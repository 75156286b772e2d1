// Fused J + d(rho) deposit contraction (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   fbpic_tpu/particles/pallas_fused.py::_fused_contract_call
// reached through fused_onehot_contract from
// sorted_deposit.deposit_rho_J_sorted(with_drho=True).
//
// What it computes, per z column `col` of the sorted (Nz, K) layout:
//   out[col, ir, w] = sum_k [ir_buf(col, k) == ir] * V[col, k, w]
// where V holds n_offJ*2*CJ current blocks (channel x per-offset z
// weight x radial corner, Ruyten-corrected lower corner with the
// below-axis parity flip) followed by n_offD*2*CD telescoped d(rho)
// blocks (endpoint shape differences, Ruyten row looked up at bn).
// V is rebuilt on the fly and never written to device memory.
//
// What bounds it on H100.  By bytes it is the live slots (39 words, two
// int64 indices and a bool a slot at Nm = 2, read once) and one
// Nz*Nrb*W store: tens of microseconds at the LWFA bench shape, with ~3
// flops per non-zero J entry and ~17 per non-zero d(rho) entry, far
// below the float32 rate.  What the kernel spends its time on is
// instruction dispatch: a visit of one particle and one z-offset block
// (stage reads, V, the read-modify-write of the accumulator at an
// address that depends on the particle) is ~40 instructions for at most
// 18 useful lanes, and a particle needs 2 J and 2-4 d(rho) visits.
// Staging, barriers and ballots alone take about a quarter of the time
// (measured with the visits compiled out).
//
// What the design does about it (contract_common.cuh).  A warp takes one
// z-offset block (of the n_offJ J blocks or the n_offD d(rho) blocks)
// and one class of radial rows of a staged tile at a time.  It ballots
// the z weights of 32 slots (for d(rho): either endpoint's) and visits
// only the particles whose weight for its offset is non-zero, two in
// flight: a particle costs 2*2*CJ J and at most 4*2*CD d(rho)
// accumulations instead of W.  Slots past the column's last live one are
// never staged (the caller's layouts keep live slots first: see
// cuda_fused.py).  The operands are read in place -- (Nz, K, C) channel
// tensors with C fastest, one (Nz, K) tensor per z offset, int64
// indices, the bool below-axis flag -- with cp.async through a ring of
// two tiles; the Ruyten table sits in shared memory.  A call is one
// launch and no operand copy.  Every accumulator word has one owner lane
// at a time and is summed in slot order: no atomics on the sums, the
// result is bit-reproducible.  Large Nr tiles the radial rows over
// blockIdx.y.

#include "contract_common.cuh"

namespace {

using namespace contract;

// Operand pointers of one call, by value in the launch arguments
template <typename T>
struct FusedArgs {
  // [chJ, zwJ_0.., sr0_m0, sr0_mh, u_a, u_b, wj, dph, ph_b, zw_a_0..,
  //  zw_b_0..]; int64 rows [ir_buf, bn]
  Runs<T> runs;
  const T* ok;
  const T* ruyten;                 // (2, NT)
  const unsigned char* is_mode0;   // (CJ,) bool, the J channels
  const T* flip;                   // (CJ,)
  T* out;
  int K, CJ, nJ, CD, nD, Nrb, NT, Rt;
};

template <typename T>
__global__ void __launch_bounds__(N_THREADS, MIN_BLOCKS)
fused_contract_kernel(
    const __grid_constant__ FusedArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int CJ = a.CJ, nJ = a.nJ, CD = a.CD, nD = a.nD, NT = a.NT;
  const int WJ = nJ * 2 * CJ, W = WJ + nD * 2 * CD;
  T* acc = reinterpret_cast<T*>(smem);
  T* tab = reinterpret_cast<T*>(smem + align16(sizeof(T) * a.Rt * W));
  unsigned char* ring = reinterpret_cast<unsigned char*>(tab)
                        + align16(sizeof(T) * 2 * NT);
  const int r_lo = blockIdx.y * a.Rt;
  const int rt = min(a.Rt, a.Nrb - r_lo);
  // staged rows (in words per slot)
  const int o_zwJ = CJ, o_m0 = CJ + nJ, o_mh = o_m0 + 1, o_ua = o_m0 + 2;
  const int o_ub = o_m0 + 3, o_wj = o_m0 + 4, o_dph = o_m0 + 5;
  const int o_phb = o_dph + CD, o_za = o_phb + CD, o_zb = o_za + nD;

  for (int i = threadIdx.x; i < 2 * NT; i += blockDim.x)
    tab[i] = a.ruyten[i];   // visible after contract_column's first barrier

  // (corner, channel) of lane channel ch.  J: the caller's metadata;
  // d(rho): one scalar component, so channel c is mode (c + 1) / 2,
  // mode 0 for c == 0, flipped below the axis for odd modes.
  auto decode = [&](int ch, bool d_warp) {
    const int C = d_warp ? CD : CJ;
    Lane<T> l;
    l.corner = ch >= C;
    l.c = l.corner ? ch - C : ch;
    const bool in = ch < 2 * C;
    if (d_warp) {
      l.srow = l.c == 0 ? 0 : NT;              // row of the Ruyten table
      l.flip = (((l.c + 1) >> 1) & 1) ? T(-1) : T(1);
    } else {
      l.srow = (in && a.is_mode0[l.c]) ? o_m0 : o_mh;
      l.flip = in ? a.flip[l.c] : T(1);
    }
    return l;
  };
  const Lane<T> mineJ = decode(threadIdx.x & 31, false);
  const Lane<T> mineD = decode(threadIdx.x & 31, true);

  contract_column<T>(
      a.runs, a.ok, a.out, acc, ring, a.K, a.Nrb, W, a.Rt, (nJ + nD) * RG,
      [&](const Stage<T>& st, int n, int item, int lane) {
        // item = (z offset block, row class); lanes = (corner, channel)
        const int blk = item / RG, g = item % RG;
        if (blk < nJ) {
          // sorted_deposit._build_V, offset block `blk`
          const T* zw = st.f + (o_zwJ + blk) * TP;
          warp_accumulate<T>(
              acc, W, blk * 2 * CJ, 2 * CJ, st.i64, r_lo, rt, g, n, lane,
              [&](int p) { return zw[p] != T(0); },
              [&](int p, int ch) {
                const Lane<T> l = ch == lane ? mineJ : decode(ch, false);
                const T sr = radial(st.f[l.srow * TP + p], l.corner,
                                    st.below[p] != 0, l.flip);
                return (st.f[p * CJ + l.c] * zw[p]) * sr;
              });
        } else {
          // sorted_deposit._build_V_span_diff, offset block `o`
          const int o = blk - nJ;
          const T* za = st.f + (o_za + o) * TP;
          const T* zb = st.f + (o_zb + o) * TP;
          const long long* bn = st.i64 + TP;
          warp_accumulate<T>(
              acc, W, WJ + o * 2 * CD, 2 * CD, st.i64, r_lo, rt, g, n, lane,
              [&](int p) { return za[p] != T(0) || zb[p] != T(0); },
              [&](int p, int ch) {
                const Lane<T> l = ch == lane ? mineD : decode(ch, true);
                const T ruy = tab[l.srow + static_cast<int>(bn[p])];
                const T ua = st.f[o_ua * TP + p], ub = st.f[o_ub * TP + p];
                const T s0a = (T(1) - ua) + ruy * ((T(1) - ua) * ua);
                const T s0b = (T(1) - ub) + ruy * ((T(1) - ub) * ub);
                const bool below = st.below[p] != 0;
                const T sa = radial(s0a, l.corner, below, l.flip);
                const T sb = radial(s0b, l.corner, below, l.flip);
                const T pb = st.f[o_phb * TP + p * CD + l.c];
                const T dp = st.f[o_dph * TP + p * CD + l.c];
                return st.f[o_wj * TP + p] *
                       (dp * (za[p] * sa) + pb * ((zb[p] - za[p]) * sa) +
                        pb * (zb[p] * (sb - sa)));
              });
        }
      });
}

template <typename T>
size_t smem_bytes(int CJ, int nJ, int CD, int nD, int NT, int Rt) {
  const int W = nJ * 2 * CJ + nD * 2 * CD;
  return align16(sizeof(T) * static_cast<size_t>(Rt) * W)
         + align16(sizeof(T) * 2 * NT)
         + NSTAGE * stage_bytes<T>(CJ + nJ + 5 + 2 * CD + 2 * nD, 2);
}

// ptrs: [chJ, sr0_m0, sr0_mh, u_a, u_b, wj, dph, ph_b, below, ir, bn, ok,
//        ruyten, is_mode0, flip, out, zwJ_0.., zw_a_0.., zw_b_0..]
template <typename T>
int launch(const void* const* ptrs, int Nz, int K, int CJ, int nJ, int CD,
           int nD, int Nrb, int NT, int Rt, void* stream) {
  if (nJ > MAX_OFF || nD > MAX_OFF || nJ + 2 * nD + 8 > MAX_RUNS) return -1;
  FusedArgs<T> a;
  int n = 0, off = 0;
  auto run = [&](const void* p, int width) {
    a.runs.src[n] = static_cast<const T*>(p);
    a.runs.width[n] = width;
    a.runs.off[n] = off;
    off += width;
    ++n;
  };
  const void* const* zw = ptrs + 16;
  run(ptrs[0], CJ);
  for (int o = 0; o < nJ; ++o) run(zw[o], 1);
  for (int i = 1; i <= 5; ++i) run(ptrs[i], 1);
  run(ptrs[6], CD);
  run(ptrs[7], CD);
  for (int o = 0; o < 2 * nD; ++o) run(zw[nJ + o], 1);
  a.runs.n = n;
  a.runs.words = off;
  a.runs.below = static_cast<const unsigned char*>(ptrs[8]);
  a.runs.i64[0] = static_cast<const long long*>(ptrs[9]);
  a.runs.i64[1] = static_cast<const long long*>(ptrs[10]);
  a.runs.n_i64 = 2;
  a.ok = static_cast<const T*>(ptrs[11]);
  a.ruyten = static_cast<const T*>(ptrs[12]);
  a.is_mode0 = static_cast<const unsigned char*>(ptrs[13]);
  a.flip = static_cast<const T*>(ptrs[14]);
  a.out = static_cast<T*>(const_cast<void*>(ptrs[15]));
  a.K = K; a.CJ = CJ; a.nJ = nJ; a.CD = CD; a.nD = nD;
  a.Nrb = Nrb; a.NT = NT; a.Rt = Rt;

  const size_t smem = smem_bytes<T>(CJ, nJ, CD, nD, NT, Rt);
  static size_t granted = 0;   // largest dynamic shared memory asked so far
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_contract_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  dim3 grid(Nz, (Nrb + Rt - 1) / Rt);
  fused_contract_kernel<T><<<grid, N_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FUSED_ARGS                                                       \
  const void *const *ptrs, int Nz, int K, int CJ, int nJ, int CD, int nD, \
      int Nrb, int NT, int Rt, void *stream
#define FUSED_CALL ptrs, Nz, K, CJ, nJ, CD, nD, Nrb, NT, Rt, stream

extern "C" int fused_contract_f32(FUSED_ARGS) {
  return launch<float>(FUSED_CALL);
}

extern "C" int fused_contract_f64(FUSED_ARGS) {
  return launch<double>(FUSED_CALL);
}

// Dynamic shared memory a launch with these sizes requests (the wrapper's
// own reckoning, cuda_fused.fused_smem_bytes, is held against it).
extern "C" int fused_contract_smem_bytes(int dtype_bytes, int CJ, int nJ,
                                         int CD, int nD, int NT, int Rt) {
  return static_cast<int>(
      dtype_bytes == 4 ? smem_bytes<float>(CJ, nJ, CD, nD, NT, Rt)
                       : smem_bytes<double>(CJ, nJ, CD, nD, NT, Rt));
}
