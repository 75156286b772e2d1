// One-hot dense deposit contraction (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   fbpic_tpu/particles/pallas_deposit.py::_onehot_deposit_call
// a drop-in for sorted_deposit._dense_deposit, the with_rho branch of
// sorted_deposit.deposit_rho_J_sorted: the J and the rho contractions of
// every step that does not deposit d(rho) (float64 runs, and any run of
// the Galilean / comoving scheme).
//
// What it computes, per z column `col` of the sorted (Nz, K) layout:
//   out[col, ir, (o, corner, c)] = sum_k [ir_buf(col, k) == ir]
//       * chan[c] * zw_o * (corner 0 ? sr0c : 1 - sr0c)
// with sr0c = sr0_m0 for mode-0 channels and sr0_mh otherwise; below the
// axis only the corner-0 factor is multiplied by flip[c] (1 - sr0c is
// taken before the flip).  This is sorted_deposit._build_V followed by
// the segmented sum _contract, over the packed channels
// (C = n_comp * (2 Nm - 1)); V is rebuilt on the fly and never written
// to device memory.
//
// What bounds it on H100.  By bytes it is the live slots (C + n_off + 2
// words, an int64 row index and a bool a slot, read once) and one
// Nz*Nrb*W store: tens of microseconds at the boosted-frame LWFA shape,
// with ~3 flops per non-zero V entry.  What the kernel spends its time
// on is instruction dispatch: a visit of one particle and one
// z-offset block (stage reads, V, the read-modify-write of the
// accumulator at an address that depends on the particle) is ~40
// instructions whether the block has 18 channels (J) or 6 (rho), and a
// particle needs two visits; the J and the rho window therefore take the
// same time.  Staging, barriers and ballots alone take about a third of
// it (measured with the visits compiled out).
//
// What the design does about it (contract_common.cuh).  The TPU needed
// V dense for its matrix unit; here a particle touches only the two
// offset blocks whose z weight is non-zero: a warp takes one offset block
// and one class of radial rows of a staged tile at a time, ballots the
// non-zero weights of 32 slots and visits those particles only (2 * 2C
// accumulations a particle instead of n_off * 2C), two particles in
// flight.  Slots past the column's last live one are never staged (the
// caller's layouts keep live slots first: see cuda_dense.py).  The
// operands are read in place -- channels (Nz, K, C) with C fastest, one
// (Nz, K) tensor per z offset, int64 row indices, the bool below-axis
// flag -- with cp.async through a ring of two tiles, so a call is one
// launch and no operand copy.  Every accumulator word has one owner lane
// at a time and is summed in slot order: no atomics on the sums, the
// result is bit-reproducible.  Large Nr tiles the radial rows over
// blockIdx.y.

#include "contract_common.cuh"

namespace {

using namespace contract;

// Operand pointers of one call, by value in the launch arguments
template <typename T>
struct DenseArgs {
  Runs<T> runs;            // [chan, zw_0 .. zw_{n_off-1}, sr0_m0, sr0_mh]
  const T* ok;
  const unsigned char* is_mode0;   // (C,) bool
  const T* flip;                   // (C,)
  T* out;
  int K, C, n_off, Nrb, Rt;
};

template <typename T>
__global__ void __launch_bounds__(N_THREADS, MIN_BLOCKS)
dense_contract_kernel(
    const __grid_constant__ DenseArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, W = a.n_off * 2 * C;
  T* acc = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + align16(sizeof(T) * a.Rt * W);
  const int r_lo = blockIdx.y * a.Rt;
  const int rt = min(a.Rt, a.Nrb - r_lo);
  const int o_zw = C, o_m0 = C + a.n_off, o_mh = o_m0 + 1;
  // (corner, channel) of lane channel ch, its radial row and its flip
  auto decode = [&](int ch) {
    Lane<T> l;
    l.corner = ch >= C;
    l.c = l.corner ? ch - C : ch;
    const bool in = ch < 2 * C;
    l.srow = (in && a.is_mode0[l.c]) ? o_m0 : o_mh;
    l.flip = in ? a.flip[l.c] : T(1);
    return l;
  };
  const Lane<T> mine = decode(threadIdx.x & 31);   // 2C <= 32: every ch

  contract_column<T>(
      a.runs, a.ok, a.out, acc, ring, a.K, a.Nrb, W, a.Rt, a.n_off * RG,
      [&](const Stage<T>& st, int n, int item, int lane) {
        // item = (z offset block, row class); lanes = (corner, channel)
        const int o = item / RG;
        const T* zw = st.f + (o_zw + o) * TP;
        warp_accumulate<T>(
            acc, W, o * 2 * C, 2 * C, st.i64, r_lo, rt, item % RG, n, lane,
            [&](int p) { return zw[p] != T(0); },
            [&](int p, int ch) {
              const Lane<T> l = ch == lane ? mine : decode(ch);
              const T sr = radial(st.f[l.srow * TP + p], l.corner,
                                  st.below[p] != 0, l.flip);
              return (st.f[p * C + l.c] * zw[p]) * sr;
            });
      });
}

template <typename T>
size_t smem_bytes(int C, int n_off, int Rt) {
  return align16(sizeof(T) * static_cast<size_t>(Rt) * n_off * 2 * C)
         + NSTAGE * stage_bytes<T>(C + n_off + 2, 1);
}

// ptrs: [chan, sr0_m0, sr0_mh, below, ir, ok, is_mode0, flip, out,
//        zw_0 .. zw_{n_off-1}]
template <typename T>
int launch(const void* const* ptrs, int Nz, int K, int C, int n_off, int Nrb,
           int Rt, void* stream) {
  if (n_off > MAX_OFF || n_off + 3 > MAX_RUNS) return -1;
  DenseArgs<T> a;
  int n = 0, off = 0;
  auto run = [&](const void* p, int width) {
    a.runs.src[n] = static_cast<const T*>(p);
    a.runs.width[n] = width;
    a.runs.off[n] = off;
    off += width;
    ++n;
  };
  run(ptrs[0], C);
  for (int o = 0; o < n_off; ++o) run(ptrs[9 + o], 1);
  run(ptrs[1], 1);
  run(ptrs[2], 1);
  a.runs.n = n;
  a.runs.words = off;
  a.runs.below = static_cast<const unsigned char*>(ptrs[3]);
  a.runs.i64[0] = static_cast<const long long*>(ptrs[4]);
  a.runs.i64[1] = nullptr;
  a.runs.n_i64 = 1;
  a.ok = static_cast<const T*>(ptrs[5]);
  a.is_mode0 = static_cast<const unsigned char*>(ptrs[6]);
  a.flip = static_cast<const T*>(ptrs[7]);
  a.out = static_cast<T*>(const_cast<void*>(ptrs[8]));
  a.K = K; a.C = C; a.n_off = n_off; a.Nrb = Nrb; a.Rt = Rt;

  const size_t smem = smem_bytes<T>(C, n_off, Rt);
  static size_t granted = 0;   // largest dynamic shared memory asked so far
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_contract_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  dim3 grid(Nz, (Nrb + Rt - 1) / Rt);
  dense_contract_kernel<T><<<grid, N_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dense_contract_f32(const void* const* ptrs, int Nz, int K,
                                  int C, int n_off, int Nrb, int Rt,
                                  void* stream) {
  return launch<float>(ptrs, Nz, K, C, n_off, Nrb, Rt, stream);
}

extern "C" int dense_contract_f64(const void* const* ptrs, int Nz, int K,
                                  int C, int n_off, int Nrb, int Rt,
                                  void* stream) {
  return launch<double>(ptrs, Nz, K, C, n_off, Nrb, Rt, stream);
}

// Dynamic shared memory a launch with these sizes requests (the wrapper's
// own reckoning, cuda_dense.dense_smem_bytes, is held against it).
extern "C" int dense_contract_smem_bytes(int dtype_bytes, int C, int n_off,
                                         int Rt) {
  return static_cast<int>(dtype_bytes == 4 ? smem_bytes<float>(C, n_off, Rt)
                                           : smem_bytes<double>(C, n_off, Rt));
}
