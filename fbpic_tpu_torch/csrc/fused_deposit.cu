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
// Design.  One block per (column, channel tile); one thread per output
// channel w.  The block stages TP particles of its column into shared
// memory with coalesced loads, then every thread walks them in order,
// rebuilds its own V[k, w] in registers and adds it into its private
// column of the (Nrb x Wt) shared accumulator.  No two threads ever
// touch the same accumulator word, so there are no atomics and the
// per-(ir, w) summation order is the particle order: the result is
// bit-reproducible from run to run.  W is tiled over blockIdx.y so the
// accumulator stays within the shared-memory budget for any Nr / Nm.
//
// What bounds it on H100: the per-particle inputs (~42 words per
// particle at Nm=2) are read exactly once -- ~0.2 GB per step at the
// LWFA bench shape, i.e. ~65 us at 3.35 TB/s -- plus one Nz*Nrb*W
// store.  The shared-memory read-modify-write of the accumulator (one
// per particle and channel, Nz*K*W ~ 1.7e8 per step) is the next
// limit; threads of a warp hit consecutive words, so it is
// bank-conflict free.

#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;          // particles staged per tile
constexpr int N_ROWS = 6;       // [sr0_m0, sr0_mh, below, u_a, u_b, wj]

template <typename T>
__global__ void fused_contract_kernel(
    const T* __restrict__ chJ, const T* __restrict__ zwJ,
    const T* __restrict__ rows, const int* __restrict__ ir,
    const int* __restrict__ bn, const T* __restrict__ dph,
    const T* __restrict__ phb, const T* __restrict__ zwa,
    const T* __restrict__ zwb, const T* __restrict__ tables,
    const T* __restrict__ metaJ, const T* __restrict__ metaD,
    T* __restrict__ out, int K, int CJ, int nJ, int CD, int nD, int Nrb,
    int NT, int Wt) {
  extern __shared__ unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);            // (Nrb, Wt)
  // Staged per-particle fields, each a row of TP values
  const int offJ = 0, offZJ = CJ, offR = CJ + nJ, offDph = offR + N_ROWS;
  const int offPhb = offDph + CD, offZa = offPhb + CD, offZb = offZa + nD;
  const int nF = offZb + nD;
  T* tf = acc + Nrb * Wt;                              // (nF, TP)
  int* ti = reinterpret_cast<int*>(tf + nF * TP);      // (2, TP)

  const int col = blockIdx.x;
  const int WJ = nJ * 2 * CJ;
  const int W = WJ + nD * 2 * CD;
  const int t = threadIdx.x;
  const int w = blockIdx.y * Wt + t;
  const bool active = (t < Wt) && (w < W);

  // Decode this thread's channel: block b = 2*offset + corner
  bool isJ = true;
  int c = 0, o = 0, corner = 0;
  T is0 = 0, flip = 1;
  if (active) {
    if (w < WJ) {
      const int b = w / CJ;
      c = w % CJ;
      o = b >> 1;
      corner = b & 1;
      is0 = metaJ[c];
      flip = metaJ[CJ + c];
    } else {
      isJ = false;
      const int wd = w - WJ;
      const int b = wd / CD;
      c = wd % CD;
      o = b >> 1;
      corner = b & 1;
      is0 = metaD[c];
      flip = metaD[CD + c];
    }
  }
  const T* tab = tables + (is0 > 0 ? 0 : NT);  // Ruyten row of this mode

  for (int i = t; i < Nrb * Wt; i += blockDim.x) acc[i] = T(0);

  const size_t colK = static_cast<size_t>(col) * K;
  for (int k0 = 0; k0 < K; k0 += TP) {
    const int n = min(TP, K - k0);
    __syncthreads();  // previous tile fully consumed (and acc zeroed)
    for (int i = t; i < nF * TP; i += blockDim.x) {
      const int f = i / TP, p = i % TP;
      if (p >= n) continue;
      const T* src;
      int fl;
      if (f < offZJ) { src = chJ; fl = f; }
      else if (f < offR) { src = zwJ; fl = f - offZJ; }
      else if (f < offDph) { src = rows; fl = f - offR; }
      else if (f < offPhb) { src = dph; fl = f - offDph; }
      else if (f < offZa) { src = phb; fl = f - offPhb; }
      else if (f < offZb) { src = zwa; fl = f - offZa; }
      else { src = zwb; fl = f - offZb; }
      int nrow;
      if (f < offZJ) nrow = CJ;
      else if (f < offR) nrow = nJ;
      else if (f < offDph) nrow = N_ROWS;
      else if (f < offZa) nrow = CD;
      else nrow = nD;
      tf[i] = src[(static_cast<size_t>(col) * nrow + fl) * K + k0 + p];
    }
    for (int p = t; p < n; p += blockDim.x) {
      ti[p] = ir[colK + k0 + p];
      ti[TP + p] = bn[colK + k0 + p];
    }
    __syncthreads();
    if (!active) continue;
    for (int p = 0; p < n; ++p) {
      const int r = ti[p];
      if (r < 0 || r >= Nrb) continue;
      const bool below = tf[(offR + 2) * TP + p] > 0;
      T v;
      if (isJ) {
        // sorted_deposit._build_V
        const T s = tf[(offR + (is0 > 0 ? 0 : 1)) * TP + p];
        const T sr = corner ? T(1) - s : (below ? flip * s : s);
        v = (tf[(offJ + c) * TP + p] * tf[(offZJ + o) * TP + p]) * sr;
      } else {
        // sorted_deposit._build_V_span_diff
        const T ruy = tab[ti[TP + p]];
        const T ua = tf[(offR + 3) * TP + p];
        const T ub = tf[(offR + 4) * TP + p];
        const T s0a = (T(1) - ua) + ruy * ((T(1) - ua) * ua);
        const T s0b = (T(1) - ub) + ruy * ((T(1) - ub) * ub);
        T sa, sb;
        if (corner) {
          sa = T(1) - s0a;
          sb = T(1) - s0b;
        } else {
          sa = below ? flip * s0a : s0a;
          sb = below ? flip * s0b : s0b;
        }
        const T za = tf[(offZa + o) * TP + p];
        const T zb = tf[(offZb + o) * TP + p];
        const T pb = tf[(offPhb + c) * TP + p];
        v = tf[(offR + 5) * TP + p] *
            (tf[(offDph + c) * TP + p] * (za * sa) + pb * ((zb - za) * sa) +
             pb * (zb * (sb - sa)));
      }
      acc[r * Wt + t] += v;
    }
  }
  __syncthreads();
  const int w0 = blockIdx.y * Wt;
  for (int i = t; i < Nrb * Wt; i += blockDim.x) {
    const int r = i / Wt, tt = i % Wt;
    if (w0 + tt < W)
      out[(static_cast<size_t>(col) * Nrb + r) * W + w0 + tt] = acc[i];
  }
}

template <typename T>
int launch(const void* chJ, const void* zwJ, const void* rows, const void* ir,
           const void* bn, const void* dph, const void* phb, const void* zwa,
           const void* zwb, const void* tables, const void* metaJ,
           const void* metaD, void* out, int Nz, int K, int CJ, int nJ,
           int CD, int nD, int Nrb, int NT, int Wt, int n_wtiles,
           int threads, void* stream) {
  const int nF = CJ + nJ + N_ROWS + 2 * CD + 2 * nD;
  const size_t smem = sizeof(T) * (static_cast<size_t>(Nrb) * Wt + nF * TP)
                      + sizeof(int) * 2 * TP;
  cudaError_t err = cudaFuncSetAttribute(
      fused_contract_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Nz, n_wtiles);
  fused_contract_kernel<T><<<grid, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(chJ), static_cast<const T*>(zwJ),
      static_cast<const T*>(rows), static_cast<const int*>(ir),
      static_cast<const int*>(bn), static_cast<const T*>(dph),
      static_cast<const T*>(phb), static_cast<const T*>(zwa),
      static_cast<const T*>(zwb), static_cast<const T*>(tables),
      static_cast<const T*>(metaJ), static_cast<const T*>(metaD),
      static_cast<T*>(out), K, CJ, nJ, CD, nD, Nrb, NT, Wt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FUSED_ARGS                                                          \
  const void *chJ, const void *zwJ, const void *rows, const void *ir,      \
      const void *bn, const void *dph, const void *phb, const void *zwa,   \
      const void *zwb, const void *tables, const void *metaJ,              \
      const void *metaD, void *out, int Nz, int K, int CJ, int nJ, int CD, \
      int nD, int Nrb, int NT, int Wt, int n_wtiles, int threads,          \
      void *stream
#define FUSED_CALL                                                          \
  chJ, zwJ, rows, ir, bn, dph, phb, zwa, zwb, tables, metaJ, metaD, out,    \
      Nz, K, CJ, nJ, CD, nD, Nrb, NT, Wt, n_wtiles, threads, stream

extern "C" int fused_contract_f32(FUSED_ARGS) {
  return launch<float>(FUSED_CALL);
}

extern "C" int fused_contract_f64(FUSED_ARGS) {
  return launch<double>(FUSED_CALL);
}

// Dynamic shared memory a launch with these sizes requests, so the
// caller can pick the channel tiling against the device limit.
extern "C" int fused_contract_smem_bytes(int dtype_bytes, int CJ, int nJ,
                                         int CD, int nD, int Nrb, int Wt) {
  const int nF = CJ + nJ + N_ROWS + 2 * CD + 2 * nD;
  return dtype_bytes * (Nrb * Wt + nF * TP) + 4 * 2 * TP;
}
