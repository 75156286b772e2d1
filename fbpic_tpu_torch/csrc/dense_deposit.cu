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
// Design (K1's, without the d(rho) blocks).  One block per (column,
// channel tile); one thread per output channel w.  The block stages TP
// particles of its column into shared memory with coalesced loads, then
// every thread walks them in order, rebuilds its V[k, w] in registers and
// adds it into its private column of the (Nrb x Wt) shared accumulator.
// No two threads touch the same accumulator word: no atomics, and the
// per-(ir, w) sum runs in particle order, so results are bit-reproducible.
// W is tiled over blockIdx.y so the accumulator fits any Nr / Nm.
//
// What bounds it on H100: the per-particle inputs (C + n_off + 4 words a
// slot: 18 for J, 14 for rho at Nm = 2) are read once, ~0.2 GB per J
// deposit at the boosted-frame LWFA shape, i.e. ~60 us at 3.35 TB/s, plus
// one Nz*Nrb*W store.  The per-slot work is ~3 flops per output channel,
// far below the FP32 rate.  The shared-memory read-modify-write of the
// accumulator (one per slot and channel) is the next limit; threads of a
// warp hit consecutive words, so it is bank-conflict free.

#include <cuda_runtime.h>

namespace {

constexpr int TP = 64;          // particles staged per tile
constexpr int N_ROWS = 3;       // [sr0_m0, sr0_mh, below]

template <typename T>
__global__ void dense_contract_kernel(
    const T* __restrict__ chan, const T* __restrict__ zw,
    const T* __restrict__ rows, const int* __restrict__ ir,
    const T* __restrict__ meta, T* __restrict__ out, int K, int C,
    int n_off, int Nrb, int Wt) {
  extern __shared__ unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);            // (Nrb, Wt)
  // Staged per-particle fields, each a row of TP values
  const int offZ = C, offR = C + n_off, nF = offR + N_ROWS;
  T* tf = acc + Nrb * Wt;                              // (nF, TP)
  int* ti = reinterpret_cast<int*>(tf + nF * TP);      // (TP,)

  const int col = blockIdx.x;
  const int W = n_off * 2 * C;
  const int t = threadIdx.x;
  const int w = blockIdx.y * Wt + t;
  const bool active = (t < Wt) && (w < W);

  // Decode this thread's channel: block b = 2*offset + corner
  int c = 0, o = 0, corner = 0;
  T is0 = 0, flip = 1;
  if (active) {
    const int b = w / C;
    c = w % C;
    o = b >> 1;
    corner = b & 1;
    is0 = meta[c];
    flip = meta[C + c];
  }
  const int srow = offR + (is0 > 0 ? 0 : 1);   // sr0_m0 or sr0_mh

  for (int i = t; i < Nrb * Wt; i += blockDim.x) acc[i] = T(0);

  const size_t colK = static_cast<size_t>(col) * K;
  for (int k0 = 0; k0 < K; k0 += TP) {
    const int n = min(TP, K - k0);
    __syncthreads();  // previous tile fully consumed (and acc zeroed)
    for (int i = t; i < nF * TP; i += blockDim.x) {
      const int f = i / TP, p = i % TP;
      if (p >= n) continue;
      const T* src;
      int fl, nrow;
      if (f < offZ) { src = chan; fl = f; nrow = C; }
      else if (f < offR) { src = zw; fl = f - offZ; nrow = n_off; }
      else { src = rows; fl = f - offR; nrow = N_ROWS; }
      tf[i] = src[(static_cast<size_t>(col) * nrow + fl) * K + k0 + p];
    }
    for (int p = t; p < n; p += blockDim.x) ti[p] = ir[colK + k0 + p];
    __syncthreads();
    if (!active) continue;
    for (int p = 0; p < n; ++p) {
      const int r = ti[p];
      if (r < 0 || r >= Nrb) continue;
      const bool below = tf[(offR + 2) * TP + p] > 0;
      const T s = tf[srow * TP + p];
      const T sr = corner ? T(1) - s : (below ? flip * s : s);
      acc[r * Wt + t] += (tf[c * TP + p] * tf[(offZ + o) * TP + p]) * sr;
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
size_t smem_bytes(int C, int n_off, int Nrb, int Wt) {
  const int nF = C + n_off + N_ROWS;
  return sizeof(T) * (static_cast<size_t>(Nrb) * Wt + nF * TP)
         + sizeof(int) * TP;
}

template <typename T>
int launch(const void* chan, const void* zw, const void* rows,
           const void* ir, const void* meta, void* out, int Nz, int K, int C,
           int n_off, int Nrb, int Wt, int n_wtiles, int threads,
           void* stream) {
  const size_t smem = smem_bytes<T>(C, n_off, Nrb, Wt);
  cudaError_t err = cudaFuncSetAttribute(
      dense_contract_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Nz, n_wtiles);
  dense_contract_kernel<T><<<grid, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(chan), static_cast<const T*>(zw),
      static_cast<const T*>(rows), static_cast<const int*>(ir),
      static_cast<const T*>(meta), static_cast<T*>(out), K, C, n_off, Nrb,
      Wt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DENSE_ARGS                                                        \
  const void *chan, const void *zw, const void *rows, const void *ir,    \
      const void *meta, void *out, int Nz, int K, int C, int n_off,      \
      int Nrb, int Wt, int n_wtiles, int threads, void *stream
#define DENSE_CALL                                                        \
  chan, zw, rows, ir, meta, out, Nz, K, C, n_off, Nrb, Wt, n_wtiles,     \
      threads, stream

extern "C" int dense_contract_f32(DENSE_ARGS) {
  return launch<float>(DENSE_CALL);
}

extern "C" int dense_contract_f64(DENSE_ARGS) {
  return launch<double>(DENSE_CALL);
}

// Dynamic shared memory a launch with these sizes requests, so the
// caller can pick the channel tiling against the device limit.
extern "C" int dense_contract_smem_bytes(int dtype_bytes, int C, int n_off,
                                         int Nrb, int Wt) {
  return static_cast<int>(dtype_bytes == 4
                              ? smem_bytes<float>(C, n_off, Nrb, Wt)
                              : smem_bytes<double>(C, n_off, Nrb, Wt));
}
