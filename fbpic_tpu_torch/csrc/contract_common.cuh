// What the two deposit contractions (K1 fused_deposit.cu, K3
// dense_deposit.cu) share on NVIDIA Hopper (sm_90a).
//
// Both compute, per z column of the sorted (Nz, K) layout,
//   out[col, ir, w] = sum_k [ir_buf(col, k) == ir] * V[col, k, w]
// with V rebuilt on the fly from per-slot operands.  The common design:
//
// - One block per (column, tile of radial rows); the (Rt x W)
//   accumulator tile lives in shared memory.
// - A work item is one z-offset block of V and one class of radial rows
//   (row mod RG) of one staged tile; the warps of the block draw items
//   from a counter until the tile is done.  A particle's z weight is
//   non-zero for at most two offsets, so the warp reads 32 weights at a
//   time, ballots the slots that belong to its item and visits only
//   those particles: the test is uniform over the warp and whole
//   particles are skipped.  The lanes of the warp are the (corner,
//   channel) pairs of the offset block.  Two items never share an
//   accumulator word, an item walks its particles in slot order, and a
//   barrier separates the tiles: no atomics on the sums, and each word
//   is summed in slot order whichever warp drew the item
//   (bit-reproducible).  The row classes spread the offset block that
//   nearly every particle touches over several warps.  A visit of two
//   particles is ~80 instructions whatever the number of channels, and
//   the kernels are bound by the rate at which the SM dispatches them:
//   the time follows the number of (particle, non-zero offset) visits,
//   not the bytes.
// - Slots past the column's last live one (the `ok` row) are never
//   staged; an empty column costs a zeroed output tile.
// - The operands are read where they lie: runs of TP slots go from
//   global to shared memory with cp.async through a ring of NSTAGE
//   buffers, so the next tile is in flight while this one is summed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace contract {

constexpr int TP = 128;       // slots staged per tile
constexpr int NSTAGE = 2;     // ring of staged tiles
constexpr int RG = 4;         // classes of radial rows (row mod RG)
constexpr int N_THREADS = 256;   // 8 warps a block
constexpr int MIN_BLOCKS = 4;    // blocks an SM should hold (registers)
constexpr int MAX_RUNS = 32;  // float operand runs of one kernel
constexpr int MAX_OFF = 8;    // z-offset blocks of one window
constexpr unsigned FULL = 0xffffffffu;
// Measurement only (tools/torch_tune_contract.py builds copies with it
// set; results are then wrong on purpose): 1 stages, draws and ballots
// but visits no particle; 2 visits, but stores into the accumulator
// without reading it.  0 ships.
constexpr int PROBE = 0;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// The float operands of a kernel: run j holds width[j] words per slot,
// (Nz, K, width[j]) with the width fastest, staged at word offset
// off[j] * TP of a stage.  The int64 rows (ir_buf, bn) and the bool
// below-axis row follow the float runs in every stage.
template <typename T>
struct Runs {
  const T* src[MAX_RUNS];
  int width[MAX_RUNS];
  int off[MAX_RUNS];
  int n;                 // float runs
  int words;             // float words per slot (sum of widths)
  const long long* i64[2];
  int n_i64;
  const unsigned char* below;
};

// Bytes of one staged tile
template <typename T>
__host__ __device__ inline size_t stage_bytes(int words, int n_i64) {
  return static_cast<size_t>(TP) * (words * sizeof(T) + 8 * n_i64 + 1);
}

template <typename T>
struct Stage {
  const T* f;                 // (words, TP) float fields
  const long long* i64;       // (n_i64, TP)
  const unsigned char* below; // (TP,)
};

template <typename T>
__device__ inline Stage<T> stage_at(unsigned char* base, int words,
                                    int n_i64) {
  Stage<T> s;
  s.f = reinterpret_cast<const T*>(base);
  s.i64 = reinterpret_cast<const long long*>(
      base + static_cast<size_t>(TP) * words * sizeof(T));
  s.below = base + static_cast<size_t>(TP) * (words * sizeof(T) + 8 * n_i64);
  return s;
}

template <int BYTES>
__device__ inline void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES) : "memory");
  }
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp copies n_bytes from global to shared memory: 16 bytes a lane
// where source, destination and length allow it, else ELEM bytes a lane.
template <int ELEM>
__device__ inline void warp_copy_async(unsigned char* dst,
                                       const unsigned char* src,
                                       int n_bytes, int lane) {
  const bool wide = ((reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst) |
                      static_cast<uintptr_t>(n_bytes)) & 15) == 0;
  if (wide) {
    for (int i = lane * 16; i < n_bytes; i += 32 * 16)
      cp_async<16>(dst + i, src + i);
  } else {
    for (int i = lane * ELEM; i < n_bytes; i += 32 * ELEM)
      cp_async<ELEM>(dst + i, src + i);
  }
}

// Stage slots [k0, k0 + n) of column `col` into the buffer at `base`:
// the runs are dealt to the warps of the block in turn.
template <typename T>
__device__ inline void stage_tile(const Runs<T>& runs, unsigned char* base,
                                  size_t colK, int k0, int n, int warp,
                                  int n_warps, int lane) {
  const size_t slot0 = colK + k0;
  T* f = reinterpret_cast<T*>(base);
  const int n_jobs = runs.n + runs.n_i64 + 1;
  for (int j = warp; j < n_jobs; j += n_warps) {
    if (j < runs.n) {
      const int wd = runs.width[j];
      warp_copy_async<sizeof(T)>(
          reinterpret_cast<unsigned char*>(f + runs.off[j] * TP),
          reinterpret_cast<const unsigned char*>(runs.src[j] + slot0 * wd),
          n * wd * static_cast<int>(sizeof(T)), lane);
    } else if (j < runs.n + runs.n_i64) {
      const int i = j - runs.n;
      warp_copy_async<8>(
          base + static_cast<size_t>(TP) * (runs.words * sizeof(T) + 8 * i),
          reinterpret_cast<const unsigned char*>(runs.i64[i] + slot0),
          n * 8, lane);
    } else {
      unsigned char* d = base + static_cast<size_t>(TP) *
                                    (runs.words * sizeof(T) + 8 * runs.n_i64);
      for (int i = lane; i < n; i += 32) d[i] = runs.below[slot0 + i];
    }
  }
}

// 1 + the index of the column's last slot whose `ok` is non-zero (0 for
// an empty column).  Dead slots carry zero z weights in every block of
// V, so nothing past this slot contributes.
template <typename T>
__device__ inline int live_extent(const T* __restrict__ ok, int K, int tid,
                                  int n_threads, int* s_last) {
  if (tid == 0) *s_last = 0;
  __syncthreads();
  int last = 0;
  for (int k = tid; k < K; k += n_threads)
    if (ok[k] != T(0)) last = k + 1;
  for (int d = 16; d > 0; d >>= 1)
    last = max(last, __shfl_xor_sync(FULL, last, d));
  if ((tid & 31) == 0 && last > 0) atomicMax(s_last, last);
  __syncthreads();
  return *s_last;
}

// What a lane knows of its (corner, channel): the channel, the staged
// row of its radial factor (mode 0 or higher) and its below-axis flip.
template <typename T>
struct Lane {
  bool corner;
  int c, srow;
  T flip;
};

// The radial factor of one (corner, channel): the Ruyten-corrected lower
// corner s (flipped below the axis) or 1 - s, taken before the flip.
template <typename T>
__device__ inline T radial(T s, bool corner, bool below, T flip) {
  return corner ? T(1) - s : (below ? flip * s : s);
}

// One work item: the walk of a warp over the slots of a staged tile
// whose radial row is of class g (row mod RG) and for which `active(p)`
// holds (the slot's z weight for this offset block is non-zero).
// `value(p, ch)` is the V entry of slot p and lane channel ch; the warp
// adds it into acc[r * W + w0 + ch].  Two particles are in flight at a
// time; they share an accumulator word only when their radial rows
// agree, and then they are added one after the other, so every word is
// still summed in slot order.
template <typename T, typename Active, typename Value>
__device__ inline void warp_accumulate(T* acc, int W, int w0, int n_ch,
                                       const long long* ir, int r_lo, int Rt,
                                       int g, int n, int lane, Active active,
                                       Value value) {
  for (int base = 0; base < n; base += 32) {
    const int p = base + lane;
    int r = -1;
    bool act = false;
    if (p < n) {
      r = static_cast<int>(ir[p]) - r_lo;
      act = r >= 0 && r < Rt && (r & (RG - 1)) == g && active(p);
    }
    unsigned mask = __ballot_sync(FULL, act);
    if (PROBE == 1) mask = 0;
    while (mask) {
      const int b0 = __ffs(mask) - 1;
      mask &= mask - 1;
      const int r0 = __shfl_sync(FULL, r, b0);
      if (mask) {
        const int b1 = __ffs(mask) - 1;
        mask &= mask - 1;
        const int r1 = __shfl_sync(FULL, r, b1);
        for (int ch = lane; ch < n_ch; ch += 32) {
          const T v0 = value(base + b0, ch);
          const T v1 = value(base + b1, ch);
          T* a0 = acc + r0 * W + w0 + ch;
          T* a1 = acc + r1 * W + w0 + ch;
          if (PROBE == 2) {
            *a0 = v0;
            *a1 = v1;
          } else if (r0 != r1) {
            const T x0 = *a0, x1 = *a1;
            *a0 = x0 + v0;
            *a1 = x1 + v1;
          } else {
            *a0 = (*a0 + v0) + v1;
          }
        }
      } else {
        for (int ch = lane; ch < n_ch; ch += 32)
          acc[r0 * W + w0 + ch] += value(base + b0, ch);
      }
    }
  }
}

// One block's work: rows [r_lo, r_lo + rt) of column blockIdx.x.  `acc`
// is the block's (Rt x W) accumulator at the start of its dynamic shared
// memory, `ring` the NSTAGE staged tiles behind it; `consume(stage, n,
// item, lane)` sums work item `item` (of n_items) of one staged tile of
// n slots into acc.
template <typename T, typename Consume>
__device__ inline void contract_column(const Runs<T>& runs,
                                       const T* __restrict__ ok,
                                       T* __restrict__ out, T* acc,
                                       unsigned char* ring, int K, int Nrb,
                                       int W, int Rt, int n_items,
                                       Consume consume) {
  __shared__ int s_last;
  __shared__ int s_next[NSTAGE];   // next work item of each staged tile
  const int tid = threadIdx.x, n_threads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, n_warps = n_threads >> 5;
  const int col = blockIdx.x;
  const int r_lo = blockIdx.y * Rt;
  const int rt = min(Rt, Nrb - r_lo);
  const size_t colK = static_cast<size_t>(col) * K;
  T* out_tile = out + (static_cast<size_t>(col) * Nrb + r_lo) * W;

  const int last = live_extent(ok + colK, K, tid, n_threads, &s_last);
  if (last == 0) {
    for (int i = tid; i < rt * W; i += n_threads) out_tile[i] = T(0);
    return;
  }
  const size_t sbytes = stage_bytes<T>(runs.words, runs.n_i64);
  const int n_tiles = (last + TP - 1) / TP;
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_tiles)
      stage_tile(runs, ring + s * sbytes, colK, s * TP,
                 min(TP, last - s * TP), warp, n_warps, lane);
    cp_async_commit();
  }
  for (int i = tid; i < rt * W; i += n_threads) acc[i] = T(0);
  if (tid == 0) s_next[0] = 0;

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every warp is done with tile t - 1, whose
    // buffer takes tile t + NSTAGE - 1
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    const int tn = t + NSTAGE - 1;
    if (tn < n_tiles)
      stage_tile(runs, ring + (tn % NSTAGE) * sbytes, colK, tn * TP,
                 min(TP, last - tn * TP), warp, n_warps, lane);
    cp_async_commit();
    if (tid == 0) s_next[(t + 1) % NSTAGE] = 0;   // read after the barrier
    const Stage<T> st = stage_at<T>(ring + (t % NSTAGE) * sbytes,
                                    runs.words, runs.n_i64);
    for (;;) {
      int item = 0;
      if (lane == 0) item = atomicAdd(&s_next[t % NSTAGE], 1);
      item = __shfl_sync(FULL, item, 0);
      if (item >= n_items) break;
      consume(st, min(TP, last - t * TP), item, lane);
    }
  }
  __syncthreads();
  for (int i = tid; i < rt * W; i += n_threads) out_tile[i] = acc[i];
}

}  // namespace contract
