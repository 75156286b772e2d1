// Sorted-layout field gather (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   fbpic_tpu/particles/pallas_gather.py::_gather_call
// reached through gather_sorted_pallas from gather.gather_fields_sorted.
//
// What it computes, per particle slot (col, k) of the sorted (Nz, K)
// layout, from the padded positions and the interpolation-grid fields
// themselves: the cylindrical projection (r, cos, sin), the cell
// coordinates and linear weights (with the Kahan words' correction when
// they are given), the mask ok = valid && r < rmax_gather, the lower
// radial row l_r = clamp(ir + 1, 0, Nr) of the extended axis (row 0 = the
// signed axis guard) and u_r = min(l_r + 1, Nr), the z offset
// o_lo = clamp(iz - col, -1, 1) + 1 (centered residue first for periodic
// z) and o_hi = min(o_lo + 1, 2); then the bilinear 4-corner fetch of all
// 12 Nm field words at z rows (col + o - 1) mod Nz (open and periodic z
// alike), the mode sum Re(F_m e^{-i m theta}) with weights 1 (m = 0) and
// 2 (m > 0), and the rotation to (Ex, Ey, Ez, Bx, By, Bz).  A slot with
// ok = 0 gets six zeros.  Index semantics and the order of the geometry's
// roundings follow gather.gather_operands (the XLA path of fbpic_tpu's
// gather_fields_sorted): every geometry operation is rounded on its own
// (the _rn intrinsics; no contraction into FMAs), so a floor lands where
// the plain version's does.
//
// What bounds it on H100.  By bytes: per slot the valid flag and six
// outputs, per live slot x, y, z (and the Kahan words), the fields once
// -- ~45 MB at the LWFA shape on a half-full layout, ~14 us at 3.35
// TB/s; ~200 operations per live slot are ~2 us at 67 TFLOP/s.  What it
// spends its time on is latency and shared-memory bandwidth: each slot
// is a dependent chain (flag -> position -> geometry -> corner fetch ->
// store), and the 48 corner loads of a particle (Nm = 2) fall on radial
// rows that differ from lane to lane, so a warp's load takes several
// wavefronts (PERF.md gives the probe times).
//
// What the design does about it.  The geometry is computed in registers
// from the positions, so no per-slot operand is written and read back
// (the operand build it replaces was ~50 elementwise launches a call).
// A block owns a run of `bz` adjacent z columns -- and, when the grid
// needs more blocks to fill the card, every gridDim.y-th run of
// blockDim.x slots of them, so that the blocks of a column share its
// live prefix -- and stages the bz + 2 z rows those columns reach, of
// all 6 Nm complex channels, into shared memory with cp.async, one
// (row, radial row) entry holding a particle corner's 12 Nm words
// contiguously, padded to an odd number of (re, im) pairs so that the
// lanes of a phase spread over all the banks; it writes the signed
// guard row itself (the signs are constants of component and mode
// parity).  The fields are read where they lie, (Nm, Nz, Nr) complex
// with r or z fastest (torch.fft along z leaves the latter).  A thread
// loads the flags and then the positions of UNROLL slots before it
// computes any, so that several loads are in flight; the position loads
// and the six output stores are coalesced.  A dead slot reads nothing
// but its flag, and a block whose slots are all dead stages nothing.
// Every sum runs in a fixed order without atomics: launches are
// bit-reproducible.  When even one column's three rows do not fit in
// shared memory (large Nr), the same kernel reads the corners from
// global memory instead (`STAGED` false).  Tried and slower (PERF.md):
// a group of 8 lanes per particle, one field component a lane, on a
// conflict-free (row, component, radial row) tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_common.cuh"

namespace {

constexpr int N_THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;   // grid.y splits the slots to reach this
constexpr int UNROLL = 2;          // slots a thread loads before it computes
// Largest run of columns a block owns (the wrapper, cuda_gather.py,
// picks the largest that fits in shared memory)
constexpr int BZ_MAX = 2;
// Measurement only (tools/torch_tune_contract.py --gather builds copies
// with it set; results are then wrong on purpose): 2 stages the rows but
// reads no corner from shared memory; 1 does neither.  0 ships.
constexpr int PROBE = 0;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Rn<double> {
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ double sqrt(double a) { return __dsqrt_rn(a); }
};

template <typename T>
struct Pair;
template <>
struct Pair<float> { using type = float2; };
template <>
struct Pair<double> { using type = double2; };

// Operands of one call, by value in the launch arguments
template <typename T>
struct GatherArgs {
  const T* x;
  const T* y;
  const T* z;
  const unsigned char* valid;
  const T* cx;             // the Kahan words, or null
  const T* cy;
  const T* cz;
  const T* f[6];           // Er, Et, Ez, Br, Bt, Bz as (re, im) pairs
  T* out;                  // (6, Nz, K)
  long long sz, sr;        // field strides of z and r, complex elements
  // The grid's left edge, read from device memory: a 0-d tensor that
  // changes from step to step, so that a launch captured in a CUDA graph
  // reads each replay's value
  const T* zmin;
  T invdz, invdr, rmin, rmax;
  int Nz, K, Nr, Nm, bz, rs;
  bool periodic;
};

// Words of one staged (row, radial row) entry: the 12 Nm words of a
// corner and one more (re, im) pair, so that an entry is an odd number
// of pairs: a thread reads its corner a pair at a time (8 bytes in
// float, 16 in double), and entries an odd number of pairs apart fall
// on distinct banks within each phase of a warp's load
__host__ __device__ inline int entry_words(int Nm) { return 12 * Nm + 2; }

template <typename T>
__host__ __device__ inline size_t smem_bytes(int Nm, int Nr, int bz) {
  return bz == 0 ? 0
                 : sizeof(T) * static_cast<size_t>(bz + 2) * (Nr + 1) *
                       entry_words(Nm);
}

__device__ inline int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// floor(v) as an int, saturated far outside any grid (|v| < 2^30 is
// exact)
template <typename T>
__device__ inline int floor_int(T v) {
  const T f = floor(v), lim = T(1 << 30);
  return static_cast<int>(f < -lim ? -lim : (f > lim ? lim : f));
}

// Sign of the axis-guard row: transverse components flip by -(-1)^m,
// the z components (Ez, Bz) by (-1)^m
template <typename T>
__device__ inline T guard_sign(int comp, int m) {
  const T ms = (m & 1) ? T(-1) : T(1);
  return (comp == 2 || comp == 5) ? ms : -ms;
}

template <int BYTES>
__device__ inline void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES) : "memory");
}

// Stage z rows (col0 - 1 + j) mod Nz, j < nj, of every channel: entry
// (j, 1 + r) from the fields, entry (j, 0) the signed guard.  A warp
// copies one run of the fields that is contiguous in memory at a time:
// a (channel, z row) run of Nr radial rows when r is fastest, a
// (channel, radial row) run of nj z rows (split at the seam) when z is.
template <typename T>
__device__ void stage_rows(const GatherArgs<T>& a, T* tile, int col0,
                           int nj) {
  using P = typename Pair<T>::type;
  const int Nr = a.Nr, Nm = a.Nm, Nrx = Nr + 1, cmn = 6 * Nm;
  const size_t plane = static_cast<size_t>(a.Nz) * Nr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (a.sr == 1) {
    for (int p = warp; p < cmn * nj; p += n_warps) {
      const int cm = p / nj, j = p - cm * nj;
      const int comp = cm / Nm, m = cm - comp * Nm;
      const int zr = wrap(col0 - 1 + j, a.Nz);
      const T* src = a.f[comp] + 2 * (m * plane + zr * a.sz);
      T* dst = tile + (j * Nrx + 1) * a.rs + 2 * cm;
      for (int r = lane; r < Nr; r += 32)
        cp_async<sizeof(P)>(dst + r * a.rs, src + 2 * r);
    }
  } else {
    for (int p = threadIdx.x; p < cmn * Nr; p += blockDim.x) {
      const int cm = p / Nr, r = p - cm * Nr;
      const int comp = cm / Nm, m = cm - comp * Nm;
      const T* src = a.f[comp] + 2 * (m * plane + r * a.sr);
      T* dst = tile + (r + 1) * a.rs + 2 * cm;
      for (int j = 0; j < nj; ++j)
        cp_async<sizeof(P)>(dst + j * Nrx * a.rs,
                            src + 2 * wrap(col0 - 1 + j, a.Nz));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = threadIdx.x; e < cmn * nj; e += blockDim.x) {
    const int cm = e / nj, j = e - cm * nj;
    const int comp = cm / Nm, m = cm - comp * Nm;
    const P v = *reinterpret_cast<const P*>(
        a.f[comp] + 2 * (m * plane + wrap(col0 - 1 + j, a.Nz) * a.sz));
    const T s = guard_sign<T>(comp, m);
    *reinterpret_cast<P*>(tile + j * Nrx * a.rs + 2 * cm) =
        P{s * v.x, s * v.y};
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// What a live slot reads: its position and Kahan words
template <typename T>
struct Slot {
  T x, y, z, cx, cy, cz;
};

// The six outputs of a live slot in column col (the block's c-th).
// STAGED: corners from the block's tile; else from the fields directly.
template <typename T, bool STAGED>
__device__ inline void gather_slot(const GatherArgs<T>& a, T zmin,
                                   const T* tile,
                                   int c, int col, const Slot<T>& s,
                                   T* six) {
  using R = Rn<T>;
  using P = typename Pair<T>::type;
  const T x = s.x, y = s.y, zp = s.z;
  const T r = R::sqrt(R::add(R::mul(x, x), R::mul(y, y)));
  if (!(r < a.rmax)) return;
  T cs = T(1), sn = T(0);
  if (r != T(0)) {
    const T invr = R::div(T(1), r);
    cs = R::mul(x, invr);
    sn = R::mul(y, invr);
  }
  const T r_cell = R::sub(R::mul(a.invdr, R::sub(r, a.rmin)), T(0.5));
  const T z_cell = R::sub(R::mul(a.invdz, R::sub(zp, zmin)), T(0.5));
  const int ir = floor_int(r_cell), iz = floor_int(z_cell);
  T sru = R::sub(r_cell, T(ir)), szu = R::sub(z_cell, T(iz));
  if (a.cx != nullptr) {
    szu = R::add(szu, R::mul(a.invdz, s.cz));
    const T num = R::add(R::mul(x, s.cx), R::mul(y, s.cy));
    const T rc = r > T(1e-30) ? r : T(1e-30);
    sru = R::add(sru, R::mul(a.invdr, R::div(num, rc)));
  }
  const int lr = min(max(ir + 1, 0), a.Nr);
  const int ur = min(lr + 1, a.Nr);
  int delta = iz - col;
  if (a.periodic) delta = wrap(delta + a.Nz / 2, a.Nz) - a.Nz / 2;
  const int olo = min(max(delta, -1), 1) + 1;
  const int ohi = min(olo + 1, 2);

  const T srl = T(1) - sru, szl = T(1) - szu;
  const T w00 = szl * srl, w01 = szl * sru;
  const T w10 = szu * srl, w11 = szu * sru;
  const int Nm = a.Nm;
  // corner (o, radial row) -> its entry: a tile offset (STAGED) or a
  // field offset in complex elements with the guard row's sign flag
  const T* e00 = nullptr; const T* e01 = nullptr;
  const T* e10 = nullptr; const T* e11 = nullptr;
  long long d00 = 0, d01 = 0, d10 = 0, d11 = 0;
  const size_t plane = static_cast<size_t>(a.Nz) * a.Nr;
  if (STAGED) {
    const int Nrx = a.Nr + 1;
    e00 = tile + ((c + olo) * Nrx + lr) * a.rs;
    e01 = tile + ((c + olo) * Nrx + ur) * a.rs;
    e10 = tile + ((c + ohi) * Nrx + lr) * a.rs;
    e11 = tile + ((c + ohi) * Nrx + ur) * a.rs;
  } else {
    const long long zl = wrap(col + olo - 1, a.Nz) * a.sz;
    const long long zh = wrap(col + ohi - 1, a.Nz) * a.sz;
    const long long rl = max(lr - 1, 0) * a.sr, ru = max(ur - 1, 0) * a.sr;
    d00 = zl + rl; d01 = zl + ru; d10 = zh + rl; d11 = zh + ru;
  }
  T pr = T(1), pi = T(0);
  for (int m = 0; m < Nm; ++m) {
    const T wm = m == 0 ? T(1) : T(2);
    const T ar = pr * wm, ai = -pi * wm;
#pragma unroll
    for (int comp = 0; comp < 6; ++comp) {
      P f00, f01, f10, f11;
      if (STAGED && PROBE != 0) {
        f00 = f01 = f10 = f11 = P{sru, szu};
      } else if (STAGED) {
        const int b = 2 * (comp * Nm + m);
        f00 = *reinterpret_cast<const P*>(e00 + b);
        f01 = *reinterpret_cast<const P*>(e01 + b);
        f10 = *reinterpret_cast<const P*>(e10 + b);
        f11 = *reinterpret_cast<const P*>(e11 + b);
      } else {
        const T* base = a.f[comp] + 2 * (m * plane);
        const T g = guard_sign<T>(comp, m);
        const T gl = lr == 0 ? g : T(1), gu = ur == 0 ? g : T(1);
        f00 = *reinterpret_cast<const P*>(base + 2 * d00);
        f01 = *reinterpret_cast<const P*>(base + 2 * d01);
        f10 = *reinterpret_cast<const P*>(base + 2 * d10);
        f11 = *reinterpret_cast<const P*>(base + 2 * d11);
        f00 = P{gl * f00.x, gl * f00.y};
        f10 = P{gl * f10.x, gl * f10.y};
        f01 = P{gu * f01.x, gu * f01.y};
        f11 = P{gu * f11.x, gu * f11.y};
      }
      const T re = w00 * f00.x + w01 * f01.x + w10 * f10.x + w11 * f11.x;
      const T im = w00 * f00.y + w01 * f01.y + w10 * f10.y + w11 * f11.y;
      six[comp] += re * ar + im * ai;
    }
    const T pr_n = pr * cs + pi * sn;
    pi = pi * cs - pr * sn;
    pr = pr_n;
  }
  const T er = six[0], et = six[1], br = six[3], bt = six[4];
  six[0] = cs * er - sn * et;
  six[1] = sn * er + cs * et;
  six[3] = cs * br - sn * bt;
  six[4] = sn * br + cs * bt;
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(N_THREADS)
gather_sorted_kernel(const __grid_constant__ GatherArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int bz = STAGED ? a.bz : 1;
  const int col0 = blockIdx.x * bz;
  const int ncol = min(bz, a.Nz - col0);
  // The block's slots of a column: runs of blockDim.x slots, every
  // gridDim.y-th run, so that the blocks of one column share its live
  // prefix evenly
  const int stride = gridDim.y * blockDim.x;
  const int k_first = blockIdx.y * blockDim.x + threadIdx.x;
  const size_t n_slots = static_cast<size_t>(a.Nz) * a.K;
  const T zmin = *a.zmin;

  if (STAGED) {
    // a block whose slots are all dead stages nothing
    int live = 0;
    for (int c = 0; c < ncol && !live; ++c)
      for (int k = k_first; k < a.K; k += stride)
        if (a.valid[static_cast<size_t>(col0 + c) * a.K + k]) {
          live = 1;
          break;
        }
    if (__syncthreads_or(live) && PROBE != 1)
      stage_rows(a, tile, col0, ncol + 2);
  }
  for (int c = 0; c < ncol; ++c) {
    const int col = col0 + c;
    const size_t row = static_cast<size_t>(col) * a.K;
    for (int k = k_first; k < a.K; k += UNROLL * stride) {
      // the flags, then the positions of the live ones, of UNROLL slots
      // in flight before any is computed
      bool live[UNROLL];
      Slot<T> sl[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int ku = k + u * stride;
        live[u] = ku < a.K && a.valid[row + ku];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const size_t i = row + k + u * stride;
        sl[u] = Slot<T>{};
        if (live[u]) {
          sl[u].x = a.x[i];
          sl[u].y = a.y[i];
          sl[u].z = a.z[i];
          if (a.cx != nullptr) {
            sl[u].cx = a.cx[i];
            sl[u].cy = a.cy[i];
            sl[u].cz = a.cz[i];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int ku = k + u * stride;
        if (ku >= a.K) break;
        T six[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
        if (live[u])
          gather_slot<T, STAGED>(a, zmin, tile, c, col, sl[u], six);
        const size_t i = row + ku;
#pragma unroll
        for (int q = 0; q < 6; ++q) a.out[q * n_slots + i] = six[q];
      }
    }
  }
}

template <typename T, bool STAGED>
int launch_kernel(const GatherArgs<T>& a, size_t smem, void* stream) {
  // largest dynamic shared memory granted so far, per device
  static size_t granted[fbpic_launch::MAX_DEVICES] = {};
  const int err = fbpic_launch::grant_smem(
      gather_sorted_kernel<T, STAGED>, smem, granted);
  if (err != 0) return err;
  static int sms[fbpic_launch::MAX_DEVICES] = {};
  const int n_sm = fbpic_launch::sm_count(sms);
  if (n_sm == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int bz = STAGED ? a.bz : 1;
  const int gx = (a.Nz + bz - 1) / bz;
  // split each column's slots until the grid fills the card, but keep at
  // least one run of N_THREADS slots a block
  const int max_split = (a.K + N_THREADS - 1) / N_THREADS;
  int gy = (n_sm * BLOCKS_PER_SM + gx - 1) / gx;
  gy = max(1, min(gy, max_split));
  gather_sorted_kernel<T, STAGED><<<dim3(gx, gy), N_THREADS, smem,
                                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: [x, y, z, valid, cx, cy, cz (null without Kahan words),
//        Er, Et, Ez, Br, Bt, Bz, out, zmin (one T on the device)]
template <typename T>
int launch(const void* const* ptrs, double invdz, double invdr,
           double rmin, double rmax, int Nz, int K, int Nr, int Nm,
           long long sz, long long sr, int periodic, int bz, void* stream) {
  if (Nz <= 0 || K <= 0 || Nr <= 0 || Nm <= 0 || bz < 0 || bz > BZ_MAX)
    return -1;
  if (ptrs[14] == nullptr) return -1;
  if ((ptrs[4] == nullptr) != (ptrs[5] == nullptr) ||
      (ptrs[4] == nullptr) != (ptrs[6] == nullptr))
    return -1;
  GatherArgs<T> a;
  a.x = static_cast<const T*>(ptrs[0]);
  a.y = static_cast<const T*>(ptrs[1]);
  a.z = static_cast<const T*>(ptrs[2]);
  a.valid = static_cast<const unsigned char*>(ptrs[3]);
  a.cx = static_cast<const T*>(ptrs[4]);
  a.cy = static_cast<const T*>(ptrs[5]);
  a.cz = static_cast<const T*>(ptrs[6]);
  for (int q = 0; q < 6; ++q) a.f[q] = static_cast<const T*>(ptrs[7 + q]);
  a.out = static_cast<T*>(const_cast<void*>(ptrs[13]));
  a.zmin = static_cast<const T*>(ptrs[14]);
  a.sz = sz;
  a.sr = sr;
  // the scalars as the plain version's float ops see them
  a.invdz = static_cast<T>(invdz);
  a.invdr = static_cast<T>(invdr);
  a.rmin = static_cast<T>(rmin);
  a.rmax = static_cast<T>(rmax);
  a.Nz = Nz; a.K = K; a.Nr = Nr; a.Nm = Nm; a.bz = bz;
  a.rs = entry_words(Nm);
  a.periodic = periodic != 0;
  return bz == 0 ? launch_kernel<T, false>(a, 0, stream)
                 : launch_kernel<T, true>(a, smem_bytes<T>(Nm, Nr, bz),
                                          stream);
}

}  // namespace

#define GATHER_ARGS                                                        \
  const void *const *ptrs, double invdz, double invdr, double rmin,      \
      double rmax, int Nz, int K, int Nr, int Nm, long long sz,           \
      long long sr, int periodic, int bz, void *stream
#define GATHER_CALL \
  ptrs, invdz, invdr, rmin, rmax, Nz, K, Nr, Nm, sz, sr, periodic, bz, \
      stream

extern "C" int gather_sorted_f32(GATHER_ARGS) {
  return launch<float>(GATHER_CALL);
}

extern "C" int gather_sorted_f64(GATHER_ARGS) {
  return launch<double>(GATHER_CALL);
}

// Dynamic shared memory a launch with these sizes requests (the wrapper's
// own reckoning, cuda_gather.gather_smem_bytes, is held against it), and
// the largest run of columns a block takes.
extern "C" int gather_smem_bytes(int dtype_bytes, int Nm, int Nr, int bz) {
  return static_cast<int>(dtype_bytes == 4 ? smem_bytes<float>(Nm, Nr, bz)
                                           : smem_bytes<double>(Nm, Nr, bz));
}

extern "C" int gather_bz_max() { return BZ_MAX; }
