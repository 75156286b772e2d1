// Sorted-layout field gather (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   fbpic_tpu/particles/pallas_gather.py::_gather_call
// reached through gather_sorted_pallas from
// gather.gather_fields_sorted.
//
// What it computes, per particle slot (col, k) of the sorted (Nz, K)
// layout: the bilinear 4-corner fetch of all C = 12*Nm field channels
// from Fg (Nz, Nr+1, C) -- the interpolation-grid E/B with a signed
// axis-guard row prepended -- at z rows (col + o - D) mod Nz for the
// low / high z offsets and radial rows l_r / min(l_r + 1, Nr), weighted
// by Sz * Sr * ok; the mode sum Re(F_m e^{-i m theta}) with weights
// 1 (m = 0) and 2 (m > 0); and the rotation to Cartesian
// (Ex, Ey, Ez, Bx, By, Bz).  Index semantics follow the XLA path of
// gather_fields_sorted exactly (z mod Nz for open and periodic z,
// o_hi = min(o_lo + 1, n_off - 1), u_r = min(l_r + 1, Nr)).
//
// Design.  One thread per particle slot; everything stays in registers
// and the six outputs are written once, coalesced.  The TPU kernel's
// corner-baked F4 / one-hot MXU fetch is not needed: Fg is read
// directly (4 corners x C contiguous words per particle).
//
// What bounds it on H100: Fg is small (~5.5 MB at the LWFA bench
// shape) and stays in L2, so the kernel is bound by the per-particle
// streams: 7 words in and 6 words out per slot, ~0.1 GB per step at the
// bench shape (~30 us at 3.35 TB/s).  The corner reads are gathers, but
// the particles of one column share two z rows, so they hit L1/L2.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void gather_sorted_kernel(
    const int* __restrict__ o_lo, const int* __restrict__ l_r,
    const T* __restrict__ sr_u, const T* __restrict__ sz_u,
    const T* __restrict__ ok, const T* __restrict__ cosv,
    const T* __restrict__ sinv, const T* __restrict__ Fg,
    T* __restrict__ out, int Nz, int K, int Nr, int Nm, int n_off) {
  const size_t n_slots = static_cast<size_t>(Nz) * K;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= n_slots) return;
  const int col = static_cast<int>(idx / K);
  const int D = (n_off - 1) / 2;
  const int C = 12 * Nm;
  const int Nrx = Nr + 1;

  const int o = o_lo[idx];
  const int oh = min(o + 1, n_off - 1);
  const int lr = l_r[idx];
  const int ur = min(lr + 1, Nr);
  const int izl = ((col + o - D) % Nz + Nz) % Nz;
  const int izh = ((col + oh - D) % Nz + Nz) % Nz;

  const T sru = sr_u[idx], szu = sz_u[idx], okv = ok[idx];
  const T srl = T(1) - sru, szl = T(1) - szu;
  const T w00 = szl * srl * okv, w01 = szl * sru * okv;
  const T w10 = szu * srl * okv, w11 = szu * sru * okv;
  const T* F00 = Fg + (static_cast<size_t>(izl) * Nrx + lr) * C;
  const T* F01 = Fg + (static_cast<size_t>(izl) * Nrx + ur) * C;
  const T* F10 = Fg + (static_cast<size_t>(izh) * Nrx + lr) * C;
  const T* F11 = Fg + (static_cast<size_t>(izh) * Nrx + ur) * C;

  const T cs = cosv[idx], sn = sinv[idx];
  T six[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  T pr = T(1), pi = T(0);
  for (int m = 0; m < Nm; ++m) {
    const T wm = m == 0 ? T(1) : T(2);
    for (int comp = 0; comp < 6; ++comp) {
      const int b = (comp * Nm + m) * 2;
      const T re = w00 * F00[b] + w01 * F01[b] + w10 * F10[b] +
                   w11 * F11[b];
      const T im = w00 * F00[b + 1] + w01 * F01[b + 1] +
                   w10 * F10[b + 1] + w11 * F11[b + 1];
      six[comp] += re * (pr * wm) + im * (-pi * wm);
    }
    const T pr_n = pr * cs + pi * sn;
    pi = pi * cs - pr * sn;
    pr = pr_n;
  }
  out[idx] = cs * six[0] - sn * six[1];
  out[n_slots + idx] = sn * six[0] + cs * six[1];
  out[2 * n_slots + idx] = six[2];
  out[3 * n_slots + idx] = cs * six[3] - sn * six[4];
  out[4 * n_slots + idx] = sn * six[3] + cs * six[4];
  out[5 * n_slots + idx] = six[5];
}

template <typename T>
int launch(const void* o_lo, const void* l_r, const void* sr_u,
           const void* sz_u, const void* ok, const void* cosv,
           const void* sinv, const void* Fg, void* out, int Nz, int K,
           int Nr, int Nm, int n_off, void* stream) {
  const size_t n_slots = static_cast<size_t>(Nz) * K;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n_slots + threads - 1) /
                                                threads);
  gather_sorted_kernel<T><<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(o_lo), static_cast<const int*>(l_r),
      static_cast<const T*>(sr_u), static_cast<const T*>(sz_u),
      static_cast<const T*>(ok), static_cast<const T*>(cosv),
      static_cast<const T*>(sinv), static_cast<const T*>(Fg),
      static_cast<T*>(out), Nz, K, Nr, Nm, n_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define GATHER_ARGS                                                         \
  const void *o_lo, const void *l_r, const void *sr_u, const void *sz_u,   \
      const void *ok, const void *cosv, const void *sinv, const void *Fg,  \
      void *out, int Nz, int K, int Nr, int Nm, int n_off, void *stream
#define GATHER_CALL \
  o_lo, l_r, sr_u, sz_u, ok, cosv, sinv, Fg, out, Nz, K, Nr, Nm, n_off, stream

extern "C" int gather_sorted_f32(GATHER_ARGS) {
  return launch<float>(GATHER_CALL);
}

extern "C" int gather_sorted_f64(GATHER_ARGS) {
  return launch<double>(GATHER_CALL);
}
