// The cross-card exchange of a decomposed run: device-side copies into
// a peer card's receive buffers and the flags that order them
// (fbpic_tpu_torch/parallel/group.py, through parallel/peer.py).
//
// Replaces no Pallas kernel.  fbpic_tpu moves its guard strips,
// migrants and counters between devices with XLA collectives
// (``ppermute`` and ``psum`` in fbpic_tpu/parallel/domain.py:58-228,
// :398-404); the port's slabs on different cards exchange them with
// these kernels, which a CUDA graph captures like any other kernel, so
// the exchange replays inside each card's graph.
//
// - ``copy_parts``: up to MAX_PARTS contiguous byte ranges in one launch
//   (blockIdx.y the part), 16-byte words where both ends are aligned.
//   With peer access enabled a pointer into another card's memory is
//   written through NVLink, so the sender pushes its strips straight
//   into the receiver's buffers.  Given a flag, the launch also gives it
//   once every block's writes are visible system-wide: each thread
//   fences (``__threadfence_system``) after its writes, each block counts
//   itself in ``arrived`` and the last one gives the flag.  A flag given
//   by a later kernel would not do: the copy's stores to the peer travel
//   over several NVLink links and may land after a later kernel's store
//   of the flag, so the receiver could read a strip of the step before.
//   Bound by bytes: the link's rate (450 GB/s each way on an H100 SXM)
//   for a peer write, device memory for a local copy; the strips are
//   small (tens to hundreds of KB), so at these sizes the launch and the
//   link's latency dominate.
// - ``take_flag`` / ``give_flag``: a one-token semaphore in a 32-bit
//   word of device memory.  ``give`` writes 1 after a system-wide fence;
//   ``take`` (one thread) spins until it reads 1 and writes 0 back.  Each
//   buffer set of a channel (sender slab -> receiver slab) has two:
//   ``ready`` (on the receiver's card, starts at 0) and ``free`` (on the
//   sender's card, starts at 1).  The sender takes ``free`` and copies,
//   the copy giving ``ready``; the receiver takes ``ready``, copies the
//   buffers out (its own loads, done when that kernel ends) and gives
//   ``free``.  The token is in device memory and not in a CUDA event: a
//   captured event wait waits on the record most recently issued from
//   the host, so with one graph a card, launched in turn, a wait could
//   pass on the previous step's record.  A token cannot be taken twice.
//   ``take`` gives up after ``timeout_ns`` (a missing ``give`` would
//   otherwise hang the card), adds one to ``fault[0]``, logs the flag's
//   address in ``fault[1..8]`` and goes on; the chunk's one host read
//   sees the fault and raises, naming the channels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_PARTS = 32;
constexpr int COPY_THREADS = 256;
constexpr int MAX_COPY_BLOCKS = 264;  // two a multiprocessor
constexpr unsigned long long FAULT_LOG = 8;  // flags logged a card

struct Parts {
  const char* src[MAX_PARTS];
  char* dst[MAX_PARTS];
  long long nbytes[MAX_PARTS];
};

__global__ void __launch_bounds__(COPY_THREADS)
    copy_parts_kernel(Parts parts, int* flag, unsigned int* arrived,
                      int fence) {
  const int p = blockIdx.y;
  const char* src = parts.src[p];
  char* dst = parts.dst[p];
  const long long n = parts.nbytes[p];
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const long long words = n / 16;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (long long i = first; i < words; i += stride) d[i] = s[i];
    done = words * 16;
  }
  for (long long i = done + first; i < n; i += stride) dst[i] = src[i];
  if (flag == nullptr && !fence) return;
  __threadfence_system();
  if (flag == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int blocks = gridDim.x * gridDim.y;
    if (atomicAdd(arrived, 1u) == blocks - 1) {
      atomicExch(arrived, 0u);
      __threadfence_system();
      *reinterpret_cast<volatile int*>(flag) = 1;
      __threadfence_system();
    }
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void take_flag_kernel(int* flag, long long* fault,
                                 unsigned long long timeout_ns) {
  volatile int* f = flag;
  const unsigned long long t0 = global_ns();
  while (*f == 0) {
    if (global_ns() - t0 > timeout_ns) {
      const unsigned long long i = atomicAdd(
          reinterpret_cast<unsigned long long*>(fault), 1ull);
      if (i < FAULT_LOG) fault[1 + i] = reinterpret_cast<long long>(flag);
      break;
    }
    __nanosleep(200);
  }
  __threadfence_system();
  *f = 0;
  __threadfence_system();
}

__global__ void give_flag_kernel(int* flag) {
  __threadfence_system();
  *reinterpret_cast<volatile int*>(flag) = 1;
  __threadfence_system();
}

}  // namespace

extern "C" {

// Let `device` read and write `peer`'s memory (a host operation: made
// before any capture).  Already enabled is no error.  The calling
// thread's current device is restored.
int peer_enable_access(int device, int peer) {
  int was = 0;
  cudaError_t err = cudaGetDevice(&was);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      (void)cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaError_t back = cudaSetDevice(was);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

// Copy n_parts byte ranges (src[i] -> dst[i], nbytes[i] bytes) in one
// launch on `stream` of the current device.  `flag` (or null): given (set
// to 1) once every write of the launch is visible system-wide, counted
// in `arrived` (a zero word of this device, left at zero); `fence`: each
// thread fences its writes system-wide without a flag (a launch before
// the one that gives it).
int peer_copy_parts(void** src, void** dst, const long long* nbytes,
                    int n_parts, void* flag, void* arrived, int fence,
                    void* stream) {
  if (n_parts <= 0) return 0;
  if (n_parts > MAX_PARTS) return static_cast<int>(cudaErrorInvalidValue);
  Parts parts;
  long long most = 0;
  for (int i = 0; i < MAX_PARTS; ++i) {
    const bool on = i < n_parts;
    parts.src[i] = on ? static_cast<const char*>(src[i]) : nullptr;
    parts.dst[i] = on ? static_cast<char*>(dst[i]) : nullptr;
    parts.nbytes[i] = on ? nbytes[i] : 0;
    if (on && nbytes[i] > most) most = nbytes[i];
  }
  long long blocks = (most / 16 + COPY_THREADS - 1) / COPY_THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_COPY_BLOCKS) blocks = MAX_COPY_BLOCKS;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_parts));
  copy_parts_kernel<<<grid, COPY_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      parts, static_cast<int*>(flag), static_cast<unsigned int*>(arrived),
      fence);
  return static_cast<int>(cudaGetLastError());
}

int peer_take_flag(void* flag, void* fault, unsigned long long timeout_ns,
                   void* stream) {
  take_flag_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(flag), static_cast<long long*>(fault), timeout_ns);
  return static_cast<int>(cudaGetLastError());
}

int peer_give_flag(void* flag, void* stream) {
  give_flag_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(flag));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
