"""Kernel-name classes of a step's device time, frozen from the port's
``chip_smoke.py`` (KERNEL_GROUPS, HOST_LAUNCH_CALLS): the first class
whose pattern a kernel's name matches takes its time."""
import functools
import re

#: The host's launch calls as the profiler names them: a kernel launch
#: and a CUDA graph's replay (one call for all the graph's kernels)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cudaGraphLaunch")

KERNEL_CLASSES = (
    ("K1", r"fused_contract_kernel"), ("K2", r"gather_sorted_kernel"),
    ("K3", r"dense_contract_kernel"),
    ("cross-card copies", r"copy_parts_kernel"),
    ("cross-card flag waits", r"flag_kernel"),
    ("sort / scan", r"[Ss]ort|[Ss]can|cub::|Onesweep|Histogram"),
    ("FFT (cuFFT)", r"fft|FFT"),
    ("GEMM / batched matmul (cuBLAS)", r"gemm|gemv|cutlass|xmma|"
     r"Kernel2|nvjet|splitK"),
    ("index / scatter / gather", r"index|[Ss]catter|[Gg]ather|take|put_"),
    ("copy / cat / fill", r"[Cc]opy|[Cc]at[A-Z]|CatArray|fill|[Mm]emcpy|"
     r"[Mm]emset"),
    ("reduction", r"reduce|[Rr]eduction|sum_|norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"))

_COMPILED = tuple((name, re.compile(pat)) for name, pat in KERNEL_CLASSES)


@functools.lru_cache(maxsize=4096)
def kernel_class(name):
    """The class of a kernel named ``name`` ("other" if none matches)."""
    return next((c for c, pat in _COMPILED if pat.search(name)), "other")
