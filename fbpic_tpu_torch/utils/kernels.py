"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Builds happen at first use (never at import), one ``nvcc`` per source,
all started together, into ``fbpic_tpu_torch/_build/`` (git-ignored).
A library's file name carries a hash of its source, so an edited source
is rebuilt and a stale library is never loaded.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("fused_deposit", "gather")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of every exported C function (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
_SIGNATURES = {
    "fused_contract_f32": [_P] * 13 + [_I] * 11 + [_P],
    "fused_contract_f64": [_P] * 13 + [_I] * 11 + [_P],
    "fused_contract_smem_bytes": [_I] * 7,
    "gather_sorted_f32": [_P] * 9 + [_I] * 5 + [_P],
    "gather_sorted_f64": [_P] * 9 + [_I] * 5 + [_P],
}

_libs = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "fbpic_tpu_torch are built with the CUDA toolkit")
    return path


def _lib_path(name):
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all():
    """Compile every source whose library is missing, in parallel.

    Returns {name: compiler log} for the sources built by this call
    (``-Xptxas -v`` prints each kernel's registers, shared memory and
    spills).  Raises with the compiler output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, target, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (tmp, target, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, target)
        logs[name] = log
    return logs


def library(name):
    """The loaded ctypes library of csrc/<name>.cu (built if needed)."""
    if name not in _libs:
        if not _lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def check_launch(code, what):
    """Raise if a C launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {code}")
