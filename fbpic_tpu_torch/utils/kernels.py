"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Builds happen at first use (never at import), one ``nvcc`` per source,
all started together, into ``fbpic_tpu_torch/_build/`` (git-ignored).
A library's file name carries a hash of its source and of every header
in ``csrc/``, so an edited source or header is rebuilt and a stale
library is never loaded.

Also here: what the kernel wrappers share on the Python side (operand
checks, the table of operand pointers, the radial-row tiling against
the card's shared memory).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("fused_deposit", "dense_deposit", "gather", "peer", "spans")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
# argtypes of every exported C function (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
_SIGNATURES = {
    "fused_contract_f32": [_P] + [_I] * 9 + [_P],
    "fused_contract_f64": [_P] + [_I] * 9 + [_P],
    "fused_contract_smem_bytes": [_I] * 7,
    "dense_contract_f32": [_P] + [_I] * 6 + [_P],
    "dense_contract_f64": [_P] + [_I] * 6 + [_P],
    "dense_contract_smem_bytes": [_I] * 4,
    "gather_sorted_f32": [_P] + [_D] * 4 + [_I] * 4 + [_L] * 2 + [_I] * 2
                         + [_P],
    "gather_sorted_f64": [_P] + [_D] * 4 + [_I] * 4 + [_L] * 2 + [_I] * 2
                         + [_P],
    "gather_smem_bytes": [_I] * 4,
    "gather_bz_max": [],
    "peer_enable_access": [_I, _I],
    "peer_copy_parts": [_P, _P, _P, _I, _P, _P, _I, _P],
    "peer_take_flag": [_P, _P, ctypes.c_ulonglong, _P],
    "peer_give_flag": [_P, _P],
    "span_load": [],
    "span_launch": [_I, _P],
    "span_find": [_P, _P, _I, _P],
    "span_set_enabled": [_P, _P, _I, _I],
}

_libs = {}
#: Builds and library loads happen under this lock: the slab threads of
#: a decomposed run (parallel/) never start two nvcc on one source
_build_lock = threading.RLock()
#: Launch counts are read-modify-written under this lock
_count_lock = threading.Lock()
#: The slab (rank) of the running thread in a decomposed run, or None
current_slab = threading.local()


#: Every kernel wrapper that has counted a launch
_counted = set()


def count_launch(fn):
    """Count one launch of kernel wrapper ``fn``: ``fn.launches`` and,
    in a slab thread of a decomposed run, ``fn.launches_by_slab[rank]``
    (safe across threads)."""
    rank = getattr(current_slab, "rank", None)
    with _count_lock:
        _counted.add(fn)
        fn.launches += 1
        if rank is not None:
            by_slab = fn.__dict__.setdefault("launches_by_slab", {})
            by_slab[rank] = by_slab.get(rank, 0) + 1


def launch_counts():
    """{wrapper: launches} of every wrapper that has counted one."""
    with _count_lock:
        return {fn: fn.launches for fn in _counted}


def slab_launch_counts():
    """{wrapper: {slab rank: launches}} of every wrapper that has counted
    one in a slab thread."""
    with _count_lock:
        return {fn: dict(fn.__dict__.get("launches_by_slab", {}))
                for fn in _counted}


def add_launches(delta, by_slab=None):
    """Add {wrapper: n} to the wrappers' counts, and {wrapper: {slab
    rank: n}} to their per-slab counts (n may be negative).  A CUDA
    graph's capture runs the wrappers' Python, which counts, but
    launches nothing; its replays launch what it recorded without
    running any Python: core/graph.py takes each capture's counts back
    out with this and adds them again at every replay."""
    with _count_lock:
        for fn, n in delta.items():
            _counted.add(fn)
            fn.launches += n
        for fn, ranks in (by_slab or {}).items():
            _counted.add(fn)
            counts = fn.__dict__.setdefault("launches_by_slab", {})
            for rank, n in ranks.items():
                counts[rank] = counts.get(rank, 0) + n


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "fbpic_tpu_torch are built with the CUDA toolkit")
    return path


def _lib_path(name):
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all():
    """Compile every source whose library is missing, in parallel.

    Returns {name: compiler log} for the sources built by this call
    (``-Xptxas -v`` prints each kernel's registers, shared memory and
    spills).  Raises with the compiler output if a build fails."""
    with _build_lock:
        return _build_all()


def _build_all():
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
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        return _load(name)


def _load(name):
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


# --- what the contraction wrappers (K1, K3) share ---------------------

#: Shared memory one block may ask for on Hopper (227 KB), and what the
#: kernels hold statically beside their dynamic request
SMEM_PER_BLOCK = 232448
SMEM_STATIC = 64
#: Slots per staged tile and tiles in the ring (csrc/contract_common.cuh)
TP, NSTAGE = 128, 2
#: Most z-offset blocks of one window the kernels take
MAX_OFF = 8


def align16(n):
    return (n + 15) & ~15


def stage_bytes(esize, words, n_i64):
    """Bytes of one staged tile: `words` float words, `n_i64` int64
    indices and the bool below-axis flag per slot."""
    return TP * (words * esize + 8 * n_i64 + 1)


def pick_row_tiling(Nrb, smem_bytes_of, limit=SMEM_PER_BLOCK - SMEM_STATIC):
    """Fewest tiles of radial rows whose block fits the card's shared
    memory: (Rt, n_tiles) with Rt rows a tile.  ``smem_bytes_of(Rt)`` is
    the dynamic shared memory of a block that accumulates Rt rows."""
    for n_tiles in range(1, Nrb + 1):
        Rt = -(-Nrb // n_tiles)
        if smem_bytes_of(Rt) <= limit:
            return Rt, -(-Nrb // Rt)
    raise ValueError(f"no tiling of {Nrb} radial rows fits {limit} bytes "
                     f"of shared memory")


def check_operand(what, name, t, device, dtype, shape):
    """Raise unless tensor `t` is what the kernel reads in place: on
    `device`, of `dtype`, of `shape`, and contiguous."""
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, not "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")


def pointer_table(tensors):
    """The tensors' addresses as a C array of pointers (host memory; the
    launcher copies it into the kernel's by-value arguments); None for an
    operand left out."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
