"""The device side of the cross-card exchange (csrc/peer.cu).

The slabs of a decomposed run on different cards (``parallel.group``)
exchange their guard strips, migrants and counters with these calls, on
the current stream of the calling thread's card, with no host
synchronization, so a CUDA graph captures them like any kernel:

- ``copy_parts(dst, src, flag, arrived)``: each contiguous ``src[i]``
  into ``dst[i]`` (same shape and dtype; ``dst`` may lie on a peer
  card), one launch for up to 32 tensors, and, given a flag, the flag
  given once the writes are visible to the peer; on CPU tensors its
  plain version, ``copy_``;
- ``take_flag(flag, fault)`` / ``give_flag(flag)``: a one-token
  semaphore in a 0-d int32 device tensor (``take`` waits for 1 and
  writes 0; it gives up after ``FLAG_TIMEOUT`` seconds, adds one to
  ``fault[0]`` and logs the flag's address in ``fault[1:]``, a
  ``fault_log()`` of the card);
- ``enable_access(a, b)``: card ``a`` reads and writes card ``b``'s
  memory (a host operation, made before any capture); raises where the
  cards have no peer access.

fbpic_tpu's counterpart is XLA's collectives (``ppermute``, ``psum``),
not a Pallas kernel.
"""
import ctypes

import torch

from ..utils import kernels

#: Seconds a card waits for a peer's flag before it counts a fault
FLAG_TIMEOUT = 20.0
#: Tensors a copy launch takes (csrc/peer.cu MAX_PARTS)
MAX_PARTS = 32
#: Timed-out flags a fault log keeps (csrc/peer.cu FAULT_LOG)
FAULT_LOG = 8


def fault_log(device):
    """A card's fault log: int64 [timed-out waits, the addresses of the
    first FAULT_LOG flags that timed out]."""
    return torch.zeros(1 + FAULT_LOG, dtype=torch.int64, device=device)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def enable_access(a, b):
    """Let card ``a`` read and write card ``b``'s memory."""
    if not torch.cuda.can_device_access_peer(a, b):
        raise RuntimeError(f"cuda:{a} has no peer access to cuda:{b}: the "
                           f"slabs' exchange between these cards copies "
                           f"from card to card")
    kernels.check_launch(kernels.library("peer").peer_enable_access(a, b),
                         f"peer access cuda:{a} -> cuda:{b}")


def copy_parts_plain(dst, src):
    """Plain version of ``copy_parts``."""
    for d, s in zip(dst, src):
        d.copy_(s)


def copy_parts(dst, src, flag=None, arrived=None):
    """Copy every tensor of ``src`` into the tensor of ``dst`` beside it
    (both contiguous, of one shape and dtype), on the current stream of
    the current card: one launch for up to 32 tensors.  ``flag`` (a 0-d
    int32 tensor, on a peer card or this one): given (set to 1) by the
    last launch once every write is visible system-wide, its blocks
    counted in ``arrived`` (a 0-d int32 zero on this card, left at
    zero).  CPU tensors take the plain version (no flag)."""
    if len(dst) != len(src):
        raise ValueError("copy_parts: as many destinations as sources")
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"copy_parts: {tuple(s.shape)} {s.dtype} into "
                             f"{tuple(d.shape)} {d.dtype}")
        if not (d.is_contiguous() and s.is_contiguous()):
            raise ValueError("copy_parts: the tensors must be contiguous")
    if not src:
        return
    if not src[0].is_cuda:
        copy_parts_plain(dst, src)
        return
    if any(not t.is_cuda for t in list(dst) + list(src)):
        raise ValueError("copy_parts: CUDA and CPU tensors mixed")
    if flag is not None:
        _flag_check(flag, "copy_parts' flag")
        _flag_check(arrived, "copy_parts' arrival count")
    lib = kernels.library("peer")
    for at in range(0, len(src), MAX_PARTS):
        d, s = dst[at:at + MAX_PARTS], src[at:at + MAX_PARTS]
        n = len(s)
        last = at + MAX_PARTS >= len(src)
        give = flag is not None and last
        kernels.check_launch(lib.peer_copy_parts(
            kernels.pointer_table(s), kernels.pointer_table(d),
            (ctypes.c_longlong * n)(*[t.numel() * t.element_size()
                                      for t in s]),
            n, ctypes.c_void_p(flag.data_ptr() if give else None),
            ctypes.c_void_p(arrived.data_ptr() if give else None),
            int(flag is not None and not last), _stream()), "copy_parts")
        kernels.count_launch(copy_parts)


copy_parts.launches = 0


def _flag_check(flag, what):
    if not (flag.is_cuda and flag.dtype == torch.int32 and flag.dim() == 0):
        raise ValueError(f"{what}: a 0-d int32 CUDA tensor, not "
                         f"{flag.dtype} {tuple(flag.shape)} on "
                         f"{flag.device}")


def take_flag(flag, fault):
    """Wait on the current stream until ``flag`` is 1, then set it to 0
    (after FLAG_TIMEOUT seconds: log the flag in ``fault``, this card's
    ``fault_log``, and go on)."""
    _flag_check(flag, "take_flag")
    if not (fault.is_cuda and fault.dtype == torch.int64
            and tuple(fault.shape) == (1 + FAULT_LOG,)):
        raise ValueError("take_flag: the fault log is a fault_log()")
    kernels.check_launch(kernels.library("peer").peer_take_flag(
        ctypes.c_void_p(flag.data_ptr()), ctypes.c_void_p(fault.data_ptr()),
        int(FLAG_TIMEOUT * 1e9), _stream()), "take_flag")


def give_flag(flag):
    """Set ``flag`` to 1 once the current stream's earlier work is done
    (``flag`` may lie on a peer card)."""
    _flag_check(flag, "give_flag")
    kernels.check_launch(kernels.library("peer").peer_give_flag(
        ctypes.c_void_p(flag.data_ptr()), _stream()), "give_flag")
