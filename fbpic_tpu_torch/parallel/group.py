"""The slab group: one Python thread per z slab, in one process.

fbpic_tpu runs a z-decomposed simulation in one process over a mesh of
devices (``shard_map`` with ``ppermute``).  The port keeps that model:
each slab runs its step in a thread of its own, and the threads meet
only in the collectives of this module -- the two ring shifts of
``ppermute`` (``shift_both``), ``psum`` and ``all_gather`` -- built on
a mailbox and a ``threading.Barrier``:

- the barrier has a timeout (``BARRIER_TIMEOUT`` seconds by default), so
  a slab that never arrives ends the run instead of hanging it;
- a slab that raises aborts the barrier (``run``): the others raise
  ``BrokenBarrierError`` at their next collective, and the run fails
  with the first slab's own exception;
- ``psum`` adds the slabs' values in rank order on every slab: each
  slab gets the same, deterministic result;
- slabs on CUDA devices take turns: one thread issues at a time and
  hands the turn on at a collective (their ops only queue launches;
  two threads issuing at once hand the interpreter lock back and forth
  at every launch); CPU slabs run side by side.

Tensors travel between slabs by reference.  Slabs on one card issue on
one stream -- its current stream, or the stream ``run`` is given (a
CUDA graph's capture stream: the capture then records every slab's work
in issue order) --, so issue order orders a sender's writes before a
receiver's reads.  Slabs on different cards copy with
``Tensor.to(device, non_blocking=True)``: torch's cross-device copy
already makes the copy wait for both cards' current streams and makes
the destination's current stream wait for the copy (a two-way event
barrier, aten/src/ATen/native/cuda/Copy.cu), so no further stream
dependency is needed as long as every slab thread issues on its card's
current stream -- the default stream, which is the same for every thread.
"""
import threading

import torch

from ..utils import kernels

#: Seconds a slab waits at a collective before the run fails
BARRIER_TIMEOUT = 600.0


class SlabGroup:
    """The collectives of ``size`` slabs, slab ``rank`` on ``devices[rank]``.

    A collective is one barrier wait: the values are posted to a
    mailbox, which alternates between two sets of slots so that a slab
    running ahead into the next collective never overwrites a value a
    slower slab has still to read."""

    def __init__(self, devices, timeout=BARRIER_TIMEOUT):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.timeout = timeout
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        self._box = [[None] * self.size, [None] * self.size]
        self._calls = [0] * self.size
        #: CUDA slabs only queue launches: one thread at a time issues,
        #: and the turn passes at a collective, so the threads do not
        #: hand the interpreter lock to each other at every launch.  CPU
        #: slabs compute in their ops, side by side.
        self._turn = (threading.Lock() if all(d.type == "cuda"
                                              for d in self.devices)
                      else None)

    def comm(self, rank):
        """The handle slab ``rank`` calls the collectives through."""
        return SlabComm(self, rank)

    def run(self, fn, stream=None):
        """Run ``fn(rank)`` for every slab, each in a thread of its own
        (set to its slab's CUDA device; the kernel launch counters count
        per slab), and return the results in rank order.  ``stream``: a
        CUDA stream every thread enters as its current stream (torch's
        current stream is per thread) -- a graph's capture stream, whose
        capture then records every slab's work in issue order; by
        default each thread issues on its card's current stream.  A slab
        that raises aborts the barrier; the first slab exception that is
        not the others' ``BrokenBarrierError`` is raised here once every
        thread has ended."""
        if self._barrier.broken:
            self._barrier.reset()
        self._calls = [0] * self.size
        results = [None] * self.size
        errors = [None] * self.size

        def body(rank):
            kernels.current_slab.rank = rank
            if self._turn is not None:
                self._turn.acquire()
            try:
                dev = self.devices[rank]
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                if stream is None:
                    results[rank] = fn(rank)
                else:
                    with torch.cuda.stream(stream):
                        results[rank] = fn(rank)
            except BaseException as exc:   # noqa: BLE001 -- re-raised below
                errors[rank] = exc
                self._barrier.abort()
            finally:
                if self._turn is not None:
                    self._turn.release()

        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"slab-{r}", daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        own = [e for e in errors if e is not None
               and not isinstance(e, threading.BrokenBarrierError)]
        if own:
            raise own[0]
        broken = [e for e in errors if e is not None]
        if broken:
            raise RuntimeError(
                f"a slab waited more than {self.timeout} s at a "
                f"collective") from broken[0]
        return results


class SlabComm:
    """Slab ``rank``'s view of its group: the collectives, called by
    every slab of the group in the same order."""

    def __init__(self, group, rank):
        self.group = group
        self.rank = rank
        self.size = group.size
        self.device = group.devices[rank]

    def all_gather(self, value):
        """Every slab's ``value`` (any object), in rank order."""
        g = self.group
        slot = g._box[g._calls[self.rank] % 2]
        g._calls[self.rank] += 1
        slot[self.rank] = value
        if g._turn is None:
            g._barrier.wait()
            return list(slot)
        g._turn.release()
        try:
            g._barrier.wait()
        finally:
            g._turn.acquire()
        return list(slot)

    def _here(self, t):
        return t.to(self.device, non_blocking=True)

    def shift_both(self, to_right, to_left):
        """The two ring shifts of ppermute in one collective, i -> i + 1
        and i + 1 -> i (mod size): (the left slab's ``to_right``, the
        right slab's ``to_left``), lists of tensors on this slab's
        device."""
        got = self.all_gather((to_right, to_left))
        left = got[(self.rank - 1) % self.size][0]
        right = got[(self.rank + 1) % self.size][1]
        return [self._here(t) for t in left], [self._here(t) for t in right]

    def psum(self, value):
        """The sum over slabs, added in rank order: a tensor (on this
        slab's device), a number, or a dict / list of them."""
        vals = self.all_gather(value)
        return _sum_in_order(vals, self._here)


def _sum_in_order(vals, here):
    first = vals[0]
    if isinstance(first, dict):
        return {k: _sum_in_order([v[k] for v in vals], here) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_sum_in_order([v[i] for v in vals], here)
                           for i in range(len(first)))
    if torch.is_tensor(first):
        acc = here(first)
        for v in vals[1:]:
            acc = acc + here(v)
        return acc
    return sum(vals[1:], first)
