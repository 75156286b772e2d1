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

The slabs fall into groups, one a device (``card_groups``).  Within a
group tensors travel by reference: the slabs of one card issue on one
stream -- the card's current stream, or the stream ``run`` gives the
card (a CUDA graph's capture stream: the capture then records every
slab's work in issue order) --, so issue order orders a sender's writes
before a receiver's reads.  Between groups a tensor is copied into a
receive buffer on the receiving slab's device (``_Channels``): the
sender writes it before the collective's barrier, the receiver copies it
out after.  A channel (sender, receiver) has two sets of buffers, used
in turn by its messages: a sender can be one collective ahead of its
receiver, not two.  On the cards both copies are device work on each
card's own stream, ordered by flags in device memory (csrc/peer.cu), a
``ready`` and a ``free`` flag for each set: the sender takes the set's
``free`` token before it writes, and its copy gives ``ready`` once its
writes are visible on the receiving card; the receiver takes ``ready``
before it reads and gives ``free`` once its copy is out.
Nothing of it waits on the host or on torch's cross-device copy (which
would make both cards' *current* streams wait on each other, a stream
the other card's capture does not hold), so a card's CUDA graph
captures its sends and receives, and one graph a card replays the
exchange.

Why the flags cannot deadlock: every collective issues all of its sends
before its barrier and its receives after.  A receive's ``ready`` comes
from a send issued before any receive of its collective; a send's
``free`` comes from the receive of its set's previous message, at least
two collectives back, issued before the previous collective's barrier.
The threads of one card may still put one slab's send of collective k
ahead of another slab's receive of k - 1 in the card's stream; with one
set a channel, that send would wait on a receive of k - 1 which another
card may hold behind a wait on this card, and two cards could wait on
each other.  With two sets no wait sits in any stream ahead of a give it
depends on, and a host synchronization after a collective never waits
on a slab that has not issued yet.  On the CPU the same path is a plain
copy into the buffer and out of it.
"""
import contextlib
import threading

import torch

from ..utils import kernels
from . import peer

#: Seconds a slab waits at a collective before the run fails
BARRIER_TIMEOUT = 600.0


def card_groups(devices):
    """The slabs (ranks) of ``devices`` in groups, one a device, in the
    order of each device's first slab: the slabs of a group exchange
    tensors by reference, the groups through receive buffers."""
    groups = {}
    for rank, d in enumerate(devices):
        groups.setdefault(torch.device(d), []).append(rank)
    return list(groups.values())


class SlabGroup:
    """The collectives of ``size`` slabs, slab ``rank`` on ``devices[rank]``.

    A collective is one barrier wait: the values are posted to a
    mailbox, which alternates between two sets of slots so that a slab
    running ahead into the next collective never overwrites a value a
    slower slab has still to read.  ``groups``: the slabs in groups of
    one device each (``card_groups``), ``cards`` the device of each
    group."""

    def __init__(self, devices, timeout=BARRIER_TIMEOUT):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.timeout = timeout
        self.groups = card_groups(self.devices)
        self.cards = [self.devices[g[0]] for g in self.groups]
        self._group_of = {r: i for i, g in enumerate(self.groups) for r in g}
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
        self.channels = (_Channels(self.devices, self._group_of)
                         if len(self.groups) > 1 else None)

    def comm(self, rank):
        """The handle slab ``rank`` calls the collectives through."""
        return SlabComm(self, rank)

    def same_group(self, a, b):
        return self._group_of[a] == self._group_of[b]

    def run(self, fn, streams=None, graphs=None):
        """Run ``fn(rank)`` for every slab, each in a thread of its own
        (set to its slab's CUDA device; the kernel launch counters count
        per slab), and return the results in rank order.

        ``streams``: {card: CUDA stream}, the stream each thread of the
        card enters as its current stream (torch's current stream is
        per thread); by default each thread issues on its card's current
        stream.  ``graphs``: {card: (CUDA graph, memory pool)}: the
        card's first slab begins the capture of its graph on its stream
        (``capture_error_mode`` "thread_local": only that thread is
        barred from the calls that are unsafe during a capture), every
        card's capture is open before any slab issues, each slab issues
        ``fn`` into its card's capture, and the first slab ends the
        capture once every slab has issued: the cards capture at the
        same time, their collectives meeting during the capture.  A
        slab that raises aborts the barrier (a capture it opened is
        ended); the first slab exception that is not the others'
        ``BrokenBarrierError`` is raised here once every thread has
        ended."""
        if self._barrier.broken:
            self._barrier.reset()
        self._calls = [0] * self.size
        if self.channels is not None:
            self.channels.reset()
        first = {self.devices[g[0]]: g[0] for g in self.groups}
        results = [None] * self.size
        errors = [None] * self.size

        def body(rank):
            kernels.current_slab.rank = rank
            if self._turn is not None:
                self._turn.acquire()
            opened = None
            try:
                dev = self.devices[rank]
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                stream = (streams or {}).get(dev)
                with torch.cuda.stream(stream) if stream is not None \
                        else contextlib.nullcontext():
                    if graphs is None:
                        results[rank] = fn(rank)
                    else:
                        comm = self.comm(rank)
                        if first[dev] == rank:
                            graph, pool = graphs[dev]
                            graph.capture_begin(
                                pool=pool, capture_error_mode="thread_local")
                            opened = graph
                        comm._gather(None)      # every capture is open
                        results[rank] = fn(rank)
                        comm._gather(None)      # every slab has issued
                        if opened is not None:
                            opened, graph = None, opened
                            graph.capture_end()
            except BaseException as exc:   # noqa: BLE001 -- re-raised below
                errors[rank] = exc
                self._barrier.abort()
            finally:
                if opened is not None:
                    with contextlib.suppress(Exception):
                        opened.capture_end()
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

    def faults(self):
        """Each card's count of flag waits that timed out (0-d int64
        device tensors; none without cross-card channels)."""
        if self.channels is None or not self.channels.cuda:
            return []
        return [log[0] for log in self.channels.fault.values()]

    def fault_report(self):
        """The flags whose waits timed out, named: "ready" / "free", the
        channel (sender, receiver) and the buffer set, by card (host
        reads: for an error message)."""
        names = {}
        for kind, flags in (("ready", self.channels.ready),
                            ("free", self.channels.free)):
            for (s, d), f in flags.items():
                for which in (0, 1):
                    names[f[which].data_ptr()] = f"{kind} {s}->{d} set {which}"
        out = {}
        for card, log in self.channels.fault.items():
            n, *addrs = log.tolist()
            if n:
                out[f"cuda:{card}"] = (n, [names.get(a, hex(a))
                                          for a in addrs[:min(n, len(addrs))]])
        return out


class SlabComm:
    """Slab ``rank``'s view of its group: the collectives, called by
    every slab of the group in the same order."""

    def __init__(self, group, rank):
        self.group = group
        self.rank = rank
        self.size = group.size
        self.device = group.devices[rank]

    def _gather(self, value):
        """Every slab's ``value`` by reference, in rank order: the
        mailbox and the barrier."""
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

    def _exchange(self, payloads):
        """One collective: ``payloads`` {destination rank: value} (any
        object; tensors in dicts, lists and tuples) -> {source rank: the
        value it sent here}.  Within a group by reference; to a slab of
        another group the tensors are sent before the barrier and
        received (copies on this slab's device) after it."""
        g = self.group
        post = {dst: value if g.same_group(self.rank, dst)
                else _Sent(g.channels, self.rank, dst, value)
                for dst, value in payloads.items()}
        boxes = self._gather(post)
        got = {}
        for src, box in enumerate(boxes):
            if self.rank in box:
                value = box[self.rank]
                got[src] = (value.receive() if isinstance(value, _Sent)
                            else value)
        return got

    def all_gather(self, value):
        """Every slab's ``value`` (any object), in rank order; its
        tensors on this slab's device."""
        got = self._exchange({q: value for q in range(self.size)})
        return [got[q] for q in range(self.size)]

    def shift_both(self, to_right, to_left):
        """The two ring shifts of ppermute in one collective, i -> i + 1
        and i + 1 -> i (mod size): (the left slab's ``to_right``, the
        right slab's ``to_left``), lists of tensors on this slab's
        device."""
        left, right = (self.rank - 1) % self.size, (self.rank + 1) % self.size
        payloads = {}
        payloads.setdefault(right, {})["from_left"] = list(to_right)
        payloads.setdefault(left, {})["from_right"] = list(to_left)
        got = self._exchange(payloads)
        return list(got[left]["from_left"]), list(got[right]["from_right"])

    def psum(self, value):
        """The sum over slabs, added in rank order: a tensor (on this
        slab's device), a number, or a dict / list of them."""
        return _sum_in_order(self.all_gather(value))


def _sum_in_order(vals):
    first = vals[0]
    if isinstance(first, dict):
        return {k: _sum_in_order([v[k] for v in vals]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_sum_in_order([v[i] for v in vals])
                           for i in range(len(first)))
    return sum(vals[1:], first)


def _leaves(value):
    if isinstance(value, dict):
        return [x for v in value.values() for x in _leaves(v)]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _leaves(v)]
    return [value]


def _rebuild(value, leaves):
    if isinstance(value, dict):
        return {k: _rebuild(v, leaves) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)([_rebuild(v, leaves) for v in value])
    return next(leaves)


class _Sent:
    """A value on its way to a slab of another group: its tensors
    already written into the channel's receive buffers."""

    def __init__(self, channels, src, dst, value):
        self.channels, self.src, self.dst = channels, src, dst
        self.value = value
        leaves = _leaves(value)
        self.at = [i for i, x in enumerate(leaves) if torch.is_tensor(x)]
        self.which, self.buffers = channels.send(
            src, dst, [leaves[i] for i in self.at])

    def receive(self):
        leaves = _leaves(self.value)
        for i, t in zip(self.at, self.channels.receive(
                self.src, self.dst, self.which, self.buffers)):
            leaves[i] = t
        return _rebuild(self.value, iter(leaves))


class _Channels:
    """The receive buffers (and on the cards the flags) of every pair
    of slabs in different groups, channel (sender, receiver).

    A buffer lives on the receiver's device, one per (channel, set,
    tensor index, shape, dtype), made at its first use, which must come
    outside a CUDA graph's capture (the warm-up run before it), on a
    stream of its own (``alloc_stream``).  On the
    cards each set of a channel has a ``ready`` flag on the receiver's
    card (starts at 0), a ``free`` flag on the sender's (starts at 1)
    and the sender's copy's block count, and each card has a fault log
    (the flag waits that timed out);
    peer access between every two cards is enabled here, before any
    capture (a host operation), and a pair of cards without it
    raises."""

    def __init__(self, devices, group_of):
        types = {d.type for d in devices}
        if len(types) > 1:
            raise ValueError(f"the slabs of one run lie on the CPU and on "
                             f"cards ({[str(d) for d in devices]}): put "
                             f"them all on one kind of device")
        self.devices = devices
        self.cuda = types == {"cuda"}
        self.pairs = [(s, d) for s in range(len(devices))
                      for d in range(len(devices))
                      if group_of[s] != group_of[d]]
        self.buffers = {}
        self.sent = dict.fromkeys(self.pairs, 0)
        if not self.cuda:
            return
        cards = sorted({d.index for d in devices})
        for a in cards:
            for b in cards:
                if a != b:
                    peer.enable_access(a, b)
        self.ready = {(s, d): torch.zeros(2, dtype=torch.int32,
                                          device=devices[d])
                      for s, d in self.pairs}
        self.free = {(s, d): torch.ones(2, dtype=torch.int32,
                                        device=devices[s])
                      for s, d in self.pairs}
        self.arrived = {(s, d): torch.zeros(2, dtype=torch.int32,
                                            device=devices[s])
                        for s, d in self.pairs}
        self.fault = {c: peer.fault_log(torch.device("cuda", c))
                      for c in cards}
        #: the stream the receive buffers are allocated on: one that runs
        #: nothing, so a buffer never reuses a block that work still
        #: queued on the receiver's stream may touch (the sender's card
        #: writes it, outside that stream's order)
        streams = {c: torch.cuda.Stream(device=torch.device("cuda", c))
                   for c in cards}
        self.alloc_stream = [streams[d.index] for d in devices]
        for c in cards:
            torch.cuda.synchronize(c)

    def reset(self):
        """A new run of the slab threads: the sets count from 0."""
        self.sent = dict.fromkeys(self.pairs, 0)

    def _buffer(self, s, d, which, i, t):
        key = (s, d, which, i, tuple(t.shape), t.dtype)
        buf = self.buffers.get(key)
        if buf is None:
            if t.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"slab {s} sends slab {d} a {tuple(t.shape)} "
                    f"{t.dtype} tensor for which no receive buffer was "
                    f"made before the capture (its warm-up did not send "
                    f"it)")
            with (torch.cuda.stream(self.alloc_stream[d]) if t.is_cuda
                  else contextlib.nullcontext()):
                buf = self.buffers[key] = torch.empty(
                    t.shape, dtype=t.dtype, device=self.devices[d])
        return buf

    def send(self, s, d, tensors):
        """Slab s's ``tensors`` into the receive buffers of channel
        (s, d), on slab s's current stream; returns (the set used, the
        buffers)."""
        which = self.sent[(s, d)] % 2
        self.sent[(s, d)] += 1
        parts = [t.contiguous() for t in tensors]
        bufs = [self._buffer(s, d, which, i, t) for i, t in enumerate(parts)]
        if not self.cuda:
            for b, t in zip(bufs, parts):
                b.copy_(t)
            return which, bufs
        if parts:
            peer.take_flag(self.free[(s, d)][which],
                           self.fault[self.devices[s].index])
            peer.copy_parts(bufs, parts, flag=self.ready[(s, d)][which],
                            arrived=self.arrived[(s, d)][which])
        return which, bufs

    def receive(self, s, d, which, bufs):
        """Copies of channel (s, d)'s buffers of set ``which`` on slab
        d's device, made on its current stream once the sender's copy is
        in."""
        if not self.cuda:
            return [b.clone() for b in bufs]
        if not bufs:
            return []
        peer.take_flag(self.ready[(s, d)][which],
                       self.fault[self.devices[d].index])
        out = [torch.empty_like(b) for b in bufs]
        peer.copy_parts(out, bufs)
        peer.give_flag(self.free[(s, d)][which])
        return out
