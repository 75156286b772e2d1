"""The cross-card exchange of the slabs (parallel/group.py) on the CPU.

Slabs on different cards exchange through receive buffers on the
receiving slab's device (on the cards: peer copies ordered by flags in
device memory, csrc/peer.cu; on the CPU: a plain copy into the buffer
and out of it).  Here each CPU slab is put in a group of its own, as if
every slab had a card, so the whole run goes through that path:

- ``card_groups`` on mixed device lists; a run with slabs on the CPU
  and on cards refused;
- 300 rounds of psum, the ring shifts and all_gather between 8 slabs of
  one group each, with the interpreter switching threads every
  microsecond: every value right (a receive buffer overwritten before a
  slow slab copied it out would break them);
- the smoke-size multichip LWFA of tests/test_torch_parallel_graph.py
  (float32, open z, moving window, exchange steps at 0 and 6) on 4
  slabs through the chunk runner: bit for bit against the same slabs
  sharing one group (the mailbox, tensors by reference) -- every tensor
  of every slab, the host values, the generators, the live counts;
- the float64 LWFA of tests/test_torch_parallel_run.py on 4 slabs of
  one group each against fbpic_tpu's 4-device CPU mesh at that file's
  tolerances (the fields within 1e-8 of their scale, every slab's live
  slots exactly, positions and momenta within 1e-8 of their vector's
  scale).
"""
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the slabs are the parallelism."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def own_groups(monkeypatch):
    """Every slab in a group of its own (as if each had a card)."""
    from fbpic_tpu_torch.parallel import group
    monkeypatch.setattr(group, "card_groups",
                        lambda devices: [[r] for r in range(len(devices))])


def test_card_groups_on_mixed_device_lists():
    from fbpic_tpu_torch.parallel import SlabGroup, card_groups
    assert card_groups(["cpu"] * 3) == [[0, 1, 2]]
    assert card_groups(["cuda:0"] * 2 + ["cuda:1"] * 2) == [[0, 1], [2, 3]]
    assert card_groups(["cuda:1", "cuda:0", "cuda:1", "cuda:2"]) == \
        [[0, 2], [1], [3]]
    assert card_groups([torch.device("cuda", 0), "cuda:0", "cpu"]) == \
        [[0, 1], [2]]
    with pytest.raises(ValueError, match="on the CPU and on cards"):
        SlabGroup(["cpu", "cuda:0"])


def test_receive_buffers_under_thread_switching(own_groups):
    from fbpic_tpu_torch.parallel import SlabGroup
    n, rounds = 8, 300
    group = SlabGroup(["cpu"] * n, timeout=120.0)
    assert len(group.groups) == n and group.channels is not None

    def slab(rank):
        comm = group.comm(rank)
        for k in range(rounds):
            total = comm.psum(torch.tensor(float(rank + k)))
            assert float(total) == n * (n - 1) / 2 + n * k
            left, right = comm.shift_both(
                [torch.tensor(rank * 1000 + k), torch.full((3,), k)],
                [torch.tensor(rank * 1000 + k)])
            assert int(left[0]) == ((rank - 1) % n) * 1000 + k
            assert left[1].tolist() == [k] * 3
            assert int(right[0]) == ((rank + 1) % n) * 1000 + k
            got = comm.all_gather({"k": k, "t": torch.tensor([rank, k])})
            assert [g["k"] for g in got] == [k] * n
            assert [g["t"].tolist() for g in got] == \
                [[q, k] for q in range(n)]
        return rank

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        assert group.run(slab) == list(range(n))
    finally:
        sys.setswitchinterval(old)
    assert time.perf_counter() - t0 < 60.0
    # two sets of buffers a channel: the ring shifts' neighbours and the
    # all-to-all of psum and all_gather
    assert {key[2] for key in group.channels.buffers} == {0, 1}


def test_receive_buffers_match_the_mailbox_bit_for_bit(monkeypatch):
    from test_torch_parallel_graph import assert_equal_runs, lwfa
    from fbpic_tpu_torch.parallel import distribute_simulation, group
    n_steps, runs = 8, []
    for own in (True, False):
        if own:
            monkeypatch.setattr(
                group, "card_groups",
                lambda devices: [[r] for r in range(len(devices))])
        else:
            monkeypatch.undo()
        run = distribute_simulation(lwfa(), devices=["cpu"] * 4)
        assert (run.group.channels is not None) == own
        assert run.graph_blockers == ([], [])
        run.step(n_steps)
        runs.append(run)
    cards, mailbox = runs
    assert cards.group.channels.buffers
    assert float(cards.states[0].zmin) > float(cards.sim.state.zmin)
    assert max(cards.live_counts[0]) > 0
    assert_equal_runs(cards, mailbox)
    assert cards.overflow_totals == mailbox.overflow_totals == {
        "migration_overflow": 0, "sort_overflow": 0, "ring_overwrite": 0}


def test_receive_buffers_match_fbpic_tpu_mesh(own_groups):
    from test_torch_parallel_run import N_DEV, NM, lwfa
    from test_torch_step import jax_column_angles
    from fbpic_tpu.parallel.api import distribute_simulation as j_dist
    from fbpic_tpu_torch.parallel import distribute_simulation
    n_steps = 10
    s0 = lwfa("fbpic_tpu")
    angles = jax_column_angles(int(s0.state.seed), torch.float64)
    r0 = j_dist(s0, n_devices=N_DEV)
    r0.step(n_steps)
    sim = lwfa("fbpic_tpu_torch")
    sim.column_angles = angles
    run = distribute_simulation(sim, devices=["cpu"] * N_DEV)
    assert len(run.group.groups) == N_DEV
    run.step(n_steps)
    for name in ("Er", "Et", "Ez", "Br", "Bt", "Bz", "rho"):
        scale = np.abs(r0.get_interp_field(name, 0)).max()
        assert scale > 0, name
        for m in range(NM):
            ref = r0.get_interp_field(name, m)
            got = run.get_interp_field("rho_prev" if name == "rho"
                                       else name, m)
            assert np.abs(got - ref).max() <= 1e-8 * scale, (name, m)
    sp0 = r0.state.species[0]
    blocks = {n: np.asarray(getattr(sp0, n)).reshape(N_DEV, -1)
              for n in ("x", "y", "z", "ux", "uy", "uz", "w")}
    scales = {v: max(np.abs(blocks[n]).max() for n in names)
              for v, names in (("pos", "xyz"), ("mom", ("ux", "uy", "uz")))}
    for i, st in enumerate(run.states):
        sp = st.species[0]
        np.testing.assert_array_equal(sp.w.numpy(), blocks["w"][i])
        live = blocks["w"][i] != 0
        for n in ("x", "y", "z", "ux", "uy", "uz") if live.any() else ():
            scale = scales["pos" if n in "xyz" else "mom"]
            diff = getattr(sp, n).numpy()[live] - blocks[n][i][live]
            assert np.abs(diff).max() <= 1e-8 * scale, (i, n)
    assert run.states[0].iteration == int(r0.state.iteration) == n_steps
    assert float(run.states[0].zmin) == float(r0.state.zmin)


class _FakeGraph:
    """Records the capture calls a card's graph gets, and from which
    thread."""

    def __init__(self, log):
        self.log = log

    def capture_begin(self, pool=None, capture_error_mode="global"):
        import threading
        self.log.append(("begin", threading.current_thread().name,
                         pool, capture_error_mode))

    def capture_end(self):
        import threading
        self.log.append(("end", threading.current_thread().name))


@pytest.mark.parametrize("fails", [False, True])
def test_capture_opened_before_any_slab_issues(fails):
    """``SlabGroup.run(fn, graphs=...)``: the card's first slab begins
    the capture (thread-local mode, the card's pool) before any slab
    issues, and ends it from the same thread once every slab has issued;
    a slab that raises still leaves the capture ended, and the run
    raises its exception."""
    from fbpic_tpu_torch.parallel import SlabGroup
    log = []
    group = SlabGroup(["cpu"] * 3, timeout=30.0)

    def fn(rank):
        log.append(("issue", rank))
        if fails and rank == 2:
            raise RuntimeError("slab 2 failed")
        group.comm(rank).psum(rank)
        return rank

    graphs = {torch.device("cpu"): (_FakeGraph(log), "pool")}
    if fails:
        with pytest.raises(RuntimeError, match="slab 2 failed"):
            group.run(fn, graphs=graphs)
    else:
        assert group.run(fn, graphs=graphs) == [0, 1, 2]
    assert log[0] == ("begin", "slab-0", "pool", "thread_local")
    # (a slab released from the barrier that slab 2 then aborts may
    # leave before it issues)
    issued = sorted(e[1] for e in log if e[0] == "issue")
    assert issued == [0, 1, 2] or (fails and 2 in issued)
    assert log[-1] == ("end", "slab-0")
    assert [e[0] for e in log].count("end") == 1
