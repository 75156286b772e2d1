"""Particle tracking: fbpic_tpu_torch's ids against fbpic_tpu's (float64).

Both packages run tests/test_torch_ring.py's window configuration (open
z, moving window, continuous injection every 4 steps, a0 = 0.5 laser),
the port fed fbpic_tpu's injection angles, with ``track()`` on, for 12
steps (3 exchanges):

- resident (``sort_K = 256``, the fused deposit forced): the ids ride
  the full column sort on exchange steps and the banded re-sort on the
  others, and injection writes into dead slots;
- a ring (``sort_K = 0``): ring-cursor injection at ``next_free``;
- a ring grown by the auto-grow (a ring-overwrite count on a ring more
  than half full doubles its capacity; the new slots are dead, id 0)
  before it steps.

The live slots must be the same, and on them the port's int64 ids must
equal fbpic_tpu's two uint32 words joined (``hi << 32 | lo``) exactly;
``next_id`` too, which is 1 + the slots numbered by ``track()`` + one
per injected candidate particle.  Ids of live particles are unique.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

N_STEPS = 12


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_ids(sp):
    """fbpic_tpu's ids of species state ``sp`` as uint64."""
    from fbpic_tpu_torch.utils.carry import join_words
    return join_words(np.asarray(sp.ids), np.asarray(sp.ids_hi))


def _grow_both(s0, s1, fill=0.6):
    """Make the first ``fill`` of the ring's slots live and let the
    auto-grow double its capacity in both packages (as
    tests/test_torch_ring.py::test_ring_auto_grow_matches_fbpic_tpu)."""
    cap = s1.state.species[0].capacity
    live = (np.arange(cap) < int(fill * cap)) * 1.0
    s0.state = dataclasses.replace(s0.state, species=(dataclasses.replace(
        s0.state.species[0], w=jnp.asarray(live)),))
    s1.state.species[0] = s1.state.species[0].replace(
        w=torch.as_tensor(live))
    return cap


@pytest.mark.parametrize("layout", ["resident", "ring", "ring_grown"])
def test_ids_match_fbpic_tpu(layout):
    from test_torch_ring import window_sims, SPECIES_KW
    kw = dict(SPECIES_KW, sort_K=256) if layout == "resident" else SPECIES_KW
    s0, s1 = window_sims(species_kw=kw, fused=layout == "resident")
    assert s1.species_configs[0].resident == (layout == "resident")
    cap0 = None
    if layout == "ring_grown":
        cap0 = _grow_both(s0, s1)
    for s in (s0, s1):
        s.ptcl[0].track(s.comm)
    n_tracked = s1.state.species[0].next_id - 1
    assert int(s0.state.species[0].next_id) == n_tracked + 1
    if layout == "ring_grown":
        for s, ring in ((s0, jnp.asarray(7, jnp.int32)), (s1,
                                                        torch.tensor(7))):
            s.state = dataclasses.replace(s.state, ring_overwrite=ring)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                s._consume_overflow_counters()
        assert s1.state.species[0].capacity > cap0
        assert s0.state.species[0].capacity == s1.state.species[0].capacity
        assert int((s1.state.species[0].ids[cap0:] != 0).sum()) == 0
    inj = s1._injector_auxes[0].r.shape[0]
    n_written = 0
    for _ in range(N_STEPS):
        s0.step(1, show_progress=False)
        before = s1.state.species[0].next_id
        s1.step(1)
        n_written += s1.state.species[0].next_id - before
        sp0, sp1 = s0.state.species[0], s1.state.species[0]
        live = np.asarray(sp0.w) != 0
        np.testing.assert_array_equal(live, sp1.w.numpy() != 0)
        ids1 = sp1.ids.numpy()
        np.testing.assert_array_equal(jax_ids(sp0)[live],
                                      ids1[live].astype(np.uint64))
        assert (ids1[~live] == 0).all()
        assert len(np.unique(ids1[live])) == int(live.sum())
    next0 = int(jax_ids(dataclasses.replace(
        sp0, ids=sp0.next_id, ids_hi=sp0.next_id_hi)))
    assert sp1.next_id == next0
    # one id per injected candidate: whole columns of the template
    assert n_written > 0 and n_written % inj == 0
    assert sp1.next_id == 1 + n_tracked + n_written
