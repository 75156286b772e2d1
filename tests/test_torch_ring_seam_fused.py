"""The sorted non-resident path on the configuration of
tests/test_continuous_injection_seam.py (fused=True: sort_K = 768 set
after the species, so the species stays a ring whose capacity is not
Nz * sort_K, and the fused deposit on), float64, in both packages.

Every step sorts the species afresh at its mid positions and deposits J
and rho through deposit_rho_J_sorted: K3's plain version twice a step in
the port, fbpic_tpu's dense contraction.  On the CPU that step costs
~0.7 s in fbpic_tpu and ~0.9 s in the port, so the test's 400 steps are
not run here: fbpic_tpu's scatter path (equal in exact arithmetic, held
against the port in tests/test_torch_ring_seam.py) brings the run to
step 220, where the ring is about to wrap and the box holds injected
plasma; from that state, carried into the port by
``utils.carry.state_from_numpy``, both packages take 24 sorted steps
(three exchanges; the cursor wraps near step 234).  Gates as in
tests/test_torch_ring_seam.py.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

N_SORTED = 24


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_seam_sorted_path_like_fbpic_tpu():
    from test_torch_ring import compare_states, noise_scales
    from test_torch_ring_seam import N_E, seam_sims
    from test_torch_step import jax_state_to_numpy
    from fbpic_tpu_torch.utils.carry import state_from_numpy
    s0, s1 = seam_sims(fused=False)
    s0.step(220, show_progress=False)
    at220 = jax_state_to_numpy(s0.state)
    for s in (s0, s1):
        s.species_configs[0] = dataclasses.replace(s.species_configs[0],
                                                   sort_K=768)
        s.use_fused_deposit = True
        sc = s.species_configs[0]
        assert sc.sort_K == 768 and not sc.resident
    cap = s1.state.species[0].capacity
    assert cap != s1.config.Nz * 768
    s1.state = state_from_numpy(**at220, device="cpu")
    s0.step(N_SORTED, show_progress=False)
    s1.step(N_SORTED)
    ref = jax_state_to_numpy(s0.state)
    assert ref["species"][0]["next_free"] < at220["species"][0]["next_free"]
    compare_states(ref, s1.state, scales=noise_scales(s1, ref, N_SORTED, N_E))
    assert s1.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}
