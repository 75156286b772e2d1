"""The non-resident paths in float32: the port against fbpic_tpu in
float32 (a subprocess with x64 off), on the configuration of
tests/test_torch_f32_parity.py (tests/test_golden_wake.py's: open z,
moving window, continuous injection, a0 = 1 laser), 40 steps, the port
fed fbpic_tpu's injection angles.

- fresh_sort: the plasma species gets a capacity above Nz * sort_K, so
  it is not resident: every step sorts it afresh at its mid positions
  and deposits J and the per-particle d(rho) through K1's plain version
  (sort_at_start=False), rho_next = rho_prev + d(rho).
- empty_beside_resident: the resident plasma plus an empty species
  (add_new_species without n): the empty species takes the scatter
  deposits and the float32 d(rho) fallback (its charge before and after
  the second half push), summed with the resident species' fused d(rho).

Gates of tests/test_torch_f32_parity.py: the on-axis Ez and the mode-0
and mode-1 Er at r = 5 dr within 1.5e-2 of their scale, the on-axis rho
within 3e-2 (float32 sums in another order move a 100-step wake by
about 1e-3).  40 steps, not that test's 100, keep the file inside its
time budget (measured over 100 steps: 1.3e-4 at most).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 40
GATES = {"Ez_axis": 1.5e-2, "Er0_r5": 1.5e-2, "Er1_r5": 1.5e-2,
         "rho_axis": 3e-2}
NZ, NR, NM = 400, 24, 2
ZMAX, ZMIN, RMAX = 30.e-6, -10.e-6, 20.e-6
SIM_KW = dict(zmin=ZMIN, n_order=32,
              boundaries={"z": "open", "r": "reflective"}, random_seed=0,
              verbose_level=0)
PLASMA = dict(n=4.e24, p_zmin=24.e-6, p_zmax=500.e-6, p_rmin=0.,
              p_rmax=14.e-6, p_nz=1, p_nr=1, p_nt=4)
LASER_KW = dict(a0=1.0, waist=8.e-6, tau=10.e-15, z0=20.e-6)
# a ring larger than the resident layout of the automatic sort_K (183296)
FRESH_CAPACITY = 200_000

SETUP = r'''
def build(Simulation, add_laser_pulse, GaussianLaser, case, **dev):
    from %(constants)s import c, e, m_e
    sim = Simulation(%(grid)s, (%(zmax)r - %(zmin)r) / %(nz)r / c,
                     **dict(%(kw)r, **dev))
    if case == "fresh_sort":
        sim.add_new_species(q=-e, m=m_e, capacity=%(cap)d, **%(plasma)r)
        sc = sim.species_configs[0]
        assert sc.sort_K > 0 and not sc.resident
    else:
        sim.add_new_species(q=-e, m=m_e, **%(plasma)r)
        sim.add_new_species(q=-e, m=m_e)
        assert sim.species_configs[0].resident
        assert not sim.species_configs[1].resident
    add_laser_pulse(sim, GaussianLaser(**%(laser)r))
    sim.set_moving_window(v=c)
    return sim
'''

JAX_SCRIPT = r'''
import sys
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from fbpic_tpu import Simulation
from fbpic_tpu.lpa_utils.laser import add_laser_pulse, GaussianLaser
%(setup)s
sim = build(Simulation, add_laser_pulse, GaussianLaser, sys.argv[2])
sim.step(%(n)d, show_progress=False)
Ez = sim.get_interp_field("Ez", 0).real
Er0 = sim.get_interp_field("Er", 0).real
Er1 = np.abs(sim.get_interp_field("Er", 1))
rho = sim.get_interp_field("rho", 0).real
np.savez(sys.argv[1], Ez_axis=Ez[:, 0], Er0_r5=Er0[:, 5], Er1_r5=Er1[:, 5],
         rho_axis=rho[:, 0], zmin=float(sim.zmin), seed=int(sim.state.seed),
         sort_K=sim.species_configs[0].sort_K,
         sort_overflow=int(sim.state.sort_overflow),
         ring_overwrite=int(sim.state.ring_overwrite))
'''


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _setup(package):
    grid = ", ".join(repr(v) for v in (NZ, ZMAX, NR, RMAX, NM))
    return SETUP % dict(constants=f"{package}.constants", grid=grid,
                        zmax=ZMAX, zmin=ZMIN, nz=NZ, kw=SIM_KW,
                        cap=FRESH_CAPACITY, plasma=PLASMA, laser=LASER_KW)


@pytest.mark.parametrize("case", ["fresh_sort", "empty_beside_resident"])
def test_f32_ring_paths_match_jax_f32(tmp_path, case):
    from test_torch_step import jax_column_angles
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    script = tmp_path / "jax_f32.py"
    script.write_text(JAX_SCRIPT % dict(repo=REPO, setup=_setup("fbpic_tpu"),
                                        n=N_STEPS))
    out = tmp_path / "jax_f32.npz"
    env = dict(os.environ)
    for var in ("JAX_ENABLE_X64", "JAX_PLATFORMS", "XLA_FLAGS",
                "JAX_PLATFORM_NAME"):
        env.pop(var, None)
    env["JAX_PLATFORMS"] = "cpu"
    # fbpic_tpu runs in the background while the port runs here
    proc = subprocess.Popen([sys.executable, str(script), str(out), case],
                            env=env)
    try:
        scope = {}
        exec(_setup("fbpic_tpu_torch"), scope)
        sim = scope["build"](Simulation, add_laser_pulse, GaussianLaser,
                             case, device="cpu", dtype=torch.float32)
        sim.column_angles = jax_column_angles(sim.device_seed,
                                              torch.float32)
        sim.step(N_STEPS)
        assert sim.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
        port = dict(
            Ez_axis=sim.get_interp_field("Ez", 0).real[:, 0],
            Er0_r5=sim.get_interp_field("Er", 0).real[:, 5],
            Er1_r5=np.abs(sim.get_interp_field("Er", 1))[:, 5],
            rho_axis=sim.get_interp_field("rho", 0).real[:, 0])
        assert proc.wait(timeout=900) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    ref = np.load(out)
    assert int(ref["seed"]) == sim.device_seed
    assert int(ref["sort_K"]) == sim.species_configs[0].sort_K
    assert int(ref["sort_overflow"]) == int(ref["ring_overwrite"]) == 0
    assert float(ref["zmin"]) == sim.zmin
    for name, gate in GATES.items():
        g = ref[name]
        assert np.isfinite(port[name]).all(), name
        err = np.abs(port[name] - g).max() / np.abs(g).max()
        print(f"float32 {case} port vs fbpic_tpu, {name}: {err:.2e}")
        assert err < gate, (name, err)
