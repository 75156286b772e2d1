"""The port in float32 against fbpic_tpu in float32, on a short LWFA run.

The configuration of tests/test_golden_wake.py (open z, moving window,
continuous injection, a0 = 1 laser) runs 100 steps in both packages:
fbpic_tpu in a subprocess with x64 off (its float32 production path:
resident layout, per-particle d(rho) for the current correction), the
port on the CPU with its plain kernel versions (the same path, d(rho)
through K1's plain version) and fbpic_tpu's injection angles.  The
on-axis Ez, Er (modes 0 and 1) and rho profiles must agree within the
100-step float32 gates of tests/test_golden_wake.py:156-157 (1.5e-2 of
the field scale, 3e-2 for rho): float32 sums in another order move a
100-step wake by about 1e-3.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 100
GATES = {"Ez_axis": 1.5e-2, "Er0_r5": 1.5e-2, "Er1_r5": 1.5e-2,
         "rho_axis": 3e-2}

NZ, NR, NM = 400, 24, 2
ZMAX, ZMIN, RMAX = 30.e-6, -10.e-6, 20.e-6
SIM_KW = dict(p_zmin=24.e-6, p_zmax=500.e-6, p_rmin=0., p_rmax=14.e-6,
              p_nz=1, p_nr=1, p_nt=4, n_e=4.e24, zmin=ZMIN, n_order=32,
              boundaries={"z": "open", "r": "reflective"}, random_seed=0,
              verbose_level=0)
LASER_KW = dict(a0=1.0, waist=8.e-6, tau=10.e-15, z0=20.e-6)

JAX_SCRIPT = r'''
import sys
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from fbpic_tpu import Simulation
from fbpic_tpu.constants import c
from fbpic_tpu.lpa_utils.laser import add_laser_pulse, GaussianLaser
sim = Simulation(%(grid)s, (%(zmax)r - %(zmin)r) / %(nz)r / c, **%(kw)r)
add_laser_pulse(sim, GaussianLaser(**%(laser)r))
sim.set_moving_window(v=c)
assert sim.species_configs[0].resident
sim.step(%(n)d, show_progress=False)
Ez = sim.get_interp_field("Ez", 0).real
Er0 = sim.get_interp_field("Er", 0).real
Er1 = np.abs(sim.get_interp_field("Er", 1))
rho = sim.get_interp_field("rho", 0).real
np.savez(sys.argv[1], Ez_axis=Ez[:, 0], Er0_r5=Er0[:, 5], Er1_r5=Er1[:, 5],
         rho_axis=rho[:, 0], zmin=float(sim.zmin), seed=int(sim.state.seed))
'''


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _capture(sim):
    Ez = sim.get_interp_field("Ez", 0).real
    Er0 = sim.get_interp_field("Er", 0).real
    Er1 = np.abs(sim.get_interp_field("Er", 1))
    rho = sim.get_interp_field("rho", 0).real
    return dict(Ez_axis=Ez[:, 0], Er0_r5=Er0[:, 5], Er1_r5=Er1[:, 5],
                rho_axis=rho[:, 0])


def test_f32_port_matches_jax_f32(tmp_path):
    from test_torch_step import jax_column_angles
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser

    script = tmp_path / "jax_f32.py"
    grid = ", ".join(repr(v) for v in (NZ, ZMAX, NR, RMAX, NM))
    script.write_text(JAX_SCRIPT % dict(
        repo=REPO, grid=grid, zmax=ZMAX, zmin=ZMIN, nz=NZ, kw=SIM_KW,
        laser=LASER_KW, n=N_STEPS))
    out = tmp_path / "jax_f32.npz"
    env = dict(os.environ)
    for var in ("JAX_ENABLE_X64", "JAX_PLATFORMS", "XLA_FLAGS",
                "JAX_PLATFORM_NAME"):
        env.pop(var, None)
    env["JAX_PLATFORMS"] = "cpu"
    # fbpic_tpu runs in the background while the port runs here
    proc = subprocess.Popen([sys.executable, str(script), str(out)],
                            env=env)
    try:
        sim = Simulation(NZ, ZMAX, NR, RMAX, NM, (ZMAX - ZMIN) / NZ / c,
                         device="cpu", dtype=torch.float32, **SIM_KW)
        assert sim.species_configs[0].resident
        sim.column_angles = jax_column_angles(sim.device_seed,
                                              torch.float32)
        add_laser_pulse(sim, GaussianLaser(**LASER_KW))
        sim.set_moving_window(v=c)
        sim.step(N_STEPS)
        port = _capture(sim)
        assert proc.wait(timeout=900) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    ref = np.load(out)
    assert int(ref["seed"]) == sim.device_seed
    assert float(ref["zmin"]) == sim.zmin
    for name, gate in GATES.items():
        g = ref[name]
        assert np.isfinite(port[name]).all(), name
        err = np.abs(port[name] - g).max() / np.abs(g).max()
        print(f"float32 port vs fbpic_tpu, {name}: {err:.2e}")
        assert err < gate, (name, err)
