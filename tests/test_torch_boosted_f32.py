"""The boosted-frame Galilean slice in float32: the port against fbpic_tpu
in float32.

The smoke-size boosted-frame LWFA of examples/boosted_frame_script.py
(:17-58 at the size of :34-35: gamma_boost = 10, a0 = 2 laser given in
the lab frame, Galilean v_comoving = -c beta_boost, open z, moving
window, continuous injection), with the plasma loaded from the box's
left edge (-40 um lab) so that the automatic rule picks the resident
layout in both packages.  fbpic_tpu runs in a subprocess with x64 off
(its float32 production path), the port on the CPU with its plain kernel
versions (the J and rho deposits through K3's plain version) and
fbpic_tpu's injection angles, 40 steps each, for the Galilean and the
comoving scheme.

Gates: the on-axis Ez and the mode-0 and mode-1 Er at r = 5 dr within
2e-4 of the electric field's scale (the largest of the three profiles),
the on-axis rho within 2e-4 of its scale; zmin and the resident sort_K
exactly.  Measured on the CPU (Galilean): at most 3e-6 of scale, from
float32 sums in another order.  The mode-0 Er is ~1e-4 of the field and
is float32 noise at its own scale: the float64 port differs from either
float32 run by 3-6e-2 of |Er0|, i.e. ~5e-6 of the field.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 40
GATE = 2e-4
# The quantity whose scale each profile's gate is relative to
SCALE_OF = {"Ez_axis": "E", "Er0_r5": "E", "Er1_r5": "E", "rho_axis": "rho"}
GAMMA = 10.

JAX_SCRIPT = r'''
import sys
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from fbpic_tpu import Simulation
from fbpic_tpu.lpa_utils.laser import add_laser_pulse, GaussianLaser
sim = Simulation(*%(grid)r, **%(kw)r)
sim.add_new_species(**%(species)r)
add_laser_pulse(sim, GaussianLaser(**%(laser)r), gamma_boost=%(gamma)r)
sim.set_moving_window(v=%(v_window)r)
assert sim.species_configs[0].resident
sim.step(%(n)d, show_progress=False)
Ez = sim.get_interp_field("Ez", 0).real
Er0 = sim.get_interp_field("Er", 0).real
Er1 = np.abs(sim.get_interp_field("Er", 1))
rho = sim.get_interp_field("rho", 0).real
np.savez(sys.argv[1], Ez_axis=Ez[:, 0], Er0_r5=Er0[:, 5], Er1_r5=Er1[:, 5],
         rho_axis=rho[:, 0], zmin=float(sim.zmin), seed=int(sim.state.seed),
         sort_K=sim.species_configs[0].sort_K)
'''


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _setup(scheme="galilean"):
    """Grid, Simulation keywords, species and laser of the smoke case
    (plain Python values, so both packages take the same ones)."""
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.boosted_frame import BoostConverter
    boost = BoostConverter(GAMMA)
    Nz, Nr, Nm, rmax = 256, 12, 2, 40.e-6
    zmin, zmax = boost.static_length([-40.e-6, 0.e-6])
    n_e, = boost.static_density([1.e24])
    v_window, = boost.velocity([c])
    grid = (Nz, float(zmax), Nr, rmax, Nm, float((zmax - zmin) / Nz / c))
    kw = dict(zmin=float(zmin), n_order=16, gamma_boost=GAMMA,
              v_comoving=float(-c * np.sqrt(1. - 1. / GAMMA**2)),
              use_galilean=(scheme == "galilean"),
              boundaries={"z": "open", "r": "reflective"},
              random_seed=0, verbose_level=0)
    species = dict(q=-e, m=m_e, n=float(n_e), p_zmin=-40.e-6,
                   p_zmax=float(boost.static_length([2000.e-6])[0]),
                   p_rmax=35.e-6, p_nz=1, p_nr=1, p_nt=4,
                   continuous_injection=True,
                   boost_positions_in_dens_func=True)
    laser = dict(a0=2., waist=10.e-6, tau=30.e-15, z0=-15.e-6)
    return grid, kw, species, laser, float(v_window)


def _capture(sim):
    Ez = sim.get_interp_field("Ez", 0).real
    Er0 = sim.get_interp_field("Er", 0).real
    Er1 = np.abs(sim.get_interp_field("Er", 1))
    rho = sim.get_interp_field("rho", 0).real
    return dict(Ez_axis=Ez[:, 0], Er0_r5=Er0[:, 5], Er1_r5=Er1[:, 5],
                rho_axis=rho[:, 0])


@pytest.mark.parametrize("scheme", ["galilean", "comoving"])
def test_boosted_f32_port_matches_jax_f32(tmp_path, scheme):
    from test_torch_step import jax_column_angles
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    grid, kw, species, laser, v_window = _setup(scheme)
    script = tmp_path / "jax_boosted_f32.py"
    script.write_text(JAX_SCRIPT % dict(
        repo=REPO, grid=grid, kw=kw, species=species, laser=laser,
        gamma=GAMMA, v_window=v_window, n=N_STEPS))
    out = tmp_path / "jax_boosted_f32.npz"
    env = dict(os.environ)
    for var in ("JAX_ENABLE_X64", "JAX_PLATFORMS", "XLA_FLAGS",
                "JAX_PLATFORM_NAME"):
        env.pop(var, None)
    env["JAX_PLATFORMS"] = "cpu"
    # fbpic_tpu runs in the background while the port runs here
    proc = subprocess.Popen([sys.executable, str(script), str(out)],
                            env=env)
    try:
        sim = Simulation(*grid, device="cpu", dtype=torch.float32, **kw)
        sim.add_new_species(**species)
        assert sim.species_configs[0].resident
        assert sim.species_configs[0].resort == "banded"
        sim.column_angles = jax_column_angles(sim.device_seed,
                                              torch.float32)
        add_laser_pulse(sim, GaussianLaser(**laser), gamma_boost=GAMMA)
        sim.set_moving_window(v=v_window)
        sim.step(N_STEPS)
        port = _capture(sim)
        assert sim.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
        assert proc.wait(timeout=900) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    ref = np.load(out)
    assert int(ref["seed"]) == sim.device_seed
    assert int(ref["sort_K"]) == sim.species_configs[0].sort_K
    assert float(ref["zmin"]) == sim.zmin
    scale = {}
    for name, of in SCALE_OF.items():
        scale[of] = max(scale.get(of, 0.0), float(np.abs(ref[name]).max()))
    for name, of in SCALE_OF.items():
        assert np.isfinite(port[name]).all(), name
        err = np.abs(port[name] - ref[name]).max() / scale[of]
        print(f"float32 boosted port vs fbpic_tpu ({scheme}), {name}: "
              f"{err:.2e} of the {of} scale")
        assert err < GATE, (name, err)
