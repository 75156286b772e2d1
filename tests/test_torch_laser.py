"""Laser direct injection: fbpic_tpu_torch against fbpic_tpu (float64).

add_laser_pulse evaluates the profile on the grid and solves for the
self-consistent Ez and B on the host in numpy float64, then writes the
interpolation-grid fields.  Both packages run the same host code on the
same grid, so the interp E/B must agree to 1e-12 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

FIELDS = ("Er", "Et", "Ez", "Br", "Bt", "Bz")


@pytest.mark.parametrize("boundaries,laser", [
    ({"z": "open", "r": "reflective"},
     dict(a0=1.0, waist=8.e-6, tau=10.e-15, z0=20.e-6)),
    ({"z": "periodic", "r": "reflective"},
     dict(a0=4.0, waist=5.e-6, tau=16.7e-15, z0=5.e-6, theta_pol=0.4)),
])
def test_direct_injection_matches_jax(boundaries, laser):
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    from fbpic_tpu_torch.constants import c
    Nz, Nr, Nm = 120, 16, 2
    zmax, zmin, rmax = 30.e-6, -10.e-6, 20.e-6
    dt = (zmax - zmin) / Nz / c
    kw = dict(zmin=zmin, n_order=32, boundaries=boundaries, verbose_level=0)
    s0 = S0(Nz, zmax, Nr, rmax, Nm, dt, **kw)
    s1 = S1(Nz, zmax, Nr, rmax, Nm, dt, device="cpu", dtype=torch.float64,
            **kw)
    assert s0.config.Nz == s1.config.Nz
    a0(s0, L0(**laser))
    a1(s1, L1(**laser))
    for name in FIELDS:
        ref = s0.get_interp_field(name)
        out = s1.get_interp_field(name)
        scale = np.abs(ref).max()
        assert scale > 0
        assert np.abs(out - ref).max() <= 1e-12 * scale, name
