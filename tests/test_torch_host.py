"""fbpic_tpu_torch host-side modules against fbpic_tpu: bit-equal arrays.

The port copies the numpy/scipy host precompute (Hankel matrices, PSATD
coefficients, stencils, grid volumes and Ruyten rows, smoothing,
host transforms, laser profiles, particle loading) instead of importing
it, because importing fbpic_tpu's field package pulls in JAX.  Same code,
same inputs: every array must be identical, bit for bit.
"""
import subprocess
import sys
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("Nm,Nr", [(2, 24), (3, 17)])
def test_hankel_psatd_stencil_bit_equal(Nm, Nr):
    from fbpic_tpu.fields import hankel as h0, psatd_coefs as p0, \
        stencil as s0
    from fbpic_tpu_torch.fields import hankel as h1, psatd_coefs as p1, \
        stencil as s1
    from fbpic_tpu_torch.constants import c
    rmax, Nz, dz = 20e-6, 48, 0.1e-6
    m0, m1 = (h.build_mode_matrices(Nm, Nr, rmax) for h in (h0, h1))
    assert m0.keys() == m1.keys()
    for k in m0:
        _same(m0[k], m1[k])
    kz = 2 * np.pi * np.fft.fftfreq(Nz, dz)
    for order in (-1, 8, 32):
        _same(s0.get_modified_k(kz, order, dz),
              s1.get_modified_k(kz, order, dz))
        assert s0.get_stencil_reach(Nz, dz, c * dz / c, order, None, False) \
            == s1.get_stencil_reach(Nz, dz, c * dz / c, order, None, False)
    kzm = s0.get_modified_k(kz, 32, dz)[None, :, None]
    kr = m0["kr"][:, None, :]
    c0 = p0.PsatdCoeffs(kzm, kr, dz / c)
    c1 = p1.PsatdCoeffs(kzm, kr, dz / c)
    for name in ("C", "S_w", "j_coef", "rho_prev_coef", "rho_next_coef"):
        _same(getattr(c0, name), getattr(c1, name))


def test_grids_smoothing_host_transform_bit_equal():
    from fbpic_tpu.fields import grids as g0, smoothing as sm0, \
        host_transform as ht0
    from fbpic_tpu_torch.fields import grids as g1, smoothing as sm1, \
        host_transform as ht1
    Nz, Nr, Nm, rmax, dz = 40, 16, 2, 15e-6, 0.2e-6
    for mod in (True, False):
        v0 = g0.cell_volumes(dz, Nr, rmax, use_modified_volume=mod)
        v1 = g1.cell_volumes(dz, Nr, rmax, use_modified_volume=mod)
        for a, b in zip(v0, v1):
            _same(a, b)
        for ruy in (True, False):
            for a, b in zip(g0.ruyten_coefficients(v0[0], Nr, rmax / Nr, dz,
                                                   ruy),
                            g1.ruyten_coefficients(v1[0], Nr, rmax / Nr, dz,
                                                   ruy)):
                _same(a, b)
    kz = 2 * np.pi * np.fft.fftfreq(Nz, dz)
    kr = np.linspace(0, 3e6, Nr)
    for n_passes, comp in ((1, False), (2, True)):
        f0 = sm0.BinomialSmoother(n_passes, comp).get_filter_array(
            kz, kr, dz, rmax / Nr)
        f1 = sm1.BinomialSmoother(n_passes, comp).get_filter_array(
            kz, kr, dz, rmax / Nr)
        for a, b in zip(f0, f1):
            _same(a, b)
    rng = np.random.RandomState(5)
    F = rng.randn(Nm, Nz, Nr) + 1j * rng.randn(Nm, Nz, Nr)
    t0 = ht0.HostSpectralTransformer(Nz, Nr, Nm, rmax, dz, 16)
    t1 = ht1.HostSpectralTransformer(Nz, Nr, Nm, rmax, dz, 16)
    _same(t0.interp2spect_scal(F), t1.interp2spect_scal(F))
    for a, b in zip(t0.spect2interp_vect(F, 2 * F),
                    t1.spect2interp_vect(F, 2 * F)):
        _same(a, b)


def test_laser_profile_and_particle_loading_bit_equal():
    from fbpic_tpu.lpa_utils.laser import GaussianLaser as L0
    from fbpic_tpu_torch.lpa_utils.laser import GaussianLaser as L1
    from fbpic_tpu.particles import state as st0
    from fbpic_tpu_torch.particles import state as st1
    from fbpic_tpu.fields.solver import _damp_profile_z as d0
    from fbpic_tpu.fields.solver import GridConfig as G0
    from fbpic_tpu_torch.fields.solver import _damp_profile_z as d1
    from fbpic_tpu_torch.fields.solver import GridConfig as G1
    rng = np.random.RandomState(2)
    x, y, z = rng.randn(3, 50) * 1e-5
    for kw in (dict(a0=4.0, waist=5e-6, tau=16.7e-15, z0=-8e-6),
               dict(a0=1.0, waist=8e-6, tau=10e-15, z0=20e-6, zf=1e-6,
                    theta_pol=0.3, cep_phase=0.5, phi2_chirp=1e-29)):
        for a, b in zip(L0(**kw).E_field(x, y, z, 3e-14),
                        L1(**kw).E_field(x, y, z, 3e-14)):
            _same(a, b)
    args = (4, 0.0, 4e-6, 3, 0.0, 5e-6, 4, 1e24, None, 0., 0., 0.1,
            0.01, 0.02, 0.03)
    out0 = st0.generate_evenly_spaced(*args, rng=np.random.RandomState(0))
    out1 = st1.generate_evenly_spaced(*args, rng=np.random.RandomState(0))
    assert out0[0] == out1[0]
    for a, b in zip(out0[1:], out1[1:]):
        _same(a, b)
    kw = dict(Nz=300, Nr=10, Nm=2, dz=1e-7, dr=1e-6, rmax=1e-5, dt=1e-16,
              boundaries_z="open", n_guard=20, nz_damp=64, n_inject=10)
    _same(d0(G0(**kw)), d1(G1(**kw)))


def test_injector_template_bit_equal():
    from fbpic_tpu.particles import injection as i0
    from fbpic_tpu_torch.particles import injection as i1
    cfg0 = i0.InjectorConfig(dz_particles=5e-8, n=4e24)
    cfg1 = i1.InjectorConfig(dz_particles=5e-8, n=4e24)
    a0 = i0.build_injector_aux(7, 0.0, 14e-6, 4, cfg0,
                               rng=np.random.RandomState(3))
    a1 = i1.build_injector_aux(7, 0.0, 14e-6, 4, cfg1,
                               rng=np.random.RandomState(3),
                               device="cpu", dtype=torch.float64)
    for name in ("r", "cos_t", "sin_t", "w_base"):
        _same(np.asarray(getattr(a0, name)),
              getattr(a1, name).numpy())
    assert cfg0.v_end_plasma == cfg1.v_end_plasma


def test_import_leaves_jax_out():
    """fbpic_tpu_torch, its whole main path, PICMI, the fbpic.main alias
    and the utils import without JAX."""
    code = ("import sys; import fbpic_tpu_torch; "
            "import fbpic_tpu_torch.core.step, "
            "fbpic_tpu_torch.lpa_utils.laser, fbpic_tpu_torch.utils.carry, "
            "fbpic_tpu_torch.picmi, fbpic_tpu_torch.main, "
            "fbpic_tpu_torch.utils.random_seed, "
            "fbpic_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'fbpic_tpu.'))]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_cuda_simulation_never_falls_back_to_cpu():
    """Simulation(device='cuda') without a card is an error."""
    from fbpic_tpu_torch import Simulation
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(32, 10e-6, 8, 5e-6, 2, 1e-15)
