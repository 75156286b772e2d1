"""fbpic_tpu_torch spectral core against fbpic_tpu (float64).

Transforms (torch.fft + batched DHT matmuls vs fbpic_tpu's dense DFT
matmuls), the PSATD push, the curl-free correction, the source filters,
the moving-window shift and the skinny open-z damping, on the inputs of
tests/test_spectral_core.py.  Tolerance: 1e-12 relative to the largest
reference value (float64; the FFT and the dense DFT sum in another
order, ~1e-15 relative).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.utils.complex_arr import CArr  # noqa: E402
from fbpic_tpu.constants import c  # noqa: E402

TOL = 1e-12


def _np(a):
    """numpy complex array of a CArr or a torch tensor."""
    if isinstance(a, CArr):
        return a.to_numpy()
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _close(ref, out, tol=TOL):
    ref, out = _np(ref), _np(out)
    assert ref.shape == out.shape
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(ref - out).max() / scale
    assert err <= tol, err


def _both(rng, shape):
    a = rng.randn(*shape) + 1j * rng.randn(*shape)
    return CArr.from_numpy(a, jnp.float64), torch.as_tensor(a)


def test_transforms_match_jax():
    from fbpic_tpu.fields import transform as t0
    from fbpic_tpu_torch.fields import transform as t1
    Nm, Nz, Nr, rmax = 3, 32, 32, 20e-6
    m0 = t0.TransformMatrices.build(Nm, Nr, Nz, rmax)
    m1 = t1.TransformMatrices.build(Nm, Nr, rmax, "cpu", torch.float64)
    rng = np.random.RandomState(1)
    F = [_both(rng, (Nm, Nz, Nr)) for _ in range(6)]
    j, t = zip(*F)
    _close(t0.interp2spect_scal(m0, j[0]), t1.interp2spect_scal(m1, t[0]))
    _close(t0.spect2interp_scal(m0, j[0]), t1.spect2interp_scal(m1, t[0]))
    for a, b in zip(t0.interp2spect_vect(m0, j[0], j[1]),
                    t1.interp2spect_vect(m1, t[0], t[1])):
        _close(a, b)
    for a, b in zip(t0.spect2interp_vect(m0, j[0], j[1]),
                    t1.spect2interp_vect(m1, t[0], t[1])):
        _close(a, b)
    for a, b in zip(t0.rt_to_pm(j[2], j[3]), t1.rt_to_pm(t[2], t[3])):
        _close(a, b)
    for a, b in zip(t0.pm_to_rt(j[2], j[3]), t1.pm_to_rt(t[2], t[3])):
        _close(a, b)
    _close(t0.spect2partial_interp(m0, j[4]),
           t1.spect2partial_interp(m1, t[4]))
    _close(t0.partial_interp2spect(m0, j[4]),
           t1.partial_interp2spect(m1, t[4]))
    for a, b in zip(t0.spect2interp_EB_fields(m0, *j),
                    t1.spect2interp_EB_fields(m1, *t)):
        _close(a, b)
    for a, b in zip(t0.interp2spect_EB_fields(m0, *j),
                    t1.interp2spect_EB_fields(m1, *t)):
        _close(a, b)
    for a, b in zip(t0.interp2spect_J_fields(m0, *j[:3]),
                    t1.interp2spect_J_fields(m1, *t[:3])):
        _close(a, b)


def _configs(**kw):
    from fbpic_tpu.fields import GridConfig as G0
    from fbpic_tpu_torch.fields import GridConfig as G1
    return G0(**kw), G1(**kw)


def _aux(g0, g1):
    from fbpic_tpu.fields import build_field_aux as b0
    from fbpic_tpu_torch.fields import build_field_aux as b1
    return b0(g0), b1(g1, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("use_true_rho", [False, True])
def test_psatd_push_correction_filters_match_jax(use_true_rho):
    from fbpic_tpu.fields import psatd_push as p0
    from fbpic_tpu_torch.fields import psatd_push as p1
    Nm, Nz, Nr, rmax, dz = 2, 64, 32, 20e-6, 1e-6
    g0, g1 = _configs(Nz=Nz, Nr=Nr, Nm=Nm, dz=dz, dr=rmax / Nr, rmax=rmax,
                      dt=0.5 * dz / c, n_order=32)
    a0, a1 = _aux(g0, g1)
    for name in ("C", "S_w", "j_coef", "rho_prev_coef", "rho_next_coef",
                 "inv_k2", "filter_z", "filter_r", "invvol",
                 "ruyten_linear", "kz", "kr", "kz_true"):
        np.testing.assert_array_equal(np.asarray(getattr(a0, name)),
                                      getattr(a1, name).numpy())
    rng = np.random.RandomState(3)
    F = [_both(rng, (Nm, Nz, Nr)) for _ in range(12)]
    j, t = zip(*F)
    coefs0 = (a0.rho_prev_coef, a0.rho_next_coef, a0.j_coef, a0.C, a0.S_w,
              a0.kr, a0.kz, g0.dt)
    coefs1 = (a1.rho_prev_coef, a1.rho_next_coef, a1.j_coef, a1.C, a1.S_w,
              a1.kr, a1.kz, g1.dt)
    out0 = p0.push_eb_standard(*j[:11], *coefs0, use_true_rho=use_true_rho)
    out1 = p1.push_eb_standard(*t[:11], *coefs1, use_true_rho=use_true_rho)
    for a, b in zip(out0, out1):
        _close(a, b)
    for drho in (None, 11):
        d0 = None if drho is None else j[drho]
        d1 = None if drho is None else t[drho]
        for a, b in zip(
                p0.correct_currents_curlfree_standard(
                    j[9], j[10], j[6], j[7], j[8], a0.kz, a0.kr, a0.inv_k2,
                    1 / g0.dt, drho=d0),
                p1.correct_currents_curlfree_standard(
                    t[9], t[10], t[6], t[7], t[8], a1.kz, a1.kr, a1.inv_k2,
                    1 / g1.dt, drho=d1)):
            _close(a, b)
    _close(p0.filter_scalar(j[0], a0.filter_z, a0.filter_r),
           p1.filter_scalar(t[0], a1.filter_z, a1.filter_r))
    for a, b in zip(p0.filter_vector(*j[:3], a0.filter_z, a0.filter_r),
                    p1.filter_vector(*t[:3], a1.filter_z, a1.filter_r)):
        _close(a, b)


def test_window_shift_and_skinny_damping_match_jax():
    """Moving-window spectral shift and the skinny open-z damping."""
    from fbpic_tpu.core import step as s0
    from fbpic_tpu.fields.solver import SpectralFields as SF0, \
        InterpFields as IF0
    from fbpic_tpu_torch.core import step as s1
    from fbpic_tpu_torch.fields.solver import SpectralFields as SF1, \
        InterpFields as IF1
    Nm, Nr, rmax, dz = 2, 12, 10e-6, 0.1e-6
    Nz = 40 + 2 * (8 + 10 + 4)
    g0, g1 = _configs(Nz=Nz, Nr=Nr, Nm=Nm, dz=dz, dr=rmax / Nr, rmax=rmax,
                      dt=dz / c, n_order=16, boundaries_z="open", n_guard=8,
                      nz_damp=10, n_inject=4)
    a0, a1 = _aux(g0, g1)
    np.testing.assert_array_equal(np.asarray(a0.damp_rows),
                                  a1.damp_rows.numpy())
    np.testing.assert_array_equal(np.asarray(a0.damp_z), a1.damp_z.numpy())
    _close(np.asarray(a0.damp_skinny_re) + 1j * np.asarray(a0.damp_skinny_im),
           a1.damp_skinny, tol=1e-15)
    rng = np.random.RandomState(4)
    names = [f.name for f in dataclasses.fields(SF1)]
    F = dict(zip(names, (_both(rng, (Nm, Nz, Nr)) for _ in names)))
    sp0 = SF0(**{n: v[0] for n, v in F.items()})
    sp1 = SF1(**{n: v[1] for n, v in F.items()})
    for n_move in (0, 1, 3):
        out0 = s0.shift_spectral_fields(g0, a0, sp0, jnp.int32(n_move))
        out1 = s1.shift_spectral_fields(g1, a1, sp1, n_move, np.float64)
        for n in names:
            _close(getattr(out0, n), getattr(out1, n))
    inames = [f.name for f in dataclasses.fields(IF1)]
    G = dict(zip(inames, (_both(rng, (Nm, Nz, Nr)) for _ in inames)))
    ip0 = IF0(**{n: v[0] for n, v in G.items()})
    ip1 = IF1(**{n: v[1] for n, v in G.items()})
    out0 = s0.damp_EB_z_skinny(a0, sp0, ip0)
    out1 = s1.damp_EB_z_skinny(a1, sp1, ip1)
    for n in ("Ep", "Em", "Ez", "Bp", "Bm", "Bz"):
        _close(getattr(out0, n), getattr(out1, n))


@pytest.mark.parametrize("use_galilean", [True, False])
@pytest.mark.parametrize("use_true_rho", [False, True])
def test_comoving_push_and_correction_match_jax(use_galilean, use_true_rho):
    """The Galilean (grid flowing at v_comoving) and comoving PSATD
    coefficients, push_eb_comoving and the comoving curl-free correction,
    at the flow of the boosted-frame example (v = -c sqrt(1 - 1/10^2)).
    The complex coefficients (T_eb, T_cc, T_rho, j_corr_coef and the
    complex j_coef / rho_*_coef) are native complex tensors in the port,
    CArr pairs in fbpic_tpu."""
    from fbpic_tpu.fields import psatd_push as p0
    from fbpic_tpu_torch.fields import psatd_push as p1
    Nm, Nz, Nr, rmax, dz = 2, 64, 32, 20e-6, 1e-6
    v = -c * np.sqrt(1. - 1. / 10.**2)
    g0, g1 = _configs(Nz=Nz, Nr=Nr, Nm=Nm, dz=dz, dr=rmax / Nr, rmax=rmax,
                      dt=dz / c, n_order=32, v_comoving=v,
                      use_galilean=use_galilean)
    assert g1.use_comoving and g1.use_galilean == use_galilean
    a0, a1 = _aux(g0, g1)
    for name in ("C", "S_w", "j_coef", "rho_prev_coef", "rho_next_coef",
                 "T_eb", "T_cc", "T_rho", "j_corr_coef"):
        ref, out = getattr(a0, name), getattr(a1, name)
        assert out.dtype == (torch.complex128 if isinstance(ref, CArr)
                             else torch.float64), name
        _close(ref, out, tol=1e-15)
    rng = np.random.RandomState(5)
    F = [_both(rng, (Nm, Nz, Nr)) for _ in range(11)]
    j, t = zip(*F)
    out0 = p0.push_eb_comoving(
        *j, a0.rho_prev_coef, a0.rho_next_coef, a0.j_coef, a0.C, a0.S_w,
        a0.T_eb, a0.T_cc, a0.T_rho, a0.kr, a0.kz, g0.dt, v,
        use_true_rho=use_true_rho)
    out1 = p1.push_eb_comoving(
        *t, a1.rho_prev_coef, a1.rho_next_coef, a1.j_coef, a1.C, a1.S_w,
        a1.T_eb, a1.T_cc, a1.T_rho, a1.kr, a1.kz, g1.dt, v,
        use_true_rho=use_true_rho)
    for a, b in zip(out0, out1):
        assert b.dtype == torch.complex128
        _close(a, b)
    for a, b in zip(
            p0.correct_currents_curlfree_comoving(
                j[9], j[10], j[6], j[7], j[8], a0.kz, a0.kr, a0.inv_k2,
                a0.j_corr_coef, a0.T_eb, a0.T_cc, 1 / g0.dt),
            p1.correct_currents_curlfree_comoving(
                t[9], t[10], t[6], t[7], t[8], a1.kz, a1.kr, a1.inv_k2,
                a1.j_corr_coef, a1.T_eb, a1.T_cc, 1 / g1.dt)):
        _close(a, b)


def test_comoving_push_keeps_complex64_in_float32():
    """float32 runs: every product of the comoving push stays complex64
    (a complex128 coefficient would silently promote the fields)."""
    from fbpic_tpu_torch.fields import GridConfig, build_field_aux
    from fbpic_tpu_torch.fields import psatd_push as p1
    Nm, Nz, Nr, rmax, dz = 2, 16, 8, 20e-6, 1e-6
    g = GridConfig(Nz=Nz, Nr=Nr, Nm=Nm, dz=dz, dr=rmax / Nr, rmax=rmax,
                   dt=dz / c, n_order=16, v_comoving=-0.99 * c)
    a = build_field_aux(g, device="cpu", dtype=torch.float32)
    for name in ("j_coef", "rho_prev_coef", "rho_next_coef", "T_eb", "T_cc",
                 "T_rho", "j_corr_coef"):
        assert getattr(a, name).dtype == torch.complex64, name
    rng = np.random.RandomState(6)
    f = [torch.as_tensor(rng.randn(Nm, Nz, Nr) + 1j * rng.randn(Nm, Nz, Nr),
                         dtype=torch.complex64) for _ in range(11)]
    for use_true_rho in (False, True):
        out = p1.push_eb_comoving(
            *f, a.rho_prev_coef, a.rho_next_coef, a.j_coef, a.C, a.S_w,
            a.T_eb, a.T_cc, a.T_rho, a.kr, a.kz, g.dt, g.v_comoving,
            use_true_rho=use_true_rho)
        assert all(o.dtype == torch.complex64 for o in out)
    out = p1.correct_currents_curlfree_comoving(
        f[9], f[10], f[6], f[7], f[8], a.kz, a.kr, a.inv_k2, a.j_corr_coef,
        a.T_eb, a.T_cc, 1 / g.dt)
    assert all(o.dtype == torch.complex64 for o in out)
