"""Cubic particle shapes: fbpic_tpu_torch against fbpic_tpu.

Module by module on the same numpy-seeded particles (a third of them
near or below the axis, some dead, some past both z ends): the scatter
deposits ``deposit_rho_cubic`` / ``deposit_J_cubic``, the 4x4 gather
``gather_fields_cubic`` and the sorted ``deposit_rho_J_sorted_cubic``
(J + rho, and J + d(rho)), in both z folds, with and without the Kahan
words, with a Galilean ``vz_shift``.  float64 to 1e-12 of each output's
largest value; float32 (explicit float32 inputs, fbpic_tpu under x64
keeps them float32) to 1e-5, or 2e-4 for d(rho), a difference of two
nearby deposits: fbpic_tpu's float32 contraction splits V into three
bfloat16 terms, the port's index_add_ sums in float32.

Then a short periodic cubic run, as tests/test_sorted_deposit.py::
test_fused_cubic_step_matches_scatter_step, through both packages'
Simulation: the scatter path in float64 and the sorted path (forced by
use_fused_deposit and sort_K), fields to 1e-8 and particles to 1e-12 of
the largest value of their vector (tests/test_torch_step.py's
tolerances).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c, e, m_e  # noqa: E402

NZ, NR, NM = 24, 10, 2
DZ, DR, ZMIN = 0.1, 0.2, -1.0
Q = -1.6e-19
INTERP = ("Er", "Et", "Ez", "Br", "Bt", "Bz")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _ruyten_cubic():
    from fbpic_tpu import Simulation
    sim = Simulation(NZ, ZMIN + NZ * DZ, NR, NR * DR, NM, 1e-12, zmin=ZMIN,
                     verbose_level=0)
    return np.asarray(sim.aux.ruyten_cubic)


def _particles(dtype, zfold, seed=11, Np=3000, slow=False):
    """x, y, z, w, ux, uy, uz, inv_gamma and the Kahan words."""
    rng = np.random.RandomState(seed)
    if zfold == "periodic":
        z = ZMIN + rng.uniform(0.0, NZ * DZ, Np)
    else:
        z = ZMIN + rng.uniform(-0.25, NZ * DZ + 0.25, Np)
    r = np.where(rng.rand(Np) < 0.35, rng.uniform(0, 2.5 * DR, Np),
                 rng.uniform(0, NR * DR * 1.05, Np))
    th = rng.uniform(0, 2 * np.pi, Np)
    w = rng.uniform(0.5, 1.5, Np)
    w[rng.rand(Np) < 0.1] = 0.0
    ux, uy, uz = rng.randn(3, Np) * (0.005 if slow else 0.5)
    ig = 1 / np.sqrt(1 + ux**2 + uy**2 + uz**2)
    comp = [rng.randn(Np) * 1e-7 * DZ for _ in range(3)]
    arrs = [a.astype(dtype) for a in (r * np.cos(th), r * np.sin(th), z, w,
                                      ux, uy, uz, ig)]
    return arrs, [a.astype(dtype) for a in comp]


def _rel(ref, out):
    ref, out = np.asarray(ref), np.asarray(out)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300)


def _cplx(a):
    """A CArr or complex tensor as complex numpy."""
    if hasattr(a, "re"):
        return np.asarray(a.re) + 1j * np.asarray(a.im)
    return a.numpy()


TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("zfold", ["clamp", "periodic"])
@pytest.mark.parametrize("with_comp", [False, True])
def test_scatter_deposits_match(dtype, zfold, with_comp):
    from fbpic_tpu.particles import deposit as d0
    from fbpic_tpu_torch.particles import deposit as d1
    arrs, comp = _particles(dtype, zfold)
    ruy = _ruyten_cubic().astype(dtype)
    geo = (NM, 1 / DZ, ZMIN, NZ, 1 / DR, 0.0, NR)
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.as_tensor(a) for a in arrs]
    cj = tuple(jnp.asarray(a) for a in comp) if with_comp else None
    ct = tuple(torch.as_tensor(a) for a in comp) if with_comp else None
    x, y, z, w, ux, uy, uz, ig = range(8)
    rho0 = d0.deposit_rho_cubic(j[x], j[y], j[z], j[w], Q, *geo,
                                jnp.asarray(ruy), zfold=zfold, comp=cj)
    rho1 = d1.deposit_rho_cubic(t[x], t[y], t[z], t[w], Q, *geo,
                                torch.as_tensor(ruy), zfold=zfold, comp=ct)
    assert _rel(_cplx(rho0), _cplx(rho1)) <= TOL[dtype]
    J0 = d0.deposit_J_cubic(*j[:4], Q, *j[4:], *geo, jnp.asarray(ruy),
                            zfold=zfold, comp=cj)
    J1 = d1.deposit_J_cubic(*t[:4], Q, *t[4:], *geo, torch.as_tensor(ruy),
                            zfold=zfold, comp=ct)
    for a, b in zip(J0, J1):
        assert _rel(_cplx(a), _cplx(b)) <= TOL[dtype]


def test_deposit_rho_J_linear_matches():
    """The joint linear scatter of deposit_species_rho_J_full."""
    from fbpic_tpu import Simulation
    from fbpic_tpu.particles import deposit as d0
    from fbpic_tpu_torch.particles import deposit as d1
    sim = Simulation(NZ, ZMIN + NZ * DZ, NR, NR * DR, NM, 1e-12, zmin=ZMIN,
                     verbose_level=0)
    ruy = np.asarray(sim.aux.ruyten_linear)
    arrs, _ = _particles(np.float64, "clamp")
    geo = (NM, 1 / DZ, ZMIN, NZ, 1 / DR, 0.0, NR)
    out0 = d0.deposit_rho_J_linear(*[jnp.asarray(a) for a in arrs[:4]], Q,
                                   *[jnp.asarray(a) for a in arrs[4:]], *geo,
                                   jnp.asarray(ruy), zfold="clamp")
    out1 = d1.deposit_rho_J_linear(*[torch.as_tensor(a) for a in arrs[:4]],
                                   Q, *[torch.as_tensor(a) for a in arrs[4:]],
                                   *geo, torch.as_tensor(ruy), zfold="clamp")
    for a, b in zip(out0, out1):
        assert _rel(_cplx(a), _cplx(b)) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_comp", [False, True])
def test_gather_cubic_matches(dtype, with_comp):
    """Particles past the last radial cell and past rmax_gather, on and
    below the axis, beyond both z ends (z taken mod Nz); each output
    against the largest value of its vector pair (Ex/Ey rotate the same
    (Fr, Ft))."""
    from fbpic_tpu.fields.solver import InterpFields as I0
    from fbpic_tpu.particles.gather import gather_fields_cubic as g0
    from fbpic_tpu.utils.complex_arr import CArr
    from fbpic_tpu_torch.fields.solver import InterpFields as I1
    from fbpic_tpu_torch.particles.gather import gather_fields_cubic as g1
    arrs, comp = _particles(dtype, "clamp", seed=5)
    arrs[0][::97] = 0.0
    arrs[1][::97] = 0.0
    rng = np.random.RandomState(3)
    fields = {n: (rng.randn(NM, NZ, NR).astype(dtype),
                  rng.randn(NM, NZ, NR).astype(dtype)) for n in INTERP}
    rmax = 0.93 * NR * DR
    geo = (1 / DZ, ZMIN, NZ, 1 / DR, 0.0, NR)
    ref = g0(*[jnp.asarray(a) for a in arrs[:3]],
             I0(**{n: CArr(jnp.asarray(re), jnp.asarray(im))
                   for n, (re, im) in fields.items()}), rmax, *geo,
             comp=tuple(jnp.asarray(a) for a in comp) if with_comp else None)
    out = g1(*[torch.as_tensor(a) for a in arrs[:3]],
             I1(**{n: torch.complex(torch.as_tensor(re), torch.as_tensor(im))
                   for n, (re, im) in fields.items()}), rmax, *geo,
             comp=(tuple(torch.as_tensor(a) for a in comp) if with_comp
                   else None))
    tol = {np.float64: 1e-12, np.float32: 5e-6}[dtype]
    for pair in ((0, 1), (2,), (3, 4), (5,)):
        scale = max(np.abs(np.asarray(ref[i])).max() for i in pair)
        for i in pair:
            err = np.abs(out[i].numpy() - np.asarray(ref[i])).max()
            assert err <= tol * scale, (i, err / scale)


def _sorts(arrs, comp, dtype, with_comp, K=512):
    """fbpic_tpu's and the port's payload plans of the same particles
    (the step's: x, y, z, w, u, inv_gamma [, Kahan words])."""
    from fbpic_tpu.particles import sorted_deposit as sd0
    from fbpic_tpu_torch.particles import sorted_deposit as sd1
    pay = arrs + (comp if with_comp else [])
    j = [jnp.asarray(a) for a in pay]
    t = [torch.as_tensor(a) for a in pay]
    s0 = sd0.build_column_sort(j[2], j[3], ZMIN, 1 / DZ, NZ, K,
                               payload=tuple(j))
    s1 = sd1.build_column_sort(t[2], t[3], ZMIN, 1 / DZ, NZ, K, t)
    np.testing.assert_array_equal(np.asarray(s0["valid"]),
                                  s1["valid"].numpy())
    return (s0, j), (s1, t)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("zfold,with_comp,vz_shift", [
    ("clamp", False, 0.0), ("periodic", False, 0.0),
    ("clamp", True, -0.3 * c), ("periodic", True, 0.0)])
def test_sorted_cubic_matches(dtype, zfold, with_comp, vz_shift):
    """deposit_rho_J_sorted_cubic: J + rho (with_drho off) and J + d(rho)
    (with_drho on, rho off), on the step's payload plan."""
    from fbpic_tpu.particles import sorted_deposit as sd0
    from fbpic_tpu_torch.particles import sorted_deposit as sd1
    arrs, comp = _particles(dtype, zfold, slow=True)
    if zfold == "clamp":
        # stragglers stay within the removal margin of the step
        arrs[2] = np.clip(arrs[2], ZMIN, ZMIN + NZ * DZ).astype(dtype)
    ruy = _ruyten_cubic().astype(dtype)
    (s0, j), (s1, t) = _sorts(arrs, comp, dtype, with_comp)
    dt_half = dtype(0.25 * DZ / c)
    tail = (dt_half, NM, 1 / DZ, ZMIN, NZ, 1 / DR, 0.0, NR)
    for with_drho in (False, True):
        kw = dict(zfold=zfold, with_drho=with_drho, with_rho=not with_drho,
                  vz_shift=vz_shift)
        out0 = sd0.deposit_rho_J_sorted_cubic(
            s0, *j[:4], Q, *j[4:8], *tail, jnp.asarray(ruy),
            comp=tuple(j[8:]) if with_comp else None, **kw)
        out1 = sd1.deposit_rho_J_sorted_cubic(
            s1, *t[:4], Q, *t[4:8], *tail, torch.as_tensor(ruy),
            comp=tuple(t[8:]) if with_comp else None, **kw)
        assert (out0[3] is None) == (out1[3] is None) == with_drho
        tols = [TOL[dtype]] * 4 + [
            {np.float64: 1e-12, np.float32: 2e-4}[dtype]]
        for k, (a, b) in enumerate(zip(out0, out1)):
            if a is not None:
                assert _rel(_cplx(a), _cplx(b)) <= tols[k], (k, with_drho)


def test_periodic_cubic_run_matches_fbpic_tpu():
    """tests/test_sorted_deposit.py::test_fused_cubic_step_matches_
    scatter_step's run (a periodic modulated plasma with a drift, 10
    steps) through both packages: the scatter path and the sorted path
    (the fused deposit on a fresh mid-step sort), float64."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    Nz, Nr, Nm = 48, 16, 2
    Lz, rmax = 20.e-6, 15.e-6
    kw = dict(zmin=0., boundaries={"z": "periodic", "r": "reflective"},
              particle_shape="cubic", random_seed=0, verbose_level=0)
    for fused in (False, True):
        sp = dict(q=-e, m=m_e, n=1.e24, p_nz=2, p_nr=2, p_nt=4, uz_m=0.05,
                  p_zmin=0., p_zmax=Lz, p_rmax=12.e-6,
                  sort_K=256 if fused else 0,
                  dens_func=lambda z, r: 1. + 0.05 * np.sin(
                      2 * np.pi * z / Lz))
        s0 = S0(Nz, Lz, Nr, rmax, Nm, Lz / Nz / 3.e8, **kw)
        s1 = S1(Nz, Lz, Nr, rmax, Nm, Lz / Nz / 3.e8, device="cpu",
                dtype=torch.float64, **kw)
        s0.use_fused_deposit = s1.use_fused_deposit = fused
        s0.add_new_species(**sp)
        s1.add_new_species(**sp)
        for sc in (s0.species_configs[0], s1.species_configs[0]):
            assert sc.particle_shape == "cubic" and not sc.resident
        s0.step(10, show_progress=False)
        s1.step(10)
        sp0, sp1 = s0.state.species[0], s1.state.species[0]
        pairs = [(_cplx(getattr(s0.state.interp, n)),
                  getattr(s1.state.interp, n).numpy()) for n in INTERP]
        pairs += [(np.asarray(getattr(sp0, n)), getattr(sp1, n).numpy())
                  for n in ("x", "y", "z", "ux", "uy", "uz")]
        # each to the largest value of its vector (E, B, x, u)
        for k, tol in enumerate((1e-8, 1e-8, 1e-12, 1e-12)):
            vec = pairs[3 * k:3 * k + 3]
            scale = max(np.abs(ref).max() for ref, _ in vec)
            for ref, out in vec:
                assert np.abs(out - ref).max() <= tol * scale, (k, fused)
