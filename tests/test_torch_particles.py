"""fbpic_tpu_torch particle modules against fbpic_tpu.

- Vay push, position push and the Kahan-compensated push: elementwise,
  float64 (1e-14 relative: same formulas, same order) and float32
  (2e-6 relative: a few ULPs, the compilers may contract into FMAs);
- build_column_sort with payload and banded_column_resort: exact layout
  equality (open z), including knife-edge escapees and column overflow;
- the scatter deposits deposit_rho_linear / deposit_J_linear: float64
  with particles below the axis, 1e-12 relative (scatter-add order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c  # noqa: E402


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _particles(rng, Np, dtype, zmin=-1.0, Lz=3.2, rmax=2.4, dr=0.2):
    z = zmin + rng.uniform(0.0, Lz, Np)
    r = np.where(rng.rand(Np) < 0.4, rng.uniform(0, 1.5 * dr, Np),
                 rng.uniform(0, rmax * 0.99, Np))
    th = rng.uniform(0, 2 * np.pi, Np)
    w = rng.uniform(0.5, 1.5, Np)
    w[rng.rand(Np) < 0.1] = 0.0
    ux, uy, uz = rng.randn(3, Np) * 0.5
    ig = 1 / np.sqrt(1 + ux ** 2 + uy ** 2 + uz ** 2)
    return [a.astype(dtype) for a in (r * np.cos(th), r * np.sin(th), z, w,
                                      ux, uy, uz, ig)]


class _P:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-14),
                                       (np.float32, 2e-6)])
def test_pushers_match_jax(dtype, tol):
    from fbpic_tpu.particles import push as p0
    from fbpic_tpu_torch.particles import push as p1
    rng = np.random.RandomState(11)
    Np = 2000
    x, y, z, w, ux, uy, uz, ig = _particles(rng, Np, dtype)
    E = [(rng.randn(Np) * 1e11).astype(dtype) for _ in range(3)]
    B = [(rng.randn(Np) * 3e2).astype(dtype) for _ in range(3)]
    q, m, dt = -1.602e-19, 9.109e-31, 1.3e-16
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.as_tensor(a)
    P0 = _P(x=J(x), y=J(y), z=J(z), ux=J(ux), uy=J(uy), uz=J(uz),
            inv_gamma=J(ig), ionization_level=None,
            comp_x=J(x * 0 + 1e-9), comp_y=J(y * 0), comp_z=J(z * 0 - 2e-9))
    P1 = _P(x=T(x), y=T(y), z=T(z), ux=T(ux), uy=T(uy), uz=T(uz),
            inv_gamma=T(ig), comp_x=T(x * 0 + 1e-9), comp_y=T(y * 0),
            comp_z=T(z * 0 - 2e-9))
    out0 = p0.push_p(P0, [J(e) for e in E], [J(b) for b in B], q, m, dt)
    out1 = p1.push_p(P1, [T(e) for e in E], [T(b) for b in B], q, m, dt)
    for a, b in zip(out0, out1):
        assert b.dtype == T(x).dtype
        assert _rel(b.numpy(), a) <= tol
    for a, b in zip(p0.push_x(P0, 0.5 * dt), p1.push_x(P1, 0.5 * dt)):
        assert _rel(b.numpy(), a) <= tol
    for a, b in zip(p0.push_x_compensated(P0, 0.5 * dt),
                    p1.push_x_compensated(P1, 0.5 * dt)):
        assert _rel(b.numpy(), a) <= tol


def _sorts(dtype, K, zfold="clamp"):
    from fbpic_tpu.particles import sorted_deposit as s0
    from fbpic_tpu_torch.particles import sorted_deposit as s1
    rng = np.random.RandomState(17)
    Nz, dz, zmin = 32, 0.1, -1.0
    arrs = _particles(rng, 3000, dtype)
    # a few stragglers outside the box (clamped to the edge columns)
    arrs[2][:5] = zmin - 0.05
    arrs[2][5:10] = zmin + Nz * dz + 0.05
    j = s0.build_column_sort(jnp.asarray(arrs[2]), jnp.asarray(arrs[3]),
                             zmin, 1 / dz, Nz, K,
                             payload=tuple(jnp.asarray(a) for a in arrs))
    t = s1.build_column_sort(torch.as_tensor(arrs[2]),
                             torch.as_tensor(arrs[3]), zmin, 1 / dz, Nz, K,
                             [torch.as_tensor(a) for a in arrs])
    return s0, s1, j, t, (Nz, dz, zmin)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("K", [256, 96])
def test_column_sort_layout_equal(dtype, K):
    """Exact (Nz, K) layout equality; K=96 overflows some columns."""
    _, _, j, t, _ = _sorts(dtype, K)
    np.testing.assert_array_equal(np.asarray(j["valid"]), t["valid"].numpy())
    assert int(j["n_over"]) == int(t["n_over"])
    for a, b in zip(j["padded"], t["padded"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_banded_resort_layout_equal(dtype):
    """Re-sort after a drift of up to one cell (plus knife-edge escapees
    and particles pushed past the band), open z: exact equality."""
    s0, s1, j, t, (Nz, dz, zmin) = _sorts(dtype, 256)
    rng = np.random.RandomState(19)
    pad = [np.asarray(a).copy() for a in j["padded"]]
    K = pad[0].shape[1]
    pad[2] = pad[2] + (rng.uniform(-1.0, 1.0, pad[2].shape)
                       * dz).astype(dtype)
    edge = rng.rand(*pad[2].shape) < 0.01
    cell = np.floor((pad[2] - zmin) / dz)
    pad[2] = np.where(edge, (zmin + (cell + 2) * dz).astype(dtype), pad[2])
    pad[3] = np.where(np.asarray(j["valid"]), pad[3], 0).astype(dtype)
    for band in (1, 2):
        a = s0.banded_column_resort(tuple(jnp.asarray(p) for p in pad),
                                    zmin, 1 / dz, Nz, K, band, zfold="clamp")
        b = s1.banded_column_resort([torch.as_tensor(p) for p in pad],
                                    zmin, 1 / dz, Nz, K, band, zfold="clamp")
        np.testing.assert_array_equal(np.asarray(a["valid"]),
                                      b["valid"].numpy())
        assert int(a["n_over"]) == int(b["n_over"])
        for x0, x1 in zip(a["padded"], b["padded"]):
            np.testing.assert_array_equal(np.asarray(x0), x1.numpy())


@pytest.mark.parametrize("zfold", ["clamp", "periodic"])
@pytest.mark.parametrize("with_comp", [False, True])
def test_scatter_deposits_match_jax(zfold, with_comp):
    from fbpic_tpu.particles import deposit as d0
    from fbpic_tpu_torch.particles import deposit as d1
    from fbpic_tpu import Simulation
    Nz, Nr, Nm, dz, dr, zmin = 32, 12, 3, 0.1, 0.2, -1.0
    sim = Simulation(Nz, zmin + Nz * dz, Nr, Nr * dr, Nm, 1e-12, zmin=zmin,
                     verbose_level=0)
    ruy = np.array(sim.aux.ruyten_linear)
    rng = np.random.RandomState(13)
    x, y, z, w, ux, uy, uz, ig = _particles(rng, 4000, np.float64)
    comp = [rng.randn(4000) * 1e-9 for _ in range(3)] if with_comp else None
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.as_tensor(a)
    geo = (Nm, 1 / dz, zmin, Nz, 1 / dr, 0.0, Nr)
    c0 = None if comp is None else tuple(J(a) for a in comp)
    c1 = None if comp is None else tuple(T(a) for a in comp)
    r0 = d0.deposit_rho_linear(J(x), J(y), J(z), J(w), -1.6e-19, *geo,
                               J(ruy), zfold=zfold, comp=c0)
    r1 = d1.deposit_rho_linear(T(x), T(y), T(z), T(w), -1.6e-19, *geo,
                               T(ruy), zfold=zfold, comp=c1)
    assert _rel(r1.numpy(), r0.to_numpy()) <= 1e-12
    j0 = d0.deposit_J_linear(J(x), J(y), J(z), J(w), -1.6e-19, J(ux), J(uy),
                             J(uz), J(ig), *geo, J(ruy), zfold=zfold,
                             comp=c0)
    j1 = d1.deposit_J_linear(T(x), T(y), T(z), T(w), -1.6e-19, T(ux), T(uy),
                             T(uz), T(ig), *geo, T(ruy), zfold=zfold,
                             comp=c1)
    for a, b in zip(j0, j1):
        assert _rel(b.numpy(), a.to_numpy()) <= 1e-12
