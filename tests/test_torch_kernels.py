"""The port's two kernels (K1 fused J + d(rho) deposit, K2 sorted gather)
against fbpic_tpu's Pallas kernels and XLA paths, on the inputs of
tests/test_pallas_deposit.py and tests/test_pallas_gather.py.

On the CPU the port's wrappers run their plain PyTorch versions, so this
file holds those against:
- the Pallas kernel in interpreter mode (``interpret=True``), and
- fbpic_tpu's XLA path (FBPIC_TPU_PALLAS_DEPOSIT / _GATHER = 0),
on identical float32 operands.  Tolerances: 2e-6 (K1) and 5e-6 (K2)
relative to each output part's largest value -- the Pallas and XLA
paths split float32 into 3 bf16 terms (about float32-exact), the port
sums in plain float32 in another order.

The end-to-end sorted deposit (both branches) and gather follow, in
float32 and float64 (1e-12).  The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu import Simulation  # noqa: E402
from fbpic_tpu.constants import c  # noqa: E402


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _deposit_inputs(dtype=np.float32, seed=23):
    """tests/test_pallas_deposit.py:31-58."""
    rng = np.random.RandomState(seed)
    Nz, Nr, Nm = 32, 12, 2
    dz, dr, zmin = 0.1, 0.2, -1.0
    sim = Simulation(Nz, zmin + Nz * dz, Nr, Nr * dr, Nm, 1e-12,
                     zmin=zmin, verbose_level=0)
    ruy = np.array(sim.aux.ruyten_linear).astype(dtype)
    Np = 4000
    z = zmin + rng.uniform(0.0, Nz * dz, Np)
    r = np.where(rng.rand(Np) < 0.4, rng.uniform(0, 1.5 * dr, Np),
                 rng.uniform(0, Nr * dr * 0.99, Np))
    th = rng.uniform(0, 2 * np.pi, Np)
    x, y = r * np.cos(th), r * np.sin(th)
    w = rng.uniform(0.5, 1.5, Np)
    w[rng.rand(Np) < 0.1] = 0.0
    ux, uy, uz = rng.randn(3, Np) * 0.5
    ig = 1 / np.sqrt(1 + ux ** 2 + uy ** 2 + uz ** 2)
    arrs = [a.astype(dtype) for a in (x, y, z, w, ux, uy, uz, ig)]
    return arrs, dict(Nz=Nz, Nr=Nr, Nm=Nm, dz=dz, dr=dr, zmin=zmin, ruy=ruy)


def _port_sort(arrs, g, K=512):
    from fbpic_tpu_torch.particles.sorted_deposit import build_column_sort
    t = [torch.as_tensor(a) for a in arrs]
    return build_column_sort(t[2], t[3], g["zmin"], 1 / g["dz"], g["Nz"], K,
                             t)


def _jax_sort(arrs, g, K=512):
    from fbpic_tpu.particles import sorted_deposit as sd
    j = [jnp.asarray(a) for a in arrs]
    return sd.build_column_sort(j[2], j[3], g["zmin"], 1 / g["dz"], g["Nz"],
                                K, payload=tuple(j))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _k1_operands(sort_at_start):
    from fbpic_tpu_torch.particles.sorted_deposit import (
        fused_contract_operands)
    arrs, g = _deposit_inputs()
    sort = _port_sort(arrs, g)
    x, y, z, w, ux, uy, uz, ig = sort["padded"]
    ops = fused_contract_operands(
        sort, x, y, z, w, np.float32(-1.6e-19), ux, uy, uz, ig,
        np.float32(0.25 * g["dz"] / c), g["Nm"], 1 / g["dz"], g["zmin"],
        g["Nz"], 1 / g["dr"], 0.0, g["Nr"], torch.as_tensor(g["ruy"]),
        zfold="clamp", sort_at_start=sort_at_start)
    return ops


def _to_jax(v):
    if isinstance(v, torch.Tensor):
        return jnp.asarray(v.numpy())
    if isinstance(v, dict):
        return {k: _to_jax(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_jax(x) for x in v]
    return v


@pytest.mark.parametrize("sort_at_start", [True, False])
def test_k1_plain_matches_pallas_and_xla(sort_at_start):
    from fbpic_tpu.particles import pallas_fused, sorted_deposit as sd
    from fbpic_tpu.particles.deposit import _channel_meta
    from fbpic_tpu_torch.particles.cuda_fused import fused_onehot_contract
    ops = _k1_operands(sort_at_start)
    out = fused_onehot_contract(**ops).numpy()
    jo = _to_jax(ops)
    Nm, Nrb = ops["Nm"], ops["Nr"] + 4
    # Pallas kernel in interpreter mode
    pal = np.asarray(pallas_fused.fused_onehot_contract(
        jo["geom"], jo["channels"], None, jo["span"], jo["dph"], jo["ph_b"],
        jo["wj"], jo["ruyten"], Nm, ops["Nz"], ops["Nr"], n_offJ=ops["n_offJ"],
        n_offD=ops["n_offD"], interpret=True))
    # fbpic_tpu's XLA path: V blocks + one-hot contraction
    geom = dict(jo["geom"], below_axis=jo["geom"]["below_axis"])
    metaJ = _channel_meta(Nm, 3, [-1.0, -1.0, +1.0], jnp.float32)
    metaD = _channel_meta(Nm, 1, [+1.0], jnp.float32)
    V = sd._build_V(geom, jo["channels"], metaJ) + sd._build_V_span_diff(
        jo["span"], jo["ph_b"] - jo["dph"], jo["ph_b"], jo["wj"], metaD,
        jo["ruyten"], n_blocks=ops["n_offD"])
    S = jax.nn.one_hot(jo["geom"]["ir_buf"], Nrb, dtype=jnp.float32)
    xla = np.asarray(sd._contract(S, V))
    W_J = ops["n_offJ"] * 2 * ops["channels"].shape[2]
    for ref in (pal, xla):
        assert ref.shape == out.shape
        for part in (slice(None, W_J), slice(W_J, None)):
            assert _rel(out[..., part], ref[..., part]) <= 2e-6


def _gather_inputs(zfold, seed=31):
    """tests/test_pallas_gather.py:26-71 (fields and particles)."""
    from fbpic_tpu_torch.fields.solver import InterpFields
    rng = np.random.RandomState(seed)
    Nz, Nr, Nm = 32, 12, 2
    dz, dr, zmin = 0.1, 0.2, -1.0
    f32 = np.float32
    fields = {n: (rng.randn(Nm, Nz, Nr).astype(f32),
                  rng.randn(Nm, Nz, Nr).astype(f32))
              for n in ("Er", "Et", "Ez", "Br", "Bt", "Bz")}
    Np = 3000
    z = zmin + rng.uniform(-0.1, Nz * dz + 0.1, Np)
    r = np.where(rng.rand(Np) < 0.4, rng.uniform(0, 1.2 * dr, Np),
                 rng.uniform(0, Nr * dr * 1.02, Np))
    th = rng.uniform(0, 2 * np.pi, Np)
    w = rng.uniform(0.5, 1.5, Np)
    w[rng.rand(Np) < 0.1] = 0.0
    arrs = [a.astype(f32) for a in (r * np.cos(th), r * np.sin(th), z, w)]
    g = dict(Nz=Nz, Nr=Nr, Nm=Nm, dz=dz, dr=dr, zmin=zmin)
    sort = _port_sort(arrs, g, K=384)
    interp = InterpFields(**{n: torch.complex(torch.as_tensor(re),
                                              torch.as_tensor(im))
                             for n, (re, im) in fields.items()})
    return arrs, g, sort, fields, interp


@pytest.mark.parametrize("zfold", ["periodic", "clamp"])
def test_k2_plain_matches_pallas(zfold):
    from fbpic_tpu.particles.pallas_gather import gather_sorted_pallas
    from fbpic_tpu_torch.particles.cuda_gather import gather_sorted
    from fbpic_tpu_torch.particles.gather import gather_operands
    arrs, g, sort, fields, interp = _gather_inputs(zfold)
    xp, yp, zp = sort["padded"][:3]
    ops = gather_operands(xp, yp, zp, sort["valid"], interp,
                          np.float32(g["Nr"] * g["dr"]), 1 / g["dz"],
                          g["zmin"], g["Nz"], 1 / g["dr"], 0.0, g["Nr"],
                          zfold=zfold)
    out = gather_sorted(**ops)
    jo = _to_jax(ops)
    pal = gather_sorted_pallas(
        jo["o_lo"].astype(jnp.float32), jo["l_r"].astype(jnp.float32),
        jo["sr_upper"], jo["sz_upper"], jo["ok"], jo["cos"], jo["sin"],
        jo["Fg"], n_off=ops["n_off"], Nm=ops["Nm"], Nz=g["Nz"], Nr=g["Nr"],
        interpret=True)
    valid = sort["valid"].numpy()
    for a, b in zip(out, pal):
        assert _rel(a.numpy()[valid], np.asarray(b)[valid]) <= 5e-6


@pytest.mark.parametrize("zfold", ["periodic", "clamp"])
def test_gather_fields_sorted_matches_xla(zfold, monkeypatch):
    """End to end: the port's gather vs fbpic_tpu's XLA one-hot path."""
    import dataclasses
    from fbpic_tpu.particles.gather import gather_fields_sorted as g0
    from fbpic_tpu_torch.particles.gather import gather_fields_sorted as g1
    from fbpic_tpu.utils.complex_arr import CArr
    monkeypatch.setenv("FBPIC_TPU_PALLAS_GATHER", "0")
    arrs, g, sort, fields, interp = _gather_inputs(zfold)
    js = _jax_sort(arrs, g, K=384)
    sim = Simulation(g["Nz"], g["zmin"] + g["Nz"] * g["dz"], g["Nr"],
                     g["Nr"] * g["dr"], g["Nm"], 1e-12, zmin=g["zmin"],
                     verbose_level=0)
    jinterp = dataclasses.replace(sim.state.interp, **{
        n: CArr(jnp.asarray(re), jnp.asarray(im))
        for n, (re, im) in fields.items()})
    geo = (1 / g["dz"], g["zmin"], g["Nz"], 1 / g["dr"], 0.0, g["Nr"])
    rmax = np.float32(g["Nr"] * g["dr"])
    ref = g0(*js["padded"][:3], js["valid"], jinterp, rmax, *geo,
             zfold=zfold)
    out = g1(*sort["padded"][:3], sort["valid"], interp, rmax, *geo,
             zfold=zfold)
    valid = sort["valid"].numpy()
    for a, b in zip(out, ref):
        assert _rel(a.numpy()[valid], np.asarray(b)[valid]) <= 5e-6


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-6),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("with_drho,with_rho", [(True, False), (True, True),
                                                (False, True)])
def test_deposit_rho_J_sorted_matches_xla(dtype, tol, with_drho, with_rho,
                                          monkeypatch):
    """End to end (both branches), sort half a push behind the J
    positions as on the resident main path."""
    from fbpic_tpu.particles import sorted_deposit as s0
    from fbpic_tpu_torch.particles import sorted_deposit as s1
    monkeypatch.setenv("FBPIC_TPU_PALLAS_DEPOSIT", "0")
    arrs, g = _deposit_inputs(dtype=dtype)
    rng = np.random.RandomState(3)
    # Kahan words ride the sort as payload channels 8..10
    arrs = arrs + [(rng.randn(len(arrs[0])) * 1e-9).astype(dtype)
                   for _ in range(3)]
    js, ts = _jax_sort(arrs, g), _port_sort(arrs, g)
    args = (-1.6e-19, g["Nm"], 1 / g["dz"], g["zmin"], g["Nz"], 1 / g["dr"],
            0.0, g["Nr"])
    kw = dict(zfold="clamp", with_drho=with_drho, with_rho=with_rho,
              sort_at_start=True)
    x0 = js["padded"]
    q, Nm, invdz, zmin, Nz, invdr, rmin, Nr = args
    dt_half = dtype(0.25 * g["dz"] / c)
    ref = s0.deposit_rho_J_sorted(
        js, *x0[:4], dtype(q), *x0[4:8], dt_half, Nm, invdz, zmin, Nz,
        invdr, rmin, Nr, tuple(jnp.asarray(t) for t in g["ruy"]),
        comp=tuple(js["padded"][8:]), **kw)
    tp = ts["padded"]
    out = s1.deposit_rho_J_sorted(
        ts, *tp[:4], dtype(q), *tp[4:8], dt_half, Nm, invdz, zmin, Nz, invdr,
        rmin, Nr, torch.as_tensor(g["ruy"]), comp=tuple(tp[8:]), **kw)
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(b.numpy(), a.to_numpy()) <= tol
