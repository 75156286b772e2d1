"""The port's three kernels (K1 fused J + d(rho) deposit, K2 sorted
gather, K3 one-hot dense deposit) against fbpic_tpu's Pallas kernels and
XLA paths, on the inputs of tests/test_pallas_deposit.py and
tests/test_pallas_gather.py.

On the CPU the port's wrappers run their plain PyTorch versions, so this
file holds those against:
- the Pallas kernel in interpreter mode (``interpret=True``), and
- fbpic_tpu's XLA path (FBPIC_TPU_PALLAS_DEPOSIT / _GATHER = 0),
on identical float32 operands.  Tolerances: 2e-6 (K1, K3) and 5e-6
(K2) relative to each output part's largest value -- the Pallas and XLA
paths split float32 into 3 bf16 terms (about float32-exact), the port
sums in plain float32 in another order.  K3 in float64 is held against
fbpic_tpu's ``_dense_deposit`` at 1e-12 (its Pallas kernel accumulates
in float32).

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
    from fbpic_tpu_torch.particles.cuda_gather import gather_corners_plain
    from fbpic_tpu_torch.particles.gather import gather_operands
    arrs, g, sort, fields, interp = _gather_inputs(zfold)
    xp, yp, zp = sort["padded"][:3]
    ops = gather_operands(xp, yp, zp, sort["valid"], interp,
                          np.float32(g["Nr"] * g["dr"]), 1 / g["dz"],
                          g["zmin"], g["Nz"], 1 / g["dr"], 0.0, g["Nr"],
                          zfold=zfold)
    out = gather_corners_plain(**ops)
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


def _k3_operands(window, zfold, dtype):
    """The operands of one K3 call exactly as deposit_rho_J_sorted builds
    them (sort half a push behind, rho one half push later): the J window
    (offsets -2..1, 3 components x 3 channels) or the rho window (-3..2,
    3 channels)."""
    from fbpic_tpu_torch.particles.sorted_deposit import (
        dense_contract_operands)
    arrs, g = _deposit_inputs(dtype=dtype)
    sort = _port_sort(arrs, g)
    x, y, z, w, ux, uy, uz, ig = sort["padded"]
    return dense_contract_operands(
        sort, x, y, z, w, dtype(-1.6e-19), ux, uy, uz, ig,
        dtype(0.25 * g["dz"] / c), g["Nm"], 1 / g["dz"], g["zmin"], g["Nz"],
        1 / g["dr"], 0.0, g["Nr"], torch.as_tensor(g["ruy"]), zfold=zfold,
        sort_at_start=True)[window]


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-6),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("zfold", ["clamp", "periodic"])
@pytest.mark.parametrize("window", ["J", "rho"])
def test_k3_plain_matches_dense_deposit_and_pallas(window, zfold, dtype,
                                                   tol):
    """The port's _dense_deposit (K3's plain version on the CPU) against
    fbpic_tpu's _dense_deposit (XLA one-hot GEMM) on the same operands,
    and in float32 with open z against the Pallas kernel run through
    _pallas_dense_deposit in interpreter mode (its reassembly has no
    periodic-seam wrap, so only the clamp fold is comparable)."""
    from fbpic_tpu.particles import pallas_deposit, sorted_deposit as s0
    from fbpic_tpu_torch.particles import sorted_deposit as s1
    from fbpic_tpu_torch.particles.cuda_dense import (
        dense_onehot_contract, dense_onehot_contract_plain)
    ops = _k3_operands(window, zfold, dtype)
    C = ops["channel_vals"].shape[2]
    n_off = ops["delta_hi"] + 2 - ops["delta_lo"]
    assert (n_off, C) == ((5, 9) if window == "J" else (7, 3))
    Nrb = ops["Nr"] + 4
    raw = dense_onehot_contract(ops["geom"], ops["channel_vals"],
                                ops["meta"], Nrb)
    assert tuple(raw.shape) == (ops["Nz"], Nrb, n_off * 2 * C)
    np.testing.assert_array_equal(
        raw.numpy(), dense_onehot_contract_plain(
            ops["geom"], ops["channel_vals"], ops["meta"], Nrb).numpy())
    out = s1._dense_deposit(**ops).numpy()
    jo = _to_jax(ops)
    refs = [s0._dense_deposit(**jo)]
    if dtype == np.float32 and zfold == "clamp":
        refs.append(pallas_deposit._pallas_dense_deposit(**jo,
                                                         interpret=True))
    for ref in refs:
        ref = np.asarray(ref)
        assert ref.shape == out.shape == (ops["Nz"], ops["Nr"], C)
        assert _rel(out, ref) <= tol


# --- what licenses the CUDA kernels' skipping of dead slots -------------

def _garbage_in_dead_slots(sort, rng):
    """The sorted layout twice: dead slots zeroed, and dead slots filled
    with finite garbage (far-off positions, non-zero weights)."""
    valid = sort["valid"]
    zeroed, garbage = [], []
    for a in sort["padded"]:
        junk = torch.as_tensor(
            (rng.randn(*a.shape) * 7.0 + 3.0).astype(a.numpy().dtype))
        zeroed.append(torch.where(valid, a, torch.zeros_like(a)))
        garbage.append(torch.where(valid, a, junk))
    return (dict(valid=valid, padded=zeroed),
            dict(valid=valid, padded=garbage))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", ["K1", "K3_J", "K3_rho"])
def test_plain_contractions_ignore_what_dead_slots_hold(kernel, dtype):
    """A slot with ok == 0 contributes exact zeros whatever it holds
    (every block of V carries a z weight that was multiplied by ok), so
    the plain versions give the same bits for zeroed and for garbage
    dead slots.  This is what lets the CUDA kernels stop at a column's
    last live slot and skip particles whose z weights are all zero."""
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused
    from fbpic_tpu_torch.particles.sorted_deposit import (
        dense_contract_operands, fused_contract_operands)
    arrs, g = _deposit_inputs(dtype=dtype)
    sort = _port_sort(arrs, g)
    assert int((~sort["valid"]).sum()) > 0
    outs = []
    for s in _garbage_in_dead_slots(sort, np.random.RandomState(5)):
        x, y, z, w, ux, uy, uz, ig = s["padded"]
        args = (s, x, y, z, w, dtype(-1.6e-19), ux, uy, uz, ig,
                dtype(0.25 * g["dz"] / c), g["Nm"], 1 / g["dz"], g["zmin"],
                g["Nz"], 1 / g["dr"], 0.0, g["Nr"],
                torch.as_tensor(g["ruy"]))
        if kernel == "K1":
            ops = fused_contract_operands(*args, zfold="clamp",
                                          sort_at_start=True)
            assert not ops["geom"]["ok"][~s["valid"]].any()
            outs.append(cuda_fused.fused_onehot_contract_plain(**ops))
        else:
            o = dense_contract_operands(
                *args, zfold="periodic",
                sort_at_start=True)[kernel.split("_")[1]]
            assert not o["geom"]["ok"][~s["valid"]].any()
            outs.append(cuda_dense.dense_onehot_contract_plain(
                o["geom"], o["channel_vals"], o["meta"], g["Nr"] + 4))
    assert bool(outs[0].isfinite().all()) and bool(outs[0].any())
    assert torch.equal(outs[0], outs[1])


def _is_prefix(valid):
    """Live slots first in every column."""
    return bool((valid[:, 1:] <= valid[:, :-1]).all())


def test_build_column_sort_keeps_live_slots_first():
    """The CUDA contractions stage a column up to its last live slot, so
    they are fastest when live slots are a prefix of every column."""
    arrs, g = _deposit_inputs()
    sort = _port_sort(arrs, g)
    assert _is_prefix(sort["valid"])
    counts = sort["valid"].sum(dim=1)
    assert int(counts.sum()) == int((arrs[3] != 0).sum())
    assert int(counts.min()) < int(counts.max()) < 512


@pytest.mark.parametrize("band", [1, 2])
@pytest.mark.parametrize("zfold", ["clamp", "periodic"])
def test_banded_resort_keeps_live_slots_first(zfold, band):
    from fbpic_tpu_torch.particles.sorted_deposit import banded_column_resort
    arrs, g = _deposit_inputs()
    sort = _port_sort(arrs, g)
    rng = np.random.RandomState(9)
    pad = [torch.where(sort["valid"], a, torch.zeros_like(a))
           for a in sort["padded"]]
    # every particle moves by less than `band` cells (wrapped or clamped
    # into the box), some leave their column, some stay
    Lz = g["Nz"] * g["dz"]
    dzp = torch.as_tensor(rng.uniform(-0.95 * band, 0.95 * band,
                                      tuple(pad[2].shape)) * g["dz"]
                          ).to(pad[2].dtype)
    z = pad[2] + dzp
    if zfold == "periodic":
        z = g["zmin"] + torch.remainder(z - g["zmin"], Lz)
    else:
        z = torch.clamp(z, g["zmin"] + 1e-3, g["zmin"] + Lz - 1e-3)
    pad[2] = torch.where(sort["valid"], z, torch.zeros_like(z))
    out = banded_column_resort(pad, g["zmin"], 1 / g["dz"], g["Nz"], 512,
                               band, zfold=zfold)
    assert int(out["n_over"]) == 0
    assert int(out["valid"].sum()) == int(sort["valid"].sum())
    assert _is_prefix(out["valid"])
    # and the kept slots are live particles, the others hold zeros
    assert bool((out["padded"][3][out["valid"]] != 0).all())
    assert not out["padded"][3][~out["valid"]].any()


# --- the Python the CUDA wrappers run before a launch --------------------

@pytest.mark.parametrize("esize", [4, 8])
@pytest.mark.parametrize("Nr,Nm", [(50, 2), (50, 1), (50, 3), (500, 2),
                                   (3000, 2)])
def test_row_tiling_fits_the_shared_memory_of_a_block(Nr, Nm, esize):
    """pick_row_tiling: the fewest tiles of radial rows whose block fits
    Hopper's 227 KB; the tiles cover every row; one tile at the paths'
    own sizes."""
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused
    from fbpic_tpu_torch.utils import kernels
    Nrb, CJ, CD = Nr + 4, 3 * (2 * Nm - 1), 2 * Nm - 1
    limit = kernels.SMEM_PER_BLOCK - kernels.SMEM_STATIC
    sizes = {
        "K1": lambda rt: cuda_fused.fused_smem_bytes(esize, CJ, 5, CD, 7,
                                                     Nr + 1, rt),
        "K3_J": lambda rt: cuda_dense.dense_smem_bytes(esize, CJ, 5, rt),
        "K3_rho": lambda rt: cuda_dense.dense_smem_bytes(esize, CD, 7, rt),
    }
    for name, smem_of in sizes.items():
        Rt, n_tiles = kernels.pick_row_tiling(Nrb, smem_of)
        assert smem_of(Rt) <= limit, name
        assert (n_tiles - 1) * Rt < Nrb <= n_tiles * Rt, name
        if n_tiles > 1:     # one tile fewer would not fit
            assert smem_of(-(-Nrb // (n_tiles - 1))) > limit, name
        if Nr == 50:
            assert n_tiles == 1, name
    if Nr >= 500 and esize == 8:
        assert kernels.pick_row_tiling(Nrb, sizes["K1"])[1] > 1
    with pytest.raises(ValueError):
        kernels.pick_row_tiling(Nrb, sizes["K1"], limit=1000)


def test_shared_memory_reckoning_at_the_lwfa_shape():
    """The staged tile and the accumulator at the bench LWFA shape (Nm =
    2, Nrb = 54, float32), by hand: K1 stages 39 float words, 2 int64
    and a bool per slot, 128 slots a tile, 2 tiles."""
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused
    from fbpic_tpu_torch.utils import kernels
    assert kernels.stage_bytes(4, 39, 2) == 128 * (39 * 4 + 16 + 1)
    assert cuda_fused.fused_smem_bytes(4, 9, 5, 3, 7, 51, 54) == (
        54 * 132 * 4 + kernels.align16(2 * 51 * 4) + 2 * 128 * 173)
    assert cuda_dense.dense_smem_bytes(4, 9, 5, 54) == (
        54 * 90 * 4 + 2 * 128 * (16 * 4 + 8 + 1))
    assert cuda_dense.dense_smem_bytes(8, 3, 7, 54) == (
        54 * 42 * 8 + 2 * 128 * (12 * 8 + 8 + 1))


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_operand_tables_name_what_the_kernels_read_in_place(kernel):
    """The wrappers' operand lists on the operands the deposit builds:
    every tensor already has the type, shape and contiguity the kernel
    reads (so the wrappers copy nothing), and check_operand refuses a
    strided view, another dtype and another shape."""
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused
    from fbpic_tpu_torch.utils import kernels
    cpu = torch.device("cpu")
    if kernel == "K1":
        ops = _k1_operands(True)
        fixed, zw = cuda_fused.fused_operands(
            ops["geom"], ops["channels"], ops["meta"], ops["span"],
            ops["dph"], ops["ph_b"], ops["wj"], ops["ruyten"])
        assert len(fixed) == 15 and len(zw) == 5 + 7 + 7
        assert ops["span"]["below"] is ops["geom"]["below_axis"]
        assert ops["span"]["ir_buf"] is ops["geom"]["ir_buf"]
    else:
        o = _k3_operands("J", "clamp", np.float32)
        fixed, zw = cuda_dense.dense_operands(o["geom"], o["channel_vals"],
                                              o["meta"])
        assert len(fixed) == 8 and len(zw) == 5
    for name, t, dt, shape in fixed + zw:
        kernels.check_operand(kernel, name, t, cpu, dt, shape)
    table = kernels.pointer_table([t for _, t, _, _ in fixed + zw])
    assert list(table) == [t.data_ptr() for _, t, _, _ in fixed + zw]
    name, t, dt, shape = fixed[0]
    with pytest.raises(ValueError, match="not contiguous"):
        kernels.check_operand(kernel, name,
                              t.transpose(0, 1).contiguous().transpose(0, 1),
                              cpu, dt, shape)
    with pytest.raises(TypeError):
        kernels.check_operand(kernel, name, t.double(), cpu, dt, shape)
    with pytest.raises(ValueError, match="shape"):
        kernels.check_operand(kernel, name, t[:, :-1], cpu, dt, shape)


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """An edited header must not load a stale library: the library's file
    name hashes every header of csrc/ beside the source."""
    from fbpic_tpu_torch.utils import kernels
    for f in kernels.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = {n: kernels._lib_path(n).name for n in kernels.SOURCES}
    with open(tmp_path / "contract_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: kernels._lib_path(n).name for n in kernels.SOURCES}
    assert all(before[n] != after[n] for n in kernels.SOURCES)
