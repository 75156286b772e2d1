"""fbpic_tpu_torch on the card: the CUDA kernels and a physics pin.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  This file imports no JAX, so it also runs on a machine that has
only PyTorch; there, skip the JAX-based conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- K1, K2 and K3 against their plain PyTorch versions on the same card
  (K1 and K3 1e-5, K2 5e-6 relative in float32: sums in another order;
  1e-12 in float64);
- K1 and K3 on layouts the random half-full one does not reach (full
  columns next to empty ones, one live particle, K not a multiple of the
  staging tile, Nm = 1 and 3, an Nr that needs several tiles of radial
  rows), two launches compared bit for bit, the wrappers' refusal of
  operands the kernels do not read in place, and the shared-memory
  reckoning of the wrappers against the kernels';
- K2 with and without Kahan words, both z folds, both field layouts it
  reads, on all-dead and full columns, one particle, K not a multiple
  of its threads, fewer columns than a block stages rows for, Nm = 1
  and 3, and an Nr whose rows do not fit (direct reads); one
  ``gather_fields_sorted`` call is one device launch;
- the golden-wake configuration for 100 steps on the card against the
  same run on the CPU (plain kernel versions), float32 and float64;
- the wavelength and amplitude invariants of tests/test_golden_wake.py
  after 450 steps on the card;
- the boosted-frame Galilean slice: 20 steps of the smoke-size
  examples/boosted_frame_script.py on the card against the CPU (float64,
  1e-8), a boosted step with the plain segmented sum made to raise (no
  CUDA deposit reaches it), and the numerical Cherenkov gate of
  tests/test_boosted.py;
- the non-resident (ring) path: the linear gather, the scatter deposits
  and write_ring on the card against the CPU; K1 / K3 on the plans that
  path builds (a fresh mid-step sort, the legacy idx plan) against their
  plain versions; 20 steps of the ring, grown-ring, empty-species,
  fresh-sort and legacy-plan runs on the card against the CPU, with
  exact launch counts;
- cubic shapes with the radial PML, and cross-deposition: 20 steps of
  each on the card against the CPU, with exact launch counts, and K3 on
  the cross-deposition plan against its plain version;
- the LPA utilities: a resident plasma beside a Gaussian bunch with its
  space-charge field (the bunch a ring: the grid-difference d(rho)), an
  antenna-emitted laser, and a window run with a mirror and an external
  field on the resident layout, each on the card against the CPU, with
  exact launch counts.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_wake.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _sorted_particles(dev, dtype, seed, Nz=48, Nr=16, Nm=2, K=512,
                     layout="half_full"):
    """Column-sorted particles from a numpy seed, a third near the axis.

    layout: "half_full" (uniform in z, half of the slots live),
    "full_and_empty" (every even column holds exactly K live particles,
    every odd column none) or "single" (one live particle)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.particles.sorted_deposit import build_column_sort
    dz, dr, zmin = 0.1, 0.2, -1.0
    sim = Simulation(Nz, zmin + Nz * dz, Nr, Nr * dr, Nm, 1e-12, zmin=zmin,
                     device=dev, dtype=dtype)
    rng = np.random.RandomState(seed)
    if layout == "full_and_empty":
        cols = np.repeat(np.arange(0, Nz, 2), K)
        Np = len(cols)
        z = zmin + (cols + rng.uniform(0.05, 0.95, Np)) * dz
    else:
        Np = 1 if layout == "single" else int(0.5 * K * Nz)
        z = zmin + rng.uniform(0.0, Nz * dz, Np)
    r = np.where(rng.rand(Np) < 0.35, rng.uniform(0, 1.5 * dr, Np),
                 rng.uniform(0, 0.99 * Nr * dr, Np))
    th = rng.uniform(0, 2 * np.pi, Np)
    w = rng.uniform(0.5, 1.5, Np)
    if layout == "half_full":
        w[rng.rand(Np) < 0.1] = 0.0
    ux, uy, uz = rng.randn(3, Np) * 0.5
    ig = 1 / np.sqrt(1 + ux ** 2 + uy ** 2 + uz ** 2)
    arrs = [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in (r * np.cos(th), r * np.sin(th), z, w, ux, uy, uz, ig)]
    sort = build_column_sort(arrs[2], arrs[3], zmin, 1 / dz, Nz, K, arrs)
    assert int(sort["n_over"]) == 0
    if layout == "full_and_empty":
        counts = sort["valid"].sum(dim=1)
        assert bool((counts[0::2] == K).all() and (counts[1::2] == 0).all())
    return sim, sort


def _k1_ops(sim, sort):
    from fbpic_tpu_torch.particles.sorted_deposit import (
        fused_contract_operands)
    cfg = sim.config
    x, y, z, w, ux, uy, uz, ig = sort["padded"]
    return fused_contract_operands(
        sort, x, y, z, w, -1.6e-19, ux, uy, uz, ig, 0.25 * cfg.dz / 3e8,
        cfg.Nm, 1 / cfg.dz, sim.zmin, cfg.Nz, 1 / cfg.dr, 0.0, cfg.Nr,
        sim.aux.ruyten_linear, zfold="clamp", sort_at_start=True)


def _k3_args(sim, sort, window, zfold="clamp"):
    from fbpic_tpu_torch.particles.sorted_deposit import (
        dense_contract_operands)
    cfg = sim.config
    x, y, z, w, ux, uy, uz, ig = sort["padded"]
    ops = dense_contract_operands(
        sort, x, y, z, w, -1.6e-19, ux, uy, uz, ig, 0.25 * cfg.dz / 3e8,
        cfg.Nm, 1 / cfg.dz, sim.zmin, cfg.Nz, 1 / cfg.dr, 0.0, cfg.Nr,
        sim.aux.ruyten_linear, zfold=zfold, sort_at_start=True,
        vz_shift=-0.995 * 3e8)[window]
    return (ops["geom"], ops["channel_vals"], ops["meta"], cfg.Nr + 4)


#: Layouts the random half-full one does not reach: keyword arguments of
#: _sorted_particles (K = 200 is no multiple of the kernels' 128-slot
#: staging tile; Nr = 500 needs several tiles of radial rows)
LAYOUTS = {
    "full_and_empty": dict(layout="full_and_empty", K=256),
    "single_particle": dict(layout="single"),
    "ragged_K": dict(K=200),
    "Nm1": dict(Nm=1),
    "Nm3": dict(Nm=3),
    "Nm4": dict(Nm=4),      # 2 * 21 J channels: more than a warp's lanes
    "tall_Nr": dict(Nz=8, Nr=500, K=128),
}


def _twice(fn):
    """The result of fn(), after checking that a second launch gives the
    same bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_k1_kernel_on_special_layouts(cuda, layout, dtype):
    from fbpic_tpu_torch.particles import cuda_fused
    from fbpic_tpu_torch.utils import kernels
    sim, sort = _sorted_particles(cuda, dtype, seed=7, **LAYOUTS[layout])
    ops = _k1_ops(sim, sort)
    out = _twice(lambda: cuda_fused.fused_onehot_contract(**ops))
    ref = cuda_fused.fused_onehot_contract_plain(**ops)
    W_J = ops["n_offJ"] * 2 * ops["channels"].shape[2]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert _rel(out[..., :W_J], ref[..., :W_J]) <= tol
    assert _rel(out[..., W_J:], ref[..., W_J:]) <= tol
    if layout == "full_and_empty":
        assert not out[1::2].any()
    if layout == "tall_Nr":
        esize = ops["channels"].element_size()
        _, n_tiles = kernels.pick_row_tiling(
            sim.config.Nr + 4, lambda rt: cuda_fused.fused_smem_bytes(
                esize, 9, ops["n_offJ"], 3, ops["n_offD"],
                sim.config.Nr + 1, rt))
        assert n_tiles > 1


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["J", "rho"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_k3_kernel_on_special_layouts(cuda, layout, dtype, window):
    from fbpic_tpu_torch.particles import cuda_dense
    from fbpic_tpu_torch.utils import kernels
    sim, sort = _sorted_particles(cuda, dtype, seed=11, **LAYOUTS[layout])
    args = _k3_args(sim, sort, window)
    out = _twice(lambda: cuda_dense.dense_onehot_contract(*args))
    ref = cuda_dense.dense_onehot_contract_plain(*args)
    assert _rel(out, ref) <= (1e-5 if dtype == torch.float32 else 1e-12)
    if layout == "full_and_empty":
        assert not out[1::2].any()
    if layout == "tall_Nr" and window == "J" and dtype == torch.float64:
        _, n_tiles = kernels.pick_row_tiling(
            sim.config.Nr + 4,
            lambda rt: cuda_dense.dense_smem_bytes(8, 9, 5, rt))
        assert n_tiles > 1


@pytest.mark.cuda
def test_wrappers_reckon_shared_memory_as_the_kernels_do(cuda):
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused, cuda_gather
    from fbpic_tpu_torch.utils import kernels
    fused, dense, gather = (kernels.library(n) for n in (
        "fused_deposit", "dense_deposit", "gather"))
    assert gather.gather_bz_max() == cuda_gather.BZ_MAX
    for esize in (4, 8):
        for Nm, Nr, bz in ((2, 50, 4), (1, 12, 1), (3, 500, 2), (4, 7, 0)):
            assert gather.gather_smem_bytes(esize, Nm, Nr, bz) == \
                cuda_gather.gather_smem_bytes(esize, Nm, Nr, bz)
    for esize in (4, 8):
        for Rt in (1, 54, 333):
            assert fused.fused_contract_smem_bytes(
                esize, 9, 5, 3, 7, 51, Rt) == cuda_fused.fused_smem_bytes(
                esize, 9, 5, 3, 7, 51, Rt)
            for C, n_off in ((9, 5), (3, 7), (1, 3)):
                assert dense.dense_contract_smem_bytes(
                    esize, C, n_off, Rt) == cuda_dense.dense_smem_bytes(
                    esize, C, n_off, Rt)


def _strided_copy(t):
    """The same values and shape, not contiguous."""
    return t.transpose(0, 1).contiguous().transpose(0, 1)


@pytest.mark.cuda
def test_contraction_wrappers_refuse_what_the_kernels_do_not_read(cuda):
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused
    sim, sort = _sorted_particles(cuda, torch.float32, seed=3)
    ops = _k1_ops(sim, sort)
    with pytest.raises(ValueError, match="not contiguous"):
        cuda_fused.fused_onehot_contract(
            **dict(ops, channels=_strided_copy(ops["channels"])))
    zw = list(ops["geom"]["zw"])
    zw[1] = _strided_copy(zw[1])
    with pytest.raises(ValueError, match="not contiguous"):
        cuda_fused.fused_onehot_contract(
            **dict(ops, geom=dict(ops["geom"], zw=zw)))
    with pytest.raises(TypeError):
        cuda_fused.fused_onehot_contract(
            **dict(ops, span=dict(ops["span"], bn=ops["span"]["bn"].int())))
    geom, chan, meta, Nrb = _k3_args(sim, sort, "J")
    with pytest.raises(ValueError, match="not contiguous"):
        cuda_dense.dense_onehot_contract(geom, _strided_copy(chan), meta, Nrb)
    with pytest.raises(TypeError):
        cuda_dense.dense_onehot_contract(
            dict(geom, below_axis=geom["below_axis"].float()), chan, meta,
            Nrb)
    with pytest.raises(ValueError):
        cuda_dense.dense_onehot_contract(
            dict(geom, ok=geom["ok"][:, :-1]), chan, meta, Nrb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_kernel_matches_plain(cuda, dtype):
    from fbpic_tpu_torch.particles import cuda_fused
    from fbpic_tpu_torch.particles.sorted_deposit import (
        fused_contract_operands)
    sim, sort = _sorted_particles(cuda, dtype, seed=23)
    cfg = sim.config
    x, y, z, w, ux, uy, uz, ig = sort["padded"]
    ops = fused_contract_operands(
        sort, x, y, z, w, -1.6e-19, ux, uy, uz, ig, 0.25 * cfg.dz / 3e8,
        cfg.Nm, 1 / cfg.dz, sim.zmin, cfg.Nz, 1 / cfg.dr, 0.0, cfg.Nr,
        sim.aux.ruyten_linear, zfold="clamp", sort_at_start=True)
    n0 = cuda_fused.fused_onehot_contract.launches
    out = cuda_fused.fused_onehot_contract(**ops)
    ref = cuda_fused.fused_onehot_contract_plain(**ops)
    assert cuda_fused.fused_onehot_contract.launches == n0 + 1
    W_J = ops["n_offJ"] * 2 * ops["channels"].shape[2]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert _rel(out[..., :W_J], ref[..., :W_J]) <= tol
    assert _rel(out[..., W_J:], ref[..., W_J:]) <= tol


def _k2_ops(sim, sort, zfold="clamp", comp=False, z_fast=False, seed=5,
            rmax_frac=1.0):
    """The keyword arguments of K2 on a sorted layout: interp fields from
    a numpy seed (r fastest, or z fastest as torch.fft leaves them), some
    live particles moved after the sort by up to 1.6 cells (so both
    clipped z offsets occur; periodic z wraps them into the box), the
    Kahan words, and rmax_gather = rmax_frac * rmax."""
    from fbpic_tpu_torch.fields.solver import InterpFields
    from fbpic_tpu_torch.particles.cuda_gather import FIELD_NAMES
    cfg = sim.config
    x, y, z = sort["padded"][:3]
    dev, dtype = x.device, x.dtype
    rng = np.random.RandomState(seed)

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    shape = (cfg.Nm, cfg.Nz, cfg.Nr)
    interp = InterpFields(**{
        n: torch.complex(tensor(rng.randn(*shape)), tensor(rng.randn(*shape)))
        for n in FIELD_NAMES})
    if z_fast:
        interp = InterpFields(**{
            n: getattr(interp, n).transpose(1, 2).contiguous().transpose(1, 2)
            for n in FIELD_NAMES})
    shift = rng.choice([0.0, 0.0, 0.7, 1.6, -0.7, -1.6], size=tuple(z.shape))
    z = torch.where(sort["valid"], z + tensor(shift * cfg.dz), z)
    if zfold == "periodic":
        z = sim.zmin + torch.remainder(z - sim.zmin, cfg.Nz * cfg.dz)
    ops = dict(xp=x, yp=y, zp=z.contiguous(), valid=sort["valid"],
               interp=interp, rmax_gather=rmax_frac * cfg.rmax,
               invdz=1 / cfg.dz, zmin=sim.zmin, Nz=cfg.Nz, invdr=1 / cfg.dr,
               rmin=0.0, Nr=cfg.Nr, zfold=zfold)
    if comp:
        ops["comp"] = tuple(tensor(rng.randn(*tuple(x.shape)) * 1e-3 * cfg.dz)
                            for _ in range(3))
    return ops


def _k2_check(ops, dtype):
    """K2 twice (bit-equal) against its plain version: 5e-6 of each
    output's largest value in float32 (corner and mode sums in another
    order than the one-hot GEMM), 1e-12 in float64; dead slots zero."""
    from fbpic_tpu_torch.particles import cuda_gather
    n0 = cuda_gather.gather_sorted.launches
    out = _twice(lambda: torch.stack(cuda_gather.gather_sorted(**ops)))
    assert cuda_gather.gather_sorted.launches == n0 + 2
    ref = torch.stack(cuda_gather.gather_sorted_plain(**ops))
    tol = 5e-6 if dtype == torch.float32 else 1e-12
    for a, b in zip(out, ref):
        assert bool(a.isfinite().all())
        assert _rel(a, b) <= tol
    assert not out[:, ~ops["valid"]].any()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("with_comp", [False, True])
@pytest.mark.parametrize("zfold", ["periodic", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_kernel_matches_plain(cuda, zfold, dtype, with_comp):
    sim, sort = _sorted_particles(cuda, dtype, seed=31)
    _k2_check(_k2_ops(sim, sort, zfold, comp=with_comp, rmax_frac=0.9),
              dtype)


#: K2 on layouts the random half-full one does not reach (K = 200 is no
#: multiple of the kernel's 256 threads; Nz = 3 is fewer columns than a
#: block stages rows for, so a staged row repeats; Nr = 500 takes 2
#: columns a block in float32 and the direct reads in float64)
K2_LAYOUTS = {
    "full_and_empty": dict(layout="full_and_empty", K=256),
    "single_particle": dict(layout="single"),
    "ragged_K": dict(K=200),
    "small_Nz": dict(Nz=3, K=1024),
    "Nm1": dict(Nm=1),
    "Nm3": dict(Nm=3),
    "tall_Nr": dict(Nz=8, Nr=500, K=128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("zfold", ["periodic", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", sorted(K2_LAYOUTS))
def test_k2_kernel_on_special_layouts(cuda, layout, dtype, zfold):
    from fbpic_tpu_torch.particles import cuda_gather
    sim, sort = _sorted_particles(cuda, dtype, seed=17, **K2_LAYOUTS[layout])
    ops = _k2_ops(sim, sort, zfold, comp=True, z_fast=zfold == "periodic")
    out = _k2_check(ops, dtype)
    if layout == "full_and_empty":
        assert not out[:, 1::2].any() and bool(out[:, 0::2].any())
    if layout == "tall_Nr":
        esize = ops["xp"].element_size()
        assert cuda_gather.pick_bz(esize, 2, 500) == (2 if esize == 4 else 0)


@pytest.mark.cuda
def test_gather_fields_sorted_is_one_kernel_launch(cuda):
    """On CUDA tensors the whole gather is K2: one device launch, no
    operand build, no copy."""
    from torch.profiler import ProfilerActivity, profile
    from fbpic_tpu_torch.particles.gather import gather_fields_sorted
    sim, sort = _sorted_particles(cuda, torch.float32, seed=3)
    ops = _k2_ops(sim, sort, "periodic", comp=True, z_fast=True)
    gather_fields_sorted(**ops)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gather_fields_sorted(**ops)
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and ev.self_device_time_total > 0]
    assert [ev.count for ev in evs] == [1]
    assert "gather_sorted_kernel" in evs[0].key


@pytest.mark.cuda
@pytest.mark.parametrize("window", ["J", "rho"])
@pytest.mark.parametrize("zfold", ["periodic", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_kernel_matches_plain(cuda, window, zfold, dtype):
    from fbpic_tpu_torch.particles import cuda_dense
    from fbpic_tpu_torch.particles.sorted_deposit import (
        dense_contract_operands)
    sim, sort = _sorted_particles(cuda, dtype, seed=29)
    cfg = sim.config
    x, y, z, w, ux, uy, uz, ig = sort["padded"]
    ops = dense_contract_operands(
        sort, x, y, z, w, -1.6e-19, ux, uy, uz, ig, 0.25 * cfg.dz / 3e8,
        cfg.Nm, 1 / cfg.dz, sim.zmin, cfg.Nz, 1 / cfg.dr, 0.0, cfg.Nr,
        sim.aux.ruyten_linear, zfold=zfold, sort_at_start=True,
        vz_shift=-0.995 * 3e8)[window]
    args = (ops["geom"], ops["channel_vals"], ops["meta"], cfg.Nr + 4)
    n0 = cuda_dense.dense_onehot_contract.launches
    out = cuda_dense.dense_onehot_contract(*args)
    ref = cuda_dense.dense_onehot_contract_plain(*args)
    assert cuda_dense.dense_onehot_contract.launches == n0 + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert _rel(out, ref) <= tol


@pytest.mark.cuda
def test_kernel_wrappers_check_their_operands(cuda):
    """K2 refuses what its kernel does not read in place: a strided
    position, a flag of another dtype, a field that is neither r- nor
    z-fastest, fields of two layouts, a field on another device."""
    import dataclasses
    from fbpic_tpu_torch.particles import cuda_gather
    sim, sort = _sorted_particles(cuda, torch.float32, seed=3)
    ops = _k2_ops(sim, sort, comp=True)
    interp = ops["interp"]
    bad = [dict(xp=_strided_copy(ops["xp"])),
           dict(comp=(ops["comp"][0], _strided_copy(ops["comp"][1]),
                      ops["comp"][2])),
           dict(interp=dataclasses.replace(
               interp, Ez=interp.Ez.transpose(0, 1).contiguous()
               .transpose(0, 1))),
           dict(interp=dataclasses.replace(
               interp, Bz=interp.Bz.transpose(1, 2).contiguous()
               .transpose(1, 2))),
           dict(interp=dataclasses.replace(interp, Br=interp.Br.cpu())),
           dict(zp=ops["zp"][:, :-1])]
    for b in bad:
        with pytest.raises(ValueError):
            cuda_gather.gather_sorted(**dict(ops, **b))
    with pytest.raises(TypeError):
        cuda_gather.gather_sorted(**dict(ops, valid=ops["valid"].float()))
    with pytest.raises(TypeError):
        cuda_gather.gather_sorted(**dict(ops, interp=dataclasses.replace(
            interp, Et=interp.Et.to(torch.complex128))))


def _wake_wavelength(Ez_axis, dz):
    """tests/test_golden_wake.py:93-109."""
    E = np.asarray(Ez_axis, np.float64)
    amp = np.abs(E).max()
    flips = np.flatnonzero(np.sign(E[:-1]) * np.sign(E[1:]) < 0)
    keep = [i for i in flips
            if np.abs(E[max(0, i - 40):i + 1]).max() > 0.25 * amp]
    if len(keep) < 3:
        return None
    keep = np.asarray(keep)
    zc = keep + E[keep] / (E[keep] - E[keep + 1])
    return float(2.0 * np.diff(zc).mean() * dz)


class _SeededAngles:
    """Column angles from a numpy seed per (iteration, species): the
    same draws whichever device the run is on."""

    def __call__(self, iteration, species_index, nkey):
        rs = np.random.RandomState(1000 * iteration + species_index)
        return torch.as_tensor(2 * np.pi * rs.random_sample(
            tuple(nkey.shape)))


def _golden_config_sim(device, dtype):
    """tests/test_golden_wake.py:68-90 (a0 = 1 laser, open z, moving
    window, continuous injection) with the resident layout forced."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    Nz, Nr, Nm = 400, 24, 2
    zmax, zmin, rmax = 30.e-6, -10.e-6, 20.e-6
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, (zmax - zmin) / Nz / c,
                     zmin=zmin, n_order=32,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, device=device, dtype=dtype)
    sim.use_fused_deposit = True         # force the resident layout
    sim.add_new_species(q=-e, m=m_e, n=4.e24, p_zmin=24.e-6, p_zmax=500.e-6,
                        p_rmin=0., p_rmax=14.e-6, p_nz=1, p_nr=1, p_nt=4,
                        sort_K=256)
    add_laser_pulse(sim, GaussianLaser(a0=1.0, waist=8.e-6, tau=10.e-15,
                                       z0=20.e-6))
    sim.set_moving_window(v=c)
    return sim


def _profiles(sim):
    return dict(
        Ez_axis=sim.get_interp_field("Ez", 0).real[:, 0],
        Er0_r5=sim.get_interp_field("Er", 0).real[:, 5],
        Er1_r5=np.abs(sim.get_interp_field("Er", 1))[:, 5],
        rho_axis=sim.get_interp_field("rho", 0).real[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_run_matches_cpu_run(cuda, dtype):
    """100 steps of the golden-wake configuration on the card (K2, and
    K1 in float32; in float64 the J and rho deposits go through
    K3<double>) and on the CPU (their plain versions), from the same
    plasma and the same injection angles.  float64: 1e-8 of each
    profile's scale (FFTs, GEMMs and sums in another order differ at
    ~1e-16 per operation; the PIC loop amplifies that over 100 steps).
    float32: the 100-step gates of tests/test_golden_wake.py:156-157
    (1.5e-2, 3e-2 for rho), as for the float32 port against fbpic_tpu."""
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused, cuda_gather
    n_k1 = cuda_fused.fused_onehot_contract.launches
    n_k2 = cuda_gather.gather_sorted.launches
    n_k3 = cuda_dense.dense_onehot_contract.launches
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        sim = _golden_config_sim(dev, dtype)
        sim.column_angles = _SeededAngles()
        sim.step(100)
        assert sim.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
        runs[dev.type] = _profiles(sim)
    assert cuda_gather.gather_sorted.launches - n_k2 == 100
    if dtype == torch.float32:
        assert cuda_fused.fused_onehot_contract.launches - n_k1 == 100
    else:
        assert cuda_dense.dense_onehot_contract.launches - n_k3 == 200
    gates = ({n: 1e-8 for n in runs["cpu"]} if dtype == torch.float64 else
             {"Ez_axis": 1.5e-2, "Er0_r5": 1.5e-2, "Er1_r5": 1.5e-2,
              "rho_axis": 3e-2})
    for name, gate in gates.items():
        card, ref = runs["cuda"][name], runs["cpu"][name]
        assert np.isfinite(card).all(), name
        err = np.abs(card - ref).max() / np.abs(ref).max()
        assert err < gate, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wake_invariants_on_card(cuda, dtype):
    """The invariants of tests/test_golden_wake.py after 450 steps on the
    card: the on-axis wake wavelength within 15% of 2 pi c / omega_p and
    within 2% of the golden run's, and the Ez amplitude within 10% of the
    golden run's.  The card draws its own injection angles (the golden
    profiles themselves need fbpic_tpu's angles: see
    tests/test_torch_golden.py); the macroscopic wake does not depend on
    them (on the CPU, another angle set gives 0.1-0.3% in wavelength and
    1-4% in amplitude)."""
    from fbpic_tpu_torch.constants import c, e, m_e
    sim = _golden_config_sim(cuda, dtype)
    sim.step(450)
    assert sim.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}
    gold = np.load(GOLDEN)
    Ez = _profiles(sim)["Ez_axis"]
    assert np.isfinite(Ez).all()
    lam = _wake_wavelength(Ez, sim.config.dz)
    wp = np.sqrt(4.e24 * e**2 / (m_e * 8.8541878128e-12))
    assert abs(lam / (2 * np.pi * c / wp) - 1) < 0.15
    assert abs(lam / float(gold["inv_wavelength"]) - 1) < 0.02
    amp = float(np.abs(Ez).max())
    assert 0.9 < amp / float(gold["inv_amplitude"]) < 1.1


def _boosted_smoke_sim(device, scheme="galilean"):
    """examples/boosted_frame_script.py:17-58 at its smoke size (:34-35),
    with the plasma from the box's left edge (-40 um lab), float64, the
    resident layout forced (sort_K)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.boosted_frame import BoostConverter
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    gamma = 10.
    boost = BoostConverter(gamma)
    Nz, Nr, Nm = 256, 12, 2
    zmin, zmax = boost.static_length([-40.e-6, 0.e-6])
    n_e, = boost.static_density([1.e24])
    v_window, = boost.velocity([c])
    sim = Simulation(Nz, zmax, Nr, 40.e-6, Nm, (zmax - zmin) / Nz / c,
                     zmin=zmin, n_order=16, gamma_boost=gamma,
                     v_comoving=-c * np.sqrt(1. - 1. / gamma**2),
                     use_galilean=(scheme == "galilean"),
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, device=device, dtype=torch.float64)
    sim.use_fused_deposit = True         # force the resident layout
    sim.add_new_species(q=-e, m=m_e, n=n_e, p_zmin=-40.e-6,
                        p_zmax=boost.static_length([2000.e-6])[0],
                        p_rmax=35.e-6, p_nz=1, p_nr=1, p_nt=4,
                        continuous_injection=True,
                        boost_positions_in_dens_func=True, sort_K=128)
    add_laser_pulse(sim, GaussianLaser(a0=2., waist=10.e-6, tau=30.e-15,
                                       z0=-15.e-6), gamma_boost=gamma)
    sim.set_moving_window(v=v_window)
    sim.column_angles = _SeededAngles()
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["galilean", "comoving"])
def test_boosted_card_run_matches_cpu_run(cuda, scheme):
    """20 boosted-frame steps on the card (K3 twice and K2 once a step,
    no K1) against the CPU (plain versions), float64, from the same
    plasma and injection angles: the on-axis Ez and rho and the mode-1
    Er at r = 5 dr within 1e-8 of their scale."""
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused, cuda_gather
    counters = (cuda_fused.fused_onehot_contract, cuda_gather.gather_sorted,
                cuda_dense.dense_onehot_contract)
    n0 = [fn.launches for fn in counters]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        sim = _boosted_smoke_sim(dev, scheme)
        sim.step(20)
        assert sim.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
        runs[dev.type] = _profiles(sim)
    assert [fn.launches - n for fn, n in zip(counters, n0)] == [0, 20, 40]
    for name in ("Ez_axis", "Er1_r5", "rho_axis"):
        card, ref = runs["cuda"][name], runs["cpu"][name]
        assert np.isfinite(card).all(), name
        err = np.abs(card - ref).max() / np.abs(ref).max()
        assert err < 1e-8, (name, err)


@pytest.mark.cuda
def test_boosted_cuda_step_never_reaches_the_plain_sum(cuda, monkeypatch):
    """On CUDA tensors the deposit launches K3 or raises: with the plain
    segmented sum (_contract) made to raise, a boosted step still runs."""
    from fbpic_tpu_torch.particles import sorted_deposit

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain segmented sum ran on the card")

    sim = _boosted_smoke_sim(cuda)
    monkeypatch.setattr(sorted_deposit, "_contract", no_plain)
    sim.step(2)
    assert np.isfinite(sim.get_interp_field("Ez")).all()
    # ... while the same step on the CPU does reach it
    with pytest.raises(AssertionError, match="plain segmented sum"):
        _boosted_smoke_sim(torch.device("cpu")).step(1)


def _nci_slope(device, dtype, scheme):
    """tests/test_boosted.py::_growth_slope with the port: a gamma = 130
    plasma and its ions (two species drifting at uz_m) flowing through a
    periodic box, 570 + 30 steps, resident layout forced."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, m_p
    Nz, zmax, zmin, Nr, rmax, Nm = 40, 7.86, -7.86, 20, 7.86, 2
    gamma = 130.
    uz_m = np.sqrt(gamma**2 - 1)
    n_e = gamma / (4 * 3.14 * 2.81e-15)
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, (zmax - zmin) / Nz / c,
                     zmin=zmin,
                     v_comoving=None if scheme == "standard" else 0.9999 * c,
                     use_galilean=(scheme == "galilean"), random_seed=0,
                     device=device, dtype=dtype)
    for q, m in ((-e, m_e), (e, m_p)):
        sim.add_new_species(q=q, m=m, n=n_e, p_zmin=zmin, p_zmax=zmax,
                            p_rmin=0., p_rmax=rmax, p_nz=2, p_nr=2, p_nt=4,
                            uz_m=uz_m, sort_K=512)

    def er_rms():
        Er0, Er1 = (sim.get_interp_field("Er", m) for m in (0, 1))
        return float(np.sqrt(np.average(np.abs(Er0)**2 + np.abs(Er1)**2)))

    sim.step(570)
    rms_a = er_rms()
    sim.step(30)
    assert sim.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}
    return np.log(er_rms()) - np.log(rms_a)


@pytest.mark.cuda
def test_galilean_suppresses_cherenkov_on_card(cuda):
    """tests/test_boosted.py::test_cherenkov_instability on the card, in
    float64 as that test runs: the standard scheme's Er grows more than
    3.5x faster than the Galilean scheme's (the J and rho deposits of
    the Galilean run go through K3<double>)."""
    slope_std = _nci_slope(cuda, torch.float64, "standard")
    slope_gal = _nci_slope(cuda, torch.float64, "galilean")
    assert slope_std > 3.5 * slope_gal, (slope_std, slope_gal)


# ---------------------------------------------------------------------
# The non-resident (ring) species path on the card
# ---------------------------------------------------------------------

def _random_particles(dev, dtype, seed, Np=20000, Nz=48, Nr=16, dz=0.1,
                      dr=0.2, zmin=-1.0):
    """x, y, z, w, ux, uy, uz, inv_gamma from a numpy seed (a third near
    or below the axis, some past the last radial cell, z a cell beyond
    both box ends, a tenth dead)."""
    rng = np.random.RandomState(seed)
    z = zmin + rng.uniform(-1.0, Nz + 1.0, Np) * dz
    r = np.where(rng.rand(Np) < 0.35, rng.uniform(0, 1.5 * dr, Np),
                 rng.uniform(0, 1.05 * Nr * dr, Np))
    th = rng.uniform(0, 2 * np.pi, Np)
    w = rng.uniform(0.5, 1.5, Np)
    w[rng.rand(Np) < 0.1] = 0.0
    ux, uy, uz = rng.randn(3, Np) * 0.5
    ig = 1 / np.sqrt(1 + ux ** 2 + uy ** 2 + uz ** 2)
    return [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in (r * np.cos(th), r * np.sin(th), z, w, ux, uy, uz, ig)]


def _random_interp(dev, dtype, seed, Nm=2, Nz=48, Nr=16):
    from fbpic_tpu_torch.fields.solver import InterpFields
    from fbpic_tpu_torch.particles.cuda_gather import FIELD_NAMES
    rng = np.random.RandomState(seed)
    return InterpFields(**{n: torch.complex(
        torch.as_tensor(rng.randn(Nm, Nz, Nr), dtype=dtype, device=dev),
        torch.as_tensor(rng.randn(Nm, Nz, Nr), dtype=dtype, device=dev))
        for n in FIELD_NAMES})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6),
                                       (torch.float64, 1e-12)])
def test_linear_gather_on_card_matches_cpu(cuda, dtype, tol):
    """gather_fields_linear on CUDA tensors against the same call on the
    CPU, each output against its vector pair's largest value (as K2's
    checks), with and without Kahan words."""
    from fbpic_tpu_torch.particles.gather import gather_fields_linear
    geo = (1 / 0.1, -1.0, 48, 1 / 0.2, 0.0, 16)
    words = np.random.RandomState(3).randn(3, 20000) * 1e-4
    for with_comp in (False, True):
        outs = []
        for dev in (cuda, torch.device("cpu")):
            x, y, z = _random_particles(dev, dtype, 11)[:3]
            comp = (tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                          for a in words) if with_comp else None)
            outs.append([t.cpu() for t in gather_fields_linear(
                x, y, z, _random_interp(dev, dtype, 12), 3.1, *geo,
                comp=comp)])
        for group in ((0, 1), (2,), (3, 4), (5,)):
            scale = max(float(outs[1][q].abs().max()) for q in group)
            for q in group:
                err = float((outs[0][q] - outs[1][q]).abs().max()) / scale
                assert err < tol, (with_comp, q, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_scatter_deposits_on_card_match_cpu(cuda, dtype, tol):
    """deposit_rho_linear and deposit_J_linear (index_add_, summed in no
    fixed order on the card) against the CPU, both z folds."""
    from fbpic_tpu_torch.fields.solver import GridConfig, build_field_aux
    from fbpic_tpu_torch.particles.deposit import (
        deposit_J_linear, deposit_rho_linear)
    cfg = GridConfig(Nz=48, Nr=16, Nm=2, dz=0.1, dr=0.2, rmax=3.2, dt=1e-12)
    for zfold in ("periodic", "clamp"):
        outs = []
        for dev in (cuda, torch.device("cpu")):
            ruyten = build_field_aux(cfg, device=dev,
                                     dtype=dtype).ruyten_linear
            x, y, z, w, ux, uy, uz, ig = _random_particles(dev, dtype, 21)
            geo = (2, 1 / 0.1, -1.0, 48, 1 / 0.2, 0.0, 16, ruyten)
            outs.append([t.cpu() for t in (
                deposit_rho_linear(x, y, z, w, -1.0, *geo, zfold=zfold),
                *deposit_J_linear(x, y, z, w, -1.0, ux, uy, uz, ig, *geo,
                                  zfold=zfold))])
        for a, b in zip(*outs):
            assert _rel(a, b) < tol, zfold


@pytest.mark.cuda
def test_write_ring_on_card_matches_cpu(cuda):
    """write_ring on the card: the same slots as on the CPU, bit for bit,
    for a write that wraps past the ring's end, a masked one and one
    longer than the ring."""
    from fbpic_tpu_torch.particles.injection import write_ring
    rng = np.random.RandomState(5)
    cap = 1000
    arr = rng.randn(cap)
    for start, n, masked in ((990, 37, False), (400, 300, True),
                             (7, 2500, True)):
        vals, mask = rng.randn(n), rng.rand(n) < 0.6
        outs = [write_ring(torch.as_tensor(arr, device=dev), start,
                           torch.as_tensor(vals, device=dev), cap,
                           torch.as_tensor(mask, device=dev) if masked
                           else None).cpu()
                for dev in (cuda, torch.device("cpu"))]
        assert torch.equal(*outs)


def _captured_contractions(module, name, fn):
    """The (args, kwargs) of every call of module.<name> while fn()
    runs."""
    real, calls = getattr(module, name), []

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, recorder)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["fresh_f32", "fresh_f64", "legacy_f32",
                                  "legacy_f64"])
def test_contractions_on_mid_step_plans(cuda, plan):
    """K1 / K3 on the plans the non-resident path builds: a fresh sort at
    the mid positions (sort_at_start=False; float32: K1 once, float64:
    K3 for J and for rho) and the legacy idx plan (deposit_J_sorted and
    deposit_rho_sorted: K3 once each), each launch held against its
    plain version on its own operands, with exact launch counts."""
    from fbpic_tpu_torch.fields.solver import GridConfig, build_field_aux
    from fbpic_tpu_torch.particles import (
        cuda_dense, cuda_fused, sorted_deposit)
    kind, tname = plan.split("_")
    dtype = torch.float32 if tname == "f32" else torch.float64
    # K above a column's ~420 particles plus the ~400 beyond each box
    # end that the sort clamps into the edge columns
    Nz, Nr, K = 48, 16, 1024
    cfg = GridConfig(Nz=Nz, Nr=Nr, Nm=2, dz=0.1, dr=0.2, rmax=3.2,
                     dt=0.1 / 3e8)
    ruyten = build_field_aux(cfg, device=cuda, dtype=dtype).ruyten_linear
    x, y, z, w, ux, uy, uz, ig = _random_particles(cuda, dtype, 31)
    geo = (2, 1 / 0.1, -1.0, Nz, 1 / 0.2, 0.0, Nr, ruyten)
    payload = [x, y, z, w, ux, uy, uz, ig] if kind == "fresh" else None
    sort = sorted_deposit.build_column_sort(z, w, -1.0, 1 / 0.1, Nz, K,
                                            payload)
    assert int(sort["n_over"]) == 0 and ("idx" in sort) == (kind == "legacy")
    if kind == "fresh":
        with_drho = dtype == torch.float32
        name, want = (("fused_onehot_contract", 1) if with_drho
                      else ("dense_onehot_contract", 2))
        calls = _captured_contractions(
            sorted_deposit, name, lambda: sorted_deposit.deposit_rho_J_sorted(
                sort, x, y, z, w, -1.0, ux, uy, uz, ig, 0.5 * cfg.dt,
                *geo[:-1], ruyten, zfold="clamp", with_drho=with_drho,
                with_rho=not with_drho))
    else:
        name, want = "dense_onehot_contract", 2

        def legacy():
            sorted_deposit.deposit_J_sorted(sort, x, y, z, w, -1.0, ux, uy,
                                            uz, ig, *geo)
            sorted_deposit.deposit_rho_sorted(sort, x, y, z, w, -1.0, *geo)
        calls = _captured_contractions(sorted_deposit, name, legacy)
    assert len(calls) == want
    kern = getattr(cuda_fused if name.startswith("fused") else cuda_dense,
                   name)
    plain = getattr(cuda_fused if name.startswith("fused") else cuda_dense,
                    name + "_plain")
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for args, kwargs in calls:
        n0 = kern.launches
        out = kern(*args, **kwargs)
        assert kern.launches == n0 + 1
        assert _rel(out, plain(*args, **kwargs)) < tol


def _ring_window_sim(device, case, dtype=torch.float64):
    """The window configuration of tests/test_torch_ring.py (open z,
    moving window, continuous injection, a0 = 0.5 laser) on the
    non-resident paths.  case: "scatter" (sort_K = 0, plus an empty
    species of 256 dead slots and one with none), "grown" (scatter, the
    ring doubled by _ensure_capacity before the first step),
    "fresh_sort" (the fused deposit on a fresh sort: capacity above
    Nz * sort_K) or "legacy" (the fused deposit off, sort_K > 0: the idx
    plan)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    sim = Simulation(130, 12.e-6, 16, 10.e-6, 2, 16.e-6 / 130 / c,
                     zmin=-4.e-6, n_order=16,
                     boundaries={"z": "open", "r": "reflective"},
                     exchange_period=4, random_seed=0, device=device,
                     dtype=dtype)
    sim.use_fused_deposit = case != "legacy"
    plasma = dict(q=-e, m=m_e, n=5.e24, p_zmin=2.e-6, p_zmax=100.e-6,
                  p_rmin=0., p_rmax=9.e-6, p_nz=1, p_nr=2, p_nt=4)
    if case in ("scatter", "grown"):
        sim.add_new_species(**plasma, sort_K=0)
        sim.add_new_species(q=-e, m=m_e)
        sim.add_new_species(q=-e, m=m_e, capacity=0)
    else:
        sim.add_new_species(**plasma, sort_K=256,
                            capacity=200_000 if case == "fresh_sort"
                            else None)
    assert not any(sc.resident for sc in sim.species_configs)
    if case == "grown":
        cap = sim.state.species[0].capacity
        assert sim._ensure_capacity(0, 0, factor=2.0) >= 2 * cap
    add_laser_pulse(sim, GaussianLaser(a0=0.5, waist=4.e-6, tau=8.e-15,
                                       z0=6.e-6))
    sim.set_moving_window(v=c)
    sim.column_angles = _SeededAngles()
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    ("scatter", torch.float64), ("grown", torch.float64),
    ("fresh_sort", torch.float64), ("fresh_sort", torch.float32),
    ("legacy", torch.float64)])
def test_ring_paths_on_card_match_cpu(cuda, case, dtype):
    """20 steps of the non-resident paths on the card against the same
    run on the CPU (plain kernel versions), from the same plasma and
    injection angles: no K2 launch (nothing is resident), K3 twice a
    step (float64 fresh sort; legacy plan), K1 once a step (float32
    fresh sort), none on the scatter path; the on-axis Ez and rho and
    the mode-1 Er at r = 5 dr within 1e-8 of their scale in float64
    (the 100-step float32 gates of tests/test_golden_wake.py in
    float32), the live slots alike, zero overflow."""
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused, cuda_gather
    counters = (cuda_fused.fused_onehot_contract, cuda_gather.gather_sorted,
                cuda_dense.dense_onehot_contract)
    n0 = [fn.launches for fn in counters]
    runs, live = {}, {}
    for dev in (cuda, torch.device("cpu")):
        sim = _ring_window_sim(dev, case, dtype)
        sim.step(20)
        assert sim.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
        runs[dev.type] = _profiles(sim)
        live[dev.type] = [(sp.w != 0).cpu() for sp in sim.state.species]
    want = {"scatter": [0, 0, 0], "grown": [0, 0, 0], "legacy": [0, 0, 40],
            "fresh_sort": [20, 0, 0] if dtype == torch.float32
            else [0, 0, 40]}[case]
    assert [fn.launches - n for fn, n in zip(counters, n0)] == want
    assert all(torch.equal(a, b) for a, b in zip(live["cuda"], live["cpu"]))
    gates = ({"Ez_axis": 1e-8, "Er1_r5": 1e-8, "rho_axis": 1e-8}
             if dtype == torch.float64 else
             {"Ez_axis": 1.5e-2, "Er1_r5": 1.5e-2, "rho_axis": 3e-2})
    for name, gate in gates.items():
        card, ref = runs["cuda"][name], runs["cpu"][name]
        assert np.isfinite(card).all(), name
        err = np.abs(card - ref).max() / np.abs(ref).max()
        assert err < gate, (name, err)


# ---------------------------------------------------------------------
# Diagnostics, checkpoints and tracking on the card
# ---------------------------------------------------------------------

def _diag_config_sim(device, wdir):
    """tests/test_diagnostics.py's configuration (Nz = 64, Nr = 16,
    Nm = 2, a periodic uniform electron cylinder), float64, the resident
    layout forced (sort_K), tracked, with ``_attach_diags``'s
    diagnostics."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    Nz, Nr, Nm, zmax, rmax = 64, 16, 2, 6.4e-6, 8.e-6
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, zmax / Nz / c, random_seed=0,
                     device=device, dtype=torch.float64)
    sim.use_fused_deposit = True
    view = sim.add_new_species(q=-e, m=m_e, n=1.e24, p_zmin=0.,
                               p_zmax=zmax, p_rmin=0., p_rmax=6.e-6,
                               p_nz=1, p_nr=1, p_nt=4, sort_K=128)
    view.track()
    _attach_diags(sim, wdir)
    return sim


def _attach_diags(sim, wdir):
    """New field, particle (a select, E, B, gamma, id), charge-density
    and back-transformed particle diagnostics on sim's species."""
    from fbpic_tpu_torch import diagnostics as d
    view = sim.ptcl[0]
    sim.diags = [
        d.FieldDiagnostic(4, sim, write_dir=wdir),
        d.ParticleDiagnostic(
            4, species={"electrons": view}, select={"x": [0.0, None]},
            particle_data=("position", "momentum", "weighting", "E", "B",
                           "gamma", "id"), write_dir=wdir, sim=sim),
        d.ParticleChargeDensityDiagnostic(4, sim,
                                          species={"electrons": view},
                                          write_dir=wdir),
        d.BackTransformedParticleDiagnostic(
            0., sim.zmax, 0., 3 * sim.dt, 2, 5.0, sim=sim,
            species={"electrons": view}, write_dir=wdir)]


def _collect_all(sim):
    """Every diagnostic collected at sim's state; the back-transformed
    particle diagnostic first catches the particles that crossed its
    planes in the last step."""
    files = {}
    for diag in sim.diags:
        if hasattr(diag, "collect_snapshot"):
            diag._t_last = sim.time - sim.dt
            diag.write(sim)
            for i, snap in enumerate(diag.snapshots):
                files.update(diag.collect_snapshot(i, snap))
        else:
            files.update({f"{type(diag).__name__}/{k}": v
                          for k, v in diag.collect(sim).items()})
    return files


@pytest.mark.cuda
def test_diagnostics_collect_on_card_matches_cpu(cuda, monkeypatch,
                                                tmp_path):
    """tests/test_diagnostics.py's configuration stepped 8 steps on the
    CPU with its diagnostics (their writes replaced by a no-op: h5py
    need not be installed beside the card), its state carried to the
    card, and every
    diagnostic collected from that state on both devices: the same
    records, ids and counts exactly, float data to 1e-12 of each
    record's largest value (FFTs, GEMMs and sums in another order).
    Stepped apart, the runs' fields differ at O(1): at rest and with no
    initial field, this configuration's fields are the roundoff of
    rho_next - rho_prev over dt, summed in another order on each
    device."""
    import warnings
    from fbpic_tpu_torch.diagnostics.checkpoint_restart import (
        checkpoint_dict, load_checkpoint_dict)
    from fbpic_tpu_torch.diagnostics.generic import (OpenPMDDiagnostic,
                                                     records_difference)
    monkeypatch.setattr(OpenPMDDiagnostic, "write_records",
                        lambda self, files: None)
    cpu = _diag_config_sim(torch.device("cpu"), str(tmp_path))
    cpu.step(8)
    card = _diag_config_sim(cuda, str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # generator
        load_checkpoint_dict(card, checkpoint_dict(cpu))
    _attach_diags(cpu, str(tmp_path))
    ref, out = _collect_all(cpu), _collect_all(card)
    errs = records_difference(ref, out)
    n_btd = sum(1 for k in ref if k.startswith("particles"))
    n_ids = sum(rec[p][0].shape[0] for rec in ref.values() for p in rec
                if p.endswith("/id"))
    assert n_btd == 2 and len(errs) > 30 and n_ids > 0
    assert max(errs.values()) < 1e-12, max(errs.items(),
                                           key=lambda kv: kv[1])


@pytest.mark.cuda
def test_boosted_field_capture_on_card_matches_cpu(cuda, tmp_path):
    """The back-transformed field slices of one state (the CPU run's,
    carried to the card through a checkpoint dict) on both devices: 1e-12
    of each field's largest value over the grid, validity exactly."""
    from fbpic_tpu_torch.diagnostics import BackTransformedFieldDiagnostic
    from fbpic_tpu_torch.diagnostics.checkpoint_restart import (
        checkpoint_dict, load_checkpoint_dict)
    from fbpic_tpu_torch.constants import c
    sims = {"cuda": _boosted_smoke_sim(cuda),
            "cpu": _boosted_smoke_sim(torch.device("cpu"))}
    sims["cpu"].step(40)
    with pytest.warns(RuntimeWarning, match="generator"):
        load_checkpoint_dict(sims["cuda"], checkpoint_dict(sims["cpu"]))
    out = {}
    for name, sim in sims.items():
        btd = BackTransformedFieldDiagnostic(
            -40.e-6, 0., c, 50.e-15, 20, 10., sim=sim,
            write_dir=str(tmp_path))
        out[name] = [t.cpu() for t in btd.capture_slices(sim)]
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert int(out["cpu"][0].sum()) > 0
    for f, name in enumerate(btd.names):
        scale = np.abs(sims["cpu"].get_interp_field(name)).max()
        err = float((out["cuda"][2][f] - out["cpu"][2][f]).abs().max())
        assert err <= 1e-12 * scale, (name, err, scale)


@pytest.mark.cuda
def test_boosted_field_capture_needs_no_host_sync(cuda, tmp_path):
    """The per-step capture of the back-transformed fields queues device
    work only: torch's sync debug mode set to raise, ten captures."""
    from fbpic_tpu_torch.diagnostics import BackTransformedFieldDiagnostic
    from fbpic_tpu_torch.constants import c
    sim = _boosted_smoke_sim(cuda)
    sim.step(5)
    btd = BackTransformedFieldDiagnostic(
        -40.e-6, 0., c, 50.e-15, 20, 10., sim=sim, write_dir=str(tmp_path))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(10):
            btd.capture(sim, capacity=20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert btd._n == 10


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card_is_bit_exact(cuda, tmp_path):
    """A tracked float32 run on the card saved (torch.save) and loaded
    into a fresh simulation: every tensor and host value equal."""
    from fbpic_tpu_torch.diagnostics.checkpoint_restart import (
        checkpoint_dict, write_checkpoint, read_checkpoint,
        load_checkpoint_dict)
    sim = _golden_config_sim(cuda, torch.float32)
    sim.ptcl[0].track()
    sim.column_angles = _SeededAngles()
    sim.step(20)
    path = str(tmp_path / "checkpoint.pt")
    write_checkpoint(sim, path)
    again = _golden_config_sim(cuda, torch.float32)
    load_checkpoint_dict(again, read_checkpoint(path, cuda))
    a, b = checkpoint_dict(sim), checkpoint_dict(again)
    assert a["host"] == b["host"] and sorted(a["tensors"]) == sorted(
        b["tensors"])
    for key, t in a["tensors"].items():
        assert t.device == b["tensors"][key].device
        assert torch.equal(t, b["tensors"][key]), key


@pytest.mark.cuda
def test_tracking_keeps_k1_k2_launch_counts(cuda):
    """The golden-wake configuration in float32 on the card, tracked: K1
    and K2 still launch exactly once a step, and the ids of the live
    particles stay unique and non-zero."""
    from fbpic_tpu_torch.particles import cuda_fused, cuda_gather
    sim = _golden_config_sim(cuda, torch.float32)
    sim.ptcl[0].track()
    sim.column_angles = _SeededAngles()
    n0 = [cuda_fused.fused_onehot_contract.launches,
          cuda_gather.gather_sorted.launches]
    sim.step(30)
    assert [cuda_fused.fused_onehot_contract.launches - n0[0],
            cuda_gather.gather_sorted.launches - n0[1]] == [30, 30]
    sp = sim.state.species[0]
    ids = sp.ids[sp.w != 0]
    assert int((ids == 0).sum()) == 0
    assert torch.unique(ids).numel() == ids.numel()


# ---------------------------------------------------------------------
# Cubic shapes, the radial PML and cross-deposition on the card
# ---------------------------------------------------------------------

def _window_variant_sim(device, dtype, variant):
    """tests/test_torch_ring.py's window configuration, with the species
    sorted (use_fused_deposit, sort_K = 256) on every device alike:
    "cubic_pml" (cubic shapes, r 'open' with 8 PML cells on Nr = 24: a
    non-resident species, the fused cubic sorted deposit and the cubic
    gather, PyTorch only) or "cross" (cross-deposition: sized resident,
    run on the legacy sorted plan, K3 for J and rho_next)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    kw = dict(zmin=-4.e-6, n_order=16, exchange_period=4, random_seed=0,
              device=device, dtype=dtype)
    if variant == "cubic_pml":
        kw.update(particle_shape="cubic", n_damp={"z": 64, "r": 8},
                  boundaries={"z": "open", "r": "open"})
        Nr = 24
    else:
        kw.update(current_correction="cross-deposition",
                  boundaries={"z": "open", "r": "reflective"})
        Nr = 16
    sim = Simulation(130, 12.e-6, Nr, 10.e-6 * Nr / 16, 2,
                     16.e-6 / 130 / c, **kw)
    sim.use_fused_deposit = True
    sim.add_new_species(q=-e, m=m_e, n=5.e24, p_zmin=2.e-6, p_zmax=100.e-6,
                        p_rmin=0., p_rmax=9.e-6, p_nz=1, p_nr=2, p_nt=4,
                        sort_K=256)
    assert sim.species_configs[0].resident == (variant == "cross")
    add_laser_pulse(sim, GaussianLaser(a0=0.5, waist=4.e-6, tau=8.e-15,
                                       z0=6.e-6))
    sim.set_moving_window(v=c)
    sim.column_angles = _SeededAngles()
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["cubic_pml", "cross"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_new_paths_on_card_match_cpu(cuda, variant, dtype):
    """20 steps of the cubic + PML and the cross-deposition window runs on
    the card against the same runs on the CPU: no K1 / K2 launch, K3
    twice a step on the cross path (J and rho_next on the legacy plan;
    cross-deposition's two charge deposits are scatter deposits) and
    never on the cubic one; the on-axis Ez and rho and the mode-1 Er at
    r = 5 dr within 1e-8 of their scale in float64 (index_add_ and the
    FFTs sum in another order on the card), within the float32 gates of
    test_ring_paths_on_card_match_cpu in float32; the live slots alike,
    zero overflow; the PML split fields finite and non-zero."""
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused, cuda_gather
    counters = (cuda_fused.fused_onehot_contract, cuda_gather.gather_sorted,
                cuda_dense.dense_onehot_contract)
    runs, live = {}, {}
    for dev in (cuda, torch.device("cpu")):
        sim = _window_variant_sim(dev, dtype, variant)
        n0 = [fn.launches for fn in counters]
        sim.step(20)
        if dev.type == "cuda":
            assert [fn.launches - n for fn, n in zip(counters, n0)] == (
                [0, 0, 40] if variant == "cross" else [0, 0, 0])
        assert sim.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
        if variant == "cubic_pml":
            Et_pml = sim.state.interp.Et_pml
            assert bool(Et_pml.isfinite().all())
            assert float(Et_pml.abs().max()) > 0
        runs[dev.type] = _profiles(sim)
        live[dev.type] = (sim.state.species[0].w != 0).cpu()
    assert torch.equal(live["cuda"], live["cpu"])
    gates = ({"Ez_axis": 1e-8, "Er1_r5": 1e-8, "rho_axis": 1e-8}
             if dtype == torch.float64 else
             {"Ez_axis": 1.5e-2, "Er1_r5": 1.5e-2, "rho_axis": 3e-2})
    for name, gate in gates.items():
        card, ref = runs["cuda"][name], runs["cpu"][name]
        assert np.isfinite(card).all(), name
        err = np.abs(card - ref).max() / np.abs(ref).max()
        assert err < gate, (name, err)


@pytest.mark.cuda
def test_k3_on_the_cross_deposition_plan(cuda):
    """One cross-deposition step on the card: its two K3 calls (J and
    rho_next on the legacy plan) against their plain version, float32
    (1e-5) and float64 (1e-12)."""
    from fbpic_tpu_torch.particles import cuda_dense, sorted_deposit
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        sim = _window_variant_sim(cuda, dtype, "cross")
        sim.step(2)
        calls = _captured_contractions(sorted_deposit,
                                       "dense_onehot_contract",
                                       lambda: sim.step(1))
        assert len(calls) == 2
        for args, kwargs in calls:
            out = cuda_dense.dense_onehot_contract(*args, **kwargs)
            plain = cuda_dense.dense_onehot_contract_plain(*args, **kwargs)
            assert _rel(out, plain) <= tol


# ---------------------------------------------------------------------
# The LPA utilities on the card: bunches, antennas, mirrors, external
# fields
# ---------------------------------------------------------------------

def _k_counts():
    from fbpic_tpu_torch.particles import cuda_dense, cuda_fused, cuda_gather
    return [cuda_fused.fused_onehot_contract.launches,
            cuda_gather.gather_sorted.launches,
            cuda_dense.dense_onehot_contract.launches]


def _close_profiles(runs, gates):
    for name, gate in gates.items():
        card, ref = runs["cuda"][name], runs["cpu"][name]
        assert np.isfinite(card).all(), name
        err = np.abs(card - ref).max() / np.abs(ref).max()
        assert err < gate, (name, err)


@pytest.mark.cuda
def test_plasma_and_bunch_on_card_match_cpu(cuda):
    """A resident plasma beside a Gaussian bunch with its space-charge
    field, float32, periodic z, 20 steps on the card and on the CPU:
    K1 and K2 once a step (the plasma), the bunch a ring with sort_K = 0
    (linear gather, scatter J, the d(rho) of two scatter deposits);
    the space-charge fields after init within 1e-5 of their scale (the
    host solve is float64, the deposit float32), the profiles within
    tests/test_golden_wake.py's 100-step float32 gates, the bunch's
    live count kept."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.bunch import add_particle_bunch_gaussian
    runs, init = {}, {}
    for key, dev in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        sim = Simulation(160, 16.e-6, 16, 12.e-6, 2, 0.1e-6 / c,
                         p_zmin=0., p_zmax=16.e-6, p_rmax=10.e-6, p_nz=1,
                         p_nr=1, p_nt=4, n_e=4.e24, n_order=32,
                         random_seed=0, verbose_level=0, device=dev,
                         dtype=torch.float32)
        sim.use_fused_deposit = True
        add_particle_bunch_gaussian(
            sim, -e, m_e, 1.5e-6, 1.5e-6, 1.e-6, 200., 2., 2.e8, 2000,
            zf=8.e-6, symmetrize=True)
        sc = sim.species_configs
        assert sc[0].resident and sc[1].sort_K == 0 and not sc[1].resident
        init[key] = {n: sim.get_interp_field(n, 0).real
                          for n in ("Er", "Bt")}
        n0 = _k_counts()
        sim.step(20)
        if dev.type == "cuda":
            assert [a - b for a, b in zip(_k_counts(), n0)] == [20, 20, 0]
        assert sim.ptcl[1].Ntot == 2000
        assert sim.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
        runs[key] = _profiles(sim)
    for n in ("Er", "Bt"):
        ref = init["cpu"][n]
        assert np.abs(init["cuda"][n] - ref).max() <= 1e-5 * np.abs(ref).max()
    _close_profiles(runs, {"Ez_axis": 1.5e-2, "Er0_r5": 1.5e-2,
                           "rho_axis": 3e-2})


def _lpa_window_sim(device, dtype, variant):
    """tests/test_torch_ring.py's window box: "antenna" -- vacuum, a
    laser emitted by a lab-static antenna; "mirror_ext" -- a resident
    plasma (sort_K = 256, the fused deposit forced), the a0 = 0.5 laser,
    a mirror 1 um inside the right edge and a uniform external Ez on the
    species."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils import ExternalField, Mirror
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    sim = Simulation(130, 12.e-6, 16, 10.e-6, 2, 16.e-6 / 130 / c,
                     zmin=-4.e-6, n_order=16,
                     boundaries={"z": "open", "r": "reflective"},
                     exchange_period=4, random_seed=0, verbose_level=0,
                     device=device, dtype=dtype)
    if variant == "antenna":
        add_laser_pulse(sim, GaussianLaser(
            a0=0.5, waist=4.e-6, tau=6.e-15, z0=8.e-6 - 3 * c * 6.e-15,
            zf=8.e-6), method="antenna", z0_antenna=8.e-6)
    else:
        sim.use_fused_deposit = True
        view = sim.add_new_species(q=-e, m=m_e, n=5.e24, p_zmin=2.e-6,
                                   p_zmax=100.e-6, p_rmin=0., p_rmax=9.e-6,
                                   p_nz=1, p_nr=2, p_nt=4, sort_K=256)
        assert sim.species_configs[0].resident
        add_laser_pulse(sim, GaussianLaser(a0=0.5, waist=4.e-6,
                                           tau=8.e-15, z0=6.e-6))
        sim.mirrors.append(Mirror(z_lab=11.e-6, n_cells=2))
        sim.external_fields.append(ExternalField(
            lambda F, x, y, z, t, amplitude, length_scale: F + amplitude,
            "Ez", 1.e9, 0., species=view))
        sim.column_angles = _SeededAngles()
    sim.set_moving_window(v=c)
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["antenna", "mirror_ext"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lpa_window_runs_on_card_match_cpu(cuda, variant, dtype):
    """20 steps of an antenna-emitted laser in vacuum, and of a resident
    plasma with a mirror and an external field, on the card against the
    CPU: no kernel launch in vacuum; K2 once a step and K1 once (float32)
    or K3 twice (float64) with the plasma; the on-axis Ez (and rho) and
    the mode-1 Er at r = 5 dr within 1e-8 of their scale in float64 and
    the float32 gates of test_ring_paths_on_card_match_cpu in float32;
    the mirror's cells zero on the card (to 1e-5 of the field's
    largest value: z transforms there and back)."""
    runs = {}
    for key, dev in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        sim = _lpa_window_sim(dev, dtype, variant)
        n0 = _k_counts()
        sim.step(20)
        if dev.type == "cuda":
            want = ([0, 0, 0] if variant == "antenna"
                    else [20, 20, 0] if dtype == torch.float32
                    else [0, 20, 40])
            assert [a - b for a, b in zip(_k_counts(), n0)] == want
        assert sim.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
        runs[key] = dict(
            Ez_axis=sim.get_interp_field("Ez", 0).real[:, 0],
            Er1_r5=np.abs(sim.get_interp_field("Er", 1))[:, 5])
        if variant == "mirror_ext":
            runs[key]["rho_axis"] = \
                sim.get_interp_field("rho", 0).real[:, 0]
            z = sim.grid_z()
            inside = (z >= 11.e-6) & (z < 11.e-6 + 2 * sim.config.dz)
            assert inside.any()
            Er1 = np.abs(sim.get_interp_field("Er", 1))
            assert Er1[inside].max() <= 1e-5 * Er1.max()
    gates = ({n: 1e-8 for n in runs["cpu"]} if dtype == torch.float64
             else {"Ez_axis": 1.5e-2, "Er1_r5": 1.5e-2, "rho_axis": 3e-2})
    _close_profiles(runs, {n: g for n, g in gates.items()
                           if n in runs["cpu"]})
