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
  exact launch counts;
- ionization and Compton scattering: K1 on a layout weighted by w *
  level (levels 5-7) against its plain version, and 10 steps of a ring
  ionizer, a resident ionizer and a Compton source on the card against
  the CPU with the same seeded draws, with exact launch counts;
- the 100- and 450-step float64 golden-wake profiles on the card with
  fbpic_tpu's injection angles (tests/data/torch_golden_angles.npz);
  the task device of use_all_mpi_ranks=False; tests/test_picmi.py's
  setup through fbpic_tpu_torch.picmi on the card against the CPU;
- the z decomposition (parallel/): make_mesh on the card; the float64
  resident mesh of tests/test_resident.py (4 slabs sharing the card)
  against the same 4 slabs on the CPU, within 1e-10 of each vector's
  scale over the slabs but rho_prev (1e-6),
  with exactly two K3 and one K2 launch per slab per step; a float32
  LWFA on 2 slabs of the card against its single-card twin (5e-3) with
  one K1 and one K2 per slab per step; the mesh's slabs spread over
  the cards against the same slabs sharing one, where the machine has
  two or more; the slabs' chunk runner (one CUDA graph a variant holding
  both slabs' steps) bit for bit with the eager slab loop under
  deterministic index_add_, one K1 and one K2 per slab per step counted
  on the replays, a planted overflow rolled back on every slab, a host
  read in one slab's captured step raising; the cross-card exchange
  (peer copies into receive buffers, flags in device memory) on one
  card, its slabs put in groups as if on cards, bit for bit with the
  mailbox; on four cards of one host (``-k several_cards``; skipped
  on one card) the float32 LWFA on 4 slabs, one CUDA graph a
  card, bit for bit with the eager slab loop and with 4 slabs on 2
  cards and on 1, exact launches per slab, a planted overflow on the
  third card rolled back on every card;
- the chunk runner (core/graph.py): K2 reading zmin from device memory
  (a CUDA graph of one call replayed after the value changed); a
  resident LWFA through Simulation.step (the step replayed from a
  captured graph) against its eager twin, the same bits but rho_prev,
  with one K1 and one K2 launch a step counted per replay; a planted
  column overflow rolled back to the eager run; a host read inside the
  captured step raising at capture; the paths that take the chunk
  runner since (an antenna with a mirror, a resident plasma with a
  mirror and an external field, float32 rings, the BTD capture, a
  cubic ring with the radial PML, periodic cross-deposition): 9 steps
  each against the eager loop, bit for bit under deterministic
  index_add_; the antenna's series made for the card; ionization (a
  resident ionizer into a ring and a resident target), Compton
  scattering and a ballistic bunch: 14 steps each against the eager
  loop, bit for bit, the generator's state too; each replay's draws the
  eager run's and new at every replay (the generator registered with
  the graphs); an ionizing chunk's rollback against the eager run.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fbpic_tpu_torch.particles.draws import GeneratorDraws  # noqa: E402

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
    operand build, no copy (zmin given as the 0-d device tensor K2 reads
    in place, as the step's scalars give it; a host number costs one
    fill)."""
    from torch.profiler import ProfilerActivity, profile
    from fbpic_tpu_torch.particles.gather import gather_fields_sorted
    sim, sort = _sorted_particles(cuda, torch.float32, seed=3)
    ops = _k2_ops(sim, sort, "periodic", comp=True, z_fast=True)
    ops["zmin"] = torch.full((), ops["zmin"], dtype=torch.float32,
                             device=cuda)
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


def _golden_config_sim(device, dtype, sort_K=256):
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
                        sort_K=sort_K)
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
    (1e-5) and float64 (1e-12).  The step is taken by the eager loop:
    Simulation.step replays it from a CUDA graph, which runs no Python."""
    from fbpic_tpu_torch.particles import cuda_dense, sorted_deposit
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        sim = _window_variant_sim(cuda, dtype, "cross")
        sim.step(2)
        calls = _captured_contractions(sorted_deposit,
                                       "dense_onehot_contract",
                                       lambda: _eager_loop(sim, 1))
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


# ---------------------------------------------------------------------
# Ionization and Compton scattering on the card
# ---------------------------------------------------------------------

class _SeededDraws:
    """The processes' uniform draws from a numpy seed per (name,
    iteration, species): the same draws whichever device the run is on
    (the port's draw-source interface, particles/draws.py)."""

    def __call__(self, name, iteration, species_index, shape, dtype):
        seed = [iteration, species_index, sum(map(ord, name))]
        u = np.random.default_rng(seed).random(shape)
        if name == "compton_phi":
            u = 2 * np.pi * u
        return torch.as_tensor(u, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_with_ionization_levels_matches_plain(cuda, dtype):
    """K1 on a resident layout whose deposit weight is w * level, levels
    5 to 7 from a seed (a new tensor, as the resident step builds it),
    against its plain version; two launches bit for bit."""
    from fbpic_tpu_torch.particles import cuda_fused
    sim, sort = _sorted_particles(cuda, dtype, seed=31)
    rs = np.random.RandomState(31)
    level = torch.as_tensor(rs.randint(5, 8, tuple(sort["valid"].shape)),
                            dtype=torch.int32, device=cuda)
    pad = list(sort["padded"])
    pad[3] = pad[3] * level.to(dtype)
    ops = _k1_ops(sim, dict(sort, padded=pad))
    out = _twice(lambda: cuda_fused.fused_onehot_contract(**ops))
    ref = cuda_fused.fused_onehot_contract_plain(**ops)
    W_J = ops["n_offJ"] * 2 * ops["channels"].shape[2]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert _rel(out[..., :W_J], ref[..., :W_J]) <= tol
    assert _rel(out[..., W_J:], ref[..., W_J:]) <= tol


def _process_sim(device, case):
    """tests/test_ionization.py's static-field harness (hydrogen atoms,
    the electrons a tracked ring: case "ionize_ring"; both resident:
    "ionize_resident") or tests/test_compton.py's photon bath (a thermal
    electron beam, the photons a ring: "compton"), float64, with
    _SeededDraws."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, m_p
    from fbpic_tpu_torch.lpa_utils import ExternalField
    Nz, Nr, Nm, zmax, rmax = 16, 8, 1, 1.6e-6, 2.e-6
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, zmax / Nz / c, random_seed=3,
                     device=device, dtype=torch.float64)
    resident = case == "ionize_resident"
    sim.use_fused_deposit = resident
    K = 512 if resident else 0
    plasma = dict(n=1e20, p_nz=4, p_nr=4, p_nt=4, p_zmin=0, p_zmax=zmax,
                  p_rmin=0, p_rmax=1.5e-6, continuous_injection=False,
                  sort_K=K)
    if case == "compton":
        elec = sim.add_new_species(q=-e, m=m_e, uz_m=3., ux_th=0.05,
                                   uy_th=0.05, uz_th=0.05, **plasma)
        photons = sim.add_new_species(q=0., m=0., capacity=131072,
                                      continuous_injection=False)
        elec.activate_compton(photons, laser_energy=4.e6,
                              laser_wavelength=0.8e-6, laser_waist=1.e-3,
                              laser_ctau=1.e-2, laser_initial_z0=0.)
    else:
        atoms = sim.add_new_species(q=e, m=m_p, **plasma)
        elec = sim.add_new_species(q=-e, m=m_e, continuous_injection=False,
                                   capacity=None if resident else 65536,
                                   sort_K=K)
        atoms.make_ionizable("H", elec, level_start=0)
        elec.track()
        sim.external_fields.append(ExternalField(
            lambda F, x, y, z, t, amplitude, length_scale: F + amplitude,
            "Ex", 3.2e10, 0.0, species=atoms))
    assert all(sc.resident == resident for sc in sim.species_configs)
    sim.process_draws = _SeededDraws()
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ionize_ring", "ionize_resident",
                                  "compton"])
def test_process_steps_on_card_match_cpu(cuda, case):
    """10 steps of each process on the card and on the CPU from the same
    particles and draws (float64): the same slots live, the same levels
    and ids (ionization), the same photon count; the on-axis Ez and rho
    within 1e-8 of their scale; K2 twice and K3 four times a step on the
    resident path (two resident species, J and rho each), no launch on
    the rings."""
    runs, states = {}, {}
    for key, dev in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        sim = _process_sim(dev, case)
        n0 = _k_counts()
        sim.step(10, correct_currents=case == "compton")
        if dev.type == "cuda":
            want = [0, 20, 40] if case == "ionize_resident" else [0, 0, 0]
            assert [a - b for a, b in zip(_k_counts(), n0)] == want
        assert sim.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
        runs[key] = dict(Ez_axis=sim.get_interp_field("Ez", 0).real[:, 0],
                         rho_axis=sim.get_interp_field("rho", 0).real[:, 0])
        states[key] = [{n: getattr(sp, n).cpu() for n in
                        ("w", "ionization_level", "ids")
                        if getattr(sp, n) is not None}
                       for sp in sim.state.species]
    created = int((states["cpu"][1]["w"] != 0).sum())
    assert created > 100
    for a, b in zip(states["cuda"], states["cpu"]):
        live = b["w"] != 0
        assert torch.equal(a["w"] != 0, live)
        for n in ("ionization_level", "ids"):
            if n in b:
                assert torch.equal(a[n][live], b[n][live]), n
    _close_profiles(runs, {"Ez_axis": 1e-8, "rho_axis": 1e-8})


#: fbpic_tpu's injection angles of the 450-step golden run
#: (tools/torch_golden_angles.py; checked against fbpic_tpu's draws by
#: tests/test_torch_golden.py)
GOLDEN_ANGLES = os.path.join(os.path.dirname(__file__), "data",
                             "torch_golden_angles.npz")


class _RecordedAngles:
    """A column-angle source that answers the recorded (iteration,
    species, column keys) calls of the golden run, and raises on any
    other."""

    def __init__(self):
        d = np.load(GOLDEN_ANGLES)
        self.seed = int(d["seed"])
        self.table = {(int(i), int(s)): (k, a) for i, s, k, a in zip(
            d["iteration"], d["species"], d["nkey"], d["angles"])}

    def __call__(self, iteration, species_index, nkey):
        keys, angles = self.table[(int(iteration), int(species_index))]
        assert np.array_equal(keys, nkey.cpu().numpy()), iteration
        return torch.as_tensor(angles, device=nkey.device)


@pytest.mark.cuda
def test_golden_full_profiles_float64_on_card(cuda):
    """tests/test_golden_wake.py's float64 pins on the card: the
    configuration resident (two K3 and one K2 launch a step) with
    fbpic_tpu's injection angles, the 100-step pin_* and the 450-step
    full_* profiles of tests/data/golden_wake.npz at the golden's own
    2e-3 of each profile's scale."""
    sim = _golden_config_sim(cuda, torch.float64)
    angles = _RecordedAngles()
    assert angles.seed == sim.device_seed
    sim.column_angles = angles
    gold = np.load(GOLDEN)
    n0 = _k_counts()
    for horizon, n_to in (("pin", 100), ("full", 450)):
        sim.step(n_to - sim.iteration)
        for name, arr in _profiles(sim).items():
            g = gold[f"{horizon}_{name}"]
            assert np.isfinite(arr).all(), name
            err = np.abs(arr - g).max() / np.abs(g).max()
            assert err < 2e-3, (horizon, name, err)
    assert [a - b for a, b in zip(_k_counts(), n0)] == [0, 450, 900]
    assert sim.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}


@pytest.mark.cuda
def test_task_device_selection_on_card(cuda, monkeypatch):
    """use_all_mpi_ranks=False pins the run to cuda:k, k being
    FBPIC_TPU_TASK_DEVICE modulo the device count; use_cuda changes
    nothing."""
    from fbpic_tpu_torch.main import Simulation
    n = torch.cuda.device_count()
    monkeypatch.setenv("FBPIC_TPU_TASK_DEVICE", str(n + 1))
    sim = Simulation(64, 10.e-6, 16, 5.e-6, 2, 1.e-15, use_cuda=False,
                     use_all_mpi_ranks=False, verbose_level=0)
    want = torch.device("cuda", (n + 1) % n)
    assert sim.device == want and sim.task_device == want
    assert torch.cuda.current_device() == want.index
    sim.step(2)
    assert sim.state.interp.Ez.device == want
    torch.cuda.set_device(0)


def _picmi_sim(device, dtype):
    """tests/test_picmi.py's setup through fbpic_tpu_torch.picmi (device
    None: the wrapper's default, the card), the host RNG seeded as
    random_seed = 0 seeds it."""
    from fbpic_tpu_torch import picmi
    from fbpic_tpu_torch.constants import c
    grid = picmi.CylindricalGrid(
        number_of_cells=[100, 20], lower_bound=[0., 0.],
        upper_bound=[10.e-6, 10.e-6],
        lower_boundary_conditions=["reflective", "open"],
        upper_boundary_conditions=["reflective", "open"],
        n_azimuthal_modes=2, moving_window_velocity=[0., c])
    on = {} if device is None else dict(device=device)
    psim = picmi.Simulation(solver=picmi.ElectromagneticSolver(
        grid=grid, source_smoother=picmi.BinomialSmoother(n_pass=1)),
        dtype=dtype, **on)
    psim.sim.verbose_level = 0
    psim.sim._rng = np.random.RandomState(0)
    plasma = picmi.Species(
        particle_type="electron", name="plasma",
        initial_distribution=picmi.AnalyticDistribution(
            density_expression="1e24*exp(-(r/3e-6)**2)",
            lower_bound=[None, None, 8.e-6], fill_in=True))
    psim.add_species(plasma, layout=picmi.GriddedLayout(
        n_macroparticle_per_cell={"r": 1, "z": 1, "theta": 4},
        grid=grid))
    psim.add_laser(picmi.GaussianLaser(
        wavelength=0.8e-6, waist=4.e-6, duration=8.e-15,
        focal_position=[0, 0, 5.e-6], centroid_position=[0, 0, 5.e-6],
        a0=0.5, polarization_direction=[0, 1, 0]))
    psim.sim.column_angles = _SeededAngles()
    return psim


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_picmi_on_card_matches_cpu(cuda, dtype):
    """20 steps of tests/test_picmi.py's setup built through
    fbpic_tpu_torch.picmi on the card (its default device) and on the
    CPU (float64: the ring path there, equal to the resident one to ~2e-14
    on the CPU): one K1 (float32) or two K3 (float64) and one K2 launch a
    step on the card (resident); E_z and rho on the axis within 1e-8 of
    their scale in float64, and the 100-step float32 gates of
    tests/test_golden_wake.py (1.5e-2, 3e-2 for rho) in float32."""
    runs = {}
    for key, dev in (("cuda", None), ("cpu", "cpu")):
        psim = _picmi_sim(dev, dtype)
        n0 = _k_counts()
        psim.step(20)
        if key == "cuda":
            assert psim.sim.device.type == "cuda"
            assert psim.sim.species_configs[0].resident
            want = [20, 20, 0] if dtype == torch.float32 else [0, 20, 40]
            assert [a - b for a, b in zip(_k_counts(), n0)] == want
        assert psim.sim.overflow_totals == {"sort_overflow": 0,
                                            "ring_overwrite": 0}
        runs[key] = dict(
            Ez_axis=psim.sim.get_interp_field("Ez", 0).real[:, 0],
            rho_axis=psim.sim.get_interp_field("rho", 0).real[:, 0])
    _close_profiles(runs, {"Ez_axis": 1e-8, "rho_axis": 1e-8}
                    if dtype == torch.float64 else
                    {"Ez_axis": 1.5e-2, "rho_axis": 3e-2})


@pytest.mark.cuda
def test_picmi_applied_field_and_mirror_on_card_match_cpu(cuda):
    """A Gaussian bunch (PseudoRandomLayout) pushed by a PICMI
    ConstantAppliedField (ExternalField(lambda F, ...: F + amplitude),
    which gets the card's tensors) beside a Mirror, 10 steps on the card
    and on the CPU, float64: the bunch's uz and E_z / rho on the axis
    within 1e-8 of their scale (tests/test_torch_picmi.py holds the same
    setup against fbpic_tpu on the CPU); a ring with sort_K = 0, so no
    kernel launch."""
    from fbpic_tpu_torch import picmi
    from fbpic_tpu_torch.constants import c
    runs, uz = {}, {}
    for key, dev in (("cuda", None), ("cpu", "cpu")):
        grid = picmi.CylindricalGrid(
            number_of_cells=[64, 16], lower_bound=[0., 0.],
            upper_bound=[8.e-6, 16.e-6],
            lower_boundary_conditions=["reflective", "periodic"],
            upper_boundary_conditions=["reflective", "periodic"])
        on = {} if dev is None else dict(device=dev)
        psim = picmi.Simulation(solver=picmi.ElectromagneticSolver(
            grid=grid), dtype=torch.float64, **on)
        psim.sim.verbose_level = 0
        psim.sim._rng = np.random.RandomState(0)
        psim.add_species(picmi.Species(
            particle_type="electron", name="bunch",
            initial_distribution=picmi.GaussianBunchDistribution(
                n_physical_particles=1.e8,
                rms_bunch_size=[1.e-6, 1.e-6, 1.e-6],
                centroid_position=[0., 0., 6.e-6],
                centroid_velocity=[0., 0., 0.99 * c])),
            layout=picmi.PseudoRandomLayout(n_macroparticles=2000))
        psim.add_applied_field(picmi.ConstantAppliedField(Ez=-1.e10,
                                                          Bx=0.2))
        psim.add_applied_field(picmi.Mirror(z_front_location=14.e-6))
        n0 = _k_counts()
        psim.step(10)
        if key == "cuda":
            assert psim.sim.device.type == "cuda"
            assert _k_counts() == n0
        sp = psim.sim.state.species[0]
        uz[key] = sp.uz.cpu().numpy()
        runs[key] = dict(
            Ez_axis=psim.sim.get_interp_field("Ez", 0).real[:, 0],
            rho_axis=psim.sim.get_interp_field("rho", 0).real[:, 0])
    assert np.abs(uz["cuda"] - uz["cpu"]).max() < 1e-8 * np.abs(
        uz["cpu"]).max()
    _close_profiles(runs, {"Ez_axis": 1e-8, "rho_axis": 1e-8})


def _k_counters():
    from fbpic_tpu_torch.particles.cuda_dense import dense_onehot_contract
    from fbpic_tpu_torch.particles.cuda_fused import fused_onehot_contract
    from fbpic_tpu_torch.particles.cuda_gather import gather_sorted
    return {"K1": fused_onehot_contract, "K2": gather_sorted,
            "K3": dense_onehot_contract}


def _reset_slab_counts():
    for fn in _k_counters().values():
        fn.launches_by_slab = {}


def _slab_counts():
    return {k: dict(fn.launches_by_slab) for k, fn in _k_counters().items()}


@pytest.mark.cuda
def test_make_mesh_on_card(cuda):
    from fbpic_tpu_torch.parallel import make_mesh
    n = torch.cuda.device_count()
    mesh = make_mesh()
    assert [str(d) for d in mesh.devices] == [f"cuda:{i}" for i in range(n)]
    assert make_mesh(devices=["cuda"] * 3).devices == [
        torch.device("cuda", 0)] * 3
    with pytest.raises(ValueError, match=f"requested a {n + 1}-device mesh"):
        make_mesh(n + 1)


def _resident_mesh(device, n_steps, devices=None):
    """tests/test_resident.py's resident mesh in float64 (4 slabs,
    n_guard 24, exchange_period 4) with numpy-drawn injection angles."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    from fbpic_tpu_torch.parallel import distribute_simulation

    def angles(iteration, species_index, nkey):
        rng = np.random.RandomState(1000 * int(iteration) + species_index)
        return torch.as_tensor(2 * np.pi * rng.random_sample(nkey.shape[0]),
                               device=nkey.device)
    nz, zmax, zmin = 130, 12.e-6, -4.e-6
    sim = Simulation(nz, zmax, 16, 10.e-6, 2, (zmax - zmin) / nz / c,
                     zmin=zmin, n_order=16,
                     boundaries={"z": "open", "r": "reflective"},
                     exchange_period=4, random_seed=0, verbose_level=0,
                     device=device, dtype=torch.float64)
    sim.use_fused_deposit = True
    sim.add_new_species(q=-e, m=m_e, n=5.e24, p_zmin=2.e-6, p_zmax=100.e-6,
                        p_rmin=0., p_rmax=9.e-6, p_nz=1, p_nr=2, p_nt=4,
                        continuous_injection=True, sort_K=256)
    add_laser_pulse(sim, GaussianLaser(a0=0.5, waist=4.e-6, tau=8.e-15,
                                       z0=6.e-6))
    sim.set_moving_window(v=c)
    sim.column_angles = angles
    run = distribute_simulation(sim, devices=devices or [device] * 4,
                                n_guard=24)
    run.step(n_steps)
    return run


_FAMILIES = (("spect", ("Ep", "Em", "Ez")), ("spect", ("Bp", "Bm", "Bz")),
             ("spect", ("Jp", "Jm", "Jz")), ("interp", ("Er", "Et", "Ez")),
             ("interp", ("Br", "Bt", "Bz")), ("species", ("x", "y", "z")),
             ("species", ("ux", "uy", "uz")), ("species", ("w",)))


def _states_close(a_states, b_states, tol, tol_rho=1e-6):
    """Per-slab states within tol of each vector's scale over the slabs
    (the live particles only; the live slots equal), rho_prev within
    tol_rho of its scale."""
    lives = []
    for a, b in zip(a_states, b_states):
        lives.append((a.species[0].w != 0).cpu())
        assert torch.equal(lives[-1], (b.species[0].w != 0).cpu())

    def arrays(st, part, n, live):
        if part == "species":
            return getattr(st.species[0], n).cpu()[live]
        return getattr(getattr(st, part), n).cpu()
    for part, names in _FAMILIES + (("spect", ("rho_prev",)),):
        pairs = [(arrays(a, part, n, lv), arrays(b, part, n, lv))
                 for a, b, lv in zip(a_states, b_states, lives)
                 for n in names]
        scale = max(float(x.abs().max()) for x, _ in pairs if x.numel())
        t = tol_rho if names == ("rho_prev",) else tol
        for x, y in pairs:
            if x.numel():
                assert float((x - y).abs().max()) <= t * scale, (part, names)


@pytest.mark.cuda
def test_resident_mesh_on_card_matches_cpu(cuda):
    n_steps = 12
    _reset_slab_counts()
    card = _resident_mesh("cuda:0", n_steps)
    assert _slab_counts() == {"K1": {},
                              "K2": {r: n_steps for r in range(4)},
                              "K3": {r: 2 * n_steps for r in range(4)}}
    cpu = _resident_mesh("cpu", n_steps)
    _states_close(cpu.states, card.states, 1e-10)
    assert card.overflow_totals == cpu.overflow_totals == {
        "migration_overflow": 0, "sort_overflow": 0, "ring_overwrite": 0}


@pytest.mark.cuda
def test_slabs_on_several_cards_match_slabs_sharing_one(cuda):
    """The 4 slabs of the float64 resident mesh spread over the cards
    (its chunks replayed from one CUDA graph a card, the cross-card
    exchanges peer copies inside them) against the same 4 slabs sharing
    cuda:0, within 1e-10."""
    n_steps = 12
    devices = _four_slabs_on_cards()
    one = _resident_mesh("cuda:0", n_steps)
    many = _resident_mesh("cuda:0", n_steps, devices=devices)
    assert [str(s.spect.Ez.device) for s in many.states] == devices
    assert many.runner.graphs and all(
        len(graphs) == len(set(devices))
        for graphs, _ in many.runner.graphs.values())
    _states_close(one.states, many.states, 1e-10)


def _slab_lwfa(exchange_period=1):
    """tests/test_multichip.py's LWFA in float32 on the card (the
    resident layout: K1 and K2)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    nz, zmax, zmin = 130, 12.e-6, -4.e-6
    sim = Simulation(nz, zmax, 20, 10.e-6, 2, (zmax - zmin) / nz / c,
                     p_zmin=2.e-6, p_zmax=200.e-6, p_rmin=0.,
                     p_rmax=9.e-6, p_nz=1, p_nr=2, p_nt=4, n_e=5.e24,
                     zmin=zmin, n_order=16,
                     boundaries={"z": "open", "r": "reflective"},
                     exchange_period=exchange_period, random_seed=0,
                     verbose_level=0)
    add_laser_pulse(sim, GaussianLaser(a0=0.5, waist=4.e-6,
                                       tau=8.e-15, z0=6.e-6))
    sim.set_moving_window(v=c)
    return sim


@pytest.mark.cuda
def test_float32_lwfa_on_two_slabs_of_the_card(cuda):
    """tests/test_multichip.py's LWFA in float32 (the card's resident
    layout: K1 and K2) on 2 slabs sharing the card against the single
    card, 30 steps: Ez within 5e-3, the live count equal, one K1 and one
    K2 per slab per step."""
    from fbpic_tpu_torch.parallel import distribute_simulation
    from fbpic_tpu_torch.fields import transform as tr
    n_steps = 30
    build = _slab_lwfa
    single = build()
    assert single.species_configs[0].resident
    single.step(n_steps)
    _reset_slab_counts()
    run = distribute_simulation(build(), devices=["cuda:0"] * 2)
    run.step(n_steps)
    assert _slab_counts() == {"K1": {0: n_steps, 1: n_steps},
                              "K2": {0: n_steps, 1: n_steps}, "K3": {}}
    Ez1 = tr.spect2interp_scal(single.aux.mats,
                               single.state.spect.Ez)[0].cpu().numpy()
    Ez2 = run.get_interp_field("Ez", 0)
    assert np.abs(Ez2 - Ez1).max() < 5e-3 * np.abs(Ez1).max()
    assert sum(int((s.species[0].w != 0).sum()) for s in run.states) == int(
        (single.state.species[0].w != 0).sum())
    assert run.overflow_totals["migration_overflow"] == 0


def _slab_twins(n_steps, devices=("cuda:0",) * 2, **dist_kw):
    """The LWFA of _slab_lwfa (exchange period 4) on slabs of
    ``devices`` (2 slabs of cuda:0) twice from the same seeds: the chunk
    runner's run (its steps replayed from CUDA graphs) and the eager
    slab loop, n_steps each under deterministic index_add_; the graphed
    run's kernel counts per slab (set to 0 just before it)."""
    from fbpic_tpu_torch.parallel import distribute_simulation
    runs, counts = [], None
    with _deterministic():
        for eager in (False, True):
            run = distribute_simulation(_slab_lwfa(exchange_period=4),
                                        devices=list(devices), n_guard=24,
                                        **dist_kw)
            run.eager = eager
            _reset_slab_counts()
            run.step(n_steps)
            torch.cuda.synchronize()
            if not eager:
                counts = _slab_counts()
            runs.append(run)
    return runs, counts


def _assert_slabs_equal(a, b):
    """Every tensor of every slab equal (wherever each run's slab lies),
    the host values and the generators' states too."""
    from fbpic_tpu_torch.core.graph import state_tensors
    for r, (sa, sb) in enumerate(zip(a.states, b.states)):
        for i, (x, y) in enumerate(zip(state_tensors(sa),
                                       state_tensors(sb))):
            assert torch.equal(x, y.to(x.device)), (r, i)
        for name in ("time", "zmin", "mw_zref", "iteration"):
            assert getattr(sa, name) == getattr(sb, name), (r, name)
    for ga, gb in zip(a._generators, b._generators):
        assert torch.equal(ga.get_state(), gb.get_state())


@pytest.mark.cuda
def test_graphed_slabs_match_the_eager_slab_loop(cuda):
    """The slabs' chunk runner on 2 slabs of the card: one CUDA graph a
    variant holds both slabs' steps (captured from the slab threads into
    one capture stream), every other step replayed; 22 steps bit for bit
    with the eager slab loop under deterministic index_add_, one K1 and
    one K2 per slab per step counted on the replays."""
    n_steps = 22
    (graphed, eager), counts = _slab_twins(n_steps)
    assert graphed.graph_blockers == ([], []) \
        and graphed.exchange_period == 4
    assert graphed.runner.graphs and not eager.runner.graphs
    assert counts == {"K1": {0: n_steps, 1: n_steps},
                      "K2": {0: n_steps, 1: n_steps}, "K3": {}}
    _assert_slabs_equal(graphed, eager)
    assert graphed.overflow_totals == eager.overflow_totals == {
        "migration_overflow": 0, "sort_overflow": 0, "ring_overwrite": 0}


@pytest.mark.cuda
def test_graphed_slabs_roll_back_a_planted_overflow(cuda):
    """A column overflow planted on slab 1 at a replayed step: the
    chunk's one read sees its redo flag, every slab runs the chunk again
    through the eager slab loop, and the result equals the eager run."""
    import dataclasses
    import warnings
    (graphed, eager), _ = _slab_twins(5, on_migration_overflow="warn")
    for run in (graphed, eager):
        cfg, K = run.config_local, run.sim.species_configs[0].sort_K
        st = run.states[1]
        sp = st.species[0]
        live = (sp.w != 0).reshape(cfg.Nz, K)
        counts = live.sum(1)
        row = int(torch.argmax(counts[:-2] + counts[1:-1] + counts[2:])) + 1
        assert int(counts[row - 1:row + 2].sum()) > K
        z = sp.z.clone().reshape(cfg.Nz, K)
        for r in (row - 1, row + 1):
            z[r] = torch.where(live[r], z[r] + (row - r) * cfg.dz, z[r])
        run.states[1] = dataclasses.replace(
            st, species=[sp.replace(z=z.reshape(-1))])
    with _deterministic(), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for run in (graphed, eager):
            run.step(3)
    assert graphed.overflow_totals.get("rollbacks") == 1
    assert graphed.overflow_totals["sort_overflow"] == \
        eager.overflow_totals["sort_overflow"] > 0
    _assert_slabs_equal(graphed, eager)


def _four_slabs_on_cards():
    """4 slabs spread over the cards (one a card on four), or a skip
    where the machine has one card."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two cards")
    return [f"cuda:{r * min(n_cards, 4) // 4}" for r in range(4)]


def _plant_column_overflow(run, slab):
    """Move the live particles of the rows around slab ``slab``'s
    fullest three into the middle row, past its sort_K."""
    import dataclasses
    cfg, K = run.config_local, run.sim.species_configs[0].sort_K
    st = run.states[slab]
    sp = st.species[0]
    live = (sp.w != 0).reshape(cfg.Nz, K)
    counts = live.sum(1)
    row = int(torch.argmax(counts[:-2] + counts[1:-1] + counts[2:])) + 1
    assert int(counts[row - 1:row + 2].sum()) > K
    z = sp.z.clone().reshape(cfg.Nz, K)
    for r in (row - 1, row + 1):
        z[r] = torch.where(live[r], z[r] + (row - r) * cfg.dz, z[r])
    run.states[slab] = dataclasses.replace(
        st, species=[sp.replace(z=z.reshape(-1))])


@pytest.mark.cuda
def test_graphed_slabs_on_several_cards_match_the_eager_slab_loop(cuda):
    """The float32 LWFA on 4 slabs spread over the cards: one CUDA graph
    a card a variant (the cross-card exchanges, migration and sums
    inside), 22 steps bit for bit with the eager slab loop on the same
    cards under deterministic index_add_ (the generators too), one K1
    and one K2 per slab per step counted on the replays, no timed-out
    exchange wait."""
    devices = _four_slabs_on_cards()
    n_steps = 22
    (graphed, eager), counts = _slab_twins(n_steps, devices)
    cards = sorted({torch.device(d) for d in devices}, key=str)
    assert [str(s.spect.Ez.device) for s in graphed.states] == devices
    assert graphed.graph_blockers == ([], [])
    assert graphed.runner.graphs and not eager.runner.graphs
    for graphs, _ in graphed.runner.graphs.values():
        assert sorted(graphs, key=str) == cards
    assert counts == {"K1": {r: n_steps for r in range(4)},
                      "K2": {r: n_steps for r in range(4)}, "K3": {}}
    _assert_slabs_equal(graphed, eager)
    assert [int(f) for f in graphed.group.faults()] == [0] * len(cards)
    assert graphed.overflow_totals == eager.overflow_totals == {
        "migration_overflow": 0, "sort_overflow": 0, "ring_overwrite": 0}


@pytest.mark.cuda
def test_graphed_slabs_on_several_cards_match_fewer_cards(cuda):
    """The same 4 slabs graphed on 4 cards (one each, every seam across
    cards), on 2 (two each: seams inside a card and across) and on 1:
    every array of every slab bit for bit under deterministic
    index_add_ (the exchanges move the same bits by reference or by
    peer copy)."""
    from fbpic_tpu_torch.parallel import distribute_simulation
    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        pytest.skip("needs four cards")
    runs = []
    with _deterministic():
        for k in (4, 2, 1):
            run = distribute_simulation(
                _slab_lwfa(exchange_period=4),
                devices=[f"cuda:{r * k // 4}" for r in range(4)],
                n_guard=24)
            run.step(14)
            assert run.runner.graphs
            runs.append(run)
    four, two, one = runs
    _assert_slabs_equal(four, two)
    _assert_slabs_equal(four, one)


@pytest.mark.cuda
def test_graphed_slabs_on_several_cards_roll_back_a_planted_overflow(cuda):
    """A column overflow planted on slab 2 (on its own card) at a
    replayed step: the chunk's one read sees that card's redo flag,
    every card runs the chunk again through the eager slab loop, and
    the result equals the eager run on the same cards."""
    import warnings
    devices = _four_slabs_on_cards()
    (graphed, eager), _ = _slab_twins(5, devices,
                                      on_migration_overflow="warn")
    for run in (graphed, eager):
        _plant_column_overflow(run, 2)
    with _deterministic(), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for run in (graphed, eager):
            run.step(3)
    assert graphed.overflow_totals.get("rollbacks") == 1
    assert graphed.overflow_totals["sort_overflow"] == \
        eager.overflow_totals["sort_overflow"] > 0
    _assert_slabs_equal(graphed, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [[[0], [1]], [[0, 1], [2, 3]]])
def test_receive_buffer_exchange_on_one_card_matches_the_mailbox(
        cuda, monkeypatch, groups):
    """The cross-card exchange (peer copies into receive buffers, the
    flags in device memory) on one card: the slabs of cuda:0 put in
    groups as if each group had a card of its own (2 slabs, one a group;
    4 slabs, two a group: exchanges inside a group and across) exchange
    through it -- in the card's one stream, the flags' two sets put no
    wait ahead of the give it needs --, graphed and eager, 14 steps bit
    for bit with the same slabs exchanging by reference (the mailbox),
    copy launches counted, no timed-out wait."""
    from fbpic_tpu_torch.parallel import group, peer
    devices = ["cuda:0"] * sum(len(g) for g in groups)
    runs, _ = _slab_twins(14, devices)
    monkeypatch.setattr(group, "card_groups", lambda d: groups)
    peer.copy_parts.launches = 0
    (graphed, eager), counts = _slab_twins(14, devices)
    assert graphed.group.groups == groups
    assert graphed.group.channels is not None and graphed.runner.graphs
    assert counts["K1"] == {r: 14 for r in range(len(devices))}
    assert peer.copy_parts.launches > 0
    assert [int(f) for f in graphed.group.faults()] == [0]
    _assert_slabs_equal(graphed, eager)
    _assert_slabs_equal(graphed, runs[0])


@pytest.mark.cuda
def test_graphed_slabs_capture_raises_on_a_host_sync(cuda, monkeypatch):
    """A host read in one slab's step during the capture raises, with
    the slabs' variant in the message (no fallback to the eager slab
    loop), and the sync debug mode is restored."""
    from fbpic_tpu_torch.core import step as step_module
    from fbpic_tpu_torch.parallel import distribute_simulation
    from fbpic_tpu_torch.utils import kernels
    real = step_module.gather_fields_sorted

    def reads_back(*args, **kwargs):
        if kernels.current_slab.rank == 1:
            int(args[3].sum())
        return real(*args, **kwargs)

    monkeypatch.setattr(step_module, "gather_fields_sorted", reads_back)
    run = distribute_simulation(_slab_lwfa(exchange_period=4),
                                devices=["cuda:0"] * 2, n_guard=24)
    with pytest.raises(RuntimeError, match="capturing the slabs' step"):
        run.step(3)
    assert torch.cuda.get_sync_debug_mode() == 0


# ---------------------------------------------------------------------
# The chunk runner on the card (core/graph.py): CUDA graphs of the step
# ---------------------------------------------------------------------

def _eager_steps(sim, n):
    """The eager twin of sim.step(n): prepare, the eager step function
    n times in a loop, the overflow read."""
    from fbpic_tpu_torch.core.step import make_prepare, make_step
    options = sim.build_options()
    step = make_step(sim.config, sim.species_configs, options)
    sim.state = make_prepare(sim.config, sim.species_configs, options)(
        sim.state, sim.aux)
    for _ in range(n):
        sim.state = step(sim.state, sim.aux, tuple(sim._injector_auxes),
                         sim.column_angles, sim.generator)
    sim._consume_overflow_counters()


def _graph_twins(cuda, sort_K=256):
    """The float32 golden-wake configuration twice, with the same
    plasma and column angles: one for Simulation.step, one for the
    eager loop."""
    sims = []
    for _ in range(2):
        sim = _golden_config_sim(cuda, torch.float32, sort_K)
        sim.column_angles = _SeededAngles()
        sims.append(sim)
    return sims


def _assert_twins_equal(a, b):
    """Every tensor of the two states equal bit for bit but rho_prev, an
    atomic scatter deposit on the card (1e-6 of its scale), and the host
    values equal."""
    from fbpic_tpu_torch.core.graph import state_tensors
    assert (a.state.iteration, float(a.state.zmin), float(a.state.time)) \
        == (b.state.iteration, float(b.state.zmin), float(b.state.time))
    rho = a.state.spect.rho_prev
    for x, y in zip(state_tensors(a.state), state_tensors(b.state)):
        if x is rho:
            assert _rel(x, y) <= 1e-6
        else:
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_reads_zmin_from_device_memory(cuda, dtype):
    """K2 with zmin as a 0-d device tensor against its plain version, bit
    for bit against K2 with the host number, and a CUDA graph of one K2
    call replayed after the tensor was refilled against a direct call
    with the new value: the launch reads zmin where it lies."""
    from fbpic_tpu_torch.particles import cuda_gather
    sim, sort = _sorted_particles(cuda, dtype, seed=41)
    ops = _k2_ops(sim, sort, "clamp", comp=True)
    z_t = torch.full((), sim.zmin, dtype=dtype, device=cuda)
    out = _k2_check(dict(ops, zmin=z_t), dtype)
    host = torch.stack(cuda_gather.gather_sorted(**ops))
    assert torch.equal(out, host)
    with pytest.raises(TypeError):
        cuda_gather.gather_sorted(**dict(ops, zmin=z_t.float() if
                                         dtype == torch.float64 else
                                         z_t.double()))
    static = torch.stack(cuda_gather.gather_sorted(**dict(ops, zmin=z_t)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = torch.stack(cuda_gather.gather_sorted(**dict(ops,
                                                              zmin=z_t)))
    shifted = sim.zmin + 0.3 * sim.config.dz
    z_t.fill_(shifted)
    graph.replay()
    direct = torch.stack(cuda_gather.gather_sorted(**dict(ops,
                                                          zmin=shifted)))
    torch.cuda.synchronize()
    assert torch.equal(static, direct) and not torch.equal(static, out)


@pytest.mark.cuda
def test_graphed_run_equals_its_eager_twin(cuda):
    """40 steps (ten exchange steps) through Simulation.step, which
    replays the captured step, and through the eager loop: the same bits
    but rho_prev; one K1 and one K2 launch a step, counted per replay;
    two graph variants (n_move = 1 every step; the exchange steps' rest,
    after their eager exchange block -- the seeded angle source keeps it
    eager -- fully re-sorted)."""
    from fbpic_tpu_torch.particles import cuda_fused, cuda_gather
    graphed, twin = _graph_twins(cuda)
    assert graphed.exchange_period > 1
    n_k1 = cuda_fused.fused_onehot_contract.launches
    n_k2 = cuda_gather.gather_sorted.launches
    graphed.step(40)
    assert cuda_fused.fused_onehot_contract.launches - n_k1 == 40
    assert cuda_gather.gather_sorted.launches - n_k2 == 40
    assert sorted(graphed._multi_step.graphs) == [(1, False, False),
                                                  (1, True, False)]
    _eager_steps(twin, 40)
    _assert_twins_equal(graphed, twin)
    assert graphed.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
    # more calls replay the same graphs
    graphs = dict(graphed._multi_step.graphs)
    graphed.step(7)
    _eager_steps(twin, 7)
    _assert_twins_equal(graphed, twin)
    assert graphed._multi_step.graphs == graphs


@pytest.mark.cuda
def test_graphed_rollback_equals_the_eager_run(cuda):
    """A column overflow planted in both twins before a call that starts
    on a non-exchange step: the graphed chunk rolls back (one rollback),
    runs again eagerly and equals the twin; the sort_K bump then drops
    the graphs and the next call captures anew."""
    import warnings
    # 68 particles a column: three columns hold more than sort_K 128
    graphed, twin = _graph_twins(cuda, sort_K=128)
    graphed.step(5)
    _eager_steps(twin, 5)
    assert graphed.state.iteration % graphed.exchange_period != 0
    for sim in (graphed, twin):
        sp, K = sim.state.species[0], sim.species_configs[0].sort_K
        Nz, dz = sim.config.Nz, sim.config.dz
        live = (sp.w != 0).reshape(Nz, K)
        counts = live.sum(1)
        row = int(torch.argmax(counts[:-2] + counts[1:-1] + counts[2:])) + 1
        assert int(counts[row - 1:row + 2].sum()) > K
        z = sp.z.clone().reshape(Nz, K)
        z[row - 1] = torch.where(live[row - 1], z[row - 1] + dz, z[row - 1])
        z[row + 1] = torch.where(live[row + 1], z[row + 1] - dz, z[row + 1])
        sim.state.species[0] = sp.replace(z=z.reshape(-1))
    runner = graphed._multi_step
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        graphed.step(6)
        _eager_steps(twin, 6)
    assert graphed.overflow_totals["rollbacks"] == 1
    assert graphed.overflow_totals["sort_overflow"] \
        == twin.overflow_totals["sort_overflow"] > 0
    _assert_twins_equal(graphed, twin)
    graphed.step(6)
    _eager_steps(twin, 6)
    assert graphed._multi_step is not runner and graphed._multi_step.graphs
    _assert_twins_equal(graphed, twin)


@pytest.mark.cuda
def test_graph_capture_raises_on_a_host_sync(cuda, monkeypatch):
    """A host read inside the captured step raises where it is made (the
    capture runs under torch's sync debug mode "error"), with the
    variant in the message: no fallback to the eager loop."""
    from fbpic_tpu_torch.core import step as step_module
    real = step_module.gather_fields_sorted

    def reads_back(*args, **kwargs):
        int(args[3].sum())
        return real(*args, **kwargs)

    monkeypatch.setattr(step_module, "gather_fields_sorted", reads_back)
    sim = _golden_config_sim(cuda, torch.float32)
    with pytest.raises(RuntimeError, match="capturing the step"):
        sim.step(3)
    assert torch.cuda.get_sync_debug_mode() == 0


def _exchange_twins(cuda, sort_K=256):
    """The float32 golden-wake configuration twice, the column angles
    the simulation's own (GeneratorAngles of its generator, seeded
    alike): the exchange block replays inside its step's graph."""
    from fbpic_tpu_torch.core.graph import graph_blockers
    sims = [_golden_config_sim(cuda, torch.float32, sort_K)
            for _ in range(2)]
    assert graph_blockers(sims[0], sims[0].build_options()) == ([], [])
    return sims


def _assert_exchange_twins_equal(a, b):
    """Every tensor bit for bit (under deterministic index_add_), the
    host values, the injection front, the cursors and the generator's
    state."""
    from fbpic_tpu_torch.core.graph import state_tensors
    sa, sb = a.state, b.state
    assert (sa.iteration, float(sa.zmin), float(sa.time)) == \
        (sb.iteration, float(sb.zmin), float(sb.time))
    for i, (x, y) in enumerate(zip(state_tensors(sa), state_tensors(sb))):
        assert torch.equal(x, y), i
    pa, pb = sa.species[0], sb.species[0]
    assert (pa.next_free, float(pa.inj_z_end)) == \
        (pb.next_free, float(pb.inj_z_end))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _host_launch_calls(run):
    """The host's kernel launch calls (not the graph launches) of
    run(), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                             "cuLaunchKernel"))


@pytest.mark.cuda
def test_graphed_exchange_runs_no_eager_exchange(cuda, monkeypatch):
    """Two exchange periods in one chunk, after a call that captured
    both variants: no exchange block runs from Python (the injection is
    never called), the host launches the kernels of a one-step chunk
    (the chunk's set-up and its one read) and, for each replay of an
    exchange variant, at most the two of torch's replay prologue for
    the generator registered with it (its seed and offset, filled on
    the device) -- where an eager exchange block would launch hundreds
    --, and the run equals its eager twin bit for bit under
    deterministic index_add_, the injection front, the cursors and the
    generator's state included."""
    from fbpic_tpu_torch.core import step as step_module
    with _deterministic():
        graphed, twin = _exchange_twins(cuda)
        ep = graphed.exchange_period
        assert ep > 1
        graphed.step(ep + 1)
        _eager_steps(twin, ep + 1)
        assert sorted(graphed._multi_step.graphs) == [(1, False, False),
                                                      (1, True, True)]
        real = step_module.continuous_injection
        calls = []

        def record(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)
        monkeypatch.setattr(step_module, "continuous_injection", record)
        one = _host_launch_calls(lambda: graphed.step(1))
        periods = _host_launch_calls(lambda: graphed.step(2 * ep))
        assert calls == []
        monkeypatch.setattr(step_module, "continuous_injection", real)
        # the twin with the same step() call boundaries (each call
        # deposits rho_prev afresh)
        _eager_steps(twin, 1)
        _eager_steps(twin, 2 * ep)
    assert one <= periods <= one + 2 * 2, (periods, one)
    _assert_exchange_twins_equal(graphed, twin)
    sp = graphed.state.species[0]
    assert sp.next_free > 0 and int((sp.w != 0).sum()) > 0


@pytest.mark.cuda
def test_density_probe_on_the_card(cuda):
    """probe_dens_func decides on the meta device what the card does: a
    torch density that it sends to the device returns a tensor of the
    card under sync debug mode "error"; numpy code (np.where, and a
    numpy ufunc, which a CPU tensor would pass through) and a torch
    density that reads the host stay on the host, and raise on CUDA
    tensors there."""
    from fbpic_tpu_torch.particles.injection import probe_dens_func

    def ramp(z, r):
        return 1. + 0.5 * torch.tanh(z / 1.e-6)

    def reads_back(z, r):
        return z * float(z.max())
    host = (lambda z, r: np.where(z > 0, 1., 0.),
            lambda z, r: np.exp(-z / 1.e-6), reads_back)
    for dtype in (torch.float32, torch.float64):
        z = torch.linspace(0., 1.e-6, 8, dtype=dtype, device=cuda)
        assert probe_dens_func(ramp, "zr", dtype=dtype)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = ramp(z, z)
            assert out.device == z.device and out.shape == z.shape
            for fn in host:
                assert not probe_dens_func(fn, "zr", dtype=dtype)
                with pytest.raises(Exception):
                    fn(z, z)
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_exchange_capture_raises_on_a_host_read(cuda, monkeypatch):
    """A host read planted in the exchange block (the injection reads
    its column count back) raises while the exchange variant is
    captured, with the variant in the message: no fallback."""
    from fbpic_tpu_torch.core import step as step_module
    real = step_module.continuous_injection

    def reads_back(sp, inj_cfg, inj_aux, columns, *args, **kwargs):
        if torch.is_tensor(columns[0]):
            int(columns[0])
        return real(sp, inj_cfg, inj_aux, columns, *args, **kwargs)

    monkeypatch.setattr(step_module, "continuous_injection", reads_back)
    sim, _ = _exchange_twins(cuda)
    with pytest.raises(RuntimeError, match="exchange block inside=True"):
        sim.step(3)
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_exchange_inside_rolls_back_a_planted_overflow(cuda):
    """A column overflow planted in both twins before a chunk that
    crosses an exchange step replayed with its exchange block: the
    chunk rolls back (the generator's state restored), runs again
    eagerly and equals the eager twin bit for bit under deterministic
    index_add_."""
    import warnings
    with _deterministic():
        graphed, twin = _exchange_twins(cuda, sort_K=128)
        graphed.step(5)
        _eager_steps(twin, 5)
        ep = graphed.exchange_period
        assert graphed.state.iteration % ep != 0
        for sim in (graphed, twin):
            sp, K = sim.state.species[0], sim.species_configs[0].sort_K
            Nz, dz = sim.config.Nz, sim.config.dz
            live = (sp.w != 0).reshape(Nz, K)
            counts = live.sum(1)
            row = int(torch.argmax(counts[:-2] + counts[1:-1]
                                   + counts[2:])) + 1
            assert int(counts[row - 1:row + 2].sum()) > K
            z = sp.z.clone().reshape(Nz, K)
            z[row - 1] = torch.where(live[row - 1], z[row - 1] + dz,
                                     z[row - 1])
            z[row + 1] = torch.where(live[row + 1], z[row + 1] - dz,
                                     z[row + 1])
            sim.state.species[0] = sp.replace(z=z.reshape(-1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            graphed.step(ep + 2)
            _eager_steps(twin, ep + 2)
    assert graphed.overflow_totals["rollbacks"] == 1
    assert graphed.overflow_totals["sort_overflow"] \
        == twin.overflow_totals["sort_overflow"] > 0
    _assert_exchange_twins_equal(graphed, twin)


@pytest.mark.cuda
def test_no_garbage_collection_during_a_capture(cuda, monkeypatch):
    """The collector is off while a step is captured (a graph it freed
    then -- an old runner's, whose Simulation sits in a reference cycle
    -- would reset mid-capture and invalidate the capture), and on again
    after."""
    import gc
    from fbpic_tpu_torch.core import step as step_module
    real = step_module.gather_fields_sorted
    seen = []

    def record(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return real(*args, **kwargs)

    monkeypatch.setattr(step_module, "gather_fields_sorted", record)
    old = _golden_config_sim(cuda, torch.float32)
    old.step(3)
    del old                         # garbage in a cycle, with its graphs
    sim = _golden_config_sim(cuda, torch.float32)
    assert gc.isenabled()
    sim.step(3)
    assert seen and not any(seen)
    assert gc.isenabled()


# ---------------------------------------------------------------------
# The chunk runner's new paths on the card: antennas, mirrors, external
# fields, rings, cubic shapes, cross-deposition, the BTD capture
# ---------------------------------------------------------------------

class _deterministic:
    """torch's deterministic algorithms while the block runs (index_add_
    a sorted segment sum, not float atomics; other ops warn only; new
    memory not filled): the scatter deposits give the same bits in every
    run, so a graphed run and its eager twin can be held bit for bit."""

    def __enter__(self):
        import torch.utils.deterministic as det
        self.prev = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     det.fill_uninitialized_memory)
        torch.use_deterministic_algorithms(True, warn_only=True)
        det.fill_uninitialized_memory = False

    def __exit__(self, *exc):
        import torch.utils.deterministic as det
        torch.use_deterministic_algorithms(self.prev[0],
                                           warn_only=self.prev[1])
        det.fill_uninitialized_memory = self.prev[2]


def _eager_loop(sim, n):
    """Simulation.step(n) through the eager loop (``_run_eager``), the
    antennas and the capturing diagnostics included."""
    from fbpic_tpu_torch.core.step import prepare
    options = sim.build_options()
    sim.state = prepare(sim.config, options, sim.species_configs, sim.state,
                        sim.aux)
    for diag in sim.diags:
        diag.write(sim)
    writers = list(sim.diags) + list(sim.checkpoints)
    capture = [w for w in writers if hasattr(w, "capture")]
    sim._run_eager(n, options, capture,
                   [w for w in writers if w not in capture], None)
    for w in capture:
        w.process_captures(sim)
    sim._consume_overflow_counters()


def _cross_periodic_sim(device):
    """Cross-deposition in a periodic box (no exchange step: every step
    is replayed), float32, a uniform plasma and an a0 = 0.5 laser."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    sim = Simulation(64, 8.e-6, 16, 10.e-6, 2, 8.e-6 / 64 / c, zmin=0.,
                     n_order=16, current_correction="cross-deposition",
                     boundaries={"z": "periodic", "r": "reflective"},
                     random_seed=0, verbose_level=0, device=device,
                     dtype=torch.float32)
    sim.add_new_species(q=-e, m=m_e, n=5.e24, p_zmin=0., p_zmax=8.e-6,
                        p_rmin=0., p_rmax=9.e-6, p_nz=1, p_nr=2, p_nt=4)
    add_laser_pulse(sim, GaussianLaser(a0=0.5, waist=4.e-6, tau=8.e-15,
                                       z0=4.e-6))
    return sim


def _graph_path_sim(device, case):
    """The configuration of one new graphed path: "antenna_mirror" (an
    antenna in vacuum and a mirror), "mirror_ext" (a resident plasma, a
    mirror and an external Ez), "ring" (float32 scatter rings), "btd"
    (the smoke boosted box, float64, with 20 BTD snapshots),
    "cubic_pml" (a cubic ring with the radial PML) or "cross_periodic"."""
    from fbpic_tpu_torch.lpa_utils import Mirror
    if case == "antenna_mirror":
        sim = _lpa_window_sim(device, torch.float32, "antenna")
        sim.mirrors.append(Mirror(z_lab=11.e-6, n_cells=2))
    elif case == "mirror_ext":
        sim = _lpa_window_sim(device, torch.float32, "mirror_ext")
    elif case == "ring":
        sim = _ring_window_sim(device, "scatter", torch.float32)
    elif case == "btd":
        from fbpic_tpu_torch.constants import c
        from fbpic_tpu_torch.diagnostics import \
            BackTransformedFieldDiagnostic
        sim = _boosted_smoke_sim(device)
        import tempfile
        btd = BackTransformedFieldDiagnostic(-40.e-6, 0., c, 50.e-15, 20,
                                             10., sim=sim,
                                             write_dir=tempfile.mkdtemp())
        btd.write_records = lambda records: None
        sim.diags.append(btd)
    elif case == "cubic_pml":
        sim = _window_variant_sim(device, torch.float32, "cubic_pml")
    else:
        sim = _cross_periodic_sim(device)
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["antenna_mirror", "mirror_ext", "ring",
                                  "btd", "cubic_pml", "cross_periodic"])
def test_new_graph_paths_equal_their_eager_twin(cuda, case):
    """9 steps through Simulation.step (exchange steps' blocks eager --
    the seeded angle source keeps them so --, every step captured under
    sync debug mode "error" and replayed) against the eager loop, under
    deterministic index_add_: every tensor equal bit for bit, rho_prev
    too; with the BTD every captured row the runner brought back equal
    to the eager loop's buffer, and the snapshots."""
    from fbpic_tpu_torch.core.graph import graph_blockers, state_tensors
    with _deterministic():
        graphed, twin = (_graph_path_sim(cuda, case) for _ in range(2))
        assert graph_blockers(graphed, graphed.build_options()).loop == []
        caps = {}
        for key, sim in (("graphed", graphed), ("eager", twin)):
            for diag in sim.diags:
                real = diag.process_chunk
                caps[key] = []

                def record(s, c_, real=real, out=caps[key]):
                    out.append([np.array(a) for a in c_])
                    return real(s, c_)
                diag.process_chunk = record
        graphed.step(9)
        _eager_loop(twin, 9)
        torch.cuda.synchronize()
    assert graphed._multi_step.graphs
    assert (graphed.state.iteration, float(graphed.state.zmin),
            float(graphed.state.time)) == (twin.state.iteration,
                                           float(twin.state.zmin),
                                           float(twin.state.time))
    for i, (x, y) in enumerate(zip(state_tensors(graphed.state),
                                   state_tensors(twin.state))):
        assert torch.equal(x, y), i
    if case == "btd":
        rows = [np.concatenate(a) for a in zip(*caps["graphed"])]
        want = [np.concatenate(a) for a in zip(*caps["eager"])]
        assert rows[0].shape[0] == 10           # the write's and 9 steps
        for a, b in zip(rows, want):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(graphed.diags[0].snapshots, twin.diags[0].snapshots):
            np.testing.assert_array_equal(a.filled, b.filled)
            for name in a.names:
                np.testing.assert_array_equal(a.data[name], b.data[name])


@pytest.mark.cuda
def test_antenna_series_are_computed_for_the_card(cuda, monkeypatch):
    """The antenna's series of a card run are made for the card (the
    required ``device`` keyword) and copied into the chunk runner's
    static buffer there."""
    from fbpic_tpu_torch.lpa_utils.laser import antenna_injection as ai
    devices = []
    series = ai.LaserAntenna.compute_series

    def record(self, t0, n_steps, dz, **kw):
        devices.append(torch.device(kw["device"]).type)
        out = series(self, t0, n_steps, dz, **kw)
        assert out.J.device.type == "cuda"
        return out
    monkeypatch.setattr(ai.LaserAntenna, "compute_series", record)
    sim = _lpa_window_sim(cuda, torch.float32, "antenna")
    sim.step(6)
    assert devices and set(devices) == {"cuda"}
    assert sim._multi_step._series[0].device.type == "cuda"
    with pytest.raises(TypeError):
        series(sim.laser_antennas[0], 0., 2, sim.config.dz)


# ---------------------------------------------------------------------
# The chunk runner with ionization, Compton scattering and a ballistic
# species (their draws from a generator registered with the graphs)
# ---------------------------------------------------------------------

#: tests/test_torch_multistep_processes.py's box: internal Nz 64, open
#: z, a window at c, exchange period 4
_PROC_KW = dict(zmin=-4.e-6, n_order=16, n_guard=8,
                n_damp={"z": 8, "r": 32},
                boundaries={"z": "open", "r": "reflective"},
                exchange_period=4, random_seed=0, verbose_level=0)
_PROC_PLASMA = dict(p_zmin=-3.e-6, p_zmax=100.e-6, p_rmin=0., p_rmax=9.e-6,
                    continuous_injection=True, sort_K=256)


def _process_graph_sim(device, case, draws=None):
    """tests/test_torch_multistep_processes.py's run on the card, float32:
    a resident plasma and an a0 = 0.5 laser, with (case "ionization")
    resident helium ions whose level-0 electrons go to a tracked ring
    and level-1 electrons to a tracked resident species, ("compton") a
    thermal gamma ~ 300 beam (a ring; at the CPU test's gamma ~ 3 the
    float32 cross-section cancels to zero) scattering into a photon ring
    in a uniform photon bath, or ("ballistic") a gamma = 100 bunch (a ring)
    whose injection plane z = 0 it crosses after 4-8 steps.  draws: a
    replacement for the default draw source, built on the generator."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, m_p
    from fbpic_tpu_torch.lpa_utils.bunch import add_particle_bunch
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    sim = Simulation(24, 2.e-6, 16, 10.e-6, 2, 6.e-6 / 24 / c,
                     device=device, dtype=torch.float32, **_PROC_KW)
    sim.add_new_species(q=-e, m=m_e, n=5.e24, p_nz=1, p_nr=2, p_nt=4,
                        **_PROC_PLASMA)
    if case == "ionization":
        ions = sim.add_new_species(q=e, m=4 * m_p, n=1.e24, p_nz=1,
                                   p_nr=1, p_nt=4, **_PROC_PLASMA)
        ring = sim.add_new_species(q=-e, m=m_e)
        resident = sim.add_new_species(q=-e, m=m_e, sort_K=256)
        ions.make_ionizable("He", {0: ring, 1: resident}, level_start=0)
        ring.track()
        resident.track()
    elif case == "compton":
        source = sim.add_new_species(
            q=-e, m=m_e, n=1.e24, p_nz=1, p_nr=1, p_nt=4, p_zmin=-3.e-6,
            p_zmax=0., p_rmin=0., p_rmax=3.e-6, uz_m=300., ux_th=0.05,
            uy_th=0.05, uz_th=0.05, continuous_injection=False)
        photons = sim.add_new_species(q=0., m=0.)
        source.activate_compton(photons, laser_energy=4.e6,
                                laser_wavelength=0.8e-6, laser_waist=1.e-3,
                                laser_ctau=1.e-2, laser_initial_z0=0.)
    else:
        add_particle_bunch(sim, -e, m_e, 100., 1.e24, -2.e-6, -1.e-6, 0.,
                           2.e-6, initialize_self_field=False,
                           z_injection_plane=0.)
    add_laser_pulse(sim, GaussianLaser(a0=0.5, waist=4.e-6, tau=8.e-15,
                                       z0=-1.e-6))
    sim.set_moving_window(v=c)
    sim.column_angles = _SeededAngles()
    if draws is not None:
        sim.process_draws = draws(sim.generator)
    return sim


def _process_twins_equal(graphed, twin):
    """Every tensor of the two states bit for bit, the host values and
    the generators' states (their Philox offsets) equal."""
    from fbpic_tpu_torch.core.graph import state_tensors
    a, b = graphed.state, twin.state
    assert (a.iteration, float(a.zmin), float(a.time)) == \
        (b.iteration, float(b.zmin), float(b.time))
    for i, (x, y) in enumerate(zip(state_tensors(a), state_tensors(b))):
        assert torch.equal(x, y), i
    assert torch.equal(graphed.generator.get_state(),
                       twin.generator.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ionization", "compton", "ballistic"])
def test_process_graph_paths_equal_their_eager_twin(cuda, case):
    """14 steps through Simulation.step (the exchange steps eager, the
    others replayed, the processes' draws from the registered
    generator) against the eager loop, under deterministic index_add_:
    every tensor bit for bit, the created particles, levels, ids and
    cursors among them, and the generator's offset; the kernels counted
    per replay as the eager loop launches them; particles created
    (ionization, Compton) or the plane crossed (ballistic)."""
    from fbpic_tpu_torch.core.graph import graph_blockers
    from fbpic_tpu_torch.particles import cuda_fused, cuda_gather
    counters = (cuda_fused.fused_onehot_contract, cuda_gather.gather_sorted)
    with _deterministic():
        graphed, twin = (_process_graph_sim(cuda, case) for _ in range(2))
        assert graph_blockers(graphed, graphed.build_options()).loop == []
        before = int(((graphed.state.species[1].z <= 0.)
                      & (graphed.state.species[1].w != 0)).sum())
        launches = []
        for run in (graphed.step, lambda n: _eager_loop(twin, n)):
            n0 = [fn.launches for fn in counters]
            run(14)
            launches.append([fn.launches - n for fn, n in zip(counters,
                                                              n0)])
        torch.cuda.synchronize()
    assert graphed._multi_step.graphs
    assert launches[0] == launches[1] and launches[0][0] >= 14
    _process_twins_equal(graphed, twin)
    sp = graphed.state.species
    if case == "ionization":
        assert int((sp[2].w != 0).sum()) > 0 and int((sp[3].w != 0).sum()) > 0
    elif case == "compton":
        assert int((sp[2].w != 0).sum()) > 0
    else:
        assert before == int((sp[1].w != 0).sum()) > 0
        assert int(((sp[1].z <= 0.) & (sp[1].w != 0)).sum()) == 0


class _RecordedDraws(GeneratorDraws):
    """The default draw source (a subclass of it, so the chunk runner
    replays it), keeping a copy of its last ionization draw of each
    species in a buffer made at the first (eager) call: a replay writes
    its own draw there."""

    def __init__(self, generator):
        super().__init__(generator)
        self.last = {}

    def __call__(self, name, iteration, species_index, shape, dtype,
                 rank=None):
        u = super().__call__(name, iteration, species_index, shape, dtype)
        if name == "ionize":
            if species_index not in self.last:
                self.last[species_index] = torch.empty_like(u)
            self.last[species_index].copy_(u)
        return u


@pytest.mark.cuda
def test_replays_draw_the_eager_runs_numbers(cuda):
    """One step a call through Simulation.step and the eager loop: each
    replay draws new numbers (the generator registered with the graph),
    the eager twin's at the same iteration, and the generator's state
    after each call equals the twin's."""
    graphed, twin = (_process_graph_sim(cuda, "ionization",
                                        draws=_RecordedDraws)
                     for _ in range(2))
    draws = []
    for _ in range(7):
        graphed.step(1)
        _eager_loop(twin, 1)
        torch.cuda.synchronize()
        a, b = graphed.process_draws.last[1], twin.process_draws.last[1]
        assert torch.equal(a, b), graphed.iteration
        assert torch.equal(graphed.generator.get_state(),
                           twin.generator.get_state())
        draws.append(a.clone())
    assert sorted(graphed._multi_step.graphs) == [(1, False, False),
                                                  (1, True, False)]
    # iteration 0 (an exchange step: its block eager, the rest fully
    # re-sorted) and 1 are their variants' warm-ups (the captures execute
    # nothing), 2-6 replays (4 the exchange step's rest)
    replayed = draws[2:]
    for x, y in zip(replayed, replayed[1:]):
        assert not torch.equal(x, y)


@pytest.mark.cuda
def test_ionizing_rollback_equals_the_eager_run(cuda):
    """A column overflow planted in the plasma of both ionizing twins
    before a call that starts on a non-exchange step: the chunk rolls
    back (the generator's state restored), runs again eagerly and equals
    the twin bit for bit, the created electrons and the draws included."""
    import warnings
    with _deterministic():
        graphed, twin = (_process_graph_sim(cuda, "ionization")
                         for _ in range(2))
        graphed.step(5)
        _eager_loop(twin, 5)
        for sim in (graphed, twin):
            sp, K = sim.state.species[0], sim.species_configs[0].sort_K
            Nz, dz = sim.config.Nz, sim.config.dz
            live = (sp.w != 0).reshape(Nz, K)
            counts = live.sum(1)
            row = int(torch.argmax(counts[:-2] + counts[1:-1]
                                   + counts[2:])) + 1
            assert int(counts[row - 1:row + 2].sum()) > K
            z = sp.z.clone().reshape(Nz, K)
            z[row - 1] = torch.where(live[row - 1], z[row - 1] + dz,
                                     z[row - 1])
            z[row + 1] = torch.where(live[row + 1], z[row + 1] - dz,
                                     z[row + 1])
            sim.state.species[0] = sp.replace(z=z.reshape(-1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            graphed.step(6)
            _eager_loop(twin, 6)
        torch.cuda.synchronize()
    assert graphed.overflow_totals["rollbacks"] == 1
    assert graphed.overflow_totals["sort_overflow"] \
        == twin.overflow_totals["sort_overflow"] > 0
    _process_twins_equal(graphed, twin)
    assert int((graphed.state.species[2].w != 0).sum()) > 0
