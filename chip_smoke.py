#!/usr/bin/env python3
"""Smoke run of fbpic_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  0. builds the CUDA kernels from fbpic_tpu_torch/csrc with nvcc (one
     nvcc per source, all started together);
  1. K1 (fused J + d(rho) deposit) against its plain PyTorch version at
     the LWFA bench shape, on particles drawn from a numpy seed (a third
     of them near or below the axis), with kernel, plain and library
     (torch.bmm of the one-hot matrix with V) times, the live fraction
     of the slots, the bound over the live slots (and, on the line
     before, over all slots), and two launches compared bit for bit;
  2. K2 (sorted field gather: geometry, staged corner fetch, mode sum
     and rotation in one launch) against its plain version on random
     particles at the LWFA shape: open and periodic z, float32 (5e-6)
     and float64 (1e-12), with and without Kahan words, the fields in
     both layouts the kernel reads, two launches bit for bit; kernel,
     plain and bound times (over the live slots; the operand-level
     all-slots figure on the line before), and torch's grid_sample of
     the field words at the live slots as context (fetch only, not the
     same function); one gather_fields_sorted call must be one device
     launch;
  3. the LWFA main path: the bench.py configuration (Nz=800, Nr=50,
     Nm=2, 16 particles per cell, a0=4 laser, moving window, continuous
     injection, open z, float32) through Simulation / add_laser_pulse /
     set_moving_window / step, with every kernel launch counter reset
     just before and read just after; ms/step, ns/particle/step,
     overflow counters, finite fields and exactly one K1 and one K2
     launch a step; then K1 and K2 once more on the operands of that
     running simulation (its resident layout: full and empty columns),
     the host synchronizations of one step (torch's CUDA sync debug
     mode), and a profiled window for the device time per step;
  4. the wake invariant of tests/test_golden_wake.py (on-axis wake
     wavelength within 15% of 2 pi c / omega_p) on the bench grid and
     plasma.  In the bench configuration the laser starts 2 um ahead of
     the window's left edge and rides with it, so its wake leaves the
     window; this phase starts the laser near the right edge instead
     (z0 = 24 um) and, as that test does, at a0 = 1 (the a0 = 4 wake is
     nonlinear and about 20% longer than 2 pi c / omega_p), then steps
     until the wake trails the laser over more than three zero
     crossings;
  5. K3 (one-hot dense deposit) against its plain version at the
     boosted-frame shape: the J window (offsets -2..1, 9 channels) and
     the rho window (-3..2, 3 channels), open and periodic z, float32
     (1e-5) and float64 (1e-12), with kernel, plain and library times
     and the bound;
  6. the boosted-frame main path: examples/boosted_frame_script.py:17-58
     as written (gamma_boost = 10, Nz = 2048, Nr = 50, Nm = 2, n_order =
     32, 2x2x4 particles per cell, Galilean v_comoving = -c beta_boost,
     a0 = 2 laser, open z, moving window, float32, no diagnostics) but
     with the plasma from the box's left edge (p_zmin = -40 um lab; the
     published empty box selects a layout the port does not run yet):
     5 + 60 steps with exactly 2 K3 launches, 1 K2 launch and no K1
     launch per step, zero overflow, finite fields; then K3 and K2 once
     more on the operands of that running simulation, the host
     synchronizations of one step, and a profiled window for the device
     time per step;
  7. the numerical Cherenkov gate of tests/test_boosted.py (Nz = 40,
     Nr = 20, a gamma = 130 plasma and its ions flowing through a
     periodic box, 570 + 30 steps): slope_standard > 3.5 slope_galilean
     in float64 (the resident layout forced by sort_K, so K3's double
     instantiation runs); the float32 slopes are printed, not gated;
  8. the non-resident (ring) species paths, each driven with every
     kernel count set to 0 just before and read just after:
     - the bench LWFA with a ring of 2**21 slots, above Nz * sort_K
       (run after phase 3): sorted afresh at the mid positions every
       step, exactly one K1 and no K2 launch a step, timed beside the
       resident run; K1 held against its plain version on one step's
       operands, the host syncs of one step and a profiled window;
     - the same ring in float64 (K3 for J and rho) and the legacy plan
       (use_fused_deposit off: deposit_J_sorted / deposit_rho_sorted, K3
       on the idx plan), 12 steps each, exactly two K3 launches a step,
       each step's K3 calls held against their plain version to 1e-12
       and timed;
     - the published boosted script as written (after phase 6): the
       empty box (p_zmin = 0 lab), so sort_K = 0 and the species a
       ring; stepped until the plasma, streaming in at about 2c
       relative to the window, fills the box, then 60 timed steps with
       no kernel launch at all (linear gather, scatter deposits, ring
       writes: PyTorch ops); ms/step, ns/particle/step, the live count
       beside the count reckoned for a full box, zero ring overwrite,
       finite fields, the host syncs of one step and a profiled window
       (device busy, idle share, launches, the largest device rows).

Prints the card's name and power limit, a {"kernels": [...]} line and,
last, {"ok": true, "device": {...}}.  Exits non-zero without a result
when no CUDA device is available.
"""
import json
import subprocess
import sys
import time

import numpy as np

# The bench.py LWFA configuration
NZ, NR, NM = 800, 50, 2
ZMAX, ZMIN, RMAX = 30.e-6, -10.e-6, 20.e-6
P_ZMIN, P_ZMAX, P_RMAX = 0.e-6, 500.e-6, 18.e-6
N_E = 4.e24
P_NZ, P_NR, P_NT = 2, 2, 4
A0, W0, TAU, Z0 = 4.0, 5.e-6, 16.7e-15, -8.e-6
N_WARMUP, N_TIMED = 5, 60
# Wake invariant: laser near the right edge at a0 = 1, steps for ~1.7
# plasma wavelengths of wake behind it (dz = 0.05 um, lambda_p = 16.7 um)
WAKE_Z0, WAKE_A0, WAKE_STEPS = 24.e-6, 1.0, 560

# The boosted-frame LWFA of examples/boosted_frame_script.py:17-58 (the
# plasma from the box's left edge, -40 um lab, instead of 0)
B_GAMMA = 10.
B_NZ, B_ZMAX_LAB, B_ZMIN_LAB = 2048, 0.e-6, -40.e-6
B_NR, B_RMAX, B_NM, B_N_ORDER = 50, 40.e-6, 2, 32
B_N_E_LAB = 1.e24
B_P_ZMIN_LAB, B_P_ZMAX_LAB, B_P_RMAX = -40.e-6, 2000.e-6, 35.e-6
B_PPC = (2, 2, 4)
B_LASER = dict(a0=2., waist=10.e-6, tau=30.e-15, z0=-15.e-6)
N_PROFILED = 10
#: The port's kernels as the profiler names them
PORT_KERNELS = {"K1": "fused_contract_kernel", "K2": "gather_sorted_kernel",
                "K3": "dense_contract_kernel"}
# The numerical Cherenkov configuration of tests/test_boosted.py
NCI_STEPS = (570, 30)
NCI_RATIO = 3.5
# The published boosted script as written starts with an empty box
# (p_zmin = 0 lab): the species is a ring, sort_K = 0
B_P_ZMIN_PUBLISHED = 0.
# The bench LWFA with a ring above Nz * sort_K (1116 x 1152 = 1,285,632):
# sorted afresh at the mid positions every step, not resident
LWFA_RING_CAPACITY = 2**21
# Steps of the float64 fresh-sort and legacy-plan runs
N_SMALL = 10

# Tolerances, relative to each output part's largest |value|: a kernel
# sums in another order than its plain version (GEMM, index_add_)
TOL_K1 = 1e-5
TOL_K2 = {"float32": 5e-6, "float64": 1e-12}
TOL_K3 = {"float32": 1e-5, "float64": 1e-12}

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
# cores (the bound of a kernel is the larger of bytes / rate and
# operations / rate)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# float64 outside the tensor cores (the same data sheet)
FP64_FLOP_PER_S = 34e12
DEVICE = "cuda"


def cuda_ms(fn, n_warm=3, n_iter=20):
    """Mean device time of fn() over n_iter launches (CUDA events).  The
    launches are queued behind a sleep kernel that outlasts their host
    time, so the events time the device running them back to back, not
    the rate at which the host launches them (a wrapper's Python can
    take longer than a small kernel)."""
    import torch
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0    # one call, host and device
    torch.cuda._sleep(int(min(2.0 * n_iter * host_s, 1.0) * 2e9))  # cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def bound(n_bytes, n_flops, flop_rate=FP32_FLOP_PER_S):
    """Least time (ms) the card needs to move n_bytes and do n_flops (at
    flop_rate: float32 by default), and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flop_rate * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def onehot_bmm(ir_buf, V, Nrb):
    """The library yardstick of K1 and K3: the prebuilt one-hot matrix
    S (Nz, Nrb, K) times V (Nz, K, W) as one torch.bmm call (TF32 off),
    and the time of that call."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    S = torch.nn.functional.one_hot(ir_buf.long(), Nrb).to(V.dtype)
    S = S.transpose(1, 2).contiguous()
    out = torch.bmm(S, V)
    ms = cuda_ms(lambda: torch.bmm(S, V))
    return out, ms


def make_sim(z0=Z0, a0=A0, dtype=None, capacity=None, fused=True):
    """The bench LWFA.  capacity: of the plasma species (above Nz *
    sort_K: a ring sorted afresh every step, not resident); fused:
    use_fused_deposit (False with sort_K > 0: the legacy plan)."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    dt = (ZMAX - ZMIN) / NZ / c
    sim = Simulation(
        NZ, ZMAX, NR, RMAX, NM, dt, zmin=ZMIN, n_order=32,
        boundaries={"z": "open", "r": "reflective"}, random_seed=0,
        device=DEVICE, dtype=dtype or torch.float32)
    sim.use_fused_deposit = fused
    sim.add_new_species(q=-e, m=m_e, n=N_E, p_zmin=P_ZMIN, p_zmax=P_ZMAX,
                        p_rmin=0., p_rmax=P_RMAX, p_nz=P_NZ, p_nr=P_NR,
                        p_nt=P_NT, capacity=capacity)
    add_laser_pulse(sim, GaussianLaser(a0=a0, waist=W0, tau=TAU, z0=z0))
    sim.set_moving_window(v=c)
    return sim


def random_sorted_particles(sim, seed=23, dtype=None):
    """Particles from a numpy seed, column-sorted at the sim's shape."""
    import torch
    from fbpic_tpu_torch.particles.sorted_deposit import build_column_sort
    cfg = sim.config
    K = sim.species_configs[0].sort_K
    rng = np.random.RandomState(seed)
    Np = int(0.55 * K * cfg.Nz)
    z = sim.zmin + rng.uniform(0.0, cfg.Nz * cfg.dz, Np)
    r = np.where(rng.rand(Np) < 0.35, rng.uniform(0, 1.5 * cfg.dr, Np),
                 rng.uniform(0, 0.99 * cfg.rmax, Np))
    th = rng.uniform(0, 2 * np.pi, Np)
    w = rng.uniform(0.5, 1.5, Np) * 1e9
    w[rng.rand(Np) < 0.1] = 0.0
    ux, uy, uz = rng.randn(3, Np) * 0.5
    ig = 1 / np.sqrt(1 + ux ** 2 + uy ** 2 + uz ** 2)
    arrs = [torch.as_tensor(a, dtype=dtype or torch.float32, device=DEVICE)
            for a in (r * np.cos(th), r * np.sin(th), z, w, ux, uy, uz, ig)]
    sort = build_column_sort(arrs[2], arrs[3], sim.zmin, 1 / cfg.dz,
                             cfg.Nz, K, arrs)
    if int(sort["n_over"]) != 0:
        raise RuntimeError("random particles overflow the columns")
    pad = list(sort["padded"])
    pad[3] = torch.where(sort["valid"], pad[3], torch.zeros_like(pad[3]))
    return sort, pad


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def live_fraction(ok):
    """(live slots, all slots) of a layout from its z-weight mask."""
    return int((ok != 0).sum()), ok.numel()


def assert_bitwise_repeatable(fn, what):
    """Two launches on the same operands must give the same bits."""
    import torch
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise RuntimeError(f"{what}: two launches differ bit for bit")
    return a


def measure_k1(ops, label):
    """K1 on `ops` against its plain version and the one-hot bmm: errors,
    times, live fraction and bounds."""
    import torch
    from fbpic_tpu_torch.particles import cuda_fused
    kern = assert_bitwise_repeatable(
        lambda: cuda_fused.fused_onehot_contract(**ops), f"K1 ({label})")
    plain = cuda_fused.fused_onehot_contract_plain(**ops)
    torch.cuda.synchronize()
    Nz, K, CJ = ops["channels"].shape
    CD, nJ, nD = ops["dph"].shape[2], ops["n_offJ"], ops["n_offD"]
    W_J = nJ * 2 * CJ
    W_D = kern.shape[2] - W_J
    errs = [rel_err(kern[..., :W_J], plain[..., :W_J]),
            rel_err(kern[..., W_J:], plain[..., W_J:])]
    max_abs = float((kern - plain).abs().max())
    n_live, n_slots = live_fraction(ops["geom"]["ok"])
    print(f"K1 {label}: Nz={Nz} K={K} Nrb={kern.shape[1]} W={kern.shape[2]}, "
          f"{n_live} of {n_slots} slots live ({n_live / n_slots:.4f}); rel "
          f"err J={errs[0]:.3e} drho={errs[1]:.3e} (tol {TOL_K1}); two "
          f"launches bit-equal", flush=True)
    if not all(np.isfinite(errs)) or max(errs) > TOL_K1:
        raise RuntimeError(f"K1 ({label}) disagrees with its plain version: "
                           f"{errs}")
    ms = cuda_ms(lambda: cuda_fused.fused_onehot_contract(**ops))
    plain_ms = cuda_ms(lambda: cuda_fused.fused_onehot_contract_plain(**ops),
                       n_warm=1, n_iter=5)
    # Bound.  Per slot the kernel's operands are CJ channels, nJ z weights,
    # 5 rows (sr0_m0, sr0_mh, u_a, u_b, wj), CD d(phase) + CD phase
    # channels and 2 nD endpoint z weights in float32, 2 int64 indices and
    # a bool; the mask row `ok` is read for every slot, the rest for the
    # live slots only (what these inputs need), the output written once.
    # Per live slot 3 operations for each J output and ~17 for each d(rho)
    # output.  The all-slots figure counts the 42 words a slot of the
    # operand copies the kernel read before it took them in place.
    slot_bytes = 4 * (CJ + nJ + 5 + 2 * CD + 2 * nD) + 2 * 8 + 1
    n_bytes = n_live * slot_bytes + 4 * n_slots + 4 * kern.numel()
    n_flops = n_live * (3 * W_J + 17 * W_D)
    bound_ms, bound_by = bound(n_bytes, n_flops)
    all_bytes = (n_slots * (4 * (CJ + nJ + 6 + 2 * CD + 2 * nD) + 8)
                 + 4 * kern.numel())
    all_ms, all_by = bound(all_bytes, n_flops)
    V = torch.cat(cuda_fused.fused_blocks(
        ops["geom"], ops["channels"], ops["meta"], ops["span"], ops["dph"],
        ops["ph_b"], ops["wj"], ops["ruyten"], ops["Nm"], ops["n_offD"]),
        dim=2)
    lib_out, library_ms = onehot_bmm(ops["geom"]["ir_buf"], V, kern.shape[1])
    lib_err = rel_err(lib_out, plain)
    del V, lib_out
    print(f"K1 {label} bound, all slots: {all_ms:.4f} ms by {all_by} "
          f"({all_bytes} bytes)", flush=True)
    print(f"K1 {label} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (bmm) {library_ms:.4f} ms (rel err {lib_err:.2e}), bound "
          f"over live slots {bound_ms:.4f} ms by {bound_by} ({n_bytes} "
          f"bytes), live fraction {n_live / n_slots:.4f}", flush=True)
    return dict(max_abs_err=max_abs, rel_err=max(errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, live_fraction=n_live / n_slots,
                bound_all_slots_ms=all_ms)


def phase_k1(sim):
    from fbpic_tpu_torch.constants import e
    from fbpic_tpu_torch.particles.sorted_deposit import (
        fused_contract_operands)
    cfg = sim.config
    sort, pad = random_sorted_particles(sim)
    x, y, z, w, ux, uy, uz, ig = pad
    ops = fused_contract_operands(
        dict(valid=sort["valid"], padded=pad), x, y, z, w, -e, ux, uy, uz,
        ig, dt_half=0.5 * cfg.dt, Nm=cfg.Nm, invdz=1 / cfg.dz, zmin=sim.zmin,
        Nz=cfg.Nz, invdr=1 / cfg.dr, rmin=0.0, Nr=cfg.Nr,
        ruyten_linear=sim.aux.ruyten_linear, zfold="clamp",
        sort_at_start=True)
    return dict(name="K1 fused J+drho deposit", route="cuda",
                source="fbpic_tpu_torch/csrc/fused_deposit.cu",
                replaces="fbpic_tpu/particles/pallas_fused.py:78",
                **measure_k1(ops, "random half-full layout"))


def capture_calls(sim, module, name):
    """The (args, kwargs) of every call of module.<name> (a kernel
    wrapper, or the function of the step that calls one) during one more
    step of the running simulation."""
    real = getattr(module, name)
    calls = []

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, recorder)
    try:
        sim.step(1)
    finally:
        setattr(module, name, real)
    if not calls:
        raise RuntimeError(f"the step did not call {name}")
    return calls


def phase_k1_resident(sim):
    """K1 on the operands of the running LWFA simulation."""
    import inspect
    from fbpic_tpu_torch.particles import cuda_fused, sorted_deposit
    (args, kwargs), = capture_calls(sim, sorted_deposit,
                                    "fused_onehot_contract")
    ops = inspect.signature(cuda_fused.fused_onehot_contract_plain).bind(
        *args, **kwargs).arguments
    return measure_k1(dict(ops), "resident LWFA layout")


def grid_sample_fetch_ms(ops):
    """CUDA-event time of torch.nn.functional.grid_sample of the 12 Nm
    field words at the live slots' cell coordinates (bilinear): the
    4-corner fetch alone, not the same function as K2 (no signed guard
    row, no periodic rows, no mode sum, no rotation).  Context for K2's
    time, not its library call."""
    import torch
    from fbpic_tpu_torch.particles.cuda_gather import FIELD_NAMES
    fields = [getattr(ops["interp"], n) for n in FIELD_NAMES]
    Nm, Nz, Nr = fields[0].shape
    img = torch.stack([f.real for f in fields] + [f.imag for f in fields])
    img = img.reshape(1, 12 * Nm, Nz, Nr).contiguous()
    live = ops["valid"]
    x, y, z = (ops[k][live] for k in ("xp", "yp", "zp"))
    rc = (torch.sqrt(x * x + y * y) - ops["rmin"]) * ops["invdr"] - 0.5
    zc = (z - ops["zmin"]) * ops["invdz"] - 0.5
    grid = torch.stack([2 * rc / (Nr - 1) - 1, 2 * zc / (Nz - 1) - 1],
                       dim=-1)[None, None]
    return cuda_ms(lambda: torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", align_corners=True))


def measure_k2(ops, label, timed):
    """K2 on `ops` (the keyword arguments of gather_sorted) against its
    plain version: errors and two launches bit for bit; with `timed`,
    also the times, the bounds and the grid_sample fetch."""
    import torch
    from fbpic_tpu_torch.particles import cuda_gather
    tname = str(ops["xp"].dtype).split(".")[-1]
    kern = assert_bitwise_repeatable(
        lambda: torch.stack(cuda_gather.gather_sorted(**ops)),
        f"K2 ({label})")
    plain = torch.stack(cuda_gather.gather_sorted_plain(**ops))
    torch.cuda.synchronize()
    # Ex and Ey (Bx and By) are one rotation of the same (Fr, Ft), so
    # their rounding scales with the pair's largest value, not each
    # component's: a linearly polarized laser leaves Ey ~ 0 where Fr and
    # Ft are large.  Ez and Bz are held against their own.
    scale = [max(float(plain[q].abs().max()) for q in grp)
             for grp in ((0, 1), (0, 1), (2,), (3, 4), (3, 4), (5,))]
    diff = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
    errs = [d / max(s, 1e-30) for d, s in zip(diff, scale)]
    own = [rel_err(a, b) for a, b in zip(kern, plain)]
    valid = ops["valid"]
    n_live, n_slots = live_fraction(valid)
    print(f"K2 {label}, {tname}, {ops.get('zfold', 'periodic')} z, "
          f"{'with' if ops.get('comp') is not None else 'without'} Kahan "
          f"words: Nz={valid.shape[0]} K={valid.shape[1]}, {n_live} of "
          f"{n_slots} slots live ({n_live / n_slots:.4f}); rel err per "
          f"component {['%.2e' % e for e in errs]} (tol {TOL_K2[tname]}; "
          f"against each component's own largest value "
          f"{['%.2e' % e for e in own]}); two launches bit-equal",
          flush=True)
    if not all(np.isfinite(errs)) or max(errs) > TOL_K2[tname]:
        raise RuntimeError(f"K2 ({label}) disagrees with its plain version: "
                           f"{errs}")
    out = dict(rel_err=max(errs), max_abs_err=max(diff),
               live_fraction=n_live / n_slots)
    del kern, plain
    if not timed:
        return out
    ms = cuda_ms(lambda: cuda_gather.gather_sorted(**ops))
    plain_ms = cuda_ms(lambda: cuda_gather.gather_sorted_plain(**ops),
                       n_warm=1, n_iter=5)
    # Bound.  The valid flag and the six outputs of every slot, x, y, z
    # (and the Kahan words) of the live slots, each read once, and the
    # six complex fields once; per live slot ~36 + 126 Nm operations (the
    # geometry, 4 corners x 12 Nm multiply-adds, the mode sum, the
    # rotation).  The all-slots figure is the operand-level one: the 2
    # int32 and 5 float words a slot that the operand build wrote and the
    # kernel read, the 6 outputs, and the guarded field table.
    fields = [getattr(ops["interp"], n) for n in cuda_gather.FIELD_NAMES]
    Nm, Nz, Nr = fields[0].shape
    esize = ops["xp"].element_size()
    words = 3 if ops.get("comp") is None else 6
    n_bytes = (n_slots * (1 + 6 * esize) + n_live * words * esize
               + sum(t.numel() * t.element_size() for t in fields))
    n_flops = n_live * (36 + 126 * Nm)
    bound_ms, bound_by = bound(n_bytes, n_flops)
    all_bytes = n_slots * (8 + 11 * esize) + esize * Nz * (Nr + 1) * 12 * Nm
    all_ms, all_by = bound(all_bytes, n_flops)
    fetch_ms = grid_sample_fetch_ms(ops)
    print(f"K2 {label} bound, all slots (operand level): {all_ms:.4f} ms by "
          f"{all_by} ({all_bytes} bytes)", flush=True)
    print(f"K2 {label}: grid_sample of the {12 * Nm} field words at the "
          f"{n_live} live slots {fetch_ms:.4f} ms (fetch only, not the same "
          f"function)", flush=True)
    print(f"K2 {label} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound over live slots {bound_ms:.4f} ms by {bound_by} ({n_bytes} "
          f"bytes), live fraction {n_live / n_slots:.4f}; no single library "
          f"call", flush=True)
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bound_all_slots_ms=all_ms,
               grid_sample_fetch_ms=fetch_ms)
    return out


def device_launches(fn):
    """Kernels (and copies) the device ran for fn(), from torch.profiler;
    None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and ev.self_device_time_total > 0]
    return sum(ev.count for ev in evs) if evs else None


def phase_k2(sim):
    """K2 against its plain version on random column-sorted particles at
    the LWFA shape: float32 and float64, open and periodic z, with and
    without Kahan words (the periodic case with Kahan words reads the
    fields in the z-fastest layout torch.fft leaves), two launches
    bit-equal each; times and bounds of the float32 open-z call without
    Kahan words, where one gather_fields_sorted call must also be exactly
    one device launch."""
    import torch
    from fbpic_tpu_torch.fields.solver import InterpFields
    from fbpic_tpu_torch.particles.cuda_gather import FIELD_NAMES
    from fbpic_tpu_torch.particles.gather import gather_fields_sorted
    cfg = sim.config
    worst, max_abs, timed = {}, 0.0, None
    for dtype in (torch.float32, torch.float64):
        tname = str(dtype).split(".")[-1]
        sort, pad = random_sorted_particles(sim, seed=31, dtype=dtype)
        rng = np.random.RandomState(31)
        slot = tuple(sort["valid"].shape)
        comp = [torch.as_tensor(rng.randn(*slot) * 1e-3 * cfg.dz,
                                dtype=dtype, device=DEVICE)
                for _ in range(3)]
        shape = (cfg.Nm, cfg.Nz, cfg.Nr)
        interp = InterpFields(**{
            n: torch.complex(*(torch.as_tensor(rng.randn(*shape),
                                               dtype=dtype, device=DEVICE)
                               for _ in range(2)))
            for n in FIELD_NAMES})
        z_fast = InterpFields(**{
            n: getattr(interp, n).transpose(1, 2).contiguous()
            .transpose(1, 2) for n in FIELD_NAMES})
        for zfold in ("clamp", "periodic"):
            for with_comp in (False, True):
                ops = dict(xp=pad[0], yp=pad[1], zp=pad[2],
                           valid=sort["valid"], interp=interp,
                           rmax_gather=cfg.rmax, invdz=1 / cfg.dz,
                           zmin=sim.zmin, Nz=cfg.Nz, invdr=1 / cfg.dr,
                           rmin=0.0, Nr=cfg.Nr,
                           comp=comp if with_comp else None, zfold=zfold)
                if zfold == "periodic" and with_comp:
                    ops["interp"] = z_fast
                is_timed = (dtype == torch.float32 and zfold == "clamp"
                            and not with_comp)
                m = measure_k2(ops, "random half-full layout", is_timed)
                max_abs = max(max_abs, m["max_abs_err"])
                worst[tname] = max(worst.get(tname, 0.0), m["rel_err"])
                if not is_timed:
                    continue
                timed = m
                args = [ops[k] for k in ("xp", "yp", "zp", "valid", "interp",
                                         "rmax_gather", "invdz", "zmin", "Nz",
                                         "invdr", "rmin", "Nr")]
                n_dev = device_launches(
                    lambda: gather_fields_sorted(*args, zfold=zfold))
                print(f"K2: one gather_fields_sorted call ran {n_dev} device "
                      f"kernel(s)", flush=True)
                if n_dev not in (1, None):
                    raise RuntimeError(f"gather_fields_sorted ran {n_dev} "
                                       f"device kernels, not 1")
        del sort, pad, comp, interp, z_fast, ops
        torch.cuda.empty_cache()
    return dict(name="K2 sorted field gather", route="cuda",
                source="fbpic_tpu_torch/csrc/gather.cu",
                replaces="fbpic_tpu/particles/pallas_gather.py:80",
                max_abs_err=max_abs, rel_err=worst["float32"],
                rel_err_f64=worst["float64"], library_ms=None,
                **{k: timed[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "live_fraction", "bound_all_slots_ms",
                    "grid_sample_fetch_ms")})


def phase_k2_resident(sim, label):
    """K2 on the operands of the running simulation's own gather."""
    import inspect
    from fbpic_tpu_torch.core import step
    from fbpic_tpu_torch.particles import cuda_gather
    (args, kwargs), = capture_calls(sim, step, "gather_fields_sorted")
    ops = inspect.signature(cuda_gather.gather_sorted).bind(
        *args, **kwargs).arguments
    m = measure_k2(dict(ops), label, True)
    return {k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "live_fraction", "bound_all_slots_ms",
                              "grid_sample_fetch_ms", "rel_err")}


def count_syncs(sim, label):
    """Host synchronizations of one more step, as torch's CUDA sync
    debug mode reports them (a warning for every blocking call), by the
    line that made them."""
    import collections
    import os
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.step(1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in rec
        if "synchroniz" in str(w.message))
    n = sum(where.values())
    print(f"host syncs in one {label} step (torch.cuda sync debug mode): "
          f"{n} {dict(where)}", flush=True)
    return dict(count=n, where=dict(where))


def check_fields(sim, what):
    for name in ("Er", "Et", "Ez", "Br", "Bt", "Bz"):
        if not bool(getattr(sim.state.interp, name).isfinite().all()):
            raise RuntimeError(f"{what}: non-finite {name}")


def phase_main(sim, counters):
    import torch
    for fn in counters:
        fn.launches = 0
    t_first = time.perf_counter()
    sim.step(N_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(N_TIMED)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = [fn.launches for fn in counters]
    n_steps = N_WARMUP + N_TIMED
    wall = t1 - t0
    # bench.py's particle count: the plasma filling the box
    n_particles = int(NZ * (P_RMAX / RMAX * NR) * P_NZ * P_NR * P_NT)
    live = sim.ptcl[0].Ntot
    print(f"main path: {n_steps} steps ({N_WARMUP} warm-up, first in "
          f"{t0 - t_first:.2f} s incl. setup of the step), "
          f"{wall / N_TIMED * 1e3:.4f} ms/step, "
          f"{wall * 1e9 / (N_TIMED * n_particles):.4f} ns/particle/step "
          f"({n_particles} particles by bench.py's count, {live} live); "
          f"Nz={sim.config.Nz} K={sim.species_configs[0].sort_K}",
          flush=True)
    print(f"launches during the main path: K1 {launches[0]}, K2 "
          f"{launches[1]}; overflow totals {sim.overflow_totals}",
          flush=True)
    if launches != [n_steps, n_steps]:
        raise RuntimeError(f"K1 / K2 ran {launches} times in {n_steps} "
                           f"steps, not once a step each")
    if any(sim.overflow_totals.values()):
        raise RuntimeError(f"column/ring overflow: {sim.overflow_totals}")
    check_fields(sim, "main path")
    return launches, dict(ms_per_step=wall / N_TIMED * 1e3,
                          ns_per_particle_step=wall * 1e9
                          / (N_TIMED * n_particles))


def wake_wavelength(Ez_axis, dz):
    """tests/test_golden_wake.py's wavelength from the Ez zero crossings."""
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


def phase_wake():
    from fbpic_tpu_torch.constants import c, e, m_e
    sim = make_sim(z0=WAKE_Z0, a0=WAKE_A0)
    t0 = time.perf_counter()
    sim.step(WAKE_STEPS)
    Ez = sim.get_interp_field("Ez", 0).real[:, 0]
    check_fields(sim, "wake run")
    wp = np.sqrt(N_E * e**2 / (m_e * 8.8541878128e-12))
    lam_a = 2 * np.pi * c / wp
    lam = wake_wavelength(Ez, sim.config.dz)
    print(f"wake run: {WAKE_STEPS} steps in {time.perf_counter() - t0:.1f} "
          f"s; wavelength {lam} m vs 2 pi c / omega_p = {lam_a} m",
          flush=True)
    if lam is None or abs(lam / lam_a - 1) >= 0.15:
        raise RuntimeError(f"wake wavelength check failed: {lam} vs {lam_a}")
    return lam / lam_a


def make_boosted_sim(dtype=None, p_zmin_lab=B_P_ZMIN_LAB):
    """examples/boosted_frame_script.py:38-58 as written (lab-frame values
    in, converted by gamma_boost), with the plasma from p_zmin_lab: the
    left edge by default, 0 (the empty box) as published."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.boosted_frame import BoostConverter
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    boost = BoostConverter(B_GAMMA)
    zmin, zmax = boost.static_length([B_ZMIN_LAB, B_ZMAX_LAB])
    dt = (zmax - zmin) / B_NZ / c
    n_e, = boost.static_density([B_N_E_LAB])
    v_window, = boost.velocity([c])
    sim = Simulation(
        B_NZ, zmax, B_NR, B_RMAX, B_NM, dt, zmin=zmin, n_order=B_N_ORDER,
        gamma_boost=B_GAMMA, v_comoving=-c * np.sqrt(1. - 1. / B_GAMMA**2),
        use_galilean=True, boundaries={"z": "open", "r": "reflective"},
        random_seed=0, device=DEVICE, dtype=dtype or torch.float32)
    sim.add_new_species(
        q=-e, m=m_e, n=n_e, p_zmin=p_zmin_lab,
        p_zmax=boost.static_length([B_P_ZMAX_LAB])[0], p_rmax=B_P_RMAX,
        p_nz=B_PPC[0], p_nr=B_PPC[1], p_nt=B_PPC[2],
        continuous_injection=True, boost_positions_in_dens_func=True)
    add_laser_pulse(sim, GaussianLaser(**B_LASER), gamma_boost=B_GAMMA)
    sim.set_moving_window(v=v_window)
    return sim


def measure_k3(args, label, timed):
    """K3 on `args` = (geom, channel_vals, meta, Nrb) against its plain
    version; with `timed`, also the times, the one-hot bmm and the bounds
    (bytes and operations are returned for the per-step sum)."""
    import torch
    from fbpic_tpu_torch.particles import cuda_dense
    from fbpic_tpu_torch.particles.sorted_deposit import _build_V
    geom, chan, _, Nrb = args
    tname = str(chan.dtype).split(".")[-1]
    kern = assert_bitwise_repeatable(
        lambda: cuda_dense.dense_onehot_contract(*args), f"K3 ({label})")
    plain = cuda_dense.dense_onehot_contract_plain(*args)
    torch.cuda.synchronize()
    err = rel_err(kern, plain)
    Nz, K, C = chan.shape
    n_off = len(geom["zw"])
    n_live, n_slots = live_fraction(geom["ok"])
    print(f"K3 {label}, {tname}: Nz={Nz} K={K} Nrb={Nrb} n_off={n_off} "
          f"C={C} W={kern.shape[2]}, {n_live} of {n_slots} slots live "
          f"({n_live / n_slots:.4f}); rel err {err:.3e} (tol "
          f"{TOL_K3[tname]}); two launches bit-equal", flush=True)
    if not np.isfinite(err) or err > TOL_K3[tname]:
        raise RuntimeError(f"K3 ({label}, {tname}) disagrees with its plain "
                           f"version: {err}")
    out = dict(rel_err=err, max_abs_err=float((kern - plain).abs().max()))
    if not timed:
        return out
    ms = cuda_ms(lambda: cuda_dense.dense_onehot_contract(*args))
    plain_ms = cuda_ms(lambda: cuda_dense.dense_onehot_contract_plain(*args),
                       n_warm=1, n_iter=5)
    # Bound.  Per slot the kernel's operands are C channels, n_off z
    # weights and 2 rows (sr0_m0, sr0_mh) in float32, an int64 row index
    # and a bool; the mask row `ok` is read for every slot, the rest for
    # the live slots only, the output written once; per live slot 3
    # operations for each output channel.  The all-slots figure counts
    # the C + n_off + 4 words a slot of the operand copies the kernel
    # read before it took them in place.
    esize = chan.element_size()
    rate = FP32_FLOP_PER_S if esize == 4 else FP64_FLOP_PER_S
    n_bytes = (n_live * (esize * (C + n_off + 2) + 8 + 1) + esize * n_slots
               + esize * kern.numel())
    n_flops = n_live * 3 * kern.shape[2]
    b_ms, b_by = bound(n_bytes, n_flops, rate)
    all_bytes = n_slots * (4 * (C + n_off + 3) + 4) + 4 * kern.numel()
    all_ms, all_by = bound(all_bytes, n_flops, rate)
    V = torch.cat(_build_V(*args[:3]), dim=2)
    lib_out, library_ms = onehot_bmm(geom["ir_buf"], V, Nrb)
    lib_err = rel_err(lib_out, plain)
    del V, lib_out
    print(f"K3 {label} bound, all slots: {all_ms:.4f} ms by {all_by} "
          f"({all_bytes} bytes)", flush=True)
    print(f"K3 {label} time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (bmm) {library_ms:.4f} ms (rel err {lib_err:.2e}), "
          f"bound over live slots {b_ms:.4f} ms by {b_by} ({n_bytes} "
          f"bytes), live fraction {n_live / n_slots:.4f}", flush=True)
    out.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               n_bytes=n_bytes, n_flops=n_flops, all_ms=all_ms,
               live_fraction=n_live / n_slots, flop_rate=rate)
    return out


def k3_step_total(windows, label):
    """Sum the J and rho windows (one step of one species)."""
    tot = {k: sum(w[k] for w in windows)
           for k in ("ms", "plain_ms", "library_ms", "n_bytes", "n_flops",
                     "all_ms")}
    bound_ms, bound_by = bound(tot["n_bytes"], tot["n_flops"],
                               windows[0]["flop_rate"])
    print(f"K3 {label} per step and species (J + rho windows): kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
          f"{tot['library_ms']:.4f} ms, bound over live slots "
          f"{bound_ms:.4f} ms by {bound_by} (all slots "
          f"{tot['all_ms']:.4f} ms)", flush=True)
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=tot["library_ms"],
                live_fraction=windows[0]["live_fraction"],
                bound_all_slots_ms=tot["all_ms"],
                windows_ms=[w["ms"] for w in windows],
                windows_library_ms=[w["library_ms"] for w in windows])


def phase_k3(sim):
    """K3 against its plain version on random column-sorted particles at
    the boosted shape, both windows, both folds, float32 and float64;
    times, library time and bound of the float32 open-z calls (the main
    path's), summed over the two windows (one step of one species)."""
    import torch
    from fbpic_tpu_torch.constants import e
    from fbpic_tpu_torch.particles.sorted_deposit import (
        dense_contract_operands)
    cfg = sim.config
    Nrb = cfg.Nr + 4
    worst, max_abs, timed_windows = {}, 0.0, []
    for dtype in (torch.float32, torch.float64):
        tname = str(dtype).split(".")[-1]
        sort, pad = random_sorted_particles(sim, seed=41, dtype=dtype)
        x, y, z, w, ux, uy, uz, ig = pad
        for zfold in ("clamp", "periodic"):
            ops = dense_contract_operands(
                dict(valid=sort["valid"], padded=pad), x, y, z, w, -e, ux,
                uy, uz, ig, 0.5 * cfg.dt, cfg.Nm, 1 / cfg.dz, sim.zmin,
                cfg.Nz, 1 / cfg.dr, 0.0, cfg.Nr,
                sim.aux.ruyten_linear.to(dtype), zfold=zfold,
                sort_at_start=True, vz_shift=cfg.v_comoving)
            for window in ("J", "rho"):
                o = ops[window]
                timed = dtype == torch.float32 and zfold == "clamp"
                m = measure_k3(
                    (o["geom"], o["channel_vals"], o["meta"], Nrb),
                    f"{window} window, {zfold}, random half-full layout",
                    timed)
                max_abs = max(max_abs, m["max_abs_err"])
                worst[tname] = max(worst.get(tname, 0.0), m["rel_err"])
                if timed:
                    timed_windows.append(m)
        del sort, pad, ops
        torch.cuda.empty_cache()
    return dict(name="K3 one-hot dense deposit (J + rho windows, one step)",
                route="cuda", source="fbpic_tpu_torch/csrc/dense_deposit.cu",
                replaces="fbpic_tpu/particles/pallas_deposit.py:78",
                max_abs_err=max_abs, rel_err=worst["float32"],
                rel_err_f64=worst["float64"],
                **k3_step_total(timed_windows, "random half-full layout"))


def phase_k3_resident(sim):
    """K3 on the operands of the running boosted simulation (its two
    calls of one step: the J and the rho window)."""
    from fbpic_tpu_torch.particles import sorted_deposit
    calls = capture_calls(sim, sorted_deposit, "dense_onehot_contract")
    if len(calls) != 2:
        raise RuntimeError(f"{len(calls)} K3 calls in one boosted step")
    windows = [measure_k3(args, f"{window} window, resident boosted layout",
                          True)
               for window, (args, _) in zip(("J", "rho"), calls)]
    return k3_step_total(windows, "resident boosted layout")


def profile_steps(sim, n_steps):
    """Device time per step and the kernels that take it, from
    torch.profiler over n_steps steps (None when the profiler shows no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sim.step(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernel rows only: the CPU-op rows carry their kernels' device time
    # too, and summing both would count it twice (one stream: the sum of
    # kernel times is the busy time)
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    busy_us = sum(ev.self_device_time_total for ev in kernels)
    if busy_us == 0:
        print("profiler: no device time recorded (not measured)")
        return None
    n_launch = sum(ev.count for ev in kernels) / n_steps
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:12]
    port = {k: sum(ev.self_device_time_total for ev in kernels
                   if name in ev.key) / n_steps / 1e3
            for k, name in PORT_KERNELS.items()}
    print(f"profiled {n_steps} steps: {wall / n_steps * 1e3:.4f} ms/step "
          f"wall under the profiler, {busy_us / n_steps / 1e3:.4f} ms/step "
          f"device busy, {n_launch:.1f} kernel launches/step; the port's "
          f"kernels, ms/step: {port}", flush=True)
    for ev in top:
        print(f"  {ev.self_device_time_total / n_steps / 1e3:9.4f} ms/step "
              f"{ev.count / n_steps:7.1f}/step  {ev.key[:90]}")
    return dict(device_ms_per_step=busy_us / n_steps / 1e3,
                profiled_wall_ms_per_step=wall / n_steps * 1e3,
                launches_per_step=n_launch, kernel_ms_per_step=port,
                top_rows=[dict(name=ev.key[:90], count_per_step=ev.count
                               / n_steps, ms_per_step=ev.self_device_time_total
                               / n_steps / 1e3) for ev in top[:5]])


def drive_path(sim, counters, n_warm, n_timed, label, per_step):
    """Drive sim n_warm + n_timed steps with every kernel count set to 0
    just before and read just after; ms/step and ns/particle/step (over
    the live particles) of the timed steps; the launches must be exactly
    per_step[kernel] a step."""
    import torch
    for fn in counters.values():
        fn.launches = 0
    t_first = time.perf_counter()
    sim.step(n_warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(n_timed)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {name: fn.launches for name, fn in counters.items()}
    n_steps = n_warm + n_timed
    wall = t1 - t0
    live = sim.ptcl[0].Ntot
    sc, sp = sim.species_configs[0], sim.state.species[0]
    print(f"{label}: {n_steps} steps ({n_warm} before the timed ones, in "
          f"{t0 - t_first:.2f} s incl. setup of the step), "
          f"{wall / n_timed * 1e3:.4f} ms/step, "
          f"{wall * 1e9 / (n_timed * max(live, 1)):.4f} ns/particle/step over "
          f"{live} live particles; Nz={sim.config.Nz} sort_K={sc.sort_K} "
          f"resident={sc.resident} capacity={sp.capacity}", flush=True)
    print(f"launches during {label}: {launches}; overflow totals "
          f"{sim.overflow_totals}", flush=True)
    want = {k: v * n_steps for k, v in per_step.items()}
    if launches != want:
        raise RuntimeError(f"{label} launches {launches} != {want}")
    if any(sim.overflow_totals.values()):
        raise RuntimeError(f"{label}: column/ring overflow "
                           f"{sim.overflow_totals}")
    check_fields(sim, label)
    return launches, dict(ms_per_step=wall / n_timed * 1e3,
                          ns_per_particle_step=wall * 1e9
                          / (n_timed * max(live, 1)),
                          live_particles=live, steps=n_steps,
                          Nz=sim.config.Nz, K=sc.sort_K,
                          capacity=sp.capacity)


def phase_lwfa_fresh_sort(counters, resident_ms):
    """The bench LWFA with a ring above Nz * sort_K: K1 once a step on a
    fresh mid-step sort (no K2: nothing is resident), timed beside the
    resident run of the same configuration; K1 held against its plain
    version on one step's own operands."""
    import inspect
    from fbpic_tpu_torch.particles import cuda_fused, sorted_deposit
    sim = make_sim(capacity=LWFA_RING_CAPACITY)
    sc, cfg = sim.species_configs[0], sim.config
    if sc.resident or sc.sort_K == 0 \
            or sim.state.species[0].capacity <= cfg.Nz * sc.sort_K:
        raise RuntimeError(f"the ring LWFA species is not a sorted ring: {sc}")
    launches, metrics = drive_path(sim, counters, N_WARMUP, N_TIMED,
                                   "bench LWFA, sorted ring",
                                   {"K1": 1, "K2": 0, "K3": 0})
    print(f"bench LWFA: sorted ring {metrics['ms_per_step']:.4f} ms/step "
          f"beside resident {resident_ms:.4f} ms/step (this call)",
          flush=True)
    (args, kwargs), = capture_calls(sim, sorted_deposit,
                                    "fused_onehot_contract")
    ops = inspect.signature(cuda_fused.fused_onehot_contract_plain).bind(
        *args, **kwargs).arguments
    k1 = measure_k1(dict(ops), "fresh mid-step sort, bench LWFA")
    syncs = count_syncs(sim, "bench LWFA sorted ring")
    prof = profile_steps(sim, N_PROFILED)
    if prof is not None:
        prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                  / metrics["ms_per_step"])
    metrics["profile"] = prof
    return launches, metrics, k1, syncs


def phase_sorted_f64():
    """The same ring in float64 (the fused deposit: K3 for J and for rho,
    twice a step) and the legacy plan (use_fused_deposit off:
    deposit_J_sorted and deposit_rho_sorted, K3 on the idx plan, twice a
    step), N_SMALL steps each; each step's two K3 calls held against
    their plain version in float64 and timed."""
    import torch
    from fbpic_tpu_torch.particles import (
        cuda_dense, cuda_fused, cuda_gather, sorted_deposit)
    counters = {"K1": cuda_fused.fused_onehot_contract,
                "K2": cuda_gather.gather_sorted,
                "K3": cuda_dense.dense_onehot_contract}
    out = {}
    for key, fused in (("fresh_sort_f64", True), ("legacy_f64", False)):
        label = ("bench LWFA float64, sorted ring" if fused
                 else "bench LWFA float64, legacy plan")
        sim = make_sim(dtype=torch.float64, fused=fused,
                       capacity=LWFA_RING_CAPACITY if fused else None)
        sc = sim.species_configs[0]
        if sc.resident or sc.sort_K == 0:
            raise RuntimeError(f"{label}: not a sorted ring: {sc}")
        launches, metrics = drive_path(sim, counters, 2, N_SMALL, label,
                                       {"K1": 0, "K2": 0, "K3": 2})
        calls = capture_calls(sim, sorted_deposit, "dense_onehot_contract")
        if len(calls) != 2:
            raise RuntimeError(f"{label}: {len(calls)} K3 calls in a step")
        windows = [measure_k3(args, f"{window} window, {label}", True)
                   for window, (args, _) in zip(("J", "rho"), calls)]
        out[key] = dict(launches=launches, metrics=metrics,
                        k3=k3_step_total(windows, label),
                        rel_err=max(w["rel_err"] for w in windows),
                        max_abs_err=max(w["max_abs_err"] for w in windows))
        del sim, calls
        torch.cuda.empty_cache()
    return out


def ring_fill_steps(sim):
    """Steps until the plasma of the published boosted script fills the
    box from its empty start, and the cells it must cross: the plasma at
    v_end_plasma (boosted) and the window at moving_win cross the span
    from the injection plane to the left removal bound at
    (moving_win - v_end) * dt / dz cells a step."""
    from fbpic_tpu_torch.constants import c
    cfg, inj = sim.config, sim._injector_configs[0]
    cells = cfg.Nz - 2 * cfg.n_guard + 3 - cfg.n_inject
    rate = (sim.moving_win - inj.v_end_plasma) * cfg.dt / cfg.dz
    n_fill = int(np.ceil(cells / rate)) + 2 * sim.exchange_period
    print(f"ring boosted: plasma streams at {rate:.4f} cells/step relative "
          f"to the window ({inj.v_end_plasma / c:.6f} c), {cells} cells to "
          f"fill: {n_fill} steps", flush=True)
    return n_fill, cells


def reckon_full_box(sim):
    """Particles of a box full of the script's plasma: the injected
    columns between the left removal bound and the injection plane,
    times the particles of one column (no dens_func); and the left
    removal bound."""
    cfg, inj = sim.config, sim._injector_configs[0]
    col_size = sim._injector_auxes[0].r.shape[0]
    z_lo = sim.zmin + max(cfg.n_guard, 1) * cfg.dz
    z_inject = (sim.zmin + (cfg.Nz - cfg.n_guard + 3 - cfg.n_inject) * cfg.dz
                + cfg.dt * (sim.moving_win - inj.v_end_plasma))
    return int((z_inject - z_lo) / inj.dz_particles) * col_size, z_lo


def phase_ring_boosted(counters):
    """examples/boosted_frame_script.py:17-58 as written: the empty box
    (p_zmin = 0 lab), so the species is a ring with sort_K = 0; run until
    the plasma, streaming in at about 2c relative to the window, fills
    the box, then 60 timed steps: no kernel launch at all (the linear
    gather, the scatter deposits and the ring writes are PyTorch ops),
    zero ring overwrite, finite E/B; the host syncs of one step and a
    profiled window."""
    sim = make_boosted_sim(p_zmin_lab=B_P_ZMIN_PUBLISHED)
    sc, cfg = sim.species_configs[0], sim.config
    if sc.sort_K != 0 or sc.resident or sim.ptcl[0].Ntot != 0:
        raise RuntimeError(f"the published boosted species is not an empty "
                           f"ring: {sc}, {sim.ptcl[0].Ntot} live")
    n_fill, cells = ring_fill_steps(sim)
    inj = sim._injector_configs[0]
    launches, metrics = drive_path(sim, counters, n_fill, N_TIMED,
                                   "published boosted script (ring)",
                                   {"K1": 0, "K2": 0, "K3": 0})
    reckoned, z_lo = reckon_full_box(sim)
    live = metrics["live_particles"]
    sp = sim.state.species[0]
    z_left = float(sp.z[sp.w != 0].min())
    # fbpic_tpu's injection front does not drift with the plasma, so a
    # drifting plasma is injected with gaps: the density comes out near
    # v_window / (v_window - v_plasma) of the nominal one
    drift_share = sim.moving_win / (sim.moving_win - inj.v_end_plasma)
    print(f"ring boosted: {live} live particles beside {reckoned} reckoned "
          f"for a full box of the nominal density (ratio "
          f"{live / reckoned:.4f}; the undrifted injection front predicts "
          f"{drift_share:.4f}); the plasma reaches "
          f"{(z_left - z_lo) / cfg.dz:.1f} cells from the left removal "
          f"bound; ring capacity {sp.capacity}", flush=True)
    if z_left > z_lo + 0.05 * cells * cfg.dz:
        raise RuntimeError(f"the plasma did not fill the box: it reaches "
                           f"{z_left}, the removal bound is {z_lo}")
    metrics.update(reckoned_full_box=reckoned,
                   undrifted_front_share=drift_share)
    syncs = count_syncs(sim, "published boosted script (ring)")
    prof = profile_steps(sim, N_PROFILED)
    if prof is not None:
        prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                  / metrics["ms_per_step"])
    metrics["profile"] = prof
    return launches, metrics, syncs


def nci_slope(scheme, dtype):
    """tests/test_boosted.py::_growth_slope: log growth of the Er RMS
    over the last 30 of 600 steps of a gamma = 130 plasma and its ions
    flowing through a periodic box (standard, Galilean or comoving)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, m_p
    Nz, zmax, zmin, Nr, rmax, Nm = 40, 7.86, -7.86, 20, 7.86, 2
    dt = (zmax - zmin) / Nz / c
    gamma = 130.
    uz_m = np.sqrt(gamma**2 - 1)
    n_e = gamma / (4 * 3.14 * 2.81e-15)
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, dt, zmin=zmin,
                     v_comoving=None if scheme == "standard" else 0.9999 * c,
                     use_galilean=(scheme == "galilean"), random_seed=0,
                     device=DEVICE, dtype=dtype)
    for q, m in ((-e, m_e), (e, m_p)):
        sim.add_new_species(q=q, m=m, n=n_e, p_zmin=zmin, p_zmax=zmax,
                            p_rmin=0., p_rmax=rmax, p_nz=2, p_nr=2, p_nt=4,
                            uz_m=uz_m, sort_K=512)

    def er_rms():
        Er0, Er1 = (sim.get_interp_field("Er", m) for m in (0, 1))
        return float(np.sqrt(np.average(np.abs(Er0)**2 + np.abs(Er1)**2)))

    sim.step(NCI_STEPS[0])
    rms_a = er_rms()
    sim.step(NCI_STEPS[1])
    rms_b = er_rms()
    if any(sim.overflow_totals.values()):
        raise RuntimeError(f"NCI run overflow: {sim.overflow_totals}")
    return float(np.log(rms_b) - np.log(rms_a))


def phase_nci():
    """The gate in float64; the float32 slopes are printed, not gated
    (float32 roundoff seeds the standard scheme's instability ~1e9 times
    higher, so it saturates early: 3.1x on the CPU)."""
    import torch
    out = {}
    for dtype in (torch.float64, torch.float32):
        tname = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        std, gal = (nci_slope(s, dtype) for s in ("standard", "galilean"))
        out[tname] = dict(standard=std, galilean=gal)
        gated = dtype == torch.float64
        print(f"NCI ({tname}, {'gated' if gated else 'not gated'}): growth "
              f"slope standard {std:.4f}, galilean {gal:.4f}, ratio "
              f"{std / gal:.2f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        if gated and not std > NCI_RATIO * gal:
            raise RuntimeError(f"NCI gate failed in {tname}: standard "
                               f"{std} <= {NCI_RATIO} x galilean {gal}")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device: "
                           "torch.cuda.is_available() is false")
    from fbpic_tpu_torch.utils import kernels
    from fbpic_tpu_torch.particles.cuda_dense import dense_onehot_contract
    from fbpic_tpu_torch.particles.cuda_fused import fused_onehot_contract
    from fbpic_tpu_torch.particles.cuda_gather import gather_sorted

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    t_start = t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")

    sim = make_sim()
    k1 = phase_k1(sim)
    k2 = phase_k2(sim)
    k3 = {}
    torch.cuda.empty_cache()
    launches, main_metrics = phase_main(
        sim, (fused_onehot_contract, gather_sorted))
    k1["launches"], k2["launches"] = launches
    k1["resident"] = phase_k1_resident(sim)
    k2["resident"] = {"LWFA": phase_k2_resident(sim, "resident LWFA layout")}
    syncs = {"bench LWFA": count_syncs(sim, "bench LWFA")}
    main_prof = profile_steps(sim, N_PROFILED)
    if main_prof is not None:
        main_prof["idle_share"] = 1 - (main_prof["device_ms_per_step"]
                                       / main_metrics["ms_per_step"])
    main_metrics["profile"] = main_prof
    del sim
    torch.cuda.empty_cache()
    counters = {"K1": fused_onehot_contract, "K2": gather_sorted,
                "K3": dense_onehot_contract}
    (k1["launches_sorted_ring"], ring_lwfa_metrics, k1["sorted_ring"],
     syncs["bench LWFA sorted ring"]) = phase_lwfa_fresh_sort(
        counters, main_metrics["ms_per_step"])
    torch.cuda.empty_cache()
    sorted_f64 = phase_sorted_f64()
    for key, run in sorted_f64.items():
        k3[key] = dict(run["k3"], launches=run["launches"]["K3"],
                       rel_err=run["rel_err"], max_abs_err=run["max_abs_err"])
    ratio = phase_wake()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bsim = make_boosted_sim()
    print(f"boosted sim set up in {time.perf_counter() - t0:.1f} s",
          flush=True)
    k3.update(phase_k3(bsim))
    torch.cuda.empty_cache()
    b_launches, boosted_metrics = drive_path(
        bsim, counters, N_WARMUP, N_TIMED, "boosted main path",
        {"K1": 0, "K2": 1, "K3": 2})
    k3["launches"] = b_launches["K3"]
    k3["resident"] = phase_k3_resident(bsim)
    k2["launches_boosted"] = b_launches["K2"]
    k2["resident"]["boosted"] = phase_k2_resident(
        bsim, "resident boosted layout")
    syncs["boosted LWFA"] = count_syncs(bsim, "boosted LWFA")
    prof = profile_steps(bsim, N_PROFILED)
    if prof is not None:
        # idle share of the unprofiled steps
        prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                  / boosted_metrics["ms_per_step"])
    boosted_metrics["profile"] = prof
    del bsim
    torch.cuda.empty_cache()
    ring_launches, ring_metrics, syncs["published boosted (ring)"] = \
        phase_ring_boosted(counters)
    torch.cuda.empty_cache()
    nci = phase_nci()

    print(json.dumps({"main_path": main_metrics, "wake_ratio": ratio,
                      "boosted_path": boosted_metrics,
                      "boosted_launches": b_launches,
                      "ring_boosted_path": ring_metrics,
                      "ring_boosted_launches": ring_launches,
                      "lwfa_sorted_ring_path": ring_lwfa_metrics,
                      "sorted_f64_paths": {
                          key: dict(run["metrics"], launches=run["launches"])
                          for key, run in sorted_f64.items()},
                      "nci_slopes": nci, "host_syncs_per_step": syncs,
                      "seconds": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
