#!/usr/bin/env python3
"""Smoke run of fbpic_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  0. builds the CUDA kernels from fbpic_tpu_torch/csrc with nvcc;
  1. K1 (fused J + d(rho) deposit) against its plain PyTorch version at
     the LWFA bench shape, on particles drawn from a numpy seed (a third
     of them near or below the axis), with kernel and plain times;
  2. K2 (sorted field gather) against its plain version, for open and
     periodic z;
  3. the main path: the bench.py LWFA configuration (Nz=800, Nr=50,
     Nm=2, 16 particles per cell, a0=4 laser, moving window, continuous
     injection, open z, float32) through Simulation / add_laser_pulse /
     set_moving_window / step, with every kernel launch counter reset
     just before and read just after; ms/step, ns/particle/step,
     overflow counters and finite fields;
  4. the wake invariant of tests/test_golden_wake.py (on-axis wake
     wavelength within 15% of 2 pi c / omega_p) on the bench grid and
     plasma.  In the bench configuration the laser starts 2 um ahead of
     the window's left edge and rides with it, so its wake leaves the
     window; this phase starts the laser near the right edge instead
     (z0 = 24 um) and, as that test does, at a0 = 1 (the a0 = 4 wake is
     nonlinear and about 20% longer than 2 pi c / omega_p), then steps
     until the wake trails the laser over more than three zero
     crossings.

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

TOL_K1 = 1e-5       # relative to each part's max |value| (float32 sums
TOL_K2 = 5e-6       # in another order: sequential vs atomics / GEMM)


def cuda_ms(fn, n_warm=3, n_iter=20):
    """Mean device time of fn() over n_iter launches (CUDA events)."""
    import torch
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def make_sim(z0=Z0, a0=A0):
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    dt = (ZMAX - ZMIN) / NZ / c
    sim = Simulation(
        NZ, ZMAX, NR, RMAX, NM, dt, p_zmin=P_ZMIN, p_zmax=P_ZMAX, p_rmin=0.,
        p_rmax=P_RMAX, p_nz=P_NZ, p_nr=P_NR, p_nt=P_NT, n_e=N_E, zmin=ZMIN,
        n_order=32, boundaries={"z": "open", "r": "reflective"},
        random_seed=0, device="cuda", dtype=torch.float32)
    add_laser_pulse(sim, GaussianLaser(a0=a0, waist=W0, tau=TAU, z0=z0))
    sim.set_moving_window(v=c)
    return sim


def random_sorted_particles(sim, seed=23):
    """Particles from a numpy seed, column-sorted at the bench shape."""
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
    arrs = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
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


def phase_k1(sim):
    from fbpic_tpu_torch.constants import e
    from fbpic_tpu_torch.particles import cuda_fused
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
    kern = cuda_fused.fused_onehot_contract(**ops)
    plain = cuda_fused.fused_onehot_contract_plain(**ops)
    import torch
    torch.cuda.synchronize()
    W_J = ops["n_offJ"] * 2 * ops["channels"].shape[2]
    errs = [rel_err(kern[..., :W_J], plain[..., :W_J]),
            rel_err(kern[..., W_J:], plain[..., W_J:])]
    max_abs = float((kern - plain).abs().max())
    print(f"K1 shape: Nz={cfg.Nz} K={ops['channels'].shape[1]} "
          f"Nrb={kern.shape[1]} W={kern.shape[2]}; rel err J={errs[0]:.3e}"
          f" drho={errs[1]:.3e} (tol {TOL_K1})", flush=True)
    if not all(np.isfinite(errs)) or max(errs) > TOL_K1:
        raise RuntimeError(f"K1 disagrees with its plain version: {errs}")
    ms = cuda_ms(lambda: cuda_fused.fused_onehot_contract(**ops))
    plain_ms = cuda_ms(lambda: cuda_fused.fused_onehot_contract_plain(**ops),
                       n_warm=1, n_iter=5)
    print(f"K1 time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return dict(name="K1 fused J+drho deposit", route="cuda",
                source="fbpic_tpu_torch/csrc/fused_deposit.cu",
                replaces="fbpic_tpu/particles/pallas_fused.py:78",
                max_abs_err=max_abs, rel_err=max(errs), ms=ms,
                plain_ms=plain_ms)


def phase_k2(sim):
    import torch
    from fbpic_tpu_torch.fields.solver import InterpFields
    from fbpic_tpu_torch.particles import cuda_gather
    from fbpic_tpu_torch.particles.gather import gather_operands
    cfg = sim.config
    sort, pad = random_sorted_particles(sim, seed=31)
    rng = np.random.RandomState(31)
    shape = (cfg.Nm, cfg.Nz, cfg.Nr)
    interp = InterpFields(**{
        n: torch.complex(*(torch.as_tensor(rng.randn(*shape),
                                           dtype=torch.float32,
                                           device="cuda")
                           for _ in range(2)))
        for n in ("Er", "Et", "Ez", "Br", "Bt", "Bz")})
    worst, max_abs, times = 0.0, 0.0, {}
    for zfold in ("clamp", "periodic"):
        ops = gather_operands(pad[0], pad[1], pad[2], sort["valid"], interp,
                              cfg.rmax, 1 / cfg.dz, sim.zmin, cfg.Nz,
                              1 / cfg.dr, 0.0, cfg.Nr, zfold=zfold)
        kern = cuda_gather.gather_sorted(**ops)
        plain = cuda_gather.gather_sorted_plain(**ops)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(kern, plain)]
        max_abs = max(max_abs, max(float((a - b).abs().max())
                                   for a, b in zip(kern, plain)))
        print(f"K2 {zfold}: rel err per component "
              f"{['%.2e' % x for x in errs]} (tol {TOL_K2})", flush=True)
        if not all(np.isfinite(errs)) or max(errs) > TOL_K2:
            raise RuntimeError(f"K2 ({zfold}) disagrees with its plain "
                               f"version: {errs}")
        worst = max(worst, max(errs))
        if zfold == "clamp":
            times["ms"] = cuda_ms(lambda: cuda_gather.gather_sorted(**ops))
            times["plain_ms"] = cuda_ms(
                lambda: cuda_gather.gather_sorted_plain(**ops),
                n_warm=1, n_iter=5)
    print(f"K2 time: kernel {times['ms']:.4f} ms, plain "
          f"{times['plain_ms']:.4f} ms", flush=True)
    return dict(name="K2 sorted field gather", route="cuda",
                source="fbpic_tpu_torch/csrc/gather.cu",
                replaces="fbpic_tpu/particles/pallas_gather.py:80",
                max_abs_err=max_abs, rel_err=worst, **times)


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
    for n in launches:
        if n < n_steps:
            raise RuntimeError(f"a kernel ran {n} < {n_steps} times")
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


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device: "
                           "torch.cuda.is_available() is false")
    from fbpic_tpu_torch.utils import kernels
    from fbpic_tpu_torch.particles.cuda_fused import fused_onehot_contract
    from fbpic_tpu_torch.particles.cuda_gather import gather_sorted

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")

    sim = make_sim()
    k1 = phase_k1(sim)
    k2 = phase_k2(sim)
    torch.cuda.empty_cache()
    launches, main_metrics = phase_main(
        sim, (fused_onehot_contract, gather_sorted))
    ratio = phase_wake()
    k1["launches"], k2["launches"] = launches
    print(json.dumps({"main_path": main_metrics, "wake_ratio": ratio}))
    print(smi)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
