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
       (device busy, idle share, launches, the largest device rows);
  9. examples/lwfa_script.py as written (the bench values, tracked, its
     FieldDiagnostic and ParticleDiagnostic(select uz > 1) every 50
     steps, a checkpoint every 100), 200 steps in two step() calls: one
     K1 and one K2 launch a step; the diagnostics collect their records
     (written and read back only where h5py is installed, which a
     CUDA machine need not have); live ids unique, next_id = 1 + the slots
     numbered + the injected candidates; a checkpoint save -> load
     round trip bit for bit; a restart from iteration 100 continued to
     200 against the uninterrupted run (the largest difference of each
     array, and which are exact); ms per collect and per checkpoint
     write and read; ms/step and device busy with tracking on, off, on;
     the host syncs of one step;
 10. the card against the card machine's CPU in float64: 8 steps of
     tests/test_diagnostics.py's configuration with the field,
     particle, charge-density and back-transformed particle
     diagnostics on the CPU, the state carried to the card, and the
     records every diagnostic collects from it on both devices held
     against each other;
 11. the boosted resident cell (phase 6) with the published script's
     back-transformed field diagnostic (20 snapshots, 50 fs apart), 100
     steps: exactly one K2 and two K3 launches a step; the captured
     slices of three steps against get_interp_field's grids; ms/step
     and device busy with the diagnostic on, off, on; the host syncs of
     step(1) and step(10) calls, and that the capture adds none a step;
 12. the bench LWFA with cubic shapes and an open radial boundary (the
     PML's 32 cells inside Nr: Nr = 82, rmax widened by 32 of the
     bench's dr), float32, 5 + 30 steps: a non-resident species (the
     mid-step payload sort, deposit_rho_J_sorted_cubic with d(rho),
     gather_fields_cubic, a full E/B round trip for the PML: PyTorch
     ops), no K1, K2 or K3 launch, zero overflow, finite fields, the
     live count against the injection front; peak memory, host syncs, a
     profiled window; the cubic contraction (index_add_; beside the
     one-hot bmm) and the cubic gather timed on one step's operands;
 13. the bench LWFA with current_correction = 'cross-deposition',
     float32, 5 + 30 steps: sized resident, run non-resident (the legacy
     mid-step sort), exactly two K3 launches a step (J and rho_next), no
     K1 or K2, the exchange block every step, zero overflow, finite
     fields, the live count; host syncs, a profiled window; K3 on that
     step's two calls against its plain version, its bmm, timed;
 14. physics gates too slow for the CPU tests: tests/test_pml.py's
     absorption (>= 30x, 400 steps, three runs, float64),
     tests/test_periodic_plasma_wave.py linear and cubic at its
     tolerances (float32, the card's default; the linear species
     resident, exactly one K1 and one K2 launch a step, the cubic one
     none), and
     tests/test_uniform_rho.py's cubic check (float64, as that test),
     also on the cubic deposit itself;
 15. the PWFA drive bunch (BASELINE config 3): bench.py's grid and plasma, no
     laser, a 50 pC Gaussian electron bunch (gamma 2000, 1,000,000
     macroparticles, symmetrized) with its space-charge field, float32:
     the fields after init against tests/test_space_charge.py's
     analytic field (10% of the peak); 5 + 30 steps with exactly one K1
     and one K2 a step (the resident plasma; the bunch a ring with
     sort_K = 0: linear gather, scatter J, the d(rho) of two scatter
     deposits), zero overflow, finite fields, the bunch's live count;
     peak memory, host syncs, a profiled window whose rows are read by
     the kernels the bunch's gather and deposits launch (each timed on
     a step's operands); K1 and K2 on this simulation's operands; on to
     600 steps and the wake's period behind the drive bunch within 15% of
     2 pi c / omega_p;
 16. the bench LWFA with its laser emitted by a lab-static antenna at 20
     um: 5 + 30 steps with exactly one K1 and one K2 a step, zero
     overflow, finite fields; the host syncs of one exchange period
     with the antenna the same as over the next without it (none in the
     antenna's code; one, the chunk's read, since the antenna takes the
     chunk runner); on until the pulse has left
     the antenna, its peak ahead of the antenna beside a0's E0 times the
     emission attenuation (printed); then 30-step windows with a Mirror
     2 um inside the right edge (its cells zero) and with an
     ExternalField (a uniform Ez on every species), each profiled
     beside the plain run;
 17. the LPA tests too slow for the CPU: tests/test_antenna.py,
     tests/test_beam_focusing.py (both runs),
     tests/test_space_charge.py, tests/test_charge_cylinder.py (both
     shapes), tests/test_external_fields.py and tests/test_laser.py's
     mirror filtering and profile injection (the four profiles without
     a file), each at its file's tolerances in float32 and, where
     float32 misses, in float64;
 18. examples/ionization_script.py at full width (the bench's grid,
     plasma and a0 = 4 laser, an N5+ dopant made ionizable from level 5
     into a tracked, empty species of one creation buffer) with its
     field and particle diagnostics collected, float32: a run-up of 500
     steps in 10-step calls (the created electrons' ring grows between
     them), then 5 + 30 steps with exactly two K1 and two K2 launches a
     step (the electrons and the ions resident), zero overflow, finite
     fields; the creation balance of one step (the ions' sum of w
     dlevel against the electrons appended); the host syncs of an
     exchange period with the ionizer the same as without it, the
     chunk's one read (the chunk runner replays the steps); profiled
     windows with and without the ionizer (what it adds a step); K1 on
     both deposits of a step (the ions' weighted by w * level, against
     the plain version in float64 too) and K2 on both gathers; unique
     ids; then a 30-step
     window of the same with the radial PML (BASELINE config 4, Nr =
     82), two K1 and two K2 a step;
 19. phase 15's PWFA with the drive bunch Compton-active against a
     counter-propagating rigid laser (0.8 um, waist 10 um, ctau 10 um)
     meeting it at step 100, its energy set from scattering_probability
     so that the photons expected a step there are under a quarter of
     the 8192-slot buffer; the photons a ring (q = 0, m = 0): 5 + 30
     steps around the overlap with one K1 and one K2 a step, zero
     overflow, the host syncs with and without Compton the same (the
     chunk's one read), profiled windows with and without it, K1 on the
     plasma's operands;
     on to 220 steps and
     the photons' upper edge within 10% of 4 gamma^2 E_L / (1 + 4 gamma
     E_L / m_e c^2);
 20. tests/test_ionization.py (the ADK rate, Chen 2013's N5+ fraction,
     the small-capacity target), tests/test_resident_processes.py and
     tests/test_compton.py through the port on the card at their files'
     sizes and tolerances, float32 and, where float32 misses, float64;
 21. the bench LWFA built from fbpic_tpu_torch.picmi objects (the bench
     grid with fbpic_tpu's PICMI axis order, 4e24 m^-3 electrons as an
     AnalyticDistribution with a 5 um linear ramp, 2x2x4 per cell, phase
     4's a0 = 1 laser, a field and a particle diagnostic every 50
     steps, collected; the infinite-order stencil, as the PICMI wrapper
     passes no n_order), float32, resident: a 200-step run-up with
     exactly one K1 and one K2 launch a step; the same configuration
     built by hand through Simulation gives the same state bit for bit
     but rho_prev (a scatter deposit: float32 atomics; 1e-6 of its
     scale); 5 + 30 timed
     steps with one K1 and one K2 a step, zero overflow, the live count;
     the host syncs of one exchange period (step(14)), a profiled window,
     K1 and K2 against their plain versions on this path's operands; on
     to 560 steps and the wake wavelength within 15%;
 22. FBPIC's documented LWFA script (tests/test_reference_script.py's
     body through fbpic_tpu_torch.main, use_cuda=True, tracking, its
     diagnostics collected, checkpoints and restart) at its reduced size
     on the card, float32: as the file runs it (32 steps, then the
     restart, which resumes from the latest checkpoint), one K1 and one
     K2 a step; and the restart from 16 against the uninterrupted run
     with the same step() call boundary: the records at 20 and 30 equal
     bit for bit but rho (rho_prev: 1e-6 of its scale);
 23. tests/test_golden_wake.py's configuration in float64 on the card
     (resident: two K3 and one K2 launch a step) with fbpic_tpu's
     injection angles from tests/data/torch_golden_angles.npz: the 100-
     and 450-step profiles of tests/data/golden_wake.npz at 2e-3.
 24. examples/multichip_lwfa_script.py as written (fbpic_tpu changed to
     fbpic_tpu_torch, float32; Simulation bound to random_seed=0, which
     the script leaves out, so that its twins load the same plasma):
     Nz=800, Nr=50, Nm=2, 2x2x4 per cell, a0=4, n_order=32, open z,
     moving window, its FieldDiagnostic every 100 steps collected,
     through distribute_simulation on 2 slabs (both on cuda:0 on a
     one-card machine, one per card on two or more; the phase prints
     which, and the run's graph_blockers): the slabs' chunk runner (on
     one card every step's rest replayed from one CUDA graph a variant
     that holds both slabs' steps) beside its eager slab twin (the same
     script, run.eager: every step from the slab threads) and its
     single-card twin (the same script, sim.step on the same schedule):
     the graphed slabs and the eager slabs every array bit for bit under
     deterministic index_add_ (the generators and the records too),
     exactly one K1 and one K2 launch per slab per step and no K3 in
     each (the graphed run's counted on the replays), zero migration
     loss and sort overflow, the gathered live count and total weight
     (1e-6) equal to the single card's at every diagnostic, Ez (m = 0,
     1) within 5e-3 of its scale at 50 steps (printed at 200), the E, B,
     J and rho records at 0 and 100 within 5e-3 on every row (the rho
     record sums each slab's rho_prev over the halo); a column overflow
     planted on a slab at a replayed step: the graphed chunk rolls back
     on every slab and equals the eager slabs; K1 and K2 on each slab's
     own operands (one more step, captured) against their plain
     versions; ms/step, device busy, idle share, launches a step, the
     device time by kernel group and the host syncs of step(14) for the
     graphed slabs, the eager slabs and the single card, and the halo
     exchanges' and the migration's device time a step on the run's
     tensors;
 25. tests/test_resident.py's resident mesh (4 slabs, n_guard 24,
     exchange period 4, 40 steps) in float64 on the card and on the
     card machine's CPU with the same injection angles: two K3 and one
     K2 launch per slab per step, the same live slots, every field and
     the live particles within 1e-10 of their vector's scale (the same
     configuration on one device, card against CPU, printed beside it),
     rho_prev (float64 atomics) within 1e-6.
 26. the chunk runner (core/graph.py): the bench LWFA, the boosted LWFA
     of phase 6 and the PICMI LWFA of phase 21, each run 200 steps (the
     boosted one 210: its window shifts 1 cell instead of 2 at step 200,
     its second graph variant) through Simulation.step (the exchange
     steps' exchange block eager, every step's rest replayed from a
     captured CUDA graph) beside an eager twin built from the same seeds
     (eager_steps: the
     eager step function called in a loop): exactly one K1 and one K2 a
     step (two K3 and one K2 on the boosted path), counted per replay,
     and the expected graph variants; every array equal bit for bit but
     rho_prev (an atomic scatter deposit: TOL_ATOMIC_RHO of its scale;
     the boosted pair under torch's deterministic index_add_, its
     correction reading rho_prev, and rho_prev too); no loss; each run's ms/step, peak memory, device busy,
     idle share, device launches and host launch calls a step
     (cudaLaunchKernel, cudaGraphLaunch) and the host syncs of an
     exchange period; on the bench path a column overflow planted in
     both runs, whose graphed chunk rolls back (one rollback) and ends
     equal to the twin.  Then, the same way, the boosted LWFA with
     phase 9's BTD captured inside the chunk (210 steps; its captured
     rows and lab snapshots bit for bit too), the antenna LWFA of phase
     16 (200 steps, then 30 with its mirror and 30 with its external
     field, each against the twin), the PWFA driver of phase 15 (200
     steps; the bunch a ring) and the published boosted script (a ring)
     with the BTD (210 steps), the last three under deterministic
     index_add_ too (a ring's J is a scatter deposit); then the
     ionization LWFA of phase 18 (its created electrons' ring built at
     262,144; both runs stepped to 150 first, so that the laser ionizes
     the dopant in the pair's 200 steps; two K1 and two K2 a step; the
     electrons created in each half printed; a planted rollback from a
     twin re-seeded with the graphed run's state after the timed
     windows), the Compton PWFA of phase 19 (its photon ring built at
     524,288, 200 steps across the overlap, photons created in each
     half) and the ballistic PWFA (phase 15's bunch behind an injection
     plane 5 sig_z ahead of it: all of it behind the plane at step 0,
     some at 210, none at 420), all under deterministic index_add_, the
     generators' states equal too; at most one host sync an exchange
     period (the chunk's read; two with the BTD, whose first write
     reads back; four on the PICMI path).

Phases 1-25 run the paths through Simulation.step, so the
configurations that take the chunk runner (every single-card one) run
replayed graphs there too;
phase 9 holds the BTD to two host syncs a step(n) call and phase 16 the
antenna to one, the chunk's read.  Where a phase takes a running
simulation's kernel operands (capture_calls), that one step runs through
the eager twin's loop: a replay runs no Python.

Prints the card's name and power limit, a {"kernels": [...]} line and,
last, {"ok": true, "device": {...}}.  Exits non-zero without a result
when no CUDA device is available.

``python3 chip_smoke.py --cards N`` (a machine with N cards, e.g. four
H100s of one host) runs instead phase 24 on N slabs, one a card
(each card's slabs replayed from its own CUDA graph, the cross-card
exchanges peer copies inside the graphs), with its gates, beside the
same slabs all on cuda:0 (graphed; bit for bit too) and with each
card's device busy, flag-wait and copy time; then phase 25 on the N
cards, K3 held against its plain version on each slab's operands; the
cross-card copy against its plain version; and the kernels line (K1-K3
and the copy).  It fails when fewer than N cards are visible.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
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

# examples/lwfa_script.py as written: diagnostics every 50 steps, a
# checkpoint every 100, 200 steps (the script's N_step is 2000)
LWFA_DIAG_PERIOD, LWFA_CHECKPOINT_PERIOD, LWFA_STEPS = 50, 100, 200
# Timed steps of tracking on / off and of the field BTD on / off
N_COST = 30
# The field BTD of examples/boosted_frame_script.py:60-65 on the
# resident boosted cell: 20 lab snapshots 50 fs apart, ~100 steps
BTD_NSNAP, BTD_DT_LAB, BTD_PERIOD, BTD_STEPS = 20, 50.e-15, 25, 100
# Captured slices against get_interp_field's grids (float32: a
# single-column inverse DFT over 2410 z modes against the full cuFFT
# transform), relative to the field's largest value
TOL_BTD_SLICES = 1e-4
# Collected records of one state, card against the card machine's CPU,
# float64: relative to each record's largest value (FFTs, GEMMs and sums
# in another order on each device)
TOL_COLLECT = 1e-12

# The bench LWFA with cubic shapes and the radial PML: fbpic_tpu puts
# the nr_damp = 32 PML cells inside Nr, so the grid widens by 32 cells of
# the bench's dr and the physical region and the plasma stay the bench's
PML_NR_DAMP = 32
PML_NR = NR + PML_NR_DAMP
PML_RMAX = RMAX * PML_NR / NR
# Timed steps of the cubic + PML and the cross-deposition paths
N_NEW_TIMED = 30

# Tolerances, relative to each output part's largest |value|: a kernel
# sums in another order than its plain version (GEMM, index_add_)
TOL_K1 = 1e-5
TOL_K2 = {"float32": 5e-6, "float64": 1e-12}
TOL_K3 = {"float32": 1e-5, "float64": 1e-12}

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
# cores (the bound of a kernel is the larger of bytes / rate and
# operations / rate)
HBM_BYTES_PER_S = 3.35e12
#: NVLink between two H100 SXM of one host, each way (data sheet)
NVLINK_BYTES_PER_S = 450e9
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


def make_sim(z0=Z0, a0=A0, dtype=None, capacity=None, fused=True, nr=NR,
             rmax=RMAX, r_boundary="reflective", z_antenna=None, sort_K=None,
             **options):
    """The bench LWFA.  capacity: of the plasma species (above Nz *
    sort_K: a ring sorted afresh every step, not resident); sort_K: the
    plasma's (None: the automatic one); fused:
    use_fused_deposit (False with sort_K > 0: the legacy plan); nr, rmax,
    r_boundary: the radial grid and boundary; z_antenna: emit the laser
    from a lab-static antenna there (its peak crossing the antenna 3 tau
    after t = 0, focused on it) instead of injecting it at z0; options:
    more Simulation arguments (particle_shape, current_correction)."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    dt = (ZMAX - ZMIN) / NZ / c
    sim = Simulation(
        NZ, ZMAX, nr, rmax, NM, dt, zmin=ZMIN, n_order=32,
        boundaries={"z": "open", "r": r_boundary}, random_seed=0,
        verbose_level=0, device=DEVICE, dtype=dtype or torch.float32,
        **options)
    sim.use_fused_deposit = fused
    sim.add_new_species(q=-e, m=m_e, n=N_E, p_zmin=P_ZMIN, p_zmax=P_ZMAX,
                        p_rmin=0., p_rmax=P_RMAX, p_nz=P_NZ, p_nr=P_NR,
                        p_nt=P_NT, capacity=capacity, sort_K=sort_K)
    if z_antenna is None:
        add_laser_pulse(sim, GaussianLaser(a0=a0, waist=W0, tau=TAU, z0=z0))
    else:
        add_laser_pulse(sim, GaussianLaser(
            a0=a0, waist=W0, tau=TAU, z0=z_antenna - 3 * c * TAU,
            zf=z_antenna), method="antenna", z0_antenna=z_antenna)
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


def rho_endpoint_ops(ops):
    """K1's operands with the old endpoint of the d(rho) taken out
    (phase and z weights 0), so that its d(rho) part is the charge the
    particles deposit at the new one: the rho_next the d(rho) adds to."""
    import torch
    span = dict(ops["span"])
    span["zw_a"] = [torch.zeros_like(t) for t in span["zw_a"]]
    return dict(ops, span=span, dph=ops["ph_b"])


def dropped_offset_ops(ops, offset):
    """K1's operands with one z offset's new-endpoint weight of the
    d(rho) zeroed: a planted fault (one dropped z offset)."""
    import torch
    span = dict(ops["span"])
    span["zw_b"] = [torch.zeros_like(t) if o == offset else t
                    for o, t in enumerate(span["zw_b"])]
    return dict(ops, span=span)


def measure_k1(ops, label, drho_vs_rho=False):
    """K1 on `ops` against its plain version and the one-hot bmm: errors,
    times, live fraction and bounds.  Each output part (J, d(rho)) is
    held against the plain version at TOL_K1, relative to its largest
    element.

    drho_vs_rho: measure the d(rho) part's error relative to the largest
    element of the rho_next it adds to (the charge the particles deposit
    at their new positions, the plain version of rho_endpoint_ops), not
    relative to the d(rho) itself.  For nearly static particles (the
    ions of the ionization LWFA) each particle's d(rho) is the
    difference of two endpoint weights ~1e4 times larger, so both float32
    versions round ~1e4 times more than TOL_K1 relative to the d(rho)
    they give, in their own order (nvcc contracts multiply-adds, PyTorch
    does not); relative to rho_next the comparison is well conditioned.
    The gate also reads the kernel on a planted fault (one dropped z
    offset of the d(rho)) and fails unless that reads above TOL_K1."""
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
    parts = (slice(0, W_J), slice(W_J, None))
    errs = [rel_err(kern[..., p], plain[..., p]) for p in parts]
    max_abs = float((kern - plain).abs().max())
    n_live, n_slots = live_fraction(ops["geom"]["ok"])
    print(f"K1 {label}: Nz={Nz} K={K} Nrb={kern.shape[1]} W={kern.shape[2]}, "
          f"{n_live} of {n_slots} slots live ({n_live / n_slots:.4f}); rel "
          f"err J={errs[0]:.3e} drho={errs[1]:.3e} (tol {TOL_K1}); two "
          f"launches bit-equal", flush=True)
    vs_rho = None
    if drho_vs_rho:
        D = parts[1]
        rho_scale = float(cuda_fused.fused_onehot_contract_plain(
            **rho_endpoint_ops(ops))[..., D].abs().max())
        drho_scale = float(plain[..., D].abs().max())
        # The planted fault: each z offset that carries weight dropped in
        # turn; the smallest reading is the one the gate must still see
        faults = {}
        for o, zw in enumerate(ops["span"]["zw_b"]):
            if float(zw.abs().sum()) == 0:
                continue
            fault = cuda_fused.fused_onehot_contract(
                **dropped_offset_ops(ops, o))
            faults[o] = float((fault[..., D] - plain[..., D]).abs().max()
                              ) / rho_scale
            del fault
        vs_rho = dict(
            kernel=float((kern[..., D] - plain[..., D]).abs().max())
            / rho_scale,
            planted_fault=min(faults.values()), planted_faults=faults,
            drho_over_rho=drho_scale / rho_scale)
        print(f"K1 {label} d(rho) relative to rho_next: kernel "
              f"{vs_rho['kernel']:.3e}, planted fault (one dropped z offset; "
              f"by offset {faults}) at least {vs_rho['planted_fault']:.3e} "
              f"(gate: kernel <= {TOL_K1} < fault); max |d(rho)| / max "
              f"|rho_next| = {vs_rho['drho_over_rho']:.3e}", flush=True)
        ok = (errs[0] <= TOL_K1 and vs_rho["kernel"] <= TOL_K1
              and vs_rho["planted_fault"] > TOL_K1)
    else:
        ok = max(errs) <= TOL_K1
    if not all(np.isfinite(errs)) or not ok:
        raise RuntimeError(f"K1 ({label}) disagrees with its plain version: "
                           f"{errs}, d(rho) relative to rho_next {vs_rho}")
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
    return dict(max_abs_err=max_abs, rel_err=max(errs), drho_vs_rho=vs_rho,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
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


def eager_steps(sim, n_steps):
    """The eager twin of sim.step(n_steps): the preparation, the
    diagnostics' first write, then Simulation's eager loop
    (``_run_eager``: the eager step function n_steps times, the
    antennas' series per fbpic_tpu chunk, the capturing diagnostics'
    capture and the plain writers after each step), the captures
    consumed, then the overflow read -- the loop Simulation.step runs
    where the configuration keeps it (a ``loop`` reason of
    core/graph.py's graph_blockers)."""
    from fbpic_tpu_torch.core.step import make_prepare
    options = sim.build_options()
    sim.state = make_prepare(sim.config, sim.species_configs, options)(
        sim.state, sim.aux)
    for diag in sim.diags:
        diag.write(sim)
    writers = list(sim.diags) + list(sim.checkpoints)
    capture = [w for w in writers if hasattr(w, "capture")]
    sim._run_eager(n_steps, options, capture,
                   [w for w in writers if w not in capture], None)
    for w in capture:
        w.process_captures(sim)
    sim._consume_overflow_counters()


def lost(totals):
    """The overflow totals that count lost or dropped particles (not the
    chunk runner's rollbacks, which lose nothing)."""
    return {k: v for k, v in totals.items() if k != "rollbacks" and v}


def capture_calls(sim, module, name):
    """The (args, kwargs) of every call of module.<name> (a kernel
    wrapper, or the function of the step that calls one) during one more
    step of the running simulation: its eager step where the
    configuration takes the chunk runner (a replayed step runs no
    Python; a captured one's arguments are the graph's, not yet
    computed), else sim.step(1)."""
    from fbpic_tpu_torch.core.graph import graph_blockers
    real = getattr(module, name)
    calls = []

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, recorder)
    try:
        if graph_blockers(sim, sim.build_options()).loop:
            sim.step(1)
        else:
            eager_steps(sim, 1)
    finally:
        setattr(module, name, real)
    if not calls:
        raise RuntimeError(f"the step did not call {name}")
    return calls


def phase_k1_resident(sim, label="resident LWFA layout"):
    """K1 on the operands of the running simulation's own deposit."""
    import inspect
    from fbpic_tpu_torch.particles import cuda_fused, sorted_deposit
    (args, kwargs), = capture_calls(sim, sorted_deposit,
                                    "fused_onehot_contract")
    ops = inspect.signature(cuda_fused.fused_onehot_contract_plain).bind(
        *args, **kwargs).arguments
    return measure_k1(dict(ops), label)


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
    if not torch.is_tensor(ops["zmin"]):
        # K2 reads zmin from device memory: a 0-d tensor, made once here
        # (a host number would add a fill launch to every call)
        ops = dict(ops, zmin=torch.full((), float(ops["zmin"]),
                                        dtype=ops["xp"].dtype,
                                        device=ops["xp"].device))
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
                           zmin=torch.full((), sim.zmin, dtype=dtype,
                                           device=DEVICE),
                           Nz=cfg.Nz, invdr=1 / cfg.dr,
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


#: What torch's CUDA sync debug mode warns at a blocking call (its other
#: warning, once a process, says the mode is a prototype)
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(sim, label, n_steps=1, run=None):
    """Host synchronizations of one more step(n_steps) call (or of
    run(n_steps)), as torch's CUDA sync debug mode reports them (a
    warning for every blocking call), by the line of the port (or of
    chip_smoke) that made them: the innermost frame of the call stack in
    fbpic_tpu_torch, whatever torch function the warning names."""
    import collections
    import os
    import traceback
    import warnings
    import torch
    torch.cuda.synchronize()
    where = collections.Counter()

    def record(message, category, filename, lineno, *args, **kwargs):
        if SYNC_WARNING not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if "fbpic_tpu_torch" in f.filename]
        f = frames[-1] if frames else None
        where[f"{os.path.relpath(f.filename)}:{f.lineno}" if f
              else f"{os.path.relpath(filename)}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            (run or sim.step)(n_steps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n = sum(where.values())
    print(f"host syncs in one {label} step({n_steps}) call (torch.cuda "
          f"sync debug mode): {n} {dict(where)}", flush=True)
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
    if lost(sim.overflow_totals):
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
        random_seed=0, verbose_level=0, device=DEVICE,
        dtype=dtype or torch.float32)
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


#: The host's launch calls as the profiler names them: a kernel launch
#: and a CUDA graph's replay (one call for all the graph's kernels)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cudaGraphLaunch")


#: Kernel groups of a step's device time (``kernel_groups``): the first
#: group whose pattern a kernel's name matches takes its time
KERNEL_GROUPS = (
    ("K1", r"fused_contract_kernel"), ("K2", r"gather_sorted_kernel"),
    ("K3", r"dense_contract_kernel"),
    ("cross-card copies", r"copy_parts_kernel"),
    ("cross-card flag waits", r"flag_kernel"),
    ("sort / scan", r"[Ss]ort|[Ss]can|cub::|Onesweep|Histogram"),
    ("FFT (cuFFT)", r"fft|FFT"),
    ("GEMM / batched matmul (cuBLAS)", r"gemm|gemv|cutlass|xmma|"
     r"Kernel2|nvjet|splitK"),
    ("index / scatter / gather", r"index|[Ss]catter|[Gg]ather|take|put_"),
    ("copy / cat / fill", r"[Cc]opy|[Cc]at[A-Z]|CatArray|fill|[Mm]emcpy|"
     r"[Mm]emset"),
    ("reduction", r"reduce|[Rr]eduction|sum_|norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"))


def kernel_groups(kernel_rows, n_steps):
    """{group: (ms a step, launches a step)} of the profiler's kernel
    rows, by KERNEL_GROUPS (the rest under "other")."""
    import re
    out = {}
    for ev in kernel_rows:
        group = next((g for g, pat in KERNEL_GROUPS
                      if re.search(pat, ev.key)), "other")
        ms, n = out.get(group, (0.0, 0.0))
        out[group] = (ms + ev.self_device_time_total / n_steps / 1e3,
                      n + ev.count / n_steps)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def card_times(events, n_steps):
    """{card index: ms a step} of the profiler's kernel events on each
    card: ``busy_ms`` (every kernel), ``flag_wait_ms`` (the cross-card
    exchange's flag kernels, csrc/peer.cu, which spin while a card
    waits for a peer), ``exchange_copy_ms`` (its copies) and
    ``busy_without_waits_ms``."""
    import torch
    out = {}
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        if us <= 0:
            continue
        card = out.setdefault(ev.device_index, dict(
            busy_ms=0.0, flag_wait_ms=0.0, exchange_copy_ms=0.0))
        ms = us / n_steps / 1e3
        card["busy_ms"] += ms
        if "flag_kernel" in ev.name:
            card["flag_wait_ms"] += ms
        elif "copy_parts_kernel" in ev.name:
            card["exchange_copy_ms"] += ms
    for card in out.values():
        card["busy_without_waits_ms"] = card["busy_ms"] - card["flag_wait_ms"]
    return dict(sorted(out.items()))


def profile_steps(sim, n_steps, run=None, breakdown=False):
    """Device time per step and the kernels that take it, from
    torch.profiler over n_steps steps (sim.step, or run(n)) (None when
    the profiler shows no device time); also the host's launch calls a
    step (HOST_LAUNCH_CALLS, each counted), and with ``breakdown`` the
    device time by kernel group (``kernel_groups``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run = run or sim.step
    run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n_steps)
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
    host_calls = {}
    for ev in prof.key_averages():
        if ev.key in HOST_LAUNCH_CALLS:
            host_calls[ev.key] = host_calls.get(ev.key, 0) + ev.count
    host_calls = {k: v / n_steps for k, v in host_calls.items()}
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:12]
    port = {k: sum(ev.self_device_time_total for ev in kernels
                   if name in ev.key) / n_steps / 1e3
            for k, name in PORT_KERNELS.items()}
    print(f"profiled {n_steps} steps: {wall / n_steps * 1e3:.4f} ms/step "
          f"wall under the profiler, {busy_us / n_steps / 1e3:.4f} ms/step "
          f"device busy, {n_launch:.1f} kernel launches/step; host launch "
          f"calls/step {host_calls}; the port's kernels, ms/step: {port}",
          flush=True)
    for ev in top:
        print(f"  {ev.self_device_time_total / n_steps / 1e3:9.4f} ms/step "
              f"{ev.count / n_steps:7.1f}/step  {ev.key[:90]}")
    per_card = card_times(prof.events(), n_steps)
    if len(per_card) > 1:
        print("  per card (ms/step): " + "; ".join(
            f"cuda:{c} busy {v['busy_ms']:.4f} (cross-card copies "
            f"{v['exchange_copy_ms']:.4f}, flag waits "
            f"{v['flag_wait_ms']:.4f})" for c, v in per_card.items()),
              flush=True)
    groups = None
    if breakdown:
        groups = kernel_groups(kernels, n_steps)
        print("  by kernel group (ms/step, launches/step): " + "; ".join(
            f"{g} {ms:.4f} ({n:.1f})" for g, (ms, n) in groups.items()),
              flush=True)
    return dict(device_ms_per_step=busy_us / n_steps / 1e3,
                kernel_groups=groups, per_card=per_card,
                profiled_wall_ms_per_step=wall / n_steps * 1e3,
                launches_per_step=n_launch,
                host_launch_calls_per_step=host_calls,
                kernel_ms_per_step=port,
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
    if lost(sim.overflow_totals):
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
                     verbose_level=0, device=DEVICE, dtype=dtype)
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
    if lost(sim.overflow_totals):
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


# ---------------------------------------------------------------------
# Diagnostics, checkpoints and tracking (phases 9-11)
# ---------------------------------------------------------------------

def h5py_available():
    import importlib.util
    return importlib.util.find_spec("h5py") is not None


def collect_only(diag, sink):
    """Without h5py, a diagnostic's writes go to ``sink`` (a list of
    {file name: Records}) instead of a file: the collect step runs as in
    a run that writes, and nothing is written in another format."""
    diag.write_records = sink.append


def cuda_wall_ms(fn, n=3):
    """Mean host time of fn() over n calls, each synchronized."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def count_syncs_n(sim, label, n_steps):
    """Host synchronizations of one step(n_steps) call (count_syncs: by
    the port's line that made each): their number, and how many came
    from the back-transformed field diagnostic's code."""
    syncs = count_syncs(sim, label, n_steps)
    n_btd = sum(n for w, n in syncs["where"].items()
                if "boosted_diag.py" in w)
    print(f"host syncs in one step({n_steps}) call, {label}: "
          f"{syncs['count']}, {n_btd} of them in "
          f"diagnostics/boosted_diag.py", flush=True)
    return dict(count=syncs["count"], btd=n_btd)


def timed_steps(sim, label, n_timed=N_COST):
    """ms/step of n_timed synchronized steps, then device busy from a
    profiled window."""
    import torch
    sim.step(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(n_timed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    prof = profile_steps(sim, N_PROFILED)
    busy = None if prof is None else prof["device_ms_per_step"]
    print(f"{label}: {ms:.4f} ms/step, device busy {busy} ms/step",
          flush=True)
    return dict(ms_per_step=ms, device_ms_per_step=busy,
                launches_per_step=None if prof is None
                else prof["launches_per_step"])


def make_lwfa_script_sim():
    """examples/lwfa_script.py:54-70 as written (full width), tracked,
    with its field and particle diagnostics (every LWFA_DIAG_PERIOD
    steps) and its periodic checkpoint; random_seed = 0 (the script
    leaves it unset)."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    dt = (ZMAX - ZMIN) / NZ / c
    sim = Simulation(NZ, ZMAX, NR, RMAX, NM, dt, p_zmin=P_ZMIN,
                     p_zmax=P_ZMAX, p_rmin=0., p_rmax=P_RMAX, p_nz=P_NZ,
                     p_nr=P_NR, p_nt=P_NT, n_e=N_E, zmin=ZMIN, n_order=32,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, device=DEVICE, dtype=torch.float32)
    elec = sim.ptcl[0]
    elec.track(sim.comm)
    add_laser_pulse(sim, GaussianLaser(a0=A0, waist=W0, tau=TAU, z0=Z0))
    sim.set_moving_window(v=c)
    return sim, elec


def state_difference(a, b):
    """{tensor name: largest |a - b|} of two checkpoint dicts, and the
    names that are equal bit for bit."""
    import torch
    diffs, exact = {}, []
    for key, t in a["tensors"].items():
        u = b["tensors"][key]
        if torch.equal(t, u):
            exact.append(key)
        diffs[key] = float((t - u).abs().max()) \
            if t.is_floating_point() or t.is_complex() else \
            float((t != u).sum())
    return diffs, exact


def phase_lwfa_script(counters, untracked_ms, workdir):
    """examples/lwfa_script.py as written on the card: tracked, its
    diagnostics every 50 steps (collected; written only where h5py is
    installed), a checkpoint every 100, 200 steps in two step() calls;
    exact K1 / K2 launches, unique ids, next_id against the injected
    candidates, a bit-exact checkpoint round trip, a restart from the
    iteration-100 checkpoint continued to 200 against the uninterrupted
    run, the cost of each collect and of a checkpoint write and read,
    tracking on / off, and the host syncs of one step."""
    import os
    import torch
    from fbpic_tpu_torch.diagnostics import (
        FieldDiagnostic, ParticleDiagnostic, set_periodic_checkpoint,
        restart_from_checkpoint)
    from fbpic_tpu_torch.diagnostics.checkpoint_restart import (
        checkpoint_dict, checkpoint_path, load_checkpoint_dict,
        read_checkpoint, write_checkpoint)
    have_h5py = h5py_available()
    print("h5py is " + ("installed: the diagnostics write their files" if
                        have_h5py else "not installed on this machine: the "
                        "diagnostics run their collect step and write "
                        "nothing"), flush=True)
    diag_dir = os.path.join(workdir, "diags")
    ckpt_dir = os.path.join(workdir, "checkpoints")
    sim, elec = make_lwfa_script_sim()
    sp0 = sim.state.species[0]
    n_tracked = int(sp0.next_id) - 1
    z_end0 = float(sp0.inj_z_end)
    col_size = sim._injector_auxes[0].r.shape[0]
    dz_p = sim._injector_configs[0].dz_particles
    sim.diags = [
        FieldDiagnostic(LWFA_DIAG_PERIOD, sim.fld, comm=sim.comm,
                        write_dir=diag_dir),
        ParticleDiagnostic(LWFA_DIAG_PERIOD, {"electrons": elec},
                           select={"uz": [1., None]}, comm=sim.comm,
                           write_dir=diag_dir)]
    sinks = [[] for _ in sim.diags]
    if not have_h5py:
        for diag, sink in zip(sim.diags, sinks):
            collect_only(diag, sink)
    set_periodic_checkpoint(sim, LWFA_CHECKPOINT_PERIOD,
                            checkpoint_dir=ckpt_dir)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sim.step(LWFA_STEPS // 2)
    sim.step(LWFA_STEPS // 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"lwfa_script as written: {LWFA_STEPS} steps in {wall:.2f} s "
          f"with its diagnostics and checkpoints; launches {launches}; "
          f"overflow totals {sim.overflow_totals}", flush=True)
    if launches != {"K1": LWFA_STEPS, "K2": LWFA_STEPS, "K3": 0}:
        raise RuntimeError(f"lwfa_script launches {launches}, not one K1 "
                           f"and one K2 a step")
    if lost(sim.overflow_totals):
        raise RuntimeError(f"lwfa_script overflow {sim.overflow_totals}")
    check_fields(sim, "lwfa_script")
    # Diagnostics: written files read back, or the collected records
    want = [i * LWFA_DIAG_PERIOD
            for i in range(LWFA_STEPS // LWFA_DIAG_PERIOD + 1)]
    if have_h5py:
        import h5py
        files = sorted(os.listdir(os.path.join(diag_dir, "hdf5")))
        if files != ["data%08d.h5" % i for i in want]:
            raise RuntimeError(f"diagnostic files {files}")
        with h5py.File(os.path.join(diag_dir, "hdf5", files[-1]), "r") as f:
            n_sel = f["/data/%d/particles/electrons/weighting" % want[-1]] \
                .shape[0]
    else:
        # (each step() call also writes at its start: iteration 100
        # twice, as in fbpic_tpu)
        iters = [sorted({int(name[4:12]) for files in sink for name in files})
                 for sink in sinks]
        if any(its != want for its in iters):
            raise RuntimeError(f"collected iterations {iters} != {want}")
        rec = sinks[1][-1]["data%08d.h5" % want[-1]]
        n_sel = rec["/data/%d/particles/electrons/weighting"
                    % want[-1]][0].shape[0]
        for sink in sinks:
            del sink[:]
    print(f"diagnostics at iterations {want}; {n_sel} electrons with "
          f"uz > 1 at iteration {want[-1]}", flush=True)
    # Tracking: unique ids, the id counter
    sp = sim.state.species[0]
    ids = sp.ids[sp.w != 0]
    n_unique = int(torch.unique(ids).numel())
    candidates = int(round((float(sp.inj_z_end) - z_end0) / dz_p)) \
        * col_size
    next_id = int(sp.next_id)
    print(f"tracking: {ids.numel()} live ids, {n_unique} unique, "
          f"{int((ids == 0).sum())} zero; next_id {next_id} = 1 + "
          f"{n_tracked} numbered + {candidates} injected candidates",
          flush=True)
    if n_unique != ids.numel() or int((ids == 0).sum()):
        raise RuntimeError("tracking ids not unique among live slots")
    if next_id != 1 + n_tracked + candidates:
        raise RuntimeError(f"next_id {next_id} != 1 + {n_tracked} + "
                           f"{candidates}")
    # Checkpoints: the round trip, write / read times
    uninterrupted = checkpoint_dict(sim)
    path = checkpoint_path(LWFA_STEPS, ckpt_dir)
    write_ms = cuda_wall_ms(lambda: write_checkpoint(sim, path))
    read_ms = cuda_wall_ms(lambda: read_checkpoint(path, sim.device))
    size_mb = os.path.getsize(path) / 1e6
    again, _ = make_lwfa_script_sim()
    t0 = time.perf_counter()
    load_checkpoint_dict(again, read_checkpoint(path, again.device))
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    diffs, exact = state_difference(uninterrupted, checkpoint_dict(again))
    round_trip_exact = len(exact) == len(diffs) and \
        uninterrupted["host"] == checkpoint_dict(again)["host"]
    print(f"checkpoint of {size_mb:.1f} MB: write {write_ms:.2f} ms, read "
          f"{read_ms:.2f} ms, read + load {load_ms:.2f} ms; save -> load "
          f"round trip bit-exact: {round_trip_exact} ({len(exact)} of "
          f"{len(diffs)} tensors)", flush=True)
    if not round_trip_exact:
        raise RuntimeError(f"checkpoint round trip differs: "
                           f"{[k for k in diffs if k not in exact]}")
    # Restart from iteration 100, continued to 200
    del again
    restarted, _ = make_lwfa_script_sim()
    restart_from_checkpoint(restarted, iteration=LWFA_CHECKPOINT_PERIOD,
                            checkpoint_dir=ckpt_dir)
    restarted.step(LWFA_STEPS - LWFA_CHECKPOINT_PERIOD)
    diffs, exact = state_difference(uninterrupted,
                                    checkpoint_dict(restarted))
    same_host = uninterrupted["host"] == checkpoint_dict(restarted)["host"]
    print(f"restart from iteration {LWFA_CHECKPOINT_PERIOD} continued to "
          f"{LWFA_STEPS}: host values equal {same_host}; exact: {exact}; "
          f"largest difference per array: "
          f"{ {k: v for k, v in diffs.items() if k not in exact} }",
          flush=True)
    del restarted
    torch.cuda.empty_cache()
    # Cost of each collect
    collect_ms = {type(d).__name__: cuda_wall_ms(lambda d=d: d.collect(sim))
                  for d in sim.diags}
    print(f"ms per collect at iteration {sim.iteration}: {collect_ms}",
          flush=True)
    sim.diags, sim.checkpoints = [], []
    syncs = count_syncs(sim, "lwfa_script, tracked")
    on = timed_steps(sim, "lwfa_script, tracking on")
    ids_kept = sim.state.species[0].ids
    sim.state.species[0] = sim.state.species[0].replace(ids=None)
    off = timed_steps(sim, "lwfa_script, tracking off")
    sim.state.species[0] = sim.state.species[0].replace(
        ids=torch.zeros_like(ids_kept))
    on2 = timed_steps(sim, "lwfa_script, tracking on again")
    print(f"tracking cost (this call): on {on['ms_per_step']:.4f} / "
          f"{on2['ms_per_step']:.4f}, off {off['ms_per_step']:.4f} ms/step; "
          f"device busy on {on['device_ms_per_step']} / "
          f"{on2['device_ms_per_step']}, off {off['device_ms_per_step']} "
          f"(phase 3, untracked, same config: {untracked_ms:.4f} ms/step)",
          flush=True)
    return launches, dict(
        steps=LWFA_STEPS, wall_s=wall, selected_uz_gt_1=n_sel,
        live_ids=int(ids.numel()), next_id=int(sp.next_id),
        injected_candidates=candidates, checkpoint_mb=size_mb,
        checkpoint_write_ms=write_ms, checkpoint_read_ms=read_ms,
        checkpoint_load_ms=load_ms, round_trip_exact=round_trip_exact,
        restart_exact=sorted(exact), restart_max_diff={
            k: v for k, v in diffs.items() if k not in exact},
        collect_ms=collect_ms, host_syncs_per_step=syncs["count"],
        tracking_on=on, tracking_off=off, tracking_on_again=on2,
        h5py=have_h5py)


def make_diag_config_sim(device, workdir):
    """tests/test_diagnostics.py's configuration, float64, the resident
    layout forced (sort_K), tracked, with the field, particle (select, E,
    B, gamma, id), charge-density and back-transformed particle
    diagnostics, their writes collected
    (tests/test_torch_cuda.py::_diag_config_sim)."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    Nz, Nr, Nm, zmax, rmax = 64, 16, 2, 6.4e-6, 8.e-6
    dt = zmax / Nz / c
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, dt, random_seed=0,
                     device=device, dtype=torch.float64)
    sim.use_fused_deposit = True
    view = sim.add_new_species(q=-e, m=m_e, n=1.e24, p_zmin=0.,
                               p_zmax=zmax, p_rmin=0., p_rmax=6.e-6,
                               p_nz=1, p_nr=1, p_nt=4, sort_K=128)
    view.track()
    attach_diags(sim, workdir)
    return sim


def attach_diags(sim, workdir):
    """make_diag_config_sim's diagnostics, new, on sim's species."""
    from fbpic_tpu_torch import diagnostics as d
    view = sim.ptcl[0]
    sim.diags = [
        d.FieldDiagnostic(4, sim, write_dir=workdir),
        d.ParticleDiagnostic(
            4, species={"electrons": view}, select={"x": [0.0, None]},
            particle_data=("position", "momentum", "weighting", "E", "B",
                           "gamma", "id"), write_dir=workdir, sim=sim),
        d.ParticleChargeDensityDiagnostic(4, sim,
                                          species={"electrons": view},
                                          write_dir=workdir),
        d.BackTransformedParticleDiagnostic(
            0., sim.zmax, 0., 3 * sim.dt, 2, 5.0, sim=sim,
            species={"electrons": view}, write_dir=workdir)]
    for diag in sim.diags:
        collect_only(diag, [])


def collect_records(sim):
    """Every diagnostic of sim collected at its state; the
    back-transformed particle diagnostic first catches the particles
    that crossed its planes in the last step (its write at this time,
    from z - vz dt), then gives its snapshots."""
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


def phase_diag_card_vs_cpu(workdir):
    """Card against the card machine's CPU, float64: 8 steps of
    tests/test_diagnostics.py's configuration with its diagnostics on
    the CPU, the state carried to the card (a checkpoint dict), and every
    diagnostic collected from that one state on both devices, the
    records held against each other.  (Stepped apart, the two runs'
    fields differ at O(1): at rest and with no initial field, this
    configuration's fields are the roundoff of rho_next - rho_prev over
    dt, summed in another order on each device.)"""
    import warnings
    import torch
    from fbpic_tpu_torch.diagnostics.checkpoint_restart import (
        checkpoint_dict, load_checkpoint_dict)
    from fbpic_tpu_torch.diagnostics.generic import records_difference
    cpu = make_diag_config_sim("cpu", workdir)
    cpu.step(8)
    card = make_diag_config_sim(DEVICE, workdir)
    with warnings.catch_warnings():
        # no injection here: the generator's state does not matter
        warnings.simplefilter("ignore", RuntimeWarning)
        load_checkpoint_dict(card, checkpoint_dict(cpu))
    attach_diags(cpu, workdir)
    runs = [collect_records(sim) for sim in (card, cpu)]
    errs = records_difference(runs[1], runs[0])
    worst = max(errs.items(), key=lambda kv: kv[1])
    n_ids = sum(rec[p][0].shape[0] for rec in runs[0].values() for p in rec
                if p.endswith("/id"))
    print(f"collect, card against CPU (float64, the state after 8 steps): "
          f"{len(runs[0])} files, {len(errs)} float datasets, {n_ids} ids "
          f"equal; largest difference {worst[1]:.3e} ({worst[0]}; tol "
          f"{TOL_COLLECT})", flush=True)
    if not worst[1] <= TOL_COLLECT:
        raise RuntimeError(f"collected records differ: {worst}")
    del runs
    torch.cuda.empty_cache()
    return dict(files=len(errs), max_rel_err=worst[1], worst=worst[0],
                ids=n_ids)


def btd_reference_slices(sim, btd):
    """The planes of capture_slices from get_interp_field's grids
    (physical rows), interpolated with the same row and weight as the
    capture (computed by the same ops on the device): {name: (Nm, S',
    Nr)} over the S' valid planes whose two rows are physical, the
    field's largest value under name + "_scale", and those planes."""
    import torch
    from fbpic_tpu_torch.constants import c
    valid, _, _ = btd.capture_slices(sim)
    st, cfg = sim.state, sim.config
    t_lab = btd._t_lab[(st.interp.Er.device, st.interp.Er.real.dtype)]
    z_b = (t_lab / btd.gamma_boost - float(st.time)) * c \
        / btd.beta_boost
    iz_f = (z_b - float(st.zmin)) / cfg.dz - 0.5
    iz0 = torch.clamp(torch.floor(iz_f).long(), 0, cfg.Nz - 2)
    s1 = torch.clamp(iz_f - iz0.to(iz_f.dtype), 0.0, 1.0)
    iz0 = iz0.cpu().numpy() - sim.nd_edge
    s1, valid = s1.cpu().numpy(), valid.cpu().numpy()
    use = [s for s in range(len(iz0))
           if valid[s] and 0 <= iz0[s] < sim.Nz_phys - 1]
    ref = {}
    for name in btd.names:
        F = sim.get_interp_field(name)
        ref[name] = np.stack([(1 - s1[s]) * F[:, iz0[s]]
                              + s1[s] * F[:, iz0[s] + 1] for s in use],
                             axis=1)
        ref[name + "_scale"] = np.abs(F).max()
    return ref, use


def phase_boosted_btd(counters, workdir):
    """The boosted resident cell with the script's back-transformed field
    diagnostic (20 snapshots 50 fs apart): ~100 steps with exact K2 / K3
    launch counts, the slices of a few steps against get_interp_field's
    grids, the BTD's added ms/step and device busy (off / on / off), and
    the host syncs of step(1) and step(10) calls with it on and off."""
    import torch
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.diagnostics import BackTransformedFieldDiagnostic
    sim = make_boosted_sim()
    btd = BackTransformedFieldDiagnostic(
        B_ZMIN_LAB, B_ZMAX_LAB, c, dt_snapshots_lab=BTD_DT_LAB,
        Ntot_snapshots_lab=BTD_NSNAP, gamma_boost=B_GAMMA,
        period=BTD_PERIOD, fldobject=sim.fld, comm=sim.comm,
        write_dir=workdir)
    flushed = []
    collect_only(btd, flushed)
    sim.diags = [btd]
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sim.step(BTD_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    filled = [int(s.filled.sum()) for s in btd.snapshots]
    print(f"boosted cell with the field BTD: {BTD_STEPS} steps in "
          f"{wall:.2f} s; launches {launches}; lab cells filled per "
          f"snapshot {filled}; {len(flushed)} snapshots complete",
          flush=True)
    if launches != {"K1": 0, "K2": BTD_STEPS, "K3": 2 * BTD_STEPS}:
        raise RuntimeError(f"boosted BTD launches {launches}")
    if sum(filled) == 0:
        raise RuntimeError("the BTD filled no lab cell")
    check_fields(sim, "boosted BTD")
    # Slices of a few steps against get_interp_field's grids
    worst = 0.0
    n_planes = 0
    for _ in range(3):
        sim.step(7)
        slices = btd.capture_slices(sim)[2].cpu().numpy()
        ref, use = btd_reference_slices(sim, btd)
        n_planes += len(use)
        for f, name in enumerate(btd.names):
            err = np.abs(slices[f][:, use] - ref[name]).max(initial=0.0) \
                / ref[name + "_scale"]
            worst = max(worst, float(err))
    print(f"BTD slices against get_interp_field's grids: {n_planes} planes "
          f"over 3 steps, largest difference {worst:.3e} of the field's "
          f"largest value (tol {TOL_BTD_SLICES})", flush=True)
    if n_planes == 0 or not worst <= TOL_BTD_SLICES:
        raise RuntimeError(f"BTD slices differ: {worst} over {n_planes}")
    syncs = {"on": {n: count_syncs_n(sim, "BTD on", n) for n in (1, 10)}}
    on = timed_steps(sim, "boosted cell, BTD on")
    sim.diags = []
    syncs["off"] = {n: count_syncs_n(sim, "BTD off", n) for n in (1, 10)}
    off = timed_steps(sim, "boosted cell, BTD off")
    sim.diags = [btd]
    on2 = timed_steps(sim, "boosted cell, BTD on again")
    # The BTD's own syncs come per step() call (the capture at its start,
    # in boosted_diag.py), not per step; its captures inside the chunk
    # come back with the chunk's one read (core/graph.py): a step(n)
    # call of one chunk makes 2 syncs with the BTD, 1 without
    per_step = (syncs["on"][10]["btd"] - syncs["on"][1]["btd"]) / 9
    print(f"BTD cost (this call): on {on['ms_per_step']:.4f} / "
          f"{on2['ms_per_step']:.4f}, off {off['ms_per_step']:.4f} ms/step; "
          f"device busy on {on['device_ms_per_step']} / "
          f"{on2['device_ms_per_step']}, off {off['device_ms_per_step']}; "
          f"launches/step on {on['launches_per_step']}, off "
          f"{off['launches_per_step']}; host syncs the BTD adds per step: "
          f"{per_step}", flush=True)
    if per_step != 0:
        raise RuntimeError(f"the BTD capture adds {per_step} syncs a step")
    want = {"on": dict(count=2, btd=1), "off": dict(count=1, btd=0)}
    if any(syncs[k][n] != v for k, v in want.items() for n in (1, 10)):
        raise RuntimeError(f"BTD host syncs {syncs}, not {want} a call")
    return launches, dict(steps=BTD_STEPS, wall_s=wall, filled=filled,
                          slices_max_rel_err=worst, planes=n_planes,
                          host_syncs=syncs, btd_on=on, btd_off=off,
                          btd_on_again=on2)

# ---------------------------------------------------------------------
# Cubic shapes with the radial PML, cross-deposition, physics gates
# (phases 12-14)
# ---------------------------------------------------------------------

def check_pml_fields(sim, what):
    for name in ("Er_pml", "Et_pml", "Br_pml", "Bt_pml"):
        if not bool(getattr(sim.state.interp, name).isfinite().all()):
            raise RuntimeError(f"{what}: non-finite {name}")


def check_live_count(sim, label):
    """The live particles must be the plasma's columns from its left
    edge (P_ZMIN, cell-aligned) to the injection front, each of
    dz / p_nz and Npr * p_nt particles: exact while the plasma has not
    reached the left removal bound (these runs are far from it)."""
    sp = sim.state.species[0]
    inj = sim._injector_configs[0]
    col_size = sim._injector_auxes[0].r.shape[0]
    want = int(round((float(sp.inj_z_end) - P_ZMIN) / inj.dz_particles)) \
        * col_size
    live = sim.ptcl[0].Ntot
    print(f"{label}: {live} live particles, {want} reckoned from the "
          f"injection front ({col_size} a column)", flush=True)
    if live != want:
        raise RuntimeError(f"{label}: {live} live particles, {want} "
                           f"reckoned")
    return live


def profiled(sim, metrics, label):
    """count_syncs and profile_steps of a path, with its idle share."""
    syncs = count_syncs(sim, label)
    prof = profile_steps(sim, N_PROFILED)
    if prof is not None:
        prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                  / metrics["ms_per_step"])
    metrics["profile"] = prof
    metrics["host_syncs_per_step"] = syncs["count"]
    return syncs


def measure_torch_op(fn, ref, label, n_bytes, n_flops, library=None):
    """A PyTorch function of the step timed on its captured operands:
    CUDA-event ms, the bound of its bytes and operations, and a library
    call's time and agreement (rel err against fn's result) if given.
    fn() must reproduce ref, its first call, to 1e-5 relative (float32
    atomics sum in another order from call to call)."""
    out = fn()
    err = rel_err(out, ref)
    ms = cuda_ms(fn, n_warm=1, n_iter=5)
    b_ms, b_by = bound(n_bytes, n_flops)
    res = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
               n_bytes=n_bytes, n_flops=n_flops)
    text = ""
    if library is not None:
        lib_out, lib_ms = library()
        res["library_ms"] = lib_ms
        res["library_rel_err"] = rel_err(lib_out, out)
        text = (f", library (one-hot bmm) {lib_ms:.4f} ms (rel err "
                f"{res['library_rel_err']:.2e})")
        del lib_out
    print(f"{label}: {ms:.4f} ms{text}, bound {b_ms:.4f} ms by {b_by} "
          f"({n_bytes} bytes, {n_flops} operations)", flush=True)
    if not np.isfinite(err) or err > 1e-5:
        raise RuntimeError(f"{label}: two calls differ by {err}")
    res["repeat_rel_err"] = err
    return res


def phase_cubic_pml(counters):
    """12. The bench LWFA with cubic shapes and an open radial boundary
    (the PML's 32 cells inside Nr, so the grid widens by them: Nr = 82,
    rmax by 32 of the bench's dr), float32, 5 + 30 steps: the species
    is not resident (cubic), so it runs the ring with the mid-step
    payload sort, deposit_rho_J_sorted_cubic with d(rho) and
    gather_fields_cubic -- PyTorch ops, no K1, K2 or K3 launch; zero
    overflow, finite fields (the PML's too), the live count; peak
    memory, host syncs and a profiled window; then the cubic
    contraction (_contract: cat + index_add_) and the cubic gather timed
    on one step's own operands, the contraction beside the one-hot
    torch.bmm and beside a torch.cat of its blocks into one V."""
    import torch
    from fbpic_tpu_torch.core import step as step_mod
    from fbpic_tpu_torch.particles import sorted_deposit
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sim = make_sim(nr=PML_NR, rmax=PML_RMAX, r_boundary="open",
                   particle_shape="cubic")
    sc, cfg = sim.species_configs[0], sim.config
    if (sc.resident or sc.sort_K == 0 or sc.particle_shape != "cubic"
            or not cfg.use_pml or cfg.nr_damp != PML_NR_DAMP):
        raise RuntimeError(f"cubic + PML: unexpected layout {sc}, {cfg}")
    if abs(sim.get_rmax_gather() - RMAX) > 1e-12 * RMAX:
        raise RuntimeError(f"cubic + PML: rmax_gather "
                           f"{sim.get_rmax_gather()} != the bench's {RMAX}")
    label = "bench LWFA, cubic + radial PML"
    launches, metrics = drive_path(sim, counters, N_WARMUP, N_NEW_TIMED,
                                   label, {"K1": 0, "K2": 0, "K3": 0})
    check_pml_fields(sim, label)
    metrics["live_particles"] = check_live_count(sim, label)
    metrics["peak_memory_gb"] = (torch.cuda.max_memory_allocated()
                                 - base) / 1e9
    print(f"{label}: peak device memory {metrics['peak_memory_gb']:.3f} GB "
          f"above the {base / 1e9:.3f} GB held before the phase",
          flush=True)
    syncs = profiled(sim, metrics, label)

    (args, kwargs), = capture_calls(sim, sorted_deposit, "_contract")
    ir_buf, blocks, Nrb = args
    V = torch.cat(blocks, dim=2)
    Nz, K, W = V.shape
    ref = sorted_deposit._contract(ir_buf, blocks, Nrb)
    contraction = measure_torch_op(
        lambda: sorted_deposit._contract(ir_buf, blocks, Nrb), ref,
        f"cubic contraction ({len(blocks)} index_add_, one a block), "
        f"Nz={Nz} K={K} W={W} Nrb={Nrb}",
        n_bytes=V.numel() * 4 + ir_buf.numel() * 8 + Nz * Nrb * W * 4,
        n_flops=V.numel(), library=lambda: onehot_bmm(ir_buf, V, Nrb))
    contraction["concat_V_ms"] = cuda_ms(
        lambda: torch.cat(blocks, dim=2), n_warm=1, n_iter=5)
    contraction["index_add_on_V_ms"] = cuda_ms(
        lambda: sorted_deposit._contract(ir_buf, [V], Nrb), n_warm=1,
        n_iter=5)
    print(f"cubic contraction: torch.cat of the blocks into V (which "
          f"_contract does not build) {contraction['concat_V_ms']:.4f} ms; "
          f"one index_add_ on that V {contraction['index_add_on_V_ms']:.4f} "
          f"ms", flush=True)
    del V, blocks, ref, args
    (args, kwargs), = capture_calls(sim, step_mod, "gather_fields_cubic")
    x = args[0]
    Np, Nm = x.numel(), cfg.Nm
    ref = torch.stack(step_mod.gather_fields_cubic(*args, **kwargs))
    gather = measure_torch_op(
        lambda: torch.stack(step_mod.gather_fields_cubic(*args, **kwargs)),
        ref, f"cubic gather (16 index_select fetches of {12 * Nm} "
        f"channels), {Np} slots",
        n_bytes=Np * 4 * (6 + 6) + 4 * 12 * Nm * cfg.Nz * cfg.Nr,
        n_flops=Np * (16 * 12 * Nm * 3 + 6 * 4 * Nm))
    metrics.update(cubic_contraction=contraction, cubic_gather=gather)
    del sim, args, ref
    torch.cuda.empty_cache()
    return launches, metrics, syncs


def phase_cross_deposition(counters):
    """13. The bench LWFA with current_correction = 'cross-deposition'
    (linear shapes, reflective r), float32, 5 + 30 steps: the species is
    sized resident, but the step runs it non-resident (no resident
    species under cross-deposition): the linear gather, the legacy
    column sort at mid-step, K3 for J and for rho_next (twice a step),
    the two cross-deposition charge deposits as scatter deposits, and
    the exchange block every step (injection moves the ring cursor
    every step); zero K1 and K2, zero overflow, finite fields, the live
    count; host syncs and a profiled window; K3 on one step's two calls
    against its plain version and its one-hot bmm, timed."""
    import torch
    from fbpic_tpu_torch.particles import sorted_deposit
    sim = make_sim(current_correction="cross-deposition")
    sc = sim.species_configs[0]
    if not sc.resident or sc.sort_K == 0:
        raise RuntimeError(f"cross-deposition: the species is not sized "
                           f"resident: {sc}")
    label = "bench LWFA, cross-deposition"
    launches, metrics = drive_path(sim, counters, N_WARMUP, N_NEW_TIMED,
                                   label, {"K1": 0, "K2": 0, "K3": 2})
    metrics["live_particles"] = check_live_count(sim, label)
    cursors = [int(sim.state.species[0].next_free)]
    for _ in range(2):
        sim.step(1)
        cursors.append(int(sim.state.species[0].next_free))
    if len(set(cursors)) != 3:
        raise RuntimeError(f"{label}: the exchange block did not run every "
                           f"step (ring cursor {cursors})")
    syncs = profiled(sim, metrics, label)
    calls = capture_calls(sim, sorted_deposit, "dense_onehot_contract")
    if len(calls) != 2:
        raise RuntimeError(f"{label}: {len(calls)} K3 calls in a step")
    windows = [measure_k3(args, f"{window} window, {label} (legacy plan)",
                          True)
               for window, (args, _) in zip(("J", "rho"), calls)]
    k3 = dict(k3_step_total(windows, label),
              rel_err=max(w["rel_err"] for w in windows),
              max_abs_err=max(w["max_abs_err"] for w in windows))
    del sim, calls
    torch.cuda.empty_cache()
    return launches, metrics, syncs, k3


# tests/test_pml.py: a tightly focused laser diffracting into the radial
# boundary; the inner third of the radial grid against a 4x wider box
PMLT_NZ, PMLT_NR, PMLT_NM, PMLT_ZMAX, PMLT_RMAX = 180, 32, 2, 18.e-6, 8.e-6
PMLT_LASER = dict(a0=0.01, waist=2.0e-6, tau=6.e-15, z0=9.e-6)
PMLT_STEPS, PMLT_RATIO = 400, 30.0
# tests/test_periodic_plasma_wave.py: a linear plasma eigenmode in modes
# 0, 1, 2 against the closed form after 0.75 plasma periods
PW = dict(Nz=200, zmax=40.e-6, Nr=64, rmax=20.e-6, Nm=3, n_order=16,
          p_zmin=0.e-6, p_zmax=41.e-6, p_rmin=0., p_rmax=18.e-6, n_e=2.e24,
          p_nz=2, p_nr=2, p_nt=8)
PW_EPS, PW_W0, PW_NPER = (0.001, 0.001, 0.001), 5.e-6, 3
PW_ATOL, PW_RTOL = 1.1e6, 2e-2
# tests/test_uniform_rho.py
UR = dict(Nz=250, zmax=20.e-6, Nr=50, rmax=20.e-6, Nm=2, p_nr=8, p_nz=1,
          p_nt=4, p_rmax=10.e-6, n=9.e24)


def pml_absorption_gate(dtype):
    """tests/test_pml.py: the inner-third field error of the PML run and
    of the reflective run against a radially 4x larger box, 400 steps
    each; the PML must cut it by >= 30x."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    t0 = time.perf_counter()

    def run(boundaries_r, nr, rmax):
        sim = Simulation(PMLT_NZ, PMLT_ZMAX, nr, rmax, PMLT_NM,
                         PMLT_ZMAX / PMLT_NZ / c, n_order=16,
                         boundaries={"z": "periodic", "r": boundaries_r},
                         n_damp={"z": 0, "r": 16}, random_seed=0,
                         verbose_level=0, device=DEVICE, dtype=dtype)
        add_laser_pulse(sim, GaussianLaser(**PMLT_LASER))
        sim.step(PMLT_STEPS, correct_currents=False)
        return {n: sim.get_interp_field(n) for n in ("Er", "Et", "Ez")}

    truth = run("reflective", 4 * PMLT_NR, 4 * PMLT_RMAX)
    inner = PMLT_NR // 3

    def error(fields):
        return float(sum(np.sum(np.abs(fields[n][:, :, :inner]
                                       - truth[n][:, :, :inner]) ** 2)
                         for n in fields))

    err_pml = error(run("open", PMLT_NR, PMLT_RMAX))
    err_refl = error(run("reflective", PMLT_NR, PMLT_RMAX))
    ratio = err_refl / err_pml
    print(f"PML absorption gate ({str(dtype)[6:]}): inner reflection error "
          f"pml {err_pml:.4e}, reflective {err_refl:.4e}, ratio "
          f"{ratio:.2f} (gate >= {PMLT_RATIO}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if not ratio >= PMLT_RATIO:
        raise RuntimeError(f"PML absorption gate failed: {ratio}")
    return dict(err_pml=err_pml, err_reflective=err_refl, ratio=ratio)


def plasma_wave_gate(shape, dtype, device=None):
    """tests/test_periodic_plasma_wave.py at its tolerances (atol 1.1e6,
    rtol 2e-2 on Ez and Er in the theta = 0 half-plane)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, epsilon_0
    t0 = time.perf_counter()
    k0 = 2 * np.pi / PW["zmax"] * PW_NPER
    wp = np.sqrt(PW["n_e"] * e**2 / (m_e * epsilon_0))
    dt = PW["zmax"] / PW["Nz"] / c
    n_step = int(2 * np.pi / (wp * dt) * 0.75)
    sim = Simulation(PW["Nz"], PW["zmax"], PW["Nr"], PW["rmax"], PW["Nm"],
                     dt, PW["p_zmin"], PW["p_zmax"], PW["p_rmin"],
                     PW["p_rmax"], PW["p_nz"], PW["p_nr"], PW["p_nt"],
                     PW["n_e"], n_order=PW["n_order"], particle_shape=shape,
                     random_seed=0, verbose_level=0,
                     device=device or DEVICE, dtype=dtype)
    ptcl = sim.ptcl[0]
    x, y, z = ptcl.x, ptcl.y, ptcl.z
    env = np.exp(-(x**2 + y**2) / PW_W0**2)
    e0, e1, e2 = PW_EPS
    a = c / wp
    ux = (e0 * a * 2 * x / PW_W0**2 - e1 * a * 2 / PW_W0
          + e1 * a * 4 * x**2 / PW_W0**3 - e2 * a * 8 * x / PW_W0**2
          + e2 * a * 8 * x * (x**2 - y**2) / PW_W0**4) * env * np.sin(k0 * z)
    uy = (e0 * a * 2 * y / PW_W0**2 + e1 * a * 4 * x * y / PW_W0**3
          + e2 * a * 8 * y / PW_W0**2
          + e2 * a * 8 * y * (x**2 - y**2) / PW_W0**4) * env * np.sin(k0 * z)
    uz = (-e0 * a * k0 - e1 * a * k0 * 2 * x / PW_W0
          - e2 * a * k0 * 4 * (x**2 - y**2) / PW_W0**2) * env * np.cos(k0 * z)
    ptcl.ux, ptcl.uy, ptcl.uz = ux, uy, uz
    ptcl.inv_gamma = 1. / np.sqrt(1 + ux**2 + uy**2 + uz**2)
    sim.step(n_step)
    rg, zg = np.meshgrid(sim.grid_r(), sim.grid_z())
    t = sim.time
    fields = {}
    for name in ("Ez", "Er"):
        f = sim.get_interp_field(name, 0).real.copy()
        for m in range(1, PW["Nm"]):
            f += 2 * sim.get_interp_field(name, m).real
        fields[name] = f
    amp = m_e * c**2 / e
    env = np.exp(-rg**2 / PW_W0**2) * np.sin(wp * t)
    Ez_th = -amp * k0 * env * np.cos(k0 * zg) * (
        e0 + e1 * 2 * rg / PW_W0 + e2 * 4 * rg**2 / PW_W0**2)
    Er_th = amp * env * np.sin(k0 * zg) * (
        e0 * 2 * rg / PW_W0**2 - e1 * 2 / PW_W0 + e1 * 4 * rg**2 / PW_W0**3
        - e2 * 8 * rg / PW_W0**2 + e2 * 8 * rg**3 / PW_W0**4)
    out = {}
    for name, th in (("Ez", Ez_th), ("Er", Er_th)):
        sim_f = fields[name]
        excess = np.abs(sim_f - th) - (PW_ATOL + PW_RTOL * np.abs(sim_f))
        out[name] = dict(max_err=float(np.abs(sim_f - th).max()),
                         max_theory=float(np.abs(th).max()),
                         worst_excess=float(excess.max()))
    print(f"periodic plasma wave ({shape}, {str(dtype)[6:]}, {n_step} "
          f"steps, {sim.ptcl[0].Ntot} particles, "
          f"{time.perf_counter() - t0:.1f} s): {out}", flush=True)
    # np.allclose(theory, sim, atol, rtol): |theory - sim| <= atol +
    # rtol * |sim| everywhere
    for name, th in (("Ez", Ez_th), ("Er", Er_th)):
        if not np.allclose(th, fields[name], atol=PW_ATOL, rtol=PW_RTOL):
            raise RuntimeError(f"periodic plasma wave ({shape}): {name} "
                               f"outside the test's tolerances: {out}")
    out["steps"] = n_step
    return out


def uniform_rho_gate(dtype):
    """tests/test_uniform_rho.py's cubic check, as the test calls it
    (deposit_single_species_rho: the linear deposit, as in fbpic_tpu),
    and the same check on the cubic deposit itself (deposit_rho_cubic
    over the cell volumes): rho within 2e-3 of -n e in the plasma, 1e-10
    of n e outside it and in mode 1."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e
    from fbpic_tpu_torch.particles.deposit import deposit_rho_cubic
    sim = Simulation(UR["Nz"], UR["zmax"], UR["Nr"], UR["rmax"], UR["Nm"],
                     UR["zmax"] / UR["Nz"] / c, 0, UR["zmax"], 0,
                     UR["p_rmax"], UR["p_nz"], UR["p_nr"], UR["p_nt"],
                     UR["n"], particle_shape="cubic", verbose_level=0,
                     device=DEVICE, dtype=dtype)
    sp, cfg = sim.state.species[0], sim.config
    cubic = deposit_rho_cubic(
        sp.x, sp.y, sp.z, sp.w, -e, cfg.Nm, 1 / cfg.dz,
        float(sim.state.zmin), cfg.Nz, 1 / cfg.dr, 0., cfg.Nr,
        sim.aux.ruyten_cubic, zfold="periodic")
    out = {}
    n_e = UR["n"] * e
    nr_max = int(UR["Nr"] * UR["p_rmax"] / UR["rmax"])
    for name, rho in (
            ("deposit_single_species_rho",
             sim.deposit_single_species_rho(sim.ptcl[0])),
            ("deposit_rho_cubic",
             (cubic * sim.aux.invvol[:, None, :]).cpu().numpy())):
        ok = (np.allclose(-n_e, rho[0][:, :nr_max - 2].real, 2.e-3)
              and np.allclose(0, rho[0][:, nr_max + 2:], atol=1.e-10 * n_e)
              and np.allclose(0, rho[1], atol=1.e-10 * n_e))
        out[name] = dict(
            inside=float(np.abs(rho[0][:, :nr_max - 2].real / -n_e - 1)
                         .max()),
            outside=float(np.abs(rho[0][:, nr_max + 2:]).max() / n_e),
            mode1=float(np.abs(rho[1]).max() / n_e))
        print(f"uniform rho, cubic species ({str(dtype)[6:]}), {name}: "
              f"{out[name]}", flush=True)
        if not ok:
            raise RuntimeError(f"uniform rho gate failed ({name}): "
                               f"{out[name]}")
    return out


def phase_physics_gates(counters):
    """14. The physics gates too slow for the CPU test budget; the
    plasma waves with every kernel count set to 0 just before and read
    just after: the linear one resident (K1 and K2 once a step), the
    cubic one sorted afresh (no kernel)."""
    import torch
    out = dict(pml=pml_absorption_gate(torch.float64), plasma_wave={})
    for shape in ("linear", "cubic"):
        for fn in counters.values():
            fn.launches = 0
        res = plasma_wave_gate(shape, torch.float32)
        res["launches"] = {k: fn.launches for k, fn in counters.items()}
        n = res["steps"]
        want = ({"K1": n, "K2": n, "K3": 0} if shape == "linear"
                else {"K1": 0, "K2": 0, "K3": 0})
        print(f"periodic plasma wave ({shape}): launches {res['launches']}",
              flush=True)
        if res["launches"] != want:
            raise RuntimeError(f"plasma wave ({shape}) launches "
                               f"{res['launches']} != {want}")
        out["plasma_wave"][shape] = res
    out["uniform_rho_cubic"] = uniform_rho_gate(torch.float64)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------
# The LPA utilities: the PWFA drive bunch, the antenna-launched LWFA and the
# physics gates of the LPA tests (phases 15-17)
# ---------------------------------------------------------------------

# The PWFA drive bunch (BASELINE config 3) on bench.py's grid and plasma, no
# laser: k_p sigma_z = k_p sigma_r ~ 0.75, n_b / n_0 ~ 0.6
PWFA_Q = 50.e-12
PWFA_BUNCH = dict(sig_r=2.e-6, sig_z=2.e-6, n_emit=1.e-6, gamma0=2000.,
                  sig_gamma=20., n_macroparticles=1_000_000, zf=15.e-6,
                  tf=0., symmetrize=True)
# Steps in all: the window's left edge passes the drive bunch's starting
# point (lab z = 15 um) after 500 steps, so at 600 the whole box behind
# the bunch holds its wake, not the plasma's response to the bunch's
# field appearing at t = 0; the space-charge tolerance of
# tests/test_space_charge.py (a fraction of the peak)
PWFA_STEPS, PWFA_SC_TOL = 600, 0.1
# The antenna LWFA: bench.py's values, the laser emitted by an antenna
# 20 um lab-static (tests/test_antenna.py's placement: peak crossing
# 3 tau after t = 0, about 300 steps); inside the window until ~600
ANT_Z, ANT_EMIT_STEPS = 20.e-6, 360
#: The antenna pair's sort_K (phase 26): what the a0 = 4 pulse bumps the
#: automatic 1152 to in phase 16, so that no column overflows in the
#: pair's ~350 steps
ANT_SORT_K = 1792
# The mirror 2 um inside the window's right edge (a laser dump ahead of
# the pulse), the uniform external Ez of tests/test_external_fields.py
ANT_MIRROR_INSET, ANT_EXT_EZ = 2.e-6, 1.e9


def bunch_op_metrics(sim, Np):
    """The bunch's linear gather, scatter J and scatter rho (the ring
    path: PyTorch ops, no kernel) on one step's operands: CUDA-event ms
    and bound (measure_torch_op), and the device kernels each launches
    (their names, to read the step's profile by)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fbpic_tpu_torch.core import step as step_mod
    cfg = sim.config
    n_grid = cfg.Nm * cfg.Nz * cfg.Nr
    out = {}
    for name, n_bytes, n_flops in (
            ("gather_fields_linear", Np * 4 * (6 + 6) + 4 * 12 * n_grid,
             Np * (6 * 8 * cfg.Nm * 3 + 40)),
            ("deposit_J_linear", Np * 4 * 11 + 4 * 6 * n_grid,
             Np * (4 * 3 * (2 * cfg.Nm - 1) * 2 + 60)),
            ("deposit_rho_linear", Np * 4 * 7 + 4 * 2 * n_grid,
             Np * (4 * (2 * cfg.Nm - 1) * 2 + 40))):
        calls = [(a, k) for a, k in capture_calls(sim, step_mod, name)
                 if a[0].numel() == Np]
        if not calls:
            raise RuntimeError(f"PWFA: no {name} call on the bunch")
        args, kwargs = calls[0]
        fn = getattr(step_mod, name)
        ref = torch.stack([torch.view_as_real(t).flatten()
                           if t.is_complex() else t.flatten()
                           for t in _as_tuple(fn(*args, **kwargs))])

        def run(fn=fn, args=args, kwargs=kwargs):
            return torch.stack([torch.view_as_real(t).flatten()
                                if t.is_complex() else t.flatten()
                                for t in _as_tuple(fn(*args, **kwargs))])
        m = measure_torch_op(run, ref, f"PWFA bunch {name} ({Np} slots)",
                             n_bytes, n_flops)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args, **kwargs)
            torch.cuda.synchronize()
        m["kernels"] = sorted({ev.key[:90] for ev in prof.key_averages()
                               if ev.device_type
                               == torch.autograd.DeviceType.CUDA
                               and ev.self_device_time_total > 0})
        m["calls_per_step"] = len(calls)
        out[name] = m
    return out


def _as_tuple(x):
    return x if isinstance(x, (tuple, list)) else (x,)


def pwfa_space_charge_check(sim):
    """tests/test_space_charge.py's check on the drive bunch: the mode-0 Er
    and Bt after init against the high-gamma Gaussian field, within 10%
    of the peak."""
    from fbpic_tpu_torch.constants import c, epsilon_0
    Er = sim.get_interp_field("Er", 0).real
    Bt = sim.get_interp_field("Bt", 0).real
    zg, rg = np.meshgrid(sim.grid_z(), sim.grid_r(), indexing="ij")
    sr, sz, zf = (PWFA_BUNCH[k] for k in ("sig_r", "sig_z", "zf"))
    Eth = (-PWFA_Q / (2 * np.pi) ** 1.5 / sz / epsilon_0 / rg
           * (1 - np.exp(-0.5 * rg**2 / sr**2))
           * np.exp(-0.5 * (zg - zf) ** 2 / sz**2))
    Bth = Eth / c
    out = dict(Er_err=float(np.abs(Er - Eth).max() / np.abs(Eth).max()),
               Bt_err=float(np.abs(Bt - Bth).max() / np.abs(Bth).max()),
               Er_peak=float(np.abs(Er).max()),
               Er_peak_analytic=float(np.abs(Eth).max()))
    ok = (np.allclose(Er, Eth, atol=PWFA_SC_TOL * np.abs(Eth).max())
          and np.allclose(Bt, Bth, atol=PWFA_SC_TOL * np.abs(Bth).max()))
    print(f"PWFA space-charge init: {out} (gate {PWFA_SC_TOL} of the "
          f"peak)", flush=True)
    if not ok:
        raise RuntimeError(f"PWFA space-charge fields off: {out}")
    return out


def make_pwfa_sim(z_injection_plane=None):
    """Phase 15's PWFA driver: bench.py's grid and plasma, no laser, the
    Gaussian bunch with its space-charge field (ballistic behind
    z_injection_plane, where one is given), a moving window at c,
    float32.  Returns (sim, the bunch's set-up seconds)."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.bunch import add_particle_bunch_gaussian
    sim = Simulation(NZ, ZMAX, NR, RMAX, NM, (ZMAX - ZMIN) / NZ / c,
                     zmin=ZMIN, n_order=32,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, device=DEVICE,
                     dtype=torch.float32)
    sim.add_new_species(q=-e, m=m_e, n=N_E, p_zmin=P_ZMIN, p_zmax=P_ZMAX,
                        p_rmin=0., p_rmax=P_RMAX, p_nz=P_NZ, p_nr=P_NR,
                        p_nt=P_NT)
    t0 = time.perf_counter()
    add_particle_bunch_gaussian(sim, q=-e, m=m_e,
                                n_physical_particles=PWFA_Q / e,
                                initialize_self_field=True,
                                z_injection_plane=z_injection_plane,
                                **PWFA_BUNCH)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sim.set_moving_window(v=c)
    return sim, t_init


def phase_pwfa(counters):
    """15. The PWFA drive bunch (BASELINE config 3): bench.py's grid and plasma,
    no laser, a Gaussian electron bunch of 50 pC in 1,000,000
    macroparticles with its space-charge field, a moving window at c,
    float32.  The plasma is resident (K1 and K2 once a step), the bunch
    a ring with sort_K = 0 (the linear gather, the scatter J and the
    grid-difference d(rho) of two scatter charge deposits: PyTorch ops).
    The space-charge fields after init against the analytic field; 5 +
    30 steps with exactly one K1 and one K2 a step, zero overflow, finite
    fields, the bunch's live count kept; peak memory, host syncs, a
    profiled window read by the kernels the bunch's ops launch (timed on
    one step's operands); K1 and K2 on this simulation's operands; then
    on to PWFA_STEPS steps in all and the wake's period behind the
    bunch within 15% of 2 pi c / omega_p."""
    import torch
    from fbpic_tpu_torch.constants import c, e, m_e, epsilon_0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sim, t_init = make_pwfa_sim()
    sc, bsp = sim.species_configs, sim.state.species[1]
    n_bunch = PWFA_BUNCH["n_macroparticles"]
    if not (sc[0].resident and sc[1].sort_K == 0 and not sc[1].resident
            and sim.ptcl[1].Ntot == n_bunch):
        raise RuntimeError(f"PWFA: unexpected layout {sc}, "
                           f"{sim.ptcl[1].Ntot} bunch particles")
    wp = np.sqrt(N_E * e**2 / (m_e * epsilon_0))
    kp = wp / c
    nb = PWFA_Q / e / ((2 * np.pi) ** 1.5 * PWFA_BUNCH["sig_r"] ** 2
                       * PWFA_BUNCH["sig_z"])
    print(f"PWFA: bunch of {n_bunch} macroparticles (capacity "
          f"{bsp.capacity}) loaded with its space-charge field in "
          f"{t_init:.2f} s; k_p sigma_z = {kp * PWFA_BUNCH['sig_z']:.3f}, "
          f"n_b / n_0 = {nb / N_E:.3f}; plasma sort_K {sc[0].sort_K}",
          flush=True)
    sc_check = pwfa_space_charge_check(sim)
    label = "PWFA drive bunch"
    launches, metrics = drive_path(sim, counters, N_WARMUP, N_NEW_TIMED,
                                   label, {"K1": 1, "K2": 1, "K3": 0})
    metrics["peak_memory_gb"] = (torch.cuda.max_memory_allocated()
                                 - base) / 1e9
    print(f"{label}: peak device memory {metrics['peak_memory_gb']:.3f} GB "
          f"above the {base / 1e9:.3f} GB held before the phase",
          flush=True)
    syncs = profiled(sim, metrics, label)
    ops = bunch_op_metrics(sim, bsp.capacity)
    if metrics["profile"] is not None:
        for row in metrics["profile"]["top_rows"]:
            row["bunch_ops"] = [n for n, m in ops.items()
                                if row["name"] in m["kernels"]]
            print(f"  profile row {row['name'][:60]!r}: launched by the "
                  f"bunch's {row['bunch_ops'] or 'none'}", flush=True)
    k1 = phase_k1_resident(sim, "resident PWFA plasma layout")
    k2 = phase_k2_resident(sim, "resident PWFA plasma layout")
    t0, n_rest = time.perf_counter(), PWFA_STEPS - sim.iteration
    sim.step(n_rest)
    torch.cuda.synchronize()
    t_rest = time.perf_counter() - t0
    check_fields(sim, label)
    live = sim.ptcl[1].Ntot
    if live != n_bunch or lost(sim.overflow_totals):
        raise RuntimeError(f"{label}: {live} bunch particles, overflow "
                           f"{sim.overflow_totals}")
    z_drive = float(np.mean(sim.ptcl[1].z))
    z = sim.grid_z()
    behind = z < z_drive
    Ez = sim.get_interp_field("Ez", 0).real[:, 0]
    lam = wake_wavelength(Ez[behind], sim.config.dz)
    lam_a = 2 * np.pi * c / wp
    print(f"{label}: {sim.iteration} steps in all ({t_rest:.1f} s for the "
          f"last {n_rest}); drive bunch centroid z = "
          f"{z_drive * 1e6:.3f} um, wake period behind it {lam} m vs "
          f"2 pi c / omega_p = {lam_a} m; peak on-axis Ez behind the "
          f"bunch {np.abs(Ez[behind]).max():.4e} V/m", flush=True)
    if lam is None or abs(lam / lam_a - 1) >= 0.15:
        raise RuntimeError(f"PWFA wake period check failed: {lam} vs "
                           f"{lam_a}")
    metrics.update(space_charge=sc_check, bunch_ops=ops,
                   bunch_init_s=t_init, wake_ratio=lam / lam_a,
                   steps_in_all=sim.iteration, bunch_live=live)
    del sim
    torch.cuda.empty_cache()
    return launches, metrics, syncs, k1, k2


def envelope_peak_ahead(sim, z_from):
    """The largest envelope of the mode-1 on-axis Er (2 Re Er_1, as
    tests/test_antenna.py reads it) at z > z_from, and where."""
    from scipy.signal import hilbert
    Er = sim.get_interp_field("Er", 1)
    env = np.abs(hilbert(2 * Er[:, 0].real))
    z = sim.grid_z()
    fwd = z > z_from
    i = int(np.argmax(env[fwd]))
    return float(env[fwd][i]), float(z[fwd][i])


def window_cost(sim, counters, label):
    """30 more steps with every kernel count set to 0 just before (one
    K1 and one K2 a step), then a profiled window: ms/step, device busy,
    launches a step."""
    launches, metrics = drive_path(sim, counters, 1, N_NEW_TIMED, label,
                                   {"K1": 1, "K2": 1, "K3": 0})
    prof = profile_steps(sim, N_PROFILED)
    if prof is not None:
        prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                  / metrics["ms_per_step"])
    metrics["profile"] = prof
    return launches, metrics


def phase_antenna_lwfa(counters, lwfa_syncs):
    """16. The bench LWFA with its a0 = 4 laser emitted by a lab-static
    antenna at 20 um (float32): 5 + 30 steps with exactly one K1 and one
    K2 a step, zero overflow, finite fields; the host syncs of a
    step(14) call (one exchange period, one chunk of the chunk runner)
    with the antenna: one, the chunk's read, at the same line as over
    the next 14 steps without it, none in the antenna's code; a
    profiled window; on until
    the pulse peak has left the antenna, its peak envelope ahead of the
    antenna beside a0's E0 times tests/test_antenna.py's attenuation
    (printed, not gated: plasma, a0 = 4); then 30 steps with a Mirror 2
    um inside the window's right edge (damp_EB_z's full z round trip
    every step; its cells zero) and 30 with an ExternalField adding a
    uniform Ez of 1e9 V/m to every species (after K2, on the resident
    layout), each profiled beside the plain antenna run."""
    import torch
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils import ExternalField, Mirror
    sim = make_sim(z_antenna=ANT_Z)
    if not sim.species_configs[0].resident or len(sim.laser_antennas) != 1:
        raise RuntimeError("antenna LWFA: unexpected layout")
    label = "antenna LWFA"
    launches, metrics = drive_path(sim, counters, N_WARMUP, N_NEW_TIMED,
                                   label, {"K1": 1, "K2": 1, "K3": 0})
    # Host syncs over one exchange period with the antenna, then over the
    # next without it (its emission paused: the pulse's leading edge, at
    # ~1e-3 of the peak), at the same places of the exchange cycle; both
    # take the chunk runner: one chunk each
    ep = sim.exchange_period
    syncs = count_syncs(sim, label, ep)
    antennas = list(sim.laser_antennas)
    sim.laser_antennas.clear()
    plain = count_syncs(sim, f"{label} without the antenna", ep)
    sim.laser_antennas.extend(antennas)
    in_antenna = {k: v for k, v in syncs["where"].items()
                  if "antenna" in k}
    print(f"{label}: step({ep}) made {syncs['count']} host syncs with the "
          f"antenna, {plain['count']} without; in the antenna's code: "
          f"{in_antenna}; phase 3's step(1): {lwfa_syncs['count']}",
          flush=True)
    if in_antenna or syncs["where"] != plain["where"] \
            or syncs["count"] != 1:
        raise RuntimeError(f"{label}: the antenna adds host syncs, or the "
                           f"chunk made more than its one read: {syncs} "
                           f"against {plain}")
    prof = profile_steps(sim, N_PROFILED)
    if prof is not None:
        prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                  / metrics["ms_per_step"])
    metrics["profile"] = prof
    metrics["host_syncs"] = dict(antenna=syncs, plain=plain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(ANT_EMIT_STEPS - sim.iteration)
    torch.cuda.synchronize()
    check_fields(sim, label)
    peak, z_peak = envelope_peak_ahead(sim, ANT_Z + 2.e-6)
    k0dz2 = np.pi / 0.8e-6 * sim.config.dz
    att = (np.sin(k0dz2) / k0dz2) ** 2 * (1 - np.sin(k0dz2) ** 2)
    E0 = A0 * m_e * c**2 * (2 * np.pi / 0.8e-6) / e
    print(f"{label}: {sim.iteration} steps ({time.perf_counter() - t0:.1f} "
          f"s for the emission); peak envelope ahead of the antenna "
          f"{peak:.4e} V/m at z = {z_peak * 1e6:.3f} um, a0's E0 x "
          f"attenuation {E0 * att:.4e} V/m (E0 {E0:.4e}, attenuation "
          f"{att:.4f}; ratio {peak / (E0 * att):.4f}; not gated)",
          flush=True)
    # The a0 = 4 pulse entering the plasma compresses the columns past
    # the automatic sort_K (1.5x the initial occupancy): the overflow
    # count auto-bumps sort_K after the call (reported, as fbpic_tpu
    # does); the windows below must add none
    bumped = dict(sim.overflow_totals, sort_K=sim.species_configs[0].sort_K)
    print(f"{label}: overflow over the emission steps {bumped}", flush=True)
    sim.overflow_totals = {k: 0 for k in sim.overflow_totals}
    metrics.update(emission=dict(peak=peak, z_peak=z_peak, E0=E0,
                                 attenuation=att,
                                 ratio=peak / (E0 * att),
                                 overflow_and_sort_K=bumped))
    windows = {}
    z_mirror = float(sim.grid_z()[-1] + 0.5 * sim.config.dz
                     - ANT_MIRROR_INSET)
    sim.mirrors.append(Mirror(z_lab=z_mirror, n_cells=2))
    windows["mirror"] = window_cost(sim, counters, f"{label} + mirror")
    z = sim.grid_z()
    inside = (z >= z_mirror) & (z < z_mirror + 2 * sim.config.dz)
    Er1 = np.abs(sim.get_interp_field("Er", 1))
    if not inside.any() or Er1[inside].max() > 1e-5 * Er1.max():
        raise RuntimeError(f"{label}: the mirror's cells are not zero "
                           f"({Er1[inside].max() if inside.any() else None} "
                           f"of {Er1.max()})")
    sim.mirrors.clear()
    sim.external_fields.append(ExternalField(
        lambda F, x, y, z, t, amplitude, length_scale: F + amplitude,
        "Ez", ANT_EXT_EZ, 0.))
    windows["external_field"] = window_cost(
        sim, counters, f"{label} + external Ez")
    sim.external_fields.clear()
    windows["plain"] = window_cost(sim, counters, f"{label}, plain again")
    for key, (lw, mw) in windows.items():
        p = mw["profile"] or {}
        print(f"{label} window '{key}': {mw['ms_per_step']:.4f} ms/step, "
              f"device busy {p.get('device_ms_per_step')} ms/step, "
              f"{p.get('launches_per_step')} launches/step; K {lw}",
              flush=True)
    metrics["windows"] = {k: dict(v[1], launches=v[0])
                          for k, v in windows.items()}
    del sim
    torch.cuda.empty_cache()
    return launches, metrics, syncs


# tests/test_antenna.py
AG = dict(Nz=600, Nr=32, Nm=2, zmax=30.e-6, rmax=25.e-6, a0=0.01,
          waist=6.e-6, tau=8.e-15, lambda0=0.8e-6, z_antenna=12.e-6,
          steps=200)
# tests/test_beam_focusing.py
BF = dict(Nz=100, zmax=0.e-6, zmin=-20.e-6, Nr=60, rmax=15.e-6, Nm=1,
          sigma_r=1.e-6, sigma_z=2.e-6, Q=200.e-12, gamma0=10.,
          n_emit=0.1e-6, z0=-10.e-6, z_focus=190.e-6, N=8000)


def antenna_gate(dtype):
    """tests/test_antenna.py::test_antenna_vs_direct: the antenna's pulse
    against the direct one after 200 steps: amplitude ratio within 0.03
    of the predicted attenuation, position within 3 cells, FWHM within
    15%."""
    from scipy.signal import hilbert
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    g = AG
    dt = g["zmax"] / g["Nz"] / c
    profile = GaussianLaser(a0=g["a0"], waist=g["waist"], tau=g["tau"],
                            z0=g["z_antenna"] - 3 * c * g["tau"],
                            zf=g["z_antenna"], lambda0=g["lambda0"])
    env, z = {}, None
    for method in ("antenna", "direct"):
        sim = Simulation(g["Nz"], g["zmax"], g["Nr"], g["rmax"], g["Nm"], dt,
                         n_order=16, boundaries={"z": "open",
                                                 "r": "reflective"},
                         random_seed=0, verbose_level=0, device=DEVICE,
                         dtype=dtype)
        add_laser_pulse(sim, profile, method=method,
                        z0_antenna=g["z_antenna"] if method == "antenna"
                        else None)
        sim.step(g["steps"], correct_currents=False)
        Er = sim.get_interp_field("Er", 1)
        env[method] = np.abs(hilbert(2 * Er[:, 0].real))
        z = sim.grid_z()
    fwd = z > g["z_antenna"] + 2.e-6
    k0dz2 = np.pi / g["lambda0"] * g["zmax"] / g["Nz"]
    att = (np.sin(k0dz2) / k0dz2) ** 2 * (1 - np.sin(k0dz2) ** 2)

    def fwhm(e):
        above = np.where(e > e.max() / 2)[0]
        return z[fwd][above[-1]] - z[fwd][above[0]]

    ea, ed = env["antenna"][fwd], env["direct"][fwd]
    out = dict(ratio=float(ea.max() / ed.max()), attenuation=float(att),
               dz_peak=float(abs(z[fwd][np.argmax(ea)]
                                 - z[fwd][np.argmax(ed)])),
               fwhm_antenna=float(fwhm(ea)), fwhm_direct=float(fwhm(ed)))
    ok = (abs(out["ratio"] - att) < 0.03
          and out["dz_peak"] < 3 * g["zmax"] / g["Nz"]
          and abs(out["fwhm_antenna"] - out["fwhm_direct"])
          < 0.15 * out["fwhm_direct"])
    return ok, out


def beam_focusing_gate(dtype):
    """tests/test_beam_focusing.py: the bunch injected ballistically
    through the focal plane reaches sigma_r within 0.1 um; without the
    plane its spot grows by more than 0.3 um."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.bunch import add_elec_bunch_gaussian
    b = BF
    dt = (b["zmax"] - b["zmin"]) / b["Nz"] / c
    n_step = int(round((b["z_focus"] - b["z0"]) / c / dt))

    def run(plane):
        sim = Simulation(b["Nz"], b["zmax"], b["Nr"], b["rmax"], b["Nm"], dt,
                         zmin=b["zmin"], boundaries={"z": "open",
                                                     "r": "reflective"},
                         random_seed=0, verbose_level=0, device=DEVICE,
                         dtype=dtype)
        add_elec_bunch_gaussian(sim, b["sigma_r"], b["sigma_z"],
                                b["n_emit"], b["gamma0"], sig_gamma=0.,
                                Q=b["Q"], N=b["N"],
                                tf=(b["z_focus"] - b["z0"]) / c,
                                zf=b["z_focus"], z_injection_plane=plane)
        sim.set_moving_window(v=c)
        sim.step(n_step)
        sp = sim.ptcl[0]
        x, y, w = (np.asarray(a, np.float64) for a in (sp.x, sp.y, sp.w))
        return float(np.sqrt(np.sum(w * (x**2 + y**2)) / np.sum(w) / 2.0))

    out = dict(steps=n_step, r_plane=run(b["z_focus"]), r_direct=run(None))
    ok = (abs(out["r_plane"] - b["sigma_r"]) < 0.1e-6
          and out["r_direct"] - b["sigma_r"] > 0.3e-6)
    return ok, out


def space_charge_gate(dtype):
    """tests/test_space_charge.py: a gamma = 15 Gaussian bunch's Er and
    Bt after init within 10% of the peak of the analytic field; the
    symmetrized bunch's transverse means below 1e-10 of their spread."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, epsilon_0
    from fbpic_tpu_torch.lpa_utils.bunch import add_particle_bunch_gaussian
    sig_r = sig_z = 3.e-6
    Q, zf = 10.e-12, 20.e-6
    sim = Simulation(160, 40.e-6, 50, 20.e-6, 1, 40.e-6 / 160 / c,
                     zmin=0.0, n_order=32, random_seed=0, verbose_level=0,
                     device=DEVICE, dtype=dtype)
    add_particle_bunch_gaussian(
        sim, q=-e, m=m_e, sig_r=sig_r, sig_z=sig_z, n_emit=0.0, gamma0=15.,
        sig_gamma=0.0, n_physical_particles=Q / e, n_macroparticles=40000,
        zf=zf, symmetrize=True)
    Er = sim.get_interp_field("Er", 0).real
    Bt = sim.get_interp_field("Bt", 0).real
    zg, rg = np.meshgrid(sim.grid_z(), sim.grid_r(), indexing="ij")
    Eth = (-Q / (2 * np.pi) ** 1.5 / sig_z / epsilon_0 / rg
           * (1 - np.exp(-0.5 * rg**2 / sig_r**2))
           * np.exp(-0.5 * (zg - zf) ** 2 / sig_z**2))
    Bth = Eth / c
    p = sim.ptcl[-1]
    means = {}
    for name in ("x", "y", "ux", "uy"):
        q = getattr(p, name)
        live = p.w != 0
        means[name] = float(abs(q[live].mean())
                            / (q[live].std() + 1e-30))
    out = dict(Er_err=float(np.abs(Er - Eth).max() / np.abs(Eth).max()),
               Bt_err=float(np.abs(Bt - Bth).max() / np.abs(Bth).max()),
               mean_over_std=means)
    ok = (np.allclose(Er, Eth, atol=0.1 * np.abs(Eth).max())
          and np.allclose(Bt, Bth, atol=0.1 * np.abs(Bth).max())
          and max(means.values()) < 1e-10)
    return ok, out


def charge_cylinder_gate(dtype, shape):
    """tests/test_charge_cylinder.py: Gauss's law -Er r = n e a^2 /
    (2 eps0) outside an on-axis cylinder shrunk by each scale, within
    1e-3."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, epsilon_0
    from fbpic_tpu_torch.lpa_utils.bunch import get_space_charge_fields
    Nz, zmax, zmin, Nr, rmax, p_rmax, n_e = (10, 10.e-6, -10.e-6, 20,
                                             2.e-6, 1.e-6, 4.e24)
    worst = 0.0
    for scale in (1.0, 0.5, 0.25, 0.1, 0.05, 0.025, 0.01):
        sim = Simulation(Nz, zmax, Nr, rmax, 1, (zmax - zmin) / Nz / c,
                         zmin=zmin, particle_shape=shape,
                         boundaries={"z": "periodic", "r": "reflective"},
                         random_seed=0, verbose_level=0, device=DEVICE,
                         dtype=dtype)
        elec = sim.add_new_species(q=-e, m=m_e, n=n_e, p_zmin=zmin,
                                   p_zmax=zmax, p_rmin=0., p_rmax=p_rmax,
                                   p_nz=1, p_nr=8, p_nt=1)
        elec.x = np.asarray(elec.x) * scale
        elec.y = np.asarray(elec.y) * scale
        get_space_charge_fields(sim, elec)
        Er = np.asarray(sim.get_interp_field("Er", 0).real).mean(axis=0)
        r = (np.arange(Nr) + 0.5) * (rmax / Nr)
        expected = n_e * e * p_rmax ** 2 / (2 * epsilon_0)
        got = (-Er * r)[-5:]
        worst = max(worst, float(np.abs(got / expected - 1).max()))
    return worst < 1.e-3, dict(worst_rel_err=worst)


def external_fields_gate(dtype):
    """tests/test_external_fields.py: electrons at rest in a uniform
    external Ez of 1e9 V/m reach uz = -e E0 N dt / (m c) within 2% after
    40 steps."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.external_fields import ExternalField
    Nz, Nr, zmax, rmax = 32, 8, 3.2e-6, 4.e-6
    dt = zmax / Nz / c
    sim = Simulation(Nz, zmax, Nr, rmax, 1, dt, random_seed=0,
                     verbose_level=0, device=DEVICE, dtype=dtype)
    view = sim.add_new_species(q=-e, m=m_e, n=1.0, p_nz=1, p_nr=1, p_nt=1,
                               p_zmin=0, p_zmax=zmax, p_rmin=0.,
                               p_rmax=2.e-6, continuous_injection=False)
    sim.external_fields.append(ExternalField(
        lambda F, x, y, z, t, amplitude, length_scale: F + amplitude,
        "Ez", 1.e9, 0.0, species=view))
    sim.step(40)
    uz_expected = -e * 1.e9 * (40 * dt) / (m_e * c)
    uz = view.uz
    err = float(np.abs(uz / uz_expected - 1).max())
    return (np.allclose(uz, uz_expected, rtol=2e-2),
            dict(max_rel_err=err, resident=sim.species_configs[0].resident))


def mirror_filter_gate(dtype):
    """tests/test_laser.py::test_mirror_mode_filtering: a mirror over the
    whole box with m = [0] zeroes mode 0 (< 1 V/m) and keeps the mode-1
    laser (> 1e8 V/m); m = 'all' zeroes both."""
    import dataclasses
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    from fbpic_tpu_torch.lpa_utils.mirrors import Mirror
    Nz, Lz = 64, 20.e-6

    def run(mirror_m):
        sim = Simulation(Nz, Lz, 16, 15.e-6, 2, Lz / Nz / c, zmin=0.,
                         verbose_level=0, device=DEVICE, dtype=dtype)
        add_laser_pulse(sim, GaussianLaser(a0=0.01, waist=5.e-6,
                                           tau=8.e-15, z0=10.e-6))
        Ez = sim.state.interp.Ez.clone()
        Ez[0] = torch.complex(torch.full_like(Ez[0].real, 1.e9),
                              Ez[0].imag)
        sim.state = dataclasses.replace(sim.state, interp=dataclasses.replace(
            sim.state.interp, Ez=Ez))
        sim.mirrors.append(Mirror(z_lab=0.0, n_cells=Nz, m=mirror_m))
        sim.step(1, correct_currents=False)
        i = sim.state.interp
        return (float(i.Er[0].real.abs().max() + i.Ez[0].real.abs().max()),
                float(i.Er[1].real.abs().max()))

    out = dict(m0_list=run([0]), m0_all=run("all"))
    ok = (out["m0_list"][0] < 1.0 and out["m0_list"][1] > 1.e8
          and out["m0_all"][0] < 1.0 and out["m0_all"][1] < 1.0)
    return ok, out


def profile_injection_gate(dtype, name):
    """tests/test_laser.py::test_profile_injection_parity: the injected
    field within 4% of the profile's own E_field; after 40 steps the
    energy within 1e-5 and the centroid moved c N dt within 1.2 cells."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    import fbpic_tpu_torch.lpa_utils.laser as L
    Nz, Nr, zmax, rmax, nm = 300, 48, 30.e-6, 30.e-6, 3
    kw = dict(a0=0.01, tau=10.e-15, z0=10.e-6)
    profile = {
        "laguerre_gauss": lambda: L.LaguerreGaussLaser(p=0, m=1,
                                                       waist=6.e-6, **kw),
        "donut": lambda: L.DonutLikeLaguerreGaussLaser(p=0, m=1,
                                                       waist=6.e-6, **kw),
        "flattened": lambda: L.FlattenedGaussianLaser(
            a0=0.01, w0=8.e-6, N=6, tau=10.e-15, z0=10.e-6),
        "fewcycle": lambda: L.FewCycleLaser(a0=0.01, waist=5.e-6,
                                            tau_fwhm=5.e-15, z0=10.e-6),
    }[name]()
    dt = zmax / Nz / c
    sim = Simulation(Nz, zmax, Nr, rmax, nm, dt, random_seed=0,
                     verbose_level=0, device=DEVICE, dtype=dtype)
    L.add_laser_pulse(sim, profile)
    r = (np.arange(Nr) + 0.5) * (rmax / Nr)
    z = sim.grid_z()

    def Ex():
        return sum((1.0 if m == 0 else 2.0)
                   * sim.get_interp_field("Er", m).real for m in range(nm))

    def energy():
        return sum((1.0 if m == 0 else 2.0) * float(np.sum(
            np.abs(sim.get_interp_field(n, m)) ** 2 * r[None, :]))
            for n in ("Er", "Et", "Ez") for m in range(nm))

    def centroid():
        wgt = np.abs(Ex()) ** 2
        return float(np.sum(wgt * z[:, None]) / np.sum(wgt))

    Z, R = np.meshgrid(z, r, indexing="ij")
    Ex_th, _ = profile.E_field(R, np.zeros_like(R), Z, 0.0)
    inj_err = float(np.abs(Ex() - Ex_th).max() / np.abs(Ex_th).max())
    e0, c0 = energy(), centroid()
    sim.step(40)
    e1, c1 = energy(), centroid()
    out = dict(injection_err=inj_err, energy_change=abs(e1 - e0) / e0,
               moved_minus_cN_dt=(c1 - c0) - 40 * c * dt)
    ok = (inj_err < 0.04 and out["energy_change"] < 1e-5
          and abs(out["moved_minus_cN_dt"]) < 1.2 * zmax / Nz)
    return ok, out


def phase_lpa_gates():
    """17. The LPA tests too slow for the CPU test budget, each at its
    file's tolerances, in float32 (the card's default) and, where float32
    misses, again in float64 (the dtype those files run on the CPU),
    the tolerance unchanged; fails if float64 misses too."""
    import torch
    gates = [("test_antenna", antenna_gate),
             ("test_beam_focusing", beam_focusing_gate),
             ("test_space_charge", space_charge_gate)]
    gates += [(f"test_charge_cylinder[{s}]",
               lambda d, s=s: charge_cylinder_gate(d, s))
              for s in ("linear", "cubic")]
    gates += [("test_external_fields", external_fields_gate),
              ("test_mirror_mode_filtering", mirror_filter_gate)]
    gates += [(f"test_profile_injection_parity[{n}]",
               lambda d, n=n: profile_injection_gate(d, n))
              for n in ("laguerre_gauss", "donut", "flattened", "fewcycle")]
    out = {}
    for name, gate in gates:
        t0 = time.perf_counter()
        res = {}
        for dtype in (torch.float32, torch.float64):
            ok, metrics = gate(dtype)
            res[str(dtype)[6:]] = dict(metrics, passed=bool(ok))
            if ok:
                break
        print(f"LPA gate {name} ({time.perf_counter() - t0:.1f} s): {res}",
              flush=True)
        if not ok:
            raise RuntimeError(f"LPA gate {name} failed in float32 and "
                               f"float64: {res}")
        out[name] = res
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------
# The elementary processes: ionization and Compton scattering
# (phases 18-20)
# ---------------------------------------------------------------------

# examples/ionization_script.py (the bench's grid, plasma and laser):
# He electrons, an N5+ dopant of ION_N_DOPANT made ionizable from level 5
# into a tracked, empty species.  The laser's peak enters the plasma near
# step 160; the run-up goes in step() calls of ION_CHUNK steps, after
# each of which the electrons' ring grows if it is more than half full
ION_N_DOPANT, ION_RUN_UP, ION_CHUNK, ION_DIAG = 1.e23, 500, 10, 50
# The PML window (BASELINE config 4): run-up, then N_NEW_TIMED steps
ION_PML_RUN_UP = 200
# The Compton-active PWFA: a counter-propagating laser (CMP_LASER) meets
# the drive bunch's centre at step CMP_T_PEAK; its energy is set so that
# the photons expected a step at that overlap are CMP_PHOTON_SHARE of the
# 8192-slot creation buffer (under a quarter); CMP_STEPS in all, the
# pulse crossing the bunch in ~140 steps (ctau + 2 sigma_z at 2c)
CMP_LASER = dict(laser_wavelength=0.8e-6, laser_waist=10.e-6,
                 laser_ctau=10.e-6)
CMP_T_PEAK, CMP_STEPS, CMP_PHOTON_SHARE, CMP_CHUNK = 100, 220, 0.225, 5
# The photon spectrum's upper edge against 4 gamma^2 E_L / (1 + 4 gamma
# E_L / m_e c^2) of the bunch's mean gamma
CMP_EDGE_TOL = 0.10


def make_ionization_sim(pml=False, target_capacity=None):
    """examples/ionization_script.py:33-55 as written (full width: Nz =
    800, Nr = 50, Nm = 2, n_order = 32, 2x2x4 particles per cell, a0 = 4,
    moving window, continuous injection), float32, random_seed = 0 (the
    script leaves it unset).  pml: the radial PML (BASELINE config 4),
    Nr widened by its 32 cells as phase 12 does; target_capacity: the
    created electrons' ring built with that many slots (default: one
    creation buffer, 8192)."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, m_p
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    nr, rmax = (PML_NR, PML_RMAX) if pml else (NR, RMAX)
    sim = Simulation(NZ, ZMAX, nr, rmax, NM, (ZMAX - ZMIN) / NZ / c,
                     zmin=ZMIN, n_order=32,
                     boundaries={"z": "open",
                                 "r": "open" if pml else "reflective"},
                     random_seed=0, verbose_level=0, device=DEVICE,
                     dtype=torch.float32)
    plasma = dict(p_zmin=P_ZMIN, p_zmax=P_ZMAX, p_rmax=P_RMAX, p_nz=P_NZ,
                  p_nr=P_NR, p_nt=P_NT)
    elec = sim.add_new_species(q=-e, m=m_e, n=N_E, **plasma)
    ion = sim.add_new_species(q=5 * e, m=14. * m_p, n=ION_N_DOPANT, **plasma)
    elec_from_N = sim.add_new_species(q=-e, m=m_e, capacity=target_capacity)
    ion.make_ionizable("N", target_species=elec_from_N, level_start=5)
    elec_from_N.track(sim.comm)
    add_laser_pulse(sim, GaussianLaser(a0=A0, waist=W0, tau=TAU, z0=Z0))
    sim.set_moving_window(v=c)
    sc = sim.species_configs
    tgt = sim.state.species[2]
    if not (sc[0].resident and sc[1].resident and sc[2].sort_K == 0
            and not sc[2].resident
            and tgt.capacity == (target_capacity or 8192)
            and sc[1].ionizer.targets == (2,)
            and type(tgt.next_free).__name__ == "Tensor"):
        raise RuntimeError(f"ionization LWFA: unexpected layout {sc}")
    return sim, elec, ion, elec_from_N


def run_up(sim, n_to, chunk, label):
    """Step to iteration n_to in step() calls of `chunk` steps; the
    process targets' rings grow between calls.  A call whose ring appends
    overwrote live particles (ring_overwrite grew) must end with the
    growth of a process target's ring at that call's last iteration
    (sim.ring_growth), or this raises.  Returns the per-call record
    (iteration, live created particles, capacity), the overflow totals
    of the run-up, which are then reset (the timed windows must add
    none), the calls that dropped (iteration, dropped, the targets
    grown then) and the memory: ``recaptures``, the calls that captured
    a new chunk runner (a target ring grew before them), with their
    iteration, the targets' capacities, the memory allocated after the
    call and its peak during it (GB), and ``peak_bytes``, the peak of
    all calls (each call resets torch's peak counter).  Each runner that
    a new one replaced must have been released (its graphs and static
    buffers dropped), or this raises."""
    import gc
    import weakref
    import torch
    tgt = [i for i in range(len(sim.species_configs))
           if sim.is_process_target(i)]
    log, drops, recaptures, runners, peak = [], [], [], [], 0
    t0 = time.perf_counter()
    while sim.iteration < n_to:
        before = sim.overflow_totals["ring_overwrite"]
        torch.cuda.reset_peak_memory_stats()
        sim.step(min(chunk, n_to - sim.iteration))
        peak = max(peak, torch.cuda.max_memory_allocated())
        runner = sim._multi_step
        if runner is not None and (not runners
                                   or runners[-1]() is not runner):
            runners.append(weakref.ref(runner))
            recaptures.append(dict(
                iteration=sim.iteration,
                capacity=[sim.state.species[i].capacity for i in tgt],
                allocated_gb=torch.cuda.memory_allocated() / 1e9,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        log.append((sim.iteration,
                    [int((sim.state.species[i].w != 0).sum()) for i in tgt],
                    [sim.state.species[i].capacity for i in tgt]))
        dropped = sim.overflow_totals["ring_overwrite"] - before
        if dropped:
            grown = [g[1] for g in sim.ring_growth
                     if g[0] == sim.iteration and g[1] in tgt]
            drops.append(dict(iteration=sim.iteration, dropped=dropped,
                              grown=grown))
            if not grown:
                raise RuntimeError(f"{label}: {dropped} particles dropped "
                                   f"in the call ending at step "
                                   f"{sim.iteration}, and no target ring "
                                   f"of {tgt} grew then")
    torch.cuda.synchronize()
    totals = dict(sim.overflow_totals)
    gc.collect()
    kept = [r() for r in runners[:-1]
            if r() is not None and (r().graphs or r()._static is not None)]
    print(f"{label}: run-up to {sim.iteration} steps in "
          f"{time.perf_counter() - t0:.1f} s; created (live) and capacity "
          f"of the targets every {chunk * 10} steps: "
          f"{log[9::10]}; rings grown {sim.ring_growth}; overflow "
          f"{totals}; calls that dropped, each followed by its target's "
          f"growth: {drops}; calls that captured a new runner (memory "
          f"allocated after each and its peak, GB): {recaptures}; "
          f"replaced runners not released: {len(kept)}", flush=True)
    if kept:
        raise RuntimeError(f"{label}: {len(kept)} replaced chunk runners "
                           f"still hold their graphs or buffers")
    sim.overflow_totals = {k: 0 for k in sim.overflow_totals}
    return log, totals, drops, dict(recaptures=recaptures, peak_bytes=peak)


def process_syncs(sim, label, toggle):
    """Host syncs of one step(exchange period) call with the processes,
    then of the next without them (toggle(False) turns them off), at the
    same places of the exchange cycle, both through Simulation.step (the
    chunk runner; the configuration without the processes is captured in
    an untimed exchange period first) and with the diagnostics detached
    (their writes read the data): at most the chunk's one read (the
    process targets' live counts folded into it), at the same place."""
    ep = sim.exchange_period
    diags, sim.diags = sim.diags, []
    try:
        on = count_syncs(sim, f"{label} with the processes", ep)
        toggle(False)
        try:
            sim.step(ep)
            off = count_syncs(sim, f"{label} without the processes", ep)
        finally:
            toggle(True)
        sim.step(ep)
    finally:
        sim.diags = diags
    print(f"{label}: step({ep}) made {on['count']} host syncs with the "
          f"processes, {off['count']} without", flush=True)
    if on["count"] > 1 or on["where"] != off["where"]:
        raise RuntimeError(f"{label}: the processes add host syncs: {on} "
                           f"against {off}")
    return dict(with_processes=on, without=off)


def process_cost(sim, toggle, label):
    """Profiled windows with the processes (toggle(True)) and without
    them (toggle(False)), on the same state: what the process adds to
    the device busy time and the launches of a step.  Each configuration
    is captured in an untimed exchange period before its window."""
    on = profile_steps(sim, N_PROFILED)
    toggle(False)
    try:
        sim.step(sim.exchange_period)
        off = profile_steps(sim, N_PROFILED)
    finally:
        toggle(True)
    sim.step(sim.exchange_period)
    if on is None or off is None:
        return on, None
    added = dict(device_ms_per_step=on["device_ms_per_step"]
                 - off["device_ms_per_step"],
                 launches_per_step=on["launches_per_step"]
                 - off["launches_per_step"])
    print(f"{label}: the processes add {added['device_ms_per_step']:.4f} ms "
          f"device busy and {added['launches_per_step']:.1f} launches a "
          f"step", flush=True)
    return on, dict(off=off, added=added)


def toggler(sim, index, field):
    """toggle(on) setting species `index`'s ionizer / compton config on
    (its own) or off (None)."""
    from dataclasses import replace
    cfg = getattr(sim.species_configs[index], field)

    def toggle(on):
        sim.species_configs[index] = replace(
            sim.species_configs[index], **{field: cfg if on else None})
    return toggle


def k1_per_species(sim, label):
    """K1 on the operands of each of one step's fused deposits (one a
    resident species, in species order) against its plain version; an
    ionizable species' d(rho) (w * level) measured relative to its
    rho_next (measure_k1's drho_vs_rho)."""
    import inspect
    from fbpic_tpu_torch.particles import cuda_fused, sorted_deposit
    resident = [i for i, sc in enumerate(sim.species_configs)
                if sc.resident]
    calls = capture_calls(sim, sorted_deposit, "fused_onehot_contract")
    if len(calls) != len(resident):
        raise RuntimeError(f"{label}: {len(calls)} fused deposits for "
                           f"{len(resident)} resident species")
    out = []
    for i, (args, kwargs) in zip(resident, calls):
        ops = inspect.signature(cuda_fused.fused_onehot_contract_plain).bind(
            *args, **kwargs).arguments
        out.append(measure_k1(
            dict(ops), f"{label}, deposit {len(out)}",
            drho_vs_rho=sim.species_configs[i].ionizer is not None))
    return out


def creation_balance(sim, ion, tgt, tries=4):
    """One step that is not an exchange step (nothing removed, nothing
    injected): the ions' sum of w * level gained against the weight of
    the electrons appended (float64 sums on the card, relative 1e-9),
    the ring's overwrite count that step, and the electrons created.  A
    step that drops creations (ring_overwrite grew) cannot close the
    balance: it must be followed by the target ring's growth at the end
    of that step() call, and the next non-exchange step is measured
    instead, up to `tries` steps."""
    import torch
    ep = sim.exchange_period
    drops = []
    for _ in range(tries):
        while (sim.iteration + 1) % ep == 0 or sim.iteration % ep == 0:
            sim.step(1)

        def sums():
            si, st = sim.state.species[ion], sim.state.species[tgt]
            return ((si.w.double() * si.ionization_level.double()).sum(),
                    st.w.double().sum(), (st.w != 0).sum())
        before = sums()
        ring0 = sim.overflow_totals["ring_overwrite"]
        sim.step(1)
        after = sums()
        d_ion, d_elec = (float(a - b) for a, b in zip(after[:2], before[:2]))
        n_new = int(after[2] - before[2])
        dropped = sim.overflow_totals["ring_overwrite"] - ring0
        grown = [g for g in sim.ring_growth
                 if g[0] == sim.iteration and g[1] == tgt]
        err = abs(d_ion - d_elec) / max(abs(d_ion), 1e-300)
        print(f"creation balance at step {sim.iteration}: sum w dlevel = "
              f"{d_ion!r}, sum w appended = {d_elec!r} (rel diff {err:.3e}),"
              f" {n_new} electrons created, {dropped} dropped; target ring "
              f"grown after this step: {grown}", flush=True)
        if dropped == 0:
            if d_ion <= 0 or err > 1e-9:
                raise RuntimeError(f"creation balance off: {d_ion} "
                                   f"{d_elec}")
            return dict(sum_w_dlevel=d_ion, sum_w_appended=d_elec,
                        rel_diff=err, created=n_new, dropped=0,
                        iteration=sim.iteration, steps_with_drops=drops)
        if not grown:
            raise RuntimeError(f"{dropped} creations dropped at step "
                               f"{sim.iteration} and the ring did not grow")
        drops.append(dict(iteration=sim.iteration, dropped=dropped,
                          grown=grown))
    raise RuntimeError(f"creations dropped on {tries} steps: {drops}")


def phase_ionization_lwfa(counters):
    """18. examples/ionization_script.py at full width (the bench's grid,
    He electrons and the a0 = 4 laser, an N5+ dopant ionizable from level
    5 into a tracked species; float32) with its field and particle
    diagnostics every ION_DIAG steps (collected: no h5py on the card):
    the run-up to ION_RUN_UP steps in ION_CHUNK-step calls (the chunk
    runner: the non-exchange steps replayed from CUDA graphs, captured
    again after each growth of the created electrons' ring); 5 + 30
    timed steps with exactly two K1 and two K2 launches a step (the
    electrons and the ions resident; the created electrons a ring:
    PyTorch ops), zero overflow, finite fields; the creation balance of
    one step; peak memory; the host syncs of an exchange period with and
    without the ionizer (the chunk's one read); profiled windows with
    and without it; K1 on both of a step's deposits (the ions' weighted
    by w * level) and K2; then the radial PML window (BASELINE config
    4)."""
    import torch
    from fbpic_tpu_torch.diagnostics import (FieldDiagnostic,
                                             ParticleDiagnostic)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sim, elec, ion, tgt = make_ionization_sim()
    sink = []
    wdir = tempfile.mkdtemp()
    sim.diags = [FieldDiagnostic(ION_DIAG, sim.fld, comm=sim.comm,
                                 write_dir=wdir),
                 ParticleDiagnostic(ION_DIAG, {"electrons from N": tgt},
                                    comm=sim.comm, write_dir=wdir)]
    if not h5py_available():
        for d in sim.diags:
            collect_only(d, sink)
    label = "ionization LWFA"
    log, run_up_totals, _, mem = run_up(sim, ION_RUN_UP, ION_CHUNK, label)
    n_created = int((sim.state.species[2].w != 0).sum())
    if n_created == 0:
        raise RuntimeError(f"{label}: no electron created in "
                           f"{sim.iteration} steps")
    launches, metrics = drive_path(sim, counters, N_WARMUP, N_NEW_TIMED,
                                   label, {"K1": 2, "K2": 2, "K3": 0})
    metrics["peak_memory_gb"] = (max(mem["peak_bytes"],
                                     torch.cuda.max_memory_allocated())
                                 - base) / 1e9
    metrics["recaptures"] = mem["recaptures"]
    balance = creation_balance(sim, 1, 2)
    syncs = process_syncs(sim, label, toggler(sim, 1, "ionizer"))
    prof, metrics["without_ionizer"] = process_cost(
        sim, toggler(sim, 1, "ionizer"), label)
    if prof is not None:
        prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                  / metrics["ms_per_step"])
    metrics["profile"] = prof
    level = sim.state.species[1].ionization_level[
        sim.state.species[1].w != 0]
    levels = {int(v): int((level == v).sum()) for v in (5, 6, 7)}
    k1 = k1_per_species(sim, f"{label} (electrons, N5+ ions w * level)")
    k2 = phase_k2_resident_all(sim, label)
    check_fields(sim, label)
    sp_t = sim.state.species[2]
    live_t = sp_t.w != 0
    ids = sp_t.ids[live_t]
    n_ids = int(torch.unique(ids).numel())
    created = int(live_t.sum())
    if n_ids != created or int((ids == 0).sum()):
        raise RuntimeError(f"{label}: {created} electrons, {n_ids} unique "
                           f"ids")
    records = len(sink) + sum(len(f) for _, _, f in os.walk(wdir))
    shutil.rmtree(wdir)
    print(f"{label}: {sim.iteration} steps; ions by level {levels}; "
          f"{created} created electrons live (unique ids), capacity "
          f"{sp_t.capacity}, rings grown {sim.ring_growth}; "
          f"{records} diagnostic files collected; peak device memory "
          f"{metrics['peak_memory_gb']:.3f} GB above the "
          f"{base / 1e9:.3f} GB held before", flush=True)
    metrics.update(run_up_overflow=run_up_totals, ions_by_level=levels,
                   created_live=created, target_capacity=sp_t.capacity,
                   ring_growth=list(sim.ring_growth),
                   creation_balance=balance, host_syncs=syncs,
                   diag_files_collected=records,
                   run_up=[dict(iteration=i, created=n, capacity=c)
                           for i, n, c in log[4::5]])
    del sim
    torch.cuda.empty_cache()

    sim, elec, ion, tgt = make_ionization_sim(pml=True)
    label = "ionization LWFA + radial PML"
    _, pml_totals, _, _ = run_up(sim, ION_PML_RUN_UP, ION_CHUNK, label)
    pml_launches, pml = drive_path(sim, counters, 1, N_NEW_TIMED, label,
                                   {"K1": 2, "K2": 2, "K3": 0})
    check_pml_fields(sim, label)
    prof = profile_steps(sim, N_PROFILED)
    if prof is not None:
        prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                  / pml["ms_per_step"])
    pml.update(profile=prof, launches=pml_launches,
               run_up_overflow=pml_totals,
               created_live=int((sim.state.species[2].w != 0).sum()))
    metrics["pml_window"] = pml
    del sim
    torch.cuda.empty_cache()
    return launches, metrics, syncs["with_processes"], k1, k2


def phase_k2_resident_all(sim, label):
    """K2 on the operands of each of one step's sorted gathers."""
    import inspect
    from fbpic_tpu_torch.core import step
    from fbpic_tpu_torch.particles import cuda_gather
    out = []
    for args, kwargs in capture_calls(sim, step, "gather_fields_sorted"):
        ops = inspect.signature(cuda_gather.gather_sorted).bind(
            *args, **kwargs).arguments
        m = measure_k2(dict(ops), f"{label}, gather {len(out)}", True)
        out.append({k: m[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "live_fraction",
                                      "rel_err")})
    return out


def compton_laser_energy(sim, bunch, z0, t_peak):
    """The laser energy whose photons expected a step, at the overlap of
    step t_peak (the bunch ballistic until then), are CMP_PHOTON_SHARE of
    the creation buffer: scattering_probability of the bunch for 1 J,
    summed (linear in the energy where p << 1)."""
    import torch
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.particles.compton import (
        build_compton_aux, scattering_probability)
    sp = sim.state.species[bunch]
    live = sp.w != 0
    moved = sp.replace(z=sp.z + c * t_peak * sp.uz * sp.inv_gamma)
    aux = build_compton_aux(1.0, laser_initial_z0=z0, device=sim.device,
                            dtype=sim.dtype, **CMP_LASER)
    p = scattering_probability(moved, aux, sim.dt, t_peak)
    per_joule = float(torch.where(live, p, torch.zeros_like(p)).double()
                      .sum())
    return CMP_PHOTON_SHARE * 8192 / per_joule, per_joule


def make_compton_sim(photon_capacity=None):
    """Phase 19's configuration: phase 15's PWFA (its grid, plasma and
    drive bunch with its space-charge field), the bunch Compton-active
    against CMP_LASER, its photons a ring (q = 0, m = 0) of
    photon_capacity slots (default: one creation buffer, 8192).
    Returns (sim, the laser energy, the photons a step per joule at the
    overlap, the laser's z0)."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.bunch import add_particle_bunch_gaussian
    sim = Simulation(NZ, ZMAX, NR, RMAX, NM, (ZMAX - ZMIN) / NZ / c,
                     zmin=ZMIN, n_order=32,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, device=DEVICE,
                     dtype=torch.float32)
    sim.add_new_species(q=-e, m=m_e, n=N_E, p_zmin=P_ZMIN, p_zmax=P_ZMAX,
                        p_rmin=0., p_rmax=P_RMAX, p_nz=P_NZ, p_nr=P_NR,
                        p_nt=P_NT)
    bunch = add_particle_bunch_gaussian(
        sim, q=-e, m=m_e, n_physical_particles=PWFA_Q / e,
        initialize_self_field=True, **PWFA_BUNCH)
    photons = sim.add_new_species(q=0., m=0., capacity=photon_capacity)
    sim.set_moving_window(v=c)
    t_peak = CMP_T_PEAK * sim.dt
    z0 = PWFA_BUNCH["zf"] + 2 * c * t_peak
    energy, per_joule = compton_laser_energy(sim, 1, z0, t_peak)
    bunch.activate_compton(photons, laser_energy=energy,
                           laser_initial_z0=z0, **CMP_LASER)
    sc = sim.species_configs
    if not (sc[0].resident and sc[1].sort_K == 0 and sc[2].sort_K == 0
            and sc[1].compton.target_index == 2
            and sim.state.species[2].capacity == (photon_capacity or 8192)):
        raise RuntimeError(f"Compton PWFA: unexpected layout {sc}")
    print(f"Compton PWFA: laser z0 = {z0 * 1e6:.3f} um, energy "
          f"{energy:.6e} J ({per_joule:.6e} photons a step per J at the "
          f"overlap of step {CMP_T_PEAK}: {energy * per_joule:.1f} "
          f"expected a step)", flush=True)
    return sim, energy, per_joule, z0


def phase_compton_pwfa(counters):
    """19. Phase 15's PWFA (the bench's grid and plasma, the 50 pC drive
    bunch of 1,000,000 macroparticles at gamma 2000 with its space-charge
    field; float32) with the bunch Compton-active against a
    counter-propagating rigid laser (CMP_LASER) that meets its centre at
    step CMP_T_PEAK, the photons a ring (q = 0, m = 0): the laser energy
    from scattering_probability (CMP_PHOTON_SHARE of the buffer a step
    at the overlap); the run-up in CMP_CHUNK-step calls (the chunk
    runner, captured again after each growth of the photon ring), 5 + 30
    timed steps around the overlap with exactly one K1 and one K2 a step
    (the plasma), zero overflow, finite fields; the host syncs of an
    exchange period with and without Compton (the chunk's one read);
    profiled windows with and without it; K1 on the plasma's operands;
    on to CMP_STEPS, then the drop gate and the photons' upper edge
    against 4 gamma^2 E_L / (1 + 4 gamma E_L / m_e c^2)."""
    import torch
    from fbpic_tpu_torch.constants import c, m_e, hbar
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sim, energy, per_joule, z0 = make_compton_sim()
    label = "Compton-active PWFA"
    n_before = CMP_T_PEAK - N_WARMUP - N_NEW_TIMED // 2
    _, run_up_totals, run_up_drops, mem = run_up(sim, n_before, CMP_CHUNK,
                                                 label)
    launches, metrics = drive_path(sim, counters, N_WARMUP, N_NEW_TIMED,
                                   label, {"K1": 1, "K2": 1, "K3": 0})
    metrics["peak_memory_gb"] = (max(mem["peak_bytes"],
                                     torch.cuda.max_memory_allocated())
                                 - base) / 1e9
    metrics["recaptures"] = mem["recaptures"]
    syncs = process_syncs(sim, label, toggler(sim, 1, "compton"))
    prof, metrics["without_compton"] = process_cost(
        sim, toggler(sim, 1, "compton"), label)
    if prof is not None:
        prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                  / metrics["ms_per_step"])
    metrics["profile"] = prof
    k1 = phase_k1_resident(sim, "resident plasma of the Compton PWFA")
    _, rest_totals, rest_drops, rest_mem = run_up(sim, CMP_STEPS,
                                                  CMP_CHUNK * 2, label)
    check_fields(sim, label)
    sp = sim.state.species[2]
    live = sp.w != 0
    u = torch.sqrt(sp.ux**2 + sp.uy**2 + sp.uz**2)[live].double()
    n_ph = int(live.sum())
    b = sim.state.species[1]
    bl = b.w != 0
    gamma = float((1.0 / b.inv_gamma[bl].double()).mean())
    k_L = 2 * np.pi * hbar / CMP_LASER["laser_wavelength"] / (m_e * c)
    e_max = 4 * gamma**2 * k_L / (1 + 4 * gamma * k_L)
    edge = float(u.max())
    q = [float(v) for v in torch.quantile(
        u.float(), torch.tensor([0.5, 0.99, 0.999], device=u.device))]
    print(f"{label}: {sim.iteration} steps; {n_ph} photons (capacity "
          f"{sp.capacity}, rings grown {sim.ring_growth}); photon energy "
          f"(m_e c^2) median {q[0]:.4e}, 99% {q[1]:.4e}, 99.9% {q[2]:.4e}, "
          f"max {edge:.4e}; 4 gamma^2 E_L / (1 + 4 gamma E_L) = "
          f"{e_max:.4e} at the bunch's mean gamma {gamma:.3f} (ratio "
          f"{edge / e_max:.4f}, gate {CMP_EDGE_TOL}); peak device memory "
          f"{metrics['peak_memory_gb']:.3f} GB", flush=True)
    if n_ph == 0 or abs(edge / e_max - 1) > CMP_EDGE_TOL:
        raise RuntimeError(f"{label}: photon upper edge {edge} vs {e_max}")
    # The drop gate: run_up raised unless every call that dropped photons
    # ended with the photon ring's growth at that call's last iteration
    drops = run_up_drops + rest_drops
    if any(d["grown"] != [2] for d in drops):
        raise RuntimeError(f"{label}: photons dropped without the photon "
                           f"ring's growth: {drops}")
    print(f"{label}: drop gate: {len(drops)} step() calls dropped photons "
          f"({sum(d['dropped'] for d in drops)} in all), each ending with "
          f"the photon ring's growth: {drops}", flush=True)
    metrics.update(laser_energy=energy, laser_z0=z0,
                   expected_photons_per_step=energy * per_joule,
                   photons=n_ph, photon_capacity=sp.capacity,
                   ring_growth=list(sim.ring_growth),
                   run_up_overflow=run_up_totals,
                   rest_overflow=rest_totals, photon_drops=drops,
                   rest_recaptures=rest_mem["recaptures"],
                   photon_edge=edge,
                   edge_formula=e_max, edge_ratio=edge / e_max,
                   photon_quantiles=q, bunch_mean_gamma=gamma,
                   host_syncs=syncs)
    del sim
    torch.cuda.empty_cache()
    return launches, metrics, syncs["with_processes"], k1


# tests/test_ionization.py, tests/test_resident_processes.py and
# tests/test_compton.py through the port on the card (phase 20)

def _static_field_sim(dtype, resident=None, E0=3.2e10):
    """The prescribed-static-field harness of tests/test_ionization.py
    (resident None: the card's defaults) and of
    tests/test_resident_processes.py::_build (resident True / False)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, m_p
    from fbpic_tpu_torch.lpa_utils import ExternalField
    Nz, Nr, Nm, zmax, rmax = 16, 8, 1, 1.6e-6, 2.e-6
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, zmax / Nz / c, random_seed=3,
                     verbose_level=0, device=DEVICE, dtype=dtype)
    kw_a, kw_e = {}, dict(capacity=65536)
    if resident is not None:
        sim.use_fused_deposit = resident
        kw_a = dict(sort_K=512 if resident else 0)
        kw_e = dict(capacity=None if resident else 65536,
                    sort_K=512 if resident else 0)
    atoms = sim.add_new_species(q=e, m=m_p, n=1e20, p_nz=4, p_nr=4, p_nt=4,
                                p_zmin=0, p_zmax=zmax, p_rmin=0,
                                p_rmax=1.5e-6, continuous_injection=False,
                                **kw_a)
    elec = sim.add_new_species(q=-e, m=m_e, continuous_injection=False,
                               **kw_e)
    atoms.make_ionizable("H", elec, level_start=0)
    if resident is not None:
        elec.track()
    sim.external_fields.append(ExternalField(
        lambda F, x, y, z, t, amplitude, length_scale: F + amplitude,
        "Ex", E0, 0.0, species=atoms))
    return sim, atoms, elec


def _adk_probability(level, E_field, dt):
    from fbpic_tpu_torch.particles.ionization import build_ionizer_aux
    aux, _ = build_ionizer_aux("H", dt, device="cpu")
    w_dtau = np.exp(float(aux.adk_log_prefactor[level])
                    + float(aux.adk_power[level]) * np.log(E_field)
                    + float(aux.adk_exp_prefactor[level]) / E_field)
    return 1.0 - np.exp(-w_dtau)


def _levels(sim, index):
    sp = sim.state.species[index]
    live = (sp.w != 0).cpu().numpy()
    return (sp.ionization_level.cpu().numpy()[live],
            sp.w.double().cpu().numpy()[live])


def adk_rate_gate(dtype):
    """tests/test_ionization.py::test_adk_rate_static_field."""
    sim, atoms, elec = _static_field_sim(dtype)
    p = _adk_probability(0, 3.2e10, sim.dt)
    sim.step(20, correct_currents=False)
    lev, _ = _levels(sim, 0)
    frac = float((lev >= 1).mean())
    expected = 1.0 - (1.0 - p) ** 20
    n_elec = int((sim.state.species[1].w != 0).sum())
    rho = sim.deposit_single_species_rho(atoms)
    ok = (abs(frac - expected) < 0.05 and n_elec == int((lev >= 1).sum())
          and rho[0].real.max() > 0)
    return ok, dict(fraction=frac, expected=expected, electrons=n_elec,
                    resident=[sc.resident for sc in sim.species_configs])


def chen2013_gate(dtype):
    """tests/test_ionization.py::test_chen2013_n5_fraction: an a0 = 1.8
    laser (a prescribed external field) through N2+ leaves 0.30-0.34 of
    the atoms N5+, and each level's electron species, with the weight the
    open z boundary removed from it added back, holds the weight of the
    ions that passed that level (rtol 1e-6, atol 0), with no ring
    overwrite.  (The test file compares the species' weight alone, with
    numpy's default atol of 1e-8 against weights ~1e-15: the last
    level's electrons leave through the open boundary, see
    tools/chen2013_routing.py.)"""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, m_p
    from fbpic_tpu_torch.lpa_utils import ExternalField
    zmin_lab, zmax_lab, Nr, rmax, Nm = 0.e-6, 20.e-6, 3, 10.e-6, 2
    plasma = dict(p_nz=2, p_nr=1, p_nt=4, p_zmin=5.e-6, p_zmax=15.e-6,
                  p_rmin=0., p_rmax=100.e-6, continuous_injection=False)
    n_atoms, a0, lambda0 = 0.2, 1.8, 0.8e-6
    ctau = 10. * lambda0
    z0 = -2 * ctau
    E0 = a0 * m_e * c * (2 * np.pi * c / lambda0) / e

    def laser_func(F, x, y, z, t, amplitude, length_scale):
        return F + amplitude * torch.cos(2 * np.pi * (z - c * t) / lambda0) \
            * torch.exp(-((z - c * t - z0) ** 2) / ctau**2)

    dz = lambda0 / 16.
    Nz = int((zmax_lab - zmin_lab) / dz) + 1
    N_step = int((2. * 40. * lambda0 + zmax_lab - zmin_lab) / dz) + 1
    sim = Simulation(Nz, zmax_lab, Nr, rmax, Nm, dz / c, zmin=zmin_lab,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, device=DEVICE,
                     dtype=dtype)
    sim.add_new_species(q=-e, m=m_e, n=2 * n_atoms, **plasma)
    ions = sim.add_new_species(q=0, m=14. * m_p, n=n_atoms, **plasma)
    targets = {lvl: sim.add_new_species(q=-e, m=m_e, capacity=65536,
                                        continuous_injection=False)
               for lvl in range(2, 6)}
    ions.make_ionizable(element="N", level_start=2, level_max=6,
                        target_species=targets)
    sim.external_fields = [ExternalField(laser_func, "Ex", E0, 0.),
                           ExternalField(laser_func, "By", E0 / c, 0.)]
    with counted_removal(len(sim.state.species)) as removed:
        t0 = time.perf_counter()
        sim.step(N_step, use_true_rho=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    lev, w = _levels(sim, ions._index)
    frac = float(w[lev == 5].sum() / w.sum())
    routed = {}
    ok = 0.30 < frac < 0.34 and sim.overflow_totals["ring_overwrite"] == 0
    for lvl, view in targets.items():
        tw = float(sim.state.species[view._index].w.double().sum())
        gone = float(removed[view._index]) \
            if removed[view._index] is not None else 0.0
        through = float(w[lev > lvl].sum())
        routed[lvl] = dict(species=tw, removed=gone, ions_through=through,
                           rel_gap=(tw + gone - through) / through)
        ok = ok and bool(np.isclose(tw + gone, through, rtol=1e-6, atol=0))
    print(f"Chen 2013 per-level weight (species, removed at the open z "
          f"boundary, ions through the level): {routed}", flush=True)
    return ok, dict(n5_fraction=frac, steps=N_step, seconds=seconds,
                    ms_per_step=seconds / N_step * 1e3,
                    routed_weight_vs_ions=routed)


@contextlib.contextmanager
def counted_removal(n_species):
    """Wrap core/step.py's remove_outside_particles (one call a species,
    in species order, in every exchange block of an open-z run) to add
    the weight it removes from each species into a float64 device
    accumulator of that species (None where nothing was removed yet),
    read after the run.  The accumulation is a device op: a captured
    exchange block replays it with the removal."""
    import torch
    from fbpic_tpu_torch.core import step as step_mod
    real = step_mod.remove_outside_particles
    removed = [None] * n_species
    calls = [0]

    def counted(sp, removal):
        out = real(sp, removal)
        i = calls[0] % n_species
        if removed[i] is None:
            removed[i] = torch.zeros((), dtype=torch.float64,
                                     device=sp.w.device)
        removed[i].add_(sp.w.to(torch.float64).sum()
                        - out.w.to(torch.float64).sum())
        calls[0] += 1
        return out
    step_mod.remove_outside_particles = counted
    try:
        yield removed
    finally:
        step_mod.remove_outside_particles = real


def small_capacity_gate(dtype):
    """tests/test_ionization.py::test_small_capacity_target_receives_
    electrons: the empty target grows to one creation buffer, and after
    60 steps of an a0 = 2 laser every level stripped is one electron
    (more than 20)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e, m_p
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    Nz, Nr, Nm = 120, 24, 2
    zmax, zmin, rmax = 15.e-6, -5.e-6, 10.e-6
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, (zmax - zmin) / Nz / c,
                     zmin=zmin, boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, device=DEVICE,
                     dtype=dtype)
    ion = sim.add_new_species(q=5 * e, m=14. * m_p, n=1.e23, p_zmin=2.e-6,
                              p_zmax=12.e-6, p_rmax=8.e-6, p_nz=2, p_nr=2,
                              p_nt=4)
    elec = sim.add_new_species(q=-e, m=m_e)
    ion.make_ionizable("N", target_species=elec, level_start=5)
    cap = sim.state.species[elec._index].capacity
    add_laser_pulse(sim, GaussianLaser(a0=2., waist=4.e-6, tau=10.e-15,
                                       z0=0.))
    sim.step(60)
    lev, _ = _levels(sim, ion._index)
    gained = int((lev - 5).sum())
    n_new = int((sim.state.species[elec._index].w != 0).sum())
    ok = cap >= 8192 and gained > 20 and n_new == gained
    return ok, dict(capacity=cap, levels_gained=gained, electrons=n_new)


def resident_adk_gate(dtype):
    """tests/test_resident_processes.py::test_resident_ionization_adk_rate:
    both species resident; the fraction within 0.05 of ADK, as many
    electrons as levels, their weight that of the levels (1e-9), no
    overflow, unique ids, the electrons inside the ion region."""
    import torch
    sim, atoms, elec = _static_field_sim(dtype, resident=True)
    p = _adk_probability(0, 3.2e10, sim.dt)
    sim.step(20, correct_currents=False)
    lev, w = _levels(sim, 0)
    frac = float((lev >= 1).mean())
    sp = sim.state.species[1]
    ew = sp.w.double().cpu().numpy()
    n_elec = int((ew != 0).sum())
    w_expected = float((w * lev).sum())
    ids = sp.ids[sp.w != 0]
    ez = sp.z[sp.w != 0].double().cpu().numpy()
    ok = (all(sc.resident for sc in sim.species_configs)
          and abs(frac - (1.0 - (1.0 - p) ** 20)) < 0.05
          and n_elec == int((lev >= 1).sum())
          and abs(ew.sum() - w_expected) < 1e-9 * w_expected
          and sim.overflow_totals["sort_overflow"] == 0
          and int(torch.unique(ids).numel()) == n_elec
          and ez.min() >= -0.1e-6 and ez.max() <= 1.7e-6)
    return ok, dict(fraction=frac, electrons=n_elec,
                    weight_rel_diff=abs(ew.sum() - w_expected) / w_expected)


def resident_vs_scatter_gate(dtype):
    """tests/test_resident_processes.py::test_resident_ionization_matches_
    scatter_rate: the ionized fractions of the resident and the ring run
    within 0.05."""
    fracs = {}
    for resident in (False, True):
        sim, _, _ = _static_field_sim(dtype, resident=resident)
        sim.step(20, correct_currents=False)
        lev, _ = _levels(sim, 0)
        fracs[resident] = float((lev >= 1).mean())
    return abs(fracs[True] - fracs[False]) < 0.05, dict(
        resident=fracs[True], ring=fracs[False])


def resident_weight_gate(dtype):
    """tests/test_resident_processes.py::test_resident_ionization_deposit_
    weight: an 8e10 V/m field ionizes every atom in 12 steps and the
    ions' charge deposit is positive."""
    sim, atoms, _ = _static_field_sim(dtype, resident=True, E0=8e10)
    sim.step(12, correct_currents=False)
    lev, _ = _levels(sim, 0)
    rho = sim.deposit_single_species_rho(atoms)
    return bool((lev >= 1).all() and rho[0].real.max() > 0), dict(
        ionized=float((lev >= 1).mean()),
        rho_max=float(rho[0].real.max()))


def _bath(dtype, uz0=0.0, laser_energy=1.0e6, seed=7, capacity=262144):
    """tests/test_compton.py::_bath_sim: electrons in a quasi-uniform
    photon bath (the pulse much longer and wider than the box)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    Nz, Nr, Nm, zmax, rmax = 16, 8, 1, 1.6e-6, 2.e-6
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, zmax / Nz / c, random_seed=seed,
                     verbose_level=0, device=DEVICE, dtype=dtype)
    elec = sim.add_new_species(q=-e, m=m_e, n=1e20, p_nz=4, p_nr=4, p_nt=4,
                               p_zmin=0, p_zmax=zmax, p_rmin=0,
                               p_rmax=1.5e-6, uz_m=uz0,
                               continuous_injection=False)
    photons = sim.add_new_species(q=0., m=0., capacity=capacity,
                                  continuous_injection=False)
    elec.activate_compton(photons, laser_energy=laser_energy,
                          laser_wavelength=0.8e-6, laser_waist=1.0e-3,
                          laser_ctau=1.0e-2, laser_initial_z0=0.0)
    return sim, elec, photons


def _thomson_p_step(sim, laser_energy):
    from fbpic_tpu_torch.constants import c, hbar
    from fbpic_tpu_torch.particles.compton import R_E
    sigma_T = 8. / 3 * np.pi * R_E**2
    n_peak = laser_energy / ((np.pi / 2.) ** 1.5 * (1.0e-3) ** 2 * 1.0e-2
                             * 2 * np.pi * hbar / 0.8e-6 * c)
    return sigma_T * n_peak * c * sim.dt


def _photons(sim, index):
    sp = sim.state.species[index]
    live = sp.w != 0
    return {n: getattr(sp, n)[live].double().cpu().numpy()
            for n in ("ux", "uy", "uz", "w")}


def thomson_rate_gate(dtype):
    """tests/test_compton.py::test_thomson_rate: electrons at rest
    scatter at sigma_T n c dt (5 sigma)."""
    sim, elec, photons = _bath(dtype, seed=5, capacity=131072)
    p = _thomson_p_step(sim, 1.0e6)
    n_elec = int((sim.state.species[0].w != 0).sum())
    sim.step(20, correct_currents=False)
    n_ph = len(_photons(sim, 1)["w"])
    expected = n_elec * (1 - (1 - p) ** 20)
    return abs(n_ph - expected) < 5 * np.sqrt(expected), dict(
        photons=n_ph, expected=expected, p_step=p)


def thomson_angular_gate(dtype):
    """tests/test_compton.py::test_thomson_angular_distribution: the
    photons' cos(theta) histogram against (1 + cos^2) 3/8."""
    sim, elec, photons = _bath(dtype, laser_energy=2.0e7)
    sim.step(30, correct_currents=False)
    ph = _photons(sim, 1)
    n_ph = len(ph["w"])
    u = np.sqrt(ph["ux"]**2 + ph["uy"]**2 + ph["uz"]**2)
    hist, edges = np.histogram(-ph["uz"] / u, bins=10, range=(-1, 1),
                               density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    expected = (1 + centers**2) * 3. / 8.
    err = np.abs(hist - expected)
    tol = 6. / np.sqrt(n_ph / 10.)
    ok = n_ph > 3000 and bool(np.all(err < expected * 0.25 + tol))
    return ok, dict(photons=n_ph, max_err_over_allowed=float(
        (err / (expected * 0.25 + tol)).max()))


def inverse_compton_gate(dtype):
    """tests/test_compton.py::test_inverse_compton_energy: uz0 = 10
    electrons backscatter up to (1 + beta)^2 gamma^2 E_L (0.8-1.02), the
    photons forward-beamed (mean uz/u > 0.9)."""
    from fbpic_tpu_torch.constants import c, m_e, hbar
    uz0 = 10.0
    gamma0 = np.sqrt(1 + uz0**2)
    sim, elec, photons = _bath(dtype, uz0=uz0, laser_energy=2.0e7)
    sim.step(20, correct_currents=False)
    ph = _photons(sim, 1)
    u = np.sqrt(ph["ux"]**2 + ph["uy"]**2 + ph["uz"]**2)
    k_laser = (2 * np.pi * hbar / 0.8e-6) / (m_e * c)
    e_max = (1 + uz0 / gamma0) ** 2 * gamma0**2 * k_laser
    beaming = float(np.mean(ph["uz"] / u))
    ok = (len(u) > 1000 and 0.8 * e_max < u.max() <= 1.02 * e_max
          and beaming > 0.9)
    return ok, dict(photons=len(u), edge_ratio=float(u.max() / e_max),
                    beaming=beaming)


def multi_photon_gate(dtype):
    """tests/test_compton.py::test_multi_photon_ratio: ratio 25 gives 25
    times the photons (6 sigma), each of 1/25 of its electron's
    weight."""
    ratio = 25.0
    sim, elec, photons = _bath(dtype)
    elec.activate_compton(photons, laser_energy=1.0e6,
                          laser_wavelength=0.8e-6, laser_waist=1.0e-3,
                          laser_ctau=1.0e-2, laser_initial_z0=0.0,
                          ratio_w_electron_photon=ratio)
    e_sp = sim.state.species[0]
    w_e = e_sp.w[e_sp.w != 0].double().cpu().numpy()
    p = _thomson_p_step(sim, 1.0e6)
    sim.step(10, correct_currents=False)
    w = _photons(sim, 1)["w"]
    expected = len(w_e) * 10 * p * ratio
    ok = (abs(len(w) - expected) < 6 * np.sqrt(expected)
          and (w * ratio).min() >= w_e.min() * (1 - 1e-6)
          and (w * ratio).max() <= w_e.max() * (1 + 1e-6))
    return ok, dict(photons=len(w), expected=expected)


def phase_process_gates():
    """20. tests/test_ionization.py (the ADK rate, Chen 2013's N5+
    fraction, the small-capacity target), tests/test_resident_processes.py
    and tests/test_compton.py (the Thomson rate, the angular
    distribution, the inverse-Compton energy, the multi-photon ratio)
    through the port on the card, each at its file's size and
    tolerances, in float32 and, where float32 misses, in float64."""
    import torch
    gates = [("test_adk_rate_static_field", adk_rate_gate),
             ("test_chen2013_n5_fraction", chen2013_gate),
             ("test_small_capacity_target_receives_electrons",
              small_capacity_gate),
             ("test_resident_ionization_adk_rate", resident_adk_gate),
             ("test_resident_ionization_matches_scatter_rate",
              resident_vs_scatter_gate),
             ("test_resident_ionization_deposit_weight",
              resident_weight_gate),
             ("test_thomson_rate", thomson_rate_gate),
             ("test_thomson_angular_distribution", thomson_angular_gate),
             ("test_inverse_compton_energy", inverse_compton_gate),
             ("test_multi_photon_ratio", multi_photon_gate)]
    out = {}
    for name, gate in gates:
        t0 = time.perf_counter()
        res = {}
        for dtype in (torch.float32, torch.float64):
            ok, metrics = gate(dtype)
            res[str(dtype)[6:]] = dict(metrics, passed=bool(ok))
            if ok:
                break
        print(f"process gate {name} ({time.perf_counter() - t0:.1f} s): "
              f"{res}", flush=True)
        if not ok:
            raise RuntimeError(f"process gate {name} failed in float32 and "
                               f"float64: {res}")
        out[name] = res
        torch.cuda.empty_cache()
    return out


# The PICMI LWFA (phase 21): the bench grid and plasma (a linear ramp
# over the first PICMI_RAMP of the plasma) and phase 4's laser, built
# from fbpic_tpu_torch.picmi objects; the PICMI wrapper passes no
# n_order, so the infinite-order stencil runs (n_guard = 64)
PICMI_RAMP = 5.e-6
PICMI_DENSITY = f"{N_E!r}*where(z < {PICMI_RAMP!r}, z/{PICMI_RAMP!r}, 1.)"
PICMI_LAMBDA0 = 0.8e-6
PICMI_RUN_UP, PICMI_DIAG = 200, 50
#: spect.rho_prev (the field diagnostic's rho record) is what the step
#: deposits afresh by scatter (index_add_: float32 atomics, summed
#: in an order that changes from run to run on the card) at every
#: exchange and at the start of every step() call; E, B, J and the
#: particles do not depend on its bits (the curl-free correction takes
#: the deposited d(rho)).  Its records are held to this share of their
#: largest value, every other record bit for bit
TOL_ATOMIC_RHO = 1e-6


def picmi_density(z, r):
    """PICMI_DENSITY written by hand, with the same operations: numpy's
    on host arrays (the initial load), torch's on tensors (the injection,
    on the card, as picmi's analytic_density evaluates it)."""
    import torch
    if torch.is_tensor(z):
        one = torch.full((), 1., dtype=z.dtype, device=z.device)
        return N_E * torch.where(z < PICMI_RAMP, z / PICMI_RAMP, one)
    return N_E * np.where(z < PICMI_RAMP, z / PICMI_RAMP, 1.)


def picmi_lwfa(workdir):
    """Phase 21's configuration through fbpic_tpu_torch.picmi on the
    card (the wrapper's defaults: device "cuda", float32), with a field
    and a particle diagnostic every PICMI_DIAG steps.  The wrapper
    passes no random_seed (as fbpic_tpu's does): the host RNG and the
    run-time generator are seeded here as random_seed = 0 seeds them."""
    from fbpic_tpu_torch import picmi
    from fbpic_tpu_torch.constants import c
    grid = picmi.CylindricalGrid(
        number_of_cells=[NZ, NR], lower_bound=[0., ZMIN],
        upper_bound=[RMAX, ZMAX],
        lower_boundary_conditions=["reflective", "open"],
        upper_boundary_conditions=["reflective", "open"],
        n_azimuthal_modes=NM, moving_window_velocity=[0., c])
    solver = picmi.ElectromagneticSolver(grid=grid, method="PSATD", cfl=1.0)
    psim = picmi.Simulation(solver=solver, particle_shape="linear")
    seed_as_random_seed_0(psim.sim)
    electrons = picmi.Species(
        particle_type="electron", name="electrons",
        initial_distribution=picmi.AnalyticDistribution(
            density_expression=PICMI_DENSITY,
            lower_bound=[None, None, P_ZMIN],
            upper_bound=[P_RMAX, None, None], fill_in=True))
    psim.add_species(electrons, layout=picmi.GriddedLayout(
        grid=grid, n_macroparticle_per_cell={"r": P_NR, "z": P_NZ,
                                             "theta": P_NT}))
    psim.add_laser(picmi.GaussianLaser(
        wavelength=PICMI_LAMBDA0, waist=W0, duration=TAU,
        focal_position=[0., 0., WAKE_Z0],
        centroid_position=[0., 0., WAKE_Z0], a0=WAKE_A0))
    psim.add_diagnostic(picmi.FieldDiagnostic(
        grid=grid, period=PICMI_DIAG, write_dir=workdir))
    psim.add_diagnostic(picmi.ParticleDiagnostic(
        period=PICMI_DIAG, species=[electrons], write_dir=workdir))
    return psim


def seed_as_random_seed_0(sim):
    """The host RNG and the run-time generator of sim as
    Simulation(random_seed=0) seeds them."""
    from fbpic_tpu_torch import Simulation
    ref = Simulation(8, 1.e-6, 4, 1.e-6, 1, 1.e-15, random_seed=0,
                     verbose_level=0, device=sim.device)
    sim._rng = ref._rng
    sim.device_seed = ref.device_seed
    sim.generator.manual_seed(sim.device_seed)


def picmi_twin(workdir):
    """The PICMI configuration built by hand through the port's
    Simulation API, in the order the PICMI wrapper calls it."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.diagnostics import (
        FieldDiagnostic, ParticleDiagnostic)
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    sim = Simulation(NZ, ZMAX, NR, RMAX, NM, 1.0 * ((ZMAX - ZMIN) / NZ) / c,
                     zmin=ZMIN, boundaries={"z": "open", "r": "reflective"},
                     particle_shape="linear", random_seed=0, verbose_level=0,
                     device=DEVICE, dtype=torch.float32)
    sim.set_moving_window(v=c)
    elec = sim.add_new_species(
        q=-e, m=m_e, n=1.0, dens_func=picmi_density, p_nz=P_NZ, p_nr=P_NR,
        p_nt=P_NT, p_zmin=P_ZMIN, p_zmax=np.inf, p_rmin=0, p_rmax=P_RMAX,
        uz_m=0.0, uz_th=0.0, continuous_injection=True, name="electrons")
    add_laser_pulse(sim, GaussianLaser(
        a0=WAKE_A0, waist=W0, tau=TAU, z0=WAKE_Z0, zf=WAKE_Z0,
        theta_pol=0.0, lambda0=PICMI_LAMBDA0, propagation_direction=1))
    sim.diags = [FieldDiagnostic(PICMI_DIAG, sim, write_dir=workdir),
                 ParticleDiagnostic(PICMI_DIAG, species={"electrons": elec},
                                    sim=sim, write_dir=workdir)]
    return sim


def twin_difference(a, b):
    """The arrays of two simulations' states (every field and particle
    array) that differ, each with its largest difference relative to its
    largest value, and whether their host values are equal (the chunk
    runner's rollbacks aside: they are not state)."""
    from fbpic_tpu_torch.diagnostics.checkpoint_restart import checkpoint_dict
    da, db = checkpoint_dict(a), checkpoint_dict(b)
    for d in (da, db):
        d["host"]["overflow_totals"].pop("rollbacks", None)
    diffs, exact = state_difference(da, db)
    rel = {key: (diffs[key] / max(float(t.abs().max()), 1e-300)
                 if t.is_floating_point() or t.is_complex() else float("inf"))
           for key, t in da["tensors"].items() if key not in exact}
    return rel, da["host"] == db["host"]


def phase_picmi_lwfa(counters):
    """21. The LWFA built from fbpic_tpu_torch.picmi objects at full width
    (PICMI_* above): the run-up of PICMI_RUN_UP steps with exactly one K1
    and one K2 launch a step, the diagnostics collected; the same
    configuration built by hand through the port's Simulation API, with
    the same seeds, gives the same state after the run-up: every array
    bit for bit (K1 and K2 sum in slot order) but spect.rho_prev, a
    scatter deposit (TOL_ATOMIC_RHO); 5 + 30 timed steps with one K1
    and one K2 a step, zero overflow, the live count against the
    injection front, finite fields; the host syncs of one exchange period (step(14)); a profiled
    window; K1 and K2 against their plain versions on this path's own
    operands; on to WAKE_STEPS and the wake wavelength within 15%."""
    import torch
    from fbpic_tpu_torch.constants import c, e, m_e
    label = "PICMI LWFA"
    workdir = tempfile.mkdtemp()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    psim = picmi_lwfa(workdir)
    sim = psim.sim
    sinks = [[] for _ in sim.diags]
    if not h5py_available():
        for diag, sink in zip(sim.diags, sinks):
            collect_only(diag, sink)
    sc = sim.species_configs[0]
    print(f"{label}: built in {time.perf_counter() - t0:.1f} s from PICMI "
          f"objects on {sim.device}, {sim.dtype}: n_order "
          f"{sim.config.n_order} (infinite order: the wrapper passes none), "
          f"internal Nz {sim.config.Nz}, sort_K {sc.sort_K}, resident "
          f"{sc.resident}, exchange period {sim.exchange_period}",
          flush=True)
    if not (sc.resident and sim.config.n_order == -1
            and sim.device.type == "cuda" and sim.dtype == torch.float32):
        raise RuntimeError(f"{label}: not the resident float32 card path")
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    psim.step(PICMI_RUN_UP)
    torch.cuda.synchronize()
    run_up_s = time.perf_counter() - t0
    run_up_launches = {k: fn.launches for k, fn in counters.items()}
    print(f"{label}: run-up of {PICMI_RUN_UP} steps in {run_up_s:.2f} s; "
          f"launches {run_up_launches}", flush=True)
    if run_up_launches != {"K1": PICMI_RUN_UP, "K2": PICMI_RUN_UP, "K3": 0}:
        raise RuntimeError(f"{label}: run-up launches {run_up_launches}")
    # The hand-built twin
    twin = picmi_twin(workdir)
    twin_sinks = [[] for _ in twin.diags]
    for diag, sink in zip(twin.diags, twin_sinks):
        collect_only(diag, sink)
    twin.step(PICMI_RUN_UP)
    rel, same_host = twin_difference(sim, twin)
    identical = same_host and not rel
    worst = max(rel.values(), default=0.0)
    print(f"{label}: the hand-built twin after {PICMI_RUN_UP} steps: "
          f"bit-identical {identical}, host values equal {same_host}, "
          f"largest relative difference {worst:.3e} {rel}", flush=True)
    off = {k: v for k, v in rel.items()
           if k != ".spect.rho_prev" or v > TOL_ATOMIC_RHO}
    if not same_host or off:
        raise RuntimeError(f"{label}: the hand-built twin differs: {rel}")
    del twin, twin_sinks
    torch.cuda.empty_cache()
    # The timed window
    launches, metrics = drive_path(sim, counters, N_WARMUP, N_NEW_TIMED,
                                   label, {"K1": 1, "K2": 1, "K3": 0})
    check_live_count(sim, label)
    metrics.update(twin_bit_identical=identical, twin_max_rel_diff=worst,
                   run_up_s=run_up_s, n_order=sim.config.n_order,
                   exchange_period=sim.exchange_period)
    syncs = count_syncs(sim, label, n_steps=sim.exchange_period)
    prof = profile_steps(sim, N_PROFILED)
    if prof is not None:
        prof["idle_share"] = 1 - (prof["device_ms_per_step"]
                                  / metrics["ms_per_step"])
    metrics["profile"] = prof
    metrics["host_syncs_exchange_period"] = syncs
    k1 = phase_k1_resident(sim, "resident PICMI LWFA layout")
    k2 = phase_k2_resident(sim, "resident PICMI LWFA layout")
    # The wake behind the laser, as phase 4
    sim.step(WAKE_STEPS - sim.iteration)
    check_fields(sim, label)
    if lost(sim.overflow_totals):
        raise RuntimeError(f"{label}: overflow {sim.overflow_totals}")
    wp = np.sqrt(N_E * e**2 / (m_e * 8.8541878128e-12))
    lam_a = 2 * np.pi * c / wp
    lam = wake_wavelength(sim.get_interp_field("Ez", 0).real[:, 0],
                          sim.config.dz)
    iters = [sorted({int(name[4:12]) for files in sink for name in files})
             for sink in sinks] if not h5py_available() else None
    print(f"{label}: {sim.iteration} steps; wake wavelength {lam} m vs "
          f"2 pi c / omega_p = {lam_a} m; diagnostics collected at "
          f"{iters}", flush=True)
    if lam is None or abs(lam / lam_a - 1) >= 0.15:
        raise RuntimeError(f"{label}: wake wavelength {lam} vs {lam_a}")
    want = list(range(0, WAKE_STEPS, PICMI_DIAG))
    if iters is not None and any(its[:len(want)] != want for its in iters):
        raise RuntimeError(f"{label}: collected iterations {iters}")
    metrics.update(wake_ratio=lam / lam_a, steps=sim.iteration)
    del psim, sim, sinks
    torch.cuda.empty_cache()
    return launches, metrics, syncs, k1, k2


@contextlib.contextmanager
def records_to(sink):
    """Every openPMD diagnostic's write goes to ``sink`` (a list of
    {file name: Records}) instead of a file while the block runs: the
    collect step runs as in a run that writes."""
    from fbpic_tpu_torch.diagnostics import generic
    real = generic.OpenPMDDiagnostic.write_records
    generic.OpenPMDDiagnostic.write_records = \
        lambda self, files: sink.append(files)
    try:
        yield
    finally:
        generic.OpenPMDDiagnostic.write_records = real


def reference_script_namespace():
    """The body of tests/test_reference_script.py (FBPIC's documented
    LWFA script, reduced) with only fbpic_tpu changed to fbpic_tpu_torch;
    its ``import h5py`` line is left out (only the file's test function,
    not run here, reads files)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_reference_script.py")
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()
                 if ln.strip() != "import h5py"]
    namespace = {"__name__": "reference_script"}
    exec(compile("\n".join(lines).replace("fbpic_tpu", "fbpic_tpu_torch"),
                 path, "exec"), namespace)
    return namespace


def records_by_file(sink):
    out = {}
    for files in sink:
        for name, rec in files.items():
            out.setdefault(name, []).append(rec)
    return out


def record_differences(a, b):
    """{HDF5 path: largest |a - b| relative to the largest |a|} of the
    datasets that differ between two lists of Records (the attributes
    carry a date and are not compared); raises if their layouts differ."""
    if len(a) != len(b) or any(ra.keys() != rb.keys()
                               for ra, rb in zip(a, b)):
        raise RuntimeError("the collected records differ in layout")
    out = {}
    for ra, rb in zip(a, b):
        for path, (da, _) in ra.items():
            db = rb[path][0]
            if da is not None and not np.array_equal(da, db):
                scale = float(np.abs(da).max()) if da.size else 0.0
                out[path] = max(out.get(path, 0.0), float(
                    np.abs(da - db).max()) / max(scale, 1e-300))
    return out


def phase_reference_script(counters):
    """22. FBPIC's documented LWFA script (tests/test_reference_script.py's
    body: fbpic_tpu_torch.main.Simulation, use_cuda=True, a dens_func,
    tracking, the field and particle diagnostics every 10 steps,
    set_periodic_checkpoint / restart_from_checkpoint) on the card at its
    reduced size, float32 (the port's default):
    - as the file runs it: 32 steps with checkpoints at 16 and 32, then
      the restart, which takes the latest checkpoint (32) and steps to 48;
      exactly one K1 and one K2 launch a step;
    - the restart from 16: the uninterrupted run with its step() call
      boundary at 16 (run(16), then step(16)) and the restart from the
      checkpoint at 16 to 32 must collect the same records at 20 and 30,
      bit for bit but for the rho record (TOL_ATOMIC_RHO); the single
      step(32) call's records are printed beside them (the restarted
      call re-deposits rho_prev and refreshes the spectral E / B at 16,
      where one call carries them)."""
    import torch
    label = "reference script"
    ns = reference_script_namespace()
    run = ns["run"]
    if ns["use_cuda"] is not True:
        raise RuntimeError(f"{label}: the script's use_cuda changed")
    out = {}
    as_written, wdir = [], tempfile.mkdtemp()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with records_to(as_written):
        sim = run(32, use_restart=False, wdir=wdir, save_checkpoints=True)
        rest = run(16, use_restart=True, wdir=wdir, save_checkpoints=False)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    ckpts = sorted(f for f in os.listdir(wdir) if f.startswith("check"))
    print(f"{label} as written: {time.perf_counter() - t0:.2f} s on "
          f"{sim.device}, {sim.dtype}; iterations {sim.iteration} then "
          f"{rest.iteration} (the restart took the latest checkpoint); "
          f"checkpoints {ckpts}; launches {launches}; overflow "
          f"{sim.overflow_totals} / {rest.overflow_totals}", flush=True)
    if (sim.device.type != "cuda" or sim.iteration != 32
            or rest.iteration != 48 or ckpts != [
                "checkpoint_00000016.pt", "checkpoint_00000032.pt"]):
        raise RuntimeError(f"{label}: unexpected run")
    if launches != {"K1": 48, "K2": 48, "K3": 0}:
        raise RuntimeError(f"{label}: launches {launches}")
    # Its dens_func is numpy code: the probe keeps it on the host, and
    # the exchange block of an exchange step runs eagerly (the rest of
    # the chunk replays its graphs)
    from fbpic_tpu_torch.core.graph import graph_blockers
    blockers = graph_blockers(sim, sim.build_options())
    print(f"{label}: graph_blockers {blockers}", flush=True)
    if blockers.loop or not any("density function" in b
                                for b in blockers.exchange) \
            or sim._multi_step is None:
        raise RuntimeError(f"{label}: the host density function is not "
                           f"named: {blockers}")
    out["graph_blockers"] = blockers._asdict()
    for s in (sim, rest):
        check_fields(s, label)
        if lost(s.overflow_totals):
            raise RuntimeError(f"{label}: overflow {s.overflow_totals}")
    single = records_by_file(as_written)
    del sim, rest
    # The restart from 16 against the uninterrupted run with the same
    # step() call boundaries
    uninterrupted, restarted, wdir = [], [], tempfile.mkdtemp()
    with records_to(uninterrupted):
        sim = run(16, use_restart=False, wdir=wdir, save_checkpoints=True)
        sim.step(16)
    os.remove(os.path.join(wdir, "checkpoint_00000032.pt"))
    with records_to(restarted):
        again = run(16, use_restart=True, wdir=wdir, save_checkpoints=False)
    if again.iteration != 32:
        raise RuntimeError(f"{label}: the restart ended at {again.iteration}")
    u, r = records_by_file(uninterrupted), records_by_file(restarted)
    for it in (20, 30):
        name = "data%08d.h5" % it
        diff = record_differences(u[name], r[name])
        one_call = record_differences(single[name], r[name])
        n_paths = sum(1 for rec in r[name] for d, _ in rec.values()
                      if d is not None)
        worst = max(one_call, key=one_call.get, default=None)
        print(f"{label}: restart from 16, the {n_paths} datasets at {it}: "
              f"those that differ from the uninterrupted run's, relative "
              f"to their largest value: {diff} (the rest bit for bit); "
              f"{len(one_call)} differ from the single step(32) call's, "
              f"the most {worst} by {one_call.get(worst)}", flush=True)
        off = {p: v for p, v in diff.items()
               if not p.endswith("/fields/rho") or v > TOL_ATOMIC_RHO}
        if off:
            raise RuntimeError(f"{label}: the restart's records at {it} "
                               f"differ: {off}")
        out[it] = dict(datasets=n_paths, differing=diff,
                       vs_single_call=one_call)
    del sim, again
    torch.cuda.empty_cache()
    return launches, out


class RecordedAngles:
    """fbpic_tpu's injection angles of the golden-wake run, read from
    tests/data/torch_golden_angles.npz (tools/torch_golden_angles.py): a
    column-angle source that answers only the (iteration, species,
    column keys) calls that run made, and raises on any other."""

    def __init__(self, path):
        d = np.load(path)
        self.seed = int(d["seed"])
        self.table = {(int(i), int(s)): (k, a) for i, s, k, a in zip(
            d["iteration"], d["species"], d["nkey"], d["angles"])}
        self.calls = 0

    def __call__(self, iteration, species_index, nkey):
        import torch
        keys, angles = self.table[(int(iteration), int(species_index))]
        if not np.array_equal(keys, nkey.cpu().numpy()):
            raise RuntimeError(f"injection at {iteration}: column keys "
                               f"differ from the recorded run's")
        self.calls += 1
        return torch.as_tensor(angles, device=nkey.device)


# tests/test_golden_wake.py's configuration and its 450-step profiles
GOLDEN_STEPS = (100, 450)
TOL_GOLDEN = 2e-3


def golden_profiles(sim):
    """tests/test_golden_wake.py's four profiles."""
    return dict(
        Ez_axis=sim.get_interp_field("Ez", 0).real[:, 0],
        Er0_r5=sim.get_interp_field("Er", 0).real[:, 5],
        Er1_r5=np.abs(sim.get_interp_field("Er", 1))[:, 5],
        rho_axis=sim.get_interp_field("rho", 0).real[:, 0])


def phase_golden_f64(counters):
    """23. tests/test_golden_wake.py's configuration (Nz = 400, Nr = 24,
    open z, moving window, continuous injection, a0 = 1) in float64 on
    the card, the resident layout forced (as tests/test_torch_golden.py
    forces it), with fbpic_tpu's injection angles from
    tests/data/torch_golden_angles.npz: exactly two K3 and one K2 launch
    a step, and the profiles at 100 (pin_*) and 450 steps (full_*) of
    tests/data/golden_wake.npz at the golden's own 2e-3 of each
    profile's scale."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    label = "golden wake, float64"
    root = os.path.dirname(os.path.abspath(__file__))
    gold = np.load(os.path.join(root, "tests", "data", "golden_wake.npz"))
    angles = RecordedAngles(os.path.join(root, "tests", "data",
                                         "torch_golden_angles.npz"))
    Nz, Nr, Nm = 400, 24, 2
    zmax, zmin, rmax = 30.e-6, -10.e-6, 20.e-6
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, (zmax - zmin) / Nz / c,
                     zmin=zmin, n_order=32,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, device=DEVICE,
                     dtype=torch.float64)
    sim.use_fused_deposit = True         # force the resident layout
    sim.add_new_species(q=-e, m=m_e, n=4.e24, p_zmin=24.e-6, p_zmax=500.e-6,
                        p_rmin=0., p_rmax=14.e-6, p_nz=1, p_nr=1, p_nt=4,
                        sort_K=256)
    add_laser_pulse(sim, GaussianLaser(a0=1.0, waist=8.e-6, tau=10.e-15,
                                       z0=20.e-6))
    sim.set_moving_window(v=c)
    if angles.seed != sim.device_seed or not sim.species_configs[0].resident:
        raise RuntimeError(f"{label}: not the recorded configuration")
    sim.column_angles = angles
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    errs = {}
    for horizon, n_to in zip(("pin", "full"), GOLDEN_STEPS):
        sim.step(n_to - sim.iteration)
        for name, arr in golden_profiles(sim).items():
            g = gold[f"{horizon}_{name}"]
            if not np.isfinite(arr).all():
                raise RuntimeError(f"{label}: non-finite {name}")
            errs[f"{horizon}_{name}"] = float(np.abs(arr - g).max()
                                              / np.abs(g).max())
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    n = GOLDEN_STEPS[-1]
    print(f"{label}: {n} steps in {time.perf_counter() - t0:.2f} s; "
          f"launches {launches}; {angles.calls} injections with the "
          f"recorded angles; overflow {sim.overflow_totals}; profile "
          f"errors relative to the golden's scale (gate {TOL_GOLDEN}): "
          f"{errs}", flush=True)
    if launches != {"K1": 0, "K2": n, "K3": 2 * n}:
        raise RuntimeError(f"{label}: launches {launches}")
    if lost(sim.overflow_totals) or angles.calls == 0:
        raise RuntimeError(f"{label}: overflow {sim.overflow_totals} or "
                           f"no injection")
    if max(errs.values()) >= TOL_GOLDEN:
        raise RuntimeError(f"{label}: profiles off the golden: {errs}")
    del sim
    torch.cuda.empty_cache()
    return launches, dict(profile_errors=errs, injections=angles.calls)


# examples/multichip_lwfa_script.py at full width: two slabs (one per
# card when there are two or more), its FieldDiagnostic every 100 steps,
# 50 steps to the Ez gate, then on to 200
MC_SLABS = 2
MC_STEPS = (50, 100, 200)
TOL_MULTICHIP = 5e-3
# The float64 resident mesh of tests/test_resident.py:240-304 (4 slabs,
# n_guard 24, exchange_period 4), card against the card machine's CPU;
# rho_prev is a scatter deposit (float64 atomics on the card)
MC64_SLABS, MC64_STEPS = 4, 40
TOL_MESH_F64 = 1e-10
# A component whose largest value is above this share of its family's
# is also held to TOL_MESH_F64 of its own largest value
MESH_OWN_SHARE = 1e-3


class Deferred:
    """What the example script's ``distribute_simulation`` returns here:
    its ``run.step(N_step)`` (2000 steps) is recorded, not run, and the
    phase drives ``run`` itself."""

    def __init__(self, run):
        self.run = run
        self.asked = None

    def step(self, N):
        self.asked = N


class Twin:
    """The single-card twin of a DistributedRun: ``sim.step`` on the
    same schedule, the run's observation methods."""

    def __init__(self, sim):
        self.sim = sim

    def step(self, N):
        self.sim.step(N)

    def get_interp_field(self, name, m=0):
        from fbpic_tpu_torch.fields import transform as tr
        F = getattr(self.sim.state.spect, name)
        return tr.spect2interp_scal(self.sim.aux.mats, F)[m].cpu().numpy()

    def live(self):
        w = self.sim.state.species[0].w
        return int((w != 0).sum()), float(w.double().sum())


def run_live(run):
    counts = [((s.species[0].w != 0).sum(), s.species[0].w.double().sum())
              for s in run.states]
    return (sum(int(n) for n, _ in counts), sum(float(w) for _, w in counts))


def multichip_script(distribute, sink):
    """examples/multichip_lwfa_script.py as written, fbpic_tpu changed to
    fbpic_tpu_torch (float32 on the card, the port's defaults), its
    ``distribute_simulation`` replaced by ``distribute``; the script
    passes no random_seed, so Simulation is bound to random_seed=0 (the
    twin must load and inject the same plasma).  The FieldDiagnostic
    collects into ``sink``.  Returns the script's globals."""
    import functools
    import fbpic_tpu_torch
    import fbpic_tpu_torch.parallel.api as api
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "examples", "multichip_lwfa_script.py")
    with open(path) as f:
        text = f.read().replace("fbpic_tpu", "fbpic_tpu_torch")
    real_sim, real_dist = fbpic_tpu_torch.Simulation, api.distribute_simulation
    fbpic_tpu_torch.Simulation = functools.partial(real_sim, random_seed=0)
    api.distribute_simulation = distribute
    try:
        ns = {"__name__": "__main__"}
        exec(compile(text, path, "exec"), ns)
    finally:
        fbpic_tpu_torch.Simulation, api.distribute_simulation = \
            real_sim, real_dist
    for diag in ns["sim"].diags:
        collect_only(diag, sink)
    return ns


def exchange_device_ms(run):
    """Device time a step of the halo exchanges (exchange_add of the
    three corrected J fields, exchange_replace of the six E / B fields)
    and of the migration (every exchange period; here per step), timed
    with CUDA events on the run's own slab tensors through its slab
    group (the threads issue on the card's default stream)."""
    from fbpic_tpu_torch.fields import transform as tr
    from fbpic_tpu_torch.parallel import domain
    group, g = run.group, run.g
    spect = [s.spect for s in run.states]

    def add():
        group.run(lambda r: domain.exchange_guards_add(
            [tr.ifft_z(getattr(spect[r], n)) for n in ("Jp", "Jm", "Jz")],
            g, group.comm(r)))

    def replace():
        group.run(lambda r: domain.exchange_guards_replace(
            [tr.ifft_z(getattr(spect[r], n))
             for n in ("Ep", "Em", "Ez", "Bp", "Bm", "Bz")],
            g, group.comm(r)))

    def migrate():
        def one(r):
            st = run.states[r]
            zmin = st.zmin + run.multi_step.halos[r].offset(type(st.zmin))
            domain.migrate_particles(
                st.species[0], run.config_local, zmin, group.comm(r),
                run.migration_buffer, global_open=True)
        group.run(one)
    ms = {"exchange_add_J": cuda_ms(add, n_iter=10),
          "exchange_replace_EB": cuda_ms(replace, n_iter=10),
          "migration": cuda_ms(migrate, n_iter=5) / run.exchange_period}
    print(f"  halo device ms/step on the run's tensors (CUDA events, "
          f"the inverse z-FFTs before them included): {ms}", flush=True)
    return ms


def capture_slab_calls(run, targets, first_only=False):
    """{name: {slab rank: (args, kwargs)}} of each module.<name> in
    ``targets`` (pairs) during one more step of the decomposed run: one
    call of each per slab (``first_only``: each slab's first of
    several)."""
    from fbpic_tpu_torch.utils import kernels
    calls = {name: {} for _, name in targets}
    reals = {name: getattr(module, name) for module, name in targets}

    def recorder(name):
        def record(*args, **kwargs):
            by_rank = calls[name]
            rank = kernels.current_slab.rank
            if rank in by_rank and not first_only:
                raise RuntimeError(f"slab {rank} called {name} twice")
            by_rank.setdefault(rank, (args, kwargs))
            return reals[name](*args, **kwargs)
        return record
    # A replay runs no Python: the step goes through the eager slab loop
    eager, run.eager = run.eager, True
    for module, name in targets:
        setattr(module, name, recorder(name))
    try:
        run.step(1)
    finally:
        run.eager = eager
        for module, name in targets:
            setattr(module, name, reals[name])
    for name, by_rank in calls.items():
        if sorted(by_rank) != list(range(run.ndev)):
            raise RuntimeError(f"{name} called by the slabs {sorted(by_rank)}")
    return calls


def phase_multichip_kernels(run, label):
    """K1 and K2 on each slab's own operands (Nz_local rows), captured in
    one more step of the decomposed run, against their plain versions at
    TOL_K1 / TOL_K2 (measure_k1 / measure_k2 raise); timed.  K1's d(rho)
    is measured relative to the rho_next it adds to, with the planted
    fault (measure_k1(drho_vs_rho=True)): the slab ahead of the laser
    holds only cold plasma at rest, whose d(rho) is the rounding of
    equal endpoint weights (relative to its own largest value, the two
    versions' roundings differ by ~2e-5)."""
    import inspect
    import torch
    from fbpic_tpu_torch.core import step
    from fbpic_tpu_torch.particles import (cuda_fused, cuda_gather,
                                           sorted_deposit)
    calls = capture_slab_calls(run, ((sorted_deposit, "fused_onehot_contract"),
                                     (step, "gather_fields_sorted")))
    k1, k2 = {}, {}
    for r, device in enumerate(run.devices):
        with torch.cuda.device(device):
            args, kwargs = calls["fused_onehot_contract"][r]
            ops = inspect.signature(cuda_fused.fused_onehot_contract_plain
                                    ).bind(*args, **kwargs).arguments
            k1[r] = measure_k1(dict(ops), f"{label}, slab {r}",
                               drho_vs_rho=True)
            args, kwargs = calls["gather_fields_sorted"][r]
            ops = inspect.signature(cuda_gather.gather_sorted).bind(
                *args, **kwargs).arguments
            m = measure_k2(dict(ops), f"{label}, slab {r}", True)
            k2[r] = {k: m[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "live_fraction",
                                       "rel_err", "max_abs_err")}
    del calls
    torch.cuda.empty_cache()
    return k1, k2


def slabs_difference(a, b):
    """The arrays of two decomposed runs (every tensor of every slab)
    that differ, {"slab r, tensor i": largest difference relative to the
    largest value}, and whether their host values and generators'
    states are equal."""
    import torch
    from fbpic_tpu_torch.core.graph import state_tensors
    rel, same_host = {}, len(a.states) == len(b.states)
    for r, (sa, sb) in enumerate(zip(a.states, b.states)):
        for i, (x, y) in enumerate(zip(state_tensors(sa), state_tensors(sb))):
            y = y.to(x.device)
            if x.shape != y.shape or not torch.equal(x, y):
                d = (x.double() - y.double()).abs().max() if \
                    x.shape == y.shape else float("inf")
                rel[f"slab {r}, tensor {i}"] = float(d) / max(
                    float(x.double().abs().max()), 1e-300)
        same_host = same_host and all(
            getattr(sa, n) == getattr(sb, n)
            for n in ("time", "zmin", "mw_zref", "iteration"))
    same_gen = all(torch.equal(ga.get_state(), gb.get_state())
                   for ga, gb in zip(a._generators, b._generators))
    return rel, same_host and a.iteration == b.iteration, same_gen


def slabs_gate(label, graphed, eager, when):
    """The graphed slabs equal to the eager slabs, every array bit for
    bit, the host values and the generators' states too."""
    rel, same_host, same_gen = slabs_difference(graphed, eager)
    print(f"{label}, {when}: graphed slabs against the eager slabs: host "
          f"values equal {same_host}, generators equal {same_gen}, "
          f"differing arrays {rel}", flush=True)
    if rel or not same_host or not same_gen:
        raise RuntimeError(f"{label}: graphed and eager slabs differ "
                           f"{when}: {rel}, host {same_host}, generators "
                           f"{same_gen}")


def plant_slab_overflow(run):
    """plant_column_overflow on the slab of run whose fullest three-row
    run holds the most particles (its local (Nz, K) layout).  Returns
    (slab, row)."""
    import dataclasses
    import torch
    cfg, K = run.config_local, run.sim.species_configs[0].sort_K
    best = None
    for r, st in enumerate(run.states):
        live = (st.species[0].w != 0).reshape(cfg.Nz, K)
        counts = live.sum(1)
        three = counts[:-2] + counts[1:-1] + counts[2:]
        row = int(torch.argmax(three)) + 1
        if best is None or int(three[row - 1]) > best[2]:
            best = (r, row, int(three[row - 1]))
    r, row, n = best
    if n <= K:
        raise RuntimeError("plant_slab_overflow: no three rows hold more "
                           "than sort_K particles")
    st = run.states[r]
    sp = st.species[0]
    live = (sp.w != 0).reshape(cfg.Nz, K)
    z = sp.z.clone().reshape(cfg.Nz, K)
    z[row - 1] = torch.where(live[row - 1], z[row - 1] + cfg.dz, z[row - 1])
    z[row + 1] = torch.where(live[row + 1], z[row + 1] - cfg.dz, z[row + 1])
    run.states[r] = dataclasses.replace(
        st, species=[sp.replace(z=z.reshape(-1))] + list(st.species[1:]))
    return r, row


def slabs_planted_rollback(label, graphed, eager):
    """A column overflow planted in both decomposed runs at a replayed
    (non-exchange) step, under deterministic index_add_: the graphed
    chunk rolls back once, on every slab, and both runs are equal after
    it and after one more chunk.  Both runs then warn of a sort overflow
    (the planted particles past sort_K are dropped) instead of raising.
    Returns (slab, row, rollbacks)."""
    import warnings
    with deterministic_scatter(True):
        if graphed.iteration % graphed.exchange_period == 0:
            graphed.step(1)
            eager.step(1)
        where = [plant_slab_overflow(run) for run in (graphed, eager)]
        before = graphed.overflow_totals.get("rollbacks", 0)
        # the particles beyond sort_K are dropped, in both runs; the
        # crowded column may overflow again in the next steps
        for run in (graphed, eager):
            run.on_migration_overflow = "warn"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            graphed.step(GRAPH_PLANT_STEPS)
            eager.step(GRAPH_PLANT_STEPS)
        rolled = graphed.overflow_totals.get("rollbacks", 0) - before
        print(f"{label}: column overflow planted on slab {where[0][0]} at "
              f"row {where[0][1]}, iteration "
              f"{graphed.iteration - GRAPH_PLANT_STEPS}: {rolled} "
              f"rollback(s); sort_overflow graphed "
              f"{graphed.overflow_totals['sort_overflow']}, eager "
              f"{eager.overflow_totals['sort_overflow']}", flush=True)
        if rolled != 1 or graphed.overflow_totals["sort_overflow"] != \
                eager.overflow_totals["sort_overflow"] or \
                graphed.overflow_totals["sort_overflow"] == 0:
            raise RuntimeError(f"{label}: the planted overflow made "
                               f"{rolled} rollbacks")
        slabs_gate(label, graphed, eager, "after the planted rollback")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            graphed.step(GRAPH_PLANT_STEPS)
            eager.step(GRAPH_PLANT_STEPS)
        slabs_gate(label, graphed, eager, "after the next chunk")
    return where[0][0], where[0][1], rolled


def phase_multichip_lwfa(counters, n_slabs=MC_SLABS, devices=None,
                         one_card=False):
    """24. examples/multichip_lwfa_script.py at full width (Nz = 800,
    Nr = 50, Nm = 2, 2x2x4 per cell, n_e = 4e24, a0 = 4, n_order = 32,
    open z, moving window, its FieldDiagnostic every 100 steps collected),
    float32, through distribute_simulation on ``n_slabs`` slabs of
    ``devices`` -- by default MC_SLABS slabs, both on cuda:0 on a
    one-card machine, one per card on two or more: the slabs' chunk
    runner (one CUDA graph a card a variant; its graph_blockers printed)
    --, its eager slab twin (the same script, ``run.eager``) and its
    single-card twin (the same script, sim.step on the same schedule);
    with ``one_card``, also the same slabs all on cuda:0, graphed:
    - the graphed and the eager slabs under deterministic index_add_,
      every array bit for bit at 50, 100 and 200 steps (the generators'
      states and the collected records too), and the slabs on one card
      too (``one_card``: by reference what the cards copy);
    - exactly one K1 and one K2 launch per slab per step in each, no
      K3 (the graphed run's counted on its replays);
    - zero migration loss and zero sort overflow;
    - the gathered live count equal to the single card's, and the total
      weight within 1e-6, at every diagnostic;
    - Ez (m = 0, 1) within TOL_MULTICHIP of the single card's scale at
      50 steps (fbpic_tpu's gate of the per-slab current correction's
      locality); at 100 and 200 printed;
    - the E, B, J and rho records collected at 0 and 100 within
      TOL_MULTICHIP of the single card's on every row (the rho record
      is each slab's rho_prev summed over the halo);
    - a column overflow planted on a slab at a replayed step: the
      graphed chunk rolls back on every slab, equal to the eager slabs;
    - K1 and K2 on each slab's own operands, captured in one more step,
      against their plain versions at TOL_K1 / TOL_K2;
    then, for the graphed slabs (their graphs captured again without
    deterministic index_add_), the eager slabs, the graphed slabs on one
    card (``one_card``) and the single card, ms/step, device busy and
    idle share (in all and per card, with the cross-card copies' and
    flag waits' device time), launches a step, the device time by kernel
    group, the host syncs of step(14), and the halo's device time a
    step.  Returns the launches of the graphed decomposed run (the sums
    over its slabs) and the phase's numbers."""
    import warnings
    import torch
    from fbpic_tpu_torch.parallel import api
    n_cards = torch.cuda.device_count()
    if devices is None:
        devices = ([f"cuda:{i}" for i in range(n_slabs)]
                   if n_cards >= n_slabs else ["cuda:0"] * n_slabs)
    label = f"multichip LWFA, {n_slabs} slabs on {devices}"
    print(f"{label}: {n_cards} card(s) on this machine", flush=True)
    sink_run, sink_eager, sink_twin, sink_one = [], [], [], []
    real_dist = api.distribute_simulation
    # (distributing deposits rho_prev: a scatter deposit, made alike in
    # both under deterministic index_add_)
    with deterministic_scatter(True):
        ns = multichip_script(lambda sim, **kw: Deferred(real_dist(
            sim, devices=devices, **kw)), sink_run)
        ne = multichip_script(lambda sim, **kw: Deferred(real_dist(
            sim, devices=devices, **kw)), sink_eager)
        no = multichip_script(lambda sim, **kw: Deferred(real_dist(
            sim, devices=["cuda:0"] * n_slabs, **kw)), sink_one) \
            if one_card else None
    run, asked = ns["run"].run, ns["run"].asked
    run_e = ne["run"].run
    run_e.eager = True
    run_1 = no["run"].run if one_card else None
    tw = multichip_script(lambda sim, **kw: Deferred(Twin(sim)), sink_twin)
    twin = tw["run"].run
    sim = ns["sim"]
    cfg, cfgl = sim.config, run.config_local
    print(f"{label}: internal Nz {cfg.Nz}, n_guard {run.g}, slab Nz "
          f"{cfgl.Nz}, exchange period {run.exchange_period} (single card "
          f"{sim.exchange_period}), migration buffer {run.migration_buffer}"
          f", sort_K {sim.species_configs[0].sort_K}, slab capacity "
          f"{run.states[0].species[0].capacity}; the script asked for "
          f"{asked} steps; graph_blockers {run.graph_blockers}",
          flush=True)
    if not all(s.species[0].capacity == cfgl.Nz
               * sim.species_configs[0].sort_K for s in run.states):
        raise RuntimeError(f"{label}: a slab is not resident")
    out, checks = {}, {}
    launches = {k: 0 for k in counters}
    runs = [("graphed", run), ("eager", run_e)] + (
        [("one card", run_1)] if one_card else [])
    by_slab = {key: {k: {} for k in counters} for key, _ in runs}

    def counted(obj, key, n_steps):
        """obj.step(n_steps) with the kernel counts set to 0 just before
        and read just after (added to the phase's)."""
        for fn in counters.values():
            fn.launches = 0
            fn.launches_by_slab = {}
        obj.step(n_steps)
        torch.cuda.synchronize()
        for k, fn in counters.items():
            if key == "graphed":
                launches[k] += fn.launches
            for r, n in fn.launches_by_slab.items():
                by_slab[key][k][r] = by_slab[key][k].get(r, 0) + n

    t0 = time.perf_counter()
    done = 0
    for n_to in MC_STEPS:
        with deterministic_scatter(True):
            for key, obj in runs:
                counted(obj, key, n_to - done)
        twin.step(n_to - done)
        done = n_to
        slabs_gate(label, run, run_e, f"after {n_to} steps")
        if one_card:
            slabs_gate(f"{label} against the same slabs on cuda:0", run,
                       run_1, f"after {n_to} steps")
        dev = {}
        for m in (0, 1):
            a = twin.get_interp_field("Ez", m)
            b = run.get_interp_field("Ez", m)
            dev[m] = float(np.abs(a - b).max() / np.abs(a).max())
        checks[n_to] = dict(Ez_deviation=dev, live=run_live(run),
                            live_twin=twin.live())
        print(f"{label}: step {n_to}: Ez deviation from the single card "
              f"(m = 0, 1): {dev}; live, weight: {checks[n_to]['live']} "
              f"(single card {checks[n_to]['live_twin']})", flush=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = MC_STEPS[-1]
    want_slab = {"K1": {r: n for r in range(n_slabs)},
                 "K2": {r: n for r in range(n_slabs)}, "K3": {}}
    runner = run.runner
    variants = sorted(runner.graphs)
    print(f"{label}: {n} steps of the graphed slabs, the eager slabs and "
          f"the single card in {wall:.2f} s; graphed launches {launches}, "
          f"per slab {by_slab['graphed']} (eager slabs "
          f"{by_slab['eager']}); graph variants {variants}; overflow "
          f"{run.overflow_totals} (eager {run_e.overflow_totals}, single "
          f"card {sim_totals(twin.sim)})", flush=True)
    ported = ("K1", "K2", "K3")
    if any({k: v[k] for k in ported} != want_slab
           for v in by_slab.values()) or \
            {k: launches[k] for k in ported} != {
                "K1": n_slabs * n, "K2": n_slabs * n, "K3": 0}:
        raise RuntimeError(f"{label}: launches {launches} / {by_slab}")
    if "copy" in counters and (launches["copy"] > 0) != (
            len(set(devices)) > 1):
        raise RuntimeError(f"{label}: {launches['copy']} cross-card copy "
                           f"launches on {len(set(devices))} card(s)")
    if not run.graph_blockers.loop and not variants:
        raise RuntimeError(f"{label}: the graphed slabs captured no graph")
    if lost(run.overflow_totals) or lost(run_e.overflow_totals) or \
            lost(twin.sim.overflow_totals):
        raise RuntimeError(f"{label}: overflow {run.overflow_totals} / "
                           f"{run_e.overflow_totals} / "
                           f"{twin.sim.overflow_totals}")
    if checks[MC_STEPS[0]]["Ez_deviation"][0] >= TOL_MULTICHIP or \
            checks[MC_STEPS[0]]["Ez_deviation"][1] >= TOL_MULTICHIP:
        raise RuntimeError(f"{label}: Ez off the single card: {checks}")
    # (the twin's sim.step writes its diagnostics at the start of every
    # call as well: a call that starts on a period writes that iteration
    # a second time; its first record is compared)
    recs, recs_twin = records_by_file(sink_run), records_by_file(sink_twin)
    recs_eager = records_by_file(sink_eager)
    period = sim.diags[0].period
    diag_its = sorted(int(k[4:12]) for k in recs)
    if sorted(recs) != sorted(recs_twin) or sorted(recs) != sorted(
            recs_eager) or diag_its != list(range(0, n + 1, period)) or any(
                len(v) != 1 for v in recs.values()):
        raise RuntimeError(f"{label}: diagnostics at {sorted(recs)} / "
                           f"{sorted(recs_eager)} / {sorted(recs_twin)}")
    rec_dev = {}
    # the record's z rows (the physical grid) within 2 n_guard of a seam
    rows = np.arange(sim.Nz_phys) + sim.nd_edge
    near_seam = np.abs(rows[:, None] - run.Nz_int * np.arange(
        1, n_slabs)).min(axis=1) < 2 * run.g
    for it in (0, period):
        name = "data%08d.h5" % it
        same = record_differences(recs_eager[name], recs[name])
        if same:
            raise RuntimeError(f"{label}: records at {it}: graphed and "
                               f"eager slabs differ {same}")
        diff = record_differences(recs_twin[name][:1], recs[name])
        path = "/data/%d/fields/rho" % it
        a, b = recs_twin[name][0][path][0], recs[name][0][path][0]
        by_row = np.abs(a - b).max(axis=(0, 1)) / np.abs(a).max()
        diff["rho at the seams"] = float(by_row[near_seam].max())
        rec_dev[it] = diff
        off = {p: v for p, v in diff.items() if v >= TOL_MULTICHIP}
        print(f"{label}: records at {it}, deviation from the single "
              f"card's relative to each dataset's largest value (rho also "
              f"on the {int(near_seam.sum())} of {len(rows)} rows within "
              f"{2 * run.g} rows of a seam): {diff}; the eager slabs' "
              f"equal bit for bit", flush=True)
        if off:
            raise RuntimeError(f"{label}: records at {it} off the single "
                               f"card: {off}")
    for it in MC_STEPS:
        (n_run, w_run) = checks[it]["live"]
        (n_twin, w_twin) = checks[it]["live_twin"]
        if n_run != n_twin or abs(w_run - w_twin) > 1e-6 * w_twin:
            raise RuntimeError(f"{label}: live {n_run}, {w_run} against "
                               f"the single card's {n_twin}, {w_twin} at "
                               f"{it}")
    for s in run.states:
        for name in ("Er", "Et", "Ez", "Br", "Bt", "Bz"):
            if not bool(getattr(s.interp, name).isfinite().all()):
                raise RuntimeError(f"{label}: non-finite {name}")
    out["gates"] = dict(checks={str(k): v for k, v in checks.items()},
                        records={str(k): v for k, v in rec_dev.items()},
                        launches=launches, launches_by_slab=by_slab,
                        graph_variants=[list(v) for v in variants],
                        graph_blockers=run.graph_blockers._asdict())
    slab, row, rolled = slabs_planted_rollback(label, run, run_e)
    out["planted_rollback"] = dict(slab=slab, row=row, rollbacks=rolled)
    out["k1_slabs"], out["k2_slabs"] = phase_multichip_kernels(run, label)
    # The graphs hold the sorted index_add_ they were captured with:
    # captured again without it, as a user's run has them
    run.runner.release()
    # Cost: the graphed slabs, the eager slabs and the single card, in
    # the same call; one untimed exchange period first (the graphed
    # run's captures fall outside the timed window)
    warnings.filterwarnings("ignore", "particle-step", RuntimeWarning)
    if one_card:
        run_1.runner.release()
    cost = [("slabs", run, run_live(run)[0]),
            ("eager slabs", run_e, run_live(run_e)[0])] + (
        [("slabs on one card", run_1, run_live(run_1)[0])]
        if one_card else []) + [("twin", twin, twin.live()[0])]
    for key, obj, live in cost:
        obj.step(run.exchange_period + 1)
        graphs = dict(obj.runner.graphs) if key != "twin" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obj.step(N_COST)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / N_COST * 1e3
        if graphs is not None and obj.runner.graphs != graphs:
            raise RuntimeError(f"{label}: the timed window captured "
                               f"graphs of its own")
        prof = profile_steps(obj, N_PROFILED, breakdown=True)
        syncs = count_syncs(obj, f"{label} ({key})", 14)
        m = dict(ms_per_step=ms, live=live,
                 ns_per_particle_step=ms * 1e6 / live, host_syncs_step14=syncs)
        if prof is not None:
            # on several cards: the busiest card's (its flag waits
            # included; per card beside it), not the sum over the cards
            busy = max(v["busy_ms"] for v in prof["per_card"].values())
            m.update(device_ms_per_step=busy, idle_share=1 - busy / ms,
                     device_ms_all_cards=prof["device_ms_per_step"],
                     launches_per_step=prof["launches_per_step"],
                     host_launch_calls_per_step=prof[
                         "host_launch_calls_per_step"],
                     kernel_ms_per_step=prof["kernel_ms_per_step"],
                     kernel_groups=prof["kernel_groups"],
                     per_card={c: dict(v, idle_share=1 - v[
                         "busy_without_waits_ms"] / ms)
                         for c, v in prof["per_card"].items()})
        print(f"{label} ({key}): {ms:.4f} ms/step over {N_COST} steps, "
              f"{m.get('device_ms_per_step')} ms/step device busy, idle "
              f"share {m.get('idle_share')}, {m.get('launches_per_step')} "
              f"launches a step, {m.get('host_launch_calls_per_step')} host "
              f"launch calls a step, {syncs['count']} host syncs in "
              f"step(14)", flush=True)
        if key in ("slabs", "slabs on one card") and syncs["count"] > 1:
            # the migration and the exchange block replay in the graphs:
            # the chunk's one read is the only sync
            raise RuntimeError(f"{label}: {syncs['count']} host syncs in "
                               f"step(14), not 1")
        out[key] = m
    warnings.filters.pop(0)
    out["slabs"]["graph_variants"] = [list(v) for v in
                                      sorted(run.runner.graphs)]
    out["overflow_after_the_plant"] = dict(slabs=dict(run.overflow_totals),
                                           eager=dict(run_e.overflow_totals))
    out["slabs"]["halo_device_ms_per_step"] = exchange_device_ms(run)
    if "copy" in counters and len(set(devices)) > 1:
        out["copy"] = measure_peer_copy(run)
    run.runner.release()
    if one_card:
        run_1.runner.release()
    del run, run_e, run_1, twin, ns, ne, no, tw, sim, runner
    torch.cuda.empty_cache()
    return {k: sum(v.values()) for k, v in by_slab["graphed"].items()}, out


def measure_peer_copy(run):
    """The cross-card copy (csrc/peer.cu ``copy_parts``) on one of the
    run's exchanges: slab 0's six E / B guard strips (the 2g..g rows
    before its right edge that exchange_guards_replace sends slab 1,
    made contiguous) into buffers on slab 1's card, one launch, against
    its plain version (torch's copy_ of each strip across the cards) on
    the same strips, bit for bit; both timed on slab 0's card (CUDA
    events); bound: the strips' bytes over one way of NVLink (the local
    read and the remote write each move them once)."""
    import torch
    from fbpic_tpu_torch.fields import transform as tr
    from fbpic_tpu_torch.parallel import peer
    g = run.g
    src_dev, dst_dev = run.devices[0], run.devices[1]
    with torch.cuda.device(src_dev):
        fields = [tr.ifft_z(getattr(run.states[0].spect, n))
                  for n in ("Ep", "Em", "Ez", "Bp", "Bm", "Bz")]
        n = fields[0].shape[1]
        src = [F[:, n - 2 * g:n - g].contiguous() for F in fields]
        dst = [torch.empty_like(t, device=dst_dev) for t in src]
        ref = [torch.empty_like(t, device=dst_dev) for t in src]
        peer.copy_parts(dst, src)
        peer.copy_parts_plain(ref, src)
        torch.cuda.synchronize(src_dev)
        torch.cuda.synchronize(dst_dev)
        err = max(float((a - b).abs().max()) for a, b in zip(dst, ref))
        if not all(torch.equal(a, b) for a, b in zip(dst, ref)):
            raise RuntimeError(f"the cross-card copy differs from its plain "
                               f"version by {err}")
        ms = cuda_ms(lambda: peer.copy_parts(dst, src))
        plain_ms = cuda_ms(lambda: peer.copy_parts_plain(ref, src))
    n_bytes = sum(t.numel() * t.element_size() for t in src)
    bound_ms = n_bytes / NVLINK_BYTES_PER_S * 1e3
    print(f"cross-card copy {src_dev} -> {dst_dev}, six {tuple(src[0].shape)} "
          f"{src[0].dtype} strips ({n_bytes} bytes): kernel {ms:.4f} ms, "
          f"plain (torch copy_ a strip) {plain_ms:.4f} ms, bound over "
          f"NVLink {bound_ms:.5f} ms; bit for bit", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None, n_bytes=n_bytes)


def sim_totals(sim):
    return dict(sim.overflow_totals)


class NumpyAngles:
    """Injection angles from a numpy generator keyed by (iteration,
    species): the same numbers on the card and on the CPU."""

    def __call__(self, iteration, species_index, nkey):
        import torch
        rng = np.random.RandomState(1000 * int(iteration)
                                    + int(species_index))
        return torch.as_tensor(2 * np.pi * rng.random_sample(nkey.shape[0]),
                               device=nkey.device)


def resident_mesh_run(device, n_slabs=MC64_SLABS, devices=None):
    """tests/test_resident.py:240-304's resident mesh in float64 on
    n_slabs slabs of ``device`` (n_slabs 0: the single device, not
    decomposed) or on ``devices`` (one a slab), MC64_STEPS steps; the
    run (or the Simulation)."""
    import torch
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    from fbpic_tpu_torch.parallel import distribute_simulation
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
    sim.column_angles = NumpyAngles()
    if not n_slabs:
        sim.step(MC64_STEPS)
        return sim
    run = distribute_simulation(sim, devices=devices or [device] * n_slabs,
                                n_guard=24)
    if 0 not in run._resident_idx or run.exchange_period != 4:
        raise RuntimeError("resident mesh: not the test's configuration")
    run.step(MC64_STEPS)
    return run


#: Families of arrays held to one scale (a component that is roundoff in
#: this configuration, as Bz or the m = 1 parts of a linearly polarized
#: laser, is held to its vector's scale)
MESH_FAMILIES = {
    "spect E": ("spect", ("Ep", "Em", "Ez")),
    "spect B": ("spect", ("Bp", "Bm", "Bz")),
    "spect J": ("spect", ("Jp", "Jm", "Jz")),
    "rho_prev": ("spect", ("rho_prev",)),
    "interp E": ("interp", ("Er", "Et", "Ez")),
    "interp B": ("interp", ("Br", "Bt", "Bz")),
    "positions": ("species", ("x", "y", "z")),
    "momenta": ("species", ("ux", "uy", "uz")),
    "weights": ("species", ("w",)),
}


def family_deviations(cpu_states, card_states):
    """Largest |card - CPU| of each MESH_FAMILIES family, relative to the
    family's largest |CPU| value, over the slabs (or the single states);
    the particles over the live slots, which must be the same.  Also,
    per component ("family.name"), its largest |card - CPU| relative to
    its own largest |CPU| value, and its share: that value over the
    family's."""
    import torch
    out, own = {}, {}
    for fam, (part, names) in MESH_FAMILIES.items():
        comp = {n: [0.0, 0.0] for n in names}       # [diff, scale]
        for a, b in zip(cpu_states, card_states):
            live = a.species[0].w != 0
            if not torch.equal(live, (b.species[0].w != 0).cpu()):
                raise RuntimeError("the live slots differ")
            for n in names:
                if part == "species":
                    x = getattr(a.species[0], n)[live].numpy()
                    y = getattr(b.species[0], n).cpu()[live].numpy()
                else:
                    x = getattr(getattr(a, part), n).numpy()
                    y = getattr(getattr(b, part), n).cpu().numpy()
                if x.size:
                    comp[n][0] = max(comp[n][0], float(np.abs(x - y).max()))
                    comp[n][1] = max(comp[n][1], float(np.abs(x).max()))
        scale = max(max(v[1] for v in comp.values()), 1e-300)
        out[fam] = max(v[0] for v in comp.values()) / scale
        for n, (d, sc) in comp.items():
            own[f"{fam}.{n}"] = dict(own=d / max(sc, 1e-300),
                                     share=sc / scale)
    return out, own


#: Steps of each graph-path run beside its eager twin (they cross the
#: exchange steps of every 14th step on the bench LWFA); the boosted
#: window shifts 2 cells a step but 1 at steps 200, 399, ... (it gains
#: 1.995 cells a step on the drifting grid), so its run takes 210 steps
#: to capture and compare both variants
GRAPH_STEPS = 200
GRAPH_STEPS_BOOSTED = 210
#: Steps of the call after the planted column overflow
GRAPH_PLANT_STEPS = 10
#: The ionization LWFA pair (phase 18's configuration): the created
#: electrons' ring built with the capacity phase 18's run ends at (one
#: 200-step call holds what it creates), and both runs stepped
#: GRAPH_ION_RUN_UP steps first, so that the pair's steps fall where the
#: laser ionizes the dopant (its peak enters the plasma near step 160)
GRAPH_ION_CAPACITY, GRAPH_ION_RUN_UP = 262144, 150
#: The Compton PWFA pair's photon ring (phase 19's grows to it)
GRAPH_CMP_CAPACITY = 524288
#: The ballistic PWFA pair: phase 15's drive bunch with its injection
#: plane 5 sig_z ahead of its centre.  The bunch spans +-5 sig_z (20 um)
#: and moves 0.05 um a step, so it crosses the plane whole in ~400
#: steps: the pair runs GRAPH_STEPS_BALLISTIC steps, not GRAPH_STEPS
BALLISTIC_PLANE = PWFA_BUNCH["zf"] + 5 * PWFA_BUNCH["sig_z"]
GRAPH_STEPS_BALLISTIC = 420


def plant_column_overflow(sim):
    """Move the live particles of the two rows around the fullest
    three-row run into its middle column: more than sort_K of them then
    belong to that column, which the next banded re-sort counts as
    overflow (a lone particle past the band is clamped into the nearest
    in-band row and counts nothing).  Returns the row."""
    import torch
    sp, K = sim.state.species[0], sim.species_configs[0].sort_K
    Nz, dz = sim.config.Nz, sim.config.dz
    live = (sp.w != 0).reshape(Nz, K)
    counts = live.sum(1)
    row = int(torch.argmax(counts[:-2] + counts[1:-1] + counts[2:])) + 1
    if int(counts[row - 1:row + 2].sum()) <= K:
        raise RuntimeError("plant_column_overflow: no three rows hold more "
                           "than sort_K particles")
    z = sp.z.clone().reshape(Nz, K)
    z[row - 1] = torch.where(live[row - 1], z[row - 1] + dz, z[row - 1])
    z[row + 1] = torch.where(live[row + 1], z[row + 1] - dz, z[row + 1])
    sim.state.species[0] = sp.replace(z=z.reshape(-1))
    return row


def twin_gate(label, graphed, twin, when):
    """Every array of the graphed run equal to its eager twin's bit for
    bit, but rho_prev (TOL_ATOMIC_RHO of its scale: an atomic scatter
    deposit); the host values and the generators' states (the injection
    angles' and the processes' draws: their Philox offsets) equal.
    Returns the differing arrays."""
    import torch
    rel, same_host = twin_difference(graphed, twin)
    same_gen = torch.equal(graphed.generator.get_state(),
                           twin.generator.get_state())
    print(f"{label}, {when}: graphed against the eager twin: host values "
          f"equal {same_host}, generators' states equal {same_gen}, "
          f"differing arrays {rel}", flush=True)
    off = {k: v for k, v in rel.items()
           if k != ".spect.rho_prev" or v > TOL_ATOMIC_RHO}
    if not same_host or not same_gen or off:
        raise RuntimeError(f"{label}: graphed and eager differ {when}: "
                           f"{rel}, host equal {same_host}, generators "
                           f"equal {same_gen}")
    return rel


def timed_run(run, n_steps):
    """ms/step of run(n_steps), synchronized, and the peak memory it
    allocated above what was allocated before it (GB)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(n_steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    return ms, (torch.cuda.max_memory_allocated() - base) / 1e9


@contextlib.contextmanager
def deterministic_scatter(on):
    """With ``on``: torch's deterministic algorithms while the block runs
    (index_add_ as a sorted segment sum instead of float atomics; other
    ops warn only; no fill of new memory), so that the scatter deposit of
    rho_prev gives the same bits in every run."""
    import torch
    import torch.utils.deterministic as det
    if not on:
        yield
        return
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = fill


def record_captures(sim):
    """Every (valid, z_lab, slices) chunk the back-transformed field
    diagnostics of sim consume from now on, as numpy copies: the chunk
    runner's rows, or the eager loop's buffer."""
    out = []
    for diag in sim.diags:
        if not hasattr(diag, "device_capture"):
            continue
        real = diag.process_chunk

        def record(s, caps, real=real):
            out.append([np.array(a) for a in caps])
            return real(s, caps)
        diag.process_chunk = record
    return out


def btd_gate(label, graphed, twin, rows_graphed, rows_twin):
    """The BTD of the graphed run against its twin's: every captured row
    (valid, z_lab, slices) and every lab snapshot (filled cells, data)
    bit for bit.  Returns (rows, filled cells)."""
    a = [np.concatenate(x) for x in zip(*rows_graphed)]
    b = [np.concatenate(x) for x in zip(*rows_twin)]
    same = len(a) == len(b) == 3 and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))
    filled = 0
    for d0, d1 in zip(graphed.diags, twin.diags):
        for s0, s1 in zip(getattr(d0, "snapshots", []),
                          getattr(d1, "snapshots", [])):
            if not hasattr(s0, "filled"):
                continue
            filled += int(s0.filled.sum())
            same = same and np.array_equal(s0.filled, s1.filled) and all(
                np.array_equal(s0.data[n], s1.data[n]) for n in s0.names)
    n_rows = a[0].shape[0] if a else 0
    print(f"{label}: BTD of the graphed run against the twin's: {n_rows} "
          f"captured rows ({int(a[0].sum()) if a else 0} valid planes), "
          f"{filled} lab cells filled; bit for bit {same}", flush=True)
    if not same or n_rows == 0:
        raise RuntimeError(f"{label}: the BTD differs from the twin's")
    return n_rows, filled


def graph_pair(label, build, per_step, counters, variants_want, n_steps,
               plant=False, deterministic=False, syncs_max=1,
               atomics=False, windows=None, run_up=0, probe=None):
    """One path's graphed run (Simulation.step) beside its eager twin
    (eager_steps), both built by build() from the same seeds (and, with
    run_up, both stepped run_up steps by Simulation.step first): n_steps
    steps each in one call, the graphed run's kernel counts (set to 0
    just before it) exactly per_step a step, exchange steps included,
    its graph variants (n_move, full re-sort, exchange block inside)
    variants_want; every array bit for bit but rho_prev; a
    back-transformed field diagnostic's captured rows and snapshots bit
    for bit; no loss; windows(graphed, twin, eager), if given (more steps
    with a mirror, an external field); then each run's ms/step, peak
    memory, profiled window (device busy, launches, host launch calls)
    and host syncs of an exchange period (at most syncs_max for the
    graphed run; host launch calls a step beside them), in the same
    calls on both after one untimed exchange
    period, and the equality once more; with plant, a column overflow
    planted in both at a non-exchange step, and the graphed call that
    rolls back equal to the twin's.  With deterministic, both builds,
    the run-up, the n_steps steps of both runs, the windows and the
    planted rollback run under deterministic_scatter (rho_prev, a ring's
    J, a bunch's initial charge or the newborns' birth-step J and rho is
    a scatter deposit with float atomics otherwise; the Galilean /
    comoving correction reads rho_prev, so its bits reach E, B, J and
    the particles), and with atomics two eager runs without it show
    what the atomics alone change; the timed windows follow without it
    (the graphs captured again without it), and the equality is then
    not held again.  probe = (fn, check): the n_steps go in two calls of
    half each, fn(sim) of both runs is read before, between and after,
    equal in both, and check(values of the graphed run) raises where
    they are wrong (particles created, a plane crossed)."""
    import torch
    with deterministic_scatter(deterministic):
        # (a bunch's space-charge field is deposited when it is built)
        graphed, twin = build(), build()
        if run_up:
            graphed.step(run_up)
            twin.step(run_up)
            # Both runners dropped: the counted call captures anew, so
            # that its peak holds the runner's buffers and graph pool
            # (the twin steps eagerly from here)
            recapture(graphed)
            recapture(twin)
            torch.cuda.empty_cache()
    caps = {"graphed": record_captures(graphed),
            "eager": record_captures(twin)}
    eager = lambda n: eager_steps(twin, n)   # noqa: E731
    calls = (n_steps // 2, n_steps - n_steps // 2) if probe else (n_steps,)
    probed = {"graphed": [], "eager": []}
    with deterministic_scatter(deterministic):
        peaks, seconds, counted = {}, {}, {}
        for name, sim, run in (("graphed", graphed, graphed.step),
                               ("eager", twin, eager)):
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            peaks[name] = 0.
            for n in calls:
                if probe:
                    probed[name].append(probe[0](sim))
                # from the first call: the static buffers, the chunk's
                # input kept aside and the graph pool count in the
                # graphed run's peak
                peaks[name] = max(peaks[name], timed_run(run, n)[1])
            if probe:
                probed[name].append(probe[0](sim))
            seconds[name] = time.perf_counter() - t0
            counted[name] = {k: fn.launches for k, fn in counters.items()}
    launches, twin_launches = counted["graphed"], counted["eager"]
    peak_graphed, peak_eager = peaks["graphed"], peaks["eager"]
    t_graphed, t_eager = seconds["graphed"], seconds["eager"]
    runner = graphed._multi_step
    variants = sorted(runner.graphs) if runner is not None else None
    print(f"{label}: {n_steps} steps graphed in {t_graphed:.2f} s "
          f"(captures included; variants {variants}), eager twin "
          f"{t_eager:.2f} s; launches graphed {launches} (counted per "
          f"replay), eager {twin_launches}; overflow graphed "
          f"{graphed.overflow_totals}, twin {twin.overflow_totals}; peak "
          f"memory above the run's start: graphed {peak_graphed:.3f} GB, "
          f"eager {peak_eager:.3f} GB", flush=True)
    want = {k: v * n_steps for k, v in per_step.items()}
    if runner is None or variants != variants_want:
        raise RuntimeError(f"{label}: graph variants {variants}, not "
                           f"{variants_want}")
    if launches != want or twin_launches != want:
        raise RuntimeError(f"{label}: launches {launches} / eager "
                           f"{twin_launches} != {want}")
    if lost(graphed.overflow_totals) or lost(twin.overflow_totals):
        raise RuntimeError(f"{label}: overflow {graphed.overflow_totals} / "
                           f"{twin.overflow_totals}")
    check_fields(graphed, label)
    rel = twin_gate(label, graphed, twin, f"after {n_steps} steps")
    out = dict(steps=n_steps, launches=launches, variants=[
        list(v) for v in variants], rho_prev_rel_diff=rel.get(
            ".spect.rho_prev", 0.0), deterministic_scatter=deterministic,
        rollbacks=graphed.overflow_totals.get("rollbacks", 0),
        first_call_peak_gb=dict(graphed=peak_graphed, eager=peak_eager))
    if caps["graphed"] or caps["eager"]:
        out["btd_rows"], out["btd_filled"] = btd_gate(
            label, graphed, twin, caps["graphed"], caps["eager"])
    if probe:
        print(f"{label}: probed before, between and after the two calls: "
              f"graphed {probed['graphed']}, eager {probed['eager']}",
              flush=True)
        if probed["graphed"] != probed["eager"]:
            raise RuntimeError(f"{label}: probes differ {probed}")
        probe[1](probed["graphed"])
        out["probe"] = probed["graphed"]
    if windows is not None:
        with deterministic_scatter(deterministic):
            out["windows"] = windows(graphed, twin, eager, counters)
    # The graph's copy of the step's results into the static buffers
    # (every state tensor once): its bytes and its time on the card
    from fbpic_tpu_torch.core.graph import state_tensors
    runner = graphed._multi_step
    pairs = list(zip(runner._static, state_tensors(graphed.state)))
    state_bytes = sum(t.numel() * t.element_size() for _, t in pairs)
    copy_ms = cuda_ms(lambda: [s.copy_(t) for s, t in pairs])
    copy_bound, _ = bound(2 * state_bytes, 0)      # read and write once
    print(f"{label}: the state is {state_bytes / 1e6:.1f} MB in "
          f"{len(pairs)} tensors; copying it into the static buffers takes "
          f"{copy_ms:.4f} ms (bound {copy_bound:.4f} ms)", flush=True)
    out.update(state_bytes=state_bytes, copy_back_ms=copy_ms,
               copy_back_bound_ms=copy_bound)
    del pairs
    if atomics:
        pair = [build() for _ in range(2)]
        for sim in pair:
            eager_steps(sim, n_steps)
        atomics, _ = twin_difference(*pair)
        print(f"{label}: two eager runs with the atomic scatter, "
              f"{n_steps} steps: differing arrays {atomics}", flush=True)
        out["eager_vs_eager_atomics"] = atomics
        del pair
        torch.cuda.empty_cache()
    if deterministic:
        # The graphs hold the sorted index_add_ they were captured with:
        # capture them again without it, as a user's run has them
        recapture(graphed)
    # One exchange period in both before the timed windows, so that the
    # captures of a new chunk runner (the windows' options, the reset)
    # fall outside them
    graphed.step(graphed.exchange_period)
    eager(twin.exchange_period)
    for name, sim, run in (("graphed", graphed, graphed.step),
                           ("eager", twin, eager)):
        runner = sim._multi_step
        graphs = None if runner is None else dict(runner.graphs)
        ms, peak = timed_run(run, N_TIMED)
        if name == "graphed" and (sim._multi_step is not runner
                                  or sim._multi_step.graphs != graphs):
            # its time and idle share would include a capture
            raise RuntimeError(
                f"{label}: the timed window captured graphs of its own "
                f"(variants {sorted(sim._multi_step.graphs)}, overflow "
                f"{sim.overflow_totals})")
        prof = profile_steps(sim, N_PROFILED, run=run)
        syncs = count_syncs(sim, f"{label} {name}", sim.exchange_period,
                            run=run)
        out[name] = dict(
            ms_per_step=ms, peak_gb_above_start=peak,
            reserved_gb=torch.cuda.memory_reserved() / 1e9,
            host_syncs_exchange_period=syncs,
            profile=prof, idle_share=None if prof is None else
            1 - prof["device_ms_per_step"] / ms)
        busy = None if prof is None else prof["device_ms_per_step"]
        calls = None if prof is None else prof["host_launch_calls_per_step"]
        print(f"{label} {name}: {ms:.4f} ms/step, device busy {busy} "
              f"ms/step, idle share {out[name]['idle_share']}, "
              f"{calls} host launch calls a step, peak "
              f"{peak:.3f} GB above the run's start, "
              f"{syncs['count']} host syncs in step({sim.exchange_period})",
              flush=True)
        if name == "graphed" and syncs["count"] > syncs_max:
            raise RuntimeError(f"{label}: {syncs['count']} host syncs in "
                               f"an exchange period, not <= {syncs_max}")
    if not deterministic:
        twin_gate(label, graphed, twin, "after the timed windows")
    if plant and deterministic:
        # The timed windows ran on float atomics: the twin takes the
        # graphed run's state, and both roll back under
        # deterministic_scatter, the graphs captured again under it
        reseed_twin(twin, graphed)
        recapture(graphed)
        with deterministic_scatter(True):
            out["planted_rollbacks"] = planted_rollback(label, graphed,
                                                        twin, eager)
    elif plant:
        out["planted_rollbacks"] = planted_rollback(label, graphed, twin,
                                                    eager)
    return out


def recapture(sim):
    """Drop sim's chunk runner (its graphs released): the next step()
    call builds and captures a new one."""
    if sim._multi_step is not None:
        sim._multi_step.release()
    sim._multi_step = sim._multi_step_key = None


def reseed_twin(twin, sim):
    """The twin given a copy of sim's state, sort_K, counters and
    generator state (its checkpoint, every tensor cloned)."""
    from fbpic_tpu_torch.diagnostics.checkpoint_restart import (
        checkpoint_dict, load_checkpoint_dict)
    ckpt = checkpoint_dict(sim)
    ckpt["tensors"] = {k: v.clone() for k, v in ckpt["tensors"].items()}
    load_checkpoint_dict(twin, ckpt)
    twin_gate("reseeded twin", sim, twin, "after the copy")


def planted_rollback(label, graphed, twin, eager):
    """A column overflow planted in both runs at a non-exchange step: the
    graphed call rolls back once (the generators' states restored with
    its input), and both runs are equal after it (twin_gate; the
    generators' states too) and after the next call, which captures
    anew.  Returns the rollbacks."""
    import warnings
    if graphed.iteration % graphed.exchange_period == 0:
        graphed.step(1)
        eager(1)
    rows = [plant_column_overflow(sim) for sim in (graphed, twin)]
    before = graphed.overflow_totals.get("rollbacks", 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        graphed.step(GRAPH_PLANT_STEPS)
        eager(GRAPH_PLANT_STEPS)
    rolled = graphed.overflow_totals.get("rollbacks", 0) - before
    print(f"{label}: column overflow planted at row {rows[0]} at "
          f"iteration {graphed.iteration - GRAPH_PLANT_STEPS}: "
          f"{rolled} rollback(s); sort_overflow graphed "
          f"{graphed.overflow_totals['sort_overflow']}, twin "
          f"{twin.overflow_totals['sort_overflow']}; sort_K now "
          f"{graphed.species_configs[0].sort_K}", flush=True)
    if rolled != 1 or graphed.overflow_totals["sort_overflow"] == 0:
        raise RuntimeError(f"{label}: the planted overflow made "
                           f"{rolled} rollbacks")
    twin_gate(label, graphed, twin, "after the planted rollback")
    graphed.step(GRAPH_PLANT_STEPS)
    eager(GRAPH_PLANT_STEPS)
    twin_gate(label, graphed, twin, "after the re-captured call")
    return rolled


def with_btd(sim, workdir):
    """sim with phase 9's back-transformed field diagnostic (20 snapshots
    BTD_DT_LAB apart), its snapshots collected, not written."""
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.diagnostics import BackTransformedFieldDiagnostic
    btd = BackTransformedFieldDiagnostic(
        B_ZMIN_LAB, B_ZMAX_LAB, c, dt_snapshots_lab=BTD_DT_LAB,
        Ntot_snapshots_lab=BTD_NSNAP, gamma_boost=B_GAMMA,
        period=BTD_PERIOD, fldobject=sim.fld, comm=sim.comm,
        write_dir=workdir)
    collect_only(btd, [])
    sim.diags = [btd]
    return sim


def ant_ext_ez(F, x, y, z, t, amplitude, length_scale):
    """Phase 16's external field: a uniform Ez of ``amplitude``."""
    return F + amplitude


def antenna_windows(graphed, twin, eager, counters):
    """Phase 16's windows on the antenna pair: N_NEW_TIMED more steps of
    both with its Mirror 2 um inside the window's right edge, then as
    many with its ExternalField instead; in each, one K1 and one K2 a
    step in both runs (counted per replay in the graphed one) and every
    array bit for bit but rho_prev."""
    from fbpic_tpu_torch.lpa_utils import ExternalField, Mirror
    label = "antenna LWFA"
    z_mirror = float(graphed.grid_z()[-1] + 0.5 * graphed.config.dz
                     - ANT_MIRROR_INSET)
    attach = {
        "mirror": lambda sim: sim.mirrors.append(
            Mirror(z_lab=z_mirror, n_cells=2)),
        "external_field": lambda sim: sim.external_fields.append(
            ExternalField(ant_ext_ez, "Ez", ANT_EXT_EZ, 0.))}
    want = {"K1": N_NEW_TIMED, "K2": N_NEW_TIMED, "K3": 0}
    out = {}
    for key, add in attach.items():
        launches = {}
        for name, sim, run in (("graphed", graphed, graphed.step),
                               ("eager", twin, eager)):
            sim.mirrors.clear()
            sim.external_fields.clear()
            add(sim)
            for fn in counters.values():
                fn.launches = 0
            run(N_NEW_TIMED)
            launches[name] = {k: fn.launches for k, fn in counters.items()}
        print(f"{label} + {key}: {N_NEW_TIMED} steps, launches {launches}, "
              f"graph variants {sorted(graphed._multi_step.graphs)}",
              flush=True)
        if any(v != want for v in launches.values()):
            raise RuntimeError(f"{label} + {key}: launches {launches}")
        rel = twin_gate(f"{label} + {key}", graphed, twin,
                        f"after {N_NEW_TIMED} steps")
        out[key] = dict(launches=launches["graphed"],
                        rho_prev_rel_diff=rel.get(".spect.rho_prev", 0.0))
    for sim in (graphed, twin):
        sim.mirrors.clear()
        sim.external_fields.clear()
    return out


def live_of(index):
    """probe: the live particles of species ``index``."""
    return lambda sim: int((sim.state.species[index].w != 0).sum())


def created_in_the_pair(label):
    """check of live_of: particles were created in each half of the
    pair's steps (of which all but the exchange steps are replayed)."""
    def check(live):
        print(f"{label}: created in the pair's steps {live[-1] - live[0]} "
              f"({live[1] - live[0]} and {live[2] - live[1]} in its two "
              f"calls)", flush=True)
        if not live[0] < live[1] < live[2]:
            raise RuntimeError(f"{label}: nothing created: {live}")
    return check


def behind_the_plane(sim):
    """probe: (the bunch's live particles behind its injection plane,
    its live particles)."""
    sp = sim.state.species[1]
    live = sp.w != 0
    return (int(((sp.z <= BALLISTIC_PLANE) & live).sum()),
            int(live.sum()))


def crossed_the_plane(values):
    """check of behind_the_plane: all the bunch behind the plane at the
    start, some of it halfway, none at the end."""
    (b0, n0), (b1, n1), (b2, n2) = values
    if not (b0 == n0 > 0 and 0 < b1 < n1 and b2 == 0):
        raise RuntimeError(f"ballistic PWFA: behind the plane {values}")


def phase_graph_paths(counters, smi):
    """26. The chunk runner (core/graph.py: the non-exchange steps
    replayed from captured CUDA graphs) on the bench LWFA, the boosted
    LWFA (phase 6; n_move alternates: two variants), the PICMI LWFA
    (phase 21; its dens_func on the host at the exchange steps), the
    boosted LWFA with phase 9's BTD captured inside the chunk, the
    antenna LWFA (phase 16; then its mirror and its external field), the
    PWFA driver (phase 15: a resident plasma and a 1,000,000-particle
    ring bunch), the published boosted script (a ring) with the BTD, the
    ionization LWFA (phase 18: its resident N5+ ions ionized into a
    262,144-slot ring, from step GRAPH_ION_RUN_UP), the Compton PWFA
    (phase 19: photons into a 524,288-slot ring across the overlap) and
    the ballistic PWFA (phase 15's bunch crossing an injection plane),
    each beside its eager twin (graph_pair); the bench run and the
    ionization LWFA also roll back a planted column overflow.  Every
    exchange step's exchange block (removal, injection, a fresh
    rho_prev; the PICMI LWFA's density evaluated with torch) replays
    inside its step's graph.  At most one host sync an exchange period
    (the chunk's read), two with the BTD (its first write at the call's
    start).  The bench, PICMI and boosted LWFA's graphed ms/step, device
    busy, idle share, host launch calls a step and host syncs of an
    exchange period are printed beside the card's name and power
    limit."""
    import torch
    workdir = tempfile.mkdtemp()

    def picmi_sim():
        sim = picmi_lwfa(workdir).sim
        for diag in sim.diags:
            collect_only(diag, [])
        return sim

    none = {"K1": 0, "K2": 0, "K3": 0}
    resident = {"K1": 1, "K2": 1, "K3": 0}
    boosted = {"K1": 0, "K2": 1, "K3": 2}
    # the variants (n_move, full re-sort, exchange block inside): an
    # exchange step is replayed whole, fully re-sorted
    one = [(1, False, False), (1, True, True)]
    two = [(1, False, False), (1, True, True), (2, False, False),
           (2, True, True)]
    # (label, build, launches a step, graph variants, steps, and
    # graph_pair's options)
    paths = (
        ("bench LWFA", make_sim, resident, one, GRAPH_STEPS,
         dict(plant=True)),
        ("boosted LWFA", make_boosted_sim, boosted, two, GRAPH_STEPS_BOOSTED,
         dict(deterministic=True, atomics=True)),
        ("PICMI LWFA", picmi_sim, resident, one, GRAPH_STEPS, {}),
        ("boosted LWFA + BTD",
         lambda: with_btd(make_boosted_sim(), workdir), boosted, two,
         GRAPH_STEPS_BOOSTED, dict(deterministic=True, syncs_max=2)),
        ("antenna LWFA", lambda: make_sim(z_antenna=ANT_Z,
                                          sort_K=ANT_SORT_K),
         resident, one, GRAPH_STEPS, dict(windows=antenna_windows)),
        ("PWFA driver", lambda: make_pwfa_sim()[0], resident, one,
         GRAPH_STEPS, dict(deterministic=True)),
        ("published boosted (ring) + BTD",
         lambda: with_btd(make_boosted_sim(p_zmin_lab=B_P_ZMIN_PUBLISHED),
                          workdir), none, two, GRAPH_STEPS_BOOSTED,
         dict(deterministic=True, syncs_max=2)),
        ("ionization LWFA",
         lambda: make_ionization_sim(target_capacity=GRAPH_ION_CAPACITY)[0],
         {"K1": 2, "K2": 2, "K3": 0}, one, GRAPH_STEPS,
         dict(deterministic=True, plant=True, run_up=GRAPH_ION_RUN_UP,
              probe=(live_of(2), created_in_the_pair("ionization LWFA")))),
        ("Compton PWFA", lambda: make_compton_sim(GRAPH_CMP_CAPACITY)[0],
         resident, one, GRAPH_STEPS,
         dict(deterministic=True,
              probe=(live_of(2), created_in_the_pair("Compton PWFA")))),
        ("ballistic PWFA",
         lambda: make_pwfa_sim(z_injection_plane=BALLISTIC_PLANE)[0],
         resident, one, GRAPH_STEPS_BALLISTIC,
         dict(deterministic=True,
              probe=(behind_the_plane, crossed_the_plane))))
    out = {}
    for label, build, per_step, variants, n_steps, kw in paths:
        out[label] = graph_pair(label, build, per_step, counters, variants,
                                n_steps, **kw)
        torch.cuda.empty_cache()
    for label in ("bench LWFA", "PICMI LWFA", "boosted LWFA"):
        print(graphed_summary(label, out[label]["graphed"], smi), flush=True)
    print(f"graph paths on {smi}", flush=True)
    return out


def graphed_summary(label, m, smi):
    """One line of a graphed path's cost beside the card's name and
    power limit: ms/step, device busy, idle share, host launch calls a
    step and host syncs of an exchange period (graph_pair's or phase
    24's metrics)."""
    prof = m.get("profile") or {}
    busy = prof.get("device_ms_per_step", m.get("device_ms_per_step"))
    calls = prof.get("host_launch_calls_per_step",
                     m.get("host_launch_calls_per_step"))
    syncs = m.get("host_syncs_exchange_period",
                  m.get("host_syncs_step14", {}))
    return (f"graphed {label} on {smi}: {m['ms_per_step']:.4f} ms/step, "
            f"device busy {busy} ms/step, idle share {m.get('idle_share')}, "
            f"{calls} host launch calls a step, {syncs.get('count')} host "
            f"syncs a step(14)")


def phase_resident_mesh_f64(counters, devices=None):
    """25. tests/test_resident.py's resident mesh in float64 (4 slabs,
    n_guard 24, exchange period 4, 40 steps) on the card (the slabs'
    chunk runner: one CUDA graph a variant for the four slabs) and on
    the card machine's CPU (its body in the slab threads), the same
    injection angles: two K3 and one K2 launch per slab per step (on
    the card counted on the replays); the same live slots; every field and the live
    particles within TOL_MESH_F64 of their vector's scale (a component
    that is roundoff here, as Bz, is held to its vector's scale; a stale
    guard cell, from a missing stream dependency in an exchange, would
    be off by far more), rho_prev (a scatter deposit) within
    TOL_ATOMIC_RHO.  The same configuration on one device, card against
    CPU, is printed beside it (the control).  ``devices``: the slabs'
    cards (one a slab: the chunks replayed from one graph a card, the
    cross-card exchanges inside), and then K3 is also held against its
    plain version on each slab's own operands (its J window, captured
    in one more step) and timed; by default all four share cuda:0."""
    import torch
    label = "resident mesh, float64"
    for fn in counters.values():
        fn.launches = 0
        fn.launches_by_slab = {}
    t0 = time.perf_counter()
    card = resident_mesh_run("cuda:0", devices=devices)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    by_slab = {k: dict(counters[k].launches_by_slab)
               for k in ("K1", "K2", "K3")}
    variants = sorted(card.runner.graphs)
    if devices:
        label = f"{label} on {devices}"
    print(f"{label}: the slabs' chunk runner on the card: graph variants "
          f"{variants}, graph_blockers {card.graph_blockers}", flush=True)
    if not variants:
        raise RuntimeError(f"{label}: the card's slabs captured no graph")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        t0 = time.perf_counter()
        cpu = resident_mesh_run("cpu")
        t_cpu = time.perf_counter() - t0
        one_card = resident_mesh_run("cuda:0", 0)
        one_cpu = resident_mesh_run("cpu", 0)
    finally:
        torch.set_num_threads(n_threads)
    n = MC64_STEPS
    want = {"K1": {}, "K2": {r: n for r in range(MC64_SLABS)},
            "K3": {r: 2 * n for r in range(MC64_SLABS)}}
    mesh, mesh_own = family_deviations(cpu.states, card.states)
    control, control_own = family_deviations([one_cpu.state],
                                             [one_card.state])
    print(f"{label}: {n} steps on {MC64_SLABS} slabs, card {t_card:.2f} s, "
          f"CPU {t_cpu:.2f} s; launches per slab {by_slab}; card against "
          f"CPU, relative to each family's scale: {mesh}; the single "
          f"device (control): {control}", flush=True)
    print(f"{label}: per component, card against CPU relative to the "
          f"component's own scale, and its share of the family's scale "
          f"(mesh / single-device control):", flush=True)
    for k, v in mesh_own.items():
        c = control_own[k]
        print(f"  {k}: own {v['own']:.3e} / {c['own']:.3e}, share "
              f"{v['share']:.3e} / {c['share']:.3e}", flush=True)
    if by_slab != want:
        raise RuntimeError(f"{label}: launches per slab {by_slab}")
    off = {k: v for k, v in mesh.items()
           if v >= (TOL_ATOMIC_RHO if k == "rho_prev" else TOL_MESH_F64)}
    off.update({k: v for k, v in mesh_own.items()
                if not k.startswith("rho_prev")
                and v["share"] > MESH_OWN_SHARE
                and v["own"] >= TOL_MESH_F64})
    if off:
        raise RuntimeError(f"{label}: card against CPU off: {off} "
                           f"(control {control})")
    if lost(card.overflow_totals):
        raise RuntimeError(f"{label}: overflow {card.overflow_totals}")
    k3_slabs = {}
    if devices:
        from fbpic_tpu_torch.particles import sorted_deposit
        calls = capture_slab_calls(
            card, ((sorted_deposit, "dense_onehot_contract"),),
            first_only=True)["dense_onehot_contract"]
        for r, device in enumerate(card.devices):
            with torch.cuda.device(device):
                m = measure_k3(calls[r][0], f"J window, {label}, slab {r}",
                               True)
            bound_ms, bound_by = bound(m["n_bytes"], m["n_flops"],
                                       m["flop_rate"])
            k3_slabs[r] = dict(m, bound_ms=bound_ms, bound_by=bound_by)
        del calls
    card.runner.release()
    del card, cpu, one_card, one_cpu
    torch.cuda.empty_cache()
    return {k: sum(v.values()) for k, v in by_slab.items()}, dict(
        k3_slabs=k3_slabs,
        deviations=mesh, control=control, components=mesh_own,
        control_components=control_own, card_s=t_card, cpu_s=t_cpu,
        launches_by_slab=by_slab, graph_variants=[list(v)
                                                  for v in variants])

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

    import tempfile
    with tempfile.TemporaryDirectory() as workdir:
        lwfa_launches, lwfa_script = phase_lwfa_script(
            counters, main_metrics["ms_per_step"], workdir)
        k1["launches_lwfa_script"] = lwfa_launches["K1"]
        k2["launches_lwfa_script"] = lwfa_launches["K2"]
        torch.cuda.empty_cache()
        diag_card_vs_cpu = phase_diag_card_vs_cpu(workdir)
        btd_launches, boosted_btd = phase_boosted_btd(counters, workdir)
        k2["launches_boosted_btd"] = btd_launches["K2"]
        k3["launches_boosted_btd"] = btd_launches["K3"]
        torch.cuda.empty_cache()

    cubic_launches, cubic_pml, syncs["bench LWFA cubic + PML"] = \
        phase_cubic_pml(counters)
    (cross_launches, cross_metrics, syncs["bench LWFA cross-deposition"],
     k3["cross_deposition"]) = phase_cross_deposition(counters)
    k3["launches_cross_deposition"] = cross_launches["K3"]
    physics_gates = phase_physics_gates(counters)
    (pwfa_launches, pwfa_metrics, syncs["PWFA drive bunch"], k1["resident_pwfa"],
     k2["resident"]["PWFA"]) = phase_pwfa(counters)
    k1["launches_pwfa"] = pwfa_launches["K1"]
    k2["launches_pwfa"] = pwfa_launches["K2"]
    ant_launches, ant_metrics, syncs["antenna LWFA"] = phase_antenna_lwfa(
        counters, syncs["bench LWFA"])
    k1["launches_antenna"] = ant_launches["K1"]
    k2["launches_antenna"] = ant_launches["K2"]
    lpa_gates = phase_lpa_gates()
    (ion_launches, ion_metrics, syncs["ionization LWFA"],
     k1["ionization"], k2["resident"]["ionization"]) = \
        phase_ionization_lwfa(counters)
    k1["launches_ionization"] = ion_launches["K1"]
    k2["launches_ionization"] = ion_launches["K2"]
    (cmp_launches, cmp_metrics, syncs["Compton PWFA"],
     k1["resident_compton"]) = phase_compton_pwfa(counters)
    k1["launches_compton"] = cmp_launches["K1"]
    k2["launches_compton"] = cmp_launches["K2"]
    process_gates = phase_process_gates()
    (picmi_launches, picmi_metrics, syncs["PICMI LWFA step(14)"],
     k1["resident_picmi"], k2["resident"]["PICMI"]) = \
        phase_picmi_lwfa(counters)
    k1["launches_picmi"] = picmi_launches["K1"]
    k2["launches_picmi"] = picmi_launches["K2"]
    ref_launches, reference_script = phase_reference_script(counters)
    k1["launches_reference_script"] = ref_launches["K1"]
    k2["launches_reference_script"] = ref_launches["K2"]
    golden_launches, golden_f64 = phase_golden_f64(counters)
    k2["launches_golden_f64"] = golden_launches["K2"]
    k3["launches_golden_f64"] = golden_launches["K3"]
    mc_launches, multichip = phase_multichip_lwfa(counters)
    print(graphed_summary(f"{MC_SLABS}-slab multichip LWFA",
                          multichip["slabs"], smi), flush=True)
    k1["launches_multichip"] = mc_launches["K1"]
    k2["launches_multichip"] = mc_launches["K2"]
    k1["multichip_slabs"] = multichip.pop("k1_slabs")
    k2["multichip_slabs"] = multichip.pop("k2_slabs")
    mesh64_launches, mesh_f64 = phase_resident_mesh_f64(counters)
    k2["launches_mesh_f64"] = mesh64_launches["K2"]
    k3["launches_mesh_f64"] = mesh64_launches["K3"]
    graph_paths = phase_graph_paths(counters, smi)
    k1["launches_graphed"] = {k: v["launches"]["K1"]
                              for k, v in graph_paths.items()}
    k2["launches_graphed"] = {k: v["launches"]["K2"]
                              for k, v in graph_paths.items()}
    k3["launches_graphed"] = {k: v["launches"]["K3"]
                              for k, v in graph_paths.items()}

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
                      "lwfa_script": lwfa_script,
                      "diag_card_vs_cpu": diag_card_vs_cpu,
                      "boosted_btd": boosted_btd,
                      "cubic_pml_path": dict(cubic_pml,
                                             launches=cubic_launches),
                      "cross_deposition_path": dict(
                          cross_metrics, launches=cross_launches),
                      "physics_gates": physics_gates,
                      "pwfa_path": dict(pwfa_metrics, launches=pwfa_launches),
                      "antenna_lwfa_path": dict(ant_metrics,
                                                launches=ant_launches),
                      "lpa_gates": lpa_gates,
                      "ionization_lwfa_path": dict(ion_metrics,
                                                   launches=ion_launches),
                      "compton_pwfa_path": dict(cmp_metrics,
                                                launches=cmp_launches),
                      "process_gates": process_gates,
                      "picmi_lwfa_path": dict(picmi_metrics,
                                              launches=picmi_launches),
                      "reference_script": dict(reference_script,
                                               launches=ref_launches),
                      "golden_f64": dict(golden_f64,
                                         launches=golden_launches),
                      "multichip_lwfa": dict(multichip,
                                             launches=mc_launches),
                      "resident_mesh_f64": dict(mesh_f64,
                                                launches=mesh64_launches),
                      "graph_paths": graph_paths,
                      "seconds": time.perf_counter() - t_start},
                     default=float))
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_cards(n_cards):
    """``--cards N``: the multichip LWFA at full width on N slabs, one a
    card (phase 24's gates and numbers, beside the same slabs on one
    card, graphed), and the float64 resident mesh on the N cards
    against the CPU (phase 25), K3 on each slab's operands.  Fails when
    fewer than N cards are visible."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device: "
                           "torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n_cards:
        raise RuntimeError(f"--cards {n_cards}: only "
                           f"{torch.cuda.device_count()} card(s) visible")
    from fbpic_tpu_torch.utils import kernels
    from fbpic_tpu_torch.parallel import peer
    from fbpic_tpu_torch.particles.cuda_dense import dense_onehot_contract
    from fbpic_tpu_torch.particles.cuda_fused import fused_onehot_contract
    from fbpic_tpu_torch.particles.cuda_gather import gather_sorted
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"{n_cards} cards of {torch.cuda.device_count()}:\n{smi}",
          flush=True)
    t_start = t0 = time.perf_counter()
    kernels.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    counters = {"K1": fused_onehot_contract, "K2": gather_sorted,
                "K3": dense_onehot_contract, "copy": peer.copy_parts}
    devices = [f"cuda:{i}" for i in range(n_cards)]
    mc_launches, multichip = phase_multichip_lwfa(
        counters, n_slabs=n_cards, devices=devices, one_card=True)
    card = f"{n_cards} x {smi.splitlines()[0]}"
    print(graphed_summary(f"{n_cards}-slab multichip LWFA on {n_cards} "
                          f"cards", multichip["slabs"], card), flush=True)
    print(graphed_summary(f"{n_cards}-slab multichip LWFA on one card",
                          multichip["slabs on one card"], card), flush=True)
    mesh_launches, mesh = phase_resident_mesh_f64(counters, devices=devices)
    k1_slabs = multichip.pop("k1_slabs")
    k2_slabs = multichip.pop("k2_slabs")
    k3_slabs = mesh.pop("k3_slabs")
    copy = multichip.pop("copy")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def fullest(slabs):
        """The numbers of the slab with the most live slots."""
        return slabs[max(slabs, key=lambda r: slabs[r]["live_fraction"])]
    k1 = dict(name="K1 fused J+drho deposit", route="cuda",
              source="fbpic_tpu_torch/csrc/fused_deposit.cu",
              replaces="fbpic_tpu/particles/pallas_fused.py:78",
              launches=mc_launches["K1"], per_slab=k1_slabs,
              **{k: fullest(k1_slabs).get(k) for k in keys})
    k2 = dict(name="K2 sorted field gather", route="cuda",
              source="fbpic_tpu_torch/csrc/gather.cu",
              replaces="fbpic_tpu/particles/pallas_gather.py:80",
              launches=mc_launches["K2"], per_slab=k2_slabs,
              **{k: fullest(k2_slabs).get(k) for k in keys})
    k3 = dict(name="K3 one-hot J / rho deposit", route="cuda",
              source="fbpic_tpu_torch/csrc/dense_deposit.cu",
              replaces="fbpic_tpu/particles/pallas_deposit.py:78",
              launches=mesh_launches["K3"], per_slab=k3_slabs,
              **{k: fullest(k3_slabs).get(k) for k in keys})
    cp = dict(name="cross-card exchange copy", route="cuda",
              source="fbpic_tpu_torch/csrc/peer.cu",
              replaces="fbpic_tpu/parallel/domain.py:58 (ppermute, an XLA "
                       "collective, not a Pallas kernel)",
              launches=mc_launches["copy"],
              **{k: copy[k] for k in keys})
    print(json.dumps({"multichip_lwfa_cards": dict(multichip,
                                                   launches=mc_launches),
                      "resident_mesh_f64_cards": dict(
                          mesh, launches=mesh_launches),
                      "seconds": time.perf_counter() - t_start},
                     default=float))
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3, cp]}, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--cards" in sys.argv[1:]:
        sys.exit(main_cards(int(sys.argv[sys.argv.index("--cards") + 1])))
    sys.exit(main())
