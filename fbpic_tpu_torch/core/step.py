"""The PIC cycle, one eager step at a time.

One step (momenta one half-step behind positions at cycle boundaries,
as in the reference, FBPIC's fbpic/main.py:346-585):

    [exchange: remove, inject, deposit rho_prev]
    -> resident species: re-sort (banded, or full) -> sorted gather E,B
       (K2) -> Vay push p -> push x (dt/2) -> [Compton, ionization]
       -> fused J + d(rho) deposit (K1), or J and rho deposits (K3)
       -> push x (dt/2)
    -> other species: linear gather E,B -> Vay push p -> push x (dt/2)
       -> [Compton, ionization; the newborns to their targets]
       -> [sort_K > 0: column sort, fused deposits (K1 / K3)]
       -> J (scatter, or the legacy sorted plan: K3) -> push x (dt/2)
    -> rho_next -> correct currents -> PSATD push
    -> Galilean drift + moving-window shift -> spect2interp E,B
    -> open-z damping and mirrors

The user's external fields are applied after every gather; a ballistic
species keeps its momenta behind its injection plane; the laser
antennas add their current slice to the grid J before the transform.

The elementary processes (ADK ionization, Compton scattering) run at
t = (n+1/2) dt, between the first half push and the deposits.  An
ionizable species carries an int32 ``ionization_level``: its charge is
level * q in the push, and every deposit weighs it by w * level (a new
tensor: the kernels read the weight channel as they read w).  The
particles a process creates leave it in a fixed-size creation buffer
(w = 0 past them) and go to their target species: a ring takes them at
its cursor (``append_new_particles``), a resident species in dead slots
of their own z rows (``append_into_padded``), its birth-step J and rho /
d(rho) scatter-deposited onto its fused grids.  The counts created stay
on the device: a target's cursor and id counter are 0-d device tensors,
and what finds no room is counted into ring_overwrite / sort_overflow,
which grow the target after the step() call.  The uniform draws come
from a replaceable source (particles/draws.py).

Cubic species gather with the 4x4 stencil (gather_fields_cubic) and,
sorted, deposit through deposit_rho_J_sorted_cubic (plain PyTorch: no
kernel); tracers are pushed and deposit nothing.  With the radial PML
(boundaries r = 'open') the split fields are pushed with E/B and damped
on the interpolation grid, one more E/B round trip a step; with
cross-deposition the correction uses the charge deposited at two mixed
positions between the half pushes (_cross_deposit), and the exchange
block runs every step.

float32 runs of the standard scheme deposit the per-particle d(rho) the
current correction needs (K1; species without the fused deposit
difference two scatter deposits instead); float64 runs and the Galilean
/ comoving scheme deposit J and rho_next (K3 on sorted species).  In the
Galilean frame the grid flows at v_comoving: its left edge is zmin at
the gather, zmin + vg*dt/2 at the J deposit and zmin + vg*dt at
rho_next.

Resident species (the fused deposit on, sort_K > 0, capacity Nz *
sort_K) live in the flattened (Nz, K) column-sort layout: the step
re-sorts them once at its start and gathers, pushes and deposits in
padded form.  Every other species keeps a stable storage order (a ring,
into which continuous injection writes at a cursor); with sort_K > 0 it
is column-sorted afresh after its first half push for the sorted
deposits.  The data-dependent branches of fbpic_tpu's jitted step run
on the host: the exchange cadence, the window's shift and the injected
column count depend on the host's own scalars (``plan_step``), and the
banded re-sort's fallback to the full sort reads the overflow count back
(one device-to-host sync), unless the caller passes a ``redo_flag``:
then the count is added into that device flag and the caller redoes the
step (core/graph.py, whose CUDA graphs of the step also take the step's
scalars from the device, ``StepScalars``).
"""
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..constants import c
from ..fields import transform as tr
from ..fields import psatd_push as ps
from ..particles import push as pp
from ..particles.deposit import (
    deposit_rho_linear, deposit_J_linear, deposit_rho_cubic, deposit_J_cubic,
)
from ..particles.gather import (
    gather_fields_linear, gather_fields_cubic, gather_fields_sorted,
)
from ..particles.injection import generate_columns, write_ring
from ..particles.ionization import ionize, select_level_electrons
from ..particles.compton import handle_compton
from ..particles.state import ARRAY_FIELDS
from ..particles.sorted_deposit import (
    build_column_sort, banded_column_resort, deposit_rho_J_sorted,
    deposit_rho_sorted, deposit_J_sorted, deposit_rho_J_sorted_cubic,
)
from ..fields.solver import SPECT_PML_FIELDS, INTERP_PML_FIELDS
from ..lpa_utils.laser.antenna_injection import (
    add_antenna_current, add_antenna_current_device,
)
from .state import SimState


@dataclass(frozen=True)
class StepOptions:
    """Static options of the PIC cycle."""
    correct_currents: bool = True
    correct_divE: bool = False
    use_true_rho: bool = False
    filter_currents: bool = True
    move_positions: bool = True
    move_momenta: bool = True
    # rmax beyond which particles no longer gather fields
    rmax_gather: float = float("inf")
    # Moving window speed (None = no moving window)
    moving_window_v: object = None
    # Per-species (InjectorConfig | None) for continuous injection
    injectors: tuple = ()
    # Particle removal / injection / fresh rho_prev deposit happen every
    # `exchange_period` steps; in between rho_prev is the window-shifted
    # previous rho_next
    exchange_period: int = 1
    # Sorted deposits: the resident layout, and the fused deposit of the
    # other sort_K species (off: the legacy sorted plan or the scatter)
    fused_deposit: bool = False
    # False forces exchange_period = 1 (a fresh rho_prev every step)
    reuse_rho_prev: bool = True
    # ExternalField objects (applied to the gathered per-particle fields)
    external_fields: tuple = ()
    # Mirror objects (zero E/B in thin z-slabs each step)
    mirrors: tuple = ()


@dataclass(frozen=True)
class StepScalars:
    """The scalars of one step as 0-d tensors of the working dtype on the
    step's device (a row of core/graph.py's per-chunk tables): the grid's
    left edge at the gather and re-sort (``zmin``), at the J deposit
    (``zmin_mid``), at rho_next (``zmin_next``) and after the step
    (``zmin_end``: the mirrors' cells), the step's ``time`` and the
    moving window's reference ``mw_zref``; each mirror's zeroed interval
    (``mirrors``: (z_lo, z_hi) a mirror, ``mirror_planes``) and each
    laser antenna's slice (``antennas``: ``antenna_cells``' values, the
    indices as int64 tensors); the elementary processes' time t + dt/2
    (``time_mid``, ``process_time``) and each species' ballistic
    injection plane (``planes``: a 0-d tensor per species, None where it
    has none, ``ballistic_plane``; empty: the host's planes); the
    exchange block's values (``exchange``: an ``ExchangePlan`` of 0-d
    tensors, ``plan_exchange``'s values, the column counts int64; None
    on a step without it).  Given to
    the step, every torch op and kernel of the step reads them from
    there, so that a captured step reads each replay's values.  Their
    values are the host's (``plan_step``, ``mirror_planes``,
    ``antenna_cells``, ``process_time``, ``ballistic_plane``,
    ``plan_exchange``), rounded
    to the working dtype as a torch op rounds the host number: the step
    is the same bit for bit either way."""
    zmin: torch.Tensor
    zmin_mid: torch.Tensor
    zmin_next: torch.Tensor
    time: torch.Tensor
    mw_zref: torch.Tensor
    zmin_end: torch.Tensor = None
    mirrors: tuple = ()
    antennas: tuple = ()
    time_mid: torch.Tensor = None
    planes: tuple = ()
    exchange: object = None


@dataclass(frozen=True)
class ExchangePlan:
    """The values of one exchange block (``plan_exchange``): the removal
    bounds and the dead particles' parking place (``removal``: z_lo,
    z_hi, z_park), each injecting species' columns (``injection``: per
    species None, or (n_cols, z_end, z_lo): the count of columns, the
    first column's start, the lower bound of the ring's overwrite
    count), on a slab the injection's ownership bounds
    (``inject_bounds``: lo, hi) and the migration's (``migration``:
    z_lo, z_hi, the slab's own interior).  Host numbers of the working
    dtype (the column counts ints) from ``plan_exchange``, with
    ``z_end_after`` (each injecting species' next column start, a host
    value the host keeps), or 0-d tensors of a table row
    (``StepScalars.exchange``)."""
    removal: tuple
    injection: tuple = ()
    inject_bounds: tuple = None
    migration: tuple = None
    z_end_after: tuple = ()


@dataclass(frozen=True)
class StepPlan:
    """What the host decides for one step from its own scalars: whether
    the exchange block runs (open z, every exchange period), whether the
    banded species are fully re-sorted, the window's shift ``n_move``;
    the grid edges of the step's deposits, and the step's end values of
    zmin, mw_zref and time (numpy scalars of the working dtype: the
    host's arithmetic, with fbpic_tpu's rounding)."""
    exchange: bool
    full_resort: bool
    n_move: int
    zmin_mid: object
    zmin_next: object
    zmin_end: object
    mw_zref_end: object
    time_end: object


def plan_step(config, options, zmin, zmin_g, mw_zref, time, iteration):
    """The host's plan of the step at ``iteration`` from the grid's left
    edge (``zmin_g``: the global grid's, which a slab's differs from),
    the window's reference and the time (fbpic_tpu core/step.py:942-956
    and :1656-1700): in the Galilean frame the grid edge flows vg*dt a
    step, deposits seeing it at their own time; the window then shifts
    by the excess of its reference over the drifted edge."""
    rdt = type(zmin)
    # fbpic_tpu forces a fresh rho_prev every step under cross-deposition
    # or without reuse_rho_prev
    ep = (max(1, options.exchange_period)
          if options.reuse_rho_prev and config.current_correction
          != "cross-deposition" else 1)
    do_exchange = iteration % ep == 0
    open_z = config.boundaries_z == "open"
    vg_dt = config.v_galilean * config.dt
    zmin_end = zmin + vg_dt
    n_move = 0
    if options.moving_window_v is not None:
        mw_zref = mw_zref + options.moving_window_v * config.dt
        # 1e-3-cell guard: with v = c and dt = dz/c the argument lands on
        # integers (see fbpic_tpu core/step.py)
        n_move = int(np.floor((mw_zref - (zmin_g + vg_dt)) / config.dz
                              + 1e-3))
        zmin_end = zmin_end + rdt(n_move) * config.dz
    return StepPlan(
        exchange=open_z and do_exchange,
        # open z: the exchange block rewrote the storage order; periodic:
        # the re-anchor covers the initial order and host-side edits
        full_resort=do_exchange if open_z else iteration % 64 == 0,
        n_move=n_move, zmin_mid=zmin + 0.5 * vg_dt, zmin_next=zmin + vg_dt,
        zmin_end=zmin_end, mw_zref_end=mw_zref,
        time_end=time + config.dt)


def injection_columns(config, options, inj_cfg, z_end, zmin,
                      grid_globals=None):
    """The host's columns of one species' continuous injection at grid
    edge ``zmin`` (the slab's local edge on a slab, ``grid_globals``:
    zmin, Nz, n_guard, n_inject of the global box): (n_cols, z_lo,
    z_end_after), the count of columns the window uncovered since
    ``z_end`` (a host int), the lower bound of the ring's overwrite
    count and the next column start (host values of the working
    dtype)."""
    rdt = type(zmin)
    if grid_globals is not None:
        zmin_g, Nz_g, n_guard_g, n_inject_g = grid_globals
    else:
        zmin_g, Nz_g = zmin, config.Nz
        n_guard_g, n_inject_g = config.n_guard, config.n_inject
    # The plane's offset from zmin summed first, as XLA folds fbpic_tpu's
    # constant terms (the plane sits on a column edge: rounding picks
    # the column count)
    z_inject = zmin_g + ((rdt((Nz_g - n_guard_g) * config.dz)
                          + rdt((3 - n_inject_g) * config.dz))
                         + rdt(config.dt * (options.moving_window_v
                                            - inj_cfg.v_end_plasma)))
    # times the reciprocal, as XLA computes a division by a constant
    n_cols = int(np.clip(np.floor((z_inject - z_end)
                                  * (rdt(1.0) / rdt(inj_cfg.dz_particles))),
                         0, inj_cfg.max_inject_cols))
    z_lo = zmin + max(config.n_guard, 1) * config.dz
    z_end_after = z_end + type(z_end)(n_cols) * inj_cfg.dz_particles
    return n_cols, z_lo, z_end_after


def plan_exchange(config, options, z_ends, zmin, halo=None,
                  migrate=False):
    """The host's values of the exchange block at grid edge ``zmin`` (a
    slab's local edge on a slab, ``halo``), every species' injection
    front ``z_ends`` (``inj_z_end``, None where it injects nothing):
    an ``ExchangePlan`` of host values of the working dtype, the
    arithmetic the eager block has always done (the removal bounds
    of the box, or of the global box on a slab; each injecting species'
    ``injection_columns``; on a slab the injection's ownership bounds
    and, with ``migrate``, the migration's)."""
    Lz = config.Nz * config.dz
    if halo is not None:
        z_lo, z_hi = halo.removal_bounds(halo.global_zmin(zmin))
    else:
        ng = max(config.n_guard, 1)
        z_lo = zmin + ng * config.dz
        z_hi = zmin + Lz - ng * config.dz
    injection, after = [None] * len(z_ends), [None] * len(z_ends)
    if options.moving_window_v is not None:
        gg = (None if halo is None
              else halo.grid_globals(halo.global_zmin(zmin)))
        for i, inj_cfg in enumerate(options.injectors):
            if inj_cfg is None:
                continue
            n_cols, inj_lo, after[i] = injection_columns(
                config, options, inj_cfg, z_ends[i], zmin, gg)
            injection[i] = (n_cols, z_ends[i], inj_lo)
    migration = None
    if halo is not None and migrate:
        rdt, g = type(zmin), config.n_guard
        migration = (zmin + rdt(g * config.dz),
                     zmin + rdt((config.Nz - g) * config.dz))
    return ExchangePlan(
        removal=(z_lo, z_hi, zmin + 0.5 * Lz), injection=tuple(injection),
        inject_bounds=None if halo is None else halo.ownership_bounds(zmin),
        migration=migration, z_end_after=tuple(after))


def _zfold(config):
    return "periodic" if config.boundaries_z == "periodic" else "clamp"


def _comp_of(sp):
    """(comp_x, comp_y, comp_z) tuple or None (float64 runs)."""
    if sp.comp_x is None:
        return None
    return (sp.comp_x, sp.comp_y, sp.comp_z)


def _scalar(v):
    """A grid edge as the deposits and gathers take it: a 0-d tensor
    (StepScalars) as it is, a host number as a float (the same bits in
    a torch op of the working dtype)."""
    return v if torch.is_tensor(v) else float(v)


def _deposit_args(config, zmin):
    return (config.Nm, 1.0 / config.dz, _scalar(zmin), config.Nz,
            1.0 / config.dr, 0.0, config.Nr)


def deposit_rho_spect(config, aux, species, species_configs, zmin,
                      sorts=None, fused=None):
    """Charge of all species but tracers -> filtered-free spectral rho
    (Nm, Nz, Nr), summed in species order (an ionizable species weighted
    by its levels).

    fused: optional {species_index: raw rho} from the fused sorted
    deposits; sorts: optional {species_index: legacy column-sort plan}
    for deposit_rho_sorted; every other species is scatter-deposited
    with its shape."""
    rho = None
    for i, (sp, sc) in enumerate(zip(species, species_configs)):
        if sc.is_tracer:
            continue
        if fused and i in fused:
            contrib = fused[i]
        elif sorts and i in sorts:
            contrib = deposit_rho_sorted(
                sorts[i], sp.x, sp.y, sp.z, sp.w_eff, sc.q,
                *_deposit_args(config, zmin), aux.ruyten_linear,
                zfold=_zfold(config))
        elif sc.particle_shape == "cubic":
            contrib = deposit_rho_cubic(
                sp.x, sp.y, sp.z, sp.w_eff, sc.q,
                *_deposit_args(config, zmin), aux.ruyten_cubic,
                zfold=_zfold(config), comp=_comp_of(sp))
        else:
            contrib = deposit_rho_linear(
                sp.x, sp.y, sp.z, sp.w_eff, sc.q,
                *_deposit_args(config, zmin), aux.ruyten_linear,
                zfold=_zfold(config), comp=_comp_of(sp))
        rho = contrib if rho is None else rho + contrib
    if rho is None:
        rho = torch.zeros((config.Nm, config.Nz, config.Nr),
                          dtype=aux.S_w.dtype, device=aux.S_w.device)
        rho = torch.complex(rho, rho)
    return tr.interp2spect_scal(aux.mats, rho * aux.invvol[:, None, :])


def deposit_J_spect(config, aux, species, species_configs, zmin,
                    antenna_series=(), iteration=None, sorts=None,
                    fused=None, antenna_bounds=None, antenna_cells=None):
    """Current of all species -> spectral (Jp, Jm, Jz), summed in
    species order (fused / sorts / scatter as in deposit_rho_spect).

    antenna_series: the laser antennas' current blocks
    (lpa_utils/laser/antenna_injection.py), whose slice of the host
    ``iteration`` is added onto the grid before the transform (and so
    before the filter), as fbpic_tpu does; ``antenna_bounds`` (a slab's
    owned z interval) keeps an antenna plane outside it off this grid.
    ``antenna_cells``: each antenna's slice, cells and weights as device
    tensors (StepScalars.antennas), read instead of the host's (zmin
    is then a 0-d tensor)."""
    JrJtJz = None
    for i, (sp, sc) in enumerate(zip(species, species_configs)):
        if sc.is_tracer:
            continue
        if fused and i in fused:
            contrib = fused[i]
        elif sorts and i in sorts:
            contrib = deposit_J_sorted(
                sorts[i], sp.x, sp.y, sp.z, sp.w_eff, sc.q, sp.ux, sp.uy,
                sp.uz, sp.inv_gamma, *_deposit_args(config, zmin),
                aux.ruyten_linear, zfold=_zfold(config))
        elif sc.particle_shape == "cubic":
            contrib = deposit_J_cubic(
                sp.x, sp.y, sp.z, sp.w_eff, sc.q, sp.ux, sp.uy, sp.uz,
                sp.inv_gamma, *_deposit_args(config, zmin),
                aux.ruyten_cubic, zfold=_zfold(config), comp=_comp_of(sp))
        else:
            contrib = deposit_J_linear(
                sp.x, sp.y, sp.z, sp.w_eff, sc.q, sp.ux, sp.uy, sp.uz,
                sp.inv_gamma, *_deposit_args(config, zmin),
                aux.ruyten_linear, zfold=_zfold(config), comp=_comp_of(sp))
        JrJtJz = (list(contrib) if JrJtJz is None
                  else [a + b for a, b in zip(JrJtJz, contrib)])
    if JrJtJz is None:
        z = torch.zeros((config.Nm, config.Nz, config.Nr),
                        dtype=aux.S_w.dtype, device=aux.S_w.device)
        JrJtJz = [torch.complex(z, z)] * 3
    Jr, Jt, Jz = [a * aux.invvol[:, None, :] for a in JrJtJz]
    for k, series in enumerate(antenna_series):
        if antenna_cells is not None:
            Jr, Jt = add_antenna_current_device(Jr, Jt, series,
                                                antenna_cells[k])
        else:
            Jr, Jt = add_antenna_current(Jr, Jt, series, iteration, zmin,
                                         config.dz, config.Nz,
                                         own_bounds=antenna_bounds)
    return tr.interp2spect_J_fields(aux.mats, Jr, Jt, Jz)


def push_fields(config, aux, spect, use_true_rho):
    """PSATD E/B advance (and the PML split fields) + rho_prev <-
    rho_next."""
    pml = {}
    if config.use_comoving:
        if config.use_pml:
            pml = dict(zip(SPECT_PML_FIELDS, ps.push_eb_pml_comoving(
                spect.Ep_pml, spect.Em_pml, spect.Bp_pml, spect.Bm_pml,
                spect.Ez, spect.Bz, aux.C, aux.S_w, aux.T_eb, aux.kr,
                aux.kz)))
        Ep, Em, Ez, Bp, Bm, Bz = ps.push_eb_comoving(
            spect.Ep, spect.Em, spect.Ez, spect.Bp, spect.Bm, spect.Bz,
            spect.Jp, spect.Jm, spect.Jz, spect.rho_prev, spect.rho_next,
            aux.rho_prev_coef, aux.rho_next_coef, aux.j_coef,
            aux.C, aux.S_w, aux.T_eb, aux.T_cc, aux.T_rho,
            aux.kr, aux.kz, config.dt, config.v_comoving,
            use_true_rho=use_true_rho)
    else:
        if config.use_pml:
            pml = dict(zip(SPECT_PML_FIELDS, ps.push_eb_pml_standard(
                spect.Ep_pml, spect.Em_pml, spect.Bp_pml, spect.Bm_pml,
                spect.Ez, spect.Bz, aux.C, aux.S_w, aux.kr, aux.kz)))
        Ep, Em, Ez, Bp, Bm, Bz = ps.push_eb_standard(
            spect.Ep, spect.Em, spect.Ez, spect.Bp, spect.Bm, spect.Bz,
            spect.Jp, spect.Jm, spect.Jz, spect.rho_prev, spect.rho_next,
            aux.rho_prev_coef, aux.rho_next_coef, aux.j_coef,
            aux.C, aux.S_w, aux.kr, aux.kz, config.dt,
            use_true_rho=use_true_rho)
    return replace(spect, Ep=Ep, Em=Em, Ez=Ez, Bp=Bp, Bm=Bm, Bz=Bz,
                   rho_prev=spect.rho_next,
                   rho_next=torch.zeros_like(spect.rho_next), **pml)


def correct_currents(config, aux, spect, drho=None):
    """Curl-free or cross-deposition current correction.  `drho`: the
    directly-deposited rho_next - rho_prev (float32 runs, curl-free)."""
    inv_dt = 1.0 / config.dt
    if config.current_correction == "curl-free":
        if config.use_comoving:
            Jp, Jm, Jz = ps.correct_currents_curlfree_comoving(
                spect.rho_prev, spect.rho_next, spect.Jp, spect.Jm, spect.Jz,
                aux.kz, aux.kr, aux.inv_k2, aux.j_corr_coef, aux.T_eb,
                aux.T_cc, inv_dt)
        else:
            Jp, Jm, Jz = ps.correct_currents_curlfree_standard(
                spect.rho_prev, spect.rho_next, spect.Jp, spect.Jm, spect.Jz,
                aux.kz, aux.kr, aux.inv_k2, inv_dt, drho=drho)
    elif config.current_correction == "cross-deposition":
        if config.use_comoving:
            Jp, Jm, Jz = ps.correct_currents_crossdeposition_comoving(
                spect.rho_prev, spect.rho_next, spect.rho_next_z,
                spect.rho_next_xy, spect.Jp, spect.Jm, spect.Jz,
                aux.kz, aux.kr, aux.j_corr_coef, aux.T_eb, aux.T_cc, inv_dt)
        else:
            Jp, Jm, Jz = ps.correct_currents_crossdeposition_standard(
                spect.rho_prev, spect.rho_next, spect.rho_next_z,
                spect.rho_next_xy, spect.Jp, spect.Jm, spect.Jz,
                aux.kz, aux.kr, inv_dt)
    else:
        raise ValueError(config.current_correction)
    return replace(spect, Jp=Jp, Jm=Jm, Jz=Jz)


def spect2interp_EB(aux, spect, interp, use_pml=False):
    Er, Et, Ez, Br, Bt, Bz = tr.spect2interp_EB_fields(
        aux.mats, spect.Ep, spect.Em, spect.Ez, spect.Bp, spect.Bm, spect.Bz)
    pml = {}
    if use_pml:
        pml["Er_pml"], pml["Et_pml"] = tr.spect2interp_vect(
            aux.mats, spect.Ep_pml, spect.Em_pml)
        pml["Br_pml"], pml["Bt_pml"] = tr.spect2interp_vect(
            aux.mats, spect.Bp_pml, spect.Bm_pml)
    return replace(interp, Er=Er, Et=Et, Ez=Ez, Br=Br, Bt=Bt, Bz=Bz, **pml)


def interp2spect_EB(aux, interp, spect, use_pml=False):
    Ep, Em, Ez, Bp, Bm, Bz = tr.interp2spect_EB_fields(
        aux.mats, interp.Er, interp.Et, interp.Ez,
        interp.Br, interp.Bt, interp.Bz)
    pml = {}
    if use_pml:
        pml["Ep_pml"], pml["Em_pml"] = tr.interp2spect_vect(
            aux.mats, interp.Er_pml, interp.Et_pml)
        pml["Bp_pml"], pml["Bm_pml"] = tr.interp2spect_vect(
            aux.mats, interp.Br_pml, interp.Bt_pml)
    return replace(spect, Ep=Ep, Em=Em, Ez=Ez, Bp=Bp, Bm=Bm, Bz=Bz, **pml)


def apply_external_fields(options, E_B, sp, time, species_index):
    """The user's external fields on the gathered (Ex, Ey, Ez, Bx, By,
    Bz) of one species, in list order (those restricted to another
    species skipped); time: a 0-d tensor of the working dtype."""
    if not options.external_fields:
        return E_B
    fields = dict(zip(("Ex", "Ey", "Ez", "Bx", "By", "Bz"), E_B))
    for ext in options.external_fields:
        if ext.applies_to(species_index):
            fields = ext.apply(fields, sp.x, sp.y, sp.z, time)
    return tuple(fields[n] for n in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"))


def process_time(time, dt):
    """The time t + dt/2 at which the elementary processes act in the
    step that starts at the host ``time`` (a host value of the working
    dtype)."""
    return time + 0.5 * dt


def ballistic_plane(sc, time, dt):
    """z of a ballistic species' injection plane at t + dt/2 from the
    host ``time`` of the working dtype (fbpic_tpu's arithmetic, z0 + v
    (t + dt/2): a host value of that dtype), or None."""
    if sc.ballistic_z0 is None:
        return None
    return sc.ballistic_z0 + sc.ballistic_v * process_time(time, dt)


def gather_and_push(config, options, sp, sc, interp, zmin, dt, z_plane=None,
                    species_index=None, time_t=None):
    """Gather E,B at a non-resident species' particles (the linear or
    cubic gather by index), apply the external fields and Vay-push its
    momenta (unless move_momenta is off; behind a ballistic species'
    plane ``z_plane`` the momenta stay).  zmin and z_plane: host numbers
    or 0-d tensors of the working dtype; time_t: the step's time as a
    0-d tensor, for the external fields.
    Returns (the species, the gathered (Ex, Ey, Ez, Bx, By, Bz)): an
    ionizable species ionizes in them."""
    gather = (gather_fields_cubic if sc.particle_shape == "cubic"
              else gather_fields_linear)
    E_B = gather(
        sp.x, sp.y, sp.z, interp, options.rmax_gather,
        1.0 / config.dz, _scalar(zmin), config.Nz, 1.0 / config.dr, 0.0,
        config.Nr, comp=_comp_of(sp))
    E_B = apply_external_fields(options, E_B, sp, time_t, species_index)
    if not options.move_momenta or sc.q == 0:
        return sp, E_B
    ux, uy, uz, inv_gamma = pp.push_p(sp, E_B[:3], E_B[3:], sc.q, sc.m, dt,
                                      z_plane=z_plane)
    return sp.replace(ux=ux, uy=uy, uz=uz, inv_gamma=inv_gamma), E_B


def half_push_x(config, options, sp, zmin):
    if not options.move_positions:
        return sp
    if sp.comp_x is not None:
        x, y, z, cx, cy, cz = pp.push_x_compensated(sp, 0.5 * config.dt)
        sp = sp.replace(comp_x=cx, comp_y=cy, comp_z=cz)
    else:
        x, y, z = pp.push_x(sp, 0.5 * config.dt)
    if config.boundaries_z == "periodic":
        Lz = config.Nz * config.dz
        zmin = _scalar(zmin)
        z = zmin + torch.remainder(z - zmin, Lz)
    return sp.replace(x=x, y=y, z=z)


def damp_pml_r(aux, interp):
    """Anisotropic radial PML damping (reference: pml_damping.py:47-83):
    the theta split components and the z components are damped; Er/Br
    are not."""
    damp = aux.damp_r_pml[None, None, :]
    Et_pml = interp.Et_pml * damp
    Bt_pml = interp.Bt_pml * damp
    return replace(interp, Et=interp.Et - interp.Et_pml + Et_pml,
                   Bt=interp.Bt - interp.Bt_pml + Bt_pml,
                   Ez=interp.Ez * damp, Bz=interp.Bz * damp,
                   Et_pml=Et_pml, Bt_pml=Bt_pml)


# ---------------------------------------------------------------------
# Moving window, open boundaries, continuous injection
# ---------------------------------------------------------------------

_SHIFTED = ("Ep", "Em", "Ez", "Bp", "Bm", "Bz", "rho_prev")


def shift_spectral_fields(config, aux, spect, n_move, rdt):
    """Shift all spectral fields (and the PML split fields) by n_move
    cells (moving window): multiplication by exp(i kz_true dz)^n_move
    (reference: boundaries/moving_window.py:134-276)."""
    ph = aux.kz_true * float(rdt(config.dz) * rdt(n_move))
    shift = torch.complex(torch.cos(ph), torch.sin(ph))[None, :, None]
    names = _SHIFTED + (SPECT_PML_FIELDS if config.use_pml else ())
    return replace(spect, **{n: getattr(spect, n) * shift for n in names})


def mirror_planes(config, options, time):
    """Each mirror's zeroed z interval (z_lo, z_hi) at the host ``time``
    of the working dtype: host values (fbpic_tpu core/step.py:492-523)."""
    planes = []
    for mirror in options.mirrors:
        z0, v = mirror.z_boost_and_beta()
        zm = float(z0) + float(v) * time
        planes.append((float(zm), float(zm + mirror.n_cells * config.dz)))
    return planes


def _z_profile(config, options, aux, zmin, time, halo=None, planes=None):
    """The multiplicative z profile of the step's E/B: the open-z
    damping times the mirrors' slabs set to zero, a per-mode (Nm, Nz)
    mask when there are mirrors (a mirror zeroes its modes ``m`` only),
    else the (Nz,) damping, or None (fbpic_tpu core/step.py:492-523).
    zmin, time: host values of the working dtype, so the mask is built
    on the device without a host read; or (``planes``: the mirrors'
    (z_lo, z_hi) as 0-d tensors, StepScalars.mirrors) zmin a 0-d tensor
    and the planes read from the device.  On a slab (``halo``) the
    damping is the slab's cut of the global profile."""
    if halo is not None:
        profile = halo.damp_profile(aux.S_w)
    else:
        profile = (aux.damp_z if config.boundaries_z == "open"
                   and config.nz_damp > 0 else None)
    if not options.mirrors:
        return profile
    rdt, dev = aux.S_w.dtype, aux.S_w.device
    z_cells = _scalar(zmin) + (torch.arange(config.Nz, dtype=rdt,
                                            device=dev) + 0.5) * config.dz
    mask = torch.ones((config.Nm, config.Nz), dtype=rdt, device=dev)
    if planes is None:
        planes = mirror_planes(config, options, time)
    for mirror, (z_lo, z_hi) in zip(options.mirrors, planes):
        inside = (z_cells >= z_lo) & (z_cells < z_hi)
        modes = (range(config.Nm) if mirror.m == "all"
                 else [mirror.m] if isinstance(mirror.m, int) else mirror.m)
        for m in modes:
            mask[m] = torch.where(inside, torch.zeros_like(mask[m]), mask[m])
    if profile is not None:
        mask = mask * profile[None, :]
    return mask


def damp_EB_z(config, aux, spect, profile, halo=None):
    """Apply a z profile ((Nz,) or per-mode (Nm, Nz), or None) to the
    spectral E/B (and the PML split fields) through one inverse /
    forward z-DFT round trip, in partial-interpolation space, the guard
    cells of a slab (``halo``) first replaced from its neighbours
    (reference: main.py:719-768, exchange_and_damp_EB)."""
    names = ("Ep", "Em", "Ez", "Bp", "Bm", "Bz") + (
        SPECT_PML_FIELDS if config.use_pml else ())
    partial = [tr.spect2partial_interp(aux.mats, getattr(spect, n))
               for n in names]
    if halo is not None:
        partial = halo.exchange_replace(partial)
    if profile is not None:
        damp = (profile[None, :, None] if profile.dim() == 1
                else profile[:, :, None])
        partial = [F * damp for F in partial]
    return replace(spect, **{
        n: tr.partial_interp2spect(aux.mats, F)
        for n, F in zip(names, partial)})


def damp_EB_z_skinny(aux, spect, interp_raw):
    """Open-z damping as a skinny spectral correction: damped = spect -
    Wf[:, rows] (1-prof)[rows] partial[rows], where partial[rows] is the
    forward DHT of the raw interp rows the step just computed (exact:
    the z profile commutes with the radial transform)."""
    rows = aux.damp_rows
    sl = [F[:, rows, :] for F in (interp_raw.Er, interp_raw.Et,
                                  interp_raw.Ez, interp_raw.Br,
                                  interp_raw.Bt, interp_raw.Bz)]
    pe, me = tr.rt_to_pm(sl[0], sl[1])
    pb, mb = tr.rt_to_pm(sl[3], sl[4])
    m_ = aux.mats
    rows_spect = [tr.dht(M, F) for M, F in zip(
        (m_.Mp, m_.Mm, m_.M0, m_.Mp, m_.Mm, m_.M0),
        (pe, me, sl[2], pb, mb, sl[5]))]
    names = ("Ep", "Em", "Ez", "Bp", "Bm", "Bz")
    return replace(spect, **{
        n: getattr(spect, n) - torch.matmul(aux.damp_skinny, X)
        for n, X in zip(names, rows_spect)})


def remove_outside_particles(sp, removal):
    """Mark particles that reached the guard cells as dead (w = 0) and
    park them at the box center (reference removal bounds,
    particle_buffer_handling.py:89-92).  removal: (z_lo, z_hi, z_park)
    of ``plan_exchange`` (the global box's bounds on a slab), host
    numbers or 0-d tensors of the working dtype."""
    z_lo, z_hi, z_park = (_scalar(v) for v in removal)
    dead = (sp.z < z_lo) | (sp.z > z_hi)

    def zero_dead(a):
        return None if a is None else torch.where(dead, torch.zeros_like(a),
                                                  a)
    return sp.replace(
        w=zero_dead(sp.w), z=torch.where(dead, z_park, sp.z),
        ids=zero_dead(sp.ids),
        ionization_level=zero_dead(sp.ionization_level))


def continuous_injection(sp, inj_cfg, inj_aux, columns, phi_of, generator,
                         resident, level=0, inject_bounds=None):
    """Inject the plasma columns the window uncovered since the last
    exchange.  A non-resident species keeps a stable storage order:
    the columns go into its ring at the cursor ``next_free``, and the
    live in-range particles they overwrite are counted.  A resident
    species' storage order is rewritten by every re-sort, so a cursor
    does not track its free slots: the columns go into dead slots (dead
    first, in storage order), and those that find none are counted.
    A slab of a decomposed run (fbpic_tpu core/step.py:735-855) writes
    only the particles inside its ``inject_bounds`` and always into dead
    slots (the slabs' occupancies differ); every slab draws the same
    columns and advances the cursors alike.
    ``columns``: (n_cols, z_end, z_lo) of ``plan_exchange`` -- host
    values, or 0-d tensors (n_cols int64) of the step's scalars, the
    same values: nothing is read back either way; the species'
    ``inj_z_end`` is the caller's (the host keeps it).
    A tracked species hands out one id per candidate particle (written
    or not), as fbpic_tpu does (core/step.py:798-801, :844-847); the
    particles of an ionizable species start at ``level``.  The cursors
    are 0-d device tensors (``Simulation.add_new_species``) or host
    ints.  Returns (species, count)."""
    updates = {}
    n_cols, z_end, z_lo = columns
    new = generate_columns(inj_cfg, inj_aux, z_end, n_cols, phi_of,
                           generator)
    n_write = new["x"].shape[0]
    col_size = inj_aux.r.shape[0]
    cap = sp.capacity
    dev = sp.x.device
    mask = torch.arange(n_write, device=dev) < n_cols * col_size
    if inject_bounds is not None:
        lo, hi = (_scalar(b) for b in inject_bounds)
        mask = mask & (new["z"] >= lo) & (new["z"] < hi)

    values = {name: new[name] for name in
              ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")}
    for name in ("comp_x", "comp_y", "comp_z"):
        if getattr(sp, name) is not None:
            values[name] = torch.zeros_like(new["x"])
    if sp.ionization_level is not None:
        values["ionization_level"] = torch.full(
            (n_write,), level, dtype=torch.int32, device=dev)
    if sp.ids is not None:
        values["ids"] = sp.next_id + torch.arange(n_write, device=dev)
        updates["next_id"] = sp.next_id + n_cols * col_size
    if not resident and inject_bounds is None:
        slots = torch.remainder(
            sp.next_free + torch.arange(n_write, device=dev), cap)
        count = (mask & (sp.w[slots] != 0)
                 & (sp.z[slots] > _scalar(z_lo))).sum()
        for name, vals in values.items():
            updates[name] = write_ring(getattr(sp, name), sp.next_free,
                                       vals, cap, mask)
    else:
        pos = torch.cumsum(mask.long(), 0) - 1
        dead_order = torch.argsort((sp.w != 0).to(torch.int8), stable=True)
        n_dead = (sp.w == 0).sum()
        slots = dead_order[:n_write]
        # The candidates go to their packed positions, the others to a
        # spare last row: an index, not a boolean mask, so no host read
        dest = torch.where(mask, pos, torch.full_like(pos, n_write))
        ok = torch.zeros(n_write + 1, dtype=torch.bool, device=dev)
        ok.index_fill_(0, dest, True)
        ok = ok[:n_write] & (torch.arange(n_write, device=dev) < n_dead)
        count = mask.sum() - ok.sum()
        for name, vals in values.items():
            arr = getattr(sp, name).clone()
            packed = torch.zeros(n_write + 1, dtype=vals.dtype, device=dev)
            packed[dest] = vals
            arr[slots] = torch.where(ok, packed[:n_write], arr[slots])
            updates[name] = arr
    updates["next_free"] = (sp.next_free + n_cols * col_size) % cap
    return sp.replace(**updates), count


def _newborn_values(esp, new, id_offset=0):
    """The channels a creation buffer writes into species ``esp``: its
    particles, zero Kahan words, and (tracked) consecutive ids from the
    species' counter plus ``id_offset``, one per buffer slot (the buffer
    is front-packed, so the newborns take the first)."""
    values = {name: new[name] for name in
              ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")}
    for name in ("comp_x", "comp_y", "comp_z"):
        if getattr(esp, name) is not None:
            values[name] = torch.zeros_like(new["x"])
    if esp.ids is not None:
        values["ids"] = (esp.next_id + id_offset) + torch.arange(
            new["x"].shape[0], device=new["x"].device)
    return values


def _rank_prescan(n_new, halo):
    """(offset, total) of this slab's creation count among the slabs':
    the counts of the lower ranks summed, and all of them (fbpic_tpu's
    all_gather prescan, core/step.py:568-576); (0, n_new) on one
    device."""
    if halo is None:
        return 0, n_new
    counts = halo.all_gather(n_new)
    off = torch.zeros((), dtype=n_new.dtype, device=n_new.device)
    total = off
    for r, cnt in enumerate(counts):
        cnt = cnt.to(n_new.device, non_blocking=True)
        if r < halo.rank:
            off = off + cnt
        total = total + cnt
    return off, total


def append_new_particles(esp, new, halo=None):
    """Write a front-packed creation buffer (w = 0 past the newborns)
    into a ring species at its cursor ``next_free`` (fbpic_tpu's
    ``_append_new_particles``, core/step.py:546-638, one device).  A
    buffer longer than the ring is cut to the ring (the excess is
    dropped).  Returns (species, dropped, overwritten): the newborns cut
    off, and the live particles the write overwrote -- fbpic_tpu counts
    the first only; both go to ring_overwrite, which grows the ring
    after the step() call (Simulation._consume_overflow_counters).
    Every count stays on the device.

    A slab of a decomposed run (``halo``) keeps the cursor and the id
    counter replicated: its ids start after the lower ranks' newborns,
    every slab advances both by the total, the writes go into this
    slab's dead slots (its occupancy differs from the others'), and the
    newborns that find none are counted, psum'd (fbpic_tpu
    ``_append_new_particles``, core/step.py:546-630)."""
    mask = new["w"] != 0
    n_new = mask.sum()
    cap = esp.capacity
    off, total = _rank_prescan(n_new, halo)
    values = _newborn_values(esp, new, off)
    if new["x"].shape[0] > cap:
        values = {name: v[:cap] for name, v in values.items()}
        mask = mask[:cap]
    nb = mask.shape[0]
    if halo is not None:
        dead_order = torch.argsort((esp.w != 0).to(torch.int8), stable=True)
        n_dead = (esp.w == 0).sum()
        slots = dead_order[:nb]
        ok = mask & (torch.arange(nb, device=mask.device) < n_dead)
        updates = {}
        for name, vals in values.items():
            arr = getattr(esp, name).clone()
            arr[slots] = torch.where(ok, vals.to(arr.dtype), arr[slots])
            updates[name] = arr
        if esp.ids is not None:
            updates["next_id"] = esp.next_id + total
        updates["next_free"] = (esp.next_free + total) % cap
        dropped = halo.psum(n_new - ok.sum())
        return esp.replace(**updates), dropped, torch.zeros_like(dropped)
    slots = torch.remainder(
        esp.next_free + torch.arange(nb, device=mask.device), cap)
    overwritten = (mask & (esp.w[slots] != 0)).sum()
    updates = {name: write_ring(getattr(esp, name), esp.next_free, vals,
                                cap, mask)
               for name, vals in values.items()}
    if esp.ids is not None:
        updates["next_id"] = esp.next_id + n_new
    updates["next_free"] = (esp.next_free + n_new) % cap
    return esp.replace(**updates), n_new - mask.sum(), overwritten


def append_into_padded(esp, new, Nz, K, zmin, invdz, zfold, halo=None):
    """Write a creation buffer into dead slots of a resident species'
    (Nz, K) layout, each newborn in a dead slot of its own z row, so the
    next banded re-sort keeps it (fbpic_tpu's ``_append_into_padded``,
    core/step.py:641-708).  ``new`` holds the end-of-step positions;
    ``zmin`` is the grid edge of the next re-sort (a host number or a
    0-d tensor of the working dtype).  Returns (species,
    dropped): the newborns whose row had no dead slot (a device count,
    for sort_overflow).  On a slab of a decomposed run (``halo``) the ids
    follow the rank prescan of append_new_particles and the count is
    psum'd."""
    dev = new["x"].device
    mask = new["w"] != 0
    nb = mask.shape[0]
    off, total = _rank_prescan(mask.sum(), halo)
    values = _newborn_values(esp, new, off)
    col = torch.floor(invdz * (values["z"] - _scalar(zmin))).long()
    col = (torch.remainder(col, Nz) if zfold == "periodic"
           else torch.clamp(col, 0, Nz - 1))
    # Stable column sort of the buffer -> the rank within each column;
    # empty buffer slots sort last (key Nz)
    key_col = torch.where(mask, col, torch.full_like(col, Nz))
    order = torch.argsort(key_col, stable=True)
    cs = key_col[order]
    mask_s = mask[order]
    within = torch.arange(nb, device=dev) - torch.searchsorted(cs, cs)
    # Each row's dead slots, dead first
    dead = (esp.w == 0).reshape(Nz, K)
    dead_order = torch.argsort((~dead).to(torch.int8), dim=1, stable=True)
    n_dead_row = dead.sum(dim=1)
    row = torch.clamp(cs, 0, Nz - 1)
    ok = (mask_s & (cs < Nz) & (within < n_dead_row[row]) & (within < K))
    slot_in_row = dead_order[row, torch.clamp(within, max=K - 1)]
    # The others go to a spare last slot: an index, not a boolean mask
    flat_slot = torch.where(ok, row * K + slot_in_row,
                            torch.full_like(row, Nz * K))
    updates = {}
    for name, vals in values.items():
        arr = getattr(esp, name)
        ext = torch.cat([arr, arr.new_zeros(1)])
        ext[flat_slot] = vals[order].to(arr.dtype)
        updates[name] = ext[:Nz * K]
    if esp.ids is not None:
        updates["next_id"] = esp.next_id + total
    dropped = mask.sum() - ok.sum()
    if halo is not None:
        dropped = halo.psum(dropped)
    return esp.replace(**updates), dropped


# ---------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------

def _cross_correction(config, options):
    return (options.correct_currents
            and config.current_correction == "cross-deposition")


def _resident_indices(config, species_configs, options):
    """Species that run the resident column layout: the fused deposit
    on, both half pushes on, no cross-deposition, and per species
    sort_K > 0, not a tracer, linear shapes and Simulation's residency
    flag (capacity Nz * sort_K)."""
    if not options.fused_deposit:
        return []
    if not (options.move_positions and options.move_momenta):
        return []
    if _cross_correction(config, options):
        return []
    return [i for i, sc in enumerate(species_configs)
            if sc.resident and sc.sort_K > 0 and not sc.is_tracer
            and sc.particle_shape == "linear"]


def make_step_fn(config, species_configs, options: StepOptions, halo=None):
    """Build the single-step function ``step(state, aux, inj_auxes,
    column_angles, generator, antenna_series, ion_auxes, comp_auxes,
    draws)``.

    ``halo``: one slab's exchange and global-geometry hooks in a
    z-decomposed run (parallel/domain.py's Halo), called where
    fbpic_tpu's step calls its Halo: the removal bounds, the injection
    plane and the window count on the global grid; the counters psum'd;
    the antenna deposited by its owning slab; the corrected J (and both
    rho's with use_true_rho or correct_divE) guard-added; the E/B guards
    replaced in the damping pass, which is then never the skinny one.
    Every branch around a collective is decided on replicated values
    (the iteration, host geometry) or psum'd ones, so all slabs take it
    alike.

    ``column_angles(iteration, species_index, nkey)`` gives the rotation
    of each injected column (see particles/injection.py);
    ``draws(name, iteration, species_index, shape, dtype)`` the uniform
    draws of ionization and Compton scattering (``GeneratorDraws``; a
    replayed step passes the iteration of its capture, which
    ``GeneratorDraws`` ignores, particles/draws.py);
    ion_auxes / comp_auxes: each species' IonizerAux / ComptonAux (or
    None).

    ``exchanged``: the caller ran the exchange block of an exchange step
    already (``step.exchange(state, aux, inj_auxes, column_angles,
    generator)``, the returned function's attribute), so the step runs
    the rest on its result: the chunk runner does so where the block
    must stay eager (a user's host density function, another angle
    source: core/graph.py's ``graph_blockers``).

    ``scalars``: the step's StepScalars, which every part of the step
    (the exchange block with ``scalars.exchange``, the re-sort, the
    gathers -- K2 and the ring's --, the pushes and the ballistic
    planes, Compton scattering, the newborns' deposits and appends, the
    deposits, the external fields, the antennas and the mirrors) then
    reads in place of the host's numbers (equal values).
    ``redo_flag``: a 0-d int64 device tensor into which the banded
    re-sort adds its overflow count, instead of reading it back and
    redoing the sort: the caller redoes the step (core/graph.py)."""
    species_configs = tuple(species_configs)
    resident_idx = _resident_indices(config, species_configs, options)
    cross = _cross_correction(config, options)
    # The fused sorted deposit (J and rho_next at once, after the first
    # half push) does not run under cross-deposition, which deposits
    # between the half pushes
    will_fuse = options.fused_deposit and options.move_positions \
        and not cross
    zfold = _zfold(config)

    def exchange(state: SimState, aux, inj_auxes=(), column_angles=None,
                 generator=None, scalars=None) -> SimState:
        """The exchange block of an exchange step (plan_step's
        ``exchange``: open z, every exchange_period steps): remove the
        particles in the guard cells, inject the columns the moving window
        uncovered, and re-deposit rho_prev (reference: main.py:435-449).
        In between, rho_prev is the window-shifted previous rho_next.
        Returns the state with it applied; the step then runs on it with
        ``exchanged``.  Its values come from ``plan_exchange`` (the
        injection fronts advanced in the returned state), or, with
        ``scalars`` whose ``exchange`` is set (the step's StepScalars),
        from the device, the injection fronts left to the caller: the
        block then reads nothing from the host, and core/graph.py
        captures it with the rest of the step."""
        zmin, it = state.zmin, state.iteration
        ring_overwrite = state.ring_overwrite
        species = list(state.species)
        on_host = scalars is None or scalars.exchange is None
        if on_host:
            values = plan_exchange(config, options,
                                   [sp.inj_z_end for sp in species], zmin,
                                   halo)
            zd = float(zmin)
        else:
            values, zd = scalars.exchange, scalars.zmin
        species = [remove_outside_particles(sp, values.removal)
                   for sp in species]
        for i, columns in enumerate(values.injection):
            if columns is None:
                continue
            ion = species_configs[i].ionizer
            species[i], count = continuous_injection(
                species[i], options.injectors[i], inj_auxes[i], columns,
                lambda nkey, i=i: column_angles(it, i, nkey), generator,
                resident=i in resident_idx,
                level=0 if ion is None else ion.level_start,
                inject_bounds=values.inject_bounds)
            if on_host:
                species[i] = species[i].replace(
                    inj_z_end=values.z_end_after[i])
            if halo is not None:
                count = halo.psum(count)
            ring_overwrite = ring_overwrite + count
        rho_prev = deposit_rho_spect(config, aux, species, species_configs,
                                     zd)
        if options.filter_currents:
            rho_prev = ps.filter_scalar(rho_prev, aux.filter_z,
                                        aux.filter_r)
        return replace(state, species=species,
                       spect=replace(state.spect, rho_prev=rho_prev),
                       ring_overwrite=ring_overwrite)

    def step(state: SimState, aux, inj_auxes=(), column_angles=None,
             generator=None, antenna_series=(), ion_auxes=(), comp_auxes=(),
             draws=None, scalars=None, redo_flag=None,
             exchanged=False) -> SimState:
        dt = config.dt
        # The global grid's left edge (the local one but on a slab)
        zmin_g = halo.global_zmin(state.zmin) if halo is not None \
            else state.zmin
        zmin = state.zmin
        it = state.iteration
        plan = plan_step(config, options, zmin, zmin_g, state.mw_zref,
                         state.time, it)
        if plan.exchange and not exchanged:
            state = exchange(state, aux, inj_auxes, column_angles,
                             generator, scalars=scalars)
        spect, interp = state.spect, state.interp
        species = list(state.species)
        sort_overflow = state.sort_overflow
        ring_overwrite = state.ring_overwrite
        # Galilean frame: the grid edge flows vg*dt per step; deposits
        # see it at their own time (fbpic_tpu core/step.py:942-956)
        vg = config.v_galilean
        zmin_mid, zmin_next = plan.zmin_mid, plan.zmin_next
        # ... as the step's ops and kernels take them
        if scalars is not None:
            zd, zd_mid, zd_next = (scalars.zmin, scalars.zmin_mid,
                                   scalars.zmin_next)
        else:
            zd, zd_mid, zd_next = (float(zmin), float(zmin_mid),
                                   float(zmin_next))
        # The external fields see the step's time as a 0-d tensor of the
        # working dtype (a fill: no host-to-device copy)
        time_t = None
        if options.external_fields:
            time_t = scalars.time if scalars is not None else torch.full(
                (), float(state.time), dtype=aux.S_w.dtype,
                device=aux.S_w.device)
        # ... Compton scattering its time t + dt/2 (the same), and each
        # ballistic push its plane (a host number or a 0-d tensor: the
        # push compares in the working dtype either way)
        time_mid = planes = None
        if scalars is not None:
            time_mid, planes = scalars.time_mid, scalars.planes or None
        elif any(sc.compton is not None for sc in species_configs):
            time_mid = torch.full(
                (), float(process_time(state.time, dt)),
                dtype=aux.S_w.dtype, device=aux.S_w.device)
        if planes is None:
            planes = tuple(ballistic_plane(sc, state.time, dt)
                           for sc in species_configs)

        # float32, standard scheme: the correction needs the
        # per-particle d(rho)
        f32_mode = any(sp.x.dtype == torch.float32 for sp in species)
        want_drho = (f32_mode and options.correct_currents
                     and config.current_correction == "curl-free"
                     and not config.use_comoving)
        band = config.resort_band
        fused_J, fused_rho, fused_drho = {}, {}, {}
        # With the fused deposit's d(rho), rho_next = rho_prev + d(rho)
        derive_rho_next = want_drho and bool(resident_idx)
        # Creation buffers of the resident sources' processes
        resident_new = {}

        def _draw_of(i):
            """Species i's uniform draws of this step: draw(name, shape),
            on the step's device (a no-op for the default source); on a
            slab the source is also given the slab's rank, which
            fbpic_tpu folds into the key (core/step.py:92-109)."""
            rank = {} if halo is None else {"rank": halo.rank}
            return lambda name, shape: draws(
                name, it, i, shape, aux.S_w.dtype, **rank).to(
                    aux.S_w.device)

        for i in resident_idx:
            sp, sc = species[i], species_configs[i]
            K = sc.sort_K
            if sp.capacity != config.Nz * K:
                raise ValueError("resident species capacity must equal "
                                 "Nz * sort_K")
            payload = [sp.x, sp.y, sp.z, sp.w, sp.ux, sp.uy, sp.uz,
                       sp.inv_gamma]
            if sp.comp_x is not None:
                payload += [sp.comp_x, sp.comp_y, sp.comp_z]
            # Tracking ids (int64) and the ionization level (int32) ride
            # the sort as channels of their own, after the float ones,
            # which the kernels read in place
            n_float = len(payload)
            if sp.ids is not None:
                payload.append(sp.ids)
            if sp.ionization_level is not None:
                payload.append(sp.ionization_level)

            def full_sort():
                return build_column_sort(sp.z, sp.w, zd, 1.0 / config.dz,
                                         config.Nz, K, payload)

            if sc.resort != "banded" or plan.full_resort:
                sort = full_sort()
            else:
                sort = banded_column_resort(
                    [a.reshape(config.Nz, K) for a in payload], zd,
                    1.0 / config.dz, config.Nz, K, band, zfold=zfold)
                # Column overflow in the banded re-sort: redo the exact
                # full sort (a host read of the count), or leave the
                # count in the caller's flag
                if redo_flag is not None:
                    redo_flag.add_(sort["n_over"])
                elif int(sort["n_over"]) > 0:
                    sort = full_sort()
            n_over = sort["n_over"]
            if halo is not None:
                n_over = halo.psum(n_over)
            sort_overflow = sort_overflow + n_over
            pad, valid = sort["padded"], sort["valid"]
            comp_kw = ({"comp_x": pad[8], "comp_y": pad[9],
                        "comp_z": pad[10]} if sp.comp_x is not None else {})
            if sp.ionization_level is not None:
                comp_kw["ionization_level"] = pad[-1]
            psp = sp.replace(
                x=pad[0], y=pad[1], z=pad[2],
                w=torch.where(valid, pad[3], torch.zeros_like(pad[3])),
                ux=pad[4], uy=pad[5], uz=pad[6], inv_gamma=pad[7], **comp_kw)

            E_B = gather_fields_sorted(
                psp.x, psp.y, psp.z, valid, interp, options.rmax_gather,
                1.0 / config.dz, zd, config.Nz,
                1.0 / config.dr, 0.0, config.Nr, comp=_comp_of(psp),
                zfold=zfold)
            # On the padded (Nz, K) layout: dead slots see the field
            # harmlessly
            E_B = apply_external_fields(options, E_B, psp, time_t, i)
            if sc.q != 0:
                ux, uy, uz, inv_gamma = pp.push_p(
                    psp, E_B[:3], E_B[3:], sc.q, sc.m, dt,
                    z_plane=planes[i])
                psp = psp.replace(ux=ux, uy=uy, uz=uz, inv_gamma=inv_gamma)
            psp = half_push_x(config, options, psp, zd_mid)

            # Elementary processes at t = (n+1/2) dt, between the push
            # and the deposit (the reference order, main.py:468-511), on
            # flat views of the padded layout: the deposit sees the new
            # levels and the recoiled momenta; the newborns are routed
            # after the resident block
            if sc.compton is not None:
                u, resident_new[("compton", i)] = handle_compton(
                    _flat(psp), sc.compton, comp_auxes[i], dt, time_mid,
                    _draw_of(i))
                psp = psp.replace(**{n: a.reshape(psp.x.shape) for n, a in
                                     zip(("ux", "uy", "uz", "inv_gamma"), u)})
            if sc.ionizer is not None:
                level, resident_new[("ionize", i)] = ionize(
                    _flat(psp), [a.reshape(-1) for a in E_B[:3]],
                    [a.reshape(-1) for a in E_B[3:]], sc.ionizer,
                    ion_auxes[i], _draw_of(i)("ionize", (psp.w.numel(),)))
                psp = psp.replace(ionization_level=level.reshape(
                    psp.x.shape))

            # Fused J + rho/d(rho) deposit on the pushed padded arrays
            # (sort_at_start: the sort is half a push behind); the
            # weight of an ionizable species times its new levels
            w_dep = psp.w_eff
            pad_dep = [psp.x, psp.y, psp.z, w_dep, psp.ux, psp.uy, psp.uz,
                       psp.inv_gamma]
            if psp.comp_x is not None:
                pad_dep += [psp.comp_x, psp.comp_y, psp.comp_z]
            out = deposit_rho_J_sorted(
                dict(valid=valid, padded=pad_dep), psp.x, psp.y, psp.z,
                w_dep, sc.q, psp.ux, psp.uy, psp.uz, psp.inv_gamma,
                0.5 * dt, config.Nm, 1.0 / config.dz, zd_mid,
                config.Nz, 1.0 / config.dr, 0.0, config.Nr,
                aux.ruyten_linear, zfold=zfold, comp=_comp_of(psp),
                with_drho=want_drho, with_rho=not want_drho,
                sort_at_start=True, vz_shift=vg)
            fused_J[i] = out[:3]
            fused_rho[i] = out[3]
            if want_drho:
                fused_drho[i] = out[4]
            psp = half_push_x(config, options, psp, zd_next)
            # Flatten back: the sorted order becomes the storage order;
            # invalid slots (duplicates of neighbours) are dead
            flat = {n: getattr(psp, n).reshape(-1) for n in
                    ("x", "y", "z", "ux", "uy", "uz", "inv_gamma")}
            if psp.comp_x is not None:
                flat.update({n: getattr(psp, n).reshape(-1)
                             for n in ("comp_x", "comp_y", "comp_z")})
            flat["w"] = torch.where(valid, psp.w,
                                    torch.zeros_like(psp.w)).reshape(-1)
            if sp.ids is not None:
                ids = pad[n_float]
                flat["ids"] = torch.where(valid, ids,
                                          torch.zeros_like(ids)).reshape(-1)
            if sp.ionization_level is not None:
                lev = psp.ionization_level
                flat["ionization_level"] = torch.where(
                    valid, lev, torch.zeros_like(lev)).reshape(-1)
            species[i] = sp.replace(**flat)

        # --- Non-resident species: linear or cubic gather, momentum
        # push, first half position push
        gathered = {}
        for i, sc in enumerate(species_configs):
            if i not in resident_idx:
                sp, E_B = gather_and_push(
                    config, options, species[i], sc, interp, zd, dt,
                    z_plane=planes[i], species_index=i, time_t=time_t)
                species[i] = half_push_x(config, options, sp, zd_mid)
                if sc.ionizer is not None:
                    gathered[i] = E_B

        # --- Elementary processes at t = (n+1/2) dt (reference:
        # main.py:499-503): Compton scattering, then ionization, species
        # by species; a resident source already ran its process in the
        # resident block.  The newborns go to their target species.
        def route_newborns(tgt, new):
            """Append a creation buffer (positions at t = (n+1/2) dt) to
            the target species.  A ring target takes it at its cursor
            before its deposits (the newborns ride the normal path).  A
            resident target's fused deposit already ran: the newborns'
            birth-step J and rho / d(rho) are scatter-deposited from the
            buffer onto its fused grids, and the buffer, half-pushed to
            t = (n+1) dt, lands in dead slots of its own z rows."""
            nonlocal ring_overwrite, sort_overflow
            if tgt not in resident_idx:
                species[tgt], dropped, overwritten = append_new_particles(
                    species[tgt], new, halo)
                ring_overwrite = ring_overwrite + dropped + overwritten
                return
            q_t = species_configs[tgt].q
            xb, yb, zb, wb = new["x"], new["y"], new["z"], new["w"]
            uxb, uyb, uzb, igb = (new["ux"], new["uy"], new["uz"],
                                  new["inv_gamma"])
            Jb = deposit_J_linear(xb, yb, zb, wb, q_t, uxb, uyb, uzb, igb,
                                  *_deposit_args(config, zd_mid),
                                  aux.ruyten_linear, zfold=zfold)
            fused_J[tgt] = tuple(a + b for a, b in zip(fused_J[tgt], Jb))
            chdt = c * 0.5 * dt
            x2 = xb + chdt * igb * uxb
            y2 = yb + chdt * igb * uyb
            z2 = zb + chdt * igb * uzb
            if want_drho:
                # The fused path's telescoped difference rho(x + h) -
                # rho(x - h): the missing pre-birth term cancels against
                # the parent's level change at the same position
                x0 = xb - chdt * igb * uxb
                y0 = yb - chdt * igb * uyb
                z0 = zb - chdt * igb * uzb
                r2 = deposit_rho_linear(x2, y2, z2, wb, q_t,
                                        *_deposit_args(config, zd),
                                        aux.ruyten_linear, zfold=zfold)
                r0 = deposit_rho_linear(x0, y0, z0, wb, q_t,
                                        *_deposit_args(config, zd),
                                        aux.ruyten_linear, zfold=zfold)
                fused_drho[tgt] = fused_drho[tgt] + (r2 - r0)
            elif fused_rho.get(tgt) is not None:
                fused_rho[tgt] = fused_rho[tgt] + deposit_rho_linear(
                    x2, y2, z2, wb, q_t, *_deposit_args(config, zd_next),
                    aux.ruyten_linear, zfold=zfold)
            species[tgt], dropped = append_into_padded(
                species[tgt], dict(new, x=x2, y=y2, z=z2), config.Nz,
                species_configs[tgt].sort_K, zd, 1.0 / config.dz, zfold,
                halo)
            sort_overflow = sort_overflow + dropped

        for i, sc in enumerate(species_configs):
            if sc.compton is None:
                continue
            if i in resident_idx:
                new = resident_new[("compton", i)]
            else:
                sp = species[i]
                u, new = handle_compton(sp, sc.compton, comp_auxes[i], dt,
                                        time_mid, _draw_of(i))
                species[i] = sp.replace(**dict(zip(
                    ("ux", "uy", "uz", "inv_gamma"), u)))
            route_newborns(sc.compton.target_index, new)
        for i, sc in enumerate(species_configs):
            if sc.ionizer is None:
                continue
            if i in resident_idx:
                new = resident_new[("ionize", i)]
            else:
                sp = species[i]
                level, new = ionize(
                    sp, gathered[i][:3], gathered[i][3:], sc.ionizer,
                    ion_auxes[i], _draw_of(i)("ionize", (sp.w.shape[0],)))
                species[i] = sp.replace(ionization_level=level)
            if sc.ionizer.per_level_targets:
                # Each level's electrons to their own species (reference
                # ionizer.py:123-146)
                for off, tgt in enumerate(sc.ionizer.per_level_targets):
                    route_newborns(tgt, select_level_electrons(
                        new, sc.ionizer.level_start + off))
            else:
                route_newborns(sc.ionizer.target_index, new)

        # --- Column sort of the non-resident sort_K species at the mid
        # positions (fbpic_tpu core/step.py:1416-1467).  The fused
        # deposit takes the particles through the sort (payload plan);
        # the legacy deposits gather the arrays as they are when they
        # deposit (idx plan), and need an exact-position sort, so a
        # Galilean grid drift sends them to the scatter deposits.  Cubic
        # species are sorted only for the fused deposit (the legacy
        # deposits are linear), tracers never.
        sorts = {}
        for i, sc in enumerate(species_configs):
            if i in resident_idx or sc.sort_K <= 0 or sc.is_tracer:
                continue
            if not (will_fuse or vg == 0.0):
                continue
            if sc.particle_shape != "linear" and not will_fuse:
                continue
            sp = species[i]
            # The payload's weight is the deposit weight (w times the
            # level of an ionizable species)
            w_eff = sp.w_eff
            payload = None
            if will_fuse:
                payload = [sp.x, sp.y, sp.z, w_eff, sp.ux, sp.uy, sp.uz,
                           sp.inv_gamma]
                if sp.comp_x is not None:
                    payload += [sp.comp_x, sp.comp_y, sp.comp_z]
            sorts[i] = build_column_sort(sp.z, w_eff, zd_mid,
                                         1.0 / config.dz, config.Nz,
                                         sc.sort_K, payload)
            n_over = sorts[i]["n_over"]
            if halo is not None:
                n_over = halo.psum(n_over)
            sort_overflow = sort_overflow + n_over

        # --- Fused J + rho / d(rho) deposit of the sorted species (K1,
        # or K3 twice; cubic: deposit_rho_J_sorted_cubic) on their fresh
        # sort
        if will_fuse and sorts:
            derive_rho_next = want_drho
            for i, sort in sorts.items():
                sp, sc = species[i], species_configs[i]
                cubic = sc.particle_shape == "cubic"
                fused_fn = (deposit_rho_J_sorted_cubic if cubic
                            else deposit_rho_J_sorted)
                out = fused_fn(
                    sort, sp.x, sp.y, sp.z, sp.w_eff, sc.q, sp.ux, sp.uy,
                    sp.uz, sp.inv_gamma, 0.5 * dt, config.Nm,
                    1.0 / config.dz, zd_mid, config.Nz,
                    1.0 / config.dr, 0.0, config.Nr, aux.ruyten_cubic if cubic
                    else aux.ruyten_linear, zfold=zfold,
                    comp=_comp_of(sp), with_drho=want_drho,
                    with_rho=not derive_rho_next, vz_shift=vg)
                fused_J[i] = out[:3]
                fused_rho[i] = out[3]
                if want_drho:
                    fused_drho[i] = out[4]

        # --- Current at t = (n+1/2) dt; on a slab the antenna deposits
        # only where the slab owns its plane (its guard spill reaches
        # the neighbour through the exchange, as particles' does)
        Jp, Jm, Jz = deposit_J_spect(
            config, aux, species, species_configs, zd_mid,
            antenna_series=antenna_series, iteration=it, sorts=sorts,
            fused=fused_J, antenna_bounds=None if halo is None
            else halo.own_bounds(zmin_mid), antenna_cells=None
            if scalars is None else scalars.antennas)
        if options.filter_currents:
            Jp, Jm, Jz = ps.filter_vector(Jp, Jm, Jz, aux.filter_z,
                                          aux.filter_r)
        spect = replace(spect, Jp=Jp, Jm=Jm, Jz=Jz)

        # --- Cross-deposition (between the two position half pushes)
        if cross:
            spect = _cross_deposit(config, options, aux, spect, species,
                                   species_configs, zd, halo=halo,
                                   zmin_next=zd_next)

        # --- float32, species without the fused deposit: their charge at
        # the start-of-step positions, for the grid-difference d(rho)
        scatter_rho1 = {}
        if want_drho:
            for i, (sp, sc) in enumerate(zip(species, species_configs)):
                if sc.is_tracer or i in fused_drho:
                    continue
                x0, y0, z0 = pp.push_x(sp, -0.5 * dt)
                dep, ruy = _scatter_rho(aux, sc)
                scatter_rho1[i] = dep(
                    x0, y0, z0, sp.w_eff, sc.q, *_deposit_args(config, zd),
                    ruy, zfold=zfold, comp=_comp_of(sp))

        # --- Second half position push of the non-resident species
        species = [sp if i in resident_idx
                   else half_push_x(config, options, sp, zd_next)
                   for i, sp in enumerate(species)]

        # --- float32: the per-particle d(rho) of the fused deposits plus
        # the grid differences of the other species
        drho = None
        if want_drho:
            contribs = list(fused_drho.values())
            for i, rho1 in scatter_rho1.items():
                sp, sc = species[i], species_configs[i]
                dep, ruy = _scatter_rho(aux, sc)
                rho2 = dep(sp.x, sp.y, sp.z, sp.w_eff, sc.q,
                           *_deposit_args(config, zd), ruy, zfold=zfold,
                           comp=_comp_of(sp))
                contribs.append(rho2 - rho1)
            if contribs:
                tot = contribs[0]
                for contrib in contribs[1:]:
                    tot = tot + contrib
                drho = tr.interp2spect_scal(aux.mats,
                                            tot * aux.invvol[:, None, :])
                if options.filter_currents:
                    drho = ps.filter_scalar(drho, aux.filter_z,
                                            aux.filter_r)

        # --- Charge at t = (n+1) dt: rho_prev + d(rho) where the fused
        # deposits gave d(rho), else deposited
        if derive_rho_next and drho is not None:
            rho_next = spect.rho_prev + drho
        else:
            rho_next = deposit_rho_spect(config, aux, species,
                                         species_configs, zd_next,
                                         sorts=sorts, fused=fused_rho)
            if options.filter_currents:
                rho_next = ps.filter_scalar(rho_next, aux.filter_z,
                                            aux.filter_r)
        spect = replace(spect, rho_next=rho_next)

        # On a slab the correction runs on the LOCAL sources (it is
        # linear: the slabs' corrected currents sum to a current that
        # satisfies the global continuity equation); the corrected J is
        # then guard-added, rho only with use_true_rho / correct_divE,
        # which read it (fbpic_tpu core/step.py:1605-1636: rho_prev
        # exchanged and reused would break the next corrections)
        if options.correct_currents:
            spect = correct_currents(config, aux, spect, drho=drho)
        if halo is not None:
            names = ["Jp", "Jm", "Jz"]
            if options.use_true_rho or options.correct_divE:
                names += ["rho_next", "rho_prev"]
            fs = halo.exchange_add([tr.ifft_z(getattr(spect, n))
                                    for n in names])
            spect = replace(spect, **{n: tr.fft_z(f)
                                      for n, f in zip(names, fs)})
        spect = push_fields(config, aux, spect, options.use_true_rho)
        if options.correct_divE:
            Ep, Em, Ez = ps.correct_divE(spect.rho_prev, spect.Ep, spect.Em,
                                         spect.Ez, aux.kz, aux.kr,
                                         aux.inv_k2)
            spect = replace(spect, Ep=Ep, Em=Em, Ez=Ez)

        # --- Galilean frame: the grid edge has flowed vg*dt this step
        # (no spectral shift: the comoving coefficients advance the
        # fields in the flowing frame).  Before the window comparison, so
        # the window shifts only the excess over the drift (plan_step).
        # --- Moving window: shift the spectral fields and the grid edge;
        # roll the resident rows so row == column still holds
        zmin = plan.zmin_end
        if options.moving_window_v is not None:
            n_move = plan.n_move
            spect = shift_spectral_fields(config, aux, spect, n_move,
                                          type(state.zmin))
            for ri in resident_idx:
                if species_configs[ri].resort != "banded":
                    continue
                rsp = species[ri]
                rK = species_configs[ri].sort_K
                upd = {n: torch.roll(getattr(rsp, n), -n_move * rK)
                       for n in ARRAY_FIELDS if getattr(rsp, n) is not None}
                if n_move > 0:
                    for n in ("w", "ids", "ionization_level"):
                        if n in upd:
                            upd[n][(config.Nz - n_move) * rK:] = 0
                species[ri] = rsp.replace(**upd)

        # --- Open-z damping and mirrors: one z profile (fbpic_tpu
        # core/step.py:1701-1733).  The damping alone commutes with the
        # radial transform, so it is applied elementwise to the interp
        # fields, and to spectral space as a skinny correction or through
        # the radial PML's full round trip (damp the split fields on the
        # interp grid, transform back).  With mirrors (time-dependent
        # rows) the profile goes through damp_EB_z's full z round trip
        # first, and the PML round trip follows without it.
        # On a slab the profile is its cut of the global one, and the E/B
        # guards are replaced in the same full round trip.
        if scalars is not None and options.mirrors:
            profile = _z_profile(config, options, aux, scalars.zmin_end,
                                 state.time, halo, planes=scalars.mirrors)
        else:
            profile = _z_profile(config, options, aux, zmin, state.time,
                                 halo)
        pml_active = aux.damp_r_pml is not None
        plain_damp = (halo is None and not options.mirrors
                      and profile is not None
                      and (aux.damp_rows is not None or pml_active))
        if (profile is not None or halo is not None) and not plain_damp:
            spect = damp_EB_z(config, aux, spect, profile, halo)
        if pml_active:
            interp = spect2interp_EB(aux, spect, interp, use_pml=True)
            if plain_damp:
                interp = _apply_z_profile(aux, interp, _EB + INTERP_PML_FIELDS)
            interp = damp_pml_r(aux, interp)
            spect = interp2spect_EB(aux, interp, spect, use_pml=True)
        else:
            interp = spect2interp_EB(aux, spect, interp,
                                     use_pml=config.use_pml)
            if plain_damp:
                spect = damp_EB_z_skinny(aux, spect, interp)
                interp = _apply_z_profile(aux, interp, _EB)

        return SimState(
            spect=spect, interp=interp, species=species,
            time=plan.time_end, zmin=zmin, iteration=it + 1,
            mw_zref=plan.mw_zref_end, sort_overflow=sort_overflow,
            ring_overwrite=ring_overwrite,
            migration_overflow=state.migration_overflow)

    step.exchange = exchange
    return step


_EB = ("Er", "Et", "Ez", "Br", "Bt", "Bz")


def _flat(psp):
    """A padded (Nz, K) species as flat (Nz * K,) tensors, for the
    elementary processes (1-D creation buffers)."""
    return psp.replace(**{n: getattr(psp, n).reshape(-1) for n in
                          ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w",
                           "ionization_level")
                          if getattr(psp, n) is not None})


def _apply_z_profile(aux, interp, names):
    """Elementwise open-z damping of interp fields."""
    prof = aux.damp_z[None, :, None]
    return replace(interp, **{n: getattr(interp, n) * prof for n in names})


def _scatter_rho(aux, sc):
    """The scatter charge deposit of a species' shape and its Ruyten
    coefficients."""
    if sc.particle_shape == "cubic":
        return deposit_rho_cubic, aux.ruyten_cubic
    return deposit_rho_linear, aux.ruyten_linear


def _cross_deposit(config, options, aux, spect, species, species_configs,
                   zmin, vg_dt=0.0, halo=None, zmin_next=None):
    """Deposit rho_next_xy and rho_next_z (cross-deposition scheme).

    Particles enter at (z[n+1/2], x[n+1/2]); see reference
    main.py:672-716.  vg_dt: the Galilean grid drift per step --
    rho_next_xy (z at t=n) sees the grid at zmin, rho_next_z (z at
    t=n+1) the grid at zmin_next = zmin + vg*dt (the reference shifts
    the boundaries between the two deposits, main.py:692,:704).  zmin
    and zmin_next (given: the step's own, StepScalars or the host
    plan's) may be 0-d tensors."""
    if zmin_next is None:
        zmin_next = zmin + vg_dt
    def push_species(species, dt, xp, yp, zp, zmin_wrap):
        if not options.move_positions:
            return species
        out = []
        for sp in species:
            x, y, z = pp.push_x(sp, dt, x_push=xp, y_push=yp, z_push=zp)
            if config.boundaries_z == "periodic":
                Lz = config.Nz * config.dz
                zw = _scalar(zmin_wrap)
                z = zw + torch.remainder(z - zw, Lz)
            out.append(sp.replace(x=x, y=y, z=z))
        return out

    # z[n+1/2], x[n+1/2] -> z[n], x[n+1]
    tmp = push_species(species, 0.5 * config.dt, 1.0, 1.0, -1.0, zmin)
    rho_next_xy = deposit_rho_spect(config, aux, tmp, species_configs, zmin)
    # z[n], x[n+1] -> z[n+1], x[n]
    tmp = push_species(tmp, config.dt, -1.0, -1.0, 1.0, zmin_next)
    rho_next_z = deposit_rho_spect(config, aux, tmp, species_configs,
                                   zmin_next)
    if halo is not None:
        fs = halo.exchange_add([tr.ifft_z(rho_next_xy), tr.ifft_z(rho_next_z)])
        rho_next_xy, rho_next_z = (tr.fft_z(f) for f in fs)
    if options.filter_currents:
        rho_next_xy = ps.filter_scalar(rho_next_xy, aux.filter_z,
                                       aux.filter_r)
        rho_next_z = ps.filter_scalar(rho_next_z, aux.filter_z, aux.filter_r)
    return replace(spect, rho_next_xy=rho_next_xy, rho_next_z=rho_next_z)


def prepare(config, options, species_configs, state, aux):
    """Before a run of steps: refresh spectral E/B (and the PML split
    fields) from the interpolation grid and deposit rho_prev (reference:
    main.py:408-415, :435-449)."""
    spect = interp2spect_EB(aux, state.interp, state.spect,
                            use_pml=config.use_pml)
    rho = deposit_rho_spect(config, aux, state.species, species_configs,
                            state.zmin)
    if options.filter_currents:
        rho = ps.filter_scalar(rho, aux.filter_z, aux.filter_r)
    return replace(state, spect=replace(spect, rho_prev=rho))


# ---------------------------------------------------------------------
# fbpic_tpu's step builders (core/step.py:1754-1815)
# ---------------------------------------------------------------------

def ensure_counters(state):
    """Materialize the overflow counters as 0-d int64 device tensors: a
    chunk of steps carries a fixed set of tensors (fbpic_tpu's
    fori_loop carry; here the CUDA graphs' static buffers)."""
    dev = state.spect.Ep.device
    updates = {n: torch.zeros((), dtype=torch.int64, device=dev)
               for n in ("sort_overflow", "ring_overwrite")
               if getattr(state, n) is None}
    return replace(state, **updates) if updates else state


def make_step(config, species_configs, options, halo=None):
    """The single step (fbpic_tpu jit-compiles it and donates the state;
    the port's runs eagerly and leaves its input state unchanged)."""
    return make_step_fn(config, species_configs, options, halo)


def make_prepare(config, species_configs, options):
    """The preparation before a run of steps, ``prepare_fn(state, aux)``:
    spectral E/B refreshed from the interpolation grid and rho_prev
    deposited (reference: main.py:408-415, :435-449)."""
    species_configs = tuple(species_configs)

    def prepare_fn(state, aux):
        return prepare(config, options, species_configs, state, aux)
    return prepare_fn


def make_multi_step(config, species_configs, options):
    """The chunk runner: ``multi_step(state, aux, n_steps, ...)`` runs up
    to MAX_CAPTURE steps with one host read at the end, the exchange
    steps eagerly and the others from captured CUDA graphs (the body
    called directly on CPU tensors); see core/graph.py.  fbpic_tpu's
    counterpart runs them as one jitted lax.fori_loop."""
    from .graph import MultiStep
    return MultiStep(config, species_configs, options)


def make_multi_step_capture(config, species_configs, options, capture_fns):
    """The chunk runner that also evaluates per-step capture functions
    inside the chunk (fbpic_tpu core/step.py:1818-1843, a lax.scan):
    each ``cap(state, aux, time, zmin)`` of the state after every step,
    written into a device buffer at the step's row (inside the graph of
    a replayed step) and brought back with the chunk's one host read,
    stacked over the steps (``counts["captures"]``); see core/graph.py.
    The back-transformed field diagnostic's ``device_capture`` gives
    one."""
    from .graph import MultiStep
    return MultiStep(config, species_configs, options, capture_fns)
