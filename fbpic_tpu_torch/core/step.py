"""The PIC cycle, one eager step at a time.

One step (momenta one half-step behind positions at cycle boundaries,
as in the reference, FBPIC's fbpic/main.py:346-585):

    [exchange: remove, inject, deposit rho_prev]
    -> resident species: re-sort (banded, or full) -> sorted gather E,B
       (K2) -> Vay push p -> push x (dt/2) -> fused J + d(rho) deposit
       (K1), or J and rho deposits (K3) -> push x (dt/2)
    -> other species: linear gather E,B -> Vay push p -> push x (dt/2)
       -> [sort_K > 0: column sort, fused deposits (K1 / K3)]
       -> J (scatter, or the legacy sorted plan: K3) -> push x (dt/2)
    -> rho_next -> correct currents -> PSATD push
    -> Galilean drift + moving-window shift -> spect2interp E,B
    -> open-z damping

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
on the host: the exchange cadence and the injected column count depend
on the iteration only, and the banded re-sort's fallback to the full
sort reads the overflow count back (one device-to-host sync per step).
"""
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..fields import transform as tr
from ..fields import psatd_push as ps
from ..particles import push as pp
from ..particles.deposit import deposit_rho_linear, deposit_J_linear
from ..particles.gather import gather_fields_linear, gather_fields_sorted
from ..particles.injection import generate_columns, write_ring
from ..particles.state import ARRAY_FIELDS
from ..particles.sorted_deposit import (
    build_column_sort, banded_column_resort, deposit_rho_J_sorted,
    deposit_rho_sorted, deposit_J_sorted,
)
from .state import SimState


@dataclass(frozen=True)
class StepOptions:
    """Static options of the PIC cycle."""
    correct_currents: bool = True
    use_true_rho: bool = False
    filter_currents: bool = True
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


def _zfold(config):
    return "periodic" if config.boundaries_z == "periodic" else "clamp"


def _comp_of(sp):
    """(comp_x, comp_y, comp_z) tuple or None (float64 runs)."""
    if sp.comp_x is None:
        return None
    return (sp.comp_x, sp.comp_y, sp.comp_z)


def _deposit_args(config, zmin):
    return (config.Nm, 1.0 / config.dz, float(zmin), config.Nz,
            1.0 / config.dr, 0.0, config.Nr)


def deposit_rho_spect(config, aux, species, species_configs, zmin,
                      sorts=None, fused=None):
    """Charge of all species -> filtered-free spectral rho (Nm, Nz, Nr),
    summed in species order.

    fused: optional {species_index: raw rho} from the fused sorted
    deposits; sorts: optional {species_index: legacy column-sort plan}
    for deposit_rho_sorted; every other species is scatter-deposited."""
    rho = None
    for i, (sp, sc) in enumerate(zip(species, species_configs)):
        if fused and i in fused:
            contrib = fused[i]
        elif sorts and i in sorts:
            contrib = deposit_rho_sorted(
                sorts[i], sp.x, sp.y, sp.z, sp.w, sc.q,
                *_deposit_args(config, zmin), aux.ruyten_linear,
                zfold=_zfold(config))
        else:
            contrib = deposit_rho_linear(
                sp.x, sp.y, sp.z, sp.w, sc.q, *_deposit_args(config, zmin),
                aux.ruyten_linear, zfold=_zfold(config), comp=_comp_of(sp))
        rho = contrib if rho is None else rho + contrib
    if rho is None:
        rho = torch.zeros((config.Nm, config.Nz, config.Nr),
                          dtype=aux.S_w.dtype, device=aux.S_w.device)
        rho = torch.complex(rho, rho)
    return tr.interp2spect_scal(aux.mats, rho * aux.invvol[:, None, :])


def deposit_J_spect(config, aux, species, species_configs, zmin,
                    sorts=None, fused=None):
    """Current of all species -> spectral (Jp, Jm, Jz), summed in
    species order (fused / sorts / scatter as in deposit_rho_spect)."""
    JrJtJz = None
    for i, (sp, sc) in enumerate(zip(species, species_configs)):
        if fused and i in fused:
            contrib = fused[i]
        elif sorts and i in sorts:
            contrib = deposit_J_sorted(
                sorts[i], sp.x, sp.y, sp.z, sp.w, sc.q, sp.ux, sp.uy, sp.uz,
                sp.inv_gamma, *_deposit_args(config, zmin),
                aux.ruyten_linear, zfold=_zfold(config))
        else:
            contrib = deposit_J_linear(
                sp.x, sp.y, sp.z, sp.w, sc.q, sp.ux, sp.uy, sp.uz,
                sp.inv_gamma, *_deposit_args(config, zmin),
                aux.ruyten_linear, zfold=_zfold(config), comp=_comp_of(sp))
        JrJtJz = (list(contrib) if JrJtJz is None
                  else [a + b for a, b in zip(JrJtJz, contrib)])
    if JrJtJz is None:
        z = torch.zeros((config.Nm, config.Nz, config.Nr),
                        dtype=aux.S_w.dtype, device=aux.S_w.device)
        JrJtJz = [torch.complex(z, z)] * 3
    Jr, Jt, Jz = [a * aux.invvol[:, None, :] for a in JrJtJz]
    return tr.interp2spect_J_fields(aux.mats, Jr, Jt, Jz)


def push_fields(config, aux, spect, use_true_rho):
    """PSATD E/B advance + rho_prev <- rho_next."""
    if config.use_comoving:
        Ep, Em, Ez, Bp, Bm, Bz = ps.push_eb_comoving(
            spect.Ep, spect.Em, spect.Ez, spect.Bp, spect.Bm, spect.Bz,
            spect.Jp, spect.Jm, spect.Jz, spect.rho_prev, spect.rho_next,
            aux.rho_prev_coef, aux.rho_next_coef, aux.j_coef,
            aux.C, aux.S_w, aux.T_eb, aux.T_cc, aux.T_rho,
            aux.kr, aux.kz, config.dt, config.v_comoving,
            use_true_rho=use_true_rho)
    else:
        Ep, Em, Ez, Bp, Bm, Bz = ps.push_eb_standard(
            spect.Ep, spect.Em, spect.Ez, spect.Bp, spect.Bm, spect.Bz,
            spect.Jp, spect.Jm, spect.Jz, spect.rho_prev, spect.rho_next,
            aux.rho_prev_coef, aux.rho_next_coef, aux.j_coef,
            aux.C, aux.S_w, aux.kr, aux.kz, config.dt,
            use_true_rho=use_true_rho)
    return replace(spect, Ep=Ep, Em=Em, Ez=Ez, Bp=Bp, Bm=Bm, Bz=Bz,
                   rho_prev=spect.rho_next,
                   rho_next=torch.zeros_like(spect.rho_next))


def correct_currents(config, aux, spect, drho=None):
    """Curl-free current correction.  `drho`: the directly-deposited
    rho_next - rho_prev (float32 runs)."""
    if config.current_correction != "curl-free":
        raise NotImplementedError(config.current_correction)
    if config.use_comoving:
        Jp, Jm, Jz = ps.correct_currents_curlfree_comoving(
            spect.rho_prev, spect.rho_next, spect.Jp, spect.Jm, spect.Jz,
            aux.kz, aux.kr, aux.inv_k2, aux.j_corr_coef, aux.T_eb,
            aux.T_cc, 1.0 / config.dt)
    else:
        Jp, Jm, Jz = ps.correct_currents_curlfree_standard(
            spect.rho_prev, spect.rho_next, spect.Jp, spect.Jm, spect.Jz,
            aux.kz, aux.kr, aux.inv_k2, 1.0 / config.dt, drho=drho)
    return replace(spect, Jp=Jp, Jm=Jm, Jz=Jz)


def spect2interp_EB(aux, spect, interp):
    Er, Et, Ez, Br, Bt, Bz = tr.spect2interp_EB_fields(
        aux.mats, spect.Ep, spect.Em, spect.Ez, spect.Bp, spect.Bm, spect.Bz)
    return replace(interp, Er=Er, Et=Et, Ez=Ez, Br=Br, Bt=Bt, Bz=Bz)


def interp2spect_EB(aux, interp, spect):
    Ep, Em, Ez, Bp, Bm, Bz = tr.interp2spect_EB_fields(
        aux.mats, interp.Er, interp.Et, interp.Ez,
        interp.Br, interp.Bt, interp.Bz)
    return replace(spect, Ep=Ep, Em=Em, Ez=Ez, Bp=Bp, Bm=Bm, Bz=Bz)


def gather_and_push(config, options, sp, sc, interp, zmin, dt):
    """Gather E,B at a non-resident species' particles (the linear
    gather by index) and Vay-push its momenta."""
    E_B = gather_fields_linear(
        sp.x, sp.y, sp.z, interp, options.rmax_gather,
        1.0 / config.dz, float(zmin), config.Nz, 1.0 / config.dr, 0.0,
        config.Nr, comp=_comp_of(sp))
    if sc.q == 0:
        return sp
    ux, uy, uz, inv_gamma = pp.push_p(sp, E_B[:3], E_B[3:], sc.q, sc.m, dt)
    return sp.replace(ux=ux, uy=uy, uz=uz, inv_gamma=inv_gamma)


def half_push_x(config, sp, zmin):
    if sp.comp_x is not None:
        x, y, z, cx, cy, cz = pp.push_x_compensated(sp, 0.5 * config.dt)
        sp = sp.replace(comp_x=cx, comp_y=cy, comp_z=cz)
    else:
        x, y, z = pp.push_x(sp, 0.5 * config.dt)
    if config.boundaries_z == "periodic":
        Lz = config.Nz * config.dz
        z = float(zmin) + torch.remainder(z - float(zmin), Lz)
    return sp.replace(x=x, y=y, z=z)


# ---------------------------------------------------------------------
# Moving window, open boundaries, continuous injection
# ---------------------------------------------------------------------

_SHIFTED = ("Ep", "Em", "Ez", "Bp", "Bm", "Bz", "rho_prev")


def shift_spectral_fields(config, aux, spect, n_move, rdt):
    """Shift all spectral fields by n_move cells (moving window):
    multiplication by exp(i kz_true dz)^n_move
    (reference: boundaries/moving_window.py:134-276)."""
    ph = aux.kz_true * float(rdt(config.dz) * rdt(n_move))
    shift = torch.complex(torch.cos(ph), torch.sin(ph))[None, :, None]
    return replace(spect, **{n: getattr(spect, n) * shift
                             for n in _SHIFTED})


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


def remove_outside_particles(config, sp, zmin):
    """Mark particles that reached the guard cells as dead (w = 0) and
    park them at the box center (reference removal bounds,
    particle_buffer_handling.py:89-92)."""
    Lz = config.Nz * config.dz
    ng = max(config.n_guard, 1)
    z_lo = float(zmin + ng * config.dz)
    z_hi = float(zmin + Lz - ng * config.dz)
    dead = (sp.z < z_lo) | (sp.z > z_hi)
    ids = (None if sp.ids is None
           else torch.where(dead, torch.zeros_like(sp.ids), sp.ids))
    return sp.replace(
        w=torch.where(dead, torch.zeros_like(sp.w), sp.w),
        z=torch.where(dead, torch.full_like(sp.z, float(zmin + 0.5 * Lz)),
                      sp.z), ids=ids)


def continuous_injection(config, options, sp, inj_cfg, inj_aux, zmin,
                         phi_of, generator, resident):
    """Inject the plasma columns the window uncovered since the last
    exchange.  A non-resident species keeps a stable storage order:
    the columns go into its ring at the cursor ``next_free``, and the
    live in-range particles they overwrite are counted.  A resident
    species' storage order is rewritten by every re-sort, so a cursor
    does not track its free slots: the columns go into dead slots (dead
    first, in storage order), and those that find none are counted.
    A tracked species hands out one id per candidate particle (written
    or not), as fbpic_tpu does (core/step.py:798-801, :844-847).
    Returns (species, count)."""
    rdt = type(zmin)
    # The plane's offset from zmin summed first, as XLA folds fbpic_tpu's
    # constant terms (the plane sits on a column edge: rounding picks
    # the column count)
    z_inject = zmin + ((rdt((config.Nz - config.n_guard) * config.dz)
                        + rdt((3 - config.n_inject) * config.dz))
                       + rdt(config.dt * (options.moving_window_v
                                          - inj_cfg.v_end_plasma)))
    # times the reciprocal, as XLA computes a division by a constant
    n_cols = int(np.clip(np.floor((z_inject - sp.inj_z_end)
                                  * (rdt(1.0) / rdt(inj_cfg.dz_particles))),
                         0, inj_cfg.max_inject_cols))
    new, new_z_end = generate_columns(inj_cfg, inj_aux, sp.inj_z_end,
                                      n_cols, phi_of, generator)
    n_write = new["x"].shape[0]
    col_size = inj_aux.r.shape[0]
    cap = sp.capacity
    dev = sp.x.device
    mask = torch.arange(n_write, device=dev) < n_cols * col_size

    values = {name: new[name] for name in
              ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")}
    for name in ("comp_x", "comp_y", "comp_z"):
        if getattr(sp, name) is not None:
            values[name] = torch.zeros_like(new["x"])
    updates = {}
    if sp.ids is not None:
        values["ids"] = sp.next_id + torch.arange(n_write, device=dev)
        updates["next_id"] = sp.next_id + n_cols * col_size
    if not resident:
        slots = torch.remainder(
            sp.next_free + torch.arange(n_write, device=dev), cap)
        z_lo = float(zmin + max(config.n_guard, 1) * config.dz)
        count = (mask & (sp.w[slots] != 0) & (sp.z[slots] > z_lo)).sum()
        for name, vals in values.items():
            updates[name] = write_ring(getattr(sp, name), sp.next_free,
                                       vals, cap, mask)
    else:
        pos = torch.cumsum(mask.long(), 0) - 1
        dead_order = torch.argsort((sp.w != 0).to(torch.int8), stable=True)
        n_dead = (sp.w == 0).sum()
        slots = dead_order[:n_write]
        ok = torch.zeros(n_write, dtype=torch.bool, device=dev)
        ok[pos[mask]] = True
        ok = ok & (torch.arange(n_write, device=dev) < n_dead)
        count = mask.sum() - ok.sum()
        for name, vals in values.items():
            arr = getattr(sp, name).clone()
            packed = torch.zeros(n_write, dtype=vals.dtype, device=dev)
            packed[pos[mask]] = vals[mask]
            arr[slots] = torch.where(ok, packed, arr[slots])
            updates[name] = arr
    updates["next_free"] = (sp.next_free + n_cols * col_size) % cap
    updates["inj_z_end"] = new_z_end
    return sp.replace(**updates), count


# ---------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------

def _resident_indices(species_configs, options):
    """Species that run the resident column layout: the fused deposit
    on, sort_K > 0, linear shapes, and Simulation's residency flag
    (capacity Nz * sort_K)."""
    if not options.fused_deposit:
        return []
    return [i for i, sc in enumerate(species_configs)
            if sc.resident and sc.sort_K > 0
            and sc.particle_shape == "linear"]


def make_step_fn(config, species_configs, options: StepOptions):
    """Build the single-step function
    ``step(state, aux, inj_auxes, column_angles, generator)``.

    ``column_angles(iteration, species_index, nkey)`` gives the rotation
    of each injected column (see particles/injection.py)."""
    species_configs = tuple(species_configs)
    for sc in species_configs:
        if sc.particle_shape != "linear":
            raise NotImplementedError("only linear shapes are ported")
    resident_idx = _resident_indices(species_configs, options)
    zfold = _zfold(config)

    def step(state: SimState, aux, inj_auxes=(), column_angles=None,
             generator=None) -> SimState:
        dt = config.dt
        rdt = type(state.zmin)
        spect, interp = state.spect, state.interp
        species = list(state.species)
        zmin = state.zmin
        it = state.iteration
        sort_overflow = state.sort_overflow
        ring_overwrite = state.ring_overwrite
        ep = max(1, options.exchange_period)
        do_exchange = it % ep == 0
        # Galilean frame: the grid edge flows vg*dt per step; deposits
        # see it at their own time (fbpic_tpu core/step.py:942-956)
        vg = config.v_galilean
        vg_dt = vg * dt
        zmin_mid = zmin + 0.5 * vg_dt
        zmin_next = zmin + vg_dt

        # --- Open boundaries: every exchange_period steps, remove the
        # particles in the guard cells, inject the columns the moving
        # window uncovered, and re-deposit rho_prev (reference:
        # main.py:435-449).  In between, rho_prev is the window-shifted
        # previous rho_next.
        if config.boundaries_z == "open" and do_exchange:
            species = [remove_outside_particles(config, sp, zmin)
                       for sp in species]
            if options.moving_window_v is not None:
                for i, inj_cfg in enumerate(options.injectors):
                    if inj_cfg is None:
                        continue
                    species[i], count = continuous_injection(
                        config, options, species[i], inj_cfg, inj_auxes[i],
                        zmin, lambda nkey, i=i: column_angles(it, i, nkey),
                        generator, resident=i in resident_idx)
                    ring_overwrite = ring_overwrite + count
            rho_prev = deposit_rho_spect(config, aux, species,
                                         species_configs, zmin)
            if options.filter_currents:
                rho_prev = ps.filter_scalar(rho_prev, aux.filter_z,
                                            aux.filter_r)
            spect = replace(spect, rho_prev=rho_prev)

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
            # Tracking ids ride the sort as their own (int64) channel,
            # after the float ones, which the kernels read in place
            if sp.ids is not None:
                payload.append(sp.ids)

            def full_sort():
                return build_column_sort(sp.z, sp.w, float(zmin),
                                         1.0 / config.dz, config.Nz, K,
                                         payload)

            if sc.resort != "banded":
                sort = full_sort()
            else:
                if config.boundaries_z == "open":
                    # the exchange block rewrote the storage order
                    do_full = do_exchange
                else:
                    do_full = it % 64 == 0
                if do_full:
                    sort = full_sort()
                else:
                    sort = banded_column_resort(
                        [a.reshape(config.Nz, K) for a in payload],
                        float(zmin), 1.0 / config.dz, config.Nz, K, band,
                        zfold=zfold)
                    # Column overflow in the banded re-sort: redo the
                    # exact full sort (host read of the count)
                    if int(sort["n_over"]) > 0:
                        sort = full_sort()
            sort_overflow = sort_overflow + sort["n_over"]
            pad, valid = sort["padded"], sort["valid"]
            comp_kw = ({"comp_x": pad[8], "comp_y": pad[9],
                        "comp_z": pad[10]} if sp.comp_x is not None else {})
            psp = sp.replace(
                x=pad[0], y=pad[1], z=pad[2],
                w=torch.where(valid, pad[3], torch.zeros_like(pad[3])),
                ux=pad[4], uy=pad[5], uz=pad[6], inv_gamma=pad[7], **comp_kw)

            E_B = gather_fields_sorted(
                psp.x, psp.y, psp.z, valid, interp, options.rmax_gather,
                1.0 / config.dz, float(zmin), config.Nz,
                1.0 / config.dr, 0.0, config.Nr, comp=_comp_of(psp),
                zfold=zfold)
            if sc.q != 0:
                ux, uy, uz, inv_gamma = pp.push_p(psp, E_B[:3], E_B[3:],
                                                  sc.q, sc.m, dt)
                psp = psp.replace(ux=ux, uy=uy, uz=uz, inv_gamma=inv_gamma)
            psp = half_push_x(config, psp, zmin_mid)

            # Fused J + rho/d(rho) deposit on the pushed padded arrays
            # (sort_at_start: the sort is half a push behind)
            pad_dep = [psp.x, psp.y, psp.z, psp.w, psp.ux, psp.uy, psp.uz,
                       psp.inv_gamma]
            if psp.comp_x is not None:
                pad_dep += [psp.comp_x, psp.comp_y, psp.comp_z]
            out = deposit_rho_J_sorted(
                dict(valid=valid, padded=pad_dep), psp.x, psp.y, psp.z,
                psp.w, sc.q, psp.ux, psp.uy, psp.uz, psp.inv_gamma,
                0.5 * dt, config.Nm, 1.0 / config.dz, float(zmin_mid),
                config.Nz, 1.0 / config.dr, 0.0, config.Nr,
                aux.ruyten_linear, zfold=zfold, comp=_comp_of(psp),
                with_drho=want_drho, with_rho=not want_drho,
                sort_at_start=True, vz_shift=vg)
            fused_J[i] = out[:3]
            fused_rho[i] = out[3]
            if want_drho:
                fused_drho[i] = out[4]
            psp = half_push_x(config, psp, zmin_next)
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
                ids = pad[-1]
                flat["ids"] = torch.where(valid, ids,
                                          torch.zeros_like(ids)).reshape(-1)
            species[i] = sp.replace(**flat)

        # --- Non-resident species: linear gather, momentum push, first
        # half position push
        for i, sc in enumerate(species_configs):
            if i not in resident_idx:
                species[i] = half_push_x(
                    config, gather_and_push(config, options, species[i], sc,
                                            interp, zmin, dt), zmin_mid)

        # --- Column sort of the non-resident sort_K species at the mid
        # positions (fbpic_tpu core/step.py:1416-1467).  The fused
        # deposit takes the particles through the sort (payload plan);
        # the legacy deposits gather the arrays as they are when they
        # deposit (idx plan), and need an exact-position sort, so a
        # Galilean grid drift sends them to the scatter deposits.
        sorts = {}
        for i, sc in enumerate(species_configs):
            if i in resident_idx or sc.sort_K <= 0:
                continue
            if not (options.fused_deposit or vg == 0.0):
                continue
            sp = species[i]
            payload = None
            if options.fused_deposit:
                payload = [sp.x, sp.y, sp.z, sp.w, sp.ux, sp.uy, sp.uz,
                           sp.inv_gamma]
                if sp.comp_x is not None:
                    payload += [sp.comp_x, sp.comp_y, sp.comp_z]
            sorts[i] = build_column_sort(sp.z, sp.w, float(zmin_mid),
                                         1.0 / config.dz, config.Nz,
                                         sc.sort_K, payload)
            sort_overflow = sort_overflow + sorts[i]["n_over"]

        # --- Fused J + rho / d(rho) deposit of the sorted species (K1,
        # or K3 twice) on their fresh sort
        if options.fused_deposit and sorts:
            derive_rho_next = want_drho
            for i, sort in sorts.items():
                sp, sc = species[i], species_configs[i]
                out = deposit_rho_J_sorted(
                    sort, sp.x, sp.y, sp.z, sp.w, sc.q, sp.ux, sp.uy, sp.uz,
                    sp.inv_gamma, 0.5 * dt, config.Nm, 1.0 / config.dz,
                    float(zmin_mid), config.Nz, 1.0 / config.dr, 0.0,
                    config.Nr, aux.ruyten_linear, zfold=zfold,
                    comp=_comp_of(sp), with_drho=want_drho,
                    with_rho=not derive_rho_next, vz_shift=vg)
                fused_J[i] = out[:3]
                fused_rho[i] = out[3]
                if want_drho:
                    fused_drho[i] = out[4]

        # --- Current at t = (n+1/2) dt
        Jp, Jm, Jz = deposit_J_spect(config, aux, species, species_configs,
                                     zmin_mid, sorts=sorts, fused=fused_J)
        if options.filter_currents:
            Jp, Jm, Jz = ps.filter_vector(Jp, Jm, Jz, aux.filter_z,
                                          aux.filter_r)
        spect = replace(spect, Jp=Jp, Jm=Jm, Jz=Jz)

        # --- float32, species without the fused deposit: their charge at
        # the start-of-step positions, for the grid-difference d(rho)
        scatter_rho1 = {}
        if want_drho:
            for i, (sp, sc) in enumerate(zip(species, species_configs)):
                if i in fused_drho:
                    continue
                x0, y0, z0 = pp.push_x(sp, -0.5 * dt)
                scatter_rho1[i] = deposit_rho_linear(
                    x0, y0, z0, sp.w, sc.q, *_deposit_args(config, zmin),
                    aux.ruyten_linear, zfold=zfold, comp=_comp_of(sp))

        # --- Second half position push of the non-resident species
        species = [sp if i in resident_idx
                   else half_push_x(config, sp, zmin_next)
                   for i, sp in enumerate(species)]

        # --- float32: the per-particle d(rho) of the fused deposits plus
        # the grid differences of the other species
        drho = None
        if want_drho:
            contribs = list(fused_drho.values())
            for i, rho1 in scatter_rho1.items():
                sp, sc = species[i], species_configs[i]
                rho2 = deposit_rho_linear(
                    sp.x, sp.y, sp.z, sp.w, sc.q,
                    *_deposit_args(config, zmin), aux.ruyten_linear,
                    zfold=zfold, comp=_comp_of(sp))
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
                                         species_configs, zmin_next,
                                         sorts=sorts, fused=fused_rho)
            if options.filter_currents:
                rho_next = ps.filter_scalar(rho_next, aux.filter_z,
                                            aux.filter_r)
        spect = replace(spect, rho_next=rho_next)

        if options.correct_currents:
            spect = correct_currents(config, aux, spect, drho=drho)
        spect = push_fields(config, aux, spect, options.use_true_rho)

        # --- Galilean frame: the grid edge has flowed vg*dt this step
        # (no spectral shift: the comoving coefficients advance the
        # fields in the flowing frame).  Before the window comparison, so
        # the window shifts only the excess over the drift.
        zmin = zmin + vg_dt

        # --- Moving window: shift the spectral fields and the grid edge;
        # roll the resident rows so row == column still holds
        mw_zref = state.mw_zref
        if options.moving_window_v is not None:
            mw_zref = mw_zref + options.moving_window_v * dt
            # 1e-3-cell guard: with v = c and dt = dz/c the argument
            # lands on integers (see fbpic_tpu core/step.py)
            n_move = int(np.floor((mw_zref - zmin) / config.dz + 1e-3))
            spect = shift_spectral_fields(config, aux, spect, n_move, rdt)
            zmin = zmin + rdt(n_move) * config.dz
            for ri in resident_idx:
                if species_configs[ri].resort != "banded":
                    continue
                rsp = species[ri]
                rK = species_configs[ri].sort_K
                upd = {n: torch.roll(getattr(rsp, n), -n_move * rK)
                       for n in ARRAY_FIELDS if getattr(rsp, n) is not None}
                if n_move > 0:
                    upd["w"][(config.Nz - n_move) * rK:] = 0.0
                    if "ids" in upd:
                        upd["ids"][(config.Nz - n_move) * rK:] = 0
                species[ri] = rsp.replace(**upd)

        # --- Fields back to the interpolation grid; open-z damping as a
        # skinny spectral correction + elementwise interp profile
        interp = spect2interp_EB(aux, spect, interp)
        if config.boundaries_z == "open" and aux.damp_rows is not None:
            spect = damp_EB_z_skinny(aux, spect, interp)
            prof = aux.damp_z[None, :, None]
            interp = replace(interp, **{
                n: getattr(interp, n) * prof
                for n in ("Er", "Et", "Ez", "Br", "Bt", "Bz")})

        return SimState(
            spect=spect, interp=interp, species=species,
            time=state.time + dt, zmin=zmin, iteration=it + 1,
            mw_zref=mw_zref, sort_overflow=sort_overflow,
            ring_overwrite=ring_overwrite)

    return step


def prepare(config, options, species_configs, state, aux):
    """Before a run of steps: refresh spectral E/B from the interpolation
    grid and deposit rho_prev (reference: main.py:408-415, :435-449)."""
    spect = interp2spect_EB(aux, state.interp, state.spect)
    rho = deposit_rho_spect(config, aux, state.species, species_configs,
                            state.zmin)
    if options.filter_currents:
        rho = ps.filter_scalar(rho, aux.filter_z, aux.filter_r)
    return replace(state, spect=replace(spect, rho_prev=rho))
