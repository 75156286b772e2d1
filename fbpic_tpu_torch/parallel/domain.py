"""z-domain decomposition: slabs, guard exchange and particle migration.

The port of fbpic_tpu's parallel/domain.py.  The z axis is cut into
slabs, one per mesh device.  Each slab runs the full local spectral
solve on its interior extended by n_guard cells at each end; the
finite-order stencil keeps the spectral operator local, so the
wrap-around error stays inside the guards (reference FBPIC:
docs/source/overview/parallelisation.rst).

Per step, between the slab threads (``parallel.group``):
  - E/B guard cells REPLACED from the neighbour's interior (in partial
    interpolation space, fused with the damping pass);
  - corrected J guard strips ADDED into the neighbour's interior;
  - particles that crossed a slab edge migrate through fixed-capacity
    buffers (validity by weight) every exchange period.

Layout (reference boundary_communicator.py:556-620):
    local grid = [ng | nc | interior | nc | ng], ng = nc = n_guard
    consecutive local grids overlap by 2*n_guard cells.

``make_multichip_step`` builds the eager slab loop; ``SlabMultiStep``
runs the same steps in chunks, every step replayed from one CUDA graph
that holds every slab's step, its migration and exchange block
included (fbpic_tpu's fori_loop inside shard_map, the migration under
its ``lax.cond``).

A decomposed state is a list of per-slab ``SimState``: fields
(Nm, Nz_local, Nr) and particle arrays (cap_local,) on the slab's
device, each slab's ``zmin`` the GLOBAL grid edge (as fbpic_tpu keeps it
replicated); the counters are psum'd, so every slab holds the totals.
"""
import dataclasses

import numpy as np
import torch

from ..constants import c
from ..fields.solver import build_field_aux, SpectralFields, InterpFields
from ..particles.compaction import topk_compact
from ..particles.state import ParticleState
from ..core import step as step_mod
from ..core.graph import (ChunkBuffers, capture_graph, check_chunk,
                          has_processes, state_tensors, with_state_tensors,
                          with_z_ends)
from ..core.state import SimState
from ..core.step import ensure_counters
from ..particles.draws import GeneratorDraws
from ..utils import kernels
from .group import SlabGroup


MIGRATION_FIELDS = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")
#: Per-particle channels that migrate with the particle where present
_OPTIONAL_FIELDS = ("ionization_level", "ids", "comp_x", "comp_y", "comp_z")


def local_grid_config(config_global, n_devices, n_guard):
    """GridConfig of one slab (interior + 2*n_guard cells).

    config_global.Nz must be divisible by n_devices.  The slab never
    wraps particles periodically and never folds deposits around its
    own edges: it is an 'open' local box whose boundary handling is
    replaced by the halo exchange."""
    if config_global.Nz % n_devices != 0:
        raise ValueError("Nz must be divisible by the number of devices")
    Nz_int = config_global.Nz // n_devices
    return dataclasses.replace(
        config_global, Nz=Nz_int + 2 * n_guard, n_guard=n_guard,
        boundaries_z="open", nz_damp=0, n_inject=0)


def exchange_guards_replace(fields, g, comm):
    """Replace the z guard cells from the neighbours' interiors.

    fields: list of complex (Nm, Nzl, Nr) tensors.  The strip a
    neighbour needs is my 'nc' region; my guards are overwritten by what
    I receive.  Returns new tensors."""
    Nzl = [F.shape[1] for F in fields]
    to_right = [F[:, n - 2 * g:n - g] for F, n in zip(fields, Nzl)]
    to_left = [F[:, g:2 * g] for F in fields]
    from_left, from_right = comm.shift_both(to_right, to_left)
    out = []
    for F, n, a, b in zip(fields, Nzl, from_left, from_right):
        F = F.clone()
        F[:, :g] = a
        F[:, n - g:] = b
        out.append(F)
    return out


def exchange_guards_add(fields, g, comm):
    """Add the 2g-wide edge strips into the neighbours' matching
    region (left strip first, as fbpic_tpu adds them)."""
    Nzl = [F.shape[1] for F in fields]
    send_right = [F[:, n - 2 * g:] for F, n in zip(fields, Nzl)]
    send_left = [F[:, :2 * g] for F in fields]
    from_left, from_right = comm.shift_both(send_right, send_left)
    out = []
    for F, n, a, b in zip(fields, Nzl, from_left, from_right):
        F = F.clone()
        F[:, :2 * g] += a
        F[:, n - 2 * g:] += b
        out.append(F)
    return out


def sum_guards(fields, g, periodic):
    """Every slab's z-real-space field (complex (Nm, Nzl, Nr), one per
    slab, in rank order) with its neighbours' 2g-wide edge strips added
    into its own (``exchange_guards_add``'s sum, taken outside the slab
    threads): each slab's local deposit becomes the global one on its
    interior.  ``periodic``: the end slabs are neighbours too (a
    periodic box); an open box adds nothing across its ends.  Returns
    new tensors."""
    n = len(fields)
    out = []
    for i, F in enumerate(fields):
        Nzl = F.shape[1]
        F = F.clone()
        if i > 0 or periodic:
            F[:, :2 * g] += fields[(i - 1) % n][:, Nzl - 2 * g:].to(F.device)
        if i < n - 1 or periodic:
            F[:, Nzl - 2 * g:] += fields[(i + 1) % n][:, :2 * g].to(F.device)
        out.append(F)
    return out


def migrate_particles(sp, config_local, zmin, comm, buffer_size,
                      global_open=False, bounds=None):
    """Move the particles that crossed the slab's ownership boundary.

    Ownership: [zmin + g dz, zmin + (Nzl - g) dz), zmin the slab's local
    edge (a numpy scalar of the working dtype).  Outgoing particles are
    compacted into fixed-size buffers (validity by weight) and sent to
    the neighbours; the arrivals are compacted together and written into
    dead slots only (``argsort(w != 0)``, dead first, stable), so a live
    particle is never overwritten.  Every per-particle channel of the
    species (ionization level, ids, Kahan words) migrates.

    global_open: the GLOBAL box has open z boundaries -- the edge slabs
    kill the particles leaving outward instead of wrapping them around
    the ring; otherwise the arrivals that wrapped are shifted by the
    global box length.

    bounds: the ownership bounds (z_lo, z_hi) as 0-d tensors of the
    working dtype (a table row's, ``core.step.plan_exchange``'s values),
    read in place of the host's: the migration then reads nothing from
    the host (the slabs' chunk runner captures it).

    Returns (species, n_lost): the particles dropped because a buffer or
    the dead slots ran out (a 0-d int64 tensor, this slab only)."""
    g, dz, Nzl = config_local.n_guard, config_local.dz, config_local.Nz
    rank, n = comm.rank, comm.size
    if bounds is None:
        rdt = type(zmin)
        z_lo = float(zmin + rdt(g * dz))
        z_hi = float(zmin + rdt((Nzl - g) * dz))
    else:
        z_lo, z_hi = bounds
    names = list(MIGRATION_FIELDS) + [
        f for f in _OPTIONAL_FIELDS if getattr(sp, f) is not None]

    alive = sp.w != 0
    go_left = alive & (sp.z < z_lo)
    go_right = alive & (sp.z >= z_hi)
    kill = torch.zeros_like(go_left)
    if global_open:
        if rank == 0:
            kill = kill | go_left
            go_left = torch.zeros_like(go_left)
        if rank == n - 1:
            kill = kill | go_right
            go_right = torch.zeros_like(go_right)

    arrays = {f: getattr(sp, f) for f in names}
    left_buf, sel_l, taken_l = topk_compact(go_left, buffer_size, arrays)
    right_buf, sel_r, taken_r = topk_compact(go_right, buffer_size, arrays)
    n_lost = (sel_l - taken_l) + (sel_r - taken_r)

    out_mask = go_left | go_right | kill
    w = torch.where(out_mask, torch.zeros_like(sp.w), sp.w)

    # My right-going buffer to my right neighbour, left-going to my left
    got_l, got_r = comm.shift_both([right_buf[f] for f in names],
                                   [left_buf[f] for f in names])
    from_left, from_right = dict(zip(names, got_l)), dict(zip(names, got_r))
    if not global_open:
        Lz_global = (Nzl - 2 * g) * dz * n
        if rank == 0:
            from_left["z"] = torch.where(from_left["w"] != 0,
                                         from_left["z"] - Lz_global,
                                         from_left["z"])
        if rank == n - 1:
            from_right["z"] = torch.where(from_right["w"] != 0,
                                          from_right["z"] + Lz_global,
                                          from_right["z"])

    # Compact the two received buffers together BEFORE any length clamp,
    # so the right buffer's arrivals are never truncated away
    incoming = {f: torch.cat([from_left[f], from_right[f]]) for f in names}
    capacity = sp.capacity
    n_in = min(2 * buffer_size, capacity)
    packed, n_live_in, _ = topk_compact(incoming["w"] != 0, n_in, incoming)

    # Arrival i lands in the i-th dead slot; beyond the dead count it is
    # lost (counted), never written over a live particle
    dead_order = torch.argsort((w != 0).to(torch.int8), stable=True)
    n_dead = (w == 0).sum()
    slots = dead_order[:n_in]
    valid = (packed["w"] != 0) & (
        torch.arange(n_in, device=w.device) < n_dead)
    n_lost = n_lost + (n_live_in - valid.sum())
    updates = {}
    for f in names:
        arr = w if f == "w" else getattr(sp, f)
        arr = arr.clone()
        arr[slots] = torch.where(valid, packed[f].to(arr.dtype), arr[slots])
        updates[f] = arr
    return sp.replace(**updates), n_lost


def default_n_guard(config_global):
    """The finite-order stencil's reach + 1 (reference:
    boundary_communicator.py:240-250); an infinite-order stencil has no
    reach and cannot be decomposed."""
    from ..fields.stencil import get_stencil_reach
    if config_global.n_order == -1:
        raise ValueError(
            "Multi-chip decomposition needs a finite stencil order "
            "(n_order > 0), like the reference's MPI mode.")
    return get_stencil_reach(
        config_global.Nz, config_global.dz, c * config_global.dt,
        config_global.n_order, config_global.v_comoving,
        config_global.use_galilean) + 1


def clamped_exchange_period(config_global, g, exchange_period):
    """The exchange period, clamped so particles stray at most half the
    guard region between two migrations: max(1, int((g/2 - 3) /
    (2 c dt / dz))) (reference: boundary_communicator.py:280-304)."""
    cells_per_step = 2.0 * c * config_global.dt / config_global.dz
    max_period = max(1, int((g / 2 - 3) / cells_per_step))
    return max(1, min(int(exchange_period), max_period))


def _damp_profile_padded(config_global, g):
    """The global open-z damping profile padded by g zero cells at each
    end (a slab's guards beyond the global box are damped to zero), or
    None."""
    if not (config_global.boundaries_z == "open"
            and config_global.nz_damp > 0):
        return None
    from ..fields.solver import _damp_profile_z
    return np.pad(_damp_profile_z(config_global), g, mode="constant")


class Halo:
    """Exchange and global-geometry hooks of slab ``comm.rank`` for the
    decomposed step (core/step.py calls them where fbpic_tpu's step
    calls its Halo)."""

    def __init__(self, comm, config_global, config_local, damp_padded=None):
        self.comm = comm
        self.rank = comm.rank
        self._cg, self._cl = config_global, config_local
        self.g = config_local.n_guard
        self.Nz_int = config_local.Nz - 2 * self.g
        self.global_open = config_global.boundaries_z == "open"
        self._damp_padded = damp_padded
        self._damp = {}

    def exchange_add(self, fields):
        return exchange_guards_add(fields, self.g, self.comm)

    def exchange_replace(self, fields):
        return exchange_guards_replace(fields, self.g, self.comm)

    def psum(self, value):
        return self.comm.psum(value)

    def all_gather(self, value):
        return self.comm.all_gather(value)

    def offset(self, rdt):
        """The slab's local edge minus the global edge, in the working
        dtype: (rank * Nz_int - g) dz."""
        return rdt(self.rank * self.Nz_int - self.g) * rdt(self._cl.dz)

    def global_zmin(self, zmin_local):
        return zmin_local - self.offset(type(zmin_local))

    def removal_bounds(self, zmin_g):
        if not self.global_open:
            return (-np.inf, np.inf)
        ng = max(self._cg.n_guard, 1)
        dz = self._cg.dz
        return (zmin_g + ng * dz, zmin_g + (self._cg.Nz - ng) * dz)

    def grid_globals(self, zmin_g):
        return (zmin_g, self._cg.Nz, self._cg.n_guard, self._cg.n_inject)

    def is_last(self):
        return self.rank == self.comm.size - 1

    def own_bounds(self, zmin_local):
        dz = self._cl.dz
        return (zmin_local + self.g * dz,
                zmin_local + (self._cl.Nz - self.g) * dz)

    def ownership_bounds(self, zmin_local):
        """Half-open z interval of the particles this slab owns, the
        global edges opened to -+inf: the slabs tile the global box, so
        a new particle is written by the one slab that owns its
        position."""
        lo, hi = self.own_bounds(zmin_local)
        if self.rank == 0:
            lo = -np.inf
        if self.is_last():
            hi = np.inf
        return lo, hi

    def damp_profile(self, like):
        """This slab's cut of the padded global damping profile, on the
        device and in the real dtype of tensor ``like``, or None."""
        if self._damp_padded is None:
            return None
        key = (like.device, like.dtype)
        if key not in self._damp:
            s = self.rank * self.Nz_int
            self._damp[key] = torch.as_tensor(
                self._damp_padded[s:s + self._cl.Nz], dtype=like.dtype,
                device=like.device)
        return self._damp[key]


def make_multichip_step(config_global, species_configs, options, mesh,
                        axis_name="z", migration_buffer=None, n_guard=None,
                        capture_fns=(), group=None):
    """Build the decomposed N-step function over ``mesh``: the eager slab
    loop, every step run from Python on each slab's thread.
    ``SlabMultiStep`` replays the same steps from CUDA graphs.

    config_global: the full-box grid config (for open z its Nz already
    includes the edge guard / damp / injection cells, as in the
    single-card Simulation).  Each slab owns Nz / n interior cells plus
    2 n_guard halo cells; n_guard defaults to the stencil reach + 1.
    The exchange period is clamped (``clamped_exchange_period``) and the
    migration buffer defaults to max(2048, (period + 1) max(sort_K,
    256)) slots.

    capture_fns: callables ``cap(state_local, aux, comm)`` evaluated by
    every slab after every step, the state's ``zmin`` the slab's LOCAL
    edge (the back-transformed diagnostics' captures; each reduces over
    the slabs itself); a capture function returns the tuple of tensors
    to keep (or None).

    Returns (multi_step, config_local) with
    ``multi_step(states, auxes, n_steps, slab_kwargs=None,
    capture=None)``: states and auxes one per slab (a slab's aux on its
    device; slabs sharing a device may share one), slab_kwargs one dict
    per slab of the step function's keyword arguments (inj_auxes,
    column_angles, generator, antenna_series, ion_auxes, comp_auxes,
    draws).  Returns the new per-slab states.  ``capture(rank, state,
    aux)``, if given, is called after each step in place of the capture
    functions.  ``multi_step.group``, ``.halos``, ``.step_fns``,
    ``.migrate``, ``.capture_fns``, ``.config_local``, ``.options``,
    ``.exchange_period`` and ``.migration_buffer`` are exposed."""
    n = mesh.size
    if n_guard is None:
        n_guard = default_n_guard(config_global)
    g = int(n_guard)
    config_local = local_grid_config(config_global, n, g)
    global_open = config_global.boundaries_z == "open"
    exchange_period = clamped_exchange_period(config_global, g,
                                              options.exchange_period)
    options = dataclasses.replace(options, exchange_period=exchange_period)
    if migration_buffer is None:
        occ = max((sc.sort_K for sc in species_configs), default=0)
        migration_buffer = max(2048, (exchange_period + 1) * max(occ, 256))
    group = group or SlabGroup(mesh.devices)
    damp_padded = _damp_profile_padded(config_global, g)
    halos = [Halo(group.comm(r), config_global, config_local, damp_padded)
             for r in range(n)]
    step_fns = [step_mod.make_step_fn(config_local, species_configs, options,
                                      halo=h) for h in halos]

    def migrate(rank, state, bounds=None):
        """The state (``zmin`` the global edge) with its ``zmin`` the
        slab's local edge, its particles migrated every exchange period
        (the cadence of removal, injection and the fresh rho_prev in the
        base step; the guard clamp keeps strays inside the halo in
        between) and the psum'd losses added to migration_overflow.
        ``bounds``: the slab's ownership bounds as 0-d tensors
        (``migrate_particles``)."""
        halo = halos[rank]
        zmin_local = state.zmin + halo.offset(type(state.zmin))
        species = list(state.species)
        overflow = state.migration_overflow
        if state.iteration % exchange_period == 0:
            n_lost = torch.zeros((), dtype=torch.int64,
                                 device=overflow.device)
            for i, sp in enumerate(species):
                species[i], lost = migrate_particles(
                    sp, config_local, zmin_local, halo.comm,
                    migration_buffer, global_open=global_open,
                    bounds=bounds)
                n_lost = n_lost + lost
            overflow = overflow + halo.psum(n_lost)
        return dataclasses.replace(state, species=species, zmin=zmin_local,
                                   migration_overflow=overflow)

    def local_step(rank, state, aux, kw):
        zmin_global = state.zmin
        state = migrate(rank, state)
        zmin_local = state.zmin
        # The local PIC cycle (the halo exchanges happen inside)
        state = step_fns[rank](state, aux, **kw)
        return state, zmin_global + (state.zmin - zmin_local)

    def multi_step(states, auxes, n_steps, slab_kwargs=None, capture=None):
        kwargs = slab_kwargs or [{}] * n

        def slab(rank):
            state = with_migration_counter(states[rank])
            for _ in range(n_steps):
                state, zmin_g = local_step(rank, state, auxes[rank],
                                           kwargs[rank])
                if capture is not None:
                    capture(rank, state, auxes[rank])
                else:
                    for cap in capture_fns:
                        cap(state, auxes[rank], halos[rank].comm)
                state = dataclasses.replace(state, zmin=zmin_g)
            return state

        return group.run(slab)

    multi_step.group = group
    multi_step.halos = halos
    multi_step.step_fns = step_fns
    multi_step.migrate = migrate
    multi_step.capture_fns = tuple(capture_fns)
    multi_step.config_local = config_local
    multi_step.options = options
    multi_step.exchange_period = exchange_period
    multi_step.migration_buffer = migration_buffer
    return multi_step, config_local


def with_migration_counter(state):
    """``state`` with its migration_overflow a 0-d int64 device tensor."""
    if state.migration_overflow is not None:
        return state
    return dataclasses.replace(state, migration_overflow=torch.zeros(
        (), dtype=torch.int64, device=state.spect.Ez.device))


class SlabMultiStep:
    """The chunk runner of the slabs: fbpic_tpu's ``shard_map``'d step
    chunk (its parallel/domain.py ``make_multichip_step``, a fori_loop
    inside shard_map), the decomposed counterpart of core/graph.py's
    ``MultiStep``, built on the eager slab loop ``multi_step`` of
    ``make_multichip_step``.

    ``runner(states, auxes, n_steps, slab_kwargs, live_counts=(),
    eager=False, eager_exchange=False)`` runs n_steps <= MAX_CAPTURE
    steps from the per-slab
    ``states`` (each slab's ``zmin`` the global edge; left unchanged)
    and returns (the new states, counts), counts the host values of the
    chunk's one read: ``resort_redo`` (the slabs' redo flags),
    ``migration_overflow``, ``sort_overflow`` and ``ring_overwrite``
    (slab 0's psum'd totals after the chunk), ``live`` ({species index:
    [its live particles on each slab]} for each index in
    ``live_counts``), ``rolled_back`` and ``captures`` (each capture
    function's outputs stacked over the chunk's steps, from slab 0).

    - Every step is the step with its StepScalars taken from each
      slab's own tables (``ChunkBuffers`` with the slab's halo: its
      local grid edges), the banded re-sort's overflow added into each
      slab's redo flag, on each slab's static buffers.  Its exchange
      block is inside: the migration every exchange period (its
      ownership bounds from the table, the losses psum'd into
      ``migration_overflow``) and, where the step's plan says so
      (``plan_step``: every exchange period on a slab, whose local box
      is open), the base step's exchange block (removal, injection with
      its generator's draws, a fresh rho_prev), their values the
      table's (``core.step.plan_exchange``).  With ``eager_exchange``
      (``DistributedRun.graph_blockers``' ``exchange`` reasons)
      both run eagerly in the slab threads before the step's graph
      instead.  On CUDA, with every slab on one card, one graph per
      variant holds every slab's step: the main thread opens the
      capture and each slab thread issues its step into the capture
      stream (``SlabGroup.run(fn, stream)``); the collectives resolve
      during the capture as they do eagerly (tensors by reference, the
      exchanges and sums device ops in stream order; the barrier orders
      the threads' issue, so a sender's writes come before a receiver's
      reads in the one stream).  A replay is one graph launch a step for
      every slab, with no thread and no barrier.  On the CPU the slab
      threads call the same body.  A variant's key is every slab's
      (n_move, full re-sort, exchange block inside); the exchange
      variants register each slab's injection generator.
    - The capture functions (``cap(state, aux, comm)``) see the state
      after each step with its time and local grid edge as 0-d tensors
      of the table row; slab 0 writes their outputs into its static
      buffers at the device step index, copied to pinned host memory
      before the chunk's one read.
    - The chunk's one read stacks every slab's redo flag, slab 0's
      counters and the live counts; a flag above 0 runs the chunk again
      from its input states through the eager slab loop (every slab,
      the generators' states restored), its captures with it.
      ``eager``: the chunk through the eager slab loop from the start
      (with the same read, captures and buffers).

    The kernel counters of a capture are taken back out, per slab too,
    and added again at every replay.  A capture that fails, a host
    synchronization in any slab's step during the capture, or a slab
    that raises, raises."""

    def __init__(self, multi_step, species_configs):
        self.eager_loop = multi_step
        self.group = multi_step.group
        self.halos = multi_step.halos
        self.step_fns = multi_step.step_fns
        self.capture_fns = multi_step.capture_fns
        self.exchange_period = multi_step.exchange_period
        self.species_configs = tuple(species_configs)
        self._processes = has_processes(self.species_configs)
        self.bufs = [ChunkBuffers(multi_step.config_local,
                                  self.species_configs, multi_step.options,
                                  halo=h) for h in self.halos]
        #: variant key (every slab's (n_move, full re-sort, exchange
        #: block inside)) -> (graph, launch counts)
        self.graphs = {}
        self._pool = self._side = None
        self._generators = []

    @property
    def size(self):
        return len(self.halos)

    # -----------------------------------------------------------------
    def __call__(self, states, auxes, n_steps, slab_kwargs, live_counts=(),
                 eager=False, eager_exchange=False):
        check_chunk(n_steps)
        states = [ensure_counters(with_migration_counter(s)) for s in states]
        series = [kw.get("antenna_series", ()) for kw in slab_kwargs]
        self._ensure_static(states, auxes, series)
        plans, edges = [], []
        for b, st, ser, kw in zip(self.bufs, states, series, slab_kwargs):
            p, rows, irows = b._plan(st, n_steps, ser, self.exchange_period)
            b._upload(rows, irows)
            plans.append(p)
            edges.append(b._edges)
        kws = [dict(kw, antenna_series=b._load_series(ser))
               for kw, b, ser in zip(slab_kwargs, self.bufs, series)]
        gens = [g for kw in slab_kwargs
                for g in (kw.get("generator"),
                          getattr(kw.get("draws"), "generator", None))
                if g is not None]
        self._generators = [kw["draws"].generator for kw in slab_kwargs
                            if self._processes
                            and isinstance(kw.get("draws"), GeneratorDraws)]
        self._inject_generators = [
            kw["generator"] for kw in slab_kwargs
            if self.bufs[0]._injecting and kw.get("generator") is not None]
        gen_states = [g.get_state() for g in gens]
        redo = [0] * self.size
        if not eager:
            curs = self._run_graphed(states, auxes, kws, plans, edges,
                                     eager_exchange)
            vals = self._read(curs, live_counts, flags=True)
            redo, vals = vals[:self.size], vals[self.size:]
        if eager or any(r > 0 for r in redo):
            # The chunk again from its input states through the eager
            # slab loop (which redoes any sort) and its captures with it
            for g, st in zip(gens, gen_states):
                g.set_state(st)
            for b in self.bufs:
                b._index.zero_()
            out = self.eager_loop(states, auxes, n_steps, kws,
                                  capture=self._eager_capture)
            self.bufs[0]._copy_captures(n_steps)
            vals = self._read(out, live_counts)
        else:
            out = [with_state_tensors(c, [s.clone() for s in b._static])
                   for c, b in zip(curs, self.bufs)]
        lost, n_sort, n_ring, *live = vals
        live = {i: live[k * self.size:(k + 1) * self.size]
                for k, i in enumerate(live_counts)}
        return out, dict(resort_redo=redo, migration_overflow=lost,
                         sort_overflow=n_sort, ring_overwrite=n_ring,
                         live=live, rolled_back=not eager and any(
                             r > 0 for r in redo),
                         exchanged=any(p.exchange for p in plans[0]),
                         captures=self.bufs[0]._captures(n_steps))

    def release(self):
        """Drop the graphs (their memory pool goes with the last) and the
        static buffers."""
        for graph, _ in self.graphs.values():
            graph.reset()
        self.graphs = {}
        self._pool = self._side = None
        for b in self.bufs:
            b._drop_buffers()

    # -----------------------------------------------------------------
    def _ensure_static(self, states, auxes, series):
        """Every slab's buffers; slab 0's capture buffers shaped by one
        capture of the input states (its collectives need every slab)."""
        samples = [()] * self.size
        if self.bufs[0]._signature is None and self.capture_fns:
            def sample(r):
                st = states[r]
                st = dataclasses.replace(st, zmin=st.zmin + self.halos[
                    r].offset(type(st.zmin)))
                outs = [cap(st, auxes[r], self.halos[r].comm)
                        for cap in self.capture_fns]
                return [o for o in outs if o is not None]
            samples[0] = self.group.run(sample)[0]
        for b, st, ser, smp in zip(self.bufs, states, series, samples):
            b._ensure_static(st, ser, smp)

    def _run_graphed(self, states, auxes, kws, plans, edges,
                     eager_exchange=False):
        """The chunk on the static buffers, every step replayed (or, on
        the CPU, run by the slab threads), its migration and exchange
        block inside -- or, with ``eager_exchange``, run eagerly in the
        slab threads before it.  Returns the slabs' states on their
        static buffers (``zmin`` the global edge)."""
        for b, st in zip(self.bufs, states):
            for s, t in zip(b._static, state_tensors(st)):
                s.copy_(t)
            b._flag.zero_()
            b._index.zero_()
        curs = [with_state_tensors(st, b._static)
                for st, b in zip(states, self.bufs)]
        for k, step_plans in enumerate(zip(*plans)):
            plan = step_plans[0]
            local = [e[k][0] for e in edges]
            block = (curs[0].iteration % self.exchange_period == 0
                     or plan.exchange)
            if block and eager_exchange:
                def run_block(r, plan=plan):
                    st = self.eager_loop.migrate(r, curs[r])
                    if plan.exchange:
                        kw = kws[r]
                        st = self.step_fns[r].exchange(
                            st, auxes[r], kw.get("inj_auxes", ()),
                            kw.get("column_angles"), kw.get("generator"))
                    self.bufs[r]._store(st)
                    return with_state_tensors(st, self.bufs[r]._static)
                curs = self.group.run(run_block)
            elif not block:
                curs = [dataclasses.replace(c, zmin=z)
                        for c, z in zip(curs, local)]
            inside = block and not eager_exchange
            key = tuple((p.n_move, p.full_resort, inside)
                        for p in step_plans)
            self._graphed(key, curs, auxes, kws, inside)
            curs = [dataclasses.replace(
                c, time=p.time_end, zmin=e[k][1], mw_zref=p.mw_zref_end,
                iteration=c.iteration + 1,
                species=with_z_ends(c.species, b._z_ends[k]))
                for c, p, e, b in zip(curs, step_plans, edges, self.bufs)]
        self.bufs[0]._copy_captures(len(plans[0]))
        return curs

    def _body(self, r, cur, aux, kw, inside):
        """Slab r's step on its static buffers: with ``inside`` its
        migration and exchange block first (``cur``'s zmin the global
        edge; their values from the slab's table row), else on ``cur``
        as it is (zmin the local edge, an exchange step's block already
        run); its scalars from its tables' row, the banded re-sort's
        overflow into its flag, the result copied back, the captures,
        its index advanced."""
        b = self.bufs[r]
        row, irow = b._row()
        scalars = b._scalars(row, irow)
        if inside:
            cur = self.eager_loop.migrate(
                r, cur, bounds=scalars.exchange.migration)
        new = self.step_fns[r](cur, aux, scalars=scalars,
                               redo_flag=b._flag, exchanged=not inside, **kw)
        b._store(new)
        self._capture(r, with_state_tensors(new, b._static), aux, row)
        b._index.add_(1)

    def _capture(self, r, state, aux, row):
        """The capture functions of slab r's state after a step, its time
        and local grid edge those of the table row; slab 0 keeps their
        outputs."""
        if not self.capture_fns:
            return
        time, zmin = ChunkBuffers._end_values(row)
        state = dataclasses.replace(state, time=time, zmin=zmin)
        outs = [cap(state, aux, self.halos[r].comm)
                for cap in self.capture_fns]
        if r == 0:
            self.bufs[0]._write_captures([o for o in outs if o is not None])

    def _eager_capture(self, r, state, aux):
        b = self.bufs[r]
        self._capture(r, state, aux, b._row()[0])
        b._index.add_(1)

    def _graphed(self, key, curs, auxes, kws, inside):
        """Every slab's step of variant ``key`` (its migration and
        exchange block with it, ``inside``): the body in the slab
        threads on the CPU; on CUDA a replay, or, at the variant's first
        step, its warm-up (the slabs' steps, eagerly, on a side stream)
        and its capture, the generators of the draws registered with it
        (the processes', and with ``inside`` the injection's)."""
        def body(r):
            self._body(r, curs[r], auxes[r], kws[r], inside)
        dev = self.bufs[0]._table.device
        if dev.type != "cuda":
            self.group.run(body)
            return
        if key in self.graphs:
            graph, counts = self.graphs[key]
            graph.replay()
            kernels.add_launches(*counts)
            return
        if self._side is None:
            self._side = torch.cuda.Stream(device=dev)
            self._pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(dev)
        self._side.wait_stream(main)
        self.group.run(body, stream=self._side)
        main.wait_stream(self._side)
        self.graphs[key] = capture_graph(
            lambda stream: self.group.run(body, stream=stream), self._pool,
            self._generators + (self._inject_generators if inside else []),
            f"the slabs' step (n_move, full re-sort, exchange block "
            f"inside: {key})")

    def _read(self, states, live_counts, flags=False):
        """The chunk's one host read: every slab's redo flag (with
        ``flags``), slab 0's migration, sort and ring counters (psum'd:
        every slab holds the totals), each slab's live count of each
        species in ``live_counts``, stacked on slab 0's device."""
        dev = states[0].sort_overflow.device
        vals = [b._flag for b in self.bufs] if flags else []
        st0 = states[0]
        vals += [st0.migration_overflow, st0.sort_overflow,
                 st0.ring_overwrite]
        vals += [(st.species[i].w != 0).sum() for i in live_counts
                 for st in states]
        return torch.stack([v.to(dev) for v in vals]).tolist()


def local_aux(config_local, **kwargs):
    """Field aux of one slab (build_field_aux of the local config; pass
    device= and dtype=)."""
    return build_field_aux(config_local, **kwargs)


def build_multichip_state(config_global, config_local, n_devices,
                          particles_by_species, zmin_global=0.0,
                          cap_local=None, *, devices, dtype=torch.float64):
    """The per-slab SimStates of a decomposed run from global particles.

    particles_by_species: one dict per species of numpy arrays x, y, z,
    ux, uy, uz, inv_gamma, w (global); each slab gets the particles
    whose z falls in its interior (clamped at the ends), packed at the
    front of a block of cap_local slots (default: 1.3 times the fullest
    slab's count, rounded up to 256).  Fields start at zero; ``devices``
    holds each slab's device."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    Nz_int = config_local.Nz - 2 * config_local.n_guard
    Lz_int = Nz_int * config_local.dz
    blocks = []
    for arrays in particles_by_species:
        z = np.asarray(arrays["z"])
        dev = np.clip(((z - zmin_global) // Lz_int).astype(int), 0,
                      n_devices - 1)
        max_count = max(int((dev == i).sum()) for i in range(n_devices))
        cap = cap_local or int(-(-(int(1.3 * max_count) + 1) // 256) * 256)
        per = []
        for i in range(n_devices):
            sel = dev == i
            cnt = int(sel.sum())
            b = {k: np.zeros(cap) for k in MIGRATION_FIELDS}
            b["inv_gamma"][:] = 1.0
            for k in MIGRATION_FIELDS:
                b[k][:cnt] = np.asarray(arrays[k])[sel]
            per.append(b)
        blocks.append(per)
    states = []
    for i in range(n_devices):
        device = torch.device(devices[i])
        species = [ParticleState(**{
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in per[i].items()}) for per in blocks]
        states.append(SimState(
            spect=SpectralFields.zeros(config_local, device, dtype),
            interp=InterpFields.zeros(config_local, device, dtype),
            species=species, time=np_dtype(0.0),
            zmin=np_dtype(zmin_global), iteration=0,
            mw_zref=np_dtype(zmin_global),
            sort_overflow=torch.zeros((), dtype=torch.int64, device=device),
            ring_overwrite=torch.zeros((), dtype=torch.int64,
                                       device=device),
            migration_overflow=torch.zeros((), dtype=torch.int64,
                                           device=device)))
    return states
