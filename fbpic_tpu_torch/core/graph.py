"""Device-resident chunks of steps: fbpic_tpu's ``make_multi_step`` on
CUDA graphs.

fbpic_tpu runs ``step(N)`` as device programs of up to 250 steps, each
one XLA ``lax.fori_loop`` over the jitted step (fbpic_tpu
core/step.py:1794-1815, core/simulation.py:880-957); the host reads the
counters once per call.  ``MultiStep`` is the port's counterpart: it
runs a chunk of up to ``MAX_CAPTURE`` steps with one host read at its
end.

- Every step replays a captured ``torch.cuda.CUDAGraph`` of the step,
  an exchange step's exchange block (removal, continuous injection and
  a fresh rho_prev, every ``exchange_period`` steps of an open-z run,
  fbpic_tpu's ``lax.cond`` inside its program) included.  There is one
  graph per variant, keyed by what the host decides for a step
  (``plan_step``): the window's shift ``n_move``, the full re-sort (of
  an exchange step, or of a periodic run every 64 steps) and whether
  the exchange block is inside.  All of them share one
  memory pool: a graph's temporaries are dead when its replay ends (its
  results are copied into the static buffers, outside the pool), and
  the replays run one after the other on one stream.
- The exchange block stays eager (run from Python before its step's
  graph, ``step.exchange``) where ``graph_blockers`` names an
  ``exchange`` reason: a user's density function that the probe
  sent to the host (it gets numpy arrays, fbpic_tpu's
  ``pure_callback``), or a column angle source other than the
  simulation's ``GeneratorAngles`` (it may read the host iteration).
- The step's scalars (``StepScalars``: zmin at the gather, the J
  deposit, rho_next and the step's end, the time, the window's
  reference, the processes' time t + dt/2, each ballistic species'
  injection plane, each mirror's zeroed interval, each laser antenna's
  slice, cells and weights, and the exchange block's values --
  ``plan_exchange``: the removal bounds, each injecting species' column
  count, column start and ring bound, a slab's ownership and migration
  bounds) come from per-chunk tables, uploaded once
  per chunk; the row is picked by a device step index that every step
  of the chunk advances, so a replay reads its own step's values.  The
  host keeps its own arithmetic for them and for the variant keys, and
  never reads them back: it advances the injection fronts
  (``inj_z_end``) as the eager block does.  The injecting species'
  cursors are 0-d device tensors of the state, which a replayed
  injection advances.  The antennas' current series are copied into
  static buffers once a chunk.
- Ionization and Compton scattering run inside the graphed steps (their
  created counts, cursors and ids are device tensors of the state).
  Their draws, and the injection's angles and thermal momenta, come
  from the simulation's ``torch.Generator`` (``GeneratorDraws``,
  ``GeneratorAngles``), which is registered with every graph that
  draws: each replay draws from the generator's Philox offset at its
  launch and advances it as the eager step would, so a graphed run
  draws the eager run's numbers.
- The capture functions (``make_multi_step_capture``: the
  back-transformed fields' plane slices, fbpic_tpu's lax.scan outputs)
  write the state after each step into static buffers at the step
  index's row; their rows come back to the host with the chunk's one
  read.
- The banded re-sort's overflow, which fbpic_tpu redoes inside its
  program with a ``lax.cond`` (a full sort), is added into a device flag
  instead.  The chunk's one read (the flag, sort_overflow and
  ring_overwrite, stacked) sees it; if the flag is above 0, the chunk
  is run again from its start through the eager step, which redoes the
  sort as it always does.  The result equals the eager run's in every
  case.  The chunk's input state is kept aside for that, untouched: the
  chunk runs on its copy in the static buffers, and the generator's
  state (the injection's and the draws') is saved with it.
- The live counts of the species the caller names (the process targets'
  rings, which grow between calls) are stacked into the chunk's one
  read.

The graphs read and write static buffers: one tensor for each tensor of
the state (fields, particle arrays, counters).  A graph ends with its
own copy of the step's results into them, so replays chain without the
host.  The chunk copies its input state into them, and its result out
of them into new tensors, so nothing a caller holds is overwritten by a
later replay.  Each variant is warmed up before its capture: its first
step runs eagerly, on a side stream (the lazy set-ups -- the kernels'
libraries, their shared-memory grants, cuFFT plans, cached constants --
happen there), and is that step's real execution; the capture, which
executes nothing, follows under torch's sync debug mode "error", so a
host synchronization in the step raises where it is made.  A capture
that fails raises; nothing falls back to the eager loop.

The kernel wrappers count their launches in Python, which a replay does
not run: the counts a capture made are taken back out and added again
at every replay (``utils.kernels.add_launches``).

Every graph holds the step's device spans (utils/profiling.py): their
marker kernels are captured always, and a runner's ``GraphMarkers``
turns the marker nodes on while a torch profiler records and off
otherwise, at the start of a call whose profiler state changed (the
graphs are captured with ``keep_graph`` and instantiated after, for
that).  A call's parts are host spans (``chunk``: ``plan``,
``stage_in``, one ``replay`` a step, ``read``, ``stage_out`` or
``rollback``; ``capture``).

On CPU tensors the same runner calls the graph's body instead of
replaying it: the table, the step index, the flag and the rollback are
the same; only the capture is CUDA-only.

The slabs' runner (parallel/domain.py ``SlabMultiStep``) keeps one
``ChunkBuffers`` per slab and captures one graph a card at once through
``capture_graphs``, the migration inside the exchange variants.
"""
import contextlib
import gc
from dataclasses import fields, replace
from typing import NamedTuple

import torch

from ..lpa_utils.laser.antenna_injection import antenna_cells
from ..particles.draws import GeneratorDraws
from ..particles.injection import GeneratorAngles
from ..utils import kernels, profiling
from ..utils.profiling import mark, span
from .step import (ExchangePlan, StepScalars, ballistic_plane,
                   ensure_counters, make_step_fn, mirror_planes, plan_exchange,
                   plan_step, process_time)

#: Most steps in one chunk (fbpic_tpu's step chunk cap)
MAX_CAPTURE = 250
#: The real table's first columns: zmin, zmin_mid, zmin_next, time,
#: mw_zref, zmin_end, time_end, time_mid (then each ballistic species'
#: plane, each mirror's two, each antenna's three, the exchange block's)
_N_BASE = 8
_ZMIN_END, _TIME_END, _TIME_MID = 5, 6, 7


def state_tensors(state):
    """Every tensor of a SimState, in a fixed order: the spectral and
    interpolation fields, each species' tensors, the counters."""
    out = []
    for part in [state.spect, state.interp] + list(state.species):
        out += [v for v in (getattr(part, f.name) for f in fields(part))
                if torch.is_tensor(v)]
    return out + [v for v in (state.sort_overflow, state.ring_overwrite,
                              state.migration_overflow)
                  if torch.is_tensor(v)]


def with_state_tensors(state, tensors):
    """``state`` with its tensors (``state_tensors``' order) replaced by
    ``tensors``; its host values kept."""
    it = iter(tensors)

    def sub(part):
        return replace(part, **{f.name: next(it) for f in fields(part)
                                if torch.is_tensor(getattr(part, f.name))})

    spect, interp = sub(state.spect), sub(state.interp)
    species = [sub(sp) for sp in state.species]
    counters = {n: next(it) for n in ("sort_overflow", "ring_overwrite",
                                      "migration_overflow")
                if torch.is_tensor(getattr(state, n))}
    return replace(state, spect=spect, interp=interp, species=species,
                   **counters)


def signature(state):
    """(shape, dtype, device) of every tensor of a state: what the static
    buffers of a MultiStep are built for."""
    return tuple((tuple(t.shape), t.dtype, t.device)
                 for t in state_tensors(state))


def has_processes(species_configs):
    """Whether a species ionizes or scatters photons (its draws then come
    from a generator that every graph registers)."""
    return any(sc.ionizer is not None or sc.compton is not None
               for sc in species_configs)


class ChunkBuffers:
    """What a chunk runner keeps for one state (one device's, or one
    slab's): the static buffers the steps run on, the per-chunk scalar
    tables and the device step index that picks their row, the redo
    flag, the antennas' static series buffers and the capture buffers
    (with their pinned host copies).  ``halo``: the slab's hooks in a
    z-decomposed run (parallel/domain.py); its table rows are then the
    slab's own (its local grid edges; an antenna plane it owns or not)."""

    def __init__(self, config, species_configs, options, halo=None):
        self.config, self.options = config, options
        self.species_configs = tuple(species_configs)
        self.halo = halo
        #: the species with a ballistic injection plane (a column each)
        self._ballistic = [i for i, sc in enumerate(self.species_configs)
                           if sc.ballistic_z0 is not None]
        #: the species the exchange block injects into (two real columns
        #: and an int64 one each)
        self._injecting = ([i for i, inj in enumerate(options.injectors)
                            if inj is not None]
                           if options.moving_window_v is not None else [])
        #: the exchange block's real columns: the removal's three, each
        #: injecting species' two, on a slab the injection's ownership
        #: bounds and the migration's
        self._n_exchange = 3 + 2 * len(self._injecting) + (
            4 if halo is not None else 0)
        self._drop_buffers()

    def _drop_buffers(self):
        self._signature = self._static = self._table = self._itable = None
        self._index = self._flag = None
        self._static_storages = set()
        self._series = ()
        self._caps = self._caps_host = ()

    def _ensure_static(self, state, antenna_series, samples):
        """The buffers, built for ``state``, the antennas and the capture
        functions' outputs ``samples`` (one tuple of tensors each, their
        shapes) the first time; another structure raises."""
        sig = signature(state) + tuple(
            (tuple(a.J.shape[2:]), a.J.dtype) for a in antenna_series)
        if self._signature is not None:
            if sig != self._signature:
                raise ValueError("the state's tensors or the antennas are "
                                 "not those the chunk runner was built "
                                 "for")
            return
        self._signature = sig
        self._static = [torch.empty_like(t) for t in state_tensors(state)]
        self._static_storages = {t.untyped_storage().data_ptr()
                                 for t in self._static}
        dev = state.spect.Ep.device
        rdt = state.spect.Ep.real.dtype
        n_b, n_m = len(self._ballistic), len(self.options.mirrors)
        n_a = len(antenna_series)
        self._table = torch.zeros(
            (MAX_CAPTURE, _N_BASE + n_b + 2 * n_m + 3 * n_a
             + self._n_exchange), dtype=rdt, device=dev)
        self._itable = torch.zeros(
            (MAX_CAPTURE, 3 * n_a + len(self._injecting)),
            dtype=torch.int64, device=dev)
        self._index = torch.zeros((), dtype=torch.int64, device=dev)
        self._flag = torch.zeros((), dtype=torch.int64, device=dev)
        self._series = [torch.zeros((2, MAX_CAPTURE) + a.J.shape[2:],
                                    dtype=a.J.dtype, device=dev)
                        for a in antenna_series]
        self._caps = [[torch.zeros((MAX_CAPTURE,) + o.shape, dtype=o.dtype,
                                   device=dev) for o in outs]
                      for outs in samples]
        pin = dev.type == "cuda"
        self._caps_host = [[torch.zeros(b.shape, dtype=b.dtype,
                                        pin_memory=pin) for b in bufs]
                           for bufs in self._caps]

    def _plan(self, state, n_steps, antenna_series, migrate_period=None):
        """The host's plan of every step of the chunk, and the rows of
        their scalars: the real table (zmin, zmin_mid, zmin_next, time,
        mw_zref, zmin_end, time_end, time_mid; each ballistic species'
        plane; each mirror's z_lo, z_hi; each antenna's s0, s1, on; the
        exchange block's removal z_lo, z_hi, z_park, each injecting
        species' z_end and z_lo, on a slab the injection's lo, hi and
        the migration's z_lo, z_hi) and the int64 one (each antenna's
        row, iz0c, iz1c; each injecting species' n_cols).  The exchange
        columns (``plan_exchange``) are filled at the steps that run the
        exchange block or, every ``migrate_period`` steps on a slab, the
        migration; zero elsewhere.  On a slab the state's ``zmin`` is
        the global grid edge, and each step's local one is derived from
        it as the eager slab loop derives it (parallel/domain.py
        ``local_step``: the same host arithmetic); ``_edges`` keeps, for
        each step, its local edge and the global edge after it, and
        ``_z_ends`` each species' injection front after it (the host's:
        never read back)."""
        cfg, halo = self.config, self.halo
        plans, rows, irows = [], [], []
        self._edges, self._z_ends = [], []
        zmin_g, time, mw_zref = state.zmin, state.time, state.mw_zref
        z_ends = [sp.inj_z_end for sp in state.species]
        for i in self._injecting:
            sp = state.species[i]
            if not (torch.is_tensor(sp.next_free)
                    and torch.is_tensor(sp.next_id)):
                # a host int would be baked into the captured injection
                raise ValueError(f"species {i} injects: its cursors must "
                                 f"be 0-d device tensors, as "
                                 f"Simulation.add_new_species makes them")
        for it in range(state.iteration, state.iteration + n_steps):
            zmin = zmin_g if halo is None else \
                zmin_g + halo.offset(type(zmin_g))
            plan = plan_step(cfg, self.options, zmin, zmin if halo is None
                             else halo.global_zmin(zmin), mw_zref, time,
                             it)
            plans.append(plan)
            row = [float(zmin), float(plan.zmin_mid), float(plan.zmin_next),
                   float(time), 0.0 if mw_zref is None else float(mw_zref),
                   float(plan.zmin_end), float(plan.time_end),
                   float(process_time(time, cfg.dt))]
            row += [float(ballistic_plane(self.species_configs[i], time,
                                          cfg.dt))
                    for i in self._ballistic]
            for z_lo, z_hi in mirror_planes(cfg, self.options, time):
                row += [z_lo, z_hi]
            irow = []
            own = None if halo is None else halo.own_bounds(plan.zmin_mid)
            for series in antenna_series:
                i, iz0c, iz1c, s0, s1, on = antenna_cells(
                    series, it, plan.zmin_mid, cfg.dz, cfg.Nz, own)
                row += [float(s0), float(s1), float(on)]
                irow += [i, iz0c, iz1c]
            migrate = bool(migrate_period) and it % migrate_period == 0
            if plan.exchange or migrate:
                xp = plan_exchange(cfg, self.options, z_ends, zmin, halo,
                                   migrate)
                row += [float(v) for v in xp.removal]
                for i in self._injecting:
                    row += [float(v) for v in xp.injection[i][1:]]
                    irow.append(xp.injection[i][0])
                if halo is not None:
                    row += [float(v) for v in xp.inject_bounds]
                    row += ([float(v) for v in xp.migration] if migrate
                            else [0.0, 0.0])
                if plan.exchange:
                    z_ends = [a if a is not None else z for a, z in
                              zip(xp.z_end_after, z_ends)]
            else:
                row += [0.0] * self._n_exchange
                irow += [0] * len(self._injecting)
            rows.append(row)
            irows.append(irow)
            zmin_g = plan.zmin_end if halo is None else \
                zmin_g + (plan.zmin_end - zmin)
            self._edges.append((zmin, zmin_g))
            self._z_ends.append(tuple(z_ends))
            time, mw_zref = plan.time_end, plan.mw_zref_end
        return plans, rows, irows

    def _upload(self, rows, irows):
        """The chunk's scalar tables in one copy each (from pinned memory
        on CUDA: asynchronous, no host sync); each value rounded to the
        table's dtype as a torch op rounds a host number."""
        for table, values in ((self._table, rows), (self._itable, irows)):
            if table.shape[1] == 0:
                continue
            host = torch.tensor(values, dtype=table.dtype)
            if table.device.type == "cuda":
                host = host.pin_memory()
            table[:len(values)].copy_(host, non_blocking=True)

    def _load_series(self, antenna_series):
        """The chunk's antenna series copied into the static buffers, as
        AntennaSeries on them (the host z positions and it0 kept)."""
        out = []
        for buf, series in zip(self._series, antenna_series):
            n = series.J.shape[1]
            if n > MAX_CAPTURE:
                raise ValueError(f"an antenna series of {n} rows: at most "
                                 f"{MAX_CAPTURE}")
            buf[:, :n].copy_(series.J)
            out.append(replace(series, J=buf))
        return tuple(out)

    def _row(self):
        """The tables' rows at the device step index (0-d tensors each,
        unbound)."""
        idx = self._index.view(1)
        row = self._table.index_select(0, idx)[0].unbind(0)
        irow = self._itable.index_select(0, idx)[0].unbind(0) \
            if self._itable.shape[1] else ()
        return row, irow

    def _scalars(self, row, irow):
        """StepScalars of a table row."""
        planes = [None] * len(self.species_configs)
        for k, i in enumerate(self._ballistic):
            planes[i] = row[_N_BASE + k]
        n_m = len(self.options.mirrors)
        m0 = _N_BASE + len(self._ballistic)
        a0 = m0 + 2 * n_m
        mirrors = tuple((row[m0 + 2 * k], row[m0 + 2 * k + 1])
                        for k in range(n_m))
        n_a = (len(irow) - len(self._injecting)) // 3
        antennas = tuple(tuple(irow[3 * a:3 * a + 3])
                         + tuple(row[a0 + 3 * a:a0 + 3 * a + 3])
                         for a in range(n_a))
        return StepScalars(*row[:5], zmin_end=row[_ZMIN_END],
                           mirrors=mirrors, antennas=antennas,
                           time_mid=row[_TIME_MID], planes=tuple(planes),
                           exchange=self._exchange_values(
                               row[a0 + 3 * n_a:], irow[3 * n_a:]))

    def _exchange_values(self, row, irow):
        """The exchange block's ExchangePlan of a table row's exchange
        columns (0-d tensors)."""
        injection = [None] * len(self.species_configs)
        for k, i in enumerate(self._injecting):
            injection[i] = (irow[k], row[3 + 2 * k], row[4 + 2 * k])
        n = 3 + 2 * len(self._injecting)
        return ExchangePlan(
            removal=tuple(row[:3]), injection=tuple(injection),
            inject_bounds=None if self.halo is None else tuple(row[n:n + 2]),
            migration=None if self.halo is None else tuple(row[n + 2:n + 4]))

    @staticmethod
    def _end_values(row):
        """The time and grid edge after the step of a table row (0-d
        tensors): what the capture functions see."""
        return row[_TIME_END], row[_ZMIN_END]

    def _write_captures(self, outs):
        """Each capture function's outputs written into its buffers at
        the row of the device step index."""
        idx = self._index.view(1)
        for bufs, out in zip(self._caps, outs):
            for buf, t in zip(bufs, out):
                buf.index_copy_(0, idx, t.unsqueeze(0))

    def _copy_captures(self, n_steps):
        """The captures' first n_steps rows into pinned host memory,
        asynchronously: the chunk's read that follows waits for them."""
        for bufs, hosts in zip(self._caps, self._caps_host):
            for buf, host in zip(bufs, hosts):
                host[:n_steps].copy_(buf[:n_steps], non_blocking=True)

    def _captures(self, n_steps):
        """The captures of the chunk's n_steps steps (after its read):
        for each capture function, its outputs as numpy arrays."""
        return [tuple(h[:n_steps].numpy() for h in hosts)
                for hosts in self._caps_host]

    def _store(self, new):
        """Copy a step's result into the static buffers (a result that
        shares storage with another static buffer is copied aside
        first; one that IS its buffer stays): the device span
        ``store``."""
        mark("store", self._table.device)
        outs = state_tensors(new)
        if len(outs) != len(self._static):
            raise ValueError("the step changed the state's structure")
        outs = [o if o is s or o.untyped_storage().data_ptr()
                not in self._static_storages else o.clone()
                for o, s in zip(outs, self._static)]
        for o, s in zip(outs, self._static):
            if o is not s:
                s.copy_(o)


class MultiStep(ChunkBuffers):
    """The chunk runner of one configuration (``make_multi_step``, and
    ``make_multi_step_capture`` with ``capture_fns``).

    ``multi_step(state, aux, n_steps, inj_auxes, column_angles,
    generator, draws, antenna_series, ion_auxes, comp_auxes,
    live_counts, eager_exchange)`` runs n_steps <= MAX_CAPTURE steps
    from ``state``
    (which it leaves unchanged) and returns (the new state, counts):
    counts holds the host ints of the chunk's one read, ``resort_redo``
    (the banded re-sorts' overflow in the graphed steps),
    ``sort_overflow`` and ``ring_overwrite`` (the state's running
    counters after the chunk), ``live`` ({species index: its live
    particles after the chunk} for each index in ``live_counts``),
    ``rolled_back`` (the chunk was run again eagerly) and ``captures``:
    for each capture function, the tuple of its outputs stacked over the
    chunk's steps (numpy arrays of n_steps rows).

    ``ion_auxes`` / ``comp_auxes``: each species' IonizerAux /
    ComptonAux (or None), handed to every step, as fbpic_tpu's
    ``multi_step`` hands them.  On CUDA the draws' source must be a
    ``GeneratorDraws`` of ``generator`` (particles/draws.py), which is
    registered with every graph of a configuration with a process.

    ``eager_exchange``: the exchange block of an exchange step runs
    eagerly before its step's graph (``graph_blockers``' ``exchange``
    names why);
    else it is inside the graph, reading the chunk's tables, and the
    ``column_angles`` must be a ``GeneratorAngles`` of ``generator``,
    which the exchange variants register.

    ``capture_fns``: functions ``cap(state, aux, time, zmin)`` of the
    state after each step (time and zmin: its time and grid edge as 0-d
    tensors of the working dtype) returning a tuple of tensors of fixed
    shapes -- the back-transformed fields' plane slices
    (``BackTransformedFieldDiagnostic.device_capture``).  Each step
    writes them into a static (MAX_CAPTURE, ...) device buffer at the
    row of the device step index (inside the graph of a replayed step),
    and the chunk copies the first n_steps rows to pinned host memory
    asynchronously before its one read, which waits for them: the
    captures cost no host read of their own.

    ``antenna_series``: the laser antennas' current blocks of the chunk
    (``LaserAntenna.compute_series``, from the iteration ``it0`` <= the
    chunk's first, at most MAX_CAPTURE rows): each is copied into a
    static MAX_CAPTURE-row buffer once a chunk, which every step reads
    (a graph reads the tensors it was captured with: a new tensor a
    chunk would leave every replay reading the first chunk's current).

    The static buffers are built for the state (and the number of
    antennas) the first call gets; another structure raises.  Every
    graph belongs to the configuration it was built for (species,
    capacities, StepOptions, capture functions): a change of any of them
    needs a new MultiStep."""

    def __init__(self, config, species_configs, options, capture_fns=()):
        super().__init__(config, species_configs, options)
        self.step = make_step_fn(config, self.species_configs, options)
        self.capture_fns = tuple(capture_fns)
        self._processes = has_processes(self.species_configs)
        self._generator = None
        #: variant key (n_move, full_resort, exchange block inside) ->
        #: (graph, launch counts)
        self.graphs = {}
        self._pool = self._side = None
        #: the device spans' marker nodes of the graphs
        self.markers = profiling.GraphMarkers()

    # -----------------------------------------------------------------
    def __call__(self, state, aux, n_steps, inj_auxes=(), column_angles=None,
                 generator=None, draws=None, antenna_series=(), ion_auxes=(),
                 comp_auxes=(), live_counts=(), eager_exchange=False):
        with span("chunk"):
            return self._chunk(state, aux, n_steps, inj_auxes, column_angles,
                               generator, draws, antenna_series, ion_auxes,
                               comp_auxes, live_counts, eager_exchange)

    def _chunk(self, state, aux, n_steps, inj_auxes, column_angles,
               generator, draws, antenna_series, ion_auxes, comp_auxes,
               live_counts, eager_exchange):
        check_chunk(n_steps)
        self.markers.follow()
        state = ensure_counters(state)
        dev = state.spect.Ep.device
        mark("chunk_in", dev)
        with span("plan"):
            self._ensure_static(state, aux, antenna_series)
            plans, rows, irows = self._plan(state, n_steps, antenna_series)
            self._upload(rows, irows)
        with span("stage_in"):
            kw = dict(draws=draws, antenna_series=self._load_series(
                antenna_series), ion_auxes=ion_auxes, comp_auxes=comp_auxes)
            self._generator = generator
            gen_state = None if generator is None else generator.get_state()
            for s, t in zip(self._static, state_tensors(state)):
                s.copy_(t)
            self._flag.zero_()
            self._index.zero_()
        cur = with_state_tensors(state, self._static)
        args = (aux, inj_auxes, column_angles, generator)
        for plan, z_ends in zip(plans, self._z_ends):
            with span("replay"):
                inside = plan.exchange and not eager_exchange
                if plan.exchange and eager_exchange:
                    new = self.step.exchange(cur, *args)
                    self._store(new)
                    cur = with_state_tensors(new, self._static)
                self._graphed((plan.n_move, plan.full_resort, inside), cur,
                              args, kw)
                cur = replace(cur, time=plan.time_end, zmin=plan.zmin_end,
                              mw_zref=plan.mw_zref_end,
                              iteration=cur.iteration + 1,
                              species=with_z_ends(cur.species, z_ends))
        mark("chunk_out", dev)
        with span("read"):
            self._copy_captures(n_steps)
            redo, n_sort, n_ring, *live = torch.stack(
                [self._flag, cur.sort_overflow, cur.ring_overwrite]
                + [(cur.species[i].w != 0).sum() for i in live_counts]
            ).tolist()
        if redo > 0:
            # A banded re-sort overflowed: the chunk again from its
            # start, through the eager step (which redoes the sort), and
            # its captures with it
            with span("rollback"):
                if generator is not None:
                    generator.set_state(gen_state)
                out = state
                self._index.zero_()
                for _ in range(n_steps):
                    out = self.step(out, *args, **kw)
                    self._capture(out, aux, self._row()[0])
                    self._index.add_(1)
                self._copy_captures(n_steps)
                n_sort, n_ring, *live = torch.stack(
                    [out.sort_overflow, out.ring_overwrite]
                    + [(out.species[i].w != 0).sum() for i in live_counts]
                ).tolist()
        else:
            with span("stage_out"):
                out = with_state_tensors(cur, [s.clone()
                                               for s in self._static])
        return out, dict(resort_redo=redo, sort_overflow=n_sort,
                         ring_overwrite=n_ring,
                         live=dict(zip(live_counts, live)),
                         rolled_back=redo > 0,
                         captures=self._captures(n_steps))

    def release(self):
        """Drop the graphs (their memory pool goes with the last) and the
        static buffers, before another runner captures its own."""
        for graph, _ in self.graphs.values():
            graph.reset()
        self.graphs = {}
        self.markers.clear()
        self._pool = self._side = None
        self._drop_buffers()

    # -----------------------------------------------------------------
    def _ensure_static(self, state, aux, antenna_series):
        # The capture buffers, shaped by one capture of the input state
        samples = ()
        if self._signature is None and self.capture_fns:
            dev = state.spect.Ep.device
            rdt = state.spect.Ep.real.dtype
            t, z = (torch.full((), float(v), dtype=rdt, device=dev)
                    for v in (state.time, state.zmin))
            samples = [fn(state, aux, t, z) for fn in self.capture_fns]
        super()._ensure_static(state, antenna_series, samples)

    def _capture(self, state, aux, row):
        """Each capture function of the state after a step, written into
        its buffers at the row of the device step index."""
        self._write_captures([fn(state, aux, *self._end_values(row))
                              for fn in self.capture_fns])

    def _body(self, cur, args, kw, inside):
        """One step on the static buffers, its exchange block with it
        (``inside``) or already run (an exchange step whose block stays
        eager): its scalars from the tables' row at the step index, the
        banded re-sort's overflow into the flag, the result copied back,
        the captures written, the index advanced.  The device span
        ``row`` opens the step, before the table read."""
        mark("row", self._table.device)
        row, irow = self._row()
        new = self.step(cur, *args, scalars=self._scalars(row, irow),
                        redo_flag=self._flag, exchanged=not inside, **kw)
        self._store(new)
        self._capture(with_state_tensors(new, self._static), args[0], row)
        self._index.add_(1)

    def _graphed(self, key, cur, args, kw):
        """The step of variant ``key`` (n_move, full re-sort, exchange
        block inside): the body itself on the CPU; on CUDA a replay, or,
        at the variant's first step, its warm-up (the step, eagerly, on a
        side stream) and its capture.  A variant that draws (the
        processes, or the exchange block's injection) registers the
        generator."""
        inside = key[2]
        if self._table.device.type != "cuda":
            self._body(cur, args, kw, inside)
            return
        if key in self.graphs:
            graph, counts = self.graphs[key]
            graph.replay()
            kernels.add_launches(*counts)
            return
        dev = self._table.device
        if self._side is None:
            self._side = torch.cuda.Stream(device=dev)
            self._pool = torch.cuda.graph_pool_handle()
        with span("capture"):
            main = torch.cuda.current_stream(dev)
            self._side.wait_stream(main)
            with torch.cuda.stream(self._side):
                self._body(cur, args, kw, inside)
            main.wait_stream(self._side)
            draws = self._processes or (inside and bool(self._injecting))
            self.graphs[key] = capture_graph(
                lambda stream: self._body(cur, args, kw, inside), self._pool,
                [self._generator] if draws and self._generator is not None
                else [], f"the step (n_move={key[0]}, full re-sort="
                f"{key[1]}, exchange block inside={key[2]})", self.markers,
                dev)


def with_z_ends(species, z_ends):
    """The species with their injection fronts ``z_ends`` (host values,
    None: the species injects nothing)."""
    return [sp if z is None else sp.replace(inj_z_end=z)
            for sp, z in zip(species, z_ends)]


def check_chunk(n_steps):
    if not 0 < n_steps <= MAX_CAPTURE:
        raise ValueError(f"a chunk runs 1 to {MAX_CAPTURE} steps, not "
                         f"{n_steps}")


class _Captured:
    """The launches a capture counted (``counts``, set when it ends)."""
    counts = None


@contextlib.contextmanager
def _capturing(what):
    """The process-wide setting around a capture, set once whatever the
    number of cards and threads that capture: no garbage collection (a
    graph it frees -- an old runner's, held in a reference cycle --
    would reset during this capture, which invalidates it).  A
    RuntimeError raised inside is raised again as a failed capture of
    ``what``.  Yields a ``_Captured`` whose ``counts`` are the launches
    the capture counted, taken back out of the kernel counters:
    ({wrapper: n}, {wrapper: {slab rank: n}})."""
    before = kernels.launch_counts()
    before_slab = kernels.slab_launch_counts()
    captured = _Captured()
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield captured
    except RuntimeError as err:
        raise RuntimeError(f"capturing {what} in a CUDA graph failed: "
                           f"{err}") from err
    finally:
        if collecting:
            gc.enable()
    counts = {fn: n - before.get(fn, 0)
              for fn, n in kernels.launch_counts().items()
              if n != before.get(fn, 0)}
    by_slab = {}
    for fn, ranks in kernels.slab_launch_counts().items():
        old = before_slab.get(fn, {})
        diff = {r: n - old.get(r, 0) for r, n in ranks.items()
                if n != old.get(r, 0)}
        if diff:
            by_slab[fn] = diff
    kernels.add_launches({fn: -n for fn, n in counts.items()},
                         {fn: {r: -n for r, n in ranks.items()}
                          for fn, ranks in by_slab.items()})
    captured.counts = (counts, by_slab)


@contextlib.contextmanager
def _host_syncs_raise():
    """torch's sync debug mode "error" (process-wide): a host
    synchronization in the captured work raises where it is made."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _register(graph, generators):
    """Register ``generators`` with ``graph``, each with its own card
    current: torch puts a generator's graph-side seed and offset on the
    current card at its first registration, and a replay on another card
    would read them there, unordered with the fill that sets them."""
    for gen in generators:
        with torch.cuda.device(gen.device):
            graph.register_generator_state(gen)


def capture_graph(body, pool, generators, what, markers, card):
    """Capture ``body(stream)`` (``stream``: the capture stream) into a
    new CUDA graph of memory pool ``pool`` on ``card``, its device
    spans' marker nodes kept in ``markers`` (a ``GraphMarkers``, which
    instantiates the graph); returns (graph, counts), the
    launches the capture counted, taken back out of the kernel counters
    (``kernels.add_launches(*counts)`` adds them again at a replay):
    ({wrapper: n}, {wrapper: {slab rank: n}}).  ``generators`` are
    registered with the graph: each replay then draws from their
    offsets at its launch and advances them as the eager step would.
    The capture runs under ``_capturing`` and ``_host_syncs_raise``
    (entered once the capture has begun: torch.cuda.graph synchronizes
    before it begins).  Only the
    capturing thread is barred from the calls that are unsafe during a
    capture (``capture_error_mode`` "thread_local").  A capture that
    fails raises."""
    graph = profiling.keep_graph()
    _register(graph, generators)
    with _capturing(what) as captured, markers.capturing({card: graph}):
        ctx = torch.cuda.graph(graph, pool=pool,
                               capture_error_mode="thread_local")
        with ctx, _host_syncs_raise():
            body(ctx.capture_stream)
    return graph, captured.counts


def capture_graphs(run, pools, generators, what, markers):
    """Capture one CUDA graph on each card of ``pools`` ({card: memory
    pool}) at once: ``run(graphs)`` issues the work, ``graphs`` {card:
    (graph, pool)} -- the slabs' threads open the captures, each card's
    on its own stream (``parallel.group.SlabGroup.run``), since the
    cards' collectives meet during the capture.  Each generator of
    ``generators`` is registered with its own card's graph only.  The
    cards are synchronized first; the capture runs under ``_capturing``
    and ``_host_syncs_raise``, set once for every card, each card's
    marker nodes kept in ``markers``.  Returns
    ({card: graph}, counts) as ``capture_graph`` does; a capture that
    fails on any card raises."""
    graphs = {card: profiling.keep_graph() for card in pools}
    for gen in generators:
        _register(graphs[torch.device(gen.device)], [gen])
    for card in pools:
        torch.cuda.synchronize(card)
    with _capturing(what) as captured, markers.capturing(graphs), \
            _host_syncs_raise():
        run({card: (graph, pools[card]) for card, graph in graphs.items()})
    return graphs, captured.counts


class GraphBlockers(NamedTuple):
    """Why a run does not replay all of its chunk from CUDA graphs
    (``graph_blockers``): ``loop``, the reasons it keeps the eager loop;
    ``exchange``, those that keep only the exchange block of an
    exchange step eager (run before its step's graph, the rest of the
    chunk replaying its graphs).  Both empty: every step replays."""
    loop: list
    exchange: list


def graph_blockers(sim, options):
    """Why ``sim``'s run with ``options`` does not replay all of its
    chunk from graphs (``GraphBlockers``).  Every single-device
    configuration takes the chunk runner: every species layout --
    resident, or a ring of any shape, cross-deposition included (their
    steps capture with no host read) --, laser antennas, external
    fields, mirrors, the back-transformed field diagnostic, ballistic
    species, ionization, Compton scattering and the exchange block
    (removal, continuous injection, a fresh rho_prev): their per-step
    values come from the chunk's tables, the diagnostic's slices go to
    the runner's buffers, the processes' draws and the injection's
    angles and momenta from the simulation's generator, registered with
    the graphs.

    ``loop``: on CUDA only, a process draw source other than a
    ``GeneratorDraws`` of ``sim.generator`` (particles/draws.py), which
    might read the host iteration that a replay does not pass, or draw
    from a generator the graphs do not advance; on the CPU the runner
    calls the step itself, so any source works there.

    ``exchange``, on every device (the CPU runs what the card runs): an
    injecting species' density function that the probe sent to the
    host (it gets numpy arrays there, fbpic_tpu's ``pure_callback``),
    and a column angle source other than a ``GeneratorAngles`` of
    ``sim.generator`` (it gets the host iteration, which a replay does
    not pass, or draws from a generator the graphs do not advance: the
    parity tests feed fbpic_tpu's angles)."""
    loop = []
    draws = sim.process_draws
    if (has_processes(sim.species_configs) and sim.device.type == "cuda"
            and not (isinstance(draws, GeneratorDraws)
                     and draws.generator is sim.generator)):
        loop.append("a process draw source other than the simulation's "
                    "GeneratorDraws")
    injectors = [(i, inj) for i, inj in enumerate(options.injectors)
                 if inj is not None] \
        if options.moving_window_v is not None else []
    exchange = [f"species {i}'s density function is evaluated on the "
                f"host (the probe found no tensor of the device)"
                for i, inj in injectors
                if inj.dens_func is not None and not inj.dens_on_device]
    angles = getattr(sim, "column_angles", None)
    if injectors and angles is not None and not (
            isinstance(angles, GeneratorAngles)
            and angles.generator is sim.generator):
        exchange.append("a column angle source other than the "
                        "simulation's GeneratorAngles")
    return GraphBlockers(loop, exchange)
