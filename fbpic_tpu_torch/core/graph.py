"""Device-resident chunks of steps: fbpic_tpu's ``make_multi_step`` on
CUDA graphs.

fbpic_tpu runs ``step(N)`` as device programs of up to 250 steps, each
one XLA ``lax.fori_loop`` over the jitted step (fbpic_tpu
core/step.py:1794-1815, core/simulation.py:880-957); the host reads the
counters once per call.  ``MultiStep`` is the port's counterpart: it
runs a chunk of up to ``MAX_CAPTURE`` steps with one host read at its
end.

- The exchange steps (removal, injection and a fresh rho_prev, every
  ``exchange_period`` steps of an open-z run) run eagerly, outside any
  graph: their injection draws angles from a ``torch.Generator`` and a
  user's ``dens_func`` reads positions on the host.
- Every other step replays a captured ``torch.cuda.CUDAGraph`` of the
  step.  There is one graph per variant, keyed by what the host decides
  for a step (``plan_step``): the window's shift ``n_move`` and the full
  re-sort of a periodic run every 64 steps.  All of them share one
  memory pool: a graph's temporaries are dead when its replay ends (its
  results are copied into the static buffers, outside the pool), and
  the replays run one after the other on one stream.
- The step's scalars (``StepScalars``: zmin at the gather, the J
  deposit and rho_next, the time, the window's reference) come from a
  per-chunk table, uploaded once per chunk; the row is picked by a
  device step index that every step of the chunk advances, so a replay
  reads its own step's values.  The host keeps its own arithmetic for
  them and for the variant keys, and never reads them back.
- The banded re-sort's overflow, which fbpic_tpu redoes inside its
  program with a ``lax.cond`` (a full sort), is added into a device flag
  instead.  The chunk's one read (the flag, sort_overflow and
  ring_overwrite, stacked) sees it; if the flag is above 0, the chunk
  is run again from its start through the eager step, which redoes the
  sort as it always does.  The result equals the eager run's in every
  case.  The chunk's input state is kept aside for that, untouched: the
  chunk runs on its copy in the static buffers, and the generator's
  state is saved with it.

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

On CPU tensors the same runner calls the graph's body instead of
replaying it: the table, the step index, the flag and the rollback are
the same; only the capture is CUDA-only.
"""
from dataclasses import fields, replace

import torch

from ..utils import kernels
from .step import (StepScalars, ensure_counters, make_step_fn, plan_step)

#: Most steps in one chunk (fbpic_tpu's step chunk cap)
MAX_CAPTURE = 250


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


class MultiStep:
    """The chunk runner of one configuration (``make_multi_step``).

    ``multi_step(state, aux, n_steps, inj_auxes, column_angles,
    generator, draws)`` runs n_steps <= MAX_CAPTURE steps from ``state``
    (which it leaves unchanged) and returns (the new state, counts):
    counts holds the host ints of the chunk's one read, ``resort_redo``
    (the banded re-sorts' overflow in the graphed steps),
    ``sort_overflow`` and ``ring_overwrite`` (the state's running
    counters after the chunk), and ``rolled_back`` (the chunk was run
    again eagerly).  The static buffers are built for the state the
    first call gets; a state of another structure raises.  Every graph
    belongs to the configuration it was built for (species, capacities,
    StepOptions): a change of any of them needs a new MultiStep."""

    def __init__(self, config, species_configs, options):
        self.config, self.options = config, options
        self.step = make_step_fn(config, tuple(species_configs), options)
        self._signature = None
        self._static = self._table = self._index = self._flag = None
        self._static_storages = set()
        #: variant key (n_move, full_resort) -> (graph, launch counts)
        self.graphs = {}
        self._pool = self._side = None

    # -----------------------------------------------------------------
    def __call__(self, state, aux, n_steps, inj_auxes=(), column_angles=None,
                 generator=None, draws=None):
        if not 0 < n_steps <= MAX_CAPTURE:
            raise ValueError(f"a chunk runs 1 to {MAX_CAPTURE} steps, not "
                             f"{n_steps}")
        state = ensure_counters(state)
        self._ensure_static(state)
        plans, rows = self._plan(state, n_steps)
        self._upload(rows)
        gen_state = None if generator is None else generator.get_state()
        for s, t in zip(self._static, state_tensors(state)):
            s.copy_(t)
        self._flag.zero_()
        self._index.zero_()
        cur = with_state_tensors(state, self._static)
        args = (aux, inj_auxes, column_angles, generator)
        for plan in plans:
            if plan.exchange:
                new = self.step(cur, *args, draws=draws)
                self._store(new)
                cur = with_state_tensors(new, self._static)
                self._index.add_(1)
            else:
                self._graphed((plan.n_move, plan.full_resort), cur, args,
                              draws)
                cur = replace(cur, time=plan.time_end, zmin=plan.zmin_end,
                              mw_zref=plan.mw_zref_end,
                              iteration=cur.iteration + 1)
        redo, n_sort, n_ring = torch.stack(
            [self._flag, cur.sort_overflow, cur.ring_overwrite]).tolist()
        if redo > 0:
            # A banded re-sort overflowed: the chunk again from its
            # start, through the eager step (which redoes the sort)
            if generator is not None:
                generator.set_state(gen_state)
            out = state
            for _ in range(n_steps):
                out = self.step(out, *args, draws=draws)
            n_sort, n_ring = torch.stack(
                [out.sort_overflow, out.ring_overwrite]).tolist()
        else:
            out = with_state_tensors(cur, [s.clone() for s in self._static])
        return out, dict(resort_redo=redo, sort_overflow=n_sort,
                         ring_overwrite=n_ring, rolled_back=redo > 0)

    # -----------------------------------------------------------------
    def _ensure_static(self, state):
        sig = signature(state)
        if self._signature is None:
            self._signature = sig
            self._static = [torch.empty_like(t) for t in state_tensors(state)]
            self._static_storages = {t.untyped_storage().data_ptr()
                                     for t in self._static}
            dev = state.spect.Ep.device
            rdt = state.spect.Ep.real.dtype
            self._table = torch.zeros((MAX_CAPTURE, 5), dtype=rdt,
                                      device=dev)
            self._index = torch.zeros((), dtype=torch.int64, device=dev)
            self._flag = torch.zeros((), dtype=torch.int64, device=dev)
        elif sig != self._signature:
            raise ValueError("the state's tensors are not those the chunk "
                             "runner was built for")

    def _plan(self, state, n_steps):
        """The host's plan of every step of the chunk, and the table rows
        of their scalars (zmin, zmin_mid, zmin_next, time, mw_zref)."""
        plans, rows = [], []
        zmin, time, mw_zref = state.zmin, state.time, state.mw_zref
        for it in range(state.iteration, state.iteration + n_steps):
            plan = plan_step(self.config, self.options, zmin, zmin,
                             mw_zref, time, it)
            plans.append(plan)
            rows.append([float(zmin), float(plan.zmin_mid),
                         float(plan.zmin_next), float(time),
                         0.0 if mw_zref is None else float(mw_zref)])
            zmin, time, mw_zref = plan.zmin_end, plan.time_end, \
                plan.mw_zref_end
        return plans, rows

    def _upload(self, rows):
        """The chunk's scalar table in one copy (from pinned memory on
        CUDA: asynchronous, no host sync); each value rounded to the
        working dtype as a torch op rounds a host number."""
        host = torch.tensor(rows, dtype=self._table.dtype)
        if self._table.device.type == "cuda":
            host = host.pin_memory()
        self._table[:len(rows)].copy_(host, non_blocking=True)

    def _store(self, new):
        """Copy a step's result into the static buffers (a result that
        shares storage with another static buffer is copied aside
        first; one that IS its buffer stays)."""
        outs = state_tensors(new)
        if len(outs) != len(self._static):
            raise ValueError("the step changed the state's structure")
        outs = [o if o is s or o.untyped_storage().data_ptr()
                not in self._static_storages else o.clone()
                for o, s in zip(outs, self._static)]
        for o, s in zip(outs, self._static):
            if o is not s:
                s.copy_(o)

    def _body(self, cur, args, draws):
        """One non-exchange step on the static buffers: its scalars from
        the table's row at the step index, the banded re-sort's overflow
        into the flag, the result copied back, the index advanced."""
        row = self._table.index_select(0, self._index.view(1))[0]
        new = self.step(cur, *args, draws=draws,
                        scalars=StepScalars(*row.unbind(0)),
                        redo_flag=self._flag)
        self._store(new)
        self._index.add_(1)

    def _graphed(self, key, cur, args, draws):
        """The non-exchange step of variant ``key``: the body itself on
        the CPU; on CUDA a replay, or, at the variant's first step, its
        warm-up (the step, eagerly, on a side stream) and its capture."""
        if self._table.device.type != "cuda":
            self._body(cur, args, draws)
            return
        if key in self.graphs:
            graph, counts = self.graphs[key]
            graph.replay()
            kernels.add_launches(counts)
            return
        dev = self._table.device
        if self._side is None:
            self._side = torch.cuda.Stream(device=dev)
            self._pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(dev)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            self._body(cur, args, draws)
        main.wait_stream(self._side)
        self.graphs[key] = self._capture(key, cur, args, draws)

    def _capture(self, key, cur, args, draws):
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self._body(cur, args, draws)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        except RuntimeError as err:
            raise RuntimeError(
                f"capturing the step (n_move={key[0]}, full re-sort="
                f"{key[1]}) in a CUDA graph failed: {err}") from err
        counts = {fn: n - before.get(fn, 0)
                  for fn, n in kernels.launch_counts().items()
                  if n != before.get(fn, 0)}
        kernels.add_launches({fn: -n for fn, n in counts.items()})
        return graph, counts


def graph_blockers(sim, options):
    """Why ``sim``'s run with ``options`` does not take the chunk runner
    (an empty list when it does).  It does when every species is
    resident (linear shape, no cross-deposition, no tracer) without
    ionization, Compton scattering or a ballistic plane, with no laser
    antenna, external field, mirror or capturing diagnostic (the
    back-transformed fields): those need host values a step, host
    reads or per-step random state, and keep the eager loop."""
    from .step import _resident_indices
    out = []
    scs = sim.species_configs
    resident = _resident_indices(sim.config, scs, options)
    if len(resident) != len(scs):
        out.append("a species is not resident")
    if any(sc.ionizer is not None or sc.compton is not None for sc in scs):
        out.append("ionization or Compton scattering")
    if any(sc.ballistic_z0 is not None for sc in scs):
        out.append("a ballistic species")
    if sim.laser_antennas:
        out.append("a laser antenna")
    if options.external_fields:
        out.append("an external field")
    if options.mirrors:
        out.append("a mirror")
    if any(hasattr(w, "capture") for w in sim.diags):
        out.append("a capturing diagnostic")
    return out

