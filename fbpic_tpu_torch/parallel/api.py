"""User-facing z decomposition: Simulation -> a run over N slabs.

``distribute_simulation(sim)`` takes a fully configured
:class:`~fbpic_tpu_torch.Simulation` (species, lasers, moving window,
diagnostics ...) and decomposes it over a 1-D z mesh -- the analog of
launching the reference with ``mpirun -np N``, and the port of
fbpic_tpu's parallel/api.py.  As there, one process runs every slab:
``run.step(N)`` runs under plain ``python``.  Each slab is a thread of
its own (``parallel.group``) on its device; several slabs may share a
card (``devices=["cuda:0", "cuda:0"]``) and a CPU mesh is
``devices=["cpu"] * N``.

The :class:`DistributedRun` owns the per-slab states (fields
(Nm, Nz_local, Nr) and particle blocks on each slab's device) and the
decomposed step of :mod:`fbpic_tpu_torch.parallel.domain`, which it
runs in chunks through the slabs' chunk runner (``SlabMultiStep``).
"""
import dataclasses
import warnings

import numpy as np
import torch

from ..core import step as step_mod
from ..core.graph import MAX_CAPTURE, GraphBlockers, graph_blockers
from ..core.state import SimState
from ..fields import transform as tr
from ..fields.solver import build_field_aux
from ..particles.draws import GeneratorDraws
from ..particles.injection import GeneratorAngles
from ..particles.state import ARRAY_FIELDS
from ..utils import kernels
from .group import SlabGroup
from .mesh import make_mesh
from . import domain as dom


def _round256(n):
    return max(256, int(-(-int(n) // 256) * 256))


def _to_device(obj, device):
    """obj with every tensor it holds (in dataclasses, tuples, lists)
    on ``device``."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _tensor_on(value, device):
    """A cursor or counter (host int or 0-d tensor) on ``device``."""
    return value.to(device) if torch.is_tensor(value) else value


class DistributedRun:
    """A z-decomposed simulation run over a mesh of slabs.

    Usage::

        run = distribute_simulation(sim)   # after full setup
        run.step(100)
        Ez = run.get_interp_field("Ez", m=0)   # global internal grid

    ``states``: the per-slab SimStates (each slab's ``zmin`` the global
    grid edge); ``overflow_totals``: the migration losses and the sort /
    ring overflows summed over the run (and ``rollbacks``, the chunks
    run again through the eager slab loop, once there is one)."""

    def __init__(self, sim, n_devices=None, devices=None, axis_name="z",
                 migration_buffer=None, n_guard=None,
                 on_migration_overflow="error", **step_kwargs):
        if on_migration_overflow not in ("error", "warn"):
            raise ValueError(
                "on_migration_overflow must be 'error' or 'warn'")
        self.on_migration_overflow = on_migration_overflow
        self.sim = sim
        config = sim.config
        mesh = make_mesh(n_devices, axis_name=axis_name, devices=devices)
        ndev = mesh.size
        if config.Nz % ndev != 0:
            raise ValueError(
                f"The internal grid Nz={config.Nz} must be divisible by "
                f"the number of devices ({ndev}).  Adjust Nz (physical "
                f"Nz + edge cells) or the device count.")
        self.mesh, self.axis_name, self.ndev = mesh, axis_name, ndev
        self.devices = mesh.devices
        self.group = SlabGroup(mesh.devices)

        options = sim.build_options(**step_kwargs)
        self.config_local = dom.local_grid_config(
            config, ndev, dom.default_n_guard(config) if n_guard is None
            else int(n_guard))
        self.g = self.config_local.n_guard
        self.Nz_int = self.config_local.Nz - 2 * self.g
        # Back-transformed field diagnostics capture every step inside
        # the slab threads (each slab slices the interior it owns, the
        # slabs' slices summed): the decomposed analog of the single
        # card's capture, fbpic_tpu's device_capture on the mesh
        self._capture_writers = [w for w in list(sim.diags)
                                 + list(sim.checkpoints)
                                 if hasattr(w, "capture") and w.snapshots]
        cap_fns = tuple(w.decomposed_capture(self.config_local)
                        for w in self._capture_writers)
        self.options = options
        #: the eager slab loop (``parallel.domain.make_multichip_step``);
        #: the chunk runner is built on it
        self.multi_step, _ = dom.make_multichip_step(
            config, tuple(sim.species_configs), options, mesh,
            axis_name=axis_name, migration_buffer=migration_buffer,
            n_guard=self.g, capture_fns=cap_fns, group=self.group)
        self._runner = None
        #: True: every chunk through the eager slab loop (a twin to hold
        #: the chunk runner against); runs whose ``graph_blockers`` name
        #: a ``loop`` reason take it anyway
        self.eager = False
        self.exchange_period = self.multi_step.exchange_period
        self.migration_buffer = self.multi_step.migration_buffer
        # Species that run the resident layout on the slabs: capacity
        # Nz_local * sort_K, packed in the column-sorted layout
        self._resident_idx = step_mod._resident_indices(
            self.config_local, tuple(sim.species_configs), options)
        auxes = {}
        for d in mesh.devices:
            if d not in auxes:
                auxes[d] = build_field_aux(
                    self.config_local, sim.smoother, device=d,
                    dtype=sim.dtype, **sim.aux_options)
        self.auxes = [auxes[d] for d in mesh.devices]
        # As a single-card step() call begins: spectral E/B refreshed
        # from the interpolation grid (user-set fields included) and
        # rho_prev deposited, on the global state, then cut into slabs
        self.states = self._shard_state(step_mod.prepare(
            config, options, sim.species_configs, sim.state, sim.aux))
        self.iteration = int(sim.iteration)
        # rho_prev is the single card's deposit cut into slabs until an
        # exchange block deposits each slab's own (``_rho_record``)
        self._rho_local = False
        self.overflow_totals = {"migration_overflow": 0, "sort_overflow": 0,
                                "ring_overwrite": 0}
        #: each slab's live particles of each species after the last chunk
        self.live_counts = {}
        self._slab_kwargs = self._make_slab_kwargs()

    # -- per-slab arguments ----------------------------------------------

    def _make_slab_kwargs(self):
        """Each slab's step arguments: the auxes on its device, the
        randomness sources.  The injection angles and thermal momenta
        are drawn alike on every slab (each a copy of the simulation's
        generator: every slab generates the same candidate columns); the
        default process draws come from a generator per slab, seeded
        from the simulation's seed and the rank (fbpic_tpu folds the
        rank into those keys)."""
        sim = self.sim
        on = {}
        out = []
        default_angles = (isinstance(sim.column_angles, GeneratorAngles)
                          and sim.column_angles.generator is sim.generator)
        default_draws = (isinstance(sim.process_draws, GeneratorDraws)
                         and sim.process_draws.generator is sim.generator)
        self._generators = []
        for rank, d in enumerate(self.devices):
            if d not in on:
                on[d] = dict(
                    inj_auxes=_to_device(tuple(sim._injector_auxes), d),
                    ion_auxes=_to_device(tuple(sim._ionizer_auxes), d),
                    comp_auxes=_to_device(tuple(sim._compton_auxes), d))
            gen = torch.Generator(device=d)
            gen.set_state(sim.generator.get_state())
            self._generators.append(gen)
            kw = dict(on[d], generator=gen,
                      column_angles=(GeneratorAngles(gen) if default_angles
                                     else sim.column_angles))
            if sim.moving_win is None:
                kw["inj_auxes"] = ()
            if default_draws:
                g_draw = torch.Generator(device=d)
                g_draw.manual_seed(sim.device_seed + 1000003 * (rank + 1))
                kw["draws"] = GeneratorDraws(g_draw)
            else:
                kw["draws"] = sim.process_draws
            out.append(kw)
        return out

    # -- state conversion -------------------------------------------------

    def _slab_rows(self, i):
        """The global z rows of slab i's extended grid, and which lie in
        the global box (all of them when z is periodic: they wrap)."""
        Nz = self.sim.config.Nz
        idx = np.arange(self.config_local.Nz) + i * self.Nz_int - self.g
        if self.sim.config.boundaries_z == "periodic":
            return idx % Nz, np.ones(idx.shape, bool)
        return np.clip(idx, 0, Nz - 1), (idx >= 0) & (idx < Nz)

    def _reslice_z(self, F, i):
        """Slab i's extended cut of a global z-real-space field (halo
        cells from the neighbouring data; zeros beyond the global edges
        of an open box, the periodic wrap otherwise), on its device."""
        rows, valid = self._slab_rows(i)
        out = F.index_select(1, torch.as_tensor(rows, device=F.device))
        if not valid.all():
            mask = torch.as_tensor(valid, device=F.device)[None, :, None]
            out = torch.where(mask, out, torch.zeros_like(out))
        return out.to(self.devices[i])

    def _reslice_spect(self, F, i):
        """Global spectral field -> slab i's.  The radial Hankel basis
        is the same for the slab and the global box (r is not
        decomposed), so the basis change goes through partial space:
        the global inverse z-DFT, the slab cut, the slab's forward
        z-DFT (Ep / Em live in the m -+ 1 bases: the full interpolation
        grid would need per-component Hankel orders)."""
        return tr.fft_z(self._reslice_z(tr.ifft_z(F), i))

    def _resident_slots(self, z, dev, zmin_g, K):
        """Per-slab slot of each particle in the resident column-padded
        layout: column-major (column * K + rank within the column), the
        (Nz_local, K) layout the resident step expects between full
        re-sorts.  A column over K raises."""
        cfgl = self.config_local
        slots = []
        for i in range(self.ndev):
            sel = dev == i
            zmin_loc = zmin_g + (i * self.Nz_int - self.g) * cfgl.dz
            col = np.clip(np.floor((z[sel] - zmin_loc) / cfgl.dz
                                   ).astype(int), 0, cfgl.Nz - 1)
            order = np.argsort(col, kind="stable")
            cs = col[order]
            within = cs
            if len(cs):
                starts = np.r_[0, np.flatnonzero(np.diff(cs)) + 1]
                counts = np.diff(np.r_[starts, len(cs)])
                within = np.arange(len(cs)) - np.repeat(starts, counts)
                if within.max() >= K:
                    raise ValueError(
                        f"Resident species: a z column of slab {i} holds "
                        f"{int(counts.max())} particles > sort_K={K}. "
                        f"Pass a larger sort_K to add_new_species before "
                        f"distributing.")
            slot = np.empty(len(cs), dtype=int)
            slot[order] = cs * K + within
            slots.append(slot)
        return slots

    def _shard_species(self, si, sp, zmin_g):
        """One species' per-slab blocks: live particles binned by z into
        the slab interiors; a resident species in its column layout
        (dead slots parked at their row's centre, so the column-sorted
        invariant holds for every slot), the others front-packed; the
        ring cursor at the last slab's first free slot."""
        cfgl = self.config_local
        z = sp.z.cpu().numpy()
        w = sp.w.cpu().numpy()
        Lz_int = self.Nz_int * cfgl.dz
        dev = np.clip(((z - zmin_g) // Lz_int).astype(int), 0,
                      self.ndev - 1)
        dev = np.where(w != 0, dev, -1)
        max_count = max(int((dev == i).sum()) for i in range(self.ndev))
        resident = si in self._resident_idx
        if resident:
            K = self.sim.species_configs[si].sort_K
            cap = cfgl.Nz * K
            slot_of = self._resident_slots(z, dev, zmin_g, K)
        else:
            cap = _round256(max(1.5 * max_count,
                                1.2 * sp.capacity / self.ndev))
        host = {n: getattr(sp, n).cpu().numpy() for n in ARRAY_FIELDS
                if getattr(sp, n) is not None}
        cnt_last = int((dev == self.ndev - 1).sum())
        blocks = []
        for i in range(self.ndev):
            sel = dev == i
            d = self.devices[i]
            arrays = {}
            for n, arr in host.items():
                out = np.zeros(cap, arr.dtype)
                if n == "inv_gamma":
                    out[:] = 1.0
                if resident:
                    out[slot_of[i]] = arr[sel]
                else:
                    out[:int(sel.sum())] = arr[sel]
                arrays[n] = out
            if resident:
                rows = np.arange(cap) // K
                zmin_loc = zmin_g + (i * self.Nz_int - self.g) * cfgl.dz
                park = (zmin_loc + (rows + 0.5) * cfgl.dz).astype(z.dtype)
                arrays["z"] = np.where(arrays["w"] == 0, park, arrays["z"])
            next_free = (torch.tensor(cnt_last, dtype=torch.int64, device=d)
                         if torch.is_tensor(sp.next_free) else cnt_last)
            blocks.append(sp.replace(
                next_free=next_free, next_id=_tensor_on(sp.next_id, d),
                **{n: torch.as_tensor(a, device=d)
                   for n, a in arrays.items()}))
        return blocks

    def _shard_state(self, state):
        zmin_g = float(state.zmin)
        per_species = [self._shard_species(si, sp, zmin_g)
                       for si, sp in enumerate(state.species)]
        states = []
        for i, d in enumerate(self.devices):
            spect = dataclasses.replace(state.spect, **{
                f.name: self._reslice_spect(getattr(state.spect, f.name), i)
                for f in dataclasses.fields(state.spect)
                if getattr(state.spect, f.name) is not None})
            interp = dataclasses.replace(state.interp, **{
                f.name: self._reslice_z(getattr(state.interp, f.name), i)
                for f in dataclasses.fields(state.interp)
                if getattr(state.interp, f.name) is not None})

            def zero():
                return torch.zeros((), dtype=torch.int64, device=d)
            states.append(SimState(
                spect=spect, interp=interp,
                species=[blocks[i] for blocks in per_species],
                time=state.time, zmin=state.zmin,
                iteration=int(state.iteration), mw_zref=state.mw_zref,
                sort_overflow=zero(), ring_overwrite=zero(),
                migration_overflow=zero()))
        return states

    # -- running ----------------------------------------------------------

    @property
    def graph_blockers(self):
        """Why this run's chunks do not replay all of their steps from
        CUDA graphs (``core.graph.GraphBlockers``): ``loop``, the reasons
        that keep the eager slab loop (on the cards the single card's: a
        process draw source other than the simulation's GeneratorDraws;
        on the CPU none, the slab threads call the chunk runner's body);
        ``exchange``, those that keep only the migration and exchange
        block eager in the slab threads (the single card's: a density
        function on the host, another column angle source).  Slabs on
        several cards replay one graph a card."""
        card = graph_blockers(self.sim, self.options)
        cuda = any(d.type == "cuda" for d in self.devices)
        return GraphBlockers(card.loop if cuda else [], card.exchange)

    @property
    def runner(self):
        """The chunk runner (``parallel.domain.SlabMultiStep``) on the
        current eager slab loop ``multi_step``."""
        if self._runner is None or self._runner.eager_loop is not \
                self.multi_step:
            if self._runner is not None:
                self._runner.release()
            self._runner = dom.SlabMultiStep(self.multi_step,
                                             self.sim.species_configs)
        return self._runner

    def step(self, N=1):
        """Advance the decomposed simulation N steps.

        Honours the diagnostics and checkpoints registered on the
        Simulation (``sim.diags`` / ``sim.checkpoints``): the run goes in
        chunks of at most MAX_CAPTURE steps that end at their periods; at
        iteration 0 and at the end of a chunk on a period the global
        state is gathered into the Simulation and written through the
        same diagnostic classes as a single-card run (fbpic_tpu
        parallel/api.py:344-410).  Each chunk is one call of the chunk
        runner (``runner``: every step replayed from CUDA graphs that hold
        every slab's step, its migration and exchange block inside --
        run eagerly in the slab threads before it where
        ``graph_blockers`` names an ``exchange`` reason --; on the
        CPU the slab threads run the same body; the eager slab loop where
        it names a ``loop`` reason or ``eager`` is set), with
        one host read at its end: the slabs'
        redo flags, the counters (``_check_migration``), the live
        counts and the back-transformed field diagnostics' captures,
        which they consume then.  A chunk run again eagerly (a banded
        re-sort's overflow) counts in ``overflow_totals["rollbacks"]``."""
        sim = self.sim
        if any(d.type == "cuda" for d in self.devices):
            kernels.build_all()          # before any slab thread runs
        all_writers = list(sim.diags) + list(sim.checkpoints)
        writers = [w for w in all_writers if not hasattr(w, "capture")]
        if all_writers and self.iteration == 0:
            self.sync_to_sim()
            for diag in sim.diags:
                diag.write(sim)
        blockers = self.graph_blockers
        eager = self.eager or bool(blockers.loop)
        eager_exchange = bool(blockers.exchange)
        species = tuple(range(len(sim.species_configs)))
        done = 0
        while done < N:
            chunk = min(N - done, MAX_CAPTURE)
            if writers:
                period = min(getattr(d, "period", N) for d in writers)
                chunk = min(chunk, max(1, period - self.iteration % period))
            kwargs = self._antenna_series(chunk)
            self.states, counts = self.runner(
                self.states, self.auxes, chunk, kwargs, live_counts=species,
                eager=eager, eager_exchange=eager_exchange)
            if counts["exchanged"]:
                self._rho_local = True
            done += chunk
            self.iteration += chunk
            if counts["rolled_back"]:
                self.overflow_totals["rollbacks"] = \
                    self.overflow_totals.get("rollbacks", 0) + 1
            self.live_counts = counts["live"]
            for w, caps in zip(self._capture_writers, counts["captures"]):
                w.process_chunk(sim, caps)
            self._check_migration(counts)
            if writers and any(self.iteration % getattr(d, "period", N) == 0
                               for d in writers):
                self.sync_to_sim()
                for w in writers:
                    w.write(sim)
        return self.states

    def _antenna_series(self, chunk):
        """The slabs' step arguments with the antennas' current series
        of one chunk (global coordinates; each slab deposits only the
        plane it owns), computed once per device."""
        sim = self.sim
        if not sim.laser_antennas:
            return self._slab_kwargs
        series = {}
        for d in self.devices:
            if d not in series:
                series[d] = tuple(
                    a.compute_series(self.iteration * sim.dt, chunk,
                                     sim.config.dz, device=d,
                                     dtype=sim.dtype, it0=self.iteration)
                    for a in sim.laser_antennas)
        return [dict(kw, antenna_series=series[d])
                for kw, d in zip(self._slab_kwargs, self.devices)]

    def _check_migration(self, counts):
        """slab 0's counters from the chunk's read (psum'd: every slab
        holds the totals).  Lost migrants, or a sort overflow (the
        single-card sort_K bump cannot re-shard mid-run), raise or warn
        as ``on_migration_overflow`` says; the sort and ring counts are
        added to ``overflow_totals`` and reset."""
        lost, n_sort, n_ring = (counts["migration_overflow"],
                                counts["sort_overflow"],
                                counts["ring_overwrite"])
        self.overflow_totals["migration_overflow"] = lost
        self.overflow_totals["sort_overflow"] += n_sort
        self.overflow_totals["ring_overwrite"] += n_ring
        if n_sort or n_ring:
            self.states = [dataclasses.replace(
                s, sort_overflow=torch.zeros_like(s.sort_overflow),
                ring_overwrite=torch.zeros_like(s.ring_overwrite))
                for s in self.states]
        msgs = []
        if lost > 0:
            msgs.append(
                f"{lost} particle(s) were dropped because a migration "
                f"buffer or a slab's particle capacity overflowed; "
                f"increase migration_buffer or the species capacity.")
        if n_sort > 0:
            msgs.append(
                f"{n_sort} particle-step(s) exceeded a z column's sorted "
                f"capacity on the mesh; pass a larger sort_K to "
                f"add_new_species before distributing.")
        for msg in msgs:
            if self.on_migration_overflow == "error":
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning)

    # -- gather to the Simulation ------------------------------------------

    def _interior(self, F, i):
        """Slab i's interior rows of a z-real-space field, on the
        Simulation's device."""
        return F[:, self.g:self.g + self.Nz_int].to(self.sim.device)

    def _unslice_spect(self, name):
        """The per-slab spectral fields ``name`` -> the global one: the
        slabs' inverse z-DFT, their interiors joined, the global forward
        z-DFT; rho_prev is the record (``_rho_record``)."""
        parts = (self._rho_record() if name == "rho_prev" else
                 [tr.ifft_z(getattr(s.spect, name)) for s in self.states])
        return tr.fft_z(torch.cat([self._interior(F, i)
                                   for i, F in enumerate(parts)], dim=1))

    def _rho_record(self):
        """The charge density the records show, each slab's rho_prev in
        partial (z-real) space: summed over the halo (``sum_guards``)
        where it is each slab's own deposit -- from the first exchange
        block on, unless use_true_rho / correct_divE already sum it in
        the step --, so that the rows next to a slab seam hold the
        neighbour's charge too; the cut of the single card's deposit as
        it was distributed before that.  The slabs' rho_prev itself stays
        local: the next step's current correction reads local sources."""
        parts = [tr.ifft_z(s.spect.rho_prev) for s in self.states]
        if self._rho_local and not (self.options.use_true_rho
                                    or self.options.correct_divE):
            parts = dom.sum_guards(parts, self.g,
                                   self.sim.config.boundaries_z == "periodic")
        return parts

    def _unslice_interp(self, name):
        return torch.cat([self._interior(getattr(s.interp, name), i)
                          for i, s in enumerate(self.states)], dim=1)

    def gather_state(self):
        """The global single-card SimState (the structure of
        ``sim.state``): fields from the slab interiors, the live
        particles of every slab (in slab order) at the front of each
        species' single-card capacity."""
        sim = self.sim
        s0 = self.states[0]
        spect = dataclasses.replace(s0.spect, **{
            f.name: self._unslice_spect(f.name)
            for f in dataclasses.fields(s0.spect)
            if getattr(s0.spect, f.name) is not None})
        interp = dataclasses.replace(s0.interp, **{
            f.name: self._unslice_interp(f.name)
            for f in dataclasses.fields(s0.interp)
            if getattr(s0.interp, f.name) is not None})
        zmin_g = s0.zmin
        z_park = float(zmin_g) + 0.5 * sim.config.Nz * sim.config.dz
        species = []
        for si, sp_t in enumerate(sim.state.species):
            cap_t = sp_t.capacity
            slabs = [s.species[si] for s in self.states]
            live = [sp.w != 0 for sp in slabs]
            n_live = int(sum(int(m.sum()) for m in live))
            if n_live > cap_t:
                raise RuntimeError(
                    f"Gathered particle count ({n_live}) exceeds the "
                    f"single-card capacity ({cap_t}); increase the "
                    f"species capacity before distributing.")
            updates = {}
            for n in ARRAY_FIELDS:
                arr_t = getattr(sp_t, n)
                if arr_t is None:
                    continue
                out = torch.zeros_like(arr_t)
                if n == "inv_gamma":
                    out.fill_(1.0)
                elif n == "z":
                    out.fill_(z_park)
                vals = torch.cat([getattr(sp, n)[m].to(arr_t.device)
                                  for sp, m in zip(slabs, live)])
                out[:n_live] = vals.to(arr_t.dtype)
                updates[n] = out
            nf = n_live % cap_t if cap_t else 0
            updates["next_free"] = (torch.tensor(nf, dtype=torch.int64,
                                                 device=sim.device)
                                    if torch.is_tensor(sp_t.next_free)
                                    else nf)
            updates["next_id"] = _tensor_on(slabs[0].next_id, sim.device)
            updates["inj_z_end"] = slabs[0].inj_z_end
            species.append(sp_t.replace(**updates))
        return dataclasses.replace(
            sim.state, spect=spect, interp=interp, species=species,
            time=s0.time, zmin=zmin_g, iteration=int(s0.iteration),
            mw_zref=s0.mw_zref,
            sort_overflow=torch.zeros_like(sim.state.sort_overflow),
            ring_overwrite=torch.zeros_like(sim.state.ring_overwrite),
            migration_overflow=None)

    def sync_to_sim(self):
        """Install the gathered global state into the Simulation (its
        diagnostics, checkpoints and accessors then see the current
        decomposed data) and carry slab 0's generator state into the
        Simulation's generator."""
        self.sim.state = self.gather_state()
        self.sim.generator.set_state(self._generators[0].get_state())
        return self.sim

    # -- observation ------------------------------------------------------

    def get_interp_field(self, name, m=0):
        """Mode ``m`` of a field on the global internal grid (complex
        numpy (Nz_global, Nr)), reassembled from the slab interiors:
        Ez, Bz, rho_prev, rho_next from the spectral fields as each slab
        holds them, rho the record's charge density (``_rho_record``:
        rho_prev summed over the halo), any interpolation-grid field as
        stored."""
        spect_names = {"Ez": "Ez", "Bz": "Bz", "rho_prev": "rho_prev",
                       "rho_next": "rho_next"}
        rho = self._rho_record() if name == "rho" else None
        out = []
        for i, (s, aux) in enumerate(zip(self.states, self.auxes)):
            if rho is not None:
                F = tr.dht(aux.mats.invM0, rho[i])
            elif name in spect_names:
                F = tr.spect2interp_scal(aux.mats,
                                         getattr(s.spect, spect_names[name]))
            else:
                F = getattr(s.interp, name)
            out.append(F[m, self.g:self.g + self.Nz_int].cpu().numpy())
        return np.concatenate(out, axis=0)


def distribute_simulation(sim, n_devices=None, devices=None, **kwargs):
    """Decompose a configured Simulation over a z mesh: ``n_devices``
    CUDA devices (default all), or the given ``devices`` (a card may
    repeat; ``["cpu"] * N`` on the CPU).  Call after all species /
    lasers / moving-window / diagnostics setup.  Keyword arguments:
    ``axis_name``, ``migration_buffer``, ``n_guard``,
    ``on_migration_overflow`` ("error" or "warn") and the step options of ``Simulation.step``.  Returns a
    :class:`DistributedRun`; ``sim`` itself is no longer stepped."""
    return DistributedRun(sim, n_devices=n_devices, devices=devices,
                          **kwargs)
