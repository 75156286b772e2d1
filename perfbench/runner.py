"""What the harness reads of a built run and writes into it, the same for
the program and the plain reference (duck-typed: a ``Simulation`` on one
card, or the ``DistributedRun`` of ``distribute_simulation`` for slabs).

A snapshot (``Runner.snapshot``) is the run's state copied to the host
with what continues it: the generators' states and, for slabs, the
run's iteration and whether its rho_prev is already the slabs' own."""
import torch

from .state_io import rebuild, to_host


class Runner:
    def __init__(self, obj):
        self.obj = obj
        self.slabs = hasattr(obj, "states")

    @property
    def sim(self):
        return self.obj.sim if self.slabs else self.obj

    def step(self, n):
        self.obj.step(n)

    @property
    def states(self):
        """The run's SimStates: one, or one a slab."""
        return list(self.obj.states) if self.slabs else [self.obj.state]

    @property
    def exchange_period(self):
        return self.obj.exchange_period

    @property
    def devices(self):
        return ([torch.device(d) for d in self.obj.devices] if self.slabs
                else [self.obj.device])

    @property
    def cards(self):
        """The indices of the cards the run uses (none on the CPU)."""
        return sorted({d.index for d in self.devices if d.type == "cuda"})

    def sync(self):
        for c in self.cards:
            torch.cuda.synchronize(c)

    def live(self):
        """Live macroparticles of every species and slab (one host read
        a device)."""
        return sum(int(torch.stack([(sp.w != 0).sum()
                                    for sp in st.species]).sum())
                   for st in self.states)

    def counters(self):
        """The program's running counters: lost particles (columns,
        rings, migration buffers) and chunks it ran again."""
        t = self.obj.overflow_totals
        return {k: int(t.get(k, 0)) for k in (
            "sort_overflow", "ring_overwrite", "migration_overflow",
            "rollbacks")}

    def lost(self):
        c = self.counters()
        return c["sort_overflow"] + c["ring_overwrite"] \
            + c["migration_overflow"]

    def graph_variants(self):
        """CUDA graphs the chunk runner holds (one a step variant)."""
        ms = (getattr(self.obj, "_runner", None) if self.slabs
              else getattr(self.obj, "_multi_step", None))
        return len(getattr(ms, "graphs", None) or {})

    def grid(self):
        """The configuration's physical grid (global Nz), for the work
        counters."""
        sim = self.sim
        return dict(Nz=sim.Nz_phys, Nr=sim.config.Nr, Nm=sim.config.Nm)

    def moment_grid(self):
        """(dz, Nz, dr, Nr) of the global internal grid, on which the
        particles' moments are binned."""
        cfg = self.sim.config
        return cfg.dz, cfg.Nz, cfg.dr, cfg.Nr

    def generators(self):
        return (list(self.obj._generators) if self.slabs
                else [self.obj.generator])

    def snapshot(self):
        return dict(
            states=to_host(self.states),
            generators=[g.get_state() for g in self.generators()],
            iteration=getattr(self.obj, "iteration", None),
            rho_local=getattr(self.obj, "_rho_local", None))

    def restore(self, snap, package):
        """Continue from a snapshot (of this run or of another package's
        run of the same configuration): the states rebuilt of
        ``package``'s classes on this run's devices."""
        states = [rebuild(s, package, d)
                  for s, d in zip(snap["states"], self.devices)]
        if self.slabs:
            self.obj.states = states
            self.obj.iteration = snap["iteration"]
            self.obj._rho_local = snap["rho_local"]
        else:
            self.obj.state = states[0]
        for g, st in zip(self.generators(), snap["generators"]):
            g.set_state(st)
