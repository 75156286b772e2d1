"""The uniform draws of the elementary processes.

fbpic_tpu draws every random number of ionization and Compton
scattering from a ``jax.random`` key derived from the seed, the
purpose, the species and the iteration (its core/step.py:92-110).  The
port draws them through a replaceable source, as it does the injection
angles (particles/injection.py): ``Simulation.process_draws``, called as
``source(name, iteration, species_index, shape, dtype)``, one name per
fbpic_tpu ``jax.random`` call:

- ``ionize``: one draw per slot of an ionizable species;
- ``compton_u`` (slots,): the fractional photon count;
- ``compton_r1``, ``compton_r2`` (buffer, N_REJECT): the rejection banks
  of the Klein-Nishina angle;
- ``compton_phi`` (buffer,): the azimuth of the scattered photon, in
  [0, 2 pi);
- ``compton_recoil`` (slots,): the recoil decision.

A caller may substitute any callable, e.g. one that reproduces
fbpic_tpu's draws.  On a slab of a z-decomposed run (parallel/) the
source is also called with ``rank=`` the slab's rank, which fbpic_tpu
folds into its key so that the slabs draw independently; the default
source ignores it (each slab draws from a generator of its own).

On CUDA the chunk runner (core/graph.py) replays captured steps, which
call the source only at their capture: the source's ``iteration`` is
then the capture's, and whatever the source does on the host is not
done again.  It takes the default source into its graphs: a
``GeneratorDraws`` (or a subclass) of the simulation's ``generator``,
which ignores ``iteration`` and draws on the device from that
generator; the runner registers the generator with every graph it
captures (the slabs' runner, parallel/domain.py, each slab's own), so
that each replay draws fresh numbers from its Philox offset, which
advances as the eager step's would.  A run with another
source keeps the eager loop on CUDA (core/graph.py's
``graph_blockers``); on the CPU the runner calls the step itself, so
any source works there.
"""
import numpy as np
import torch


class GeneratorDraws:
    """Default source: ``torch.rand`` from a ``torch.Generator`` on the
    simulation's device (no host round trip); the iteration is not
    read, so the chunk runner's graphs replay it."""

    def __init__(self, generator):
        self.generator = generator

    def __call__(self, name, iteration, species_index, shape, dtype,
                 rank=None):
        u = torch.rand(shape, generator=self.generator, dtype=dtype,
                       device=self.generator.device)
        return 2.0 * np.pi * u if name == "compton_phi" else u
