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
"""
import numpy as np
import torch


class GeneratorDraws:
    """Default source: ``torch.rand`` from a ``torch.Generator`` on the
    simulation's device (no host round trip)."""

    def __init__(self, generator):
        self.generator = generator

    def __call__(self, name, iteration, species_index, shape, dtype,
                 rank=None):
        u = torch.rand(shape, generator=self.generator, dtype=dtype,
                       device=self.generator.device)
        return 2.0 * np.pi * u if name == "compton_phi" else u
