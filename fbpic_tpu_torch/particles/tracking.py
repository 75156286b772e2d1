"""Particle tracking: a unique id per macroparticle.

One int64 per slot (0 in a dead or never-written slot).  The ids ride
the resident column sort as an integer channel beside the float ones
(core/step.py).  Continuous injection hands out one id per candidate
particle from the species' counter ``next_id``, ionization and Compton
scattering one per newborn (core/step.py ``append_new_particles`` /
``append_into_padded``); the counter is a host int, or a 0-d device
tensor in a species that those processes write into.  fbpic_tpu keeps
two uint32 words per id (the TPU has no 64-bit integers); its
diagnostics join them as ``hi << 32 | lo``, the value stored here.
"""
import torch


def tracked_slot_count(sim, index):
    """The slots fbpic_tpu numbers when tracking starts: its
    ``SpeciesView.Ntot``, the capacity of a species that receives
    particles at run time (continuous injection, ionization, Compton
    scattering), else the count loaded by ``add_new_species``."""
    if sim.creates_at_run_time(index):
        return sim.state.species[index].capacity
    return sim._species_counts[index]


def enable_tracking(sim, view):
    """Give ids 1..n to the first n slots (n = ``tracked_slot_count``;
    dead slots among them keep 0) and start the species' id counter at
    n + 1.  Reference API: ``Particles.track(comm)``."""
    idx = view._index
    sp = sim.state.species[idx]
    n = tracked_slot_count(sim, idx)
    ids = torch.zeros(sp.capacity, dtype=torch.int64, device=sp.w.device)
    ids[:n] = torch.arange(1, n + 1, device=sp.w.device)
    ids = torch.where(sp.w != 0, ids, torch.zeros_like(ids))
    next_id = n + 1
    if torch.is_tensor(sp.next_free):      # created at run time
        next_id = sim._device_counter(next_id)
    sim.state.species[idx] = sp.replace(ids=ids, next_id=next_id)
