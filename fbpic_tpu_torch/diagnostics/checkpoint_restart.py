"""Checkpoint / restart: save and reload the full simulation state.

As in fbpic_tpu, a checkpoint holds the complete state, not openPMD
records, so a restart is bit-exact.  The file is
``checkpoints/checkpoint_%08d.pt``, written with ``torch.save`` and read
with ``torch.load(weights_only=True)``.  It holds a dict:

- ``tensors``: every state tensor under fbpic_tpu's keypath names
  (``.spect.Ep``, ``.interp.Er``, ``.species[0].x``, ``.species[0].ids``,
  ``.sort_overflow``, ...; the radial PML's ``.spect.Ep_pml`` ... and
  cross-deposition's ``.spect.rho_next_xy`` / ``_z`` where the
  simulation has them; complex fields as complex tensors, where
  fbpic_tpu stores ``.re`` / ``.im`` pairs; ids as one int64 per slot),
  and ``generator_state``, the state of ``sim.generator``: the
  injection angles and thermal momenta drawn after a restart depend on
  it (a CUDA generator's state does not fit a CPU generator: a restart
  on another kind of device warns and keeps its own);
- ``host``: the host values the step reads: ``iteration``, ``time``,
  ``zmin``, ``mw_zref``, each species' ``next_free``, ``inj_z_end``,
  ``next_id``, ``sort_K``, ``resident`` and capacity (sort_K and the
  capacity change at run time), the loaded particle counts and the
  overflow totals.

fbpic_tpu stores neither ``sort_K`` nor a generator state (its
randomness is derived from a key in the state).
"""
import glob
import os
import warnings
from dataclasses import replace

import torch

from ..core.state import SimState
from ..fields.solver import SpectralFields, InterpFields, present_fields
from ..particles.state import ARRAY_FIELDS, ParticleState


class Checkpoint(object):
    """Periodic full-state checkpoint writer (not at iteration 0)."""

    def __init__(self, period, checkpoint_dir="./checkpoints"):
        self.period = period
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        os.makedirs(self.checkpoint_dir, exist_ok=True)

    def write(self, sim):
        iteration = sim.iteration
        if iteration % self.period != 0 or iteration == 0:
            return
        write_checkpoint(sim, os.path.join(
            self.checkpoint_dir, "checkpoint_%08d.pt" % iteration))


def set_periodic_checkpoint(sim, period, checkpoint_dir="./checkpoints"):
    """Register periodic checkpoints of the full simulation state
    (reference API: openpmd_diag/checkpoint_restart.py:22)."""
    sim.checkpoints.append(Checkpoint(period, checkpoint_dir))


def checkpoint_dict(sim):
    """The checkpoint of ``sim`` as a dict of tensors and host values
    (the tensors are the state's own, not copies)."""
    st = sim.state
    tensors = {".spect." + n: getattr(st.spect, n)
               for n in present_fields(st.spect)}
    tensors.update({".interp." + n: getattr(st.interp, n)
                    for n in present_fields(st.interp)})
    species = []
    for i, (sp, sc) in enumerate(zip(st.species, sim.species_configs)):
        for name in ARRAY_FIELDS:
            if getattr(sp, name) is not None:
                tensors[".species[%d].%s" % (i, name)] = getattr(sp, name)
        species.append(dict(
            next_free=int(sp.next_free), next_id=int(sp.next_id),
            inj_z_end=None if sp.inj_z_end is None else float(sp.inj_z_end),
            sort_K=int(sc.sort_K), resident=bool(sc.resident),
            capacity=int(sp.capacity)))
    tensors[".sort_overflow"] = st.sort_overflow
    tensors[".ring_overwrite"] = st.ring_overwrite
    tensors["generator_state"] = sim.generator.get_state()
    host = dict(
        iteration=int(st.iteration), time=float(st.time),
        zmin=float(st.zmin),
        mw_zref=None if st.mw_zref is None else float(st.mw_zref),
        dtype=str(sim.dtype), generator_device=sim.generator.device.type,
        species=species,
        species_counts=[int(n) for n in sim._species_counts],
        overflow_totals=dict(sim.overflow_totals))
    return dict(tensors=tensors, host=host)


def load_checkpoint_dict(sim, ckpt):
    """Set ``sim``'s state, sort_K, counters and generator from a
    checkpoint dict.  The simulation must be configured as the one that
    wrote it (grid, species, tracking); the checkpoint's tracking ids
    are taken even where ``track()`` was not called again."""
    host, tensors = ckpt["host"], ckpt["tensors"]
    if host["dtype"] != str(sim.dtype):
        raise RuntimeError(f"checkpoint dtype {host['dtype']} != the "
                           f"simulation's {sim.dtype}")
    if len(host["species"]) != len(sim.species_configs):
        raise RuntimeError("the checkpoint has %d species, the simulation "
                           "%d" % (len(host["species"]),
                                   len(sim.species_configs)))
    dev, rdt = sim.device, sim.np_dtype

    def tensor(key):
        if key not in tensors:
            raise RuntimeError(
                "Checkpoint is missing %r -- configure the simulation as "
                "the one that wrote it before restarting" % key)
        return tensors[key].to(dev)

    spect = SpectralFields(**{n: tensor(".spect." + n)
                              for n in present_fields(sim.state.spect)})
    interp = InterpFields(**{n: tensor(".interp." + n)
                             for n in present_fields(sim.state.interp)})
    species = []
    for i, (sp, h) in enumerate(zip(sim.state.species, host["species"])):
        arrays = {}
        for name in ARRAY_FIELDS:
            key = ".species[%d].%s" % (i, name)
            if key in tensors or getattr(sp, name) is not None:
                arrays[name] = tensor(key)
        species.append(ParticleState(
            next_free=h["next_free"], next_id=h["next_id"],
            inj_z_end=None if h["inj_z_end"] is None else rdt(h["inj_z_end"]),
            **arrays))
        sc = sim.species_configs[i]
        if sc.resident != h["resident"]:
            raise RuntimeError(f"species {i}: resident={sc.resident} in the "
                               f"simulation, {h['resident']} in the "
                               f"checkpoint")
        sim.species_configs[i] = replace(sc, sort_K=h["sort_K"])
    sim.state = SimState(
        spect=spect, interp=interp, species=species, time=rdt(host["time"]),
        zmin=rdt(host["zmin"]), iteration=host["iteration"],
        mw_zref=None if host["mw_zref"] is None else rdt(host["mw_zref"]),
        sort_overflow=tensor(".sort_overflow"),
        ring_overwrite=tensor(".ring_overwrite"))
    sim._species_counts = list(host["species_counts"])
    sim.overflow_totals = dict(host["overflow_totals"])
    if host["generator_device"] == sim.generator.device.type:
        sim.generator.set_state(tensors["generator_state"].cpu())
    else:
        warnings.warn(
            f"the checkpoint's generator state is a "
            f"{host['generator_device']} generator's; this simulation's "
            f"runs on {sim.generator.device.type}, so its injection draws "
            f"after the restart differ from the run that wrote it",
            RuntimeWarning)


def write_checkpoint(sim, path):
    torch.save(checkpoint_dict(sim), path)


def read_checkpoint(path, device):
    """A checkpoint dict from ``path``, its tensors on ``device``."""
    return torch.load(path, map_location=device, weights_only=True)


def checkpoint_path(iteration=None, checkpoint_dir="./checkpoints"):
    """The file of ``iteration``, or the latest checkpoint."""
    checkpoint_dir = os.path.abspath(checkpoint_dir)
    if iteration is not None:
        return os.path.join(checkpoint_dir, "checkpoint_%08d.pt" % iteration)
    files = sorted(glob.glob(os.path.join(checkpoint_dir,
                                          "checkpoint_*.pt")))
    if not files:
        raise RuntimeError("No checkpoint found in %s" % checkpoint_dir)
    return files[-1]


def restart_from_checkpoint(sim, iteration=None,
                            checkpoint_dir="./checkpoints"):
    """Reload the latest (or the given iteration's) checkpoint into
    ``sim`` (reference API: openpmd_diag/checkpoint_restart.py:77)."""
    load_checkpoint_dict(sim, read_checkpoint(
        checkpoint_path(iteration, checkpoint_dir), sim.device))
