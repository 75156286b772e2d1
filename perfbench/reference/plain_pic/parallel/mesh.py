"""The device mesh of a z-decomposed run, and the particle placement rule.

fbpic_tpu's ``make_mesh`` returns a 1-D ``jax.sharding.Mesh``
(its parallel/mesh.py:21-43); the port's ``Mesh`` is the ordered list of
``torch.device`` the slabs run on, one per slab, and the axis name.  A
list may name one card several times: several slabs then share it
(``devices=["cuda:0", "cuda:0"]``), as the slab threads of
``parallel.group`` allow.  Nothing falls back to another device: a mesh
on CUDA without a CUDA device, or with more slabs than cards when the
devices are not given, is an error.
"""
from dataclasses import dataclass, fields as dc_fields
from typing import List

import torch


@dataclass(frozen=True)
class Mesh:
    """The devices of the slabs (slab i on ``devices[i]``) and the name
    of the decomposed axis."""
    devices: List[torch.device]
    axis_name: str = "z"

    @property
    def size(self):
        return len(self.devices)


def _too_many(n_devices, avail):
    return ValueError(
        f"requested a {n_devices}-device mesh but only {len(avail)} "
        f"device(s) are available ({[str(d) for d in avail[:2]]}...); "
        f"to run several slabs on one card pass devices=['cuda:0'] * N, "
        f"for a CPU mesh devices=['cpu'] * N")


def make_mesh(n_devices=None, axis_name="z", devices=None):
    """A 1-D mesh of ``n_devices`` CUDA devices (default: all), or of the
    given ``devices`` (any torch devices, repeats allowed).

    Asking for more CUDA devices than exist is an error -- silently
    truncating would turn a multi-device run into a smaller one -- and
    so is a CUDA mesh where torch sees no CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: CUDA is not available (pass devices=['cpu'] "
                "* N for a CPU mesh)")
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        if n_devices is not None and n_devices > len(avail):
            raise _too_many(n_devices, avail)
        devices = avail[: n_devices or len(avail)]
    else:
        devices = [torch.device(d) for d in devices]
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} "
                             f"devices were given")
        if not devices:
            raise ValueError("make_mesh: no devices")
        cuda = [d for d in devices if d.type == "cuda"]
        if cuda:
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh: CUDA devices were asked for "
                                   "but CUDA is not available")
            count = torch.cuda.device_count()
            avail = [torch.device("cuda", i) for i in range(count)]
            for d in cuda:
                if (d.index or 0) >= count:
                    raise _too_many(max((c.index or 0) for c in cuda) + 1,
                                    avail)
            devices = [torch.device("cuda", d.index or 0)
                       if d.type == "cuda" else d for d in devices]
    return Mesh(list(devices), axis_name)


def particle_dp_shardings(mesh, state, axis_name="p"):
    """fbpic_tpu's placement rule for particle data parallelism (its
    parallel/mesh.py:46-58): every 1-D per-particle array of a species
    is split over the mesh along its capacity axis, everything else
    (fields, scalars) is replicated.  Returns {keypath: spec}, the
    keypaths as fbpic_tpu names its leaves (``.species[0].x``,
    ``.spect.Ez``, ``.time``), the spec ``(axis_name,)`` for split and
    ``()`` for replicated, as a PartitionSpec's entries."""
    out = {}
    for part in ("spect", "interp"):
        block = getattr(state, part)
        for f in dc_fields(block):
            if getattr(block, f.name) is not None:
                out[f".{part}.{f.name}"] = ()
    for i, sp in enumerate(state.species):
        for f in dc_fields(sp):
            v = getattr(sp, f.name)
            if v is None:
                continue
            split = torch.is_tensor(v) and v.dim() == 1
            out[f".species[{i}].{f.name}"] = (axis_name,) if split else ()
    for name in ("time", "zmin", "iteration", "mw_zref", "sort_overflow",
                 "ring_overwrite"):
        if getattr(state, name, None) is not None:
            out[f".{name}"] = ()
    return out
