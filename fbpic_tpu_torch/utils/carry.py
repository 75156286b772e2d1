"""Build the port's SimState and GridConfig from another simulation's.

Used to start fbpic_tpu_torch from exactly the state of an fbpic_tpu run
(its SimState turned into numpy arrays by the caller: split-complex
fields become ``re + 1j * im``; its GridConfig read field by field), or
from an fbpic_tpu checkpoint's named leaves (``state_from_leaves``), so
both packages can be stepped from the same state and compared.
"""
import re
from dataclasses import fields as dc_fields

import numpy as np
import torch

from ..core.state import SimState
from ..fields.solver import (
    GridConfig, SpectralFields, InterpFields, complex_dtype,
)
from ..particles.state import ARRAY_FIELDS, ParticleState, SpeciesConfig


def join_words(lo, hi=None):
    """fbpic_tpu's two-word ids (uint32 low and high words) as uint64:
    ``hi << 32 | lo``; one word (or one int64 per id) as it is."""
    lo = np.asarray(lo).astype(np.uint64)
    if hi is None:
        return lo
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | lo


def config_from(config):
    """The port's GridConfig with the values of another GridConfig (e.g.
    fbpic_tpu's), field by field: the comoving fields v_comoving and
    use_galilean too."""
    return GridConfig(**{f.name: getattr(config, f.name)
                         for f in dc_fields(GridConfig)})


def species_configs_from(species_configs):
    """The port's SpeciesConfig of each of another package's species
    configs (e.g. fbpic_tpu's), field by field (is_tracer, sort_K,
    resident, resort, particle_shape too)."""
    return [SpeciesConfig(**{f.name: getattr(sc, f.name)
                             for f in dc_fields(SpeciesConfig)})
            for sc in species_configs]


def state_from_numpy(spect, interp, species, time, zmin, iteration,
                     mw_zref=None, sort_overflow=0, ring_overwrite=0,
                     *, device, dtype=torch.float64):
    """SimState from numpy data.

    spect / interp: mappings from the SpectralFields / InterpFields field
    names to complex (Nm, Nz, Nr) arrays; the optional fields (the
    radial PML's ``*_pml``, cross-deposition's ``rho_next_xy`` /
    ``rho_next_z``) where the mapping holds them (not None).  species: one mapping per
    species with the per-particle arrays x, y, z, ux, uy, uz, inv_gamma,
    w (and comp_x, comp_y, comp_z for float32 runs) in their storage
    order, and the scalars next_free and inj_z_end (None when not
    injecting); a tracked species also has its ids, either one int64 per
    slot or fbpic_tpu's two uint32 words ``ids`` (low) and ``ids_hi``,
    joined as ``hi << 32 | lo``, and ``next_id`` (with ``next_id_hi``).
    The capacity is the arrays' length: Nz * sort_K for a resident
    species, any length for a ring species (whose cursor is next_free),
    zero for an empty species without slots.  time, zmin,
    mw_zref: floats (rounded to the working dtype); iteration: int.
    device: where the state lives (required: no default device).  The
    field coefficients are not part of the state: ``build_field_aux`` of
    the carried ``config_from`` rebuilds them (standard or Galilean /
    comoving).
    """
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cdt = complex_dtype(dtype)

    def fields_of(cls, arrays):
        return cls(**{f.name: torch.as_tensor(np.array(arrays[f.name]),
                                              dtype=cdt, device=device)
                      for f in dc_fields(cls)
                      if arrays.get(f.name) is not None})

    parts = []
    for sp in species:
        arrays = {}
        for name in ARRAY_FIELDS:
            if sp.get(name) is not None and name != "ids":
                arrays[name] = torch.as_tensor(np.array(sp[name]),
                                               dtype=dtype, device=device)
        next_id = 0
        if sp.get("ids") is not None:
            arrays["ids"] = torch.as_tensor(
                join_words(sp["ids"], sp.get("ids_hi")).astype(np.int64),
                device=device)
            next_id = int(join_words(sp.get("next_id") or 0,
                                     sp.get("next_id_hi")))
        z_end = sp.get("inj_z_end")
        parts.append(ParticleState(
            next_free=int(sp.get("next_free") or 0), next_id=next_id,
            inj_z_end=None if z_end is None else np_dtype(z_end), **arrays))

    def counter(v):
        return torch.as_tensor(int(v), dtype=torch.int64, device=device)

    return SimState(
        spect=fields_of(SpectralFields, spect),
        interp=fields_of(InterpFields, interp),
        species=parts, time=np_dtype(time), zmin=np_dtype(zmin),
        iteration=int(iteration),
        mw_zref=None if mw_zref is None else np_dtype(mw_zref),
        sort_overflow=counter(sort_overflow),
        ring_overwrite=counter(ring_overwrite))


_LEAF = re.compile(r"^\.(spect|interp)\.(\w+)\.(re|im)$"
                   r"|^\.species\[(\d+)\]\.(\w+)$|^\.(\w+)$")


def state_from_leaves(leaves, *, device, dtype=torch.float64):
    """SimState from an fbpic_tpu checkpoint's named leaves: the mapping
    from each leaf's keypath (``.spect.Ep.re``, ``.species[0].ids``,
    ``.time``, ...: fbpic_tpu's diagnostics/checkpoint_restart.py:50-66)
    to its array.  Split-complex fields become complex, two-word ids
    int64 (``state_from_numpy``); leaves the port has no use for
    (``seed``) are dropped."""
    fields = {"spect": {}, "interp": {}}
    species, scalars = {}, {}
    for name, value in leaves.items():
        m = _LEAF.match(name)
        if m is None:
            raise ValueError(f"not an fbpic_tpu state keypath: {name!r}")
        if m.group(1):
            part = fields[m.group(1)].setdefault(m.group(2), {})
            part[m.group(3)] = np.asarray(value)
        elif m.group(4):
            species.setdefault(int(m.group(4)), {})[m.group(5)] = value
        else:
            scalars[m.group(6)] = value
    spect, interp = ({n: p["re"] + 1j * p["im"] for n, p in f.items()}
                     for f in (fields["spect"], fields["interp"]))
    parts = []
    for i in range(len(species)):
        sp = {k: (None if v is None else np.asarray(v))
              for k, v in species[i].items()}
        for k in ("next_free", "inj_z_end", "next_id", "next_id_hi"):
            if sp.get(k) is not None:
                sp[k] = sp[k].item()
        parts.append(sp)

    def scalar(name, default=None):
        v = scalars.get(name)
        return default if v is None else np.asarray(v).item()
    return state_from_numpy(
        spect, interp, parts, time=scalar("time"), zmin=scalar("zmin"),
        iteration=scalar("iteration"), mw_zref=scalar("mw_zref"),
        sort_overflow=scalar("sort_overflow", 0),
        ring_overwrite=scalar("ring_overwrite", 0),
        device=device, dtype=dtype)
