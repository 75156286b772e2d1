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
    resident, resort, particle_shape too; an ionizer or Compton config
    becomes the port's IonizerConfig / ComptonConfig, field by field)."""
    from ..particles.ionization import IonizerConfig
    from ..particles.compton import ComptonConfig

    def converted(value, cls):
        if value is None:
            return None
        return cls(**{f.name: getattr(value, f.name)
                      for f in dc_fields(cls)})
    out = []
    for sc in species_configs:
        kw = {f.name: getattr(sc, f.name) for f in dc_fields(SpeciesConfig)}
        kw["ionizer"] = converted(kw["ionizer"], IonizerConfig)
        kw["compton"] = converted(kw["compton"], ComptonConfig)
        out.append(SpeciesConfig(**kw))
    return out


def state_from_numpy(spect, interp, species, time, zmin, iteration,
                     mw_zref=None, sort_overflow=0, ring_overwrite=0,
                     *, device, dtype=torch.float64, process_targets=()):
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
    joined as ``hi << 32 | lo``, and ``next_id`` (with ``next_id_hi``);
    an ionizable species has its ``ionization_level`` (int32).  An
    injecting species (its inj_z_end set) and the species whose indices
    are in ``process_targets`` (those ionization or Compton scattering
    write into) get their cursor next_free and counter next_id as 0-d
    int64 device tensors, as Simulation gives them; the others as host
    ints.
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
            if sp.get(name) is not None and name not in (
                    "ids", "ionization_level"):
                arrays[name] = torch.as_tensor(np.array(sp[name]),
                                               dtype=dtype, device=device)
        if sp.get("ionization_level") is not None:
            arrays["ionization_level"] = torch.as_tensor(
                np.array(sp["ionization_level"]).astype(np.int32),
                device=device)
        next_id = 0
        if sp.get("ids") is not None:
            arrays["ids"] = torch.as_tensor(
                join_words(sp["ids"], sp.get("ids_hi")).astype(np.int64),
                device=device)
            next_id = int(join_words(sp.get("next_id") or 0,
                                     sp.get("next_id_hi")))
        z_end = sp.get("inj_z_end")
        next_free = int(sp.get("next_free") or 0)
        if len(parts) in process_targets or z_end is not None:
            next_free, next_id = (
                torch.tensor(v, dtype=torch.int64, device=device)
                for v in (next_free, next_id))
        parts.append(ParticleState(
            next_free=next_free, next_id=next_id,
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


def state_from_leaves(leaves, *, device, dtype=torch.float64,
                      process_targets=()):
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
        device=device, dtype=dtype, process_targets=process_targets)


def slab_states_from_numpy(spect, interp, species, time, zmin, iteration,
                           n_slabs, mw_zref=None, sort_overflow=0,
                           ring_overwrite=0, migration_overflow=0, *,
                           devices, dtype=torch.float64,
                           process_targets=()):
    """The per-slab SimStates of a z-decomposed run from the numpy
    leaves of fbpic_tpu's ``DistributedRun.state``: its fields are the
    slabs' (Nm, Nz_local, Nr) blocks concatenated along z, its particle
    arrays the slabs' (cap_local,) blocks concatenated; its scalars and
    counters are replicated (the arguments as ``state_from_numpy``
    takes them).  Slab i's block goes to ``devices[i]`` (a list, one per
    slab, or one device for all); every slab's ``zmin`` is the global
    edge, as the port's DistributedRun keeps it."""
    if not isinstance(devices, (list, tuple)):
        devices = [devices] * n_slabs

    def block(arr, i, axis):
        if arr is None:
            return None
        arr = np.asarray(arr)
        n = arr.shape[axis] // n_slabs
        return np.take(arr, np.arange(i * n, (i + 1) * n), axis=axis)

    states = []
    for i in range(n_slabs):
        parts = []
        for sp in species:
            part = {}
            for name, value in sp.items():
                is_array = name in ARRAY_FIELDS or name == "ids_hi"
                part[name] = block(value, i, 0) if is_array else value
            parts.append(part)
        st = state_from_numpy(
            {n: block(v, i, 1) for n, v in spect.items()},
            {n: block(v, i, 1) for n, v in interp.items()}, parts,
            time, zmin, iteration, mw_zref=mw_zref,
            sort_overflow=sort_overflow, ring_overwrite=ring_overwrite,
            device=devices[i], dtype=dtype,
            process_targets=process_targets)
        st.migration_overflow = torch.as_tensor(
            int(migration_overflow), dtype=torch.int64, device=devices[i])
        states.append(st)
    return states
