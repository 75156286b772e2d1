"""Build the port's SimState from another simulation's arrays.

Used to start fbpic_tpu_torch from exactly the state of an fbpic_tpu run
(its SimState turned into numpy arrays by the caller: split-complex
fields become ``re + 1j * im``), so both packages can be stepped from
the same state and compared.
"""
from dataclasses import fields as dc_fields

import numpy as np
import torch

from ..core.state import SimState
from ..fields.solver import SpectralFields, InterpFields, complex_dtype
from ..particles.state import ARRAY_FIELDS, ParticleState


def state_from_numpy(spect, interp, species, time, zmin, iteration,
                     mw_zref=None, sort_overflow=0, ring_overwrite=0,
                     device="cpu", dtype=torch.float64):
    """SimState from numpy data.

    spect / interp: mappings from the SpectralFields / InterpFields field
    names to complex (Nm, Nz, Nr) arrays.  species: one mapping per
    species with the per-particle arrays x, y, z, ux, uy, uz, inv_gamma,
    w (and comp_x, comp_y, comp_z for float32 runs) and the scalars
    next_free and inj_z_end (None when not injecting).  time, zmin,
    mw_zref: floats (rounded to the working dtype); iteration: int.
    """
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cdt = complex_dtype(dtype)

    def fields_of(cls, arrays):
        return cls(**{f.name: torch.as_tensor(np.array(arrays[f.name]),
                                              dtype=cdt, device=device)
                      for f in dc_fields(cls)})

    parts = []
    for sp in species:
        arrays = {}
        for name in ARRAY_FIELDS:
            if sp.get(name) is not None:
                arrays[name] = torch.as_tensor(np.array(sp[name]),
                                               dtype=dtype, device=device)
        z_end = sp.get("inj_z_end")
        parts.append(ParticleState(
            next_free=int(sp.get("next_free") or 0),
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
