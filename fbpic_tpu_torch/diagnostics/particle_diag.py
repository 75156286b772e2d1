"""Particle diagnostic: per-species arrays with selection filters.

The selection runs on the device (live slots, ``w != 0``, and the
``select`` bounds, strict at both ends); only the selected slots are
copied to the host, in storage order, as fbpic_tpu writes them.  E and B
at the particles are gathered at write time from the interpolation
grid (``particles/gather.py::gather_fields_linear``), as in fbpic_tpu.
"""
import numpy as np
import torch

from ..constants import c
from .generic import (OpenPMDDiagnostic, Records, setup_particle_record,
                      unit_dimension_dict, macro_weighted_dict,
                      weighting_power_dict)


def _quantity(sp, name):
    """The (capacity,) tensor of a selectable quantity of a species."""
    if name == "gamma":
        return 1.0 / sp.inv_gamma
    if name == "id":
        return sp.ids
    return getattr(sp, name)


def selected_slots(sp, select=None):
    """Indices (storage order) of the live slots of species state ``sp``
    whose quantities lie strictly inside the ``select`` bounds."""
    mask = sp.w != 0
    for quantity, (lo, hi) in (select or {}).items():
        vals = _quantity(sp, quantity)
        if lo is not None:
            mask = mask & (vals > lo)
        if hi is not None:
            mask = mask & (vals < hi)
    return torch.nonzero(mask).squeeze(1)


def _species_scalars(rec, path, n, q, m):
    for record, value in (("charge", q), ("mass", m)):
        attrs = rec.group("%s/%s" % (path, record))
        attrs["value"] = value
        attrs["shape"] = np.array([n], dtype=np.uint64)
        attrs["unitDimension"] = unit_dimension_dict[record]
        attrs["timeOffset"] = 0.0
        attrs["macroWeighted"] = macro_weighted_dict[record]
        attrs["weightingPower"] = weighting_power_dict[record]
        attrs["unitSI"] = 1.0


def _component(rec, path, data):
    rec.dataset(path, data)["unitSI"] = 1.0


def _position_offset(rec, path, n):
    for comp in "xyz":
        attrs = rec.group("%s/positionOffset/%s" % (path, comp))
        attrs["value"] = 0.0
        attrs["shape"] = np.array([n], dtype=np.uint64)
        attrs["unitSI"] = 1.0
    setup_particle_record(rec.group(path + "/positionOffset"),
                          "positionOffset")


class ParticleDiagnostic(OpenPMDDiagnostic):
    """Writes selected particle quantities at regular intervals.

    period: output period in iterations; species: {name: SpeciesView};
    select: e.g. {'uz': [0.05, None]}, the particles whose quantity lies
    strictly between the bounds (None = unbounded); particle_data:
    quantities among 'position', 'momentum', 'weighting', 'E', 'B',
    'gamma', 'id'.
    """

    def __init__(self, period=None, species=None, comm=None,
                 particle_data=("position", "momentum", "weighting"),
                 select=None, write_dir=None, iteration_min=0,
                 iteration_max=np.inf, dt_period=None, sim=None):
        self.species_dict = species or {}
        self.select = select
        self.particle_data = list(particle_data)
        dt_sim = sim.dt if sim is not None else None
        if dt_sim is None and self.species_dict:
            view = next(iter(self.species_dict.values()))
            dt_sim = getattr(getattr(view, "_sim", None), "dt", None)
        OpenPMDDiagnostic.__init__(
            self, period, comm, write_dir, iteration_min, iteration_max,
            dt_period=dt_period, dt_sim=dt_sim)

    # -----------------------------------------------------------------
    def collect(self, sim, iteration=None):
        if isinstance(sim, int):
            sim = None
        if sim is None and self.species_dict:
            sim = next(iter(self.species_dict.values()))._sim
        if iteration is None:
            iteration = sim.iteration
        rec = Records()
        self.setup_openpmd_file(rec, iteration, sim.time, sim.dt)
        for name, view in self.species_dict.items():
            self.collect_species(
                rec, "/data/%d/particles/%s" % (iteration, name), view)
        return {"data%08d.h5" % iteration: rec}

    def collect_species(self, rec, path, view):
        sim = view._sim
        sp = sim.state.species[view._index]
        idx = selected_slots(sp, self.select)
        n = int(idx.shape[0])

        def host(t):
            return t[idx].cpu().numpy()

        _species_scalars(rec, path, n, view.q, view.m)
        for quantity in self.particle_data:
            if quantity == "position":
                for comp in "xyz":
                    _component(rec, "%s/position/%s" % (path, comp),
                               host(getattr(sp, comp)))
                setup_particle_record(rec.group(path + "/position"),
                                      "position")
                _position_offset(rec, path, n)
            elif quantity == "momentum":
                for comp in "xyz":
                    _component(rec, "%s/momentum/%s" % (path, comp),
                               host(getattr(sp, "u" + comp)) * view.m * c)
                setup_particle_record(rec.group(path + "/momentum"),
                                      "momentum")
            elif quantity == "weighting":
                _component(rec, path + "/weighting", host(sp.w))
                setup_particle_record(rec[path + "/weighting"][1],
                                      "weighting")
            elif quantity == "gamma":
                _component(rec, path + "/gamma", 1.0 / host(sp.inv_gamma))
                setup_particle_record(rec[path + "/gamma"][1], "gamma")
            elif quantity == "id":
                if sp.ids is not None:
                    _component(rec, path + "/id",
                               host(sp.ids).astype(np.uint64))
                    setup_particle_record(rec[path + "/id"][1], "id")
            elif quantity in ("E", "B"):
                from ..particles.gather import gather_fields_linear
                cfg = sim.config
                comps = gather_fields_linear(
                    sp.x[idx], sp.y[idx], sp.z[idx], sim.state.interp,
                    sim.get_rmax_gather(), 1.0 / cfg.dz,
                    float(sim.state.zmin), cfg.Nz, 1.0 / cfg.dr, 0.0,
                    cfg.Nr)
                trio = comps[:3] if quantity == "E" else comps[3:]
                for comp, vals in zip("xyz", trio):
                    _component(rec, "%s/%s/%s" % (path, quantity, comp),
                               vals.cpu().numpy())
                setup_particle_record(rec.group("%s/%s" % (path, quantity)),
                                      quantity)
            else:
                raise ValueError("Invalid particle_data: %s" % quantity)


def species_arrays_records(rec, path, arrays, q, m, ids=None):
    """Records of plain numpy particle arrays (x, y, z, ux, uy, uz, w: SI
    and dimensionless u) in ParticleDiagnostic's layout; the
    back-transformed particle diagnostic writes its snapshots so."""
    n = len(arrays["w"])
    _species_scalars(rec, path, n, q, m)
    for comp in "xyz":
        _component(rec, "%s/position/%s" % (path, comp), arrays[comp])
    setup_particle_record(rec.group(path + "/position"), "position")
    _position_offset(rec, path, n)
    for comp in "xyz":
        _component(rec, "%s/momentum/%s" % (path, comp),
                   np.asarray(arrays["u" + comp]) * m * c)
    setup_particle_record(rec.group(path + "/momentum"), "momentum")
    _component(rec, path + "/weighting", arrays["w"])
    setup_particle_record(rec[path + "/weighting"][1], "weighting")
    if ids is not None:
        _component(rec, path + "/id", ids)
        setup_particle_record(rec[path + "/id"][1], "id")
