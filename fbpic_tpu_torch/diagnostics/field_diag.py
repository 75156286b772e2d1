"""Field diagnostic: rho, E, B, J per azimuthal mode, thetaMode geometry.

Datasets have shape (2*Nm - 1, Nr, Nz): mode-0 real, then for each
m >= 1 the real and imaginary parts scaled by 2 (Lifschitz et al.
convention), as fbpic_tpu writes them.  The device work is the inverse
transforms of rho and J (``Simulation.get_interp_field``) and, for
``ParticleChargeDensityDiagnostic``, one charge deposit per species.
"""
import numpy as np

from .generic import OpenPMDDiagnostic, Records, _s


def stack_modes(data):
    """(Nm, Nz, Nr) complex -> (2*Nm - 1, Nr, Nz) float64."""
    Nm, Nz, Nr = data.shape
    out = np.empty((2 * Nm - 1, Nr, Nz), dtype="f8")
    out[0] = data[0].T.real
    for m in range(1, Nm):
        out[2 * m - 1] = 2 * data[m].T.real
        out[2 * m] = 2 * data[m].T.imag
    return out


class FieldDiagnostic(OpenPMDDiagnostic):
    """Writes grid fields at regular intervals."""

    def __init__(self, period=None, fldobject=None, comm=None,
                 fieldtypes=("rho", "E", "B", "J"), write_dir=None,
                 iteration_min=0, iteration_max=np.inf,
                 dt_period=None, sim=None):
        # `fldobject` may be the Simulation itself; scripts pass sim.fld,
        # which is the Simulation
        self.sim = sim or fldobject
        dt_sim = self.sim.dt if self.sim is not None else None
        OpenPMDDiagnostic.__init__(
            self, period, comm, write_dir, iteration_min, iteration_max,
            dt_period=dt_period, dt_sim=dt_sim)
        self.fieldtypes = list(fieldtypes)
        self.coords = ["r", "t", "z"]

    # -----------------------------------------------------------------
    def collect(self, sim, iteration=None):
        if isinstance(sim, int):
            sim = self.sim
        self.sim = sim
        if iteration is None:
            iteration = sim.iteration
        cfg = sim.config
        dz = cfg.dz
        zmin = sim.zmin + sim.nd_edge * dz
        rec = Records()
        self.setup_openpmd_file(rec, iteration, sim.time, sim.dt)
        field_path = "/data/%d/fields" % iteration
        self.setup_openpmd_meshes_group(rec.group(field_path))
        for fieldtype in self.fieldtypes:
            if fieldtype.startswith("rho") or fieldtype.endswith("_pml"):
                attrs = rec.dataset(
                    "%s/%s" % (field_path, fieldtype),
                    stack_modes(self.get_dataset(sim, fieldtype)))
                self.setup_openpmd_mesh_component(attrs)
                self.setup_openpmd_mesh_record(attrs, fieldtype, dz, zmin)
            elif fieldtype in ("E", "B", "J"):
                for coord in self.coords:
                    attrs = rec.dataset(
                        "%s/%s/%s" % (field_path, fieldtype, coord),
                        stack_modes(self.get_dataset(
                            sim, fieldtype + coord)))
                    self.setup_openpmd_mesh_component(attrs)
                self.setup_openpmd_mesh_record(
                    rec.group("%s/%s" % (field_path, fieldtype)),
                    fieldtype, dz, zmin)
            else:
                raise ValueError(
                    "Invalid string in fieldtypes: %s" % fieldtype)
        return {"data%08d.h5" % iteration: rec}

    def get_dataset(self, sim, quantity):
        """The (Nm, Nz, Nr) complex numpy array of `quantity`."""
        return sim.get_interp_field(quantity)

    # -----------------------------------------------------------------
    def setup_openpmd_meshes_group(self, attrs):
        attrs["fieldSolver"] = _s("PSATD")
        attrs["fieldBoundary"] = np.array(
            [b"reflecting", b"reflecting", b"reflecting", b"reflecting"])
        attrs["particleBoundary"] = np.array(
            [b"absorbing", b"absorbing", b"absorbing", b"absorbing"])
        attrs["currentSmoothing"] = _s("Binomial")
        attrs["currentSmoothingParameters"] = _s(
            "period=1;numPasses=1;compensator=false")
        attrs["chargeCorrection"] = _s("spectral")
        attrs["chargeCorrectionParameters"] = _s("period=1")

    def setup_openpmd_mesh_record(self, attrs, quantity, dz, zmin):
        if quantity.startswith("rho"):
            key = "rho"
        elif quantity.endswith("_pml"):
            key = quantity
        else:
            key = quantity[0]  # 'E', 'B' or 'J'
        self.setup_openpmd_record(attrs, key)
        cfg = self.sim.config
        attrs["geometry"] = _s("thetaMode")
        attrs["geometryParameters"] = _s("m=%d;imag=+" % cfg.Nm)
        attrs["gridSpacing"] = np.array([cfg.dr, dz])
        attrs["gridGlobalOffset"] = np.array([0.5 * cfg.dr, zmin + 0.5 * dz])
        attrs["axisLabels"] = np.array([b"r", b"z"])
        attrs["dataOrder"] = _s("C")
        attrs["gridUnitSI"] = 1.0
        attrs["fieldSmoothing"] = _s("none")

    def setup_openpmd_mesh_component(self, attrs):
        self.setup_openpmd_component(attrs)
        attrs["position"] = np.array([0.5, 0.5])


class ParticleChargeDensityDiagnostic(FieldDiagnostic):
    """Charge density of individual species, each deposited on its own
    (``Simulation.deposit_single_species_rho``); records ``rho_<name>``."""

    def __init__(self, period=None, sim=None, species=None, comm=None,
                 write_dir=None, iteration_min=0, iteration_max=np.inf,
                 dt_period=None):
        species = species or {}
        self.species_dict = species
        fieldtypes = ["rho_%s" % name for name in species.keys()]
        FieldDiagnostic.__init__(
            self, period=period, fldobject=sim, comm=comm,
            fieldtypes=fieldtypes, write_dir=write_dir,
            iteration_min=iteration_min, iteration_max=iteration_max,
            dt_period=dt_period, sim=sim)

    def get_dataset(self, sim, quantity):
        return sim.deposit_single_species_rho(self.species_dict[quantity[4:]])
