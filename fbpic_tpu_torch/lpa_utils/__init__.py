from .boosted_frame import BoostConverter
from .bunch import (
    add_particle_bunch, add_particle_bunch_gaussian,
    add_particle_bunch_file, add_particle_bunch_openPMD,
    add_particle_bunch_from_arrays, get_space_charge_fields,
    add_elec_bunch, add_elec_bunch_gaussian, add_elec_bunch_file,
    add_elec_bunch_openPMD, add_elec_bunch_from_arrays,
)
from .external_fields import ExternalField
from .mirrors import Mirror

__all__ = [
    "BoostConverter", "add_particle_bunch", "add_particle_bunch_gaussian",
    "add_particle_bunch_file", "add_particle_bunch_openPMD",
    "add_particle_bunch_from_arrays", "get_space_charge_fields",
    "add_elec_bunch", "add_elec_bunch_gaussian", "add_elec_bunch_file",
    "add_elec_bunch_openPMD", "add_elec_bunch_from_arrays",
    "ExternalField", "Mirror",
]
