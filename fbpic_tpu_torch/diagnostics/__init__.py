"""openPMD diagnostics, checkpoints and back-transformed snapshots.

Each diagnostic's ``collect`` returns its records as numpy (the device
work); ``write_records`` writes them with h5py (see generic.py).
"""
from .generic import OpenPMDDiagnostic
from .field_diag import FieldDiagnostic, ParticleChargeDensityDiagnostic
from .particle_diag import ParticleDiagnostic
from .checkpoint_restart import (
    set_periodic_checkpoint, restart_from_checkpoint,
)
from .inputscript_diag import InputScriptDiagnostic
from .boosted_diag import (
    BackTransformedFieldDiagnostic, BoostedFieldDiagnostic,
    BackTransformedParticleDiagnostic, BoostedParticleDiagnostic,
)

__all__ = [
    "OpenPMDDiagnostic", "FieldDiagnostic",
    "ParticleChargeDensityDiagnostic", "ParticleDiagnostic",
    "set_periodic_checkpoint", "restart_from_checkpoint",
    "InputScriptDiagnostic", "BackTransformedFieldDiagnostic",
    "BoostedFieldDiagnostic", "BackTransformedParticleDiagnostic",
    "BoostedParticleDiagnostic",
]
