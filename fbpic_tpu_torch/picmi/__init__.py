"""PICMI interface of fbpic_tpu_torch: the portable declarative input layer.

Maps PICMI-standard objects (CylindricalGrid, Species, GaussianLaser,
diagnostics...) onto fbpic_tpu_torch objects, as fbpic_tpu/picmi does
onto fbpic_tpu's: self-contained classes of the standard's signatures
(the standard is a thin argument container), so no ``picmistandard``
package is needed.
"""
from .simulation import (
    Simulation, CylindricalGrid, ElectromagneticSolver, BinomialSmoother,
    GaussianLaser, LaserAntenna, Species, MultiSpecies,
    UniformDistribution, AnalyticDistribution, GaussianBunchDistribution,
    ParticleListDistribution, GriddedLayout, PseudoRandomLayout,
    FieldDiagnostic, ParticleDiagnostic, LabFrameFieldDiagnostic,
    LabFrameParticleDiagnostic, Mirror, ConstantAppliedField,
    AnalyticAppliedField,
)

codename = "fbpic"

__all__ = [
    "Simulation", "CylindricalGrid", "ElectromagneticSolver",
    "BinomialSmoother", "GaussianLaser", "LaserAntenna", "Species",
    "MultiSpecies", "UniformDistribution", "AnalyticDistribution",
    "GaussianBunchDistribution", "ParticleListDistribution",
    "GriddedLayout", "PseudoRandomLayout", "FieldDiagnostic",
    "ParticleDiagnostic", "LabFrameFieldDiagnostic",
    "LabFrameParticleDiagnostic", "Mirror", "ConstantAppliedField",
    "AnalyticAppliedField", "codename",
]
