from .laser import add_laser_pulse, add_laser
from .laser_profiles import (
    LaserProfile, GaussianLaser, LaguerreGaussLaser,
    DonutLikeLaguerreGaussLaser, FlattenedGaussianLaser, FewCycleLaser,
    CustomSpectrumLaser, FromLasyFileLaser, ParaxialApproximationLaser,
    GaussianChirpedLongitudinalProfile, CustomSpectrumLongitudinalProfile,
    GaussianTransverseProfile, LaguerreGaussTransverseProfile,
    DonutLikeLaguerreGaussTransverseProfile,
    FlattenedGaussianTransverseProfile,
)

__all__ = [
    "add_laser_pulse", "add_laser", "LaserProfile", "GaussianLaser",
    "LaguerreGaussLaser", "DonutLikeLaguerreGaussLaser",
    "FlattenedGaussianLaser", "FewCycleLaser", "CustomSpectrumLaser",
    "FromLasyFileLaser", "ParaxialApproximationLaser",
]
