from .laser import add_laser_pulse, add_laser
from .laser_profiles import LaserProfile, GaussianLaser

__all__ = ["add_laser_pulse", "add_laser", "LaserProfile", "GaussianLaser"]
