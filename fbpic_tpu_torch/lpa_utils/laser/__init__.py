from .laser import add_laser_pulse
from .laser_profiles import LaserProfile, GaussianLaser

__all__ = ["add_laser_pulse", "LaserProfile", "GaussianLaser"]
