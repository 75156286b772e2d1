"""Top-level laser injection API (reference: lpa_utils/laser/laser.py)."""
from scipy.constants import c

from ..boosted_frame import BoostConverter
from .laser_profiles import GaussianLaser
from .direct_injection import add_laser_direct
from .antenna_injection import LaserAntenna


def add_laser_pulse(sim, laser_profile, gamma_boost=None,
                    method="direct", z0_antenna=None, v_antenna=0.0):
    """Introduce a laser pulse in the simulation.

    method: 'direct' adds the fields to the mesh via a global spectral
    solve on the host; 'antenna' emits the laser progressively from a
    virtual antenna plane at z0_antenna moving at v_antenna (reference:
    laser.py:14-111).  gamma_boost: the profile (and a lab-static
    antenna) is given in the lab frame and converted to the boosted
    frame of that Lorentz factor.
    """
    boost = None
    if gamma_boost is not None and gamma_boost != 1.0:
        boost = BoostConverter(gamma_boost)

    if method == "direct":
        add_laser_direct(sim, laser_profile, boost)
    elif method == "antenna":
        if z0_antenna is None:
            raise ValueError("`z0_antenna` is required for method='antenna'")
        antenna = LaserAntenna(
            laser_profile, z0_antenna, v_antenna,
            sim.grid_z(), sim.grid_r(), sim.config.dr, sim.dt,
            sim.config.Nm, boost=boost)
        sim.laser_antennas.append(antenna)
    else:
        raise ValueError("Unknown laser injection method: %s" % method)


def add_laser(sim, a0, w0, ctau, z0, zf=None, lambda0=0.8e-6,
              cep_phase=0.0, phi2_chirp=0.0, theta_pol=0.0,
              gamma_boost=None, method="direct", fw_propagating=True,
              filter_currents=True, z0_antenna=None):
    """Legacy interface: add a linearly-polarized Gaussian laser
    (reference: laser.py:113-214)."""
    direction = 1 if fw_propagating else -1
    profile = GaussianLaser(
        a0=a0, waist=w0, tau=ctau / c, z0=z0, zf=zf, theta_pol=theta_pol,
        lambda0=lambda0, cep_phase=cep_phase, phi2_chirp=phi2_chirp,
        propagation_direction=direction)
    add_laser_pulse(sim, profile, gamma_boost=gamma_boost, method=method,
                    z0_antenna=z0_antenna)
