"""Top-level laser injection API (reference: lpa_utils/laser/laser.py)."""
from ..boosted_frame import BoostConverter
from .direct_injection import add_laser_direct


def add_laser_pulse(sim, laser_profile, gamma_boost=None, method="direct"):
    """Introduce a laser pulse in the simulation.

    method: 'direct' adds the fields to the mesh via a global spectral
    solve on the host (reference: laser.py:14-111).  gamma_boost: the
    profile is given in the lab frame and evaluated in the boosted frame
    of that Lorentz factor.  The antenna method is not ported.
    """
    if method != "direct":
        raise NotImplementedError(
            f"laser injection method {method!r} is not ported")
    boost = None
    if gamma_boost is not None and gamma_boost != 1.0:
        boost = BoostConverter(gamma_boost)
    add_laser_direct(sim, laser_profile, boost)
