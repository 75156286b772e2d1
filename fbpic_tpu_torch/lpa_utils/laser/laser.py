"""Top-level laser injection API (reference: lpa_utils/laser/laser.py)."""
from .direct_injection import add_laser_direct


def add_laser_pulse(sim, laser_profile, method="direct"):
    """Introduce a laser pulse in the simulation.

    method: 'direct' adds the fields to the mesh via a global spectral
    solve on the host (reference: laser.py:14-111).  The antenna method
    and the boosted frame are not ported.
    """
    if method != "direct":
        raise NotImplementedError(
            f"laser injection method {method!r} is not ported")
    add_laser_direct(sim, laser_profile)
