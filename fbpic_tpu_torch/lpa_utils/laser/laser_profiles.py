"""Laser profiles: complex transverse/longitudinal envelopes (host numpy).

This copy keeps GaussianLaser and the base classes it needs; the other
profiles of fbpic_tpu are not ported yet.

Profiles are evaluated once at injection time on the host (float64) --
they are not part of the device hot loop.

Attribution: the class decomposition, attribute naming and paraxial
formula bodies are condensed from FBPIC
(lpa_utils/laser/laser_profiles.py, transverse_laser_profiles.py,
longitudinal_laser_profiles.py), Copyright 2016-2018 FBPIC
contributors (University of Hamburg / LBNL), 3-Clause-BSD-LBNL
license.  Class names and signatures are kept for API compatibility;
the implementation derives from that code, not a fresh derivation.
"""
import numpy as np
from scipy.constants import c, m_e, e


# ---------------------------------------------------------------------
# Base classes
# ---------------------------------------------------------------------

class LaserProfile(object):
    """Base class for laser profiles; provides E_field(x, y, z, t)
    (reference: laser_profiles.py:20-103)."""

    def __init__(self, propagation_direction):
        assert propagation_direction in (-1, 1)
        self.propag_direction = float(propagation_direction)

    def E_field(self, x, y, z, t):
        """Return (Ex, Ey) at given positions and time."""
        return np.zeros_like(x), np.zeros_like(x)


# ---------------------------------------------------------------------
# Longitudinal profiles
# ---------------------------------------------------------------------

class LaserLongitudinalProfile(object):
    def __init__(self, propagation_direction):
        assert propagation_direction in (-1, 1)
        self.propag_direction = float(propagation_direction)

    def evaluate(self, z, t):
        raise NotImplementedError


class GaussianChirpedLongitudinalProfile(LaserLongitudinalProfile):
    """Gaussian (possibly chirped) longitudinal envelope.

    Derived from the spectral representation
    E(w) = exp(-(w - w0)^2 (tau^2/4 + i phi2/2)); reference:
    longitudinal_laser_profiles.py:97-187.
    """

    def __init__(self, tau, z0, lambda0=0.8e-6, cep_phase=0.0,
                 phi2_chirp=0.0, propagation_direction=1):
        LaserLongitudinalProfile.__init__(self, propagation_direction)
        self.k0 = 2 * np.pi / lambda0
        self.z0 = z0
        self.cep_phase = cep_phase
        self.phi2_chirp = phi2_chirp
        self.inv_ctau2 = 1.0 / (c * tau) ** 2

    def evaluate(self, z, t):
        prop_dir = self.propag_direction
        stretch = 1 - 2j * self.phi2_chirp * c**2 * self.inv_ctau2
        xi = prop_dir * (z - self.z0) - c * t
        exp_argument = (
            -1j * self.cep_phase
            + 1j * self.k0 * xi
            - 1.0 / stretch * self.inv_ctau2 * xi**2
        )
        return np.exp(exp_argument) / stretch**0.5


# ---------------------------------------------------------------------
# Transverse profiles
# ---------------------------------------------------------------------

class LaserTransverseProfile(object):
    def __init__(self, propagation_direction):
        assert propagation_direction in (-1, 1)
        self.propag_direction = float(propagation_direction)

    def evaluate(self, x, y, z):
        raise NotImplementedError


class GaussianTransverseProfile(LaserTransverseProfile):
    """Gaussian transverse envelope with exact paraxial propagation
    (diffraction, Gouy phase, wavefront curvature).
    Reference: transverse_laser_profiles.py:94-166."""

    def __init__(self, waist, zf=0.0, lambda0=0.8e-6,
                 propagation_direction=1):
        LaserTransverseProfile.__init__(self, propagation_direction)
        k0 = 2 * np.pi / lambda0
        zr = 0.5 * k0 * waist**2
        self.k0 = k0
        self.inv_zr = 1.0 / zr
        self.zf = zf
        self.w0 = waist

    def evaluate(self, x, y, z):
        prop_dir = self.propag_direction
        diffract = 1.0 + 1j * prop_dir * (z - self.zf) * self.inv_zr
        exp_argument = -(x**2 + y**2) / (self.w0**2 * diffract)
        return np.exp(exp_argument) / diffract


# ---------------------------------------------------------------------
# Composed paraxial profiles
# ---------------------------------------------------------------------

class ParaxialApproximationLaser(LaserProfile):
    """Compose longitudinal x transverse complex profiles (paraxial).
    Reference: laser_profiles.py:105-176."""

    def __init__(self, E0x, E0y, longitudinal_profile, transverse_profile):
        assert (longitudinal_profile.propag_direction
                == transverse_profile.propag_direction)
        LaserProfile.__init__(
            self, int(longitudinal_profile.propag_direction))
        self.E0x = E0x
        self.E0y = E0y
        self.longitudinal_profile = longitudinal_profile
        self.transverse_profile = transverse_profile

    def E_field(self, x, y, z, t):
        profile = self.longitudinal_profile.evaluate(z, t) \
            * self.transverse_profile.evaluate(x, y, z)
        return (self.E0x * profile).real, (self.E0y * profile).real


def _E0_from_a0(a0, lambda0):
    k0 = 2 * np.pi / lambda0
    return a0 * m_e * c**2 * k0 / e


class GaussianLaser(ParaxialApproximationLaser):
    """Linearly-polarized Gaussian laser pulse.
    Reference: laser_profiles.py:179-296."""

    def __init__(self, a0, waist, tau, z0, zf=None, theta_pol=0.0,
                 lambda0=0.8e-6, cep_phase=0.0, phi2_chirp=0.0,
                 propagation_direction=1):
        E0 = _E0_from_a0(a0, lambda0)
        if zf is None:
            zf = z0
        long_prof = GaussianChirpedLongitudinalProfile(
            tau=tau, z0=z0, lambda0=lambda0, cep_phase=cep_phase,
            phi2_chirp=phi2_chirp,
            propagation_direction=propagation_direction)
        trans_prof = GaussianTransverseProfile(
            waist=waist, zf=zf, lambda0=lambda0,
            propagation_direction=propagation_direction)
        ParaxialApproximationLaser.__init__(
            self, E0 * np.cos(theta_pol), E0 * np.sin(theta_pol),
            long_prof, trans_prof)

