"""Lorentz boosted-frame conversions.

Standard special-relativity transforms applied at initialization time
(host-side numpy).

Attribution: the transform logic flow follows FBPIC
(lpa_utils/boosted_frame.py), Copyright 2016-2018 FBPIC contributors
(University of Hamburg / LBNL), 3-Clause-BSD-LBNL license.
"""
import numpy as np

from ..constants import c


class BoostConverter(object):
    """Converts lab-frame quantities to the boosted frame (gamma0)."""

    def __init__(self, gamma0):
        self.gamma0 = gamma0
        self.beta0 = np.sqrt(1.0 - 1.0 / gamma0**2)

    # Length / density -------------------------------------------------
    def static_length(self, lab_frame_vars):
        """Length of an object at rest in the lab (contracted)."""
        return [length / self.gamma0 for length in lab_frame_vars]

    def copropag_length(self, lab_frame_vars, beta_object=1.0):
        """Length of an object copropagating at beta_object."""
        convert_factor = 1.0 / (self.gamma0 * (1.0 - self.beta0 * beta_object))
        return [length * convert_factor for length in lab_frame_vars]

    def static_density(self, lab_frame_vars):
        """Density of a plasma at rest in the lab (compressed)."""
        return [dens * self.gamma0 for dens in lab_frame_vars]

    def copropag_density(self, lab_frame_vars, beta_object=1.0):
        """Density of an object copropagating at beta_object."""
        convert_factor = self.gamma0 * (1.0 - self.beta0 * beta_object)
        return [dens * convert_factor for dens in lab_frame_vars]

    # Velocity / momentum ----------------------------------------------
    def velocity(self, lab_frame_vars):
        """Relativistic velocity addition."""
        return [(v - c * self.beta0) / (1.0 - v * self.beta0 / c)
                for v in lab_frame_vars]

    def longitudinal_momentum(self, lab_frame_vars):
        """uz (normalized momentum) of particles moving along +z."""
        out = []
        for uz in lab_frame_vars:
            gamma_lab = np.sqrt(1.0 + uz**2)
            out.append(self.gamma0 * (uz - self.beta0 * gamma_lab))
        return out

    def gamma(self, lab_frame_vars):
        """Lorentz factor of particles moving along +z."""
        out = []
        for gamma_lab in lab_frame_vars:
            uz_lab = np.sqrt(gamma_lab**2 - 1.0)
            out.append(self.gamma0 * (gamma_lab - self.beta0 * uz_lab))
        return out

    def wavenumber(self, lab_frame_vars):
        """Wavenumber of a laser propagating along +z."""
        return [k / (self.gamma0 * (1.0 + self.beta0))
                for k in lab_frame_vars]

    # Particles ----------------------------------------------------------
    def boost_particle_arrays(self, x, y, z, ux, uy, uz, inv_gamma):
        """Transform a t=const lab snapshot to t'=0 in the boosted frame,
        propagating ballistically (reference: boosted_frame.py:222-275)."""
        uz_boost = self.gamma0 * self.beta0
        t_boost = -uz_boost * z / c
        z_boost = self.gamma0 * z
        gamma_lab = np.sqrt(1.0 + (ux * ux + uy * uy + uz * uz))
        new_ux = np.array(ux, copy=True)
        new_uy = np.array(uy, copy=True)
        new_uz = self.gamma0 * uz - uz_boost * gamma_lab
        gamma_boost = np.sqrt(1.0 + new_ux**2 + new_uy**2 + new_uz**2)
        new_x = x - t_boost * new_ux * c / gamma_boost
        new_y = y - t_boost * new_uy * c / gamma_boost
        new_z = z_boost - t_boost * new_uz * c / gamma_boost
        return (new_x, new_y, new_z, new_ux, new_uy, new_uz,
                1.0 / gamma_boost)

    def interaction_time(self, L_interact, l_window, v_window):
        """Time for the moving window to cross the interaction length,
        in the boosted frame."""
        L_i = L_interact / self.gamma0
        l_w = l_window * self.gamma0 * (1.0 + self.beta0)
        v_w, = self.velocity([v_window])
        v_plasma = -c * self.beta0
        return (L_i + l_w) / (v_w - v_plasma)
