"""Laser profiles: complex transverse/longitudinal envelopes (host numpy).

Profiles are evaluated on the host (float64): once at injection time for
the direct method, once per block of steps for an antenna
(antenna_injection.py) -- they are not part of the device hot loop.
This module is numpy and scipy only, a copy of fbpic_tpu's.

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
from scipy.special import genlaguerre, binom, factorial
from scipy.optimize import fsolve


# ---------------------------------------------------------------------
# Base classes
# ---------------------------------------------------------------------

class LaserProfile(object):
    """Base class for laser profiles; provides E_field(x, y, z, t) and
    profile summation via `+` (reference: laser_profiles.py:20-103)."""

    def __init__(self, propagation_direction, gpu_capable=False):
        assert propagation_direction in (-1, 1)
        self.propag_direction = float(propagation_direction)
        self.gpu_capable = gpu_capable

    def E_field(self, x, y, z, t):
        """Return (Ex, Ey) at given positions and time."""
        return np.zeros_like(x), np.zeros_like(x)

    def __add__(self, other):
        return SummedLaserProfile(self, other)

    def squared_profile_integral(self):
        raise NotImplementedError


class SummedLaserProfile(LaserProfile):
    """Sum of two laser profiles (must propagate in the same direction)."""

    def __init__(self, profile1, profile2):
        if profile1.propag_direction != profile2.propag_direction:
            raise ValueError(
                "Summed profiles must propagate in the same direction.")
        LaserProfile.__init__(self, int(profile1.propag_direction))
        self.profile1 = profile1
        self.profile2 = profile2

    def E_field(self, x, y, z, t):
        Ex1, Ey1 = self.profile1.E_field(x, y, z, t)
        Ex2, Ey2 = self.profile2.E_field(x, y, z, t)
        return Ex1 + Ex2, Ey1 + Ey2


# ---------------------------------------------------------------------
# Longitudinal profiles
# ---------------------------------------------------------------------

class LaserLongitudinalProfile(object):
    def __init__(self, propagation_direction, gpu_capable=False):
        assert propagation_direction in (-1, 1)
        self.propag_direction = float(propagation_direction)
        self.gpu_capable = gpu_capable

    def evaluate(self, z, t):
        raise NotImplementedError

    def squared_profile_integral(self):
        raise NotImplementedError


class GaussianChirpedLongitudinalProfile(LaserLongitudinalProfile):
    """Gaussian (possibly chirped) longitudinal envelope.

    Derived from the spectral representation
    E(w) = exp(-(w - w0)^2 (tau^2/4 + i phi2/2)); reference:
    longitudinal_laser_profiles.py:97-187.
    """

    def __init__(self, tau, z0, lambda0=0.8e-6, cep_phase=0.0,
                 phi2_chirp=0.0, propagation_direction=1):
        LaserLongitudinalProfile.__init__(self, propagation_direction, True)
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

    def squared_profile_integral(self):
        return (0.5 * np.pi * 1.0 / self.inv_ctau2) ** 0.5


class CustomSpectrumLongitudinalProfile(LaserLongitudinalProfile):
    """Longitudinal profile built from a user-provided spectrum file.

    The file must contain two columns: wavelength (m) and relative
    spectral intensity (arbitrary units), optionally a third column with
    spectral phase.  Reference: longitudinal_laser_profiles.py:190+.
    """

    def __init__(self, z0, spectrum_file, propagation_direction=1):
        LaserLongitudinalProfile.__init__(self, propagation_direction, False)
        self.z0 = z0
        data = np.loadtxt(spectrum_file)
        wavelength = data[:, 0]
        intensity = data[:, 1]
        phase = data[:, 2] if data.shape[1] > 2 else np.zeros_like(wavelength)
        # Spectral amplitude on an omega grid
        omega = 2 * np.pi * c / wavelength[::-1]
        amp = np.sqrt(intensity[::-1])
        ph = phase[::-1]
        # Uniform omega grid for the inverse FFT
        N = 2 ** int(np.ceil(np.log2(len(omega) * 8)))
        omega_uniform = np.linspace(omega.min(), omega.max(), N)
        amp_u = np.interp(omega_uniform, omega, amp)
        ph_u = np.interp(omega_uniform, omega, ph)
        spectral = amp_u * np.exp(1j * ph_u)
        # Time-domain complex envelope via inverse FFT
        dw = omega_uniform[1] - omega_uniform[0]
        t_grid = 2 * np.pi * np.fft.fftfreq(N, dw)
        order = np.argsort(t_grid)
        env = np.fft.ifft(spectral)
        self._t_grid = t_grid[order]
        self._env = env[order]
        self._omega0 = np.average(omega_uniform, weights=np.abs(spectral)**2)
        self.k0 = self._omega0 / c
        norm = np.abs(self._env).max()
        self._env = self._env / norm

    def evaluate(self, z, t):
        prop_dir = self.propag_direction
        # Retarded time of each point
        t_ret = (c * t - prop_dir * (z - self.z0)) / c
        env = np.interp(t_ret.ravel(), self._t_grid, self._env.real) \
            + 1j * np.interp(t_ret.ravel(), self._t_grid, self._env.imag)
        env = env.reshape(np.shape(t_ret))
        return env * np.exp(-1j * self._omega0 * t_ret)

    def squared_profile_integral(self):
        dt = self._t_grid[1] - self._t_grid[0]
        return float(np.sum(np.abs(self._env) ** 2) * dt * c)


# ---------------------------------------------------------------------
# Transverse profiles
# ---------------------------------------------------------------------

class LaserTransverseProfile(object):
    def __init__(self, propagation_direction, gpu_capable=False):
        assert propagation_direction in (-1, 1)
        self.propag_direction = float(propagation_direction)
        self.gpu_capable = gpu_capable

    def evaluate(self, x, y, z):
        raise NotImplementedError

    def squared_profile_integral(self):
        raise NotImplementedError


class GaussianTransverseProfile(LaserTransverseProfile):
    """Gaussian transverse envelope with exact paraxial propagation
    (diffraction, Gouy phase, wavefront curvature).
    Reference: transverse_laser_profiles.py:94-166."""

    def __init__(self, waist, zf=0.0, lambda0=0.8e-6,
                 propagation_direction=1):
        LaserTransverseProfile.__init__(self, propagation_direction, True)
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

    def squared_profile_integral(self):
        return 0.5 * np.pi * self.w0**2


class LaguerreGaussTransverseProfile(LaserTransverseProfile):
    """Laguerre-Gauss (p, m) transverse mode with cos(m theta) azimuthal
    dependence.  Reference: transverse_laser_profiles.py:201-309."""

    def __init__(self, p, m, waist, zf=0.0, lambda0=0.8e-6, theta0=0.0,
                 propagation_direction=1):
        LaserTransverseProfile.__init__(self, propagation_direction)
        if m < 0 or not isinstance(m, (int, np.integer)):
            raise ValueError("m should be an integer positive number.")
        k0 = 2 * np.pi / lambda0
        zr = 0.5 * k0 * waist**2
        scaled_amplitude = 1.0
        if m != 0:
            scaled_amplitude = np.sqrt(factorial(p) / factorial(m + p))
            scaled_amplitude *= 2**0.5
        self.p = p
        self.m = m
        self.scaled_amplitude = scaled_amplitude
        self.laguerre_pm = genlaguerre(p, m)
        self.theta0 = theta0
        self.k0 = k0
        self.inv_zr = 1.0 / zr
        self.zf = zf
        self.w0 = waist

    def evaluate(self, x, y, z):
        prop_dir = self.propag_direction
        diffract = 1.0 + 1j * prop_dir * (z - self.zf) * self.inv_zr
        w = self.w0 * np.abs(diffract)
        psi = np.angle(diffract)
        srs = 2 * (x**2 + y**2) / w**2
        scaled_radius = np.sqrt(srs)
        theta = np.angle(x + 1j * y)
        exp_argument = (
            -(x**2 + y**2) / (self.w0**2 * diffract)
            - 1j * (2 * self.p + self.m) * psi
        )
        profile = (
            np.exp(exp_argument) / diffract
            * scaled_radius**self.m * self.laguerre_pm(srs)
            * np.cos(self.m * (theta - self.theta0))
        )
        return profile * self.scaled_amplitude

    def squared_profile_integral(self):
        return 0.5 * np.pi * self.w0**2


class DonutLikeLaguerreGaussTransverseProfile(LaserTransverseProfile):
    """Donut-like Laguerre-Gauss: exp(i m theta) cork-screw phase and
    theta-independent intensity.  Reference:
    transverse_laser_profiles.py:311-420."""

    def __init__(self, p, m, waist, zf=0.0, lambda0=0.8e-6,
                 propagation_direction=1):
        LaserTransverseProfile.__init__(self, propagation_direction)
        k0 = 2 * np.pi / lambda0
        zr = 0.5 * k0 * waist**2
        scaled_amplitude = np.sqrt(factorial(p) / factorial(abs(m) + p))
        self.p = p
        self.m = m
        self.scaled_amplitude = scaled_amplitude
        self.laguerre_pm = genlaguerre(p, abs(m))
        self.k0 = k0
        self.inv_zr = 1.0 / zr
        self.zf = zf
        self.w0 = waist

    def evaluate(self, x, y, z):
        prop_dir = self.propag_direction
        diffract = 1.0 + 1j * prop_dir * (z - self.zf) * self.inv_zr
        w = self.w0 * np.abs(diffract)
        psi = np.angle(diffract)
        srs = 2 * (x**2 + y**2) / w**2
        scaled_radius = np.sqrt(srs)
        theta = np.angle(x + 1j * y)
        exp_argument = (
            -(x**2 + y**2) / (self.w0**2 * diffract)
            - 1j * (2 * self.p + abs(self.m)) * psi
            + 1j * self.m * theta
        )
        profile = (
            np.exp(exp_argument) / diffract
            * scaled_radius ** abs(self.m) * self.laguerre_pm(srs)
        )
        return profile * self.scaled_amplitude

    def squared_profile_integral(self):
        return 0.5 * np.pi * self.w0**2


class FlattenedGaussianTransverseProfile(LaserTransverseProfile):
    """Flattened Gaussian (Santarsiero et al., J. Mod. Opt. 1997):
    flat-top at focus decomposed over N+1 Laguerre-Gauss modes.
    Reference: transverse_laser_profiles.py:422-565."""

    def __init__(self, w0, N, zf=0.0, lambda0=0.8e-6,
                 propagation_direction=1):
        LaserTransverseProfile.__init__(self, propagation_direction, False)
        self.N = int(round(N))
        self.w_foc = w0 * (self.N + 1) ** 0.5
        k0 = 2 * np.pi / lambda0
        zr = 0.5 * k0 * self.w_foc**2
        self.k0 = k0
        self.inv_zr = 1.0 / zr
        self.zf = zf
        self.cn = np.empty(self.N + 1)
        for n in range(self.N + 1):
            m_values = np.arange(n, self.N + 1)
            self.cn[n] = np.sum(
                (1.0 / 2) ** m_values * binom(m_values, n)) / (self.N + 1)

    def evaluate(self, x, y, z):
        prop_dir = self.propag_direction
        diffract = 1.0 + 1j * prop_dir * (z - self.zf) * self.inv_zr
        w = self.w_foc * np.abs(diffract)
        psi = np.angle(diffract)
        srs = 2 * (x**2 + y**2) / w**2

        laguerre_sum = np.zeros_like(x, dtype=np.complex128)
        L = L1 = L2 = None
        for n in range(0, self.N + 1):
            if n == 0:
                L = 1.0
            elif n == 1:
                L1 = L
                L = 1.0 - srs
            else:
                L2 = L1
                L1 = L
                L = (((2 * n - 1) - srs) * L1 - (n - 1) * L2) / n
            laguerre_sum += self.cn[n] * np.exp(-(2j * n) * psi) * L

        exp_argument = -(x**2 + y**2) / (self.w_foc**2 * diffract)
        return laguerre_sum * np.exp(exp_argument) / diffract

    def squared_profile_integral(self):
        return 0.5 * np.pi * self.w_foc**2 * float(np.sum(self.cn**2))


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
            self, int(longitudinal_profile.propag_direction),
            gpu_capable=(longitudinal_profile.gpu_capable
                         and transverse_profile.gpu_capable))
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


class LaguerreGaussLaser(ParaxialApproximationLaser):
    """Linearly-polarized Laguerre-Gauss laser pulse.
    Reference: laser_profiles.py:296-446."""

    def __init__(self, p, m, a0, waist, tau, z0, zf=None, theta_pol=0.0,
                 lambda0=0.8e-6, cep_phase=0.0, theta0=0.0,
                 propagation_direction=1):
        E0 = _E0_from_a0(a0, lambda0)
        if zf is None:
            zf = z0
        long_prof = GaussianChirpedLongitudinalProfile(
            tau=tau, z0=z0, lambda0=lambda0, cep_phase=cep_phase,
            propagation_direction=propagation_direction)
        trans_prof = LaguerreGaussTransverseProfile(
            p=p, m=m, waist=waist, zf=zf, lambda0=lambda0, theta0=theta0,
            propagation_direction=propagation_direction)
        ParaxialApproximationLaser.__init__(
            self, E0 * np.cos(theta_pol), E0 * np.sin(theta_pol),
            long_prof, trans_prof)


class DonutLikeLaguerreGaussLaser(ParaxialApproximationLaser):
    """Donut-like Laguerre-Gauss laser pulse (cork-screw phase).
    Reference: laser_profiles.py:448-585."""

    def __init__(self, p, m, a0, waist, tau, z0, zf=None, theta_pol=0.0,
                 lambda0=0.8e-6, cep_phase=0.0, propagation_direction=1):
        E0 = _E0_from_a0(a0, lambda0)
        if zf is None:
            zf = z0
        long_prof = GaussianChirpedLongitudinalProfile(
            tau=tau, z0=z0, lambda0=lambda0, cep_phase=cep_phase,
            propagation_direction=propagation_direction)
        trans_prof = DonutLikeLaguerreGaussTransverseProfile(
            p=p, m=m, waist=waist, zf=zf, lambda0=lambda0,
            propagation_direction=propagation_direction)
        ParaxialApproximationLaser.__init__(
            self, E0 * np.cos(theta_pol), E0 * np.sin(theta_pol),
            long_prof, trans_prof)


class FlattenedGaussianLaser(ParaxialApproximationLaser):
    """Laser with a flattened Gaussian transverse profile at focus.
    Reference: laser_profiles.py:587-711."""

    def __init__(self, a0, w0, tau, z0, N=6, zf=None, theta_pol=0.0,
                 lambda0=0.8e-6, cep_phase=0.0, propagation_direction=1):
        E0 = _E0_from_a0(a0, lambda0)
        if zf is None:
            zf = z0
        long_prof = GaussianChirpedLongitudinalProfile(
            tau=tau, z0=z0, lambda0=lambda0, cep_phase=cep_phase,
            propagation_direction=propagation_direction)
        trans_prof = FlattenedGaussianTransverseProfile(
            w0=w0, N=N, zf=zf, lambda0=lambda0,
            propagation_direction=propagation_direction)
        ParaxialApproximationLaser.__init__(
            self, E0 * np.cos(theta_pol), E0 * np.sin(theta_pol),
            long_prof, trans_prof)


class CustomSpectrumLaser(ParaxialApproximationLaser):
    """Gaussian transverse profile x user-spectrum longitudinal profile."""

    def __init__(self, a0, waist, z0, spectrum_file, zf=None, theta_pol=0.0,
                 lambda0=0.8e-6, propagation_direction=1):
        E0 = _E0_from_a0(a0, lambda0)
        if zf is None:
            zf = z0
        long_prof = CustomSpectrumLongitudinalProfile(
            z0=z0, spectrum_file=spectrum_file,
            propagation_direction=propagation_direction)
        trans_prof = GaussianTransverseProfile(
            waist=waist, zf=zf, lambda0=lambda0,
            propagation_direction=propagation_direction)
        ParaxialApproximationLaser.__init__(
            self, E0 * np.cos(theta_pol), E0 * np.sin(theta_pol),
            long_prof, trans_prof)


class FewCycleLaser(LaserProfile):
    """Few-cycle laser pulse, valid beyond the slowly-varying-envelope
    approximation (Caron & Potvliege, J. Mod. Opt. 46 (1999)).
    Reference: laser_profiles.py:713-840."""

    def __init__(self, a0, waist, tau_fwhm, z0, zf=None, theta_pol=0.0,
                 lambda0=0.8e-6, cep_phase=0.0, propagation_direction=1):
        LaserProfile.__init__(self, propagation_direction, gpu_capable=True)
        k0 = 2 * np.pi / lambda0
        E0 = a0 * m_e * c**2 * k0 / e
        zr = 0.5 * k0 * waist**2
        if zf is None:
            zf = z0
        self.k0 = k0
        self.zr = zr
        self.zf = zf
        self.z0 = z0
        self.E0x = E0 * np.cos(theta_pol)
        self.E0y = E0 * np.sin(theta_pol)
        self.w0 = waist
        self.cep_phase = cep_phase
        # Solve for the parameter s: w0 tau_fwhm = s sqrt(2(4^{1/(s+1)}-1))
        w_tau = c * k0 * tau_fwhm
        sol = fsolve(lambda s: s * (2 * (4 ** (1 / (s + 1)) - 1)) ** 0.5
                     - w_tau, 1.0)
        self.s = sol[0]

    def E_field(self, x, y, z, t):
        prop_dir = self.propag_direction
        inv_q = 1.0 / (prop_dir * (z - self.zf) + 1j * self.zr)
        argument = 1.0 + 1j * self.k0 / self.s * (
            prop_dir * (z - self.z0) - c * t + 0.5 * (x**2 + y**2) * inv_q)
        profile = (np.exp(1j * self.cep_phase) * 1j * self.zr * inv_q
                   * argument ** (-self.s - 1))
        return (self.E0x * profile).real, (self.E0y * profile).real


class FromLasyFileLaser(LaserProfile):
    """Laser read from a `lasy` HDF5 file (lab frame, propagating +z).

    The lasy file stores the envelope on an (t, r) or (t, y, x) grid;
    the field is reconstructed by interpolation.  Reference:
    laser_profiles.py:841+.  Requires h5py.
    """

    def __init__(self, filename, t_start=0.0):
        LaserProfile.__init__(self, 1, gpu_capable=False)
        try:
            import h5py
        except ImportError as err:
            raise ImportError(
                "FromLasyFileLaser reads the lasy file with h5py, which "
                "is not installed") from err
        with h5py.File(filename, "r") as f:
            # openPMD layout written by lasy
            it = sorted(f["data"].keys())[0]
            env_group = f["data"][it]["meshes"]["laserEnvelope"]
            env = env_group[...]
            # Attributes
            w0 = env_group.attrs["angularFrequency"]
            grid_spacing = env_group.attrs["gridSpacing"]
            grid_offset = env_group.attrs["gridGlobalOffset"]
            geometry = env_group.attrs["geometry"]
            if isinstance(geometry, bytes):
                geometry = geometry.decode()
        self._env = env
        self._omega0 = float(w0)
        self.k0 = self._omega0 / c
        self._spacing = np.asarray(grid_spacing, dtype=float)
        self._offset = np.asarray(grid_offset, dtype=float)
        self._geometry = geometry
        self._t_start = t_start

    def E_field(self, x, y, z, t):
        # Retarded time coordinate of the envelope grid
        t_ret = t - self._t_start - z / c
        if "thetaMode" in str(self._geometry) or self._env.ndim == 3 and \
                self._env.shape[0] <= 4:
            # Cylindrical (mode 0 only is used)
            env = self._env[0]
            t_axis = self._offset[0] + self._spacing[0] * np.arange(
                env.shape[0])
            r_axis = self._offset[1] + self._spacing[1] * np.arange(
                env.shape[1])
            r = np.sqrt(x**2 + y**2)
            from scipy.interpolate import RegularGridInterpolator
            interp_re = RegularGridInterpolator(
                (t_axis, r_axis), env.real, bounds_error=False, fill_value=0.)
            interp_im = RegularGridInterpolator(
                (t_axis, r_axis), env.imag, bounds_error=False, fill_value=0.)
            pts = np.stack([t_ret.ravel(), r.ravel()], axis=-1)
            envelope = (interp_re(pts) + 1j * interp_im(pts)).reshape(
                np.shape(t_ret))
        else:
            raise NotImplementedError(
                "Only cylindrical lasy files are supported.")
        field = envelope * np.exp(-1j * self._omega0 * t_ret)
        # lasy stores the envelope of E (in V/m); polarization x
        return field.real, np.zeros_like(field.real)
