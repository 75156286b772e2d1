"""Direct laser injection: evaluate the profile on the grid and add
self-consistent (Ez, B) fields.

The global spectral solve runs on the host in numpy float64 (it happens
once, at t=0); behavioral reference:
FBPIC's fbpic/lpa_utils/laser/direct_injection.py:12-217.
"""
import numpy as np
from scipy.constants import c

from ...fields.host_transform import HostSpectralTransformer


def get_laser_Er_Et(sim, laser_profile):
    """Evaluate the laser's (Er, Et) on the grid, azimuthally decomposed.

    Returns (Er_m, Et_m): complex (Nm, Nz, Nr) mode arrays.
    """
    Nm = sim.config.Nm
    # Evaluate on the full internal grid (incl. damp cells), like the
    # reference's with_damp=True global grid
    z = sim.grid_z(physical=False)
    r = sim.grid_r()
    ntheta = 2 * Nm
    theta = (2 * np.pi / ntheta) * np.arange(ntheta)
    z_3d, r_3d, theta_3d = np.meshgrid(z, r, theta, indexing="ij")
    cos_t = np.cos(theta_3d)
    sin_t = np.sin(theta_3d)
    x_3d = r_3d * cos_t
    y_3d = r_3d * sin_t

    Ex_3d, Ey_3d = laser_profile.E_field(x_3d, y_3d, z_3d, sim.time)
    Er_3d = cos_t * Ex_3d + sin_t * Ey_3d
    Et_3d = -sin_t * Ex_3d + cos_t * Ey_3d

    # Azimuthal decomposition: inverse DFT over theta samples
    Er_m = np.fft.ifft(Er_3d, axis=-1)   # (Nz, Nr, ntheta)
    Et_m = np.fft.ifft(Et_3d, axis=-1)
    # Keep modes 0..Nm-1, reorder to (Nm, Nz, Nr)
    Er_m = np.moveaxis(Er_m[:, :, :Nm], -1, 0)
    Et_m = np.moveaxis(Et_m[:, :, :Nm], -1, 0)
    return Er_m, Et_m


def calculate_laser_fields(Er_m, Et_m, trans: HostSpectralTransformer,
                           dz, propag_direction):
    """Given transverse laser E, compute self-consistent Ez and B.

    Ez from div(E)=0; B from the propagation relation -i w B = -curl E
    with sign(w) chosen by the propagation direction.
    Returns dict of complex (Nm, Nz, Nr) interp-space fields.
    """
    Ep, Em = trans.interp2spect_vect(Er_m, Et_m)
    kz, kr = trans.kz_kr_mesh()

    # Smoother + compensator on the transverse E (avoids amplitude loss
    # at low resolution)
    kz_true = trans.kz_true
    filt = (1.0 - np.sin(0.5 * kz_true * dz) ** 2) \
        * (1.0 + np.sin(0.5 * kz_true * dz) ** 2)
    Ep = Ep * filt[None, :, None]
    Em = Em * filt[None, :, None]

    inv_kz = np.where(kz == 0, 0.0, 1.0 / np.where(kz == 0, 1.0, kz))
    Ez = 1j * kr * (Ep - Em) * inv_kz

    w = c * np.sqrt(kz**2 + kr**2)
    w = w * np.sign(kz) * propag_direction
    inv_w = np.where(w == 0, 0.0, 1.0 / np.where(w == 0, 1.0, w))
    Bp = -1j * inv_w * (kz * Ep - 0.5j * kr * Ez)
    Bm = -1j * inv_w * (-kz * Em - 0.5j * kr * Ez)
    Bz = inv_w * kr * (Ep + Em)

    Er_i, Et_i = trans.spect2interp_vect(Ep, Em)
    Ez_i = trans.spect2interp_scal(Ez)
    Br_i, Bt_i = trans.spect2interp_vect(Bp, Bm)
    Bz_i = trans.spect2interp_scal(Bz)
    return dict(Er=Er_i, Et=Et_i, Ez=Ez_i, Br=Br_i, Bt=Bt_i, Bz=Bz_i)


def add_laser_direct(sim, laser_profile):
    """Add a laser pulse to the simulation mesh (single global solve)."""
    Er_m, Et_m = get_laser_Er_Et(sim, laser_profile)
    trans = HostSpectralTransformer(
        sim.config.Nz, sim.config.Nr, sim.config.Nm, sim.config.rmax,
        sim.config.dz, sim.config.n_order)
    fields = calculate_laser_fields(
        Er_m, Et_m, trans, sim.config.dz, laser_profile.propag_direction)

    # Add to the simulation's interpolation fields & refresh spect
    current = {
        name: getattr(sim.state.interp, name).cpu().numpy()
        for name in fields
    }
    sim.set_interp_EB(**{name: current[name] + fields[name]
                         for name in fields})
