"""Particle bunch loaders + relativistic space-charge initialization.

The space-charge solve (phi, A from 1/(kr^2 + kz^2/gamma^2)) runs on
the host in numpy float64, once, at initialization, restructured
around the host-side spectral transformer; the charge and current it
solves for are deposited on the simulation's device
(Simulation.deposit_species_rho_J_full).  The loaders draw from
``sim._rng`` in fbpic_tpu's order, so a seed loads the same bunch in
both packages.  A bunch is a species without continuous injection
whose capacity is its particle count rounded up to 256 and whose
sort_K is 0: a ring, gathered and deposited by index every step.

Attribution: the bunch loader halves (distribution setup, openPMD /
file parsing, Gaussian moments) are condensed ports of FBPIC
(lpa_utils/bunch.py), Copyright 2016-2018 FBPIC contributors
(University of Hamburg / LBNL), 3-Clause-BSD-LBNL license.
"""
import warnings

from dataclasses import replace

import numpy as np
from scipy.constants import c, e, m_e, epsilon_0, mu_0

from ..fields.host_transform import HostSpectralTransformer
from ..particles.state import (
    generate_evenly_spaced, _check_dens_func_arguments, make_particle_state,
)


def add_particle_bunch(sim, q, m, gamma0, n, p_zmin, p_zmax, p_rmin, p_rmax,
                       p_nr=2, p_nz=2, p_nt=4, dens_func=None, boost=None,
                       direction="forward", z_injection_plane=None,
                       initialize_self_field=True,
                       boost_positions_in_dens_func=False):
    """Introduce a flat-top relativistic bunch with its space-charge field."""
    if boost is not None:
        beta0 = np.sqrt(1.0 - 1.0 / gamma0**2)
        p_zmin, p_zmax = boost.copropag_length(
            [p_zmin, p_zmax], beta_object=beta0)
        n, = boost.copropag_density([n], beta_object=beta0)
        if boost_positions_in_dens_func and dens_func is not None:
            coef = boost.gamma0 * (1 - beta0 * boost.beta0)
            args = _check_dens_func_arguments(dens_func)
            if args == ["z", "r"]:
                user_func = dens_func
                dens_func = lambda z, r: user_func(coef * z, r)
            else:
                user_func = dens_func
                dens_func = lambda x, y, z: user_func(x, y, coef * z)

    uz_m = np.sqrt(gamma0**2 - 1.0)
    if direction == "backward":
        uz_m *= -1.0
    if boost is not None:
        uz_m, = boost.longitudinal_momentum([uz_m])

    # Particle loading on the evenly-spaced lattice
    from ..core.simulation import adapt_to_grid
    p_zmin_, p_zmax_, Npz = adapt_to_grid(sim.grid_z(), p_zmin, p_zmax, p_nz)
    p_rmin_, p_rmax_, Npr = adapt_to_grid(sim.grid_r(), p_rmin, p_rmax, p_nr)
    Ntot, x, y, z, ux, uy, uz, inv_gamma, w = generate_evenly_spaced(
        Npz, p_zmin_, p_zmax_, Npr, p_rmin_, p_rmax_, p_nt, n, dens_func,
        0.0, 0.0, uz_m, 0.0, 0.0, 0.0, rng=sim._rng)

    return add_particle_bunch_from_arrays(
        sim, q, m, x, y, z, ux, uy, uz, w, boost=None,
        z_injection_plane=z_injection_plane,
        initialize_self_field=initialize_self_field)


def add_particle_bunch_gaussian(sim, q, m, sig_r, sig_z, n_emit, gamma0,
                                sig_gamma, n_physical_particles,
                                n_macroparticles, tf=0.0, zf=0.0, boost=None,
                                save_beam=None, z_injection_plane=None,
                                initialize_self_field=True,
                                symmetrize=False):
    """Introduce a Gaussian bunch with emittance and energy spread."""
    rng = sim._rng
    if symmetrize:
        assert n_macroparticles % 4 == 0
        n_macroparticles = n_macroparticles // 4
    if sig_gamma > 0.0:
        gamma = rng.normal(gamma0, sig_gamma, n_macroparticles)
    else:
        gamma = np.full(n_macroparticles, gamma0)
        if sig_gamma < 0.0:
            warnings.warn("Negative sig_gamma; set to zero.")
    inv_gamma = 1.0 / gamma
    x = sig_r * rng.normal(0.0, 1.0, n_macroparticles)
    y = sig_r * rng.normal(0.0, 1.0, n_macroparticles)
    z = zf + sig_z * rng.normal(0.0, 1.0, n_macroparticles)
    sig_ur = n_emit / sig_r
    ux = sig_ur * rng.normal(0.0, 1.0, n_macroparticles)
    uy = sig_ur * rng.normal(0.0, 1.0, n_macroparticles)
    uz_sqr = (gamma**2 - 1) - ux**2 - uy**2

    mask = uz_sqr >= 0
    N_new = int(np.count_nonzero(mask))
    if N_new < n_macroparticles:
        warnings.warn("%d particles with uz^2<0 removed from the beam."
                      % (n_macroparticles - N_new))
        x, y, z = x[mask], y[mask], z[mask]
        ux, uy = ux[mask], uy[mask]
        inv_gamma = inv_gamma[mask]
        uz_sqr = uz_sqr[mask]
    uz = np.sqrt(uz_sqr)
    w = n_physical_particles / N_new * np.ones_like(x)

    # Propagate backwards so that the bunch focuses at time tf
    if tf != 0.0:
        x = x - ux * inv_gamma * c * tf
        y = y - uy * inv_gamma * c * tf
        z = z - uz * inv_gamma * c * tf

    if symmetrize:
        w = w * 0.25
        x, y, z, ux, uy, uz, w = map(np.concatenate, zip(
            [x, y, z, ux, uy, uz, w],
            [-y, x, z, -uy, ux, uz, w],
            [-x, -y, z, -ux, -uy, uz, w],
            [y, -x, z, uy, -ux, uz, w]))

    if save_beam is not None:
        np.savez(save_beam, x=x, y=y, z=z, ux=ux, uy=uy, uz=uz,
                 inv_gamma=inv_gamma, w=w)

    return add_particle_bunch_from_arrays(
        sim, q, m, x, y, z, ux, uy, uz, w, boost=boost,
        z_injection_plane=z_injection_plane,
        initialize_self_field=initialize_self_field)


def add_particle_bunch_file(sim, q, m, filename, n_physical_particles,
                            z_off=0.0, boost=None, direction="forward",
                            z_injection_plane=None,
                            initialize_self_field=True):
    """Load a bunch from a text file with columns x y z ux uy uz."""
    x, y, z, ux, uy, uz = np.loadtxt(filename, unpack=True)
    z = z + z_off
    w = n_physical_particles / len(x) * np.ones_like(x)
    return add_particle_bunch_from_arrays(
        sim, q, m, x, y, z, ux, uy, uz, w, boost=boost,
        z_injection_plane=z_injection_plane,
        initialize_self_field=initialize_self_field)


def add_particle_bunch_openPMD(sim, q, m, ts_path, z_off=0.0, species=None,
                               select=None, iteration=None, boost=None,
                               z_injection_plane=None,
                               initialize_self_field=True):
    """Load a bunch from an openPMD time series (requires openpmd_viewer)."""
    try:
        from openpmd_viewer import OpenPMDTimeSeries
    except ImportError:
        raise ImportError(
            "The `openpmd_viewer` package is required for "
            "`add_particle_bunch_openPMD` but is not installed.")
    ts = OpenPMDTimeSeries(ts_path)
    if iteration is None:
        iteration = ts.iterations[-1]
    x, y, z, ux, uy, uz, w = ts.get_particle(
        ["x", "y", "z", "ux", "uy", "uz", "w"],
        species=species, iteration=iteration, select=select)
    z = z + z_off
    return add_particle_bunch_from_arrays(
        sim, q, m, x, y, z, ux, uy, uz, w, boost=boost,
        z_injection_plane=z_injection_plane,
        initialize_self_field=initialize_self_field)


def add_particle_bunch_from_arrays(sim, q, m, x, y, z, ux, uy, uz, w,
                                   boost=None, z_injection_plane=None,
                                   initialize_self_field=True):
    """Create a bunch species from explicit particle arrays."""
    inv_gamma = 1.0 / np.sqrt(1 + ux**2 + uy**2 + uz**2)
    if boost is not None:
        x, y, z, ux, uy, uz, inv_gamma = boost.boost_particle_arrays(
            x, y, z, ux, uy, uz, inv_gamma)

    view = sim.add_new_species(q=q, m=m, continuous_injection=False)
    view_idx = view._index
    pstate = make_particle_state(x, y, z, ux, uy, uz, inv_gamma, w,
                                 device=sim.device, dtype=sim.dtype)
    species = list(sim.state.species)
    species[view_idx] = pstate
    sim.state = replace(sim.state, species=species)
    sim._species_counts[view_idx] = len(x)

    if z_injection_plane is not None:
        sc = sim.species_configs[view_idx]
        v_plane = 0.0
        z0_plane = z_injection_plane
        if boost is not None:
            z0_plane = z_injection_plane / boost.gamma0
            v_plane = -boost.beta0 * c
        sim.species_configs[view_idx] = replace(
            sc, ballistic_z0=float(z0_plane), ballistic_v=float(v_plane))

    if initialize_self_field:
        get_space_charge_fields(sim, view, direction=(
            "forward" if np.sum(uz) >= 0 else "backward"))
    return view


def get_space_charge_fields(sim, view, direction="forward"):
    """Add the space-charge field of `view`'s particles to the grid.

    Host-side float64 k-space solve: phi = rho / (eps0 (kr^2 + kz^2/g^2)),
    Az = mu0 Jz / (kr^2 + kz^2/g^2) (reference: bunch.py:838-1007).
    """
    sp = sim.state.species[view._index]
    w = sp.w.cpu().numpy()
    if w.sum() == 0:
        warnings.warn("0 macroparticles; skipping space charge.")
        return
    gamma = float((w / sp.inv_gamma.cpu().numpy()).sum() / w.sum())

    # Deposit rho and J of this species on the full internal grid
    rho, Jr, Jt, Jz = sim.deposit_species_rho_J_full(view)

    trans = HostSpectralTransformer(
        sim.config.Nz, sim.config.Nr, sim.config.Nm, sim.config.rmax,
        sim.config.dz, sim.config.n_order)
    rho_s = trans.interp2spect_scal(rho)
    Jp_s, Jm_s = trans.interp2spect_vect(Jr, Jt)
    Jz_s = trans.interp2spect_scal(Jz)

    # Binomial smoothing consistent with the source filtering
    kz_true = trans.kz_true
    kz, kr = trans.kz_kr_mesh()
    filt_z = (1.0 - np.sin(0.5 * kz_true * sim.config.dz) ** 2)
    filt_r = np.stack([
        1.0 - np.sin(0.5 * trans.kr[mm] * sim.config.dr) ** 2
        for mm in range(sim.config.Nm)])
    filt = filt_z[None, :, None] * filt_r[:, None, :]
    rho_s = rho_s * filt
    Jz_s = Jz_s * filt

    beta = np.sqrt(1.0 - 1.0 / gamma**2)
    if direction == "backward":
        beta *= -1.0

    K2 = kr**2 + kz**2 / gamma**2
    inv_K2 = np.where(K2 != 0, 1.0 / np.where(K2 == 0, 1.0, K2), 0.0)

    phi = rho_s * inv_K2 / epsilon_0
    Az = Jz_s * inv_K2 * mu_0

    Ep = 0.5 * kr * phi
    Em = -0.5 * kr * phi
    Ez = -1j * kz * phi + 1j * beta * c * kz * Az
    Bp = -0.5j * kr * Az
    Bm = -0.5j * kr * Az
    Bz = np.zeros_like(Az)

    Er_i, Et_i = trans.spect2interp_vect(Ep, Em)
    Ez_i = trans.spect2interp_scal(Ez)
    Br_i, Bt_i = trans.spect2interp_vect(Bp, Bm)
    Bz_i = trans.spect2interp_scal(Bz)

    current = {name: getattr(sim.state.interp, name).cpu().numpy()
               for name in ("Er", "Et", "Ez", "Br", "Bt", "Bz")}
    sim.set_interp_EB(
        Er=current["Er"] + Er_i, Et=current["Et"] + Et_i,
        Ez=current["Ez"] + Ez_i, Br=current["Br"] + Br_i,
        Bt=current["Bt"] + Bt_i, Bz=current["Bz"] + Bz_i)


# ---------------------------------------------------------------------
# Electron-bunch wrappers: the reference's historical API
# (FBPIC's fbpic/lpa_utils/bunch.py:550-830), kept so existing
# user scripts run unchanged.  Each is add_particle_bunch* with
# q = -e, m = m_e; `Q`/`Q_tot` is the total physical charge.
# ---------------------------------------------------------------------

def add_elec_bunch(sim, gamma0, n_e, p_zmin, p_zmax, p_rmin, p_rmax,
                   p_nr=2, p_nz=2, p_nt=4, dens_func=None, boost=None,
                   direction="forward", z_injection_plane=None):
    """Flat-top relativistic electron bunch (reference bunch.py:550)."""
    return add_particle_bunch(
        sim, -e, m_e, gamma0, n_e, p_zmin, p_zmax, p_rmin, p_rmax,
        p_nr=p_nr, p_nz=p_nz, p_nt=p_nt, dens_func=dens_func,
        boost=boost, direction=direction,
        z_injection_plane=z_injection_plane)


def add_elec_bunch_gaussian(sim, sig_r, sig_z, n_emit, gamma0,
                            sig_gamma, Q, N, tf=0.0, zf=0.0, boost=None,
                            save_beam=None, z_injection_plane=None,
                            symmetrize=False):
    """Gaussian electron bunch focused at (tf, zf)
    (reference bunch.py:619)."""
    n_physical_particles = Q / e
    return add_particle_bunch_gaussian(
        sim, -e, m_e, sig_r, sig_z, n_emit, gamma0, sig_gamma,
        n_physical_particles, N, tf=tf, zf=zf, boost=boost,
        save_beam=save_beam, z_injection_plane=z_injection_plane,
        symmetrize=symmetrize)


def add_elec_bunch_file(sim, filename, Q_tot, z_off=0.0, boost=None,
                        direction="forward", z_injection_plane=None):
    """Electron bunch from a text file (reference bunch.py:696)."""
    return add_particle_bunch_file(
        sim, -e, m_e, filename, Q_tot / e, z_off=z_off, boost=boost,
        z_injection_plane=z_injection_plane)


def add_elec_bunch_openPMD(sim, ts_path, z_off=0.0, species=None,
                           select=None, iteration=None, boost=None,
                           z_injection_plane=None):
    """Electron bunch from an openPMD time series
    (reference bunch.py:742)."""
    return add_particle_bunch_openPMD(
        sim, -e, m_e, ts_path, z_off=z_off, species=species,
        select=select, iteration=iteration, boost=boost,
        z_injection_plane=z_injection_plane)


def add_elec_bunch_from_arrays(sim, x, y, z, ux, uy, uz, w, boost=None,
                               direction="forward",
                               z_injection_plane=None):
    """Electron bunch from numpy arrays (reference bunch.py:796)."""
    if direction == "backward":
        uz = -np.asarray(uz)
    return add_particle_bunch_from_arrays(
        sim, -e, m_e, x, y, z, ux, uy, uz, w, boost=boost,
        z_injection_plane=z_injection_plane)
