"""PICMI objects mapped onto fbpic_tpu_torch (fbpic_tpu/picmi/simulation.py).

Signatures follow the PICMI standard (picmi-standard.github.io), read as
fbpic_tpu reads them: ``number_of_cells`` is ``[Nz, Nr]`` while the
bounds and the boundary conditions are ``[r, z]``, so that one script
gives the same simulation in both packages.  The wrapper ``Simulation``
takes the port's ``device`` and ``dtype``; an ``AnalyticDistribution``'s
expression is evaluated with numpy (the port calls density functions
with numpy arrays on the host).
"""
import math

import numpy as np
import torch
from scipy.constants import c, e, m_e, m_p

from ..core.simulation import Simulation as FbpicSimulation
from ..fields.smoothing import BinomialSmoother as FbpicBinomialSmoother
from ..lpa_utils.laser import add_laser_pulse
from ..lpa_utils.laser import GaussianLaser as FbpicGaussianLaser
from ..lpa_utils.mirrors import Mirror as FbpicMirror
from ..lpa_utils.external_fields import ExternalField
from ..lpa_utils.bunch import (
    add_particle_bunch_gaussian, add_particle_bunch_from_arrays,
)
from ..diagnostics import (
    FieldDiagnostic as FbpicFieldDiagnostic,
    ParticleDiagnostic as FbpicParticleDiagnostic,
    BackTransformedFieldDiagnostic,
)

# Particle type -> (charge, mass); covers the common LPA species
# (reference: picmi/particle_charge_and_mass.py)
particle_charge = {
    "electron": -e, "positron": e, "proton": e, "anti-proton": -e,
    "H": e, "He": e, "Li": e, "C": e, "N": e, "O": e, "Ne": e, "Al": e,
    "Ar": e, "Kr": e, "Xe": e,
}
_amu = 1.66053906660e-27
particle_mass = {
    "electron": m_e, "positron": m_e, "proton": m_p, "anti-proton": m_p,
    "H": 1.008 * _amu, "He": 4.0026 * _amu, "Li": 6.94 * _amu,
    "C": 12.011 * _amu, "N": 14.007 * _amu, "O": 15.999 * _amu,
    "Ne": 20.1797 * _amu, "Al": 26.9815 * _amu, "Ar": 39.948 * _amu,
    "Kr": 83.798 * _amu, "Xe": 131.293 * _amu,
}


class _Container:
    """Store constructor kwargs as attributes (PICMI-style container)."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._kwargs = kwargs

    def get(self, name, default=None):
        return getattr(self, name, default)


class CylindricalGrid(_Container):
    def __init__(self, number_of_cells=None, lower_bound=None,
                 upper_bound=None, lower_boundary_conditions=None,
                 upper_boundary_conditions=None, n_azimuthal_modes=2,
                 moving_window_velocity=None, **kw):
        super().__init__(
            number_of_cells=number_of_cells, lower_bound=lower_bound,
            upper_bound=upper_bound,
            lower_boundary_conditions=lower_boundary_conditions,
            upper_boundary_conditions=upper_boundary_conditions,
            n_azimuthal_modes=n_azimuthal_modes,
            moving_window_velocity=moving_window_velocity, **kw)


class ElectromagneticSolver(_Container):
    def __init__(self, grid, method="PSATD", cfl=1.0, source_smoother=None,
                 galilean_velocity=None, **kw):
        super().__init__(grid=grid, method=method, cfl=cfl,
                         source_smoother=source_smoother,
                         galilean_velocity=galilean_velocity, **kw)


class BinomialSmoother(_Container):
    def __init__(self, n_pass=1, compensation=False, **kw):
        super().__init__(n_pass=n_pass, compensation=compensation, **kw)


class GaussianLaser(_Container):
    def __init__(self, wavelength, waist, duration, focal_position,
                 centroid_position, propagation_direction=(0, 0, 1),
                 polarization_direction=(1, 0, 0), a0=None, E0=None, **kw):
        super().__init__(
            wavelength=wavelength, waist=waist, duration=duration,
            focal_position=focal_position,
            centroid_position=centroid_position,
            propagation_direction=propagation_direction,
            polarization_direction=polarization_direction,
            a0=a0, E0=E0, **kw)


class LaserAntenna(_Container):
    def __init__(self, position, normal_vector=(0, 0, 1), **kw):
        super().__init__(position=position, normal_vector=normal_vector,
                         **kw)


class UniformDistribution(_Container):
    def __init__(self, density, lower_bound=(None, None, None),
                 upper_bound=(None, None, None), rms_velocity=(0, 0, 0),
                 directed_velocity=(0, 0, 0), fill_in=True, **kw):
        super().__init__(density=density, lower_bound=lower_bound,
                         upper_bound=upper_bound, rms_velocity=rms_velocity,
                         directed_velocity=directed_velocity,
                         fill_in=fill_in, **kw)


class AnalyticDistribution(UniformDistribution):
    def __init__(self, density_expression, lower_bound=(None, None, None),
                 upper_bound=(None, None, None), rms_velocity=(0, 0, 0),
                 directed_velocity=(0, 0, 0), fill_in=True, **kw):
        _Container.__init__(
            self, density_expression=density_expression,
            lower_bound=lower_bound, upper_bound=upper_bound,
            rms_velocity=rms_velocity, directed_velocity=directed_velocity,
            fill_in=fill_in, **kw)
        self.user_defined_kw = {k: v for k, v in kw.items()}


class GaussianBunchDistribution(_Container):
    def __init__(self, n_physical_particles, rms_bunch_size,
                 rms_velocity=(0, 0, 0), centroid_position=(0, 0, 0),
                 centroid_velocity=(0, 0, 0), **kw):
        super().__init__(
            n_physical_particles=n_physical_particles,
            rms_bunch_size=rms_bunch_size, rms_velocity=rms_velocity,
            centroid_position=centroid_position,
            centroid_velocity=centroid_velocity, **kw)


class ParticleListDistribution(_Container):
    def __init__(self, x, y, z, ux, uy, uz, weight, **kw):
        super().__init__(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz,
                         weight=weight, **kw)


class GriddedLayout(_Container):
    def __init__(self, n_macroparticle_per_cell, grid=None, **kw):
        super().__init__(
            n_macroparticle_per_cell=n_macroparticle_per_cell,
            grid=grid, **kw)


class PseudoRandomLayout(_Container):
    def __init__(self, n_macroparticles=None,
                 n_macroparticles_per_cell=None, grid=None, **kw):
        super().__init__(n_macroparticles=n_macroparticles,
                         n_macroparticles_per_cell=n_macroparticles_per_cell,
                         grid=grid, **kw)


class Species(_Container):
    def __init__(self, particle_type=None, name=None, charge_state=None,
                 charge=None, mass=None, initial_distribution=None,
                 density_scale=None, **kw):
        super().__init__(particle_type=particle_type, name=name,
                         charge_state=charge_state, charge=charge,
                         mass=mass, initial_distribution=initial_distribution,
                         density_scale=density_scale, **kw)
        self.fbpic_species = None


class MultiSpecies(_Container):
    def __init__(self, particle_types=None, names=None, charge_states=None,
                 proportions=None, initial_distribution=None, **kw):
        super().__init__(particle_types=particle_types, names=names,
                         charge_states=charge_states,
                         proportions=proportions,
                         initial_distribution=initial_distribution, **kw)


class Mirror(_Container):
    def __init__(self, z_front_location=None, n_cells=2, **kw):
        super().__init__(z_front_location=z_front_location,
                         n_cells=n_cells, **kw)


class ConstantAppliedField(_Container):
    def __init__(self, Ex=None, Ey=None, Ez=None, Bx=None, By=None,
                 Bz=None, **kw):
        super().__init__(Ex=Ex, Ey=Ey, Ez=Ez, Bx=Bx, By=By, Bz=Bz, **kw)


class AnalyticAppliedField(_Container):
    def __init__(self, Ex_expression=None, Ey_expression=None,
                 Ez_expression=None, Bx_expression=None,
                 By_expression=None, Bz_expression=None, **kw):
        super().__init__(Ex_expression=Ex_expression,
                         Ey_expression=Ey_expression,
                         Ez_expression=Ez_expression,
                         Bx_expression=Bx_expression,
                         By_expression=By_expression,
                         Bz_expression=Bz_expression, **kw)


class FieldDiagnostic(_Container):
    def __init__(self, grid=None, period=100, data_list=None,
                 write_dir=None, **kw):
        super().__init__(grid=grid, period=period, data_list=data_list,
                         write_dir=write_dir, **kw)


class ParticleDiagnostic(_Container):
    def __init__(self, period=100, species=None, data_list=None,
                 write_dir=None, **kw):
        super().__init__(period=period, species=species,
                         data_list=data_list, write_dir=write_dir, **kw)


class LabFrameFieldDiagnostic(_Container):
    def __init__(self, grid=None, num_snapshots=None, dt_snapshots=None,
                 data_list=None, write_dir=None, **kw):
        super().__init__(grid=grid, num_snapshots=num_snapshots,
                         dt_snapshots=dt_snapshots, data_list=data_list,
                         write_dir=write_dir, **kw)


class LabFrameParticleDiagnostic(_Container):
    def __init__(self, grid=None, num_snapshots=None, dt_snapshots=None,
                 species=None, data_list=None, write_dir=None, **kw):
        super().__init__(grid=grid, num_snapshots=num_snapshots,
                         dt_snapshots=dt_snapshots, species=species,
                         data_list=data_list, write_dir=write_dir, **kw)




#: The functions an AnalyticDistribution's expression may call, besides
#: z, r, np, pi and the distribution's own keywords (fbpic_tpu's names:
#: numpy's on host arrays, torch's on tensors, ``TorchNamespace``)
EXPRESSION_FUNCTIONS = ("exp", "sin", "cos", "sqrt", "tanh", "where",
                        "maximum", "minimum", "abs")


class TorchNamespace:
    """The ``np`` of an expression evaluated on tensors: torch's function
    of each name (fbpic_tpu's is jax.numpy), taking Python numbers where
    numpy takes them -- a number becomes a 0-d tensor of ``like``'s dtype
    and device (a fill, no host copy), so the expression is computed in
    the working dtype on the device."""

    def __init__(self, like):
        self._like = like

    def _tensor(self, v):
        return v if torch.is_tensor(v) else torch.full(
            (), v, dtype=self._like.dtype, device=self._like.device)

    def __getattr__(self, name):
        fn = getattr(torch, name)
        if not callable(fn):
            return fn
        return lambda *args: fn(*(self._tensor(a) for a in args))


def analytic_density(expression, user_kw):
    """dens_func(z, r) of an AnalyticDistribution: its expression
    evaluated with numpy on host arrays (the initial load), with torch
    on tensors (``TorchNamespace``: the injection, on the device and
    inside the chunk runner's graphs, as fbpic_tpu evaluates it with
    jax.numpy inside its program)."""
    def dens_func(z, r):
        on_tensors = torch.is_tensor(z)
        lib = TorchNamespace(z) if on_tensors else np
        namespace = {"z": z, "r": r, "np": lib, "pi": np.pi}
        namespace.update({k: getattr(lib, k) for k in EXPRESSION_FUNCTIONS})
        namespace.update(user_kw)
        # torch's C++ operators import through the calling frame's
        # builtins: the expression's globals keep __import__ and no
        # other builtin
        builtins = {"__import__": __import__} if on_tensors else {}
        return eval(expression, {"__builtins__": builtins}, namespace)
    return dens_func


class Simulation(object):
    """PICMI Simulation: builds a fbpic_tpu_torch Simulation from the
    declarative objects (fbpic_tpu/picmi/simulation.py:226-445) on
    ``device`` in ``dtype``."""

    def __init__(self, solver=None, time_step_size=None, max_steps=None,
                 max_time=None, verbose=None, particle_shape="linear",
                 gamma_boost=None, cfl=None, device="cuda",
                 dtype=torch.float32, **kw):
        self.solver = solver
        self.gamma_boost = gamma_boost
        self.particle_shape = particle_shape
        grid = solver.grid
        Nz, Nr = grid.number_of_cells
        zmin, rmin = grid.lower_bound[1], grid.lower_bound[0]
        zmax, rmax = grid.upper_bound[1], grid.upper_bound[0]
        Nm = grid.n_azimuthal_modes

        dz = (zmax - zmin) / Nz
        if time_step_size is not None:
            dt = time_step_size
        else:
            dt = (solver.cfl or 1.0) * dz / c
        self.max_steps = max_steps
        self.max_time = max_time

        boundaries = {
            "z": ("open" if grid.lower_boundary_conditions[1] == "open"
                  else "periodic"),
            "r": ("open" if grid.upper_boundary_conditions[0] == "open"
                  else "reflective"),
        }

        smoother = None
        if solver.source_smoother is not None:
            ss = solver.source_smoother
            smoother = FbpicBinomialSmoother(
                n_passes=ss.n_pass, compensator=ss.compensation)

        v_comoving = None
        use_galilean = False
        if solver.galilean_velocity is not None:
            v_comoving = solver.galilean_velocity[-1]
            use_galilean = True

        self.sim = FbpicSimulation(
            Nz, zmax, Nr, rmax, Nm, dt, zmin=zmin,
            boundaries=boundaries, particle_shape=particle_shape,
            smoother=smoother, v_comoving=v_comoving,
            use_galilean=use_galilean, gamma_boost=gamma_boost,
            device=device, dtype=dtype)

        if grid.moving_window_velocity is not None:
            self.sim.set_moving_window(v=grid.moving_window_velocity[-1])

    # -----------------------------------------------------------------
    def add_species(self, species, layout, initialize_self_field=False):
        dist = species.initial_distribution
        q = species.charge
        m = species.mass
        if q is None and species.particle_type is not None:
            q = particle_charge[species.particle_type]
            if species.particle_type != "electron" \
                    and species.charge_state is not None:
                q = species.charge_state * e
        if m is None and species.particle_type is not None:
            m = particle_mass[species.particle_type]

        if isinstance(layout, GriddedLayout):
            ppc = layout.n_macroparticle_per_cell
            p_nr = ppc.get("r", ppc.get("x", 1)) if isinstance(ppc, dict) \
                else ppc[0]
            p_nt = ppc.get("theta", 4) if isinstance(ppc, dict) else ppc[1]
            p_nz = ppc.get("z", 1) if isinstance(ppc, dict) else ppc[2]
        else:
            p_nr = p_nt = p_nz = 2

        if isinstance(dist, (UniformDistribution, AnalyticDistribution)):
            n0 = getattr(dist, "density", None)
            dens_func = None
            if isinstance(dist, AnalyticDistribution):
                dens_func = analytic_density(
                    dist.density_expression,
                    dict(getattr(dist, "user_defined_kw", {})))
                n0 = 1.0
            scale = species.density_scale or 1.0
            lo, hi = dist.lower_bound, dist.upper_bound
            view = self.sim.add_new_species(
                q=q, m=m, n=n0 * scale, dens_func=dens_func,
                p_nz=p_nz, p_nr=p_nr, p_nt=p_nt,
                p_zmin=(lo[2] if lo[2] is not None else -np.inf),
                p_zmax=(hi[2] if hi[2] is not None else np.inf),
                p_rmin=0,
                p_rmax=(hi[0] if hi[0] is not None else np.inf),
                uz_m=dist.directed_velocity[2] / c,
                uz_th=dist.rms_velocity[2] / c,
                continuous_injection=dist.fill_in,
                name=species.name)
        elif isinstance(dist, GaussianBunchDistribution):
            gamma0 = 1.0 / np.sqrt(
                1 - (dist.centroid_velocity[2] / c) ** 2) \
                if dist.centroid_velocity[2] < c else \
                dist.centroid_velocity[2] / c
            view = add_particle_bunch_gaussian(
                self.sim, q, m, sig_r=dist.rms_bunch_size[0],
                sig_z=dist.rms_bunch_size[2], n_emit=0.0,
                gamma0=max(gamma0, 1.000001), sig_gamma=0.0,
                n_physical_particles=dist.n_physical_particles,
                n_macroparticles=(layout.n_macroparticles
                                  if isinstance(layout, PseudoRandomLayout)
                                  else 10000),
                zf=dist.centroid_position[2],
                initialize_self_field=initialize_self_field)
        elif isinstance(dist, ParticleListDistribution):
            view = add_particle_bunch_from_arrays(
                self.sim, q, m, np.asarray(dist.x), np.asarray(dist.y),
                np.asarray(dist.z), np.asarray(dist.ux) / c,
                np.asarray(dist.uy) / c, np.asarray(dist.uz) / c,
                np.asarray(dist.weight),
                initialize_self_field=initialize_self_field)
        elif dist is None:
            view = self.sim.add_new_species(q=q, m=m, name=species.name)
        else:
            raise ValueError("Unsupported distribution: %s" % type(dist))

        species.fbpic_species = view
        return view

    def activate_field_ionization(self, species, product_species):
        view = species.fbpic_species
        view.make_ionizable(species.particle_type,
                            product_species.fbpic_species,
                            level_start=species.charge_state or 0)

    def add_laser(self, laser, injection_method=None):
        if isinstance(laser, GaussianLaser):
            theta_pol = math.atan2(laser.polarization_direction[1],
                                   laser.polarization_direction[0])
            profile = FbpicGaussianLaser(
                a0=laser.a0, waist=laser.waist, tau=laser.duration,
                z0=laser.centroid_position[2],
                zf=laser.focal_position[2], theta_pol=theta_pol,
                lambda0=laser.wavelength,
                propagation_direction=int(
                    laser.propagation_direction[2]))
        else:
            raise ValueError("Unsupported laser: %s" % type(laser))
        method = "direct"
        z0_antenna = None
        if isinstance(injection_method, LaserAntenna):
            method = "antenna"
            z0_antenna = injection_method.position[2]
        add_laser_pulse(self.sim, profile, gamma_boost=self.gamma_boost,
                        method=method, z0_antenna=z0_antenna)

    def add_applied_field(self, applied_field):
        if isinstance(applied_field, Mirror):
            self.sim.mirrors.append(FbpicMirror(
                z_lab=applied_field.z_front_location,
                n_cells=applied_field.n_cells,
                gamma_boost=self.gamma_boost))
        elif isinstance(applied_field, ConstantAppliedField):
            for comp in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
                val = getattr(applied_field, comp)
                if val is not None:
                    self.sim.external_fields.append(ExternalField(
                        lambda F, x, y, z, t, amplitude, length_scale:
                        F + amplitude, comp, val, 1.0))
        else:
            raise ValueError("Unsupported applied field: %s"
                             % type(applied_field))

    def add_diagnostic(self, diagnostic):
        if isinstance(diagnostic, FieldDiagnostic):
            self.sim.diags.append(FbpicFieldDiagnostic(
                diagnostic.period, self.sim,
                write_dir=diagnostic.write_dir))
        elif isinstance(diagnostic, ParticleDiagnostic):
            species_dict = {s.name: s.fbpic_species
                            for s in diagnostic.species}
            self.sim.diags.append(FbpicParticleDiagnostic(
                diagnostic.period, species=species_dict, sim=self.sim,
                write_dir=diagnostic.write_dir))
        elif isinstance(diagnostic, LabFrameFieldDiagnostic):
            grid = diagnostic.grid
            self.sim.diags.append(BackTransformedFieldDiagnostic(
                zmin_lab=grid.lower_bound[1], zmax_lab=grid.upper_bound[1],
                v_lab=c, dt_snapshots_lab=diagnostic.dt_snapshots,
                Ntot_snapshots_lab=diagnostic.num_snapshots,
                gamma_boost=self.gamma_boost, sim=self.sim,
                write_dir=diagnostic.write_dir))
        else:
            raise ValueError("Unsupported diagnostic: %s" % type(diagnostic))

    def step(self, nsteps=None):
        if nsteps is None:
            nsteps = self.max_steps
        self.sim.step(nsteps)

    def write_input_file(self, file_name):
        raise NotImplementedError(
            "write_input_file is not supported; the PICMI objects map "
            "directly onto the fbpic_tpu_torch Simulation.")
