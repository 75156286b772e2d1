"""User-facing Simulation API, mirroring the reference's surface.

The constructor arguments follow FBPIC's fbpic/main.py:51-344 so
that reference input scripts port over; the PIC cycle runs eagerly in
PyTorch on an explicit ``device`` and ``dtype`` (see core/step.py).
This port covers linear and cubic shapes, resident and non-resident
(ring) species, tracers, empty species, open or periodic z, a reflective
or open (PML) radial boundary, moving window and continuous injection,
the standard and the Galilean / comoving PSATD solver with curl-free or
cross-deposition current correction, the boosted-frame conversions
of species, laser and moving window (``gamma_boost``), and the LPA
utilities' hooks: ``mirrors``, ``external_fields`` and
``laser_antennas``.
"""
import warnings
from dataclasses import replace

import numpy as np
import torch

from ..constants import c, e, m_e
from ..fields.solver import (
    GridConfig, SpectralFields, InterpFields, build_field_aux,
)
from ..fields import transform as tr
from ..lpa_utils.boosted_frame import BoostConverter
from ..fields.smoothing import BinomialSmoother
from ..particles.state import (
    SpeciesConfig, ParticleState, generate_evenly_spaced,
    make_particle_state, pad_particle_state,
)
from ..particles.injection import (
    InjectorConfig, GeneratorAngles, build_injector_aux,
)
from ..particles.deposit import deposit_rho_linear, deposit_rho_J_linear
from ..fields import psatd_push as psp
from ..utils.device import catch_memory_error
from ..utils.printing import ProgressBar, print_simulation_setup
from .state import SimState
from .step import (
    StepOptions, interp2spect_EB, make_step_fn, prepare, deposit_rho_spect,
    deposit_J_spect,
)

#: Most cycles a capture diagnostic buffers on the device before it
#: consumes them (fbpic_tpu's step chunk cap)
MAX_CAPTURE = 250


def adapt_to_grid(x, p_xmin, p_xmax, p_nx, ncells_empty=0):
    """Adapt p_xmin/p_xmax to fall exactly on the grid x.

    Reference: FBPIC's fbpic/main.py:1056-1111.
    """
    xmin = x.min()
    xmax = x.max()
    dx = x[1] - x[0]
    if p_xmin < xmin - 0.5 * dx:
        p_xmin = xmin - 0.5 * dx
    if p_xmax > xmax + (0.5 - ncells_empty) * dx:
        p_xmax = xmax + (0.5 - ncells_empty) * dx
    x_load = x[(x > p_xmin) & (x < p_xmax)]
    Npx = len(x_load) * p_nx
    if Npx > 0:
        p_xmin = x_load.min() - 0.5 * dx
        p_xmax = x_load.max() + 0.5 * dx
    return p_xmin, p_xmax, Npx


class SpeciesView:
    """Numpy view of one species (reference ``Particles`` attributes):
    reads return the live slots, writes set them."""
    _arrays = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")

    def __init__(self, sim, index):
        self._sim = sim
        self._index = index

    @property
    def Ntot(self):
        """Live particles of the species."""
        return int((self._sim.state.species[self._index].w != 0).sum())

    @property
    def q(self):
        return self._sim.species_configs[self._index].q

    @property
    def m(self):
        return self._sim.species_configs[self._index].m

    def track(self, comm=None):
        """Give the species' particles unique ids, carried through the
        step and handed out to injected particles (reference API:
        ``Particles.track``)."""
        from ..particles.tracking import enable_tracking
        enable_tracking(self._sim, self)

    def __getattr__(self, name):
        if name in SpeciesView._arrays:
            arr = getattr(self._sim.state.species[self._index], name)
            live = self._sim.state.species[self._index].w != 0
            return arr[live].cpu().numpy()
        raise AttributeError(name)

    def __setattr__(self, name, value):
        """Writes to x, y, z, ux, uy, uz, inv_gamma or w set the live
        slots (in storage order, as the reads return them)."""
        if name not in SpeciesView._arrays:
            object.__setattr__(self, name, value)
            return
        sim = self._sim
        sp = sim.state.species[self._index]
        arr = getattr(sp, name).clone()
        arr[sp.w != 0] = torch.as_tensor(np.asarray(value), dtype=arr.dtype,
                                         device=arr.device)
        species = list(sim.state.species)
        species[self._index] = sp.replace(**{name: arr})
        sim.state = replace(sim.state, species=species)


class Simulation:
    """Top-level simulation object (API-compatible with the reference).

    device / dtype: where and in which precision the PIC cycle runs
    (default CUDA, float32; a missing CUDA device is an error, never a
    silent fallback).  sort_K: per-column slot capacity of the initial
    species' sorted layout (None = the automatic rule).  The attribute
    ``use_fused_deposit`` (default: on CUDA or in float32, as
    fbpic_tpu's on an accelerator or in float32) turns the fused sorted
    deposits and the resident layout on; set it before adding a species.
    v_comoving / use_galilean: the Galilean (grid flowing at v_comoving)
    or comoving PSATD scheme; gamma_boost: the Lorentz factor of the
    boosted frame, for the lab-to-boosted conversions of
    ``add_new_species`` and ``set_moving_window``.  initialize_ions: with
    ``n_e``, a species of ions (q = e, m = 1836.2 m_e) on the electrons'
    positions.  boundaries r 'open': the radial PML, its ``n_damp["r"]``
    cells (32 by default) inside ``Nr``, as in fbpic_tpu.

    Diagnostics and checkpoints (``fbpic_tpu_torch.diagnostics``) go in
    ``diags`` and ``checkpoints``; ``step`` writes them at their periods.
    ``fld`` is the Simulation itself and ``comm`` is None (one device),
    as in fbpic_tpu.
    """

    def __init__(self, Nz, zmax, Nr, rmax, Nm, dt,
                 p_zmin=-np.inf, p_zmax=np.inf, p_rmin=0, p_rmax=np.inf,
                 p_nz=None, p_nr=None, p_nt=None, n_e=None, zmin=0.0,
                 n_order=-1, dens_func=None, filter_currents=True,
                 v_comoving=None, use_galilean=True, initialize_ions=False,
                 n_guard=None, n_damp=None, exchange_period=None,
                 current_correction="curl-free", boundaries=None,
                 gamma_boost=None, particle_shape="linear", verbose_level=1,
                 smoother=None,
                 use_ruyten_shapes=True, use_modified_volume=True,
                 random_seed=None, device="cuda", dtype=torch.float32,
                 sort_K=None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Simulation(device='cuda'): CUDA is not "
                               "available (pass device='cpu' explicitly)")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, not {dtype}")
        if boundaries is None:
            boundaries = {"z": "periodic", "r": "reflective"}
        if isinstance(boundaries, str):
            boundaries = {"z": boundaries, "r": "reflective"}
        self.device, self.dtype = device, dtype
        #: Fused sorted deposits and the resident layout (user-overridable)
        self.use_fused_deposit = self._fused_by_default()
        self.np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.boundaries = boundaries
        self.verbose_level = int(verbose_level)
        self._banner_printed = False
        boundaries_z = boundaries.get("z", "periodic")
        dz = (zmax - zmin) / Nz
        use_galilean = bool(use_galilean) and v_comoving is not None

        # Open z: the internal grid is enlarged by guard + damping +
        # injection cells at each end (boundary_communicator.py:224-278)
        if boundaries_z == "open":
            if n_guard is None:
                if n_order == -1:
                    n_guard_ = 64
                else:
                    from ..fields.stencil import get_stencil_reach
                    n_guard_ = get_stencil_reach(
                        Nz, dz, c * dt, n_order, v_comoving,
                        use_galilean) + 1
            else:
                n_guard_ = n_guard
            if n_damp is None:
                n_damp = {"z": 64, "r": 32}
            nz_damp_ = n_damp["z"] if isinstance(n_damp, dict) else n_damp
            n_inject_ = n_guard_ // 2
        else:
            n_guard_ = nz_damp_ = n_inject_ = 0
        nd = n_guard_ + nz_damp_ + n_inject_
        self.Nz_phys = Nz
        self.nd_edge = nd

        # Period of particle removal / injection / fresh rho_prev
        # (boundary_communicator.py:280-304)
        if exchange_period is None:
            if boundaries_z == "open":
                cells_per_step = 2.0 * c * dt / dz
                exchange_period = max(
                    1, int((n_guard_ / 2 - 3) / cells_per_step))
            else:
                exchange_period = 1
        self.exchange_period = max(1, int(exchange_period))

        # Radial PML (r 'open'): nr_damp cells INSIDE Nr, as in fbpic_tpu
        use_pml = boundaries.get("r") == "open"
        nr_damp = 0
        if use_pml:
            nr_damp = n_damp["r"] if isinstance(n_damp, dict) else 32
        self.config = GridConfig(
            Nz=Nz + 2 * nd, Nr=Nr, Nm=Nm, dz=dz, dr=rmax / Nr, rmax=rmax,
            dt=dt, n_order=n_order, v_comoving=v_comoving,
            use_galilean=use_galilean, use_pml=use_pml,
            current_correction=current_correction,
            particle_shape=particle_shape, boundaries_z=boundaries_z,
            n_guard=n_guard_, nz_damp=nz_damp_, n_inject=n_inject_,
            nr_damp=nr_damp)
        self.zmax = zmax
        self.dt = dt
        self.filter_currents = filter_currents
        self.boost = (None if gamma_boost is None
                      else BoostConverter(gamma_boost))
        self.smoother = smoother or BinomialSmoother(1, False)
        self.aux = build_field_aux(
            self.config, self.smoother, use_ruyten_shapes=use_ruyten_shapes,
            use_modified_volume=use_modified_volume, device=device,
            dtype=dtype)

        self._rng = np.random.RandomState(random_seed)
        # Seed of the run-time randomness, derived from random_seed as in
        # fbpic_tpu (its device PRNG root)
        seed_rs = np.random.RandomState(
            None if random_seed is None else random_seed + 987654321)
        self.device_seed = int(seed_rs.randint(0, 2**31 - 1))
        #: torch.Generator of the run-time randomness (injection angles
        #: and thermal momenta); replaceable by the caller
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(self.device_seed)
        #: column_angles(iteration, species_index, nkey) -> angles of the
        #: injected plasma columns; replaceable by the caller
        self.column_angles = GeneratorAngles(self.generator)

        zmin_total = self.np_dtype(zmin - nd * dz)
        self.state = SimState(
            spect=SpectralFields.zeros(self.config, device, dtype),
            interp=InterpFields.zeros(self.config, device, dtype),
            species=[], time=self.np_dtype(0.0), zmin=zmin_total,
            iteration=0, mw_zref=zmin_total,
            sort_overflow=torch.zeros((), dtype=torch.int64, device=device),
            ring_overwrite=torch.zeros((), dtype=torch.int64,
                                       device=device))
        #: Overflow counts summed over all step() calls of this object
        self.overflow_totals = {"sort_overflow": 0, "ring_overwrite": 0}
        self.species_configs = []
        #: Particles each species was loaded with (fbpic_tpu's counts)
        self._species_counts = []
        self.moving_win = None
        self._injector_configs = []
        self._injector_auxes = []
        self.ptcl = []
        self.diags = []
        self.checkpoints = []
        #: LaserAntenna objects (add_laser_pulse(method="antenna")),
        #: ExternalField and Mirror objects (lpa_utils), used by step()
        self.laser_antennas = []
        self.external_fields = []
        self.mirrors = []
        # Reference-API aliases: scripts pass `sim.fld` to FieldDiagnostic
        # and `sim.comm` to the diagnostics and to track()
        self.fld = self
        self.comm = None
        if n_e is not None:
            self.add_new_species(
                q=-e, m=m_e, n=n_e, dens_func=dens_func,
                p_nz=p_nz, p_nr=p_nr, p_nt=p_nt,
                p_zmin=p_zmin, p_zmax=p_zmax, p_rmin=p_rmin, p_rmax=p_rmax,
                sort_K=sort_K)
            if initialize_ions:
                self.add_new_species(
                    q=e, m=1836.2 * m_e, n=n_e, dens_func=dens_func,
                    p_nz=p_nz, p_nr=p_nr, p_nt=p_nt,
                    p_zmin=p_zmin, p_zmax=p_zmax, p_rmin=p_rmin,
                    p_rmax=p_rmax, sort_K=sort_K)

    def _fused_by_default(self):
        """fbpic_tpu's default of use_fused_deposit and gate of the
        automatic sort_K: on an accelerator or in float32."""
        return self.device.type == "cuda" or self.dtype == torch.float32

    # -----------------------------------------------------------------
    @property
    def time(self):
        return float(self.state.time)

    @property
    def iteration(self):
        return self.state.iteration

    @property
    def zmin(self):
        return float(self.state.zmin)

    def grid_z(self, physical=True):
        """z positions of grid cells; physical=True excludes the
        guard/damp/injection cells of open boundaries."""
        z_full = self.zmin + (0.5 + np.arange(self.config.Nz)) * self.config.dz
        if physical and self.nd_edge > 0:
            return z_full[self.nd_edge:self.nd_edge + self.Nz_phys]
        return z_full

    def grid_r(self):
        return (0.5 + np.arange(self.config.Nr)) * self.config.dr

    # -----------------------------------------------------------------
    def add_new_species(self, q, m, n=None, dens_func=None,
                        p_nz=None, p_nr=None, p_nt=None,
                        p_zmin=-np.inf, p_zmax=np.inf,
                        p_rmin=0, p_rmax=np.inf,
                        uz_m=0.0, ux_m=0.0, uy_m=0.0,
                        uz_th=0.0, ux_th=0.0, uy_th=0.0,
                        continuous_injection=True,
                        boost_positions_in_dens_func=False, is_tracer=False,
                        capacity=None, name=None, sort_K=None):
        """Create a new species; returns a SpeciesView.  Without ``n``
        the species is empty.

        With ``gamma_boost`` set on the Simulation, the lab-frame p_zmin,
        p_zmax, n, uz_m and uz_th are converted to the boosted frame
        (and the dens_func argument z too, with
        boost_positions_in_dens_func).

        is_tracer: the species is pushed but deposits no charge or
        current (and is never sorted).

        sort_K: per-column slot capacity of the sorted layout.  None =
        automatic on CUDA or in float32 for a species that is not a
        tracer (1.5x the initial maximum column occupancy, at least 86,
        rounded up to 128), else 0 (the scatter deposits).  With
        use_fused_deposit on, a linear-shape species that is not a
        tracer and whose capacity fits Nz * sort_K is resident (capacity
        Nz * sort_K); any other sort_K species is column-sorted afresh
        every step."""
        injector_cfg = injector_aux = None
        if n is None:
            Ntot = 0
            x = y = z = ux = uy = uz = inv_gamma = w = np.empty(0)
        else:
            for var in (p_nz, p_nr, p_nt):
                if var is None:
                    raise ValueError("If `n` is passed, `p_nz`, `p_nr`, "
                                     "`p_nt` are required too.")
            # Boosted frame: convert the lab-frame quantities
            # (fbpic_tpu core/simulation.py:458-482)
            if self.boost is not None:
                gamma_m = np.sqrt(1. + uz_m**2 + ux_m**2 + uy_m**2)
                beta_m_lab = uz_m / gamma_m
                p_zmin, p_zmax = self.boost.copropag_length(
                    [p_zmin, p_zmax], beta_object=beta_m_lab)
                n, = self.boost.copropag_density([n], beta_object=beta_m_lab)
                if uz_m == 0:
                    uz_th = self.boost.gamma0 * uz_th
                else:
                    uz_th = self.boost.gamma0 * (
                        1. - self.boost.beta0 * beta_m_lab) * uz_th
                uz_m = self.boost.gamma0 * (uz_m - self.boost.beta0 * gamma_m)
                if boost_positions_in_dens_func and dens_func is not None:
                    from ..particles.state import _check_dens_func_arguments
                    coef = self.boost.gamma0 * (
                        1 - beta_m_lab * self.boost.beta0)
                    user_func = dens_func
                    if _check_dens_func_arguments(dens_func) == ["z", "r"]:
                        dens_func = lambda z, r: user_func(coef * z, r)
                    else:
                        dens_func = lambda x, y, z: user_func(x, y, coef * z)
            p_zmin_, p_zmax_, Npz = adapt_to_grid(self.grid_z(), p_zmin,
                                                  p_zmax, p_nz)
            p_rmin_, p_rmax_, Npr = adapt_to_grid(self.grid_r(), p_rmin,
                                                  p_rmax, p_nr)
            Ntot, x, y, z, ux, uy, uz, inv_gamma, w = generate_evenly_spaced(
                Npz, p_zmin_, p_zmax_, Npr, p_rmin_, p_rmax_, p_nt, n,
                dens_func, ux_m, uy_m, uz_m, ux_th, uy_th, uz_th,
                rng=self._rng)
            if continuous_injection:
                dz_particles = self.config.dz / p_nz
                dens_args = None
                if dens_func is not None:
                    from ..particles.state import _check_dens_func_arguments
                    dens_args = ("xyz" if _check_dens_func_arguments(dens_func)
                                 == ["x", "y", "z"] else "zr")
                # Columns accumulated over one exchange period, plus margin
                max_cols = int(np.ceil(self.exchange_period
                                       * (c * self.config.dt / self.config.dz)
                                       * p_nz)) + 4
                injector_cfg = InjectorConfig(
                    dz_particles=dz_particles, n=n, ux_m=ux_m, uy_m=uy_m,
                    uz_m=uz_m, ux_th=ux_th, uy_th=uy_th, uz_th=uz_th,
                    dens_func=dens_func, dens_args=dens_args or "zr",
                    max_inject_cols=max_cols)
                injector_aux = build_injector_aux(
                    Npr, p_rmin_, p_rmax_, p_nt, injector_cfg, rng=self._rng,
                    device=self.device, dtype=self.dtype)
                # The particles live inside the removal bounds: size the
                # ring from that span
                margin = 2 * max(self.config.n_guard, 1)
                cols_live = int(np.ceil((self.config.Nz - margin)
                                        * self.config.dz / dz_particles))
                needed = int(1.2 * cols_live * Npr * p_nt)
                capacity = max(capacity or 0, needed, int(1.2 * max(Ntot, 1)))

        if sort_K is None:
            if self._fused_by_default() and Ntot > 0 and not is_tracer:
                cols = np.floor((np.asarray(z) - self.zmin)
                                / self.config.dz).astype(int)
                occ = np.bincount(cols[(cols >= 0) & (cols < self.config.Nz)],
                                  minlength=self.config.Nz).max()
                sort_K = int(-(-3 * max(int(occ), 86) // 2 // 128) * 128)
            else:
                sort_K = 0
        resident = False
        if (int(sort_K) > 0 and not is_tracer and self.use_fused_deposit
                and self.config.particle_shape == "linear"):
            cap_resident = self.config.Nz * int(sort_K)
            if cap_resident >= (capacity or 0):
                capacity = cap_resident
                resident = True
        # Banded re-sort when positions move at most 2 columns per step
        resort = ("banded" if resident and self.config.resort_band <= 2
                  else "full")
        sc = SpeciesConfig(
            q=q, m=m, particle_shape=self.config.particle_shape,
            is_tracer=bool(is_tracer), name=name or f"species{len(self.species_configs)}",
            sort_K=int(sort_K), resident=resident, resort=resort)
        pstate = make_particle_state(x, y, z, ux, uy, uz, inv_gamma, w,
                                     capacity=capacity, device=self.device,
                                     dtype=self.dtype)
        if injector_cfg is not None:
            z_end = (float(np.max(z)) + 0.5 * injector_cfg.dz_particles
                     if Ntot > 0 else float(self.zmax))
            pstate = pstate.replace(next_free=Ntot,
                                    inj_z_end=self.np_dtype(z_end))
        self.species_configs.append(sc)
        self._species_counts.append(int(Ntot))
        self._injector_configs.append(injector_cfg)
        self._injector_auxes.append(injector_aux)
        self.state.species.append(pstate)
        view = SpeciesView(self, len(self.species_configs) - 1)
        self.ptcl.append(view)
        return view

    # -----------------------------------------------------------------
    def get_interp_field(self, name, m=None):
        """Return an interpolation-grid field as numpy (Nm, Nz, Nr).

        name in {Er, Et, Ez, Br, Bt, Bz} (live in state) or
        {rho, Jr, Jt, Jz} (computed on the fly from spectral space).
        """
        mats, spect = self.aux.mats, self.state.spect
        if name in ("Er", "Et", "Ez", "Br", "Bt", "Bz") or (
                name in ("Er_pml", "Et_pml", "Br_pml", "Bt_pml")
                and self.config.use_pml):
            arr = getattr(self.state.interp, name)
        elif name == "rho":
            arr = tr.spect2interp_scal(mats, spect.rho_prev)
        elif name in ("Jr", "Jt"):
            Jr, Jt = tr.spect2interp_vect(mats, spect.Jp, spect.Jm)
            arr = Jr if name == "Jr" else Jt
        elif name == "Jz":
            arr = tr.spect2interp_scal(mats, spect.Jz)
        else:
            raise ValueError(
                f"Unknown field {name!r}; expected one of Er, Et, Ez, Br, "
                "Bt, Bz, rho, Jr, Jt, Jz (and Er_pml, Et_pml, Br_pml, "
                "Bt_pml with the radial PML)")
        arr = arr.cpu().numpy()
        if self.nd_edge > 0:
            arr = arr[:, self.nd_edge:self.nd_edge + self.Nz_phys, :]
        return arr if m is None else arr[m]

    def deposit_single_species_rho(self, view):
        """Charge density of one species (diagnostics only), deposited
        with the scatter deposit: numpy complex (Nm, Nz_phys, Nr)."""
        idx = view._index
        sp, sc, cfg = self.state.species[idx], self.species_configs[idx], \
            self.config
        rho = deposit_rho_linear(
            sp.x, sp.y, sp.z, sp.w, sc.q, cfg.Nm, 1.0 / cfg.dz,
            float(self.state.zmin), cfg.Nz, 1.0 / cfg.dr, 0.0, cfg.Nr,
            self.aux.ruyten_linear,
            zfold="periodic" if cfg.boundaries_z == "periodic" else "clamp")
        rho = (rho * self.aux.invvol[:, None, :]).cpu().numpy()
        if self.nd_edge > 0:
            rho = rho[:, self.nd_edge:self.nd_edge + self.Nz_phys, :]
        return rho

    def deposit_species_rho_J_full(self, view):
        """rho and J of one species on the FULL internal grid, deposited
        together with the linear scatter (host-side global solves):
        numpy complex (Nm, Nz, Nr) each, divided by the cell volume."""
        idx = view._index
        sp, sc, cfg = self.state.species[idx], self.species_configs[idx], \
            self.config
        out = deposit_rho_J_linear(
            sp.x, sp.y, sp.z, sp.w, sc.q, sp.ux, sp.uy, sp.uz, sp.inv_gamma,
            cfg.Nm, 1.0 / cfg.dz, float(self.state.zmin), cfg.Nz,
            1.0 / cfg.dr, 0.0, cfg.Nr, self.aux.ruyten_linear,
            zfold="periodic" if cfg.boundaries_z == "periodic" else "clamp")
        return tuple((a * self.aux.invvol[:, None, :]).cpu().numpy()
                     for a in out)

    def deposit(self, fieldtype, update_spectral=True, exchange=False):
        """Deposit 'rho_prev' / 'rho_next' (any spectral rho field) or
        'J' from the current particles, filtered, into spectral space.
        update_spectral and exchange are the reference API's; on one
        device there is nothing to exchange (as in fbpic_tpu)."""
        st, aux = self.state, self.aux
        if fieldtype.startswith("rho"):
            rho = deposit_rho_spect(self.config, aux, st.species,
                                    self.species_configs, st.zmin)
            if self.filter_currents:
                rho = psp.filter_scalar(rho, aux.filter_z, aux.filter_r)
            spect = replace(st.spect, **{fieldtype: rho})
        elif fieldtype == "J":
            J = deposit_J_spect(self.config, aux, st.species,
                                self.species_configs, st.zmin)
            if self.filter_currents:
                J = psp.filter_vector(*J, aux.filter_z, aux.filter_r)
            spect = replace(st.spect, Jp=J[0], Jm=J[1], Jz=J[2])
        else:
            raise ValueError(fieldtype)
        self.state = replace(st, spect=spect)

    def get_rmax_gather(self):
        """Radius beyond which particles gather no field: rmax, less the
        radial PML cells (reference: boundary_communicator.py
        get_rmax)."""
        if self.config.use_pml:
            return self.config.rmax - self.config.nr_damp * self.config.dr
        return self.config.rmax

    def reverse_time(self):
        """Reverse the propagation direction of waves and particles by
        flipping the magnetic fields (the PML's too) and the particle
        momenta (reference: main.py:1034-1054)."""
        st = self.state
        names = ("Bp", "Bm", "Bz") + (
            ("Bp_pml", "Bm_pml") if self.config.use_pml else ())
        spect = replace(st.spect, **{n: -getattr(st.spect, n)
                                     for n in names})
        names = ("Br", "Bt", "Bz") + (
            ("Br_pml", "Bt_pml") if self.config.use_pml else ())
        interp = replace(st.interp, **{n: -getattr(st.interp, n)
                                       for n in names})
        species = [sp.replace(ux=-sp.ux, uy=-sp.uy, uz=-sp.uz)
                   for sp in st.species]
        self.state = replace(st, spect=spect, interp=interp, species=species)

    def set_interp_EB(self, **fields):
        """Overwrite interpolation-grid E/B components (numpy arrays) and
        refresh spectral E/B from them."""
        cdt = self.state.interp.Er.dtype
        interp = replace(self.state.interp, **{
            name: torch.as_tensor(np.asarray(value), dtype=cdt,
                                  device=self.device)
            for name, value in fields.items()})
        self.state = replace(self.state, interp=interp, spect=interp2spect_EB(
            self.aux, interp, self.state.spect, use_pml=self.config.use_pml))

    def set_moving_window(self, v=None, gamma_boost=None):
        """Attach a moving window of speed v (default c); requires open z
        boundaries (reference: main.py:1004-1033).  With gamma_boost (and
        the Simulation's own gamma_boost), v is a lab-frame speed and is
        converted to the boosted frame."""
        if self.config.boundaries_z != "open":
            raise ValueError(
                "A moving window requires boundaries={'z': 'open'}.")
        if v is None:
            v = c
        if gamma_boost is not None and self.boost is not None:
            v, = self.boost.velocity([v])
        self.moving_win = float(v)
        self.state = replace(self.state, mw_zref=self.state.zmin)

    # -----------------------------------------------------------------
    def build_options(self, correct_currents=True, correct_divE=False,
                      use_true_rho=False, move_positions=True,
                      move_momenta=True, reuse_rho_prev=True):
        return StepOptions(
            correct_currents=correct_currents, correct_divE=correct_divE,
            use_true_rho=use_true_rho, move_positions=move_positions,
            move_momenta=move_momenta, reuse_rho_prev=reuse_rho_prev,
            filter_currents=self.filter_currents,
            rmax_gather=self.get_rmax_gather(),
            moving_window_v=self.moving_win,
            injectors=(tuple(self._injector_configs)
                       if self.moving_win is not None else ()),
            exchange_period=self.exchange_period,
            fused_deposit=self.use_fused_deposit,
            external_fields=tuple(self.external_fields),
            mirrors=tuple(self.mirrors))

    def step(self, N=1, correct_currents=True, correct_divE=False,
             use_true_rho=False, move_positions=True, move_momenta=True,
             show_progress=False, reuse_rho_prev=True):
        """Perform N PIC cycles.

        The setup banner is printed before the first call's first cycle
        (verbose_level >= 1).  show_progress: a progress bar, updated
        (one device synchronization each) every ceil(N / 35) cycles and
        after the last.  A device out-of-memory error becomes a
        MemoryError with advice (utils.device.catch_memory_error).

        Every diagnostic in ``diags`` is written once before the first
        cycle (it checks its own period), as in fbpic_tpu.  After each
        cycle, each diagnostic with a ``capture`` method (the
        back-transformed fields) captures on the device, into a buffer
        it consumes at most every ``MAX_CAPTURE`` cycles and at the end
        of the call; every other diagnostic and every checkpoint is
        written if its period says so.  fbpic_tpu writes the latter at
        the end of step chunks that stop at their smallest period: the
        same iterations.  The laser antennas' currents are computed for
        the same chunks, one upload each (``_antenna_block``)."""
        if not self._banner_printed:
            self._banner_printed = True
            print_simulation_setup(self, self.verbose_level)
        catch_memory_error(self._step_impl)(
            N, correct_currents=correct_currents, correct_divE=correct_divE,
            use_true_rho=use_true_rho, move_positions=move_positions,
            move_momenta=move_momenta, show_progress=show_progress,
            reuse_rho_prev=reuse_rho_prev)

    def _step_impl(self, N, show_progress=False, **option_kw):
        options = self.build_options(**option_kw)
        step_fn = make_step_fn(self.config, self.species_configs, options)
        # Refresh spectral E/B from the interpolation grid (captures any
        # user-set fields), then the initial rho_prev deposit
        # (reference: main.py:408-415 and :435-449)
        self.state = prepare(self.config, options, self.species_configs,
                             self.state, self.aux)
        for diag in self.diags:
            diag.write(self)
        writers = list(self.diags) + list(self.checkpoints)
        capture = [w for w in writers if hasattr(w, "capture")]
        plain = [w for w in writers if not hasattr(w, "capture")]
        progress = ProgressBar(N) if show_progress else None
        series, block_end = (), 0
        for n in range(N):
            if self.laser_antennas and n == block_end:
                series, block_end = self._antenna_block(N, n, plain)
            self.state = step_fn(self.state, self.aux,
                                 tuple(self._injector_auxes),
                                 self.column_angles, self.generator,
                                 antenna_series=series)
            for w in capture:
                w.capture(self, capacity=min(N - n, MAX_CAPTURE))
            for w in plain:
                w.write(self)
            if progress is not None and progress.due(n + 1):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                progress.time(n + 1)
                progress.print_progress()
        for w in capture:
            w.process_captures(self)
        if progress is not None:
            progress.print_summary()
        self._consume_overflow_counters()

    def _antenna_block(self, N, n, plain):
        """The antennas' current series for the block of steps from
        cycle n of a step(N) call: fbpic_tpu's step chunk -- at most
        MAX_CAPTURE steps, ending where the plain writers' smallest
        period ends (core/simulation.py:915-941) -- computed on the host
        with t0 = iteration * dt and uploaded in one copy each.
        Returns (series, the cycle after the block)."""
        it = self.state.iteration
        chunk = min(N - n, MAX_CAPTURE)
        if plain:
            period = min(getattr(w, "period", N) for w in plain)
            chunk = min(chunk, max(1, period - it % period))
        series = tuple(
            antenna.compute_series(it * self.dt, chunk, self.config.dz,
                                   device=self.device, dtype=self.dtype,
                                   it0=it)
            for antenna in self.laser_antennas)
        return series, n + chunk

    def _ensure_capacity(self, index, min_capacity, factor=1.0):
        """Grow species ``index`` to at least ``min_capacity`` slots
        (and ``factor`` times its capacity), rounded up to 128, with dead
        slots at the array end.  A resident species is left alone: its
        capacity is Nz * sort_K and grows with the sort_K bump.  Returns
        the new capacity, or None."""
        sc = self.species_configs[index]
        sp = self.state.species[index]
        new_cap = int(-(-max(min_capacity, int(factor * sp.capacity))
                        // 128) * 128)
        if sc.resident or new_cap <= sp.capacity:
            return None
        species = list(self.state.species)
        species[index] = pad_particle_state(sp, new_cap)
        self.state = replace(self.state, species=species)
        return new_cap

    def _consume_overflow_counters(self):
        """Read the overflow counters (one host read per step() call).

        sort_overflow > 0: some z column exceeded its sort_K slots and
        the excess particles were lost (resident) or their charge was
        dropped (sorted each step); warn and bump sort_K (1.5x, rounded
        to 128), re-padding every row of a resident layout.
        ring_overwrite > 0: injected particles overwrote live ones in a
        full ring, or found no dead slot in a resident species; warn and
        double the capacity of every non-resident injecting species
        that is more than half full (one more host read each)."""
        n_sort = int(self.state.sort_overflow)
        n_ring = int(self.state.ring_overwrite)
        self.overflow_totals["sort_overflow"] += n_sort
        self.overflow_totals["ring_overwrite"] += n_ring
        if n_sort > 0:
            bumped = []
            species = list(self.state.species)
            for i, sc in enumerate(self.species_configs):
                if sc.sort_K <= 0:
                    continue
                new_K = int(-(-3 * sc.sort_K // 2 // 128) * 128)
                self.species_configs[i] = replace(sc, sort_K=new_K)
                if sc.resident:
                    species[i] = pad_particle_state(
                        species[i], self.config.Nz * new_K,
                        row_shape=(self.config.Nz, sc.sort_K))
                bumped.append(f"{sc.name}: {sc.sort_K}->{new_K}")
            self.state = replace(self.state, species=species)
            warnings.warn(
                f"{n_sort} particle-step(s) exceeded a z column's "
                f"capacity during this step() call (those particles were "
                f"lost, or their charge dropped); sort_K auto-bumped "
                f"({'; '.join(bumped)}).  Pass a larger sort_K to "
                f"add_new_species to avoid this.", RuntimeWarning)
        if n_ring > 0:
            grown = []
            for i, sc in enumerate(self.species_configs):
                sp = self.state.species[i]
                if sc.resident or self._injector_configs[i] is None:
                    continue
                n_live = int((sp.w != 0).sum())
                if n_live > 0.5 * sp.capacity:
                    new_cap = self._ensure_capacity(i, 0, factor=2.0)
                    if new_cap:
                        grown.append(f"{sc.name}: -> {new_cap}")
            warnings.warn(
                f"{n_ring} created/injected particle(s) found their "
                "species' ring buffer full this step() call (they were "
                "dropped or overwrote live particles)"
                + (f"; capacity auto-grown ({'; '.join(grown)}) for "
                   f"subsequent steps" if grown else "")
                + ".  Pass a larger `capacity` to add_new_species to "
                "avoid this.", RuntimeWarning)
        if n_sort > 0 or n_ring > 0:
            self.state = replace(
                self.state,
                sort_overflow=torch.zeros_like(self.state.sort_overflow),
                ring_overwrite=torch.zeros_like(self.state.ring_overwrite))
