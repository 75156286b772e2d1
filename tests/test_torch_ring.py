"""The non-resident (ring) species path, module by module:
fbpic_tpu_torch against fbpic_tpu on the same numpy-seeded inputs.

- ``gather_fields_linear`` (the 4-corner gather by index) in float64
  (1e-12) and float32 (5e-6), each output against the largest value of
  its vector pair (Ex/Ey, Bx/By rotate the same (Fr, Ft)), with
  particles on and below the axis, past the last radial cell and past
  rmax_gather, with and without Kahan words, inside the box and beyond
  both z ends (z is taken mod Nz, open z too); and the two analytic
  cases of tests/test_particles.py:116-167.
- ``write_ring`` and the ring-cursor branch of ``continuous_injection``
  slot by slot (exactly), with a cursor that wraps past the ring's end
  onto live particles, and the count of those it overwrites.
- ``set_interp_EB`` refreshes spectral E/B (1e-12 relative).
- ``pad_particle_state``, ``Simulation._ensure_capacity`` and the ring
  auto-grow: the same capacities, slots and warning.
- An empty species (``add_new_species`` without ``n``) beside a laser,
  and a ring species with an empty one carried by
  ``utils.carry.state_from_numpy``, stepped in both packages.
- The sorted non-resident species in float64: the fused deposit on a
  fresh mid-step sort (``use_fused_deposit`` with a capacity above
  Nz * sort_K: K3's plain version twice a step) and the legacy plan
  (``use_fused_deposit`` off, ``sort_K`` > 0: ``deposit_J_sorted`` /
  ``deposit_rho_sorted``, K3's plain version on the ``idx`` plan).

Step gates as in tests/test_torch_boosted.py: particles to 1e-12 and
fields to 1e-8 of the scale of their vector (the curl-free correction
amplifies the float64 roundoff of deposits summed in another order).
fbpic_tpu's injection angles feed the port
(tests/test_torch_step.py::jax_column_angles).
"""
import dataclasses
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c, e, m_e  # noqa: E402

PARTICLE = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")
INTERP = ("Er", "Et", "Ez", "Br", "Bt", "Bz")
SPECT = ("Ep", "Em", "Ez", "Bp", "Bm", "Bz", "Jp", "Jm", "Jz", "rho_prev",
         "rho_next")
VECTORS = (("x", "y", "z"), ("ux", "uy", "uz"), ("inv_gamma",), ("w",),
           ("Er", "Et", "Ez"), ("Br", "Bt", "Bz"), ("Ep", "Em", "Ez"),
           ("Bp", "Bm", "Bz"), ("Jp", "Jm", "Jz"), ("rho_prev", "rho_next"))

# The window configuration of tests/test_torch_step.py (open z, moving
# window, continuous injection, a0 = 0.5 laser), fbpic_tpu's defaults
NZ_PHYS, NR, NM = 130, 16, 2
ZMAX, ZMIN, RMAX = 12.e-6, -4.e-6, 10.e-6
DT = (ZMAX - ZMIN) / NZ_PHYS / c
SIM_KW = dict(zmin=ZMIN, n_order=16,
              boundaries={"z": "open", "r": "reflective"},
              exchange_period=4, random_seed=0, verbose_level=0)
SPECIES_KW = dict(q=-e, m=m_e, n=5.e24, p_zmin=2.e-6, p_zmax=100.e-6,
                  p_rmin=0., p_rmax=9.e-6, p_nz=1, p_nr=2, p_nt=4,
                  continuous_injection=True)
LASER_KW = dict(a0=0.5, waist=4.e-6, tau=8.e-15, z0=6.e-6)
EPS0 = 8.8541878128e-12


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(ref, out, name, tol, scale=None):
    ref, out = np.asarray(ref), np.asarray(out)
    assert ref.shape == out.shape, name
    if ref.size == 0:
        return
    if scale is None:
        scale = np.abs(ref).max(initial=0.0)
    if scale == 0:
        assert np.abs(out).max() == 0, name
    else:
        err = np.abs(out - ref).max() / scale
        assert err <= tol, (name, err)


def compare_states(ref, state1, tol_particles=1e-12, tol_fields=1e-8,
                   scales=None, live_only=False):
    """Gate a port SimState against fbpic_tpu's (as jax_state_to_numpy
    gives it): grid edge, time and counters exactly, every species slot
    by slot (which slots are live exactly; with ``live_only``, the
    arrays at the live slots only), every field, each to the scale of
    its vector (or to ``scales["<kind> <name>"]`` where given, kind
    interp, spect or species)."""
    scales = scales or {}
    for n in ("time", "zmin", "mw_zref"):
        assert float(getattr(state1, n)) == ref[n], n
    assert state1.iteration == ref["iteration"]
    assert int(state1.sort_overflow) == ref["sort_overflow"]
    assert int(state1.ring_overwrite) == ref["ring_overwrite"]
    groups = [("interp", INTERP, state1.interp, tol_fields, ref["interp"]),
              ("spect", SPECT, state1.spect, tol_fields, ref["spect"])]
    for sp_ref, sp in zip(ref["species"], state1.species):
        assert sp.next_free == sp_ref["next_free"]
        if sp_ref["inj_z_end"] is not None:
            assert float(sp.inj_z_end) == sp_ref["inj_z_end"]
        live = sp_ref["w"] != 0
        np.testing.assert_array_equal(live, sp.w.numpy() != 0)
        if live_only:
            sp_ref = {n: sp_ref[n][live] for n in PARTICLE}
            sp = sp.replace(**{n: getattr(sp, n)[torch.as_tensor(live)]
                               for n in PARTICLE})
        groups.append(("species", PARTICLE, sp, tol_particles, sp_ref))
    for kind, names, obj, tol, arrays in groups:
        for vec in VECTORS:
            if not set(vec) <= set(names):
                continue
            scale = max(np.abs(arrays[n]).max(initial=0.0) for n in vec)
            for n in vec:
                _close(arrays[n], getattr(obj, n).numpy(), f"{kind} {n}",
                       tol, scale=scales.get(f"{kind} {n}", scale))


def noise_scales(sim, ref, n_steps, n_e):
    """compare_states scales for a cold plasma at rest with no laser,
    whose fields, currents and momenta are float64 roundoff noise
    (~1e-13 of these scales), summed in another order by each package:
    E of e n_e dz / eps0 (the field of one cell's charge), B of that over
    c, the momenta of what that field gives in the run's n_steps, J of
    e n_e c times that momentum; the spectral fields carry the
    transforms' gain (rho_prev's, measured against the port's rho)."""
    E_s = e * n_e * sim.config.dz / EPS0
    u_s = e * E_s * sim.dt * n_steps / (m_e * c)
    J_s = e * n_e * c * u_s
    gain = (np.abs(ref["spect"]["rho_prev"]).max()
            / np.abs(sim.get_interp_field("rho")).max())
    return dict(
        {f"interp {n}": E_s for n in ("Er", "Et", "Ez")},
        **{f"interp {n}": E_s / c for n in ("Br", "Bt", "Bz")},
        **{f"spect {n}": gain * E_s for n in ("Ep", "Em", "Ez")},
        **{f"spect {n}": gain * E_s / c for n in ("Bp", "Bm", "Bz")},
        **{f"spect {n}": gain * J_s for n in ("Jp", "Jm", "Jz")},
        **{f"species {n}": u_s for n in ("ux", "uy", "uz")})


def window_sims(species_kw=SPECIES_KW, laser=True, fused=None, capacity=None,
                extra=()):
    """fbpic_tpu and the port on the window configuration, the port fed
    fbpic_tpu's injection angles.  fused: use_fused_deposit of both (None:
    each package's default); extra: more add_new_species keywords."""
    from test_torch_step import jax_column_angles
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    s0 = S0(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, **SIM_KW)
    s1 = S1(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, device="cpu",
            dtype=torch.float64, **SIM_KW)
    if fused is not None:
        s0.use_fused_deposit = s1.use_fused_deposit = fused
    assert s0.use_fused_deposit == s1.use_fused_deposit
    for kw in (dict(species_kw, capacity=capacity),) + tuple(extra):
        s0.add_new_species(**kw)
        s1.add_new_species(**kw)
    if laser:
        a0(s0, L0(**LASER_KW))
        a1(s1, L1(**LASER_KW))
    s0.set_moving_window(v=c)
    s1.set_moving_window(v=c)
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    for sc0, sc1 in zip(s0.species_configs, s1.species_configs):
        assert (sc0.sort_K, sc0.resident) == (sc1.sort_K, sc1.resident)
    for sp0, sp1 in zip(s0.state.species, s1.state.species):
        assert sp0.capacity == sp1.capacity
    return s0, s1


# ---------------------------------------------------------------------
# gather_fields_linear
# ---------------------------------------------------------------------

G_NZ, G_NR, G_DZ, G_DR, G_ZMIN = 16, 10, 0.1, 0.2, -1.0
G_RMAX = (G_NR + 0.3) * G_DR


def _gather_inputs(dtype, beyond_z, seed=5):
    rng = np.random.RandomState(seed)
    Np = 1500
    lo, hi = (-2.5, G_NZ + 2.5) if beyond_z else (0.0, G_NZ)
    z = G_ZMIN + rng.uniform(lo, hi, Np) * G_DZ
    r = rng.uniform(0, 1.08 * G_NR * G_DR, Np)
    pick = rng.rand(Np)
    r[pick < 0.25] = rng.uniform(0, 0.5 * G_DR, int((pick < 0.25).sum()))
    r[pick > 0.95] = 0.0
    th = rng.uniform(0, 2 * np.pi, Np)
    comp = [rng.randn(Np) * 1e-3 * G_DZ for _ in range(3)]
    fields = {n: (rng.randn(NM, G_NZ, G_NR).astype(dtype),
                  rng.randn(NM, G_NZ, G_NR).astype(dtype)) for n in INTERP}
    parts = [a.astype(dtype) for a in (r * np.cos(th), r * np.sin(th), z)]
    return parts, [a.astype(dtype) for a in comp], fields


def _gather_pair(parts, comp, fields, rmax, with_comp):
    from fbpic_tpu.fields.solver import InterpFields as I0
    from fbpic_tpu.particles.gather import gather_fields_linear as g0
    from fbpic_tpu.utils.complex_arr import CArr
    from fbpic_tpu_torch.fields.solver import InterpFields as I1
    from fbpic_tpu_torch.particles.gather import gather_fields_linear as g1
    geo = (1 / G_DZ, G_ZMIN, G_NZ, 1 / G_DR, 0.0, G_NR)
    ref = g0(*[jnp.asarray(a) for a in parts],
             I0(**{n: CArr(jnp.asarray(re), jnp.asarray(im))
                   for n, (re, im) in fields.items()}), rmax, *geo,
             comp=tuple(jnp.asarray(a) for a in comp) if with_comp else None)
    out = g1(*[torch.as_tensor(a) for a in parts],
             I1(**{n: torch.complex(torch.as_tensor(re), torch.as_tensor(im))
                   for n, (re, im) in fields.items()}), rmax, *geo,
             comp=tuple(torch.as_tensor(a) for a in comp)
             if with_comp else None)
    return [np.asarray(a) for a in ref], [t.numpy() for t in out]


@pytest.mark.parametrize("with_comp", [False, True])
@pytest.mark.parametrize("beyond_z", [False, True])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 5e-6),
                                       (np.float64, 1e-12)])
def test_gather_fields_linear_matches_fbpic_tpu(dtype, tol, beyond_z,
                                                with_comp):
    parts, comp, fields = _gather_inputs(dtype, beyond_z)
    rmax = dtype(G_RMAX)
    ref, out = _gather_pair(parts, comp, fields, rmax, with_comp)
    # what the inputs reach: below-axis and on-axis particles, the top
    # radial cell's clamp, particles past rmax_gather (zeroed)
    r = np.hypot(parts[0], parts[1])
    rc = r / G_DR - 0.5
    assert (rc < 0).any() and (r == 0).any() and (rc >= G_NR - 1).any()
    assert (r >= rmax).any() and (np.abs(ref[2][r >= rmax]) == 0).all()
    if beyond_z:
        zc = (parts[2] - G_ZMIN) / G_DZ - 0.5
        assert (zc < 0).any() and (zc >= G_NZ - 1).any()
    for group in ((0, 1), (2,), (3, 4), (5,)):
        scale = max(np.abs(ref[q]).max() for q in group)
        for q in group:
            _close(ref[q], out[q], f"component {q}", tol, scale=scale)


def test_gather_linear_uniform_Ez():
    """tests/test_particles.py::test_gather_uniform_Ez with the port."""
    from fbpic_tpu_torch.fields.solver import GridConfig, InterpFields
    from fbpic_tpu_torch.particles.gather import gather_fields_linear
    Nz, Nr, Nm, dz, rmax, E0 = 16, 16, 2, 1e-6, 16e-6, 5.0e9
    dr = rmax / Nr
    config = GridConfig(Nz=Nz, Nr=Nr, Nm=Nm, dz=dz, dr=dr, rmax=rmax,
                        dt=1e-15)
    interp = InterpFields.zeros(config, "cpu", torch.float64)
    interp.Ez[0] = E0
    rng = np.random.RandomState(2)
    r = rng.uniform(0, 0.9 * rmax, 100)
    th = rng.uniform(0, 2 * np.pi, 100)
    x, y = torch.as_tensor(r * np.cos(th)), torch.as_tensor(r * np.sin(th))
    z = torch.as_tensor(rng.uniform(0.0, Nz * dz, 100))
    Ex, Ey, Ez, Bx, By, Bz = gather_fields_linear(
        x, y, z, interp, rmax, 1 / dz, 0.0, Nz, 1 / dr, 0.0, Nr)
    np.testing.assert_allclose(Ez.numpy(), E0, rtol=1e-12)
    assert Ex.abs().max() < 1e-6 and Bz.abs().max() < 1e-20


def test_gather_linear_mode1_theta_dependence():
    """tests/test_particles.py::test_gather_mode1_theta_dependence with the
    port: a real mode-1 Ez coefficient gives 2 F1 cos(theta)."""
    from fbpic_tpu_torch.fields.solver import GridConfig, InterpFields
    from fbpic_tpu_torch.particles.gather import gather_fields_linear
    Nz, Nr, Nm, rmax = 8, 8, 2, 8e-6
    dz, dr = 1e-6, rmax / Nr
    config = GridConfig(Nz=Nz, Nr=Nr, Nm=Nm, dz=dz, dr=dr, rmax=rmax,
                        dt=1e-15)
    interp = InterpFields.zeros(config, "cpu", torch.float64)
    F1 = 3.0e7
    interp.Ez[1] = F1
    theta = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    r0 = 3.3 * dr
    _, _, Ez, _, _, _ = gather_fields_linear(
        torch.as_tensor(r0 * np.cos(theta)),
        torch.as_tensor(r0 * np.sin(theta)),
        torch.full((16,), 4.2 * dz, dtype=torch.float64), interp, rmax,
        1 / dz, 0.0, Nz, 1 / dr, 0.0, Nr)
    np.testing.assert_allclose(Ez.numpy(), 2 * F1 * np.cos(theta),
                               rtol=1e-10, atol=1e-6)


# ---------------------------------------------------------------------
# write_ring and ring-cursor injection
# ---------------------------------------------------------------------

@pytest.mark.parametrize("start,n,masked", [
    (0, 7, False), (5, 11, True), (14, 9, True), (3, 16, True)])
def test_write_ring_matches_fbpic_tpu(start, n, masked):
    from fbpic_tpu.particles.injection import write_ring as w0
    from fbpic_tpu_torch.particles.injection import write_ring as w1
    rng = np.random.RandomState(start + n)
    cap = 16
    arr, vals = rng.randn(cap), rng.randn(n)
    mask = rng.rand(n) < 0.7 if masked else None
    ref = np.asarray(w0(jnp.asarray(arr), start, jnp.asarray(vals), cap,
                        None if mask is None else jnp.asarray(mask)))
    out = w1(torch.as_tensor(arr), start, torch.as_tensor(vals), cap,
             None if mask is None else torch.as_tensor(mask))
    np.testing.assert_array_equal(ref, out.numpy())


def test_write_ring_longer_than_the_ring():
    """More values than slots: the later values win where slots repeat;
    masked-off values keep what the slot held before the write."""
    from fbpic_tpu_torch.particles.injection import write_ring
    cap, start, n = 5, 3, 12
    vals = np.arange(100, 100 + n, dtype=np.float64)
    mask = np.ones(n, bool)
    mask[-1] = False                     # slot (3 + 11) % 5 = 4
    out = write_ring(torch.zeros(cap, dtype=torch.float64), start,
                     torch.as_tensor(vals), cap, torch.as_tensor(mask))
    ref = np.zeros(cap)
    for i in range(n):
        ref[(start + i) % cap] = vals[i] if mask[i] else 0.0
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("cursor", ["after_live", "wraps_onto_live"])
def test_ring_injection_matches_fbpic_tpu(cursor):
    """The ring branch of continuous_injection in both packages from the
    same species state: every slot, the cursor, the injection front and
    the count of live in-range particles overwritten (zero when the
    cursor sits after the live particles, positive when it wraps past
    the ring's end onto them)."""
    from fbpic_tpu.core.step import continuous_injection as ci0, \
        _stream_key, _STREAM_INJECT
    from fbpic_tpu_torch.core.step import continuous_injection as ci1, \
        injection_columns
    s0, s1 = window_sims(laser=False)
    sp0, sp1 = s0.state.species[0], s1.state.species[0]
    n_live = int((np.asarray(sp0.w) != 0).sum())
    inj = s1._injector_configs[0]
    start = n_live if cursor == "after_live" else sp0.capacity - 3 * 64
    # an injection front 10 columns back, so several columns go in
    z_end = float(sp0.inj_z_end) - 10 * inj.dz_particles
    sp0 = dataclasses.replace(sp0, next_free=jnp.asarray(start, jnp.int32),
                              inj_z_end=jnp.asarray(z_end))
    sp1 = sp1.replace(next_free=start, inj_z_end=np.float64(z_end))
    new0, count0 = ci0(s0.config, s0.build_options(), s0.aux, sp0,
                       s0.species_configs[0], s0._injector_configs[0],
                       s0._injector_auxes[0], s0.state.zmin,
                       _stream_key(s0.state, _STREAM_INJECT, 0))
    n_cols, z_lo, z_end_after = injection_columns(
        s1.config, s1.build_options(), inj, sp1.inj_z_end, s1.state.zmin)
    new1, count1 = ci1(sp1, inj, s1._injector_auxes[0],
                       (n_cols, sp1.inj_z_end, z_lo),
                       lambda nkey: s1.column_angles(0, 0, nkey),
                       s1.generator, resident=False)
    assert int(count1) == int(count0)
    assert (int(count0) == 0) == (cursor == "after_live")
    assert new1.next_free == int(new0.next_free)
    assert float(z_end_after) == float(new0.inj_z_end)
    for n in PARTICLE:
        np.testing.assert_array_equal(np.asarray(getattr(new0, n)),
                                      getattr(new1, n).numpy(), n)


# ---------------------------------------------------------------------
# Simulation: set_interp_EB, empty species, capacity growth
# ---------------------------------------------------------------------

def test_set_interp_EB_refreshes_spectral_fields():
    s0, s1 = window_sims(laser=False)
    rng = np.random.RandomState(3)
    shape = (NM, s1.config.Nz, NR)
    fields = {n: rng.randn(*shape) + 1j * rng.randn(*shape)
              for n in ("Er", "Et", "Bz")}
    s0.set_interp_EB(**fields)
    s1.set_interp_EB(**fields)
    for n in ("Ep", "Em", "Ez", "Bp", "Bm", "Bz"):
        _close(getattr(s0.state.spect, n).to_numpy(),
               getattr(s1.state.spect, n).numpy(), n, 1e-12)
    for n in INTERP:
        _close(getattr(s0.state.interp, n).to_numpy(),
               getattr(s1.state.interp, n).numpy(), n, 0.0)


@pytest.mark.parametrize("capacity", [None, 0])
def test_empty_species_steps_like_fbpic_tpu(capacity):
    """add_new_species without n: an empty, non-resident species sized
    as fbpic_tpu sizes it (256 dead slots), or with no slots at all
    (capacity 0: zero-length tensors through the gather and the scatter
    deposits), beside a laser, through 12 steps (3 exchanges) of both
    packages."""
    from test_torch_step import jax_state_to_numpy
    s0, s1 = window_sims(species_kw=dict(q=-e, m=m_e), capacity=capacity)
    for s in (s0, s1):
        sc, sp = s.species_configs[0], s.state.species[0]
        assert sc.sort_K == 0 and not sc.resident
        assert sp.capacity == (256 if capacity is None else 0)
    s0.step(12, show_progress=False)
    s1.step(12)
    assert s1.ptcl[0].Ntot == 0
    # all slots stay dead (they are gathered and pushed too, harmlessly:
    # from the axis, where the push's direction is roundoff)
    compare_states(jax_state_to_numpy(s0.state), s1.state, live_only=True)


def test_pad_particle_state_matches_fbpic_tpu():
    from fbpic_tpu.particles.state import make_particle_state as mk0, \
        pad_particle_state as pad0
    from fbpic_tpu_torch.particles.state import make_particle_state as mk1, \
        pad_particle_state as pad1
    rng = np.random.RandomState(4)
    arrays = [rng.randn(40) for _ in range(8)]
    for new_cap, rows in ((100, None), (48, (8, 5)), (40, None)):
        a = pad0(mk0(*arrays, capacity=40), new_cap, row_shape=rows)
        b = pad1(mk1(*arrays, capacity=40, device="cpu"), new_cap,
                 row_shape=rows)
        for n in PARTICLE:
            np.testing.assert_array_equal(np.asarray(getattr(a, n)),
                                          getattr(b, n).numpy(), n)
    with pytest.raises(ValueError):
        pad1(mk1(*arrays, capacity=40, device="cpu"), 30)


def test_ensure_capacity_matches_fbpic_tpu():
    s0, s1 = window_sims(laser=False)
    for args in ((0, 100000), (0, 0, 2.0), (0, 10)):
        assert s0._ensure_capacity(*args) == s1._ensure_capacity(*args)
        for n in PARTICLE:
            np.testing.assert_array_equal(
                np.asarray(getattr(s0.state.species[0], n)),
                getattr(s1.state.species[0], n).numpy(), n)
    assert s1.state.species[0].capacity == s0.state.species[0].capacity
    # a resident species keeps its Nz * sort_K capacity
    from fbpic_tpu_torch import Simulation
    s2 = Simulation(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, device="cpu",
                    dtype=torch.float64, **SIM_KW)
    s2.use_fused_deposit = True
    s2.add_new_species(**SPECIES_KW, sort_K=256)
    assert s2.species_configs[0].resident
    assert s2._ensure_capacity(0, 10 * s2.state.species[0].capacity) is None


def _ring_warning(records):
    """(count, grown species or None) of the one ring warning."""
    msgs = [str(w.message) for w in records
            if issubclass(w.category, RuntimeWarning)
            and "ring buffer full" in str(w.message)]
    assert len(msgs) == 1, msgs
    count = re.search(r"(\d+) created/injected", msgs[0])
    grown = re.search(r"capacity auto-grown \((.*?)\)", msgs[0])
    return int(count.group(1)), grown and grown.group(1)


@pytest.mark.parametrize("fill", [0.4, 0.6])
def test_ring_auto_grow_matches_fbpic_tpu(fill):
    """A ring_overwrite count after a step() call: both packages warn
    with the count, and double (to a multiple of 128) the capacity of an
    injecting ring species more than half full -- here one whose first
    ``fill`` of slots are live -- and only that one."""
    s0, s1 = window_sims(laser=False)
    cap = s1.state.species[0].capacity
    live = np.arange(cap) < int(fill * cap)
    sp0 = s0.state.species[0]
    s0.state = dataclasses.replace(
        s0.state, ring_overwrite=jnp.asarray(7, jnp.int32),
        species=(dataclasses.replace(sp0, w=jnp.asarray(live * 1.0)),))
    s1.state = dataclasses.replace(
        s1.state, ring_overwrite=torch.tensor(7),
        species=[s1.state.species[0].replace(w=torch.as_tensor(live * 1.0))])
    recs = []
    for s in (s0, s1):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            s._consume_overflow_counters()
        recs.append(_ring_warning(rec))
    assert recs[0] == recs[1] and recs[0][0] == 7
    new_cap = s0.state.species[0].capacity
    assert new_cap == s1.state.species[0].capacity
    assert (new_cap > cap) == (fill > 0.5)
    if fill > 0.5:
        assert new_cap == -(-2 * cap // 128) * 128
        assert recs[0][1] == f"species0: -> {new_cap}"
    assert int(s1.state.ring_overwrite) == 0
    for n in PARTICLE:
        np.testing.assert_array_equal(
            np.asarray(getattr(s0.state.species[0], n)),
            getattr(s1.state.species[0], n).numpy(), n)


def test_carried_ring_state_steps_like_fbpic_tpu():
    """An fbpic_tpu state with a ring species and two empty ones (256
    dead slots; no slots), carried into the port
    (utils.carry.state_from_numpy: any capacity, the ring cursor, the
    injection front), then one exchange step and one step between
    exchanges in both packages from that state."""
    from fbpic_tpu.core.step import make_step_fn as m0, make_prepare as p0
    from fbpic_tpu_torch.core.step import make_step_fn as m1
    from fbpic_tpu_torch.utils.carry import state_from_numpy
    from test_torch_step import jax_state_to_numpy
    s0, s1 = window_sims(extra=(dict(q=-e, m=m_e),
                                dict(q=-e, m=m_e, capacity=0)))
    options0 = s0.build_options()
    step0 = jax.jit(m0(s0.config, tuple(s0.species_configs), options0))
    step1 = m1(s1.config, s1.species_configs, s1.build_options())
    # fbpic_tpu's run-up to iteration 8 (the next step is an exchange),
    # through the same jitted step the checked steps use
    inj0 = tuple(s0._injector_auxes)
    state0 = p0(s0.config, tuple(s0.species_configs), options0)(
        s0.state, s0.aux, inj0, (), (), ())
    for _ in range(8):
        state0 = step0(state0, s0.aux, inj0, (), (), ())
    assert int(state0.iteration) == 8
    for _ in range(2):
        carried = jax_state_to_numpy(state0)
        assert carried["species"][0]["next_free"] > 0
        state1 = state_from_numpy(**carried, device="cpu")
        assert [sp.capacity for sp in state1.species] == \
            [sp.capacity for sp in state0.species]
        state0 = step0(state0, s0.aux, tuple(s0._injector_auxes), (), (),
                       ())
        state1 = step1(state1, s1.aux, tuple(s1._injector_auxes),
                       s1.column_angles, s1.generator)
        compare_states(jax_state_to_numpy(state0), state1)


# ---------------------------------------------------------------------
# Sorted non-resident species (float64)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["fresh_sort", "legacy"])
def test_sorted_non_resident_steps_like_fbpic_tpu(plan):
    """fresh_sort: use_fused_deposit on and a capacity above Nz * sort_K,
    so the species is sorted afresh at the mid positions every step and
    deposited by deposit_rho_J_sorted (float64: J and rho, K3's plain
    version twice).  legacy: use_fused_deposit off with sort_K > 0, the
    idx plan and deposit_J_sorted / deposit_rho_sorted.  10 steps."""
    from test_torch_step import jax_state_to_numpy
    fused = plan == "fresh_sort"
    kw = dict(SPECIES_KW, sort_K=256)
    s0, s1 = window_sims(species_kw=kw, fused=fused,
                         capacity=200_000 if fused else None)
    for s in (s0, s1):
        sc, sp = s.species_configs[0], s.state.species[0]
        assert sc.sort_K == 256 and not sc.resident
        if fused:
            assert sp.capacity > s.config.Nz * 256
    s0.step(10, show_progress=False)
    s1.step(10)
    compare_states(jax_state_to_numpy(s0.state), s1.state)
