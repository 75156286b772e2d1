"""ADK ionization of fbpic_tpu_torch against fbpic_tpu (float64, CPU).

fbpic_tpu's random draws are fed to the port (``jax_process_draws``: the
same ``_stream_key`` and ``jax.random`` calls), so the two packages take
the same decisions:

- the NIST table (every element), the ADK coefficients (1e-12), the
  compaction of a selection (also one larger than the buffer) and the
  per-level repack, exactly;
- ``ionize`` on random particles and fields: levels exactly, the
  creation buffer to 1e-12;
- whole steps from a carried fbpic_tpu state (``utils.carry``): a ring
  ionizer into a tracked ring target (tests/test_ionization.py's static
  field), a resident ionizer into a resident tracked target
  (tests/test_resident_processes.py's), per-level routing into four
  species, and the laser-driven N5+ run of
  tests/test_small_capacity_target_receives_electrons (the empty target
  grown to one creation buffer).  Particle arrays to 1e-12 on the live
  slots (x and y of their pair's scale, the momenta of the momentum's,
  the others of their own), levels, ids, cursors and counters exactly,
  fields to 1e-8 (the curl-free correction's roundoff gate of
  tests/test_torch_step.py);
- a checkpoint / restart round trip of an ionizable species and its
  target, bit for bit.
"""
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c, e, m_e, m_p  # noqa: E402

PARTICLE = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")
SPECT = ("Ep", "Em", "Ez", "Bp", "Bm", "Bz", "Jp", "Jm", "Jz", "rho_prev",
         "rho_next")
INTERP = ("Er", "Et", "Ez", "Br", "Bt", "Bz")
# Particle arrays held against their vector's scale: a linearly
# polarized laser leaves uy (and y's motion) at the roundoff of the
# rotation that makes ux
VECTORS = (("x", "y"), ("z",), ("ux", "uy", "uz"), ("inv_gamma",), ("w",))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# Helpers shared with tests/test_torch_compton.py
# ---------------------------------------------------------------------

def jax_process_draws(seed):
    """fbpic_tpu's draws of ionization and Compton scattering
    (core/step.py:92-110, particles/ionization.py:182,
    particles/compton.py:148-203) as the port's draw source."""
    from fbpic_tpu.core.step import (_stream_key, _STREAM_IONIZE,
                                     _STREAM_COMPTON)

    def draws(name, iteration, species_index, shape, dtype):
        jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
        st = SimpleNamespace(seed=jnp.asarray(seed, jnp.uint32),
                             iteration=jnp.asarray(iteration, jnp.int32))
        if name == "ionize":
            u = jax.random.uniform(
                _stream_key(st, _STREAM_IONIZE, species_index), shape, jdt)
            return torch.as_tensor(np.array(u))
        k_draw, k_rej, k_phi, k_rec = jax.random.split(
            _stream_key(st, _STREAM_COMPTON, species_index), 4)
        k1, k2 = jax.random.split(k_rej)
        key = dict(compton_u=k_draw, compton_r1=k1, compton_r2=k2,
                   compton_phi=k_phi, compton_recoil=k_rec)[name]
        if name == "compton_phi":
            u = jax.random.uniform(key, shape, jdt, 0.0, 2 * np.pi)
        else:
            u = jax.random.uniform(key, shape, jdt)
        return torch.as_tensor(np.array(u))
    return draws


def jax_column_angles(seed):
    """fbpic_tpu's injection angles (particles/injection.py:145-161)."""
    def angles(iteration, species_index, nkey):
        root = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
        key = jax.random.fold_in(root, species_index)
        key = jax.random.fold_in(key, jnp.asarray(iteration, jnp.int32))
        key_th = jax.random.fold_in(key, 1)
        phi = jax.vmap(lambda n: 2.0 * jnp.pi * jax.random.uniform(
            jax.random.fold_in(key_th, n), (), jnp.float64))(
                jnp.asarray(nkey.cpu().numpy(), jnp.int32))
        return torch.as_tensor(np.array(phi))
    return angles


def jax_state_to_numpy(state):
    """fbpic_tpu SimState -> the arguments of state_from_numpy (with the
    levels, the two-word ids and the counters)."""
    def opt(v, cast=np.asarray):
        return None if v is None else cast(np.asarray(v))

    species = []
    for sp in state.species:
        d = {n: np.asarray(getattr(sp, n)) for n in PARTICLE}
        for n in ("comp_x", "comp_y", "comp_z", "ionization_level", "ids",
                  "ids_hi"):
            d[n] = opt(getattr(sp, n))
        for n in ("next_free", "next_id", "next_id_hi"):
            d[n] = opt(getattr(sp, n), int)
        d["inj_z_end"] = opt(sp.inj_z_end, float)
        species.append(d)
    names = [n for n in SPECT if getattr(state.spect, n) is not None]
    return dict(
        spect={n: getattr(state.spect, n).to_numpy() for n in names},
        interp={n: getattr(state.interp, n).to_numpy() for n in INTERP},
        species=species, time=float(state.time), zmin=float(state.zmin),
        iteration=int(state.iteration),
        mw_zref=opt(state.mw_zref, float),
        sort_overflow=int(state.sort_overflow or 0),
        ring_overwrite=int(state.ring_overwrite or 0))


def close(ref, out, name, tol, scale=None):
    """out within tol of ref, relative to ``scale`` (default: ref's
    largest value)."""
    ref, out = np.asarray(ref), np.asarray(out)
    assert ref.shape == out.shape, name
    if scale is None:
        scale = np.abs(ref).max() if ref.size else 0
    if scale == 0:
        assert np.abs(out).max(initial=0) == 0, name
    else:
        err = np.abs(out - ref).max()
        assert err <= tol * scale, (name, err / scale)


def assert_states_match(ref, state1, tol_fields=1e-8, tolerances=None):
    """A port state against fbpic_tpu's (numpy) after the same step;
    tolerances: {species index: the particle arrays' tolerance} where it
    is not 1e-12."""
    from fbpic_tpu_torch.utils.carry import join_words
    assert state1.iteration == ref["iteration"]
    for n in ("time", "zmin"):
        assert float(getattr(state1, n)) == ref[n], n
    assert int(state1.sort_overflow) == ref["sort_overflow"]
    assert int(state1.ring_overwrite) == ref["ring_overwrite"]
    for n in ref["spect"]:
        close(ref["spect"][n], getattr(state1.spect, n).numpy(), n,
              tol_fields)
    for n in INTERP:
        close(ref["interp"][n], getattr(state1.interp, n).numpy(), n,
              tol_fields)
    for i, (sp_ref, sp) in enumerate(zip(ref["species"], state1.species)):
        live = sp_ref["w"] != 0
        np.testing.assert_array_equal(live, sp.w.numpy() != 0)
        for group in VECTORS:
            scale = max(np.abs(sp_ref[n][live]).max(initial=0)
                        for n in group)
            for n in group:
                close(sp_ref[n][live], getattr(sp, n).numpy()[live],
                      f"species {i} {n}", (tolerances or {}).get(i, 1e-12),
                      scale)
        if sp_ref["ionization_level"] is not None:
            np.testing.assert_array_equal(
                sp_ref["ionization_level"][live],
                sp.ionization_level.numpy()[live])
        if sp_ref["ids"] is not None:
            np.testing.assert_array_equal(
                join_words(sp_ref["ids"], sp_ref["ids_hi"])[live].astype(
                    np.int64), sp.ids.numpy()[live])
            assert int(sp.next_id) == int(join_words(
                sp_ref["next_id"], sp_ref["next_id_hi"]))
        if sp_ref["next_free"] is not None:
            assert int(sp.next_free) == sp_ref["next_free"], i


def carried_steps(s0, s1, n_steps, options_kw=None, process_targets=(),
                  tolerances=None):
    """From fbpic_tpu's current state: n_steps single steps, each taken
    by both packages from the same (carried) state and compared;
    tolerances: {species index: the particle arrays' tolerance} where it
    is not 1e-12."""
    from fbpic_tpu.core.step import make_step_fn as m0
    from fbpic_tpu_torch.core.step import make_step_fn as m1
    from fbpic_tpu_torch.utils.carry import state_from_numpy
    options_kw = options_kw or {}
    step0 = jax.jit(m0(s0.config, tuple(s0.species_configs),
                       s0.build_options(**options_kw)))
    step1 = m1(s1.config, s1.species_configs, s1.build_options(**options_kw))
    seed = int(s0.state.seed)
    state0 = s0.state
    created = 0
    for _ in range(n_steps):
        carried = jax_state_to_numpy(state0)
        state1 = state_from_numpy(**carried, device="cpu",
                                  process_targets=process_targets)
        state0 = step0(state0, s0.aux, tuple(s0._injector_auxes),
                       tuple(s0._ionizer_auxes), (),
                       tuple(s0._compton_auxes))
        state1 = step1(state1, s1.aux, tuple(s1._injector_auxes),
                       jax_column_angles(seed), s1.generator,
                       ion_auxes=tuple(s1._ionizer_auxes),
                       comp_auxes=tuple(s1._compton_auxes),
                       draws=jax_process_draws(seed))
        ref = jax_state_to_numpy(state0)
        assert_states_match(ref, state1, tolerances=tolerances)
        created += sum(int((sp["w"] != 0).sum()) - int((c["w"] != 0).sum())
                       for sp, c in zip(ref["species"], carried["species"]))
    return state1, created


# ---------------------------------------------------------------------
# Host-side tables and the compaction
# ---------------------------------------------------------------------

def _elements():
    from fbpic_tpu_torch.particles.ionization import _ATOMIC_DATA_FILE
    out = []
    with open(_ATOMIC_DATA_FILE) as f:
        for line in f:
            parts = [p.strip() for p in line.split("|")]
            if (len(parts) >= 4 and parts[0].isdigit() and parts[1]
                    and parts[1].split()[0] not in out):
                out.append(parts[1].split()[0])
    return out


def test_ionization_energies_of_every_element():
    from fbpic_tpu.particles.ionization import get_ionization_energies as g0
    from fbpic_tpu_torch.particles.ionization import \
        get_ionization_energies as g1
    elements = _elements()
    assert len(elements) == 22 and "N" in elements and "Rn" in elements
    for el in elements:
        np.testing.assert_array_equal(g0(el), g1(el))
    assert g1("Unknownium") is None
    with open(os.path.join(os.path.dirname(__file__), "..", "fbpic_tpu_torch",
                           "particles", "atomic_data.txt")) as f:
        assert "NIST" in f.read(2000)


@pytest.mark.parametrize("element,level_max", [
    ("H", None), ("He", None), ("N", None), ("N", 6), ("Ar", None),
    ("Kr", None), ("Xe", None), ("Rn", None)])
def test_ionizer_aux_matches(element, level_max):
    from fbpic_tpu.particles.ionization import build_ionizer_aux as b0
    from fbpic_tpu_torch.particles.ionization import build_ionizer_aux as b1
    dt = 0.1e-6 / c
    a0, n0 = b0(element, dt, level_max)
    a1, n1 = b1(element, dt, level_max, device="cpu")
    assert n0 == n1
    for n in ("adk_log_prefactor", "adk_power", "adk_exp_prefactor"):
        close(np.asarray(getattr(a0, n)), getattr(a1, n).numpy(), n, 1e-12)
    with pytest.raises(ValueError):
        b1("Helium", dt, device="cpu")


@pytest.mark.parametrize("N,buffer_size,p_keep", [
    (1000, 64, 0.3),       # the selection overflows the buffer
    (1000, 2048, 0.3),     # a buffer longer than the arrays
    (1000, 128, 0.0),      # nothing selected
    (0, 16, 0.5)])         # no elements
def test_topk_compact_matches(N, buffer_size, p_keep):
    from fbpic_tpu.particles.compaction import topk_compact as t0
    from fbpic_tpu_torch.particles.compaction import topk_compact as t1
    rng = np.random.default_rng(N + buffer_size)
    mask = rng.random(N) < p_keep
    arrays = dict(x=rng.normal(size=N), level=rng.integers(0, 7, N,
                                                           dtype=np.int32))
    b0, n_sel0, n_taken0 = t0(jnp.asarray(mask), buffer_size,
                              {k: jnp.asarray(v) for k, v in arrays.items()})
    b1, n_sel1, n_taken1 = t1(torch.as_tensor(mask), buffer_size,
                              {k: torch.as_tensor(v)
                               for k, v in arrays.items()})
    assert int(n_sel0) == int(n_sel1) and int(n_taken0) == int(n_taken1)
    for k in arrays:
        assert b1[k].dtype == torch.as_tensor(arrays[k]).dtype
        np.testing.assert_array_equal(np.asarray(b0[k]), b1[k].numpy())


def _random_buffer(rng, B=512, n=300):
    buf = {n_: np.zeros(B) for n_ in PARTICLE}
    for n_ in PARTICLE:
        buf[n_][:n] = rng.normal(size=n)
    buf["w"][:n] = rng.random(n) + 0.1
    buf["level"] = np.zeros(B, np.int32)
    buf["level"][:n] = rng.integers(3, 7, n)
    return buf


def test_select_level_electrons_matches():
    from fbpic_tpu.particles.ionization import select_level_electrons as s0
    from fbpic_tpu_torch.particles.ionization import \
        select_level_electrons as s1
    buf = _random_buffer(np.random.default_rng(4))
    for level in range(3, 8):
        o0 = s0({k: jnp.asarray(v) for k, v in buf.items()}, level)
        o1 = s1({k: torch.as_tensor(v) for k, v in buf.items()}, level)
        assert sorted(o0) == sorted(o1)
        for k in o0:
            np.testing.assert_array_equal(np.asarray(o0[k]), o1[k].numpy())


def _random_ions(rng, N=4000):
    """Random ions of N from level 2 on (some dead, some at level 7, the
    last) and fields spanning the levels' thresholds."""
    d = dict(x=rng.normal(size=N) * 1e-6, y=rng.normal(size=N) * 1e-6,
             z=rng.random(N) * 1e-5, ux=rng.normal(size=N) * 0.3,
             uy=rng.normal(size=N) * 0.3, uz=rng.normal(size=N) * 2.)
    d["inv_gamma"] = 1 / np.sqrt(1 + d["ux"]**2 + d["uy"]**2 + d["uz"]**2)
    d["w"] = np.where(rng.random(N) < 0.9, rng.random(N) * 1e6, 0.)
    level = rng.integers(2, 8, N).astype(np.int32)
    E = [rng.normal(size=N) * 10 ** rng.uniform(9, 12.5, N)
         for _ in range(3)]
    B = [rng.normal(size=N) * 10 ** rng.uniform(1, 4, N) for _ in range(3)]
    E[0][:20] = 0.
    return d, level, E, B


@pytest.mark.parametrize("buffer_size", [8192, 256])
def test_ionize_random_particles_matches(buffer_size):
    from fbpic_tpu.particles import ionization as i0
    from fbpic_tpu.particles.state import ParticleState as P0
    from fbpic_tpu_torch.particles import ionization as i1
    from fbpic_tpu_torch.particles.state import ParticleState as P1
    d, level, E, B = _random_ions(np.random.default_rng(11))
    dt = 0.05e-6 / c
    cfg0 = i0.IonizerConfig(element="N", level_start=2, level_max=7,
                            target_index=1, buffer_size=buffer_size)
    cfg1 = i1.IonizerConfig(element="N", level_start=2, level_max=7,
                            target_index=1, buffer_size=buffer_size)
    aux0, _ = i0.build_ionizer_aux("N", dt)
    aux1, _ = i1.build_ionizer_aux("N", dt, device="cpu")
    key = jax.random.PRNGKey(7)
    sp0 = P0(**{k: jnp.asarray(v) for k, v in d.items()},
             ionization_level=jnp.asarray(level))
    sp0n, new0 = i0.ionize(sp0, [jnp.asarray(a) for a in E],
                           [jnp.asarray(a) for a in B], cfg0, aux0, key)
    draw = torch.as_tensor(np.array(jax.random.uniform(
        key, level.shape, jnp.float64)))
    sp1 = P1(**{k: torch.as_tensor(v) for k, v in d.items()},
             ionization_level=torch.as_tensor(level))
    level1, new1 = i1.ionize(sp1, [torch.as_tensor(a) for a in E],
                             [torch.as_tensor(a) for a in B], cfg1, aux1,
                             draw)
    np.testing.assert_array_equal(np.asarray(sp0n.ionization_level),
                                  level1.numpy())
    gained = int((level1.numpy() - level).sum())
    assert 50 < gained and (buffer_size > gained) == (buffer_size == 8192)
    assert sorted(new0) == sorted(new1)
    np.testing.assert_array_equal(np.asarray(new0["level"]),
                                  new1["level"].numpy())
    for k in PARTICLE:
        close(np.asarray(new0[k]), new1[k].numpy(), k, 1e-12)


# ---------------------------------------------------------------------
# Whole steps
# ---------------------------------------------------------------------

def _static_field_sims(resident, element="H", level_start=0, E0=3.2e10,
                       per_level=None):
    """tests/test_ionization.py's / tests/test_resident_processes.py's
    harness (atoms in a static Ex), in both packages; per_level: the
    levels to route to species of their own."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.external_fields import ExternalField as X0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.external_fields import ExternalField as X1
    Nz, Nr, Nm = 16, 8, 1
    zmax, rmax = 1.6e-6, 2.e-6
    dt = zmax / Nz / c
    K = 512 if resident else 0
    sims = []
    for S, X, kw in ((S0, X0, {}),
                     (S1, X1, dict(device="cpu", dtype=torch.float64))):
        sim = S(Nz, zmax, Nr, rmax, Nm, dt, random_seed=3, verbose_level=0,
                **kw)
        sim.use_fused_deposit = resident
        atoms = sim.add_new_species(
            q=e, m=m_p, n=1e20, p_nz=4, p_nr=4, p_nt=4, p_zmin=0,
            p_zmax=zmax, p_rmin=0, p_rmax=1.5e-6,
            continuous_injection=False, sort_K=K)
        if per_level:
            target = {lvl: sim.add_new_species(
                q=-e, m=m_e, capacity=16384, continuous_injection=False)
                for lvl in per_level}
        else:
            target = sim.add_new_species(
                q=-e, m=m_e, continuous_injection=False,
                capacity=None if resident else 65536, sort_K=K)
        atoms.make_ionizable(element, target, level_start=level_start,
                             level_max=(max(per_level) + 1 if per_level
                                        else None))
        if not per_level:
            target.track()
        sim.external_fields.append(X(
            lambda F, x, y, z, t, amplitude, length_scale: F + amplitude,
            "Ex", E0, 0.0, species=atoms))
        sims.append(sim)
    return sims


def _targets(sim):
    return tuple(i for i in range(len(sim.species_configs))
                 if sim.is_process_target(i))


def test_ring_ionizer_steps_match():
    """tests/test_ionization.py's static field: the atoms and the tracked
    electrons rings; 4 steps of fbpic_tpu, then 3 carried steps."""
    s0, s1 = _static_field_sims(resident=False)
    assert not any(sc.resident for sc in s1.species_configs)
    assert torch.is_tensor(s1.state.species[1].next_free)
    assert int(s1.state.species[1].next_id) == int(
        s0.state.species[1].next_id) == 65536 + 1
    s0.step(4, correct_currents=False, show_progress=False)
    state1, created = carried_steps(s0, s1, 3,
                                    dict(correct_currents=False),
                                    process_targets=_targets(s1))
    assert created > 100
    lev = state1.species[0].ionization_level
    assert int((state1.species[1].w != 0).sum()) == int(lev.sum())


def test_resident_ionizer_steps_match():
    """tests/test_resident_processes.py's resident harness: ionization
    in the resident block, the newborns' birth-step deposits, the
    row-aware append with ids; 5 steps of fbpic_tpu, then 3 carried
    steps (banded re-sorts)."""
    s0, s1 = _static_field_sims(resident=True)
    assert all(sc.resident for sc in s0.species_configs)
    assert all(sc.resident for sc in s1.species_configs)
    s0.step(5, correct_currents=False, show_progress=False)
    state1, created = carried_steps(s0, s1, 3,
                                    dict(correct_currents=False),
                                    process_targets=_targets(s1))
    assert created > 100


def test_per_level_routing_steps_match():
    """Nitrogen from N2+ in a static field strong enough to strip three
    levels, each level's electrons routed to its own species."""
    s0, s1 = _static_field_sims(resident=False, element="N", level_start=2,
                                E0=3.5e11, per_level=(2, 3, 4, 5))
    assert s1.species_configs[0].ionizer.per_level_targets == (1, 2, 3, 4)
    s0.step(6, correct_currents=False, show_progress=False)
    state1, created = carried_steps(s0, s1, 2,
                                    dict(correct_currents=False),
                                    process_targets=_targets(s1))
    n_per_level = [int((state1.species[i].w != 0).sum()) for i in (1, 2, 3)]
    assert min(n_per_level) > 0, n_per_level


def test_small_capacity_target_steps_match():
    """tests/test_ionization.py::test_small_capacity_target_receives_
    electrons: an empty target grows to one creation buffer, then the
    a0 = 2 laser strips N5+ (open z, rings); 40 steps of fbpic_tpu, then
    2 carried steps."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    Nz, Nr, Nm = 120, 24, 2
    zmax, zmin, rmax = 15.e-6, -5.e-6, 10.e-6
    dt = (zmax - zmin) / Nz / c
    sims = []
    for S, add, L, kw in ((S0, a0, L0, {}),
                          (S1, a1, L1, dict(device="cpu",
                                            dtype=torch.float64))):
        sim = S(Nz, zmax, Nr, rmax, Nm, dt, zmin=zmin,
                boundaries={"z": "open", "r": "reflective"}, random_seed=0,
                verbose_level=0, **kw)
        ion = sim.add_new_species(q=5 * e, m=14. * m_p, n=1.e23,
                                  p_zmin=2.e-6, p_zmax=12.e-6, p_rmax=8.e-6,
                                  p_nz=2, p_nr=2, p_nt=4)
        elec = sim.add_new_species(q=-e, m=m_e)
        assert sim.state.species[1].capacity == 256
        ion.make_ionizable("N", target_species=elec, level_start=5)
        add(sim, L(a0=2., waist=4.e-6, tau=10.e-15, z0=0.))
        sims.append(sim)
    s0, s1 = sims
    assert s1.state.species[1].capacity == s0.state.species[1].capacity \
        == 8192
    s0.step(40, show_progress=False)
    state1, created = carried_steps(s0, s1, 2,
                                    process_targets=_targets(s1))
    lev = state1.species[0].ionization_level
    live = state1.species[0].w != 0
    assert int((lev[live] - 5).sum()) == int((state1.species[1].w != 0).sum())
    assert int((state1.species[1].w != 0).sum()) > 20


def test_checkpoint_round_trip_of_ionization(tmp_path):
    """A resident ionizable species and its tracked resident target
    (the draws from sim.generator): checkpointed at 4 and continued to
    8, against a second simulation restarted from the file and stepped
    to 8 -- every tensor and cursor bit for bit."""
    from fbpic_tpu_torch.diagnostics.checkpoint_restart import (
        write_checkpoint, restart_from_checkpoint, checkpoint_path)
    runs = []
    for restart in (False, True):
        _, sim = _static_field_sims(resident=True)
        if restart:
            sim.step(1, correct_currents=False)    # advance the generator
            restart_from_checkpoint(sim, 4, str(tmp_path))
        else:
            sim.step(4, correct_currents=False)
            write_checkpoint(sim, checkpoint_path(4, str(tmp_path)))
        sim.step(4, correct_currents=False)
        runs.append(sim)
    a, b = runs
    assert a.iteration == b.iteration == 8
    for sp_a, sp_b in zip(a.state.species, b.state.species):
        for f in dataclasses.fields(sp_a):
            va, vb = getattr(sp_a, f.name), getattr(sp_b, f.name)
            if torch.is_tensor(va):
                assert torch.equal(va, vb), f.name
            else:
                assert va == vb, f.name
    assert torch.is_tensor(b.state.species[1].next_free)
    assert int((a.state.species[1].w != 0).sum()) > 0
    assert torch.equal(a.state.interp.Ez, b.state.interp.Ez)
