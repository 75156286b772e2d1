"""Compton scattering of fbpic_tpu_torch against fbpic_tpu (float64, CPU).

fbpic_tpu's random draws are fed to the port (tests/test_torch_ionization.py's
``jax_process_draws``), so both packages scatter the same electrons into
the same photons:

- ``build_compton_aux`` (lab and boosted frame), ``scattering_probability``
  and the Klein-Nishina angle sampler on random inputs, to 1e-12;
- ``handle_compton`` on random electrons (one photon per scattering, 25,
  and a photon buffer too small for them): the photon buffer and the
  recoiled momenta to 1e-12 (the momenta and x, y of their vector's
  scale), the photon count exactly;
- whole steps from a carried fbpic_tpu state: tests/test_compton.py's
  photon bath, its electrons a thermal beam of gamma ~ 3 (BATH_BEAM says
  why), with a ring source (ratio 25) and with a resident source, the
  photons a ring (q = 0, m = 0).  Particle arrays to 1e-12 on the live
  slots (the photons to 1e-9: PHOTON_TOL says why), cursors and
  counters exactly, fields to 1e-8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c, e, m_e  # noqa: E402
from test_torch_ionization import (  # noqa: E402
    VECTORS, close, carried_steps)

BATH = dict(laser_wavelength=0.8e-6, laser_waist=1.0e-3, laser_ctau=1.0e-2,
            laser_initial_z0=0.0)
# Electrons at rest make the rest-frame direction of the incoming photon
# ill-conditioned (cos(theta) ~ -1, sin(theta) = sqrt(1 - cos^2)): one
# ulp of the boost moves the recoil by ~5e-11 of the momentum.  The
# whole-step parity runs a thermal beam of gamma ~ 3 instead; the
# rest-frame physics of tests/test_compton.py runs on the card
# (chip_smoke.py's process gates).
BATH_BEAM = dict(uz_m=3., ux_th=0.05, uy_th=0.05, uz_th=0.05)
# The newborn photons: the Klein-Nishina sampler (b ~ 1/k) and the boost
# back to the lab (~4 gamma^2) amplify the last bits of the exp / log /
# pow the compiler picks.  fbpic_tpu's own step, jitted and run op by
# op from one state, disagrees by up to 4e-12 of the photons' momentum
# on this beam and 5e-10 at gamma = 100; the port against the jitted
# step by up to 1.6e-11 here.  Everything else is held to 1e-12.
PHOTON_TOL = 1e-9



@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("gamma_boost", [None, 10.])
def test_compton_aux_matches(gamma_boost):
    from fbpic_tpu.lpa_utils.boosted_frame import BoostConverter as B0
    from fbpic_tpu.particles.compton import build_compton_aux as b0
    from fbpic_tpu_torch.lpa_utils.boosted_frame import BoostConverter as B1
    from fbpic_tpu_torch.particles.compton import build_compton_aux as b1
    args = (2.e-3, 0.8e-6, 10.e-6, 10.e-6, -20.e-6)
    a0 = b0(*args, boost=None if gamma_boost is None else B0(gamma_boost))
    a1 = b1(*args, boost=None if gamma_boost is None else B1(gamma_boost),
            device="cpu")
    for n in ("photon_n_lab_peak", "photon_p", "photon_beta_z", "inv_waist2",
              "inv_ctau2", "z0", "gamma_boost", "beta_boost"):
        close(np.asarray(getattr(a0, n)), getattr(a1, n).numpy(), n, 1e-12)


def _random_electrons(rng, N=3000, uz0=100.):
    d = dict(x=rng.normal(size=N) * 5e-6, y=rng.normal(size=N) * 5e-6,
             z=rng.normal(size=N) * 5e-6, ux=rng.normal(size=N),
             uy=rng.normal(size=N), uz=uz0 + rng.normal(size=N) * 5.)
    d["ux"][:10] = d["uy"][:10] = d["uz"][:10] = 0.     # at rest
    d["inv_gamma"] = 1 / np.sqrt(1 + d["ux"]**2 + d["uy"]**2 + d["uz"]**2)
    d["w"] = np.where(rng.random(N) < 0.9, rng.random(N) * 1e5 + 1., 0.)
    return d


def _states(d):
    from fbpic_tpu.particles.state import ParticleState as P0
    from fbpic_tpu_torch.particles.state import ParticleState as P1
    return (P0(**{k: jnp.asarray(v) for k, v in d.items()}),
            P1(**{k: torch.as_tensor(v) for k, v in d.items()}))


def _auxes(laser_energy):
    from fbpic_tpu.particles.compton import build_compton_aux as b0
    from fbpic_tpu_torch.particles.compton import build_compton_aux as b1
    args = (laser_energy, 0.8e-6, 5.e-6, 5.e-6, 0.)
    return b0(*args), b1(*args, device="cpu")


def test_scattering_probability_matches():
    from fbpic_tpu.particles.compton import scattering_probability as p0
    from fbpic_tpu_torch.particles.compton import \
        scattering_probability as p1
    sp0, sp1 = _states(_random_electrons(np.random.default_rng(2)))
    a0, a1 = _auxes(1.)
    dt, t = 1.e-16, 3.e-15
    close(np.asarray(p0(sp0, a0, dt, t)), p1(sp1, a1, dt, t).numpy(), "p",
          1e-12)


def test_klein_nishina_sampler_matches():
    from fbpic_tpu.particles.compton import _sample_kn_angle as k0, N_REJECT
    from fbpic_tpu_torch.particles.compton import _sample_kn_angle as k1
    B = 4096
    k = 10 ** np.random.default_rng(3).uniform(-6, 2, B)
    key = jax.random.PRNGKey(5)
    x0 = k0(jnp.asarray(k), key, jnp.float64)
    ka, kb = jax.random.split(key)
    r1, r2 = (torch.as_tensor(np.array(jax.random.uniform(
        kk, (B, N_REJECT), jnp.float64))) for kk in (ka, kb))
    close(np.asarray(x0), k1(torch.as_tensor(k), r1, r2).numpy(), "cos",
          1e-12)


@pytest.mark.parametrize("ratio,buffer_size,laser_energy", [
    (1., 8192, 2.e2), (25., 8192, 8.), (25., 512, 8.)])
def test_handle_compton_random_electrons_matches(ratio, buffer_size,
                                                 laser_energy):
    from fbpic_tpu.particles import compton as c0
    from fbpic_tpu_torch.particles import compton as c1
    sp0, sp1 = _states(_random_electrons(np.random.default_rng(9)))
    a0, a1 = _auxes(laser_energy)
    cfg0 = c0.ComptonConfig(target_index=1, ratio_w_electron_photon=ratio,
                            buffer_size=buffer_size)
    cfg1 = c1.ComptonConfig(target_index=1, ratio_w_electron_photon=ratio,
                            buffer_size=buffer_size)
    dt, t = 1.e-16, 0.
    key = jax.random.PRNGKey(13)
    sp0n, ph0 = c0.handle_compton(sp0, cfg0, a0, dt, t, key)
    k_draw, k_rej, k_phi, k_rec = jax.random.split(key, 4)
    k_1, k_2 = jax.random.split(k_rej)
    keys = dict(compton_u=k_draw, compton_r1=k_1, compton_r2=k_2,
                compton_recoil=k_rec)

    def draw(name, shape):
        if name == "compton_phi":
            u = jax.random.uniform(k_phi, shape, jnp.float64, 0., 2 * np.pi)
        else:
            u = jax.random.uniform(keys[name], shape, jnp.float64)
        return torch.as_tensor(np.array(u))
    u1, ph1 = c1.handle_compton(sp1, cfg1, a1, dt, t, draw)
    n_ph = int((np.asarray(ph0["w"]) != 0).sum())
    assert n_ph == int((ph1["w"] != 0).sum()) > 100
    assert (n_ph == buffer_size) == (buffer_size == 512)
    u0 = [np.asarray(getattr(sp0n, n)) for n in ("ux", "uy", "uz")]
    for n, a, b in zip(("ux", "uy", "uz"), u0, u1):
        close(a, b.numpy(), n, 1e-12, max(np.abs(u).max() for u in u0))
    close(np.asarray(sp0n.inv_gamma), u1[3].numpy(), "inv_gamma", 1e-12)
    for group in VECTORS:
        scale = max(np.abs(np.asarray(ph0[n])).max() for n in group)
        for n in group:
            close(np.asarray(ph0[n]), ph1[n].numpy(), "photon " + n, 1e-12,
                  scale)

def _bath_sims(resident, ratio=1., laser_energy=4.0e6):
    """tests/test_compton.py's photon bath (a pulse much longer and wider
    than the box), its electrons a thermal beam (BATH_BEAM), in both
    packages."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    Nz, Nr, Nm = 16, 8, 1
    zmax, rmax = 1.6e-6, 2.e-6
    dt = zmax / Nz / c
    sims = []
    for S, kw in ((S0, {}), (S1, dict(device="cpu", dtype=torch.float64))):
        sim = S(Nz, zmax, Nr, rmax, Nm, dt, random_seed=7, verbose_level=0,
                **kw)
        sim.use_fused_deposit = resident
        elec = sim.add_new_species(
            q=-e, m=m_e, n=1e20, p_nz=4, p_nr=4, p_nt=4, p_zmin=0,
            p_zmax=zmax, p_rmin=0, p_rmax=1.5e-6, continuous_injection=False,
            sort_K=512 if resident else 0, **BATH_BEAM)
        photons = sim.add_new_species(q=0., m=0., capacity=131072,
                                      continuous_injection=False)
        elec.activate_compton(photons, laser_energy=laser_energy,
                              ratio_w_electron_photon=ratio, **BATH)
        sims.append(sim)
    assert sims[1].species_configs[0].resident == resident
    return sims


def test_ring_compton_source_steps_match():
    """Ratio 25 (25 photon macroparticles per scattering, recoil with
    probability 1/25): 4 steps of fbpic_tpu, then 3 carried steps."""
    s0, s1 = _bath_sims(resident=False, ratio=25., laser_energy=2.0e5)
    s0.step(4, correct_currents=False, show_progress=False)
    state1, created = carried_steps(s0, s1, 3, dict(correct_currents=False),
                                    process_targets=(1,),
                                    tolerances={1: PHOTON_TOL})
    assert created > 100
    assert torch.is_tensor(state1.species[1].next_free)


def test_resident_compton_source_steps_match():
    """The electrons resident (Compton inside the resident block, before
    the fused deposit), the photons a ring: 4 steps of fbpic_tpu, then 3
    carried steps (banded re-sorts)."""
    s0, s1 = _bath_sims(resident=True)
    s0.step(4, correct_currents=False, show_progress=False)
    state1, created = carried_steps(s0, s1, 3, dict(correct_currents=False),
                                    process_targets=(1,),
                                    tolerances={1: PHOTON_TOL})
    assert created > 100
