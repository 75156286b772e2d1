"""lwfa_boosted: FBPIC's documented boosted-frame LWFA script
(lwfa_boosted.json), built on an API namespace: fbpic_tpu_torch for the
system under test, the frozen plain reference
(perfbench/reference/plain_pic) for the comparison.

``api`` gives ``Simulation``, ``add_laser_pulse``, ``GaussianLaser``,
``BoostConverter`` and ``constants``; the builder imports neither
package itself."""
import math


def build(api, cfg, random_seed, devices, dtype):
    """The script's boosted-frame Simulation, plasma, laser and moving
    window (lab-frame values converted by gamma_boost), from the
    configuration's values (cfg) and the run's random_seed, on the
    first of ``devices`` (one card)."""
    c = api.constants.c
    gamma = cfg["gamma_boost"]
    boost = api.BoostConverter(gamma)
    zmin, zmax = boost.static_length([cfg["zmin_lab"], cfg["zmax_lab"]])
    dt = (zmax - zmin) / cfg["Nz"] / c
    n_e, = boost.static_density([cfg["n_e_lab"]])
    v_window, = boost.velocity([c])
    sim = api.Simulation(
        cfg["Nz"], zmax, cfg["Nr"], cfg["rmax"], cfg["Nm"], dt, zmin=zmin,
        n_order=cfg["n_order"], gamma_boost=gamma,
        v_comoving=-c * math.sqrt(1. - 1. / gamma**2),
        use_galilean=cfg["use_galilean"],
        boundaries=dict(cfg["boundaries"]), random_seed=random_seed,
        verbose_level=0, device=devices[0], dtype=dtype)
    sim.add_new_species(
        q=-api.constants.e, m=api.constants.m_e, n=n_e,
        p_zmin=cfg["p_zmin_lab"],
        p_zmax=boost.static_length([cfg["p_zmax_lab"]])[0],
        p_rmax=cfg["p_rmax"], p_nz=cfg["p_nz"], p_nr=cfg["p_nr"],
        p_nt=cfg["p_nt"],
        continuous_injection=cfg["continuous_injection"],
        boost_positions_in_dens_func=cfg["boost_positions_in_dens_func"])
    api.add_laser_pulse(sim, api.GaussianLaser(
        a0=cfg["a0"], waist=cfg["w0"], tau=cfg["tau"], z0=cfg["z0"]),
        gamma_boost=gamma)
    sim.set_moving_window(v=v_window)
    return sim
