"""lwfa_std: FBPIC's documented LWFA script (lwfa_std.json), built on an
API namespace: fbpic_tpu_torch for the system under test, the frozen
plain reference (perfbench/reference/plain_pic) for the comparison.

``api`` gives ``Simulation``, ``add_laser_pulse``, ``GaussianLaser``,
``BoostConverter`` and ``constants``; the builder imports neither
package itself."""


def build(api, cfg, random_seed, devices, dtype):
    """The script's Simulation, laser and moving window, from the
    configuration's values (cfg; its ``sort_K``, if it has one, the
    plasma's slots a column) and the run's random_seed, on the first of
    ``devices`` (one card)."""
    c = api.constants.c
    dt = (cfg["zmax"] - cfg["zmin"]) / cfg["Nz"] / c
    sim = api.Simulation(
        cfg["Nz"], cfg["zmax"], cfg["Nr"], cfg["rmax"], cfg["Nm"], dt,
        p_zmin=cfg["p_zmin"], p_zmax=cfg["p_zmax"], p_rmin=cfg["p_rmin"],
        p_rmax=cfg["p_rmax"], p_nz=cfg["p_nz"], p_nr=cfg["p_nr"],
        p_nt=cfg["p_nt"], n_e=cfg["n_e"], zmin=cfg["zmin"],
        n_order=cfg["n_order"], boundaries=dict(cfg["boundaries"]),
        random_seed=random_seed, verbose_level=0, device=devices[0],
        dtype=dtype, sort_K=cfg.get("sort_K"))
    api.add_laser_pulse(sim, api.GaussianLaser(
        a0=cfg["a0"], waist=cfg["w0"], tau=cfg["tau"], z0=cfg["z0"]))
    sim.set_moving_window(v=c)
    return sim
