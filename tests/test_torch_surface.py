"""The rest of the Simulation surface: fbpic_tpu_torch against fbpic_tpu
(float64), at tests/test_torch_step.py's tolerances (particles 1e-12,
fields 1e-8 of the largest value of their vector; deposits and
``deposit_species_rho_J_full`` 1e-12).

- ``deposit('rho_prev' | 'rho_next' | 'J')`` and
  ``deposit_species_rho_J_full`` on a state with electrons and ions
  (``initialize_ions``), and ``deposit`` beside a tracer;
- ``reverse_time``, with and without the radial PML, then more steps;
- the step options ``correct_divE``, ``move_positions=False`` and
  ``move_momenta=False`` in turn on a drifting periodic plasma with ions
  and a tracer species (``add_new_species(is_tracer=True)``), and
  ``reuse_rho_prev=False`` on tests/test_torch_ring.py's window
  configuration with ions;
- who is resident: fbpic_tpu's ``_resident_indices`` and the port's on
  the same configs and options, and ``add_new_species``' rule (no
  tracer, no cubic shape);
- ``show_progress``: the banner, the bar's updates and its summary;
  ``catch_memory_error``: a CUDA out-of-memory error becomes a
  MemoryError with fbpic_tpu's advice, any other error passes through;
- the error paths.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from fbpic_tpu.constants import c, e, m_e  # noqa: E402


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _window_sims():
    """The window configuration with electrons and ions from the
    constructor (initialize_ions), in both packages, the port fed
    fbpic_tpu's injection angles."""
    from test_torch_ring import (NZ_PHYS, ZMAX, NR, RMAX, NM, DT, SIM_KW,
                                 SPECIES_KW, LASER_KW)
    from test_torch_step import jax_column_angles
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    plasma = {k: SPECIES_KW[k] for k in ("p_zmin", "p_zmax", "p_rmin",
                                         "p_rmax", "p_nz", "p_nr", "p_nt")}
    kw = dict(SIM_KW, n_e=SPECIES_KW["n"], initialize_ions=True, **plasma)
    s0 = S0(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, **kw)
    s1 = S1(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, device="cpu",
            dtype=torch.float64, **kw)
    for sim, add, L in ((s0, a0, L0), (s1, a1, L1)):
        add(sim, L(**LASER_KW))
        sim.set_moving_window(v=c)
        assert len(sim.species_configs) == 2
        assert sim.species_configs[1].q == e
        assert sim.species_configs[1].m == 1836.2 * m_e
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    return s0, s1


def _periodic_sims():
    """A drifting, density-modulated periodic plasma (tests/
    test_torch_step.py's periodic run) with ions (initialize_ions) and a
    tracer species, in both packages."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    Nz, Nr, Nm = 48, 16, 2
    Lz, rmax = 20.e-6, 15.e-6
    kw = dict(zmin=0., boundaries={"z": "periodic", "r": "reflective"},
              random_seed=0, verbose_level=0, n_e=1.e24, p_nz=2, p_nr=2,
              p_nt=4, p_zmin=0., p_zmax=Lz, p_rmax=12.e-6,
              initialize_ions=True,
              dens_func=lambda z, r: 1. + 0.05 * np.sin(2 * np.pi * z / Lz))
    s0 = S0(Nz, Lz, Nr, rmax, Nm, Lz / Nz / c, **kw)
    s1 = S1(Nz, Lz, Nr, rmax, Nm, Lz / Nz / c, device="cpu",
            dtype=torch.float64, **kw)
    for sim in (s0, s1):
        sim.add_new_species(q=-e, m=m_e, n=1.e23, p_nz=1, p_nr=1, p_nt=4,
                            p_zmin=0., p_zmax=Lz, p_rmax=4.e-6, uz_m=0.5,
                            is_tracer=True)
        sim.ptcl[0].uz = 0.05 * np.sin(2 * np.pi * sim.ptcl[0].z / Lz)
    return s0, s1


def _gate(s0, s1):
    from test_torch_pml import compare_fields
    from test_torch_ring import compare_states
    from test_torch_step import jax_state_to_numpy
    compare_states(jax_state_to_numpy(s0.state), s1.state)
    compare_fields(s0.state, s1.state, 1e-8)


def _close(ref, out, tol, what):
    ref = ref.to_numpy() if hasattr(ref, "to_numpy") else np.asarray(ref)
    out = out.numpy() if hasattr(out, "numpy") else np.asarray(out)
    scale = np.abs(ref).max()
    assert scale > 0, what
    assert np.abs(out - ref).max() <= tol * scale, what


def test_step_options_match():
    """correct_divE, move_positions=False and move_momenta=False, each
    for one step() call of 3 cycles, in turn, on the same pair of
    periodic simulations; the whole state gated after each call."""
    s0, s1 = _periodic_sims()
    for opts in (dict(correct_divE=True), dict(move_positions=False),
                 dict(move_momenta=False)):
        s0.step(3, show_progress=False, **opts)
        s1.step(3, **opts)
        _gate(s0, s1)
    # the tracer deposits nothing: the charge is the electrons' and ions'
    # alone, in both packages alike
    for sim in (s0, s1):
        sim.deposit("rho_prev")
    _close(s0.state.spect.rho_prev, s1.state.spect.rho_prev, 1e-12,
           "rho with a tracer")


def test_deposit_methods_match():
    """On the window configuration after two cycles without
    reuse_rho_prev (the second, not an exchange step of its period 4,
    runs the exchange block), gated first."""
    s0, s1 = _window_sims()
    s0.step(2, show_progress=False, reuse_rho_prev=False)
    s1.step(2, reuse_rho_prev=False)
    _gate(s0, s1)
    for fieldtype in ("rho_prev", "rho_next", "J"):
        s0.deposit(fieldtype)
        s1.deposit(fieldtype)
        for n in (("Jp", "Jm", "Jz") if fieldtype == "J" else (fieldtype,)):
            _close(getattr(s0.state.spect, n), getattr(s1.state.spect, n),
                   1e-12, f"deposit({fieldtype!r}): {n}")
    for i in (0, 1):
        out0 = s0.deposit_species_rho_J_full(s0.ptcl[i])
        out1 = s1.deposit_species_rho_J_full(s1.ptcl[i])
        for a, b in zip(out0, out1):
            assert a.shape == b.shape == (s1.config.Nm, s1.config.Nz,
                                          s1.config.Nr)
            _close(a, b, 1e-12, f"deposit_species_rho_J_full {i}")
    for sim in (s0, s1):
        with pytest.raises(ValueError):
            sim.deposit("E")


@pytest.mark.parametrize("pml", [False, True])
def test_reverse_time_matches(pml):
    from test_torch_pml import (NZ, NR, NM, ZMAX, RMAX, DT, SIM_KW,
                                LASER_KW)
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    kw = dict(SIM_KW, p_zmin=0., p_zmax=ZMAX, p_rmax=3.e-6, p_nz=1,
              p_nr=1, p_nt=4, n_e=1.e23)
    if not pml:
        kw.update(boundaries={"z": "periodic", "r": "reflective"})
    s0 = S0(NZ, ZMAX, NR, RMAX, NM, DT, **kw)
    s1 = S1(NZ, ZMAX, NR, RMAX, NM, DT, device="cpu", dtype=torch.float64,
            **kw)
    a0(s0, L0(**LASER_KW))
    a1(s1, L1(**LASER_KW))
    s0.step(4, show_progress=False)
    s1.step(4)
    b_before = s1.state.interp.Bt.clone()
    s0.reverse_time()
    s1.reverse_time()
    assert torch.equal(s1.state.interp.Bt, -b_before)
    assert (s1.state.spect.Bp_pml is not None) == pml
    _gate(s0, s1)
    s0.step(3, show_progress=False)
    s1.step(3)
    _gate(s0, s1)


def test_resident_rule_matches():
    """Which species run resident: fbpic_tpu's _resident_indices and the
    port's on the same grid configs, species configs and options."""
    import dataclasses
    from fbpic_tpu.core.step import (_resident_indices as r0,
                                     StepOptions as O0)
    from fbpic_tpu.fields.solver import GridConfig
    from fbpic_tpu.particles.state import SpeciesConfig
    from fbpic_tpu_torch.core.step import (_resident_indices as r1,
                                           StepOptions as O1)
    from fbpic_tpu_torch.utils.carry import config_from, \
        species_configs_from
    base = SpeciesConfig(q=-e, m=m_e, sort_K=256, resident=True)
    scs = [base, dataclasses.replace(base, is_tracer=True),
           dataclasses.replace(base, particle_shape="cubic"),
           dataclasses.replace(base, sort_K=0),
           dataclasses.replace(base, resident=False)]
    for corr in ("curl-free", "cross-deposition"):
        cfg = GridConfig(Nz=8, Nr=8, Nm=2, dz=1., dr=1., rmax=8., dt=1.,
                         current_correction=corr)
        for kw in (dict(), dict(move_positions=False),
                   dict(move_momenta=False), dict(correct_currents=False),
                   dict(fused_deposit=False)):
            kw0 = dict(dict(fused_deposit=True), **kw)
            want = sorted(r0(cfg, tuple(scs), O0(**kw0), None))
            got = r1(config_from(cfg), species_configs_from(scs),
                     O1(**kw0))
            assert got == want, (corr, kw)


def test_add_new_species_resident_rule():
    """A tracer or a cubic species is never sized resident, in both
    packages (use_fused_deposit on, sort_K given)."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    kw = dict(zmin=0., random_seed=0, verbose_level=0)
    sp = dict(q=-e, m=m_e, n=1.e24, p_zmin=0., p_zmax=8.e-6, p_rmax=4.e-6,
              p_nz=1, p_nr=1, p_nt=4, sort_K=256)
    for shape, tracer, resident in (("linear", False, True),
                                    ("linear", True, False),
                                    ("cubic", False, False)):
        sims = (S0(16, 8.e-6, 8, 8.e-6, 2, 1.e-15, particle_shape=shape,
                   **kw),
                S1(16, 8.e-6, 8, 8.e-6, 2, 1.e-15, particle_shape=shape,
                   device="cpu", dtype=torch.float64, **kw))
        for sim in sims:
            sim.use_fused_deposit = True
            sim.add_new_species(is_tracer=tracer, **sp)
            sc = sim.species_configs[0]
            assert (sc.resident, sc.is_tracer) == (resident, tracer), shape
        assert sims[0].state.species[0].capacity == \
            sims[1].state.species[0].capacity


def test_show_progress_and_banner(capsys):
    from fbpic_tpu_torch import Simulation
    sim = Simulation(32, 8.e-6, 8, 8.e-6, 2, 8.e-6 / 32 / c, zmin=0.,
                     boundaries={"z": "periodic", "r": "reflective"},
                     device="cpu", dtype=torch.float64)
    sim.step(70, show_progress=True)
    out = capsys.readouterr().out
    assert out.startswith("fbpic_tpu_torch ")
    assert "Boundaries: z=periodic, r=reflective" in out
    # every ceil(70 / 35) = 2 steps
    assert out.count("\r") == 35
    assert "70/70" in out and "ms/step" in out
    assert "Total duration" in out
    sim.step(3)
    assert capsys.readouterr().out == ""       # banner once, no bar


def test_catch_memory_error():
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.utils.device import catch_memory_error

    def oom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.00 GiB")

    with pytest.raises(MemoryError) as info:
        catch_memory_error(oom)()
    assert "ran out of memory" in str(info.value)
    assert "Tried to allocate 2.00 GiB" in str(info.value)
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)

    def other():
        raise ValueError("not a memory error")

    with pytest.raises(ValueError, match="not a memory error"):
        catch_memory_error(other)()
    assert catch_memory_error(lambda x: 2 * x)(3) == 6

    sim = Simulation(16, 8.e-6, 8, 8.e-6, 2, 1.e-15, zmin=0., device="cpu",
                     dtype=torch.float64, verbose_level=0)

    def step_oom(*args, **kwargs):
        oom()

    sim._step_impl = step_oom
    with pytest.raises(MemoryError):
        sim.step(1)


def test_error_paths():
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    kw = dict(zmin=0., verbose_level=0)
    pml = dict(boundaries={"z": "periodic", "r": "open"})
    # the 32 PML cells lie inside Nr: a narrower grid cannot hold them
    with pytest.raises(ValueError):
        S0(16, 8.e-6, 16, 8.e-6, 2, 1.e-15, **pml, **kw)
    with pytest.raises(ValueError):
        S1(16, 8.e-6, 16, 8.e-6, 2, 1.e-15, device="cpu", **pml, **kw)
    s1 = S1(16, 8.e-6, 8, 8.e-6, 2, 1.e-15, device="cpu", **kw)
    with pytest.raises(ValueError, match="Er_pml"):
        s1.get_interp_field("Er_pml")         # no PML in this simulation
    s1 = S1(16, 8.e-6, 40, 8.e-6, 2, 1.e-15, device="cpu", **pml, **kw)
    assert s1.get_interp_field("Et_pml").shape == (2, 16, 40)
    for S, extra in ((S0, {}), (S1, dict(device="cpu"))):
        sim = S(16, 8.e-6, 8, 8.e-6, 2, 1.e-15,
                current_correction="bogus", **extra, **kw)
        with pytest.raises(ValueError):
            sim.step(1, **({} if S is S1 else dict(show_progress=False)))
