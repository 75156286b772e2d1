"""fbpic_tpu_torch on the card: the CUDA kernels and a physics pin.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  This file imports no JAX, so it also runs on a machine that has
only PyTorch; there, skip the JAX-based conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- K1 and K2 against their plain PyTorch versions on the same card
  (K1 1e-5, K2 5e-6 relative: float32 sums in another order);
- the golden-wake configuration for 100 steps on the card against the
  same run on the CPU (plain kernel versions), float32 and float64;
- the wavelength and amplitude invariants of tests/test_golden_wake.py
  after 450 steps on the card.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_wake.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _sorted_particles(dev, dtype, seed, Nz=48, Nr=16, Nm=2, K=512):
    """Column-sorted particles from a numpy seed, a third near the axis."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.particles.sorted_deposit import build_column_sort
    dz, dr, zmin = 0.1, 0.2, -1.0
    sim = Simulation(Nz, zmin + Nz * dz, Nr, Nr * dr, Nm, 1e-12, zmin=zmin,
                     device=dev, dtype=dtype)
    rng = np.random.RandomState(seed)
    Np = int(0.5 * K * Nz)
    z = zmin + rng.uniform(0.0, Nz * dz, Np)
    r = np.where(rng.rand(Np) < 0.35, rng.uniform(0, 1.5 * dr, Np),
                 rng.uniform(0, 0.99 * Nr * dr, Np))
    th = rng.uniform(0, 2 * np.pi, Np)
    w = rng.uniform(0.5, 1.5, Np)
    w[rng.rand(Np) < 0.1] = 0.0
    ux, uy, uz = rng.randn(3, Np) * 0.5
    ig = 1 / np.sqrt(1 + ux ** 2 + uy ** 2 + uz ** 2)
    arrs = [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in (r * np.cos(th), r * np.sin(th), z, w, ux, uy, uz, ig)]
    sort = build_column_sort(arrs[2], arrs[3], zmin, 1 / dz, Nz, K, arrs)
    return sim, sort


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_kernel_matches_plain(cuda, dtype):
    from fbpic_tpu_torch.particles import cuda_fused
    from fbpic_tpu_torch.particles.sorted_deposit import (
        fused_contract_operands)
    sim, sort = _sorted_particles(cuda, dtype, seed=23)
    cfg = sim.config
    x, y, z, w, ux, uy, uz, ig = sort["padded"]
    ops = fused_contract_operands(
        sort, x, y, z, w, -1.6e-19, ux, uy, uz, ig, 0.25 * cfg.dz / 3e8,
        cfg.Nm, 1 / cfg.dz, sim.zmin, cfg.Nz, 1 / cfg.dr, 0.0, cfg.Nr,
        sim.aux.ruyten_linear, zfold="clamp", sort_at_start=True)
    n0 = cuda_fused.fused_onehot_contract.launches
    out = cuda_fused.fused_onehot_contract(**ops)
    ref = cuda_fused.fused_onehot_contract_plain(**ops)
    assert cuda_fused.fused_onehot_contract.launches == n0 + 1
    W_J = ops["n_offJ"] * 2 * ops["channels"].shape[2]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert _rel(out[..., :W_J], ref[..., :W_J]) <= tol
    assert _rel(out[..., W_J:], ref[..., W_J:]) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("zfold", ["periodic", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_kernel_matches_plain(cuda, zfold, dtype):
    from fbpic_tpu_torch.fields.solver import InterpFields
    from fbpic_tpu_torch.particles import cuda_gather
    from fbpic_tpu_torch.particles.gather import gather_operands
    sim, sort = _sorted_particles(cuda, dtype, seed=31)
    cfg = sim.config
    g = torch.Generator(device=cuda).manual_seed(5)
    shape = (cfg.Nm, cfg.Nz, cfg.Nr)
    interp = InterpFields(**{
        n: torch.complex(torch.randn(shape, generator=g, device=cuda,
                                     dtype=dtype),
                         torch.randn(shape, generator=g, device=cuda,
                                     dtype=dtype))
        for n in ("Er", "Et", "Ez", "Br", "Bt", "Bz")})
    ops = gather_operands(*sort["padded"][:3], sort["valid"], interp,
                          cfg.rmax, 1 / cfg.dz, sim.zmin, cfg.Nz, 1 / cfg.dr,
                          0.0, cfg.Nr, zfold=zfold)
    n0 = cuda_gather.gather_sorted.launches
    out = cuda_gather.gather_sorted(**ops)
    ref = cuda_gather.gather_sorted_plain(**ops)
    assert cuda_gather.gather_sorted.launches == n0 + 1
    tol = 5e-6 if dtype == torch.float32 else 1e-12
    for a, b in zip(out, ref):
        assert _rel(a, b) <= tol


@pytest.mark.cuda
def test_kernel_wrappers_check_their_operands(cuda):
    from fbpic_tpu_torch.particles import cuda_gather
    sim, sort = _sorted_particles(cuda, torch.float32, seed=3)
    ok = torch.ones(sort["valid"].shape, device=cuda)
    bad_Fg = torch.zeros((sim.config.Nz, 5, 24), device=cuda)
    with pytest.raises(ValueError):
        cuda_gather.gather_sorted(
            torch.zeros_like(ok, dtype=torch.int32),
            torch.zeros_like(ok, dtype=torch.int32), ok, ok, ok, ok, ok,
            bad_Fg[:, :, :12], 3, 2)


def _wake_wavelength(Ez_axis, dz):
    """tests/test_golden_wake.py:93-109."""
    E = np.asarray(Ez_axis, np.float64)
    amp = np.abs(E).max()
    flips = np.flatnonzero(np.sign(E[:-1]) * np.sign(E[1:]) < 0)
    keep = [i for i in flips
            if np.abs(E[max(0, i - 40):i + 1]).max() > 0.25 * amp]
    if len(keep) < 3:
        return None
    keep = np.asarray(keep)
    zc = keep + E[keep] / (E[keep] - E[keep + 1])
    return float(2.0 * np.diff(zc).mean() * dz)


class _SeededAngles:
    """Column angles from a numpy seed per (iteration, species): the
    same draws whichever device the run is on."""

    def __call__(self, iteration, species_index, nkey):
        rs = np.random.RandomState(1000 * iteration + species_index)
        return torch.as_tensor(2 * np.pi * rs.random_sample(
            tuple(nkey.shape)))


def _golden_config_sim(device, dtype):
    """tests/test_golden_wake.py:68-90 (a0 = 1 laser, open z, moving
    window, continuous injection) with the resident layout forced."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    Nz, Nr, Nm = 400, 24, 2
    zmax, zmin, rmax = 30.e-6, -10.e-6, 20.e-6
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, (zmax - zmin) / Nz / c,
                     p_zmin=24.e-6, p_zmax=500.e-6, p_rmin=0.,
                     p_rmax=14.e-6, p_nz=1, p_nr=1, p_nt=4, n_e=4.e24,
                     zmin=zmin, n_order=32,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, device=device, dtype=dtype,
                     sort_K=256)
    add_laser_pulse(sim, GaussianLaser(a0=1.0, waist=8.e-6, tau=10.e-15,
                                       z0=20.e-6))
    sim.set_moving_window(v=c)
    return sim


def _profiles(sim):
    return dict(
        Ez_axis=sim.get_interp_field("Ez", 0).real[:, 0],
        Er0_r5=sim.get_interp_field("Er", 0).real[:, 5],
        Er1_r5=np.abs(sim.get_interp_field("Er", 1))[:, 5],
        rho_axis=sim.get_interp_field("rho", 0).real[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_run_matches_cpu_run(cuda, dtype):
    """100 steps of the golden-wake configuration on the card (K2, and
    K1 in float32) and on the CPU (their plain versions), from the same
    plasma and the same injection angles.  float64: 1e-8 of each
    profile's scale (FFTs, GEMMs and sums in another order differ at
    ~1e-16 per operation; the PIC loop amplifies that over 100 steps).
    float32: the 100-step gates of tests/test_golden_wake.py:156-157
    (1.5e-2, 3e-2 for rho), as for the float32 port against fbpic_tpu."""
    from fbpic_tpu_torch.particles import cuda_fused, cuda_gather
    n_k1 = cuda_fused.fused_onehot_contract.launches
    n_k2 = cuda_gather.gather_sorted.launches
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        sim = _golden_config_sim(dev, dtype)
        sim.column_angles = _SeededAngles()
        sim.step(100)
        assert sim.overflow_totals == {"sort_overflow": 0,
                                       "ring_overwrite": 0}
        runs[dev.type] = _profiles(sim)
    assert cuda_gather.gather_sorted.launches - n_k2 == 100
    if dtype == torch.float32:
        assert cuda_fused.fused_onehot_contract.launches - n_k1 == 100
    gates = ({n: 1e-8 for n in runs["cpu"]} if dtype == torch.float64 else
             {"Ez_axis": 1.5e-2, "Er0_r5": 1.5e-2, "Er1_r5": 1.5e-2,
              "rho_axis": 3e-2})
    for name, gate in gates.items():
        card, ref = runs["cuda"][name], runs["cpu"][name]
        assert np.isfinite(card).all(), name
        err = np.abs(card - ref).max() / np.abs(ref).max()
        assert err < gate, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wake_invariants_on_card(cuda, dtype):
    """The invariants of tests/test_golden_wake.py after 450 steps on the
    card: the on-axis wake wavelength within 15% of 2 pi c / omega_p and
    within 2% of the golden run's, and the Ez amplitude within 10% of the
    golden run's.  The card draws its own injection angles (the golden
    profiles themselves need fbpic_tpu's angles: see
    tests/test_torch_golden.py); the macroscopic wake does not depend on
    them (on the CPU, another angle set gives 0.1-0.3% in wavelength and
    1-4% in amplitude)."""
    from fbpic_tpu_torch.constants import c, e, m_e
    sim = _golden_config_sim(cuda, dtype)
    sim.step(450)
    assert sim.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}
    gold = np.load(GOLDEN)
    Ez = _profiles(sim)["Ez_axis"]
    assert np.isfinite(Ez).all()
    lam = _wake_wavelength(Ez, sim.config.dz)
    wp = np.sqrt(4.e24 * e**2 / (m_e * 8.8541878128e-12))
    assert abs(lam / (2 * np.pi * c / wp) - 1) < 0.15
    assert abs(lam / float(gold["inv_wavelength"]) - 1) < 0.02
    amp = float(np.abs(Ez).max())
    assert 0.9 < amp / float(gold["inv_amplitude"]) < 1.1
