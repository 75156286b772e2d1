"""The radial PML: fbpic_tpu_torch against fbpic_tpu (float64).

- Module by module on numpy-seeded complex fields: the split-field
  pushes ``push_eb_pml_standard`` / ``push_eb_pml_comoving`` (with each
  package's own PSATD coefficients of the same grid, Galilean for the
  comoving one), the damping profile ``damp_r_pml`` and the step's
  ``damp_pml_r``: 1e-12 of each output's largest value.
- tests/test_pml.py's configuration (a tightly focused laser diffracting
  into the radial boundary, r 'open', 16 PML cells inside Nr, periodic
  z, no current correction) for 40 steps in both packages, then
  fbpic_tpu's state carried into the port (``utils.carry``: the ``_pml``
  fields too) and 5 more steps each: every field, the ``_pml`` ones
  included, to 1e-8 of the largest value of its vector (E: the three
  components and the split ones; rho: the four charge grids;
  tests/test_torch_step.py's field tolerance -- no particles here, so
  the agreement is far closer).
- Its ``FieldDiagnostic`` with the ``_pml`` records, object by object
  against fbpic_tpu's writer (tests/test_torch_diagnostics.py's
  comparison).  fbpic_tpu's ``get_interp_field`` rejects the ``_pml``
  names, so its writer is fed its own state's ``_pml`` fields through
  ``get_dataset``.
- A checkpoint of the PML run restores the ``_pml`` fields bit for bit
  within the port.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c  # noqa: E402

NZ, NR, NM = 180, 32, 2
ZMAX, RMAX = 18.e-6, 8.e-6
DT = ZMAX / NZ / c
SIM_KW = dict(n_order=16, boundaries={"z": "periodic", "r": "open"},
              n_damp={"z": 0, "r": 16}, random_seed=0, verbose_level=0)
LASER_KW = dict(a0=0.01, waist=2.0e-6, tau=6.e-15, z0=9.e-6)
PML_INTERP = ("Er_pml", "Et_pml", "Br_pml", "Bt_pml")
PML_SPECT = ("Ep_pml", "Em_pml", "Bp_pml", "Bm_pml")
INTERP_VECTORS = (("Er", "Et", "Ez", "Er_pml", "Et_pml"),
                  ("Br", "Bt", "Bz", "Br_pml", "Bt_pml"))
SPECT_VECTORS = (("Ep", "Em", "Ez", "Ep_pml", "Em_pml"),
                 ("Bp", "Bm", "Bz", "Bp_pml", "Bm_pml"),
                 ("Jp", "Jm", "Jz"),
                 ("rho_prev", "rho_next", "rho_next_xy", "rho_next_z"))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_fields(state):
    """Every field fbpic_tpu's state holds (optional ones where not
    None) as complex numpy: ({spect name: array}, {interp name: array})."""
    import dataclasses
    out = []
    for group in (state.spect, state.interp):
        out.append({f.name: getattr(group, f.name).to_numpy()
                    for f in dataclasses.fields(group)
                    if getattr(group, f.name) is not None})
    return tuple(out)


def compare_fields(state0, state1, tol):
    """Every field of fbpic_tpu's state against the port's, to tol of
    the largest value of its vector (those of its *_VECTORS entry that
    the state holds); the port must hold exactly the fields fbpic_tpu
    holds."""
    from fbpic_tpu_torch.fields.solver import present_fields
    spect0, interp0 = jax_fields(state0)
    for ref, obj, vectors in ((spect0, state1.spect, SPECT_VECTORS),
                              (interp0, state1.interp, INTERP_VECTORS)):
        assert sorted(ref) == sorted(present_fields(obj))
        for name in ref:
            vec = next(v for v in vectors if name in v)
            scale = max(np.abs(ref[n]).max() for n in vec if n in ref)
            err = np.abs(getattr(obj, name).numpy() - ref[name]).max()
            assert err <= tol * max(scale, 1e-300), (name, err / scale)


def _rand_fields(rng, n, shape=(NM, 12, 10)):
    return [rng.randn(*shape) + 1j * rng.randn(*shape) for _ in range(n)]


@pytest.mark.parametrize("scheme", ["standard", "galilean"])
def test_pml_push_and_damping_match(scheme):
    from fbpic_tpu.fields import psatd_push as p0
    from fbpic_tpu.fields.solver import (GridConfig as G0,
                                         build_field_aux as b0)
    from fbpic_tpu.core.step import damp_pml_r as d0
    from fbpic_tpu.fields.solver import InterpFields as I0
    from fbpic_tpu.utils.complex_arr import CArr
    from fbpic_tpu_torch.fields import psatd_push as p1
    from fbpic_tpu_torch.fields.solver import build_field_aux as b1
    from fbpic_tpu_torch.core.step import damp_pml_r as d1
    from fbpic_tpu_torch.fields.solver import InterpFields as I1
    from fbpic_tpu_torch.utils.carry import config_from
    Nz, Nr = 12, 10
    kw = dict(Nz=Nz, Nr=Nr, Nm=NM, dz=0.1e-6, dr=0.2e-6, rmax=Nr * 0.2e-6,
              dt=0.1e-6 / c, n_order=8, use_pml=True, nr_damp=4)
    if scheme == "galilean":
        kw.update(v_comoving=-0.9 * c, use_galilean=True)
    cfg0 = G0(**kw)
    aux0 = b0(cfg0)
    aux1 = b1(config_from(cfg0), device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(aux1.damp_r_pml.numpy(),
                               np.asarray(aux0.damp_r_pml), rtol=1e-15)
    rng = np.random.RandomState(1)
    Ep, Em, Bp, Bm, Ez, Bz = _rand_fields(rng, 6, (NM, Nz, Nr))

    def J(a):
        return CArr.from_numpy(a, jnp.float64)

    def T(a):
        return torch.as_tensor(a)

    def coef(aux, name):
        v = getattr(aux, name)
        return v.to_numpy() if hasattr(v, "to_numpy") else np.asarray(v)

    if scheme == "standard":
        out0 = p0.push_eb_pml_standard(*map(J, (Ep, Em, Bp, Bm, Ez, Bz)),
                                       aux0.C, aux0.S_w, aux0.kr, aux0.kz)
        out1 = p1.push_eb_pml_standard(*map(T, (Ep, Em, Bp, Bm, Ez, Bz)),
                                       aux1.C, aux1.S_w, aux1.kr, aux1.kz)
    else:
        out0 = p0.push_eb_pml_comoving(*map(J, (Ep, Em, Bp, Bm, Ez, Bz)),
                                       aux0.C, aux0.S_w, aux0.T_eb, aux0.kr,
                                       aux0.kz)
        out1 = p1.push_eb_pml_comoving(*map(T, (Ep, Em, Bp, Bm, Ez, Bz)),
                                       aux1.C, aux1.S_w, aux1.T_eb, aux1.kr,
                                       aux1.kz)
        np.testing.assert_allclose(aux1.T_eb.numpy(), coef(aux0, "T_eb"),
                                   rtol=1e-13, atol=0)
    for a, b in zip(out0, out1):
        ref = a.to_numpy()
        assert np.abs(b.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()

    names = ("Er", "Et", "Ez", "Br", "Bt", "Bz") + PML_INTERP
    vals = dict(zip(names, _rand_fields(rng, len(names), (NM, Nz, Nr))))
    i0 = d0(aux0, I0(**{n: J(v) for n, v in vals.items()}))
    i1 = d1(aux1, I1(**{n: T(v) for n, v in vals.items()}))
    for n in names:
        ref = getattr(i0, n).to_numpy()
        assert np.abs(getattr(i1, n).numpy() - ref).max() \
            <= 1e-12 * np.abs(ref).max(), n


def _pml_sims(diag_dirs=None):
    """tests/test_pml.py's PML run in both packages."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    s0 = S0(NZ, ZMAX, NR, RMAX, NM, DT, **SIM_KW)
    s1 = S1(NZ, ZMAX, NR, RMAX, NM, DT, device="cpu", dtype=torch.float64,
            **SIM_KW)
    a0(s0, L0(**LASER_KW))
    a1(s1, L1(**LASER_KW))
    for sim in (s0, s1):
        assert sim.config.use_pml and sim.config.nr_damp == 16
        assert sim.get_rmax_gather() == RMAX - 16 * RMAX / NR
    if diag_dirs is not None:
        _attach_pml_diags(s0, s1, diag_dirs)
    return s0, s1


def _attach_pml_diags(s0, s1, dirs):
    import fbpic_tpu.diagnostics as D0
    import fbpic_tpu_torch.diagnostics as D1
    fieldtypes = ["E", "B"] + list(PML_INTERP)

    class JaxPmlDiagnostic(D0.FieldDiagnostic):
        """fbpic_tpu's writer, given its state's _pml fields (its
        get_interp_field rejects the names)."""
        def get_dataset(self, sim, quantity):
            if quantity.endswith("_pml"):
                arr = getattr(sim.state.interp, quantity).to_numpy()
                return arr[:, sim.nd_edge:sim.nd_edge + sim.Nz_phys, :]
            return D0.FieldDiagnostic.get_dataset(self, sim, quantity)

    s0.diags = [JaxPmlDiagnostic(20, s0, fieldtypes=fieldtypes,
                                 write_dir=dirs[0])]
    s1.diags = [D1.FieldDiagnostic(20, s1, fieldtypes=fieldtypes,
                                   write_dir=dirs[1])]


def test_pml_run_matches_fbpic_tpu(tmp_path):
    from fbpic_tpu_torch.utils.carry import state_from_numpy
    h5py = pytest.importorskip("h5py")
    from test_torch_diagnostics import compare_h5
    dirs = [str(tmp_path / "jax"), str(tmp_path / "torch")]
    s0, s1 = _pml_sims(dirs)
    s0.step(40, correct_currents=False, show_progress=False)
    s1.step(40, correct_currents=False)
    compare_fields(s0.state, s1.state, 1e-8)
    # The split fields carry the laser's diffraction into the PML
    assert np.abs(s1.state.interp.Et_pml.numpy()).max() > 0
    files = sorted(os.listdir(os.path.join(dirs[0], "hdf5")))
    assert files == ["data%08d.h5" % i for i in (0, 20, 40)]
    for name in files:
        compare_h5(os.path.join(dirs[0], "hdf5", name),
                   os.path.join(dirs[1], "hdf5", name))
    with h5py.File(os.path.join(dirs[1], "hdf5", files[-1]), "r") as f:
        assert f["/data/40/fields/Et_pml"].shape == (2 * NM - 1, NR, NZ)

    # fbpic_tpu's state (the _pml fields included) carried into the port
    spect, interp = jax_fields(s0.state)
    st = s0.state
    s1.state = state_from_numpy(spect, interp, [], float(st.time),
                                float(st.zmin), int(st.iteration),
                                device="cpu")
    s0.diags, s1.diags = [], []
    s0.step(5, correct_currents=False, show_progress=False)
    s1.step(5, correct_currents=False)
    compare_fields(s0.state, s1.state, 1e-8)


def test_pml_checkpoint_round_trip(tmp_path):
    """A PML run's checkpoint restores every field, the _pml ones
    included, bit for bit; the restarted run steps on identically."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.diagnostics import (set_periodic_checkpoint,
                                             restart_from_checkpoint)
    from fbpic_tpu_torch.fields.solver import present_fields
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser

    def make():
        sim = Simulation(NZ, ZMAX, NR, RMAX, NM, DT, device="cpu",
                         dtype=torch.float64, **SIM_KW)
        add_laser_pulse(sim, GaussianLaser(**LASER_KW))
        return sim

    ckdir = str(tmp_path / "ck")
    a = make()
    set_periodic_checkpoint(a, 6, checkpoint_dir=ckdir)
    a.step(6, correct_currents=False)
    b = make()
    restart_from_checkpoint(b, 6, checkpoint_dir=ckdir)
    for group in ("spect", "interp"):
        ga, gb = getattr(a.state, group), getattr(b.state, group)
        assert present_fields(ga) == present_fields(gb)
        assert set(PML_SPECT if group == "spect" else PML_INTERP) \
            <= set(present_fields(gb))
        for n in present_fields(ga):
            assert torch.equal(getattr(ga, n), getattr(gb, n)), n
    a.checkpoints = []
    a.step(2, correct_currents=False)
    b.step(2, correct_currents=False)
    for n in PML_SPECT:
        assert torch.equal(getattr(a.state.spect, n),
                           getattr(b.state.spect, n)), n
