"""openPMD diagnostics: fbpic_tpu_torch against fbpic_tpu (float64).

Both packages run tests/test_diagnostics.py's configuration (Nz = 64,
Nr = 16, Nm = 2, a periodic uniform electron cylinder) with tracking on
and the same diagnostics: ``FieldDiagnostic``,
``ParticleDiagnostic`` (position, momentum, weighting, E, B, gamma and
id, with a ``select``) and ``ParticleChargeDensityDiagnostic``.  Every
group, dataset and attribute of their files must agree, except the
``date`` and ``software`` attributes: attributes, ids, counts, shapes
and dtypes exactly; float datasets to a tolerance of their record's
largest value (E/r, E/t, E/z share one): grid fields and E/B at the
particles 1e-8 (the curl-free correction amplifies the float64 roundoff
of deposits summed in another order, tests/test_torch_step.py),
particle positions, momenta, weights and gammas 1e-12.

Without h5py, ``write`` raises ImportError naming h5py and ``collect``
still returns the records.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from fbpic_tpu.constants import c  # noqa: E402

NZ, NR, NM = 64, 16, 2
ZMAX, RMAX = 6.4e-6, 8.e-6
DT = ZMAX / NZ / c
SIM_KW = dict(p_zmin=0., p_zmax=ZMAX, p_rmin=0., p_rmax=6.e-6, p_nz=1,
              p_nr=1, p_nt=4, n_e=1.e24, random_seed=0)
PARTICLE_DATA = ("position", "momentum", "weighting", "E", "B", "gamma",
                 "id")
SELECT = {"x": [0.0, None], "uz": [-1.0, 1.0]}
SKIP_ATTRS = ("date", "software")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tolerance(name):
    """Float tolerance of dataset ``name`` (see the module docstring)."""
    if "/fields/" in name:
        return 1e-8
    parts = name.split("/")
    if len(parts) >= 2 and parts[-2] in ("E", "B"):
        return 1e-8
    return 1e-12


def compare_h5(path0, path1, tolerance=_tolerance):
    """Hold file path1 against path0: the same objects, attributes
    (except date / software) exactly, datasets' shapes and dtypes
    exactly, integer data exactly, float data to tolerance(name) of
    the largest |value| of the record (the parent group of a component
    dataset, or the dataset itself)."""
    with h5py.File(path0, "r") as f0, h5py.File(path1, "r") as f1:
        names0, names1 = [], []
        f0.visit(names0.append)
        f1.visit(names1.append)
        assert sorted(names0) == sorted(names1)
        for name in ["/"] + names0:
            o0, o1 = f0[name], f1[name]
            assert type(o0) is type(o1), name
            keys = [k for k in o0.attrs if k not in SKIP_ATTRS]
            assert sorted(keys) == sorted(k for k in o1.attrs
                                          if k not in SKIP_ATTRS), name
            for k in keys:
                a0, a1 = np.asarray(o0.attrs[k]), np.asarray(o1.attrs[k])
                assert a0.dtype == a1.dtype, (name, k)
                np.testing.assert_array_equal(a0, a1, err_msg=f"{name}@{k}")
            if not isinstance(o0, h5py.Dataset):
                continue
            d0, d1 = o0[...], o1[...]
            assert d0.shape == d1.shape and d0.dtype == d1.dtype, name
            if not np.issubdtype(d0.dtype, np.floating):
                np.testing.assert_array_equal(d0, d1, err_msg=name)
                continue
            parent = o0.parent
            record = ([parent[k][...] for k in parent
                       if isinstance(parent[k], h5py.Dataset)]
                      if parent.attrs.get("unitDimension") is not None
                      and "unitDimension" not in o0.attrs else [d0])
            scale = max(np.abs(r).max(initial=0.0) for r in record)
            err = np.abs(d1 - d0).max(initial=0.0)
            assert err <= tolerance(name) * scale, (name, err, scale)


def _diags(pkg, sim, wdir):
    d = pkg.diagnostics
    view = sim.ptcl[0]
    return [
        d.FieldDiagnostic(4, sim, write_dir=wdir),
        d.ParticleDiagnostic(4, species={"electrons": view},
                             particle_data=PARTICLE_DATA, select=SELECT,
                             write_dir=wdir, sim=sim),
        d.ParticleChargeDensityDiagnostic(4, sim,
                                          species={"electrons": view},
                                          write_dir=wdir)]


def _run_both(tmp_path, n_steps=8):
    import fbpic_tpu
    import fbpic_tpu.diagnostics  # noqa: F401
    import fbpic_tpu_torch
    import fbpic_tpu_torch.diagnostics  # noqa: F401
    s0 = fbpic_tpu.Simulation(NZ, ZMAX, NR, RMAX, NM, DT, **SIM_KW)
    s1 = fbpic_tpu_torch.Simulation(NZ, ZMAX, NR, RMAX, NM, DT, device="cpu",
                                    dtype=torch.float64, **SIM_KW)
    dirs = []
    for pkg, sim, tag in ((fbpic_tpu, s0, "jax"),
                          (fbpic_tpu_torch, s1, "torch")):
        sim.ptcl[0].track(sim.comm)
        wdir = str(tmp_path / tag)
        sim.diags = _diags(pkg, sim, wdir)
        dirs.append(os.path.join(wdir, "hdf5"))
    s0.step(n_steps, show_progress=False)
    s1.step(n_steps)
    return s0, s1, dirs


def test_openpmd_files_match_fbpic_tpu(tmp_path):
    """Iterations 0, 4 and 8 of both packages' files, object by object."""
    s0, s1, (dir0, dir1) = _run_both(tmp_path)
    files = sorted(os.listdir(dir0))
    assert files == ["data%08d.h5" % i for i in (0, 4, 8)]
    assert sorted(os.listdir(dir1)) == files
    for name in files:
        compare_h5(os.path.join(dir0, name), os.path.join(dir1, name))
    with h5py.File(os.path.join(dir1, files[-1]), "r") as f:
        sp = f["/data/8/particles/electrons"]
        n = sp["weighting"].shape[0]
        # the select keeps x > 0 of all live particles: about half
        assert 0.3 * s1.ptcl[0].Ntot < n < 0.7 * s1.ptcl[0].Ntot
        assert sp["id"].dtype == np.uint64 and len(set(sp["id"][...])) == n


def test_write_without_h5py_raises_and_collect_works(tmp_path,
                                                     monkeypatch):
    """No other format and no silent skip: with h5py missing, write()
    raises ImportError naming h5py (FieldDiagnostic, ParticleDiagnostic,
    and the back-transformed field diagnostic's snapshot flush), while
    collect() returns the records a write would store."""
    import fbpic_tpu_torch
    from fbpic_tpu_torch.diagnostics import BackTransformedFieldDiagnostic
    sim = fbpic_tpu_torch.Simulation(NZ, ZMAX, NR, RMAX, NM, DT,
                                     device="cpu", dtype=torch.float64,
                                     **SIM_KW)
    sim.ptcl[0].track()
    fdiag, pdiag, _ = _diags(fbpic_tpu_torch, sim, str(tmp_path))
    btd = BackTransformedFieldDiagnostic(0., ZMAX, 0., DT, 1, 2.0, sim=sim,
                                         write_dir=str(tmp_path))
    monkeypatch.setitem(sys.modules, "h5py", None)
    for diag in (fdiag, pdiag):
        with pytest.raises(ImportError, match="h5py"):
            diag.write(sim)
    with pytest.raises(ImportError, match="h5py"):
        btd.flush_snapshot(0, btd.snapshots[0])
    assert os.listdir(os.path.join(str(tmp_path), "hdf5")) == []
    (name, rec), = fdiag.collect(sim).items()
    assert name == "data00000000.h5"
    data, attrs = rec["/data/0/fields/E/z"]
    assert data.shape == (2 * NM - 1, NR, NZ) and data.dtype == np.float64
    assert attrs["unitSI"] == 1.0
    (_, rec), = pdiag.collect(sim).items()
    ids, _ = rec["/data/0/particles/electrons/id"]
    n = rec["/data/0/particles/electrons/weighting"][0].shape[0]
    assert ids.dtype == np.uint64 and ids.shape == (n,) and n > 0
