"""The banded re-sort at a periodic seam on a small grid (Nz <= 4 band
+ 2), where fbpic_tpu's ``banded_column_resort`` keeps a particle that
strayed past its band twice: the port counts it instead.

- Nz = 6, band 1, one particle stored in row 0 whose column is 3 (three
  rows away): fbpic_tpu's re-sort keeps it in rows 1 and 5, and its
  ``n_over`` is -1 (the duplicate subtracts from the unplaced count);
  the port's ``n_over`` is exactly 2 (the duplicate and the far clamp),
  so the eager step takes the full sort, which places it once;
- the same through the port's step on a periodic float32 run (the
  resident banded layout, band 1, Nz = 6): after the planted particle's
  step the live count and the total weight are those before it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fbpic_tpu.constants import c  # noqa: E402

NZ, K, BAND = 6, 4, 1


def _layout():
    """One particle a row at its cell's centre, and a planted one in row
    0 lane 1 whose column is 3: (x, y, z, w) as (Nz, K) float64."""
    z = np.zeros((NZ, K))
    w = np.zeros((NZ, K))
    z[:, 0] = np.arange(NZ) + 0.5
    w[:, 0] = 1.0
    z[0, 1], w[0, 1] = 3.5, 7.0
    x = np.tile(np.linspace(0.1, 0.4, K), (NZ, 1))
    return [x, x.copy(), z, w]


def test_far_particle_at_periodic_seam_is_counted_not_duplicated():
    import jax.numpy as jnp
    from fbpic_tpu.particles.sorted_deposit import banded_column_resort as ref
    from fbpic_tpu_torch.particles.sorted_deposit import (
        banded_column_resort, build_column_sort)
    pad = _layout()
    assert NZ <= 4 * BAND + 2
    # fbpic_tpu: kept twice, its n_over negative
    a = ref(tuple(jnp.asarray(p) for p in pad), 0.0, 1.0, NZ, K, BAND,
            zfold="periodic")
    w_a = np.asarray(a["padded"][3])[np.asarray(a["valid"])]
    assert int((w_a == 7.0).sum()) == 2
    assert int(a["n_over"]) == -1
    # the port: the same layout, its count exact (one particle kept
    # twice, one more than band + 1 rows from its row)
    b = banded_column_resort([torch.as_tensor(p) for p in pad], 0.0, 1.0,
                             NZ, K, BAND, zfold="periodic")
    assert int(b["n_over"]) == 2
    # which sends the step to the full sort: the particle once, in its
    # column
    full = build_column_sort(torch.as_tensor(pad[2]).reshape(-1),
                             torch.as_tensor(pad[3]).reshape(-1), 0.0, 1.0,
                             NZ, K, [torch.as_tensor(p).reshape(-1)
                                     for p in pad])
    w_f = full["padded"][3][full["valid"]]
    assert int((w_f == 7.0).sum()) == 1
    assert int(full["n_over"]) == 0
    assert float(full["padded"][3][3][full["valid"][3]].sum()) == 8.0
    # in clamp z nothing is kept twice: the count is fbpic_tpu's
    a = ref(tuple(jnp.asarray(p) for p in pad), 0.0, 1.0, NZ, K, BAND,
            zfold="clamp")
    b = banded_column_resort([torch.as_tensor(p) for p in pad], 0.0, 1.0,
                             NZ, K, BAND, zfold="clamp")
    assert int(a["n_over"]) == int(b["n_over"]) == 0


def test_periodic_step_keeps_the_particle_count():
    """A periodic float32 run with Nz = 6 (band 1): a particle planted
    three rows from its stored row; the step after it keeps the live
    count and the weight (with the reference's count the banded layout
    would have kept it twice)."""
    from fbpic_tpu_torch import Simulation
    zmax = 6.e-6
    sim = Simulation(NZ, zmax, 8, 4.e-6, 1, zmax / NZ / c, p_zmin=0.,
                     p_zmax=zmax, p_rmin=0., p_rmax=3.e-6, p_nz=1, p_nr=1,
                     p_nt=2, n_e=1.e24, n_order=4, random_seed=0,
                     verbose_level=0, device="cpu", dtype=torch.float32)
    sc = sim.species_configs[0]
    assert sc.resident and sc.resort == "banded"
    assert sim.config.resort_band == BAND
    sim.step(1)          # the full sort of iteration 0; then banded ones
    sp = sim.state.species[0]
    Kr = sc.sort_K
    live = (sp.w != 0).reshape(NZ, Kr)
    n0, w0 = int(live.sum()), float(sp.w.double().sum())
    assert live[0].any()
    # a live particle of row 0 moved to column 3 (a periodic wrap of at
    # most half the box: the band's candidates reach it from both sides)
    k = int(torch.nonzero(live[0])[0])
    z = sp.z.clone().reshape(NZ, Kr)
    z[0, k] = float(sim.state.zmin + 3.5 * sim.config.dz)
    sim.state.species[0] = sp.replace(z=z.reshape(-1))
    sim.step(1)
    sp = sim.state.species[0]
    assert int((sp.w != 0).sum()) == n0
    assert abs(float(sp.w.double().sum()) - w0) <= 1e-6 * w0
    assert sim.overflow_totals["sort_overflow"] == 0
