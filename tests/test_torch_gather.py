"""K2, the sorted field gather: the port's ``gather_fields_sorted``
against fbpic_tpu's XLA path, and the Python its CUDA wrapper runs
before a launch.

On the CPU, ``gather_fields_sorted`` runs K2's plain version
(``cuda_gather.gather_sorted_plain``: the operand build of
``gather.gather_operands`` and the one-hot contraction).  It is held
against fbpic_tpu's ``gather_fields_sorted`` with the Pallas gather off
(FBPIC_TPU_PALLAS_GATHER=0), on the same numpy-seeded particles and
fields, in float32 (5e-6 of each output's largest value: both sum the
corners and modes in float32, in another order) and float64 (1e-12),
for both z folds, with and without Kahan words, and with a finite
rmax_gather.  The particles include the cases the kernel's geometry
treats at an edge: on the axis (r = 0), below the first cell centre
(the signed guard row), past the top radial row (the clamp u_r = Nr)
and beyond rmax_gather (zeroed), and z offsets clipped at both ends
(moved after the sort by more than the one-cell window).  The CUDA
kernel itself is held against this plain version on the card
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

NZ, NR, NM = 16, 10, 2
DZ, DR, ZMIN = 0.1, 0.2, -1.0
K = 160
RMAX_GATHER = (NR + 0.3) * DR    # inside the clamped top cell


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _inputs(dtype, zfold, seed=13):
    """Column-sorted particles with the edge cases, Kahan words and the
    interp fields, from a numpy seed.  Returns (padded x, y, z, Kahan
    words, valid, fields as numpy (re, im) pairs)."""
    from fbpic_tpu_torch.particles.sorted_deposit import build_column_sort
    rng = np.random.RandomState(seed)
    Np = 1200
    z = ZMIN + rng.uniform(0.0, NZ * DZ, Np)
    r = rng.uniform(0, 1.08 * NR * DR, Np)
    pick = rng.rand(Np)
    r[pick < 0.25] = rng.uniform(0, 0.5 * DR, int((pick < 0.25).sum()))
    r[pick > 0.95] = 0.0                                   # on the axis
    top = (pick > 0.85) & (pick <= 0.95)                   # top radial row
    r[top] = rng.uniform((NR - 0.5) * DR, (NR + 0.6) * DR, int(top.sum()))
    th = rng.uniform(0, 2 * np.pi, Np)
    w = rng.uniform(0.5, 1.5, Np)
    w[rng.rand(Np) < 0.1] = 0.0
    comp = [rng.randn(Np) * 1e-3 * DZ for _ in range(3)]
    arrs = [torch.as_tensor(a.astype(dtype))
            for a in [r * np.cos(th), r * np.sin(th), z, w] + comp]
    sort = build_column_sort(arrs[2], arrs[3], ZMIN, 1 / DZ, NZ, K, arrs)
    assert int(sort["n_over"]) == 0
    x, y, zp, _, cx, cy, cz = sort["padded"]
    valid = sort["valid"]
    # Move some live particles after the sort by up to 1.6 cells, so
    # their z offset from the column is clipped at both ends (o_lo = 0
    # and o_lo = 2); periodic z wraps them back into the box
    shift = rng.choice([0.0, 0.0, 0.7, 1.6, -0.7, -1.6], size=zp.shape) * DZ
    zp = torch.where(valid, zp + torch.as_tensor(shift.astype(dtype)), zp)
    if zfold == "periodic":
        zp = ZMIN + torch.remainder(zp - ZMIN, NZ * DZ)
    fields = {n: (rng.randn(NM, NZ, NR).astype(dtype),
                  rng.randn(NM, NZ, NR).astype(dtype))
              for n in ("Er", "Et", "Ez", "Br", "Bt", "Bz")}
    return x, y, zp.contiguous(), (cx, cy, cz), valid, fields


def _port_interp(fields):
    from fbpic_tpu_torch.fields.solver import InterpFields
    return InterpFields(**{n: torch.complex(torch.as_tensor(re),
                                            torch.as_tensor(im))
                           for n, (re, im) in fields.items()})


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("with_comp", [False, True])
@pytest.mark.parametrize("zfold", ["periodic", "clamp"])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 5e-6),
                                       (np.float64, 1e-12)])
def test_gather_fields_sorted_matches_fbpic_tpu(dtype, tol, zfold, with_comp,
                                                monkeypatch):
    from fbpic_tpu.fields.solver import InterpFields as JaxInterp
    from fbpic_tpu.particles.gather import gather_fields_sorted as g0
    from fbpic_tpu.utils.complex_arr import CArr
    from fbpic_tpu_torch.particles.gather import gather_fields_sorted as g1
    monkeypatch.setenv("FBPIC_TPU_PALLAS_GATHER", "0")
    x, y, z, comp, valid, fields = _inputs(dtype, zfold)
    geo = (1 / DZ, ZMIN, NZ, 1 / DR, 0.0, NR)
    rmax = dtype(RMAX_GATHER)
    out = g1(x, y, z, valid, _port_interp(fields), rmax, *geo,
             comp=comp if with_comp else None, zfold=zfold)
    jinterp = JaxInterp(**{n: CArr(jnp.asarray(re), jnp.asarray(im))
                           for n, (re, im) in fields.items()})
    j = [jnp.asarray(t.numpy()) for t in (x, y, z, valid)]
    ref = g0(*j, jinterp, rmax, *geo,
             comp=tuple(jnp.asarray(t.numpy()) for t in comp)
             if with_comp else None, zfold=zfold)
    # what the inputs reach: the guard row, the top-row clamp, zeroed
    # slots past rmax_gather, and both clipped z offsets
    from fbpic_tpu_torch.particles.gather import gather_operands
    ops = gather_operands(x, y, z, valid, _port_interp(fields), rmax, *geo,
                          zfold=zfold)
    live = valid & (ops["ok"] != 0)
    assert bool(((ops["l_r"] == 0) & live).any())
    assert bool(((ops["l_r"] == NR) & live).any())
    assert bool((valid & (ops["ok"] == 0)).any())
    for o in (0, 2):
        assert bool(((ops["o_lo"] == o) & live).any())
    assert bool(((x == 0) & (y == 0) & live).any())
    for a, b in zip(out, ref):
        assert a.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        assert _rel(a.numpy(), np.asarray(b)) <= tol
        assert not a[~valid].any()


# --- the Python the CUDA wrapper runs before a launch --------------------

def _operands(dtype=np.float32):
    x, y, z, comp, valid, fields = _inputs(dtype, "periodic")
    return dict(xp=x, yp=y, zp=z, valid=valid, interp=_port_interp(fields),
                Nz=NZ, Nr=NR, comp=comp)


def test_wrapper_accepts_both_field_layouts_it_reads():
    """Contiguous fields (r fastest) and the layout torch.fft along z
    leaves (z fastest) are read in place; the strides come back in
    complex elements."""
    import dataclasses
    from fbpic_tpu_torch.particles.cuda_gather import check_gather_operands
    ops = _operands()
    fields, Nm, sz, sr = check_gather_operands("K2", **ops)
    assert (Nm, sz, sr) == (NM, NR, 1)
    assert fields[0] is ops["interp"].Er
    fft_made = torch.fft.ifft(torch.fft.fft(ops["interp"].Er, dim=1), dim=1)
    assert not fft_made.is_contiguous()
    interp = dataclasses.replace(ops["interp"], **{
        n: torch.fft.ifft(torch.fft.fft(getattr(ops["interp"], n), dim=1),
                          dim=1)
        for n in ("Er", "Et", "Ez", "Br", "Bt", "Bz")})
    _, _, sz, sr = check_gather_operands("K2", **dict(ops, interp=interp))
    assert (sz, sr) == (1, NZ)


@pytest.mark.parametrize("fault", [
    "dtype", "valid_dtype", "device", "shape", "strided", "comp_strided",
    "field_strided", "field_dtype", "field_shape", "field_layouts_differ",
    "field_conj", "zfold"])
def test_wrapper_refuses_what_the_kernel_does_not_read(fault):
    import dataclasses
    from fbpic_tpu_torch.particles.cuda_gather import check_gather_operands
    ops = _operands()
    interp = ops["interp"]

    def strided(t):
        return t.transpose(0, 1).contiguous().transpose(0, 1)

    bad = {
        "dtype": dict(xp=ops["xp"].double()),
        "valid_dtype": dict(valid=ops["valid"].float()),
        "device": dict(yp=ops["yp"].to("meta")),
        "shape": dict(zp=ops["zp"][:, :-1]),
        "strided": dict(xp=strided(ops["xp"])),
        "comp_strided": dict(comp=(ops["comp"][0], strided(ops["comp"][1]),
                                   ops["comp"][2])),
        "field_strided": dict(interp=dataclasses.replace(
            interp, Ez=interp.Ez.transpose(0, 1).contiguous()
            .transpose(0, 1))),
        "field_dtype": dict(interp=dataclasses.replace(
            interp, Bt=interp.Bt.to(torch.complex128))),
        "field_shape": dict(interp=dataclasses.replace(
            interp, Br=interp.Br[:, :, :-1])),
        "field_layouts_differ": dict(interp=dataclasses.replace(
            interp, Bz=interp.Bz.transpose(1, 2).contiguous()
            .transpose(1, 2))),
        "field_conj": dict(interp=dataclasses.replace(
            interp, Et=interp.Et.conj())),
        "zfold": dict(zfold="wrap"),
    }[fault]
    err = TypeError if "dtype" in fault else ValueError
    with pytest.raises(err):
        check_gather_operands("K2", **dict(ops, **bad))


def test_wrapper_raises_on_a_device_it_has_no_kernel_for():
    from fbpic_tpu_torch.particles.cuda_gather import gather_sorted
    ops = _operands()
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in ops.items() if k not in ("interp", "comp")}
    with pytest.raises(ValueError, match="unsupported device"):
        gather_sorted(meta["xp"], meta["yp"], meta["zp"], meta["valid"],
                      ops["interp"], 1.0, 1 / DZ, ZMIN, NZ, 1 / DR, 0.0, NR)


@pytest.mark.parametrize("esize", [4, 8])
@pytest.mark.parametrize("Nm", [1, 2, 3, 4])
@pytest.mark.parametrize("Nr", [12, 50, 200, 500, 3000])
def test_staged_rows_fit_the_shared_memory_of_a_block(Nr, Nm, esize):
    """pick_bz: the largest run of columns whose staged rows fit
    Hopper's 227 KB (one more would not), 0 (direct reads) when not
    even one column's do; a staged entry holds the 12 Nm words of a
    corner and is an odd number of (re, im) pairs."""
    from fbpic_tpu_torch.particles import cuda_gather
    from fbpic_tpu_torch.utils import kernels
    limit = kernels.SMEM_PER_BLOCK - kernels.SMEM_STATIC
    bz = cuda_gather.pick_bz(esize, Nm, Nr)
    smem = cuda_gather.gather_smem_bytes
    assert 0 <= bz <= cuda_gather.BZ_MAX
    if bz > 0:
        assert smem(esize, Nm, Nr, bz) <= limit
        entry = smem(esize, Nm, Nr, bz) // ((bz + 2) * (Nr + 1))
        assert entry % (2 * esize) == 0 and (entry // (2 * esize)) % 2 == 1
        assert 12 * Nm * esize < entry <= (12 * Nm + 2) * esize
    if bz < cuda_gather.BZ_MAX:
        assert smem(esize, Nm, Nr, bz + 1) > limit
    assert smem(esize, Nm, Nr, 0) == 0
    if Nr == 50 and Nm == 2:      # the paths' own shape: the most columns
        assert bz == cuda_gather.BZ_MAX
    if Nr == 3000:
        assert bz == 0


def test_shared_memory_reckoning_at_the_lwfa_shape():
    """By hand at Nm = 2, Nr = 50: 24 words a corner padded to 13 (re,
    im) pairs, 6 z rows of 51 entries."""
    from fbpic_tpu_torch.particles import cuda_gather
    assert cuda_gather.gather_smem_bytes(4, 2, 50, 4) == 6 * 51 * 26 * 4
    assert cuda_gather.gather_smem_bytes(8, 2, 50, 4) == 6 * 51 * 26 * 8
    assert cuda_gather.pick_bz(8, 2, 500) == 0
    assert cuda_gather.pick_bz(4, 2, 500) == 2


def test_channel_metadata_is_built_once_per_layout():
    """The deposit's channel metadata comes from a cache: the same
    tensors on every call (no host-to-device copy in the step), equal to
    what the layout defines."""
    from fbpic_tpu_torch.particles.deposit import _channel_meta
    a = _channel_meta(2, 3, [-1.0, -1.0, +1.0], torch.float32,
                      torch.device("cpu"))
    b = _channel_meta(2, 3, (-1.0, -1.0, 1.0), torch.float32, "cpu")
    assert a["flip"] is b["flip"] and a["is_mode0"] is b["is_mode0"]
    assert a["is_mode0"].tolist() == [True, False, False] * 3
    assert a["flip"].tolist() == [-1.0, 1.0, 1.0] * 2 + [1.0, -1.0, -1.0]
    c = _channel_meta(2, 3, [-1.0, -1.0, +1.0], torch.float64, "cpu")
    assert c["flip"].dtype == torch.float64 and c["flip"] is not a["flip"]
