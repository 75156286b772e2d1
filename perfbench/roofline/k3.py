"""K3, the dense J and rho deposits with linear shapes
(csrc/dense_deposit.cu), all its launches of a step together.

The work of a step is K1's: per live particle x, y, z, ux, uy, uz,
1/gamma and w (8 float32) read once; J_r, J_t, J_z and rho written on
the grid (4 components of 2 Nm - 1 real values a cell, float32); each
particle's 4 corner weights times each component's mode values, a
multiply-add each.  Bytes bound it."""

KERNEL = "dense_contract_kernel"


def work(grid, live):
    n_real = 2 * grid["Nm"] - 1
    n_bytes = live * 8 * 4 + 4 * n_real * grid["Nz"] * grid["Nr"] * 4
    n_flops = live * 4 * 4 * n_real * 2
    return n_bytes, n_flops
