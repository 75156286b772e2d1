"""K1, the fused J + rho deposit with linear shapes (csrc/fused_deposit.cu).

Per live particle it reads x, y, z, ux, uy, uz, 1/gamma and w (8
float32); it writes J_r, J_t, J_z and rho on the grid (4 components of
2 Nm - 1 real values a cell, float32).  Operations: each particle's 4
corner weights times each component's 2 Nm - 1 mode values, a
multiply-add each (2 operations).  Bytes bound it."""

KERNEL = "fused_contract_kernel"


def work(grid, live):
    n_real = 2 * grid["Nm"] - 1
    n_bytes = live * 8 * 4 + 4 * n_real * grid["Nz"] * grid["Nr"] * 4
    n_flops = live * 4 * 4 * n_real * 2
    return n_bytes, n_flops
