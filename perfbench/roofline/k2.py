"""K2, the field gather with linear shapes (csrc/gather.cu).

Per live particle it reads x, y, z and writes Ex, Ey, Ez, Bx, By, Bz
(9 float32); it reads E_r, E_t, E_z, B_r, B_t, B_z on the grid (6
components of 2 Nm - 1 real values a cell, float32).  Operations: each
particle's 4 corner weights times each component's 2 Nm - 1 mode
values, a multiply-add each (2 operations).  Bytes bound it."""

KERNEL = "gather_sorted_kernel"


def work(grid, live):
    n_real = 2 * grid["Nm"] - 1
    n_bytes = live * 9 * 4 + 6 * n_real * grid["Nz"] * grid["Nr"] * 4
    n_flops = live * 4 * 6 * n_real * 2
    return n_bytes, n_flops
