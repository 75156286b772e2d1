"""Laser emission by a virtual antenna plane.

A laser can be progressively emitted from a plane z = z0(t) carrying
the surface current K = 2 eps0 c E_laser (the field a current sheet
must carry to radiate E_laser symmetrically; the reference implements
this with virtual macroparticle pairs whose motion produces exactly
this current -- FBPIC's antenna_injection.py:24-330).

As in fbpic_tpu, the azimuthally-decomposed (Jr, Jt) the antenna adds
to the grid is computed on the host for a block of steps (the laser
profile is an analytic function of space and time) and uploaded to the
device in one copy as an (n_steps, Nm, Nr) series; each step adds its
slice onto the two z cells next to the antenna with linear weights.
The antenna's z positions stay on the host (in the working dtype), so
the cell index and the weights are host numbers (``antenna_cells``): a
step reads nothing back from the device.  The eager step adds the
slice at those host numbers (``add_antenna_current``); a step replayed
from a CUDA graph reads them from the device, where the chunk runner
put them (``add_antenna_current_device``): the same bits.
"""
from dataclasses import dataclass

import numpy as np
import torch

from ...constants import c, epsilon_0


@dataclass
class AntennaSeries:
    """One block of the antenna's deposited current.

    J: complex tensor (2, n_steps, Nm, Nr) on the device -- the
    mode-decomposed Jr (J[0]) and Jt (J[1]), already divided by dz
    (surface current / cell size).
    z_pos: numpy (n_steps,) of the working dtype -- the antenna's z at
    each step.
    it0: int -- the iteration of the first slice.
    """
    J: torch.Tensor
    z_pos: np.ndarray
    it0: int = 0

    @property
    def Jr(self):
        return self.J[0]

    @property
    def Jt(self):
        return self.J[1]


class LaserAntenna(object):
    """Virtual antenna emitting a given laser profile.

    Parameters mirror the reference (antenna_injection.py:24-120).
    """

    def __init__(self, laser_profile, z0_antenna, v_antenna,
                 z_grid, r_grid, dr, dt, Nm, boost=None):
        self.profile = laser_profile
        self.z0 = z0_antenna
        self.v = v_antenna
        self.boost = boost
        self.dt = dt
        self.Nm = Nm
        self.r = np.asarray(r_grid)
        self.dr = dr
        if boost is not None and v_antenna == 0.0:
            # A lab-static antenna moves backward in the boosted frame
            self.z0 = z0_antenna / boost.gamma0
            self.v = -boost.beta0 * c

    def compute_series(self, t0, n_steps, dz, *, device,
                       dtype=torch.float64, it0=0):
        """Host-side (numpy float64) evaluation of the emitted current
        for n_steps steps from time t0, cast to ``dtype`` and uploaded to
        ``device`` (required: the simulation's) in one copy
        (asynchronous, from pinned memory, on a CUDA device).

        The current is sampled at the half-steps t0 + (i + 1/2) dt, the
        time at which J is deposited in the PIC cycle.
        """
        Nm = self.Nm
        ntheta = 2 * Nm
        theta = (2 * np.pi / ntheta) * np.arange(ntheta)
        r3, th3 = np.meshgrid(self.r, theta, indexing="ij")
        x2 = r3 * np.cos(th3)
        y2 = r3 * np.sin(th3)

        J = np.zeros((2, n_steps, Nm, len(self.r)), complex)
        z_pos = np.zeros(n_steps)
        for i in range(n_steps):
            t = t0 + (i + 0.5) * self.dt
            z_ant = self.z0 + self.v * t
            z_pos[i] = z_ant
            if self.boost is not None:
                zlab = self.boost.gamma0 * (
                    z_ant + self.boost.beta0 * c * t)
                tlab = self.boost.gamma0 * (
                    t + self.boost.beta0 * z_ant / c)
                Ex, Ey = self.profile.E_field(
                    x2, y2, np.full_like(x2, zlab), tlab)
                scale = 1.0 / (self.boost.gamma0 * (1 + self.boost.beta0))
                Ex = Ex * scale
                Ey = Ey * scale
            else:
                Ex, Ey = self.profile.E_field(
                    x2, y2, np.full_like(x2, z_ant), t)
            Er = np.cos(th3) * Ex + np.sin(th3) * Ey
            Et = -np.sin(th3) * Ex + np.cos(th3) * Ey
            # Azimuthal decomposition + surface current / dz
            coef = 2 * epsilon_0 * c / dz
            J[0, i] = coef * np.moveaxis(
                np.fft.ifft(Er, axis=-1)[:, :Nm], -1, 0)
            J[1, i] = coef * np.moveaxis(
                np.fft.ifft(Et, axis=-1)[:, :Nm], -1, 0)

        cdtype = (torch.complex64 if dtype == torch.float32
                  else torch.complex128)
        J = torch.from_numpy(J).to(cdtype)
        device = torch.device(device)
        if device.type == "cuda":
            J = J.pin_memory().to(device, non_blocking=True)
        else:
            J = J.to(device)
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        return AntennaSeries(J=J, z_pos=z_pos.astype(np_dtype), it0=it0)


def antenna_cells(series: AntennaSeries, iteration, zmin, dz, Nz,
                  own_bounds=None):
    """Where the antenna's slice of host ``iteration`` goes, as host
    numbers: (its row in the series, the two clamped z cells, their
    weights s0 and s1 (numpy scalars of the working dtype), and whether
    the slice is added at all: the two cells inside the box, and on a
    slab of a decomposed run the plane inside the (z_lo, z_hi) interval
    ``own_bounds`` it owns).  zmin: a host number of the working dtype;
    the arithmetic is fbpic_tpu's (antenna_injection.py:137-151)."""
    n_steps = series.z_pos.shape[0]
    i = min(max(iteration - series.it0, 0), n_steps - 1)
    z_ant = series.z_pos[i]
    rdt = type(z_ant)
    z_cell = (z_ant - rdt(zmin)) / rdt(dz) - rdt(0.5)
    iz0 = int(np.floor(z_cell))
    s1 = z_cell - rdt(iz0)
    s0 = rdt(1.0) - s1
    iz0c = min(max(iz0, 0), Nz - 1)
    iz1c = min(max(iz0 + 1, 0), Nz - 1)
    on = 0 <= iz0 < Nz - 1 and (own_bounds is None or
                                own_bounds[0] <= z_ant < own_bounds[1])
    return i, iz0c, iz1c, s0, s1, on


def add_antenna_current(Jr_grid, Jt_grid, series: AntennaSeries,
                        iteration, zmin, dz, Nz, own_bounds=None):
    """Add the antenna's current slice of host ``iteration`` onto the
    grid currents (complex (Nm, Nz, Nr)): linear weights on the two z
    cells next to the antenna, nothing when those leave the box
    (``antenna_cells``; zmin: a numpy scalar of the working dtype).
    ``own_bounds``: on a slab of a decomposed run, the (z_lo, z_hi)
    interval it owns -- the antenna deposits only there."""
    i, iz0c, iz1c, s0, s1, on = antenna_cells(series, iteration, zmin, dz,
                                              Nz, own_bounds)
    if not on:
        return Jr_grid, Jt_grid

    def add(G, S):
        G = G.clone()
        G[:, iz0c, :] += float(s0) * S
        G[:, iz1c, :] += float(s1) * S
        return G

    return add(Jr_grid, series.Jr[i]), add(Jt_grid, series.Jt[i])


def add_antenna_current_device(Jr_grid, Jt_grid, series: AntennaSeries,
                               cells):
    """``add_antenna_current`` with the values of ``antenna_cells`` read
    from the device: ``cells`` = (row, iz0c, iz1c) 0-d int64 tensors and
    (s0, s1, on) 0-d tensors of the working dtype (on: 1 or 0).  The
    slice is added to the two cells by one ``index_add`` each, with its
    weights times ``on``: 0 when the host form adds nothing.  No host
    read, so a CUDA graph can capture it; the same bits as the host form
    (each cell's sum is the host form's single add)."""
    row, iz0c, iz1c, s0, s1, on = cells
    idx = torch.stack([iz0c, iz1c])
    w = (torch.stack([s0, s1]) * on)[None, :, None]

    def add(G, S):
        S = S.index_select(0, row.view(1))[0]            # (Nm, Nr)
        return G.index_add(1, idx, S[:, None, :] * w)

    return add(Jr_grid, series.Jr), add(Jt_grid, series.Jt)
