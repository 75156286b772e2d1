"""Progress bar and setup banner.

Behavioral reference: fbpic_tpu's utils/printing.py (after FBPIC's
utils/printing.py): the time per step as an exponential moving average,
an ETA, and the first update reported as the start-up (first-step
compilation in fbpic_tpu; first kernel builds and allocations here).
"""
import sys
import time

import torch

from .. import __version__


class ProgressBar(object):
    """A progress bar with the average time per step and the ETA.

    The step loop calls ``due(i)`` after step i and, where it is due,
    ``time(i)`` and ``print_progress()``: every ceil(N / Nbars) steps
    and after the last, so a run of N steps updates at most Nbars + 1
    times.  The time per step of an update is the time since the last
    one over the steps between them (fbpic_tpu's bar updates once per
    device chunk of up to 250 steps and divides by one)."""

    def __init__(self, N, n_avg=20, Nbars=35):
        self.N = N
        self.i_step = 0
        self.Nbars = Nbars
        self.every = max(1, -(-N // Nbars))
        self.avg_timeper_step = 0.0
        self.n_avg = n_avg
        self.init_time = time.time()
        self.prev_time = self.init_time

    def due(self, i_step):
        return i_step % self.every == 0 or i_step == self.N

    def time(self, i_step):
        curr_time = time.time()
        time_per_step = (curr_time - self.prev_time) / max(
            i_step - self.i_step, 1)
        self.prev_time = curr_time
        if i_step > 1 and self.i_step > 0:
            # Exponential moving average (the first update excluded: it
            # holds the start-up)
            alpha = min(1.0 / self.n_avg, 1.0 / max(i_step - 1, 1))
            self.avg_timeper_step = (
                (1 - alpha) * self.avg_timeper_step + alpha * time_per_step)
        else:
            self.avg_timeper_step = time_per_step
        self.i_step = i_step

    def print_progress(self):
        i = self.i_step
        nbars = int(i * self.Nbars / max(self.N, 1))
        bar = "|" + nbars * "-" + (self.Nbars - nbars) * " " + "|"
        eta = self.avg_timeper_step * (self.N - i)
        info = " %d/%d, %.1f ms/step, ETA %s" % (
            i, self.N, 1e3 * self.avg_timeper_step,
            time.strftime("%H:%M:%S", time.gmtime(eta)))
        sys.stdout.write("\r" + bar + info + " " * 8)
        sys.stdout.flush()

    def print_summary(self):
        total = time.time() - self.init_time
        sys.stdout.write(
            "\nTotal duration: %.1f s; average %.1f ms/step "
            "(the first steps include start-up)\n"
            % (total, 1e3 * self.avg_timeper_step))
        sys.stdout.flush()


def print_simulation_setup(sim, verbose_level=1):
    """Print a setup banner (reference: printing.py:139-243)."""
    if verbose_level <= 0:
        return
    cfg = sim.config
    dev = sim.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    lines = [
        "fbpic_tpu_torch %s" % __version__,
        "Device: %s (%s), %s" % (dev, name,
                                 str(sim.dtype).replace("torch.", "")),
        "Grid: Nz=%d (physical %d) x Nr=%d, Nm=%d modes" % (
            cfg.Nz, sim.Nz_phys, cfg.Nr, cfg.Nm),
        "dz=%.3e m, dr=%.3e m, dt=%.3e s, stencil order n=%d" % (
            cfg.dz, cfg.dr, cfg.dt, cfg.n_order),
        "Boundaries: z=%s, r=%s" % (
            cfg.boundaries_z, "open (PML)" if cfg.use_pml
            else "reflective"),
    ]
    if verbose_level >= 2:
        for i, sc in enumerate(sim.species_configs):
            lines.append("Species %d (%s): q=%.3e C, m=%.3e kg" % (
                i, sc.name, sc.q, sc.m))
    print("\n".join(lines))
