"""ADK field ionization (relativistic, boosted-frame compatible).

Each ion macroparticle carries an ``ionization_level`` (int32, 0 in dead
slots).  The ADK probability is evaluated in the ion rest frame (a
Lorentz invariant), one uniform draw per slot decides ionization, and
the freed electrons are compacted into a fixed-size creation buffer
that the step writes into the target species (core/step.py): the
number created is data-dependent, and nothing of it is read back to
the host.  Port of fbpic_tpu's particles/ionization.py; reference
physics: FBPIC's fbpic/particles/elementary_process/ionization/.

Rate formula: ADK as in Chen et al., JCP 236 (2013), eq. (2), evaluated
in log space: the plain prefactor dt*wa*C2*(U/2UH)*(2(U/UH)^1.5 Ea)^(2n-1)
spans ~1e-30..1e+60 across high ionization levels, which overflows
float32; the log form stays O(100).
"""
import os
import re
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import c, e, m_e
from .compaction import topk_compact

# The NIST ionization-energy table (public-domain NIST ASD data, with
# its license and citation header): H-Ar, Kr, Xe, Rb, Rn, every level
_ATOMIC_DATA_FILE = os.path.join(os.path.dirname(__file__),
                                 "atomic_data.txt")
_cached_energies = {}

# Physical constants of the ADK prefactors
ALPHA_FS = 7.2973525693e-3        # fine-structure constant
R_E = 2.8179403262e-15            # classical electron radius [m]
UH_EV = 13.598434                 # hydrogen ionization energy [eV]

#: Channels of a creation buffer, beside the birth ``level``
BUFFER_FIELDS = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")


def get_ionization_energies(element):
    """Ionization energies in Joules (one entry per ionization level,
    i.e. the energy to go from charge state i to i+1), or None for an
    element absent from the table."""
    if element in _cached_energies:
        return _cached_energies[element]
    levels = {}
    atomic_number = None
    with open(_ATOMIC_DATA_FILE) as f:
        for line in f:
            if "|" not in line or line.lstrip().startswith("#"):
                continue
            parts = [p.strip() for p in line.split("|")]
            if len(parts) < 4 or not parts[0].isdigit():
                continue
            sym = parts[1].split()[0] if parts[1] else ""
            if sym != element:
                continue
            charge = int(parts[2].lstrip("+") or 0)
            match = re.search(r"(\d+\.?\d*)", parts[3])
            if match is None:
                continue
            levels[charge] = float(match.group(1))
            atomic_number = int(parts[0])
    if not levels:
        _cached_energies[element] = None
        return None
    energies = np.zeros(atomic_number)
    for lvl in range(atomic_number):
        if lvl not in levels:
            raise ValueError(f"atomic_data.txt is missing level {lvl} of "
                             f"{element}")
        energies[lvl] = e * levels[lvl]
    _cached_energies[element] = energies
    return energies


@dataclass(frozen=True)
class IonizerConfig:
    """Static ionization settings of one species."""
    element: str
    level_start: int
    level_max: int
    target_index: int          # species index receiving the electrons
    buffer_size: int = 8192    # most electrons created per step
    # Per-level routing (reference ionizer.py:123-146): one species index
    # per ionizable level from level_start to level_max - 1; empty: all
    # electrons go to target_index
    per_level_targets: tuple = ()

    @property
    def targets(self):
        """Every species index that receives electrons."""
        return tuple(self.per_level_targets) or (self.target_index,)


@dataclass
class IonizerAux:
    """ADK coefficients, one element per ionization level (tensors of
    the working dtype on the simulation's device)."""
    adk_log_prefactor: torch.Tensor
    adk_power: torch.Tensor
    adk_exp_prefactor: torch.Tensor


def build_ionizer_aux(element, dt, level_max=None, *, device,
                      dtype=torch.float64):
    """The ADK prefactor arrays, computed on the host in float64 and
    rounded to ``dtype``; returns (aux, number of levels).

    Math: Chen JCP 2013 eq. (2); reference ionizer.py:157-208."""
    from scipy.special import gamma as gamma_fn
    Uion = get_ionization_energies(element)
    if Uion is None:
        raise ValueError(
            "Unknown ionizable element %s. Use the atomic symbol "
            "(e.g. 'He', not 'Helium')." % element)
    if level_max is not None and level_max > len(Uion):
        raise ValueError(
            "level_max for %s cannot exceed %d" % (element, len(Uion)))

    wa = ALPHA_FS**3 * c / R_E
    Ea = m_e * c**2 / e * ALPHA_FS**4 / R_E
    UH = UH_EV * e
    Z = np.arange(len(Uion)) + 1
    n_eff = Z * np.sqrt(UH / Uion)
    l_eff = n_eff[0] - 1
    C2 = 2 ** (2 * n_eff) / (
        n_eff * gamma_fn(n_eff + l_eff + 1) * gamma_fn(n_eff - l_eff))
    adk_power = -(2 * n_eff - 1)
    adk_log_prefactor = (
        np.log(dt * wa * C2 * (Uion / (2 * UH)))
        + (2 * n_eff - 1) * np.log(2 * (Uion / UH) ** 1.5 * Ea))
    adk_exp_prefactor = -2.0 / 3 * (Uion / UH) ** 1.5 * Ea

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return IonizerAux(adk_log_prefactor=dev(adk_log_prefactor),
                      adk_power=dev(adk_power),
                      adk_exp_prefactor=dev(adk_exp_prefactor)), len(Uion)


def ionize(sp, E, B, cfg: IonizerConfig, aux: IonizerAux, draw):
    """One ionization step of one species.

    sp: a ParticleState with ionization_level; E, B: the per-particle
    (Ex, Ey, Ez), (Bx, By, Bz); draw: one uniform draw in [0, 1) per
    slot.  Returns (the new levels, the creation buffer): a dict of
    (buffer_size,) tensors, the electrons in slot order with w = 0
    past them, each with its ion's position, momentum and weight (recoil
    neglected, as in the reference) and the ion's level BEFORE this
    ionization (``level``, for the per-level routing)."""
    ux, uy, uz = sp.ux, sp.uy, sp.uz
    Ex, Ey, Ez = E
    cBx, cBy, cBz = c * B[0], c * B[1], c * B[2]

    # E-field amplitude in the ion rest frame
    u_dot_E = ux * Ex + uy * Ey + uz * Ez
    gamma = torch.sqrt(1 + ux**2 + uy**2 + uz**2)
    E2 = (-(u_dot_E) ** 2
          + (gamma * Ex + uy * cBz - uz * cBy) ** 2
          + (gamma * Ey + uz * cBx - ux * cBz) ** 2
          + (gamma * Ez + ux * cBy - uy * cBx) ** 2)
    E_amp = torch.sqrt(torch.clamp(E2, min=0.0))

    level = sp.ionization_level
    lvl_idx = torch.clamp(level, 0, aux.adk_log_prefactor.shape[0] - 1).long()
    log_prefactor = aux.adk_log_prefactor[lvl_idx]
    power = aux.adk_power[lvl_idx]
    exp_prefactor = aux.adk_exp_prefactor[lvl_idx]

    has_E = E_amp > 0
    safe_E = torch.where(has_E, E_amp, torch.ones_like(E_amp))
    log_w_dtau = (log_prefactor + power * torch.log(safe_E)
                  + exp_prefactor / safe_E - torch.log(gamma))
    w_dtau = torch.exp(torch.clamp(log_w_dtau, max=60.0))
    p = torch.where(has_E, 1.0 - torch.exp(-w_dtau),
                    torch.zeros_like(w_dtau))

    ionized = (sp.w != 0) & (level < cfg.level_max) & (draw < p)
    new_level = torch.where(ionized, level + 1, level)
    arrays = {name: getattr(sp, name) for name in BUFFER_FIELDS}
    arrays["level"] = level.to(torch.int32)
    new, _, _ = topk_compact(ionized, cfg.buffer_size, arrays)
    return new_level, new


def select_level_electrons(new, level):
    """The electrons of one birth level, packed to the front of a buffer
    of the same size (w = 0 past them); without ``level``."""
    mask = (new["w"] != 0) & (new["level"] == level)
    return topk_compact(mask, new["w"].shape[0],
                        {name: new[name] for name in BUFFER_FIELDS})[0]
