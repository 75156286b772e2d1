"""The numbers that decide ``correct``: the gaps between the program's
states and the plain reference's, read from host copies (state_io.py).

``eb_gap``: for each complex (Nm, Nz, Nr) E and B field (spectral and
interpolation grids), the largest |program - reference| over the
largest |reference| of its group on its grid: the z component alone,
the two transverse components (r and t, or + and -) together, since
one of them cancels out where the field is polarized (the + or -
component of a linearly polarized laser); the largest of these.

``position_gap``: the live macroparticles' moments w, w x and w y (x,
y, z with their Kahan words), each deposited by linear weights on the
global (z, r) grid in float64, which is independent of the order and
the slabs the program keeps its particles in; a moment's largest
|program - reference| over the largest reference moment of the
magnitude it is made of (w; w r for w x and w y: a moment of a quantity
that cancels over a ring of particles has no scale of its own); the
largest of these.  A particle lost, gained or moved changes a moment;
the linear weights keep rounding from jumping between cells.

Recorded beside them and not compared (PERF.md: the control does not
move them, so no limit would hold): ``j_rho_gap``, the same for J and
rho, each over the largest of its group (J: its three components, rho:
rho_prev and rho_next), and ``momentum_gap``, the moments w ux, w uy,
w uz over the largest w |u|."""
import torch

#: The E and B fields, by the group whose largest value scales them:
#: the two transverse components of a field together, its z component
#: alone
EB = {"Ep": "E_perp", "Em": "E_perp", "Er": "E_perp", "Et": "E_perp",
      "Ez": "Ez", "Bp": "B_perp", "Bm": "B_perp", "Br": "B_perp",
      "Bt": "B_perp", "Bz": "Bz"}
#: The J and rho fields, likewise
J_RHO = {"Jp": "J", "Jm": "J", "Jz": "J", "rho_prev": "rho",
         "rho_next": "rho"}
#: Each compared field's scale group (on its own grid)
SCALE_GROUP = {**EB, **J_RHO}
POSITION_MOMENTS = ("w", "w_x", "w_y")
MOMENTUM_MOMENTS = ("w_ux", "w_uy", "w_uz")
MOMENTS = POSITION_MOMENTS + MOMENTUM_MOMENTS
#: The moment whose largest value scales each moment's gap
SCALE_OF = {"w": "w", "w_x": "w_r", "w_y": "w_r", "w_ux": "w_u",
            "w_uy": "w_u", "w_uz": "w_u"}


def rel_gap(p, r, scale=None):
    """max |p - r| / scale, the scale max |r| by default (0 when the
    difference and the scale are 0; inf when the scale alone is 0 or
    the shapes differ)."""
    if p.shape != r.shape:
        return float("inf")
    d = (p.to(torch.complex128) - r.to(torch.complex128)).abs().max().item()
    if scale is None:
        scale = r.abs().max().item()
    if scale == 0:
        return 0.0 if d == 0 else float("inf")
    return d / scale


def field_gaps(P, R):
    """{(grid, field name): gap} of every compared field that both
    states hold, over its scale group's largest |reference| on its grid.
    P, R: lists of states (one a slab): a field's gap is the largest over
    the slabs, its scale the largest over the slabs (a slab without the
    laser holds fields 1e-7 of the laser's)."""
    scale, diff = {}, {}
    for p, r in zip(P, R):
        for grid in ("spect", "interp"):
            pf, rf = p[grid].values, r[grid].values
            for n in pf:
                if n not in SCALE_GROUP or pf[n] is None \
                        or rf.get(n) is None:
                    continue
                key, g = (grid, n), (grid, SCALE_GROUP[n])
                scale[g] = max(scale.get(g, 0.0), rf[n].abs().max().item())
                if pf[n].shape != rf[n].shape:
                    diff[key] = float("inf")
                    continue
                d = (pf[n].to(torch.complex128)
                     - rf[n].to(torch.complex128)).abs().max().item()
                diff[key] = max(diff.get(key, 0.0), d)
    out = {}
    for (grid, n), d in diff.items():
        s = scale[(grid, SCALE_GROUP[n])]
        out[(grid, n)] = (d / s if s > 0 else
                          0.0 if d == 0 else float("inf"))
    return out


def position(sp, axis):
    """A coordinate in float64, its Kahan word added."""
    x = sp[axis].to(torch.float64)
    comp = sp.values.get(f"comp_{axis}")
    return x if comp is None else x + comp.to(torch.float64)


def moments(states, zmin, dz, Nz, dr, Nr):
    """{moment: (Nz + 2) * (Nr + 2) float64 grid} of all live particles of
    every species of ``states`` (host Records of SimStates), by linear
    weights in z (cells of dz from zmin) and r (cells of dr from the
    axis), clamped to the grid."""
    out = {m: torch.zeros((Nz + 2) * (Nr + 2), dtype=torch.float64)
           for m in MOMENTS + ("w_r", "w_u")}
    for sp in (sp for st in states for sp in st["species"]):
        w = sp["w"].to(torch.float64)
        live = w != 0
        x, y, z = (position(sp, a)[live] for a in ("x", "y", "z"))
        w = w[live]
        ux, uy, uz = (sp[a].to(torch.float64)[live]
                      for a in ("ux", "uy", "uz"))
        vals = {"w": w, "w_x": w * x, "w_y": w * y, "w_ux": w * ux,
                "w_uy": w * uy, "w_uz": w * uz,
                "w_r": w * torch.sqrt(x * x + y * y),
                "w_u": w * torch.sqrt(ux * ux + uy * uy + uz * uz)}
        uz = ((z - float(zmin)) / dz).clamp(0.0, Nz + 1 - 1e-9)
        ur = (torch.sqrt(x * x + y * y) / dr).clamp(0.0, Nr + 1 - 1e-9)
        iz, ir = uz.floor(), ur.floor()
        fz, fr = uz - iz, ur - ir
        iz, ir = iz.long(), ir.long()
        for dzi, sz in ((0, 1 - fz), (1, fz)):
            for dri, sr in ((0, 1 - fr), (1, fr)):
                idx = (iz + dzi).clamp(max=Nz + 1) * (Nr + 2) \
                    + (ir + dri).clamp(max=Nr + 1)
                s = sz * sr
                for m, v in vals.items():
                    out[m].index_add_(0, idx, v * s)
    return out


def particle_gaps(P, R, zmin, dz, Nz, dr, Nr):
    """{moment: gap} of the program's states P against the reference's
    R (lists: every slab's particles together), binned on one grid."""
    mp = moments(P, zmin, dz, Nz, dr, Nr)
    mr = moments(R, zmin, dz, Nz, dr, Nr)
    return {m: rel_gap(mp[m], mr[m], mr[SCALE_OF[m]].abs().max().item())
            for m in MOMENTS}


def live_count(states):
    return sum(int((sp["w"] != 0).sum()) for st in states
               for sp in st["species"])


def gaps(P, R, grid):
    """The gaps of the program's states P against the reference's R
    (lists of host Records of SimStates: one, or one a slab; the fields
    of each slab on its own grid, scaled by the largest over all slabs,
    and the particles of all slabs together):
    "eb_gap", "position_gap", "j_rho_gap", "momentum_gap" and, in
    "detail", every field's (the largest over the slabs) and moment's
    own gap.  ``grid``: (dz, Nz, dr, Nr) of the global internal grid."""
    dz, Nz, dr, Nr = grid
    if len(P) != len(R):
        raise ValueError("the program and the reference hold different "
                         "numbers of slabs")
    fg = field_gaps(P, R)
    pg = particle_gaps(P, R, R[0]["zmin"], dz, Nz, dr, Nr)

    def largest(values):
        values = list(values)
        return max(values) if values else float("inf")
    return dict(
        eb_gap=largest(g for (_, n), g in fg.items() if n in EB),
        position_gap=largest(pg[m] for m in POSITION_MOMENTS),
        j_rho_gap=largest(g for (_, n), g in fg.items() if n in J_RHO),
        momentum_gap=largest(pg[m] for m in MOMENTUM_MOMENTS),
        detail={**{f"{g}.{n}": v for (g, n), v in fg.items()},
                **{f"moment.{m}": v for m, v in pg.items()},
                "live_program": live_count(P),
                "live_reference": live_count(R)})
