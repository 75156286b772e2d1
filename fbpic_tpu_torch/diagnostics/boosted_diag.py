"""Back-transformed (boosted-frame -> lab-frame) diagnostics.

For a simulation running in a boosted frame, these diagnostics fill
fixed-t_lab snapshots on the fly: every boosted-frame step, the plane
where each snapshot's lab time meets the current boosted time is
located in the box, the fields (or the particles that crossed it) are
taken there, Lorentz-transformed to the lab frame and written into the
snapshot's lab-frame grid.

Fields: the (snapshots, Nm, Nr) slices of every field are taken on the
device after every cycle -- E and B interpolated between two z rows of
the interpolation grid, rho and J from a single-column inverse
transform of the spectral fields (the interpolated inverse-DFT rows,
then the radial transform) -- with no host synchronization.  Where
``Simulation.step`` runs the chunk runner, the function of
``device_capture`` takes them inside each step (a replayed CUDA graph
included) into the runner's buffer, whose rows the runner copies to the
host with the chunk's one read, and ``process_chunk`` fills the
snapshots from them, as fbpic_tpu's ``device_capture`` +
``process_chunk`` do; on a z-decomposed run ``decomposed_capture``
gives the slab runner's function.  In the eager loop ``capture`` appends them to a
buffer of this diagnostic's after every cycle, which
``process_captures`` copies to the host once (at the end of ``step``,
or when it holds ``core/simulation.py``'s ``MAX_CAPTURE`` cycles).  A
filled snapshot is written as one openPMD file (``collect_snapshot``
gives its records, ``write_records`` writes them with h5py).

Particles: the crossing mask is computed on the device; only the
particles that crossed one of the planes are copied to the host.
"""
import numpy as np
import torch

from ..constants import c
from ..fields import transform as tr
from .generic import OpenPMDDiagnostic, Records
from .field_diag import stack_modes
from .particle_diag import species_arrays_records

#: Field names computed by a row interpolation of the interp grid
_EB = ("Er", "Et", "Ez", "Br", "Bt", "Bz")


class LabSnapshot(object):
    """One fixed-t_lab snapshot being accumulated (host numpy)."""

    def __init__(self, t_lab, zmin_lab, zmax_lab, dz_lab, Nr, Nm,
                 fieldtypes):
        self.t_lab = t_lab
        self.zmin_lab = zmin_lab
        self.zmax_lab = zmax_lab
        self.dz_lab = dz_lab
        self.Nz_lab = int(round((zmax_lab - zmin_lab) / dz_lab))
        self.names = []
        for ftype in fieldtypes:
            if ftype in ("E", "B", "J"):
                self.names += [ftype + comp for comp in "rtz"]
            else:
                self.names.append(ftype)
        # (Nm, Nz_lab, Nr) complex buffer of each field
        self.data = {name: np.zeros((Nm, self.Nz_lab, Nr), complex)
                     for name in self.names}
        self.filled = np.zeros(self.Nz_lab, bool)
        self.written = False


class BackTransformedFieldDiagnostic(OpenPMDDiagnostic):
    """Accumulates lab-frame field snapshots from a boosted-frame run.

    zmin_lab, zmax_lab: lab-frame z range of each snapshot; v_lab: speed
    of the snapshot window in the lab frame; dt_snapshots_lab: lab time
    between snapshots; Ntot_snapshots_lab: number of snapshots;
    gamma_boost: Lorentz factor of the frame (reference API:
    boosted_field_diag.py:25-120).  Every cycle is captured, whatever
    ``period``, as in fbpic_tpu.
    """

    def __init__(self, zmin_lab, zmax_lab, v_lab, dt_snapshots_lab,
                 Ntot_snapshots_lab, gamma_boost, period=1, sim=None,
                 fldobject=None, comm=None,
                 fieldtypes=("rho", "E", "B", "J"), write_dir=None):
        sim = sim or fldobject
        OpenPMDDiagnostic.__init__(self, period, comm, write_dir,
                                   dt_sim=sim.dt if sim else None)
        self.sim = sim
        self.gamma_boost = gamma_boost
        self.beta_boost = np.sqrt(1.0 - 1.0 / gamma_boost**2)
        self.fieldtypes = list(fieldtypes)
        cfg = sim.config
        self.dz_lab = cfg.dz * gamma_boost * (1.0 + self.beta_boost)
        self.dt_snapshots_lab = dt_snapshots_lab
        self.snapshots = []
        for i in range(Ntot_snapshots_lab):
            t_lab = i * dt_snapshots_lab
            self.snapshots.append(LabSnapshot(
                t_lab, zmin_lab + v_lab * t_lab, zmax_lab + v_lab * t_lab,
                self.dz_lab, cfg.Nr, cfg.Nm, self.fieldtypes))
        self.names = list(self.snapshots[0].names) if self.snapshots else []
        self._t_lab = {}         # (S,) tensor per (device, dtype)
        self._buf = None         # (valid, z_lab, slices) device buffers
        self._n = 0              # cycles in the buffer

    # -----------------------------------------------------------------
    def write(self, sim):
        """At the start of ``step``: the slices of the current state,
        consumed at once (fbpic_tpu takes them on the host there, valid
        where the plane's lower row lies in [0, Nz - 2])."""
        if isinstance(sim, int) or not self.snapshots:
            return
        self.capture(sim, capacity=1, strict=True)
        self.process_captures(sim)

    def capture_slices(self, sim, strict=False):
        """The planes of the current state, on the device: ``valid``
        (S,) bool, ``z_lab`` (S,) and ``slices`` (F, Nm, S, Nr) complex,
        F in ``self.names`` order (fbpic_tpu boosted_diag.py:193-247).
        ``strict``: a plane at the last row's centre is not valid."""
        return self._slices(sim.config, sim.state, sim.aux.mats, strict)

    def device_capture(self):
        """The capture function of the chunk runner
        (core/graph.py, ``make_multi_step_capture``; fbpic_tpu's
        ``device_capture()``, boosted_diag.py:144-262, on one device):
        ``cap(state, aux, time, zmin)`` returns ``capture_slices``' three
        tensors of a state whose time and grid edge are the 0-d tensors
        ``time`` and ``zmin`` (the runner's table row: a replayed step
        reads its own), with no host read.  ``process_chunk`` consumes
        the rows the runner stacks."""
        cfg = self.sim.config

        def cap(state, aux, time, zmin):
            return self._slices(cfg, state, aux.mats, time=time, zmin=zmin)
        return cap

    def decomposed_capture(self, config_local):
        """The capture function of one slab of a z-decomposed run
        (fbpic_tpu's ``device_capture(config, mats, own, axis_name)``,
        boosted_diag.py:145-260), ``cap(state, aux, comm)``: each slab
        slices the interior it owns (state.zmin its local edge; its time
        and edge may be 0-d tensors, a chunk table's row), the slices of
        the planes it does not claim zeroed -- the interiors tile the
        global box, so at most one slab claims a plane -- and the slices
        are summed over the slabs in rank order.  Returns ``(claimed,
        z_lab, slices)`` as ``device_capture``'s function does, with no
        host synchronization; the slab runner (parallel/domain.py
        ``SlabMultiStep``) writes slab 0's into its buffers at the device
        step index and ``process_chunk`` consumes the rows."""
        if not self.snapshots:
            return lambda state, aux, comm: None
        g = config_local.n_guard

        def cap(state, aux, comm):
            own = (g, config_local.Nz - 2 * g, comm.rank, comm.size)
            valid, z_lab, slices = self._slices(config_local, state,
                                                aux.mats, own=own)
            mask = valid.to(slices.real.dtype)[None, None, :, None]
            slices, n_claims = comm.psum([slices * mask,
                                          valid.to(torch.int32)])
            return n_claims > 0, z_lab, slices
        return cap

    def _slices(self, cfg, st, mats, strict=False, own=None, time=None,
                zmin=None):
        """capture_slices of a state on grid ``cfg`` with radial
        matrices ``mats``; ``own`` = (g, Nz_int, rank, size) on a slab:
        a plane is valid where this slab owns it (the edge slabs' claims
        opened to -+inf, as fbpic_tpu widens them) inside the global
        box.  ``time``, ``zmin``: the state's as 0-d tensors of the
        working dtype (the state's own where they are tensors, else made
        from its host values, by a fill: no host-to-device copy); every
        plane's arithmetic reads them, as fbpic_tpu's traced scalars."""
        dev = st.interp.Er.device
        rdt = st.interp.Er.real.dtype
        t_lab = self._t_lab.get((dev, rdt))
        if t_lab is None:
            # i * dt_snapshots_lab in float64, made on the device: a
            # host-to-device copy would synchronize
            t_lab = self._t_lab[(dev, rdt)] = (
                torch.arange(len(self.snapshots), device=dev,
                             dtype=torch.float64)
                * self.dt_snapshots_lab).to(rdt)
        gamma, beta = self.gamma_boost, self.beta_boost
        Nz, S = cfg.Nz, len(self.snapshots)
        if time is None:
            time = st.time if torch.is_tensor(st.time) else torch.full(
                (), float(st.time), dtype=rdt, device=dev)
        if zmin is None:
            zmin = st.zmin if torch.is_tensor(st.zmin) else torch.full(
                (), float(st.zmin), dtype=rdt, device=dev)
        t_b = time
        z_b = (t_lab / gamma - t_b) * c / beta
        z_lab = gamma * (z_b + beta * c * t_b)
        iz_f = (z_b - zmin) / cfg.dz - 0.5
        iz0 = torch.clamp(torch.floor(iz_f).long(), 0, Nz - 2)
        s1 = torch.clamp(iz_f - iz0.to(rdt), 0.0, 1.0)
        if own is None:
            valid = (iz_f >= 0.0) & ((iz_f < Nz - 1.0) if strict
                                     else (iz_f <= Nz - 1.0))
        else:
            g, Nz_int, rank, size = own
            lo = -np.inf if rank == 0 else float(g)
            hi = np.inf if rank == size - 1 else float(g + Nz_int)
            glob = iz_f + (rank * Nz_int - g)
            valid = ((iz_f >= lo) & (iz_f < hi) & (glob >= 0.0)
                     & (glob <= size * Nz_int - 1.0))
        rows = torch.cat([iz0, iz0 + 1])
        w0, w1 = (1 - s1)[:, None], s1[:, None]
        out = {}
        eb = [n for n in _EB if n in self.names]
        if eb:
            # one gather of both rows of every plane from the stacked
            # fields: a few launches, not a few per field
            g = torch.stack([getattr(st.interp, n) for n in eb]
                            ).index_select(2, rows)   # (E, Nm, 2S, Nr)
            g = w0 * g[:, :, :S] + w1 * g[:, :, S:]
            out.update(zip(eb, g.unbind(0)))
        spect = []
        if "rho" in self.names:
            spect.append(("rho", st.spect.rho_prev, "invM0"))
        if "Jr" in self.names:
            spect += [("Jp", st.spect.Jp, "invMp"),
                      ("Jm", st.spect.Jm, "invMm"),
                      ("Jz", st.spect.Jz, "invM0")]
        if spect:
            # Interpolated inverse-DFT rows (S, Nz): x[n] = sum_k
            # exp(2 pi i n k / Nz) X[k] / Nz, the phase reduced mod Nz
            # in integers first; then one GEMM over every spectral
            # field's (Nm, Nr) columns and one batched radial transform
            k = torch.arange(Nz, device=dev)
            ph = torch.remainder(rows[:, None] * k[None, :], Nz).to(rdt) \
                * (2 * np.pi / Nz)
            W = torch.polar(torch.full_like(ph, 1.0 / Nz), ph)
            W = w0 * W[:S] + w1 * W[S:]
            n_f = len(spect)
            G = torch.stack([G.transpose(0, 1) for _, G, _ in spect],
                            dim=2)                    # (Nz, Nm, F, Nr)
            Nm, Nr = G.shape[1], G.shape[3]
            cols = torch.matmul(W, G.reshape(Nz, -1))
            cols = cols.reshape(S, Nm, n_f, Nr).permute(2, 1, 0, 3)
            mats = torch.stack([getattr(mats, M) for _, _, M in spect])
            F = tr.dht(mats, cols)                   # (F, Nm, S, Nr)
            F = dict(zip([n for n, _, _ in spect], F.unbind(0)))
            if "rho" in F:
                out["rho"] = F["rho"]
            if "Jp" in F:
                out["Jr"], out["Jt"] = tr.pm_to_rt(F["Jp"], F["Jm"])
                out["Jz"] = F["Jz"]
        slices = torch.stack([out[name] for name in self.names])
        return valid, z_lab, slices

    def capture(self, sim, capacity=1, strict=False):
        """Append the current state's slices to the device buffer (made
        for ``capacity`` cycles when there is none); consume the buffer
        when it is full."""
        if not self.snapshots:
            return
        self._append(self.capture_slices(sim, strict), capacity)
        if self._n == self._buf[0].shape[0]:
            self.process_captures(sim)

    def _append(self, captured, capacity):
        """Append (valid, z_lab, slices) to the device buffer (made for
        ``capacity`` cycles when there is none)."""
        if self._buf is None:
            self._buf = tuple(torch.empty((capacity,) + t.shape,
                                          dtype=t.dtype, device=t.device)
                              for t in captured)
            self._n = 0
        for buf, t in zip(self._buf, captured):
            buf[self._n] = t
        self._n += 1

    def process_captures(self, sim):
        """Copy the buffered captures to the host (one synchronization:
        the three copies queued, then one wait for the stream) and fill
        the snapshots."""
        if self._buf is None:
            return
        caps = [b[:self._n].to("cpu", non_blocking=True) for b in self._buf]
        if self._buf[0].is_cuda:
            torch.cuda.current_stream(self._buf[0].device).synchronize()
        caps = tuple(t.numpy() for t in caps)
        self._buf, self._n = None, 0
        self.process_chunk(sim, caps)

    def process_chunk(self, sim, caps):
        """Fill the snapshots from T captured cycles: ``caps`` = (valid,
        z_lab, slices), numpy (T, S), (T, S) and (T, F, Nm, S, Nr) (the
        capture function's outputs stacked over the cycles); write the
        snapshots that are full."""
        valid, z_lab, stacked = caps
        slices = {name: stacked[:, f] for f, name in enumerate(self.names)}
        for t in range(valid.shape[0]):
            for si, snap in enumerate(self.snapshots):
                if snap.written or not valid[t, si]:
                    continue
                zl = z_lab[t, si]
                if zl < snap.zmin_lab or zl >= snap.zmax_lab:
                    continue
                slc = self._to_lab_frame(
                    {name: slices[name][t, :, si, :] for name in snap.names})
                iz_lab = int((zl - snap.zmin_lab) / snap.dz_lab)
                if 0 <= iz_lab < snap.Nz_lab:
                    for name in snap.names:
                        snap.data[name][:, iz_lab, :] = slc[name]
                    snap.filled[iz_lab] = True
        for i, snap in enumerate(self.snapshots):
            if snap.filled.all() and not snap.written:
                self.flush_snapshot(i, snap)
                snap.written = True

    def _to_lab_frame(self, slc):
        """Lorentz transform with -beta (reference:
        boosted_field_diag.py:694-742)."""
        gamma = self.gamma_boost
        cbeta = c * self.beta_boost
        beta_c = self.beta_boost / c
        out = dict(slc)
        if "Er" in slc and "Bt" in slc:
            out["Er"] = gamma * (slc["Er"] + cbeta * slc["Bt"])
            out["Bt"] = gamma * (slc["Bt"] + beta_c * slc["Er"])
        if "Et" in slc and "Br" in slc:
            out["Et"] = gamma * (slc["Et"] - cbeta * slc["Br"])
            out["Br"] = gamma * (slc["Br"] - beta_c * slc["Et"])
        if "rho" in slc and "Jz" in slc:
            out["rho"] = gamma * (slc["rho"] + beta_c * slc["Jz"])
            out["Jz"] = gamma * (slc["Jz"] + cbeta * slc["rho"])
        return out

    # -----------------------------------------------------------------
    def collect_snapshot(self, i, snap):
        """{file name: Records} of lab snapshot ``i``."""
        rec = Records()
        self.setup_openpmd_file(rec, i, snap.t_lab, self.dz_lab / c)
        rec.group("/data/%d/fields" % i)
        for name, data in snap.data.items():
            if name[0] in "EBJ" and name != "rho":
                path = "%s/%s" % (name[0], name[1])
            else:
                path = name
            attrs = rec.dataset("/data/%d/fields/%s" % (i, path),
                                stack_modes(data))
            attrs["unitSI"] = 1.0
            attrs["position"] = np.array([0.5, 0.5])
        return {"data%08d.h5" % i: rec}

    def flush_snapshot(self, i, snap):
        self.write_records(self.collect_snapshot(i, snap))


# Reference alias
BoostedFieldDiagnostic = BackTransformedFieldDiagnostic


class BackTransformedParticleDiagnostic(OpenPMDDiagnostic):
    """Catches particles crossing the snapshot planes, advances them
    ballistically to the crossing time and transforms them to the lab
    frame (reference: boosted_particle_diag.py:724-841).

    Each lab snapshot (fixed t_lab) is a plane moving at -c/beta in the
    boosted frame.  A particle is caught when it crossed the plane
    during the last cycle; the previous position is z - vz*dt, as in
    fbpic_tpu (the resident layout re-sorts the storage order every
    cycle, so no pairing by index).  Written every ``period`` cycles
    (fbpic_tpu: at the end of each step chunk, which stops at the
    smallest period: the same cycles for period 1).
    """

    file_mode = "w"

    def __init__(self, zmin_lab, zmax_lab, v_lab, dt_snapshots_lab,
                 Ntot_snapshots_lab, gamma_boost, period=1, sim=None,
                 species=None, comm=None, write_dir=None):
        OpenPMDDiagnostic.__init__(self, period, comm, write_dir,
                                   dt_sim=sim.dt if sim else None)
        self.sim = sim
        self.species_dict = species or {}
        self.gamma_boost = gamma_boost
        self.beta_boost = np.sqrt(1.0 - 1.0 / gamma_boost**2)
        self.snapshots = [
            dict(t_lab=i * dt_snapshots_lab, buffers=[], written=False,
                 zmin_lab=zmin_lab + v_lab * i * dt_snapshots_lab,
                 zmax_lab=zmax_lab + v_lab * i * dt_snapshots_lab)
            for i in range(Ntot_snapshots_lab)]
        self._t_last = None

    def _crossing_particles(self, view, planes, dt):
        """Host numpy arrays (storage order) of the live particles of
        ``view`` that crossed any of ``planes`` [(z_plane, z_plane_prev)]
        during the last cycle: the mask is computed on the device."""
        sp = view._sim.state.species[view._index]
        z_prev = sp.z - sp.uz * sp.inv_gamma * c * dt
        crossed = torch.zeros_like(sp.w, dtype=torch.bool)
        for zp, zpp in planes:
            crossed |= (((sp.z >= zp) & (z_prev <= zpp))
                        | ((sp.z <= zp) & (z_prev >= zpp)))
        idx = torch.nonzero(crossed & (sp.w != 0)).squeeze(1)
        cur = {k: getattr(sp, k)[idx].cpu().numpy() for k in
               ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")}
        if sp.ids is not None:
            cur["ids"] = sp.ids[idx].cpu().numpy().astype(np.uint64)
        return cur

    def write(self, sim):
        if isinstance(sim, int) or sim.iteration % self.period:
            return
        gamma, beta = self.gamma_boost, self.beta_boost
        t_b = sim.time
        dt = sim.dt
        v_plane = -c / beta
        if self._t_last is None or t_b <= self._t_last:
            # No cycle has run yet (z - vz*dt would invent a position
            # before the start), or this time was processed already
            # (step() writes the diagnostics at its start)
            self._t_last = max(t_b, self._t_last or t_b)
            return
        self._t_last = t_b
        planes = []
        for snap in self.snapshots:
            if not snap["written"]:
                # The plane moves at -c/beta in the boosted frame
                z_plane = (snap["t_lab"] / gamma - t_b) * c / beta
                planes.append((snap, z_plane, z_plane - v_plane * dt))
        for name, view in self.species_dict.items():
            if not planes:
                break
            cur = self._crossing_particles(
                view, [(zp, zpp) for _, zp, zpp in planes], dt)
            vz = cur["uz"] * cur["inv_gamma"] * c
            z_prev = cur["z"] - vz * dt
            for snap, z_plane, z_plane_prev in planes:
                crossed = ((cur["z"] >= z_plane)
                           & (z_prev <= z_plane_prev)) \
                    | ((cur["z"] <= z_plane) & (z_prev >= z_plane_prev))
                if not crossed.any():
                    continue
                sel = {k: v[crossed] for k, v in cur.items()}
                # Time at which each particle meets the moving plane,
                # then a ballistic push to that time
                # (reference: boosted_particle_diag.py:812-826)
                vz_s = sel["uz"] * sel["inv_gamma"] * c
                t_cross = t_b - (z_plane - sel["z"]) / (v_plane - vz_s)
                dtc = c * (t_cross - t_b) * sel["inv_gamma"]
                x_c = sel["x"] + dtc * sel["ux"]
                y_c = sel["y"] + dtc * sel["uy"]
                z_c = sel["z"] + dtc * sel["uz"]
                # Lorentz transform to the lab frame (inverse boost)
                gamma_p = 1.0 / sel["inv_gamma"]
                uz_lab = gamma * (sel["uz"] + beta * gamma_p)
                gamma_lab = np.sqrt(1 + sel["ux"]**2 + sel["uy"]**2
                                    + uz_lab**2)
                z_lab = gamma * (z_c + beta * c * t_cross)
                keep = (z_lab >= snap["zmin_lab"]) & \
                    (z_lab < snap["zmax_lab"])
                buf = dict(
                    x=x_c[keep], y=y_c[keep], z=z_lab[keep],
                    ux=sel["ux"][keep], uy=sel["uy"][keep],
                    uz=uz_lab[keep], w=sel["w"][keep],
                    inv_gamma=1.0 / gamma_lab[keep], species=name)
                if "ids" in sel:
                    buf["ids"] = sel["ids"][keep]
                snap["buffers"].append(buf)
        # Write the snapshots whose plane has left the box
        for i, snap in enumerate(self.snapshots):
            z_plane = (snap["t_lab"] / gamma - t_b) * c / beta
            if not snap["written"] and z_plane < sim.zmin:
                self._flush(i, snap)
                snap["written"] = True

    def collect_snapshot(self, i, snap):
        """{file name: Records} of lab snapshot ``i``."""
        rec = Records()
        self.setup_openpmd_file(rec, i, snap["t_lab"], 0.0)
        for name, view in self.species_dict.items():
            bufs = [b for b in snap["buffers"] if b["species"] == name]
            arrays = {key: (np.concatenate([b[key] for b in bufs]) if bufs
                            else np.zeros(0))
                      for key in ("x", "y", "z", "ux", "uy", "uz", "w")}
            ids = None
            if bufs and "ids" in bufs[0]:
                ids = np.concatenate([b["ids"] for b in bufs])
            species_arrays_records(
                rec, "/data/%d/particles/%s" % (i, name), arrays, view.q,
                view.m, ids=ids)
        return {"particles%08d.h5" % i: rec}

    def _flush(self, i, snap):
        self.write_records(self.collect_snapshot(i, snap))


BoostedParticleDiagnostic = BackTransformedParticleDiagnostic
