#!/usr/bin/env python3
"""Time the kernels of fbpic_tpu_torch under variants of their
constants, inside one process tree on one card: K1 and K3 under those
of csrc/contract_common.cuh, or (--gather) K2 under those of
csrc/gather.cu.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/torch_tune_contract.py                 # the defaults
    python3 tools/torch_tune_contract.py RG=2 "RG=8,TP=128" MIN_BLOCKS=2
    python3 tools/torch_tune_contract.py PROBE=1,nocheck PROBE=2,nocheck
    python3 tools/torch_tune_contract.py --gather BZ_MAX=2 N_THREADS=512

Each argument is one variant: comma-separated NAME=VALUE pairs that
replace `constexpr int NAME = ...;` in a copy of the source (BZ_MAX also
in the copy of particles/cuda_gather.py, whose `pick_bz` reads it;
SOURCE=path, first in a variant, takes the whole source from that file
of the checkout instead, to time another design; the word `nocheck`
among them turns the comparison with the plain version off, for a
variant that leaves work out on purpose).  For every variant
(the unchanged sources first and last) the script copies the package
and chip_smoke.py into a scratch directory, patches the copies, and runs
this file there with --measure, which builds the kernels and runs
chip_smoke's phase_k1 / phase_k3 (or phase_k2: kernel against plain
version, bit-equal launches, CUDA-event times, the bounds) at the LWFA
bench and boosted-frame shapes, then the same kernels on the resident
layouts after five steps of each simulation.  Nothing in the package
reads these variants: the shipped constants are the sources'.
"""
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(check=True, gather=False):
    sys.path.insert(0, str(Path.cwd()))
    import torch
    import chip_smoke as cs
    if not check:   # a variant that times a deliberately incomplete kernel
        cs.TOL_K1 = float("inf")
        cs.TOL_K2 = {k: float("inf") for k in cs.TOL_K2}
        cs.TOL_K3 = {k: float("inf") for k in cs.TOL_K3}
    from fbpic_tpu_torch.utils import kernels
    for name, log in kernels.build_all().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    if gather:
        sim = cs.make_sim()
        k2 = cs.phase_k2(sim)
        sim.step(5)
        k2r = cs.phase_k2_resident(sim, "resident LWFA layout")
        del sim
        torch.cuda.empty_cache()
        bsim = cs.make_boosted_sim()
        bsim.step(5)
        k2b = cs.phase_k2_resident(bsim, "resident boosted layout")
        print("RESULT " + json.dumps(dict(
            K2=k2["ms"], K2_resident=k2r["ms"], K2_boosted=k2b["ms"])),
            flush=True)
        return
    sim = cs.make_sim()
    k1 = cs.phase_k1(sim)
    sim.step(5)
    k1r = cs.phase_k1_resident(sim)
    del sim
    torch.cuda.empty_cache()
    bsim = cs.make_boosted_sim()
    k3 = cs.phase_k3(bsim)
    bsim.step(5)
    k3r = cs.phase_k3_resident(bsim)
    print("RESULT " + json.dumps(dict(
        K1=k1["ms"], K1_bmm=k1["library_ms"], K1_resident=k1r["ms"],
        K3_J=k3["windows_ms"][0], K3_rho=k3["windows_ms"][1],
        K3_bmm=k3["windows_library_ms"],
        K3_resident=k3r["windows_ms"])), flush=True)


def run_variant(spec, gather):
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        shutil.copytree(ROOT / "fbpic_tpu_torch", tmp / "fbpic_tpu_torch",
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp / "chip_smoke.py")
        pkg = tmp / "fbpic_tpu_torch"
        source = pkg / "csrc" / ("gather.cu" if gather
                                 else "contract_common.cuh")
        text = source.read_text()
        pairs = [p for p in spec.split(",") if p and p != "nocheck"]
        for pair in pairs:
            name, value = pair.split("=")
            if name == "SOURCE":     # another version of the whole file
                text = (ROOT / value).read_text()
                continue
            text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                              rf"\g<1>{value};", text)
            if n != 1:
                raise SystemExit(f"no constant {name} in {source.name}")
            if name == "BZ_MAX":
                py = pkg / "particles" / "cuda_gather.py"
                py.write_text(re.sub(r"(?m)^BZ_MAX = \d+$",
                                     f"BZ_MAX = {value}", py.read_text()))
        source.write_text(text)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--measure-unchecked" if "nocheck" in spec else "--measure"]
            + (["--gather"] if gather else []),
            cwd=tmp, capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        if proc.returncode != 0:
            print(f"[{spec or 'shipped'}] FAILED\n" + "\n".join(lines[-15:])
                  + "\n" + proc.stderr[-2000:], flush=True)
            return
        for line in lines:
            if line.startswith(("RESULT", "  fused", "  dense", "  gather")):
                print(f"[{spec or 'shipped'}] {line}", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    gather = "--gather" in args
    args = [a for a in args if a != "--gather"]
    if args in (["--measure"], ["--measure-unchecked"]):
        measure(check=args[0] == "--measure", gather=gather)
    else:
        for spec in [""] + args + [""]:
            run_variant(spec, gather)
