#!/usr/bin/env python3
"""Time K1 and K3 of fbpic_tpu_torch under variants of the constants of
csrc/contract_common.cuh, inside one process tree on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/torch_tune_contract.py                 # the defaults
    python3 tools/torch_tune_contract.py RG=2 "RG=8,TP=128" MIN_BLOCKS=2
    python3 tools/torch_tune_contract.py PROBE=1,nocheck PROBE=2,nocheck

Each argument is one variant: comma-separated NAME=VALUE pairs that
replace `constexpr int NAME = ...;` in a copy of the header (the word
`nocheck` among them turns the comparison with the plain version off,
for a variant that leaves work out on purpose).  For every
variant (the unchanged sources first and last) the script copies the
package and chip_smoke.py into a scratch directory, patches the copy of
the header, and runs this file there with --measure, which builds the
kernels and runs chip_smoke's phase_k1 / phase_k3 (kernel against plain
version, bit-equal launches, CUDA-event times, the one-hot bmm, the
bounds) at the LWFA bench and boosted-frame shapes, then the same
kernels on the resident layouts after five steps of each simulation.
Nothing in the package reads these variants: the shipped constants are
the header's.
"""
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(check=True):
    sys.path.insert(0, str(Path.cwd()))
    import torch
    import chip_smoke as cs
    if not check:   # a variant that times a deliberately incomplete kernel
        cs.TOL_K1 = float("inf")
        cs.TOL_K3 = {k: float("inf") for k in cs.TOL_K3}
    from fbpic_tpu_torch.utils import kernels
    for name, log in kernels.build_all().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
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


def run_variant(spec):
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        shutil.copytree(ROOT / "fbpic_tpu_torch", tmp / "fbpic_tpu_torch",
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tmp / "chip_smoke.py")
        header = tmp / "fbpic_tpu_torch" / "csrc" / "contract_common.cuh"
        text = header.read_text()
        pairs = [p for p in spec.split(",") if p and p != "nocheck"]
        for pair in pairs:
            name, value = pair.split("=")
            text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                              rf"\g<1>{value};", text)
            if n != 1:
                raise SystemExit(f"no constant {name} in the header")
        header.write_text(text)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--measure-unchecked" if "nocheck" in spec else "--measure"],
            cwd=tmp, capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        if proc.returncode != 0:
            print(f"[{spec or 'shipped'}] FAILED\n" + "\n".join(lines[-15:])
                  + "\n" + proc.stderr[-2000:], flush=True)
            return
        for line in lines:
            if line.startswith(("RESULT", "  fused", "  dense")):
                print(f"[{spec or 'shipped'}] {line}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] in (["--measure"], ["--measure-unchecked"]):
        measure(check=sys.argv[1] == "--measure")
    else:
        for spec in [""] + sys.argv[1:] + [""]:
            run_variant(spec)
