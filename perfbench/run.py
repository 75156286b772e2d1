"""Run one cell of the benchmark once, from the repository root:

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (one JSON object); the
compared numbers, each beside its limit, are the last lines of standard
error.  A run exits with another code than 0, and prints no result,
without CUDA or with fewer cards than the cell asks for, when JAX or
fbpic_tpu was loaded, or when the program is not there.  ``--control
tf32`` runs the control of ``correct`` instead (the plain reference in
TF32 in the program's place; see README.md); the benchmark's own runs
never pass it."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Build and kernel caches, at fixed paths inside the checkout
CACHE = ROOT / ".perfbench_cache"


def set_environment():
    """Caches inside the checkout; nothing may load JAX by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",), default=None)
    return p.parse_args(argv)


def power_limits():
    """The cards' names and power limits, as nvidia-smi reads them (a
    roofline share is stated against the published peak at 700 W)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read ({err})"
    return "; ".join(out.stdout.strip().splitlines()) or "not read"


def fail(msg, code=3):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    args = parse(argv)
    set_environment()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import harness, registry
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: no result")
    if torch.cuda.device_count() < wl["chips"]:
        fail(f"{wl['name']} needs {wl['chips']} cards, "
             f"{torch.cuda.device_count()} present: no result")
    torch.set_num_threads(4)
    result = harness.run_cell(bench, wl, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START,
                              devices=[f"cuda:{i}" for i in range(wl["chips"])],
                              control=args.control == "tf32")
    forbidden = result.pop("_forbidden")
    detail = result.pop("_detail")
    late = harness.forbidden_modules()
    if forbidden or late:
        fail(f"forbidden modules loaded: {sorted(set(forbidden + late))}")
    kind = torch.cuda.get_device_name(0)
    result["device"] = dict(platform="gpu", kind=kind, count=wl["chips"],
                            **result["device"])
    checks = result.pop("checks")
    result["checks"] = checks
    print("detail: " + json.dumps(detail), file=sys.stderr)
    print(f"cards: {power_limits()}", file=sys.stderr)
    if args.control:
        print(f"control {args.control}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
