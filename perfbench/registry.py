"""Find a cell's parts by the names in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel sits in files of its own, found by name:

- ``configs/<config>.json`` (its values, ``source``, ``assumed``,
  ``reduced``) and the builder it names (``configs/<config>.py``);
- ``traffic/<traffic>.json``, read by the one window loop of harness.py;
- ``metrics/<metric>.py``, a reader ``read(ctx)`` of one per-layer
  metric;
- ``roofline/<kernel>.py``, the work counter of one kernel;
- ``checks/<workload>.json``, the limits of the numbers that decide a
  cell's ``correct``.

A later change adds a cell, metric or configuration as new files and
entries, and edits none of these files."""
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    """BENCHMARK.json of the checkout."""
    return load_json(Path(root) / "BENCHMARK.json")


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name):
    """A configuration's values (configs/<name>.json)."""
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name):
    """A traffic mix's parameters (traffic/<name>.json)."""
    return load_json(HERE / "traffic" / f"{name}.json")


def checks(workload_name):
    """The limits of a cell's compared numbers (checks/<workload>.json)."""
    return load_json(HERE / "checks" / f"{workload_name}.json")


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def builder(cfg):
    """The module whose ``build(api, cfg, random_seed, device, dtype)``
    builds the configuration's Simulation on an API namespace."""
    path = HERE / "configs" / cfg["builder"]
    return _module(path, f"perfbench_config_{path.stem}")


def metric_reader(name):
    """The reader of per-layer metric ``name`` (metrics/<name>.py)."""
    path = HERE / "metrics" / f"{name}.py"
    return _module(path, "perfbench_metric_" + name.replace(".", "_"))


def roofline(kernel):
    """The work counter of ``kernel`` (roofline/<kernel>.py)."""
    path = HERE / "roofline" / f"{kernel}.py"
    return _module(path, f"perfbench_roofline_{kernel}")


def end_to_end(bench, wl_name):
    """The end-to-end metrics that cell ``wl_name`` reports."""
    return [m for m in bench["end_to_end"]
            if wl_name in m.get("workloads", [wl_name])]


def per_layer(bench, wl_name):
    """The per-layer metrics that cell ``wl_name`` reports (a metric
    without ``workloads`` in every cell that reports the end-to-end
    metric it moves)."""
    e2e = {m["name"] for m in end_to_end(bench, wl_name)}
    return [m for m in bench["per_layer"]
            if (wl_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
