"""The benchmark finds its cells, configurations, traffic, metric
readers, work counters and limits by the names in BENCHMARK.json."""
import re

import pytest

from perfbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_names_are_unique_and_well_formed():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names)), key
        assert all(NAME.match(n) for n in names), key


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_parts(wl):
    cfg = registry.config(wl["config"])
    assert cfg["name"] == wl["config"]
    assert callable(registry.builder(cfg).build)
    traffic = registry.traffic(wl["traffic"])
    assert traffic["chunk_steps"] > 0 and traffic["warmup_steps"] >= 0
    limits = registry.checks(wl["name"])
    assert set(limits) == {"eb_gap", "position_gap", "start_eb_gap",
                           "start_position_gap", "lost_particles"}
    assert all(v["limit"] >= 0 for v in limits.values())
    e2e = {m["name"] for m in registry.end_to_end(BENCH, wl["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.per_layer(BENCH, wl["name"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_states_source_assumed_reduced(cfg):
    values = registry.config(cfg["name"])
    assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
    assert 0 < len(values["source"]) <= 200 and "FBPIC" in values["source"]
    assert values["reduced"] == cfg["reduced"]
    assert all(k in values for k in values["reduced"])
    assert values["assumed"]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_a_reader(metric):
    assert callable(registry.metric_reader(metric["name"]).read)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    for wl in metric.get("workloads", []):
        registry.workload(BENCH, wl)
        assert metric["moves"] in {
            m["name"] for m in registry.end_to_end(BENCH, wl)}


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3"])
def test_each_work_counter_names_its_kernel(kernel):
    counter = registry.roofline(kernel)
    assert isinstance(counter.KERNEL, str) and callable(counter.work)
    assert callable(registry.metric_reader(f"{kernel}_roofline").read)


@pytest.mark.parametrize(
    "metric", [m for m in BENCH["per_layer"]
               if m["name"].endswith("_roofline")], ids=lambda m: m["name"])
def test_each_roofline_metric_has_a_counter(metric):
    assert metric["unit"] == "%"
    registry.roofline(metric["name"][:-len("_roofline")])


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.workload(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        registry.config("no_such_config")
