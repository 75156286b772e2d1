"""Small sizes of the benchmark's cells for CPU tests: the same
configurations and traffic with fewer cells, particles and steps."""
from perfbench import registry

SMALL = {
    "lwfa_std": dict(Nz=64, Nr=16, p_nz=1, p_nr=1, p_nt=4, n_order=16),
    "lwfa_boosted": dict(Nz=128, Nr=16, p_nz=1, p_nr=1, p_nt=4,
                         n_order=16),
    # the internal grid (Nz + 2 x 112 edge cells) splits into 4 slabs
    "lwfa_long4": dict(Nz=128, Nr=16, p_nz=1, p_nr=1, p_nt=4, n_order=8),
}


#: Cells whose files are here and whose entries wait (PERF.md, Open
#: questions): the decomposed LWFA and the boosted-frame LWFA
WAITING = {
    "lwfa_long-4card": dict(name="lwfa_long-4card", config="lwfa_long4",
                            traffic="slabs4_chunks250", chips=4),
    "lwfa_boosted-1card": dict(name="lwfa_boosted-1card",
                               config="lwfa_boosted", traffic="chunks250",
                               chips=1),
}


def small_cell(name):
    """(BENCHMARK.json, workload entry, small configuration, small
    traffic) of cell ``name``, in BENCHMARK.json or WAITING."""
    bench = registry.benchmark()
    wl = WAITING.get(name) or registry.workload(bench, name)
    cfg = dict(registry.config(wl["config"]), **SMALL[wl["config"]])
    traffic = dict(registry.traffic(wl["traffic"]), warmup_steps=12,
                   chunk_steps=6)
    return bench, wl, cfg, traffic
