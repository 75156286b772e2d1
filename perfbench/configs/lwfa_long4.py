"""lwfa_long4: lwfa_std's script on a box four times as long
(lwfa_long4.json), decomposed along z one slab a device through
``distribute_simulation``, as this repo's examples/multichip_lwfa_script.py
runs it.  Built on an API namespace: fbpic_tpu_torch for the system
under test, the frozen plain reference for the comparison."""
from perfbench import registry


def build(api, cfg, random_seed, devices, dtype):
    """lwfa_std's Simulation at this configuration's values, on the first
    device, then decomposed over ``devices`` (one slab each)."""
    std = registry.builder({"builder": "lwfa_std.py"})
    sim = std.build(api, cfg, random_seed, devices[:1], dtype)
    return api.distribute_simulation(sim, devices=list(devices))
