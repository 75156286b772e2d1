"""The benchmark of fbpic_tpu_torch on NVIDIA H100 cards (see README.md).

Run one cell once from the repository root:

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Nothing in this package imports JAX or fbpic_tpu; the system under test,
fbpic_tpu_torch, is imported by ``perfbench.program`` alone, and the plain
reference (``perfbench.reference``) imports nothing of it.
"""
