"""interp_push_ms_per_step (particles): ms a step of the kernels in the
program's ``interpolate``, ``push`` and ``unpad`` device spans -- K2
and the external fields, the momentum push and the position half
pushes, the processes, the flattening back -- their union on the
card."""
from perfbench.metrics._spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, ("interpolate", "push", "unpad"))
