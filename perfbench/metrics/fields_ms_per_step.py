"""fields_ms_per_step (fields): ms a step of the kernels in the
program's ``sources``, ``maxwell``, ``window`` and ``damp`` device
spans -- the sources to spectral space, the filters, the current
correction, the PSATD push, the window's shift, the damping and the
transform back -- their union on the card (spectral_ms_per_step is a
part of it)."""
from perfbench.metrics._spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, ("sources", "maxwell", "window", "damp"))
