"""Device memory errors (the reference's cuda.py / printing.py OOM
handling, after fbpic_tpu's utils/device.py)."""
import functools

import torch

OOM_ADVICE = (
    "The device ran out of memory.\n"
    "Try reducing the grid size, the number of "
    "macroparticles, or the particle-buffer capacities "
    "(`capacity` argument of add_new_species).\n"
    "Original error:\n")


def catch_memory_error(fn):
    """Re-raise a CUDA out-of-memory error of ``fn`` as a MemoryError
    with fbpic_tpu's advice (reference: printing.py:313-345); every other
    error passes through unchanged.  Adds no work to a call that does
    not fail."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except torch.cuda.OutOfMemoryError as err:
            raise MemoryError(OOM_ADVICE + str(err)) from err

    return wrapper
