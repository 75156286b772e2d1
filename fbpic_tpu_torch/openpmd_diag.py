"""Compatibility alias: ``fbpic.openpmd_diag`` -> the port's diagnostics."""
from .diagnostics import *  # noqa: F401,F403
from .diagnostics import __all__  # noqa: F401
