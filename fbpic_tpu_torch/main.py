"""Import-compatibility alias: reference scripts use
``from fbpic.main import Simulation`` (fbpic_tpu/main.py)."""
from .core.simulation import Simulation  # noqa: F401
