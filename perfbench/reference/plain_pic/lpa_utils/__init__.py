from .boosted_frame import BoostConverter

__all__ = ["BoostConverter"]
