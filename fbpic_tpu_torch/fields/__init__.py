from .solver import (
    GridConfig, SpectralFields, InterpFields, FieldAux, build_field_aux,
)
from .smoothing import BinomialSmoother
from .transform import TransformMatrices

__all__ = [
    "GridConfig", "SpectralFields", "InterpFields", "FieldAux",
    "build_field_aux", "BinomialSmoother", "TransformMatrices",
]
