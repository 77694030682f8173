from .registry import (ARCHS, SHAPES, ArchConfig, ShapeConfig, TensorSpec,
                       cell_supported, get, input_specs, smoke)

__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "TensorSpec",
           "cell_supported", "get", "input_specs", "smoke"]
