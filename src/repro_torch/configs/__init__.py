"""Config registry: 10 assigned architectures x 4 input shapes."""
from .registry import ARCHS, SHAPES, ShapeSpec, all_cells, applicable, runnable_cells

def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_arch", "all_cells", "applicable", "runnable_cells"]
