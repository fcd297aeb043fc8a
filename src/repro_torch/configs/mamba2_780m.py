"""Selectable config module for --arch (see registry for provenance)."""
from .registry import MAMBA2_780M

CONFIG = MAMBA2_780M
REDUCED = CONFIG.reduced()
