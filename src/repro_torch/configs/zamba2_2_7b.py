"""Selectable config module for --arch (see registry for provenance)."""
from .registry import ZAMBA2_27B

CONFIG = ZAMBA2_27B
REDUCED = CONFIG.reduced()
