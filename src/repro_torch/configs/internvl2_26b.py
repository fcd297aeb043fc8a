"""Selectable config module for --arch (see registry for provenance)."""
from .registry import INTERNVL2_26B

CONFIG = INTERNVL2_26B
REDUCED = CONFIG.reduced()
