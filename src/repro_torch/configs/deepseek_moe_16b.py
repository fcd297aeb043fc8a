"""Selectable config module for --arch (see registry for provenance)."""
from .registry import DEEPSEEK_MOE_16B

CONFIG = DEEPSEEK_MOE_16B
REDUCED = CONFIG.reduced()
