"""Selectable config module for --arch (see registry for provenance)."""
from .registry import QWEN3_MOE_30B

CONFIG = QWEN3_MOE_30B
REDUCED = CONFIG.reduced()
