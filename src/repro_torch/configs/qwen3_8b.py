"""Selectable config module for --arch (see registry for provenance)."""
from .registry import QWEN3_8B

CONFIG = QWEN3_8B
REDUCED = CONFIG.reduced()
