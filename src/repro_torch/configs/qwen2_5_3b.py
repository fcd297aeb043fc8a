"""Selectable config module for --arch (see registry for provenance)."""
from .registry import QWEN25_3B

CONFIG = QWEN25_3B
REDUCED = CONFIG.reduced()
