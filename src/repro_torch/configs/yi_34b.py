"""Selectable config module for --arch (see registry for provenance)."""
from .registry import YI_34B

CONFIG = YI_34B
REDUCED = CONFIG.reduced()
