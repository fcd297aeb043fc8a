"""Selectable config module for --arch (see registry for provenance)."""
from .registry import PHI3_MEDIUM

CONFIG = PHI3_MEDIUM
REDUCED = CONFIG.reduced()
