"""Selectable config module for --arch (see registry for provenance)."""
from .registry import WHISPER_MEDIUM

CONFIG = WHISPER_MEDIUM
REDUCED = CONFIG.reduced()
