"""Atomic file replacement: the write-temp/fsync/rename idiom.

The one durable-publication primitive every on-disk artifact in this repo
shares (checkpoint segments, consolidated generations, manifest rewrites,
``repro.api.Engine.snapshot`` manifests): the complete new contents are
written to a temp file *in the same directory*, fsync'd, and then renamed
over the destination.  ``os.replace`` is atomic on POSIX, so a reader (or a
crash) sees either the old file or the complete new one — never a torn
in-place write.

Deliberately dependency-free (``os``/``tempfile`` only) so non-numpy callers
like ``repro.api`` can import it without pulling the checkpoint stack.
"""
from __future__ import annotations

import os
import tempfile


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Atomically replace ``path`` with ``data`` (write-temp/fsync/rename)."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        os.write(fd, data)
        os.fsync(fd)
    except BaseException:
        os.close(fd)
        os.unlink(tmp)
        raise
    os.close(fd)
    try:
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


__all__ = ["atomic_write_bytes"]
