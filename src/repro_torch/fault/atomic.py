"""Crash-safe file writes: tmp + fsync + rename.

Stdlib copy of `repro.fault.atomic` for the PyTorch port (the port imports
nothing of the JAX package). The serve artifacts (`serve.artifact.
save_model`) go through it, so a hot-swap watcher polling a model path
never reads a torn file. The contract is the classic POSIX one:

    1. write the full payload to a temp file IN THE SAME DIRECTORY,
    2. flush + fsync the temp file,
    3. os.replace() it over the destination (atomic on POSIX),
    4. best-effort fsync the parent directory so the rename survives a
       power cut.

A crash at any step leaves the destination untouched; stale ``.tmp-*``
siblings are the only debris and are safe to delete.
"""
from __future__ import annotations

import json
import os
import tempfile


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory (persists a completed rename).
    Some filesystems refuse O_RDONLY dir fsync -- that only weakens
    durability, not atomicity, so failures are swallowed."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write `data` to `path` atomically (tmp + fsync + rename)."""
    path = os.fspath(path)
    parent = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=parent, prefix=".tmp-",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(parent)


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj, **dump_kwargs) -> None:
    """Atomic `json.dump`. Serialization happens BEFORE the temp file is
    created, so an unserializable object leaves no debris at all."""
    atomic_write_text(path, json.dumps(obj, **dump_kwargs))
