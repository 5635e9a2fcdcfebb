"""Atomic, schema-checked JSON artifact IO.

A truncated artifact (a cut-off stdout tail, ``"parsed": null``) loses
its headline number.  This module makes that class of loss structurally
impossible for anything written through it:

- ``write_json`` serializes, **round-trip parses the serialized text**,
  writes to a temp file in the TARGET directory, ``fsync``\\ s, then
  ``os.replace``\\ s over the destination (plus a directory fsync where
  the platform allows) — a reader never observes a partial file, and a
  crash mid-write leaves the previous version intact.
- after the rename the destination is **read back and parsed again**, so
  the returned object is exactly what a later reader will see.
- an optional ``schema`` (iterable of required top-level keys, or a
  callable validator) rejects structurally wrong payloads before any
  byte hits disk.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Iterable, Optional, Union

__all__ = ["SchemaError", "check_schema", "dumps_checked", "write_json",
           "read_json"]

Schema = Union[Iterable[str], Callable[[Any], None]]


class SchemaError(ValueError):
    """Payload failed the artifact schema check."""


def check_schema(obj: Any, schema: Optional[Schema]) -> None:
    """``schema`` is either a callable ``schema(obj)`` raising on
    mismatch, or an iterable of required top-level dict keys."""
    if schema is None:
        return
    if callable(schema):
        schema(obj)
        return
    if not isinstance(obj, dict):
        raise SchemaError(f"expected a JSON object, got {type(obj).__name__}")
    missing = [k for k in schema if k not in obj]
    if missing:
        raise SchemaError(f"missing required keys: {missing}")


def dumps_checked(obj: Any, schema: Optional[Schema] = None,
                  indent: Optional[int] = None) -> str:
    """Serialize and prove the text parses back (and passes ``schema``)
    BEFORE anyone prints or writes it."""
    text = json.dumps(obj, indent=indent, sort_keys=False,
                      allow_nan=False, default=_jsonify)
    parsed = json.loads(text)
    check_schema(parsed, schema)
    return text


def _jsonify(o: Any):
    """Last-resort encoder: numpy scalars/arrays → python, else str."""
    item = getattr(o, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    tolist = getattr(o, "tolist", None)
    if callable(tolist):
        try:
            return tolist()
        except Exception:
            pass
    return str(o)


def write_json(path: str, obj: Any, schema: Optional[Schema] = None,
               indent: Optional[int] = 2) -> Any:
    """Atomically write ``obj`` as JSON to ``path``; returns the object
    parsed back FROM the renamed file (the round-trip proof)."""
    import tempfile
    text = dumps_checked(obj, schema, indent)
    directory = os.path.dirname(os.path.abspath(path))
    # mkstemp: a pid-only suffix would let two THREADS of one process
    # share (and tear) the temp inode — uniqueness must cover threads
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
            if not text.endswith("\n"):
                f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o644)          # mkstemp defaults to 0600
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        # fsync the directory so the rename itself survives power loss
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # pragma: no cover - platform without dir fsync
        pass
    return read_json(path, schema)


def read_json(path: str, schema: Optional[Schema] = None) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        obj = json.load(f)
    check_schema(obj, schema)
    return obj
