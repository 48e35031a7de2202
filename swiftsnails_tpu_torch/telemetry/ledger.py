"""Config hashing and atomic file writes — three functions of the JAX
package's ``telemetry/ledger.py``.

The port takes only what its checkpoints need: :func:`config_hash` (the
manifest's ``config_hash``), :func:`atomic_write_bytes` and
:func:`atomic_write_json` (the manifest commit). The run ledger itself
(``Ledger``, its reports and regression gates) is not ported yet; see
``ROADMAP.md``.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict


def config_hash(conf: Dict) -> str:
    """Stable short hash of a flat config mapping (order-independent)."""
    blob = json.dumps(
        {str(k): str(v) for k, v in conf.items()}, sort_keys=True
    ).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:16]


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via tmp + fsync + rename (+ dir fsync):
    readers only ever see the old or the new complete file."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", dir=d)
    try:
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.rename(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:  # persist the rename itself
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # e.g. directories that reject O_RDONLY open; data is renamed


def atomic_write_json(path: str, obj) -> None:
    atomic_write_bytes(path, (json.dumps(obj) + "\n").encode("utf-8"))
