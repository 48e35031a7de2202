"""Subprocess / pipe helpers for launcher tooling.

Capability parity with the reference's ``GlobalShell`` (``src/utils/shell.h``:
``make_pipe`` / ``execute`` / ``get_command_output`` over ``popen`` with
``set -o pipefail``, fork-guarded by ``global_fork_mutex()``). The reference
used these to stream training data out of HDFS pipes and to drive the
Hadoop-Streaming launch scripts; here they back the ``tools/`` launchers and
any ``data: "cmd |"`` pipe-style input.

Python's ``subprocess`` already serializes fork internally, so the fork mutex
disappears; ``pipefail`` is preserved by running through ``bash -o pipefail``.
The JAX package's ``utils/shell.py``, kept as the port's own copy.
"""

from __future__ import annotations

import subprocess
from typing import IO, Iterator, Optional


def execute(cmd: str, check: bool = True) -> int:
    """Run a shell command (``GlobalShell::execute`` parity, with pipefail)."""
    proc = subprocess.run(["bash", "-o", "pipefail", "-c", cmd])
    if check and proc.returncode != 0:
        raise RuntimeError(f"command failed ({proc.returncode}): {cmd}")
    return proc.returncode


def get_command_output(cmd: str) -> str:
    """Capture stdout (``GlobalShell::get_command_output`` parity)."""
    proc = subprocess.run(
        ["bash", "-o", "pipefail", "-c", cmd], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"command failed ({proc.returncode}): {cmd}\n{proc.stderr}"
        )
    return proc.stdout


class ManagedPipe:
    """Read-only command pipe (``GlobalShell::make_pipe('r')`` parity).

    Usage::

        with ManagedPipe("zcat corpus.gz") as f:
            for line in f: ...
    """

    def __init__(self, cmd: str):
        self.cmd = cmd
        self._proc: Optional[subprocess.Popen] = None

    def __enter__(self) -> IO[str]:
        self._proc = subprocess.Popen(
            ["bash", "-o", "pipefail", "-c", self.cmd],
            stdout=subprocess.PIPE,
            text=True,
        )
        assert self._proc.stdout is not None
        return self._proc.stdout

    def __exit__(self, *exc) -> None:
        assert self._proc is not None
        if self._proc.stdout:
            self._proc.stdout.close()
        rc = self._proc.wait()
        if rc != 0 and exc == (None, None, None):
            raise RuntimeError(f"pipe command failed ({rc}): {self.cmd}")


class _PipeReader:
    """File-like over a child's stdout that reaps the child on close and
    raises on nonzero exit (matching ManagedPipe's failure semantics) —
    returning the bare stdout would leak a zombie and swallow pipefail."""

    def __init__(self, cmd: str):
        self.cmd = cmd
        self._closed = False
        self._proc = subprocess.Popen(
            ["bash", "-o", "pipefail", "-c", cmd],
            stdout=subprocess.PIPE,
            text=True,
        )
        assert self._proc.stdout is not None

    def __getattr__(self, name):
        return getattr(self._proc.stdout, name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._proc.stdout)

    def __enter__(self) -> "_PipeReader":
        return self

    def __exit__(self, *exc) -> None:
        # like ManagedPipe: don't let a pipe-exit error (often EPIPE from our
        # own early close) mask an in-flight exception from the with-body
        if exc == (None, None, None):
            self.close()
        else:
            self._reap()

    def _reap(self) -> int:
        if self._proc.stdout and not self._proc.stdout.closed:
            self._proc.stdout.close()
        return self._proc.wait()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        rc = self._reap()
        if rc != 0:
            raise RuntimeError(f"pipe command failed ({rc}): {self.cmd}")


def open_maybe_pipe(path: str) -> IO[str]:
    """Open a data path; a trailing ``|`` means "command pipe" (HDFS-pipe
    pattern from the reference's deploy scripts)."""
    if path.endswith("|"):
        return _PipeReader(path[:-1].strip())
    return open(path, "r", encoding="utf-8", errors="replace")
