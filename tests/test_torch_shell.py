"""The port's host utilities ``utils/shell.py`` and ``utils/timer.py``: the
JAX package's ``tests/test_shell.py`` cases (GlobalShell parity: pipefail,
managed child reaping), and the stopwatch against the JAX one."""

import time

import pytest

from swiftsnails_tpu.utils.timer import Timer as JTimer

from swiftsnails_tpu_torch.utils.shell import (
    ManagedPipe,
    execute,
    get_command_output,
    open_maybe_pipe,
)
from swiftsnails_tpu_torch.utils.timer import Timer


def test_execute_pipefail():
    assert execute("true | true") == 0
    with pytest.raises(RuntimeError):
        execute("false | true")  # pipefail propagates the left failure
    assert execute("false | true", check=False) == 1


def test_get_command_output():
    assert get_command_output("printf hello").strip() == "hello"
    with pytest.raises(RuntimeError, match="command failed"):
        get_command_output("exit 3")


def test_managed_pipe_reads_and_raises():
    with ManagedPipe("printf 'a\\nb\\n'") as f:
        assert [l.strip() for l in f] == ["a", "b"]
    with pytest.raises(RuntimeError):
        with ManagedPipe("false"):
            pass


def test_open_maybe_pipe_plain_file(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("x\n")
    with open_maybe_pipe(str(p)) as f:
        assert f.read() == "x\n"


def test_open_maybe_pipe_command():
    with open_maybe_pipe("printf 'a\\nb\\n' |") as f:
        assert [l.strip() for l in f] == ["a", "b"]


def test_open_maybe_pipe_raises_on_failure_and_close_idempotent():
    f = open_maybe_pipe("false |")
    f.read()
    with pytest.raises(RuntimeError):
        f.close()
    f.close()  # second close is a no-op, not a re-raise


def test_open_maybe_pipe_body_exception_not_masked():
    with pytest.raises(ValueError, match="body"):
        with open_maybe_pipe("yes |") as f:
            f.readline()
            raise ValueError("body error")


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("timeout_s,advance,expired", [
    (0.0, 50.0, False), (2.0, 1.0, False), (2.0, 2.0, True), (2.0, 3.5, True)])
def test_timer_matches_jax(monkeypatch, timeout_s, advance, expired):
    """Both stopwatches on one injected monotonic clock."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    mine, theirs = Timer(timeout_s), JTimer(timeout_s)
    clock.now += advance
    assert mine.elapsed() == theirs.elapsed() == advance
    assert mine.timeout() == theirs.timeout() == expired
    mine.restart()
    theirs.restart()
    assert mine.elapsed() == theirs.elapsed() == 0.0 and not mine.timeout()
