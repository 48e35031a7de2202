"""Serving under a ``(data, model)`` mesh: one leader, the others followers.

The JAX package serves a sharded table from one controller. The port is one
process a rank, and every rank must make the same collectives in the same
order, while the micro-batchers batch requests by timing: two ranks left
alone would dispatch different batches. So the rank at the mesh's origin
(every coordinate 0) leads and the others follow:

* the leader runs the batchers, the hot-row cache, the breakers and the
  routers; before each dispatch that makes a collective (a pull, a topk, a
  score, a tiered pull) or changes what the ranks hold (``apply_rows``, a
  checkpoint reload, a fleet's delta, reload, ``add`` or ``drain``) it
  broadcasts over the whole mesh a header of :data:`HEADER` int64s (the op,
  the target's index, the op's integers) and then the op's tensors (ids,
  queries, features, delta rows, a checkpoint path's bytes);
* a follower runs :func:`follow`: it takes each header, the tensors its op
  names, and makes the same call on its own shard, in the same order. The
  leader checks what a request could fail on alike everywhere (a tiered
  request's distinct rows against the cache's budget, say) before it sends
  it, so an op that raises on a follower raised there alone: its
  collectives no longer pair with the others', and :func:`follow` raises
  :class:`FollowerError` (the leader's next collective then fails by the
  process group's timeout, or as soon as the follower's process exits);
* an op that changes what the ranks hold (``apply_rows``, a checkpoint
  reload, a fleet's delta or reload) runs in two halves: every rank makes
  the fallible half (the shadow load and its checks, the new planes), then
  every rank votes (:meth:`ServeChannel.voted`, one all-gather), and only
  if every rank succeeded does any rank commit. Otherwise every rank raises
  :class:`Refused` and keeps what it served: the leader's caller sees the
  refusal, a follower logs it and follows on, still in step. A reload sends
  the followers the leader's config and its retry policy's knobs;
* every dispatch of a leader process runs under one lock (:attr:`ServeChannel.lock`,
  re-entrant, taken before any servant's own locks), so no header and its
  collective interleave with another thread's: the servants' batchers, a
  fleet's replicas, a delta subscriber's apply thread, the heartbeat;
* :func:`stop` sends a stop header, which ends the followers; with
  ``error`` they raise :class:`LeaderError`. :func:`leading` sends it when
  its block ends, the error form when it raises;
* an idle leader sends an empty header every :data:`HEARTBEAT_S` seconds, so a
  follower's wait never reaches the process group's timeout; a leader that
  dies without a stop leaves the followers to that timeout, which then
  raises.

Targets (servants and fleets) register in the order they are made, so a
process must make them in the same order on every rank
(``Servant.from_checkpoint`` and ``Fleet.from_checkpoint`` with the same
arguments do). A stop ends the session: the channel forgets its targets,
and the next servant on the mesh opens a new one. Headers and tensors
travel on the CPU under gloo and on the mesh's device under NCCL.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

HEADER = 8  # int64s: op, target, then up to six integers of the op
HEARTBEAT_S = 30.0  # an idle leader's header period, well inside any group timeout

# ops
STOP, NOP, PULL, TIER_PULL, TOPK, SCORE, APPLY, RELOAD = range(8)
FLEET_APPLY, FLEET_RELOAD, FLEET_ADD, FLEET_DRAIN = range(8, 12)

log = logging.getLogger(__name__)
_CHANNELS: Dict[int, Tuple[Any, "ServeChannel"]] = {}
_CHANNELS_LOCK = threading.Lock()


class LeaderError(RuntimeError):
    """The serving leader stopped with an error."""


class FollowerError(RuntimeError):
    """An op failed on this follower alone: it left the session."""


class Refused(RuntimeError):
    """A rank failed its half of a voted op, and no rank committed it."""


class ServeChannel:
    """One process's end of the leader/follower protocol over ``mesh``
    (module docstring). Made once a mesh by :func:`channel`."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.leader = not any(mesh.coords.values())
        self.device = (torch.device("cpu") if dist.get_backend() == "gloo"
                       else mesh.device)
        self.lock = threading.RLock()
        self.targets: List[Any] = []
        self.stopped = False
        self._quiet = 0
        self._last = time.monotonic()
        self._hb_stop = threading.Event()
        self._hb = None

    def register(self, target) -> int:
        """``target``'s index, by the order of registration."""
        with self.lock:
            self.targets.append(target)
            if self.leader and self._hb is None:
                self._hb = threading.Thread(target=self._heartbeat, daemon=True,
                                            name="ssn-serve-heartbeat")
                self._hb.start()
            return len(self.targets) - 1

    # -- leader ------------------------------------------------------------

    @contextlib.contextmanager
    def composite(self, op: int, target: int, ints: Sequence[int] = (),
                  tensors: Sequence[torch.Tensor] = ()):
        """A fleet's op: send it whole, then hold the lock and send nothing
        for the block's ops (its replicas' parts are the followers' too)."""
        with self.lock:
            self.send(op, target, ints, tensors)
            self._quiet += 1
            try:
                yield
            finally:
                self._quiet -= 1

    def send(self, op: int, target: int, ints: Sequence[int] = (),
             tensors: Sequence[torch.Tensor] = ()) -> None:
        """On the leader: broadcast the header and ``tensors`` (no-op on a
        follower, inside :meth:`composite` and after :meth:`stop`)."""
        if not self.leader or self._quiet or self.stopped:
            return
        with self.lock:
            hdr = torch.zeros(HEADER, dtype=torch.int64)
            hdr[0], hdr[1] = op, target
            if ints:
                hdr[2:2 + len(ints)] = torch.tensor([int(v) for v in ints], dtype=torch.int64)
            self._bcast(hdr)
            for t in tensors:
                self._bcast(t)
            self._last = time.monotonic()

    def stop(self, error: bool = False) -> None:
        """On the leader: end the followers (with ``error``, they raise
        :class:`LeaderError`) and the heartbeat. Idempotent."""
        if not self.leader or self.stopped:
            return
        with self.lock:
            self.send(STOP, 0, (int(bool(error)),))
            self._close()
        self._hb_stop.set()

    def _close(self) -> None:
        """The session is over: forget the targets, and let the next
        :func:`channel` call on the mesh open a new one."""
        self.stopped = True
        self.targets = []
        with _CHANNELS_LOCK:
            entry = _CHANNELS.get(id(self.mesh))
            if entry is not None and entry[1] is self:
                del _CHANNELS[id(self.mesh)]

    def _heartbeat(self) -> None:
        while not self._hb_stop.wait(HEARTBEAT_S / 4):
            if time.monotonic() - self._last >= HEARTBEAT_S / 2:
                with self.lock:
                    self.send(NOP, 0)

    def voted(self, what: str, prepare: Callable[[], Any]) -> Any:
        """Every rank's fallible half of the voted op ``what``, then the
        vote (one all-gather over the whole mesh, in the op's place in the
        sequence): ``prepare()``'s result when every rank succeeded, else
        :class:`Refused` on every rank (from this rank's own error, if it
        failed)."""
        try:
            out, err = prepare(), None
        except Exception as e:  # noqa: BLE001 — the vote carries it to every rank
            out, err = None, e
        flag = torch.tensor([int(err is not None)], dtype=torch.int32, device=self.device)
        flags = [torch.empty_like(flag) for _ in range(dist.get_world_size())]
        dist.all_gather(flags, flag)
        failed = [r for r, f in enumerate(flags) if int(f)]
        if failed:
            raise Refused(f"{what}: rank(s) {failed} failed their half; no rank "
                          "committed it") from err
        return out

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device).contiguous()
        dist.broadcast(t, src=0)
        return t

    # -- follower ------------------------------------------------------------

    def recv(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """The next tensor the leader sends (``shape``, ``dtype``), on the
        CPU."""
        return self._bcast(torch.empty(tuple(shape), dtype=dtype)).cpu()

    def follow(self) -> None:
        """A follower's loop: run each op the leader sends on its target
        until a stop; raise :class:`LeaderError` on an error stop, and
        :class:`FollowerError` where an op failed here alone (module
        docstring)."""
        if self.leader:
            raise RuntimeError("the mesh's origin leads; follow() is for the other ranks")
        while True:
            hdr = self.recv((HEADER,), torch.int64).tolist()
            op, target, args = hdr[0], hdr[1], hdr[2:]
            if op == STOP:
                self._close()
                if args[0]:
                    raise LeaderError("the serving leader stopped with an error")
                return
            if op == NOP:
                continue
            try:
                self.targets[target]._follow(op, args, self)
            except Refused as e:  # every rank refused it alike: still in step
                log.warning("serving follower: %s", e)
            except Exception as e:
                self._close()
                raise FollowerError(f"serving follower: op {op} on target {target} failed "
                                    "on this rank; it leaves the session") from e


def channel(mesh) -> ServeChannel:
    """The process's :class:`ServeChannel` of ``mesh``, made on first use."""
    with _CHANNELS_LOCK:
        entry = _CHANNELS.get(id(mesh))
        if entry is None or entry[0] is not mesh:
            entry = _CHANNELS[id(mesh)] = (mesh, ServeChannel(mesh))
        return entry[1]


def follow(mesh) -> None:
    """Run a follower rank of ``mesh`` until the leader's stop."""
    channel(mesh).follow()


def stop(mesh, error: bool = False) -> None:
    """On the leader rank: end the followers of ``mesh``."""
    channel(mesh).stop(error)


@contextlib.contextmanager
def leading(mesh):
    """The leader's block: a stop when it ends, the error stop (then the
    error itself) when it raises."""
    try:
        yield channel(mesh)
    except BaseException:
        stop(mesh, error=True)
        raise
    stop(mesh)


# ------------------------------------------------------- the op payloads ---


def text_tensor(text: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(text.encode("utf-8"), np.uint8).copy())


def recv_text(ch: ServeChannel, nbytes: int) -> str:
    return bytes(ch.recv((nbytes,), torch.uint8).numpy()).decode("utf-8")


RETRY_KNOBS = ("max_attempts", "deadline_ms", "base_ms", "cap_ms")


def reload_payload(root: str, step: int, config, retry) -> Tuple[Tuple[int, int],
                                                                 Tuple[torch.Tensor]]:
    """A checkpoint reload's header integers and tensor: the step the
    leader verified, and one JSON text of the root, the leader's config and
    its retry policy's :data:`RETRY_KNOBS` (a follower retries on
    ``OSError``, the policy's default)."""
    text = text_tensor(json.dumps({
        "root": root,
        "config": None if config is None else config.as_dict(),
        "retry": None if retry is None else {k: getattr(retry, k) for k in RETRY_KNOBS},
    }))
    return (int(step), text.numel()), (text,)


def recv_reload(ch: ServeChannel, args) -> Tuple[str, int, Any, Optional[Any]]:
    """The ``(root, step, config, retry)`` :func:`reload_payload` sent."""
    from swiftsnails_tpu_torch.resilience.retry import RetryPolicy
    from swiftsnails_tpu_torch.utils.config import Config

    msg = json.loads(recv_text(ch, args[1]))
    config = None if msg["config"] is None else Config(msg["config"])
    retry = None if msg["retry"] is None else RetryPolicy(**msg["retry"])
    return msg["root"], int(args[0]), config, retry


def updates_tensors(updates: Dict[str, Tuple[np.ndarray, np.ndarray]],
                    names: Sequence[str]) -> List[torch.Tensor]:
    """A delta's tensors (:func:`served_updates`' form), a table at a
    time: ``[index, n, width]``, the ids (int64), the rows (float64: any
    float input, exactly)."""
    out = []
    for name, (ids, vals) in updates.items():
        out.append(torch.tensor([names.index(name), *vals.shape], dtype=torch.int64))
        out.append(torch.from_numpy(np.ascontiguousarray(ids, np.int64)))
        out.append(torch.from_numpy(np.ascontiguousarray(vals, np.float64)))
    return out


def recv_updates(ch: ServeChannel, n_tables: int,
                 names: Sequence[str]) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The delta :func:`updates_tensors` sent."""
    out = {}
    for _ in range(n_tables):
        idx, n, width = ch.recv((3,), torch.int64).tolist()
        ids = ch.recv((n,), torch.int64).numpy()
        out[names[idx]] = (ids, ch.recv((n, width), torch.float64).numpy())
    return out


def served_updates(updates: Dict[str, Any], names: Sequence[str]
                   ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The tables of ``updates`` in ``names``, in that order, as ``(ids
    [n] int64, rows [n, width])`` numpy arrays."""
    out = {}
    for name in names:
        if name in updates:
            ids, vals = updates[name]
            ids = np.asarray(ids, np.int64).reshape(-1)
            vals = (np.asarray(vals).reshape(ids.shape[0], -1) if ids.size
                    else np.zeros((0, 0), np.float64))
            out[name] = (ids, vals)
    return out


def opt(v: int):
    """A header integer back to an optional one (-1: none)."""
    return None if v < 0 else int(v)
