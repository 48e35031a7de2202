"""Trainer-side delta publishing — the JAX package's ``freshness/publisher.py``
over the port's tables.

Three layers:

* :class:`DeltaPublisher` — owns one log directory: stamps each batch
  with ``(publisher, seq, base_step, step, ts_ns)``, writes it
  atomically, applies the ``freshness_log_mb`` retention, and emits
  rate-limited ``delta`` ledger events.
* :class:`TouchedRowCollector` — resident-path row source: per step it
  asks the trainer's ``tier_plan`` for the exact master row ids the step
  touches (hashing and the negative draws included: the plan draws from
  its own ``step_generator(seed, step)``, so the step's generator is never
  advanced), falling back to the union of integer batch leaves when a
  trainer has no plan (the fused word2vec paths, whose pools are drawn
  inside the step). Extra rows are harmless: payloads carry absolute
  values, not diffs.
* :class:`TrainPublisher` — the TrainLoop-owned facade wiring source to
  sink: under ``table_tier: host`` it taps the tier's dirty-flush stream
  (``TieredTable.delta_tap``) and gathers flushed units from the host
  masters; on the resident (or transparent-tier) path it drains the
  collector and gathers rows straight from the live planes. Either way the
  gathered values are normalized dense rows — bit-identical to the serving
  engine's ``normalize_table`` lane selects.

The resident gather never copies a table to the host: the touched tiles
are gathered on the plane's device (``rowdma.gather_rows`` for the packed
layouts, ``index_select`` for the 2-D plane, which has no kernel), lane-
selected there to ``[n, dim]`` f32, and only those rows cross to the host.
Publishing is synchronous at the loop's step boundary, as in the JAX
package; :meth:`TrainPublisher.stats` splits its cost into the wait for
the step's own queued device work (the gather reads the step's result),
the gather (synchronized), the device-to-host copy and the file write.

Publishing never blocks or kills training: every cadence publish is
wrapped, failures land as ``freshness_gap`` ledger events and the stream
simply misses a beat (subscribers see a late batch, not a torn one).

Under a ``(data, model)`` mesh (the trainer's ``mesh``) the publisher opens
on every rank and every rank observes the same global batches, but only the
leader (the mesh's origin) writes the delta log and runs the
``freshness_listen`` server. A resident table's touched rows are gathered
from its model shards with the owned gather summed over ``model``
(``transfer.gather_slots_collective``), so every rank holds them whole; a
tiered table's dirty slots are flushed on every rank (a collective) and
the leader publishes from its own whole master. Before the gather's
collectives the ranks vote that each drained the same rows, and after the
publish that none failed (:func:`~swiftsnails_tpu_torch.parallel.mesh.vote`):
a failure on any rank is then a miss on every rank, one ``freshness_gap``
event on the leader, and every rank trains on.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.freshness.log import list_seqs, prune, seg_path, write_base, \
    write_batch
from swiftsnails_tpu_torch.parallel.mesh import is_leader, vote, vote_any
from swiftsnails_tpu_torch.utils.config import ConfigError

_LEDGER_EVERY = 100  # rate limit: first publish + every 100th


class HybridFreshnessError(ConfigError):
    """``placement: hybrid`` + freshness publishing + a TCP delta stream
    (``freshness_listen``) don't compose: hybrid head/tail planes leave
    the master row layout mid-run, so published rows would carry the
    wrong id space — and with a socket listener configured, remote
    subscribers would be *silently* starved if publishing were just
    disabled (the local-file case disables with a notice on stderr).
    Raised at ``TrainLoop`` construction, before any step runs."""


# ------------------------------------------------- normalized row gathers ---


def _as_plane(plane) -> torch.Tensor:
    if isinstance(plane, torch.Tensor):
        return plane
    from swiftsnails_tpu_torch.serving.engine import as_tensor

    return as_tensor(plane, torch.device("cpu"))


def gather_normalized(plane, rows: np.ndarray, *, layout: str,
                      dim: int, mesh=None) -> torch.Tensor:
    """Gather logical ``rows`` from a table plane in its trainer layout ->
    ``[n, dim]`` f32 on the plane's device, via the exact lane selects of
    the serving engine's ``normalize_table`` (no arithmetic: bit-identical
    rows). ``packed`` / ``packed_small`` gather the touched tiles with
    ``rowdma.gather_rows``; ``dense`` takes ``index_select``. ``mesh``:
    ``plane`` is this rank's model shard, and the tiles (rows) come whole
    on every rank from ``transfer.gather_slots_collective`` (the owned
    ``gather_rows`` summed over ``model``; every rank calls it)."""
    from swiftsnails_tpu_torch.ops.rowdma import ROW_LANES, gather_rows, unpack_rows

    t = _as_plane(plane)
    rows = np.asarray(rows, np.int64)

    def take(units: np.ndarray) -> torch.Tensor:
        if mesh is None:
            return gather_rows(t, torch.from_numpy(units.astype(np.int32)).to(t.device))
        from swiftsnails_tpu_torch.parallel.transfer import gather_slots_collective

        return gather_slots_collective(mesh, t, torch.from_numpy(units).to(t.device))

    if layout == "dense":
        if mesh is not None:
            return take(rows).to(torch.float32)
        idx = torch.from_numpy(rows).to(t.device)
        return t.index_select(0, idx).to(torch.float32)
    if layout == "packed":
        tiles = take(rows)  # [n, S, 128], one row a tile
        return unpack_rows(tiles, dim).to(torch.float32).contiguous()
    if layout == "packed_small":
        from swiftsnails_tpu_torch.parallel.store import small_group

        g = small_group(dim)
        stride = ROW_LANES // g
        sub0 = take(rows // g)[:, 0, :]  # [n, 128]: sublane 0 = params
        lanes = torch.from_numpy(((rows % g) * stride)[:, None]
                                 + np.arange(dim)[None, :]).to(t.device)
        return torch.gather(sub0, 1, lanes).to(torch.float32)
    raise ValueError(f"unknown table layout {layout!r}")


def gather_normalized_rows(plane, rows: np.ndarray, *, layout: str,
                           dim: int) -> np.ndarray:
    """:func:`gather_normalized`, copied to the host: ``[n, dim]`` f32."""
    return gather_normalized(plane, rows, layout=layout, dim=dim).cpu().numpy()


def normalize_units(t_units, units: np.ndarray, *, layout: str, dim: int,
                    group: int, capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """Master-gathered units -> ``(row_ids, [n, dim] f32 values)``. A unit
    is one logical row except ``packed_small`` (one tile = ``group`` rows:
    a dirty tile publishes all its resident rows)."""
    from swiftsnails_tpu_torch.ops.rowdma import ROW_LANES

    units = np.asarray(units, np.int64)
    t = _as_plane(t_units)
    if layout in ("dense", "packed"):
        vals = gather_normalized_rows(t, np.arange(units.size), layout=layout, dim=dim)
        return units, vals
    if layout == "packed_small":
        g = int(group)
        stride = ROW_LANES // g
        sub0 = t[:, 0, :].to(torch.float32).numpy()  # [n, 128]
        rows = (units[:, None] * g + np.arange(g)[None, :]).ravel()
        rep = np.repeat(np.arange(units.size), g)
        idx = ((rows % g) * stride)[:, None] + np.arange(dim)[None, :]
        vals = np.take_along_axis(sub0[rep], idx, axis=1)
        keep = rows < int(capacity)
        return rows[keep], vals[keep]
    raise ValueError(f"unknown table layout {layout!r}")


# --------------------------------------------------------------- publisher ---


class DeltaPublisher:
    """One publisher incarnation over one delta-log directory."""

    def __init__(self, dirpath: str, *, base_step: int,
                 dtype: str = "float32", log_mb: float = 64.0,
                 ledger=None, request_tracer=None):
        if dtype not in ("float32", "int8"):
            raise ValueError(
                f"freshness_delta_dtype must be float32|int8, got {dtype!r}")
        self.dir = os.path.abspath(dirpath)
        self.dtype = dtype
        self.log_mb = float(log_mb)
        self.ledger = ledger
        self.request_tracer = request_tracer
        self.base_step = int(base_step)
        self.id = uuid.uuid4().hex[:12]
        self.seq = 0
        self.published_batches = 0
        self.published_rows = 0
        self.published_bytes = 0
        self.pruned = 0
        self.write_ns = 0  # encode + atomic write + retention, summed
        # a new incarnation owns the directory: stale segments from a dead
        # publisher use an unrelated numbering and must never be read as
        # ours — drop them BEFORE the new base becomes visible
        for s in list_seqs(self.dir):
            try:
                os.remove(seg_path(self.dir, s))
            except OSError:
                pass
        write_base(self.dir, {
            "publisher": self.id,
            "base_step": self.base_step,
            "first_seq": 1,
            "dtype": self.dtype,
        })

    def publish(self, updates: Dict[str, Tuple[np.ndarray, np.ndarray]],
                step: int) -> Optional[int]:
        """Write one batch of ``{table: (row_ids, [n, dim] f32 values)}``
        current as of trainer ``step``; returns the assigned seq (None when
        every table came up empty — an empty batch is not published)."""
        t0 = time.perf_counter_ns()
        tables: Dict[str, Dict[str, np.ndarray]] = {}
        total_rows = 0
        for name, (rows, values) in updates.items():
            rows = np.asarray(rows, np.int64).ravel()
            if rows.size == 0:
                continue
            values = np.asarray(values, np.float32)
            if self.dtype == "int8":
                from swiftsnails_tpu_torch.tiered.store import _np_quant_unit_rows

                codes, scales = _np_quant_unit_rows(values)
                tables[name] = {"rows": rows, "values": codes, "scales": scales}
            else:
                tables[name] = {"rows": rows, "values": values}
            total_rows += int(rows.size)
        if not tables:
            return None
        self.seq += 1
        ctx = None
        if self.request_tracer is not None:
            try:
                ctx = self.request_tracer.start("delta_publish", publisher=self.id)
            except Exception:
                ctx = None  # tracing never blocks the publish path
        header = {
            "seq": self.seq,
            "publisher": self.id,
            "base_step": self.base_step,
            "step": int(step),
            "ts_ns": time.time_ns(),
            "dtype": self.dtype,
        }
        if ctx is not None:
            # the wire form rides the batch header: the subscriber resumes
            # this trace, so publish->apply->cutover is one drillable tree
            try:
                header["trace"] = ctx.wire()
            except Exception:
                pass
        t_write = time.perf_counter_ns()
        path = write_batch(self.dir, header, tables)
        try:
            nbytes = os.path.getsize(path)
        except OSError:
            nbytes = 0
        if ctx is not None:
            try:
                ctx.add_span("write", t_write, time.perf_counter_ns() - t_write,
                             tables=len(tables))
                ctx.annotate(seq=self.seq, step=int(step), rows=total_rows, bytes=nbytes)
                self.request_tracer.finish(ctx)
            except Exception:
                pass
        self.published_batches += 1
        self.published_rows += total_rows
        self.published_bytes += nbytes
        self.pruned += prune(self.dir, int(self.log_mb * (1 << 20)))
        self.write_ns += time.perf_counter_ns() - t0
        if self.ledger is not None and (
                self.published_batches == 1
                or self.published_batches % _LEDGER_EVERY == 0):
            try:
                self.ledger.append("delta", {
                    "source": "freshness",
                    "publisher": self.id,
                    "seq": self.seq,
                    "step": int(step),
                    "rows": total_rows,
                    "bytes": nbytes,
                    "dtype": self.dtype,
                    "published_batches": self.published_batches,
                })
            except Exception:
                pass  # record-keeping never blocks the publish path
        return self.seq

    def stats(self) -> Dict:
        return {
            "publisher": self.id,
            "seq": self.seq,
            "base_step": self.base_step,
            "dtype": self.dtype,
            "published_batches": self.published_batches,
            "published_rows": self.published_rows,
            "published_bytes": self.published_bytes,
            "pruned": self.pruned,
            "write_ms": self.write_ns / 1e6,
        }


# --------------------------------------------------------------- collector ---


class TouchedRowCollector:
    """Union of master row ids touched since the last drain (resident path).

    Primary source: the trainer's ``tier_plan`` (exact ids, hashing and the
    negative draws included). Fallback when a trainer has no plan (its
    ``tier_plan`` raises): every integer batch leaf, attributed to every
    table and masked to capacity at drain — an over-approximation of the
    batch's own ids, harmless for absolute-value payloads, which misses
    rows the step draws itself.
    """

    _COMPACT_EVERY = 64  # chunks per table before an in-place unique

    def __init__(self, trainer):
        self.trainer = trainer
        self._plan_ok = True
        self._acc: Dict[Optional[str], List[np.ndarray]] = {}

    def observe(self, batch: Dict, seed: int, step: int) -> None:
        ids = None
        if self._plan_ok:
            try:
                ids, _aug, _remap = self.trainer.tier_plan(batch, seed, step)
            except Exception:
                self._plan_ok = False
        if ids is None:
            leaves = [
                np.asarray(v).ravel() for v in batch.values()
                if np.issubdtype(np.asarray(v).dtype, np.integer)
            ]
            ids = {None: np.concatenate(leaves) if leaves else np.zeros(0, np.int64)}
        for name, rows in ids.items():
            chunks = self._acc.setdefault(name, [])
            chunks.append(np.asarray(rows, np.int64).ravel())
            if len(chunks) > self._COMPACT_EVERY:
                self._acc[name] = [np.unique(np.concatenate(chunks))]

    def clear(self) -> None:
        """Drop every pending id."""
        self._acc = {}

    def drain(self, geometry: Dict[str, Dict]) -> Dict[str, np.ndarray]:
        """Pending ids -> ``{table: unique in-capacity row ids}``; resets."""
        acc, self._acc = self._acc, {}
        out: Dict[str, np.ndarray] = {}
        for name, g in geometry.items():
            chunks = list(acc.get(name, ()))
            chunks.extend(acc.get(None, ()))  # fallback leaves: every table
            if not chunks:
                continue
            rows = np.unique(np.concatenate(chunks))
            rows = rows[(rows >= 0) & (rows < int(g["capacity"]))]
            if rows.size:
                out[name] = rows
        return out


# ---------------------------------------------------------- loop-side hook ---


class TrainPublisher:
    """The TrainLoop's freshness hook: decide the row source once, then
    ``on_batch`` each step and ``maybe_publish`` at the configured cadence
    (``freshness_publish`` steps; a final forced publish at end of run)."""

    def __init__(self, trainer, *, tier=None, placement=None, ledger=None,
                 request_tracer=None):
        cfg = trainer.config
        self.trainer = trainer
        self.tier = tier
        self.ledger = ledger
        if request_tracer is None:
            try:
                from swiftsnails_tpu_torch.telemetry.request_trace import RequestTracer

                request_tracer = RequestTracer.from_config(
                    cfg, ledger=ledger, source="freshness")
            except Exception:
                request_tracer = None
        self.request_tracer = request_tracer
        self.period = cfg.get_int("freshness_publish", 0)
        self.dir = cfg.get_str("freshness_dir", "")
        self.dtype = cfg.get_str("freshness_delta_dtype", "float32")
        self.log_mb = cfg.get_float("freshness_log_mb", 64.0)
        self.geometry = trainer.table_geometry()
        self.active = bool(self.period > 0 and self.dir and self.geometry)
        self.listen = cfg.get_str("freshness_listen", "")
        self.mesh = getattr(trainer, "mesh", None)
        self.leader = is_leader(self.mesh)
        self.opened = False
        if self.active and placement is not None:
            # hybrid head/tail planes aren't in master row layout mid-run;
            # publishing would ship rows from the wrong id space
            if self.listen:
                raise HybridFreshnessError(
                    "placement: hybrid cannot be combined with freshness "
                    "publishing to a TCP delta stream (freshness_listen="
                    f"{self.listen!r}): hybrid planes leave master row layout "
                    "mid-run, and remote subscribers would be silently "
                    "starved. Drop freshness_listen (file-dir publishing "
                    "is disabled with a notice) or drop placement: hybrid.")
            print("freshness: publishing disabled under hybrid placement "
                  "(planes leave master layout mid-run)", file=sys.stderr)
            self.active = False
        self.stream_server = None
        self.pub: Optional[DeltaPublisher] = None
        self.collector: Optional[TouchedRowCollector] = None
        self._tap: Dict[str, List[np.ndarray]] = {}
        self._tap_lock = threading.Lock()
        self.errors = 0
        # the cost of the synchronous publish, split (summed over publishes)
        self.step_wait_ns = 0
        self.gather_ns = 0
        self.d2h_ns = 0
        self.publishes = 0

    # -- lifecycle ----------------------------------------------------------

    def open(self, base_step: int) -> None:
        """Start an incarnation: called once per run, after tier adopt (so
        transparent pass-through mode is known) with the resume step."""
        if not self.active:
            return
        self.opened = True
        if self.leader:
            self.pub = DeltaPublisher(
                self.dir, base_step=base_step, dtype=self.dtype,
                log_mb=self.log_mb, ledger=self.ledger,
                request_tracer=self.request_tracer)
        if self.listen and self.leader:
            # freshness_listen: HOST:PORT — push this log's frames to TCP
            # subscribers (net/delta_stream.py) alongside the file dir
            from swiftsnails_tpu_torch.net.delta_stream import DeltaStreamServer

            host, _, port = self.listen.rpartition(":")
            self.stream_server = DeltaStreamServer(
                self.dir, host=host or "127.0.0.1", port=int(port or 0),
                ledger=self.ledger).start()
        if self.tier is not None and not self.tier.all_transparent:
            # dirty-flush tee: every landed write-back records its units
            for tt in self.tier.tables.values():
                tt.delta_tap = self._on_flush
        else:
            # resident (or transparent-tier: identity slot map, raw-id
            # batches, live full planes) — collect touched rows per step
            self.collector = TouchedRowCollector(self.trainer)

    def close(self) -> None:
        """End the incarnation: stop the TCP stream server (if any); the
        delta files stay for file-poll subscribers and resubscribes."""
        if self.stream_server is not None:
            self.stream_server.stop()
            self.stream_server = None
        if self.tier is not None:
            for tt in self.tier.tables.values():
                tt.delta_tap = None

    # -- per-step hooks ------------------------------------------------------

    def on_batch(self, batch: Dict, seed: int, step: int) -> None:
        """Observe BEFORE ``tier.prepare`` remaps ids to slot space."""
        if self.collector is not None and self.opened:
            try:
                self.collector.observe(batch, seed, step)
            except Exception:
                self.errors += 1

    def _on_flush(self, name: str, units: np.ndarray) -> None:
        with self._tap_lock:
            self._tap.setdefault(name, []).append(np.asarray(units, np.int64).copy())

    def maybe_publish(self, state, step: int, force: bool = False) -> None:
        """Publish at the cadence (or ``force``); a failure is a
        ``freshness_gap`` ledger event, never an exception. Under a mesh
        every rank calls this at the same step (module docstring)."""
        if not self.opened:
            return
        if not force and (self.period <= 0 or step == 0 or step % self.period != 0):
            return
        err = None
        try:
            updates = self._gather(state)
            if self.pub is not None:
                self.pub.publish(updates, step)
        except Exception as e:  # publishing must never kill training
            err = e
        if vote_any(self.mesh, [err is not None])[0] and err is None:
            err = RuntimeError("another rank's publish failed")
        if err is None:
            return
        self.errors += 1
        if self.ledger is not None:
            try:
                self.ledger.append("freshness_gap", {
                    "source": "publisher",
                    "reason": "publish_error",
                    "step": int(step),
                    "error": f"{type(err).__name__}: {err}",
                })
            except Exception:
                pass

    # -- the publish itself --------------------------------------------------

    def _gather(self, state) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """``{table: (row ids, [n, dim] f32 values)}`` of the rows touched
        since the last publish (on a follower under a tier: empty, the
        flush made)."""
        updates: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        t0 = time.perf_counter_ns()
        d2h = 0
        if self.collector is not None:
            pending, err = {}, None
            try:
                pending = self.collector.drain(self.geometry)
            except Exception as e:
                err = e
            if self.mesh is not None:
                self._agree(pending, err)
            elif err is not None:
                raise err
            if pending:
                tabs = self.trainer.tier_tables(state)
                dev = next(iter(tabs.values())).table.device
                if dev.type == "cuda":
                    # the step's kernels are still queued: their time is
                    # the step's, not the gather's
                    torch.cuda.synchronize(dev)
                    t1 = time.perf_counter_ns()
                    self.step_wait_ns += t1 - t0
                    t0 = t1
                gathered = {}
                for name, rows in pending.items():
                    g = self.geometry[name]
                    gathered[name] = (rows, gather_normalized(
                        tabs[name].table, rows, layout=g["layout"], dim=int(g["dim"]),
                        mesh=self.mesh))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)  # the gather's own time
                t1 = time.perf_counter_ns()
                if self.leader:
                    for name, (rows, vals) in gathered.items():
                        updates[name] = (rows, vals.cpu().numpy())
                d2h = time.perf_counter_ns() - t1
        else:
            # flush first so the masters hold the exact step-`step` rows —
            # the flush tee below records every landed unit
            self.tier.flush_dirty(state)
            with self._tap_lock:
                tapped, self._tap = self._tap, {}
            for name, chunks in tapped.items() if self.leader else ():
                tt = self.tier.tables.get(name)
                g = self.geometry.get(name)
                if tt is None or g is None or not chunks:
                    continue
                from swiftsnails_tpu_torch.tiered.store import _to_torch

                units = np.unique(np.concatenate(chunks))
                t_units, _slots = tt.master.gather(units)
                updates[name] = normalize_units(
                    _to_torch(np.ascontiguousarray(t_units), tt.master.table_dtype),
                    units, layout=g["layout"], dim=int(g["dim"]),
                    group=int(g.get("group", 1)), capacity=int(g["capacity"]))
        self.gather_ns += time.perf_counter_ns() - t0 - d2h
        self.d2h_ns += d2h
        self.publishes += 1
        return updates

    def _agree(self, pending: Dict[str, np.ndarray], err) -> None:
        """Under a mesh, before the gather's collectives: every rank drained
        without error and the same rows (their count and id sum a table,
        in the geometry's order), or every rank drops its pending rows, as
        a failed publish on one device does, and raises."""
        mine = [float(err is not None)]
        for name in self.geometry:
            rows = pending.get(name, np.zeros(0, np.int64))
            mine += [float(rows.size), float(rows.sum())]
        rows = vote(self.mesh, mine)
        if rows[:, 0].any() or (rows[1:] != rows[0]).any():
            self.collector.clear()
            if err is not None:
                raise err
            raise RuntimeError("the ranks drained different touched rows"
                               if not rows[:, 0].any() else "another rank's drain failed")

    def stats(self) -> Dict:
        out = {"active": self.active, "period": self.period, "errors": self.errors}
        if self.pub is not None:
            out.update(self.pub.stats())
            out.update({"publishes": self.publishes,
                        "step_wait_ms": self.step_wait_ns / 1e6,
                        "gather_ms": self.gather_ns / 1e6,
                        "d2h_ms": self.d2h_ns / 1e6,
                        "source": "collector" if self.collector is not None else "flush_tee"})
        return out
