"""TierManager — wires the tiered store into the training loop (the JAX
package's ``tiered/manager.py``).

Lifecycle (all on the host side of the step boundary):

* :meth:`adopt`       — move the trainer's freshly initialized (or restored)
  device planes to host masters, build one :class:`TieredTable` per table
  within the ``tier_hbm_budget_mb`` budget, prewarm with the vocab's hottest
  rows, and hand back a state whose table leaves are the small cache planes
  (the full-size device planes are then unreferenced and freed);
* :meth:`stage_stream` — a generator wrapped around ``trainer.batches()``
  *before* the ``_Prefetcher``, so the producer thread plans each upcoming
  batch (ids + the step's own negative draws), gathers the predicted missing
  rows from the masters, and copies them to the card on a side stream — the
  H2D overlaps the current step (``tier_prefetch_depth`` batches ahead);
* :meth:`prepare`     — per step, on the consumer side: fault every unit the
  batch touches (consuming the staged payload), remap batch ids into
  cache-slot space, return the updated state + batch;
* :meth:`master_state` — flush dirty slots and return the full-size
  master-backed state (checkpoint save, end of run).

Determinism: the planner makes the step's generator (``step_generator(seed,
step, device)``, as the loop does) and the trainer's draws from it, in the
step's order, so the host knows the step's negative rows ahead of time and
the tiered run stays bit-identical to the resident one.

Under a ``(data, model)`` mesh (the trainer's ``mesh``) the plan, the
CLOCK and the remap run on the global batch, before the loop's
``Trainer.local_batch`` slices it, so every rank holds the same slot map;
each rank stages the same rows to its own device. :meth:`adopt` takes this
rank's shards and builds the whole master from them
(``transfer.gather_table``), :meth:`master_state` returns the whole
master, and :meth:`shard_state` cuts it back to this rank's rows.

Keys (``docs/CONFIG_KEYS.md``): ``tier_hbm_budget_mb`` (64), ``tier_checksums``
(1), ``tier_verify_period`` (0, read by the loop), ``tier_prefetch_depth`` (2
or ``auto``), ``tier_async_flush`` (1), ``tier_flush_batch`` (8),
``tier_master_dtype`` (``float32`` | ``int8``); ``use_native`` picks the
remap and CLOCK sweep's route.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from swiftsnails_tpu_torch.tiered.store import (
    HostMaster,
    TieredTable,
    TierStats,
    _fields,
    _FlushQueue,
    _to_torch,
    resolve_master_dtype,
    whole_state,
)
from swiftsnails_tpu_torch.utils.config import ConfigError
from swiftsnails_tpu_torch.utils.tree import map_tensors

# tier_prefetch_depth: auto — start shallow, deepen while the consumer
# measurably stalls on the staging queue
_AUTO_DEPTH_START = 2
_AUTO_DEPTH_MAX = 8
_AUTO_WINDOW = 16  # prepare() calls per adaptation decision
_AUTO_STALL_NS = 1_000_000  # a >1ms prefetch wait counts as a stall


class TierManager:
    def __init__(self, trainer, registry=None, tracer=None):
        spec = trainer.tier_spec()
        if spec is None:
            raise ConfigError(
                f"table_tier: host is not supported by trainer "
                f"'{trainer.name}' (no tier_spec)")
        self.trainer = trainer
        self.mesh = getattr(trainer, "mesh", None)
        self.spec = spec
        self.device = trainer.device
        cfg = trainer.config
        self.budget_mb = cfg.get_float("tier_hbm_budget_mb", 64.0)
        if self.budget_mb <= 0:
            raise ConfigError("tier_hbm_budget_mb must be > 0")
        raw_depth = cfg.get_str("tier_prefetch_depth", "2")
        self.prefetch_auto = raw_depth.strip().lower() == "auto"
        self.prefetch_depth = (
            _AUTO_DEPTH_START if self.prefetch_auto
            else cfg.get_int("tier_prefetch_depth", 2))
        self.checksums = cfg.get_bool("tier_checksums", True)
        # tier_master_dtype: int8 stores the host masters as code planes +
        # per-unit scales (tiered/store.py) — the cache, checkpoints and
        # every other surface stay f32
        self.master_dtype = resolve_master_dtype(
            cfg.get_str("tier_master_dtype", "float32"))
        self.async_flush = cfg.get_bool("tier_async_flush", True)
        self.flush_batch = cfg.get_int("tier_flush_batch", 8)
        if self.flush_batch <= 0:
            raise ConfigError("tier_flush_batch must be > 0")
        self.use_native = cfg.get_bool("use_native", True)
        from swiftsnails_tpu_torch.resilience.retry import RetryPolicy

        # shared policy over the tier's fallible host I/O (master flush at
        # checkpoint/end-of-run, heal-time checkpoint restore)
        self.retry = RetryPolicy.from_config(cfg)
        self.registry = registry
        self.tracer = tracer
        self.stats = TierStats()
        self.tables: Dict[str, TieredTable] = {}
        self._published: Dict[str, int] = {}
        # one queue shared by every table: a single worker keeps D2H traffic
        # serialized (and coalesced across tables in one batch)
        self.flusher = (
            _FlushQueue(batch=self.flush_batch, registry=registry)
            if self.async_flush else None)
        self._prefetcher = None  # set via attach_prefetcher when depth=auto
        self._wait_win: list = []
        self._stage_stream = None  # the producer's H2D stream, made on first use
        # every table in pass-through mode (budget covers the whole master,
        # identity slot map): prepare()/stage_stream() skip all per-step
        # tier work and the run moves at resident speed. Set in adopt().
        self.all_transparent = False

    # -- lifecycle ----------------------------------------------------------

    def adopt(self, state):
        """Device planes -> host masters + device cache planes (+ prewarm).
        Under a mesh ``state`` holds this rank's shards."""
        self._drain()  # re-adopt: no stragglers from the previous generation
        # of tables may land after the masters rebuild
        tabs = self.trainer.tier_tables(state)
        budget_each = self.budget_mb / max(len(tabs), 1)
        caches = {}
        for name, st in tabs.items():
            info = self.spec[name]
            master = HostMaster(
                whole_state(self.mesh, st), info["layout"], group=int(info.get("group", 1)),
                checksums=self.checksums, master_dtype=self.master_dtype)
            # budget math stays in LOGICAL bytes: the cache holds f32 rows
            # regardless of how narrow the host storage is
            units = int(budget_each * (1 << 20) // max(master.unit_nbytes, 1))
            tt = TieredTable(
                master, units, mesh=self.mesh, name=name, stats=self.stats,
                flusher=self.flusher, device=self.device,
                use_native=self.use_native,
            )
            self.tables[name] = tt
            if tt.budget >= tt.master.units:
                # the budget covers the whole table: the trainer's device
                # plane IS the cache — identity slot map, zero copies, and
                # the table enters transparent (pass-through) mode
                caches[name] = tt.adopt_resident(st)
            else:
                caches[name] = tt.make_cache()
        del tabs
        warm = self.trainer.tier_warm_rows() or {}
        for name, tt in self.tables.items():
            if tt.transparent:
                continue
            rows = warm.get(name)
            if rows is None or not len(rows):
                continue
            caches[name] = tt.prewarm(
                caches[name], tt.units_for(np.asarray(rows)))
        self.all_transparent = bool(self.tables) and all(
            tt.transparent for tt in self.tables.values())
        self._publish()
        return self.trainer.tier_with_tables(state, caches)

    # -- per-step fault + remap ----------------------------------------------

    def _plan(self, batch, seed: int, step: int):
        t0 = time.monotonic_ns()
        out = self.trainer.tier_plan(batch, seed, step)
        self.stats.plan_ns += time.monotonic_ns() - t0
        return out

    def prepare(self, state, batch, seed: int, step: int):
        """Fault + remap for one step; returns ``(state, batch)`` with the
        cache planes updated and every table id in cache-slot space."""
        if self.all_transparent:
            # pass-through: identity slot map + full coverage means the raw
            # batch already addresses the cache and the step draws its own
            # negatives, exactly like a resident run
            self.stats.transparent_steps += 1
            if "_tier_staged" in batch:
                batch = {k: v for k, v in batch.items() if k != "_tier_staged"}
            return state, batch
        staged = batch.get("_tier_staged")
        if staged is not None and staged.get("step") != step:
            staged = None  # stale hint (e.g. resume: 1 offsets the stream)
        if staged is not None:
            ids, aug, remap_keys = staged["plan"]
        else:
            ids, aug, remap_keys = self._plan(batch, seed, step)
        tabs = self.trainer.tier_tables(state)
        out_batch = {k: v for k, v in batch.items() if k != "_tier_staged"}
        out_batch.update(aug)
        new_tabs = {}
        faults0 = self.stats.faults
        t_fault0 = time.monotonic_ns()
        for name, tt in self.tables.items():
            payload = staged["payload"].get(name) if staged else None
            new_tabs[name] = tt.ensure(
                tabs[name], tt.units_for(ids[name]), staged=payload)
            for key in remap_keys.get(name, ()):
                out_batch[key] = tt.remap(out_batch[key])
        if self.registry is not None and self.stats.faults > faults0:
            self.registry.histogram("tier_fault_ms").observe(
                (time.monotonic_ns() - t_fault0) / 1e6)
        self._adapt_prefetch()
        self._publish()
        return self.trainer.tier_with_tables(state, new_tabs), out_batch

    # -- adaptive prefetch depth ---------------------------------------------

    def attach_prefetcher(self, pf) -> None:
        """``tier_prefetch_depth: auto``: hand the manager the live
        ``_Prefetcher`` so it can watch per-step queue waits and deepen the
        staging pipeline while the consumer measurably stalls. No-op for a
        fixed depth."""
        self._prefetcher = pf if self.prefetch_auto else None
        self._wait_win = []

    def _adapt_prefetch(self) -> None:
        pf = self._prefetcher
        if pf is None:
            return
        self._wait_win.append(getattr(pf, "last_wait_ns", 0))
        if len(self._wait_win) < _AUTO_WINDOW:
            return
        waits = self._wait_win
        self._wait_win = []
        stalled = sum(1 for w in waits if w > _AUTO_STALL_NS)
        if stalled * 2 >= len(waits) and self.prefetch_depth < _AUTO_DEPTH_MAX:
            self.prefetch_depth = min(self.prefetch_depth * 2, _AUTO_DEPTH_MAX)
            pf.set_depth(self.prefetch_depth)
            if self.registry is not None:
                self.registry.gauge("tier_prefetch_depth").set(
                    self.prefetch_depth)

    # -- prefetch staging -----------------------------------------------------

    def stage_stream(self, src: Iterator, seed: int) -> Iterator:
        """Wrap the batch stream so each batch carries a ``_tier_staged``
        payload: the plan plus the predicted-missing master rows already on
        the card. Runs on the ``_Prefetcher`` producer thread, so the gather
        + H2D overlap the step. The residency peek may be stale (the
        consumer mutates the slot map concurrently) — that only costs
        efficiency, never correctness: :meth:`prepare` re-checks residency
        and host-gathers anything the stage missed."""
        if self.all_transparent:
            return src  # pass-through: nothing to plan or stage

        def gen():
            try:
                for i, b in enumerate(src):
                    b = dict(b)
                    b["_tier_staged"] = self._stage(b, seed, i)
                    yield b
            finally:
                close = getattr(src, "close", None)
                if close is not None:
                    close()

        return gen()

    def _stage(self, batch, seed: int, step: int):
        plan = self._plan(batch, seed, step)
        ids, _, _ = plan
        payload = {}
        for name, tt in self.tables.items():
            missing = tt.peek_missing(tt.units_for(ids[name]))
            if not missing.size:
                continue
            # version snapshot BEFORE the gather: a write-back racing the
            # gather bumps the generation, so the install sees the mismatch
            # and discards the (possibly torn) staged row
            vers = tt.master_ver[missing].copy()
            t_rows, s_rows = tt.master.gather(missing)
            self.stats.h2d_bytes += t_rows.nbytes + sum(
                v.nbytes for v in s_rows.values())
            t0 = time.monotonic_ns()
            m = tt.master
            host = [(None, t_rows, m.table_dtype)] + [
                (k, v, m.slot_dtypes[k]) for k, v in s_rows.items()]
            dev, event = self._to_device(host)
            self.stats.h2d_ns += time.monotonic_ns() - t0
            payload[name] = (missing, vers, dev[None],
                             {k: v for k, v in dev.items() if k is not None},
                             event)
        return {"step": step, "plan": plan, "payload": payload}

    def _to_device(self, host):
        """``[(key, rows, dtype), ...]`` -> ``({key: device tensor}, event)``.
        On the card the copies run from pinned memory on the producer's own
        stream, and the event marks their landing; the install waits for it.
        The pinned blocks come from torch's caching host allocator, which
        reuses one only after the copies that read it have completed."""
        if self.device.type != "cuda":
            return {k: _to_torch(rows, dt) for k, rows, dt in host}, None
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(self.device)
        stream = self._stage_stream
        with torch.cuda.stream(stream):
            out = {k: _to_torch(rows, dt).pin_memory().to(self.device, non_blocking=True)
                   for k, rows, dt in host}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    # -- write-back / reporting -----------------------------------------------

    def _drain(self) -> None:
        """Barrier on the async flush queue, attributed to the trace (the
        ``tier-flush-wait`` span folds into the goodput ``host_blocked``
        decomposition)."""
        if self.flusher is None:
            return
        if self.tracer is not None:
            with self.tracer.span("tier-flush-wait"):
                self.flusher.drain()
        else:
            self.flusher.drain()

    def stop(self) -> None:
        """End of a run: land every queued async flush and stop the flush
        worker (``TrainLoop.run`` calls it on every way out). A later flush
        starts a new worker."""
        if self.flusher is not None:
            self.flusher.stop()

    def flush_dirty(self, state) -> None:
        """Freshness-publish barrier: land every queued async flush and
        write every dirty slot back, leaving the caches mapped. The cheap
        sibling of :meth:`master_state` — no full-state materialization;
        after it the masters hold the exact resident-table content (and the
        flush tee has recorded every landed unit)."""
        self._drain()
        tabs = self.trainer.tier_tables(state)
        for name, tt in self.tables.items():
            self.retry.call(tt.flush, tabs[name], op=f"tier_flush:{name}")

    def master_state(self, state):
        """Flush every dirty slot, then return the full-size master-backed
        state (same state type, shapes and dtypes; CPU tensors). The flush
        happens *before* the caller builds any checkpoint manifest — with
        async write-back on, ``flush`` first drains the background queue, so
        this is a full barrier either way."""
        self._drain()
        tabs = self.trainer.tier_tables(state)
        for name, tt in self.tables.items():
            self.retry.call(tt.flush, tabs[name], op=f"tier_flush:{name}")
        masters = {name: tt.master.state() for name, tt in self.tables.items()}
        return self.trainer.tier_with_tables(state, masters)

    def shard_state(self, state, device=None):
        """This rank's model rows of each table of a :meth:`master_state`
        (the layout a resident meshed run holds), moved to ``device`` where
        given; ``state`` itself without a mesh. Row ranges are contiguous
        leading-dim slices, the units of every layout (rows, packed rows,
        small-row tiles)."""
        if self.mesh is None:
            return state
        from swiftsnails_tpu_torch.parallel.mesh import model_rows

        def part(t):
            t = model_rows(self.mesh, t)
            return t if device is None else t.to(device)

        tabs = self.trainer.tier_tables(state)
        shards = {}
        for name, st in tabs.items():
            tab, slots = _fields(st)
            shards[name] = type(st)(table=part(tab), slots={k: part(v) for k, v in slots.items()})
        return self.trainer.tier_with_tables(state, shards)

    # -- integrity: verify / quarantine-and-rebuild ---------------------------

    def verify(self) -> Dict[str, list]:
        """Recompute every master plane digest; returns ``{table: [corrupt
        plane, ...]}`` for the tables that fail (empty dict = all intact).
        Drains the async flush queue first — a digest recomputed mid-scatter
        would be a false corruption alarm. Under a mesh every rank checks
        its own whole master and the ``(table, plane)`` flags are voted in
        sorted order (a vote over the mesh, so every rank calls this together):
        every rank returns the union."""
        from swiftsnails_tpu_torch.parallel.mesh import vote_any

        self._drain()
        bad = {name: tt.master.verify() for name, tt in self.tables.items()}
        flags = [(name, plane) for name in sorted(self.tables)
                 for plane, _ in self.tables[name].master._planes()]
        voted = vote_any(self.mesh, [plane in bad[name] for name, plane in flags])
        union: Dict[str, list] = {}
        for (name, plane), hit in zip(flags, voted):
            if hit:
                union.setdefault(name, []).append(plane)
        return union

    def heal(self, state, root: str, corrupt: Optional[Dict[str, list]] = None,
             retry_policy=None):
        """Quarantine-and-rebuild: replace each corrupt table's master planes
        from the newest *verified* checkpoint under ``root``, then write every
        currently-resident cache slot back on top — the cache plane was never
        corrupt (the flip hit host memory), so re-asserting it bounds the
        rollback to units evicted since that checkpoint.

        Only the corrupt tables' arrays are read, whole
        (:func:`~swiftsnails_tpu_torch.framework.checkpoint.read_arrays`),
        and checked against the manifest. Under a mesh every rank calls this
        with the same ``corrupt`` (:meth:`verify`'s union): the leader's
        candidate steps are broadcast, every rank reads each candidate's
        whole arrays (a meshed save's arrays are whole on disk) and the
        ranks vote on it, so all take the same step or all raise; then
        each rank re-asserts its cache shard, the resident slots read whole
        over ``model`` on the loop's thread
        (``transfer.gather_slots_collective``).

        Returns ``(step, rebuilt_tables)``; raises
        :class:`~swiftsnails_tpu_torch.framework.checkpoint.CheckpointError`
        when no verified checkpoint survives (training on a silently corrupt
        master would be worse than dying)."""
        from swiftsnails_tpu_torch.framework.checkpoint import (
            CheckpointError, candidate_steps, read_arrays,
        )
        from swiftsnails_tpu_torch.parallel.mesh import broadcast_ints, is_leader, vote_any
        from swiftsnails_tpu_torch.utils.tree import tensor_items

        self._drain()  # no flush may land while masters are being replaced
        corrupt = self.verify() if corrupt is None else corrupt
        if not corrupt:
            return None, []
        names = sorted(corrupt)
        # the keys of the corrupt tables' arrays in the state's structure
        masters = {name: tt.master.state() for name, tt in self.tables.items()}
        shape_of = self.trainer.tier_with_tables(state, masters)
        want = {id(t) for name in names for _, t in tensor_items(masters[name])}
        template = {key: t for key, t in tensor_items(shape_of) if id(t) in want}
        mesh = self.mesh

        def read(step):
            arrays = read_arrays(root, step, list(template), verify=True)
            for key, t in template.items():
                a = arrays[key]
                if a.shape != t.shape or a.dtype != t.dtype:
                    raise CheckpointError(
                        f"step_{step}: {key} is {a.dtype}{list(a.shape)} on disk, "
                        f"{t.dtype}{list(t.shape)} in the master")
            return arrays

        def _restore_newest_verified():
            steps = candidate_steps(root) if is_leader(mesh) else []
            if mesh is not None:  # the leader's list on every rank
                n = broadcast_ints(mesh, [len(steps)], 1)[0]
                steps = broadcast_ints(mesh, steps, n)
            rejections = []
            for s in steps:
                try:
                    arrays, err = read(s), None
                except Exception as e:
                    arrays, err = None, e
                    rejections.append(f"step_{s}: {type(e).__name__}: {e}")
                if vote_any(mesh, [err is not None])[0]:  # every rank moves on together
                    if err is None:
                        rejections.append(f"step_{s}: another rank's read failed")
                    continue
                return s, arrays
            raise CheckpointError(
                f"tier heal: no verified checkpoint under {root!r}: "
                + " | ".join(rejections[:4]))

        policy = retry_policy if retry_policy is not None else self.retry
        step, arrays = policy.call(_restore_newest_verified, op="tier_heal_restore")
        restored = map_tensors(shape_of, lambda key, t: arrays.get(key, t))
        restored_tabs = self.trainer.tier_tables(restored)
        tabs = self.trainer.tier_tables(state)
        for name in names:
            tt = self.tables[name]
            tt.master.reload(restored_tabs[name])
            tt.writeback_resident(tabs[name])
        return step, names

    def summary(self) -> Dict:
        out = self.stats.as_dict()
        out["async_flush"] = bool(self.flusher is not None)
        out["flush_queue_depth"] = (
            self.flusher.qsize() if self.flusher is not None else 0)
        out["prefetch_depth"] = self.prefetch_depth
        out["prefetch_auto"] = self.prefetch_auto
        out["transparent"] = self.all_transparent
        out["master_dtype"] = self.master_dtype
        out["tables"] = {
            name: {
                "budget_slots": tt.budget,
                "master_units": tt.master.units,
                "unit_bytes": tt.master.unit_nbytes,
                "host_unit_bytes": tt.master.host_unit_nbytes,
                "resident": int((tt.unit_of >= 0).sum()),
                "dirty": int(tt.dirty.sum()),
            }
            for name, tt in self.tables.items()
        }
        return out

    def _publish(self) -> None:
        """Mirror the shared counters into the telemetry registry (deltas —
        registry counters are inc-only)."""
        reg = self.registry
        if reg is None:
            return
        reg.gauge("tier_cache_hit_rate").set(self.stats.hit_rate)
        if self.flusher is not None:
            reg.gauge("tier_flush_queue_depth").set(self.flusher.qsize())
        for key in ("h2d_bytes", "d2h_bytes", "faults", "faulted_rows",
                    "evictions", "flushed_rows"):
            cur = getattr(self.stats, key)
            delta = cur - self._published.get(key, 0)
            if delta:
                reg.counter(f"tier_{key}").inc(delta)
                self._published[key] = cur
