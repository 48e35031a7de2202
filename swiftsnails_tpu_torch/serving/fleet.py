"""The serving fleet: N Servant replicas behind an affinity/hedging router.

The JAX package's ``serving/fleet.py`` over the port's
:class:`~swiftsnails_tpu_torch.serving.engine.Servant`: pure Python
threads; replicas share the loaded tensors on the card.

A single :class:`~swiftsnails_tpu_torch.serving.engine.Servant` is one admission
queue, one hot-row LRU, one set of batcher threads — its QPS is the fleet ceiling no
matter how fast the kernels are. The reference system scaled reads by
running many servant processes behind a key-hash router (PAPER §0 serves
"heavy traffic from millions of users"); :class:`Fleet` is the in-process
analog: N replicas sharing the *same* loaded checkpoint planes (served
tensors are never written in place: a delta or reload installs new ones —
replication costs threads and per-replica caches, not table memory) behind four routing layers:

1. **Affinity** (:class:`~swiftsnails_tpu_torch.serving.router.HashRing`):
   ``pull``/``topk`` requests route by their hashed key slice so each
   replica's version-keyed hot-row LRU stays warm for its 1/N of the
   anchor space. ``score`` has no key identity and routes least-loaded.
2. **Bounded spill** (:func:`~swiftsnails_tpu_torch.serving.router.spill_order`):
   a deep-queued owner sheds overflow to the next ring node instead of
   queueing it (``serve_ring_spill`` load factor).
3. **Hedging**: when a request outlives the EWMA-tracked per-kernel p95
   (``serve_hedge_p95_ms`` floor), it is duplicated to the next ring
   replica; first writer wins, the loser's answer is discarded when it
   lands (an in-flight micro-batch cannot be revoked — the *result* is
   cancelled, not the kernel). ``serve.hedged`` / ``serve.hedge_won``
   count both edges and :class:`~swiftsnails_tpu_torch.serving.router.HedgeGovernor`
   caps the hedge rate at ``serve_hedge_budget_pct``.
4. **Breaker awareness**: replicas whose per-kernel breaker is open
   sort to the back of every candidate list — a degraded replica serves
   only when it is the last one standing. A typed
   :class:`~swiftsnails_tpu_torch.serving.breaker.Unavailable` /
   :class:`~swiftsnails_tpu_torch.serving.engine.Overloaded` from the winner
   triggers one synchronous re-route to the next healthy candidate.

**Elastic add/drain.** :meth:`Fleet.add_replica` spins a fresh replica over
the shared planes and splices its vnodes into the ring (only adjacent keys
move). :meth:`Fleet.drain` removes the replica from the ring first — new
requests re-route immediately — then blocks until its in-flight requests
finish before closing it: connection draining, no mid-request kills. Both
edges land in the run ledger as ``drain`` events.

Per-replica injectable hooks (``Replica.request_hook`` at admission, the
engine's ``Servant.fault_hook`` at dispatch) are the chaos/bench seam: a
drill slows or kills exactly one replica through them.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from swiftsnails_tpu_torch.serving.breaker import OPEN, Unavailable
from swiftsnails_tpu_torch.serving.engine import (
    DEFAULT_BREAKER_COOLDOWN_MS,
    DEFAULT_BREAKER_PROBES,
    DEFAULT_BREAKER_THRESHOLD,
    Overloaded,
    Servant,
    _normalize_state_tables,
)
from swiftsnails_tpu_torch.serving.router import (
    DEFAULT_HEDGE_BUDGET_PCT,
    DEFAULT_HEDGE_P95_MS,
    DEFAULT_SPILL,
    DEFAULT_VNODES,
    EwmaQuantile,
    HashRing,
    HedgeGovernor,
    route_annotation,
    route_hash,
    spill_order,
)
from swiftsnails_tpu_torch.telemetry import request_trace

ACTIVE = "active"
DRAINING = "draining"
CLOSED = "closed"

_KERNELS = ("pull", "topk", "score")
_REQUEST_TIMEOUT_S = 120.0


class Replica:
    """One Servant plus the fleet's view of it: id, lifecycle state,
    in-flight accounting (what drain waits on), and the injectable
    per-replica ``request_hook(kernel)`` — called on the fleet worker
    thread at admission, before the servant sees the request; it may stall
    (a slow replica) or raise (a sick one)."""

    __slots__ = ("id", "servant", "state", "inflight", "request_hook",
                 "requests", "_cv")

    def __init__(self, rid: str, servant: Servant):
        self.id = rid
        self.servant = servant
        self.state = ACTIVE
        self.inflight = 0
        self.requests = 0
        self.request_hook: Optional[Callable[[str], None]] = None
        self._cv = threading.Condition()

    def begin(self) -> None:
        with self._cv:
            self.inflight += 1
            self.requests += 1

    def end(self) -> None:
        with self._cv:
            self.inflight -= 1
            if self.inflight <= 0:
                self._cv.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while self.inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=left)
            return True

    def load(self, kernel: str) -> int:
        """Fleet-visible load: requests the fleet has admitted but not
        finished, plus what is already queued inside the engine (the
        queue-depth introspection the spill policy keys on)."""
        return self.inflight + self.servant.queue_depths().get(kernel, 0)


class _Flight:
    """First-writer-wins rendezvous between a primary and its hedge."""

    __slots__ = ("done", "winner", "errors", "pending", "_lock")

    def __init__(self):
        self.done = threading.Event()
        self.winner = None  # (replica_id, result, hedged)
        self.errors: List[BaseException] = []
        self.pending = 0
        self._lock = threading.Lock()

    def arm(self) -> None:
        with self._lock:
            self.pending += 1

    def complete(self, rid: str, result, error, hedged: bool) -> bool:
        """Record one leg's outcome; returns True iff this leg won."""
        with self._lock:
            self.pending -= 1
            if error is None and self.winner is None:
                self.winner = (rid, result, hedged)
                self.done.set()
                return True
            if error is not None:
                self.errors.append(error)
            if self.pending == 0 and self.winner is None:
                self.done.set()  # all legs failed: release the caller
            return False


class Fleet:
    """N replicas, one query API (``pull``/``topk``/``score`` mirror the
    Servant's signatures, plus an optional explicit ``key=`` affinity
    override).

    ``factory(replica_id) -> Servant`` builds each replica; pass ``first``
    to adopt an already-constructed Servant as replica 0 (how
    :meth:`from_checkpoint` avoids loading the planes twice). ``registry``
    holds the fleet-level counters/histograms; each Servant keeps its own
    per-replica registry.
    """

    def __init__(
        self,
        factory: Callable[[str], Servant],
        *,
        replicas: int = 1,
        first: Optional[Servant] = None,
        registry=None,
        ledger=None,
        hedge_budget_pct: float = DEFAULT_HEDGE_BUDGET_PCT,
        hedge_p95_ms: float = DEFAULT_HEDGE_P95_MS,
        ring_spill: float = DEFAULT_SPILL,
        vnodes: int = DEFAULT_VNODES,
        affinity: bool = True,
        max_inflight: int = 64,
        clock: Callable[[], float] = time.perf_counter,
        request_tracer=None,
        slo=None,
    ):
        if replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if registry is None:
            from swiftsnails_tpu_torch.telemetry.registry import MetricRegistry

            registry = MetricRegistry()
        self.registry = registry
        self.ledger = ledger
        # ops plane: one fleet-level RequestTracer owns each request's span
        # tree (per-attempt child spans ride in from replica servants via
        # the thread-local context); one SloTracker burns the error budget.
        self.request_tracer = request_tracer
        self.slo = slo
        self._freshness = None  # an attached DeltaSubscriber (health rollup)
        self.affinity = bool(affinity)
        self.ring_spill = float(ring_spill)
        self.hedge_p95_ms = float(hedge_p95_ms)
        self._factory = factory
        self._clock = clock
        self._lock = threading.Lock()
        self._next_rid = 0
        self._rr = 0  # round-robin cursor for keyless (no-affinity) routing
        self._replicas: Dict[str, Replica] = {}
        self._ring = HashRing(vnodes=vnodes)
        self._gov = HedgeGovernor(hedge_budget_pct)
        self._p95 = {k: EwmaQuantile(initial=hedge_p95_ms) for k in _KERNELS}
        self._hedge_events = 0
        self._pool = ThreadPoolExecutor(
            max_workers=max(int(max_inflight), 2 * replicas + 2),
            thread_name_prefix="ssn-fleet",
        )
        for _ in range(replicas):
            self._add(first)
            first = None

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def from_checkpoint(
        cls,
        root: str,
        config,
        *,
        step: Optional[int] = None,
        mesh=None,
        device=None,
        replicas: Optional[int] = None,
        registry=None,
        ledger=None,
        **servant_kwargs,
    ) -> "Fleet":
        """Load the checkpoint ONCE, then replicate the read path.

        Replica 0 is a plain :meth:`Servant.from_checkpoint`; every further
        replica is constructed over replica 0's already-normalized (and
        already device-resident) planes — N replicas share one copy of the
        tables and differ only in batchers, caches, and breakers. Fleet
        knobs come from the same typed config: ``serve_replicas``,
        ``serve_hedge_budget_pct``, ``serve_hedge_p95_ms``,
        ``serve_ring_spill``. The planes load on ``device`` (default: the
        card).
        """
        # trace + SLO live at the FLEET level (one trace per request, one
        # budget per fleet); replicas join the active context instead of
        # minting their own, so their servants get neither
        from swiftsnails_tpu_torch.telemetry.request_trace import RequestTracer
        from swiftsnails_tpu_torch.telemetry.slo import SloTracker

        tracer = servant_kwargs.pop(
            "request_tracer", None) or RequestTracer.from_config(
                config, ledger=ledger, source="fleet")
        slo = servant_kwargs.pop(
            "slo", None) or SloTracker.from_config(
                config, ledger=ledger, source="fleet")
        proto = Servant.from_checkpoint(
            root, config, step=step, mesh=mesh, device=device, ledger=ledger,
            request_tracer=None, slo=None, **servant_kwargs)
        n = int(replicas) if replicas is not None else \
            config.get_int("serve_replicas", 1)

        def factory(rid: str) -> Servant:
            return Servant(
                proto._tables,
                manifest=proto.manifest,
                device=proto.device,
                scorer=proto.scorer,
                dense=proto._dense,
                default_table=proto.default_table,
                ledger=ledger,
                batch_buckets=proto.buckets,
                cache_rows=proto.cache.capacity,
                queue_depth=proto._batchers["pull"].queue_depth,
                comm_dtype=proto.comm_dtype,
                topk=proto.topk_default,
                topk_tile_rows=proto.topk_tile_rows,
                tier_hbm_budget_mb=proto.tier_budget_mb,
                breaker_threshold=config.get_int(
                    "breaker_threshold", DEFAULT_BREAKER_THRESHOLD),
                breaker_cooldown_ms=config.get_float(
                    "breaker_cooldown_ms", DEFAULT_BREAKER_COOLDOWN_MS),
                breaker_halfopen_probes=config.get_int(
                    "breaker_halfopen_probes", DEFAULT_BREAKER_PROBES),
                degraded=config.get_bool("serve_degraded", True),
            )

        return cls(
            factory,
            replicas=n,
            first=proto,
            registry=registry,
            ledger=ledger,
            hedge_budget_pct=config.get_float(
                "serve_hedge_budget_pct", DEFAULT_HEDGE_BUDGET_PCT),
            hedge_p95_ms=config.get_float(
                "serve_hedge_p95_ms", DEFAULT_HEDGE_P95_MS),
            ring_spill=config.get_float("serve_ring_spill", DEFAULT_SPILL),
            request_tracer=tracer,
            slo=slo,
        )

    def _add(self, servant: Optional[Servant] = None) -> Replica:
        with self._lock:
            rid = f"r{self._next_rid}"
            self._next_rid += 1
        rep = Replica(rid, servant if servant is not None else
                      self._factory(rid))
        with self._lock:
            self._replicas[rid] = rep
            self._ring.add(rid)
        return rep

    def add_replica(self) -> str:
        """Elastic scale-up: a new replica over the shared planes joins the
        ring; only the keys adjacent to its vnode points move to it."""
        rep = self._add()
        self.registry.counter("fleet.replicas_added").inc()
        return rep.id

    def drain(self, replica_id: str, timeout_s: float = 30.0) -> Dict:
        """Connection-draining removal: ring exit first (new requests
        re-route from this instant), then wait for in-flight requests to
        finish, then close the underlying servant. Returns the drain
        record; both edges land in the ledger as ``drain`` events."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None or rep.state != ACTIVE:
                raise KeyError(f"no active replica {replica_id!r}")
            rep.state = DRAINING
            self._ring.remove(replica_id)
            inflight_at_start = rep.inflight
        self._ledger_event("drain", {
            "phase": "start",
            "replica": replica_id,
            "inflight": inflight_at_start,
            "remaining_replicas": len(self._ring),
        })
        t0 = time.monotonic()
        drained = rep.wait_idle(timeout_s)
        waited_ms = (time.monotonic() - t0) * 1e3
        rep.state = CLOSED
        rep.servant.close()
        with self._lock:
            self._replicas.pop(replica_id, None)
        self.registry.counter("fleet.replicas_drained").inc()
        record = {
            "phase": "complete",
            "replica": replica_id,
            "inflight_at_start": inflight_at_start,
            "waited_ms": round(waited_ms, 3),
            "clean": bool(drained),
            "remaining_replicas": len(self._ring),
        }
        self._ledger_event("drain", record)
        return record

    def configure(
        self,
        *,
        affinity: Optional[bool] = None,
        hedge_budget_pct: Optional[float] = None,
        hedge_p95_ms: Optional[float] = None,
        ring_spill: Optional[float] = None,
    ) -> "Fleet":
        """Post-construction routing-knob override (bench legs and tests
        build control fleets this way); returns ``self`` for chaining."""
        if affinity is not None:
            self.affinity = bool(affinity)
        if hedge_budget_pct is not None:
            self._gov = HedgeGovernor(float(hedge_budget_pct))
        if hedge_p95_ms is not None:
            self.hedge_p95_ms = float(hedge_p95_ms)
            self._p95 = {k: EwmaQuantile(initial=self.hedge_p95_ms)
                         for k in _KERNELS}
        if ring_spill is not None:
            self.ring_spill = float(ring_spill)
        return self

    # -- fleet-wide epoch cutover -------------------------------------------
    #
    # Shared-plane swaps (delta apply, live reload) must land every replica
    # on the SAME cache version: independent per-replica bumps would let two
    # replicas disagree mid-cutover on which planes a version number means.
    # One epoch — strictly above every replica's current version — is chosen
    # up front and installed everywhere.

    @property
    def step(self) -> int:
        """Newest checkpoint/watermark step any replica serves."""
        with self._lock:
            return max((r.servant.step for r in self._replicas.values()),
                       default=0)

    @property
    def version(self) -> int:
        """The fleet cache epoch (max over replicas; equal everywhere
        outside the instants of a cutover)."""
        with self._lock:
            return max((r.servant.version for r in self._replicas.values()),
                       default=0)

    def _next_epoch(self) -> int:
        with self._lock:
            return max((r.servant.version for r in self._replicas.values()),
                       default=0) + 1

    def apply_rows(self, updates: Dict[str, Any], *,
                   step: Optional[int] = None) -> int:
        """Apply one delta batch fleet-wide at a single epoch.

        Resident replicas share one set of planes, so the post-delta tensors
        are computed ONCE (``prepare_rows`` on the first replica) and the
        same tensors install into every replica — no replica ever serves a
        torn batch, and every cache cuts over to the same version. Tiered
        replicas own separate host masters and apply individually, still at
        the shared epoch."""
        epoch = self._next_epoch()
        reps = self.replicas()
        if not reps:
            raise Unavailable("fleet: no active replicas")
        first = reps[0].servant
        if first.tier_budget_mb > 0:
            for rep in reps:
                rep.servant.apply_rows(updates, version=epoch, step=step)
            return epoch
        new_tables = first.prepare_rows(updates)
        for rep in reps:
            rep.servant.install_tables(new_tables, version=epoch, step=step)
        return epoch

    def reload(self, tables: Dict[str, Any], manifest: Optional[Dict] = None,
               dense=None) -> int:
        """Swap new planes into every replica at one shared epoch."""
        epoch = self._next_epoch()
        for rep in self.replicas():
            rep.servant.reload(tables, manifest=manifest, dense=dense,
                               version=epoch)
        return epoch

    def reload_from_checkpoint(self, root: str, config, *,
                               step: Optional[int] = None,
                               retry=None) -> int:
        """The fleet twin of the Servant's shadow reload: load + verify the
        checkpoint ONCE off the serving path, then cut every replica over
        to the same planes at one epoch (mixed versions can never serve)."""
        from swiftsnails_tpu_torch.framework.checkpoint import load_tables

        reps = self.replicas()
        if not reps:
            raise Unavailable("fleet: no active replicas")
        first = reps[0].servant
        try:
            state, manifest = load_tables(
                root, step=step, verify=True, retry=retry, device=first.device)
            tables, dense, _ = _normalize_state_tables(
                state, config, first.scorer, first.mesh)
        except Exception as e:
            self.registry.counter("fleet.reload_rejected").inc()
            self._ledger_event("cache_error", {
                "probe": "fleet_reload",
                "root": root,
                "step": step,
                "kept_version": self.version,
                "error": f"{type(e).__name__}: {e}",
            })
            raise
        return self.reload(tables, manifest=manifest, dense=dense)

    def attach_freshness(self, subscriber) -> None:
        """Roll a :class:`~swiftsnails_tpu_torch.freshness.subscriber.
        DeltaSubscriber`'s watermark into :meth:`health` (with every
        replica's version) and into each traced request."""
        self._freshness = subscriber

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        with self._lock:
            reps = list(self._replicas.values())
            self._replicas.clear()
        for rep in reps:
            rep.state = CLOSED
            rep.servant.close()

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- routing -----------------------------------------------------------

    def replicas(self) -> List[Replica]:
        with self._lock:
            return [r for r in self._replicas.values() if r.state == ACTIVE]

    def _breaker_open(self, rep: Replica, kernel: str) -> bool:
        br = rep.servant.breakers.get(kernel)
        return br is not None and br.state == OPEN

    def _route(self, kernel: str, key) -> Tuple[List[Replica], Dict]:
        """Candidate replicas, best first: ring order from the key's owner
        (or least-loaded when there is no affinity key), open-breaker
        replicas demoted to last resort, bounded-load spill applied within
        the healthy prefix. Returns ``(candidates, decision)`` — the
        decision is the owner-vs-spill annotation a request trace records.
        """
        keyed = self.affinity and key is not None
        with self._lock:
            active = {rid: r for rid, r in self._replicas.items()
                      if r.state == ACTIVE}
            if not active:
                raise Unavailable("fleet: no active replicas")
            if keyed:
                order = [active[rid]
                         for rid in self._ring.successors(route_hash(key))
                         if rid in active]
            else:
                # keyless spray: least-loaded with a round-robin tiebreak
                # (a stable sort over a rotated list), so an idle fleet
                # spreads instead of dog-piling the lexically-first replica
                reps = sorted(active.values(), key=lambda r: r.id)
                self._rr = (self._rr + 1) % len(reps)
                rotated = reps[self._rr:] + reps[:self._rr]
                order = sorted(rotated, key=lambda r: r.load(kernel))
        if not order:
            raise Unavailable("fleet: no routable replicas")
        healthy = [r for r in order if not self._breaker_open(r, kernel)]
        last_resort = [r for r in order if self._breaker_open(r, kernel)]
        if not healthy:
            self.registry.counter("fleet.route_last_resort").inc()
            return last_resort, route_annotation(
                [r.id for r in order], [r.id for r in last_resort],
                affinity=keyed, last_resort=True)
        picked, spilled, _cap = spill_order(
            healthy, lambda r: r.load(kernel),
            spill=self.ring_spill, active=len(order))
        if spilled:
            self.registry.counter("fleet.spill").inc()
        return picked + last_resort, route_annotation(
            [r.id for r in order], [r.id for r in picked], affinity=keyed)

    # -- request path ------------------------------------------------------

    def pull(self, ids, table: Optional[str] = None, *,
             key=None) -> np.ndarray:
        """Affinity-routed row pull. ``key`` overrides the affinity key;
        by default the request routes by its first id — the anchor of the
        key slice — so a repeated slice always warms the same replica."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        if key is None and len(ids):
            key = int(ids[0])
        return self._request(
            "pull", key, lambda s: s.pull(ids, table=table))

    def topk(self, query, k: Optional[int] = None,
             table: Optional[str] = None, exclude: Sequence[int] = (),
             normalize: bool = True, *, key=None) -> List:
        q = np.asarray(query, np.float32).reshape(-1)
        if key is None:
            key = int(q.view(np.uint32).sum())  # stable per query vector
        return self._request(
            "topk", key,
            lambda s: s.topk(q, k=k, table=table, exclude=exclude,
                             normalize=normalize))

    def score(self, feats) -> np.ndarray:
        """CTR scores; no key identity, so least-loaded routing."""
        return self._request("score", None, lambda s: s.score(feats))

    def _request(self, kernel: str, key, fn: Callable[[Servant], Any]):
        t0 = self._clock()
        rt = self.request_tracer
        ctx = None
        if rt is not None:
            try:
                ctx = rt.start(kernel)
            except Exception:
                ctx = None  # tracing never blocks the serve path
        try:
            result = self._request_traced(kernel, key, fn, t0, ctx)
        except BaseException as e:
            self._finish_request(kernel, t0, ctx, error=e)
            raise
        self._finish_request(kernel, t0, ctx)
        return result

    def _finish_request(self, kernel: str, t0: float, ctx,
                        error: Optional[BaseException] = None) -> None:
        if self.slo is not None:
            try:
                self.slo.record(kernel, (self._clock() - t0) * 1e3,
                                ok=error is None)
            except Exception:
                pass  # record-keeping never blocks the serve path
        if ctx is not None and self.request_tracer is not None:
            try:
                self.request_tracer.finish(ctx, error=error)
            except Exception:
                pass

    def _request_traced(self, kernel: str, key,
                        fn: Callable[[Servant], Any], t0: float, ctx):
        self._gov.note_request()
        self.registry.counter(f"fleet.{kernel}.requests").inc()
        candidates, decision = self._route(kernel, key)
        if ctx is not None:
            ctx.annotate(**decision)
            fr = self._freshness
            if fr is not None:
                try:
                    ctx.annotate(watermark_step=fr.applied_step,
                                 watermark_age_ms=round(fr.last_lag_ms, 3))
                except Exception:
                    pass
        flight = _Flight()
        launched: List[Replica] = []

        def launch(rep: Replica, hedged: bool) -> None:
            flight.arm()
            launched.append(rep)
            rep.begin()
            self._pool.submit(self._run_leg, flight, rep, kernel, fn,
                              hedged, ctx)

        launch(candidates[0], hedged=False)
        budget_s = self._p95[kernel].value / 1e3
        if not flight.done.wait(timeout=budget_s):
            hedge_to = next(
                (r for r in candidates[1:] if r not in launched), None)
            if hedge_to is not None and self._gov.allow():
                self._gov.note_hedge()
                self.registry.counter("serve.hedged").inc()
                self.registry.counter(f"fleet.{kernel}.hedged").inc()
                self._note_hedge(kernel, candidates[0].id, hedge_to.id,
                                 budget_s * 1e3)
                if ctx is not None:
                    ctx.mark_anomaly("hedge")
                    ctx.annotate(hedge_to=hedge_to.id,
                                 hedge_budget_ms=round(budget_s * 1e3, 3))
                launch(hedge_to, hedged=True)
        if not flight.done.wait(timeout=_REQUEST_TIMEOUT_S):
            raise TimeoutError(f"fleet {kernel} request timed out")

        if flight.winner is not None:
            rid, result, hedged = flight.winner
            if hedged:
                self.registry.counter("serve.hedge_won").inc()
            if ctx is not None:
                ctx.annotate(winner=rid, winner_hedged=hedged)
            self._observe(kernel, t0, ctx)
            return result

        # every launched leg failed: one synchronous re-route when the
        # failure is a routable condition (breaker shed / queue full), so a
        # single sick replica costs affinity, not availability
        err = flight.errors[0] if flight.errors else \
            Unavailable(f"fleet {kernel}: request lost")
        if isinstance(err, (Unavailable, Overloaded)):
            for rep in candidates:
                if rep in launched or rep.state != ACTIVE:
                    continue
                self.registry.counter("fleet.reroute").inc()
                if ctx is not None:
                    ctx.mark_anomaly("reroute")
                rep.begin()
                try:
                    with request_trace.use(ctx):
                        if ctx is not None:
                            with ctx.span("reroute", replica=rep.id) as sp:
                                result = fn(rep.servant)
                                sp.set(outcome="won")
                        else:
                            result = fn(rep.servant)
                except BaseException as e:  # noqa: BLE001 — keep first error type
                    err = e
                    continue
                finally:
                    rep.end()
                if ctx is not None:
                    ctx.annotate(winner=rep.id, rerouted=True)
                self._observe(kernel, t0, ctx)
                return result
        raise err

    def _run_leg(self, flight: _Flight, rep: Replica, kernel: str,
                 fn: Callable[[Servant], Any], hedged: bool,
                 ctx=None) -> None:
        # per-attempt child span: replica, breaker state at admission, and
        # the first-writer-wins outcome. The thread-local activation lets
        # the replica servant hang its queue-wait/kernel spans inside this
        # attempt rather than minting its own trace.
        sp = None
        if ctx is not None:
            try:
                br = rep.servant.breakers.get(kernel)
                sp = ctx.span("attempt", replica=rep.id, hedged=hedged,
                              breaker=br.state if br is not None else "none")
                sp.__enter__()
            except Exception:
                sp = None
        activation = request_trace.use(ctx)
        activation.__enter__()
        try:
            hook = rep.request_hook
            if hook is not None:
                hook(kernel)
            result, error = fn(rep.servant), None
        except BaseException as e:  # noqa: BLE001 — delivered to the caller
            result, error = None, e
        finally:
            rep.end()
            activation.__exit__(None, None, None)
        won = flight.complete(rep.id, result, error, hedged)
        if sp is not None:
            try:
                sp.set(outcome="won" if won else
                       ("error" if error is not None else "lost"))
                if error is not None:
                    sp.set(error=type(error).__name__)
                sp.__exit__(None, None, None)
            except Exception:
                pass
        if hedged and not won and error is None:
            self.registry.counter("serve.hedge_lost").inc()

    # -- metrics / events --------------------------------------------------

    def _observe(self, kernel: str, t0: float, ctx=None) -> None:
        ms = (self._clock() - t0) * 1e3
        self._p95[kernel].observe(ms)
        # exemplar: only link traces that will be kept (sampled/anomalous)
        tid = ctx.trace_id if ctx is not None and \
            (ctx.sampled or ctx.anomalous) else None
        self.registry.histogram(f"fleet.{kernel}.latency_ms").observe(
            ms, trace_id=tid)

    def _note_hedge(self, kernel: str, primary: str, hedge: str,
                    budget_ms: float) -> None:
        """Rate-limited hedge ledger events: the first and every 100th —
        same policy as the engine's overload/degraded streams."""
        total = int(self.registry.counter("serve.hedged").value)
        if self.ledger is not None and (total == 1 or total % 100 == 0):
            self._ledger_event("hedge", {
                "kernel": kernel,
                "primary": primary,
                "hedge": hedge,
                "budget_ms": round(budget_ms, 3),
                "hedged_total": total,
                "hedge_rate_pct": round(self._gov.rate_pct, 3),
            })
            self._hedge_events = total

    def _ledger_event(self, kind: str, record: Dict) -> None:
        if self.ledger is None:
            return
        try:
            self.ledger.append(kind, {"source": "fleet", **record})
        except Exception:
            pass  # record-keeping never blocks the serve path

    def hedge_budget(self, kernel: str) -> float:
        """Current hedge-arm delay for ``kernel`` in ms (EWMA p95)."""
        return self._p95[kernel].value

    def stats(self) -> Dict:
        reg = self.registry
        with self._lock:
            reps = dict(self._replicas)
        per_replica = {}
        for rid, rep in sorted(reps.items()):
            s = rep.servant.stats()
            per_replica[rid] = {
                "state": rep.state,
                "requests": rep.requests,
                "inflight": rep.inflight,
                "queue_depths": rep.servant.queue_depths(),
                "kernels": s["kernels"],
                "cache_hit_rate": s["cache"]["hit_rate"],
                "breakers": {k: b["state"] for k, b in s["breakers"].items()},
            }
        kernels = {}
        for k in _KERNELS:
            summ = reg.histogram(f"fleet.{k}.latency_ms").summary()
            kernels[k] = {
                "requests": int(reg.counter(f"fleet.{k}.requests").value),
                "hedged": int(reg.counter(f"fleet.{k}.hedged").value),
                "p50_ms": round(summ.get("p50", 0.0), 4),
                "p95_ms": round(summ.get("p95", 0.0), 4),
                "p99_ms": round(summ.get("p99", 0.0), 4),
                "hedge_budget_ms": round(self._p95[k].value, 3),
            }
        return {
            "replicas": per_replica,
            "ring": {"members": self._ring.members(),
                     "vnodes": self._ring.vnodes,
                     "spill": self.ring_spill,
                     "affinity": self.affinity},
            "kernels": kernels,
            "hedge": self._gov.snapshot() | {
                "won": int(reg.counter("serve.hedge_won").value),
                "lost": int(reg.counter("serve.hedge_lost").value),
            },
            "spills": int(reg.counter("fleet.spill").value),
            "reroutes": int(reg.counter("fleet.reroute").value),
            "replicas_added": int(reg.counter("fleet.replicas_added").value),
            "replicas_drained": int(
                reg.counter("fleet.replicas_drained").value),
            **({"trace": self.request_tracer.stats()}
               if self.request_tracer is not None else {}),
            **({"slo": self.slo.snapshot()} if self.slo is not None else {}),
        }

    def health(self) -> Dict:
        """Fleet-level liveness: ``ok`` when every active replica is ok,
        ``degraded`` when at least one still answers, ``down`` otherwise."""
        with self._lock:
            reps = dict(self._replicas)
        statuses = {}
        for rid, rep in sorted(reps.items()):
            statuses[rid] = {
                "state": rep.state,
                "status": rep.servant.health()["status"]
                if rep.state != CLOSED else "closed",
                "version": rep.servant.version,
                "step": rep.servant.step,
            }
        active = [v for v in statuses.values() if v["state"] == ACTIVE]
        if not active:
            status = "down"
        elif all(v["status"] == "ok" for v in active):
            status = "ok"
        else:
            status = "degraded"
        out = {
            "status": status,
            "replicas": statuses,
            "active": len(active),
            "hedge": self._gov.snapshot(),
        }
        if self._freshness is not None:
            try:
                fr = self._freshness.status()
                fr["replica_versions"] = {
                    rid: v["version"] for rid, v in statuses.items()}
                out["freshness"] = fr
            except Exception:
                pass  # introspection never blocks the health probe
        return out
