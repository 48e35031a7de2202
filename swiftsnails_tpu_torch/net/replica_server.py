"""A replica process: one Servant behind pull/topk/score/health RPCs — the
JAX package's ``net/replica_server.py``, in the port.

The reference's ``server`` role binary reborn (survey §2.7) — spawnable as::

    python -m swiftsnails_tpu_torch.net.replica_server \\
        --root CKPT_ROOT --listen 127.0.0.1:0 --config dim=16 ... [--device cpu]

On startup it loads the checkpoint onto its device (the card unless
``--device cpu`` is given; without a card it raises), binds (port 0 =
ephemeral), and prints ONE JSON ready line to stdout — ``{"port": ...,
"incarnation": ...}`` — which is how the spawner (``net/fleet.py``) learns
the address. A fresh ``incarnation`` id is minted per process start (the
same uuid discipline as a delta publisher's id in ``freshness/log.py``): a
respawned replica rejoining the ring is distinguishable from the one that
died. Each process opens its own CUDA context; the spawner starts it as a
new interpreter, never by ``fork``.

Every reply to a ``health``/``stats``/write op carries a ``snapshot``
(version / step / queue depths / breaker states / incarnation) that the
client caches for the router's hot-path introspection. ``stats`` also
carries the process's row-kernel launch counts (``launches``), so a caller
can show that a remote pull or apply went through the kernels.

Rows cross the wire as host numpy arrays: the Servant's answers are on the
host already (``pull`` and ``score`` copy their results off the card before
they return), and :func:`~swiftsnails_tpu_torch.net.wire.pack_arrays`
packs only numpy.

Write ops carry the fleet's shared cache epoch; an epoch at/below the
replica's current version is refused with a typed ``StaleEpoch`` — the
heal-side guarantee that a partitioned replica cannot accept a stale
write (it must resync via ``reload_checkpoint`` instead).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import uuid
from typing import Dict, Optional, Tuple

import numpy as np

from swiftsnails_tpu_torch.net.remote import StaleEpoch, jsonable
from swiftsnails_tpu_torch.net.rpc import RpcServer
from swiftsnails_tpu_torch.net.wire import pack_arrays, unpack_arrays


def kernel_launches() -> Dict[str, int]:
    """This process's launch counts of the row kernels the serving path
    runs (``gather_rows`` for pulls, ``scatter_write_rows`` for applies)."""
    from swiftsnails_tpu_torch.ops import rowdma

    return {"gather_rows": rowdma.gather_rows.launches,
            "scatter_write_rows": rowdma.scatter_write_rows.launches}


class ServantRpcServer:
    """Wrap a live Servant in an :class:`RpcServer` (the process entry
    below uses this; tests wrap an in-process Servant the same way)."""

    def __init__(self, servant, *, host: str = "127.0.0.1", port: int = 0,
                 config=None, checkpoint_root: Optional[str] = None,
                 ledger=None):
        self.servant = servant
        self.config = config
        self.checkpoint_root = checkpoint_root
        self.incarnation = uuid.uuid4().hex[:12]
        self._write_lock = threading.Lock()
        self.server = RpcServer({
            "pull": self._pull,
            "topk": self._topk,
            "score": self._score,
            "health": self._health,
            "stats": self._stats,
            "apply_rows": self._apply_rows,
            "reload_checkpoint": self._reload_checkpoint,
            "ping": self._ping,
        }, host=host, port=port, ledger=ledger, name="replica")

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def start(self) -> "ServantRpcServer":
        self.server.start()
        return self

    def stop(self) -> None:
        self.server.stop()

    # -- snapshot ------------------------------------------------------------

    def _snapshot(self) -> Dict:
        s = self.servant
        return {
            "version": int(s.version),
            "step": int(s.step),
            "queue_depths": {k: int(v) for k, v in s.queue_depths().items()},
            "breakers": {k: br.state for k, br in s.breakers.items()},
            "incarnation": self.incarnation,
        }

    # -- handlers ------------------------------------------------------------

    def _pull(self, header: Dict, payload: bytes) -> Tuple[Dict, bytes]:
        ids = unpack_arrays(header.get("arrays"), payload)["ids"]
        rows = np.asarray(self.servant.pull(ids, table=header.get("table")))
        index, out = pack_arrays({"rows": rows})
        return {"arrays": index}, out

    def _topk(self, header: Dict, payload: bytes) -> Tuple[Dict, bytes]:
        q = unpack_arrays(header.get("arrays"), payload)["query"]
        hits = self.servant.topk(
            q, k=header.get("k"), table=header.get("table"),
            exclude=tuple(header.get("exclude") or ()),
            normalize=bool(header.get("normalize", True)))
        return {"topk": [[int(i), float(s)] for i, s in hits]}, b""

    def _score(self, header: Dict, payload: bytes) -> Tuple[Dict, bytes]:
        feats = unpack_arrays(header.get("arrays"), payload)["feats"]
        scores = np.asarray(self.servant.score(feats), np.float32)
        index, out = pack_arrays({"scores": scores})
        return {"arrays": index}, out

    def _health(self, header: Dict, payload: bytes) -> Tuple[Dict, bytes]:
        return {"health": jsonable(self.servant.health()),
                "snapshot": self._snapshot()}, b""

    def _stats(self, header: Dict, payload: bytes) -> Tuple[Dict, bytes]:
        return {"stats": jsonable({**self.servant.stats(), "launches": kernel_launches()}),
                "snapshot": self._snapshot()}, b""

    def _ping(self, header: Dict, payload: bytes) -> Tuple[Dict, bytes]:
        return {"snapshot": self._snapshot()}, b""

    def _apply_rows(self, header: Dict, payload: bytes) -> Tuple[Dict, bytes]:
        version = header.get("version")
        arrays = unpack_arrays(header.get("arrays"), payload)
        updates: Dict[str, Tuple] = {}
        for name, meta in (header.get("tables") or {}).items():
            values = arrays[f"{name}/values"]
            if meta.get("scales"):
                # int8-quantized rows cross the wire raw; dequantize with
                # the delta log's own codec before the scatter
                from swiftsnails_tpu_torch.tiered.store import _np_dequant_unit_rows

                values = _np_dequant_unit_rows(
                    values, arrays[f"{name}/scales"], np.float32)
            updates[name] = (arrays[f"{name}/rows"], values)
        with self._write_lock:
            if version is not None and int(version) <= self.servant.version:
                raise StaleEpoch(
                    f"epoch {version} <= served version "
                    f"{self.servant.version} (resync, don't regress)")
            new_version = self.servant.apply_rows(
                updates,
                version=int(version) if version is not None else None,
                step=header.get("step"))
        return {"version": int(new_version),
                "snapshot": self._snapshot()}, b""

    def _reload_checkpoint(self, header: Dict,
                           payload: bytes) -> Tuple[Dict, bytes]:
        root = header.get("root") or self.checkpoint_root
        if root is None:
            raise ValueError("reload_checkpoint: no checkpoint root")
        with self._write_lock:
            version = self.servant.reload_from_checkpoint(
                root, self.config, step=header.get("step"))
        return {"version": int(version), "step": int(self.servant.step),
                "snapshot": self._snapshot()}, b""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="replica_server",
        description="serve one checkpoint over TCP (pull/topk/score/health)")
    ap.add_argument("--root", required=True, help="checkpoint root")
    ap.add_argument("--listen", default="127.0.0.1:0",
                    help="host:port (port 0 = ephemeral, printed on stdout)")
    ap.add_argument("--config", action="append", default=[],
                    metavar="K=V", help="typed config overrides")
    ap.add_argument("--ledger", default="", help="run-ledger path")
    ap.add_argument("--device", default="",
                    help="cuda (the default: the card) or cpu")
    args = ap.parse_args(argv)

    from swiftsnails_tpu_torch.serving.engine import Servant
    from swiftsnails_tpu_torch.utils.config import Config

    cfg = Config()
    for kv in args.config:
        k, _, v = kv.partition("=")
        cfg.set(k.strip(), v.strip())
    ledger = None
    if args.ledger:
        from swiftsnails_tpu_torch.telemetry.ledger import Ledger

        ledger = Ledger(args.ledger)
    host, _, port = args.listen.rpartition(":")
    servant = Servant.from_checkpoint(args.root, cfg, ledger=ledger,
                                      device=args.device or None)
    rs = ServantRpcServer(servant, host=host or "127.0.0.1",
                          port=int(port or 0), config=cfg,
                          checkpoint_root=args.root, ledger=ledger).start()
    print(json.dumps({
        "port": rs.address[1], "host": rs.address[0],
        "incarnation": rs.incarnation, "step": int(servant.step),
        "device": str(servant.device),
    }), flush=True)
    try:
        threading.Event().wait()  # serve until killed (SIGTERM/SIGKILL)
    except KeyboardInterrupt:
        pass
    finally:
        rs.stop()
        servant.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
