"""Freshness pipeline — version-stamped hot-row delta shipping (the JAX
package's ``freshness/``, over the port's tables).

The trainer side (:mod:`.publisher`) publishes monotonically-sequenced
batches of absolute row values — sourced from the tier's dirty-flush
stream under ``table_tier: host``, or from a per-step touched-row
collector on the resident path — onto a bounded file-backed delta log
(:mod:`.log`, byte-compatible with the JAX package's). The serving side
(:mod:`.subscriber`) applies them behind the version-keyed hot-row cache
with an atomic version cutover per batch; any sequence gap, publisher
restart, or CRC mismatch falls back to the ``reload_from_checkpoint``
shadow swap and re-subscribes from the new base. See docs/FRESHNESS.md.
"""

from swiftsnails_tpu_torch.freshness.log import (  # noqa: F401
    DeltaCorrupt, list_seqs, prune, read_base, read_batch, write_base,
    write_batch,
)
from swiftsnails_tpu_torch.freshness.publisher import (  # noqa: F401
    DeltaPublisher, TouchedRowCollector, TrainPublisher,
)
from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber  # noqa: F401

__all__ = [
    "DeltaCorrupt",
    "DeltaPublisher",
    "DeltaSubscriber",
    "TouchedRowCollector",
    "TrainPublisher",
    "list_seqs",
    "prune",
    "read_base",
    "read_batch",
    "write_base",
    "write_batch",
]
