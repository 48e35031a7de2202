"""Cluster supervision: the reference Master role (rendezvous + lifecycle)
reproduced as lease-based membership, straggler mitigation, and elastic
data-shard reassignment with exactly-once batch accounting — the JAX
package's ``cluster/``: the accountant, the supervisor and the worker's
leased stream here, the simulated fleet (``sim.py``), its chaos lane
(``chaos_lane.py``) and ``supervisor-status`` (``status.py``) beside them.
The port's network plane (``net/fleet.py``) runs its replica liveness on
the same leases.

See docs/CLUSTER.md for the lease/watermark protocol and the drill
cookbook.
"""

from swiftsnails_tpu_torch.cluster.accounting import (
    BatchAccountant, RangeLease, compress_ranges, expand_ranges,
)
from swiftsnails_tpu_torch.cluster.supervisor import (
    STRAGGLER_FACTOR, STRAGGLER_SHARE, Supervisor, WorkerLost,
)
from swiftsnails_tpu_torch.cluster.worker import (
    INDEX_KEY, FollowedStream, IndexedBatchSource, LeasedStream, WorkerClient,
)

__all__ = [
    "BatchAccountant",
    "RangeLease",
    "compress_ranges",
    "expand_ranges",
    "Supervisor",
    "WorkerLost",
    "STRAGGLER_FACTOR",
    "STRAGGLER_SHARE",
    "INDEX_KEY",
    "FollowedStream",
    "IndexedBatchSource",
    "LeasedStream",
    "WorkerClient",
]
