"""Cluster supervision: the reference Master role (rendezvous + lifecycle)
reproduced as lease-based membership, straggler mitigation, and elastic
data-shard reassignment with exactly-once batch accounting — the JAX
package's ``cluster/accounting.py`` and ``cluster/supervisor.py``, kept as
the port's own copies. The port's network plane (``net/fleet.py``) runs its
replica liveness on these leases; the cluster worker and simulator are not
ported yet (``ROADMAP.md``).

See docs/CLUSTER.md for the lease/watermark protocol.
"""

from swiftsnails_tpu_torch.cluster.accounting import (
    BatchAccountant, RangeLease, compress_ranges, expand_ranges,
)
from swiftsnails_tpu_torch.cluster.supervisor import (
    STRAGGLER_FACTOR, STRAGGLER_SHARE, Supervisor, WorkerLost,
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
]
