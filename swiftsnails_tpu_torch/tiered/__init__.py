"""Tiered parameter store: host-RAM masters + a device working-set cache —
the JAX package's ``tiered/``, with PyTorch inside.

Enabled with ``table_tier: host`` (the default ``device`` keeps the tables
resident on the card and pays nothing). ``README.md`` ("The tiered store on
the card") lists the keys.

The freshness tee (``TieredTable.delta_tap``, called after each landed
write-back, and ``TierManager.flush_dirty``, the publish barrier) feeds the
delta publisher of ``freshness/``. Not ported yet (``ROADMAP.md``): the tier
under a mesh (the sharded cache plane, Queue 1 item 6), which raises
``NotImplementedError``.
"""

from swiftsnails_tpu_torch.tiered.manager import TierManager
from swiftsnails_tpu_torch.tiered.store import HostMaster, TieredTable, TierStats

__all__ = ["TierManager", "TieredTable", "HostMaster", "TierStats"]
