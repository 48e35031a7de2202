"""Tiered parameter store: host-RAM masters + a device working-set cache —
the JAX package's ``tiered/``, with PyTorch inside.

Enabled with ``table_tier: host`` (the default ``device`` keeps the tables
resident on the card and pays nothing). ``README.md`` ("The tiered store on
the card") lists the keys.

The freshness tee (``TieredTable.delta_tap``, called after each landed
write-back, and ``TierManager.flush_dirty``, the publish barrier) feeds the
delta publisher of ``freshness/``. Under a ``(data, model)`` mesh the cache
plane is row-sharded over ``model`` and each rank holds the whole master
(``TieredTable(mesh=)``, ``TierManager`` on a meshed trainer); the
freshness tee and the integrity sweep under a mesh come with Queue 1 item
6, slice 6 (``ROADMAP.md``).
"""

from swiftsnails_tpu_torch.tiered.manager import TierManager
from swiftsnails_tpu_torch.tiered.store import HostMaster, TieredTable, TierStats

__all__ = ["TierManager", "TieredTable", "HostMaster", "TierStats"]
