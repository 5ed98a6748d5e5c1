"""Query plane: online membership serving over the live dedup table
(port of ``ct_mapreduce_tpu.serve``).

``storage-statistics`` answers "has this certificate been seen?" only
in batch. This package serves it online: a batched membership oracle
("is serial S known for (issuer, expDate)?") plus per-issuer metadata,
answered from epoch-pinned copies of the LIVE aggregator state while
ingest keeps running.

- :mod:`~ct_mapreduce_tpu_torch.serve.snapshot` — epoch-pinned,
  immutable read views captured under the aggregator's fold and table
  locks, pinned on the aggregator's device;
- :mod:`~ct_mapreduce_tpu_torch.serve.batcher` — deadline-driven
  dynamic micro-batching with a bounded admission queue that sheds
  with explicit ``overloaded`` rejections;
- :mod:`~ct_mapreduce_tpu_torch.serve.server` — the stdlib HTTP JSON
  API (``queryPort``; ``/query``, ``/issuer/<id>``, ``/healthz``,
  ``/getcert``) and the :class:`MembershipOracle` behind it;
  :mod:`~ct_mapreduce_tpu_torch.serve.client` is the matching client
  (the ``ct-query`` binary).
"""

from ct_mapreduce_tpu_torch.serve.batcher import (  # noqa: F401
    DeadlineExceeded,
    MicroBatcher,
    Overloaded,
)
from ct_mapreduce_tpu_torch.serve.cache import HotSerialCache  # noqa: F401
from ct_mapreduce_tpu_torch.serve.snapshot import (  # noqa: F401
    ReplicaPool,
    SnapshotManager,
    TableView,
)
