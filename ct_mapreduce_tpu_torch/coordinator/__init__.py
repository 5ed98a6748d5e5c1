"""Leader election and the start barrier over a RemoteCache."""

from ct_mapreduce_tpu_torch.coordinator.coordinator import Coordinator  # noqa: F401
