"""Storage layer: the CertDatabase facade, domain aggregates, pluggable
durable backends, and the remote-cache fabric (reference parity with
reference storage/).

A copy of ``ct_mapreduce_tpu.storage``: the port imports nothing of the JAX package.
"""

from ct_mapreduce_tpu_torch.storage.interfaces import (  # noqa: F401
    CertDatabase,
    RemoteCache,
    StorageBackend,
)
from ct_mapreduce_tpu_torch.storage.mockcache import MockRemoteCache  # noqa: F401
from ct_mapreduce_tpu_torch.storage.knowncerts import KnownCertificates  # noqa: F401
from ct_mapreduce_tpu_torch.storage.issuermetadata import IssuerMetadata  # noqa: F401
from ct_mapreduce_tpu_torch.storage.noop import NoopBackend  # noqa: F401
from ct_mapreduce_tpu_torch.storage.localdisk import LocalDiskBackend  # noqa: F401
from ct_mapreduce_tpu_torch.storage.mockbackend import MockBackend  # noqa: F401
from ct_mapreduce_tpu_torch.storage.certdb import FilesystemDatabase  # noqa: F401
