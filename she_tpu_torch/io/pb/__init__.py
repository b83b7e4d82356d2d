"""Generated protobuf modules of the reference-compatible wire formats.

The port's own copies of the seven modules she_tpu loads
(she_tpu/io/pb/__init__.py:17-23), generated by protoc from the schemas
in she_tpu/io/protos/ (reconstructed from the reference's swift-protobuf
code). Their imports of one another are package-relative, so nothing here
touches sys.path. The descriptors keep the schemas' own file and package
names: loading them beside she_tpu's copies in one process gives the same
descriptors, and both write the same bytes.
"""

from . import he_pb2  # noqa: F401  (first: the others depend on it)
from . import api_shared_pb2, pir_pb2, pnns_pb2  # noqa: F401
from . import api_pir_pb2, api_pnns_pb2  # noqa: F401
from . import api_pb2  # noqa: F401

__all__ = [
    "he_pb2",
    "pir_pb2",
    "pnns_pb2",
    "api_pb2",
    "api_shared_pb2",
    "api_pir_pb2",
    "api_pnns_pb2",
]
