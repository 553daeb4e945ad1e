"""Generated protobuf messages + hand-written gRPC stubs for `at2.AT2`.

Counterpart of ``at2_node_tpu/proto/__init__.py``.

`at2_pb2` is generated from `at2.proto` by `protoc --python_out` (the
grpc_tools codegen plugin is unavailable in this environment, so the
service stubs in `rpc.py` are written by hand against `grpc.aio`'s generic
handler API — functionally identical to what `protoc-gen-grpc-python`
would emit).
"""

from . import at2_pb2

__all__ = ["at2_pb2"]
