# -*- coding: utf-8 -*-
"""Runtime-built protobuf messages for the finality RPC surface.

Counterpart of ``at2_node_tpu/proto/finality_pb2.py``.

`at2_pb2.py` is a frozen protoc artifact (a serialized FileDescriptorProto
blob) and the grpc_tools protoc plugin is not available in this
environment, so the GetCertificate pair is described here with explicit
descriptor_pb2 construction and registered in the default pool at import
time — same wire semantics as if `finality.proto` had been compiled:

    message GetCertificateRequest {}
    message GetCertificateReply {
      bool   enabled       = 1;  // [finality] table on at the serving node
      uint64 epoch         = 2;  // serving node's current membership epoch
      uint64 node_commits  = 3;  // serving node's commit frontier NOW
      repeated bytes certificates = 4;  // Certificate.encode(), oldest first
    }
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_FILE_NAME = "at2_finality.proto"
_PACKAGE = "at2"


def _build_file() -> descriptor_pb2.FileDescriptorProto:
    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.name = _FILE_NAME
    fdp.package = _PACKAGE
    fdp.syntax = "proto3"

    fdp.message_type.add().name = "GetCertificateRequest"

    reply = fdp.message_type.add()
    reply.name = "GetCertificateReply"
    f = reply.field.add()
    f.name, f.number = "enabled", 1
    f.type = descriptor_pb2.FieldDescriptorProto.TYPE_BOOL
    f.label = descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL
    f = reply.field.add()
    f.name, f.number = "epoch", 2
    f.type = descriptor_pb2.FieldDescriptorProto.TYPE_UINT64
    f.label = descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL
    f = reply.field.add()
    f.name, f.number = "node_commits", 3
    f.type = descriptor_pb2.FieldDescriptorProto.TYPE_UINT64
    f.label = descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL
    f = reply.field.add()
    f.name, f.number = "certificates", 4
    f.type = descriptor_pb2.FieldDescriptorProto.TYPE_BYTES
    f.label = descriptor_pb2.FieldDescriptorProto.LABEL_REPEATED
    return fdp


_pool = descriptor_pool.Default()
try:
    _file = _pool.Add(_build_file())
except Exception:
    # already registered (module reloaded, or a parallel import raced us)
    _file = _pool.FindFileByName(_FILE_NAME)


def _message_class(name: str):
    desc = _file.message_types_by_name[name]
    get = getattr(message_factory, "GetMessageClass", None)
    if get is not None:  # protobuf >= 4
        return get(desc)
    return message_factory.MessageFactory(_pool).GetPrototype(desc)


GetCertificateRequest = _message_class("GetCertificateRequest")
GetCertificateReply = _message_class("GetCertificateReply")
