"""Hand-written grpc.aio service/client stubs for the `at2.AT2` service.

Counterpart of ``at2_node_tpu/proto/rpc.py``.

Replaces the codegen the reference gets from tonic-build
(`at2-node/build.rs:2`, `at2-node/src/proto.rs:1-6`): the
same four unary RPCs under the fully-qualified service name `at2.AT2`
(`at2-node/src/at2.proto:4-9`), here registered via
`grpc.method_handlers_generic_handler` because the grpc_tools protoc
plugin is not available in this environment.
"""

from __future__ import annotations

import grpc

from . import at2_pb2 as pb
from . import finality_pb2 as fpb

SERVICE_NAME = "at2.AT2"

# method name -> (request type, reply type); mirrors at2.proto's service
# block one-to-one.
_METHODS = {
    "SendAsset": (pb.SendAssetRequest, pb.SendAssetReply),
    "SendAssetBatch": (pb.SendAssetBatchRequest, pb.SendAssetReply),
    "GetBalance": (pb.GetBalanceRequest, pb.GetBalanceReply),
    "GetLastSequence": (pb.GetLastSequenceRequest, pb.GetLastSequenceReply),
    "GetLatestTransactions": (
        pb.GetLatestTransactionsRequest,
        pb.GetLatestTransactionsReply,
    ),
    # Broker ingress tier: directory registration + distilled
    # batch submission (proto/distill.py wire format inside `frame`).
    "Register": (pb.RegisterRequest, pb.RegisterReply),
    "SendDistilledBatch": (pb.SendDistilledBatchRequest, pb.SendAssetReply),
    # Finality lane (finality/): the certificate chain + the serving
    # node's live commit frontier, for light clients and wait_final().
    "GetCertificate": (fpb.GetCertificateRequest, fpb.GetCertificateReply),
}


class At2Servicer:
    """Subclass and override the four handlers, then `add_to_server`."""

    async def SendAsset(self, request, context):
        raise NotImplementedError

    async def SendAssetBatch(self, request, context):
        raise NotImplementedError

    async def GetBalance(self, request, context):
        raise NotImplementedError

    async def GetLastSequence(self, request, context):
        raise NotImplementedError

    async def GetLatestTransactions(self, request, context):
        raise NotImplementedError

    async def Register(self, request, context):
        raise NotImplementedError

    async def SendDistilledBatch(self, request, context):
        raise NotImplementedError

    async def GetCertificate(self, request, context):
        raise NotImplementedError


def add_to_server(servicer: At2Servicer, server: grpc.aio.Server) -> None:
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=rep.SerializeToString,
        )
        for name, (req, rep) in _METHODS.items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )


class At2Stub:
    """Async client stub over a `grpc.aio.Channel`."""

    def __init__(self, channel: grpc.aio.Channel) -> None:
        for name, (req, rep) in _METHODS.items():
            setattr(
                self,
                name,
                channel.unary_unary(
                    f"/{SERVICE_NAME}/{name}",
                    request_serializer=req.SerializeToString,
                    response_deserializer=rep.FromString,
                ),
            )
