"""grpc-web / HTTP1 / CORS browser-surface tests (reference parity:
`at2-node/src/bin/server/main.rs:110-114` serves tonic-web with
`accept_http1(true)` and CORS allow-all on the same port as native gRPC).

The calls here speak raw HTTP/1.1 + grpc-web framing over a plain TCP
socket — exactly what a browser grpc-web client emits — against the same
public RPC port the native gRPC tests use (the PortMux splices the two
protocols)."""

import asyncio
import base64
import itertools

from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
from at2_node_tpu_torch.net.peers import Peer
from at2_node_tpu_torch.net.webmux import _DATA_FRAME, _TRAILER_FRAME, _frame, _parse_frames
from at2_node_tpu_torch.node.config import Config, VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.proto import at2_pb2 as pb
from at2_node_tpu_torch.types import transfer_signing_bytes

_ports = itertools.count(31600)


def _single_node_config():
    return Config(
        node_address=f"127.0.0.1:{next(_ports)}",
        rpc_address=f"127.0.0.1:{next(_ports)}",
        sign_key=SignKeyPair.random(),
        network_key=ExchangeKeyPair.random(),
        verifier=VerifierConfig(kind="cpu"),
    )


async def _http1(addr: str, request: bytes) -> tuple:
    """One raw HTTP/1.1 exchange; returns (status_line, headers, body)."""
    host, _, port = addr.rpartition(":")
    reader, writer = await asyncio.open_connection(host, int(port))
    writer.write(request)
    await writer.drain()
    raw = await reader.read(-1)  # server closes after responding
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return lines[0], headers, body


async def _grpc_web_call(addr: str, method: str, request_msg, text=False):
    """Unary grpc-web call; returns (grpc_status, reply_bytes|None)."""
    body = _frame(request_msg.SerializeToString())
    ctype = "application/grpc-web+proto"
    if text:
        body = base64.b64encode(body)
        ctype = "application/grpc-web-text+proto"
    req = (
        f"POST /at2.AT2/{method} HTTP/1.1\r\n"
        f"Host: node\r\nContent-Type: {ctype}\r\n"
        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
    ).encode() + body
    status_line, headers, payload = await _http1(addr, req)
    assert "200" in status_line, status_line
    assert headers.get("access-control-allow-origin") == "*"
    if text:
        payload = base64.b64decode(payload)
    reply = None
    grpc_status = None
    for flags, data in _parse_frames(payload):
        if flags == _DATA_FRAME:
            reply = data
        elif flags == _TRAILER_FRAME:
            for line in data.decode().split("\r\n"):
                if line.lower().startswith("grpc-status:"):
                    grpc_status = int(line.split(":", 1)[1])
    return grpc_status, reply


class TestGrpcWeb:
    async def test_cors_preflight(self):
        cfg = _single_node_config()
        service = await Service.start(cfg)
        try:
            req = (
                "OPTIONS /at2.AT2/SendAsset HTTP/1.1\r\nHost: node\r\n"
                "Origin: http://example.com\r\n"
                "Access-Control-Request-Method: POST\r\n"
                "Connection: close\r\n\r\n"
            ).encode()
            status_line, headers, _ = await _http1(cfg.rpc_address, req)
            assert "204" in status_line
            assert headers["access-control-allow-origin"] == "*"
            assert "post" in headers["access-control-allow-methods"].lower()
        finally:
            await service.close()

    async def test_send_asset_and_read_back_over_grpc_web(self):
        cfg = _single_node_config()
        service = await Service.start(cfg)
        try:
            sender, recipient = SignKeyPair.random(), SignKeyPair.random()
            request = pb.SendAssetRequest(
                sender=sender.public,
                sequence=1,
                recipient=recipient.public,
                amount=77,
                signature=sender.sign(
                    transfer_signing_bytes(
                        sender.public, 1, recipient.public, 77
                    )
                ),
            )
            status, reply = await _grpc_web_call(
                cfg.rpc_address, "SendAsset", request
            )
            assert status == 0 and reply is not None

            # poll commit via grpc-web GetLastSequence (binary mode)
            deadline = asyncio.get_event_loop().time() + 10
            seq = 0
            while asyncio.get_event_loop().time() < deadline:
                status, reply = await _grpc_web_call(
                    cfg.rpc_address,
                    "GetLastSequence",
                    pb.GetLastSequenceRequest(sender=sender.public),
                )
                assert status == 0
                seq = pb.GetLastSequenceReply.FromString(reply).sequence
                if seq == 1:
                    break
                await asyncio.sleep(0.1)
            assert seq == 1

            # GetLatestTransactions over grpc-web-TEXT mode (the framing a
            # browser uses when fetch streaming is unavailable)
            status, reply = await _grpc_web_call(
                cfg.rpc_address,
                "GetLatestTransactions",
                pb.GetLatestTransactionsRequest(),
                text=True,
            )
            assert status == 0
            txs = pb.GetLatestTransactionsReply.FromString(reply).transactions
            assert len(txs) == 1 and txs[0].amount == 77
        finally:
            await service.close()

    async def test_native_grpc_still_served_on_same_port(self):
        # the splice path: a stock gRPC client on the muxed public port
        cfg = _single_node_config()
        service = await Service.start(cfg)
        try:
            async with Client(f"http://{cfg.rpc_address}") as client:
                user = SignKeyPair.random()
                assert await client.get_balance(user.public) == 100_000
        finally:
            await service.close()

    async def test_grpc_web_error_paths(self):
        cfg = _single_node_config()
        service = await Service.start(cfg)
        try:
            # unknown method -> UNIMPLEMENTED (12) in the trailers
            status, reply = await _grpc_web_call(
                cfg.rpc_address, "NoSuchMethod", pb.GetBalanceRequest()
            )
            assert status == 12 and reply is None
            # handler abort -> INVALID_ARGUMENT (3)
            bad = pb.SendAssetRequest(
                sender=b"short", sequence=1, recipient=b"r" * 32,
                amount=1, signature=b"s" * 64,
            )
            status, _ = await _grpc_web_call(cfg.rpc_address, "SendAsset", bad)
            assert status == 3
        finally:
            await service.close()


class TestConnectionBounds:
    async def test_idle_splice_flood_does_not_starve_http1(self, monkeypatch):
        """Fill the splice budget with idle native-gRPC-preface
        connections: excess splices are rejected, and grpc-web service
        on the same port keeps working throughout."""
        from at2_node_tpu_torch.net import webmux as webmux_mod

        monkeypatch.setattr(webmux_mod, "_MAX_SPLICES", 4)
        cfg = _single_node_config()
        service = await Service.start(cfg)
        host, _, port = cfg.rpc_address.rpartition(":")
        writers = []
        try:
            # 8 idle splices against a cap of 4: all hold only the
            # 4-byte preface so the mux pins pump tasks for each
            for _ in range(8):
                reader, writer = await asyncio.open_connection(host, int(port))
                writer.write(b"PRI ")
                await writer.drain()
                writers.append(writer)
            await asyncio.sleep(0.2)  # let the mux route/reject them
            # exactly the cap: 4 accepted (proving the splice path DID
            # engage), 4 rejected
            assert service._mux._n_splices == 4

            # a real grpc-web call on the same port is unaffected
            status, reply = await _grpc_web_call(
                cfg.rpc_address, "GetBalance",
                pb.GetBalanceRequest(sender=b"\x01" * 32),
            )
            assert status == 0
            assert pb.GetBalanceReply.FromString(reply).amount == 100_000
        finally:
            for w in writers:
                w.close()
            await service.close()

    async def test_http1_conn_cap_answers_503(self, monkeypatch):
        from at2_node_tpu_torch.net import webmux as webmux_mod

        monkeypatch.setattr(webmux_mod, "_MAX_HTTP1_CONNS", 2)
        cfg = _single_node_config()
        service = await Service.start(cfg)
        host, _, port = cfg.rpc_address.rpartition(":")
        holders = []
        try:
            # two keep-alive connections occupy the whole budget
            for _ in range(2):
                reader, writer = await asyncio.open_connection(host, int(port))
                writer.write(b"XGET")  # non-PRI head: routed to HTTP/1
                await writer.drain()
                holders.append(writer)
            await asyncio.sleep(0.2)
            # the third is turned away with 503, not hung or crashed
            reader, writer = await asyncio.open_connection(host, int(port))
            writer.write(b"XGET")
            await writer.drain()
            line = await asyncio.wait_for(reader.readline(), timeout=5)
            assert b"503" in line
            writer.close()
        finally:
            for w in holders:
                w.close()
            await service.close()


class TestAgainstTheReference:
    async def test_grpc_web_answers_equal_the_reference(self):
        """Differential: the same seeded grpc-web calls (a SendAsset in
        binary mode, the read-backs of the sender and the recipient in
        binary and text mode, an unknown method, a malformed request and
        a CORS preflight) against a reference node and a port node: the
        same status lines, headers (``Date`` left out) and bodies."""
        import importlib

        import numpy as np

        async def raw_call(addr, method, body, text=False):
            ctype = "application/grpc-web-text+proto" if text else "application/grpc-web+proto"
            if text:
                body = base64.b64encode(body)
            req = (f"POST /at2.AT2/{method} HTTP/1.1\r\nHost: node\r\nContent-Type: {ctype}\r\n"
                   f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode() + body
            return await _raw(addr, req)

        async def _raw(addr, req):
            host, _, port = addr.rpartition(":")
            reader, writer = await asyncio.open_connection(host, int(port))
            writer.write(req)
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(-1), 10)
            writer.close()
            head, _, body = raw.partition(b"\r\n\r\n")
            lines = head.split(b"\r\n")
            return lines[0], sorted(h.lower() for h in lines[1:] if not h.lower().startswith(b"date:")), body

        async def session(pkg):
            config = importlib.import_module(f"{pkg}.node.config")
            keys = importlib.import_module(f"{pkg}.crypto.keys")
            service = importlib.import_module(f"{pkg}.node.service")
            proto = importlib.import_module(f"{pkg}.proto.at2_pb2")
            types = importlib.import_module(f"{pkg}.types")
            webmux = importlib.import_module(f"{pkg}.net.webmux")
            rng = np.random.default_rng(25)
            cfg = config.Config(node_address=f"127.0.0.1:{next(_ports)}", rpc_address=f"127.0.0.1:{next(_ports)}",
                                sign_key=keys.SignKeyPair(rng.bytes(32)),
                                network_key=keys.ExchangeKeyPair(rng.bytes(32)),
                                verifier=config.VerifierConfig(kind="cpu"))
            sender, recipient = keys.SignKeyPair(rng.bytes(32)), keys.SignKeyPair(rng.bytes(32))
            svc = await service.Service.start(cfg)
            out = []
            try:
                addr = cfg.rpc_address
                send = proto.SendAssetRequest(
                    sender=sender.public, sequence=1, recipient=recipient.public, amount=77,
                    signature=sender.sign(types.transfer_signing_bytes(sender.public, 1, recipient.public, 77)))
                out.append(await raw_call(addr, "SendAsset", webmux._frame(send.SerializeToString())))
                deadline = asyncio.get_event_loop().time() + 10
                while await svc.accounts.get_last_sequence(sender.public) != 1:
                    assert asyncio.get_event_loop().time() < deadline
                    await asyncio.sleep(0.05)
                for who in (sender, recipient):
                    for text in (False, True):
                        out.append(await raw_call(addr, "GetBalance", webmux._frame(
                            proto.GetBalanceRequest(sender=who.public).SerializeToString()), text))
                    out.append(await raw_call(addr, "GetLastSequence", webmux._frame(
                        proto.GetLastSequenceRequest(sender=who.public).SerializeToString())))
                out.append(await raw_call(addr, "NoSuchMethod", webmux._frame(b"")))
                out.append(await raw_call(addr, "SendAsset", webmux._frame(proto.SendAssetRequest(
                    sender=b"short", sequence=1, recipient=b"r" * 32, amount=1,
                    signature=b"s" * 64).SerializeToString())))
                out.append(await _raw(addr, b"OPTIONS /at2.AT2/SendAsset HTTP/1.1\r\nHost: node\r\n"
                                            b"Origin: http://example.com\r\nAccess-Control-Request-Method: POST"
                                            b"\r\nConnection: close\r\n\r\n"))
            finally:
                await svc.close()
            return out

        port, ref = await session("at2_node_tpu_torch"), await session("at2_node_tpu")
        assert [o[0] for o in port][:1] == [b"HTTP/1.1 200 OK"] and b"204" in port[-1][0]
        assert port == ref
