"""Single-port gRPC + grpc-web multiplexer (the browser surface).

Counterpart of ``at2_node_tpu/net/webmux.py``.

The reference serves browsers and native clients on ONE port: tonic with
`accept_http1(true)` + `tonic_web::config().allow_all_origins()`
(`at2-node/src/bin/server/main.rs:110-114`), so its wasm client can
call the node from a browser (`at2-node/src/client.rs:45-46,58-61`).
grpc.aio has no HTTP/1 story, so this module recreates the capability the
transport-native way:

* ``PortMux`` listens on the node's public RPC address and sniffs each
  connection's first bytes. The HTTP/2 client preface (``PRI *
  HTTP/2.0``) marks a native gRPC client — the connection is spliced to
  the real grpc.aio server on an internal loopback port, bytes forwarded
  verbatim both ways.
* Anything else is treated as HTTP/1: an in-process grpc-web endpoint
  decodes the grpc-web framing (binary ``application/grpc-web+proto`` and
  base64 ``application/grpc-web-text+proto``), dispatches to the SAME
  servicer object the gRPC server uses, and answers with CORS-allow-all
  headers plus the grpc-web trailers frame — so any stock grpc-web client
  (including browsers) works against the node.

Only unary RPCs are implemented — exactly the surface `at2.proto` has.
"""

from __future__ import annotations

import asyncio
import base64
import logging
import time
from typing import Dict, Optional, Tuple

import grpc

from ..proto import at2_pb2 as pb
from ..proto import finality_pb2 as fpb

logger = logging.getLogger(__name__)

# grpc-web frame flags
_DATA_FRAME = 0x00
_TRAILER_FRAME = 0x80

_MAX_BODY = 4 * 1024 * 1024
_MAX_HEADER = 64 * 1024
# Splice-path bounds: each spliced native-gRPC connection costs two pump
# tasks, so the count is capped and fully-idle splices are reaped. Idle
# means NO traffic in EITHER direction for the whole window (a watchdog
# checks a shared last-activity stamp), so a long-running RPC whose
# client half is quiet — e.g. a SendAsset parked behind a saturated
# broadcast inbox — is never torn down while the server is replying.
_MAX_SPLICES = 256
_SPLICE_IDLE = 300.0
# keep-alive bounds: one HTTP/1 connection serves at most this many
# requests before the server closes it (resource rotation), and at most
# this many HTTP/1 connections are held concurrently — keep-alive must
# not let cheap idle sockets pin unbounded handler tasks on the public
# port (the splice path has _MAX_SPLICES for the same reason)
_MAX_REQUESTS_PER_CONN = 10_000
_MAX_HTTP1_CONNS = 512

# method name -> request message class (the service's reply types come
# back from the servicer call itself)
_REQUEST_TYPES: Dict[str, type] = {
    "SendAsset": pb.SendAssetRequest,
    "SendAssetBatch": pb.SendAssetBatchRequest,
    "GetBalance": pb.GetBalanceRequest,
    "GetLastSequence": pb.GetLastSequenceRequest,
    "GetLatestTransactions": pb.GetLatestTransactionsRequest,
    "GetCertificate": fpb.GetCertificateRequest,
}

_CORS_HEADERS = (
    "Access-Control-Allow-Origin: *\r\n"
    "Access-Control-Allow-Methods: POST, OPTIONS\r\n"
    "Access-Control-Allow-Headers: content-type, x-grpc-web, x-user-agent, grpc-timeout\r\n"
    "Access-Control-Expose-Headers: grpc-status, grpc-message\r\n"
)


class _TooLarge(ValueError):
    """Chunked body exceeded _MAX_BODY (maps to 413, not 400)."""


class _Abort(Exception):
    """Raised by the fake context to short-circuit a handler."""

    def __init__(self, code: grpc.StatusCode, details: str) -> None:
        super().__init__(details)
        self.code = code
        self.details = details


class _WebContext:
    """Minimal stand-in for grpc.aio.ServicerContext under grpc-web: the
    servicer methods use ``abort`` and ``peer`` (see node/service.py
    handlers — ``peer`` keys the per-source admission token bucket)."""

    def __init__(self, peer: str = "web:unknown") -> None:
        self._peer = peer

    def peer(self) -> str:
        return self._peer

    async def abort(self, code: grpc.StatusCode, details: str = "") -> None:
        raise _Abort(code, details)


def _frame(payload: bytes, flags: int = _DATA_FRAME) -> bytes:
    return bytes([flags]) + len(payload).to_bytes(4, "big") + payload


def _parse_frames(body: bytes) -> list:
    """Split a grpc-web body into (flags, payload) tuples."""
    out = []
    view = memoryview(body)
    while len(view) >= 5:
        flags = view[0]
        length = int.from_bytes(view[1:5], "big")
        if len(view) < 5 + length:
            raise ValueError("truncated grpc-web frame")
        out.append((flags, bytes(view[5 : 5 + length])))
        view = view[5 + length :]
    if len(view):
        raise ValueError("trailing bytes after grpc-web frames")
    return out


def _status_int(code: grpc.StatusCode) -> int:
    return code.value[0]


class PortMux:
    """The public RPC listener: native gRPC spliced through, grpc-web
    served in-process."""

    def __init__(
        self,
        listen_addr: str,
        grpc_port: int,
        servicer,
        grpc_host: str = "127.0.0.1",
    ) -> None:
        self.listen_addr = listen_addr
        self.grpc_host = grpc_host
        self.grpc_port = grpc_port
        self.servicer = servicer
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()  # live per-connection handler tasks
        self._n_splices = 0  # live spliced native-gRPC connections
        self._n_http1 = 0  # live keep-alive HTTP/1 connections
        self._http1_accepted = 0  # total accepted (observability/tests)

    def stats(self) -> dict:
        return {
            "splices": self._n_splices,
            "http1_conns": self._n_http1,
            "http1_accepted": self._http1_accepted,
        }

    async def start(self) -> None:
        host, _, port = self.listen_addr.rpartition(":")
        self._server = await asyncio.start_server(
            self._handle_conn, host or "0.0.0.0", int(port)
        )

    async def close(self) -> None:
        """Shutdown must not depend on clients hanging up: handler tasks
        (including gRPC splices held open by lingering client channels)
        are cancelled outright before the listener is awaited closed."""
        if self._server is not None:
            self._server.close()
        for task in list(self._conns):
            task.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        self._conns.clear()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conns.add(task)
        try:
            await self._handle(reader, writer)
        except asyncio.CancelledError:
            pass
        finally:
            if task is not None:
                self._conns.discard(task)

    # -- connection handling ---------------------------------------------

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            # readexactly: a short first segment must not misroute a native
            # gRPC client whose HTTP/2 preface arrives in pieces
            head = await asyncio.wait_for(reader.readexactly(4), timeout=30)
        except (
            asyncio.TimeoutError,
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
        ):
            writer.close()
            return
        try:
            if head == b"PRI ":
                await self._splice_grpc(head, reader, writer)
            else:
                await self._http1_loop(head, reader, writer)
        except asyncio.TimeoutError:
            pass
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            pass
        except Exception:
            logger.exception("webmux connection error")
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _splice_grpc(
        self,
        head: bytes,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        """Bidirectional byte pipe to the internal grpc.aio port, bounded
        in count (cap) and lifetime (per-read idle timeout) so an
        idle-splice flood cannot pin pump tasks indefinitely."""
        if self._n_splices >= _MAX_SPLICES:
            logger.warning("splice cap reached (%d); rejecting", _MAX_SPLICES)
            writer.close()
            return
        self._n_splices += 1
        try:
            up_reader, up_writer = await asyncio.open_connection(
                self.grpc_host, self.grpc_port
            )
            up_writer.write(head)
            last_activity = time.monotonic()

            async def pipe(src: asyncio.StreamReader, dst: asyncio.StreamWriter):
                # bare read loop: the idle policy lives in the watchdog, so
                # the data plane pays no per-chunk timer machinery
                nonlocal last_activity
                try:
                    while True:
                        chunk = await src.read(65536)
                        if not chunk:
                            break
                        last_activity = time.monotonic()
                        dst.write(chunk)
                        await dst.drain()
                finally:
                    try:
                        dst.close()
                    except Exception:
                        pass

            async def watchdog():
                while True:
                    await asyncio.sleep(_SPLICE_IDLE / 4)
                    if time.monotonic() - last_activity > _SPLICE_IDLE:
                        for w in (writer, up_writer):
                            try:
                                w.close()  # pumps wake with EOF and exit
                            except Exception:
                                pass
                        return

            wd = asyncio.create_task(watchdog())
            try:
                await asyncio.gather(
                    pipe(reader, up_writer), pipe(up_reader, writer),
                    return_exceptions=True,
                )
            finally:
                wd.cancel()
        finally:
            self._n_splices -= 1

    # -- HTTP/1 grpc-web --------------------------------------------------

    async def _http1_loop(
        self,
        head: bytes,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        """Serve HTTP/1 requests on this connection until the client
        closes, asks to close, errors, or idles out — real keep-alive,
        like the reference's tonic HTTP/1 surface, so stock grpc-web
        clients reuse one connection across unary calls instead of
        paying a reconnect each. Each request (headers through response)
        gets a 30s bound: the same slowloris protection as before, now
        doubling as the idle-connection reaper between requests."""
        if self._n_http1 >= _MAX_HTTP1_CONNS:
            writer.write(
                b"HTTP/1.1 503 Service Unavailable\r\n"
                b"Content-Length: 0\r\nConnection: close\r\n\r\n"
            )
            await writer.drain()
            return
        self._n_http1 += 1
        self._http1_accepted += 1
        try:
            buf = bytearray(head)
            for i in range(_MAX_REQUESTS_PER_CONN):
                # the final allowed request must ADVERTISE close — a
                # pooled client told keep-alive would write its next
                # request into a dead socket
                last = i == _MAX_REQUESTS_PER_CONN - 1
                keep = await asyncio.wait_for(
                    self._serve_http1(buf, reader, writer, allow_keep=not last),
                    timeout=30,
                )
                if not keep:
                    return
        finally:
            self._n_http1 -= 1

    async def _serve_http1(
        self,
        buf: bytearray,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        allow_keep: bool = True,
    ) -> bool:
        """Serve ONE request whose leading bytes (possibly from the
        previous request's over-read) sit in ``buf``; leaves any trailing
        over-read in ``buf`` for the next request. Returns True when the
        connection should stay open."""
        while b"\r\n\r\n" not in buf:
            chunk = await reader.read(4096)
            if not chunk:
                return False  # client closed between/mid requests
            buf.extend(chunk)
            if len(buf) > _MAX_HEADER:
                await self._respond(
                    writer, "431 Request Header Fields Too Large",
                    "text/plain", b"",
                )
                return False
        sep = buf.find(b"\r\n\r\n")
        header_blob = bytes(buf[:sep])
        del buf[: sep + 4]
        try:
            request_line, headers = self._parse_headers(header_blob)
            method, path, version = request_line.split(" ", 2)
        except ValueError:
            await self._respond(writer, "400 Bad Request", "text/plain", b"bad request")
            return False

        # HTTP/1.1 defaults to keep-alive; 1.0 only opts in; either side
        # can force close. Connection is a comma-separated token list
        # (RFC 9110 §7.6.1) — compare whole tokens, not substrings, so a
        # token that merely CONTAINS "close"/"keep-alive" can't
        # misclassify the connection.
        conn_tokens = {
            t.strip()
            for t in headers.get("connection", "").lower().split(",")
            if t.strip()
        }
        keep = allow_keep and (
            "close" not in conn_tokens
            if version.strip().upper() == "HTTP/1.1"
            else "keep-alive" in conn_tokens
        )

        if method.upper() == "OPTIONS":
            # drain any body (preflights normally have none, but an
            # unconsumed body would desync the next request's framing)
            if "chunked" in headers.get("transfer-encoding", "").lower():
                keep = False  # not worth decoding for a preflight
            else:
                try:
                    opt_len = int(headers.get("content-length", "0"))
                except ValueError:
                    opt_len = -1
                if opt_len < 0 or opt_len > _MAX_BODY:
                    keep = False
                else:
                    while len(buf) < opt_len:
                        chunk = await reader.read(65536)
                        if not chunk:
                            return False
                        buf.extend(chunk)
                    del buf[:opt_len]
            # CORS preflight (allow-all, reference parity)
            writer.write(
                (
                    "HTTP/1.1 204 No Content\r\n"
                    + _CORS_HEADERS
                    + "Access-Control-Max-Age: 86400\r\n"
                    + "Content-Length: 0\r\n"
                    + f"Connection: {'keep-alive' if keep else 'close'}\r\n\r\n"
                ).encode()
            )
            await writer.drain()
            return keep

        if method.upper() == "GET":
            # Observability endpoints (/metrics /healthz /statusz),
            # answered by the servicer when it implements obs_http (duck-
            # typed: test doubles and bare servicers just 404). Riding
            # THIS loop — not a separate listener — is deliberate: GETs
            # share _MAX_HTTP1_CONNS, the per-connection request cap, and
            # the 30s per-request bound with grpc-web traffic, so a
            # scrape flood cannot pin handler tasks beyond what the
            # grpc-web path already tolerates.
            if "chunked" in headers.get("transfer-encoding", "").lower():
                keep = False  # a GET with a chunked body isn't worth decoding
            else:
                try:
                    get_len = int(headers.get("content-length", "0"))
                except ValueError:
                    get_len = -1
                if get_len < 0 or get_len > _MAX_BODY:
                    keep = False
                else:
                    while len(buf) < get_len:
                        chunk = await reader.read(65536)
                        if not chunk:
                            return False
                        buf.extend(chunk)
                    del buf[:get_len]
            handler = getattr(self.servicer, "obs_http", None)
            route = path.split("?", 1)[0]  # query-free form, for logging
            result = None
            if callable(handler):
                try:
                    # full path INCLUDING the query string: the handler
                    # parses parameters itself (e.g. /tracez?limit=N)
                    result = handler(path)
                except Exception:
                    logger.exception("obs handler failed for %s", route)
                    await self._respond(
                        writer, "500 Internal Server Error", "text/plain",
                        b"", keep=keep,
                    )
                    return keep
            if result is None:
                await self._respond(
                    writer, "404 Not Found", "text/plain", b"not found",
                    keep=keep,
                )
                return keep
            status, content_type, body = result
            reason = {200: "OK", 503: "Service Unavailable"}.get(status, "OK")
            await self._respond(
                writer, f"{status} {reason}", content_type, body, keep=keep
            )
            return keep

        if method.upper() != "POST":
            await self._respond(writer, "405 Method Not Allowed", "text/plain", b"")
            return False

        # curl (bodies >1KB and streaming uploads) sends Expect:
        # 100-continue and stalls ~1s waiting for the interim response;
        # answer it before any body read so real streaming clients
        # never pay that latency
        if "100-continue" in headers.get("expect", "").lower():
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()

        if "chunked" in headers.get("transfer-encoding", "").lower():
            # real client stacks (curl/httpx streaming bodies) DO send
            # unary grpc-web requests chunked; ignoring the body here
            # would silently decode an EMPTY request — wrong answer, not
            # even an error (interop finding)
            try:
                body = await self._read_chunked(reader, buf)
            except _TooLarge:
                await self._respond(
                    writer, "413 Payload Too Large", "text/plain", b""
                )
                return False
            except ValueError:
                await self._respond(
                    writer, "400 Bad Request", "text/plain", b""
                )
                return False
        else:
            try:
                length = int(headers.get("content-length", "0"))
            except ValueError:
                length = -1
            if length < 0:
                # malformed/negative Content-Length answers 400 instead of
                # falling into the generic handler (which would log a full
                # traceback per junk request on the public port)
                await self._respond(writer, "400 Bad Request", "text/plain", b"")
                return False
            if length > _MAX_BODY:
                await self._respond(
                    writer, "413 Payload Too Large", "text/plain", b""
                )
                return False
            while len(buf) < length:
                chunk = await reader.read(65536)
                if not chunk:
                    return False  # closed mid-body
                buf.extend(chunk)
            body = bytes(buf[:length])
            del buf[:length]  # over-read stays for the next request

        content_type = headers.get("content-type", "")
        text_mode = "grpc-web-text" in content_type
        if "grpc-web" not in content_type:
            await self._respond(
                writer, "415 Unsupported Media Type", "text/plain", b""
            )
            return False
        if text_mode:
            try:
                body = base64.b64decode(body)
            except Exception:
                await self._respond(writer, "400 Bad Request", "text/plain", b"")
                return False

        # key admission buckets by HOST only: HTTP/1 connections churn
        # ephemeral ports, and a per-port bucket would reset on reconnect
        peername = writer.get_extra_info("peername")
        peer = (
            f"web:{peername[0]}"
            if isinstance(peername, tuple) and peername
            else "web:unknown"
        )
        status, message, reply_bytes = await self._dispatch(path, body, peer)

        payload = b""
        if reply_bytes is not None:
            payload += _frame(reply_bytes)
        trailer = f"grpc-status: {status}\r\n"
        if message:
            trailer += f"grpc-message: {message}\r\n"
        payload += _frame(trailer.encode(), _TRAILER_FRAME)
        if text_mode:
            payload = base64.b64encode(payload)
            reply_type = "application/grpc-web-text+proto"
        else:
            reply_type = "application/grpc-web+proto"
        await self._respond(writer, "200 OK", reply_type, payload, keep=keep)
        return keep

    async def _dispatch(
        self, path: str, body: bytes, peer: str = "web:unknown"
    ) -> Tuple[int, str, Optional[bytes]]:
        """Decode the request, run the servicer method, encode the reply.
        Returns (grpc-status, grpc-message, reply bytes or None)."""
        parts = path.strip("/").split("/")
        if len(parts) != 2 or parts[0] != "at2.AT2":
            return _status_int(grpc.StatusCode.UNIMPLEMENTED), "unknown service", None
        method_name = parts[1]
        req_type = _REQUEST_TYPES.get(method_name)
        handler = getattr(self.servicer, method_name, None)
        if req_type is None or handler is None:
            return _status_int(grpc.StatusCode.UNIMPLEMENTED), "unknown method", None
        try:
            frames = _parse_frames(body)
            data = b"".join(p for f, p in frames if f == _DATA_FRAME)
            request = req_type.FromString(data)
        except Exception:
            return (
                _status_int(grpc.StatusCode.INVALID_ARGUMENT),
                "malformed request",
                None,
            )
        try:
            reply = await handler(request, _WebContext(peer))
        except _Abort as abort:
            return _status_int(abort.code), abort.details, None
        except Exception:
            logger.exception("grpc-web handler error in %s", method_name)
            return _status_int(grpc.StatusCode.INTERNAL), "internal error", None
        return 0, "", reply.SerializeToString()

    # -- small HTTP helpers ----------------------------------------------

    @staticmethod
    async def _read_chunked(
        reader: asyncio.StreamReader, buf: bytearray
    ) -> bytes:
        """Decode a Transfer-Encoding: chunked body (bounded by _MAX_BODY)
        from the connection's shared buffer: consumed bytes are removed,
        over-read bytes stay in ``buf`` for the next keep-alive request."""

        async def fill(n: int) -> None:
            while len(buf) < n:
                chunk = await reader.read(65536)
                if not chunk:
                    raise ValueError("connection closed mid-chunk")
                buf.extend(chunk)
                if len(buf) > _MAX_BODY + 4096:
                    raise _TooLarge("chunked body too large")

        async def read_line() -> bytes:
            while True:
                idx = buf.find(b"\r\n")
                if idx >= 0:
                    line = bytes(buf[:idx])
                    del buf[: idx + 2]
                    return line
                await fill(len(buf) + 1)

        body = bytearray()
        while True:
            size_token = (await read_line()).split(b";", 1)[0]
            # RFC 9112 chunk-size is 1*HEXDIG only — int(x, 16) alone
            # would also take '+3'/' 3'/'0x3', framing every other
            # server rejects
            if not size_token or any(
                c not in b"0123456789abcdefABCDEF" for c in size_token
            ):
                raise ValueError(f"bad chunk size {size_token[:16]!r}")
            size = int(size_token, 16)
            if len(body) + size > _MAX_BODY:
                raise _TooLarge("chunked body too large")
            if size == 0:
                # trailers (if any) up to the final blank line
                while await read_line():
                    pass
                return bytes(body)
            await fill(size + 2)
            body += buf[:size]
            if bytes(buf[size : size + 2]) != b"\r\n":
                raise ValueError("missing chunk terminator")
            del buf[: size + 2]

    @staticmethod
    def _parse_headers(raw: bytes) -> Tuple[str, Dict[str, str]]:
        header_blob = raw.split(b"\r\n\r\n", 1)[0].decode("latin-1")
        lines = header_blob.split("\r\n")
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        return lines[0], headers

    @staticmethod
    async def _respond(
        writer: asyncio.StreamWriter,
        status_line: str,
        content_type: str,
        body: bytes,
        keep: bool = False,
    ) -> None:
        """Error responses default to Connection: close (the request's
        framing can't be trusted past a parse failure); successful
        grpc-web replies pass keep=True to hold the connection open."""
        conn = "keep-alive" if keep else "close"
        writer.write(
            (
                f"HTTP/1.1 {status_line}\r\n"
                f"Content-Type: {content_type}\r\n"
                + _CORS_HEADERS
                + f"Content-Length: {len(body)}\r\nConnection: {conn}\r\n\r\n"
            ).encode()
            + body
        )
        await writer.drain()
