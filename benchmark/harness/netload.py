"""A generator process of the net cells: closed-loop gRPC clients.

Copied in spirit from the port's ``tools/loadgen.py`` (a firehose of
seeded clients, each keeping ``in_flight`` calls open, ``rpc_batch``
transfers a call), without its fixed count: the clients send until the
harness says stop, and every call is recorded with its send and reply
times (``time.time()``, the clock the harness opens its window on) and
its status. Each client has a channel, so a node sees each as its own
source. A tampered twin goes alone in a call of the cell's method just
before the call that carries the transfer it shadows. Nothing of the
program is imported: requests are encoded from the benchmark's copy of
at2.proto.

A client sends no transfer that could take its debits past
``debit_cap``, so that no transfer overdraws whatever order the nodes
commit in; a client that reaches it stops and records when
(``capped_at``), and the harness counts it against the run.

Runs as ``multiprocessing`` spawn target :func:`main`; it reads
``"go"`` and ``"stop"`` from its pipe and sends back one result dict,
with the top-level names of the modules the process loaded.
"""

from __future__ import annotations

import asyncio
import sys
import time
from typing import Dict, List

import grpc

from benchmark.harness import guard, wire, workload

STATUS_ERROR = -1  # a call that raised something other than an RPC error


class Client:
    def __init__(self, params: dict, index: int, keys: List[workload.Key], uri: str, codec: wire.Codec):
        self.p = params
        self.index = index
        self.keys = keys
        self.publics = [k.public for k in keys]
        self.uri = uri
        self.codec = codec
        # (t_send, t_done, n, twin class or "", status, client, first sequence)
        self.records: List[tuple] = []
        self.twins: List[tuple] = []  # (sequence, class, sender, seq, recipient, amount, sig, status)
        self.last_sent = 0  # the last sequence put into a call
        self.debit = 0
        self.capped_at = None  # wall clock at which the client reached debit_cap
        self.last_twin = float("-inf")

    def _request(self, sender, seq, recipient, amount, sig) -> dict:
        return {"sender": sender, "sequence": seq, "recipient": recipient, "amount": amount,
                "signature": sig}

    def _encode(self, requests: List[dict]) -> bytes:
        if self.p["rpc"] == "SendAsset":
            return self.codec.encode("SendAssetRequest", requests[0])
        return self.codec.encode("SendAssetBatchRequest", {"transactions": requests})

    async def _call(self, stub, payload: bytes, n: int, twin: str, first: int, twin_row=None) -> None:
        t0 = time.time()
        try:
            await stub(payload, timeout=self.p["call_timeout_s"])
            status = grpc.StatusCode.OK.value[0]
        except grpc.aio.AioRpcError as exc:
            status = exc.code().value[0]
        except Exception:  # recorded as an error, never retried
            status = STATUS_ERROR
        self.records.append((t0, time.time(), n, twin, status, self.index, first))
        if twin_row is not None:
            self.twins.append(twin_row + (status,))

    async def run(self, stop: asyncio.Event) -> None:
        p, seed, c = self.p, self.p["seed"], self.index
        me = self.keys[c]
        async with grpc.aio.insecure_channel(self.uri) as channel:
            stub = channel.unary_unary(wire.rpc_path(p["rpc"]))
            pending: set = set()
            seq = 1
            while not stop.is_set():
                batch = []
                for s in range(seq, seq + p["rpc_batch"]):
                    t = workload.transfer(seed, self.publics, c, s, p["amounts"])
                    batch.append(t)
                if self.debit + sum(t[3] for t in batch) > p["debit_cap"]:
                    self.capped_at = time.time()
                    break
                for _, s, _, _ in batch:
                    cls = workload.twin_class(seed, c, s, p["tamper_share"], p["tamper_classes"])
                    # twins are spaced so that a source never drains the
                    # node's admission fail bucket (64 per 10 s by default)
                    if cls is None or time.monotonic() - self.last_twin < p["twin_min_interval_s"]:
                        continue
                    self.last_twin = time.monotonic()
                    row = workload.net_twin(seed, self.keys, c, s, cls, p["amounts"])
                    while len(pending) >= p["in_flight"]:
                        _, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
                    pending.add(asyncio.ensure_future(self._call(
                        stub, self._encode([self._request(*row)]), 1, cls, s, (s, cls) + row)))
                requests = [self._request(*t, me.sign(workload.signing_bytes(*t))) for t in batch]
                while len(pending) >= p["in_flight"]:
                    _, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
                pending.add(asyncio.ensure_future(self._call(
                    stub, self._encode(requests), len(batch), "", seq)))
                self.debit += sum(t[3] for t in batch)
                seq += len(batch)
                self.last_sent = seq - 1
            if pending:
                await asyncio.wait(pending)


async def _serve(conn, params: dict) -> Dict:
    codec = wire.Codec()
    keys = [workload.key(params["seed"], "client", i) for i in range(params["clients"])]
    clients = [Client(params, c, keys, params["uris"][c], codec) for c in params["mine"]]
    loop = asyncio.get_running_loop()
    conn.send("ready")
    go = await loop.run_in_executor(None, conn.recv)
    if go != "go":
        return {"clients": [], "modules": guard.top_level(sys.modules)}
    stop = asyncio.Event()
    tasks = [asyncio.ensure_future(cl.run(stop)) for cl in clients]
    await loop.run_in_executor(None, conn.recv)  # "stop"
    stop.set()
    await asyncio.gather(*tasks)
    return {"clients": [{"index": cl.index, "last_sent": cl.last_sent, "records": cl.records,
                         "twins": cl.twins, "capped_at": cl.capped_at} for cl in clients],
            "modules": guard.top_level(sys.modules)}


def main(conn, params: dict) -> None:
    try:
        result = asyncio.run(_serve(conn, params))
    except BaseException as exc:  # reported to the harness, which fails the run
        conn.send({"error": repr(exc)})
        raise
    conn.send(result)
