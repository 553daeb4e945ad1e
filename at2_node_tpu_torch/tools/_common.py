"""Shared helpers for the benchmark/demo tools.

Counterpart of ``at2_node_tpu/tools/_common.py``; ``make_net_configs``
also takes a seed, so keys can be drawn with numpy. ``card_stamp`` is what
the port's rows carry where the reference's carried
``tunnel_live_at_write``, and ``OUT_DIR`` is where the port's tools write
by default (a git-ignored directory: the repo's root ``BENCH_*.json``
files are the TPU's record).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import socket
import subprocess
import time
from typing import Iterator, List

import numpy as np

from ..crypto.keys import ExchangeKeyPair, SignKeyPair
from ..net.peers import Peer
from ..node.config import Config

_GET_TIMEOUT = 5.0

# the tools' default output directory: under the package's git-ignored
# build/, never the repo's root
OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "bench"
)


def device_seconds(dev, fn) -> float:
    """Seconds ``fn`` takes on ``dev``: CUDA events around it on the card
    (its launches' device time), the host clock on the CPU."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def tool_device(device: str, flag: str = "--device cpu"):
    """A tool's device: ``"cuda"`` is ``cuda:0`` and raises without a card,
    naming the ``flag`` that asks for the host instead."""
    import torch

    from ..ops.cuda_verify import resolve_device

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available; pass {flag} to run on the host")
    return resolve_device(device)


def card_stamp(device) -> str:
    """The card a measurement ran on, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints it (name and power limit),
    or ``"cpu"`` for a run of the plain versions on the host. Rows of two
    cards, or of a card and the CPU, are never compared (``regress``)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = 0 if dev.index is None else dev.index
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        line = out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        line = ""
    return line or f"{torch.cuda.get_device_name(index)}, power limit not read"


async def fetch_json(host: str, port: int, path: str,
                     timeout: float = _GET_TIMEOUT):
    """One raw HTTP/1 GET of a JSON obs endpoint (no http client
    dependency): the fleet-polling primitive of the tools."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout
    )
    try:
        writer.write(
            f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
            "Connection: close\r\n\r\n".encode()
        )
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass
    head, _, body = raw.partition(b"\r\n\r\n")
    status_line = head.split(b"\r\n", 1)[0].decode("latin-1", "replace")
    if " 200 " not in f"{status_line} ":
        raise RuntimeError(f"{host}:{port} answered {status_line!r}")
    return json.loads(body)


async def fetch_statusz(host: str, port: int, timeout: float = _GET_TIMEOUT):
    """One raw HTTP/1 GET /statusz."""
    return await fetch_json(host, port, "/statusz", timeout)


def parse_addr(spec: str):
    host, _, port = spec.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad address {spec!r}, want HOST:PORT")
    return host, int(port)


async def poll_fleet(addrs, path: str, timeout: float = _GET_TIMEOUT) -> list:
    """GET ``path`` from every (host, port) concurrently. Returns one
    entry per address: the parsed JSON, or ``{"error": str}`` for a node
    that did not answer — collectors keep going with a partial fleet."""
    results = await asyncio.gather(
        *(fetch_json(h, p, path, timeout) for h, p in addrs),
        return_exceptions=True,
    )
    return [
        {"error": str(r)} if isinstance(r, BaseException) else r
        for r in results
    ]


def host_context() -> dict:
    """The one statement of this host's measurement ceiling, embedded by
    every tool artifact, so a reader can't mistake harness floors for
    design ceilings."""
    return {
        "cpus": len(os.sched_getaffinity(0)),
        "note": (
            "all servers, clients and load generators share this host's "
            "cores and, in-process, one interpreter lock; absolute tx/s "
            "figures are harness floors, not design ceilings — device-side "
            "rates and same-call comparisons are the signal."
        ),
    }


def make_net_configs(
    n: int, ports: Iterator[int], seed: int | None = None, **config_overrides
) -> List[Config]:
    """N full-mesh node Configs: the one place that makes the tools' in-process
    nets. Keys are fresh, or drawn from ``np.random.default_rng(seed)``."""
    rng = None if seed is None else np.random.default_rng(seed)

    def keys():
        if rng is None:
            return SignKeyPair.random(), ExchangeKeyPair.random()
        return SignKeyPair(rng.bytes(32)), ExchangeKeyPair(rng.bytes(32))

    cfgs = []
    for _ in range(n):
        sign_key, network_key = keys()
        cfgs.append(Config(
            node_address=f"127.0.0.1:{next(ports)}",
            rpc_address=f"127.0.0.1:{next(ports)}",
            sign_key=sign_key,
            network_key=network_key,
            **config_overrides,
        ))
    for i, cfg in enumerate(cfgs):
        cfg.nodes = [
            Peer(o.node_address, o.network_key.public, o.sign_key.public)
            for j, o in enumerate(cfgs)
            if j != i
        ]
    return cfgs


def port_counter(start: int) -> Iterator[int]:
    return itertools.count(start)


def ephemeral_range() -> tuple:
    """The kernel's range for port-0 binds and outgoing connections."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fp:
            lo, hi = (int(x) for x in fp.read().split())
        return lo, hi
    except (OSError, ValueError):
        return 32768, 60999


def listen_ports(seed: int | None = None) -> Iterator[int]:
    """Endless TCP ports on 127.0.0.1 for an in-process net's listeners,
    each bindable when yielded. They come from outside the ephemeral range
    where it leaves room: a net's own outgoing connections and port-0
    binds draw from that range, and take a port handed out inside it
    before its node has bound it."""
    lo, hi = ephemeral_range()
    if lo - 1024 >= 4096:
        span = range(1024, lo)
    elif 65535 - hi >= 4096:
        span = range(hi + 1, 65536)
    else:
        span = range(1024, 65536)
    start = np.random.default_rng(seed).integers(0, len(span))
    for i in range(len(span)):
        port = span[(start + i) % len(span)]
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        yield port
