"""Four ``server run`` processes of the port on one host, as
``deploy/README_torch.md`` runs them, configured from ``--seed``.

The harness writes each node's TOML itself (keys drawn from the seed,
``cryptography`` for the public halves), in the format ``server config
new`` writes and ``Config.loads`` reads, with every other node's
``[[nodes]]`` fragment appended and the configuration's thresholds and
``[verifier]`` table. It reads the nodes only through their public
surfaces: gRPC (``GetLastSequence``, ``GetBalance``) and the RPC port's
``/metrics`` and ``/statusz``. Each node runs through
``benchmark/harness/guard.py``, which writes the top-level names of the
modules the node loaded into the run's directory as the node exits.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import grpc
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric import ed25519, x25519

from benchmark.harness import wire

_RAW = serialization.Encoding.Raw
_RAW_PUB = serialization.PublicFormat.Raw


def free_ports(n: int) -> List[int]:
    """n distinct free TCP ports on 127.0.0.1, drawn below the kernel's
    ephemeral range, so that no outgoing connection of a node that is up
    takes the port of a node still starting."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            top = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        top = 32768
    rng = random.SystemRandom()
    out: List[int] = []
    while len(out) < n:
        port = rng.randrange(10000, top)
        if port in out:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        out.append(port)
    return out


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return json.dumps(v)
    return repr(v)


def node_tomls(config: dict, seed: int, ports: Sequence[int], profile_dirs: Optional[Sequence[str]]) -> List[str]:
    """The TOML of every node: thresholds, addresses, keys drawn from the
    seed, the configuration's [verifier] table, [observability] with a
    profile_dir in a traced run, then every other node's fragment."""
    n = config["nodes"]
    node_ports, rpc_ports = ports[0::2], ports[1::2]
    ids = []
    for i in range(n):
        sk = hashlib.sha512(f"at2-bench/node-sign/{seed}/{i}".encode()).digest()[:32]
        nk = hashlib.sha512(f"at2-bench/node-net/{seed}/{i}".encode()).digest()[:32]
        spub = ed25519.Ed25519PrivateKey.from_private_bytes(sk).public_key().public_bytes(_RAW, _RAW_PUB)
        npub = x25519.X25519PrivateKey.from_private_bytes(nk).public_key().public_bytes(_RAW, _RAW_PUB)
        ids.append((sk, nk, spub, npub))
    out = []
    for i in range(n):
        sk, nk, _, _ = ids[i]
        lines = [f"echo_threshold = {config['echo_threshold']}",
                 f"ready_threshold = {config['ready_threshold']}",
                 "[addresses]", f'node = "127.0.0.1:{node_ports[i]}"', f'rpc = "127.0.0.1:{rpc_ports[i]}"',
                 "", "[keys]", f'sign = "{sk.hex()}"', f'network = "{nk.hex()}"', "", "[verifier]"]
        lines += [f"{k} = {_toml_value(v)}" for k, v in config["verifier"].items()]
        if profile_dirs is not None:
            lines += ["", "[observability]", f"profile_dir = {json.dumps(profile_dirs[i])}"]
        for j in range(n):
            if j != i:
                lines += ["", "[[nodes]]", f'address = "127.0.0.1:{node_ports[j]}"',
                          f'public_key = "{ids[j][3].hex()}"', f'sign_public_key = "{ids[j][2].hex()}"']
        out.append("\n".join(lines) + "\n")
    return out


def parse_metrics(text: str) -> Dict[str, float]:
    """The sample lines of a Prometheus exposition: {name: value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            try:
                out[name] = float(value)
            except ValueError:
                continue
    return out


class Net:
    """The node processes of one run. ``server_target`` is the module or
    script, with its arguments, that runs one node with its TOML on stdin
    (:data:`SERVER`, or a test's stand-in)."""

    def __init__(self, config: dict, seed: int, workdir: str, env: dict, server_target: Sequence[str],
                 traced: bool) -> None:
        self.config = config
        self.n = config["nodes"]
        self.workdir = workdir
        self.env = env
        self.server_target = list(server_target)
        ports = free_ports(2 * self.n)
        self.rpc_ports = ports[1::2]
        self.profile_dirs = [os.path.join(workdir, f"profile{i}") for i in range(self.n)] if traced else None
        self.tomls = node_tomls(config, seed, ports, self.profile_dirs)
        self.procs: List[subprocess.Popen] = []
        self.logs = [os.path.join(workdir, f"node{i}.log") for i in range(self.n)]
        self.module_lists = [os.path.join(workdir, f"node{i}.modules.json") for i in range(self.n)]
        self._http = ThreadPoolExecutor(max_workers=self.n)

    @property
    def uris(self) -> List[str]:
        return [f"127.0.0.1:{p}" for p in self.rpc_ports]

    def spawn(self) -> None:
        for i in range(self.n):
            path = os.path.join(self.workdir, f"node{i}.toml")
            with open(path, "w") as f:
                f.write(self.tomls[i])
            with open(path) as stdin, open(self.logs[i], "w") as out:
                argv = [sys.executable, GUARD, self.module_lists[i]] + self.server_target
                self.procs.append(subprocess.Popen(argv, stdin=stdin, stdout=out, stderr=subprocess.STDOUT,
                                                   env=self.env))

    def log_tail(self, i: int, n: int = 3000) -> str:
        with open(self.logs[i], errors="replace") as f:
            return f.read()[-n:]

    def _alive(self) -> None:
        for i, p in enumerate(self.procs):
            if p.poll() is not None:
                raise RuntimeError(f"node {i} exited with {p.returncode}: {self.log_tail(i)}")

    def get(self, i: int, path: str) -> str:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.rpc_ports[i]}{path}", timeout=30) as r:
                return r.read().decode()
        except urllib.error.HTTPError as exc:
            return exc.read().decode()

    def wait_up(self, deadline_s: float) -> None:
        """Every RPC port accepts and every node holds a channel to and from
        each peer."""
        t_end = time.monotonic() + deadline_s
        for i, port in enumerate(self.rpc_ports):
            while True:
                self._alive()
                try:
                    with socket.create_connection(("127.0.0.1", port), timeout=1):
                        break
                except OSError:
                    pass
                if time.monotonic() > t_end:
                    raise RuntimeError(f"node {i}'s RPC port never came up: {self.log_tail(i)}")
                time.sleep(0.05)
        while True:
            self._alive()
            try:
                if all(json.loads(self.get(i, "/statusz"))["stats"]["mesh_channels"] >= 2 * (self.n - 1)
                       for i in range(self.n)):
                    return
            except (OSError, ValueError, KeyError):
                pass
            if time.monotonic() > t_end:
                raise RuntimeError(f"the {self.n}-node mesh did not connect in {deadline_s} s")
            time.sleep(0.05)

    def metrics(self) -> List[Dict[str, float]]:
        """Every node's /metrics, fetched side by side."""
        return list(self._http.map(lambda i: parse_metrics(self.get(i, "/metrics")), range(self.n)))

    def stop(self, timeout_s: float = 60.0) -> List[int]:
        """SIGTERM every node once, then wait for each (a traced node writes
        its trace on the way down)."""
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = []
        t_end = time.monotonic() + timeout_s
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=max(0.1, t_end - time.monotonic())))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        self._http.shutdown(wait=True)
        return rcs

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        self._http.shutdown(wait=False)

    def loaded_modules(self) -> List[Optional[List[str]]]:
        """Each node's top-level module names, as it wrote them on its way
        out; None for a node that wrote none."""
        out = []
        for path in self.module_lists:
            try:
                with open(path) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                out.append(None)
        return out

    def trace_files(self) -> List[str]:
        out = []
        for d in self.profile_dirs or ():
            if os.path.isdir(d):
                out += [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".json")]
        return out


class Reader:
    """The harness's own gRPC reads of every node's ledger."""

    def __init__(self, uris: Sequence[str]) -> None:
        self.codec = wire.Codec()
        self.channels = [grpc.aio.insecure_channel(u) for u in uris]
        self.seq = [ch.unary_unary(wire.rpc_path("GetLastSequence")) for ch in self.channels]
        self.bal = [ch.unary_unary(wire.rpc_path("GetBalance")) for ch in self.channels]

    async def close(self) -> None:
        await asyncio.gather(*(ch.close() for ch in self.channels))

    async def _one(self, stub, message: str, reply: str, field: str, account: bytes) -> int:
        raw = await stub(self.codec.encode(message, {"sender": account}), timeout=60)
        return int(self.codec.decode(reply, raw).get(field, 0))

    async def sequences(self, accounts: Sequence[bytes]) -> List[List[int]]:
        """[node][account] last committed sequence, read side by side."""
        rows = await asyncio.gather(*(
            asyncio.gather(*(self._one(s, "GetLastSequenceRequest", "GetLastSequenceReply", "sequence", a)
                             for a in accounts)) for s in self.seq))
        return [list(r) for r in rows]

    async def balances(self, accounts: Sequence[bytes]) -> List[List[int]]:
        rows = await asyncio.gather(*(
            asyncio.gather(*(self._one(s, "GetBalanceRequest", "GetBalanceReply", "amount", a)
                             for a in accounts)) for s in self.bal))
        return [list(r) for r in rows]


GUARD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "guard.py")
SERVER = ["at2_node_tpu_torch.cli.server", "run"]
