"""`server` CLI: `config {new,get-node}` and `run`.

Counterpart of ``at2_node_tpu/cli/server.py``.

Same subcommand surface and stdin/stdout TOML piping as the reference
server binary (`at2-node/src/bin/server/main.rs:17-140`):

    server config new <node_address> <rpc_address>   > node.toml
    server config new --verifier cpu ...             # no card: host verifier
    server config new --verifier pool ...            # every local card
    server config get-node < node.toml               # shareable fragment
    server run < node.toml                           # serve forever

Peers are added by appending other nodes' `get-node` fragments to the
config, exactly the reference operator workflow
(`at2-node/README.md:26-27`).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from ..crypto.keys import ExchangeKeyPair, SignKeyPair
from ..node.config import Config, VerifierConfig
from ..obs.profiler import BusySelector


def maybe_initialize() -> bool:
    """Multi-host bring-up: joins the ``torch.distributed`` process group
    when ``AT2_COORDINATOR`` (with ``AT2_NUM_PROCESSES`` and
    ``AT2_PROCESS_ID``) is set; a no-op returning False otherwise, so
    single-host servers stay light at boot."""
    from ..parallel.multihost import maybe_initialize as init

    return init()


def cmd_config_new(args: argparse.Namespace) -> int:
    config = Config(
        node_address=args.node_address,
        rpc_address=args.rpc_address,
        sign_key=SignKeyPair.random(),
        network_key=ExchangeKeyPair.random(),
        verifier=VerifierConfig(kind=args.verifier),
    )
    sys.stdout.write(config.dumps())
    return 0


def cmd_config_get_node(args: argparse.Namespace) -> int:
    config = Config.load(sys.stdin)
    sys.stdout.write(config.node_fragment())
    return 0


def cmd_run(args: argparse.Namespace) -> int:
    # WARN-level logging by default, like the reference's tracing setup
    # (`server/main.rs:94-99`); AT2_LOG overrides for debugging.
    import os

    logging.basicConfig(
        level=os.environ.get("AT2_LOG", "WARNING").upper(),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    maybe_initialize()
    config = Config.load(sys.stdin)
    # the loop's selector, timed: /metrics event_loop_busy_ns
    selector = BusySelector()

    async def main() -> None:
        import signal

        from ..node.service import Service

        service = await Service.start(config)
        service.loop_selector = selector
        # SIGTERM (systemd/k8s stop, test harness kill) must shut down
        # gracefully like SIGINT: quiesce, drain deliveries, write the
        # final checkpoint. Default SIGTERM disposition would kill the
        # process mid-state with no snapshot.
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):
                pass  # non-unix / nested-loop fallback: SIGINT still works
        serve = asyncio.ensure_future(service.serve_forever())
        stopped = asyncio.ensure_future(stop.wait())
        try:
            await asyncio.wait(
                {serve, stopped}, return_when=asyncio.FIRST_COMPLETED
            )
        finally:
            # close() BEFORE cancelling serve: wait_for_termination shares
            # grpc's shutdown future — cancelling it first poisons the
            # stop() await inside close() with CancelledError.
            await service.close()
            for t in (serve, stopped):
                t.cancel()
            await asyncio.gather(serve, stopped, return_exceptions=True)
        if not stop.is_set() and serve.done() and not serve.cancelled():
            exc = serve.exception()
            if exc is not None:
                raise exc  # server crashed: surface it, exit nonzero

    try:
        asyncio.run(main(), loop_factory=lambda: asyncio.SelectorEventLoop(selector))
    except KeyboardInterrupt:
        pass
    except OSError as exc:
        print(f"server: {exc}", file=sys.stderr)
        return 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="server", description="AT2 node")
    sub = parser.add_subparsers(dest="command", required=True)

    config = sub.add_parser("config", help="manage node configuration")
    config_sub = config.add_subparsers(dest="config_command", required=True)

    new = config_sub.add_parser("new", help="generate a fresh node config")
    new.add_argument("node_address", help="host:port of the node-to-node plane")
    new.add_argument("rpc_address", help="host:port of the client gRPC plane")
    new.add_argument(
        "--verifier", choices=("cuda", "cpu", "pool"), default=VerifierConfig.kind,
        help="[verifier] kind: the kernel on the first CUDA device "
        "(default), the host verifier, or the pool over every local CUDA "
        "device",
    )
    new.set_defaults(func=cmd_config_new)

    get_node = config_sub.add_parser(
        "get-node", help="print this node's shareable [[nodes]] fragment"
    )
    get_node.set_defaults(func=cmd_config_get_node)

    run = sub.add_parser("run", help="run the node (config on stdin)")
    run.set_defaults(func=cmd_run)

    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
