"""Run one broker ingress tier (broker.py) as a process.

Counterpart of ``at2_node_tpu/tools/broker.py``.

The broker serves the full `at2.AT2` surface on --listen (native gRPC +
grpc-web + GET /metrics, same PortMux as a node), collects SendAsset /
SendAssetBatch submissions, and forwards them to --node as distilled
SendDistilledBatch frames on a size/deadline trigger.

Usage:
    python -m at2_node_tpu_torch.tools.broker \
        --node http://127.0.0.1:4001 --listen 0.0.0.0:5001 \
        [--max-entries 1024] [--window 0.005] [--eager]
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from ..broker import Broker
from ..node.config import OverloadConfig
from ..proto.distill import DISTILL_MAX_ENTRIES


async def _run(args) -> int:
    broker = await Broker.start(
        args.node,
        args.listen,
        max_entries=args.max_entries,
        window=args.window,
        eager=args.eager,
        overload=(
            OverloadConfig(enabled=True) if args.overload else None
        ),
    )
    try:
        await broker.serve_forever()
    except asyncio.CancelledError:
        pass
    finally:
        await broker.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--node", required=True,
                    help="RPC URL of the node to forward distilled frames to")
    ap.add_argument("--listen", required=True,
                    help="host:port for the broker's client-facing surface")
    ap.add_argument("--max-entries", type=int, default=1024,
                    help="flush when this many transfers are buffered "
                    f"(cap {DISTILL_MAX_ENTRIES})")
    ap.add_argument("--window", type=float, default=0.005,
                    help="flush deadline in seconds for a partial buffer")
    ap.add_argument("--eager", action="store_true",
                    help="anchor the flush deadline to the first buffered "
                    "entry and shrink it as the buffer fills (lower "
                    "tail latency, smaller frames)")
    ap.add_argument("--overload", action="store_true",
                    help="graduated brownout ladder (default [overload] "
                    "knobs): shrink flush deadlines past brownout_frac "
                    "of the pending cap, refuse with a retry-after hint "
                    "past refuse_frac, instead of the hard-cap cliff")
    ap.add_argument("--log-level", default="warning")
    args = ap.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper())
    try:
        return asyncio.run(_run(args))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
