"""`client` CLI: wallet commands over the `at2.AT2` RPC surface.

Counterpart of ``at2_node_tpu/cli/client.py``.

Same subcommand surface, config schema, and output formats as the
reference client binary (`at2-node/src/bin/client/main.rs:19-175`,
`at2-node/src/bin/client/config.rs:7-13`):

    client config new <rpc_url>        > wallet.toml   # random keypair
    client config get-public-key       < wallet.toml   # hex public key
    client send-asset <seq> <recipient-hex> <amount>  < wallet.toml
    client get-balance                 < wallet.toml
    client get-last-sequence           < wallet.toml
    client get-latest-transactions     < wallet.toml

Config is `{rpc_address, private_key(hex)}` TOML on stdin; generated
config goes to stdout — pure shell-pipe plumbing like the reference.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: tomli is the same parser
    import tomli as tomllib
from dataclasses import dataclass

from ..client import Client
from ..crypto.keys import SignKeyPair
from ..types import TransactionState


@dataclass
class WalletConfig:
    rpc_address: str
    private_key: SignKeyPair

    def dumps(self) -> str:
        return (
            f'rpc_address = "{self.rpc_address}"\n'
            f'private_key = "{self.private_key.to_hex()}"\n'
        )

    @staticmethod
    def load_stdin() -> "WalletConfig":
        doc = tomllib.loads(sys.stdin.read())
        return WalletConfig(
            rpc_address=doc["rpc_address"],
            private_key=SignKeyPair.from_hex(doc["private_key"]),
        )


def cmd_config_new(args: argparse.Namespace) -> int:
    sys.stdout.write(WalletConfig(args.rpc_address, SignKeyPair.random()).dumps())
    return 0


def cmd_config_get_public_key(args: argparse.Namespace) -> int:
    print(WalletConfig.load_stdin().private_key.public.hex())
    return 0


def _run(coro) -> int:
    try:
        asyncio.run(coro)
        return 0
    except Exception as exc:  # match the reference's single-line stderr exit
        print(f"error running cmd: {exc}", file=sys.stderr)
        return 1


def cmd_send_asset(args: argparse.Namespace) -> int:
    config = WalletConfig.load_stdin()

    async def go() -> None:
        async with Client(config.rpc_address) as client:
            await client.send_asset(
                config.private_key,
                args.sequence,
                bytes.fromhex(args.recipient),
                args.amount,
            )

    return _run(go())


def cmd_get_balance(args: argparse.Namespace) -> int:
    config = WalletConfig.load_stdin()

    async def go() -> None:
        async with Client(config.rpc_address) as client:
            print(await client.get_balance(config.private_key.public))

    return _run(go())


def cmd_get_last_sequence(args: argparse.Namespace) -> int:
    config = WalletConfig.load_stdin()

    async def go() -> None:
        async with Client(config.rpc_address) as client:
            print(await client.get_last_sequence(config.private_key.public))

    return _run(go())


_STATE_NAMES = {
    TransactionState.PENDING: "pending",
    TransactionState.SUCCESS: "success",
    TransactionState.FAILURE: "failure",
}


def cmd_get_latest_transactions(args: argparse.Namespace) -> int:
    config = WalletConfig.load_stdin()

    async def go() -> None:
        async with Client(config.rpc_address) as client:
            for tx in await client.get_latest_transactions():
                # same human format as client/main.rs:134-147
                print(
                    f"{tx.timestamp.isoformat()}: {tx.sender.hex()} send "
                    f"{tx.amount}¤ to {tx.recipient.hex()} "
                    f"({_STATE_NAMES[tx.state]})"
                )

    return _run(go())


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="client", description="AT2 wallet")
    sub = parser.add_subparsers(dest="command", required=True)

    config = sub.add_parser("config", help="manage wallet configuration")
    config_sub = config.add_subparsers(dest="config_command", required=True)
    new = config_sub.add_parser("new", help="generate a fresh wallet config")
    new.add_argument("rpc_address", help="node RPC url, e.g. http://host:port")
    new.set_defaults(func=cmd_config_new)
    gpk = config_sub.add_parser("get-public-key", help="print hex public key")
    gpk.set_defaults(func=cmd_config_get_public_key)

    send = sub.add_parser("send-asset", help="sign and submit a transfer")
    send.add_argument("sequence", type=int)
    send.add_argument("recipient", help="recipient public key (hex)")
    send.add_argument("amount", type=int)
    send.set_defaults(func=cmd_send_asset)

    sub.add_parser("get-balance").set_defaults(func=cmd_get_balance)
    sub.add_parser("get-last-sequence").set_defaults(func=cmd_get_last_sequence)
    sub.add_parser("get-latest-transactions").set_defaults(
        func=cmd_get_latest_transactions
    )

    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
