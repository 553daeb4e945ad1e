"""The `at2.AT2` wire format, read from the benchmark's own copy of at2.proto.

The benchmark speaks to the nodes without importing anything of the
program: :func:`load_proto` reads the message definitions of
``benchmark/proto/at2.proto`` (a copy of the service's published
contract), and :class:`Codec` encodes and decodes those messages in the
protobuf wire format by their field numbers and scalar types. Only what
the file uses is supported: scalar fields, ``repeated`` fields, nested
messages and enums (read as varints).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict

PROTO_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "proto", "at2.proto")

_VARINT = {"uint32", "uint64", "int32", "int64", "bool"}
_BYTES = {"bytes", "string"}


@dataclass(frozen=True)
class Field:
    name: str
    number: int
    type: str
    repeated: bool


def _strip_comments(text: str) -> str:
    return re.sub(r"//[^\n]*", "", text)


def _blocks(text: str, keyword: str):
    """(name, body) of every top-level ``keyword Name { ... }`` block,
    braces balanced."""
    pos = 0
    head = re.compile(r"\b" + keyword + r"\s+(\w+)\s*\{")
    while True:
        m = head.search(text, pos)
        if m is None:
            return
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        yield m.group(1), text[m.end():i - 1]
        pos = i


def load_proto(path: str = PROTO_PATH) -> Dict[str, Dict[str, Field]]:
    """{message name: {field name: Field}} of every message in the file."""
    with open(path) as f:
        text = _strip_comments(f.read())
    enums = {name for name, _ in _blocks(text, "enum")}
    messages: Dict[str, Dict[str, Field]] = {}
    for name, body in _blocks(text, "message"):
        enums |= {n for n, _ in _blocks(body, "enum")}
        flat = re.sub(r"\benum\s+\w+\s*\{[^}]*\}", "", body)
        fields = {}
        for m in re.finditer(r"(repeated\s+)?(\w+)\s+(\w+)\s*=\s*(\d+)\s*;", flat):
            ftype = "enum" if m.group(2) in enums else m.group(2)
            fields[m.group(3)] = Field(m.group(3), int(m.group(4)), ftype, bool(m.group(1)))
        messages[name] = fields
    return messages


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, i: int):
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


class Codec:
    """Encode and decode the messages of one .proto file."""

    def __init__(self, path: str = PROTO_PATH) -> None:
        self.messages = load_proto(path)

    def encode(self, message: str, values: dict) -> bytes:
        fields = self.messages[message]
        out = bytearray()
        for name, value in values.items():
            f = fields[name]
            for v in (value if f.repeated else [value]):
                if f.type in _VARINT or f.type == "enum":
                    out += _varint(f.number << 3) + _varint(int(v))
                else:
                    raw = v.encode() if f.type == "string" else (
                        v if f.type == "bytes" else self.encode(f.type, v))
                    out += _varint((f.number << 3) | 2) + _varint(len(raw)) + raw
        return bytes(out)

    def decode(self, message: str, buf: bytes) -> dict:
        by_number = {f.number: f for f in self.messages[message].values()}
        out: dict = {f.name: [] for f in by_number.values() if f.repeated}
        i = 0
        while i < len(buf):
            key, i = _read_varint(buf, i)
            number, wire = key >> 3, key & 7
            if wire == 0:
                value, i = _read_varint(buf, i)
            elif wire == 2:
                n, i = _read_varint(buf, i)
                value, i = buf[i:i + n], i + n
            else:
                raise ValueError(f"{message}: wire type {wire} is not in at2.proto")
            f = by_number.get(number)
            if f is None:
                continue
            if wire == 2 and f.type not in _BYTES:
                value = self.decode(f.type, value)
            elif f.type == "string":
                value = value.decode()
            if f.repeated:
                out[f.name].append(value)
            else:
                out[f.name] = value
        return out


def rpc_path(method: str) -> str:
    return f"/at2.AT2/{method}"

