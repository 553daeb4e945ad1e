"""Fixed-slot shared-memory SPSC ring: the cross-process handoff lane.

Counterpart of ``at2_node_tpu/parallel/ring.py``.

The thread-mode sharded plane hands effects back to the owner loop
through an in-process ``SPSCQueue`` (parallel/plane.py) — Python object
references, no serialization, GIL-atomic deque ops. A process-mode
shard cannot share object references, but it doesn't need to: every
record that crosses the plane boundary is already flat bytes (wire
frames out, payload bodies in), so the handoff lane becomes a fixed-slot
ring over ``multiprocessing.shared_memory`` carrying ``(len, kind,
payload)`` records directly — no pickling per item, no per-record
allocation on the producer side beyond the payload copy into the
segment.

Layout (one segment per direction per shard)::

    header (64 bytes, 8-byte aligned fields):
      [ 0: 4)  magic   u32  0x52325441 ("AT2R")
      [ 4: 8)  slot    u32  slot size in bytes
      [ 8:16)  nslots  u64
      [16:24)  head    u64  producer-owned: total slots ever claimed
      [24:32)  tail    u64  consumer-owned: total slots ever consumed
      [32:40)  dropped u64  producer-owned: records refused at capacity
    data (nslots * slot bytes):
      records start on slot boundaries; each spans
      ceil((16 + len) / slot) CONTIGUOUS slots:
        [0: 1)  kind   u8   (application record type)
        [1: 2)  flag   u8   1 = wrap pad (no payload; consumer skips to
                            the ring start), 0 = data record
        [2: 4)  pad
        [4: 8)  len    u32  payload length in bytes
        [8:16)  t_ns   u64  producer CLOCK_MONOTONIC enqueue stamp
        [16:..) payload

Counters are MONOTONIC (they never wrap to zero; slot index = counter %
nslots), so fullness is ``head - tail`` with no ambiguous empty/full
state and no modular arithmetic races. The producer writes record bytes
first and publishes ``head`` last; the consumer reads records strictly
below ``head`` and publishes ``tail`` after copying them out. Each
counter has exactly ONE writer. On x86-64 (and AArch64 for an aligned
8-byte store) that single publish is not torn and stores are not
reordered past it under the TSO model CPython's memcpy-based
``pack_into`` compiles to; a port to a weaker memory model would need a
real fence here, which is called out rather than hidden.

``put`` never overwrites and never blocks: a record that does not fit —
including the wrap pad it may need to stay contiguous — increments
``dropped`` and returns False, preserving the producer-side drop
accounting contract of ``SPSCQueue.put``. A producer that sets ``spill``
keeps such a record instead, in a backlog of its own process, and every
later ``put`` and every ``flush`` moves the backlog into the ring in
order as room appears; only a record larger than the whole ring still
drops. The plane's protocol lanes spill (actions from the owner, effects
from a worker: a dropped message or delivery stalls its sender for good,
and each side drains on its own clock), so neither side loses a record
or waits for the other; the observability lane drops. The consumer's ``drain`` returns ``(records, max_handoff_ns)`` with the same
shape the in-process queue reports, so /metrics observes one handoff
histogram regardless of executor.

Stale segments: a node that died uncleanly leaves its rings in
``/dev/shm``. ``ShmRing(create=True)`` therefore unlinks any existing
segment of the same name before creating — an owner restart never
attaches to (or trips over) a predecessor's ring state. (Spawn workers
share the owner's resource-tracker process, so an owner crash also gets
the segments unlinked by the tracker once the tree is dead.)
"""

from __future__ import annotations

import struct
import time
from collections import deque
from multiprocessing import shared_memory
from typing import List, Tuple

__all__ = ["ShmRing"]

_MAGIC = 0x52325441
_HDR = 64
_REC_HDR = 16
_HEAD_OFF = 16
_TAIL_OFF = 24
_DROP_OFF = 32

_u64 = struct.Struct("<Q")
_rec = struct.Struct("<BBxxIQ")


class ShmRing:
    """Bounded SPSC ring over one shared-memory segment.

    Exactly one producer process calls :meth:`put`; exactly one consumer
    process calls :meth:`drain`. The creating side owns the segment and
    unlinks it on :meth:`close`.
    """

    #: keep a record that does not fit in the producer's backlog instead
    #: of dropping it
    spill = False

    def __init__(
        self,
        name: str,
        *,
        slots: int = 4096,
        slot_bytes: int = 1024,
        create: bool = False,
    ) -> None:
        if create:
            if slots <= 0 or slot_bytes < _REC_HDR:
                raise ValueError("ShmRing needs slots > 0, slot >= 16")
            size = _HDR + slots * slot_bytes
            try:
                shm = shared_memory.SharedMemory(name, create=True, size=size)
            except FileExistsError:
                # stale segment from a dead predecessor: reclaim it
                stale = shared_memory.SharedMemory(name)
                stale.close()
                stale.unlink()
                shm = shared_memory.SharedMemory(name, create=True, size=size)
            buf = shm.buf
            struct.pack_into("<IIQ", buf, 0, _MAGIC, slot_bytes, slots)
            _u64.pack_into(buf, _HEAD_OFF, 0)
            _u64.pack_into(buf, _TAIL_OFF, 0)
            _u64.pack_into(buf, _DROP_OFF, 0)
        else:
            # NOTE on bpo-38119: attaching registers the segment with the
            # resource tracker a second time. That is harmless HERE —
            # spawn workers inherit the owner's tracker process (the
            # tracker fd rides in the spawn preparation data), and the
            # tracker's cache is a set, so attach-side registration is a
            # no-op add and the owner's unlink removes the one entry.
            # Unregistering on attach (the usual bpo-38119 workaround)
            # would be WRONG with a shared tracker: it strips the owner's
            # registration, making every clean unlink a tracker KeyError
            # and losing crash cleanup entirely.
            shm = shared_memory.SharedMemory(name)
            buf = shm.buf
            magic, slot_bytes, slots = struct.unpack_from("<IIQ", buf, 0)
            if magic != _MAGIC:
                shm.close()
                raise ValueError(f"segment {name!r} is not an AT2 ring")
        self._shm = shm
        self._buf = shm.buf
        self._slot = int(slot_bytes)
        self._nslots = int(slots)
        self._owner = create
        self._closed = False
        self.name = name
        self._backlog: deque = deque()
        self.spilled = 0  # records that went through the backlog

    # -- counters ---------------------------------------------------------

    @property
    def head(self) -> int:
        return _u64.unpack_from(self._buf, _HEAD_OFF)[0]

    @property
    def tail(self) -> int:
        return _u64.unpack_from(self._buf, _TAIL_OFF)[0]

    @property
    def dropped(self) -> int:
        """Records refused at capacity (producer-side accounting)."""
        return _u64.unpack_from(self._buf, _DROP_OFF)[0]

    def __len__(self) -> int:
        """Occupied SLOTS (allocation units, not records)."""
        return max(0, self.head - self.tail)

    # -- producer ---------------------------------------------------------

    @property
    def backlog(self) -> int:
        """Records kept in the producer's backlog, not yet in the ring."""
        return len(self._backlog)

    def put(self, kind: int, payload) -> bool:
        """Append one record. One that does not fit joins the backlog
        under ``spill`` (True); otherwise, or when it is larger than the
        whole ring, it drops (False, ``dropped`` += 1). Producer-side
        only."""
        if (_REC_HDR + len(payload) + self._slot - 1) // self._slot > self._nslots:
            self._count_drop()
            return False
        if self.spill:
            if not (self.flush() and self._write(kind, payload)):
                self._backlog.append((kind, bytes(payload)))
                self.spilled += 1
            return True
        if self._write(kind, payload):
            return True
        self._count_drop()
        return False

    def flush(self) -> bool:
        """Move backlog records into the ring, in order, while they fit;
        whether the backlog is empty. Producer-side only."""
        backlog = self._backlog
        while backlog and self._write(*backlog[0]):
            backlog.popleft()
        return not backlog

    def stop_spilling(self) -> None:
        """Turn ``spill`` off (the consumer is gone) and drop the backlog,
        each record counted in ``dropped``."""
        self.spill = False
        self._count_drop(len(self._backlog))
        self._backlog.clear()

    def _count_drop(self, n: int = 1) -> None:
        _u64.pack_into(self._buf, _DROP_OFF, _u64.unpack_from(self._buf, _DROP_OFF)[0] + n)

    def _write(self, kind: int, payload) -> bool:
        """Write one record if it fits now (it is no larger than the ring)."""
        buf = self._buf
        ln = len(payload)
        need = (_REC_HDR + ln + self._slot - 1) // self._slot
        head = _u64.unpack_from(buf, _HEAD_OFF)[0]
        idx = head % self._nslots
        till_end = self._nslots - idx
        pad = 0
        if need > till_end:
            # keep records contiguous: pad out the ring tail, restart at 0
            pad = till_end
            idx = 0
        tail = _u64.unpack_from(buf, _TAIL_OFF)[0]
        free = self._nslots - (head - tail)
        if need + pad > free:
            if pad and self.spill and pad <= free:
                # the backlog's head belongs at the ring start: publish the
                # wrap pad alone, so the consumer's drain frees the start
                _rec.pack_into(buf, _HDR + (head % self._nslots) * self._slot,
                               0, 1, 0, 0)
                _u64.pack_into(buf, _HEAD_OFF, head + pad)
            return False
        if pad:
            _rec.pack_into(buf, _HDR + (head % self._nslots) * self._slot,
                           0, 1, 0, 0)
        off = _HDR + idx * self._slot
        _rec.pack_into(buf, off, kind, 0, ln, time.monotonic_ns())
        if ln:
            buf[off + _REC_HDR : off + _REC_HDR + ln] = payload
        # publish LAST: one aligned 8-byte store makes the record(s)
        # visible; the consumer never reads past head
        _u64.pack_into(buf, _HEAD_OFF, head + pad + need)
        return True

    # -- consumer ---------------------------------------------------------

    def drain(
        self, max_records: int = 0
    ) -> Tuple[List[Tuple[int, bytes]], int]:
        """Pop up to ``max_records`` records (0 = all currently visible).

        Returns ``(records, max_handoff_ns)`` where records are
        ``(kind, payload)`` and the latency is the oldest
        enqueue-to-drain gap seen — the ``plane_shard_handoff_ns``
        number, same contract as ``SPSCQueue.drain``. Consumer-side
        only."""
        buf = self._buf
        out: List[Tuple[int, bytes]] = []
        worst = 0
        now = time.monotonic_ns()
        head = _u64.unpack_from(buf, _HEAD_OFF)[0]
        tail = _u64.unpack_from(buf, _TAIL_OFF)[0]
        while tail < head:
            if max_records and len(out) >= max_records:
                break
            idx = tail % self._nslots
            off = _HDR + idx * self._slot
            kind, flag, ln, t_ns = _rec.unpack_from(buf, off)
            if flag:  # wrap pad: nothing to read before the ring start
                tail += self._nslots - idx
                continue
            payload = bytes(buf[off + _REC_HDR : off + _REC_HDR + ln])
            dt = now - t_ns
            if dt > worst:
                worst = dt
            out.append((kind, payload))
            tail += (_REC_HDR + ln + self._slot - 1) // self._slot
        _u64.pack_into(buf, _TAIL_OFF, tail)
        return out, worst

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._buf = None
        try:
            self._shm.close()
            if self._owner:
                self._shm.unlink()
        except Exception:  # pragma: no cover - teardown best-effort
            pass

    def __del__(self):  # pragma: no cover - GC-order dependent
        try:
            self.close()
        except Exception:
            pass
