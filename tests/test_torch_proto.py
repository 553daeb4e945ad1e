"""The port's RPC surface against the JAX package's: the generated
descriptors serialize byte-equal, the same messages encode to the same
bytes, the method tables agree, and distilled frames (the broker ingress
codec) are byte-equal, with the native parser equal to the Python one.

Every frame is made from a numpy seed; every comparison is exact.
"""

import numpy as np
import pytest

from at2_node_tpu.node.directory import ClientDirectory as RefDirectory
from at2_node_tpu.proto import at2_pb2 as ref_pb
from at2_node_tpu.proto import distill as ref_distill
from at2_node_tpu.proto import finality_pb2 as ref_fpb
from at2_node_tpu.proto import rpc as ref_rpc
from at2_node_tpu_torch.native import ingest
from at2_node_tpu_torch.node.directory import ClientDirectory
from at2_node_tpu_torch.proto import at2_pb2 as pb
from at2_node_tpu_torch.proto import distill
from at2_node_tpu_torch.proto import finality_pb2 as fpb
from at2_node_tpu_torch.proto import rpc


@pytest.mark.parametrize("mods", [(pb, ref_pb), (fpb, ref_fpb)], ids=["at2", "finality"])
def test_descriptors_serialize_byte_equal(mods):
    """``at2_pb2`` is protoc's output; ``finality_pb2`` builds its file
    descriptor at import."""

    def file_descriptor(mod):
        return getattr(mod, "DESCRIPTOR", None) or mod._file

    port, ref = map(file_descriptor, mods)
    assert port.serialized_pb == ref.serialized_pb
    assert port.name == ref.name


def test_messages_encode_to_the_same_bytes():
    rng = np.random.default_rng(1)
    req = dict(sender=rng.bytes(32), sequence=7, recipient=rng.bytes(32), amount=123456789,
               signature=rng.bytes(64))
    one, ref_one = pb.SendAssetRequest(**req), ref_pb.SendAssetRequest(**req)
    assert one.SerializeToString() == ref_one.SerializeToString()
    batch = pb.SendAssetBatchRequest(transactions=[one, one])
    ref_batch = ref_pb.SendAssetBatchRequest(transactions=[ref_one, ref_one])
    assert batch.SerializeToString() == ref_batch.SerializeToString()
    reply = fpb.GetCertificateReply(enabled=True, epoch=3, node_commits=9, certificates=[b"x"])
    ref_reply = ref_fpb.GetCertificateReply(enabled=True, epoch=3, node_commits=9, certificates=[b"x"])
    assert reply.SerializeToString() == ref_reply.SerializeToString()


def test_rpc_method_tables_agree():
    assert {k: (a.DESCRIPTOR.full_name, b.DESCRIPTOR.full_name) for k, (a, b) in rpc._METHODS.items()} == {
        k: (a.DESCRIPTOR.full_name, b.DESCRIPTOR.full_name) for k, (a, b) in ref_rpc._METHODS.items()
    }
    assert rpc.SERVICE_NAME == ref_rpc.SERVICE_NAME


def _entries(rng, n, n_ids):
    """Seeded distilled entries: ids below ``n_ids``, about one recipient in
    four a raw key, sorted by (sender, sequence) with no duplicate pair."""
    pairs = sorted({(int(rng.integers(0, n_ids)), int(rng.integers(1, 1 << 20))) for _ in range(n)})
    out = []
    for sender, seq in pairs:
        recipient = rng.bytes(32) if rng.random() < 0.25 else int(rng.integers(0, n_ids + 2))
        amount = int(rng.integers(0, 1 << 63))
        out.append((sender, seq, recipient, amount, rng.bytes(64)))
    return out


@pytest.mark.parametrize("n", [1, 7, 300, 4096])
def test_distilled_frames_are_byte_equal_and_parse_alike(n):
    rng = np.random.default_rng(n)
    n_ids = 40
    raw = _entries(rng, n, n_ids)
    frame, dropped = distill.distill([distill.DistilledEntry(*e) for e in raw])
    ref_frame, ref_dropped = ref_distill.distill([ref_distill.DistilledEntry(*e) for e in raw])
    assert frame == ref_frame and dropped == ref_dropped == 0
    assert [(e.sender_id, e.sequence, e.recipient, e.amount, e.signature)
            for e in distill.decode(frame)] == raw

    # a directory holding ids 0..n_ids-1 (ids n_ids, n_ids+1 miss)
    port_dir, ref_dir = ClientDirectory(), RefDirectory()
    keys = [rng.bytes(32) for _ in range(n_ids)]
    for k in keys:
        assert port_dir.assign(k) == ref_dir.assign(k)
    bodies, ids, ok = distill.expand_py(frame, port_dir.get)
    ref_bodies, ref_ids, ref_ok = ref_distill.expand_py(frame, ref_dir.get)
    assert (bytes(bodies), ids, ok) == (bytes(ref_bodies), ref_ids, ref_ok)
    assert ingest.ingest_available()
    nat_bodies, nat_ids, nat_ok = ingest.distill_parse_native(frame, *port_dir.keys_view())
    assert nat_bodies == bytes(bodies)
    assert nat_ids.tolist() == ids and nat_ok.tolist() == ok


@pytest.mark.parametrize("cut", ["truncated", "bad_magic", "trailing"])
def test_malformed_frames_are_refused_by_every_parser(cut):
    rng = np.random.default_rng(5)
    frame, _ = distill.distill([distill.DistilledEntry(*e) for e in _entries(rng, 20, 8)])
    bad = {"truncated": frame[:-5], "bad_magic": b"\x00" + frame[1:], "trailing": frame + b"\x01"}[cut]
    for decode in (distill.decode, ref_distill.decode):
        with pytest.raises(ValueError):
            decode(bad)
    assert ingest.distill_parse_native(bad, *ClientDirectory().keys_view()) is None
