# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: at2.proto
"""Generated protocol buffer code.

Counterpart of ``at2_node_tpu/proto/at2_pb2.py``.
"""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tat2.proto\x12\x03at2"j\n\x10SendAssetRequest\x12\x0e\n\x06sender\x18\x01 \x01(\x0c\x12\x10\n\x08sequence\x18\x02 \x01(\r\x12\x11\n\trecipient\x18\x03 \x01(\x0c\x12\x0e\n\x06amount\x18\x04 \x01(\x04\x12\x11\n\tsignature\x18\x05 \x01(\x0c"\x10\n\x0eSendAssetReply"D\n\x15SendAssetBatchRequest\x12+\n\x0ctransactions\x18\x01 \x03(\x0b2\x15.at2.SendAssetRequest"#\n\x11GetBalanceRequest\x12\x0e\n\x06sender\x18\x01 \x01(\x0c"!\n\x0fGetBalanceReply\x12\x0e\n\x06amount\x18\x01 \x01(\x04"(\n\x16GetLastSequenceRequest\x12\x0e\n\x06sender\x18\x01 \x01(\x0c"(\n\x14GetLastSequenceReply\x12\x10\n\x08sequence\x18\x01 \x01(\r"\xcb\x01\n\x0fFullTransaction\x12\x11\n\ttimestamp\x18\x01 \x01(\t\x12\x0e\n\x06sender\x18\x02 \x01(\x0c\x12\x11\n\trecipient\x18\x03 \x01(\x0c\x12\x0e\n\x06amount\x18\x04 \x01(\x04\x12)\n\x05state\x18\x05 \x01(\x0e2\x1a.at2.FullTransaction.State\x12\x17\n\x0fsender_sequence\x18\x06 \x01(\r".\n\x05State\x12\x0b\n\x07Pending\x10\x00\x12\x0b\n\x07Success\x10\x01\x12\x0b\n\x07Failure\x10\x02"\x1e\n\x1cGetLatestTransactionsRequest"H\n\x1aGetLatestTransactionsReply\x12*\n\x0ctransactions\x18\x01 \x03(\x0b2\x14.at2.FullTransaction"%\n\x0fRegisterRequest\x12\x12\n\npublic_key\x18\x01 \x01(\x0c""\n\rRegisterReply\x12\x11\n\tclient_id\x18\x01 \x01(\x04"*\n\x19SendDistilledBatchRequest\x12\r\n\x05frame\x18\x01 \x01(\x0c2\xe6\x03\n\x03AT2\x127\n\tSendAsset\x12\x15.at2.SendAssetRequest\x1a\x13.at2.SendAssetReply\x12:\n\nGetBalance\x12\x16.at2.GetBalanceRequest\x1a\x14.at2.GetBalanceReply\x12I\n\x0fGetLastSequence\x12\x1b.at2.GetLastSequenceRequest\x1a\x19.at2.GetLastSequenceReply\x12[\n\x15GetLatestTransactions\x12!.at2.GetLatestTransactionsRequest\x1a\x1f.at2.GetLatestTransactionsReply\x12A\n\x0eSendAssetBatch\x12\x1a.at2.SendAssetBatchRequest\x1a\x13.at2.SendAssetReply\x124\n\x08Register\x12\x14.at2.RegisterRequest\x1a\x12.at2.RegisterReply\x12I\n\x12SendDistilledBatch\x12\x1e.at2.SendDistilledBatchRequest\x1a\x13.at2.SendAssetReplyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'at2_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SENDASSETREQUEST._serialized_start=18
  _SENDASSETREQUEST._serialized_end=124
  _SENDASSETREPLY._serialized_start=126
  _SENDASSETREPLY._serialized_end=142
  _SENDASSETBATCHREQUEST._serialized_start=144
  _SENDASSETBATCHREQUEST._serialized_end=212
  _GETBALANCEREQUEST._serialized_start=214
  _GETBALANCEREQUEST._serialized_end=249
  _GETBALANCEREPLY._serialized_start=251
  _GETBALANCEREPLY._serialized_end=284
  _GETLASTSEQUENCEREQUEST._serialized_start=286
  _GETLASTSEQUENCEREQUEST._serialized_end=326
  _GETLASTSEQUENCEREPLY._serialized_start=328
  _GETLASTSEQUENCEREPLY._serialized_end=368
  _FULLTRANSACTION._serialized_start=371
  _FULLTRANSACTION._serialized_end=574
  _FULLTRANSACTION_STATE._serialized_start=528
  _FULLTRANSACTION_STATE._serialized_end=574
  _GETLATESTTRANSACTIONSREQUEST._serialized_start=576
  _GETLATESTTRANSACTIONSREQUEST._serialized_end=606
  _GETLATESTTRANSACTIONSREPLY._serialized_start=608
  _GETLATESTTRANSACTIONSREPLY._serialized_end=680
  _REGISTERREQUEST._serialized_start=682
  _REGISTERREQUEST._serialized_end=719
  _REGISTERREPLY._serialized_start=721
  _REGISTERREPLY._serialized_end=755
  _SENDDISTILLEDBATCHREQUEST._serialized_start=757
  _SENDDISTILLEDBATCHREQUEST._serialized_end=799
  _AT2._serialized_start=802
  _AT2._serialized_end=1288
# @@protoc_insertion_point(module_scope)
