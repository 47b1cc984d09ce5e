# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ffn_tpu/proto/example.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1b\x66\x66n_tpu/proto/example.proto\x12\rffn.tfexample\"\x1a\n\tBytesList\x12\r\n\x05value\x18\x01 \x03(\x0c\"\x1e\n\tFloatList\x12\x11\n\x05value\x18\x01 \x03(\x02\x42\x02\x10\x01\"\x1e\n\tInt64List\x12\x11\n\x05value\x18\x01 \x03(\x03\x42\x02\x10\x01\"\xa1\x01\n\x07\x46\x65\x61ture\x12.\n\nbytes_list\x18\x01 \x01(\x0b\x32\x18.ffn.tfexample.BytesListH\x00\x12.\n\nfloat_list\x18\x02 \x01(\x0b\x32\x18.ffn.tfexample.FloatListH\x00\x12.\n\nint64_list\x18\x03 \x01(\x0b\x32\x18.ffn.tfexample.Int64ListH\x00\x42\x06\n\x04kind\"\x89\x01\n\x08\x46\x65\x61tures\x12\x35\n\x07\x66\x65\x61ture\x18\x01 \x03(\x0b\x32$.ffn.tfexample.Features.FeatureEntry\x1a\x46\n\x0c\x46\x65\x61tureEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.ffn.tfexample.Feature:\x02\x38\x01\"4\n\x07\x45xample\x12)\n\x08\x66\x65\x61tures\x18\x01 \x01(\x0b\x32\x17.ffn.tfexample.Featuresb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ffn_tpu_torch.proto.example_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FLOATLIST.fields_by_name['value']._options = None
  _FLOATLIST.fields_by_name['value']._serialized_options = b'\020\001'
  _INT64LIST.fields_by_name['value']._options = None
  _INT64LIST.fields_by_name['value']._serialized_options = b'\020\001'
  _FEATURES_FEATUREENTRY._options = None
  _FEATURES_FEATUREENTRY._serialized_options = b'8\001'
  _BYTESLIST._serialized_start=46
  _BYTESLIST._serialized_end=72
  _FLOATLIST._serialized_start=74
  _FLOATLIST._serialized_end=104
  _INT64LIST._serialized_start=106
  _INT64LIST._serialized_end=136
  _FEATURE._serialized_start=139
  _FEATURE._serialized_end=300
  _FEATURES._serialized_start=303
  _FEATURES._serialized_end=440
  _FEATURES_FEATUREENTRY._serialized_start=370
  _FEATURES_FEATUREENTRY._serialized_end=440
  _EXAMPLE._serialized_start=442
  _EXAMPLE._serialized_end=494
# @@protoc_insertion_point(module_scope)
