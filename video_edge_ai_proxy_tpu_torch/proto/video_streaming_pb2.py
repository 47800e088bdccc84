# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: video_streaming.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




# A pool of the port's own, so the JAX package's copy of the same file can
# live in one process beside it.
_POOL = _descriptor_pool.DescriptorPool()
DESCRIPTOR = _POOL.AddSerializedFile(b'\n\x15video_streaming.proto\x12"chrys.cloud.videostreaming.v1beta1"\xd3\x06\n\x0fAnnotateRequest\x12\x13\n\x0bdevice_name\x18\x01 \x01(\t\x12\x18\n\x10remote_stream_id\x18\x02 \x01(\t\x12\x0c\n\x04type\x18\x03 \x01(\t\x12\x17\n\x0fstart_timestamp\x18\x04 \x01(\x03\x12\x15\n\rend_timestamp\x18\x05 \x01(\x03\x12\x13\n\x0bobject_type\x18\x06 \x01(\t\x12\x11\n\tobject_id\x18\x07 \x01(\t\x12\x1a\n\x12object_tracking_id\x18\x08 \x01(\t\x12\x12\n\nconfidence\x18\t \x01(\x01\x12K\n\x12object_bouding_box\x18\n \x01(\x0b2/.chrys.cloud.videostreaming.v1beta1.BoundingBox\x12>\n\x08location\x18\x0b \x01(\x0b2,.chrys.cloud.videostreaming.v1beta1.Location\x12I\n\x11object_coordinate\x18\x0c \x01(\x0b2..chrys.cloud.videostreaming.v1beta1.Coordinate\x12<\n\x04mask\x18\r \x03(\x0b2..chrys.cloud.videostreaming.v1beta1.Coordinate\x12\x18\n\x10object_signature\x18\x0e \x03(\x01\x12\x10\n\x08ml_model\x18\x0f \x01(\t\x12\x18\n\x10ml_model_version\x18\x10 \x01(\t\x12\r\n\x05width\x18\x11 \x01(\x05\x12\x0e\n\x06height\x18\x12 \x01(\x05\x12\x13\n\x0bis_keyframe\x18\x13 \x01(\x08\x12\x12\n\nvideo_type\x18\x14 \x01(\t\x12\x18\n\x10offset_timestamp\x18\x15 \x01(\x03\x12\x17\n\x0foffset_duration\x18\x16 \x01(\x03\x12\x17\n\x0foffset_frame_id\x18\x17 \x01(\x03\x12\x18\n\x10offset_packet_id\x18\x18 \x01(\x03\x12\x15\n\rcustom_meta_1\x18\x19 \x01(\t\x12\x15\n\rcustom_meta_2\x18\x1a \x01(\t\x12\x15\n\rcustom_meta_3\x18\x1b \x01(\t\x12\x15\n\rcustom_meta_4\x18\x1c \x01(\t\x12\x15\n\rcustom_meta_5\x18\x1d \x01(\t"h\n\x10AnnotateResponse\x12\x13\n\x0bdevice_name\x18\x01 \x01(\t\x12\x18\n\x10remote_stream_id\x18\x02 \x01(\t\x12\x0c\n\x04type\x18\x03 \x01(\t\x12\x17\n\x0fstart_timestamp\x18\x04 \x01(\x03"$\n\x08Location\x12\x0b\n\x03lat\x18\x01 \x01(\x01\x12\x0b\n\x03lon\x18\x02 \x01(\x01"-\n\nCoordinate\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x12\t\n\x01z\x18\x03 \x01(\x01"G\n\x0bBoundingBox\x12\x0b\n\x03top\x18\x01 \x01(\x05\x12\x0c\n\x04left\x18\x02 \x01(\x05\x12\r\n\x05width\x18\x03 \x01(\x05\x12\x0e\n\x06height\x18\x04 \x01(\x05"p\n\nShapeProto\x12?\n\x03dim\x18\x02 \x03(\x0b22.chrys.cloud.videostreaming.v1beta1.ShapeProto.Dim\x1a!\n\x03Dim\x12\x0c\n\x04size\x18\x01 \x01(\x03\x12\x0c\n\x04name\x18\x02 \x01(\t"\xd1\x02\n\nVideoFrame\x12\r\n\x05width\x18\x01 \x01(\x03\x12\x0e\n\x06height\x18\x02 \x01(\x03\x12\x0c\n\x04data\x18\x03 \x01(\x0c\x12\x11\n\ttimestamp\x18\x04 \x01(\x03\x12\x13\n\x0bis_keyframe\x18\x05 \x01(\x08\x12\x0b\n\x03pts\x18\x06 \x01(\x03\x12\x0b\n\x03dts\x18\x07 \x01(\x03\x12\x12\n\nframe_type\x18\x08 \x01(\t\x12\x12\n\nis_corrupt\x18\t \x01(\x08\x12\x11\n\ttime_base\x18\n \x01(\x01\x12=\n\x05shape\x18\x0b \x01(\x0b2..chrys.cloud.videostreaming.v1beta1.ShapeProto\x12\x11\n\tdevice_id\x18\x0c \x01(\t\x12\x0e\n\x06packet\x18\r \x01(\x03\x12\x10\n\x08keyframe\x18\x0e \x01(\x03\x12\x10\n\x08trace_id\x18\x0f \x01(\x03\x12\x13\n\x0bparent_span\x18\x10 \x01(\x03">\n\x11VideoFrameRequest\x12\x16\n\x0ekey_frame_only\x18\x01 \x01(\x08\x12\x11\n\tdevice_id\x18\x02 \x01(\t"\xee\x01\n\nListStream\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\t\x12\x16\n\x0efailing_streak\x18\x03 \x01(\x03\x12\x15\n\rhealth_status\x18\x04 \x01(\t\x12\x0c\n\x04dead\x18\x05 \x01(\x08\x12\x11\n\texit_code\x18\x06 \x01(\x03\x12\x0b\n\x03pid\x18\x07 \x01(\x05\x12\x0f\n\x07running\x18\x08 \x01(\x08\x12\x0e\n\x06paused\x18\t \x01(\x08\x12\x12\n\nrestarting\x18\n \x01(\x08\x12\x11\n\toomkilled\x18\x0b \x01(\x08\x12\r\n\x05error\x18\x0c \x01(\t\x12\x0e\n\x06source\x18\r \x01(\t"\x13\n\x11ListStreamRequest"6\n\x0cProxyRequest\x12\x11\n\tdevice_id\x18\x01 \x01(\t\x12\x13\n\x0bpassthrough\x18\x02 \x01(\x08"7\n\rProxyResponse\x12\x11\n\tdevice_id\x18\x01 \x01(\t\x12\x13\n\x0bpassthrough\x18\x02 \x01(\x08"2\n\x0eStorageRequest\x12\x11\n\tdevice_id\x18\x01 \x01(\t\x12\r\n\x05start\x18\x02 \x01(\x08"3\n\x0fStorageResponse\x12\x11\n\tdevice_id\x18\x01 \x01(\t\x12\r\n\x05start\x18\x02 \x01(\x08"\xa8\x01\n\tDetection\x12<\n\x03box\x18\x01 \x01(\x0b2/.chrys.cloud.videostreaming.v1beta1.BoundingBox\x12\x12\n\nconfidence\x18\x02 \x01(\x01\x12\x10\n\x08class_id\x18\x03 \x01(\x05\x12\x12\n\nclass_name\x18\x04 \x01(\t\x12\x11\n\tembedding\x18\x05 \x03(\x02\x12\x10\n\x08track_id\x18\x06 \x01(\t"\x85\x02\n\x0fInferenceResult\x12\x11\n\tdevice_id\x18\x01 \x01(\t\x12\x11\n\ttimestamp\x18\x02 \x01(\x03\x12\r\n\x05model\x18\x03 \x01(\t\x12\x15\n\rmodel_version\x18\x04 \x01(\t\x12A\n\ndetections\x18\x05 \x03(\x0b2-.chrys.cloud.videostreaming.v1beta1.Detection\x12\x12\n\nlatency_ms\x18\x06 \x01(\x01\x12\x12\n\nbatch_size\x18\x07 \x01(\x05\x12\x14\n\x0cframe_packet\x18\x08 \x01(\x03\x12\x10\n\x08trace_id\x18\t \x01(\x03\x12\x13\n\x0bparent_span\x18\n \x01(\x03"5\n\x10InferenceRequest\x12\x12\n\ndevice_ids\x18\x01 \x03(\t\x12\r\n\x05model\x18\x02 \x01(\t2\xdd\x05\n\x05Image\x12\x7f\n\x10VideoLatestImage\x125.chrys.cloud.videostreaming.v1beta1.VideoFrameRequest\x1a..chrys.cloud.videostreaming.v1beta1.VideoFrame"\x00(\x010\x01\x12x\n\x0bListStreams\x125.chrys.cloud.videostreaming.v1beta1.ListStreamRequest\x1a..chrys.cloud.videostreaming.v1beta1.ListStream"\x000\x01\x12w\n\x08Annotate\x123.chrys.cloud.videostreaming.v1beta1.AnnotateRequest\x1a4.chrys.cloud.videostreaming.v1beta1.AnnotateResponse"\x00\x12n\n\x05Proxy\x120.chrys.cloud.videostreaming.v1beta1.ProxyRequest\x1a1.chrys.cloud.videostreaming.v1beta1.ProxyResponse"\x00\x12t\n\x07Storage\x122.chrys.cloud.videostreaming.v1beta1.StorageRequest\x1a3.chrys.cloud.videostreaming.v1beta1.StorageResponse"\x00\x12z\n\tInference\x124.chrys.cloud.videostreaming.v1beta1.InferenceRequest\x1a3.chrys.cloud.videostreaming.v1beta1.InferenceResult"\x000\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'video_streaming_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ANNOTATEREQUEST._serialized_start=62
  _ANNOTATEREQUEST._serialized_end=913
  _ANNOTATERESPONSE._serialized_start=915
  _ANNOTATERESPONSE._serialized_end=1019
  _LOCATION._serialized_start=1021
  _LOCATION._serialized_end=1057
  _COORDINATE._serialized_start=1059
  _COORDINATE._serialized_end=1104
  _BOUNDINGBOX._serialized_start=1106
  _BOUNDINGBOX._serialized_end=1177
  _SHAPEPROTO._serialized_start=1179
  _SHAPEPROTO._serialized_end=1291
  _SHAPEPROTO_DIM._serialized_start=1258
  _SHAPEPROTO_DIM._serialized_end=1291
  _VIDEOFRAME._serialized_start=1294
  _VIDEOFRAME._serialized_end=1631
  _VIDEOFRAMEREQUEST._serialized_start=1633
  _VIDEOFRAMEREQUEST._serialized_end=1695
  _LISTSTREAM._serialized_start=1698
  _LISTSTREAM._serialized_end=1936
  _LISTSTREAMREQUEST._serialized_start=1938
  _LISTSTREAMREQUEST._serialized_end=1957
  _PROXYREQUEST._serialized_start=1959
  _PROXYREQUEST._serialized_end=2013
  _PROXYRESPONSE._serialized_start=2015
  _PROXYRESPONSE._serialized_end=2070
  _STORAGEREQUEST._serialized_start=2072
  _STORAGEREQUEST._serialized_end=2122
  _STORAGERESPONSE._serialized_start=2124
  _STORAGERESPONSE._serialized_end=2175
  _DETECTION._serialized_start=2178
  _DETECTION._serialized_end=2346
  _INFERENCERESULT._serialized_start=2349
  _INFERENCERESULT._serialized_end=2610
  _INFERENCEREQUEST._serialized_start=2612
  _INFERENCEREQUEST._serialized_end=2665
  _IMAGE._serialized_start=2668
  _IMAGE._serialized_end=3401
# @@protoc_insertion_point(module_scope)
