"""The wire messages of the port.

``annotate``: the ``AnnotateRequest`` message and its proto3 codec, without
``protobuf`` (the engine and the annotation uplink use it).
``video_streaming_pb2`` / ``video_streaming_pb2_grpc``: the generated
messages and the ``Image`` service bindings of ``video_streaming.proto``,
for the gRPC wire only; they import ``google.protobuf`` and ``grpc``, so
nothing imports them before the server starts its wire.
"""
