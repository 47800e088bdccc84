"""gRPC bindings for the ``Image`` service.

Hand-written equivalent of what ``grpc_tools.protoc`` would emit. The
service path strings match the reference's generated stubs (its
``python/proto/video_streaming_pb2_grpc.py``) so reference clients
interoperate: ``/chrys.cloud.videostreaming.v1beta1.Image/<Method>``.
"""

from __future__ import annotations

import grpc

from . import video_streaming_pb2 as pb

_SERVICE = "chrys.cloud.videostreaming.v1beta1.Image"


class ImageStub:
    """Client stub; mirrors the generated ``ImageStub`` surface used by the
    reference examples (``examples/basic_usage.py``)."""

    def __init__(self, channel: grpc.Channel):
        self.VideoLatestImage = channel.stream_stream(
            f"/{_SERVICE}/VideoLatestImage",
            request_serializer=pb.VideoFrameRequest.SerializeToString,
            response_deserializer=pb.VideoFrame.FromString,
        )
        self.ListStreams = channel.unary_stream(
            f"/{_SERVICE}/ListStreams",
            request_serializer=pb.ListStreamRequest.SerializeToString,
            response_deserializer=pb.ListStream.FromString,
        )
        self.Annotate = channel.unary_unary(
            f"/{_SERVICE}/Annotate",
            request_serializer=pb.AnnotateRequest.SerializeToString,
            response_deserializer=pb.AnnotateResponse.FromString,
        )
        self.Proxy = channel.unary_unary(
            f"/{_SERVICE}/Proxy",
            request_serializer=pb.ProxyRequest.SerializeToString,
            response_deserializer=pb.ProxyResponse.FromString,
        )
        self.Storage = channel.unary_unary(
            f"/{_SERVICE}/Storage",
            request_serializer=pb.StorageRequest.SerializeToString,
            response_deserializer=pb.StorageResponse.FromString,
        )
        self.Inference = channel.unary_stream(
            f"/{_SERVICE}/Inference",
            request_serializer=pb.InferenceRequest.SerializeToString,
            response_deserializer=pb.InferenceResult.FromString,
        )


class ImageServicer:
    """Service base class; override the methods you implement."""

    def VideoLatestImage(self, request_iterator, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def ListStreams(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def Annotate(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def Proxy(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def Storage(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def Inference(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_ImageServicer_to_server(servicer: ImageServicer, server: grpc.Server) -> None:
    rpc_method_handlers = {
        "VideoLatestImage": grpc.stream_stream_rpc_method_handler(
            servicer.VideoLatestImage,
            request_deserializer=pb.VideoFrameRequest.FromString,
            response_serializer=pb.VideoFrame.SerializeToString,
        ),
        "ListStreams": grpc.unary_stream_rpc_method_handler(
            servicer.ListStreams,
            request_deserializer=pb.ListStreamRequest.FromString,
            response_serializer=pb.ListStream.SerializeToString,
        ),
        "Annotate": grpc.unary_unary_rpc_method_handler(
            servicer.Annotate,
            request_deserializer=pb.AnnotateRequest.FromString,
            response_serializer=pb.AnnotateResponse.SerializeToString,
        ),
        "Proxy": grpc.unary_unary_rpc_method_handler(
            servicer.Proxy,
            request_deserializer=pb.ProxyRequest.FromString,
            response_serializer=pb.ProxyResponse.SerializeToString,
        ),
        "Storage": grpc.unary_unary_rpc_method_handler(
            servicer.Storage,
            request_deserializer=pb.StorageRequest.FromString,
            response_serializer=pb.StorageResponse.SerializeToString,
        ),
        "Inference": grpc.unary_stream_rpc_method_handler(
            servicer.Inference,
            request_deserializer=pb.InferenceRequest.FromString,
            response_serializer=pb.InferenceResult.SerializeToString,
        ),
    }
    handler = grpc.method_handlers_generic_handler(_SERVICE, rpc_method_handlers)
    server.add_generic_rpc_handlers((handler,))
