"""Annotation uplink of the port: the bounded batching queue
(``queue.AnnotationQueue``) and the signed cloud batch handler
(``cloud.make_batch_handler``), counterparts of the JAX package's
``uplink/`` modules of the same names. The Redis-backed queue
(``redis_queue.RedisAnnotationQueue``) is imported where it is used: the
``Server`` picks it for ``bus.backend: redis``."""

from .cloud import CloudClient, ForbiddenError, annotation_to_cloud, make_batch_handler
from .queue import AnnotationQueue

__all__ = [
    "AnnotationQueue",
    "CloudClient",
    "ForbiddenError",
    "annotation_to_cloud",
    "make_batch_handler",
]
