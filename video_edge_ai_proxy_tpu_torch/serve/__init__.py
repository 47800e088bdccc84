"""The server around the port's engine (counterpart of the JAX package's
``serve/``): the registry (``storage``, ``models``, ``settings``), the
camera process manager, the maintenance cron, the gRPC and REST wire
(``grpc_api``, ``rest_api``: they import ``grpc``, ``google.protobuf``
and ``aiohttp``, so only ``Server.start`` imports them) and ``server``.
Importing this package needs none of those."""

from .models import ProcessState, RTMPStreamStatus, Settings, StreamProcess
from .process_manager import ProcessError, ProcessManager
from .settings import SettingsManager
from .storage import NotFound, Storage

__all__ = [
    "ProcessError",
    "ProcessManager",
    "ProcessState",
    "RTMPStreamStatus",
    "Settings",
    "SettingsManager",
    "NotFound",
    "Storage",
    "StreamProcess",
]
