"""The temporal cascade (counterpart of ``video_edge_ai_proxy_tpu/temporal``).

The detector runs every tick; each tracked detection's crop goes into a
device-resident clip ring of its track (``TrackStatePool``), and every N
ticks a temporal head (a VideoMAE and a logistic anomaly score) runs as its
own program of the engine's step cache over every track with a full clip
(``CascadeScheduler``); its scores pass a hysteresis (``TrackEventTracker``)
and the enter and exit events go out through the uplink, the archive and
the metrics. Importing this package builds nothing and touches no device.
"""

from .events import TrackEventTracker
from .scheduler import CascadeScheduler, CascadeTickResult
from .state_pool import TrackStatePool

__all__ = [
    "CascadeScheduler",
    "CascadeTickResult",
    "TrackEventTracker",
    "TrackStatePool",
]
