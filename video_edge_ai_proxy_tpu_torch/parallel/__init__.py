"""Device parallelism of the port (counterpart of
``video_edge_ai_proxy_tpu/parallel/``): the mesh of device slots and the
data-parallel batch placement over it (``mesh``, ``sharding``), and
``make_trainer`` with its train step on one card (``train``). The
logical-axis rules, tp/fsdp/sp/ep placement, ring and Ulysses attention,
the pipeline and the multi-host bring-up are not ported yet."""

from .mesh import AXES, Mesh, Slot, factor_mesh, factor_sizes, make_mesh, single_device_mesh
from .sharding import (
    BatchSharding, Replicated, assemble_sharded, batch_sharding, replicated, shard_put,
)
from .train import (
    AUX_LOSS_WEIGHT, Trainer, TrainState, clip_by_global_norm, cross_entropy_loss,
    global_norm, make_trainer,
)

__all__ = [
    "AUX_LOSS_WEIGHT", "AXES", "BatchSharding", "Mesh", "Replicated", "Slot", "Trainer",
    "TrainState", "assemble_sharded", "batch_sharding", "clip_by_global_norm",
    "cross_entropy_loss", "factor_mesh", "factor_sizes", "global_norm", "make_mesh",
    "make_trainer", "replicated", "shard_put", "single_device_mesh",
]
