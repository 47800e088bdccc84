"""Training of the port (counterpart of ``video_edge_ai_proxy_tpu/parallel/``),
on one card: ``make_trainer`` and its train step. The mesh, sharding and
sequence-parallel attention of the JAX package are not ported yet."""

from .train import (
    AUX_LOSS_WEIGHT, Trainer, TrainState, clip_by_global_norm, cross_entropy_loss,
    global_norm, make_trainer,
)

__all__ = [
    "AUX_LOSS_WEIGHT", "Trainer", "TrainState", "clip_by_global_norm",
    "cross_entropy_loss", "global_norm", "make_trainer",
]
