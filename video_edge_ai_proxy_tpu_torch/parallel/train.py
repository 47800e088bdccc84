"""Training step on one card (counterpart of ``video_edge_ai_proxy_tpu/parallel/train.py``).

``make_trainer(model)`` returns a ``Trainer`` whose ``train_step`` computes
what the JAX package's jitted ``step_fn`` computes: the loss and its
gradients with respect to every parameter, optional global-norm clipping
(``optax.clip_by_global_norm``), then AdamW (``optax.adamw``: b1 0.9,
b2 0.999, eps 1e-8 outside the square root, decoupled weight decay on
every parameter), with a learning rate that may be a schedule of the
update count (from 0 at the first update, as optax counts).

The non-parameter state (JAX's ``aux`` collections: BatchNorm's running
statistics) is the model's buffers, named by ``TrainState.aux``. The
optimizer never sees them: weight decay goes to parameters only, as
optax's ``adamw`` does on ``params``. With ``mutable_aux`` the statistics
the loss's forward writes (``models/detect_loss.py`` under
``update_stats=True``, through ``common.batch_statistics``) are kept, as
JAX threads the loss's returned collections into the next state; without
it, the buffers are restored after the backward, as JAX's frozen ``aux``.
The step order is JAX's: the forward (and its statistics), the gradients,
clipping, AdamW.

Differences of form, not of result:
- The parameters live in the model (``TrainState.params`` names them) and
  the optimizer state in a ``torch.optim.AdamW``; ``train_step`` updates
  both in place and returns the state. The JAX step donates its state, so
  the old one is gone there too.
- A loss returns the scalar alone, also with ``mutable_aux``: the new
  statistics are already in the model's buffers (JAX's returns
  ``(loss, new_aux)``).
- No mesh: one device. Data, tensor and sequence parallelism and the
  mixture-of-experts auxiliary losses (``AUX_LOSS_WEIGHT`` weighs them in
  JAX) are not ported yet.

A parameter the loss does not reach gets a zero gradient, as under
``jax.grad``, so weight decay and the moments still move it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

# Weight on sown auxiliary objectives (the switch-MoE load-balance loss) in
# the JAX package; no ported model sows one yet.
AUX_LOSS_WEIGHT = 0.01

LossFn = Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor]
Schedule = Union[float, Callable[[int], float]]


def cross_entropy_loss(model: nn.Module, batch: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy of the model's float32 logits against
    integer ``labels``. The trainer runs the model in ``train()`` mode (a
    ViT-family model has no BatchNorm statistics, so dropout is active, as
    in JAX)."""
    return F.cross_entropy(model(batch).float(), labels)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    in float32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: when the global norm is at
    least ``max_norm`` every gradient becomes ``g / norm * max_norm``,
    else nothing changes. (``torch.nn.utils.clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead.) Returns the norm; no host synchronisation."""
    grads = list(grads)
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


@dataclass
class TrainState:
    step: int                               # updates made so far
    params: Dict[str, nn.Parameter]         # the model's parameters, by name
    opt_state: torch.optim.AdamW
    # The model's floating-point buffers (BatchNorm running statistics), by
    # name: JAX's aux collections.
    aux: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass
class Trainer:
    """Owns the model on its device, the optimizer settings and the step."""

    model: nn.Module
    device: torch.device
    learning_rate: Schedule
    weight_decay: float
    loss_fn: LossFn
    clip_norm: Optional[float] = None
    mutable_aux: bool = False

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """Fresh random weights (the model's ``init_weights`` from the CPU
        ``generator``, default seed 0: flax's schemes, ``init_convnet_weights``
        for a convnet) and a fresh optimizer."""
        with torch.no_grad():
            self.model.init_weights(generator or torch.Generator().manual_seed(0))
        return self._fresh_state()

    def init_state_from(self, state) -> TrainState:
        """The fine-tune entry point: load ``state`` and start a fresh
        optimizer. ``state`` is a port ``state_dict`` (an imported or
        previously trained checkpoint, any dtype) or the flax tree of a
        loaded msgpack checkpoint (``{"params", "batch_stats"}``, as
        ``utils.checkpoint.load_msgpack`` returns it), carried across by
        ``from_flax`` and fitted to the model (``fit_state``). Missing or
        extra keys raise."""
        from ..models.carry import fit_state, from_flax

        if "params" in state:
            state = from_flax(state)
        self.model.load_state_dict(fit_state(state, self.model), strict=True)
        return self._fresh_state()

    def _fresh_state(self) -> TrainState:
        params = dict(self.model.named_parameters())
        aux = {k: b for k, b in self.model.named_buffers() if b.is_floating_point()}
        opt = torch.optim.AdamW(list(params.values()), lr=self._lr(0), betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=self.weight_decay)
        return TrainState(step=0, params=params, opt_state=opt, aux=aux)

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def train_step(self, state: TrainState, batch: torch.Tensor,
                   labels: torch.Tensor):
        """One update on ``batch``/``labels`` (on the trainer's device) ->
        ``(state, loss)``; ``loss`` is a detached scalar on the device."""
        self.model.train()
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        frozen = None if self.mutable_aux else {k: b.clone() for k, b in state.aux.items()}
        loss = self.loss_fn(self.model, batch, labels)
        loss.backward()
        if frozen is not None:
            # After the backward: a frozen-statistics forward saved these
            # buffers for it, so writing them earlier would break it.
            with torch.no_grad():
                for k, b in state.aux.items():
                    b.copy_(frozen[k])
        grads = []
        for p in state.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.clip_norm is not None:
            clip_by_global_norm(grads, self.clip_norm)
        for group in opt.param_groups:
            group["lr"] = self._lr(state.step)
        opt.step()
        state.step += 1
        return state, loss.detach()


def make_trainer(
    model: nn.Module,
    device: "str | torch.device" = "cuda",
    learning_rate: Schedule = 1e-4,
    weight_decay: float = 0.05,
    loss_fn: Optional[LossFn] = None,
    clip_norm: Optional[float] = None,
    mutable_aux: bool = False,
) -> Trainer:
    """A ``Trainer`` for ``model`` on ``device`` (the card unless the caller
    asks for ``"cpu"``; without a GPU it raises).

    ``loss_fn(model, batch, labels) -> scalar`` defaults to
    ``cross_entropy_loss``. ``learning_rate`` is a number or a schedule of
    the update count. ``clip_norm`` clips the gradients' global norm first,
    as ``optax.clip_by_global_norm`` (detection fine-tunes need it: the
    TAL/BCE loss starts in the hundreds on fresh heads). ``mutable_aux``
    keeps the BatchNorm statistics the loss's forward writes, REQUIRED when
    training BatchNorm models from scratch: frozen random-init statistics
    mis-normalise every layer and the deep features degenerate to
    constants. Without it the statistics stay frozen, the stance for
    near-distribution fine-tunes of imported checkpoints."""
    dev = resolve_device(device)
    return Trainer(model=model.to(dev), device=dev, learning_rate=learning_rate,
                   weight_decay=weight_decay, loss_fn=loss_fn or cross_entropy_loss,
                   clip_norm=clip_norm, mutable_aux=mutable_aux)
