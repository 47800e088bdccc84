"""Training step on one card (counterpart of ``video_edge_ai_proxy_tpu/parallel/train.py``).

``make_trainer(model)`` returns a ``Trainer`` whose ``train_step`` computes
what the JAX package's jitted ``step_fn`` computes: the loss and its
gradients with respect to every parameter, optional global-norm clipping
(``optax.clip_by_global_norm``), then AdamW (``optax.adamw``: b1 0.9,
b2 0.999, eps 1e-8 outside the square root, decoupled weight decay on
every parameter), with a learning rate that may be a schedule of the
update count (from 0 at the first update, as optax counts).

Differences of form, not of result:
- The parameters live in the model (``TrainState.params`` names them) and
  the optimizer state in a ``torch.optim.AdamW``; ``train_step`` updates
  both in place and returns the state. The JAX step donates its state, so
  the old one is gone there too.
- No mesh: one device. Data, tensor and sequence parallelism, the
  mixture-of-experts auxiliary losses (``AUX_LOSS_WEIGHT`` weighs them in
  JAX), and ``mutable_aux`` (BatchNorm statistics, for detection
  training) are not ported yet and raise.

A parameter the loss does not reach gets a zero gradient, as under
``jax.grad``, so weight decay and the moments still move it.
"""

from __future__ import annotations

from dataclasses import dataclass
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


@dataclass
class Trainer:
    """Owns the model on its device, the optimizer settings and the step."""

    model: nn.Module
    device: torch.device
    learning_rate: Schedule
    weight_decay: float
    loss_fn: LossFn
    clip_norm: Optional[float] = None

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """Fresh random weights (the model's ``init_weights`` from the CPU
        ``generator``; default seed 0) and a fresh optimizer."""
        with torch.no_grad():
            self.model.init_weights(generator or torch.Generator().manual_seed(0))
        return self._fresh_state()

    def init_state_from(self, state_dict) -> TrainState:
        """The fine-tune entry point: load ``state_dict`` (an imported or
        previously trained checkpoint, any dtype; missing or extra keys
        raise) and start a fresh optimizer."""
        self.model.load_state_dict(state_dict, strict=True)
        return self._fresh_state()

    def _fresh_state(self) -> TrainState:
        params = dict(self.model.named_parameters())
        opt = torch.optim.AdamW(list(params.values()), lr=self._lr(0), betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=self.weight_decay)
        return TrainState(step=0, params=params, opt_state=opt)

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
        loss = self.loss_fn(self.model, batch, labels)
        loss.backward()
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
    as ``optax.clip_by_global_norm``. ``mutable_aux`` and models with
    BatchNorm statistics (detection training) are not ported yet."""
    dev = resolve_device(device)
    if mutable_aux:
        raise NotImplementedError("mutable_aux (BatchNorm statistics carried through "
                                  "training) is not ported yet")
    if any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in model.modules()):
        raise NotImplementedError("training a model with BatchNorm statistics is not "
                                  "ported yet")
    return Trainer(model=model.to(dev), device=dev, learning_rate=learning_rate,
                   weight_decay=weight_decay, loss_fn=loss_fn or cross_entropy_loss,
                   clip_norm=clip_norm)
