"""Shared transformer encoder for the ViT family (counterpart of ``video_edge_ai_proxy_tpu/models/transformer.py``).

Submodules carry the flax scope names (``block{i}``, ``attn.qkv``,
``mlp.fc1``, ``ln_final``), so ``models/carry.py`` maps a flax tree onto
them mechanically. Precision follows the JAX package: LayerNorms in
float32 with flax's epsilon 1e-6, everything else computed in the model's
``dtype``; the Dense layers keep their parameters in ``param_dtype``
(default: ``dtype``; float32 for bf16 training, as flax keeps them) and
cast them at use. GELU is the tanh approximation (flax ``nn.gelu``).

Training settings behave as in JAX: ``dropout`` drops after the MLP's
GELU in ``train()`` mode only, and ``remat`` recomputes each block in the
backward (``torch.utils.checkpoint``) instead of keeping its activations.

Attention is a pluggable ``attn_fn(q, k, v)`` over ``[B, T, H, D]``. The
default, ``auto_attention``, sends sequences of ``FLASH_THRESHOLD_T``
tokens or more to ``ops/flash_attention.py`` (the CUDA kernel on the card)
and shorter ones to ``default_attention``. The mixture-of-experts MLP
(``num_experts > 0``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from .common import Linear

# attn_fn(q, k, v) -> out, all [B, T, H, D]
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

LN_EPS = 1e-6          # flax nn.LayerNorm's default (torch's is 1e-5)


@dataclass(frozen=True)
class EncoderConfig:
    num_layers: int = 12
    dim: int = 768
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout: float = 0.0
    remat: bool = False
    # >0 replaces the dense MLP with a mixture-of-experts MLP (not ported).
    num_experts: int = 0
    moe_router: str = "soft"
    capacity_factor: float = 1.25


def default_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention over [B, T, H, D]. As in the JAX package,
    the logits come out of the product in the inputs' dtype, the softmax
    runs in float32 and the probabilities go back to ``v.dtype``."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


# Sequences this long go to the flash forward. The value is the JAX
# package's, chosen on a TPU; it has not been measured on the card yet.
FLASH_THRESHOLD_T = 1024


def auto_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense attention for short sequences, flash attention for long ones
    (the CUDA kernel on the card, its plain version on the CPU)."""
    if q.shape[1] >= FLASH_THRESHOLD_T:
        return flash_attention(q, k, v)
    return default_attention(q, k, v)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[AttnFn] = None, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn
        self.qkv = Linear(cfg.dim, 3 * cfg.dim, dtype, param_dtype)
        self.out = Linear(cfg.dim, cfg.dim, dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, t, _ = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, c.num_heads, c.dim // c.num_heads)
        q, k, v = qkv.unbind(2)
        attn = (self.attn_fn or auto_attention)(q, k, v)
        return self.out(attn.reshape(b, t, c.dim))


class Mlp(nn.Module):
    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = cfg.dropout
        self.fc1 = Linear(cfg.dim, cfg.mlp_dim, dtype, param_dtype)
        self.fc2 = Linear(cfg.mlp_dim, cfg.dim, dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.fc1(x), approximate="tanh")
        if self.dropout:
            h = F.dropout(h, self.dropout, training=self.training)
        return self.fc2(h)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[AttnFn] = None, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.num_experts:
            raise NotImplementedError("the mixture-of-experts MLP is not ported yet")
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(cfg.dim, eps=LN_EPS, dtype=torch.float32)
        self.attn = SelfAttention(cfg, dtype, attn_fn, param_dtype)
        self.ln2 = nn.LayerNorm(cfg.dim, eps=LN_EPS, dtype=torch.float32)
        self.mlp = Mlp(cfg, dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x.float()).to(self.dtype))
        return x + self.mlp(self.ln2(x.float()).to(self.dtype))


class Encoder(nn.Module):
    """``num_layers`` pre-norm blocks and a final float32 LayerNorm.

    ``cfg.dropout`` is active in ``train()`` mode only (JAX: ``deterministic
    = not train``). With ``cfg.remat`` each block runs under
    ``torch.utils.checkpoint`` whenever autograd records, so its
    activations are recomputed in the backward instead of kept (JAX wraps
    each block in ``nn.remat``); the outputs and gradients do not change."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: Optional[AttnFn] = None, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", EncoderBlock(cfg, dtype, attn_fn, param_dtype))
        self.ln_final = nn.LayerNorm(cfg.dim, eps=LN_EPS, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i in range(self.cfg.num_layers):
            block = getattr(self, f"block{i}")
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.ln_final(x.float()).to(self.dtype)


def init_encoder_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's encoder init on every Linear and LayerNorm under
    ``module``: xavier-uniform kernels, zero biases, unit LayerNorms."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                m.weight.copy_(nn.init.xavier_uniform_(w, generator=generator))
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
