"""PyTorch/CUDA port of the video edge AI proxy's inference and training planes.

The JAX package ``video_edge_ai_proxy_tpu`` stays the reference; this
package mirrors its layout and names (``ops/``, ``models/``, ``engine/``,
``bus/``, ``utils/``) so each module has an obvious counterpart, and is
written in PyTorch idiom: NCHW ``nn.Module``s (channels_last memory on the
card), plain functions on tensors, explicit ``device`` arguments and
explicit ``torch.Generator``s.

It imports ``torch`` and numpy only, never ``jax``, ``flax`` or any module
of the JAX package. Every TPU kernel of the JAX package (the NMS keep mask
of detection serving; the flash-attention forward of long-clip serving and
its two backward kernels of training) is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use (``kernels/build.py``).
``parallel/train.py`` ports ``make_trainer`` for one card.

Entry points default to ``device="cuda"`` and raise when no GPU is present
unless the caller asked for ``device="cpu"`` (``device.py``).
"""
