"""The port's VideoMAE pretraining path against the JAX package's, on the CPU.

- ``tubelet_pixels`` equal exactly.
- ``masked_pretrain_loss`` and its gradients for ``tiny_videomae`` in
  float32 (flash attention forced in the encoder on both sides: the JAX
  Pallas kernels in interpret mode, the port's ``flash_attention``), with
  the whole JAX pretraining tree ``{"encoder", "decoder"}`` carried across
  by ``models/carry.py``, within 2e-4.
- A JAX pretraining tree, tiny and at ``videomae_b_long``'s full width,
  loads strictly into ``VideoMAEPretrain``.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.models import videomae as jvmae
from video_edge_ai_proxy_tpu.ops import flash_attention as jfa
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax_pretrain, load_flax_pretrain
from video_edge_ai_proxy_tpu_torch.models.videomae import (
    VideoMAEConfig, VideoMAEPretrain, masked_pretrain_loss, tiny_videomae_config,
    tube_keep_mask, tubelet_pixels,
)
from video_edge_ai_proxy_tpu_torch.ops.flash_attention import flash_attention
from video_edge_ai_proxy_tpu_torch.parallel import make_trainer

TOL = 2e-4
JFLASH = functools.partial(jfa.flash_attention, block_q=8, block_k=8, interpret=True)


def _randomized(tree, seed):
    """Kernels keep flax's init; biases, LayerNorm terms and embeddings are
    drawn from a numpy seed, so a swapped mapping shows."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        arr = np.asarray(node, np.float32)
        if path[-1] == "scale":
            return rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
        if path[-1] in ("bias", "pos_embed", "dec_pos"):
            return rng.normal(0.0, 0.2, arr.shape).astype(np.float32)
        return arr
    return walk(fnn.meta.unbox(tree), ())


def _pretrain_tree(jmodel, jdec, clips, keep):
    enc_init = functools.partial(jmodel.init, method=jvmae.VideoMAE.encode_visible)
    enc = jax.jit(enc_init)(jax.random.PRNGKey(0), clips, keep)
    tokens = jmodel.apply(enc, clips, keep, method=jvmae.VideoMAE.encode_visible)
    dec = jax.jit(jdec.init)(jax.random.PRNGKey(1), tokens)
    return {"encoder": enc, "decoder": dec}


def test_tubelet_pixels_equal_exactly():
    cfg = tiny_videomae_config()
    clips = np.arange(2 * 4 * 32 * 32 * 3, dtype=np.float32).reshape(2, 4, 32, 32, 3)
    want = np.asarray(jvmae.tubelet_pixels(jnp.asarray(clips), jvmae.tiny_videomae_config()))
    got = tubelet_pixels(torch.from_numpy(clips), cfg)
    assert got.shape == (2, cfg.num_tokens, cfg.pixels_per_token)
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_pretrain_loss_and_gradients_match_jax():
    cfg = tiny_videomae_config()
    rng = np.random.default_rng(0)
    clips = rng.normal(0, 1, (2, 4, 32, 32, 3)).astype(np.float32)
    keep = tube_keep_mask(2, cfg, 0.75, torch.Generator().manual_seed(1)).numpy()
    jmodel = jvmae.VideoMAE(jvmae.tiny_videomae_config(), dtype=jnp.float32, attn_fn=JFLASH)
    jdec = jvmae.VideoMAEDecoder(jvmae.tiny_videomae_config(), dtype=jnp.float32)
    tree = _randomized(_pretrain_tree(jmodel, jdec, jnp.asarray(clips), jnp.asarray(keep)), 2)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jvmae.masked_pretrain_loss(jmodel, jdec, p, jnp.asarray(clips),
                                             jnp.asarray(keep)))(tree)
    model = load_flax_pretrain(VideoMAEPretrain(cfg, torch.float32, attn_fn=flash_attention),
                               tree)
    loss = model(torch.from_numpy(clips), torch.from_numpy(keep))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    want = from_flax_pretrain(jax.device_get(want_grads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for key, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), rtol=TOL, atol=TOL, err_msg=key)
    assert float(got["decoder.dec_pred.weight"].abs().max()) > 0.0
    assert float(got["encoder.encoder.block0.attn.qkv.weight"].abs().max()) > 0.0


def test_pretraining_tree_loads_strictly():
    cfg = tiny_videomae_config()
    clips = jnp.ones((1, 4, 32, 32, 3), jnp.float32)
    keep = jnp.ones((1, cfg.num_tokens), bool)
    jmodel = jvmae.VideoMAE(jvmae.tiny_videomae_config(), dtype=jnp.float32)
    jdec = jvmae.VideoMAEDecoder(jvmae.tiny_videomae_config(), dtype=jnp.float32)
    tree = _randomized(_pretrain_tree(jmodel, jdec, clips, keep), 3)
    model = load_flax_pretrain(VideoMAEPretrain(cfg, torch.float32), tree)
    dec = tree["decoder"]["params"]
    np.testing.assert_array_equal(model.decoder.dec_embed.weight.detach().numpy(),
                                  dec["dec_embed"]["kernel"].T)
    np.testing.assert_array_equal(model.decoder.dec_pos.detach().numpy(), dec["dec_pos"])
    np.testing.assert_array_equal(model.decoder.decoder.ln_final.bias.detach().numpy(),
                                  dec["decoder"]["ln_final"]["bias"])
    np.testing.assert_array_equal(model.encoder.pos_embed.detach().numpy(),
                                  tree["encoder"]["params"]["pos_embed"])
    assert model.encoder.head is None
    with pytest.raises(KeyError):
        from_flax_pretrain({"encoder": tree["encoder"]})


def test_full_width_pretraining_tree_loads_strictly():
    """``videomae_b_long``'s pretraining tree (shapes from tracing init; no
    forward is run): 12 encoder blocks of 768, 4 decoder blocks of 384 with
    6 heads, leaf for leaf."""
    jcfg = jvmae.VideoMAEConfig(num_frames=64)
    jmodel, jdec = jvmae.VideoMAE(jcfg), jvmae.VideoMAEDecoder(jcfg)
    clips = jax.ShapeDtypeStruct((1, 64, 224, 224, 3), jnp.float32)
    keep = jax.ShapeDtypeStruct((1, jcfg.num_tokens), jnp.bool_)
    enc = jax.eval_shape(functools.partial(jmodel.init, method=jvmae.VideoMAE.encode_visible),
                         jax.random.PRNGKey(0), clips, keep)
    dec = jax.eval_shape(jdec.init, jax.random.PRNGKey(0),
                         jax.ShapeDtypeStruct((1, jcfg.num_tokens, 768), jnp.bfloat16))
    shapes = fnn.meta.unbox({"encoder": enc, "decoder": dec})
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = VideoMAEPretrain(VideoMAEConfig(num_frames=64), torch.float32)
    load_flax_pretrain(model, zeros)
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n_flax == sum(p.numel() for p in model.parameters())
    assert model.decoder.decoder.block0.attn.cfg.num_heads == 6


def test_tube_keep_mask():
    cfg = VideoMAEConfig(num_frames=64)
    keep = tube_keep_mask(3, cfg, 0.9, torch.Generator().manual_seed(4))
    assert keep.shape == (3, 6272) and keep.dtype == torch.bool
    per_group = keep.reshape(3, 32, 196)
    assert torch.equal(per_group, per_group[:, :1].expand_as(per_group))   # tubes
    assert per_group[:, 0].sum(-1).tolist() == [196 - round(0.9 * 196)] * 3
    assert torch.equal(keep, tube_keep_mask(3, cfg, 0.9, torch.Generator().manual_seed(4)))


def test_nothing_masked_gives_zero_loss():
    cfg = tiny_videomae_config()
    model = VideoMAEPretrain(cfg, torch.float32)
    model.init_weights(torch.Generator().manual_seed(5))
    clips = torch.randn((1, 4, 32, 32, 3), generator=torch.Generator().manual_seed(6))
    keep = torch.ones((1, cfg.num_tokens), dtype=torch.bool)
    assert masked_pretrain_loss(model.encoder, model.decoder, clips, keep).item() == 0.0


def test_trainer_runs_pretraining():
    cfg = tiny_videomae_config()
    model = VideoMAEPretrain(cfg, torch.bfloat16, param_dtype=torch.float32)
    trainer = make_trainer(model, device="cpu", learning_rate=3e-3,
                           loss_fn=lambda m, clips, keep: m(clips, keep))
    state = trainer.init_state(torch.Generator().manual_seed(7))
    clips = torch.randn((2, 4, 32, 32, 3), generator=torch.Generator().manual_seed(8))
    keep = tube_keep_mask(2, cfg, 0.75, torch.Generator().manual_seed(9))
    losses = []
    for _ in range(4):
        state, loss = trainer.train_step(state, clips, keep)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
