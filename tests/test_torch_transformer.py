"""The port's transformer family against the JAX package's, on the CPU.

``Encoder``, ``tiny_vit`` and ``tiny_videomae`` in float32 on both sides,
to RTOL = ATOL = 2e-4, each twice: with the default attention, and with
``attn_fn=flash_attention`` on both sides (the JAX one runs the Pallas
kernel in interpret mode, the port's its plain packed forward), so the
flash route of the slice is covered here. Weights are flax's init, with
every bias, LayerNorm term and embedding randomised from a numpy seed so
a swapped mapping shows, carried across by ``models/carry.py``.

The weight mapping is also held at full width: ``videomae_b_long`` and
``vit_b16`` load strictly from zero arrays of the shapes
``jax.eval_shape`` gives, leaf for leaf.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.models import transformer as jtr
from video_edge_ai_proxy_tpu.models import videomae as jvmae
from video_edge_ai_proxy_tpu.models import vit as jvit
from video_edge_ai_proxy_tpu.ops import flash_attention as jfa
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models import transformer as ttr
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax, load_flax
from video_edge_ai_proxy_tpu_torch.models.videomae import (
    VideoMAE, VideoMAEConfig, tiny_videomae_config,
)
from video_edge_ai_proxy_tpu_torch.models.vit import ViT, ViTConfig, tiny_vit_config
from video_edge_ai_proxy_tpu_torch.ops.flash_attention import flash_attention

TOL = 2e-4
TINY_ENC = dict(num_layers=2, dim=64, num_heads=4, mlp_dim=128)

ROUTES = {"dense": (None, None), "flash": (jfa.flash_attention, flash_attention)}


def _randomized(variables, seed):
    """flax variables -> numpy tree: kernels keep flax's init; biases,
    LayerNorm terms, pos_embed and cls_token are drawn from a numpy seed."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        arr = np.asarray(node, np.float32)
        if path[-1] == "scale":
            return rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
        if path[-1] in ("bias", "pos_embed", "cls_token"):
            return rng.normal(0.0, 0.2, arr.shape).astype(np.float32)
        return arr
    return walk(fnn.meta.unbox(variables), ())


def _init(jmodel, x):
    return jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))


@pytest.mark.parametrize("route", ["dense", "flash"])
@pytest.mark.parametrize("scale", [1.0, 1e-3], ids=["unit", "tiny-variance"])
def test_encoder_matches(route, scale):
    """The tiny-variance input makes LayerNorm's epsilon (flax 1e-6, torch
    1e-5 by default) show in the output."""
    jattn, tattn = ROUTES[route]
    x = (np.random.default_rng(1).normal(0, 1, (2, 20, 64)) * scale).astype(np.float32)
    cfg_j = jtr.EncoderConfig(**TINY_ENC)
    jmodel = jtr.Encoder(cfg_j, dtype=jnp.float32, attn_fn=jattn)
    variables = _randomized(_init(jmodel, x), 2)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    tmodel = ttr.Encoder(ttr.EncoderConfig(**TINY_ENC), torch.float32, attn_fn=tattn)
    load_flax(tmodel, variables).eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("route", ["dense", "flash"])
def test_tiny_vit_matches(route):
    jattn, tattn = ROUTES[route]
    x = np.random.default_rng(3).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jmodel = jvit.ViT(jvit.tiny_vit_config(), dtype=jnp.float32, attn_fn=jattn)
    variables = _randomized(_init(jmodel, x), 4)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    tmodel = load_flax(ViT(tiny_vit_config(), torch.float32, attn_fn=tattn), variables).eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("route", ["dense", "flash"])
def test_tiny_videomae_matches(route):
    jattn, tattn = ROUTES[route]
    x = np.random.default_rng(5).normal(0, 1, (2, 4, 32, 32, 3)).astype(np.float32)
    jmodel = jvmae.VideoMAE(jvmae.tiny_videomae_config(), dtype=jnp.float32, attn_fn=jattn)
    variables = _randomized(_init(jmodel, x), 6)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    tmodel = load_flax(VideoMAE(tiny_videomae_config(), torch.float32, attn_fn=tattn),
                       variables).eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_tubelet_tokens_follow_flax_order():
    """Token n of the tubelet embedding is flax's token n: (t', h', w')
    order of the channels-last conv output."""
    x = np.random.default_rng(7).normal(0, 1, (1, 4, 32, 32, 3)).astype(np.float32)
    jembed = jvmae.TubeletEmbed(64, 8, 2, dtype=jnp.float32)
    variables = _randomized(_init(jembed, x), 8)
    want = np.asarray(jembed.apply(variables, jnp.asarray(x)))
    tmodel = VideoMAE(tiny_videomae_config(), torch.float32)
    sd = from_flax({"params": {"tubelet": variables["params"]}})
    tmodel.tubelet.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tmodel.tubelet(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 32, 64)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _flax_zeros(jmodel, shape):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct(shape, jnp.float32))
    shapes = fnn.meta.unbox(shapes)
    return shapes, jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.mark.parametrize("name,jbuild,shape", [
    ("videomae_b_long", lambda: jvmae.VideoMAE(jvmae.VideoMAEConfig(num_frames=64)),
     (1, 64, 224, 224, 3)),
    ("vit_b16", lambda: jvit.ViT(jvit.ViTConfig()), (1, 224, 224, 3)),
])
def test_full_width_layout_loads_strictly(name, jbuild, shape):
    """Every flax leaf (shapes from tracing init, no forward is run) maps
    onto a port parameter of the same shape, with no key left over on
    either side, and the parameter counts agree."""
    shapes, zeros = _flax_zeros(jbuild(), shape)
    tmodel = registry.get(name).build(torch.float32)
    sd = from_flax(zeros)
    assert set(sd) == set(tmodel.state_dict())
    load_flax(tmodel, zeros)
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_flax == sum(p.numel() for p in tmodel.parameters())


def test_configs_compare_equal_to_jax():
    for jc, tc in ((jvmae.VideoMAEConfig(num_frames=64), VideoMAEConfig(num_frames=64)),
                   (jvmae.tiny_videomae_config(), tiny_videomae_config()),
                   (jvit.ViTConfig(), ViTConfig()), (jvit.tiny_vit_config(), tiny_vit_config())):
        enc_j, enc_t = jc.encoder, tc.encoder
        assert {f: getattr(enc_j, f) for f in enc_j.__dataclass_fields__} == \
               {f: getattr(enc_t, f) for f in enc_t.__dataclass_fields__}
        for f in jc.__dataclass_fields__:
            if f != "encoder":
                assert getattr(jc, f) == getattr(tc, f), f
    assert VideoMAEConfig(num_frames=64).num_tokens == 6272
    assert ttr.FLASH_THRESHOLD_T == jtr.FLASH_THRESHOLD_T == 1024


def test_mapping_of_the_transformer_leaves():
    x = np.zeros((1, 32, 32, 3), np.float32)
    variables = _randomized(_init(jvit.ViT(jvit.tiny_vit_config(), dtype=jnp.float32), x), 9)
    p = variables["params"]
    sd = from_flax(variables)
    np.testing.assert_array_equal(sd["encoder.block1.attn.qkv.weight"].numpy(),
                                  p["encoder"]["block1"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(sd["encoder.ln_final.weight"].numpy(),
                                  p["encoder"]["ln_final"]["scale"])
    np.testing.assert_array_equal(sd["patch_embed.weight"].numpy(),
                                  p["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["cls_token"].numpy(), p["cls_token"])
    with pytest.raises(KeyError, match="unmapped"):
        from_flax({"params": {"encoder": {"ln1": {"kernel": np.zeros((2, 2), np.float32)}}}})
    with pytest.raises(KeyError, match="unmapped"):
        from_flax({"params": {"register_token": np.zeros((1, 1, 4), np.float32)}})


def test_auto_attention_threshold():
    q, k, v = (torch.from_numpy(x) for x in
               np.random.default_rng(10).normal(0, 1, (3, 1, 1024, 2, 16)).astype(np.float32))
    np.testing.assert_allclose(ttr.auto_attention(q, k, v).numpy(),
                               flash_attention(q, k, v).numpy(), rtol=0, atol=0)
    short = [x[:, :1023] for x in (q, k, v)]
    assert torch.equal(ttr.auto_attention(*short), ttr.default_attention(*short))


def test_default_attention_rounds_like_jax_in_bf16():
    q, k, v = np.random.default_rng(11).normal(0, 1, (3, 2, 12, 2, 16)).astype(np.float32)
    want = np.asarray(jtr.default_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))),
                      np.float32)
    got = ttr.default_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    # Both round the logits and the probabilities to bf16: within two bf16
    # ulps of the unit-scale outputs.
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * 2.0 ** -8)


def test_mixture_of_experts_is_not_ported():
    with pytest.raises(NotImplementedError):
        ttr.Encoder(ttr.EncoderConfig(num_experts=4, **TINY_ENC), torch.float32)


@pytest.mark.parametrize("name", ["tiny_vit", "tiny_videomae"])
def test_registry_init_params_is_seeded(name):
    spec = registry.get(name)
    a = spec.init_params(torch.Generator().manual_seed(5), device="cpu", dtype=torch.float32)
    b = spec.init_params(torch.Generator().manual_seed(5), device="cpu", dtype=torch.float32)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    qkv = a.encoder.block0.attn.qkv.weight.detach()
    assert float(qkv.abs().max()) <= (6.0 / (64 + 192)) ** 0.5        # xavier-uniform
    assert float(a.encoder.block0.attn.qkv.bias.detach().abs().sum()) == 0.0
    assert abs(float(a.pos_embed.detach().std()) - 0.02) < 0.004
    assert not a.training
    bf = spec.init_params(torch.Generator().manual_seed(5), device="cpu")
    assert bf.encoder.block0.mlp.fc1.weight.dtype == torch.bfloat16
    assert bf.encoder.ln_final.weight.dtype == torch.float32
    assert bf.pos_embed.dtype == torch.float32
