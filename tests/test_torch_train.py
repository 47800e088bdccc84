"""The port's ``make_trainer`` against the JAX package's, on the CPU.

``tiny_vit`` and ``tiny_videomae`` in float32, flash attention forced on
both sides through ``attn_fn`` (JAX: the Pallas kernels in interpret mode
with 8-row blocks; the port: ``flash_attention``, its plain versions on
the CPU), one flax init carried across by ``from_flax``. The JAX trainer
runs on a one-device CPU mesh. Compared:

- the loss and every gradient of step 1, within 2e-4;
- the losses of 3 steps, within 2e-4;
- the parameters after each step. The first Adam update of an entry is
  lr * g / (|g| + 1e-8), about +-lr whatever |g|, so an entry whose
  gradient is within float32 noise of zero may move the other way on the
  other side. The bar: within 2e-4 wherever |g| >= 1e-6 (far above the
  noise of these gradients), within 2 * lr + 2e-4 elsewhere.

Also: AdamW and global-norm clipping against optax directly, a learning
rate schedule, bf16 compute over float32 parameters, dropout, remat, and
the refusals of ``make_trainer``.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_edge_ai_proxy_tpu.models import videomae as jvmae
from video_edge_ai_proxy_tpu.models import vit as jvit
from video_edge_ai_proxy_tpu.ops import flash_attention as jfa
from video_edge_ai_proxy_tpu.parallel import train as jtrain
from video_edge_ai_proxy_tpu.parallel.mesh import single_device_mesh
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax
from video_edge_ai_proxy_tpu_torch.models.transformer import Encoder, EncoderConfig
from video_edge_ai_proxy_tpu_torch.models.videomae import VideoMAE, tiny_videomae_config
from video_edge_ai_proxy_tpu_torch.models.vit import ViT, tiny_vit_config
from video_edge_ai_proxy_tpu_torch.ops.flash_attention import flash_attention
from video_edge_ai_proxy_tpu_torch.parallel import (
    clip_by_global_norm, cross_entropy_loss, global_norm, make_trainer,
)

TOL = 2e-4
G_NOISE = 1e-6
LR = 1e-3
JFLASH = functools.partial(jfa.flash_attention, block_q=8, block_k=8, interpret=True)


def _randomized(variables, seed):
    """flax variables -> numpy tree: kernels keep flax's init; biases,
    LayerNorm terms and embeddings are drawn from a numpy seed."""
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


def _case(name):
    """(JAX model, port model, variables, batch, labels) in float32."""
    rng = np.random.default_rng(11)
    if name == "tiny_vit":
        jmodel = jvit.ViT(jvit.tiny_vit_config(), dtype=jnp.float32, attn_fn=JFLASH)
        tmodel = ViT(tiny_vit_config(), torch.float32, attn_fn=flash_attention)
        x, n_cls = rng.normal(0, 1, (4, 32, 32, 3)), 10
    else:
        jmodel = jvmae.VideoMAE(jvmae.tiny_videomae_config(), dtype=jnp.float32, attn_fn=JFLASH)
        tmodel = VideoMAE(tiny_videomae_config(), torch.float32, attn_fn=flash_attention)
        x, n_cls = rng.normal(0, 1, (3, 4, 32, 32, 3)), 5
    x = x.astype(np.float32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    labels = rng.integers(0, n_cls, x.shape[0]).astype(np.int32)
    return jmodel, tmodel, _randomized(variables, 12), x, labels


def _run_jax(jmodel, variables, x, y, steps, **kw):
    mesh = single_device_mesh()
    trainer = jtrain.make_trainer(jmodel, mesh, **kw)
    losses, params = [], []
    with mesh:
        state = trainer.init_state_from(variables)
        for _ in range(steps):
            state, loss = trainer.train_step(state, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
            params.append(from_flax({"params": jax.device_get(state.params)}))
    return losses, params


def _run_port(tmodel, variables, x, y, steps, **kw):
    trainer = make_trainer(tmodel, device="cpu", **kw)
    state = trainer.init_state_from(from_flax(variables))
    losses, params, grads = [], [], []
    for _ in range(steps):
        state, loss = trainer.train_step(state, torch.from_numpy(x),
                                         torch.from_numpy(y.astype(np.int64)))
        losses.append(float(loss))
        params.append({k: p.detach().clone() for k, p in state.params.items()})
        grads.append({k: p.grad.clone() for k, p in state.params.items()})
    assert state.step == steps
    return losses, params, grads


def _assert_params_close(got, want, grads, lr):
    assert set(got) == set(want)
    for name, p in got.items():
        diff = (p - want[name]).abs()
        moving = grads[name].abs() >= G_NOISE
        assert float(torch.where(moving, diff, 0.0).max()) <= TOL, name
        assert float(diff.max()) <= 2 * lr + TOL, name


@pytest.mark.parametrize("name", ["tiny_vit", "tiny_videomae"])
def test_train_step_matches_jax(name):
    jmodel, tmodel, variables, x, y = _case(name)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtrain.cross_entropy_loss(jmodel, p, None, jnp.asarray(x), jnp.asarray(y))
    )(variables["params"])
    want_grads = from_flax({"params": jax.device_get(jgrads)})
    j_losses, j_params = _run_jax(jmodel, variables, x, y, 3, learning_rate=LR)
    t_losses, t_params, t_grads = _run_port(tmodel, variables, x, y, 3, learning_rate=LR)

    np.testing.assert_allclose(t_losses[0], float(jloss), rtol=TOL, atol=TOL)
    assert set(t_grads[0]) == set(want_grads)
    for key, g in t_grads[0].items():
        np.testing.assert_allclose(g.numpy(), want_grads[key].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=key)
    assert sum(float(g.abs().sum()) for g in t_grads[0].values()) > 0.0
    np.testing.assert_allclose(t_losses, j_losses, rtol=TOL, atol=TOL)
    _assert_params_close(t_params[0], j_params[0], t_grads[0], LR)


def test_clipped_step_matches_jax():
    """clip_norm far below the gradients' norm, so every step is clipped."""
    jmodel, tmodel, variables, x, y = _case("tiny_vit")
    j_losses, j_params = _run_jax(jmodel, variables, x, y, 2, learning_rate=LR, clip_norm=0.05)
    t_losses, t_params, t_grads = _run_port(tmodel, variables, x, y, 2, learning_rate=LR,
                                            clip_norm=0.05)
    norm = float(global_norm(t_grads[0].values()))
    np.testing.assert_allclose(norm, 0.05, rtol=1e-5)        # the grads were clipped
    np.testing.assert_allclose(t_losses, j_losses, rtol=TOL, atol=TOL)
    _assert_params_close(t_params[0], j_params[0], t_grads[0], LR)


def test_learning_rate_schedule_counts_updates_from_zero():
    jmodel, tmodel, variables, x, y = _case("tiny_vit")
    start = {k: v.clone() for k, v in from_flax(variables).items()}
    schedule = lambda count: LR * count                        # noqa: E731
    j_losses, j_params = _run_jax(jmodel, variables, x, y, 2, learning_rate=schedule)
    t_losses, t_params, t_grads = _run_port(tmodel, variables, x, y, 2, learning_rate=schedule)
    for k, p in t_params[0].items():                           # lr(0) = 0: nothing moves
        assert torch.equal(p, start[k]), k
    np.testing.assert_allclose(t_losses, j_losses, rtol=TOL, atol=TOL)
    _assert_params_close(t_params[1], j_params[1], t_grads[1], LR)


def test_adamw_matches_optax():
    rng = np.random.default_rng(0)
    params = [rng.normal(0, 1, s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.normal(0, 1e-2, p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    tx = optax.adamw(3e-3, weight_decay=0.05)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = torch.optim.AdamW(tp, lr=3e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.05)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(a) for a in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    for p, want in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "below"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(1)
    grads = [rng.normal(0, 1, s).astype(np.float32) for s in ((4, 6), (9,))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    if max_norm > float(norm):
        assert all(np.array_equal(g.numpy(), a) for g, a in zip(got, grads))


def test_bf16_compute_over_f32_params_trains():
    spec = registry.get("tiny_vit")
    model = spec.init_params(torch.Generator().manual_seed(1), device="cpu",
                             dtype=torch.bfloat16, param_dtype=torch.float32)
    assert model.encoder.block0.attn.qkv.weight.dtype == torch.float32
    assert model.patch_embed.weight.dtype == torch.float32
    trainer = make_trainer(model, device="cpu", learning_rate=3e-3)
    state = trainer.init_state(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 8))
    losses = []
    for _ in range(5):
        state, loss = trainer.train_step(state, x, y)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in state.params.values())
    # The trained float32 weights load into the registry's bf16 serving model.
    serving = spec.init_params(device="cpu")
    serving.load_state_dict(model.state_dict(), strict=True)
    with torch.inference_mode():
        assert serving(x[:2]).shape == (2, 10)


def test_init_state_is_seeded():
    models = [ViT(tiny_vit_config(), torch.float32) for _ in range(2)]
    states = [make_trainer(m, device="cpu").init_state(torch.Generator().manual_seed(4))
              for m in models]
    for (ka, a), (kb, b) in zip(states[0].params.items(), states[1].params.items()):
        assert ka == kb and torch.equal(a, b)
    assert states[0].step == 0


def test_unreached_parameters_still_decay():
    """The JAX gradient of a parameter the loss never reads is zero, and
    AdamW still decays it; the port gives such a parameter a zero grad."""
    model = ViT(tiny_vit_config(), torch.float32)
    trainer = make_trainer(model, device="cpu", learning_rate=LR, weight_decay=0.05,
                           loss_fn=lambda m, x, y: m.encoder(x).float().square().mean())
    state = trainer.init_state(torch.Generator().manual_seed(5))
    before = model.classifier.weight.detach().clone()
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (2, 5, 64)).astype(np.float32))
    trainer.train_step(state, x, torch.zeros(2, dtype=torch.int64))
    assert torch.equal(model.classifier.weight.grad, torch.zeros_like(before))
    np.testing.assert_allclose(model.classifier.weight.detach().numpy(),
                               (before * (1 - LR * 0.05)).numpy(), rtol=1e-6, atol=1e-7)


def test_remat_changes_no_result():
    cfg = dict(num_layers=2, dim=32, num_heads=2, mlp_dim=64)
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (2, 9, 32)).astype(np.float32))
    results = []
    for remat in (False, True):
        enc = Encoder(EncoderConfig(remat=remat, **cfg), torch.float32, attn_fn=flash_attention)
        enc.load_state_dict(results[0][2] if results else enc.state_dict())
        out = enc(x)
        out.square().sum().backward()
        results.append((out.detach(), [p.grad for p in enc.parameters()], enc.state_dict()))
    assert torch.equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_dropout_acts_in_train_mode_only():
    enc = Encoder(EncoderConfig(num_layers=1, dim=32, num_heads=2, mlp_dim=64, dropout=0.5),
                  torch.float32)
    x = torch.from_numpy(np.random.default_rng(8).normal(0, 1, (2, 9, 32)).astype(np.float32))
    enc.eval()
    assert torch.equal(enc(x), enc(x))
    torch.manual_seed(0)
    enc.train()
    assert not torch.equal(enc(x), enc.eval()(x))
    still = Encoder(EncoderConfig(num_layers=1, dim=32, num_heads=2, mlp_dim=64),
                    torch.float32).train()
    assert torch.equal(still(x), still.eval()(x))


def test_cross_entropy_is_the_mean_over_the_batch():
    model = ViT(tiny_vit_config(), torch.float32)
    model.init_weights(torch.Generator().manual_seed(9))
    x = torch.from_numpy(np.random.default_rng(9).normal(0, 1, (3, 32, 32, 3)).astype(np.float32))
    y = torch.tensor([1, 2, 3])
    want = -torch.log_softmax(model(x), -1)[torch.arange(3), y].mean()
    with torch.no_grad():
        got = float(cross_entropy_loss(model, x, y))
    np.testing.assert_allclose(got, float(want.detach()), rtol=1e-6)


def test_make_trainer_refusals():
    from video_edge_ai_proxy_tpu_torch.models.yolov8 import YOLOv8, tiny_yolov8_config

    model = ViT(tiny_vit_config(), torch.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_trainer(model)
    assert make_trainer(model, device="cpu").device.type == "cpu"
    # Detection training is ported (mutable_aux, BatchNorm statistics,
    # float32 detector weights); a model of one dtype and the int8
    # activation path still refuse.
    assert make_trainer(YOLOv8(tiny_yolov8_config(), torch.float32), device="cpu",
                        mutable_aux=True).mutable_aux
    with pytest.raises(NotImplementedError):
        registry.get("tiny_resnet").init_params(device="cpu", param_dtype=torch.float32)
    from video_edge_ai_proxy_tpu_torch.models.common import ConvBN, batch_statistics

    conv = ConvBN(3, 8, dtype=torch.float32, act_int8=True)
    with batch_statistics(conv), pytest.raises(NotImplementedError):
        conv(torch.zeros(1, 3, 8, 8))
