#!/usr/bin/env python3
"""The detection variants' accuracy gate (mAP50 of each variant's
detections against the classic fp step's, the tolerances of
``tools/bench_levers.py`` ``ACCURACY_TOL``) for the JAX package and the
port on the SAME weights, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_accuracy_gate.py --hw 1080x1920 --seeds 0 1 2
    JAX_PLATFORMS=cpu python tools/torch_accuracy_gate.py --hw 270x480 --frames 4

For each seed: flax initialises the engine's ``yolov8n`` (``stem_pad_c=8``)
from ``jax.random.PRNGKey(seed)`` with the class prior zeroed; the port
takes that tree through ``from_flax``. Both packages then serve each
variant by their engine's definitions: ``s2d`` folds the classic stem
(``s2d_fold_kernel``) and serves the fused letterbox, ``int8`` serves int8
weights dequantized inside the step, ``int8_act`` calibrates the int8
activation convs on the engine's warmup frames (``default_rng(0)``, 2
batches of 2 at 640²) and serves int8 weights as well. The frames are
``default_rng(7)`` uint8 noise at ``--hw``, as the bench_levers gate makes
them. ``--port-weights`` starts instead from the port's own seeded
weights (``init_params`` with ``torch.Generator().manual_seed(seed)``, the
class prior zeroed: the weights ``chip_smoke.py`` phase 15 serves) and
carries them into the JAX package (``carry.to_flax``). Both packages run bf16 on
the CPU: scores only, no timing. ``fused_letterbox`` in the output is each
package's max |fused letterbox - space_to_depth(two-pass letterbox)| on the
same frames (``tools/stem_smoke.py``'s check), and whether the port's two
planes equal the JAX package's bit for bit. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LEGS = (("classic", "", "classic"), ("s2d", "", "s2d"), ("classic", "int8", "int8"),
        ("s2d", "int8", "s2d_int8"), ("classic", "int8_act", "int8_act"))
# tools/bench_levers.py ACCURACY_TOL, copied as it is.
ACCURACY_TOL = {"s2d": 0.95, "s2d_int8": 0.80, "int8": 0.80, "int8_act": 0.60}


def noise_frames(n: int, hw: tuple):
    import numpy as np

    return np.random.default_rng(7).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)


def score(dets: dict) -> dict:
    """mAP50 of every gated leg against the classic leg's detections."""
    from video_edge_ai_proxy_tpu_torch.models.metrics import DetectionEvaluator

    out = {}
    for leg in ACCURACY_TOL:
        ev = DetectionEvaluator()
        for (gb, _, gc), (pb, ps, pc) in zip(dets["classic"], dets[leg]):
            ev.add_image(pb, ps, pc, gb, gc)
        out[leg] = round(ev.summarize()["mAP50"], 4)
    return {"gt_detections": int(sum(len(b) for b, _, _ in dets["classic"])),
            "mAP50": out, "below": sorted(k for k, m in out.items() if m < ACCURACY_TOL[k])}


def jax_init(seed: int):
    import jax
    import jax.numpy as jnp

    from video_edge_ai_proxy_tpu.models import registry
    from video_edge_ai_proxy_tpu.replay.checksum import zero_class_prior

    spec = registry.get("yolov8n")
    model = spec.build()
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, spec.input_size, spec.input_size, 3), jnp.bfloat16))
    return jax.device_get(zero_class_prior(variables))


def jax_detections(variables, frames) -> dict:
    """The JAX package's legs, as its engine serves them
    (``_variant_spec``, ``_maybe_calibrate``, ``_maybe_quantize``)."""
    import jax
    import numpy as np

    from video_edge_ai_proxy_tpu.engine.runner import build_serving_step
    from video_edge_ai_proxy_tpu.models import registry
    from video_edge_ai_proxy_tpu.models.import_weights import s2d_fold_kernel
    from video_edge_ai_proxy_tpu.models.quantize import (
        calibrate_serving, dequantize_tree, quantize_tree,
    )

    spec = registry.get("yolov8n")
    base = spec.build()
    dets = {}
    for stem, quantize, leg in LEGS:
        model = base.clone(cfg=dataclasses.replace(
            base.cfg, stem=stem, act_int8=quantize == "int8_act"))
        v = copy.deepcopy(variables)
        if stem == "s2d":
            k = np.asarray(v["params"]["stem"]["conv"]["kernel"])
            v["params"]["stem"]["conv"]["kernel"] = s2d_fold_kernel(k[:, :, :3, :])
        if quantize == "int8_act":
            rng = np.random.default_rng(0)
            s = spec.input_size
            v = calibrate_serving(model, spec, v, [
                rng.integers(0, 256, (2, s, s, 3), np.uint8) for _ in range(2)])
        step = build_serving_step(model, spec)
        if quantize:
            v = quantize_tree(v)
            fp_step = step

            def step(qv, frames_u8, _fp=fp_step):
                return _fp(dequantize_tree(qv), frames_u8)

        out = jax.device_get(jax.jit(step)(v, frames))
        dets[leg] = [(out["boxes"][i][out["valid"][i].astype(bool)],
                      out["scores"][i][out["valid"][i].astype(bool)],
                      out["classes"][i][out["valid"][i].astype(bool)])
                     for i in range(len(frames))]
    return dets


def port_detections(model, frames) -> dict:
    """The port's legs through its engine (``EngineConfig(stem, quantize)``)."""
    import torch

    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    x = torch.from_numpy(frames)
    dets = {}
    for stem, quantize, leg in LEGS:
        engine = InferenceEngine(MemoryFrameBus(), EngineConfig(stem=stem, quantize=quantize),
                                 device="cpu", model=copy.deepcopy(model))
        engine.warmup()
        with torch.inference_mode():
            out = build_serving_step(engine._model, engine._spec)(x)
        valid = out["valid"]
        dets[leg] = [(out["boxes"][i][valid[i]].float().numpy(),
                      out["scores"][i][valid[i]].float().numpy(),
                      out["classes"][i][valid[i]].numpy()) for i in range(len(frames))]
    return dets


def fused_letterbox(frames, dst: int = 640, chunk: int = 4) -> dict:
    """Both packages' max |fused - space_to_depth(two-pass)| on ``frames``
    (bf16, ``chunk`` frames a call), and whether the port's planes equal
    the JAX package's."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from video_edge_ai_proxy_tpu.ops import preprocess as jpre
    from video_edge_ai_proxy_tpu_torch.ops import preprocess as tpre

    jax_diff = port_diff = 0.0
    equal = True
    for lo in range(0, len(frames), chunk):
        f = frames[lo:lo + chunk]
        jf = np.asarray(jpre.preprocess_letterbox_fused(jnp.asarray(f), dst)[0], np.float32)
        jt = np.asarray(jpre.space_to_depth(jpre.preprocess_letterbox(jnp.asarray(f), dst)[0]),
                        np.float32)
        x = torch.from_numpy(f)
        tf = tpre.preprocess_letterbox_fused(x, dst)[0].float().numpy()
        tt = tpre.space_to_depth(tpre.preprocess_letterbox(x, dst)[0]).float().numpy()
        jax_diff = max(jax_diff, float(np.abs(jf - jt).max()))
        port_diff = max(port_diff, float(np.abs(tf - tt).max()))
        equal = equal and np.array_equal(tf, jf) and np.array_equal(tt, jt)
    return {"jax": jax_diff, "port": port_diff, "port_equals_jax": bool(equal)}


def port_model(seed: int, variables=None):
    import torch

    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.models.carry import from_flax
    from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior

    spec = registry.get("yolov8n")
    model = spec.init_params(torch.Generator().manual_seed(seed), device="cpu")
    if variables is not None:
        model.load_state_dict(from_flax(variables), strict=True)
    else:
        model.load_state_dict(zero_class_prior(model.state_dict()))
    return model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--hw", default="1080x1920", help="source geometry HxW")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--port-weights", action="store_true",
                    help="start from the port's seeded weights (default: flax's)")
    args = ap.parse_args(argv)
    hw = tuple(int(v) for v in args.hw.split("x"))
    sys.path.insert(0, ROOT)
    frames = noise_frames(args.frames, hw)
    out = {"tool": "torch_accuracy_gate", "hw": list(hw), "n_frames": args.frames,
           "weights": "port" if args.port_weights else "jax",
           "tolerance": ACCURACY_TOL, "seeds": {}}
    import jax

    jax.config.update("jax_platforms", "cpu")
    out["fused_letterbox"] = fused_letterbox(frames)
    for seed in args.seeds:
        if args.port_weights:
            model = port_model(seed)
            from video_edge_ai_proxy_tpu_torch.models.carry import to_flax

            variables = to_flax(model.state_dict())
        else:
            variables = jax_init(seed)
            model = port_model(seed, variables)
        row = {"jax": score(jax_detections(variables, frames)),
               "port": score(port_detections(model, frames))}
        out["seeds"][seed] = row
        print(json.dumps({"seed": seed, **row}), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
