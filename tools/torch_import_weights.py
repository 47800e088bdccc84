"""Convert a torch-layout checkpoint into a msgpack the port's engine serves
(the port's counterpart of ``tools/import_weights.py``, same flags).

Usage:
    python tools/torch_import_weights.py --model yolov8n \\
        --src yolov8n_state.npz --out /var/lib/vep/yolov8n.msgpack

Then serve it (conf.yaml):
    engine:
      model: yolov8n
      checkpoint_path: /var/lib/vep/yolov8n.msgpack

Accepted sources (all offline): ``.npz``, ``.safetensors``, torch
``.pt``/``.pth`` (loaded ``weights_only``). The key layouts per model family
are in ``video_edge_ai_proxy_tpu_torch/models/import_weights.py``;
conversion is strictly accounted, so an unmapped or leftover tensor aborts
with the full list. The msgpack holds the flax ``{"params",
"batch_stats"}`` tree (``carry.to_flax``), the file the JAX package's
importer writes for the same source.

``--validate`` runs the serving step once on a zero batch and prints an
output checksum (``--device``: ``cuda`` by default, ``cpu`` on request).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--model", required=True,
                    help="registry model name (e.g. yolov8n, resnet50, vit_b16)")
    ap.add_argument("--src", required=True,
                    help="source checkpoint (.npz/.safetensors/.pt/.pth)")
    ap.add_argument("--out", required=True,
                    help="output msgpack path (engine.checkpoint_path)")
    ap.add_argument("--validate", action="store_true",
                    help="run the serving step on zeros and print a checksum")
    ap.add_argument("--device", default="cuda", help="device of --validate")
    args = ap.parse_args(argv)

    from video_edge_ai_proxy_tpu_torch.models import import_weights as iw
    from video_edge_ai_proxy_tpu_torch.models.carry import to_flax
    from video_edge_ai_proxy_tpu_torch.utils.checkpoint import save_msgpack

    state = iw.load_state_dict(args.src)
    print(f"loaded {len(state)} tensors from {args.src}", file=sys.stderr)
    ported = iw.convert(args.model, state)
    variables = to_flax(ported)
    save_msgpack(args.out, variables)
    n_params = sum(int(v.size) for v in _leaves(variables.get("params", {})))
    result = {"model": args.model, "out": args.out, "params": n_params}

    if args.validate:
        import numpy as np
        import torch

        from video_edge_ai_proxy_tpu_torch.engine.runner import build_serving_step
        from video_edge_ai_proxy_tpu_torch.models import registry

        spec = registry.get(args.model)
        model = spec.init_params(device=args.device)
        model.load_state_dict(ported, strict=True)
        step = build_serving_step(model, spec)
        s = spec.input_size
        shape = (1, spec.clip_len, s, s, 3) if spec.clip_len else (1, s, s, 3)
        out = step(torch.zeros(shape, dtype=torch.uint8, device=model_device(model)))
        result["validate_checksum"] = float(
            sum(float(np.abs(v.float().cpu().numpy()).sum()) for v in out.values()))
    print(json.dumps(result))
    return 0


def model_device(model):
    return next(model.parameters()).device


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
