#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's detection serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure raises and the script
exits non-zero:

1. the card: ``torch.cuda.is_available()`` or exit 1; ``nvidia-smi`` name
   and power limit;
2. build every CUDA kernel from ``video_edge_ai_proxy_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card (bit-identical
   keep masks on random boxes with duplicates, zero-area boxes, all-zero
   slots and class-offset boxes, B = 16, K = 256 and K = 1024);
4. the slice at full width: ``yolov8n`` at 640 in bf16 with seeded random
   weights and the zeroed class prior, on 16x1080x1920 uint8 frames with
   ``quality_thumb=32`` -- shapes, finiteness, ``valid.sum() > 0``, the same
   detections with the plain keep mask swapped in, float32 agreement of
   the model and preprocessing with the CPU on two frames, step time
   (median of 20), the kernel's own time on the step's candidates, peak
   memory, and a profile of where a step's device time goes;
5. the engine answers requests: ``InferenceEngine(device="cuda")`` over a
   ``MemoryFrameBus`` of 16 streams at 1080p; every stream must get
   results. The kernels' launch counts are set to 0 just before this run
   and read just after it; each kernel must have launched.

The line before the last is one JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``. Longer output (the
profile table) goes to ``chiprun_out/chip_smoke_profile.txt``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per IoU pair of the keep mask: 4 min/max + 2 sub for the
# intersection sides, 2 clamps, 1 mul, 1 add + 1 sub for the union, 1 clamp,
# 1 div, 1 compare. Greedy NMS needs only the pairs j > i: K(K-1)/2 per image.
NMS_OPS_PER_PAIR = 14

# Kinds of device work in a step's profile, by substrings of kernel names
# (the first kind that matches wins).
KERNEL_KINDS = (
    ("nms_keep_mask", ("nms_keep_mask",)),
    ("convolution", ("fprop", "convolve", "cutlass")),
    ("batchnorm", ("bn_fw",)),
    ("dtype copy", ("copy_kernel",)),
    ("matmul", ("gemv", "gemm", "nvjet")),
    ("memcpy", ("Memcpy",)),
    ("cat", ("CatArray",)),
    ("silu", ("silu",)),
)

N_STREAMS = 16
FRAME_HW = (1080, 1920)
THUMB = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out[0].strip()


def time_events(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` between two CUDA events (after a warmup
    call): the device's time when the host keeps ahead, the host's launch
    rate when it does not."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, iters: int, name_part: str):
    """Mean device ms per call of the kernels whose name contains
    ``name_part``, from torch.profiler; None when the profiler saw no
    device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in device_events(prof) if name_part in e.name)
    return total_us / 1000.0 / iters if total_us > 0 else None


def device_events(prof):
    """The kernels (and device copies) a torch.profiler run recorded."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def nms_boxes(gen, b: int, k: int, device):
    """Random score-sorted candidate boxes with the edge cases of the main
    path: duplicates, zero-area boxes, all-zero (filtered) slots and
    class-offset boxes."""
    import torch

    from video_edge_ai_proxy_tpu_torch.ops.nms import _CLASS_OFFSET

    xy = torch.rand((b, k, 2), generator=gen) * 600
    wh = torch.rand((b, k, 2), generator=gen) * 200 + 1
    boxes = torch.cat([xy, xy + wh], dim=-1)
    boxes[:, 1::7] = boxes[:, 0:1]                           # duplicates
    boxes[:, 3::11, 2] = boxes[:, 3::11, 0]                  # zero width
    boxes[:, -k // 8:] = 0.0                                 # filtered slots
    cls = torch.randint(0, 80, (b, k, 1), generator=gen).float()
    boxes = boxes + cls * _CLASS_OFFSET
    boxes[:, -k // 8:] = 0.0
    return boxes.to(device)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.device import resolve_device
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
    from video_edge_ai_proxy_tpu_torch.kernels import build
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.models.carry import zero_class_prior
    from video_edge_ai_proxy_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_reference
    from video_edge_ai_proxy_tpu_torch.ops.preprocess import frame_quality_stats, preprocess_letterbox
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    # Every kernel of the path: its wrapper (which counts launches) and
    # where it comes from.
    kernels = {
        "nms_keep_mask": {
            "route": "cuda",
            "source": "video_edge_ai_proxy_tpu_torch/" + build.SOURCES["nms_keep_mask"],
            "replaces": "video_edge_ai_proxy_tpu/ops/nms.py:68",
            "wrapper": nms_keep_mask_cuda,
        },
    }
    report = {name: {} for name in kernels}

    # -- phase 1: the card ------------------------------------------------
    dev = resolve_device("cuda")
    card = card_line()
    log(card)
    log(f"phase 1 card: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all(list(kernels))
    log(f"phase 2 build: {len(kernels)} kernel(s), {len(logs)} built now, in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        ptxas = [ln.strip() for ln in text.splitlines() if "ptxas" in ln and
                 ("registers" in ln or "spill" in ln or "smem" in ln)]
        log(f"phase 2 {name}: " + " | ".join(ptxas))

    # -- phase 3: each kernel against its plain version ---------------------
    gen = torch.Generator().manual_seed(0)
    worst = 0
    for b, k in ((16, 256), (4, 1024), (2, 100)):
        boxes = nms_boxes(gen, b, k, dev)
        got = nms_keep_mask_cuda(boxes, 0.45)
        torch.cuda.synchronize()
        want = nms_keep_mask_reference(boxes, 0.45)
        err = int((got.int() - want.int()).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"keep-mask kernel differs from its plain version at "
                                 f"B={b} K={k}: {int((got != want).sum())} of {got.numel()}")
        log(f"phase 3 nms_keep_mask B={b} K={k}: bit-identical to the plain version "
            f"(kept {int(got.sum())} of {got.numel()})")

    # -- phase 4: the slice at full width -------------------------------------
    spec = registry.get("yolov8n")
    model = spec.init_params(torch.Generator().manual_seed(0), device=dev)
    model.load_state_dict(zero_class_prior(model.state_dict()))
    fgen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randint(0, 256, (N_STREAMS,) + FRAME_HW + (3,), generator=fgen,
                           dtype=torch.uint8, device=dev)
    captured = []

    def recording_keep_mask(boxes, t):
        captured.append((boxes.clone(), t))
        return nms_keep_mask(boxes, t)

    step = build_serving_step(model, spec, quality_thumb=THUMB)
    for _ in range(3):
        step(frames)
    torch.cuda.synchronize()
    for spec_k in kernels.values():
        spec_k["wrapper"].launches = 0
    out = step(frames)
    torch.cuda.synchronize()
    step_launches = {n: kernels[n]["wrapper"].launches for n in kernels}
    if step_launches["nms_keep_mask"] != 1:
        raise AssertionError(f"one serving step launched the keep-mask kernel "
                             f"{step_launches['nms_keep_mask']} times, expected 1")
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    want_shapes = {"boxes": (16, 100, 4), "scores": (16, 100), "classes": (16, 100),
                   "valid": (16, 100), "quality_stats": (16, 3),
                   "quality_thumbs": (16, THUMB, THUMB)}
    if shapes != want_shapes:
        raise AssertionError(f"output shapes {shapes} != {want_shapes}")
    for key in ("boxes", "scores", "quality_stats", "quality_thumbs"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"non-finite values in {key}")
    n_valid = int(out["valid"].sum())
    if n_valid <= 0:
        raise AssertionError("no detections: NMS did no work")
    log(f"phase 4 step: shapes ok, finite, {n_valid} detections over {N_STREAMS} frames, "
        f"keep-mask launches per step = {step_launches['nms_keep_mask']}")

    ref_step = build_serving_step(model, spec, quality_thumb=THUMB,
                                  keep_mask=nms_keep_mask_reference)
    ref = ref_step(frames)
    for key in ("boxes", "scores", "classes", "valid"):
        if not torch.equal(out[key], ref[key]):
            raise AssertionError(f"step with the kernel differs from the step with the "
                                 f"plain keep mask in {key}")
    log("phase 4 step with the plain keep mask swapped in: identical detections")

    # float32 on the card (TF32 off) against float32 on the CPU, full width,
    # on two frames: preprocessing, the raw head outputs of every level
    # (box DFL logits and class logits) and the decoded boxes. Tolerances:
    # the two run the same function through different convolution
    # algorithms, so sums differ in order; 1e-3 on logits and 1e-2 px on
    # boxes in a 640-px frame are far above that noise and far below any
    # real difference. (Class ids are not compared: with random weights the
    # top two class logits of an anchor are often closer than the noise.)
    m32 = spec.init_params(torch.Generator().manual_seed(0), device=dev, dtype=torch.float32)
    m32_cpu = spec.init_params(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    two = frames[:2]
    with torch.inference_mode():
        x_gpu, _ = preprocess_letterbox(two, 640, out_dtype=torch.float32)
        x_cpu, _ = preprocess_letterbox(two.cpu(), 640, out_dtype=torch.float32)
        pre_err = float((x_gpu.cpu() - x_cpu).abs().max())
        head_gpu = m32(x_gpu.permute(0, 3, 1, 2), decode=False)
        head_cpu = m32_cpu(x_cpu.permute(0, 3, 1, 2), decode=False)
        logit_err = max(float((g.cpu() - c).abs().max())
                        for lg, lc in zip(head_gpu, head_cpu) for g, c in zip(lg, lc))
        b_gpu, _ = m32(x_gpu.permute(0, 3, 1, 2), decode=True)
        b_cpu, _ = m32_cpu(x_cpu.permute(0, 3, 1, 2), decode=True)
        s_gpu, _ = frame_quality_stats(two, torch.zeros((2, THUMB, THUMB), device=dev),
                                       (THUMB, THUMB))
        s_cpu, _ = frame_quality_stats(two.cpu(), torch.zeros((2, THUMB, THUMB)),
                                       (THUMB, THUMB))
    box_err = float((b_gpu.cpu() - b_cpu).abs().max())
    stat_err = float((s_gpu.cpu() - s_cpu).abs().max())
    log(f"phase 4 f32 card vs CPU (yolov8n, 2 frames): preprocess {pre_err:.3g}, "
        f"head logits {logit_err:.3g}, boxes {box_err:.3g} px, quality stats {stat_err:.3g}")
    if not (pre_err <= 1e-4 and logit_err <= 1e-3 and box_err <= 1e-2 and stat_err <= 1e-4):
        raise AssertionError("float32 on the card disagrees with float32 on the CPU")
    del m32, m32_cpu

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(5):
        step(frames)
    torch.cuda.synchronize()
    for _ in range(20):
        t0 = time.perf_counter()
        step(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    step_ms = statistics.median(times)
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"phase 4 timing on {card}: yolov8n bf16 640, batch {N_STREAMS}x1080x1920 uint8: "
        f"median {step_ms:.3f} ms/batch over 20 (min {min(times):.3f}, max {max(times):.3f}), "
        f"{N_STREAMS * 1000.0 / step_ms:.1f} frames/s, peak memory {peak_mib:.1f} MiB")

    # The kernel's own time, on the candidates the main path gave it.
    cap_step = build_serving_step(model, spec, quality_thumb=THUMB,
                                  keep_mask=recording_keep_mask)
    cap_step(frames)
    cand, thresh = captured[-1]
    got = nms_keep_mask_cuda(cand, thresh)
    want = nms_keep_mask_reference(cand, thresh)
    worst = max(worst, int((got.int() - want.int()).abs().max()))
    if not torch.equal(got, want):
        raise AssertionError("keep-mask kernel differs from its plain version on the "
                             "main path's candidates")
    b_, k_ = cand.shape[0], cand.shape[1]
    ev_ms = time_events(lambda: nms_keep_mask_cuda(cand, thresh), 200)
    prof_ms = profiled_device_ms(lambda: nms_keep_mask_cuda(cand, thresh), 50,
                                 "nms_keep_mask")
    plain_ms = time_events(lambda: nms_keep_mask_reference(cand, thresh), 10)
    bound_bytes_ms = (b_ * k_ * 16 + b_ * k_) / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = b_ * (k_ * (k_ - 1) // 2) * NMS_OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    kernel_ms = prof_ms if prof_ms is not None else ev_ms
    log(f"phase 4 nms_keep_mask on {card}: B={b_} K={k_}: device {prof_ms} ms/launch "
        f"(profiler), {ev_ms:.5f} ms/launch (CUDA events, 200 back to back), plain "
        f"version {plain_ms:.4f} ms; bound {max(bound_bytes_ms, bound_ops_ms):.3g} ms "
        f"(bytes {bound_bytes_ms:.3g}, operations {bound_ops_ms:.3g})")
    report["nms_keep_mask"].update(
        max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=max(bound_bytes_ms, bound_ops_ms),
        bound_by="bytes" if bound_bytes_ms > bound_ops_ms else "operations",
        library_ms=None,   # no single PyTorch call computes a greedy keep mask
    )

    # Where a step's device time goes: every kernel (and device copy) the
    # profiler saw in 3 steps, grouped by name.
    from torch.profiler import ProfilerActivity, profile

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            step(frames)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in device_events(prof):
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.device_time_total, n + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    dev_ms = sum(us for us, _ in by_name.values()) / n_prof / 1000.0
    launches_per_step = sum(n for _, n in by_name.values()) / n_prof
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_profile.txt"), "w") as fh:
        fh.write(f"{card}\nyolov8n bf16 serving step, {N_STREAMS}x1080x1920 uint8, "
                 f"{n_prof} steps profiled; step {step_ms:.3f} ms wall, {dev_ms:.3f} ms "
                 f"device, {launches_per_step:.0f} device launches per step\n"
                 f"ms/step  launches/step  kernel\n")
        for name, (us, n) in rows:
            fh.write(f"{us / n_prof / 1000.0:8.4f}  {n / n_prof:6.1f}  {name[:200]}\n")
        fh.write("\n" + prof.key_averages().table(sort_by="device_time_total", row_limit=40))
    log(f"phase 4 profile: device busy {dev_ms:.3f} ms per step over "
        f"{launches_per_step:.0f} device launches (the step took {step_ms:.3f} ms wall); "
        f"per-kernel table in chiprun_out/chip_smoke_profile.txt")
    for name, (us, n) in rows[:5]:
        log(f"phase 4 profile kernel: {us / n_prof / 1000.0:.4f} ms/step x{n / n_prof:.0f} "
            f"{name[:90]}")
    kinds: dict = {}
    for name, (us, n) in rows:
        kind = next((k for k, parts in KERNEL_KINDS if any(p in name for p in parts)), "other")
        k_us, k_n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (k_us + us, k_n + n)
    log("phase 4 profile by kind (ms/step, launches/step): " + ", ".join(
        f"{k} {us / n_prof / 1000.0:.4f} ({n / n_prof:.0f})"
        for k, (us, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])))

    # -- phase 5: the engine answers requests ---------------------------------
    bus = MemoryFrameBus()
    streams = [f"cam{i:02d}" for i in range(N_STREAMS)]
    for s in streams:
        bus.create_stream(s, FRAME_HW[0] * FRAME_HW[1] * 3)
    pool = frames[:4].cpu().numpy()
    engine = InferenceEngine(bus, EngineConfig(), device="cuda", model=model)
    results = engine.subscribe()
    got_results: dict = {}

    def consume():
        for r in results:
            got_results.setdefault(r.device_id, []).append(r)

    reader = threading.Thread(target=consume, daemon=True)
    reader.start()
    engine.warmup()
    for spec_k in kernels.values():
        spec_k["wrapper"].launches = 0
    engine.start()
    try:
        for packet in range(1, 5):
            for i, s in enumerate(streams):
                bus.publish(s, pool[(i + packet) % len(pool)],
                            FrameMeta(width=FRAME_HW[1], height=FRAME_HW[0], packet=packet,
                                      timestamp_ms=int(time.time() * 1000)))
            deadline = time.monotonic() + 60
            while any(engine.stats().get(s) is None or engine.stats()[s].frames < packet
                      for s in streams):
                if time.monotonic() > deadline:
                    raise AssertionError(f"engine did not serve tick {packet} within 60 s")
                time.sleep(0.005)
    finally:
        engine.stop()
    launches = {n: kernels[n]["wrapper"].launches for n in kernels}
    reader.join(10)
    if reader.is_alive():
        raise AssertionError("result subscriber did not end")
    missing = [s for s in streams if not got_results.get(s)]
    if missing:
        raise AssertionError(f"streams without results: {missing}")
    for s in streams:
        for r in got_results[s]:
            if not (0 <= len(r.detections) <= 100 and r.batch_size >= 1):
                raise AssertionError(f"bad result for {s}: {r}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        report[name]["launches"] = n
    n_res = sum(len(v) for v in got_results.values())
    n_det = sum(len(r.detections) for v in got_results.values() for r in v)
    log(f"phase 5 engine: {N_STREAMS} streams at 1080p, {n_res} results, {n_det} detections, "
        f"every stream served; kernel launches {launches}")

    line = {"kernels": []}
    for name, meta in kernels.items():
        r = report[name]
        line["kernels"].append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
