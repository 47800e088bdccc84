"""Short card check of the tensor-core flash forward
(``video_edge_ai_proxy_tpu_torch/csrc/flash_attention_fwd_sm90.cu``).

    python3 tools/torch_flash_fwd_check.py      # from the repo root, on a CUDA card

Builds the bf16 tensor-core forward and the float32 forward, prints each
kernel instantiation's registers and spills and the tensor-core library's
HGMMA count per kernel, checks the fragment mapping on one tile with V = I
(where O is softmax(S)), holds the kernel to ``chip_smoke.py``'s bar
(1e-5 + 2**-7 * |O| on O, 1e-5 on LSE) against the plain version at every
head dim and at padded shapes, and times it at videomae_b_long's shape
(BH = 24, T = 6272, D = 64) by CUDA events and the profiler, in turns with
the float32 source's bf16 instantiation and beside
``scaled_dot_product_attention``. Exits 1 if any shape misses the bar."""
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from video_edge_ai_proxy_tpu_torch.kernels import build, flash  # noqa: E402
from video_edge_ai_proxy_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_reference,
)


def bar(o, want_o, lse, want_lse):
    o, want_o = o.float(), want_o.float()
    diff = (o - want_o).abs()
    tol = 1e-5 + 2.0 ** -7 * torch.maximum(o.abs(), want_o.abs())
    return (bool((diff <= tol).all()), float(diff.max()), float((diff - tol).max()),
            float((lse - want_lse).abs().max()))


def main() -> int:
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    logs = build.build_all(["flash_attention_fwd_sm90", "flash_attention_fwd"])
    print("build", time.perf_counter() - t0, flush=True)
    for n, t in logs.items():
        print(n, "; ".join(cs.ptxas_summary(t)), flush=True)
    print("HGMMA", cs.sass_hgmma_counts(build.library_path("flash_attention_fwd_sm90")), flush=True)
    dev = torch.device("cuda")

    # One tile, V = identity: O = softmax(S) exposes S's fragment mapping and P.V's.
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 64, 64), generator=g, device=dev).bfloat16()
    k = torch.randn((1, 64, 64), generator=g, device=dev).bfloat16()
    v = torch.eye(64, device=dev).bfloat16()[None].contiguous()
    o, lse = flash.flash_attention_fwd_cuda(q, k, v, 64)
    torch.cuda.synchronize()
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * 0.125
    p = torch.softmax(s, -1)
    print("one tile V=I: max|O - softmax(S)|", float((o.float() - p).abs().max()),
          "lse", float((lse[..., 0] - torch.logsumexp(s, -1)).abs().max()), flush=True)
    wo, wl = flash_attention_reference(q, k, v, 64)
    print("one tile V=I vs plain", bar(o, wo, lse, wl), flush=True)

    cases = [(1, 64, 64, 64), (1, 64, 64, 40), (2, 64, 16, 64), (2, 64, 32, 64),
             (3, 200, 32, 150), (24, 512, 64, 512), (2, 256, 16, 200), (4, 1024, 64, 1000),
             (1, 24, 16, 24), (24, 256, 64, 200), (8, 6272, 32, 6272), (8, 1568, 16, 1568),
             (24, 6272, 64, 6272)]
    ok_all = True
    for bh, tp, d, tt in cases:
        q, k, v = (torch.randn((bh, tp, d), generator=g, device=dev).bfloat16() for _ in range(3))
        o, lse = flash.flash_attention_fwd_cuda(q, k, v, tt)
        torch.cuda.synchronize()
        wo, wl = flash_attention_reference(q, k, v, tt)
        r = bar(o, wo, lse, wl)
        ok = r[0] and r[3] <= 1e-5 and bool(torch.isfinite(o.float()).all())
        ok_all &= ok
        print(f"case BH={bh} Tp={tp} D={d} true_t={tt}: ok={ok} max|dO| {r[1]:.3g} "
              f"excess {r[2]:.3g} max|dLSE| {r[3]:.3g}", flush=True)
        del q, k, v, o, lse, wo, wl

    bh, tp, d = 24, 6272, 64
    q, k, v = (torch.randn((bh, tp, d), generator=g, device=dev).bfloat16() for _ in range(3))
    # "old": the float32 source's bf16 instantiation, which the wrapper no
    # longer reaches, launched directly for an A/B inside one call.
    old = flash._launcher("flash_attention_fwd", "flash_attention_fwd_launch", 5)

    def old_fwd():
        o = torch.empty_like(q)
        lse = torch.empty((bh, tp, 1), device=dev)
        flash._launch(old, "old", (q, k, v, o, lse), q, tp)

    def new():
        return flash.flash_attention_fwd_cuda(q, k, v, tp)

    b4 = [x.view(2, 12, tp, d) for x in (q, k, v)]

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(*b4)

    for name, fn, it in (("old", old_fwd, 5), ("new", new, 50), ("new", new, 50),
                         ("old", old_fwd, 5), ("sdpa", lib, 50)):
        ms = cs.time_events(fn, it)
        print(f"time {name}: {ms:.4f} ms (CUDA events); {4 * bh * tp * tp * d / ms / 1e9:.1f} "
              f"TFLOP/s; share of 0.2444 ms bound {0.24439 / ms:.2%}", flush=True)
    print("profiler new", cs.profiled_device_ms(new, 10, "flash_fwd_kernel_wgmma"), flush=True)
    print("ALL_OK" if ok_all else "SOME_FAILED", flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
