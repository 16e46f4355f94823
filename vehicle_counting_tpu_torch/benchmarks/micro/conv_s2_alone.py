"""The layer-1 conv kernel (K6, `ops/conv_s2.py`) alone on this card.

    python -m vehicle_counting_tpu_torch.benchmarks.micro.conv_s2_alone [--device cuda|cpu] [--shape B H W]

Times the bf16 kernel by itself at [128, 192, 320, 32] (the main path's
layer-1 input): weights packed once outside the timed region, LAUNCHES
launches between two CUDA events, best of TURNS turns, beside a device copy
that moves as many bytes. It is the tool for asking what bounds the kernel:
run it from a copy of the checkout whose `csrc/conv_s2.cu` has its stores
or its `cp.async` copies switched off (results are then wrong, times are
not) and compare. `chip_smoke.py` checks the kernel's results.

On `--device cpu` the plain version runs once at a small shape: a
functional check, not a measurement.
"""

from __future__ import annotations

import argparse
import json

LAUNCHES, TURNS = 20, 3


def main(device="cuda", shape=(128, 192, 320)) -> dict:
    import torch

    from vehicle_counting_tpu_torch.ops import conv_s2
    from vehicle_counting_tpu_torch.utils.device import card_line, require_device

    dev = require_device(device)
    on_card = dev.type == "cuda"
    b, h, w = shape if on_card else (1, 32, 64)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, h, w, conv_s2.CIN), generator=gen).to(torch.bfloat16).to(dev)
    wt = (torch.randn((3, 3, conv_s2.CIN, conv_s2.COUT), generator=gen) * 0.05).to(dev)
    bias = torch.randn(conv_s2.COUT, generator=gen).to(dev)
    res = {"card": card_line() if on_card else "cpu", "device": str(dev), "shape": [b, h, w, conv_s2.CIN]}
    if not on_card:
        out = conv_s2.conv1_s2_silu(x, wt, bias)
        res.update(kernel_ms=None, copy_ms=None, finite=bool(torch.isfinite(out.float()).all()))
        print(json.dumps({"conv_s2_alone": res}))
        return res

    def best_ms(fn):
        fn()
        start, end, best = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), float("inf")
        for _ in range(TURNS):
            start.record()
            for _ in range(LAUNCHES):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            best = min(best, start.elapsed_time(end) / LAUNCHES)
        return best

    packed = conv_s2.pack_conv1_weights(wt)
    out = conv_s2._launch_kernel(x, packed, bias)
    moved = sum(t.numel() * t.element_size() for t in (x, out, packed, bias))
    src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    res["kernel_ms"] = best_ms(lambda: conv_s2._launch_kernel(x, packed, bias))
    res["copy_ms"] = best_ms(lambda: dst.copy_(src))
    res["moved_mb"] = moved / 1e6
    print(f"K6 bf16 {res['shape']} kernel alone {res['kernel_ms']:.4f} ms; a device copy of the same "
          f"{res['moved_mb']:.1f} MB {res['copy_ms']:.4f} ms [{res['card']}]")
    print(json.dumps({"conv_s2_alone": res}))
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' for a functional check")
    ap.add_argument("--shape", type=int, nargs=3, default=(128, 192, 320), metavar=("B", "H", "W"))
    args = ap.parse_args()
    main(args.device, tuple(args.shape))
