"""K5's f32 kernel (`csrc/reid_block.cu`, namespace `ffma`) against variants of its own source, on this card.

    python -m vehicle_counting_tpu_torch.benchmarks.micro.reid_block_variants [--device cuda|cpu] [--n 3840 3960] [--reps 10]

A variant is the committed source with the textual edits of VARIANTS,
each of which must match exactly once. It is built with `_build`'s nvcc
flags into build/variants/ and called through the same C entry. At each N
the committed kernel and the variants run on the same inputs in turns
(all of them forward, then in reverse), CUDA events over `reps`
back-to-back launches. Each variant's output must equal the committed
kernel's bit for bit: no edit changes the order of any output's sums.
Then the SM clock and power are sampled (nvidia-smi) while the committed
kernel runs back to back for 4 s. Prints one JSON line. It is the tool
for asking what the kernel's tiling and loop order cost: add an entry to
VARIANTS. `chip_smoke.py` checks the kernel's results.

On `--device cpu` it only applies the edits: a check that VARIANTS still
fits the source, not a measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import threading
import time

_FMA = """#pragma unroll
          for (int s = 0; s < SEG; ++s)
#pragma unroll
            for (int j = 0; j < PX; ++j)
#pragma unroll
              for (int k = 0; k < CO; ++k) acc[s][j][k] = fmaf(v[s][j + dx], wv[k], acc[s][j][k]);"""
_FMA_CHANNEL_OUTER = """#pragma unroll
          for (int k = 0; k < CO; ++k)
#pragma unroll
            for (int s = 0; s < SEG; ++s)
#pragma unroll
              for (int j = 0; j < PX; ++j) acc[s][j][k] = fmaf(v[s][j + dx], wv[k], acc[s][j][k]);"""

VARIANTS = {
    # one 5-pixel segment per thread: 16 warps of 80 accumulators
    "seg1": [("constexpr int SEG = 2;", "constexpr int SEG = 1;")],
    # the input-channel loop unrolled twice
    "unroll2": [("#pragma unroll 1\n    for (int ci = 0; ci < CK;", "#pragma unroll 2\n    for (int ci = 0; ci < CK;")],
    # output channel outermost: the operand reuse cache holds the weight, not the window value
    "channel_outer": [(_FMA, _FMA_CHANNEL_OUTER)],
}


def variant_sources() -> dict:
    """{name: source} of every variant; raises if an edit does not match
    the committed source exactly once."""
    from vehicle_counting_tpu_torch import _build

    with open(os.path.join(_build.CSRC_DIR, "reid_block.cu")) as f:
        src = f.read()
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: its edit matches {text.count(old)} times in csrc/reid_block.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build_variants(sources):
    """Build every variant with one nvcc each, all at once -> {name: (C entry, ptxas report)}."""
    from vehicle_counting_tpu_torch import _build

    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = os.path.join(out_dir, f"reid_block_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libreid_block_{name}.so")
        procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", lib, src],
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err}")
        fn = ctypes.CDLL(lib).vct_reid_block64
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        report, kernel = [], None
        for ln in err.splitlines():
            if "Compiling entry function" in ln:
                kernel = "f32" if "reid_block_f32" in ln else "bf16"
            elif kernel == "f32" and ("Used" in ln or "spill" in ln):
                report.append(ln.split("ptxas info    :")[-1].strip())
        built[name] = (fn, report)
    return built


def _clocks(run, seconds=4.0):
    """nvidia-smi's SM clock, its maximum and the power drawn, every 0.2 s while `run()` repeats."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
            samples.append(q)
            time.sleep(0.2)

    th = threading.Thread(target=sample)
    th.start()
    try:
        t0 = time.time()
        while time.time() - t0 < seconds:
            run()
    finally:
        stop.set()
        th.join()
    return samples


def main(device="cuda", ns=(3840, 3960), reps=10) -> dict:
    import numpy as np
    import torch

    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.models.convert import reid_block64_from_jax
    from vehicle_counting_tpu_torch.ops import reid_block
    from vehicle_counting_tpu_torch.testing import reid_block_params
    from vehicle_counting_tpu_torch.utils.device import card_line, require_device

    dev = require_device(device)
    sources = variant_sources()
    if dev.type != "cuda":
        res = {"device": str(dev), "variants": sorted(sources)}
        print(json.dumps({"reid_block_variants": res}))
        return res
    built = _build_variants(sources)
    rng = np.random.default_rng(5)
    ops = reid_block64_from_jax(*reid_block_params(rng), dev)
    wk = reid_block.pack_weights_f32(ops["w1"], ops["w2"])
    ab = torch.stack([ops["a1"], ops["b1"], ops["a2"], ops["b2"]]).float().contiguous()
    stream = _build.current_stream(dev)

    def runner(name, x):
        if name == "kernel":
            return lambda: reid_block._launch_kernel(x, wk, ab)

        def run():
            out = torch.empty_like(x)
            _build.check(built[name][0](x.data_ptr(), wk.data_ptr(), ab.data_ptr(), out.data_ptr(), x.shape[0], 0, stream),
                         f"variant {name}")
            return out
        return run

    def ms(fn):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps

    names = ["kernel", *sources]
    res = {"card": card_line(), "reps": reps, "ptxas": {n: built[n][1] for n in sources}, "ms": {}}
    for n in ns:
        x = torch.from_numpy(np.maximum(rng.standard_normal((n, 64, 25, 25)), 0).astype(np.float32)).to(dev)
        want = runner("kernel", x)()
        for name in sources:
            if not torch.equal(runner(name, x)(), want):
                raise AssertionError(f"variant {name} at N={n}: output differs from the committed kernel's")
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(ms(runner(name, x)))
        res["ms"][n] = times
        print(f"K5 f32 N={n}, ms per launch in turns (bitwise equal outputs): "
              f"{ {k: [round(v, 4) for v in t] for k, t in times.items()} } [{res['card']}]", flush=True)
    x = torch.from_numpy(np.maximum(rng.standard_normal((ns[0], 64, 25, 25)), 0).astype(np.float32)).to(dev)
    kernel = runner("kernel", x)

    def burst():
        for _ in range(20):
            kernel()
        torch.cuda.synchronize(dev)

    res["clocks_sm_max_power"] = _clocks(burst)
    print(f"while the kernel runs back to back: {res['clocks_sm_max_power']}")
    print(json.dumps({"reid_block_variants": res}))
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' only applies the edits")
    ap.add_argument("--n", type=int, nargs="+", default=[3840, 3960], help="crops per launch")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    main(args.device, tuple(args.n), args.reps)
