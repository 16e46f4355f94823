"""Fixed cost of a minimal kernel call on this card (K7, `ops/noop.py`).

    python -m vehicle_counting_tpu_torch.benchmarks.micro.noop_launch [--device cuda|cpu]

Counterpart of the JAX package's `benchmarks/micro/noop_launch.py`: `xs`
[256, 64, 128] f32, one program = 256 sequential iterations of
`acc += noop(x).sum()`, best of 5 turns of 4 programs, printed as us/iter
for the hand-written kernel ("cuda noop") and for `(x + 1.0).sum()`
("torch equiv"). The JAX probe times the calls inside one compiled
program. The card has two counterparts of that, and both are printed:

  eager  the loop as Python launches it, kernel by kernel: what the port's
         tracker does today, so this is the cost its small kernels pay;
  graph  the 256 iterations captured once in a CUDA graph and replayed:
         what a launch costs once the host is out of the way.

"bare" is the same kernel launched with n = 0 through `ctypes` alone, no
allocation and no torch op beside it: the floor of the route every kernel
of this package takes. Each iteration of the two programs is three device
kernels (the add, the sum, the accumulate), a bare launch is one.

On `--device cpu` the wrapper takes its plain version and there is no
graph and no bare launch: a functional check, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import time

N = 256
TURNS, PROGRAMS = 5, 4


def _best_us_per_iter(program, sync, iters=N):
    """Best of TURNS turns of PROGRAMS programs and one sync, in us/iter."""
    program()
    sync()
    best = float("inf")
    for _ in range(TURNS):
        t0 = time.perf_counter()
        for _ in range(PROGRAMS):
            program()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best / PROGRAMS / iters * 1e6


def main(device="cuda") -> dict:
    import torch

    from vehicle_counting_tpu_torch.ops import noop
    from vehicle_counting_tpu_torch.utils.device import card_line, require_device

    dev = require_device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    xs = list(torch.zeros((N, 64, 128), dtype=torch.float32, device=dev).unbind(0))
    acc = torch.zeros((), dtype=torch.float32, device=dev)  # static: the graphs update it in place
    want = float(N * 64 * 128)

    def body(fn):
        def program():
            acc.zero_()
            for x in xs:
                acc.add_(fn(x).sum())
        return program

    programs = {"cuda noop": body(noop.noop_add1), "torch equiv": body(noop.noop_add1_plain)}
    res = {"card": card_line() if on_card else "cpu", "device": str(dev), "iters": N}
    launches0 = noop.noop_add1.launches
    replays = dict.fromkeys(programs, 0)  # graph replays, counted where they are made
    for name, program in programs.items():
        key = name.replace(" ", "_")
        res[f"{key}_eager_us"] = _best_us_per_iter(program, sync)
        if float(acc) != want:
            raise AssertionError(f"{name}: eager program summed {float(acc)}, expected {want}")
        if on_card:
            # warm up on a side stream, capture one program, replay it
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                program()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                program()
            def replay():
                graph.replay()
                replays[name] += 1

            res[f"{key}_graph_us"] = _best_us_per_iter(replay, sync)
            if float(acc) != want:
                raise AssertionError(f"{name}: graph replay summed {float(acc)}, expected {want}")
        else:
            res[f"{key}_graph_us"] = None
    if on_card:
        launch = noop.bare_launcher(xs[0])

        def bare():
            for _ in range(N):
                launch()

        res["bare_launch_us"] = _best_us_per_iter(bare, sync)
    else:
        res["bare_launch_us"] = None
    # launches this call made through the wrapper: a capture counts once and
    # a replay not at all, so the kernel also ran N times in every replay
    res["wrapper_launches"] = noop.noop_add1.launches - launches0
    res["graph_replayed_launches"] = replays["cuda noop"] * N

    def fmt(v):
        return "   n/a " if v is None else f"{v:7.2f}"

    for name in programs:
        key = name.replace(" ", "_")
        print(f"{name}: eager {fmt(res[key + '_eager_us'])} us/iter, graph {fmt(res[key + '_graph_us'])} us/iter")
    print(f"bare launch (n=0, ctypes only): {fmt(res['bare_launch_us'])} us/launch")
    print(json.dumps({"noop_launch": res}))
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' for a functional check")
    main(ap.parse_args().device)
