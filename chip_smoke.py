#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (vehicle_counting_tpu_torch).

    python3 chip_smoke.py            # from the repository root, one CUDA card
    python3 chip_smoke.py --cli-ab   # only the CLI's frames/s, repeated (see cli_ab)
    python3 chip_smoke.py --kernel-ab [--root DIR]   # only the K1, K6, K7 checks of a checkout (see kernel_ab)

Phases, each fatal on failure:
  build     compile the hand-written kernels (csrc/*.cu) with nvcc, one
            process per source, all at once;
  K1        crop gather kernel vs its plain version on the card, array-equal,
            at the driven paths' shapes (B=128 planar 384x640 u8 frames):
            128 crops incl. edge, clamp, one-pixel and frame-sized boxes
            (the step's embed chunk; both routes of the kernel, staged and
            direct, must run) and stage_bench's single call over 3840
            crops; device kernels per call (exactly one) and device time;
  K1 720p   K1 on the raw-RGB path's crop source: the planar copy of 128
            raw 720x1280 frames, 3840 crops with edge, frame-sized and
            one-pixel boxes, array-equal, both routes; the copy's time and
            bound beside K1's;
  K2        association kernel (and its per-class entry K3) vs the plain
            version, bitwise on all four outputs, at C=4, K=64, max_age=30
            (random, tie, empty, steady) and as a node of a captured CUDA
            graph; ms per launch eager and as a graph node; the kernel's
            clock64 split; then past the tracker's routing gates: K = 320
            and detection keys >= 2^23 (K = 1023 where the kernel's
            registers allow 1024 threads);
  K3        the per-class entry alone on [1, 64] problems (what the scan
            mode launches), bitwise; eager and graph-node ms, bound;
  K4        batched assignment kernel vs its plain version, bitwise, on 300
            clamp-tie problems at S=64 (one launch), a [4, 64, 64] batch and
            S=256; alone and inside the batched transpose rule; its fused
            matching stage vs the plain stage on 306 masked stages (normal,
            flipped, empty, all-rejected, keys >= 2^22, K = 64 and 320);
  K5        fused ReID stage-1 block vs its plain version: bf16 at N=128
            (the embed's launch) and N=3840 (128 frames x 30), with cuDNN's
            bf16 block timed beside them, batch invariance (bitwise), f32
            at N=3840; its ptxas registers and shared memory;
  embed     the ReID embed at the main path's shapes with K5 off and on;
  K6        layer-1 conv (3x3 s2, 32->64, SiLU) vs its plain version at
            [128, 192, 320, 32] bf16, [3, 64, 128, 32] bf16 (edge tiles) and
            a small f32 shape, with the library call (F.conv2d channels-last
            + F.silu) timed beside it; the bf16 variant's ptxas registers,
            shared memory and HGMMA count;
  K7        the launch-cost probe kernel vs its plain version, array-equal,
            then the probe itself: us per launch eager and in a captured
            CUDA graph, for the kernel and the torch equivalent, and the
            bare ctypes launch;
  pipeline  the CLI main path on a synthetic 256-frame 1280x720 video:
            yolov5s random init, default config (detect_batch 128, bf16),
            a calibrated min_conf and a 4-class mapping; asserts the CSV and
            MP4 and that both of its kernels (K1, K2) were launched, K2 once
            per frame (the tracker's frame step is replayed from a CUDA
            graph); then the same run with the graph off, off and on: equal
            CSV rows, frames/s of each;
  switched  the CLI on the first 128 frames with FORCE_PALLAS_REID_BLOCK=1
            and the staged association forced: CSV and MP4 written, K1, K4
            and K5 launched; its track count beside the default run's;
  compacted K4's compacted insertion where the port still launches it: the
            staged association's stage in its compacting form, 31 stages of
            a [4, 64, 64] frame, held against the fused stage's chain;
  layer-1   K6's stand-alone path (no detector calls it, as in the JAX
            package): yolov5s layer 0 on 128 frames, then K6 as layer 1,
            held against the detector's own layer 1;
  detect-only  the CLI with --detect_only on the 256-frame video: the
            detections CSV's schema and rows, frames/s, no tracker kernel;
  raw-rgb   the CLI with thin_upload: false on 128 frames (CSV and MP4, K1
            and K2 launched), then thin and raw uploads in turns, frames/s;
  parity    one f32 step on the card vs the same step on the CPU (plain
            versions): detections and track ids equal; then the same step
            on the card through the staged route (K4) vs the K2 route:
            track ids, mask and boxes equal; then card == CPU at f32 for
            detect_only_step and the raw_rgb / letterboxed_rgb steps;
  graph     the frame graph vs the eager loop on the card over the 256-frame
            video, both association routes: every tracker state leaf and
            output bitwise-equal; the K2 / K4 kernels one replay shows in
            the card's trace against the counts the runner adds per replay;
            then `tracker_scan` at B=128 in steady state with the graph
            off / on / on / off, ms/frame;
  scan      class_mode "scan" over the same frames: graph == eager, bitwise,
            both routes; scan == batched on the track outputs; K3 launched
            C times per frame (C K3 kernels in one replay's trace), no K2;
            batched against scan ms/frame;
  stage     stage_bench at B=128 (reid bf16, chunks of 128), every stage;
  bench     bench with a short budget; its metric line is parsed;
  profile   the CLI with --profile on 128 frames, then profile_summary on
            the trace it wrote;
  weights   the CLI with --weight and a ReID checkpoint, both made from
            seeds (an ultralytics-named .pt state dict and a .t7).
Each kernel's bound (the least time the card could take: bytes over
3.35 TB/s or operations over the peak rate of their type, whichever is
larger) is computed from the checked call's inputs.
Prints the card, a kernel JSON line, and last {"ok": true, "device": ...}.
Exits non-zero without printing a result when there is no CUDA device or
the package is missing.
"""

import collections
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

SEED = 0
SRC_HW = (720, 1280)
N_FRAMES = 256
N_SWITCHED = 128
VARIANT = "yolov5s"
KERNELS = ("crops", "cascade", "assignment", "reid_block", "conv_s2", "noop")

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense bf16 tensor-core and f32 CUDA-core FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


def bound(nbytes, ops, ops_rate):
    """{"bound_ms", "bound_by"}: the larger of bytes over the memory rate
    and operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / ops_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase(name, card):
    print(f"\n== {name} == [{card}]", flush=True)


def cuda_ms(fn, n):
    """Mean ms per call over n calls after a warm-up, CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def check_k1(dev):
    """K1 against its plain version, array-equal, at both shapes the driven
    paths give it: 128 crops (a chunk of the step's embed; edge and clamp
    boxes, frame-sized and one-pixel boxes, 10 % invalid) and stage_bench's
    one call over 3840 crops (128 frames x 30 seed-3 boxes in network-input
    pixels). The 128 crops must take both routes of the kernel (band staged
    in shared memory; taps from global memory), and a call must run exactly
    one device kernel. Returns the 128-crop numbers with the 3840-crop ones
    under "d3840"."""
    import torch

    from vehicle_counting_tpu_torch.benchmarks.load import crop_gather_inputs, synthetic_boxes
    from vehicle_counting_tpu_torch.ops import crops
    from vehicle_counting_tpu_torch.ops.letterbox import letterbox_params
    from vehicle_counting_tpu_torch.testing import crop_boxes

    rng = np.random.default_rng(SEED)
    b, h, w, d = 128, 384, 640, 128
    frames = torch.from_numpy(rng.integers(0, 256, (b, 3, h, w), dtype=np.uint8)).to(dev)
    boxes_np = crop_boxes(rng, d, h, w)
    fidx = torch.from_numpy(rng.integers(0, b, d).astype(np.int32)).to(dev)
    valid_np = rng.random(d) < 0.9
    boxes_np[-8:] = [[0, 0, w, h], [0, 0, w - 1, h - 1], [-1, -1, w + 1, h + 1], [0.5, 0.5, w - 0.5, h - 0.5],
                     [w - 1, h - 1, w, h], [10.7, 20.2, 11.9, 21.1], [5, 5, 5, 5], [w / 2, h / 2, w / 2 + 1, h / 2 + 1]]
    valid_np[-8:] = True
    boxes, valid = torch.from_numpy(boxes_np).to(dev), torch.from_numpy(valid_np).to(dev)
    gain, pad_x, pad_y, _, _ = letterbox_params(SRC_HW, (h, w))
    churn = torch.from_numpy(synthetic_boxes(3, b, 300, SRC_HW).astype(np.float32)).to(dev)
    fidx_s, boxes_s, valid_s = crop_gather_inputs(churn, 30, gain, pad_x, pad_y)
    band_max = crops._build.load("crops").vct_crop_gather_band_max()
    res = {}
    for args, reps in (((frames, fidx, boxes, valid), 200), ((frames, fidx_s, boxes_s, valid_s), 20)):
        _, fi, bx, ok = args
        n = bx.shape[0]
        got = crops.gather_crops_batch(*args)
        torch.cuda.synchronize()
        want = crops.gather_crops_batch_plain(*args)
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K1 kernel differs from its plain version on {n} crops: max |diff| {err}")
        if not torch.equal(crops.gather_crops_batch(frames, fi.long(), bx, ok), want):
            raise AssertionError(f"K1 kernel differs from its plain version on {n} crops with an int64 frame index")
        # which route each crop took: the kernel counts its staged crops
        staged = torch.zeros((), dtype=torch.int32, device=dev)
        if not torch.equal(crops._launch(*args, staged_count=staged), want):
            raise AssertionError(f"K1 kernel differs from its plain version on {n} crops (counted launch)")
        n_staged, n_valid = int(staged), int(ok.sum())
        if n == d and not 0 < n_staged < n_valid:
            raise AssertionError(f"K1: {n_staged} of {n_valid} valid crops staged: both routes must run")
        ev = device_events(lambda: crops.gather_crops_batch(*args))
        if len(ev) != 1 or "crop_gather" not in ev[0][0]:
            raise AssertionError(f"K1: a call must run exactly one device kernel, the trace shows {ev}")
        # plain, kernel, kernel, plain
        t_plain = cuda_ms(lambda: crops.gather_crops_batch_plain(*args), 5)
        t_k = cuda_ms(lambda: crops.gather_crops_batch(*args), reps)
        t_k2 = cuda_ms(lambda: crops.gather_crops_batch(*args), reps)
        t_plain2 = cuda_ms(lambda: crops.gather_crops_batch_plain(*args), 5)
        # bytes this call's crops need: each valid crop's source pixels (u8, 3
        # planes) once, the boxes, indices and mask, and the f32 output; the
        # bilinear mix is 8 taps * 2 flops per output value
        x1, y1, x2, y2 = (v[ok].long() for v in crops.crop_boxes_to_bounds(bx, h, w))
        src = int((3 * torch.clamp(x2 - x1 + 1, min=1) * torch.clamp(y2 - y1 + 1, min=1)).sum())
        bd = bound(src + nbytes(bx, fi, ok, got), 16 * got.numel(), F32_FLOPS)
        print(f"K1 array-equal over {n} crops (int32 and int64 frame index); {n_staged} of {n_valid} valid crops "
              f"staged in shared memory (band <= {band_max} B), {n_valid - n_staged} direct; wrapper "
              f"{t_k:.4f}/{t_k2:.4f} ms, plain {t_plain:.4f}/{t_plain2:.4f} ms; one call = {len(ev)} device kernel, "
              f"device time {ev[0][1]:.4f} ms (torch.profiler); bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
        res[n] = {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2), **bd, "library_ms": None,
                  "device_ms": ev[0][1], "device_kernels": len(ev), "staged": n_staged, "direct": n_valid - n_staged}
    # rows that are no 16-byte multiples cannot be staged: every crop direct
    narrow = torch.from_numpy(rng.integers(0, 256, (2, 3, 96, 120), dtype=np.uint8)).to(dev)
    args = (narrow, torch.from_numpy(rng.integers(0, 2, 64)).to(dev), torch.from_numpy(crop_boxes(rng, 64, 96, 120)).to(dev),
            torch.ones(64, dtype=torch.bool, device=dev))
    staged = torch.zeros((), dtype=torch.int32, device=dev)
    if not torch.equal(crops._launch(*args, staged_count=staged), crops.gather_crops_batch_plain(*args)) or int(staged):
        raise AssertionError(f"K1 kernel differs from its plain version on 96x120 frames, or staged {int(staged)} crops there")
    print("K1 array-equal over 64 crops of 96x120 frames (rows not 16-byte multiples): all direct")
    return {**res[d], "d3840": res[3840]}


def graph_node_ms(launch, n=50, reps=5):
    """ms per launch when `launch` is a node of a captured CUDA graph: n
    launches captured once, the graph replayed reps times between CUDA
    events (after a warm-up launch and replay). The host pays one replay
    for the n nodes, so this is the device's time per launch."""
    import torch

    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    return cuda_ms(graph.replay, reps) / n


def check_k2(dev):
    """K2 and its per-class entry K3 against the plain version, bitwise, on
    all four outputs (det_free as bool bytes, det_key, out_row, track_col);
    the same launch as a node of a captured CUDA graph gives the same
    bytes; ms per launch eager and as a graph node; the kernel's clock64
    split on the timed problem. Then past the routing's gates, where the
    tracker takes the staged route: K = 320 with detection keys >= 2^23,
    and K = 1023 where the kernel's registers allow 1024 threads."""
    import torch

    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.ops import cascade
    from vehicle_counting_tpu_torch.testing import association_problem

    names = ["gated", "iou", "lvl_of", "tentative", "track_id", "iou_order", "det_valid", "det_order"]
    rng = np.random.default_rng(SEED + 1)
    n_cases, t_plain, err = 0, [], 0

    def compare(got_list, want, what):
        e = 0
        for field, w in zip(want._fields, want):
            for got in got_list:
                g = getattr(got, field)
                if g.dtype != w.dtype:
                    raise AssertionError(f"K2 {field}: dtype {g.dtype}, plain {w.dtype}")
                e = max(e, int((g.cpu().to(torch.int64) - w.to(torch.int64)).abs().max()))
        if e:
            raise AssertionError(f"K2/K3 kernel differs from the plain version ({what}): max |diff| {e}")
        return e

    for kind in ("random", "ties", "empty", "steady"):
        for _ in range(8):
            pr = association_problem(rng, 4, 64, 30, kind)
            cpu = [torch.from_numpy(pr[n]) for n in names]
            gpu = [x.to(dev) for x in cpu]
            a = cascade.cascade_match_classparallel(*gpu, 0.2, 0.6, max_age=30)
            b = cascade.cascade_match_batched(*gpu, 0.2, 0.6, max_age=30)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cascade.cascade_match_classparallel(*cpu, 0.2, 0.6, max_age=30)
            t_plain.append((time.perf_counter() - t0) * 1e3)
            err = max(err, compare((a, b), want, f"{kind} case"))
            n_cases += 1
    pr = association_problem(np.random.default_rng(SEED + 2), 4, 64, 30, "random")
    gpu = [torch.from_numpy(pr[n]).to(dev) for n in names]

    def eager():
        return cascade.cascade_match_classparallel(*gpu, 0.2, 0.6, max_age=30)

    # the launch as a graph node: same bytes as the eager launch
    want = [t.clone() for t in eager()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        node_out = eager()
    for t in node_out:
        t.fill_(1)  # stale bytes: the replay must overwrite them all
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(node_out, want)):
        raise AssertionError("K2 launched as a graph node differs from the eager launch")
    t_k = cuda_ms(eager, 50)
    t_node = graph_node_ms(eager)
    t_k2 = cuda_ms(eager, 50)
    split = cascade.cascade_clock_split(*gpu, 0.2, 0.6, max_age=30)
    total = max(split["total"], 1)
    share = {k: round(v / total, 4) for k, v in split.items() if k not in ("total", "stages")}
    # a steady frame's problem: 8 tracks and 8 detections per class, one stage + the IoU stage
    pr = association_problem(np.random.default_rng(SEED + 20), 4, 64, 30, "steady")
    sgpu = [torch.from_numpy(pr[n]).to(dev) for n in names]

    def steady_launch():
        return cascade.cascade_match_classparallel(*sgpu, 0.2, 0.6, max_age=30)

    steady = {"ms": min(cuda_ms(steady_launch, 50), cuda_ms(steady_launch, 50)), "graph_node_ms": graph_node_ms(steady_launch),
              "clock_split": cascade.cascade_clock_split(*sgpu, 0.2, 0.6, max_age=30)}
    stotal = max(steady["clock_split"]["total"], 1)
    steady["clock_share"] = {k: round(v / stotal, 4) for k, v in steady["clock_split"].items()
                             if k not in ("total", "stages")}
    # the timed problem: every operand once, four [C, K] outputs; each
    # valid detection's row insertion scans at most K columns K times
    outs = eager()
    bd = bound(nbytes(*gpu, *outs), 2 * int(gpu[6].sum()) * 64 * 64, F32_FLOPS)
    print(f"K2/K3 bitwise-equal on {n_cases} [4, 64] problems (det_free bool, det_key, out_row, track_col; as a graph "
          f"node too); per launch: eager wrapper {t_k:.4f}/{t_k2:.4f} ms, graph node {t_node:.4f} ms; plain (host CPU) "
          f"median {np.median(t_plain):.2f} ms; bound {bd['bound_ms']:.6f} ms ({bd['bound_by']}): a dependent chain "
          f"inside one launch, so the launch floor (K7) is its real bound")
    print(f"K2 clock64 split of the timed problem (thread 0's ticks summed over the 4 classes, {split['stages']} "
          f"non-empty stages): {split}; shares of the total {share}; x graph node time = "
          f"{ {k: round(v * t_node * 1e3, 2) for k, v in share.items()} } us")
    print(f"K2 on a steady frame's problem (8 tracks and 8 detections per class): eager wrapper "
          f"{steady['ms']:.4f} ms, graph node {steady['graph_node_ms']:.4f} ms; clock64 split "
          f"{steady['clock_split']}, shares {steady['clock_share']}")

    # past the routing's gates (2^22 keys, 256 slots): the kernel ranks its
    # keys before packing them and holds one slot per thread
    max_threads = _build.entry("cascade", "vct_cascade_max_threads", [])()
    wide = {"max_threads": max_threads, "cases": []}
    shapes = [(4, 320, 4, "random"), (4, 320, 4, "ties"), (2, 320, 30, "steady")]
    if max_threads >= 1024:
        shapes.append((2, 1023, 4, "steady"))
    for c, k, max_age, kind in shapes:
        pr = association_problem(rng, c, k, max_age, kind)
        pr["det_order"] = pr["det_order"] + (1 << 23)
        cpu = [torch.from_numpy(pr[n]) for n in names]
        wgpu = [x.to(dev) for x in cpu]
        got = cascade.cascade_match_classparallel(*wgpu, 0.2, 0.6, max_age=max_age)
        torch.cuda.synchronize()
        compare((got,), cascade.cascade_match_classparallel(*cpu, 0.2, 0.6, max_age=max_age), f"K = {k}, {kind}, wide keys")
        ms = cuda_ms(lambda: cascade.cascade_match_classparallel(*wgpu, 0.2, 0.6, max_age=max_age), 10)
        wide["cases"].append({"c": c, "k": k, "kind": kind, "matched": int((got.track_col >= 0).sum()), "ms": ms})
    print(f"K2 past the routing's gates, bitwise-equal to the plain version with det keys >= 2^23: {wide['cases']}; "
          f"the kernel's blocks can hold {max_threads} threads (K + 1 rounded up to a warp), so K <= "
          f"{min(max_threads, 1024) - 1} launches")
    return {"max_abs_err": float(err), "ms": min(t_k, t_k2), "graph_node_ms": t_node,
            "plain_ms": float(np.median(t_plain)), **bd, "library_ms": None, "clock_split": split,
            "clock_share": share, "steady": steady, "past_gates": wide}


def check_k4(dev):
    """K4's two entries against their plain versions, bitwise: the
    compacted insertion (insert_rows, alone and inside the transpose rule)
    and the fused matching stage (match_stage: 306 masked stages, normal,
    flipped, empty and all-rejected, detection keys >= 2^22, K = 64 and
    320), each timed on a [4, 64, 64] problem."""
    import torch

    from vehicle_counting_tpu_torch.ops import assignment
    from vehicle_counting_tpu_torch.testing import clamp_tie_problems, stage_problems

    rng = np.random.default_rng(SEED + 4)
    err, n_ok = 0, 0
    for n, s, hi in ((300, 64, 40), (4, 64, 65), (2, 256, 257)):
        costs, nr, nc = (torch.from_numpy(a) for a in clamp_tie_problems(rng, n, s, hi))
        gpu = [t.to(dev) for t in (costs, nr, nc)]
        p = assignment.insert_rows_batched(gpu[0], gpu[1])
        r2c = assignment.solve_uniform_batched(*gpu)
        torch.cuda.synchronize()
        for got, want in ((p, assignment.insert_rows_batched(costs, nr)),
                          (r2c, assignment.solve_uniform_batched(costs, nr, nc))):
            err = max(err, int((got.cpu().long() - want.long()).abs().max()))
        if err:
            raise AssertionError(f"K4 kernel differs from its plain version on [{n}, {s}, {s}]: max |diff| {err}")
        n_ok += n
    # the main path's shape: C=4 classes, K=64 slots
    costs, nr, _ = (torch.from_numpy(a) for a in clamp_tie_problems(rng, 4, 64, 65))
    gpu = (costs.to(dev), nr.to(dev))
    t_k = cuda_ms(lambda: assignment.insert_rows_batched(*gpu), 50)
    t_plain = []
    for _ in range(3):
        t0 = time.perf_counter()
        assignment.insert_rows_plain(costs, nr)
        t_plain.append((time.perf_counter() - t0) * 1e3)
    bd = bound(nbytes(*gpu, assignment.insert_rows_batched(*gpu)), 2 * int(nr.sum()) * 64 * 64, F32_FLOPS)
    print(f"K4 bitwise-equal on {n_ok} problems (insert and transpose rule); [4, 64, 64] kernel {t_k:.4f} ms, "
          f"plain (host CPU) median {np.median(t_plain):.2f} ms; bound {bd['bound_ms']:.6f} ms ({bd['bound_by']}): "
          f"a dependent chain inside one launch, so the launch floor (K7) is its real bound")
    res = {"max_abs_err": float(err), "ms": t_k, "plain_ms": float(np.median(t_plain)), **bd, "library_ms": None}

    # the fused stage: one launch per batch of stages, in place
    def stage_args(pr, d):
        return {k: (torch.from_numpy(v).to(d) if isinstance(v, np.ndarray) else v) for k, v in pr.items()}

    serr, n_stage, kinds = 0, 0, collections.Counter()
    for n, k, hi in ((300, 64, 40), (4, 64, 65), (2, 320, 321)):
        pr = stage_problems(rng, n, k, hi)
        nr_, nc_ = pr["rows"].sum(-1), pr["det_free"].sum(-1)
        kinds.update(np.where((nr_ == 0) | (nc_ == 0), "empty", np.where(nr_ > nc_, "flipped", "normal")).tolist())
        want = assignment.match_stage_batched(**stage_args(pr, "cpu"))
        got = assignment.match_stage_batched(**stage_args(pr, dev))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.dtype != w.dtype:
                raise AssertionError(f"K4 match_stage: dtype {g.dtype}, plain {w.dtype}")
            serr = max(serr, int((g.cpu().to(torch.int64) - w.to(torch.int64)).abs().max()))
        if serr:
            raise AssertionError(f"K4 match_stage differs from its plain version on [{n}, {k}, {k}]: max |diff| {serr}")
        n_stage += n
    pr = stage_problems(rng, 4, 64, 65)
    pr["cost"][:] = np.random.default_rng(SEED + 40).uniform(0, 0.25, pr["cost"].shape)  # one in five rejected
    base = stage_args(pr, dev)
    state = ("det_free", "track_col", "det_key")  # what a launch updates in place
    work = dict(base, **{name: base[name].clone() for name in state})
    pool = []

    def reset():
        for name in state:
            work[name].copy_(base[name])

    def fused_node():  # in a graph the nodes run one after another: the three copies are taken off below
        reset()
        return assignment.match_stage_batched(**work)

    def fused():  # eager: every launch on a fresh copy of the state, made before the clock starts
        return assignment.match_stage_batched(**pool.pop())

    def eager_ms(n=50):
        pool[:] = [dict(base, **{name: base[name].clone() for name in state}) for _ in range(n + 1)]
        return cuda_ms(fused, n)

    def plain():  # the staged route's stage as it was: ~45 torch ops around insert_rows
        return assignment.match_stage_plain(**base)

    for g, w in zip(fused_node(), plain()):
        if not torch.equal(g, w):
            raise AssertionError("K4 match_stage differs from the plain stage run on the card")
    t_plain_a = cuda_ms(plain, 20)
    t_f, t_f2 = eager_ms(), eager_ms()
    t_plain_b = cuda_ms(plain, 20)
    t_node = graph_node_ms(fused_node) - graph_node_ms(reset)
    empty = dict(base, rows=torch.zeros_like(base["rows"]))
    t_empty = graph_node_ms(lambda: assignment.match_stage_batched(**empty))
    live = int((pr["rows"].sum(-1) * pr["det_free"].sum(-1)).sum())
    vec = nbytes(*(base[n] for n in ("rows", "det_free", "track_col", "row_order", "det_key", "stage_base")))
    sbd = bound(4 * live + vec + nbytes(base["det_free"], base["track_col"], base["det_key"]),
                2 * int(np.minimum(pr["rows"].sum(-1), pr["det_free"].sum(-1)).sum()) * 64 * 64, F32_FLOPS)
    print(f"K4 match_stage bitwise-equal on {n_stage} stages ({dict(kinds)}; det keys >= 2^23; K = 64 and 320); "
          f"[4, 64, 64] per launch: eager wrapper {t_f:.4f}/{t_f2:.4f} ms, graph node {t_node:.4f} ms "
          f"(three copy nodes taken off), an empty stage as a graph node {t_empty:.4f} ms; the plain stage on the card "
          f"(~45 torch ops + insert_rows) {t_plain_a:.4f}/{t_plain_b:.4f} ms; bound {sbd['bound_ms']:.6f} ms "
          f"({sbd['bound_by']}) -> the launch floor")
    res["match_stage"] = {"ok": True, "max_abs_err": float(serr), "ms": min(t_f, t_f2), "graph_node_ms": t_node,
                          "empty_graph_node_ms": t_empty, "plain_ms": min(t_plain_a, t_plain_b), **sbd,
                          "library_ms": None, "stages_checked": n_stage}
    return res


def check_k5(dev):
    """bf16 rtol 1.6e-2 / atol 1e-2, f32 atol 1e-4: the tolerances of
    tests/test_torch_reid_block.py. bf16 at the embed's launch (N=128, a
    128-crop chunk) and at a 128-frame batch's crops (N=3840), each beside
    the plain version and, for information, cuDNN's bf16 block
    (models/reid.py::_basic_block, what the embed runs with K5 off); f32
    (parity mode) at N=3840."""
    import torch

    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.models.convert import reid_block64_from_jax, reid_params_from_jax
    from vehicle_counting_tpu_torch.models.reid import _basic_block, cast_conv_weights
    from vehicle_counting_tpu_torch.ops import reid_block
    from vehicle_counting_tpu_torch.testing import reid_block_params

    fn, ptxas = None, {}
    for ln in _build.BUILD_LOGS.get("reid_block", "").splitlines():
        if "Compiling entry function" in ln:
            fn = "bf16" if "reid_block_bf16" in ln else "f32"
        elif fn and ("Used" in ln or "spill" in ln or "wgmma" in ln):
            ptxas.setdefault(fn, []).append(ln.split("ptxas info    :")[-1].strip())
    smem = _build.load("reid_block").vct_reid_block64_smem
    for fn in ("bf16", "f32"):
        print(f"K5 {fn} ptxas: {ptxas.get(fn, '(cached: no report)')}; dynamic smem per block "
              f"{smem(int(fn == 'bf16'))} B")
    torch.backends.cudnn.allow_tf32 = False  # the plain version's f32 convs
    rng = np.random.default_rng(SEED + 5)
    p, s = reid_block_params(rng)
    ops = reid_block64_from_jax(p, s, dev)
    wts = (ops["w1"], ops["w2"], ops["a1"], ops["b1"], ops["a2"], ops["b2"])
    pb, sb = reid_params_from_jax(p, s, dev)
    pb = cast_conv_weights(pb, torch.bfloat16)
    x32 = torch.from_numpy(np.maximum(rng.standard_normal((3840, 64, 25, 25)), 0).astype(np.float32)).to(dev)
    bf16_tol, res = dict(rtol=1.6e-2, atol=1e-2), {}
    for n, reps in ((128, 50), (3840, 5)):
        x = x32[:n].to(torch.bfloat16)
        got = reid_block.reid_block64(x, *wts).float()
        want = reid_block.reid_block64_plain(x, *wts).float()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, **bf16_tol)
        xf = x.float()  # the embed hands its blocks f32 activations
        t_plain = cuda_ms(lambda: reid_block.reid_block64_plain(x, *wts), reps)
        t_k = cuda_ms(lambda: reid_block.reid_block64(x, *wts), reps)
        t_k2 = cuda_ms(lambda: reid_block.reid_block64(x, *wts), reps)
        t_plain2 = cuda_ms(lambda: reid_block.reid_block64_plain(x, *wts), reps)
        t_cudnn = cuda_ms(lambda: _basic_block(pb, sb, xf, 1, torch.bfloat16), reps)
        dev_k = device_events(lambda: reid_block.reid_block64(x, *wts))
        dev_k5 = sum(ms for name, ms in dev_k if "reid_block_bf16" in name)
        dev_plain = sum(ms for _, ms in device_events(lambda: reid_block.reid_block64_plain(x, *wts)))
        print(f"K5 bfloat16 N={n}: max |diff| {err:.3e} ({bf16_tol}); kernel {t_k:.4f}/{t_k2:.4f} ms, "
              f"plain {t_plain:.4f}/{t_plain2:.4f} ms; cuDNN bf16 block (information) {t_cudnn:.4f} ms; "
              f"device time of one call (torch.profiler): K5 {dev_k5:.4f} ms + the wrapper's other ops "
              f"{sum(ms for _, ms in dev_k) - dev_k5:.4f} ms, plain {dev_plain:.4f} ms")
        # two 3x3 64->64 convs on 25x25: 2 * 625 * 64 * 64 * 9 MACs per crop; x and out once, weights and BN once
        bd = bound(2 * nbytes(x) + nbytes(*wts), 2 * 2 * 625 * 64 * 64 * 9 * n, BF16_FLOPS)
        print(f"K5 bfloat16 N={n}: bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}), device time is "
              f"{100 * bd['bound_ms'] / dev_k5:.1f} % of it")
        res[n] = {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2), "cudnn_bf16_ms": t_cudnn,
                  "device_ms": dev_k5, "plain_device_ms": dev_plain, **bd, "library_ms": t_cudnn}
    # N=1, and N=133 where some blocks take two crops; no atomics, no state
    # across crops: a crop's output does not depend on the launch
    for n in (1, 133):
        x = x32[:n].to(torch.bfloat16)
        got = reid_block.reid_block64(x, *wts)
        torch.testing.assert_close(got.float(), reid_block.reid_block64_plain(x, *wts).float(), **bf16_tol)
    if not torch.equal(got[:4], reid_block.reid_block64(x[:4].contiguous(), *wts)):
        raise AssertionError("K5 bf16: the first 4 crops of an N=133 launch differ from an N=4 launch")
    print("K5 bfloat16 N=1 and N=133 within tolerance; batch-invariant: crops 0-3 of N=133 == N=4, bitwise")
    args = (x32, *wts)
    got = reid_block.reid_block64(*args)
    want = reid_block.reid_block64_plain(*args)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    t_plain = cuda_ms(lambda: reid_block.reid_block64_plain(*args), 5)
    t_k = cuda_ms(lambda: reid_block.reid_block64(*args), 5)
    t_k2 = cuda_ms(lambda: reid_block.reid_block64(*args), 5)
    t_plain2 = cuda_ms(lambda: reid_block.reid_block64_plain(*args), 5)
    print(f"K5 float32 N=3840 (parity mode, CUDA cores): max |diff| {err:.3e} (atol 1e-4); "
          f"kernel {t_k:.4f}/{t_k2:.4f} ms, plain {t_plain:.4f}/{t_plain2:.4f} ms")
    return {**res[128], "n": 128, "n3840": res[3840],
            "f32": {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2), "n": 3840}}


def embed_ab(dev, n_frames=128, per_frame=30):
    """The ReID embed at the main path's shapes (bf16, chunks of
    DeepSortParams.max_embed crops, per_frame crops for each of n_frames
    frames) with K5 off and on, in turns (off, on, on, off), CUDA events;
    then one profiled pass of each for the card's busy time. Returns the
    best ms/frame of each."""
    import torch

    from vehicle_counting_tpu_torch.models import reid
    from vehicle_counting_tpu_torch.ops import reid_block
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams

    chunk = DeepSortParams._field_defaults["max_embed"]
    rp, rs = reid.init_reid(torch.Generator().manual_seed(1), device=dev)
    rp = reid.cast_conv_weights(rp, torch.bfloat16)
    crops = torch.from_numpy(np.random.default_rng(SEED + 7).standard_normal(
        (n_frames * per_frame, 50, 50, 3)).astype(np.float32)).to(dev)

    def embed():
        with torch.no_grad():
            for i in range(0, crops.shape[0], chunk):
                reid.reid_forward(rp, rs, crops[i : i + chunk], dtype=torch.bfloat16)

    old, t = reid.FORCE_REID_BLOCK_KERNEL, {False: [], True: []}
    try:
        for on in (False, True, True, False) * 2:  # the host's clock wanders: 4 turns each
            reid.FORCE_REID_BLOCK_KERNEL = on
            reid_block.reid_block64.launches = 0
            t[on].append(cuda_ms(embed, 5) / n_frames)
            if bool(reid_block.reid_block64.launches) != on:
                raise AssertionError(f"embed A/B: K5 {'on' if on else 'off'}, {reid_block.reid_block64.launches} launches")
        print(f"embed ms/frame ({n_frames} frames x {per_frame} crops, chunks of {chunk}, bf16): "
              f"K5 off {[round(v, 4) for v in t[False]]}, K5 on {[round(v, 4) for v in t[True]]}")
        for on in (False, True):  # how much of that wall time the card is busy
            reid.FORCE_REID_BLOCK_KERNEL = on
            ev = device_events(embed)
            k5 = sum(ms for name, ms in ev if "reid_block_bf16" in name)
            total = sum(ms for _, ms in ev) / n_frames
            print(f"embed K5 {'on' if on else 'off'}: device busy {total:.4f} ms/frame "
                  f"({100 * total / min(t[on]):.1f} % of the best wall time; torch.profiler), "
                  f"K5 kernel {k5 / n_frames:.4f} ms/frame, {len(ev) / n_frames:.2f} device ops/frame")
    finally:
        reid.FORCE_REID_BLOCK_KERNEL = old
    return {"off": min(t[False]), "on": min(t[True])}


def device_events(fn):
    """(name, ms) of each kernel and copy that one call of fn runs on the
    card: a warm-up call, then one call under utils/profiling.trace, read
    back from the trace file. The call sits in a named region, and a
    device event counts when the host call that launched it (its
    correlation id) lies in the region, or when it starts inside the
    region. The profiler maps the device's clock onto the host's and the
    mapping drifts as the process runs: kernels come out tens of
    milliseconds before their launch (warned "GPU op timestamp <
    runtime timestamp" by the profiler), and it drops device events that
    come out before the trace began. So the region opens only after a
    pause inside the trace; a trace that still shows no device event of
    the region is taken again with a pause twice as long, and the fifth
    empty one raises, with what the traces held."""
    import torch

    from vehicle_counting_tpu_torch.tools.profile_summary import DEVICE_CATS
    from vehicle_counting_tpu_torch.utils.profiling import trace

    fn()
    torch.cuda.synchronize()
    seen = []
    for pause in (0.25, 0.5, 1.0, 2.0, 4.0):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as t:
                torch.zeros(8, device="cuda").add_(1.0)
                torch.cuda.synchronize()
                time.sleep(pause)
                with torch.profiler.record_function("vct_device_events_region"):
                    fn()
                    torch.cuda.synchronize()
            with open(t["path"]) as f:
                data = json.load(f)
        raw = [e for e in (data["traceEvents"] if isinstance(data, dict) else data) if e.get("ph") == "X"]
        region = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in raw
                  if e.get("name") == "vct_device_events_region"]
        if not region:
            raise AssertionError("device_events: the trace holds no region marker")
        start, stop = min(r[0] for r in region), max(r[1] for r in region)
        launched = {e.get("args", {}).get("correlation") for e in raw
                    if e.get("cat") in ("cuda_runtime", "cuda_driver") and start <= float(e["ts"]) <= stop}
        launched.discard(None)
        device = sorted((e for e in raw if e.get("cat") in DEVICE_CATS), key=lambda e: float(e["ts"]))
        events = [(str(e.get("name", "")), float(e.get("dur", 0.0)) / 1e3) for e in device
                  if e.get("args", {}).get("correlation") in launched or start <= float(e["ts"]) <= stop]
        if events:
            return events
        seen.append(f"pause {pause} s: {len(device)} device events, {len(launched)} launches in the region, first "
                    f"device event at {float(device[0]['ts']) - start if device else None} us from the region's start")
    raise AssertionError(f"device_events: five traces in a row show no device event of the region: {seen}")


def check_k6(dev):
    """bf16 rtol 1.6e-2 / atol 1e-2, f32 1e-5: the tolerances of
    tests/test_torch_conv_s2.py. bf16 at the main path's shape (every
    worker walks ~78 tiles: the ring turns) and at [3, 64, 128, 32], a
    launch of 96 tiles, one per worker, 60 of them on an image's edge."""
    import subprocess

    import torch
    import torch.nn.functional as F

    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.models.convert import conv1_s2_from_jax
    from vehicle_counting_tpu_torch.ops import conv_s2
    from vehicle_counting_tpu_torch.testing import conv1_s2_inputs

    fn, ptxas = None, {}
    for ln in _build.BUILD_LOGS.get("conv_s2", "").splitlines():
        if "Compiling entry function" in ln:
            fn = "bf16" if "conv1_s2_bf16" in ln else "f32"
        elif fn and ("Used" in ln or "spill" in ln or "wgmma" in ln):
            ptxas.setdefault(fn, []).append(ln.split("ptxas info    :")[-1].strip())
    lib = _build.load("conv_s2")
    for fn in ("bf16", "f32"):
        print(f"K6 {fn} ptxas: {ptxas.get(fn, '(cached: no report)')}; dynamic smem per block "
              f"{lib.vct_conv1_s2_smem(int(fn == 'bf16'))} B")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):  # the tensor-core instruction in the built code, not a library's
        sass = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True, text=True).stdout
        print(f"K6 SASS: {sass.count('HGMMA')} HGMMA (wgmma) and {sass.count('LDSM')} LDSM (ldmatrix) instructions")
        if "HGMMA" not in sass:
            raise AssertionError("K6: the built kernel holds no HGMMA instruction")
    torch.backends.cudnn.allow_tf32 = False  # the plain version's f32 conv
    rng = np.random.default_rng(SEED + 6)
    res = {}
    bf16_tol = dict(rtol=1.6e-2, atol=1e-2)
    for key, shape, dt, tol in (("bfloat16", (128, 192, 320, 32), torch.bfloat16, bf16_tol),
                                ("bfloat16_edges", (3, 64, 128, 32), torch.bfloat16, bf16_tol),
                                ("float32", (2, 64, 128, 32), torch.float32, dict(rtol=1e-5, atol=1e-5))):
        x, p = conv1_s2_inputs(rng, shape)
        w, b = conv1_s2_from_jax(p, dev)
        xt = torch.from_numpy(x).to(dev).to(dt)
        got = conv_s2.conv1_s2_silu(xt, w, b).float()
        want = conv_s2.conv1_s2_silu_plain(xt, w, b).float()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, **tol)
        n = 10 if shape[0] == 128 else 20
        t_plain = cuda_ms(lambda: conv_s2.conv1_s2_silu_plain(xt, w, b), n)
        t_k = cuda_ms(lambda: conv_s2.conv1_s2_silu(xt, w, b), n)
        t_k2 = cuda_ms(lambda: conv_s2.conv1_s2_silu(xt, w, b), n)
        t_plain2 = cuda_ms(lambda: conv_s2.conv1_s2_silu_plain(xt, w, b), n)
        name = str(dt).split(".")[-1]
        # the library's way to the same function: cuDNN's conv in the
        # compute dtype, channels-last (the NHWC input as an NCHW view), and
        # SiLU. Timed here, used nowhere in the package.
        x_cl, w_cl = xt.permute(0, 3, 1, 2), w.to(dt).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_dt = b.to(dt)

        def library():
            return F.silu(F.conv2d(x_cl, w_cl, b_dt, stride=2, padding=1))

        lib_err = float((library().permute(0, 2, 3, 1).float() - want).abs().max())
        t_lib = min(cuda_ms(library, n), cuda_ms(library, n))
        ev = device_events(lambda: conv_s2.conv1_s2_silu(xt, w, b))
        dev_k = [ms for nm, ms in ev if "conv1_s2" in nm]
        if not dev_k:
            raise AssertionError(f"K6: no conv1_s2 kernel among the call's device events {ev}")
        # x and out once, weights and bias once; 2 * 9 * 32 * 64 flops per output pixel
        moved = nbytes(xt, got.to(dt), w.to(dt), b)
        bd = bound(moved, 2 * 9 * 32 * got.numel(), BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
        print(f"K6 {name} {list(shape)}: max |diff| {err:.3e} ({tol}); kernel {t_k:.4f}/{t_k2:.4f} ms, "
              f"plain {t_plain:.4f}/{t_plain2:.4f} ms, library (F.conv2d {name} channels-last + F.silu) {t_lib:.4f} ms "
              f"(max |diff| vs plain {lib_err:.3e}); device time of the kernel {sum(dev_k):.4f} ms (torch.profiler) = "
              f"{moved / sum(dev_k) / 1e9:.3f} TB/s of {HBM_BPS / 1e12} ; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        res[key] = {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2), **bd, "library_ms": t_lib,
                    "device_ms": sum(dev_k), "shape": list(shape)}
        if shape[0] == 128:
            # what this card's memory gives a plain copy that moves as many bytes (half read, half written)
            src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            t_copy = min(cuda_ms(lambda: dst.copy_(src), n), cuda_ms(lambda: dst.copy_(src), n))
            print(f"K6 yardstick: a device copy moving the same {moved / 1e6:.1f} MB takes {t_copy:.4f} ms = "
                  f"{2 * src.numel() / t_copy / 1e9:.3f} TB/s; the kernel's device time is {sum(dev_k) / t_copy:.2f}x that")
            res[key]["copy_ms"] = t_copy
    return res


def check_k7(dev):
    """K7 against its plain version, array-equal, on the probe's [64, 128]
    f32 block and on a ragged size; then the launch-cost probe. The K7
    launches of the probe are its main path's: counted from 0."""
    import torch

    from vehicle_counting_tpu_torch.benchmarks.micro import noop_launch
    from vehicle_counting_tpu_torch.ops import noop

    rng = np.random.default_rng(SEED + 8)
    for shape in ((64, 128), (3, 1000, 77)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        got = noop.noop_add1(x)
        torch.cuda.synchronize()
        want = noop.noop_add1_plain(x)
        if not torch.equal(got, want):
            raise AssertionError(f"K7 kernel differs from its plain version on {shape}: "
                                 f"max |diff| {float((got - want).abs().max())}")
    x = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).to(dev)
    err = float((noop.noop_add1(x) - noop.noop_add1_plain(x)).abs().max())
    t_plain = cuda_ms(lambda: noop.noop_add1_plain(x), 200)
    t_k = cuda_ms(lambda: noop.noop_add1(x), 200)
    t_k2 = cuda_ms(lambda: noop.noop_add1(x), 200)
    t_plain2 = cuda_ms(lambda: noop.noop_add1_plain(x), 200)
    bd = bound(2 * nbytes(x), x.numel(), F32_FLOPS)
    print(f"K7 array-equal on [64, 128] and [3, 1000, 77] f32; wrapper {t_k:.5f}/{t_k2:.5f} ms, "
          f"plain (torch add, also the library call) {t_plain:.5f}/{t_plain2:.5f} ms; bound {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']}): the launch is the cost")
    noop.noop_add1.launches = 0
    probe = noop_launch.main(dev)
    launches = noop.noop_add1.launches
    if launches <= 0:
        raise AssertionError("the launch-cost probe never launched the K7 kernel")
    for key in ("cuda_noop_eager_us", "cuda_noop_graph_us", "torch_equiv_eager_us", "torch_equiv_graph_us", "bare_launch_us"):
        if not (probe[key] and np.isfinite(probe[key]) and probe[key] > 0):
            raise AssertionError(f"launch-cost probe: {key} = {probe[key]}")
    return {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2), **bd,
            "library_ms": min(t_plain, t_plain2), "launches": launches, "probe": probe}


def write_video(tmp, n_frames=N_FRAMES, name="cam_smoke"):
    """n_frames of 1280x720: a fixed textured background with coloured
    boxes driving across (the same frames for every n_frames), and the
    zone file the CLI needs."""
    import cv2

    rng = np.random.default_rng(SEED + 3)
    h, w = SRC_HW
    bg = cv2.resize(rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8), (w, h))
    cars = [(rng.integers(0, h - 120), rng.uniform(-9, 9), rng.integers(40, 160), rng.integers(30, 120),
             tuple(int(c) for c in rng.integers(0, 256, 3))) for _ in range(24)]
    path = os.path.join(tmp, f"{name}.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (w, h))
    for t in range(n_frames):
        img = bg.copy()
        for i, (y, vx, bw, bh, color) in enumerate(cars):
            x = int((i * 53 + vx * t) % (w - bw))
            cv2.rectangle(img, (x, int(y)), (x + int(bw), int(y) + int(bh)), color, -1)
        writer.write(img)
    writer.release()
    zones = os.path.join(tmp, "zones")
    os.makedirs(zones, exist_ok=True)
    with open(os.path.join(zones, f"{name}.json"), "w") as f:
        json.dump({"shapes": [
            {"label": "zone", "points": [[100, 100], [1180, 100], [1180, 620], [100, 620]]},
            {"label": "direction01", "points": [[100, 360], [1180, 360]]},
            {"label": "direction02", "points": [[1180, 360], [100, 360]]},
        ]}, f)
    return path, zones


def first_batch(path, n):
    """The first n decoded RGB frames [n, H, W, 3] of the video, as the
    pipeline's reader yields them."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while len(frames) < n:
        ok, bgr = cap.read()
        if not ok:
            raise AssertionError(f"{path}: {len(frames)} frames readable, {n} needed")
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames)


def calibrate(dev, path):
    """(min_conf, mapping) like bench.py: one bf16 step at conf 0 with the
    identity class map; track the 4 dominant classes and set the threshold
    so frame 0 keeps ~30 of their detections."""
    import torch

    from vehicle_counting_tpu_torch.benchmarks.load import calibrate_from_det
    from vehicle_counting_tpu_torch.models.reid import cast_conv_weights, init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420
    from vehicle_counting_tpu_torch.pipeline.step import detect_embed_core
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    net = autoshape_hw(SRC_HW, 640)
    cfg = YoloConfig(VARIANT, 80)
    yp = cast_params(init_yolov5(torch.Generator().manual_seed(0), cfg, dev), torch.bfloat16)
    rp, rs = init_reid(torch.Generator().manual_seed(1), device=dev)
    yuv = torch.from_numpy(host_letterbox_yuv420(first_batch(path, 8), net, content_only=True)).to(dev)
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=80)
    with torch.no_grad():
        det, _ = detect_embed_core(
            yp, cast_conv_weights(rp, torch.bfloat16), rs, yuv, torch.ones(8, dtype=torch.bool, device=dev),
            torch.arange(80, dtype=torch.int32, device=dev), ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW,
            conf_thres=0.0, iou_thres=0.45, max_det=300, dtype=torch.bfloat16)
    conf, _, top4 = calibrate_from_det(det, 30)
    return conf, {int(c): i for i, c in enumerate(top4)}


def kernel_counters():
    """{kernel: [wrappers that launch it]} of the step's kernels. K2
    ("cascade", all classes in one launch) and its per-class entry K3
    ("cascade_k3", the scan mode's association) are counted apart."""
    from vehicle_counting_tpu_torch.ops import assignment, cascade, crops, reid_block

    return {
        "crops": [crops.gather_crops_batch],
        "cascade": [cascade.cascade_match_classparallel],
        "cascade_k3": [cascade.cascade_match_batched],
        "insert_rows": [assignment.insert_rows_batched],
        "match_stage": [assignment.match_stage_batched],
        "reid_block": [reid_block.reid_block64],
    }


def zero_counts(counters):
    for fns in counters.values():
        for fn in fns:
            fn.launches = 0


def read_counts(counters):
    return {name: sum(fn.launches for fn in fns) for name, fns in counters.items()}


def run_pipeline(dev, tmp, path, zones, conf, mapping, n_frames=N_FRAMES, out="out", extra_args=(),
                 reid_checkpoint=None, config_over=None):
    """The CLI main path; returns (frames/s, the kernel counts of that run,
    the CSV's rows). `mapping` None leaves the CLI's default class map,
    `conf` None the packaged min_conf; `config_over` sets configs.yaml
    keys (e.g. thin_upload)."""
    import torch

    from vehicle_counting_tpu_torch import run

    out_dir = os.path.join(tmp, out)
    args = run.parser.parse_args([
        "--input_path", path, "--output_path", out_dir, "--device", str(dev),
        *(("--mapping", json.dumps(mapping)) if mapping is not None else ()), *extra_args,
    ])
    config, cam_config = run.load_configs(args)  # the packaged defaults
    if conf is not None:
        config.min_conf = conf
    for key, value in (config_over or {}).items():
        setattr(config, key, value)
    cam_config.zone_path = zones
    if reid_checkpoint:
        cam_config.checkpoint = reid_checkpoint
    counters = kernel_counters()
    zero_counts(counters)
    t0 = time.perf_counter()
    results = run.main(args, config, cam_config)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    (res,) = results
    if not res.get("csv"):
        raise AssertionError(f"pipeline failed: {res.get('error')}")
    import pandas as pd

    df = pd.read_csv(res["csv"])
    mp4 = os.path.join(out_dir, os.path.basename(path))
    if not (os.path.getsize(res["csv"]) > 0 and (args.no_visualize or os.path.getsize(mp4) > 0)):
        raise AssertionError("pipeline wrote no CSV/MP4")
    if res["frames"] != n_frames:
        raise AssertionError(f"pipeline processed {res['frames']} of {n_frames} frames")
    print(f"pipeline: {res['frames']} frames, {res['fps']:.2f} frames/s (CLI wall {wall:.2f} s incl. "
          f"model init and the MP4 pass), {len(df)} CSV rows, {df.track_id.nunique() if len(df) else 0} "
          f"tracks in the zone, counts {res['counts']}, launches {launches}")
    return res["fps"], launches, df


def run_cli_ab(dev, tmp, path, zones, conf, mapping, df_on, fps_on):
    """The default CLI run again without the MP4 pass, with the frame graph
    off, off and on (the phase before was on, and cold): every run's CSV
    must hold the rows of the first (track id, frame, box, label), and the
    eager runs must launch K2 as often. Returns {"on": [...], "off": [...]}
    frames/s in the order run."""
    from vehicle_counting_tpu_torch.pipeline import step as step_mod

    cols = ["track_id", "frame_id", "box", "label"]
    fps = {"on": [fps_on], "off": []}
    old = step_mod.USE_FRAME_GRAPH
    try:
        for i, graph in enumerate((False, False, True)):
            step_mod.USE_FRAME_GRAPH = None if graph else False
            got, launches, df = run_pipeline(dev, tmp, path, zones, conf, mapping, N_FRAMES, f"out_ab{i}",
                                             extra_args=("--no_visualize",))
            if launches["cascade"] != N_FRAMES:
                raise AssertionError(f"CLI with the frame graph {'on' if graph else 'off'}: {launches['cascade']} K2 launches")
            if not df[cols].equals(df_on[cols]):
                raise AssertionError(f"CLI with the frame graph {'on' if graph else 'off'}: CSV rows differ from the first run's")
            fps["on" if graph else "off"].append(got)
    finally:
        step_mod.USE_FRAME_GRAPH = old
    print(f"CLI frames/s, 256 frames: frame graph on {[round(v, 2) for v in fps['on']]} (the first cold, with the MP4 "
          f"pass after it), off {[round(v, 2) for v in fps['off']]}; CSV rows equal in all four runs")
    return fps


def run_switched(dev, tmp, path, zones, conf, mapping):
    """The CLI on the first N_SWITCHED frames with the fused ReID block on
    (the environment switch both packages read) and the staged association
    forced. Returns (launches, CSV rows)."""
    from vehicle_counting_tpu_torch.tracking import tracker

    old_env, old_force = os.environ.get("FORCE_PALLAS_REID_BLOCK"), tracker.FORCE_CASCADE_KERNEL
    os.environ["FORCE_PALLAS_REID_BLOCK"] = "1"
    tracker.FORCE_CASCADE_KERNEL = False
    try:
        _, launches, df = run_pipeline(dev, tmp, path, zones, conf, mapping, N_SWITCHED, "out_switched")
    finally:
        tracker.FORCE_CASCADE_KERNEL = old_force
        if old_env is None:
            os.environ.pop("FORCE_PALLAS_REID_BLOCK")
        else:
            os.environ["FORCE_PALLAS_REID_BLOCK"] = old_env
    for name in ("crops", "match_stage", "reid_block"):
        if launches[name] <= 0:
            raise AssertionError(f"the switched path never launched the {name} kernel")
    if launches["cascade"]:
        raise AssertionError("the staged route was forced, yet the fused cascade kernel ran")
    return launches, df


def run_layer1_path(dev, path):
    """K6's stand-alone path (the detector does not call it, as in the JAX
    package): the first 128 frames through the pixel path and yolov5s
    layer 0 (bf16), then layer 1 as K6 on those activations, the main
    path's [128, 192, 320, 32]; held against the detector's own layer 1
    (cuDNN bf16, which rounds the conv sum, the bias add and SiLU each to
    bf16: up to 4 bf16 ulps, so rtol 3.2e-2, atol 2e-2). Returns K6's
    launches in that run."""
    import torch

    from vehicle_counting_tpu_torch.models.layers import conv_block_nchw
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
    from vehicle_counting_tpu_torch.ops import conv_s2, true_div
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420, yuv420_content_to_full, yuv420_to_rgb_u8_planar
    from vehicle_counting_tpu_torch.ops.reid_block import hwio

    net = autoshape_hw(SRC_HW, 640)
    yp = cast_params(init_yolov5(torch.Generator().manual_seed(0), YoloConfig(VARIANT, 80), dev), torch.bfloat16)
    yuv = torch.from_numpy(host_letterbox_yuv420(first_batch(path, 128), net, content_only=True)).to(dev)
    conv_s2.conv1_s2_silu.launches = 0
    with torch.no_grad():
        rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(yuv, SRC_HW, net))
        x0 = conv_block_nchw(yp["0"], true_div(rgb.to(torch.float32), 255.0).to(torch.bfloat16), stride=2, padding=2)
        got = conv_s2.conv1_s2_silu(x0.permute(0, 2, 3, 1).contiguous(), hwio(yp["1"]["w"]), yp["1"]["b"])
        torch.cuda.synchronize()
        launches = conv_s2.conv1_s2_silu.launches
        want = conv_block_nchw(yp["1"], x0, stride=2).permute(0, 2, 3, 1)
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=3.2e-2, atol=2e-2)
    print(f"layer-1 path: K6 on yolov5s layer 0's output {list(x0.permute(0, 2, 3, 1).shape)} bf16, "
          f"{launches} launch(es); max |diff| vs the detector's layer 1 {err:.3e}")
    if launches <= 0:
        raise AssertionError("the layer-1 path never launched the K6 kernel")
    return launches


def run_compacted_stage_path(dev):
    """K4's compacted insertion where the port still runs it on the card:
    the staged association's stage in its compacting form
    (`ops/assignment.py::match_stage_plain` on CUDA tensors: argsort, gather,
    one `insert_rows` launch, scatter), chained over a frame's 31 stages at
    the main path's [4, 64, 64], and held against the same chain through
    the fused stage. The tracker's staged route launches the fused stage,
    so this is a path of its own. Returns the `insert_rows` launches."""
    import torch

    from vehicle_counting_tpu_torch.ops import assignment
    from vehicle_counting_tpu_torch.testing import stage_problems

    rng = np.random.default_rng(SEED + 41)
    pr = stage_problems(rng, 4, 64, 65)
    pr["cost"][:] = rng.uniform(0, 0.25, pr["cost"].shape)
    t = {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v) for k, v in pr.items()}
    rows = torch.from_numpy(rng.uniform(0, 1, (31, 4, 64)) < 0.08).to(dev)
    assignment.insert_rows_batched.launches = 0
    plain = fused = (t["det_free"], t["track_col"], t["det_key"])
    fused = tuple(x.clone() for x in fused)
    for i in range(31):
        base = torch.full((4,), i + 1, dtype=torch.int32, device=dev)
        plain = assignment.match_stage_plain(t["cost"], rows[i], *plain[:2], 0.2, t["row_order"], plain[2], base)
        fused = assignment.match_stage_batched(t["cost"], rows[i], *fused[:2], 0.2, t["row_order"], fused[2], base)
    torch.cuda.synchronize()
    launches = assignment.insert_rows_batched.launches
    for name, a, b in zip(("det_free", "track_col", "det_key"), plain, fused):
        if not torch.equal(a, b):
            raise AssertionError(f"compacted stage chain differs from the fused stage chain: {name}")
    print(f"compacted stage on the card: 31 stages of a [4, 64, 64] frame, {launches} insert_rows launches, "
          f"{int((plain[1] >= 0).sum())} tracks matched; equal to the fused stage's chain")
    if launches <= 0:
        raise AssertionError("the compacted stage never launched the insert_rows kernel")
    return launches


def check_parity(dev, path):
    """One f32 step (B=16, yolov5s, K=64) on the card (the tracker's frame
    step replayed from its CUDA graph) vs the CPU (the plain loop); the
    threshold sits in a gap of the CPU scores so neither side is near it.
    Then the card's step through the staged route (K4's fused stage) vs the
    K2 route, and both routes' tracker time per frame on the step's
    detections. Returns that timing."""
    import torch

    from vehicle_counting_tpu_torch.ops import assignment
    from vehicle_counting_tpu_torch.pipeline.step import detect_embed_core, tracker_scan
    from vehicle_counting_tpu_torch.tracking import tracker
    from vehicle_counting_tpu_torch.models.reid import init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420, yuv420_content_to_full, yuv420_to_rgb_u8_planar
    from vehicle_counting_tpu_torch.pipeline.step import pipeline_batch_step
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = 16
    net = autoshape_hw(SRC_HW, 640)
    cfg = YoloConfig(VARIANT, 80)
    yp = init_yolov5(torch.Generator().manual_seed(0), cfg)
    rp, rs = init_reid(torch.Generator().manual_seed(1))
    yuv = torch.from_numpy(host_letterbox_yuv420(first_batch(path, b), net, content_only=True))
    rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(yuv, SRC_HW, net)).float() / 255.0
    conf, lut, gap = _gap_conf(yp, cfg, rgb, 20 * b)
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=4)
    to = _tree_to

    def step(d):
        with torch.no_grad():
            _, det, tout = pipeline_batch_step(
                to(yp, d), to(rp, d), to(rs, d), init_states(hp, d), yuv.to(d), torch.ones(b, dtype=torch.bool, device=d),
                torch.from_numpy(lut).to(d), ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW,
                conf_thres=conf, iou_thres=0.45, max_det=300, dtype=torch.float32)
        return det, tout

    outs = {}
    for d in ("cpu", dev):
        det, tout = step(d)
        outs[str(d)] = ({k: v.cpu() for k, v in det.items()}, [x.cpu() for x in tout])
    (dc, tc), (dg, tg) = outs["cpu"], outs[str(dev)]
    if not torch.equal(dc["valid"], dg["valid"]) or not torch.equal(dc["classes"], dg["classes"]):
        raise AssertionError("parity: detections differ between card and CPU")
    box_err = float((dc["boxes"] - dg["boxes"]).abs().max())
    if not (torch.equal(tc[3], tg[3]) and torch.equal(tc[1], tg[1])):
        raise AssertionError("parity: track ids/mask differ between card and CPU")
    print(f"parity: f32 B={b} card == CPU: {int(dc['valid'].sum())} detections (threshold gap {gap:.2e}), "
          f"{int(tc[3].sum())} track outputs, ids equal, max det box diff {box_err:.2e} px, "
          f"track boxes equal: {torch.equal(tc[0], tg[0])}")

    # the same step on the card through the staged route (K4 per stage)
    old = tracker.FORCE_CASCADE_KERNEL
    tracker.FORCE_CASCADE_KERNEL = False
    try:
        assignment.match_stage_batched.launches = 0
        det_s, tout_s = step(dev)
        torch.cuda.synchronize()
        k4 = assignment.match_stage_batched.launches
    finally:
        tracker.FORCE_CASCADE_KERNEL = old
    if k4 <= 0:
        raise AssertionError("staged route: the assignment kernel was never launched")
    ts = [x.cpu() for x in tout_s]
    for name, i in (("boxes", 0), ("ids", 1), ("mask", 3)):
        if not torch.equal(ts[i], tg[i]):
            raise AssertionError(f"staged route (K4) and K2 route differ on the card: track {name}")
    print(f"staged vs fused on the card: track ids, mask and boxes equal ({int(ts[3].sum())} track outputs, "
          f"{k4} K4 launches for {b} frames)")

    # tracker time per frame, K2 route vs staged route, in turns, on the
    # step's detections and features
    with torch.no_grad():
        det_s, feats = detect_embed_core(
            to(yp, dev), to(rp, dev), to(rs, dev), yuv.to(dev), torch.ones(b, dtype=torch.bool, device=dev),
            torch.from_numpy(lut).to(dev), ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW,
            conf_thres=conf, iou_thres=0.45, max_det=300, dtype=torch.float32)

    def scan_ms(staged):
        tracker.FORCE_CASCADE_KERNEL = False if staged else old
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                tracker_scan(init_states(hp, dev), det_s, feats, hp=hp, src_hw=SRC_HW)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / b
        finally:
            tracker.FORCE_CASCADE_KERNEL = old

    scan_ms(False), scan_ms(True)  # warm-up
    t = {"k2": [], "staged": []}
    for staged in (False, True, True, False):
        t["staged" if staged else "k2"].append(scan_ms(staged))
    print(f"tracker ms/frame (B={b}, f32, host clock): K2 route {t['k2']}, staged route {t['staged']}")
    return t


def check_frame_graph(dev, path, conf, mapping):
    """The frame scan replayed from its CUDA graph against the eager loop,
    on the card, over the 256-frame smoke video (the CLI's default config:
    bf16, B=128, the calibrated threshold and class map), on both
    association routes: every `TrackerState` leaf and every output
    bitwise-equal after each batch; the two routes equal on the discrete
    outputs. Then the tracker A/B: `tracker_scan` on the second batch
    (B=128, the state warmed by the first: steady state), graph off / on /
    on / off, ms/frame. Returns the A/B times and the launch counts."""
    import torch

    from vehicle_counting_tpu_torch.models.detector import class_lut
    from vehicle_counting_tpu_torch.models.reid import cast_conv_weights, init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420
    from vehicle_counting_tpu_torch.pipeline import step as step_mod
    from vehicle_counting_tpu_torch.tracking import graph as graph_mod
    from vehicle_counting_tpu_torch.tracking import tracker
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState

    b = 128
    net = autoshape_hw(SRC_HW, 640)
    cfg = YoloConfig(VARIANT, 80)
    yp = cast_params(init_yolov5(torch.Generator().manual_seed(0), cfg, dev), torch.bfloat16)
    rp, rs = init_reid(torch.Generator().manual_seed(1), device=dev)
    rp = cast_conv_weights(rp, torch.bfloat16)
    lut = torch.from_numpy(class_lut(80, mapping)).to(dev)
    hp = DeepSortParams(tracker=TrackerParams(feat_dtype="bfloat16"), num_classes=len(mapping))
    frames = first_batch(path, N_FRAMES)
    batches = []
    with torch.no_grad():
        for i in range(0, N_FRAMES, b):
            yuv = torch.from_numpy(host_letterbox_yuv420(frames[i : i + b], net, content_only=True)).to(dev)
            batches.append(step_mod.detect_embed_core(
                yp, rp, rs, yuv, torch.ones(b, dtype=torch.bool, device=dev), lut, ycfg=cfg, hp=hp,
                image_size=net, src_hw=SRC_HW, conf_thres=conf, iou_thres=0.45, max_det=300, dtype=torch.bfloat16))
    del frames

    def scan(states, det, feats, graph, staged):
        old = step_mod.USE_FRAME_GRAPH, tracker.FORCE_CASCADE_KERNEL
        step_mod.USE_FRAME_GRAPH = None if graph else False
        tracker.FORCE_CASCADE_KERNEL = False if staged else old[1]
        try:
            with torch.no_grad():
                return step_mod.tracker_scan(states, det, feats, hp=hp, src_hw=SRC_HW)
        finally:
            step_mod.USE_FRAME_GRAPH, tracker.FORCE_CASCADE_KERNEL = old

    counters = kernel_counters()
    runs, launches = {}, {}
    for staged in (False, True):
        for graph in (False, True):
            zero_counts(counters)
            states, per_batch = init_states(hp, dev), []
            for det, feats in batches:
                states, outs = scan(states, det, feats, graph, staged)
                per_batch.append((TrackerState(*(t.clone() for t in states)), outs))
            torch.cuda.synchronize()
            runs[staged, graph] = per_batch
            launches[staged, graph] = read_counts(counters)
        for i, ((st_e, out_e), (st_g, out_g)) in enumerate(zip(runs[staged, False], runs[staged, True])):
            for name, e, g in zip(st_e._fields + out_e._fields, tuple(st_e) + tuple(out_e), tuple(st_g) + tuple(out_g)):
                if not torch.equal(e, g):
                    raise AssertionError(f"frame graph != eager loop on the {'staged' if staged else 'K2'} route, "
                                         f"batch {i}: {name} differs")
        if launches[staged, False] != launches[staged, True]:
            raise AssertionError(f"launch counts differ, eager {launches[staged, False]} vs graph {launches[staged, True]}")
    for (st_k, out_k), (st_s, out_s) in zip(runs[False, True], runs[True, True]):
        for name in ("ids", "mask", "boxes"):
            if not torch.equal(getattr(out_k, name), getattr(out_s, name)):
                raise AssertionError(f"staged route and K2 route differ under the graph: track {name}")
    n_out = sum(int(o.mask.sum()) for _, o in runs[False, True])
    k2_l, st_l = launches[False, True], launches[True, True]
    if (k2_l["cascade"] != N_FRAMES or k2_l["match_stage"] or st_l["cascade"] or st_l["match_stage"] != 31 * N_FRAMES
            or k2_l["insert_rows"] or st_l["insert_rows"]):
        raise AssertionError(f"frame graph launch counts over {N_FRAMES} frames: K2 route {k2_l}, staged route {st_l}")
    # what one replay really launches, read from the card's trace, against
    # what the runner adds to the wrappers' counts per replay
    measured = {}
    for staged in (False, True):
        old = tracker.FORCE_CASCADE_KERNEL
        tracker.FORCE_CASCADE_KERNEL = False if staged else old
        try:
            runner = step_mod.frame_runner(hp, SRC_HW, dev)
        finally:
            tracker.FORCE_CASCADE_KERNEL = old
        events = device_events(runner._step)
        seen = {"cascade": sum("cascade_kernel" in name for name, _ in events),
                "match_stage": sum("match_stage_kernel" in name for name, _ in events),
                "insert_rows": sum("insert_rows_kernel" in name for name, _ in events)}
        counted = {"cascade": 0, "match_stage": 0, "insert_rows": 0}
        for name, fns in counters.items():
            if name in counted:
                counted[name] = sum(runner.replay_launches.get(fn, 0) for fn in fns)
        want = {"cascade": 0, "match_stage": 31, "insert_rows": 0} if staged else {"cascade": 1, "match_stage": 0, "insert_rows": 0}
        if seen != counted or seen != want:
            raise AssertionError(f"one replay on the {'staged' if staged else 'K2'} route: the trace shows {seen} device "
                                 f"kernels, the runner counts {counted}, expected {want}")
        measured["staged" if staged else "k2"] = {"device_kernels_per_replay": len(events), **seen}
    print(f"frame graph == eager loop, bitwise, on all {len(TrackerState._fields)} state leaves and 4 outputs after each "
          f"of {len(batches)} batches of {b} frames, on both routes ({n_out} track outputs); staged == K2 route on ids, "
          f"mask, boxes; launches over {N_FRAMES} frames: K2 route {k2_l['cascade']} K2, staged route "
          f"{st_l['match_stage']} K4 match_stage (31 per frame: min(max_age, K) + 1); one replay in the card's trace "
          f"(torch.profiler): {measured}, equal to the counts the runner adds per replay; warm-up launches of the "
          f"captures so far, on scratch state and in no count above: {dict(graph_mod.warmup_launches)}")

    # tracker A/B on the steady-state batch
    warmed = runs[False, False][0][0]
    det, feats = batches[1]

    def scan_ms(graph, staged):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan(TrackerState(*(t.clone() for t in warmed)), det, feats, graph, staged)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / b

    ab = {}
    for staged in (False, True):
        scan_ms(True, staged), scan_ms(False, staged)  # warm-up
        t = {"off": [], "on": []}
        for graph in (False, True, True, False) * 2:
            t["on" if graph else "off"].append(scan_ms(graph, staged))
        ab["staged" if staged else "k2"] = t
        print(f"tracker_scan ms/frame (B={b}, steady state, bf16 gallery, host clock, {'staged' if staged else 'K2'} route), "
              f"graph off/on/on/off x2: off {[round(v, 4) for v in t['off']]} (min {min(t['off']):.4f}, median "
              f"{np.median(t['off']):.4f}), on {[round(v, 4) for v in t['on']]} (min {min(t['on']):.4f}, median "
              f"{np.median(t['on']):.4f})")
    step_mod.free_frame_runners()
    return {"ab": ab, "launches_k2_route": k2_l, "launches_staged_route": st_l, "replay_in_trace": measured,
            "batches": batches, "hp": hp, "runs": runs}


def check_k3(dev):
    """K3, the per-class entry of K2's kernel, which the scan mode's
    association launches once per class per frame: bitwise against the
    plain version on [1, 64] problems (random, ties, empty, steady); ms per
    launch eager and as a node of a captured CUDA graph on a steady
    [1, 64, 64] problem (K/8 tracks and detections); its bound."""
    import torch

    from vehicle_counting_tpu_torch.ops import cascade
    from vehicle_counting_tpu_torch.testing import association_problem

    names = ["gated", "iou", "lvl_of", "tentative", "track_id", "iou_order", "det_valid", "det_order"]
    rng = np.random.default_rng(SEED + 30)
    n_cases, t_plain = 0, []
    for kind in ("random", "ties", "empty", "steady"):
        for _ in range(2):
            pr3 = association_problem(rng, 3, 64, 30, kind)
            for ci in range(3):  # each class of a [3, 64] problem as a problem of its own
                cpu = [torch.from_numpy(np.ascontiguousarray(pr3[n][ci : ci + 1])) for n in names]
                got = cascade.cascade_match_batched(*(x.to(dev) for x in cpu), 0.2, 0.6, max_age=30)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = cascade.cascade_match_batched(*cpu, 0.2, 0.6, max_age=30)
                t_plain.append((time.perf_counter() - t0) * 1e3)
                for field, g, w in zip(want._fields, got, want):
                    if not torch.equal(g.cpu(), w):
                        raise AssertionError(f"K3 differs from the plain version ({kind} case): {field}")
                n_cases += 1
    pr = association_problem(np.random.default_rng(SEED + 31), 3, 64, 30, "steady")
    gpu = [torch.from_numpy(np.ascontiguousarray(pr[n][:1])).to(dev) for n in names]

    def launch():
        return cascade.cascade_match_batched(*gpu, 0.2, 0.6, max_age=30)

    t_k = cuda_ms(launch, 50)
    t_node = graph_node_ms(launch)
    t_k2 = cuda_ms(launch, 50)
    bd = bound(nbytes(*gpu, *launch()), 2 * int(gpu[6].sum()) * 64 * 64, F32_FLOPS)
    print(f"K3 bitwise-equal on {n_cases} [1, 64] problems; steady [1, 64, 64] problem: eager wrapper "
          f"{t_k:.4f}/{t_k2:.4f} ms, graph node {t_node:.4f} ms; plain (host CPU) median {np.median(t_plain):.2f} ms; "
          f"bound {bd['bound_ms']:.6f} ms ({bd['bound_by']}): a dependent chain, the launch floor is its real bound")
    return {"max_abs_err": 0.0, "ms": min(t_k, t_k2), "graph_node_ms": t_node, "plain_ms": float(np.median(t_plain)),
            **bd, "library_ms": None}


def check_k1_source(dev, b=128):
    """K1 where the raw-RGB path drives it: the crop source is the raw
    frames at source resolution, [128, 720, 1280, 3] u8 interleaved, so K1
    reads their planar copy [128, 3, 720, 1280] (`ops/crops.py::
    planar_copy`, one u8 transpose per batch) with boxes in source pixels
    and no letterbox transform. 3840 crops (128 frames x 30 seed-3 boxes)
    with frame-sized, edge, one-pixel and line boxes among them:
    array-equal to the plain version, both routes run (bands that do not
    fit the shared-memory stage read from global memory), the transpose's
    time and bound beside K1's."""
    import torch

    from vehicle_counting_tpu_torch.benchmarks.load import crop_gather_inputs, synthetic_boxes
    from vehicle_counting_tpu_torch.ops import crops

    h, w = SRC_HW
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    raw = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device=dev, generator=gen)
    planar = crops.planar_copy(raw)
    churn = torch.from_numpy(synthetic_boxes(3, b, 300, SRC_HW).astype(np.float32)).to(dev)
    fidx, boxes, valid = crop_gather_inputs(churn, 30, 1.0, 0.0, 0.0)
    edge = [[0, 0, w, h], [-1, -1, w + 1, h + 1], [0.5, 0.5, w - 0.5, h - 0.5], [w - 1, h - 1, w, h], [5, 5, 5, 5],
            [10.7, 20.2, 11.9, 21.1], [0, h / 2, w, h / 2 + 1], [w / 2, 0, w / 2 + 1, h]]
    boxes[: len(edge)] = torch.tensor(edge, dtype=torch.float32, device=dev)
    args = (planar, fidx, boxes, valid)
    got = crops.gather_crops_batch(*args)
    torch.cuda.synchronize()
    want = crops.gather_crops_batch_plain(*args)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"K1 differs from its plain version on the raw 720x1280 source: max |diff| {err}")
    staged = torch.zeros((), dtype=torch.int32, device=dev)
    if not torch.equal(crops._launch(*args, staged_count=staged), want):
        raise AssertionError("K1 differs from its plain version on the raw 720x1280 source (counted launch)")
    n_staged, n_valid = int(staged), int(valid.sum())
    if not 0 < n_staged < n_valid:
        raise AssertionError(f"K1 at 720x1280: {n_staged} of {n_valid} crops staged: both routes must run")
    t_tr = cuda_ms(lambda: crops.planar_copy(raw), 10)
    t_plain = cuda_ms(lambda: crops.gather_crops_batch_plain(*args), 3)
    t_k = cuda_ms(lambda: crops.gather_crops_batch(*args), 20)
    t_k2 = cuda_ms(lambda: crops.gather_crops_batch(*args), 20)
    t_plain2 = cuda_ms(lambda: crops.gather_crops_batch_plain(*args), 3)
    t_tr2 = cuda_ms(lambda: crops.planar_copy(raw), 10)
    x1, y1, x2, y2 = (v[valid].long() for v in crops.crop_boxes_to_bounds(boxes, h, w))
    src = int((3 * torch.clamp(x2 - x1 + 1, min=1) * torch.clamp(y2 - y1 + 1, min=1)).sum())
    bd = bound(src + nbytes(boxes, fidx, valid, got), 16 * got.numel(), F32_FLOPS)
    bd_tr = bound(2 * nbytes(raw), 0, F32_FLOPS)
    print(f"K1 array-equal over {got.shape[0]} crops of [{b}, 3, {h}, {w}] frames (the raw-RGB crop source); "
          f"{n_staged} of {n_valid} crops staged in shared memory, {n_valid - n_staged} direct; wrapper "
          f"{t_k:.4f}/{t_k2:.4f} ms, plain {t_plain:.4f}/{t_plain2:.4f} ms, bound {bd['bound_ms']:.5f} ms "
          f"({bd['bound_by']}); the planar copy of the batch ({nbytes(raw) / 1e6:.1f} MB read and written) "
          f"{t_tr:.4f}/{t_tr2:.4f} ms, bound {bd_tr['bound_ms']:.5f} ms")
    return {"shape": [b, 3, h, w], "crops": int(got.shape[0]), "max_abs_err": err, "ms": min(t_k, t_k2),
            "plain_ms": min(t_plain, t_plain2), **bd, "library_ms": None, "staged": n_staged,
            "direct": n_valid - n_staged, "transpose_ms": min(t_tr, t_tr2), "transpose_bound_ms": bd_tr["bound_ms"]}


def run_detect_only(dev, tmp, path, zones, conf, mapping, n_frames=N_FRAMES):
    """The CLI with --detect_only: {cam}_detections.csv with its schema, a
    row count, frames/s; no tracker kernel may launch. Returns (frames/s,
    launches, rows)."""
    import pandas as pd
    import torch

    from vehicle_counting_tpu_torch import run

    out_dir = os.path.join(tmp, "out_detect_only")
    args = run.parser.parse_args(["--input_path", path, "--output_path", out_dir, "--device", str(dev),
                                  "--mapping", json.dumps(mapping), "--detect_only"])
    config, cam_config = run.load_configs(args)
    config.min_conf = conf
    cam_config.zone_path = zones
    counters = kernel_counters()
    zero_counts(counters)
    (res,) = run.main(args, config, cam_config)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    df = pd.read_csv(res["csv"])
    cols = ["frame_id", "x1", "y1", "x2", "y2", "score", "label"]
    if list(df.columns) != cols or not res["csv"].endswith("_detections.csv"):
        raise AssertionError(f"detect-only CSV {res['csv']}: columns {list(df.columns)}")
    if res["frames"] != n_frames or not len(df) or not df.label.between(0, len(mapping) - 1).all():
        raise AssertionError(f"detect-only: {res['frames']} frames, {len(df)} rows, labels {sorted(set(df.label))}")
    if not np.isfinite(df[cols[1:6]].to_numpy()).all() or not (df.score > 0).all():
        raise AssertionError("detect-only: a non-finite value or a non-positive score in the CSV")
    if any(launches.values()):
        raise AssertionError(f"detect-only launched tracker / ReID kernels: {launches}")
    print(f"detect-only CLI: {res['frames']} frames, {res['fps']:.2f} frames/s (cold, model init outside), "
          f"{len(df)} rows over {df.frame_id.nunique()} frames, {df.groupby('frame_id').size().mean():.1f} per frame")
    return res["fps"], launches, len(df)


def _gap_conf(yp, cfg, imgs, n):
    """A threshold in the widest gap of the CPU's anchor scores around the
    n-th best (so neither side sits near it), and the 4 classes most
    detected above it as a LUT."""
    import torch

    from vehicle_counting_tpu_torch.models.yolo import decode_predictions, yolov5_forward_nchw

    with torch.no_grad():
        heads = [h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(yp, imgs)]
        dec = decode_predictions(heads, cfg)
    s_all, c_all = dec["scores"].numpy().ravel(), dec["classes"].numpy().ravel()
    s = np.sort(np.unique(s_all))[::-1]
    gaps = s[n // 3 : 3 * n] - s[n // 3 + 1 : 3 * n + 1]
    i = n // 3 + int(np.argmax(gaps))
    conf = float((s[i] + s[i + 1]) / 2)
    top4 = [c for c, _ in collections.Counter(c_all[s_all > conf].tolist()).most_common(4)]
    lut = np.full(80, -1, np.int32)
    lut[top4] = np.arange(len(top4))
    return conf, lut, float(s[i] - s[i + 1])


def _tree_to(tree, d):
    if isinstance(tree, dict):
        return {k: _tree_to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, d) for v in tree]
    return tree.to(d)


def check_front_parity(dev, path):
    """Card == CPU at f32 (yolov5s, B=8, the first frames of the smoke
    video, a threshold in a gap of the CPU's scores) for the slice's
    fronts: `detect_only_step` on the content-row I420 upload (detections),
    and `pipeline_batch_step` on the raw_rgb and letterboxed_rgb uploads
    (detections and track ids)."""
    import torch

    from vehicle_counting_tpu_torch.models.reid import init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox, host_letterbox_yuv420, letterbox
    from vehicle_counting_tpu_torch.pipeline.step import _i420_pixels, detect_only_step, pipeline_batch_step
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = 8
    net = autoshape_hw(SRC_HW, 640)
    cfg = YoloConfig(VARIANT, 80)
    yp = init_yolov5(torch.Generator().manual_seed(0), cfg)
    rp, rs = init_reid(torch.Generator().manual_seed(1))
    frames = first_batch(path, b)
    yuv = torch.from_numpy(host_letterbox_yuv420(frames, net, content_only=True))
    kw = dict(image_size=net, src_hw=SRC_HW, iou_thres=0.45, max_det=300, dtype=torch.float32)
    res = {}
    conf, _, gap = _gap_conf(yp, cfg, _i420_pixels(yuv, SRC_HW, net).float() / 255.0, 20 * b)
    dets = {}
    for d in ("cpu", dev):
        with torch.no_grad():
            dets[str(d)] = {k: v.cpu() for k, v in detect_only_step(_tree_to(yp, d), yuv.to(d), ycfg=cfg,
                                                                     conf_thres=conf, **kw).items()}
    dc, dg = dets["cpu"], dets[str(dev)]
    if not (torch.equal(dc["valid"], dg["valid"]) and torch.equal(dc["classes"], dg["classes"])):
        raise AssertionError("detect-only: detections differ between card and CPU")
    res["detect_only"] = {"detections": int(dc["valid"].sum()), "box_err": float((dc["boxes"] - dg["boxes"]).abs().max()),
                          "gap": gap}
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=4)
    for fmt in ("raw_rgb", "letterboxed_rgb"):
        if fmt == "raw_rgb":
            up = torch.from_numpy(frames)
            imgs = letterbox(up, net).permute(0, 3, 1, 2)
        else:
            up = torch.from_numpy(host_letterbox(frames, net))
            imgs = up.permute(0, 3, 1, 2).float() / 255.0
        conf, lut, gap = _gap_conf(yp, cfg, imgs, 20 * b)
        outs = {}
        for d in ("cpu", dev):
            with torch.no_grad():
                _, det, tout = pipeline_batch_step(
                    _tree_to(yp, d), _tree_to(rp, d), _tree_to(rs, d), init_states(hp, d), up.to(d),
                    torch.ones(b, dtype=torch.bool, device=d), torch.from_numpy(lut).to(d), ycfg=cfg, hp=hp,
                    conf_thres=conf, frames_format=fmt, **kw)
            outs[str(d)] = ({k: v.cpu() for k, v in det.items()}, [x.cpu() for x in tout])
        (dc, tc), (dg, tg) = outs["cpu"], outs[str(dev)]
        if not (torch.equal(dc["valid"], dg["valid"]) and torch.equal(dc["classes"], dg["classes"])):
            raise AssertionError(f"{fmt}: detections differ between card and CPU")
        if not (torch.equal(tc[3], tg[3]) and torch.equal(tc[1], tg[1])):
            raise AssertionError(f"{fmt}: track ids/mask differ between card and CPU")
        res[fmt] = {"detections": int(dc["valid"].sum()), "track_outputs": int(tc[3].sum()),
                    "box_err": float((dc["boxes"] - dg["boxes"]).abs().max()), "gap": gap,
                    "track_boxes_equal": bool(torch.equal(tc[0], tg[0]))}
    print(f"card == CPU at f32, B={b}: {json.dumps(res)}")
    return res


def run_raw_rgb(dev, tmp, path, zones, conf, mapping, n_frames=N_SWITCHED):
    """The CLI with `thin_upload: false` (full frames uploaded, letterboxed
    on the card, crops from the raw frames through K1 on their planar copy):
    CSV and MP4 written, K1 launched and K2 once per frame. Then the thin
    I420 and the raw upload without the MP4 pass in turns (thin, raw, raw,
    thin), frames/s. Returns (launches, frames/s of each)."""
    raw = {"thin_upload": False}
    _, launches, df = run_pipeline(dev, tmp, path, zones, conf, mapping, n_frames, "out_raw", config_over=raw)
    if launches["crops"] <= 0 or launches["cascade"] != n_frames or launches["cascade_k3"]:
        raise AssertionError(f"raw-RGB CLI: launches {launches}")
    fps = {"thin": [], "raw": []}
    for i, kind in enumerate(("thin", "raw", "raw", "thin")):
        got, _, _ = run_pipeline(dev, tmp, path, zones, conf, mapping, n_frames, f"out_rawab{i}",
                                 extra_args=("--no_visualize",), config_over=raw if kind == "raw" else None)
        fps[kind].append(got)
    print(f"raw-RGB CLI: {len(df)} CSV rows, {df.track_id.nunique() if len(df) else 0} tracks; frames/s over "
          f"{n_frames} frames without the MP4 pass: thin I420 {[round(v, 2) for v in fps['thin']]}, raw RGB "
          f"{[round(v, 2) for v in fps['raw']]}")
    return launches, fps


def check_scan(dev, fg):
    """`class_mode="scan"` on the card over the graph phase's 256 frames
    (the same detections and features): the scan-mode frame graph == the
    eager scan loop on every state leaf and output, on both routes; scan
    == batched on the track outputs; K3 launched C times per frame on the
    K2 route and no K2, K4's fused stage C x 31 times per frame on the
    staged route; one replay's trace shows C K3 kernels; then
    `tracker_scan` ms/frame, batched against scan, graph on, in turns on
    the steady batch."""
    import torch

    from vehicle_counting_tpu_torch.pipeline import step as step_mod
    from vehicle_counting_tpu_torch.tracking import tracker
    from vehicle_counting_tpu_torch.tracking.deepsort import init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerState

    batches, hp_b = fg["batches"], fg["hp"]
    hp = hp_b._replace(class_mode="scan")
    c = hp.num_classes
    n_frames = sum(f.shape[0] for _, f in batches)
    stages = min(hp.tracker.max_age, hp.tracker.capacity) + 1  # the staged route's fixed schedule

    def scan(states, det, feats, h, graph, staged):
        old = step_mod.USE_FRAME_GRAPH, tracker.FORCE_CASCADE_KERNEL
        step_mod.USE_FRAME_GRAPH = None if graph else False
        tracker.FORCE_CASCADE_KERNEL = False if staged else old[1]
        try:
            with torch.no_grad():
                return step_mod.tracker_scan(states, det, feats, hp=h, src_hw=SRC_HW)
        finally:
            step_mod.USE_FRAME_GRAPH, tracker.FORCE_CASCADE_KERNEL = old

    counters = kernel_counters()
    runs, launches = {}, {}
    for staged in (False, True):
        for graph in (False, True):
            zero_counts(counters)
            states, per_batch = init_states(hp, dev), []
            for det, feats in batches:
                states, outs = scan(states, det, feats, hp, graph, staged)
                per_batch.append((TrackerState(*(t.clone() for t in states)), outs))
            torch.cuda.synchronize()
            runs[staged, graph] = per_batch
            launches[staged, graph] = read_counts(counters)
        for i, ((st_e, out_e), (st_g, out_g)) in enumerate(zip(runs[staged, False], runs[staged, True])):
            for name, e, g in zip(st_e._fields + out_e._fields, tuple(st_e) + tuple(out_e), tuple(st_g) + tuple(out_g)):
                if not torch.equal(e, g):
                    raise AssertionError(f"scan mode: frame graph != eager loop on the {'staged' if staged else 'K2'} "
                                         f"route, batch {i}: {name} differs")
        for i, ((_, out_s), (_, out_b)) in enumerate(zip(runs[staged, True], fg["runs"][staged, True])):
            for name in out_b._fields:
                if not torch.equal(getattr(out_s, name), getattr(out_b, name)):
                    raise AssertionError(f"scan != batched on the {'staged' if staged else 'K2'} route, batch {i}: "
                                         f"track {name}")
    k2_l, st_l = launches[False, True], launches[True, True]
    if (k2_l["cascade_k3"] != c * n_frames or k2_l["cascade"] or k2_l["match_stage"] or st_l["cascade"]
            or st_l["cascade_k3"] or st_l["match_stage"] != c * stages * n_frames or launches[False, False] != k2_l):
        raise AssertionError(f"scan-mode launch counts over {n_frames} frames: K2 route {k2_l}, staged {st_l}")
    events = device_events(step_mod.frame_runner(hp, SRC_HW, dev)._step)
    seen = sum("cascade_kernel" in name for name, _ in events)
    if seen != c:
        raise AssertionError(f"one scan-mode replay shows {seen} association kernels in the card's trace, want {c}")
    n_out = sum(int(o.mask.sum()) for _, o in runs[False, True])
    print(f"scan mode: frame graph == eager loop, bitwise, on every state leaf and output, both routes; scan == "
          f"batched on the track outputs ({n_out} track outputs); launches over {n_frames} frames: K2 route "
          f"{k2_l['cascade_k3']} K3 ({c} per frame), 0 K2; staged route {st_l['match_stage']} K4 match_stage "
          f"({c} x {stages} per frame); one replay: {len(events)} device kernels, {seen} K3")

    warmed = fg["runs"][False, False][0][0]
    det, feats = batches[1]
    b = feats.shape[0]

    def scan_ms(h):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan(TrackerState(*(t.clone() for t in warmed)), det, feats, h, True, False)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / b

    scan_ms(hp), scan_ms(hp_b)  # warm-up (captures)
    t = {"batched": [], "scan": []}
    for mode in ("batched", "scan", "scan", "batched") * 2:
        t[mode].append(scan_ms(hp if mode == "scan" else hp_b))
    print(f"tracker_scan ms/frame (B={b}, steady state, K2 route, frame graph on), batched/scan/scan/batched x2: "
          f"batched {[round(v, 4) for v in t['batched']]} (min {min(t['batched']):.4f}), scan "
          f"{[round(v, 4) for v in t['scan']]} (min {min(t['scan']):.4f})")
    step_mod.free_frame_runners()
    return {"ab": t, "launches_k2_route": k2_l, "launches_staged_route": st_l, "replay_device_kernels": len(events),
            "replay_k3": seen, "frames": n_frames}


def run_stage_bench(dev):
    """stage_bench at the main path's shapes (B=128, reid bf16, chunks of
    128 crops), every stage, few reps; K1 and K2 must have launched."""
    from vehicle_counting_tpu_torch import stage_bench

    counters = kernel_counters()
    zero_counts(counters)
    res = stage_bench.main(["--device", str(dev), "--batch", "128", "--reps", "3", "--chain", "1", "--stages", "all",
                            "--reid_dtype", "bfloat16", "--max_embed", "128"])
    launches = read_counts(counters)
    missing = [st for st in stage_bench.STAGES if st not in res]
    if missing or not all(np.isfinite(v).all() and min(v) > 0 for v in res.values()):
        raise AssertionError(f"stage_bench: missing {missing} or a non-positive time in {res}")
    for name in ("crops", "cascade"):
        if launches[name] <= 0:
            raise AssertionError(f"stage_bench never launched the {name} kernel")
    print(f"stage_bench launches {launches}")
    return res, launches


def run_bench(dev):
    """bench with a short budget; parses its last two lines. K1 and K2
    must have launched."""
    from vehicle_counting_tpu_torch import bench

    env = {"BENCH_BUDGET_S": "20", "BENCH_WINDOWS": "6", "BENCH_PATIENCE": "4", "BENCH_STREAM_SWEEP": "4,1,8"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    counters = kernel_counters()
    zero_counts(counters)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            bench.main(["--device", str(dev)])
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    launches = read_counts(counters)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    print("\n".join(lines))
    telemetry, metric = json.loads(lines[-2])["telemetry"], json.loads(lines[-1])
    if set(metric) != {"metric", "value", "unit", "vs_baseline"} or not metric["value"] > 0:
        raise AssertionError(f"bench: malformed metric line {metric}")
    if metric["unit"] != "frames/sec" or metric["vs_baseline"] is not None:
        raise AssertionError(f"bench: unit/vs_baseline {metric}")
    if not (telemetry["device_resident_fps"] > 0 and telemetry["upload_gbps_best"] > 0):
        raise AssertionError(f"bench: telemetry {telemetry}")
    for name in ("crops", "cascade"):
        if launches[name] <= 0:
            raise AssertionError(f"bench never launched the {name} kernel")
    print(f"bench launches {launches}")
    return telemetry, metric, launches


def run_profile(dev, tmp, path, zones, conf, mapping):
    """The CLI with --profile on N_SWITCHED frames, then profile_summary on
    the trace it wrote. Returns the summary's numbers."""
    from vehicle_counting_tpu_torch.tools import profile_summary

    trace_dir = os.path.join(tmp, "trace")
    fps, launches, _ = run_pipeline(dev, tmp, path, zones, conf, mapping, N_SWITCHED, "out_profile",
                                    extra_args=("--profile", trace_dir, "--check_numerics", "--no_visualize"))
    trace_path = profile_summary.find_trace(trace_dir)
    print(f"trace {os.path.getsize(trace_path) / 1e6:.1f} MB")
    if profile_summary.main([trace_dir, "-n", "12", "--frames", str(N_SWITCHED)]) != 0:
        raise AssertionError("profile_summary failed")
    summ = profile_summary.summarize(profile_summary.load_device_events(trace_path), frames=N_SWITCHED)
    own = summ["by_category"].get("vct kernels (csrc/)", 0.0)
    if summ["device_kernels"] <= 0 or own <= 0:
        raise AssertionError(f"--profile: the trace shows no device kernels / none of csrc/: {summ['by_category']}")
    return {"fps_profiled": fps, "kernels_per_frame": summ["kernels_per_frame"], "busy_share": summ["busy_share"],
            "window_ms": summ["window_us"] / 1e3, "by_category_us": summ["by_category"], "launches": launches}


def run_weights(dev, tmp, path, zones):
    """The CLI with --weight and a ReID checkpoint made from seeds: a
    yolov5s state dict with ultralytics' names (.pt) and a net_dict (.t7).
    The loaded trees must be what a fold of the same arrays on the host
    gives, and the run must write its CSV."""
    import torch

    from vehicle_counting_tpu_torch.models import convert
    from vehicle_counting_tpu_torch.models.reid import load_reid_weights
    from vehicle_counting_tpu_torch.testing import fake_reid_state_dict, fake_yolov5_state_dict

    rng = np.random.default_rng(SEED + 9)
    sd = fake_yolov5_state_dict(rng, VARIANT, 80)
    pt, t7 = os.path.join(tmp, "yolov5s_seeded.pt"), os.path.join(tmp, "ckpt_seeded.t7")
    torch.save({"model": {k: torch.from_numpy(v).half() for k, v in sd.items()}, "epoch": -1}, pt)
    rsd = fake_reid_state_dict(rng)
    torch.save({"net_dict": {k: torch.from_numpy(v) for k, v in rsd.items()}, "acc": 0.5, "epoch": 3}, t7)
    tree = convert.load_yolov5_weights(pt, dev)
    half = {k: v.astype(np.float16).astype(np.float32) for k, v in sd.items()}
    w, b = convert.fuse_conv_bn(*(half[f"model.1.{n}"] for n in (
        "conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")))
    if not (np.array_equal(tree["1"]["w"].cpu().numpy(), w) and np.array_equal(tree["1"]["b"].cpu().numpy(), b)):
        raise AssertionError("--weight: layer 1 of the loaded tree is not the BN fold of the checkpoint's arrays")
    rp, rs = load_reid_weights(t7, dev)
    if not (np.array_equal(rp["layer1_0"]["conv1"]["w"].cpu().numpy(), rsd["layer1.0.conv1.weight"])
            and np.array_equal(rs["stem"]["var"].cpu().numpy(), rsd["conv.1.running_var"])):
        raise AssertionError("ReID checkpoint: the loaded tree differs from the checkpoint's arrays")
    # seeded weights score low everywhere: a low threshold gives the tracker work
    fps, launches, df = run_pipeline(dev, tmp, path, zones, 0.001, None, N_SWITCHED, "out_weights",
                                     extra_args=("--weight", pt, "--no_visualize", "--check_numerics"),
                                     reid_checkpoint=t7)
    for name in ("crops", "cascade"):
        if launches[name] <= 0:
            raise AssertionError(f"the --weight run never launched the {name} kernel")
    return {"fps": fps, "rows": len(df), "launches": launches}


def checkout_smoke(ap, root):
    """The chip_smoke module of the checkout at `root` (a directory inside
    this one), with that checkout's package first on the import path; None
    (after a message) when there is no CUDA device."""
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.realpath(root)
    if os.path.commonpath([root, here]) != here:
        ap.error(f"--root must lie inside {here}")
    import torch

    if not torch.cuda.is_available():
        print(f"chip_smoke {ap.description}: no CUDA device", file=sys.stderr)
        return None
    sys.path.insert(0, root)  # that checkout's package, before any import of it
    spec = importlib.util.spec_from_file_location("chip_smoke_of_root", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def cli_ab(argv) -> int:
    """`python3 chip_smoke.py --cli-ab [--root DIR] [--repeat 3] [--frames 256]`:
    frames/s of the default CLI run alone, for comparing two checkouts on
    one card. It drives the "pipeline" phase of the checkout at DIR (a
    directory under this one that holds an older `chip_smoke.py` and
    package, e.g. `git archive` of the parent unpacked under build/;
    default: this checkout) with that checkout's own write_video /
    calibrate / run_pipeline, once to warm up (kernel build, cuDNN plans)
    and then --repeat times, and prints one JSON line. Run it once per
    checkout and turn (parent, change, change, parent), each a process of
    its own, all in one job on the card: the host's clock differs too much
    between jobs to compare across them."""
    import argparse

    ap = argparse.ArgumentParser(description="--cli-ab: frames/s of the default CLI run of a checkout")
    ap.add_argument("--cli-ab", action="store_true")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    args = ap.parse_args(argv)
    cs = checkout_smoke(ap, args.root)
    if cs is None:
        return 2
    import torch

    root = os.path.realpath(args.root)
    dev = torch.device("cuda", 0)
    fps, launches = [], None
    with tempfile.TemporaryDirectory() as tmp:
        path, zones = cs.write_video(tmp, args.frames)
        conf, mapping = cs.calibrate(dev, path)
        for i in range(args.repeat + 1):
            got, launches, _ = cs.run_pipeline(dev, tmp, path, zones, conf, mapping, args.frames, f"out{i}")
            if i:
                fps.append(got)
    card_line = getattr(cs, "card_line", None)  # an older checkout keeps it in its chip_smoke.py
    if card_line is None:
        from vehicle_counting_tpu_torch.utils.device import card_line

    print(json.dumps({"cli_ab": {"root": root, "frames": args.frames, "fps": fps, "launches": launches,
                                 "card": card_line()}}))
    return 0


def kernel_ab(argv) -> int:
    """`python3 chip_smoke.py --kernel-ab [--root DIR]`: the K7, K1 and K6
    checks of the checkout at DIR alone (default: this checkout; DIR as for
    --cli-ab), with that checkout's own chip_smoke.py, package and kernel
    build, and one JSON line of their numbers. For holding two checkouts'
    kernels against each other on one card: one process per checkout and
    turn (parent, change, change, parent), all in one job."""
    import argparse

    ap = argparse.ArgumentParser(description="--kernel-ab: the K7, K1 and K6 checks of a checkout")
    ap.add_argument("--kernel-ab", action="store_true")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args(argv)
    cs = checkout_smoke(ap, args.root)
    if cs is None:
        return 2
    import torch

    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.utils.device import card_line

    dev = torch.device("cuda", 0)
    _build.load_all(("crops", "conv_s2", "noop"))
    for name in ("crops", "conv_s2", "noop"):
        log = _build.BUILD_LOGS.get(name, "(cached)").splitlines()
        print(f"built {name}: {[ln.strip() for ln in log if 'registers' in ln or 'spill' in ln][-4:]}")
    k7, k1, k6 = cs.check_k7(dev), cs.check_k1(dev), cs.check_k6(dev)
    print(json.dumps({"kernel_ab": {"root": os.path.realpath(args.root), "k1": k1, "k6": k6, "k7": k7, "card": card_line()}}))
    return 0


def main() -> int:
    if "--cli-ab" in sys.argv[1:]:
        return cli_ab(sys.argv[1:])
    if "--kernel-ab" in sys.argv[1:]:
        return kernel_ab(sys.argv[1:])
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the card", file=sys.stderr)
        return 2
    try:
        from vehicle_counting_tpu_torch import _build
        from vehicle_counting_tpu_torch.utils.device import card_line, get_devices_info
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable from {os.getcwd()}: {e}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    print(get_devices_info())
    t_start = time.perf_counter()

    phase("build", card)
    t0 = time.perf_counter()
    _build.load_all(KERNELS)
    for name in KERNELS:
        log = _build.BUILD_LOGS.get(name, "(cached)").splitlines()
        print(f"built {name}: {[ln.strip() for ln in log if 'registers' in ln or 'spill' in ln][-4:]}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    phase("K7 launch-cost probe kernel", card)
    k7 = check_k7(dev)
    phase("K1 crop gather", card)
    k1 = check_k1(dev)
    phase("K1 at source resolution (the raw-RGB crop source)", card)
    k1_src = check_k1_source(dev)
    phase("K2/K3 association", card)
    k2 = check_k2(dev)
    phase("K3, the per-class entry (class_mode scan)", card)
    k3 = check_k3(dev)
    phase("K4 batched assignment", card)
    k4 = check_k4(dev)
    phase("K5 fused ReID stage-1 block", card)
    k5 = check_k5(dev)
    phase("embed A/B: ReID embed with K5 off and on", card)
    emb = embed_ab(dev)
    phase("K6 layer-1 conv", card)
    k6 = check_k6(dev)

    with tempfile.TemporaryDirectory() as tmp:
        path, zones = write_video(tmp)
        path_sw, zones_sw = write_video(tmp, N_SWITCHED, "cam_switched")
        phase("calibration", card)
        conf, mapping = calibrate(dev, path)
        print(f"min_conf {conf:.6f}, mapping {mapping}")
        phase("pipeline", card)
        from vehicle_counting_tpu_torch.tracking import graph as graph_mod

        graph_mod.warmup_launches.clear()
        fps, launches, df = run_pipeline(dev, tmp, path, zones, conf, mapping)
        warmup = {"cascade": graph_mod.warmup_launches.get("cascade_match_classparallel", 0)}
        print(f"beside the {launches['cascade']} K2 launches that advanced the tracker, the capture's warm-up made "
              f"{warmup['cascade']} on scratch state")
        for name in ("crops", "cascade"):
            if launches[name] <= 0:
                raise AssertionError(f"the main path never launched the {name} kernel")
        if launches["cascade"] != N_FRAMES:
            raise AssertionError(f"the main path replays one K2 launch per frame: {launches['cascade']} for {N_FRAMES} frames")
        phase("pipeline A/B: the CLI with the frame graph off / off / on", card)
        cli_fps = run_cli_ab(dev, tmp, path, zones, conf, mapping, df, fps)
        phase("switched pipeline: fused ReID block + staged association", card)
        graph_mod.warmup_launches.clear()
        launches_sw, df_sw = run_switched(dev, tmp, path_sw, zones_sw, conf, mapping)
        warmup["match_stage"] = graph_mod.warmup_launches.get("match_stage_batched", 0)
        n_default = df[df.frame_id < N_SWITCHED].track_id.nunique() if len(df) else 0
        n_switched = df_sw.track_id.nunique() if len(df_sw) else 0
        print(f"tracks in the zone over the first {N_SWITCHED} frames: switched run {n_switched}, "
              f"default run {n_default} (not asserted equal: K5 rounds each block's output to bf16)")
        phase("layer-1 path (K6, stand-alone)", card)
        launches_k6 = run_layer1_path(dev, path)
        phase("compacted stage path (K4 insert_rows, stand-alone)", card)
        launches_ins = run_compacted_stage_path(dev)
        phase("detect-only: the CLI with --detect_only", card)
        fps_det, launches_det, rows_det = run_detect_only(dev, tmp, path, zones, conf, mapping)
        phase("raw-rgb: the CLI with thin_upload: false", card)
        launches_raw, fps_raw = run_raw_rgb(dev, tmp, path_sw, zones_sw, conf, mapping)
        phase("parity", card)
        scan = check_parity(dev, path)
        phase("parity of the detect-only and RGB fronts", card)
        front = check_front_parity(dev, path)
        phase("frame graph: graph == eager loop on both routes, tracker A/B", card)
        fg = check_frame_graph(dev, path, conf, mapping)
        phase("scan: class_mode scan, graph == eager, scan == batched, K3 per class", card)
        sc = check_scan(dev, fg)
        del fg["batches"], fg["runs"]
        phase("--profile CLI run + profile_summary", card)
        prof = run_profile(dev, tmp, path_sw, zones_sw, conf, mapping)
        phase("--weight CLI run (seeded .pt + .t7)", card)
        wts = run_weights(dev, tmp, path_sw, zones_sw)

    phase("stage_bench", card)
    stages, launches_stage = run_stage_bench(dev)
    phase("bench", card)
    telemetry, metric, launches_bench = run_bench(dev)

    floor_ms = k7["probe"]["bare_launch_us"] / 1e3
    kernels = [
        dict(name="crop_gather", route="cuda", source="vehicle_counting_tpu_torch/csrc/crops.cu",
             replaces="vehicle_counting_tpu/ops/pallas/crops.py:240", launches=launches["crops"],
             launches_bench=launches_bench["crops"], launches_stage_bench=launches_stage["crops"],
             launches_raw_rgb=launches_raw["crops"], source_720p=k1_src, **k1),
        dict(name="cascade_match", route="cuda", source="vehicle_counting_tpu_torch/csrc/cascade.cu",
             replaces="vehicle_counting_tpu/ops/pallas/cascade.py:887", launches=launches["cascade"],
             launches_bench=launches_bench["cascade"], launches_stage_bench=launches_stage["cascade"],
             launches_raw_rgb=launches_raw["cascade"], launches_per_frame=launches["cascade"] / N_FRAMES,
             warmup_launches=warmup["cascade"], replay_in_trace=fg["replay_in_trace"]["k2"], **k2),
        dict(name="cascade_match_batched", route="cuda", source="vehicle_counting_tpu_torch/csrc/cascade.cu",
             replaces="vehicle_counting_tpu/ops/pallas/cascade.py:379", launches=sc["launches_k2_route"]["cascade_k3"],
             path="class_mode scan (the graph phase's frames)", launches_per_frame=sc["launches_k2_route"]["cascade_k3"]
             / sc["frames"], launches_default_path=launches["cascade_k3"], replay_k3=sc["replay_k3"], **k3),
        dict(name="insert_rows", route="cuda", source="vehicle_counting_tpu_torch/csrc/assignment.cu",
             replaces="vehicle_counting_tpu/ops/pallas/assignment.py:179", launches=launches_ins,
             path="compacted stage stand-alone", launches_switched=launches_sw["insert_rows"],
             **{k: v for k, v in k4.items() if k != "match_stage"}),
        dict(name="match_stage", route="cuda", source="vehicle_counting_tpu_torch/csrc/assignment.cu",
             replaces="vehicle_counting_tpu/ops/pallas/assignment.py:179", launches=launches_sw["match_stage"],
             path="switched", launches_per_frame=launches_sw["match_stage"] / N_SWITCHED,
             launches_graph_256_frames=fg["launches_staged_route"]["match_stage"],
             warmup_launches=warmup["match_stage"], replay_in_trace=fg["replay_in_trace"]["staged"],
             **k4["match_stage"]),
        dict(name="reid_block64", route="cuda", source="vehicle_counting_tpu_torch/csrc/reid_block.cu",
             replaces="vehicle_counting_tpu/ops/pallas/reid_block.py:139", launches=launches_sw["reid_block"],
             path="switched", **k5),
        dict(name="conv1_s2_silu", route="cuda", source="vehicle_counting_tpu_torch/csrc/conv_s2.cu",
             replaces="vehicle_counting_tpu/ops/pallas/conv_s2.py:181", launches=launches_k6,
             path="layer-1 stand-alone", **k6["bfloat16"], edges=k6["bfloat16_edges"], f32=k6["float32"]),
        dict(name="noop_add1", route="cuda", source="vehicle_counting_tpu_torch/csrc/noop.cu",
             replaces="benchmarks/micro/noop_launch.py:14", path="launch-cost probe", **k7),
    ]
    for k in kernels:
        k["launch_floor_ms"] = floor_ms  # the bare ctypes launch of K7, this run
    print(f"pipeline frames/s: {fps:.2f} [{card}]")
    print(f"embed ms/frame, bf16: K5 off {emb['off']:.4f}, K5 on {emb['on']:.4f} [{card}]")
    print(f"tracker ms/frame, f32 B=16: K2 route min {min(scan['k2']):.4f}, staged route min "
          f"{min(scan['staged']):.4f} [{card}]")
    print(f"tracker_scan ms/frame, B=128 steady state, frame graph off / on: {json.dumps(fg['ab'])} [{card}]")
    print(f"CLI frames/s, frame graph off / on: {json.dumps(cli_fps)} [{card}]")
    print(f"detect-only CLI frames/s ({N_FRAMES} frames, cold): {fps_det:.2f}, {rows_det} rows [{card}]")
    print(f"CLI frames/s over {N_SWITCHED} frames without the MP4 pass, thin I420 / raw RGB: {json.dumps(fps_raw)} [{card}]")
    print(f"tracker_scan ms/frame, B=128 steady state, graph on, batched / scan: {json.dumps(sc['ab'])} [{card}]")
    print(f"K1 on the raw 720x1280 source: {json.dumps(k1_src)} [{card}]")
    print(f"launch cost, us: {json.dumps(k7['probe'])} [{card}]")
    print(f"stage_bench ms/frame (min, median): {json.dumps(stages)} [{card}]")
    print(f"bench: {json.dumps(metric)}; streamed p50 {telemetry['p50_fps']} min {telemetry['min_fps']} best "
          f"{telemetry['best_fps']}, device-resident {telemetry['device_resident_fps']} frames/s, upload GB/s best "
          f"{telemetry['upload_gbps_best']} p50 {telemetry['upload_gbps_p50']}, p50 by stream count "
          f"{telemetry['upload_gbps_p50_by_streams']} [{card}]")
    print(f"--profile run: {json.dumps(prof)} [{card}]")
    print(f"--weight run: {json.dumps(wts)} [{card}]")
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
