#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (vehicle_counting_tpu_torch).

    python3 chip_smoke.py            # from the repository root, one CUDA card
    python3 chip_smoke.py --cli-ab   # only the CLI's frames/s, repeated (see cli_ab)
    python3 chip_smoke.py --kernel-ab [--root DIR]   # only the K1, K6, K7 checks of a checkout (see kernel_ab)
    python3 chip_smoke.py --multi-card   # two or more cards: frame-parallel, cameras and the fleet across them (see multi_card)
    python3 chip_smoke.py --k5-parent DIR   # the default run, with the K5 of the checkout at DIR beside this one

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
  K4 solve  K4 through `tracking.solve_assignment` on full [N, M] costs
            (tests/test_assignment.py's shapes and their transposes, the
            masked-rows case, 1023 x 1023, 300 x 1023, 1023 x 300):
            array-equal to the CPU's plain solve, total cost scipy's to
            1e-5, one K4 launch per call, [1024, 1024] refused; one call's
            ms per shape against scipy's on the host;
  K5        fused ReID stage-1 block vs its plain version: bf16 at N=128
            (the embed's launch) and N=3840 (128 frames x 30), with cuDNN's
            bf16 block timed beside them, batch invariance (bitwise), the
            cached packed weights against a fresh pack (bitwise); f32 at
            N=1, 133 (batch invariance) and 3840 with its device time,
            bound and cuDNN's f32 block; with `--k5-parent DIR` the K5 of
            the checkout at DIR: its bf16 output == this one's, bitwise,
            its f32 kernel timed in turns with this one; each variant's
            ptxas registers and shared memory;
  embed     the ReID embed at the main path's shapes with K5 off and on;
  K8        the ReID trunk's BN epilogue vs its plain version (the eager
            chain it replaces), bitwise, every option at the stem's and
            each stage's shape, f32 / bf16 input, NCHW / channels-last, N =
            1, 37, 128; kernel and plain chain in turns, device time (L2
            flushed) against the byte bound, above 105 % a failure; the
            wrapper's host cost; the embedding bitwise
            against the plain chain's with 20 / 16 launches per forward (K5
            off / on); device kernels per chunk of the step's embed;
  K6        layer-1 conv (3x3 s2, 32->64, SiLU) vs its plain version at
            [128, 192, 320, 32] bf16, [3, 64, 128, 32] bf16 (edge tiles) and
            a small f32 shape, with the library call (F.conv2d channels-last
            + F.silu) timed beside it, and for bf16 the wrapper with its
            cached packed weights against packing on every call (bitwise,
            in turns); the bf16 variant's ptxas registers, shared memory
            and HGMMA count;
  K7        the launch-cost probe kernel vs its plain version, array-equal,
            then the probe itself: us per launch eager and in a captured
            CUDA graph, for the kernel and the torch equivalent, and the
            bare ctypes launch;
  pipeline  the CLI main path on a synthetic 256-frame 1280x720 video:
            yolov5s random init, default config (detect_batch 128, bf16),
            a calibrated min_conf and a 4-class mapping; asserts the CSV and
            MP4 and that both of its kernels (K1, K2) were launched, K2 once
            per frame (the tracker's frame step is replayed from a CUDA
            graph), K8 20 times per K1 launch (each chunk's ReID forward);
            then the same run with the graph off, off and on: equal
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
  multicam  (a) K2 at C = 4 classes x 8 cameras, bitwise on random, tie,
            empty and steady problems, eager and graph-node ms; (d) the
            tracker's frame step at N_cam x C = 4, 16, 32 classes (B=128,
            steady, graph on), ms/frame and one replay's device kernels;
            (b) one f32 multi-camera step of 4 cameras x B=8 on the card ==
            the card's serial steps per camera == the CPU; (c) the CLI with
            --multicam over 4 videos (128, 128, 128, 96 frames): CSVs and
            MP4s, K1 launched, K2 once per frame-round for all cameras, no
            K3; each camera's CSV against the serial CLI's; camera-frames/s
            of both in turns;
  camera mesh  the camera-sharded step over a mesh that repeats cuda:0
            twice: f32, 3 cameras padded to 4, 2 x B=8, every state leaf
            and track output bitwise == the unsharded step; two frame
            runners (one per shard), K2 launched twice per frame-round;
            then `MultiCamCountingPipeline` over that mesh on the
            multi-camera videos: each CSV row for row against (c)'s;
  framedp   (a) the frame-parallel step on a mesh of [cuda:0] == the serial
            step, bitwise on every output and state leaf (f32, 2 x B=8,
            720p I420); (b) on [cuda:0, cuda:0] == the serial step at B/2
            with the states chained on track ids, mask, boxes, det classes
            and valid and the integer state leaves; K1 launched by each
            shard, K2 once per frame; serial and two-shard ms per batch in
            turns; (c) the CLI with --frame_parallel (a no-op on one card):
            the default run's CSV rows and launches;
  serving   (d) `serving.cli export` at bf16, B=128, 720p I420, weights
            bundled; `verify` in a fresh process: bit_exact, K1 and K2
            loaded from the artifact's kernels/ and launched by its step,
            live and artifact ms per batch; `smoke` in a fresh process,
            frames/s; a detect-only artifact's smoke;
  multihost (e) a one-rank NCCL group through initialize_multihost: the
            host_local_to_global / global_to_host_local round trip of
            (b)'s outputs;
  stage     stage_bench at B=128 (reid bf16, chunks of 128), every stage;
  bench     bench with a short budget; its metric line is parsed;
  profile   the CLI with --profile on 128 frames, then profile_summary on
            the trace it wrote, with its convolution roofline (--convs);
  weights   the CLI with --weight and a ReID checkpoint, both made from
            seeds (an ultralytics-named .pt state dict and a .t7);
  weight cache  the CLI without --weight from a directory whose ./.cache
            holds that .pt as yolov5s.pt: the --weight run's CSV row for
            row and its K1 / K2 launches; then from an empty directory: the
            fetch fails and the detector is the seed-0 random init;
  reid-train  5 ReID train steps (B=16, 8 classes) on the card against
            the CPU with the same init, batches and dropout draws: f32 (TF32
            off) to a stated tolerance, f64 to 1e-8 of each gradient's
            size; then the recipe's shapes (B=64, 751 classes, augmentation
            on the card): train_step ms and images/s, extract_features at
            B=512 with cuDNN and through K5's f32 parity mode (2 launches
            per call, against cuDNN's);
  reid_cli  2 epochs on a synthetic ImageFolder (rc 0, new_ckpt.npz,
            train.jpg, the history), then --resume from the saved epoch;
            whether matplotlib imports;
  tools     e2e_smoke on 48 frames of 720p with a seeded .pt as --weight,
            the soak at 1024 frames (fps first / last sample, RSS growth,
            peak device memory), the egress_day dry run on seeded fake
            checkpoints, and graft_entry.entry() once.
Each kernel's bound (the least time the card could take: bytes over
3.35 TB/s or operations over the peak rate of their type, whichever is
larger) is computed from the checked call's inputs.
No URL is fetched: the process refuses every fetch before any phase, so
the pipeline's weight resolution (./.cache, a fetch, random init) ends in
random init without contacting an outside host, as it would on a machine
with no network; subprocesses that build a pipeline get --weight.
Prints the card, a kernel JSON line, and last {"ok": true, "device": ...}.
Exits non-zero without printing a result when there is no CUDA device or
the package is missing.
"""

import collections
import contextlib
import io
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np

SEED = 0
SRC_HW = (720, 1280)
N_FRAMES = 256
N_SWITCHED = 128
VARIANT = "yolov5s"
KERNELS = ("crops", "cascade", "assignment", "reid_block", "conv_s2", "noop", "reid_epilogue", "track_frame")
MC_FRAMES = (128, 128, 128, 96)  # the multi-camera CLI's videos
MC_K2_CAMS = 8  # cameras of K2's camera-axis check: C = 4 x 8 blocks
FP_B = 8  # frames per batch of the frame-parallel checks (f32)
SERVE_BATCHES = 4  # chained batches of serving.cli verify and smoke

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


def host_ms(fn, n=3):
    """Mean ms per call of n calls on the host clock, every card synchronised
    before and after (a step may span several cards)."""
    import torch

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / n


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


SA_SHAPES = ((1, 1), (3, 3), (5, 8), (8, 8), (16, 16), (32, 40))  # tests/test_assignment.py's
SA_LARGE = ((1023, 1023), (300, 1023), (1023, 300))  # up to K4's MAX_S


@contextlib.contextmanager
def count_calls(module, name, counter):
    """Counts the calls of module.<name> in counter["calls"] for the block."""
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counter["calls"] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield counter
    finally:
        setattr(module, name, fn)


def check_solve_assignment(dev):
    """K4's third route: `tracking.solve_assignment` on full [N, M] f32
    costs, padded to a square and solved in one `insert_rows` launch (no
    host sync), over tests/test_assignment.py's shapes and their
    transposes, the masked-rows case, [1023, 1023], [300, 1023] and [1023,
    300]: array-equal to the plain version on the CPU, its total cost
    scipy's to 1e-5, exactly one K4 launch per call; [1024, 1024] raises
    on the card. Times one call per shape (CUDA events) against scipy on
    the host. Bound: the cost read once and the rows written, or 8 f32
    operations per column per Dijkstra step of this data (the plain
    version's steps, counted), whichever is larger."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from vehicle_counting_tpu_torch.ops import assignment
    from vehicle_counting_tpu_torch.tracking import solve_assignment
    from vehicle_counting_tpu_torch.tracking.assignment import BIG

    rng = np.random.default_rng(SEED + 11)
    cases = []
    for n, m in SA_SHAPES:
        cost = rng.uniform(0, 1, (n, m)).astype(np.float32)
        cases += [(f"{n}x{m}", cost), (f"{n}x{m}^T", np.ascontiguousarray(cost.T))]
    masked = np.full((4, 4), BIG, np.float32)  # 2 real rows, 2 BIG rows, 3 real columns
    masked[:2, :3] = np.minimum(rng.uniform(0, 0.5, (2, 3)), 0.2 + 1e-5)
    cases.append(("masked 4x4", masked))
    cases += [(f"{n}x{m}", rng.random((n, m), dtype=np.float32)) for n, m in SA_LARGE]

    want, steps, plain_ms = {}, {}, {}
    for name, cost in cases:  # the plain version on the CPU, its Dijkstra steps counted
        with count_calls(torch, "argmin", {"calls": 0}) as c:
            t0 = time.perf_counter()
            want[name] = solve_assignment(torch.from_numpy(cost))
            plain_ms[name] = (time.perf_counter() - t0) * 1e3
        steps[name] = c["calls"]
    gpu = {name: torch.from_numpy(cost).to(dev) for name, cost in cases}
    torch.cuda.synchronize()
    assignment.insert_rows_batched.launches = 0
    got = {name: solve_assignment(gpu[name]) for name, _ in cases}
    torch.cuda.synchronize()
    launches = assignment.insert_rows_batched.launches
    if launches != len(cases):
        raise AssertionError(f"solve_assignment: {launches} K4 launches for {len(cases)} calls, want one per call")
    rows = []
    for name, cost in cases:
        g = got[name]
        if g.device != gpu[name].device or g.dtype != torch.int64 or not torch.equal(g.cpu(), want[name]):
            raise AssertionError(f"solve_assignment {name}: the card's {g.dtype} on {g.device} differs from the CPU's")
        r2c = g.cpu().numpy()
        t0 = time.perf_counter()
        ri, ci = linear_sum_assignment(cost)
        scipy_ms = (time.perf_counter() - t0) * 1e3
        total, want_total = cost[r2c >= 0, r2c[r2c >= 0]].astype(np.float64).sum(), cost[ri, ci].astype(np.float64).sum()
        if (r2c >= 0).sum() != min(cost.shape) or abs(total - want_total) > 1e-5:
            raise AssertionError(f"solve_assignment {name}: total {total} against scipy's {want_total}")
        n, m = cost.shape
        s = max(n, m)
        ms = cuda_ms(lambda: solve_assignment(gpu[name]), 5)
        bd = bound(nbytes(gpu[name], g), 8 * s * steps[name], F32_FLOPS)
        rows.append({"shape": name, "ms": ms, "plain_ms": plain_ms[name], "scipy_ms": scipy_ms,
                     "dijkstra_steps": steps[name], "total_minus_scipy": total - want_total, **bd})
    try:
        solve_assignment(torch.zeros((1024, 1024), device=dev))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("solve_assignment took a [1024, 1024] cost on the card: past K4's MAX_S it must raise")
    for r in rows:
        print(f"solve_assignment {r['shape']}: array-equal to the CPU, total - scipy's {r['total_minus_scipy']:.2e}; "
              f"K4 {r['ms']:.4f} ms, plain (host CPU) {r['plain_ms']:.2f} ms, scipy (host) {r['scipy_ms']:.4f} ms; "
              f"{r['dijkstra_steps']} Dijkstra steps, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    print(f"solve_assignment: {len(cases)} calls, {launches} K4 launches (one per call); [1024, 1024] raised: {refused}")
    top = rows[-len(SA_LARGE)]  # [1023, 1023]
    return {"launches": launches, "calls": len(cases), "max_abs_err": 0.0, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "scipy_ms": top["scipy_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None, "shape": top["shape"], "refused_1024": refused,
            "shapes": rows}


def check_k5(dev, parent=None):
    """bf16 rtol 1.6e-2 / atol 1e-2, f32 atol 1e-4: the tolerances of
    tests/test_torch_reid_block.py. bf16 at the embed's launch (N=128, a
    128-crop chunk) and at a 128-frame batch's crops (N=3840), each beside
    the plain version and, for information, cuDNN's bf16 block
    (testing.reid_block_eager: cuDNN and the eager op chain, the embed's
    block with K5 off before K8); the
    cached packed weights against a fresh pack, bitwise; then the f32 mode
    (`check_k5_f32`), with the kernel of the checkout at `parent` beside it
    when one is given."""
    import torch

    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.models.convert import reid_block64_from_jax, reid_params_from_jax
    from vehicle_counting_tpu_torch.models.reid import cast_conv_weights
    from vehicle_counting_tpu_torch.ops import reid_block
    from vehicle_counting_tpu_torch.testing import reid_block_eager, reid_block_params

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
    pf, sf = reid_params_from_jax(p, s, dev)
    pb = cast_conv_weights(pf, torch.bfloat16)
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
        t_cudnn = cuda_ms(lambda: reid_block_eager(pb, sf, xf, 1, torch.bfloat16), reps)
        dev_k = device_events(lambda: reid_block.reid_block64(x, *wts))
        dev_k5 = sum(ms for name, ms in dev_k if "reid_block_bf16" in name)
        dev_plain = sum(ms for _, ms in device_events(lambda: reid_block.reid_block64_plain(x, *wts)))
        print(f"K5 bfloat16 N={n}: max |diff| {err:.3e} ({bf16_tol}); kernel {t_k:.4f}/{t_k2:.4f} ms, "
              f"plain {t_plain:.4f}/{t_plain2:.4f} ms; cuDNN bf16 block (information) {t_cudnn:.4f} ms; "
              f"device time of one call (torch.profiler): K5 {dev_k5:.4f} ms + the wrapper's other ops "
              f"{sum(ms for _, ms in dev_k) - dev_k5:.4f} ms in {len(dev_k) - 1} kernels, plain {dev_plain:.4f} ms")
        # two 3x3 64->64 convs on 25x25: 2 * 625 * 64 * 64 * 9 MACs per crop; x and out once, weights and BN once
        bd = bound(2 * nbytes(x) + nbytes(*wts), 2 * 2 * 625 * 64 * 64 * 9 * n, BF16_FLOPS)
        print(f"K5 bfloat16 N={n}: bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}), device time is "
              f"{100 * bd['bound_ms'] / dev_k5:.1f} % of it")
        res[n] = {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2), "cudnn_bf16_ms": t_cudnn,
                  "device_ms": dev_k5, "wrapper_device_ops": len(dev_k) - 1, "plain_device_ms": dev_plain, **bd,
                  "library_ms": t_cudnn}
    # N=1, and N=133 where some blocks take two crops; no atomics, no state
    # across crops: a crop's output does not depend on the launch
    for n in (1, 133):
        x = x32[:n].to(torch.bfloat16)
        got = reid_block.reid_block64(x, *wts)
        torch.testing.assert_close(got.float(), reid_block.reid_block64_plain(x, *wts).float(), **bf16_tol)
    if not torch.equal(got[:4], reid_block.reid_block64(x[:4].contiguous(), *wts)):
        raise AssertionError("K5 bf16: the first 4 crops of an N=133 launch differ from an N=4 launch")
    print("K5 bfloat16 N=1 and N=133 within tolerance; batch-invariant: crops 0-3 of N=133 == N=4, bitwise")
    # the wrapper's kept pack against one made now, and the kept pack is what the kernel reads
    x = x32[:128].to(torch.bfloat16)
    ab = torch.stack(wts[2:]).float().contiguous()
    fresh = reid_block._launch_kernel(x, reid_block.pack_weights(*wts[:2]), ab)
    if not torch.equal(reid_block.reid_block64(x, *wts), fresh):
        raise AssertionError("K5 bf16: output with the cached packed weights differs from a fresh pack's")
    if reid_block.kernel_weights(*wts[:2], torch.bfloat16) is not reid_block.kernel_weights(*wts[:2], torch.bfloat16):
        raise AssertionError("K5: the packed weights of unchanged tensors were packed again")
    t_fresh = cuda_ms(lambda: reid_block._launch_kernel(x, reid_block.pack_weights(*wts[:2]), ab), 50)
    t_cached = cuda_ms(lambda: reid_block.reid_block64(x, *wts), 50)
    print(f"K5 bfloat16 N=128: cached pack == fresh pack, bitwise; wrapper {t_cached:.4f} ms with the cache, "
          f"{t_fresh:.4f} ms packing per call")
    res[128].update(uncached_ms=t_fresh, cached_ms=t_cached)
    old = parent_k5(parent) if parent else None
    if old:  # the bf16 kernel is the parent's: the same bits
        for n in (128, 3840):
            x = x32[:n].to(torch.bfloat16)
            if not torch.equal(old[0](x, *wts[:2], ab), reid_block.reid_block64(x, *wts)):
                raise AssertionError(f"K5 bf16 N={n}: output differs from the parent checkout's kernel")
        print("K5 bfloat16 N=128 and N=3840: bitwise equal to the parent checkout's kernel")
    f32 = check_k5_f32(dev, x32, wts, pf, sf, old)
    return {**res[128], "n": 128, "n3840": res[3840], "f32": f32}


def parent_k5(root):
    """The K5 kernels of the checkout at `root` as they stood before the f32
    redesign: built with this checkout's nvcc flags into build/parent_k5/,
    called through their C interface (x, x zero-padded to 27 x 27 for f32,
    w1, w2: HWIO f32, or pack_weights' two slabs for bf16, ab, out, N,
    bf16, stream) as their wrapper called them. -> (launch(x, w1, w2, ab)
    -> out, its ptxas report)."""
    import ctypes
    import subprocess

    import torch
    import torch.nn.functional as F

    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.ops.reid_block import pack_weights

    src = os.path.join(os.path.abspath(root), "vehicle_counting_tpu_torch", "csrc", "reid_block.cu")
    lib_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parent_k5")
    os.makedirs(lib_dir, exist_ok=True)
    path = os.path.join(lib_dir, "libreid_block_parent.so")
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", path, src], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for the parent's {src}:\n{done.stderr}")
    fn = ctypes.CDLL(path).vct_reid_block64
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def launch(x, w1, w2, ab):
        bf16 = x.dtype == torch.bfloat16
        xpad = None if bf16 else F.pad(x, (1, 1, 1, 1))
        wa, wb = pack_weights(w1, w2) if bf16 else (w1, w2)
        out = torch.empty_like(x)
        _build.check(fn(x.data_ptr(), None if bf16 else xpad.data_ptr(), wa.data_ptr(), wb.data_ptr(), ab.data_ptr(),
                        out.data_ptr(), x.shape[0], int(bf16), _build.current_stream(x.device)),
                     "the parent's reid block kernel")
        return out

    report = [ln.split("ptxas info    :")[-1].strip() for ln in done.stderr.splitlines() if "Used" in ln]
    return launch, report


def check_k5_f32(dev, x32, wts, pf, sf, parent=None, reps=10):
    """K5's f32 mode (the trainer's extract_features with the block
    switched on) against its plain version at atol 1e-4: N = 1, 133
    (crops 0-3 == an N = 4 launch, bitwise) and 3840. At N = 3840 the
    wrapper's and the plain version's times in turns, the kernel's device
    time against its bound, the library call (cuDNN's f32 block and the
    eager op chain, testing.reid_block_eager, TF32 off) and, with `parent` (what
    `parent_k5` returns), the parent's f32 kernel in turns with this one."""
    import torch

    from vehicle_counting_tpu_torch.ops import reid_block
    from vehicle_counting_tpu_torch.testing import reid_block_eager

    tol = dict(rtol=0, atol=1e-4)
    for n in (1, 133):
        x = x32[:n]
        got = reid_block.reid_block64(x, *wts)
        torch.testing.assert_close(got, reid_block.reid_block64_plain(x, *wts), **tol)
    if not torch.equal(got[:4], reid_block.reid_block64(x32[:4], *wts)):
        raise AssertionError("K5 f32: the first 4 crops of an N=133 launch differ from an N=4 launch")
    print("K5 float32 N=1 and N=133 within atol 1e-4; batch-invariant: crops 0-3 of N=133 == N=4, bitwise")
    args = (x32, *wts)
    got = reid_block.reid_block64(*args)
    want = reid_block.reid_block64_plain(*args)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **tol)
    t_plain = cuda_ms(lambda: reid_block.reid_block64_plain(*args), reps)
    t_k = cuda_ms(lambda: reid_block.reid_block64(*args), reps)
    t_k2 = cuda_ms(lambda: reid_block.reid_block64(*args), reps)
    t_plain2 = cuda_ms(lambda: reid_block.reid_block64_plain(*args), reps)
    t_lib = cuda_ms(lambda: reid_block_eager(pf, sf, x32, 1, torch.float32), reps)
    lib_err = float((reid_block_eager(pf, sf, x32, 1, torch.float32) - want).abs().max())
    t_lib2 = cuda_ms(lambda: reid_block_eager(pf, sf, x32, 1, torch.float32), reps)

    def k5_device(launch):
        ev = device_events(launch)
        k = [ms for name, ms in ev if "reid_block_f32" in name]
        if len(k) != 1:
            raise AssertionError(f"K5 f32: {len(k)} reid_block_f32 kernels among one call's device events {ev}")
        return k[0], sum(ms for _, ms in ev) - k[0], len(ev) - 1

    dev_k, dev_other, n_other = k5_device(lambda: reid_block.reid_block64(*args))
    dev_lib = sum(ms for _, ms in device_events(lambda: reid_block_eager(pf, sf, x32, 1, torch.float32)))
    # x and out once, weights and BN once; two 3x3 64->64 convs on 25x25 per crop, f32 FMA on the CUDA cores
    bd = bound(2 * nbytes(x32) + nbytes(*wts), 2 * 2 * 625 * 64 * 64 * 9 * x32.shape[0], F32_FLOPS)
    print(f"K5 float32 N=3840: max |diff| {err:.3e} (atol 1e-4); wrapper {t_k:.4f}/{t_k2:.4f} ms, plain "
          f"{t_plain:.4f}/{t_plain2:.4f} ms, library (cuDNN f32 block, TF32 off) {t_lib:.4f}/{t_lib2:.4f} ms "
          f"(max |diff| vs plain {lib_err:.3e}); device time (torch.profiler): K5 {dev_k:.4f} ms + the wrapper's "
          f"other ops {dev_other:.4f} ms in {n_other} kernels, library {dev_lib:.4f} ms; bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}), device time is {100 * bd['bound_ms'] / dev_k:.1f} % of it")
    out = {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2), "n": 3840, "device_ms": dev_k,
           "wrapper_device_ops": n_other, **bd, "bound_share": bd["bound_ms"] / dev_k, "library_ms": min(t_lib, t_lib2),
           "library_device_ms": dev_lib}
    if parent:
        launch, report = parent
        w1, w2, ab = wts[0], wts[1], torch.stack(wts[2:]).float().contiguous()
        old = launch(x32, w1, w2, ab)
        torch.testing.assert_close(old, want, **tol)
        t, d = {"parent": [], "change": []}, {"parent": [], "change": []}
        runs = {"parent": lambda: launch(x32, w1, w2, ab), "change": lambda: reid_block.reid_block64(*args)}
        for who in ("parent", "change", "change", "parent"):
            t[who].append(cuda_ms(runs[who], reps))
            d[who].append(k5_device(runs[who])[0])
        print(f"K5 float32 N=3840, the parent's kernel (ptxas {report}) against this checkout's, in "
              f"turns (parent, change, change, parent): wrapper ms parent {t['parent']}, change {t['change']}; "
              f"device ms parent {d['parent']}, change {d['change']}")
        out["parent"] = {"ms": t["parent"], "device_ms": d["parent"], "change_ms": t["change"],
                         "change_device_ms": d["change"], "ptxas": report}
    return out


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
                reid.reid_embed(rp, rs, crops[i : i + chunk], dtype=torch.bfloat16)

    old, t = reid.FORCE_PALLAS_REID_BLOCK, {False: [], True: []}
    try:
        for on in (False, True, True, False) * 2:  # the host's clock wanders: 4 turns each
            reid.FORCE_PALLAS_REID_BLOCK = on
            reid_block.reid_block64.launches = 0
            t[on].append(cuda_ms(embed, 5) / n_frames)
            if bool(reid_block.reid_block64.launches) != on:
                raise AssertionError(f"embed A/B: K5 {'on' if on else 'off'}, {reid_block.reid_block64.launches} launches")
        print(f"embed ms/frame ({n_frames} frames x {per_frame} crops, chunks of {chunk}, bf16): "
              f"K5 off {[round(v, 4) for v in t[False]]}, K5 on {[round(v, 4) for v in t[True]]}")
        for on in (False, True):  # how much of that wall time the card is busy
            reid.FORCE_PALLAS_REID_BLOCK = on
            ev = device_events(embed)
            k5 = sum(ms for name, ms in ev if "reid_block_bf16" in name)
            total = sum(ms for _, ms in ev) / n_frames
            print(f"embed K5 {'on' if on else 'off'}: device busy {total:.4f} ms/frame "
                  f"({100 * total / min(t[on]):.1f} % of the best wall time; torch.profiler), "
                  f"K5 kernel {k5 / n_frames:.4f} ms/frame, {len(ev) / n_frames:.2f} device ops/frame")
    finally:
        reid.FORCE_PALLAS_REID_BLOCK = old
    return {"off": min(t[False]), "on": min(t[True])}


@contextlib.contextmanager
def _reid_trunk_as(plain_epilogue=False, eager_conv_weights=False):
    """The ReID trunk with the plain chain in K8's place and / or each
    convolution taking its OIHW weight as it is (F.conv2d relayouts it per
    call): both set, the parent's trunk, op for op."""
    import torch.nn.functional as F

    from vehicle_counting_tpu_torch.models import reid
    from vehicle_counting_tpu_torch.ops import reid_epilogue as ep

    kept = reid.reid_epilogue, reid._conv
    if plain_epilogue:
        reid.reid_epilogue = ep.reid_epilogue_plain
    if eager_conv_weights:
        reid._conv = lambda x, w, stride, padding, dtype: F.conv2d(x.to(dtype), w.to(dtype), stride=stride,
                                                                   padding=padding)
    try:
        yield
    finally:
        reid.reid_epilogue, reid._conv = kept


def check_reid_epilogue(dev):
    """K8, the ReID trunk's BN epilogue: the kernel against its plain
    version (the eager chain it replaces), bitwise, at the stem's shape and
    each stage's for every option (testing.EPILOGUE_CASES), f32 and bf16
    input, NCHW and channels-last, N = 1, 37 and 128; its time against the
    plain chain's in turns, device time (each call after a read that
    evicts L2) against the byte bound at the stem and at each stage's
    shortcut, above 105 % a failure; the wrapper's host cost; the embedding
    with K8 bitwise the embedding with the plain chain put in its place and
    the parent's trunk's (plain chain, OIHW weights; N = 1, 37, 128; bf16
    and f32; K5 off and on) with 20 / 16 launches per forward; and the
    device kernels per 128-crop chunk of the step's embed
    (embed_detections_batch, 30 chunks) against the parent's trunk's."""
    import torch

    from vehicle_counting_tpu_torch.models import reid
    from vehicle_counting_tpu_torch.ops import reid_epilogue as ep
    from vehicle_counting_tpu_torch.testing import EPILOGUE_CASES, crop_boxes, fake_reid_state_dict, reid_epilogue_operands
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, embed_detections_batch
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    torch.backends.cudnn.allow_tf32 = False
    layouts = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}
    shapes = {"stem": (128, 64, 50, 50), "stage1": (128, 64, 25, 25), "stage2": (128, 128, 13, 13),
              "stage3": (128, 256, 7, 7), "stage4": (128, 512, 4, 4)}

    def bits(t):
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)

    def call(fn, ops, x, res, case, lo_dtype):
        o = EPILOGUE_CASES[case]
        return fn(x, ops["mean"], ops["inv"], ops["scale"], ops["bias"], pre_bias=ops["pre_bias"] if o["pre_bias"] else None,
                  residual=res if o["residual"] else None, relu=o["relu"], f32=o["f32"], lo=lo_dtype if o["lo"] else None)

    rng = np.random.default_rng(SEED + 20)
    operands, checked = {}, 0
    for where, shape in shapes.items():
        ops = {k: torch.from_numpy(v).to(dev) for k, v in reid_epilogue_operands(rng, shape).items()}
        ops["inv"] = ep.bn_inv(ops["var"], reid.BN_EPS)
        operands[where] = ops
        for dtype in (torch.float32, torch.bfloat16):
            for layout, fmt in layouts.items():
                x_all = ops["x"].to(dtype).contiguous(memory_format=fmt)
                r_all = ops["residual"].contiguous(memory_format=fmt)
                for n in (1, 37, 128):
                    x, r = x_all[:n], r_all[:n]
                    for case in EPILOGUE_CASES:
                        got = call(ep.reid_epilogue, ops, x, r, case, torch.bfloat16)
                        want = call(ep.reid_epilogue_plain, ops, x, r, case, torch.bfloat16)
                        for g, w in zip(got, want):
                            if (g is None) != (w is None) or (g is not None and (
                                    g.stride() != w.stride() or not torch.equal(bits(g), bits(w)))):
                                raise AssertionError(f"K8 {case} {where} {dtype} {layout} N={n}: differs from the plain "
                                                     f"chain (or its memory format does)")
                        checked += 1
    print(f"K8 bitwise == the plain chain in {checked} calls: {len(EPILOGUE_CASES)} cases x stem and four stages x "
          f"f32 / bf16 input x NCHW / channels-last x N = 1, 37, 128 (zeros of both signs, ties, infinities, a NaN)")

    timings, flushed_calls = {}, 5
    l2_flush = torch.zeros(64 * 2**20, device=dev)  # 256 MB, five times the H100's L2
    for where, case in (("stem", "stem"), ("stage1", "conv2"), ("stage2", "conv2"), ("stage3", "conv2"),
                        ("stage4", "conv2")):
        ops = operands[where]
        x = ops["x"].to(torch.bfloat16).contiguous(memory_format=torch.channels_last)  # the cell's: bf16, channels-last
        r = ops["residual"].contiguous(memory_format=torch.channels_last)
        kern = lambda: call(ep.reid_epilogue, ops, x, r, case, torch.bfloat16)  # noqa: E731
        plain = lambda: call(ep.reid_epilogue_plain, ops, x, r, case, torch.bfloat16)  # noqa: E731
        t = {"plain": [], "kernel": []}
        for who in ("plain", "kernel", "kernel", "plain"):
            t[who].append(cuda_ms(kern if who == "kernel" else plain, 20))
        ev = device_events(kern)
        if len(ev) != 1 or "reid_epilogue" not in ev[0][0]:
            raise AssertionError(f"K8: one call must run exactly one device kernel, the trace shows {ev}")
        ev_warm = ev[0][1]
        # the bound counts every byte from HBM, but the stem's 41 MB input fits the 50 MB L2 that the
        # previous call left warm: each traced call comes after a read of 256 MB, which evicts it
        ev = device_events(lambda: [(l2_flush.sum(), kern()) for _ in range(flushed_calls)])
        k8 = sorted(ms for name, ms in ev if "reid_epilogue" in name)
        if len(k8) != flushed_calls:
            raise AssertionError(f"K8: {len(k8)} kernels in {flushed_calls} calls, the trace shows {ev}")
        k8_ms = k8[len(k8) // 2]
        plain_ev = device_events(plain)
        o = EPILOGUE_CASES[case]
        out_bytes = x.numel() * (4 * o["f32"] + 2 * o["lo"])
        vec_bytes = nbytes(ops["mean"]) * (4 + o["pre_bias"])
        bd = bound(nbytes(x) + (nbytes(r) if o["residual"] else 0) + out_bytes + vec_bytes, 0, BF16_FLOPS)
        timings[where] = {"case": case, "shape": list(x.shape), "ms": min(t["kernel"]), "plain_ms": min(t["plain"]),
                          "device_ms": k8_ms, "device_ms_warm_l2": ev_warm,
                          "plain_device_ms": sum(ms for _, ms in plain_ev),
                          "plain_device_kernels": len(plain_ev), **bd, "bound_share": bd["bound_ms"] / k8_ms}
        print(f"K8 {case} {list(x.shape)} bf16 channels-last: kernel {t['kernel']} ms, plain chain {t['plain']} ms "
              f"(CUDA events, turns); device, L2 flushed, median of {flushed_calls} {k8_ms:.4f} ms (all "
              f"{[round(v, 4) for v in k8]}; warm L2 {ev_warm:.4f}) in 1 kernel against the plain chain's "
              f"{timings[where]['plain_device_ms']:.4f} ms in {len(plain_ev)}; bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}, 3.35 TB/s): {100 * bd['bound_ms'] / k8_ms:.1f} % of it")
        if bd["bound_ms"] / k8_ms > 1.05:
            raise AssertionError(f"K8 {where}: {100 * bd['bound_ms'] / k8_ms:.1f} % of its byte bound; above 105 % the "
                                 f"bytes are counted too high or the time misses part of the work")
    ops = operands["stage4"]
    x = ops["x"].to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    kern = lambda: call(ep.reid_epilogue, ops, x, None, "conv1", torch.bfloat16)  # noqa: E731
    bn_p, bn_s = {"scale": ops["scale"], "bias": ops["bias"]}, {"mean": ops["mean"], "var": ops["var"]}
    trunk_call = lambda: reid._bn_epilogue(x, bn_p, bn_s, torch.bfloat16, f32=False, feeds_conv=True,  # noqa: E731
                                           relu=True)
    host_us = [1e3 * host_ms(kern, 2000) for _ in range(3)]
    trunk_us = [1e3 * host_ms(trunk_call, 2000) for _ in range(3)]
    print(f"K8 wrapper host cost, {list(x.shape)} conv1 (one bf16 output), 2000 calls in a row: {host_us} us a call; "
          f"with the kept inv's lookup, as the trunk calls it: {trunk_us} us")

    rp, rs = reid.reid_state_dict_to_pytree(fake_reid_state_dict(rng), dev)  # BN away from identity
    rpb = reid.cast_conv_weights(rp, torch.bfloat16)
    crops = torch.from_numpy(rng.standard_normal((128, 50, 50, 3)).astype(np.float32)).to(dev)
    old = reid.FORCE_PALLAS_REID_BLOCK
    per_forward = {}
    try:
        for k5 in (False, True):
            reid.FORCE_PALLAS_REID_BLOCK = k5
            for dtype, params in ((torch.bfloat16, rpb), (None, rp)):
                for n in (1, 37, 128):
                    ep.reid_epilogue.launches = 0
                    got = reid.reid_embed(params, rs, crops[:n], dtype=dtype)
                    launches = ep.reid_epilogue.launches
                    with _reid_trunk_as(plain_epilogue=True):
                        want = reid.reid_embed(params, rs, crops[:n], dtype=dtype)
                    with _reid_trunk_as(plain_epilogue=True, eager_conv_weights=True):
                        want_parent = reid.reid_embed(params, rs, crops[:n], dtype=dtype)
                    if not (torch.equal(got, want) and torch.equal(got, want_parent)):
                        raise AssertionError(f"K8: embedding (N={n}, {dtype}, K5 {k5}) differs from the plain chain's "
                                             f"(or from the parent's trunk: plain chain, OIHW weights)")
                    per_forward[f"k5_{'on' if k5 else 'off'}_{'bf16' if dtype else 'f32'}"] = launches
                    want_launches = 16 if k5 and dtype is not None else 20
                    if launches != want_launches:
                        raise AssertionError(f"K8: {launches} launches per forward (K5 {k5}, {dtype}), want {want_launches}")
    finally:
        reid.FORCE_PALLAS_REID_BLOCK = old
    print(f"K8 embedding bitwise == the plain chain's, N = 1, 37, 128, bf16 and f32, K5 off and on; launches per "
          f"forward {per_forward}")

    # the step's embed at the cell's load: 128 frames x 30 detections = 30 chunks of max_embed crops
    b, nd, h, w = 128, 64, 384, 640
    frames = torch.from_numpy(rng.integers(0, 256, (b, 3, h, w), dtype=np.uint8)).to(dev)
    boxes = torch.from_numpy(crop_boxes(rng, b * nd, h, w).reshape(b, nd, 4)).to(dev)
    valid = torch.zeros((b, nd), dtype=torch.bool, device=dev)
    valid[:, :30] = True
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=4)  # the embed reads max_embed only
    chunks = -(-int(valid.sum()) // hp.max_embed)

    def embed():
        with torch.no_grad():
            return embed_detections_batch(frames, boxes, valid, rpb, rs, hp, dtype=torch.bfloat16)

    counts, walls = {}, {"parent": [], "kernel": []}
    for who in ("parent", "kernel", "kernel", "parent"):
        with _reid_trunk_as(plain_epilogue=who == "parent", eager_conv_weights=who == "parent"):
            walls[who].append(host_ms(embed, 5))
    for who in ("parent", "kernel"):
        with _reid_trunk_as(plain_epilogue=who == "parent", eager_conv_weights=who == "parent"):
            ev = device_events(embed)
        counts[who] = {"device_kernels": len(ev), "per_chunk": len(ev) / chunks,
                       "device_ms": sum(ms for _, ms in ev), "k8_ms": sum(ms for n, ms in ev if "reid_epilogue" in n)}
    if not counts["kernel"]["per_chunk"] <= 70:
        raise AssertionError(f"K8: {counts['kernel']['per_chunk']:.1f} device kernels per embed chunk, want <= 70")
    print(f"embed_detections_batch, {b} frames x 30 detections ({chunks} chunks of {hp.max_embed}), bf16: host ms a "
          f"batch (synchronised) parent's trunk {walls['parent']}, K8 {walls['kernel']}; device kernels per chunk "
          f"(torch.profiler) parent's trunk {counts['parent']['per_chunk']:.2f}, K8 {counts['kernel']['per_chunk']:.2f}; "
          f"device ms a batch parent's {counts['parent']['device_ms']:.3f}, K8 {counts['kernel']['device_ms']:.3f} "
          f"(of which K8 {counts['kernel']['k8_ms']:.3f})")
    return {"bitwise_calls": checked, "timings": timings, "wrapper_host_us": host_us, "trunk_call_host_us": trunk_us,
            "launches_per_forward": per_forward,
            "embed_batch_ms": walls, "embed_device": counts, **timings["stem"], "library_ms": None}


def device_events(fn):
    """(name, ms) of each kernel and copy that one call of fn runs on the
    card: a warm-up call, then one call under utils/profiling.trace, read
    back from the trace file. The call sits in a named region between two
    launches of a marker kernel. A device event counts when the host call
    that launched it (its correlation id) lies in the region, or when it
    runs between the two markers on the device's clock: the kernels that
    the port launches through ctypes may show no host call, and the
    profiler maps the device's clock onto the host's with a drift that
    grows as the process runs (kernels come out tens of milliseconds
    before their launch, warned "GPU op timestamp < runtime timestamp"),
    so a host-clock window would miss them. It also drops device events
    that come out before the trace began or after it ended (the drift has
    gone either way): the region sits between two pauses inside the
    trace, and a trace that lost either marker's device event is taken
    again with pauses twice as long; the fifth raises, with what the
    traces held. The markers' events are not returned."""
    import torch

    from vehicle_counting_tpu_torch.utils.profiling import trace

    fn()
    marker = torch.zeros(8, device="cuda")
    torch.cuda.synchronize()
    seen = []
    for pause in (0.25, 0.5, 1.0, 2.0, 4.0):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as t:
                marker.add_(1.0)
                torch.cuda.synchronize()
                time.sleep(pause)
                with torch.profiler.record_function("vct_device_events_region"):
                    marker.add_(1.0)  # opens the region on the device's clock
                    fn()
                    marker.add_(1.0)  # and closes it
                    torch.cuda.synchronize()
                time.sleep(pause)
            with open(t["path"]) as f:
                data = json.load(f)
        raw = [e for e in (data["traceEvents"] if isinstance(data, dict) else data) if e.get("ph") == "X"]
        events, why = _region_events(raw)
        if events:
            return events
        seen.append(f"pause {pause} s: {why}")
    raise AssertionError(f"device_events: five traces in a row lost the region's device events: {seen}")


def _region_events(raw):
    """device_events' reading of one trace's complete events: ([(name,
    ms)], None), or (None, what was missing). The markers are the region's
    first and last runtime kernel launches (PyTorch's; a ctypes launch
    shows as a cuLaunchKernel call, if at all)."""
    from vehicle_counting_tpu_torch.tools.profile_summary import DEVICE_CATS

    region = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in raw
              if e.get("name") == "vct_device_events_region"]
    if not region:
        raise AssertionError("device_events: the trace holds no region marker")
    start, stop = min(r[0] for r in region), max(r[1] for r in region)
    calls = sorted((e for e in raw if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and start <= float(e["ts"]) <= stop and e.get("args", {}).get("correlation") is not None),
                   key=lambda e: float(e["ts"]))
    launched = {e["args"]["correlation"] for e in calls}
    launches = [e["args"]["correlation"] for e in calls if str(e.get("name", "")).startswith("cudaLaunchKernel")]
    markers = {launches[0], launches[-1]} if launches else set()
    device = sorted((e for e in raw if e.get("cat") in DEVICE_CATS), key=lambda e: float(e["ts"]))
    ends = {e["args"]["correlation"]: (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in device
            if e.get("args", {}).get("correlation") in markers}
    if len(launches) < 2 or len(ends) < 2:
        return None, (f"{len(device)} device events, {len(launched)} calls and {len(launches)} launches in the "
                      f"region, {len(ends)} of the 2 markers' device events kept")
    lo, hi = ends[launches[0]][0], ends[launches[-1]][1]
    events = [(str(e.get("name", "")), float(e.get("dur", 0.0)) / 1e3) for e in device
              if e.get("args", {}).get("correlation") not in markers
              and (e.get("args", {}).get("correlation") in launched or lo <= float(e["ts"]) <= hi)]
    return (events, None) if events else (None, f"no device event between the markers ({len(device)} in the trace)")


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
        if dt == torch.bfloat16:  # the wrapper keeps its packed weights; packing on every call, as before the cache
            bias = b.float().contiguous()

            def uncached():
                return conv_s2._launch_kernel(xt, conv_s2.pack_conv1_weights(w), bias)

            if not torch.equal(uncached(), conv_s2.conv1_s2_silu(xt, w, b)):
                raise AssertionError(f"K6 {list(shape)}: output with the cached packed weights differs from a fresh pack's")
            t_un = [cuda_ms(uncached, n)]
            t_ca = [cuda_ms(lambda: conv_s2.conv1_s2_silu(xt, w, b), n) for _ in range(2)]
            t_un.append(cuda_ms(uncached, n))
            print(f"K6 {name} {list(shape)}: cached pack == fresh pack, bitwise; wrapper in turns (packing per call, "
                  f"cached, cached, packing per call): {t_un[0]:.4f}, {t_ca[0]:.4f}, {t_ca[1]:.4f}, {t_un[1]:.4f} ms")
            res[key].update(uncached_ms=min(t_un), cached_ms=min(t_ca))
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


def write_video(tmp, n_frames=N_FRAMES, name="cam_smoke", seed=SEED + 3):
    """n_frames of 1280x720: a fixed textured background with coloured
    boxes driving across (the same frames for every n_frames of one seed),
    and the zone file the CLI needs."""
    import cv2

    rng = np.random.default_rng(seed)
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
            conf_thres=0.0, iou_thres=0.45, max_det=300, dtype=torch.bfloat16, frames_format="letterboxed_yuv420")
    conf, _, top4 = calibrate_from_det(det, 30)
    return conf, {int(c): i for i, c in enumerate(top4)}


def kernel_counters():
    """{kernel: [wrappers that launch it]} of the step's kernels. K2
    ("cascade", all classes in one launch) and its per-class entry K3
    ("cascade_k3", the scan mode's association) are counted apart."""
    from vehicle_counting_tpu_torch.ops import assignment, cascade, crops, reid_block, reid_epilogue, track_frame

    return {
        "crops": [crops.gather_crops_batch],
        "cascade": [cascade.cascade_match_classparallel],
        "cascade_k3": [cascade.cascade_match_batched],
        "insert_rows": [assignment.insert_rows_batched],
        "match_stage": [assignment.match_stage_batched],
        "reid_block": [reid_block.reid_block64],
        "reid_epilogue": [reid_epilogue.reid_epilogue],
        "track_pre": [track_frame.track_frame_pre],
        "track_post": [track_frame.track_frame_post],
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

    old_env, old_force = os.environ.get("FORCE_PALLAS_REID_BLOCK"), tracker.FORCE_PALLAS_CASCADE
    os.environ["FORCE_PALLAS_REID_BLOCK"] = "1"
    tracker.FORCE_PALLAS_CASCADE = False
    try:
        _, launches, df = run_pipeline(dev, tmp, path, zones, conf, mapping, N_SWITCHED, "out_switched")
    finally:
        tracker.FORCE_PALLAS_CASCADE = old_force
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
                conf_thres=conf, iou_thres=0.45, max_det=300, dtype=torch.float32, frames_format="letterboxed_yuv420")
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
    old = tracker.FORCE_PALLAS_CASCADE
    tracker.FORCE_PALLAS_CASCADE = False
    try:
        assignment.match_stage_batched.launches = 0
        det_s, tout_s = step(dev)
        torch.cuda.synchronize()
        k4 = assignment.match_stage_batched.launches
    finally:
        tracker.FORCE_PALLAS_CASCADE = old
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
            conf_thres=conf, iou_thres=0.45, max_det=300, dtype=torch.float32, frames_format="letterboxed_yuv420")

    def scan_ms(staged):
        tracker.FORCE_PALLAS_CASCADE = False if staged else old
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                tracker_scan(init_states(hp, dev), det_s, feats, hp=hp, src_hw=SRC_HW)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / b
        finally:
            tracker.FORCE_PALLAS_CASCADE = old

    scan_ms(False), scan_ms(True)  # warm-up
    t = {"k2": [], "staged": []}
    for staged in (False, True, True, False):
        t["staged" if staged else "k2"].append(scan_ms(staged))
    print(f"tracker ms/frame (B={b}, f32, host clock): K2 route {t['k2']}, staged route {t['staged']}")
    return t


UPDATE_LEAVES = ("mean", "cov")  # through kalman.update's contractions (and the gate's sum upstream)


@contextlib.contextmanager
def op_chain(on=True):
    """With `on`, the frame step runs K9's and K10's plain versions, the op
    chain, in the kernels' place on the card: the kernels' yardstick."""
    from vehicle_counting_tpu_torch.ops import track_frame as tf
    from vehicle_counting_tpu_torch.tracking import deepsort

    old = deepsort.track_frame_pre, deepsort.track_frame_post
    if on:
        deepsort.track_frame_pre, deepsort.track_frame_post = tf.track_frame_pre_plain, tf.track_frame_post_plain
    try:
        yield
    finally:
        deepsort.track_frame_pre, deepsort.track_frame_post = old


def kernels_vs_chain(got, want, what, rtol=1e-5):
    """K9 + K10 against the op chain, batch by batch (lists of (state,
    outputs)): every integer leaf, the gallery and boxes / ids / mask equal;
    last_conf and scores equal; mean and cov equal or within `rtol`
    relative (|a - b| <= rtol * |b|, zeros exact). Returns what differed."""
    import torch

    worst, differing, total = {}, {}, {}
    for i, ((st_g, out_g), (st_w, out_w)) in enumerate(zip(got, want)):
        for name, g, w in zip(st_w._fields + out_w._fields, tuple(st_g) + tuple(out_g), tuple(st_w) + tuple(out_w)):
            if name in UPDATE_LEAVES:
                diff = (g - w).abs()
                rel = float((diff / w.abs().clamp(min=1e-30)).max()) if bool((diff > 0).any()) else 0.0
                worst[name] = max(worst.get(name, 0.0), rel)
                differing[name] = differing.get(name, 0) + int((g != w).sum())
                total[name] = total.get(name, 0) + g.numel()
                if not bool((diff <= rtol * w.abs()).all()):
                    raise AssertionError(f"{what}, batch {i}: {name} beyond {rtol} relative of the op chain "
                                         f"(worst {rel:.3g})")
            elif not torch.equal(g, w):
                raise AssertionError(f"{what}, batch {i}: {name} differs from the op chain")
    return {"bitwise_except": {n: f"{differing[n]} of {total[n]}" for n in UPDATE_LEAVES if differing.get(n)},
            "worst_rel": {n: worst[n] for n in UPDATE_LEAVES}}


def track_frame_bytes(st, sims_rows, written, gallery_bytes):
    """Bytes K9 and K10 need for one frame (each input read once, each
    output written once), from the state's shapes: K9 reads the slots'
    state and the detections, the similarities of the ring rows below
    each slot's count (`sims_rows` rows of K) and writes the prediction
    and the association's operands; K10 reads the prediction or the old
    mean / covariance, the slots' scalars, the detections and the
    association's outcome and the features of the `written` ring rows,
    and writes the state, the outputs and those rows."""
    c, k = st.state.shape
    f = st.gallery.shape[-1]
    slots = c * k
    k9 = slots * (72 + 4) * 4 + slots * (16 + 1) + sims_rows * k * 4 + slots * (72 * 4 + 2 * k * 4 + 9)
    k10 = (slots * (72 * 4 + 8 * 4) + slots * (16 + 4 + 1 + 1 + 4 + 4) + written * f * 4
           + slots * (72 * 4 + 8 * 4) + slots * (16 + 4 + 4 + 1) + written * f * gallery_bytes)
    return k9, k10


def check_track_frame(dev, reps=200):
    """K9 and K10 at the cells' shapes (C = 4, K = 64, budget 60, F = 512,
    bf16 gallery) on three random states (`testing.tracker_frame_case`,
    the last crowded past its free slots): each bitwise against its plain
    version, K10 on the plain association's outcome; then, on the last
    state, the wrapper's ms (CUDA events over `reps` calls) against the
    plain version's, one call's device time from the card's trace, and
    the bytes bound at 3.35 TB/s (`track_frame_bytes`)."""
    import torch

    from vehicle_counting_tpu_torch.ops import track_frame as tf
    from vehicle_counting_tpu_torch.testing import tracker_frame_case
    from vehicle_counting_tpu_torch.tracking import tracker as trk
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerState

    def clone(st):
        return TrackerState(*(t.clone() for t in st))

    for seed in range(3):
        hp, st, inp, (h, w) = tracker_frame_case(np.random.default_rng(SEED + 90 + seed), 4, 64, budget=60, feat=512,
                                                 gallery_dtype="bfloat16", crowded=seed == 2, device=dev)
        tp = hp.tracker
        f_n = trk.l2_normalize(inp.feats)
        sims = trk.gallery_sims(st.gallery, f_n)
        pre = tf.track_frame_pre_plain(st, inp.tlwh, inp.valid, sims, tp)
        for name, a, b in zip(pre._fields, tf.track_frame_pre(st, inp.tlwh, inp.valid, sims, tp), pre):
            if not torch.equal(a, b):
                raise AssertionError(f"K9, seed {seed}: {name} differs from the plain version")
        assoc = trk._associate(pre.gated, pre.iou_cost, pre.lvl_of, pre.tentative, st.track_id, pre.iou_order,
                               inp.valid, inp.order, tp)
        post_args = (pre, inp.tlwh, inp.scores, inp.valid, inp.present, f_n, *assoc, tp, w, h)
        got_st, got_out = tf.track_frame_post(clone(st), *post_args)
        want_st, want_out = tf.track_frame_post_plain(clone(st), *post_args)
        for name, a, b in zip(want_st._fields + want_out._fields, tuple(got_st) + tuple(got_out),
                              tuple(want_st) + tuple(want_out)):
            if not torch.equal(a, b):
                raise AssertionError(f"K10, seed {seed}: {name} differs from the plain version")
    torch.cuda.synchronize()
    sims_rows = int(torch.clamp(st.gallery_count, max=tp.budget).sum())
    written = int((((assoc[1] >= 0) | (want_st.track_id >= st.next_id[:, None])) & inp.present[:, None]).sum())
    scratch = clone(st)
    calls = {"K9": (lambda: tf.track_frame_pre(st, inp.tlwh, inp.valid, sims, tp),
                    lambda: tf.track_frame_pre_plain(st, inp.tlwh, inp.valid, sims, tp), "track_pre_kernel"),
             "K10": (lambda: tf.track_frame_post(scratch, *post_args),
                     lambda: tf.track_frame_post_plain(scratch, *post_args), "track_post_kernel")}
    bytes_ = dict(zip(("K9", "K10"), track_frame_bytes(st, sims_rows, written, 2)))
    res = {}
    for name, (kern, plain, kname) in calls.items():
        ms = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            ms[which].append(cuda_ms(kern if which == "kernel" else plain, reps))
        ev = device_events(kern)
        dev_ms = sum(t for n, t in ev if kname in n)
        bound_ms = bytes_[name] / HBM_BPS * 1e3
        res[name] = {"ms": ms["kernel"], "plain_ms": ms["plain"], "device_ms": dev_ms, "device_kernels": len(ev),
                     "bytes": bytes_[name], "bound_ms": bound_ms, "bound_share": 100 * bound_ms / dev_ms}
        if len(ev) != 1:
            raise AssertionError(f"{name}: one call shows {len(ev)} device kernels: {ev}")
    print(f"K9 / K10 at C=4, K=64, budget 60, F=512, bf16 gallery: bitwise their plain versions on 3 states; "
          f"{sims_rows} ring rows below the counts, {written} rows written; {json.dumps(res)}")
    return res


def check_frame_graph(dev, path, conf, mapping):
    """The frame scan replayed from its CUDA graph against the eager loop,
    on the card, over the 256-frame smoke video (the CLI's default config:
    bf16, B=128, the calibrated threshold and class map), on both
    association routes: every `TrackerState` leaf and every output
    bitwise-equal after each batch; the two routes equal on the discrete
    outputs; the frame graph's K9 + K10 against the op chain run eagerly on
    the card (`kernels_vs_chain`); one replay's device kernels from the
    card's trace (<= 12 on the K2 route) against the runner's counts. Then
    the tracker A/B: `tracker_scan` on the second batch (B=128, the state
    warmed by the first: steady state), graph off / on / on / off,
    ms/frame. Returns the A/B times and the launch counts."""
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
                image_size=net, src_hw=SRC_HW, conf_thres=conf, iou_thres=0.45, max_det=300, dtype=torch.bfloat16,
                frames_format="letterboxed_yuv420"))
    del frames

    def scan(states, det, feats, graph, staged, chain=False):
        old = step_mod.USE_FRAME_GRAPH, tracker.FORCE_PALLAS_CASCADE
        step_mod.USE_FRAME_GRAPH = None if graph else False
        tracker.FORCE_PALLAS_CASCADE = False if staged else old[1]
        try:
            with torch.no_grad(), op_chain(chain):
                return step_mod.tracker_scan(states, det, feats, hp=hp, src_hw=SRC_HW)
        finally:
            step_mod.USE_FRAME_GRAPH, tracker.FORCE_PALLAS_CASCADE = old

    counters = kernel_counters()
    runs, launches, against_chain = {}, {}, {}
    for staged in (False, True):
        for graph in (False, True, "chain"):
            zero_counts(counters)
            states, per_batch = init_states(hp, dev), []
            for det, feats in batches:
                states, outs = scan(states, det, feats, graph is True, staged, chain=graph == "chain")
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
        against_chain["staged" if staged else "k2"] = kernels_vs_chain(
            runs[staged, True], runs[staged, "chain"], f"frame graph on the {'staged' if staged else 'K2'} route")
    for (st_k, out_k), (st_s, out_s) in zip(runs[False, True], runs[True, True]):
        for name in ("ids", "mask", "boxes"):
            if not torch.equal(getattr(out_k, name), getattr(out_s, name)):
                raise AssertionError(f"staged route and K2 route differ under the graph: track {name}")
    n_out = sum(int(o.mask.sum()) for _, o in runs[False, True])
    k2_l, st_l = launches[False, True], launches[True, True]
    if (k2_l["cascade"] != N_FRAMES or k2_l["match_stage"] or st_l["cascade"] or st_l["match_stage"] != 31 * N_FRAMES
            or k2_l["insert_rows"] or st_l["insert_rows"]
            or any(l[n] != N_FRAMES for l in (k2_l, st_l) for n in ("track_pre", "track_post"))
            or any(launches[r, "chain"][n] for r in (False, True) for n in ("track_pre", "track_post"))):
        raise AssertionError(f"frame graph launch counts over {N_FRAMES} frames: K2 route {k2_l}, staged route {st_l}")
    # what one replay really launches, read from the card's trace, against
    # what the runner adds to the wrappers' counts per replay
    measured = {}
    for staged in (False, True):
        old = tracker.FORCE_PALLAS_CASCADE
        tracker.FORCE_PALLAS_CASCADE = False if staged else old
        try:
            runner = step_mod.frame_runner(hp, SRC_HW, dev)
        finally:
            tracker.FORCE_PALLAS_CASCADE = old
        events = device_events(runner._step)
        seen = {"cascade": sum("cascade_kernel" in name for name, _ in events),
                "match_stage": sum("match_stage_kernel" in name for name, _ in events),
                "insert_rows": sum("insert_rows_kernel" in name for name, _ in events),
                "track_pre": sum("track_pre_kernel" in name for name, _ in events),
                "track_post": sum("track_post_kernel" in name for name, _ in events)}
        counted = dict.fromkeys(seen, 0)
        for name, fns in counters.items():
            if name in counted:
                counted[name] = sum(runner.replay_launches.get(fn, 0) for fn in fns)
        want = ({"cascade": 0, "match_stage": 31, "insert_rows": 0} if staged
                else {"cascade": 1, "match_stage": 0, "insert_rows": 0})
        want.update(track_pre=1, track_post=1)
        if seen != counted or seen != want:
            raise AssertionError(f"one replay on the {'staged' if staged else 'K2'} route: the trace shows {seen} device "
                                 f"kernels, the runner counts {counted}, expected {want}")
        if not staged and len(events) > 12:
            raise AssertionError(f"one replay on the K2 route runs {len(events)} device kernels, want <= 12: "
                                 f"{[name for name, _ in events]}")
        measured["staged" if staged else "k2"] = {
            "device_kernels_per_replay": len(events), **seen, "device_ms": round(sum(ms for _, ms in events), 5),
            "k9_ms": round(sum(ms for n, ms in events if "track_pre_kernel" in n), 5),
            "k10_ms": round(sum(ms for n, ms in events if "track_post_kernel" in n), 5),
            "kernels": sorted({name[:48] for name, _ in events})}
    print(f"frame graph == eager loop, bitwise, on all {len(TrackerState._fields)} state leaves and 4 outputs after each "
          f"of {len(batches)} batches of {b} frames, on both routes ({n_out} track outputs); staged == K2 route on ids, "
          f"mask, boxes; launches over {N_FRAMES} frames: K2 route {k2_l['cascade']} K2, staged route "
          f"{st_l['match_stage']} K4 match_stage (31 per frame: min(max_age, K) + 1), {k2_l['track_pre']} K9 and "
          f"{k2_l['track_post']} K10; one replay in the card's trace "
          f"(torch.profiler): {measured}, equal to the counts the runner adds per replay; warm-up launches of the "
          f"captures so far, on scratch state and in no count above: {dict(graph_mod.warmup_launches)}")
    print(f"K9 + K10 against the op chain on the card, {N_FRAMES} frames: {json.dumps(against_chain)}")

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
            "against_chain": against_chain, "batches": batches, "hp": hp, "runs": runs}


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


def run_detect_only(dev, tmp, path, zones, conf, mapping, n_frames=N_FRAMES, out="out_detect_only",
                    config_over=None):
    """The CLI with --detect_only: {cam}_detections.csv with its schema, a
    row count, frames/s; no tracker kernel may launch. `config_over` sets
    configs.yaml keys. Returns (frames/s, launches, the CSV's rows)."""
    import pandas as pd
    import torch

    from vehicle_counting_tpu_torch import run

    out_dir = os.path.join(tmp, out)
    args = run.parser.parse_args(["--input_path", path, "--output_path", out_dir, "--device", str(dev),
                                  "--mapping", json.dumps(mapping), "--detect_only", "--no_visualize"])
    config, cam_config = run.load_configs(args)
    config.min_conf = conf
    for key, value in (config_over or {}).items():
        setattr(config, key, value)
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
    print(f"detect-only CLI on {dev}: {res['frames']} frames, {res['fps']:.2f} frames/s (cold, model init outside), "
          f"{len(df)} rows over {df.frame_id.nunique()} frames, {df.groupby('frame_id').size().mean():.1f} per frame")
    return res["fps"], launches, df


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
                                                                     conf_thres=conf, content_only=True, **kw).items()}
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
    eager scan loop on every state leaf and output, on both routes; the
    graph's K9 + K10 against the op chain (`kernels_vs_chain`); scan ==
    batched on the track outputs; K3 launched C times per frame on the K2
    route and no K2, K4's fused stage C x 31 times per frame on the staged
    route, K9 and K10 once per frame; one replay's trace shows C K3
    kernels, one K9 and one K10; then
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

    def scan(states, det, feats, h, graph, staged, chain=False):
        old = step_mod.USE_FRAME_GRAPH, tracker.FORCE_PALLAS_CASCADE
        step_mod.USE_FRAME_GRAPH = None if graph else False
        tracker.FORCE_PALLAS_CASCADE = False if staged else old[1]
        try:
            with torch.no_grad(), op_chain(chain):
                return step_mod.tracker_scan(states, det, feats, hp=h, src_hw=SRC_HW)
        finally:
            step_mod.USE_FRAME_GRAPH, tracker.FORCE_PALLAS_CASCADE = old

    counters = kernel_counters()
    runs, launches, against_chain = {}, {}, {}
    for staged in (False, True):
        route = "staged" if staged else "K2"
        for graph in (False, True, "chain"):
            zero_counts(counters)
            states, per_batch = init_states(hp, dev), []
            for det, feats in batches:
                states, outs = scan(states, det, feats, hp, graph is True, staged, chain=graph == "chain")
                per_batch.append((TrackerState(*(t.clone() for t in states)), outs))
            torch.cuda.synchronize()
            runs[staged, graph] = per_batch
            launches[staged, graph] = read_counts(counters)
        against_chain[route] = kernels_vs_chain(runs[staged, True], runs[staged, "chain"],
                                                f"scan mode, frame graph on the {route} route")
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
            or st_l["cascade_k3"] or st_l["match_stage"] != c * stages * n_frames or launches[False, False] != k2_l
            or any(l[n] != n_frames for l in (k2_l, st_l) for n in ("track_pre", "track_post"))):
        raise AssertionError(f"scan-mode launch counts over {n_frames} frames: K2 route {k2_l}, staged {st_l}")
    runner = step_mod.frame_runner(hp, SRC_HW, dev)
    events = device_events(runner._step)
    seen = sum("cascade_kernel" in name for name, _ in events)
    k9_k10 = [sum(f"track_{n}_kernel" in name for name, _ in events) for n in ("pre", "post")]
    counted = [runner.replay_launches.get(fn, 0) for fn in counters["track_pre"] + counters["track_post"]]
    if seen != c or k9_k10 != [1, 1] or counted != k9_k10:
        raise AssertionError(f"one scan-mode replay shows {seen} association kernels (want {c}) and K9 / K10 "
                             f"{k9_k10} (the runner counts {counted}, want [1, 1]) in the card's trace")
    n_out = sum(int(o.mask.sum()) for _, o in runs[False, True])
    print(f"scan mode: frame graph == eager loop, bitwise, on every state leaf and output, both routes; scan == "
          f"batched on the track outputs ({n_out} track outputs); launches over {n_frames} frames: K2 route "
          f"{k2_l['cascade_k3']} K3 ({c} per frame), 0 K2; staged route {st_l['match_stage']} K4 match_stage "
          f"({c} x {stages} per frame), {k2_l['track_pre']} K9 and {k2_l['track_post']} K10; one replay: "
          f"{len(events)} device kernels, {seen} K3, K9 / K10 {k9_k10}; K9 + K10 against the op chain: "
          f"{json.dumps(against_chain)}")

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
            "replay_k3": seen, "frames": n_frames, "against_chain": against_chain}


def check_k2_cameras(dev):
    """K2 with the camera axis (the multi-camera step launches it once per
    frame with N_cam x C blocks): at C = 4 classes x MC_K2_CAMS cameras,
    bitwise against the plain version on all four outputs (random, ties,
    empty, steady problems); ms per launch eager and as a graph node on a
    steady frame's and a random problem, beside the one-camera C = 4
    steady problem in the same call."""
    import torch

    from vehicle_counting_tpu_torch.ops import cascade
    from vehicle_counting_tpu_torch.testing import association_problem

    names = ["gated", "iou", "lvl_of", "tentative", "track_id", "iou_order", "det_valid", "det_order"]
    c = 4 * MC_K2_CAMS
    rng = np.random.default_rng(SEED + 60)
    n_cases, t_plain = 0, []
    for kind in ("random", "ties", "empty", "steady"):
        for _ in range(4):
            pr = association_problem(rng, c, 64, 30, kind)
            cpu = [torch.from_numpy(pr[n]) for n in names]
            got = cascade.cascade_match_classparallel(*(x.to(dev) for x in cpu), 0.2, 0.6, max_age=30)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cascade.cascade_match_classparallel(*cpu, 0.2, 0.6, max_age=30)
            t_plain.append((time.perf_counter() - t0) * 1e3)
            for field, w in zip(want._fields, want):
                g = getattr(got, field)
                if g.dtype != w.dtype or not torch.equal(g.cpu(), w):
                    raise AssertionError(f"K2 at C = {c} ({kind} problem): {field} differs from the plain version")
            n_cases += 1

    def problem(cc, kind, seed):
        pr = association_problem(np.random.default_rng(seed), cc, 64, 30, kind)
        return [torch.from_numpy(pr[n]).to(dev) for n in names]

    times = {}
    for label, cc, kind, seed in (("c4_steady", 4, "steady", SEED + 20), (f"c{c}_steady", c, "steady", SEED + 61),
                                  (f"c{c}_random", c, "random", SEED + 62)):
        gpu = problem(cc, kind, seed)

        def launch(g=gpu):
            return cascade.cascade_match_classparallel(*g, 0.2, 0.6, max_age=30)

        times[label] = {"eager_ms": min(cuda_ms(launch, 50), cuda_ms(launch, 50)), "graph_node_ms": graph_node_ms(launch)}
    outs = launch()
    bd = bound(nbytes(*gpu, *outs), 2 * int(gpu[6].sum()) * 64 * 64, F32_FLOPS)
    print(f"K2 with the camera axis, C = 4 x {MC_K2_CAMS} = {c} blocks: bitwise-equal to the plain version on "
          f"{n_cases} problems (det_free, det_key, out_row, track_col); per launch {json.dumps(times)}; plain (host "
          f"CPU) median {np.median(t_plain):.2f} ms; bound of the random problem {bd['bound_ms']:.6f} ms "
          f"({bd['bound_by']})")
    return {"c": c, "cases": n_cases, "max_abs_err": 0.0, "ms": times[f"c{c}_random"]["eager_ms"],
            "graph_node_ms": times[f"c{c}_steady"]["graph_node_ms"], "plain_ms": float(np.median(t_plain)),
            "times": times, **bd}


def check_multicam_parity(dev, paths):
    """f32: one `multicam_batch_step` of the cameras at B = 8 (the first
    frames of each multi-camera video) on the card equals the card's
    `pipeline_batch_step` camera by camera (track ids, mask, boxes and
    every integer state leaf; the float leaves' largest difference is
    printed) and the same multi-camera step on the CPU (track ids, mask
    and every integer state leaf). The threshold sits in a gap of the
    CPU's scores."""
    import torch

    from vehicle_counting_tpu_torch.models.reid import init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420, yuv420_content_to_full, yuv420_to_rgb_u8_planar
    from vehicle_counting_tpu_torch.parallel.cameras import camera_params, multicam_batch_step, regroup_states
    from vehicle_counting_tpu_torch.pipeline import step as step_mod
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n = 8, len(paths)
    net = autoshape_hw(SRC_HW, 640)
    cfg = YoloConfig(VARIANT, 80)
    yp = init_yolov5(torch.Generator().manual_seed(0), cfg)
    rp, rs = init_reid(torch.Generator().manual_seed(1))
    yuv = torch.from_numpy(np.stack([host_letterbox_yuv420(first_batch(p, b), net, content_only=True) for p in paths]))
    rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(yuv.reshape((n * b,) + yuv.shape[2:]), SRC_HW, net))
    conf, lut, gap = _gap_conf(yp, cfg, rgb.float() / 255.0, 20 * n * b)
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=4)
    kw = dict(ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW, conf_thres=conf, iou_thres=0.45, max_det=300,
              dtype=torch.float32, frames_format="letterboxed_yuv420")
    valid = torch.ones((n, b), dtype=torch.bool)
    to = _tree_to

    def multicam(d):
        states = regroup_states(init_states(camera_params(hp, n), d), (n, hp.num_classes))
        with torch.no_grad():
            st, out = multicam_batch_step(None, to(yp, d), to(rp, d), to(rs, d), states, yuv.to(d), valid.to(d),
                                          torch.from_numpy(lut).to(d), **kw)
        return TrackerState(*(x.cpu() for x in st)), [x.cpu() for x in out]

    (card_st, card_out), (cpu_st, cpu_out) = multicam(dev), multicam("cpu")
    ints = [f for f, x in zip(TrackerState._fields, card_st) if not x.is_floating_point()]
    floats = [f for f in TrackerState._fields if f not in ints]
    float_err, boxes_cpu = {f: 0.0 for f in floats}, True
    for i in range(n):
        with torch.no_grad():
            st, _, out = step_mod.pipeline_batch_step(
                to(yp, dev), to(rp, dev), to(rs, dev), init_states(hp, dev), yuv[i].to(dev), valid[i].to(dev),
                torch.from_numpy(lut).to(dev), **kw)
        st, out = TrackerState(*(x.cpu() for x in st)), [x.cpu() for x in out]
        for name, j in (("boxes", 0), ("ids", 1), ("mask", 3)):
            if not torch.equal(card_out[j][i], out[j]):
                raise AssertionError(f"multi-camera parity: camera {i} track {name} differ from its serial step on the card")
        for f in ints:
            if not torch.equal(getattr(card_st, f)[i], getattr(st, f)):
                raise AssertionError(f"multi-camera parity: camera {i} state {f} differs from its serial step on the card")
        for f in floats:
            float_err[f] = max(float_err[f], float((getattr(card_st, f)[i].float() - getattr(st, f).float()).abs().max()))
    for name, j in (("ids", 1), ("mask", 3)):
        if not torch.equal(card_out[j], cpu_out[j]):
            raise AssertionError(f"multi-camera parity: track {name} differ between card and CPU")
    for f in ints:
        if not torch.equal(getattr(card_st, f), getattr(cpu_st, f)):
            raise AssertionError(f"multi-camera parity: state {f} differs between card and CPU")
    boxes_cpu = bool(torch.equal(card_out[0], cpu_out[0]))
    step_mod.free_frame_runners()
    res = {"cameras": n, "b": b, "track_outputs": int(card_out[3].sum()), "gap": gap,
           "float_leaf_max_diff_vs_serial": float_err, "track_boxes_equal_cpu": boxes_cpu}
    print(f"multi-camera step, f32, {n} cameras x B={b}: card == card's serial step per camera (track ids, mask, "
          f"boxes, {len(ints)} integer state leaves) == CPU (ids, mask, integer leaves): {json.dumps(res)}")
    return res


def write_multicam_videos(tmp):
    """The multi-camera CLI's input: one directory of MC_FRAMES 1280x720
    videos, each from its own seed, with their zone files."""
    vids = os.path.join(tmp, "multicam")
    os.makedirs(vids)
    paths = [write_video(vids, n, f"cam_mc{i}", seed=SEED + 70 + i)[0] for i, n in enumerate(MC_FRAMES)]
    return vids, os.path.join(vids, "zones"), paths


def run_cli_dir(dev, tmp, vids, zones, conf, mapping, out, multicam, visualize=False, config_over=None, mesh=None):
    """The CLI over a directory of videos, serial or with --multicam
    (`config_over` sets configs.yaml keys; `mesh`, with multicam, the
    `MultiCamCountingPipeline` built on that mesh in place of `run.main`'s
    default one). Returns {camera-frames/s of the loops (decode to readback,
    no model init, CSV or MP4), the CLI's wall, the kernel counts of that
    run, K2 launches per card, each camera's frames, CSV rows and MP4
    path}."""
    import pandas as pd
    import torch

    from vehicle_counting_tpu_torch import run
    from vehicle_counting_tpu_torch.pipeline.multicam import MultiCamCountingPipeline

    out_dir = os.path.join(tmp, out)
    args = run.parser.parse_args(["--input_path", vids, "--output_path", out_dir, "--device", str(dev),
                                  "--mapping", json.dumps(mapping), *(("--multicam",) if multicam else ()),
                                  *(() if visualize else ("--no_visualize",))])
    config, cam_config = run.load_configs(args)
    config.min_conf = conf
    for key, value in (config_over or {}).items():
        setattr(config, key, value)
    cam_config.zone_path = zones
    counters = kernel_counters()
    zero_counts(counters)
    with k2_per_card() as per_card:
        t0 = time.perf_counter()
        if mesh is None:
            results = run.main(args, config, cam_config)
        else:
            args.mapping_dict = run._mapping_dict(args.mapping)
            results = MultiCamCountingPipeline(args, config, cam_config, mesh=mesh).run(visualize=visualize)
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        wall = time.perf_counter() - t0
    launches = read_counts(counters)
    failed = [r for r in results if not r.get("csv")]
    if failed:
        raise AssertionError(f"CLI over {vids} ({'multicam' if multicam else 'serial'}): failed {failed}")
    frames = [r["frames"] for r in results]
    if multicam:
        fps = results[0]["fps"]  # one group: the group's camera-frames/s
    else:
        fps = sum(frames) / sum(r["frames"] / r["fps"] for r in results)
    cams = [os.path.basename(r["csv"])[:-4] for r in results]
    return {"fps": fps, "wall_s": wall, "launches": launches, "k2_per_card": dict(per_card), "frames": frames,
            "batch": config.detect_batch, "dfs": {c: pd.read_csv(r["csv"]) for c, r in zip(cams, results)},
            "mp4": {c: os.path.join(out_dir, c + ".mp4") for c in cams}}


def _csv_diff(a, b):
    """(rows that differ, the first differing row of each) over every
    column but color, rows aligned in order."""
    cols = [c for c in a.columns if c != "color"]
    if a[cols].equals(b[cols]):
        return 0, None
    n = max(len(a), len(b))
    x, y = a[cols].reindex(range(n)), b[cols].reindex(range(n))
    bad = ~((x == y) | (x.isna() & y.isna())).all(axis=1)
    first = int(np.argmax(bad.to_numpy()))
    return int(bad.sum()), {"row": first, "serial": x.iloc[first].to_dict(), "multicam": y.iloc[first].to_dict()}


def run_multicam_cli(dev, tmp, vids, zones, conf, mapping):
    """`run.py --multicam` on MC_FRAMES videos (default config: B=128, bf16;
    the calibrated min_conf and mapping): CSVs and MP4s written, K1
    launched, K2 launched once per frame-round for all cameras, no K3. Then
    the serial CLI over the same directory: each camera's CSV against its
    serial one (all columns but color; a difference is counted and its
    first row printed: bf16 rounding of the tracker's batched matmul may
    differ across class counts). Then camera-frames/s without the MP4 pass,
    serial and multi-camera in turns."""
    mc = run_cli_dir(dev, tmp, vids, zones, conf, mapping, "out_mc", multicam=True, visualize=True)
    rounds = -(-max(MC_FRAMES) // mc["batch"]) * mc["batch"]
    if mc["frames"] != list(MC_FRAMES):
        raise AssertionError(f"multi-camera CLI: frames {mc['frames']}, want {list(MC_FRAMES)}")
    for cam, mp4 in mc["mp4"].items():
        if not (os.path.exists(mp4) and os.path.getsize(mp4) > 0):
            raise AssertionError(f"multi-camera CLI wrote no MP4 for {cam}")
    lc = mc["launches"]
    if lc["crops"] <= 0 or lc["cascade"] != rounds or lc["cascade_k3"] or lc["match_stage"]:
        raise AssertionError(f"multi-camera CLI launches {lc}: want K1 > 0, K2 = {rounds} (one per frame-round), no K3")
    fps = {"multicam": [mc["fps"]], "serial": []}
    walls = {"multicam": [mc["wall_s"]], "serial": []}
    diff, serial_launches = {}, None
    for i, kind in enumerate(("serial", "multicam", "multicam", "serial")):
        r = run_cli_dir(dev, tmp, vids, zones, conf, mapping, f"out_mcab{i}", multicam=kind == "multicam")
        fps[kind].append(r["fps"])
        walls[kind].append(r["wall_s"])
        if i == 0:
            serial_launches = r["launches"]
            for cam, df in r["dfs"].items():
                n_bad, first = _csv_diff(df, mc["dfs"][cam])
                diff[cam] = {"rows_serial": len(df), "rows_multicam": len(mc["dfs"][cam]), "rows_differing": n_bad,
                             "first": first}
        elif kind == "multicam":
            for cam, df in r["dfs"].items():
                if _csv_diff(df, mc["dfs"][cam])[0]:
                    raise AssertionError(f"multi-camera CLI: {cam}'s CSV differs between two multi-camera runs")
    rows = sum(d["rows_multicam"] for d in diff.values())
    if not rows:
        raise AssertionError("multi-camera CLI: no CSV row in any camera")
    print(f"multi-camera CLI, {len(MC_FRAMES)} cameras of {list(MC_FRAMES)} frames: {rows} CSV rows, counts written, "
          f"MP4s written; launches {lc} (K2 {lc['cascade']} = one per frame-round; the serial CLI over the same "
          f"videos: K2 {serial_launches['cascade']}, K1 {serial_launches['crops']})")
    print(f"multi-camera CSV vs serial CSV per camera (all columns but color): {json.dumps(diff, default=str)}")
    print(f"camera-frames/s of the loops, turns multicam (cold, MP4 after), serial, multicam, multicam, serial: "
          f"multicam {[round(v, 2) for v in fps['multicam']]}, serial {[round(v, 2) for v in fps['serial']]}; "
          f"CLI wall s (model init and counting included) multicam {[round(v, 2) for v in walls['multicam']]}, "
          f"serial {[round(v, 2) for v in walls['serial']]}")
    return {"launches": lc, "launches_serial": serial_launches, "rounds": rounds, "fps": fps, "wall_s": walls,
            "csv_vs_serial": diff, "rows": rows, "dfs": mc["dfs"]}


def multicam_tracker_ab(dev, fg):
    """`scan_frame_inputs` at B=128 in steady state, graph on, K2 route, at
    N_cam x C = 4, 16 and 32 classes: the graph phase's second batch (state
    warmed by the first) given to 1, 4 and 8 cameras alike, in turns;
    ms/frame on the host clock, and one replay's device kernels (count, K2
    among them, summed device ms) from the card's trace."""
    import torch

    from vehicle_counting_tpu_torch.parallel.cameras import camera_params
    from vehicle_counting_tpu_torch.pipeline import step as step_mod
    from vehicle_counting_tpu_torch.tracking.deepsort import FrameInputs, frame_inputs
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerState

    hp, warmed = fg["hp"], fg["runs"][False, False][0][0]
    det, feats = fg["batches"][1]
    b = feats.shape[0]
    with torch.no_grad():
        inp = frame_inputs(feats, det["boxes"], det["scores"], det["classes"], det["valid"], hp)
    cams = (1, 4, 8)
    cases = {n: (camera_params(hp, n), FrameInputs(*(torch.cat([x] * n, 1) for x in inp))) for n in cams}

    def scan_ms(n):
        hp_n, inp_n = cases[n]
        states = TrackerState(*(torch.cat([x] * n) for x in warmed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            step_mod.scan_frame_inputs(states, inp_n, hp=hp_n, src_hw=SRC_HW)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / b

    for n in cams:
        scan_ms(n)  # warm-up: the capture
    t = {n: [] for n in cams}
    for n in cams + cams[::-1]:
        t[n].append(scan_ms(n))
    replay = {}
    for n in cams:
        events = device_events(step_mod.frame_runner(cases[n][0], SRC_HW, dev)._step)
        replay[n * hp.num_classes] = {"device_kernels": len(events), "k2": sum("cascade_kernel" in e for e, _ in events),
                                      "device_ms": round(sum(ms for _, ms in events), 4)}
    step_mod.free_frame_runners()
    res = {"ms_per_frame": {n * hp.num_classes: v for n, v in t.items()}, "replay": replay}
    print(f"scan_frame_inputs ms/frame (B={b}, steady state, graph on, K2 route) by N_cam x C classes, turns "
          f"4, 16, 32, 32, 16, 4: {json.dumps(res['ms_per_frame'])}; per camera-frame at 16 / 32 classes: "
          f"{min(t[4]) / 4:.4f} / {min(t[8]) / 8:.4f} against {min(t[1]):.4f}; one replay: {json.dumps(replay)}")
    return res


@contextlib.contextmanager
def k2_per_card():
    """{card: K2 launches} of the frame-graph replays inside the block, by
    the replaying runner's device (the wrappers' counts are the process's,
    summed over cards)."""
    from vehicle_counting_tpu_torch.ops import cascade
    from vehicle_counting_tpu_torch.tracking import graph

    counts, real = collections.Counter(), graph.FrameRunner._step

    def step(self):
        real(self)
        counts[str(self.device)] += self.replay_launches.get(cascade.cascade_match_classparallel, 0)

    graph.FrameRunner._step = step
    try:
        yield counts
    finally:
        graph.FrameRunner._step = real


def camera_frames(paths, n_cam, frames):
    """[n_cam, frames, rows, 640] host-packed I420 (720p content rows): camera
    i's frames are the first `frames` of paths[i], or with one path its
    i-th run of `frames` frames."""
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420

    net = autoshape_hw(SRC_HW, 640)
    if len(paths) == 1:
        raw = first_batch(paths[0], n_cam * frames)
        cams = [raw[i * frames:(i + 1) * frames] for i in range(n_cam)]
    else:
        cams = [first_batch(p, frames) for p in paths[:n_cam]]
    return np.stack([host_letterbox_yuv420(c, net, content_only=True) for c in cams])


def check_camera_mesh_step(dev, yuv, mesh, b=8):
    """f32 (TF32 off), yolov5s, C=4, K=64: the cameras of `yuv` ([N, 2b, ...]
    host I420), padded with all-invalid cameras to a multiple of the mesh
    size, two chained batches of b frames through `multicam_batch_step`
    over `mesh` (frames uploaded per shard to its card, weights from
    `dev`), against the `mesh=None` step on `dev` over the same padded
    input: every state leaf and track output bitwise equal, camera by
    camera. Each shard must have replayed a frame runner of its own (one
    per slot, on its device) and launched K2 once per frame-round."""
    import torch

    from vehicle_counting_tpu_torch.models.reid import init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, init_yolov5
    from vehicle_counting_tpu_torch.ops import cascade, crops
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, yuv420_content_to_full, yuv420_to_rgb_u8_planar
    from vehicle_counting_tpu_torch.parallel.cameras import camera_params, join_shards, multicam_batch_step
    from vehicle_counting_tpu_torch.parallel.cameras import regroup_states
    from vehicle_counting_tpu_torch.pipeline import step as step_mod
    from vehicle_counting_tpu_torch.pipeline import upload_shards
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n_real = yuv.shape[0]
    total = n_real + (-n_real) % mesh.size
    n_local = total // mesh.size
    net = autoshape_hw(SRC_HW, 640)
    cfg = YoloConfig(VARIANT, 80)
    yp_cpu = init_yolov5(torch.Generator().manual_seed(0), cfg)
    rp, rs = init_reid(torch.Generator().manual_seed(1), device=dev)
    flat = torch.from_numpy(yuv.reshape((-1,) + yuv.shape[2:]))
    rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(flat, SRC_HW, net)).float() / 255.0
    conf, lut, gap = _gap_conf(yp_cpu, cfg, rgb, 20 * flat.shape[0])
    yp, lut = _tree_to(yp_cpu, dev), torch.from_numpy(lut).to(dev)
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=4)
    kw = dict(ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW, conf_thres=conf, iou_thres=0.45, max_det=300,
              dtype=torch.float32, frames_format="letterboxed_yuv420")
    padded = np.zeros((total,) + yuv.shape[1:], np.uint8)
    padded[:n_real] = yuv
    valid = np.zeros((total, 2 * b), bool)
    valid[:n_real] = True

    def run(m):
        """Both batches over mesh m (None: `dev` alone): [(joined state
        snapshot, joined outputs)] on the host."""
        states = regroup_states(init_states(camera_params(hp, total), dev), (total, hp.num_classes))
        got = []
        with torch.no_grad():
            for i in range(2):
                fr, va = padded[:, i * b:(i + 1) * b], valid[:, i * b:(i + 1) * b]
                if m is None:
                    fr, va = torch.from_numpy(fr).to(dev), torch.from_numpy(va).to(dev)
                else:
                    fr, va = upload_shards(fr, m), upload_shards(va, m)
                states, outs = multicam_batch_step(m, yp, rp, rs, states, fr, va, lut, **kw)
                st = join_shards(states, "cpu")
                got.append((TrackerState(*(x.clone() for x in st)), join_shards(outs, "cpu")))
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        return got

    want = run(None)
    step_mod.free_frame_runners()
    with k2_per_card() as per_card:
        crops.gather_crops_batch.launches = cascade.cascade_match_classparallel.launches = 0
        got = run(mesh)
        launches = {"crops": crops.gather_crops_batch.launches, "cascade": cascade.cascade_match_classparallel.launches}
    hp_local = camera_params(hp, n_local)
    runners = {key[3]: r for key, r in step_mod._RUNNERS.items() if key[0] == hp_local}
    step_mod.free_frame_runners()
    if sorted(runners) != list(range(mesh.size)) or len({id(r) for r in runners.values()}) != mesh.size:
        raise AssertionError(f"camera mesh: frame runners by slot {sorted(runners)}, want one per shard of {mesh.size}")
    if [runners[i].device for i in range(mesh.size)] != list(mesh.devices):
        raise AssertionError(f"camera mesh: runners on {[str(r.device) for r in runners.values()]}")
    for i, ((sw, ow), (sg, og)) in enumerate(zip(want, got)):
        for name, x, y in zip(sw._fields + ow._fields, tuple(sw) + tuple(ow), tuple(sg) + tuple(og)):
            for c in range(total):
                if not torch.equal(x[c], y[c]):
                    raise AssertionError(f"camera mesh {[str(d) for d in mesh.devices]}: batch {i} camera {c} {name} "
                                         f"differs from the unsharded step on {dev}")
    rounds = 2 * b
    if launches["cascade"] != mesh.size * rounds or launches["crops"] <= 0:
        raise AssertionError(f"camera mesh: launches {launches}, want K2 = {mesh.size} x {rounds} frame-rounds, K1 > 0")
    want_cards = {str(d): c * rounds for d, c in collections.Counter(mesh.devices).items()}
    if dict(per_card) != want_cards:
        raise AssertionError(f"camera mesh: K2 per card {dict(per_card)}, want {want_cards}")
    tracked = sum(int(o.mask[:n_real].sum()) for _, o in got)
    if not tracked or any(int(o.mask[n_real:].sum()) for _, o in got):
        raise AssertionError(f"camera mesh: {tracked} track outputs of the real cameras, or a padded camera tracked")
    res = {"cameras": n_real, "padded_to": total, "mesh": [str(d) for d in mesh.devices], "b": b, "batches": 2,
           "runners": mesh.size, "launches": launches, "k2_per_frame_round": launches["cascade"] / rounds,
           "k2_per_card": dict(per_card), "track_outputs": tracked, "gap": gap}
    print(f"camera mesh, f32, {n_real} cameras padded to {total} over {res['mesh']}, 2 x B={b}: every state leaf and "
          f"track output of every camera bitwise == the unsharded step on {dev}; {mesh.size} frame runners, one per "
          f"shard; {json.dumps(res)}")
    return res


def camera_mesh_cli(dev, tmp, vids, zones, conf, mapping, mesh, mc):
    """`MultiCamCountingPipeline(mesh=mesh)` over the multi-camera phase's
    videos at the default config (bf16, B=128), no MP4 pass: each camera's
    CSV row for row (all columns but color) against the `run --multicam`
    run of phase (c), K2 launched once per frame-round by each shard, K1
    launched. A failed camera fails the phase (`run_cli_dir`)."""
    r = run_cli_dir(dev, tmp, vids, zones, conf, mapping, "out_mc_mesh", multicam=True, mesh=mesh)
    diff = {cam: _csv_diff(mc_df, r["dfs"][cam]) for cam, mc_df in mc["dfs"].items()}
    lc = r["launches"]
    res = {"mesh": [str(d) for d in mesh.devices], "launches": lc, "k2_per_card": r["k2_per_card"],
           "rows": {cam: len(df) for cam, df in r["dfs"].items()},
           "rows_differing": {cam: d[0] for cam, d in diff.items()}, "fps": r["fps"]}
    print(f"MultiCamCountingPipeline over the camera mesh, against `run --multicam` on one card: {json.dumps(res)}")
    if set(r["dfs"]) != set(mc["dfs"]) or any(d[0] for d in diff.values()):
        raise AssertionError(f"camera mesh CLI: CSVs differ from the one-card --multicam run: "
                             f"{json.dumps({c: d for c, d in diff.items() if d[0]}, default=str)}")
    if lc["cascade"] != mesh.size * mc["rounds"] or lc["crops"] <= 0 or lc["cascade_k3"]:
        raise AssertionError(f"camera mesh CLI: launches {lc}, want K2 = {mesh.size} x {mc['rounds']} frame-rounds")
    return res


def cameras_over_cards(tmp, path, zones, conf, mapping, n):
    """(h) of --multi-card: cameras over every card. The f32 step with 2n + 1
    cameras over the n-card mesh against the unsharded step on cuda:0;
    `run --multicam --device cuda` (every card) against `--device cuda:0`
    at f32 over the multi-camera videos, each CSV row for row, K2 per card;
    the step alone at the main path's shapes on one card against n and
    against a thread per card, in turns, with each card's busy window
    (`benchmarks/micro/camera_dispatch.py`); the CLI's camera-frames/s on
    one card against n, in turns (the default config)."""
    import torch

    from vehicle_counting_tpu_torch.benchmarks.micro import camera_dispatch
    from vehicle_counting_tpu_torch.parallel.mesh import make_mesh

    dev, mesh = torch.device("cuda", 0), make_mesh(None, ("cam",))
    step = check_camera_mesh_step(dev, camera_frames([path], 2 * n + 1, 16), mesh)
    vids, mc_zones, _ = write_multicam_videos(tmp)
    runs = {k: run_cli_dir(d, tmp, vids, mc_zones, conf, mapping, f"mc_cards_{k}", multicam=True, config_over=F32)
            for k, d in (("one", "cuda:0"), ("every", "cuda"))}
    rounds = -(-max(MC_FRAMES) // int(runs["one"]["batch"])) * int(runs["one"]["batch"])
    diff = {cam: _csv_diff(df, runs["every"]["dfs"][cam])[0] for cam, df in runs["one"]["dfs"].items()}
    cli = {"rows": {cam: len(df) for cam, df in runs["one"]["dfs"].items()}, "rows_differing": diff,
           "launches": {k: r["launches"] for k, r in runs.items()}, "k2_per_card": {k: r["k2_per_card"] for k, r in runs.items()}}
    print(f"run --multicam --device cuda ({n} cards) against --device cuda:0, f32: {json.dumps(cli)}")
    want_cards = {str(d): rounds for d in mesh.devices}  # every card's shard replays, padded cameras and all
    if any(diff.values()) or not sum(cli["rows"].values()):
        raise AssertionError(f"(h): the CSVs over {n} cards differ from one card's: {diff}")
    if runs["every"]["k2_per_card"] != want_cards or runs["one"]["k2_per_card"] != {"cuda:0": rounds}:
        raise AssertionError(f"(h): K2 per card {cli['k2_per_card']}, want {want_cards} over the cards and "
                             f"{rounds} on cuda:0 alone")
    ab = camera_dispatch.measure(dev, mesh)
    print(f"the camera-sharded step alone, bf16, {ab['cameras']} cameras x 4 classes, B={ab['b']}, device-resident "
          f"frames, one card against {n} (passes) and against a thread per card (threads): {json.dumps(ab)}")
    fps = {"one": [], "every": []}
    for i, k in enumerate(("one", "every", "every", "one")):
        fps[k].append(run_cli_dir("cuda:0" if k == "one" else "cuda", tmp, vids, mc_zones, conf, mapping,
                                  f"mc_cards_fps{i}", multicam=True)["fps"])
    print(f"run --multicam camera-frames/s, default config, turns one card, {n} cards, {n} cards, one card: "
          f"{json.dumps(fps)}")
    return {"step": step, "cli": cli, "step_ab": ab, "cli_fps": fps}


def check_framedp(dev, path, mesh_b=None):
    """The frame-parallel step on the card at f32 (TF32 off), B=FP_B frames
    of the smoke video per batch (720p host-packed I420), two chained
    batches, yolov5s, C=4, K=64, the threshold in a gap of the CPU's
    scores. (a) on a mesh of [cuda:0]: every det and track output and
    every state leaf bitwise-equal to the serial step's. (b) on `mesh_b`
    (default [cuda:0, cuda:0]), n shards of FP_B/n: track ids, mask, boxes,
    the detections' classes and valid and the integer state leaves equal
    to the serial step at FP_B/n with the states chained (float leaves'
    largest difference printed); K1 launched by each shard (each shard's
    count is the serial B/n call's on the same frames), K2 once per frame.
    Returns (b)'s launches, its outputs for the multi-host phase and the
    ms per batch of the serial step and of (b) in turns."""
    import torch

    from vehicle_counting_tpu_torch.models.reid import init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, init_yolov5
    from vehicle_counting_tpu_torch.ops import cascade, crops
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420, yuv420_content_to_full, yuv420_to_rgb_u8_planar
    from vehicle_counting_tpu_torch.parallel.frames import make_framedp_step
    from vehicle_counting_tpu_torch.parallel.mesh import DeviceMesh
    from vehicle_counting_tpu_torch.pipeline import step as step_mod
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = FP_B
    net = autoshape_hw(SRC_HW, 640)
    cfg = YoloConfig(VARIANT, 80)
    yp_cpu = init_yolov5(torch.Generator().manual_seed(0), cfg)
    rp, rs = init_reid(torch.Generator().manual_seed(1), device=dev)
    yuv = torch.from_numpy(host_letterbox_yuv420(first_batch(path, 2 * b), net, content_only=True))
    rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(yuv, SRC_HW, net)).float() / 255.0
    conf, lut, gap = _gap_conf(yp_cpu, cfg, rgb, 20 * 2 * b)
    yp, lut = _tree_to(yp_cpu, dev), torch.from_numpy(lut).to(dev)
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=4)
    kw = dict(ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW, conf_thres=conf, iou_thres=0.45, max_det=300,
              dtype=torch.float32, frames_format="letterboxed_yuv420")
    batches = [yuv[i * b:(i + 1) * b].to(dev) for i in range(2)]
    valid = torch.ones(b, dtype=torch.bool, device=dev)
    snap = lambda st: TrackerState(*(x.clone() for x in st))

    def serial(shards):
        """The serial step over both batches, each in `shards` calls of
        b / shards frames, states chained. -> per batch (det, outs, state
        snapshot, K1 launches per call)."""
        n, got, states = b // shards, [], init_states(hp, dev)
        with torch.no_grad():
            for fr in batches:
                parts, k1 = [], []
                for j in range(shards):
                    crops.gather_crops_batch.launches = 0
                    states, det, out = step_mod.pipeline_batch_step(yp, rp, rs, states, fr[j * n:(j + 1) * n],
                                                                    valid[j * n:(j + 1) * n], lut, **kw)
                    torch.cuda.synchronize()
                    k1.append(crops.gather_crops_batch.launches)
                    parts.append((det, out))
                det = {k: torch.cat([p[0][k] for p in parts]) for k in parts[0][0]}
                out = type(parts[0][1])(*(torch.cat([p[1][i] for p in parts]) for i in range(len(parts[0][1]))))
                got.append((det, out, snap(states), k1))
        return got

    def framedp(mesh):
        step = make_framedp_step(mesh, **kw)
        got, states = [], init_states(hp, dev)
        crops.gather_crops_batch.launches = cascade.cascade_match_classparallel.launches = 0
        with torch.no_grad():
            for fr in batches:
                states, det, out = step(yp, rp, rs, lut, states, fr, valid)
                got.append((det, out, snap(states)))
        torch.cuda.synchronize()
        return got, {"crops": crops.gather_crops_batch.launches,
                     "cascade": cascade.cascade_match_classparallel.launches}

    ints = [f for f, x in zip(TrackerState._fields, init_states(hp, "meta")) if not x.is_floating_point()]
    # (a) one shard on [cuda:0] against the serial step, bitwise everywhere
    want = serial(1)
    got, _ = framedp(DeviceMesh((dev,), ("frame",)))
    for i, ((dw, ow, sw, _), (dg, og, sg)) in enumerate(zip(want, got)):
        for k in dw:
            if not torch.equal(dw[k], dg[k]):
                raise AssertionError(f"framedp (a), one shard: batch {i} det {k} differs from the serial step")
        for name, x, y in zip(ow._fields + sw._fields, tuple(ow) + tuple(sw), tuple(og) + tuple(sg)):
            if not torch.equal(x, y):
                raise AssertionError(f"framedp (a), one shard: batch {i} {name} differs from the serial step")
    tracked = sum(int(o.mask.sum()) for _, o, _ in got)
    if not tracked:
        raise AssertionError("framedp (a): no track output in two batches")
    print(f"framedp (a): mesh [cuda:0], f32, 2 x B={b} at 720p I420: every det / track output and all "
          f"{len(TrackerState._fields)} state leaves bitwise-equal to the serial step; {tracked} track outputs, "
          f"{int(sum(d['valid'].sum() for d, _, _ in got))} detections (threshold gap {gap:.2e})")

    # (b) n shards against the serial step at b/n, chained
    mesh2 = mesh_b or DeviceMesh((dev, dev), ("frame",))
    want = serial(mesh2.size)
    got, launches = framedp(mesh2)
    float_err = {}
    for i, ((dw, ow, sw, _), (dg, og, sg)) in enumerate(zip(want, got)):
        for k in ("classes", "valid"):
            if not torch.equal(dw[k], dg[k]):
                raise AssertionError(f"framedp (b), {mesh2.size} shards: batch {i} det {k} differs from the serial step")
        for name in ("ids", "mask", "boxes"):
            if not torch.equal(getattr(ow, name), getattr(og, name)):
                raise AssertionError(f"framedp (b), {mesh2.size} shards: batch {i} track {name} differs from the serial step")
        for name in ints:
            if not torch.equal(getattr(sw, name), getattr(sg, name)):
                raise AssertionError(f"framedp (b), {mesh2.size} shards: batch {i} state {name} differs from the serial step")
        for name in [f for f in TrackerState._fields if f not in ints] + ["det boxes", "det scores"]:
            x, y = (dw[name[4:]], dg[name[4:]]) if name.startswith("det ") else (getattr(sw, name), getattr(sg, name))
            float_err[name] = max(float_err.get(name, 0.0), float((x.float() - y.float()).abs().max()))
    per_shard = [k for _, _, _, k1 in want for k in k1]
    if launches["crops"] != sum(per_shard) or min(per_shard) <= 0:
        raise AssertionError(f"framedp (b): K1 launches {launches['crops']}, per shard of the serial calls {per_shard}")
    if launches["cascade"] != 2 * b:
        raise AssertionError(f"framedp (b): K2 launches {launches['cascade']} for {2 * b} frames")

    step2 = make_framedp_step(mesh2, **kw)
    runs = {"serial": lambda: step_mod.pipeline_batch_step(yp, rp, rs, init_states(hp, dev), batches[0], valid, lut, **kw),
            "two_shards": lambda: step2(yp, rp, rs, lut, init_states(hp, dev), batches[0], valid)}
    t = {k: [] for k in runs}
    with torch.no_grad():
        for k in ("serial", "two_shards", "two_shards", "serial"):
            t[k].append(host_ms(runs[k]))
    step_mod.free_frame_runners()
    res = {"b": b, "mesh": [str(d) for d in mesh2.devices], "launches": launches, "k1_per_shard": per_shard,
           "k2_per_frame": launches["cascade"] / (2 * b), "float_max_diff": float_err, "ms_per_batch": t, "gap": gap}
    print(f"framedp (b): mesh {res['mesh']}, 2 x B={b}: track ids, mask, boxes, det classes / valid and "
          f"{len(ints)} integer state leaves equal to the serial step at B/{mesh2.size} chained; K1 launches per "
          f"shard (batch by batch, shard by shard) {per_shard}, K2 {launches['cascade']} = one per frame; "
          f"{json.dumps(res)}")
    res["outputs"] = got[-1]
    return res


def run_frame_parallel_cli(dev, tmp, path, zones, conf, mapping, df, launches_default):
    """`run --frame_parallel` on the smoke video (one card: a no-op, as in
    the JAX package): the default run's CSV rows, all columns but color,
    and its K1 / K2 launches."""
    _, launches, got = run_pipeline(dev, tmp, path, zones, conf, mapping, N_FRAMES, "out_fp",
                                    extra_args=("--frame_parallel", "--no_visualize"))
    n_bad, first = _csv_diff(df, got)
    if n_bad or len(got) != len(df):
        raise AssertionError(f"--frame_parallel: {n_bad} rows differ from the default run's ({len(got)} vs "
                             f"{len(df)}), first {first}")
    for name in ("crops", "cascade"):
        if launches[name] != launches_default[name]:
            raise AssertionError(f"--frame_parallel: {launches[name]} {name} launches, the default run "
                                 f"{launches_default[name]}")
    res = {"rows": len(got), "rows_differing": n_bad, "launches": launches}
    print(f"--frame_parallel on one card: {json.dumps(res)} (the default run's CSV and launches)")
    return res


def _serving_config(dev, tmp):
    """(a configs.yaml, a --mapping) for the serving phase, calibrated as
    bench.py's load is on the random frames `serving.cli verify` draws (its
    seed 0), at bf16: the 4 classes the random-init detector finds most in
    frame 0 are tracked, and min_conf keeps ~30 of their detections per
    frame."""
    import torch
    import yaml

    from vehicle_counting_tpu_torch.benchmarks.load import calibrate_from_det
    from vehicle_counting_tpu_torch.configs import default_config
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, content_upload_exact
    from vehicle_counting_tpu_torch.pipeline.step import detect_only_step
    from vehicle_counting_tpu_torch.serving.artifact import serving_frames_shape

    net = autoshape_hw(SRC_HW, 640)
    b = int(default_config().detect_batch)
    yp = cast_params(init_yolov5(torch.Generator().manual_seed(0), YoloConfig(VARIANT, 80), dev), torch.bfloat16)
    fshape = serving_frames_shape("letterboxed_yuv420", b, SRC_HW, net)
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 255, fshape, dtype="uint8")).to(dev)
    with torch.no_grad():
        det = detect_only_step(yp, frames, ycfg=YoloConfig(VARIANT, 80), image_size=net, src_hw=SRC_HW,
                               conf_thres=0.0, max_det=300, dtype=torch.bfloat16,
                               content_only=content_upload_exact(SRC_HW, net))
    conf, _, top4 = calibrate_from_det(det, 30)
    settings = default_config().to_dict()
    settings["min_conf"] = conf
    path = os.path.join(tmp, "serving_configs.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"settings": settings}, f)
    mapping = json.dumps({str(c): i for i, c in enumerate(top4)})
    print(f"serving config: min_conf {conf:.6f}, mapping {mapping}")
    return path, mapping


def _serving_cli(*argv, card=None):
    """`python -m vehicle_counting_tpu_torch.serving.cli <argv>` in a fresh
    process from this checkout; -> its last stdout line as JSON. With
    `card`, the process makes cuda:<card> its current device (TF32 off)
    before the CLI's main, and the result gains each card's
    `max_memory_allocated` over the run."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    cmd = ["-m", "vehicle_counting_tpu_torch.serving.cli", *argv]
    if card is not None:
        cmd = ["-c", "import json, torch\n"
                     f"torch.cuda.set_device({card})\n"
                     "torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False\n"
                     "from vehicle_counting_tpu_torch.serving import cli\n"
                     f"cli.main({list(argv)!r})\n"
                     "print(json.dumps([torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count())]))\n"]
    proc = subprocess.run([sys.executable, *cmd], cwd=here, env=dict(os.environ, PYTHONPATH=here),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serving.cli {argv[0]} failed (rc {proc.returncode}):\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    if card is None:
        return json.loads(lines[-1])
    return dict(json.loads(lines[-2]), max_memory_allocated=json.loads(lines[-1]))


def run_serving(dev, tmp):
    """(d) `serving.cli export` of the production config (bf16, B=128, 720p
    I420, yolov5s, weights bundled; min_conf and the class map from
    `_serving_config`), then
    `verify` in a fresh process: bit_exact, K1, K2, K8, K9 and K10 loaded
    from the artifact's own kernels/ (not build/kernels/) and launched by
    its step (K8 20 times per K1 launch: a ReID forward per chunk; K2, K9
    and K10 once per frame), live and artifact ms per batch; `smoke` in a fresh process
    (frames/s); then a detect-only artifact and its `smoke`."""
    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.serving import cli

    cfg, mapping = _serving_config(dev, tmp)
    art, art_det = os.path.join(tmp, "artifact"), os.path.join(tmp, "artifact_detect")
    t0 = time.perf_counter()
    cli.main(["export", "--out", art, "--config", cfg, "--mapping", mapping, "--device", str(dev)])
    export_s = time.perf_counter() - t0
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    if sorted(manifest["kernels"]) != ["cascade", "crops", "reid_epilogue", "track_frame"]:
        raise AssertionError(f"serving: the artifact ships kernels {sorted(manifest['kernels'])}, want cascade, crops, "
                             f"reid_epilogue, track_frame")
    verify = _serving_cli("verify", "--artifact", art, "--batches", str(SERVE_BATCHES))
    kdir = os.path.realpath(os.path.join(art, "kernels"))
    build_dir = os.path.dirname(_build.library_path("crops"))
    frames = 2 * SERVE_BATCHES * verify["batch"]  # two passes of the chain
    if not verify["bit_exact"]:
        raise AssertionError(f"serving verify: {verify['mismatched_arrays']} arrays differ from the live step")
    for name in ("crops", "cascade", "reid_epilogue", "track_frame"):
        if os.path.realpath(verify["kernels_from"][name]) != kdir or verify["kernels_from"][name] == build_dir:
            raise AssertionError(f"serving verify: {name} loaded from {verify['kernels_from'][name]}, not {kdir}")
    if (verify["launches"]["K1"] <= 0 or verify["launches"]["K2"] != frames
            or verify["launches"]["K8"] != 20 * verify["launches"]["K1"]
            or verify["launches"]["K9"] != frames or verify["launches"]["K10"] != frames):
        raise AssertionError(f"serving verify: the artifact's step launched {verify['launches']} (K2 {frames} wanted)")
    smoke = _serving_cli("smoke", "--artifact", art, "--batches", str(SERVE_BATCHES))
    cli.main(["export", "--out", art_det, "--config", cfg, "--mapping", mapping, "--device", str(dev), "--detect_only"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["smoke", "--artifact", art_det, "--batches", str(SERVE_BATCHES)])
    smoke_det = json.loads(out.getvalue().strip().splitlines()[-1])
    res = {"export_s": export_s, "verify": verify, "smoke": smoke, "smoke_detect_only": smoke_det,
           "kernels": {k: v["key"] for k, v in manifest["kernels"].items()}}
    print(f"serving: export {export_s:.2f} s; verify (fresh process) bit_exact {verify['bit_exact']}, kernels from "
          f"{verify['kernels_from']}, launches {verify['launches']}, live {verify['live_ms_per_batch']:.3f} / artifact "
          f"{verify['artifact_ms_per_batch']:.3f} ms per batch of {verify['batch']}; smoke {smoke['fps']:.2f} frames/s "
          f"({smoke['dets_last_batch']} detections, {smoke['tracks_last_batch']} track outputs in the last batch); "
          f"detect-only smoke {smoke_det['fps']:.2f} frames/s")
    return res


def check_multihost_card(dev, outputs):
    """(e) a one-rank NCCL group through `initialize_multihost` on the card:
    `host_local_to_global` then `global_to_host_local` of framedp (b)'s
    last outputs give them back, and the gathered tensors equal them."""
    import socket

    import torch
    import torch.distributed as dist

    from vehicle_counting_tpu_torch.parallel.mesh import (
        global_to_host_local,
        host_local_to_global,
        initialize_multihost,
        make_global_mesh,
    )

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    det, out, _ = outputs
    initialize_multihost(f"localhost:{port}", 1, 0, device=dev)
    try:
        mesh = make_global_mesh(("frame",))
        names = []
        for name, x in [("det " + k, v) for k, v in sorted(det.items())] + list(zip(out._fields, out)):
            full = host_local_to_global(mesh, ("frame",), x)
            if not (torch.equal(full, x) and torch.equal(global_to_host_local(full), x)):
                raise AssertionError(f"multi-host round trip on the card changed {name}")
            names.append(name)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    res = {"backend": backend, "mesh": [str(d) for d in mesh.devices], "tensors": len(names)}
    print(f"multi-host (e): {json.dumps(res)}: every tensor of framedp (b)'s last batch back through the round trip")
    return res


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
    if profile_summary.main([trace_dir, "-n", "12", "--frames", str(N_SWITCHED), "--convs"]) != 0:
        raise AssertionError("profile_summary failed")
    events = profile_summary.read_events(trace_path)
    summ = profile_summary.summarize(profile_summary.device_events(events), frames=N_SWITCHED)
    own = summ["by_category"].get("vct kernels (csrc/)", 0.0)
    if summ["device_kernels"] <= 0 or own <= 0:
        raise AssertionError(f"--profile: the trace shows no device kernels / none of csrc/: {summ['by_category']}")
    convs = profile_summary.conv_calls(events)
    conv_us = sum(c.device_us for c in convs)
    if not convs or conv_us <= 0:
        raise AssertionError(f"--convs: {len(convs)} convolutions with {conv_us} us of device kernels")
    return {"fps_profiled": fps, "kernels_per_frame": summ["kernels_per_frame"], "busy_share": summ["busy_share"],
            "window_ms": summ["window_us"] / 1e3, "by_category_us": summ["by_category"], "launches": launches,
            "conv_calls": len(convs), "conv_calls_without_kernels": sum(c.device_us <= 0 for c in convs),
            "conv_device_ms": conv_us / 1e3,
            "conv_tflops": sum(c.flops for c in convs) / (conv_us * 1e-6) / 1e12}


def seeded_yolo_pt(path, rng, variant=VARIANT):
    """An ultralytics-style hub dict at `path`: a yolov5 state dict with
    ultralytics' names in fp16, drawn from `rng`. Returns the f32 arrays."""
    import torch

    from vehicle_counting_tpu_torch.testing import fake_yolov5_state_dict

    sd = fake_yolov5_state_dict(rng, variant, 80)
    torch.save({"model": {k: torch.from_numpy(v).half() for k, v in sd.items()}, "epoch": -1}, path)
    return sd


def run_weights(dev, tmp, path, zones):
    """The CLI with --weight and a ReID checkpoint made from seeds: a
    yolov5s state dict with ultralytics' names (.pt) and a net_dict (.t7).
    The loaded trees must be what a fold of the same arrays on the host
    gives, and the run must write its CSV. Returns (the run's summary, its
    CSV rows, (the .pt, the .t7))."""
    import torch

    from vehicle_counting_tpu_torch.models import convert
    from vehicle_counting_tpu_torch.models.reid import load_reid_weights
    from vehicle_counting_tpu_torch.testing import fake_reid_state_dict

    rng = np.random.default_rng(SEED + 9)
    pt, t7 = os.path.join(tmp, "yolov5s_seeded.pt"), os.path.join(tmp, "ckpt_seeded.t7")
    sd = seeded_yolo_pt(pt, rng)
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
    return {"fps": fps, "rows": len(df), "launches": launches}, df, (pt, t7)


class _Tee(io.TextIOBase):
    """Writes to every stream it holds (stdout, and a buffer to read)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for f in self.streams:
            f.write(s)
        return len(s)

    def flush(self):
        for f in self.streams:
            f.flush()


def run_weight_cache(dev, tmp, path, zones, seeded, df_weight, launches_weight):
    """The CLI without --weight, resolving the detector as the JAX package
    does. From a directory whose ./.cache holds run_weights' seeded .pt as
    yolov5s.pt: the CSV must be the --weight run's row for row, with as
    many K1 and K2 launches. From an empty directory: the fetch fails (this
    process refuses every fetch) and the detector is the seed-0 random
    init, with no file left in its ./.cache. Both run with the --weight
    run's other arguments; the working directory is restored after each."""
    pt, t7 = seeded
    run_args = dict(conf=0.001, mapping=None, n_frames=N_SWITCHED, extra_args=("--no_visualize", "--check_numerics"),
                    reid_checkpoint=t7)
    cached = os.path.join(tmp, "weight_cache")
    os.makedirs(os.path.join(cached, ".cache"))
    shutil.copyfile(pt, os.path.join(cached, ".cache", f"{VARIANT}.pt"))
    with contextlib.chdir(cached):
        fps, launches, df = run_pipeline(dev, tmp, path, zones, out="out_weight_cache", **run_args)
    n_bad, first = _csv_diff(df_weight, df)
    if n_bad:
        raise AssertionError(f"./.cache/{VARIANT}.pt: {n_bad} rows differ from the --weight run's ({len(df)} vs "
                             f"{len(df_weight)}), first {first}")
    for name in ("crops", "cascade"):
        if not 0 < launches[name] == launches_weight[name]:
            raise AssertionError(f"./.cache/{VARIANT}.pt: {launches[name]} {name} launches, the --weight run "
                                 f"{launches_weight[name]}")
    empty = os.path.join(tmp, "weight_none")
    os.makedirs(empty)
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.chdir(empty), contextlib.redirect_stdout(_Tee(sys.stdout, said)):
        _, launches_none, df_none = run_pipeline(dev, tmp, path, zones, out="out_weight_none", **run_args)
    wall_none = time.perf_counter() - t0
    text = said.getvalue()
    fetch = re.search(r"\[download\] could not fetch \S+ \(([0-9.]+) s\)", text)
    if fetch is None or "no weights available; using a random-init detector (seed 0)" not in text:
        raise AssertionError("an empty working directory: the failed fetch's or the random-init line is missing")
    left = os.listdir(os.path.join(empty, ".cache"))
    if left:
        raise AssertionError(f"the failed fetch left {left} in ./.cache")
    res = {"rows": len(df), "rows_differing": n_bad, "launches": launches, "fps": fps,
           "no_cache": {"fetch_s": float(fetch.group(1)), "rows": len(df_none), "launches": launches_none,
                        "cli_wall_s": wall_none}}
    print(f"weight cache: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# ReID training (train/), the tools, the soak, the graft entry
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_NC, TRAIN_STEPS, TRAIN_LR = 16, 8, 5, 0.005  # the parity run (tests/test_torch_train.py's shapes)
# f32 card == CPU after 5 steps, each leaf's error as a fraction of its
# gradient's size (params: of lr x the trace's largest value, one step's
# move). The step is chaotic in f32: on the host, oneDNN's f32 against the
# native f32 convolutions part by 0.65 / 2.1e-3 / 0.31 (param / stats /
# trace) after these 5 steps, f32 against f64 by 0.64 / 1.9e-3 / 0.18,
# the losses by 1.4 %. So these bounds are f32's spread; the f64 run holds
# the semantics.
TRAIN_F32_TOL, TRAIN_LOSS_RTOL = {"param": 2.0, "stats": 1e-2, "trace": 0.75}, 0.05
TRAIN_F64_TOL = 1e-8  # f64 card == CPU, every kind


def train_steps(device, dtype, steps=TRAIN_STEPS, b=TRAIN_B, nc=TRAIN_NC, lr=TRAIN_LR):
    """`steps` ReID train steps on `device` in `dtype` from one seeded init
    (drawn on the host) on one seeded batch, with dropout masks drawn on
    the host (the same on every device). Returns the per-step losses and
    accuracies and the final state as the checkpoint's leaves (params,
    stats, trace, count), with the param and stat counts."""
    import torch

    from vehicle_counting_tpu_torch.models import reid as reid_mod
    from vehicle_counting_tpu_torch.train import reid_train as rt

    rng = np.random.default_rng(SEED + 40)
    images = rng.normal(size=(b, 50, 50, 3)).astype(np.float32)
    labels = rng.integers(0, nc, b).astype(np.int32)
    masks = torch.Generator().manual_seed(SEED + 41)
    cfg = rt.ReidTrainConfig(num_classes=nc, batch_size=b, lr=lr)
    params, stats, opt, ost = rt.create_train_state(torch.Generator().manual_seed(SEED), cfg, 10, device)
    if dtype != torch.float32:
        params, stats, ost = rt.cast_train_state(params, stats, opt, dtype)
    keep = reid_mod.dropout_keep
    reid_mod.dropout_keep = lambda gen, shape, dev: keep(masks, shape, "cpu").to(dev)
    try:
        losses, accs = [], []
        for _ in range(steps):
            params, stats, ost, m = rt.train_step(params, stats, ost, images, labels, masks, opt=opt)
            losses.append(float(m["loss"]))
            accs.append(float(m["acc"]))
    finally:
        reid_mod.dropout_keep = keep
    return losses, accs, rt.checkpoint_leaves(params, stats, ost), len(rt._flatten(params)), len(rt._flatten(stats))


def _leaf_names(nc=TRAIN_NC):
    """The checkpoint's leaf names, in its order: params, stats, trace, count."""
    import torch

    from vehicle_counting_tpu_torch.models.reid import init_reid
    from vehicle_counting_tpu_torch.tools.convert_weights import _paths

    params, stats = init_reid(torch.Generator().manual_seed(0), num_classes=nc)
    p = [k for k, _ in _paths(params)]
    return p + [f"stats/{k}" for k, _ in _paths(stats)] + [f"trace/{k}" for k in p] + ["count"]


def _state_errors(got, want, n_p, n_s, lr):
    """Per leaf kind, the worst |got - want| as a fraction of the leaf's
    gradient's largest value (a param moves by lr x its trace; the stats
    by their own largest value), and the leaf it was at."""
    worst = {}
    for i, (g, w) in enumerate(zip(got[:-1], want[:-1])):
        if i < n_p:
            kind, scale = "param", lr * max(float(np.abs(want[n_p + n_s + i]).max()), 1e-3)
        elif i < n_p + n_s:
            kind, scale = "stats", max(float(np.abs(w).max()), 1e-3)
        else:
            kind, scale = "trace", max(float(np.abs(w).max()), 1e-3)
        err = float(np.abs(g.astype(np.float64) - w).max()) / scale
        if err >= worst.get(kind, (-1.0, 0))[0]:
            worst[kind] = (err, i)
    return worst


def check_reid_train_parity(dev):
    """5 ReID train steps (B=16, 8 classes, one batch) on the card against
    the same steps on the CPU, the same init, batch and dropout draws: in
    f32 (TF32 off) each leaf within TRAIN_F32_TOL of its gradient's size,
    the losses within TRAIN_LOSS_RTOL, the accuracies within one sample; in
    f64 every leaf within TRAIN_F64_TOL and the accuracies equal. Prints
    the worst leaf of each kind."""
    import torch

    names = _leaf_names()
    out = {}
    f64_tol = {k: TRAIN_F64_TOL for k in TRAIN_F32_TOL}
    for name, dtype, tol in (("f32", torch.float32, TRAIN_F32_TOL), ("f64", torch.float64, f64_tol)):
        t0 = time.perf_counter()
        lc, ac, card, n_p, n_s = train_steps(dev, dtype)
        t_card = time.perf_counter() - t0
        lh, ah, host, _, _ = train_steps(torch.device("cpu"), dtype)
        worst = {k: (e, names[i]) for k, (e, i) in _state_errors(card, host, n_p, n_s, TRAIN_LR).items()}
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        print(f"reid-train parity {name}: losses card {[round(x, 6) for x in lc]} host {[round(x, 6) for x in lh]} "
              f"(worst rel {loss_err:.3e}); acc card {ac} host {ah}; worst leaf per kind (error / gradient "
              f"scale, leaf index): {json.dumps(worst)}; card {t_card:.2f} s for {TRAIN_STEPS} steps incl. init")
        if card[-1] != host[-1] or card[-1] != TRAIN_STEPS:
            raise AssertionError(f"reid-train {name}: step counts {card[-1]} / {host[-1]}")
        if name == "f32":
            if loss_err > TRAIN_LOSS_RTOL or ac[0] != ah[0] or max(abs(a - b) for a, b in zip(ac, ah)) > 1.0 / TRAIN_B:
                raise AssertionError(f"reid-train f32: card losses / accuracies differ from the host's past the bounds")
        elif loss_err > TRAIN_F64_TOL or ac != ah:
            raise AssertionError(f"reid-train f64: card losses {lc} / accuracies {ac} != the host's {lh} / {ah}")
        bad = {k: v for k, v in worst.items() if v[0] > tol[k]}
        if bad:
            raise AssertionError(f"reid-train {name}: card leaves differ from the host's past {tol}: {bad}")
        out[name] = {"loss_card": lc, "loss_host": lh, "loss_worst_rel": loss_err, "worst": worst, "tol": tol}
    return out


def reid_train_throughput(dev, b=64, nc=751, steps=60, warm=5, b_feat=512):
    """The reference recipe's shapes: B=64 50x50 crops, 751 classes, SGD
    0.1 / 0.9 / 5e-4, augmentation (flip + rotation) on the card each step:
    train_step ms and images/s over `steps` steady steps (CUDA events), one
    step's device kernels and busy time from the card's trace, then
    `extract_features` at B=512, cuDNN and with the fused stage-1 block
    switched on (K5's f32 parity mode, FORCE_PALLAS_REID_BLOCK=1): that
    one held against the cuDNN one, with 2 K5 launches per call."""
    import torch

    from vehicle_counting_tpu_torch.models import reid as reid_mod
    from vehicle_counting_tpu_torch.ops import reid_block
    from vehicle_counting_tpu_torch.train import reid_train as rt
    from vehicle_counting_tpu_torch.train.augment import augment_batch

    cfg = rt.ReidTrainConfig(num_classes=nc, batch_size=b)
    params, stats, opt, ost = rt.create_train_state(torch.Generator().manual_seed(SEED), cfg, 100, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = torch.randn((4, b, 50, 50, 3), generator=gen, device=dev)
    labels = torch.randint(0, nc, (4, b), generator=gen, device=dev, dtype=torch.int32)
    state = {"stats": stats}

    def step(i):
        im = augment_batch(gen, data[i % 4])
        _, state["stats"], _, m = rt.train_step(params, state["stats"], ost, im, labels[i % 4], gen, opt=opt)
        return m

    for i in range(warm):
        step(i)
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        m = step(i)
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / steps
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"reid-train throughput: loss {loss}")
    events = device_events(lambda: step(0))  # one step's device kernels and copies, from the card's trace
    busy = sum(d for _, d in events)
    top = collections.Counter()
    for name, d in events:
        top[name[:50]] += d
    feats_in = torch.randn((b_feat, 50, 50, 3), generator=gen, device=dev)
    stats = state["stats"]
    feat_ms = cuda_ms(lambda: rt.extract_features(params, stats, feats_in), 10)
    plain = rt.extract_features(params, stats, feats_in)
    prev = reid_mod.FORCE_PALLAS_REID_BLOCK
    reid_mod.FORCE_PALLAS_REID_BLOCK = True
    try:
        reid_block.reid_block64.launches = 0
        fused = rt.extract_features(params, stats, feats_in)
        torch.cuda.synchronize(dev)
        k5 = reid_block.reid_block64.launches
        k5_ms = cuda_ms(lambda: rt.extract_features(params, stats, feats_in), 10)
    finally:
        reid_mod.FORCE_PALLAS_REID_BLOCK = prev
    err = float((fused - plain).abs().max())
    print(f"extract_features B={b_feat}: cuDNN {feat_ms:.4f} ms, through K5 f32 {k5_ms:.4f} ms ({k5} K5 launches per "
          f"call, max |diff| {err:.3e} against cuDNN's)")
    if k5 != 2:
        raise AssertionError(f"extract_features with the fused block launched K5 {k5} times, want 2 (stage 1)")
    if err > 1e-4:
        raise AssertionError(f"extract_features through K5 (f32) differs from cuDNN's by {err}")
    res = {"batch": b, "classes": nc, "train_step_ms": ms, "train_images_per_s": b * 1000.0 / ms,
           "steps_timed": steps, "last_loss": loss, "device_events_per_step": len(events),
           "device_busy_ms_per_step": busy, "device_busy_share": busy / ms,
           "top_device_ms": [[k, round(v, 4)] for k, v in top.most_common(4)], "extract_b": b_feat, "extract_ms": feat_ms,
           "extract_images_per_s": b_feat * 1000.0 / feat_ms, "extract_k5_ms": k5_ms,
           "extract_k5_images_per_s": b_feat * 1000.0 / k5_ms, "k5_launches_per_call": k5,
           "k5_vs_cudnn_max_abs": err}
    print(f"reid-train throughput: {json.dumps(res)}")
    return res


def write_image_folder(root, classes=8, train=24, test=8, seed=SEED + 50):
    """A class-per-directory image set ({root}/train, {root}/test), 64x32
    crops written with cv2: each class a colour with noise."""
    import cv2

    rng = np.random.default_rng(seed)
    for c in range(classes):
        colour = rng.integers(0, 256, 3)
        for split, n in (("train", train), ("test", test)):
            d = os.path.join(root, split, f"{c:04d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                img = np.clip(colour + rng.normal(0, 40, (64, 32, 3)), 0, 255).astype(np.uint8)
                cv2.imwrite(os.path.join(d, f"{i}.jpg"), img)
    return root


def _module(name, *argv, timeout=900):
    """`python -m name argv...` from this checkout; (rc, stdout + stderr)."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", name, *argv], cwd=here, env=dict(os.environ, PYTHONPATH=here),
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr


def run_reid_cli(tmp):
    """`reid_cli` on the card over a synthetic ImageFolder (8 classes, 24
    train / 8 test images each): 2 epochs (rc 0, new_ckpt.npz, train.jpg,
    the history printed), then --resume for one more epoch, which must
    start from the saved epoch."""
    import importlib.util

    data = write_image_folder(os.path.join(tmp, "reid_data"))
    ck = os.path.join(tmp, "reid_ckpt")
    t0 = time.perf_counter()
    rc, out = _module("vehicle_counting_tpu_torch.train.reid_cli", "--data_dir", data, "--epochs", "2", "--batch",
                      "32", "--checkpoint_dir", ck)
    wall = time.perf_counter() - t0
    print(out[-1500:])
    hist = [ln for ln in out.splitlines() if ln.startswith("best val acc")]
    if rc != 0 or not hist:
        raise AssertionError(f"reid_cli exited {rc}:\n{out[-3000:]}")
    ckpt = os.path.join(ck, "new_ckpt.npz")
    if not (os.path.exists(ckpt) and os.path.getsize(os.path.join(ck, "train.jpg")) > 1000):
        raise AssertionError("reid_cli wrote no new_ckpt.npz / train.jpg")
    saved_epoch = int(np.load(ckpt)["__meta__"][0])
    rc2, out2 = _module("vehicle_counting_tpu_torch.train.reid_cli", "--data_dir", data, "--epochs",
                        str(saved_epoch + 1), "--batch", "32", "--checkpoint_dir", ck, "--resume", ckpt)
    print(out2[-1500:])
    resumed = [ln for ln in out2.splitlines() if ln.startswith("[fit] resumed from")]
    if rc2 != 0 or not resumed or f"at epoch {saved_epoch} " not in resumed[0]:
        raise AssertionError(f"reid_cli --resume (saved epoch {saved_epoch}) exited {rc2}:\n{out2[-3000:]}")
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    print(f"matplotlib imports: {has_mpl} (train.jpg drawn with {'matplotlib' if has_mpl else 'cv2'})")
    return {"rc": rc, "wall_s": wall, "history": hist[0], "saved_epoch": saved_epoch, "resumed": resumed[0],
            "matplotlib": has_mpl}


def _egress_inputs(tmp, seed=SEED + 68):
    """Seeded fake checkpoints (a yolov5n .pt with ultralytics' names, a
    ReID .t7), a static 240x320 video of 16 frames, its zone, and the
    small configs the egress dry run uses (tests/test_egress_day.py's).
    The seed is one whose weights put detections of mapped (vehicle)
    classes in the top 8, so the steps have rows to compare."""
    import cv2
    import torch
    import yaml

    from vehicle_counting_tpu_torch.testing import fake_reid_state_dict, fake_yolov5_state_dict

    d = os.path.join(tmp, "egress")
    os.makedirs(os.path.join(d, "zones"))
    rng = np.random.default_rng(seed)
    pt, t7 = os.path.join(d, "yolov5n.pt"), os.path.join(d, "ckpt.t7")
    sd = fake_yolov5_state_dict(rng, "yolov5n", 80)
    torch.save({"model": {k: torch.from_numpy(v).half() for k, v in sd.items()}, "epoch": -1}, pt)
    torch.save({"net_dict": {k: torch.from_numpy(v) for k, v in fake_reid_state_dict(rng).items()}, "acc": 0.5,
                "epoch": 3}, t7)
    h, w = 240, 320
    img = cv2.GaussianBlur(rng.integers(0, 255, (h, w, 3), dtype=np.uint8), (7, 7), 3)
    video = os.path.join(d, "cam_rw.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h))
    for _ in range(16):
        writer.write(img)
    writer.release()
    with open(os.path.join(d, "zones", "cam_rw.json"), "w") as f:
        json.dump({"shapes": [{"label": "zone", "points": [[-5, -5], [w + 5, -5], [w + 5, h + 5], [-5, h + 5]]},
                              {"label": "direction01", "points": [[0, h // 2], [w, h // 2]]}]}, f)
    cfg, cam = os.path.join(d, "configs.yaml"), os.path.join(d, "cam_configs.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"settings": {"detect_batch": 8, "max_tracks_per_class": 16, "image_size": [192, 192],
                                     "model_name": "yolov5n", "min_conf": 1e-4, "max_det": 8,
                                     "compute_dtype": "float32"}}, f)
    with open(cam, "w") as f:
        yaml.safe_dump({"settings": {"zone_path": os.path.join(d, "zones"), "checkpoint": t7, "cam": {
            "cam_rw": {"tracking_config": {"MIN_CONFIDENCE": 0.0, "N_INIT": 2, "MAX_AGE": 5}}}}}, f)
    return d, pt, t7, video, cfg, cam


def run_tools(dev, tmp):
    """The tools on the card: e2e_smoke (the CLI in a subprocess, 48
    frames of 720p with a seeded .pt: schema and MP4 frame count); the
    soak at 1024 frames (fps first / last sample, RSS growth, peak device
    memory); the egress_day dry run on seeded fake checkpoints (rc 0);
    graft_entry's entry() once."""
    import torch

    from vehicle_counting_tpu_torch import graft_entry
    from vehicle_counting_tpu_torch.benchmarks import soak
    from vehicle_counting_tpu_torch.tools import e2e_smoke, egress_day

    out = {}
    pt = os.path.join(tmp, "yolov5s_e2e.pt")
    seeded_yolo_pt(pt, np.random.default_rng(SEED + 9))
    t0 = time.perf_counter()
    # the CLI's subprocess would try a real fetch without --weight
    rc = e2e_smoke.main(["--out", os.path.join(tmp, "e2e"), "--frames", "48", "--weight", pt])
    out["e2e_smoke"] = {"rc": rc, "wall_s": time.perf_counter() - t0}
    if rc != 0:
        raise AssertionError("e2e_smoke failed")
    t0 = time.perf_counter()
    rc = soak.main(["--frames", "1024", "--out", os.path.join(tmp, "soak"), "--sample_s", "1"])
    with open(os.path.join(tmp, "soak", "soak_report.json")) as f:
        rep = json.load(f)
    out["soak"] = {k: rep.get(k) for k in ("frames", "wall_s", "fps_overall", "fps_interval_first",
                                           "fps_interval_last", "fps_interval_min", "fps_interval_max",
                                           "rss_start_mb", "rss_end_mb", "rss_growth_mb", "device_peak_allocated_mb",
                                           "device_peak_reserved_mb", "csv_rows", "checks")}
    out["soak"]["script_s"] = time.perf_counter() - t0
    if rc != 0 or not rep["ok"]:
        raise AssertionError(f"soak failed: {out['soak']}")
    d, pt, t7, video, cfg, cam = _egress_inputs(tmp)
    args = egress_day.argparse.Namespace(yolo_pt=pt, reid_t7=t7, config=cfg, cam_config=cam, device="cuda")
    pre = egress_day._make_pipeline(args, os.path.join(d, "pre"))
    gt_csv = pre.run_video_detect_only(video)["csv"]
    ref_csv = pre.run_video(video, visualize=False)["csv"]
    import pandas as pd

    rows = {"gt": len(pd.read_csv(gt_csv)), "ref": len(pd.read_csv(ref_csv))}
    if not (rows["gt"] and rows["ref"]):
        raise AssertionError(f"egress_day dry run: the fake weights gave no rows to compare {rows}")
    rc = egress_day.main(["--yolo_pt", pt, "--reid_t7", t7, "--workdir", os.path.join(d, "work"), "--val_video",
                          video, "--gt", gt_csv, "--map50_min", "0.5", "--parity_video", video, "--ref_csv",
                          ref_csv, "--config", cfg, "--cam_config", cam])
    out["egress_day"] = {"rc": rc, "rows": rows}
    if rc != 0:
        raise AssertionError("egress_day dry run failed")
    fn, fargs = graft_entry.entry()
    t0 = time.perf_counter()
    det = fn(*fargs)
    torch.cuda.synchronize(dev)
    out["graft_entry"] = {"s": time.perf_counter() - t0, "shapes": {k: list(v.shape) for k, v in det.items()},
                          "device": str(det["boxes"].device)}
    if det["boxes"].shape != (1, 300, 4) or det["boxes"].device.type != "cuda":
        raise AssertionError(f"graft_entry.entry(): {out['graft_entry']}")
    print(f"tools: {json.dumps(out)}")
    return out


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


def framedp_production_ab(dev, path, mesh, conf, mapping, b=128):
    """The main path's shapes (yolov5s bf16, B=128 of the smoke video, 720p
    host-packed I420, the calibrated load): `pipeline_batch_step` on one card
    against the frame-parallel step over `mesh`, each from a fresh tracker
    state, ms per batch on the host clock in turns (serial, frame-parallel,
    frame-parallel, serial), every card synchronised."""
    import torch

    from vehicle_counting_tpu_torch.models.detector import class_lut
    from vehicle_counting_tpu_torch.models.reid import cast_conv_weights, init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420
    from vehicle_counting_tpu_torch.parallel.frames import make_framedp_step
    from vehicle_counting_tpu_torch.pipeline import step as step_mod
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    net = autoshape_hw(SRC_HW, 640)
    cfg = YoloConfig(VARIANT, 80)
    yp = cast_params(init_yolov5(torch.Generator().manual_seed(0), cfg, dev), torch.bfloat16)
    rp, rs = init_reid(torch.Generator().manual_seed(1), device=dev)
    rp = cast_conv_weights(rp, torch.bfloat16)
    lut = torch.from_numpy(class_lut(80, mapping)).to(dev)
    hp = DeepSortParams(tracker=TrackerParams(feat_dtype="bfloat16"), num_classes=4)
    kw = dict(ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW, conf_thres=conf, iou_thres=0.45, max_det=300,
              dtype=torch.bfloat16, frames_format="letterboxed_yuv420")
    yuv = torch.from_numpy(host_letterbox_yuv420(first_batch(path, b), net, content_only=True)).to(dev)
    valid = torch.ones(b, dtype=torch.bool, device=dev)
    step = make_framedp_step(mesh, **kw)
    runs = {"serial": lambda: step_mod.pipeline_batch_step(yp, rp, rs, init_states(hp, dev), yuv, valid, lut, **kw),
            "framedp": lambda: step(yp, rp, rs, lut, init_states(hp, dev), yuv, valid)}
    t = {k: [] for k in runs}
    with torch.no_grad():
        for fn in runs.values():
            fn()  # warm-up: the frame graph's capture, cuDNN's plans on every card
        for k in ("serial", "framedp", "framedp", "serial"):
            t[k].append(host_ms(runs[k]))
    step_mod.free_frame_runners()
    res = {"b": b, "mesh": [str(d) for d in mesh.devices], "ms_per_batch": t}
    print(f"frame-parallel at the main path's shapes: {json.dumps(res)}")
    return res


def framedp_cli_ab(dev, tmp, path, zones, conf, mapping):
    """`run` on the smoke video without the MP4 pass, default and with
    --frame_parallel (every card) in turns: frames/s, K1 / K2 launches,
    and the frame-parallel CSV against the default one (rows differing are
    counted, not refused: at bf16 a detection within ~1e-3 of a threshold
    may flip with the batch extent, as the JAX CLI's help says)."""
    fps, launches, dfs = {"default": [], "frame_parallel": []}, {}, {}
    for i, kind in enumerate(("default", "frame_parallel", "frame_parallel", "default")):
        extra = ("--no_visualize",) + (("--frame_parallel",) if kind == "frame_parallel" else ())
        got, launches[kind], dfs[kind] = run_pipeline(dev, tmp, path, zones, conf, mapping, N_FRAMES, f"out_mc{i}",
                                                      extra_args=extra)
        fps[kind].append(got)
    if launches["frame_parallel"]["cascade"] != N_FRAMES or launches["frame_parallel"]["crops"] <= 0:
        raise AssertionError(f"--frame_parallel over every card: launches {launches['frame_parallel']}")
    n_bad, first = _csv_diff(dfs["default"], dfs["frame_parallel"])
    res = {"fps": fps, "launches": launches, "rows": {k: len(v) for k, v in dfs.items()}, "rows_differing": n_bad,
           "first_differing": first}
    print(f"--frame_parallel over every card against the default run: {json.dumps(res, default=str)}")
    return res


FLEET_CAMS = 2  # cameras per process of the --multi-card fleet


def fleet(addr, n, rank, device):
    """One process of the camera fleet: joins the process group at `addr`
    as `rank` of `n` (`initialize_multihost`: NCCL on a card), runs its
    FLEET_CAMS cameras (8 random 720p frames each, seeded by the global
    camera id; yolov5s f32) through `multicam_batch_step` with no
    collective, holds them against its serial steps, then gathers every
    rank's track outputs (`host_local_to_global`) and holds each camera's
    against its serial step, and the round trip (`global_to_host_local`)
    against its own. Prints one JSON line."""
    import torch
    import torch.distributed as dist

    from vehicle_counting_tpu_torch.models.reid import init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420
    from vehicle_counting_tpu_torch.parallel.cameras import camera_params, multicam_batch_step, regroup_states
    from vehicle_counting_tpu_torch.parallel.mesh import (
        global_to_host_local,
        host_local_to_global,
        initialize_multihost,
        make_global_mesh,
    )
    from vehicle_counting_tpu_torch.pipeline.step import pipeline_batch_step
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    dev = torch.device(device)
    initialize_multihost(addr, n, rank, device=dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_global_mesh(("cam",))
    cfg, b, net = YoloConfig(VARIANT, 80), 8, autoshape_hw(SRC_HW, 640)
    yp = init_yolov5(torch.Generator().manual_seed(0), cfg, dev)
    rp, rs = init_reid(torch.Generator().manual_seed(1), device=dev)
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=4)
    lut = torch.arange(80, dtype=torch.int32, device=dev) % 4
    kw = dict(ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW, conf_thres=0.25, iou_thres=0.45, max_det=300,
              dtype=torch.float32, frames_format="letterboxed_yuv420")
    valid = torch.ones(b, dtype=torch.bool, device=dev)

    def frames(g):
        rgb = np.random.default_rng(SEED + 90 + g).integers(0, 255, (b,) + SRC_HW + (3,), np.uint8)
        return torch.from_numpy(host_letterbox_yuv420(rgb, net, content_only=True)).to(dev)

    def serial(g):
        with torch.no_grad():
            _, det, out = pipeline_batch_step(yp, rp, rs, init_states(hp, dev), frames(g), valid, lut, **kw)
        return int(det["valid"].sum()), out

    mine = [rank * FLEET_CAMS + c for c in range(FLEET_CAMS)]
    states = regroup_states(init_states(camera_params(hp, FLEET_CAMS), dev), (FLEET_CAMS, hp.num_classes))
    with torch.no_grad():
        _, touts = multicam_batch_step(None, yp, rp, rs, states, torch.stack([frames(g) for g in mine]),
                                       valid.expand(FLEET_CAMS, b).contiguous(), lut, **kw)
    want = {g: serial(g) for g in range(n * FLEET_CAMS)}
    for c, g in enumerate(mine):
        for name in ("ids", "mask", "boxes"):
            if not torch.equal(getattr(touts, name)[c], getattr(want[g][1], name)):
                raise AssertionError(f"fleet rank {rank}: camera {g} track {name} differs from its serial step")
    for name in ("ids", "mask", "boxes"):
        local = getattr(touts, name)
        full = host_local_to_global(mesh, ("cam",), local)
        if not torch.equal(global_to_host_local(full), local):
            raise AssertionError(f"fleet rank {rank}: the round trip changed {name}")
        for g in range(full.shape[0]):
            if not torch.equal(full[g], getattr(want[g][1], name)):
                raise AssertionError(f"fleet rank {rank}: gathered camera {g} track {name} differs from its serial step")
    res = {"rank": rank, "ranks": n, "device": str(dev), "backend": dist.get_backend(), "cams": mine,
           "detections": sum(d for d, _ in want.values()), "track_outputs": sum(int(o.mask.sum()) for _, o in want.values())}
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"fleet": res}))
    return res


def run_fleet(n):
    """n processes of this script (`--fleet-worker`), one per card, as one
    NCCL group on localhost; each must print its JSON line and exit 0."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--fleet-worker", f"localhost:{port}", str(n),
                               str(r)], cwd=here, env=dict(os.environ, PYTHONPATH=here), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    res = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith('{"fleet"')]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"fleet rank {r} failed (rc {p.returncode}):\n{out[-3000:]}")
        res.append(json.loads(lines[-1])["fleet"])
    print(f"fleet of {n} processes: {json.dumps(res)}")
    return res


def fleet_worker(argv) -> int:
    """`python3 chip_smoke.py --fleet-worker ADDR N RANK`: one process of
    `run_fleet`, driving card RANK."""
    addr, n, rank = argv[1], int(argv[2]), int(argv[3])
    fleet(addr, n, rank, f"cuda:{rank}")
    return 0


def multi_card_train(n, per_card=64, steps=20):
    """The data-parallel ReID train_step over n cards against one card
    (`graft_entry.dp_train_check`: f32 loss and first leaf at the JAX DP
    test's tolerances, every leaf in f64 to 1e-9 of its gradient's size),
    then images/s at B=64 per card: one card against n cards (the batch
    split over them, the whole batch's BN statistics and loss)."""
    import torch

    from vehicle_counting_tpu_torch import graft_entry
    from vehicle_counting_tpu_torch.parallel.mesh import make_mesh
    from vehicle_counting_tpu_torch.train import reid_train as rt

    mesh = make_mesh(n, ("data",))
    out = {"f32": graft_entry.dp_train_check(mesh), "f64": graft_entry.dp_train_check(mesh, dtype=torch.float64)}
    d0 = mesh.devices[0]
    for name, m, b in (("one_card", None, per_card), (f"{n}_cards", mesh, per_card * n)):
        cfg = rt.ReidTrainConfig(batch_size=b)
        params, stats, opt, ost = rt.create_train_state(torch.Generator().manual_seed(SEED), cfg, 100, d0)
        gen = torch.Generator(device=d0).manual_seed(SEED)
        im = torch.randn((b, 50, 50, 3), generator=gen, device=d0)
        lb = torch.randint(0, cfg.num_classes, (b,), generator=gen, device=d0)
        holder = {"stats": stats}

        def step():
            _, holder["stats"], _, _ = rt.train_step(params, holder["stats"], ost, im, lb, gen, opt=opt, mesh=m)

        step()
        ms = host_ms(step, steps)
        out[name] = {"batch": b, "ms_per_step": ms, "images_per_s": b * 1000.0 / ms}
    print(f"multi-card train: {json.dumps(out, default=str)}")
    return out


F32 = {"compute_dtype": "float32"}  # f32 pipelines turn TF32 off


def _card1_against_card0(what, runs):
    """runs {card: (launches, {camera: CSV rows})} for cards 0 and 1: the
    same launches, the same cameras, every CSV equal row for row (all
    columns but the per-track colour), some rows in all."""
    diff = {}
    for cam, df0 in runs[0][1].items():
        df1 = runs[1][1].get(cam)
        n_bad, first = _csv_diff(df0, df1) if df1 is not None else (len(df0), "missing on cuda:1")
        diff[cam] = {"rows": [len(df0), None if df1 is None else len(df1)], "differing_rows": n_bad, "first": first}
    res = {"launches": [runs[i][0] for i in (0, 1)], "csv": diff}
    print(f"{what}, cuda:1 against cuda:0 at f32: {json.dumps(res, default=str)}")
    if (runs[0][0] != runs[1][0] or set(runs[0][1]) != set(runs[1][1])
            or any(d["differing_rows"] for d in diff.values()) or not sum(d["rows"][0] for d in diff.values())):
        raise AssertionError(f"{what}: cuda:1 differs from cuda:0: {res}")
    return res


def serial_cli_on_card1(tmp, path, zones, conf, mapping):
    """The serial CLI with --device cuda:1 against --device cuda:0, f32
    (compute_dtype float32; TF32 off), no MP4 pass: the CSVs equal row for
    row (every column but the per-track colour), the same kernel launches."""
    import torch

    runs, fps = {}, []
    for i in (0, 1):
        f, launches, df = run_pipeline(torch.device("cuda", i), tmp, path, zones, conf, mapping, out=f"f32_cuda{i}",
                                       extra_args=("--no_visualize",), config_over=F32)
        runs[i] = (launches, {"cam": df})
        fps.append(f)
    return dict(_card1_against_card0("serial CLI", runs), fps=fps)


def detect_only_on_card1(tmp, path, zones, conf, mapping):
    """`run --detect_only --device cuda:1` against cuda:0 at f32: the
    detections CSVs equal row for row, the same (tracker-free) launches."""
    import torch

    runs = {}
    for i in (0, 1):
        _, launches, df = run_detect_only(torch.device("cuda", i), tmp, path, zones, conf, mapping,
                                          out=f"det_f32_cuda{i}", config_over=F32)
        runs[i] = (launches, {"detections": df})
    return _card1_against_card0("detect-only CLI", runs)


def multicam_on_card1(tmp, conf, mapping):
    """`run --multicam --device cuda:1` against cuda:0 at f32, no MP4 pass,
    over the multi-camera phase's four videos: each camera's CSV equal row
    for row, the same launches (K2 once per frame-round)."""
    import torch

    vids, zones, _ = write_multicam_videos(tmp)
    runs = {}
    for i in (0, 1):
        r = run_cli_dir(torch.device("cuda", i), tmp, vids, zones, conf, mapping, f"mc_f32_cuda{i}", multicam=True,
                        config_over=F32)
        runs[i] = (r["launches"], r["dfs"])
    return _card1_against_card0("multi-camera CLI", runs)


def serving_on_card1(tmp):
    """`serving.cli export --device cuda:<i>` of the serving phase's
    configuration at f32, then `verify` in a fresh process whose current
    device is cuda:<i> (the artifact records only the platform, so verify
    runs on the current device), for i = 0 and 1: bit_exact on both, the
    same launches, and the step's memory on card i alone."""
    import torch
    import yaml

    from vehicle_counting_tpu_torch.serving import cli

    cfg, mapping = _serving_config(torch.device("cuda", 0), tmp)
    with open(cfg) as f:
        settings = yaml.safe_load(f)
    settings["settings"].update(F32)
    cfg = os.path.join(tmp, "serving_configs_f32.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(settings, f)
    res = {}
    for i in (0, 1):
        art = os.path.join(tmp, f"artifact_f32_cuda{i}")
        cli.main(["export", "--out", art, "--config", cfg, "--mapping", mapping, "--device", f"cuda:{i}"])
        v = _serving_cli("verify", "--artifact", art, "--batches", str(SERVE_BATCHES), card=i)
        mem = v["max_memory_allocated"]
        res[i] = {k: v[k] for k in ("bit_exact", "launches", "live_ms_per_batch", "artifact_ms_per_batch")}
        res[i]["max_memory_allocated"] = mem
        if not v["bit_exact"] or not mem[i] or any(m for d, m in enumerate(mem) if d != i):
            raise AssertionError(f"serving verify with cuda:{i} current: {res[i]} (bit_exact, and memory on card "
                                 f"{i} alone, wanted)")
    print(f"serving verify, cuda:1 current against cuda:0 current, f32: {json.dumps(res)}")
    if res[0]["launches"] != res[1]["launches"] or not res[1]["launches"]["K2"]:
        raise AssertionError(f"serving verify: launches on cuda:1 {res[1]['launches']}, cuda:0 {res[0]['launches']}")
    return res


def second_card(tmp, path, zones, conf, mapping):
    """(e) of --multi-card: every entry point that takes a device, on cuda:1
    against cuda:0 at f32."""
    return {"serial_cli": serial_cli_on_card1(tmp, path, zones, conf, mapping),
            "detect_only": detect_only_on_card1(tmp, path, zones, conf, mapping),
            "multicam": multicam_on_card1(tmp, conf, mapping), "serving": serving_on_card1(tmp)}


def multi_card(argv) -> int:
    """`python3 chip_smoke.py --multi-card`: what exists only across cards,
    on every card of the machine (two or more; one JSON line at the end):
    (a) `check_framedp` with its shards over every card (f32, 2 x B=8: one
    shard bitwise == serial, n shards == the serial step at B/n chained,
    K1 per shard, K2 per frame); (b) the main path's shapes, the serial
    step on one card against the frame-parallel step over every card, ms
    per batch in turns; (c) `run --frame_parallel` against the default run
    on the smoke video, in turns; (d) the camera fleet, one process per
    card joined over NCCL (`run_fleet`); (e) the serial CLI with --device
    cuda:1 against cuda:0 at f32, row for row, then the other entry points
    that take a device the same way: `run --detect_only` and `run
    --multicam` (each CSV row for row, the same launches), and `serving.cli
    export --device cuda:<i>` with `verify` in a fresh process whose
    current device is cuda:<i> (bit_exact, the same launches, the step's
    memory on that card alone); (f) the data-parallel ReID train step over
    every card against one card, and images/s; (g)
    `graft_entry.dryrun_multichip` over every card; (h) cameras over every
    card (`cameras_over_cards`): the f32 camera-sharded step with 2n + 1
    cameras against the unsharded step, `run --multicam --device cuda`
    against `--device cuda:0` (CSVs row for row, K2 per card), and one card
    against n in turns for the step alone (bf16, 4 cameras x 4 classes,
    B=128, each card's busy window) and for the CLI's camera-frames/s.
    `--parts h` (any letters) runs only those parts."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_smoke --multi-card: {n} CUDA device(s); this mode needs two or more", file=sys.stderr)
        return 2
    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.parallel.mesh import make_mesh
    from vehicle_counting_tpu_torch.utils.device import card_line

    parts = set(_flag_value("--parts") or "abcdefgh")  # e.g. --parts h: only the cameras over every card
    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"[cards] {n} x {torch.cuda.get_device_name(0)}; {card}; parts {''.join(sorted(parts))}")
    _build.load_all(("crops", "cascade", "reid_block"))
    mesh = make_mesh(None, ("frame",))
    out = {"cards": n, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        path, zones = write_video(tmp)
        conf, mapping = calibrate(dev, path)
        if "a" in parts:
            phase(f"multi-card (a): the frame-parallel step, shards over {n} cards", card)
            out["framedp"] = check_framedp(dev, path, mesh)
            out["framedp"].pop("outputs")
        if "b" in parts:
            phase("multi-card (b): the main path's shapes, one card against every card", card)
            out["main_path_shapes"] = framedp_production_ab(dev, path, mesh, conf, mapping)
        if "c" in parts:
            phase("multi-card (c): the CLI with --frame_parallel against the default run", card)
            out["cli"] = framedp_cli_ab(dev, tmp, path, zones, conf, mapping)
        if "e" in parts:
            phase("multi-card (e): the serial CLI, detect-only, multicam and serving on cuda:1 against cuda:0, f32",
                  card)
            out["cuda1"] = second_card(tmp, path, zones, conf, mapping)
        if "h" in parts:
            phase(f"multi-card (h): cameras over every card ({n})", card)
            out["cameras"] = cameras_over_cards(tmp, path, zones, conf, mapping, n)
    if "d" in parts:
        phase(f"multi-card (d): the camera fleet, {n} processes over NCCL", card)
        out["fleet"] = run_fleet(n)
    if "f" in parts:
        phase(f"multi-card (f): the data-parallel ReID train step over {n} cards against one", card)
        out["train"] = multi_card_train(n)
    if "g" in parts:
        phase(f"multi-card (g): graft_entry.dryrun_multichip({n})", card)
        from vehicle_counting_tpu_torch import graft_entry

        out["dryrun"] = graft_entry.dryrun_multichip(n)
    print(json.dumps({"multi_card": out}, default=str))
    return 0


def _flag_value(flag):
    """The value after `flag` on the command line, or None."""
    argv = sys.argv[1:]
    return argv[argv.index(flag) + 1] if flag in argv[:-1] else None


def refuse_fetches():
    """Every URL fetch of this process fails at once, as on a machine with
    no network, without trying to reach the host."""
    import urllib.error
    import urllib.request

    def refuse(url, *args, **kwargs):
        raise urllib.error.URLError(f"chip_smoke fetches nothing ({getattr(url, 'full_url', url)})")

    urllib.request.urlopen = refuse


def main() -> int:
    refuse_fetches()
    if "--multi-card" in sys.argv[1:]:
        return multi_card(sys.argv[1:])
    if "--fleet-worker" in sys.argv[1:]:
        return fleet_worker(sys.argv[1:])
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
    phase("K4 through solve_assignment: full [N, M] costs, one launch per call", card)
    sa = check_solve_assignment(dev)
    phase("K5 fused ReID stage-1 block", card)
    k5 = check_k5(dev, _flag_value("--k5-parent"))
    phase("embed A/B: ReID embed with K5 off and on", card)
    emb = embed_ab(dev)
    phase("K8 ReID BN epilogue", card)
    k8 = check_reid_epilogue(dev)
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
        if launches["track_pre"] != N_FRAMES or launches["track_post"] != N_FRAMES:
            raise AssertionError(f"the main path replays one K9 and one K10 launch per frame: {launches['track_pre']} "
                                 f"and {launches['track_post']} for {N_FRAMES} frames")
        if launches["reid_epilogue"] != 20 * launches["crops"]:
            raise AssertionError(f"the main path's embed: {launches['reid_epilogue']} K8 launches for {launches['crops']} "
                                 f"chunks (K1 launches), want 20 per chunk's ReID forward")
        phase("pipeline A/B: the CLI with the frame graph off / off / on", card)
        cli_fps = run_cli_ab(dev, tmp, path, zones, conf, mapping, df, fps)
        phase("switched pipeline: fused ReID block + staged association", card)
        graph_mod.warmup_launches.clear()
        launches_sw, df_sw = run_switched(dev, tmp, path_sw, zones_sw, conf, mapping)
        warmup["match_stage"] = graph_mod.warmup_launches.get("match_stage_batched", 0)
        if launches_sw["reid_epilogue"] != 16 * launches_sw["crops"]:
            raise AssertionError(f"the switched path's embed: {launches_sw['reid_epilogue']} K8 launches for "
                                 f"{launches_sw['crops']} chunks, want 16 per ReID forward with K5 on")
        n_default = df[df.frame_id < N_SWITCHED].track_id.nunique() if len(df) else 0
        n_switched = df_sw.track_id.nunique() if len(df_sw) else 0
        print(f"tracks in the zone over the first {N_SWITCHED} frames: switched run {n_switched}, "
              f"default run {n_default} (not asserted equal: K5 rounds each block's output to bf16)")
        phase("layer-1 path (K6, stand-alone)", card)
        launches_k6 = run_layer1_path(dev, path)
        phase("compacted stage path (K4 insert_rows, stand-alone)", card)
        launches_ins = run_compacted_stage_path(dev)
        phase("detect-only: the CLI with --detect_only", card)
        fps_det, launches_det, df_det = run_detect_only(dev, tmp, path, zones, conf, mapping)
        rows_det = len(df_det)
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
        phase("K9 / K10: the tracker's frame step around the association, against the plain versions", card)
        k9k10 = check_track_frame(dev)
        phase("multicam (a): K2 with the camera axis, C = 4 x 8", card)
        k2cam = check_k2_cameras(dev)
        phase("multicam (d): the tracker's frame step at N_cam x C = 4, 16, 32 classes", card)
        mc_ab = multicam_tracker_ab(dev, fg)
        del fg["batches"], fg["runs"]
        mc_vids, mc_zones, mc_paths = write_multicam_videos(tmp)
        phase("multicam (b): f32 multi-camera step, card == card's serial steps == CPU", card)
        mc_parity = check_multicam_parity(dev, mc_paths)
        phase("multicam (c): the CLI with --multicam, against the serial CLI", card)
        mc = run_multicam_cli(dev, tmp, mc_vids, mc_zones, conf, mapping)
        phase("camera mesh on one card: the camera-sharded step and pipeline over [cuda:0, cuda:0]", card)
        from vehicle_counting_tpu_torch.parallel.mesh import DeviceMesh

        cam_mesh = DeviceMesh((dev, dev), ("cam",))
        cm = {"step": check_camera_mesh_step(dev, camera_frames(mc_paths, 3, 16), cam_mesh),
              "cli": camera_mesh_cli(dev, tmp, mc_vids, mc_zones, conf, mapping, cam_mesh, mc)}
        phase("framedp (a), (b): the frame-parallel step on one card, one shard and two", card)
        fp = check_framedp(dev, path)
        phase("framedp (c): the CLI with --frame_parallel", card)
        fp_cli = run_frame_parallel_cli(dev, tmp, path, zones, conf, mapping, df, launches)
        phase("serving (d): export, verify in a fresh process, smoke", card)
        serve = run_serving(dev, tmp)
        phase("multi-host (e): a one-rank NCCL group, the host_local_to_global round trip", card)
        mh = check_multihost_card(dev, fp.pop("outputs"))
        phase("--profile CLI run + profile_summary", card)
        prof = run_profile(dev, tmp, path_sw, zones_sw, conf, mapping)
        phase("--weight CLI run (seeded .pt + .t7)", card)
        wts, df_wts, seeded = run_weights(dev, tmp, path_sw, zones_sw)
        phase("weight cache: the CLI without --weight, from ./.cache/yolov5s.pt, then from an empty directory", card)
        wcache = run_weight_cache(dev, tmp, path_sw, zones_sw, seeded, df_wts, wts["launches"])

    phase("stage_bench", card)
    stages, launches_stage = run_stage_bench(dev)
    phase("bench", card)
    telemetry, metric, launches_bench = run_bench(dev)

    with tempfile.TemporaryDirectory() as tmp:
        phase("reid-train parity: 5 train steps on the card against the CPU, f32 and f64", card)
        train_parity = check_reid_train_parity(dev)
        phase("reid-train throughput (B=64, 751 classes) and extract_features (B=512; K5 in f32 parity mode)", card)
        train_speed = reid_train_throughput(dev)
        phase("reid_cli: 2 epochs on a synthetic ImageFolder, then --resume", card)
        train_cli = run_reid_cli(tmp)
        phase("tools: e2e_smoke, soak (1024 frames), egress_day dry run, graft_entry.entry()", card)
        tools = run_tools(dev, tmp)

    floor_ms = k7["probe"]["bare_launch_us"] / 1e3
    kernels = [
        dict(name="crop_gather", route="cuda", source="vehicle_counting_tpu_torch/csrc/crops.cu",
             replaces="vehicle_counting_tpu/ops/pallas/crops.py:240", launches=launches["crops"],
             launches_bench=launches_bench["crops"], launches_stage_bench=launches_stage["crops"],
             launches_raw_rgb=launches_raw["crops"], launches_multicam=mc["launches"]["crops"], source_720p=k1_src,
             launches_framedp=fp["launches"]["crops"], launches_framedp_per_shard=fp["k1_per_shard"],
             launches_camera_mesh=cm["step"]["launches"]["crops"],
             launches_serving_verify=serve["verify"]["launches"]["K1"], **k1),
        dict(name="cascade_match", route="cuda", source="vehicle_counting_tpu_torch/csrc/cascade.cu",
             replaces="vehicle_counting_tpu/ops/pallas/cascade.py:887", launches=launches["cascade"],
             launches_bench=launches_bench["cascade"], launches_stage_bench=launches_stage["cascade"],
             launches_raw_rgb=launches_raw["cascade"], launches_per_frame=launches["cascade"] / N_FRAMES,
             warmup_launches=warmup["cascade"], replay_in_trace=fg["replay_in_trace"]["k2"],
             launches_multicam=mc["launches"]["cascade"], multicam_frame_rounds=mc["rounds"],
             launches_multicam_serial=mc["launches_serial"]["cascade"], camera_axis=k2cam,
             multicam_replay=mc_ab["replay"], launches_framedp=fp["launches"]["cascade"],
             launches_camera_mesh=cm["step"]["launches"]["cascade"],
             camera_mesh_per_frame_round=cm["step"]["k2_per_frame_round"],
             launches_camera_mesh_cli=cm["cli"]["launches"]["cascade"],
             launches_serving_verify=serve["verify"]["launches"]["K2"], **k2),
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
        dict(name="solve_assignment", route="cuda", source="vehicle_counting_tpu_torch/csrc/assignment.cu",
             replaces="vehicle_counting_tpu/ops/pallas/assignment.py:163",
             path="tracking.solve_assignment, full [N, M] costs", **sa),
        dict(name="reid_block64", route="cuda", source="vehicle_counting_tpu_torch/csrc/reid_block.cu",
             replaces="vehicle_counting_tpu/ops/pallas/reid_block.py:139", launches=launches_sw["reid_block"],
             path="switched", launches_extract_features_per_call=train_speed["k5_launches_per_call"], **k5),
        dict(name="reid_epilogue", route="cuda", source="vehicle_counting_tpu_torch/csrc/reid_epilogue.cu",
             replaces=None, launches=launches["reid_epilogue"], launches_switched=launches_sw["reid_epilogue"],
             launches_serving_verify=serve["verify"]["launches"]["K8"], **k8),
        dict(name="track_pre", route="cuda", source="vehicle_counting_tpu_torch/csrc/track_frame.cu", replaces=None,
             launches=launches["track_pre"], launches_per_frame=launches["track_pre"] / N_FRAMES,
             replay_in_trace=fg["replay_in_trace"], against_chain=fg["against_chain"],
             launches_serving_verify=serve["verify"]["launches"]["K9"], **k9k10["K9"]),
        dict(name="track_post", route="cuda", source="vehicle_counting_tpu_torch/csrc/track_frame.cu", replaces=None,
             launches=launches["track_post"], scan_against_chain=sc["against_chain"],
             launches_serving_verify=serve["verify"]["launches"]["K10"], **k9k10["K10"]),
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
    print(f"K8 BN epilogue: bound shares {json.dumps({k: v['bound_share'] for k, v in k8['timings'].items()})}, "
          f"wrapper host us {json.dumps(k8['wrapper_host_us'])}, launches per forward "
          f"{json.dumps(k8['launches_per_forward'])}, the step's embed per chunk {json.dumps(k8['embed_device'])}, "
          f"ms a batch {json.dumps(k8['embed_batch_ms'])} [{card}]")
    print(f"tracker ms/frame, f32 B=16: K2 route min {min(scan['k2']):.4f}, staged route min "
          f"{min(scan['staged']):.4f} [{card}]")
    print(f"tracker_scan ms/frame, B=128 steady state, frame graph off / on: {json.dumps(fg['ab'])} [{card}]")
    print(f"CLI frames/s, frame graph off / on: {json.dumps(cli_fps)} [{card}]")
    print(f"detect-only CLI frames/s ({N_FRAMES} frames, cold): {fps_det:.2f}, {rows_det} rows [{card}]")
    print(f"CLI frames/s over {N_SWITCHED} frames without the MP4 pass, thin I420 / raw RGB: {json.dumps(fps_raw)} [{card}]")
    print(f"tracker_scan ms/frame, B=128 steady state, graph on, batched / scan: {json.dumps(sc['ab'])} [{card}]")
    print(f"K1 on the raw 720x1280 source: {json.dumps(k1_src)} [{card}]")
    print(f"K2 with the camera axis (C = {k2cam['c']}): {json.dumps(k2cam['times'])} [{card}]")
    print(f"tracker ms/frame by N_cam x C classes (B=128 steady, graph on): {json.dumps(mc_ab)} [{card}]")
    print(f"multi-camera f32 parity: {json.dumps(mc_parity)} [{card}]")
    print(f"multi-camera CLI camera-frames/s {json.dumps(mc['fps'])}, wall s {json.dumps(mc['wall_s'])}, launches "
          f"{json.dumps(mc['launches'])}, CSV vs serial {json.dumps(mc['csv_vs_serial'], default=str)} [{card}]")
    print(f"camera mesh on one card: step {json.dumps(cm['step'])}; pipeline {json.dumps(cm['cli'])} [{card}]")
    print(f"framedp on one card, f32 B={fp['b']}: serial / two shards ms per batch {json.dumps(fp['ms_per_batch'])}, "
          f"K1 per shard {fp['k1_per_shard']}, K2 {fp['launches']['cascade']} [{card}]")
    print(f"--frame_parallel CLI: {json.dumps(fp_cli)} [{card}]")
    print(f"serving: verify {json.dumps(serve['verify'])}; smoke {json.dumps(serve['smoke'])}; detect-only smoke "
          f"{json.dumps(serve['smoke_detect_only'])}; export {serve['export_s']:.2f} s [{card}]")
    print(f"multi-host on the card: {json.dumps(mh)} [{card}]")
    print(f"solve_assignment on K4, per shape: {json.dumps(sa['shapes'])} [{card}]")
    print(f"launch cost, us: {json.dumps(k7['probe'])} [{card}]")
    print(f"stage_bench ms/frame (min, median): {json.dumps(stages)} [{card}]")
    print(f"bench: {json.dumps(metric)}; streamed p50 {telemetry['p50_fps']} min {telemetry['min_fps']} best "
          f"{telemetry['best_fps']}, device-resident {telemetry['device_resident_fps']} frames/s, upload GB/s best "
          f"{telemetry['upload_gbps_best']} p50 {telemetry['upload_gbps_p50']}, p50 by stream count "
          f"{telemetry['upload_gbps_p50_by_streams']} [{card}]")
    print(f"--profile run: {json.dumps(prof)} [{card}]")
    print(f"--weight run: {json.dumps(wts)} [{card}]")
    print(f"weight cache: CSV rows differing from the --weight run {wcache['rows_differing']} of {wcache['rows']}, "
          f"launches {json.dumps(wcache['launches'])}; no cache: the refused fetch took "
          f"{wcache['no_cache']['fetch_s']} s, random init, {wcache['no_cache']['rows']} rows [{card}]")
    print(f"reid-train parity, card against CPU: {json.dumps(train_parity)} [{card}]")
    print(f"reid-train throughput: {json.dumps(train_speed)} [{card}]")
    print(f"reid_cli: {json.dumps(train_cli)} [{card}]")
    print(f"tools: {json.dumps(tools)} [{card}]")
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
