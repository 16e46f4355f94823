"""One run of one cell of the port's benchmark.

    python3 cellbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything is found by name: the cell in
`BENCHMARK.json`, its configuration file, `cellbench/traffic/<mix>.json`,
`cellbench/limits/<cell>.json` and, in a traced run, one reader
`cellbench/metrics/<metric>.py` per per-layer metric of the cell.

The run first holds the port's detector, built from the configuration
(its anchors as given, the strides of its layer table), to the
configuration's conv shapes and refuses any other network. It then makes
the weights and a pool of raw frames from the seed on the card,
calibrates the confidence threshold with the reference detector, warms
up, then streams batches for `--seconds` through the port's counting
step, `pipeline.step.pipeline_batch_step` on the I420 upload, fed as the
port's `CountingPipeline` feeds it: a producer thread takes the next B raw
frames from the pool, letterboxes them on the host and uploads them one
batch ahead; the main thread runs the step with the tracker state carried
from batch to batch and reads the previous batch's track rows back. The
host bounds the step, so on the card the window keeps the host steady:
the main thread on a core of its own, the producer and its letterbox
threads on the others, freed host memory kept for the next batch. After
the window it judges the first batch and a sample of the window's batches,
drawn from the seed, against the plain reference (`judge.py`), and prints
one JSON line last on standard output.

With `--trace 0` the run, after the window, traces the device alone over
the batches that take the pool once, for the card's busy time per frame.
With `--trace 1` it records CUDA events at the step's layer boundaries
over the window and profiles a few batches after it, and reports the
per-layer metrics instead of the end-to-end ones.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "vehicle_counting_tpu")
PROFILED_FRAMES = 128  # frames of whole batches in the traced run's profiler window
WARMUP_BATCHES = 2
MIN_WINDOW_BATCHES = 2  # so that a window's batch latencies have a 90th percentile


def _load_json(path, what):
    if not os.path.isfile(path):
        raise SystemExit(f"cellbench: no {what} file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def _reader(path):
    spec = importlib.util.spec_from_file_location(f"cellbench_metric_{os.path.basename(path)[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spec:
    """A cell's files, found by the names in BENCHMARK.json."""

    def __init__(self, root, workload):
        bench = _load_json(os.path.join(root, "BENCHMARK.json"), "benchmark")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"cellbench: unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        if self.cell["config"] not in configs:
            raise SystemExit(f"cellbench: workload {workload!r} names an unknown config {self.cell['config']!r}")
        self.cfg = _load_json(os.path.join(root, configs[self.cell["config"]]["file"]), "configuration")
        self.traffic = _load_json(os.path.join(root, "cellbench", "traffic", self.cell["traffic"] + ".json"),
                                  "traffic mix")
        self.limits = _load_json(os.path.join(root, "cellbench", "limits", workload + ".json"), "limits")
        self.end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
        self.readers = {m["name"]: _reader(os.path.join(root, "cellbench", "metrics", m["name"] + ".py"))
                        for m in self.per_layer}
        self.workload = workload
        self._refuse_unsupported()

    def _refuse_unsupported(self):
        t = self.traffic
        for key, ok in (("cameras", 1), ("per_camera_batch", None), ("video", None)):
            if t.get(key, ok) != ok:
                raise SystemExit(f"cellbench: traffic {t['name']!r} sets {key}={t[key]!r}, which this harness "
                                 f"does not run yet (it runs {key}={ok!r})")
        if t["frames"]["kind"] != "still_scene":
            raise SystemExit(f"cellbench: traffic {t['name']!r} asks for frames of kind {t['frames']['kind']!r}, "
                             "which this harness does not make (still_scene)")
        if self.cell.get("chips", 1) != 1:
            raise SystemExit(f"cellbench: {self.workload} asks for {self.cell['chips']} chips; this harness runs one")


def _tree_difference(ref, port, path):
    """The first place where the port's parameter tree differs from the
    configuration's conv shapes (`reference/yolo.py::conv_shapes`), or None."""
    if isinstance(ref, tuple):  # one conv, (cout, cin, k)
        co, ci, k = ref
        if not isinstance(port, dict) or set(port) != {"w", "b"}:
            return f"{path}: the configuration has a conv, the port a {type(port).__name__}"
        for n, want in (("w", (co, ci, k, k)), ("b", (co,))):
            if tuple(port[n].shape) != want:
                return f"{path}.{n}: the port has {tuple(port[n].shape)}, the configuration {want}"
        return None
    if isinstance(ref, list):
        if not isinstance(port, list) or len(port) != len(ref):
            got = len(port) if isinstance(port, list) else type(port).__name__
            return f"{path}: the port has {got} blocks, the configuration {len(ref)}"
        found = (_tree_difference(r, p, f"{path}[{i}]") for i, (r, p) in enumerate(zip(ref, port)))
    else:
        if not isinstance(port, dict):
            return f"{path}: the port has {type(port).__name__}, the configuration a module"
        found = (_tree_difference(ref[k], port[k], f"{path}.{k}") if k in port and k in ref else
                 f"{path}.{k}: only {'the configuration' if k in ref else 'the port'} has it"
                 for k in list(ref) + [k for k in port if k not in ref])
    return next((d for d in found if d), None)


def port_yolo_config(cfg):
    """The port's `YoloConfig` for the configuration: its anchors as given
    and its strides from its layer table. Raises SystemExit, naming the
    first difference, unless the port's own network for it, initialised
    once on the CPU, has the configuration's conv shapes leaf by leaf."""
    import torch

    from cellbench.reference import yolo as yolo_ref
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, init_yolov5

    sets = cfg["anchors"]
    if any(len(a) % 2 or len(a) != len(sets[0]) for a in sets):
        raise SystemExit(f"cellbench: the anchor sets {sets} are not of one count of (w, h) pairs")
    try:
        st = yolo_ref.strides(cfg)
    except ValueError as e:
        raise SystemExit(f"cellbench: the configuration's layer table: {e}")
    if len(st) != len(sets):
        raise SystemExit(f"cellbench: {len(sets)} anchor sets for {len(st)} Detect inputs")
    ycfg = YoloConfig(variant=cfg["variant"], num_classes=cfg["nc"],
                      anchors=tuple(tuple(zip(a[0::2], a[1::2])) for a in sets), strides=st)
    try:
        tree = init_yolov5(torch.Generator(), ycfg)
    except (KeyError, ValueError, NotImplementedError) as e:
        raise SystemExit(f"cellbench: the port builds no {cfg['variant']!r} network ({type(e).__name__}: {e})")
    diff = _tree_difference(yolo_ref.conv_shapes(cfg), tree, "layer")
    if diff:
        raise SystemExit(f"cellbench: the port's {cfg['variant']} is not the configuration's network: {diff}")
    return ycfg


def split_cores(allowed):
    """(the main thread's cores, the feed's cores) out of the cores the
    process may run on: the main thread, which dispatches every step, gets
    the last core to itself, and the producer thread and the letterbox's
    threads, which it starts, share the others; None with one core."""
    cores = sorted(allowed)
    return ({cores[-1]}, set(cores[:-1])) if len(cores) > 1 else None


def keep_freed_memory():
    """glibc's allocator set to keep what the process frees: no block is
    mapped for itself (M_MMAP_MAX 0) and the heap's top is given back only
    past 1 GiB (M_TRIM_THRESHOLD), so the host buffers of one batch (the
    letterbox's frames, the step's) are reused by the next instead of being
    unmapped and faulted in again. Nothing where the C library has no
    `mallopt`."""
    import ctypes

    mallopt = getattr(ctypes.CDLL(None), "mallopt", None)
    if mallopt is not None:
        mallopt(-4, 0)  # M_MMAP_MAX
        mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD


def calibrate(cfg, traffic, yolo_w, pool, device, block=16):
    """(class lut [nc] with -1 dropped, confidence threshold) from the
    reference detector at confidence 0 on the first `frames` frames of the
    pool: track the detector's most frequent classes and put the threshold
    at the (k x frames)-th score among them, k tracked detections a frame
    on average (the arithmetic of the port's
    `benchmarks/load.py::calibrate_from_det`, over many frames)."""
    import collections

    import numpy as np

    from cellbench.reference import pixels as px_ref
    from cellbench.reference import yolo as yolo_ref

    cal = traffic["calibration"]
    n = min(cal["frames"], pool.shape[0])
    scores, classes = [], []
    for i in range(0, n, block):
        pix = px_ref.network_pixels(pool[i:min(i + block, n)].to(device), cfg["net_hw"])
        for _, s, c in yolo_ref.detect(cfg, yolo_w, pix.float() / 255.0, 0.0):
            scores.append(s.cpu().numpy())
            classes.append(c.cpu().numpy())
    scores, classes = np.concatenate(scores), np.concatenate(classes)
    top = [int(c) for c, _ in collections.Counter(classes.tolist()).most_common(cal["tracked_classes"])]
    lut = np.full((cfg["nc"],), -1, np.int64)
    for d, src in enumerate(top):
        lut[src] = d
    kept = np.sort(scores[np.isin(classes, top)])
    k = cal["per_frame"] * n
    return lut, float(kept[-min(k, kept.size)]) if kept.size else 0.0


@contextlib.contextmanager
def plain_f32():
    """TF32 off, as the plain reference states its precision."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Layers:
    """Wrappers around the three layer calls that `pipeline_batch_step`
    makes (`detect_front`, `embed_front`, `tracker_scan` of
    `pipeline/step.py`): CUDA events at their boundaries and a named host
    range while `timed`, and the embed's features of a checked batch."""

    NAMES = {"detect_front": "detect", "embed_front": "embed", "tracker_scan": "track"}

    def __init__(self, step_mod, on_card, fault=None):
        self.step_mod, self.on_card, self.fault = step_mod, on_card, fault
        self.timed, self.keep, self.feats = False, False, None
        self.events = []
        self.orig = {n: getattr(step_mod, n) for n in self.NAMES}

    def _wrap(self, fn_name):
        import torch

        fn, layer = self.orig[fn_name], self.NAMES[fn_name]

        def inner(*a, **k):
            if layer == "track" and self.fault == "state":
                # the step returns the state it was given, unchanged
                before = type(a[0])(*(x.clone() for x in a[0]))
                return before, fn(*a, **k)[1]
            if not self.timed:
                out = fn(*a, **k)
            else:
                e0 = torch.cuda.Event(enable_timing=True) if self.on_card else None
                if e0 is not None:
                    e0.record()
                with torch.profiler.record_function(f"cellbench.{layer}"):
                    out = fn(*a, **k)
                if e0 is not None:
                    e1 = torch.cuda.Event(enable_timing=True)
                    e1.record()
                    self.events.append((layer, e0, e1))
            if layer == "embed" and self.fault == "answer":
                hit = torch.nonzero(out.abs().sum(-1))
                if len(hit):
                    out[tuple(hit[0])] *= -1  # one detection's feature, wrong where it is produced
            if layer == "embed" and self.keep:
                self.feats = out
            return out

        return inner

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.step_mod, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.step_mod, n, fn)

    def layer_ms(self):
        out = {}
        for layer, e0, e1 in self.events:
            out[layer] = out.get(layer, 0.0) + e0.elapsed_time(e1)
        return out


class Record:
    """What the per-layer readers read (cellbench/metrics/*.py)."""

    def __init__(self):
        self.feed_wait_s, self.layer_ms, self.frames, self.window_s = [], {}, 0, 0.0
        self.window, self.peaks, self.model_flops, self.k1_bytes = None, None, 0.0, 0.0
        self.device_window = None  # a window of the device's activity alone
        self.latencies = []  # seconds, each batch of the timed window


def _state_np(state):
    import torch

    from cellbench.judge import STATE_FIELDS

    return {f: getattr(state, f).float().cpu().numpy() if getattr(state, f).dtype == torch.bfloat16
            else getattr(state, f).cpu().numpy() for f in STATE_FIELDS}


def run(spec, seed, seconds, trace, device, fault=None, control=False, readings=False, log=print):
    """One run; returns the result dict (the contract's keys and the
    compared numbers under "checks"; with `readings` every number under
    "numbers" and the share of tracker rows compared under "compared", and
    with `control` the control's beside them under "control" and
    "control_compared")."""
    import numpy as np
    import torch

    from cellbench import counts, judge, weights
    from cellbench import trace as trace_mod
    from vehicle_counting_tpu_torch.models.reid import cast_conv_weights
    from vehicle_counting_tpu_torch.models.yolo import cast_params
    from vehicle_counting_tpu_torch.ops.letterbox import content_upload_exact, host_letterbox_yuv420
    from vehicle_counting_tpu_torch.pipeline import step as step_mod
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams
    from vehicle_counting_tpu_torch.utils.transfer import parallel_device_put

    cfg, tc = spec.cfg, spec.cfg["tracker"]
    on_card = device.type == "cuda"
    b = cfg["batch"]
    src_hw, net_hw = tuple(cfg["source_hw"]), tuple(cfg["net_hw"])
    if not content_upload_exact(src_hw, net_hw):
        raise SystemExit(f"cellbench: the content-row upload is not exact for {src_hw} -> {net_hw}")

    phases = [("imports", time.perf_counter())]
    ycfg = port_yolo_config(cfg)
    phases.append(("network check", time.perf_counter()))
    g = weights.generator(seed, device)
    yolo_w, reid_p, reid_s = weights.draw(cfg, g, device)
    pool = weights.frame_pool(cfg, spec.traffic, g, device)
    pool_np = pool.numpy()
    n_pool = pool.shape[0]
    phases.append(("weights and frames", time.perf_counter()))
    with plain_f32(), torch.no_grad():
        lut, conf = calibrate(cfg, spec.traffic, yolo_w, pool, device)
    phases.append(("calibration", time.perf_counter()))
    calibration_s = phases[-1][1] - phases[-2][1]

    dtype = getattr(torch, cfg["compute_dtype"])
    port_yolo = cast_params(yolo_w, dtype)
    port_reid = cast_conv_weights(reid_p, dtype)
    hp = DeepSortParams(
        tracker=TrackerParams(capacity=tc["capacity"], feat_dim=cfg["reid"]["embed_dim"], budget=tc["budget"],
                              max_dist=tc["max_dist"], max_iou_distance=tc["max_iou_distance"],
                              max_age=tc["max_age"], n_init=tc["n_init"], feat_dtype=tc["feat_dtype"]),
        num_classes=tc["num_classes"], min_confidence=tc["min_confidence"], nms_max_overlap=tc["nms_max_overlap"],
        max_embed=tc["max_embed"])
    kw = dict(ycfg=ycfg, hp=hp, image_size=net_hw, src_hw=src_hw, conf_thres=conf, iou_thres=cfg["iou_thres"],
              max_det=cfg["max_det"], dtype=dtype, frames_format="letterboxed_yuv420")
    lut_dev = torch.as_tensor(lut, dtype=torch.int32, device=device)
    frame_valid = torch.ones((b,), dtype=torch.bool, device=device)
    if fault == "half":
        frame_valid[b // 2:] = False

    placement = split_cores(os.sched_getaffinity(0)) if on_card else None

    def produce(i):
        if placement and i == 0:  # the producer's first call, on its own thread
            os.sched_setaffinity(0, placement[1])
        j = (i * b) % n_pool
        t_take = time.perf_counter()
        yuv = host_letterbox_yuv420(pool_np[j:j + b], net_hw, content_only=True)
        return i, j, t_take, parallel_device_put(yuv, device=device)

    rec = Record()
    latencies, checked = [], []
    ex = ThreadPoolExecutor(max_workers=1)
    loop = {"fut": ex.submit(produce, 0), "next": 1, "pending": None, "states": init_states(hp, device)}
    clone = lambda s: type(s)(*(x.clone() for x in s))  # noqa: E731

    def drain(item):
        touts = item.pop("touts")
        host = {k: getattr(touts, k).cpu().numpy() for k in ("mask", "ids", "boxes")}
        item["t_done"] = time.perf_counter()
        latencies.append(item["t_done"] - item["t_take"])
        if "n_emb" in item:
            item["n_emb"] = int(item["n_emb"])
        if item.get("check"):
            item.update(host)

    def iterate(check, keep_det=False):
        t0 = time.perf_counter()
        i, j, t_take, fdev = loop["fut"].result()
        wait = time.perf_counter() - t0
        loop["fut"] = ex.submit(produce, loop["next"])
        loop["next"] += 1
        states = loop["states"]
        item = {"i": i, "j": j, "t_take": t_take, "check": check}
        if check:
            item["state0"] = clone(states) if i else None
        layers.keep = check
        with torch.no_grad():
            new_states, det, touts = step_mod.pipeline_batch_step(
                port_yolo, port_reid, reid_s, states, fdev, frame_valid, lut_dev, **kw)
        item["touts"] = touts
        if check:
            item.update(det=det, feats=layers.feats, state1=clone(new_states))
            layers.feats = None
        if keep_det:
            item["det"] = det
        if trace:
            item["n_emb"] = det["valid"].sum()
        loop["states"] = new_states
        if loop["pending"] is not None:
            drain(loop["pending"])
        loop["pending"] = item
        if check:
            checked.append(item)
        return wait, item

    def finish():
        if loop["pending"] is not None:
            drain(loop["pending"])
            loop["pending"] = None

    rng = np.random.default_rng(int(seed) % (1 << 63))
    check_at = sorted(rng.uniform(0, seconds, size=cfg["checked_batches"]).tolist())
    if placement:
        os.sched_setaffinity(0, placement[0])  # this thread alone; threads it starts later inherit it
    with Layers(step_mod, on_card, fault) as layers:
        try:
            for w in range(WARMUP_BATCHES):
                iterate(check=(w == 0))
            finish()
            if on_card:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            latencies.clear()
            items = []
            layers.timed = bool(trace)
            t_win0 = time.perf_counter()
            # the benchmark's own threshold calibration is no set-up of the program
            setup_s = t_win0 - T_PROCESS - calibration_s
            phases.append(("warm-up", t_win0))
            log("cellbench: set-up " + ", ".join(
                f"{name} {t - (phases[i - 1][1] if i else T_PROCESS):.3f} s" for i, (name, t) in enumerate(phases)),
                file=sys.stderr)
            while len(items) < MIN_WINDOW_BATCHES or time.perf_counter() - t_win0 < seconds:
                due = bool(check_at) and time.perf_counter() - t_win0 >= check_at[0]
                if due:
                    check_at.pop(0)
                wait, item = iterate(check=due)
                rec.feed_wait_s.append(wait)
                items.append(item)
            finish()
            t_end = items[-1]["t_done"]
            layers.timed = False
            if placement:  # the window has closed: the profiler's threads start from this one
                os.sched_setaffinity(0, placement[0] | placement[1])
            if on_card:
                torch.cuda.synchronize(device)
            window_s = t_end - t_win0
            frames = len(items) * b
            rec.frames, rec.window_s, rec.latencies = frames, window_s, list(latencies)
            if trace:
                rec.layer_ms = layers.layer_ms() if on_card else {}
                rec.model_flops = (frames * counts.detector_flops(cfg, net_hw)
                                   + sum(it["n_emb"] for it in items) * counts.reid_flops(cfg["reid"]))
                if on_card:
                    n_prof = max(1, PROFILED_FRAMES // b)

                    def profiled():
                        got = [iterate(check=False, keep_det=True)[1] for _ in range(n_prof)]
                        finish()
                        return got

                    rec.window = trace_mod.profile(profiled)
                    try:
                        rec.device_window = trace_mod.profile(profiled, host=False)
                    except RuntimeError:
                        log("cellbench: the device-only trace lost a marker; the idle share is read from a trace "
                            "of the host's operations without their shapes", file=sys.stderr)
                        rec.device_window = trace_mod.profile(profiled, shapes=False)
                    rec.peaks = counts.peaks(torch.cuda.get_device_name(device))
                    rec.k1_bytes = _k1_bytes(cfg, hp, rec.window, rec.window.result, counts)
            elif on_card:
                # the card's time per frame: the device's busy time over the
                # batches that take the whole pool once, traced after the window
                n_card = max(1, n_pool // b)

                def card_batches():
                    for _ in range(n_card):
                        iterate(check=False)
                    finish()

                card = trace_mod.profile(card_batches, host=False)
                device_busy_ms = card.busy_us() * 1e-3 / (n_card * b)
                log(f"cellbench: the device busy {card.busy_us() * 1e-3:.4f} ms over {n_card} batches of {b} "
                    f"frames, {len(card.ops)} operations", file=sys.stderr)
            memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        finally:
            loop["fut"].result()
            ex.shutdown()

    # the window has closed: free the program's state, then the reference
    del loop["states"], items
    step_mod.free_frame_runners()
    if on_card:
        torch.cuda.empty_cache()
    tally, ctally = judge.Tally(), judge.Tally()
    ref_w = (yolo_w, reid_p, reid_s)
    with plain_f32(), torch.no_grad():
        for it in checked:
            args = (cfg, ref_w, pool[it["j"]:it["j"] + b].to(device), lut, conf)
            prog = dict(it, state0=None if it["state0"] is None else _state_np(it["state0"]),
                        state1=_state_np(it["state1"]))
            det, feat, track = judge.check_batch(*args, prog, tally)
            log(f"cellbench: checked batch {it['i']}: detections {det[0] / max(det[1], 1e-12):.6g} unpaired by "
                f"margin; widest feature gap {feat:.6g}; {track[1]} of {track[3]} track rows before a near-tie, "
                f"{track[0]} differing, widest box gap {track[2]:.6g} px", file=sys.stderr)
            if control:
                judge.check_batch(*args, prog, ctally, control=True)

    numbers = tally.numbers()
    checks = {k: {"value": numbers[k], "limit": spec.limits[k]} for k in judge.NUMBERS if k in spec.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and tally.rows > 0 and tally.margin > 0
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": frames, "failed": 0}
    if trace:
        metrics = {}
        for m in spec.per_layer:
            v = spec.readers[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if rec.device_window is not None:
            dev_info.update(busy_s=rec.device_window.busy_us() * 1e-6, window_s=rec.device_window.window_us * 1e-6)
    else:
        lat = rec.latencies
        p90 = statistics.quantiles(lat, n=10)[-1] if len(lat) > 1 else lat[0]
        values = {"frames_per_s": frames / window_s, "batch_latency_p90_ms": 1e3 * p90, "setup_s": setup_s}
        if on_card:
            values["device_busy_ms_per_frame"] = device_busy_ms
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in spec.end_to_end
                   if m["name"] in values}
        log(f"cellbench: {len(lat)} batches of {b} frames in {window_s:.4f} s ({frames / window_s:.4f} frames/s); "
            f"latency median {1e3 * statistics.median(lat):.4f} ms, p90 over {len(lat)} batches "
            f"({sum(x > p90 for x in lat)} beyond it)", file=sys.stderr)
    log(f"cellbench: peak device memory {memory_peak} bytes; threshold {conf:.6g}", file=sys.stderr)
    result.update(metrics=metrics, device=dev_info)
    if trace and rec.device_window is not None:
        result["breakdown"] = _breakdown(rec.device_window)
    if readings:
        result["numbers"], result["compared"] = numbers, tally.compared_share()
    if control:
        result["control"], result["control_compared"] = ctally.numbers(), ctally.compared_share()
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']:.6g} limit {c['limit']:.6g}", file=sys.stderr)
    return result


def _k1_bytes(cfg, hp, window, items, counts):
    """K1's bytes over the profiled batches: their valid detections' crop
    boxes in letterbox pixels and the launches the profile saw."""
    from cellbench.reference import pixels as px_ref

    gain, pad_x, pad_y = px_ref.box_transform(cfg["source_hw"], cfg["net_hw"])
    h, w = cfg["net_hw"]
    bounds = []
    for it in items:
        bx = it["det"]["boxes"][it["det"]["valid"]].float().cpu().numpy()
        x1 = (bx[:, 0] * gain + pad_x).astype("int64").clip(min=0)
        y1 = (bx[:, 1] * gain + pad_y).astype("int64").clip(min=0)
        x2 = (bx[:, 2] * gain + pad_x).astype("int64").clip(max=w - 1)
        y2 = (bx[:, 3] * gain + pad_y).astype("int64").clip(max=h - 1)
        bounds += list(zip((y2 - y1).clip(min=1).tolist(), (x2 - x1).clip(min=1).tolist()))
    _, launches = window.kernel_us("crop_gather_kernel")
    return counts.k1_bytes(bounds, launches, hp.max_embed, cfg["reid"]["crop_hw"])


def _breakdown(window):
    by_name = {}
    for name, _, dur in window.ops:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], us * 1e-6] for n, us in ops],
            "idle_gaps": [[window.host_at(ts)[:120], us * 1e-6] for ts, us in window.gaps()[:10]]}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, device=None, fault=None, root=ROOT):
    """The command. For the tests: `device` (a CPU run) skips the look for
    a card, `fault` plants one of the faults the check must catch, `root`
    is the checkout whose BENCHMARK.json and cellbench/ files are read."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    spec = Spec(root, args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell.get("chips", 1):
            print(f"cellbench: {args.workload} needs {spec.cell.get('chips', 1)} CUDA device(s); "
                  f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        # few threads in one process: no idle intra-op pool spinning beside
        # the main thread, and cv2 single-threaded inside each of the
        # letterbox's frame threads; host memory kept for reuse
        import cv2

        torch.set_num_threads(1)
        cv2.setNumThreads(1)
        keep_freed_memory()
    try:
        result = run(spec, args.seed, args.seconds, args.trace, torch.device(device), fault=fault)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"cellbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
