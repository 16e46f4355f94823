"""Seeded inputs for checking the kernels against their plain versions.

Shared by the CPU parity tests and `chip_smoke.py`. Everything is made
with numpy from a seed, so the same problem can be fed to the JAX
reference, the plain PyTorch version and the CUDA kernel.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from vehicle_counting_tpu_torch.ops.cascade import IMAX
from vehicle_counting_tpu_torch.tracking.assignment import BIG
from vehicle_counting_tpu_torch.tracking.tracker import INFTY_COST


def one_torch_thread():
    """Generator for a module-scoped autouse pytest fixture: torch on one
    intra-op thread while the module's tests run, the count restored after.
    The test suite runs several workers at once, and more threads per
    worker only contend."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def association_problem(rng: np.random.Generator, c: int, k: int, max_age: int,
                        kind: str = "random") -> Dict[str, np.ndarray]:
    """[C]-batched association operands like one tracker frame produces.

    kind: "random" (spread costs, gating, mixed ages), "ties" (costs from
    three values, many above the threshold so the clamp ties them),
    "empty" (class 0 has no valid detection, class 1 no track, class 2 no
    free detection after validity), or "steady" (a frame of an established
    scene: K/8 tracks and as many detections per class, all but one
    confirmed and seen last frame, each with one cheap detection).
    """
    steady = kind == "steady"
    n_trk = np.full(c, max(2, k // 8)) if steady else rng.integers(0, k + 1, size=c)
    n_det = n_trk if steady else rng.integers(0, k + 1, size=c)
    state = np.zeros((c, k), np.int32)  # 0 empty, 1 tentative, 2 confirmed
    tsu = np.zeros((c, k), np.int32)
    track_slots = []
    for ci in range(c):
        slots = rng.permutation(k)[: n_trk[ci]]
        track_slots.append(slots)
        if steady:
            state[ci, slots], tsu[ci, slots] = 2, 1
            state[ci, slots[0]], tsu[ci, slots[1]] = 1, 2  # one tentative, one missed last frame
            continue
        state[ci, slots] = rng.choice([1, 2, 2, 2], size=slots.size)
        tsu[ci, slots] = np.where(rng.random(slots.size) < 0.6, 1, rng.integers(1, max_age + 3, slots.size))
    track_id = np.where(state > 0, rng.permutation(c * k).reshape(c, k) + 1, 0).astype(np.int32)
    confirmed = state == 2
    lvl_of = np.where(confirmed & (tsu <= max_age), tsu - 1, IMAX).astype(np.int32)
    det_valid = np.zeros((c, k), bool)
    det_slots = []
    for ci in range(c):
        det_slots.append(rng.permutation(k)[: n_det[ci]])
        det_valid[ci, det_slots[ci]] = True
    if kind == "ties":
        gated = rng.choice(np.float32([0.05, 0.1, 0.5]), size=(c, k, k))
        iou = rng.choice(np.float32([0.2, 0.4, 0.9]), size=(c, k, k))
    else:
        gated = rng.uniform(0.0, 0.45, size=(c, k, k)).astype(np.float32)
        iou = rng.uniform(0.0, 1.0, size=(c, k, k)).astype(np.float32)
        gated = np.where(rng.random((c, k, k)) < 0.2, INFTY_COST, gated)
    if steady:
        for ci in range(c):  # every track has its own detection, well under the thresholds
            gated[ci, track_slots[ci], det_slots[ci]] = rng.uniform(0.01, 0.1, n_trk[ci]).astype(np.float32)
            iou[ci, track_slots[ci], det_slots[ci]] = rng.uniform(0.05, 0.3, n_trk[ci]).astype(np.float32)
    if kind == "empty":
        det_valid[0] = False
        state[1] = 0
        lvl_of[1] = IMAX
        det_valid[2] = False
    gated = np.where(det_valid[:, None, :], gated, BIG).astype(np.float32)
    iou = np.where(tsu[:, :, None] > 1, INFTY_COST, iou).astype(np.float32)
    iou_order = (track_id + np.where(confirmed, 1 << 20, 0)).astype(np.int32)
    det_order = np.stack([rng.permutation(k) for _ in range(c)]).astype(np.int32)
    return {
        "gated": gated, "iou": iou, "lvl_of": lvl_of,
        "tentative": (state == 1), "track_id": track_id, "iou_order": iou_order,
        "det_valid": det_valid, "det_order": det_order,
    }


def clamp_tie_problems(rng: np.random.Generator, n: int, s: int = 64, hi: int = 40):
    """n compacted [S, S] assignment problems with min_cost_matching's clamp
    ties: an nr x nc block (1 <= nr, nc < hi) of uniform costs clamped at
    0.2 + 1e-5, 30 % of them gated to exactly that value, BIG elsewhere.
    Returns (costs [n, S, S] f32, nr [n] i32, nc [n] i32)."""
    costs = np.full((n, s, s), BIG, np.float32)
    nr = rng.integers(1, hi, n).astype(np.int32)
    nc = rng.integers(1, hi, n).astype(np.int32)
    for i in range(n):
        sub = np.minimum(rng.uniform(0, 1, (nr[i], nc[i])).astype(np.float32), 0.2 + 1e-5)
        sub[rng.uniform(0, 1, (nr[i], nc[i])) < 0.3] = 0.2 + 1e-5
        costs[i, : nr[i], : nc[i]] = sub
    return costs, nr, nc


def stage_problems(rng: np.random.Generator, n: int, k: int = 64, hi: int = 40, key_offset: int = 1 << 23):
    """n one-class matching stages in masked form, as kernel K4's fused
    stage takes them ([n, K, K] cost and [n, K] vectors): nr rows and nc
    free detections (0 <= nr, nc < hi, so normal, flipped and empty stages)
    at random slots; costs uniform with 30 % at exactly the clamp of
    threshold 0.2 (ties) and one problem in eight all above it (every pair
    rejected); row order keys with repeats (ties go to the lower slot);
    detection keys unique and past `key_offset` (>= 2^22: beyond the
    association kernel's packed range); some tracks matched already.
    Returns a dict of numpy arrays named like `match_stage_batched`'s
    arguments, threshold 0.2."""
    cost = rng.uniform(0, 1, (n, k, k)).astype(np.float32)
    cost[rng.uniform(0, 1, (n, k, k)) < 0.3] = np.float32(0.2 + 1e-5)
    cost[::8] = np.float32(0.9)
    rows = np.zeros((n, k), bool)
    det_free = np.zeros((n, k), bool)
    for i in range(n):
        rows[i, rng.permutation(k)[: rng.integers(0, hi)]] = True
        det_free[i, rng.permutation(k)[: rng.integers(0, hi)]] = True
    row_order = rng.integers(1, max(2, k // 2), (n, k)).astype(np.int32)
    det_key = (np.stack([rng.permutation(k) for _ in range(n)]) + key_offset).astype(np.int32)
    track_col = np.where(~rows & (rng.uniform(0, 1, (n, k)) < 0.2), rng.integers(0, k, (n, k)), -1).astype(np.int32)
    stage_base = rng.integers(1, 32, n).astype(np.int32)
    return {"cost": cost, "rows": rows, "det_free": det_free, "track_col": track_col, "threshold": 0.2,
            "row_order": row_order, "det_key": det_key, "stage_base": stage_base}


def reid_block_params(rng: np.random.Generator, c: int = 64):
    """Numpy (params, stats) of one stage-1 BasicBlock in the JAX layout
    (HWIO convs, BN scale/bias and non-trivial running stats)."""
    p = {
        "conv1": {"w": (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)},
        "conv2": {"w": (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)},
    }
    s = {}
    for i in (1, 2):
        p[f"bn{i}"] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}
        s[f"bn{i}"] = {"mean": (rng.standard_normal(c) * 0.1).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return p, s



def reid_bn_eager(x, p, s):
    """Inference BN on an f32 NCHW tensor as eager torch ops: what the ReID
    trunk ran after each convolution before K8."""
    import torch

    from vehicle_counting_tpu_torch.models.reid import BN_EPS

    inv = torch.rsqrt(s["var"] + BN_EPS)
    shape = (1, -1, 1, 1)
    return (x - s["mean"].view(shape)) * inv.view(shape) * p["scale"].view(shape) + p["bias"].view(shape)


def reid_conv_eager(x, w, stride, padding, dtype):
    """A trunk convolution as before K8: in `dtype` (OIHW weight), f32 out."""
    import torch.nn.functional as F

    return F.conv2d(x.to(dtype), w.to(dtype), stride=stride, padding=padding).float()


def reid_block_eager(p, s, x, stride, dtype):
    """One BasicBlock of the ReID trunk as eager torch ops on an f32 input,
    f32 out: cuDNN's convolutions and the op chain between them, the
    trunk's block before K8 (the library call K5 is held against)."""
    import torch

    y = torch.relu(reid_bn_eager(reid_conv_eager(x, p["conv1"]["w"], stride, 1, dtype), p["bn1"], s["bn1"]))
    y = reid_bn_eager(reid_conv_eager(y, p["conv2"]["w"], 1, 1, dtype), p["bn2"], s["bn2"])
    if "down" in p:
        x = reid_bn_eager(reid_conv_eager(x, p["down"]["w"], stride, 0, dtype), p["down"]["bn"], s["down"])
    return torch.relu(x + y)

# The trunk's BN epilogues (K8), by what follows the convolution: the f32
# output, the copy for the next convolution, and the options.
EPILOGUE_CASES = {
    "stem": dict(pre_bias=True, residual=False, relu=True, f32=True, lo=False),
    "conv1": dict(pre_bias=False, residual=False, relu=True, f32=False, lo=True),
    "down": dict(pre_bias=False, residual=False, relu=False, f32=True, lo=False),
    "conv2": dict(pre_bias=False, residual=True, relu=True, f32=True, lo=True),
    "conv2_to_down": dict(pre_bias=False, residual=True, relu=True, f32=False, lo=True),
}


def reid_epilogue_operands(rng: np.random.Generator, shape) -> Dict[str, np.ndarray]:
    """Numpy f32 operands of one BN epilogue: x (a convolution's output,
    [N, C, H, W]), a residual like x, and the [C] vectors mean, var, scale,
    bias and pre_bias. x holds zeros of both signs, ties with the mean,
    infinities and a NaN besides its normal values."""
    n, c = shape[:2]
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    mean = (rng.standard_normal(c) * 0.2).astype(np.float32)
    out = {"x": x, "residual": (rng.standard_normal(shape)).astype(np.float32), "mean": mean,
           "var": rng.uniform(0.05, 2.0, c).astype(np.float32), "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
           "bias": (rng.standard_normal(c) * 0.1).astype(np.float32),
           "pre_bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}
    flat = x.reshape(n, c, -1)
    k = flat.shape[-1]
    flat[0, :, 0] = mean  # (x - mean) == 0
    flat[0, :, min(1, k - 1)] = -0.0
    flat[-1, 0, k // 2] = np.inf
    flat[-1, c - 1, k - 1] = -np.inf
    flat[n // 2, c // 2, k // 3] = np.nan
    return out


def conv1_s2_inputs(rng: np.random.Generator, shape=(1, 32, 64, 32)):
    """Numpy NHWC input and JAX-layout {"w": HWIO, "b"} of the layer-1 conv."""
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    p = {"w": (rng.standard_normal((3, 3, shape[-1], 64)) * 0.1).astype(np.float32),
         "b": (rng.standard_normal(64) * 0.05).astype(np.float32)}
    return x, p


def crop_boxes(rng: np.random.Generator, d: int, h: int, w: int) -> np.ndarray:
    """[D, 4] xyxy boxes in a [h, w] frame: ordinary boxes plus boxes that
    touch or cross the edges, one-pixel boxes and degenerate (x2 < x1)
    boxes, so clamp taps coincide."""
    x1 = rng.uniform(-20, w, d)
    y1 = rng.uniform(-20, h, d)
    bw = rng.uniform(0.5, w / 2, d)
    bh = rng.uniform(0.5, h / 2, d)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], axis=1)
    n = d // 8
    boxes[:n] = [[w - 3.5, h - 2.2, w + 40.0, h + 30.0]] * n       # past the corner
    boxes[n : 2 * n] = [[0.0, 0.0, 1.0, 1.0]] * n                 # one pixel
    boxes[2 * n : 3 * n] = [[30.0, 40.0, 10.0, 20.0]] * n         # degenerate
    return boxes.astype(np.float32)


def fake_yolov5_state_dict(rng: np.random.Generator, variant: str = "yolov5s",
                           num_classes: int = 80) -> Dict[str, np.ndarray]:
    """A state dict named and shaped like an ultralytics v6.0 yolov5
    checkpoint's (`model.<i>.conv.weight`, `.bn.*`, the Detect layer's
    `model.<d>.m.<j>.*` and `model.<d>.anchors`, d = 24 for P5 and 33 for a
    P6 variant), with seeded weights and non-trivial BN statistics."""
    import torch

    from vehicle_counting_tpu_torch.models.yolo import default_config, detect_key, init_yolov5

    cfg = default_config(variant, num_classes)
    tree = init_yolov5(torch.Generator().manual_seed(0), cfg)
    head = detect_key(tree) + "."
    sd: Dict[str, np.ndarray] = {}

    def visit(node, path):
        if isinstance(node, list):
            for j, child in enumerate(node):
                visit(child, f"{path}.{j}")
        elif "w" in node:
            cout, cin, kh, kw = node["w"].shape
            w = (rng.standard_normal((cout, cin, kh, kw)) * np.sqrt(2.0 / (cin * kh * kw))).astype(np.float32)
            if path.startswith(head):
                sd[f"model.{path}.weight"] = w
                sd[f"model.{path}.bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
                return
            sd[f"model.{path}.conv.weight"] = w
            sd[f"model.{path}.bn.weight"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
            sd[f"model.{path}.bn.bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
            sd[f"model.{path}.bn.running_mean"] = rng.normal(0, 0.1, cout).astype(np.float32)
            sd[f"model.{path}.bn.running_var"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        else:
            for key, child in node.items():
                visit(child, f"{path}.{key}" if path else key)

    visit(tree, "")
    anchors = np.asarray(cfg.anchors, np.float32)  # [nl, na, 2] pixels
    sd[f"model.{head}anchors"] = anchors / np.asarray(cfg.strides, np.float32)[:, None, None]
    return sd


def fake_reid_state_dict(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A `net_dict` named and shaped like the reference ReID `ckpt.t7`'s
    (conv.0/conv.1 stem, layer{1..4}.{0,1}.*, no classifier), seeded."""
    import torch

    from vehicle_counting_tpu_torch.models.reid import init_reid

    params, _ = init_reid(torch.Generator().manual_seed(1))
    sd: Dict[str, np.ndarray] = {}

    def conv(name, like):
        cout, cin, kh, kw = like.shape
        sd[f"{name}.weight"] = (rng.standard_normal(tuple(like.shape)) * np.sqrt(2.0 / (cin * kh * kw))).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    conv("conv.0", params["stem"]["w"])
    sd["conv.0.bias"] = rng.normal(0, 0.1, 64).astype(np.float32)
    bn("conv.1", 64)
    for name, p in params.items():
        if not name.startswith("layer"):  # the stem above; no classifier head
            continue
        base = name.replace("_", ".")  # layer1_0 -> layer1.0
        c = p["conv1"]["w"].shape[0]
        conv(f"{base}.conv1", p["conv1"]["w"])
        bn(f"{base}.bn1", c)
        conv(f"{base}.conv2", p["conv2"]["w"])
        bn(f"{base}.bn2", c)
        if "down" in p:
            conv(f"{base}.downsample.0", p["down"]["w"])
            bn(f"{base}.downsample.1", c)
    return sd


def tracker_frame_case(rng: np.random.Generator, c: int, k: int, budget: int = 6, feat: int = 16,
                       gallery_dtype: str = "float32", crowded: bool = False, absent: bool = True,
                       max_age: int = 3, device="cpu"):
    """A random tracker state for C classes of K slots and one frame's
    inputs, for holding kernels K9 / K10 against the frame step's op chain:
    (DeepSortParams, TrackerState, FrameInputs, out_hw).

    About half the slots are live (nine in ten with `crowded`), tentative or
    confirmed, with times since update up to max_age + 1, so a frame both
    deletes tentative tracks and expires confirmed ones; the gallery counts
    run past the ring (budget) and the covariances are SPD. Half the
    detections sit on a live track's predicted box (a pixel of jitter) with
    a feature near one of its gallery rows, the rest are clutter; a few are
    invalid. With `crowded` every slot holds a valid detection, so the
    initiations outrun the free slots (overflow). With `absent` and C > 1
    the last class had no raw detection. Everything is drawn from `rng`."""
    import torch

    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, FrameInputs
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState

    hp = DeepSortParams(tracker=TrackerParams(capacity=k, feat_dim=feat, budget=budget, max_age=max_age, n_init=3,
                                              feat_dtype=gallery_dtype), num_classes=c)
    f32, i32 = np.float32, np.int32
    state = np.where(rng.random((c, k)) < (0.9 if crowded else 0.5), rng.integers(1, 3, (c, k)), 0).astype(i32)
    live = state > 0
    hits = np.where(live, rng.integers(1, 6, (c, k)), 0).astype(i32)
    age = np.where(live, hits + rng.integers(0, 5, (c, k)), 0).astype(i32)
    tsu = np.where(live, rng.integers(0, max_age + 2, (c, k)), 0).astype(i32)
    track_id = np.where(live, np.arange(1, c * k + 1).reshape(c, k), 0).astype(i32)
    next_id = (track_id.max(-1) + 1).astype(i32)
    mean = np.zeros((c, k, 8), f32)
    mean[..., 0] = rng.uniform(40, 260, (c, k))
    mean[..., 1] = rng.uniform(40, 200, (c, k))
    mean[..., 2] = rng.uniform(0.4, 2.0, (c, k))
    mean[..., 3] = rng.uniform(12, 50, (c, k))
    mean[..., 4:6] = rng.normal(0, 1.5, (c, k, 2))
    mean[..., 6] = rng.normal(0, 0.01, (c, k))
    mean[..., 7] = rng.normal(0, 0.3, (c, k))
    std = np.concatenate([np.full((c, k, 2), 2.0), np.full((c, k, 1), 0.05), np.full((c, k, 1), 2.0),
                          np.full((c, k, 2), 0.8), np.full((c, k, 1), 1e-3), np.full((c, k, 1), 0.8)], -1)
    std = std * rng.uniform(0.5, 2.0, (c, k, 1))
    a = rng.normal(0, 0.2, (c, k, 8, 8))
    cov = (np.einsum("...i,ij->...ij", std ** 2, np.eye(8)) + a @ np.swapaxes(a, -1, -2)).astype(f32)
    rows = rng.standard_normal((c, k, budget, feat))
    gallery = (rows / np.linalg.norm(rows, axis=-1, keepdims=True)).astype(f32)
    gallery_count = np.where(live, rng.integers(0, 2 * budget + 1, (c, k)), 0).astype(i32)
    pending_count = np.where(live, rng.integers(0, 3, (c, k)), 0).astype(i32)
    last_conf = rng.uniform(0.2, 0.95, (c, k)).astype(f32)
    overflow = rng.integers(0, 3, c).astype(i32)

    tlwh = np.zeros((c, k, 4), f32)
    feats = rng.standard_normal((c, k, feat)).astype(f32)
    valid = np.zeros((c, k), bool)
    for ci in range(c):
        tracks = np.flatnonzero(live[ci])
        n_det = k if crowded else int(rng.integers(k // 4, k // 2 + 2))
        for d in range(min(n_det, k)):
            if d % 2 == 0 and tracks.size:
                t = tracks[rng.integers(0, tracks.size)]
                m = mean[ci, t]
                w, h = m[2] * m[3], m[3]
                cx, cy = m[0] + m[4], m[1] + m[5]
                tlwh[ci, d] = [cx - w / 2, cy - h / 2, w, h] + rng.normal(0, 1.0, 4)
                feats[ci, d] = gallery[ci, t, int(rng.integers(0, budget))] * 4 + rng.normal(0, 0.05, feat)
            else:
                tlwh[ci, d] = [*rng.uniform(0, 280, 2), *rng.uniform(10, 60, 2)]
            valid[ci, d] = crowded or rng.random() < 0.9
    scores = rng.uniform(0.3, 0.95, (c, k)).astype(f32)
    order = np.argsort(rng.random((c, k)), -1).astype(i32)
    present = np.ones(c, bool)
    if absent and c > 1:
        present[-1] = False

    def t(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)

    st = TrackerState(t(mean), t(cov), t(track_id), t(state), t(hits), t(age), t(tsu),
                      t(gallery, getattr(torch, gallery_dtype)), t(gallery_count), t(pending_count), t(last_conf),
                      t(next_id), t(overflow))
    inp = FrameInputs(t(tlwh), t(scores), t(valid), t(feats), t(present), t(order))
    return hp, st, inp, (240, 300)
