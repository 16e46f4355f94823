"""The detector network's convolutions one by one, from the configuration's
layer table and its `net_hw` alone, and the time they take at the card's
peaks: what `detect_net_roofline` divides by the network's busy time. The
count follows `counts.detector_flops` layer by layer (their FLOPs sum to
it)."""

from __future__ import annotations

from cellbench.counts import _out, conv_flops
from cellbench.reference import yolo as yolo_ref

# the configuration's compute dtype -> (bytes an element, the peak its convolutions run at)
PRECISION = {"bfloat16": (2, "bf16_flops"), "float16": (2, "bf16_flops"), "float32": (4, "tf32_flops")}


def detector_convs(cfg, net_hw):
    """[(FLOPs, input elements, weight elements, output elements)] of every
    convolution of one frame at `net_hw`, in the network's order."""
    shapes = yolo_ref.conv_shapes(cfg)
    convs = []

    def conv(hw, w, s=1, p=None):
        co, ci, k = w
        ho = _out(hw, k, s, k // 2 if p is None else p)
        convs.append((conv_flops(ho, co, ci, k), ci * hw[0] * hw[1], co * ci * k * k, co * ho[0] * ho[1]))
        return ho

    hws, hw = [], tuple(net_hw)
    for i, (f, n, m, cin, cout, args) in enumerate(yolo_ref.layer_table(cfg)):
        w = shapes.get(str(i))
        if m == "Conv":
            hw = conv(hw, w, args[2] if len(args) > 2 else 1, args[3] if len(args) > 3 else None)
        elif m == "C3":
            conv(hw, w["cv1"])
            conv(hw, w["cv2"])
            for b in w["m"]:
                conv(hw, b["cv1"])
                conv(hw, b["cv2"])
            conv(hw, w["cv3"])
        elif m == "SPPF":
            conv(hw, w["cv1"])
            conv(hw, w["cv2"])
        elif m == "nn.Upsample":
            hw = (hw[0] * 2, hw[1] * 2)
        elif m == "Detect":
            for c, j in zip(w["m"], f):
                conv(hws[j], c)
        hws.append(hw)
    return convs


def net_bound_s(cfg, peaks) -> float:
    """Seconds a frame of the network takes at best: over its convolutions,
    each at the larger of its FLOPs at the dense peak of the compute dtype
    and its bytes at the memory rate, for a batch of `cfg["batch"]` frames
    (input and output once a frame, the weights once a batch), over the
    batch's frames."""
    itemsize, peak = PRECISION[cfg["compute_dtype"]]
    b = cfg["batch"]
    total = 0.0
    for flops, x, w, y in detector_convs(cfg, cfg["net_hw"]):
        total += max(b * flops / peaks[peak], itemsize * (b * (x + y) + w) / peaks["hbm_bytes_per_s"])
    return total / b
