"""Operation and byte counts, from shapes alone: the model FLOPs of a frame
and of a ReID crop (every convolution, 2 * Ho * Wo * Cout * Cin * k * k),
one `aten::convolution` call's FLOPs and bytes, and K1's bytes. Peaks of
the card the roofline shares are taken against."""

from __future__ import annotations

from cellbench.reference import reid as reid_ref
from cellbench.reference import yolo as yolo_ref

# NVIDIA's data sheet, H100 SXM, dense, at the 700 W power limit
PEAKS = {"NVIDIA H100": {"bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12,
                         "hbm_bytes_per_s": 3.35e12}}


def peaks(kind: str):
    for prefix, p in PEAKS.items():
        if kind.startswith(prefix):
            return p
    return None


def _out(hw, k, s, p):
    return tuple((x + 2 * p - k) // s + 1 for x in hw)


def conv_flops(hw_out, cout, cin, k) -> float:
    return 2.0 * hw_out[0] * hw_out[1] * cout * cin * k * k


def detector_flops(cfg, net_hw) -> float:
    """One frame of the detector at `net_hw`."""
    shapes = yolo_ref.conv_shapes(cfg)
    hws, total = [], 0.0
    hw = tuple(net_hw)
    for i, (f, n, m, cin, cout, args) in enumerate(yolo_ref.layer_table(cfg)):
        w = shapes.get(str(i))
        if m == "Conv":
            k, s = args[1], args[2] if len(args) > 2 else 1
            hw = _out(hw, k, s, args[3] if len(args) > 3 else k // 2)
            total += conv_flops(hw, *w)
        elif m == "C3":
            total += sum(conv_flops(hw, *w[key]) for key in ("cv1", "cv2", "cv3"))
            total += sum(conv_flops(hw, *b["cv1"]) + conv_flops(hw, *b["cv2"]) for b in w["m"])
        elif m == "SPPF":
            total += conv_flops(hw, *w["cv1"]) + conv_flops(hw, *w["cv2"])
        elif m == "nn.Upsample":
            hw = (hw[0] * 2, hw[1] * 2)
        elif m == "Concat":
            pass  # the inputs share the previous layer's spatial size
        elif m == "Detect":
            total += sum(conv_flops(hws[j], *c) for c, j in zip(w["m"], f))
        hws.append(hw)
    return total


def reid_flops(rcfg) -> float:
    """One crop of the ReID network."""
    hw = tuple(rcfg["crop_hw"])
    c0 = rcfg["stem_channels"]
    total = conv_flops(hw, c0, 3, 3)
    hw = _out(hw, 3, 2, 1)  # max pool
    for _, cin, cout, stride, down in reid_ref.block_names(rcfg):
        out = _out(hw, 3, stride, 1)
        total += conv_flops(out, cout, cin, 3) + conv_flops(out, cout, cout, 3)
        if down:
            total += conv_flops(out, cout, cin, 1)
        hw = out
    return total


def conv_call(x_dims, w_dims, stride, pad, dil, groups, itemsize):
    """(FLOPs, bytes) of one convolution call: each input, weight and
    output element moved once."""
    n, c, h, w = x_dims
    o, i, kh, kw = w_dims
    ho = (h + 2 * pad[0] - dil[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (w + 2 * pad[1] - dil[1] * (kw - 1) - 1) // stride[1] + 1
    flops = 2.0 * n * o * ho * wo * i * kh * kw
    nbytes = itemsize * (n * c * h * w + o * i * kh * kw + n * o * ho * wo)
    return flops, nbytes


def k1_bytes(crop_bounds, launches: int, rows_per_launch: int, crop_hw) -> float:
    """K1's bytes: each source pixel a crop samples read once (u8 RGB; at
    most two taps per output row and column) and every crop row of every
    launch written once (f32 RGB). `crop_bounds`: (height, width) of each
    valid crop's integer box."""
    oh, ow = crop_hw
    read = sum(3 * min(h + 1, 2 * oh) * min(w + 1, 2 * ow) for h, w in crop_bounds)
    return read + launches * rows_per_launch * oh * ow * 3 * 4
