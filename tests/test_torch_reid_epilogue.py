"""PyTorch port, kernel K8 (the ReID trunk's BN epilogue): its plain version
against the eager op chain that models/reid.py ran after each convolution
before it, the CPU embedding bitwise unchanged, the kept `inv`, the
wrapper's checks; on a card the kernel bitwise against its plain version
and its launches per forward."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vehicle_counting_tpu_torch.models import reid as treid
from vehicle_counting_tpu_torch.ops import reid_epilogue as tre
from vehicle_counting_tpu_torch.testing import (
    EPILOGUE_CASES,
    fake_reid_state_dict,
    one_torch_thread,
    reid_block_eager,
    reid_bn_eager,
    reid_conv_eager,
    reid_epilogue_operands,
)

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

LAYOUTS = {"nchw": torch.contiguous_format, "channels_last": torch.channels_last}


# ---------------------------------------------------------------------------
# the eager chain of models/reid.py before K8, kept as the reference
# ---------------------------------------------------------------------------

def _trunk_eager(params, stats, x, dtype, parity):
    y = reid_conv_eager(x, params["stem"]["w"], 1, 1, dtype) + params["stem"]["b"].view(1, -1, 1, 1)
    y = F.max_pool2d(torch.relu(reid_bn_eager(y, params["stem"]["bn"], stats["stem"])), 3, 2, 1)
    fused = treid._reid_block_on()
    for si, (_, _, ds) in enumerate(treid.STAGES):
        for bi in range(2):
            name = f"layer{si + 1}_{bi}"
            stride = 2 if (ds and bi == 0) else 1
            if (fused and stride == 1 and "down" not in params[name] and tuple(y.shape[1:]) == (64, 25, 25)
                    and (dtype == torch.bfloat16 or parity or y.device.type == "cpu")):
                y = treid._block_fused(params[name], stats[name], y.to(dtype)).float()
                continue
            y = reid_block_eager(params[name], stats[name], y, stride, dtype)
    return F.avg_pool2d(y, 4, 1).flatten(1)


def _embed_eager(params, stats, crops, dtype):
    return treid._l2_normalise(_trunk_eager(params, stats, crops.permute(0, 3, 1, 2), dtype, False))


def _eager_epilogue(case, ops, x):
    """What the eager chain computed after one convolution: (f32, bf16 copy for the next conv)."""
    opt = EPILOGUE_CASES[case]
    y = x.float()
    if opt["pre_bias"]:
        y = y + ops["pre_bias"].view(1, -1, 1, 1)
    y = reid_bn_eager(y, {"scale": ops["scale"], "bias": ops["bias"]}, {"mean": ops["mean"], "var": ops["var"]})
    if opt["residual"]:
        y = ops["residual"] + y
    if opt["relu"]:
        y = torch.relu(y)
    return (y if opt["f32"] else None), (y.to(torch.bfloat16) if opt["lo"] else None)


def _operands(case, shape, dtype, layout, device="cpu", seed=90):
    ops = {k: torch.from_numpy(v).to(device) for k, v in reid_epilogue_operands(np.random.default_rng(seed), shape).items()}
    ops["x"] = ops["x"].to(dtype).contiguous(memory_format=LAYOUTS[layout])
    ops["residual"] = ops["residual"].contiguous(memory_format=LAYOUTS[layout])
    return ops


def _call(fn, case, ops):
    opt = EPILOGUE_CASES[case]
    return fn(ops["x"], ops["mean"], tre.bn_inv(ops["var"], treid.BN_EPS), ops["scale"], ops["bias"],
              pre_bias=ops["pre_bias"] if opt["pre_bias"] else None,
              residual=ops["residual"] if opt["residual"] else None, relu=opt["relu"], f32=opt["f32"],
              lo=torch.bfloat16 if opt["lo"] else None)


def _bits(t):
    """A tensor's bit patterns (NaN == NaN where the bits are the same)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape and g.stride() == w.stride()
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(EPILOGUE_CASES))
def test_plain_matches_eager_chain(case, dtype, layout):
    """Every option (the stem's bias, the down path without ReLU, the
    shortcut + ReLU, each output) on f32 and bf16 convolution outputs in
    both memory formats: bitwise, NaN and zeros of both signs included, in
    the input's memory format."""
    ops = _operands(case, (3, 16, 5, 7), dtype, layout)
    got = _call(tre.reid_epilogue, case, ops)
    _assert_same(got, _eager_epilogue(case, ops, ops["x"]))
    assert all(t.is_contiguous(memory_format=LAYOUTS[layout]) for t in got if t is not None)


@pytest.fixture(scope="module")
def reid_weights():
    return treid.reid_state_dict_to_pytree(fake_reid_state_dict(np.random.default_rng(91)))


@pytest.mark.parametrize("k5", [False, True], ids=["k5_off", "k5_on"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_reid_embed_cpu_unchanged(reid_weights, monkeypatch, dtype, k5):
    """`reid_embed` on the CPU is bitwise the eager chain's, with K5 (its
    plain version) off and on, and the trunk calls the epilogue once per
    convolution K5 does not take: 20 and 16 per forward."""
    tp, ts = reid_weights
    if dtype is not None:
        tp = treid.cast_conv_weights(tp, dtype)
    crops = torch.from_numpy(np.random.default_rng(92).standard_normal((3, 50, 50, 3)).astype(np.float32))
    monkeypatch.setattr(treid, "FORCE_PALLAS_REID_BLOCK", k5)
    calls = []
    monkeypatch.setattr(treid, "reid_epilogue", lambda *a, **k: calls.append(1) or tre.reid_epilogue(*a, **k))
    got = treid.reid_embed(tp, ts, crops, dtype=dtype)
    assert len(calls) == (16 if k5 else 20)
    want = _embed_eager(tp, ts, crops, torch.float32 if dtype is None else dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_reid_apply_inference_unchanged(reid_weights, dtype):
    """`reid_apply(train=False)` (the trainer's evaluation and
    `extract_features`) bitwise the eager chain's; with f64 state (the
    trainer's reference runs) the plain chain promotes as before."""
    tp, ts = reid_weights

    def cast(tree):
        return {k: cast(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dtype)

    tp, ts = cast(tp), cast(ts)
    crops = torch.from_numpy(np.random.default_rng(93).standard_normal((2, 50, 50, 3)).astype(np.float32))
    got, _ = treid.reid_apply(tp, ts, crops, train=False, reid=True)
    want = treid._l2_normalise(_trunk_eager(tp, ts, crops.permute(0, 3, 1, 2), torch.float32, True))
    assert got.dtype == want.dtype and torch.equal(got, want)


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def test_cached_inv_follows_in_place_update(reid_weights):
    """`bn_inv` keeps rsqrt(var + eps) per var tensor and makes it anew
    after an in-place update of var, as the trainer's updates are; the
    embedding then follows the update."""
    tp, ts = reid_weights
    ts = _clone(ts)  # the fixture's tensors stay as they are
    var = ts["layer3_0"]["bn1"]["var"]
    first = tre.bn_inv(var, treid.BN_EPS)
    assert tre.bn_inv(var, treid.BN_EPS) is first
    assert torch.equal(first, torch.rsqrt(var + treid.BN_EPS))
    crops = torch.from_numpy(np.random.default_rng(94).standard_normal((2, 50, 50, 3)).astype(np.float32))
    before = treid.reid_embed(tp, ts, crops)
    var.mul_(1.5)
    second = tre.bn_inv(var, treid.BN_EPS)
    assert second is not first and torch.equal(second, torch.rsqrt(var + treid.BN_EPS))
    got = treid.reid_embed(tp, ts, crops)
    assert not torch.equal(got, before)
    assert torch.equal(got, _embed_eager(tp, ts, crops, torch.float32))


def _fake_entry(calls):
    def entry(lib, symbol, argtypes):
        assert (lib, symbol) == ("reid_epilogue", "vct_reid_epilogue") and len(argtypes) == 16
        return lambda *args: calls.append(args) or 0
    return entry


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_wrapper_passes_the_kernel_its_operands(monkeypatch, layout):
    """The launch path on CPU stand-ins (the C entry replaced): pointers,
    sizes, the layout flag and options as the C entry takes them, and
    outputs allocated in x's memory format."""
    calls = []
    monkeypatch.setattr(tre._build, "entry", _fake_entry(calls))
    monkeypatch.setattr(tre._build, "current_stream", lambda device: 7)
    ops = _operands("conv2", (2, 8, 3, 5), torch.bfloat16, layout)
    inv = tre.bn_inv(ops["var"], treid.BN_EPS)
    out32, outlo = tre._launch(ops["x"], ops["mean"], inv, ops["scale"], ops["bias"], None, ops["residual"], True,
                               True, torch.bfloat16)
    (args,) = calls
    assert args == (ops["x"].data_ptr(), 1, ops["mean"].data_ptr(), inv.data_ptr(), ops["scale"].data_ptr(),
                    ops["bias"].data_ptr(), 0, ops["residual"].data_ptr(), out32.data_ptr(), outlo.data_ptr(),
                    2 * 8 * 3 * 5, 8, 15, int(layout == "channels_last"), 1, 7)
    assert out32.dtype == torch.float32 and outlo.dtype == torch.bfloat16
    assert out32.stride() == outlo.stride() == ops["x"].stride()


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(tre._build, "entry", _fake_entry([]))
    ops = _operands("conv2", (2, 8, 3, 5), torch.float32, "nchw")
    inv = tre.bn_inv(ops["var"], treid.BN_EPS)
    vec = (ops["mean"], inv, ops["scale"], ops["bias"])

    def launch(x=ops["x"], v=vec, pre_bias=None, residual=None, f32=True, lo=None):
        return tre._launch(x, *v, pre_bias, residual, False, f32, lo)

    with pytest.raises(ValueError, match=r"\[N, C, H, W\]"):
        launch(x=ops["x"][0])
    with pytest.raises(ValueError, match=r"\[N, C, H, W\]"):
        launch(x=ops["x"].half())
    with pytest.raises(ValueError, match="channels-last"):
        launch(x=ops["x"].transpose(2, 3))
    with pytest.raises(ValueError, match="bfloat16 copy"):
        launch(lo=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 copy"):
        launch(f32=False)
    with pytest.raises(ValueError, match="BN vectors"):
        launch(v=(ops["mean"].double(), *vec[1:]))
    with pytest.raises(ValueError, match="BN vectors"):
        launch(pre_bias=ops["pre_bias"][:4])
    with pytest.raises(ValueError, match="residual"):
        launch(residual=ops["residual"].contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="unsupported device"):
        tre.reid_epilogue(ops["x"].to("meta"), *vec)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the epilogue kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EPILOGUE_CASES))
@pytest.mark.parametrize("n", [1, 37, 128])
def test_kernel_bitwise_plain(n, case):
    """The kernel == its plain version on the card, bitwise, for every
    option at the stem's shape and each stage's, f32 and bf16 input, NCHW
    and channels-last."""
    dev = _card()
    for shape in ((n, 64, 50, 50), (n, 64, 25, 25), (n, 128, 13, 13), (n, 256, 7, 7), (n, 512, 4, 4)):
        for dtype in (torch.float32, torch.bfloat16):
            for layout in LAYOUTS:
                ops = _operands(case, shape, dtype, layout, dev)
                _assert_same(_call(tre.reid_epilogue, case, ops), _call(tre.reid_epilogue_plain, case, ops))


@pytest.mark.cuda
@pytest.mark.parametrize("k5", [False, True], ids=["k5_off", "k5_on"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_reid_embed_card_bitwise(reid_weights, monkeypatch, dtype, k5):
    """`reid_embed` on the card through K8 == the same with the plain chain
    put in its place == the eager chain before K8, bitwise, with K5 off and
    on; K8 launches 20 times per forward, 16 with K5 on (in bf16: the
    embed's K5 takes no f32)."""
    dev = _card()
    tp, ts = treid._tree_to(reid_weights[0], dev), treid._tree_to(reid_weights[1], dev)
    if dtype is not None:
        tp = treid.cast_conv_weights(tp, dtype)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(treid, "FORCE_PALLAS_REID_BLOCK", k5)
    for n in (1, 37, 128):
        crops = torch.from_numpy(np.random.default_rng(95 + n).standard_normal((n, 50, 50, 3)).astype(np.float32))
        crops = crops.to(dev)
        tre.reid_epilogue.launches = 0
        got = treid.reid_embed(tp, ts, crops, dtype=dtype)
        assert tre.reid_epilogue.launches == (16 if k5 and dtype is not None else 20)  # K5 takes bf16 here
        with monkeypatch.context() as m:
            m.setattr(treid, "reid_epilogue", tre.reid_epilogue_plain)
            want = treid.reid_embed(tp, ts, crops, dtype=dtype)
        assert torch.equal(got, want)
        # and the eager chain with OIHW weights (relayout inside each convolution), as before K8
        assert torch.equal(got, _embed_eager(tp, ts, crops, torch.float32 if dtype is None else dtype))
