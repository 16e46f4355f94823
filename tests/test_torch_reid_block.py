"""PyTorch port, kernel K5: the fused ReID stage-1 block's plain version
against the TPU kernel in interpret mode, and the embedding with the block
switched on against JAX's, on the same numpy weights (carried across by
models/convert.py)."""

import copy
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vehicle_counting_tpu.models.reid as jreid
from vehicle_counting_tpu.ops.pallas.reid_block import reid_block64_pallas
from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.benchmarks.micro import reid_block_variants
from vehicle_counting_tpu_torch.models import reid as treid
from vehicle_counting_tpu_torch.models.convert import reid_block64_from_jax, reid_params_from_jax
from vehicle_counting_tpu_torch.ops import conv_s2 as tcs
from vehicle_counting_tpu_torch.ops import reid_block as trb
from vehicle_counting_tpu_torch.ops import weight_cache
from vehicle_counting_tpu_torch.testing import one_torch_thread, reid_block_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

# f32: conv summation order differs (XLA:CPU patch matmul vs oneDNN);
# bf16: h1 and the output are rounded to bf16 (2^-8 relative), so a sum
# that lands near a rounding boundary flips by one bf16 ulp
TOL = {"float32": dict(rtol=0, atol=1e-4), "bfloat16": dict(rtol=1.6e-2, atol=1e-2)}


def _jax_fold(bp, bs):
    a = jax.lax.rsqrt(jnp.asarray(bs["var"]) + jreid.BN_EPS) * bp["scale"]
    return a, bp["bias"] - bs["mean"] * a


@pytest.mark.parametrize("n", [1, 5, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(dtype, n):
    """N = 1, 5 and 9 are ragged against the TPU kernel's groups of G = 4
    crops (its last group is padded)."""
    rng = np.random.default_rng(30)
    p, s = reid_block_params(rng)
    x = (rng.standard_normal((n, 25, 25, 64)) * 0.5).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = reid_block64_pallas(
        jnp.asarray(x, jdt), p["conv1"]["w"], p["conv2"]["w"],
        *_jax_fold(p["bn1"], s["bn1"]), *_jax_fold(p["bn2"], s["bn2"]),
        use_bf16=dtype == "bfloat16", interpret=True,
    )
    ops = reid_block64_from_jax(p, s)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(getattr(torch, dtype))
    got = trb.reid_block64(tx, ops["w1"], ops["w2"], ops["a1"], ops["b1"], ops["a2"], ops["b2"])
    assert got.dtype == tx.dtype and got.shape == (n, 64, 25, 25)
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reid_weights():
    jp, js = jax.jit(jreid.init_reid)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(31)
    js = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32)), js)
    return jp, js, reid_params_from_jax(_np(jp), _np(js))


def test_reid_forward_with_block_matches_jax(reid_weights, monkeypatch):
    """Both packages with the stage-1 block switched on, f32, N = 4."""
    jp, js, (tp, ts) = reid_weights
    crops = np.random.default_rng(32).standard_normal((4, 50, 50, 3)).astype(np.float32)
    monkeypatch.setattr(jreid, "FORCE_PALLAS_REID_BLOCK", True)
    want, _ = jreid.reid_forward(jp, js, jnp.asarray(crops), train=False, reid=True)
    monkeypatch.setattr(treid, "FORCE_PALLAS_REID_BLOCK", True)
    calls = []
    monkeypatch.setattr(treid, "reid_block64", lambda *a: calls.append(1) or trb.reid_block64(*a))
    got = treid.reid_embed(tp, ts, torch.from_numpy(crops))
    assert len(calls) == 2  # layer1_0 and layer1_1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_reid_forward_with_block_after_in_place_update_matches_jax(reid_weights, monkeypatch):
    """The trainer updates the conv weights in place between calls: the
    block's kept HWIO weights (and the card's packs made from them) follow
    the update. One call fills the caches, a stage-1 weight changes in
    place, and the next call equals JAX's on the changed weights."""
    jp, js, (tp, ts) = reid_weights
    tp = copy.deepcopy(tp)  # the fixture's tensors stay as they are
    crops = torch.from_numpy(np.random.default_rng(36).standard_normal((4, 50, 50, 3)).astype(np.float32))
    monkeypatch.setattr(jreid, "FORCE_PALLAS_REID_BLOCK", True)
    monkeypatch.setattr(treid, "FORCE_PALLAS_REID_BLOCK", True)
    before = treid.reid_embed(tp, ts, crops)
    delta = (np.random.default_rng(37).standard_normal((3, 3, 64, 64)) * 0.05).astype(np.float32)  # HWIO
    w = tp["layer1_0"]["conv1"]["w"]
    version = w._version
    w.add_(torch.from_numpy(delta).permute(3, 2, 0, 1))  # OIHW, in place
    assert w._version > version
    jl = jp["layer1_0"]
    jp = {**jp, "layer1_0": {**jl, "conv1": {**jl["conv1"], "w": jl["conv1"]["w"] + delta}}}
    want, _ = jreid.reid_forward(jp, js, jnp.asarray(crops.numpy()), train=False, reid=True)
    got = treid.reid_embed(tp, ts, crops)
    assert not np.allclose(got.numpy(), before.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("switch,env,expect", [
    (None, None, 0), (None, "1", 2), (True, None, 2), (False, "1", 0), (True, "0", 0),
])
def test_block_switch(reid_weights, monkeypatch, switch, env, expect):
    """Off by default; the module switch FORCE_PALLAS_REID_BLOCK or the
    environment variable of the same name turns it on, =0 / False wins, as in the JAX package."""
    _, _, (tp, ts) = reid_weights
    monkeypatch.setattr(treid, "FORCE_PALLAS_REID_BLOCK", switch)
    if env is None:
        monkeypatch.delenv("FORCE_PALLAS_REID_BLOCK", raising=False)
    else:
        monkeypatch.setenv("FORCE_PALLAS_REID_BLOCK", env)
    calls = []
    monkeypatch.setattr(treid, "reid_block64", lambda *a: calls.append(1) or trb.reid_block64(*a))
    treid.reid_embed(tp, ts, torch.zeros((2, 50, 50, 3)))
    assert len(calls) == expect


def test_pack_weights_is_a_permutation_of_hwio():
    """The bf16 kernel's packed slabs hold exactly the HWIO weights: undo
    the [conv, tap, co, ci] transpose and the chunk swizzle (ci chunk c of
    row co stored at chunk c ^ (co % 8)) and compare bit for bit."""
    rng = np.random.default_rng(34)
    w1, w2 = (torch.from_numpy(rng.standard_normal((3, 3, 64, 64)).astype(np.float32)) for _ in range(2))
    packed = trb.pack_weights(w1, w2)
    assert packed.shape == (2, 9, 64, 64) and packed.dtype == torch.bfloat16 and packed.is_contiguous()
    chunks = packed.reshape(2, 9, 64, 8, 8)
    co = np.arange(64)[:, None]
    stored = np.arange(8)[None, :] ^ (co % 8)  # stored chunk of logical chunk c (columns)
    unswizzled = chunks[:, :, torch.from_numpy(co), torch.from_numpy(stored)]  # [conv, tap, co, c, 8]
    hwio = unswizzled.reshape(2, 9, 64, 64).transpose(2, 3).reshape(2, 3, 3, 64, 64)
    assert torch.equal(hwio[0], w1.to(torch.bfloat16)) and torch.equal(hwio[1], w2.to(torch.bfloat16))


def test_pack_weights_f32_is_a_permutation_of_hwio():
    """The f32 kernel's weights: [conv, ci, tap, co], every 8 input channels
    one contiguous chunk of all 9 taps; undo the transpose and compare bit
    for bit."""
    rng = np.random.default_rng(38)
    w1, w2 = (torch.from_numpy(rng.standard_normal((3, 3, 64, 64)).astype(np.float32)) for _ in range(2))
    packed = trb.pack_weights_f32(w1, w2)
    assert packed.shape == (2, 64, 9, 64) and packed.dtype == torch.float32 and packed.is_contiguous()
    hwio = packed.reshape(2, 64, 3, 3, 64).permute(0, 2, 3, 1, 4)  # [conv, kh, kw, ci, co]
    assert torch.equal(hwio[0], w1) and torch.equal(hwio[1], w2)
    chunk = packed.reshape(-1)[3 * 8 * 9 * 64:][:8 * 9 * 64].reshape(8, 9, 64)  # conv1's ci 24..31, as one copy
    assert torch.equal(chunk, w1.reshape(9, 64, 64)[:, 24:32].transpose(0, 1))


def _hwio_weights(seed, shape):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shape]


# (source shapes, the wrapper's kept pack, a fresh pack): K5 bf16, K5 f32, K6 bf16
PACKS = {
    "reid_block_bf16": ([(3, 3, 64, 64)] * 2, lambda ws: trb.kernel_weights(*ws, torch.bfloat16), trb.pack_weights),
    "reid_block_f32": ([(3, 3, 64, 64)] * 2, lambda ws: trb.kernel_weights(*ws, torch.float32), trb.pack_weights_f32),
    "conv_s2_bf16": ([(3, 3, 32, 64)], lambda ws: tcs.kernel_weights(*ws), tcs.pack_conv1_weights),
}


@pytest.mark.parametrize("kind", sorted(PACKS))
def test_weight_cache_hits_the_same_tensors(kind):
    shapes, kept, fresh = PACKS[kind]
    ws = _hwio_weights(40, shapes)
    first = kept(ws)
    assert kept(ws) is first
    assert torch.equal(first, fresh(*ws))


@pytest.mark.parametrize("kind", sorted(PACKS))
def test_weight_cache_misses_new_tensors(kind):
    """Equal values in other tensors are other keys: the cache never keys
    on contents or addresses."""
    shapes, kept, fresh = PACKS[kind]
    ws = _hwio_weights(41, shapes)
    first = kept(ws)
    copies = [w.clone() for w in ws]
    second = kept(copies)
    assert second is not first and torch.equal(second, first)


@pytest.mark.parametrize("kind", sorted(PACKS))
def test_weight_cache_never_keys_on_the_address(kind):
    """A new tensor at a dead one's address, as PyTorch's caching allocator
    hands out, with other values and the same version count: here the same
    numpy memory, rewritten while no tensor views it."""
    shapes, kept, fresh = PACKS[kind]
    arrays = [w.numpy() for w in _hwio_weights(44, shapes)]
    ws = [torch.from_numpy(a) for a in arrays]
    first, ptrs = kept(ws).clone(), [w.data_ptr() for w in ws]
    del ws
    gc.collect()
    for a in arrays:
        a += 1.0
    ws = [torch.from_numpy(a) for a in arrays]
    assert [w.data_ptr() for w in ws] == ptrs
    got = kept(ws)
    assert torch.equal(got, fresh(*ws)) and not torch.equal(got, first)


@pytest.mark.parametrize("kind", sorted(PACKS))
def test_weight_cache_follows_in_place_updates(kind):
    """w.add_(1) moves w's version: the next call packs the new values."""
    shapes, kept, fresh = PACKS[kind]
    ws = _hwio_weights(42, shapes)
    first = kept(ws).clone()
    ws[0].add_(1)
    second = kept(ws)
    assert torch.equal(second, fresh(*ws)) and not torch.equal(second, first)
    ws[-1][0, 0, 0, 0] = 7.0  # an indexed write moves it too
    assert torch.equal(kept(ws), fresh(*ws))


@pytest.mark.parametrize("kind", sorted(PACKS))
def test_weight_cache_drops_dead_tensors(kind):
    shapes, kept, fresh = PACKS[kind]
    ws = _hwio_weights(43, shapes)
    gc.collect()  # only this test's tensors die below
    before = weight_cache.size()
    kept(ws)
    assert weight_cache.size() == before + 1
    del ws
    gc.collect()
    assert weight_cache.size() == before


def test_weight_cache_is_bounded():
    keep = [torch.zeros(2) for _ in range(weight_cache.MAX_ENTRIES + 5)]
    for i, t in enumerate(keep):
        weight_cache.cached("bounded", (t,), lambda i=i: torch.full((1,), float(i)))
    assert weight_cache.size() <= weight_cache.MAX_ENTRIES
    made = []
    weight_cache.cached("bounded", (keep[0],), lambda: made.append(1) or torch.zeros(1))
    assert made  # the oldest entry went first


def test_weight_cache_never_keeps_inference_tensors():
    """An inference tensor has no version counter to key on: packed anew."""
    with torch.inference_mode():
        w = torch.ones(4)
    made = []
    for _ in range(2):
        weight_cache.cached("inference", (w,), lambda: made.append(1) or w * 2)
    assert len(made) == 2


def test_kernel_variants_still_fit_the_source():
    """The variant benchmark's edits each match the f32 kernel's source
    once, so its sweep runs against the kernel as committed."""
    res = reid_block_variants.main("cpu")
    assert res["variants"] == sorted(reid_block_variants.VARIANTS)
    with open(f"{_build.CSRC_DIR}/reid_block.cu") as f:
        committed = f.read()
    assert all(src != committed for src in reid_block_variants.variant_sources().values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            reid_block_variants.main("cuda")


def test_kernel_rejects_other_shapes():
    w = torch.zeros((3, 3, 64, 64))
    v = torch.zeros(64)
    with pytest.raises(ValueError, match=r"\[N, 64, 25, 25\]"):
        trb._launch(torch.zeros((2, 64, 13, 13)), w, w, v, v, v, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(d, n) for d in ("float32", "bfloat16") for n in (1, 128, 133)]
                         + [("float32", 3840)])
def test_kernel_matches_plain_on_card(dtype, n):
    """N = 128 is the embed's launch; N = 133 leaves some SMs two crops;
    f32 at N = 3840 is a 128-frame batch's crops, 29-30 per SM. The first
    4 crops of a launch equal a launch of those 4 alone, bit for bit: the
    kernel has no atomics and no state across crops."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the block kernel is CUDA C++ with no CPU mode")
    torch.backends.cudnn.allow_tf32 = False  # the plain version's f32 convs
    rng = np.random.default_rng(33)
    p, s = reid_block_params(rng)
    ops = {k: v.cuda() for k, v in reid_block64_from_jax(p, s).items()}
    x = torch.from_numpy(rng.standard_normal((n, 64, 25, 25)).astype(np.float32)).to(getattr(torch, dtype)).cuda()
    wts = (ops["w1"], ops["w2"], ops["a1"], ops["b1"], ops["a2"], ops["b2"])
    got = trb.reid_block64(x, *wts)
    torch.testing.assert_close(got.float(), trb.reid_block64_plain(x, *wts).float(), **TOL[dtype])
    if n > 4:
        assert torch.equal(got[:4], trb.reid_block64(x[:4].contiguous(), *wts))
