"""PyTorch port, ReID training (`vehicle_counting_tpu_torch/train/`) against
the JAX trainer (`vehicle_counting_tpu/train/reid_train.py`) on the CPU.

The JAX side runs once per module (`jax_run`): `create_train_state` at
PRNGKey(0) (8 classes), five `train_step`s at B=4 on class-coloured noise
(JAX's own test data) with keys PRNGKey(100 + i), checkpoints before the
first step and after steps 2 and 3, then `eval_step` / `extract_features`
and a `fit` resumed from the step-2 checkpoint. The port starts from those
checkpoints (its `load_checkpoint` reads the JAX layout) and takes JAX's
dropout masks: the test replays `jax.random.bernoulli` on the same keys and
hands the masks to `models/reid.py::dropout_keep`.

Tolerances. In f32 this step is ill-conditioned at init: against an f64
run of the port on the same inputs, JAX's f32 gradients (the momentum
trace after one step) are off by up to 2.5e-3 of a leaf's largest value,
the port's by 1.7e-5, and another f32 summation order (two data-parallel
shards) moves the port's by up to 2.7e-2 at B=16 (all measured). So the
loss, accuracy, params and BN stats are held at rtol 1e-4 / atol 1e-5 (the
JAX DP test's), and each trace leaf at atol TRACE_TOL x its largest value;
the semantics are held exactly where f32 cannot show them: in f64, where
the port's data-parallel step equals its single-device step to 1e-14.
"""

import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vehicle_counting_tpu.train import reid_train as J
from vehicle_counting_tpu_torch.models import reid as reid_mod
from vehicle_counting_tpu_torch.parallel.mesh import make_mesh
from vehicle_counting_tpu_torch.train import reid_cli
from vehicle_counting_tpu_torch.train import reid_train as P

B, NC, STEPS, SPE = 16, 8, 5, 10
LR = 0.005  # f32 noise compounds over steps at larger steps (see the module docstring)
RTOL, ATOL = 1e-4, 1e-5
# a gradient leaf's error, as a fraction of its largest value: JAX's f32
# step is off the f64 step by up to 0.10 here, the port's by 0.011
TRACE_TOL = 0.25
CURVE_RTOL = 0.05  # the losses of steps 2-5 and fit's history (measured 1.4e-2 at step 5)


def _toy_data(rng, n, num_classes, hw=50):
    """Class-colored noise images: trivially separable (test_reid_train.py)."""
    labels = rng.integers(0, num_classes, n)
    images = rng.normal(0, 0.3, size=(n, hw, hw, 3)).astype(np.float32)
    for i, l in enumerate(labels):
        images[i, :, :, l % 3] += (1.0 + l)
    return images, labels.astype(np.int32)


def _crops(rng, n, num_classes, hw=50):
    """Normalised-crop-like inputs: zero-mean unit-variance noise, random
    labels. (The toy data's +1..+8 channel offsets make train-mode BN
    subtract a large mean in f32: the port's own f32 step is then 1.3 %
    off its f64 step, and the 5-step curves of the two packages part by
    3 %; here they agree to f32.)"""
    return (rng.normal(size=(n, hw, hw, 3)).astype(np.float32),
            rng.integers(0, num_classes, n).astype(np.int32))


def _mask(key, n=B):
    return np.asarray(jax.random.bernoulli(key, 0.5, (n, 256)))


def _leaves(path):
    d = np.load(path)
    return [d[f"leaf_{i}"] for i in range(sum(k.startswith("leaf_") for k in d.files))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cached_opt():
    """One optax chain for every JAX state of the module: `train_step`
    takes it as a static argument, so one object keeps one compile."""
    return J.make_optimizer(J.ReidTrainConfig(num_classes=NC, batch_size=B, lr=LR), SPE)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, cached_opt):
    tmp = tmp_path_factory.mktemp("jax_train")
    cfg = J.ReidTrainConfig(num_classes=NC, batch_size=B, lr=LR)
    images, labels = _crops(np.random.default_rng(1702), STEPS * B, NC)
    params, stats, _, ost = J.create_train_state(jax.random.PRNGKey(0), cfg, SPE)
    ckpt = {0: str(tmp / "step0.npz")}
    J.save_checkpoint(ckpt[0], params, stats, ost, 0, 0.0)
    out = {"images": images, "labels": labels, "ckpt": ckpt, "loss": [], "acc": [], "masks": [], "tmp": tmp}
    feats_in = images[:B]
    out["eval"] = {k: float(v) for k, v in J.eval_step(params, stats, jnp.asarray(images[:B]),
                                                      jnp.asarray(labels[:B])).items()}
    out["feats"] = np.asarray(J.extract_features(params, stats, jnp.asarray(feats_in)))
    for i in range(STEPS):
        key = jax.random.PRNGKey(100 + i)
        out["masks"].append(_mask(key))
        sl = slice(i * B, (i + 1) * B)
        params, stats, ost, m = J.train_step(params, stats, ost, jnp.asarray(images[sl]), jnp.asarray(labels[sl]),
                                             key, opt=cached_opt)
        out["loss"].append(float(m["loss"]))
        out["acc"].append(float(m["acc"]))
        if i + 1 in (1, 2, 3):
            ckpt[i + 1] = str(tmp / f"step{i + 1}.npz")
            J.save_checkpoint(ckpt[i + 1], params, stats, ost, 1, 0.0)
    out["template"] = (params, stats, ost)
    return out


def _port_state(path, cfg=None):
    cfg = cfg or P.ReidTrainConfig(num_classes=NC, batch_size=B, lr=LR)
    params, stats, opt, ost = P.create_train_state(torch.Generator().manual_seed(0), cfg, SPE, "cpu")
    params, stats, ost, epoch, acc = P.load_checkpoint(path, params, stats, ost)
    return params, stats, opt, ost


def _shared_masks(monkeypatch, masks):
    it = iter(masks)
    monkeypatch.setattr(reid_mod, "dropout_keep", lambda gen, shape, device: torch.from_numpy(next(it)).to(device))


def _assert_state(got, want, n_params, n_stats, what, lr=LR):
    """One step's state against JAX's: BN stats at rtol/atol; each trace
    leaf at TRACE_TOL of its largest value; each param at that error times
    the step's lr (param = old - lr * trace); the count equal. Returns the
    worst trace and param errors, as fractions of the trace's largest value."""
    assert len(got) == len(want), what
    assert all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want)), what
    trace = want[n_params + n_stats:-1]
    scale = [max(float(np.abs(t).max()), 1e-3) for t in trace]
    worst = {"trace": 0.0, "param": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        if n_params <= i < n_params + n_stats or g.dtype == np.int32:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{what}: stats leaf {i}")
            continue
        kind, j = ("param", i) if i < n_params else ("trace", i - n_params - n_stats)
        tol = TRACE_TOL * scale[j] * (lr if kind == "param" else 1.0)
        worst[kind] = max(worst[kind], float(np.abs(g - w).max()) / (scale[j] * (lr if kind == "param" else 1.0)))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL + tol, err_msg=f"{what}: {kind} leaf {i}")
    print(f"{what}: worst error / largest trace value: {worst}")
    return worst


def test_checkpoint_leaf_count_matches_jax(jax_run):
    """(params, stats, opt_state) flatten to JAX's leaf count and shapes."""
    params, stats, _, ost = _port_state(jax_run["ckpt"][0])
    got = P.checkpoint_leaves(params, stats, ost)
    want = jax.tree.leaves(jax_run["template"])
    assert len(got) == len(want) == len(_leaves(jax_run["ckpt"][0]))
    assert [a.shape for a in got] == [tuple(np.shape(b)) for b in want]


def test_reid_params_from_jax_carries_the_head(jax_run):
    """`models/convert.py::reid_params_from_jax` brings the classifier head
    and its BN stats across: every leaf bitwise what the port's
    `load_checkpoint` reads from the same JAX state."""
    from vehicle_counting_tpu.models.reid import init_reid as j_init_reid
    from vehicle_counting_tpu_torch.models.convert import reid_params_from_jax

    jp, js = j_init_reid(jax.random.PRNGKey(0), num_classes=NC)
    params, stats = reid_params_from_jax(jp, js)
    assert {"fc1", "fc2"} <= set(params) and "fc1" in stats
    lp, ls, _, _ = _port_state(jax_run["ckpt"][0])
    for a, b in zip(P._flatten((params, stats)), P._flatten((lp, ls))):
        assert torch.equal(a, b.detach())


def test_train_step_matches_jax(jax_run, monkeypatch):
    """One step from JAX's initial state with JAX's dropout mask: loss, acc
    and every updated leaf (params, BN stats, momentum trace, count)."""
    params, stats, opt, ost = _port_state(jax_run["ckpt"][0])
    _shared_masks(monkeypatch, jax_run["masks"])
    im, lb = jax_run["images"][:B], jax_run["labels"][:B]
    params, stats, ost, m = P.train_step(params, stats, ost, im, lb, torch.Generator(), opt=opt)
    np.testing.assert_allclose(float(m["loss"]), jax_run["loss"][0], rtol=RTOL)
    assert float(m["acc"]) == jax_run["acc"][0]
    n_p, n_s = len(P._flatten(params)), len(P._flatten(stats))
    _assert_state(P.checkpoint_leaves(params, stats, ost), _leaves(jax_run["ckpt"][1]), n_p, n_s, "step 1")


def test_five_step_loss_curve_matches_jax(jax_run, monkeypatch):
    params, stats, opt, ost = _port_state(jax_run["ckpt"][0])
    _shared_masks(monkeypatch, jax_run["masks"])
    losses, accs = [], []
    for i in range(STEPS):
        sl = slice(i * B, (i + 1) * B)
        params, stats, ost, m = P.train_step(params, stats, ost, jax_run["images"][sl], jax_run["labels"][sl],
                                             torch.Generator(), opt=opt)
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
    np.testing.assert_allclose(losses[0], jax_run["loss"][0], rtol=RTOL)
    np.testing.assert_allclose(losses, jax_run["loss"], rtol=CURVE_RTOL)
    assert accs[0] == jax_run["acc"][0]
    # once the losses part (f32 noise, TRACE_TOL), a sample may flip its argmax
    assert np.abs(np.subtract(accs, jax_run["acc"])).max() <= 1.0 / B
    assert ost.count == STEPS


def test_jax_checkpoint_resumes_in_port(jax_run, monkeypatch):
    """The step-2 JAX checkpoint (momentum set, count 2) resumed in the
    port: its next step is JAX's step 3."""
    params, stats, opt, ost = _port_state(jax_run["ckpt"][2])
    assert ost.count == 2
    _shared_masks(monkeypatch, jax_run["masks"][2:])
    sl = slice(2 * B, 3 * B)
    params, stats, ost, m = P.train_step(params, stats, ost, jax_run["images"][sl], jax_run["labels"][sl],
                                         torch.Generator(), opt=opt)
    np.testing.assert_allclose(float(m["loss"]), jax_run["loss"][2], rtol=RTOL)
    n_p, n_s = len(P._flatten(params)), len(P._flatten(stats))
    _assert_state(P.checkpoint_leaves(params, stats, ost), _leaves(jax_run["ckpt"][3]), n_p, n_s, "step 3")


def test_port_checkpoint_loads_in_jax(jax_run, tmp_path, monkeypatch):
    """A port checkpoint read by JAX's `load_checkpoint`: every leaf
    bitwise the port's (conv weights and traces HWIO), meta intact."""
    params, stats, opt, ost = _port_state(jax_run["ckpt"][0])
    _shared_masks(monkeypatch, jax_run["masks"])
    params, stats, ost, _ = P.train_step(params, stats, ost, jax_run["images"][:B], jax_run["labels"][:B],
                                         torch.Generator(), opt=opt)
    path = str(tmp_path / "port.npz")
    P.save_checkpoint(path, params, stats, ost, 3, 0.25)
    jp, js, jo, epoch, acc = J.load_checkpoint(path, *jax_run["template"])
    assert (epoch, acc) == (3, 0.25)
    got = [np.asarray(x) for x in jax.tree.leaves((jp, js, jo))]
    want = P.checkpoint_leaves(params, stats, ost)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # and back: the file loads into a fresh port state bitwise
    p2, s2, _, o2 = _port_state(path)
    for g, w in zip(P.checkpoint_leaves(p2, s2, o2), want):
        np.testing.assert_array_equal(g, w)


def test_eval_step_and_features_match_jax(jax_run):
    params, stats, _, _ = _port_state(jax_run["ckpt"][0])
    im, lb = jax_run["images"][:B], jax_run["labels"][:B]
    ev = P.eval_step(params, stats, im, lb)
    np.testing.assert_allclose(float(ev["loss"]), jax_run["eval"]["loss"], rtol=RTOL)
    assert float(ev["acc"]) == jax_run["eval"]["acc"]
    feats = P.extract_features(params, stats, im)
    np.testing.assert_allclose(feats.numpy(), jax_run["feats"], rtol=RTOL, atol=ATOL)
    # the inference embed path, bitwise
    assert torch.equal(feats, reid_mod.reid_embed(params, stats, torch.from_numpy(im)))


def test_top1_retrieval_accuracy_matches_jax(jax_run):
    rng = np.random.default_rng(3)
    q, g = rng.normal(size=(12, 16)).astype(np.float32), rng.normal(size=(20, 16)).astype(np.float32)
    ql, gl = rng.integers(0, 4, 12), rng.integers(0, 4, 20)
    want = J.top1_retrieval_accuracy(q, ql, g, gl)
    assert P.top1_retrieval_accuracy(torch.from_numpy(q), torch.from_numpy(ql), g, gl) == want
    params, stats, _, _ = _port_state(jax_run["ckpt"][0])
    feats = P.extract_features(params, stats, jax_run["images"][:B])
    assert P.top1_retrieval_accuracy(feats, jax_run["labels"][:B], feats, jax_run["labels"][:B]) == 1.0


@pytest.mark.parametrize("step", [0, 20 * SPE - 1, 20 * SPE])
def test_lr_schedule_matches_optax(step):
    cfg = P.ReidTrainConfig()
    sched = optax.exponential_decay(cfg.lr, transition_steps=cfg.lr_decay_every * SPE, decay_rate=0.1,
                                    staircase=True)
    assert P.make_optimizer(cfg, SPE).lr_at(step) == float(np.float32(sched(step)))


def test_sgd_updates_match_optax_across_the_decay():
    """torch SGD + the staircase against optax's chain on one tree with
    fixed gradients: the first update (optax's zero trace against torch's
    first-gradient buffer) and the update at the decay step (spe = 1,
    decay every 2 epochs: step 2)."""
    cfg = P.ReidTrainConfig(lr_decay_every=2)
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(4)]
    jopt = J.make_optimizer(J.ReidTrainConfig(lr_decay_every=2), 1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jopt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = P.make_optimizer(cfg, 1)
    ost = opt.init(tp)
    for g in grads:
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k])
        for group in ost.sgd.param_groups:
            group["lr"] = opt.lr_at(ost.count)
        ost.sgd.step()
        ost.count += 1
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    assert ost.count == int(jax.tree.leaves(jst)[-1])


def test_dp_train_step_matches_single(jax_run):
    """DP over a CPU mesh of 2 == the single-device step. JAX's test case
    (B=16 toy data, 4 classes, lr 0.05, one step): loss at rel 1e-4 and
    the first param leaf at rtol 1e-4 / atol 1e-5, in f32; and every leaf
    in f64, where f32's summation order cannot hide a difference (measured
    9.5e-15 of a leaf's largest value)."""
    cfg = P.ReidTrainConfig(num_classes=4, lr=0.05, batch_size=16, num_epochs=2)
    images, labels = _toy_data(np.random.default_rng(1702), 16, cfg.num_classes)

    def step(mesh, dtype):
        params, stats, opt, ost = P.create_train_state(torch.Generator().manual_seed(0), cfg, 10, "cpu")
        if dtype == torch.float64:
            params, stats, ost = P.cast_train_state(params, stats, opt, dtype)
        params, stats, ost, m = P.train_step(params, stats, ost, images, labels, torch.Generator().manual_seed(5),
                                             opt=opt, mesh=mesh)
        return float(m["loss"]), P.checkpoint_leaves(params, stats, ost)

    mesh = make_mesh(2, ("data",), "cpu")
    (l1, a1), (l2, a2) = step(None, torch.float32), step(mesh, torch.float32)
    assert l1 == pytest.approx(l2, rel=1e-4)
    np.testing.assert_allclose(a2[0], a1[0], rtol=1e-4, atol=1e-5)
    (l1, a1), (l2, a2) = step(None, torch.float64), step(mesh, torch.float64)
    assert l1 == pytest.approx(l2, rel=1e-12)
    for i, (x, y) in enumerate(zip(a2, a1)):
        np.testing.assert_allclose(x, y, rtol=1e-10, atol=1e-12 * max(float(np.abs(y).max()), 1.0), err_msg=str(i))


def test_f32_step_close_to_f64(jax_run, monkeypatch):
    """The port's f32 step and JAX's against the port's step in f64, each
    leaf's error as a fraction of its gradient's largest value (a param
    moves by lr x its trace): the port's within 3e-2 (measured 1.1e-2),
    JAX's within TRACE_TOL (measured 0.10). A step with another semantics
    (no dropout, say) lands ~2x the gradient off."""
    def step(dtype):
        params, stats, opt, ost = _port_state(jax_run["ckpt"][0])
        if dtype == torch.float64:
            params, stats, ost = P.cast_train_state(params, stats, opt, dtype)
        _shared_masks(monkeypatch, jax_run["masks"][:1])
        params, stats, ost, _ = P.train_step(params, stats, ost, jax_run["images"][:B], jax_run["labels"][:B],
                                             torch.Generator(), opt=opt)
        return P.checkpoint_leaves(params, stats, ost), len(P._flatten(params)), len(P._flatten(stats))

    (f32, n_p, n_s), (f64, _, _) = step(torch.float32), step(torch.float64)
    jax1 = _leaves(jax_run["ckpt"][1])
    worst = {"port f32": 0.0, "jax f32": 0.0}
    for i in list(range(n_p)) + list(range(n_p + n_s, n_p + n_s + n_p)):
        j = i % (n_p + n_s) if i >= n_p else i  # the param's index
        trace = f64[n_p + n_s + j]
        scale = max(float(np.abs(trace).max()), 1e-3) * (LR if i < n_p else 1.0)
        worst["port f32"] = max(worst["port f32"], float(np.abs(f32[i] - f64[i]).max()) / scale)
        worst["jax f32"] = max(worst["jax f32"], float(np.abs(jax1[i] - f64[i]).max()) / scale)
    print(f"f32 against the port's f64 step, worst / largest gradient value: {worst}")
    assert worst["port f32"] <= 3e-2 and worst["jax f32"] <= TRACE_TOL, worst


def test_fit_resumed_from_one_jax_checkpoint(jax_run, tmp_path, monkeypatch, cached_opt):
    """`fit` in both packages resumed from the step-2 JAX checkpoint (meta
    epoch 1), 3 epochs of 2 steps, with JAX's dropout draws: history to
    tolerance, the same best epoch, new_ckpt.npz and train.jpg."""
    images, labels = jax_run["images"], jax_run["labels"]
    cfg_kw = dict(num_classes=NC, batch_size=B, num_epochs=3, lr=LR)

    def train_data(epoch):
        for i in range(2):
            sl = slice((epoch + i) % 4 * B, ((epoch + i) % 4 + 1) * B)
            yield images[sl], labels[sl]

    eval_data = [(images[:B], labels[:B]), (images[B:2 * B], labels[B:2 * B])]
    monkeypatch.setattr(J, "make_optimizer", lambda cfg, spe: cached_opt)
    jdir = tmp_path / "jax"
    jout = J.fit(train_data, eval_data, J.ReidTrainConfig(**cfg_kw), steps_per_epoch=SPE, checkpoint_dir=str(jdir),
                 resume=jax_run["ckpt"][2], seed=7)
    key, masks = jax.random.PRNGKey(7), []
    for _ in range(4):
        key, sk = jax.random.split(key)
        masks.append(_mask(sk))
    _shared_masks(monkeypatch, masks)
    pdir = tmp_path / "port"
    pout = P.fit(train_data, eval_data, P.ReidTrainConfig(**cfg_kw), steps_per_epoch=SPE, checkpoint_dir=str(pdir),
                 resume=jax_run["ckpt"][2], seed=7, device="cpu")
    assert pout["start_epoch"] == 1
    for k in ("loss", "acc", "val_acc"):
        np.testing.assert_allclose(pout["history"][k], jout["history"][k], rtol=CURVE_RTOL, atol=1e-6, err_msg=k)
    assert pout["best_acc"] == pytest.approx(jout["best_acc"])
    jm, pm = np.load(jdir / "new_ckpt.npz")["__meta__"], np.load(pdir / "new_ckpt.npz")["__meta__"]
    assert jm[0] == pm[0]  # the same best epoch
    for d in (jdir, pdir):
        assert (d / "train.jpg").stat().st_size > 1000


def test_save_train_curves_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed the same two panels are drawn with cv2."""
    monkeypatch.setattr(P, "_has_matplotlib", lambda: False)
    path = str(tmp_path / "train.jpg")
    hist = {"loss": [2.0, 1.5, 1.1], "acc": [0.2, 0.5, 0.7], "val_acc": [0.1, 0.4, 0.6]}
    assert P.save_train_curves(hist, path) == "cv2"
    img = cv2.imread(path)
    assert img.shape == (400, 900, 3) and os.path.getsize(path) > 1000
    assert (img != 255).any(axis=2)[:, 450:].sum() > (img != 255).any(axis=2)[:, :450].sum()  # two series right


def test_reid_cli_tiny_image_folder(tmp_path, monkeypatch):
    rng = np.random.default_rng(1702)
    for split, n in (("train", 6), ("test", 4)):
        for cls in ("0001", "0002"):
            d = tmp_path / "data" / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                cv2.imwrite(str(d / f"{i}.jpg"), rng.integers(0, 255, size=(64, 32, 3), dtype=np.uint8))
    ck = tmp_path / "ckpt"
    out = reid_cli.main(["--data_dir", str(tmp_path / "data"), "--epochs", "1", "--batch", "4", "--device", "cpu",
                         "--checkpoint_dir", str(ck)])
    assert len(out["history"]["loss"]) == 1
    assert (ck / "new_ckpt.npz").exists() and (ck / "train.jpg").stat().st_size > 1000
    # the card is the default: without one, and without --device cpu, it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reid_cli.main(["--data_dir", str(tmp_path / "data"), "--epochs", "1"])
