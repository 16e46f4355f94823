"""ReID classifier training in PyTorch, the port of `vehicle_counting_tpu/train/reid_train.py`.

Reference training recipe (networks/deepsort/deep/train.py): SGD lr 0.1,
momentum 0.9, weight decay 5e-4, cross-entropy loss, 40 epochs with x0.1
decay every 20 (train.py:16-23,71-72,179-196), best-accuracy checkpointing
(train.py:144-156), resume support (train.py:59-67). Crops train at 50x50,
the size the inference extractor uses.

The JAX package's names and contracts, in PyTorch:
  * `make_optimizer` is `torch.optim.SGD(lr, momentum=0.9, dampening=0,
    nesterov=False, weight_decay=5e-4)` with optax's per-step staircase
    `lr * 0.1 ** (step // (lr_decay_every * steps_per_epoch))` set before
    each step: the same update as optax's `chain(add_decayed_weights,
    sgd(exponential_decay(staircase=True), momentum))` (optax's trace
    starts at zero, torch's buffer at the first gradient: the first
    update is the same);
  * the train state is (params, stats, opt, opt_state): params are leaf
    tensors updated in place by `train_step`, opt_state holds the SGD
    object and the schedule's step count;
  * data parallelism over a `parallel/mesh.py::DeviceMesh` ("data" axis):
    the batch splits into one shard per device, each shard's forward runs
    on its device with weights copied there, the BN statistics and the
    loss are the whole batch's (`models/reid.py::reid_apply`), so the
    result is the single-device step's, as XLA's global means make it in
    JAX; params live on the first device and autograd takes the
    gradients back through the copies;
  * checkpoints are the JAX `.npz` layout: `leaf_i` in `jax.tree.flatten`
    order of (params, stats, opt_state) (dict keys sorted; the optimizer's
    leaves are the momentum trace tree, then the step count, int32) with
    conv weights and their traces stored HWIO, and `__meta__` = [epoch,
    acc]; a checkpoint from either package resumes in the other.
The trainer computes in f32 and means it: TF32 is switched off on the card.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vehicle_counting_tpu_torch.models.reid import init_reid, reid_apply
from vehicle_counting_tpu_torch.utils.device import on_device, require_device


@dataclass(frozen=True)
class ReidTrainConfig:
    num_classes: int = 751
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    num_epochs: int = 40
    lr_decay_every: int = 20  # x0.1 (train.py:179-184)
    batch_size: int = 64
    crop_hw: Tuple[int, int] = (50, 50)


def _flatten(tree) -> List[torch.Tensor]:
    """Leaves in `jax.tree.flatten` order: dict keys sorted, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _f32_exact(device: torch.device) -> None:
    """The trainer is f32: no TF32 in cuDNN's convs or in matmuls."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


class ReidOptimizer:
    """SGD with momentum and weight decay on optax's staircase schedule;
    `init(params)` binds it to a parameter tree."""

    def __init__(self, cfg: ReidTrainConfig, steps_per_epoch: int = 1000):
        self.cfg = cfg
        self.transition_steps = cfg.lr_decay_every * steps_per_epoch

    def lr_at(self, count: int) -> float:
        """optax's `exponential_decay(lr, transition_steps, 0.1,
        staircase=True)` at step `count`, in f32 as optax computes it."""
        p = np.float32(count // self.transition_steps)
        return float(np.float32(self.cfg.lr) * np.float32(0.1) ** p)

    def init(self, params) -> "OptState":
        sgd = torch.optim.SGD(_flatten(params), lr=self.cfg.lr, momentum=self.cfg.momentum, dampening=0,
                              nesterov=False, weight_decay=self.cfg.weight_decay)
        return OptState(sgd, 0)


@dataclass
class OptState:
    """The optimizer's state: the bound SGD (its momentum buffers are the
    trace) and the schedule's step count."""

    sgd: torch.optim.SGD
    count: int

    def trace(self) -> List[torch.Tensor]:
        """The momentum trace per parameter, in flatten order (zeros before
        the first step, as optax's)."""
        out = []
        for p in self.sgd.param_groups[0]["params"]:
            buf = self.sgd.state.get(p, {}).get("momentum_buffer")
            out.append(torch.zeros_like(p) if buf is None else buf)
        return out


def make_optimizer(cfg: ReidTrainConfig, steps_per_epoch: int = 1000) -> ReidOptimizer:
    return ReidOptimizer(cfg, steps_per_epoch)


def create_train_state(gen: torch.Generator, cfg: ReidTrainConfig, steps_per_epoch: int = 1000, device=None):
    """(params, stats, opt, opt_state): `init_reid` drawn from `gen`, params
    made leaf tensors that require grad, on `device` (default: the card)."""
    dev = require_device(device)
    _f32_exact(dev)
    params, stats = init_reid(gen, num_classes=cfg.num_classes, device=dev)
    for p in _flatten(params):
        p.requires_grad_(True)
    opt = make_optimizer(cfg, steps_per_epoch)
    return params, stats, opt, opt.init(params)


def _exact_convs(device: torch.device):
    """On the CPU, the native convolutions instead of oneDNN's: on one ReID
    step at B=4, oneDNN's f32 conv backward put the gradients up to 5.8e-3
    of a leaf's largest value off an f64 run of the same step, the native
    ones 1.7e-5 (tests/test_torch_train.py holds the f32 step to its f64)."""
    return torch.backends.mkldnn.flags(enabled=False) if device.type == "cpu" else contextlib.nullcontext()


def cast_train_state(params, stats, opt: "ReidOptimizer", dtype):
    """The state in another float dtype (f64 for a reference run: the step
    computes in the params' dtype): params cast in place, stats rebuilt, a
    fresh optimizer state. Returns (params, stats, opt_state)."""
    for t in _flatten(params):
        t.data = t.data.to(dtype)

    def cast(tree):
        return {k: cast(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dtype)

    return params, cast(stats), opt.init(params)


def _device_of(params) -> torch.device:
    return _flatten(params)[0].device


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def _shards(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    if mesh is None or mesh.size == 1:
        return [x.to(mesh.devices[0]) if mesh is not None else x]
    if x.shape[0] % mesh.size:
        raise ValueError(f"batch size {x.shape[0]} must be a multiple of the mesh's {mesh.size} devices")
    return [s.to(d) for s, d in zip(x.chunk(mesh.size), mesh.devices)]


def _loss_and_acc(logits: List[torch.Tensor], labels: List[torch.Tensor], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy and top-1 accuracy of the whole batch: the sum of
    the shards' sums, over the batch size."""
    n = sum(lb.shape[0] for lb in labels)
    loss = sum(F.cross_entropy(lg, lb, reduction="sum").to(device) for lg, lb in zip(logits, labels))
    hits = sum((lg.argmax(-1) == lb).sum().to(device) for lg, lb in zip(logits, labels))
    return loss / torch.full((), float(n), dtype=loss.dtype, device=device), hits.to(torch.float32) / n


def train_step(params, stats, opt_state: OptState, images, labels, gen: Optional[torch.Generator] = None, *,
               opt: ReidOptimizer, mesh=None):
    """One SGD step. images [B, H, W, 3] normalized (cast to the params'
    dtype: f32, or f64 for a reference run), labels [B] int.
    `gen` draws the dropout mask (None: no dropout). With `mesh`, the batch
    splits over its devices (params on its first device). Returns (params,
    new_stats, opt_state, {"loss", "acc"}); params and opt_state are the
    ones passed in, updated in place."""
    dev, dtype = _device_of(params), _flatten(params)[0].dtype
    with on_device(dev), _exact_convs(dev):
        xs = _shards(_as_tensor(images, dev, dtype), mesh)
        ys = _shards(_as_tensor(labels, dev, torch.int64), mesh)
        opt_state.sgd.zero_grad(set_to_none=True)
        with torch.enable_grad():
            logits, new_stats = reid_apply(params, stats, xs, train=True, reid=False, dropout=gen)
            loss, acc = _loss_and_acc(logits, ys, dev)
        loss.backward()
        for group in opt_state.sgd.param_groups:
            group["lr"] = opt.lr_at(opt_state.count)
        opt_state.sgd.step()
        opt_state.count += 1
    return params, new_stats, opt_state, {"loss": loss.detach(), "acc": acc}


@torch.no_grad()
def eval_step(params, stats, images, labels) -> Dict[str, torch.Tensor]:
    dev = _device_of(params)
    with on_device(dev):
        logits, _ = reid_apply(params, stats, _as_tensor(images, dev, torch.float32), train=False, reid=False)
        loss, acc = _loss_and_acc([logits], [_as_tensor(labels, dev, torch.int64)], dev)
    return {"loss": loss, "acc": acc}


@torch.no_grad()
def extract_features(params, stats, images) -> torch.Tensor:
    """Batch embeddings for retrieval eval (deep/test.py:55-66 role)."""
    dev = _device_of(params)
    with on_device(dev):
        emb, _ = reid_apply(params, stats, _as_tensor(images, dev, torch.float32), train=False, reid=True)
    return emb


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def top1_retrieval_accuracy(query_f, query_l, gallery_f, gallery_l) -> float:
    """deep/evaluate.py:9-13: dot-product ranking, top-1 match."""
    scores = _np(query_f) @ _np(gallery_f).T
    idx = scores.argmax(axis=1)
    return float((_np(gallery_l)[idx] == _np(query_l)).mean())


# ---------------------------------------------------------------------------
# checkpoints: the JAX package's .npz layout
# ---------------------------------------------------------------------------

def _to_file(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0))) if a.ndim == 4 else a  # OIHW -> HWIO


def _from_file(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dim() == 4:
        a = np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=like.device, dtype=like.dtype)


def checkpoint_leaves(params, stats, opt_state: OptState) -> List[np.ndarray]:
    """The state as the JAX checkpoint stores it: (params, stats, opt_state)
    flattened, conv weights and their traces HWIO, the count int32."""
    trees = _flatten(params) + _flatten(stats) + opt_state.trace()
    return [_to_file(t) for t in trees] + [np.asarray(opt_state.count, np.int32)]


def save_checkpoint(path: str, params, stats, opt_state: OptState, epoch: int, acc: float):
    np.savez(path, __meta__=np.array([epoch, acc]),
             **{f"leaf_{i}": a for i, a in enumerate(checkpoint_leaves(params, stats, opt_state))})


def load_checkpoint(path: str, params, stats, opt_state: OptState):
    """Restore a checkpoint of this layout (written by either package) into
    the state's structure: params copied in place (the optimizer stays
    bound to them), stats rebuilt, the momentum buffers and the count set.
    Returns (params, stats, opt_state, epoch, acc)."""
    data = np.load(path)
    p_leaves, s_leaves = _flatten(params), _flatten(stats)
    n_p, n_s = len(p_leaves), len(s_leaves)
    n = n_p + n_s + n_p + 1
    present = sum(1 for k in data.files if k.startswith("leaf_"))
    if present != n:
        raise ValueError(f"{path} holds {present} leaves; this state has {n}")
    leaf = [data[f"leaf_{i}"] for i in range(n)]
    with torch.no_grad():
        for t, a in zip(p_leaves, leaf[:n_p]):
            t.copy_(_from_file(a, t))
    it = iter(leaf[n_p:n_p + n_s])

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return _from_file(next(it), tree)

    stats = rebuild(stats)
    for t, a in zip(p_leaves, leaf[n_p + n_s:n_p + n_s + n_p]):
        opt_state.sgd.state[t]["momentum_buffer"] = _from_file(a, t)
    opt_state.count = int(leaf[-1])
    epoch, acc = data["__meta__"]
    return params, stats, opt_state, int(epoch), float(acc)


# ---------------------------------------------------------------------------
# host loop
# ---------------------------------------------------------------------------

def _has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def save_train_curves(history: Dict, path: str) -> str:
    """Loss / top-1 error curves to a JPG (reference train.py:161-176:
    draw_curve plots per-epoch train/test loss and error to train.jpg):
    with matplotlib where it is installed, else the same two panels drawn
    with cv2. Returns which of the two drew it."""
    epochs = list(range(len(history["loss"])))
    err = [1.0 - a for a in history["acc"]]
    val_err = [1.0 - a for a in history["val_acc"]]
    if _has_matplotlib():
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(9, 4))
        ax0.plot(epochs, history["loss"], "bo-", label="train")
        ax0.set_title("loss")
        ax0.legend()
        ax1.plot(epochs, err, "bo-", label="train")
        ax1.plot(epochs, val_err, "ro-", label="val")
        ax1.set_title("top1err")
        ax1.legend()
        fig.savefig(path)
        plt.close(fig)
        return "matplotlib"
    _curves_cv2(path, epochs, [("loss", [(history["loss"], (255, 0, 0), "train")]),
                               ("top1err", [(err, (255, 0, 0), "train"), (val_err, (0, 0, 255), "val")])])
    return "cv2"


def _curves_cv2(path: str, epochs, panels, w: int = 450, h: int = 400) -> None:
    """Side-by-side line plots (title, [(values, BGR colour, label)]) on a
    white 900x400 canvas, as `save_train_curves` lays them out."""
    import cv2

    img = np.full((h, w * len(panels), 3), 255, np.uint8)
    for pi, (title, series) in enumerate(panels):
        x0, y0, x1, y1 = pi * w + 50, 40, pi * w + w - 20, h - 40
        cv2.rectangle(img, (x0, y0), (x1, y1), (0, 0, 0), 1)
        cv2.putText(img, title, (x0 + (x1 - x0) // 2 - 30, 28), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 0, 0), 1)
        vals = [v for s, _, _ in series for v in s] or [0.0]
        lo, hi = min(vals), max(vals)
        span, n = (hi - lo) or 1.0, max(len(epochs) - 1, 1)
        for si, (ys, colour, label) in enumerate(series):
            pts = [(int(x0 + (x1 - x0) * i / n), int(y1 - (y1 - y0) * (v - lo) / span)) for i, v in enumerate(ys)]
            for a, b in zip(pts, pts[1:]):
                cv2.line(img, a, b, colour, 2)
            for p in pts:
                cv2.circle(img, p, 4, colour, -1)
            cv2.putText(img, label, (x1 - 70, y0 + 20 + 20 * si), cv2.FONT_HERSHEY_SIMPLEX, 0.5, colour, 1)
        for v, y in ((hi, y0), (lo, y1)):
            cv2.putText(img, f"{v:.3g}", (pi * w + 2, y + 5), cv2.FONT_HERSHEY_SIMPLEX, 0.4, (0, 0, 0), 1)
    cv2.imwrite(path, img)


def fit(
    train_data,
    eval_data,
    cfg: ReidTrainConfig,
    *,
    steps_per_epoch: int,
    checkpoint_dir: Optional[str] = None,
    resume: Optional[str] = None,
    seed: int = 0,
    mesh=None,
    device=None,
) -> Dict[str, Any]:
    """Best-acc-checkpointing train loop (train.py:186-196 semantics).

    train_data: callable(epoch) -> iterator of (images, labels) batches
    (numpy or tensors). eval_data: list of (images, labels) batches.
    mesh: optional `DeviceMesh` ("data" axis) for data parallelism over
    several cards; the state lives on its first device. device: where to
    train without a mesh (default: the card). The init draws from a CPU
    generator seeded with `seed`, the dropout from one on the device.
    As in the JAX trainer, a resumed run starts again at the checkpoint's
    epoch.
    """
    dev = mesh.devices[0] if mesh is not None else require_device(device)
    params, stats, opt, opt_state = create_train_state(torch.Generator().manual_seed(seed), cfg, steps_per_epoch,
                                                       dev)
    start_epoch, best_acc = 0, 0.0
    if resume and os.path.exists(resume):
        params, stats, opt_state, start_epoch, best_acc = load_checkpoint(resume, params, stats, opt_state)
        print(f"[fit] resumed from {resume} at epoch {start_epoch} (best acc {best_acc:.4f}, step {opt_state.count})")
    gen = torch.Generator(device=dev).manual_seed(seed)

    history: Dict[str, List[float]] = {"loss": [], "acc": [], "val_acc": []}
    for epoch in range(start_epoch, cfg.num_epochs):
        losses, accs = [], []
        for images, labels in train_data(epoch):
            params, stats, opt_state, m = train_step(params, stats, opt_state, images, labels, gen, opt=opt,
                                                     mesh=mesh)
            losses.append(float(m["loss"]))
            accs.append(float(m["acc"]))
        val_accs = [float(eval_step(params, stats, x, y)["acc"]) for x, y in eval_data]
        val_acc = float(np.mean(val_accs)) if val_accs else 0.0
        history["loss"].append(float(np.mean(losses)) if losses else 0.0)
        history["acc"].append(float(np.mean(accs)) if accs else 0.0)
        history["val_acc"].append(val_acc)
        if checkpoint_dir and val_acc >= best_acc:
            best_acc = val_acc
            os.makedirs(checkpoint_dir, exist_ok=True)
            save_checkpoint(os.path.join(checkpoint_dir, "new_ckpt.npz"), params, stats, opt_state, epoch, best_acc)
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            save_train_curves(history, os.path.join(checkpoint_dir, "train.jpg"))
    return {"params": params, "stats": stats, "history": history, "best_acc": best_acc, "start_epoch": start_epoch}
