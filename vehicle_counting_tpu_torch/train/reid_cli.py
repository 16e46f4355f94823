#!/usr/bin/env python
"""ReID classifier training CLI — the reference deep/train.py surface.

    python -m vehicle_counting_tpu_torch.train.reid_cli --data_dir D \
        [--lr 0.1] [--epochs 40] [--batch 64] [--resume ckpt.npz] \
        [--checkpoint_dir checkpoint/] [--no_augment] [--device cuda|cpu]

Port of `vehicle_counting_tpu/train/reid_cli.py`, same flags plus
`--device` (default: the card; it raises without one, `cpu` only when
asked). {data_dir}/train and {data_dir}/test hold class-per-subdirectory
images (train.py:34-53 layout). Trains with SGD 0.1/0.9/5e-4, CE loss,
x0.1 decay every 20 epochs, best-accuracy checkpointing (the JAX
checkpoint layout, so either package resumes the other's) and --resume
(train.py:16-196 recipe); augmentation runs on the device. With
`--device cuda` and more than one card visible, batches split over every
card ("data" axis), with the whole batch's BN statistics and loss.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Train the ReID appearance CNN")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoint")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--seed", type=int, default=1702)
    p.add_argument("--device", type=str, default="cuda", help="torch device ('cuda', 'cuda:1', 'cpu')")
    args = p.parse_args(argv)

    import torch

    from vehicle_counting_tpu_torch.parallel.mesh import make_mesh
    from vehicle_counting_tpu_torch.train import ReidTrainConfig, fit
    from vehicle_counting_tpu_torch.train.augment import augment_batch
    from vehicle_counting_tpu_torch.train.data import ImageFolderDataset
    from vehicle_counting_tpu_torch.utils.device import require_device

    dev = require_device(args.device)
    train_ds = ImageFolderDataset(os.path.join(args.data_dir, "train"))
    test_ds = ImageFolderDataset(os.path.join(args.data_dir, "test"))
    print(f"train: {len(train_ds)} images / {train_ds.num_classes} classes; "
          f"test: {len(test_ds)}")

    cfg = ReidTrainConfig(
        num_classes=train_ds.num_classes,
        lr=args.lr,
        num_epochs=args.epochs,
        batch_size=args.batch,
    )
    steps_per_epoch = max(len(train_ds) // args.batch, 1)

    mesh = None
    if args.device == "cuda" and torch.cuda.device_count() > 1:
        mesh = make_mesh(None, ("data",))
        dev = mesh.devices[0]
        print(f"data-parallel over {mesh.size} devices")
    aug_gen = torch.Generator(device=dev).manual_seed(args.seed)

    def train_data(epoch):
        for images, labels in train_ds.batches(args.batch, seed=args.seed + epoch):
            images = torch.from_numpy(images).to(dev)
            if not args.no_augment:
                images = augment_batch(aug_gen, images)
            yield images, labels

    eval_data = list(test_ds.batches(args.batch, shuffle=False))
    out = fit(
        train_data, eval_data, cfg, steps_per_epoch=steps_per_epoch,
        checkpoint_dir=args.checkpoint_dir, resume=args.resume,
        seed=args.seed, mesh=mesh, device=dev,
    )
    print(f"best val acc: {out['best_acc']:.4f}; "
          f"history: {[round(a, 3) for a in out['history']['val_acc']]}")
    return out


if __name__ == "__main__":
    main()
