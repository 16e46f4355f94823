"""PyTorch port, the ReID trainer's ImageFolder dataset (`train/data.py`, the
port's own copy) against the JAX package's: the same files, classes,
normalised images and shuffled batches, bitwise, for the same seed."""

import cv2
import numpy as np
import pytest

from vehicle_counting_tpu.train.data import ImageFolderDataset as JDataset
from vehicle_counting_tpu_torch.train.data import ImageFolderDataset
from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture
def folder(tmp_path, rng):
    for cls in ["0001", "0002", "0003"]:
        d = tmp_path / "train" / cls
        d.mkdir(parents=True)
        for i in range(5):
            cv2.imwrite(str(d / f"{i}.jpg"), rng.integers(0, 255, size=(64, 32, 3), dtype=np.uint8))
    (tmp_path / "train" / "0003" / "notes.txt").write_text("not an image")
    return str(tmp_path / "train")


def test_image_folder_dataset_matches_jax(folder):
    ds, jds = ImageFolderDataset(folder), JDataset(folder)
    assert len(ds) == len(jds) == 15
    assert ds.num_classes == jds.num_classes == 3
    assert ds.classes == jds.classes == ["0001", "0002", "0003"]
    assert ds.samples == jds.samples
    (im, lb), (jim, jlb) = ds.all(), jds.all()
    assert im.shape == (15, 50, 50, 3)
    np.testing.assert_array_equal(im, jim)
    np.testing.assert_array_equal(lb, jlb)
    assert -3.0 < im.min() and im.max() < 3.0


@pytest.mark.parametrize("seed,shuffle", [(0, True), (7, True), (0, False)])
def test_batches_bitwise_equal_to_jax(folder, seed, shuffle):
    got = list(ImageFolderDataset(folder).batches(4, seed=seed, shuffle=shuffle))
    want = list(JDataset(folder).batches(4, seed=seed, shuffle=shuffle))
    assert len(got) == len(want) == 3  # 15 // 4: the partial batch is dropped
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_empty_folder_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError):
        ImageFolderDataset(str(tmp_path / "empty"))
