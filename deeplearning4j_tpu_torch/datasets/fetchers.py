"""Dataset fetchers/iterators — MNIST, EMNIST, CIFAR, Iris, UCI, …

Reference: ``deeplearning4j-core/.../datasets/fetchers/`` +
``iterator/impl/``: ``MnistDataFetcher.java:42``, EMNIST, Cifar, SVHN,
TinyImageNet, LFW, ``IrisDataSetIterator``, UCI synthetic control, with
download-cache-extract base ``CacheableExtractableDataSetFetcher``.

This environment has no egress, so fetchers resolve data in this order:
1. local cache dir (``$DL4J_TPU_DATA_DIR`` or ``~/.deeplearning4j_tpu_torch/data``)
   holding the standard file formats (MNIST idx, CIFAR binary batches);
2. datasets bundled with locally installed libs (sklearn's real Iris);
3. deterministic synthetic data with the same shapes/classes when
   ``allow_synthetic=True`` (the default for tests) — clearly marked.

The port's copy of the JAX package's ``datasets/fetchers.py``, on the
port's ``DataSet`` and ``ListDataSetIterator`` (sklearn is imported only
by Iris).
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, DataSetIterator, ListDataSetIterator


def data_dir() -> Path:
    return Path(os.environ.get("DL4J_TPU_DATA_DIR",
                               os.path.expanduser("~/.deeplearning4j_tpu_torch/data")))


def _read_idx(path: Path) -> np.ndarray:
    """Parse an IDX file (optionally gzipped) — the MNIST/EMNIST format."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def _find(base: Path, names) -> Optional[Path]:
    for n in names:
        p = base / n
        if p.exists():
            return p
        pg = base / (n + ".gz")
        if pg.exists():
            return pg
    return None


def _synthetic_images(n: int, h: int, w: int, c: int, n_classes: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-separable images: class k gets a bright band at a
    class-specific row plus noise. Learnable by convs; NOT real data."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    x = rng.uniform(0, 0.2, size=(n, h, w, c)).astype(np.float32)
    rows = (np.linspace(0, h - 3, n_classes)).astype(int)
    for i in range(n):
        r = rows[labels[i]]
        x[i, r:r + 2, :, :] += 0.8
    return (x * 255).astype(np.float32), labels.astype(np.int64)


class MnistDataFetcher:
    """MNIST (MnistDataFetcher.java:42). Loads idx files from the cache dir
    (``mnist/``) or synthesizes deterministic stand-in digits."""

    NUM_EXAMPLES = 60000
    NUM_EXAMPLES_TEST = 10000

    def __init__(self, train: bool = True, allow_synthetic: bool = True,
                 synthetic_size: Optional[int] = None, seed: int = 123):
        base = data_dir() / "mnist"
        img_names = (["train-images-idx3-ubyte", "train-images.idx3-ubyte"]
                     if train else ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"])
        lbl_names = (["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"]
                     if train else ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"])
        img_p, lbl_p = _find(base, img_names), _find(base, lbl_names)
        if img_p is not None and lbl_p is not None:
            imgs = _read_idx(img_p).astype(np.float32)
            self.labels = _read_idx(lbl_p).astype(np.int64)
            self.images = imgs[..., None]  # NHWC
            self.synthetic = False
        elif allow_synthetic:
            n = synthetic_size or (4096 if train else 1024)
            self.images, self.labels = _synthetic_images(
                n, 28, 28, 1, 10, seed + (0 if train else 1))
            self.synthetic = True
        else:
            raise FileNotFoundError(
                f"MNIST idx files not found under {base}; place the standard "
                "files there or pass allow_synthetic=True")

    def dataset(self, normalize: bool = True) -> DataSet:
        x = self.images / 255.0 if normalize else self.images
        y = np.eye(10, dtype=np.float32)[self.labels]
        return DataSet(x.astype(np.float32), y)


class MnistDataSetIterator(ListDataSetIterator):
    """DL4J MnistDataSetIterator(batch, train) equivalent."""

    def __init__(self, batch_size: int, train: bool = True, *, shuffle=True,
                 seed: int = 123, normalize: bool = True,
                 allow_synthetic: bool = True, synthetic_size=None):
        fetcher = MnistDataFetcher(train, allow_synthetic, synthetic_size, seed)
        self.synthetic = fetcher.synthetic
        super().__init__(fetcher.dataset(normalize), batch_size, shuffle, seed)


class EmnistDataSetIterator(ListDataSetIterator):
    """EMNIST (EmnistDataFetcher): same idx format, more classes. Sets:
    letters(26), digits(10), balanced(47), byclass(62), bymerge(47)."""

    SETS = {"letters": 26, "digits": 10, "balanced": 47, "byclass": 62,
            "bymerge": 47, "mnist": 10}

    def __init__(self, dataset: str, batch_size: int, train: bool = True, *,
                 shuffle=True, seed: int = 123, allow_synthetic: bool = True):
        if dataset not in self.SETS:
            raise ValueError(f"unknown EMNIST set {dataset!r}")
        n_classes = self.SETS[dataset]
        base = data_dir() / "emnist"
        split = "train" if train else "test"
        img_p = _find(base, [f"emnist-{dataset}-{split}-images-idx3-ubyte"])
        lbl_p = _find(base, [f"emnist-{dataset}-{split}-labels-idx1-ubyte"])
        if img_p is not None and lbl_p is not None:
            x = _read_idx(img_p).astype(np.float32)[..., None] / 255.0
            lab = _read_idx(lbl_p).astype(np.int64)
            if dataset == "letters":  # the letters set alone is 1-indexed
                lab = lab - 1
            self.synthetic = False
        else:
            x, lab = _synthetic_images(2048 if train else 512, 28, 28, 1,
                                       n_classes, seed)
            x = x / 255.0
            self.synthetic = True
        y = np.eye(n_classes, dtype=np.float32)[lab]
        super().__init__(DataSet(x.astype(np.float32), y), batch_size, shuffle, seed)


class CifarDataSetIterator(ListDataSetIterator):
    """CIFAR-10 (CifarDataSetIterator): binary batches from cache dir or
    synthetic 32x32x3 stand-ins."""

    def __init__(self, batch_size: int, train: bool = True, *, shuffle=True,
                 seed: int = 123, allow_synthetic: bool = True):
        base = data_dir() / "cifar-10-batches-bin"
        files = ([base / f"data_batch_{i}.bin" for i in range(1, 6)]
                 if train else [base / "test_batch.bin"])
        if all(f.exists() for f in files):
            xs, ys = [], []
            for f in files:
                raw = np.frombuffer(f.read_bytes(), np.uint8).reshape(-1, 3073)
                ys.append(raw[:, 0].astype(np.int64))
                xs.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            x = np.concatenate(xs).astype(np.float32) / 255.0
            lab = np.concatenate(ys)
            self.synthetic = False
        else:
            x, lab = _synthetic_images(2048 if train else 512, 32, 32, 3, 10, seed)
            x = x / 255.0
            self.synthetic = True
        y = np.eye(10, dtype=np.float32)[lab]
        super().__init__(DataSet(x.astype(np.float32), y), batch_size, shuffle, seed)


class _CachedNpyIterator(ListDataSetIterator):
    """Shared cache-or-synthetic loader: ``<dir>/<split>_{x,y}.npy`` if
    present, else deterministic synthetic stand-ins (the reference's
    ``CacheableExtractableDataSetFetcher`` downloads instead; this image has
    no egress)."""

    def __init__(self, batch_size: int, *, dir_name: str, split: str,
                 n_synth: int, hw: int, n_classes: int,
                 shuffle=True, seed: int = 123):
        base = data_dir() / dir_name
        xp, yp = base / f"{split}_x.npy", base / f"{split}_y.npy"
        if xp.exists() and yp.exists():
            x = np.load(xp).astype(np.float32) / 255.0
            lab = np.load(yp).astype(np.int64)
            self.synthetic = False
        else:
            x, lab = _synthetic_images(n_synth, hw, hw, 3, n_classes, seed)
            x = x / 255.0
            self.synthetic = True
        y = np.eye(n_classes, dtype=np.float32)[lab]
        super().__init__(DataSet(x.astype(np.float32), y), batch_size, shuffle, seed)


class TinyImageNetDataSetIterator(_CachedNpyIterator):
    """TinyImageNet (TinyImageNetFetcher): 64x64x3, 200 classes."""

    def __init__(self, batch_size: int, train: bool = True, *, shuffle=True,
                 seed: int = 123, n_classes: int = 200):
        super().__init__(batch_size, dir_name="tinyimagenet",
                         split="train" if train else "val",
                         n_synth=1024 if train else 256, hw=64,
                         n_classes=n_classes, shuffle=shuffle, seed=seed)


class LFWDataSetIterator(_CachedNpyIterator):
    """LFW faces (LFWDataSetIterator / LFWDataFetcher): cache-or-synthetic.
    The reference serves 250x250x3 faces over 5749 identities with a
    configurable subset; here image side and label count are parameters and
    the cache layout is ``lfw/{train,test}_{x,y}.npy``."""

    def __init__(self, batch_size: int, train: bool = True, *, shuffle=True,
                 seed: int = 123, n_classes: int = 10, image_size: int = 64):
        super().__init__(batch_size, dir_name="lfw",
                         split="train" if train else "test",
                         n_synth=512 if train else 128, hw=image_size,
                         n_classes=n_classes, shuffle=shuffle, seed=seed)


class SvhnDataSetIterator(_CachedNpyIterator):
    """SVHN (SvhnDataFetcher): 32x32x3 digits, same cache-or-synthetic policy."""

    def __init__(self, batch_size: int, train: bool = True, *, shuffle=True,
                 seed: int = 123):
        super().__init__(batch_size, dir_name="svhn",
                         split="train" if train else "test",
                         n_synth=1024 if train else 256, hw=32,
                         n_classes=10, shuffle=shuffle, seed=seed)


class IrisDataSetIterator(ListDataSetIterator):
    """Iris (IrisDataSetIterator): the real 150-example dataset via sklearn's
    bundled copy (offline), else a deterministic 3-cluster stand-in."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150, *,
                 shuffle=False, seed: int = 123):
        try:
            from sklearn.datasets import load_iris
            d = load_iris()
            x = d.data.astype(np.float32)
            lab = d.target.astype(np.int64)
            self.synthetic = False
        except Exception:  # pragma: no cover - sklearn always present in CI
            rng = np.random.default_rng(seed)
            lab = np.repeat(np.arange(3), 50)
            centers = np.asarray([[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3],
                                  [6.6, 3.0, 5.6, 2.0]], np.float32)
            x = centers[lab] + rng.normal(0, 0.3, (150, 4)).astype(np.float32)
            self.synthetic = True
        x, lab = x[:num_examples], lab[:num_examples]
        y = np.eye(3, dtype=np.float32)[lab]
        super().__init__(DataSet(x, y), batch_size, shuffle, seed)


class UciSequenceDataSetIterator(DataSetIterator):
    """UCI synthetic-control sequences (UciSequenceDataFetcher): 600 series of
    length 60 in 6 classes; generated deterministically per the published
    generator equations (the UCI 'synthetic control' data is itself synthetic)."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 123):
        rng = np.random.default_rng(seed + (0 if train else 7))
        n_per = 100 if train else 20
        t = np.arange(60, dtype=np.float32)
        xs, ys = [], []
        for cls in range(6):
            for _ in range(n_per):
                base = 30 + rng.normal(0, 2, 60).astype(np.float32)
                if cls == 1:    # cyclic
                    base += 15 * np.sin(2 * np.pi * t / rng.uniform(10, 15))
                elif cls == 2:  # increasing trend
                    base += rng.uniform(0.2, 0.5) * t
                elif cls == 3:  # decreasing trend
                    base -= rng.uniform(0.2, 0.5) * t
                elif cls == 4:  # upward shift
                    base += np.where(t > rng.uniform(20, 40), rng.uniform(7.5, 20), 0)
                elif cls == 5:  # downward shift
                    base -= np.where(t > rng.uniform(20, 40), rng.uniform(7.5, 20), 0)
                xs.append(base[:, None])  # [T, 1]
                ys.append(cls)
        x = np.stack(xs).astype(np.float32)  # [N, 60, 1]
        y = np.eye(6, dtype=np.float32)[np.asarray(ys)]
        self._it = ListDataSetIterator(DataSet(x, y), batch_size, shuffle=True,
                                       seed=seed)

    def reset(self):
        self._it.reset()

    def __iter__(self):
        return iter(self._it)
