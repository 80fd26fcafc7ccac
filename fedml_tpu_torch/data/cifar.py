"""CIFAR-10 / CIFAR-100 / CINIC-10, loaded whole and then partitioned.

Port of ``fedml_tpu/data/cifar.py``.  The archives are read directly:
the CIFAR pickle batches, and CINIC-10's ImageFolder PNGs through PIL
(imported when such a tree is read).  The ``homo`` / ``hetero`` switch
partitions through `fedml_tpu_torch.core.partition`.  Images are float32
[0, 1] HWC; crop, flip, normalize and cutout run on the device
(`fedml_tpu_torch.data.augment`)."""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from fedml_tpu_torch.core.partition import (partition_dirichlet_hetero,
                                            partition_homo,
                                            record_data_stats)
from fedml_tpu_torch.data.stacking import (FederatedData, batch_global,
                                           stack_client_data)


def _load_cifar10_arrays(data_dir: str) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray, np.ndarray]:
    """cifar-10-batches-py pickle layout: 5 train batches + test_batch, each
    {data: [n, 3072] uint8 CHW-flat, labels: [n]}."""
    root = os.path.join(data_dir, "cifar-10-batches-py")
    xs, ys = [], []
    for b in range(1, 6):
        with open(os.path.join(root, f"data_batch_{b}"), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        xs.append(d["data"])
        ys.extend(d["labels"])
    x_train = np.concatenate(xs)
    y_train = np.asarray(ys)
    with open(os.path.join(root, "test_batch"), "rb") as f:
        d = pickle.load(f, encoding="latin1")
    return x_train, y_train, np.asarray(d["data"]), np.asarray(d["labels"])


def _load_cifar100_arrays(data_dir: str):
    """cifar-100-python layout: train/test pickles with fine_labels."""
    root = os.path.join(data_dir, "cifar-100-python")
    out = []
    for split in ("train", "test"):
        with open(os.path.join(root, split), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        out.extend([np.asarray(d["data"]), np.asarray(d["fine_labels"])])
    return tuple(out)


def _to_hwc01(flat: np.ndarray) -> np.ndarray:
    return (flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            .astype(np.float32) / 255.0)


def _load_cinic10_arrays(data_dir: str):
    """CINIC10 ImageFolder: {train,test}/<class>/*.png.  Loaded via PIL."""
    from PIL import Image
    classes = None
    out = []
    for split in ("train", "test"):
        root = os.path.join(data_dir, split)
        if classes is None:
            classes = sorted(d for d in os.listdir(root)
                             if os.path.isdir(os.path.join(root, d)))
        xs, ys = [], []
        for yi, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for fn in sorted(os.listdir(cdir)):
                with Image.open(os.path.join(cdir, fn)) as im:
                    xs.append(np.asarray(im.convert("RGB"), dtype=np.uint8))
                ys.append(yi)
        out.extend([np.stack(xs).astype(np.float32) / 255.0,
                    np.asarray(ys)])
    return tuple(out)


_LOADERS = {"cifar10": (_load_cifar10_arrays, 10, True),
            "cifar100": (_load_cifar100_arrays, 100, True),
            "cinic10": (_load_cinic10_arrays, 10, False)}


def load_cifar_partitioned(dataset: str, data_dir: str, client_num: int,
                           partition_method: str = "hetero",
                           partition_alpha: float = 0.5,
                           batch_size: int = 64,
                           seed: Optional[int] = None,
                           arrays: Optional[Tuple] = None) -> FederatedData:
    """The partition_data switch (cifar10/data_loader.py:113-161):
    ``homo`` = shuffled even split, ``hetero`` = per-class Dirichlet with the
    min-size-10 retry loop.  Test data stays global (the reference's
    get_dataloader_test serves each client the full test set unless given
    explicit test indices — local test dicts here are even homo shards so
    per-client eval exists without duplicating the test set C times).

    ``arrays`` lets callers inject (x_tr, y_tr, x_te, y_te) directly — the
    hermetic-test path and the hook for pre-staged data.
    """
    if arrays is None:
        loader, class_num, flat = _LOADERS[dataset]
        x_tr, y_tr, x_te, y_te = loader(data_dir)
        if flat:
            x_tr, x_te = _to_hwc01(x_tr), _to_hwc01(x_te)
    else:
        x_tr, y_tr, x_te, y_te = arrays
        class_num = int(np.max(y_tr)) + 1

    if partition_method == "homo":
        idx_map = partition_homo(len(y_tr), client_num, seed=seed)
    elif partition_method == "hetero":
        idx_map = partition_dirichlet_hetero(
            y_tr, client_num, class_num, partition_alpha, seed=seed)
    else:
        raise ValueError(f"unknown partition method {partition_method!r}")
    record_data_stats(y_tr, idx_map)

    xs = [x_tr[idx_map[c]] for c in range(client_num)]
    ys = [y_tr[idx_map[c]] for c in range(client_num)]
    te_map = partition_homo(len(y_te), client_num, seed=seed)
    train = stack_client_data(xs, ys, batch_size)
    test = stack_client_data([x_te[te_map[c]] for c in range(client_num)],
                             [y_te[te_map[c]] for c in range(client_num)],
                             batch_size)
    return FederatedData(
        client_num=client_num, class_num=class_num, train=train, test=test,
        train_global=batch_global(x_tr, y_tr, batch_size),
        test_global=batch_global(x_te, y_te, batch_size))
