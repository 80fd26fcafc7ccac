"""LEAF-format federated datasets (MNIST, Shakespeare, synthetic).

Port of ``fedml_tpu/data/leaf.py``.  The LEAF layout: ``train/`` and
``test/`` directories of ``.json`` files, each with ``users``,
``user_data`` (``{user: {"x": [...], "y": [...]}}``) and optionally
``hierarchies`` / ``num_samples``.  Each client's train samples are
shuffled once with seed 100, as the reference's MNIST loader does; all
clients are stacked into padded ``[C, S, B, ...]`` host arrays once, and
a round gathers its cohort from them.  A user missing from a split is a
client with no samples there."""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fedml_tpu_torch.data.stacking import (FederatedData, batch_global,
                                           stack_client_data)
from fedml_tpu_torch.data.text import CharVocab, SHAKESPEARE_SEQ_LEN

MNIST_SHUFFLE_SEED = 100  # MNIST/data_loader.py:58


def read_leaf_dirs(train_dir: str, test_dir: str
                   ) -> Tuple[List[str], List[str], Dict, Dict]:
    """Parse LEAF train/test json directories -> (users, groups, train, test)
    (MNIST/data_loader.py:8-47). Users are sorted for determinism."""
    def read_dir(d):
        users, groups, data = [], [], {}
        for f in sorted(os.listdir(d)):
            if not f.endswith(".json"):
                continue
            with open(os.path.join(d, f)) as inf:
                cdata = json.load(inf)
            users.extend(cdata["users"])
            groups.extend(cdata.get("hierarchies", []))
            data.update(cdata["user_data"])
        return users, groups, data

    train_users, groups, train_data = read_dir(train_dir)
    _, _, test_data = read_dir(test_dir)
    return sorted(train_users), groups, train_data, test_data


def _stack_leaf(users: Sequence[str], train_data: Dict, test_data: Dict,
                batch_size: int, class_num: int,
                encode: Optional[Callable] = None,
                x_dtype=np.float32, y_dtype=np.int32) -> FederatedData:
    """Common LEAF -> FederatedData path. ``encode`` maps one client's raw
    (x list, y list) to (x array, y array)."""
    def prep(data, u):
        ux, uy = data.get(u, {"x": [], "y": []}), None
        x, y = ux["x"], ux["y"]
        if encode is not None:
            return encode(x, y)
        return (np.asarray(x, dtype=x_dtype), np.asarray(y, dtype=y_dtype))

    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for u in users:
        x, y = prep(train_data, u)
        xs_tr.append(x)
        ys_tr.append(y)
        x, y = prep(test_data, u)
        xs_te.append(x)
        ys_te.append(y)

    train = stack_client_data(xs_tr, ys_tr, batch_size,
                              shuffle_seed=MNIST_SHUFFLE_SEED)
    test = stack_client_data(xs_te, ys_te, batch_size)
    xg_tr = np.concatenate([x for x in xs_tr if len(x)])
    yg_tr = np.concatenate([y for y in ys_tr if len(y)])
    xg_te = np.concatenate([x for x in xs_te if len(x)])
    yg_te = np.concatenate([y for y in ys_te if len(y)])
    return FederatedData(
        client_num=len(users), class_num=class_num, train=train, test=test,
        train_global=batch_global(xg_tr, yg_tr, batch_size),
        test_global=batch_global(xg_te, yg_te, batch_size))


def load_mnist(data_dir: str, batch_size: int = 10) -> FederatedData:
    """LEAF MNIST: 1000 clients, x = flat 784 floats, 10 classes
    (MNIST/data_loader.py:86-138; batch size 10 per benchmark/README.md)."""
    users, _, train_data, test_data = read_leaf_dirs(
        os.path.join(data_dir, "train"), os.path.join(data_dir, "test"))
    return _stack_leaf(users, train_data, test_data, batch_size, class_num=10)


def load_mnist_by_device_id(data_dir: str, device_id: str,
                            batch_size: int = 10) -> FederatedData:
    """Mobile variant: per-device train/test subtree
    (MNIST/data_loader.py:79-84)."""
    return load_mnist(os.path.join(data_dir, device_id), batch_size)


def load_shakespeare_leaf(data_dir: str, batch_size: int = 4) -> FederatedData:
    """LEAF shakespeare: x = 80-char crops, y = next char
    (shakespeare/data_loader.py + language_utils.py). We encode to the shared
    90-symbol vocab and emit full next-char targets (y shifted by one) so the
    same LM loss serves both shakespeare variants."""
    vocab = CharVocab()

    def encode(x_list, y_list):
        xs = np.asarray([[vocab.char_id(c) for c in s] for s in x_list],
                        dtype=np.int32)
        if xs.size == 0:
            xs = np.zeros((0, SHAKESPEARE_SEQ_LEN), np.int32)
        # LEAF y is the single next char; widen to a shifted sequence target
        ys_last = np.asarray([vocab.char_id(s[0] if s else " ")
                              for s in y_list], dtype=np.int32)
        ys = np.concatenate([xs[:, 1:], ys_last[:, None]], axis=1) \
            if len(xs) else np.zeros((0, SHAKESPEARE_SEQ_LEN), np.int32)
        return xs, ys

    users, _, train_data, test_data = read_leaf_dirs(
        os.path.join(data_dir, "train"), os.path.join(data_dir, "test"))
    return _stack_leaf(users, train_data, test_data, batch_size,
                       class_num=vocab.vocab_size, encode=encode)


def load_synthetic_leaf(data_dir: str, batch_size: int = 10,
                        class_num: int = 10) -> FederatedData:
    """LEAF synthetic_(a,b) json produced by generate_synthetic.py
    (data/synthetic_0.5_0.5/generate_synthetic.py:73-…)."""
    users, _, train_data, test_data = read_leaf_dirs(
        os.path.join(data_dir, "train"), os.path.join(data_dir, "test"))
    return _stack_leaf(users, train_data, test_data, batch_size,
                       class_num=class_num)
