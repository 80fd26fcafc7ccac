"""ImageNet (ILSVRC2012) and Google Landmarks (gld23k / gld160k) loaders.

Port of ``fedml_tpu/data/imagenet.py``.  ImageNet is one client per class
folder; Landmarks a CSV-mapped split ``user_id,image_id,class``.  Both
build per-client index tables and a decode function, and
`materialize_clients` stages a subset of clients into the stacked
layout: RGB images resized to 224x224 in [0, 1] (PIL, imported when an
image is decoded); flip and cutout are left to the device."""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fedml_tpu_torch.data.stacking import (FederatedData, batch_global,
                                           stack_client_data)


def _decode_image(path: str, size: int = 224) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size))
        return np.asarray(im, dtype=np.float32) / 255.0


def index_imagenet_folders(data_dir: str, split: str = "train"
                           ) -> Tuple[Dict[int, List[str]], int]:
    """class folder -> file list; client i = class i (the reference's
    federated ImageNet assigns whole classes to clients)."""
    root = os.path.join(data_dir, split)
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    table = {i: [os.path.join(root, c, f)
                 for f in sorted(os.listdir(os.path.join(root, c)))]
             for i, c in enumerate(classes)}
    return table, len(classes)


def read_landmarks_mapping(csv_path: str
                           ) -> Dict[str, List[Tuple[str, int]]]:
    """user_id -> [(image_id, class), ...] (Landmarks/data_loader.py:120-153;
    columns user_id,image_id,class are required there too)."""
    out: Dict[str, List[Tuple[str, int]]] = defaultdict(list)
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            out[row["user_id"]].append((row["image_id"], int(row["class"])))
    return dict(out)


def landmarks_image_path(data_dir: str, image_id: str) -> str:
    """GLD images live at <data_dir>/images/<first 3 chars as dirs>/<id>.jpg
    (the standard GLDv2 layout)."""
    return os.path.join(data_dir, "images", image_id[0], image_id[1],
                        image_id[2], image_id + ".jpg")


def materialize_clients(index: Dict, decode: Callable[[object], Tuple],
                        client_ids: Sequence, batch_size: int,
                        class_num: int,
                        test_index: Optional[Dict] = None,
                        image_size: int = 224) -> FederatedData:
    """Stage a subset of clients into stacked arrays.  ``decode`` maps one
    index entry to (x, y)."""
    empty_shape = (0, image_size, image_size, 3)

    def stage(table, cids):
        xs, ys = [], []
        for cid in cids:
            pairs = [decode(e) for e in table.get(cid, [])]
            xs.append(np.stack([p[0] for p in pairs]) if pairs
                      else np.zeros(empty_shape, np.float32))
            ys.append(np.asarray([p[1] for p in pairs], np.int32))
        return xs, ys

    xs_tr, ys_tr = stage(index, client_ids)
    train = stack_client_data(xs_tr, ys_tr, batch_size)
    test = None
    test_global = None
    if test_index is not None:
        te_ids = list(test_index)
        xs_te, ys_te = stage(test_index, te_ids)
        test = stack_client_data(xs_te, ys_te, batch_size)
        test_global = batch_global(np.concatenate(xs_te),
                                   np.concatenate(ys_te), batch_size)
    return FederatedData(
        client_num=len(client_ids), class_num=class_num, train=train,
        test=test,
        train_global=batch_global(np.concatenate(xs_tr),
                                  np.concatenate(ys_tr), batch_size),
        test_global=test_global)


def load_landmarks(data_dir: str, mapping_csv: str, batch_size: int = 20,
                   max_clients: Optional[int] = None,
                   image_size: int = 224) -> FederatedData:
    """gld23k (233 clients / 203 classes) or gld160k (1262 / 2028), chosen by
    which mapping csv is passed (Landmarks/data_loader.py docstring).
    A relative ``mapping_csv`` resolves against ``data_dir``."""
    if not os.path.isabs(mapping_csv):
        mapping_csv = os.path.join(data_dir, mapping_csv)
    mapping = read_landmarks_mapping(mapping_csv)
    cids = sorted(mapping)[:max_clients]
    class_num = 1 + max(c for entries in mapping.values()
                        for _, c in entries)
    decode = lambda e: (_decode_image(landmarks_image_path(data_dir, e[0]),
                                      image_size), e[1])
    return materialize_clients(mapping, decode, cids, batch_size, class_num,
                               image_size=image_size)


def load_imagenet(data_dir: str, batch_size: int = 32,
                  max_clients: Optional[int] = None,
                  image_size: int = 224) -> FederatedData:
    train_idx, class_num = index_imagenet_folders(data_dir, "train")
    cids = list(train_idx)[:max_clients]
    # entry = (path, class); rebuild table with labels attached
    table = {c: [(p, c) for p in train_idx[c]] for c in cids}
    decode = lambda e: (_decode_image(e[0], image_size), e[1])
    return materialize_clients(table, decode, cids, batch_size, class_num,
                               image_size=image_size)
