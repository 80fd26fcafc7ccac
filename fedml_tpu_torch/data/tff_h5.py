"""TFF-exported HDF5 federated datasets.

Port of ``fedml_tpu/data/tff_h5.py``.  Every file uses the group layout
``examples/<client_id>/<field>``:

* FederatedEMNIST — ``pixels`` [n, 28, 28] float, ``label`` int;
* fed_cifar100 — ``image`` [n, 32, 32, 3] uint8, ``label``; kept at
  32x32 in [0, 1] here, the 24x24 crops run on the device
  (`augment.fed_cifar100_train_augment`, `fed_cifar100_eval_transform`);
* fed_shakespeare — ``snippets`` byte strings, char-encoded to windows of
  80;
* StackOverflow — ``tokens`` / ``title`` / ``tags`` byte strings: next
  word ids at length 20 (nwp), or a 10k bag of words and a 500-tag
  multi-hot (lr).

``max_clients`` bounds how many clients are read (StackOverflow has
342,477).  Each loader has a ``fake_*_h5`` writer of a tiny file in the
same format.  ``h5py`` is imported when a file is read or written, not
with this module."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fedml_tpu_torch.data.stacking import (FederatedData, batch_global,
                                           stack_client_data)
from fedml_tpu_torch.data.text import (SHAKESPEARE_SEQ_LEN, CharVocab,
                                       WordVocab, bag_of_words,
                                       multi_hot_tags, split_next_word)

_EXAMPLES = "examples"

FEMNIST_TRAIN_FILE = "fed_emnist_train.h5"
FEMNIST_TEST_FILE = "fed_emnist_test.h5"
FED_CIFAR100_TRAIN_FILE = "fed_cifar100_train.h5"
FED_CIFAR100_TEST_FILE = "fed_cifar100_test.h5"
FED_SHAKESPEARE_TRAIN_FILE = "shakespeare_train.h5"
FED_SHAKESPEARE_TEST_FILE = "shakespeare_test.h5"
STACKOVERFLOW_TRAIN_FILE = "stackoverflow_train.h5"
STACKOVERFLOW_TEST_FILE = "stackoverflow_test.h5"


def _h5():
    import h5py
    return h5py


def _client_ids(h5file, max_clients: Optional[int]) -> List[str]:
    ids = list(h5file[_EXAMPLES].keys())
    return ids[:max_clients] if max_clients else ids


def _per_client_arrays(path: str, fields: Sequence[str],
                       max_clients: Optional[int]) -> List[Dict[str, np.ndarray]]:
    with _h5().File(path, "r") as f:
        out = []
        for cid in _client_ids(f, max_clients):
            g = f[_EXAMPLES][cid]
            out.append({k: np.asarray(g[k][()]) for k in fields})
    return out


def _assemble(xs_tr, ys_tr, xs_te, ys_te, batch_size, class_num
              ) -> FederatedData:
    train = stack_client_data(xs_tr, ys_tr, batch_size)
    test = stack_client_data(xs_te, ys_te, batch_size)
    cat = lambda parts: np.concatenate([p for p in parts if len(p)])
    return FederatedData(
        client_num=len(xs_tr), class_num=class_num, train=train, test=test,
        train_global=batch_global(cat(xs_tr), cat(ys_tr), batch_size),
        test_global=batch_global(cat(xs_te), cat(ys_te), batch_size))


def load_federated_emnist(data_dir: str, batch_size: int = 20,
                          max_clients: Optional[int] = None) -> FederatedData:
    """62-class FEMNIST; pixels already in [0,1] floats (TFF export)."""
    def read(path):
        xs, ys = [], []
        for g in _per_client_arrays(path, ("pixels", "label"), max_clients):
            xs.append(g["pixels"].reshape(-1, 28, 28, 1).astype(np.float32))
            ys.append(g["label"].reshape(-1).astype(np.int32))
        return xs, ys

    xs_tr, ys_tr = read(os.path.join(data_dir, FEMNIST_TRAIN_FILE))
    xs_te, ys_te = read(os.path.join(data_dir, FEMNIST_TEST_FILE))
    return _assemble(xs_tr, ys_tr, xs_te, ys_te, batch_size, class_num=62)


def load_fed_cifar100(data_dir: str, batch_size: int = 20,
                      max_clients: Optional[int] = None) -> FederatedData:
    """100-class fed CIFAR; stored uint8 HWC — we scale to [0,1] float32 and
    leave crop/flip/normalize to the on-device augment pipeline (the
    reference bakes them into the loader, fed_cifar100/utils.py:28-37)."""
    def read(path):
        xs, ys = [], []
        for g in _per_client_arrays(path, ("image", "label"), max_clients):
            xs.append(g["image"].reshape(-1, 32, 32, 3)
                      .astype(np.float32) / 255.0)
            ys.append(g["label"].reshape(-1).astype(np.int32))
        return xs, ys

    xs_tr, ys_tr = read(os.path.join(data_dir, FED_CIFAR100_TRAIN_FILE))
    xs_te, ys_te = read(os.path.join(data_dir, FED_CIFAR100_TEST_FILE))
    return _assemble(xs_tr, ys_tr, xs_te, ys_te, batch_size, class_num=100)


def load_fed_shakespeare(data_dir: str, batch_size: int = 4,
                         max_clients: Optional[int] = None) -> FederatedData:
    """Char LM over 90-symbol vocab; each snippet becomes 81-wide windows
    split into (x, y) by shift-by-one."""
    vocab = CharVocab()

    def read(path):
        xs, ys = [], []
        for g in _per_client_arrays(path, ("snippets",), max_clients):
            wins = []
            for snip in g["snippets"].reshape(-1):
                text = snip.decode("utf8") if isinstance(snip, bytes) else str(snip)
                wins.extend(vocab.encode_snippet(text))
            w = (np.stack(wins) if wins
                 else np.zeros((0, SHAKESPEARE_SEQ_LEN + 1), np.int32))
            d = split_next_word(w)
            xs.append(d["x"])
            ys.append(d["y"])
        return xs, ys

    xs_tr, ys_tr = read(os.path.join(data_dir, FED_SHAKESPEARE_TRAIN_FILE))
    xs_te, ys_te = read(os.path.join(data_dir, FED_SHAKESPEARE_TEST_FILE))
    return _assemble(xs_tr, ys_tr, xs_te, ys_te, batch_size,
                     class_num=vocab.vocab_size)


def load_stackoverflow_nwp(data_dir: str, batch_size: int = 16,
                           max_clients: Optional[int] = 1000,
                           vocab_size: int = 10000,
                           seq_len: int = 20) -> FederatedData:
    """Next-word prediction: each sentence -> 21 ids, split into x/y by
    shift (stackoverflow_nwp/utils.py:56-95).  max_clients defaults to 1000 —
    loading all 342k clients' text eagerly is a deliberate opt-in."""
    vocab = WordVocab.from_word_count_file(
        os.path.join(data_dir, "stackoverflow.word_count"), vocab_size)

    def read(path):
        xs, ys = [], []
        for g in _per_client_arrays(path, ("tokens",), max_clients):
            rows = [vocab.encode_sentence(
                        t.decode("utf8") if isinstance(t, bytes) else str(t),
                        seq_len)
                    for t in g["tokens"].reshape(-1)]
            w = (np.stack(rows) if rows
                 else np.zeros((0, seq_len + 1), np.int32))
            d = split_next_word(w)
            xs.append(d["x"])
            ys.append(d["y"])
        return xs, ys

    xs_tr, ys_tr = read(os.path.join(data_dir, STACKOVERFLOW_TRAIN_FILE))
    xs_te, ys_te = read(os.path.join(data_dir, STACKOVERFLOW_TEST_FILE))
    return _assemble(xs_tr, ys_tr, xs_te, ys_te, batch_size,
                     class_num=vocab.vocab_size)


def load_stackoverflow_lr(data_dir: str, batch_size: int = 10,
                          max_clients: Optional[int] = 1000,
                          vocab_size: int = 10000, tag_size: int = 500
                          ) -> FederatedData:
    """Tag prediction: x = normalized 10k BoW over tokens+title, y = 500-dim
    multi-hot tags (stackoverflow_lr/dataset.py:55-63)."""
    from fedml_tpu_torch.data.text import load_tag_dict
    words = WordVocab.from_word_count_file(
        os.path.join(data_dir, "stackoverflow.word_count"), vocab_size)
    word_dict = {w: i for i, w in enumerate(words._ids)}  # 0-based BoW index
    tag_dict = load_tag_dict(
        os.path.join(data_dir, "stackoverflow.tag_count"), tag_size)

    def read(path):
        xs, ys = [], []
        for g in _per_client_arrays(path, ("tokens", "title", "tags"),
                                    max_clients):
            dec = lambda a: [v.decode("utf8") if isinstance(v, bytes)
                             else str(v) for v in a.reshape(-1)]
            sents = [" ".join(p) for p in zip(dec(g["tokens"]),
                                              dec(g["title"]))]
            xs.append(bag_of_words(sents, word_dict))
            ys.append(multi_hot_tags(dec(g["tags"]), tag_dict))
        return xs, ys

    xs_tr, ys_tr = read(os.path.join(data_dir, STACKOVERFLOW_TRAIN_FILE))
    xs_te, ys_te = read(os.path.join(data_dir, STACKOVERFLOW_TEST_FILE))
    return _assemble(xs_tr, ys_tr, xs_te, ys_te, batch_size,
                     class_num=tag_size)


# ---------------------------------------------------------------------------
# Hermetic fixtures: format-identical tiny h5 files for tests / air-gapped CI.

def fake_femnist_h5(data_dir: str, num_clients: int = 4,
                    samples: int = 12, seed: int = 0) -> None:
    rng = np.random.RandomState(seed)
    for fname, n in ((FEMNIST_TRAIN_FILE, samples),
                     (FEMNIST_TEST_FILE, max(2, samples // 4))):
        with _h5().File(os.path.join(data_dir, fname), "w") as f:
            for c in range(num_clients):
                g = f.create_group(f"{_EXAMPLES}/f{c:04d}")
                g.create_dataset("pixels", data=rng.rand(n, 28, 28)
                                 .astype(np.float32))
                g.create_dataset("label", data=rng.randint(0, 62, (n, 1)))


def fake_fed_cifar100_h5(data_dir: str, num_clients: int = 4,
                         samples: int = 10, seed: int = 0) -> None:
    rng = np.random.RandomState(seed)
    for fname, n in ((FED_CIFAR100_TRAIN_FILE, samples),
                     (FED_CIFAR100_TEST_FILE, max(2, samples // 4))):
        with _h5().File(os.path.join(data_dir, fname), "w") as f:
            for c in range(num_clients):
                g = f.create_group(f"{_EXAMPLES}/c{c:04d}")
                g.create_dataset("image", data=rng.randint(
                    0, 256, (n, 32, 32, 3), dtype=np.uint8))
                g.create_dataset("label", data=rng.randint(0, 100, (n, 1)))


def fake_fed_shakespeare_h5(data_dir: str, num_clients: int = 3,
                            seed: int = 0) -> None:
    rng = np.random.RandomState(seed)
    words = ["to be or not to be ", "all the world's a stage ",
             "once more unto the breach "]
    for fname in (FED_SHAKESPEARE_TRAIN_FILE, FED_SHAKESPEARE_TEST_FILE):
        with _h5().File(os.path.join(data_dir, fname), "w") as f:
            for c in range(num_clients):
                g = f.create_group(f"{_EXAMPLES}/s{c:04d}")
                snips = [(words[rng.randint(len(words))] * rng.randint(3, 9))
                         .encode("utf8") for _ in range(rng.randint(1, 4))]
                g.create_dataset("snippets", data=snips)


def fake_stackoverflow_h5(data_dir: str, num_clients: int = 3,
                          vocab_size: int = 50, tag_size: int = 8,
                          seed: int = 0) -> None:
    rng = np.random.RandomState(seed)
    vocab = [f"word{i}" for i in range(vocab_size)]
    tags = [f"tag{i}" for i in range(tag_size)]
    with open(os.path.join(data_dir, "stackoverflow.word_count"), "w") as f:
        for i, w in enumerate(vocab):
            f.write(f"{w} {vocab_size - i}\n")
    import json
    with open(os.path.join(data_dir, "stackoverflow.tag_count"), "w") as f:
        json.dump({t: tag_size - i for i, t in enumerate(tags)}, f)
    for fname in (STACKOVERFLOW_TRAIN_FILE, STACKOVERFLOW_TEST_FILE):
        with _h5().File(os.path.join(data_dir, fname), "w") as f:
            for c in range(num_clients):
                g = f.create_group(f"{_EXAMPLES}/u{c:06d}")
                n = rng.randint(2, 6)
                sent = lambda: " ".join(
                    vocab[rng.randint(vocab_size)]
                    for _ in range(rng.randint(3, 15))).encode("utf8")
                g.create_dataset("tokens", data=[sent() for _ in range(n)])
                g.create_dataset("title", data=[sent() for _ in range(n)])
                g.create_dataset("tags", data=[
                    "|".join(tags[rng.randint(tag_size)]
                             for _ in range(rng.randint(1, 3))).encode("utf8")
                    for _ in range(n)])
