"""Non-IID data partitioners (host side, numpy).

Port of ``fedml_tpu/core/partition.py``: the LDA partitioner (per-class
Dirichlet split with the min-size-10 retry loop and the capacity cap
``p * (len(idx_j) < N / client_num)``, for classification and multi-label
segmentation), the cifar-style ``homo`` and ``hetero`` splits, the
fixed-table ``hetero-fix`` split and the per-client class histograms.

The draws are numpy's ``RandomState`` (the global ``np.random`` when
``seed`` is None), in the JAX package's order, so one seed gives the same
index maps in both packages.  Partitioning runs once at set-up, on the
host; the device work starts where the per-client index lists are stacked
(`fedml_tpu_torch.data.stacking`)."""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence

import numpy as np


def _dirichlet_split_class(N: int, alpha: float, client_num: int,
                           idx_batch: List[List[int]], idx_k: np.ndarray,
                           rng):
    """One class's Dirichlet allocation.  Clients already holding
    ``>= N / client_num`` samples get probability 0 for this class, which
    bounds the imbalance."""
    rng.shuffle(idx_k)
    proportions = rng.dirichlet(np.repeat(alpha, client_num))
    proportions = np.array(
        [p * (len(idx_j) < N / client_num)
         for p, idx_j in zip(proportions, idx_batch)])
    proportions = proportions / proportions.sum()
    cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
    idx_batch = [idx_j + idx.tolist()
                 for idx_j, idx in zip(idx_batch, np.split(idx_k, cuts))]
    min_size = min(len(idx_j) for idx_j in idx_batch)
    return idx_batch, min_size


def partition_dirichlet(label_list, client_num: int, classes, alpha: float,
                        task: str = "classification",
                        seed: int | None = None,
                        min_size_floor: int = 10) -> Dict[int, np.ndarray]:
    """LDA partition.  ``classes`` is the number of classes for
    classification, or a list of category ids for segmentation (an
    instance can hold several categories and goes with the first that
    matches).  Retries until every client holds ``min_size_floor``
    samples."""
    rng = np.random.RandomState(seed) if seed is not None else np.random
    if task == "segmentation":
        N = len(label_list)
    else:
        label_list = np.asarray(label_list)
        N = label_list.shape[0]

    min_size = 0
    while min_size < min_size_floor:
        idx_batch: List[List[int]] = [[] for _ in range(client_num)]
        if task == "segmentation":
            for c, cat in enumerate(classes):
                if c > 0:
                    hit = np.asarray([
                        np.any(label_list[i] == cat)
                        and not np.any(np.isin(label_list[i], classes[:c]))
                        for i in range(len(label_list))])
                else:
                    hit = np.asarray([np.any(label_list[i] == cat)
                                      for i in range(len(label_list))])
                idx_k = np.where(hit)[0]
                idx_batch, min_size = _dirichlet_split_class(
                    N, alpha, client_num, idx_batch, idx_k, rng)
        else:
            for k in range(int(classes)):
                idx_k = np.where(label_list == k)[0]
                idx_batch, min_size = _dirichlet_split_class(
                    N, alpha, client_num, idx_batch, idx_k, rng)

    out = {}
    for i in range(client_num):
        rng.shuffle(idx_batch[i])
        out[i] = np.asarray(idx_batch[i], dtype=np.int64)
    return out


def partition_dirichlet_hetero(labels, client_num: int, class_num: int,
                               alpha: float, seed: int | None = None
                               ) -> Dict[int, np.ndarray]:
    """The cifar-style ``hetero`` partition: the LDA partitioner on
    classification labels."""
    return partition_dirichlet(labels, client_num, class_num, alpha,
                               task="classification", seed=seed)


def partition_homo(n_samples: int, client_num: int,
                   seed: int | None = None) -> Dict[int, np.ndarray]:
    """IID split: one permutation, then ``array_split`` (the permuted
    order is kept within each client)."""
    rng = np.random.RandomState(seed) if seed is not None else np.random
    idxs = rng.permutation(n_samples)
    return {i: part.astype(np.int64)
            for i, part in enumerate(np.array_split(idxs, client_num))}


def partition_from_distribution(labels: Sequence[int],
                                distribution: Dict[int, Dict[int, int]]
                                ) -> Dict[int, np.ndarray]:
    """``hetero-fix``: each (client, class) takes the next ``count``
    samples of the class, from a fixed table."""
    labels = np.asarray(labels)
    per_class = {k: list(np.where(labels == k)[0]) for k in np.unique(labels)}
    out: Dict[int, List[int]] = {}
    for cid, cls_counts in distribution.items():
        take: List[int] = []
        for k, cnt in cls_counts.items():
            pool = per_class[k]
            take.extend(pool[:cnt])
            del pool[:cnt]
        out[int(cid)] = np.asarray(take, dtype=np.int64)
    return out


def record_data_stats(y_train, net_dataidx_map: Dict[int, np.ndarray],
                      task: str = "classification"
                      ) -> Dict[int, Dict[int, int]]:
    """Per-client class histograms ``{client: {class: count}}``."""
    y_train = (np.asarray(y_train, dtype=object) if task == "segmentation"
               else np.asarray(y_train))
    net_cls_counts = {}
    for net_i, dataidx in net_dataidx_map.items():
        if task == "segmentation":
            vals = np.concatenate([np.asarray(y_train[i]).ravel()
                                   for i in dataidx])
        else:
            vals = y_train[dataidx]
        unq, unq_cnt = np.unique(vals, return_counts=True)
        net_cls_counts[net_i] = {int(u): int(c) for u, c in zip(unq, unq_cnt)}
    logging.debug("Data statistics: %s", net_cls_counts)
    return net_cls_counts
