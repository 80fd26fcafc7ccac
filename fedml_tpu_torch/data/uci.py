"""Streaming UCI datasets (SUSY, Room Occupancy) for decentralized online
learning.

Port of ``fedml_tpu/data/uci.py``: the first ``beta * N`` rows are
clustered (numpy Lloyd's k-means) into one group per client and each
group pinned to its client (maximally non-IID); the other rows are dealt
round-robin.  Output: client id -> list of ``{"x": [...], "y": int}``
samples, and the same as padded arrays."""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def read_susy_csv(path: str, max_rows: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """SUSY.csv: label first column, 18 float features after."""
    xs, ys = [], []
    with open(path) as f:
        for i, row in enumerate(csv.reader(f)):
            if max_rows is not None and i >= max_rows:
                break
            ys.append(int(float(row[0])))
            xs.append([float(v) for v in row[1:]])
    return np.asarray(xs, np.float32), np.asarray(ys, np.int32)


def read_room_occupancy_csv(path: str, max_rows: Optional[int] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """datatraining.txt: header, then id,date,5 floats,occupancy."""
    xs, ys = [], []
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        for i, row in enumerate(reader):
            if max_rows is not None and i >= max_rows:
                break
            xs.append([float(v) for v in row[2:-1]])
            ys.append(int(row[-1]))
    return np.asarray(xs, np.float32), np.asarray(ys, np.int32)


def _kmeans_labels(x: np.ndarray, k: int, seed: int = 0,
                   iters: int = 20) -> np.ndarray:
    """Plain-numpy Lloyd's algorithm (replaces sklearn.KMeans — the only
    sklearn use in the reference's streaming loader)."""
    rng = np.random.RandomState(seed)
    k = min(k, len(x))
    centers = x[rng.choice(len(x), k, replace=False)]
    x_sq = (x ** 2).sum(-1, keepdims=True)
    assign = np.zeros(len(x), np.int64)
    for _ in range(iters):
        # ||x-c||² = ||x||² - 2x·c + ||c||², chunked: O(N·k) memory, not N×k×d
        c_sq = (centers ** 2).sum(-1)
        for lo in range(0, len(x), 65536):
            hi = lo + 65536
            d = x_sq[lo:hi] - 2.0 * (x[lo:hi] @ centers.T) + c_sq
            assign[lo:hi] = d.argmin(1)
        for j in range(k):
            pts = x[assign == j]
            if len(pts):
                centers[j] = pts.mean(0)
    return assign


def make_streaming_data(x: np.ndarray, y: np.ndarray,
                        client_list: Sequence[int],
                        sample_num_in_total: int, beta: float,
                        seed: int = 0) -> Dict[int, List[dict]]:
    """The adversarial+stochastic split described in the module docstring."""
    n_clients = len(client_list)
    n_adv = int(beta * sample_num_in_total)
    x, y = x[:sample_num_in_total], y[:sample_num_in_total]
    out: Dict[int, List[dict]] = {c: [] for c in client_list}

    if n_adv > 0:
        assign = _kmeans_labels(x[:n_adv], n_clients, seed=seed)
        for i in range(n_adv):
            cid = client_list[int(assign[i]) % n_clients]
            out[cid].append({"x": x[i].tolist(), "y": int(y[i])})
    for j, i in enumerate(range(n_adv, len(x))):
        cid = client_list[j % n_clients]
        out[cid].append({"x": x[i].tolist(), "y": int(y[i])})
    return out


def streaming_to_arrays(stream: Dict[int, List[dict]]
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad each client's stream to the max length -> (x [C, T, D],
    y [C, T], mask [C, T]) for the jit'd online-learning loop."""
    cids = sorted(stream)
    T = max(len(stream[c]) for c in cids)
    D = len(stream[cids[0]][0]["x"])
    x = np.zeros((len(cids), T, D), np.float32)
    y = np.zeros((len(cids), T), np.int32)
    m = np.zeros((len(cids), T), np.float32)
    for ci, c in enumerate(cids):
        for t, s in enumerate(stream[c]):
            x[ci, t] = s["x"]
            y[ci, t] = s["y"]
            m[ci, t] = 1.0
    return x, y, m


def load_streaming_uci(data_name: str, data_path: str,
                       client_list: Sequence[int],
                       sample_num_in_total: int, beta: float,
                       seed: int = 0) -> Dict[int, List[dict]]:
    """Top-level parity entry (DataLoader.load_datastream,
    data_loader_for_susy_and_ro.py:26-36)."""
    if data_name.upper() == "SUSY":
        x, y = read_susy_csv(data_path, max_rows=sample_num_in_total)
    else:
        x, y = read_room_occupancy_csv(data_path, max_rows=sample_num_in_total)
    return make_streaming_data(x, y, client_list, min(sample_num_in_total,
                                                      len(y)), beta, seed)


def synthetic_stream(num_clients: int = 4, total: int = 400, dim: int = 8,
                     beta: float = 0.25, seed: int = 0
                     ) -> Dict[int, List[dict]]:
    """Hermetic stand-in: two gaussian blobs -> binary labels."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, total).astype(np.int32)
    x = (rng.randn(total, dim) + 1.5 * y[:, None]).astype(np.float32)
    return make_streaming_data(x, y, list(range(num_clients)), total, beta,
                               seed)
