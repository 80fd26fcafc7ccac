"""Hermetic synthetic federated datasets (in memory, no downloads).

Port of ``fedml_tpu/data/synthetic.py``: the LEAF synthetic_(alpha, beta)
logistic task (``generate_synthetic_alpha_beta``, ``load_synthetic``),
the shape twin of any real loader (``synthetic_federated_dataset``), and
the learnable twins of MNIST and CIFAR-10 (``mnist_learnable_twin``,
``cifar_learnable_twin`` at ``FLAGSHIP_TWIN_KWARGS``).  The numpy draws
are the same, in the same order, so one seed gives byte-equal arrays in
both packages."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from fedml_tpu_torch.core.partition import partition_dirichlet_hetero
from fedml_tpu_torch.data.stacking import (FederatedData, batch_global,
                                           stack_client_data)


def _federated(xs_tr, ys_tr, xs_te, ys_te, num_clients: int, class_num: int,
               batch_size: int) -> FederatedData:
    return FederatedData(
        client_num=num_clients, class_num=class_num,
        train=stack_client_data(xs_tr, ys_tr, batch_size),
        test=stack_client_data(xs_te, ys_te, batch_size),
        train_global=batch_global(np.concatenate(xs_tr),
                                  np.concatenate(ys_tr), batch_size),
        test_global=batch_global(np.concatenate(xs_te),
                                 np.concatenate(ys_te), batch_size))


def generate_synthetic_alpha_beta(
        alpha: float = 0.5, beta: float = 0.5, iid: bool = False,
        num_users: int = 30, dimension: int = 60, num_classes: int = 10,
        seed: int = 0, min_samples: int = 50) -> Tuple[list, list]:
    """Per-user (X, y) lists of the synthetic_(alpha, beta) task: user
    weights W_i ~ N(u_i, 1) with u_i ~ N(0, alpha), feature means
    v_i ~ N(B_i, 1) with B_i ~ N(0, beta), x ~ N(v_i, diag(j^-1.2)),
    y = argmax(xW + b); ``iid`` shares one (W, b).  Sample counts are
    lognormal(4, 2) + ``min_samples``."""
    rng = np.random.RandomState(seed)
    samples_per_user = rng.lognormal(4, 2, num_users).astype(int) \
        + min_samples

    mean_W = rng.normal(0, alpha, num_users)
    B = rng.normal(0, beta, num_users)
    cov_x = np.diag(np.power(np.arange(1, dimension + 1), -1.2))

    mean_x = np.zeros((num_users, dimension))
    for i in range(num_users):
        mean_x[i] = B[i] if iid else rng.normal(B[i], 1, dimension)

    if iid:
        W_g = rng.normal(0, 1, (dimension, num_classes))
        b_g = rng.normal(0, 1, num_classes)

    X_split, y_split = [], []
    for i in range(num_users):
        W = W_g if iid else rng.normal(mean_W[i], 1, (dimension, num_classes))
        b = b_g if iid else rng.normal(mean_W[i], 1, num_classes)
        xx = rng.multivariate_normal(mean_x[i], cov_x, samples_per_user[i])
        yy = np.argmax(xx @ W + b, axis=1)
        X_split.append(xx.astype(np.float32))
        y_split.append(yy.astype(np.int32))
    return X_split, y_split


def load_synthetic(alpha: float = 0.5, beta: float = 0.5, iid: bool = False,
                   num_users: int = 30, batch_size: int = 10,
                   train_frac: float = 0.9, seed: int = 0) -> FederatedData:
    """synthetic_(alpha, beta) with a 90/10 train/test split per user."""
    X, y = generate_synthetic_alpha_beta(alpha, beta, iid, num_users,
                                         seed=seed)
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for xi, yi in zip(X, y):
        n_tr = int(len(yi) * train_frac)
        xs_tr.append(xi[:n_tr])
        ys_tr.append(yi[:n_tr])
        xs_te.append(xi[n_tr:])
        ys_te.append(yi[n_tr:])
    return _federated(xs_tr, ys_tr, xs_te, ys_te, num_users, 10, batch_size)


def mnist_learnable_twin(num_clients: int = 1000, class_num: int = 10,
                         dim: int = 784, batch_size: int = 10,
                         noise: float = 7.0, max_samples: int = 64,
                         seed: int = 0) -> FederatedData:
    """A learnable MNIST stand-in: each class is a random prototype,
    samples are prototype + N(0, noise), client sizes follow a lognormal
    power law, and each client has two dominant classes."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(class_num, dim).astype(np.float32)
    sizes = np.minimum(rng.lognormal(3.0, 1.0, num_clients).astype(int) + 8,
                       max_samples)
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for c in range(num_clients):
        dom = rng.choice(class_num, 2, replace=False)
        p = np.full(class_num, 0.1 / (class_num - 2))
        p[dom] = 0.45
        n = int(sizes[c])
        n_te = max(1, n // 5)
        for xs, ys, m in ((xs_tr, ys_tr, n), (xs_te, ys_te, n_te)):
            y = rng.choice(class_num, m, p=p).astype(np.int32)
            x = (protos[y] + noise * rng.randn(m, dim)).astype(np.float32)
            xs.append(x)
            ys.append(y)
    return _federated(xs_tr, ys_tr, xs_te, ys_te, num_clients, class_num,
                      batch_size)


# the flagship-proxy twin's difficulty: the CI retention proxy and the
# full-size accuracy run must measure the same task
FLAGSHIP_TWIN_KWARGS = {"noise": 1.4, "modes": 4}


def cifar_learnable_twin(num_clients: int = 10, class_num: int = 10,
                         samples_per_client: int = 500,
                         partition_alpha: float = 0.5,
                         batch_size: int = 64, noise: float = 0.35,
                         seed: int = 0, modes: int = 1) -> FederatedData:
    """A learnable CIFAR-shaped twin: each class has ``modes`` smooth
    random 32x32x3 prototypes (8x8 noise upsampled bilinearly), a sample
    is a random mode of its class plus pixel noise, and the train pool is
    split across clients by the LDA(``partition_alpha``) partitioner, so
    the label skew is the published config's.  Each client keeps the
    last fifth of its own shard as its test split; the global test set
    is drawn apart."""
    rng = np.random.RandomState(seed)
    n_total = num_clients * samples_per_client
    low = rng.randn(class_num, modes, 8, 8, 3).astype(np.float32)
    protos = np.stack([np.stack([_upsample_bilinear(m, 32) for m in p])
                       for p in low])  # [class, mode, 32, 32, 3]

    def make_split(n, rng):
        y = rng.randint(0, class_num, n).astype(np.int32)
        mode = rng.randint(0, modes, n)
        x = protos[y, mode] + noise * rng.randn(
            n, 32, 32, 3).astype(np.float32)
        return x.astype(np.float32), y

    x_tr, y_tr = make_split(n_total, rng)
    x_te, y_te = make_split(max(class_num * 20, n_total // 5), rng)
    idx_map = partition_dirichlet_hetero(y_tr, num_clients, class_num,
                                         partition_alpha, seed=seed)
    xs, ys, xs_te, ys_te = [], [], [], []
    for c in range(num_clients):
        idx = idx_map[c]
        n_te = max(1, len(idx) // 5)
        xs.append(x_tr[idx[:-n_te]])
        ys.append(y_tr[idx[:-n_te]])
        xs_te.append(x_tr[idx[-n_te:]])
        ys_te.append(y_tr[idx[-n_te:]])
    return FederatedData(
        client_num=num_clients, class_num=class_num,
        train=stack_client_data(xs, ys, batch_size),
        test=stack_client_data(xs_te, ys_te, batch_size),
        train_global=batch_global(np.concatenate(xs), np.concatenate(ys),
                                  batch_size),
        test_global=batch_global(x_te, y_te, batch_size))


def _upsample_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """[h, w, c] -> [size, size, c], bilinear, in numpy."""
    h, w, c = img.shape
    ys = np.linspace(0, h - 1, size)
    xs = np.linspace(0, w - 1, size)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def synthetic_federated_dataset(
        num_clients: int = 8, samples_per_client: int = 32,
        sample_shape: Sequence[int] = (28, 28, 1), class_num: int = 10,
        batch_size: int = 8, seed: int = 0,
        x_dtype=np.float32, sequence_vocab: Optional[int] = None,
        multilabel: bool = False, heterogeneous_sizes: bool = True
        ) -> FederatedData:
    """Shape-compatible stand-in for a real loader: x ~ N(0, 1) in
    ``sample_shape`` with uniform labels; ``sequence_vocab`` gives int ids
    with shifted targets; ``multilabel`` a float multi-hot target."""
    rng = np.random.RandomState(seed)
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for c in range(num_clients):
        n = samples_per_client
        if heterogeneous_sizes:
            n = max(2, int(samples_per_client * rng.uniform(0.4, 1.6)))
        n_te = max(1, n // 5)
        for xs, ys, m in ((xs_tr, ys_tr, n), (xs_te, ys_te, n_te)):
            if sequence_vocab is not None:
                seq = rng.randint(0, sequence_vocab,
                                  (m,) + tuple(sample_shape)).astype(np.int32)
                xs.append(seq)
                ys.append(np.concatenate(
                    [seq[:, 1:], seq[:, :1]], axis=1).astype(np.int32))
            else:
                xs.append(rng.randn(*((m,) + tuple(sample_shape)))
                          .astype(x_dtype))
                if multilabel:
                    ys.append((rng.rand(m, class_num) < 0.05)
                              .astype(np.float32))
                else:
                    ys.append(rng.randint(0, class_num, m).astype(np.int32))
    return _federated(xs_tr, ys_tr, xs_te, ys_te, num_clients, class_num,
                      batch_size)
