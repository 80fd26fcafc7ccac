"""Hermetic synthetic federated datasets (in memory, no downloads).

Port of ``fedml_tpu/data/synthetic.py``'s ``synthetic_federated_dataset``
and ``mnist_learnable_twin``.  The numpy draws are the same, in the same
order, so one seed gives byte-equal arrays in both packages."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

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
