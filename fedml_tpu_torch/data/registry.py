"""Dataset registry for the port: the hermetic twins of this slice.

Port of ``fedml_tpu/data/registry.py`` restricted to ``mnist``,
``mnist_learnable_twin``, ``femnist`` (28x28x1, 62 classes), the 32x32x3
twins ``fed_cifar100`` (100 classes), ``cifar10``, ``cifar100`` and
``cinic10``, and the next-word twins ``shakespeare`` and
``fed_shakespeare`` (80 tokens, vocab 90) and ``stackoverflow_nwp`` (20
tokens, vocab 10004).  As in the JAX package a twin takes its client
count from the caller (``num_clients``); the CIFAR loaders' own default
of 10 clients belongs to the real on-disk loaders (LEAF, TFF h5, the
CIFAR partitions), which arrive with a later slice of the port."""

from __future__ import annotations

import inspect
from functools import partial
from typing import Callable, Dict, Optional

from fedml_tpu_torch.data.stacking import FederatedData
from fedml_tpu_torch.data.synthetic import (mnist_learnable_twin,
                                            synthetic_federated_dataset)

_REGISTRY: Dict[str, Callable[..., FederatedData]] = {
    "mnist": partial(synthetic_federated_dataset, sample_shape=(784,),
                     class_num=10),
    "mnist_learnable_twin": mnist_learnable_twin,
    "femnist": partial(synthetic_federated_dataset, sample_shape=(28, 28, 1),
                       class_num=62),
    "shakespeare": partial(synthetic_federated_dataset, sample_shape=(80,),
                           sequence_vocab=90, class_num=90),
    "fed_shakespeare": partial(synthetic_federated_dataset,
                               sample_shape=(80,), sequence_vocab=90,
                               class_num=90),
    "stackoverflow_nwp": partial(synthetic_federated_dataset,
                                 sample_shape=(20,), sequence_vocab=10004,
                                 class_num=10004),
    "fed_cifar100": partial(synthetic_federated_dataset,
                            sample_shape=(32, 32, 3), class_num=100),
    **{name: partial(synthetic_federated_dataset, sample_shape=(32, 32, 3),
                     class_num=100 if name == "cifar100" else 10)
       for name in ("cifar10", "cifar100", "cinic10")},
}


def dataset_names():
    return sorted(_REGISTRY)


def _accepted_kwargs(fn, kw: Dict) -> Dict:
    """Keep only the kwargs ``fn`` accepts (twins differ in signature)."""
    params = inspect.signature(fn).parameters
    return {k: v for k, v in kw.items() if k in params}


def load_data(name: str, data_dir: Optional[str] = None,
              **kw) -> FederatedData:
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; have {dataset_names()}")
    if data_dir is not None:
        raise NotImplementedError(
            f"dataset {name!r}: the port has no on-disk loaders yet; the "
            f"real LEAF/TFF loaders arrive with the data-loader slice "
            f"(ROADMAP Queue 1, the long tail).  Drop --data_dir to use the "
            f"hermetic twin")
    twin = _REGISTRY[name]
    return twin(**_accepted_kwargs(twin, kw))
