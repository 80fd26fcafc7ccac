"""Dataset registry: ``load_data(name, data_dir=..., **kw)`` dispatches to
the dataset's loader and returns `FederatedData`.

Port of ``fedml_tpu/data/registry.py``, the same names, loaders, twins and
defaults.  With ``data_dir`` the on-disk loader reads it: a ``data_dir``
that does not exist raises `FileNotFoundError` (never a silent twin), an
option that neither the loader nor the twin takes raises `TypeError`, and
an option only the twin takes (``num_clients``) is dropped.  Without
``data_dir`` the hermetic twin, with the real dataset's shapes, stands in
(``synthetic_ok=False`` refuses it)."""

from __future__ import annotations

import inspect
import os
from functools import partial
from typing import Callable, Dict, Optional

from fedml_tpu_torch.data.stacking import FederatedData
from fedml_tpu_torch.data.synthetic import (load_synthetic,
                                            mnist_learnable_twin,
                                            synthetic_federated_dataset)

# name -> {"loader": on-disk loader, "twin": hermetic twin, "defaults"}
_REGISTRY: Dict[str, Dict] = {}


def register_dataset(name: str, loader: Callable,
                     synthetic_twin: Optional[Callable] = None,
                     **defaults) -> None:
    _REGISTRY[name] = {"loader": loader, "twin": synthetic_twin,
                       "defaults": defaults}


def dataset_names():
    return sorted(_REGISTRY)


def _accepted_kwargs(fn, kw: Dict) -> Dict:
    """The kwargs ``fn`` accepts (all of them when it takes ``**kw``)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return kw
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return kw
    return {k: v for k, v in kw.items() if k in sig.parameters}


def load_data(name: str, data_dir: Optional[str] = None,
              synthetic_ok: bool = True, **kw) -> FederatedData:
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; have {dataset_names()}")
    entry = _REGISTRY[name]
    if data_dir is not None:
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(
                f"dataset {name!r}: data_dir {data_dir!r} does not exist")
        merged = {**entry["defaults"], **kw}
        accepted = _accepted_kwargs(entry["loader"], merged)
        dropped = set(merged) - set(accepted)
        twin_ok = (set(_accepted_kwargs(entry["twin"], merged))
                   if entry["twin"] is not None else set())
        unknown = dropped - twin_ok
        if unknown:
            raise TypeError(
                f"dataset {name!r}: unknown option(s) {sorted(unknown)}")
        return entry["loader"](data_dir=data_dir, **accepted)
    if synthetic_ok and entry["twin"] is not None:
        return entry["twin"](**_accepted_kwargs(entry["twin"], kw))
    raise FileNotFoundError(
        f"dataset {name!r}: no data_dir given and synthetic fallback "
        f"disabled/unavailable")


def _register_all() -> None:
    from fedml_tpu_torch.data import cifar, imagenet, leaf, tff_h5

    def img_twin(shape, classes):
        return partial(synthetic_federated_dataset, sample_shape=shape,
                       class_num=classes)

    def text_twin(length, vocab):
        return partial(synthetic_federated_dataset, sample_shape=(length,),
                       sequence_vocab=vocab, class_num=vocab)

    register_dataset("mnist", leaf.load_mnist, img_twin((784,), 10))
    # the learnable MNIST stand-in (class prototypes + noise, LEAF
    # power-law sizes): a model learns on it, unlike the noise twin
    register_dataset("mnist_learnable_twin", leaf.load_mnist,
                     mnist_learnable_twin)
    register_dataset("shakespeare", leaf.load_shakespeare_leaf,
                     text_twin(80, 90))
    register_dataset("synthetic", lambda data_dir=None, **kw:
                     leaf.load_synthetic_leaf(data_dir, **kw),
                     load_synthetic)
    register_dataset("femnist", tff_h5.load_federated_emnist,
                     img_twin((28, 28, 1), 62))
    register_dataset("fed_cifar100", tff_h5.load_fed_cifar100,
                     img_twin((32, 32, 3), 100))
    register_dataset("fed_shakespeare", tff_h5.load_fed_shakespeare,
                     text_twin(80, 90))
    register_dataset("stackoverflow_nwp", tff_h5.load_stackoverflow_nwp,
                     text_twin(20, 10004))
    register_dataset("stackoverflow_lr", tff_h5.load_stackoverflow_lr,
                     partial(synthetic_federated_dataset,
                             sample_shape=(10000,), class_num=500,
                             multilabel=True))
    for ds in ("cifar10", "cifar100", "cinic10"):
        register_dataset(
            ds, partial(cifar.load_cifar_partitioned, ds),
            img_twin((32, 32, 3), 100 if ds == "cifar100" else 10),
            client_num=10)
    register_dataset("ilsvrc2012", imagenet.load_imagenet,
                     img_twin((224, 224, 3), 1000))
    # the Landmarks mapping csvs under the data root
    register_dataset(
        "gld23k", imagenet.load_landmarks, img_twin((224, 224, 3), 203),
        mapping_csv="data_user_dict/gld23k_user_dict_train.csv")
    register_dataset(
        "gld160k", imagenet.load_landmarks, img_twin((224, 224, 3), 2028),
        mapping_csv="data_user_dict/gld160k_user_dict_train.csv")


_register_all()
