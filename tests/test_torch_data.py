"""Port data layer and tree math against the JAX package: the sampler is
bit-exact, the hermetic twins byte-equal, the cohort gather equal, and the
weighted mean equal within float rounding (tolerance stated per test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.pytree import tree_weighted_mean as j_mean
from fedml_tpu.core.sampling import sample_clients as j_sample
from fedml_tpu.data import registry as j_registry
from fedml_tpu.data.stacking import gather_cohort as j_gather
from fedml_tpu_torch.core.pytree import acc_dtype, tree_keys, tree_sub
from fedml_tpu_torch.core.pytree import tree_weighted_mean as t_mean
from fedml_tpu_torch.core.sampling import sample_clients as t_sample
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.data.stacking import gather_cohort as t_gather
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy


@pytest.mark.parametrize("total,per_round", [(1000, 10), (3400, 10),
                                             (12, 12), (5, 8)])
def test_sampler_bit_exact(total, per_round):
    for r in range(6):
        np.testing.assert_array_equal(t_sample(r, total, per_round),
                                      j_sample(r, total, per_round))


@pytest.mark.parametrize("name,kw", [
    ("mnist", dict(num_clients=6, batch_size=4)),
    ("mnist_learnable_twin", dict(num_clients=5, batch_size=10)),
    ("femnist", dict(num_clients=4, batch_size=20)),
    ("fed_cifar100", dict(num_clients=3, batch_size=20)),
    ("cifar10", dict(num_clients=3, batch_size=8)),
    ("cifar100", dict(num_clients=2, batch_size=8)),
    ("cinic10", dict(num_clients=2, batch_size=8)),
    ("synthetic", dict(num_users=2, batch_size=10)),
    ("stackoverflow_lr", dict(num_clients=2, samples_per_client=6,
                              batch_size=4)),
    ("cifar_learnable_twin", dict(num_clients=3, samples_per_client=60,
                                  batch_size=16)),
    ("gld23k", dict(num_clients=2, samples_per_client=3, batch_size=2)),
])
def test_twins_byte_equal(name, kw):
    """Same seed, same arrays, byte for byte, in every split (the CIFAR
    learnable twin at the flagship difficulty)."""
    if name == "cifar_learnable_twin":
        from fedml_tpu.data import synthetic as j_synthetic
        from fedml_tpu_torch.data import synthetic as t_synthetic
        kw = {**kw, **t_synthetic.FLAGSHIP_TWIN_KWARGS}
        assert kw == {**kw, **j_synthetic.FLAGSHIP_TWIN_KWARGS}
        a = t_synthetic.cifar_learnable_twin(seed=3, **kw)
        b = j_synthetic.cifar_learnable_twin(seed=3, **kw)
    else:
        a = load_data(name, seed=3, **kw)
        b = j_registry.load_data(name, seed=3, **kw)
    assert (a.client_num, a.class_num) == (b.client_num, b.class_num)
    for split in ("train", "test", "train_global", "test_global"):
        sa, sb = getattr(a, split), getattr(b, split)
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype
            assert sa[k].tobytes() == sb[k].tobytes(), (split, k)


def test_data_dir_dispatches_to_the_loader_and_new_twins(tmp_path):
    """``data_dir`` reaches the on-disk loader (a TFF h5 FEMNIST the JAX
    package's writer made), and ``ilsvrc2012`` has its twin (224x224x3,
    1000 classes; small sizes here, its defaults are ~150 MB)."""
    from fedml_tpu.data.tff_h5 import fake_femnist_h5
    fake_femnist_h5(str(tmp_path), num_clients=3, samples=5)
    a = load_data("femnist", data_dir=str(tmp_path), batch_size=4)
    b = j_registry.load_data("femnist", data_dir=str(tmp_path), batch_size=4)
    assert (a.client_num, a.class_num) == (3, 62)
    for k in b.train:
        assert a.train[k].tobytes() == b.train[k].tobytes()
    twin = load_data("ilsvrc2012", num_clients=2, samples_per_client=4)
    assert (twin.client_num, twin.class_num) == (2, 1000)
    assert twin.train["x"].shape[-3:] == (224, 224, 3)


def test_gather_cohort_matches_and_zeroes_pad_slots():
    data = load_data("mnist", num_clients=7, batch_size=4, seed=1)
    ids = [5, 2, 3]
    got = t_gather(data.train, ids, pad_to=5)
    want = j_gather(data.train, ids, pad_to=5)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert float(got["mask"][3:].sum()) == 0.0
    assert got["num_samples"][3:].tolist() == [0.0, 0.0]
    with pytest.raises(ValueError, match="pad_to"):
        t_gather(data.train, [0, 1, 2], pad_to=2)


def _tree(rng, n):
    mk = lambda *s: rng.randn(n, *s).astype(np.float32)
    return {"params": {"dense": {"kernel": mk(5, 3), "bias": mk(3)}},
            "batch_stats": {"count": rng.randint(0, 100, (n, 1))
                            .astype(np.int32)}}


def test_weighted_mean_matches_jax(rng):
    """Float leaves within 1e-6; the int leaf truncates identically."""
    tree = _tree(rng, 4)
    w = np.array([3.0, 0.0, 1.0, 2.5], np.float32)
    got = params_to_numpy(t_mean(params_from_numpy(tree), torch.tensor(w)))
    want = jax.tree.map(np.asarray, j_mean(jax.tree.map(jnp.asarray, tree),
                                           jnp.asarray(w)))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=1e-6),
                 got, want)
    assert got["batch_stats"]["count"].dtype == np.int32
    # list-of-trees form equals the stacked form
    flat = params_from_numpy(tree)
    rows = [{k: v[i] for k, v in flat.items()} for i in range(4)]
    listed = t_mean(rows, torch.tensor(w))
    for k in flat:
        torch.testing.assert_close(listed[k], t_mean(flat, torch.tensor(w))[k])


def test_tree_helpers():
    t = params_from_numpy({"b": {"y": np.ones(2)}, "a": np.zeros(1),
                           "b2": np.ones(1)})
    assert list(t) == tree_keys(t) == ["a", "b/y", "b2"]
    assert acc_dtype(torch.int32) == torch.float32
    assert acc_dtype(torch.bfloat16) == torch.bfloat16
    d = tree_sub(t, t)
    assert all(float(v.abs().sum()) == 0 for v in d.values())
