"""The port's data layer against the JAX package's, on files the tests
write in each dataset's own layout: every loader gives byte-equal
`FederatedData` (dtype and bytes of every split), the partitioners give
the same index maps, the augmentation functions and the new key draws are
bit-equal on the CPU, the tag-prediction workload agrees within 1e-6
relative, memmap staging trains bit-equal to memory, and the registry and
the CLI dispatch as the JAX package's do."""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import partition as j_part
from fedml_tpu.data import augment as j_aug
from fedml_tpu.data import cifar as j_cifar
from fedml_tpu.data import edge_case as j_edge
from fedml_tpu.data import imagenet as j_imagenet
from fedml_tpu.data import leaf as j_leaf
from fedml_tpu.data import registry as j_registry
from fedml_tpu.data import tabular as j_tabular
from fedml_tpu.data import text as j_text
from fedml_tpu.data import tff_h5 as j_h5
from fedml_tpu.data import uci as j_uci
from fedml_tpu_torch.core import partition as t_part
from fedml_tpu_torch.core import prng
from fedml_tpu_torch.data import augment as t_aug
from fedml_tpu_torch.data import cifar as t_cifar
from fedml_tpu_torch.data import edge_case as t_edge
from fedml_tpu_torch.data import imagenet as t_imagenet
from fedml_tpu_torch.data import leaf as t_leaf
from fedml_tpu_torch.data import registry as t_registry
from fedml_tpu_torch.data import tabular as t_tabular
from fedml_tpu_torch.data import text as t_text
from fedml_tpu_torch.data import tff_h5 as t_h5
from fedml_tpu_torch.data import uci as t_uci


def assert_fd_equal(a, b):
    """Every split of two `FederatedData`, dtype and bytes."""
    assert (a.client_num, a.class_num) == (b.client_num, b.class_num)
    for split in ("train", "test", "train_global", "test_global"):
        sa, sb = getattr(a, split), getattr(b, split)
        assert (sa is None) == (sb is None), split
        if sa is None:
            continue
        assert sorted(sa) == sorted(sb), split
        for k in sa:
            assert sa[k].dtype == sb[k].dtype, (split, k)
            assert sa[k].shape == sb[k].shape, (split, k)
            assert sa[k].tobytes() == sb[k].tobytes(), (split, k)


def assert_arrays_equal(a, b):
    for x, y in zip(a, b, strict=True):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


# --- LEAF json ---------------------------------------------------------------

def _write_leaf(root, make, users=5, n=7, seed=0, skip_test_user=True):
    """A LEAF tree; the last user has no test rows (a missing user)."""
    rng = np.random.RandomState(seed)
    names = [f"u_{i:03d}" for i in range(users)]
    for split, m in (("train", n), ("test", max(2, n // 3))):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        present = names[:-1] if split == "test" and skip_test_user else names
        data = {u: make(rng, m + i % 3) for i, u in enumerate(present)}
        with open(os.path.join(root, split, "all_data.json"), "w") as f:
            json.dump({"users": present,
                       "num_samples": [len(d["y"]) for d in data.values()],
                       "user_data": data}, f)


def _mnist_rows(rng, m):
    return {"x": np.round(rng.rand(m, 784), 3).tolist(),
            "y": rng.randint(0, 10, m).tolist()}


def _shakespeare_rows(rng, m):
    chars = "abc de!\nZ~"
    return {"x": ["".join(rng.choice(list(chars), 80)) for _ in range(m)],
            "y": [rng.choice(list(chars)) for _ in range(m)]}


def _synthetic_rows(rng, m):
    return {"x": rng.randn(m, 60).tolist(),
            "y": rng.randint(0, 10, m).tolist()}


@pytest.mark.parametrize("name, rows, load_j, load_t", [
    ("mnist", _mnist_rows, j_leaf.load_mnist, t_leaf.load_mnist),
    ("shakespeare", _shakespeare_rows, j_leaf.load_shakespeare_leaf,
     t_leaf.load_shakespeare_leaf),
    ("synthetic", _synthetic_rows, j_leaf.load_synthetic_leaf,
     t_leaf.load_synthetic_leaf),
])
def test_leaf_loaders_byte_equal(tmp_path, name, rows, load_j, load_t):
    _write_leaf(str(tmp_path), rows)
    a, b = load_t(str(tmp_path), batch_size=3), load_j(str(tmp_path),
                                                       batch_size=3)
    assert_fd_equal(a, b)
    assert a.client_num == 5 and a.test["num_samples"][-1] == 0


def test_leaf_mnist_by_device_id_and_read_dirs(tmp_path):
    _write_leaf(str(tmp_path / "dev7"), _mnist_rows)
    assert_fd_equal(t_leaf.load_mnist_by_device_id(str(tmp_path), "dev7"),
                    j_leaf.load_mnist_by_device_id(str(tmp_path), "dev7"))
    dirs = [str(tmp_path / "dev7" / s) for s in ("train", "test")]
    assert t_leaf.read_leaf_dirs(*dirs) == j_leaf.read_leaf_dirs(*dirs)


# --- text encodings ----------------------------------------------------------

def test_text_encodings_equal(tmp_path):
    wc = tmp_path / "wc"
    wc.write_text("".join(f"w{i} {100 - i}\n" for i in range(30)))
    tags = tmp_path / "tags"
    tags.write_text(json.dumps({f"t{i}": 9 - i for i in range(9)}))
    cj, ct = j_text.CharVocab(), t_text.CharVocab()
    assert ct.vocab_size == cj.vocab_size == 90
    snippet = "to be, or not to be: that is the question~\n" * 3
    assert_arrays_equal(ct.encode_snippet(snippet, 16),
                        cj.encode_snippet(snippet, 16))
    assert_arrays_equal([t_text.leaf_word_to_indices("ab~")],
                        [j_text.leaf_word_to_indices("ab~")])
    wj = j_text.WordVocab.from_word_count_file(str(wc), 20, 3)
    wt = t_text.WordVocab.from_word_count_file(str(wc), 20, 3)
    for s in ("w0 w1 zzz", "w3 " * 30, "oov words only here"):
        assert_arrays_equal([wt.encode_sentence(s)], [wj.encode_sentence(s)])
    win = np.arange(24, dtype=np.int32).reshape(3, 8)
    for k in ("x", "y"):
        assert_arrays_equal([t_text.split_next_word(win)[k]],
                            [j_text.split_next_word(win)[k]])
    vocab = {"a": 0, "b": 1, "w2": 2}
    sents = ["a a b", "c c", "w2 a w2 w2"]
    assert_arrays_equal([t_text.bag_of_words(sents, vocab)],
                        [j_text.bag_of_words(sents, vocab)])
    td = t_text.load_tag_dict(str(tags), 5)
    assert td == j_text.load_tag_dict(str(tags), 5)
    assert_arrays_equal([t_text.multi_hot_tags(["t0|t4", "t8|t1"], td)],
                        [j_text.multi_hot_tags(["t0|t4", "t8|t1"], td)])


# --- TFF h5 ------------------------------------------------------------------

H5_SETS = {
    "femnist": ("fake_femnist_h5", "load_federated_emnist", {}),
    "fed_cifar100": ("fake_fed_cifar100_h5", "load_fed_cifar100", {}),
    "fed_shakespeare": ("fake_fed_shakespeare_h5", "load_fed_shakespeare",
                        {}),
    "stackoverflow_nwp": ("fake_stackoverflow_h5", "load_stackoverflow_nwp",
                          dict(vocab_size=50)),
    "stackoverflow_lr": ("fake_stackoverflow_h5", "load_stackoverflow_lr",
                         dict(vocab_size=50, tag_size=8)),
}


@pytest.mark.parametrize("name", sorted(H5_SETS))
def test_h5_writers_and_loaders_cross(tmp_path, name):
    """Each package's writer read by each package's loader: all four
    `FederatedData` byte-equal."""
    writer, loader, kw = H5_SETS[name]
    out = []
    for side, mod in (("jax", j_h5), ("port", t_h5)):
        d = tmp_path / side
        d.mkdir()
        getattr(mod, writer)(str(d), seed=3)
        out += [getattr(j_h5, loader)(str(d), batch_size=3, **kw),
                getattr(t_h5, loader)(str(d), batch_size=3, **kw)]
    for fd in out[1:]:
        assert_fd_equal(fd, out[0])


def test_h5_max_clients(tmp_path):
    t_h5.fake_femnist_h5(str(tmp_path), num_clients=5, samples=6)
    a = t_h5.load_federated_emnist(str(tmp_path), batch_size=4,
                                   max_clients=2)
    assert_fd_equal(a, j_h5.load_federated_emnist(str(tmp_path),
                                                  batch_size=4,
                                                  max_clients=2))
    assert a.client_num == 2


# --- CIFAR / CINIC ------------------------------------------------------------

def _write_cifar(root, hundred=False, per=40, n_test=30, seed=0):
    rng = np.random.RandomState(seed)
    if hundred:
        d = root / "cifar-100-python"
        d.mkdir(parents=True)
        for split, n in (("train", 5 * per), ("test", n_test)):
            with open(d / split, "wb") as f:
                pickle.dump({"data": rng.randint(0, 256, (n, 3072),
                                                 dtype=np.uint8),
                             "fine_labels": rng.randint(0, 100, n).tolist()},
                            f, protocol=2)
        return root
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for name, n in [(f"data_batch_{b}", per) for b in range(1, 6)] \
            + [("test_batch", n_test)]:
        with open(d / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072),
                                             dtype=np.uint8),
                         "labels": rng.randint(0, 10, n).tolist()}, f,
                        protocol=2)
    return root


def _write_image_tree(root, splits, classes, per_class, size, ext,
                      seed=0):
    from PIL import Image
    rng = np.random.RandomState(seed)
    for split in splits:
        for c in classes:
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(per_class):
                Image.fromarray(rng.randint(0, 256, (size, size, 3),
                                            dtype=np.uint8)).save(
                    d / f"img{i}{ext}")
    return root


@pytest.mark.parametrize("dataset, method", [
    ("cifar10", "hetero"), ("cifar10", "homo"), ("cifar100", "homo"),
    ("cinic10", "homo")])
def test_cifar_loaders_byte_equal(tmp_path, dataset, method):
    if dataset == "cinic10":
        _write_image_tree(tmp_path, ("train", "test"),
                          ("airplane", "cat", "ship"), 14, 32, ".png")
    else:
        _write_cifar(tmp_path, hundred=dataset == "cifar100")
    kw = dict(client_num=3, partition_method=method, partition_alpha=0.5,
              batch_size=8, seed=4)
    a = t_cifar.load_cifar_partitioned(dataset, str(tmp_path), **kw)
    assert_fd_equal(a, j_cifar.load_cifar_partitioned(dataset, str(tmp_path),
                                                      **kw))
    assert a.train["num_samples"].sum() == {"cinic10": 42}.get(dataset, 200)


def test_cifar_arrays_hook_and_refusal():
    rng = np.random.RandomState(0)
    arrays = (rng.rand(120, 32, 32, 3).astype(np.float32),
              rng.randint(0, 4, 120), rng.rand(20, 32, 32, 3)
              .astype(np.float32), rng.randint(0, 4, 20))
    kw = dict(client_num=3, batch_size=16, seed=2, arrays=arrays)
    assert_fd_equal(t_cifar.load_cifar_partitioned("cifar10", "", **kw),
                    j_cifar.load_cifar_partitioned("cifar10", "", **kw))
    flat = rng.randint(0, 256, (3, 3072), dtype=np.uint8)
    assert_arrays_equal([t_cifar._to_hwc01(flat)], [j_cifar._to_hwc01(flat)])
    for mod in (t_cifar, j_cifar):
        with pytest.raises(ValueError, match="unknown partition method"):
            mod.load_cifar_partitioned("cifar10", "", partition_method="x",
                                       **kw)


# --- ImageNet / Landmarks ------------------------------------------------------

def test_imagenet_and_landmarks_byte_equal(tmp_path):
    from PIL import Image
    _write_image_tree(tmp_path / "inet", ("train",), ("n01", "n02", "n03"),
                      2, 20, ".JPEG")
    kw = dict(batch_size=2, max_clients=2, image_size=16)
    assert_fd_equal(t_imagenet.load_imagenet(str(tmp_path / "inet"), **kw),
                    j_imagenet.load_imagenet(str(tmp_path / "inet"), **kw))
    assert t_imagenet.index_imagenet_folders(str(tmp_path / "inet")) == \
        j_imagenet.index_imagenet_folders(str(tmp_path / "inet"))

    gld = tmp_path / "gld"
    rng = np.random.RandomState(1)
    rows = [("u1", "abc001", 0), ("u1", "abd002", 2), ("u0", "xyz003", 1)]
    (gld / "data_user_dict").mkdir(parents=True)
    with open(gld / "data_user_dict" / "gld23k_user_dict_train.csv",
              "w") as f:
        f.write("user_id,image_id,class\n")
        f.writelines(f"{u},{i},{c}\n" for u, i, c in rows)
    for _, image_id, _ in rows:
        p = t_imagenet.landmarks_image_path(str(gld), image_id)
        assert p == j_imagenet.landmarks_image_path(str(gld), image_id)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (24, 18, 3),
                                    dtype=np.uint8)).save(p)
    csv = "data_user_dict/gld23k_user_dict_train.csv"
    kw = dict(batch_size=2, image_size=16)
    a = t_imagenet.load_landmarks(str(gld), csv, **kw)
    assert_fd_equal(a, j_imagenet.load_landmarks(str(gld), csv, **kw))
    assert (a.client_num, a.class_num) == (2, 3)
    assert t_imagenet.read_landmarks_mapping(str(gld / csv)) == \
        j_imagenet.read_landmarks_mapping(str(gld / csv))
    # the registry's gld23k default names the same csv
    assert_fd_equal(t_registry.load_data("gld23k", data_dir=str(gld), **kw),
                    a)


# --- UCI streams, VFL tables ---------------------------------------------------

def test_uci_streams_equal(tmp_path):
    rng = np.random.RandomState(0)
    susy = tmp_path / "SUSY.csv"
    susy.write_text("".join(
        ",".join([f"{rng.randint(0, 2)}.0"]
                 + [f"{v:.6f}" for v in rng.randn(18)]) + "\n"
        for _ in range(60)))
    ro = tmp_path / "datatraining.txt"
    ro.write_text('"id","date","T","H","L","CO2","HR","Occupancy"\n' + "".join(
        f'"{i}","2015-02-04 17:51:00",{rng.rand():.4f},{rng.rand():.4f},'
        f'{rng.rand():.4f},{rng.rand():.4f},{rng.rand():.6f},'
        f'{rng.randint(0, 2)}\n' for i in range(40)))
    for name, path in (("SUSY", susy), ("RO", ro)):
        kw = dict(client_list=[0, 1, 2], sample_num_in_total=30, beta=0.3,
                  seed=1)
        a = t_uci.load_streaming_uci(name, str(path), **kw)
        assert a == j_uci.load_streaming_uci(name, str(path), **kw)
        assert_arrays_equal(t_uci.streaming_to_arrays(a),
                            j_uci.streaming_to_arrays(a))
    assert t_uci.synthetic_stream(num_clients=5, total=80, beta=0.25) == \
        j_uci.synthetic_stream(num_clients=5, total=80, beta=0.25)


def test_vfl_tables_equal(tmp_path):
    rng = np.random.RandomState(0)
    n = 30
    lines = ["loan_status,emp_length,annual_inc,home_ownership,loan_amnt,"
             "int_rate,grade"]
    for _ in range(n):
        lines.append(",".join([
            rng.choice(["Fully Paid", "Charged Off", "Current"]),
            rng.choice(["1 year", "10+ years", ""]),
            f"{rng.rand() * 1e5:.1f}", rng.choice(["RENT", "OWN"]),
            f"{rng.rand() * 3e4:.1f}", f"{rng.rand() * 20:.2f}",
            rng.choice(["A", "B", "C"])]))
    (tmp_path / "loan.csv").write_text("\n".join(lines) + "\n")
    # JAX's loader encodes object columns, which pandas 3 reads as str:
    # the packages are held on the numeric columns, the port's encoding of
    # the text ones on their category codes
    numeric = tmp_path / "numeric"
    numeric.mkdir()
    keep = (0, 2, 4, 5)
    (numeric / "loan.csv").write_text("\n".join(
        ",".join(line.split(",")[i] for i in keep) for line in lines) + "\n")
    assert_arrays_equal(
        sum(t_tabular.load_lending_club_two_party(str(numeric)), []),
        sum(j_tabular.load_lending_club_two_party(str(numeric)), []))
    (xa, xb, y), _ = t_tabular.load_lending_club_two_party(str(tmp_path))
    assert xa.shape == (24, 4) and xb.shape == (24, 2)   # emp, home, grade
    assert np.isfinite(xa).all() and y.dtype == np.float32

    nus = tmp_path / "nus"
    for d in ("Low_Level_Features", "NUS_WID_Tags",
              "Groundtruth/TrainTestLabels"):
        (nus / d).mkdir(parents=True)
    for fn, dim in (("CH_Train.dat", 4), ("EDH_Train.dat", 3)):
        (nus / "Low_Level_Features" / fn).write_text("".join(
            " ".join(f"{v:.4f}" for v in rng.rand(dim)) + " \n"
            for _ in range(n)))
    (nus / "NUS_WID_Tags" / "Train_Tags1k.dat").write_text("".join(
        "\t".join(str(v) for v in rng.randint(0, 2, 5)) + "\t\n"
        for _ in range(n)))
    for lbl in ("sky", "clouds"):
        (nus / "Groundtruth" / "TrainTestLabels" /
         f"Labels_{lbl}_Train.txt").write_text("".join(
             f"{v}\n" for v in rng.randint(0, 2, n)))
    kw = dict(selected_labels=["sky", "clouds"], neg_label=0)
    assert_arrays_equal(
        sum(t_tabular.load_nus_wide_two_party(str(nus), **kw), []),
        sum(j_tabular.load_nus_wide_two_party(str(nus), **kw), []))
    assert_arrays_equal(
        sum(t_tabular.synthetic_vfl_parties(n_samples=50, seed=2), []),
        sum(j_tabular.synthetic_vfl_parties(n_samples=50, seed=2), []))


# --- edge-case poison ------------------------------------------------------------

def test_edge_case_sets_equal(tmp_path):
    rng = np.random.RandomState(0)
    xc = rng.rand(20, 8, 8, 3).astype(np.float32)
    yc = rng.randint(0, 10, 20).astype(np.int32)
    xp, yp = t_edge.apply_pixel_trigger(xc[:12], target_label=9)
    assert_arrays_equal((xp, yp), j_edge.apply_pixel_trigger(xc[:12], 9))
    for frac in (0.25, 0.5, 2.0):
        assert_arrays_equal(
            t_edge.make_poisoned_dataset(xc, yc, xp, yp, frac, seed=3),
            j_edge.make_poisoned_dataset(xc, yc, xp, yp, frac, seed=3))
    with open(tmp_path / "southwest_images_new_test.pkl", "wb") as f:
        pickle.dump(rng.randint(0, 256, (6, 32, 32, 3), dtype=np.uint8), f)
    p = str(tmp_path / "southwest_images_new_test.pkl")
    assert_arrays_equal(t_edge.load_external_poison(p, 9),
                        j_edge.load_external_poison(p, 9))
    ardis = tmp_path / "ardis"
    ardis.mkdir()
    torch.save(torch.utils.data.TensorDataset(
        torch.from_numpy(rng.randint(0, 256, (5, 1, 28, 28)).astype(
            np.float32)), torch.zeros(5)), ardis / "ardis_test_dataset.pt")
    for d in (str(tmp_path), str(ardis), None):
        a = t_edge.targeted_task_eval_set("cifar10", d, n=8, target_label=7)
        b = j_edge.targeted_task_eval_set("cifar10", d, n=8, target_label=7)
        assert_arrays_equal((a["x"], a["y"]), (b["x"], b["y"]))


# --- partitioners ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_partitions_equal_index_maps(seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, 600)

    def same(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])

    for alpha in (0.1, 0.5, 100.0):
        a = t_part.partition_dirichlet_hetero(labels, 8, 10, alpha, seed)
        same(a, j_part.partition_dirichlet_hetero(labels, 8, 10, alpha,
                                                  seed))
        assert min(len(v) for v in a.values()) >= 10
        assert t_part.record_data_stats(labels, a) == \
            j_part.record_data_stats(labels, a)
    same(t_part.partition_homo(103, 6, seed), j_part.partition_homo(103, 6,
                                                                    seed))
    dist = {0: {0: 3, 1: 2}, 1: {1: 4, 2: 1}}
    same(t_part.partition_from_distribution(labels, dist),
         j_part.partition_from_distribution(labels, dist))
    seg = [rng.choice([1, 2, 3, 5], rng.randint(1, 3)) for _ in range(200)]
    a = t_part.partition_dirichlet(seg, 4, [1, 2, 3, 5], 0.5,
                                   task="segmentation", seed=seed)
    same(a, j_part.partition_dirichlet(seg, 4, [1, 2, 3, 5], 0.5,
                                       task="segmentation", seed=seed))
    assert t_part.record_data_stats(seg, a, "segmentation") == \
        j_part.record_data_stats(seg, a, "segmentation")


def test_partition_global_rng_when_unseeded():
    labels = np.random.RandomState(3).randint(0, 5, 300)
    np.random.seed(11)
    a = t_part.partition_dirichlet_hetero(labels, 4, 5, 0.5)
    np.random.seed(11)
    b = j_part.partition_dirichlet_hetero(labels, 4, 5, 0.5)
    assert all(np.array_equal(a[k], b[k]) for k in b)


# --- key draws and augmentation ---------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
@pytest.mark.parametrize("shape", [(), (4,), (2, 3), (5, 1, 1)])
def test_bernoulli_and_randint_bit_equal(seed, shape):
    jk, tk = jax.random.key(seed), prng.key(seed)
    for p in (0.5, 0.1):
        assert np.array_equal(np.asarray(jax.random.bernoulli(jk, p, shape)),
                              prng.bernoulli(tk, p, shape).numpy())
    for lo, hi in ((0, 9), (0, 32), (-5, 100), (3, 3), (0, 2**31 - 1),
                   (-2**31, 2**31 - 1), (0, 70000)):
        want = np.asarray(jax.random.randint(jk, shape, lo, hi))
        got = prng.randint(tk, shape, lo, hi).numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got)


def _augment_pairs(size=24):
    """name -> (JAX function, port function), each ``f(key, x, mean,
    std)``."""
    def pair(name, *extra):
        jf, tf = getattr(j_aug, name), getattr(t_aug, name)
        return (lambda k, x, m, s: jf(k, x, *extra),
                lambda k, x, m, s: tf(k, x, *extra))

    def stats(name, *extra):
        return (lambda k, x, m, s: getattr(j_aug, name)(k, x, m, s, *extra),
                lambda k, x, m, s: getattr(t_aug, name)(k, x, m, s, *extra))

    def keyless(name, *extra):
        return (lambda k, x, m, s: getattr(j_aug, name)(x, *extra),
                lambda k, x, m, s: getattr(t_aug, name)(x, *extra))

    def keyless_stats(name):
        return (lambda k, x, m, s: getattr(j_aug, name)(x, m, s),
                lambda k, x, m, s: getattr(t_aug, name)(x, m, s))

    return {
        "random_flip": pair("random_flip"),
        "random_crop": pair("random_crop"),
        "random_crop_pad2": pair("random_crop", 2),
        "cutout": pair("cutout"),
        "cutout_7": pair("cutout", 7),
        "cifar_train_augment": stats("cifar_train_augment"),
        "random_crop_to": pair("random_crop_to", size),
        "fed_cifar100_train_augment": stats("fed_cifar100_train_augment"),
        "normalize": keyless_stats("normalize"),
        "center_crop": keyless("center_crop", size),
        "fed_cifar100_eval_transform": keyless_stats(
            "fed_cifar100_eval_transform"),
    }


@pytest.mark.parametrize("lead, seed", [((), 0), ((4,), 5), ((2, 3), 99)])
def test_augment_bit_equal(lead, seed):
    """Each function equals the port bit for bit for two keys and the
    leading dims, with the CIFAR-100 statistics.  The JAX functions run in one
    jit with the statistics as arguments, so XLA divides by ``std`` as
    the unjitted functions do (a constant ``std`` it folds into a
    multiply by its reciprocal: `test_augment_under_jit_within_one_ulp`)."""
    x = np.random.RandomState(len(lead)).rand(*lead, 32, 32, 3).astype(
        np.float32)
    m, s = t_aug.CIFAR100_MEAN, t_aug.CIFAR100_STD
    pairs = _augment_pairs()
    everything = jax.jit(lambda k, v, jm, js: {
        name: jf(k, v, jm, js) for name, (jf, _) in pairs.items()})
    for key in (seed, seed + 1):
        want = everything(jax.random.key(key), jnp.asarray(x),
                          *(jnp.asarray(v, jnp.float32) for v in (m, s)))
        for name, (_, tf) in pairs.items():
            got = tf(prng.key(key), torch.from_numpy(x), m, s).numpy()
            w = np.asarray(want[name])
            assert w.dtype == got.dtype and w.shape == got.shape, name
            assert w.tobytes() == got.tobytes(), (name, key)


def test_augment_under_jit_within_one_ulp():
    """With the statistics as jit constants, XLA folds the divide by
    ``std`` into a multiply by its reciprocal, so JAX's jitted pipelines
    sit within 1 ulp of the port (and of JAX's own unjitted functions)."""
    x = np.random.RandomState(1).rand(4, 32, 32, 3).astype(np.float32)
    m, s = t_aug.CIFAR10_MEAN, t_aug.CIFAR10_STD
    for name in ("cifar_train_augment", "fed_cifar100_train_augment"):
        jf, tf = getattr(j_aug, name), getattr(t_aug, name)
        want = np.asarray(jax.jit(lambda k, v: jf(k, v, m, s))(
            jax.random.key(2), jnp.asarray(x)))
        got = tf(prng.key(2), torch.from_numpy(x), m, s).numpy()
        dist = np.abs(want.view(np.int32).astype(np.int64)
                      - got.view(np.int32).astype(np.int64)).max()
        assert dist <= 1, name
    # called as they are, JAX's functions are bit-equal to the port
    want = np.asarray(j_aug.normalize(jnp.asarray(x), m, s))
    assert want.tobytes() == t_aug.normalize(torch.from_numpy(x), m,
                                             s).numpy().tobytes()


# --- tag prediction ------------------------------------------------------------------

def test_tag_prediction_workload_matches_jax():
    from fedml_tpu.models import LogisticRegression as JLR
    from fedml_tpu.trainer.workload import TagPredictionWorkload as JTag
    from fedml_tpu_torch.experiments.models import create_workload
    from fedml_tpu_torch.utils.jax_params import params_from_numpy
    rng = np.random.RandomState(0)
    d, c, n = 40, 6, 9
    batch = {"x": rng.rand(n, d).astype(np.float32) * 3 - 1.5,
             "y": (rng.rand(n, c) < 0.3).astype(np.float32),
             "mask": np.r_[np.ones(n - 2), np.zeros(2)].astype(np.float32)}
    jwl = JTag(JLR(d, c))
    jp = jax.jit(jwl.model.init)(jax.random.key(0), batch["x"][:1])["params"]
    jp = jax.tree.map(lambda v: np.asarray(v) * 4, jp)  # logits of both signs
    twl = create_workload("lr", "stackoverflow_lr", c, (d,))
    assert twl.loss_fn.__qualname__.startswith("TagPredictionWorkload")
    tp = params_from_numpy(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = float(jax.jit(lambda p, b: jwl.loss_fn(p, b, None, True)[0])(
        jp, jb))
    tloss = float(twl.loss_fn(tp, tb)[0])
    assert tloss == pytest.approx(jloss, rel=1e-6)
    jm = jax.jit(jwl.metric_fn)(jp, jb)
    tm = twl.metric_fn(tp, tb)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6,
                                             abs=1e-12), k
    # the evaluators sum the two extra keys over a [S, B] stack
    from fedml_tpu.trainer.local_sgd import make_evaluator as j_evaluator
    from fedml_tpu_torch.trainer.local_sgd import make_evaluator
    stack = {k: v[:8].reshape((2, 4) + v.shape[1:]) for k, v in batch.items()}
    je = jax.jit(j_evaluator(jwl))(
        jp, {k: jnp.asarray(v) for k, v in stack.items()})
    te = make_evaluator(twl)(tp, {k: torch.from_numpy(v)
                                  for k, v in stack.items()})
    assert {"precision_sum", "recall_sum"} <= set(te)
    for k in je:
        assert float(te[k]) == pytest.approx(float(je[k]), rel=1e-6,
                                             abs=1e-12), k


# --- memmap staging --------------------------------------------------------------------

def test_memmap_rounds_bit_equal_to_memory(tmp_path, monkeypatch):
    """A corpus saved with `save_stacked` and memory-mapped back trains
    bit-equal to the same split in memory; over the device-data budget the
    map stays a map and each round gathers only its cohort's rows."""
    from fedml_tpu_torch.algorithms.fedavg import (FedAvg, FedAvgConfig,
                                                   split_nbytes)
    from fedml_tpu_torch.data.stacking import (FederatedData,
                                               load_stacked_memmap,
                                               save_stacked,
                                               stack_client_data)
    from fedml_tpu_torch.models import LogisticRegression
    from fedml_tpu_torch.trainer.workload import ClassificationWorkload
    rng = np.random.RandomState(0)
    xs = [rng.randn(12, 6).astype(np.float32) for _ in range(20)]
    ys = [rng.randint(0, 3, 12).astype(np.int32) for _ in range(20)]
    stacked = stack_client_data(xs, ys, batch_size=6)
    save_stacked(stacked, str(tmp_path / "corpus"))
    mm = load_stacked_memmap(str(tmp_path / "corpus"))
    assert all(isinstance(v, np.memmap) and not v.flags.writeable
               for v in mm.values())
    assert split_nbytes(mm) == split_nbytes(stacked)
    monkeypatch.setenv("FEDML_TPU_DEVICE_DATA_BYTES", "0")
    gathered = []
    real_getitem = np.memmap.__getitem__

    def spy(self, idx):
        out = real_getitem(self, idx)
        gathered.append(out.shape[0] if np.ndim(out) else 0)
        return out
    cfg = FedAvgConfig(comm_round=2, client_num_per_round=4, epochs=1,
                       batch_size=6, lr=0.2, frequency_of_the_test=100)

    def run_with(train):
        data = FederatedData(client_num=20, class_num=3, train=train,
                             test=train)
        wl = ClassificationWorkload(LogisticRegression(6, 3), num_classes=3,
                                    grad_clip_norm=None)
        algo = FedAvg(wl, data, cfg, device="cpu")
        params = algo.run()
        assert algo._train_dev is None          # the host gather
        return params

    p_ram = run_with(stacked)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(np.memmap, "__getitem__", spy)
        p_mm = run_with(mm)
    assert all(p_ram[k].numpy().tobytes() == p_mm[k].numpy().tobytes()
               for k in p_ram)
    assert 4 in gathered and max(gathered) <= 20


# --- registry and CLI ---------------------------------------------------------------------

def test_registry_names_and_errors(tmp_path):
    assert t_registry.dataset_names() == j_registry.dataset_names()
    for mod in (t_registry, j_registry):
        with pytest.raises(KeyError):
            mod.load_data("no_such_set")
        with pytest.raises(FileNotFoundError, match="does not exist"):
            mod.load_data("mnist", data_dir=str(tmp_path / "missing"))
        with pytest.raises(FileNotFoundError, match="synthetic fallback"):
            mod.load_data("femnist", synthetic_ok=False)
        with pytest.raises(TypeError, match="unknown option"):
            mod.load_data("femnist", data_dir=str(tmp_path), batch_sise=3)
    t_h5.fake_femnist_h5(str(tmp_path), num_clients=2, samples=4)
    # a twin-only option is dropped quietly by the on-disk loader
    assert_fd_equal(
        t_registry.load_data("femnist", data_dir=str(tmp_path),
                             num_clients=9, batch_size=3),
        j_registry.load_data("femnist", data_dir=str(tmp_path),
                             num_clients=9, batch_size=3))


def test_registry_register_dataset():
    calls = []

    def twin(num_clients=1, seed=0):
        calls.append((num_clients, seed))
        return "twin"
    t_registry.register_dataset("_test_set", lambda data_dir: "disk", twin,
                                seed=1)
    try:
        assert t_registry.load_data("_test_set", num_clients=3,
                                    extra=1) == "twin"
        assert calls == [(3, 0)]
    finally:
        del t_registry._REGISTRY["_test_set"]


def test_cli_cifar10_hetero_from_pickles(tmp_path):
    """``--dataset cifar10 --data_dir --partition_method hetero``: both
    packages' CLI loaders give the same clients, byte for byte, and both
    CLIs run a round on the CPU."""
    import importlib
    j_config = importlib.import_module("fedml_tpu.experiments.config")
    j_main = importlib.import_module("fedml_tpu.experiments.main")
    t_config = importlib.import_module("fedml_tpu_torch.experiments.config")
    t_main = importlib.import_module("fedml_tpu_torch.experiments.main")
    _write_cifar(tmp_path / "data", per=48, n_test=24)
    argv = ["--algo", "fedavg", "--model", "lr", "--dataset", "cifar10",
            "--data_dir", str(tmp_path / "data"), "--partition_method",
            "hetero", "--partition_alpha", "0.5", "--client_num_in_total",
            "4", "--client_num_per_round", "2", "--batch_size", "16",
            "--comm_round", "1", "--frequency_of_the_test", "1", "--seed",
            "2", "--platform", "cpu"]
    tcfg, jcfg = (t_config.config_from_argv(argv),
                  j_config.config_from_argv(argv))
    assert (tcfg.partition_method, tcfg.partition_alpha) == ("hetero", 0.5)
    a = t_main.load_experiment_data(tcfg)
    assert_fd_equal(a, j_main.load_experiment_data(jcfg))
    assert a.client_num == 4 and a.train["num_samples"].sum() == 240
    t_sum = t_main.main([*argv, "--run_dir", str(tmp_path / "t"),
                         "--log_stdout", "false"])
    j_sum = j_main.main([*argv, "--run_dir", str(tmp_path / "j")])
    assert t_sum["params_finite"]
    assert {"train_acc", "test_acc"} <= set(t_sum) & set(j_sum)


def test_cli_missing_data_dir_raises(tmp_path):
    import importlib
    t_main = importlib.import_module("fedml_tpu_torch.experiments.main")
    with pytest.raises(FileNotFoundError):
        t_main.main(["--dataset", "mnist", "--data_dir",
                     str(tmp_path / "nope"), "--platform", "cpu",
                     "--comm_round", "1", "--log_stdout", "false"])


def test_evaluator_chunks_the_steps_axis(monkeypatch):
    """A stack over `EVAL_ROWS` rows is evaluated in chunks of its steps
    axis (a full-size CIFAR-10 split padded by the hetero partition is
    ~260k rows): the counts equal the whole stack's, the float sums
    within 1e-6 relative."""
    from fedml_tpu_torch.models import LogisticRegression
    from fedml_tpu_torch.trainer import local_sgd
    from fedml_tpu_torch.trainer.workload import ClassificationWorkload
    wl = ClassificationWorkload(LogisticRegression(5, 7), num_classes=7)
    params = wl.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    data = {"x": torch.from_numpy(rng.randn(3, 7, 4, 5).astype(np.float32)),
            "y": torch.from_numpy(rng.randint(0, 7, (3, 7, 4))),
            "mask": torch.from_numpy((rng.rand(3, 7, 4) < 0.8)
                                     .astype(np.float32))}
    whole = local_sgd.make_evaluator(wl)(params, data)
    calls = []
    spy = dataclasses.replace(wl, metric_fn=lambda p, b: calls.append(
        len(b["mask"])) or wl.metric_fn(p, b))
    monkeypatch.setattr(local_sgd, "EVAL_ROWS", 30)
    chunked = local_sgd.make_evaluator(spy)(params, data)
    assert calls == [24, 24, 24, 12]            # 2 steps of 3 x 4 rows
    for k in ("correct", "total", "correct_top5"):
        assert float(chunked[k]) == float(whole[k])
    assert float(chunked["loss_sum"]) == pytest.approx(
        float(whole["loss_sum"]), rel=1e-6)
