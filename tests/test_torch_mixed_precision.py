"""Mixed precision (``compute_dtype=bfloat16``) of the port against the
JAX package's: the workloads' casts, the norms' flax order under bf16,
and FedAvg rounds from the same weights and cohorts.

Limits.  A bf16 norm (LayerNorm, GroupNorm, BatchNorm) equals flax's
within one bf16 rounding of its output (``NORM_ULP`` x |ref|: the f32
statistics are summed in another order, which can flip the last bit of
the rounded output).  A bf16 round (each client's bf16 forward and
backward, f32 masters and SGD) equals the JAX package's within
``BF16_ROUND_TOL`` (5e-3, about twice the worst case seen here: 2.4e-3
for the dense transformer, whose weights move 0.17 at lr 0.5; a round
must move them by more than 3x the limit) on the new global: the CPU's
bf16 products are
rounded at other places by torch and by XLA (a convolution's or a
matmul's bias added before or after the output's rounding; an
elementwise chain fused or not), each such difference is one bf16 ulp
(2^-8 relative) of an activation or gradient, and the round moves the
weights by ``lr x`` those gradients.  The f32 paths are held elsewhere
bit for bit or at 1e-4 and are not touched by this file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from fedml_tpu.algorithms import FedAvg as JFedAvg
from fedml_tpu.algorithms import FedAvgConfig as JFedAvgConfig
from fedml_tpu.data.synthetic import (
    synthetic_federated_dataset as j_synthetic)
from fedml_tpu.models import RNNOriginalFedAvg as JRNN
from fedml_tpu.models import TransformerLM as JTransformerLM
from fedml_tpu.models.resnet import CifarResNet as JCifarResNet
from fedml_tpu.trainer.local_sgd import make_local_trainer as j_local_trainer
from fedml_tpu.trainer.workload import (
    ClassificationWorkload as JClassificationWorkload)
from fedml_tpu.trainer.workload import NWPWorkload as JNWPWorkload
from fedml_tpu.trainer.workload import make_client_optimizer as j_opt
from fedml_tpu_torch.algorithms import FedAvg, FedAvgConfig
from fedml_tpu_torch.data.synthetic import synthetic_federated_dataset
from fedml_tpu_torch.models import RNNOriginalFedAvg, TransformerLM
from fedml_tpu_torch.models.layers import Dense, LayerNorm
from fedml_tpu_torch.models.norms import BatchNorm, GroupNorm
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.trainer.local_sgd import make_local_trainer
from fedml_tpu_torch.trainer.workload import (ClassificationWorkload,
                                              NWPWorkload, cast_floats,
                                              compute_dtype_of,
                                              make_client_optimizer)
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy

BF = torch.bfloat16
NORM_ULP = 2.0 ** -7           # one bf16 ulp at [1, 2), relative
BF16_ROUND_TOL = 5e-3          # bf16 round vs JAX's, on the new global


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_trees(got, want, tol):
    worst = 0.0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        worst = max(worst, float(np.abs(np.asarray(a, np.float32)
                                        - np.asarray(b, np.float32)).max()))
    assert worst <= tol, worst
    return worst


def test_cast_floats_and_dtype_names():
    tree = {"w": torch.ones(2), "ids": torch.arange(3)}
    out = cast_floats(tree, BF)
    assert out["w"].dtype == BF and out["ids"].dtype == torch.int64
    assert compute_dtype_of("bfloat16") is BF
    assert compute_dtype_of("") is None and compute_dtype_of(None) is None
    with pytest.raises(ValueError, match="compute_dtype"):
        compute_dtype_of("int8")


def _bf16_pair(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3 + 1
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.tensor(np.asarray(xj.astype(jnp.float32))).to(BF)


def _ulp_close(got, want):
    got = got.float().detach().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.all(np.abs(got - want) <= NORM_ULP * np.abs(want) + 1e-30), \
        np.abs(got - want).max()


@pytest.mark.parametrize("norm", ["layer", "group", "batch_train",
                                  "batch_eval"])
def test_bf16_norms_follow_flax(norm):
    """bf16 input and bf16 (cast) scale and bias: f32 statistics, the f32
    normalisation, one cast to bf16 at the end, as flax 0.12; running
    statistics f32."""
    rng = np.random.RandomState(1)
    scale = (1 + 0.1 * rng.randn(8)).astype(np.float32)
    bias = (0.1 * rng.randn(8)).astype(np.float32)
    p = {"scale": jnp.asarray(scale, jnp.bfloat16),
         "bias": jnp.asarray(bias, jnp.bfloat16)}
    tp = {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(BF)
          for k, v in p.items()}
    if norm == "layer":
        xj, xt = _bf16_pair((4, 6, 8), 2)
        want = fnn.LayerNorm(dtype=jnp.bfloat16).apply({"params": p}, xj)
        layer = LayerNorm(8, dtype=BF)
        got = torch.func.functional_call(layer, tp, (xt,))
    elif norm == "group":
        xj, xt = _bf16_pair((2, 5, 5, 8), 3)               # NHWC for flax
        want = fnn.GroupNorm(num_groups=2).apply({"params": p}, xj)
        got = torch.func.functional_call(
            GroupNorm(8, 2), tp, (xt.permute(0, 3, 1, 2),)).permute(
                0, 2, 3, 1)
    else:
        train = norm == "batch_train"
        xj, xt = _bf16_pair((6, 8), 4)
        stats = {"mean": jnp.asarray(rng.randn(8), jnp.float32),
                 "var": jnp.asarray(rng.rand(8) + 0.5, jnp.float32)}
        bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                           epsilon=1e-5)
        want, new = bn.apply({"params": p, "batch_stats": stats}, xj,
                             mutable=["batch_stats"])
        layer = BatchNorm(8)
        bufs = {k: torch.tensor(np.asarray(v)) for k, v in stats.items()}
        from fedml_tpu_torch.models.norms import batch_stats_collector
        if train:
            with batch_stats_collector() as col:
                got = torch.func.functional_call(layer, {**tp, **bufs},
                                                 (xt,))
        else:
            got = torch.func.functional_call(layer, {**tp, **bufs}, (xt,))
        if train:
            mean, var = col[layer]
            assert mean.dtype == var.dtype == torch.float32
            np.testing.assert_allclose(
                mean.numpy(), np.asarray(new["batch_stats"]["mean"]),
                rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(
                var.numpy(), np.asarray(new["batch_stats"]["var"]),
                rtol=1e-5, atol=1e-6)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _ulp_close(got, want)


# ---------------------------------------------------------------------------
# classification rounds: GroupNorm and BatchNorm ResNets at 8x8
# ---------------------------------------------------------------------------

def _image_data(num_classes=4, n=6):
    kw = dict(num_clients=n, samples_per_client=6, sample_shape=(8, 8, 3),
              class_num=num_classes, batch_size=3, seed=3)
    return j_synthetic(**kw), synthetic_federated_dataset(**kw)


@pytest.mark.parametrize("norm", ["batch"])
def test_bf16_classification_round_matches_jax(norm):
    """One FedAvg round (3 of 6 clients, 2 steps of B=3, SGD lr 0.1) of
    a (1, 1, 1) BatchNorm CIFAR ResNet under compute_dtype bf16: the
    global and the running statistics within BF16_ROUND_TOL of JAX's,
    every leaf f32.  (GroupNorm under bf16 is held by the norm test
    above and by EfficientNet's and VGG's rounds on the card.)"""
    stateful = norm == "batch"
    j_data, t_data = _image_data()
    jwl = JClassificationWorkload(
        JCifarResNet(layers=(1, 1, 1), num_classes=4, norm=norm), 4,
        stateful=stateful, compute_dtype=jnp.bfloat16)
    twl = ClassificationWorkload(
        CifarResNet((1, 1, 1), num_classes=4, norm=norm), 4,
        stateful=stateful, compute_dtype="bfloat16")
    p0 = jwl.init(jax.random.key(0), {"x": np.zeros((1, 8, 8, 3),
                                                    np.float32)})
    common = dict(comm_round=1, client_num_per_round=3, batch_size=3,
                  lr=0.1, frequency_of_the_test=1000)
    want = JFedAvg(jwl, j_data, JFedAvgConfig(**common)).run(params=p0)
    got = FedAvg(twl, t_data, FedAvgConfig(**common), device="cpu").run(
        params=params_from_numpy(_np(p0)))
    assert all(v.dtype == torch.float32 for v in got.values())
    _close_trees(params_to_numpy(got), _np(want), BF16_ROUND_TOL)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(p0)))
    assert moved > 3 * BF16_ROUND_TOL


class _TinyBN(torch.nn.Module):
    """tests/test_models_cv.py's TinyBN: Dense(8) -> BatchNorm -> Dense(3)."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(6, 8)
        self.BatchNorm_0 = BatchNorm(8, momentum=0.99)   # flax's default
        self.Dense_1 = Dense(8, 3)

    def forward(self, x):
        x = self.Dense_0(x.reshape(x.shape[0], -1))
        return self.Dense_1(self.BatchNorm_0(x))


class _JTinyBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Dense(8)(x.reshape((x.shape[0], -1)))
        x = fnn.BatchNorm(use_running_average=not train)(x)
        return fnn.Dense(3)(x)


def test_bf16_stateful_batch_stats_stay_f32():
    """``test_models_cv.py::test_bf16_stateful_batch_stats_stay_f32`` on
    the port, and against JAX: one local step of SGD under bf16 keeps
    every leaf f32, moves the running mean, and lands within
    BF16_ROUND_TOL of JAX's step."""
    jwl = JClassificationWorkload(_JTinyBN(), 3, stateful=True,
                                  compute_dtype=jnp.bfloat16)
    rng = np.random.RandomState(0)
    data = {"x": rng.randn(2, 4, 6).astype(np.float32),
            "y": rng.randint(0, 3, (2, 4)).astype(np.int32),
            "mask": np.ones((2, 4), np.float32)}
    params = jwl.init(jax.random.key(0), jax.tree.map(lambda v: v[0], data))
    want, _ = j_local_trainer(jwl, j_opt("sgd", 0.1), 1)(
        params, jax.tree.map(jnp.asarray, data), jax.random.key(1))
    twl = ClassificationWorkload(_TinyBN(), 3, stateful=True,
                                 compute_dtype=BF)
    local = make_local_trainer(twl, make_client_optimizer("sgd", 0.1), 1)
    tp = params_from_numpy(_np(params))
    got, _ = local(tp, {k: torch.tensor(v) for k, v in data.items()})
    assert all(v.dtype == torch.float32 for v in got.values())
    key = "batch_stats/BatchNorm_0/mean"
    assert not np.allclose(got[key].numpy(), tp[key].numpy())
    _close_trees(params_to_numpy(got), _np(want), BF16_ROUND_TOL)


# ---------------------------------------------------------------------------
# next-word rounds: the transformer (dense, MoE, flash) and the LSTM
# ---------------------------------------------------------------------------

VOCAB = 30
LM = dict(vocab_size=VOCAB, d_model=32, n_heads=2, d_ff=64, max_len=128,
          n_layers=1)


def _nwp_round(jmodel, tmodels, t, lr=0.5):
    """One bf16 FedAvg round of JAX's ``jmodel`` and of each of the port's
    ``tmodels`` from the same init and cohort; each port global within
    BF16_ROUND_TOL of JAX's."""
    kw = dict(num_clients=6, samples_per_client=4, sample_shape=(t,),
              sequence_vocab=VOCAB, class_num=VOCAB, batch_size=2, seed=1)
    j_data, t_data = j_synthetic(**kw), synthetic_federated_dataset(**kw)
    jwl = JNWPWorkload(jmodel, compute_dtype=jnp.bfloat16)
    p0 = jwl.init(jax.random.key(3), {"x": np.zeros((1, t), np.int32)})
    common = dict(comm_round=1, client_num_per_round=3, batch_size=2,
                  lr=lr, frequency_of_the_test=1000)
    want = JFedAvg(jwl, j_data, JFedAvgConfig(**common)).run(params=p0)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(p0)))
    assert moved > 3 * BF16_ROUND_TOL
    for tmodel in tmodels:
        got = FedAvg(NWPWorkload(tmodel, compute_dtype=BF), t_data,
                     FedAvgConfig(**common), device="cpu").run(
            params=params_from_numpy(_np(p0)))
        assert all(v.dtype == torch.float32 for v in got.values())
        _close_trees(params_to_numpy(got), _np(want), BF16_ROUND_TOL)


@pytest.mark.parametrize("variant", ["dense_and_flash", "moe"])
def test_bf16_transformer_round_matches_jax(variant):
    """One bf16 FedAvg round of a 1-layer transformer against JAX's: at
    T=128 the port's dense path and its flash path (the plain bf16
    halves on the CPU) against JAX's dense path (JAX's flash kernel
    needs a TPU); the Switch MoE (8 experts) at T=16."""
    if variant == "moe":
        _nwp_round(JTransformerLM(**LM, moe_experts=8, dtype=jnp.bfloat16),
                   [TransformerLM(**LM, moe_experts=8, dtype=BF)], 16)
    else:
        _nwp_round(JTransformerLM(**LM, dtype=jnp.bfloat16),
                   [TransformerLM(**LM, dtype=BF),
                    TransformerLM(**LM, dtype=BF, use_flash=True)], 128)


def test_bf16_lstm_round_matches_jax():
    """The Shakespeare LSTM (narrowed to hidden 32) under bf16: f32
    carry, bf16 projections, as flax's OptimizedLSTMCell; one round
    within BF16_ROUND_TOL of JAX's."""
    _nwp_round(JRNN(vocab_size=VOCAB, hidden_size=32, dtype=jnp.bfloat16),
               [RNNOriginalFedAvg(vocab_size=VOCAB, hidden_size=32,
                                  dtype=BF)], 12)


# ---------------------------------------------------------------------------
# the f32-vs-bf16 oracle (tests/test_fedavg_oracle.py, fewer rounds)
# ---------------------------------------------------------------------------

class _Linear(torch.nn.Module):
    def __init__(self, d, classes=4):
        super().__init__()
        self.Dense_0 = Dense(d, classes)

    def forward(self, x):
        return self.Dense_0(x.reshape(x.shape[0], -1))


def test_bf16_tracks_f32_oracle():
    """compute_dtype bf16 on a linear model: master params stay f32, both
    runs learn, and bf16 tracks f32 within the JAX test's 0.08 over its
    20 rounds."""
    rng = np.random.RandomState(8)       # _synthetic_clients(6, seed=8)
    w = rng.randn(12, 4)
    xs, ys = [], []
    for _ in range(6):
        n = rng.randint(6, 21)
        x = rng.randn(n, 12).astype(np.float32)
        xs.append(x)
        ys.append(np.argmax(x @ w + 0.1 * rng.randn(n, 4), axis=1)
                  .astype(np.int32))
    from fedml_tpu_torch.data.stacking import (FederatedData,
                                               stack_client_data)
    train = stack_client_data(xs, ys, 32)
    data = FederatedData(client_num=6, class_num=4, train=train, test=train)
    cfg = FedAvgConfig(comm_round=20, client_num_per_round=6, epochs=1,
                       batch_size=32, lr=0.3, frequency_of_the_test=100)
    runs = {}
    for name, dt in (("f32", None), ("bf16", BF)):
        wl = ClassificationWorkload(_Linear(12), 4, grad_clip_norm=None,
                                    compute_dtype=dt)
        algo = FedAvg(wl, data, cfg, device="cpu")
        p0 = wl.init(torch.Generator().manual_seed(4))
        p = algo.run(params=p0)
        assert all(v.dtype == torch.float32 for v in p.values())
        runs[name] = (p, algo.evaluate_global(p)["train_acc"])
    assert runs["bf16"][1] > 0.9 and runs["f32"][1] > 0.9
    for k in runs["f32"][0]:
        np.testing.assert_allclose(runs["f32"][0][k].numpy(),
                                   runs["bf16"][0][k].numpy(), atol=0.08)
