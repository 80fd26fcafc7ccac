"""One client's local run in the port against the JAX package's
``make_local_trainer`` from carried weights, within 1e-5: SGD and AMSGrad
(with weight decay), global-norm grad clipping on, a fully padded batch
and two epochs.  And the cohort engine's two client axes agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import CNNOriginalFedAvg as JCNN
from fedml_tpu.models import LogisticRegression as JLR
from fedml_tpu.parallel.cohort import make_cohort_step as j_step
from fedml_tpu.trainer.local_sgd import make_local_trainer as j_trainer
from fedml_tpu.trainer.workload import ClassificationWorkload as JWorkload
from fedml_tpu.trainer.workload import make_client_optimizer as j_opt
from fedml_tpu_torch.models import CNNOriginalFedAvg, LogisticRegression
from fedml_tpu_torch.parallel.cohort import make_cohort_step
from fedml_tpu_torch.trainer.local_sgd import (clip_by_global_norm,
                                               make_local_trainer)
from fedml_tpu_torch.trainer.workload import (ClassificationWorkload,
                                              make_client_optimizer)
from fedml_tpu_torch.utils.jax_params import params_from_numpy, params_to_numpy


def _client(rng, steps, batch, shape, classes, live):
    """[S, B, ...] batches; only the first ``live`` samples are real, so
    trailing batches can be fully padded."""
    x = rng.randn(steps, batch, *shape).astype(np.float32)
    y = rng.randint(0, classes, (steps, batch)).astype(np.int32)
    mask = (np.arange(steps * batch) < live).astype(np.float32)
    return {"x": x, "y": y, "mask": mask.reshape(steps, batch)}


def _pair(kind, classes):
    if kind == "lr":
        return JLR(12, classes), LogisticRegression(12, classes), (12,)
    return (JCNN(only_digits=True), CNNOriginalFedAvg(only_digits=True),
            (28, 28, 1))


@pytest.mark.parametrize("kind,opt,lr,epochs", [
    ("lr", "sgd", 2.0, 2),
    ("lr", "adam", 0.05, 2),
    ("cnn", "sgd", 0.1, 1),
    # AMSGrad's first step is g / (|g| + 1e-8): where a CNN gradient sits
    # within a few eps of 0, f32 rounding of g moves the step by up to lr,
    # so this case runs at an lr that keeps that inside the tolerance
    ("cnn", "adam", 2e-5, 1),
])
def test_local_run_matches_jax(rng, kind, opt, lr, epochs):
    classes = 10 if kind == "cnn" else 4
    jm, tm, shape = _pair(kind, classes)
    data = _client(rng, 3, 4, shape, classes, live=6)   # batch 3 is padding
    jwl = JWorkload(jm, num_classes=classes, grad_clip_norm=1.0)
    twl = ClassificationWorkload(tm, num_classes=classes, grad_clip_norm=1.0)
    p0 = jwl.init(jax.random.key(0), {k: v[0] for k, v in data.items()})
    want, jmet = j_trainer(jwl, j_opt(opt, lr, wd=1e-3), epochs)(
        p0, jax.tree.map(jnp.asarray, data), jax.random.key(1))
    got, tmet = make_local_trainer(twl, make_client_optimizer(opt, lr, 1e-3),
                                   epochs)(
        params_from_numpy(jax.tree.map(np.asarray, p0)),
        {k: torch.tensor(v) for k, v in data.items()})
    moved = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - b).max()),
                         want, jax.tree.map(np.asarray, p0))
    # training moved the weights by more than the tolerance
    assert max(jax.tree.leaves(moved)) > 2e-5
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-5, rtol=0), params_to_numpy(got), want)
    np.testing.assert_allclose(tmet["train_loss_per_step"].numpy(),
                               np.asarray(jmet["train_loss_per_step"]),
                               atol=1e-5)


def test_clip_by_global_norm_has_no_epsilon():
    g = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    out = clip_by_global_norm(g, 1.0)
    assert out["a"].item() == pytest.approx(0.6, rel=1e-6)
    assert out["b"].item() == pytest.approx(0.8, rel=1e-6)
    same = clip_by_global_norm(g, 5.5)
    assert torch.equal(same["a"], g["a"])


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fully_padded_client_is_untouched(rng, opt):
    twl = ClassificationWorkload(LogisticRegression(12, 4), num_classes=4)
    p = twl.init(torch.Generator().manual_seed(0))
    data = _client(rng, 2, 3, (12,), 4, live=0)
    got, _ = make_local_trainer(twl, make_client_optimizer(opt, 0.1, 1e-3),
                                2)(p, {k: torch.tensor(v)
                                       for k, v in data.items()})
    assert all(torch.equal(got[k], p[k]) for k in p)


def _cohort(rng, n, shape, classes):
    clients = [_client(rng, 2, 4, shape, classes, live=rng.randint(1, 9))
               for _ in range(n)]
    out = {k: np.stack([c[k] for c in clients]) for k in clients[0]}
    out["num_samples"] = out["mask"].sum(axis=(1, 2))
    return out


@pytest.mark.parametrize("kind", ["lr", "cnn"])
def test_scan_equals_vmap_and_jax(rng, kind):
    """client_axis 'scan' (a loop, dense convs) == 'vmap' (grouped convs)
    within 1e-6, and both equal the JAX cohort step within 1e-5."""
    classes = 10 if kind == "cnn" else 4
    jm, tm, shape = _pair(kind, classes)
    cohort = _cohort(rng, 3, shape, classes)
    jwl = JWorkload(jm, num_classes=classes, grad_clip_norm=1.0)
    twl = ClassificationWorkload(tm, num_classes=classes, grad_clip_norm=1.0)
    p0 = jwl.init(jax.random.key(0),
                  {k: v[0, 0] for k, v in cohort.items() if k != "num_samples"})
    tp0 = params_from_numpy(jax.tree.map(np.asarray, p0))
    local = make_local_trainer(twl, make_client_optimizer("sgd", 0.1), 2)
    tc = {k: torch.tensor(v) for k, v in cohort.items()}
    agg_v, m_v = make_cohort_step(local)(tp0, tc)
    agg_s, m_s = make_cohort_step(local, client_axis="scan")(tp0, tc)
    for k in agg_v:
        torch.testing.assert_close(agg_v[k], agg_s[k], atol=1e-6, rtol=0)
    torch.testing.assert_close(m_v["train_loss_per_step"],
                               m_s["train_loss_per_step"], atol=1e-6, rtol=0)
    want, _ = j_step(j_trainer(jwl, j_opt("sgd", 0.1), 2))(
        p0, jax.tree.map(jnp.asarray, cohort), jax.random.key(3))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-5, rtol=0), params_to_numpy(agg_v), want)
    with pytest.raises(ValueError, match="client_axis"):
        make_cohort_step(local, client_axis="pmap")(tp0, tc)
