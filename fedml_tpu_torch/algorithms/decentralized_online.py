"""Decentralized online learning: DSGD and PushSum over directed graphs
(port of ``fedml_tpu/algorithms/decentralized_online.py``).

Each iteration every node takes one streaming sample, computes the BCE
gradient at its consensus iterate z, applies it to its auxiliary variable
x, then receives its in-neighbours' x with the sender-row weights of the
mixing matrix (``x <- Wᵀ x``).  PushSum also pushes the weights ``omega
<- Wᵀ omega`` and de-biases with ``z = x / omega``; the topology may be
regenerated every iteration from ``seed = t`` (``time_varying``).  Mode
``"LOCAL"`` trains without mixing.  The average regret after t+1
iterations is ``sum(losses) / (N * (t + 1))``.

Node states live stacked on a leading ``nodes`` axis; the per-node
gradient is one ``torch.func.vmap`` of ``grad_and_value``, the exchange
one ``[N, N] @ [N, D]`` matmul per leaf.  JAX scans the T·epochs
iterations inside one jit; here the same step is a host loop on the CPU
and, on the card, one captured CUDA graph replayed once an iteration
(the step is a few dozen small kernels: eager, the loop is
launch-bound).  The sample of iteration i is at ``i % T`` of the
stream."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from fedml_tpu_torch.core.pytree import Tree, tree_keys
from fedml_tpu_torch.core.topology import (AsymmetricTopologyManager,
                                           SymmetricTopologyManager)
from fedml_tpu_torch.data.uci import streaming_to_arrays
from fedml_tpu_torch.device import resolve_device

MODES = ("DOL", "PUSHSUM", "LOCAL")


@dataclasses.dataclass
class DecentralizedOnlineConfig:
    mode: str = "DOL"                # "DOL" | "PUSHSUM" | "LOCAL"
    iteration_number: int = 100      # T: stream length per client
    epochs: int = 1                  # total iterations = T * epochs
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    b_symmetric: bool = False
    topology_neighbors_num_undirected: int = 4
    topology_neighbors_num_directed: int = 4
    time_varying: bool = False       # regenerate topology per iteration
    seed: int = 0


# --------------------------------------------------------------------------
# model: online logistic regression
# --------------------------------------------------------------------------

def init_lr_params(input_dim: int, device="cpu") -> Tree:
    """Zero-init logistic regression (every node starts at the same
    point)."""
    return {"w": torch.zeros((input_dim,), dtype=torch.float32,
                             device=device),
            "b": torch.zeros((), dtype=torch.float32, device=device)}


def lr_predict(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """Single-sample logit (the sigmoid lives inside the BCE)."""
    return x @ params["w"] + params["b"]


def bce_with_logits(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sigmoid + BCE in optax's log-sigmoid form, smooth at 0 (where the
    zero init starts)."""
    return -y * F.logsigmoid(logit) - (1.0 - y) * F.logsigmoid(-logit)


# --------------------------------------------------------------------------
# topology
# --------------------------------------------------------------------------

def make_topology(cfg: DecentralizedOnlineConfig, n: int,
                  seed: Optional[int] = None) -> np.ndarray:
    """The row-stochastic mixing matrix W."""
    if cfg.b_symmetric:
        mgr = SymmetricTopologyManager(
            n, cfg.topology_neighbors_num_undirected)
        return np.asarray(mgr.generate_topology(), np.float32)
    mgr = AsymmetricTopologyManager(
        n, cfg.topology_neighbors_num_undirected,
        cfg.topology_neighbors_num_directed,
        seed=seed if seed is not None else cfg.seed)
    return np.asarray(mgr.generate_topology(), np.float32)


def _topology_bank(cfg: DecentralizedOnlineConfig, n: int,
                   n_iter: int) -> np.ndarray:
    """[K, N, N] bank of mixing matrices, read at iteration i as ``i %
    K``: time-varying regenerates with seed = t (K = n_iter); static
    keeps one matrix (K = 1)."""
    if cfg.time_varying:
        if cfg.b_symmetric:
            raise ValueError(
                "time_varying topology requires b_symmetric=False: the "
                "symmetric Watts-Strogatz(p=0) graph is deterministic, so "
                "'regenerating' it every iteration would silently produce "
                "an identical (static) topology")
        return np.stack([make_topology(cfg, n, seed=t)
                         for t in range(n_iter)])
    return make_topology(cfg, n)[None]


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

def _mix(A: torch.Tensor, stacked: Tree) -> Tree:
    """The neighbour exchange, one ``[N, N] @ [N, D]`` matmul per leaf."""
    n = A.shape[0]
    return {k: (A @ v.reshape(n, -1)).reshape(v.shape)
            for k, v in stacked.items()}


def _per_node(omega: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return omega.reshape((omega.shape[0],) + (1,) * (like.dim() - 1))


def make_online_run(predict_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
                    cfg: DecentralizedOnlineConfig):
    """Returns ``run(x0_stacked, stream_x, stream_y, stream_mask, W_bank,
    ts) -> (z_final_stacked, per_iteration_loss_sums)``, ``ts`` the
    ``(data index, W index)`` of every iteration, on the tensors'
    device (`_online_loop`: the step called once an iteration on the
    CPU, one CUDA graph of it replayed once an iteration on the card).
    ``run.captures`` counts the graphs captured; ``run.capture_s`` and
    ``run.replay_ms`` are the last card run's warm-up and capture (host
    seconds) and its replays (CUDA events, ms)."""
    mode = cfg.mode.upper()
    if mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; available: {MODES}")
    lr = cfg.learning_rate
    wd = cfg.weight_decay

    def loss_fn(params, x, y):
        return bce_with_logits(predict_fn(params, x), y)

    grad_fn = vmap(grad_and_value(loss_fn))

    def step(x_params, omega, xt, yt, mt, A):
        """One iteration: (x, omega) after it and its masked loss sum."""
        # z_t: the consensus iterate the gradient is evaluated at
        if mode == "PUSHSUM":
            z = {k: a / _per_node(omega, a) for k, a in x_params.items()}
        else:
            z = x_params
        grads, losses = grad_fn(z, xt, yt)
        if wd:
            grads = {k: g + wd * z[k] for k, g in grads.items()}
        # the gradient applied to x at lr, masked on padded steps
        x_half = {k: x_params[k] - lr * _per_node(mt, g) * g
                  for k, g in grads.items()}
        if mode == "LOCAL":
            x_next = x_half
        else:
            x_next = _mix(A, x_half)
            if mode == "PUSHSUM":
                omega = A @ omega
        return x_next, omega, (losses * mt).sum()

    def run(x0_stacked, stream_x, stream_y, stream_mask, W_bank, ts):
        n = stream_x.shape[0]
        K = W_bank.shape[0]
        data_idx, w_idx = (np.asarray(t.cpu() if torch.is_tensor(t) else t)
                           for t in ts)
        x_params = {k: x0_stacked[k] for k in tree_keys(x0_stacked)}
        omega = torch.ones((n,), dtype=torch.float32, device=stream_x.device)
        # Wᵀ once per matrix of the bank: receiver i takes sender j's x
        # with weight W[j, i], a column-stochastic push
        banks = W_bank.transpose(1, 2).contiguous()
        stream_y = stream_y.to(torch.float32)
        x_params, omega, losses, timing = _online_loop(
            step, x_params, omega, stream_x, stream_y, stream_mask, banks,
            data_idx, w_idx % K)
        if timing is not None:
            run.capture_s, run.replay_ms = timing
            run.captures += 1
        if mode == "PUSHSUM":
            z_fin = {k: a / _per_node(omega, a) for k, a in x_params.items()}
        else:
            z_fin = x_params
        return z_fin, losses

    run.captures, run.capture_s, run.replay_ms = 0, None, None
    return run


def _online_loop(step, x_params, omega, stream_x, stream_y, stream_mask,
                 banks, data_idx, w_idx):
    """The iterations around one device counter.  ``advance`` reads
    iteration ``counter``'s sample and matrix from the stream and the
    bank by ``index_select``, writes (x, omega) back into its buffers and
    the loss into slot ``counter``, and advances the counter.  On the CPU
    it is called once an iteration; on the card one CUDA graph of it is
    captured and replayed once an iteration, so an iteration is one
    replay and no host copy.  The graph is warmed up once on the capture
    stream with its outputs discarded; a failed capture raises, there is
    no eager fallback.  Returns (x, omega, the losses, and on the card
    the warm-up and capture's seconds and the replays' ms, else None)."""
    t0 = time.perf_counter()
    dev = stream_x.device
    n_iter = len(data_idx)
    plan = torch.as_tensor(np.stack([data_idx, w_idx]).astype(np.int64)).to(
        dev)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    x = {k: v.clone() for k, v in x_params.items()}
    omega = omega.clone()
    losses = torch.zeros(n_iter, dtype=torch.float32, device=dev)

    def body():
        t = plan[0].index_select(0, counter)
        wi = plan[1].index_select(0, counter)
        return step(x, omega, stream_x.index_select(1, t).squeeze(1),
                    stream_y.index_select(1, t).squeeze(1),
                    stream_mask.index_select(1, t).squeeze(1),
                    banks.index_select(0, wi).squeeze(0))

    def advance():
        x_next, omega_next, loss = body()
        for k, v in x.items():
            v.copy_(x_next[k])
        omega.copy_(omega_next)
        losses.index_copy_(0, counter, loss.reshape(1))
        counter.add_(1)

    if not stream_x.is_cuda:
        for _ in range(n_iter):
            advance()
        return x, omega, losses, None

    capture = torch.cuda.Stream(dev)
    capture.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(capture):
        body()
    torch.cuda.current_stream(dev).wait_stream(capture)
    graph = torch.cuda.CUDAGraph()
    # no garbage collection inside the capture (a freed pinned buffer or
    # event calls into CUDA off the capture stream)
    gc.collect()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=capture):
            advance()
    except Exception as e:
        raise RuntimeError(f"capturing the online step as a CUDA graph "
                           f"failed: {type(e).__name__}: {e}") from e
    finally:
        gc.enable()
    capture_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n_iter):
        graph.replay()
    end.record()
    end.synchronize()
    return x, omega, losses, (capture_s, start.elapsed_time(end))


# --------------------------------------------------------------------------
# the run over a stream
# --------------------------------------------------------------------------

class DecentralizedOnline:
    """N-node online learning over a (possibly directed, possibly
    time-varying) graph.  ``device``: None for the card (raises without
    one), "cpu" for the CPU."""

    def __init__(self, streaming_data: Dict[int, List[dict]],
                 config: DecentralizedOnlineConfig,
                 predict_fn: Callable = lr_predict,
                 init_params: Optional[Tree] = None, device=None):
        self.cfg = config
        self.device = resolve_device(device)
        self.x, self.y, self.mask = streaming_to_arrays(streaming_data)
        self.n = self.x.shape[0]
        T = min(config.iteration_number, self.x.shape[1])
        self.x = self.x[:, :T]
        self.y = self.y[:, :T]
        self.mask = self.mask[:, :T]
        self.T = T
        if init_params is None:
            init_params = init_lr_params(self.x.shape[-1])
        # every node starts from the same point
        self.x0 = {k: torch.as_tensor(v).to(self.device).expand(
            (self.n,) + tuple(torch.as_tensor(v).shape)).clone()
            for k, v in init_params.items()}
        self._run = make_online_run(predict_fn, config)
        self.predict_fn = predict_fn
        self.history: List[Dict[str, float]] = []

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        n_iter = self.T * max(cfg.epochs, 1)
        W_bank = _topology_bank(cfg, self.n, n_iter)
        it = np.arange(n_iter, dtype=np.int32)
        dev = self.device
        z_fin, loss_seq = self._run(
            self.x0, torch.as_tensor(self.x).to(dev),
            torch.as_tensor(self.y).to(dev),
            torch.as_tensor(self.mask).to(dev),
            torch.as_tensor(W_bank).to(dev), (it % self.T, it))
        loss_seq = loss_seq.cpu().numpy()
        # the average regret after t+1 iterations
        regret = np.cumsum(loss_seq) / (self.n * np.arange(1, n_iter + 1))
        self.history = [{"iteration": int(t), "average_loss": float(r)}
                        for t, r in enumerate(regret)]
        return {"params_z": z_fin, "regret": regret, "losses": loss_seq,
                "final_regret": float(regret[-1])}

    def accuracy(self, params_z: Tree) -> float:
        """The fraction of stream samples node 0's final model classifies
        correctly (threshold 0.5, i.e. logit 0)."""
        p0 = {k: a[0] for k, a in params_z.items()}
        x = torch.as_tensor(self.x.reshape(-1, self.x.shape[-1])).to(
            self.device)
        with torch.no_grad():
            logits = vmap(lambda v: self.predict_fn(p0, v))(x)
        pred = (logits.cpu().numpy() > 0).astype(np.int32)
        y = self.y.reshape(-1)
        m = self.mask.reshape(-1) > 0
        return float((pred[m] == y[m]).mean())


def run_decentralized_online(streaming_data: Dict[int, List[dict]],
                             config: DecentralizedOnlineConfig,
                             **kw) -> Dict[str, Any]:
    """The functional entry: run, then node 0's accuracy and the
    history."""
    algo = DecentralizedOnline(streaming_data, config, **kw)
    out = algo.run()
    out["accuracy"] = algo.accuracy(out["params_z"])
    out["history"] = algo.history
    return out
