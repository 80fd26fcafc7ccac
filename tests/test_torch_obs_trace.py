"""The port's span tracer (``fedml_tpu_torch/obs/trace.py``) and the
actors' spans against the JAX package.

* A 2-round local cross-silo federation (2 silos, the codec hub) under an
  injected clock gives the same span tree in both packages: names,
  parent links, node tracks, span arguments and count (exact).
* The ``_trace`` header param has JAX's keys (``t``, ``s``, ``m``) and a
  port frame's context decodes in the JAX package (and back): a
  federation of JAX and port nodes stitches one trace.
* Deterministic span ids are JAX's (same blake2s digest); a duplicated
  delivery collapses to one span; tracing off is the shared null
  context, frames without a ``_trace`` param.
"""

import itertools
import json
from collections import defaultdict

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms import cross_silo as j_cross_silo
from fedml_tpu.comm.local import LocalHub as JHub
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu.obs import trace as j_trace
from fedml_tpu_torch.algorithms.cross_silo import (FedAvgClientActor,
                                                   FedAvgServerActor)
from fedml_tpu_torch.comm.actors import NodeManager
from fedml_tpu_torch.comm.local import LocalHub
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.obs import trace
from fedml_tpu_torch.utils.jax_params import params_from_numpy


def _params():
    rng = np.random.RandomState(0)
    return {"dense": {"kernel": rng.randn(3, 2).astype(np.float32),
                      "bias": rng.randn(2).astype(np.float32)}}


def _clock():
    """A deterministic clock: every read advances one millisecond."""
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


@pytest.fixture
def tracers():
    jt = j_trace.enable(node="server", clock=_clock())
    tt = trace.enable(node="server", clock=_clock())
    yield jt, tt
    j_trace.disable()
    trace.disable()


def _j_federation(n_silos=2, rounds=2):
    hub = JHub(codec_roundtrip=True)
    server = j_cross_silo.FedAvgServerActor(hub.transport(0), _params(),
                                            n_silos, n_silos, rounds)
    server.register_handlers()
    silos = [j_cross_silo.FedAvgClientActor(
        i, hub.transport(i),
        lambda p, c, r: (jax.tree.map(lambda v: np.asarray(v) + 1.0, p), 10))
        for i in range(1, n_silos + 1)]
    for s in silos:
        s.register_handlers()
    server.start()
    hub.pump()
    return server


def _t_federation(n_silos=2, rounds=2):
    hub = LocalHub(codec_roundtrip=True)
    server = FedAvgServerActor(hub.transport(0),
                               params_from_numpy(_params()), n_silos,
                               n_silos, rounds)
    server.register_handlers()
    silos = [FedAvgClientActor(
        i, hub.transport(i),
        lambda p, c, r: ({k: np.asarray(v) + 1.0 for k, v in p.items()},
                         10))
        for i in range(1, n_silos + 1)]
    for s in silos:
        s.register_handlers()
    server.start()
    hub.pump()
    return server


def _tree(spans):
    """The span forest with ids replaced by structure: each span as
    (name, node, args, sorted children), roots sorted."""
    children = defaultdict(list)
    roots = []
    for s in spans:
        (children[s["parent_id"]] if s["parent_id"] is not None
         else roots).append(s)

    def render(s):
        return (s["name"], str(s["node"]),
                tuple(sorted((k, str(v)) for k, v in s["args"].items())),
                tuple(sorted(render(c) for c in children[s["span_id"]])))

    return sorted(render(r) for r in roots)


def test_span_tree_equals_jax(tracers):
    jt, tt = tracers
    _j_federation()
    _t_federation()
    j_spans, t_spans = jt.spans, tt.spans
    assert len(t_spans) == len(j_spans) > 0
    assert _tree(t_spans) == _tree(j_spans)
    # one root a round, recv: children on every silo's track
    roots = [s for s in t_spans if s["parent_id"] is None]
    assert [s["name"] for s in roots] == ["round", "round"]
    recv_nodes = {s["node"] for s in t_spans
                  if s["name"].startswith("recv:")}
    assert {1, 2} <= recv_nodes
    # every parent link resolves inside its own trace
    ids = {s["span_id"]: s for s in t_spans}
    for s in t_spans:
        if s["parent_id"] is not None:
            assert ids[s["parent_id"]]["trace_id"] == s["trace_id"]
    # the Perfetto export names each node's track, as JAX's does
    j_names = sorted(e["args"]["name"] for e in jt.to_trace_events()
                     if e["ph"] == "M")
    t_names = sorted(e["args"]["name"] for e in tt.to_trace_events()
                     if e["ph"] == "M")
    assert t_names == j_names


def test_trace_header_has_jax_keys_and_crosses_packages(tracers):
    _, tt = tracers
    msg = Message(3, 1, 0).add(Message.ARG_MODEL_PARAMS, _params())
    with tt.span("upload") as sp:
        trace.inject(msg, sp.context)
    header = msg.get(trace.CTX_KEY)
    assert trace.CTX_KEY == j_trace.CTX_KEY == Message.ARG_TRACE == "_trace"
    assert set(header) == {"t", "s", "m"}
    # a port frame's context decodes in the JAX package ...
    ctx = j_trace.extract(JMessage.from_bytes(msg.to_bytes()))
    assert (ctx.trace_id, ctx.span_id, ctx.msg_id) == \
        (sp.trace_id, sp.span_id, header["m"])
    # ... and a JAX frame's in the port
    jmsg = JMessage(3, 1, 0).add(JMessage.ARG_MODEL_PARAMS, _params())
    j_trace.inject(jmsg, j_trace.SpanContext("T", "S"))
    back = trace.extract(Message.from_bytes(jmsg.to_bytes()))
    assert (back.trace_id, back.span_id) == ("T", "S")


def test_deterministic_ids_and_duplicate_delivery(tracers):
    _, tt = tracers
    parts = ("trace", "parent", "msg", "recv:3", "0")
    assert trace.deterministic_span_id(*parts) == \
        j_trace.deterministic_span_id(*parts)
    seen = []

    class Probe(NodeManager):
        def register_handlers(self):
            self.register_handler(7, seen.append)

    hub = LocalHub(codec_roundtrip=True)
    a, b = Probe(0, hub.transport(0)), Probe(1, hub.transport(1))
    a.register_handlers(), b.register_handlers()
    msg = Message(7, 0, 1)
    with tt.span("send", node=0) as sp:
        trace.inject(msg, sp.context)
    b.receive_message(7, msg)
    b.receive_message(7, msg)   # the wire delivered the frame twice
    recv = [s for s in tt.spans if s["name"] == "recv:7"]
    assert len(seen) == 2 and len(recv) == 1
    assert recv[0]["parent_id"] == sp.span_id and recv[0]["node"] == 1


def test_tracing_off_is_the_shared_null_context(tmp_path):
    """No tracer: the actor's spans are the one shared null context and
    no frame carries a ``_trace`` param (the byte-equal frames)."""
    assert trace.get_tracer() is None
    server = _t_federation(rounds=1)
    assert server._span("x") is trace.NULL_CONTEXT
    assert server._root_span("x") is trace.NULL_CONTEXT
    msg = Message(1, 0, 1).add(Message.ARG_ROUND, 0)
    server.transport.send_message = lambda m: None
    assert msg.get(trace.CTX_KEY) is None
    # the export writes Perfetto JSON atomically
    tr = trace.SpanTracer(node="n", clock=_clock())
    with tr.span("round", node=0):
        pass
    path = tmp_path / "t" / "trace.json"
    tr.export(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events] == ["round", "process_name"]
