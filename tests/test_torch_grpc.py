"""The port's gRPC transport (``comm/grpc_transport.py``) over loopback:

* a frame from a port endpoint to a JAX endpoint and back (one service
  name and method path, byte-compatible frames);
* ``load_ip_table`` parses the reference's CSV as the JAX package does;
* the runner's ``--silo_backend grpc`` mode — one `CrossSiloFederation`
  per node, here three in one process on threads — ends with the global
  of the in-process hub's run, bit for bit (the stack mean sums in silo
  order, whatever the arrival order);
* without grpcio, building the transport raises an ImportError that
  names grpcio (nothing falls back).
"""

import socket
import sys
import threading
import time

import numpy as np
import pytest

from fedml_tpu_torch.comm.message import Message

pytest.importorskip("grpc")

JOIN_S = 60


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()
              and (isinstance(t, threading.Timer)
                   or t.name.startswith(("node-", "heartbeat-")))]
    assert not leaked, leaked


def free_base_port(n: int) -> int:
    """A port ``p`` with ``p .. p + n - 1`` free on the loopback now, away
    from the fixed ports the JAX package's gRPC tests bind (56210-56311),
    which may run at the same time in another worker."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n >= 65535 or 56000 <= base + n and base < 57000:
            continue
        try:
            for p in range(base, base + n):
                with socket.socket() as s:
                    s.bind(("", p))
            return base
        except OSError:
            continue
    raise RuntimeError("no free port range")


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def test_frames_cross_between_the_packages():
    from fedml_tpu.comm.grpc_transport import GrpcTransport as JGrpc
    from fedml_tpu_torch.comm.grpc_transport import GrpcTransport
    base = free_base_port(2)
    table = {0: "127.0.0.1", 1: "127.0.0.1"}
    ours = GrpcTransport(0, table, base_port=base)
    theirs = JGrpc(1, table, base_port=base)
    got = {0: [], 1: []}

    class Collect:
        def __init__(self, node):
            self.node = node

        def receive_message(self, msg_type, msg):
            got[self.node].append(msg)

    ours.add_observer(Collect(0))
    theirs.add_observer(Collect(1))
    threads = [threading.Thread(target=t.run, daemon=True, name=f"node-{i}")
               for i, t in ((0, ours), (1, theirs))]
    for th in threads:
        th.start()
    tree = {"dense": {"kernel": np.arange(12, dtype=np.float32)
                      .reshape(4, 3)}, "steps": np.int32(7)}
    try:
        ours.send_message(Message(3, 0, 1).add(Message.ARG_MODEL_PARAMS,
                                               tree).add("v", 1))
        assert _wait(lambda: got[1])
        echo = got[1][0]
        theirs.send_message(type(echo)(4, 1, 0).add(
            Message.ARG_MODEL_PARAMS, echo.get(Message.ARG_MODEL_PARAMS)))
        assert _wait(lambda: got[0])
    finally:
        ours.stop()
        theirs.stop()
        for th in threads:
            th.join(timeout=5)
    back = got[0][0].get(Message.ARG_MODEL_PARAMS)
    assert back["dense"]["kernel"].tobytes() == \
        tree["dense"]["kernel"].tobytes()
    assert int(back["steps"]) == 7


def test_load_ip_table_as_the_jax_package(tmp_path):
    from fedml_tpu.comm.grpc_transport import load_ip_table as j_load
    from fedml_tpu_torch.comm.grpc_transport import load_ip_table
    csv = tmp_path / "grpc_ipconfig.csv"
    csv.write_text("receiver_id,ip\n0,10.0.0.1\n1, 10.0.0.2\n\n2,10.0.0.3\n")
    assert load_ip_table(str(csv)) == j_load(str(csv)) == {
        0: "10.0.0.1", 1: "10.0.0.2", 2: "10.0.0.3"}


def _cfg(extra):
    from fedml_tpu_torch.experiments.config import config_from_argv
    return config_from_argv([
        "--algo", "cross_silo", "--model", "lr", "--dataset", "mnist",
        "--client_num_in_total", "8", "--client_num_per_round", "2",
        "--batch_size", "4", "--comm_round", "2", "--platform", "cpu",
        "--frequency_of_the_test", "100", "--log_stdout", "false", *extra])


class _Sink:
    def log(self, *a, **k):
        pass


def test_runner_grpc_mode_equals_the_hub():
    from fedml_tpu_torch.experiments import main as t_main
    hub_cfg = _cfg([])
    data = t_main.load_experiment_data(hub_cfg)
    hub = t_main.CrossSiloFederation(hub_cfg, data, _Sink())
    init = {k: v.clone() for k, v in hub.server.params.items()}
    hub.run()
    base = free_base_port(3)
    feds = {}
    for node in range(3):
        cfg = _cfg(["--silo_backend", "grpc", "--node_id", str(node),
                    "--base_port", str(base), "--heartbeat_s", "0.05",
                    "--dead_after_s", "30", "--silo_retries", "4",
                    "--silo_idle_timeout_s", str(JOIN_S)])
        t_main.check_config(cfg)
        feds[node] = t_main.CrossSiloFederation(cfg, data, _Sink(),
                                                init_params=init)
    assert feds[0].drive == "grpc" and feds[0].server is not None
    outs = {}

    def run(node):
        outs[node] = feds[node].run()

    threads = [threading.Thread(target=run, args=(n,), daemon=True,
                                name=f"node-{n}") for n in (1, 2, 0)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=JOIN_S)
    alive = [th.name for th in threads if th.is_alive()]
    for fed in feds.values():
        (fed.server or fed.silos[0]).transport.stop()
    for th in threads:
        th.join(timeout=5)
    assert not alive, f"{alive} never reached FINISH"
    assert outs[1] == {} and outs[2] == {}
    assert outs[0]["params_finite"]
    server = feds[0].server
    assert server.round_idx == 2
    assert all(server.params[k].numpy().tobytes()
               == hub.server.params[k].numpy().tobytes()
               for k in hub.server.params)


def test_missing_grpcio_raises_naming_it(monkeypatch):
    from fedml_tpu_torch.comm.grpc_transport import GrpcTransport
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(ImportError, match="grpcio"):
        GrpcTransport(0, {0: "127.0.0.1"}, base_port=free_base_port(1))
