"""The base-framework template (port of
``fedml_tpu/algorithms/base_framework.py``): a minimal central/client
worker pair whose "model" is any Python value, the scaffold to copy for a
new message-passing algorithm.

The bootstrap is transport injection (any `fedml_tpu_torch.comm`
transport: the in-process hub for tests, gRPC or MQTT for a deployment);
the choreography is init broadcast -> client update -> upload -> the
all-received barrier -> aggregate -> the next round.  An algorithm that
trains on the device starts from the cohort engine
(`fedml_tpu_torch.parallel.cohort`) instead; this scaffold is for the
host-side choreography only.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from fedml_tpu_torch.comm.actors import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.transport import Transport

log = logging.getLogger(__name__)


class BaseMsg:
    """The message types and the payload key."""
    S2C_INIT = 1          # MSG_TYPE_S2C_INIT_CONFIG
    C2S_INFORMATION = 2   # MSG_TYPE_C2S_INFORMATION
    S2C_SYNC = 3          # MSG_TYPE_S2C_SYNC_TO_CLIENT
    S2C_FINISH = 4
    ARG_INFORMATION = "information"


class BaseCentralWorker:
    """Accumulate client results and aggregate them.  Replace
    ``aggregate`` in your algorithm."""

    def __init__(self, client_num: int):
        self.client_num = client_num
        self.client_local_result_list: Dict[int, Any] = {}

    def add_client_local_result(self, index: int, result: Any) -> None:
        self.client_local_result_list[index] = result

    def check_whether_all_receive(self) -> bool:
        return len(self.client_local_result_list) >= self.client_num

    def aggregate(self) -> Any:
        total = sum(self.client_local_result_list.values())
        self.client_local_result_list.clear()
        return total


class BaseClientWorker:
    """The local computation stub: ``train`` returns the client's
    contribution; ``update`` receives the global state."""

    def __init__(self, client_index: int):
        self.client_index = client_index
        self.updated_information: Any = 0

    def update(self, info: Any) -> None:
        self.updated_information = info

    def train(self) -> Any:
        return self.client_index


class BaseCentralActor(ServerManager):
    """The central node's choreography on the transport actor layer."""

    def __init__(self, transport: Transport, worker: BaseCentralWorker,
                 num_rounds: int,
                 on_round_done: Optional[Callable[[int, Any], None]] = None):
        super().__init__(0, transport)
        self.worker = worker
        self.num_rounds = num_rounds
        self.round_idx = 0
        self.on_round_done = on_round_done

    def register_handlers(self) -> None:
        self.register_handler(BaseMsg.C2S_INFORMATION, self._on_information)

    def start(self) -> None:
        for client in range(1, self.worker.client_num + 1):
            self.send(BaseMsg.S2C_INIT, client,
                      **{BaseMsg.ARG_INFORMATION: 0})

    def _on_information(self, msg: Message) -> None:
        self.worker.add_client_local_result(
            msg.sender_id - 1, msg.get(BaseMsg.ARG_INFORMATION))
        if not self.worker.check_whether_all_receive():
            return
        global_result = self.worker.aggregate()
        if self.on_round_done is not None:
            self.on_round_done(self.round_idx, global_result)
        self.round_idx += 1
        done = self.round_idx >= self.num_rounds
        for client in range(1, self.worker.client_num + 1):
            if done:
                self.send(BaseMsg.S2C_FINISH, client)
            else:
                self.send(BaseMsg.S2C_SYNC, client,
                          **{BaseMsg.ARG_INFORMATION: global_result})
        if done:
            self.finish()


class BaseClientActor(ClientManager):
    """The client node's choreography: update -> train -> upload."""

    def __init__(self, node_id: int, transport: Transport,
                 worker: BaseClientWorker):
        super().__init__(node_id, transport)
        self.worker = worker

    def register_handlers(self) -> None:
        self.register_handler(BaseMsg.S2C_INIT, self._on_sync)
        self.register_handler(BaseMsg.S2C_SYNC, self._on_sync)
        self.register_handler(BaseMsg.S2C_FINISH, lambda m: self.finish())

    def _on_sync(self, msg: Message) -> None:
        self.worker.update(msg.get(BaseMsg.ARG_INFORMATION))
        self.send(BaseMsg.C2S_INFORMATION, 0,
                  **{BaseMsg.ARG_INFORMATION: self.worker.train()})


def run_base_framework_demo(client_num: int = 3, num_rounds: int = 2):
    """The template's whole run on the in-process hub (the deterministic
    pump, no threads); returns the per-round aggregates."""
    from fedml_tpu_torch.comm.local import LocalHub
    hub = LocalHub()
    history = []
    server = BaseCentralActor(hub.transport(0), BaseCentralWorker(client_num),
                              num_rounds,
                              on_round_done=lambda r, g: history.append(g))
    clients = [BaseClientActor(i, hub.transport(i), BaseClientWorker(i - 1))
               for i in range(1, client_num + 1)]
    server.register_handlers()
    for c in clients:
        c.register_handlers()
    server.start()
    hub.pump()
    return history
