"""MQTT transport: pub/sub through a broker, one topic per node
(``<prefix>/<node_id>``), the binary frames of `comm.message` as MQTT
payloads.

The port's copy of ``fedml_tpu/comm/mqtt_transport.py``, with the same
topic scheme and default prefix, so port and JAX nodes share one broker.
``paho-mqtt`` is used when it is installed; otherwise the repo's own
`MiniMqttClient`, which speaks MQTT 3.1.1 over a real socket to
`MqttBroker` or any 3.1.1 broker.  An unexpected broker loss wakes
``run()`` with ``ConnectionError``.
"""

from __future__ import annotations

import logging
import queue

from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.transport import Transport
from fedml_tpu_torch.obs import telemetry

log = logging.getLogger(__name__)

try:
    import paho.mqtt.client as _mqtt
    HAVE_MQTT = True
except ImportError:  # pragma: no cover - environment without paho-mqtt
    _mqtt = None
    HAVE_MQTT = False

_STOP = object()
_LOST = object()   # unexpected broker disconnect (MiniMqttClient)


class MqttTransport(Transport):
    def __init__(self, node_id: int, broker_host: str, broker_port: int = 1883,
                 topic_prefix: str = "fedml_tpu"):
        super().__init__()
        self.node_id = node_id
        self.topic_prefix = topic_prefix
        self.broker_host = broker_host
        self.broker_port = broker_port
        self._inbox: "queue.Queue" = queue.Queue()
        self._stopped = False
        self._m_torn = telemetry.get_registry().counter(
            "fedml_wire_torn_frames_total")
        cid = f"{topic_prefix}_{node_id}"
        if not HAVE_MQTT:
            # no paho: the in-repo MQTT 3.1.1 client speaks the same wire
            # protocol over a real socket (works against mqtt_broker.py or
            # any external 3.1.1 daemon).  An unexpected broker loss wakes
            # run() with ConnectionError instead of wedging the inbox.
            from fedml_tpu_torch.comm.mqtt_client import MiniMqttClient
            self._client = MiniMqttClient(client_id=cid)
            self._client.on_disconnect = (
                lambda c, u, rc: self._inbox.put(_LOST))
        elif hasattr(_mqtt, "CallbackAPIVersion"):  # paho-mqtt >= 2.0
            self._client = _mqtt.Client(_mqtt.CallbackAPIVersion.VERSION1,
                                        client_id=cid)
        else:
            self._client = _mqtt.Client(client_id=cid)
        self._client.on_message = self._on_message
        self._client.connect(broker_host, broker_port)
        self._client.subscribe(self._topic(node_id), qos=1)
        self._client.loop_start()

    def _topic(self, node_id: int) -> str:
        return f"{self.topic_prefix}/{node_id}"

    def _on_message(self, client, userdata, mqtt_msg) -> None:
        try:
            msg = Message.from_bytes(mqtt_msg.payload)
        except ValueError as exc:
            # a torn frame must not kill the broker callback thread: drop
            # it like a lost publish and let the round policy recover
            self._m_torn.inc()
            log.warning("node %d: dropping undecodable %d-byte frame from "
                        "%s: %s", self.node_id, len(mqtt_msg.payload),
                        mqtt_msg.topic, exc)
            return
        self._inbox.put(msg)

    def send_message(self, msg: Message) -> None:
        # shared-aware: a send_many sibling reuses the fan-out's encoded
        # block (one header encode + one memcpy per receiver)
        data = msg.to_bytes()
        self._obs_send(msg, len(data))
        self._client.publish(self._topic(msg.receiver_id), data, qos=1)

    def reconnect(self) -> None:
        """Tear down and re-run the CONNECT/SUBSCRIBE handshake against the
        same broker — the hook `ResilientTransport` invokes between retry
        attempts after a publish fails (broker restarted, TCP reset)."""
        if self._stopped:
            return
        try:
            self._client.loop_stop()
            self._client.disconnect()
        except Exception:  # noqa: BLE001 — the old session may be half-dead
            pass
        if hasattr(self._client, "_closing"):  # MiniMqttClient
            self._client._closing = False
        self._client.connect(self.broker_host, self.broker_port)
        self._client.subscribe(self._topic(self.node_id), qos=1)
        self._client.loop_start()

    def run(self) -> None:
        while True:
            item = self._inbox.get()
            if item is _STOP:
                return
            if item is _LOST:
                raise ConnectionError(
                    "MQTT broker connection lost (unexpected disconnect)")
            self._notify(item)

    def stop(self) -> None:
        if self._stopped:
            return  # idempotent: actor finish + fixture teardown both stop
        self._stopped = True
        self._inbox.put(_STOP)
        self._client.loop_stop()
        self._client.disconnect()
