"""Minimal MQTT 3.1.1 client with the paho surface `MqttTransport` uses.

The port's copy of ``fedml_tpu/comm/mqtt_client.py``: ``connect``,
``subscribe``, ``publish``, ``loop_start``/``loop_stop``, ``disconnect``
and the ``on_message``/``on_disconnect`` callbacks, over one TCP socket:

* ``connect`` runs the CONNECT/CONNACK handshake synchronously, then
  starts the reader thread (no frame is lost in a connect→loop gap);
* ``subscribe`` waits for ITS SUBACK — matched by packet id, unlike the
  JAX package's shared event — and raises when the broker refuses the
  filter (return code 0x80);
* ``publish`` at QoS 1 sends with a packet id and returns; the reader
  drains the PUBACK;
* CONNECT advertises keepalive 0 (§3.1.2.10), so a silo idle at a
  barrier is never dropped;
* an unexpected connection loss calls ``on_disconnect(client, userdata,
  1)`` from the reader thread;
* ``disconnect`` sends DISCONNECT, half-closes and waits for the broker to
  close its end before closing the socket (the JAX package closes at
  once, which can reset the connection before the broker has read the
  last publishes).
"""

from __future__ import annotations

import socket
import struct
import threading
import types
from typing import Optional

from fedml_tpu_torch.comm import mqtt_wire as w


class MiniMqttClient:
    def __init__(self, client_id: str = ""):
        self.client_id = client_id or "fedml-tpu"
        self.on_message = None
        self.on_disconnect = None  # (client, userdata, rc) on UNEXPECTED loss
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[threading.Thread] = None
        self._wlock = threading.Lock()
        self._pid = 0
        # packet id -> [event, return codes] of each SUBSCRIBE in flight
        self._subacks: dict = {}
        self._closing = False

    # -- paho surface ------------------------------------------------------
    def connect(self, host: str, port: int = 1883,
                keepalive: int = 0) -> None:
        self._sock = socket.create_connection((host, port), timeout=30)
        body = (w.encode_string("MQTT") + bytes([4])   # protocol level 4
                + bytes([0x02])                        # clean session
                + struct.pack(">H", keepalive)
                + w.encode_string(self.client_id))
        self._send(w.make_packet(w.CONNECT, 0, body))
        pkt = w.read_packet(self._sock)
        if pkt is None or pkt[0] != w.CONNACK or pkt[2][1] != 0:
            raise ConnectionError(f"MQTT CONNECT refused: {pkt!r}")
        self._sock.settimeout(None)
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"mqtt-{self.client_id}",
                                        daemon=True)
        self._reader.start()

    def subscribe(self, topic: str, qos: int = 0) -> None:
        with self._wlock:
            pid = self._next_pid()
            waiter = self._subacks[pid] = [threading.Event(), b""]
        body = struct.pack(">H", pid) + w.encode_string(topic) + bytes([qos])
        self._send(w.make_packet(w.SUBSCRIBE, 0x02, body))
        try:
            if not waiter[0].wait(timeout=10):
                raise TimeoutError(f"no SUBACK for {topic!r}")
        finally:
            with self._wlock:
                self._subacks.pop(pid, None)
        if 0x80 in waiter[1]:
            raise ValueError(f"the broker refused the subscription to "
                             f"{topic!r} (SUBACK 0x80)")

    def publish(self, topic: str, payload: bytes, qos: int = 0) -> None:
        payload = bytes(payload)
        head = w.encode_string(topic)
        if qos:
            with self._wlock:
                head += struct.pack(">H", self._next_pid())
        self._send(w.make_packet(w.PUBLISH, (qos & 0x3) << 1,
                                 head + payload))

    def loop_start(self) -> None:
        pass  # the reader runs from connect() — see module docstring

    def loop_stop(self) -> None:
        pass

    def disconnect(self) -> None:
        self._closing = True
        reader = (self._reader if self._reader is not threading.current_thread()
                  else None)
        try:
            self._send(w.make_packet(w.DISCONNECT, 0, b""))
            # half-close, then wait for the broker to close its end (§3.14.4):
            # it has then read every frame sent before DISCONNECT.  Closing
            # with unread input (PUBACKs) would reset the connection, and
            # the broker could lose the last publishes — a FINISH fan-out.
            self._sock.shutdown(socket.SHUT_WR)
            if reader is not None:
                reader.join(timeout=5)
        except OSError:
            pass
        try:  # shutdown wakes the reader's blocked recv(); close alone
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if reader is not None:
            reader.join(timeout=5)

    # -- internals ---------------------------------------------------------
    def _next_pid(self) -> int:
        """The next packet id; the caller holds the write lock."""
        self._pid = self._pid % 0xFFFF + 1
        return self._pid

    def _send(self, packet: bytes) -> None:
        with self._wlock:
            self._sock.sendall(packet)

    def _read_loop(self) -> None:
        try:
            while True:
                pkt = w.read_packet(self._sock)
                if pkt is None:
                    self._lost()
                    return
                ptype, flags, body = pkt
                if ptype == w.PUBLISH:
                    topic, off = w.decode_string(body, 0)
                    if (flags >> 1) & 0x3:
                        (pid,) = struct.unpack_from(">H", body, off)
                        off += 2
                        self._send(w.make_packet(
                            w.PUBACK, 0, struct.pack(">H", pid)))
                    if self.on_message is not None:
                        self.on_message(self, None, types.SimpleNamespace(
                            topic=topic, payload=body[off:]))
                elif ptype == w.SUBACK:
                    (pid,) = struct.unpack_from(">H", body, 0)
                    with self._wlock:
                        waiter = self._subacks.get(pid)
                    if waiter is not None:   # a stray SUBACK wakes no one
                        waiter[1] = bytes(body[2:])
                        waiter[0].set()
                # PUBACK / PINGRESP / UNSUBACK: drained
        except (OSError, ValueError):
            self._lost()

    def _lost(self) -> None:
        """Unexpected connection loss: tell the owner from the reader
        thread (a silent reader exit would wedge anything blocking on
        inbound messages)."""
        if not self._closing and self.on_disconnect is not None:
            self.on_disconnect(self, None, 1)
