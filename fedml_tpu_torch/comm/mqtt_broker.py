"""Minimal MQTT 3.1.1 loopback broker: real TCP sockets, real framing.

The port's copy of ``fedml_tpu/comm/mqtt_broker.py``: a threaded TCP
server speaking the subset the transport needs — CONNECT/CONNACK,
SUBSCRIBE/SUBACK, PUBLISH QoS 0/1 (QoS 1 inbound is PUBACK-ed; delivery
is at the granted QoS 0, as §3.8.4 permits), UNSUBSCRIBE/UNSUBACK,
PINGREQ/PINGRESP, DISCONNECT.  One thread per connection; the
subscription table (topic filter → connections) sits under one lock;
per-connection write locks serialize frames from concurrent routing
threads.

Departures from the JAX package: a subscription whose filter puts ``#``
before its last level is refused with SUBACK return code 0x80
(§4.7.1.2); and the broker counts the bytes it takes in and sends out
(``bytes_in``, ``bytes_out``).
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Dict, Set

from fedml_tpu_torch.comm import mqtt_wire as w

log = logging.getLogger(__name__)


class _Conn:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.wlock = threading.Lock()
        self.client_id = "?"

    def send(self, packet: bytes) -> None:
        with self.wlock:
            self.sock.sendall(packet)

    def close(self) -> None:
        # shutdown BEFORE close: close() alone does not wake a thread
        # blocked in recv() on the same fd (observed hang)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class MqttBroker:
    """``with MqttBroker() as b: ... b.port ...`` — serves until stop()."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self._subs: Dict[str, Set[_Conn]] = {}
        self._conns: Set[_Conn] = set()
        self._lock = threading.Lock()
        self._stopping = False
        self._threads: list = []   # connection threads, joined by stop()
        # bytes read from publishers and written to subscribers (PUBLISH
        # frames, headers included)
        self.bytes_in = 0
        self.bytes_out = 0
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="mqtt-broker-accept",
                                        daemon=True)
        self._accept.start()

    # -- lifecycle ---------------------------------------------------------
    def stop(self) -> None:
        self._stopping = True
        try:  # shutdown wakes the blocked accept(); close alone may not
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        self._accept.join(timeout=5)
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- server loops ------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return  # closed by stop()
            conn = _Conn(sock)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name="mqtt-broker-conn", daemon=True)
            with self._lock:
                self._conns.add(conn)
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _serve(self, conn: _Conn) -> None:
        try:
            pkt = w.read_packet(conn.sock)
            if pkt is None or pkt[0] != w.CONNECT:
                return
            _, _, body = pkt
            proto, off = w.decode_string(body, 0)
            if proto not in ("MQTT", "MQIsdp"):  # 3.1.1 / legacy 3.1
                return
            off += 1 + 1 + 2  # level, connect flags, keepalive
            conn.client_id, _ = w.decode_string(body, off)
            # CONNACK: session-present 0, return code 0 (accepted)
            conn.send(w.make_packet(w.CONNACK, 0, b"\x00\x00"))
            while True:
                pkt = w.read_packet(conn.sock)
                if pkt is None:
                    return
                ptype, flags, body = pkt
                if ptype == w.PUBLISH:
                    self._on_publish(conn, flags, body)
                elif ptype == w.SUBSCRIBE:
                    self._on_subscribe(conn, body)
                elif ptype == w.UNSUBSCRIBE:
                    self._on_unsubscribe(conn, body)
                elif ptype == w.PINGREQ:
                    conn.send(w.make_packet(w.PINGRESP, 0, b""))
                elif ptype == w.DISCONNECT:
                    return
                # PUBACK from subscribers would land here; QoS0 delivery
                # means none arrive — anything else is ignored
        except (OSError, ValueError) as e:
            if not self._stopping:
                log.debug("broker conn %s dropped: %s", conn.client_id, e)
        finally:
            self._drop(conn)

    # -- packet handlers ---------------------------------------------------
    def _on_publish(self, conn: _Conn, flags: int, body: bytes) -> None:
        qos = (flags >> 1) & 0x3
        topic, off = w.decode_string(body, 0)
        if qos:
            (pid,) = struct.unpack_from(">H", body, off)
            off += 2
            conn.send(w.make_packet(w.PUBACK, 0, struct.pack(">H", pid)))
        payload = body[off:]
        out = w.make_packet(w.PUBLISH, 0,
                            w.encode_string(topic) + payload)
        with self._lock:
            targets = {c for filt, conns in self._subs.items()
                       if w.topic_matches(filt, topic) for c in conns}
            self.bytes_in += 1 + len(w.encode_varint(len(body))) + len(body)
            self.bytes_out += len(out) * len(targets)
        for c in targets:
            try:
                c.send(out)
            except OSError:
                self._drop(c)

    def _on_subscribe(self, conn: _Conn, body: bytes) -> None:
        (pid,) = struct.unpack_from(">H", body, 0)
        off, granted = 2, bytearray()
        with self._lock:
            while off < len(body):
                filt, off = w.decode_string(body, off)
                off += 1  # requested qos; delivery is granted QoS 0
                if not w.valid_filter(filt):
                    granted.append(0x80)   # failure (§3.9.3)
                    continue
                self._subs.setdefault(filt, set()).add(conn)
                granted.append(0)
        conn.send(w.make_packet(w.SUBACK, 0,
                                struct.pack(">H", pid) + bytes(granted)))

    def _on_unsubscribe(self, conn: _Conn, body: bytes) -> None:
        (pid,) = struct.unpack_from(">H", body, 0)
        off = 2
        with self._lock:
            while off < len(body):
                filt, off = w.decode_string(body, off)
                self._subs.get(filt, set()).discard(conn)
        conn.send(w.make_packet(w.UNSUBACK, 0, struct.pack(">H", pid)))

    def _drop(self, conn: _Conn) -> None:
        with self._lock:
            self._conns.discard(conn)
            for conns in self._subs.values():
                conns.discard(conn)
        conn.close()
