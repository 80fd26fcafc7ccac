"""MQTT 3.1.1 wire framing: the byte-level subset shared by the loopback
broker (`mqtt_broker`) and the minimal client (`mqtt_client`).

The port's copy of ``fedml_tpu/comm/mqtt_wire.py`` (OASIS MQTT 3.1.1
§2-§3): a fixed header of packet type and flags, the variable-length
Remaining Length (7 bits a byte, MSB = continuation), UTF-8 strings with
2-byte big-endian length prefixes.  Only the packet types the pub/sub
choreography needs: CONNECT/CONNACK, PUBLISH (QoS 0/1) + PUBACK,
SUBSCRIBE/SUBACK, UNSUBSCRIBE/UNSUBACK, PINGREQ/PINGRESP, DISCONNECT.

One departure from the JAX package: `topic_matches` follows §4.7.1.2 and
a filter with ``#`` anywhere but its last level matches nothing
(`valid_filter` says so; the broker refuses such a subscription).
"""

from __future__ import annotations

import socket
import struct
from typing import Optional, Tuple

CONNECT = 1
CONNACK = 2
PUBLISH = 3
PUBACK = 4
SUBSCRIBE = 8
SUBACK = 9
UNSUBSCRIBE = 10
UNSUBACK = 11
PINGREQ = 12
PINGRESP = 13
DISCONNECT = 14


def encode_varint(n: int) -> bytes:
    """Remaining Length encoding (spec §2.2.3): 7 bits per byte, MSB set
    while more bytes follow; max 4 bytes (268 435 455)."""
    if n < 0 or n > 0x0FFFFFFF:
        raise ValueError(f"remaining length {n} out of MQTT range")
    out = bytearray()
    while True:
        n, digit = divmod(n, 128)
        out.append(digit | (0x80 if n else 0))
        if not n:
            return bytes(out)


def encode_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def decode_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from(">H", buf, off)
    off += 2
    return buf[off:off + n].decode("utf-8"), off + n


def make_packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | (flags & 0x0F)]) + encode_varint(
        len(body)) + body


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes, received in place (a model frame is megabytes:
    no quadratic re-concatenation); None on EOF."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return bytes(buf)


def read_packet(sock: socket.socket
                ) -> Optional[Tuple[int, int, bytes]]:
    """Blocking read of one full control packet; None on clean EOF."""
    head = _read_exact(sock, 1)
    if head is None:
        return None
    ptype, flags = head[0] >> 4, head[0] & 0x0F
    length, shift = 0, 0
    while True:
        b = _read_exact(sock, 1)
        if b is None:
            return None
        length |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            break
        shift += 7
        if shift > 21:
            raise ValueError("malformed MQTT remaining length")
    body = _read_exact(sock, length) if length else b""
    if body is None:
        return None
    return ptype, flags, body


def valid_filter(filt: str) -> bool:
    """§4.7.1.2: ``#`` only as the whole last level."""
    levels = filt.split("/")
    return all(f != "#" and "#" not in f for f in levels[:-1]) \
        and (levels[-1] == "#" or "#" not in levels[-1])


def topic_matches(filt: str, topic: str) -> bool:
    """MQTT topic-filter matching (spec §4.7): '+' one level, '#' tail.
    An invalid filter (`valid_filter`) matches nothing."""
    if not valid_filter(filt):
        return False
    fl, tl = filt.split("/"), topic.split("/")
    for i, f in enumerate(fl):
        if f == "#":
            return True
        if i >= len(tl) or (f != "+" and f != tl[i]):
            return False
    return len(fl) == len(tl)
