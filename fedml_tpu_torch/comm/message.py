"""Typed message envelope with a binary pytree codec.

The port's own copy of ``fedml_tpu/comm/message.py``.  It stays numpy on
the wire, so a frame is byte-identical to the JAX package's for the same
payload and the two packages' nodes can read each other's frames.  Torch
tensors become numpy at the actor boundary (``.cpu().numpy()``), never
inside the codec.

A message serializes to one frame::

    [4-byte header length][JSON header][raw buffer 0][raw buffer 1]...

Array-valued params (numpy arrays and nested dicts/lists/tuples of them)
are flattened; the header records the tree spec, dtypes and shapes; the
buffers are the arrays' raw bytes.  Scalars, strings and lists of plain
Python stay in the JSON header.

* **encode** copies each contiguous leaf once, straight into the frame.
* **decode** takes read-only ``memoryview`` slices of the frame and
  ``np.frombuffer``s each leaf in place: zero copies, and every decoded
  array is read-only.
* **fan-out**: `SharedPayload` serializes a payload once for a whole
  broadcast; each receiver's frame varies only in its small JSON header.

A torn or truncated frame raises ``ValueError`` from every decode entry
point.  ``CODEC_COUNTS`` counts payload encodes/decodes and per-leaf
copies, so tests can pin "one encode per broadcast".
"""

from __future__ import annotations

import json
import struct
import time
from typing import Any, Dict, List, Optional

import numpy as np

from fedml_tpu_torch.obs import telemetry

_HDR = struct.Struct("<I")

# codec spy counters (module-global, monotonically increasing):
#   payload_encodes — array-section serializations (one per to_bytes with
#                     array params; ONE per SharedPayload regardless of
#                     fan-out width)
#   payload_decodes — array-section decodes
#   leaf_copies     — per-leaf byte copies paid while encoding (1 per
#                     contiguous leaf, 2 for a non-contiguous one)
CODEC_COUNTS = {"payload_encodes": 0, "payload_decodes": 0, "leaf_copies": 0}


def _encode_params(params: Dict[str, Any], idx_offset: int = 0):
    """Serialize the array half of ``params``.

    Returns ``(header, buffers, n_buffers)`` where ``header`` is the
    JSON-able ``{"plain": ..., "arrays": ...}`` dict (buffer indices start
    at ``idx_offset``), and ``buffers`` is the flat ``[len-prefix,
    memoryview, ...]`` part list whose concatenation is the frame's buffer
    section — each part a view into the SOURCE array, so the single copy
    per leaf happens where the caller materializes the frame.
    """
    header: Dict[str, Any] = {"plain": {}, "arrays": {}}
    parts: List[Any] = []
    n_buffers = 0
    for key, value in params.items():
        leaves, spec = _flatten_arrays(value)
        if leaves is None:
            header["plain"][key] = value
        else:
            descr = []
            for leaf in leaves:
                src = np.asarray(leaf)
                arr = np.ascontiguousarray(src)
                if arr is not src:
                    CODEC_COUNTS["leaf_copies"] += 1
                CODEC_COUNTS["leaf_copies"] += 1  # the copy into the frame
                # ascontiguousarray promotes 0-d to shape (1,) — record
                # the ORIGINAL shape so 0-d leaves round-trip exactly
                descr.append({"dtype": arr.dtype.str, "shape": src.shape,
                              "idx": idx_offset + n_buffers})
                parts.append(_HDR.pack(arr.nbytes))
                # empty leaves cannot be cast to a flat byte view
                parts.append(memoryview(arr).cast("B") if arr.nbytes
                             else b"")
                n_buffers += 1
            header["arrays"][key] = {"spec": spec, "leaves": descr}
    if n_buffers:
        CODEC_COUNTS["payload_encodes"] += 1
    return header, parts, n_buffers


def _freeze_parts(parts: List[Any]) -> bytearray:
    """Materialize an ``_encode_params`` part list into one preallocated
    buffer (the single copy per leaf)."""
    total = sum(len(p) if isinstance(p, bytes) else p.nbytes for p in parts)
    block = bytearray(total)
    mv = memoryview(block)
    off = 0
    for p in parts:
        n = len(p) if isinstance(p, bytes) else p.nbytes
        mv[off:off + n] = p
        off += n
    return block


def _parse_buffer_stream(mv: memoryview, buffers: List[memoryview]) -> None:
    """Walk one ``[4-byte len][raw bytes]...`` stream, appending read-only
    views.  Raises ``ValueError`` on a torn/truncated stream."""
    offset, end = 0, len(mv)
    while offset < end:
        if offset + _HDR.size > end:
            raise ValueError(
                f"torn frame: {end - offset} trailing bytes where a "
                f"{_HDR.size}-byte buffer length was expected")
        (n,) = _HDR.unpack_from(mv, offset)
        offset += _HDR.size
        if offset + n > end:
            raise ValueError(
                f"truncated frame: buffer {len(buffers)} declares {n} "
                f"bytes but only {end - offset} remain")
        buffers.append(mv[offset:offset + n])
        offset += n


def _readonly(data) -> memoryview:
    mv = data if isinstance(data, memoryview) else memoryview(data)
    return mv if mv.readonly else mv.toreadonly()


class Message:
    """Key-value message envelope (type, sender, receiver, params)."""

    # canonical param keys, mirroring the reference's Message constants
    # (message.py:9-24) so algorithm choreography reads the same
    ARG_TYPE = "msg_type"
    ARG_SENDER = "sender"
    ARG_RECEIVER = "receiver"
    ARG_MODEL_PARAMS = "model_params"
    ARG_NUM_SAMPLES = "num_samples"
    ARG_CLIENT_INDEX = "client_idx"
    ARG_ROUND = "round_idx"
    ARG_ACCEPTED = "accepted_silos"  # silo ids aggregated last round (EF ack)
    ARG_EDGE_COUNT = "edge_count"    # uploads folded into a pre-reduced
    #                                  edge update (multi-level topology).
    #                                  DIAGNOSTIC-ONLY: the root's
    #                                  aggregation weights ride
    #                                  ARG_NUM_SAMPLES; this field exists
    #                                  for wire-level observability and
    #                                  tests, nothing load-bearing reads it
    ARG_HEALTH = "health_summary"    # compact per-round learning-health
    #                                  rollup an edge aggregator ships
    #                                  inside its existing edge frame
    #                                  (obs/health.compact_summary) — the
    #                                  tree stays one-frame-per-round;
    #                                  DIAGNOSTIC-ONLY like ARG_EDGE_COUNT
    ARG_SHARD = "shard_idx"          # sharded global-model spine
    #                                  (shard_spine/): which
    #                                  shard's slice this frame carries —
    #                                  broadcasts ship S per-shard
    #                                  frames (one encode-once
    #                                  SharedPayload per SHARD, never
    #                                  per receiver) and uploads arrive
    #                                  as S slice frames screened per
    #                                  shard before any fold
    ARG_SHARD_COUNT = "shard_count"  # S, on every shard frame (a lone
    #                                  slice is meaningless without it)
    ARG_SHARD_SPEC = "shard_spec"    # the plan descriptor (plain JSON,
    #                                  rides shard 0's sync frame) — a
    #                                  silo rebuilds split/join from it
    #                                  with zero configuration, like the
    #                                  secagg masking parameters
    ARG_SECAGG = "secagg"            # secure-aggregation protocol frames
    #                                  (secure/protocol.py): the sync
    #                                  broadcast's masking parameters
    #                                  (group/threshold/clip/weight_cap),
    #                                  a silo's advert (pk + Shamir share
    #                                  envelopes), the roster relay, and
    #                                  the unmask request/reveal payloads
    #                                  — all plain-JSON dicts of ints, so
    #                                  they ride the header beside the
    #                                  masked uint32 model payload
    # span context (obs/trace.py CTX_KEY): a {"t","s"} dict riding the
    # plain JSON header, so one federated round stitches into a single
    # cross-process trace
    ARG_TRACE = "_trace"

    def __init__(self, msg_type: int | str = 0, sender_id: int = 0,
                 receiver_id: int = 0):
        self.params: Dict[str, Any] = {
            self.ARG_TYPE: msg_type,
            self.ARG_SENDER: sender_id,
            self.ARG_RECEIVER: receiver_id,
        }
        # encode-once fan-out: build_fanout() points every sibling of a
        # broadcast at ONE SharedPayload, and to_bytes() reuses its
        # already-serialized block instead of re-encoding the model bytes
        self._shared: Optional["SharedPayload"] = None
        # a decoded frame keeps its header's array descriptors and buffer
        # views, so the ingest arena can stage a payload without a tree
        # walk (`raw_payload`)
        self._arrays: Optional[dict] = None
        self._buffers: Optional[List[memoryview]] = None

    # -- accessors (reference message.py:26-60) ------------------------------
    @property
    def type(self):
        return self.params[self.ARG_TYPE]

    @property
    def sender_id(self) -> int:
        return self.params[self.ARG_SENDER]

    @property
    def receiver_id(self) -> int:
        return self.params[self.ARG_RECEIVER]

    def add(self, key: str, value: Any) -> "Message":
        self.params[key] = value
        return self

    def get(self, key: str, default: Any = None) -> Any:
        return self.params.get(key, default)

    def __repr__(self):
        keys = [k for k in self.params
                if k not in (self.ARG_TYPE, self.ARG_SENDER, self.ARG_RECEIVER)]
        return (f"Message(type={self.type}, {self.sender_id}->"
                f"{self.receiver_id}, params={keys})")

    # -- binary codec --------------------------------------------------------
    def to_bytes(self) -> bytes:
        """One frame: header + buffer stream (byte-identical to the
        historical format — old/new nodes interoperate, and chaos-replay
        seeds keyed on frame sizes stay valid).  Each contiguous array
        leaf is copied exactly once, by the final join."""
        shared = self._shared
        if shared is not None:
            return shared.frame_bytes(self)
        t0 = time.perf_counter()
        header, parts, n_buffers = _encode_params(self.params)
        hdr = json.dumps(header).encode()
        frame = b"".join([_HDR.pack(len(hdr)), hdr] + parts)
        if n_buffers:
            _observe_encode(time.perf_counter() - t0)
        return frame

    def frame_parts(self) -> List[Any]:
        """The frame as a list of buffer segments (zero-copy where a
        shared payload is attached) — for transports that can scatter
        instead of joining.  ``b"".join(map(bytes, parts))`` is always
        byte-identical to ``to_bytes()``."""
        shared = self._shared
        if shared is not None:
            return shared.frame_parts(self)
        return [self.to_bytes()]

    @classmethod
    def from_bytes(cls, data) -> "Message":
        """Zero-copy decode: array leaves are read-only views into
        ``data``.  Raises ``ValueError`` for any torn, truncated, or
        structurally damaged frame — callers on receive threads catch it
        and drop the frame (counting ``fedml_wire_torn_frames_total``)."""
        mv = _readonly(data)
        if len(mv) < _HDR.size:
            raise ValueError(
                f"truncated frame: {len(mv)} bytes is shorter than the "
                f"{_HDR.size}-byte header length")
        (hlen,) = _HDR.unpack_from(mv, 0)
        if _HDR.size + hlen > len(mv):
            raise ValueError(
                f"truncated frame: header declares {hlen} bytes but only "
                f"{len(mv) - _HDR.size} follow")
        header = cls._parse_header(mv[_HDR.size:_HDR.size + hlen])
        buffers: List[memoryview] = []
        _parse_buffer_stream(mv[_HDR.size + hlen:], buffers)
        return cls._from_header(header, buffers)

    @classmethod
    def from_frame_parts(cls, parts) -> "Message":
        """Decode a `frame_parts` segment list without materializing one
        contiguous frame: segment 0 is ``[hdr len][hdr][buffers...]``,
        later segments are pure buffer streams."""
        mv0 = _readonly(parts[0])
        if len(mv0) < _HDR.size:
            raise ValueError("truncated frame: empty header segment")
        (hlen,) = _HDR.unpack_from(mv0, 0)
        if _HDR.size + hlen > len(mv0):
            raise ValueError("truncated frame: header crosses segments")
        header = cls._parse_header(mv0[_HDR.size:_HDR.size + hlen])
        buffers: List[memoryview] = []
        _parse_buffer_stream(mv0[_HDR.size + hlen:], buffers)
        for part in parts[1:]:
            _parse_buffer_stream(_readonly(part), buffers)
        return cls._from_header(header, buffers)

    @staticmethod
    def _parse_header(mv: memoryview) -> dict:
        try:
            header = json.loads(bytes(mv))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise ValueError(f"undecodable frame header: {exc}") from exc
        if (not isinstance(header, dict)
                or not isinstance(header.get("plain"), dict)
                or not isinstance(header.get("arrays"), dict)):
            raise ValueError("malformed frame header: expected "
                             "{'plain': {...}, 'arrays': {...}}")
        return header

    def raw_payload(self, key: str):
        """The raw-frame view of one array param, for the ingest arena:
        ``(leaf_descriptors, spec, buffers)``, header facts plus the
        frame's zero-copy buffer views.  None when the message never
        crossed the wire or carries no such array param."""
        if self._arrays is None or self._buffers is None:
            return None
        info = self._arrays.get(key)
        if not isinstance(info, dict):
            return None
        try:
            return info["leaves"], info["spec"], self._buffers
        except (TypeError, KeyError):
            return None

    @classmethod
    def _from_header(cls, header: dict, buffers: List[memoryview]):
        msg = cls.__new__(cls)
        msg._shared = None
        msg._arrays = header["arrays"]
        msg._buffers = buffers
        msg.params = dict(header["plain"])
        decoded_payload = False
        for key, info in header["arrays"].items():
            leaves = []
            try:
                descr = info["leaves"]
            except (TypeError, KeyError) as exc:
                raise ValueError(f"malformed array header for {key!r}") \
                    from exc
            for d in descr:
                try:
                    idx, dtype, shape = d["idx"], d["dtype"], d["shape"]
                except (TypeError, KeyError) as exc:
                    raise ValueError(
                        f"malformed leaf descriptor for {key!r}") from exc
                if not isinstance(idx, int) or not 0 <= idx < len(buffers):
                    raise ValueError(
                        f"frame header references buffer {idx!r} but only "
                        f"{len(buffers)} arrived")
                try:
                    arr = np.frombuffer(buffers[idx], dtype=np.dtype(dtype))
                    leaves.append(arr.reshape(shape))
                except (TypeError, ValueError) as exc:
                    raise ValueError(
                        f"buffer {idx} does not match its declared "
                        f"dtype/shape ({dtype}, {shape}): {exc}") from exc
            decoded_payload = decoded_payload or bool(descr)
            try:
                msg.params[key] = _unflatten_arrays(info["spec"], leaves)
            except (TypeError, KeyError, IndexError) as exc:
                raise ValueError(
                    f"malformed pytree spec for {key!r}") from exc
        if decoded_payload:
            CODEC_COUNTS["payload_decodes"] += 1
        return msg


class SharedPayload:
    """Encode-once payload for a transport fan-out (``send_many``).

    The expensive serialization — flattening the pytree and copying every
    array leaf — runs ONCE, here, into one immutable block.  Each
    receiver's frame is then ``[hdr][shared block][own block]``: only the
    small JSON header (and any receiver-private params, e.g. the trace
    context or ``client_idx``) varies per receiver.  The shared block is
    never mutated after construction, so a wrapper that damages one
    receiver's payload (chaos ``corrupt``) must — and does — drop its
    message's reference to this object and re-encode its own copy.
    """

    def __init__(self, params: Dict[str, Any]):
        self.keys = frozenset(params)
        self.params = dict(params)
        t0 = time.perf_counter()
        self._header, parts, self._n_buffers = _encode_params(params)
        self._block = _freeze_parts(parts)
        # the arrays section (one descriptor per leaf — the bulk of a big
        # model's header) is identical for every receiver: serialize its
        # JSON once so each receiver's header costs only its few plain
        # keys, keeping fan-out cost flat in BOTH payload and leaf count
        self._arrays_json = json.dumps(self._header["arrays"]).encode()
        if self._n_buffers:
            _observe_encode(time.perf_counter() - t0)

    def _header_and_own(self, msg: Message):
        own = {k: v for k, v in msg.params.items() if k not in self.keys}
        hdr_own, own_parts, _ = _encode_params(own,
                                               idx_offset=self._n_buffers)
        plain = {**self._header["plain"], **hdr_own["plain"]}
        if not hdr_own["arrays"]:
            # splice the cached arrays JSON around this receiver's plain
            # keys — same document shape json.dumps would produce
            hdr = (b'{"plain": ' + json.dumps(plain).encode()
                   + b', "arrays": ' + self._arrays_json + b'}')
            return hdr, own_parts
        header = {"plain": plain,
                  "arrays": {**self._header["arrays"], **hdr_own["arrays"]}}
        return json.dumps(header).encode(), own_parts

    def frame_bytes(self, msg: Message) -> bytes:
        """A standalone contiguous frame for single-buffer wires (gRPC,
        MQTT): one memcpy of the already-encoded shared block, no
        re-serialization."""
        hdr, own_parts = self._header_and_own(msg)
        return b"".join([_HDR.pack(len(hdr)), hdr, self._block] + own_parts)

    def frame_parts(self, msg: Message) -> List[Any]:
        """The zero-copy form: ``[prefix, shared-block view, own...]`` —
        the shared block is not copied at all (the in-process hub decodes
        straight from the view)."""
        hdr, own_parts = self._header_and_own(msg)
        parts: List[Any] = [_HDR.pack(len(hdr)) + hdr,
                            memoryview(self._block).toreadonly()]
        if own_parts:
            parts.append(bytes(_freeze_parts(own_parts)))
        return parts


def build_fanout(msg_type, sender_id: int, receivers,
                 shared_params: Optional[Dict[str, Any]] = None,
                 per_receiver_params: Optional[Dict[int, Dict[str, Any]]]
                 = None) -> List[Message]:
    """Build one `Message` per receiver, all sharing ONE encoded payload.

    ``shared_params`` (the model bytes, round tag, EF ack) serialize once;
    ``per_receiver_params[r]`` (e.g. ``client_idx``) ride each receiver's
    JSON header.  Every message also carries the shared params in
    ``msg.params`` BY REFERENCE, so in-process delivery and wrappers that
    inspect payloads (chaos corrupt, observers) see a normal message.

    The two key sets must be disjoint: a per-receiver override of a
    shared key would be honored by in-process delivery but dropped from
    the wire frame (the shared block is immutable), a silent
    backend-dependent divergence — so it is rejected here instead.
    """
    shared = SharedPayload(shared_params or {})
    per_receiver_params = per_receiver_params or {}
    for receiver, own in per_receiver_params.items():
        clash = shared.keys & set(own)
        if clash:
            raise ValueError(
                f"per-receiver params for {receiver} override shared "
                f"keys {sorted(clash)}; shared-payload values cannot "
                f"vary per receiver — send those keys per-receiver only")
    out = []
    for receiver in receivers:
        msg = Message(msg_type, sender_id, receiver)
        msg.params.update(shared.params)
        msg.params.update(per_receiver_params.get(receiver, {}))
        msg._shared = shared
        out.append(msg)
    return out


def _observe_encode(seconds: float) -> None:
    reg = telemetry.get_registry()
    if reg.enabled:
        reg.histogram("fedml_wire_encode_seconds").observe(seconds)


def _is_array(x) -> bool:
    if isinstance(x, (np.ndarray, np.generic)):  # includes 0-d numpy scalars
        return True
    return hasattr(x, "__array__") and hasattr(x, "dtype") and hasattr(x, "shape")


def _flatten_arrays(value):
    """Flatten a pytree-of-arrays into (leaves, json-able spec).

    Returns (None, None) when the value contains no arrays — it then travels
    in the JSON header verbatim.  Supports dict/list/tuple nests of arrays,
    the shapes model params (nested dicts) and stacked batches take.
    """
    if _is_array(value):
        return [value], {"k": "leaf"}
    if isinstance(value, dict):
        if not any(_contains_array(v) for v in value.values()):
            return None, None
        keys = sorted(value.keys())
        leaves, specs = [], []
        for k in keys:
            sub_leaves, sub_spec = _flatten_arrays(value[k])
            if sub_leaves is None:  # plain sub-value inside an array dict
                sub_leaves, sub_spec = [], {"k": "plain", "v": value[k]}
            leaves.extend(sub_leaves)
            specs.append(sub_spec)
        return leaves, {"k": "dict", "keys": keys, "children": specs}
    if isinstance(value, (list, tuple)):
        if not any(_contains_array(v) for v in value):
            return None, None
        leaves, specs = [], []
        for v in value:
            sub_leaves, sub_spec = _flatten_arrays(v)
            if sub_leaves is None:
                sub_leaves, sub_spec = [], {"k": "plain", "v": v}
            leaves.extend(sub_leaves)
            specs.append(sub_spec)
        kind = "tuple" if isinstance(value, tuple) else "list"
        return leaves, {"k": kind, "children": specs}
    return None, None


def _contains_array(value) -> bool:
    if _is_array(value):
        return True
    if isinstance(value, dict):
        return any(_contains_array(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_contains_array(v) for v in value)
    return False


def _unflatten_arrays(spec, leaves, _pos=None):
    if _pos is None:
        _pos = [0]
    kind = spec["k"]
    if kind == "leaf":
        out = leaves[_pos[0]]
        _pos[0] += 1
        return out
    if kind == "plain":
        return spec["v"]
    if kind == "dict":
        return {k: _unflatten_arrays(c, leaves, _pos)
                for k, c in zip(spec["keys"], spec["children"])}
    children = [_unflatten_arrays(c, leaves, _pos) for c in spec["children"]]
    return tuple(children) if kind == "tuple" else children
