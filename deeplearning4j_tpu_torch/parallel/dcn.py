"""Cross-slice gradient bridge: threshold-compressed update exchange
between separately trained replicas.

Counterpart of ``deeplearning4j_tpu/parallel/dcn.py`` (the reference's
Aeron path: ``SharedTrainingMaster.java:493``, ``WiredEncodingHandler.java:96``,
``EncodedGradientsAccumulator.java:257``). Each endpoint adds its
parameters' movement since the last exchange to a residual per tensor,
threshold-encodes it with the native codec (``native/codec.py``: signed
1-based int32 indices), and sends one frame over any transport with
``publish(bytes)`` / ``poll(timeout) -> bytes`` (a socket pair, an
``EmbeddedBroker`` topic, Kafka); the receiver decodes and adds it to its
parameters. Updates below the threshold stay in the residual.

The frame is the reference's, byte layout and header keys alike: a 4-byte
big-endian header length, the JSON header (``slice``, ``seq``, ``inc``,
``host``, ``threshold``, ``sections`` and, when tracing, ``tp``), then each
section's payload (int32 indices, or raw float32 when ``count`` is -1, the
dense fallback). So a frame from either package applies in the other.

The parameters stay torch tensors on the network's device: the encode and
decode run on host copies (the codec is host code, as in the reference),
and a received update is added to the tensors in place, so that the
fused updater keeps holding the network's own tensors.
"""

from __future__ import annotations

import json
import logging
import struct
import uuid
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.native import decode_threshold, encode_threshold, extract_threshold
from deeplearning4j_tpu_torch.nn.train_step import to_host
from deeplearning4j_tpu_torch.observe.trace import parse_traceparent
from deeplearning4j_tpu_torch.observe.trace import span as _span
from deeplearning4j_tpu_torch.util import faultinject

log = logging.getLogger(__name__)


def _flat_host(t) -> np.ndarray:
    return np.asarray(to_host(t), np.float32).reshape(-1)


class CrossSliceGradientBridge:
    """One endpoint of the exchange. ``publisher`` / ``consumer`` carry
    opaque frames; each endpoint keeps its own residual per parameter
    tensor."""

    def __init__(self, publisher, consumer, threshold: float = 1e-3,
                 capacity_fraction: float = 0.25, slice_id: str = "slice",
                 host: Optional[int] = None):
        self.publisher = publisher
        self.consumer = consumer
        self.threshold = float(threshold)
        self.capacity_fraction = capacity_fraction
        self.slice_id = slice_id
        # the host failure domain of this endpoint, carried in every frame
        # so that a receiver can honour a partition between host groups
        self.host = faultinject.current_host() if host is None else host
        # {layer key: {param: flat f32 residual}}; _prev holds the values
        # as of the last exchange
        self._residual: Optional[Dict] = None
        self._prev: Optional[Dict] = None
        # a monotone frame sequence, so that receivers drop replays; the
        # incarnation tells a restarted sender (seq back at 0) from a replay
        self._seq = 0
        self._incarnation = uuid.uuid4().hex[:8]
        # slice -> {incarnation: high-water seq}
        self._last_seq: Dict[str, Dict[str, int]] = {}

    @staticmethod
    def _layers(params):
        """``(key, {name: tensor})`` in order: a dict of layers (both of the
        port's networks) by sorted key, a list by index."""
        if isinstance(params, dict):
            return sorted(params.items())
        return list(enumerate(params))

    def _ensure_residual(self, params) -> None:
        if self._residual is None:
            self._residual = {lk: {k: np.zeros(int(v.numel()), np.float32)
                                   for k, v in layer.items()}
                              for lk, layer in self._layers(params)}
            self._prev = {lk: {k: _flat_host(v).copy() for k, v in layer.items()}
                          for lk, layer in self._layers(params)}

    def publish_update(self, params) -> int:
        """Add the parameters' movement since the last call to the
        residual, encode what reaches the threshold and send ONE frame.
        Returns the bytes sent (0, and no frame, when nothing reached the
        threshold). The residual gives up what was sent only after the
        publish succeeded: a transport failure keeps the mass for the next
        round."""
        self._ensure_residual(params)
        sections, blobs, pending, total = [], [], [], 0
        for lk, layer in self._layers(params):
            for k in sorted(layer):
                cur = _flat_host(layer[k])
                delta = cur - self._prev[lk][k]
                self._prev[lk][k] = cur.copy()
                r = self._residual[lk][k]
                r += delta
                cap = max(16, int(len(r) * self.capacity_fraction))
                msg = encode_threshold(r, self.threshold, capacity=cap)
                if msg is None:
                    # too dense for the sparse format: the raw residual
                    # (count -1), never left unsynced
                    sections.append({"layer": lk, "param": k, "count": -1, "size": len(r)})
                    blobs.append(r.astype(np.float32).tobytes())
                    pending.append((r, None))
                    total += len(r)
                elif len(msg):
                    sections.append({"layer": lk, "param": k, "count": len(msg),
                                     "size": len(r)})
                    blobs.append(msg.tobytes())
                    pending.append((r, msg))
                    total += len(msg)
        if total == 0:
            return 0
        seq = self._seq
        # consumed before the publish: a publish that raises after the
        # bytes left must not make the next exchange reuse this number
        self._seq = seq + 1
        with _span("dcn_send", category="dcn",
                   attrs={"slice": self.slice_id, "seq": seq,
                          "sections": len(sections)}) as sp:
            header_obj = {"slice": self.slice_id, "seq": seq, "inc": self._incarnation,
                          "host": self.host, "threshold": self.threshold,
                          "sections": sections}
            if sp is not None:
                # the receiver links its dcn_recv span to this one
                header_obj["tp"] = sp.context.traceparent()
            header = json.dumps(header_obj).encode()
            frame = struct.pack(">I", len(header)) + header + b"".join(blobs)
            if sp is not None:
                sp.set_attribute("bytes", len(frame))
            for out in faultinject.on_dcn_send(self.slice_id, seq, frame, host=self.host):
                # an injected [] drops the frame in transit, after the
                # sender committed, like a frame lost on the wire
                self.publisher.publish(out)  # may raise: the residual stays
        for r, msg in pending:
            if msg is None:
                r[:] = 0.0  # the dense payload carried the whole residual
            else:
                extract_threshold(r, self.threshold, msg)
        return len(frame)

    def poll_and_apply(self, params, timeout: float = 0.0, max_messages: int = 16):
        """Add every pending remote frame to ``params``, in place; returns
        ``(params, frames applied)``."""
        self._ensure_residual(params)
        applied = 0
        dense: Optional[Dict] = None
        for _ in range(max_messages):
            frame = self.consumer.poll(timeout=timeout)
            if frame is None:
                break
            try:
                hlen = struct.unpack(">I", frame[:4])[0]
                meta = json.loads(frame[4:4 + hlen].decode())
                slice_tag = meta.get("slice")
                thr = float(meta["threshold"])
                sections = meta["sections"]
            except (struct.error, json.JSONDecodeError, UnicodeDecodeError,
                    KeyError, ValueError, TypeError) as e:
                log.warning("Dropping unparseable frame: %s", e)
                continue
            if slice_tag == self.slice_id:
                continue  # our own frame echoed back by a broker's fan-out
            seq = meta.get("seq")
            if seq is not None and not faultinject.on_dcn_recv(
                    self.slice_id, int(seq), frame_host=meta.get("host"), host=self.host):
                log.warning("Dropping frame %s from %s: DCN partition between host "
                            "groups %s and %s", seq, slice_tag, self.host, meta.get("host"))
                continue
            if seq is not None:
                peer = self._last_seq.setdefault(slice_tag, {})
                inc = meta.get("inc")
                last = peer.get(inc)
                if last is not None and int(seq) <= last:
                    log.warning("Dropping duplicate frame %s from %s", seq, slice_tag)
                    continue
                peer[inc] = int(seq)
            if dense is None:
                dense = {lk: {k: np.zeros(int(v.numel()), np.float32)
                              for k, v in layer.items()}
                         for lk, layer in self._layers(params)}
            with _span("dcn_recv", category="dcn",
                       attrs={"slice": self.slice_id, "from": slice_tag,
                              "seq": seq, "bytes": len(frame)}) as sp:
                if sp is not None:
                    sp.add_link(parse_traceparent(meta.get("tp")))
                decoded_any = self._decode_frame(frame, hlen, sections, thr, dense, meta)
            if decoded_any:
                applied += 1
        if dense is None or applied == 0:
            return params, 0
        with torch.no_grad():
            for lk, layer in self._layers(params):
                for k, v in layer.items():
                    v.add_(torch.from_numpy(dense[lk][k]).to(device=v.device, dtype=v.dtype)
                           .reshape(v.shape))
                    # the movement just applied must not re-enter the deltas
                    self._prev[lk][k] = _flat_host(v).copy()
        return params, applied

    def _decode_frame(self, frame, hlen, sections, thr, dense, meta) -> bool:
        """Decode one frame's sections into ``dense``; False for a
        malformed frame (dropped without touching the frames already
        decoded in this call)."""
        off = 4 + hlen
        decoded_any = False
        try:
            for s in sections:
                count, size = int(s["count"]), int(s["size"])
                if count < -1 or size < 0:
                    raise ValueError("negative section count/size")
                is_dense = count == -1
                n_bytes = (size if is_dense else count) * 4
                if off + n_bytes > len(frame):
                    raise ValueError("frame truncated mid-section")
                payload = frame[off:off + n_bytes]
                off += n_bytes
                lk = s["layer"]
                # checked against the local model: an unknown name or a
                # size mismatch is skipped, never written out of bounds
                target = dense.get(lk, {}).get(s["param"]) \
                    if isinstance(dense.get(lk), dict) else None
                if target is None or len(target) != size:
                    log.warning("Skipping mismatched section %r/%r from %s",
                                lk, s["param"], meta.get("slice"))
                    continue
                if is_dense:
                    target += np.frombuffer(payload, np.float32)
                else:
                    decode_threshold(np.frombuffer(payload, np.int32), thr, len(target),
                                     out=target)
                decoded_any = decoded_any or n_bytes > 0
        except (ValueError, KeyError, TypeError) as e:
            log.warning("Dropping malformed frame from %s: %s", meta.get("slice"), e)
            return False
        return decoded_any
