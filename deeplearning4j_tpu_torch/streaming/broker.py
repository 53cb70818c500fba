"""In-process topic broker + TCP transport + streaming DataSet iterator.

``EmbeddedBroker`` plays the role of the reference's embedded Kafka/ZooKeeper
test cluster (`streaming/embedded/EmbeddedKafkaCluster.java`): real topic
semantics (named topics, multiple independent consumer groups, blocking
polls) without any external service. ``SocketPublisher``/``SocketConsumer``
carry the same frames across processes over TCP — the role Kafka plays in
production for the reference.

The port's copy of the JAX package's jax-free ``streaming/broker.py``,
on the port's ``streaming/codec.py``: the frames are the reference's
bytes.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.streaming.codec import (
    deserialize_dataset,
    serialize_dataset,
)


class EmbeddedBroker:
    """Named topics; each consumer group gets every message once."""

    def __init__(self):
        self._topics: Dict[str, Dict[str, "queue.Queue[bytes]"]] = {}
        self._lock = threading.Lock()

    def _groups(self, topic: str) -> Dict[str, "queue.Queue[bytes]"]:
        with self._lock:
            return self._topics.setdefault(topic, {})

    def subscribe(self, topic: str, group: str = "default") -> "queue.Queue[bytes]":
        groups = self._groups(topic)
        with self._lock:
            return groups.setdefault(group, queue.Queue())

    def publish(self, topic: str, payload: bytes) -> None:
        groups = self._groups(topic)
        with self._lock:
            if not groups:
                groups.setdefault("default", queue.Queue())
            targets = list(groups.values())
        for q in targets:
            q.put(payload)

    def poll(self, topic: str, group: str = "default",
             timeout: Optional[float] = None) -> Optional[bytes]:
        q = self.subscribe(topic, group)
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            return None


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    head = b""
    while len(head) < 4:
        chunk = sock.recv(4 - len(head))
        if not chunk:
            return None
        head += chunk
    n = struct.unpack(">I", head)[0]
    # into one buffer of the frame's size: appending each piece to a
    # bytes object copies the frame so far every time (quadratic; about
    # a second for a 20 MB frame)
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], min(65536, n - got))
        if not k:
            return None
        got += k
    return bytes(buf)


class SocketConsumer:
    """Listens on a TCP port, feeding received frames into a local queue
    (the consumer end of the production transport)."""

    def __init__(self, port: int = 0):
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", port))
        self._server.listen(4)
        self.port = self._server.getsockname()[1]
        self.queue: "queue.Queue[bytes]" = queue.Queue()
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn: socket.socket):
        with conn:
            while True:
                frame = _recv_frame(conn)
                if frame is None:
                    return
                self.queue.put(frame)

    def poll(self, timeout: Optional[float] = None) -> Optional[bytes]:
        try:
            return self.queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self):
        self._running = False
        self._server.close()


class SocketPublisher:
    """Publishes frames to a SocketConsumer."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def publish(self, payload: bytes) -> None:
        _send_frame(self._sock, payload)

    def close(self):
        self._sock.close()


class StreamingDataSetIterator:
    """Consumes serialized DataSets from a topic until ``num_batches`` (or a
    poll timeout) — plugs a stream into ``net.fit`` exactly like the
    reference's Camel route → iterator glue."""

    def __init__(self, source, topic: Optional[str] = None,
                 group: str = "default", num_batches: Optional[int] = None,
                 poll_timeout: float = 5.0):
        self.source = source
        self.topic = topic
        self.group = group
        self.num_batches = num_batches
        self.poll_timeout = poll_timeout

    def reset(self) -> None:
        pass  # a stream cannot be rewound

    def _poll(self) -> Optional[bytes]:
        if self.topic is not None:
            return self.source.poll(self.topic, self.group,
                                    timeout=self.poll_timeout)
        return self.source.poll(timeout=self.poll_timeout)

    def __iter__(self):
        n = 0
        while self.num_batches is None or n < self.num_batches:
            frame = self._poll()
            if frame is None:
                return
            yield deserialize_dataset(frame)
            n += 1
