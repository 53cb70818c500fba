"""Nearest-neighbors REST server + client.

Parity with the reference's serving stack
(`deeplearning4j-nearestneighbor-server/.../NearestNeighborsServer.java:42`
— Play HTTP routes ``POST /knn`` (query by index into the served corpus) and
``POST /knnnew`` (query by raw vector), JCommander CLI flags — and the
``-client`` / ``-model`` modules' request/response records), built on stdlib
``http.server`` with JSON bodies. Queries run on the MXU brute-force k-NN
path by default (one device matmul beats host VP-tree traversal for the
corpus sizes a REST hop implies), with VPTree as the host fallback.

The port's copy of the JAX package's ``clustering/server.py``: the same
routes, JSON bodies, status codes and flags, on the port's
``observe.metrics`` and its brute-force index; the ``invert`` branch takes
the port's :func:`~.bruteforce.pairwise_distance` on the index's device
(the host with ``use_device=False``). With ``use_device=True`` the corpus
goes to the card unless the server is given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import urlparse

import numpy as np


class NearestNeighbor:
    """One result record (nearestneighbor-model's NearestNeighbor)."""

    def __init__(self, index: int, distance: float):
        self.index = int(index)
        self.distance = float(distance)

    def to_dict(self):
        return {"index": self.index, "distance": self.distance}


class NearestNeighborsServer:
    """Serves k-NN queries over a fixed corpus of points.

    Endpoints:
      - ``POST /knn``     body ``{"ndarray": <index>, "k": n}`` — neighbors of
        an existing corpus row (reference ``/knn`` semantics)
      - ``POST /knnnew``  body ``{"ndarray": [floats], "k": n}`` — neighbors
        of a new point
      - ``GET  /labels``  the optional label list
    """

    def __init__(self, points, labels: Optional[List[str]] = None,
                 similarity_function: str = "euclidean", invert: bool = False,
                 port: int = 9200, use_device: bool = True, metrics=None,
                 device=None):
        self.points = np.asarray(points, np.float32)
        self.labels = labels
        self.similarity_function = similarity_function
        self.invert = invert
        self.port = port
        self._httpd = None
        self._thread = None
        # optional shared observability core (observe.metrics registry)
        self._observe = None
        if metrics is not None:
            from deeplearning4j_tpu_torch.observe.metrics import instrument_http
            self._observe = instrument_http(metrics, "knn")
        if use_device:
            from deeplearning4j_tpu_torch.clustering.bruteforce import (
                BruteForceNearestNeighbors)
            self._index = BruteForceNearestNeighbors(
                self.points, distance=similarity_function, device=device)
            self._vptree = None
        else:
            from deeplearning4j_tpu_torch.clustering.vptree import VPTree
            self._vptree = VPTree(self.points, distance=similarity_function)
            self._index = None

    # -- query -----------------------------------------------------------
    def query(self, point: np.ndarray, k: int,
              exclude_index: Optional[int] = None) -> List[NearestNeighbor]:
        k_eff = min(k + (1 if exclude_index is not None else 0),
                    len(self.points))
        if self.invert:
            # inverted metric (farthest-first, the reference's --invert):
            # one full distance row, reversed order
            from deeplearning4j_tpu_torch.clustering.bruteforce import (
                as_tensor, pairwise_distance)
            corpus = (self._index.points if self._index is not None
                      else as_tensor(self.points))
            d = pairwise_distance(as_tensor(point[None, :], corpus.device), corpus,
                                  self.similarity_function)[0].cpu().numpy()
            idx = np.argsort(-d)[:k_eff]
            dist = d[idx]
        elif self._index is not None:
            dist, idx = self._index.search(point[None, :], k_eff)
            idx, dist = np.asarray(idx[0]), np.asarray(dist[0])
        else:
            dist, idx = self._vptree.search(point, k_eff)
        out = []
        for i, d in zip(idx, dist):
            if exclude_index is not None and int(i) == exclude_index:
                continue
            out.append(NearestNeighbor(int(i), float(d)))
        return out[:k]

    # -- http ------------------------------------------------------------
    def start(self) -> int:
        server = self

        from deeplearning4j_tpu_torch.observe.metrics import HTTPObserverMixin

        class Handler(HTTPObserverMixin, BaseHTTPRequestHandler):
            observe = server._observe

            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if urlparse(self.path).path == "/labels":
                    self._json({"labels": server.labels or []})
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                path = urlparse(self.path).path
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    req = json.loads(self.rfile.read(n).decode())
                    k = int(req.get("k", 1))
                    if path == "/knn":
                        i = int(req["ndarray"])
                        if not 0 <= i < len(server.points):
                            self._json({"error": f"index {i} out of range"}, 400)
                            return
                        res = server.query(server.points[i], k, exclude_index=i)
                    elif path == "/knnnew":
                        point = np.asarray(req["ndarray"], np.float32)
                        if point.shape != server.points.shape[1:]:
                            self._json({"error":
                                        f"expected dim {server.points.shape[1]}"},
                                       400)
                            return
                        res = server.query(point, k)
                    else:
                        self._json({"error": "not found"}, 404)
                        return
                    payload = {"results": [r.to_dict() for r in res]}
                    if server.labels:
                        payload["labels"] = [
                            server.labels[r.index] for r in res
                            if r.index < len(server.labels)]
                    self._json(payload)
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    self._json({"error": str(e)}, 400)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # -- CLI (JCommander-flag parity) -------------------------------------
    @staticmethod
    def main(argv: Optional[List[str]] = None,
             device=None) -> "NearestNeighborsServer":
        """Starts a server from the reference's flags; ``device`` places
        its corpus (None: the card)."""
        ap = argparse.ArgumentParser("nearest-neighbors-server")
        ap.add_argument("--ndarrayPath", required=True,
                        help=".npy corpus of shape [n, d]")
        ap.add_argument("--labelsPath", default=None,
                        help="optional text file, one label per row")
        ap.add_argument("--nearestNeighborsPort", type=int, default=9200)
        ap.add_argument("--similarityFunction", default="euclidean")
        ap.add_argument("--invert", action="store_true")
        args = ap.parse_args(argv)
        points = np.load(args.ndarrayPath)
        labels = None
        if args.labelsPath:
            with open(args.labelsPath) as f:
                labels = [l.strip() for l in f]
        server = NearestNeighborsServer(
            points, labels, args.similarityFunction, args.invert,
            args.nearestNeighborsPort, device=device)
        server.start()
        return server


class NearestNeighborsClient:
    """JSON client (`nearestneighbor-client` parity)."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        import urllib.request
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode())

    def knn(self, index: int, k: int) -> dict:
        return self._post("/knn", {"ndarray": int(index), "k": k})

    def knn_new(self, point, k: int) -> dict:
        return self._post("/knnnew",
                          {"ndarray": np.asarray(point).tolist(), "k": k})
