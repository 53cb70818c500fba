"""Cluster model objects (parity: ``clustering/cluster/{Point,Cluster,
ClusterSet,PointClassification}.java``).

Host-side value objects; the math lives in :mod:`kmeans` on device.

The port's copy of the JAX package's ``clustering/cluster.py``: the same
objects; a point's distance and classification take the port's
:func:`~.bruteforce.pairwise_distance` and :func:`~.bruteforce.knn` on
host tensors, where the reference's lazy calls ran on its default device.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Point:
    """A labelled vector (``cluster/Point.java``)."""
    array: np.ndarray
    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    label: Optional[str] = None

    @staticmethod
    def to_points(matrix) -> List["Point"]:
        return [Point(np.asarray(row, np.float32)) for row in np.asarray(matrix)]


@dataclass
class PointClassification:
    """Result of classifying a point into a cluster set
    (``cluster/PointClassification.java``)."""
    cluster: "Cluster"
    distance_from_center: float
    new_location: bool


class Cluster:
    """A center plus its member points (``cluster/Cluster.java``)."""

    def __init__(self, center: np.ndarray, distance: str = "euclidean",
                 id: Optional[str] = None, label: Optional[str] = None):
        self.id = id or str(uuid.uuid4())
        self.label = label
        self.center = np.asarray(center, np.float32)
        self.distance = distance
        self.points: List[Point] = []

    def distance_to_center(self, point: Point) -> float:
        from .bruteforce import pairwise_distance
        d = pairwise_distance(np.asarray(point.array)[None, :],
                              np.asarray(self.center)[None, :], self.distance)
        return float(d[0, 0])

    def add_point(self, point: Point, move_center: bool = False) -> None:
        self.points.append(point)
        if move_center:
            self.center = np.mean([p.array for p in self.points], axis=0)

    def is_empty(self) -> bool:
        return not self.points


class ClusterSet:
    """All clusters of one run (``cluster/ClusterSet.java``)."""

    def __init__(self, distance: str = "euclidean"):
        self.distance = distance
        self.clusters: List[Cluster] = []

    def add_new_cluster_with_center(self, center: np.ndarray) -> Cluster:
        c = Cluster(center, self.distance)
        self.clusters.append(c)
        return c

    @property
    def cluster_count(self) -> int:
        return len(self.clusters)

    def get_centers(self) -> np.ndarray:
        return np.stack([c.center for c in self.clusters])

    def classify_point(self, point: Point, move_center: bool = False) -> PointClassification:
        from .bruteforce import knn
        d, i = knn(np.asarray(point.array)[None, :],
                   self.get_centers(), 1, self.distance)
        best = self.clusters[int(i[0, 0])]
        new_location = point.id not in {p.id for p in best.points}
        if new_location:
            for c in self.clusters:
                c.points = [p for p in c.points if p.id != point.id]
            best.add_point(point, move_center)
        return PointClassification(best, float(d[0, 0]), new_location)

    def classify_points(self, points: List[Point], move_centers: bool = False) -> None:
        for p in points:
            self.classify_point(p, move_centers)

    def remove_empty_clusters(self) -> List[Cluster]:
        empty = [c for c in self.clusters if c.is_empty()]
        self.clusters = [c for c in self.clusters if not c.is_empty()]
        return empty
