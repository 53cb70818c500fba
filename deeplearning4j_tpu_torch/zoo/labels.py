"""Class labels of the zoo's models.

Counterpart of ``deeplearning4j_tpu/zoo/labels.py`` (DL4J's
``zoo/util/`` ``Labels`` / ``BaseLabels``, ``ImageNetLabels``,
``VOCLabels``, ``COCOLabels``): the 20 VOC and 80 COCO class names are
kept here; ImageNet's 1000-class table loads from a local JSON
(``$DL4J_TPU_ZOO_DIR/imagenet_class_index.json``, the standard
Keras-format index, or a path passed in). ``decode_predictions`` takes
numpy arrays or tensors on any device.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

VOC_CLASSES: Tuple[str, ...] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")

COCO_CLASSES: Tuple[str, ...] = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush")


class ClassPrediction:
    """One decoded prediction (``zoo/util/ClassPrediction.java``)."""

    def __init__(self, number: int, label: str, probability: float):
        self.number = int(number)
        self.label = label
        self.probability = float(probability)

    def __repr__(self):
        return (f"ClassPrediction(number={self.number}, "
                f"label={self.label!r}, probability={self.probability:.4f})")


class Labels:
    """Label-table SPI (``zoo/util/Labels.java``): index → name plus
    ``decode_predictions`` over a batch of output probabilities."""

    def __init__(self, labels: Sequence[str]):
        self._labels = list(labels)

    def get_label(self, n: int) -> str:
        return self._labels[n]

    def __len__(self) -> int:
        return len(self._labels)

    def decode_predictions(self, predictions, top: int = 5
                           ) -> List[List[ClassPrediction]]:
        """Top-``top`` (label, probability) per example
        (``BaseLabels.decodePredictions``). ``predictions`` is [N, C]."""
        from deeplearning4j_tpu_torch.nn.train_step import to_host
        p = to_host(predictions)
        if p.ndim == 1:
            p = p[None, :]
        if p.shape[1] != len(self._labels):
            raise ValueError(
                f"predictions have {p.shape[1]} classes but the label "
                f"table has {len(self._labels)}")
        out = []
        for row in p:
            idx = np.argsort(-row)[:top]
            out.append([ClassPrediction(int(i), self._labels[int(i)],
                                        float(row[int(i)])) for i in idx])
        return out


class VOCLabels(Labels):
    """Pascal VOC's 20 classes (``darknet/VOCLabels.java``) — the label set
    TinyYOLO was trained on."""

    def __init__(self):
        super().__init__(VOC_CLASSES)


class COCOLabels(Labels):
    """COCO's 80 classes (``darknet/COCOLabels.java``) — the label set
    YOLO2 was trained on."""

    def __init__(self):
        super().__init__(COCO_CLASSES)


class ImageNetLabels(Labels):
    """ImageNet-1k labels (``imagenet/ImageNetLabels.java``). The reference
    downloads its table at runtime; here it loads the standard Keras-format
    ``imagenet_class_index.json`` (``{"0": ["n01440764", "tench"], ...}``)
    from ``path``, or ``$DL4J_TPU_ZOO_DIR/imagenet_class_index.json``."""

    def __init__(self, path: Optional[str] = None):
        if path is None:
            root = os.environ.get(
                "DL4J_TPU_ZOO_DIR",
                os.path.expanduser("~/.deeplearning4j_tpu/zoo"))
            path = os.path.join(root, "imagenet_class_index.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"No ImageNet label table at {path}; place the standard "
                "imagenet_class_index.json there (the reference downloads "
                "the same table at runtime)")
        with open(path, "r", encoding="utf-8") as fh:
            idx = json.load(fh)
        labels = [idx[str(i)][1] for i in range(len(idx))]
        super().__init__(labels)
