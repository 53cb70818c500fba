"""YOLOv2 output layer and detection decoding.

Counterpart of ``deeplearning4j_tpu/nn/layers/objdetect.py``
(``Yolo2OutputLayer.java``, ``YoloUtils.java``): ``DetectedObject``,
``iou``, ``nms``, ``get_predicted_objects`` and ``Yolo2OutputLayer``.
The layer's input is NHWC ``[N, H, W, B·(5+C)]``: for each of the B
anchor boxes ``tx, ty, tw, th``, a confidence and C class scores. Its
forward is the identity, so a network's ``output`` is the raw scores.
Labels are ``[N, H, W, 5+C]``: the box's centre in absolute grid units
(cell index plus offset, as the decoded ``sigmoid(tx) + grid_x``), its
width and height in grid units, the object flag and the one-hot class.

The loss (Redmon et al. 2016, the reference's): the anchor with the best
IoU against a cell's box is responsible for it (``argmax``, the first
anchor among equals); λ_coord-weighted squared errors of the centre and
of the square roots of the sizes (``sqrt(max(wh, 1e-8))``); the
responsible anchors' confidences against their IoU (held constant, or
``conf_target``), the others' against 0 (λ_noobj); softmax cross-entropy
of the classes; the sum over the batch divided by N.

Decoding (``_decode_detections``) runs on the network's device in f32
for the whole batch; the candidates above the threshold come to the host
in ``np.nonzero`` order (example, y, x, anchor) and non-max suppression
drops, in place and in that order, every detection that a same-class
one of strictly higher confidence overlaps above the threshold.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import _max
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@dataclasses.dataclass
class DetectedObject:
    """One detected object (``objdetect/DetectedObject.java``), in grid
    cell units: at 416x416 with 32x downsampling there are 13x13 cells,
    so ``center_x`` 5.5 lies 5.5·32 = 176 pixels from the left."""

    example: int
    center_x: float
    center_y: float
    width: float
    height: float
    class_predictions: np.ndarray
    confidence: float

    @property
    def predicted_class(self) -> int:
        """The index of the most probable class (``getPredictedClass``)."""
        return int(np.argmax(np.ravel(self.class_predictions)))

    def top_left_xy(self) -> Tuple[float, float]:
        return (self.center_x - self.width / 2.0, self.center_y - self.height / 2.0)

    def bottom_right_xy(self) -> Tuple[float, float]:
        return (self.center_x + self.width / 2.0, self.center_y + self.height / 2.0)


def iou(o1: DetectedObject, o2: DetectedObject) -> float:
    """Intersection over union of two detections (``YoloUtils.java:86``)."""
    x1min, y1min = o1.top_left_xy()
    x1max, y1max = o1.bottom_right_xy()
    x2min, y2min = o2.top_left_xy()
    x2max, y2max = o2.bottom_right_xy()
    iw = max(min(x1max, x2max) - max(x1min, x2min), 0.0)
    ih = max(min(y1max, y2max) - max(y1min, y2min), 0.0)
    inter = iw * ih
    union = o1.width * o1.height + o2.width * o2.height - inter
    return 0.0 if union <= 0 else inter / union


def nms(objects: List[DetectedObject], iou_threshold: float) -> List[DetectedObject]:
    """Non-max suppression as ``YoloUtils.nms``: in list order, a detection
    goes when a detection still kept, of the same class and of strictly
    higher confidence, overlaps it above ``iou_threshold`` (the example is
    not compared, as in the reference). Mutates ``objects`` in place and
    returns it. Only a class's own detections can suppress one, so each
    class is walked alone, in list order, and each of its detections is
    held against the class's others at once in float64 numpy (the
    arithmetic of :func:`iou` on Python floats): a decode of thousands of
    candidates is not a Python loop over pairs."""
    cls = np.array([o.predicted_class for o in objects])
    alive = np.ones(len(objects), bool)
    for c in np.unique(cls):
        idx = np.flatnonzero(cls == c)
        conf = np.array([objects[i].confidence for i in idx], np.float64)
        cx, cy, w, h = (np.array([getattr(objects[i], a) for i in idx], np.float64)
                        for a in ("center_x", "center_y", "width", "height"))
        x0, x1, y0, y1 = cx - w / 2.0, cx + w / 2.0, cy - h / 2.0, cy + h / 2.0
        area = w * h
        kept = np.ones(len(idx), bool)
        for j in range(len(idx)):
            iw = np.maximum(np.minimum(x1[j], x1) - np.maximum(x0[j], x0), 0.0)
            ih = np.maximum(np.minimum(y1[j], y1) - np.maximum(y0[j], y0), 0.0)
            inter = iw * ih
            union = area[j] + area - inter
            with np.errstate(divide="ignore", invalid="ignore"):
                overlap = np.where(union <= 0, 0.0, inter / union)
            kept[j] = not np.any(kept & (conf[j] < conf) & (overlap > iou_threshold))
        alive[idx] = kept
    objects[:] = [o for o, keep in zip(objects, alive) if keep]
    return objects


def _decode(x: torch.Tensor, anchors: torch.Tensor):
    """``[N, H, W, B, 5+C]`` scores decoded: ``(cx, cy, wh, conf,
    class scores)``, the centres in absolute grid units (``sigmoid(t) +
    the cell's index``), the sizes ``anchors · exp(t)``, the confidences
    (``sigmoid``) and the raw class scores."""
    _, h, w = x.shape[:3]
    txy = torch.sigmoid(x[..., 0:2])
    cx = txy[..., 0] + torch.arange(w, device=x.device, dtype=x.dtype)[None, None, :, None]
    cy = txy[..., 1] + torch.arange(h, device=x.device, dtype=x.dtype)[None, :, None, None]
    wh = anchors.to(x.device, x.dtype) * torch.exp(x[..., 2:4])
    return cx, cy, wh, torch.sigmoid(x[..., 4]), x[..., 5:]


def _decode_detections(output: torch.Tensor, n_boxes: int, n_classes: int,
                       anchors: torch.Tensor):
    """Raw ``[N, H, W, B·(5+C)]`` scores decoded in f32 on their device,
    each anchor's class scores softmaxed (``YoloUtils.activate`` and
    ``getPredictedObjects``)."""
    n, h, w, _ = output.shape
    cx, cy, wh, conf, scores = _decode(
        output.reshape(n, h, w, n_boxes, 5 + n_classes).float(), anchors)
    return cx, cy, wh, conf, torch.softmax(scores, dim=-1)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def get_predicted_objects(boxes, network_output, conf_threshold: float,
                          nms_threshold: float = 0.0,
                          n_classes: Optional[int] = None) -> List[DetectedObject]:
    """``YoloUtils.getPredictedObjects``: raw network output to the
    detections at or above ``conf_threshold``, non-max suppressed when
    ``nms_threshold`` > 0. The decode runs where the output lies; only the
    candidates come to the host."""
    if not 0.0 <= conf_threshold <= 1.0:
        raise ValueError(
            f"Invalid confidence threshold: must be in [0,1], got {conf_threshold}")
    if getattr(network_output, "ndim", None) != 4:
        raise ValueError(
            "Invalid network output activations array: should be rank 4. "
            f"Got shape {getattr(network_output, 'shape', None)}")
    out_t = _as_tensor(network_output)
    anchors = torch.as_tensor(np.asarray(boxes, np.float32))
    b = anchors.shape[0]
    if n_classes is None:
        n_classes = out_t.shape[-1] // b - 5
    with torch.no_grad():
        decoded = _decode_detections(out_t, b, int(n_classes), anchors)
    cx, cy, wh, conf, probs = (a.cpu().numpy() for a in decoded)
    out: List[DetectedObject] = []
    for i, yy, xx, bb in zip(*np.nonzero(conf >= conf_threshold)):
        out.append(DetectedObject(
            int(i), float(cx[i, yy, xx, bb]), float(cy[i, yy, xx, bb]),
            float(wh[i, yy, xx, bb, 0]), float(wh[i, yy, xx, bb, 1]),
            probs[i, yy, xx, bb].copy(), float(conf[i, yy, xx, bb])))
    if nms_threshold > 0:
        nms(out, nms_threshold)
    return out


@register_layer
@dataclasses.dataclass
class Yolo2OutputLayer(Layer):
    """YOLOv2 detection loss (λ-weighted coordinate, confidence and class
    terms)."""

    boxes: Tuple[Tuple[float, float], ...] = ((1.0, 1.0),)  # anchor (w, h), grid units
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5
    n_classes: int = 0

    def __post_init__(self):
        if self.activation is None:
            self.activation = "identity"
        if isinstance(self.boxes, list):
            self.boxes = tuple(tuple(b) for b in self.boxes)

    def has_loss(self) -> bool:
        return True

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def _split_predictions(self, x):
        """``[N, H, W, B·(5+C)]`` into the decoded centres and sizes, the
        confidences and the class logits."""
        n, h, w, _ = x.shape
        return _decode(x.reshape(n, h, w, len(self.boxes), 5 + self.n_classes),
                       torch.tensor(self.boxes, dtype=x.dtype))

    @staticmethod
    def _iou(cx1, cy1, wh1, cx2, cy2, wh2):
        x1min, x1max = cx1 - wh1[..., 0] / 2, cx1 + wh1[..., 0] / 2
        y1min, y1max = cy1 - wh1[..., 1] / 2, cy1 + wh1[..., 1] / 2
        x2min, x2max = cx2 - wh2[..., 0] / 2, cx2 + wh2[..., 0] / 2
        y2min, y2max = cy2 - wh2[..., 1] / 2, cy2 + wh2[..., 1] / 2
        iw = _max(torch.minimum(x1max, x2max) - torch.maximum(x1min, x2min), 0.0)
        ih = _max(torch.minimum(y1max, y2max) - torch.maximum(y1min, y2min), 0.0)
        inter = iw * ih
        union = wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1] - inter
        return inter / _max(union, 1e-8)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return x

    # ------------------------------------------------- detection extraction
    def get_predicted_objects(self, network_output, conf_threshold: float,
                              nms_threshold: float = 0.0) -> List[DetectedObject]:
        """Detections from raw network output (``Yolo2OutputLayer.java:575``,
        which passes ``nmsThreshold=0.0``; an argument here)."""
        return get_predicted_objects(self.boxes, network_output, conf_threshold,
                                     nms_threshold, n_classes=self.n_classes)

    def _decoded(self, network_output):
        out_t = _as_tensor(network_output)
        anchors = torch.tensor(self.boxes, dtype=torch.float32)
        with torch.no_grad():
            return _decode_detections(out_t, len(self.boxes), int(self.n_classes),
                                      anchors)

    def get_confidence_matrix(self, network_output, example: int, bb_number: int):
        """The decoded confidence of one anchor box at every position,
        ``[H, W]`` (``Yolo2OutputLayer.java:588``)."""
        return self._decoded(network_output)[3][example, :, :, bb_number]

    def get_probability_matrix(self, network_output, example: int, class_number: int):
        """The decoded probability of one class at every position and anchor,
        ``[H, W, B]`` (``:604``; each anchor has its own softmax, so the
        anchor axis stays)."""
        return self._decoded(network_output)[4][example, :, :, :, class_number]

    def compute_loss(self, params, x, labels, mask=None, conf_target=None):
        """The YOLOv2 loss. ``conf_target`` (default: the IoU, held constant)
        may be a fixed ``[N, H, W, B]`` tensor."""
        cx, cy, wh, conf, cls_logits = self._split_predictions(x)
        lab_cxy, lab_wh = labels[..., 0:2], labels[..., 2:4]
        obj, lab_cls = labels[..., 4], labels[..., 5:]
        lab_cx, lab_cy = lab_cxy[..., None, 0], lab_cxy[..., None, 1]
        lab_w, lab_h = lab_wh[..., None, 0], lab_wh[..., None, 1]

        # the responsible anchor: the best IoU with the cell's box
        with torch.no_grad():
            overlap = self._iou(cx, cy, wh, lab_cx, lab_cy, lab_wh[..., None, :])
        best = torch.argmax(overlap, dim=-1)
        resp = F.one_hot(best, len(self.boxes)).to(x.dtype) * obj[..., None]

        err_xy = (cx - lab_cx) ** 2 + (cy - lab_cy) ** 2
        err_wh = ((torch.sqrt(_max(wh[..., 0], 1e-8)) - torch.sqrt(_max(lab_w, 1e-8))) ** 2
                  + (torch.sqrt(_max(wh[..., 1], 1e-8)) - torch.sqrt(_max(lab_h, 1e-8))) ** 2)
        coord_loss = self.lambda_coord * torch.sum(resp * (err_xy + err_wh))

        target = (overlap if conf_target is None else _as_tensor(conf_target)
                  .to(x.device, x.dtype)).detach()
        conf_obj = torch.sum(resp * (conf - target) ** 2)
        conf_noobj = self.lambda_no_obj * torch.sum((1 - resp) * conf ** 2)

        logp = torch.log_softmax(cls_logits, dim=-1)
        cls_loss = -torch.sum(resp[..., None] * lab_cls[..., None, :] * logp)
        return (coord_loss + conf_obj + conf_noobj + cls_loss) / x.shape[0]
