"""scikit-learn adapter: Estimator-style wrappers around networks.

Role of the reference's Spark ML pipeline glue
(`dl4j-spark-ml/.../SparkDl4jNetwork.scala`, `AutoEncoder.scala` — exposing
DL4J nets as Spark ML `Pipeline` stages): in the Python ecosystem the
pipeline framework is scikit-learn, so networks are wrapped as
fit/predict/score estimators usable inside ``sklearn.pipeline.Pipeline``,
grid search, and cross-validation. No hard sklearn dependency — the wrappers
implement the estimator protocol structurally.

The port's copy of the JAX package's ``sklearn_adapter.py`` over the
port's networks; ``device=`` places them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

try:  # inherit sklearn's estimator protocol (tags, clone) when available
    from sklearn.base import BaseEstimator as _SkBase
    from sklearn.base import ClassifierMixin as _SkClf
    from sklearn.base import RegressorMixin as _SkReg
except ImportError:  # structural protocol only
    _SkBase = object

    class _SkClf:  # type: ignore[no-redef]
        pass

    class _SkReg:  # type: ignore[no-redef]
        pass


class _BaseAdapter(_SkBase):
    def __init__(self, conf_factory: Callable[[int, int], object], *,
                 epochs: int = 10, batch_size: int = 32, shuffle: bool = True,
                 seed: int = 0, device=None):
        self.conf_factory = conf_factory
        self.epochs = epochs
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.device = device  # the network's device (None: the card)
        self.network_ = None

    # sklearn protocol ----------------------------------------------------
    def get_params(self, deep: bool = True) -> dict:
        return {"conf_factory": self.conf_factory, "epochs": self.epochs,
                "batch_size": self.batch_size, "shuffle": self.shuffle,
                "seed": self.seed, "device": self.device}

    def set_params(self, **params) -> "_BaseAdapter":
        valid = self.get_params()
        for k, v in params.items():
            if k not in valid:  # the sklearn contract: constructor params only
                raise ValueError(f"unknown parameter {k!r} "
                                 f"(valid: {sorted(valid)})")
            setattr(self, k, v)
        return self

    def _fit_net(self, x: np.ndarray, y2d: np.ndarray):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet, ListDataSetIterator
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        conf = self.conf_factory(x.shape[-1], y2d.shape[-1])
        if hasattr(conf, "vertices"):
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
            net = ComputationGraph(conf, device=self.device)
        else:
            net = MultiLayerNetwork(conf, device=self.device)
        net.init()
        it = ListDataSetIterator(DataSet(x, y2d), self.batch_size,
                                 shuffle=self.shuffle, seed=self.seed)
        net.fit(it, epochs=self.epochs)
        self.network_ = net
        return net

    def _output(self, x: np.ndarray) -> np.ndarray:
        if self.network_ is None:
            raise RuntimeError("fit must be called before predict")
        from deeplearning4j_tpu_torch.nn.train_step import to_host
        return to_host(self.network_.output(np.asarray(x, np.float32)))


class SklearnDl4jClassifier(_SkClf, _BaseAdapter):
    """Classifier estimator: ``conf_factory(n_features, n_classes)`` builds
    the network configuration (output layer = softmax + NLL)."""

    def fit(self, X, y) -> "SklearnDl4jClassifier":
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        if y.ndim == 1:
            self.classes_ = np.unique(y)  # sorted
            idx = np.searchsorted(self.classes_, y)
            onehot = np.zeros((len(y), len(self.classes_)), np.float32)
            onehot[np.arange(len(y)), idx] = 1.0
        else:
            self.classes_ = np.arange(y.shape[1])
            onehot = np.asarray(y, np.float32)
        self._fit_net(X, onehot)
        return self

    def predict_proba(self, X) -> np.ndarray:
        return self._output(X)

    def predict(self, X) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(X), axis=-1)]

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))


class SklearnDl4jRegressor(_SkReg, _BaseAdapter):
    """Regressor estimator: ``conf_factory(n_features, n_outputs)`` builds
    the network (output layer = identity + MSE)."""

    def fit(self, X, y) -> "SklearnDl4jRegressor":
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        self._y1d = y.shape[1] == 1
        self._fit_net(X, y)
        return self

    def predict(self, X) -> np.ndarray:
        out = self._output(X)
        return out[:, 0] if self._y1d else out

    def score(self, X, y) -> float:
        """R^2, the sklearn regressor convention."""
        pred = self.predict(X)
        y = np.asarray(y, np.float32).reshape(pred.shape)
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - np.mean(y)) ** 2))
        return 1.0 - ss_res / max(ss_tot, 1e-12)
