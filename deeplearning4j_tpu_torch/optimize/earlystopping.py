"""Early stopping: termination conditions, score calculators, savers, trainer.

Counterpart of ``deeplearning4j_tpu/optimize/earlystopping.py`` (reference
``deeplearning4j-nn/.../earlystopping/``: ``EarlyStoppingConfiguration.java``
(builder), ``termination/`` (Max*Epochs, MaxTime, ScoreImprovement,
BestScore, InvalidScore), ``scorecalc/`` (DataSetLossCalculator,
ClassificationScoreCalculator, ...), ``saver/`` (InMemoryModelSaver,
LocalFileModelSaver), and ``BaseEarlyStoppingTrainer.java:46``
(``fit():76``)), for both networks.

Everything runs on the model's device: the calculators score through the
network's own ``score``, ``evaluate*`` and forward; a ``LocalFileModelSaver``
restores onto the device of the model it saved (or the ``device`` it was
given). A ``WatchdogAlarm`` from a raise-policy ``TrainingWatchdog``
(``observe/health.py``) ends the run as an "Error" termination, as the
reference's does; any other exception from an epoch propagates.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


# ---------------------------------------------------------------- calculators
class ScoreCalculator:
    """Score to MINIMIZE on held-out data (``scorecalc/ScoreCalculator.java``)."""

    def calculate_score(self, model) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over an iterator (``DataSetLossCalculator.java``)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        for ds in self.iterator:
            total += model.score(ds) * ds.num_examples()
            n += ds.num_examples()
        if n == 0:
            return float("nan")
        return total / n if self.average else total


class ClassificationScoreCalculator(ScoreCalculator):
    """1 - metric, so that better classification minimizes the score
    (``ClassificationScoreCalculator.java``). metric: accuracy | f1 |
    precision | recall, or an ``Evaluation.Metric`` name (GMEASURE, MCC)."""

    def __init__(self, iterator, metric: str = "accuracy"):
        self.iterator = iterator
        self.metric = metric

    def calculate_score(self, model) -> float:
        e = model.evaluate(self.iterator)
        try:
            return 1.0 - e.score_for_metric(self.metric)
        except ValueError:
            return 1.0 - getattr(e, self.metric)()


class RegressionScoreCalculator(ScoreCalculator):
    """Column-averaged regression metric to minimize
    (``RegressionScoreCalculator.java``). metric: MSE | MAE | RMSE | RSE |
    PC | R2 — correlation-style metrics (PC, R2) are negated so lower
    stays better."""

    _MAXIMIZED = {"PC", "R2"}

    def __init__(self, iterator, metric: str = "MSE"):
        self.iterator = iterator
        self.metric = metric

    def calculate_score(self, model) -> float:
        e = model.evaluate_regression(self.iterator)
        v = e.score_for_metric(self.metric)
        return -v if self.metric.upper() in self._MAXIMIZED else v


class ROCScoreCalculator(ScoreCalculator):
    """1 - AUC so better ranking minimizes (``ROCScoreCalculator.java``).
    roc_type: "roc" (binary), "binary" (per-output ROCBinary average) or
    "multiclass" (ROCMultiClass average); metric: "auc" or "auprc"."""

    def __init__(self, iterator, roc_type: str = "roc",
                 metric: str = "auc"):
        if roc_type not in ("roc", "binary", "multiclass"):
            raise ValueError("roc_type must be roc|binary|multiclass")
        if metric not in ("auc", "auprc"):
            raise ValueError("metric must be auc|auprc")
        self.iterator = iterator
        self.roc_type = roc_type
        self.metric = metric

    def _value(self, roc) -> float:
        return roc.calculate_auc() if self.metric == "auc" else roc.calculate_auc_pr()

    def calculate_score(self, model) -> float:
        if self.roc_type == "roc":
            return 1.0 - self._value(model.evaluate_roc(self.iterator))
        if self.roc_type == "multiclass":
            roc = model.evaluate_roc_multi_class(self.iterator)
            n = roc.num_classes()
        else:
            roc = model.evaluate_roc_binary(self.iterator)
            n = roc.num_labels()
        vals = [self._value(roc._single(c)) for c in range(n)]
        return 1.0 - (float(np.mean(vals)) if vals else 0.0)


def _resolve_layer(model, layer_ref):
    """(layer, params) for a sequential layer index or a graph vertex
    name — the AE/VAE calculators work on both networks."""
    if isinstance(layer_ref, str):
        return model.get_layer(layer_ref), model.params[layer_ref]
    return model.layers[layer_ref], model.params[layer_ref]


def _activation_into_layer(model, layer_ref, x) -> torch.Tensor:
    """The activation the target layer sees in a normal forward, on the
    model's device: the layers before it applied, then the input
    preprocessor configured AT the layer. ``layer_ref`` is a sequential
    layer index or a graph vertex name."""
    if isinstance(layer_ref, str):
        vd = model.conf.vertices[layer_ref]
        acts = model.feed_forward(x)
        ins = [acts[s] for s in vd.inputs]
        h = ins[0] if len(ins) == 1 else torch.cat(ins, dim=-1)
    elif layer_ref > 0:
        h = model.feed_forward_to_layer(layer_ref - 1, x)[-1]
    else:
        h = model._as_tensor(x)
    pre = model.conf.preprocessors.get(layer_ref)
    return h if pre is None else pre(h)


class AutoencoderScoreCalculator(ScoreCalculator):
    """Mean reconstruction error of an AutoEncoder layer on held-out data
    (``AutoencoderScoreCalculator.java``): forward to the layer, decode,
    and score reconstruction vs input."""

    def __init__(self, iterator, layer_index=0, metric: str = "mse"):
        # layer_index: a sequential layer index, or a graph vertex name
        self.iterator = iterator
        self.layer_index = layer_index
        self.metric = metric.lower()

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        layer, params = _resolve_layer(model, self.layer_index)
        with torch.no_grad():
            for ds in self.iterator:
                x = _activation_into_layer(model, self.layer_index, ds.features)
                recon = layer.decode(params, layer.encode(params, x))
                err = (recon - x) ** 2 if self.metric == "mse" else (recon - x).abs()
                total += float(err.sum())
                n += x.shape[0]
        return total / n if n else float("nan")


class VAEReconErrorScoreCalculator(ScoreCalculator):
    """Mean deterministic reconstruction error of a VAE layer
    (``VAEReconErrorScoreCalculator.java``; loss-function configs only)."""

    def __init__(self, iterator, layer_index: int = 0):
        self.iterator = iterator
        self.layer_index = layer_index

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        layer, params = _resolve_layer(model, self.layer_index)
        with torch.no_grad():
            for ds in self.iterator:
                x = _activation_into_layer(model, self.layer_index, ds.features)
                total += float(layer.reconstruction_error(params, x).sum())
                n += x.shape[0]
        return total / n if n else float("nan")


class VAEReconProbScoreCalculator(ScoreCalculator):
    """Negative mean reconstruction log-probability of a VAE layer
    (``VAEReconProbScoreCalculator.java``; probabilistic reconstruction
    distributions only) — negated so higher likelihood minimizes. Each
    call draws from a ``torch.Generator`` on the model's device seeded with
    ``seed``, batch after batch (the JAX package folds the batch index into
    its key: the draws differ, the estimate is the same)."""

    def __init__(self, iterator, layer_index: int = 0,
                 num_samples: int = 1, log_prob: bool = True, seed: int = 0):
        self.iterator = iterator
        self.layer_index = layer_index
        self.num_samples = num_samples
        self.log_prob = log_prob
        self.seed = seed

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        layer, params = _resolve_layer(model, self.layer_index)
        gen = torch.Generator(device=model.device)
        gen.manual_seed(self.seed)
        with torch.no_grad():
            for ds in self.iterator:
                x = _activation_into_layer(model, self.layer_index, ds.features)
                lp = layer.reconstruction_log_probability(
                    params, x, gen, num_samples=self.num_samples)
                if not self.log_prob:
                    lp = torch.exp(lp)
                total += float(lp.sum())
                n += x.shape[0]
        return -(total / n) if n else float("nan")


# ---------------------------------------------------------------- termination
class EpochTerminationCondition:
    def initialize(self) -> None:
        """Reset state; called at the start of every fit() (the reference's
        ``TerminationCondition.initialize()``)."""

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self) -> None:
        """Reset state; called at the start of every fit()."""

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop when no improvement for ``max_epochs_without_improvement`` epochs
    (with optional ``min_improvement`` delta)."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self._best: Optional[float] = None
        self._stale = 0

    def initialize(self) -> None:
        self._best = None
        self._stale = 0

    def terminate(self, epoch, score):
        if math.isnan(score):
            return False  # no fresh evaluation this epoch; don't advance staleness
        if self._best is None or (self._best - score) > self.min_improvement:
            self._best = score
            self._stale = 0
            return False
        self._stale += 1
        return self._stale >= self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop as soon as the score is at/below a target."""

    def __init__(self, best_expected_score: float):
        self.target = best_expected_score

    def terminate(self, epoch, score):
        return score <= self.target


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = time.monotonic()

    def initialize(self) -> None:
        self._start = time.monotonic()

    def terminate(self, last_score):
        return (time.monotonic() - self._start) >= self.max_seconds


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop on NaN/Inf score (``InvalidScoreIterationTerminationCondition``)."""

    def terminate(self, last_score):
        return math.isnan(last_score) or math.isinf(last_score)


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score):
        return last_score > self.max_score


# ---------------------------------------------------------------------- saver
class InMemoryModelSaver:
    """Keeps the best/latest model in memory (``saver/InMemoryModelSaver.java``)
    as a clone on the model's device: training goes on writing the model's
    tensors in place."""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, model, score):
        self._best = (model.clone() if hasattr(model, "clone") else model, score)

    def save_latest_model(self, model, score):
        self._latest = (model.clone() if hasattr(model, "clone") else model, score)

    def get_best_model(self):
        return self._best[0] if self._best else None

    def get_latest_model(self):
        return self._latest[0] if self._latest else None


class LocalFileModelSaver:
    """Writes bestModel.zip / latestModel.zip (``saver/LocalFileModelSaver.java``).
    A model read back lands on ``device`` when given, else on the device of
    the model this saver last wrote, else on ``cuda``."""

    def __init__(self, directory, device=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.device = device

    def _write(self, model, name):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        if self.device is None:
            self.device = model.device
        write_model(model, self.dir / name)

    def _read(self, name):
        from deeplearning4j_tpu_torch.util.model_serializer import restore_model
        p = self.dir / name
        return restore_model(p, device=self.device) if p.exists() else None

    def save_best_model(self, model, score):
        self._write(model, "bestModel.zip")

    def save_latest_model(self, model, score):
        self._write(model, "latestModel.zip")

    def get_best_model(self):
        return self._read("bestModel.zip")

    def get_latest_model(self):
        return self._read("latestModel.zip")


# ------------------------------------------------------------------ config
class EarlyStoppingListener:
    """Hooks into the early-stopping loop
    (``earlystopping/listener/EarlyStoppingListener.java``)."""

    def on_start(self, config, model) -> None:
        pass

    def on_epoch(self, epoch: int, score: float, config, model) -> None:
        pass

    def on_completion(self, result) -> None:
        pass


class EarlyStoppingConfiguration:
    """Builder-style config (``EarlyStoppingConfiguration.java``)."""

    def __init__(self, *, score_calculator: ScoreCalculator,
                 epoch_termination_conditions: Optional[List[EpochTerminationCondition]] = None,
                 iteration_termination_conditions: Optional[List[IterationTerminationCondition]] = None,
                 model_saver=None,
                 evaluate_every_n_epochs: int = 1,
                 save_last_model: bool = False):
        self.score_calculator = score_calculator
        self.epoch_conditions = epoch_termination_conditions or []
        self.iteration_conditions = iteration_termination_conditions or []
        self.saver = model_saver or InMemoryModelSaver()
        self.evaluate_every_n_epochs = max(1, evaluate_every_n_epochs)
        self.save_last_model = save_last_model


class EarlyStoppingResult:
    """Outcome record (``EarlyStoppingResult.java``)."""

    def __init__(self, termination_reason: str, termination_details: str,
                 score_vs_epoch: dict, best_model_epoch: int, best_model_score: float,
                 total_epochs: int, best_model):
        self.termination_reason = termination_reason  # "EpochTerminationCondition" | "IterationTerminationCondition"
        self.termination_details = termination_details
        self.score_vs_epoch = score_vs_epoch
        self.best_model_epoch = best_model_epoch
        self.best_model_score = best_model_score
        self.total_epochs = total_epochs
        self.best_model = best_model


class EarlyStoppingTrainer:
    """Epoch loop with held-out scoring and best-model tracking
    (``BaseEarlyStoppingTrainer.java:46``, ``fit():76``), for both
    networks, on the model's device."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_iterator):
        self.config = config
        self.model = model
        self.iterator = train_iterator
        self._es_listener: Optional[EarlyStoppingListener] = None

    def _fit_epoch(self) -> None:
        """One training epoch — the hook a subclass reroutes."""
        self.model.fit(self.iterator, epochs=1)

    def set_listener(self, listener: Optional[EarlyStoppingListener]) -> None:
        """Attach an EarlyStoppingListener (``BaseEarlyStoppingTrainer
        .setListener``)."""
        self._es_listener = listener

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        listener = self._es_listener
        if listener is not None:
            listener.on_start(cfg, self.model)
        for c in cfg.epoch_conditions:
            c.initialize()
        for c in cfg.iteration_conditions:
            c.initialize()
        scores: dict = {}
        best_score, best_epoch = float("inf"), -1
        epoch = 0
        last_eval = float("nan")
        reason, details = "EpochTerminationCondition", "max epochs"
        while True:
            try:
                self._fit_epoch()
            except Exception as e:
                # a raise-policy TrainingWatchdog (observe/health.py) firing
                # mid-fit ends the run as an Error termination with the best
                # model so far — the reference's BaseEarlyStoppingTrainer
                # "Error" reason, wired to real divergence detection
                from deeplearning4j_tpu_torch.observe.health import WatchdogAlarm
                if not isinstance(e, WatchdogAlarm):
                    raise
                reason, details = "Error", str(e)
                epoch += 1
                break
            last = self.model.score_
            stop_iter = next((c for c in cfg.iteration_conditions if c.terminate(last)), None)
            if stop_iter is not None:
                reason = "IterationTerminationCondition"
                details = type(stop_iter).__name__
                epoch += 1
                break
            if cfg.save_last_model:
                # latest is saved every epoch, independent of eval cadence
                cfg.saver.save_latest_model(self.model, last_eval)
            if (epoch + 1) % cfg.evaluate_every_n_epochs == 0:
                last_eval = cfg.score_calculator.calculate_score(self.model)
                scores[epoch] = last_eval
                if last_eval < best_score:
                    best_score, best_epoch = last_eval, epoch
                    cfg.saver.save_best_model(self.model, last_eval)
                if listener is not None:
                    # only on epochs that evaluated, with the fresh score
                    # (BaseEarlyStoppingTrainer onEpoch timing)
                    listener.on_epoch(epoch, last_eval, cfg, self.model)
            # epoch termination is checked EVERY epoch (with the most recent
            # eval score), so MaxEpochs cannot overshoot when
            # evaluate_every_n_epochs > 1
            stop_epoch = next(
                (c for c in cfg.epoch_conditions if c.terminate(epoch, last_eval)), None)
            if stop_epoch is not None:
                reason = "EpochTerminationCondition"
                details = type(stop_epoch).__name__
                epoch += 1
                break
            epoch += 1
        best = cfg.saver.get_best_model() or self.model
        result = EarlyStoppingResult(reason, details, scores, best_epoch,
                                     best_score, epoch, best)
        if listener is not None:
            listener.on_completion(result)
        return result


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping with data-parallel epochs
    (``EarlyStoppingParallelTrainer.java:51``): each epoch runs the
    network's step through a ``ParallelWrapper`` over the mesh
    (``parallel/trainer.py``; a mesh over every rank of the world when
    none is given)."""

    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_iterator, mesh=None, mode: str = "shared_gradients",
                 averaging_frequency: int = 5):
        super().__init__(config, model, train_iterator)
        from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper
        self._pw = ParallelWrapper(model, mesh, mode=mode,
                                   averaging_frequency=averaging_frequency)

    def _fit_epoch(self) -> None:
        # epochs run sharded over the mesh
        self._pw.fit(self.iterator, epochs=1)
