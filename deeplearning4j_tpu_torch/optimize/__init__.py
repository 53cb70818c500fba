"""Training-loop observers, full-batch solvers, early stopping and
hyperparameter search of the port.

Counterpart of ``deeplearning4j_tpu/optimize/`` (reference
``optimize/listeners/``, ``optimize/solvers/``, ``earlystopping/`` and the
Arbiter role), exporting the same names.
"""

from deeplearning4j_tpu_torch.optimize.earlystopping import (  # noqa: F401
    BestScoreEpochTerminationCondition,
    ClassificationScoreCalculator,
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    EarlyStoppingParallelTrainer,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    InvalidScoreIterationTerminationCondition,
    LocalFileModelSaver,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_tpu_torch.optimize.solvers import (  # noqa: F401
    BackTrackLineSearch,
    ConjugateGradient,
    ConvexOptimizer,
    EpsTermination,
    LBFGS,
    LineGradientDescent,
    Norm2Termination,
    Solver,
    StochasticGradientDescent,
    ZeroDirection,
)
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CheckpointListener,
    CollectScoresIterationListener,
    ComposableIterationListener,
    EvaluativeListener,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ProfilerListener,
    ScoreIterationListener,
    SleepyTrainingListener,
    TimeIterationListener,
)
