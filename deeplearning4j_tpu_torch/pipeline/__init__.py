"""Continuous-training pipeline (L7 of the stack, above serving/observe).

The self-retraining product loop the framework's pieces were built for:
a streaming route feeds mini-epoch incremental ``fit()`` (watchdog- and
trace-guarded), the candidate must pass a held-out eval gate against the
serving version, then canaries at ramped traffic fractions with shadow
diffing before an automatic promote — or an alert/watchdog-driven
rollback.  A fenced, journaled state machine (the elastic supervisor's
ledger pattern) makes the whole loop crash-safe: a killed pipeline
resumes at the stage it died in and can never double-promote.

- ``state``   — :class:`PipelineStateMachine` / :class:`PipelineJournal`
  (fencing, single-terminal-decision journal, fault-injection hook);
- ``trainer`` — :class:`ContinuousTrainer` + :class:`StreamBuffer`
  (stream → mini-epoch fit with ``attach_observability`` wired in);
- ``gate``    — :class:`EvalGate` (candidate vs serving within margins);
- ``canary``  — :class:`CanaryController` (ramp schedule on a
  ``TimeSource``, alert/shadow-divergence rollback signals);
- ``runner``  — :class:`ContinuousPipeline` + :class:`PipelineConfig`
  (the orchestration + the JSON config schema shared with the CLI and
  ``tools/validate_pipeline_config.py``).

The port's copy of the JAX package's ``pipeline/`` (its modules are jax-
free; the networks they train are the port's).
"""

from deeplearning4j_tpu_torch.pipeline.canary import (  # noqa: F401
    CanaryController,
    CanaryStep,
    parse_schedule,
)
from deeplearning4j_tpu_torch.pipeline.gate import (  # noqa: F401
    GATE_METRICS,
    EvalGate,
    GateResult,
)
from deeplearning4j_tpu_torch.pipeline.runner import (  # noqa: F401
    ContinuousPipeline,
    PipelineConfig,
)
from deeplearning4j_tpu_torch.pipeline.state import (  # noqa: F401
    AlreadyDecided,
    IllegalTransition,
    PipelineJournal,
    PipelineState,
    PipelineStateMachine,
    STAGES,
    StalePipelineError,
    TERMINAL_STAGES,
)
from deeplearning4j_tpu_torch.pipeline.trainer import (  # noqa: F401
    ContinuousTrainer,
    StreamBuffer,
    StreamStuck,
)
