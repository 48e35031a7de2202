"""Resilience of a training run — the JAX package's ``resilience/``:

* :mod:`~swiftsnails_tpu_torch.resilience.chaos` — seeded fault injection
  of every kind: training, serving, cluster and transport (``chaos_spec``
  / ``chaos_seed``);
* :mod:`~swiftsnails_tpu_torch.resilience.drill` — the drill matrix and
  the ``chaos`` lane (``python -m swiftsnails_tpu_torch.tools.chaos_drill``);
* :mod:`~swiftsnails_tpu_torch.resilience.guardrail` — the per-step health
  check with rollback, batch skip, trust factor and bounded give-up
  (``guardrail``, ``guard_max_update_norm``, ``guard_max_consecutive``);
* :mod:`~swiftsnails_tpu_torch.resilience.resume` — resume from the newest
  *verified* checkpoint, walking back past corruption, with the data-stream
  cursor (``resume: auto``, with ``framework/checkpoint.py``);
* :mod:`~swiftsnails_tpu_torch.resilience.retry` — the deadline + retry
  policy of the data stream and the checkpoint writes
  (``retry_max_attempts``, ``retry_deadline_ms``).
"""

from swiftsnails_tpu_torch.resilience.chaos import (
    ChaosPlan,
    ChaosSpecError,
    TransientDataError,
    corrupt_checkpoint_dir,
    parse_chaos_spec,
)
from swiftsnails_tpu_torch.resilience.guardrail import GuardrailExhausted, StepGuardrail
from swiftsnails_tpu_torch.resilience.resume import resume_mode, resume_state
from swiftsnails_tpu_torch.resilience.retry import (
    Deadline,
    DeadlineExceeded,
    RetryBudget,
    RetryExhausted,
    RetryingIterator,
    RetryPolicy,
    retry_call,
)

__all__ = [
    "ChaosPlan",
    "ChaosSpecError",
    "Deadline",
    "DeadlineExceeded",
    "GuardrailExhausted",
    "RetryBudget",
    "RetryExhausted",
    "RetryingIterator",
    "RetryPolicy",
    "StepGuardrail",
    "TransientDataError",
    "corrupt_checkpoint_dir",
    "parse_chaos_spec",
    "resume_mode",
    "resume_state",
    "retry_call",
]
