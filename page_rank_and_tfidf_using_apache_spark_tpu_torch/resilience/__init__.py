"""Resilient execution: deterministic fault injection (:mod:`.chaos`), a
retry/deadline executor (:mod:`.executor`), and the structured
:class:`ResilienceExhausted` that hands callers the checkpoint to resume
from.

Counterpart of the JAX package's ``resilience/`` with its names, less the
elastic runtime (``DeviceHealth``, ``ShrinkPlan``, ``plan_shrink``,
``reset_health``: ROADMAP Queue 1 item 11) and the process supervisor
(item 12).  The port's failure model: retry a transient fault, then raise
:class:`ResilienceExhausted` naming the newest checkpoint; no rung moves
work to the CPU.
"""

from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience.chaos import (
    ChaosError,
    DeviceLostError,
    PartitionError,
    inject,
    parse_plan,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience.executor import (
    ResilienceExhausted,
    RetryPolicy,
    SyncDeadlineExceeded,
    block_until_ready,
    device_get,
    is_transient,
    run_guarded,
)

__all__ = [
    "ChaosError",
    "DeviceLostError",
    "PartitionError",
    "ResilienceExhausted",
    "RetryPolicy",
    "SyncDeadlineExceeded",
    "block_until_ready",
    "device_get",
    "inject",
    "is_transient",
    "parse_plan",
    "run_guarded",
]
