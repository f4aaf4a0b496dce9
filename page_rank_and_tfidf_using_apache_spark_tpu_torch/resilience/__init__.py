"""Resilient execution: deterministic fault injection (:mod:`.chaos`), a
retry/deadline executor (:mod:`.executor`), the device-health registry of
the single-device salvage (:mod:`.elastic`), and the structured
:class:`ResilienceExhausted` that hands callers the checkpoint to resume
from.

Counterpart of the JAX package's ``resilience/`` with its names.  The
process supervisor of the serving fleet, :mod:`.process` (the ``respawn``
rung), is imported as a module, as in the reference, and not re-exported
here.  The port's failure model:
retry a transient fault; on a lost device that names its index, shrink a
sharded run's mesh over the surviving slots (:func:`plan_shrink`) or hand a
single-device run to the CPU from its newest commit point (the salvage);
else raise :class:`ResilienceExhausted` naming the newest checkpoint.
"""

from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience.chaos import (
    ChaosError,
    DeviceLostError,
    PartitionError,
    inject,
    parse_plan,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience.elastic import (
    DeviceHealth,
    ShrinkPlan,
    plan_shrink,
    reset_health,
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
    "DeviceHealth",
    "DeviceLostError",
    "PartitionError",
    "ResilienceExhausted",
    "RetryPolicy",
    "ShrinkPlan",
    "SyncDeadlineExceeded",
    "block_until_ready",
    "device_get",
    "inject",
    "is_transient",
    "parse_plan",
    "plan_shrink",
    "reset_health",
    "run_guarded",
]
