"""graftlint for the PyTorch port: static analysis of this package.

The JAX package's ``analysis/`` over the port's own code and contracts, for
the four tiers that read no trace, over one ratchet baseline:

- **Tier 1 (lexical, rules.py)**: stdlib-only AST rules over the package
  and the root ``chip_smoke.py`` — steps handed to the loop driver stay
  free of host syncs, Python branches on tensors and data-dependent
  shapes; hot Python loops do not sync every iteration; dtypes are
  pinned; timed regions fence what they time; host syncs and H2D puts
  route through the resilience executor and the staging API; thread
  targets take the lock; threads, env knobs, metric names and ladder
  rungs are declared.
- **Tier 4 (concurrency, concurrency.py)**: lock-order cycles,
  blocking-under-lock, use-after-donate over the ``DONATED_CALLEES``
  contract (the callees that overwrite an argument in place),
  chaos-coverage drift, thread/lock registry drift.
- **Tier 5 (persistence, persistence.py)**: atomic-write drift,
  pointer-flip ordering, generation-deferred GC, ``ARTIFACT_SCHEMAS``
  writer/reader drift, ``COMMIT_LOCKS`` drift, and the crash-point
  enumeration ``tools/crash_harness.py`` replays.
- **Tier 6 (wire protocol, protocol.py)**: ``WIRE_SCHEMAS`` endpoint,
  status-code and key drift, status classes against the router's retry
  logic, retry-unsafe effects ahead of the request-id dedup guard, floor
  monotonicity, and the message space ``tools/protocol_harness.py``
  replays at a live replica.

Every tier is stdlib-only: it never imports the code it scans, torch
included.  The reference's trace-based tiers 2 and 3 are not ported yet
(ROADMAP item 15b).  ``analysis/baseline.json`` is kept empty: fix true
positives, don't freeze them.  ``tools/lint.sh`` is the gate.
"""

from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.engine import (
    apply_ratchet,
    baseline_path,
    changed_python_files,
    default_targets,
    load_baseline,
    repo_root,
    run_lint,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.findings import Finding
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.rules import RULES

__all__ = [
    "Finding",
    "RULES",
    "apply_ratchet",
    "baseline_path",
    "changed_python_files",
    "default_targets",
    "load_baseline",
    "repo_root",
    "run_lint",
]
