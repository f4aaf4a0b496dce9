"""graftlint for the PyTorch port: static analysis of this package.

The JAX package's ``analysis/`` over the port's own code and contracts,
every tier, over one ratchet baseline:

- **Tier 1 (lexical, rules.py)**: stdlib-only AST rules over the package
  and the root ``chip_smoke.py`` — steps handed to the loop driver stay
  free of host syncs, Python branches on tensors and data-dependent
  shapes; hot Python loops do not sync every iteration; dtypes are
  pinned; timed regions fence what they time; host syncs and H2D puts
  route through the resilience executor and the staging API; thread
  targets take the lock; threads, env knobs, metric names and ladder
  rungs are declared.
- **Tier 2 (trace, semantic.py)**: one step of each registered entry
  point (``registry.ENTRY_POINTS``) traced with ``make_fx`` on fake
  tensors on the card's device (``trace.py``; each kernel one
  ``graft_torch`` op): distinct shapes against ``max_compiles``, 64-bit
  values from pinned inputs, host reads per step, collectives' axes and
  counts, collectives after a slot-varying host read.
- **Tier 3 (cost.py, profile.py)**: the static FLOP/byte model of the
  same traces against the intensity floors (advisory until the port's
  cost artifact is gpu-stamped), the pad_frac budgets of the partition
  and padding plans, the in-place contract against the step's writes; and
  the tuned-profile contract (``profile-drift``, ``untuned-knob-read``).
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

Tiers 1, 4, 5 and 6 and the profile half of tier 3 are stdlib-only: they
never import the code they scan, torch included; the traces of tiers 2
and 3 import torch, and run on the CPU with no card.
``analysis/baseline.json`` is kept empty: fix true positives, don't freeze
them.  ``tools/lint.sh`` is the gate.
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
