#!/usr/bin/env bash
# The port's fast pre-commit gate: lint only what changed against a base
# ref, from the repository root:
#
#   page_rank_and_tfidf_using_apache_spark_tpu_torch/tools/precommit.sh [BASE]
#
# BASE defaults to HEAD (the work tree's diff).  Tier 1 scans the changed
# files; tiers 2 and 3 trace only the entry points whose contracted module
# changed (all of them when analysis/ itself changed); tiers 4, 5 and 6
# model the whole surface but report only findings in the changed files.
# tools/lint.sh stays the full gate.
set -euo pipefail
cd "$(dirname "$0")/../.."
BASE="${1:-HEAD}"
exec python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis --changed-only "$BASE"
