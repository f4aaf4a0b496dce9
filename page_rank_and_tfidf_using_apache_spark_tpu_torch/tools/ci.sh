#!/usr/bin/env bash
# The port's CI gate, from the repository root:
#
#   page_rank_and_tfidf_using_apache_spark_tpu_torch/tools/ci.sh
#
# 1. the port's tier-1 tests (tests/test_torch_*.py, -m 'not slow', six
#    workers, one test file each at a time);
# 2. tools/lint.sh: the six analysis tiers with their smokes and budgets,
#    and the protocol harness;
# 3. the smokes of the JAX package's tools/ci.sh that lint.sh does not run
#    (tools/ci_smokes.py: autotune, crash harness, drain kill matrix,
#    traced run, soak, fabric, federation, segment, owned strategy), each
#    within the reference's budget knob; the trace-diff gate is left to
#    the port's benchmark (ci_smokes.py says why);
# 4. tools/chaos.sh.
set -euo pipefail
cd "$(dirname "$0")/../.."
PKG=page_rank_and_tfidf_using_apache_spark_tpu_torch
TOOLS="$PKG/tools"

echo "== the port's tier-1 tests =="
python -m pytest tests/test_torch_*.py -q -m 'not slow' \
    -p no:cacheprovider -p xdist -n 6 --dist loadfile -p no:randomly

echo "== the lint gate =="
"$TOOLS/lint.sh"

echo "== the smokes =="
python -m "$PKG.tools.ci_smokes" --device cpu

echo "== the chaos gate =="
"$TOOLS/chaos.sh"

echo "CI: all gates green"
