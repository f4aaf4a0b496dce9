#!/usr/bin/env bash
# The port's chaos gate, from the repository root:
#
#   page_rank_and_tfidf_using_apache_spark_tpu_torch/tools/chaos.sh [pytest args...]
#
# 1. The port's tests (tests/test_torch_*.py, -m 'not slow') under an
#    aggressive fault plan: every 5th guarded call at every site raises a
#    transient device error, and a generous sync deadline arms the watchdog
#    on each guarded call.  They must pass unchanged: the retry executor
#    makes injected transients invisible to callers.  A test that installs
#    its own plan (resilience.chaos.inject) shadows the env plan; a parity
#    test shadows it in both packages, whose plans count calls apart.  Six
#    workers, one test file each at a time (the suite takes some 6 minutes
#    so; serially about six times as long); arguments go to pytest.
# 2. The scenarios of the JAX package's tools/chaos.sh on the port, on CPU
#    slots and CPU replicas (tools/chaos_scenarios.py): the 2-slot mesh
#    losing slot 1, the tolerance fixpoint and batched PPR, the staged
#    ingest, the segment hot swap, the crash harness's append kills,
#    malformed messages at a faulted fleet, the scrape and cache-peer
#    partitions.  One OK line each.
set -euo pipefail
cd "$(dirname "$0")/../.."
PKG=page_rank_and_tfidf_using_apache_spark_tpu_torch

echo "== chaos: the port's tests under *:fail@%5 =="
env GRAFT_CHAOS='*:fail@%5' \
    GRAFT_RETRY_MAX=4 \
    GRAFT_BACKOFF_BASE_S=0.01 \
    GRAFT_SYNC_DEADLINE_S=60 \
    python -m pytest tests/test_torch_*.py -q -m 'not slow' \
        -p no:cacheprovider -p xdist -n 6 --dist loadfile -p no:randomly "$@"

echo "== chaos: the scenarios on the CPU =="
python -m "$PKG.tools.chaos_scenarios" --device cpu
