#!/usr/bin/env bash
# The port's static-analysis gate: fail on any finding not frozen in the
# port's analysis/baseline.json (kept empty), over the package and the root
# chip_smoke.py.
#
# With arguments, this is the analysis CLI itself:
#   page_rank_and_tfidf_using_apache_spark_tpu_torch/tools/lint.sh --tier 4 --lock-graph
# With none, it runs the whole gate, with the budgets of the JAX package's
# tools/ci.sh:
#   - tier 1 (lexical rules);
#   - tier 2 (the traced steps of the entry points) within
#     GRAFT_SEMANTIC_BUDGET_S (60 s);
#   - tier 3 (the cost model and the tuned-profile contract) within
#     GRAFT_COST_BUDGET_S (30 s: the reference's is 10 s, but the port's
#     cost pass traces every entry again, some 12 s on one CPU core), its
#     --cost-report naming every entry with the pagerank_step segment
#     kernel as one op, its --profile-report every knob;
#   - tier 4 (concurrency) within GRAFT_CONC_BUDGET_S (10 s), its
#     --lock-graph DOT naming the serving drain lock;
#   - tier 5 (persistence) within GRAFT_PERSIST_BUDGET_S (10 s), its
#     --crash-points holding commit_append's two rename boundaries;
#   - tier 6 (wire protocol) within GRAFT_PROTO_BUDGET_S (10 s), its
#     --wire-probes holding the duplicate-rid, stale-floor and
#     unknown-path probes;
#   - the protocol harness (tools/protocol_harness.py) against a fixture
#     replica on the CPU, within the same protocol budget.
# Exit 0 = clean; 1 = new findings, a smoke that failed or a blown budget.
# Tiers 1, 4, 5 and 6 are stdlib-only; tiers 2 and 3 trace with torch on
# the CPU, and the harness imports torch.
set -euo pipefail
cd "$(dirname "$0")/../.."
PKG=page_rank_and_tfidf_using_apache_spark_tpu_torch

if [ "$#" -gt 0 ]; then
    exec python -m "$PKG.analysis" "$@"
fi

budget() {  # budget <label> <seconds> <limit>
    echo "$1: ${2}s"
    if [ "$2" -gt "$3" ]; then
        echo "FAIL: $1 exceeded its ${3}s budget (${2}s)" >&2
        exit 1
    fi
}

echo "== tier 1 (lexical) =="
python -m "$PKG.analysis" --tier 1

echo "== tier 2 (traced steps, budget ${GRAFT_SEMANTIC_BUDGET_S:-60}s) =="
t0=$(date +%s)
python -m "$PKG.analysis" --tier 2
budget "trace tier" $(( $(date +%s) - t0 )) "${GRAFT_SEMANTIC_BUDGET_S:-60}"

echo "== tier 3 (cost model + tuned profiles, budget ${GRAFT_COST_BUDGET_S:-30}s; incl. cost-report smoke) =="
t0=$(date +%s)
cost_json=$(python -m "$PKG.analysis" --tier 3 --cost-report --profile-report --json)
budget "cost tier" $(( $(date +%s) - t0 )) "${GRAFT_COST_BUDGET_S:-30}"
printf '%s\n' "$cost_json" | python -c '
import json
import sys

doc = json.load(sys.stdin)
assert doc["ok"] is True, doc.get("findings")
entries = {e["entry"]: e for e in doc["cost_report"]["entries"]}
assert len(entries) == 26, sorted(entries)
step = next(iter(entries["pagerank_step"]["variants"].values()))
assert step["kernels"]["segment"]["nodes"] == 1 and step["flops"] > 0, step
assert entries["tfidf_chunk_ingest_carry"]["donation"] == {"declared": [3], "written": [3]}
knobs = doc["profile_report"]["knobs"]
assert knobs and all(k["tuned"].get("gpu") is not None for k in knobs.values()), knobs
gate = doc["cost_report"]["intensity_gate"]
advisories = len(doc.get("advisories", []))
print(f"cost-report smoke: OK ({len(entries)} entries, intensity gate {gate}, "
      f"{advisories} advisories; {len(knobs)} knobs tuned for gpu)")
'

echo "== tier 4 (concurrency, budget ${GRAFT_CONC_BUDGET_S:-10}s; incl. lock-graph smoke) =="
t0=$(date +%s)
lock_dot=$(python -m "$PKG.analysis" --tier 4 --lock-graph)
budget "concurrency tier" $(( $(date +%s) - t0 )) "${GRAFT_CONC_BUDGET_S:-10}"
case "$lock_dot" in
    *"digraph lock_graph"*"TfidfServer._lock"*) ;;
    *) echo "FAIL: --lock-graph emitted no usable DOT graph" >&2
       printf '%s\n' "$lock_dot" | head -20 >&2
       exit 1 ;;
esac
echo "lock-graph smoke: OK ($(printf '%s\n' "$lock_dot" | grep -c ' -> ') edge(s) emitted)"

echo "== tier 5 (persistence, budget ${GRAFT_PERSIST_BUDGET_S:-10}s; incl. crash-point smoke) =="
t0=$(date +%s)
crash_json=$(python -m "$PKG.analysis" --tier 5 --crash-points --json)
budget "persistence tier" $(( $(date +%s) - t0 )) "${GRAFT_PERSIST_BUDGET_S:-10}"
printf '%s\n' "$crash_json" | python -c '
import json
import sys

doc = json.load(sys.stdin)
assert doc["ok"] is True, doc.get("findings")
cps = doc["crash_points"]
entry = next((k for k in cps if k.endswith("::commit_append")), None)
assert entry is not None, sorted(cps)
pts = cps[entry]
assert pts, f"{entry} enumeration is empty/null"
bounds = [p for p in pts if p["boundary"]]
assert [b["op"] for b in bounds] == ["replace", "replace"], bounds
assert "_write_manifest()" in bounds[0]["via"], bounds[0]
assert "_write_pointer()" in bounds[1]["via"], bounds[1]
total = sum(1 for e in cps.values() if e for _p in e)
print(f"crash-point smoke: OK ({len(bounds)} commit_append boundary point(s), "
      f"{total} enumerated op(s) across {len(cps)} commit sequences)")
'

echo "== tier 6 (wire protocol, budget ${GRAFT_PROTO_BUDGET_S:-10}s; incl. wire-probe smoke) =="
t0=$(date +%s)
wire_json=$(python -m "$PKG.analysis" --tier 6 --wire-probes --json)
budget "protocol tier" $(( $(date +%s) - t0 )) "${GRAFT_PROTO_BUDGET_S:-10}"
printf '%s\n' "$wire_json" | python -c '
import json
import sys

doc = json.load(sys.stdin)
assert doc["ok"] is True, doc.get("findings")
probes = doc["wire_probes"]
kinds = {p["kind"] for p in probes}
assert {"duplicate-rid", "stale-floor", "unknown-path"} <= kinds, sorted(kinds)
print(f"wire-probe smoke: OK ({len(probes)} probe(s), {len(kinds)} kind(s) enumerated)")
'

echo "== protocol-harness smoke (declared message space at a live replica) =="
t0=$(date +%s)
python -m "$PKG.tools.protocol_harness" --device cpu
budget "protocol harness" $(( $(date +%s) - t0 )) "${GRAFT_PROTO_BUDGET_S:-10}"
echo "lint gate: clean"
