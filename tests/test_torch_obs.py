"""The port's run telemetry (``obs/``, ``utils/profiling.py``, the metrics
helpers and the spans of PageRank and TF-IDF) against the JAX package's.

The stdlib modules are copies: their code, docstrings aside, must stay the
reference's.  A traced CLI run of the port must name the JAX package's
spans for the phases both have, and read back through the repository's
stdlib reader ``tools/trace_report.py``, which is loaded as the other tests
load it and not edited.
"""

import ast
import importlib.util
import json
import logging
import pathlib

import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu import obs as jobs
from page_rank_and_tfidf_using_apache_spark_tpu.cli import pagerank as jcli
from page_rank_and_tfidf_using_apache_spark_tpu.cli import tfidf as jtcli
from page_rank_and_tfidf_using_apache_spark_tpu.obs.federation import FleetHub as JFleetHub
from page_rank_and_tfidf_using_apache_spark_tpu.obs.metrics import MetricsHub as JMetricsHub
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.utils import metrics as jmetrics
from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as tcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import tfidf as ttcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs import manifest
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.federation import FleetHub
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import MetricsHub
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import metrics as tmetrics
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import profiling
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import GRAFT_ENV_KNOBS

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "page_rank_and_tfidf_using_apache_spark_tpu"
PORT = ROOT / "page_rank_and_tfidf_using_apache_spark_tpu_torch"
TINY = str(ROOT / "tests" / "fixtures" / "tiny.txt")


def _trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", ROOT / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def sink():
    s = obs.MemorySink()
    obs.bus().attach(s)
    yield s
    obs.bus().detach(s)


# ------------------------------------------------------------------ copies

def _code(path: pathlib.Path, transform: ast.NodeTransformer | None = None) -> str:
    """The module's AST without docstrings, the JAX package's name read as
    the port's; ``transform``, if given, rewrites the tree first."""
    tree = ast.parse(path.read_text())
    if transform is not None:
        tree = transform.visit(tree)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree).replace("page_rank_and_tfidf_using_apache_spark_tpu_torch",
                                  "page_rank_and_tfidf_using_apache_spark_tpu")


class _WithoutEarlyClose(ast.NodeTransformer):
    """The port's one addition to ``obs/export.py``: the draining listener's
    ``self.socket.close()`` right after its backlog sweep."""

    def visit_Expr(self, node):
        call = node.value
        if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                and call.func.attr == "close"
                and isinstance(call.func.value, ast.Attribute)
                and call.func.value.attr == "socket"
                and isinstance(call.func.value.value, ast.Name)
                and call.func.value.value.id == "self"):
            return None
        return node


@pytest.mark.parametrize("module", ["events", "runtime", "metrics", "export", "federation"])
def test_copy_matches_reference(module):
    """Each copy's code is the reference's; ``export`` but for the one
    statement its docstring names."""
    transform = _WithoutEarlyClose() if module == "export" else None
    assert (_code(PORT / "obs" / f"{module}.py", transform)
            == _code(REF / "obs" / f"{module}.py"))
    if module == "export":
        assert (_code(PORT / "obs" / "export.py")
                != _code(REF / "obs" / "export.py"))


def test_obs_surface_matches_reference():
    assert set(obs.__all__) == set(jobs.__all__)
    for name in obs.__all__:
        assert hasattr(obs, name), name


def test_env_knobs_are_the_references():
    from page_rank_and_tfidf_using_apache_spark_tpu.utils.config import (
        GRAFT_ENV_KNOBS as REF_KNOBS,
    )

    assert {"GRAFT_LOG_LEVEL", "GRAFT_TRACE_DIR", "GRAFT_TRACE_PARENT"} <= GRAFT_ENV_KNOBS
    assert GRAFT_ENV_KNOBS <= REF_KNOBS


# ------------------------------------------------------------- events, spans

def test_span_events_and_nesting(sink):
    with obs.span("outer", a=1) as outer:
        with obs.span("inner") as inner:
            obs.emit("probe", x=2)
    kinds = [(e["kind"], e.get("name")) for e in sink.events]
    assert kinds == [("span_begin", "outer"), ("span_begin", "inner"), ("probe", None),
                     ("span_end", "inner"), ("span_end", "outer")]
    ends = sink.of_kind("span_end")
    assert ends[0]["span"] == inner and ends[0]["parent"] == outer
    assert ends[1]["parent"] is None and ends[1]["attrs"] == {"a": 1}
    assert all(e["status"] == "ok" and e["secs"] >= 0 for e in ends)


def test_span_error_status(sink):
    with pytest.raises(KeyError):
        with obs.span("boom"):
            raise KeyError("x")
    assert sink.of_kind("span_end")[0]["status"] == "error:KeyError"


def test_span_reaches_the_torch_profiler():
    """The bridge: a span is a ``record_function`` range in a profile."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("bridge.probe"):
            torch.ones(4).sum()
    assert "bridge.probe" in {e.key for e in prof.key_averages()}


def test_metrics_recorder_forwards_to_the_bus(sink):
    m = tmetrics.MetricsRecorder()
    m.record(event="put_graph", preprocess_secs=0.5)
    (ev,) = sink.of_kind("metric")
    assert ev["event"] == "put_graph" and ev["preprocess_secs"] == 0.5
    assert m.records == [{"event": "put_graph", "preprocess_secs": 0.5}]


# ------------------------------------------------------- utils/metrics helpers

@pytest.mark.parametrize("spec", [None, "", "debug", "WARNING", "info", "15", "0", "bogus",
                                  " error "])
def test_resolve_log_level_matches_reference(spec):
    assert tmetrics.resolve_log_level(spec) == jmetrics.resolve_log_level(spec)
    assert tmetrics.resolve_log_level(spec, logging.ERROR) == jmetrics.resolve_log_level(
        spec, logging.ERROR)


@pytest.mark.parametrize("xs", [[], [3.0], [1.0, 2.0], list(range(1, 101)), [0.5] * 7,
                                [float(i) ** 2 for i in range(37)]])
@pytest.mark.parametrize("p", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_percentile_matches_reference(xs, p):
    assert tmetrics.percentile(xs, p) == jmetrics.percentile(xs, p)


def test_timed_is_a_timer():
    with tmetrics.timed() as t:
        pass
    assert isinstance(t, tmetrics.Timer) and t.elapsed >= 0


# ------------------------------------------------------------------ manifest

def test_manifest_reads_torch(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFT_TRACE_PARENT", "round-7")
    run = obs.start_run("knobtest", trace_dir=str(tmp_path))
    try:
        man = json.loads(pathlib.Path(run.manifest_path).read_text())
        assert set(man["knobs"]) == set(GRAFT_ENV_KNOBS)
        assert man["knobs"]["GRAFT_TRACE_PARENT"] == "round-7"
        assert man["status"] == "running" and man["tuned_profile"] is None
        assert man["backend"] == "cpu" and man["device_count"] == 1
    finally:
        obs.end_run()
    man = json.loads(pathlib.Path(run.manifest_path).read_text())
    assert man["status"] == "ok" and man["events"] >= 2 and "summary" in man


def test_manifest_device_snapshot_names_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card{i}")
    assert manifest._device_snapshot() == {"backend": "cuda", "devices": ["card0", "card1"],
                                           "device_count": 2}


# ---------------------------------------------------------------- federation

class _Clock:
    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


HUB_ARGS = dict(window_s=60.0, slots=30, latency_slo_s=0.05, availability_target=0.99)


def _board(fleet) -> dict:
    """A fleet snapshot without its wall-clock stamp."""
    return {k: v for k, v in fleet.snapshot().items() if k != "at_wall"}


def test_federation_scrape_matches_reference():
    """The same replica snapshots through the port's FleetHub and the JAX
    package's (each scrape a guarded ``fed_scrape`` attempt) give the same board,
    and a dead replica is a scrape error, labelled stale, not dropped."""
    clk = _Clock(100.0)
    hubs = {str(i): JMetricsHub(clock=clk, **HUB_ARGS) for i in range(2)}
    for i, hub in enumerate(hubs.values()):
        for k in range(5 + i):
            hub.observe_request(0.01 * (k + 1), ok=k != 3)
    alive = dict.fromkeys(hubs, True)

    def fetch(url):
        r = url.rsplit("/", 1)[-1]
        if not alive[r]:
            raise OSError(f"replica {r} unreachable")
        return json.loads(json.dumps(hubs[r].snapshot()))

    # each scrape is a guarded fed_scrape call, and each package counts an
    # env plan's calls on its own: shadow GRAFT_CHAOS in both, so neither
    # board takes an injected fault the other does not
    with chaos.inject(""), jchaos.inject(""):
        fleets = [cls(scrape_s=1.0, clock=clk, fetch=fetch, **HUB_ARGS)
                  for cls in (FleetHub, JFleetHub)]
        for fleet in fleets:
            for r in hubs:
                fleet.register(r, f"http://stub/{r}")
            assert fleet.scrape_once() == {"0": True, "1": True}
        port, ref = (_board(f) for f in fleets)
        assert port == ref
        assert port["counters"]["serve.requests"]["total"] == 11
        alive["1"] = False
        for _ in range(4):
            clk.t += 1.0
            for fleet in fleets:
                assert fleet.scrape_once() == {"0": True, "1": False}
        port, ref = (_board(f) for f in fleets)
        assert port == ref and port["fleet"]["stale"] == ["1"]
    assert isinstance(MetricsHub(**HUB_ARGS).snapshot()["mergeable"], dict)


# ------------------------------------------------------------- traced CLIs

def _trace(trace_dir: pathlib.Path, name: str) -> dict:
    (path,) = trace_dir.glob(f"{name}.*.trace.jsonl")
    return _trace_report().report(str(path))


def _events(trace_dir: pathlib.Path, name: str) -> list:
    (path,) = trace_dir.glob(f"{name}.*.trace.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("tol", [0.0, 1e-9])
def test_pagerank_cli_trace_matches_reference(tol, tmp_path):
    """The port's traced run and the JAX CLI's on tiny.txt: the port's
    spans are the reference's phases it has, result_pull and the segment
    loop's segment always and delta_sync with a tolerance, and both metric
    streams name the same events."""
    args = [TINY, "20", "--dangling", "redistribute", "--init", "uniform", "--dtype",
            "float64", "--tol", str(tol)]
    assert tcli.main([*args, "--device", "cpu", "--output", str(tmp_path / "t.tsv"),
                      "--trace-dir", str(tmp_path / "port")]) == 0
    assert jcli.main([*args, "--tuned-profile", "off", "--output", str(tmp_path / "j.tsv"),
                      "--trace-dir", str(tmp_path / "ref")]) == 0
    port, ref = _trace(tmp_path / "port", "pagerank"), _trace(tmp_path / "ref", "pagerank")
    want = {"pagerank.result_pull", "pagerank.segment"} | (
        {"pagerank.delta_sync"} if tol else set())
    assert set(port["spans"]) == want and want <= set(ref["spans"])
    assert port["complete"] and port["status"] == "ok" and not port["incomplete_phases"]
    assert port["manifest"]["name"] == "pagerank" and port["manifest"]["status"] == "ok"
    assert port["manifest"]["backend"] == "cpu"
    metric_events = [[e["event"] for e in _events(tmp_path / d, "pagerank")
                      if e["kind"] == "metric" and "event" in e] for d in ("port", "ref")]
    assert metric_events[0] == ["load", "put_graph"]
    assert set(metric_events[0]) <= set(metric_events[1])
    kinds = {e["kind"] for e in _events(tmp_path / "port", "pagerank")}
    assert kinds == {"run_start", "span_begin", "span_end", "metric", "run_end"}
    assert (tmp_path / "t.tsv").read_text().splitlines()[0].split("\t")[0] == \
        (tmp_path / "j.tsv").read_text().splitlines()[0].split("\t")[0]


def test_tfidf_cli_trace_matches_reference(tmp_path):
    args = [TINY, "--lines", "--vocab-bits", "10", "--idf-mode", "smooth", "--l2-normalize"]
    assert ttcli.main([*args, "--device", "cpu", "--output", str(tmp_path / "t.tsv"),
                       "--trace-dir", str(tmp_path / "port")]) == 0
    assert jtcli.main([*args, "--tuned-profile", "off", "--output", str(tmp_path / "j.tsv"),
                       "--trace-dir", str(tmp_path / "ref")]) == 0
    port, ref = _trace(tmp_path / "port", "tfidf"), _trace(tmp_path / "ref", "tfidf")
    assert set(port["spans"]) == {"io.tokenize", "tfidf.pipeline"}
    assert set(port["spans"]) <= set(ref["spans"])
    assert port["spans"]["io.tokenize"]["count"] == ref["spans"]["io.tokenize"]["count"] == 1
    assert port["complete"] and port["status"] == "ok"
    tok = [e for e in _events(tmp_path / "port", "tfidf") if e["kind"] == "span_end"
           and e["name"] == "io.tokenize"]
    assert tok[0]["attrs"] == {"docs": 12}


def test_trace_dir_defaults_to_the_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFT_TRACE_DIR", str(tmp_path / "env"))
    assert tcli.main([TINY, "3", "--device", "cpu", "--output", str(tmp_path / "r.tsv")]) == 0
    assert _trace(tmp_path / "env", "pagerank")["status"] == "ok"


def test_untraced_run_writes_no_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("GRAFT_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert ttcli.main([TINY, "--lines", "--device", "cpu", "--output", "w.tsv"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["w.tsv"]
    assert obs.current_run() is None


def test_failed_run_finalizes_with_error(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main([TINY, "3", "--output", str(tmp_path / "r.tsv"),
                   "--trace-dir", str(tmp_path / "t")])
    rep = _trace(tmp_path / "t", "pagerank")
    assert rep["status"] == "error:RuntimeError" and rep["manifest"]["status"] == rep["status"]


@pytest.mark.parametrize("cli", ["pagerank", "tfidf"])
def test_profile_dir_writes_a_chrome_trace(cli, tmp_path):
    out = str(tmp_path / "o.tsv")
    if cli == "pagerank":
        rc = tcli.main([TINY, "5", "--device", "cpu", "--output", out,
                        "--profile-dir", str(tmp_path / "prof")])
        span = "pagerank.result_pull"
    else:
        rc = ttcli.main([TINY, "--lines", "--device", "cpu", "--output", out,
                         "--profile-dir", str(tmp_path / "prof")])
        span = "tfidf.pipeline"
    assert rc == 0
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert span in names


def test_profiling_trace_is_a_noop_without_a_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(None):
        torch.ones(2).sum()
    assert not list(tmp_path.iterdir())
    assert profiling.annotate("x").__class__ is obs.span("x").__class__


def test_tfidf_cli_takes_the_trace_flags():
    args = ttcli.build_parser().parse_args([TINY, "--trace-dir", "a", "--profile-dir", "b"])
    assert (args.trace_dir, args.profile_dir) == ("a", "b")
