"""The port's resilience layer (``resilience/chaos.py``,
``resilience/executor.py``, ``resilience/elastic.py``) against the JAX
package's, on the CPU.

``chaos.py`` is a copy: its code, docstrings aside, is the reference's.
The executor is a port: plan
schedules, backoff delays, the env policy and the classification of the
shared exception kinds must equal the reference's, and the behaviour and
event tests of ``tests/test_resilience.py`` and
``tests/test_observability.py`` run against both packages.  The CUDA
classes only the port knows (out of memory, a sticky error) are held by
message.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from page_rank_and_tfidf_using_apache_spark_tpu import obs as jobs
from page_rank_and_tfidf_using_apache_spark_tpu import resilience as jresilience
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import chaos as jchaos
from page_rank_and_tfidf_using_apache_spark_tpu.resilience import executor as jrx
from page_rank_and_tfidf_using_apache_spark_tpu.utils import checkpoint as jckpt
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu.utils.metrics import MetricsRecorder as JMetrics
import page_rank_and_tfidf_using_apache_spark_tpu_torch as port
from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs, resilience
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos, elastic
from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder
from tests.test_torch_obs import PORT, REF, _code

# (executor, chaos, checkpoint, MetricsRecorder, obs) of each package
PACKAGES = {
    "port": (rx, chaos, ckpt, MetricsRecorder, obs),
    "jax": (jrx, jchaos, jckpt, JMetrics, jobs),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@contextlib.contextmanager
def sink_of(bus_owner):
    s = bus_owner.MemorySink()
    bus_owner.bus().attach(s)
    try:
        yield s
    finally:
        bus_owner.bus().detach(s)


# ------------------------------------------------------------------ the copy

def test_chaos_copy_matches_reference():
    assert _code(PORT / "resilience" / "chaos.py") == _code(REF / "resilience" / "chaos.py")


def test_device_lost_fires_until_acknowledged():
    """tests/test_elastic.py:92: the injection behaves like a dead card:
    every guarded call fails, carrying the device's index, until a rung
    marks the device lost; then the run's calls succeed again."""
    resilience.reset_health()
    try:
        with sink_of(obs) as sink, chaos.inject("*:device_lost@dev:3") as plan:
            for site in ("a", "b"):
                with pytest.raises(chaos.DeviceLostError) as ei:
                    chaos.on_call(site)
                assert ei.value.device == 3
            elastic.health().mark_lost(3)
            chaos.on_call("a")  # acknowledged: no further injection
            assert plan.call_count("a") == 2
        assert [e["device"] for e in sink.of_kind("chaos")] == [3, 3]
    finally:
        resilience.reset_health()


def test_surface_matches_reference():
    assert set(resilience.__all__) == set(jresilience.__all__)
    for name in resilience.__all__:
        assert hasattr(resilience, name), name
    assert port.ResilienceExhausted is rx.ResilienceExhausted
    assert "ResilienceExhausted" in port.__all__
    assert tcfg.DEGRADE_LADDER == jcfg.DEGRADE_LADDER
    knobs = {"GRAFT_CHAOS", "GRAFT_ELASTIC", "GRAFT_RETRY_MAX", "GRAFT_SYNC_DEADLINE_S",
             "GRAFT_STEP_DEADLINE_S", "GRAFT_BACKOFF_BASE_S", "GRAFT_BACKOFF_MAX_S"}
    assert knobs <= tcfg.GRAFT_ENV_KNOBS and knobs <= jcfg.GRAFT_ENV_KNOBS


# ------------------------------------------------------- executor parity

PLAN_SPECS = [
    "a:fail@3; b:lost@2+ ; c:hang@%4:0.5",
    "*:fail@%2",
    "*:fail@%3",
    "pagerank_step:fail@2;pagerank_ckpt_pull:fail@1",
    "hits_delta_sync:hang@3:2.0",
    "x:net_hang@1;y:net_partition@2+;z:proc_kill@5",
    "s:device_lost@dev:1",
    "tfidf_chunk_sync:fail@%3;ingest_h2d_put:fail@2;ingest_h2d_wait:fail@4",
    "",
]
BAD_SPECS = ["nosep", "a:frob@1", "a:fail", "a:fail@0", "a:fail@x", "a:fail@%0",
             "a:fail@5++", "a:fail@%5+", "a:fail@+5", "a:device_lost@3",
             "a:device_lost@dev:x", "a:fail@1:2:3"]
SITES = ["a", "b", "c", "x", "y", "z", "s", "pagerank_step", "pagerank_ckpt_pull",
         "hits_delta_sync", "tfidf_chunk_sync", "ingest_h2d_put", "ingest_h2d_wait", "other"]


@pytest.mark.parametrize("spec", PLAN_SPECS)
def test_parse_plan_matches_reference(spec):
    got, want = chaos.parse_plan(spec), jchaos.parse_plan(spec)
    assert [dataclasses.astuple(i) for i in got] == [dataclasses.astuple(i) for i in want]
    for g, w in zip(got, want):
        for site in SITES:
            assert ([g.matches(site, n) for n in range(1, 13)]
                    == [w.matches(site, n) for n in range(1, 13)]), (spec, site)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_plan_rejects_like_reference(spec):
    for mod in (chaos, jchaos):
        with pytest.raises(ValueError):
            mod.parse_plan(spec)


@pytest.mark.parametrize("site", ["pagerank_step", "tfidf_chunk_sync", "serve_dispatch",
                                  "ingest_h2d_put", "x"])
def test_backoff_delay_matches_reference(site):
    for base, cap in ((0.05, 2.0), (0.001, 0.01), (1.0, 100.0)):
        got = [rx.backoff_delay(site, a, rx.RetryPolicy(backoff_base_s=base,
                                                         backoff_max_s=cap))
               for a in range(1, 9)]
        want = [jrx.backoff_delay(site, a, jrx.RetryPolicy(backoff_base_s=base,
                                                           backoff_max_s=cap))
                for a in range(1, 9)]
        assert got == want


@pytest.mark.parametrize("env", [
    {},
    {"GRAFT_RETRY_MAX": "7"},
    {"GRAFT_SYNC_DEADLINE_S": "0.5", "GRAFT_BACKOFF_BASE_S": "0.001"},
    {"GRAFT_BACKOFF_MAX_S": "9.5", "GRAFT_RETRY_MAX": "0"},
])
def test_retry_policy_from_env_matches_reference(env, monkeypatch):
    for k in ("GRAFT_RETRY_MAX", "GRAFT_SYNC_DEADLINE_S", "GRAFT_BACKOFF_BASE_S",
              "GRAFT_BACKOFF_MAX_S"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert (dataclasses.asdict(rx.RetryPolicy.from_env())
            == dataclasses.asdict(jrx.RetryPolicy.from_env()))


def _shared_exc(mod_rx, mod_chaos, kind: str) -> BaseException:
    if kind == "exhausted":
        return mod_rx.ResilienceExhausted("s", 2, RuntimeError("UNAVAILABLE"), None)
    if kind == "lost_marker":
        return mod_chaos.DeviceLostError("UNAVAILABLE: device lost")
    return {
        "chaos": lambda: mod_chaos.ChaosError("x"),
        "partition": lambda: mod_chaos.PartitionError("x"),
        "lost": lambda: mod_chaos.DeviceLostError("x"),
        "deadline": lambda: mod_rx.SyncDeadlineExceeded("x"),
        "resource": lambda: RuntimeError("RESOURCE_EXHAUSTED: oom"),
        "unavailable": lambda: RuntimeError("UNAVAILABLE: socket closed"),
        "aborted": lambda: OSError("ABORTED"),
        "cancelled": lambda: RuntimeError("CANCELLED"),
        "deadline_marker": lambda: TimeoutError("DEADLINE_EXCEEDED"),
        "shape": lambda: ValueError("shape mismatch"),
        "key": lambda: KeyError("k"),
    }[kind]()


@pytest.mark.parametrize("kind", ["chaos", "partition", "lost", "lost_marker", "deadline",
                                  "exhausted", "resource", "unavailable", "aborted",
                                  "cancelled", "deadline_marker", "shape", "key"])
def test_is_transient_matches_reference(kind):
    assert (rx.is_transient(_shared_exc(rx, chaos, kind))
            == jrx.is_transient(_shared_exc(jrx, jchaos, kind)))


@pytest.mark.parametrize("exc, transient", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
    (RuntimeError("CUDA error: misaligned address\nUNAVAILABLE"), False),
    (RuntimeError("CUDA error: device-side assert triggered"), False),
    (RuntimeError("CUDA error: an illegal memory access was encountered "
                  "(RESOURCE_EXHAUSTED)"), False),
])
def test_is_transient_cuda_classes(exc, transient):
    """A CUDA out-of-memory is the counterpart of RESOURCE_EXHAUSTED; a
    sticky CUDA error kills the context, so no marker makes it transient."""
    assert rx.is_transient(exc) is transient


# --------------------------------- behaviour (tests/test_resilience.py)

def test_inject_overrides_env_and_counts(pkg, monkeypatch):
    _, ch, *_ = pkg
    # the module caches the env plan it parsed, call counts included: start
    # from an empty cache and put the old one back afterwards, so neither
    # this test nor tests/test_resilience.py's twin (the same spec, in the
    # same process) meets a plan whose first call was already counted
    monkeypatch.setattr(ch, "_env_cache", (None, None))
    monkeypatch.setenv("GRAFT_CHAOS", "s:lost@1")  # would fail immediately
    with ch.inject("s:fail@2") as plan:
        ch.on_call("s")  # call 1: no injection under the override
        with pytest.raises(ch.ChaosError):
            ch.on_call("s")  # call 2: injected transient
        assert plan.call_count("s") == 2
    with pytest.raises(ch.DeviceLostError):
        ch.on_call("s")  # the env plan again once the context exits


def test_backoff_deterministic_and_bounded(pkg):
    r, *_ = pkg
    pol = r.RetryPolicy(backoff_base_s=0.05, backoff_max_s=0.2)
    d1 = r.backoff_delay("site", 1, pol)
    assert d1 == r.backoff_delay("site", 1, pol)
    assert 0.05 <= d1 < 0.075
    assert r.backoff_delay("site", 10, pol) == 0.2


def test_run_guarded_retries_transients(pkg):
    r, ch, _, metrics_cls, _ = pkg
    calls = []
    pol = r.RetryPolicy(max_retries=3, backoff_base_s=0.001)
    m = metrics_cls()
    with ch.inject("t1:fail@1;t1:fail@2"):
        out = r.run_guarded(lambda: calls.append(1) or 42, site="t1", policy=pol, metrics=m)
    assert out == 42
    assert len(calls) == 1  # both injections fired BEFORE fn ran
    assert sum(rec.get("event") == "retry" for rec in m.records) == 2


def test_run_guarded_persistent_skips_retries_and_uses_fallback(pkg):
    r, ch, _, metrics_cls, _ = pkg
    pol = r.RetryPolicy(max_retries=5, backoff_base_s=0.001)
    m = metrics_cls()
    with ch.inject("t2:lost@1+") as plan:
        out = r.run_guarded(lambda: 1, site="t2", policy=pol, metrics=m,
                            fallback=lambda: "degraded")
    assert out == "degraded"
    assert plan.call_count("t2") == 1  # no retry spent on a lost device
    assert any(rec.get("event") == "degraded" for rec in m.records)


def test_run_guarded_exhausted_carries_checkpoint(pkg, tmp_path):
    r, ch, ck, *_ = pkg
    d = str(tmp_path)
    ck.save_checkpoint(d, 7, {"x": np.arange(3)}, "h")
    pol = r.RetryPolicy(max_retries=1, backoff_base_s=0.001)
    with ch.inject("t3:fail@1+"):
        with pytest.raises(r.ResilienceExhausted) as ei:
            r.run_guarded(lambda: 1, site="t3", policy=pol, checkpoint_dir=d)
    err = ei.value
    assert err.site == "t3" and err.attempts == 2
    assert err.last_checkpoint and err.last_checkpoint.endswith("ckpt_00000007.npz")
    assert isinstance(err.last_error, ch.ChaosError)
    assert err.last_checkpoint in str(err)


def test_sync_deadline_watchdog_abandons_hung_call(pkg):
    r, ch, *_ = pkg
    pol = r.RetryPolicy(max_retries=1, backoff_base_s=0.001, deadline_s=0.15)
    t0 = time.perf_counter()
    # call 1 hangs 5 s inside the watched thread; the watchdog abandons it
    # and the retry (call 2, uninjected) succeeds
    with ch.inject("t4:hang@1:5"):
        out = r.run_guarded(lambda: "ok", site="t4", policy=pol)
    assert out == "ok"
    assert time.perf_counter() - t0 < 2.0


def test_retry_transient_and_attempt_once_propagate_raw(pkg):
    """retry_transient retries a transient fault but lets a lost device and
    a spent budget through raw; attempt_once never retries; neither emits
    ``exhausted``."""
    r, ch, _, _, bus = pkg
    pol = r.RetryPolicy(max_retries=1, backoff_base_s=0.001)
    with sink_of(bus) as sink:
        with ch.inject("u1:fail@1"):
            assert r.retry_transient(lambda: 5, site="u1", policy=pol) == 5
        with ch.inject("u2:lost@1"), pytest.raises(ch.DeviceLostError):
            r.retry_transient(lambda: 5, site="u2", policy=pol)
        with ch.inject("u3:fail@1+"), pytest.raises(ch.ChaosError):
            r.retry_transient(lambda: 5, site="u3", policy=pol)
        with ch.inject("u4:fail@1") as plan, pytest.raises(ch.ChaosError):
            r.attempt_once(lambda: 5, site="u4", policy=pol)
        assert plan.call_count("u4") == 1
    assert not sink.of_kind("exhausted")
    assert [(e["site"], e["attempt"]) for e in sink.of_kind("retry")] == [
        ("u1", 1), ("u3", 1)]


def test_watchdog_attempt_enters_the_callers_stream(monkeypatch):
    """Under a deadline the attempt runs on another thread, inside the
    context ``_caller_stream`` captured on the caller's (on the card: the
    caller's device and current stream)."""
    seen = []

    @contextlib.contextmanager
    def entered():
        seen.append(("enter", threading.current_thread().name))
        yield
        seen.append(("exit", threading.current_thread().name))

    caller = threading.current_thread().name
    monkeypatch.setattr(rx, "_caller_stream", lambda: entered)
    pol = rx.RetryPolicy(deadline_s=5.0)
    out = rx.run_guarded(lambda: seen.append(("fn", threading.current_thread().name)) or 3,
                         site="stream_t", policy=pol)
    assert out == 3
    assert [k for k, _ in seen] == ["enter", "fn", "exit"]
    assert len({n for _, n in seen}) == 1 and seen[0][1] != caller
    monkeypatch.undo()
    assert rx._caller_stream() is contextlib.nullcontext  # no CUDA here


def test_device_get_pulls_a_tree_as_snapshots():
    """device_get gives numpy for every tensor of a nested tuple (named
    too), list or dict, other leaves as they are; a CPU tensor updated in
    place afterwards leaves the pulled array alone."""
    Pair = __import__("collections").namedtuple("Pair", "a b")
    t = torch.arange(4, dtype=torch.float64)
    tree = {"p": Pair(t, [torch.ones(2, dtype=torch.int32), 7]), "s": torch.tensor(2.5)}
    got = rx.device_get(tree, site="dg_t")
    assert isinstance(got["p"], Pair) and isinstance(got["p"].a, np.ndarray)
    assert got["p"].a.dtype == np.float64 and got["p"].b[1] == 7
    assert float(got["s"]) == 2.5 and got["p"].b[0].dtype == np.int32
    t.add_(10.0)
    assert got["p"].a.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert rx.block_until_ready(tree, site="bur_t") is tree


# ------------------------------------- events (tests/test_observability.py)

def test_chaos_injected_retry_publishes_events(pkg):
    r, ch, _, _, bus = pkg
    pol = r.RetryPolicy(max_retries=3, backoff_base_s=0.001)
    with sink_of(bus) as sink:
        with ch.inject("obs_t1:fail@1;obs_t1:fail@2"):
            out = r.run_guarded(lambda: 42, site="obs_t1", policy=pol)
    assert out == 42
    chaos_evts = [e for e in sink.of_kind("chaos") if e["site"] == "obs_t1"]
    retry_evts = [e for e in sink.of_kind("retry") if e["site"] == "obs_t1"]
    backoffs = [e for e in sink.of_kind("backoff") if e["site"] == "obs_t1"]
    assert len(chaos_evts) == 2 and chaos_evts[0]["fault"] == "fail"
    assert len(retry_evts) == 2
    assert retry_evts[0]["attempt"] == 1 and "ChaosError" in retry_evts[0]["error"]
    assert len(backoffs) == 2 and all(b["secs"] > 0 for b in backoffs)


def test_exhausted_and_degraded_events(pkg):
    r, ch, _, _, bus = pkg
    pol = r.RetryPolicy(max_retries=1, backoff_base_s=0.001)
    with sink_of(bus) as sink:
        with ch.inject("obs_t2:lost@1+"):
            out = r.run_guarded(lambda: 1, site="obs_t2", policy=pol,
                                fallback=lambda: "cpu")
        assert out == "cpu"
        assert [e["site"] for e in sink.of_kind("degraded")] == ["obs_t2"]
        with ch.inject("obs_t3:fail@1+"):
            with pytest.raises(r.ResilienceExhausted):
                r.run_guarded(lambda: 1, site="obs_t3", policy=pol)
    exh = sink.of_kind("exhausted")
    assert exh and exh[-1]["site"] == "obs_t3" and exh[-1]["attempts"] == 2


def test_watchdog_event_on_deadline(pkg):
    r, ch, _, _, bus = pkg
    pol = r.RetryPolicy(max_retries=1, backoff_base_s=0.001, deadline_s=0.1)
    with sink_of(bus) as sink:
        with ch.inject("obs_t4:hang@1:5"):
            out = r.run_guarded(lambda: "ok", site="obs_t4", policy=pol)
    assert out == "ok"
    wd = [e for e in sink.of_kind("watchdog") if e["site"] == "obs_t4"]
    assert len(wd) == 1 and wd[0]["deadline_s"] == 0.1


@pytest.mark.parametrize("name", ["port", "jax"])
def test_counters_of_a_retried_call(name):
    """A run's aggregates count retries, watchdog fires, injections and the
    backoff histogram under the reference's names, in both packages."""
    r, ch, _, _, bus = PACKAGES[name]
    pol = r.RetryPolicy(max_retries=2, backoff_base_s=0.001, deadline_s=0.1)
    with bus.run("cnt") as run, ch.inject("cnt_t:fail@1;cnt_t:hang@2:1"):
        assert r.run_guarded(lambda: 1, site="cnt_t", policy=pol) == 1
        summary = run.aggregates.summary()
    assert summary["counters"] == {"chaos_injections": 2, "retries": 2, "watchdog_fires": 1}
    assert summary["histograms"]["backoff_secs"]["count"] == 2
