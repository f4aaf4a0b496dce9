"""The port's tuned-profile API (``utils/config.py``), the manifest's
snapshot (``obs/manifest.py``) and the three CLIs' knob resolution ladder,
against the JAX package's.

The same files go through both packages' ``load_tuned_profile``,
``write_tuned_profile`` and ``tuned_config``; a profile one package writes
loads in the other with equal fields.  The port's committed profiles lie
in its package directory, so it never loads the JAX package's
``tuned_profile_cpu.json`` at the repository root.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from page_rank_and_tfidf_using_apache_spark_tpu import serving as jserving
from page_rank_and_tfidf_using_apache_spark_tpu.obs import manifest as jmanifest
from page_rank_and_tfidf_using_apache_spark_tpu.utils import artifacts as jart
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving as tserving
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as tcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import serve as tscli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import tfidf as ttcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs import manifest as tmanifest
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.autotune import TUNED_KNOBS
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import artifacts as tart
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "tests" / "fixtures" / "tiny.txt")
PKGS = {"jax": (jcfg, jart), "torch": (tcfg, tart)}

KNOBS_A = {"prefetch": 4, "pipeline_depth": 2, "pack_target_tokens": 131072}
# a profile of every knob, none at its TUNABLE_DEFAULTS value
OFF_DEFAULT = {"head_coverage": 0.25, "head_row_width": 64, "shuffle_bucket_width": 4,
               "owned_max_head": 1024, "prefetch": 0, "pipeline_depth": 4,
               "pack_target_tokens": 40, "max_batch": 4, "impact_bucket_width": 16,
               "impact_warm_buckets": 4096}


@pytest.fixture(autouse=True)
def no_env_profile(monkeypatch):
    monkeypatch.delenv("GRAFT_TUNED_PROFILE", raising=False)


def fields(p) -> dict:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


# ------------------------------------------------------------- round trip

@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax")])
def test_profile_written_by_one_package_loads_in_the_other(writer, reader, tmp_path):
    p = tmp_path / "profile.json"
    record = PKGS[writer][0].write_tuned_profile(p, "cpu", KNOBS_A,
                                                 measured={"sweep_secs": 1.0})
    assert set(record) == {"backend", "knobs", "git_sha", "created_wall", "measured"}
    # the artifact is one JSON line, keys sorted
    assert len(p.read_text().strip().splitlines()) == 1
    assert json.loads(p.read_text()) == record
    got = PKGS[reader][0].load_tuned_profile(backend="cpu", path=p)
    want = PKGS[writer][0].load_tuned_profile(backend="cpu", path=p)
    assert fields(got) == fields(want)
    assert got.knobs == KNOBS_A and got.source == "explicit" and got.backend == "cpu"
    assert got.measured == {"sweep_secs": 1.0} and got.path == str(p)


def test_write_records_the_references_keys(tmp_path):
    a = tcfg.write_tuned_profile(tmp_path / "a.json", "cpu", KNOBS_A)
    b = jcfg.write_tuned_profile(tmp_path / "b.json", "cpu", KNOBS_A)
    assert set(a) == set(b)
    assert {k: v for k, v in a.items() if k != "created_wall"} == \
        {k: v for k, v in b.items() if k != "created_wall"}


# ---------------------------------------------------------------- the ladder

def test_resolution_ladder_through_both_packages(tmp_path, monkeypatch):
    """explicit path > GRAFT_TUNED_PROFILE ('off' and friends disable) >
    committed profile (each package's own root) > None."""
    roots = {pkg: tmp_path / pkg for pkg in PKGS}
    for pkg, root in roots.items():
        root.mkdir()
        committed = Path(PKGS[pkg][0].profile_path("cpu", root=root))
        assert committed.name == "tuned_profile_cpu.json"
        PKGS[pkg][0].write_tuned_profile(committed, "cpu", dict(KNOBS_A, prefetch=0))
    env_p = tmp_path / "env_profile.json"
    tcfg.write_tuned_profile(env_p, "cpu", dict(KNOBS_A, prefetch=2))
    exp_p = tmp_path / "explicit.json"
    jcfg.write_tuned_profile(exp_p, "cpu", dict(KNOBS_A, prefetch=4))

    def both(**kw):
        got = [PKGS[p][0].load_tuned_profile(backend="cpu", root=roots[p], **kw)
               for p in ("jax", "torch")]
        if got[0] is None:
            assert got[1] is None
            return None
        assert (got[0].source, got[0].knobs) == (got[1].source, got[1].knobs)
        return got[1]

    prof = both()
    assert prof.source == "committed" and prof.knob("prefetch") == 0
    assert prof.path == tcfg.profile_path("cpu", root=roots["torch"])
    monkeypatch.setenv("GRAFT_TUNED_PROFILE", str(env_p))
    prof = both()
    assert prof.source == "env" and prof.knob("prefetch") == 2
    prof = both(path=exp_p)
    assert prof.source == "explicit" and prof.knob("prefetch") == 4
    for off in ("off", "", "0", "none", " OFF "):
        monkeypatch.setenv("GRAFT_TUNED_PROFILE", off)
        assert both() is None
    monkeypatch.delenv("GRAFT_TUNED_PROFILE")
    assert both(path=None) is not None
    empty = tmp_path / "empty"
    assert tcfg.load_tuned_profile(backend="cpu", root=empty) is None
    assert jcfg.load_tuned_profile(backend="cpu", root=empty) is None


def test_port_never_loads_the_reference_file():
    """The JAX package's committed profiles lie at the repository root, the
    port's in its package directory: the reference loads its committed
    ``tuned_profile_cpu.json``, the port (no CPU profile committed) none,
    so CPU runs of the port keep their defaults.  Nothing of the port lies
    where the JAX package's ``profile-drift`` lint reads."""
    assert Path(jcfg.profile_path("cpu")) == REPO / "tuned_profile_cpu.json"
    assert Path(tcfg.profile_path("cpu")) == \
        REPO / "page_rank_and_tfidf_using_apache_spark_tpu_torch" / "tuned_profile_cpu.json"
    assert jcfg.load_tuned_profile(backend="cpu").source == "committed"
    assert not Path(tcfg.profile_path("cpu")).exists()
    assert tcfg.load_tuned_profile(backend="cpu") is None
    assert {p.name for p in REPO.glob("tuned_profile_*.json")} == {"tuned_profile_cpu.json"}


def test_committed_gpu_profile(tmp_path):
    """The port's committed ``tuned_profile_gpu.json``: stamped ``gpu`` with
    the card's name and power limit, every tuned knob in its domain,
    ``owned`` a fallback at its default; refused for the CPU."""
    path = tcfg.profile_path("gpu")
    prof = tcfg.load_tuned_profile(backend="gpu")
    assert prof is not None and prof.source == "committed" and prof.path == path
    domains = {name: domain for name, domain, _ in TUNED_KNOBS}
    assert set(prof.knobs) == set(domains)
    assert all(prof.knobs[k] in domains[k] for k in domains)
    assert prof.measured["device"].startswith("NVIDIA") and prof.measured["power_limit"]
    owned = prof.measured["groups"]["owned"]
    assert owned["fallback"] and prof.knobs["owned_max_head"] == \
        tcfg.TUNABLE_DEFAULTS["owned_max_head"]
    with pytest.raises(tart.ProvenanceError, match="cross-backend"):
        tcfg.load_tuned_profile(backend="cpu", path=path)
    # the CPU's default resolution never reaches it
    assert tcfg.load_tuned_profile(backend="cpu") is None


# ------------------------------------------------------------ tuned_config

def _serve(pkg):
    return (jserving if pkg == "jax" else tserving).ServeConfig


CLASSES = {
    "PageRankConfig": lambda pkg: PKGS[pkg][0].PageRankConfig,
    "TfidfConfig": lambda pkg: PKGS[pkg][0].TfidfConfig,
    "IngestConfig": lambda pkg: PKGS[pkg][0].IngestConfig,
    "ServeConfig": _serve,
}


def _parity(cls_name: str, knobs: dict, overrides: dict) -> None:
    """The port's config equals the reference's on every shared field."""
    built = {}
    for pkg in ("jax", "torch"):
        cfg, cls = PKGS[pkg][0], CLASSES[cls_name](pkg)
        prof = cfg.TunedProfile(backend="cpu", knobs=dict(knobs))
        names = {f.name for f in dataclasses.fields(cls)}
        built[pkg] = json.loads(cfg.config_to_json(cfg.tuned_config(
            cls, prof, **{k: v for k, v in overrides.items() if k in names})))
    shared = set(built["jax"]) & set(built["torch"])
    assert shared and {k: built["torch"][k] for k in shared} == \
        {k: built["jax"][k] for k in shared}
    for k in shared & set(tcfg.TUNABLE_DEFAULTS):
        assert type(built["torch"][k]) is type(built["jax"][k]), k


@pytest.mark.parametrize("cls_name", list(CLASSES))
def test_tuned_config_parity(cls_name):
    """Every knob off its default, as JSON floats (cast back to int for int
    knobs); one explicit override beats the profile; None means unset."""
    knobs = {k: float(v) for k, v in OFF_DEFAULT.items()}
    overrides = {"prefetch": 1, "max_batch": 16, "head_row_width": None, "top_k": 7,
                 "vocab_bits": 9, "iterations": 5, "pipeline_depth": None}
    _parity(cls_name, knobs, overrides)
    cls = CLASSES[cls_name]("torch")
    cfg = tcfg.tuned_config(cls, tcfg.TunedProfile(backend="cpu", knobs=knobs),
                            **{k: v for k, v in overrides.items()
                               if k in {f.name for f in dataclasses.fields(cls)}})
    for f in dataclasses.fields(cls):
        if f.name in OFF_DEFAULT:
            want = overrides.get(f.name) or OFF_DEFAULT[f.name]
            assert getattr(cfg, f.name) == want and \
                type(getattr(cfg, f.name)) is type(tcfg.TUNABLE_DEFAULTS[f.name])
    with pytest.raises(TypeError, match="no fields"):
        tcfg.tuned_config(cls, None, not_a_field=3)
    # no profile, or a profile without the knob: the field default stands
    assert tcfg.tuned_config(cls, None) == cls()
    assert tcfg.tuned_config(cls, tcfg.TunedProfile(backend="cpu", knobs={})) == cls()


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_tuned_config_parity_over_drawn_knobs(data):
    cls_name = data.draw(st.sampled_from(list(CLASSES)))
    knobs, overrides = {}, {}
    for name, domain, _ in TUNED_KNOBS:
        v = data.draw(st.one_of(st.none(), st.sampled_from(domain)))
        if v is not None:
            knobs[name] = float(v) if data.draw(st.booleans()) else v
        overrides[name] = data.draw(st.one_of(st.none(), st.sampled_from(domain)))
    _parity(cls_name, knobs, overrides)


# ------------------------------------------------------- structure, provenance

@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("text, match", [
    ("{not json", "not valid JSON"),
    (json.dumps({"knobs": {}}), "required keys"),
    (json.dumps([1, 2]), "required keys"),
    (json.dumps({"backend": "cpu", "knobs": {"prefetch": True}}), "numbers"),
    (json.dumps({"backend": "cpu", "knobs": {"prefetch": "2"}}), "numbers"),
    (json.dumps({"backend": "cpu", "knobs": [2]}), "numbers"),
    (None, "unreadable"),
])
def test_profile_structure_errors(pkg, text, match, tmp_path):
    p = tmp_path / "p.json"
    if text is not None:
        p.write_text(text)
    cfg = PKGS[pkg][0]
    with pytest.raises(cfg.TunedProfileError, match=match):
        cfg.load_tuned_profile(backend="cpu", path=p)


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("stamped, backend", [("cpu", "gpu"), ("gpu", "cpu"),
                                              ("cpu", "tpu"), ("tpu", "cpu")])
def test_provenance_refusal_both_directions(pkg, stamped, backend, tmp_path):
    cfg, art = PKGS[pkg]
    p = tmp_path / f"tuned_profile_{stamped}.json"
    cfg.write_tuned_profile(p, stamped, KNOBS_A)
    with pytest.raises(art.ProvenanceError, match="cross-backend"):
        cfg.load_tuned_profile(backend=backend, path=p)
    assert cfg.load_tuned_profile(backend=stamped, path=p).backend == stamped


@pytest.mark.parametrize("accel", ["gpu", "tpu"])
def test_overwrite_guard_protects_an_accelerator_profile(accel, tmp_path):
    p = tmp_path / f"tuned_profile_{accel}.json"
    tcfg.write_tuned_profile(p, accel, KNOBS_A)
    with pytest.raises(tart.ProvenanceError, match="refusing to overwrite"):
        tcfg.write_tuned_profile(p, "cpu", KNOBS_A)
    assert tcfg.load_tuned_profile(backend=accel, path=p).knobs == KNOBS_A
    tcfg.write_tuned_profile(p, "cpu", dict(KNOBS_A, prefetch=0), force=True)
    assert tcfg.load_tuned_profile(path=p, backend="cpu").knob("prefetch") == 0
    tcfg.write_tuned_profile(p, "cpu", dict(KNOBS_A, prefetch=2))
    assert tcfg.load_tuned_profile(path=p, backend="cpu").knob("prefetch") == 2


def test_default_backend_follows_cuda(monkeypatch):
    import torch

    assert tcfg.default_backend() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcfg.default_backend() == "gpu"


# ------------------------------------------------------- crash consistency

_KILL_CHILD = textwrap.dedent("""
    import json, os, signal, sys

    sys.path.insert(0, sys.argv[1])
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        write_tuned_profile,
    )

    target, kill_at = sys.argv[2], int(sys.argv[3])
    counter = {"n": 0}

    def wrap(orig):
        def inner(*args, **kwargs):
            if counter["n"] == kill_at:
                os.kill(os.getpid(), signal.SIGKILL)
            counter["n"] += 1
            return orig(*args, **kwargs)
        return inner

    os.replace = wrap(os.replace)
    os.rename = wrap(os.rename)
    os.unlink = wrap(os.unlink)
    os.fsync = wrap(os.fsync)

    write_tuned_profile(target, "cpu", {"prefetch": 4}, measured={"v": 2})
    print(json.dumps({"boundaries": counter["n"]}))
""")


def test_profile_commit_kill_matrix(tmp_path):
    """The reference harness's SIGKILL schedule (right before every
    reader-visible mutation syscall) on the port's ``write_tuned_profile``:
    the committed path parses and holds exactly the old record or the new
    one, never a torn file."""
    target = tmp_path / "tuned_profile_cpu.json"
    tcfg.write_tuned_profile(target, "cpu", {"prefetch": 2}, measured={"v": 1})
    old_text = target.read_text()

    def run_child(kill_at: int):
        return subprocess.run(
            [sys.executable, "-c", _KILL_CHILD, str(REPO), str(target), str(kill_at)],
            capture_output=True, text=True, timeout=60,
        )

    count = run_child(-1)
    assert count.returncode == 0, count.stderr
    boundaries = json.loads(count.stdout)["boundaries"]
    assert boundaries >= 2, "the commit lost its staged-rename protocol"
    new_record = json.loads(target.read_text())
    assert new_record["knobs"] == {"prefetch": 4}

    def stamp_free(record: dict) -> dict:
        return {k: v for k, v in record.items() if k != "created_wall"}

    old_record = json.loads(old_text)
    for kill_at in range(boundaries):
        target.write_text(old_text)
        proc = run_child(kill_at)
        assert proc.returncode == -signal.SIGKILL, (kill_at, proc.stderr)
        surviving = json.loads(target.read_text())
        assert stamp_free(surviving) in (stamp_free(old_record), stamp_free(new_record)), (
            f"kill at boundary {kill_at} left a mixed-generation profile: {surviving!r}")


# ---------------------------------------------------------------- manifest

@pytest.mark.parametrize("case", ["valid", "broken", "wrong_backend", "off", "unset"])
def test_startup_snapshot_matches_reference(case, tmp_path, monkeypatch):
    """The manifest's snapshot of the profile a CLI resolves (here the CPU
    backend through the env and committed rungs) equals the reference's
    startup snapshot; a broken or wrong-backend profile is recorded as its
    error, not raised, and a run opened under the snapshot writes it.  A run that
    resolves no profile (an API caller's) records None whatever the env."""
    p = tmp_path / "p.json"
    if case == "valid":
        tcfg.write_tuned_profile(p, "cpu", KNOBS_A)
    elif case == "broken":
        p.write_text("{not json")
    elif case == "wrong_backend":
        tcfg.write_tuned_profile(p, "gpu", KNOBS_A)
    if case != "unset":
        monkeypatch.setenv("GRAFT_TUNED_PROFILE", "off" if case == "off" else str(p))
    prof, got, refused = tmanifest.resolve_tuned_profile("cpu", None)
    plain = obs.start_run("api", trace_dir=str(tmp_path / "api"))
    obs.end_run()
    assert json.loads(Path(plain.manifest_path).read_text())["tuned_profile"] is None
    if case == "unset":  # the reference loads its committed tuned_profile_cpu.json
        assert got is None and prof is None and refused is None
        assert jmanifest._tuned_profile_snapshot()["source"] == "committed"
        return
    assert got == jmanifest._tuned_profile_snapshot()
    if case == "valid":
        assert got["source"] == "env" and got["knobs"] == KNOBS_A and got["path"] == str(p)
        assert prof.knobs == KNOBS_A and refused is None
    elif case == "off":
        assert got is None and prof is None and refused is None
    else:
        assert got["error"].startswith(("TunedProfileError", "ProvenanceError"))
        assert prof is None and got["error"].startswith(type(refused).__name__)
    with tmanifest.recording_profile(got):
        run = obs.start_run("snapshot", trace_dir=str(tmp_path / "tr"))
    obs.end_run()
    man = json.loads(Path(run.manifest_path).read_text())
    assert man["tuned_profile"] == got and man["status"] == "ok"


# -------------------------------------------------------------------- CLIs

def _spy(monkeypatch, module, name, seen: list):
    """Record the config (second argument) of each call of ``module.name``."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.fixture
def profiles(tmp_path):
    cpu = tmp_path / "cpu.json"
    tcfg.write_tuned_profile(cpu, "cpu", OFF_DEFAULT)
    gpu = tmp_path / "gpu.json"
    tcfg.write_tuned_profile(gpu, "gpu", OFF_DEFAULT)
    return {"cpu": str(cpu), "gpu": str(gpu)}


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    cfg = tcfg.TfidfConfig(vocab_bits=10)
    d = tmp_path_factory.mktemp("idx")
    out = run_tfidf(Path(TINY).read_text().splitlines(), cfg, device="cpu")
    tserving.save_index(str(d), out, cfg)
    q = d / "queries.txt"
    q.write_text("node graph\nrank\nthe page rank of a node\ngraph\n")
    return str(d), str(q)


def _cli(kind, index_dir, tmp_path):
    """(main, module, spied name, argv, explicit flags of OFF_DEFAULT's
    knobs, the knobs the config carries)."""
    if kind == "pagerank":
        return (tcli.main, tcli, "run_pagerank",
                ["synthetic:3000,30000,1", "10", "--spmv-impl", "hybrid", "--device", "cpu"],
                ["--head-coverage", "0.25", "--head-row-width", "64"],
                ("head_coverage", "head_row_width", "shuffle_bucket_width", "owned_max_head"))
    if kind == "tfidf":
        return (ttcli.main, ttcli, "run_tfidf_streaming",
                [TINY, "--lines", "--streaming", "--chunk-docs", "2", "--vocab-bits", "10",
                 "--device", "cpu", "--query", "node", "graph"],
                ["--prefetch", "0", "--pipeline-depth", "4", "--pack-target", "40"],
                ("prefetch", "pipeline_depth", "pack_target_tokens"))
    path, queries = index_dir
    return (tscli.main, tscli, "TfidfServer",
            [path, "--queries", queries, "--top-k", "3", "--scoring", "impacted",
             "--device", "cpu"],
            ["--max-batch", "4", "--impact-bucket-width", "16"],
            ("max_batch", "impact_bucket_width", "impact_warm_buckets"))


@pytest.mark.parametrize("kind", ["pagerank", "tfidf", "serve"])
def test_cli_profile_equals_explicit_flags(kind, profiles, index_dir, tmp_path, monkeypatch,
                                           capsys):
    """``--device cpu --tuned-profile <cpu profile>`` prints what the same
    CLI prints given the equivalent flags, its config carries the
    profile's knobs, and the manifest names the profile."""
    main, module, name, argv, flags, knobs = _cli(kind, index_dir, tmp_path)
    seen: list = []
    _spy(monkeypatch, module, name, seen)
    outs = []
    trace = tmp_path / "trace"
    for extra in (["--tuned-profile", profiles["cpu"], "--trace-dir", str(trace)], flags):
        assert main([*argv, *extra]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0]
    prof_cfg, flag_cfg = seen
    for k in knobs:
        assert getattr(prof_cfg, k) == OFF_DEFAULT[k], k
    for k, v in zip(flags[::2], flags[1::2]):
        field = {"--pack-target": "pack_target_tokens"}.get(k, k[2:].replace("-", "_"))
        assert getattr(flag_cfg, field) == getattr(prof_cfg, field) == type(
            tcfg.TUNABLE_DEFAULTS[field])(v)
    (man_path,) = trace.glob("*.manifest.json")
    man = json.loads(man_path.read_text())
    assert man["status"] == "ok" and man["tuned_profile"] == {
        "path": profiles["cpu"], "backend": "cpu", "git_sha": man["tuned_profile"]["git_sha"],
        "source": "explicit", "knobs": OFF_DEFAULT}


@pytest.mark.parametrize("kind", ["pagerank", "tfidf", "serve"])
def test_cli_env_rung_and_off(kind, profiles, index_dir, tmp_path, monkeypatch, capsys):
    """``GRAFT_TUNED_PROFILE`` steers a run given no flag; ``--tuned-profile
    off`` beats it; with neither (no CPU profile is committed) every knob is
    its TUNABLE_DEFAULTS value; an explicit knob flag beats the profile."""
    main, module, name, argv, flags, knobs = _cli(kind, index_dir, tmp_path)
    seen: list = []
    _spy(monkeypatch, module, name, seen)
    assert main(argv) == 0
    monkeypatch.setenv("GRAFT_TUNED_PROFILE", profiles["cpu"])
    assert main(argv) == 0
    assert main([*argv, "--tuned-profile", "off"]) == 0
    assert main([*argv, flags[0], flags[1]]) == 0
    capsys.readouterr()
    none, env, off, flag = seen
    field = {"--pack-target": "pack_target_tokens"}.get(flags[0], flags[0][2:].replace("-", "_"))
    for k in knobs:
        assert getattr(none, k) == getattr(off, k) == tcfg.TUNABLE_DEFAULTS[k]
        assert getattr(env, k) == OFF_DEFAULT[k]
        assert getattr(flag, k) == (type(tcfg.TUNABLE_DEFAULTS[k])(flags[1]) if k == field
                                    else OFF_DEFAULT[k])


@pytest.mark.parametrize("kind", ["pagerank", "tfidf", "serve"])
def test_cli_refuses_a_gpu_profile_on_the_cpu(kind, profiles, index_dir, tmp_path,
                                              monkeypatch):
    """A ``gpu``-stamped profile under ``--device cpu`` raises
    ``ProvenanceError`` before anything runs; the manifest records it."""
    main, module, name, argv, _, _ = _cli(kind, index_dir, tmp_path)
    seen: list = []
    _spy(monkeypatch, module, name, seen)
    trace = tmp_path / "trace"
    with pytest.raises(tart.ProvenanceError, match="cross-backend"):
        main([*argv, "--tuned-profile", profiles["gpu"], "--trace-dir", str(trace)])
    assert seen == []
    (man_path,) = trace.glob("*.manifest.json")
    man = json.loads(man_path.read_text())
    assert man["status"] == "error:ProvenanceError"
    assert man["tuned_profile"]["error"].startswith("ProvenanceError: tuned profile")


@pytest.mark.parametrize("source", ["profile", "flag"])
def test_cli_streaming_resume_under_a_pack_target(source, tmp_path, monkeypatch):
    """A pack target (from a tuned profile or the flag) re-chunks the
    stream, so its checkpoints count re-packed chunks: the streaming CLI
    killed after a checkpoint resumes to an unbroken run's weights."""
    import random

    rng = random.Random(7)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("".join(" ".join(f"w{rng.randrange(300)}" for _ in range(rng.randint(3, 30)))
                              + "\n" for _ in range(120)))
    prof = tmp_path / "cpu.json"
    tcfg.write_tuned_profile(prof, "cpu", {"pack_target_tokens": 60})
    knob = (["--tuned-profile", str(prof)] if source == "profile"
            else ["--pack-target", "60", "--tuned-profile", "off"])
    argv = [str(corpus), "--lines", "--streaming", "--chunk-docs", "4", "--vocab-bits", "10",
            "--device", "cpu", *knob]
    assert ttcli.main([*argv, "--output", str(tmp_path / "whole.tsv")]) == 0
    real = ttcli.iter_corpus_chunks

    def killed(*args, **kwargs):
        for i, chunk in enumerate(real(*args, **kwargs)):
            if i == 17:
                raise KeyboardInterrupt("killed")
            yield chunk

    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "3"]
    monkeypatch.setattr(ttcli, "iter_corpus_chunks", killed)
    with pytest.raises(KeyboardInterrupt):
        ttcli.main([*argv, *ck])
    monkeypatch.setattr(ttcli, "iter_corpus_chunks", real)
    assert list((tmp_path / "ck").iterdir())
    assert ttcli.main([*argv, *ck, "--resume", "--output", str(tmp_path / "resumed.tsv")]) == 0
    whole = (tmp_path / "whole.tsv").read_text()
    assert whole and (tmp_path / "resumed.tsv").read_text() == whole
