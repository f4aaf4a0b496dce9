"""The port's tier 3, active half (``..._torch/analysis/profile.py``): the
tuned-profile contract, against the reference's ``profile-drift`` and
``untuned-knob-read`` cases (``tests/test_autotune.py``).

``profile.py`` is a copy of the reference's with the port's package name,
reading the profiles beside the port's package: the copy is held to the
reference line for line apart from that, every fixture of the reference
runs through both analyzers with the same findings, and the port's
committed surface is clean.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.analysis import profile as ref_profile
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import (
    baseline_path,
    load_baseline,
    repo_root,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import profile
from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import TUNED_KNOBS
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
    TUNABLE_DEFAULTS,
    load_tuned_profile,
)

REPO = repo_root()
PKG = "page_rank_and_tfidf_using_apache_spark_tpu_torch"
REF_PKG = "page_rank_and_tfidf_using_apache_spark_tpu"

REGISTRY_OK = """
class EntryPoint:
    def __init__(self, name=None):
        self.name = name


ENTRY_POINTS = (
    EntryPoint(name="tfidf_chunk_ingest_carry"),
)

TUNED_KNOBS = (
    ("prefetch", (0, 2, 4), ("tfidf_chunk_ingest_carry",)),
)
"""

CONFIG_OK = """
TUNABLE_DEFAULTS = {"prefetch": 2}
"""


def profile_lint(mod, pkg: str, tmp_path: Path, registry_src: str, config_src: str,
                 scan_files: dict | None = None, profiles=None):
    """A synthetic contract tree under ``pkg`` run through ``mod``'s
    profile checks (``run_profile``'s injection point)."""
    files = {f"{pkg}/analysis/registry.py": registry_src,
             f"{pkg}/utils/config.py": config_src,
             **{f"{pkg}/{rel}": src for rel, src in (scan_files or {}).items()}}
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    mod._contract_cache.clear()
    try:
        return mod.run_profile(root=tmp_path, paths=[tmp_path], profiles=list(profiles or []))
    finally:
        mod._contract_cache.clear()


def both(tmp_path: Path, registry_src: str, config_src: str, scan_files=None,
         record: dict | None = None, backend: str = "gpu"):
    """The port's and the reference's results on one fixture: (port, ref)."""
    out = []
    for mod, pkg, sub in ((profile, PKG, "port"), (ref_profile, REF_PKG, "ref")):
        arts = []
        if record is not None:
            rel = f"{PKG}/tuned_profile_{backend}.json" if mod is profile \
                else f"tuned_profile_{backend}.json"
            arts = [mod.ProfileArtifact(relpath=rel, backend=backend, record=record, error=None)]
        out.append(profile_lint(mod, pkg, tmp_path / sub, registry_src, config_src,
                                scan_files, arts))
    return out


def same_findings(port, ref) -> list:
    """The port's findings, after checking they are the reference's (rule,
    message, line; paths under the port's package)."""
    key = lambda f: (f.rule, f.line, f.message.replace(f"{PKG}/", "").replace(  # noqa: E731
        f"{REF_PKG}/", ""))
    assert sorted(map(key, port.findings)) == sorted(map(key, ref.findings))
    return port.findings


def test_profile_drift_tn(tmp_path):
    port, ref = both(tmp_path, REGISTRY_OK, CONFIG_OK,
                     record={"backend": "gpu", "knobs": {"prefetch": 4}})
    assert same_findings(port, ref) == []
    assert port.report["knobs"]["prefetch"]["tuned"]["gpu"] == 4


def test_profile_drift_artifact_tp(tmp_path):
    """Stale knob, out-of-domain value, declared-but-untuned knob, and a
    backend stamp disagreeing with the filename — each its own finding."""
    port, ref = both(tmp_path / "a", REGISTRY_OK, CONFIG_OK,
                     record={"backend": "cpu", "knobs": {"prefetch": 3, "bogus": 1}})
    msgs = [f.message for f in same_findings(port, ref)]
    assert all(f.rule == "profile-drift" for f in port.findings)
    assert any("stale knob 'bogus'" in m for m in msgs), msgs
    assert any("outside" in m and "'prefetch'" in m for m in msgs), msgs
    assert any("does not match the filename" in m for m in msgs), msgs
    assert all(f.path == f"{PKG}/tuned_profile_gpu.json" for f in port.findings)
    port, ref = both(tmp_path / "b", REGISTRY_OK, CONFIG_OK,
                     record={"backend": "gpu", "knobs": {}})
    assert any("untuned" in f.message for f in same_findings(port, ref))
    # the TUNABLE_DEFAULTS value is always in the domain
    port, ref = both(tmp_path / "c", REGISTRY_OK.replace("(0, 2, 4)", "(0, 4)"), CONFIG_OK,
                     record={"backend": "gpu", "knobs": {"prefetch": 2}})
    assert same_findings(port, ref) == []


@pytest.mark.parametrize("registry_src, wanted", [
    (REGISTRY_OK.replace('"prefetch", (0, 2, 4)', '"undeclared", (0, 2, 4)'),
     ("no such default", "no TUNED_KNOBS row")),
    (REGISTRY_OK.replace('("tfidf_chunk_ingest_carry",)),', '("no_such_entry",)),'),
     ("ENTRY_POINTS does not define",)),
])
def test_profile_drift_contract_tp(tmp_path, registry_src, wanted):
    """The declaration itself drifts: a searchable knob with no default, a
    default with no search space, an affected entry that does not exist."""
    port, ref = both(tmp_path, registry_src, CONFIG_OK)
    msgs = [f.message for f in same_findings(port, ref)]
    for w in wanted:
        assert any(w in m for m in msgs), (w, msgs)


def test_profile_drift_suppressed(tmp_path):
    port, ref = both(
        tmp_path,
        REGISTRY_OK.replace("TUNED_KNOBS = (", "TUNED_KNOBS = (  # graftlint: disable=profile-drift "
                            "(migration window: default lands next PR)")
        .replace('"prefetch", (0, 2, 4)', '"undeclared", (0, 2, 4)'),
        CONFIG_OK.replace('{"prefetch": 2}', "{}"))
    assert [f for f in same_findings(port, ref) if f.rule == "profile-drift"] == []


THING = """
    import dataclasses


    def run(corpus, prefetch=2):
        return corpus


    @dataclasses.dataclass
    class Cfg:
        prefetch: int = 2


    def caller(corpus):
        return run(corpus, prefetch=2)
"""


def test_untuned_knob_read_tp(tmp_path):
    """A bare-literal signature default, a dataclass-field default, and a
    call-site keyword duplicating the TUNABLE_DEFAULTS value — each a site
    the resolution ladder cannot reach."""
    port, ref = both(tmp_path, REGISTRY_OK, CONFIG_OK, {"models/thing.py": THING})
    hits = [f for f in same_findings(port, ref) if f.rule == "untuned-knob-read"]
    assert len(hits) == 3 and all(f.path == f"{PKG}/models/thing.py" for f in hits)


@pytest.mark.parametrize("scan_files", [
    {"models/clean.py": """
        from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
            TUNABLE_DEFAULTS,
        )


        def run(corpus, prefetch=None):
            if prefetch is None:
                prefetch = TUNABLE_DEFAULTS["prefetch"]
            return corpus


        def caller(corpus):
            return run(corpus, prefetch=4)
    """},
    # the same literal outside the scanned runtime dirs
    {"utils/helper.py": "def f(prefetch=2): pass\n"},
    {"models/thing.py": """
        def run(corpus, prefetch=2):  # graftlint: disable=untuned-knob-read (CLI compat shim, removed next PR)
            return corpus
    """},
], ids=["reads-the-table", "outside-the-scan", "suppressed"])
def test_untuned_knob_read_tn(tmp_path, scan_files):
    """Reading the table, None defaults, a deliberate non-default literal,
    a literal outside models//parallel//serving//dataflow/, and a
    suppressed site all stay quiet."""
    port, ref = both(tmp_path, REGISTRY_OK, CONFIG_OK, scan_files)
    assert [f for f in same_findings(port, ref) if f.rule == "untuned-knob-read"] == []


def test_copy_is_the_references():
    """profile.py is the reference's, line for line, apart from its
    docstring, the package name and reading the profiles beside the
    port's package."""
    def code(path: Path, pkg: str) -> list:
        text = path.read_text(encoding="utf-8")
        body = text[text.index("from __future__"):].replace(pkg, "PKG")
        return [line for line in body.splitlines()
                if "tuned_profile_" not in line and "glob(" not in line
                and "ProfileArtifact(relpath=" not in line]

    assert code(REPO / PKG / "analysis" / "profile.py", PKG) == \
        code(REPO / REF_PKG / "analysis" / "profile.py", REF_PKG)


def test_profiles_are_read_beside_the_port():
    """The port reads its own committed profiles, never the repository
    root's (the JAX package's)."""
    found = profile.discover_profiles(REPO)
    assert [p.relpath for p in found] == [f"{PKG}/tuned_profile_gpu.json"]
    assert all(p.backend == "gpu" and p.record["backend"] == "gpu" for p in found)


# ----------------------------------------------------- whole-repo gates


def test_whole_repo_profile_clean():
    """No tier-3 profile finding beyond the (empty) baseline over the real
    surface: the committed contract, the committed gpu profile, and every
    knob read in models//parallel//serving//dataflow/."""
    res = profile.run_profile(root=REPO)
    baseline = load_baseline(baseline_path(REPO))
    new = [f for f in res.findings if f.fingerprint not in baseline]
    assert not new, "\n".join(f.render() for f in new)
    assert set(res.report["knobs"]) == set(TUNABLE_DEFAULTS)
    assert "gpu" in res.report["profiles"]


def test_committed_gpu_profile_is_live():
    """The committed profile loads through the real ladder, carries its
    sweep's evidence (the card's machine has no git checkout, so no sha)
    and tunes every declared knob to an in-domain (or default) value."""
    prof = load_tuned_profile(backend="gpu")
    assert prof is not None and prof.source == "committed"
    assert prof.measured["prune"]["prune_frac"] >= 0.30
    domains = {name: tuple(domain) for name, domain, _ in TUNED_KNOBS}
    assert set(prof.knobs) == set(domains)
    for name, value in prof.knobs.items():
        assert value in domains[name] or value == TUNABLE_DEFAULTS[name]


def test_cli_profile_report():
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.analysis", "--tier", "3",
                           f"{PKG}/dataflow/bm25.py", "--profile-report", "--json"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)["profile_report"]
    assert set(report["knobs"]) == set(TUNABLE_DEFAULTS)
    row = report["knobs"]["shuffle_bucket_width"]
    assert row["default"] == TUNABLE_DEFAULTS["shuffle_bucket_width"]
    assert row["tuned"]["gpu"] in row["domain"]
    assert report["profiles"]["gpu"]["path"] == f"{PKG}/tuned_profile_gpu.json"
