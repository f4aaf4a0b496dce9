"""The port's streaming rehearsal (``..._torch/tools/streaming_rehearsal.py``)
against the reference's (``tools/streaming_rehearsal.py``), both run as
processes on the CPU at 20,000 documents in chunks of 1,024 with a
checkpoint every 8 chunks: the reference's keys (plus the card stamp),
equal document, token, nonzero, checkpoint and 1/8-scale token counts and
the finalize record's nonzero count; the copied corpus generator yields the
reference's chunks.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf_streaming
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import streaming_rehearsal as sr
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import TfidfConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--docs", "20000", "--docs-per-chunk", "1024", "--checkpoint-every", "8"]
STAMP = {"device", "power_limit"}


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_streaming_rehearsal", ROOT / "tools" / "streaming_rehearsal.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(cmd: list, env: dict) -> dict:
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, **env})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def records():
    port = _last_json([sys.executable, "-m", sr.__name__, *ARGS, "--device", "cpu"], {})
    ref = _last_json([sys.executable, "tools/streaming_rehearsal.py", *ARGS],
                     {"JAX_PLATFORMS": "cpu"})
    return port, ref


def test_record_has_the_references_keys_and_the_stamp(records):
    port, ref = records
    assert set(port) == set(ref) | STAMP
    assert (port["backend"], port["device"], port["power_limit"]) == ("cpu", "cpu", None)


@pytest.mark.parametrize("key", ["n_docs", "n_tokens", "nnz", "checkpoints_written",
                                 "small_scale_tokens"])
def test_counts_equal_the_references(records, key):
    port, ref = records
    assert port[key] == ref[key]


def test_finalize_record_matches_the_references(records):
    port, ref = records
    assert port["finalize"]["event"] == ref["finalize"]["event"] == "finalize"
    assert port["finalize"]["nnz"] == ref["finalize"]["nnz"] == port["nnz"]


def test_run_checkpoints_and_counts_every_token(records):
    """The run wrote checkpoints (2 over 20 chunks), and its tokens are the
    generator's corpus counted on the host."""
    port, _ = records
    assert port["n_docs"] == 20000 and port["checkpoints_written"] == 2
    assert port["n_tokens"] == sr.corpus_tokens(20000, 1024, 12, 11, 2)


def test_synth_chunks_is_the_references():
    ref = _reference_tool()
    assert sr.VOCAB_WORDS == ref.VOCAB_WORDS
    got = list(sr.synth_chunks(5000, 1024, 12, 11))
    assert got == list(ref.synth_chunks(5000, 1024, 12, 11))
    assert [len(c) for c in got] == [1024] * 4 + [904]


def test_differing_arrays_names_what_differs():
    chunks = list(sr.synth_chunks(300, 100, 12, 3))
    cfg = TfidfConfig(vocab_bits=12, ngram=2, idf_mode="smooth", l2_normalize=True)
    a = run_tfidf_streaming(iter(chunks), cfg, device="cpu")
    b = run_tfidf_streaming(iter(chunks), cfg, device="cpu")
    assert sr.differing_arrays(a, b) == []
    b.weight[0] = b.weight[0] * 2
    assert sr.differing_arrays(a, b) == ["weight"]


def test_refuses_the_reference_record(capsys):
    """The root ``rehearsal_metrics.json`` is the JAX package's; the tool
    refuses it before running anything and leaves it as it was."""
    path = ROOT / "rehearsal_metrics.json"
    before = path.read_bytes()
    assert sr.main(["--docs", "16", "--device", "cpu", "--out", str(path)]) == 3
    assert "REFUSED" in capsys.readouterr().err
    assert path.read_bytes() == before
