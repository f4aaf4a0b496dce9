"""Checkpoints and resume of the port's streaming TF-IDF, on the CPU.

``utils/checkpoint.py`` and ``serving/artifact.py`` are copies of the JAX
package's: their code (docstrings and comments aside) must stay the
reference's.  A run killed mid-stream and resumed gives the bits of an
unbroken run; a checkpoint written by either package resumes in the
other (same ``config_hash``, ``.npz`` layout and ``LATEST`` pointer); a
resume over a differently chunked corpus raises.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import pytest

from page_rank_and_tfidf_using_apache_spark_tpu.models import tfidf as jm
from page_rank_and_tfidf_using_apache_spark_tpu.utils import checkpoint as jckpt
from page_rank_and_tfidf_using_apache_spark_tpu.utils import config as jcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import tfidf as tcli
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder
from tests.test_torch_obs import PORT, REF, _code
from tests.test_torch_streaming import chunks_of, flat

BASE = dict(vocab_bits=10, idf_mode="smooth", l2_normalize=True)


@pytest.mark.parametrize("module", ["utils/checkpoint.py", "serving/artifact.py"])
def test_copy_matches_reference(module):
    assert _code(PORT / module) == _code(REF / module)


class Killed(RuntimeError):
    pass


def killed_after(chunks, n: int):
    """The chunks, with the source failing when asked for chunk ``n``."""
    yield from chunks[:n]
    raise Killed(f"killed after chunk {n}")


def events(m: MetricsRecorder, name: str) -> list[dict]:
    return [r for r in m.records if r.get("event") == name]


@pytest.mark.parametrize("prefetch, depth", [(0, 0), (2, 2)])
def test_kill_and_resume_gives_equal_bits(prefetch, depth, tmp_path):
    """Checkpoints every 4 chunks, a source that dies after chunk 10: the
    resumed run starts at the last checkpoint and equals an unbroken run
    bit for bit (the carry and the sums are deterministic).  A checkpoint
    drains what is in flight first, so with chunks in flight it lands past
    the 4th chunk."""
    chunks = chunks_of(14)
    cfg = tcfg.TfidfConfig(**BASE, prefetch=prefetch, pipeline_depth=depth,
                           checkpoint_every=4, checkpoint_dir=str(tmp_path / "ck"))
    full = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**BASE), device="cpu")
    m1 = MetricsRecorder()
    with pytest.raises(Killed):
        tm.run_tfidf_streaming(killed_after(chunks, 10), cfg, metrics=m1, device="cpu")
    saved = [r["chunk"] for r in events(m1, "checkpoint")]
    assert saved == ([4, 8] if prefetch == 0 else [6])
    assert tm.resume_point(cfg) == saved[-1]
    m2 = MetricsRecorder()
    res = tm.run_tfidf_streaming(iter(chunks), cfg, metrics=m2, resume=True, device="cpu")
    assert events(m2, "resume")[0]["chunk"] == saved[-1]
    assert [r["chunk"] for r in events(m2, "chunk")] == list(range(saved[-1], 14))
    assert res.n_docs == full.n_docs
    for f in ("doc", "term", "count", "weight", "df", "idf", "doc_lengths"):
        assert getattr(res, f).tobytes() == getattr(full, f).tobytes(), f


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(writer, tmp_path):
    """A checkpoint written by one package resumes in the other: DF and the
    counts exact, the weights within 1e-6 of the reader's unbroken run."""
    chunks = chunks_of(9)
    kw = dict(**BASE, checkpoint_every=2, checkpoint_dir=str(tmp_path / "ck"))
    assert tcfg.TfidfConfig(**kw).config_hash() == jcfg.TfidfConfig(**kw).config_hash()
    if writer == "jax":
        jm.run_tfidf_streaming(iter(chunks[:5]), jcfg.TfidfConfig(**kw))
        res = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**kw), resume=True,
                                     device="cpu")
        full = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**BASE), device="cpu")
        assert res.to_dense().tobytes() == full.to_dense().tobytes()
    else:
        tm.run_tfidf_streaming(iter(chunks[:5]), tcfg.TfidfConfig(**kw), device="cpu")
        res = jm.run_tfidf_streaming(iter(chunks), jcfg.TfidfConfig(**kw), resume=True)
        full = jm.run_tfidf_streaming(iter(chunks), jcfg.TfidfConfig(**BASE))
        np.testing.assert_allclose(res.to_dense(), full.to_dense(), atol=1e-6)
    for f in ("doc", "term", "count", "df"):
        assert np.asarray(getattr(res, f)).tobytes() == np.asarray(getattr(full, f)).tobytes()
    assert res.n_docs == full.n_docs == 27


def test_checkpoint_files_match_reference(tmp_path):
    """The same stream checkpointed by both packages: the same snapshot
    steps, the same arrays, the same metadata but the wall time."""
    chunks = chunks_of(7)
    dirs = {}
    for name, cfg_mod, run, kw in (("port", tcfg, tm.run_tfidf_streaming, {"device": "cpu"}),
                                   ("jax", jcfg, jm.run_tfidf_streaming, {})):
        dirs[name] = str(tmp_path / name)
        run(iter(chunks), cfg_mod.TfidfConfig(**BASE, checkpoint_every=3,
                                              checkpoint_dir=dirs[name]), **kw)
    names = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
    assert names["port"] == names["jax"] and len(names["port"]) >= 2  # LATEST + snapshots
    p = ckpt.load_checkpoint(ckpt.latest_checkpoint(dirs["port"]))
    j = jckpt.load_checkpoint(jckpt.latest_checkpoint(dirs["jax"]))
    assert p[0] == j[0]
    assert p[1].keys() == j[1].keys()
    for k in p[1]:
        assert p[1][k].dtype == j[1][k].dtype and p[1][k].tobytes() == j[1][k].tobytes(), k
    assert {k: v for k, v in p[2].items() if k != "ingest_secs"} == \
        {k: v for k, v in j[2].items() if k != "ingest_secs"}


def test_resume_refuses_another_configuration(tmp_path):
    ckdir = str(tmp_path / "ck")
    tm.run_tfidf_streaming(iter(chunks_of(4)), tcfg.TfidfConfig(
        **BASE, checkpoint_every=2, checkpoint_dir=ckdir), device="cpu")
    other = tcfg.TfidfConfig(vocab_bits=10, idf_mode="classic", checkpoint_every=2,
                             checkpoint_dir=ckdir)
    with pytest.raises(ValueError, match="refusing to resume"):
        tm.run_tfidf_streaming(iter(chunks_of(4)), other, resume=True, device="cpu")
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        tm.run_tfidf_streaming(iter(chunks_of(4)), tcfg.TfidfConfig(**BASE), resume=True,
                               device="cpu")


def test_resume_without_a_checkpoint_starts_from_scratch(tmp_path):
    cfg = tcfg.TfidfConfig(**BASE, checkpoint_every=2, checkpoint_dir=str(tmp_path / "none"))
    assert tm.resume_point(cfg) == 0 and tm.resume_point(tcfg.TfidfConfig()) == 0
    out = tm.run_tfidf_streaming(iter(chunks_of(3)), cfg, resume=True, device="cpu")
    full = tm.run_tfidf(flat(chunks_of(3)), tcfg.TfidfConfig(**BASE), device="cpu")
    assert out.to_dense().tobytes() == full.to_dense().tobytes()


def test_rechunked_resume_raises(tmp_path):
    """Resume bookkeeping counts chunks, so a resume over the same corpus in
    other chunks would skip the wrong documents: it raises."""
    docs = flat(chunks_of(6))
    ckdir = str(tmp_path / "ck")
    cfg = tcfg.TfidfConfig(**BASE, prefetch=0, checkpoint_every=2, checkpoint_dir=ckdir)
    tm.run_tfidf_streaming(iter([docs[i:i + 3] for i in range(0, 9, 3)]), cfg, device="cpu")
    assert tm.resume_point(cfg) == 2
    with pytest.raises(ValueError, match="resume chunking mismatch"):
        tm.run_tfidf_streaming(iter([docs[i:i + 4] for i in range(0, 18, 4)]), cfg,
                               resume=True, device="cpu")


def write_lines(path: pathlib.Path, docs) -> str:
    path.write_text("".join(d + "\n" for d in docs))
    return str(path)


def test_cli_resume_skips_the_prefix_and_refuses_new_chunk_docs(tmp_path):
    """The CLI's resume probe: a run over the first 12 lines leaves a
    checkpoint; --resume over all 30 lines with another --chunk-docs
    raises, and with the same one gives the unbroken run's output."""
    docs = tt.synthetic_corpus_lines(30, 8, 5)
    head = write_lines(tmp_path / "head.txt", docs[:12])
    full = write_lines(tmp_path / "full.txt", docs)
    common = ["--lines", "--streaming", "--vocab-bits", "10", "--device", "cpu",
              "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2"]
    assert tcli.main([head, *common, "--chunk-docs", "3"]) == 0
    with pytest.raises(ValueError, match="resume chunking mismatch"):
        tcli.main([full, *common, "--chunk-docs", "5", "--resume"])
    assert tcli.main([full, *common, "--chunk-docs", "3", "--resume",
                      "--output", str(tmp_path / "resumed.tsv")]) == 0
    assert tcli.main([full, "--lines", "--streaming", "--vocab-bits", "10", "--device", "cpu",
                      "--chunk-docs", "3", "--output", str(tmp_path / "unbroken.tsv")]) == 0
    assert (tmp_path / "resumed.tsv").read_text() == (tmp_path / "unbroken.tsv").read_text()
