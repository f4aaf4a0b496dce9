"""PageRank and TF-IDF configuration: frozen dataclasses mirroring the CLI
flags.

Counterpart of the JAX package's ``utils/config.py`` (``PageRankConfig``,
``DanglingMode``, ``RankInit``, ``IngestConfig``, ``TfidfConfig``,
``IdfMode``, ``TfMode``, ``HitsConfig``, ``ComponentsConfig``,
``Bm25Config``, the keys of ``TUNABLE_DEFAULTS``
they read, ``config_hash`` and ``config_to_json``, and the tuned-profile
API: ``TunedProfileError``, ``TunedProfile``, ``default_backend``,
``profile_path``, ``load_tuned_profile``, ``write_tuned_profile`` and
``tuned_config``), copied so the port never imports that package.  Field names, defaults, validation and hashes
are held equal to the JAX package by ``tests/test_torch_graph.py``
(PageRank), ``tests/test_torch_tfidf.py`` (TF-IDF),
``tests/test_torch_ingest.py`` / ``tests/test_torch_artifact.py``
(ingest, BM25) and ``tests/test_torch_fixpoint.py`` (the hashes of
``PageRankConfig``, ``HitsConfig`` and ``ComponentsConfig``, which a
checkpoint carries), the tuned-profile API by
``tests/test_torch_tuned_profile.py``.  The JAX package's
``ensure_dtype_support`` has no counterpart: PyTorch takes float64 as it
is.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import os
import pathlib
import tempfile
import time
from typing import Any

# The performance knobs the configs read and their hand-picked defaults.  A
# knob resolves as explicit value, then the tuned profile of the backend the
# run computes on (load_tuned_profile below), then this table.
TUNABLE_DEFAULTS: dict = {
    # hybrid SpMV dense-head layout (ops/pagerank.py, PageRankConfig)
    "head_coverage": 0.5,
    "head_row_width": 128,
    # sort_shuffle bucket padding (ops/pagerank.py build_shuffle_layout)
    "shuffle_bucket_width": 8,
    # strategy="owned" replicated hub-head cap (parallel/pagerank_sharded.py)
    "owned_max_head": 4096,
    # staged streaming-ingest depths and chunk re-packing target
    # (IngestConfig, TfidfConfig)
    "prefetch": 2,
    "pipeline_depth": 2,
    "pack_target_tokens": 0,
    # serving batch cap (serving/server.py ServeConfig)
    "max_batch": 8,
    # impacted-list scoring bucket layout (serving/server.py)
    "impact_bucket_width": 8,
    "impact_warm_buckets": 8192,  # 1 << 13
}

# The GRAFT_* environment knobs the port's entry points read; a traced
# run's manifest records each one's value (obs/manifest.py).  The same names
# as the JAX package's knobs of the same use.
GRAFT_ENV_KNOBS: frozenset = frozenset({
    "GRAFT_LOG_LEVEL",  # stderr log level (utils/metrics.py; default INFO)
    "GRAFT_TRACE_DIR",  # obs/ run-telemetry output dir: traced runs write
    # <name>.<pid>.trace.jsonl + .manifest.json here (unset = no trace)
    "GRAFT_TRACE_PARENT",  # cross-process trace id (obs/runtime.py): every
    # child run adopts it in its run_start event + manifest
    "GRAFT_METRICS_PORT",  # live-metrics HTTP endpoint (obs/export.py):
    # unset = no exporter, 0 = ephemeral port, else the literal port;
    # serves /snapshot.json (rolling-window SLO snapshot) + /metrics
    # (Prometheus text) from a running cli.serve
    "GRAFT_CHAOS",  # fault-injection plan (resilience/chaos.py)
    "GRAFT_ELASTIC",  # the CPU salvage on a lost device
    # (resilience/elastic.py; "0" disables it)
    "GRAFT_RETRY_MAX",  # max retries per guarded call
    "GRAFT_SYNC_DEADLINE_S",  # watchdog deadline for host syncs
    "GRAFT_STEP_DEADLINE_S",  # watchdog deadline for segment dispatch
    "GRAFT_BACKOFF_BASE_S",  # first backoff delay
    "GRAFT_BACKOFF_MAX_S",  # backoff ceiling
    "GRAFT_TUNE_BUDGET_S",  # tools/autotune.py wall-clock budget for
    # the measured sweep over cost-model survivors (default 60s — the
    # pruned grid must fit)
    "GRAFT_TUNED_PROFILE",  # path to a tuned_profile_<backend>.json the
    # knob resolution ladder loads instead of the committed per-backend
    # default ("off" or empty disables profile loading
    # entirely: every knob falls back to TUNABLE_DEFAULTS)
})

# The degradation rungs of the resilience executor (resilience/executor.py
# run_guarded's ``fallbacks``), declared in one place: a ``degraded`` event
# names one of these.  The JAX package's ladder, copied.  The port runs
# ``cpu`` as the salvage (the single-device paths hand the run of a lost
# device that names its index to the CPU, from the newest commit point;
# the reference's per-segment rung is not ported) and as the end of the
# mesh shrink; mesh_shrink and single_device are the sharded runners'
# (parallel/); respawn waits for the fleet's process supervisor (ROADMAP
# Queue 1 item 13).
DEGRADE_LADDER: tuple = (
    "mesh_shrink",  # rebuild the mesh over surviving devices (pow2 shrink)
    "single_device",  # the 1-device end of the shrink chain
    "cpu",  # re-lower on the CPU backend (single-chip paths)
    "respawn",  # replace a dead replica PROCESS (resilience/process.py):
    # past every in-process rung — recovery belongs to the supervisor
)

SPMV_IMPLS = ("segment", "bcoo", "cumsum", "cumsum_mxu", "hybrid",
              "sort_shuffle", "pallas")


class DanglingMode(str, enum.Enum):
    """What happens to rank mass at nodes with no out-links.

    ``DROP`` is the canonical Spark example (dangling nodes never appear
    as a ``links`` key, so their mass vanishes each iteration);
    ``REDISTRIBUTE`` is the textbook/networkx behaviour: dangling mass is
    spread over the restart distribution, keeping ``sum(ranks)`` constant.
    """

    DROP = "drop"
    REDISTRIBUTE = "redistribute"


class RankInit(str, enum.Enum):
    """Initial rank value. The canonical Spark example uses 1.0 per node
    (so ranks sum to N); ``UNIFORM`` is 1/N (ranks sum to 1)."""

    ONE = "one"
    UNIFORM = "uniform"


@dataclasses.dataclass(frozen=True)
class PageRankConfig:
    """Configuration for a PageRank run.

    Mirrors the reference CLI shape ``pagerank <edges> <iters>`` plus
    explicit flags for every reconstructed-semantics choice.
    """

    iterations: int = 20
    damping: float = 0.85
    # Convergence: if tol > 0, stop early when the L1 delta between
    # successive rank vectors falls below tol (one host sync per step).
    tol: float = 0.0
    dangling: DanglingMode = DanglingMode.DROP
    init: RankInit = RankInit.ONE
    # Exact emulation of the canonical Spark example's shrinking key-set
    # semantics (nodes absent from the join drop out).  Only meaningful
    # with dangling=DROP, init=ONE.
    spark_exact: bool = False
    # Personalized PageRank: restart concentrated on these node ids instead
    # of uniform. None => standard PageRank.
    personalize: tuple[int, ...] | None = None
    # Sparse matvec implementation, one of SPMV_IMPLS; "pallas" runs the
    # hand-written prefix-sum kernel and "hybrid" the row-sum kernel.
    spmv_impl: str = "segment"
    # spmv_impl="hybrid" layout knobs: the head is the smallest top-k
    # in-degree set covering ~head_coverage of all edges (every member's
    # in-degree >= the dense row width, which adapts down from
    # head_row_width on small graphs).
    head_coverage: float = TUNABLE_DEFAULTS["head_coverage"]
    head_row_width: int = TUNABLE_DEFAULTS["head_row_width"]
    # spmv_impl="sort_shuffle": bucket width each destination's edge run is
    # padded to.
    shuffle_bucket_width: int = TUNABLE_DEFAULTS["shuffle_bucket_width"]
    # Sharded strategy="owned" head cap; kept so configs (and their
    # hashes) round-trip with the JAX package.
    owned_max_head: int = TUNABLE_DEFAULTS["owned_max_head"]
    dtype: str = "float32"
    # Checkpoint every k iterations (0 = off) into checkpoint_dir.
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None

    def __post_init__(self) -> None:
        if self.iterations < 0:
            raise ValueError(f"iterations must be >= 0, got {self.iterations}")
        if not 0.0 <= self.damping <= 1.0:
            raise ValueError(f"damping must be in [0, 1], got {self.damping}")
        # Accept plain strings for enum fields (CLI / JSON round-trips) —
        # coerce BEFORE any enum-identity validation below.
        object.__setattr__(self, "dangling", DanglingMode(self.dangling))
        object.__setattr__(self, "init", RankInit(self.init))
        if self.spark_exact and self.dangling is not DanglingMode.DROP:
            raise ValueError("spark_exact requires dangling=drop")
        if self.spark_exact and self.personalize is not None:
            raise ValueError("spark_exact cannot be personalized")
        if self.spmv_impl not in SPMV_IMPLS:
            raise ValueError(f"unknown spmv_impl {self.spmv_impl!r}")
        if not 0.0 < self.head_coverage <= 1.0:
            raise ValueError(
                f"head_coverage must be in (0, 1], got {self.head_coverage}"
            )
        if self.head_row_width < 8 or self.shuffle_bucket_width < 2:
            raise ValueError(
                "head_row_width must be >= 8 and shuffle_bucket_width >= 2, "
                f"got {self.head_row_width}/{self.shuffle_bucket_width}"
            )
        if self.owned_max_head < 0:
            raise ValueError(
                f"owned_max_head must be >= 0, got {self.owned_max_head}"
            )
        if self.spark_exact and self.spmv_impl not in ("segment", "bcoo"):
            # spark_exact's presence test counts unit contributions through
            # the SpMV; a float32 prefix sum stops resolving +1.0 past 2^24
            # accumulated mass, silently zeroing live nodes at large-graph
            # scale.  spark_exact is a parity mode — keep it on exact impls.
            raise ValueError("spark_exact requires spmv_impl='segment' or 'bcoo'")
        if self.personalize is not None:
            object.__setattr__(self, "personalize", tuple(int(x) for x in self.personalize))

    def config_hash(self) -> str:
        """Hash of the *semantic* fields only: run length, tolerance, and
        checkpoint placement are operational."""
        return _hash_config(self, exclude={"iterations", "tol", "checkpoint_every", "checkpoint_dir"})


class IdfMode(str, enum.Enum):
    """IDF formula variant.

    - CLASSIC: ``log(N / df)`` — the textbook formula most course projects use.
    - MLLIB:   ``log((N + 1) / (df + 1))`` — Spark MLlib's smoothing.
    - SMOOTH:  ``log((1 + N) / (1 + df)) + 1`` — sklearn's ``smooth_idf``.
    """

    CLASSIC = "classic"
    MLLIB = "mllib"
    SMOOTH = "smooth"


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Knobs of the staged ingest pipeline (``dataflow.ingest.chunked_ingest``):
    tokenize, H2D staging and compute run as overlapped stages, and these
    two depths bound how far each stage may run ahead.

    - ``prefetch``: tokenized chunks the tokenizer thread may buffer ahead
      of the H2D stage, and launched chunks in flight before the host
      drains the oldest.  0 = no tokenizer thread, every chunk drains
      before the next launches.
    - ``pipeline_depth``: H2D-staged chunks (copies issued on the copy
      stream, compute not yet launched) the transfer thread may hold.  0 =
      staging runs inline on the calling thread.

    Results are bit-identical at every depth; only scheduling changes.
    """

    prefetch: int = TUNABLE_DEFAULTS["prefetch"]
    pipeline_depth: int = TUNABLE_DEFAULTS["pipeline_depth"]

    def __post_init__(self) -> None:
        if self.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {self.prefetch}")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {self.pipeline_depth}"
            )


class TfMode(str, enum.Enum):
    """TF variant: RAW counts (Spark canonical), FREQ = count/doc_len,
    LOGNORM = 1 + log(count)."""

    RAW = "raw"
    FREQ = "freq"
    LOGNORM = "lognorm"


@dataclasses.dataclass(frozen=True)
class TfidfConfig:
    """Configuration for a TF-IDF run over a corpus.

    ``vocab_bits`` fixes the hashed vocabulary to ``2**vocab_bits`` ids
    (2^18 for the 20-Newsgroups configuration).  The batch and streaming
    pipelines run in float32 whatever ``dtype`` says; the batch one does in
    the JAX package too.
    """

    vocab_bits: int = 18
    ngram: int = 1  # 1 = unigram, 2 = uni+bigram
    tf_mode: TfMode = TfMode.RAW
    idf_mode: IdfMode = IdfMode.CLASSIC
    l2_normalize: bool = False
    lowercase: bool = True
    min_token_len: int = 1
    # Streaming ingest: chunks are padded to this many tokens; 0 = the
    # first chunk's size rounded up to a power of two.
    chunk_tokens: int = 0
    # Staged ingest pipeline (IngestConfig above): tokenized chunks the
    # tokenizer thread may run ahead and launches in flight (prefetch), and
    # H2D-staged chunks held on the device (pipeline_depth).
    prefetch: int = TUNABLE_DEFAULTS["prefetch"]
    pipeline_depth: int = TUNABLE_DEFAULTS["pipeline_depth"]
    # Re-pack incoming document chunks to ~this many tokens each; 0 = take
    # the caller's chunking as-is.  Checkpoint chunk indices count packed
    # chunks, so a resume re-packs with the same target.
    pack_target_tokens: int = TUNABLE_DEFAULTS["pack_target_tokens"]
    checkpoint_every: int = 0  # chunks between checkpoints (0 = off)
    checkpoint_dir: str | None = None
    dtype: str = "float32"

    def __post_init__(self) -> None:
        if not 1 <= self.vocab_bits <= 30:
            raise ValueError(f"vocab_bits must be in [1, 30], got {self.vocab_bits}")
        if self.ngram not in (1, 2):
            raise ValueError(f"ngram must be 1 or 2, got {self.ngram}")
        if self.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {self.prefetch}")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {self.pipeline_depth}"
            )
        if self.pack_target_tokens < 0:
            raise ValueError(
                f"pack_target_tokens must be >= 0, got {self.pack_target_tokens}"
            )
        object.__setattr__(self, "tf_mode", TfMode(self.tf_mode))
        object.__setattr__(self, "idf_mode", IdfMode(self.idf_mode))

    @property
    def vocab_size(self) -> int:
        return 1 << self.vocab_bits

    def ingest(self) -> IngestConfig:
        """The staged-pipeline knobs as the dataflow core's IngestConfig."""
        return IngestConfig(prefetch=self.prefetch,
                            pipeline_depth=self.pipeline_depth)

    def config_hash(self) -> str:
        """Semantic fields only (chunking/checkpoint placement excluded —
        the accumulated DF/TF state is chunk-boundary-independent)."""
        return _hash_config(
            self,
            exclude={"chunk_tokens", "prefetch", "pipeline_depth",
                     "pack_target_tokens", "checkpoint_every",
                     "checkpoint_dir"},
        )


@dataclasses.dataclass(frozen=True)
class HitsConfig:
    """Configuration for a HITS (hubs/authorities) run
    (``dataflow/hits.py``).  Field names mirror PageRankConfig so the shared
    segment driver (``dataflow.fixpoint.run_segments``) drives it unchanged;
    the iteration follows networkx.hits (max-normalization each step, L1
    convergence on the hub vector, sum-normalization at the end)."""

    iterations: int = 100
    tol: float = 1e-8
    dtype: str = "float32"
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None

    def __post_init__(self) -> None:
        if self.iterations < 0:
            raise ValueError(f"iterations must be >= 0, got {self.iterations}")
        if self.tol < 0:
            raise ValueError(f"tol must be >= 0, got {self.tol}")

    def config_hash(self) -> str:
        return _hash_config(
            self, exclude={"iterations", "tol", "checkpoint_every", "checkpoint_dir"}
        )


@dataclasses.dataclass(frozen=True)
class ComponentsConfig:
    """Configuration for connected components by min-label propagation
    (``dataflow/components.py``).  ``iterations`` caps the rounds (at least
    the undirected diameter for an exact answer; the run stops the round
    nothing changes)."""

    iterations: int = 200
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None
    # The delta is the COUNT of labels that changed, so any tol in (0, 1)
    # means "stop when nothing changed".  A field, so dataclasses.replace in
    # the segment driver keeps it.
    tol: float = 0.5

    def __post_init__(self) -> None:
        if self.iterations < 0:
            raise ValueError(f"iterations must be >= 0, got {self.iterations}")

    def config_hash(self) -> str:
        return _hash_config(
            self, exclude={"iterations", "tol", "checkpoint_every", "checkpoint_dir"}
        )


@dataclasses.dataclass(frozen=True)
class Bm25Config:
    """Okapi BM25 weighting knobs (``dataflow/bm25.py``): the second ranker
    over the same postings COO the TF-IDF pipeline builds, with the Lucene
    idf ``log(1 + (N - df + 0.5)/(df + 0.5))``, which keeps weights
    non-negative."""

    k1: float = 1.5
    b: float = 0.75

    def __post_init__(self) -> None:
        if self.k1 < 0:
            raise ValueError(f"k1 must be >= 0, got {self.k1}")
        if not 0.0 <= self.b <= 1.0:
            raise ValueError(f"b must be in [0, 1], got {self.b}")

    def config_hash(self) -> str:
        return _hash_config(self)


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj


def config_to_json(cfg: Any) -> str:
    return json.dumps(_to_jsonable(cfg), sort_keys=True)


def _hash_config(cfg: Any, exclude: set[str] = frozenset()) -> str:
    """Stable short hash tagging metrics as belonging to one semantic
    configuration; equal to the JAX package's for equal configs."""
    d = {k: v for k, v in _to_jsonable(cfg).items() if k not in exclude}
    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]


# --------------------------------------------------------------------------
# Tuned-profile artifact: the committed per-backend knob optimum
# tools/autotune.py measures.  Spark counterpart: a tuned ``spark.conf``
# shipped alongside the job — platform-specific values for the same named
# knobs the code reads through one resolution ladder.
# --------------------------------------------------------------------------

# The port's committed profiles live in its package directory.
_PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]


class TunedProfileError(ValueError):
    """A tuned-profile artifact failed structural validation."""


@dataclasses.dataclass(frozen=True)
class TunedProfile:
    """One backend's measured knob optimum, as loaded from a
    ``tuned_profile_<backend>.json`` artifact.

    ``knobs`` maps TUNABLE_DEFAULTS names to the measured-best values;
    ``measured`` carries the sweep evidence (per-group times, the card's
    name and power limit) for forensics.  ``source`` records which rung of
    the resolution ladder produced this profile ("explicit" path argument,
    "env" GRAFT_TUNED_PROFILE, or the "committed" per-backend default) —
    run manifests persist it so a run's numbers are attributable."""

    backend: str
    knobs: dict
    path: str | None = None
    git_sha: str | None = None
    created_wall: float | None = None
    measured: dict | None = None
    source: str = "explicit"

    def knob(self, name: str, default: Any = None) -> Any:
        return self.knobs.get(name, default)


def default_backend() -> str:
    """The backend stamp of a process that has resolved no device:
    ``"gpu"`` where CUDA is available, else ``"cpu"``.  An entry point that
    resolved its device passes that device's backend
    (``utils.device.backend_name``) instead, so a ``--device cpu`` run on a
    machine with a card resolves the CPU's profile."""
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def profile_path(backend: str, root: str | pathlib.Path | None = None) -> str:
    """Committed location of ``backend``'s tuned profile artifact:
    ``tuned_profile_<backend>.json`` in the port's package directory (or in
    ``root``).  The JAX package keeps its profiles at the repository root,
    where its ``profile-drift`` lint reads every ``tuned_profile_*.json``
    as its own, so neither package loads (or audits) the other's."""
    base = pathlib.Path(root) if root is not None else _PACKAGE_DIR
    return str(base / f"tuned_profile_{backend}.json")


def load_tuned_profile(
    backend: str | None = None,
    path: str | pathlib.Path | None = None,
    *,
    root: str | pathlib.Path | None = None,
) -> TunedProfile | None:
    """Resolve and load the tuned profile for ``backend``.

    Resolution ladder (highest wins):

    1. an explicit ``path`` argument (CLI ``--tuned-profile``);
    2. the ``GRAFT_TUNED_PROFILE`` env knob — ``"off"``/empty disables
       profile loading entirely (returns None: every knob falls back to
       ``TUNABLE_DEFAULTS``);
    3. the committed ``tuned_profile_<backend>.json`` in the port's
       package directory (None when absent — a missing committed profile is not an
       error).

    A profile stamped for a DIFFERENT backend raises ``ProvenanceError``
    (same guard class as the measured cost artifacts): a CPU-tuned
    optimum must never silently steer a GPU run, nor vice versa.
    """
    from .artifacts import ProvenanceError

    if backend is None:
        backend = default_backend()
    source = "explicit"
    if path is None:
        env = os.environ.get("GRAFT_TUNED_PROFILE")
        if env is not None:
            if env.strip().lower() in ("", "off", "0", "none"):
                return None
            path, source = env, "env"
        else:
            path, source = profile_path(backend, root=root), "committed"
            if not os.path.exists(path):
                return None
    try:
        text = pathlib.Path(path).read_text()
    except OSError as exc:
        raise TunedProfileError(
            f"tuned profile {path} unreadable: {exc}"
        ) from exc
    try:
        record = json.loads(text)
    except json.JSONDecodeError as exc:
        raise TunedProfileError(
            f"tuned profile {path} is not valid JSON: {exc}"
        ) from exc
    if not isinstance(record, dict) or "backend" not in record \
            or "knobs" not in record:
        raise TunedProfileError(
            f"tuned profile {path} missing required keys "
            "('backend', 'knobs')"
        )
    stamped = str(record["backend"])
    if stamped != backend:
        raise ProvenanceError(
            f"tuned profile {path} was measured on backend {stamped!r} but "
            f"this run computes on {backend!r}; refusing to load a "
            "cross-backend optimum (re-tune with tools/autotune.py on this "
            "backend, or point GRAFT_TUNED_PROFILE at the right artifact)"
        )
    knobs = record["knobs"]
    if not isinstance(knobs, dict) or not all(
        isinstance(v, (int, float)) and not isinstance(v, bool)
        for v in knobs.values()
    ):
        raise TunedProfileError(
            f"tuned profile {path} knobs must map names to numbers"
        )
    return TunedProfile(
        backend=stamped,
        knobs=dict(knobs),
        path=str(path),
        git_sha=record.get("git_sha"),
        created_wall=record.get("created_wall"),
        measured=record.get("measured"),
        source=source,
    )


def write_tuned_profile(
    path: str | pathlib.Path,
    backend: str,
    knobs: dict,
    *,
    measured: dict | None = None,
    force: bool = False,
) -> dict:
    """Commit a tuned profile artifact durably.

    Same write discipline as the cost artifacts: backend-stamped,
    ``check_overwrite`` guarded (a run on another backend may not clobber
    an accelerator-stamped profile without ``force``), staged to a temp
    file and published with ``durable_replace`` so a crash at any point
    leaves either the old profile or the new one — never a torn JSON."""
    from .artifacts import check_overwrite
    from .checkpoint import durable_replace

    check_overwrite(path, backend, force=force)
    record = {
        "backend": backend,
        "knobs": {str(k): knobs[k] for k in sorted(knobs)},
        "git_sha": _git_short_sha(),
        "created_wall": time.time(),
        "measured": dict(measured or {}),
    }
    target = pathlib.Path(path)
    fd, tmp = tempfile.mkstemp(dir=str(target.parent) or ".",
                               suffix=".tuned.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")
        durable_replace(tmp, str(target))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return record


def tuned_config(cls: type, profile: TunedProfile | None = None,
                 **overrides: Any) -> Any:
    """Build config dataclass ``cls`` through the knob resolution ladder:
    explicit non-None override > tuned-profile knob > field default (which
    reads ``TUNABLE_DEFAULTS``).  ``None`` overrides mean "not specified"
    — exactly what argparse hands over for an unset flag — so CLI layers
    pass their whole namespace through without pre-filtering."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(overrides) - set(fields)
    if unknown:
        raise TypeError(
            f"{cls.__name__} has no fields {sorted(unknown)}"
        )
    kwargs: dict = {}
    for name, field in fields.items():
        if overrides.get(name) is not None:
            kwargs[name] = overrides[name]
        elif profile is not None and name in TUNABLE_DEFAULTS \
                and name in profile.knobs:
            value = profile.knobs[name]
            # int knobs arrive as JSON numbers; preserve the field's kind
            if isinstance(TUNABLE_DEFAULTS.get(name), int):
                value = int(value)
            kwargs[name] = value
    return cls(**kwargs)


def _git_short_sha() -> str | None:
    """Short HEAD sha of the repo the profile was tuned in (None when git
    is unavailable — e.g. a deployed artifact tree)."""
    import subprocess

    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=str(_PACKAGE_DIR), capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None
