"""The SpMV cost probes on the card: counterparts of the JAX package's
``tools/gather_micro.py``, ``tools/spmv_breakdown.py`` and
``tools/xla_cost_micro.py``.

Each tool runs as ``python -m page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.<tool>``,
on ``cuda`` unless given ``--device cpu``, and prints one JSON line with
the JAX tool's keys, stamped with the backend (``"gpu"``), the card's name
and its power limit.  Its stages are module-level callables
(``stages(...)``) that ``main`` times with ``utils/timing.py``.  A
``--device cpu`` run evaluates every stage once and writes ``null`` where a
time would stand.  ``--out`` also writes the record, under the provenance
guard of ``utils/artifacts.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import artifacts, timing
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import (
    backend_name,
    resolve_device,
)


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--out", type=str, default=None,
                    help="also write the JSON record to this path")
    ap.add_argument("--force", action="store_true",
                    help="allow overwriting a record measured on an accelerator "
                         "with a run on another backend (utils/artifacts.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' computes every "
                         "stage and writes null times)")


def device_stamp(device: torch.device) -> dict:
    """What a record measured on ``device`` carries beside its backend: the
    card's name and power limit (``utils/timing.card``), or the device
    type and ``None`` off the card."""
    if device.type == "cuda":
        return timing.card()
    return {"device": device.type, "power_limit": None}


def start(args: argparse.Namespace) -> tuple[torch.device, str, dict] | None:
    """Resolve the device and its stamp, and check ``--out`` before any
    measurement.  Returns ``(device, backend, stamp)``, or ``None`` after
    printing why the write would be refused."""
    device = resolve_device(args.device)
    backend = backend_name(device)
    stamp = device_stamp(device)
    try:
        artifacts.check_overwrite(args.out, backend, force=args.force)
    except artifacts.ProvenanceError as exc:
        print(f"REFUSED: {exc}", file=sys.stderr)
        return None
    return device, backend, stamp


def emit(args: argparse.Namespace, payload: dict, backend: str, stamp: dict) -> int:
    """Print the stamped record as one JSON line, and write it to
    ``--out`` if given.  Returns the tool's exit code."""
    print(json.dumps(artifacts.write_artifact(None, payload, backend=backend, **stamp)))
    try:
        artifacts.write_artifact(args.out, payload, backend=backend, force=args.force, **stamp)
    except artifacts.ProvenanceError as exc:
        print(f"REFUSED: {exc}", file=sys.stderr)
        return 3
    return 0
