"""Multi-device PageRank + TF-IDF via the PyTorch port's library API
(SURVEY.md §2.2 R1–R3).

The port's counterpart of ``examples/multichip_example.py``: every shard
strategy over a mesh of device slots, each strategy's L1 against the
one-device ranks, then the sharded TF-IDF.  By default the mesh spreads at
least 4 slots over every visible card, one a card where there are 4 or
more (4 slots of the one card on a one-card machine: the 4-shard layout,
not multi-GPU scaling); ``--slots`` sets the count.  Runs on ``cuda``
unless given ``--device cpu`` (then ``--slots`` CPU slots, default 4).

Run from the repo root:
    python examples/torch_multichip_example.py [--slots N] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import (  # noqa: E402
    synthetic_powerlaw,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import (  # noqa: E402
    run_pagerank,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import (  # noqa: E402
    auto_select_strategy,
    make_mesh,
    run_pagerank_sharded,
    run_tfidf_sharded,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (  # noqa: E402
    PageRankConfig,
    TfidfConfig,
)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.device import (  # noqa: E402
    resolve_device,
)

MIN_SLOTS = 4


def slot_devices(device, slots):
    """The mesh's devices: ``slots`` (default: at least ``MIN_SLOTS``, one a
    card where there are that many) spread in order over every visible card,
    or ``slots`` slots of the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * (slots or MIN_SLOTS)
    cards = ([dev] if dev.index is not None
             else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    n = slots or max(MIN_SLOTS, len(cards))
    return [cards[i * len(cards) // n] for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slots", type=int, default=None,
                    help=f"slots of the mesh (default: at least {MIN_SLOTS}, over every "
                         "visible card)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    mesh = make_mesh(devices=slot_devices(args.device, args.slots))
    d = mesh.size
    graph = synthetic_powerlaw(20_000, 120_000, seed=3)
    cfg = PageRankConfig(iterations=30, dangling="redistribute", init="uniform",
                         dtype="float64")
    single = run_pagerank(graph, cfg, device=mesh.devices[0]).ranks

    print(f"mesh: {d} slots of {sorted({str(x) for x in mesh.devices})}; auto strategy -> "
          f"{auto_select_strategy(graph, d, devices=mesh.devices)!r}")
    for strategy in ("edges", "nodes", "nodes_balanced", "src", "src_ring",
                     "hybrid"):
        res = run_pagerank_sharded(graph, cfg, mesh=mesh, strategy=strategy)
        l1 = np.abs(res.ranks - single).sum()
        print(f"pagerank[{strategy:14s}] on {d} devices: L1 vs single-chip {l1:.2e}")

    docs = [f"alpha w{i % 17} w{i % 5} beta{i % 3}" for i in range(512)]
    chunks = [docs[i:i + 64] for i in range(0, len(docs), 64)]
    out = run_tfidf_sharded(iter(chunks), TfidfConfig(vocab_bits=14), mesh=mesh)
    print(f"tfidf sharded: {out.n_docs} docs, nnz={out.nnz} "
          f"(DF psum over {d} devices, replicated IDF broadcast)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
