"""End-to-end TF-IDF + query scoring via the PyTorch port's library API.

The port's counterpart of ``examples/tfidf_example.py``: the TF-IDF chain
(SURVEY.md §3.2) and the top-k query (SURVEY.md A11).  Runs on ``cuda``
unless given ``--device cpu``.

Run from the repo root:  python examples/torch_tfidf_example.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from page_rank_and_tfidf_using_apache_spark_tpu_torch.api import tfidf  # noqa: E402
from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.text import (  # noqa: E402
    fnv1a_64,
    hash_to_vocab,
    tokenize,
)

NAMES = ["spark.txt", "tpu.txt", "pagerank.txt", "tfidf.txt"]
DOCS = [
    "apache spark is a cluster computing framework",
    "a tpu accelerates dense linear algebra with a systolic array",
    "pagerank scores pages by the structure of the web graph",
    "tf idf weighs terms by frequency and inverse document frequency",
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    out = tfidf(DOCS, vocab_bits=12, idf_mode="smooth", l2_normalize=True,
                device=args.device)
    print(f"{out.n_docs} docs, {out.nnz} nonzero (term, doc) weights")

    # Score documents for a query by summed TF-IDF (the reference's likely
    # takeOrdered capability, SURVEY.md A11).
    query = "spark framework"
    qids = hash_to_vocab(fnv1a_64(tokenize(query)), 12)
    scores = np.zeros(out.n_docs)
    for qid in np.unique(qids):
        hit = out.term == qid
        np.add.at(scores, out.doc[hit], out.weight[hit])
    for rank, d in enumerate(scores.argsort()[::-1][:3], 1):
        print(f"  {rank}. {NAMES[d]}  score={scores[d]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
