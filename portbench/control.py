"""The control of the comparison: the plain reference put in the program's
place, computed in the precision below the configuration's.

The configuration states float32 and there is no matrix product, so the
precision below is bfloat16: ranks, degrees and restart vectors held in
bfloat16, each step's sums taken in float32 and rounded to bfloat16.  A run
with the control in the program's place has to come out not correct; the
smallest of its readings over three seeds or more is the upper reading
each limit is set below (``calibrate.py``).
"""

from __future__ import annotations

import torch

from portbench import reference


def make(src, dst, n: int, device):
    """The control's ``call(graph, cfg, batch, device)`` over the raw edge
    arrays; the program's graph it is handed is left unread."""
    g = reference.build(src, dst, n, device)

    def call(graph, cfg, batch, dev):
        del graph
        e = reference.restart_matrix(n, batch, dev)
        r = reference.pagerank(g, e, iterations=cfg.iterations, damping=cfg.damping,
                               dangling=cfg.dangling.value, init=cfg.init.value,
                               dtype=torch.bfloat16, acc=torch.float32)
        return r.T.float().cpu().numpy(), {"iterations": cfg.iterations,
                                           "queries": e.shape[1], "records": []}

    return call
