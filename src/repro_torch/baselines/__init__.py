"""The paper's 11 baselines (§5.2) in PyTorch, all sharing one kNN graph —
port of ``repro.baselines``.

``run_baseline(name, x, k)`` returns per-point scores where LOW = anomalous
(the paper's μ−σ thresholding convention), as numpy, and the host seconds
of graph build plus scoring — mirroring how ELKI amortises its index.  The
graph and the inner pairwise distances stay on the device between
methods.
"""
from __future__ import annotations

import time

from repro_torch import resolve_device
from repro_torch.baselines import neighbors as nb
from repro_torch.baselines.cof import cof_score
from repro_torch.baselines.fastvoa import fastvoa_score
from repro_torch.baselines.knn_graph import (knn_graph,
                                             pairwise_within_neighborhood)

GRAPH_BASED = {
    "lof": lambda g, x: nb.lof_score(*g),
    "knn": lambda g, x: nb.knn_score(*g),
    "knnw": lambda g, x: nb.knnw_score(*g),
    "loop": lambda g, x: nb.loop_score(*g),
    "odin": lambda g, x: nb.odin_score(*g),
    "kdeos": lambda g, x: nb.kdeos_score(*g),
    "ldf": lambda g, x: nb.ldf_score(*g),
    "inflo": lambda g, x: nb.inflo_score(*g),
}
NEIGHBORHOOD_BASED = {"ldof", "cof"}        # need inner pairwise distances
ALL_BASELINES = (list(GRAPH_BASED) + ["ldof", "cof", "fastvoa"])


def run_baseline(name: str, x, k: int, graph=None, inner=None,
                 fastvoa_t: int = 320, device=None):
    """Returns (scores_lo_anomalous as numpy, host seconds, graph, inner).

    ``graph``/``inner`` can be passed in to share across methods
    (ELKI-style); their build time is charged to the first method that
    needs them.  The seconds end in the scores' device→host copy, which
    waits for the device.  Runs on ``device`` (CUDA unless the caller
    passes another).
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if name == "fastvoa":
        s = fastvoa_score(x, t=fastvoa_t, device=dev).cpu().numpy()
        return s, time.perf_counter() - t0, graph, inner

    if graph is None:
        graph = knn_graph(x, k, device=dev)
    if name in GRAPH_BASED:
        s = GRAPH_BASED[name](graph, x).cpu().numpy()
        return s, time.perf_counter() - t0, graph, inner

    if inner is None:
        inner = pairwise_within_neighborhood(x, graph[1])
    if name == "ldof":
        s = nb.ldof_score(graph[0], graph[1], inner)
    elif name == "cof":
        s = cof_score(x, graph[1], inner)
    else:
        raise KeyError(name)
    return s.cpu().numpy(), time.perf_counter() - t0, graph, inner
