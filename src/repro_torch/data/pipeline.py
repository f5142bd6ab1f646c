"""Request featurisation shared by the guardrail and (in a later slice)
the data filters — port of ``repro.data.pipeline.mean_embed_features``.

``AceDataFilter`` and the data stream are not ported yet (ROADMAP.md
queue 1 item 2).
"""
from __future__ import annotations

import torch


def mean_embed_features(embeds: torch.Tensor,
                        bias_const: float) -> torch.Tensor:
    """(B, S, D) embeddings -> (B, D+1) unit-mean + bias features.

    Unit-normalised mean embedding + a bias coordinate: direction drift is
    what the angular SRP sees; the bias re-encodes magnitude at a
    controlled weight.
    """
    f = torch.mean(embeds.to(torch.float32), dim=1)
    f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-9)
    bias = torch.full((f.shape[0], 1), bias_const, dtype=torch.float32,
                      device=f.device)
    return torch.cat([f, bias], dim=-1)
