"""Batched serving with the ACE request guardrail on the PyTorch/CUDA port:
greedy continuations from a small LM through ``ServeEngine``'s captured
prefill and decode programs (one CUDA graph a signature) while the
guardrail sketches request-embedding traffic; after warmup,
out-of-distribution request batches are rejected in O(K·L) before the
model runs.  Runs on the card (``--device cpu`` for the CPU, where the
programs run uncaptured on their static buffers).

    PYTHONPATH=src python examples/serve_guardrail_torch.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.models.registry import Arch
from repro_torch.serve.engine import Guardrail, GuardrailConfig, ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)

    a = Arch("qwen2_1_5b", reduced=True)
    a.cfg = dataclasses.replace(a.cfg, num_layers=4, d_model=256,
                                num_heads=4, num_kv_heads=2, head_dim=64,
                                d_ff=1024, vocab_size=4096, dtype="float32")
    params = a.init_params(0, device=device)

    guard = Guardrail(GuardrailConfig(d_model=a.cfg.d_model, num_bits=8,
                                      warmup_items=64, alpha=3.0),
                      device=device)
    engine = ServeEngine(a, s_max=64, guardrail=guard, device=device)

    rng = np.random.default_rng(0)
    B, S = 8, 16
    # In-distribution traffic: a few template prompts with 2 of 16 tokens
    # substituted per request (prompt similarity = token OVERLAP; with
    # untrained random embeddings, nearby token *ids* share nothing).
    templates = rng.integers(100, 400, (4, S))
    ood_template = rng.integers(3800, 4096, (S,))

    def _jitter(base):
        toks = base.copy()
        for b in range(toks.shape[0]):
            idx = rng.choice(S, 2, replace=False)
            toks[b, idx] = rng.integers(0, 4096, 2)
        return torch.as_tensor(toks, dtype=torch.int32, device=device)

    def normal_requests():
        return _jitter(templates[rng.integers(0, 4, B)])

    def weird_requests():
        return _jitter(np.tile(ood_template, (B, 1)))

    # warm traffic
    for _ in range(12):
        engine.generate(params, {"tokens": normal_requests()},
                        num_new_tokens=8, prompt_len=S)
    print("served 12 normal batches; guardrail n =", float(guard.state.n))
    print("programs built (prefill, decode):", engine.trace_counts,
          "guardrail admit:", guard.trace_count)

    admit_ok = guard.admit(params["embed"][normal_requests().long()])
    admit_bad = guard.admit(params["embed"][weird_requests().long()])
    print(f"normal batch admitted: {admit_ok.sum()}/{B}")
    print(f"OOD batch admitted:    {admit_bad.sum()}/{B}")
    print("guardrail cost per request: K·L =",
          guard.ace_cfg.num_bits * guard.ace_cfg.num_tables,
          "hash bits + ", guard.ace_cfg.num_tables, "lookups; memory =",
          f"{guard.ace_cfg.memory_bytes() / 2**20:.2f} MB")


if __name__ == "__main__":
    main()
