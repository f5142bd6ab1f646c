#!/usr/bin/env python3
"""Build the PyTorch/CUDA port of ACE (``src/repro_torch``) and drive its
main paths on one NVIDIA GPU, checking every result.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order (any failed check raises, and the script then exits
non-zero without printing its result line):

1. build   — compile the ten CUDA kernel sources (one ``nvcc`` per
             source, all at once) and print the card's name and power
             limit;
2. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes of the main paths: dense hash bucket ids agree
             >= 0.999 at the fit, admit and stream-step shapes, and are
             bitwise equal between two calls (``srp_hash`` and every
             output of ``ace_admit_fused``), SRHT ids bitwise at d = 36,
             64, 1024, 1025, 4097 and 12289 (an all-zero and a NaN row
             each), and
             counts, gathers, scores and admit masks bitwise (downstream
             of the kernel's own bucket ids), including a batch of
             repeated rows for both fused admissions, ``ace_update``
             with every id of the fit batch in one bucket, the weighted (two
             tables masked) forms of the fused score and the window
             combine, ``ace_update``/``ace_query`` at per-item base
             rows of the windowed fleet's (T·E·L, 2^15) ring,
             ``ace_query_sum`` (the one-launch gather and row sum) in
             every scale, with a health mask and at those base rows with a
             (T, L) mask routed by tenant id, also bitwise equal to the
             (B, L) gather + PyTorch reduction it replaced, the windowed-
             fleet admission's ids bitwise ``srp_hash``'s under one plan,
             and
             ``attr_estimate`` equal by value at R = 1, 2, 5, 8 (C = 256)
             for B = 32 and all 4097 leaf coordinates, and on an all-zero
             plane, and ``attr_find_hh`` (the one-launch drill-down)
             bitwise its plain version and the per-level loop of
             ``attr_estimate`` launches it replaced, at phase 7's
             hierarchy shape, topk 8 and 18, planted, all-zero and NaN;
             ``ace_score_fused``'s ids bitwise ``srp_hash``'s, its
             unweighted scores bitwise ``srp_hash`` + ``ace_query_sum``
             (either row sum), its weighted ones the table-order sum;
3. estimator — ``AceEstimator`` (paper Algorithm 1) at K=15, L=50 fit on
             596,853 x 36 clustered non-negative points (the KDD-Cup99 HTTP
             shape) in batches of 4096, then 16,384 queries scored and
             predicted (``ace_score_fused``), and the largest row sum a
             fit point sees printed (below 2^24 every score is bitwise the
             old gather + fp32 reduction's); then a shorter fit and score
             under ``hash_mode="srht"``, held bitwise against the plain
             path;
4. guardrail — ``Guardrail`` at d_model=4096, K=15, L=50: 32 admits of
             256 requests x 16 tokens, one NaN row per batch, an
             off-distribution burst in half the rows of the last 4; held
             against the plain-path guardrail on the same W: masks differ
             in <= 1%, insertions a hash flip moved to another bucket
             <= 1e-3 of n*L (the hash floor), mu and Welford within rtol
             1e-3 (1e-5 when no insertion moved);
5. stream  — ``StreamRunner(chunk_T=16)`` over 8 chunks of 16 x 512 feature
             rows at d_model=4096 (clustered around 8 topics, one NaN row a
             step, a burst of unseen topics in the last two chunks) through
             four filters at their defaults (K=13, L=32, alpha=4, warmup
             512): ``AceDataFilter`` in each hash family,
             ``WindowedAceFilter`` (E=4, gamma=1) with ``rotate_every=4``,
             and ``FleetDataFilter`` of 8 tenants (every batch mixes all of
             them): the chunked run equals a sequential loop of ``step``
             bitwise, the kernel path equals the plain path (bitwise under
             SRHT, within the dense ids floor otherwise), one transfer each
             way per chunk, no host sync inside ``consume`` (sync debug
             mode "error"), items/s printed;
6. windows and fleets — three ``Guardrail`` flavours at the phase-4 width
             (d_model=4096, K=15, L=50), 40 admits of 256 x 16 whose
             traffic shifts to 4 unseen topics after admit 16: windowed
             (E=4, gamma=0.9, rotate every 4 admits), a fleet of 8 tenants
             and the windowed fleet (8 x 4 epochs, a 210 MB int32 ring and a
             52 MB tail), each held against its plain path (masks, the hash
             floor, cursors and ticks); the windowed ones must re-admit the
             new regime once the old one has aged out (E x R admits), the
             flat fleet, like the flat guardrail, keeps rejecting it; then
             ``ops.ace_window_score`` (``ace_window_combine``) and
             ``ops.ace_fleet_score`` (``ace_fleet_score``) on the states
             those guardrails built;
7. attribution — three of phase 5's filters with heavy-hitter
             attribution (``attr_rows=5``, ``attr_bits=8``, ``topk=8``) on
             phase 5's stream whose last two chunks also move a block of
             64 rows a step onto three planted coordinates: the
             ``AceDataFilter`` under SRHT, the fleet of 8 (the block routed
             to one tenant) and the windowed filter; the last chunk's
             heavy hitters name the planted coordinates (and the fleet's
             ``hh_tenant[0]`` the offender), the kernel path's equal the
             plain path's, one ``attr_find_hh`` launch a chunk and no
             ``attr_estimate`` on the stream, one transfer each way a
             chunk and no host sync in ``consume``, the post-mortem batch
             query over all 4097 coordinates one ``attr_estimate`` launch
             and kernel ≡ plain, items/s beside phase 5's;
             ``attr_find_hh`` bitwise its plain version on the attacked
             chunk's drift hierarchy, and one ``find_hh`` and one
             ``consume`` of that chunk traced with the one-launch
             drill-down and with the per-level loop (device ops before
             and after);
8. timing  — each kernel, its plain version and (where one PyTorch call
             computes the same function) that call, timed with CUDA events,
             beside the least time the card could take (its bound);
             ``srp_hash`` at its three main-path shapes (fit, admit, stream
             step) under its launch plan and every other cluster size, and
             ``ace_admit_fused`` at its two (admit, stream step), each
             beside cuBLAS's fp32 projection alone (``matmul_ms``, TF32
             off), with the plan printed; ``ace_update`` at the fit (into
             five fresh tables), admit and stream-step shapes and
             ``srht_hash`` at the stream step, the d = 36 fit and the
             d = 64 corner (``time_update_and_srht``, which
             ``scripts/kernel_ab.py`` also runs on another checkout's
             kernels); ``ace_query_sum`` at the fit against the (B, L)
             gather + ``torch.sum`` + multiply it replaced;
             ``ops.ace_query``/``ace_update``/``ace_fleet_admit_at`` at
             three shapes and the windowed-fleet admission
             (``time_query_paths``, which ``kernel_ab.py`` also runs);
             ``attr_find_hh`` on the drift hierarchy (also with the plane
             read from global memory) against the per-level loop it
             replaced, ``ace_score_fused`` under each row sum and
             weighted against ``srp_hash`` + ``ace_query_sum``, and the
             public ``attribution.find_hh`` and ``ops.ace_score``
             (``time_public_paths``, which ``kernel_ab.py`` also runs);
             and both hash kernels at the corners of hash_mode="auto"
             (d = 64 and 4096), checked against the rule's picks.

Every kernel wrapper counts its launches; the counts are set to 0 just
before each path of phases 3 to 7 (the post-mortem query a path of its
own) and read just after, every kernel of a path must have been launched
in it, and no path may launch the (B, L) ``ace_query`` gather (every
gather-and-reduce is one ``ace_query_sum``).
The admits and ``consume`` calls traced in phases 4-7 are traced twice:
as they run, and with the (B, L) gather + PyTorch reductions in place of
``ace_query_sum``, the device ops before and after it.  The last lines
are the card's ``nvidia-smi`` name and power limit, one JSON line of
per-kernel numbers, and ``{"ok": true, "device": {...}}``.  A kernel's
``max_abs_err`` there is the largest absolute difference, in phase 2,
between any of its outputs (bucket ids, counts, gathers, scores) and the
plain version's.

Data and weights are made from SEED.  Nothing here imports JAX.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores (an FMA counts two, so plain adds run at half of it), and
# HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_FP32_ADDS = 33.5e12
PEAK_BYTES_PER_S = 3.35e12

KDD_N, KDD_D = 596_853, 36          # KDD-Cup99 HTTP (repro/data/synthetic.py)
K_BITS, L_TABLES = 15, 50           # the paper's sketch
FIT_BATCH, N_QUERIES = 4096, 16_384
D_MODEL, ADMITS, ADMIT_B, ADMIT_S = 4096, 32, 256, 16
SRHT_FIT_N = 65_536                 # the shorter hash_mode="srht" fit
STREAM_T, STREAM_B, STREAM_CHUNKS = 16, 512, 8
STREAM_K, STREAM_L = 13, 32          # the stream filters' defaults
SRHT_WIDTHS = (36, 64, 1024, 1025, 4097, 12289)   # d_pad 64 ... 16384
AUTO_DIMS, AUTO_B = (64, 4096), 256  # benchmarks/stream_throughput.py
WIN_E, WIN_GAMMA, WIN_R = 4, 0.9, 4  # the windowed guardrails
FLEET_T = 8                          # tenants of the fleets
SHIFT_ADMITS, SHIFT_AT = 40, 16      # phase 6: the traffic shifts here
STREAM_R = 4                         # the windowed stream's rotate_every
ATTR_KINDS = ("srht", "fleet", "window")   # phase 7's filters
ATTR_ROWS, ATTR_BITS, ATTR_TOPK = 5, 8, 8   # the reference's defaults
ATTR_KW = dict(attr_rows=ATTR_ROWS, attr_bits=ATTR_BITS)
PLANTED = (700, 2049, 3501)          # the dims the attack block moves onto
ATTACK_ROWS = 64                     # rows B/4 … B/4 + 63 of a late step
OFFENDER = 5                         # the fleet tenant they are routed to

KERNELS = ("srp_hash", "srht_hash", "ace_update", "ace_query",
           "ace_score_fused", "ace_admit_fused", "ace_window_combine",
           "ace_fleet_score", "ace_fleet_window_admit", "attr_estimate")
REPLACES = {
    "srp_hash": "src/repro/kernels/srp_hash.py:125",
    "srht_hash": "src/repro/kernels/srht_hash.py:100",
    "ace_update": "src/repro/kernels/ace_update.py:122",
    "ace_query": "src/repro/kernels/ace_query.py:66",
    "ace_score_fused": "src/repro/kernels/ace_score_fused.py:130",
    "ace_admit_fused": "src/repro/kernels/ace_admit_fused.py:178",
    "ace_window_combine": "src/repro/kernels/ace_window_combine.py:174",
    "ace_fleet_score": "src/repro/kernels/ace_fleet_score.py:108",
    "ace_fleet_window_admit":
        "src/repro/kernels/ace_fleet_window_admit.py:250",
    "attr_estimate": "src/repro/kernels/attr_estimate.py:60",
    "attr_find_hh": "src/repro/kernels/attr_estimate.py:60",
}
# The kernels of the result line: each module's KERNEL, and the second
# entry point of csrc/attr_estimate.cu, the one-launch findHH drill-down.
LINE_KERNELS = KERNELS + ("attr_find_hh",)
SOURCES = {**{k: k for k in KERNELS}, "attr_find_hh": "attr_estimate"}


class CheckFailed(RuntimeError):
    pass


def check(ok, what: str) -> None:
    if not bool(ok):
        raise CheckFailed(what)
    print(f"  ok: {what}")


def import_port():
    """The port's modules, from ``src/`` beside this script."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside "
                         "chip_smoke.py; run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import importlib
    return {k: importlib.import_module(f"repro_torch.kernels.{k}")
            for k in KERNELS}


def launch_counters(mods) -> dict:
    """Every wrapper's launch counter: each module's ``KERNEL`` (for
    ``ace_query`` the one-launch gather-and-sum every main path takes, for
    ``attr_estimate`` the post-mortem batch query), ``attr_find_hh`` (the
    stream's drill-down), and ``ace_query``'s (B, L) gather, which no main
    path takes."""
    return {**{k: m.KERNEL for k, m in mods.items()},
            "attr_find_hh": mods["attr_estimate"].FIND_HH_KERNEL,
            "ace_query_gather": mods["ace_query"].GATHER_KERNEL}


def reset_launches(mods) -> None:
    for c in launch_counters(mods).values():
        c.launches = 0


def read_launches(mods) -> dict:
    return {k: c.launches for k, c in launch_counters(mods).items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kdd_like(n: int, d: int, rng: np.random.Generator) -> np.ndarray:
    """n x d clustered non-negative float32 points: a dozen sparse
    non-negative centres with skewed weights, scaled per point and
    perturbed by small non-negative noise."""
    c = 12
    centers = rng.gamma(2.0, 1.0, size=(c, d)) * (rng.random((c, d)) < 0.5)
    labels = rng.choice(c, size=n, p=rng.dirichlet(np.full(c, 0.5)))
    scale = rng.lognormal(0.0, 0.1, size=(n, 1))
    x = centers[labels] * scale + np.abs(rng.normal(0.0, 0.05, size=(n, d)))
    return x.astype(np.float32)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a == b).to(torch.float64).mean())


def distinct_counters(buckets: torch.Tensor, nbuckets: int) -> int:
    """Number of distinct counters (j, bucket) a (B, L) batch touches."""
    rows = torch.arange(buckets.shape[1], device=buckets.device)[None, :]
    return int(torch.unique(rows * nbuckets + buckets.long()).numel())


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version at the main path's shapes.
# ---------------------------------------------------------------------------

def phase_kernels(mods, device, fit_batch=FIT_BATCH, d_model=D_MODEL,
                  admit_b=ADMIT_B, n_queries=N_QUERIES) -> dict:
    from repro_torch.core.srp import SrpConfig, make_projections
    h, u, q, a = (mods[k] for k in ("srp_hash", "ace_update", "ace_query",
                                    "ace_admit_fused"))
    gen = torch.Generator(device=device).manual_seed(SEED)
    err = {}

    cfg = SrpConfig(dim=KDD_D, num_bits=K_BITS, num_tables=L_TABLES)
    w = make_projections(cfg, device=device)
    x = torch.as_tensor(kdd_like(fit_batch, KDD_D,
                                 np.random.default_rng(SEED + 1)),
                        device=device)
    kb = h.srp_hash(x, w, cfg)
    pb = h.srp_hash_plain(x, w, cfg)
    share = agreement(kb, pb)
    err["srp_hash"] = float((kb - pb).abs().max())
    check(share >= 0.999, f"srp_hash ids agree with plain: {share:.6f} "
          f">= 0.999 at B={fit_batch}, d={KDD_D}")
    # the admits' and the stream step's shapes; the depth splits add in a
    # fixed order, so a second call gives the same bits
    for (hb, hd, hk, hl) in ((admit_b, d_model + 1, K_BITS, L_TABLES),
                             (STREAM_B, d_model + 1, STREAM_K, STREAM_L)):
        hcfg = SrpConfig(dim=hd, num_bits=hk, num_tables=hl, seed=43)
        hw = make_projections(hcfg, device=device)
        hx = torch.randn((hb, hd), generator=gen, device=device)
        k1, p1 = h.srp_hash(hx, hw, hcfg), h.srp_hash_plain(hx, hw, hcfg)
        share = agreement(k1, p1)
        err["srp_hash"] = max(err["srp_hash"], float((k1 - p1).abs().max()))
        plan = h.device_plan(hb, hd, hk, hl, device)
        check(share >= 0.999, f"srp_hash ids agree with plain: {share:.6f} "
              f">= 0.999 at B={hb}, d={hd}, K={hk}, L={hl} "
              f"({plan.describe()})")
        check(torch.equal(k1, h.srp_hash(hx, hw, hcfg)), "srp_hash ids "
              f"bitwise equal between two calls at B={hb}, d={hd}")

    counts0 = torch.randint(0, 9, (L_TABLES, 1 << K_BITS), generator=gen,
                            device=device, dtype=torch.int32)
    ck = u.ace_update(counts0.clone(), kb)
    cp = u.ace_update_plain(counts0.clone(), kb)
    err["ace_update"] = float((ck - cp).abs().max())
    check(torch.equal(ck, cp), "ace_update counts bitwise equal to plain")

    gk, gp = q.ace_query(ck, kb), q.ace_query_plain(ck, kb)
    err["ace_query"] = float((gk - gp).abs().max())
    check(torch.equal(gk, gp), "ace_query (B, L) gather bitwise equal to "
          "plain")
    # the one-launch sum in every scale, with and without two tables
    # masked: bitwise its plain version, and (below 2^24) the gather +
    # PyTorch reduction each caller took before it
    tmask = torch.ones(L_TABLES, device=device)
    tmask[[3, 31]] = 0.0
    old = {"sum": torch.sum(gk, dim=-1),
           "mean": torch.sum(gk, dim=-1) * torch.tensor(1.0 / L_TABLES),
           "masked mean": torch.sum(gk * tmask, dim=-1)
           * (1.0 / torch.clamp_min(torch.sum(tmask), 1.0))}
    for scale in q.SCALES:
        for m in (None, tmask):
            sk_ = q.ace_query_sum(ck, kb, table_mask=m, scale=scale)
            sp = q.ace_query_sum_plain(ck, kb, table_mask=m, scale=scale)
            err["ace_query"] = max(err["ace_query"],
                                   float((sk_ - sp).abs().max()))
            what = f"ace_query_sum ({scale}" + (", 2 tables masked)"
                                                if m is not None else ")")
            check(torch.equal(sk_, sp), f"{what} bitwise equal to plain at "
                  f"B={fit_batch}, L={L_TABLES}")
            key = ("masked " if m is not None else "") + scale
            if key in old:
                check(torch.equal(sk_, old[key]), f"{what} bitwise equal to "
                      "the (B, L) gather + PyTorch reduction it replaces")
    check(torch.equal(q.ace_query_sum(ck, kb), torch.mean(gk, dim=-1)),
          "ace_query_sum (mean) bitwise equal to torch.mean of the (B, L) "
          "gather on the card (ops.ace_update's old composition)")

    acfg = SrpConfig(dim=d_model + 1, num_bits=K_BITS, num_tables=L_TABLES,
                     seed=41)
    aw = make_projections(acfg, device=device)
    qr = torch.randn((admit_b, d_model + 1), generator=gen, device=device)
    # colliding batch: 8 copies of each of B/8 rows, so every bucket an
    # item hits is hit by 7 others in the same launch
    qc = qr[: admit_b // 8].repeat(8, 1).contiguous()
    mask = torch.rand((admit_b,), generator=gen, device=device) < 0.9
    # the dense stream step's admission: B = 512 at K = 13, L = 32
    scfg = SrpConfig(dim=d_model + 1, num_bits=STREAM_K,
                     num_tables=STREAM_L, seed=47)
    sw = make_projections(scfg, device=device)
    sq = torch.randn((STREAM_B, d_model + 1), generator=gen, device=device)
    smask = torch.rand((STREAM_B,), generator=gen, device=device) < 0.9
    scounts = torch.randint(0, 9, (STREAM_L, 1 << STREAM_K), generator=gen,
                            device=device, dtype=torch.int32)
    worst = 0.0
    for name, qb, c0, wb, cb, mb in (
            ("random", qr, counts0, aw, acfg, mask),
            ("colliding", qc, counts0, aw, acfg, mask),
            ("stream step", sq, scounts, sw, scfg, smask)):
        pre = h.srp_hash_plain(qb, wb, cb)
        nt = cb.num_tables
        rows = torch.arange(nt, device=device)[None, :]
        recip = torch.tensor(1.0 / nt, dtype=torch.float32)
        thresh = torch.median(c0[rows, pre.long()].float().sum(-1) * recip)
        ck, sk_, ak, bk = a.ace_admit_fused(c0.clone(), qb, wb, thresh, cb,
                                            item_mask=mb)
        _, sp, ap, bp = a.ace_admit_fused_plain(c0.clone(), qb, wb, thresh,
                                                cb, item_mask=mb)
        share = agreement(bk, bp)
        check(share >= 0.999, f"ace_admit_fused ({name}) ids agree with "
              f"plain: {share:.6f} >= 0.999")
        # downstream of the kernel's own ids everything is exact
        ref_s = c0[rows, bk.long()].float().sum(-1) * recip
        ref_a = (ref_s >= thresh) & mb
        ref_c = c0.clone().index_put_(
            (rows, bk.long()),
            ref_a.to(torch.int32)[:, None].expand(bk.shape), accumulate=True)
        worst = max(worst, float((bk - bp).abs().max()),
                    float((sk_ - ref_s).abs().max()),
                    float((ck - ref_c).abs().max()))
        check(torch.equal(sk_, ref_s), f"ace_admit_fused ({name}) "
              "pre-insert scores bitwise")
        check(torch.equal(ak, ref_a), f"ace_admit_fused ({name}) admit "
              "mask bitwise")
        check(torch.equal(ck, ref_c), f"ace_admit_fused ({name}) counts "
              "bitwise")
        if name == "colliding":
            s8 = sk_.view(8, -1)
            check(torch.equal(s8, s8[:1].expand_as(s8)),
                  "colliding copies score alike: every score is pre-insert")
        again = a.ace_admit_fused(c0.clone(), qb, wb, thresh, cb,
                                  item_mask=mb)
        check(all(torch.equal(u, v) for u, v in
                  zip((ck, sk_, ak, bk), again)),
              f"ace_admit_fused ({name}) bitwise equal between two calls")
    err["ace_admit_fused"] = worst

    # ace_update's row mask: the masked insert of the SRHT/degraded paths
    rmask = torch.rand((fit_batch,), generator=gen, device=device) < 0.5
    ck = u.ace_update(counts0.clone(), kb, row_mask=rmask)
    cp = u.ace_update_plain(counts0.clone(), kb, rmask)
    err["ace_update"] = max(err["ace_update"], float((ck - cp).abs().max()))
    check(torch.equal(ck, cp), "ace_update with a row mask bitwise equal "
          "to plain")
    # every id of the fit batch in one bucket: each warp's 32 rows of a
    # table merge in one lane, a block's 8 warps in its shared table, and
    # 16 blocks' sums meet in each of the 50 counters
    hot = torch.full_like(kb, 12345)
    ck = u.ace_update(counts0.clone(), hot)
    cp = u.ace_update_plain(counts0.clone(), hot)
    err["ace_update"] = max(err["ace_update"], float((ck - cp).abs().max()))
    check(torch.equal(ck, cp), f"ace_update with all {hot.numel()} ids in "
          "one bucket a table bitwise equal to plain")

    # ace_score_fused at the estimator's score shape, both forms: its
    # ids are srp_hash's under the card's plan, its
    # unweighted scores ace_query_sum's of them, its weighted ones the
    # table-order sum of their gathers
    f = mods["ace_score_fused"]
    qs = torch.as_tensor(kdd_like(n_queries, KDD_D,
                                  np.random.default_rng(SEED + 4)),
                         device=device)
    ids = h.srp_hash(qs, w, cfg)
    same = (ids == h.srp_hash_plain(qs, w, cfg)).all(dim=1)
    tmask = torch.ones(L_TABLES, device=device)
    tmask[[3, 31]] = 0.0
    worst = 0.0
    for name, tw in (("unweighted", None),
                     ("weighted, 2 tables masked", tmask / tmask.sum())):
        sp = f.ace_score_fused_plain(ck, qs, w, cfg, table_weights=tw)
        if tw is None:
            ref = q.ace_query_sum(ck, ids)
        else:
            g = f.flat_table_gather(ck, ids)
            ref = torch.zeros(n_queries, device=device)
            for j in range(L_TABLES):
                ref = ref + g[:, j] * tw[j]
        sk_, kid = f.ace_score_fused_planned(ck, qs, w, cfg, tw, None,
                                             with_ids=True)
        what = f"ace_score_fused ({name})"
        worst = max(worst, float((sk_ - sp).abs().max()))
        check(torch.equal(kid, ids), f"{what} ids bitwise srp_hash's "
              "under the same plan")
        check(torch.equal(sk_, ref), f"{what} bitwise equal to "
              + ("srp_hash + ace_query_sum" if tw is None else
                 "the table-order sum of its own ids' gathers"))
        check(torch.equal(sk_[same], sp[same]), f"{what} bitwise equal "
              f"to plain on the {int(same.sum())} of {n_queries} rows "
              "whose ids agree")
    err["ace_score_fused"] = worst

    # srht_hash: ids bitwise on both sides of the one-warp / several-warp
    # row (d_pad 1024 / 2048), at powers of two and the widths of the
    # main paths, one above 48 KB of smem; an all-zero and a NaN row
    sh = mods["srht_hash"]
    worst = 0.0
    for d in SRHT_WIDTHS:
        scfg = SrpConfig(dim=d, num_bits=13, num_tables=32, seed=29,
                         hash_mode="srht")
        xs = torch.randn((STREAM_B, d), generator=gen, device=device)
        xs[0] = 0.0
        xs[1, d // 2] = float("nan")
        kb_s, pb_s = sh.srht_hash(xs, scfg), sh.srht_hash_plain(xs, scfg)
        worst = max(worst, float((kb_s - pb_s).abs().max()))
        check(torch.equal(kb_s, pb_s), f"srht_hash ids bitwise equal to "
              f"plain at B={STREAM_B}, d={d} (d_pad "
              f"{sh.srht_params(scfg).d_pad})")
    err["srht_hash"] = worst
    return err


def phase_kernels_windows_fleets(mods, device, d_model=D_MODEL,
                                 admit_b=ADMIT_B) -> dict:
    """Phase 2 for the kernels of the windowed and fleet paths, at the
    shapes of phase 8: the windowed fleet's (8, 4, 50, 2^15) ring, its
    fractional tail, B = 256 queries of d_model + 1."""
    from repro_torch.core.srp import SrpConfig, make_projections
    h, u, q = mods["srp_hash"], mods["ace_update"], mods["ace_query"]
    wc, fs, fwa = (mods[k] for k in ("ace_window_combine", "ace_fleet_score",
                                     "ace_fleet_window_admit"))
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    T, E, L, K = FLEET_T, WIN_E, L_TABLES, K_BITS
    nb = 1 << K
    err = {}
    cfg = SrpConfig(dim=d_model + 1, num_bits=K, num_tables=L, seed=41)
    w = make_projections(cfg, device=device)
    x = torch.randn((admit_b, d_model + 1), generator=gen, device=device)
    ids = h.srp_hash(x, w, cfg)
    ring = torch.randint(0, 9, (T, E, L, nb), generator=gen, device=device,
                         dtype=torch.int32)
    tail = torch.randint(0, 40, (T, L, nb), generator=gen,
                         device=device).float() * 0.9
    cursor = torch.randint(0, E, (T,), generator=gen, device=device,
                           dtype=torch.int32)
    tids = (torch.arange(admit_b, device=device) % T).to(torch.int32)

    # ace_update / ace_query at the live rows tid·E·L + cursor[tid]·L
    base = ((tids.long() * E + cursor.long()[tids.long()]) * L) \
        .to(torch.int32)
    mask = torch.rand((admit_b,), generator=gen, device=device) < 0.8
    flat = ring.view(T * E * L, nb)
    ck = u.ace_update(flat.clone(), ids, row_mask=mask, row_base=base)
    cp = u.ace_update_plain(flat.clone(), ids, mask, base)
    gk, gp = (q.ace_query(ck, ids, row_base=base),
              q.ace_query_plain(ck, ids, base))
    err["ace_update"] = float((ck - cp).abs().max())
    err["ace_query"] = float((gk - gp).abs().max())
    check(torch.equal(ck, cp), "ace_update at per-item base rows of the "
          f"({T * E * L}, 2^{K}) ring bitwise equal to plain")
    check(torch.equal(gk, gp), "ace_query at per-item base rows bitwise "
          "equal to plain")
    # the sum at the live rows, its (T, L) mask routed by tenant id, with
    # the unmasked sum beside it (the windowed fleet's live half)
    routed = (torch.rand((T, L), generator=gen, device=device) < 0.9) \
        .float()
    for scale in q.SCALES:
        got = q.ace_query_sum(ck, ids, base, table_mask=routed,
                              tenant_ids=tids, scale=scale,
                              with_unmasked=True)
        want = q.ace_query_sum_plain(ck, ids, base, table_mask=routed,
                                     tenant_ids=tids, scale=scale,
                                     with_unmasked=True)
        err["ace_query"] = max(err["ace_query"],
                               float((got[0] - want[0]).abs().max()))
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"ace_query_sum ({scale}) at per-item base rows, a routed "
              "(T, L) mask, with the unmasked sum: bitwise equal to plain")

    # ace_window_combine on one tenant's ring, both forms
    weights = WIN_GAMMA ** torch.arange(E, dtype=torch.float32,
                                        device=device)
    tmask = torch.ones(L, device=device)
    tmask[[3, 31]] = 0.0
    worst = 0.0
    for name, tw in (("unweighted", None),
                     ("weighted, 2 tables masked", tmask / tmask.sum())):
        sk_ = wc.ace_window_combine(ring[0], ids, weights, tw)
        sp = wc.ace_window_combine_plain(ring[0], ids, weights, tw)
        worst = max(worst, float((sk_ - sp).abs().max()))
        check(torch.equal(sk_, sp), f"ace_window_combine ({name}) bitwise "
              f"equal to plain at B={admit_b}, E={E}, L={L}, K={K}")
    err["ace_window_combine"] = worst

    # ace_fleet_score on the ring's live epochs seen as a fleet
    counts = ring[:, 0].contiguous()
    sk_ = fs.ace_fleet_score(counts, x, tids, w, cfg)
    sp = fs.ace_fleet_score_plain(counts, x, tids, w, cfg)
    ref = fs.fleet_score_from_ids(counts, ids, tids)
    same = (ids == h.srp_hash_plain(x, w, cfg)).all(dim=1)
    err["ace_fleet_score"] = float((sk_ - sp).abs().max())
    check(torch.equal(sk_, ref), "ace_fleet_score bitwise equal to the "
          "routed table-order gather of its own ids")
    check(torch.equal(sk_[same], sp[same]), f"ace_fleet_score bitwise equal "
          f"to plain on the {int(same.sum())} of {admit_b} rows whose ids "
          "agree")

    # ace_fleet_window_admit: random and colliding batches, quarantine mask
    xc = x[: admit_b // 8].repeat(8, 1).contiguous()
    tc = tids[: admit_b // 8].repeat(8).contiguous()
    pre = fwa.fleet_window_admit_from_ids(
        ring.clone(), tail, cursor, ids, tids,
        torch.full((T,), float("-inf"), device=device))[0]
    thr = torch.stack([torch.median(pre[tids == t]) for t in range(T)])
    worst = 0.0
    plan = h.device_plan(admit_b, d_model + 1, K, L, device)
    for name, qb, tb in (("random", x, tids), ("colliding", xc, tc)):
        r = ring.clone()
        out = fwa.ace_fleet_window_admit_fused(r, tail, cursor, qb, tb, w,
                                               thr, cfg, item_mask=mask)
        plain = fwa.ace_fleet_window_admit_fused_plain(
            ring.clone(), tail, cursor, qb, tb, w, thr, cfg, item_mask=mask)
        share = agreement(out[3], plain[3])
        check(share >= 0.999, f"ace_fleet_window_admit ({name}) ids agree "
              f"with plain: {share:.6f} >= 0.999")
        check(torch.equal(out[3], h.srp_hash_planned(qb, w, cfg, plan)),
              f"ace_fleet_window_admit ({name}) ids bitwise equal to "
              f"srp_hash's under the same plan ({plan.describe()})")
        r_ref = ring.clone()
        ref = (r_ref, *fwa.fleet_window_admit_from_ids(
            r_ref, tail, cursor, out[3], tb, thr, mask))
        for a, b in ((r, ref[0]), (out[1], ref[1]), (out[2], ref[2]),
                     (out[4], ref[3]), (out[5], ref[4])):
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        check(torch.equal(r, ref[0]) and torch.equal(out[1], ref[1])
              and torch.equal(out[2], ref[2]) and torch.equal(out[4], ref[3])
              and torch.equal(out[5], ref[4]),
              f"ace_fleet_window_admit ({name}) ring, scores, admit mask and "
              "both sums bitwise downstream of its own ids")
        worst = max(worst, float((out[3] - plain[3]).abs().max()))
        if name == "colliding":
            s8 = out[1].view(8, -1)
            check(torch.equal(s8, s8[:1].expand_as(s8)), "colliding copies "
                  "score alike: every windowed-fleet score is pre-insert")
    err["ace_fleet_window_admit"] = worst
    return err


def attr_operands(device, B, R, C, seed, zero=False):
    """(plane (R, C), cols (B, R) int32, signs (B, R) ±1) on the card: a
    plane with a share of empty cells (zeros, so ±0 values) or all zero."""
    gen = torch.Generator(device=device).manual_seed(seed)
    plane = torch.randn((R, C), generator=gen, device=device)
    plane[:, : C // 8] = 0.0
    if zero:
        plane.zero_()
    cols = torch.randint(0, C, (B, R), generator=gen, device=device,
                         dtype=torch.int32)
    signs = torch.where(torch.rand((B, R), generator=gen, device=device)
                        < 0.5, -1.0, 1.0)
    return plane, cols, signs


def phase_kernels_attr(mods, device, C=1 << ATTR_BITS) -> dict:
    """Phase 2 for the two kernels of ``csrc/attr_estimate.cu``:
    ``attr_estimate`` equal by value to its plain version at the
    post-mortem's B = 4097 (every leaf coordinate of d_model + 1) and at
    B = 32, odd and even R, and on an all-zero plane; ``attr_find_hh``
    bitwise its plain version (estimates equal by value, NaN to NaN) on
    phase 7's hierarchy shape (d = 4097, R = 5, C = 256, NL = 13) with the
    port's own tables, at topk = 8 and 18, on a plane with planted heavy
    coordinates, an all-zero plane and one with a NaN cell, and equal to
    the per-level composition of ``attr_estimate`` launches it replaced."""
    from repro_torch.attribution import sketch as at
    ae = mods["attr_estimate"]
    worst = 0.0
    cases = [(B, R, False) for R in (1, 2, 5, 8) for B in (32, D_MODEL + 1)]
    cases.append((D_MODEL + 1, ATTR_ROWS, True))
    for i, (B, R, zero) in enumerate(cases):
        ops_ = attr_operands(device, B, R, C, SEED + 20 + i, zero)
        k, p = ae.attr_estimate(*ops_), ae.attr_estimate_plain(*ops_)
        worst = max(worst, float((k - p).abs().max()))
        check(torch.equal(k, p), f"attr_estimate equal by value to plain at "
              f"B={B}, R={R}, C={C}" + (", all-zero plane" if zero else ""))

    acfg = at.AttrConfig(dim=D_MODEL + 1, rows=ATTR_ROWS, bits=ATTR_BITS)
    tables = at.level_tables(acfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 27)
    v = torch.randn(D_MODEL + 1, generator=gen, device=device) * 0.05
    v[list(PLANTED)] = torch.tensor([3.0, -2.5, 2.0], device=device)
    planted = at.sketch_vector(acfg, tables, v).contiguous()
    nan = planted.clone()
    nan[3, 2, 17] = float("nan")
    worst_hh = 0.0
    for what, plane in (("planted", planted),
                        ("all-zero", torch.zeros_like(planted)),
                        ("NaN cell", nan)):
        for topk in (ATTR_TOPK, 18):
            args = (plane, tables.cols, tables.signs, acfg.dim, topk)
            k, p = ae.attr_find_hh(*args), ae.attr_find_hh_plain(*args)
            old = ae.attr_find_hh_plain(*args, estimator=ae.attr_estimate)
            for name, ref in (("its plain version", p),
                              ("the per-level attr_estimate loop", old)):
                check(torch.equal(k[0], ref[0]) and torch.equal(k[2], ref[2])
                      and same_values(k[1], ref[1]),
                      f"attr_find_hh ({what} plane, topk={topk}) bitwise "
                      f"{name}")
            diff = (k[1] - p[1]).abs().nan_to_num(0.0)
            worst_hh = max(worst_hh, float(diff.max()))
            if what == "planted":
                named = set(k[0][k[2]].tolist())
                check(set(PLANTED) <= named, f"attr_find_hh (topk={topk}) "
                      f"names the planted coordinates {PLANTED}")
    return {"attr_estimate": worst, "attr_find_hh": worst_hh}


def same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal by value, NaN equal to NaN (a median of zeros may be ±0)."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


# ---------------------------------------------------------------------------
# Phase 3: AceEstimator (Algorithm 1) at the KDD-Cup99 HTTP shape.
# ---------------------------------------------------------------------------

def phase_estimator(mods, device, n=KDD_N, n_queries=N_QUERIES) -> dict:
    from repro_torch.core import sketch as sk
    from repro_torch.core.estimators import AceEstimator
    from repro_torch.core.sketch import AceConfig
    rng = np.random.default_rng(SEED + 2)
    n_out = n_queries // 100
    pts = kdd_like(n + n_queries - n_out, KDD_D, rng)   # one set of centres
    x = pts[:n]
    queries = np.concatenate([
        pts[n:], rng.normal(0.0, 1.0, size=(n_out, KDD_D)).astype(np.float32)])
    cfg = AceConfig(dim=KDD_D, num_bits=K_BITS, num_tables=L_TABLES)

    reset_launches(mods)
    est = AceEstimator(cfg, use_kernels=True, device=device)
    t0 = time.perf_counter()
    est.fit(x, batch=FIT_BATCH)
    scores = est.score(queries)
    flags = est.predict(queries, alpha=1.0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(mods)
    print(f"  estimator path: fit {n} x {KDD_D} + score/predict "
          f"{n_queries} in {secs:.3f} s (host clock); launches {launches}")

    counts = est.state.counts
    check(float(est.state.n) == n, f"n == {n}")
    check(torch.all(counts.sum(dim=1, dtype=torch.int64) == n),
          "every table's counts sum to n")
    c64 = counts.cpu().double()
    mu_ref = float((c64 * c64).sum() / (n * L_TABLES))
    mu = float(est.mu)
    check(abs(mu - mu_ref) <= 1e-5 * mu_ref,
          f"closed-form mu {mu:.6f} equals the float64 recomputation "
          f"{mu_ref:.6f} (rtol 1e-5)")
    check(scores.shape == (n_queries,) and bool(torch.isfinite(scores).all()),
          "scores finite, shape (n_queries,)")
    check(flags.shape == (n_queries,) and flags.dtype == torch.bool,
          "predict gives a bool per query")
    q_dev = torch.as_tensor(queries, device=device)
    plain = sk.batch_scores(counts, mods["srp_hash"].srp_hash_plain(
        q_dev, est.w, cfg.srp))
    share = agreement(scores, plain)
    check(share >= 0.999, f"kernel scores equal the plain hash+gather "
          f"score for {share:.6f} >= 0.999 of queries")
    inl, out = scores[:-n_out].mean(), scores[-n_out:].mean()
    print(f"  mean score inliers {float(inl):.1f}, outliers "
          f"{float(out):.1f}; flagged inliers "
          f"{float(flags[:-n_out].float().mean()):.4f}, outliers "
          f"{float(flags[-n_out:].float().mean()):.4f}")
    check(out < inl, "off-distribution queries score below inliers")
    for k in ("srp_hash", "ace_update", "ace_query", "ace_score_fused"):
        check(launches[k] > 0, f"estimator path launched {k}")
    # every fit point's row sum against the final counts, the most any
    # fit-time gather saw: below 2^24 every score is bitwise the old
    # gather + fp32 reduction's
    top = 0.0
    for i in range(0, n, 1 << 16):
        ids = mods["srp_hash"].srp_hash(
            torch.as_tensor(x[i:i + (1 << 16)], device=device), est.w,
            cfg.srp)
        top = max(top, float(mods["ace_query"].ace_query_sum(
            counts, ids, scale="sum").max()))
    print(f"  fit: largest row sum of the {n:,} points against the final "
          f"counts {top:,.0f} (2^24 = {1 << 24:,})")
    return {"launches": launches, "seconds": secs, "counts": counts,
            "buckets": mods["srp_hash"].srp_hash(
                torch.as_tensor(x[:FIT_BATCH], device=device), est.w,
                cfg.srp),
            "w": est.w}


def phase_estimator_srht(mods, device, n=SRHT_FIT_N,
                         n_queries=N_QUERIES) -> dict:
    """A shorter fit and score at the KDD shape under hash_mode="srht",
    held bitwise against the plain path on the card."""
    from repro_torch.core.estimators import AceEstimator
    from repro_torch.core.sketch import AceConfig
    rng = np.random.default_rng(SEED + 5)
    pts = kdd_like(n + n_queries, KDD_D, rng)
    x, queries = pts[:n], pts[n:]
    cfg = AceConfig(dim=KDD_D, num_bits=K_BITS, num_tables=L_TABLES,
                    hash_mode="srht")
    reset_launches(mods)
    est = AceEstimator(cfg, use_kernels=True, device=device)
    t0 = time.perf_counter()
    est.fit(x, batch=FIT_BATCH)
    scores = est.score(queries)
    sync(device)
    secs = time.perf_counter() - t0
    launches = read_launches(mods)
    print(f"  estimator path (srht): fit {n} x {KDD_D} + score {n_queries} "
          f"in {secs:.3f} s (host clock); launches {launches}")
    plain = AceEstimator(cfg, use_kernels=False, device=device, w=est.w)
    plain.fit(x, batch=FIT_BATCH)
    check(tuple(est.w.shape) == (KDD_D, 0), "W is the (d, 0) placeholder")
    check(torch.equal(est.state.counts, plain.state.counts)
          and float(est.state.n) == float(plain.state.n) == n,
          "srht estimator counts and n bitwise equal to the plain path")
    check(torch.equal(scores, plain.score(queries)),
          "srht estimator scores bitwise equal to the plain path")
    check(bool(torch.isfinite(scores).all()), "srht scores finite")
    for k in ("srht_hash", "ace_update", "ace_query"):
        check(launches[k] > 0, f"srht estimator path launched {k}")
    return {"launches": launches, "seconds": secs}


# ---------------------------------------------------------------------------
# Phase 4: the serving guardrail at d_model = 4096.
# ---------------------------------------------------------------------------

def guardrail_batches(device, d_model, admits, b, s):
    """Request embeddings (b, s, d_model) for each admit: normal traffic
    around 8 topics, one NaN row per batch, and a burst around 4 unseen
    topics in the first half of the rows of the last 4 batches."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    topics = torch.nn.functional.normalize(
        torch.randn((12, d_model), generator=gen, device=device), dim=-1)
    for i in range(admits):
        burst = i >= admits - 4
        pick = torch.randint(0, 8, (b,), generator=gen, device=device)
        if burst:
            pick[: b // 2] = 8 + pick[: b // 2] % 4
        e = topics[pick][:, None, :] + 0.02 * torch.randn(
            (b, s, d_model), generator=gen, device=device)
        e[i % b, 0, 0] = float("nan")
        yield e, burst


def phase_guardrail(mods, device, d_model=D_MODEL, admits=ADMITS,
                    b=ADMIT_B, s=ADMIT_S) -> dict:
    from repro_torch.serve.engine import Guardrail, GuardrailConfig
    gcfg = GuardrailConfig(d_model=d_model, num_bits=K_BITS,
                           num_tables=L_TABLES)
    reset_launches(mods)
    g = Guardrail(gcfg, use_kernels=True, device=device)
    masks, lat, bursts = [], [], []
    for e, burst in guardrail_batches(device, d_model, admits, b, s):
        t0 = time.perf_counter()
        masks.append(g.admit(e))                 # ends in the one transfer
        lat.append(time.perf_counter() - t0)
        bursts.append(burst)
    launches = read_launches(mods)
    print(f"  guardrail path: {admits} admits of {b} x {s} x {d_model}; "
          f"admit p50 {1e3 * statistics.median(lat):.3f} ms (host clock, "
          f"ends in the mask transfer); launches {launches}")

    # the same batches through the plain-path guardrail, on the same W
    plain = Guardrail(gcfg, use_kernels=False, device=device, w=g.w)
    plain_masks = [plain.admit(e) for e, _ in
                   guardrail_batches(device, d_model, admits, b, s)]

    m = np.stack(masks)
    nan_rows = np.zeros_like(m)
    nan_rows[np.arange(admits), np.arange(admits) % b] = True
    check(g.quarantined == admits, f"quarantined {g.quarantined} == "
          f"{admits} NaN rows")
    check(m[nan_rows].all(),
          "NaN rows answered by fail_open (admitted, not inserted)")
    inserted = int(m[~nan_rows].sum())
    check(float(g.state.n) == inserted,
          f"n == admitted finite rows ({inserted})")
    check(torch.all(g.state.counts.sum(dim=1, dtype=torch.int64)
                    == inserted), "every table's counts sum to n")
    check(bool(torch.isfinite(g.state.welford_m2)), "Welford M2 finite")
    n_after = np.cumsum((m & ~nan_rows).sum(1))
    last_warm = int(np.argmax(n_after >= gcfg.warmup_items))
    print(f"  warmup ({gcfg.warmup_items:g} items) ends after admit "
          f"{last_warm + 1}")
    burst_rows = np.zeros_like(m)
    burst_rows[np.array(bursts), : b // 2] = True
    burst_rows &= ~nan_rows
    normal = ~nan_rows & ~burst_rows
    armed = np.arange(admits)[:, None] > last_warm
    f_norm = float(m[normal & armed].mean())
    f_burst = float(m[burst_rows].mean())
    print(f"  admitted: normal rows after warmup {f_norm:.4f}, burst rows "
          f"{f_burst:.4f}")
    check(f_burst < f_norm, "burst rows admitted less often than normal rows")
    mismatch = int((np.stack(plain_masks) != m).sum())
    check(mismatch <= 0.01 * m.size, f"masks agree with the plain-path "
          f"guardrail ({mismatch} of {m.size} differ, <= 1%)")
    # The two paths hash with different fp32 summation orders (the
    # kernel's tile loop vs cuBLAS), so a projection at |proj| ~ 0 may
    # land an admitted item in another bucket of one table: hold the
    # displaced share of the n·L insertions to the hash floor.
    moved = int((g.state.counts - plain.state.counts).abs().sum()) // 2
    share = moved / max(float(plain.state.n) * L_TABLES, 1.0)
    check(share <= 0.001, f"counts equal the plain path's but for "
          f"{moved} displaced insertions ({share:.2e} <= 1e-3 of n*L)")
    if mismatch == 0:
        check(float(g.state.n) == float(plain.state.n),
              "n bitwise equal to the plain-path guardrail")
    from repro_torch.core import sketch as sk
    for name, a, p in (
            ("mu", sk.mean_mu(g.state), sk.mean_mu(plain.state)),
            ("Welford mean", g.state.welford_mean,
             plain.state.welford_mean),
            ("Welford M2", g.state.welford_m2, plain.state.welford_m2)):
        rel = abs(float(a) - float(p)) / max(abs(float(p)), 1e-30)
        tol = 1e-5 if moved == 0 else 1e-3
        check(rel <= tol, f"{name} {float(a):.6g} vs plain {float(p):.6g}: "
              f"rel {rel:.2e} <= {tol:g} ({moved} displaced insertions)")
    for k in ("ace_admit_fused", "ace_query"):
        check(launches[k] > 0, f"guardrail path launched {k}")
    e, _ = next(guardrail_batches(device, d_model, admits, b, s))
    return {"launches": launches, "p50_ms": 1e3 * statistics.median(lat),
            "guardrail": g, "breakdown": admit_breakdown(g, e, None,
                                                         device)}


# ---------------------------------------------------------------------------
# Phase 6: the windowed, fleet and windowed-fleet guardrails, then the
# arbitrary-γ window query and the fleet query on the states they built.
# ---------------------------------------------------------------------------

GUARD_KINDS = {
    "window": dict(window_epochs=WIN_E, window_decay=WIN_GAMMA,
                   rotate_every=WIN_R),
    "fleet": dict(num_tenants=FLEET_T),
    "fleet_window": dict(num_tenants=FLEET_T, window_epochs=WIN_E,
                         window_decay=WIN_GAMMA, rotate_every=WIN_R),
}


def shift_batches(device, d_model, admits, b, s, shift_at, tenants=None):
    """Request embeddings (b, s, d_model) for each admit, with their host
    tenant ids when ``tenants`` is given (every batch mixes all tenants):
    traffic around 8 topics up to admit ``shift_at``, around 4 unseen
    topics from there on, one NaN row per batch."""
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    topics = torch.nn.functional.normalize(
        torch.randn((12, d_model), generator=gen, device=device), dim=-1)
    for i in range(admits):
        lo, n = (0, 8) if i < shift_at else (8, 4)
        pick = lo + torch.randint(0, n, (b,), generator=gen, device=device)
        e = topics[pick][:, None, :] + 0.02 * torch.randn(
            (b, s, d_model), generator=gen, device=device)
        e[i % b, 0, 0] = float("nan")
        tids = None if tenants is None \
            else ((np.arange(b) + i) % tenants).astype(np.int32)
        yield e, tids


def phase_shift_guardrail(mods, device, kind, d_model=D_MODEL,
                          admits=SHIFT_ADMITS, b=ADMIT_B, s=ADMIT_S) -> dict:
    from repro_torch.serve.engine import Guardrail, GuardrailConfig
    gcfg = GuardrailConfig(d_model=d_model, num_bits=K_BITS,
                           num_tables=L_TABLES, **GUARD_KINDS[kind])
    T = gcfg.num_tenants if gcfg.num_tenants > 1 else None
    windowed = gcfg.window_epochs > 1

    def batches():
        return shift_batches(device, d_model, admits, b, s, SHIFT_AT, T)
    reset_launches(mods)
    g = Guardrail(gcfg, use_kernels=True, device=device)
    masks, lat = [], []
    for e, t in batches():
        t0 = time.perf_counter()
        masks.append(g.admit(e, t))                 # ends in the one transfer
        lat.append(time.perf_counter() - t0)
    launches = read_launches(mods)
    p50 = 1e3 * statistics.median(lat)
    print(f"  guardrail ({kind}): {admits} admits of {b} x {s} x {d_model}, "
          f"K={K_BITS}, L={L_TABLES}, {gcfg}; admit p50 {p50:.3f} ms (host "
          f"clock, ends in the mask transfer); launches {launches}")
    plain = Guardrail(gcfg, use_kernels=False, device=device, w=g.w)
    plain_masks = [plain.admit(e, t) for e, t in batches()]

    m = np.stack(masks)
    nan_rows = np.zeros_like(m)
    nan_rows[np.arange(admits), np.arange(admits) % b] = True
    check(g.quarantined == admits, f"quarantined {g.quarantined} == "
          f"{admits} NaN rows")
    check(m[nan_rows].all(),
          "NaN rows answered by fail_open (admitted, not inserted)")
    st = g.state
    check(torch.all(st.counts.sum(dim=-1, dtype=torch.int64)
                    == st.n[..., None].long()),
          "every table of every epoch/tenant sums to its n")
    mismatch = int((np.stack(plain_masks) != m).sum())
    check(mismatch <= 0.01 * m.size, f"masks agree with the plain-path "
          f"guardrail ({mismatch} of {m.size} differ, <= 1%)")
    moved = int((st.counts - plain.state.counts).abs().sum()) // 2
    share = moved / max(float(plain.state.n.sum()) * L_TABLES, 1.0)
    check(share <= 0.001, f"counts equal the plain path's but for {moved} "
          f"displaced insertions ({share:.2e} <= 1e-3 of n*L)")
    if windowed:
        check(torch.equal(st.cursor, plain.state.cursor)
              and torch.equal(st.tick, plain.state.tick),
              f"cursors {st.cursor.tolist()} and ticks equal the plain "
              "path's")
        check(int(st.tick.min()) == admits, f"every clock ticked {admits} "
              "times (every batch held every tenant)")
        want = admits // WIN_R % WIN_E
        check(torch.all(st.cursor == want), f"every ring rotated on the "
              f"admit that filled an epoch (cursor {want})")
    tol = 1e-5 if moved == 0 else 1e-3
    for name in ("welford_mean", "welford_m2") + (("ssq",) if windowed
                                                  else ()):
        a, p = getattr(st, name), getattr(plain.state, name)
        rel = float((a - p).abs().max()) / max(float(p.abs().max()), 1e-30)
        check(rel <= tol, f"{name} within rtol {tol:g} of the plain path "
              f"({rel:.2e}; {moved} displaced insertions)")

    normal = ~nan_rows
    pre = normal[SHIFT_AT - 4:SHIFT_AT]
    post = normal[-4:]
    f_pre = float(m[SHIFT_AT - 4:SHIFT_AT][pre].mean())
    f_post = float(m[-4:][post].mean())
    f_new = float(m[SHIFT_AT:SHIFT_AT + 4][normal[SHIFT_AT:SHIFT_AT + 4]]
                  .mean())
    print(f"  admitted: before the shift {f_pre:.4f}, first 4 admits after "
          f"it {f_new:.4f}, last 4 admits {f_post:.4f}")
    check(f_pre > 0.7, "the armed guardrail admits its own traffic")
    check(f_new < 0.2, "the new regime is rejected right after the shift")
    if windowed:
        check(f_post > 0.8, f"the stale regime aged out within "
              f"{WIN_E} x {WIN_R} admits: the new regime is admitted again")
    else:
        check(f_post < 0.2, "without a window the new regime stays "
              "rejected (the stale regime pins mu/sigma)")
    path = ("ace_fleet_window_admit", "ace_query") if kind == "fleet_window" \
        else ("srp_hash", "ace_query", "ace_update")
    for k in path:
        check(launches[k] > 0, f"guardrail ({kind}) path launched {k}")
    e, t = next(batches())
    breakdown = admit_breakdown(g, e, t, device)
    return {"launches": launches, "p50_ms": p50, "guardrail": g,
            "breakdown": breakdown}


@contextlib.contextmanager
def gather_then_reduce():
    """``ace_query_sum`` replaced, inside the block, by the composition
    each ``ops`` call site took before it: the (B, L) ``ace_query``
    gather, then PyTorch's reductions and scaling — to trace a path's
    device ops both ways in one run."""
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import ace_query as q
    real = q.ace_query_sum

    def composed(counts, buckets, row_base=None, *, table_mask=None,
                 tenant_ids=None, scale="mean", with_unmasked=False):
        g = q.ace_query(counts, buckets, row_base)
        if table_mask is None:
            if scale == "sum":
                return torch.sum(g, dim=-1)
            return torch.sum(g, dim=-1) * sk.reciprocal(g.shape[1])
        maskf = table_mask.to(torch.float32)
        if maskf.dim() == 2:
            maskf = maskf[tenant_ids.long()]
        s = torch.sum(g * maskf, dim=-1)
        nh = torch.clamp_min(torch.sum(maskf, dim=-1), 1.0)
        if scale == "mean":
            s = s * (1.0 / nh)
        return (s, torch.sum(g, dim=-1)) if with_unmasked else s
    q.ace_query_sum = composed
    try:
        yield
    finally:
        q.ace_query_sum = real


def device_trace(fn, device) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time (ends in a
    sync), the device's busy time and ops, the top device ops by time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [x for x in prof.events()
               if x.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(x.time_range.elapsed_us() for x in kernels)
    by_name: dict[str, float] = {}
    for x in kernels:
        by_name[x.name] = by_name.get(x.name, 0.0) \
            + x.time_range.elapsed_us()
    return {"profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3, "device_ops": len(kernels),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:5]}


def traced_both_ways(what, fn, device) -> dict:
    """``device_trace`` of ``fn`` as it runs, then, after one untraced
    call, with the (B, L) gather and PyTorch's reductions in place of
    ``ace_query_sum``; prints both.  Each is traced twice and the trace
    with more device ops kept: a trace can miss device events (PERF.md,
    PR 17), never invent them."""
    def fuller(a, b):
        return a if a["device_ops"] >= b["device_ops"] else b
    tr = fuller(device_trace(fn, device), device_trace(fn, device))
    with gather_then_reduce():
        fn()
        sync(device)
        old = fuller(device_trace(fn, device), device_trace(fn, device))
    if not tr["device_ops"]:
        print(f"  {what} under torch.profiler: no device op in the trace; "
              "device idle share not measured")
    else:
        print(f"  {what} under torch.profiler: wall "
              f"{tr['profiled_wall_ms']:.3f} ms, {tr['device_ops']} device "
              f"ops, device busy {tr['device_busy_ms']:.3f} ms (idle share "
              f"{1 - tr['device_busy_ms'] / tr['profiled_wall_ms']:.3f}); "
              "top: " + ", ".join(f"{n[:40]} {v / 1e3:.3f} ms"
                                  for n, v in tr["top"]))
        print(f"  {what} with the (B, L) gather + PyTorch reductions in "
              f"place of ace_query_sum: {old['device_ops']} device ops, "
              f"device busy {old['device_busy_ms']:.3f} ms, wall "
              f"{old['profiled_wall_ms']:.3f} ms")
    out = {k: v for k, v in tr.items() if k != "top"}
    out.update({f"{k}_gather_then_reduce": v for k, v in old.items()
                if k != "top"})
    return out


def admit_breakdown(g, e, t, device) -> dict:
    """One admit traced both ways (``traced_both_ways``)."""
    g.admit(e, t)
    sync(device)
    return traced_both_ways("one admit", lambda: g.admit(e, t), device)


def phase_queries(mods, device, gw, gf, b=ADMIT_B) -> dict:
    """Path 6: ``ops.ace_window_score`` on the windowed guardrail's ring at
    its own γ and at another, and ``ops.ace_fleet_score`` on the fleet
    guardrail's tables, for one batch of the post-shift traffic."""
    from repro_torch.data.pipeline import mean_embed_features
    from repro_torch.fleet import state as fl
    from repro_torch.kernels import ops
    from repro_torch.window import ring
    wc = mods["ace_window_combine"]
    for e, tids in shift_batches(device, D_MODEL, SHIFT_AT + 1, b, ADMIT_S,
                                 SHIFT_AT, FLEET_T):
        pass                            # the first batch after the shift
    feat = mean_embed_features(e, gw.gcfg.bias_const)
    feat = torch.where(torch.isfinite(feat).all(-1)[:, None], feat, 0.0)
    tids = torch.as_tensor(tids, device=device)
    ids = mods["srp_hash"].srp_hash(feat, gw.w, gw.ace_cfg.srp)
    reset_launches(mods)
    own = ops.ace_window_score(gw.state, ids, WIN_GAMMA)
    other = ops.ace_window_score(gw.state, ids, 0.5)
    fscores = ops.ace_fleet_score(gf.state, feat, tids, gf.w, gf.ace_cfg)
    launches = read_launches(mods)
    print(f"  queries: ace_window_score x 2 (gamma {WIN_GAMMA} and 0.5) and "
          f"ace_fleet_score on {b} rows; launches {launches}")
    for gamma, got in ((WIN_GAMMA, own), (0.5, other)):
        wts = ring.epoch_weights(gw.state.cursor, WIN_E, gamma)
        check(torch.equal(got, wc.ace_window_combine_plain(
            gw.state.counts, ids, wts)), f"ace_window_score (gamma {gamma}) "
            "bitwise equal to the plain combine")
        ref = ring.score_windowed(gw.state, ids, gamma)
        rel = float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                    1e-30)
        check(rel <= 1e-6, f"ace_window_score (gamma {gamma}) equals "
              f"ring.score_windowed within rtol 1e-6 ({rel:.2e})")
    hot = ring.score_combined(gw.state, ids)
    rel = float((own - hot).abs().max()) / max(float(hot.abs().max()), 1e-30)
    check(rel <= 1e-5, f"at the ring's own gamma the E-way combine equals "
          f"the tail + live hot path within rtol 1e-5 ({rel:.2e})")
    fids = mods["srp_hash"].srp_hash(feat, gf.w, gf.ace_cfg.srp)
    check(torch.equal(fscores, fl.fleet_scores(gf.state, tids, fids)),
          "ace_fleet_score bitwise equal to fleet_scores of the same ids")
    check(bool(torch.isfinite(fscores).all()) and fscores.shape == (b,),
          "fleet scores finite, shape (B,)")
    for k in ("ace_window_combine", "ace_fleet_score"):
        check(launches[k] > 0, f"query path launched {k}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 5: the data filter through the chunked stream runner, d_model 4096.
# ---------------------------------------------------------------------------

def stream_features(device, d_model, chunks, T, B):
    """(chunks * T, B, d_model + 1) float32 feature rows, made on the card
    and brought to the host once (set-up): unit-norm rows around 8 topics
    plus the 0.25 bias coordinate, one NaN row a step, and in the last two
    chunks a quarter of each step's rows around 4 unseen topics.  Returns
    (host array, burst-row mask (steps, B))."""
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    topics = torch.nn.functional.normalize(
        torch.randn((12, d_model), generator=gen, device=device), dim=-1)
    steps = chunks * T
    pick = torch.randint(0, 8, (steps, B), generator=gen, device=device)
    burst = torch.zeros((steps, B), dtype=torch.bool, device=device)
    burst[(chunks - 2) * T:, : B // 4] = True
    pick = torch.where(burst, 8 + pick % 4, pick)
    f = topics[pick] + 0.005 * torch.randn((steps, B, d_model),
                                           generator=gen, device=device)
    f = torch.nn.functional.normalize(f, dim=-1)
    feats = torch.cat([f, torch.full((steps, B, 1), 0.25, device=device)],
                      dim=-1)
    idx = torch.arange(steps, device=device)
    feats[idx, idx % B, 0] = float("nan")
    return feats.cpu().numpy(), burst.cpu().numpy()


def stream_filter(kind, device, d_model, use_kernels=True, **extra):
    """The filter of one stream run: ``AceDataFilter`` in the "dense" or
    "srht" hash family, ``WindowedAceFilter`` ("window") or
    ``FleetDataFilter`` ("fleet"), each at its defaults but ``extra``."""
    from repro_torch.data.pipeline import AceDataFilter
    from repro_torch.fleet.filter import FleetDataFilter
    from repro_torch.window.filter import WindowedAceFilter
    kw = dict(d_model=d_model, use_kernels=use_kernels, device=device,
              **extra)
    if kind == "window":
        return WindowedAceFilter(**kw, rotate_every=STREAM_R)
    if kind == "fleet":
        return FleetDataFilter(**kw, num_tenants=FLEET_T)
    return AceDataFilter(**kw, hash_mode=kind)


def state_leaves(state) -> dict:
    return {k: v for k, v in zip(state._fields, state) if v is not None}


def instrumented_run(mods, runner, device, feats, tids, T):
    """``runner.run`` over the host features (and tenant ids) as a user
    drives it, after one unrecorded chunk on a throw-away state (so the
    timed run pays no first-call costs): every host-device transfer
    counted, ``consume`` under sync-debug "error" (any host sync inside
    raises), the launch counts set to 0 just before and read just after.
    Returns (state, w, summaries, seconds, launches, transfers)."""
    import repro_torch.stream.runner as runner_mod
    transfers = {"h2d": 0, "d2h": 0}
    real_in, real_out, real_consume = (runner_mod._to_device,
                                       runner_mod._to_host, runner.consume)

    def to_device(x, dev):
        transfers["h2d"] += 1
        return real_in(x, dev)

    def to_host(x):
        transfers["d2h"] += 1
        return real_out(x)

    def consume_no_sync(*a, **k):
        if device.type != "cuda":
            return real_consume(*a, **k)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_consume(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    runner_mod._to_device, runner_mod._to_host = to_device, to_host
    runner.consume = consume_no_sync
    try:
        s0, w = runner.init()
        runner.consume(s0, w, torch.as_tensor(feats[:T], device=device),
                       None if tids is None
                       else torch.as_tensor(tids[:T], device=device))
        sync(device)
        transfers.update(h2d=0, d2h=0)
        state, w = runner.init()
        sync(device)
        reset_launches(mods)
        t0 = time.perf_counter()
        state, sums = runner.run(state, w, iter(feats),
                                 None if tids is None else iter(tids))
        secs = time.perf_counter() - t0          # ends in the last D2H
        launches = read_launches(mods)
    finally:
        runner_mod._to_device, runner_mod._to_host = real_in, real_out
        runner.consume = real_consume
    return state, w, sums, secs, launches, transfers


def phase_stream(mods, device, kind, d_model=D_MODEL, chunks=STREAM_CHUNKS,
                 T=STREAM_T, B=STREAM_B) -> dict:
    import repro_torch.stream.runner as runner_mod
    from repro_torch.window import ring
    feats, burst = stream_features(device, d_model, chunks, T, B)
    steps = chunks * T
    tids = None
    if kind == "fleet":    # every batch mixes all tenants
        tids = np.random.default_rng(SEED + 9).integers(
            0, FLEET_T, size=(steps, B)).astype(np.int32)
    filt = stream_filter(kind, device, d_model)
    runner = runner_mod.StreamRunner(filt, chunk_T=T)
    state, w, sums, secs, launches, transfers = instrumented_run(
        mods, runner, device, feats, tids, T)

    def chunk_ids(c):
        return None if tids is None else torch.as_tensor(
            tids[c * T:(c + 1) * T], device=device)

    items = chunks * T * B
    print(f"  stream path ({kind}): {chunks} chunks of {T} x {B} x "
          f"{d_model + 1}; {items / secs:,.0f} items/s ({secs:.3f} s, host "
          f"clock, ends in the last summary transfer); launches {launches}")
    check(len(sums) == chunks, f"{chunks} chunk summaries")
    check(transfers == {"h2d": chunks, "d2h": chunks},
          f"one H2D and one D2H per chunk ({transfers})")
    check(all(int(x.quarantined) == T for x in sums),
          "quarantined == 1 per step in every chunk")

    # the same features step by step: kernel path (bitwise), plain path
    dev_feats = torch.as_tensor(feats, device=device)
    dev_tids = None if tids is None else torch.as_tensor(tids, device=device)
    plain_f = stream_filter(kind, device, d_model, use_kernels=False)
    seq, plain = filt.init()[0], plain_f.init()[0]
    keep_k, keep_p, n_lo, n_hi = [], [], [], []
    for t in range(steps):
        n_lo.append(float(seq.n.min()) if kind == "fleet"
                    else float(seq.n.sum()))
        n_hi.append(float(seq.n.max()) if kind == "fleet" else n_lo[-1])
        extra = () if tids is None else (dev_tids[t],)
        seq, kk, _ = filt.step(seq, w, dev_feats[t], *extra)
        plain, kp, _ = plain_f.step(plain, w, dev_feats[t], *extra)
        if kind == "window" and (t + 1) % STREAM_R == 0:
            seq = ring.maybe_rotate(seq, STREAM_R, filt.decay)
            plain = ring.maybe_rotate(plain, STREAM_R, filt.decay)
        keep_k.append(kk)
        keep_p.append(kp)
    got, want = state_leaves(state), state_leaves(seq)
    check(got.keys() == want.keys()
          and all(torch.equal(got[k], want[k]) for k in got),
          f"chunked run equals the sequential loop of step: every state leaf "
          f"bitwise ({', '.join(got)})")
    keep_k, keep_p = torch.stack(keep_k), torch.stack(keep_p)
    agree = agreement(keep_k, keep_p)
    if kind == "srht":
        check(all(torch.equal(getattr(state, k), getattr(plain, k))
                  for k in ("counts", "n", "welford_mean", "welford_m2"))
              and torch.equal(keep_k, keep_p),
              "srht kernel path equals the plain path bitwise (counts, n, "
              "Welford, keep masks)")
    else:
        moved = int((state.counts - plain.counts).abs().sum()) // 2
        share = moved / max(float(plain.n.sum()) * filt.num_tables, 1.0)
        check(agree >= 0.999 and share <= 1e-3,
              f"dense kernel path within the ids floor of the plain path: "
              f"keep masks agree {agree:.6f} >= 0.999, {moved} displaced "
              f"insertions ({share:.2e} <= 1e-3 of n*L)")
    if kind == "window":
        check(int(state.tick) == steps
              and int(state.cursor) == (steps // STREAM_R) % filt.num_epochs,
              f"the ring rotated every {STREAM_R} steps inside the chunks: "
              f"tick {int(state.tick)}, cursor {int(state.cursor)}")

    # cold: every tenant in warmup; armed: every tenant past it
    cold = np.array(n_hi) < filt.warmup_items
    armed = np.array(n_lo) >= filt.warmup_items
    burst_steps = burst.any(axis=1)
    for c, x in enumerate(sums):
        st = c * T + x.topk_step
        check(not (x.topk_valid & cold[st]).any(),
              f"chunk {c}: no valid top-k row in warmup")
    anom = np.concatenate([x.anom_counts for x in sums]) - 1   # NaN rows
    normal_rate = float(anom[~burst_steps & armed].mean()) / B
    burst_rate = float(anom[burst_steps].mean()) / B
    print(f"  flagged per step: normal {normal_rate:.4f}, burst steps "
          f"{burst_rate:.4f} (a quarter of their rows are burst rows); "
          f"steps with a tenant in warmup {int((~armed).sum())}")
    check(burst_rate > normal_rate + 0.1, "the burst is flagged")
    for x in sums[-2:]:
        rows = x.topk_item[x.topk_valid]
        check(x.topk_valid.all() and (rows < B // 4).all(),
              "burst chunks: every top-k row is a valid burst row")
    if kind == "fleet":
        check(all(int(x.per_tenant_items.sum()) == T * B for x in sums),
              "fleet summaries: per-tenant item counts add up to the chunk")
    path = {"dense": ("ace_admit_fused", "ace_query"),
            "srht": ("srht_hash", "ace_query", "ace_update")}.get(
                kind, ("srp_hash", "ace_query", "ace_update"))
    for k in path:
        check(launches[k] > 0, f"stream path ({kind}) launched {k}")
    breakdown = stream_breakdown(runner, seq, w, feats[:T], device,
                                 chunk_ids(0))
    return {"launches": launches, "items_per_s": items / secs,
            "seconds": secs, "breakdown": breakdown}


def stream_breakdown(runner, state, w, batches, device,
                     tids=None) -> dict:
    """Where one chunk's time goes: the host clock of each stage of
    ``run`` (each ends in a sync), and ``consume`` traced both ways
    (``traced_both_ways``) for the device's busy time and op count."""
    import repro_torch.stream.runner as runner_mod
    t = [time.perf_counter()]
    stacked = np.stack(list(batches))
    t.append(time.perf_counter())
    chunk = runner_mod._to_device(stacked, device)
    sync(device)
    t.append(time.perf_counter())
    state, summary = runner.consume(state, w, chunk, tids)
    sync(device)
    t.append(time.perf_counter())
    runner.fetch(summary)
    t.append(time.perf_counter())
    ms = dict(zip(("stack", "h2d", "consume", "fetch"),
                  (1e3 * (b - a) for a, b in zip(t, t[1:]))))
    print(f"  one chunk, host clock: stack {ms['stack']:.2f} ms, H2D "
          f"{ms['h2d']:.2f} ms, consume {ms['consume']:.2f} ms, summary "
          f"fetch {ms['fetch']:.2f} ms")
    return {**ms, **traced_both_ways(
        "consume", lambda: runner.consume(state, w, chunk, tids), device)}


# ---------------------------------------------------------------------------
# Phase 7: heavy-hitter attribution through the stream runner, d_model 4096.
# ---------------------------------------------------------------------------

def attack_stream(device, d_model=D_MODEL, chunks=STREAM_CHUNKS, T=STREAM_T,
                  B=STREAM_B):
    """Phase 5's stream (``stream_features``) with an attack in its last
    two chunks: rows B/4 … B/4 + 63 of each step carry their energy on the
    three PLANTED coordinates only (unit norm, the bias kept) — the
    scenario of ``examples/drift_postmortem.py`` at full width.  Fleet
    tenant ids as phase 5's, the attack rows routed to OFFENDER.  Returns
    (features, tenant ids), both on the host."""
    feats, _ = stream_features(device, d_model, chunks, T, B)
    late = slice((chunks - 2) * T, None)
    rows = slice(B // 4, B // 4 + ATTACK_ROWS)
    att = feats[late, rows]
    att[..., :d_model] = 0.0
    att[..., list(PLANTED)] = 1.0 / np.sqrt(len(PLANTED))
    tids = np.random.default_rng(SEED + 9).integers(
        0, FLEET_T, size=(chunks * T, B)).astype(np.int32)
    tids[late, rows] = OFFENDER
    return feats, tids


def phase_attribution(mods, device, kind, feats, tids, base_items_per_s,
                      T=STREAM_T, B=STREAM_B) -> dict:
    """One filter with attribution through ``StreamRunner.run`` (the main
    path, launches counted), then the same stream through the plain path,
    the heavy-hitter checks and the post-mortem batch query."""
    import repro_torch.stream.runner as runner_mod
    from repro_torch.attribution import sketch as at
    tids = tids if kind == "fleet" else None
    filt = stream_filter(kind, device, D_MODEL, **ATTR_KW)
    runner = runner_mod.StreamRunner(filt, chunk_T=T, topk=ATTR_TOPK)
    state, w, sums, secs, launches, transfers = instrumented_run(
        mods, runner, device, feats, tids, T)
    chunks = len(feats) // T
    items = chunks * T * B
    print(f"  attribution ({kind}): {chunks} chunks of {T} x {B} x "
          f"{D_MODEL + 1}; {items / secs:,.0f} items/s with attribution, "
          f"{base_items_per_s:,.0f} without (phase 5) ({secs:.3f} s, host "
          f"clock); launches {launches}")
    check(len(sums) == chunks and transfers == {"h2d": chunks,
                                                 "d2h": chunks},
          f"one H2D and one D2H per chunk, hh_* fields included "
          f"({transfers})")
    acfg = filt.ace_cfg.attr
    check(launches["attr_find_hh"] == chunks
          and launches["attr_estimate"] == 0,
          f"attribution ({kind}): one attr_find_hh launch a chunk "
          f"({launches['attr_find_hh']} in {chunks} chunks) and no "
          f"attr_estimate launch on the stream ({launches['attr_estimate']})")
    last = sums[-1]
    named = sorted(last.hh_coord[last.hh_valid].tolist())
    print(f"  last chunk: hh_coord {last.hh_coord.tolist()}, hh_valid "
          f"{last.hh_valid.astype(int).tolist()}, hh_est "
          f"{np.round(last.hh_est, 5).tolist()}")
    check(set(PLANTED) <= set(named), f"attribution ({kind}): the last "
          f"chunk's valid heavy hitters name the planted coordinates "
          f"{PLANTED}")
    if kind == "fleet":
        print(f"  hh_tenant {last.hh_tenant.tolist()}, hh_tenant_est "
              f"{np.round(last.hh_tenant_est, 5).tolist()}")
        check(int(last.hh_tenant[0]) == OFFENDER,
              f"the fleet's hh_tenant[0] is the offender, tenant {OFFENDER}")

    # the plain path on the same stream and the same tables
    plain_f = stream_filter(kind, device, D_MODEL, use_kernels=False,
                            **ATTR_KW)
    check(plain_f.attr_tables is filt.attr_tables,
          "kernel and plain filters share one set of attribution tables")
    pr = runner_mod.StreamRunner(plain_f, chunk_T=T, topk=ATTR_TOPK)
    pstate, psums = pr.run(pr.init()[0], w, iter(feats),
                           None if tids is None else iter(tids))
    same = all(np.array_equal(a.hh_coord, b.hh_coord)
               and np.array_equal(a.hh_valid, b.hh_valid)
               for a, b in zip(sums, psums))
    est_err = max(float(np.max(np.abs(a.hh_est - b.hh_est)
                               / np.maximum(np.abs(b.hh_est), 1e-30)))
                  for a, b in zip(sums, psums))
    scale = float(pstate.attr.abs().max())
    plane_err = float((state.attr - pstate.attr).abs().max())
    print(f"  kernel vs plain path: hh_est largest relative difference "
          f"{est_err:.3e}, planes largest difference {plane_err:.3e} "
          f"(largest magnitude {scale:.3e})")
    check(same, f"attribution ({kind}): kernel path's hh_coord and "
          "hh_valid equal the plain path's in every chunk")
    check(est_err <= 1e-4, "hh_est within rtol 1e-4 of the plain path")
    check(torch.allclose(state.attr, pstate.attr, rtol=1e-5,
                         atol=1e-5 * scale),
          "planes within rtol 1e-5, atol 1e-5 x max|plane| of the plain "
          "path")

    # the post-mortem batch query: every coordinate of the anomaly channel
    # (the fleet's offender; the ring's epochs summed)
    plane = {"fleet": lambda a: a[OFFENDER, 1],
             "window": lambda a: a.sum(0)[1]}.get(kind, lambda a: a[1])(
        state.attr).contiguous()
    coords = torch.arange(D_MODEL + 1, dtype=torch.int32, device=device)
    reset_launches(mods)
    est = at.estimate(acfg, filt.attr_tables, plane, coords)
    sync(device)
    post = read_launches(mods)
    check(post["attr_estimate"] == 1 and sum(post.values()) == 1,
          "the post-mortem query is one attr_estimate launch")
    plain_est = at.estimate(acfg, filt.attr_tables, plane, coords,
                            use_kernels=False)
    check(torch.equal(est, plain_est), "post-mortem estimates of all "
          f"{D_MODEL + 1} coordinates equal by value to the plain version")
    top4 = set(torch.topk(est, 4).indices.tolist())
    check(set(PLANTED) <= top4, f"the planted coordinates rank in the top "
          f"4 of the anomaly channel's estimates ({sorted(top4)}; the "
          "fourth may be the bias coordinate every row carries)")
    breakdown = stream_breakdown(
        runner, state, w, feats[:T], device,
        None if tids is None else torch.as_tensor(tids[:T], device=device))
    # the last (attacked) chunk's drift hierarchy, and its drill-down and
    # its consume traced with one launch and with the per-level loop
    last = torch.as_tensor(np.stack(list(feats[-T:])), device=device)
    last_tids = None if tids is None else torch.as_tensor(tids[-T:],
                                                          device=device)
    drift = drift_plane(runner, state, w, last, last_tids)
    ae = mods["attr_estimate"]
    args = (drift, filt.attr_tables.cols, filt.attr_tables.signs, acfg.dim,
            ATTR_TOPK)
    k, p = ae.attr_find_hh(*args), ae.attr_find_hh_plain(*args)
    check(torch.equal(k[0], p[0]) and torch.equal(k[2], p[2])
          and same_values(k[1], p[1]), f"attribution ({kind}): "
          "attr_find_hh bitwise its plain version on the attacked chunk's "
          "drift hierarchy")
    breakdown.update(find_hh_both_ways(kind, runner, state, w, last,
                                       last_tids, drift, device))
    return {"launches": launches, "items_per_s": items / secs,
            "seconds": secs, "breakdown": breakdown, "filter": filt,
            "state": state, "drift_plane": drift,
            "postmortem_launches": post}


@contextlib.contextmanager
def per_level_find_hh():
    """``ops.attr_find_hh`` replaced, inside the block, by the drill-down
    each chunk ran before it: the plain loop with one ``attr_estimate``
    launch a level and its small PyTorch ops around each — to trace a
    path's device ops both ways in one run."""
    from repro_torch.kernels import attr_estimate as ae
    from repro_torch.kernels import ops
    real = ops.attr_find_hh

    def per_level(plane, cols, signs, dim, topk):
        return ae.attr_find_hh_plain(plane, cols, signs, dim, topk,
                                     estimator=ops.attr_estimate)
    ops.attr_find_hh = per_level
    try:
        yield
    finally:
        ops.attr_find_hh = real


def drift_plane(runner, state, w, chunk, tids) -> torch.Tensor:
    """The (NL, R, C) drift hierarchy that ``find_hh`` gets in one
    ``consume`` of ``chunk``."""
    from repro_torch.kernels import ops
    seen = []
    real = ops.attr_find_hh

    def record(plane, *args):
        seen.append(plane.clone())
        return real(plane, *args)
    ops.attr_find_hh = record
    try:
        runner.consume(state, w, chunk, tids)
    finally:
        ops.attr_find_hh = real
    return seen[-1]


def find_hh_both_ways(kind, runner, state, w, chunk, tids, drift,
                      device) -> dict:
    """Device ops of one ``find_hh`` on ``drift`` and of one attribution
    ``consume`` of ``chunk``, each traced with the one-launch drill-down
    and with the per-level loop in its place (``per_level_find_hh``); each
    trace taken twice (``find_hh`` alone, a single launch, five times) and
    the fuller kept (a trace can miss events, and missed the lone launch
    in both of two traces once).  The consume should lose the loop's ops
    minus the one launch."""
    from repro_torch.attribution import sketch as at
    acfg, tables = runner.filt.ace_cfg.attr, runner.filt.attr_tables

    def fuller(fn, tries=2):
        return max((device_trace(fn, device) for _ in range(tries)),
                   key=lambda t: t["device_ops"])

    def hh():
        return at.find_hh(acfg, tables, drift, runner.topk)

    def cons():
        return runner.consume(state, w, chunk, tids)
    new_hh, new_c = fuller(hh, 5), fuller(cons)
    with per_level_find_hh():
        hh(), cons()
        sync(device)
        old_hh, old_c = fuller(hh), fuller(cons)
    print(f"  attribution ({kind}) under torch.profiler: find_hh alone "
          f"{new_hh['device_ops']} device op(s), busy "
          f"{new_hh['device_busy_ms']:.5f} ms, against "
          f"{old_hh['device_ops']} ops, busy {old_hh['device_busy_ms']:.5f} "
          f"ms for the per-level loop; one consume {new_c['device_ops']} "
          f"device ops (busy {new_c['device_busy_ms']:.3f} ms) against "
          f"{old_c['device_ops']} (busy {old_c['device_busy_ms']:.3f} ms) "
          f"with the loop: {old_c['device_ops'] - new_c['device_ops']} "
          f"fewer, the loop's {old_hh['device_ops']} minus "
          f"{new_hh['device_ops']} predicted")
    return {"find_hh_device_ops": new_hh["device_ops"],
            "find_hh_device_ops_per_level": old_hh["device_ops"],
            "find_hh_busy_ms": new_hh["device_busy_ms"],
            "find_hh_busy_ms_per_level": old_hh["device_busy_ms"],
            "consume_device_ops": new_c["device_ops"],
            "consume_device_ops_per_level": old_c["device_ops"],
            "consume_busy_ms": new_c["device_busy_ms"],
            "consume_busy_ms_per_level": old_c["device_busy_ms"]}


# ---------------------------------------------------------------------------
# Phase 8: timing on the card.
# ---------------------------------------------------------------------------

def device_ms(fn, reps: int = 30, inner: int = 10) -> float:
    """Median over ``reps`` of the device time of ``inner`` back-to-back
    calls, per call, from CUDA events.  A device-side sleep queued first
    keeps the card busy while the host enqueues the calls, so the events
    time the kernels and not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def time_dense_hash(h, where, x, w, cfg) -> dict:
    """``srp_hash`` at one shape: the kernel under its plan and under every
    other cluster size the depth allows, the plain version, and cuBLAS's
    fp32 projection alone (``torch.matmul(x, w[:, :K·L])``, TF32 off) as a
    yardstick (no one PyTorch call also signs and packs)."""
    B, d = x.shape
    K, L, KL = cfg.num_bits, cfg.num_tables, cfg.num_projections
    plan = h.device_plan(B, d, K, L, x.device)
    splits_ms = {}
    for s in range(1, min(h.MAX_SPLITS, -(-d // h.SLICE)) + 1):
        other = h.make_plan(B, d, K, L, plan.tables, s)
        splits_ms[s] = device_ms(
            lambda: h.srp_hash_planned(x, w, cfg, other))
    r = dict(
        ms=device_ms(lambda: h.srp_hash(x, w, cfg)),
        plain_ms=device_ms(lambda: h.srp_hash_plain(x, w, cfg)),
        matmul_ms=device_ms(lambda: torch.matmul(x, w[:, :KL])),
        library_ms=None, plan=plan.describe(), splits_ms=splits_ms,
        shape=f"{where} B={B}, d={d}, K={K}, L={L}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(2 * B * d * KL, 4 * (B * d + d * KL + B * L)))))
    print(f"  srp_hash {r['shape']} ({r['plan']}): kernel {r['ms']:.5f} ms "
          f"(S: " + ", ".join(f"{k} {v:.5f}" for k, v in splits_ms.items())
          + f"), plain {r['plain_ms']:.5f}, cuBLAS projection "
          f"{r['matmul_ms']:.5f}, bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    return r


def time_admit(a, where, counts, q, w, thresh, cfg, mask) -> dict:
    """``ace_admit_fused`` at one shape on a copy of ``counts``: bound by
    the hash's operations against q, W, the counters it gathers and the
    ones its admitted rows insert, the ids, scores and verdicts."""
    B, d = q.shape
    K, L, KL = cfg.num_bits, cfg.num_tables, cfg.num_projections
    nb = 1 << K
    c = counts.clone()
    _, _, adm, ab = a.ace_admit_fused(c, q, w, thresh, cfg, item_mask=mask)
    Ua = distinct_counters(ab, nb)
    Uins = distinct_counters(ab[adm], nb) if bool(adm.any()) else 0
    r = dict(
        ms=device_ms(lambda: a.ace_admit_fused(c, q, w, thresh, cfg,
                                               item_mask=mask)),
        plain_ms=device_ms(lambda: a.ace_admit_fused_plain(
            c, q, w, thresh, cfg, item_mask=mask)),
        matmul_ms=device_ms(lambda: torch.matmul(q, w[:, :KL])),
        library_ms=None,
        plan=a.device_plan(B, d, K, L, q.device).describe(),
        shape=f"{where} B={B}, d={d}, K={K}, L={L}, admitted "
              f"{int(adm.sum())}",
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * B * d * KL + B * L,
            4 * (B * d + d * KL) + 4 * Ua + 2 * 4 * Uins
            + 4 * B * L + 4 * B + 2 * B + 4))))
    print(f"  ace_admit_fused {r['shape']} ({r['plan']}): kernel "
          f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f}, cuBLAS projection "
          f"{r['matmul_ms']:.5f}, bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    return r


def phase_timing(mods, device, est, guard) -> tuple:
    from repro_torch.core.srp import SrpConfig, make_projections
    h, u, q, a = (mods[k] for k in ("srp_hash", "ace_update", "ace_query",
                                    "ace_admit_fused"))
    L, nb = L_TABLES, 1 << K_BITS
    out = {}

    # the fit's shapes: one batch of 4096 KDD-like rows
    cfg = SrpConfig(dim=KDD_D, num_bits=K_BITS, num_tables=L)
    x = torch.as_tensor(kdd_like(FIT_BATCH, KDD_D,
                                 np.random.default_rng(SEED + 1)),
                        device=device)
    w = est["w"]
    B, d, KL = FIT_BATCH, KDD_D, K_BITS * L
    buckets = est["buckets"]
    U = distinct_counters(buckets, nb)
    counts = guard["guardrail"].state.counts.clone()
    rows = torch.arange(L, device=device)[None, :].expand(B, L)
    b64 = buckets.long()
    # the guardrail's shapes: B=256 features of d_model + 1 = 4097
    g = guard["guardrail"]
    acfg = g.ace_cfg.srp
    e, _ = next(guardrail_batches(device, D_MODEL, ADMITS, ADMIT_B, ADMIT_S))
    from repro_torch.data.pipeline import mean_embed_features
    feat = mean_embed_features(e, g.gcfg.bias_const)
    finite = torch.all(torch.isfinite(feat), dim=-1)
    feat = torch.where(finite[:, None], feat, 0.0).contiguous()
    from repro_torch.core import sketch as sk
    thresh = sk.admit_threshold(g.state, g.gcfg.alpha, g.gcfg.warmup_items)
    # the dense hash at each shape its main-path launches run at: the
    # fit, the windowed and fleet admits, the stream step; and the card's
    # cluster capacity its plans follow
    clusters = h.device_clusters(device)
    print(f"  clusters of S = 1..8 blocks the card runs at once, two blocks "
          f"an SM: {clusters} (the CPU tests' stand-in: "
          f"{h.H100_CLUSTERS})")
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    scfg = SrpConfig(dim=D_MODEL + 1, num_bits=STREAM_K,
                     num_tables=STREAM_L, seed=47)
    sw = make_projections(scfg, device=device)
    sx = torch.randn((STREAM_B, D_MODEL + 1), generator=gen, device=device)
    hashes = [time_dense_hash(h, "fit", x, w, cfg),
              time_dense_hash(h, "admit", feat, g.w, acfg),
              time_dense_hash(h, "stream step", sx, sw, scfg)]
    out["srp_hash"] = {**hashes[-1], "by_shape": hashes}

    out.update(time_update_and_srht(u, mods["srht_hash"], device))
    # ace_query: the one-launch sum (the score's scale) against its plain
    # version, the (B, L) gather + torch.sum + multiply it replaces, the
    # gather alone and one library call of the same mean (embedding_bag
    # over a float copy of the counts, made outside the timing)
    recip = torch.tensor(1.0 / L, dtype=torch.float32)
    counts_f = counts.float().view(-1, 1)
    flat_ids = rows * nb + b64
    out["ace_query"] = dict(
        ms=device_ms(lambda: q.ace_query_sum(counts, buckets)),
        plain_ms=device_ms(lambda: q.ace_query_sum_plain(counts, buckets)),
        library_ms=device_ms(lambda: torch.nn.functional.embedding_bag(
            flat_ids, counts_f, mode="mean")),
        old_sequence_ms=device_ms(
            lambda: torch.sum(q.ace_query(counts, buckets), dim=-1) * recip),
        gather_ms=device_ms(lambda: q.ace_query(counts, buckets)),
        gather_library_ms=device_ms(lambda: counts[rows, b64]),
        shape=f"B={B}, L={L}, 2^K={nb}, distinct counters {U}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(0, 4 * B * L + 4 * B + 4 * U))))
    print(f"  ace_query_sum {out['ace_query']['shape']}: one launch "
          f"{out['ace_query']['ms']:.5f} ms against the (B, L) gather + "
          f"torch.sum + multiply {out['ace_query']['old_sequence_ms']:.5f} "
          f"ms (the gather alone {out['ace_query']['gather_ms']:.5f}, "
          f"counts[rows, ids] {out['ace_query']['gather_library_ms']:.5f})")
    c2 = counts.clone()

    # the admission at the guardrails' shape and at the dense stream
    # step's (K = 13, L = 32: counts from the stream's own ids, a
    # threshold that admits about half)
    sc = torch.zeros((STREAM_L, 1 << STREAM_K), dtype=torch.int32,
                     device=device)
    u.ace_update(sc, h.srp_hash(sx, sw, scfg))
    u.ace_update(sc, h.srp_hash(torch.randn(sx.shape, generator=gen,
                                            device=device), sw, scfg))
    srows = torch.arange(STREAM_L, device=device)[None, :]
    sthresh = torch.median(sc[srows, h.srp_hash(sx, sw, scfg).long()]
                           .float().sum(-1) / STREAM_L)
    admits = [time_admit(a, "admit", c2, feat, g.w, thresh, acfg, finite),
              time_admit(a, "stream step", sc, sx, sw, sthresh, scfg,
                         torch.ones(STREAM_B, dtype=torch.bool,
                                    device=device))]
    out["ace_admit_fused"] = {**admits[-1], "by_shape": admits}

    # ace_score_fused at the estimator's score shape, on its fitted counts:
    # the kernel, unweighted and weighted, against the composition it
    # matches bitwise (srp_hash + ace_query_sum), in turns
    f, sh = mods["ace_score_fused"], mods["srht_hash"]
    qs = torch.as_tensor(kdd_like(N_QUERIES, KDD_D,
                                  np.random.default_rng(SEED + 4)),
                         device=device)
    ec = est["counts"]
    Us = distinct_counters(h.srp_hash(qs, w, cfg), nb)
    B3 = N_QUERIES
    tmask = torch.ones(L, device=device)
    tmask[[3, 31]] = 0.0
    tw = tmask / tmask.sum()
    order = [("composition", lambda: q.ace_query_sum(ec, h.srp_hash(qs, w,
                                                                    cfg))),
             ("kernel", lambda: f.ace_score_fused(ec, qs, w, cfg)),
             ("weighted", lambda: f.ace_score_fused(ec, qs, w, cfg,
                                                    table_weights=tw))]
    runs = {k: [] for k, _ in order}
    for k, fn in order + order[::-1]:
        runs[k].append(device_ms(fn))
    mean = {k: statistics.mean(v) for k, v in runs.items()}
    out["ace_score_fused"] = dict(
        ms=mean["kernel"],
        plain_ms=device_ms(lambda: f.ace_score_fused_plain(ec, qs, w, cfg)),
        library_ms=None, composition_ms=mean["composition"],
        weighted_ms=mean["weighted"], runs=runs,
        shape=f"B={B3}, d={KDD_D}, K={K_BITS}, L={L}, distinct counters "
              f"{Us}",
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * B3 * KDD_D * KL + B3 * L,
            4 * (B3 * KDD_D + KDD_D * KL) + 4 * Us + 4 * B3))))
    print(f"  ace_score_fused  {out['ace_score_fused']['shape']}: "
          f"kernel {mean['kernel']:.5f} ms, "
          f"weighted {mean['weighted']:.5f} ms, "
          f"srp_hash + ace_query_sum {mean['composition']:.5f} ms "
          f"(each the mean of two medians taken in turns: {runs})")

    # hash_mode="auto": both hash kernels at the benchmark corners
    from repro_torch.core.srht import choose_hash_mode
    from repro_torch.core.srp import make_projections
    auto = {}
    for d in AUTO_DIMS:
        dcfg = SrpConfig(dim=d, num_bits=K_BITS, num_tables=L)
        hcfg = SrpConfig(dim=d, num_bits=K_BITS, num_tables=L,
                         hash_mode="srht")
        wd = make_projections(dcfg, device=device)
        xd = torch.randn((AUTO_B, d), generator=torch.Generator(
            device=device).manual_seed(d), device=device)
        dense_ms = device_ms(lambda: h.srp_hash(xd, wd, dcfg))
        srht_ms = device_ms(lambda: sh.srht_hash(xd, hcfg))
        winner = "srht" if srht_ms < dense_ms else "dense"
        pick = choose_hash_mode(SrpConfig(dim=d, num_bits=K_BITS,
                                          num_tables=L, hash_mode="auto"))
        auto[d] = dict(dense_ms=dense_ms, srht_ms=srht_ms, winner=winner,
                       auto_picks=pick)
        print(f"  auto corner d={d}, B={AUTO_B}, K={K_BITS}, L={L}: "
              f"srp_hash {dense_ms:.5f} ms, srht_hash {srht_ms:.5f} ms; "
              f"measured winner {winner}, auto picks {pick}")
    for d, a in auto.items():
        # a pick that is not the winner is allowed only in a near tie:
        # auto must never cost more than 25% over the faster family
        picked = a[f"{a['auto_picks']}_ms"]
        best = min(a["dense_ms"], a["srht_ms"])
        check(picked <= 1.25 * best, f"hash_mode='auto' at d={d} picks "
              f"{a['auto_picks']} ({picked:.5f} ms), within 25% of the "
              f"measured winner {a['winner']} ({best:.5f} ms)")
    for k, v in out.items():
        lib = "null" if v["library_ms"] is None else f"{v['library_ms']:.5f}"
        print(f"  {k:16s} {v['shape']}: kernel {v['ms']:.5f} ms, plain "
              f"{v['plain_ms']:.5f} ms, library {lib} ms, bound "
              f"{v['bound_ms']:.5f} ms ({v['bound_by']}), "
              f"{100 * v['bound_ms'] / v['ms']:.1f}% of bound")
    return out, auto


def phase_timing_windows_fleets(mods, device, gw, gf, gfw) -> dict:
    """The three kernels of the windowed and fleet paths at the shapes of
    phase 6, on the states its guardrails built: B = 256 queries of
    d_model + 1 = 4097, K = 15, L = 50, E = 4, T = 8."""
    from repro_torch.data.pipeline import mean_embed_features
    from repro_torch.fleet import window as fw
    from repro_torch.window import ring
    wc, fs, fwa = (mods[k] for k in ("ace_window_combine", "ace_fleet_score",
                                     "ace_fleet_window_admit"))
    L, nb = L_TABLES, 1 << K_BITS
    for e, tids in shift_batches(device, D_MODEL, SHIFT_ADMITS, ADMIT_B,
                                 ADMIT_S, SHIFT_AT, FLEET_T):
        pass        # the last batch: the regime the windows now admit
    feat = mean_embed_features(e, gw.gcfg.bias_const)
    finite = torch.isfinite(feat).all(-1)
    feat = torch.where(finite[:, None], feat, 0.0).contiguous()
    tids = torch.as_tensor(tids, device=device)
    B, d = feat.shape
    KL = K_BITS * L
    out = {}

    ids = mods["srp_hash"].srp_hash(feat, gw.w, gw.ace_cfg.srp)
    wts = ring.epoch_weights(gw.state.cursor, WIN_E, WIN_GAMMA)
    counts = gw.state.counts
    Uw = WIN_E * distinct_counters(ids, nb)
    out["ace_window_combine"] = dict(
        ms=device_ms(lambda: wc.ace_window_combine(counts, ids, wts)),
        plain_ms=device_ms(lambda: wc.ace_window_combine_plain(counts, ids,
                                                               wts)),
        library_ms=None, shape=f"B={B}, E={WIN_E}, L={L}, 2^K={nb}, "
        f"counters touched {Uw}",
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * B * WIN_E * L, 4 * B * L + 4 * Uw + 4 * WIN_E + 4 * B))))

    fc = gf.state.counts
    fids = mods["srp_hash"].srp_hash(feat, gf.w, gf.ace_cfg.srp)
    table_rows = mods["ace_update"].table_rows
    rows = table_rows(fids, tids.long() * L)
    Uf = int(torch.unique(rows * nb + fids.long()).numel())
    out["ace_fleet_score"] = dict(
        ms=device_ms(lambda: fs.ace_fleet_score(fc, feat, tids, gf.w,
                                                gf.ace_cfg.srp)),
        plain_ms=device_ms(lambda: fs.ace_fleet_score_plain(
            fc, feat, tids, gf.w, gf.ace_cfg.srp)),
        library_ms=None, shape=f"B={B}, d={d}, T={FLEET_T}, K={K_BITS}, "
        f"L={L}, counters touched {Uf}",
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * B * d * KL + B * L,
            4 * (B * d + d * KL) + 4 * B + 4 * Uf + 4 * B))))

    st = gfw.state
    cfg = gfw.ace_cfg
    thr = fw.window_admit_thresholds(st, WIN_GAMMA, gfw.gcfg.alpha,
                                     gfw.gcfg.warmup_items)
    ring_c = st.counts.clone()
    _, _, adm, aids, _, _ = fwa.ace_fleet_window_admit_fused(
        ring_c.clone(), st.tail, st.cursor, feat, tids, gfw.w, thr, cfg.srp,
        item_mask=finite)
    t = tids.long()
    tail_rows = table_rows(aids, t * L)
    live_rows = table_rows(aids, (t * WIN_E + st.cursor.long()[t]) * L)
    Ut = int(torch.unique(tail_rows * nb + aids.long()).numel())
    Ul = int(torch.unique(live_rows * nb + aids.long()).numel())
    Ui = int(torch.unique((live_rows * nb + aids.long())[adm]).numel()) \
        if bool(adm.any()) else 0
    out["ace_fleet_window_admit"] = dict(
        ms=device_ms(lambda: fwa.ace_fleet_window_admit_fused(
            ring_c, st.tail, st.cursor, feat, tids, gfw.w, thr, cfg.srp,
            item_mask=finite)),
        plain_ms=device_ms(lambda: fwa.ace_fleet_window_admit_fused_plain(
            ring_c, st.tail, st.cursor, feat, tids, gfw.w, thr, cfg.srp,
            item_mask=finite)),
        library_ms=None, shape=f"B={B}, d={d}, T={FLEET_T}, E={WIN_E}, "
        f"K={K_BITS}, L={L}, admitted {int(adm.sum())}",
        plan=mods["srp_hash"].device_plan(B, d, K_BITS, L, device)
        .describe(),
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * B * d * KL + 3 * B * L,
            4 * (B * d + d * KL) + 4 * Ut + 4 * Ul + 2 * 4 * Ui
            + 4 * B * L + 4 * 4 * B + 2 * B + 8 * FLEET_T))))
    for k, v in out.items():
        print(f"  {k:16s} {v['shape']}: kernel {v['ms']:.5f} ms, plain "
              f"{v['plain_ms']:.5f} ms, library null, bound "
              f"{v['bound_ms']:.5f} ms ({v['bound_by']}), "
              f"{100 * v['bound_ms'] / v['ms']:.1f}% of bound")
    return out


def phase_timing_attr(mods, device, attr) -> dict:
    """The two kernels of ``csrc/attr_estimate.cu`` on the attribution
    phase's own state and tables (the SRHT filter: R = 5, C = 256,
    NL = 13).  ``attr_estimate`` on the anomaly channel at the beam's
    B = 2·W = 32 children of one level and at B = 4097, the post-mortem
    query of every leaf coordinate; bound: the (B, R) columns and signs
    read, the (B,) estimates written and each plane cell touched read
    once, against the B·R sign multiplies.  ``attr_find_hh``, one whole
    drill-down at topk = 8 on the last chunk's drift hierarchy, against
    the per-level composition it replaced (the plain loop with one
    ``attr_estimate`` launch a level) and its plain version; bound: the
    table entries of the 2W children of each of the NL − 1 levels and the
    distinct plane cells they name read once (``find_hh_touched``), the
    outputs written once, against one sign multiply an entry."""
    ae = mods["attr_estimate"]
    filt, state = attr["filter"], attr["state"]
    acfg, tables = filt.ace_cfg.attr, filt.attr_tables
    lvl = acfg.num_levels - 1
    plane = state.attr[1, lvl].contiguous()
    R, C = plane.shape
    out = {}
    for B in (2 * max(2 * ATTR_TOPK, 8), D_MODEL + 1):
        nodes = torch.arange(B, device=device)
        cols = tables.cols[lvl][nodes].contiguous()
        signs = tables.signs[lvl][nodes].contiguous()
        rows = torch.arange(R, device=device)[None, :]
        U = int(torch.unique(rows * C + cols.long()).numel())
        bound_ms, bound_by = bound(B * R, 4 * (2 * B * R + B + U))
        out[B] = dict(
            ms=device_ms(lambda: ae.attr_estimate(plane, cols, signs)),
            plain_ms=device_ms(lambda: ae.attr_estimate_plain(plane, cols,
                                                              signs)),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            shape=f"B={B}, R={R}, C={C}, plane cells touched {U}")
        v = out[B]
        print(f"  attr_estimate    {v['shape']}: kernel {v['ms']:.5f} ms, "
              f"plain {v['plain_ms']:.5f} ms, library none (no one call: "
              f"gather, sign and median), bound {v['bound_ms']:.3g} ms "
              f"({v['bound_by']}), {100 * v['bound_ms'] / v['ms']:.1f}% of "
              "bound")
    beam, leaves = out.values()

    drift, nl = attr["drift_plane"], acfg.num_levels
    args = (drift, tables.cols, tables.signs, acfg.dim, ATTR_TOPK)
    W = ae.beam_width(ATTR_TOPK)
    entries, cells = find_hh_touched(ae, args)
    hh_bound = bound(entries, 4 * cells + 8 * entries + 9 * ATTR_TOPK)
    # one drill-down between the events (inner=1): the per-level loop is
    # ~320 device ops whose enqueue (~4 ms) the queued sleep then covers,
    # so the events time the device's work and not the host's; in turns
    order = [("kernel", lambda: ae.attr_find_hh(*args)),
             ("per_level", lambda: ae.attr_find_hh_plain(
                 *args, estimator=ae.attr_estimate))]
    runs = {k: [] for k, _ in order}
    for k, fn in order + order[::-1]:
        runs[k].append(device_ms(fn, inner=1))
    # the same launch with the plane read from global memory at every
    # level, the layout find_hh_layout picks where the plane does not fit
    layout = ae.find_hh_layout
    ae.find_hh_layout = lambda *a: (False, layout(*a)[1])
    try:
        unstaged_ms = device_ms(order[0][1])
    finally:
        ae.find_hh_layout = layout
    hh = dict(ms=device_ms(order[0][1]), unstaged_ms=unstaged_ms,
              one_call_ms=statistics.mean(runs["kernel"]),
              old_composition_ms=statistics.mean(runs["per_level"]),
              plain_ms=device_ms(lambda: ae.attr_find_hh_plain(*args),
                                 inner=1),
              library_ms=None, runs=runs,
              **dict(zip(("bound_ms", "bound_by"), hh_bound)),
              shape=f"d={acfg.dim}, NL={nl}, R={R}, C={C}, topk="
                    f"{ATTR_TOPK} (W={W}), the drift hierarchy, table "
                    f"entries read {entries}, plane cells touched {cells}")
    print(f"  attr_find_hh     {hh['shape']}: {hh['ms']:.5f} ms a launch "
          f"back to back ({unstaged_ms:.5f} ms with the plane read from "
          f"global memory); one call alone {hh['one_call_ms']:.5f} ms against "
          f"the per-level attr_estimate loop "
          f"{hh['old_composition_ms']:.5f} ms (each the mean of two medians "
          f"taken in turns: {runs}), plain {hh['plain_ms']:.5f} ms, bound "
          f"{hh['bound_ms']:.3g} ms ({hh['bound_by']}), "
          f"{100 * hh['bound_ms'] / hh['ms']:.2f}% of bound")
    return {"attr_estimate": {**beam, "at_post_mortem": leaves},
            "attr_find_hh": hh}


def find_hh_touched(ae, args) -> tuple[int, int]:
    """(table entries, distinct plane cells) that one drill-down on
    ``args`` reads: the (2W, R) entries of each level the beam descends
    and the cells of that level they name, from the plain loop's own
    per-level calls.  The leaf ranking reuses the last level's estimates,
    so its call (the last) reads nothing new when NL > 1."""
    calls = []

    def record(plane, cols, signs):
        R, C = plane.shape
        rows = torch.arange(R, device=cols.device)[None, :]
        cells = rows * C + torch.clamp(cols.long(), 0, C - 1)
        calls.append((cols.numel(), int(torch.unique(cells).numel())))
        return ae.attr_estimate_plain(plane, cols, signs)
    ae.attr_find_hh_plain(*args, estimator=record)
    if len(calls) > 1:
        calls.pop()
    return sum(e for e, _ in calls), sum(u for _, u in calls)


def fit_ids(device) -> torch.Tensor:
    """The ids of the estimator's first fit batch (phase 3's data and
    W): 4096 clustered rows at K = 15, L = 50, hashed by the plain dense
    hash, so they are the same bits in every checkout on one card."""
    from repro_torch.core.srp import (SrpConfig, make_projections,
                                      pack_buckets, srp_bits)
    pts = kdd_like(KDD_N + N_QUERIES - N_QUERIES // 100, KDD_D,
                   np.random.default_rng(SEED + 2))
    cfg = SrpConfig(dim=KDD_D, num_bits=K_BITS, num_tables=L_TABLES)
    x = torch.as_tensor(pts[:FIT_BATCH], device=device)
    return pack_buckets(srp_bits(x, make_projections(cfg, device=device),
                                 cfg), cfg)


def time_update_and_srht(u, sh, device) -> dict:
    """``ace_update`` and ``srht_hash`` (the modules ``u`` and ``sh``, of
    this checkout or another one's) at the main path's shapes, on inputs
    made here from SEED, so two checkouts time the same work.

    ``ace_update``: the fit (the estimator's first batch, K = 15, L = 50,
    clustered: a few hundred hot counters) into five fresh zeroed tables,
    its time the median of the five; the windowed and fleet admits' insert
    (B = 256, L = 50, 2^15, a fleet of 8 tenants' stacked rows at tid·L,
    90% of rows admitted); the SRHT stream step's masked insert (B = 512,
    L = 32, 2^13, 90% kept).  Library: one ``index_put_(accumulate=True)``.
    ``srht_hash``: the stream step (B = 512, d = 4097, K = 13, L = 32), the
    SRHT fit (B = 4096, d = 36, K = 15, L = 50) and the ``"auto"`` corner
    d = 64 (B = 256, K = 15, L = 50)."""
    from repro_torch.core.srp import (SrpConfig, make_projections,
                                      pack_buckets, srp_bits)
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    out = {}

    def update_case(where, ids, R, nb, mask=None, base=None, buffers=1):
        B, L = ids.shape
        rows = torch.arange(L, device=device)[None, :].expand(B, L)
        if base is not None:
            rows = rows + base.long()[:, None]
        sel = slice(None) if mask is None else mask
        U = int(torch.unique(rows[sel] * nb + ids[sel].long()).numel())
        tables = [torch.zeros((R, nb), dtype=torch.int32, device=device)
                  for _ in range(buffers)]
        times = [device_ms(lambda c=c: u.ace_update(c, ids, mask, base))
                 for c in tables]
        ones = (torch.ones_like(ids) if mask is None
                else mask.to(torch.int32)[:, None].expand(B, L))
        c = tables[0]
        r = dict(
            ms=statistics.median(times), copies_ms=times,
            plain_ms=device_ms(lambda: u.ace_update_plain(c, ids, mask,
                                                          base)),
            library_ms=device_ms(lambda: c.index_put_(
                (rows, ids.long()), ones, accumulate=True)),
            shape=f"{where} B={B}, L={L}, R={R}, 2^K={nb}"
                  + ("" if mask is None else f", {int(mask.sum())} rows in")
                  + f", distinct counters {U}",
            **dict(zip(("bound_ms", "bound_by"),
                       bound(B * L, 4 * B * L + 2 * 4 * U
                             + (0 if mask is None else B)
                             + (0 if base is None else 4 * B)))))
        print(f"  ace_update {r['shape']}: kernel {r['ms']:.5f} ms"
              + ("" if buffers == 1 else " (median of " + ", ".join(
                  f"{t:.5f}" for t in times) + f" into {buffers} fresh "
                  "tables)")
              + f", plain {r['plain_ms']:.5f}, index_put_ "
              f"{r['library_ms']:.5f}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of "
              "bound")
        return r

    def dense_ids(B, d, K, L, seed):
        cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed)
        x = torch.randn((B, d), generator=gen, device=device)
        return pack_buckets(srp_bits(x, make_projections(cfg, device=device),
                                     cfg), cfg)

    nb = 1 << K_BITS
    updates = [update_case("fit", fit_ids(device), L_TABLES, nb,
                           buffers=5)]
    ids = dense_ids(ADMIT_B, D_MODEL + 1, K_BITS, L_TABLES, 41)
    tid = torch.randint(0, FLEET_T, (ADMIT_B,), generator=gen,
                        device=device, dtype=torch.int32)
    keep = torch.rand((ADMIT_B,), generator=gen, device=device) < 0.9
    updates.append(update_case("admit", ids, FLEET_T * L_TABLES, nb, keep,
                               (tid * L_TABLES).contiguous()))
    ids = dense_ids(STREAM_B, D_MODEL + 1, STREAM_K, STREAM_L, 47)
    keep = torch.rand((STREAM_B,), generator=gen, device=device) < 0.9
    updates.append(update_case("stream step", ids, STREAM_L, 1 << STREAM_K,
                               keep))
    out["ace_update"] = {**updates[0], "by_shape": updates}

    hashes = []
    for where, B, d, K, L in (
            ("stream step", STREAM_B, D_MODEL + 1, STREAM_K, STREAM_L),
            ("fit", FIT_BATCH, KDD_D, K_BITS, L_TABLES),
            ("auto corner", AUTO_B, AUTO_DIMS[0], K_BITS, L_TABLES)):
        cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=29,
                        hash_mode="srht")
        x = torch.randn((B, d), generator=gen, device=device)
        r = dict(
            ms=device_ms(lambda: sh.srht_hash(x, cfg)),
            plain_ms=device_ms(lambda: sh.srht_hash_plain(x, cfg)),
            library_ms=None,
            shape=f"{where} B={B}, d={d}, d_pad "
                  f"{sh.srht_params(cfg).d_pad}, K={K}, L={L}",
            **dict(zip(("bound_ms", "bound_by"), srht_bound(B, d, cfg))))
        print(f"  srht_hash {r['shape']}: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of "
              "bound")
        hashes.append(r)
    out["srht_hash"] = {**hashes[0], "by_shape": hashes}
    return out


def time_query_paths(device) -> dict:
    """``ops.ace_query``, ``ops.ace_update`` and ``ops.ace_fleet_admit_at``
    (T = 8, every item admitted) at the fit, admit and stream-step shapes,
    and the fused windowed-fleet admission at phase 6's shape (T = 8,
    E = 4), through whichever ``repro_torch`` is first on the path, on
    inputs made here from SEED: so two checkouts time the same work
    (``scripts/kernel_ab.py``), each call's device time whatever kernels
    and PyTorch ops it runs."""
    from repro_torch.core import sketch as sk
    from repro_torch.core.srp import make_projections
    from repro_torch.fleet import state as fl
    from repro_torch.kernels import ace_fleet_window_admit as fwa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    out = {k: {"by_shape": []} for k in ("ops.ace_query", "ops.ace_update",
                                         "ops.ace_fleet_admit_at")}
    for where, B, d, K, L in (
            ("fit", FIT_BATCH, KDD_D, K_BITS, L_TABLES),
            ("admit", ADMIT_B, D_MODEL + 1, K_BITS, L_TABLES),
            ("stream step", STREAM_B, D_MODEL + 1, STREAM_K, STREAM_L)):
        cfg = sk.AceConfig(dim=d, num_bits=K, num_tables=L, seed=53)
        w = make_projections(cfg.srp, device=device)
        x = torch.randn((B, d), generator=gen, device=device)
        ids = fit_ids(device) if where == "fit" else torch.randint(
            0, 1 << K, (B, L), generator=gen, device=device,
            dtype=torch.int32)
        state = ops.ace_update(sk.init(cfg, device), ids, cfg)
        fstate = fl.init(fl.FleetConfig(ace=cfg, num_tenants=FLEET_T),
                         device)
        tids = (torch.arange(B, device=device) % FLEET_T).to(torch.int32)
        thr = torch.full((B,), float("-inf"), device=device)
        shape = f"{where}: B={B}, d={d}, K={K}, L={L}"
        for k, fn in (
                ("ops.ace_query", lambda: ops.ace_query(state, ids)),
                ("ops.ace_update", lambda: ops.ace_update(state, ids, cfg)),
                ("ops.ace_fleet_admit_at", lambda: ops.ace_fleet_admit_at(
                    fstate, x, tids, w, cfg, thr))):
            out[k]["by_shape"].append({"shape": shape, "ms": device_ms(fn)})
    T, E, B, d, K, L = FLEET_T, WIN_E, ADMIT_B, D_MODEL + 1, K_BITS, L_TABLES
    cfg = sk.AceConfig(dim=d, num_bits=K, num_tables=L, seed=41)
    w = make_projections(cfg.srp, device=device)
    x = torch.randn((B, d), generator=gen, device=device)
    ring = torch.randint(0, 9, (T, E, L, 1 << K), generator=gen,
                         device=device, dtype=torch.int32)
    tail = torch.randint(0, 40, (T, L, 1 << K), generator=gen,
                         device=device).float() * 0.9
    cursor = torch.randint(0, E, (T,), generator=gen, device=device,
                           dtype=torch.int32)
    tids = (torch.arange(B, device=device) % T).to(torch.int32)
    thr = torch.full((T,), 40.0, device=device)
    out["ace_fleet_window_admit_fused"] = {"by_shape": [{
        "shape": f"B={B}, d={d}, T={T}, E={E}, K={K}, L={L}",
        "ms": device_ms(lambda: fwa.ace_fleet_window_admit_fused(
            ring, tail, cursor, x, tids, w, thr, cfg.srp))}]}
    return out


def time_public_paths(device) -> dict:
    """``attribution.find_hh`` at phase 7's hierarchy (d = 4097, R = 5,
    C = 256, topk = 8, a sketch with three planted coordinates) and
    ``ops.ace_score`` at the estimator's score shape (B = 16,384, d = 36,
    K = 15, L = 50, counts of the fit's first batch; unweighted and with
    two tables masked), through whichever ``repro_torch`` is first on the
    path, on inputs made here from SEED: two checkouts time the same work
    through the same public functions (``scripts/kernel_ab.py``)."""
    from repro_torch.attribution import sketch as at
    from repro_torch.core import sketch as sk
    from repro_torch.core.srp import make_projections
    from repro_torch.kernels import ops
    acfg = at.AttrConfig(dim=D_MODEL + 1, rows=ATTR_ROWS, bits=ATTR_BITS)
    tables = at.level_tables(acfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    v = torch.randn(D_MODEL + 1, generator=gen, device=device) * 0.05
    v[list(PLANTED)] = 3.0
    plane = at.sketch_vector(acfg, tables, v).contiguous()
    cfg = sk.AceConfig(dim=KDD_D, num_bits=K_BITS, num_tables=L_TABLES)
    w = make_projections(cfg.srp, device=device)
    state = ops.ace_update(sk.init(cfg, device), fit_ids(device), cfg)
    qs = torch.as_tensor(kdd_like(N_QUERIES, KDD_D,
                                  np.random.default_rng(SEED + 4)),
                         device=device)
    tmask = torch.ones(L_TABLES, device=device)
    tmask[[3, 31]] = 0.0
    shape = f"B={N_QUERIES}, d={KDD_D}, K={K_BITS}, L={L_TABLES}"
    return {
        "attribution.find_hh": {"by_shape": [{
            "shape": f"d={acfg.dim}, R={ATTR_ROWS}, C={acfg.width}, "
                     f"topk={ATTR_TOPK}",
            "ms": device_ms(lambda: at.find_hh(acfg, tables, plane,
                                               ATTR_TOPK))}]},
        "ops.ace_score": {"by_shape": [
            {"shape": shape, "ms": device_ms(
                lambda: ops.ace_score(state, qs, w, cfg))},
            {"shape": f"{shape}, 2 tables masked", "ms": device_ms(
                lambda: ops.ace_score(state, qs, w, cfg,
                                      table_mask=tmask))}]}}


def srht_bound(B: int, d: int, cfg):
    """The SRHT's bound: its adds, sign flips and sampled compares at the
    add rate against x, the signs, the row sample and the ids in bytes."""
    from repro_torch.core.srht import next_pow2
    d_pad = next_pow2(max(d, 2))
    log2 = d_pad.bit_length() - 1
    m = cfg.num_projections
    ops = B * (2 * d_pad * log2 + 2 * d_pad + m)
    nbytes = 4 * B * d + 2 * 4 * d_pad + 4 * m + 4 * B * cfg.num_tables
    t_ops, t_bytes = ops / PEAK_FP32_ADDS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    mods = import_port()
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain hash
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    print("phase 1: build")
    t0 = time.perf_counter()
    build.build_all()
    for name in build.sources():
        build.load(name)
    print(f"  built and loaded {len(build.sources())} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in sorted(build.build_log.items()):
        for line in log.splitlines():
            if any(w in line.lower() for w in ("registers", "spill",
                                               "error")):
                print(f"  [{name}] {line.strip()}")
    card = card_line()
    print(f"  card: {card}")

    print("phase 2: kernels against their plain versions on the card")
    err = phase_kernels(mods, device)
    for k, v in phase_kernels_windows_fleets(mods, device).items():
        err[k] = max(err.get(k, 0.0), v)
    err.update(phase_kernels_attr(mods, device))
    print("phase 3: AceEstimator path")
    paths = {"estimator": phase_estimator(mods, device),
             "estimator_srht": phase_estimator_srht(mods, device)}
    print("phase 4: Guardrail path")
    paths["guardrail"] = phase_guardrail(mods, device)
    print("phase 5: stream paths (AceDataFilter, WindowedAceFilter, "
          "FleetDataFilter + StreamRunner)")
    for kind in ("dense", "srht", "window", "fleet"):
        paths[f"stream_{kind}"] = phase_stream(mods, device, kind)
    print("phase 6: windowed, fleet and windowed-fleet guardrails; window "
          "and fleet queries")
    for kind in GUARD_KINDS:
        paths[f"guardrail_{kind}"] = phase_shift_guardrail(mods, device,
                                                           kind)
    paths["queries"] = phase_queries(
        mods, device, paths["guardrail_window"]["guardrail"],
        paths["guardrail_fleet"]["guardrail"])
    print("phase 7: heavy-hitter attribution (AceDataFilter under SRHT, "
          "FleetDataFilter, WindowedAceFilter + StreamRunner)")
    feats, tids = attack_stream(device)
    for kind in ATTR_KINDS:
        paths[f"attribution_{kind}"] = phase_attribution(
            mods, device, kind, feats, tids,
            paths[f"stream_{kind}"]["items_per_s"])
        paths[f"postmortem_{kind}"] = {
            "launches": paths[f"attribution_{kind}"]["postmortem_launches"]}
    del feats
    print("phase 8: timing (CUDA events, median of 30)")
    times, _ = phase_timing(mods, device, paths["estimator"],
                            paths["guardrail"])
    times.update(phase_timing_windows_fleets(
        mods, device, *(paths[f"guardrail_{k}"]["guardrail"]
                        for k in GUARD_KINDS)))
    times.update(phase_timing_attr(mods, device, paths["attribution_srht"]))
    for k, v in {**time_query_paths(device),
                 **time_public_paths(device)}.items():
        print(f"  {k}: " + "; ".join(f"{r['shape']} {r['ms']:.5f} ms"
                                     for r in v["by_shape"]))

    gathers = sum(r["launches"]["ace_query_gather"] for r in paths.values())
    check(gathers == 0, "no main path launched the (B, L) ace_query gather "
          f"({gathers}): every gather-and-reduce is one ace_query_sum")
    kernels = []
    for name in LINE_KERNELS:
        by_path = {p: r["launches"][name] for p, r in paths.items()}
        launches = sum(by_path.values())
        check(launches > 0, f"{name} launched on the main paths ({launches})")
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCES[name]}.cu",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "launches_by_path": by_path,
            **{k: t[k] for k in ("matmul_ms", "plan", "by_shape",
                                 "copies_ms", "at_post_mortem",
                                 "old_sequence_ms", "gather_ms",
                                 "gather_library_ms", "old_composition_ms",
                                 "composition_ms",
                                 "weighted_ms", "runs", "one_call_ms",
                                 "unstaged_ms")
                 if k in t}})
    print(f"end to end (host clock): estimator fit + score + predict "
          f"{paths['estimator']['seconds']:.3f} s; srht estimator fit + "
          f"score {paths['estimator_srht']['seconds']:.3f} s; guardrail "
          f"admit p50 {paths['guardrail']['p50_ms']:.3f} ms (windowed "
          f"{paths['guardrail_window']['p50_ms']:.3f}, fleet "
          f"{paths['guardrail_fleet']['p50_ms']:.3f}, windowed fleet "
          f"{paths['guardrail_fleet_window']['p50_ms']:.3f}); stream "
          + ", ".join(f"{paths[f'stream_{k}']['items_per_s']:,.0f} items/s "
                      f"{k}" for k in ("dense", "srht", "window", "fleet"))
          + "; with attribution "
          + ", ".join(f"{paths[f'attribution_{k}']['items_per_s']:,.0f} "
                      f"items/s {k}" for k in ATTR_KINDS))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
