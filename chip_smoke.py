#!/usr/bin/env python3
"""Build the PyTorch/CUDA port of ACE (``src/repro_torch``) and drive its
main paths on one NVIDIA GPU, checking every result.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order (any failed check raises, and the script then exits
non-zero without printing its result line):

1. build   — compile the ten CUDA kernels (one ``nvcc`` per source, all
             at once) and print the card's name and power limit;
2. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes of the main paths: dense hash bucket ids agree
             >= 0.999 at the fit, admit and stream-step shapes, and are
             bitwise equal between two calls (``srp_hash`` and every
             output of ``ace_admit_fused``), SRHT ids bitwise at d = 36,
             4097 and 12289, and
             counts, gathers, scores and admit masks bitwise (downstream
             of the kernel's own bucket ids), including a batch of
             repeated rows for both fused admissions, the weighted (two
             tables masked) forms of the fused score and the window
             combine, ``ace_update``/``ace_query`` at per-item base
             rows of the windowed fleet's (T·E·L, 2^15) ring, and
             ``attr_estimate`` equal by value at R = 1, 2, 5, 8 (C = 256)
             for the beam's B = 32 and all 4097 leaf coordinates, and on
             an all-zero plane;
3. estimator — ``AceEstimator`` (paper Algorithm 1) at K=15, L=50 fit on
             596,853 x 36 clustered non-negative points (the KDD-Cup99 HTTP
             shape) in batches of 4096, then 16,384 queries scored and
             predicted (``ace_score_fused``); then a shorter fit and score
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
             plain path's, one transfer each way a chunk and no host sync
             in ``consume``, the post-mortem batch query over all 4097
             coordinates kernel ≡ plain, items/s beside phase 5's;
8. timing  — each kernel, its plain version and (where one PyTorch call
             computes the same function) that call, timed with CUDA events,
             beside the least time the card could take (its bound);
             ``srp_hash`` at its three main-path shapes (fit, admit, stream
             step) under its launch plan and every other cluster size, and
             ``ace_admit_fused`` at its two (admit, stream step), each
             beside cuBLAS's fp32 projection alone (``matmul_ms``, TF32
             off), with the plan printed; and both hash kernels at the
             corners of hash_mode="auto" (d = 64 and 4096), checked against
             the rule's picks.

Every kernel wrapper counts its launches; the counts are set to 0 just
before each path of phases 3 to 7 and read just after, and every kernel
of a path must have been launched in it.  The last lines are the card's
``nvidia-smi`` name and power limit, one JSON line of per-kernel numbers,
and ``{"ok": true, "device": {...}}``.  A kernel's ``max_abs_err`` there is
the largest absolute difference, in phase 2, between any of its outputs
(bucket ids, counts, gathers, scores) and the plain version's.

Data and weights are made from SEED.  Nothing here imports JAX.
"""
from __future__ import annotations

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
SRHT_WIDTHS = (36, 4097, 12289)     # d_pad 64, 8192, 16384
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
}


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


def reset_launches(mods) -> None:
    for m in mods.values():
        m.KERNEL.launches = 0


def read_launches(mods) -> dict:
    return {k: m.KERNEL.launches for k, m in mods.items()}


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
    check(torch.equal(gk, gp), "ace_query gather bitwise equal to plain")

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

    # ace_score_fused at the estimator's score shape, both forms
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
        sk_ = f.ace_score_fused(ck, qs, w, cfg, table_weights=tw)
        sp = f.ace_score_fused_plain(ck, qs, w, cfg, table_weights=tw)
        g = f.flat_table_gather(ck, ids)
        ref = torch.zeros(n_queries, device=device)
        for j in range(L_TABLES):
            ref = ref + (g[:, j] if tw is None else g[:, j] * tw[j])
        if tw is None:
            ref = ref * torch.tensor(1.0 / L_TABLES, dtype=torch.float32)
        worst = max(worst, float((sk_ - sp).abs().max()))
        check(torch.equal(sk_, ref), f"ace_score_fused ({name}) bitwise "
              "equal to the table-order sum of its own ids' gathers")
        check(torch.equal(sk_[same], sp[same]), f"ace_score_fused ({name}) "
              f"bitwise equal to plain on the {int(same.sum())} of "
              f"{n_queries} rows whose ids agree")
    err["ace_score_fused"] = worst

    # srht_hash: ids bitwise at three widths, one above 48 KB of smem
    sh = mods["srht_hash"]
    worst = 0.0
    for d in SRHT_WIDTHS:
        scfg = SrpConfig(dim=d, num_bits=13, num_tables=32, seed=29,
                         hash_mode="srht")
        xs = torch.randn((STREAM_B, d), generator=gen, device=device)
        xs[0] = 0.0
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
    for name, qb, tb in (("random", x, tids), ("colliding", xc, tc)):
        r = ring.clone()
        out = fwa.ace_fleet_window_admit_fused(r, tail, cursor, qb, tb, w,
                                               thr, cfg, item_mask=mask)
        plain = fwa.ace_fleet_window_admit_fused_plain(
            ring.clone(), tail, cursor, qb, tb, w, thr, cfg, item_mask=mask)
        share = agreement(out[3], plain[3])
        check(share >= 0.999, f"ace_fleet_window_admit ({name}) ids agree "
              f"with plain: {share:.6f} >= 0.999")
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
    """Phase 2 for ``attr_estimate``: equal by value to its plain version
    at the beam's B = 2·W = 32 and at B = 4097 (every leaf coordinate of
    d_model + 1), odd and even R, and on an all-zero plane."""
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
    return {"attr_estimate": worst}


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
    return {"launches": launches, "p50_ms": 1e3 * statistics.median(lat),
            "guardrail": g}


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


def admit_breakdown(g, e, t, device) -> dict:
    """A ``torch.profiler`` trace of one admit: wall, device busy, device
    ops and the top device ops by time."""
    from torch.profiler import ProfilerActivity, profile
    g.admit(e, t)
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g.admit(e, t)
        sync(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [x for x in prof.events()
               if x.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(x.time_range.elapsed_us() for x in kernels)
    by_name: dict[str, float] = {}
    for x in kernels:
        by_name[x.name] = by_name.get(x.name, 0.0) \
            + x.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    if not kernels:
        print("  one admit under torch.profiler: no device op in the trace; "
              "device idle share not measured")
    else:
        print(f"  one admit under torch.profiler: wall {wall_us / 1e3:.3f} "
              f"ms, {len(kernels)} device ops, device busy "
              f"{busy_us / 1e3:.3f} ms (idle share "
              f"{1 - busy_us / wall_us:.3f}); top: "
              + ", ".join(f"{n[:40]} {v / 1e3:.3f} ms" for n, v in top))
    return {"profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3, "device_ops": len(kernels)}


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
    ``run`` (each ends in a sync), and a ``torch.profiler`` trace of
    ``consume`` for the device's busy time and kernel count."""
    import repro_torch.stream.runner as runner_mod
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, summary = runner.consume(state, w, chunk, tids)
        sync(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"  one chunk, host clock: stack {ms['stack']:.2f} ms, H2D "
          f"{ms['h2d']:.2f} ms, consume {ms['consume']:.2f} ms, summary "
          f"fetch {ms['fetch']:.2f} ms")
    if not kernels:
        print("  consume under torch.profiler: no device op in the trace; "
              "device idle share not measured")
    else:
        print(f"  consume under torch.profiler: wall {wall_us / 1e3:.3f} "
              f"ms, {len(kernels)} device ops, device busy "
              f"{busy_us / 1e3:.3f} ms (idle share "
              f"{1 - busy_us / wall_us:.3f}); top: "
              + ", ".join(f"{n[:40]} {v / 1e3:.3f} ms" for n, v in top))
    return {**ms, "profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3, "device_ops": len(kernels)}


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
    check(launches["attr_estimate"] == chunks * acfg.num_levels,
          f"attribution ({kind}) launched attr_estimate "
          f"{launches['attr_estimate']} times: NL = {acfg.num_levels} a "
          f"chunk ({acfg.num_levels - 1} beam levels and the leaf ranking)")
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
    before = mods["attr_estimate"].KERNEL.launches
    est = at.estimate(acfg, filt.attr_tables, plane, coords)
    sync(device)
    check(mods["attr_estimate"].KERNEL.launches == before + 1,
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
    return {"launches": launches, "items_per_s": items / secs,
            "seconds": secs, "breakdown": breakdown, "filter": filt,
            "state": state}


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
    ones = torch.ones_like(buckets)
    # ace_update timed as the first kernel of this phase, straight after
    # the host-bound phases, into a copy of the counts (the later timings
    # see the counts as they were); its reported time is taken below,
    # after the dense hash's timings
    first = counts.clone()
    update_first_ms = device_ms(lambda: u.ace_update(first, buckets))

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

    out["ace_update"] = dict(
        ms=device_ms(lambda: u.ace_update(counts, buckets)),
        plain_ms=device_ms(lambda: u.ace_update_plain(counts, buckets)),
        library_ms=device_ms(
            lambda: counts.index_put_((rows, b64), ones, accumulate=True)),
        first_ms=update_first_ms,
        shape=f"B={B}, L={L}, 2^K={nb}, distinct counters {U}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(B * L, 4 * B * L + 2 * 4 * U))))
    # the same ids into three more copies of the same counts: the atomics'
    # time moves with the buffer that holds the hot counters
    copies_ms = [device_ms(lambda c=c: u.ace_update(c, buckets))
                 for c in [counts.clone() for _ in range(3)]]
    out["ace_update"]["copies_ms"] = copies_ms
    print(f"  ace_update B={B}, L={L}: {update_first_ms:.5f} ms as the "
          f"phase's first timed kernel (into a fresh copy of the counts), "
          f"{out['ace_update']['ms']:.5f} ms after the dense hash's "
          f"timings, then " + ", ".join(f"{t:.5f}" for t in copies_ms)
          + " ms into three more fresh copies")
    out["ace_query"] = dict(
        ms=device_ms(lambda: q.ace_query(counts, buckets)),
        plain_ms=device_ms(lambda: q.ace_query_plain(counts, buckets)),
        library_ms=device_ms(lambda: counts[rows, b64]),
        shape=f"B={B}, L={L}, 2^K={nb}, distinct counters {U}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(0, 4 * B * L * 2 + 4 * U))))
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

    # ace_score_fused at the estimator's score shape, on its fitted counts
    f, sh = mods["ace_score_fused"], mods["srht_hash"]
    qs = torch.as_tensor(kdd_like(N_QUERIES, KDD_D,
                                  np.random.default_rng(SEED + 4)),
                         device=device)
    ec = est["counts"]
    Us = distinct_counters(h.srp_hash(qs, w, cfg), nb)
    B3 = N_QUERIES
    out["ace_score_fused"] = dict(
        ms=device_ms(lambda: f.ace_score_fused(ec, qs, w, cfg)),
        plain_ms=device_ms(lambda: f.ace_score_fused_plain(ec, qs, w, cfg)),
        library_ms=None,
        shape=f"B={B3}, d={KDD_D}, K={K_BITS}, L={L}, distinct counters "
              f"{Us}",
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * B3 * KDD_D * KL + B3 * L,
            4 * (B3 * KDD_D + KDD_D * KL) + 4 * Us + 4 * B3))))

    # srht_hash at the stream step's shape (AceDataFilter(d_model=4096))
    scfg = SrpConfig(dim=D_MODEL + 1, num_bits=13, num_tables=32, seed=29,
                     hash_mode="srht")
    xs = torch.randn((STREAM_B, D_MODEL + 1),
                     generator=torch.Generator(device=device).manual_seed(7),
                     device=device)
    out["srht_hash"] = dict(
        ms=device_ms(lambda: sh.srht_hash(xs, scfg)),
        plain_ms=device_ms(lambda: sh.srht_hash_plain(xs, scfg)),
        library_ms=None,
        shape=f"B={STREAM_B}, d={D_MODEL + 1}, d_pad "
              f"{sh.srht_params(scfg).d_pad}, K=13, L=32",
        **dict(zip(("bound_ms", "bound_by"),
                   srht_bound(STREAM_B, D_MODEL + 1, scfg))))

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
    """``attr_estimate`` on the attribution phase's own state and tables
    (the SRHT filter's anomaly channel, R = 5, C = 256): at the beam's
    B = 2·W = 32 children of one level, the launch the drill-down makes 12
    times a chunk, and at B = 4097, the post-mortem query of every leaf
    coordinate.  Bound: the (B, R) columns and signs read, the (B,)
    estimates written and each plane cell touched read once, against the
    B·R sign multiplies."""
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
    return {"attr_estimate": {**beam, "at_post_mortem": leaves}}


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
    del feats
    print("phase 8: timing (CUDA events, median of 30)")
    times, _ = phase_timing(mods, device, paths["estimator"],
                            paths["guardrail"])
    times.update(phase_timing_windows_fleets(
        mods, device, *(paths[f"guardrail_{k}"]["guardrail"]
                        for k in GUARD_KINDS)))
    times.update(phase_timing_attr(mods, device, paths["attribution_srht"]))

    kernels = []
    for name in KERNELS:
        by_path = {p: r["launches"][name] for p, r in paths.items()}
        launches = sum(by_path.values())
        check(launches > 0, f"{name} launched on the main paths ({launches})")
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "launches_by_path": by_path,
            **{k: t[k] for k in ("matmul_ms", "plan", "by_shape",
                                 "first_ms", "copies_ms", "at_post_mortem")
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
