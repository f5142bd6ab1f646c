"""Streaming anomaly detection with drift on the PyTorch/CUDA port — the
paper's Challenge 1, at device speed.

    PYTHONPATH=src python examples/streaming_detection_torch.py [--device cpu]

A high-rate stream whose distribution drifts over time, with periodic
burst anomalies.  Ingest runs through ``repro_torch.stream.StreamRunner``:
T batches stack into one chunk and ONE device program (on the card a
captured CUDA graph, its state donated) hashes → scores → thresholds →
masked-inserts every batch, so the host touches the device once per T
batches (the stacked feed + the chunk summary's one ``fetch``) instead of
≥ 2 syncs per batch — the difference between the sketch running at
stream rate and the Python loop being the bottleneck.

Per chunk the summary reports kept fraction, per-step anomaly counts (the
burst detector below just thresholds them) and the top-k most-anomalous
item coordinates, all computed on device.  The sketch updates online with
kept items only.

Part 2 is the SLIDING-WINDOW demo: an abrupt regime shift that a
cumulative ("frozen") sketch never recovers from — its μ/σ keep
describing a regime that stopped arriving, the μ−ασ threshold collapses,
and post-shift bursts sail through undetected — while the
``repro_torch.window`` epoch ring (same runner, same chunk program,
rotation INSIDE it) ages the stale regime out and catches the bursts
again once the window slides past the shift.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import convert
from repro_torch.data.pipeline import AceDataFilter
from repro_torch.stream import StreamRunner
from repro_torch.window.filter import WindowedAceFilter

CHUNK_T = 10           # batches per chunk (one host round-trip each)
BATCH = 256
STEPS = 60
DIM = 24


def stream_batch(rng, t, poison=False):
    """Drifting inlier cone (mass on the first half of the feature dims);
    burst anomalies live on the OTHER half — angular separation, which is
    what an SRP score sees."""
    half = DIM // 2
    mu = np.zeros(DIM)
    mu[:half] = 4.0 * (1.0 + 0.1 * np.sin(t / 10.0 + np.arange(half)))
    if poison:
        nu = np.zeros(DIM)
        nu[half:] = 6.0
        return np.abs(rng.normal(size=(BATCH, DIM)) * 0.3 + nu)
    return np.abs(rng.normal(size=(BATCH, DIM)) * 0.6 + mu)


def shift_batch(rng, t, shift_t, poison=False):
    """Abrupt regime change: cone A (first half of dims) until shift_t,
    cone B (second quarter) after; bursts on the last quarter of dims
    throughout (identical distribution pre/post — only "normal" moves)."""
    q = DIM // 4
    mu = np.zeros(DIM)
    if t < shift_t:
        mu[:2 * q] = 4.0
    else:
        mu[q:2 * q] = 5.0
    if poison:
        nu = np.zeros(DIM)
        nu[3 * q:] = 6.0
        return np.abs(rng.normal(size=(BATCH, DIM)) * 0.3 + nu)
    return np.abs(rng.normal(size=(BATCH, DIM)) * 0.5 + mu)


def chunk_features(filt, batches, device) -> torch.Tensor:
    """(T, B, DIM) raw batches -> (T, B, DIM+1) features (unit-mean + bias;
    S=1 sequences) in ONE batched call on the device, not T per-batch
    ones."""
    raw = torch.as_tensor(np.stack(batches), dtype=torch.float32,
                          device=device)          # the ONE feed
    T, B, _ = raw.shape
    return filt.features(raw.reshape(T * B, 1, DIM)).reshape(T, B, DIM + 1)


def runner_for(filt, w, **kw):
    """A StreamRunner over ``filt`` with its (state, W): ``w`` (numpy)
    carries a projection matrix in, else the filter's own."""
    runner = StreamRunner(filt, chunk_T=CHUNK_T, **kw)
    state, own = runner.init()
    return runner, state, (own if w is None
                           else convert.params_from_numpy(w, filt.device))


def drift_demo(device, w=None) -> dict:
    """Frozen vs windowed under an abrupt shift (monitor mode: flag but
    insert everything, so both sketches keep seeing the stream).  Both
    filters share one W (``w``, numpy, or the one they draw from their
    seed).  Returns {name: (caught_pre, missed_pre, caught_post,
    missed_post, trace_count)}."""
    steps, shift_t = 120, 40
    poison_steps = {t for t in range(steps) if t % 10 == 9}
    common = dict(d_model=DIM, num_bits=12, num_tables=32, alpha=2.5,
                  warmup_items=2048.0, insert_all=True, device=device)
    detectors = {
        "frozen  ": AceDataFilter(**common),
        "windowed": WindowedAceFilter(**common, num_epochs=4,
                                      rotate_every=10),
    }
    print(f"\n=== drift demo: regime shift at t={shift_t}, bursts every "
          f"10 steps, window = 4 epochs x 10 steps ===")
    out = {}
    for name, filt in detectors.items():
        rng = np.random.default_rng(1)
        runner, state, fw = runner_for(filt, w)
        caught_pre = caught_post = missed_pre = missed_post = 0
        for c0 in range(0, steps, CHUNK_T):
            batches = [shift_batch(rng, t, shift_t, t in poison_steps)
                       for t in range(c0, c0 + CHUNK_T)]
            state, summary = runner.consume(
                state, fw, chunk_features(filt, batches, device))
            s = runner.fetch(summary)
            for i, t in enumerate(range(c0, c0 + CHUNK_T)):
                if t not in poison_steps:
                    continue
                hit = int(s.anom_counts[i]) > BATCH // 2
                # give both detectors the window span to re-adapt
                if t < shift_t:
                    caught_pre += hit; missed_pre += not hit
                elif t >= shift_t + 40:
                    caught_post += hit; missed_post += not hit
        print(f"  {name}: bursts pre-shift {caught_pre}/"
              f"{caught_pre + missed_pre}   post-shift (re-adapted) "
              f"{caught_post}/{caught_post + missed_post}   "
              f"({runner.trace_count} trace, {steps // CHUNK_T} host "
              "round-trips)")
        out[name.strip()] = (caught_pre, missed_pre, caught_post,
                             missed_post, runner.trace_count)
    return out


def run(device, w=None) -> dict:
    """The drifting stream with bursts through the flat filter's runner
    (top-4 per chunk).  ``w`` (numpy) carries a projection matrix in.
    Returns what it prints: the host chunk summaries; caught, missed,
    false flags; the runner's trace_count."""
    rng = np.random.default_rng(0)
    filt = AceDataFilter(d_model=DIM, num_bits=13, num_tables=40,
                         alpha=3.0, warmup_items=1024.0, device=device)
    runner, state, fw = runner_for(filt, w, topk=4)

    poison_steps = {t for t in range(STEPS) if t % 10 == 9 and t > 20}
    caught, missed, false_pos = 0, 0, 0
    summaries = []
    t0 = time.perf_counter()

    for c0 in range(0, STEPS, CHUNK_T):
        batches = [stream_batch(rng, t, t in poison_steps)
                   for t in range(c0, c0 + CHUNK_T)]
        state, summary = runner.consume(
            state, fw, chunk_features(filt, batches, device))
        s = runner.fetch(summary)              # the chunk's ONE sync

        for i, t in enumerate(range(c0, c0 + CHUNK_T)):
            flagged = int(s.anom_counts[i]) > BATCH // 2
            if t in poison_steps and flagged:
                caught += 1
            elif t in poison_steps:
                missed += 1
            elif flagged:
                false_pos += 1
        worst = ", ".join(
            f"step {c0 + int(st)} item {int(it)} (margin {m:+.2f})"
            for st, it, m in zip(s.topk_step, s.topk_item, s.topk_margin)
            if np.isfinite(m))
        print(f"chunk t=[{c0:2d},{c0 + CHUNK_T - 1:2d}]  n={s.n:7.0f}  "
              f"kept={s.kept_frac:.3f}  anom/step={s.anom_counts.tolist()}")
        if worst:
            print(f"  most anomalous: {worst}")
        summaries.append(s)

    dt = time.perf_counter() - t0
    print(f"\nbursts caught {caught}, missed {missed}, "
          f"clean batches falsely flagged {false_pos}")
    print(f"throughput: {STEPS * BATCH / dt:,.0f} items/s "
          f"({STEPS // CHUNK_T} host round-trips for {STEPS} batches; "
          f"chunk program built {runner.trace_count}x)")
    cfg = filt.ace_cfg
    print(f"sketch memory: {cfg.memory_bytes() / 2**20:.2f} MB; "
          f"stream processed: {STEPS * BATCH} items "
          f"({STEPS * BATCH * DIM * 4 / 2**20:.1f} MB never stored)")
    return {"summaries": summaries, "caught": caught, "missed": missed,
            "false_pos": false_pos, "trace_count": runner.trace_count}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    run(device)
    drift_demo(device)


if __name__ == "__main__":
    main()
