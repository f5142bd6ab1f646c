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
             fleet admission's and the fleet score's ids bitwise
             ``srp_hash``'s under one plan, the fleet score bitwise
             ``srp_hash`` + the routed ``ace_query_sum`` (also on rows
             that sum past 2^24), and
             ``attr_estimate`` equal by value at R = 1, 2, 5, 8 (C = 256)
             for B = 32 and all 4097 leaf coordinates, and on an all-zero
             plane, and ``attr_find_hh`` (the one-launch drill-down)
             bitwise its plain version and the per-level loop of
             ``attr_estimate`` launches it replaced, at phase 7's
             hierarchy shape, topk 8 and 18, planted, all-zero and NaN;
             ``ace_score_fused``'s ids bitwise ``srp_hash``'s, its
             unweighted scores bitwise ``srp_hash`` + ``ace_query_sum``
             (either row sum), its weighted ones the table-order sum;
             then the seven kernels that read or add counters again in
             int16, int8 and float32 counters (``phase_kernels_dtypes``):
             the same shapes and checks, a batch of 4096 into one bucket
             from the cap (narrow counters wrap, add for add), 4096 rows
             on the four int8 buckets of one 32-bit word, and base rows
             of the windowed fleet's ring in each dtype; then the six
             hash kernels on bfloat16 and on float16 x and W
             (``phase_kernels_operands``): ``srp_hash`` and
             ``ace_admit_fused`` on the tensor-core tile at their three
             shapes (ids >= 0.999 against the plain version, which
             widens both operands, two launches bitwise equal, the
             admission's counts, scores and verdicts bitwise the plain
             path downstream of its ids; the widening tile, asked for by
             name, bitwise the float32 kernel's on the widened
             operands), ``srht_hash`` at its three (bitwise), the other
             three fused kernels at the admit shape (ids the widening
             tile's, every output bitwise the kernel's on the widened
             operands), and ``ops.ace_admit`` on a bfloat16 W and on
             bfloat16 q and W (each its own path: one
             ``ace_admit_fused`` launch, outputs equal to the widened
             operands' where the two tiles' ids agree);
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
             beside the least time the card could take (its bound); the
             six hash kernels also on bfloat16 and float16 operands in
             turns with float32: ``srp_hash`` and ``ace_admit_fused`` on
             the tensor-core tile at their three shapes, also in turns
             with the widening tile on the same operands, ``srht_hash``
             at its three, the other three fused kernels at the admit
             shape also in turns with the operands widened on the card
             before a float32 launch (the dense bound the products at
             the bf16/fp16 tensor-core rate against x and W at 2 bytes,
             beside cuBLAS's projection on the narrow operands; the
             SRHT's its fp32 adds against a 2-byte x);
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
             ``attr_find_hh`` on the drift hierarchy against the
             per-level loop it replaced, ``ace_score_fused`` unweighted
             and weighted against ``srp_hash`` + ``ace_query_sum``,
             ``ace_window_combine`` unweighted and weighted, and
             ``ace_fleet_score`` against ``srp_hash`` + the routed
             ``ace_query_sum``, each in turns, and the public
             ``attribution.find_hh``, ``ops.ace_score``,
             ``ops.ace_window_score`` and ``ops.ace_fleet_score``
             (``time_public_paths``, which ``kernel_ab.py`` also runs);
             and both hash kernels at the corners of hash_mode="auto"
             (d = 64 and 4096), checked against the rule's picks;
9. quantile — ``threshold_mode="quantile"``: the four ``Guardrail``
             flavours at phase 6's width and traffic with q = 0.01, one
             D2H an admit, then run in lockstep with the plain path from
             the same state before every admit (ids >= 0.999, verdicts
             equal on every row whose ids agree, each histogram row's
             total equal to the finite rows observed past the half-warmup
             gate), admit p50 in turns with mu-sigma's and one admit traced
             beside phases 4 and 6; ``benchmarks/quantile_bench.py``'s
             calibration scenario at its full shape (B = 384, d = 64,
             three tenants of different tails, 220 steps, a burst from
             step 200; its stream copied here in numpy) through
             ``FleetDataFilter`` + ``StreamRunner`` in both modes, held to
             that benchmark's gates (quantile FPR in [q/2, 2q] for every
             tenant, mu-sigma under- and over-flagging, burst recall
             >= 0.8), its rates' bin ids on the card against a CPU
             ``bin_index`` of the same rates (how many lie within 4 ulp
             of an edge, how many differ); phase 5's fleet stream in
             quantile mode (one transfer each way a chunk, no sync inside
             ``consume``), items/s in turns with mu-sigma's;
10. narrow — every narrow flavour in lockstep with its int32 twin (one
             W, the same traffic, the order alternating, each admit
             timed): the flat ``Guardrail`` at phase 4's width and
             traffic in int16 (3,276,800 B of counters), in int8 (which
             wraps) and in int8 with ``esc_capacity`` 4096 (hot counters
             promoted past 127), the windowed, fleet and windowed-fleet
             guardrails on phase 6's traffic in int16 and int8; verdicts
             equal every admit, counts widened (densified) bitwise while
             no counter passes the cap, and an unpromoted plane past it
             the int32 counts wrapped; the fused, window and fleet queries
             on the narrow states; ``AceEstimator`` at phase 3's shape
             in int16 with promotion (densified ≡ phase 3's int32 fit,
             none lost) and phase 5's dense stream in int16 (one
             transfer each way a chunk, no sync in ``consume``), each in
             turns with int32; then the seven count-reading kernels timed
             in int32, int16 and int8 in one call
             (``phase_timing_dtypes``);
11. resilience — each ``Guardrail`` flavour at phase 6's width and
             traffic, a kernel guardrail and a plain one in lockstep:
             armed, 4 NaN rows quarantined, 2 bits flipped in each of
             ⌈L/4⌉ = 13 tables (``resilience.flip_count_bits``), the
             ``health_check`` reports equal, every flagged table a
             flipped one (all of them where conservation is two-sided),
             masked scores bitwise an unflipped twin's, degraded admits
             (one D2H each, verdicts equal where ids agree, ``srp_hash``,
             ``ace_query_sum`` and ``ace_update`` launched and no fused
             admission, no sync under sync-debug "error"), their p50 in
             turns with the healthy route's and one traced, ``repair``
             (the invariants hold at once), re-warm within the
             reference's bound and the healthy route again, and two
             CRC-checked checkpoints of the state, the newest torn, the
             intact one restored bitwise;
12. front end — ``FrontEnd`` (``repro_torch.serve.frontend``) over each
             ``Guardrail`` flavour at phase 6's shapes, built as
             ``benchmarks/openloop_bench.py`` builds the reference's
             (policies alternating fail_open / fail_closed by tenant,
             ``max_queue`` 4B, deadline 50 ms, ``max_wait`` 5 ms): on the
             fleet the closed-loop capacity of ``admit`` (items/s), the
             front end's (req/s, ``submit`` + ``pump``) and seeded Poisson
             open loops at 0.5x, 1x and 2x that capacity, then the flat,
             windowed and windowed-fleet flavours at 2x; served items/s,
             shed rate by reason, the p50/p99/p999 latency of served
             requests from their scheduled arrival, the service-time
             estimate and the host ms of batch assembly; at 0.5x the
             shed rate <= 0.05 and served >= 0.9 x offered; at 2x the
             shed rate > 0.05, at least 500 served and served >= 0.5 x
             the front end's capacity, and p999 <= 50 + 3 x service + 5 +
             20 ms; served + shed + queued = offered, every shed verdict its tenant's
             ``fail_open_mask``, the pads the only quarantined rows, each
             admit through its flavour's kernels; then on a fresh
             guardrail and its twin the served verdicts bitwise the
             twin's on the same padded batches, and a full-queue burst
             with its deadline sheds under sync-debug "error";
13. private hash — paper section 4's DP-SRP on the KDD-Cup99 HTTP
             analogue (``make_paper_dataset("kddcup99_http", seed=0)``,
             596,853 x 36, ``bias_augment``ed, unit rows), K=15, L=50: at
             sigma = 0 the ids agree with the ``srp_hash`` kernel's on
             >= 0.999; at the Gaussian mechanism's sigma for (1, 1e-5)
             the measured bit-flip rate lies within 3 standard errors of
             the expected one; the private ids through ``ace_update`` and
             ``ace_query_sum``, and mu-sigma's detection counts at both
             sigma;
14. paper comparison — shuttle, aloi and kddcup99_http (seed 0, the
             paper's k 5, 5, 10): ``AceEstimator`` (K=15, L=50) at full n,
             the 11 baselines (``repro_torch.baselines.run_baseline``, the
             graph shared) at the comparison bench's n = 12,000, the
             card's graph-based, LDOF and COF scores against the plain
             CPU version on the card's graph, then all 11 at
             kddcup99_http's full n; seconds and reported / correct /
             missed for each, every score finite, ODIN's indegrees
             summing to n*k;
15. serving — ``ServeEngine.generate`` behind phase 4's flat
             ``Guardrail`` (K=15, L=50, warmed past its warm-up on the
             model's embedding rows): (a) Mixtral-8x7B at full width
             (d_model 4096, 32 heads, kv 8, d_ff 14336, 8 experts top-2,
             window 4096, vocab 32000, bf16 activations, float32
             parameters cast at each use) cut to 8 of its 32 layers, 64
             prompts of 128 tokens, 64 new tokens each, through the
             engine's captured prefill and decode programs
             (``core.capture``, one CUDA graph a signature) in turns
             with their eager twin (``capture.disabled()``): the output's
             shape and dtype, one ``ace_admit_fused`` launch a generate,
             the guardrail's verdict block and the tokens the only
             ``_to_host`` transfers, no sync in prefill and decode
             (sync-debug "error" from the admit's return to the tokens'
             transfer), the captured tokens equal to the eager twin's,
             ``trace_counts`` (1, 1), the weights adopted (the graphs
             read the caller's tensors, same ``data_ptr``), the
             prefill's and one decode step's logits from one cache
             against the eager twin's (bitwise, else within 2e-4);
             captured / eager: prefill ms, generate and
             ``decode_throughput`` tokens/s, one traced decode step, the
             peak memory and ``memory_reserved`` of each path; the
             prefill's ``moe_drop_frac``; (b) two of those layers in
             float32 (TF32 off, the capacity factor E/K so that no token
             drops): prefill +
             decode logits against ``forward`` within rtol 2e-4 / atol
             2e-4, and a ring cache (window cut to 32, ``s_max`` 32)
             against a full one (``s_max`` 64) over 48 greedy tokens that
             wrap it, tokens equal; (c) olmo_1b at its full size (16
             layers, d_model 2048) served as in (a) behind a guardrail
             at d_model 2048, then its weights in float32: 2 prompts of
             16 tokens and 4 greedy tokens on the card against the CPU,
             logits within rtol 2e-4 / atol 2e-4 and tokens equal;
16. the rest of the zoo — served as in phase 15: (a) Jamba-v0.1 at full
             width (d_model 4096, 32 heads, kv 8, d_ff 14336, 16 experts
             top-2 at the odd pattern positions, Mamba d_state 16, d_conv
             4, expand 2, vocab 65536) cut to one of its four 8-layer
             superblocks (7 Mamba + 1 attention layer), behind a
             guardrail at d_model 4096, with the checks and numbers of
             phase 15 (a), then that superblock in float32 at capacity
             E/K, B = 2: prefill + decode logits against ``forward``
             within 2e-4 (the Mamba scan against its step); (b) RWKV-6 7B
             at its full size (32 layers, d_model 4096, 64 heads of 64,
             d_ff 14336) served the same way, then its first 2 layers in
             float32 with the zero-initialised time-mix ``wo`` and
             channel-mix ``wv`` redrawn (std 1/sqrt(fan-in)): prefill +
             decode against ``forward``, and 2 prompts of 16 tokens and
             4 greedy tokens on the card against the CPU, within 2e-4,
             tokens equal; (c) whisper_tiny at its full size (4 + 4
             layers, d_model 384, 1500 frames, vocab 51865) on 64 frame
             batches and prompts of 128 tokens: its batch carries
             "embeds", so ``generate`` never calls the guardrail (the
             reference's rule): no launch, the tokens the one transfer,
             no sync; then in float32 the card's greedy logits and tokens
             against the CPU's (2 frame batches, 16 prompt tokens, 4
             new).  For Jamba and RWKV-6 one recurrent mixer (projections
             and the time loop) is also timed at the prefill's shape,
             beside the prefill it is part of;
17. training — ``train_loop.train`` behind the ACE data filter and the
             ACE gradient monitor (AdamW, remat, the cosine schedule): (a)
             olmo_1b at its full size (16 layers, d_model 2048, vocab
             50304, bf16 activations, float32 parameters) on a
             ``DataStream`` of 8 × 128 tokens made from SEED, one
             warm-up step, then 8 steps with 2 microbatches and the
             in-step filter and 8 with the chunked prefilter (T = 4), no
             checkpoint, each in turns captured (``train``'s step, chunk
             features and tail step as ``core.capture`` programs) and
             as its eager twin (``capture.disabled()``) from a copy of
             the same state at the same stream position: every loss
             finite, every kernel of the path (``ace_admit_fused``,
             ``ace_query_sum``, ``srp_hash``, ``ace_update``) launched,
             as often captured as eager, one H2D (the batch) and one D2H
             (the metrics) a step and no sync in a step (sync-debug
             "error" from the batch's H2D to the metrics transfer);
             metrics, parameters, moments, sketches, residual and
             generator bitwise the twin's (each part that differs
             named with its largest difference); one step program
             (``trace_count``), none in the twin; the captured peak
             memory within 4 GiB of the twin's (the state donated, not
             cloned); step ms (median), tokens/s, the filter's keep
             fraction and the peak memory; then 3 unprofiled eager
             steps (their median wall) and one step traced on the card
             only (device ops, busy, the idle share against the
             unprofiled wall) with the stream ms of its forward,
             backward, clip, filter, monitor and optimiser from CUDA
             events and their device busy ms from the trace; and the
             same step as one captured program: its build, 3 unprofiled
             replays and one traced (device ops, busy, idle share);
             (b) reduced olmo_1b in float32 (TF32 off), eager on the
             card (its noise recorder is a Python hook a replay would
             not call),
             filter, monitor and compression on, 4 steps on the card and
             on the CPU from one set of weights and one noise draw
             (recorded on the card, replayed on the CPU): losses within
             rtol 1e-5, verdicts equal, params within the summed
             learning rate and 99.9% within 1e-6, filter counts all but
             0.2%; 24 more steps of each past the monitor's warmup:
             verdicts equal, the monitor's counts all but 0.2%, n exact,
             Welford within rtol 1e-5; the monitor's kernel path against
             its plain path on the card, one shared state a step, over
             the card run's features twice and a spike, and the filter's
             (both threshold modes) over 84 batches of embeddings, past
             both warmups: verdicts, scores, counts, n and Welford equal
             where the ids agree; then an
             interrupted run restored from its checkpoint against the
             uninterrupted one on the card, plain and chunked prefilter:
             params within 1e-6, sketches and generator bitwise, both
             runs captured; (c) one
             Mamba mixer of Jamba (d_model 4096, d_inner 8192, N 16) and
             one RWKV-6 time mix (64 heads of 64) at full width in
             float32, B = 2, S = 256, time_chunk 64: loss and gradients
             against the CPU's within 2e-4, forward + backward ms and
             peak memory beside the in-place inference loop's forward;
             (d) poison, reduced olmo_1b, captured: the reference's
             test_monitor_skips_poisoned_step (30 healthy steps, then
             zeros with every label the last token: flagged, params and
             moments unchanged), then 130 steps of a corrupt_every=13
             stream of 64 x 16 tokens with the filter in quantile mode
             (q = 0.05), whose
             keep fraction must drop on the poisoned batches after it
             arms, and again in μ−ασ mode (reported);
18. cluster — ``repro_torch.cluster`` at full width: two host processes
             (``chip_smoke.py --cluster-child h0|h1``, started once the
             kernels are built, so they only load them) on the card, each
             a ``ClusterNode`` over a 16-tenant ``FleetDataFilter``
             (d_model 4096, K = 15, L = 50, int32: 104,857,600 B a host),
             chunks of 8 single-tenant batches of 512 rows, 2 chunks an
             epoch, a checkpoint an epoch, a ``TCPStore`` served by this
             process, batches of the reference chaos test's structure
             made from SEED; (a) h1 fetches h0's first full-width gossip
             blob (bytes, publish and fetch ms); (b) h1 dies (exit 137,
             no cleanup) half an epoch past its last publish; h0 declares
             it dead at its first poll more than the failure timeout past
             h1's last beat, adopts its 8 tenants from that gossip with exact n and
             resumes their streams; a never-failed replay here on the
             card: survivors' counts, n and Welford bitwise, adopted
             counts and n equal, probe scores exact, every served verdict
             equal, recall after re-homing >= 0.9 × fault-free; (c) h1
             restarted cold rejoins through ``try_rejoin``, then runs
             its control loop until h0 has read the state, and wins back
             only its HRW tenants, from h0's gossip with exact n (its
             silence at the new map version against the failure timeout
             printed); (d)
             items/s a host ingests, ``ingest_chunk`` in turns with a
             plain ``StreamRunner`` on one fleet, the epoch boundary by
             part, kill-to-dead, re-shard + adoption ms, gossip bytes;
             each host's launches (``srp_hash``, ``ace_query_sum``,
             ``ace_update``, no (B, L) gather) join the kernels' counts.
19. dist — ``repro_torch.dist`` as ``gloo`` ranks on the card
             (``chip_smoke.py --dist-child WORLD RANK DIR``, started once
             the kernels are built), world 2 and then world 4, each held
             against this process running the main path with no mesh
             (the fused admission, the filters' kernel path), whose timed
             runs go before and after the ranks: (a) flat guardrails at d_model 4096,
             K = 15, L = 50 (25 tables a rank), 16 admits of 256 × 16,
             replicated and table-sharded, μ−ασ and quantile: masks,
             counts, n, μ, Welford bitwise, ``srp_hash``, ``ace_query_sum``
             and ``ace_update`` launched on each rank and no fused
             admission, the all-reduce tally 2 × 4·B bytes an admit (+ 8
             for μ's int64 Σc²); (b) T = 8 fleets tenant-sharded (world
             2) and tenant × table (world 4), each rank its tenants'
             requests: bitwise, no collective on the tenant axis; (c) the
             table-sharded stream (T 16 × B 512 × d 4097, K 13, L 32, 2
             chunks) flat and windowed (E 4, γ 0.9, R 4): keeps and state
             bitwise; (d) K = 18, L = 200 (209,715,200 B) over 2 ranks:
             each rank's block bitwise; (e) reduced olmo_1b, 2 ZeRO-2
             steps at 2 × 1 (FSDP specs): loss within rtol 1e-5,
             parameters within the summed lr and 99.9% within 1e-6, the
             filter's and monitor's sketches bitwise; (f) GPipe, 2 stages
             × 8 microbatches, against the sequential stages; (g) the
             self-healing lifecycle under a mesh at world 2 (the flat
             guardrail table-sharded in both modes, the windowed one
             table-sharded, the T = 8 fleet tenant-sharded): bits
             flipped in both ranks' tables, ``health_check``, degraded
             admits, ``repair``, re-warm, each bitwise one process
             (verdicts, reports, masked μ, repaired states, a ring's
             ssq), one D2H an admit and an audit, ``health_check`` and
             ``repair`` ms, degraded against healthy admit p50 in turns
             and their collectives; admit p50 and items/s beside one
             process's, each rank's tally and launches (which join the
             kernels' counts).
20. dry run — ``repro_torch.launch.dryrun`` on the ``meta`` device (no
             allocation): (a) olmo_1b train_4k, mixtral_8x7b prefill_32k,
             jamba_v01_52b decode_32k and rwkv6_7b long_500k on the 16×16
             and 2×16×16 meshes, each ``ok`` with collectives, and their
             ``dist.roofline`` table at the H100 datasheet rates; (b) the
             one-card (1 × 1) prediction of phase 17's olmo_1b step
             (B 8 × S 128, 2 microbatches) and phase 15's olmo_1b prefill
             (B 64 × 128): each measured time >= the compute bound and
             >= ``memory.args`` at the HBM rate, ``memory.args`` <= the
             phase's ``max_memory_allocated``, measured ÷ ``bound_s``
             printed; while ``chip_smoke.py --dryrun-child WORLD RANK DIR``
             ranks (world 2 and world 4 at once, ``gloo`` on the card)
             run (c) one live step of reduced olmo_1b (AdamW; Adafactor
             with int8 compression) on (2, 1) and (2, 2) meshes, each
             rank's tally equal to the same step's run on ``meta`` over
             the mesh's shape (``train.sharded.step_on_meta``), and (d)
             Adafactor at world 2 and on a (2, 2) mesh at world 4, and
             at world 2 int8 compression, the chunked prefilter (a
             (1, 2) mesh, table-sharded sketch) and a run that
             checkpoints at steps 2 and 4, resumed from step 2 at world
             2 and here at world 1, each against this process's run
             (phase 19 (e)'s tolerances); the ranks' launches join the
             kernels' counts;
21. compile once — ``Guardrail.admit`` and ``StreamRunner.consume`` as
             one captured ``torch.cuda.CUDAGraph`` a signature
             (``repro_torch.core.capture``; phases 1-20 run captured
             too), each against its eager twin under
             ``capture.disabled()`` on the same W and inputs: the four
             guardrail flavours in both threshold modes at phase 6's
             shapes through warm-up, phase 11's flips, degraded admits,
             repair, re-warm and healthy admits, verdicts and states
             bitwise every admit, one D2H each, ``trace_count`` 2, replays
             under sync-debug "error" (healthy and degraded) each adding
             its capture's launch tally, admit p50 and items/s in turns
             with the eager twin and (μ−ασ) one traced admit each way;
             the copy of the embeds into the admit's static buffer
             against featurising eagerly, timed; seven stream kinds at
             phase 5's shapes (dense, SRHT, window, fleet, fleet with
             attribution, fleet in quantile mode, ``return_masks``),
             three chunks (one with a health mask) bitwise the twin
             (summaries, keep masks, states), ``run`` both ways from
             identical states bitwise with one H2D (from the reused
             page-locked buffer) and one D2H a chunk and no sync in a
             captured ``consume``, items/s in turns, one traced
             ``consume`` each way; every kernel of these paths launched
             inside a graph;
22. the five configurations the card had not run — qwen2_1_5b (all 28
             layers), gemma2_27b (8 of 46: four local/global superblocks),
             mistral_large_123b (4 of 88), mixtral_8x22b (4 of 56) and
             qwen2_vl_7b (all 28) at their published widths, fewer layers
             only where the card's memory forces it (printed), each freed
             before the next: the four that take tokens served by
             phase 15's ``serve_model`` (B 64 × 128 prompt tokens, 64
             new, s_max 256, behind a warmed flat guardrail at the
             model's d_model) with the prefill's logits and cache and one
             decode step's logits required bitwise the eager twin's, then
             the guardrail's kernels at that d_model against a plain-path
             guardrail from one state (masks at the ids floor, counts, n,
             μ and Welford as phase 4);
             qwen2_vl_7b's prefill of 64 seeded embedding batches
             (M-RoPE) captured and eager, bitwise, and its ``generate``
             raising ``KeyError`` as the reference's does; each family's
             first 2 layers (gemma2: one superblock) in float32 against
             ``forward`` within rtol/atol 2e-4 (mixtral at capacity E/K;
             qwen2_vl on embeddings), gemma2 again with its window cut
             to 32 and a prompt of 48, and its local layers' ring cache
             against a full one; qwen2_1_5b in float32 on the card
             against the CPU;
23. the examples as users run them — ``examples/quickstart_torch.py``,
             ``fleet_serving_torch.py``, ``streaming_detection_torch.py``,
             ``drift_postmortem_torch.py`` and
             ``scripts/chaos_report_torch.py --json
             build/RESILIENCE_torch.json``, each its own process
             (``PYTHONPATH=src``, on the card by default), all at once:
             each exits 0, and its printed figures are parsed and
             checked against its story (the exact inverse and the merge;
             bursts flagged, isolation, one admit program; the window
             catching post-shift bursts the frozen sketch misses; the
             planted dims and the offender; the drill's five stages ok
             and two admission programs).

Every kernel wrapper counts its launches (a captured graph's replay adds
the launches its capture recorded); the counts are set to 0 just
before each path of phases 3 to 7 and 9 to 21 (the post-mortem query a
path of its own; in phase 10 before each narrow admit, in phase 11
before each degraded admit and the first healthy one after recovery;
in phase 12 before each open loop; in phase 14 before each ACE fit; in
phases 15 and 16 before each checked captured generate; in phase 17
before each
measured ``train``; in phase 18 in each serving host process, before
its first chunk; in phase 19 in each rank, before each part; in phase
20 in each rank, before each step or run; in phase 21 around each
captured call; in phase 22 before each checked captured generate) and
read just after, every kernel of a path must have been
launched in it, and no path may launch the (B, L) ``ace_query`` gather (every
gather-and-reduce is one ``ace_query_sum``).
The admits and ``consume`` calls traced in phases 4-7 and 9 are traced
eagerly (``capture.disabled()``; phase 21 traces the captured ones)
twice:
as they run, and with the (B, L) gather + PyTorch reductions in place of
``ace_query_sum``, the device ops before and after it.  The last lines
are the card's ``nvidia-smi`` name and power limit, one JSON line of
per-kernel numbers, and ``{"ok": true, "device": {...}}``.  A kernel's
``max_abs_err`` there is the largest absolute difference, in phase 2,
between any of its outputs (bucket ids, counts, gathers, scores) and the
plain version's; each count-reading kernel's ``by_dtype`` gives the same
in int16, int8 and float32, its times and bound in each narrow dtype,
and its launches on phase 10's paths of that dtype; each hash kernel's
``by_dtype`` also gives bfloat16 and float16 operands: ``max_abs_err``
of the ids, times in turns with float32 (and with the widening tile,
``srp_hash`` and ``ace_admit_fused``; with the operands widened on the
card first, the other three dense ones), bounds, cuBLAS's projection on
the narrow operands, and launches on the two bfloat16 ``ops.ace_admit``
paths.

Data and weights are made from SEED.  Nothing here imports JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): fp32 outside
# the tensor cores (an FMA counts two, so plain adds run at half of it),
# bf16/fp16 products on the tensor cores with fp32 accumulation (exact for
# 2-byte operands, so the same ids), and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_FP32_ADDS = 33.5e12
PEAK_16BIT_TC_FLOPS = 989e12
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

    # ace_fleet_score on the ring's live epochs seen as a fleet, and on a
    # fleet whose rows sum past 2^24: its ids srp_hash's under one plan,
    # its scores srp_hash + the routed ace_query_sum (the exact row sum)
    plan = h.device_plan(admit_b, d_model + 1, K, L, device)
    rows = (tids * L).contiguous()
    same = (ids == h.srp_hash_plain(x, w, cfg)).all(dim=1)
    big = torch.randint(0, 1 << 20, (T, L, nb), generator=gen,
                        device=device, dtype=torch.int32)
    for name, counts in (("live epochs", ring[:, 0].contiguous()),
                         ("counters to 2^20, rows past 2^24", big)):
        sk_, fids = fs.ace_fleet_score_planned(counts, x, tids, w, cfg, plan,
                                               with_ids=True)
        sp = fs.ace_fleet_score_plain(counts, x, tids, w, cfg)
        err["ace_fleet_score"] = max(err.get("ace_fleet_score", 0.0),
                                     float((sk_ - sp).abs().max()))
        check(torch.equal(fids, h.srp_hash_planned(x, w, cfg, plan)),
              f"ace_fleet_score ({name}) ids bitwise equal to srp_hash's "
              f"under the same plan ({plan.describe()})")
        check(torch.equal(sk_, q.ace_query_sum(counts.view(T * L, nb), fids,
                                               rows)),
              f"ace_fleet_score ({name}) bitwise equal to srp_hash + the "
              "routed ace_query_sum of its own ids")
        check(torch.equal(sk_[same], sp[same]), f"ace_fleet_score ({name}) "
              f"bitwise equal to plain on the {int(same.sum())} of "
              f"{admit_b} rows whose ids agree")
    del big

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


def against_plain(what, g, plain, masks, plain_masks, floor) -> int:
    """A kernel-path guardrail ``g`` against the plain-path ``plain`` after
    the same admits from one state: the masks agree on >= ``floor`` of
    the rows; the counts but for displaced insertions within the hash
    floor (1e-3 of n·L); n bitwise where the masks agree; μ and the
    Welford moments within 1e-5 (1e-3 with displaced insertions).
    Returns the displaced insertions."""
    from repro_torch.core import sketch as sk
    mismatch = int((plain_masks != masks).sum())
    check(mismatch <= (1 - floor) * masks.size, f"{what}masks agree with "
          f"the plain-path guardrail ({mismatch} of {masks.size} differ, "
          f"<= {1 - floor:.1%})")
    # The two paths hash with different fp32 summation orders (the
    # kernel's tile loop vs cuBLAS), so a projection at |proj| ~ 0 may
    # land an admitted item in another bucket of one table: hold the
    # displaced share of the n·L insertions to the hash floor.
    moved = int((g.state.counts - plain.state.counts).abs().sum()) // 2
    share = moved / max(float(plain.state.n) * g.gcfg.num_tables, 1.0)
    check(share <= 0.001, f"{what}counts equal the plain path's but for "
          f"{moved} displaced insertions ({share:.2e} <= 1e-3 of n*L)")
    if mismatch == 0:
        check(float(g.state.n) == float(plain.state.n),
              f"{what}n bitwise equal to the plain-path guardrail")
    for name, a, p in (
            ("mu", sk.mean_mu(g.state), sk.mean_mu(plain.state)),
            ("Welford mean", g.state.welford_mean,
             plain.state.welford_mean),
            ("Welford M2", g.state.welford_m2, plain.state.welford_m2)):
        rel = abs(float(a) - float(p)) / max(abs(float(p)), 1e-30)
        tol = 1e-5 if moved == 0 else 1e-3
        check(rel <= tol, f"{what}{name} {float(a):.6g} vs plain "
              f"{float(p):.6g}: rel {rel:.2e} <= {tol:g} ({moved} displaced "
              "insertions)")
    return moved


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
    against_plain("", g, plain, m, np.stack(plain_masks), 0.99)
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
    """``device_trace`` of ``fn`` as it runs eagerly (``capture.disabled``:
    a captured graph would replay the kernels it recorded, whatever is
    patched in later), then, after one untraced call, with the (B, L)
    gather and PyTorch's reductions in place of ``ace_query_sum``; prints
    both.  Each is traced twice and the trace with more device ops kept:
    a trace can miss device events (PERF.md), never invent them.
    Phase 21 traces the captured paths."""
    from repro_torch.core import capture

    def fuller(a, b):
        return a if a["device_ops"] >= b["device_ops"] else b
    with capture.disabled():
        tr = fuller(device_trace(fn, device), device_trace(fn, device))
        with gather_then_reduce():
            fn()
            sync(device)
            old = fuller(device_trace(fn, device), device_trace(fn, device))
    if not tr["device_ops"]:
        print(f"  {what} under torch.profiler: no device op in the trace; "
              "device idle share not measured")
    else:
        print(f"  {what} (eager) under torch.profiler: wall "
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
    from repro_torch.core import capture
    from repro_torch.kernels import ops
    seen = []
    real = ops.attr_find_hh

    def record(plane, *args):
        seen.append(plane.clone())
        return real(plane, *args)
    ops.attr_find_hh = record
    try:
        with capture.disabled():        # a replay would not call record
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
    from repro_torch.core import capture
    acfg, tables = runner.filt.ace_cfg.attr, runner.filt.attr_tables

    def fuller(fn, tries=2):
        return max((device_trace(fn, device) for _ in range(tries)),
                   key=lambda t: t["device_ops"])

    def hh():
        return at.find_hh(acfg, tables, drift, runner.topk)

    def cons():                         # eager: the loop is patched in
        with capture.disabled():
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
# Phase 9: quantile-calibrated admission (threshold_mode="quantile").
# ---------------------------------------------------------------------------

QUANT_Q = 0.01                       # the quantile guardrails' flag rate
QUANT_KINDS = {"flat": {}, **GUARD_KINDS}
# benchmarks/quantile_bench.py's full-size calibration scenario
CAL_TENANTS = ("light", "bimodal", "pareto")
CAL_BIMODAL_FRAC = 0.08
CAL_SHAPE = dict(steps=220, batch=384, dim=64, T=3)
CAL_STREAM = dict(burst_from=200, burst_frac=0.3, drift=0.1,
                  noise_scale=0.55, seed=0)
CAL_CHUNK_T, CAL_ARM, CAL_Q = 10, 20, 0.02
CAL_FILTER = dict(num_bits=10, num_tables=32, alpha=3.0,
                  warmup_items=1024.0, insert_all=True)


def cal_noise(rng, kind: str, rows: int, dim: int, scale: float):
    """Per-tenant angular noise: one scale, three tails (numpy copy of
    ``benchmarks/quantile_bench.py``'s ``_noise``)."""
    if kind == "light":       # bounded support: zero mass beyond √3·σ
        return rng.uniform(-1.0, 1.0, (rows, dim)) * (scale * np.sqrt(3.0))
    g = rng.normal(size=(rows, dim))
    if kind == "bimodal":     # majority mode: plain Gaussian
        return g * scale
    mult = rng.pareto(2.0, (rows, 1)) + 0.1   # infinite-variance tail
    return g * mult * scale


def calibration_stream(steps: int, batch: int, dim: int, T: int, *,
                       burst_from: int, burst_frac: float, drift: float,
                       noise_scale: float, seed: int):
    """The mixed-tenant heavy-tailed drift stream of
    ``benchmarks/quantile_bench.py`` (``_make_stream``), in numpy, draw for
    draw: a list of (x (B, dim) f32, tids (B,) i32, y (B,) i8) steps.
    Tenant t's inliers sit on a cone drifting from block t to block t + 1;
    the bimodal tenant has a benign 8% minority cone; from ``burst_from``
    on, ``burst_frac`` of each tenant's rows are scattered anomalies."""
    rng = np.random.default_rng(seed)
    per = batch // T
    blocks = T + 1
    span = dim // blocks
    mus = []
    for t in range(T):
        a = np.zeros(dim)
        a[t * span:(t + 1) * span] = 5.0
        b = np.zeros(dim)
        b[(t + 1) * span:(t + 2) * span] = 5.0
        mus.append((a, b))
    out = []
    for s in range(steps):
        frac = drift * s / max(steps - 1, 1)
        xs, ts, ys = [], [], []
        for t in range(T):
            a, b = mus[t]
            mu = (1.0 - frac) * a + frac * b
            x = np.abs(mu + cal_noise(rng, CAL_TENANTS[t], per, dim,
                                      noise_scale))
            if CAL_TENANTS[t] == "bimodal":
                alt = np.zeros(dim)
                alt[t * span:t * span + span // 2] = 7.0
                rows = rng.uniform(size=per) < CAL_BIMODAL_FRAC
                k = int(rows.sum())
                x[rows] = np.abs(alt + rng.normal(size=(k, dim)) * 0.3)
            y = np.zeros(per, np.int8)
            if s >= burst_from and burst_frac > 0:
                k = max(1, int(round(per * burst_frac)))
                rows = rng.choice(per, size=k, replace=False)
                x[rows] = rng.normal(size=(k, dim)) * 3.0
                y[rows] = 1
            xs.append(x)
            ts.append(np.full(per, t, np.int32))
            ys.append(y)
        order = rng.permutation(batch)
        out.append((np.concatenate(xs)[order].astype(np.float32),
                    np.concatenate(ts)[order],
                    np.concatenate(ys)[order]))
    return out


def clone_state(state):
    return type(state)(*(None if x is None else x.clone() for x in state))


def phase_quantile_guardrail(mods, device, kind, d_model=D_MODEL,
                             admits=SHIFT_ADMITS, b=ADMIT_B,
                             s=ADMIT_S) -> dict:
    """One ``Guardrail`` flavour with ``threshold_mode="quantile"`` on
    phase 6's shifting traffic: the timed run (launches, one D2H an
    admit), then a lockstep run against the plain path from the same
    state before every admit (ids, verdicts where a row's ids agree, the
    histograms' totals against the finite rows past the half-warmup
    gate)."""
    import repro_torch.serve.engine as engine
    from repro_torch.core.srp import hash_buckets
    from repro_torch.data.pipeline import mean_embed_features
    from repro_torch.window import ring
    gcfg = engine.GuardrailConfig(d_model=d_model, num_bits=K_BITS,
                                  num_tables=L_TABLES,
                                  threshold_mode="quantile",
                                  quantile_q=QUANT_Q, **QUANT_KINDS[kind])
    T = gcfg.num_tenants if gcfg.num_tenants > 1 else None
    windowed = gcfg.window_epochs > 1

    def batches():
        return shift_batches(device, d_model, admits, b, s, SHIFT_AT, T)
    d2h = []
    real_to_host = engine._to_host

    def to_host(x):
        d2h.append(tuple(x.shape))
        return real_to_host(x)
    engine._to_host = to_host
    try:
        reset_launches(mods)
        g = engine.Guardrail(gcfg, use_kernels=True, device=device)
        masks, lat = [], []
        for e, t in batches():
            t0 = time.perf_counter()
            masks.append(g.admit(e, t))          # ends in the one transfer
            lat.append(time.perf_counter() - t0)
        launches = read_launches(mods)
    finally:
        engine._to_host = real_to_host
    p50 = 1e3 * statistics.median(lat)
    print(f"  quantile guardrail ({kind}): {admits} admits of {b} x {s} x "
          f"{d_model}, K={K_BITS}, L={L_TABLES}, q={QUANT_Q}; admit p50 "
          f"{p50:.3f} ms (host clock, ends in the mask transfer); launches "
          f"{launches}")
    check(d2h == [(2, b)] * admits, f"one D2H an admit ({len(d2h)} for "
          f"{admits} admits, each the (2, {b}) verdict block)")
    m = np.stack(masks)
    nan_rows = np.zeros_like(m)
    nan_rows[np.arange(admits), np.arange(admits) % b] = True
    pre = slice(SHIFT_AT - 4, SHIFT_AT)
    flagged_pre = 1.0 - float(m[pre][~nan_rows[pre]].mean())
    flagged_new = 1.0 - float(m[SHIFT_AT:SHIFT_AT + 4]
                              [~nan_rows[SHIFT_AT:SHIFT_AT + 4]].mean())
    flagged_last = 1.0 - float(m[-4:][~nan_rows[-4:]].mean())
    print(f"  flagged: 4 admits before the shift {flagged_pre:.4f} (q = "
          f"{QUANT_Q}), first 4 after it {flagged_new:.4f}, last 4 "
          f"{flagged_last:.4f}")
    check(flagged_new > flagged_pre, "the new regime is flagged more than "
          "the armed guardrail's own traffic")

    # lockstep: both paths from the kernel path's state before each admit
    gk = engine.Guardrail(gcfg, use_kernels=True, device=device, w=g.w)
    gp = engine.Guardrail(gcfg, use_kernels=False, device=device, w=g.w)
    cfg, gate = gk.ace_cfg, 0.5 * gcfg.warmup_items
    lead = tuple(gk.state.qhist.shape[:-1])
    expect = np.zeros(lead, np.float64)
    ids_same = ids_total = rows_same = verdicts_differ = 0
    for e, t in batches():
        st = gk.state
        gp.state = clone_state(st)
        feat = mean_embed_features(e, gcfg.bias_const)
        finite = torch.all(torch.isfinite(feat), dim=-1)
        feat = torch.where(finite[:, None], feat, 0.0)
        ids_k = mods["srp_hash"].srp_hash(feat, gk.w, cfg.srp)
        ids_p = hash_buckets(feat, gk.w, cfg.srp)
        ids_same += int((ids_k == ids_p).sum())
        ids_total += ids_k.numel()
        agree = torch.all(ids_k == ids_p, dim=1).cpu().numpy()
        n_gate = (ring.combined_n(st, gcfg.window_decay) if windowed
                  else st.n).cpu().numpy()
        cur = st.cursor.cpu().numpy() if windowed else None
        obs = finite.cpu().numpy() & (
            (n_gate if T is None else n_gate[t]) >= gate)
        mk, mp = gk.admit(e, t), gp.admit(e, t)
        rows_same += int(agree.sum())
        verdicts_differ += int((mk != mp)[agree].sum())
        if T is None and not windowed:
            expect += obs.sum()
        elif T is None:
            expect[cur] += obs.sum()
        elif not windowed:
            np.add.at(expect, t, obs)
        else:
            np.add.at(expect, (t, cur[t]), obs)
        if windowed:                 # a rotation retires the row it enters
            new = gk.state.cursor.cpu().numpy()
            moved = np.nonzero(np.atleast_1d(new != cur))[0]
            if T is None and moved.size:
                expect[new] = 0.0
            elif T is not None:
                expect[moved, new[moved]] = 0.0
    share = ids_same / ids_total
    check(share >= 0.999, f"kernel path ids equal the plain path's "
          f"({share:.6f} >= 0.999)")
    check(verdicts_differ == 0, f"verdicts equal the plain path's on every "
          f"row whose ids agree ({rows_same} of {admits * b} rows, from "
          "the same state before each admit)")
    for name, gg in (("kernel", gk), ("plain", gp)):
        got = gg.state.qhist.sum(dim=-1).double().cpu().numpy()
        check(np.array_equal(got, expect), f"{name} path: every histogram "
              f"row's total equals the finite rows observed past the "
              f"half-warmup gate ({int(expect.sum())} in all)")
    path = {"flat": ("ace_admit_fused", "ace_query"),
            "fleet_window": ("ace_fleet_window_admit", "ace_query")}.get(
                kind, ("srp_hash", "ace_query", "ace_update"))
    for k in path:
        check(launches[k] > 0, f"quantile guardrail ({kind}) path "
              f"launched {k}")

    # both rules' admits in turns on the same batches (which goes first
    # alternates), so their p50s share the host's state of the moment
    arms = {mode: engine.Guardrail(dataclasses.replace(
        gcfg, threshold_mode=mode), device=device, w=g.w)
        for mode in ("quantile", "mu_sigma")}
    lat = {mode: [] for mode in arms}
    for i, (e, t) in enumerate(batches()):
        for mode in (list(arms) if i % 2 else list(arms)[::-1]):
            t0 = time.perf_counter()
            arms[mode].admit(e, t)
            lat[mode].append(time.perf_counter() - t0)
    turns = {mode: 1e3 * statistics.median(v) for mode, v in lat.items()}
    print(f"  in turns, admit by admit: quantile p50 "
          f"{turns['quantile']:.3f} ms, mu-sigma {turns['mu_sigma']:.3f} ms "
          f"(ratio {turns['quantile'] / turns['mu_sigma']:.3f}; host "
          "clock)")
    e, t = next(batches())
    return {"launches": launches, "p50_ms": p50, "guardrail": g,
            "p50_turns_ms": turns,
            "breakdown": admit_breakdown(g, e, t, device)}


def calibration_fpr(flags, tids, y, T):
    """Per-tenant false-positive rates over the armed pre-burst band and
    the burst recall of (steps, B) flags."""
    band = slice(CAL_ARM, CAL_STREAM["burst_from"])
    out = {}
    for t in range(T):
        sel = (tids[band] == t) & ~y[band]
        out[f"fpr_{CAL_TENANTS[t]}"] = float(flags[band][sel].mean())
    burst = slice(CAL_STREAM["burst_from"], None)
    out["recall_burst"] = float(flags[burst][y[burst]].mean())
    return out


def phase_calibration(mods, device) -> dict:
    """``benchmarks/quantile_bench.py``'s calibration scenario at its full
    shape through ``FleetDataFilter`` + ``StreamRunner`` in both modes,
    held to that benchmark's gates."""
    from repro_torch.fleet.filter import FleetDataFilter
    from repro_torch.stream.runner import StreamRunner
    steps, B, dim, T = (CAL_SHAPE[k] for k in ("steps", "batch", "dim",
                                                "T"))
    stream = calibration_stream(**CAL_SHAPE, **CAL_STREAM)
    raw = torch.as_tensor(np.stack([x for x, _, _ in stream]), device=device)
    tids = np.stack([x[1] for x in stream])
    y = np.stack([x[2] for x in stream]).astype(bool)
    dev_tids = torch.as_tensor(tids, device=device)
    q = CAL_Q
    out, launches = {}, None
    for mode in ("mu_sigma", "quantile"):
        filt = FleetDataFilter(d_model=dim, num_tenants=T, **CAL_FILTER,
                               threshold_mode=mode, quantile_q=q,
                               device=device)
        runner = StreamRunner(filt, chunk_T=CAL_CHUNK_T, return_masks=True)
        state, w = runner.init()
        feats = filt.features(raw.reshape(-1, 1, dim)).reshape(
            steps, B, dim + 1)
        if mode == "quantile":
            reset_launches(mods)
        keeps = []
        t0 = time.perf_counter()
        for c in range(steps // CAL_CHUNK_T):
            sl = slice(c * CAL_CHUNK_T, (c + 1) * CAL_CHUNK_T)
            state, _, k = runner.consume(state, w, feats[sl], dev_tids[sl])
            keeps.append(k)
        flags = ~torch.cat(keeps).cpu().numpy()
        secs = time.perf_counter() - t0
        if mode == "quantile":
            launches = read_launches(mods)
        out[mode] = calibration_fpr(flags, tids, y, T)
        print(f"  calibration ({mode}): {steps} steps of {B} x {dim + 1}, "
              f"T={T}, K={CAL_FILTER['num_bits']}, L="
              f"{CAL_FILTER['num_tables']}, alpha={CAL_FILTER['alpha']}, "
              f"q={q}; per-tenant FPR over steps {CAL_ARM}-"
              f"{CAL_STREAM['burst_from']}: "
              + ", ".join(f"{n} {out[mode][f'fpr_{n}']:.4f}"
                          for n in CAL_TENANTS)
              + f"; burst recall {out[mode]['recall_burst']:.4f} "
              f"({secs:.3f} s, host clock)")
    qt, mu = out["quantile"], out["mu_sigma"]
    for n in CAL_TENANTS:
        check(q / 2 <= qt[f"fpr_{n}"] <= 2 * q, f"quantile mode holds the "
              f"{n} tenant's FPR {qt[f'fpr_{n}']:.4f} inside [q/2, 2q]")
    check(mu["fpr_light"] < q / 2, f"mu-sigma under-flags the light tenant "
          f"({mu['fpr_light']:.4f} < q/2)")
    check(mu["fpr_bimodal"] > 2 * q, f"mu-sigma over-flags the bimodal "
          f"tenant ({mu['fpr_bimodal']:.4f} > 2q)")
    check(qt["recall_burst"] >= 0.8, f"quantile burst recall "
          f"{qt['recall_burst']:.4f} >= 0.8")
    for k in ("srp_hash", "ace_query", "ace_update"):
        check(launches[k] > 0, f"calibration (quantile) path launched {k}")
    return {"launches": launches, **{f"{m}_{k}": v for m, r in out.items()
                                     for k, v in r.items()}}


def phase_quantile_stream(mods, device, d_model=D_MODEL,
                          chunks=STREAM_CHUNKS, T=STREAM_T,
                          B=STREAM_B) -> dict:
    """Phase 5's fleet stream with ``threshold_mode="quantile"``: one
    transfer each way a chunk and no sync inside ``consume``, then
    items/s beside the mu-sigma fleet's, the two runners taking the
    chunks in turns."""
    import repro_torch.stream.runner as runner_mod
    feats, _ = stream_features(device, d_model, chunks, T, B)
    tids = np.random.default_rng(SEED + 9).integers(
        0, FLEET_T, size=(chunks * T, B)).astype(np.int32)
    filt = stream_filter("fleet", device, d_model,
                         threshold_mode="quantile", quantile_q=QUANT_Q)
    runner = runner_mod.StreamRunner(filt, chunk_T=T)
    state, w, sums, secs, launches, transfers = instrumented_run(
        mods, runner, device, feats, tids, T)
    print(f"  stream path (fleet, quantile): {chunks} chunks of {T} x {B} x "
          f"{d_model + 1}; {chunks * T * B / secs:,.0f} items/s "
          f"({secs:.3f} s, host clock); launches {launches}")
    check(transfers == {"h2d": chunks, "d2h": chunks},
          f"one H2D and one D2H per chunk ({transfers}), no host sync "
          "inside consume (sync debug mode 'error')")
    check(all(int(x.quarantined) == T for x in sums),
          "quarantined == 1 per step in every chunk")
    total = float(state.qhist.sum())
    check(0 < total <= chunks * T * (B - 1) and total == int(total),
          f"the histograms hold {int(total)} observations, whole, at most "
          "the finite rows")
    for k in ("srp_hash", "ace_query", "ace_update"):
        check(launches[k] > 0, f"stream path (fleet, quantile) launched {k}")

    # items/s of both modes, the runners taking the chunks in turns
    arms = {}
    for mode in ("mu_sigma", "quantile"):
        f = stream_filter("fleet", device, d_model, threshold_mode=mode,
                          quantile_q=QUANT_Q)
        r = runner_mod.StreamRunner(f, chunk_T=T)
        st, ww = r.init()
        r.run(st, ww, iter(feats[:T]), iter(tids[:T]))     # warm, thrown away
        arms[mode] = [r, *r.init(), 0.0]
    sync(device)
    for c in range(chunks):
        sl = slice(c * T, (c + 1) * T)
        for arm in arms.values():
            r, st, ww, _ = arm
            t0 = time.perf_counter()
            arm[1], _ = r.run(st, ww, iter(feats[sl]), iter(tids[sl]))
            arm[3] += time.perf_counter() - t0
    rate = {m: chunks * T * B / a[3] for m, a in arms.items()}
    print(f"  in turns, chunk by chunk: quantile {rate['quantile']:,.0f} "
          f"items/s, mu-sigma {rate['mu_sigma']:,.0f} items/s (ratio "
          f"{rate['quantile'] / rate['mu_sigma']:.3f}; host clock)")
    breakdown = stream_breakdown(runner, state, w, feats[:T], device,
                                 torch.as_tensor(tids[:T], device=device))
    return {"launches": launches, "items_per_s": rate["quantile"],
            "mu_sigma_items_per_s": rate["mu_sigma"],
            "run_items_per_s": chunks * T * B / secs,
            "breakdown": breakdown}


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


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
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

    h, q = mods["srp_hash"], mods["ace_query"]
    ids = h.srp_hash(feat, gw.w, gw.ace_cfg.srp)
    wts = ring.epoch_weights(gw.state.cursor, WIN_E, WIN_GAMMA)
    counts = gw.state.counts
    tmask = torch.ones(L, device=device)
    tmask[[3, 31]] = 0.0
    tw = tmask / tmask.sum()
    Uw = WIN_E * distinct_counters(ids, nb)
    # unweighted and weighted (two tables masked), in turns
    order = [("kernel", lambda: wc.ace_window_combine(counts, ids, wts)),
             ("weighted", lambda: wc.ace_window_combine(counts, ids, wts,
                                                        tw))]
    runs = {k: [] for k, _ in order}
    for k, fn in order + order[::-1]:
        runs[k].append(device_ms(fn))
    out["ace_window_combine"] = dict(
        ms=statistics.mean(runs["kernel"]),
        weighted_ms=statistics.mean(runs["weighted"]), runs=runs,
        plain_ms=device_ms(lambda: wc.ace_window_combine_plain(counts, ids,
                                                               wts)),
        library_ms=None, shape=f"B={B}, E={WIN_E}, L={L}, 2^K={nb}, "
        f"counters touched {Uw}",
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * B * WIN_E * L, 4 * B * L + 4 * Uw + 4 * WIN_E + 4 * B))))

    # the fleet score in turns with the composition it matches bitwise
    # (srp_hash + the routed ace_query_sum, the SRHT and masked branch of
    # ops.ace_fleet_score)
    fc, fcfg = gf.state.counts, gf.ace_cfg.srp
    fids = h.srp_hash(feat, gf.w, fcfg)
    table_rows = mods["ace_update"].table_rows
    rows = table_rows(fids, tids.long() * L)
    Uf = int(torch.unique(rows * nb + fids.long()).numel())
    base = (tids * L).contiguous()
    flat = fc.view(FLEET_T * L, nb)
    order = [("composition", lambda: q.ace_query_sum(
                 flat, h.srp_hash(feat, gf.w, fcfg), base)),
             ("kernel", lambda: fs.ace_fleet_score(fc, feat, tids, gf.w,
                                                   fcfg))]
    runs = {k: [] for k, _ in order}
    for k, fn in order + order[::-1]:
        runs[k].append(device_ms(fn))
    out["ace_fleet_score"] = dict(
        ms=statistics.mean(runs["kernel"]),
        composition_ms=statistics.mean(runs["composition"]), runs=runs,
        plain_ms=device_ms(lambda: fs.ace_fleet_score_plain(
            fc, feat, tids, gf.w, fcfg)),
        library_ms=None, shape=f"B={B}, d={d}, T={FLEET_T}, K={K_BITS}, "
        f"L={L}, counters touched {Uf}",
        plan=h.device_plan(B, d, K_BITS, L, device).describe(),
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
        extra = "".join(f", {n} {v[f'{n}_ms']:.5f} ms"
                        for n in ("weighted", "composition")
                        if f"{n}_ms" in v)
        print(f"  {k:16s} {v['shape']}: kernel {v['ms']:.5f} ms{extra}, "
              f"plain {v['plain_ms']:.5f} ms, library null, bound "
              f"{v['bound_ms']:.5f} ms ({v['bound_by']}), "
              f"{100 * v['bound_ms'] / v['ms']:.1f}% of bound"
              + (f" (each the mean of two medians taken in turns: "
                 f"{v['runs']})" if "runs" in v else ""))
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
    hh = dict(ms=device_ms(order[0][1]),
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
          f"back to back; one call alone {hh['one_call_ms']:.5f} ms against "
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
    C = 256, topk = 8, a sketch with three planted coordinates),
    ``ops.ace_score`` at the estimator's score shape (B = 16,384, d = 36,
    K = 15, L = 50, counts of the fit's first batch; unweighted and with
    two tables masked), and ``ops.ace_window_score`` (unmasked and with
    two tables masked) and ``ops.ace_fleet_score`` at phase 6's query
    shape (B = 256, d = 4097, K = 15, L = 50, E = 4, T = 8), through
    whichever ``repro_torch`` is first on the path, on inputs made here
    from SEED: two checkouts time the same work through the same public
    functions (``scripts/kernel_ab.py``)."""
    from repro_torch.attribution import sketch as at
    from repro_torch.core import sketch as sk
    from repro_torch.core.srp import make_projections
    from repro_torch.fleet import state as fl
    from repro_torch.kernels import ops
    from repro_torch.window import ring
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
    # phase 6's queries: a ring and a fleet of counters up to 2^20
    B, dq, nb = ADMIT_B, D_MODEL + 1, 1 << K_BITS
    qcfg = sk.AceConfig(dim=dq, num_bits=K_BITS, num_tables=L_TABLES,
                        seed=41)
    qw = make_projections(qcfg.srp, device=device)
    qx = torch.randn((B, dq), generator=gen, device=device)
    qids = torch.randint(0, nb, (B, L_TABLES), generator=gen, device=device,
                         dtype=torch.int32)
    wst = ring.init(qcfg, WIN_E, device)._replace(
        counts=torch.randint(0, 1 << 20, (WIN_E, L_TABLES, nb),
                             generator=gen, device=device,
                             dtype=torch.int32),
        cursor=torch.tensor(1, dtype=torch.int32, device=device))
    fst = fl.init(fl.FleetConfig(ace=qcfg, num_tenants=FLEET_T),
                  device)._replace(
        counts=torch.randint(0, 1 << 20, (FLEET_T, L_TABLES, nb),
                             generator=gen, device=device,
                             dtype=torch.int32))
    qtids = (torch.arange(B, device=device) % FLEET_T).to(torch.int32)
    qshape = f"B={B}, K={K_BITS}, L={L_TABLES}"
    return {
        "ops.ace_window_score": {"by_shape": [
            {"shape": f"{qshape}, E={WIN_E}", "ms": device_ms(
                lambda: ops.ace_window_score(wst, qids, WIN_GAMMA))},
            {"shape": f"{qshape}, E={WIN_E}, 2 tables masked",
             "ms": device_ms(lambda: ops.ace_window_score(
                 wst, qids, WIN_GAMMA, table_mask=tmask))}]},
        "ops.ace_fleet_score": {"by_shape": [
            {"shape": f"{qshape}, d={dq}, T={FLEET_T}", "ms": device_ms(
                lambda: ops.ace_fleet_score(fst, qx, qtids, qw, qcfg))}]},
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


def srht_bound(B: int, d: int, cfg, x_bytes: int = 4):
    """The SRHT's bound: its adds, sign flips and sampled compares at the
    add rate against x (``x_bytes`` an element), the signs, the row sample
    and the ids in bytes."""
    from repro_torch.core.srht import next_pow2
    d_pad = next_pow2(max(d, 2))
    log2 = d_pad.bit_length() - 1
    m = cfg.num_projections
    ops = B * (2 * d_pad * log2 + 2 * d_pad + m)
    nbytes = (x_bytes * B * d + 2 * 4 * d_pad + 4 * m
              + 4 * B * cfg.num_tables)
    t_ops, t_bytes = ops / PEAK_FP32_ADDS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Phase 2, count dtypes: the seven kernels that read or add counters, in
# the reference's other count dtypes, against their plain versions.
# ---------------------------------------------------------------------------

NARROW_KERNELS = ("ace_update", "ace_query", "ace_admit_fused",
                  "ace_score_fused", "ace_window_combine", "ace_fleet_score",
                  "ace_fleet_window_admit")
COUNT_DTYPES = ("int16", "int8", "float32")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_kernels_dtypes(mods, device, fit_batch=FIT_BATCH, d_model=D_MODEL,
                         admit_b=ADMIT_B, n_queries=N_QUERIES) -> dict:
    """Phase 2 in int16, int8 and float32 counters, at the main paths'
    shapes, each kernel against its plain version on the card, bitwise
    downstream of the kernel's own ids: ``ace_update`` on the fit batch
    (with a row mask; the whole batch in one bucket a table from the cap,
    so narrow counters wrap; the rows on four neighbouring buckets of one
    32-bit word, the int8 compare-and-swap's contention), ``ace_query``
    and ``ace_query_sum`` in every scale, ``ace_admit_fused`` on random,
    colliding and stream-step batches, ``ace_score_fused`` at the
    estimator's score shape in both forms, and on the windowed fleet's
    (T·E·L, 2^15) ring in each dtype ``ace_update``/``ace_query_sum`` at
    per-item base rows, ``ace_window_combine``, ``ace_fleet_score`` and
    ``ace_fleet_window_admit``.  Returns {kernel: {dtype: max_abs_err}}."""
    from repro_torch.core.srp import SrpConfig, make_projections
    h, u, q, a, f, wc, fs, fwa = (mods[k] for k in (
        "srp_hash", "ace_update", "ace_query", "ace_admit_fused",
        "ace_score_fused", "ace_window_combine", "ace_fleet_score",
        "ace_fleet_window_admit"))
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    err = {k: {dt: 0.0 for dt in COUNT_DTYPES} for k in NARROW_KERNELS}
    L, K, nb = L_TABLES, K_BITS, 1 << K_BITS

    def same(kernel, dt, x, y) -> bool:
        err[kernel][dt] = max(err[kernel][dt], max_err(x, y))
        return torch.equal(x, y)

    cfg = SrpConfig(dim=KDD_D, num_bits=K, num_tables=L)
    w = make_projections(cfg, device=device)
    x = torch.as_tensor(kdd_like(fit_batch, KDD_D,
                                 np.random.default_rng(SEED + 1)),
                        device=device)
    kb = h.srp_hash(x, w, cfg)
    base = torch.randint(0, 9, (L, nb), generator=gen, device=device,
                         dtype=torch.int32)
    rmask = torch.rand((fit_batch,), generator=gen, device=device) < 0.5
    hot = torch.full_like(kb, 12345)
    word = (400 + torch.arange(fit_batch, device=device) % 4)[:, None] \
        .expand(fit_batch, L).to(torch.int32).contiguous()
    tmask = torch.ones(L, device=device)
    tmask[[3, 31]] = 0.0
    acfg = SrpConfig(dim=d_model + 1, num_bits=K, num_tables=L, seed=41)
    aw = make_projections(acfg, device=device)
    qr = torch.randn((admit_b, d_model + 1), generator=gen, device=device)
    qc = qr[: admit_b // 8].repeat(8, 1).contiguous()
    amask = torch.rand((admit_b,), generator=gen, device=device) < 0.9
    scfg = SrpConfig(dim=d_model + 1, num_bits=STREAM_K,
                     num_tables=STREAM_L, seed=47)
    sw = make_projections(scfg, device=device)
    sq = torch.randn((STREAM_B, d_model + 1), generator=gen, device=device)
    sbase = torch.randint(0, 9, (STREAM_L, 1 << STREAM_K), generator=gen,
                          device=device, dtype=torch.int32)
    qs = torch.as_tensor(kdd_like(n_queries, KDD_D,
                                  np.random.default_rng(SEED + 4)),
                         device=device)
    ids_s = h.srp_hash(qs, w, cfg)
    agree_s = (ids_s == h.srp_hash_plain(qs, w, cfg)).all(dim=1)
    for dt in COUNT_DTYPES:
        tdt = getattr(torch, dt)
        c0 = base.to(tdt)
        tag = f"[{dt}]"
        # ace_update
        capped = c0.clone()
        if dt != "float32":
            capped[:, 12345] = torch.iinfo(tdt).max
        for name, c, ids_, m in (
                ("fit batch", c0, kb, None), ("row mask", c0, kb, rmask),
                (f"all {fit_batch} rows in one bucket a table, from the cap",
                 capped, hot, None),
                ("the same, row mask", capped, hot, rmask),
                ("four neighbouring buckets of one word", c0, word, None),
                ("four buckets of one word, row mask", c0, word, rmask)):
            ck = u.ace_update(c.clone(), ids_, row_mask=m)
            cp = u.ace_update_plain(c.clone(), ids_, m)
            check(same("ace_update", dt, ck, cp), f"ace_update {tag} "
                  f"({name}) bitwise equal to plain")
            if ids_ is hot:
                n_in = fit_batch if m is None else int(m.sum())
                want = (capped[:, 12345].to(torch.int64) + n_in)
                want = want.to(tdt) if dt != "float32" else want.float()
                check(torch.equal(ck[:, 12345], want), f"ace_update {tag}: "
                      f"{n_in} adds to a counter at "
                      f"{capped[0, 12345].item():g} give "
                      f"{ck[0, 12345].item():g}, the reference's add in "
                      f"{dt} (a narrow counter wraps past its max)")
        # ace_query: the (B, L) gather and the sum in every scale
        ck = u.ace_update(c0.clone(), kb)
        gk, gp = q.ace_query(ck, kb), q.ace_query_plain(ck, kb)
        check(same("ace_query", dt, gk, gp), f"ace_query {tag} (B, L) "
              "gather bitwise equal to plain")
        wide = q.ace_query_sum(ck.to(torch.int32), kb)
        for scale in q.SCALES:
            for m in (None, tmask):
                got = q.ace_query_sum(ck, kb, table_mask=m, scale=scale)
                ref = q.ace_query_sum_plain(ck, kb, table_mask=m, scale=scale)
                check(same("ace_query", dt, got, ref), f"ace_query_sum {tag} "
                      f"({scale}{', 2 tables masked' if m is not None else ''}"
                      ") bitwise equal to plain")
        check(torch.equal(q.ace_query_sum(ck, kb), wide), f"ace_query_sum "
              f"{tag} bitwise the int32 plane's on the same counters")
        # ace_admit_fused: random, colliding, the stream step
        for name, qb, c, wb, cb, mb in (
                ("random", qr, c0, aw, acfg, amask),
                ("colliding", qc, c0, aw, acfg, amask),
                ("stream step", sq, sbase.to(tdt), sw, scfg, None)):
            nt = cb.num_tables
            rr = torch.arange(nt, device=device)[None, :]
            rc = torch.tensor(1.0 / nt, dtype=torch.float32)
            pre = h.srp_hash_plain(qb, wb, cb)
            thresh = torch.median(c[rr, pre.long()].float().sum(-1) * rc)
            ck, sk_, ak, bk = a.ace_admit_fused(c.clone(), qb, wb, thresh, cb,
                                                item_mask=mb)
            ref_s = c[rr, bk.long()].float().sum(-1) * rc
            ref_a = ref_s >= thresh
            if mb is not None:
                ref_a = ref_a & mb
            ref_c = c.clone().index_put_(
                (rr, bk.long()), ref_a.to(tdt)[:, None].expand(bk.shape),
                accumulate=True)
            check(all([same("ace_admit_fused", dt, sk_, ref_s),
                       same("ace_admit_fused", dt, ak, ref_a),
                       same("ace_admit_fused", dt, ck, ref_c)]),
                  f"ace_admit_fused {tag} ({name}) scores, admit mask and "
                  "counts bitwise downstream of its own ids")
            share = agreement(bk, h.srp_hash_plain(qb, wb, cb))
            check(share >= 0.999, f"ace_admit_fused {tag} ({name}) ids "
                  f"agree with plain: {share:.6f} >= 0.999")
        # ace_score_fused at the estimator's score shape, both forms
        ck_fit = u.ace_update(c0.clone(), kb)
        for name, tw in (("unweighted", None),
                         ("weighted, 2 tables masked", tmask / tmask.sum())):
            sk_, kid = f.ace_score_fused_planned(ck_fit, qs, w, cfg, tw, None,
                                                 with_ids=True)
            if tw is None:
                ref = q.ace_query_sum(ck_fit, kid)
            else:
                ref = f.table_order_sum(f.flat_table_gather(ck_fit, kid), tw)
            sp = f.ace_score_fused_plain(ck_fit, qs, w, cfg, tw)
            same("ace_score_fused", dt, sk_[agree_s], sp[agree_s])
            check(torch.equal(kid, ids_s) and torch.equal(sk_, ref)
                  and torch.equal(sk_[agree_s], sp[agree_s]),
                  f"ace_score_fused {tag} ({name}): ids srp_hash's, scores "
                  f"bitwise its own ids' and plain on the {int(agree_s.sum())}"
                  f" of {n_queries} rows whose ids agree")
    del base, capped

    # the windowed fleet's ring in each dtype
    T, E = FLEET_T, WIN_E
    x6 = torch.randn((admit_b, d_model + 1), generator=gen, device=device)
    ids6 = h.srp_hash(x6, aw, acfg)
    ring32 = torch.randint(0, 9, (T, E, L, nb), generator=gen, device=device,
                           dtype=torch.int32)
    tail = torch.randint(0, 40, (T, L, nb), generator=gen,
                         device=device).float() * 0.9
    cursor = torch.randint(0, E, (T,), generator=gen, device=device,
                           dtype=torch.int32)
    tids = (torch.arange(admit_b, device=device) % T).to(torch.int32)
    live = ((tids.long() * E + cursor.long()[tids.long()]) * L) \
        .to(torch.int32)
    routed = (torch.rand((T, L), generator=gen, device=device) < 0.9).float()
    weights = WIN_GAMMA ** torch.arange(E, dtype=torch.float32, device=device)
    plan = h.device_plan(admit_b, d_model + 1, K, L, device)
    agree6 = (ids6 == h.srp_hash_plain(x6, aw, acfg)).all(dim=1)
    xc6 = x6[: admit_b // 8].repeat(8, 1).contiguous()
    tc6 = tids[: admit_b // 8].repeat(8).contiguous()
    pre = fwa.fleet_window_admit_from_ids(
        ring32.clone(), tail, cursor, ids6, tids,
        torch.full((T,), float("-inf"), device=device))[0]
    thr = torch.stack([torch.median(pre[tids == t]) for t in range(T)])
    for dt in COUNT_DTYPES:
        tdt = getattr(torch, dt)
        tag = f"[{dt}]"
        ring = ring32.to(tdt)
        flat = ring.view(T * E * L, nb)
        ck = u.ace_update(flat.clone(), ids6, row_mask=amask, row_base=live)
        cp = u.ace_update_plain(flat.clone(), ids6, amask, live)
        check(same("ace_update", dt, ck, cp), f"ace_update {tag} at "
              f"per-item base rows of the ({T * E * L}, 2^{K}) ring bitwise "
              "equal to plain")
        for scale in q.SCALES:
            got = q.ace_query_sum(ck, ids6, live, table_mask=routed,
                                  tenant_ids=tids, scale=scale,
                                  with_unmasked=True)
            ref = q.ace_query_sum_plain(ck, ids6, live, table_mask=routed,
                                        tenant_ids=tids, scale=scale,
                                        with_unmasked=True)
            check(all([same("ace_query", dt, got[0], ref[0]),
                       same("ace_query", dt, got[1], ref[1])]),
                  f"ace_query_sum {tag} ({scale}) at per-item base rows, a "
                  "routed (T, L) mask, with the unmasked sum: bitwise plain")
        for name, tw in (("unweighted", None),
                         ("weighted, 2 tables masked", tmask / tmask.sum())):
            got = wc.ace_window_combine(ring[0], ids6, weights, tw)
            ref = wc.ace_window_combine_plain(ring[0], ids6, weights, tw)
            check(same("ace_window_combine", dt, got, ref),
                  f"ace_window_combine {tag} ({name}) bitwise equal to plain "
                  f"at B={admit_b}, E={E}, L={L}, K={K}")
        live0 = ring[:, 0].contiguous()
        got, fids = fs.ace_fleet_score_planned(live0, x6, tids, aw, acfg,
                                               plan, with_ids=True)
        ref = q.ace_query_sum(live0.view(T * L, nb), fids,
                              (tids * L).contiguous())
        sp = fs.ace_fleet_score_plain(live0, x6, tids, aw, acfg)
        same("ace_fleet_score", dt, got[agree6], sp[agree6])
        check(torch.equal(fids, h.srp_hash_planned(x6, aw, acfg, plan))
              and same("ace_fleet_score", dt, got, ref)
              and torch.equal(got[agree6], sp[agree6]),
              f"ace_fleet_score {tag}: ids srp_hash's under one plan, "
              "scores bitwise srp_hash + the routed ace_query_sum and plain "
              f"on the {int(agree6.sum())} of {admit_b} rows whose ids agree")
        for name, qb, tb in (("random", x6, tids), ("colliding", xc6, tc6)):
            r = ring.clone()
            out = fwa.ace_fleet_window_admit_fused(r, tail, cursor, qb, tb, aw,
                                                   thr, acfg, item_mask=amask)
            r_ref = ring.clone()
            ref = (r_ref, *fwa.fleet_window_admit_from_ids(
                r_ref, tail, cursor, out[3], tb, thr, amask))
            ok = all([same("ace_fleet_window_admit", dt, x_, y_)
                      for x_, y_ in ((r, ref[0]), (out[1], ref[1]),
                                     (out[2], ref[2]), (out[4], ref[3]),
                                     (out[5], ref[4]))])
            check(ok and torch.equal(out[3],
                                     h.srp_hash_planned(qb, aw, acfg, plan)),
                  f"ace_fleet_window_admit {tag} ({name}): ids srp_hash's; "
                  "ring, scores, admit mask and both sums bitwise downstream "
                  "of its own ids")
        del ring, flat, ck, cp
    return err


# ---------------------------------------------------------------------------
# Phase 10: narrow count planes end to end, each in lockstep with int32.
# ---------------------------------------------------------------------------

NARROW_ESC = 4096        # escalation slots of the promoted flat sketches


def widened(state) -> torch.Tensor:
    """A state's counts as int32: narrow ones widened, a quantized plane's
    densified through its escalation table."""
    from repro_torch.core import quantize as qz
    if getattr(state, "esc", None) is not None:
        return qz.densify(state.counts, state.esc)
    return state.counts.to(torch.int32)


def lockstep(mods, what, gn, g32, batches) -> dict:
    """Each batch admitted by the narrow guardrail ``gn`` and its int32 twin
    ``g32`` (one W, both empty to start) in turns, the order alternating,
    each admit timed (host clock, ends in the verdict transfer); the
    launch counts set to 0 just before each narrow admit and read just
    after.  Checked after every admit: the verdicts equal, and the narrow
    counts widened (densified through the escalation table) bitwise the
    int32 twin's while its largest counter stays at most the narrow cap.
    An admit that takes a counter of an unpromoted narrow plane past its
    cap must leave the narrow counts the int32 ones wrapped into the
    narrow dtype (the reference's add); from there the two are different
    sketches and are not compared."""
    cap = torch.iinfo(gn.state.counts.dtype).max
    promoted = getattr(gn.state, "esc", None) is not None
    launches = {k: 0 for k in launch_counters(mods)}
    t_n, t_32, compared, wrapped_at = [], [], 0, None
    for i, (e, t) in enumerate(batches):
        order = (gn, g32) if i % 2 == 0 else (g32, gn)
        masks = {}
        for g in order:
            if g is gn:
                reset_launches(mods)
            t0 = time.perf_counter()
            masks[id(g)] = g.admit(e, t)
            (t_n if g is gn else t_32).append(time.perf_counter() - t0)
            if g is gn:
                for k, v in read_launches(mods).items():
                    launches[k] += v
        if wrapped_at is not None:
            continue
        check(np.array_equal(masks[id(gn)], masks[id(g32)]),
              f"{what}: admit {i + 1} verdicts equal the int32 twin's")
        top = int(g32.state.counts.max())
        if promoted or top <= cap:
            check(torch.equal(widened(gn.state), g32.state.counts),
                  f"{what}: after admit {i + 1} the counts, "
                  f"{'densified' if promoted else 'widened'}, are bitwise "
                  f"the int32 twin's (largest counter {top})")
            compared += 1
        else:
            check(torch.equal(gn.state.counts,
                              g32.state.counts.to(gn.state.counts.dtype)),
                  f"{what}: admit {i + 1} takes a counter to {top}, past "
                  f"{cap}: the narrow counts are the int32 ones wrapped, "
                  "add for add; from here the sketches differ")
            wrapped_at = i + 1
    p50_n, p50_32 = (1e3 * statistics.median(x) for x in (t_n, t_32))
    print(f"  {what}: admit p50 {p50_n:.3f} ms, int32 twin {p50_32:.3f} ms "
          f"(in turns); {compared} admits compared bitwise"
          + ("" if wrapped_at is None else
             f", wrapped at admit {wrapped_at}")
          + f"; memory_bytes {gn.memory_bytes():,} (int32 "
          f"{g32.memory_bytes():,}); launches {launches}")
    return {"launches": launches, "p50_ms": p50_n, "int32_p50_ms": p50_32,
            "compared": compared, "wrapped_at": wrapped_at,
            "memory_bytes": gn.memory_bytes(),
            "int32_memory_bytes": g32.memory_bytes()}


def phase_narrow(mods, device, est, d_model=D_MODEL) -> dict:
    """Phase 10: every narrow flavour beside its int32 twin on the same W
    and traffic.  Flat guardrails at phase 4's width on its traffic: int16
    (3,276,800 B of counters at K = 15, L = 50) and int8 with
    ``esc_capacity`` so hot counters pass 127; the windowed, fleet and
    windowed-fleet guardrails with int8 rings on phase 6's traffic; the
    queries on the narrow states (``ops.ace_score`` on the int16 sketch,
    ``ops.ace_window_score`` and ``ops.ace_fleet_score`` on the int8
    rings); ``AceEstimator`` at phase 3's KDD shape in int16 with
    promotion (``est``: phase 3's int32 fit); phase 5's dense stream in
    int16.  Returns {path: result}."""
    from repro_torch.core import quantize as qz
    from repro_torch.core.estimators import AceEstimator
    from repro_torch.core.sketch import AceConfig
    from repro_torch.data.pipeline import mean_embed_features
    from repro_torch.kernels import ops
    from repro_torch.stream.runner import StreamRunner
    from repro_torch.serve.engine import Guardrail, GuardrailConfig
    from repro_torch.window import ring
    out = {}
    base = dict(d_model=d_model, num_bits=K_BITS, num_tables=L_TABLES)
    guards = {}
    flavours = [("flat_int16", dict(count_dtype="int16"), "phase4"),
                ("flat_int8", dict(count_dtype="int8"), "phase4"),
                ("flat_int8_esc", dict(count_dtype="int8",
                                       esc_capacity=NARROW_ESC), "phase4")]
    flavours += [(f"{k}_{dt}", dict(count_dtype=dt, **GUARD_KINDS[k]),
                  "phase6") for dt in ("int16", "int8") for k in GUARD_KINDS]
    for name, kw, traffic in flavours:
        dt = kw["count_dtype"]
        extra = {k: v for k, v in kw.items()
                 if k not in ("count_dtype", "esc_capacity")}
        g32 = Guardrail(GuardrailConfig(**base, **extra), device=device)
        gn = Guardrail(GuardrailConfig(**base, **kw), device=device, w=g32.w)
        T = gn.gcfg.num_tenants if gn.gcfg.num_tenants > 1 else None
        batches = (((e, None) for e, _ in guardrail_batches(
            device, d_model, ADMITS, ADMIT_B, ADMIT_S))
            if traffic == "phase4" else shift_batches(
                device, d_model, SHIFT_ADMITS, ADMIT_B, ADMIT_S, SHIFT_AT, T))
        r = lockstep(mods, f"guardrail {name}", gn, g32, batches)
        st = gn.state
        check(st.counts.dtype == getattr(torch, dt),
              f"guardrail {name} keeps {dt} counts")
        if dt == "int16":
            check(r["wrapped_at"] is None, f"guardrail {name}: no counter "
                  "reaches the int16 cap on this traffic; every admit "
                  "bitwise the int32 twin's")
        if name == "flat_int16":
            check(gn.memory_bytes() == 3_276_800,
                  f"int16 flat sketch: memory_bytes {gn.memory_bytes():,} "
                  "B (L x 2^K x 2, under 4 MB); largest counter "
                  f"{int(st.counts.max())}")
        if name == "flat_int8_esc":
            slots = int((st.esc.offs != qz.SENTINEL).sum())
            print(f"  guardrail {name}: {slots} promoted slots of "
                  f"{NARROW_ESC}, lost {float(st.esc.lost):g}, largest "
                  f"logical counter {int(widened(st).max())}")
            check(slots > 0 and float(st.esc.lost) == 0.0
                  and r["compared"] == ADMITS,
                  "int8 with promotion: hot counters promoted past 127, "
                  "none lost, every admit bitwise the int32 twin's")
            path = ("srp_hash",)
        elif name.startswith("flat"):
            path = ("ace_admit_fused", "ace_query")
        elif name.startswith("fleet_window"):
            path = ("ace_fleet_window_admit", "ace_query")
        else:
            path = ("srp_hash", "ace_query", "ace_update")
        for k in path:
            check(r["launches"][k] > 0, f"guardrail {name} launched {k}")
        out[f"narrow_{name}"] = {**r, "dtype": dt}
        guards[name] = (gn, g32)

    # the queries on the narrow states: the fused score of the flat
    # sketch, the E-way window score, the fleet score; bitwise what the
    # same kernels' inputs give on another route, and bitwise the int32
    # twins' where the two never diverged
    e, _ = next(guardrail_batches(device, d_model, ADMITS, ADMIT_B, ADMIT_S))
    tids = (torch.arange(ADMIT_B, device=device) % FLEET_T).to(torch.int32)
    for dt in ("int16", "int8"):
        gs, gs32 = guards[f"flat_{dt}"]
        gw, gw32 = guards[f"window_{dt}"]
        gf, gf32 = guards[f"fleet_{dt}"]
        feat = mean_embed_features(e, gs.gcfg.bias_const)
        feat = torch.where(torch.isfinite(feat).all(-1)[:, None], feat, 0.0)
        ids = mods["srp_hash"].srp_hash(feat, gs.w, gs.ace_cfg.srp)
        wids = mods["srp_hash"].srp_hash(feat, gw.w, gw.ace_cfg.srp)
        fids = mods["srp_hash"].srp_hash(feat, gf.w, gf.ace_cfg.srp)
        reset_launches(mods)
        got = {"flat": ops.ace_score(gs.state, feat, gs.w, gs.ace_cfg),
               "window": ops.ace_window_score(gw.state, wids, WIN_GAMMA),
               "fleet": ops.ace_fleet_score(gf.state, feat, tids, gf.w,
                                            gf.ace_cfg)}
        launches = read_launches(mods)
        wts = ring.epoch_weights(gw.state.cursor, WIN_E, WIN_GAMMA)
        other = {"flat": mods["ace_query"].ace_query_sum(gs.state.counts,
                                                         ids),
                 "window": mods["ace_window_combine"]
                 .ace_window_combine_plain(gw.state.counts, wids, wts),
                 "fleet": mods["ace_fleet_score"].fleet_score_from_ids(
                     gf.state.counts, fids, tids)}
        twin = {"flat": lambda: ops.ace_score(gs32.state, feat, gs.w,
                                              gs.ace_cfg),
                "window": lambda: ops.ace_window_score(gw32.state, wids,
                                                       WIN_GAMMA),
                "fleet": lambda: ops.ace_fleet_score(gf32.state, feat, tids,
                                                     gf.w, gf.ace_cfg)}
        for k in got:
            check(torch.equal(got[k], other[k]), f"{dt} {k} query bitwise "
                  "the same counters' score on another route (srp_hash + "
                  "ace_query_sum, the plain combine, the routed sum)")
            if out[f"narrow_{k}_{dt}"]["wrapped_at"] is None:
                check(torch.equal(got[k], twin[k]()), f"{dt} {k} query "
                      "bitwise the int32 twin's")
        for k in ("ace_score_fused", "ace_window_combine", "ace_fleet_score"):
            check(launches[k] > 0, f"{dt} query path launched {k}")
        print(f"  narrow queries ({dt}): launches {launches}")
        out[f"narrow_queries_{dt}"] = {"launches": launches, "dtype": dt}
    guards.clear()

    # AceEstimator at the KDD shape in int16 with promotion, in turns
    # with the int32 fit (phase 3's data and W)
    rng = np.random.default_rng(SEED + 2)
    x = kdd_like(KDD_N + N_QUERIES - N_QUERIES // 100, KDD_D, rng)[:KDD_N]
    xd = torch.as_tensor(x, device=device)
    secs = {"int16": [], "int32": []}
    launches = {k: 0 for k in launch_counters(mods)}
    for dt in ("int16", "int32", "int16", "int32"):
        cfg = AceConfig(dim=KDD_D, num_bits=K_BITS, num_tables=L_TABLES,
                        counter_dtype=dt,
                        esc_capacity=NARROW_ESC if dt == "int16" else 0)
        e_ = AceEstimator(cfg, device=device, w=est["w"])
        sync(device)
        if dt == "int16":
            reset_launches(mods)
        t0 = time.perf_counter()
        e_.fit(xd, batch=FIT_BATCH)
        sync(device)
        secs[dt].append(time.perf_counter() - t0)
        if dt == "int16":
            for k, v in read_launches(mods).items():
                launches[k] += v
            narrow = e_
    st = narrow.state
    slots = int((st.esc.offs != qz.SENTINEL).sum())
    check(torch.equal(widened(st), est["counts"]) and float(st.n) == KDD_N
          and float(st.esc.lost) == 0.0,
          f"AceEstimator int16 + promotion: densified counts bitwise the "
          f"int32 fit's ({slots} promoted slots of {NARROW_ESC}, largest "
          f"counter {int(widened(st).max()):,}, lost 0)")
    qx = xd[:N_QUERIES]
    reset_launches(mods)
    s_n = narrow.score(qx)
    launches_q = read_launches(mods)
    for k, v in launches_q.items():
        launches[k] += v
    e32 = AceEstimator(AceConfig(dim=KDD_D, num_bits=K_BITS,
                                 num_tables=L_TABLES), device=device,
                       w=est["w"])
    e32.state = e32.state._replace(counts=est["counts"])
    check(torch.equal(s_n, e32.score(qx)), "its scores bitwise the int32 "
          "sketch's (the logical gather of the same ids)")
    check(launches["srp_hash"] > 0, "estimator int16 path launched srp_hash")
    f16, f32 = statistics.median(secs["int16"]), statistics.median(
        secs["int32"])
    print(f"  AceEstimator int16 + promotion: fit {KDD_N:,} x {KDD_D} in "
          f"{f16:.3f} s, int32 {f32:.3f} s (in turns, medians of 2); "
          f"memory_bytes {narrow.memory_bytes():,} (int32 "
          f"{e32.memory_bytes():,}); launches {launches}")
    out["narrow_estimator_int16_esc"] = {
        "launches": launches, "dtype": "int16", "seconds": f16,
        "int32_seconds": f32, "memory_bytes": narrow.memory_bytes(),
        "promoted": slots}
    del xd, narrow, e32

    # phase 5's dense stream in int16, in turns with int32
    chunks, T, B = STREAM_CHUNKS, STREAM_T, STREAM_B
    feats, _ = stream_features(device, d_model, chunks, T, B)
    runs = {}
    for dt in ("int32", "int16", "int16", "int32"):
        filt = stream_filter("dense", device, d_model, count_dtype=dt)
        runner = StreamRunner(filt, chunk_T=T)
        res = instrumented_run(mods, runner, device, feats, None, T)
        runs.setdefault(dt, []).append(res)
    (st16, _, sums16, _, launches, tr16) = runs["int16"][0]
    (st32, _, sums32, _, _, _) = runs["int32"][0]
    check(tr16 == {"h2d": chunks, "d2h": chunks}, f"int16 stream: one H2D "
          f"and one D2H a chunk ({tr16}), no host sync inside consume")
    check(st16.counts.dtype == torch.int16
          and torch.equal(st16.counts.to(torch.int32), st32.counts)
          and all(np.array_equal(a.kept_frac, b.kept_frac)
                  for a, b in zip(sums16, sums32)),
          f"int16 stream: counts widened and kept fractions bitwise the "
          f"int32 stream's (largest counter {int(st32.counts.max())})")
    for k in ("ace_admit_fused", "ace_query"):
        check(launches[k] > 0, f"int16 stream path launched {k}")
    ips = {dt: statistics.median(chunks * T * B / r[3] for r in rs)
           for dt, rs in runs.items()}
    print(f"  stream int16: {ips['int16']:,.0f} items/s, int32 "
          f"{ips['int32']:,.0f} items/s (in turns, medians of 2); launches "
          f"{launches}")
    out["narrow_stream_int16"] = {"launches": launches, "dtype": "int16",
                                  "items_per_s": ips["int16"],
                                  "int32_items_per_s": ips["int32"]}
    return out


def phase_timing_dtypes(mods, device, d_model=D_MODEL) -> dict:
    """Phase 8 for the seven count-reading kernels in int32, int16 and
    int8, in one call so the three compare: each at its main path's shape
    (``ace_update`` and ``ace_query_sum`` at the fit into one zeroed table,
    ``ace_admit_fused`` at the admit, ``ace_score_fused`` at the
    estimator's score, ``ace_window_combine``, ``ace_fleet_score`` and
    ``ace_fleet_window_admit`` on a (8, 4, 50, 2^15) ring at the admit),
    its plain version, and its bound counting the plane's own bytes (each
    counter the batch touches read once, written once when added to).
    Returns {kernel: {dtype: row}}."""
    from repro_torch.core.srp import SrpConfig, make_projections
    h, u, q, a, f, wc, fs, fwa = (mods[k] for k in (
        "srp_hash", "ace_update", "ace_query", "ace_admit_fused",
        "ace_score_fused", "ace_window_combine", "ace_fleet_score",
        "ace_fleet_window_admit"))
    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    L, K, nb = L_TABLES, K_BITS, 1 << K_BITS
    T, E, Ba, da = FLEET_T, WIN_E, ADMIT_B, d_model + 1
    ids = fit_ids(device)
    B = ids.shape[0]
    U = distinct_counters(ids, nb)
    cfg = SrpConfig(dim=KDD_D, num_bits=K, num_tables=L)
    w = make_projections(cfg, device=device)
    qs = torch.as_tensor(kdd_like(N_QUERIES, KDD_D,
                                  np.random.default_rng(SEED + 4)),
                         device=device)
    Uq = distinct_counters(h.srp_hash(qs, w, cfg), nb)
    acfg = SrpConfig(dim=da, num_bits=K, num_tables=L, seed=41)
    aw = make_projections(acfg, device=device)
    P = acfg.padded_projections
    feat = torch.randn((Ba, da), generator=gen, device=device)
    aids = h.srp_hash(feat, aw, acfg)
    Ua = distinct_counters(aids, nb)
    base = torch.randint(0, 9, (L, nb), generator=gen, device=device,
                         dtype=torch.int32)
    ring32 = torch.randint(0, 9, (T, E, L, nb), generator=gen, device=device,
                           dtype=torch.int32)
    tail = torch.randint(0, 40, (T, L, nb), generator=gen,
                         device=device).float()
    cursor = torch.randint(0, E, (T,), generator=gen, device=device,
                           dtype=torch.int32)
    tids = (torch.arange(Ba, device=device) % T).to(torch.int32)
    thr = torch.full((T,), float("-inf"), device=device)   # all admitted
    thresh = torch.tensor(float("-inf"), device=device)
    weights = WIN_GAMMA ** torch.arange(E, dtype=torch.float32, device=device)
    hash_flops = 2.0 * Ba * da * K * L
    out = {k: {} for k in NARROW_KERNELS}

    def row(kernel, dt, fn, plain, flops, nbytes, shape, library=None):
        r = dict(ms=device_ms(fn), plain_ms=device_ms(plain, reps=10),
                 library_ms=None if library is None else device_ms(library),
                 shape=shape, **dict(zip(("bound_ms", "bound_by"),
                                         bound(flops, nbytes))),
                 plane_bytes_ms=1e3 * nbytes / PEAK_BYTES_PER_S)
        out[kernel][dt] = r
        print(f"  {kernel} [{dt}] {shape}: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f}"
              + ("" if library is None else f", library "
                 f"{r['library_ms']:.5f}")
              + f", bound {r['bound_ms']:.5f} ms ({r['bound_by']}; the "
              f"bytes alone {r['plane_bytes_ms']:.6f})")

    for dt in ("int32", "int16", "int8"):
        tdt = getattr(torch, dt)
        isz = torch.empty((), dtype=tdt).element_size()
        zero = torch.zeros((L, nb), dtype=tdt, device=device)
        counts = base.to(tdt)
        rows = torch.arange(L, device=device)[None, :].expand(B, L)
        ones = torch.ones((B, L), dtype=tdt, device=device)
        row("ace_update", dt, lambda: u.ace_update(zero, ids),
            lambda: u.ace_update_plain(zero, ids), B * L,
            4 * B * L + 2 * isz * U,
            f"fit B={B}, L={L}, 2^K={nb}, distinct counters {U}",
            library=lambda: zero.index_put_((rows, ids.long()), ones,
                                            accumulate=True))
        row("ace_query", dt, lambda: q.ace_query_sum(counts, ids),
            lambda: q.ace_query_sum_plain(counts, ids), 0,
            4 * B * L + 4 * B + isz * U,
            f"fit B={B}, L={L}, distinct counters {U}")
        row("ace_admit_fused", dt,
            lambda: a.ace_admit_fused(counts, feat, aw, thresh, acfg),
            lambda: a.ace_admit_fused_plain(counts, feat, aw, thresh, acfg),
            hash_flops,
            4 * (Ba * da + da * P) + 2 * isz * Ua + 4 * Ba * L + 5 * Ba,
            f"admit B={Ba}, d={da}, K={K}, L={L}")
        row("ace_score_fused", dt,
            lambda: f.ace_score_fused(counts, qs, w, cfg),
            lambda: f.ace_score_fused_plain(counts, qs, w, cfg),
            2.0 * N_QUERIES * KDD_D * K * L,
            4 * (N_QUERIES * KDD_D + KDD_D * cfg.padded_projections)
            + isz * Uq + 4 * N_QUERIES,
            f"score B={N_QUERIES}, d={KDD_D}, distinct counters {Uq}")
        ring = ring32.to(tdt)
        row("ace_window_combine", dt,
            lambda: wc.ace_window_combine(ring[0], aids, weights),
            lambda: wc.ace_window_combine_plain(ring[0], aids, weights), 0,
            4 * Ba * L + 4 * Ba + 4 * E + E * isz * Ua,
            f"B={Ba}, E={E}, L={L}, distinct counters {Ua} an epoch")
        live0 = ring[:, 0].contiguous()
        row("ace_fleet_score", dt,
            lambda: fs.ace_fleet_score(live0, feat, tids, aw, acfg),
            lambda: fs.ace_fleet_score_plain(live0, feat, tids, aw, acfg),
            hash_flops, 4 * (Ba * da + da * P) + 8 * Ba + isz * Ua,
            f"admit B={Ba}, T={T}")
        row("ace_fleet_window_admit", dt,
            lambda: fwa.ace_fleet_window_admit_fused(
                ring, tail, cursor, feat, tids, aw, thr, acfg),
            lambda: fwa.ace_fleet_window_admit_fused_plain(
                ring, tail, cursor, feat, tids, aw, thr, acfg),
            hash_flops, 4 * (Ba * da + da * P) + (4 + 2 * isz) * Ua
            + 4 * Ba * L + 17 * Ba,
            f"admit B={Ba}, T={T}, E={E}, ring {ring.numel() * isz:,} B")
        del ring, live0
    return out


# ---------------------------------------------------------------------------
# Phase 9's bin ids on the card against a CPU recomputation.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_bins():
    """Inside the block, every ``quantile.sketch.bin_index`` call on the
    card keeps a copy of its rates and bin ids (no sync: device copies)."""
    from repro_torch.quantile import sketch as qsk
    real = qsk.bin_index
    seen = []

    def record(rates):
        ids = real(rates)
        if rates.is_cuda:
            seen.append((rates.detach().to(torch.float32).reshape(-1).clone(),
                         ids.reshape(-1).clone()))
        return ids
    qsk.bin_index = record
    try:
        yield seen
    finally:
        qsk.bin_index = real


def bin_edge_counts(seen) -> dict:
    """Of the recorded rates: how many lie within 4 ulp of a bin edge (the
    parity tests' ±1-bin band), and how many bin ids computed on the card
    differ from ``bin_index`` of the same rates on the CPU."""
    from repro_torch.quantile import sketch as qsk
    rates = torch.cat([r for r, _ in seen]).cpu()
    ids = torch.cat([i for _, i in seen]).cpu()
    cpu_ids = qsk.bin_index(rates)
    r = rates.numpy()
    edges = qsk._EDGES_NP
    at = np.clip(np.searchsorted(edges, r), 1, len(edges) - 1)
    gap = np.minimum(np.abs(r - edges[at - 1]), np.abs(edges[at] - r))
    near = int((gap <= 4 * np.spacing(np.abs(r))).sum())
    differ = ids != cpu_ids
    return {"rates": int(r.size), "near_edge": near,
            "differ": int(differ.sum()),
            "differ_by_more_than_1": int(
                ((ids - cpu_ids).abs() > 1).sum()),
            "differ_rates": r[differ.numpy()][:8].tolist()}


# ---------------------------------------------------------------------------
# Phase 11: resilience — health audit, degraded admission, repair, re-warm
# and CRC-checked checkpoints in the four Guardrail flavours.
# ---------------------------------------------------------------------------

RES_KINDS = {"flat": {}, **GUARD_KINDS}
RES_WARM = 12            # clean admits: every flavour's sketch armed
RES_NAN = 4              # NaN rows of the quarantine batch
RES_DEGRADED = 4         # degraded admits in lockstep with the plain path
RES_TURNS = 16           # admits each in turns, degraded and healthy
RES_CKPT = ROOT / "build" / "resilience_ckpt"


class RequestStream:
    """Phase 6's traffic before its shift: rows around the same 8 topics
    (the same topic draw from SEED + 8), each tenant every T-th row, the
    first ``nan_rows`` rows of a batch NaN when asked."""

    def __init__(self, device, d_model, b, s, tenants=None):
        self.gen = torch.Generator(device=device).manual_seed(SEED + 8)
        self.topics = torch.nn.functional.normalize(torch.randn(
            (12, d_model), generator=self.gen, device=device), dim=-1)
        self.device, self.tenants = device, tenants
        self.shape = (b, s, d_model)
        self.i = 0

    def next(self, nan_rows=0):
        b, s, d = self.shape
        pick = torch.randint(0, 8, (b,), generator=self.gen,
                             device=self.device)
        e = self.topics[pick][:, None, :] + 0.02 * torch.randn(
            (b, s, d), generator=self.gen, device=self.device)
        e[:nan_rows, 0, 0] = float("nan")
        tids = None if self.tenants is None \
            else ((np.arange(b) + self.i) % self.tenants).astype(np.int32)
        self.i += 1
        return e, tids


def mirror(dst, src) -> None:
    """``dst`` takes a copy of ``src``'s sketch and health state."""
    dst.state = clone_state(src.state)
    dst._table_mask = None if src._table_mask is None \
        else src._table_mask.clone()
    dst._repair_offsets = None if src._repair_offsets is None \
        else src._repair_offsets.clone()
    dst._rewarm_admits = src._rewarm_admits
    dst._rewarming = None if src._rewarming is None \
        else src._rewarming.copy()
    dst.quarantined = src.quarantined


def flavour_thresholds(g) -> torch.Tensor:
    """The guardrail's score-space thresholds (−inf while unarmed)."""
    from repro_torch.core import sketch as sk
    from repro_torch.fleet import state as fl
    from repro_torch.fleet import window as fw
    from repro_torch.window import ring
    c = g.gcfg
    if g.multi_tenant and g.windowed:
        return fw.window_admit_thresholds(g.state, c.window_decay, c.alpha,
                                          c.warmup_items)
    if g.multi_tenant:
        return fl.admit_thresholds(g.state, c.alpha, c.warmup_items)
    if g.windowed:
        return ring.admit_threshold_windowed(g.state, c.window_decay,
                                             c.alpha, c.warmup_items)
    return sk.admit_threshold(g.state, c.alpha, c.warmup_items)


def masked_scores(g, state, ids, tids) -> torch.Tensor:
    """Pre-insert scores of (B, L) ids against ``state`` over ``g``'s
    serving mask, by the plain path of ``g``'s flavour."""
    from repro_torch.core import sketch as sk
    from repro_torch.fleet import state as fl
    from repro_torch.fleet import window as fw
    from repro_torch.window import ring
    mask = g._table_mask
    if g.multi_tenant and g.windowed:
        return fw.window_fleet_scores(state, tids, ids, table_mask=mask)
    if g.multi_tenant:
        return fl.fleet_scores(state, tids, ids, table_mask=mask)
    if g.windowed:
        return ring.score_live(*ring.window_table_sums(state, ids,
                                                       table_mask=mask),
                               g.ace_cfg.num_tables, table_mask=mask)
    return sk.lookup(state, ids, mask)


def request_ids(mods, g, e):
    """(features, kernel ids, plain ids) of a request batch."""
    from repro_torch.core.srp import hash_buckets
    from repro_torch.data.pipeline import mean_embed_features
    feat = mean_embed_features(e, g.gcfg.bias_const)
    feat = torch.where(torch.isfinite(feat).all(-1)[:, None], feat, 0.0)
    return (feat, mods["srp_hash"].srp_hash(feat, g.w, g.ace_cfg.srp),
            hash_buckets(feat, g.w, g.ace_cfg.srp))


def reports_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def states_equal(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def phase_resilience(mods, device, kind, healthy_ops, d_model=D_MODEL,
                     b=ADMIT_B, s=ADMIT_S) -> dict:
    """One ``Guardrail`` flavour through the whole self-healing cycle at
    phase 6's width and traffic, a kernel guardrail and a plain one in
    lockstep (the plain one takes the kernel one's state before every
    step): warm up, quarantine NaN rows, flip 2 bits in each of ⌈L/4⌉
    tables, audit, masked scores against the unflipped twin, degraded
    admits (one D2H each; the hash, the masked sum and the insert, no
    fused admission), repair, re-warm within the reference's bound, the
    healthy route again; a degraded admit's device ops and p50 in turns
    with the healthy one's; and two checkpoints with CRCs, the newest
    torn, the intact one restored bitwise."""
    import shutil
    import repro_torch.serve.engine as engine
    from repro_torch import resilience as rz
    from repro_torch.train import checkpoint as ck
    gcfg = engine.GuardrailConfig(d_model=d_model, num_bits=K_BITS,
                                  num_tables=L_TABLES, **RES_KINDS[kind])
    T = gcfg.num_tenants if gcfg.num_tenants > 1 else None
    L = L_TABLES
    stream = RequestStream(device, d_model, b, s, T)
    gk = engine.Guardrail(gcfg, use_kernels=True, device=device)
    gp = engine.Guardrail(gcfg, use_kernels=False, device=device, w=gk.w)
    for _ in range(RES_WARM):
        gk.admit(*stream.next())
    check(bool(torch.isfinite(flavour_thresholds(gk)).all()),
          f"resilience ({kind}): armed after {RES_WARM} clean admits")

    mirror(gp, gk)
    q0 = gk.quarantined
    e, t = stream.next(nan_rows=RES_NAN)
    gk.admit(e, t)
    gp.admit(e, t)
    check(gk.quarantined - q0 == RES_NAN and gp.quarantined - q0 == RES_NAN,
          f"quarantined grew by {RES_NAN} in both guardrails")
    saved = clone_state(gk.state)              # checkpoint step 1

    # inject: 2 flipped bits in each of ceil(L/4) tables
    twin = clone_state(gk.state)
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    tables = sorted(torch.randperm(L, generator=gen, device=device)
                    [:-(-L // 4)].tolist())
    counts = gk.state.counts
    for j in tables:
        counts = rz.flip_count_bits(counts, gen, num_flips=2, tables=(j,))
    gk.state = gk.state._replace(counts=counts)
    where = torch.nonzero(counts != twin.counts).cpu().numpy()
    flipped = {(int(r[0]), int(r[-2])) if T else int(r[-2]) for r in where}
    mirror(gp, gk)

    # audit, both ways
    t0 = time.perf_counter()
    rep = gk.health_check()                     # ends in its one transfer
    check_ms = 1e3 * (time.perf_counter() - t0)
    rep_p = gp.health_check()
    check(reports_equal(rep, rep_p), "health reports equal (kernel and "
          "plain guardrail)")
    bad = {(int(x[0]), int(x[1])) if T else int(x[0])
           for x in np.argwhere(~rep.table_ok)}
    print(f"  resilience ({kind}): flipped 2 bits in each of tables "
          f"{tables} ({len(flipped)} "
          f"{'(tenant, table)' if T else 'table'} planes changed); "
          f"health_check flags {len(bad)}: {sorted(bad)}")
    check(bad and bad <= flipped, "every flagged table is a flipped one, "
          "at least one flagged")
    if not gk.windowed:
        check(bad == flipped, "conservation is two-sided: every flipped "
              "table flagged")
    check(gk.degraded and gp.degraded, "both guardrails degraded")

    # masked scores against the unflipped twin
    e, t = stream.next()
    _, _, ids = request_ids(mods, gk, e)
    tdev = None if t is None else torch.as_tensor(t, device=device)
    got = masked_scores(gk, gk.state, ids, tdev)
    want = masked_scores(gk, twin, ids, tdev)
    keep = torch.ones(b, dtype=torch.bool, device=device)
    if gk.windowed:
        # a flip that lowers a count passes the one-sided Σ <= n: rows
        # reading such a counter of the live epoch differ, by design
        cur = twin.cursor.cpu().numpy()
        for r in where:
            tab = int(r[-2])
            if (int(r[0]), tab) in bad if T else tab in bad:
                continue
            if (cur[int(r[0])] if T else int(cur)) != int(r[-3]):
                continue
            hit = ids[:, tab] == int(r[-1])
            if T:
                hit &= tdev == int(r[0])
            keep &= ~hit
    kept = int(keep.sum())
    check(kept > 0 and torch.equal(got[keep], want[keep]),
          f"masked scores equal the unflipped twin's bitwise ({kept} of {b} "
          "rows; the rest read an unflagged flipped counter)")

    # degraded admits, kernel and plain from the same state
    d2h = []
    real_to_host = engine._to_host

    def to_host(x):
        d2h.append(tuple(x.shape))
        return real_to_host(x)
    launches = {k: 0 for k in read_launches(mods)}
    differ = agree_rows = 0
    engine._to_host = to_host
    try:
        for _ in range(RES_DEGRADED):
            e, t = stream.next(nan_rows=1)
            mirror(gp, gk)
            _, ik, ip = request_ids(mods, gk, e)
            agree = torch.all(ik == ip, dim=1).cpu().numpy()
            n0 = len(d2h)
            reset_launches(mods)
            mk = gk.admit(e, t)
            got = read_launches(mods)
            check(len(d2h) == n0 + 1, "one D2H a degraded admit")
            launches = {k: launches[k] + v for k, v in got.items()}
            mp = gp.admit(e, t)
            agree_rows += int(agree.sum())
            differ += int((mk != mp)[agree].sum())
    finally:
        engine._to_host = real_to_host
    check(differ == 0, f"degraded verdicts equal the plain path's on every "
          f"row whose ids agree ({agree_rows} of {RES_DEGRADED * b})")
    print(f"  degraded launches over {RES_DEGRADED} admits: {launches}")
    for k in ("srp_hash", "ace_query", "ace_update"):
        check(launches[k] > 0, f"degraded route launched {k}")
    for k in ("ace_admit_fused", "ace_fleet_window_admit"):
        check(launches[k] == 0, f"degraded route launched no {k}")

    # a degraded admit against a healthy one, in turns, on copies
    gd = engine.Guardrail(gcfg, device=device, w=gk.w)
    gh = engine.Guardrail(gcfg, device=device, w=gk.w)
    mirror(gd, gk)
    gh.state = clone_state(twin)
    e, t = stream.next()
    tdev = None if t is None else torch.as_tensor(t, device=device)
    sync(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        gd._admit_device(e, tdev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  ok: no host sync inside a degraded admit (sync debug mode "
          "'error')")
    lat = {"degraded": [], "healthy": []}
    arms = {"degraded": gd, "healthy": gh}
    for i in range(RES_TURNS):
        e, t = stream.next()
        for name in (("degraded", "healthy") if i % 2 else
                     ("healthy", "degraded")):
            t0 = time.perf_counter()
            arms[name].admit(e, t)
            lat[name].append(time.perf_counter() - t0)
    check(gd.degraded and not gh.degraded, "the timed copies kept their "
          "routes")
    p50 = {k: 1e3 * statistics.median(v) for k, v in lat.items()}
    e, t = stream.next()
    gd.admit(e, t)
    sync(device)

    def fuller(a, b):
        return a if a["device_ops"] >= b["device_ops"] else b
    tr = fuller(device_trace(lambda: gd.admit(e, t), device),
                device_trace(lambda: gd.admit(e, t), device))
    print(f"  in turns, admit by admit: degraded p50 {p50['degraded']:.3f} "
          f"ms, healthy {p50['healthy']:.3f} ms (host clock); one degraded "
          f"admit {tr['device_ops']} device ops, busy "
          f"{tr['device_busy_ms']:.3f} ms (healthy, phase "
          f"{4 if kind == 'flat' else 6}: {healthy_ops})")

    # repair, both ways
    mirror(gp, gk)
    t0 = time.perf_counter()
    pre = gk.repair()                  # ends in health_check's transfer
    repair_ms = 1e3 * (time.perf_counter() - t0)
    pre_p = gp.repair()
    check(reports_equal(pre, pre_p) and states_equal(gk.state, gp.state),
          "repair: reports and repaired states equal (kernel and plain)")
    post = rz.health_check(gk.state, gk._repair_offsets)
    check(bool(post.table_ok.all()), "every invariant holds right after "
          "the repair")
    check(gk.degraded == (not pre.table_ok.all()), "repaired tables "
          "re-warm before they serve")

    # re-warm: serve and audit until healthy
    if gk.windowed:
        bound = WIN_E * WIN_R
    else:
        rows = b if T is None else b // T
        bound = -(-int(gcfg.warmup_items) // rows) + 2
    admits = differ = 0
    while gk.degraded and admits < bound:
        e, t = stream.next()
        mirror(gp, gk)
        _, ik, ip = request_ids(mods, gk, e)
        agree = torch.all(ik == ip, dim=1).cpu().numpy()
        mk, mp = gk.admit(e, t), gp.admit(e, t)
        differ += int((mk != mp)[agree].sum())
        admits += 1
        gk.health_check()
        gp.health_check()
        check(gk.degraded == gp.degraded, "degraded flags equal after "
              f"re-warm admit {admits}")
    check(not gk.degraded and differ == 0, f"recovered after {admits} "
          f"admits (bound {bound}), verdicts equal where ids agree")
    reset_launches(mods)
    gk.admit(*stream.next())
    healthy = read_launches(mods)
    route = {"flat": ("ace_admit_fused",),
             "fleet_window": ("ace_fleet_window_admit",)}.get(
                 kind, ("srp_hash", "ace_query", "ace_update"))
    for k in route:
        check(healthy[k] > 0, f"the healthy route resumed: {k} launched")

    # checkpoints with CRCs: the newest torn, the intact one restored
    d = RES_CKPT / kind
    shutil.rmtree(d, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        ck.save(str(d), 1, saved, keep=5)
        save_ms = 1e3 * (time.perf_counter() - t0)
        nbytes = (d / "step_0000000001" / "arrays.npz").stat().st_size
        ck.save(str(d), 2, gk.state, keep=5)
        rz.tear_checkpoint(str(d), 2, mode="truncate")
        t0 = time.perf_counter()
        restored, manifest = ck.CheckpointManager(str(d)).restore_latest(
            gk.state)
        sync(device)
        restore_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(manifest is not None and manifest["step"] == 1
          and states_equal(restored, saved), "the torn step 2 skipped, "
          "step 1 restored bitwise")
    print(f"  health_check {check_ms:.3f} ms, repair {repair_ms:.3f} ms "
          f"(host clock, each ending in its transfer); recovered after "
          f"{admits} admits (bound {bound}); checkpoint save {save_ms:.1f} "
          f"ms, restore {restore_ms:.1f} ms (the torn step tried first), "
          f"{nbytes:,} B")
    return {"launches": launches, "healthy_launches": healthy,
            "p50_ms": p50["degraded"], "healthy_p50_ms": p50["healthy"],
            "device_ops": tr["device_ops"], "healthy_device_ops": healthy_ops,
            "health_check_ms": check_ms, "repair_ms": repair_ms,
            "recovery_admits": admits, "recovery_bound": bound,
            "save_ms": save_ms, "restore_ms": restore_ms,
            "checkpoint_bytes": nbytes}


# ---------------------------------------------------------------------------
# Phase 12: the open-loop front end at full width, loaded as
# benchmarks/openloop_bench.py loads the reference's (its _build, _capacity,
# _frontend_capacity and _open_loop, written here for the port).
# ---------------------------------------------------------------------------

FE_LOADS = {"fleet": (0.5, 1.0, 2.0), "flat": (2.0,), "window": (2.0,),
            "fleet_window": (2.0,)}     # each flavour's loads, fleet first
FE_WARMUP = 64.0                 # openloop_bench._build's warmup_items
FE_CAP_BATCHES, FE_CAP_REPS = 12, 3
FE_CAP_REQ = 6000                # the front end's closed-loop requests
FE_POOL = 64                     # request embeddings a run cycles over
FE_MAX_REQ = 200_000
# the kernel each admit of a flavour launches exactly once (§3's mix)
FE_ONCE = {"flat": ("ace_admit_fused",), "window": ("srp_hash", "ace_update"),
           "fleet": ("srp_hash", "ace_update"),
           "fleet_window": ("ace_fleet_window_admit",)}


def frontend_guardrail(device, kind, d_model):
    """``openloop_bench._build`` at phase 6's shapes: policies alternating
    fail_open / fail_closed by tenant, ``max_queue`` 4B, the default
    deadline (50 ms) and ``max_wait`` (5 ms)."""
    from repro_torch.serve.engine import Guardrail, GuardrailConfig
    from repro_torch.serve.frontend import FrontEndConfig
    kw = RES_KINDS[kind]
    T = kw.get("num_tenants", 1)
    pol = tuple("fail_open" if t % 2 == 0 else "fail_closed"
                for t in range(T))
    g = Guardrail(GuardrailConfig(d_model=d_model, num_bits=K_BITS,
                                  num_tables=L_TABLES,
                                  warmup_items=FE_WARMUP, fail_policy=pol,
                                  **kw), device=device)
    fcfg = FrontEndConfig(batch_size=ADMIT_B, seq=ADMIT_S, d_model=d_model,
                          max_queue=4 * ADMIT_B)
    return g, fcfg, T


def request_pool(rng, fcfg) -> list:
    return [rng.normal(size=(fcfg.seq, fcfg.d_model)).astype(np.float32)
            for _ in range(FE_POOL)]


def admit_capacity(g, fcfg, T, device) -> tuple:
    """Closed-loop items/s of the warmed ``admit`` on batches already on
    the card (as the reference's ``_capacity`` hands it device arrays)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    B = fcfg.batch_size
    embeds = [torch.randn((B, fcfg.seq, fcfg.d_model), generator=gen,
                          device=device) for _ in range(FE_CAP_BATCHES)]
    tenants = None if T == 1 else np.random.default_rng(0).integers(
        0, T, size=B).astype(np.int32)
    g.admit(embeds[0], tenants)
    reps = []
    for _ in range(FE_CAP_REPS):
        t0 = time.perf_counter()
        for e in embeds:
            g.admit(e, tenants)             # ends in the verdict transfer
        reps.append(FE_CAP_BATCHES * B / (time.perf_counter() - t0))
    return max(reps), reps


def shed_by_policy(tickets, g, T) -> bool:
    """Every shed ticket's verdict is its tenant's ``fail_open_mask``."""
    mask = g.fail_open_mask
    return all(t.admitted is bool(mask[t.tenant if T > 1 else 0])
               for t in tickets if t.status == "shed")


@contextlib.contextmanager
def frozen_heap():
    """Run a front-end loop with the heap that the earlier phases left
    frozen (``gc.freeze``) and the cyclic collector off: one full
    collection over the earlier heap took 120-190 ms on an H100 host, long
    enough to shed a deadline's worth (50 ms) of requests wherever it
    lands in a 2 s loop, and where it lands moves with any allocation
    anywhere in the script.  Inside the loop the collector would walk the
    tickets that the harness keeps for its percentiles (one a request,
    tens of thousands at 2x), a pause that lands on one batch of 256
    requests and so on the p999.  The loop's garbage is acyclic and freed
    by reference counting; the collection on the way out takes the
    rest."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
        gc.collect()


@contextlib.contextmanager
def gc_pauses():
    """The cyclic collector's pauses inside the block: (generation, s)."""
    out, t = [], [0.0]

    def cb(phase, info):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            out.append((info["generation"], time.perf_counter() - t[0]))
    gc.callbacks.append(cb)
    try:
        yield out
    finally:
        gc.callbacks.remove(cb)


def frontend_capacity(g, fcfg, T) -> float:
    """Closed-loop requests/s through ``submit`` + ``pump``, deadlines far
    past the run so nothing sheds."""
    from repro_torch.serve.frontend import FrontEnd
    pool = request_pool(np.random.default_rng(7), fcfg)
    fe = FrontEnd(g, fcfg)
    q0 = g.quarantined
    with frozen_heap():
        t0 = time.perf_counter()
        for k in range(FE_CAP_REQ):
            fe.submit(pool[k % len(pool)], tenant=k % T,
                      deadline=time.perf_counter() + 60.0)
            if fe.ready():
                fe.pump()
        fe.drain()
        wall = time.perf_counter() - t0
    check(fe.served == FE_CAP_REQ and g.quarantined - q0 == fe.pad_rows,
          f"closed loop: all {FE_CAP_REQ} requests served, the "
          f"{fe.pad_rows} pad rows the only quarantined rows")
    return FE_CAP_REQ / wall


def open_loop(mods, g, fcfg, T, kind, rate: float, seed: int) -> dict:
    """``openloop_bench._open_loop``: Poisson arrivals at ``rate`` req/s,
    every request accountable from its SCHEDULED arrival (deadline and
    latency), a bounded tail drain; launches counted over the run."""
    from repro_torch.serve.frontend import FrontEnd
    n_req = int(min(max(400, rate * 2.0), FE_MAX_REQ))
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_req))
    pool = request_pool(rng, fcfg)
    fe = FrontEnd(g, fcfg)
    q0 = g.quarantined
    tickets = []
    clk = time.perf_counter
    pumps = []              # (assembly s, whole pump s) of each batch

    def pump(force=False):
        a, p0 = fe.assembly_s, clk()
        n = fe.pump(force=force)
        if n:
            pumps.append((fe.assembly_s - a, clk() - p0))
        return n
    reset_launches(mods)
    with frozen_heap(), gc_pauses() as pauses:
        t0 = clk()
        for k in range(n_req):
            while clk() - t0 < arrivals[k]:
                if fe.ready():
                    pump()
                else:
                    ahead = arrivals[k] - (clk() - t0)
                    if ahead > 0.0005:
                        time.sleep(min(ahead, 0.002))
            tickets.append((fe.submit(
                pool[k % len(pool)], tenant=k % T,
                deadline=t0 + arrivals[k] + fcfg.default_deadline),
                arrivals[k]))
            if fe.ready():
                pump()
        t_end = clk()
        while fe.queue_len and clk() - t_end < 1.0:    # bounded tail drain
            pump(force=True)
        wall = clk() - t0
    launches = read_launches(mods)
    lat = np.array([tk.t_done - t0 - sched for tk, sched in tickets
                    if tk.status == "served"])
    m = fe.metrics()
    check(m["served"] + m["shed_queue_full"] + m["shed_deadline"]
          + fe.queue_len == n_req, f"served + shed + queued == {n_req}")
    check(shed_by_policy([tk for tk, _ in tickets], g, T),
          "(b) every shed verdict is its tenant's fail_open_mask")
    check(g.quarantined - q0 == fe.pad_rows, f"(c) the {fe.pad_rows} pad "
          "rows are the only quarantined rows")
    batches = (fe.served + fe.pad_rows) // fcfg.batch_size
    mix = {k: launches[k] for k in FE_ONCE[kind] + ("ace_query",)}
    check(all(launches[k] == batches for k in FE_ONCE[kind])
          and launches["ace_query"] >= batches,
          f"(e) {batches} admits, each through the {kind} kernels: {mix}")
    pct = (lambda q: float(np.percentile(lat, q) * 1e3)) if len(lat) \
        else (lambda q: float("nan"))
    return {"offered_per_s": rate, "n_requests": n_req,
            "served_items_per_s": m["served"] / wall,
            "shed_rate": m["shed_rate"],
            "shed_queue_full": m["shed_queue_full"],
            "shed_deadline": m["shed_deadline"],
            "p50_ms": pct(50), "p99_ms": pct(99), "p999_ms": pct(99.9),
            "est_service_ms": m["est_service_s"] * 1e3,
            "served": m["served"], "assembly_ms": 1e3 * fe.assembly_s / max(batches, 1),
            "batches": batches, "launches": launches,
            "max_ms": float(lat.max() * 1e3) if len(lat) else float("nan"),
            "max_assembly_ms": 1e3 * max((a for a, _ in pumps), default=0),
            "max_pump_ms": 1e3 * max((p for _, p in pumps), default=0),
            "gc_pauses": len(pauses),
            "gc_max_ms": 1e3 * max((d for _, d in pauses), default=0),
            "gc_full": sum(gen == 2 for gen, _ in pauses)}


class TwinRecorder:
    """The guardrail behind a front end, also feeding every padded batch
    to a twin (same W, same state before the run) and keeping the twin's
    verdicts of the non-pad rows in service order."""

    def __init__(self, g, twin):
        self.g, self.twin, self.twin_rows = g, twin, []

    multi_tenant = property(lambda self: self.g.multi_tenant)
    fail_open_mask = property(lambda self: self.g.fail_open_mask)

    def admit(self, embeds, tenants=None):
        args = (embeds,) if tenants is None else (embeds, tenants)
        verdicts = self.g.admit(*args)
        real = ~np.isnan(embeds[:, 0, 0])
        self.twin_rows.extend(self.twin.admit(*args)[real].tolist())
        return verdicts


def lockstep_requests(stream, n) -> list:
    """n numpy requests (S, D) with tenant ids from ``stream`` (phase 6's
    traffic before its shift), every 7th row replaced by unseen noise, so
    an armed guardrail both admits and rejects."""
    rng = np.random.default_rng(SEED + 13)
    out = []
    while len(out) < n:
        e, tids = stream.next()
        e = e.cpu().numpy()
        for i in range(len(e)):
            row = e[i] if len(out) % 7 else rng.normal(
                size=e[i].shape).astype(np.float32)
            out.append((row, 0 if tids is None else int(tids[i])))
    return out[:n]


def frontend_lockstep(kind, fcfg, device, d_model) -> None:
    """On a fresh guardrail of the flavour and its twin (same W, the same
    ``RES_WARM`` warm-up admits): (a) the served tickets' verdicts bitwise the twin's
    fed the same padded batches; (b) sheds by policy; (c) pads the only
    quarantined rows; (d) a full-queue burst and its deadline sheds under
    sync-debug "error" (a shed reads the host policy only)."""
    from repro_torch.serve.engine import Guardrail
    from repro_torch.serve.frontend import FrontEnd
    g, _, T = frontend_guardrail(device, kind, d_model)
    rec = TwinRecorder(g, Guardrail(g.gcfg, device=device, w=g.w))
    stream = RequestStream(device, d_model, fcfg.batch_size, fcfg.seq,
                           None if T == 1 else T)
    for _ in range(RES_WARM):               # both armed on the same batches
        e, tids = stream.next()
        rec.g.admit(e, tids)
        rec.twin.admit(e, tids)
    # a slack that covers two guardrails' service: this run is for the
    # verdicts (the loads above hold the 50 ms deadline)
    fe = FrontEnd(rec, dataclasses.replace(fcfg, default_deadline=1.0))
    reqs = lockstep_requests(stream, 4 * fcfg.batch_size + 37)
    tickets = []
    for k, (row, tenant) in enumerate(reqs):
        tickets.append(fe.submit(row, tenant=tenant,
                                 deadline=-1.0 if k % 11 == 5 else None))
        if fe.ready():
            fe.pump()
    fe.drain()
    served = [t.admitted for t in tickets if t.status == "served"]
    check(len(served) > 0 and served == rec.twin_rows, f"(a) lockstep: "
          f"{len(served)} served verdicts bitwise the twin guardrail's "
          f"({sum(served)} admitted, {len(served) - sum(served)} rejected)")
    check(shed_by_policy(tickets, g, T), f"(b) {len(reqs) - len(served)} "
          "sheds answered by their tenant's policy")
    check(g.quarantined == fe.pad_rows,
          f"(c) quarantined == pad rows ({fe.pad_rows})")
    pool = [row for row, _ in reqs[:FE_POOL]]
    sync(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        burst = [fe.submit(pool[i % len(pool)], tenant=i % T, deadline=-1.0)
                 for i in range(fcfg.max_queue + 256)]
        pumped = fe.pump()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(pumped == 0 and fe.queue_len == 0
          and all(t.status == "shed" for t in burst)
          and shed_by_policy(burst, g, T), f"(d) a burst of {len(burst)} "
          f"submits ({fcfg.max_queue} queued, 256 tail-dropped) and its "
          "deadline sheds ran under sync-debug 'error'")


def phase_frontend(mods, device, kind, d_model=D_MODEL) -> dict:
    g, fcfg, T = frontend_guardrail(device, kind, d_model)
    cap, reps = admit_capacity(g, fcfg, T, device)
    fe_cap = frontend_capacity(g, fcfg, T)
    print(f"  front end ({kind}, T={T}, B={fcfg.batch_size} x {fcfg.seq} x "
          f"{d_model}, K={K_BITS}, L={L_TABLES}, max_queue "
          f"{fcfg.max_queue}): admit capacity {cap:,.0f} items/s (reps "
          f"{', '.join(f'{r:,.0f}' for r in reps)}; batches on the card); "
          f"front-end capacity {fe_cap:,.0f} req/s (submit + pump, numpy "
          "in)")
    out = {"admit_items_per_s": cap, "frontend_req_per_s": fe_cap,
           "loads": {}}
    for ratio in FE_LOADS[kind]:
        pt = open_loop(mods, g, fcfg, T, kind, ratio * fe_cap,
                       seed=int(ratio * 10))
        out["loads"][ratio] = pt
        print(f"  {kind} x{ratio}: offered {pt['offered_per_s']:,.0f}/s, "
              f"{pt['n_requests']} requests; served "
              f"{pt['served_items_per_s']:,.0f} items/s; shed "
              f"{pt['shed_rate']:.4f} (queue_full {pt['shed_queue_full']}, "
              f"deadline {pt['shed_deadline']}); latency from the scheduled "
              f"arrival p50 {pt['p50_ms']:.2f} ms, p99 {pt['p99_ms']:.2f}, "
              f"p999 {pt['p999_ms']:.2f}; est_service "
              f"{pt['est_service_ms']:.3f} ms; batch assembly "
              f"{pt['assembly_ms']:.3f} ms a batch (host, {pt['batches']} "
              f"batches); worst batch: latency {pt['max_ms']:.2f} ms, "
              f"assembly {pt['max_assembly_ms']:.3f} ms, pump "
              f"{pt['max_pump_ms']:.3f} ms; {pt['gc_pauses']} collector "
              f"pauses ({pt['gc_full']} full), the longest "
              f"{pt['gc_max_ms']:.3f} ms")
    if 0.5 in out["loads"]:     # under capacity: little shed, all served
        low = out["loads"][0.5]
        check(low["shed_rate"] <= 0.05
              and low["served_items_per_s"] >= 0.9 * low["offered_per_s"],
              f"{kind} x0.5 sheds {low['shed_rate']:.4f} <= 0.05 and serves "
              f"{low['served_items_per_s']:,.0f}/s >= 0.9 x the offered "
              f"{low['offered_per_s']:,.0f}/s")
    over = out["loads"][2.0]
    svc = max(over["est_service_ms"], 0.1)
    bound = fcfg.default_deadline * 1e3 + 3.0 * svc \
        + fcfg.max_wait * 1e3 + 20.0
    check(over["shed_rate"] > 0.05, f"{kind} x2.0 sheds "
          f"{over['shed_rate']:.4f} > 0.05")
    check(over["served"] >= 500
          and over["served_items_per_s"] >= 0.5 * fe_cap,
          f"{kind} x2.0 serves {over['served']} requests (>= 500), "
          f"{over['served_items_per_s']:,.0f}/s >= 0.5 x the front end's "
          f"capacity {fe_cap:,.0f}/s")
    check(over["p999_ms"] <= bound, f"{kind} x2.0 p999 "
          f"{over['p999_ms']:.2f} ms <= deadline + 3 x service + max_wait "
          f"+ 20 = {bound:.2f} ms")
    frontend_lockstep(kind, fcfg, device, d_model)
    return out


# ---------------------------------------------------------------------------
# Phase 13: the §4 private hash on the KDD-Cup99 HTTP analogue.
# ---------------------------------------------------------------------------

PRIV_EPS, PRIV_DELTA = 1.0, 1e-5


def report_counts(scores: np.ndarray, y: np.ndarray) -> tuple:
    """``benchmarks/table3_5_comparison._report``: flag score < μ − σ;
    (reported, correct, missed)."""
    mu, sd = scores.mean(), scores.std()
    flagged = scores < (mu - sd)
    correct = int((flagged & (y == 1)).sum())
    return int(flagged.sum()), correct, int(y.sum()) - correct


def sketch_counts(mods, cfg, ids, y, device) -> tuple:
    """Insert the (n, L) ids (``ace_update``), score them
    (``ace_query_sum``) and report μ−σ's counts."""
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import ops as kops
    state = kops.ace_update(sk.init(cfg, device), ids, cfg)
    return report_counts(kops.ace_query(state, ids).cpu().numpy(), y)


def phase_private_hash(mods, device, ds) -> dict:
    """Private ids at σ = 0 against the ``srp_hash`` kernel; at the
    Gaussian mechanism's σ for (ε, δ) = (1, 1e-5) the measured bit-flip
    rate against the expected one; the private ids through ``ace_update``
    and ``ace_query_sum``; μ−σ's detection counts at both σ."""
    from repro_torch.core import privacy
    from repro_torch.core import sketch as sk
    from repro_torch.core.srp import srp_bits
    from repro_torch.data.synthetic import bias_augment
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls off: "
          "the private projection's sign bits are full float32")
    cfg = sk.AceConfig(dim=ds.dim + 1, num_bits=K_BITS,
                       num_tables=L_TABLES, seed=SEED)
    x = torch.as_tensor(bias_augment(ds.x), device=device)
    # unit-norm rows: the sensitivity bound's premise (SRP bits are
    # invariant to a row's scale, so the plain ids do not change)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    w = sk.make_params(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    ids0 = privacy.private_hash_buckets(x, w, cfg.srp, gen, 0.0)
    agree = agreement(ids0, mods["srp_hash"].srp_hash(x, w, cfg.srp))
    check(agree >= 0.999, f"sigma = 0: private ids agree with the srp_hash "
          f"kernel's on {agree:.6f} of {ids0.numel():,} (>= 0.999)")
    kl = cfg.srp.num_projections
    l2 = 2.0 * float(torch.linalg.vector_norm(w[:, :kl], dim=0).max())
    sigma = privacy.gaussian_sigma(PRIV_EPS, PRIV_DELTA, l2)
    margin = privacy.projections(x, w)[:, :kl]
    flips = privacy.private_srp_bits(x, w, cfg.srp, gen, sigma) \
        != srp_bits(x, w, cfg.srp)
    rate = float(flips.double().mean())
    del flips
    p = privacy.expected_bit_flip_rate(margin, sigma).double()
    want = float(p.mean())
    se = float(torch.sqrt(torch.sum(p * (1.0 - p)))) / p.numel()
    del p, margin
    check(abs(rate - want) <= 3.0 * se, f"sigma = {sigma:.4f} (eps "
          f"{PRIV_EPS}, delta {PRIV_DELTA:g}, L2 sensitivity {l2:.4f}): "
          f"measured bit-flip rate {rate:.6f} within 3 standard errors "
          f"({se:.2e}) of the expected {want:.6f}")
    reset_launches(mods)
    sync(device)
    t0 = time.perf_counter()
    ids = privacy.private_hash_buckets(x, w, cfg.srp, gen, sigma)
    private = sketch_counts(mods, cfg, ids, ds.y, device)
    seconds = time.perf_counter() - t0
    launches = read_launches(mods)
    for k in ("ace_update", "ace_query"):
        check(launches[k] > 0, f"the private ids went through {k} "
              f"({launches[k]})")
    plain = sketch_counts(mods, cfg, ids0, ds.y, device)
    print(f"  private hash of {ds.n:,} x {cfg.dim} (unit rows), K={K_BITS}, "
          f"L={L_TABLES}: hash + insert + score {seconds:.3f} s (host clock, "
          f"ends in the scores' transfer); mu-sigma reported/correct/missed "
          f"sigma = 0: {plain}, sigma = {sigma:.4f}: {private} "
          f"({ds.n_anomalies} anomalies)")
    return {"launches": launches, "sigma": sigma, "flip_rate": rate,
            "expected_flip_rate": want, "seconds": seconds,
            "counts_sigma0": plain, "counts_private": private,
            "agreement_sigma0": agree}


# ---------------------------------------------------------------------------
# Phase 14: the paper's comparison (Tables 3-5): ACE against its 11
# baselines.
# ---------------------------------------------------------------------------

PAPER_K = {"shuttle": 5, "aloi": 5, "kddcup99_http": 10}   # paper Table 2
PAPER_SUB_N = 12_000     # benchmarks/table3_5_comparison.py's baseline_n
FASTVOA_T = 320


def run_baselines(ds, k, device, names) -> tuple:
    """``run_baseline`` over ``names``, sharing the graph and inner
    distances as the comparison bench does: {name: (scores, seconds,
    counts)}, the graph and the inner distances."""
    from repro_torch.baselines import run_baseline
    out, graph, inner = {}, None, None
    for name in names:
        s, sec, graph, inner = run_baseline(name, ds.x, k, graph, inner,
                                            fastvoa_t=FASTVOA_T,
                                            device=device)
        check(s.shape == (ds.n,) and np.isfinite(s).all(),
              f"{name} at n={ds.n:,}: {ds.n:,} finite scores")
        out[name] = (s, sec, report_counts(s, ds.y))
    check(float(out["odin"][0].astype(np.float64).sum()) == ds.n * k,
          f"ODIN indegrees sum to n*k = {ds.n * k:,}")
    return out, graph, inner


def print_table(name, ds, k, rows) -> None:
    print(f"  [{name}] n={ds.n:,} d={ds.dim} anomalies={ds.n_anomalies} "
          f"k={k}: method reported/correct/missed seconds")
    for method, (_, sec, counts) in rows.items():
        print(f"    {method}: {counts[0]}/{counts[1]}/{counts[2]} "
              f"{sec:.3f} s")


def phase_paper(mods, device, datasets) -> tuple:
    """ACE (K=15, L=50, kernels) at full n on each dataset; the 11
    baselines at the bench's subsample n = 12,000; the card's graph-based
    scores against the plain CPU version on the same graph; then the kNN
    graph, the graph scorers, LDOF, COF and FastVOA at kddcup99_http's
    full n.  Returns the ACE paths (with their launches) and the
    baselines' seconds and counts."""
    from repro_torch.baselines import (ALL_BASELINES, GRAPH_BASED,
                                       neighbors as nb)
    from repro_torch.baselines.cof import cof_score
    from repro_torch.baselines.knn_graph import pairwise_within_neighborhood
    from repro_torch.core import sketch as sk
    from repro_torch.core.estimators import AceEstimator
    from repro_torch.data.synthetic import make_paper_dataset
    paths, tables = {}, {}
    for name, ds in datasets.items():
        k = PAPER_K[name]
        reset_launches(mods)
        t0 = time.perf_counter()
        est = AceEstimator(sk.AceConfig(dim=ds.dim, num_bits=K_BITS,
                                        num_tables=L_TABLES, seed=SEED),
                           device=device)
        est.update(ds.x)
        scores = est.score(ds.x).cpu().numpy()
        ace_s = time.perf_counter() - t0
        launches = read_launches(mods)
        check(np.isfinite(scores).all(), f"ACE on {name}: finite scores")
        for kk in ("srp_hash", "ace_update", "ace_query", "ace_score_fused"):
            check(launches[kk] > 0, f"ACE on {name} launched {kk}")
        paths[f"paper_ace_{name}"] = {"launches": launches,
                                      "seconds": ace_s,
                                      "counts": report_counts(scores, ds.y)}
        sub = make_paper_dataset(name, n=PAPER_SUB_N, seed=SEED)
        rows, graph, inner = run_baselines(sub, k, device, ALL_BASELINES)
        print_table(name, ds, k, {"ace (full n)": (
            scores, ace_s, paths[f"paper_ace_{name}"]["counts"])})
        print_table(name, sub, k, rows)
        cpu = (graph[0].cpu(), graph[1].cpu())
        inner_cpu = pairwise_within_neighborhood(sub.x, cpu[1])
        plain = {m: f(cpu, sub.x).numpy() for m, f in GRAPH_BASED.items()}
        plain["ldof"] = nb.ldof_score(*cpu, inner_cpu).numpy()
        plain["cof"] = cof_score(sub.x, cpu[1], inner_cpu).numpy()
        excess = {m: np.abs(rows[m][0] - p) - 1e-4 * np.abs(p)
                  for m, p in plain.items() if m != "kdeos"}
        # KDEOS's z-score, (mean - density) / spread, cancels where a
        # density sits near its neighbours' mean, so float32 parts summed
        # in another order move it past any fixed tolerance there.  Its
        # parts (neighbors.kdeos_terms) are held at the tolerance instead,
        # and the card's score to the formula on the card's own parts in
        # float64 at rtol 1e-6 (the float32 subtraction and division).
        card = [t.cpu().numpy() for t in nb.kdeos_terms(*graph)]
        for part, a, b in zip(("density", "mean", "spread"), card,
                              (t.numpy() for t in nb.kdeos_terms(*cpu))):
            excess[f"kdeos {part}"] = np.abs(a - b) - 1e-4 * np.abs(b)
        dens, mu, sd = (a.astype(np.float64) for a in card)
        z = -(mu - dens) / sd
        excess["kdeos"] = np.abs(rows["kdeos"][0] - z) - 1e-6 * np.abs(z)
        worst = {m: float(e.max()) for m, e in excess.items()}
        check(max(worst.values()) <= 1e-6, f"{name}: the card's graph-"
              "based, LDOF and COF scores equal the plain CPU version's on "
              "the card's graph (rtol 1e-4, atol 1e-6; KDEOS's parts so, "
              "its score its parts' formula at rtol 1e-6); worst excess "
              + ", ".join(f"{m} {v:.1e}" for m, v in worst.items()))
        tables[name] = {m: {"seconds": r[1], "counts": r[2]}
                        for m, r in rows.items()}
    name = "kddcup99_http"
    ds, k = datasets[name], PAPER_K[name]
    t0 = time.perf_counter()
    rows, _, _ = run_baselines(ds, k, device, ALL_BASELINES)
    print_table(f"{name}, full n", ds, k, rows)
    print(f"  all 11 baselines at n={ds.n:,}: "
          f"{time.perf_counter() - t0:.1f} s (host clock)")
    tables[f"{name}_full"] = {m: {"seconds": r[1], "counts": r[2]}
                              for m, r in rows.items()}
    return paths, tables


# ---------------------------------------------------------------------------
# Phase 15: a language model served behind the guardrail (ServeEngine).
# ---------------------------------------------------------------------------

SERVE_B, SERVE_PROMPT, SERVE_NEW, SERVE_SMAX = 64, 128, 64, 256
MIXTRAL_LAYERS = 8          # of Mixtral-8x7B's 32: 47 GB of float32 weights
CONSIST_LAYERS = 2          # (b): Mixtral's first two layers in float32
RING_WINDOW, RING_NEW = 32, 48   # (b): the ring's window cut, tokens decoded
CPU_B, CPU_PROMPT, CPU_NEW = 2, 16, 4   # (c): the card against the CPU
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)  # the reference's tests/test_archs.py


def serve_guardrail(device, params, vocab: int, d_model: int):
    """Phase 4's flat guardrail at ``d_model``, warmed past its warm-up on
    384 rows of the model's embeddings (3 admits of 128 prompts x 4)."""
    from repro_torch.serve.engine import Guardrail, GuardrailConfig
    g = Guardrail(GuardrailConfig(d_model=d_model, num_bits=K_BITS,
                                  num_tables=L_TABLES), device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    for _ in range(3):
        toks = torch.randint(0, vocab, (128, 4), generator=gen, device=device)
        g.admit(params["embed"][toks])
    check(float(g.state.n) >= g.gcfg.warmup_items,
          f"guardrail warmed past warmup_items ({float(g.state.n):g} >= "
          f"{g.gcfg.warmup_items:g})")
    return g


def prompts_for(device, vocab: int, b: int, s: int, seed: int):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=gen, device=device,
                         dtype=torch.int32)


def checked_generate(mods, device, what, eng, params, batch, g, screened):
    """One measured ``generate`` of SERVE_NEW tokens, its launches, transfers
    and syncs checked: behind a screened batch one ``ace_admit_fused``
    launch, the verdict block and the tokens the only transfers and no
    sync in prefill and decode under sync-debug "error"; behind an
    unscreened one no launch, the guardrail's n unchanged, the tokens the
    one transfer and no sync from the call's start.  Returns (tokens,
    host seconds, each kernel's launches in the call)."""
    from repro_torch.serve import engine as E
    g_n = float(g.state.n)
    transfers = []
    to_host, admit = E._to_host, g.admit

    def counted_to_host(x):
        torch.cuda.set_sync_debug_mode(0)      # the transfer may sync
        transfers.append(tuple(x.shape))
        return to_host(x)

    def then_no_sync(*a, **k):
        out = admit(*a, **k)                   # ends in its one transfer
        torch.cuda.set_sync_debug_mode("error")
        return out

    E._to_host, g.admit = counted_to_host, then_no_sync
    sync(device)
    reset_launches(mods)
    try:
        if not screened:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        toks = eng.generate(params, batch, num_new_tokens=SERVE_NEW,
                            prompt_len=SERVE_PROMPT)
        gen_s = time.perf_counter() - t0
    except RuntimeError as e:
        check(False, f"{what}: no sync in prefill and decode ({e})")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        E._to_host = to_host
        del g.admit
    launches = read_launches(mods)
    check(toks.shape == (SERVE_B, SERVE_NEW) and toks.dtype == np.int32,
          f"{what}: generate returned {toks.shape} {toks.dtype}")
    check(((toks >= 0) & (toks < eng.arch.cfg.vocab_size)).all(),
          f"{what}: every token in the vocabulary")
    if screened:
        check(launches["ace_admit_fused"] == 1 and launches["ace_query"] >= 1,
              f"{what}: one ace_admit_fused launch in the generate "
              f"({launches['ace_admit_fused']}), ace_query_sum "
              f"{launches['ace_query']}")
        check(transfers == [(2, SERVE_B), (SERVE_B, SERVE_NEW)],
              f"{what}: the guardrail's verdict block and the tokens are "
              f"the generate's only transfers ({transfers}); no sync in "
              "prefill and decode under sync-debug \"error\"")
    else:
        check(sum(launches.values()) == 0 and float(g.state.n) == g_n,
              f"{what}: a batch with \"embeds\" is never screened: no "
              f"kernel launch in the generate ({launches}), the guardrail's "
              "n unchanged")
        check(transfers == [(SERVE_B, SERVE_NEW)],
              f"{what}: the tokens are the generate's one transfer "
              f"({transfers}); no sync in the whole generate under "
              "sync-debug \"error\"")
    return toks, gen_s, launches


def memory_now(device) -> dict:
    """The peak allocated since the last reset and what the allocator holds
    (the graphs' pools included), after a sync."""
    sync(device)
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_reserved": torch.cuda.memory_reserved()}


def logits_agree(what, kind, got, want, card, exact=False) -> float:
    """Captured logits against the eager twin's: bitwise expected, else
    (unless ``exact``) within the reference tests' 2e-4.  Returns the max
    abs difference."""
    err = float((got.float() - want.float()).abs().max())
    same = bool(torch.equal(got, want))
    check(same or not exact and torch.allclose(got.float(), want.float(),
                                               **MODEL_TOL),
          f"{what}: captured {kind} logits against the eager twin's "
          f"({'bitwise' if same else f'max abs {err:.3g}'}; {card})")
    return err


def prefill_in_turns(eng, params, batch, device) -> tuple:
    """The engine's prefill program captured and eager in turns (C E E C
    C E): (host ms of each, {kind: (logits, cache)} of the last of
    each)."""
    from repro_torch.core import capture
    ms = {"captured": [], "eager": []}
    got = {}
    for kind in ("captured", "eager", "eager", "captured", "captured",
                 "eager"):
        with contextlib.ExitStack() as stack:
            if kind == "eager":
                stack.enter_context(capture.disabled())
            sync(device)
            t0 = time.perf_counter()
            _, got[kind] = eng._prefill(None, params, batch)
            sync(device)
            ms[kind].append(1e3 * (time.perf_counter() - t0))
    return ms, got


def bitwise(what, kind, got, want, card) -> None:
    """Captured against the eager twin, trees of tensors leaf by leaf:
    bitwise, the phase's contract."""
    from repro_torch.core import capture
    pairs = list(zip(capture.leaves(got), capture.leaves(want)))
    err = max(float((x.float() - y.float()).abs().max()) for x, y in pairs)
    check(all(torch.equal(x, y) for x, y in pairs),
          f"{what}: captured {kind} bitwise the eager twin's ({len(pairs)} "
          f"tensors, max abs {err:.3g}; {card})")


def serve_model(mods, device, what, arch, params, g, card,
                extra=None, exact=False) -> dict:
    """SERVE_B prompts of SERVE_PROMPT tokens behind ``g``, SERVE_NEW new,
    through the engine's captured programs in turns with their eager twin
    (``capture.disabled()``).  The eager twin first, from a flushed cache
    (its warm-up, then a measured generate: its memory); then the captured
    path (a warm-up generate that builds both programs, then the measured
    ``checked_generate``: its memory, the graphs' pools included); the
    tokens equal; ``trace_counts`` (1, 1); the weights adopted (same
    ``data_ptr``s); one eager then one captured generate more (turns E, C,
    C, E).  Then prefill ms (median of 3, through the engine's prefill
    program, in turns C E E C C E), the prefill's and one decode step's
    logits from one cache against the eager twin's (``exact``: bitwise,
    the prefill's cache too), the device ms of the cache's
    hand-over (the prefill's outputs cloned, then copied into the decode
    program's state), ``decode_throughput`` (two runs of 16, in turns)
    and one traced decode step each way.  ``extra`` joins
    the batch (whisper's {"embeds": frames}); a batch with "embeds" is
    never screened (the reference's rule)."""
    from repro_torch.core import capture
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine as E
    cfg = arch.cfg
    eng = E.ServeEngine(arch, s_max=SERVE_SMAX, guardrail=g, device=device)
    batch = {"tokens": prompts_for(device, cfg.vocab_size, SERVE_B,
                                   SERVE_PROMPT, SEED + 16), **(extra or {})}
    screened = "embeds" not in batch
    ptrs = [t.data_ptr() for t in capture.leaves(params)]
    gen = {"captured": [], "eager": []}

    def timed(kind):
        sync(device)
        t0 = time.perf_counter()
        toks = eng.generate(params, batch, num_new_tokens=SERVE_NEW,
                            prompt_len=SERVE_PROMPT)
        gen[kind].append(time.perf_counter() - t0)
        return toks

    mem = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with capture.disabled():
        eng.generate(params, batch, num_new_tokens=2, prompt_len=SERVE_PROMPT)
        eager_toks = timed("eager")
    mem["eager"] = memory_now(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng.generate(params, batch, num_new_tokens=2, prompt_len=SERVE_PROMPT)
    toks, gen_s, launches = checked_generate(mods, device, what, eng, params,
                                             batch, g, screened)
    gen["captured"].append(gen_s)
    mem["captured"] = memory_now(device)
    check(np.array_equal(toks, eager_toks), f"{what}: captured tokens equal "
          f"the eager twin's ({SERVE_B} x {SERVE_NEW})")
    check(eng.trace_counts == (1, 1), f"{what}: one prefill and one decode "
          f"program after the warm-up and the measured generate "
          f"(trace_counts {eng.trace_counts})")
    kept = [t.data_ptr() for t in capture.leaves(params)]
    held = [w[0] for p in (eng._prefill, eng._decode)
            for w in p._last.where[0]]
    check(kept == ptrs and held == 2 * ptrs, f"{what}: the weights adopted, "
          f"not cloned: the graphs read the caller's {len(ptrs)} tensors "
          f"where they lie (same data_ptr)")
    check(np.array_equal(timed("captured"), eager_toks),
          f"{what}: a second captured generate gives the same tokens")
    with capture.disabled():
        timed("eager")

    pre, got = prefill_in_turns(eng, params, batch, device)
    (logits, cache), (elogits, ecache) = got["captured"], got["eager"]
    err = {"prefill": logits_agree(what, "prefill", logits, elogits, card,
                                   exact)}
    if exact:
        bitwise(what, "prefill cache", cache, ecache, card)
    step = {"tokens": torch.argmax(elogits[:, -1], dim=-1)
            .to(torch.int32)[:, None]}
    pos = torch.full((SERVE_B,), SERVE_PROMPT, dtype=torch.int32,
                     device=device)
    # one decode step from one cache: the program copies it in, the eager
    # step reads it; neither writes it
    _, dlogits = eng._decode(ecache, params, step, pos)
    with capture.disabled():
        _, delogits = eng._decode(ecache, params, step, pos)
    err["decode"] = logits_agree(what, "decode step", dlogits, delogits,
                                 card, exact)
    # two runs of 16 steps each way, in turns: the spread of the host clock
    dec = {"captured": [], "eager": []}
    for kind in ("captured", "eager", "eager", "captured"):
        with contextlib.ExitStack() as stack:
            if kind == "eager":
                stack.enter_context(capture.disabled())
            dec[kind].append(E.decode_throughput(arch, params, cache, step,
                                                 pos, iters=16))
    state, _ = eng._decode(cache, params, step, pos)
    # the cache's hand-over: cloned out of the prefill's graph, then copied
    # into the decode program's static state at the first step
    pairs = list(zip(capture.leaves(state), capture.leaves(cache)))
    hand = {"bytes": sum(x.numel() * x.element_size() for _, x in pairs),
            "clone_ms": device_ms(
                lambda: capture.tree_map(torch.clone, cache), reps=5,
                inner=2),
            "copy_in_ms": device_ms(
                lambda: [s.copy_(x) for s, x in pairs], reps=5, inner=2)}
    tr = {"captured": device_trace(
        lambda: eng._decode(state, params, step, pos), device)}
    with capture.disabled():
        tr["eager"] = device_trace(
            lambda: arch.decode_step(params, step, cache, pos), device)
    out = {"launches": launches,
           "prefill_ms": statistics.median(pre["captured"]),
           "eager_prefill_ms": statistics.median(pre["eager"]),
           "generate_tokens_per_s": SERVE_B * SERVE_NEW / gen_s,
           "generate_s": gen["captured"], "eager_generate_s": gen["eager"],
           "eager_generate_tokens_per_s":
               SERVE_B * SERVE_NEW / gen["eager"][0],
           "decode_tokens_per_s": dec["captured"][0],
           "decode_tokens_per_s_runs": dec["captured"],
           "eager_decode_tokens_per_s_runs": dec["eager"],
           "decode_step_trace": {k: v for k, v in tr["captured"].items()
                                 if k != "top"},
           "eager_decode_step_trace": {k: v for k, v in tr["eager"].items()
                                       if k != "top"},
           "logits_max_abs_err": err, "trace_counts": eng.trace_counts,
           "memory": mem, "cache_hand_over": hand}
    if cfg.moe_num_experts:
        with torch.no_grad():
            _, aux, _ = tf._run_full(params, batch, cfg)
        moe_layers = sum(moe for *_, moe in tf.layers(cfg))
        out["moe_drop_frac"] = float(aux["moe_drop_frac"]) / moe_layers
    toks_s = [SERVE_B * SERVE_NEW / t for t in gen["captured"]]
    etoks_s = [SERVE_B * SERVE_NEW / t for t in gen["eager"]]
    print(f"  {what}: B {SERVE_B} x {SERVE_PROMPT} prompt tokens, "
          f"{SERVE_NEW} new, captured / eager: prefill "
          f"{out['prefill_ms']:.3f} / {out['eager_prefill_ms']:.3f} ms "
          f"(median of 3, the engine's prefill program); generate "
          f"{toks_s[0]:,.1f}, {toks_s[1]:,.1f} / {etoks_s[0]:,.1f}, "
          f"{etoks_s[1]:,.1f} tokens/s (turns E C C E, the admit included); "
          f"decode_throughput {dec['captured'][0]:,.1f}, "
          f"{dec['captured'][1]:,.1f} / {dec['eager'][0]:,.1f}, "
          f"{dec['eager'][1]:,.1f} tokens/s (two runs of 16 steps each)"
          + (f"; prefill moe_drop_frac {out['moe_drop_frac']:.4f} an MoE "
             "layer" if "moe_drop_frac" in out else "")
          + f"; logits max abs prefill {err['prefill']:.3g}, decode "
          f"{err['decode']:.3g}; the cache's hand-over "
          f"{hand['bytes'] / 1e9:.3f} GB: clone {hand['clone_ms']:.3f} ms + "
          f"copy-in {hand['copy_in_ms']:.3f} ms (CUDA events); trace_counts "
          f"{eng.trace_counts}; launches "
          f"{launches} ({card})")
    for kind in ("captured", "eager"):
        m = mem[kind]
        print(f"  {what} {kind}: warm-up + measured generate peak "
              f"(max_memory_allocated) {m['max_memory_allocated'] / 2**30:.2f}"
              f" GiB, memory_reserved {m['memory_reserved'] / 2**30:.2f} GiB "
              f"({card})")
        t = tr[kind]
        busy = t["device_busy_ms"]
        print(f"  {what}: one {kind} decode step under torch.profiler: wall "
              f"{t['profiled_wall_ms']:.3f} ms, {t['device_ops']} device ops, "
              f"device busy {busy:.3f} ms (idle share "
              f"{1 - busy / t['profiled_wall_ms']:.3f}); top: "
              + ", ".join(f"{n[:40]} {v / 1e3:.3f} ms" for n, v in t["top"])
              + f" ({card})" if t["device_ops"] else
              f"  {what}: no device op in the {kind} decode step's trace; "
              "device idle share not measured")
    return out


def greedy_logits(arch, params, prompts, new: int, s_max: int, extra=None):
    """Greedy decode keeping every step's logits: (tokens, logits).
    ``extra`` joins the prefill's batch (whisper's frames)."""
    logits, cache = arch.prefill(params, {"tokens": prompts, **(extra or {})},
                                 s_max=s_max)
    B, P = prompts.shape
    outs, toks = [logits[:, -1]], []
    for i in range(new):
        tok = torch.argmax(outs[-1], dim=-1).to(torch.int32)
        toks.append(tok)
        if i == new - 1:
            break
        pos = torch.full((B,), P + i, dtype=torch.int32, device=tok.device)
        logits, cache = arch.decode_step(params, {"tokens": tok[:, None]},
                                         cache, pos)
        outs.append(logits[:, -1])
    return torch.stack(toks, 1), torch.stack(outs, 1)


def sub_model(arch, params, layers: int, **kw):
    """An Arch on the first ``layers`` layers of ``params`` (no copy), its
    config replaced by ``kw`` too."""
    import copy
    a = copy.copy(arch)
    a.cfg = dataclasses.replace(arch.cfg, num_layers=layers, **kw)
    if "blocks" not in params:           # whisper: all its layers
        return a, params
    return a, {**params, "blocks": params["blocks"][:a.cfg.num_superblocks]}


def fp32_against_forward(what, a, p, device, card, prompt=16,
                         s_max=32) -> dict:
    """A float32 model ``a``: prefill of ``prompt`` tokens (a cache of
    ``s_max`` slots) and one decode step, the last-token logits against
    ``forward``'s over all ``prompt`` + 1 (2 prompts), within rtol/atol
    2e-4; an MoE's forward at capacity E/K drops no token.  Returns the
    max abs errors."""
    toks = prompts_for(device, a.cfg.vocab_size, 2, prompt + 1, SEED + 17)
    full, aux = a.forward(p, {"tokens": toks})
    if a.cfg.moe_num_experts:
        check(float(aux["moe_drop_frac"]) == 0.0,
              f"{what}: capacity E/K, forward drops no token")
    last, cache = a.prefill(p, {"tokens": toks[:, :prompt]}, s_max=s_max)
    step, _ = a.decode_step(p, {"tokens": toks[:, prompt:]}, cache,
                            torch.full((2,), prompt, dtype=torch.int32,
                                       device=device))
    return logits_against_forward(what, last, step, full, prompt, card)


def logits_against_forward(what, last, step, full, prompt, card) -> dict:
    """The prefill's last-token logits and one decode step's against
    ``forward``'s at positions ``prompt`` - 1 and ``prompt``, within
    rtol/atol 2e-4.  Returns the max abs errors."""
    errs = {}
    for name, got, want in (("prefill", last[:, 0], full[:, prompt - 1]),
                            ("decode", step[:, 0], full[:, prompt])):
        errs[name] = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, **MODEL_TOL))
        check(ok, f"{what}: {name} last-token logits against forward "
              f"within rtol/atol 2e-4 (max abs {errs[name]:.3g}; {card})")
    return errs


def consistency_fp32(arch, params, device, card) -> None:
    """(b): Mixtral's first CONSIST_LAYERS layers in float32."""
    cfg = arch.cfg
    a, p = sub_model(arch, params, CONSIST_LAYERS, dtype="float32",
                     moe_capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    fp32_against_forward(f"mixtral x{CONSIST_LAYERS} float32", a, p, device,
                         card)
    a, p = sub_model(arch, params, CONSIST_LAYERS, dtype="float32",
                     sliding_window=RING_WINDOW)
    ring_against_full(f"mixtral x{CONSIST_LAYERS} float32", a, p, device)


def ring_against_full(what, a, p, device) -> None:
    """``a``, every layer sliding-window with its window cut to
    RING_WINDOW: greedy tokens from a ring cache (s_max RING_WINDOW)
    equal to those from a full one (s_max 2 x RING_WINDOW) over RING_NEW
    tokens that wrap it, 2 prompts of 8."""
    from repro_torch.serve.engine import ServeEngine
    prompts = prompts_for(device, a.cfg.vocab_size, 2, 8, SEED + 18)
    ring = ServeEngine(a, s_max=RING_WINDOW, device=device).generate(
        p, {"tokens": prompts}, num_new_tokens=RING_NEW, prompt_len=8)
    flat = ServeEngine(a, s_max=2 * RING_WINDOW, device=device).generate(
        p, {"tokens": prompts}, num_new_tokens=RING_NEW, prompt_len=8)
    check((ring == flat).all(), f"{what}, window {RING_WINDOW}: ring cache "
          f"(s_max {RING_WINDOW}) tokens equal the full cache's (s_max "
          f"{2 * RING_WINDOW}) over {RING_NEW} tokens that wrap it")


def card_against_cpu(arch, params, device, card, what="olmo_1b float32",
                     extra=None) -> float:
    """(c): a model's weights in float32, the card's greedy decode against
    the CPU's; ``extra`` joins the prefill's batch on both.  Returns the
    max abs error of the logits."""
    a, p = sub_model(arch, params, arch.cfg.num_layers, dtype="float32")
    prompts = prompts_for(device, a.cfg.vocab_size, CPU_B, CPU_PROMPT,
                          SEED + 19)
    extra = extra or {}
    toks, logits = greedy_logits(a, p, prompts, CPU_NEW, 32, extra)
    cpu = torch.device("cpu")

    def to_cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.to(cpu)
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return [to_cpu(v) for v in tree]

    ctoks, clogits = greedy_logits(a, to_cpu(p), prompts.cpu(), CPU_NEW, 32,
                                   to_cpu(extra))
    err = float((logits.cpu() - clogits).abs().max())
    check(torch.allclose(logits.cpu(), clogits, **MODEL_TOL),
          f"{what}: card logits of {CPU_NEW} greedy steps against the "
          f"CPU's within rtol/atol 2e-4 (max abs {err:.3g}; {card})")
    check(torch.equal(toks.cpu(), ctoks), f"{what}: card tokens equal the "
          "CPU's")
    return err


def phase_serve(mods, device, card) -> dict:
    from repro_torch.models import Arch
    from repro_torch.models.registry import leaves
    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arch = Arch("mixtral_8x7b")
    arch.cfg = dataclasses.replace(arch.cfg, num_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = arch.init_params(SEED, device=device)
    sync(device)
    print(f"  mixtral_8x7b at full width, {MIXTRAL_LAYERS} of 32 layers: "
          f"{sum(t.numel() for t in leaves(params)) / 1e9:.2f} B float32 "
          f"parameters drawn in {time.perf_counter() - t0:.2f} s ({card})")
    g = serve_guardrail(device, params, arch.cfg.vocab_size,
                        arch.cfg.d_model)
    out["serve_mixtral"] = serve_model(mods, device, "mixtral_8x7b", arch,
                                       params, g, card)
    consistency_fp32(arch, params, device, card)
    peak = torch.cuda.max_memory_allocated()
    out["serve_mixtral"]["max_memory_allocated"] = peak
    print(f"  mixtral peak memory (max_memory_allocated) {peak / 2**30:.2f} "
          f"GiB ({card})")
    del params, g
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    arch = Arch("olmo_1b")
    params = arch.init_params(SEED, device=device)
    g = serve_guardrail(device, params, arch.cfg.vocab_size,
                        arch.cfg.d_model)
    out["serve_olmo"] = serve_model(mods, device, "olmo_1b", arch, params, g,
                                    card)
    peak = torch.cuda.max_memory_allocated()
    out["serve_olmo"]["max_memory_allocated"] = peak
    print(f"  olmo_1b peak memory (max_memory_allocated) {peak / 2**30:.2f} "
          f"GiB ({card})")
    card_against_cpu(arch, params, device, card)
    del params, g
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 16: the rest of the zoo served behind the guardrail: Jamba's Mamba
# hybrid, RWKV-6 and whisper.
# ---------------------------------------------------------------------------

JAMBA_LAYERS = 8            # one of Jamba's four 8-layer superblocks: 53 GB
RWKV_FP32_LAYERS = 2        # (b): RWKV-6's first two layers in float32


def redraw_rwkv_zeros(params, device, seed: int):
    """``params`` with every RWKV block's zero-initialised time-mix ``wo``
    and channel-mix ``wv`` drawn anew, std 1/sqrt(fan-in), from a
    generator seeded with ``seed`` (new dicts; ``params`` unchanged): at
    init those blocks add exactly 0, so a check would hold only the
    embedding, ln0 and the head."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def drawn(t):
        return torch.randn(t.shape, generator=gen, device=device,
                           dtype=t.dtype) / t.shape[0] ** 0.5

    return {**params, "blocks": [[
        {**b, "mixer": {**b["mixer"], "wo": drawn(b["mixer"]["wo"])},
         "mlp": {**b["mlp"], "wv": drawn(b["mlp"]["wv"])}} for b in row]
        for row in params["blocks"]]}


def recurrent_mixer_ms(what, arch, params, prefill_ms, device, card):
    """Host-clock ms (median of 3 after a warm-up, each ending in a sync)
    of one recurrent mixer, ``mamba_scan`` or ``rwkv_time_scan`` with its
    projections, on the prefill's (SERVE_B, SERVE_PROMPT, d_model) in the
    activation dtype; printed beside the prefill it is part of."""
    from repro_torch.models import mamba as mb
    from repro_torch.models import rwkv6 as rw
    from repro_torch.models import transformer as tf
    cfg = arch.cfg
    layers = list(tf.layers(cfg))
    r, i, kind, _ = next(x for x in layers if x[2] in ("mamba", "rwkv"))
    p = params["blocks"][r][i]["mixer"]
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    h = torch.randn((SERVE_B, SERVE_PROMPT, cfg.d_model), generator=gen,
                    device=device).to(cfg.adtype)
    st = rw.init_rwkv_state(cfg, SERVE_B, cfg.adtype, device)

    def run():
        if kind == "mamba":
            return mb.mamba_scan(p, h, cfg)
        return rw.rwkv_time_scan(p, h, st.x_prev_att, st.wkv, cfg)

    times = []
    for _ in range(4):
        sync(device)
        t0 = time.perf_counter()
        run()
        sync(device)
        times.append(time.perf_counter() - t0)
    ms = 1e3 * statistics.median(times[1:])
    n = sum(x[2] == kind for x in layers)
    print(f"  {what}: one {kind} mixer (projections and the time loop) at "
          f"the prefill's shape {ms:.3f} ms (median of 3); x {n} layers = "
          f"{n * ms:.1f} ms of the prefill's {prefill_ms:.1f} ms ({card})")
    return ms


def serve_zoo_model(mods, device, card, name, layers=None, frames=False):
    """``name`` at its published widths (cut to ``layers``), its weights
    drawn on the card, served by ``serve_model`` behind a warmed flat
    guardrail at its d_model (with ``frames``, on SERVE_B frame batches
    (B, encoder_seq, d_model) drawn from SEED); returns (the path's
    numbers, arch, params, the frames or None)."""
    from repro_torch.models import Arch
    from repro_torch.models.registry import leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arch = Arch(name)
    if layers is not None:
        arch.cfg = dataclasses.replace(arch.cfg, num_layers=layers)
    t0 = time.perf_counter()
    params = arch.init_params(SEED, device=device)
    sync(device)
    n = sum(t.numel() for t in leaves(params))
    print(f"  {name} at full width, {arch.cfg.num_layers} layers: "
          f"{n / 1e9:.3f} B float32 parameters ({4 * n / 1e9:.1f} GB) drawn "
          f"in {time.perf_counter() - t0:.2f} s ({card})")
    g = serve_guardrail(device, params, arch.cfg.vocab_size,
                        arch.cfg.d_model)
    embeds = None
    if frames:
        gen = torch.Generator(device=device).manual_seed(SEED + 21)
        embeds = torch.randn((SERVE_B, arch.cfg.encoder_seq,
                              arch.cfg.d_model), generator=gen,
                             device=device)
    out = serve_model(mods, device, name, arch, params, g, card,
                      None if embeds is None else {"embeds": embeds})
    out["params"] = n
    if {"mamba", "rwkv"} & set(arch.cfg.block_pattern):
        out["mixer_ms"] = recurrent_mixer_ms(name, arch, params,
                                             out["prefill_ms"], device, card)
    return out, arch, params, embeds


def phase_serve_zoo(mods, device, card) -> dict:
    """(a) Jamba's superblock, (b) RWKV-6 7B, (c) whisper_tiny, each served
    and checked in float32 (the module docstring, phase 16)."""
    out = {}
    res, arch, params, _ = serve_zoo_model(mods, device, card,
                                           "jamba_v01_52b",
                                           layers=JAMBA_LAYERS)
    cfg = arch.cfg
    a, p = sub_model(arch, params, JAMBA_LAYERS, dtype="float32",
                     moe_capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    res["fp32_err"] = fp32_against_forward(
        f"jamba x{JAMBA_LAYERS} float32 (7 Mamba + 1 attention)", a, p,
        device, card)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"  jamba peak memory (max_memory_allocated) "
          f"{res['max_memory_allocated'] / 2**30:.2f} GiB ({card})")
    out["serve_jamba"] = res
    del params, a, p

    res, arch, params, _ = serve_zoo_model(mods, device, card, "rwkv6_7b")
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"  rwkv6_7b peak memory (max_memory_allocated) "
          f"{res['max_memory_allocated'] / 2**30:.2f} GiB ({card})")
    a, p = sub_model(arch, params, RWKV_FP32_LAYERS, dtype="float32")
    p = redraw_rwkv_zeros(p, device, SEED + 20)
    what = f"rwkv6 x{RWKV_FP32_LAYERS} float32, wo and wv redrawn"
    res["fp32_err"] = fp32_against_forward(what, a, p, device, card)
    res["fp32_err"]["card_vs_cpu"] = card_against_cpu(a, p, device, card,
                                                      what)
    out["serve_rwkv"] = res
    del params, a, p

    res, arch, params, frames = serve_zoo_model(mods, device, card,
                                                "whisper_tiny", frames=True)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"  whisper_tiny peak memory (max_memory_allocated) "
          f"{res['max_memory_allocated'] / 2**30:.2f} GiB ({card})")
    res["fp32_err"] = {"card_vs_cpu": card_against_cpu(
        arch, params, device, card, "whisper_tiny float32",
        {"embeds": frames[:CPU_B]})}
    out["serve_whisper"] = res
    del params, frames
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 17: training behind the data filter and the gradient monitor.
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 8, 128            # the training launcher's defaults
TRAIN_STEPS, TRAIN_CHUNK = 8, 4      # (a): each run's steps, the prefilter's T
TRAIN_KERNELS = ("srp_hash", "ace_query", "ace_update", "ace_admit_fused")
REDUCED_STEPS = 4                    # (b): card against CPU
ARMED_STEPS = 24                     # (b): then on past the monitor's warmup
LOCKSTEP_BATCHES = 84                # (b): the filter's 64 warmup steps + 20
REDUCED_B, REDUCED_S = 8, 16         # (b), (d): the reference test's stream
RECUR_B, RECUR_S, RECUR_CHUNK = 2, 256, 64   # (c)
POISON_STEPS, POISON_EVERY, POISON_Q = 130, 13, 0.05   # (d)
POISON_B = 64                        # (d): the filter's stream (arms at step 8)
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
SECTIONS = ("forward", "backward", "clip", "filter", "monitor", "optimiser")
BREAKDOWN_STEPS = 3                  # unprofiled steps timed for the idle share


def train_config(**kw):
    """The phase's TrainConfig: AdamW, remat, filter and monitor on, two
    warm-up steps of the cosine schedule, on the card unless ``kw`` says
    otherwise."""
    from repro_torch.train.train_loop import TrainConfig
    base = dict(optimizer="adamw", peak_lr=3e-4, warmup_steps=2,
                total_steps=64, remat=True, use_data_filter=True,
                use_grad_monitor=True, seed=SEED, device="cuda")
    return TrainConfig(**{**base, **kw})


@contextlib.contextmanager
def step_transfers(rec: dict):
    """``train_loop``'s two named transfers counted, and every step held
    to no sync: sync-debug "error" from the end of each batch's H2D to the
    step's metrics D2H, off only inside the two transfers; ``rec["ends"]``
    the host time each metrics transfer returned."""
    from repro_torch.train import train_loop as tl
    to_device, to_host = tl._to_device, tl._to_host

    def counted_device(batch, dev):
        torch.cuda.set_sync_debug_mode(0)
        out = to_device(batch, dev)
        rec["h2d"] += 1
        torch.cuda.set_sync_debug_mode("error")
        return out

    def counted_host(x):
        torch.cuda.set_sync_debug_mode(0)
        out = to_host(x)
        rec["d2h"] += 1
        rec["ends"].append(time.perf_counter())
        torch.cuda.set_sync_debug_mode("error")
        return out

    tl._to_device, tl._to_host = counted_device, counted_host
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        tl._to_device, tl._to_host = to_device, to_host


def run_train(mods, device, card, what, arch, tcfg, state, stream, steps,
              tokens_per_step):
    """``train`` for ``steps`` steps with the launch counts set to 0 just
    before and read just after, its transfers counted and no sync allowed
    inside a step; prints and returns (state, the path's numbers)."""
    from repro_torch.train.train_loop import train
    rec = {"h2d": 0, "d2h": 0, "ends": []}
    gc.collect()             # an earlier step's garbage is not this run's
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    reset_launches(mods)
    t0 = time.perf_counter()
    try:
        with step_transfers(rec), train_programs() as programs:
            state, hist = train(arch, tcfg, stream, steps, log_every=0,
                                state=state)
    except RuntimeError as e:
        check(False, f"{what}: no sync inside a step ({e})")
    sync(device)
    seconds = time.perf_counter() - t0
    launches = read_launches(mods)
    traces = {k: p.trace_count for k, p in programs.items()}
    ends = [t0] + rec["ends"]
    step_ms = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
    losses = [h["loss"] for h in hist]
    keep = statistics.mean(h.get("filter_keep_frac", 1.0) for h in hist)
    out = {"launches": launches, "steps": steps, "seconds": seconds,
           "step_ms": statistics.median(step_ms), "losses": losses,
           "keep_frac": keep, "hist": hist,
           "tokens_per_s": steps * tokens_per_step / seconds,
           "grad_anomalies": sum(h.get("grad_anomaly", 0.0) for h in hist),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "memory_at_start": at_start, "trace_counts": traces}
    check(len(hist) == steps and all(np.isfinite(losses)),
          f"{what}: {steps} steps, every loss finite ({losses[0]:.4f} -> "
          f"{losses[-1]:.4f})")
    check(rec["d2h"] == steps and rec["h2d"] == steps,
          f"{what}: one H2D (the batch) and one D2H (the metrics) a step "
          f"({rec['h2d']}, {rec['d2h']}), no sync in a step")
    ran = {k: launches[k] for k in TRAIN_KERNELS}
    check(all(ran.values()), f"{what}: every kernel of the path launched "
          f"{ran}")
    print(f"  {what}: step {out['step_ms']:.3f} ms (median of {steps}, "
          f"host clock between metrics transfers), "
          f"{out['tokens_per_s']:,.0f} tokens/s over {seconds:.3f} s, "
          f"filter keep {keep:.4f}, monitor flagged "
          f"{out['grad_anomalies']:.0f}, peak memory "
          f"{out['max_memory_allocated'] / 2**30:.2f} GiB "
          f"({(out['max_memory_allocated'] - at_start) / 2**30:.2f} over "
          f"the run's start), programs {traces} ({card})")
    return state, out


@contextlib.contextmanager
def train_programs():
    """``train``'s captured programs made within it, by function: the
    step (``train_step``), the chunk features and the tail step."""
    from repro_torch.core import capture
    real = capture.Program
    made = {}

    class Recorded(real):
        def __init__(self, fn, *a, **k):
            super().__init__(fn, *a, **k)
            name = getattr(fn, "__name__", "")
            if name in ("train_step", "chunk_features", "tail_step"):
                made[name] = self

    capture.Program = Recorded
    try:
        yield made
    finally:
        capture.Program = real


def clone_train_state(state):
    """A TrainState's copy on its device: every tensor cloned, the
    generator a new one in the same state."""
    from repro_torch.models.registry import tree_map

    def gen(g):
        out = torch.Generator(device=g.device)
        out.set_state(g.get_state())
        return out
    return type(state)(*[gen(f) if isinstance(f, torch.Generator)
                         else tree_map(torch.clone, f) for f in state])


def twin_differences(a, b, hist_a, hist_b) -> dict:
    """Each part of two training runs that is not bitwise the same, by
    name, with its largest absolute difference: the metrics, the
    parameters, the moments (``opt_state``), the sketches (the filter's,
    the monitor's), the residual and the generator's state."""
    from repro_torch.models.registry import leaves
    out = {}
    for k in sorted({k for h in hist_a for k in h}):
        x = np.array([h.get(k, np.nan) for h in hist_a])
        y = np.array([h.get(k, np.nan) for h in hist_b])
        if not np.array_equal(x, y, equal_nan=True):
            out[f"metric {k}"] = float(np.nanmax(np.abs(x - y)))
    for f in ("params", "opt_state", "filter_state", "monitor", "ef"):
        for i, (x, y) in enumerate(zip(leaves(getattr(a, f)),
                                       leaves(getattr(b, f)))):
            if not torch.equal(x, y):
                d = (x.double() - y.double()).abs().max()
                out[f"{f} leaf {i} {tuple(x.shape)}"] = float(d)
    if not torch.equal(a.rng.get_state(), b.rng.get_state()):
        out["generator state"] = float("nan")
    return out


def train_twins(mods, device, card, what, arch, tcfg, state, stream,
                tokens) -> tuple:
    """(a): one configuration's TRAIN_STEPS steps of ``train`` captured,
    then its eager twin (``capture.disabled()``) from a copy of the same
    state at the same stream position: (state, captured numbers, eager
    numbers, the parts that differ).  While one runs the other's state
    lies on the card too (the peak memory over the run's start excludes
    it)."""
    from repro_torch.core import capture
    from repro_torch.data.pipeline import DataStream
    twin = clone_train_state(state)
    twin_stream = DataStream(stream.cfg)
    twin_stream.load_state_dict(stream.state_dict())
    state, got = run_train(mods, device, card, f"{what}, captured", arch,
                           tcfg, state, stream, TRAIN_STEPS, tokens)
    with capture.disabled():
        twin, want = run_train(mods, device, card, f"{what}, eager twin",
                               arch, tcfg, twin, twin_stream, TRAIN_STEPS,
                               tokens)
    differ = twin_differences(state, twin, got.pop("hist"),
                              want.pop("hist"))
    del twin
    over = [(r["max_memory_allocated"] - r["memory_at_start"]) / 2**30
            for r in (got, want)]
    print(f"  {what}: captured against the eager twin over {TRAIN_STEPS} "
          f"steps: "
          + ("metrics, parameters, moments, sketches, residual and "
             "generator bitwise" if not differ else
             "differ in " + "; ".join(f"{k} (max abs {v:.3g})"
                                      for k, v in differ.items()))
          + f"; step {got['step_ms']:.3f} ms against {want['step_ms']:.3f} "
          f"ms ({want['step_ms'] / got['step_ms']:.3f}x), peak "
          f"{got['max_memory_allocated'] / 2**30:.2f} against "
          f"{want['max_memory_allocated'] / 2**30:.2f} GiB ({over[0]:.2f} "
          f"against {over[1]:.2f} over the run's start) ({card})")
    check(not differ, f"{what}: captured bitwise the eager twin "
          f"({sorted(differ)})")
    check(got["launches"] == want["launches"], f"{what}: each kernel "
          f"launched as often captured as eager ({got['launches']})")
    check(got["trace_counts"].get("train_step") == 1
          and not any(want["trace_counts"].values()),
          f"{what}: one step program captured, none in the twin "
          f"({got['trace_counts']}, {want['trace_counts']})")
    grow = got["max_memory_allocated"] - want["max_memory_allocated"]
    check(grow <= 4 * 2**30, f"{what}: captured peak within 4 GiB of the "
          f"twin's ({grow / 2**30:+.2f} GiB): no copy of the donated "
          "parameters and moments")
    return state, got, want, differ


@contextlib.contextmanager
def sectioned(events: list):
    """Each of ``SECTIONS`` bracketed by a pair of CUDA events on the
    current stream, appended to ``events`` as (label, start, end), at the
    functions a train step calls: ``Arch.loss`` (forward and loss),
    ``torch.autograd.grad`` (backward), the clip, the filter's
    ``__call__``, ``GradMonitor.step`` and ``AdamW.update``."""
    from repro_torch.data import pipeline
    from repro_torch.models import registry
    from repro_torch.train import fault, optim
    from repro_torch.train import train_loop as tl
    targets = [("forward", registry.Arch, "loss"),
               ("backward", torch.autograd, "grad"),
               ("clip", tl, "clip_by_global_norm"),
               ("filter", pipeline.AceDataFilter, "__call__"),
               ("monitor", fault.GradMonitor, "step"),
               ("optimiser", optim.AdamW, "update")]
    real = [(owner, name, getattr(owner, name)) for _, owner, name
            in targets]

    def timed(label, fn):
        def wrapper(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events.append((label, start, end))
            return out
        return wrapper

    for (label, owner, name), (_, _, fn) in zip(targets, real):
        setattr(owner, name, timed(label, fn))
    try:
        yield
    finally:
        for owner, name, fn in real:
            setattr(owner, name, fn)


def step_breakdown(arch, tcfg, state, stream, device, card) -> dict:
    """One full-size step under ``torch.profiler`` tracing the card only
    (no CPU-op recording, which would slow the host's dispatch): device
    ops and busy ms; the idle share against the median wall time of
    BREAKDOWN_STEPS unprofiled steps, each bracketed by syncs.  Each
    section's stream ms (its CUDA events) and device busy ms and ops: the
    traced kernels that start inside its event window, aligned on the
    ``torch.cuda._sleep(1)`` marker (``spin_kernel``) launched right after
    the origin event on an idle card; when the trace's first kernel is not
    that marker, the sections' busy ms are not measured (a kernel that
    starts within a few µs of a window's edge may fall on the wrong
    side)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import train_loop as tl
    step_fn = tl.make_train_step(arch, tcfg)

    def batch():
        return tl._to_device({k: v for k, v in next(stream).items()
                              if not k.startswith("_")}, device)
    state, _ = step_fn(state, batch())        # warm
    walls = []
    for _ in range(BREAKDOWN_STEPS):
        b = batch()
        sync(device)
        t0 = time.perf_counter()
        state, _ = step_fn(state, b)
        sync(device)
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_ms = statistics.median(walls)
    b = batch()
    sync(device)
    events: list = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with sectioned(events):
            t0 = time.perf_counter()
            origin = torch.cuda.Event(enable_timing=True)
            origin.record()
            torch.cuda._sleep(1)
            state, _ = step_fn(state, b)
            sync(device)
            traced_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted((x for x in prof.events()
                      if x.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda x: x.time_range.start)
    busy_ms = sum(x.time_range.elapsed_us() for x in kernels) / 1e3
    stream_ms = {k: 0.0 for k in SECTIONS}
    windows = [(label, 1e3 * origin.elapsed_time(s),
                1e3 * origin.elapsed_time(e)) for label, s, e in events]
    for label, lo, hi in windows:
        stream_ms[label] += (hi - lo) / 1e3
    out = {"wall_ms": wall_ms, "wall_ms_runs": walls,
           "traced_wall_ms": traced_ms, "device_ops": len(kernels),
           "device_busy_ms": busy_ms, "stream_ms": stream_ms,
           "busy_ms": None, "ops": None}
    print(f"  olmo_1b step, unprofiled: wall {wall_ms:.3f} ms (median of "
          f"{BREAKDOWN_STEPS}: {', '.join(f'{w:.3f}' for w in walls)}) "
          f"({card})")
    if not kernels:
        print("  one full-size step under torch.profiler: no device op in "
              "the trace; device busy ms and idle share not measured")
        return state, out
    out["idle_share"] = 1 - busy_ms / wall_ms
    print(f"  one full-size step under torch.profiler (card only): wall "
          f"{traced_ms:.3f} ms traced, {len(kernels)} device ops, busy "
          f"{busy_ms:.3f} ms; idle share against the unprofiled wall "
          f"{out['idle_share']:.3f} ({card})")
    if "spin_kernel" not in kernels[0].name:
        print(f"  by section, stream ms: "
              + ", ".join(f"{k} {stream_ms[k]:.3f}" for k in SECTIONS)
              + f"; device busy ms by section not measured (the trace's "
              f"first kernel is {kernels[0].name[:60]!r}, not the marker)")
        return state, out
    busy = {k: 0.0 for k in SECTIONS}
    ops = {k: 0 for k in SECTIONS}
    for x in kernels[1:]:
        at = x.time_range.start - kernels[0].time_range.start
        for label, lo, hi in windows:
            if lo <= at < hi:
                busy[label] += x.time_range.elapsed_us() / 1e3
                ops[label] += 1
                break
    out.update(busy_ms=busy, ops=ops)
    print("  by section, device busy ms (ops) / stream ms: "
          + ", ".join(f"{k} {busy[k]:.3f} ({ops[k]}) / {stream_ms[k]:.3f}"
                      for k in SECTIONS)
          + f"; outside them {busy_ms - sum(busy.values()):.3f}")
    return state, out


def captured_step(arch, tcfg, state, stream, device, card) -> tuple:
    """(a): ``step_breakdown``'s step as ``train`` runs it, one captured
    program (``core.capture``, its state donated): built by its first
    call (the eager warm-up and the capture, timed), then
    BREAKDOWN_STEPS replays each bracketed by syncs (their median wall,
    the batch's copy into the static inputs and the metrics' clones
    included) and one replay traced on the card (``device_trace``, the
    fuller of two traces): device ops, busy ms and the idle share against
    the unprofiled wall."""
    from repro_torch.core import capture
    from repro_torch.train import train_loop as tl
    step = capture.Program(tl.make_train_step(arch, tcfg), device,
                           name="train.step", donate=True)

    def batch():
        return tl._to_device({k: v for k, v in next(stream).items()
                              if not k.startswith("_")}, device)
    sync(device)
    t0 = time.perf_counter()
    state, _ = step(state, batch())
    sync(device)
    build_ms = 1e3 * (time.perf_counter() - t0)
    walls = []
    for _ in range(BREAKDOWN_STEPS):
        b = batch()
        sync(device)
        t0 = time.perf_counter()
        state, _ = step(state, b)
        sync(device)
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_ms = statistics.median(walls)
    traces = []
    for _ in range(2):
        b = batch()
        sync(device)

        def one():
            nonlocal state
            state, _ = step(state, b)
        traces.append(device_trace(one, device))
    tr = max(traces, key=lambda t: t["device_ops"])
    out = {"build_ms": build_ms, "wall_ms": wall_ms, "wall_ms_runs": walls,
           "device_ops": tr["device_ops"],
           "device_busy_ms": tr["device_busy_ms"],
           "traced_wall_ms": tr["profiled_wall_ms"],
           "trace_count": step.trace_count}
    print(f"  olmo_1b step captured (one program, {step.trace_count} key; "
          f"its build, the eager warm-up and the capture, {build_ms:.3f} "
          f"ms): wall {wall_ms:.3f} ms unprofiled (median of "
          f"{BREAKDOWN_STEPS}: {', '.join(f'{w:.3f}' for w in walls)}) "
          f"({card})")
    if not tr["device_ops"]:
        print("  one captured step under torch.profiler: no device op in "
              "the trace; device busy ms and idle share not measured")
        return state, out
    out["idle_share"] = 1 - tr["device_busy_ms"] / wall_ms
    print(f"  one captured step under torch.profiler: wall "
          f"{tr['profiled_wall_ms']:.3f} ms traced, {tr['device_ops']} "
          f"device ops, busy {tr['device_busy_ms']:.3f} ms; idle share "
          f"against the unprofiled wall {out['idle_share']:.3f}; top: "
          + ", ".join(f"{n[:40]} {v / 1e3:.3f} ms" for n, v in tr["top"])
          + f" ({card})")
    return state, out


def move_state(state, device):
    """A TrainState on ``device``: every tensor copied there, the
    generator a new one there seeded with SEED."""
    from repro_torch.models.registry import tree_map
    return type(state)(*[
        torch.Generator(device=device).manual_seed(SEED)
        if isinstance(f, torch.Generator)
        else tree_map(lambda t: t.to(device, copy=True), f)
        for f in state])


@contextlib.contextmanager
def recorded_noise(tape: list, replay: bool):
    """``compression.uniform_noise`` recording its draws into ``tape``
    (on the CPU), or replaying them in order: one noise draw for two
    runs."""
    from repro_torch.train import compression
    real = compression.uniform_noise
    it = iter(list(tape))

    def noise(shape, generator):
        if replay:
            return next(it)
        out = real(shape, generator)
        tape.append(out)
        return out

    compression.uniform_noise = noise
    try:
        yield
    finally:
        compression.uniform_noise = real


@contextlib.contextmanager
def recorded_outputs(owner, name: str, tape: list):
    """``owner.name`` appending a copy of each of its outputs to ``tape``."""
    real = getattr(owner, name)

    def wrapper(*a, **k):
        out = real(*a, **k)
        tape.append(out.detach().clone())
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, real)


def sketch_agreement(a, b) -> tuple:
    """Two AceStates: the counters that differ, whether n is equal, and the
    larger relative difference of the two Welford fields."""
    def rel(x, y):
        x, y = float(x), float(y)
        return 0.0 if x == y else abs(x - y) / max(abs(x), abs(y))
    return (int((a.counts.cpu() != b.counts.cpu()).sum()),
            float(a.n) == float(b.n),
            max(rel(a.welford_mean, b.welford_mean),
                rel(a.welford_m2, b.welford_m2)))


def monitor_lockstep(mon, w, rows, card) -> dict:
    """``GradMonitor.step_features``' kernel path (``srp_hash``,
    ``ace_query_sum``, ``ace_update(row_mask=~is_anom)``, the Welford fold
    through ``masked_batch_welford``) against its plain path
    (``sketch.score`` / ``sketch.insert`` + select) on the card, step by
    step from one state over ``rows`` (1, d + 1): where a step's ids agree,
    verdict, score, counts, n, Welford (rtol 1e-5) and the counters
    equal; where they do not, at most 2 counters differ per differing id.
    Ids agree >= 0.999, and once armed the monitor both flags and
    inserts."""
    from repro_torch.core import srp
    from repro_torch.kernels import ops as kops
    from repro_torch.models.registry import tree_map
    cfg = mon.ace_cfg
    state, _ = mon.init()
    wrong_ids = total_ids = 0
    faults, armed = [], {True: 0, False: 0}
    for t, feat in enumerate(rows):
        wrong = int((kops.srp_hash(feat, w, cfg.srp)
                     != srp.hash_buckets(feat, w, cfg.srp)).sum())
        wrong_ids += wrong
        total_ids += cfg.srp.num_tables
        plain, anom_p, score_p = mon.step_features(
            tree_map(torch.clone, state), w, feat, kernels=False)
        is_armed = float(state.warmup_left) <= 0.0
        state, anom_k, score_k = mon.step_features(state, w, feat,
                                                   kernels=True)
        differ, n_eq, w_rel = sketch_agreement(state.ace, plain.ace)
        if is_armed:
            armed[bool(anom_k)] += 1
        if wrong:
            ok = differ <= 2 * wrong
        else:
            ok = (bool(anom_k) == bool(anom_p) and differ == 0 and n_eq
                  and w_rel <= 1e-5
                  and abs(float(score_k) - float(score_p))
                  <= 1e-6 * abs(float(score_p))
                  and all(torch.equal(getattr(state, f), getattr(plain, f))
                          for f in ("anomalies", "consecutive",
                                    "warmup_left")))
        if not ok:
            faults.append((t, wrong, differ, bool(anom_k), bool(anom_p),
                           n_eq, w_rel))
    agree = 1 - wrong_ids / total_ids
    print(f"  monitor, kernel path against plain path on the card from one "
          f"state a step, {len(rows)} steps of (1, {cfg.dim}) features "
          f"(the card run's, twice, then a spike): ids agree {agree:.6f}; "
          f"armed verdicts {armed[True]} flagged, {armed[False]} inserted; "
          f"steps disagreeing {faults[:4]} ({card})")
    check(agree >= 0.999 and not faults,
          "monitor kernel path = plain path a step: verdict, score, counts, "
          "n, Welford (rtol 1e-5) where the ids agree")
    check(armed[True] > 0 and armed[False] > 0,
          "monitor lockstep: once armed it both flags and inserts")
    return {"steps": len(rows), "ids_agree": agree,
            "armed_flagged": armed[True], "armed_inserted": armed[False]}


def filter_lockstep(filt, w, feats, card) -> dict:
    """The data filter's kernel path (``ace_admit_fused`` + its
    ``ace_query_sum``) against ``use_kernels=False`` on the card, step by
    step from one state over the (B, d + 1) batches ``feats``, past the
    filter's warmup: keep and margin equal on rows whose ids agree; where
    every id of a step agrees, counts, n, Welford (rtol 1e-5) and the
    histogram equal; else at most 2 counters differ per differing id."""
    from repro_torch.core import srp
    from repro_torch.kernels import ops as kops
    from repro_torch.models.registry import tree_map
    plain_f = dataclasses.replace(filt, use_kernels=False)
    cfg = filt.ace_cfg
    state, _ = filt.init()
    wrong_ids = total_ids = armed_rows = flagged = 0
    faults = []
    for t, feat in enumerate(feats):
        row_ok = torch.all(kops.srp_hash(feat, w, cfg.srp)
                           == srp.hash_buckets(feat, w, cfg.srp), dim=-1)
        wrong = int((~row_ok).sum()) * cfg.srp.num_tables
        wrong_ids += wrong
        total_ids += feat.shape[0] * cfg.srp.num_tables
        plain, keep_p, margin_p = plain_f.step(tree_map(torch.clone, state),
                                               w, feat)
        state, keep_k, margin_k = filt.step(state, w, feat)
        differ, n_eq, w_rel = sketch_agreement(state, plain)
        armed = bool(torch.all(torch.isfinite(margin_k)))
        if armed:
            armed_rows += feat.shape[0]
            flagged += int((~keep_k).sum())
        same_rows = bool(torch.equal(keep_k[row_ok], keep_p[row_ok])
                         and torch.allclose(margin_k[row_ok],
                                            margin_p[row_ok], rtol=1e-6,
                                            atol=0))
        if wrong:
            ok = same_rows and differ <= 2 * wrong
        else:
            ok = (same_rows and differ == 0 and n_eq and w_rel <= 1e-5
                  and (state.qhist is None
                       or torch.equal(state.qhist, plain.qhist)))
        if not ok:
            faults.append((t, wrong, differ, n_eq, w_rel))
    agree = 1 - wrong_ids / total_ids
    print(f"  filter {filt.threshold_mode}, kernel path against "
          f"use_kernels=False on the card from one state a step, "
          f"{len(feats)} steps of {tuple(feats[0].shape)}: ids agree "
          f"{agree:.6f}; armed on {armed_rows} rows, flagged {flagged}; "
          f"steps disagreeing {faults[:4]} ({card})")
    check(agree >= 0.999 and not faults and armed_rows > 0,
          f"filter {filt.threshold_mode} kernel path = plain path a step "
          "past warmup: keep and margin where the ids agree; counts, n, "
          "Welford (rtol 1e-5), histogram")
    return {"steps": len(feats), "ids_agree": agree,
            "armed_rows": armed_rows, "flagged": flagged}


def reduced_card_vs_cpu(device, card) -> dict:
    """(b): reduced olmo_1b in float32 (TF32 off), filter, monitor and
    compression on, REDUCED_STEPS steps on the card and on the CPU from
    one set of weights and one noise draw; then ARMED_STEPS more of each,
    past the monitor's 20-step warmup: verdicts and the monitor's sketch
    card against CPU.  Then the monitor's and the filter's kernel paths
    against their plain paths on the card on the same inputs, past their
    warmups: the monitor on the card run's features, the filter on
    LOCKSTEP_BATCHES batches of sequence embeddings."""
    from repro_torch.data.pipeline import DataStream, StreamConfig
    from repro_torch.models import Arch
    from repro_torch.models.registry import leaves
    from repro_torch.train.fault import GradMonitor
    from repro_torch.train.train_loop import (init_train_state,
                                              make_data_filter,
                                              sequence_embeddings, train)
    arch = Arch("olmo_1b", reduced=True)
    kw = dict(grad_compression=True, peak_lr=1e-3, total_steps=16)
    cpu_cfg = train_config(device="cpu", **kw)
    cpu_state = init_train_state(arch, cpu_cfg)
    card_state = move_state(cpu_state, device)
    scfg = StreamConfig(vocab_size=arch.cfg.vocab_size, seq_len=REDUCED_S,
                        global_batch=REDUCED_B, seed=SEED)
    streams = [DataStream(scfg), DataStream(scfg)]
    feats: list = []

    def both(card_state, cpu_state, steps):
        tape: list = []
        with recorded_noise(tape, replay=False), \
                recorded_outputs(GradMonitor, "features", feats):
            card_state, card_hist = train(arch, train_config(**kw),
                                          streams[0], steps, log_every=0,
                                          state=card_state)
        tape[:] = [t.cpu() for t in tape]
        with recorded_noise(tape, replay=True):
            cpu_state, cpu_hist = train(arch, cpu_cfg, streams[1], steps,
                                        log_every=0, state=cpu_state)
        return card_state, card_hist, cpu_state, cpu_hist, len(tape)

    def counters_differ(a, b):
        touched = (a.counts.cpu() != 0) | (b.counts != 0)
        return int((a.counts.cpu() != b.counts).sum()), int(touched.sum())

    card_state, card_hist, cpu_state, cpu_hist, draws = both(
        card_state, cpu_state, REDUCED_STEPS)
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(card_hist, cpu_hist))
    same = all(a[k] == b[k] for a, b in zip(card_hist, cpu_hist)
               for k in ("filter_keep_frac", "grad_anomaly"))
    diffs = np.concatenate([(a.cpu() - b).abs().reshape(-1).numpy()
                            for a, b in zip(leaves(card_state.params),
                                            leaves(cpu_state.params))])
    lr_sum = sum(h["lr"] for h in cpu_hist)
    differ, touched = counters_differ(card_state.filter_state,
                                      cpu_state.filter_state)
    out = {"loss_rel_err": loss_err, "param_max_abs": float(diffs.max()),
           "param_share_within_1e-6": float(np.mean(diffs <= 1e-6)),
           "noise_draws": draws, "filter_counters_differ": differ}
    print(f"  reduced olmo_1b float32, filter + monitor + compression, "
          f"{REDUCED_STEPS} steps card vs CPU, eager on the card "
          f"(capture.disabled(): a replay would not call the noise "
          f"recorder) ({draws} noise tensors "
          f"drawn on the card, replayed on the CPU): loss rel err "
          f"{loss_err:.3g}, params max abs {diffs.max():.3g} "
          f"({out['param_share_within_1e-6']:.6f} within 1e-6), filter "
          f"counters differing {differ} of {touched} touched ({card})")
    check(loss_err <= 1e-5, "losses card vs CPU within rtol 1e-5 (float32 "
          "sums in another order)")
    check(same, "filter keep fractions and monitor verdicts equal card "
          "vs CPU (both in warmup)")
    check(diffs.max() <= lr_sum and out["param_share_within_1e-6"] >= 0.999,
          f"params card vs CPU: every one within the summed lr "
          f"{lr_sum:.3g} (AdamW's update is ~1 where |g| ~ eps, and an int8 "
          "rounding at a .5 tie moves a gradient by one scale), 99.9% "
          "within 1e-6")
    check(differ <= max(2, int(0.002 * touched)),
          "filter counts card vs CPU: dense ids agree >= 0.999, so <= 0.2% "
          "of touched counters differ")
    card_state, card_hist, cpu_state, cpu_hist, _ = both(
        card_state, cpu_state, ARMED_STEPS)
    flags = [[h["grad_anomaly"] for h in x] for x in (card_hist, cpu_hist)]
    agree = [a == b for a, b in zip(*flags)]
    mon_differ, mon_touched = counters_differ(card_state.monitor.ace,
                                              cpu_state.monitor.ace)
    _, n_eq, w_rel = sketch_agreement(card_state.monitor.ace,
                                      cpu_state.monitor.ace)
    out.update(armed_verdicts_agree=sum(agree),
               armed_flags=[sum(f) for f in flags],
               monitor_counters_differ=mon_differ, monitor_n_equal=n_eq,
               monitor_welford_rel=w_rel)
    print(f"  then {ARMED_STEPS} more steps past the monitor's warmup: "
          f"verdicts agree on {sum(agree)} of {ARMED_STEPS} steps, flagged "
          f"{out['armed_flags'][0]:.0f} on the card and "
          f"{out['armed_flags'][1]:.0f} on the CPU; the monitor's sketch: "
          f"counters differing {mon_differ} of {mon_touched} touched, n "
          f"{'equal' if n_eq else 'differs'}, Welford rel diff {w_rel:.3g}; "
          f"losses {card_hist[-1]['loss']:.4f} and "
          f"{cpu_hist[-1]['loss']:.4f} ({card})")
    check(all(agree), "armed monitor verdicts equal card vs CPU on every "
          "step")
    check(mon_differ <= max(2, int(0.002 * mon_touched)) and n_eq
          and w_rel <= 1e-5,
          "monitor sketch card vs CPU after the armed steps: <= 0.2% of "
          "touched counters differ, n exact, Welford within rtol 1e-5")

    mon = GradMonitor(feature_dim=cpu_cfg.monitor_feature_dim,
                      device=device)
    rows = [f[None] for f in feats]
    spike = rows[-1].clone()
    spike[0, :-2] += 3.0            # every leaf's log-norm up 3: e^3 larger
    out["monitor_lockstep"] = monitor_lockstep(
        mon, card_state.monitor_w, rows + rows + [spike], card)
    embed_stream = DataStream(scfg)
    batches = []
    with torch.no_grad():
        for _ in range(LOCKSTEP_BATCHES):
            tokens = torch.from_numpy(next(embed_stream)["tokens"])
            batches.append(sequence_embeddings(
                card_state.params, {"tokens": tokens.to(device)}, arch.cfg))
    for mode in ("mu_sigma", "quantile"):
        filt = make_data_filter(
            train_config(filter_threshold_mode=mode,
                         filter_quantile_q=POISON_Q), arch.cfg.d_model)
        out[f"filter_lockstep_{mode}"] = filter_lockstep(
            filt, card_state.filter_w, [filt.features(e) for e in batches],
            card)
    check(out["filter_lockstep_quantile"]["flagged"] > 0,
          "filter lockstep, quantile mode: rows flagged once armed")
    return out


def restart_on_card(device, card, what, **kw) -> None:
    """(b): an interrupted run restored from its checkpoint equals the
    uninterrupted one on the card (the reference's restart tests)."""
    import shutil
    from repro_torch.data.pipeline import DataStream, StreamConfig
    from repro_torch.models import Arch
    from repro_torch.models.registry import leaves
    from repro_torch.train.train_loop import train
    arch = Arch("olmo_1b", reduced=True)
    scfg = StreamConfig(vocab_size=arch.cfg.vocab_size, seq_len=REDUCED_S,
                        global_batch=REDUCED_B, seed=SEED)
    dirs = [TRAIN_CKPT / f"{what}_{x}" for x in "ab"]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    chunked = kw.get("filter_chunk", 0) > 1
    first = 5 if chunked else 6
    ta = train_config(ckpt_dir=str(dirs[0]),
                      ckpt_interval=2 if chunked else 4, peak_lr=1e-3,
                      grad_compression=True, **kw)
    tb = dataclasses.replace(ta, ckpt_dir=str(dirs[1]))
    sa, _ = train(arch, ta, DataStream(scfg), 8, log_every=0)
    train(arch, tb, DataStream(scfg), first, log_every=0)
    sc, _ = train(arch, tb, DataStream(scfg), 4, log_every=0)
    err = max(float((x - y).abs().max()) for x, y in
              zip(leaves(sa.params), leaves(sc.params)))
    sketches = all(torch.equal(x, y) for f in ("filter_state", "monitor",
                                                "ef")
                   for x, y in zip(leaves(getattr(sa, f)),
                                   leaves(getattr(sc, f))))
    check(int(sc.step) == 8 and err <= 1e-6 and sketches
          and torch.equal(sa.rng.get_state(), sc.rng.get_state()),
          f"{what}: 8 steps equal {first} + 4 restored from step 4 on the "
          f"card (params max abs {err:.3g}; filter, monitor, residual and "
          f"generator state bitwise) ({card})")
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def recurrence_backward(device, card, name) -> dict:
    """(c): one recurrent mixer at full width in float32 (time_chunk
    RECUR_CHUNK), loss = mean(out · probe): the output, the loss and
    every gradient on the card against the CPU; forward + backward ms and
    peak memory, beside the in-place inference loop's forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba as mb
    from repro_torch.models import rwkv6 as rw
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 30)
    if name.startswith("jamba"):
        p = mb.init_mamba(cfg, gen, cpu)

        def scan(q, x):
            return mb.mamba_scan(q, x, cfg, time_chunk=RECUR_CHUNK)[0]
    else:
        p = rw.init_rwkv_time(cfg, gen, cpu)
        p["wo"] = torch.randn(p["wo"].shape, generator=gen) \
            / p["wo"].shape[0] ** 0.5         # zero at init: redrawn

        def scan(q, x):
            st = rw.init_rwkv_state(cfg, x.shape[0], x.dtype, x.device)
            return rw.rwkv_time_scan(q, x, st.x_prev_att, st.wkv, cfg,
                                     time_chunk=RECUR_CHUNK)[0]
    x = torch.randn((RECUR_B, RECUR_S, cfg.d_model), generator=gen)
    probe = torch.randn((RECUR_B, RECUR_S, cfg.d_model), generator=gen)

    def fwd_bwd(dev):
        q = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        xx = x.to(dev).requires_grad_()
        out = scan(q, xx)
        loss = torch.mean(out * probe.to(dev))
        return out.detach(), loss.detach(), \
            torch.autograd.grad(loss, [xx, *q.values()])

    def timed(fn):
        times = []
        for _ in range(4):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times[1:])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, loss, grads = fwd_bwd(device)
    peak = torch.cuda.max_memory_allocated()
    ms = timed(lambda: fwd_bwd(device))
    with torch.no_grad():
        qd = {k: v.to(device) for k, v in p.items()}
        xd = x.to(device)
        inf_ms = timed(lambda: scan(qd, xd))
    c_out, c_loss, c_grads = fwd_bwd(cpu)
    # the loss, a mean of products of either sign, cancels: its error is
    # read against the mean magnitude of those products
    loss_err = abs(float(loss) - float(c_loss)) \
        / float(torch.mean(torch.abs(c_out * probe)))
    out_err = float((out.cpu() - c_out).abs().max() / c_out.abs().max())
    rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
              for a, b in zip(grads, c_grads))
    kind = "Mamba mixer" if name.startswith("jamba") else "RWKV-6 time mix"
    print(f"  {name} {kind} at full width (d_model {cfg.d_model}), B "
          f"{RECUR_B} x S {RECUR_S}, time_chunk {RECUR_CHUNK}, float32: "
          f"forward + backward {ms:.3f} ms (median of 3), peak memory "
          f"{peak / 2**30:.2f} GiB; the in-place inference loop's forward "
          f"{inf_ms:.3f} ms; card vs CPU: output max abs err / max "
          f"{out_err:.3g}, loss err / mean |out · probe| {loss_err:.3g}, "
          f"gradients max abs err / leaf max {rel:.3g} ({card})")
    check(max(out_err, loss_err, rel) <= 2e-4,
          f"{name}: output, loss and gradients card vs CPU within 2e-4 "
          "(the zoo's float32 bound)")
    return {"fwd_bwd_ms": ms, "inference_fwd_ms": inf_ms, "peak": peak,
            "out_err": out_err, "loss_err": loss_err, "grad_rel_err": rel}


def poison(mods, device, card) -> dict:
    """(d): the monitor as the reference's test_monitor_skips_poisoned_step
    drives it (30 healthy steps, then zeros with every label the last
    token), then the filter on a corrupt_every=13 stream in both
    threshold modes."""
    from repro_torch.core import capture
    from repro_torch.data.pipeline import DataStream, StreamConfig, \
        synth_batch
    from repro_torch.models import Arch
    from repro_torch.models.registry import leaves
    from repro_torch.train import train_loop as tl
    arch = Arch("olmo_1b", reduced=True)
    tcfg = train_config(use_data_filter=False, peak_lr=1e-3,
                        total_steps=100, seed=1)
    step_fn = capture.Program(tl.make_train_step(arch, tcfg), device,
                              name="train.step", donate=True)
    state = tl.init_train_state(arch, tcfg, 1)
    stream = DataStream(StreamConfig(vocab_size=arch.cfg.vocab_size,
                                     seq_len=REDUCED_S,
                                     global_batch=REDUCED_B, seed=1))
    for _ in range(30):
        state, _ = step_fn(state, tl._to_device(
            {k: v for k, v in next(stream).items()
             if not k.startswith("_")}, device))
    before = [t.clone() for t in leaves((state.params, state.opt_state))]
    bad = {k: v for k, v in next(stream).items() if not k.startswith("_")}
    bad["tokens"] = np.zeros_like(bad["tokens"])
    bad["labels"] = np.full_like(bad["labels"], arch.cfg.vocab_size - 1)
    state, m = step_fn(state, tl._to_device(bad, device))
    kept = all(torch.equal(a, b) for a, b in
               zip(before, leaves((state.params, state.opt_state))))
    check(float(m["grad_anomaly"]) == 1.0 and kept
          and step_fn.trace_count == 1,
          "the monitor skips the poisoned step once armed (one captured "
          "step program): flagged, params and optimiser state unchanged "
          f"({card})")
    out = {}
    scfg = StreamConfig(vocab_size=arch.cfg.vocab_size, seq_len=REDUCED_S,
                        global_batch=POISON_B, seed=1,
                        corrupt_every=POISON_EVERY)
    armed = 512 // POISON_B                # the filter's warmup_items
    poisoned = {i for i in range(POISON_STEPS)
                if "_poisoned" in synth_batch(scfg, i)}
    for mode in ("quantile", "mu_sigma"):
        tc = train_config(peak_lr=1e-3, total_steps=200, seed=1,
                          filter_threshold_mode=mode,
                          filter_quantile_q=POISON_Q)
        _, res = run_train(mods, device, card, f"poison, filter {mode}",
                           arch, tc, None, DataStream(scfg), POISON_STEPS,
                           POISON_B * REDUCED_S)
        hist = res.pop("hist")
        bad = [hist[i] for i in sorted(poisoned) if i >= armed]
        good = [h for i, h in enumerate(hist)
                if i >= armed and i not in poisoned]
        res["keep_poisoned"] = statistics.mean(h["filter_keep_frac"]
                                               for h in bad)
        res["keep_clean"] = statistics.mean(h["filter_keep_frac"]
                                            for h in good)
        res["flagged_poisoned"] = sum(h["grad_anomaly"] for h in bad)
        res["flagged_clean"] = sum(h["grad_anomaly"] for h in good)
        print(f"  poison, filter {mode}: after the filter arms (step "
              f"{armed}), keep {res['keep_poisoned']:.4f} on {len(bad)} "
              f"poisoned batches against {res['keep_clean']:.4f} on "
              f"{len(good)} clean ones; monitor flagged "
              f"{res['flagged_poisoned']:.0f} poisoned, "
              f"{res['flagged_clean']:.0f} clean steps ({card})")
        out[f"poison_{mode}"] = res
    q = out["poison_quantile"]
    check(q["keep_poisoned"] < q["keep_clean"],
          f"the filter's keep fraction drops on poisoned batches (quantile "
          f"q = {POISON_Q}: {q['keep_poisoned']:.4f} < "
          f"{q['keep_clean']:.4f})")
    return out


def phase_train(mods, device, card) -> dict:
    """Phase 17 (the module docstring)."""
    from repro_torch.core import capture
    from repro_torch.data.pipeline import DataStream, StreamConfig
    from repro_torch.models import Arch
    from repro_torch.models.registry import leaves
    from repro_torch.train.train_loop import init_train_state, train
    out = {}
    torch.cuda.empty_cache()
    arch = Arch("olmo_1b")
    tcfg = train_config(microbatches=2)
    t0 = time.perf_counter()
    state = init_train_state(arch, tcfg)
    sync(device)
    n = sum(t.numel() for t in leaves(state.params))
    print(f"  olmo_1b at full size: {n:,} float32 parameters and AdamW "
          f"moments drawn in {time.perf_counter() - t0:.2f} s ({card})")
    stream = DataStream(StreamConfig(vocab_size=arch.cfg.vocab_size,
                                     seq_len=TRAIN_S, global_batch=TRAIN_B,
                                     seed=SEED))
    state, _ = train(arch, tcfg, stream, 1, log_every=0, state=state)
    tokens = TRAIN_B * TRAIN_S
    for key, what, tc in (
            ("train_olmo_microbatches",
             "olmo_1b, 2 microbatches, in-step filter", tcfg),
            ("train_olmo_chunked",
             f"olmo_1b, chunked prefilter T = {TRAIN_CHUNK}",
             train_config(filter_chunk=TRAIN_CHUNK))):
        state, out[key], out[f"{key}_eager"], out[f"{key}_differ"] = \
            train_twins(mods, device, card, what, arch, tc, state, stream,
                        tokens)
    state, out["breakdown"] = step_breakdown(arch, train_config(), state,
                                             stream, device, card)
    state, out["captured_step"] = captured_step(arch, train_config(), state,
                                                stream, device, card)
    eager, got = out["breakdown"]["wall_ms"], out["captured_step"]["wall_ms"]
    print(f"  olmo_1b plain-loop step: captured {got:.3f} ms against eager "
          f"{eager:.3f} ms ({eager / got:.3f}x) ({card})")
    del state
    torch.cuda.empty_cache()

    # eager: a captured step's replay would not call the noise recorder
    with capture.disabled():
        out["card_vs_cpu"] = reduced_card_vs_cpu(device, card)
    restart_on_card(device, card, "restart, plain loop")
    restart_on_card(device, card, "restart, chunked prefilter",
                    filter_chunk=2)
    for name in ("jamba_v01_52b", "rwkv6_7b"):
        out[f"backward_{name}"] = recurrence_backward(device, card, name)
    out.update(poison(mods, device, card))
    return out


# ---------------------------------------------------------------------------
# Phases 2 and 8, operand dtypes: the six hash kernels on bfloat16 and
# float16 x and W, against their plain versions (which widen both operands
# to float32, as the kernels and the reference's Pallas kernels do).
# ---------------------------------------------------------------------------

OPERAND_KERNELS = ("srp_hash", "srht_hash", "ace_admit_fused",
                   "ace_score_fused", "ace_fleet_score",
                   "ace_fleet_window_admit")
OPERAND_DTYPES = ("bfloat16", "float16")


def dense_hash_shapes(d_model=D_MODEL, fit_batch=FIT_BATCH,
                      admit_b=ADMIT_B):
    """(where, B, d, K, L) of the dense hash's three main-path shapes."""
    return (("fit", fit_batch, KDD_D, K_BITS, L_TABLES),
            ("admit", admit_b, d_model + 1, K_BITS, L_TABLES),
            ("stream step", STREAM_B, d_model + 1, STREAM_K, STREAM_L))


def srht_shapes(d_model=D_MODEL, fit_batch=FIT_BATCH):
    """(where, B, d, K, L) of ``srht_hash``'s three main-path shapes."""
    return (("stream step", STREAM_B, d_model + 1, STREAM_K, STREAM_L),
            ("fit", fit_batch, KDD_D, K_BITS, L_TABLES),
            ("auto corner", AUTO_B, AUTO_DIMS[0], K_BITS, L_TABLES))


def operands(B, d, K, L, dtype, device, seed, srht=False):
    """(cfg, x, W) in float32 and the same rounded to ``dtype``."""
    from repro_torch.core.srp import SrpConfig, make_projections
    cfg = SrpConfig(dim=d, num_bits=K, num_tables=L, seed=seed,
                    hash_mode="srht" if srht else "dense")
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, d), generator=gen, device=device)
    w = make_projections(cfg, device=device)
    nd = getattr(torch, dtype)
    return cfg, (x, w), (x.to(nd), w.to(nd))


def fused_cases(mods, device, cfg, B: int):
    """The four fused hash kernels on (B, d) queries under ``cfg``, over
    random counters: a flat table, a fleet of ``FLEET_T`` tenants, a
    4-epoch ring of them with integer tails, thresholds of L (some rows
    admit, some not).  Returns ({name: run(q, w) -> outputs}, {name:
    bytes the call moves beside q and W, as a function of the ids})."""
    a, f = mods["ace_admit_fused"], mods["ace_score_fused"]
    fs, fwa = mods["ace_fleet_score"], mods["ace_fleet_window_admit"]
    T, E, L, nb = FLEET_T, 4, cfg.num_tables, cfg.num_buckets
    gen = torch.Generator(device=device).manual_seed(SEED + 54)

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)
    counts, fleet = ints((L, nb), 9), ints((T, L, nb), 9)
    ring, tail = ints((T, E, L, nb), 9), ints((T, L, nb), 20).float()
    cursor, tids = ints((T,), E), ints((B,), T)
    thr = torch.full((T,), float(L), device=device)
    t1 = torch.tensor(float(L), device=device)
    rows = torch.arange(L, device=device)[None, :]

    def fleet_u(ids):       # distinct (tenant, table, bucket) counters
        return int(torch.unique((tids.long()[:, None] * L + rows) * nb
                                + ids.long()).numel())
    runs = {       # fresh=False: update the counters in place (timing)
        "ace_admit_fused": lambda q, v, fresh=True: a.ace_admit_fused(
            counts.clone() if fresh else counts, q, v, t1, cfg),
        "ace_score_fused": lambda q, v, fresh=True: f.ace_score_fused_planned(
            counts, q, v, cfg, None, None, with_ids=True),
        "ace_fleet_score": lambda q, v, fresh=True: fs.ace_fleet_score_planned(
            fleet, q, tids, v, cfg, None, with_ids=True),
        "ace_fleet_window_admit": lambda q, v, fresh=True:
            fwa.ace_fleet_window_admit_fused(ring.clone() if fresh else ring,
                                             tail, cursor, q, tids, v, thr,
                                             cfg)}
    # counters gathered (read once) and inserted (read and written), the
    # outputs, the tenant ids, thresholds and cursors
    moved = {
        "ace_admit_fused": lambda ids: 4 * distinct_counters(ids, nb)
        + 2 * 4 * distinct_counters(ids, nb) + 4 * B * L + 5 * B + 4,
        "ace_score_fused": lambda ids: 4 * distinct_counters(ids, nb)
        + 4 * B,
        "ace_fleet_score": lambda ids: 4 * fleet_u(ids) + 8 * B,
        "ace_fleet_window_admit": lambda ids: (4 + 4 + 2 * 4) * fleet_u(ids)
        + 4 * B * L + 17 * B + 8 * T}
    return runs, moved


def admit_from_ids(counts, ids, thresh, mask=None):
    """The plain path of a flat admission downstream of one set of ids:
    (counts after the masked insert, PRE-insert scores, verdicts)."""
    L = counts.shape[0]
    rows = torch.arange(L, device=counts.device)[None, :]
    scores = counts[rows, ids.long()].float().sum(-1) \
        * torch.tensor(1.0 / L, dtype=torch.float32)
    admit = scores >= thresh
    if mask is not None:
        admit &= mask
    after = counts.clone().index_put_(
        (rows, ids.long()), admit.to(counts.dtype)[:, None].expand_as(ids),
        accumulate=True)
    return after, scores, admit


def tensor_core_checks(mods, what, cfg, nx, nw, counts,
                       mask=None) -> tuple:
    """``srp_hash`` and ``ace_admit_fused`` on a same-type 2-byte pair,
    which they run on the tensor-core tile: ids >= 0.999 against the plain
    version, two launches of each bitwise equal, the admission's ids
    ``srp_hash``'s and its counts, scores and verdicts bitwise the plain
    path's downstream of them, at the median pre-insert score as the
    threshold (about half the rows insert); the widening tile asked for
    by name bitwise the float32 kernel on the widened operands.  Returns
    (ids, max |ids - plain|, the admission's largest output difference
    from that plain path, the threshold)."""
    h, a = mods["srp_hash"], mods["ace_admit_fused"]
    ids, again = h.srp_hash(nx, nw, cfg), h.srp_hash(nx, nw, cfg)
    thresh = torch.median(admit_from_ids(counts, ids, float("-inf"))[1])
    plain = h.srp_hash_plain(nx, nw, cfg)
    share = agreement(ids, plain)
    wide = h.srp_hash_planned(nx, nw, cfg, None, "widening")
    check(share >= 0.999 and torch.equal(ids, again) and torch.equal(
        wide, h.srp_hash(nx.float(), nw.float(), cfg)),
        f"srp_hash {what}: tensor-core ids agree with plain {share:.6f} >= "
        "0.999, two launches bitwise equal; the widening tile bitwise the "
        f"float32 kernel's on the widened operands (agree with the "
        f"tensor-core tile {agreement(ids, wide):.6f})")
    got = a.ace_admit_fused(counts.clone(), nx, nw, thresh, cfg,
                            item_mask=mask)
    twice = a.ace_admit_fused(counts.clone(), nx, nw, thresh, cfg,
                              item_mask=mask)
    want = admit_from_ids(counts, got[3], thresh, mask)
    check(torch.equal(got[3], ids) and all(
        torch.equal(u, v) for u, v in zip(got, twice)) and all(
        torch.equal(u, v) for u, v in zip(got[:3], want)),
        f"ace_admit_fused {what}: ids srp_hash's, two launches bitwise "
        "equal, counts, scores and verdicts bitwise the plain path's "
        f"downstream of them ({int(got[2].sum())} of {nx.shape[0]} "
        "admitted)")
    return ids, max_err(ids, plain), max(max_err(u, v) for u, v in zip(
        got[:3], want)), thresh


def phase_kernels_operands(mods, device, d_model=D_MODEL,
                           fit_batch=FIT_BATCH, admit_b=ADMIT_B) -> dict:
    """Phase 2 on narrow operands: x and W both bfloat16, then both
    float16.  ``srp_hash`` and ``ace_admit_fused`` run such a pair on the
    tensor-core tile: at the three main-path shapes, ``tensor_core_checks``
    (ids >= 0.999 against the plain version, two launches bitwise equal,
    the admission bitwise the plain path downstream of its ids, the
    widening tile bitwise the float32 kernel on the widened operands);
    ``srht_hash`` at its three: ids bitwise the plain version's; the
    other three fused hash kernels (the widening tile) at the admit shape
    (T = 8 tenants, a 4-epoch ring): their ids the widening tile's, and
    every output bitwise the same kernel's on the operands widened to
    float32 (which phase 2 holds against the plain versions).
    Returns {kernel: {dtype: max_abs_err of the ids}}."""
    h, sh = mods["srp_hash"], mods["srht_hash"]
    err = {k: {} for k in OPERAND_KERNELS}
    for dt in OPERAND_DTYPES:
        e = ea = 0.0
        for where, B, d, K, L in dense_hash_shapes(d_model, fit_batch,
                                                   admit_b):
            cfg, _, (nx, nw) = operands(B, d, K, L, dt, device, 51)
            counts = torch.randint(0, 9, (L, cfg.num_buckets),
                                   dtype=torch.int32, device=device)
            mask = torch.arange(B, device=device) % 7 != 0
            _, eh, _, _ = tensor_core_checks(
                mods, f"{dt} {where} B={B}, d={d}", cfg, nx, nw, counts,
                mask)
            e, ea = max(e, eh), max(ea, eh)
        err["srp_hash"][dt] = e
        err["ace_admit_fused"][dt] = ea
        e = 0.0
        for where, B, d, K, L in srht_shapes(d_model, fit_batch):
            cfg, (x, _), (nx, _) = operands(B, d, K, L, dt, device, 52,
                                            srht=True)
            got = sh.srht_hash(nx, cfg)
            plain = sh.srht_hash_plain(nx, cfg)
            e = max(e, max_err(got, plain))
            check(torch.equal(got, plain) and torch.equal(
                got, sh.srht_hash(nx.float(), cfg)),
                f"srht_hash {dt} {where} B={B}, d={d}: ids bitwise plain "
                "and the kernel's on the widened x")
        err["srht_hash"][dt] = e

        B, d, K, L = admit_b, d_model + 1, K_BITS, L_TABLES
        cfg, _, (nx, nw) = operands(B, d, K, L, dt, device, 53)
        wx, ww = nx.float(), nw.float()       # the widened operands
        ids = h.srp_hash_planned(nx, nw, cfg, None, "widening")
        plain_ids = h.srp_hash_plain(nx, nw, cfg)
        runs = fused_cases(mods, device, cfg, B)[0]
        for name, run in runs.items():
            if name == "ace_admit_fused":     # on the tensor-core tile
                continue
            got, wide = run(nx, nw), run(wx, ww)
            kid = got[3] if len(got) > 2 else got[1]
            err[name][dt] = max_err(kid, plain_ids)
            check(torch.equal(kid, ids) and all(
                torch.equal(u, v) for u, v in zip(got, wide)),
                f"{name} {dt} admit shape B={B}, d={d}: ids the widening "
                f"tile's (plain ids agree {agreement(ids, plain_ids):.6f}), "
                "every output the kernel's on the widened operands")
    for k in OPERAND_KERNELS:
        print(f"  {k}: max |ids - plain| " + ", ".join(
            f"{dt} {err[k][dt]:g}" for dt in OPERAND_DTYPES))
    return err


def narrow_admit_path(mods, device, d_model=D_MODEL,
                      admit_b=ADMIT_B, pair=False) -> dict:
    """One ``ops.ace_admit`` on a bfloat16 W at the flat guardrail's shape
    (armed sketch), counts set to 0 just before it: it launched the fused
    admission once, and its outputs equal the same admission on W widened
    to float32.  With ``pair`` the queries are bfloat16 too, a pair the
    admission runs on the tensor-core tile, and the twin's are widened as
    well: outputs bitwise where the two tiles' ids agree on every row (the
    ids are held to >= 0.999 either way)."""
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import ops
    cfg = sk.AceConfig(dim=d_model + 1, num_bits=K_BITS,
                       num_tables=L_TABLES, seed=55)
    w = sk.make_params(cfg, device=device, dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(SEED + 55)
    state = sk.init(cfg, device)
    for _ in range(4):                      # arm it: n past the warmup
        q = torch.randn((admit_b, d_model + 1), generator=gen,
                        device=device)
        state, _ = ops.ace_admit(state, q, w.float(), cfg, alpha=4.0,
                                 warmup_items=2.0 * admit_b)
    q = torch.randn((admit_b, d_model + 1), generator=gen, device=device)
    if pair:
        q = q.to(torch.bfloat16)
    twin = sk.AceState(*(v if v is None or not torch.is_tensor(v)
                         else v.clone() for v in state))
    reset_launches(mods)
    got, admit = ops.ace_admit(state, q, w, cfg, alpha=4.0,
                               warmup_items=2.0 * admit_b)
    sync(device)
    launches = read_launches(mods)
    want, wadmit = ops.ace_admit(twin, q.float(), w.float(), cfg, alpha=4.0,
                                 warmup_items=2.0 * admit_b)
    what = "bfloat16 q and W" if pair else "a bfloat16 W"
    check(launches["ace_admit_fused"] == 1, f"ops.ace_admit on {what} "
          "launched ace_admit_fused once")
    h, scfg = mods["srp_hash"], cfg.srp
    ids, wide = h.srp_hash(q, w, scfg), h.srp_hash(q.float(), w.float(),
                                                   scfg)
    share = agreement(ids, wide)
    same = torch.equal(admit, wadmit) and all(
        torch.equal(u, v) for u, v in zip(got, want) if torch.is_tensor(u))
    check(share >= 0.999 and (same or not torch.equal(ids, wide)),
          f"ops.ace_admit on {what} equals it on the operands widened to "
          f"float32 ({int(admit.sum())} of {admit_b} admitted; the two "
          f"tiles' ids agree {share:.6f})")
    return {"launches": launches, "dtype": "bfloat16"}


def time_in_turns(**fns) -> tuple:
    """Device ms of each function, in turns (the order given, then
    reversed: float32, narrow, widened, widened, narrow, float32):
    ({name: mean ms}, {name: every sample})."""
    runs = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        runs[k].append(device_ms(fns[k], reps=10))
    return {k: statistics.mean(v) for k, v in runs.items()}, runs


def phase_timing_operands(mods, device, d_model=D_MODEL) -> dict:
    """Phase 8 on narrow operands.  ``srp_hash`` and ``ace_admit_fused``
    at their three main-path shapes on the tensor-core tile, each held to
    ``tensor_core_checks`` first, then each dtype in turns with the
    widening tile on the same operands (``widening_ms``) and with the
    float32 kernel on the float32 operands (``float32_ms``); their bound
    the products at the card's bf16/fp16 tensor-core rate (a 2-byte
    product accumulated in fp32 is exact) against the bytes with x and W
    at two bytes an element, beside cuBLAS's projection on the same
    narrow operands (``matmul_ms``).  ``srht_hash`` at its three shapes
    and the other three fused hash kernels at the admit shape, in turns
    with float32 and (the fused ones) with the same kernel on operands
    widened on the card first (``x.float()``, ``w.float()``, the casts
    included: ``widen_ms``); the SRHT's bound its fp32 adds against a
    2-byte x.  Returns {kernel: {dtype: entry}} (with ``by_shape`` for
    the two hashes and the admission)."""
    h, sh, a = mods["srp_hash"], mods["srht_hash"], mods["ace_admit_fused"]
    out = {"srp_hash": {}, "srht_hash": {}, "ace_admit_fused": {}}
    for dt in OPERAND_DTYPES:
        rows, arows = [], []
        for where, B, d, K, L in dense_hash_shapes(d_model):
            cfg, (x, w), (nx, nw) = operands(B, d, K, L, dt, device, 56)
            KL, nb = cfg.num_projections, cfg.num_buckets
            shape = f"{where} B={B}, d={d}, K={K}, L={L}"
            counts = torch.randint(0, 9, (L, nb), dtype=torch.int32,
                                   device=device)
            ids, _, _, t1 = tensor_core_checks(
                mods, f"{dt} {shape} (phase 8)", cfg, nx, nw, counts)
            matmul_ms = device_ms(lambda: torch.matmul(nx, nw[:, :KL]))
            ms, runs = time_in_turns(
                float32=lambda: h.srp_hash(x, w, cfg),
                narrow=lambda: h.srp_hash(nx, nw, cfg),
                widening=lambda: h.srp_hash_planned(nx, nw, cfg, None,
                                                    "widening"))
            r = dict(ms=ms["narrow"], float32_ms=ms["float32"],
                     widening_ms=ms["widening"], runs=runs,
                     plain_ms=device_ms(lambda: h.srp_hash_plain(nx, nw,
                                                                 cfg)),
                     matmul_ms=matmul_ms, library_ms=None, shape=shape,
                     **dict(zip(("bound_ms", "bound_by"), bound(
                         2 * B * d * KL, 2 * (B * d + d * KL) + 4 * B * L,
                         PEAK_16BIT_TC_FLOPS))))
            print(f"  srp_hash {dt} {shape}: tensor-core tile "
                  f"{r['ms']:.5f} ms, widening tile {r['widening_ms']:.5f}, "
                  f"float32 {r['float32_ms']:.5f} (in turns), plain "
                  f"{r['plain_ms']:.5f}, cuBLAS {dt} projection "
                  f"{matmul_ms:.5f}, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% "
                  "of bound")
            rows.append(r)
            c = counts.clone()                # updated in place (timing)
            ms, runs = time_in_turns(
                float32=lambda: a.ace_admit_fused(c, x, w, t1, cfg),
                narrow=lambda: a.ace_admit_fused(c, nx, nw, t1, cfg),
                widening=lambda: a.ace_admit_fused_planned(
                    c, nx, nw, t1, cfg, None, None, "widening"))
            u = distinct_counters(ids, nb)    # gathered; inserted at most
            r = dict(ms=ms["narrow"], float32_ms=ms["float32"],
                     widening_ms=ms["widening"], runs=runs,
                     plain_ms=device_ms(lambda: a.ace_admit_fused_plain(
                         c, nx, nw, t1, cfg)),
                     matmul_ms=matmul_ms, library_ms=None, shape=shape,
                     **dict(zip(("bound_ms", "bound_by"), bound(
                         2 * B * d * KL, 2 * (B * d + d * KL) + 3 * 4 * u
                         + 4 * B * L + 5 * B + 4, PEAK_16BIT_TC_FLOPS))))
            print(f"  ace_admit_fused {dt} {shape}: tensor-core tile "
                  f"{r['ms']:.5f} ms, widening tile {r['widening_ms']:.5f}, "
                  f"float32 {r['float32_ms']:.5f} (in turns), plain "
                  f"{r['plain_ms']:.5f}, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']})")
            arows.append(r)
        out["srp_hash"][dt] = {**rows[-1], "by_shape": rows}
        out["ace_admit_fused"][dt] = {**arows[1], "by_shape": arows}
        rows = []
        for where, B, d, K, L in srht_shapes(d_model):
            cfg, (x, _), (nx, _) = operands(B, d, K, L, dt, device, 57,
                                            srht=True)
            ms, runs = time_in_turns(float32=lambda: sh.srht_hash(x, cfg),
                                     narrow=lambda: sh.srht_hash(nx, cfg))
            b_ms, b_by = srht_bound(B, d, cfg, x_bytes=2)
            r = dict(ms=ms["narrow"], float32_ms=ms["float32"], runs=runs,
                     plain_ms=device_ms(lambda: sh.srht_hash_plain(nx,
                                                                   cfg)),
                     library_ms=None, bound_ms=b_ms, bound_by=b_by,
                     shape=f"{where} B={B}, d={d}, K={K}, L={L}")
            print(f"  srht_hash {dt} {r['shape']}: kernel {r['ms']:.5f} ms, "
                  f"float32 {r['float32_ms']:.5f} (in turns), plain "
                  f"{r['plain_ms']:.5f}, bound {b_ms:.5f} ms ({b_by})")
            rows.append(r)
        out["srht_hash"][dt] = {**rows[0], "by_shape": rows}
        B, d, K, L = ADMIT_B, d_model + 1, K_BITS, L_TABLES
        cfg, (x, w), (nx, nw) = operands(B, d, K, L, dt, device, 58)
        runs, moved = fused_cases(mods, device, cfg, B)
        ids = h.srp_hash_planned(nx, nw, cfg, None, "widening")
        KL = cfg.num_projections
        matmul_ms = device_ms(lambda: torch.matmul(nx, nw[:, :KL]))
        for name, run in runs.items():
            if name == "ace_admit_fused":     # timed above
                continue
            ms, samples = time_in_turns(
                float32=lambda: run(x, w, fresh=False),
                narrow=lambda: run(nx, nw, fresh=False),
                widened=lambda: run(nx.float(), nw.float(), fresh=False))
            b_ms, b_by = bound(2 * B * d * KL,
                               2 * (B * d + d * KL) + moved[name](ids),
                               PEAK_16BIT_TC_FLOPS)
            out.setdefault(name, {})[dt] = dict(
                ms=ms["narrow"], float32_ms=ms["float32"],
                widen_ms=ms["widened"], runs=samples, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, matmul_ms=matmul_ms,
                shape=f"admit B={B}, d={d}, K={K}, L={L}")
            print(f"  {name} {dt} admit B={B}, d={d}: kernel "
                  f"{ms['narrow']:.5f} ms, float32 {ms['float32']:.5f}, "
                  f"widened + float32 kernel {ms['widened']:.5f} (in turns), "
                  f"cuBLAS {dt} projection {matmul_ms:.5f}, bound "
                  f"{b_ms:.5f} ms ({b_by})")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the fault-tolerant multi-host fleet (repro_torch.cluster).  Two
# host processes on the one card over a TCPStore this process serves, the
# reference's chaos test (tests/test_cluster_multiprocess.py) at Mixtral's
# width and the paper's K and L.
# ---------------------------------------------------------------------------

CL_HOSTS = ("h0", "h1")
CL_T, CL_B, CL_D = 16, 512, 4096        # tenants; a batch's rows; d_model
CL_CHUNK_T, CL_EPOCH_CHUNKS = 8, 2
CL_BEAT, CL_TIMEOUT = 0.1, 1.5          # heartbeat interval, failure timeout
CL_KILL_AFTER = 10                      # h1 dies after chunk 11: mid-epoch 6
CL_RESUME_TO = 16                       # h0 serves adopted tenants this far
CL_TIMING_CHUNKS = 4                    # (d): chunks a turn
CL_DIR = ROOT / "build" / "cluster"
CL_CHILD_TIMEOUT = 300
CL_DEVICE = "cuda"                      # the hosts' device


def cluster_config(host: str, root: Path):
    """The chaos test's cluster at full width: a 16-tenant int32 fleet of
    K = 15, L = 50 over 4097-wide features, 2 hosts, chunks of 8
    single-tenant batches of 512 rows, an epoch 2 chunks, a checkpoint an
    epoch.  The warmup is the reference's three batches (48 items of 16
    rows there, 1536 of 512 here)."""
    from repro_torch.cluster import ClusterConfig, MembershipConfig
    return ClusterConfig(
        host_id=host, hosts=CL_HOSTS, num_tenants=CL_T, d_model=CL_D,
        num_bits=K_BITS, num_tables=L_TABLES, alpha=2.0,
        warmup_items=3.0 * CL_B, insert_all=True, chunk_T=CL_CHUNK_T,
        epoch_chunks=CL_EPOCH_CHUNKS, ckpt_root=str(root / "ckpt"),
        ckpt_every_epochs=1, ckpt_keep=3,
        membership=MembershipConfig(heartbeat_interval=CL_BEAT,
                                    failure_timeout=CL_TIMEOUT))


def cluster_batch(t: int, idx: int, B: int = CL_B, D: int = CL_D):
    """Batch ``idx`` of tenant t, the reference chaos test's ``_GEN`` at
    width D: rows around one of the tenant's three centres (norm 6),
    and from batch 6 on every third batch a burst of scattered anomalies
    (the first quarter of the rows, norm 8, each its own direction).  The
    noise is scaled by sqrt(8 / D), so the angles are those of the
    reference's D = 8.  Returns (x (B, D) float32, y (B,) bool)."""
    rng = np.random.default_rng(1 + 7919 * t + idx)
    crng = np.random.default_rng(555 + t)
    s = np.float32(np.sqrt(8.0 / D))
    centers = crng.standard_normal((3, D), dtype=np.float32)
    centers *= 6.0 / np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, 3, size=B)
    x = centers[assign] + (0.5 * s) * rng.standard_normal((B, D),
                                                          dtype=np.float32)
    y = np.zeros(B, bool)
    if idx >= 6 and idx % 3 == 0:
        nb = B // 4
        y[:nb] = True
        d = rng.standard_normal((nb, D), dtype=np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        x[:nb] = 8.0 * d + (0.3 * s) * rng.standard_normal(
            (nb, D), dtype=np.float32)
    return x.astype(np.float32), y


def cluster_features(filt, x: np.ndarray) -> np.ndarray:
    """(B, D) embeddings -> (B, D + 1) features, on the host (every process
    computes them alike)."""
    return filt.features(torch.from_numpy(x[:, None, :])).numpy()


class ClusterHost:
    """A chaos host's stream: each chunk takes the next batch of each owned
    tenant in turn, as the reference worker's ``run_chunk`` does, and logs
    what was served and its verdicts."""

    def __init__(self, node):
        self.node = node
        self.counters = {t: 0 for t in range(CL_T)}
        self.step_no = 0
        self.served, self.keeps = [], []
        self.chunk_ms = []
        self.published = {}           # epoch -> {tenant: n} as published

    def run_chunk(self) -> None:
        node, T = self.node, CL_CHUNK_T
        owned = node.owned()
        feats = np.empty((T, CL_B, CL_D + 1), np.float32)
        tids = np.empty((T, CL_B), np.int32)
        meta = []
        for j in range(T):
            t = owned[(self.step_no + j) % len(owned)]
            idx = self.counters[t]
            self.counters[t] += 1
            feats[j] = cluster_features(node.filt, cluster_batch(t, idx)[0])
            tids[j] = t
            meta.append((t, idx))
        self.step_no += T
        epoch = node.epoch
        t0 = time.perf_counter()
        _, keeps = node.ingest_chunk(feats, tids)
        self.chunk_ms.append(1e3 * (time.perf_counter() - t0))
        if node.epoch != epoch:
            n = node.state.n.cpu().numpy()
            self.published[node.epoch] = {t: float(n[t])
                                          for t in node.owned()}
        for m, k in zip(meta, keeps):
            self.served.append(m)
            self.keeps.append(k)


def wait_key(store, key: str, timeout: float = CL_CHILD_TIMEOUT) -> str:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        v = store.get(key)
        if v is not None:
            return v
        time.sleep(0.01)
    raise CheckFailed(f"timed out waiting for {key}")


def detection_reading(polls, last_beat, dead_at) -> tuple:
    """h0's failure detection of h1 read from h0's poll stamps, h1's last
    beat and the declaring poll (one monotonic clock): ((the gap between
    the polls around the beat, the gap before the declaring poll), the
    beat to the declaration, the timeout + one beat + the longest poll
    gap from the beat to the declaration, that gap).  The detector marks
    the beat seen at the first poll after it and declares h1 dead at the
    first poll more than the timeout later, so the beat to the
    declaration lies past the timeout and within the timeout and those
    two gaps."""
    j = next(i for i, p in enumerate(polls) if p >= last_beat)
    m = polls.index(dead_at)
    gaps = [b - a for a, b in zip(polls[j - 1:m], polls[j:m + 1])]
    return ((gaps[0], gaps[-1]), dead_at - last_beat,
            CL_TIMEOUT + CL_BEAT + max(gaps), max(gaps))


def cluster_child(role: str, port: int, root: Path) -> int:
    """One host of phase 18, run as ``chip_smoke.py --cluster-child ROLE
    PORT DIR``: "h0" serves and survives, "h1" serves and dies (exit 137,
    no cleanup) half an epoch past its last publish, "h1b" is h1 restarted
    cold, rejoining.  Writes its results under DIR; the kernels are
    already built, so it only loads them."""
    mods = import_port()
    torch.backends.cuda.matmul.allow_tf32 = False   # the probe's plain hash
    from repro_torch.cluster import (ClusterNode, DistributedStore,
                                     GossipBus, RejoinPolicy)
    from repro_torch.kernels import build
    device = torch.device(CL_DEVICE)
    if device.type == "cuda":
        for name in build.sources():
            build.load(name)
    store = DistributedStore(host="127.0.0.1", port=port)
    node = ClusterNode(cluster_config(role[:2], root), store, device=device)
    out = {"role": role}
    if role == "h1b":
        # stamps on the machine's one monotonic clock: each beat h1b
        # writes (before the write) with the map version it carries, and
        # each adoption's start and end
        beats, adopts = [], []
        beat, adopt = node.heartbeat.beat, node._adopt

        def stamped_beat():
            beats.append((time.monotonic(), int(node.heartbeat.version)))
            beat()

        def timed_adopt(*args):
            t = time.monotonic()
            adopt(*args)
            adopts.append((t, time.monotonic()))
        node.heartbeat.beat, node._adopt = stamped_beat, timed_adopt
        t0 = time.time()
        ok = node.try_rejoin(RejoinPolicy(max_attempts=8, base_delay=0.1))
        n = node.state.n.cpu().numpy()
        out.update(rejoined=ok, rejoin_s=time.time() - t0,
                   adoptions=list(node.adoptions), owned=list(node.owned()),
                   map_version=node.map.version,
                   n={str(t): float(n[t]) for t in node.owned()})
        store.set("h1b_done", "1")
        # back in the cluster, the host runs its control loop until h0
        # has read the state after the rejoin
        t0 = time.monotonic()
        while store.get("h0_after") is None \
                and time.monotonic() - t0 < CL_CHILD_TIMEOUT:
            node.control_step()
            time.sleep(0.05)
        out.update(beats=beats, adopts=adopts,
                   map_version_end=node.map.version)
        (root / "h1b.json").write_text(json.dumps(out))
        return 0
    host = ClusterHost(node)
    # Stamps on the machine's one monotonic clock, shared by the processes:
    # each heartbeat h1 writes (taken before the write) and each poll of
    # h0's failure detector (taken before the poll).
    stamps = []
    stamped = node.heartbeat.beat if role == "h1" else node.detector.poll

    def stamp(*args):
        stamps.append(time.monotonic())
        return stamped(*args)
    if role == "h1":
        node.heartbeat.beat = stamp
    else:
        node.detector.poll = stamp
    reset_launches(mods)
    host.run_chunk()
    store.set(f"warm/{role}", "1")
    wait_key(store, f"warm/{'h1' if role == 'h0' else 'h0'}")
    if role == "h1":
        for i in range(CL_KILL_AFTER):
            host.run_chunk()
            if i == 0:       # (a): h0's first epoch's blob, fetched here
                want = json.loads(wait_key(store, "published/h0/1"))
                t0 = time.perf_counter()
                got = GossipBus(store, "h1").latest("h0")
                out["fetch_ms"] = 1e3 * (time.perf_counter() - t0)
                out["fetched"] = {"epoch": got[0], "map_version": got[2],
                                  "n": {str(t): float(a.n)
                                        for t, a in got[1].items()},
                                  "dtype": str(next(iter(
                                      got[1].values())).counts.dtype)}
                out["fetch_ok"] = (got[0] == 1 and out["fetched"]["n"]
                                   == want)
            node.control_step()
            time.sleep(0.05)
        sync(device)
        out.update(launches=read_launches(mods), chunk_ms=host.chunk_ms,
                   boundary_ms=node.boundary_ms, last_beat_at=stamps[-1],
                   killed_at=time.monotonic())
        (root / "h1.json").write_text(json.dumps(out))
        sys.stdout.flush()
        os._exit(137)                     # SIGKILL-equivalent: no cleanup
    # h0: serve, detect, re-home, resume the adopted streams
    seen, t_dead, reshard_ms = 0, None, None
    for loop in range(400):
        host.run_chunk()
        if loop == 0:
            store.set("published/h0/1", json.dumps(
                {str(t): v for t, v in host.published[1].items()}))
        t0 = time.perf_counter()
        dead = node.control_step()
        if dead and t_dead is None:
            t_dead, polls = stamps[-1], list(stamps)   # the declaring poll
            reshard_ms = 1e3 * (time.perf_counter() - t0)
        for rec in node.adoptions[seen:]:          # resume adopted streams
            host.counters[rec["tenant"]] = int(round(rec["n"] / CL_B))
            seen += 1
        time.sleep(0.03)
        if len(node.owned()) == CL_T:
            adopted = [a["tenant"] for a in node.adoptions]
            if adopted and all(host.counters[t] >= CL_RESUME_TO
                               for t in adopted):
                break
    else:
        raise CheckFailed("h1's death never produced a full adoption")
    # one more publish, so the gossip carries the adopted tenants
    target = node.epoch + 1
    while node.epoch < target:
        host.run_chunk()
        node.control_step()
    sync(device)
    launches = read_launches(mods)
    surv = sorted(set(range(CL_T)) - {a["tenant"] for a in node.adoptions})
    qx = np.random.default_rng(424242).standard_normal(
        (CL_B, CL_D), dtype=np.float32)
    qf = cluster_features(node.filt, qx)
    probe = np.stack([node.probe_scores(qf, np.full(CL_B, t, np.int32))
                      for t in surv])
    s = node.state
    np.savez(root / "h0_result.npz", counts=s.counts.cpu().numpy(),
             n=s.n.cpu().numpy(), mean=s.welford_mean.cpu().numpy(),
             m2=s.welford_m2.cpu().numpy(),
             served_t=np.array([t for t, _ in host.served], np.int32),
             served_i=np.array([i for _, i in host.served], np.int32),
             keeps=np.stack(host.keeps), probe=probe,
             surv=np.array(surv, np.int32))
    out.update(adoptions=node.adoptions, epoch=node.epoch,
               map_version=node.map.version,
               gossip_bytes=node.gossip.published_bytes,
               gossip_epochs=node.gossip.published_epochs,
               boundary_ms=node.boundary_ms, chunk_ms=host.chunk_ms,
               published={str(e): v for e, v in host.published.items()},
               dead_at=t_dead, polls=polls, reshard_ms=reshard_ms,
               launches=launches)
    (root / "h0.json").write_text(json.dumps(out))
    store.set("h0_ready", "1")
    # (c): keep the control plane running until the cold h1 is back;
    # each turn's end on the shared clock, the map version and the hosts
    # it declared dead
    turns = []
    t0 = time.monotonic()
    while store.get("h1b_done") is None:
        if time.monotonic() - t0 > CL_CHILD_TIMEOUT:
            raise CheckFailed("h1 never rejoined")
        dead = node.control_step()
        turns.append((time.monotonic(), node.map.version, dead))
        time.sleep(0.05)
    dead = node.control_step()
    turns.append((time.monotonic(), node.map.version, dead))
    (root / "h0_after.json").write_text(json.dumps(
        {"map_version": node.map.version, "owned": list(node.owned()),
         "turns": turns}))
    store.set("h0_after", "1")
    return 0


def spawn_child(role: str, port: int, root: Path) -> subprocess.Popen:
    log = open(root / f"{role}.log", "w")
    return subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--cluster-child",
         role, str(port), str(root)], stdout=log, stderr=subprocess.STDOUT,
        cwd=str(ROOT))


def child_log(root: Path, role: str) -> str:
    path = root / f"{role}.log"
    return path.read_text()[-3000:] if path.exists() else ""


def wait_child(proc, root: Path, role: str, rc: int) -> None:
    try:
        got = proc.wait(timeout=CL_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise CheckFailed(f"cluster host {role} timed out:\n"
                          + child_log(root, role))
    if got != rc:
        print(child_log(root, role))
    check(got == rc, f"cluster host {role} exited {got} (want {rc})")


def cluster_oracle(device, served_max: dict):
    """The never-failed run on the card: each tenant's batches 0..max, in
    order, one single-batch chunk at a time through a plain
    ``StreamRunner`` over the same filter (the same W: one seed).  Returns
    (state, {(tenant, idx): keep}, filter, W)."""
    from repro_torch.fleet.filter import FleetDataFilter
    from repro_torch.stream.runner import StreamRunner
    c = cluster_config("h0", CL_DIR)
    filt = FleetDataFilter(d_model=c.d_model, num_tenants=c.num_tenants,
                           num_bits=c.num_bits, num_tables=c.num_tables,
                           alpha=c.alpha, warmup_items=c.warmup_items,
                           insert_all=c.insert_all, device=device)
    runner = StreamRunner(filt, chunk_T=1, return_masks=True)
    state, w = runner.init()
    keeps = {}
    for t in range(CL_T):
        tid = torch.full((1, CL_B), t, dtype=torch.int32, device=device)
        for idx in range(served_max[t] + 1):
            f = torch.as_tensor(cluster_features(
                filt, cluster_batch(t, idx)[0]), device=device)[None]
            state, _, k = runner.consume(state, w, f, tid)
            keeps[(t, idx)] = k[0].cpu().numpy()
    return state, keeps, filt, w


def cluster_recall(keep_of, pairs) -> tuple:
    flagged = total = 0
    for t, i in pairs:
        _, y = cluster_batch(t, i)
        if not y.any():
            continue
        k = np.asarray(keep_of(t, i), bool)
        flagged += int((~k[y]).sum())
        total += int(y.sum())
    return flagged / max(total, 1), total


def cluster_timing(device, card) -> dict:
    """(d) ``ClusterNode.ingest_chunk`` (h0's ownership mask, gossip to an
    in-process store and a checkpoint an epoch) in turns with a plain
    ``StreamRunner`` (its fleet upload, ``consume`` and one ``fetch``) on
    the same fleet, ``CL_TIMING_CHUNKS`` chunks a turn, host clock around
    work that ends in a fetch."""
    from repro_torch.cluster import ClusterNode, MemStore
    from repro_torch.stream.runner import StreamRunner
    node = ClusterNode(cluster_config("h0", CL_DIR / "timing"), MemStore(),
                       device=device)
    plain = StreamRunner(node.filt, chunk_T=CL_CHUNK_T, return_masks=True)
    owned = node.owned()
    chunks = []
    for c in range(CL_TIMING_CHUNKS):
        feats = np.stack([cluster_features(node.filt, cluster_batch(
            owned[(c * CL_CHUNK_T + j) % len(owned)], c)[0])
            for j in range(CL_CHUNK_T)])
        tids = np.stack([np.full(CL_B, owned[(c * CL_CHUNK_T + j)
                                             % len(owned)], np.int32)
                         for j in range(CL_CHUNK_T)])
        chunks.append((feats, tids))

    def run_node():
        for feats, tids in chunks:
            node.ingest_chunk(feats, tids)

    def run_plain():
        for feats, tids in chunks:
            f, t = plain._upload_fleet(list(feats), list(tids))
            node.state, summary, keeps = plain.consume(node.state, node.w,
                                                       f, t)
            plain.fetch(summary)
            keeps.cpu()

    run_node()                               # warm both
    run_plain()
    runs = {"node": [], "plain": []}
    for k, fn in (("node", run_node), ("plain", run_plain),
                  ("plain", run_plain), ("node", run_node)) * 2:
        sync(device)
        t0 = time.perf_counter()
        fn()
        runs[k].append(time.perf_counter() - t0)
    items = CL_TIMING_CHUNKS * CL_CHUNK_T * CL_B
    r = {k: items / statistics.median(v) for k, v in runs.items()}
    bd = node.boundary_ms[2:]                # past the warm-up's
    split = {k: statistics.median(b[k] for b in bd)
             for k in ("d2h", "pack", "publish", "ckpt")}
    print(f"  (d) ingest_chunk {r['node']:,.0f} items/s, plain StreamRunner "
          f"{r['plain']:,.0f} items/s on the same fleet (in turns, "
          f"{CL_TIMING_CHUNKS} chunks of {CL_CHUNK_T} x {CL_B} a turn; "
          f"{card})")
    print("  (d) epoch boundary (median of " + str(len(bd)) + "): fleet "
          f"D2H {split['d2h']:.3f} ms ({node.state.counts.numel() * 4:,} B "
          f"of counts), pack + CRC {split['pack']:.3f} ms, store set "
          f"{split['publish']:.3f} ms, checkpoint save {split['ckpt']:.3f} "
          f"ms; gossip {bd[-1]['bytes']:,} B a publish")
    return {"node_items_per_s": r["node"], "plain_items_per_s": r["plain"],
            "runs": runs, "boundary_ms": split}


def phase_cluster(mods, device, card) -> dict:
    """Phase 18 (see the module docstring): (a) the KV and gossip round trip
    between the two host processes, (b) the chaos kill against the
    never-failed oracle, (c) the cold rejoin, (d) timing."""
    from repro_torch.cluster import ShardMap
    shutil.rmtree(CL_DIR, ignore_errors=True)
    CL_DIR.mkdir(parents=True)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    server = torch.distributed.TCPStore(
        "127.0.0.1", port, is_master=True, wait_for_workers=False,
        timeout=datetime.timedelta(seconds=CL_CHILD_TIMEOUT))
    procs = {}
    try:
        t_start = time.perf_counter()
        procs["h0"] = spawn_child("h0", port, CL_DIR)
        procs["h1"] = spawn_child("h1", port, CL_DIR)
        wait_child(procs["h1"], CL_DIR, "h1", 137)
        t0 = time.monotonic()
        while server.check(["h0_ready"]) is False:
            if procs["h0"].poll() is not None or \
                    time.monotonic() - t0 > CL_CHILD_TIMEOUT:
                print(child_log(CL_DIR, "h0"))
                raise CheckFailed("h0 never finished re-homing h1's tenants")
            time.sleep(0.05)
        procs["h1b"] = spawn_child("h1b", port, CL_DIR)
        wait_child(procs["h1b"], CL_DIR, "h1b", 0)
        wait_child(procs["h0"], CL_DIR, "h0", 0)
        children_s = time.perf_counter() - t_start
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        del server
    h0 = json.loads((CL_DIR / "h0.json").read_text())
    h1 = json.loads((CL_DIR / "h1.json").read_text())
    h1b = json.loads((CL_DIR / "h1b.json").read_text())
    after = json.loads((CL_DIR / "h0_after.json").read_text())
    res = np.load(CL_DIR / "h0_result.npz")
    print(f"  the two hosts and the rejoin ran in {children_s:.1f} s "
          f"(processes started after the kernels were built)")

    # (a) the KV and gossip round trip
    b0 = h0["boundary_ms"][0]
    print(f"  (a) h0's first publish: {b0['bytes']:,} B for "
          f"{len(h1['fetched']['n'])} tenants at full width, store set "
          f"{b0['publish']:.3f} ms; h1's fetch of it {h1['fetch_ms']:.3f} "
          f"ms ({card})")
    check(h1["fetch_ok"] and h1["fetched"]["dtype"] == "int32",
          "h1 fetched h0's epoch-1 blob across processes: CRCs pass, n as "
          "h0 published it")

    # (b) the chaos kill
    adopted = {a["tenant"]: a for a in h0["adoptions"]}
    surv = set(res["surv"].tolist())
    won1 = set(ShardMap(0, CL_HOSTS, CL_T).owned_by("h1"))
    check(set(adopted) == won1 and surv | won1 == set(range(CL_T)),
          f"h0 adopted exactly h1's {len(won1)} tenants and kept its "
          f"{len(surv)}")
    check(all(r["source"] == "gossip" and r["source_epoch"] == 5
              and r["n"] == 10.0 * CL_B for r in adopted.values()),
          "every adopted tenant came from h1's last gossip (epoch 5) with "
          "exact n (10 of its 11 batches)")
    latency = h0["dead_at"] - h1["killed_at"]
    ((obs_gap, decl_gap), since_beat, issue_limit,
     window_loop) = detection_reading(h0["polls"], h1["last_beat_at"],
                                      h0["dead_at"])
    print(f"  (b) kill to declared dead {1e3 * latency:.1f} ms, h1's last "
          f"beat to declared dead {1e3 * since_beat:.1f} ms (failure "
          f"timeout {1e3 * CL_TIMEOUT:.0f} ms, beat {1e3 * CL_BEAT:.0f} ms; "
          f"h0's polls {1e3 * obs_gap:.1f} ms apart around h1's last beat "
          f"and {1e3 * decl_gap:.1f} ms before the declaring one; the "
          f"longest poll gap from the beat to the declaration "
          f"{1e3 * window_loop:.1f} ms, so timeout + one beat + that gap "
          f"{1e3 * issue_limit:.1f} ms, "
          f"{'held' if latency <= issue_limit else 'exceeded'}); re-shard + "
          f"adoption of {len(adopted)} tenants {h0['reshard_ms']:.3f} ms")
    check(CL_TIMEOUT < since_beat <= CL_TIMEOUT + obs_gap + decl_gap,
          f"h1 declared dead {since_beat:.3f} s after its last beat: past "
          f"the failure timeout, at the first poll past it (within the "
          f"timeout + the poll gap around the beat + the poll gap before "
          f"the declaration, {CL_TIMEOUT + obs_gap + decl_gap:.3f} s)")
    served = list(zip(res["served_t"].tolist(), res["served_i"].tolist()))
    served_max = {}
    for t, i in served:
        served_max[t] = max(served_max.get(t, -1), i)
    t0 = time.perf_counter()
    oracle, okeeps, filt, w = cluster_oracle(device, served_max)
    print(f"  oracle replay of {sum(v + 1 for v in served_max.values())} "
          f"batches on the card in {time.perf_counter() - t0:.1f} s")
    same = all(np.array_equal(res[k][t], getattr(oracle, f)[t].cpu().numpy())
               for t in surv for k, f in (("counts", "counts"), ("n", "n"),
                                          ("mean", "welford_mean"),
                                          ("m2", "welford_m2")))
    check(same, "survivors' counts, n and Welford bitwise the never-failed "
          "oracle's")
    check(all(np.array_equal(res["counts"][t], oracle.counts[t].cpu().numpy())
              and res["n"][t] == float(oracle.n[t]) for t in adopted),
          "adopted tenants' counts and n equal the oracle's (seamless "
          "resume)")
    from repro_torch.core import srp
    from repro_torch.fleet import state as fl
    qx = np.random.default_rng(424242).standard_normal((CL_B, CL_D),
                                                       dtype=np.float32)
    qf = torch.as_tensor(cluster_features(filt, qx), device=device)
    buckets = srp.hash_buckets(qf, w, filt.ace_cfg.srp)
    check(all(np.array_equal(row, fl.fleet_scores(
        oracle, torch.full((CL_B,), t, dtype=torch.int32, device=device),
        buckets).cpu().numpy()) for row, t in zip(res["probe"],
                                                  sorted(surv))),
        "survivors' probe scores equal the oracle's exactly")
    check(all(np.array_equal(k.astype(bool), okeeps[ti].astype(bool))
              for ti, k in zip(served, res["keeps"])),
          f"all {len(served)} batches h0 served got the oracle's verdicts")
    post = [(t, i) for t, i in served if t in adopted and i >= 10]
    faulted = {ti: k for ti, k in zip(served, res["keeps"])}
    r_fault, n_fault = cluster_recall(lambda t, i: faulted[(t, i)], post)
    r_free, n_free = cluster_recall(
        lambda t, i: okeeps[(t, i)],
        [(t, i) for t in adopted for i in range(11, served_max[t] + 1)])
    print(f"  (b) recall after re-homing {r_fault:.4f} ({n_fault} anomalies)"
          f", fault-free {r_free:.4f} ({n_free})")
    check(n_fault > 0 and r_free > 0 and r_fault >= 0.9 * r_free,
          "recall after re-homing >= 0.9 x fault-free")

    # (c) the cold rejoin
    admitted = next((t for t, v, _ in after["turns"] if v == 2), None)
    new_beats = [t for t, v in h1b["beats"] if v == 2]
    redeclared = [t for t, _, d in after["turns"] if "h1" in d]
    if admitted is not None and new_beats:
        gaps = np.diff([admitted] + new_beats)
        print(f"  (c) rejoin: h1's first beat at the new map version "
              f"{1e3 * (new_beats[0] - admitted):.1f} ms after h0's turn "
              f"that admitted it; adoption "
              + ", ".join(f"{1e3 * (b - a):.1f}" for a, b in h1b["adopts"])
              + f" ms; longest silence at that version "
              f"{1e3 * float(gaps.max()):.1f} ms (failure timeout "
              f"{1e3 * CL_TIMEOUT:.0f} ms); h0 declared h1 dead again: "
              f"{'yes' if redeclared else 'no'}")
    moved = {a["tenant"] for a in h1b["adoptions"]}
    pub = h0["published"][str(max(map(int, h0["published"])))]
    check(h1b["rejoined"] and moved == won1 and set(h1b["owned"]) == won1
          and set(after["owned"]) == surv and after["map_version"] == 2,
          f"h1 rejoined in {h1b['rejoin_s']:.3f} s and won back only its "
          f"{len(won1)} HRW tenants; h0 kept its own")
    check(all(a["source"] == "gossip" and a["from_host"] == "h0"
              and a["n"] == pub[str(a["tenant"])] for a in h1b["adoptions"]),
          "the rejoined host took them from h0's last gossip with exact n")

    # the fleet step's kernels on the card, in each serving host
    paths = {}
    for role, r in (("h0", h0), ("h1", h1)):
        lc = r["launches"]
        print(f"  launches ({role}): " + ", ".join(
            f"{k} {v}" for k, v in lc.items() if v))
        check(all(lc[k] > 0 for k in ("srp_hash", "ace_query", "ace_update"))
              and lc["ace_query_gather"] == 0,
              f"{role} launched srp_hash, ace_query_sum and ace_update, and "
              "no (B, L) ace_query gather")
        paths[f"cluster_{role}"] = {"launches": lc}
        cms = r["chunk_ms"][1:]
        rate = CL_CHUNK_T * CL_B / (1e-3 * statistics.median(cms))
        print(f"  (d) {role}: ingest_chunk {rate:,.0f} items/s (median of "
              f"{len(cms)} chunks during the run, host clock)")
    bd = h0["boundary_ms"]
    print(f"  (d) h0's epoch boundaries: gossip {bd[-1]['bytes']:,} B a "
          f"publish ({h0['gossip_bytes']:,} B over {h0['gossip_epochs']} "
          "epochs)")
    cluster_timing(device, card)
    return paths


# ---------------------------------------------------------------------------
# Phase 19: repro_torch.dist — sharded sketches, GPipe and ZeRO-2 training,
# as gloo ranks on the one card
# ---------------------------------------------------------------------------

DI_DIR = ROOT / "build" / "dist"
DI_DEVICE = "cuda"                       # the ranks' device
DI_TIMEOUT = 600                         # seconds a group of ranks may take
DI_L = 50                                # (a), (b): 25 tables a rank
DI_ADMITS = 16                           # (a): admits of ADMIT_B rows
DI_T, DI_FLEET_ADMITS = 8, 8             # (b): tenants; admits a group
DI_STREAM = dict(T=16, B=512, K=13, L=32, chunks=2)     # (c)
DI_WINDOW = dict(num_epochs=4, decay=0.9, rotate_every=4)
DI_BIG = dict(K=18, L=200, admits=4)     # (d): 209,715,200 B of int32
DI_PIPE = dict(S=2, M=8, mb=64, D=1024)  # (f)
DI_TRAIN_STEPS = 2                       # (e)
DI_MODES = ("mu_sigma", "quantile")
DI_LAYOUTS = ("replicated", "table_sharded")
# (g): the self-healing lifecycle under a mesh, name -> (GuardrailConfig
# fields, layout); admits before the flips, re-warm cap, timed turns
DI_LIFE = {
    "flat_mu_sigma": (dict(), "table_sharded"),
    "flat_quantile": (dict(threshold_mode="quantile"), "table_sharded"),
    "window": (dict(window_epochs=4, window_decay=0.9, rotate_every=2),
               "table_sharded"),
    "fleet": (dict(num_tenants=DI_T, warmup_items=float(ADMIT_B)),
              "tenant_sharded"),
}
DI_LIFE_WARM, DI_LIFE_REWARM, DI_LIFE_TURNS = 6, 16, 8


def dist_guard_cfg(**kw):
    from repro_torch.serve.engine import GuardrailConfig
    base = dict(d_model=D_MODEL, num_bits=K_BITS, num_tables=DI_L,
                warmup_items=4.0 * ADMIT_B)
    return GuardrailConfig(**{**base, **kw})


def dist_big_cfg():
    return dist_guard_cfg(num_bits=DI_BIG["K"], num_tables=DI_BIG["L"],
                          warmup_items=float(ADMIT_B))


def dist_fleet_batches(device, group: int, groups: int,
                       admits: int = DI_FLEET_ADMITS):
    """(embeds, tenant ids) of each fleet admit of tenant group ``group``:
    the guardrail traffic, each row routed to one of the group's
    DI_T / groups tenants."""
    per = DI_T // groups
    rng = np.random.default_rng(SEED + 190 + group)
    for e, _ in guardrail_batches(device, D_MODEL, admits, ADMIT_B,
                                  ADMIT_S):
        yield e, (rng.integers(0, per, ADMIT_B) + per * group).astype(
            np.int32)


def timed_admit(g, e, t=None):
    """One admit: (host-clock ms, its verdicts); the verdicts' D2H
    syncs."""
    t0 = time.perf_counter()
    mask = g.admit(e, t)
    return 1e3 * (time.perf_counter() - t0), mask


def dist_guardrail_run(device, mode, w, mesh=None, layout="replicated"):
    """DI_ADMITS admits of one flat Guardrail, over ``mesh`` in ``layout``
    or with no mesh: (guardrail, masks, ms)."""
    from repro_torch.serve.engine import Guardrail
    g = Guardrail(dist_guard_cfg(threshold_mode=mode), device=device,
                  mesh=mesh, sketch_layout=layout, w=w)
    masks, ms = [], []
    for e, _ in guardrail_batches(device, D_MODEL, DI_ADMITS, ADMIT_B,
                                  ADMIT_S):
        t, m = timed_admit(g, e)
        masks.append(m)
        ms.append(t)
    return g, np.stack(masks), ms


def dist_fleet_run(device, layout, w, mesh, group, groups):
    from repro_torch.serve.engine import Guardrail
    g = Guardrail(dist_guard_cfg(num_tenants=DI_T, warmup_items=ADMIT_B),
                  device=device, mesh=mesh, sketch_layout=layout, w=w)
    masks, ms = [], []
    for e, t in dist_fleet_batches(device, group, groups):
        dt, m = timed_admit(g, e, t)
        masks.append(m)
        ms.append(dt)
    return g, np.stack(masks), ms


def dist_filters(device):
    from repro_torch.data.pipeline import AceDataFilter
    from repro_torch.window.filter import WindowedAceFilter
    s = DI_STREAM
    kw = dict(d_model=D_MODEL, num_bits=s["K"], num_tables=s["L"],
              device=device)
    return {"flat": AceDataFilter(**kw),
            "window": WindowedAceFilter(**kw, **DI_WINDOW)}


def dist_stream_run(device, filt, mesh, feats, w):
    """DI_STREAM's chunks through a StreamRunner: (state, keeps, items/s)."""
    from repro_torch.stream.runner import StreamRunner
    s = DI_STREAM
    runner = StreamRunner(filt, s["T"], return_masks=True, mesh=mesh,
                          sketch_layout="table_sharded")
    state, _ = runner.init()
    keeps, secs = [], 0.0
    for c in range(s["chunks"]):
        chunk = torch.as_tensor(feats[c * s["T"]:(c + 1) * s["T"]],
                                device=device)
        sync(device)
        t0 = time.perf_counter()
        state, summary, keep = runner.consume(state, w, chunk)
        runner.fetch(summary)
        secs += time.perf_counter() - t0
        keeps.append(keep.cpu())
    return runner, state, torch.stack(keeps), s["chunks"] * s["T"] * s[
        "B"] / secs


def dist_train(device, mesh, steps):
    """Reduced olmo_1b (phase 17's (b) config, no compression), ``steps``
    steps: over ``mesh`` with FSDP specs (``launch.train``'s), or on one
    process.  Returns (state, history, specs or None)."""
    from repro_torch.data.pipeline import DataStream, StreamConfig
    from repro_torch.dist import mesh as dm
    from repro_torch.models import Arch
    from repro_torch.models.common import set_rules
    from repro_torch.train import sharded
    from repro_torch.train.train_loop import init_train_state, train
    arch = Arch("olmo_1b", reduced=True)
    tcfg = train_config(peak_lr=1e-3, total_steps=16, device=device.type)
    scfg = StreamConfig(vocab_size=arch.cfg.vocab_size, seq_len=REDUCED_S,
                        global_batch=REDUCED_B, seed=SEED)
    if mesh is None:
        state, hist = train(arch, tcfg, DataStream(scfg), steps, log_every=0)
        return state, hist, None
    set_rules(dm.rules_for(mesh))
    shapes = arch.abstract_params()[0]
    specs = dm.sharding_tree_for(
        mesh, dm.fsdp_tree(arch.param_pspecs(), shapes, mesh), shapes)
    set_rules({})
    state = sharded.shard_train_state(init_train_state(arch, tcfg), arch,
                                      tcfg, mesh, specs)
    state, hist = train(arch, tcfg, DataStream(scfg), steps, log_every=0,
                        state=state, mesh=mesh, grad_pspecs=specs)
    return state, hist, specs


def dist_pipe_operands(device):
    p = DI_PIPE
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    w = 0.3 * torch.randn((p["S"], p["D"], p["D"]), generator=gen,
                          device=device) / p["D"] ** 0.5
    x = torch.randn((p["M"], p["mb"], p["D"]), generator=gen, device=device)
    return w, x


def dist_layer(p, h):
    return torch.tanh(h @ p["w"])


def np_state(st) -> dict:
    """The state's counts, n and Welford, copied to the host."""
    return {k: getattr(st, k).detach().to("cpu", copy=True)
            for k in ("counts", "n", "welford_mean", "welford_m2")}


def dist_life_flips(name: str) -> list:
    """(g)'s flips (lead, table, bucket, bit): two tables in each half of
    the L = 50 (each rank's tables under the table layout) or, for the
    fleet, one tenant of each tenant group a flip; the lead is the
    fleet's tenant or the ring's epoch; bits 16-30, which no count of
    this traffic has, so every flip raises its table's sum."""
    fields, _ = DI_LIFE[name]
    rng = np.random.default_rng(SEED + 197)
    half, nb = DI_L // 2, 1 << K_BITS
    fleet = fields.get("num_tenants", 1) > 1
    flips = []
    for shard in (0, 1):
        for j in rng.choice(half, 2, replace=False) + shard * half:
            lead = (rng.integers(0, DI_T // 2) + shard * DI_T // 2 if fleet
                    else rng.integers(0, fields.get("window_epochs", 1)))
            flips.append((int(lead), int(j), int(rng.integers(0, nb)),
                          int(rng.integers(16, 31))))
    return flips


def dist_flip(g, flips: list) -> None:
    """The flips that land in ``g``'s block (all of them with no mesh),
    in place."""
    sh = g._shard
    t0, lt = (0, g.gcfg.num_tables) if sh is None \
        else (sh.table_start, sh.l_local)
    u0, ut = (0, max(g.gcfg.num_tenants, 1)) if sh is None \
        else (sh.tenant_start, sh.t_local)
    counts = g.state.counts
    for lead, j, b, bit in flips:
        if not t0 <= j < t0 + lt:
            continue
        if g.multi_tenant:
            if not u0 <= lead < u0 + ut:
                continue
            idx = (lead - u0, j - t0, b)
        else:
            idx = (lead, j - t0, b) if g.windowed else (j - t0, b)
        counts[idx] ^= 1 << bit


def life_mu(g) -> torch.Tensor:
    """μ under ``g``'s serving mask: ``ShardedSketch.mean_mu`` on a rank,
    the single card's function with no mesh."""
    from repro_torch.core import sketch as sk
    from repro_torch.fleet import state as fl
    from repro_torch.window import ring
    mask, gamma = g._table_mask, g.gcfg.window_decay
    if g._shard is not None:
        return g._shard.mean_mu(g.state, mask, gamma).cpu()
    if g.windowed:
        return ring.mean_mu_windowed(g.state, gamma, mask).cpu()
    if g.multi_tenant:
        return fl.mean_mu_fleet(g.state, mask).cpu()
    return sk.mean_mu(g.state, mask).cpu()


def copied_state(g) -> dict:
    """``np_state`` of the guardrail's whole state (a sharded one's
    gathered)."""
    return np_state(g.state if g._shard is None else g._shard.gather(g.state))


def dist_life_run(device, name, w, mesh=None, group=0):
    """One (g) lifecycle of a Guardrail: over ``mesh`` (this rank's
    blocks; a fleet rank serves tenant group ``group``) or on one process
    (a fleet's two tenant groups admitted in turns): DI_LIFE_WARM admits,
    ``dist_life_flips``, ``health_check``, two degraded admits,
    ``repair``, admit + ``health_check`` until healthy (at most
    DI_LIFE_REWARM), one healthy admit.  Returns (guardrail, its traffic
    streams, record): verdicts, reports, ``degraded`` / ``_rewarm_admits``
    after each audit, ``_to_host`` calls an admit and a health_check,
    the masked μ after the first audit, the repaired state (and a ring's
    ssq), the admit of recovery, the final state, the two control calls'
    host-clock ms."""
    import repro_torch.serve.engine as engine
    fields, layout = DI_LIFE[name]
    g = engine.Guardrail(dist_guard_cfg(**fields), device=device, mesh=mesh,
                         sketch_layout=layout, w=w)
    admits = DI_LIFE_WARM + 2 + DI_LIFE_REWARM + 1 + 2 * DI_LIFE_TURNS
    if g.multi_tenant:
        streams = [dist_fleet_batches(device, gr, 2, admits)
                   for gr in ((0, 1) if mesh is None else (group,))]
    else:
        streams = [((e, None) for e, _ in guardrail_batches(
            device, D_MODEL, admits, ADMIT_B, ADMIT_S))]
    rec = {"masks": [], "reports": [], "flags": [], "d2h_admit": [],
           "d2h_check": []}
    calls = [0]
    real = engine._to_host

    def counted(x):
        calls[0] += 1
        return real(x)

    def serve():
        row = []
        for stream in streams:
            c0 = calls[0]
            row.append(g.admit(*next(stream)))
            rec["d2h_admit"].append(calls[0] - c0)
        rec["masks"].append(np.stack(row))

    def audit(method):
        c0 = calls[0]
        t0 = time.perf_counter()
        rep = getattr(g, method)()          # ends in its one transfer
        ms = 1e3 * (time.perf_counter() - t0)
        if method == "health_check":
            rec["d2h_check"].append(calls[0] - c0)
        rec["reports"].append(np.concatenate(
            [np.asarray(x, bool).reshape(-1) for x in rep]))
        rec["flags"].append([bool(g.degraded), int(g._rewarm_admits)])
        return ms

    engine._to_host = counted
    try:
        for _ in range(DI_LIFE_WARM):
            serve()
        dist_flip(g, dist_life_flips(name))
        rec["health_check_ms"] = audit("health_check")
        rec["mu"] = life_mu(g)
        rec["degraded_mask"] = g._table_mask
        for _ in range(2):
            serve()
        rec["repair_ms"] = audit("repair")
        rec["repaired"] = copied_state(g)
        if g.windowed:
            rec["ssq"] = g.state.ssq.detach().to("cpu", copy=True)
        rec["landed"] = -1
        for i in range(DI_LIFE_REWARM):
            serve()
            audit("health_check")
            if not g.degraded:
                rec["landed"] = i
                break
        serve()
    finally:
        engine._to_host = real
    rec["final"] = copied_state(g)
    rec["masks"] = torch.as_tensor(np.stack(rec["masks"]))
    rec["reports"] = torch.as_tensor(np.stack(rec["reports"]))
    return g, streams, rec


def tally_delta(before: dict, after: dict) -> dict:
    """{kind: {"bytes", "count"}} of the collectives between two
    ``TALLY.snapshot()``s."""
    kinds = [k for k, v in after.items() if isinstance(v, dict)
             and "count" in v]
    return {k: {f: after[k][f] - before.get(k, {}).get(f, 0)
                for f in ("bytes", "count")} for k in kinds
            if after[k]["count"] > before.get(k, {}).get("count", 0)}


def dist_life_turns(g, streams, dmask) -> dict:
    """A degraded admit (``dmask`` the serving mask) and a healthy one (no
    mask) in turns on the same sharded guardrail, DI_LIFE_TURNS each, the
    order alternating: host-clock p50s; then one of each with its
    collectives counted."""
    from repro_torch.dist import collectives as col
    lat = {"degraded": [], "healthy": []}
    for i in range(DI_LIFE_TURNS):
        for route in (("degraded", "healthy") if i % 2 else
                      ("healthy", "degraded")):
            g._table_mask = dmask if route == "degraded" else None
            e, t = next(streams[0])
            t0 = time.perf_counter()
            g.admit(e, t)
            lat[route].append(1e3 * (time.perf_counter() - t0))
    out = {f"{k}_p50_ms": statistics.median(v) for k, v in lat.items()}
    for route in ("degraded", "healthy"):
        g._table_mask = dmask if route == "degraded" else None
        before = col.TALLY.snapshot()
        g.admit(*next(streams[0]))
        out[f"{route}_collectives"] = tally_delta(before,
                                                  col.TALLY.snapshot())
    g._table_mask = None
    return out


def dist_child(world: int, rank: int, root: Path) -> int:
    """One rank of phase 19, run as ``chip_smoke.py --dist-child WORLD
    RANK DIR``: joins the gloo group of WORLD ranks (``file://`` init under
    DIR), runs its parts on the card, and writes its results there: a JSON
    of launches, tallies and timings, tensors in a ``.pt``.  The kernels
    are already built, so it only loads them."""
    import torch.distributed as dist
    mods = import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist import collectives as col
    from repro_torch.dist.mesh import make_debug_mesh, make_mesh
    from repro_torch.kernels import build
    device = torch.device(DI_DEVICE)
    if device.type == "cuda":
        torch.cuda.set_device(0)
        for name in build.sources():
            build.load(name)
    dist.init_process_group("gloo", init_method=f"file://{root}/init{world}",
                            rank=rank, world_size=world)
    dtype = device.type
    out = {"rank": rank, "world": world, "paths": {}, "tally": {},
           "ms": {}}
    tensors = {}
    w = torch.load(root / "w.pt").to(device)

    def part(name, fn):
        reset_launches(mods)
        col.TALLY.reset()
        res = fn()
        out["paths"][f"dist_{name}_r{rank}"] = {
            "launches": read_launches(mods)}
        out["tally"][name] = col.TALLY.snapshot()
        return res

    try:
        if world == 2:
            mesh = make_debug_mesh(data=1, model=2, device_type=dtype)
            for layout in DI_LAYOUTS:
                for mode in DI_MODES:
                    name = f"guardrail_{layout}_{mode}"
                    g, masks, ms = part(name, lambda: dist_guardrail_run(
                        device, mode, w, mesh, layout))
                    out["ms"][name] = ms
                    tensors[f"{name}_masks"] = torch.as_tensor(masks)
                    tensors[name] = np_state(g._shard.gather(g.state))
            tmesh = make_debug_mesh(data=2, model=1, device_type=dtype)
            g, masks, ms = part("fleet_tenant_sharded", lambda: dist_fleet_run(
                device, "tenant_sharded", w, tmesh, rank, 2))
            out["ms"]["fleet_tenant_sharded"] = ms
            tensors["fleet_tenant_sharded_masks"] = torch.as_tensor(masks)
            tensors["fleet_tenant_sharded"] = np_state(
                g._shard.gather(g.state))
            del g
            out["life"] = {}
            for name, (_, layout) in DI_LIFE.items():
                lmesh = tmesh if layout == "tenant_sharded" else mesh

                def life():
                    g, streams, rec = dist_life_run(device, name, w, lmesh,
                                                    rank)
                    rec.update(dist_life_turns(g, streams,
                                               rec.pop("degraded_mask")))
                    return rec
                rec = part(f"life_{name}", life)
                tensors[f"life_{name}"] = {k: rec.pop(k) for k in (
                    "masks", "reports", "mu", "repaired", "final", "ssq")
                    if k in rec}
                out["life"][name] = rec
            feats, _ = stream_features(device, D_MODEL, DI_STREAM["chunks"],
                                       DI_STREAM["T"], DI_STREAM["B"])
            ws = torch.load(root / "w_stream.pt").to(device)
            for kind, filt in dist_filters(device).items():
                runner, st, keeps, ips = part(
                    f"stream_{kind}", lambda: dist_stream_run(
                        device, filt, mesh, feats, ws))
                out["ms"][f"stream_{kind}_items_per_s"] = ips
                tensors[f"stream_{kind}_keeps"] = keeps
                tensors[f"stream_{kind}"] = np_state(runner.shard.gather(st))
            del feats
            wb = torch.load(root / "w_big.pt").to(device)
            from repro_torch.serve.engine import Guardrail

            def big():
                g = Guardrail(dist_big_cfg(), device=device, mesh=mesh,
                              sketch_layout="table_sharded", w=wb)
                masks, ms = [], []
                for e, _ in guardrail_batches(device, D_MODEL,
                                              DI_BIG["admits"], ADMIT_B,
                                              ADMIT_S):
                    dt, m = timed_admit(g, e)
                    masks.append(m)
                    ms.append(dt)
                return g, np.stack(masks), ms
            g, masks, ms = part("big", big)
            out["ms"]["big"] = ms
            out["big_block_bytes"] = g.state.counts.numel() * 4
            tensors["big_masks"] = torch.as_tensor(masks)
            tensors["big_block"] = g.state.counts.cpu()
            tensors["big"] = {k: v for k, v in np_state(g.state).items()
                              if k != "counts"}
            del g
            dmesh = make_debug_mesh(data=2, model=1, device_type=dtype)
            st, hist, specs = part("train", lambda: dist_train(
                device, dmesh, DI_TRAIN_STEPS))
            from repro_torch.models.registry import leaves
            from repro_torch.train import sharded
            full = sharded.gather_params(st.params, specs, dmesh)
            tensors["train_params"] = torch.cat(
                [t.reshape(-1).cpu() for t in leaves(full)])
            tensors["train_filter"] = np_state(st.filter_state)
            tensors["train_monitor"] = np_state(st.monitor.ace)
            out["train_hist"] = hist
            out["train_fsdp_leaves"] = sum(
                1 for ps in sharded.spec_leaves(specs) if "data" in ps)
            pmesh = make_mesh((2,), ("pipe",), dtype)
            pw, px = dist_pipe_operands(device)
            from repro_torch.dist.pipeline import pipeline_apply
            tensors["pipe"] = part("pipe", lambda: pipeline_apply(
                dist_layer, {"w": pw}, px, mesh=pmesh,
                num_stages=DI_PIPE["S"],
                num_microbatches=DI_PIPE["M"])).cpu()
        else:
            mesh = make_debug_mesh(data=2, model=2, device_type=dtype)
            g, masks, ms = part("fleet_tenant_table_sharded",
                                lambda: dist_fleet_run(
                                    device, "tenant_table_sharded", w, mesh,
                                    mesh.get_local_rank("data"), 2))
            out["ms"]["fleet_tenant_table_sharded"] = ms
            tensors["fleet_tenant_table_sharded_masks"] = \
                torch.as_tensor(masks)
            tensors["fleet_tenant_table_sharded"] = np_state(
                g._shard.gather(g.state))
        out["host_staged"] = sorted(col.GLOO_HOST_STAGED)
    finally:
        dist.destroy_process_group()
    torch.save(tensors, root / f"w{world}_r{rank}.pt")
    (root / f"w{world}_r{rank}.json").write_text(json.dumps(out))
    return 0


def spawn_ranks(world: int, root: Path) -> list:
    procs = []
    for r in range(world):
        log = open(root / f"w{world}_r{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-child",
             str(world), str(r), str(root)], stdout=log,
            stderr=subprocess.STDOUT, cwd=str(ROOT)))
    return procs


def wait_ranks(procs: list, world: int, root: Path, phase: int = 19,
               timeout: float = DI_TIMEOUT) -> None:
    t0 = time.monotonic()
    try:
        for r, p in enumerate(procs):
            left = max(timeout - (time.monotonic() - t0), 1.0)
            try:
                rc = p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                print((root / f"w{world}_r{r}.log").read_text()[-4000:])
            check(rc == 0, f"phase {phase} rank {r} of {world} exited {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def same_state(a: dict, b: dict, what: str) -> None:
    for k in b:
        check(torch.equal(a[k], b[k]), f"{what}: {k} bitwise")


def p50(ms) -> float:
    return statistics.median(ms)


def phase_dist(mods, device, card) -> dict:
    """Phase 19 (see the module docstring).  This process runs every
    baseline first, on the main path with no mesh (the unmeshed
    ``Guardrail`` with its fused admission, the filters' kernel path,
    one process's training), then the ranks as two groups of processes
    on the card, world 2 and then world 4, waiting idle, then the timed
    baselines again (in turns around the ranks); then compares."""
    from repro_torch.models.registry import leaves
    from repro_torch.serve.engine import Guardrail
    shutil.rmtree(DI_DIR, ignore_errors=True)
    DI_DIR.mkdir(parents=True)
    w = Guardrail(dist_guard_cfg(), device=device).w
    torch.save(w.cpu(), DI_DIR / "w.pt")
    ws = dist_filters(device)["flat"].init()[1]
    torch.save(ws.cpu(), DI_DIR / "w_stream.pt")
    wb = Guardrail(dist_big_cfg(), device=device).w
    torch.save(wb.cpu(), DI_DIR / "w_big.pt")

    def timed_baselines():
        out = {}
        for mode in DI_MODES:
            g, masks, ms = dist_guardrail_run(device, mode, w)
            out[mode] = (np_state(g.state), masks, ms)
        feats, _ = stream_features(device, D_MODEL, DI_STREAM["chunks"],
                                   DI_STREAM["T"], DI_STREAM["B"])
        for kind, f in dist_filters(device).items():
            _, st, keeps, ips = dist_stream_run(device, f, None, feats, ws)
            out[f"stream_{kind}"] = (np_state(st), keeps, ips)
        return out

    t0 = time.perf_counter()
    before = timed_baselines()
    g = Guardrail(dist_guard_cfg(num_tenants=DI_T, warmup_items=ADMIT_B),
                  device=device, w=w)
    fleet_masks = {0: [], 1: []}
    for (e0, i0), (e1, i1) in zip(dist_fleet_batches(device, 0, 2),
                                  dist_fleet_batches(device, 1, 2)):
        fleet_masks[0].append(g.admit(e0, i0))
        fleet_masks[1].append(g.admit(e1, i1))
    fleet = np_state(g.state)
    g = Guardrail(dist_big_cfg(), device=device, w=wb)
    big_masks, big_ms = [], []
    for e, _ in guardrail_batches(device, D_MODEL, DI_BIG["admits"],
                                  ADMIT_B, ADMIT_S):
        dt, m = timed_admit(g, e)
        big_masks.append(m)
        big_ms.append(dt)
    big_state = np_state(g.state)
    del g
    tstate, thist, _ = dist_train(device, None, DI_TRAIN_STEPS)
    pw, px = dist_pipe_operands(device)
    seq = px
    for s in range(DI_PIPE["S"]):
        seq = dist_layer({"w": pw[s]}, seq)
    life_one = {}
    for name in DI_LIFE:
        rec = dist_life_run(device, name, w)[2]
        rec.pop("degraded_mask")
        life_one[name] = rec
    t1 = time.perf_counter()
    for world in (2, 4):
        wait_ranks(spawn_ranks(world, DI_DIR), world, DI_DIR)
    ranks_s = time.perf_counter() - t1
    after = timed_baselines()
    res = {(wd, r): (json.loads((DI_DIR / f"w{wd}_r{r}.json").read_text()),
                     torch.load(DI_DIR / f"w{wd}_r{r}.pt"))
           for wd in (2, 4) for r in range(wd)}
    print(f"  one-process baselines {t1 - t0:.1f} s, then the ranks (world "
          f"2, then world 4, on the one card) {ranks_s:.1f} s ({card})")
    print(f"  gloo host staging: {res[(2, 0)][0]['host_staged']} go "
          "through a host copy on CUDA tensors (gloo's point-to-point "
          "sends read device pointers as host memory); all-reduce, "
          "all-gather, reduce-scatter and broadcast take them directly")
    paths = {}      # one a part and world, its ranks' launches summed
    for (wd, r), (js, _) in res.items():
        for name, p in js["paths"].items():
            part = name[5:-3]
            total = paths.setdefault(f"dist_{part}_w{wd}", {
                "launches": dict.fromkeys(p["launches"], 0)})["launches"]
            for k, v in p["launches"].items():
                total[k] += v
            print(f"  rank {r} of {wd}, {part}: launches "
                  + ", ".join(f"{k} {v}" for k, v in p["launches"].items()
                              if v)
                  + f"; tally {js['tally'][part]}")

    # (a) flat guardrails, world 2
    for layout in DI_LAYOUTS:
        for mode in DI_MODES:
            name = f"guardrail_{layout}_{mode}"
            want, masks, _ = before[mode]
            for r in range(2):
                js, t = res[(2, r)]
                check(np.array_equal(t[f"{name}_masks"].numpy(), masks),
                      f"(a) {name} rank {r}: {DI_ADMITS} masks bitwise the "
                      "one process's")
                same_state(t[name], want, f"(a) {name} rank {r}")
                launched = js["paths"][f"dist_{name}_r{r}"]["launches"]
                check(all(launched[k] > 0 for k in ("srp_hash", "ace_query",
                                                    "ace_update"))
                      and launched["ace_admit_fused"] == 0,
                      f"(a) {name} rank {r}: srp_hash, ace_query_sum and "
                      "ace_update launched, no fused admission")
                tally = js["tally"][name]
                ar = tally.get("all-reduce", {"bytes": 0, "count": 0})
                per = 2 * 4 * ADMIT_B + (8 if mode == "mu_sigma" else 0)
                want_bytes = per * DI_ADMITS if layout == "table_sharded" \
                    else 0
                check(ar["bytes"] == want_bytes,
                      f"(a) {name}: all-reduce bytes {ar['bytes']} = "
                      f"{DI_ADMITS} admits x (two (B,) float partial sums, "
                      f"4·B = {4 * ADMIT_B} B each"
                      + (", and μ's int64 Σc²)" if mode == "mu_sigma"
                         else ")"))
            print(f"  (a) {name}: admit p50 "
                  f"{p50(res[(2, 0)][0]['ms'][name]):.3f} ms at world 2, "
                  f"one process {p50(before[mode][2]):.3f} / "
                  f"{p50(after[mode][2]):.3f} ms (before / after) ({card})")
    # (b) fleets
    for layout, wd in (("tenant_sharded", 2), ("tenant_table_sharded", 4)):
        for r in range(wd):
            js, t = res[(wd, r)]
            group = r if wd == 2 else r // 2
            check(np.array_equal(t[f"fleet_{layout}_masks"].numpy(),
                                 np.stack(fleet_masks[group])),
                  f"(b) fleet {layout} rank {r}: masks bitwise the one "
                  "process's for its tenants")
            same_state(t[f"fleet_{layout}"], fleet,
                       f"(b) fleet {layout} rank {r}")
            tally = js["tally"][f"fleet_{layout}"]
            check("data" not in tally["by_axis"],
                  f"(b) fleet {layout} rank {r}: no collective on the "
                  f"tenant axis (tally by axis {tally['by_axis']})")
        print(f"  (b) fleet {layout}, T {DI_T}: admit p50 "
              f"{p50(res[(wd, 0)][0]['ms'][f'fleet_{layout}']):.3f} ms at "
              f"world {wd} ({card})")
    # (c) stream
    for kind in ("flat", "window"):
        want, keeps, ips = before[f"stream_{kind}"]
        for r in range(2):
            js, t = res[(2, r)]
            check(torch.equal(t[f"stream_{kind}_keeps"], keeps),
                  f"(c) stream {kind} rank {r}: keep masks bitwise")
            same_state(t[f"stream_{kind}"], want, f"(c) stream {kind} "
                       f"rank {r}")
        print(f"  (c) stream {kind} (T {DI_STREAM['T']}, B "
              f"{DI_STREAM['B']}, d {D_MODEL + 1}, K {DI_STREAM['K']}, L "
              f"{DI_STREAM['L']}): "
              f"{res[(2, 0)][0]['ms'][f'stream_{kind}_items_per_s']:,.0f} "
              f"items/s at world 2, one process {ips:,.0f} / "
              f"{after[f'stream_{kind}'][2]:,.0f} (before / after) ({card})")
    # (d) the big sketch
    half = DI_BIG["L"] // 2
    for r in range(2):
        js, t = res[(2, r)]
        check(np.array_equal(t["big_masks"].numpy(), np.stack(big_masks)),
              f"(d) big sketch rank {r}: masks bitwise")
        check(torch.equal(t["big_block"],
                          big_state["counts"][r * half:(r + 1) * half]),
              f"(d) big sketch rank {r}: its {js['big_block_bytes']:,} B "
              "block bitwise the one process's tables "
              f"{r * half}..{(r + 1) * half - 1}")
        same_state(t["big"], {k: v for k, v in big_state.items()
                              if k != "counts"}, f"(d) big rank {r}")
    print(f"  (d) K {DI_BIG['K']}, L {DI_BIG['L']}: "
          f"{big_state['counts'].numel() * 4:,} B of counts, admit p50 "
          f"{p50(res[(2, 0)][0]['ms']['big']):.3f} ms at world 2, one "
          f"process {p50(big_ms):.3f} ms ({card})")
    # (e) ZeRO-2 training
    js, t = res[(2, 0)]
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(js["train_hist"], thist))
    one_params = torch.cat([p.reshape(-1).cpu() for p in
                            leaves(tstate.params)])
    diffs = (t["train_params"] - one_params).abs()
    lr_sum = sum(h["lr"] for h in thist)
    share = float((diffs <= 1e-6).float().mean())
    print(f"  (e) reduced olmo_1b, {DI_TRAIN_STEPS} steps at --mesh 2x1 "
          f"({js['train_fsdp_leaves']} leaves split over data): loss rel "
          f"err {loss_err:.3g}, params max abs {float(diffs.max()):.3g} "
          f"({share:.6f} within 1e-6) against one process")
    check(loss_err <= 1e-5, "(e) losses within rtol 1e-5 of one process")
    check(float(diffs.max()) <= lr_sum and share >= 0.999,
          "(e) params within the summed lr, 99.9% within 1e-6")
    same_state(t["train_filter"], np_state(tstate.filter_state),
               "(e) the data filter's sketch")
    same_state(t["train_monitor"], np_state(tstate.monitor.ace),
               "(e) the gradient monitor's sketch")
    # (f) GPipe
    err = float((res[(2, 0)][1]["pipe"] - seq.cpu()).abs().max())
    check(torch.allclose(res[(2, 0)][1]["pipe"], seq.cpu(), rtol=2e-5,
                         atol=2e-5),
          f"(f) GPipe over 2 stages against the sequential stages (max abs "
          f"{err:.3g}; bubble {DI_PIPE['S'] - 1}/"
          f"{DI_PIPE['S'] + DI_PIPE['M'] - 1})")
    print(f"  (f) tally of a rank: {res[(2, 0)][0]['tally']['pipe']}")
    dist_life_checks(life_one, res, card)
    return paths


def dist_life_checks(life_one: dict, res: dict, card: str) -> None:
    """(g): each rank's lifecycle against this process's on the same W,
    traffic and flips: verdicts, every report, ``degraded`` and
    ``_rewarm_admits``, the admit of recovery, the masked μ, the repaired
    and final states (and a ring's re-anchored ssq) bitwise; one D2H an
    admit and a health_check; the flipped tables exactly the flagged
    ones; the three kernels launched, no fused admission."""
    for name, (fields, layout) in DI_LIFE.items():
        one = life_one[name]
        fleet = "num_tenants" in fields
        L, T = DI_L, DI_T if fleet else 1
        first = one["reports"][0][:T * L].reshape(T, L).numpy()
        flagged = {(int(t), int(j)) for t, j in np.argwhere(~first)}
        flipped = {(lead if fleet else 0, j)
                   for lead, j, _, _ in dist_life_flips(name)}
        check(flagged == flipped, f"(g) {name}: the audit flags exactly "
              f"the flipped tables {sorted(flipped)}")
        check(one["landed"] >= 0, f"(g) {name}: one process recovers "
              f"within {DI_LIFE_REWARM} admits")
        for r in range(2):
            js, t = res[(2, r)]
            info, got = js["life"][name], t[f"life_{name}"]
            what = f"(g) {name} {layout} rank {r}"
            want_masks = one["masks"][:, r:r + 1] if fleet else one["masks"]
            check(torch.equal(got["masks"], want_masks),
                  f"{what}: verdicts bitwise the one process's at every "
                  "admit")
            check(torch.equal(got["reports"], one["reports"])
                  and info["flags"] == one["flags"]
                  and info["landed"] == one["landed"],
                  f"{what}: every report, degraded flag and re-warm "
                  f"countdown equal, recovered at the same admit "
                  f"({one['landed'] + 1} after the repair)")
            per = DI_T // 2
            want_mu = one["mu"][r * per:(r + 1) * per] if fleet \
                else one["mu"]
            check(torch.equal(got["mu"], want_mu), f"{what}: masked μ "
                  "bitwise")
            same_state(got["repaired"], one["repaired"], f"{what} repaired")
            same_state(got["final"], one["final"], f"{what} final")
            if "ssq" in one:
                check(torch.equal(got["ssq"], one["ssq"]),
                      f"{what}: the repaired ring's ssq bitwise")
            check(set(info["d2h_admit"]) == {1}
                  and set(info["d2h_check"]) == {1},
                  f"{what}: one D2H an admit (degraded or not) and a "
                  "health_check")
            launched = js["paths"][f"dist_life_{name}_r{r}"]["launches"]
            check(all(launched[k] > 0 for k in ("srp_hash", "ace_query",
                                                "ace_update"))
                  and launched["ace_admit_fused"] == 0,
                  f"{what}: srp_hash, ace_query_sum and ace_update "
                  "launched, no fused admission")
        info = res[(2, 0)][0]["life"][name]
        print(f"  (g) {name} {layout}: flagged {len(flagged)} tables; "
              f"health_check {info['health_check_ms']:.3f} ms, repair "
              f"{info['repair_ms']:.3f} ms at world 2 (one process "
              f"{one['health_check_ms']:.3f} / {one['repair_ms']:.3f} ms); "
              f"in turns, admit p50 degraded {info['degraded_p50_ms']:.3f} "
              f"ms, healthy {info['healthy_p50_ms']:.3f} ms (host clock); "
              f"collectives of a degraded admit "
              f"{info['degraded_collectives']}, of a healthy one "
              f"{info['healthy_collectives']}; recovered "
              f"{one['landed'] + 1} admits after the repair ({card})")


# ---------------------------------------------------------------------------
# Phase 20: the dry run (launch.dryrun, dist.roofline) on ``meta``, its
# one-card prediction against phases 15 and 17, its planned collectives
# against live ranks, and the training features a sharded run takes
# ---------------------------------------------------------------------------

DR_DIR = ROOT / "build" / "dryrun"
DR_DEVICE = "cuda"                       # the ranks' device
DR_TIMEOUT = 400                         # seconds the ranks may take
DR_CELLS = (("olmo_1b", "train_4k"), ("mixtral_8x7b", "prefill_32k"),
            ("jamba_v01_52b", "decode_32k"), ("rwkv6_7b", "long_500k"))
DR_STEPS = 4                             # (d): each run's steps
# (d): name -> (TrainConfig fields, (data, model) mesh, sketch layout)
DR_FEATURES = {
    "adafactor": (dict(optimizer="adafactor"), (2, 1), None),
    "adafactor_2x2": (dict(optimizer="adafactor"), (2, 2), None),
    "compression": (dict(grad_compression=True), (2, 1), None),
    "chunked": (dict(filter_chunk=2), (1, 2), "table_sharded"),
    "ckpt": (dict(grad_compression=True, ckpt_interval=2), (2, 1), None),
}
# (c): world -> the live steps held to the step on meta (TrainConfig fields,
# layout)
DR_PLANS = {2: ((dict(), None),
                (dict(optimizer="adafactor", grad_compression=True), None)),
            4: ((dict(), "table_sharded"),
                (dict(optimizer="adafactor", grad_compression=True),
                 "table_sharded"))}


def dr_config(name=None, **kw):
    """Reduced olmo_1b's TrainConfig of phase 19 (e), with a feature's
    fields."""
    fields = DR_FEATURES[name][0] if name else {}
    return train_config(peak_lr=1e-3, total_steps=16, device=DR_DEVICE,
                        **{**fields, **kw})


def dr_specs(arch, mesh):
    """``launch.train``'s specs: the mesh's rules, FSDP, divisibility."""
    from repro_torch.dist import mesh as dm
    from repro_torch.models.common import set_rules
    set_rules(dm.rules_for(mesh))
    shapes = arch.abstract_params()[0]
    specs = dm.sharding_tree_for(
        mesh, dm.fsdp_tree(arch.param_pspecs(), shapes, mesh), shapes)
    set_rules({})
    return specs


def dr_stream(arch):
    from repro_torch.data.pipeline import DataStream, StreamConfig
    return DataStream(StreamConfig(vocab_size=arch.cfg.vocab_size,
                                   seq_len=REDUCED_S, global_batch=REDUCED_B,
                                   seed=SEED))


def dr_run(name, mesh=None, steps=DR_STEPS, **kw):
    """A feature's run of reduced olmo_1b: over ``mesh`` (this rank's
    blocks, the feature's sketch layout) or on one process.  Returns
    (state, history, specs or None)."""
    from repro_torch.models import Arch
    from repro_torch.train import sharded
    from repro_torch.train.train_loop import init_train_state, train
    arch = Arch("olmo_1b", reduced=True)
    tcfg = dr_config(name, **kw)
    if mesh is None:
        state, hist = train(arch, tcfg, dr_stream(arch), steps, log_every=0)
        return state, hist, None
    layout = DR_FEATURES[name][2]
    specs = dr_specs(arch, mesh)
    state = sharded.shard_train_state(init_train_state(arch, tcfg), arch,
                                      tcfg, mesh, specs, layout)
    state, hist = train(arch, tcfg, dr_stream(arch), steps, log_every=0,
                        state=state, mesh=mesh, grad_pspecs=specs,
                        sketch_layout=layout)
    return state, hist, specs


def dr_params(state, specs=None, mesh=None) -> torch.Tensor:
    from repro_torch.models.registry import leaves
    from repro_torch.train import sharded
    params = state.params if specs is None else sharded.gather_params(
        state.params, specs, mesh)
    return torch.cat([t.reshape(-1).float().cpu() for t in leaves(params)])


def dryrun_child(world: int, rank: int, root: Path) -> int:
    """One rank of phase 20, run as ``chip_smoke.py --dryrun-child WORLD
    RANK DIR``: (c) one live step of each ``DR_PLANS[world]`` case with
    its tally, and at world 2 (d) every ``DR_FEATURES`` run and the
    checkpointed run resumed from its step 2; a JSON of launches, tallies
    and histories and a ``.pt`` of gathered parameters under DIR."""
    import torch.distributed as dist
    mods = import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist import collectives as col
    from repro_torch.dist.mesh import make_debug_mesh
    from repro_torch.kernels import build
    from repro_torch.models import Arch
    from repro_torch.train import sharded
    from repro_torch.train import train_loop as tl
    device = torch.device(DR_DEVICE)
    if device.type == "cuda":
        torch.cuda.set_device(0)
        for name in build.sources():
            build.load(name)
    dist.init_process_group("gloo", init_method=f"file://{root}/init{world}",
                            rank=rank, world_size=world)
    out = {"rank": rank, "world": world, "paths": {}, "tally": {},
           "hist": {}}
    tensors = {}

    def part(name, fn):
        reset_launches(mods)
        res = fn()
        out["paths"][f"dryrun_{name}_r{rank}"] = {
            "launches": read_launches(mods)}
        return res

    def mesh_of(shape):
        return make_debug_mesh(data=shape[0], model=shape[1],
                               device_type=device.type)

    try:
        mesh = mesh_of((2, world // 2))
        arch = Arch("olmo_1b", reduced=True)
        specs = dr_specs(arch, mesh)
        for i, (fields, layout) in enumerate(DR_PLANS[world]):
            tcfg = dr_config(**fields)
            state = sharded.shard_train_state(
                tl.init_train_state(arch, tcfg), arch, tcfg, mesh, specs,
                layout)
            step = tl.make_train_step(arch, tcfg, specs, layout, mesh)
            batch = tl._to_device({k: v for k, v in next(dr_stream(arch))
                                   .items() if not k.startswith("_")},
                                  device)
            with col.tallied() as tally:
                part(f"plan{i}", lambda: step(state, batch))
            out["tally"][f"plan{i}"] = tally.snapshot()
            del state, step
        for name, (_, shape, _) in DR_FEATURES.items():
            if shape[0] * shape[1] != world:
                continue
            m = mesh_of(shape)
            kw = {"ckpt_dir": str(root / "ckpt")} if name == "ckpt" \
                else {}
            st, hist, sp = part(name, lambda: dr_run(name, m, **kw))
            tensors[name] = dr_params(st, sp, m)
            out["hist"][name] = hist
        if world == 2:
            resumed = root / "resumed_w2"
            if rank == 0:
                resumed.mkdir()
                shutil.copytree(root / "ckpt" / f"step_{2:010d}",
                                resumed / f"step_{2:010d}")
            dist.barrier()
            m = mesh_of(DR_FEATURES["ckpt"][1])
            st, hist, sp = part("resumed", lambda: dr_run(
                "ckpt", m, steps=DR_STEPS - 2, ckpt_dir=str(resumed)))
            tensors["resumed"] = dr_params(st, sp, m)
            out["hist"]["resumed"] = hist
    finally:
        dist.destroy_process_group()
    torch.save(tensors, root / f"w{world}_r{rank}.pt")
    (root / f"w{world}_r{rank}.json").write_text(json.dumps(out))
    return 0


def spawn_dryrun_ranks(world: int, root: Path) -> list:
    procs = []
    for r in range(world):
        log = open(root / f"w{world}_r{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-child",
             str(world), str(r), str(root)], stdout=log,
            stderr=subprocess.STDOUT, cwd=str(ROOT)))
    return procs


def dr_agree(what, hist, params, want_hist, want_params, card) -> None:
    """Phase 19 (e)'s tolerances: keep fractions and verdicts exact,
    losses within rtol 1e-5, parameters within the summed lr and 99.9%
    within 1e-6."""
    for k in ("filter_keep_frac", "grad_anomaly"):
        check([h.get(k) for h in hist] == [h.get(k) for h in want_hist],
              f"{what}: {k} equal step for step")
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(hist, want_hist))
    diffs = (params - want_params).abs()
    lr_sum = sum(h["lr"] for h in want_hist)
    share = float((diffs <= 1e-6).float().mean())
    print(f"  {what}: loss rel err {loss_err:.3g}, params max abs "
          f"{float(diffs.max()):.3g} ({share:.6f} within 1e-6) ({card})")
    check(len(hist) == len(want_hist) and loss_err <= 1e-5,
          f"{what}: losses within rtol 1e-5")
    check(float(diffs.max()) <= lr_sum and share >= 0.999,
          f"{what}: params within the summed lr, 99.9% within 1e-6")


def dr_predictions(card, measured) -> None:
    """(b): the dry run of phase 17's olmo_1b step and phase 15's olmo_1b
    prefill on one card (a 1 × 1 mesh, float32 parameters as the card ran
    them), against their measured times and peak memory."""
    from repro_torch.dist import roofline as rf
    from repro_torch.dist.mesh import MeshShape
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import Arch
    from repro_torch.models.registry import ShapeSpec
    one = MeshShape((1, 1), ("data", "model"))
    arch = Arch("olmo_1b")
    cells = (
        ("phase 17 step (B 8 x S 128, 2 microbatches, AdamW)", dr.dry_run(
            arch, ShapeSpec("train_b8_s128", TRAIN_S, TRAIN_B, "train"), one,
            policy=dr.CellPolicy("adamw", 2),
            tcfg=train_config(microbatches=2)),
         measured["train_step_ms"], measured["train_peak"]),
        ("phase 15 prefill (B 64 x 128)", dr.dry_run(
            arch, ShapeSpec("prefill_b64_s128", SERVE_PROMPT, SERVE_B,
                            "prefill"), one,
            policy=dr.CellPolicy("adamw", 1)),
         measured["prefill_ms"], measured["prefill_peak"]))
    for what, cell, ms, peak in cells:
        check(cell.ok, f"(b) olmo_1b {what}: dry run ok "
              f"({(cell.error or '').splitlines()[:1]})")
        row = rf.build_row(dataclasses.asdict(cell))
        args = cell.memory["args"]
        args_s = args / rf.HBM_BW
        s = ms / 1e3
        print(f"  (b) olmo_1b {what}: predicted flops {cell.flops:.6g}, "
              f"bytes {cell.bytes_accessed:.6g}, compute_s "
              f"{row.compute_s:.6g}, memory_s {row.memory_s:.6g}, bound_s "
              f"{row.bound_s:.6g} ({row.dominant}), memory.args {args:,} B "
              f"({args_s:.6g} s at HBM rate); measured {ms:.3f} ms = "
              f"{s / row.bound_s:.3f} x bound_s, {s / row.compute_s:.2f} x "
              f"compute_s; peak {peak:,} B ({card})")
        check(s >= max(row.compute_s, args_s),
              f"(b) olmo_1b {what}: measured {ms:.3f} ms >= the compute "
              f"bound {1e3 * row.compute_s:.3f} ms and the state-bytes "
              f"bound {1e3 * args_s:.3f} ms")
        check(args <= peak, f"(b) olmo_1b {what}: memory.args {args:,} B <= "
              f"max_memory_allocated {peak:,} B")


def phase_dryrun(mods, device, card, measured) -> dict:
    """Phase 20 (the module docstring).  The ranks (world 2 and world 4,
    at once) start first; this process meanwhile runs (a) and (b) on
    ``meta`` and the one-process runs of (d) on the card, then reads the
    ranks' results."""
    from repro_torch.dist import roofline as rf
    from repro_torch.dist.mesh import MeshShape
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import Arch
    from repro_torch.train import sharded
    shutil.rmtree(DR_DIR, ignore_errors=True)
    DR_DIR.mkdir(parents=True)
    groups = {w: spawn_dryrun_ranks(w, DR_DIR) for w in (2, 4)}
    try:
        t0 = time.perf_counter()
        rows = []
        for arch_name, shape_name in DR_CELLS:
            for multi_pod in (False, True):
                cell = dataclasses.asdict(dr.run_cell(arch_name, shape_name,
                                                      multi_pod))
                tag = f"{arch_name}__{shape_name}__{cell['mesh']}"
                (DR_DIR / f"{tag}.json").write_text(json.dumps(cell))
                check(cell["ok"] and cell["collectives"]["total_bytes"] > 0,
                      f"(a) {tag} on meta: ok, "
                      f"{cell['collectives']['total_bytes'] if cell['ok'] else 0:,.0f}"
                      f" B of collectives a rank, {cell['seconds']} s"
                      + ("" if cell["ok"] else f": {cell['error']}"))
                rows.append(rf.build_row(cell))
        print(f"  (a) {len(rows)} cells on meta in "
              f"{time.perf_counter() - t0:.1f} s; roofline at H100 SXM5 "
              f"datasheet rates ({rf.PEAK_FLOPS:.4g} FLOP/s bf16, "
              f"{rf.HBM_BW:.4g} B/s HBM, {rf.INTERNODE_BW:.4g} B/s between "
              f"nodes), beside this card ({card}):")
        for line in rf.format_table(rows).splitlines():
            print(f"  {line}")
        dr_predictions(card, measured)
        baselines = {name: dr_run(name) for name in DR_FEATURES}
        arch = Arch("olmo_1b", reduced=True)
        batch = {k: torch.empty(np.shape(v), dtype=torch.as_tensor(v).dtype,
                                device="meta")
                 for k, v in next(dr_stream(arch)).items()
                 if not k.startswith("_")}
        plans = {}
        for world, cases in DR_PLANS.items():
            mesh = MeshShape((2, world // 2), ("data", "model"))
            specs = dr_specs(arch, mesh)
            plans[world] = [sharded.step_on_meta(
                arch, dr_config(**fields), specs, layout, mesh, batch)
                for fields, layout in cases]
        t1 = time.perf_counter()
        for world, procs in groups.items():
            wait_ranks(procs, world, DR_DIR, 20, DR_TIMEOUT)
        print(f"  the ranks' results after {time.perf_counter() - t1:.1f} s "
              "more")
    finally:
        for procs in groups.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    res = {(w, r): (json.loads((DR_DIR / f"w{w}_r{r}.json").read_text()),
                    torch.load(DR_DIR / f"w{w}_r{r}.pt"))
           for w in (2, 4) for r in range(w)}
    paths = {}
    # (c) the step on meta against every rank's tally
    for (w, r), (js, _) in res.items():
        for i, plan in enumerate(plans[w]):
            tally = js["tally"][f"plan{i}"]
            fields, layout = DR_PLANS[w][i]
            check(tally == plan, f"(c) world {w} rank {r}, "
                  f"{fields or 'adamw'}, sketches {layout}: tally equals "
                  f"the step's on meta by kind, bytes, calls and axis "
                  f"({plan['total_bytes']:,} B: " + ", ".join(
                      f"{k} {v['count']} x {v['bytes']:,} B"
                      for k, v in plan.items() if isinstance(v, dict)
                      and "count" in v) + ")")
        for name, p in js["paths"].items():
            part = name[len("dryrun_"):name.rindex("_r")]
            launched = p["launches"]
            check(all(launched[k] > 0 for k in ("srp_hash", "ace_query",
                                                "ace_update")),
                  f"(c)/(d) {part} rank {r} of {w}: srp_hash, "
                  "ace_query_sum and ace_update launched")
            total = paths.setdefault(f"dryrun_{part}_w{w}", {
                "launches": dict.fromkeys(launched, 0)})["launches"]
            for k, v in launched.items():
                total[k] += v
    # (d) the features at world 2 and 4 against one process
    for name, (st, hist, _) in baselines.items():
        shape = DR_FEATURES[name][1]
        world = shape[0] * shape[1]
        js, t = res[(world, 0)]
        dr_agree(f"(d) {name} at world {world} {shape}, against one "
                 "process", js["hist"][name], t[name], hist, dr_params(st),
                 card)
    js, t = res[(2, 0)]
    one_st, one_hist, _ = baselines["ckpt"]
    resumed = DR_DIR / "resumed_w1"
    resumed.mkdir()
    shutil.copytree(DR_DIR / "ckpt" / f"step_{2:010d}",
                    resumed / f"step_{2:010d}")
    st, hist, _ = dr_run("ckpt", steps=DR_STEPS - 2, ckpt_dir=str(resumed))
    dr_agree("(d) world-2 checkpoint of step 2 resumed at world 2",
             js["hist"]["resumed"], t["resumed"], one_hist[2:],
             dr_params(one_st), card)
    dr_agree("(d) world-2 checkpoint of step 2 resumed at world 1",
             hist, dr_params(st), one_hist[2:], dr_params(one_st), card)
    return paths


# ---------------------------------------------------------------------------
# Phase 21: the compile-once contract — Guardrail.admit and
# StreamRunner.consume as one captured CUDA graph a signature, against
# their eager twins.
# ---------------------------------------------------------------------------

CAP_MODES = ("mu_sigma", "quantile")
CAP_DEGRADED = 4             # degraded admits after phase 11's flips
CAP_REWARM = 20              # admits the re-warm may take (windows: 16)
CAP_TURNS = 12               # timed admits each, captured and eager
CAP_CHUNKS = 3               # phase 5's chunks a stream kind
CAP_STREAMS = {"dense": ("dense", {}), "srht": ("srht", {}),
               "window": ("window", {}), "fleet": ("fleet", {}),
               "fleet_attr": ("fleet", ATTR_KW),
               "fleet_quantile": ("fleet", dict(threshold_mode="quantile",
                                                quantile_q=QUANT_Q)),
               "dense_masks": ("dense", {})}
# every kernel of these paths, each launched inside a captured graph
# (``ace_window_combine`` is the windowed query's, ``ops.ace_window_score``:
# a windowed admit reads its ring through ``ace_query_sum`` at base rows)
CAP_KERNELS = ("srp_hash", "ace_update", "ace_query", "ace_admit_fused",
               "ace_fleet_window_admit", "srht_hash", "attr_find_hh")


def launch_delta(mods, fn, into: dict):
    """``fn()``, its kernel launches added to ``into``."""
    before = read_launches(mods)
    out = fn()
    for k, v in read_launches(mods).items():
        into[k] = into.get(k, 0) + v - before[k]
    return out


def graph_tallies(mods, program) -> dict:
    """Kernel name -> launches one replay of each of ``program``'s graphs
    adds, summed over its graphs; checks every key has a graph."""
    names = {id(c): k for k, c in launch_counters(mods).items()}
    out = {}
    for entry in program._entries.values():
        check(entry.graph is not None, f"{program.name}: every signature "
              "replays a captured torch.cuda.CUDAGraph")
        for kernel, n in entry.tally.items():
            name = names[id(kernel)]
            out[name] = out.get(name, 0) + n
    return out


def replays_add_tally(mods, program, run, what: str, n=3) -> None:
    """``run`` (a replay of one signature) n times under sync-debug
    "error": no sync, and each kernel's ``launches`` grows by n × that
    graph's tally."""
    run()
    sync(program.device)
    entry = program._last
    before = {k: k.launches for k in entry.tally}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(entry.tally and all(k.launches - before[k] == n * c
                              for k, c in entry.tally.items()),
          f"{what}: {n} replays under sync-debug 'error', no sync, each "
          f"kernel's launches grown by {n} x the capture's tally "
          f"({sum(entry.tally.values())} launches a replay)")


def idle_line(tr: dict) -> str:
    if not tr["device_ops"]:
        return "no device op in the trace (idle share not measured)"
    return (f"{tr['device_ops']} device ops, busy {tr['device_busy_ms']:.3f} "
            f"ms of {tr['profiled_wall_ms']:.3f} ms (idle share "
            f"{1 - tr['device_busy_ms'] / tr['profiled_wall_ms']:.3f})")


def captured_guardrail(mods, device, kind, mode, d_model=D_MODEL,
                       b=ADMIT_B, s=ADMIT_S) -> dict:
    """One ``Guardrail`` flavour and threshold mode at phase 6's shapes,
    captured, in lockstep with its twin under ``capture.disabled()`` (same
    W, the same batches): warm-up, phase 11's flips, degraded admits,
    repair and re-warm, healthy again — verdicts and states bitwise every
    admit, one D2H an admit, two graphs; replays without a sync adding
    their tally; then p50 in turns and one traced admit each way."""
    import repro_torch.serve.engine as engine
    from repro_torch import resilience as rz
    from repro_torch.core import capture
    gcfg = engine.GuardrailConfig(d_model=d_model, num_bits=K_BITS,
                                  num_tables=L_TABLES, threshold_mode=mode,
                                  quantile_q=QUANT_Q, **RES_KINDS[kind])
    T = gcfg.num_tenants if gcfg.num_tenants > 1 else None
    L = L_TABLES
    g = engine.Guardrail(gcfg, device=device)
    eager = engine.Guardrail(gcfg, device=device, w=g.w)
    stream = RequestStream(device, d_model, b, s, T)
    launches, bad, d2h = {}, [], []
    real_to_host = engine._to_host

    def to_host(x):
        d2h.append(tuple(x.shape))
        return real_to_host(x)

    def both(e, t, where):
        n0 = len(d2h)
        got = launch_delta(mods, lambda: g.admit(e, t), launches)
        if len(d2h) - n0 != 1:
            bad.append(f"{where}: {len(d2h) - n0} D2H")
        with capture.disabled():
            want = eager.admit(e, t)
        if not (np.array_equal(got, want)
                and states_equal(g.state, eager.state)):
            bad.append(where)

    engine._to_host = to_host
    try:
        for i in range(RES_WARM):
            both(*stream.next(), f"warm {i}")
        gen = torch.Generator(device=device).manual_seed(SEED + 11)
        tables = sorted(torch.randperm(L, generator=gen, device=device)
                        [:-(-L // 4)].tolist())
        counts = g.state.counts
        for j in tables:
            counts = rz.flip_count_bits(counts, gen, num_flips=2,
                                        tables=(j,))
        g.state = g.state._replace(counts=counts)       # copied in
        eager.state = eager.state._replace(counts=counts.clone())
        check(reports_equal(g.health_check(), eager.health_check())
              and g.degraded and eager.degraded,
              f"captured {kind} ({mode}): phase 11's flips found alike, "
              "both degraded")
        for i in range(CAP_DEGRADED):
            both(*stream.next(), f"degraded {i}")
        check(reports_equal(g.repair(), eager.repair()),
              f"captured {kind} ({mode}): repair reports equal")
        rewarm = None
        for i in range(CAP_REWARM):
            both(*stream.next(), f"re-warm {i}")
            g.health_check()
            eager.health_check()
            if g.degraded != eager.degraded:
                bad.append(f"re-warm {i}: degraded flags differ")
            if not g.degraded:
                rewarm = i + 1
                break
        for i in range(2):
            both(*stream.next(), f"healthy {i}")
    finally:
        engine._to_host = real_to_host
    admits = RES_WARM + CAP_DEGRADED + (rewarm or CAP_REWARM) + 2
    check(not bad and rewarm is not None,
          f"captured {kind} ({mode}): {admits} admits (healthy, degraded, "
          f"re-warm in {rewarm}, healthy) with verdicts and states bitwise "
          f"the eager twin's, one D2H each{'' if not bad else f' ({bad})'}")
    check(g.trace_count == 2 and eager.trace_count == 0,
          f"captured {kind} ({mode}): trace_count {g.trace_count} (healthy "
          "and degraded signatures)")
    tallies = graph_tallies(mods, g._program)
    e, t = stream.next()
    tdev = None if t is None else torch.as_tensor(t, device=device)
    replays_add_tally(mods, g._program, lambda: g._admit_device(e, tdev),
                      f"captured {kind} ({mode}) healthy admit")
    mask = torch.ones((T, L) if T else (L,), device=device)
    mask[..., 3] = 0.0
    g._table_mask = mask
    replays_add_tally(mods, g._program, lambda: g._admit_device(e, tdev),
                      f"captured {kind} ({mode}) degraded admit")
    g._table_mask = None
    mirror(eager, g)

    lat = {"captured": [], "eager": []}
    for i in range(CAP_TURNS):
        e, t = stream.next()
        for arm in (("captured", "eager") if i % 2 == 0
                    else ("eager", "captured")):
            with contextlib.ExitStack() as ctx:
                if arm == "eager":
                    ctx.enter_context(capture.disabled())
                t0 = time.perf_counter()
                (g if arm == "captured" else eager).admit(e, t)
                lat[arm].append(1e3 * (time.perf_counter() - t0))
    ms = {k: p50(v) for k, v in lat.items()}
    out = {"launches": launches, "tallies": tallies,
           "p50_ms": ms["captured"], "eager_p50_ms": ms["eager"],
           "items_per_s": b / ms["captured"] * 1e3,
           "eager_items_per_s": b / ms["eager"] * 1e3, "rewarm": rewarm}
    line = (f"  captured {kind} ({mode}): admit p50 {ms['captured']:.3f} ms "
            f"({out['items_per_s']:,.0f} items/s), eager "
            f"{ms['eager']:.3f} ms ({out['eager_items_per_s']:,.0f} "
            f"items/s), in turns ({CAP_TURNS} each, host clock, each ends "
            f"in its D2H); one D2H an admit; trace_count 2")
    print(line)
    if mode == "mu_sigma":
        e, t = stream.next()
        tr = device_trace(lambda: g.admit(e, t), device)
        with capture.disabled():
            tr_e = device_trace(lambda: eager.admit(e, t), device)
        print(f"    one traced admit: captured {idle_line(tr)}; eager "
              f"{idle_line(tr_e)}")
        out.update(trace=tr, eager_trace=tr_e)
    return out


def embeds_or_features(device, d_model=D_MODEL, b=ADMIT_B,
                       s=ADMIT_S) -> dict:
    """What the flat admit's program starts from, measured: the copy of
    the (B, S, D) embeds into its static buffer (the graph then
    featurises), against featurising eagerly (``mean_embed_features`` and
    the quarantine select) and copying the (B, D + 1) features."""
    from repro_torch.data.pipeline import mean_embed_features
    from repro_torch.serve.engine import GuardrailConfig
    bias = GuardrailConfig(d_model=d_model).bias_const
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    e = torch.randn((b, s, d_model), generator=gen, device=device)
    static = torch.empty_like(e)

    def featurise():
        f = mean_embed_features(e, bias)
        return torch.where(torch.isfinite(f).all(-1)[:, None], f, 0.0)
    f = featurise()
    fstatic = torch.empty_like(f)
    out = {"embeds_copy_ms": device_ms(lambda: static.copy_(e)),
           "featurise_ms": device_ms(featurise),
           "features_copy_ms": device_ms(lambda: fstatic.copy_(f))}
    print(f"  the admit's program input at ({b}, {s}, {d_model}) float32: "
          f"embeds copy {out['embeds_copy_ms']:.5f} ms "
          f"({e.numel() * 4 / 2**20:.0f} MiB D2D); featurising eagerly "
          f"instead {out['featurise_ms']:.5f} ms + the ({b}, {d_model + 1}) "
          f"features' copy {out['features_copy_ms']:.5f} ms (CUDA events)")
    return out


def captured_stream(mods, device, kind, feats, tids, T=STREAM_T,
                    B=STREAM_B) -> dict:
    """One stream kind at phase 5's shapes, captured, against a twin
    runner under ``capture.disabled()`` on the same filter and W: chunk
    by chunk from identical states (the second with a health mask: a
    second graph), summaries, keep masks and states bitwise; then
    ``run`` both ways in turns from identical states (summaries and
    states bitwise, one H2D and one D2H a chunk, no sync in a captured
    ``consume``), replays adding their tally, one traced consume each
    way."""
    import repro_torch.stream.runner as runner_mod
    from repro_torch.core import capture
    base, extra = CAP_STREAMS[kind]
    fleet = base == "fleet"
    masks = kind.endswith("masks")
    filt = stream_filter(base, device, D_MODEL, **extra)
    r = runner_mod.StreamRunner(filt, chunk_T=T, return_masks=masks)
    twin = runner_mod.StreamRunner(filt, chunk_T=T, return_masks=masks)
    state, w = r.init()
    tstate = capture.tree_map(torch.clone, state)
    tids = tids if fleet else None
    chunks = len(feats) // T
    tmask = torch.ones((FLEET_T, STREAM_L) if fleet else (STREAM_L,),
                       device=device)
    tmask[..., 5] = 0.0
    launches, bad = {}, []
    for c in range(chunks):
        f = torch.as_tensor(feats[c * T:(c + 1) * T], device=device)
        tc = None if tids is None else torch.as_tensor(
            tids[c * T:(c + 1) * T], device=device)
        m = tmask if c == 1 else None
        out = launch_delta(mods, lambda: r.consume(state, w, f, tc,
                                                   table_mask=m), launches)
        with capture.disabled():
            tout = twin.consume(tstate, w, f, tc, table_mask=m)
        state, tstate = out[0], tout[0]
        if not (all((a is None and b is None) or torch.equal(a, b)
                    for a, b in zip(capture.leaves(out[1:]),
                                    capture.leaves(tout[1:])))
                and states_equal(state, tstate)):
            bad.append(f"chunk {c}")
    check(not bad, f"captured stream ({kind}): {chunks} chunks (one with a "
          "health mask) with summaries, keep masks and states bitwise the "
          f"eager twin's {bad or ''}")
    check(r.trace_count == 2 and twin.trace_count == 0,
          f"captured stream ({kind}): trace_count {r.trace_count} "
          "(healthy and masked signatures)")
    tallies = graph_tallies(mods, r._program)
    replays_add_tally(mods, r._program,
                      lambda: r.consume(state, w, f, tc),
                      f"captured stream ({kind}) consume")

    transfers = {"h2d": 0, "d2h": 0}
    real_in, real_out, real_consume = (runner_mod._to_device,
                                       runner_mod._to_host, r.consume)

    def to_device(x, to):
        transfers["h2d"] += 1
        return real_in(x, to)

    def to_host(x):
        transfers["d2h"] += 1
        return real_out(x)

    def consume_no_sync(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_consume(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    start = capture.tree_map(torch.clone, state)
    secs = {"captured": [], "eager": []}
    runs = {}
    for rnd in range(2):
        for arm in (("captured", "eager") if rnd == 0
                    else ("eager", "captured")):
            s0 = capture.tree_map(torch.clone, start)
            sync(device)
            with contextlib.ExitStack() as ctx:
                if arm == "eager":
                    ctx.enter_context(capture.disabled())
                    runner = twin
                else:
                    runner_mod._to_device, runner_mod._to_host = (to_device,
                                                                  to_host)
                    r.consume = consume_no_sync
                    ctx.callback(setattr, runner_mod, "_to_device", real_in)
                    ctx.callback(setattr, runner_mod, "_to_host", real_out)
                    ctx.callback(delattr, r, "consume")
                    runner = r
                t0 = time.perf_counter()
                runs[arm] = launch_delta(
                    mods, lambda: runner.run(s0, w, iter(feats),
                                             None if tids is None
                                             else iter(tids)),
                    launches if arm == "captured" else {})
                secs[arm].append(time.perf_counter() - t0)
    (sc, hc), (se, he) = runs["captured"], runs["eager"]
    same = states_equal(sc, se) and all(
        all(np.array_equal(x, y) for x, y in zip(a, b)
            if x is not None or y is not None) for a, b in zip(hc, he))
    check(same, f"captured stream ({kind}): run's summaries and final state "
          "bitwise the eager twin's")
    check(transfers == {"h2d": 2 * chunks, "d2h": 2 * chunks},
          f"captured stream ({kind}): one H2D (from the reused page-locked "
          f"buffer) and one D2H a chunk ({transfers} in 2 runs of {chunks})"
          ", no sync inside a captured consume")
    items = chunks * T * B
    ips = {k: items / min(v) for k, v in secs.items()}
    f = torch.as_tensor(feats[:T], device=device)
    tc = None if tids is None else torch.as_tensor(tids[:T], device=device)
    r.consume(sc, w, f, tc)
    tr = device_trace(lambda: r.consume(sc, w, f, tc), device)
    with capture.disabled():
        tr_e = device_trace(lambda: twin.consume(se, w, f, tc), device)
    print(f"  captured stream ({kind}): {ips['captured']:,.0f} items/s, "
          f"eager {ips['eager']:,.0f} items/s (run over {chunks} chunks of "
          f"{T} x {B} x {D_MODEL + 1}, better of 2 in turns, host clock); "
          f"one traced consume: captured {idle_line(tr)}; eager "
          f"{idle_line(tr_e)}")
    return {"launches": launches, "tallies": tallies,
            "items_per_s": ips["captured"], "eager_items_per_s": ips["eager"],
            "trace": tr, "eager_trace": tr_e}


def phase_captured(mods, device) -> dict:
    """Phase 21: every guardrail flavour in both threshold modes and every
    stream kind through its captured program against the eager twin."""
    out = {}
    for kind in RES_KINDS:
        for mode in CAP_MODES:
            out[f"captured_guardrail_{kind}_{mode}"] = captured_guardrail(
                mods, device, kind, mode)
    out["captured_input"] = embeds_or_features(device)
    feats, _ = stream_features(device, D_MODEL, CAP_CHUNKS, STREAM_T,
                               STREAM_B)
    tids = np.random.default_rng(SEED + 9).integers(
        0, FLEET_T, size=(len(feats), STREAM_B)).astype(np.int32)
    for kind in CAP_STREAMS:
        out[f"captured_stream_{kind}"] = captured_stream(mods, device, kind,
                                                         feats, tids)
    seen = set()
    for r in out.values():
        seen |= {k for k, n in r.get("tallies", {}).items() if n}
    check(set(CAP_KERNELS) <= seen, "every kernel of these paths launched "
          f"inside a captured graph: {sorted(seen)}")
    return out


# ---------------------------------------------------------------------------
# Phase 22: the five configurations the card had not run, served at their
# published widths.
# ---------------------------------------------------------------------------

# layers kept of each config (None: all).  At full depth the cut ones'
# float32 weights pass the card's 80 GB (gemma2_27b 108.9 GB, mistral_large
# 490.4, mixtral_8x22b 562.5); the depths kept (22.8, 25.4, 41.7 GB) leave
# room for the bf16 casts, the graphs' pools and the eager twin's peak, and
# gemma2 keeps whole (local, global) superblocks
CONFIG_LAYERS = {"qwen2_1_5b": None, "gemma2_27b": 8,
                 "mistral_large_123b": 4, "mixtral_8x22b": 4,
                 "qwen2_vl_7b": None}
CONFIG_FP32_LAYERS = 2      # float32 against forward (gemma2: a superblock)
WINDOW_PROMPT = 48          # gemma2's window cut to RING_WINDOW: a prompt
                            # past it, where the mask bites
SHADOW_BATCHES = 3          # seeded token batches after the served one in
                            # the guardrail's check against the plain path


def config_model(name, layers, device, card):
    """``name`` at its published widths with its first ``layers`` layers
    (all of them with None), the reason for a cut printed; its weights
    drawn on the card from SEED.  Returns (arch, params)."""
    from repro_torch.models import Arch
    from repro_torch.models.registry import leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arch = Arch(name)
    full = arch.cfg.num_layers
    if layers is not None:
        room = torch.cuda.get_device_properties(device).total_memory
        print(f"  {name}: all {full} layers' float32 weights, "
              f"{4 * arch.param_count() / 1e9:.1f} GB, pass the card's "
              f"{room / 1e9:.1f} GB: {layers} kept (CONFIG_LAYERS)")
        arch.cfg = dataclasses.replace(arch.cfg, num_layers=layers)
    t0 = time.perf_counter()
    params = arch.init_params(SEED, device=device)
    sync(device)
    n = sum(t.numel() for t in leaves(params))
    cfg = arch.cfg
    print(f"  {name} at full width (d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads over {cfg.num_kv_heads}, d_ff {cfg.d_ff}"
          + (f", {cfg.moe_num_experts} experts top-{cfg.moe_top_k}"
             if cfg.moe_num_experts else "")
          + f", vocab {cfg.vocab_size}), {cfg.num_layers} of {full} layers: "
          f"{n / 1e9:.3f} B float32 parameters, {4 * n / 1e9:.2f} GB, drawn "
          f"in {time.perf_counter() - t0:.2f} s ({card})")
    return arch, params


def fp32_embeds_against_forward(what, a, p, device, card) -> dict:
    """``fp32_against_forward`` for a model fed embeddings (qwen2_vl):
    2 seeded batches of 17 embeddings with M-RoPE positions whose three
    sections differ (t, h, w = i, i // 4, i % 4), prefill of 16 and one
    decode step on the 17th, against ``forward``."""
    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    e = torch.randn((2, 17, a.cfg.d_model), generator=gen, device=device)
    i = torch.arange(17, dtype=torch.int32, device=device)
    pos = torch.stack([i, i // 4, i % 4])[:, None].expand(3, 2, 17)
    full, _ = a.forward(p, {"embeds": e, "positions": pos})
    last, cache = a.prefill(p, {"embeds": e[:, :16],
                                "positions": pos[..., :16]}, s_max=32)
    step, _ = a.decode_step(p, {"embeds": e[:, 16:]}, cache, pos[..., 16])
    return logits_against_forward(what, last, step, full, 16, card)


def serve_embeds(device, card, what, arch, params) -> dict:
    """A model fed embeddings (qwen2_vl): the engine's prefill of SERVE_B
    seeded embedding batches of SERVE_PROMPT (M-RoPE positions i, i // 4,
    i % 4) captured and eager in turns (C E E C C E), logits and cache
    bitwise; then
    ``generate`` raises ``KeyError`` from the decode step's build, as the
    reference's does (ROADMAP queue 3 item 12)."""
    from repro_torch.serve import engine as E
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    i = torch.arange(SERVE_PROMPT, dtype=torch.int32, device=device)
    batch = {"embeds": torch.randn((SERVE_B, SERVE_PROMPT,
                                    arch.cfg.d_model), generator=gen,
                                   device=device),
             "positions": torch.stack([i, i // 4, i % 4])[:, None]
             .expand(3, SERVE_B, SERVE_PROMPT).contiguous()}
    eng = E.ServeEngine(arch, s_max=SERVE_SMAX, device=device)
    torch.cuda.reset_peak_memory_stats()
    eng._prefill(None, params, batch)           # builds the program
    pre, got = prefill_in_turns(eng, params, batch, device)
    (logits, cache), (elogits, ecache) = got["captured"], got["eager"]
    bitwise(what, "prefill logits", logits, elogits, card)
    bitwise(what, "prefill cache", cache, ecache, card)
    mem = memory_now(device)
    try:
        eng.generate(params, batch, num_new_tokens=2,
                     prompt_len=SERVE_PROMPT)
        raised = None
    except KeyError as err:
        raised = err
    check(raised is not None and "embeds" in str(raised),
          f"{what}: generate raises KeyError 'embeds' from the decode "
          f"step's build, as the reference's does ({raised!r})")
    check(eng.trace_counts == (1, 1), f"{what}: one prefill program and the "
          f"failed decode build, as the reference's jit caches count "
          f"(trace_counts {eng.trace_counts})")
    out = {"launches": {}, "trace_counts": eng.trace_counts,
           "prefill_ms": statistics.median(pre["captured"]),
           "eager_prefill_ms": statistics.median(pre["eager"]),
           "prefill_ms_runs": pre["captured"],
           "eager_prefill_ms_runs": pre["eager"], "memory": mem}
    print(f"  {what}: B {SERVE_B} x {SERVE_PROMPT} embeddings (M-RoPE); "
          f"captured / eager prefill "
          + ", ".join(f"{x:.3f}" for x in pre["captured"]) + " / "
          + ", ".join(f"{x:.3f}" for x in pre["eager"])
          + f" ms (turns C E E C C E; captured ÷ eager "
          f"{out['prefill_ms'] / out['eager_prefill_ms']:.3f}); logits and "
          f"cache bitwise; generate raised {raised!r}; trace_counts "
          f"{eng.trace_counts}; peak (max_memory_allocated) "
          f"{mem['max_memory_allocated'] / 2**30:.2f} GiB ({card})")
    return out


def gemma_window(what, arch, params, device, card) -> dict:
    """gemma2 with its window cut to RING_WINDOW, in float32: one
    superblock (local + global) against ``forward`` on prompts of
    WINDOW_PROMPT tokens, past the window, in a full cache; then its
    local layers alone (the global ones keep a full cache by design)
    as ``ring_against_full``.  Returns the max abs errors."""
    a, p = sub_model(arch, params, CONFIG_FP32_LAYERS, dtype="float32",
                     sliding_window=RING_WINDOW)
    errs = fp32_against_forward(
        f"{what} x{CONFIG_FP32_LAYERS} float32, window {RING_WINDOW}, "
        f"prompt {WINDOW_PROMPT}", a, p, device, card, prompt=WINDOW_PROMPT,
        s_max=2 * WINDOW_PROMPT)
    local, lp = sub_model(arch, params, CONFIG_FP32_LAYERS, dtype="float32",
                          sliding_window=RING_WINDOW, block_pattern=("swa",))
    lp = {**lp, "blocks": [[row[0]] for row in
                           params["blocks"][:CONFIG_FP32_LAYERS]]}
    ring_against_full(f"{what} local layers x{CONFIG_FP32_LAYERS} float32",
                      local, lp, device)
    return errs


def guardrail_against_plain(what, g, params, device, card) -> dict:
    """``g``'s admission kernels (``ace_admit_fused``, ``ace_query_sum``)
    at the served model's d_model held against the plain path: a
    plain-path guardrail on ``g``'s W starts from a copy of ``g``'s
    state, then both admit the served prompts' embedding rows (as
    ``generate`` screens them, B SERVE_B x SERVE_PROMPT) and
    SHADOW_BATCHES seeded batches of 128 x 4 embedding rows (the
    warm-up's shape), through ``g``'s captured programs;
    ``against_plain`` at the ids floor (masks agree on >= 0.999 of the
    rows).  Returns the rows, differing masks and displaced
    insertions."""
    from repro_torch.core import capture
    from repro_torch.serve.engine import Guardrail
    plain = Guardrail(g.gcfg, use_kernels=False, device=device, w=g.w)
    plain.state = capture.tree_map(torch.clone, g.state)
    vocab = params["embed"].shape[0]
    gen = torch.Generator(device=device).manual_seed(SEED + 34)
    toks = [prompts_for(device, vocab, SERVE_B, SERVE_PROMPT, SEED + 16)] \
        + [torch.randint(0, vocab, (128, 4), generator=gen, device=device)
           for _ in range(SHADOW_BATCHES)]
    embeds = [params["embed"][t.long()] for t in toks]
    masks = np.concatenate([g.admit(e) for e in embeds])
    plain_masks = np.concatenate([plain.admit(e) for e in embeds])
    moved = against_plain(f"{what} at d_model {g.gcfg.d_model}: ", g, plain,
                          masks, plain_masks, 0.999)
    out = {"rows": int(masks.size), "displaced": moved,
           "masks_differ": int((masks != plain_masks).sum())}
    print(f"  {what}: the guardrail's kernels against the plain path at "
          f"d_model {g.gcfg.d_model} from one state: {out['rows']} rows, "
          f"{out['masks_differ']} masks differ, {moved} displaced "
          f"insertions ({card})")
    return out


def phase_serve_configs(mods, device, card) -> dict:
    """The five configurations at their published widths: served, held
    captured against eager, and checked in float32 (module docstring,
    phase 22).  Each model is freed before the next is drawn."""
    from repro_torch.models.registry import leaves
    out = {}
    for name, layers in CONFIG_LAYERS.items():
        t0 = time.perf_counter()
        arch, params = config_model(name, layers, device, card)
        cfg = arch.cfg
        extra = {}
        if cfg.moe_num_experts:
            extra["moe_capacity_factor"] = (cfg.moe_num_experts
                                            / cfg.moe_top_k)
        a, p = sub_model(arch, params, CONFIG_FP32_LAYERS, dtype="float32",
                         **extra)
        fp32 = f"{name} x{CONFIG_FP32_LAYERS} float32"
        if cfg.input_mode == "embeds":
            res = serve_embeds(device, card, name, arch, params)
            res["fp32_err"] = fp32_embeds_against_forward(fp32, a, p, device,
                                                          card)
        else:
            g = serve_guardrail(device, params, cfg.vocab_size, cfg.d_model)
            res = serve_model(mods, device, name, arch, params, g, card,
                              exact=True)
            res["decode_step_ms"] = 1e3 * SERVE_B / res["decode_tokens_per_s"]
            res["guardrail_vs_plain"] = guardrail_against_plain(
                name, g, params, device, card)
            del g
            res["fp32_err"] = fp32_against_forward(fp32, a, p, device, card)
        if name == "gemma2_27b":
            res["window_err"] = gemma_window(name, arch, params, device,
                                             card)
        if name == "qwen2_1_5b":
            res["fp32_err"]["card_vs_cpu"] = card_against_cpu(
                arch, params, device, card, f"{name} float32")
        res["params"] = sum(t.numel() for t in leaves(params))
        res["layers"] = cfg.num_layers
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        res["seconds"] = time.perf_counter() - t0
        print(f"  {name}: float32 max abs against forward "
              + ", ".join(f"{k} {v:.3g}" for k, v in res["fp32_err"].items())
              + (", window: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                          res["window_err"].items())
                 if "window_err" in res else "")
              + (f"; captured decode step {res['decode_step_ms']:.3f} ms "
                 "(decode_throughput, 16 replays)"
                 if "decode_step_ms" in res else "")
              + f"; {res['seconds']:.1f} s ({card})")
        out[f"config_{name}"] = res
        del arch, params, a, p
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 23: the examples and the chaos drill as users run them.
# ---------------------------------------------------------------------------

EXAMPLES = {
    "quickstart": ["examples/quickstart_torch.py"],
    "fleet_serving": ["examples/fleet_serving_torch.py"],
    "streaming_detection": ["examples/streaming_detection_torch.py"],
    "drift_postmortem": ["examples/drift_postmortem_torch.py"],
    "chaos_report": ["scripts/chaos_report_torch.py", "--json",
                     "build/RESILIENCE_torch.json"],
}
EXAMPLE_TIMEOUT = 300


def example_figures(name: str, out: str) -> dict:
    """The figures an example prints, parsed, each checked against the
    example's own story."""
    def grab(pat, what):
        m = re.search(pat, out)
        check(m is not None, f"phase 23 {name}: prints {what}")
        return m.groups()

    if name == "quickstart":
        flagged, caught, anomalies = grab(
            r"flagged (\d+) \((\d+)/(\d+) true", "its flags")
        inverse, = grab(r"exact inverse: (\w+)", "the delete check")
        merged, = grab(r"bulk build: (\w+)", "the merge check")
        check(inverse == merged == "True", "phase 23 quickstart: delete + "
              "re-insert is an exact inverse of μ and shard-and-merge "
              "equals the bulk build")
        return {"flagged": int(flagged), "caught": f"{caught}/{anomalies}"}
    if name == "fleet_serving":
        traces, = grab(r"trace_count=(\d+)", "its trace count")
        caught, total = grab(r"bursts flagged: (\d+)/(\d+)", "its bursts")
        false, = grab(r"other \d+ tenants: (\d+)", "its neighbour flags")
        check("bitwise identical" in out and out.rstrip().endswith("OK"),
              "phase 23 fleet_serving: isolation bitwise, OK")
        return {"bursts": f"{caught}/{total}", "neighbour_flags": int(false),
                "trace_count": int(traces)}
    if name == "streaming_detection":
        caught, missed, false = grab(
            r"bursts caught (\d+), missed (\d+), clean batches falsely "
            r"flagged (\d+)", "its bursts")
        traces, = grab(r"built (\d+)x", "its trace count")
        figs = {"caught": int(caught), "missed": int(missed),
                "false_flags": int(false), "trace_count": int(traces)}
        for kind in ("frozen", "windowed"):
            pre = grab(rf"{kind}\s*: bursts pre-shift (\d+/\d+)\s+"
                       r"post-shift \(re-adapted\) (\d+/\d+)", kind)
            figs[kind] = {"pre_shift": pre[0], "post_shift": pre[1]}
        frozen, windowed = (int(figs[k]["post_shift"].split("/")[0])
                            for k in ("frozen", "windowed"))
        check(windowed > frozen and traces == "1", "phase 23 streaming: "
              "the window catches post-shift bursts the frozen sketch "
              f"misses ({windowed} > {frozen}), one chunk program")
        return figs
    if name == "drift_postmortem":
        check("all planted dims [3, 11, 17] named." in out,
              "phase 23 drift_postmortem: the planted dims named")
        offender, = grab(r"tenant (\d+) named as the offender", "offender")
        dims = [int(d) for d in re.findall(r"dim +(\d+) +drift", out)]
        return {"planted_named": dims, "offender": int(offender)}
    stages = re.findall(r"\[(ok|FAIL)\] (\w+):", out)
    check([s for _, s in stages] == ["baseline", "quarantine", "degrade",
                                     "repair", "checkpoint_fallback"]
          and all(v == "ok" for v, _ in stages), "phase 23 chaos_report: "
          f"the five stages in order, each ok ({stages})")
    programs, = grab(r"admission programs built: (\d+)", "its programs")
    report = json.loads((ROOT / "build" / "RESILIENCE_torch.json")
                        .read_text())
    check(report["ok"], "phase 23 chaos_report: the report's ok")
    return {"stages": [s for _, s in stages], "programs": int(programs),
            "quarantined_total": report["quarantined_total"]}


def phase_examples(card) -> dict:
    """The four ``examples/*_torch.py`` and ``scripts/chaos_report_torch.py``
    as a user runs them: each its own process (``PYTHONPATH=src python
    …``, on the card by default), all five at once; each must exit 0,
    and its printed figures are parsed and checked."""
    log = ROOT / "build" / "examples"
    log.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    t0 = time.perf_counter()
    for name, argv in EXAMPLES.items():
        with open(log / f"{name}.log", "w") as f:
            procs[name] = subprocess.Popen(
                [sys.executable, *argv], cwd=ROOT, env=env, stdout=f,
                stderr=subprocess.STDOUT)
    out = {}
    try:
        for name, proc in procs.items():
            try:
                rc = proc.wait(timeout=max(
                    1.0, EXAMPLE_TIMEOUT - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                rc = None
            text = (log / f"{name}.log").read_text()
            if rc != 0:
                print(f"  {name}'s output ends:\n{text[-3000:]}")
            check(rc == 0, f"phase 23 {name}: exits 0 (rc {rc})")
            out[name] = {"seconds": time.perf_counter() - t0,
                         **example_figures(name, text)}
            print(f"  {' '.join(EXAMPLES[name])}: exit 0 after "
                  f"{out[name]['seconds']:.1f} s; "
                  + ", ".join(f"{k} {v}" for k, v in out[name].items()
                              if k != "seconds") + f" ({card})")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--cluster-child"]:     # a phase-18 host process
        return cluster_child(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4]))
    if sys.argv[1:2] == ["--dist-child"]:        # a phase-19 rank
        return dist_child(int(sys.argv[2]), int(sys.argv[3]),
                          Path(sys.argv[4]))
    if sys.argv[1:2] == ["--dryrun-child"]:      # a phase-20 rank
        return dryrun_child(int(sys.argv[2]), int(sys.argv[3]),
                            Path(sys.argv[4]))
    mods = import_port()
    from repro_torch.core import capture
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain hash
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    print("phase 1: build")
    t0 = t_all = time.perf_counter()
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
    print("phase 2: the seven count-reading kernels in int16, int8 and "
          "float32 against their plain versions on the card")
    err_dt = phase_kernels_dtypes(mods, device)
    print("phase 2: the six hash kernels on bfloat16 and float16 x and W "
          "against their plain versions on the card")
    err_op = phase_kernels_operands(mods, device)
    op_admit = narrow_admit_path(mods, device)
    op_pair = narrow_admit_path(mods, device, pair=True)
    print("phase 3: AceEstimator path")
    paths = {"estimator": phase_estimator(mods, device),
             "estimator_srht": phase_estimator_srht(mods, device),
             "operands_admit_bfloat16": op_admit,
             "operands_admit_bfloat16_pair": op_pair}
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
    print("phase 8: the dense and SRHT hashes on bfloat16 and float16 "
          "operands, in turns with float32 (and the widening tile)")
    times_op = phase_timing_operands(mods, device)
    for k, v in {**time_query_paths(device),
                 **time_public_paths(device)}.items():
        print(f"  {k}: " + "; ".join(f"{r['shape']} {r['ms']:.5f} ms"
                                     for r in v["by_shape"]))
    print("phase 9: quantile admission (threshold_mode='quantile'): four "
          "Guardrail flavours, the calibration scenario, the fleet stream")
    for kind in QUANT_KINDS:
        paths[f"quantile_{kind}"] = phase_quantile_guardrail(mods, device,
                                                             kind)
        mu = paths["guardrail" if kind == "flat" else f"guardrail_{kind}"]
        qb, mb = paths[f"quantile_{kind}"]["breakdown"], mu["breakdown"]
        print(f"  admit ({kind}): quantile p50 "
              f"{paths[f'quantile_{kind}']['p50_ms']:.3f} ms, "
              f"{qb['device_ops']} device ops; mu-sigma (phase "
              f"{4 if kind == 'flat' else 6}) p50 {mu['p50_ms']:.3f} ms, "
              f"{mb['device_ops']} device ops")
    # eager: a captured chunk's replay would not call the recorder
    with recorded_bins() as seen, capture.disabled():
        paths["quantile_calibration"] = phase_calibration(mods, device)
    edges = bin_edge_counts(seen)
    print(f"  calibration bin ids: {edges['rates']:,} rates observed on the "
          f"card, {edges['near_edge']} within 4 ulp of a bin edge; "
          f"{edges['differ']} bin ids differ from bin_index of the same "
          f"rates on the CPU ({edges['differ_by_more_than_1']} by more "
          f"than one bin; rates {edges['differ_rates']})")
    check(edges["differ_by_more_than_1"] == 0, "no card bin id more than "
          "one bin off the CPU's")
    paths["quantile_stream"] = phase_quantile_stream(mods, device)
    print(f"  consume (fleet): quantile "
          f"{paths['quantile_stream']['breakdown']['device_ops']} device "
          f"ops, mu-sigma (phase 5) "
          f"{paths['stream_fleet']['breakdown']['device_ops']}")

    print("phase 10: narrow count planes (int16, int8; the flat sketch "
          "also with promotion) end to end, in turns with int32")
    paths.update(phase_narrow(mods, device, paths["estimator"]))
    times_dt = phase_timing_dtypes(mods, device)

    print("phase 11: resilience — health audit, degraded admission, repair, "
          "re-warm and checkpoints in the four Guardrail flavours")
    t11 = time.perf_counter()
    for kind in RES_KINDS:
        mu = paths["guardrail" if kind == "flat" else f"guardrail_{kind}"]
        res = phase_resilience(mods, device, kind,
                               mu["breakdown"]["device_ops"])
        paths[f"resilience_{kind}"] = res
        paths[f"resilience_{kind}_healthy"] = {
            "launches": res["healthy_launches"]}
    print(f"  phase 11 took {time.perf_counter() - t11:.1f} s")

    print("phase 12: the open-loop front end (FrontEnd over each Guardrail "
          "flavour): capacities, Poisson loads, lockstep, sheds")
    t12 = time.perf_counter()
    frontend = {}
    for kind in FE_LOADS:
        frontend[kind] = phase_frontend(mods, device, kind)
        for ratio, pt in frontend[kind]["loads"].items():
            paths[f"frontend_{kind}_x{ratio}"] = {"launches": pt["launches"]}
    print(f"  phase 12 took {time.perf_counter() - t12:.1f} s")

    print("phase 13: the private hash (paper section 4) on the KDD-Cup99 "
          "HTTP analogue")
    t13 = time.perf_counter()
    from repro_torch.data.synthetic import make_paper_dataset
    datasets = {name: make_paper_dataset(name, seed=SEED)
                for name in PAPER_K}
    paths["private_hash"] = phase_private_hash(
        mods, device, datasets["kddcup99_http"])
    print(f"  phase 13 took {time.perf_counter() - t13:.1f} s (the three "
          "datasets' generation included)")

    print("phase 14: the paper's comparison: ACE against its 11 baselines")
    t14 = time.perf_counter()
    paper_paths, tables = phase_paper(mods, device, datasets)
    paths.update(paper_paths)
    print(f"  phase 14 took {time.perf_counter() - t14:.1f} s")

    print("phase 15: a language model served behind the guardrail "
          "(ServeEngine.generate): Mixtral-8x7B at full width, olmo_1b")
    t15 = time.perf_counter()
    paths.update(phase_serve(mods, device, card))
    print(f"  phase 15 took {time.perf_counter() - t15:.1f} s")

    print("phase 16: the rest of the zoo served behind the guardrail: "
          "Jamba-v0.1 (one 8-layer superblock at full width), RWKV-6 7B, "
          "whisper_tiny")
    t16 = time.perf_counter()
    paths.update(phase_serve_zoo(mods, device, card))
    print(f"  phase 16 took {time.perf_counter() - t16:.1f} s")

    print("phase 17: training behind the data filter and the gradient "
          "monitor: olmo_1b at full size, reduced olmo_1b card vs CPU and "
          "restarts, the recurrences' backward at full width, poison")
    t17 = time.perf_counter()
    trained = phase_train(mods, device, card)
    paths.update({k: v for k, v in trained.items()
                  if not k.endswith("_differ") and "launches" in v})
    print(f"  phase 17 took {time.perf_counter() - t17:.1f} s")

    print("phase 18: the fault-tolerant multi-host fleet (repro_torch."
          "cluster): two host processes on the card, a kill, re-homing "
          "and a rejoin")
    t18 = time.perf_counter()
    paths.update(phase_cluster(mods, device, card))
    print(f"  phase 18 took {time.perf_counter() - t18:.1f} s")

    print("phase 19: repro_torch.dist as gloo ranks on the card: flat "
          "guardrails replicated and table-sharded, tenant-sharded fleets, "
          "the table-sharded stream, a K=18 L=200 sketch, ZeRO-2 training, "
          "GPipe, the sharded guardrails' audit, degraded admits and "
          "repair")
    t19 = time.perf_counter()
    paths.update(phase_dist(mods, device, card))
    print(f"  phase 19 took {time.perf_counter() - t19:.1f} s")

    print("phase 20: the dry run on meta (production cells, the roofline, "
          "the one-card prediction against phases 15 and 17), the planned "
          "collectives against gloo ranks' tallies, and Adafactor, "
          "compression, the chunked prefilter and checkpoints at world 2")
    t20 = time.perf_counter()
    paths.update(phase_dryrun(mods, device, card, {
        "train_step_ms": trained["train_olmo_microbatches"]["step_ms"],
        "train_peak": trained["train_olmo_microbatches"][
            "max_memory_allocated"],
        "prefill_ms": paths["serve_olmo"]["prefill_ms"],
        "prefill_peak": paths["serve_olmo"]["max_memory_allocated"]}))
    print(f"  phase 20 took {time.perf_counter() - t20:.1f} s")

    print("phase 21: the compile-once contract: each Guardrail flavour in "
          "both threshold modes and each stream kind as one captured CUDA "
          "graph a signature, against its eager twin (capture.disabled)")
    t21 = time.perf_counter()
    captured = phase_captured(mods, device)
    paths.update({k: v for k, v in captured.items() if "launches" in v})
    print(f"  phase 21 took {time.perf_counter() - t21:.1f} s; phases 1-21 "
          f"{time.perf_counter() - t_all:.1f} s")

    print("phase 22: the five configurations the card had not run, served "
          "at their published widths: qwen2_1_5b, gemma2_27b, "
          "mistral_large_123b, mixtral_8x22b, qwen2_vl_7b")
    t22 = time.perf_counter()
    configs = phase_serve_configs(mods, device, card)
    paths.update({k: v for k, v in configs.items() if v["launches"]})
    print(f"  phase 22 took {time.perf_counter() - t22:.1f} s")

    print("phase 23: the four examples and the chaos drill as users run "
          "them (PYTHONPATH=src python examples/..._torch.py, "
          "scripts/chaos_report_torch.py)")
    t23 = time.perf_counter()
    examples = phase_examples(card)
    print(f"  phase 23 took {time.perf_counter() - t23:.1f} s; phases 22-23 "
          f"{time.perf_counter() - t22:.1f} s; phases 1-23 "
          f"{time.perf_counter() - t_all:.1f} s")

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
                                 "weighted_ms", "runs", "one_call_ms")
                 if k in t}})
        if name in NARROW_KERNELS:
            kernels[-1]["by_dtype"] = {
                dt: {**times_dt[name].get(dt, {}),
                     "max_abs_err": err_dt[name].get(dt, err[name]),
                     "launches": sum(r["launches"][name]
                                     for r in paths.values()
                                     if r.get("dtype") == dt)}
                for dt in ("int16", "int8", "float32")}
        if name in OPERAND_KERNELS:
            kernels[-1].setdefault("by_dtype", {}).update({
                dt: {**times_op.get(name, {}).get(dt, {}),
                     "max_abs_err": err_op[name][dt],
                     "launches": sum(r["launches"][name]
                                     for r in paths.values()
                                     if r.get("dtype") == dt)}
                for dt in OPERAND_DTYPES})
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
                      f"items/s {k}" for k in ATTR_KINDS)
          + "; quantile admit p50 "
          + ", ".join(f"{paths[f'quantile_{k}']['p50_ms']:.3f} ms {k}"
                      for k in QUANT_KINDS)
          + "; quantile fleet stream "
          f"{paths['quantile_stream']['items_per_s']:,.0f} items/s"
          + "; narrow admit p50 "
          + ", ".join(f"{paths[k]['p50_ms']:.3f} ms {k[7:]} (int32 "
                      f"{paths[k]['int32_p50_ms']:.3f})" for k in paths
                      if k.startswith("narrow_") and "p50_ms" in paths[k])
          + f"; int16 + promotion fit "
          f"{paths['narrow_estimator_int16_esc']['seconds']:.3f} s (int32 "
          f"{paths['narrow_estimator_int16_esc']['int32_seconds']:.3f}); "
          f"int16 stream "
          f"{paths['narrow_stream_int16']['items_per_s']:,.0f} items/s "
          f"(int32 {paths['narrow_stream_int16']['int32_items_per_s']:,.0f})"
          + "; degraded admit p50 "
          + ", ".join(f"{r['p50_ms']:.3f} ms {k} (healthy "
                      f"{r['healthy_p50_ms']:.3f})" for k, r in (
                          (k, paths[f"resilience_{k}"]) for k in RES_KINDS))
          + "; front end x2.0 p999 "
          + ", ".join(f"{r['loads'][2.0]['p999_ms']:.2f} ms {k} (shed "
                      f"{r['loads'][2.0]['shed_rate']:.4f})"
                      for k, r in frontend.items())
          + f"; private hash + insert + score "
          f"{paths['private_hash']['seconds']:.3f} s; ACE fit + score "
          + ", ".join(f"{paths[f'paper_ace_{n}']['seconds']:.3f} s {n}"
                      for n in PAPER_K)
          + "; kNN graph + LOF at kddcup99_http's full n "
          f"{tables['kddcup99_http_full']['lof']['seconds']:.3f} s"
          + "; served (captured / eager) " + ", ".join(
              f"{k[6:]} prefill {r['prefill_ms']:.3f} / "
              f"{r['eager_prefill_ms']:.3f} ms, generate "
              f"{r['generate_tokens_per_s']:,.1f} / "
              f"{r['eager_generate_tokens_per_s']:,.1f} tokens/s, decode "
              f"{r['decode_tokens_per_s']:,.1f} / "
              f"{r['eager_decode_tokens_per_s_runs'][0]:,.1f} tokens/s"
              for k, r in paths.items() if k.startswith("serve_"))
          + "; trained olmo_1b (captured / eager) " + ", ".join(
              f"{k[11:]} step {r['step_ms']:.3f} / {e['step_ms']:.3f} ms, "
              f"{r['tokens_per_s']:,.0f} / {e['tokens_per_s']:,.0f} "
              f"tokens/s, peak {r['max_memory_allocated'] / 2**30:.2f} / "
              f"{e['max_memory_allocated'] / 2**30:.2f} GiB"
              for k, r, e in ((k, trained[k], trained[f"{k}_eager"]) for k
                              in ("train_olmo_microbatches",
                                  "train_olmo_chunked")))
          + f"; plain-loop step captured "
          f"{trained['captured_step']['wall_ms']:.3f} / eager "
          f"{trained['breakdown']['wall_ms']:.3f} ms"
          + "; captured admit p50 " + ", ".join(
              f"{r['p50_ms']:.3f} ms {k[19:]} (eager {r['eager_p50_ms']:.3f})"
              for k, r in captured.items()
              if k.startswith("captured_guardrail_"))
          + "; captured stream " + ", ".join(
              f"{r['items_per_s']:,.0f} items/s {k[16:]} (eager "
              f"{r['eager_items_per_s']:,.0f})" for k, r in captured.items()
              if k.startswith("captured_stream_"))
          + "; configs (captured / eager) " + ", ".join(
              f"{k[7:]} prefill {r['prefill_ms']:.3f} / "
              f"{r['eager_prefill_ms']:.3f} ms"
              + (f", decode step {r['decode_step_ms']:.3f} ms"
                 if "decode_step_ms" in r else "")
              for k, r in configs.items())
          + "; examples " + ", ".join(f"{k} exit 0 in {r['seconds']:.1f} s"
                                      for k, r in examples.items()))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
