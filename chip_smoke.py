#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. device  — print the card's name and power limit (``nvidia-smi``) and
   require CUDA with capability (9, 0);
2. build   — compile every kernel of the serving and training paths from
   the sources in this checkout (one ``nvcc`` per source, in parallel);
3. kernels — call each kernel's wrapper on the card at its path's shapes
   and hold it against its plain PyTorch version: the BLSTM layer (K1
   port) and its stashing variant at bf16 tolerance 2e-2 (normalised by
   the plain output's max-abs; the stash variant's y bit-identical to
   the inference variant's), the backward (K2 port: dx, dWx, dWh, db) at
   2e-2, 16 learners in one launch bit-identical to 16 launches of one,
   each with the device ms of its sub-launches (torch.profiler:
   x-projection and recurrence; recurrence, dx and dW) and the
   recurrences' tile rows and cluster size; the tensor-core GEMM routine
   (x·Wx, dx unrounded, dWx, dWh, db) at the full training shape within
   1e-5 of float64 products; the beam frame step (K5 port) bit-identical
   under the max semiring and within 1e-5 under sum; time each with CUDA
   events beside its plain version, its bytes/operations bound and a
   library call;
3a. k4 — the fused BLSTM stack (K4 port, one launch for every layer)
   against its plain version ``blstm_stack_plain`` at 2e-2 of each
   utterance's largest value (every value finite) and bit-identical to
   the loop of K1 launches, at the serving admission's shape (B = 1, T =
   256, 6 layers of 512, D0 = 260), evaluate's (B = 8, T = 256, var-len
   with a length-1 row), a small ragged one (B = 5 in a tile of 8, H =
   16, 3 layers: the item path) and B = 16, T = 21, 2 layers (the K1
   loop's 16 rows in two tiles, K4's in four 4-row tiles a direction, two
   waves of clusters), each with its plan (``lstm_cell.stack_plan``: path,
   tile rows, clusters of 16 CTAs, waves of the clusters the card holds at
   once); B = 1 and B = 8 timed (eager, and one launch replayed from a
   CUDA graph) beside the K1 loop, the plain version, the bound and
   cuDNN's 6-layer bidirectional LSTM;
4. serve   — the full-width ``swb2000-blstm`` AsrServer (6 BLSTM layers
   of 512 per direction, vocab 32000, random weights from seed 0)
   serves 8 synthetic utterances to completion with every launch counter
   set to 0 just before and read just after (K4 once per admission, K1
   never); then a second run with top-C pruning (C = 16) serves 4 more.
   The parked posteriors of one request are held against the plain
   forward;
5. profile — 4 requests once more under torch.profiler: device time by
   kernel and the device's busy share of the wall time;
6. train   — the paper's §V training setup at full width: ad_psgd over
   16 learners, global batch 256, T = 21, variable-length utterances,
   2 warm-up and 10 timed steps with the launch counters set to 0 just
   before and read just after; loss per step, ms per step, valid
   frames/s; one step's loss and gradients of the kernel path held
   against the plain path at 2e-2 (normalised); a non-finite loss fails;
7. train profile — one more step under torch.profiler;
7a. evaluate — the 16-learner state the train phase ended with is saved
   through the port's ``checkpoint.save`` into a temporary directory
   (bytes and seconds printed), then ``launch.evaluate.main`` scores it:
   ``--arch swb2000-blstm --strategy ad_psgd --learners 16 --batches 4
   --batch 8 --seq-len 256 --var-len --beam-width 8 --decode-chunk 8``,
   with the counters set to 0 just before and read just after (K4 once
   per forward, warm-up included; K1 never; K5 once per decoded frame);
   on the first batch the consensus logits are held bit-identical to the
   per-layer K1 loop and within 2e-2 per utterance of the plain forward,
   and the final K5 beam state (every slot's prefix and scores) equal to
   the plain beam decode's on the same logits on the card (max semiring:
   K5 is bit-exact there); its six CSV
   rows (no quality claim: 12 steps of synthetic data);
7a-comm — the paper's communication substrate on the train phase's data
   (16 learners, batch 256, T = 21, var-len, seed 0), five transports of
   1 warm-up and 3 timed steps each, the counters set to 0 just before
   and read just after (K1-stash and K2 6 times a step): ``hring`` with
   pods of 4 (f32, the ``mix_hierarchical`` fast path); ``hring`` with
   bf16 intra-pod, top-k inter-pod (1 %) and 4 MB buckets, driven
   through ``launch.train.main`` with its ``--comm-*`` flags and
   ``--consensus``; ``ad_psgd_q8`` with 4 MB buckets; ``ad_psgd_exp``;
   ``ad_psgd`` over a flat top-k wire.  Each prints ms/step, valid
   frames/s, wire bytes a learner a round (held equal to the reference's
   formula), the consensus distance, the grad norm and peak memory; every
   loss finite.  On each one's final params upcast to f32: the hring round
   within 1e-6 (normalised) of ``hierarchical_matrix(16, 4) @ w`` in f64,
   4 exponential-graph rounds to consensus (1e-6 of the params' RMS), the
   top-k wires' replica mean kept to 1e-6, every int8 value within
   scale/2 of its sender's; one round of each on ``softmax_w`` (16 x 256
   x 32000) on the card bit-identical to the same ops on a CPU copy;
7a-ctc — the reference's ``bench_decode_wer`` path at full width: ad_psgd
   with the CTC loss (each utterance's valid frames collapsed to at most 6
   labels), 2 warm-up and 5 timed steps (K1-stash and K2 6 times a step,
   every loss finite); one step's loss and gradients against the plain
   path at 2e-2; ``ctc_loss`` on the card against a CPU f64 evaluation at
   1e-5; then 2 held-out batches of 8 through the consensus model (K4 once
   per forward), ``greedy_ctc_decode`` and ``beam_decode(beam=8,
   semiring="sum")`` (K5 once per frame), whose hypotheses equal the plain
   beam's on the same logits on the card with scores within K5_SUM_TOL;
   greedy and beam TER (no quality claim);
7a-elastic — elastic fault-tolerant training at full width on the train
   phase's data (16 learners, batch 256, T = 21, var-len, fresh seed-0
   weights, sgd), each run with the counters set to 0 just before its
   steps and read just after (K1-stash and K2 6 times a step): (a)
   ``ad_psgd`` over the f32 ring under one ``FaultPlan`` (learner 0
   straggling 4x, learner 1 crashed at step 2 and rejoining at step 6,
   drop and corrupt probability 0.05, corrupt scale 0.1, staleness
   damping 0.2, fault seed 0), 1 warm-up and 8 timed steps; (b) ``hring``
   (pods of 4, int8 wire) with learners 4-7 crashed at step 1 and
   rejoining at step 3, 4 steps; (c) run (a)'s flags through
   ``launch.train.main``: 4 steps, then 2 with a checkpoint and 2 more
   with ``--resume``, every leaf of params, prev_params, opt and
   staleness and the ``final loss`` line bit-identical.  Every step: the
   loss finite, the staleness counters equal to the reference's formula
   on the host, the step's matrix doubly stochastic to 1e-6 with identity
   rows and columns for the dead, ``wire_bytes`` = the wire formula x
   n_active / 16; the dead replicas bit-identical through their crash
   windows; (a)'s rejoiner at the incumbents' f64 mean (f32 leaves 1e-6,
   bf16 one rounding), fresh state and zero staleness; (b) ``n_active``
   12 in the crash window; one elastic step of (a) kernel vs plain path
   (loss and gradients at 2e-2); the no-fault plan against the plain
   ad_psgd step, 3 steps each from the same state (one f32 mix and the
   f32 leaves at 2e-5 normalised, bf16 leaves at 2e-5 beyond one bf16
   rounding step of each element).  ms/step (beside
   the train phase's plain step), contributors' valid frames/s, peak
   memory, the act/stale trail, beside the card's name and power limit;
7a-multirank — decentralized training with the learner axis split over
   two ranks that share the one card (``torch.multiprocessing`` spawn, a
   file rendezvous, gloo: each rank's payloads staged through host
   memory; ``launch.multihost.initialize`` places both on cuda:0): the §V
   step at full width from the train phase's seed-0 init, 16 learners (8
   a rank, batch 256, T = 21, var-len), the gradient norm on: ad_psgd for
   3 steps, hring with pods of 8 (one pod a rank: the pod mean local, the
   ring of pod means across ranks) and sc_psgd_replicated (the ordered
   chain) for 2 each; the coded wires of 7a-comm, ad_psgd_q8 with 4 MB
   buckets and hring with bf16 intra-pod and top-k inter-pod (1 %, 4 MB
   buckets, pods of 4), 3 steps each; the elastic step under 7a-elastic's
   plan (a) for 7 steps (through the rejoin at step 6) and plan (b) over
   int8 (a pod down) for 4.  Each runs first in one process, then in the
   ranks, their launch counters and sent bytes set to 0 just before their
   steps and read just after (K1-stash and K2 6 times a step in every
   rank); every state leaf (params, prev_params, the EF residual and
   estimate, the staleness counters), every loss and the last step's
   metrics of the ranks bit-identical to the one-process run (leaves by
   SHA-256 digest, row by row), whose ad_psgd losses equal the train
   phase's first three; ms/step at W = 1 and W = 2, the exchange alone
   (the run's own mix of its final params) and the bytes each rank sends
   a step, by primitive, beside the analytic ``wire_bytes``, beside the
   card's name and power limit.  A rank that raises fails the run;
7b. k3 — the long-utterance slice's kernels against their plain versions
   and against the unchunked pair: K1's chunk-entry variant and the
   chunked-recompute backward (K3 port) at 4 learners x 2 rows, T = 300,
   K = 64 (T padded to 320), D = 1024, H = 512, var-len with a length-1
   row, f32 and bf16 stash: K1-chunk's y bit-identical to K1-stash's and
   to K1 inference's (the streaming launch), its entry carries and
   K3's dx, dWx, dWh, db within 2e-2 of the plain versions, and with an
   f32 stash K3's dx bit-identical to K2's and its gradients within 2e-5
   normalised of K2's on the same input; K1-stash on the forward
   recurrence's plan (``lstm_cell.recur_plan``: resident Wh at this T)
   bit-identical to the streaming launch; at the train-long layer shape
   (16 learners x 2 rows, T = 2000, K = 256) the same y and dx identities
   and gradient tolerance against the unchunked pair, the plans printed
   (path, cluster size, active clusters, waves), each kernel timed with
   the device ms of its sub-launches beside its plain version, its bound
   and a cuDNN LSTM call;
7c. train-long — full-width ``swb2000-blstm``, ad_psgd over 16 learners,
   global batch 32, T = 2000 (lognormal var-len, median 1200) with
   ``seq_chunk = -1`` (K = 256): 1 warm-up and 3 timed steps chunked,
   then 1 warm-up and 2 timed steps unchunked, each with the launch
   counters set to 0 just before and read just after (chunked: K1-chunk
   and K3 6 times per step, K1-stash and K2 never); ms/step, valid
   frames/s, peak device memory and the stash accounting of each; then
   one step's loss and per-layer f32 gradients chunked against unchunked
   at 2e-5 normalised; one more step of each under torch.profiler;
8. lm kernels — the LM slice's kernels at its serving shapes against
   their plain versions: decode attention (K7 port), canonical and delta,
   at B = 8, S = 1024, 5 KV heads of 3 queries, E = 64, bf16, over pos
   0, tile edges and S - 1 and a window, at 2e-2 (normalised); the paged
   kernel (K8 port) over a shuffled 512-page pool of 16 positions with
   padded tables at 2e-2, and bit-identical to K7 at block_s = 16 on
   contiguous pages (with and without a window); both again at one
   request (B = 1, the serving group) and at granite-moe-3b-a800m's 8 KV
   heads of 3 queries, and K7 at hymba-1.5b's decode shape (S = 2048,
   M = 5, window 1024) at 8 slots and one request, each timed shape
   with its launch plan (splits, CTAs, rows per split) and its own
   bound; argmax (K6 port) on (8, 49152) logits with
   planted ties (one across a slice bound), NaN (one only in the last
   slice) and -inf, bit for bit in bf16, in f32 and one element off a
   16-byte boundary; each timed beside its plain version, its byte bound
   and a library call, and per launch with the host's dispatch taken out
   (``_device_ms``: back-to-back launches replayed from one CUDA graph;
   for K6 ``torch.argmax`` too, and both eager times as medians of five
   alternating turns);
8a. k11 — the flash-attention kernel (K11 port) against its plain
   version ``flash_attention_plain`` at 1e-2 of each (position, head)
   row's largest value (half the bf16 output's 2e-2, held since p is
   rounded to bf16 before p·v; every value finite; the check is shown to
   see a window one key short) at hymba-1.5b's prefill shape (B = 1, S =
   1500, 25 heads over 5 KV heads, E = 64; window 1024 and global),
   smollm-360m's (15 heads, S = 600), granite-moe-3b-a800m's (24 heads
   over 8, S = 700), Sq = 1, a ragged E = 32 case, q_offset > 0 with Sk
   > Sq (windowed and global), non-causal with Sk < Sq, and M = 8 at E =
   128; each case's CTA count from the wrapper's launch plan; the four
   serving shapes timed (eager, and graph-replayed per launch) beside
   their plain version, their operation bound and
   scaled_dot_product_attention, and the kernel and the plain version
   set beside an f64 evaluation; the flash library's HGMMA, HMMA and
   UTMALDG instruction counts (the toolkit's ``cuobjdump -sass``), which
   must show wgmma and TMA loads and no mma.sync;
9. lm-serve — the full-width ``smollm-360m`` (32 layers, d 960, 15 heads
   over 5 KV heads, vocab 49152, random weights from seed 0) dense
   ``Server``: 16 requests (prompt lengths 64-960 drawn with seed 0, the
   second forced to 600, a 64-token shared prefix), 8 slots, max_len
   1024, 64 new tokens each, with the launch counters set to 0 just
   before and read just after (K11 32 times per admission); decoded
   tokens/s, mean wave ms, prefill ms per request, peak device memory;
   the shortest and the 600-token request's prefill and first 8 decode
   logits against the plain path (teacher-forced) at 2e-2; one preempt
   -> restore held bit-identical to the uninterrupted run;
10. lm profile — 4 requests under torch.profiler;
11. lm-serve paged — the same requests through ``PagedServer`` (pages of
    16, a 512-page pool): tokens/s, peak sharing ratio, COW count and
    shared hits, and how many requests decode the dense run's tokens;
12. k9 — the chunked SSD scan (K9 port) against its plain version
    ``ssd_plain`` at a small shape (G < H) and at the two full-width
    serving shapes (mamba2-370m: B = 1, 32 heads of P = 64, N = 128, one
    B/C group, Q = 256, S = 700, the last chunk ragged; hymba-1.5b: 50
    heads of 64, N = 16, S = 1500): y within 2e-2 and the state within
    1e-4 (normalised); each serving shape timed beside its plain version
    and its operation bound (no library call computes chunked SSD);
13. ssm-serve — the full-width ``mamba2-370m`` (48 layers, d 1024,
    d_inner 2048 as 32 SSM heads of 64, state 128, chunk 256, vocab
    50,280, random weights from seed 0) ``Server``: 16 requests (prompt
    lengths 64-960 drawn with seed 0, the first forced to 700), 8 slots,
    max_len 1024, 32 new tokens each, with the counters set to 0 just
    before and read just after (K9 48 times per admission, K6 per
    equal-position group); tokens/s, mean wave ms, prefill ms, peak
    memory; for the 700-token request, each of its 48 K9 launches against
    ``ssd_plain`` on the layer's own inputs (2e-2 / 1e-4), and its
    prefill and first 8 decode logits against the plain path
    (teacher-forced) at 2e-2 through the first 4 layers — through all 48
    they are printed, not held (random-init depth amplifies any f32
    rounding difference: tools/ssd_precision.py);
    one preempt -> restore held bit-identical to the uninterrupted run;
14. ssm profile — 4 requests under torch.profiler, admissions (prefill)
    and decode waves as two windows: each one's share of the wall time,
    the device's busy share and the top kernels;
15. hybrid-serve — the full-width ``hymba-1.5b`` (32 layers, d 1600, 25
    heads over 5 KV heads, window 1024 with global layers 0, 15 and 31,
    an SSM branch of 50 heads of 64 with state 16, vocab 32,001, random
    weights from seed 0) ``Server``: 16 requests (prompt lengths 64-2000
    drawn with seed 0, the first forced to 1500), 8 slots, max_len 2048,
    24 new tokens each, with the counters set to 0 just before and read
    just after (K11 and K9 32 times per admission, K7 32 times per decode
    call, K6 once per admission and per decode call); tokens/s, mean wave
    ms, prefill ms, peak memory; for the 1500-token request each of its
    32 K11 launches against ``flash_attention_plain`` (per row, as in
    8a) and each K9 launch
    against ``ssd_plain`` on the layer's own inputs, and its prefill and
    first 8 decode logits against the plain path (every kernel swapped
    for its plain version; teacher-forced) held at 2e-2 through the first
    4 layers and printed through all 32; one preempt -> restore held
    bit-identical;
16. hybrid profile — as 14, for the hybrid server;
17. k10 — the fused dense-MoE kernel (K10 port) against its plain version
    ``moe_dense_plain`` at 2e-2 of each token row's largest value (every
    value finite) at granite-moe-3b-a800m's d 1536, 40 experts of d_ff
    512, top-8: T = 1, 8, 700 and 1500, every router weight non-zero, one
    expert never selected, a token with no weight (its row exactly 0),
    T = 1 on experts 32-39, and a small gelu case, each with its launch
    plan (items, clusters, CTAs, slot bytes) and the work list the
    kernel's first launch builds on the card equal to ``work_list``'s; 5
    rows of the T = 700 call launched alone at T = 1 bit-identical to the
    same rows; the check shown to reject the plain version without the
    last expert; T = 1, 8 and 700 timed (eager, and graph-replayed per
    call) beside their plain version, their bound and a three-bmm
    yardstick (not one call);
18. moe-serve — the full-width ``granite-moe-3b-a800m`` (32 layers, d
    1536, 24 heads over 8 KV heads, 40 experts of 512, top-8, vocab
    49,155, random weights from seed 0 drawn on the card) ``Server``: 16
    requests (prompt lengths 64-960 drawn with seed 0, the first forced to
    700, a 64-token shared prefix), 8 slots, max_len 1024, 24 new tokens
    each, with the counters set to 0 just before and read just after (K10
    and K11 32 times per admission, K10 and K7 32 times per decode call,
    K6 once per admission and per decode call); tokens/s, mean wave ms,
    prefill ms, peak memory; for the 700-token request each of its 32 K10
    launches against ``moe_dense_plain`` on the layer's own inputs, and
    its prefill and first 8 decode logits against the plain path held at
    2e-2 through the first 4 layers and printed through all 32, with the
    top-8 selections that differ between the two paths and the smallest
    router margin among them; one preempt -> restore held bit-identical;
19. moe profile — as 14, for the moe server;
20. moe-paged — the same requests through ``PagedServer`` (pages of 16, a
    512-page pool): K8 32 times per decode call, and how many requests
    decode the dense run's tokens;
21. load — serving under load and observability at full width, every
    run through ``launch.load.main`` (or ``launch.train.main``) with the
    launch counters set to 0 just before and read just after: (a) the
    ``swb2000-blstm`` AsrServer (4 slots, 256 frames, chunk 8, lognormal
    lengths of median 120 frames, two tiers, patience 1 s) at 8
    requests/s for 3 wall seconds with ``--wall --calibrate``: the
    ``calib/*`` rows (a least-squares cost model of the measured
    admissions and waves, each stop stamp after ``torch.cuda.
    synchronize``); (b) ``serving.sustained_capacity`` in virtual time at
    those costs over one AsrServer reset between probes (1-64 requests/s,
    3 bisection steps, first-token p99 target 250 ms): the max sustained
    rate and its p99; (c) twice an overload at twice that rate with
    ``--trace-out --trace-deterministic``: preemptions > 0, no priority
    inversion after any pump (``check_inversion``), done + abandoned +
    rejected = offered, both traces valid and byte-identical; in (a)-(c)
    K4 once per first admission, K5 once per frame of each wave, K1
    never; (d) the paged ``smollm-360m`` (pages of 16, 1024 positions, 8
    slots' pool, 32 new tokens, prompts of median 300) at 4 requests/s
    for 2.5 wall seconds with ``--trace-out``: K11 32 times per
    admission, K8 32 times per decode call, K6 once per admission and per
    decode call, the trace rendered by ``launch.obsreport`` (its
    compile/steady table printed); (e) the train CLI, the §V setup for 2
    steps with ``--trace-out --trace-deterministic``, twice: K1-stash and
    K2 6 times a step, the two traces byte-identical.

22. encdec — the full-width ``whisper-large-v3`` (32 encoder and 32
    decoder layers, d 1280, 20 heads of 64, vocab 51,866, random weights
    from seed 0) through ``Model.prefill_fn`` / ``decode_fn`` (no server
    runs the family): 8 streams of 1500 stub frame embeddings (30 s of
    audio at 50 Hz), the 4-token start sequence, a 448-position self
    cache, 64 greedy tokens (K6), with the counters set to 0 just before
    and read just after (K11 96 times per prefill: 32 encoder, 32 self,
    32 cross; K7 64 times per decode step: 32 self, 32 cross over the
    1500 frames); encode ms, prefill ms, decode-step ms, tokens/s, peak
    memory; every token in the vocabulary; stream 0's prefill and 8
    teacher-forced decode logits against the plain path within 2e-2
    through 4 encoder and 4 decoder layers (through all 32 printed);
23. vlm — the full-width ``internvl2-2b`` (24 layers, d 2048, 16 heads
    over 8 KV heads of 128, vocab 92,553) ``Server`` and ``PagedServer``
    (pages of 16) serving 8 requests of token prompts (64-960 tokens, a
    64-token shared prefix), 8 slots x 1024, 24 new tokens, each with the
    counters set to 0 just before and read just after (K11 24 times per
    admission, K7 (K8 paged) 24 times per decode call, K6 once per
    admission and per call); one prefill of 256 patch embeddings and 64
    text tokens and 8 teacher-forced decode logits held within 2e-2 of
    the plain path; preempt/restore bit-identical in both servers;
24. dense-configs — ``phi3-medium-14b``, ``stablelm-12b`` (E = 160) and
    ``command-r-35b`` (60.57 GB) at full width, one at a time from an
    emptied allocator: ``param_bytes`` and ``require_weights_fit``; a
    ``Server`` of 4 slots x 1024 serving 4 requests, 8 new tokens (K11 40
    times per admission, K7 40 times per decode call); the first
    request's prefill and 8 decode logits within 2e-2 of the plain path
    through 4 layers.  Phase 8's K7 also runs at whisper's cross (pos 1499
    of 1500 frames, canonical) and self (448 positions) shapes and at
    stablelm's E = 160, its K6 at the four vocabularies, and 8a's K11 at
    stablelm's S = 1000 (E = 160), whisper's encoder (S = 1500, non-
    causal) and cross-attention (4 queries over 1500 frames).

25. lm-train — the transformer families' training through
    ``launch.train`` (``setup_training``, ``run``, ``main``) and
    ``Model.loss_fn``, every run from an emptied allocator with the
    counters set to 0 just before its steps and read just after: (a)
    ``smollm-360m`` at full width and depth (32 layers, d 960), ad_psgd
    over 16 learners, batch 32 x 128 tokens, 2 microbatches, 2 warm-up
    and 5 timed steps: loss per step, ms/step, tokens/s, peak memory, K11
    launches per step held to 32 x 2 x 2 (remat re-runs each layer in the
    backward); one step's losses and every gradient leaf kernel vs plain
    path at 2e-2 (normalised per leaf) through all 32 layers; one more
    step profiled (busy share, the kernels' device time, the autograd
    Functions' plain backward and the mixer as CUDA-event spans); (b)
    ``mamba2-370m`` at full width and depth, ad_psgd over 16 learners
    (K9 folds them into 512 heads), 3 steps; (c) ``granite-moe-3b-a800m``
    under sc_psgd (one replica), batch 8, 3 steps, then 4 of its layers
    over 4 learners (ad_psgd, batch 16: K10 folds them into 160 experts,
    the folded weights' layout copies counted) with a kernel-vs-plain
    step; (d) ``hymba-1.5b``, ``internvl2-2b`` (32 patches + 96 tokens)
    and ``whisper-large-v3`` (64 frames + 64 tokens) at full width and
    depth over 2 learners of their configs' strategies, 2 steps each, a
    kernel-vs-plain step through 4 layers, each gradient leaf's relative
    L2 distance held at 2e-2 (the max-abs one printed; hymba's and
    whisper's at 8e-2: the SSD's B/C gradients and whisper's
    cross-attention gradients amplify the forward's rounding; on moe the
    plain pass replays the kernel pass's top-k selections, whose flips
    are counted); (e) the train CLI
    (``--arch smollm-360m --learners 4 --steps 2``) with its timing
    line; (f) each autograd Function (K11 at smollm's rows and whisper's
    cross-attention, K9 at mamba2's 512 folded heads, K10 at granite's
    4-learner fold) against autograd of its plain version at 2e-2, timed
    forward + backward beside it.  A non-finite loss, a kernel of a
    family never launched or a missed tolerance fails the run.

The last two lines are ``{"kernels": [...]}`` (K1-stash's, K2's, K4's and
K5's ``launches`` counting 7a-comm, 7a-ctc and 7a-elastic too, also apart
as ``launches_comm``, ``launches_ctc`` and ``launches_elastic``, K1-stash's
and K2's the ranks' of 7a-multirank, as ``launches_multirank``; K4's,
K5's, K6's, K8's and K11's counting phase 21's runs, apart as
``launches_load``, and K1-stash's and K2's its train CLI runs, as
``launches_trace_cli``; K6's, K7's, K8's and K11's phases 22-24's, apart
as ``launches_encdec``, ``launches_vlm`` and ``launches_dense_cfgs``;
K9's, K10's and K11's phase 25's, apart as ``launches_train_lm``, with
``train_shapes``: each Function's gradient error and forward + backward
ms at its training shapes) and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit: the
# port's one record of the card's peaks (repro_torch.analysis.roofline)
try:
    from repro_torch.analysis.roofline import HW
except ImportError:              # main() says what is missing, and fails
    HW = None
PEAK_BYTES_S = HW and HW.hbm_bw
PEAK_BF16_FLOPS = HW and HW.peak_flops_bf16
PEAK_F32_FLOPS = HW and HW.peak_flops_f32
# f32-accurate products on the tensor cores: the least time for K2's (and
# K3's) products on f32 dgates is one TF32 pass of the same work (the
# kernels issue three bf16 passes of split operands, gemm.cuh)
PEAK_TF32_FLOPS = HW and HW.peak_flops_tf32

K1_TOL = 2e-2            # bf16 forward (docs/kernels.md §Oracle tolerances)
K5_SUM_TOL = 1e-5        # sum semiring: logaddexp in another order
SEED = 0


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one call of ``fn`` with the host's dispatch taken
    out: ``iters`` back-to-back calls captured into one CUDA graph, the
    graph replayed ``reps`` times between two CUDA events, the elapsed
    time over iters * reps.  (``_time_ms`` times eager calls, which also
    counts the wrapper's host time whenever the host is the slower side.)
    ``fn`` must launch on the current stream and synchronise nothing, as
    the kernel wrappers do; None, said, if the capture fails."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                              # libraries loaded outside capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        print(f"[device-ms] CUDA graph capture failed, not measured: {e}",
              flush=True)
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def _profile_window(fn, tag):
    """Run ``fn`` under torch.profiler: (its result, wall ms of the
    window, device busy ms, rows of (device us, count, kernel) by device
    time), or None, said under ``tag``, when the profiler recorded no
    device events.  Device activity only: CPU op events would repeat
    their kernels' device time, and over a host-bound decode window their
    hundreds of thousands took ``key_averages`` about a minute."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0), reverse=True)
    if not rows:
        print(f"[{tag}] the profiler recorded no device events: device "
              f"busy share not measured", flush=True)
        return None
    return out, wall_ms, sum(r[0] for r in rows) / 1e3, rows


def _lstm_kernel_label(key: str) -> str:
    """Which sub-launch of the BLSTM wrappers a profiler kernel name is."""
    if "bwd_recur" in key:
        return "lstm_bwd_recur"
    if "blstm_recur" in key:
        return "blstm_recur"
    if "gemm_kernel" in key:
        a = key.split("gemm_kernel<", 1)[-1]
        if a.startswith("lstm_gemm::Shifted"):
            return "lstm_bwd_dw dWh+db"
        if a.startswith("lstm_gemm::Mat<float"):
            return "lstm_bwd_dx"
        if a.startswith(("lstm_gemm::Mat<__nv_bfloat16, true>",
                         "lstm_gemm::ChunkRows<true>")):
            return "lstm_bwd_dw dWx"
        return "lstm_xproj"
    return "torch ops"


def _sub_launch_ms(fn, calls: int) -> dict:
    """Device ms per call of each sub-launch of ``fn`` (torch.profiler
    over ``calls`` calls after one warm-up, by `_lstm_kernel_label`), or
    {} when the profiler records no device events."""
    fn()
    got = _profile_window(lambda: [fn() for _ in range(calls)], "sub-launch")
    if got is None:
        return {}
    out = {}
    for us, _, key in got[3]:
        label = _lstm_kernel_label(key)
        out[label] = out.get(label, 0.0) + us / 1e3 / calls
    return out


def _bound(nbytes: float, ops, peak_ops: float = None):
    """The larger of the byte time and the operation time, in ms.  ``ops``
    is a count at ``peak_ops``, or a list of (count, peak) pairs when the
    work mixes operand types, each at the peak of its own type."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    parts = [(ops, peak_ops)] if peak_ops is not None else ops
    t_ops = sum(n / peak for n, peak in parts) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _norm_err(got, want) -> tuple:
    got, want = got.float(), want.float()
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / (float(want.abs().max()) + 1e-8)


def _row_err(got, want) -> tuple:
    """An attention output's error, each (position, head) row over its
    largest |want|: (max abs error, worst such ratio).  A tensor-wide
    scale would be set by the few rows that see one or two keys (|o| near
    |v|), and let a row that averages a thousand keys (|o| ~ 0.05 at unit
    inputs) be off by as much as its own values."""
    got, want = got.float(), want.float()
    diff = (got - want).abs().amax(-1)
    return (float(diff.max()),
            float((diff / (want.abs().amax(-1) + 1e-6)).max()))


# ---------------------------------------------------------------- phase 1
def _card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def phase_device():
    import torch

    print(_card_line(), flush=True)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {torch.cuda.get_device_name(0)} capability {cap} "
          f"count {torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if tuple(cap) != (9, 0):
        _fail(f"need compute capability (9, 0), got {cap}")


# ---------------------------------------------------------------- phase 2
def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build()
    print(f"[build] {sorted(secs)} built in "
          f"{time.perf_counter() - t0:.1f}s (per library: "
          f"{ {k: round(v, 1) for k, v in secs.items()} })", flush=True)
    for name in build.SOURCES:
        log = build.log_path(name)
        if log.exists():
            for line in log.read_text(errors="replace").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ptxas {name}] {line.strip()}", flush=True)


# ---------------------------------------------------------------- phase 3
def _k1_inputs(B, T, D, H, lengths, gen):
    import torch

    dev = torch.device("cuda")

    def w(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(
            dev, torch.bfloat16)

    ws = []
    for _ in range(2):
        ws += [w(D, 4 * H, scale=D ** -0.5), w(H, 4 * H, scale=H ** -0.5),
               (torch.randn(4 * H, generator=gen) * 0.1).to(dev)]
    x = w(B, T, D, scale=1.0)
    return ws, x, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _cudnn_stack(layers, x, lengths):
    """One call of a ``len(layers)``-layer cuDNN bidirectional LSTM over a
    packed batch with the same weights (forget bias +1 folded into the
    input bias): the library yardstick, timed only here and used nowhere
    in the port."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    D, H = x.shape[-1], layers[0][1].shape[0]
    lstm = torch.nn.LSTM(D, H, num_layers=len(layers), batch_first=True,
                         bidirectional=True).to(x.device, torch.bfloat16)
    with torch.no_grad():
        for k, (wxf, whf, bf, wxb, whb, bb) in enumerate(layers):
            for sfx, (wx, wh, b) in (("", (wxf, whf, bf)),
                                     ("_reverse", (wxb, whb, bb))):
                bias = b.clone()
                bias[H:2 * H] += 1.0
                getattr(lstm, f"weight_ih_l{k}{sfx}").copy_(wx.t())
                getattr(lstm, f"weight_hh_l{k}{sfx}").copy_(wh.t())
                getattr(lstm, f"bias_ih_l{k}{sfx}").copy_(bias)
                getattr(lstm, f"bias_hh_l{k}{sfx}").zero_()
    lstm.flatten_parameters()
    packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                  enforce_sorted=False)

    def call():
        with torch.no_grad():
            return lstm(packed)
    return call


def check_k1(gen):
    import torch

    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import blstm_layer_ref

    T, H = 256, 512
    cases = [(1, 260, (173,)), (1, 1024, (256,)),
             (4, 260, (256, 200, 77, 1)), (4, 1024, (256, 131, 40, 9))]
    worst, entry = 0.0, None
    for B, D, lens in cases:
        ws, x, lengths = _k1_inputs(B, T, D, H, lens, gen)
        got = lstm_cell.blstm_layer(*ws, x, lengths)
        torch.cuda.synchronize()
        want = blstm_layer_ref(*ws, x, lengths)
        abs_err, norm = _norm_err(got, want)
        for b, n in enumerate(lens):
            if got[b, n:].any():
                _fail(f"K1 B={B} D={D}: padded frames of row {b} not zero")
        print(f"[K1] blstm_layer B={B} T={T} D={D} H={H} lengths={lens}: "
              f"max_abs_err {abs_err:.3g}, normalised {norm:.3g} "
              f"(tol {K1_TOL})", flush=True)
        if not norm <= K1_TOL:
            _fail(f"K1 B={B} D={D} disagrees with its plain version: "
                  f"normalised error {norm}")
        worst = max(worst, abs_err)
        if (B, D) != (1, 1024):
            continue
        # the admission path's shape for layers 1..5: time it
        ms = _time_ms(lambda: lstm_cell.blstm_layer(*ws, x, lengths), 10)
        plain_ms = _time_ms(lambda: blstm_layer_ref(*ws, x, lengths), 2,
                            warmup=1)
        try:
            library_ms = _time_ms(_cudnn_stack([ws], x, lengths), 10)
        except RuntimeError as e:        # no cuDNN kernel for these types
            print(f"[K1] library (cuDNN LSTM) not timed: {e}", flush=True)
            library_ms = None
        n_valid = int(sum(lens))
        nbytes = (B * T * D * 2 + 2 * (D * 4 * H * 2 + H * 4 * H * 2
                                       + 4 * H * 4)
                  + B * 4 + B * T * 2 * H * 2)
        ops = 2 * (2 * n_valid * D * 4 * H + 2 * n_valid * H * 4 * H)
        bound_ms, bound_by = _bound(nbytes, ops, PEAK_BF16_FLOPS)
        entry = dict(name="blstm_layer", route="cuda",
                     source="src/repro_torch/kernels/csrc/lstm_fwd.cu",
                     replaces="src/repro/kernels/lstm_cell.py:498",
                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms,
                     shape=f"B={B} T={T} D={D} H={H}")
        print(f"[K1] B={B} D={D}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms, library {library_ms} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
    entry["max_abs_err"] = worst
    return entry


# Training shapes of the main path: 16 learners x 16 rows (global batch
# 256, the paper's §V setup), T = 21 frames, layers 1..5 (D = 2H = 1024)
TRAIN_L, TRAIN_B, TRAIN_T, TRAIN_D, TRAIN_H = 16, 16, 21, 1024, 512


def _stacked_inputs(L, B, T, D, H, gen, var_len):
    """Weights, x and lengths with a leading learner axis of L."""
    import torch

    dev = torch.device("cuda")

    def w(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(
            dev, torch.bfloat16)

    ws = []
    for _ in range(2):
        ws += [w(L, D, 4 * H, scale=D ** -0.5), w(L, H, 4 * H, scale=H ** -0.5),
               (torch.randn(L, 4 * H, generator=gen) * 0.1).to(dev)]
    x = w(L, B, T, D, scale=1.0)
    if var_len:
        lens = torch.randint(1, T + 1, (L, B), generator=gen)
        lens[:, 0] = T
        lens[0, -1] = 0                  # an empty row
    else:
        lens = torch.full((L, B), T)
    return ws, x, lens.to(dev, torch.int32)


def _cudnn_blstm_train(x, ws):
    """One cuDNN bidirectional bf16 LSTM over all the learners' rows with
    the first learner's weights (a library call takes one weight set):
    returns (forward with autograd, backward of one saved forward) — the
    yardsticks of the stash forward and of K2, timed only here, used
    nowhere in the port."""
    import torch

    L, B, T, D = x.shape
    H = ws[1].shape[-2]
    lstm = torch.nn.LSTM(D, H, batch_first=True, bidirectional=True).to(
        x.device, torch.bfloat16)
    with torch.no_grad():
        for sfx, (wx, wh, b) in (("", ws[:3]), ("_reverse", ws[3:])):
            bias = b[0].clone()
            bias[H:2 * H] += 1.0
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(wx[0].t())
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(wh[0].t())
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(bias)
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
    lstm.flatten_parameters()
    xin = x.reshape(L * B, T, D).detach().requires_grad_(True)

    def fwd():
        return lstm(xin)[0]
    out = fwd()
    dy = torch.randn_like(out)

    def bwd():
        torch.autograd.grad(out, [xin] + list(lstm.parameters()), dy,
                            retain_graph=True)
    return fwd, bwd


def _library_ms(make, what):
    try:
        return make()
    except RuntimeError as e:            # no cuDNN kernel for these types
        print(f"[{what}] library (cuDNN LSTM) not timed: {e}", flush=True)
        return None


def check_k1_stash(gen):
    """K1's stashing variant vs its plain version; y bit-identical to the
    inference variant; 16 learners in one launch equal to 16 launches of
    one."""
    import torch

    from repro_torch.kernels import lstm_cell as LC

    L, B, T, D, H = TRAIN_L, TRAIN_B, TRAIN_T, TRAIN_D, TRAIN_H
    worst = 0.0
    for var_len in (False, True):
        ws, x, lens = _stacked_inputs(2, B, T, D, H, gen, var_len)
        for stash in ("float32", "bfloat16"):
            got = LC.blstm_layer_train(*ws, x, lens, stash=stash)
            torch.cuda.synchronize()
            want = LC.blstm_layer_train(*ws, x, lens, stash=stash,
                                        plain=True)
            errs = []
            for name, g, w_ in zip(("y", "acts", "cseq"), got, want):
                abs_err, norm = _norm_err(g, w_)
                errs.append(f"{name} {norm:.3g}")
                if not norm <= K1_TOL:
                    _fail(f"K1-stash {stash} var_len={var_len}: {name} "
                          f"disagrees with its plain version: {norm}")
                worst = max(worst, abs_err)
            y_inf = LC.blstm_layer(*ws, x, lens)
            if not torch.equal(got[0], y_inf):
                _fail(f"K1-stash {stash}: y is not bit-identical to the "
                      f"inference variant")
            for l in range(2):
                for b in range(B):
                    if got[0][l, b, int(lens[l, b]):].any():
                        _fail("K1-stash: padded frames of y not zero")
            print(f"[K1-stash] L=2 B={B} T={T} D={D} H={H} stash={stash} "
                  f"var_len={var_len}: normalised errors {', '.join(errs)} "
                  f"(tol {K1_TOL}); y bit-identical to inference",
                  flush=True)
    # the main path's shape: 16 learners in one launch
    ws, x, lens = _stacked_inputs(L, B, T, D, H, gen, True)
    got = LC.blstm_layer_train(*ws, x, lens)
    for l in range(L):
        one = LC.blstm_layer_train(*(w[l:l + 1].contiguous() for w in ws),
                                   x[l:l + 1].contiguous(),
                                   lens[l:l + 1].contiguous())
        same = torch.equal(got[0][l], one[0][0]) and all(
            torch.equal(g[:, l], o[:, 0]) for g, o in zip(got[1:], one[1:]))
        if not same:
            _fail(f"K1-stash: learner {l} of a 16-learner launch differs "
                  f"from its own launch")
    print(f"[K1-stash] {L} learners in one launch == {L} one-learner "
          f"launches (bit-identical)", flush=True)
    ms = _time_ms(lambda: LC.blstm_layer_train(*ws, x, lens), 10)
    subs = _sub_launch_ms(lambda: LC.blstm_layer_train(*ws, x, lens), 5)
    plan, text = _recur_plan(L, B, T, H)
    print(f"[K1-stash] sub-launches, device ms per call: "
          f"{ {k: round(v, 4) for k, v in subs.items()} }; recurrence "
          f"{text}", flush=True)
    plain_ms = _time_ms(lambda: LC.blstm_layer_train(*ws, x, lens,
                                                     plain=True), 3,
                        warmup=1)
    lib = _library_ms(lambda: _cudnn_blstm_train(x, ws)[0], "K1-stash")
    library_ms = None if lib is None else _time_ms(lib, 10)
    n_valid = int(lens.sum())
    nbytes = (L * B * T * D * 2 + L * 2 * (D * 4 * H * 2 + H * 4 * H * 2
                                           + 4 * H * 4)
              + L * B * 4 + L * B * T * 2 * H * 2 + 2 * L * B * T * 5 * H * 4)
    ops = 2 * (2 * n_valid * D * 4 * H + 2 * n_valid * H * 4 * H)
    bound_ms, bound_by = _bound(nbytes, ops, PEAK_BF16_FLOPS)
    print(f"[K1-stash] L={L} B={B} T={T} D={D} H={H}: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, library {library_ms} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(name="blstm_layer_train", route="cuda",
                source="src/repro_torch/kernels/csrc/lstm_fwd.cu",
                replaces="src/repro/kernels/lstm_cell.py:498",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                sub_launch_ms=subs, recurrence=plan,
                shape=f"L={L} B={B} T={T} D={D} H={H} f32 stash")


def _recur_plan(L, B, T, H):
    """The forward recurrence's plan at this launch shape as a dict (path,
    tile rows, cluster size; for a resident plan also the clusters the
    card holds at once, cudaOccupancyMaxActiveClusters, and the waves of
    clusters the launch runs in) and as printed.  Fails where a resident
    cluster cannot be scheduled."""
    from repro_torch.kernels import lstm_cell as LC

    plan = LC.recur_plan(B, T, H)
    info = plan._asdict()
    text = (f"{plan.path}: clusters of C={plan.cluster} CTAs, tiles of "
            f"BB={plan.block_rows} rows")
    if plan.path == "resident":
        active = LC.active_clusters(plan, H)
        if active < 1:
            _fail(f"a resident recurrence cluster of {plan.cluster} CTAs "
                  f"cannot be scheduled: cudaOccupancyMaxActiveClusters "
                  f"{active}")
        info.update(active_clusters=active,
                    waves=LC.recur_waves(plan, L, B, active))
        text += (f", {active} clusters at once, {info['waves']} wave(s) of "
                 f"{2 * L * -(-B // plan.block_rows)} clusters")
    return info, text


def _reverse_plan(B, H):
    """The reverse recurrence's launch (it always streams) as a dict."""
    from repro_torch.kernels import lstm_cell as LC

    return LC.RecurPlan("stream", *LC._tile(B, H))._asdict()


def check_k2(gen):
    """K2 vs its plain version (dx, dWx, dWh, db); 16 learners in one
    launch equal to 16 launches of one."""
    import torch

    from repro_torch.kernels import lstm_cell as LC

    L, B, T, D, H = TRAIN_L, TRAIN_B, TRAIN_T, TRAIN_D, TRAIN_H

    def run(ws, x, lens, dy, stash, plain=False):
        y, acts, cseq = LC.blstm_layer_train(*ws, x, lens, stash=stash)
        return LC.blstm_layer_bwd(ws[0], ws[1], ws[3], ws[4], x, y, acts,
                                  cseq, dy, lens, plain=plain)

    worst = 0.0
    for var_len in (False, True):
        ws, x, lens = _stacked_inputs(2, B, T, D, H, gen, var_len)
        dy = torch.randn(2, B, T, 2 * H, generator=gen).to(
            x.device, torch.bfloat16)
        for stash in ("float32", "bfloat16"):
            dx, grads = run(ws, x, lens, dy, stash)
            torch.cuda.synchronize()
            dx_w, grads_w = run(ws, x, lens, dy, stash, plain=True)
            pairs = [("dx", dx, dx_w)] + [
                (f"{n}_{d}", g, w_) for d in range(2)
                for n, g, w_ in zip(("dwx", "dwh", "db"), grads[d],
                                    grads_w[d])]
            errs = []
            for name, g, w_ in pairs:
                abs_err, norm = _norm_err(g, w_)
                errs.append(f"{name} {norm:.3g}")
                if not norm <= K1_TOL:
                    _fail(f"K2 {stash} var_len={var_len}: {name} disagrees "
                          f"with its plain version: {norm}")
                worst = max(worst, abs_err)
            print(f"[K2] L=2 B={B} T={T} D={D} H={H} stash={stash} "
                  f"var_len={var_len}: normalised errors {', '.join(errs)} "
                  f"(tol {K1_TOL})", flush=True)
    ws, x, lens = _stacked_inputs(L, B, T, D, H, gen, True)
    dy = torch.randn(L, B, T, 2 * H, generator=gen).to(x.device,
                                                        torch.bfloat16)
    y, acts, cseq = LC.blstm_layer_train(*ws, x, lens)
    args = (ws[0], ws[1], ws[3], ws[4], x, y, acts, cseq, dy, lens)
    dx, grads = LC.blstm_layer_bwd(*args)
    for l in range(L):
        one = [a[l:l + 1].contiguous() for a in args[:6]] + [
            acts[:, l:l + 1].contiguous(), cseq[:, l:l + 1].contiguous(),
            dy[l:l + 1].contiguous(), lens[l:l + 1].contiguous()]
        dx1, grads1 = LC.blstm_layer_bwd(*one)
        same = torch.equal(dx[l], dx1[0]) and all(
            torch.equal(g[l], g1[0]) for d in range(2)
            for g, g1 in zip(grads[d], grads1[d]))
        if not same:
            _fail(f"K2: learner {l} of a 16-learner launch differs from "
                  f"its own launch")
    print(f"[K2] {L} learners in one launch == {L} one-learner launches "
          f"(bit-identical)", flush=True)
    ms = _time_ms(lambda: LC.blstm_layer_bwd(*args), 10)
    subs = _sub_launch_ms(lambda: LC.blstm_layer_bwd(*args), 5)
    plan = _reverse_plan(B, H)
    print(f"[K2] sub-launches, device ms per call: "
          f"{ {k: round(v, 4) for k, v in subs.items()} }; reverse "
          f"recurrence {plan}", flush=True)
    plain_ms = _time_ms(lambda: LC.blstm_layer_bwd(*args, plain=True), 3,
                        warmup=1)
    lib = _library_ms(lambda: _cudnn_blstm_train(x, ws)[1], "K2")
    library_ms = None if lib is None else _time_ms(lib, 10)
    n_valid = int(lens.sum())
    nbytes = (L * B * T * 2 * H * 2 * 2            # dy, y
              + 2 * L * B * T * 5 * H * 4          # f32 stash
              + L * B * T * D * 2 * 2              # x, dx
              + L * 2 * (D * 4 * H + H * 4 * H) * 2    # wx, wh
              + L * B * 4
              + L * 2 * (D * 4 * H + H * 4 * H + 4 * H) * 4)   # f32 dW, db
    ops = 2 * (2 * n_valid * 4 * H * (H + D + D + H) + n_valid * 4 * H)
    bound_ms, bound_by = _bound(nbytes, ops, PEAK_TF32_FLOPS)
    print(f"[K2] L={L} B={B} T={T} D={D} H={H}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, library {library_ms} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(name="blstm_layer_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/lstm_bwd.cu",
                replaces="src/repro/kernels/lstm_cell.py:656",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                sub_launch_ms=subs, recurrence=plan,
                shape=f"L={L} B={B} T={T} D={D} H={H} f32 stash")


GEMM_F64_TOL = 1e-5      # split products vs float64: f32 accuracy


def check_gemm_precision(gen):
    """The tensor-core GEMM routine (csrc/gemm.cuh) at the full training
    shape against float64 products on the card: x·Wx (``lstm_xproj``),
    dx's f32 sum of both directions (``lstm_bwd_dx``'s unrounded view),
    dWx, dWh and db (``lstm_bwd_dw``), each within 1e-5 of its largest
    value; the f32 dgates carry full mantissas.  Returns the worst
    normalised error of the forward's and the backward's products."""
    import torch

    from repro_torch.kernels import lstm_cell as LC

    L, B, T, D, H = TRAIN_L, TRAIN_B, TRAIN_T, TRAIN_D, TRAIN_H
    M, N = B * T, 4 * H
    ws, x, _ = _stacked_inputs(L, B, T, D, H, gen, False)
    wxf, wxb = ws[0], ws[3]
    y = torch.randn(L, B, T, 2 * H, generator=gen).to(x.device,
                                                       torch.bfloat16)
    dg = torch.randn(2, L, M, N, generator=gen).to(x.device)
    xm = x.double().view(L, M, D)
    errs = {}
    gx = LC._xproj(x.view(L, M, D), wxf, wxb)
    errs["x.Wx"] = max(_norm_err(gx[:, d], xm @ w.double())[1]
                       for d, w in enumerate((wxf, wxb)))
    del gx
    dx = LC._bwd_dx(dg, wxf, wxb, f32_out=True)
    errs["dx"] = _norm_err(dx, dg[0].double() @ wxf.double().transpose(1, 2)
                           + dg[1].double() @ wxb.double().transpose(1, 2))[1]
    del dx
    dwx, dwhb = LC._bwd_dw(x, y, dg)
    for d in range(2):
        errs[f"dWx_{d}"] = _norm_err(
            dwx[d], xm.transpose(1, 2) @ dg[d].double())[1]
        h = y[..., d * H:(d + 1) * H].double()
        prev = torch.zeros_like(h)       # h_{t-1}: t - 1 forward, t + 1 back
        if d == 0:
            prev[:, :, 1:] = h[:, :, :-1]
        else:
            prev[:, :, :-1] = h[:, :, 1:]
        want = prev.view(L, M, H).transpose(1, 2) @ dg[d].double()
        errs[f"dWh_{d}"] = _norm_err(dwhb[d, :, :H], want)[1]
        errs[f"db_{d}"] = _norm_err(dwhb[d, :, H], dg[d].double().sum(1))[1]
    torch.cuda.synchronize()
    print(f"[gemm-f64] L={L} M={M} D={D} N={N}: normalised errors vs "
          f"float64 {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} "
          f"(tol {GEMM_F64_TOL})", flush=True)
    for k, v in errs.items():
        if not v <= GEMM_F64_TOL:
            _fail(f"the GEMM routine's {k} is {v} from float64")
    return errs["x.Wx"], max(v for k, v in errs.items() if k != "x.Wx")


def _k5_states(B, K, V, gen):
    """Beam states the serving path meets: a few frames into a decode of
    peaked posteriors, plus fresh beams capped at length 0 (one live
    candidate per row, so later passes repeat a taken index)."""
    import torch

    from repro_torch.decode import beam as DB

    dev = torch.device("cuda")
    st = DB.init_state(B, K, 64, dev)
    for _ in range(6):
        lp = torch.log_softmax(
            torch.randn(B, V, generator=gen).to(dev) * 3.0, dim=-1)
        sel, npb, npnb = DB.frame_step_scores(
            lp, st.p_b, st.p_nb, st.last, st.phash, st.lens, blank=0,
            max_len=64, semiring="max")
        st = DB.apply_selection(st, sel, npb, npnb, blank=0, vocab=V)
    fresh = DB.init_state(B, K, 64, dev)
    return [("mid-utterance", st, 64), ("fewer-live-than-beam", fresh, 0)]


K5_BATCHES = (4, 8)      # serve's rows, evaluate's (both timed)


def _k5_bound(B, K, V, topc):
    """Bytes (the row in; the state in, the outputs out) and compares."""
    nbytes = B * V * 4 + B * K * 4 * 5 + B * K * 4 * 3
    ops = (B * V + B * K * (topc + 1) * 2) if topc else B * K * V * 2
    return _bound(nbytes, ops, PEAK_F32_FLOPS)


def check_k5(gen):
    """K5 against the plain frame step at serve's B = 4 and evaluate's B =
    8 (K = 8, V = 32000), both bodies, both semirings and both states:
    sel and the max-semiring scores bit-equal, the sum semiring's within
    K5_SUM_TOL; then both shapes timed (eager, and graph-replayed per
    call) beside the plain step and the bound, with the plan (CTAs a row,
    ``decode.kernel.beam_slices``)."""
    import torch

    from repro_torch.decode import beam as DB
    from repro_torch.decode import kernel as DK

    K, V = 8, 32000
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    entries = {}
    for topc in (0, 16):
        worst = 0.0
        timed = {}
        for B in K5_BATCHES:
            logp = torch.log_softmax(
                torch.randn(B, V, generator=gen).to(dev) * 3.0,
                dim=-1).contiguous()
            for semiring in ("max", "sum"):
                for label, st, max_len in _k5_states(B, K, V, gen):
                    args = (logp, st.p_b, st.p_nb, st.last, st.phash,
                            st.lens)
                    kw = dict(blank=0, max_len=max_len, semiring=semiring)
                    got = DK.beam_frame_step(*args, topc=topc, **kw)
                    torch.cuda.synchronize()
                    want = (DB.frame_step_scores_topc(*args, topc=topc, **kw)
                            if topc else DB.frame_step_scores(*args, **kw))
                    if not torch.equal(got[0], want[0]):
                        _fail(f"K5 B={B} topc={topc} {semiring} {label}: "
                              f"sel {got[0].tolist()} != {want[0].tolist()}")
                    err = max(float((g - w).abs().max())
                              for g, w in zip(got[1:], want[1:]))
                    tol = 0.0 if semiring == "max" else K5_SUM_TOL
                    ok = (all(torch.equal(g, w) for g, w in
                              zip(got[1:], want[1:])) if semiring == "max"
                          else all(torch.allclose(g, w, rtol=tol, atol=tol)
                                   for g, w in zip(got[1:], want[1:])))
                    print(f"[K5] beam_frame_step B={B} topc={topc} "
                          f"{semiring} {label}: sel equal, score max_abs_err "
                          f"{err:.3g} (tol {tol})", flush=True)
                    if not ok:
                        _fail(f"K5 B={B} topc={topc} {semiring} {label}: "
                              f"scores disagree (max_abs_err {err})")
                    worst = max(worst, err)
            st = _k5_states(B, K, V, gen)[0][1]
            args = (logp, st.p_b, st.p_nb, st.last, st.phash, st.lens)
            kw = dict(blank=0, max_len=64, semiring="max")
            call = lambda: DK.beam_frame_step(*args, topc=topc, **kw)  # noqa
            ms = _time_ms(call, 50)
            device = _device_ms(call)
            plain = ((lambda: DB.frame_step_scores_topc(*args, topc=topc,
                                                        **kw))
                     if topc else (lambda: DB.frame_step_scores(*args, **kw)))
            plain_ms = _time_ms(plain, 5)
            bound_ms, bound_by = _k5_bound(B, K, V, topc)
            slices = DK.beam_slices(B, V, n_sm)
            timed[B] = dict(ms=ms, device_ms=device, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            plan=dict(slices=slices, ctas=B * slices),
                            shape=f"B={B} K={K} V={V} C={topc}")
            print(f"[K5] B={B} topc={topc}: kernel {ms:.4f} ms, device "
                  f"{_ms(device)} per call, plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.5f} ms ({bound_by}); plan: {slices} CTAs a "
                  f"row (one cluster), {B * slices} CTAs", flush=True)
        name = "beam_frame_step_topc" if topc else "beam_frame_step"
        serve = timed[K5_BATCHES[0]]
        entries[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/decode/csrc/beam_step.cu",
            replaces="src/repro/decode/kernel.py:123", max_abs_err=worst,
            library_ms=None, **serve,
            evaluate_shape=timed[K5_BATCHES[1]])
    return entries


# K4 at the serving admission's shape (B = 1, T = 256, a 173-frame
# utterance: 1-row resident tiles) and evaluate's (B = 8, T = 256, var-len
# with a length-1 row: 4-row tiles, one wave), both timed; a small ragged
# case (B = 5 in a tile of 8, H = 16, 3 layers: the item path) first; and
# B = 16 at T = 21, 2 layers, where the K1 loop runs two 8-row tiles on
# clusters of 2 and K4 four 4-row tiles a direction on clusters of 16, in
# two waves
K4_CASES = [(5, 9, 12, 16, 3, (9, 4, 1, 9, 6)),
            (1, 256, 260, 512, 6, (173,)),
            (8, 256, 260, 512, 6, (256, 240, 199, 150, 97, 64, 12, 1)),
            (16, 21, 260, 512, 2,
             (21, 20, 19, 17, 15, 13, 11, 9, 7, 5, 3, 2, 1, 21, 21, 8))]
K4_TIMED = (1, 8)        # the batch sizes of the timed shapes


def _stack_inputs(n_layers, B, T, D0, H, lengths, gen):
    """Random layers (``_k1_inputs``' scales) of a stack: layer 0 reads
    D0 features, the others 2H; x and lengths."""
    layers, x, lens = [], None, None
    D = D0
    for k in range(n_layers):
        ws, xk, lk = _k1_inputs(B, T, D, H, lengths, gen)
        layers.append(ws)
        if k == 0:
            x, lens = xk, lk
        D = 2 * H
    return layers, x, lens


def _stack_bytes_ops(layers, x, lengths):
    """K4's bound: x, every weight and bias, the lengths and y once; the
    x- and h-products of the valid frames (every layer, both
    directions) at the bf16 peak."""
    B, T, _ = x.shape
    H = layers[0][1].shape[0]
    n_valid = int(lengths.sum())
    nbytes = (x.numel() * 2 + B * 4 + B * T * 2 * H * 2
              + sum(w.numel() * w.element_size() for ws in layers
                    for w in ws))
    ops = sum(2 * 2 * n_valid * (ws[0].shape[0] + H) * 4 * H
              for ws in layers)
    return nbytes, ops


def _row_norm_err(got, want) -> tuple:
    """(max abs error, worst per-utterance error over that utterance's
    largest |want|): a length-1 row is held at its own scale."""
    got, want = got.float(), want.float()
    diff = (got - want).abs().flatten(1).amax(1)
    return (float(diff.max()),
            float((diff / (want.abs().flatten(1).amax(1) + 1e-6)).max()))


def _stack_plan(B, H):
    """K4's plan at this shape (``lstm_cell.stack_plan``) as a dict, with
    the clusters the card holds at once on the resident path, and as
    printed."""
    from repro_torch.kernels import lstm_cell as LC

    active = LC.stack_active_clusters(H) if LC.stack_resident(H) else 0
    plan = LC.stack_plan(B, H, active)
    text = f"{plan.path}, tiles of {plan.block_rows} rows"
    if plan.path == "resident":
        text += (f", {plan.clusters} clusters of {LC.RESIDENT_CLUSTER} CTAs "
                 f"in {plan.waves} wave(s) of the {active} the card holds")
    return dict(plan._asdict(), active_clusters=active), text


def check_k4(gen):
    """The fused stack (K4 port) against its plain version (2e-2 per
    utterance, every value finite) and bit-identical to the per-layer K1
    loop, each case's plan printed; both full-width shapes timed (eager,
    and one launch replayed from a CUDA graph) beside the K1 loop, the
    plain version, the bound and cuDNN's stacked bidirectional LSTM.  The
    K1 launches of the loop are comparisons, not the main path: the
    counters are restored."""
    import torch

    from repro_torch.kernels import lstm_cell as LC
    from repro_torch.kernels.ref import blstm_stack_plain

    saved = (LC.launches, LC.stack_launches)
    worst, timings = 0.0, {}
    for B, T, D0, H, n_layers, lens in K4_CASES:
        layers, x, lengths = _stack_inputs(n_layers, B, T, D0, H, lens, gen)
        got = LC.blstm_stack(layers, x, lengths)
        torch.cuda.synchronize()

        def loop():
            y = x
            for ws in layers:
                y = LC.blstm_layer(*ws, y, lengths)
            return y
        same = torch.equal(got, loop())
        want = blstm_stack_plain(layers, x, lengths)
        abs_err, norm = _row_norm_err(got, want)
        shape = f"B={B} T={T} D0={D0} H={H} L={n_layers}"
        plan, plan_text = _stack_plan(B, H)
        print(f"[K4] blstm_stack {shape} lengths={lens} ({plan_text}): "
              f"bit-identical to the K1 loop {same}; vs plain max_abs_err "
              f"{abs_err:.3g}, worst per-utterance {norm:.3g} (tol "
              f"{K1_TOL})", flush=True)
        if not torch.isfinite(got).all():
            _fail(f"K4 {shape}: non-finite output")
        if not same:
            _fail(f"K4 {shape} is not bit-identical to the per-layer loop")
        if not norm <= K1_TOL:
            _fail(f"K4 {shape} disagrees with its plain version: {norm}")
        for b, n in enumerate(lens):
            if got[b, n:].any():
                _fail(f"K4 {shape}: padded frames of row {b} not zero")
        worst = max(worst, abs_err)
        if T != 256 or B not in K4_TIMED:
            continue
        ms = _time_ms(lambda: LC.blstm_stack(layers, x, lengths), 5)
        dev_ms = _device_ms(lambda: LC.blstm_stack(layers, x, lengths),
                            iters=3, reps=2)
        loop_ms = _time_ms(loop, 5)
        loop_dev_ms = _device_ms(loop, iters=3, reps=2)
        plain_ms = _time_ms(lambda: blstm_stack_plain(layers, x, lengths),
                            1, warmup=1)
        library_ms = _library_ms(lambda: _time_ms(
            _cudnn_stack(layers, x, lengths), 5), "K4")
        bound_ms, bound_by = _bound(*_stack_bytes_ops(layers, x, lengths),
                                    PEAK_BF16_FLOPS)
        timings[B] = dict(ms=ms, device_ms=dev_ms, k1_loop_ms=loop_ms,
                          k1_loop_device_ms=loop_dev_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, plan=plan)
        print(f"[K4] {shape}: kernel {ms:.3f} ms (device {_ms(dev_ms)}), "
              f"K1 loop {loop_ms:.3f} ms (device {_ms(loop_dev_ms)}), plain "
              f"{plain_ms:.1f} ms, library {library_ms} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    LC.launches, LC.stack_launches = saved
    serve, ev = timings[1], timings[8]
    return dict(name="blstm_stack", route="cuda",
                source="src/repro_torch/kernels/csrc/lstm_stack.cu",
                replaces="src/repro/kernels/lstm_cell.py:1238",
                max_abs_err=worst, **serve, evaluate_shape=ev,
                shape="B=1 T=256 D0=260 H=512 L=6")


# ---------------------------------------------------------------- phase 4
def _serve(cfg, *, requests, topc):
    import torch

    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import lstm_cell
    from repro_torch.launch.serve import AsrServer, asr_requests, serve_all

    server = AsrServer(cfg, slots=4, max_frames=256, chunk=8, beam=8,
                       seed=SEED, topc=topc)
    pending = asr_requests(cfg, requests=requests, seq_len=256, seed=SEED)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    finished, wave_s = serve_all(server, pending)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {"blstm_stack": lstm_cell.stack_launches,
              "blstm_layer": lstm_cell.launches,
              "beam_frame_step_topc" if topc else "beam_frame_step":
              DK.launches}
    return server, pending, finished, wave_s, dt, counts


def phase_serve():
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import lstm as LS

    cfg = get_arch("swb2000-blstm")
    launches = {}
    for requests, topc in ((8, 0), (4, 16)):
        server, pending, finished, wave_s, dt, counts = _serve(
            cfg, requests=requests, topc=topc)
        got = sorted(rid for rid, _ in finished)
        if got != [rid for rid, _ in pending]:
            _fail(f"served {got}, expected every one of {len(pending)}")
        admits = sum(1 for kind, _, _ in server.events if kind == "admit")
        if (counts.pop("blstm_layer"), counts["blstm_stack"]) != (0, admits):
            _fail(f"serve: {counts} launches for {admits} admissions: the "
                  f"stack kernel runs once per admission, K1 never")
        for name, n in counts.items():
            if n <= 0:
                _fail(f"kernel {name} was never launched on the main path")
            launches.setdefault(name, n)     # each kernel's first path
        frames = sum(len(f) for _, f in pending)
        toks = sum(len(h) for _, h in finished)
        if any(h and (min(h) < 0 or max(h) >= cfg.vocab)
               for _, h in finished):
            _fail("a hypothesis holds a token outside the vocabulary")
        print(f"[serve] topc={topc}: {len(finished)} requests, {frames} "
              f"frames, {toks} tokens, {len(wave_s)} waves in {dt:.3f}s: "
              f"{frames / dt:.1f} frames/s, {toks / dt:.1f} tokens/s, mean "
              f"wave {1e3 * float(np.mean(wave_s)):.2f} ms; launches "
              f"{counts}", flush=True)
    # parked posteriors of the last request admitted to slot 0 against the
    # plain forward (on the CPU, from the same weights)
    rid = [r for k, r, kw in server.events
           if k == "admit" and kw["slot"] == 0][-1]
    feats = dict(pending)[rid]
    n = len(feats)
    padded = np.zeros((1, server.max_frames, cfg.input_dim), np.float32)
    padded[0, :n] = feats
    want = LS.forward(cfg, _to_cpu(server.params), torch.from_numpy(padded),
                      torch.tensor([n], dtype=torch.int32), device="cpu")[0]
    got = server.logits[0].cpu()
    if not torch.isfinite(got).all() or got.shape != want.shape:
        _fail(f"parked logits not finite or shape {tuple(got.shape)}")
    abs_err, norm = _norm_err(got, want)
    print(f"[serve] parked logits of request {rid} ({n} frames) vs plain "
          f"forward: max_abs_err {abs_err:.3g}, normalised {norm:.3g} "
          f"(tol {K1_TOL})", flush=True)
    if not norm <= K1_TOL:
        _fail(f"parked logits disagree with the plain forward: {norm}")
    return launches


def phase_profile():
    """Where the serving time goes: the main path once more (4 requests)
    under torch.profiler, device time by kernel and the device's busy
    share of the wall time."""
    from repro_torch.configs import get_arch

    got = _profile_window(lambda: _serve(get_arch("swb2000-blstm"),
                                         requests=4, topc=0), "profile")
    if got is None:
        return
    served, _, busy_ms, rows = got
    dt = served[4]
    print(f"[profile] serve 4 requests: wall {1e3 * dt:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / (1e3 * dt):.1f}%)",
          flush=True)
    for us, n, key in rows[:8]:
        print(f"[profile]   {us / 1e3:9.2f} ms  {n:6d}x  {key[:70]}",
              flush=True)


TRAIN_WARMUP, TRAIN_STEPS = 2, 10


def _train_counts():
    from repro_torch.kernels import lstm_cell as LC

    return {"blstm_layer_train": LC.stash_launches,
            "blstm_layer_bwd": LC.bwd_launches}


def _zero_counts():
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import lstm_cell as LC

    LC.launches = LC.stash_launches = LC.bwd_launches = 0
    LC.chunk_launches = LC.chunked_bwd_launches = LC.stack_launches = 0
    DK.launches = 0


def phase_train():
    """The paper's §V training setup at full width: ad_psgd over 16
    learners, global batch 256, T = 21, variable-length utterances;
    warm-up steps, then timed steps, all with the launch counters set to
    0 just before and read just after.  Then one step's loss and
    gradients of the kernel path against the plain path on the card."""
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import strategies as ST
    from repro_torch.data import make_dataset
    from repro_torch.launch.train import run, setup_training, timing_line
    from repro_torch.models import lstm as LS

    cfg = get_arch("swb2000-blstm")
    dev = torch.device("cuda")
    L, batch, T = TRAIN_L, TRAIN_L * TRAIN_B, TRAIN_T
    t0 = time.perf_counter()
    state, step, meta = setup_training(cfg, strategy_name="ad_psgd",
                                       n_learners=L, seed=SEED)
    ds = make_dataset(cfg, seq_len=T, batch=batch, seed=SEED, var_len=True)
    torch.cuda.synchronize()
    n_params = sum(w[0].numel() for w in ST._leaves(state["params"]))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f} M params per learner, "
          f"{L} learners, ad_psgd, batch {batch}, T={T}, var-len; set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, metrics, records = run(state, step, ds, steps=steps, device=dev,
                                  log_every=1, label="[train] ")
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, n in counts.items():
        if n <= 0:
            _fail(f"kernel {name} was never launched on the training path")
    losses = [float(r[3]) for r in records]
    if not all(math.isfinite(v) for v in losses):
        _fail(f"non-finite training loss: {losses}")
    timed = records[TRAIN_WARMUP:]
    ms = 1e3 * sum(r[0] for r in timed) / len(timed)
    fps = sum(r[1] for r in timed) / sum(r[0] for r in timed)
    print(f"[train] {timing_line(records)}", flush=True)
    print(f"[train] {len(timed)} timed steps: {ms:.2f} ms/step, {fps:.1f} "
          f"valid frames/s; launches {counts} over {steps} steps "
          f"({ {k: v / steps for k, v in counts.items()} } per step); peak "
          f"device memory {peak_gb:.2f} GiB", flush=True)

    # one step's loss and gradients, kernel path vs plain path, at the
    # parameters the next ad_psgd step takes its gradient at
    lb = ST.split_learner_batch(
        {k: torch.as_tensor(v).to(dev)
         for k, v in ds.batch_at(steps).items()}, L)
    loss, grads = ST._value_and_grad(meta["loss_fn"], state["prev_params"],
                                     lb)
    plain_fn = lambda p, b: LS.loss_train(cfg, p, b, device=dev, plain=True)
    loss_w, grads_w = ST._value_and_grad(plain_fn, state["prev_params"], lb)
    if not torch.isfinite(loss).all():
        _fail("non-finite loss in the gradient check")
    loss_err = float(((loss - loss_w).abs() / loss_w.abs()).max())
    worst, where = 0.0, None
    for (key, g), w_ in zip(_named_leaves(grads), ST._leaves(grads_w)):
        if not torch.isfinite(g).all():
            _fail(f"non-finite gradient {key}")
        _, norm = _norm_err(g, w_)
        if norm > worst:
            worst, where = norm, key
    print(f"[train] kernel vs plain path, one step at 16 learners: loss "
          f"relative error {loss_err:.3g}, worst normalised gradient error "
          f"{worst:.3g} ({where}) (tol {K1_TOL})", flush=True)
    if not (loss_err <= K1_TOL and worst <= K1_TOL):
        _fail("the kernel path's loss or gradients disagree with the "
              "plain path")
    del grads, grads_w
    return state, step, ds, counts, steps, ms, losses


def _named_leaves(tree, prefix=""):
    """(path, leaf) of every leaf of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _named_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def phase_train_profile(state, step, ds, start, tag="train-profile"):
    """Where the training time goes: one step under torch.profiler."""
    import torch

    from repro_torch.launch.train import run

    dev = torch.device("cuda")
    got = _profile_window(lambda: run(state, step, ds, steps=1, device=dev,
                                      start=start), tag)
    if got is None:
        return
    (_, _, records), _, busy_ms, rows = got
    wall_ms = 1e3 * records[0][0]
    print(f"[{tag}] one ad_psgd step: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)", flush=True)
    for us, n, key in rows[:10]:
        print(f"[{tag}]   {us / 1e3:9.2f} ms  {n:6d}x  {key[:70]}",
              flush=True)


# ---------------------------------------------------------------- phase 7a
EVAL_ARGS = ["--arch", "swb2000-blstm", "--strategy", "ad_psgd",
             "--learners", "16", "--batches", "4", "--batch", "8",
             "--seq-len", "256", "--var-len", "--beam-width", "8",
             "--decode-chunk", "8"]


def phase_evaluate(state):
    """Recognition scoring of the train phase's 16-learner state: saved
    through the port's checkpoint module, restored and scored by the
    evaluate CLI with the counters set to 0 just before and read just
    after; then the first batch's logits held bit-identical to the
    per-layer K1 loop and within 2e-2 of the plain forward, and its final
    K5 beam state (every slot's prefix and scores) equal to the plain
    beam decode's.  Returns the launch counts of the run and the K1
    launches of the loop check."""
    import tempfile

    import torch

    from repro_torch import checkpoint as CK
    from repro_torch import decode as DC
    from repro_torch.configs import get_arch
    from repro_torch.decode import beam as DB
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import lstm_cell as LC
    from repro_torch.launch import evaluate as EV
    from repro_torch.models import lstm as LS

    cfg = get_arch("swb2000-blstm")
    with tempfile.TemporaryDirectory() as ck:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = Path(CK.save(ck, state["step"], state))
        secs = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in path.iterdir())
        print(f"[evaluate] checkpoint of step {state['step']} (16 learners, "
              f"ad_psgd): {nbytes} bytes saved in {secs:.2f}s", flush=True)
        # record what the CLI's forward and decode return, batch by batch
        calls, finals = [], []
        forward, finalize = LS.forward, DC.finalize

        def rec_forward(*a, **kw):
            out = forward(*a, **kw)
            calls.append((a, out))
            return out

        def rec_finalize(st, **kw):
            finals.append(st)
            return finalize(st, **kw)
        LS.forward, DC.finalize = rec_forward, rec_finalize
        try:
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            m = EV.main(EVAL_ARGS + ["--ckpt-dir", ck])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {"blstm_stack": LC.stack_launches,
                      "blstm_layer": LC.launches,
                      "beam_frame_step": DK.launches}
        finally:
            LS.forward, DC.finalize = forward, finalize
    frames = sum(a[2].shape[1] for a, _ in calls)
    print(f"[evaluate] {len(calls)} forwards (warm-up included), restore "
          f"and scoring in {dt:.2f}s; the {len(calls) - 1} timed batches: "
          f"forward {1e3 * m['forward_s']:.1f} ms, decode "
          f"{1e3 * m['decode_s']:.1f} ms; launches {counts}", flush=True)
    if counts != {"blstm_stack": len(calls), "blstm_layer": 0,
                  "beam_frame_step": frames}:
        _fail(f"evaluate launches {counts}: expected K4 once per forward "
              f"({len(calls)}), K1 never, K5 once per decoded frame "
              f"({frames})")
    (_, params, feats, lengths), logits = calls[0]
    if not torch.isfinite(logits).all() or logits.shape != (
            feats.shape[0], feats.shape[1], cfg.vocab):
        _fail(f"evaluate logits not finite or shape {tuple(logits.shape)}")

    def k1_loop(layers, x, lens):
        for ws in layers:
            x = LC.blstm_layer(*ws, x, lens)
        return x
    stack = LS.blstm_stack
    LS.blstm_stack = k1_loop
    try:
        LC.launches = 0
        with torch.no_grad():
            loop = LS.forward(cfg, params, feats, lengths,
                              device=lengths.device)
        k1_launches = LC.launches
    finally:
        LS.blstm_stack = stack
    with torch.no_grad():
        plain = LS.forward(cfg, params, feats, lengths,
                           device=lengths.device, plain=True)
    abs_err, norm = _row_norm_err(logits, plain)
    same = torch.equal(logits, loop)
    print(f"[evaluate] first batch ({feats.shape[0]} x {feats.shape[1]}, "
          f"lengths {lengths.tolist()}): consensus logits bit-identical to "
          f"the per-layer K1 loop {same} ({k1_launches} K1 launches); vs "
          f"plain max_abs_err {abs_err:.3g}, worst per-utterance "
          f"{norm:.3g} (tol {K1_TOL})", flush=True)
    if not same:
        _fail("evaluate: the stack's logits differ from the K1 loop's")
    if not norm <= K1_TOL:
        _fail(f"evaluate logits disagree with the plain forward: {norm}")
    # the whole final beam state of the first batch (every slot, not only
    # the best hypothesis) against the plain decode of the same logits on
    # the card: the same decode with K5's plain frame step in its place
    # (on the CPU, log_softmax rounds the log-probabilities apart)
    state = finals[0]
    kernel_step = DK.beam_frame_step

    def plain_step(*a, topc=0, **kw):
        return DB.frame_step_scores(*a, **kw)
    DK.beam_frame_step = plain_step
    try:
        want = DC.decode_chunk(
            DC.init_state(feats.shape[0], state.p_b.shape[1],
                          feats.shape[1], logits.device), logits, lengths,
            blank=0, semiring="max")
    finally:
        DK.beam_frame_step = kernel_step
    diff = [f for f in state._fields
            if not torch.equal(getattr(state, f), getattr(want, f))]
    toks, lens, _ = finalize(state)
    print(f"[evaluate] K5 beam state of the first batch vs the plain beam "
          f"decode: fields that differ {diff}; {int(state.lens.sum())} "
          f"tokens over its {state.lens.numel()} beam slots, "
          f"{int(lens.sum())} in the best hypotheses", flush=True)
    if diff:
        _fail(f"evaluate: K5's beam state differs from the plain decode in "
              f"{diff}")
    return counts, k1_launches


# ------------------------------------------------------- phase 7a-multirank
MULTIRANK_MIX_CALLS = 3      # timed calls of the exchange alone, after one
MULTIRANK_S = 420            # the most the ranks may take, or one wait
ELASTIC_REJOIN = 6           # plan (a)'s rejoin step


def _multirank_runs(world: int) -> tuple:
    """(name, strategy, extra config, steps, fault plan): the §V step
    over a learner axis split across ``world`` ranks, each held bit for
    bit against the same steps in one process.  hring's pods are the
    ranks' blocks (the paper's H-ring: the pod mean local, the ring of
    pod means across ranks); sc_psgd_replicated mixes through the ordered
    chain; 7a-comm's coded wires (ad_psgd_q8 with 4 MB buckets, hring
    with a bf16 intra-pod and a top-k inter-pod wire, pods of 4 inside
    the blocks); 7a-elastic's plans, (a) through its rejoin and (b) over
    int8 with a pod down (``_elastic_plan``)."""
    coded_hring = dict(comm_pod_size=4, comm_intra_wire="bf16",
                       comm_wire="topk", comm_topk_frac=0.01,
                       comm_bucket_mb=4)
    return (("ad_psgd", "ad_psgd", {}, 3, None),
            ("hring", "hring", {"comm_pod_size": TRAIN_L // world}, 2, None),
            ("sc_psgd_replicated", "sc_psgd_replicated", {}, 2, None),
            ("ad_psgd_q8", "ad_psgd_q8", {"comm_bucket_mb": 4}, 3, None),
            ("hring-bf16-topk", "hring", coded_hring, 3, None),
            ("elastic-a", "ad_psgd",
             {"comm_staleness_lambda": ELASTIC_LAMBDA}, ELASTIC_REJOIN + 1,
             "a"),
            ("elastic-b", "hring", {"comm_pod_size": 4, "comm_wire": "int8"},
             ELASTIC_HRING_STEPS, "b"))


def _exchange_ms(mix, device) -> float:
    """Mean host ms of ``mix(k)``, the transport's mix of the final
    params (one warm-up, then :data:`MULTIRANK_MIX_CALLS` calls, each
    rank in step)."""
    import torch

    mix(0)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for k in range(MULTIRANK_MIX_CALLS):
        mix(k)
    torch.cuda.synchronize(device)
    return 1e3 * (time.perf_counter() - t0) / MULTIRANK_MIX_CALLS


def _multirank_setup(strategy, knobs, device, plan):
    """The train phase's set-up for one run of :func:`_multirank_runs`:
    seed-0 weights, ``strategy`` over TRAIN_L learners (this rank's block
    of them under a process group), the gradient norm on, the §V data;
    the elastic step under ``plan`` ('a' or 'b': ``_elastic_plan``).
    Returns (state, step, meta, data, FaultPlan or None)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import make_dataset
    from repro_torch.launch.train import setup_training

    cfg = dataclasses.replace(get_arch("swb2000-blstm"), **knobs)
    faults = _elastic_plan(TRAIN_L, plan == "b") if plan else None
    state, step, meta = setup_training(
        cfg, strategy_name=strategy, n_learners=TRAIN_L, seed=SEED,
        device=device, with_grad_norm=True, elastic=faults is not None,
        fault_seed=faults.seed if faults else 0,
        with_corruption=bool(faults and faults.corrupt_prob > 0))
    ds = make_dataset(cfg, seq_len=TRAIN_T, batch=TRAIN_L * TRAIN_B,
                      seed=SEED, var_len=True)
    return state, step, meta, ds, faults


def _state_digests(state, whole) -> dict:
    """The bits of every state leaf but ``step``, as SHA-256 digests:
    path -> (dtype, trailing shape, [digest of each learner row]) for a
    leaf split over ranks, and [the digest of the whole leaf] for one
    under the keys every rank holds whole (``whole``).  Equal digests are
    equal bits; the ranks' rows in order are one process's stack, and no
    copy of a full-width state is kept."""
    import hashlib

    import torch

    out = {}
    for key, tree in state.items():
        if key == "step":
            continue
        for path, leaf in _named_leaves(tree, key):
            t = leaf.detach().contiguous().cpu()
            rows = ([t] if key in whole or t.dim() == 0
                    else list(t.unbind(0)))
            out[path] = (str(t.dtype), tuple(t.shape[1:]), [
                hashlib.sha256(r.contiguous().reshape(-1).view(
                    torch.uint8).numpy().tobytes()).hexdigest()
                for r in rows])
    return out


def _multirank_mixer(state, meta, faults, steps):
    """``mix(k)``: the run's own mix of its final params at step k (the
    elastic one under the last step's masks and the final counters)."""
    t = meta["transport"]
    params = state["params"]
    if faults is None:
        mix = t.make_mixer(TRAIN_L)
        return lambda k: mix(params, k, state.get("comm", {}))
    emix = t.make_elastic_mixer(TRAIN_L, fault_seed=faults.seed,
                                with_corruption=faults.corrupt_prob > 0)
    f = faults.step_inputs(steps - 1)
    stale = state["staleness"].numpy()
    return lambda k: emix(params, k, f["active"], stale, f["edge_ok"],
                          f["corrupt"])


def _multirank_run(name, strategy, knobs, steps, plan, dev):
    """One run of :func:`_multirank_runs` on this process's block (the
    whole stack in one process), the launch counters and the sent bytes
    set to 0 just before its steps and read just after, then the
    exchange alone.  Returns its record."""
    import torch

    from repro_torch.core import collective as C
    from repro_torch.core import strategies as ST
    from repro_torch.launch.train import run

    state, step, meta, ds, faults = _multirank_setup(strategy, knobs, dev,
                                                     plan)
    torch.cuda.synchronize(dev)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    _zero_counts()
    C.reset_sent()
    state, metrics, records = run(state, step, ds, steps=steps, device=dev,
                                  plan=faults)
    counts = _train_counts()
    sent = dict(C.sent_bytes)
    whole = ST.whole_keys(state, meta["transport"])
    out = dict(digests=_state_digests(state, whole), counts=counts,
               sent=sent, whole=whole,
               losses=[float(r[3]) for r in records],
               metrics={k: float(v) for k, v in metrics.items()},
               step_ms=[1e3 * r[0] for r in records], steps=steps,
               mix_ms=_exchange_ms(_multirank_mixer(state, meta, faults,
                                                    steps), dev))
    del state, step, meta
    torch.cuda.empty_cache()
    return out


def _multirank_rank(rank, world, rdv, out_dir, backend):
    """One rank of phase 7a-multirank: joins the group over ``rdv`` (a
    file rendezvous) through ``launch.multihost.initialize``, which takes
    its card (the shared card under gloo, ``cuda:rank`` under nccl) and
    picks the backend, held to ``backend``; runs every
    :func:`_multirank_runs` entry on its block (:func:`_multirank_run`)
    and writes its blocks, losses, metrics, times, sent bytes and counts
    to ``out_dir``."""
    import torch

    from repro_torch.launch import multihost

    # a collective that waits past MULTIRANK_S raises in the rank
    if not multihost.initialize(init_method=f"file://{rdv}",
                                num_processes=world, process_id=rank,
                                timeout=MULTIRANK_S):
        raise RuntimeError("no process group after the rendezvous")
    try:
        place = multihost.placement()
        if place.device.type != "cuda" or place.backend != backend:
            raise RuntimeError(f"rank {rank} placed as {place}")
        result = {"placement": place.describe()}
        for name, strategy, knobs, steps, plan in _multirank_runs(world):
            result[name] = _multirank_run(name, strategy, knobs, steps,
                                          plan, place.device)
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def _same_state(name, one, parts) -> None:
    """The ranks' state digests (:func:`_state_digests`) against one
    process's: the same leaves, dtypes and trailing shapes; a split
    leaf's rows over the ranks in order, a whole one's on every rank.
    Fails the run naming the first leaf that differs."""
    if parts[0]["whole"] != one["whole"]:
        _fail(f"[multirank] {name}: the ranks hold {parts[0]['whole']} "
              f"whole, one process {one['whole']}")
    want = one["digests"]
    for r, p in enumerate(parts):
        if list(p["digests"]) != list(want):
            _fail(f"[multirank] {name}: rank {r}'s state has other leaves "
                  f"than the one-process run's")
    for path, (dtype, shape, rows) in want.items():
        got = [p["digests"][path] for p in parts]
        if any(g[:2] != (dtype, shape) for g in got):
            _fail(f"[multirank] {name}: {path} has another dtype or shape "
                  f"than the one-process run's")
        whole = path.split("/")[0] in one["whole"]
        if (any(g[2] != rows for g in got) if whole
                else [d for g in got for d in g[2]] != rows):
            _fail(f"[multirank] {name}: {path} differs from the one-process "
                  f"run")


def phase_multirank(train_losses, *, backend="gloo", world=2):
    """Decentralized training with the learner axis split over ``world``
    ranks (two ranks sharing the one card over gloo, payloads staged
    through host memory; or, from ``tools/multicard_smoke.py``, one rank a
    card over nccl): each run of :func:`_multirank_runs` in one process
    first (its ms/step, the exchange's ms), then in the ranks; every state
    leaf (params, prev_params, the optimizer's, the EF residual and
    estimate, the staleness counters: the split ones concatenated over the
    ranks, those every rank holds whole equal on each), every loss and
    the last step's metrics held bit for bit; the ad_psgd run's losses
    also equal the train phase's first steps.  Prints ms/step at W = 1
    and W = ``world``, the exchange's ms, the bytes each rank sends a step
    by primitive beside ``wire_bytes`` (the analytic bytes a learner
    sends a round).  Returns the ranks' K1-stash and K2 launches."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    dev = torch.device("cuda")
    print(f"[multirank] {_card_line()}", flush=True)
    t_phase = time.perf_counter()
    runs = _multirank_runs(world)
    ref = {r[0]: _multirank_run(*r, dev) for r in runs}
    got = ref["ad_psgd"]["losses"]
    if got != list(train_losses[:len(got)]):
        _fail(f"[multirank] the one-process ad_psgd losses {got} are not "
              f"the train phase's {list(train_losses[:len(got)])}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # a rank that raises fails the spawn, and the run with it; ranks
        # still running after MULTIRANK_S are killed
        ctx = mp.start_processes(_multirank_rank,
                                 args=(world, f"{tmp}/rdv", tmp, backend),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 > MULTIRANK_S:
                    _fail(f"[multirank] ranks still running after "
                          f"{MULTIRANK_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(world)]
    counts = {"blstm_layer_train": 0, "blstm_layer_bwd": 0}
    summary = []
    for name, strategy, knobs, steps, plan in runs:
        parts = [r[name] for r in ranks]
        one = ref[name]
        _same_state(name, one, parts)
        for r, p in enumerate(parts):
            if p["losses"] != one["losses"] or p["metrics"] != one["metrics"]:
                _fail(f"[multirank] {name}: rank {r}'s losses "
                      f"{p['losses']} and last metrics {p['metrics']} != "
                      f"one process's {one['losses']}, {one['metrics']}")
            for kname, n in p["counts"].items():
                if n != 6 * steps:
                    _fail(f"[multirank] {name}: rank {r} launched {kname} "
                          f"{n} times in {steps} steps, not {6 * steps}")
                counts[kname] += n
        w1 = sum(one["step_ms"][1:]) / (steps - 1)
        wn = sum(parts[0]["step_ms"][1:]) / (steps - 1)
        sent = [{k: v // steps for k, v in p["sent"].items()} for p in parts]
        row = dict(name=name, steps=steps, ms_w1=w1, ms_wn=wn,
                   mix_ms_w1=one["mix_ms"], mix_ms_wn=parts[0]["mix_ms"],
                   sent_per_step=sent,
                   wire_bytes=one["metrics"]["wire_bytes"])
        summary.append(row)
        print(f"[multirank] {name}: {steps} steps at W = 1 and W = {world} "
              f"({backend}) bit-identical (every state leaf, losses "
              f"{one['losses']}, last metrics {one['metrics']}); ms/step "
              f"after the first: W = 1 {w1:.2f}, W = {world} {wn:.2f} "
              f"(rank 0; first {one['step_ms'][0]:.1f} / "
              f"{parts[0]['step_ms'][0]:.1f}); exchange alone "
              f"{one['mix_ms']:.2f} ms at W = 1, {parts[0]['mix_ms']:.2f} "
              f"at W = {world}; bytes sent a step by each rank {sent} "
              f"beside wire_bytes {row['wire_bytes']:.0f} (a learner a "
              f"round, analytic)", flush=True)
    print(f"[multirank] summary {json.dumps(summary)}", flush=True)
    print(f"[multirank] ranks: {[r['placement'] for r in ranks]}; spawn "
          f"and runs {spawn_s:.1f}s, phase "
          f"{time.perf_counter() - t_phase:.1f}s; K1-stash and K2 launches "
          f"by the ranks {counts}", flush=True)
    return counts


# ------------------------------------------------------------- phase 7a-comm
# The paper's communication substrate at full width: the train phase's
# data (16 learners, batch 256, T = 21, var-len, seed 0) through five
# transports, 1 warm-up and 3 timed steps each.  The second runs through
# the train CLI with its --comm-* flags (docs/strategies.md's combination:
# bf16 inside pods of 4, top-k error-feedback gossip across them).
COMM_WARMUP, COMM_STEPS = 1, 3
COMM_TOL = 1e-6          # f32 mixing against f64, the CPU round, the mean
COMM_CONFIGS = [
    ("hring-f32", "hring", dict(comm_pod_size=4)),
    ("hring-bf16-topk", "hring", dict(comm_pod_size=4,
                                      comm_intra_wire="bf16",
                                      comm_wire="topk", comm_topk_frac=0.01,
                                      comm_bucket_mb=4)),
    ("ad_psgd_q8", "ad_psgd_q8", dict(comm_bucket_mb=4)),
    ("ad_psgd_exp", "ad_psgd_exp", {}),
    ("ad_psgd-topk", "ad_psgd", dict(comm_wire="topk")),
]
COMM_CLI = ["--arch", "swb2000-blstm", "--strategy", "hring", "--learners",
            "16", "--batch", "256", "--var-len", "--log-every", "1",
            "--steps", str(COMM_WARMUP + COMM_STEPS), "--comm-pod-size", "4",
            "--comm-intra-wire", "bf16", "--comm-wire", "topk",
            "--comm-topk-frac", "0.01", "--comm-bucket-mb", "4",
            "--consensus", "--grad-norm"]


def _wire_formula(params, t) -> float:
    """The reference's analytic bytes a learner sends per mixing round
    (``repro/core/transport.py:375-422``), restated from the leaf shapes:
    ring 2 payloads, exp 1, hierarchical the intra-pod allreduce
    (2(p-1)/p) plus the pod ring over its p members; f32 4 B, bf16 2 B,
    int8 1 B + a 4-B scale per bucket, topk 8 B per kept entry."""
    import math

    from repro_torch.core.strategies import _leaves

    def payload(wire, n):
        if t.bucket_bytes <= 0 or 4 * n <= t.bucket_bytes:
            sizes = [n]
        else:
            per = t.bucket_bytes // 4
            sizes = [min(per, n - i) for i in range(0, n, per)]
        return {"f32": 4.0 * n, "bf16": 2.0 * n,
                "int8": float(n + 4 * len(sizes)),
                "topk": float(sum(8 * min(s, max(1, math.ceil(
                    t.topk_frac * s))) for s in sizes))}[wire]

    def ring(G):
        return 0.0 if G <= 1 else (1.0 if G == 2 else 2.0)

    total = 0.0
    for w in _leaves(params):
        L, n = w.shape[0], w[0].numel()
        if t.topology == "hierarchical":
            p = t.pod_size
            total += (2.0 * (p - 1) / p * payload(t.intra_wire, n)
                      + ring(L // p) * payload(t.wire, n) / p)
        else:
            total += {"ring": ring(L), "exp": 1.0}[t.topology] * payload(
                t.wire, n)
    return total


def _comm_checks(name, state, t):
    """The mixing checks of one configuration on the phase's own final
    params, upcast to f32 (bf16-representable, so the bf16 intra codec is
    exact there and the mixer's output keeps f32): config 1 one round
    against ``hierarchical_matrix(16, 4) @ w`` in f64; the exponential
    graph 4 rounds to consensus; the top-k wires keep the replica mean;
    int8 within scale/2 of each sender; and, for every configuration, one
    round on ``softmax_w`` on the card bit-identical to the same round of
    the same ops on a CPU copy."""
    import torch

    from repro_torch.core import mixing as MX
    from repro_torch.core import strategies as ST
    from repro_torch.core import transport as TP
    from repro_torch.core.strategies import _leaves
    from repro_torch.optim.optimizers import tree_map

    L = TRAIN_L
    mix = t.make_mixer(L)
    step = state["step"]
    comm = state.get("comm", {})
    pf = tree_map(lambda w: w.float(), state["params"])
    if name == "hring-f32":
        T = torch.as_tensor(MX.hierarchical_matrix(L, t.pod_size),
                            device=pf["softmax_w"].device)
        mixed, _ = mix(pf, step, comm)
        worst = 0.0
        for w, m in zip(_leaves(pf), _leaves(mixed)):
            want = (T @ w.double().reshape(L, -1)).reshape(w.shape)
            worst = max(worst, float((m.double() - want).abs().max())
                        / float(want.abs().max()))
        print(f"[comm {name}] one round vs hierarchical_matrix(16, 4) @ w "
              f"in f64: worst normalised error {worst:.3g} (tol {COMM_TOL})",
              flush=True)
        if not worst <= COMM_TOL:
            _fail(f"comm {name}: the mixer is not hierarchical_matrix @ w")
    if name == "ad_psgd_exp":
        q = pf
        for k in range(4):
            q, _ = mix(q, step + k, comm)
        rms = float(torch.sqrt(sum(torch.sum(w.double() ** 2)
                                   for w in _leaves(pf))
                               / sum(w.numel() for w in _leaves(pf))))
        dist = float(ST.consensus_distance(q))
        print(f"[comm {name}] 4 rounds, no gradient: consensus distance "
              f"{dist:.3g}, {dist / rms:.3g} of the params' RMS {rms:.4g} "
              f"(tol {COMM_TOL})", flush=True)
        if not dist <= COMM_TOL * rms:
            _fail(f"comm {name}: 4 rounds did not reach consensus")
    if t.wire == "topk":
        # the mean the gossip must keep is that of what it was given: the
        # hierarchical intra-pod allreduce averages coded payloads (bf16
        # here: exact on the bf16 weights, one rounding of the f32 biases)
        coded = t.topology == "hierarchical" and t.pod_size > 1
        mixed, _ = mix(pf, step, comm)
        worst = 0.0
        for w, m in zip(_leaves(pf), _leaves(mixed)):
            if coded:
                w = TP._coded(t, t.intra_wire, w.reshape(L, -1)).reshape(
                    w.shape)
            drift = float((m.double().mean(0) - w.double().mean(0)).abs()
                          .max())
            worst = max(worst, drift / float(w.abs().max()))
        print(f"[comm {name}] replica mean after one round"
              f"{' (against the intra-pod payloads)' if coded else ''}: "
              f"worst normalised drift {worst:.3g} (tol {COMM_TOL})",
              flush=True)
        if not worst <= COMM_TOL:
            _fail(f"comm {name}: the replica mean moved")
    if t.wire == "int8":
        worst = 0.0
        for w in _leaves(pf):
            for c in TP._split_cols(w.reshape(L, -1), t.bucket_bytes):
                err = (TP.decode_payload("int8", c) - c).abs()
                half = c.abs().amax(dim=1, keepdim=True) / 254.0
                # a zero sender (scale 1) must come through exactly
                ratio = torch.where(half > 0, err / half, err * 1e30)
                worst = max(worst, float(ratio.max()))
        print(f"[comm {name}] int8 error over each sender's half scale: "
              f"worst {worst:.7f} (must be <= 1, f32 rounding aside)",
              flush=True)
        if not worst <= 1.0 + 1e-5:
            _fail(f"comm {name}: an int8 value is off by more than scale/2")
    leaf = {"softmax_w": state["params"]["softmax_w"]}
    lcomm = {k: {"softmax_w": v["softmax_w"]} for k, v in comm.items()}
    got, gcomm = mix(leaf, step, lcomm)
    want, wcomm = mix(tree_map(lambda x: x.cpu(), leaf), step,
                      tree_map(lambda x: x.cpu(), lcomm))
    diff = [k for k, g, w in [("mixed", got, want)] + [
        (k, gcomm[k], wcomm[k]) for k in sorted(wcomm)]
        if not torch.equal(g["softmax_w"].cpu(), w["softmax_w"])]
    print(f"[comm {name}] one round on softmax_w {tuple(leaf['softmax_w'].shape)} "
          f"on the card vs the same ops on a CPU copy: bit-identical "
          f"{not diff}", flush=True)
    if diff:
        errs = {k: _norm_err((got if k == "mixed" else gcomm[k])[
            "softmax_w"].cpu(), (want if k == "mixed" else wcomm[k])[
            "softmax_w"])[1] for k in diff}
        _fail(f"comm {name}: the card's round differs from the CPU's in "
              f"{diff} (normalised {errs})")


def phase_comm():
    """Five transports over the §V training data at full width, each with
    the counters set to 0 just before its steps and read just after
    (K1-stash and K2 6 times a step); ms/step, valid frames/s, wire bytes
    a learner a round (equal to the reference's formula), consensus, grad
    norm, peak memory; then :func:`_comm_checks`."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import make_dataset
    from repro_torch.launch import train as TR

    dev = torch.device("cuda")
    base = get_arch("swb2000-blstm")
    steps = COMM_WARMUP + COMM_STEPS
    total, rows = {"blstm_layer_train": 0, "blstm_layer_bwd": 0}, []
    for name, strategy, knobs in COMM_CONFIGS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if name == "hring-bf16-topk":
            _zero_counts()
            out = TR.main(COMM_CLI)
            counts = _train_counts()
            state, metrics, records, meta = (out["state"], out["metrics"],
                                             out["records"], out["meta"])
            del out          # the next configuration's peak is its own
        else:
            cfg = dataclasses.replace(base, **knobs)
            state, step, meta = TR.setup_training(
                cfg, strategy_name=strategy, n_learners=TRAIN_L, seed=SEED,
                device=dev, with_consensus=True, with_grad_norm=True)
            ds = make_dataset(cfg, seq_len=TRAIN_T,
                              batch=TRAIN_L * TRAIN_B, seed=SEED,
                              var_len=True)
            torch.cuda.synchronize()
            _zero_counts()
            state, metrics, records = TR.run(state, step, ds, steps=steps,
                                             device=dev, log_every=1,
                                             label=f"[comm {name}] ")
            counts = _train_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        t = meta["transport"]
        losses = [float(r[3]) for r in records]
        if not all(math.isfinite(v) for v in losses):
            _fail(f"comm {name}: non-finite loss {losses}")
        for k, n in counts.items():
            if n != 6 * steps:
                _fail(f"comm {name}: {k} launched {n} times in {steps} "
                      f"steps, expected 6 a step")
            total[k] += n
        timed = records[COMM_WARMUP:]
        ms = 1e3 * sum(r[0] for r in timed) / len(timed)
        fps = sum(r[1] for r in timed) / sum(r[0] for r in timed)
        wire = float(metrics["wire_bytes"])
        want = _wire_formula(state["params"], t)
        row = dict(name=name, strategy=strategy, transport=str(t),
                   ms_per_step=ms, valid_frames_s=fps, wire_bytes=wire,
                   consensus=float(metrics["consensus"]),
                   grad_norm=float(metrics["grad_norm"]), peak_gib=peak_gb,
                   losses=losses)
        rows.append(row)
        print(f"[comm {name}] {t}: {COMM_STEPS} timed steps {ms:.2f} "
              f"ms/step, {fps:.1f} valid frames/s; wire {wire:.0f} B = "
              f"{wire / 2 ** 20:.2f} MiB a learner a round (formula "
              f"{want:.0f}); consensus {row['consensus']:.4g}, grad norm "
              f"{row['grad_norm']:.4g}; peak device memory {peak_gb:.2f} "
              f"GiB; launches {counts}", flush=True)
        if wire != want:
            _fail(f"comm {name}: wire_bytes {wire} != the formula's {want}")
        _comm_checks(name, state, t)
        del state, metrics, records, meta
    print(f"[comm] summary {json.dumps(rows)}", flush=True)
    return total


# ---------------------------------------------------------- phase 7a-elastic
# Elastic fault-tolerant training at full width on the train phase's data
# (16 learners, batch 256, T = 21, var-len, seed 0, fresh seed-0 weights,
# sgd): (a) ad_psgd over the f32 ring under one fault plan; (b) hring,
# pods of 4, an int8 wire, one whole pod crashed and rejoined; (c) run
# (a)'s flags through the train CLI, killed and resumed.
ELASTIC_WARMUP, ELASTIC_STEPS, ELASTIC_HRING_STEPS = 1, 8, 4
ELASTIC_LAMBDA = 0.2
ELASTIC_TOL = 1e-6       # doubly stochastic; f32 leaves against f64
TRIVIAL_TOL = 2e-5       # trivial plan vs the plain step (f32 leaves)
BF16_ULP = 2.0 ** -7     # one bf16 rounding step, relative, at most
ELASTIC_FLAGS = ["--comm-staleness-lambda", str(ELASTIC_LAMBDA),
                 "--fault-stragglers", "0:4", "--fault-departures", "1:2:6",
                 "--fault-drop-prob", "0.05", "--fault-corrupt-prob",
                 "0.05", "--fault-corrupt-scale", "0.1", "--fault-seed",
                 "0"]
ELASTIC_CLI = ["--arch", "swb2000-blstm", "--strategy", "ad_psgd",
               "--learners", "16", "--batch", "256", "--var-len",
               "--log-every", "1"] + ELASTIC_FLAGS


def _elastic_plan(L, hring):
    from repro_torch.core.faults import (FaultPlan, parse_departures,
                                         parse_stragglers)

    if hring:
        return FaultPlan(L, departures=parse_departures(
            "4:1:3,5:1:3,6:1:3,7:1:3"))
    return FaultPlan(L, seed=0, stragglers=parse_stragglers("0:4"),
                     departures=parse_departures("1:2:6"), drop_prob=0.05,
                     corrupt_prob=0.05, corrupt_scale=0.1)


def _rows(tree, i):
    """Learner ``i``'s rows of every leaf, cloned."""
    from repro_torch.core.strategies import _leaves

    return [w[i].clone() for w in _leaves(tree)]


def _same_rows(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def _check_matrix(name, k, mix, faults, staleness):
    """This step's elastic matrix (the mixer's own host construction, from
    the step's masks and counters): doubly stochastic to ELASTIC_TOL,
    identity rows and columns for the dead.  Returns its error."""
    import numpy as np

    T = mix.matrix(k, faults["active"], staleness, faults["edge_ok"]).numpy()
    eye = np.eye(T.shape[0], dtype=T.dtype)
    err = max(float(np.abs(T.sum(0) - 1).max()),
              float(np.abs(T.sum(1) - 1).max()), float(-T.min()))
    for i in np.where(faults["active"] == 0)[0]:
        err = max(err, float(np.abs(T[i] - eye[i]).max()),
                  float(np.abs(T[:, i] - eye[i]).max()))
    if not err <= ELASTIC_TOL:
        _fail(f"elastic {name}: step {k}'s matrix is {err:.3g} off doubly "
              f"stochastic with identity rows for the dead")
    return err


def _elastic_run(name, cfg, strategy, plan, steps, warmup, checks):
    """One elastic run from fresh seed-0 weights, the counters set to 0
    just before its steps and read just after.  Every step: the loss
    finite, the staleness counters equal to the reference's formula on
    the host, the step's matrix checked (:func:`_check_matrix`),
    ``wire_bytes`` equal to the wire formula times n_active / L; then
    ``checks(k, before, after, faults, metrics)``.  Returns the final
    state, the step, meta and a record of the run."""
    import math

    import numpy as np
    import torch

    from repro_torch.core import strategies as ST
    from repro_torch.data import make_dataset
    from repro_torch.launch import train as TR

    L = TRAIN_L
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step, meta = TR.setup_training(
        cfg, strategy_name=strategy, n_learners=L, seed=SEED,
        device=torch.device("cuda"), elastic=True, fault_seed=plan.seed,
        with_corruption=plan.corrupt_prob > 0)
    t = meta["transport"]
    mix = t.make_elastic_mixer(L)
    ds = make_dataset(cfg, seq_len=TRAIN_T, batch=L * TRAIN_B, seed=SEED,
                      var_len=True)
    stale = np.zeros(L, np.int32)
    records, trail, mat_err = [], [], 0.0
    torch.cuda.synchronize()
    _zero_counts()
    for k in range(steps):
        batch = ds.batch_at(k)
        faults = plan.step_inputs(k)
        ST.check_active(faults["active"])
        before = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, faults)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        gmask = faults["active"] * faults["contrib"]
        frames = float((batch["lengths"].reshape(L, -1).sum(1)
                        * gmask).sum())
        loss = float(metrics["loss"])
        records.append((secs, frames, loss))
        trail.append((int(metrics["n_active"]),
                      int(metrics["staleness_max"])))
        print(f"[elastic {name}] step {k} loss {loss:.4f} {1e3 * secs:.2f} "
              f"ms act {trail[-1][0]}/{L} stale {trail[-1][1]} contrib "
              f"{int(metrics['n_contrib'])} wire "
              f"{metrics['wire_bytes'] / 2 ** 20:.2f}MB", flush=True)
        if not math.isfinite(loss):
            _fail(f"elastic {name}: non-finite loss at step {k}")
        stale = np.where(faults["rejoin"] > 0, 0, stale)
        mat_err = max(mat_err, _check_matrix(name, k, mix, faults, stale))
        stale = np.where(gmask > 0, 0, stale + 1).astype(np.int32)
        if not np.array_equal(state["staleness"].numpy(), stale):
            _fail(f"elastic {name}: staleness {state['staleness']} != the "
                  f"formula's {stale} at step {k}")
        want = _wire_formula(state["params"], t) * float(
            faults["active"].sum()) / L
        if not abs(metrics["wire_bytes"] - want) <= 1e-6 * want:
            _fail(f"elastic {name}: wire_bytes {metrics['wire_bytes']} != "
                  f"{want} at step {k}")
        checks(k, before, state, faults, metrics)
    counts = _train_counts()
    for key, n in counts.items():
        if n != 6 * steps:
            _fail(f"elastic {name}: {key} launched {n} times in {steps} "
                  f"steps, expected 6 a step")
    timed = records[warmup:]
    run = dict(ms=1e3 * sum(r[0] for r in timed) / len(timed),
               fps=sum(r[1] for r in timed) / sum(r[0] for r in timed),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               trail=trail, counts=counts, losses=[r[2] for r in records],
               matrix_err=mat_err)
    return state, step, meta, run


def _mean_check(name, params, incumbents, got):
    """A rejoiner's reseeded params ``got`` against the incumbents' mean of
    ``params`` in f64 (on the card): f32 leaves within ELASTIC_TOL of the
    leaf's max-abs, bf16 leaves within one bf16 step of the mean (its one
    rounding, from an f32 mean).  Returns the worst relative error."""
    import torch

    from repro_torch.core.strategies import _leaves

    worst = 0.0
    for w, g in zip(_leaves(params), _leaves(got)):
        mu = w[incumbents].double().mean(0)
        d = (g.double() - mu).abs()
        if g.dtype == torch.float32:
            err = float(d.max()) / float(mu.abs().max())
            ok = err <= ELASTIC_TOL
        else:
            err = float((d / (mu.abs() + 1e-30)).max())
            ok = bool((d <= BF16_ULP * mu.abs() + 1e-30).all())
        worst = max(worst, err)
        if not ok:
            _fail(f"elastic {name}: the rejoiner is not at the incumbents' "
                  f"mean ({err:.3g})")
    return worst


def _elastic_kernel_vs_plain(cfg, meta, step, state, batch, faults):
    """One elastic step from ``state`` through the kernels and through the
    plain path (which launches no kernel), and the gradients both take at
    the step's iterate: loss and every gradient leaf within K1_TOL."""
    import torch

    from repro_torch.core import strategies as ST
    from repro_torch.models import lstm as LS
    from repro_torch.optim.optimizers import sgd

    dev = state["params"]["softmax_b"].device
    L = TRAIN_L

    def plain_fn(p, b):
        return LS.loss_train(cfg, p, b, device=dev, plain=True)

    # the loss is taken before the update: the plain step's lr is moot
    plain_step = ST.make_elastic_train_step(
        meta["strategy"], plain_fn, sgd(), lambda k: 0.0, n_learners=L,
        transport=meta["transport"], fault_seed=0, with_corruption=True)
    _, m_plain = plain_step(state, batch, faults)
    _, m_kern = step(state, batch, faults)
    loss_err = abs(float(m_kern["loss"]) - float(m_plain["loss"])) / abs(
        float(m_plain["loss"]))
    lb = ST.split_learner_batch({k: torch.as_tensor(v).to(dev)
                                 for k, v in batch.items()}, L)
    _, grads = ST._value_and_grad(meta["loss_fn"], state["prev_params"], lb)
    _, grads_w = ST._value_and_grad(plain_fn, state["prev_params"], lb)
    worst, where = 0.0, None
    for (key, g), w_ in zip(_named_leaves(grads), ST._leaves(grads_w)):
        if not torch.isfinite(g).all():
            _fail(f"elastic: non-finite gradient {key}")
        _, norm = _norm_err(g, w_)
        if norm > worst:
            worst, where = norm, key
    print(f"[elastic ad_psgd] one elastic step (step 5, learner 1 dead) "
          f"kernel vs plain: loss relative error {loss_err:.3g}, worst "
          f"normalised gradient error {worst:.3g} ({where}) (tol {K1_TOL})",
          flush=True)
    if not (loss_err <= K1_TOL and worst <= K1_TOL):
        _fail("elastic: the kernel path disagrees with the plain path")


def _elastic_trivial(base, ds):
    """The no-fault plan against the plain ad_psgd step on the card, each
    of 3 steps from the plain run's own state: the elastic step mixes by a
    matrix product where the plain one rolls, so the mix (in f32) and
    the f32 leaves hold TRIVIAL_TOL, and a bf16 leaf holds TRIVIAL_TOL of
    its max-abs beyond one bf16 rounding step of each element."""
    import numpy as np
    import torch

    from repro_torch.core import strategies as ST
    from repro_torch.core.faults import FaultPlan
    from repro_torch.launch import train as TR
    from repro_torch.optim.optimizers import sgd, tree_map

    L = TRAIN_L
    ps, pstep, meta = TR.setup_training(base, strategy_name="ad_psgd",
                                        n_learners=L, seed=SEED,
                                        device=torch.device("cuda"))
    t = meta["transport"]
    estep = ST.make_elastic_train_step(
        meta["strategy"], meta["loss_fn"], sgd(), lambda k: 0.05,
        n_learners=L, transport=t)
    pstep = ST.make_train_step(meta["strategy"], meta["loss_fn"], sgd(),
                               lambda k: 0.05, n_learners=L, transport=t)
    nf = FaultPlan(L).no_fault_inputs()
    pf = tree_map(lambda w: w.float(), ps["params"])
    got = t.make_elastic_mixer(L)(pf, 0, nf["active"],
                                  np.zeros(L, np.int32), nf["edge_ok"],
                                  nf["corrupt"])
    want, _ = t.make_mixer(L)(pf, 0, {})
    mix_err = max(_norm_err(g, w_)[1] for g, w_ in
                  zip(ST._leaves(got), ST._leaves(want)))
    del pf, got, want
    f32_err, bf16_err, flips, n_bf16 = 0.0, 0.0, 0, 0
    for k in range(3):
        batch = ds.batch_at(k)
        es, _ = estep(dict(ps, staleness=torch.zeros(L, dtype=torch.int32)),
                      batch, nf)
        ps, _ = pstep(ps, batch)
        for g, w_ in zip(ST._leaves(es["params"]), ST._leaves(ps["params"])):
            w_ = w_.float()
            d = (g.float() - w_).abs()
            scale = float(w_.abs().max())
            if g.dtype == torch.float32:
                f32_err = max(f32_err, float(d.max()) / scale)
            else:
                flips += int((d > 0).sum())
                n_bf16 += d.numel()
                beyond = torch.clamp(d - BF16_ULP * w_.abs(), min=0.0)
                bf16_err = max(bf16_err, float(beyond.max()) / scale)
        del es
    print(f"[elastic trivial] no-fault elastic step vs the plain ad_psgd "
          f"step, 3 steps each from the plain run's state: one f32 mix "
          f"{mix_err:.3g}, f32 leaves {f32_err:.3g}, bf16 leaves "
          f"{bf16_err:.3g} beyond one rounding step (tol {TRIVIAL_TOL}; "
          f"{flips} of {n_bf16} bf16 elements apart)", flush=True)
    if not max(mix_err, f32_err, bf16_err) <= TRIVIAL_TOL:
        _fail("elastic: the trivial plan does not walk the plain step")


def _elastic_cli(L):
    """Run (c): the train CLI under run (a)'s flags, 4 steps, then 2 with
    a checkpoint and 2 more with ``--resume``: every leaf of params,
    prev_params, opt and staleness and the ``final loss`` line
    bit-identical.  Returns the launch counts of the 8 steps."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch.launch import train as TR

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = TR.main(ELASTIC_CLI + argv)
        text = buf.getvalue()
        final = [l for l in text.splitlines() if l.startswith("final loss")]
        return res["state"], text, final[-1] if final else None

    torch.cuda.empty_cache()
    _zero_counts()
    full, text, final_full = cli(["--steps", "4"])
    if "FaultPlan(L=16" not in text or f"act 15/{L}" not in text:
        _fail(f"elastic CLI: no fault banner or crash window:\n{text}")
    print("\n".join(f"[elastic CLI] {l}" for l in text.splitlines()
                    if l.startswith(("FaultPlan", "step"))), flush=True)
    with tempfile.TemporaryDirectory() as ck:
        cli(["--steps", "2", "--ckpt-dir", ck, "--ckpt-every", "2"])
        resumed, _, final_res = cli(["--steps", "2", "--ckpt-dir", ck,
                                     "--resume"])
    counts = _train_counts()
    for key, n in counts.items():
        if n != 6 * 8:
            _fail(f"elastic CLI: {key} launched {n} times in 8 steps")
    diff = [name for name, a, b in _paired_leaves(full, resumed)
            if not (a.dtype == b.dtype and a.device == b.device
                    and torch.equal(a, b))]
    print(f"[elastic CLI] 4 steps vs 2 + --resume 2: {final_full!r} vs "
          f"{final_res!r}; every leaf of params, prev_params, opt and "
          f"staleness bit-identical: {not diff}", flush=True)
    if diff or final_full is None or final_full != final_res:
        _fail(f"elastic CLI: the resumed run differs in {diff[:4]}")
    return counts


def phase_elastic(train_ms):
    """Phase 7a-elastic: runs (a), (b) and (c) with their checks, one
    elastic step kernel vs plain, the trivial plan against the plain
    step; ms/step, contributors' valid frames/s and peak memory beside
    the card's name and power limit.  Returns K1-stash's and K2's
    launches over the three runs."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import make_dataset
    from repro_torch.optim.optimizers import tree_map

    t_phase = time.perf_counter()
    L = TRAIN_L
    base = get_arch("swb2000-blstm")
    card = _card_line()
    totals = {"blstm_layer_train": 0, "blstm_layer_bwd": 0}

    # (a) ad_psgd, f32 ring: a 4x straggler, a crash at step 2 rejoining
    # at step 6, dropped edges and corrupted payloads
    cfg_a = dataclasses.replace(base, comm_staleness_lambda=ELASTIC_LAMBDA)
    plan = _elastic_plan(L, hring=False)
    seen = {}

    def checks_a(k, before, after, faults, metrics):
        if k == 2:
            seen["rows"] = _rows(before["params"], 1)
        if 2 <= k < 6 and not _same_rows(seen["rows"],
                                         _rows(after["params"], 1)):
            _fail(f"elastic ad_psgd: dead learner 1 moved at step {k}")
        if k == 5:
            seen["state"] = after
        if k == 6:
            # the reseeded iterate is the next gradient's: prev_params
            inc = torch.as_tensor(
                faults["active"] * (1 - faults["rejoin"]) > 0,
                device=before["params"]["softmax_b"].device)
            seen["mean_err"] = _mean_check(
                "ad_psgd", before["params"], inc,
                tree_map(lambda w: w[1], after["prev_params"]))
            if int(after["staleness"][1]) != 0 or after["opt"] != ():
                _fail("elastic ad_psgd: the rejoiner's staleness or "
                      "optimizer state is not fresh")

    state, step_a, meta_a, run_a = _elastic_run(
        "ad_psgd", cfg_a, "ad_psgd", plan, ELASTIC_WARMUP + ELASTIC_STEPS,
        ELASTIC_WARMUP, checks_a)
    del state
    print(f"[elastic ad_psgd] {card}: {ELASTIC_STEPS} timed steps "
          f"{run_a['ms']:.2f} ms/step (the train phase's plain ad_psgd "
          f"step: {train_ms:.2f}), {run_a['fps']:.1f} contributors' valid "
          f"frames/s; peak device memory {run_a['peak_gib']:.2f} GiB; "
          f"act/stale trail {run_a['trail']}; launches {run_a['counts']}; "
          f"matrices doubly stochastic to {run_a['matrix_err']:.3g}; "
          f"learner 1 frozen through steps 2-5 and reseeded at step 6 "
          f"within {seen['mean_err']:.3g} of the incumbents' f64 mean",
          flush=True)
    ds = make_dataset(cfg_a, seq_len=TRAIN_T, batch=L * TRAIN_B, seed=SEED,
                      var_len=True)
    _elastic_kernel_vs_plain(cfg_a, meta_a, step_a, seen.pop("state"),
                             ds.batch_at(5), plan.step_inputs(5))
    del step_a, meta_a
    _elastic_trivial(base, ds)

    # (b) hring, pods of 4, int8 wire: learners 4-7 (one pod) crash at
    # step 1 and rejoin at step 3
    cfg_b = dataclasses.replace(base, comm_pod_size=4, comm_wire="int8")

    def checks_b(k, before, after, faults, metrics):
        if k == 1:
            seen["pod"] = [_rows(before["params"], i) for i in range(4, 8)]
        if 1 <= k < 3:
            if metrics["n_active"] != 12:
                _fail(f"elastic hring: n_active {metrics['n_active']} in "
                      f"the crash window")
            for i, rows in zip(range(4, 8), seen["pod"]):
                if not _same_rows(rows, _rows(after["params"], i)):
                    _fail(f"elastic hring: dead learner {i} moved")

    state, _, _, run_b = _elastic_run("hring", cfg_b, "hring",
                                      _elastic_plan(L, hring=True),
                                      ELASTIC_HRING_STEPS, 1, checks_b)
    del state, seen
    print(f"[elastic hring] {card}: pods of 4, int8 wire, learners 4-7 "
          f"dead at steps 1-2: {ELASTIC_HRING_STEPS - 1} timed steps "
          f"{run_b['ms']:.2f} ms/step, {run_b['fps']:.1f} contributors' "
          f"valid frames/s; peak device memory {run_b['peak_gib']:.2f} "
          f"GiB; act/stale trail {run_b['trail']}", flush=True)

    counts_c = _elastic_cli(L)
    for counts in (run_a["counts"], run_b["counts"], counts_c):
        for key in totals:
            totals[key] += counts[key]
    secs = time.perf_counter() - t_phase
    summary = {k: {kk: v[kk] for kk in ("ms", "fps", "peak_gib", "trail",
                                        "losses")}
               for k, v in (("ad_psgd", run_a), ("hring", run_b))}
    print(f"[elastic] {card}: phase 7a-elastic {secs:.1f}s; summary "
          f"{json.dumps(summary)}", flush=True)
    return totals


def _paired_leaves(a, b, prefix=""):
    """(path, leaf of a, leaf of b) over two trees of dicts, tuples and
    tensors; the host ``step`` compared as a 0-d tensor."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            yield prefix + "/<keys>", torch.zeros(1), torch.ones(1)
            return
        for k in a:
            yield from _paired_leaves(a[k], b[k], f"{prefix}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _paired_leaves(x, y, f"{prefix}/{i}")
    else:
        yield prefix, torch.as_tensor(a), torch.as_tensor(b)


# -------------------------------------------------------------- phase 7a-ctc
# The reference's recognition-quality path (benchmarks/paper_tables.py,
# bench_decode_wer) at full width: ad_psgd with the CTC loss on the train
# phase's data, each utterance's valid frames collapsed to at most 6
# labels; then the consensus model decodes 2 held-out batches of 8
# (greedy, and the sum-semiring prefix beam, beam 8).
CTC_U, CTC_WARMUP, CTC_STEPS, CTC_LR = 6, 2, 5, 0.03
CTC_HELD, CTC_HELD_B, CTC_BEAM = 2, 8, 8
CTC_LOSS_TOL = 1e-5      # the card's f32 CTC against the CPU's f64


class _CtcData:
    """A dataset's batches with CTC targets: each utterance's valid frames
    collapsed (``collapse_frame_labels``) into at most CTC_U labels."""

    def __init__(self, ds):
        self.ds = ds

    def batch_at(self, step):
        return _ctc_batch(self.ds.batch_at(step))


def _ctc_batch(batch):
    import numpy as np

    from repro_torch.models.ctc import collapse_frame_labels

    rows = [collapse_frame_labels(lab[None, :n], CTC_U)
            for lab, n in zip(batch["labels"], batch["lengths"])]
    return {"features": batch["features"], "lengths": batch["lengths"],
            "ctc": np.concatenate([r[0] for r in rows]),
            "ctc_lengths": np.concatenate([r[1] for r in rows])}


def phase_ctc():
    """CTC training at full width (2 warm-up and 5 timed steps, K1-stash
    and K2 6 times a step), one step's loss and gradients against the
    plain path, ``ctc_loss`` on the card against a CPU f64 evaluation,
    then the held-out decode: K4 once per forward, K5 once per frame,
    the beam's hypotheses equal to the plain beam's with scores within
    K5_SUM_TOL; greedy and beam TER (no quality claim)."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import strategies as ST
    from repro_torch.data import make_dataset
    from repro_torch.decode import beam as DB
    from repro_torch.decode import beam_decode
    from repro_torch.decode import kernel as DK
    from repro_torch.eval.metrics import greedy_ctc_decode, token_error_rate
    from repro_torch.kernels import lstm_cell as LC
    from repro_torch.launch.train import run, timing_line
    from repro_torch.models import lstm as LS
    from repro_torch.models.ctc import ctc_loss
    from repro_torch.optim.optimizers import sgd, tree_map
    from repro_torch.optim.schedules import constant
    from repro_torch.params import init_params

    cfg = get_arch("swb2000-blstm")
    dev = torch.device("cuda")
    L = TRAIN_L

    def loss_fn(p, b, plain=False):
        logits = LS.forward(cfg, p, b["features"], b["lengths"], device=dev,
                            plain=plain)
        return ctc_loss(logits, b["ctc"], b["ctc_lengths"],
                        input_lengths=b["lengths"])

    strategy, opt = ST.get_strategy("ad_psgd"), sgd()
    step = ST.make_train_step(strategy, loss_fn, opt, constant(CTC_LR),
                              n_learners=L, with_grad_norm=True)
    params = ST.stack_for_learners(
        init_params(LS.param_specs(cfg), SEED, dev), L)
    state = ST.init_state(strategy, params, opt)
    data = _CtcData(make_dataset(cfg, seq_len=TRAIN_T,
                                 batch=TRAIN_L * TRAIN_B, seed=SEED,
                                 var_len=True))
    steps = CTC_WARMUP + CTC_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, metrics, records = run(state, step, data, steps=steps,
                                  device=dev, log_every=1, label="[ctc] ")
    counts = _train_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(r[3]) for r in records]
    if not all(math.isfinite(v) for v in losses):
        _fail(f"ctc: non-finite loss {losses}")
    for k, n in counts.items():
        if n != 6 * steps:
            _fail(f"ctc: {k} launched {n} times in {steps} steps, expected "
                  f"6 a step")
    timed = records[CTC_WARMUP:]
    ms = 1e3 * sum(r[0] for r in timed) / len(timed)
    fps = sum(r[1] for r in timed) / sum(r[0] for r in timed)
    print(f"[ctc] {timing_line(records)}", flush=True)
    print(f"[ctc] ad_psgd, CTC (U <= {CTC_U}), {L} learners, batch "
          f"{TRAIN_L * TRAIN_B}, T={TRAIN_T}, var-len: {CTC_STEPS} timed "
          f"steps {ms:.2f} ms/step, {fps:.1f} valid frames/s; losses "
          f"{[round(v, 4) for v in losses]}; grad norm "
          f"{float(metrics['grad_norm']):.4g}; peak device memory "
          f"{peak_gb:.2f} GiB; launches {counts}", flush=True)

    # one step's CTC loss and gradients, kernel path vs plain path
    lb = ST.split_learner_batch(
        {k: torch.as_tensor(v).to(dev)
         for k, v in data.batch_at(steps).items()}, L)
    loss, grads = ST._value_and_grad(loss_fn, state["prev_params"], lb)
    loss_w, grads_w = ST._value_and_grad(
        lambda p, b: loss_fn(p, b, plain=True), state["prev_params"], lb)
    if not torch.isfinite(loss).all():
        _fail("ctc: non-finite loss in the gradient check")
    loss_err = float(((loss - loss_w).abs() / loss_w.abs()).max())
    worst, where = 0.0, None
    for (key, g), w_ in zip(_named_leaves(grads), ST._leaves(grads_w)):
        if not torch.isfinite(g).all():
            _fail(f"ctc: non-finite gradient {key}")
        _, norm = _norm_err(g, w_)
        if norm > worst:
            worst, where = norm, key
    print(f"[ctc] kernel vs plain path, one step: loss relative error "
          f"{loss_err:.3g}, worst normalised gradient error {worst:.3g} "
          f"({where}) (tol {K1_TOL})", flush=True)
    if not (loss_err <= K1_TOL and worst <= K1_TOL):
        _fail("ctc: the kernel path's loss or gradients disagree with the "
              "plain path")
    del grads, grads_w

    # ctc_loss on the card against a CPU f64 evaluation, one learner
    with torch.no_grad():
        one = tree_map(lambda w: w[0], state["params"])
        logits = LS.forward(cfg, one, lb["features"][0], lb["lengths"][0],
                            device=dev)
        args = (lb["ctc"][0], lb["ctc_lengths"][0])
        got = float(ctc_loss(logits, *args, input_lengths=lb["lengths"][0]))
        want = float(ctc_loss(logits.double().cpu(),
                              *(a.cpu() for a in args),
                              input_lengths=lb["lengths"][0].cpu()))
    rel = abs(got - want) / abs(want)
    print(f"[ctc] ctc_loss on the card {got:.7f} vs CPU f64 {want:.7f}: "
          f"relative error {rel:.3g} (tol {CTC_LOSS_TOL})", flush=True)
    if not rel <= CTC_LOSS_TOL:
        _fail("ctc: the card's ctc_loss disagrees with the f64 evaluation")

    # held-out decode of the consensus model
    avg = ST.average_learners(state["params"])
    del state, params
    held = make_dataset(cfg, seq_len=TRAIN_T, batch=CTC_HELD_B, seed=SEED,
                        var_len=True)
    batches = [_ctc_batch(held.batch_at(10_000 + i))
               for i in range(CTC_HELD)]
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    refs, hyp_g, hyp_b, kept = [], [], [], []
    for hb in batches:
        refs += [list(map(int, s[:n])) for s, n in zip(hb["ctc"],
                                                      hb["ctc_lengths"])]
        with torch.no_grad():
            lg = LS.forward(cfg, avg, hb["features"], hb["lengths"],
                            device=dev)
        hyp_g += greedy_ctc_decode(lg.cpu().numpy(), hb["lengths"])
        hyps = beam_decode(lg, hb["lengths"], beam=CTC_BEAM,
                           semiring="sum", device=dev)
        hyp_b += hyps
        kept.append((lg, hb["lengths"], hyps))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dec = {"blstm_stack": LC.stack_launches, "blstm_layer": LC.launches,
           "beam_frame_step": DK.launches}
    frames = CTC_HELD * TRAIN_T
    print(f"[ctc] held-out decode ({CTC_HELD} batches of {CTC_HELD_B}, "
          f"T={TRAIN_T}) in {dt:.2f}s; launches {dec}", flush=True)
    if dec != {"blstm_stack": CTC_HELD, "blstm_layer": 0,
               "beam_frame_step": frames}:
        _fail(f"ctc decode launches {dec}: expected K4 once per forward "
              f"({CTC_HELD}), K1 never, K5 once per frame ({frames})")
    # the same decode with K5's plain frame step in its place, on the card
    kernel_step = DK.beam_frame_step

    def plain_step(*a, topc=0, **kw):
        return DB.frame_step_scores(*a, **kw)
    worst, n_hyp = 0.0, 0
    for lg, lens, hyps in kept:
        kw = dict(beam=CTC_BEAM, semiring="sum", device=dev)
        tok, ln, sc = DB.beam_search(lg, lens, **kw)
        DK.beam_frame_step = plain_step
        try:
            tok_w, ln_w, sc_w = DB.beam_search(lg, lens, **kw)
        finally:
            DK.beam_frame_step = kernel_step
        mine = [list(map(int, r[:n])) for r, n in zip(tok.cpu().numpy(),
                                                      ln.cpu().numpy())]
        if not (torch.equal(tok, tok_w) and torch.equal(ln, ln_w)
                and mine == hyps):
            _fail("ctc: K5's sum-semiring hypotheses differ from the plain "
                  "beam's")
        if not torch.allclose(sc, sc_w, rtol=K5_SUM_TOL, atol=K5_SUM_TOL):
            _fail(f"ctc: beam scores differ: {sc.tolist()} vs "
                  f"{sc_w.tolist()}")
        worst = max(worst, float((sc - sc_w).abs().max()))
        n_hyp += len(hyps)
    ter_g = token_error_rate(refs, hyp_g)
    ter_b = token_error_rate(refs, hyp_b)
    print(f"[ctc] K5 sum-semiring beam vs the plain beam on the same "
          f"logits: {n_hyp} hypotheses equal, score max_abs_err "
          f"{worst:.3g} (tol {K5_SUM_TOL}); TER greedy {ter_g:.4f}, beam "
          f"{ter_b:.4f} ({sum(map(len, hyp_b))} beam tokens against "
          f"{sum(map(len, refs))} reference labels; {steps} steps of "
          f"synthetic data: no quality claim)", flush=True)
    return counts, dec


# ---------------------------------------------------------------- phase 7b
# The long-utterance slice (--seq-chunk): the train-long layer shape is 16
# learners x 2 rows, T = 2000, layers 1..5 (D = 2H = 1024), K = 256.
LONG_L, LONG_ROWS, LONG_T, LONG_K = 16, 2, 2000, 256
LONG_BATCH = LONG_L * LONG_ROWS
LONG_WARMUP, LONG_STEPS, LONG_UNCHUNKED_STEPS = 1, 3, 2
K3_VS_K2_TOL = 2e-5      # the reference's chunked-vs-unchunked contract


def _long_inputs(gen, L, B, T, D, H, K):
    """Stacked inputs with var-len rows: a length-1 row, rows that end
    before the last chunk, and full rows."""
    import torch

    ws, x, _ = _stacked_inputs(L, B, T, D, H, gen, False)
    lens = torch.randint(1, T + 1, (L, B), generator=gen)
    lens[:, 0] = T
    lens[0, -1] = 1
    lens[-1, -1] = T - K - 7            # whole masked chunks in reverse
    return ws, x, lens.to(x.device, torch.int32)


def _chunked_bound(L, B, T, D, H, K, n_valid, fwd):
    """(bytes, [(operations, peak of their type)]) the K1-chunk forward
    (``fwd``) or K3 must move and do at this shape, counting valid frames
    only."""
    n = -(-T // K)
    weights = L * 2 * (D * 4 * H * 2 + H * 4 * H * 2 + 4 * H * 4)
    carries = 2 * L * B * n * 2 * H * 4
    act = L * B * T * 2 * H * 2                       # y or dy (bf16)
    # x·Wx and h·Wh of both directions: bf16 operands
    recur = 2 * (2 * n_valid * 4 * H * (D + H))
    if fwd:
        nbytes = L * B * T * D * 2 + weights + L * B * 4 + act + carries
        return nbytes, [(recur, PEAK_BF16_FLOPS)]
    nbytes = (2 * L * B * T * D * 2 + 2 * act + carries + weights + L * B * 4
              + L * 2 * (D * 4 * H + H * 4 * H + 4 * H) * 4)
    # the replay's recur, then K2's products on f32 dgates (dh, dx, dWx,
    # dWh) and db
    k2 = 2 * (2 * n_valid * 4 * H * (H + D + D + H) + n_valid * 4 * H)
    return nbytes, [(recur, PEAK_BF16_FLOPS), (k2, PEAK_TF32_FLOPS)]


def check_k3(gen):
    """K1's chunk-entry variant and K3 against their plain versions and
    against K1-stash / K2; then each timed at the train-long layer shape."""
    import torch

    from repro_torch.kernels import lstm_cell as LC

    L, B, T, D, H, K = 4, 2, 300, TRAIN_D, TRAIN_H, 64
    ws, x, lens = _long_inputs(gen, L, B, T, D, H, K)
    dy = torch.randn(L, B, T, 2 * H, generator=gen).to(x.device,
                                                        torch.bfloat16)
    for stash in ("float32", "bfloat16"):
        got = LC.blstm_layer_train_chunked(*ws, x, lens, chunk=K, stash=stash)
        torch.cuda.synchronize()
        want = LC.blstm_layer_train_chunked(*ws, x, lens, chunk=K,
                                            stash=stash, plain=True)
        errs = []
        for name, g, w_ in _chunked_pairs("K1-chunk", got, want):
            norm = _norm_err(g, w_)[1]
            errs.append(f"{name} {norm:.3g}")
            if not norm <= K1_TOL:
                _fail(f"K1-chunk {stash}: {name} disagrees with its plain "
                      f"version: {norm}")
        y_stash, acts, cseq = LC.blstm_layer_train(*ws, x, lens, stash=stash)
        if not torch.equal(got[0], y_stash):
            _fail(f"K1-chunk {stash}: y is not bit-identical to K1-stash's")
        if not torch.equal(got[0], LC.blstm_layer(*ws, x, lens)):
            _fail(f"K1-chunk {stash}: y is not bit-identical to K1 "
                  f"inference's (which streams Wh)")
        for l in range(L):
            for b in range(B):
                if got[0][l, b, int(lens[l, b]):].any():
                    _fail("K1-chunk: padded frames of y not zero")
        print(f"[K1-chunk] L={L} B={B} T={T} K={K} D={D} H={H} stash={stash} "
              f"lengths {lens.tolist()}: normalised errors {', '.join(errs)} "
              f"(tol {K1_TOL}); y bit-identical to K1-stash and to K1 "
              f"inference", flush=True)
        y, hb, cb = got
        args = (*ws, x, y, hb, cb, dy, lens)
        dx, grads = LC.blstm_layer_bwd_chunked(*args, chunk=K)
        torch.cuda.synchronize()
        want = LC.blstm_layer_bwd_chunked(*args, chunk=K, plain=True)
        errs = []
        for name, g, w_ in _chunked_pairs("K3", (dx, grads), want):
            norm = _norm_err(g, w_)[1]
            errs.append(f"{name} {norm:.3g}")
            if not norm <= K1_TOL:
                _fail(f"K3 {stash}: {name} disagrees with its plain version: "
                      f"{norm}")
        print(f"[K3] L={L} B={B} T={T} K={K} D={D} H={H} stash={stash}: "
              f"normalised errors vs plain {', '.join(errs)} (tol {K1_TOL})",
              flush=True)
        if stash != "float32":
            continue
        bwd_args = (ws[0], ws[1], ws[3], ws[4], x, y, acts, cseq, dy, lens)
        _k3_vs_k2((dx, grads), LC.blstm_layer_bwd(*bwd_args), "T=300")
        # the resident forward against the streaming launch
        with _streaming():
            fwd_s = LC.blstm_layer_train(*ws, x, lens, stash=stash)
        same = _bits_equal(fwd_s, (y_stash, acts, cseq))
        print(f"[K3] K1-stash at T={T}: {_recur_plan(L, B, T, H)[1]}; y "
              f"and stash bit-identical to the streaming launch's {same}; "
              f"K3's replay: {_recur_plan(L, B, K, H)[1]}", flush=True)
        if not same:
            _fail("the resident forward recurrence's bits differ from the "
                  "streaming one's")
    return _time_chunked(gen)


def _bits_equal(got, want) -> bool:
    """Whether two nests of tensors (or None) are equal bit for bit."""
    import torch

    if isinstance(got, (list, tuple)):
        return len(got) == len(want) and all(
            _bits_equal(g, w_) for g, w_ in zip(got, want))
    if got is None or want is None:
        return got is None and want is None
    return torch.equal(got, want)


def _streaming():
    """The wrappers' forward recurrences on the streaming launch (clusters
    of 2 reading Wh from device memory), whatever ``recur_plan`` picks: the
    oracle of the resident launch's bits."""
    from unittest import mock

    from repro_torch.kernels import lstm_cell as LC

    def plan(B, T, H):
        return LC.RecurPlan("stream", *LC._tile(B, H))
    return mock.patch.object(LC, "recur_plan", plan)


def _k3_vs_k2(got, want, where):
    """K3's dx bit-identical to K2's and its gradients within 2e-5 (the
    reference's chunked-vs-unchunked contract) on the same f32 stash."""
    import torch

    errs = {name: _norm_err(g, w_)[1] for name, g, w_ in
            _chunked_pairs("K3", got, want)}
    same = torch.equal(got[0], want[0])
    print(f"[K3] vs K2 on the same input at {where} (f32 stash): normalised "
          f"errors { {k: float(f'{v:.3g}') for k, v in errs.items()} } (tol "
          f"{K3_VS_K2_TOL}); dx bit-identical {same}", flush=True)
    if not same:
        _fail(f"K3's dx is not bit-identical to K2's at {where}")
    if not max(errs.values()) <= K3_VS_K2_TOL:
        _fail(f"K3's gradients are not within {K3_VS_K2_TOL} of K2's at "
              f"{where}")


def _timed_call(fn):
    """(ms, result) of one call of ``fn``, timed with CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _chunked_pairs(tag, got, want):
    """Named (kernel, plain) output pairs of K1-chunk (y, hb, cb) or of K3
    (dx and each direction's dwx, dwh, db)."""
    if tag == "K1-chunk":
        return list(zip(("y", "hb", "cb"), got, want))
    (dx, grads), (dx_w, grads_w) = got, want
    return [("dx", dx, dx_w)] + [
        (f"{n}_{d}", g, w_) for d in range(2)
        for n, g, w_ in zip(("dwx", "dwh", "db"), grads[d], grads_w[d])]


def _time_chunked(gen):
    """K1-chunk and K3 at the train-long layer shape: each held against
    its plain version on the same inputs and timed beside it, its bound
    and cuDNN's bf16 LSTM."""
    import torch

    from repro_torch.kernels import lstm_cell as LC

    L, B, T, D, H, K = LONG_L, LONG_ROWS, LONG_T, TRAIN_D, TRAIN_H, LONG_K
    ws, x, lens = _long_inputs(gen, L, B, T, D, H, K)
    dy = torch.randn(L, B, T, 2 * H, generator=gen).to(x.device,
                                                        torch.bfloat16)
    n_valid = int(lens.sum())
    fwd = lambda: LC.blstm_layer_train_chunked(*ws, x, lens, chunk=K)
    y, hb, cb = fwd()
    bwd_args = (*ws, x, y, hb, cb, dy, lens)
    # the unchunked pair on the same input: y and dx bit for bit
    y_stash, acts, cseq = LC.blstm_layer_train(*ws, x, lens)
    if not torch.equal(y, y_stash):
        _fail("K1-chunk at the train-long shape: y is not bit-identical to "
              "K1-stash's")
    _k3_vs_k2(LC.blstm_layer_bwd_chunked(*bwd_args, chunk=K),
              LC.blstm_layer_bwd(ws[0], ws[1], ws[3], ws[4], x, y, acts, cseq,
                                 dy, lens), "the train-long layer shape")
    del y_stash, acts, cseq
    (fwd_plan, fwd_text), (replay, replay_text) = (
        _recur_plan(L, B, T, H), _recur_plan(L, B, K, H))
    plans = {"K1-chunk": fwd_plan,
             "K3": dict(replay=replay, reverse=_reverse_plan(B, H))}
    print(f"[K1-chunk] train-long layer shape: y bit-identical to K1-stash's; "
          f"recurrence {fwd_text}; K3's replay {replay_text}, its reverse "
          f"{plans['K3']['reverse']}", flush=True)
    lib = _library_ms(lambda: _cudnn_blstm_train(x, ws), "K3")
    entries = []
    for name, fn, plain, lib_fn, tag, src, line in (
            ("blstm_layer_train_chunked", fwd,
             lambda: LC.blstm_layer_train_chunked(*ws, x, lens, chunk=K,
                                                  plain=True),
             None if lib is None else lib[0], "K1-chunk", "lstm_fwd.cu", 498),
            ("blstm_layer_bwd_chunked",
             lambda: LC.blstm_layer_bwd_chunked(*bwd_args, chunk=K),
             lambda: LC.blstm_layer_bwd_chunked(*bwd_args, chunk=K,
                                                plain=True),
             None if lib is None else lib[1], "K3", "lstm_bwd_chunked.cu",
             823)):
        got = fn()
        plain_ms, want = _timed_call(plain)
        worst, errs = 0.0, []
        for n, g, w_ in _chunked_pairs(tag, got, want):
            abs_err, norm = _norm_err(g, w_)
            errs.append(f"{n} {norm:.3g}")
            if not norm <= K1_TOL:
                _fail(f"{tag} at the train-long shape: {n} disagrees with "
                      f"its plain version: {norm}")
            worst = max(worst, abs_err)
        del got, want
        ms = _time_ms(fn, 3, warmup=0)
        subs = _sub_launch_ms(fn, 2)
        print(f"[{tag}] sub-launches, device ms per call (blstm_recur: the "
              f"forward recurrence, K3's replay; lstm_bwd_recur: the "
              f"reverse; the GEMMs: x·Wx, dx, dWx, dWh + db): "
              f"{ {k: round(v, 3) for k, v in subs.items()} }", flush=True)
        library_ms = None if lib_fn is None else _time_ms(lib_fn, 3)
        nbytes, ops = _chunked_bound(L, B, T, D, H, K, n_valid,
                                     tag == "K1-chunk")
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"[{tag}] L={L} B={B} T={T} K={K} D={D} H={H} var-len "
              f"({n_valid} valid frames): normalised errors vs plain "
              f"{', '.join(errs)} (tol {K1_TOL}); kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, library {library_ms} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
        entries.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/lstm_cell.py:{line}",
            max_abs_err=worst, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, sub_launch_ms=subs,
            recurrence=plans[tag],
            shape=f"L={L} B={B} T={T} K={K} D={D} H={H} f32 stash"))
    return entries


def _long_counts():
    from repro_torch.kernels import lstm_cell as LC

    return {"blstm_layer_train_chunked": LC.chunk_launches,
            "blstm_layer_bwd_chunked": LC.chunked_bwd_launches,
            "blstm_layer_train": LC.stash_launches,
            "blstm_layer_bwd": LC.bwd_launches}


def _long_run(cfg, ds, label, warmup, timed):
    """One train-long run: set-up, warm-up and timed steps with the
    counters set to 0 just before and read just after."""
    import math

    import torch

    from repro_torch.launch.train import run, setup_training, stash_line

    dev = torch.device("cuda")
    state, step, _ = setup_training(cfg, strategy_name="ad_psgd",
                                    n_learners=LONG_L, seed=SEED)
    print(f"[train-long {label}] {stash_line(cfg, LONG_BATCH, LONG_T)}",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    steps = warmup + timed
    state, _, records = run(state, step, ds, steps=steps, device=dev,
                            log_every=1, label=f"[train-long {label}] ")
    counts = _long_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(r[3]) for r in records]
    if not all(math.isfinite(v) for v in losses):
        _fail(f"train-long {label}: non-finite loss {losses}")
    t = records[warmup:]
    ms = 1e3 * sum(r[0] for r in t) / len(t)
    fps = sum(r[1] for r in t) / sum(r[0] for r in t)
    print(f"[train-long {label}] {len(t)} timed steps: {ms:.2f} ms/step, "
          f"{fps:.1f} valid frames/s ({sum(r[1] for r in t)} valid of "
          f"{sum(r[2] for r in t)} frames); peak device memory "
          f"{peak_gb:.2f} GiB; launches {counts} over {steps} steps",
          flush=True)
    phase_train_profile(state, step, ds, steps,
                        tag=f"train-long-profile {label}")
    return state, counts, steps, dict(ms=ms, fps=fps, peak_gb=peak_gb)


def _recorded_layer_grads(loss_fn, params, lb, which):
    """Loss and the per-layer f32 gradients (dx, dWx, dWh, db of each
    direction) that the wrapper ``which`` returned in one backward."""
    from unittest import mock

    from repro_torch.core import strategies as ST
    from repro_torch.kernels import lstm_cell as LC

    rec = []
    orig = getattr(LC, which)

    def recording(*a, **kw):
        dx, grads = orig(*a, **kw)
        rec.append([dx] + [g for d in grads for g in d])
        return dx, grads

    with mock.patch.object(LC, which, recording):
        loss, grads = ST._value_and_grad(loss_fn, params, lb)
    return loss, grads, rec


def phase_train_long():
    """Long utterances at full width: the chunked run, the unchunked run
    at the same batch, then one step's gradients of the two against each
    other."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import strategies as ST
    from repro_torch.data import make_dataset
    from repro_torch.kernels.lstm_cell import chunk_length
    from repro_torch.models import lstm as LS

    cfg = get_arch("swb2000-blstm")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ds = make_dataset(cfg, seq_len=LONG_T, batch=LONG_BATCH, seed=SEED,
                      var_len=True)
    ds.batch_at(0)
    print(f"[train-long] {cfg.name}: ad_psgd, {LONG_L} learners, batch "
          f"{LONG_BATCH}, T={LONG_T} var-len (lognormal, median "
          f"{int(0.6 * LONG_T)}); data set-up {time.perf_counter() - t0:.1f}s",
          flush=True)
    chunked = dataclasses.replace(cfg, lstm_seq_chunk=-1)
    K = chunk_length(LONG_T, -1)
    if K != LONG_K:
        _fail(f"seq_chunk -1 resolved to K={K} at T={LONG_T}, not {LONG_K}")
    results, counts = {}, {}
    for label, c, timed in (("chunked", chunked, LONG_STEPS),
                            ("unchunked", cfg, LONG_UNCHUNKED_STEPS)):
        state, n, steps, res = _long_run(c, ds, label, LONG_WARMUP, timed)
        results[label], counts[label] = res, n
        per_run = cfg.n_layers * steps          # one launch per layer-step
        want_chunked = per_run if label == "chunked" else 0
        want = {"blstm_layer_train_chunked": want_chunked,
                "blstm_layer_bwd_chunked": want_chunked,
                "blstm_layer_train": per_run - want_chunked,
                "blstm_layer_bwd": per_run - want_chunked}
        if n != want:
            _fail(f"train-long {label}: launches {n}, expected {want}")
        if label == "chunked":
            params = state["prev_params"]
        del state
    print(f"[train-long] chunked / unchunked: ms/step "
          f"{results['chunked']['ms'] / results['unchunked']['ms']:.3f}x, "
          f"peak memory {results['chunked']['peak_gb']:.2f} vs "
          f"{results['unchunked']['peak_gb']:.2f} GiB (lower by "
          f"{results['unchunked']['peak_gb'] - results['chunked']['peak_gb']:.2f}"
          f" GiB)", flush=True)

    # one step's loss and gradients, chunked vs unchunked, same weights
    lb = ST.split_learner_batch(
        {k: torch.as_tensor(v).to(dev)
         for k, v in ds.batch_at(LONG_WARMUP + LONG_STEPS).items()}, LONG_L)
    loss_c, grads_c, rec_c = _recorded_layer_grads(
        lambda p, b: LS.loss_train(chunked, p, b, device=dev), params, lb,
        "blstm_layer_bwd_chunked")
    loss_u, grads_u, rec_u = _recorded_layer_grads(
        lambda p, b: LS.loss_train(cfg, p, b, device=dev), params, lb,
        "blstm_layer_bwd")
    if not (torch.isfinite(loss_c).all()
            and len(rec_c) == len(rec_u) == cfg.n_layers):
        _fail("train-long: non-finite loss or missing layer gradients")
    loss_err = float(((loss_c - loss_u).abs() / loss_u.abs()).max())
    names = ["dx"] + [f"{n}_{d}" for d in range(2)
                      for n in ("dwx", "dwh", "db")]
    worst, where = 0.0, None
    for i, (a, b) in enumerate(zip(rec_c, rec_u)):
        for name, g, w_ in zip(names, a, b):
            if g is None:               # layer 0 takes no dx
                continue
            if not torch.isfinite(g).all():
                _fail(f"train-long: non-finite gradient {name} (layer "
                      f"{cfg.n_layers - 1 - i})")
            _, norm = _norm_err(g, w_)
            if norm > worst:
                worst, where = norm, f"layer {cfg.n_layers - 1 - i} {name}"
    param_worst = max(_norm_err(g, w_)[1] for g, w_ in
                      zip(ST._leaves(grads_c), ST._leaves(grads_u)))
    print(f"[train-long] one step at {LONG_L} learners, chunked vs unchunked "
          f"(f32 stash): loss relative error {loss_err:.3g}, worst "
          f"normalised f32 layer gradient error {worst:.3g} ({where}) (tol "
          f"{K3_VS_K2_TOL}); parameter gradients (bf16 weights) worst "
          f"{param_worst:.3g} (tol {K1_TOL})", flush=True)
    if not (loss_err <= K3_VS_K2_TOL and worst <= K3_VS_K2_TOL
            and param_worst <= K1_TOL):
        _fail("train-long: the chunked gradients disagree with the "
              "unchunked ones")
    return counts["chunked"], LONG_WARMUP + LONG_STEPS


# ---------------------------------------------------------------- phase 8
# The LM slice's serving shapes: 8 slots of a 1024-position cache at
# smollm-360m's 5 KV heads of M = 3 queries, E = 64; pages of 16.
LM_B, LM_S, LM_KV, LM_M, LM_E, LM_P = 8, 1024, 5, 3, 64, 16
LM_POOL = LM_B * LM_S // LM_P
LM_REQUESTS, LM_MAX_NEW, LM_SHARED = 16, 64, 64
LM_TIMED_POS = 511
LM_RAGGED = 600


def _attn_inputs(gen, B, S, KV=LM_KV, M=LM_M, E=LM_E, n_pages=None,
                 P=LM_P):
    """q, the cache (or a pool of ``n_pages`` pages of P), k_new, v_new:
    unit normals in bf16 on the card."""
    import torch

    cache = (n_pages, P) if n_pages else (B, S)

    def r(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)

    return (r(B, 1, KV * M, E), r(*cache, KV, E), r(*cache, KV, E),
            r(B, 1, KV, E), r(B, 1, KV, E))


def _attn_bytes_ops(B, rows, KV=LM_KV, M=LM_M, E=LM_E):
    """Bytes a delta call must move (q, the ``rows`` admitted cache rows
    of K and V of each (batch row, KV head), the new column, the output)
    and its f32 operations, at a group of M queries per KV head."""
    H = KV * M
    nbytes = (2 * B * H * E * 2 + 2 * B * rows * KV * E * 2
              + 2 * B * KV * E * 2)
    ops = 4 * B * (rows + 1) * H * E
    return nbytes, ops


def _sdpa(q, kc, vc, pos):
    """One scaled_dot_product_attention call over the whole cache with the
    canonical mask t <= pos (the library yardstick; used nowhere in the
    port)."""
    import torch
    import torch.nn.functional as F

    S = kc.shape[1]
    qt = q.transpose(1, 2)                               # (B, H, 1, E)
    kt = kc.transpose(1, 2).contiguous()                 # (B, KV, S, E)
    vt = vc.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=q.device) <= pos)[None, None, None]

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    return call


def _library_attn_ms(q, kc, vc, pos, what):
    """SDPA's eager ms and device ms (one call replayed from a CUDA
    graph), or (None, None), said, where no backend takes the inputs."""
    try:
        call = _sdpa(q, kc, vc, pos)
        return _time_ms(call, 50), _device_ms(call)
    except RuntimeError as e:        # no SDPA backend for these inputs
        print(f"[{what}] library (scaled_dot_product_attention) not timed: "
              f"{e}", flush=True)
        return None, None


def _taken_plan(DA, call):
    """The ``decode_plan`` the wrapper takes for ``call`` (run once)."""
    real, seen = DA.decode_plan, []
    DA.decode_plan = lambda *a: seen.append(real(*a)) or seen[-1]
    try:
        call()
    finally:
        DA.decode_plan = real
    return seen[-1]


def _attn_timed(tag, DA, call, B, KV, M, E, rows, extra_bytes=0):
    """One timed decode-attention shape: eager ms over 200 calls, the
    device ms of one launch, the bound of its bytes and operations, and
    the plan the wrapper took (splits, CTAs, rows per split), printed."""
    plan = _taken_plan(DA, call)
    ms, dev_ms = _time_ms(call, 200), _device_ms(call)
    nbytes, ops = _attn_bytes_ops(B, rows, KV, M, E)
    bound_ms, bound_by = _bound(nbytes + extra_bytes, ops, PEAK_F32_FLOPS)
    rec = dict(ms=ms, device_ms=dev_ms, bound_ms=bound_ms, bound_by=bound_by,
               n_split=plan.n_split, ctas=B * KV * plan.n_split,
               rows_per_split=plan.rows, admitted=[plan.lo, plan.hi])
    print(f"[{tag}] B={B} KV={KV} M={M} E={E}, {rows} old rows: kernel "
          f"{ms:.4f} ms eager, graph-replayed per launch {_ms(dev_ms)}, "
          f"bound {bound_ms:.5f} ms ({bound_by}); plan: {plan.n_split} "
          f"splits, {rec['ctas']} CTAs, rows {plan.lo}..{plan.hi - 1}, "
          f"<= {plan.rows} rows a split", flush=True)
    return rec


def _attn_sweep(tag, fn, ref, args, cases, tol=K1_TOL):
    """``fn`` against ``ref`` at every (pos, window) of ``cases``,
    canonical and delta; ``args`` = (q, cache..., k_new, v_new).  Returns
    the worst max abs error; fails past ``tol`` (normalised)."""
    import torch

    *head, kn, vn = args
    worst = 0.0
    for delta in (False, True):
        kw = dict(k_new=kn, v_new=vn) if delta else {}
        for pos, window in cases:
            got = fn(*head, pos, window=window, **kw)
            torch.cuda.synchronize()
            want = ref(*head, pos, window=window, **kw)
            abs_err, norm = _norm_err(got, want)
            if not norm <= tol:
                _fail(f"{tag} delta={delta} pos={pos} window={window}: "
                      f"normalised error {norm}")
            worst = max(worst, abs_err)
    return worst


# granite-moe-3b-a800m's decode attention (moe-serve, moe-paged): 24
# heads over 8 KV heads, E = 64, the LM slice's cache and pages
GRN_KV, GRN_M = 8, 3


def check_k7(gen):
    from repro_torch.kernels import decode_attention as DA

    q, kc, vc, kn, vn = _attn_inputs(gen, LM_B, LM_S)
    tile = DA.DEFAULT_BLOCK_S
    cases = [(pos, None) for pos in (0, tile - 1, tile, LM_TIMED_POS,
                                     LM_S - 1)] + [(700, 100)]
    worst = _attn_sweep("K7", DA.decode_attention, DA.decode_attention_ref,
                        (q, kc, vc, kn, vn), cases)
    print(f"[K7] decode_attention B={LM_B} S={LM_S} KV={LM_KV} M={LM_M} "
          f"E={LM_E} tile {tile}, canonical and delta: pos/window {cases} "
          f"within {K1_TOL} (worst max_abs_err {worst:.3g})", flush=True)
    one = [t[:1].contiguous() for t in (q, kc, vc, kn, vn)]
    worst_b1 = _attn_sweep("K7 B=1", DA.decode_attention,
                           DA.decode_attention_ref, one, cases)
    g = _attn_inputs(gen, LM_B, LM_S, GRN_KV, GRN_M)
    g1 = [t[:1].contiguous() for t in g]
    worst_grn = max(_attn_sweep(f"K7 granite B={len(x[0])}",
                                DA.decode_attention, DA.decode_attention_ref,
                                x, cases) for x in (g, g1))
    print(f"[K7] B=1 and granite's shape (B=8 and 1, KV={GRN_KV}, "
          f"M={GRN_M}): within {K1_TOL} (worst max_abs_err "
          f"{max(worst_b1, worst_grn):.3g})", flush=True)
    pos = LM_TIMED_POS
    plain_ms = _time_ms(lambda: DA.decode_attention_ref(
        q, kc, vc, pos, k_new=kn, v_new=vn), 20)
    library_ms, library_dev = _library_attn_ms(q, kc, vc, pos, "K7")
    library_b1, library_dev_b1 = _library_attn_ms(*one[:3], pos, "K7 B=1")

    def timed(tag, x, KV, M):
        return _attn_timed(tag, DA, lambda: DA.decode_attention(
            x[0], x[1], x[2], pos, k_new=x[3], v_new=x[4]),
            len(x[0]), KV, M, LM_E, pos)

    at = {"b8": timed("K7", (q, kc, vc, kn, vn), LM_KV, LM_M),
          "b1": timed("K7 B=1", one, LM_KV, LM_M),
          "granite_b8": timed("K7 granite", g, GRN_KV, GRN_M),
          "granite_b1": timed("K7 granite B=1", g1, GRN_KV, GRN_M)}
    at["b8"].update(library_ms=library_ms, library_device_ms=library_dev)
    at["b1"].update(library_ms=library_b1, library_device_ms=library_dev_b1)
    print(f"[K7] B={LM_B} pos={pos} delta: plain {plain_ms:.4f} ms; "
          f"library {library_ms} ms eager, {_ms(library_dev)} device (B=1: "
          f"{library_b1} / {_ms(library_dev_b1)})", flush=True)
    hyb = _check_k7_hybrid(gen)
    at.update(hymba_b8=hyb.pop("at_b8"), hymba_b1=hyb.pop("at_b1"))
    wide, worst_wide = _check_k7_wide(gen)
    at.update(wide)
    b8 = at["b8"]
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:216",
                max_abs_err=max(worst, worst_b1, worst_grn, worst_wide),
                ms=b8["ms"],
                plain_ms=plain_ms, bound_ms=b8["bound_ms"],
                bound_by=b8["bound_by"], library_ms=library_ms,
                device_ms=b8["device_ms"], device_ms_b1=at["b1"]["device_ms"],
                plan={k: b8[k] for k in ("n_split", "ctas",
                                         "rows_per_split")},
                shapes=at,
                shape=f"B={LM_B} S={LM_S} KV={LM_KV} M={LM_M} E={LM_E} "
                      f"pos={pos} delta tile={tile}", **hyb)


# hymba-1.5b's decode attention (the hybrid-serve phase): 8 slots of a
# 2048-position cache, 5 KV heads of M = 5 queries, E = 64, and the
# windowed layers' 1024-position window.
HYB_B, HYB_CACHE, HYB_KV, HYB_M, HYB_E, HYB_WINDOW = 8, 2048, 5, 5, 64, 1024
HYB_TIMED_POS = 1600


def _check_k7_hybrid(gen):
    """K7 at hymba-1.5b's decode shape against its plain version, over pos
    at and around the window's edge, canonical and delta, at 8 slots and
    at one request; the delta call timed at pos 1600 (1023 cache rows
    inside the window).  Returns the fields this adds to K7's entry."""
    from repro_torch.kernels import decode_attention as DA

    B, S, KV, M, E, W = (HYB_B, HYB_CACHE, HYB_KV, HYB_M, HYB_E,
                         HYB_WINDOW)
    x = _attn_inputs(gen, B, S, KV, M, E)
    one = [t[:1].contiguous() for t in x]
    cases = [(pos, W) for pos in (0, W - 1, W, HYB_TIMED_POS, S - 1)]
    worst = max(_attn_sweep(f"K7 (hymba shape) B={len(y[0])}",
                            DA.decode_attention, DA.decode_attention_ref,
                            y, cases) for y in (x, one))
    pos = HYB_TIMED_POS
    rows = W - 1                        # old rows inside the window

    def timed(tag, y):
        return _attn_timed(tag, DA, lambda: DA.decode_attention(
            y[0], y[1], y[2], pos, window=W, k_new=y[3], v_new=y[4]),
            len(y[0]), KV, M, E, rows)

    b8, b1 = timed("K7 hymba", x), timed("K7 hymba B=1", one)
    print(f"[K7] hymba shape B={B} and 1, S={S} KV={KV} M={M} E={E} window "
          f"{W}: pos 0..{S - 1} canonical and delta within {K1_TOL} (worst "
          f"max_abs_err {worst:.3g})", flush=True)
    return dict(ms_hymba=b8["ms"], device_ms_hymba=b8["device_ms"],
                bound_ms_hymba=b8["bound_ms"], max_abs_err_hymba=worst,
                shape_hymba=f"B={B} S={S} KV={KV} M={M} E={E} pos={pos} "
                            f"window={W} delta", at_b8=b8, at_b1=b1)


# K7 at the decode shapes of the encdec and dense-configs phases: whisper-
# large-v3's cross-attention (the canonical variant over all 1500 encoder
# frames at pos 1499) and self-attention (the delta variant over its
# 448-position cache; the phase decodes positions 4..67), MHA (20 heads,
# M = 1, E = 64) at 8 streams; stablelm-12b's (32 heads over 8, M = 4, E =
# 160) at the phase's 4 slots of 1024 positions
K7_WIDE = [
    # tag, B, S, KV, M, E, timed pos, delta, sweep positions
    ("whisper_cross", 8, 1500, 20, 1, 64, 1499, False, (0, 1023, 1499)),
    ("whisper_self", 8, 448, 20, 1, 64, 67, True, (0, 15, 16, 67, 447)),
    ("stablelm_e160", 4, 1024, 8, 4, 160, 511, True,
     (0, 15, 16, 511, 1023)),
]


def _check_k7_wide(gen):
    """K7 against its plain version at every K7_WIDE shape (canonical and
    delta over its positions, 2e-2), each timed at its decode position in
    the variant the phase runs, beside SDPA.  Returns ({tag: record},
    worst max_abs_err)."""
    from repro_torch.kernels import decode_attention as DA

    out, worst = {}, 0.0
    for tag, B, S, KV, M, E, pos, delta, sweep in K7_WIDE:
        x = _attn_inputs(gen, B, S, KV, M, E)
        worst = max(worst, _attn_sweep(f"K7 {tag}", DA.decode_attention,
                                       DA.decode_attention_ref, x,
                                       [(p, None) for p in sweep]))
        kw = dict(k_new=x[3], v_new=x[4]) if delta else {}

        def call(fn=DA.decode_attention):
            return fn(x[0], x[1], x[2], pos, **kw)

        # the canonical call reads pos + 1 rows, as many bytes and
        # operations as a delta call of pos old rows and the new column
        rec = _attn_timed(f"K7 {tag}", DA, call, B, KV, M, E, pos)
        rec["plain_ms"] = _time_ms(
            lambda: call(DA.decode_attention_ref), 20)
        if delta:
            kc, vc = x[1].clone(), x[2].clone()
            kc[:, pos], vc[:, pos] = x[3][:, 0], x[4][:, 0]
        else:
            kc, vc = x[1], x[2]
        rec["library_ms"], rec["library_device_ms"] = _library_attn_ms(
            x[0], kc, vc, pos, f"K7 {tag}")
        rec["shape"] = (f"B={B} S={S} KV={KV} M={M} E={E} pos={pos} "
                        f"{'delta' if delta else 'canonical'}")
        print(f"[K7] {tag}: {rec['shape']}, positions {sweep} canonical and "
              f"delta within {K1_TOL}; plain {rec['plain_ms']:.4f} ms, "
              f"library {_ms(rec['library_ms'])} eager, "
              f"{_ms(rec['library_device_ms'])} graph-replayed", flush=True)
        out[tag] = rec
        del x, kc, vc
    return out, worst


def _shuffled_pool_table(gen, B, W, n_pages, used):
    """Each row's first ``used`` entries distinct pages of a shuffled
    pool, the rest arbitrary valid ids (never read)."""
    import torch

    perm = torch.randperm(n_pages, generator=gen)
    tbl = torch.randint(0, n_pages, (B, W), generator=gen)
    tbl[:, :used] = perm[:B * used].reshape(B, used)
    return tbl.to("cuda", torch.int32)


def check_k8(gen):
    import torch

    from repro_torch.kernels import decode_attention as DA

    dev = torch.device("cuda")
    W = LM_S // LM_P
    q, kp, vp, kn, vn = _attn_inputs(gen, LM_B, None, n_pages=LM_POOL)
    used = 36                         # pages of a 560-position request
    tbl = _shuffled_pool_table(gen, LM_B, W, LM_POOL, used)
    cases = [(0, None), (15, None), (16, None), (LM_TIMED_POS, None),
             (used * LM_P - 1, None), (500, 100)]
    worst = _attn_sweep("K8", DA.paged_decode_attention,
                        DA.paged_decode_attention_ref,
                        (q, kp, vp, tbl, kn, vn), cases)
    # one request, and granite's 8 KV heads, over pools of their own
    one = (q[:1].contiguous(), kp, vp, tbl[:1].contiguous(),
           kn[:1].contiguous(), vn[:1].contiguous())
    worst_b1 = _attn_sweep("K8 B=1", DA.paged_decode_attention,
                           DA.paged_decode_attention_ref, one, cases)
    gq, gkp, gvp, gkn, gvn = _attn_inputs(gen, LM_B, None, GRN_KV, GRN_M,
                                          n_pages=LM_POOL)
    g = (gq, gkp, gvp, _shuffled_pool_table(gen, LM_B, W, LM_POOL, used),
         gkn, gvn)
    g1 = tuple(t if t.dim() == 4 and t.shape[0] == LM_POOL
               else t[:1].contiguous() for t in g)
    worst_grn = max(_attn_sweep(f"K8 granite B={len(y[0])}",
                                DA.paged_decode_attention,
                                DA.paged_decode_attention_ref, y, cases)
                    for y in (g, g1))
    # contiguous pages: the paged kernel equals the dense one at block_s = P
    _, kc, vc, _, _ = _attn_inputs(gen, LM_B, LM_S)
    ctbl = torch.arange(LM_POOL, device=dev,
                        dtype=torch.int32).reshape(LM_B, W)
    kcp = kc.reshape(LM_POOL, LM_P, LM_KV, LM_E)
    vcp = vc.reshape(LM_POOL, LM_P, LM_KV, LM_E)
    for delta in (False, True):
        kw = dict(k_new=kn, v_new=vn) if delta else {}
        for pos in (0, 16, LM_TIMED_POS, LM_S - 1):
            for window in (None, 100):
                dense = DA.decode_attention(q, kc, vc, pos, window=window,
                                            block_s=LM_P, **kw)
                paged = DA.paged_decode_attention(q, kcp, vcp, ctbl, pos,
                                                  window=window, **kw)
                if not torch.equal(dense, paged):
                    _fail(f"K8 is not bit-identical to K7 at block_s="
                          f"{LM_P} (delta={delta}, pos={pos}, window="
                          f"{window})")
    print(f"[K8] paged_decode_attention B={LM_B} and 1 (granite's KV="
          f"{GRN_KV} M={GRN_M} too) pool={LM_POOL}x{LM_P} W={W} shuffled, "
          f"padded: within {K1_TOL} (worst max_abs_err "
          f"{max(worst, worst_b1, worst_grn):.3g}); bit-identical to K7 at "
          f"block_s={LM_P} on contiguous pages", flush=True)
    pos = LM_TIMED_POS
    plain_ms = _time_ms(lambda: DA.paged_decode_attention_ref(
        q, kp, vp, tbl, pos, k_new=kn, v_new=vn), 20)
    k7_16 = _attn_timed("K8's shape through K7", DA,
                        lambda: DA.decode_attention(
                            q, kc, vc, pos, block_s=LM_P, k_new=kn,
                            v_new=vn), LM_B, LM_KV, LM_M, LM_E, pos)
    library_ms, library_dev = _library_attn_ms(
        q, DA.gather_pages(kp, tbl), DA.gather_pages(vp, tbl), pos, "K8")

    def timed(tag, y, KV, M):
        B = len(y[0])
        return _attn_timed(tag, DA, lambda: DA.paged_decode_attention(
            y[0], y[1], y[2], y[3], pos, k_new=y[4], v_new=y[5]),
            B, KV, M, LM_E, pos,
            extra_bytes=B * (pos // LM_P + 1) * 4)   # table entries

    at = {"b8": timed("K8", (q, kp, vp, tbl, kn, vn), LM_KV, LM_M),
          "b1": timed("K8 B=1", one, LM_KV, LM_M),
          "granite_b8": timed("K8 granite", g, GRN_KV, GRN_M),
          "granite_b1": timed("K8 granite B=1", g1, GRN_KV, GRN_M)}
    at["b8"].update(library_ms=library_ms, library_device_ms=library_dev,
                    k7_block16_ms=k7_16["ms"],
                    k7_block16_device_ms=k7_16["device_ms"])
    b8 = at["b8"]
    print(f"[K8] B={LM_B} pos={pos} delta: plain {plain_ms:.4f} ms, "
          f"library {library_ms} ms eager, {_ms(library_dev)} device (over "
          f"the gathered cache); K7 at block_s={LM_P} on the same shape "
          f"{_ms(k7_16['device_ms'])} device", flush=True)
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:294",
                max_abs_err=max(worst, worst_b1, worst_grn), ms=b8["ms"],
                plain_ms=plain_ms, bound_ms=b8["bound_ms"],
                bound_by=b8["bound_by"], library_ms=library_ms,
                device_ms=b8["device_ms"],
                plan={k: b8[k] for k in ("n_split", "ctas",
                                         "rows_per_split")},
                shapes=at,
                shape=f"B={LM_B} pool={LM_POOL}x{LM_P} W={W} KV={LM_KV} "
                      f"M={LM_M} E={LM_E} pos={pos} delta")


def check_k6(gen):
    """K6 at the dense decode's shape, bit for bit against its plain
    version on rows of planted ties, NaN and -inf, in bf16, in f32 and on
    a view one element off a 16-byte boundary; timed eager and
    graph-replayed beside ``torch.argmax``, timed the same two ways."""
    import torch

    from repro_torch.decode import kernel as DK

    B, V = LM_B, 49152
    x = torch.randn(B, V, generator=gen)
    x[1, [7, 4096, V - 1]] = 6.0                 # a three-way tie
    x[2, [100, 30000]] = float("nan")           # the first NaN wins
    x[2, 5] = float("inf")
    x[3] = float("-inf")
    x[4] = torch.round(x[4] * 2) / 2            # many ties
    x[5, [V // 8 - 1, V // 8]] = 9.0            # a tie across a slice bound
    x[6, -1] = float("nan")                     # NaN only in the last slice
    x = x.to("cuda", torch.bfloat16)
    shifted = torch.empty(B * V + 1, dtype=torch.bfloat16, device="cuda")
    shifted = shifted[1:].view(B, V)
    shifted.copy_(x)
    for tag, rows in (("bf16", x), ("f32", x.float()),
                      ("bf16 at an offset of one element", shifted)):
        got = DK.argmax_tokens(rows)
        torch.cuda.synchronize()
        want = DK.argmax_ref(rows)
        if not torch.equal(got, want):
            _fail(f"K6 argmax {tag} {got.tolist()} != plain "
                  f"{want.tolist()}")
        if got[1:4].tolist() != [7, 100, 0] or got[5:7].tolist() != \
                [V // 8 - 1, V - 1]:
            _fail(f"K6 {tag} ties/NaN/-inf rows gave {got[1:7].tolist()}")
    slices = DK.argmax_slices(B, V, 2, DK._n_sm)
    print(f"[K6] argmax_tokens ({B}, {V}) bf16, f32 and at an offset of one "
          f"element, {slices} CTAs a row, ties + NaN + -inf rows: "
          f"bit-identical to the plain version {got.tolist()}", flush=True)
    # both eager times are the host's: taken in turns, kernel and library
    # alternating, each the median of its five, so that the host's drift
    # over the phase falls on both alike
    turns = [(_time_ms(lambda: DK.argmax_tokens(x), 200),
              _time_ms(lambda: torch.argmax(x, dim=-1), 200))
             for _ in range(5)]
    ms, library_ms = (sorted(t)[2] for t in zip(*turns))
    plain_ms = _time_ms(lambda: DK.argmax_ref(x), 200)
    dev_ms = _device_ms(lambda: DK.argmax_tokens(x))
    lib_dev_ms = _device_ms(lambda: torch.argmax(x, dim=-1))
    bound_ms, bound_by = _bound(B * V * 2 + B * 4, B * V, PEAK_F32_FLOPS)
    print(f"[K6] kernel {ms:.4f} ms eager (median of 5 turns "
          f"{[round(k, 4) for k, _ in turns]}), graph-replayed per launch "
          f"{_ms(dev_ms)}; torch.argmax {library_ms:.4f} ms eager (turns "
          f"{[round(t, 4) for _, t in turns]}), graph-replayed "
          f"{_ms(lib_dev_ms)}; plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by})", flush=True)
    return dict(name="argmax_tokens", route="cuda",
                source="src/repro_torch/decode/csrc/argmax.cu",
                replaces="src/repro/decode/kernel.py:158", max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, device_ms=dev_ms,
                bound_by=bound_by, library_ms=library_ms,
                library_device_ms=lib_dev_ms, slices=slices,
                shape=f"B={B} V={V} bf16", vocabs=_check_k6_vocabs(gen))


# the vocabularies of the encdec, vlm and dense-configs phases: whisper-
# large-v3's and internvl2-2b's are odd multiples of 2 bytes off a 16-byte
# boundary (every bf16 row after the first starts mid-vector), phi3's and
# stablelm's 100,352, command-r's 256,000
K6_VOCABS = (51866, 92553, 100352, 256000)


def _check_k6_vocabs(gen):
    """K6 at B = 8 over each of K6_VOCABS: bit for bit against
    ``torch.argmax`` and the plain version on unit normals (ties planted
    in one row, the maximum in the last element of another), timed eager
    and graph-replayed beside ``torch.argmax``.  Returns {V: record}."""
    import torch

    from repro_torch.decode import kernel as DK

    out = {}
    for V in K6_VOCABS:
        x = torch.randn(8, V, generator=gen)
        x[1, [3, V // 2, V - 2]] = 7.0           # a three-way tie
        x[2, V - 1] = 8.0                        # the row's last element
        x = x.to("cuda", torch.bfloat16)
        got = DK.argmax_tokens(x)
        torch.cuda.synchronize()
        want = torch.argmax(x, dim=-1)
        if not (torch.equal(got, want.to(got.dtype))
                and torch.equal(got, DK.argmax_ref(x))
                and got[1:3].tolist() == [3, V - 1]):
            _fail(f"K6 at V = {V}: {got.tolist()} != torch.argmax "
                  f"{want.tolist()}")
        kernel = functools.partial(DK.argmax_tokens, x)
        library = functools.partial(torch.argmax, x, dim=-1)
        rec = dict(ms=_time_ms(kernel, 200), device_ms=_device_ms(kernel),
                   library_ms=_time_ms(library, 200),
                   library_device_ms=_device_ms(library),
                   plain_ms=_time_ms(functools.partial(DK.argmax_ref, x), 50),
                   slices=DK.argmax_slices(8, V, 2, DK._n_sm))
        rec["bound_ms"], rec["bound_by"] = _bound(8 * V * 2 + 8 * 4, 8 * V,
                                                  PEAK_F32_FLOPS)
        print(f"[K6] V={V} (8 rows, bf16, {rec['slices']} CTAs a row): "
              f"bit-identical to torch.argmax and the plain version; kernel "
              f"{rec['ms']:.4f} ms eager, graph-replayed "
              f"{_ms(rec['device_ms'])}; torch.argmax {rec['library_ms']:.4f}"
              f" ms / {_ms(rec['library_device_ms'])}; plain "
              f"{rec['plain_ms']:.4f} ms; bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']})", flush=True)
        out[V] = rec
    return out


# --------------------------------------------------------------- phase 8a
# The flash-attention kernel (K11 port): the prefill attention of the
# dense and hybrid families.  hymba-1.5b's serving shape is a B = 1
# prefill of 1500 tokens (past the 1024-position window, a multiple of
# neither 512 nor 256) with 25 query heads over 5 KV heads, E = 64.
HYB_S, HYB_H = 1500, 25
K11_TOL = 2e-2           # a row's bf16 output rounding (docs/kernels.md)
# held on the card: the kernel rounds p to bf16 once before p·v (as the
# reference model's prefill does), kept only while it stays within half
# the output's tolerance
K11_P_TOL = 1e-2
GLOBAL = 2 ** 30         # the model's GLOBAL_WINDOW
K11_CASES = [
    # tag, B, Sq, Sk, H, KV, E, causal, window, q_offset, timed
    ("hymba windowed", 1, HYB_S, HYB_S, HYB_H, HYB_KV, 64, True, HYB_WINDOW,
     0, True),
    ("hymba global", 1, HYB_S, HYB_S, HYB_H, HYB_KV, 64, True, GLOBAL, 0,
     True),
    ("smollm-360m", 1, 600, 600, 15, 5, 64, True, GLOBAL, 0, True),
    ("granite S=700", 1, 700, 700, 24, 8, 64, True, GLOBAL, 0, True),
    ("ragged Sq=1", 2, 1, 1, 4, 2, 64, True, 0, 0, False),
    ("ragged E=32", 3, 77, 77, 6, 2, 32, True, 16, 0, False),
    ("q_offset", 2, 100, 700, HYB_H, HYB_KV, 64, True, 256, 600, False),
    ("q_offset global", 1, 37, 300, 15, 5, 64, True, 0, 263, False),
    ("non-causal", 2, 333, 290, 8, 2, 64, False, 0, 0, False),
    ("M=8 E=128 windowed", 1, 777, 777, 8, 1, 128, True, 128, 0, False),
    ("M=8 E=128 global", 1, 777, 777, 8, 1, 128, True, 0, 0, False),
    # stablelm-12b's prefill (32 heads over 8, E = 160: 192-column tiles),
    # whisper-large-v3's encoder (30 s of audio: 1500 frames, 20 heads,
    # MHA, non-causal) and its decoder's cross-attention (the 4-token start
    # sequence over the 1500 encoder frames)
    ("stablelm E=160", 1, 1000, 1000, 32, 8, 160, True, GLOBAL, 0, True),
    ("whisper encoder", 1, 1500, 1500, 20, 20, 64, False, 0, 0, True),
    ("whisper cross", 1, 4, 1500, 20, 20, 64, False, 0, 0, True),
    ("E=160 windowed ragged", 2, 77, 77, 8, 2, 160, True, 16, 0, False),
    ("E=160 q_offset", 1, 37, 300, 8, 2, 160, True, 0, 263, False),
    ("E=160 non-causal", 2, 5, 333, 4, 4, 160, False, 0, 0, False),
]


def _attn_pairs(Sq, Sk, causal, window, q_offset):
    """The (query position, key) pairs one head admits."""
    import numpy as np

    if not causal:
        return Sq * Sk
    p = q_offset + np.arange(Sq)
    hi = np.minimum(p, Sk - 1)
    lo = np.maximum(p - window + 1, 0) if 0 < window < GLOBAL else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flash_bytes_ops(B, Sq, Sk, H, KV, E, causal, window, q_offset):
    """Bytes a call must move (q, k, v in and o out, bf16) and its
    operations: 4E per admitted pair and query head (q.k and p.v), all on
    bf16 operands at the bf16 tensor-core peak."""
    nbytes = 2 * (2 * B * Sq * H * E + 2 * B * Sk * KV * E)
    return nbytes, 4 * E * B * H * _attn_pairs(Sq, Sk, causal, window,
                                                q_offset)


def _sdpa_prefill(q, k, v, causal, window, q_offset):
    """The library yardstick (used nowhere in the port): one
    scaled_dot_product_attention call with the library's GQA grouping,
    ``is_causal`` for a global prefill, else a boolean mask."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    Sq, Sk = q.shape[1], k.shape[1]
    kw = {}
    full = window <= 0 or window >= GLOBAL
    if causal and full and q_offset == 0 and Sq == Sk:
        kw["is_causal"] = True
    elif causal:
        qp = q_offset + torch.arange(Sq, device=q.device)
        kp = torch.arange(Sk, device=q.device)
        ok = qp[:, None] >= kp[None, :]
        if not full:
            ok &= qp[:, None] - kp[None, :] < window
        kw["attn_mask"] = ok

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **kw)
    return call


def _attn_f64(q, k, v, causal, window, q_offset):
    """The attention of ``flash_attention_plain`` evaluated in float64
    (window 0 or past every position: none), unrounded: the yardstick of
    both the kernel's and the plain version's rounding."""
    import torch

    B, Sq, H, E = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, E).double()
    s = torch.einsum("bsgme,btge->bgmst", qg, k.double()) / E ** 0.5
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)
        kp = torch.arange(Sk, device=q.device)
        ok = qp[:, None] >= kp[None, :]
        if 0 < window < GLOBAL:
            ok &= qp[:, None] - kp[None, :] < window
        s = s.masked_fill(~ok, -1e30)
    o = torch.einsum("bgmst,btge->bsgme", torch.softmax(s, -1), v.double())
    return o.reshape(B, Sq, H, E)


def _f64_distance(got, ref):
    """(worst row-normalised error, whole-tensor relative RMS) of ``got``
    against the f64 ``ref``."""
    d = got.double() - ref
    row = d.abs().amax(-1) / (ref.abs().amax(-1) + 1e-6)
    return float(row.max()), float(d.norm() / ref.norm())


def _sass_counts(lib, opcodes=("HGMMA", "HMMA", "UTMALDG")):
    """How many of each SASS opcode the shared library holds, read with
    the ``cuobjdump`` of the toolkit that built it (raises where that
    toolkit has none)."""
    import re

    from repro_torch.kernels import build

    out = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return {op: len(re.findall(rf"\b{op}\.", out)) for op in opcodes}


def check_k11(gen):
    """K11 against ``flash_attention_plain`` at every case of K11_CASES
    (K11_P_TOL of each row's largest value, :func:`_row_err`; every value
    finite); the timed ones beside their plain version, their bound and
    SDPA, and the kernel and the plain version beside an f64 evaluation;
    the flash library's SASS must hold wgmma and TMA loads, no mma.sync.  At hymba's windowed shape the check must also reject the
    plain version with the window one key short, the smallest fault a
    kernel's window edge could have."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import flash_attention_plain

    worst, rows = 0.0, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tag, B, Sq, Sk, H, KV, E, causal, window, q_offset, timed in \
            K11_CASES:
        def r(*shape):
            return torch.randn(*shape, generator=gen).to("cuda",
                                                         torch.bfloat16)

        q, k, v = r(B, Sq, H, E), r(B, Sk, KV, E), r(B, Sk, KV, E)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        before = FA.launches
        got = FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if FA.launches != before + 1:
            _fail(f"K11 {tag}: the wrapper did not launch the kernel")
        want = flash_attention_plain(q, k, v, **kw)
        abs_err, norm = _row_err(got, want)
        if not (norm <= K11_P_TOL and bool(torch.isfinite(got).all())):
            _fail(f"K11 {tag}: row-normalised error {norm} (tol "
                  f"{K11_P_TOL}), or a value that is not finite")
        worst = max(worst, abs_err)
        pl = FA.plan(B, Sq, KV, H // KV, E, sms)
        line = (f"[K11] {tag}: B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} E={E} "
                f"causal={causal} window={window} q_offset={q_offset} "
                f"({pl.items} CTAs: {pl.tiles} row tiles of {pl.rows} "
                f"rows x {B * KV} (batch, KV head) on {sms} SMs): "
                f"row-normalised error {norm:.3g} (tol {K11_P_TOL}; "
                f"tensor-normalised {_norm_err(got, want)[1]:.3g}), "
                f"max_abs_err {abs_err:.3g}")
        if tag == "hymba windowed":
            short = flash_attention_plain(q, k, v, causal=causal,
                                          window=window - 1,
                                          q_offset=q_offset)
            seen = _row_err(short, want)[1]
            line += (f"; the window one key short: row-normalised "
                     f"{seen:.3g}, tensor-normalised "
                     f"{_norm_err(short, want)[1]:.3g}")
            if not seen > K11_TOL:
                _fail(f"K11 {tag}: the check cannot tell a window one key "
                      f"short ({seen} <= {K11_TOL})")
        if timed:
            call = lambda: FA.flash_attention(q, k, v, **kw)  # noqa: E731
            ms, dev_ms = _time_ms(call, 50), _device_ms(call)
            plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                                5)
            try:
                sdpa = _sdpa_prefill(q, k, v, causal, window, q_offset)
                library_ms, library_dev = _time_ms(sdpa, 50), _device_ms(sdpa)
            except (RuntimeError, TypeError) as e:    # no SDPA backend
                print(f"[K11] {tag}: library not timed: {e}", flush=True)
                library_ms = library_dev = None
            nbytes, ops = _flash_bytes_ops(B, Sq, Sk, H, KV, E, causal,
                                           window, q_offset)
            bound_ms, bound_by = _bound(nbytes, ops, PEAK_BF16_FLOPS)
            ref = _attn_f64(q, k, v, causal, window, q_offset)
            f64 = {"kernel": _f64_distance(got, ref),
                   "plain": _f64_distance(want, ref)}
            del ref
            rows[tag] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                             library_ms=library_ms,
                             library_device_ms=library_dev,
                             bound_ms=bound_ms, bound_by=bound_by,
                             f64_row_err=f64["kernel"][0],
                             f64_row_err_plain=f64["plain"][0],
                             shape=f"B={B} S={Sq} H={H} KV={KV} E={E} "
                                   f"window={window} bf16")
            line += (f"; kernel {ms:.4f} ms eager, graph-replayed per "
                     f"launch {_ms(dev_ms)}, plain {plain_ms:.4f} ms, "
                     f"library {_ms(library_ms)} eager, "
                     f"{_ms(library_dev)} graph-replayed, bound "
                     f"{bound_ms:.5f} ms ({bound_by}: {ops / 1e9:.3f} GFLOP, "
                     f"{nbytes / 1e6:.2f} MB), roofline share "
                     f"{bound_ms / (dev_ms or ms):.3f}; vs f64 (worst "
                     f"row-normalised, relative RMS): " + ", ".join(
                         f"{n} {a:.3g} / {b:.3g}"
                         for n, (a, b) in f64.items()))
        print(line, flush=True)
    sass = _sass_counts(build.lib_path("flash_attention"))
    print(f"[K11] SASS of the flash library: {sass}", flush=True)
    if not (sass["HGMMA"] > 0 and sass["HMMA"] == 0 and sass["UTMALDG"] > 0):
        _fail(f"K11: the flash library is not on wgmma and TMA: {sass}")
    extra = {}
    for tag, key in (("hymba global", "global"), ("smollm-360m", "smollm"),
                     ("granite S=700", "granite"),
                     ("stablelm E=160", "stablelm"),
                     ("whisper encoder", "whisper_encoder"),
                     ("whisper cross", "whisper_cross")):
        extra.update({f"{k}_{key}": v for k, v in rows[tag].items()})
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:119",
                max_abs_err=worst, sass=sass, **rows["hymba windowed"],
                **extra)


# ---------------------------------------------------------------- phase 9
def _lm_counts():
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD

    return {"decode_attention": DA.launches,
            "paged_decode_attention": DA.paged_launches,
            "argmax_tokens": DK.argmax_launches,
            "flash_attention": FA.launches, "ssd_scan": SSD.launches}


def _zero_lm_counts():
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD

    DA.launches = DA.paged_launches = DK.argmax_launches = 0
    FA.launches = SSD.launches = 0


def _lm_pending(cfg, requests=LM_REQUESTS):
    """16 prompts of 64-960 tokens drawn with the seed, sharing a 64-token
    prefix; the second forced to LM_RAGGED = 600 (past 512 and no
    multiple of it: a length the 512-row chunked prefill once refused)."""
    import numpy as np

    from repro_torch.launch.serve import lm_requests

    lengths = np.random.default_rng(SEED).integers(64, 961, size=requests)
    lengths[1] = LM_RAGGED
    return lm_requests(cfg, [int(n) for n in lengths],
                       shared_prefix=LM_SHARED, seed=SEED)


def _lm_run(server, pending, max_new):
    """Serve ``pending`` once with the launch counters set to 0 just
    before and read just after."""
    import torch

    from repro_torch.launch.serve import serve_lm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    t0 = time.perf_counter()
    finished, admit_s, wave_s, occ = serve_lm(server, pending, max_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dict(finished), admit_s, wave_s, occ, dt, _lm_counts()


def _lm_report(tag, cfg, pending, finished, admit_s, wave_s, occ, dt,
               counts, max_new):
    import numpy as np
    import torch

    if sorted(finished) != [rid for rid, _ in pending]:
        _fail(f"{tag}: served {sorted(finished)}, expected all of "
              f"{len(pending)}")
    for rid, toks in finished.items():
        if len(toks) != max_new or min(toks) < 0 or max(toks) >= cfg.vocab:
            _fail(f"{tag}: request {rid} decoded {len(toks)} tokens, or "
                  f"one outside the vocabulary")
    n_tok = sum(len(t) for t in finished.values())
    print(f"[{tag}] {len(finished)} requests, {n_tok} tokens, "
          f"{len(wave_s)} waves in {dt:.3f}s: {n_tok / dt:.1f} decoded "
          f"tokens/s, mean wave {1e3 * float(np.mean(wave_s)):.2f} ms, "
          f"prefill {1e3 * float(np.mean(admit_s)):.2f} ms per request, "
          f"occupancy {occ:.2f}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches {counts}", flush=True)


def _teacher_forced_logits(server, prompt, tokens, steps):
    """Last-token logits of the prefill and of ``steps`` decode steps fed
    ``tokens`` (one request, batch 1), as (steps + 1, V) f32."""
    import torch

    dev = torch.device("cuda")
    logits, cache = server.model.prefill_fn(
        server.params, {"tokens": torch.as_tensor(prompt[None]).to(dev)},
        cache_len=server.max_len)
    out = [logits[:, -1].float()]
    for i in range(steps):
        tok = torch.tensor([[tokens[i]]], dtype=torch.int32, device=dev)
        logits, cache = server.model.decode_fn(server.params, cache, tok,
                                               len(prompt) + i)
        out.append(logits[:, -1].float())
    return torch.cat(out)


def _moe_dense_learners_plain(x, router_w, wi, wg, wo, *, act="swiglu",
                              keep=None, slot=None):
    from repro_torch.kernels.ref import moe_dense_plain

    return moe_dense_plain(x, router_w, wi, wg, wo, act=act)


def _plain_kernels():
    """Every LM kernel wrapper swapped for its plain version: the prefill
    attention (K11), the SSD scan (K9, which ``ssd_learners`` calls), the
    decode attention (K7) and the fused dense MoE (K10, one model's and
    the learner-batched call of training)."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels.ref import (flash_attention_plain,
                                         moe_dense_plain, ssd_plain)

    stack = ExitStack()
    for mod, name, plain in ((FA, "flash_attention", flash_attention_plain),
                             (SSD, "ssd", ssd_plain),
                             (DA, "decode_attention",
                              DA.decode_attention_ref),
                             (MD, "moe_dense", moe_dense_plain),
                             (MD, "moe_dense_learners",
                              _moe_dense_learners_plain)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def _check_lm_against_plain(server, pending, finished):
    """The shortest request's and the 600-token request's prefill and
    first 8 decode logits, teacher-forced with their served tokens, kernel
    path vs plain path (K11 and K7 swapped for their plain versions) on
    the card, held at 2e-2."""
    def errors(rid, prompt):
        toks = finished[rid]
        got = _teacher_forced_logits(server, prompt, toks, 8)
        with _plain_kernels():
            want = _teacher_forced_logits(server, prompt, toks, 8)
        return [_norm_err(g, w)[1] for g, w in zip(got, want)]

    held = [min(pending, key=lambda r: len(r[1]))]
    held += [r for r in pending if len(r[1]) == LM_RAGGED][:1]
    for rid, prompt in held:
        errs = errors(rid, prompt)
        print(f"[lm-serve] request {rid} ({len(prompt)} prompt tokens) "
              f"teacher-forced, kernel vs plain path, normalised logits "
              f"error (tol {K1_TOL}): prefill {errs[0]:.3g}, decode steps "
              f"1-8 {[round(e, 5) for e in errs[1:]]}; served first tokens "
              f"{finished[rid][:9]}", flush=True)
        if not max(errs) <= K1_TOL:
            _fail(f"lm-serve logits disagree with the plain path: {errs}")
    worst = {r: round(max(errors(r, p)), 5) for r, p in pending[:4]}
    print(f"[lm-serve] the same check for the first 4 requests (not "
          f"held): worst per request {worst}", flush=True)


def _check_lm_preempt(server, pending, tag="lm-serve"):
    """Two requests that never share a position; request A is preempted
    after 3 waves and restored after 1: both decode bit for bit as in
    the uninterrupted run."""
    (ra, pa), (rb, pb) = pending[0], pending[1]
    if abs(len(pa) - len(pb)) < 2:      # B runs one wave ahead after the
        pb = pb[:len(pa) - 2]            # preemption: never aligned

    def run(preempt_at):
        server.reset()
        server.admit(ra, pa, 16)
        server.admit(rb, pb, 16)
        fin = []
        for i in range(40):
            if i == preempt_at:
                snap = server.preempt(ra)
                fin += server.step()
                if not server.restore(snap):
                    _fail(f"{tag}: restore found no free slot")
            fin += server.step()
            if not server.active.any():
                break
        return dict(fin)

    base, pre = run(-1), run(3)
    print(f"[{tag}] preempt -> restore: request {ra} and {rb} "
          f"bit-identical to the uninterrupted run: {base == pre}",
          flush=True)
    if base != pre or len(base) != 2:
        _fail(f"{tag}: a preempted request decoded other tokens")


def _expect_prefill_launches(tag, cfg, pending, counts):
    """K11 once per attention layer of every admission."""
    want = cfg.n_layers * len(pending)
    if counts["flash_attention"] != want:
        _fail(f"{tag}: K11 launched {counts['flash_attention']} times, "
              f"expected {cfg.n_layers} per admission = {want}")


def phase_lm_serve():
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import Server

    cfg = get_arch("smollm-360m")
    t0 = time.perf_counter()
    server = Server(cfg, slots=LM_B, max_len=LM_S, seed=SEED)
    pending = _lm_pending(cfg)
    # warm-up: one short request (cuBLAS handles and workspaces)
    server.admit(-1, pending[0][1][:64], 4)
    while server.active.any():
        server.step()
    server.reset()
    print(f"[lm-serve] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, vocab "
          f"{cfg.vocab}; prompt lengths {[len(p) for _, p in pending]}; "
          f"set-up {time.perf_counter() - t0:.1f}s", flush=True)
    finished, admit_s, wave_s, occ, dt, counts = _lm_run(server, pending,
                                                         LM_MAX_NEW)
    for name in ("decode_attention", "argmax_tokens"):
        if counts[name] <= 0:
            _fail(f"kernel {name} was never launched on the lm-serve path")
    _expect_prefill_launches("lm-serve", cfg, pending, counts)
    _lm_report("lm-serve", cfg, pending, finished, admit_s, wave_s, occ, dt,
               counts, LM_MAX_NEW)
    _check_lm_against_plain(server, pending, finished)
    _check_lm_preempt(server, pending)
    return server, pending, finished, counts


def _first_difference(server, pending, dense, paged):
    """Print how many requests decode the dense run's tokens; for the
    first that does not, the position and the dense path's top-2 logit
    margin there (teacher-forced with the dense tokens, through the
    dense cache layout of ``server``'s model and weights, which are the
    dense run's)."""
    import torch

    agree = [rid for rid in dense if dense[rid] == paged.get(rid)]
    print(f"[lm-paged] {len(agree)} of {len(dense)} requests decode the "
          f"dense run's tokens", flush=True)
    for rid, prompt in pending:
        if rid in agree:
            continue
        i = next(j for j, (a, b) in enumerate(zip(dense[rid], paged[rid]))
                 if a != b)
        logits = _teacher_forced_logits(server, prompt, dense[rid], i)[-1]
        top = torch.topk(logits, 2).values
        print(f"[lm-paged] request {rid} first differs at generated token "
              f"{i} (dense {dense[rid][i]}, paged {paged[rid][i]}); top-2 "
              f"logit margin there {float(top[0] - top[1]):.4g}",
              flush=True)
        return


def phase_lm_paged(pending, dense):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import PagedServer

    cfg = get_arch("smollm-360m")
    server = PagedServer(cfg, pool_pages=LM_POOL, page_size=LM_P,
                         max_len=LM_S, seed=SEED)
    finished, admit_s, wave_s, occ, dt, counts = _lm_run(server, pending,
                                                         LM_MAX_NEW)
    for name in ("paged_decode_attention", "argmax_tokens"):
        if counts[name] <= 0:
            _fail(f"kernel {name} was never launched on the paged path")
    _expect_prefill_launches("lm-paged", cfg, pending, counts)
    _lm_report("lm-paged", cfg, pending, finished, admit_s, wave_s, occ, dt,
               counts, LM_MAX_NEW)
    print(f"[lm-paged] pool {server.pool.n_pages} pages x {LM_P}: peak "
          f"sharing_ratio {server.peak_sharing:.3f}, cow "
          f"{server.pool.n_cow}, shared_hits {server.pool.n_shared_hits}",
          flush=True)
    if server.pool.n_shared_hits <= 0 or server.pool.pages_in_use != 0:
        _fail("lm-paged: no prefix page was shared, or pages leaked")
    _first_difference(server, pending, dense, finished)
    return counts


def phase_lm_profile(server, pending):
    """Where the LM serving time goes: 4 requests (16 new tokens each)
    under torch.profiler."""
    server.reset()
    got = _profile_window(lambda: _lm_run(server, pending[:4], 16),
                          "lm-profile")
    if got is None:
        return
    (_, _, wave_s, _, dt, _), _, busy_ms, rows = got
    print(f"[lm-profile] serve 4 requests x 16 tokens: wall {1e3 * dt:.1f} "
          f"ms, {len(wave_s)} waves, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / (1e3 * dt):.1f}%)", flush=True)
    for us, n, key in rows[:12]:
        print(f"[lm-profile]   {us / 1e3:9.2f} ms  {n:6d}x  {key[:70]}",
              flush=True)


# --------------------------------------------------------------- phase 12
# The ssm slice's serving shape: mamba2-370m's 32 heads of P = 64, state
# N = 128 in one B/C group, chunk 256; a 700-token prompt leaves a ragged
# last chunk of 188.
SSM_H, SSM_P, SSM_N, SSM_Q, SSM_S = 32, 64, 128, 256, 700
SSM_REQUESTS, SSM_MAX_NEW, SSM_RAGGED = 16, 32, 700
SSM_Y_TOL, SSM_STATE_TOL = 2e-2, 1e-4
SSM_CUT = 8              # layers of the held end-to-end logits check
PROFILE_NEW = 8          # new tokens per request in the two-window profiles


def _ssd_inputs(gen, B, S, H, P, G, N):
    import torch

    dev = torch.device("cuda")
    x = torch.randn(B, S, H, P, generator=gen).to(dev, torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen) - 2.0).to(dev)
    A = (-torch.exp(torch.rand(H, generator=gen) * 2.7)).to(dev)
    Bm = torch.randn(B, S, G, N, generator=gen).to(dev, torch.bfloat16)
    Cm = torch.randn(B, S, G, N, generator=gen).to(dev, torch.bfloat16)
    return x, dt, A, Bm, Cm


def _ssd_bytes_ops(B, S, H, P, G, N, Q):
    """Bytes an SSD call must move (x, dt, A, B, C in; y, state out) and
    the operations its chunks need, as (count, peak) pairs: per chunk of
    L rows and head, the causal pairs k <= q only (L (L + 1) / 2 of them),
    whose C.B^T scores have bf16 operands (products exact in f32: the
    bf16 tensor-core peak), L (L + 1) N; the weights times x in f32,
    L (L + 1) P; and the carried state in and out, 4 L N P f32."""
    nbytes = (2 * B * S * H * P * 2 + B * S * H * 4 + H * 4
              + 2 * B * S * G * N * 2 + B * H * N * P * 4)
    scores = f32 = 0
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        scores += B * H * L * (L + 1) * N
        f32 += B * H * (L * (L + 1) * P + 4 * L * N * P)
    return nbytes, [(scores, PEAK_BF16_FLOPS), (f32, PEAK_F32_FLOPS)]


def _ssd_launch_us(call, calls=20):
    """Device µs per call of each of K9's launches (torch.profiler)."""
    call()
    got = _profile_window(lambda: [call() for _ in range(calls)], "k9")
    if got is None:
        return {}
    out = {}
    for us, _, key in got[3]:
        label = next((n for n in ("ssd_state", "ssd_out") if n in key),
                     key[:32])
        out[label] = round(out.get(label, 0.0) + us / calls, 2)
    return out


def check_k9(gen):
    import torch

    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels.ref import ssd_plain

    worst = 0.0
    shapes = [(2, 100, 4, 32, 2, 64, 32),                   # small, G < H
              (1, SSM_S, SSM_H, SSM_P, 1, SSM_N, SSM_Q),    # mamba2-370m
              (1, HYB_S, 50, 64, 1, 16, 256)]               # hymba-1.5b
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    timed = []
    for B, S, H, P, G, N, Q in shapes:
        args = _ssd_inputs(gen, B, S, H, P, G, N)
        y, h = SSD.ssd(*args, chunk=Q)
        torch.cuda.synchronize()
        want_y, want_h = ssd_plain(*args, chunk=Q)
        (ey, ny), (eh, nh) = _norm_err(y, want_y), _norm_err(h, want_h)
        if not (ny <= SSM_Y_TOL and nh <= SSM_STATE_TOL):
            _fail(f"K9 B={B} S={S} H={H} P={P} G={G} N={N} Q={Q}: "
                  f"normalised error y {ny}, state {nh}")
        worst = max(worst, ey)
        plan = SSD.ssd_plan(B, S, H, P, G, N, min(Q, S), n_sm)
        print(f"[K9] ssd B={B} S={S} H={H} P={P} G={G} N={N} Q={Q}: y "
              f"{ny:.3g} (tol {SSM_Y_TOL}), state {nh:.3g} (tol "
              f"{SSM_STATE_TOL}) normalised, max_abs_err y {ey:.3g} state "
              f"{eh:.3g}; plan: {plan['chunks']} chunks (last "
              f"{S - (plan['chunks'] - 1) * min(Q, S)}), {plan['items']} "
              f"items, output CTAs of {plan['p_tile']} channels, scratch "
              f"{plan['scratch_bytes'] / 1e6:.2f} MB", flush=True)
        if B == 1:                                  # the serving shapes
            call = lambda: SSD.ssd(*args, chunk=Q)  # noqa: E731
            ms = _time_ms(call, 50)
            device = _device_ms(call)
            per_launch = _ssd_launch_us(call)
            plain_ms = _time_ms(lambda: ssd_plain(*args, chunk=Q), 10)
            nbytes, ops = _ssd_bytes_ops(B, S, H, P, G, N, Q)
            bound_ms, bound_by = _bound(nbytes, ops)
            # the kernel's own: each f32 product as three bf16 wgmma ones
            split_ms, _ = _bound(nbytes, [ops[0], (3 * ops[1][0],
                                                   PEAK_BF16_FLOPS)])
            print(f"[K9] B={B} S={S} (last chunk {S % Q or Q}) H={H} P={P} "
                  f"N={N} Q={Q}: kernel {ms:.4f} ms, device {_ms(device)} "
                  f"per call (launches, us: {per_launch}), plain "
                  f"{plain_ms:.4f} ms, library none, bound {bound_ms:.5f} ms "
                  f"({bound_by}: {ops[0][0] / 1e9:.3f} GFLOP bf16 scores, "
                  f"{ops[1][0] / 1e9:.3f} GFLOP f32, {nbytes / 1e6:.2f} MB); "
                  f"bound of the wgmma form (the f32 products as three bf16 "
                  f"ones at the bf16 peak) {split_ms:.5f} ms", flush=True)
            timed.append(dict(
                ms=ms, device_ms=device, launch_us=per_launch,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_wgmma_split_ms=split_ms, plan=plan,
                shape=f"B={B} S={S} H={H} P={P} G={G} N={N} Q={Q} bf16"))
    mamba, hyb = timed
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:103",
                max_abs_err=worst, library_ms=None, **mamba,
                hymba_shape=hyb)


# --------------------------------------------------------------- phase 13
def _ssm_counts():
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import ssd_scan as SSD

    return {"ssd_scan": SSD.launches, "argmax_tokens": DK.argmax_launches}


def _ssm_pending(cfg):
    """16 prompts of 64-960 tokens drawn with the seed; the first is
    forced to 700 (> 256 and not a multiple of it: a ragged chunk)."""
    import numpy as np

    from repro_torch.launch.serve import lm_requests

    lengths = np.random.default_rng(SEED).integers(64, 961,
                                                   size=SSM_REQUESTS)
    lengths[0] = SSM_RAGGED
    return lm_requests(cfg, [int(n) for n in lengths], seed=SEED)


def _ssm_run(server, pending, max_new):
    """Serve ``pending`` once with the K9 and K6 counters set to 0 just
    before and read just after."""
    import torch

    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch.serve import serve_lm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SSD.launches = DK.argmax_launches = 0
    t0 = time.perf_counter()
    finished, admit_s, wave_s, occ = serve_lm(server, pending, max_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dict(finished), admit_s, wave_s, occ, dt, _ssm_counts()


def _layer_cut(server, n_layers):
    """The served model and weights cut to their first ``n_layers``
    layers (a stand-in for ``server`` in ``_teacher_forced_logits``)."""
    import dataclasses
    from types import SimpleNamespace

    from repro_torch.models import build_model

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n_layers]

    cfg = dataclasses.replace(server.cfg, n_layers=n_layers)
    params = dict(server.params, layers=cut(server.params["layers"]))
    return SimpleNamespace(model=build_model(cfg), params=params,
                           max_len=server.max_len)


def _check_ssm_against_plain(server, pending, finished):
    """Kernel path vs plain path (the SSD wrapper swapped for
    ``ssd_plain``) on the card, for the ragged 700-token request:

    * every one of its 48 K9 launches held against ``ssd_plain`` on that
      layer's own inputs (y within 2e-2, the state within 1e-4);
    * its prefill and first 8 decode logits, teacher-forced with its
      served tokens, held at 2e-2 through the first SSM_CUT layers of the
      served model.  Not all 48: at random init the stack amplifies a
      handful of bf16 roundings of y that any two f32 SSDs make apart, so
      that past 8 layers ``ssd_plain`` and an f64 evaluation of the exact
      recurrence drift apart as well (``tools/ssd_precision.py``
      measures both by depth)."""
    from unittest import mock

    import torch

    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels.ref import ssd_plain

    rid, prompt = pending[0]
    toks = finished[rid]
    real, per_layer = SSD.ssd, []

    def both(x, dt, A, Bm, Cm, *, chunk):
        y, h = real(x, dt, A, Bm, Cm, chunk=chunk)
        py, ph = ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
        per_layer.append((_norm_err(y, py)[1], _norm_err(h, ph)[1]))
        return y, h

    with mock.patch.object(SSD, "ssd", both):
        server.model.prefill_fn(server.params, {"tokens": torch.as_tensor(
            prompt[None]).to("cuda")})
    wy, wh = max(e[0] for e in per_layer), max(e[1] for e in per_layer)
    print(f"[ssm-serve] request {rid} ({len(prompt)} prompt tokens, last "
          f"chunk {len(prompt) % SSM_Q}): each of its {len(per_layer)} K9 "
          f"launches vs ssd_plain on the layer's own inputs, worst "
          f"normalised y {wy:.3g} (tol {SSM_Y_TOL}), state {wh:.3g} (tol "
          f"{SSM_STATE_TOL})", flush=True)
    if len(per_layer) != server.cfg.n_layers or not (
            wy <= SSM_Y_TOL and wh <= SSM_STATE_TOL):
        _fail(f"ssm-serve: a K9 launch disagrees with ssd_plain on its "
              f"layer's inputs: {per_layer}")

    srv = _layer_cut(server, SSM_CUT)
    got = _teacher_forced_logits(srv, prompt, toks, 8)
    with mock.patch.object(SSD, "ssd", ssd_plain):
        want = _teacher_forced_logits(srv, prompt, toks, 8)
    cut = [_norm_err(g, w)[1] for g, w in zip(got, want)]
    print(f"[ssm-serve] teacher-forced logits through the first {SSM_CUT} "
          f"layers, kernel vs plain path, normalised (tol {SSM_Y_TOL}): "
          f"prefill {cut[0]:.3g}, decode steps 1-8 "
          f"{[round(e, 5) for e in cut[1:]]}; served first tokens "
          f"{toks[:9]}", flush=True)
    if not max(cut) <= SSM_Y_TOL:
        _fail(f"ssm-serve logits disagree with the plain path: {cut}")


def phase_ssm_serve():
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import Server

    cfg = get_arch("mamba2-370m")
    t0 = time.perf_counter()
    server = Server(cfg, slots=LM_B, max_len=LM_S, seed=SEED)
    pending = _ssm_pending(cfg)
    # warm-up: one short request (cuBLAS handles, the K9 library)
    server.admit(-1, pending[0][1][:64], 4)
    while server.active.any():
        server.step()
    server.reset()
    d_inner = cfg.ssm.expand * cfg.d_model
    print(f"[ssm-serve] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"d_inner {d_inner} as {d_inner // cfg.ssm.head_dim} heads of "
          f"{cfg.ssm.head_dim}, state {cfg.ssm.state_dim}, chunk "
          f"{cfg.ssm.chunk}, vocab {cfg.vocab}; {LM_B} slots, max_len "
          f"{LM_S}; prompt lengths {[len(p) for _, p in pending]}; set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    finished, admit_s, wave_s, occ, dt, counts = _ssm_run(server, pending,
                                                          SSM_MAX_NEW)
    want = cfg.n_layers * len(pending)
    if counts["ssd_scan"] != want:
        _fail(f"K9 launched {counts['ssd_scan']} times on the ssm-serve "
              f"path, expected {cfg.n_layers} per admission = {want}")
    if counts["argmax_tokens"] <= 0:
        _fail("kernel argmax_tokens was never launched on the ssm-serve "
              "path")
    _lm_report("ssm-serve", cfg, pending, finished, admit_s, wave_s, occ, dt,
               counts, SSM_MAX_NEW)
    _check_ssm_against_plain(server, pending, finished)
    _check_lm_preempt(server, pending, tag="ssm-serve")
    return server, pending, counts


def phase_two_window_profile(server, pending, tag):
    """Where the serving time goes: 4 requests, their admissions (prefill)
    and their decode waves (PROFILE_NEW new tokens each) profiled as two
    windows."""
    server.reset()

    def admit():
        for rid, prompt in pending[:4]:
            server.admit(rid, prompt, PROFILE_NEW)

    def decode():
        while server.active.any():
            server.step()

    pre = _profile_window(admit, tag)
    dec = pre and _profile_window(decode, tag)
    if not dec:
        return
    total = pre[1] + dec[1]
    for part, (_, wall, busy, rows) in (("prefill", pre), ("decode", dec)):
        print(f"[{tag}] {part}: wall {wall:.1f} ms "
              f"({100 * wall / total:.1f}% of the 4-request run), device "
              f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%), host-bound "
              f"rest {wall - busy:.1f} ms", flush=True)
        for us, n, key in rows[:8]:
            print(f"[{tag}]   {part} {us / 1e3:9.2f} ms  {n:6d}x  "
                  f"{key[:64]}", flush=True)


# --------------------------------------------------------------- phase 15
# The hybrid slice: the full-width hymba-1.5b Server, 8 slots of 2048
# positions (HYB_B, HYB_CACHE); the first prompt HYB_S = 1500 tokens.
HYB_REQUESTS, HYB_MAX_NEW = 16, 24
HYB_CUT = 4              # layers of the held end-to-end logits check


def _hybrid_pending(cfg):
    """16 prompts of 64-2000 tokens drawn with the seed; the first forced
    to 1500 (past the 1024-position window, a multiple of neither 512
    nor 256)."""
    import numpy as np

    from repro_torch.launch.serve import lm_requests

    lengths = np.random.default_rng(SEED).integers(64, 2001,
                                                   size=HYB_REQUESTS)
    lengths[0] = HYB_S
    return lm_requests(cfg, [int(n) for n in lengths], seed=SEED)


def _check_hybrid_against_plain(server, pending, finished):
    """Kernel path vs plain path on the card, for the 1500-token request:

    * every one of its 32 K11 launches held against
      ``flash_attention_plain`` on that layer's own q, k, v (K11_P_TOL =
      1e-2 of each row's largest value, :func:`_row_err`), and
      every K9 launch against ``ssd_plain`` (2e-2 y, 1e-4 state);
    * its prefill and first 8 decode logits, teacher-forced with its
      served tokens, every kernel swapped for its plain version, held at
      2e-2 through the first HYB_CUT layers; through all 32 the distance
      is printed, not held (random-init depth amplifies any rounding
      difference, as ``_check_ssm_against_plain`` says)."""
    from unittest import mock

    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels.ref import flash_attention_plain, ssd_plain

    rid, prompt = pending[0]
    toks = finished[rid]
    real_fa, real_ssd, attn, ssd = FA.flash_attention, SSD.ssd, [], []

    def fa_both(q, k, v, **kw):
        o = real_fa(q, k, v, **kw)
        attn.append(_row_err(o, flash_attention_plain(q, k, v, **kw))[1])
        return o

    def ssd_both(x, dt, A, Bm, Cm, *, chunk):
        y, h = real_ssd(x, dt, A, Bm, Cm, chunk=chunk)
        py, ph = ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
        ssd.append((_norm_err(y, py)[1], _norm_err(h, ph)[1]))
        return y, h

    with mock.patch.object(FA, "flash_attention", fa_both), \
            mock.patch.object(SSD, "ssd", ssd_both):
        server.model.prefill_fn(server.params, {"tokens": torch.as_tensor(
            prompt[None]).to("cuda")})
    wy, wh = max(e[0] for e in ssd), max(e[1] for e in ssd)
    print(f"[hybrid-serve] request {rid} ({len(prompt)} prompt tokens): "
          f"each of its {len(attn)} K11 launches vs flash_attention_plain "
          f"on the layer's own q/k/v, worst row-normalised {max(attn):.3g} "
          f"(tol {K11_P_TOL}; per layer {[round(e, 5) for e in attn]}); each "
          f"of its {len(ssd)} K9 launches vs ssd_plain, worst y {wy:.3g} "
          f"(tol {SSM_Y_TOL}), state {wh:.3g} (tol {SSM_STATE_TOL})",
          flush=True)
    L = server.cfg.n_layers
    if len(attn) != L or len(ssd) != L or not (
            max(attn) <= K11_P_TOL and wy <= SSM_Y_TOL
            and wh <= SSM_STATE_TOL):
        _fail(f"hybrid-serve: a K11 or K9 launch disagrees with its plain "
              f"version on its layer's inputs: {attn}, {ssd}")

    for srv, held in ((_layer_cut(server, HYB_CUT), True), (server, False)):
        got = _teacher_forced_logits(srv, prompt, toks, 8)
        with _plain_kernels():
            want = _teacher_forced_logits(srv, prompt, toks, 8)
        errs = [_norm_err(g, w)[1] for g, w in zip(got, want)]
        n = srv.model.cfg.n_layers
        print(f"[hybrid-serve] teacher-forced logits through {n} layers, "
              f"kernel vs plain path, normalised: prefill {errs[0]:.3g}, "
              f"decode steps 1-8 {[round(e, 5) for e in errs[1:]]} "
              f"({'held at ' + str(K1_TOL) if held else 'not held'}); "
              f"served first tokens {toks[:9]}", flush=True)
        if held and not max(errs) <= K1_TOL:
            _fail(f"hybrid-serve logits disagree with the plain path "
                  f"through {n} layers: {errs}")


def phase_hybrid_serve():
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import Server

    cfg = get_arch("hymba-1.5b")
    t0 = time.perf_counter()
    server = Server(cfg, slots=HYB_B, max_len=HYB_CACHE, seed=SEED)
    pending = _hybrid_pending(cfg)
    # warm-up: one short request (cuBLAS handles, the kernel libraries)
    server.admit(-1, pending[0][1][:64], 4)
    while server.active.any():
        server.step()
    server.reset()
    d_inner = cfg.ssm.expand * cfg.d_model
    print(f"[hybrid-serve] {cfg.name}: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
          f"heads, window {cfg.window} (global layers "
          f"{cfg.global_attn_layers}), SSM d_inner {d_inner} as "
          f"{d_inner // cfg.ssm.head_dim} heads of {cfg.ssm.head_dim}, state "
          f"{cfg.ssm.state_dim}, vocab {cfg.vocab}; {HYB_B} slots, max_len "
          f"{HYB_CACHE}, {HYB_MAX_NEW} new tokens; prompt lengths "
          f"{[len(p) for _, p in pending]}; set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    finished, admit_s, wave_s, occ, dt, counts = _lm_run(server, pending,
                                                         HYB_MAX_NEW)
    calls = counts["decode_attention"] // cfg.n_layers
    for name, want in (("flash_attention", cfg.n_layers * len(pending)),
                       ("ssd_scan", cfg.n_layers * len(pending)),
                       ("decode_attention", cfg.n_layers * calls),
                       ("argmax_tokens", calls + len(pending))):
        if counts[name] != want or not calls:
            _fail(f"hybrid-serve: {name} launched {counts[name]} times, "
                  f"expected {want} ({len(pending)} admissions, {calls} "
                  f"decode calls)")
    _lm_report("hybrid-serve", cfg, pending, finished, admit_s, wave_s, occ,
               dt, counts, HYB_MAX_NEW)
    print(f"[hybrid-serve] {calls} decode calls; the {HYB_S}-token "
          f"request's admission (prefill + first token) "
          f"{1e3 * admit_s[0]:.2f} ms", flush=True)
    _check_hybrid_against_plain(server, pending, finished)
    _check_lm_preempt(server, pending, tag="hybrid-serve")
    return server, pending, counts


# --------------------------------------------------------------- phase 17
# The MoE slice: granite-moe-3b-a800m's FFN, d 1536, 40 experts of d_ff
# 512, top-8 under the dense router (K10 port).
MOE_D, MOE_E, MOE_F, MOE_K = 1536, 40, 512, 8
K10_TOL = 2e-2           # a token row's bf16 output rounding
MOE_NEVER = 17           # the expert the "never selected" case leaves out
K10_ROWS = (0, 63, 64, 345, 699)   # rows launched alone at T = 1
K10_CASES = [
    # tag, T, d, E, f, top-k, act, router weights, timed
    ("T=1", 1, MOE_D, MOE_E, MOE_F, MOE_K, "swiglu", "topk", True),
    ("T=8 decode", 8, MOE_D, MOE_E, MOE_F, MOE_K, "swiglu", "topk", True),
    ("T=700 prefill", 700, MOE_D, MOE_E, MOE_F, MOE_K, "swiglu", "topk",
     True),
    ("T=1500", 1500, MOE_D, MOE_E, MOE_F, MOE_K, "swiglu", "topk", False),
    ("gelu small", 37, 256, 4, 128, 2, "gelu", "topk", False),
    ("every weight non-zero", 64, MOE_D, MOE_E, MOE_F, MOE_K, "swiglu",
     "all", False),
    ("one expert never selected", 300, MOE_D, MOE_E, MOE_F, MOE_K,
     "swiglu", "skip", False),
    ("a token with no weight", 37, MOE_D, MOE_E, MOE_F, MOE_K, "swiglu",
     "zero_row", False),
    ("T=1 experts 32-39", 1, MOE_D, MOE_E, MOE_F, MOE_K, "swiglu", "last8",
     False),
]
MOE_REQUESTS, MOE_MAX_NEW, MOE_RAGGED = 16, 24, 700
MOE_CUT = 4              # layers of the held end-to-end logits check


def _moe_weights(gen, d, E, f):
    """wi/wg (E, d, f) and wo (E, f, d) bf16 on the card at the model's
    init scales (1/sqrt of the contracted axis)."""
    import torch

    def r(*shape, fan):
        return (torch.randn(*shape, generator=gen) / fan ** 0.5).to(
            "cuda", torch.bfloat16)
    return r(E, d, f, fan=d), r(E, d, f, fan=d), r(E, f, d, fan=f)


def _router_weights(gen, T, E, k, mode):
    """(T, E) f32 combine weights: the renormalised top-k of a softmax
    ("topk"), with expert MOE_NEVER never among them ("skip"), drawn only
    from experts E - 8 .. E - 1 ("last8"), with token T // 2's row all
    zero ("zero_row"), or the whole softmax, every weight non-zero
    ("all")."""
    import torch

    logits = torch.randn(T, E, generator=gen)
    if mode == "skip":
        logits[:, MOE_NEVER] = -float("inf")
    if mode == "last8":
        logits[:, :E - 8] = -float("inf")
    probs = torch.softmax(logits, dim=-1)
    if mode != "all":
        top, idx = torch.topk(probs, k, dim=-1)
        probs = torch.zeros_like(probs).scatter_(
            -1, idx, top / top.sum(-1, keepdim=True))
    if mode == "zero_row":
        probs[T // 2] = 0.0
    return probs.to("cuda")


def _moe_bytes_ops(w, d, f):
    """What this call's router weights w (T, E) need: x and w in, y out,
    and wi, wg, wo of every expert that some token weights (an expert
    with no non-zero weight adds nothing to y); 2 x 3 d f operations per
    non-zero (token, expert) weight, bf16 products at the bf16 peak."""
    T, E = w.shape
    nz = w != 0
    experts = int(nz.any(dim=0).sum())
    nbytes = 2 * T * d + 4 * T * E + 2 * 3 * experts * d * f + 2 * T * d
    return nbytes, 6 * int(nz.sum()) * d * f, experts


def _moe_yardstick(x, w, wi, wg, wo):
    """A library yardstick, not one call that computes the function (used
    nowhere in the port): three torch.bmm over the expert axis (the
    (E, T, f) hidden in device memory) and the elementwise ops."""
    import torch

    def call():
        xb = x.expand(wi.shape[0], *x.shape)
        h = torch.bmm(xb, wi)
        a = torch.nn.functional.silu(torch.bmm(xb, wg)) * h
        ye = torch.bmm(a, wo)
        return (ye.float() * w.T[:, :, None]).sum(0).to(x.dtype)
    return call


def check_k10(gen):
    """K10 against ``moe_dense_plain`` at every case of K10_CASES (2e-2 of
    each token row's largest value, :func:`_row_err`; every value finite);
    the work list its first launch builds on the card equal to
    ``moe_dense.work_list``'s, field by field; a token with no weight an
    exact 0 row; 5 rows of the T = 700 call launched alone at T = 1
    bit-identical to the same rows of the big call; the check must reject
    the plain version without the last expert; T = 1, 8 and 700 timed
    beside their plain version, their bound and a three-bmm yardstick."""
    import torch

    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels.ref import moe_dense_plain

    full = _moe_weights(gen, MOE_D, MOE_E, MOE_F)
    worst, rows = 0.0, {}
    for tag, T, d, E, f, k, act, mode, timed in K10_CASES:
        wi, wg, wo = full if (d, E, f) == (MOE_D, MOE_E, MOE_F) else \
            _moe_weights(gen, d, E, f)
        x = torch.randn(T, d, generator=gen).to("cuda", torch.bfloat16)
        w = _router_weights(gen, T, E, k, mode)
        before = MD.launches
        got = MD.moe_dense(x, w, wi, wg, wo, act=act)
        torch.cuda.synchronize()
        if MD.launches != before + 1:
            _fail(f"K10 {tag}: the wrapper did not launch the kernel")
        want = moe_dense_plain(x, w, wi, wg, wo, act=act)
        abs_err, norm = _row_err(got, want)
        if not (norm <= K10_TOL and bool(torch.isfinite(got).all())):
            _fail(f"K10 {tag}: row-normalised error {norm} (tol {K10_TOL}), "
                  f"or a value that is not finite")
        worst = max(worst, abs_err)
        plain_list = MD.work_list(w.cpu())
        dev_list = MD.device_work_list(w, d)
        diff = [name for name, a, b in zip(plain_list._fields, plain_list,
                                           dev_list) if not torch.equal(a, b)]
        if diff:
            _fail(f"K10 {tag}: the device's work list differs from "
                  f"work_list's in {diff}")
        plan = MD.launch_plan(T, d, E, f)
        line = (f"[K10] {tag}: T={T} d={d} E={E} f={f} top-{k} {act} "
                f"({mode} weights; {plan['regime']}: "
                f"{len(plain_list.items)} items of <= {plan['item_rows']} "
                f"rows over {plan['clusters']} clusters of "
                f"{plan['cluster']} CTAs = {plan['ctas']} CTAs, "
                f"{plan['hidden_per_cta']} hidden and "
                f"{plan['out_per_cta']} output columns a CTA, "
                f"{int(plain_list.counts.gt(0).sum())} experts used, "
                f"{len(plain_list.pair_tok)} pairs, slot bytes "
                f"{4 * d * len(plain_list.pair_tok)} used of "
                f"{plan['slot_bytes']}; device work list = work_list's): "
                f"row-normalised error {norm:.3g} (tol {K10_TOL}; "
                f"tensor-normalised {_norm_err(got, want)[1]:.3g}), "
                f"max_abs_err {abs_err:.3g}")
        if mode == "zero_row":
            zero_ok = torch.equal(got[T // 2], torch.zeros_like(got[T // 2]))
            line += f"; the weightless token's row exactly 0: {zero_ok}"
            if not zero_ok:
                _fail(f"K10 {tag}: token {T // 2} has no weight but its row "
                      f"is not 0")
        if T == 700:
            alone = [torch.equal(MD.moe_dense(x[r:r + 1], w[r:r + 1], wi, wg,
                                              wo, act=act), got[r:r + 1])
                     for r in K10_ROWS]
            # and rows 0-7 as one decode call of 8 (8 items, 16-row tiles)
            alone.append(torch.equal(MD.moe_dense(x[:8], w[:8], wi, wg, wo,
                                                  act=act), got[:8]))
            short = moe_dense_plain(x, w[:, :-1], wi[:-1], wg[:-1], wo[:-1],
                                    act=act)
            seen = _row_err(short, want)[1]
            line += (f"; rows {K10_ROWS} launched alone at T=1, and rows "
                     f"0-7 as one T=8 call, bit-identical: {alone}; the "
                     f"plain version without "
                     f"the last expert: row-normalised {seen:.3g}")
            if not all(alone):
                _fail(f"K10 {tag}: a row launched alone differs from the "
                      f"same row of the T={T} call: {alone}")
            if not seen > K10_TOL:
                _fail(f"K10 {tag}: the check cannot tell a missing expert "
                      f"({seen} <= {K10_TOL})")
        if timed:
            call = lambda: MD.moe_dense(x, w, wi, wg, wo, act=act)  # noqa
            ms, dev_ms = _time_ms(call, 50), _device_ms(call, iters=20)
            plain_ms = _time_ms(
                lambda: moe_dense_plain(x, w, wi, wg, wo, act=act), 5)
            yard = _moe_yardstick(x, w, wi, wg, wo)
            yard_ms, yard_dev = _time_ms(yard, 20), _device_ms(yard, iters=10)
            nbytes, ops, used = _moe_bytes_ops(w, d, f)
            bound_ms, bound_by = _bound(nbytes, ops, PEAK_BF16_FLOPS)
            rows[T] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           library_ms=None, yardstick_ms=yard_ms,
                           yardstick_device_ms=yard_dev,
                           yardstick="3 torch.bmm + elementwise (not one "
                                     "call)",
                           bound_ms=bound_ms, bound_by=bound_by,
                           shape=f"T={T} d={d} E={E} f={f} top-{k} bf16")
            line += (f"; kernel {ms:.4f} ms eager, graph-replayed per launch "
                     f"{_ms(dev_ms)}, plain {plain_ms:.4f} ms, yardstick "
                     f"(3 bmm + elementwise, not one call) {yard_ms:.4f} ms "
                     f"eager, {_ms(yard_dev)} graph-replayed, bound "
                     f"{bound_ms:.5f} ms ({bound_by}: {ops / 1e9:.3f} GFLOP "
                     f"of the non-zero weights, {nbytes / 1e6:.2f} MB with "
                     f"the {used} of {E} experts some token weights), "
                     f"roofline share "
                     f"{bound_ms / (dev_ms or ms):.3f}")
        print(line, flush=True)
    extra = {f"{k}_decode": v for k, v in rows[8].items()}
    extra.update({f"{k}_t1": v for k, v in rows[1].items()})
    return dict(name="moe_dense", route="cuda",
                source="src/repro_torch/kernels/csrc/moe_dense.cu",
                replaces="src/repro/kernels/moe_dense.py:72",
                max_abs_err=worst, **rows[700], **extra)


# --------------------------------------------------------------- phase 18
def _moe_pending(cfg):
    """16 prompts of 64-960 tokens drawn with the seed, sharing a 64-token
    prefix; the first forced to 700 (no multiple of 64: a ragged K10 and
    K11 tile)."""
    import numpy as np

    from repro_torch.launch.serve import lm_requests

    lengths = np.random.default_rng(SEED).integers(64, 961,
                                                   size=MOE_REQUESTS)
    lengths[0] = MOE_RAGGED
    return lm_requests(cfg, [int(n) for n in lengths],
                       shared_prefix=LM_SHARED, seed=SEED)


def _moe_counts():
    from repro_torch.kernels import moe_dense as MD

    return dict(_lm_counts(), moe_dense=MD.launches)


def _moe_run(server, pending, max_new):
    """``_lm_run`` with the K10 counter set to 0 as well."""
    from repro_torch.kernels import moe_dense as MD

    MD.launches = 0
    finished, admit_s, wave_s, occ, dt, _ = _lm_run(server, pending, max_new)
    return finished, admit_s, wave_s, occ, dt, _moe_counts()


def _expect_moe_launches(tag, cfg, pending, counts, decode_kernel):
    """K10 once per layer of every admission and of every decode call, K11
    once per layer of every admission, the decode kernel once per layer
    of every decode call, K6 once per admission and per decode call.
    Returns the number of decode calls."""
    L, n = cfg.n_layers, len(pending)
    calls = counts[decode_kernel] // L
    for name, want in (("moe_dense", L * (n + calls)),
                       ("flash_attention", L * n),
                       (decode_kernel, L * calls),
                       ("argmax_tokens", calls + n)):
        if counts[name] != want or not calls:
            _fail(f"{tag}: {name} launched {counts[name]} times, expected "
                  f"{want} ({n} admissions, {calls} decode calls)")
    return calls


def _route_recorder(log):
    """A stand-in for ``moe.route`` that records each call's (probs, top-k
    indices)."""
    from repro_torch.models import moe as M

    real = M.route

    def record(cfg, p, xg):
        probs, top_w, top_idx = real(cfg, p, xg)
        log.append((probs.reshape(-1, probs.shape[-1]),
                    top_idx.reshape(-1, top_idx.shape[-1])))
        return probs, top_w, top_idx
    return record


def _selection_changes(got, want, k):
    """(top-k sets that differ, sets compared, the smallest margin between
    the k-th and (k+1)-th probability of the kernel path among them)."""
    import torch

    differ, total, margin = 0, 0, None
    for (pg, ig), (_, iw) in zip(got, want):
        bad = (ig.sort(-1).values != iw.sort(-1).values).any(-1)
        total += len(bad)
        differ += int(bad.sum())
        if bad.any():
            top = torch.topk(pg[bad], k + 1, dim=-1).values
            m = float((top[:, k - 1] - top[:, k]).min())
            margin = m if margin is None else min(margin, m)
    return differ, total, margin


def _check_moe_against_plain(server, pending, finished):
    """Kernel path vs plain path on the card, for the 700-token request:

    * every one of its 32 K10 launches held against ``moe_dense_plain`` on
      that layer's own inputs (2e-2 of each token row's largest value);
    * its prefill and first 8 decode logits, teacher-forced with its
      served tokens, every kernel swapped for its plain version, held at
      2e-2 through the first MOE_CUT layers; through all 32 the distance
      is printed, not held (random-init depth amplifies any rounding
      difference, and a top-8 selection that flips moves a token's FFN by
      a whole expert), with the number of top-8 selections that differ
      between the two paths and the smallest router margin among them."""
    from unittest import mock

    import torch

    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels.ref import moe_dense_plain
    from repro_torch.models import moe as M

    rid, prompt = pending[0]
    toks = finished[rid]
    real, errs = MD.moe_dense, []

    def both(x, w, wi, wg, wo, *, act):
        y = real(x, w, wi, wg, wo, act=act)
        errs.append(_row_err(y, moe_dense_plain(x, w, wi, wg, wo,
                                                act=act))[1])
        return y

    with mock.patch.object(MD, "moe_dense", both):
        server.model.prefill_fn(server.params, {"tokens": torch.as_tensor(
            prompt[None]).to("cuda")})
    print(f"[moe-serve] request {rid} ({len(prompt)} prompt tokens): each "
          f"of its {len(errs)} K10 launches vs moe_dense_plain on the "
          f"layer's own inputs, worst row-normalised {max(errs):.3g} (tol "
          f"{K10_TOL}; per layer {[round(e, 5) for e in errs]})", flush=True)
    if len(errs) != server.cfg.n_layers or not max(errs) <= K10_TOL:
        _fail(f"moe-serve: a K10 launch disagrees with moe_dense_plain on "
              f"its layer's inputs: {errs}")

    k = server.cfg.moe.top_k
    for srv, held in ((_layer_cut(server, MOE_CUT), True), (server, False)):
        got_r, want_r = [], []
        with mock.patch.object(M, "route", _route_recorder(got_r)):
            got = _teacher_forced_logits(srv, prompt, toks, 8)
        with _plain_kernels(), mock.patch.object(M, "route",
                                                 _route_recorder(want_r)):
            want = _teacher_forced_logits(srv, prompt, toks, 8)
        errs = [_norm_err(g, w)[1] for g, w in zip(got, want)]
        differ, total, margin = _selection_changes(got_r, want_r, k)
        n = srv.model.cfg.n_layers
        print(f"[moe-serve] teacher-forced logits through {n} layers, "
              f"kernel vs plain path, normalised: prefill {errs[0]:.3g}, "
              f"decode steps 1-8 {[round(e, 5) for e in errs[1:]]} "
              f"({'held at ' + str(K1_TOL) if held else 'not held'}); "
              f"top-{k} selections that differ: {differ} of {total} "
              f"(token, layer) pairs, smallest margin among them "
              f"{'none' if margin is None else f'{margin:.3g}'}; served "
              f"first tokens {toks[:9]}", flush=True)
        if held and not max(errs) <= K1_TOL:
            _fail(f"moe-serve logits disagree with the plain path through "
                  f"{n} layers: {errs}")


def phase_moe_serve():
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import Server

    cfg = get_arch("granite-moe-3b-a800m")
    t0 = time.perf_counter()
    server = Server(cfg, slots=LM_B, max_len=LM_S, seed=SEED)
    pending = _moe_pending(cfg)
    # warm-up: one short request (cuBLAS handles, the kernel libraries)
    server.admit(-1, pending[0][1][:64], 4)
    while server.active.any():
        server.step()
    server.reset()
    m = cfg.moe
    print(f"[moe-serve] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, "
          f"{m.num_experts} experts of d_ff {m.d_ff_expert}, top-{m.top_k} "
          f"({m.router_impl} router), vocab {cfg.vocab}; {LM_B} slots, "
          f"max_len {LM_S}, {MOE_MAX_NEW} new tokens; prompt lengths "
          f"{[len(p) for _, p in pending]}; set-up "
          f"{time.perf_counter() - t0:.1f}s (weights drawn on the card)",
          flush=True)
    finished, admit_s, wave_s, occ, dt, counts = _moe_run(server, pending,
                                                          MOE_MAX_NEW)
    calls = _expect_moe_launches("moe-serve", cfg, pending, counts,
                                 "decode_attention")
    _lm_report("moe-serve", cfg, pending, finished, admit_s, wave_s, occ, dt,
               counts, MOE_MAX_NEW)
    print(f"[moe-serve] {calls} decode calls; the {MOE_RAGGED}-token "
          f"request's admission (prefill + first token) "
          f"{1e3 * admit_s[0]:.2f} ms", flush=True)
    _check_moe_against_plain(server, pending, finished)
    _check_lm_preempt(server, pending, tag="moe-serve")
    return server, pending, finished, counts


def phase_moe_paged(pending, dense):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import PagedServer

    cfg = get_arch("granite-moe-3b-a800m")
    server = PagedServer(cfg, pool_pages=LM_POOL, page_size=LM_P,
                         max_len=LM_S, seed=SEED)
    finished, admit_s, wave_s, occ, dt, counts = _moe_run(server, pending,
                                                          MOE_MAX_NEW)
    _expect_moe_launches("moe-paged", cfg, pending, counts,
                         "paged_decode_attention")
    _lm_report("moe-paged", cfg, pending, finished, admit_s, wave_s, occ, dt,
               counts, MOE_MAX_NEW)
    print(f"[moe-paged] pool {server.pool.n_pages} pages x {LM_P}: peak "
          f"sharing_ratio {server.peak_sharing:.3f}, cow "
          f"{server.pool.n_cow}, shared_hits {server.pool.n_shared_hits}",
          flush=True)
    if server.pool.pages_in_use != 0:
        _fail("moe-paged: pages leaked")
    agree = [rid for rid in dense if dense[rid] == finished.get(rid)]
    print(f"[moe-paged] {len(agree)} of {len(dense)} requests decode the "
          f"dense run's tokens", flush=True)
    return counts


# ---------------------------------------------------------------- phase 21
LOAD_ASR = ["--arch", "swb2000-blstm", "--slots", "4", "--max-len", "256",
            "--chunk-frames", "8", "--len-median", "120", "--len-sigma",
            "0.5", "--patience", "1.0", "--deadline", "2.0"]
LOAD_ASR_WALL = ["--qps", "8", "--horizon", "3"]
LOAD_HORIZON = 2.0        # virtual seconds of the capacity probes, overload
LOAD_P99 = 0.25           # first-token p99 target of the capacity search, s
LOAD_LM = ["--arch", "smollm-360m", "--cache", "paged", "--page-size", "16",
           "--max-len", "1024", "--slots", "8", "--max-new", "32",
           "--len-median", "300", "--len-sigma", "0.6", "--qps", "4",
           "--horizon", "2.5", "--wall"]
LOAD_TRAIN = ["--arch", "swb2000-blstm", "--strategy", "ad_psgd",
              "--learners", "16", "--batch", "256", "--var-len", "--steps",
              "2", "--log-every", "1", "--trace-deterministic"]


def _load_counts():
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import lstm_cell as LC

    counts = _lm_counts()
    counts.update(blstm_stack=LC.stack_launches, blstm_layer=LC.launches,
                  beam_frame_step=DK.launches)
    return counts


def _zero_load_counts():
    _zero_counts()
    _zero_lm_counts()


def _load_cli(tag, argv, loops=None):
    """One run of ``launch.load.main`` with the launch counters set to 0
    just before and read just after; the CSV rows as a dict, the
    counts, and the printed lines (echoed with ``tag``).  ``loops``
    collects the run's ServingLoop, checking priority inversion after
    every pump."""
    import torch

    from repro_torch.launch import load as TL
    from repro_torch.serving import ServingLoop

    class Checked(ServingLoop):
        def __init__(self, *a, **kw):
            super().__init__(*a, check_inversion=True, **kw)
            loops.append(self)

    torch.cuda.synchronize()
    _zero_load_counts()
    t0 = time.perf_counter()
    try:
        if loops is not None:
            TL.ServingLoop = Checked
        rc, text = _io_run(TL.main, argv)
    finally:
        TL.ServingLoop = ServingLoop
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _load_counts()
    if rc != 0:
        _fail(f"{tag}: launch.load exited {rc}:\n{text}")
    rows = {}
    for line in text.splitlines():
        parts = line.split(",", 2)
        if len(parts) == 3 and parts[0] != "name":
            rows[parts[0]] = float(parts[1])
    print("\n".join(f"[{tag}] {l}" for l in text.splitlines()
                    if l.startswith(("[load]", "load/", "calib/",
                                     "trace:"))), flush=True)
    print(f"[{tag}] {dt:.2f}s wall; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return rows, counts, text


def _check_asr_launches(tag, rows, counts, chunk=8):
    """K4 once per first admission (every admitted request finishes),
    K5 once per frame of every wave, K1 never."""
    want = {"blstm_stack": int(rows["load/done"]),
            "beam_frame_step": chunk * int(rows["load/waves"]),
            "blstm_layer": 0}
    got = {k: counts[k] for k in want}
    if got != want or want["blstm_stack"] <= 0:
        _fail(f"{tag}: launches {got}, expected {want}")
    if rows["load/offered"] != (rows["load/done"] + rows["load/abandoned"]
                                + rows["load/rejected"]):
        _fail(f"{tag}: done + abandoned + rejected != offered: {rows}")


def _load_capacity(calib):
    """sustained_capacity in virtual time at the calibrated costs over one
    full-width AsrServer (reset between probes), the launches counted
    per probe through the server's own calls."""
    import argparse

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import load as TL
    from repro_torch.launch.serve import AsrServer
    from repro_torch.serving import (CostModel, make_payload,
                                     sustained_capacity)

    cfg = get_arch("swb2000-blstm")
    server = AsrServer(cfg, slots=4, max_frames=256, chunk=8, seed=SEED)
    calls = {"admit": 0, "wave": 0}
    submit, step_wave = server.submit, server.step_wave

    def counted_submit(req, payload):
        res = submit(req, payload)
        calls["admit"] += bool(res)
        return res

    def counted_wave():
        calls["wave"] += 1
        return step_wave()

    server.submit, server.step_wave = counted_submit, counted_wave
    args = argparse.Namespace(
        qps=1.0, horizon=LOAD_HORIZON, seed=SEED, tier_probs="0.25,0.75",
        len_median=120.0, len_sigma=0.5, max_len=256, diurnal_amp=0.0,
        diurnal_period=60.0, patience=1.0, deadline=2.0, max_new=8)
    workload = TL.build_workload(args, "asr")
    cost = CostModel(admit_s=calib["calib/admit_ms"] * 1e-3,
                     wave_base_s=calib["calib/wave_ms"] * 1e-3,
                     per_work_s=calib["calib/work_us"] * 1e-6)
    payload = lambda req: make_payload(req, mode="asr",
                                       input_dim=cfg.input_dim, seed=SEED)
    torch.cuda.synchronize()
    _zero_load_counts()
    t0 = time.perf_counter()
    qps, best = sustained_capacity(server, workload, payload,
                                   p99_target_s=LOAD_P99, qps_lo=1.0,
                                   qps_hi=64.0, iters=3, cost=cost)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _load_counts()
    want = {"blstm_stack": calls["admit"],
            "beam_frame_step": 8 * calls["wave"], "blstm_layer": 0}
    got = {k: counts[k] for k in want}
    print(f"[load-capacity] max sustained {qps:.6g} qps at first-token "
          f"p99 {1e3 * best['first_token']['p99']:.3f} ms (target "
          f"{1e3 * LOAD_P99:.0f} ms; {best['done']} of {best['offered']} "
          f"done, {best['abandoned']} abandoned, {best['waves']} waves, "
          f"virtual {best['virtual_s']:.3f}s); cost admit "
          f"{calib['calib/admit_ms']:.4f} ms, wave "
          f"{calib['calib/wave_ms']:.4f} ms + {calib['calib/work_us']:.4f} "
          f"us/frame; 5 probes in {dt:.2f}s wall, launches {got}",
          flush=True)
    if got != want or want["blstm_stack"] <= 0:
        _fail(f"load-capacity: launches {got}, expected {want}")
    if not qps > 0:
        _fail("load-capacity: even 1 qps misses the first-token target")
    return qps, cost, counts


def _add_counts(total, counts, names):
    for name in names:
        total[name] = total.get(name, 0) + counts[name]


def phase_load():
    """Phase 21: the serving layer under load and the observability layer
    at full width (module docstring)."""
    import tempfile

    import torch

    from repro_torch import obs
    from repro_torch.launch import obsreport
    from repro_torch.launch import train as TR

    asr = ("blstm_stack", "beam_frame_step")
    lm = ("flash_attention", "paged_decode_attention", "argmax_tokens")
    load = {}
    torch.cuda.empty_cache()
    # (a) full-width ASR, wall time, calibrated
    rows, counts, _ = _load_cli("load-asr-wall",
                                LOAD_ASR + LOAD_ASR_WALL
                                + ["--wall", "--calibrate"])
    _check_asr_launches("load-asr-wall", rows, counts)
    _add_counts(load, counts, asr)
    calib = {k: v for k, v in rows.items() if k.startswith("calib/")}
    if not all(v == v and v >= 0 for v in calib.values()) or \
            calib.get("calib/n_waves", 0) <= 0:
        _fail(f"load-asr-wall: calibration rows {calib}")
    # (b) the capacity search in virtual time at the calibrated costs
    qps, cost, counts = _load_capacity(calib)
    _add_counts(load, counts, asr)
    # (c) an overload at twice that rate, deterministic trace, twice
    over = LOAD_ASR + [
        "--qps", repr(2 * qps), "--horizon", repr(LOAD_HORIZON),
        "--admit-ms", repr(cost.admit_s * 1e3),
        "--wave-ms", repr(cost.wave_base_s * 1e3),
        "--work-us", repr(cost.per_work_s * 1e6), "--trace-deterministic"]
    traces = []
    with tempfile.TemporaryDirectory() as tmp:
        for k in (1, 2):
            loops = []
            path = f"{tmp}/asr{k}.jsonl"
            rows, counts, _ = _load_cli(f"load-asr-over{k}",
                                        over + ["--trace-out", path], loops)
            _check_asr_launches(f"load-asr-over{k}", rows, counts)
            _add_counts(load, counts, asr)
            inv = loops[0].inversions
            if rows["load/preemptions"] <= 0 or inv:
                _fail(f"load-asr-over{k}: preemptions "
                      f"{rows['load/preemptions']}, inversions {inv[:4]}")
            with open(path, "rb") as f:
                traces.append(f.read())
            evs = obs.read_jsonl(path)
            if obs.validate_events(evs):
                _fail(f"load-asr-over{k}: {obs.validate_events(evs)[:4]}")
        print(f"[load-asr-over] {rows['load/offered']:.0f} offered at "
              f"{2 * qps:.6g} qps: {rows['load/preemptions']:.0f} "
              f"preemptions, no priority inversion after any pump; "
              f"deterministic traces of {len(evs)} events, "
              f"{len(traces[0])} bytes, byte-identical: "
              f"{traces[0] == traces[1]}", flush=True)
        if traces[0] != traces[1]:
            _fail("load-asr-over: the two deterministic traces differ")
        # (d) full-width smollm-360m, paged, wall time, traced
        path = f"{tmp}/lm.jsonl"
        rows, counts, _ = _load_cli("load-lm-wall",
                                    LOAD_LM + ["--trace-out", path])
        evs = obs.read_jsonl(path)
        decode_calls = sum(
            e["count"] for e in evs if e["kind"] == "metric"
            and e["name"] == "profile/call_s"
            and e["tags"]["fn"] == "serve/decode")
        done = int(rows["load/done"])
        want = {"flash_attention": 32 * done,
                "paged_decode_attention": 32 * decode_calls,
                "argmax_tokens": done + decode_calls}
        got = {k: counts[k] for k in want}
        if got != want or done <= 0:
            _fail(f"load-lm-wall: launches {got}, expected {want}")
        _add_counts(load, counts, lm)
        rep = _io_run(obsreport.main, [path])
        print("\n".join(f"[load-lm-report] {l}" for l in rep[1].splitlines()),
              flush=True)
        if rep[0] != 0 or "serve/decode" not in rep[1]:
            _fail("load-lm-wall: obsreport did not render the trace")
        # (e) the train CLI, §V setup, 2 steps, deterministic trace, twice
        train, trace_counts = [], {}
        for k in (1, 2):
            path = f"{tmp}/train{k}.jsonl"
            torch.cuda.empty_cache()
            _zero_counts()
            rc, _ = _io_run(TR.main, LOAD_TRAIN + ["--trace-out", path])
            tc = _train_counts()
            if rc is None or tc != {"blstm_layer_train": 12,
                                    "blstm_layer_bwd": 12}:
                _fail(f"load-train{k}: launches {tc}, expected 6 a step")
            _add_counts(trace_counts, tc, tc)
            with open(path, "rb") as f:
                train.append(f.read())
            steps = [json.loads(l) for l in train[-1].splitlines()
                     if b'"train/step"' in l]
            print(f"[load-train{k}] " + "; ".join(
                f"step {e['attrs']['step']} loss {e['attrs']['loss']!r} "
                f"grad_norm {e['attrs']['grad_norm']!r}" for e in steps),
                flush=True)
        print(f"[load-train] deterministic traces of {len(train[0])} "
              f"bytes, byte-identical: {train[0] == train[1]}", flush=True)
        if train[0] != train[1] or len(steps) != 2:
            _fail("load-train: the two deterministic traces differ")
    return load, trace_counts


# --------------------------------------------------------------- phase 22
# The encdec family at full width: whisper-large-v3 (32 encoder and 32
# decoder layers, d 1280, 20 heads of 64, vocab 51,866; 3.07 GB of
# weights).  8 streams of 30 s of audio (1500 stub frame embeddings each,
# whisper's 50 Hz encoder rate), the 4-token start sequence, a self cache
# of 448 positions (whisper's decoder context), 64 greedy tokens.
ED_B, ED_FRAMES, ED_CACHE, ED_NEW = 8, 1500, 448, 64
ED_CUT = 4               # encoder and decoder layers of the held check
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|> (large-v3)
ED_START = (50258, 50259, 50360, 50364)


def _encdec_cut(cfg, params, n):
    """The encdec model and weights cut to their first ``n`` encoder and
    ``n`` decoder layers."""
    import dataclasses

    from repro_torch.models import build_model

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]

    return (build_model(dataclasses.replace(cfg, n_layers=n,
                                            n_enc_layers=n)),
            dict(params, enc_layers=cut(params["enc_layers"]),
                 dec_layers=cut(params["dec_layers"])))


def _encdec_logits(model, params, frames, prompt, tokens):
    """One stream's prefill logits and one decode step's per token of
    ``tokens`` (teacher-forced), as (len(tokens) + 1, V) f32."""
    import torch

    logits, cache = model.prefill_fn(params, {"frames": frames,
                                              "tokens": prompt},
                                     cache_len=ED_CACHE)
    out = [logits[:, -1].float()]
    for i, t in enumerate(tokens):
        tok = torch.tensor([[t]], dtype=torch.int32, device=frames.device)
        logits, cache = model.decode_fn(params, cache, tok,
                                        prompt.shape[1] + i)
        out.append(logits[:, -1].float())
    return torch.cat(out)


def phase_encdec():
    """whisper-large-v3 through ``Model.prefill_fn`` / ``decode_fn`` (no
    server runs the family): 8 streams, greedy tokens by K6, with the
    counters set to 0 just before and read just after (K11 96 times per
    prefill: 32 encoder, 32 self, 32 cross; K7 64 times per decode step:
    32 self (delta) and 32 cross (canonical over the 1500 frames); K6
    once per token); every token in the vocabulary; stream 0's prefill
    and 8 teacher-forced decode logits against the plain path within 2e-2
    through ED_CUT encoder and decoder layers (printed, not held, through
    all 32)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import select_tokens
    from repro_torch.models import build_model
    from repro_torch.models import encdec as ED
    from repro_torch.params import init_params, param_bytes

    cfg = get_arch("whisper-large-v3")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = init_params(model.param_specs(), SEED, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.randn(ED_B, ED_FRAMES, cfg.d_model, generator=gen,
                         device="cuda").to(torch.bfloat16)
    prompt = torch.tensor([ED_START] * ED_B, dtype=torch.int32,
                          device="cuda")

    def run(n_new):
        """Greedy decode of every stream: (tokens per stream, seconds of
        the prefill and first token, seconds of the decode steps)."""
        t_a = time.perf_counter()
        logits, cache = model.prefill_fn(params, {"frames": frames,
                                                  "tokens": prompt},
                                         cache_len=ED_CACHE)
        toks = [select_tokens(logits[:, -1])]
        t_b = time.perf_counter()
        for i in range(n_new - 1):
            tok = torch.tensor(toks[-1], dtype=torch.int32,
                               device="cuda")[:, None]
            logits, cache = model.decode_fn(params, cache, tok,
                                            len(ED_START) + i)
            toks.append(select_tokens(logits[:, -1]))
        return [list(t) for t in zip(*toks)], t_b - t_a, \
            time.perf_counter() - t_b

    run(3)                                # warm-up: libraries, cuBLAS
    setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    streams, prefill_s, decode_s = run(ED_NEW)
    counts = _lm_counts()
    peak = torch.cuda.max_memory_allocated()
    encode_ms = _time_ms(lambda: ED.encode(cfg, params, frames), 3, 1)
    steps = ED_NEW - 1
    want = {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers,
            "decode_attention": 2 * cfg.n_layers * steps,
            "argmax_tokens": ED_NEW}
    for name, n in want.items():
        if counts[name] != n:
            _fail(f"encdec: {name} launched {counts[name]} times, expected "
                  f"{n}")
    if any(len(t) != ED_NEW or min(t) < 0 or max(t) >= cfg.vocab
           for t in streams):
        _fail("encdec: a stream decoded too few tokens, or one outside "
              "the vocabulary")
    n_tok = ED_B * ED_NEW
    print(f"[encdec] {cfg.name}: {cfg.n_enc_layers} encoder and "
          f"{cfg.n_layers} decoder layers, d {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.head_dim}, vocab {cfg.vocab}, "
          f"{param_bytes(model.param_specs())} bytes of weights; {ED_B} "
          f"streams of {ED_FRAMES} frames, prompt {list(ED_START)}, self "
          f"cache {ED_CACHE}; set-up {setup:.1f}s", flush=True)
    print(f"[encdec] encode {encode_ms:.2f} ms ({ED_B} x {ED_FRAMES} "
          f"frames), prefill + first token {1e3 * prefill_s:.2f} ms, decode "
          f"step {1e3 * decode_s / steps:.2f} ms ({steps} steps), "
          f"{n_tok / (prefill_s + decode_s):.1f} tokens/s, peak device "
          f"memory {peak / 2 ** 30:.2f} GiB; launches {counts}; stream 0 "
          f"{streams[0][:12]}", flush=True)

    fed = streams[0][:8]
    for (m, p), held in ((_encdec_cut(cfg, params, ED_CUT), True),
                         ((model, params), False)):
        got = _encdec_logits(m, p, frames[:1], prompt[:1], fed)
        with _plain_kernels():
            ref = _encdec_logits(m, p, frames[:1], prompt[:1], fed)
        errs = [_norm_err(g, w)[1] for g, w in zip(got, ref)]
        print(f"[encdec] stream 0 teacher-forced through "
              f"{m.cfg.n_enc_layers} + {m.cfg.n_layers} layers, kernel vs "
              f"plain path, normalised: prefill {errs[0]:.3g}, decode steps "
              f"1-8 {[round(e, 5) for e in errs[1:]]} "
              f"({'held at ' + str(K1_TOL) if held else 'not held'})",
              flush=True)
        if held and not max(errs) <= K1_TOL:
            _fail(f"encdec logits disagree with the plain path: {errs}")
    return counts


# --------------------------------------------------------------- phase 23
# The vlm family at full width: internvl2-2b (24 layers, d 2048, 16 heads
# over 8 KV heads of 128, vocab 92,553; 3.40 GB).  8 requests of token
# prompts (64-960 tokens drawn with the seed, a 64-token shared prefix), 8
# slots x 1024 positions, 24 new tokens; one prefill of 256 patch
# embeddings (InternVL2's tokens per 448 x 448 tile) and 64 text tokens.
VLM_REQUESTS, VLM_MAX_NEW, VLM_PATCHES, VLM_TEXT = 8, 24, 256, 64


def _vlm_logits(server, patches, text, tokens=None):
    """The prefill of ``patches`` then ``text`` (batch 1) and 8 decode
    steps fed ``tokens`` (None: the run's own greedy tokens): ((9, V) f32
    logits, the tokens fed)."""
    import torch

    logits, cache = server.model.prefill_fn(
        server.params, {"tokens": text, "patches": patches},
        cache_len=server.max_len)
    out, fed = [logits[:, -1].float()], []
    n = patches.shape[1] + text.shape[1]
    for i in range(8):
        t = tokens[i] if tokens else int(out[-1].argmax())
        fed.append(t)
        tok = torch.tensor([[t]], dtype=torch.int32, device="cuda")
        logits, cache = server.model.decode_fn(server.params, cache, tok,
                                               n + i)
        out.append(logits[:, -1].float())
    return torch.cat(out), fed


def _check_vlm_patches(server):
    """One ``Model.prefill_fn`` of VLM_PATCHES patch embeddings (the
    stub's output, drawn at the token embeddings' scale, 0.02) and
    VLM_TEXT text tokens, and 8 decode steps, kernel vs plain path
    (teacher-forced with the kernel path's greedy tokens), held at 2e-2."""
    import torch

    cfg = server.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    patches = (0.02 * torch.randn(1, VLM_PATCHES, cfg.d_model, generator=gen,
                                  device="cuda")).to(torch.bfloat16)
    text = torch.randint(0, cfg.vocab, (1, VLM_TEXT), generator=gen,
                         device="cuda", dtype=torch.int32)
    got, fed = _vlm_logits(server, patches, text)
    with _plain_kernels():
        want, _ = _vlm_logits(server, patches, text, fed)
    errs = [_norm_err(g, w)[1] for g, w in zip(got, want)]
    print(f"[vlm-serve] {VLM_PATCHES} patch embeddings + {VLM_TEXT} text "
          f"tokens through {cfg.n_layers} layers, kernel vs plain path, "
          f"normalised: prefill {errs[0]:.3g}, decode steps 1-8 "
          f"{[round(e, 5) for e in errs[1:]]} (held at {K1_TOL}); greedy "
          f"tokens {fed}", flush=True)
    if not max(errs) <= K1_TOL:
        _fail(f"vlm-serve: the patch prefill's logits disagree with the "
              f"plain path: {errs}")


def _expect_attn_launches(tag, cfg, pending, counts, decode_kernel):
    """K11 once per layer of every admission; the decode kernel once per
    layer of every decode call; K6 once per admission and per call."""
    calls = counts[decode_kernel] // cfg.n_layers
    for name, want in (("flash_attention", cfg.n_layers * len(pending)),
                       (decode_kernel, cfg.n_layers * calls),
                       ("argmax_tokens", calls + len(pending))):
        if counts[name] != want or not calls:
            _fail(f"{tag}: {name} launched {counts[name]} times, expected "
                  f"{want} ({len(pending)} admissions, {calls} decode "
                  f"calls)")
    return calls


def phase_vlm():
    """internvl2-2b's ``Server`` and ``PagedServer`` (pages of 16, the
    dense cache's bytes) over the same requests, each run with the
    counters set to 0 just before and read just after: K11 24 times per
    admission, K7 (K8 paged) 24 times per decode call, K6 once per
    admission and per call; every token in the vocabulary; the patch
    prefill held against the plain path; preempt/restore bit-identical in
    both servers."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import PagedServer, Server, lm_requests

    cfg = get_arch("internvl2-2b")
    t0 = time.perf_counter()
    server = Server(cfg, slots=LM_B, max_len=LM_S, seed=SEED)
    lengths = np.random.default_rng(SEED).integers(64, 961,
                                                   size=VLM_REQUESTS)
    pending = lm_requests(cfg, [int(n) for n in lengths],
                          shared_prefix=LM_SHARED, seed=SEED)
    server.admit(-1, pending[0][1][:64], 4)          # warm-up
    while server.active.any():
        server.step()
    server.reset()
    print(f"[vlm-serve] {cfg.name}: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
          f"heads of {cfg.head_dim}, vocab {cfg.vocab}; {LM_B} slots x "
          f"{LM_S}, {VLM_MAX_NEW} new tokens; prompt lengths "
          f"{[len(p) for _, p in pending]}; set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    finished, admit_s, wave_s, occ, dt, counts = _lm_run(server, pending,
                                                         VLM_MAX_NEW)
    calls = _expect_attn_launches("vlm-serve", cfg, pending, counts,
                                  "decode_attention")
    _lm_report("vlm-serve", cfg, pending, finished, admit_s, wave_s, occ,
               dt, counts, VLM_MAX_NEW)
    print(f"[vlm-serve] {calls} decode calls", flush=True)
    _check_vlm_patches(server)
    _check_lm_preempt(server, pending, tag="vlm-serve")
    del server
    gc.collect()
    torch.cuda.empty_cache()

    paged = PagedServer(cfg, pool_pages=LM_POOL, page_size=LM_P,
                        max_len=LM_S, seed=SEED)
    p_fin, admit_s, wave_s, occ, dt, p_counts = _lm_run(paged, pending,
                                                        VLM_MAX_NEW)
    _expect_attn_launches("vlm-paged", cfg, pending, p_counts,
                          "paged_decode_attention")
    _lm_report("vlm-paged", cfg, pending, p_fin, admit_s, wave_s, occ, dt,
               p_counts, VLM_MAX_NEW)
    agree = sum(finished[r] == p_fin.get(r) for r in finished)
    print(f"[vlm-paged] pool {paged.pool.n_pages} pages x {LM_P}: peak "
          f"sharing_ratio {paged.peak_sharing:.3f}, cow {paged.pool.n_cow}, "
          f"shared_hits {paged.pool.n_shared_hits}; {agree} of "
          f"{len(finished)} requests decode the dense run's tokens",
          flush=True)
    if paged.pool.n_shared_hits <= 0 or paged.pool.pages_in_use != 0:
        _fail("vlm-paged: no prefix page was shared, or pages leaked")
    _check_lm_preempt(paged, pending, tag="vlm-paged")
    return counts, p_counts


# --------------------------------------------------------------- phase 24
# The last three dense configs at full width, one at a time, each from an
# emptied allocator: phi3-medium-14b (28.29 GB), stablelm-12b (24.29 GB;
# E = 160), command-r-35b (60.57 GB, ~20 GB left beside it).  4 slots x
# 1024 positions, 4 requests (64-960 tokens drawn with the seed), 8 new
# tokens.
DENSE_CFGS = ("phi3-medium-14b", "stablelm-12b", "command-r-35b")
DENSE_SLOTS, DENSE_REQUESTS, DENSE_NEW = 4, 4, 8
DENSE_CUT = 4            # layers of the held logits check


def phase_dense_configs():
    """Each of DENSE_CFGS: its ``param_bytes`` and ``require_weights_fit``
    on the card; a ``Server`` serving 4 requests with the counters set to
    0 just before and read just after (K11 40 times per admission, K7 40
    times per decode call, K6 once per admission and per call); every
    token in the vocabulary; the first request's prefill and 8 decode
    logits (teacher-forced) against the plain path within 2e-2 through
    DENSE_CUT layers.  Returns the launches summed over the three."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import (Server, lm_requests,
                                          require_weights_fit)
    from repro_torch.models import build_model
    from repro_torch.params import param_bytes

    total = {}
    cap = torch.cuda.get_device_properties(0).total_memory
    for name in DENSE_CFGS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_arch(name)
        model = build_model(cfg)
        nbytes = param_bytes(model.param_specs())
        require_weights_fit(model, torch.device("cuda"))
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        server = Server(cfg, slots=DENSE_SLOTS, max_len=LM_S, seed=SEED)
        lengths = np.random.default_rng(SEED).integers(
            64, 961, size=DENSE_REQUESTS)
        pending = lm_requests(cfg, [int(n) for n in lengths], seed=SEED)
        server.admit(-1, pending[0][1][:64], 2)      # warm-up
        while server.active.any():
            server.step()
        server.reset()
        tag = f"dense-configs {name}"
        print(f"[{tag}] {cfg.n_layers} layers, d {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
              f"param_bytes {nbytes} ({nbytes / 1e9:.2f} GB) fit the card's "
              f"{cap / 1e9:.2f} GB (allocated before: {before / 2 ** 30:.2f} "
              f"GiB); prompt lengths {[len(p) for _, p in pending]}; set-up "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        finished, admit_s, wave_s, occ, dt, counts = _lm_run(
            server, pending, DENSE_NEW)
        _expect_attn_launches(tag, cfg, pending, counts, "decode_attention")
        _lm_report(tag, cfg, pending, finished, admit_s, wave_s, occ, dt,
                   counts, DENSE_NEW)
        rid, prompt = pending[0]
        cut = _layer_cut(server, DENSE_CUT)
        got = _teacher_forced_logits(cut, prompt, finished[rid], 8)
        with _plain_kernels():
            want = _teacher_forced_logits(cut, prompt, finished[rid], 8)
        errs = [_norm_err(g, w)[1] for g, w in zip(got, want)]
        print(f"[{tag}] request {rid} ({len(prompt)} prompt tokens) "
              f"teacher-forced through {DENSE_CUT} layers, kernel vs plain "
              f"path, normalised: prefill {errs[0]:.3g}, decode steps 1-8 "
              f"{[round(e, 5) for e in errs[1:]]} (held at {K1_TOL})",
              flush=True)
        if not max(errs) <= K1_TOL:
            _fail(f"{tag}: logits disagree with the plain path: {errs}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del server, cut, model
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------- phase 25
LMT_L, LMT_BATCH, LMT_S = 16, 32, 128     # smollm's ad_psgd x 16, the CLI's
LMT_WARMUP, LMT_STEPS = 2, 5              # batch max(8, 2 L), 128 positions
LMT_CUT = 4             # layers of the (c) and (d) kernel-vs-plain steps
# the kernel-vs-plain gradient tolerance of the families whose gradients
# amplify the forward's rounding: the SSD's B/C gradients reach every leaf
# upstream of a Mamba-2 block (the reference's own gradients move 0.047
# when its SSD's bf16 casts become f32; tests/test_torch_ssm_train.py
# holds the port at this too); whisper's cross-attention gradients move
# 5.7 % (relative L2) at full width between p rounded to bf16 before p·v
# (K11's, and the reference's) and an f32 p, on the CPU with no kernel
LMT_GRAD_TOL = {"ssm": 8e-2, "hybrid": 8e-2, "encdec": 8e-2}
# (d): the families' configs over 2 learners, 2 steps each
LMT_FAMILIES = ("hymba-1.5b", "internvl2-2b", "whisper-large-v3")
LMT_CLI = ["--arch", "smollm-360m", "--learners", "4", "--steps", "2",
           "--log-every", "1"]
TRAIN_LM = ("flash_attention", "ssd_scan", "moe_dense")


def _train_lm_counts():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels import ssd_scan as SSD

    return {"flash_attention": FA.launches, "ssd_scan": SSD.launches,
            "moe_dense": MD.launches}


def _zero_train_lm_counts():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels import ssd_scan as SSD

    FA.launches = SSD.launches = MD.launches = 0


def _free_all():
    """Collect what the last run left and empty the allocator."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _lm_kernels_of(cfg) -> set:
    """The kernels a training step of ``cfg`` launches."""
    fam = cfg.family
    out = set() if fam == "ssm" else {"flash_attention"}
    if fam in ("ssm", "hybrid"):
        out.add("ssd_scan")
    if fam == "moe" and cfg.moe.router_impl == "dense":
        out.add("moe_dense")
    return out


def _lm_train_run(tag, cfg, *, strategy, L, batch, steps, warmup):
    """Set up ``cfg`` on the card from an emptied allocator and take
    ``steps`` steps of ``strategy`` over L learners on the port's
    synthetic data (``batch`` x LMT_S positions), the counters set to 0
    just before and read just after; the first ``warmup`` are not timed.
    Fails on a non-finite loss or a kernel of the family never launched.
    Returns (state, meta, dataset, the run's numbers)."""
    import math

    import torch

    from repro_torch.core import strategies as ST
    from repro_torch.data import make_dataset
    from repro_torch.launch.train import run, setup_training, timing_line

    _free_all()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state, step, meta = setup_training(cfg, strategy_name=strategy,
                                       n_learners=L, seed=SEED)
    ds = make_dataset(cfg, seq_len=LMT_S, batch=batch, seed=SEED)
    torch.cuda.synchronize()
    lead = 1 if meta["strategy"].replicated else 0
    n_params = sum(w[0].numel() if lead else w.numel()
                   for w in ST._leaves(state["params"]))
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params / 1e6:.1f} M params per learner, "
          f"{meta['n_learners']} learner(s), {strategy}, batch {batch} x "
          f"{LMT_S} positions, {cfg.microbatches} microbatches, remat "
          f"{cfg.remat}; set-up {time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_train_lm_counts()
    box = [state]          # the run holds the only reference to the state
    del state
    state, _, records = run(box.pop(), step, ds, steps=steps, device=dev,
                            log_every=1, label=f"[{tag}] ")
    counts = _train_lm_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(r[3]) for r in records]
    if not all(math.isfinite(v) for v in losses):
        _fail(f"{tag}: non-finite training loss: {losses}")
    for name in _lm_kernels_of(cfg):
        if counts[name] <= 0:
            _fail(f"{tag}: kernel {name} was never launched on the training "
                  f"path")
    timed = records[warmup:]
    secs = sum(r[0] for r in timed)
    out = dict(ms=1e3 * secs / len(timed),
               tokens_s=sum(r[1] for r in timed) / secs, peak_gib=peak,
               counts=counts, steps=steps)
    print(f"[{tag}] {timing_line(records, 'tokens')}", flush=True)
    print(f"[{tag}] {len(timed)} timed steps: {out['ms']:.1f} ms/step, "
          f"{out['tokens_s']:.1f} tokens/s; launches {counts} over {steps} "
          f"steps ({ {k: v / steps for k, v in counts.items()} } per step); "
          f"peak device memory {peak:.2f} GiB; {_card_line()}", flush=True)
    return state, meta, ds, out


def _cut_layers(cfg, params, n):
    """``cfg`` and learner-stacked ``params`` cut to their first ``n``
    layers (an encdec's encoder too)."""
    import dataclasses

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:, :n].contiguous()
    changes = dict(n_layers=n)
    if cfg.n_enc_layers:
        changes["n_enc_layers"] = n
    out = {k: cut(v) if k.endswith("layers") else v
           for k, v in params.items()}
    return dataclasses.replace(cfg, **changes), out


def _lm_grad_check(tag, cfg, params, batch, L, *, metric="max"):
    """One step's per-learner losses and every gradient leaf of the
    kernel path (K11, K9 and K10 through their autograd Functions) against
    the plain path (every kernel swapped for its plain version), at
    ``params`` on one batch split over the learners: the loss relative,
    and each leaf's largest difference normalised by its plain max-abs
    (a key bias's by its query bias's) with ``metric="max"``, or with
    ``metric="l2"`` its relative L2 distance (both printed), held at
    K1_TOL (the families of LMT_GRAD_TOL at theirs).  On moe the plain pass takes
    the kernel pass's top-k selections.  The kernel launches made here
    are a check's and not counted."""
    import torch

    from repro_torch.core import strategies as ST
    from repro_torch.models import build_model

    from unittest import mock

    from repro_torch.models import moe as M

    counts = _train_lm_counts()
    dev = torch.device("cuda")
    lb = ST.split_learner_batch({k: torch.as_tensor(v).to(dev)
                                 for k, v in batch.items()}, L)
    loss_fn = build_model(cfg).loss_fn
    routes, flips = [], [0, 0]
    with mock.patch.object(M, "route_learners", _route_logger(routes)):
        loss, grads = ST._value_and_grad(loss_fn, params, lb)
    with _plain_kernels(), mock.patch.object(
            M, "route_learners", _route_replayer(routes, flips)):
        loss_w, grads_w = ST._value_and_grad(loss_fn, params, lb)
    for k, v in counts.items():           # restore the main path's counts
        setattr(_kernel_module(k), "launches", v)
    if routes:
        print(f"[{tag}] the plain pass takes the kernel pass's top-"
              f"{cfg.moe.top_k} selections ({len(routes)} router calls; "
              f"its own would differ in {flips[0]} of {flips[1]} tokens): "
              f"a flipped selection moves a whole expert's gradient",
              flush=True)
    if not torch.isfinite(loss).all():
        _fail(f"{tag}: non-finite loss in the gradient check")
    loss_err = float(((loss - loss_w).abs() / loss_w.abs()).max())
    tol = LMT_GRAD_TOL.get(cfg.family, K1_TOL)
    plain = dict(_named_leaves(grads_w))
    worst = {"max": (0.0, None), "l2": (0.0, None)}
    for key, g in _named_leaves(grads):
        if not torch.isfinite(g).all():
            _fail(f"{tag}: non-finite gradient {key}")
        w_ = plain[key].float()
        # a key bias's gradient is zero in exact arithmetic (it shifts
        # each query's scores by a constant): both are rounding noise,
        # normalised by the sibling query bias's
        scale = plain[key[:-2] + "bq"].float() if key.endswith("/bk") \
            else w_
        d = g.float() - w_
        errs = {"max": float(d.abs().max()) / (float(scale.abs().max())
                                                + 1e-8),
                "l2": float(d.norm()) / (float(scale.norm()) + 1e-8)}
        for k, e in errs.items():
            if e > worst[k][0]:
                worst[k] = (e, key)
    print(f"[{tag}] kernel vs plain path, one step over {L} learners "
          f"through {cfg.n_layers} layers: loss relative error "
          f"{loss_err:.3g} (tol {K1_TOL}); worst gradient leaf, max-abs "
          f"normalised {worst['max'][0]:.3g} ({worst['max'][1]}), relative "
          f"L2 {worst['l2'][0]:.3g} ({worst['l2'][1]}); {metric} held at "
          f"{tol}", flush=True)
    if not (loss_err <= K1_TOL and worst[metric][0] <= tol):
        _fail(f"{tag}: the kernel path's loss or gradients disagree with "
              f"the plain path")


def _route_logger(log):
    """A stand-in for ``moe.route_learners`` that records each call's
    top-k indices."""
    from repro_torch.models import moe as M

    real = M.route_learners

    def record(cfg, p, xg):
        out = real(cfg, p, xg)
        log.append(out[2])
        return out
    return record


def _route_replayer(log, flips):
    """A stand-in for ``moe.route_learners`` that takes the recorded
    calls' top-k indices in order (weights gathered from its own probs and
    renormalised, so gradients flow as through top-k), counting in
    ``flips`` the tokens whose own selection differs."""
    from repro_torch.models import moe as M

    real = M.route_learners
    calls = iter(log)

    def replay(cfg, p, xg):
        probs, _, own = real(cfg, p, xg)
        idx = next(calls)
        flips[0] += int((own.sort(-1).values != idx.sort(-1).values)
                        .any(-1).sum())
        flips[1] += own[..., 0].numel()
        top_w = probs.gather(-1, idx)
        return probs, top_w / top_w.sum(dim=-1, keepdim=True), idx
    return replay


def _kernel_module(name):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels import ssd_scan as SSD

    return {"flash_attention": FA, "ssd_scan": SSD, "moe_dense": MD}[name]


class _Spans:
    """Device time between CUDA events recorded around each call of the
    wrapped functions (the stream's clock from the first launch of a span
    to its last, gaps included), summed per name."""

    def __init__(self):
        self.events = {}

    def wrap(self, name, fn):
        import torch

        def timed(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            self.events.setdefault(name, []).append((e0, e1))
            return out
        return timed

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return {k: (sum(a.elapsed_time(b) for a, b in v), len(v))
                for k, v in self.events.items()}


def _lm_train_profile(tag, cfg, state, meta, ds, start):
    """One more step under torch.profiler (device activity): wall time,
    the device's busy share, each training kernel's device time from the
    trace, and as CUDA-event spans the plain backward of each autograd
    Function (its recompute and differentiation) and the mixer."""
    from contextlib import ExitStack
    from unittest import mock

    import torch

    from repro_torch.core import strategies as ST
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch.train import run
    from repro_torch.optim.optimizers import get_optimizer

    spans = _Spans()
    dev = torch.device("cuda")
    transport = meta["transport"]
    make_mixer = type(transport).make_mixer
    with ExitStack() as stack:
        for cls, name in ((FA._FlashAttention, "K11 plain backward"),
                          (SSD._SSD, "K9 plain backward"),
                          (MD._MoEDense, "K10 plain backward")):
            stack.enter_context(mock.patch.object(
                cls, "backward", staticmethod(spans.wrap(name,
                                                         cls.backward))))
        stack.enter_context(mock.patch.object(
            type(transport), "make_mixer",
            lambda self, n: spans.wrap("mixer", make_mixer(self, n))))
        step = ST.make_train_step(
            meta["strategy"], meta["loss_fn"], get_optimizer("sgd"),
            lambda k: 0.05, n_learners=meta["n_learners"],
            microbatches=cfg.microbatches, transport=transport)
        box = [state]
        del state
        got = _profile_window(lambda: run(box.pop(), step, ds, steps=1,
                                          device=dev, start=start), tag)
    if got is None:
        return
    (_, _, records), _, busy_ms, rows = got
    wall_ms = 1e3 * records[0][0]
    kern = {}
    for us, n, key in rows:
        for name, sub in (("K11 flash_attn_kernel", "flash_attn"),
                          ("K9 ssd_*", "ssd_"), ("K10 moe_*", "moe_")):
            if sub in key:
                t, c = kern.get(name, (0.0, 0))
                kern[name] = (t + us / 1e3, c + n)
    span = spans.ms()
    print(f"[{tag}] one {meta['strategy'].name} step: wall {wall_ms:.1f} "
          f"ms, device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}"
          f"%); {_card_line()}", flush=True)
    for name, (ms, n) in sorted(kern.items()):
        print(f"[{tag}]   {ms:9.2f} ms  {n:6d}x  {name} (device time, "
              f"trace)", flush=True)
    for name, (ms, n) in sorted(span.items()):
        print(f"[{tag}]   {ms:9.2f} ms  {n:6d}x  {name} (event span)",
              flush=True)
    for us, n, key in rows[:10]:
        print(f"[{tag}]   {us / 1e3:9.2f} ms  {n:6d}x  {key[:70]}",
              flush=True)


def _train_fn_check(tag, fn, plain, ins, gen, iters=10):
    """An autograd Function's gradients against autograd of its plain
    version on the same inputs (each input's gradient normalised by the
    plain one's max-abs, held at K1_TOL), and forward + backward timed
    through each.  Returns (worst error, ms, plain ms)."""
    import torch

    leaves = [[t.detach().clone().requires_grad_(t.is_floating_point())
               for t in ins] for _ in range(2)]
    first = fn(*leaves[0])
    first = first[0] if isinstance(first, tuple) else first
    cot = torch.randn(first.shape, generator=gen).to(first.device)

    def grads(f, ls):
        y = f(*ls)
        y = y[0] if isinstance(y, tuple) else y
        want = [t for t in ls if t.requires_grad]
        return torch.autograd.grad((y.float() * cot).sum(), want)
    got, want = grads(fn, leaves[0]), grads(plain, leaves[1])
    err = max(_norm_err(a, b)[1] for a, b in zip(got, want))
    ms = _time_ms(lambda: grads(fn, leaves[0]), iters)
    plain_ms = _time_ms(lambda: grads(plain, leaves[1]), iters)
    print(f"[{tag}] gradients vs autograd of the plain version: worst "
          f"normalised error {err:.3g} (tol {K1_TOL}); forward + backward "
          f"{ms:.3f} ms (plain {plain_ms:.3f} ms)", flush=True)
    if not err <= K1_TOL:
        _fail(f"{tag}: the autograd Function's gradients disagree with "
              f"the plain version's")
    return err, ms, plain_ms


def check_train_functions(gen, whisper_lb):
    """(f) Each autograd Function at its training shapes: K11 at
    smollm-360m's (L·B = 16 rows of 128, 15 heads over 5) and at
    whisper-large-v3's cross-attention (L·B = ``whisper_lb``, 64 tokens
    over 64 frames, 20 heads); K9 at mamba2-370m's 16 learners folded
    into 512 heads (S = 128, one row); K10 at granite-moe-3b-a800m's 4
    learners folded into 160 experts (128 tokens each, top-8).  Returns
    {kernel: {shape: (err, ms, plain ms)}}."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels.ref import (flash_attention_plain,
                                         moe_dense_plain, ssd_plain)

    _free_all()
    cuda = torch.device("cuda")

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(cuda, dtype)
    out = {"flash_attention": {}, "ssd_scan": {}, "moe_dense": {}}
    for name, B, Sq, Sk, H, KV, causal in (
            ("smollm", 16, 128, 128, 15, 5, True),
            ("whisper-cross", whisper_lb, 64, 64, 20, 20, False)):
        ins = (rnd(B, Sq, H, 64), rnd(B, Sk, KV, 64), rnd(B, Sk, KV, 64))
        out["flash_attention"][f"{name} B={B} Sq={Sq} Sk={Sk} H={H} KV={KV}"
                               ] = _train_fn_check(
            f"train-fn K11 {name}",
            lambda *a: FA.flash_attention(*a, causal=causal),
            lambda *a: flash_attention_plain(*a, causal=causal), ins, gen)
    H, P, G, N = 16 * 32, 64, 16, 128
    ins = (rnd(1, LMT_S, H, P), (0.05 + 0.1 * torch.rand(
        1, LMT_S, H, generator=gen)).to(cuda),
        (-1.0 - 15.0 * torch.rand(H, generator=gen)).to(cuda),
        rnd(1, LMT_S, G, N, scale=0.3), rnd(1, LMT_S, G, N, scale=0.3))
    out["ssd_scan"][f"mamba2 16 learners: B=1 S={LMT_S} H={H} P={P} G={G} "
                    f"N={N}"] = _train_fn_check(
        "train-fn K9 mamba2", lambda *a: SSD.ssd(*a, chunk=256),
        lambda *a: ssd_plain(*a, chunk=256), ins, gen)
    L, T, d, E, f, k = 4, LMT_S, 1536, 40, 512, 8
    ws = [rnd(L, E, *s, scale=s[0] ** -0.5) for s in ((d, f), (d, f),
                                                        (f, d))]
    p = torch.softmax(torch.randn(L, T, E, generator=gen), -1)
    top = torch.topk(p, k, -1)
    rw = (torch.zeros_like(p).scatter(-1, top.indices, top.values)
          / top.values.sum(-1, keepdim=True)).to(cuda)
    out["moe_dense"][f"granite 4 learners: T={T} d={d} E={E} f={f} top-{k}"
                     ] = _train_fn_check(
        "train-fn K10 granite", lambda *a: MD.moe_dense_learners(*a),
        lambda *a: moe_dense_plain(*a), (rnd(L, T, d), rw, *ws), gen)
    return out


def phase_lm_train(gen):
    """The transformer families' training on the card, every run from an
    emptied allocator with the counters set to 0 just before its steps and
    read just after: (a) smollm-360m at full width and depth, ad_psgd over
    16 learners (LMT_WARMUP + LMT_STEPS steps, K11 launches per step held
    to layers x microbatches x 2 with remat), one step kernel vs plain at
    full depth (each leaf's max-abs error), one more step profiled; (b)
    mamba2-370m the same, 3 steps, no check;
    (c) granite-moe-3b-a800m under sc_psgd (batch 8), 3 steps, then 4 of
    its layers over 4 learners (ad_psgd, batch 16), where K10 folds the
    learners into its experts, with its kernel-vs-plain step; (d) each of
    LMT_FAMILIES over 2 learners of its config's strategy, 2 steps, a
    kernel-vs-plain step through its first LMT_CUT layers ((c) and (d):
    each leaf's relative L2 error); (e) the train
    CLI at full width; (f) each autograd Function at its training shapes.
    Returns (the main-path launches per kernel summed over (a)-(e), (f)'s
    checks)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import main as train_main

    total = dict.fromkeys(TRAIN_LM, 0)

    def add(counts):
        for k2, v in counts.items():
            total[k2] += v

    # (a) the main path
    cfg = get_arch("smollm-360m")
    state, meta, ds, res = _lm_train_run(
        "lm-train smollm", cfg, strategy="ad_psgd", L=LMT_L,
        batch=LMT_BATCH, steps=LMT_WARMUP + LMT_STEPS, warmup=LMT_WARMUP)
    add(res["counts"])
    want = cfg.n_layers * cfg.microbatches * (2 if cfg.remat else 1)
    got = res["counts"]["flash_attention"] / res["steps"]
    print(f"[lm-train smollm] K11 launches per step {got:g} (layers "
          f"{cfg.n_layers} x microbatches {cfg.microbatches} x "
          f"{2 if cfg.remat else 1} with remat = {want})", flush=True)
    if got != want:
        _fail(f"lm-train smollm: {got} K11 launches per step, expected "
              f"{want}")
    steps = res["steps"]
    _lm_grad_check("lm-train smollm", cfg, state["prev_params"],
                   ds.batch_at(steps), LMT_L)
    _lm_train_profile("lm-train-profile", cfg, state, meta, ds, steps)
    del state
    # (b) the ssm family at full width
    cfg = get_arch("mamba2-370m")
    state, meta, ds, res = _lm_train_run(
        "lm-train mamba2", cfg, strategy="ad_psgd", L=LMT_L,
        batch=LMT_BATCH, steps=3, warmup=1)
    add(res["counts"])
    del state
    # (c) the moe family: one replica at full depth, then 4 learners
    cfg = get_arch("granite-moe-3b-a800m")
    state, meta, ds, res = _lm_train_run(
        "lm-train granite", cfg, strategy="sc_psgd", L=1, batch=8, steps=3,
        warmup=1)
    add(res["counts"])
    del state
    cut = dataclasses.replace(cfg, n_layers=LMT_CUT)
    state, meta, ds, res = _lm_train_run(
        "lm-train granite-4x4", cut, strategy="ad_psgd", L=4, batch=16,
        steps=2, warmup=1)
    add(res["counts"])
    from repro_torch.kernels import moe_dense as MD
    print(f"[lm-train granite-4x4] learner-folded expert weights: "
          f"{MD.fold_copies} layout copies, {MD.fold_bytes / 2 ** 20:.1f} "
          f"MiB over the run (each layer's copy taken once a step)",
          flush=True)
    _lm_grad_check("lm-train granite-4x4", cut, state["prev_params"],
                   ds.batch_at(2), 4, metric="l2")
    del state, meta                 # the model keeps its folded experts
    # (d) the hybrid, vlm and encdec families over 2 learners
    whisper_lb = 0
    for name in LMT_FAMILIES:
        cfg = get_arch(name)
        tag = f"lm-train {name.split('-')[0]}"
        state, meta, ds, res = _lm_train_run(
            tag, cfg, strategy=cfg.train_strategy, L=2, batch=8, steps=2,
            warmup=1)
        add(res["counts"])
        ccfg, cparams = _cut_layers(cfg, state["params"], LMT_CUT)
        del state
        _lm_grad_check(tag, ccfg, cparams, ds.batch_at(2), 2, metric="l2")
        del cparams
        if cfg.family == "encdec":
            whisper_lb = 8 // cfg.microbatches
    # (e) the train CLI at full width
    _free_all()
    _zero_train_lm_counts()
    t0 = time.perf_counter()
    res_cli, text = _io_run(train_main, LMT_CLI)
    counts = _train_lm_counts()
    add(counts)
    lines = [ln for ln in text.splitlines() if ln.startswith(("timing",
                                                              "done",
                                                              "final"))]
    for ln in lines:
        print(f"[lm-train cli] {ln}", flush=True)
    print(f"[lm-train cli] {' '.join(LMT_CLI)}: {time.perf_counter() - t0:.1f}"
          f"s, launches {counts}", flush=True)
    if counts["flash_attention"] <= 0 or not any(
            ln.startswith("timing") for ln in lines):
        _fail("lm-train cli: no K11 launch or no timing line")
    del res_cli
    # (f) each autograd Function at its training shapes
    fns = check_train_functions(gen, whisper_lb)
    _free_all()
    return total, fns


# ---------------------------------------------------------------- phase 26
# impl-dryrun: the one-direction LSTM (models/lstm.lstm_layer: K1, K1-stash,
# K2, K1-chunk and K3 launched with one direction), the public wrappers and
# the fake tensors' plain path, the dry-run's prediction against the card,
# the card's identity
UNI_B, UNI_T = 16, 21                  # the paper's batch tile and frames
UNI_TOL = 2e-2                         # bf16 forward and gradients
# the dry-run traces the plain path; the card runs the kernels.  Its
# predicted peak must lie at or above the kernel path's
# max_memory_allocated and at most this share above it, set from the
# card's first run (+2.74 %; PERF.md §3)
DRYRUN_PEAK_TOL = 0.05
DRYRUN_B, DRYRUN_S = 4, 600            # smollm's ragged serve prompt


def _uni_counts():
    from repro_torch.kernels import lstm_cell as LC

    return {"lstm_layer": LC.uni_launches,
            "lstm_layer_train": LC.uni_stash_launches,
            "lstm_layer_bwd": LC.uni_bwd_launches,
            "lstm_layer_train_chunked": LC.uni_chunk_launches,
            "lstm_layer_bwd_chunked": LC.uni_chunked_bwd_launches}


def _zero_uni_counts():
    from repro_torch.kernels import lstm_cell as LC

    LC.uni_launches = LC.uni_stash_launches = LC.uni_bwd_launches = 0
    LC.uni_chunk_launches = LC.uni_chunked_bwd_launches = 0


def _uni_main_path(gen):
    """The main path of the one-direction kernels: ``models/lstm.
    lstm_layer`` (the reference's ``lstm_layer(kernel_impl="pallas")``;
    on CUDA tensors the port's takes the kernels) at the paper's width, both directions, inference and under a gradient
    (stash; and at T = 2000 chunked), with the counts zeroed just before
    and read just after."""
    import torch

    from repro_torch.models import lstm as LS

    D, H = TRAIN_D, TRAIN_H
    ws, x, lens = _stacked_inputs(1, UNI_B, UNI_T, D, H, gen, True)
    xl, ll = x[0], lens[0]
    lws, lx, llens = _long_inputs(gen, LONG_L, LONG_ROWS, LONG_T, D, H,
                                  LONG_K)
    _zero_uni_counts()
    for d in range(2):
        p = dict(zip(("wx", "wh", "b"), ws[3 * d:3 * d + 3]))
        p = {k: v[0] for k, v in p.items()}
        with torch.no_grad():
            LS.lstm_layer(p, xl, lengths=ll, reverse=bool(d))
        pg = {k: v.detach().requires_grad_() for k, v in p.items()}
        LS.lstm_layer(pg, xl, lengths=ll,
                      reverse=bool(d)).float().sum().backward()
        # 16 learners' weights and rows in one call (x (L, B, T, D))
        pl = {k: v.detach().requires_grad_() for k, v in
              zip(("wx", "wh", "b"), lws[3 * d:3 * d + 3])}
        LS.lstm_layer(pl, lx, lengths=llens, reverse=bool(d),
                      seq_chunk=-1).float().sum().backward()
    torch.cuda.synchronize()
    counts = _uni_counts()
    for name, n in counts.items():
        if n <= 0:
            _fail(f"impl-dryrun: kernel {name} was never launched on the "
                  f"one-direction path")
    print(f"[impl-dryrun] models/lstm.lstm_layer, both directions, launches "
          f"{counts}", flush=True)
    return counts


def _cudnn_uni(x, wx, wh, b):
    """One cuDNN unidirectional bf16 LSTM over x's rows with the same
    weights (forget bias +1 in the input bias): (forward with autograd,
    backward of one saved forward), the library yardstick timed only
    here and used nowhere in the port."""
    import torch

    L, B, T, D = x.shape
    H = wh.shape[-2]
    lstm = torch.nn.LSTM(D, H, batch_first=True).to(x.device, torch.bfloat16)
    with torch.no_grad():
        bias = b[0].clone()
        bias[H:2 * H] += 1.0
        lstm.weight_ih_l0.copy_(wx[0].t())
        lstm.weight_hh_l0.copy_(wh[0].t())
        lstm.bias_ih_l0.copy_(bias)
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()
    xin = x.reshape(L * B, T, D).detach().requires_grad_(True)

    def fwd():
        return lstm(xin)[0]
    out = fwd()
    dy = torch.randn_like(out)

    def bwd():
        torch.autograd.grad(out, [xin] + list(lstm.parameters()), dy,
                            retain_graph=True)
    return fwd, bwd


def _uni_bound(L, B, T, D, H, n_valid, kind, K=0):
    """(bytes, ops) one direction must move and do: x, the weights, the
    lengths, y (and the stash or carries), or K2/K3's reads and writes;
    the products on the valid frames at the bf16 peak (x·Wx, h·Wh), K2's
    and K3's on f32 dgates at the TF32 peak."""
    weights = L * (D * 4 * H * 2 + H * 4 * H * 2 + 4 * H * 4)
    io = L * B * T * D * 2 + weights + L * B * 4 + L * B * T * H * 2
    recur = 2 * n_valid * 4 * H * (D + H)
    k2 = 2 * n_valid * 4 * H * (H + D + D + H) + n_valid * 4 * H
    grads = L * (D * 4 * H + H * 4 * H + 4 * H) * 4
    if kind == "fwd":
        return io, [(recur, PEAK_BF16_FLOPS)]
    if kind == "stash":
        return io + L * B * T * 5 * H * 4, [(recur, PEAK_BF16_FLOPS)]
    n = -(-T // K) if K else 0
    carries = L * B * n * 2 * H * 4
    if kind == "chunk":
        return io + carries, [(recur, PEAK_BF16_FLOPS)]
    if kind == "bwd":       # + dy, the f32 stash, dx and dW, db
        return (io + L * B * T * H * 2 + L * B * T * 5 * H * 4
                + L * B * T * D * 2 + grads), [(k2, PEAK_TF32_FLOPS)]
    return (io + L * B * T * H * 2 + carries + L * B * T * D * 2 + grads,
            [(recur, PEAK_BF16_FLOPS), (k2, PEAK_TF32_FLOPS)])


def _uni_entry(name, tag, src, line, fn, plain, lib_fn, err, nbytes, ops,
               shape):
    ms = _time_ms(fn, 5, warmup=1)
    dev_ms = _device_ms(fn, iters=5, reps=3)
    plain_ms = _time_ms(plain, 1, warmup=0)
    library_ms = None if lib_fn is None else _time_ms(lib_fn, 5)
    bound_ms, bound_by = _bound(nbytes, ops)
    print(f"[{tag}] {shape}: kernel {ms:.4f} ms eager, {_ms(dev_ms)} "
          f"replayed from a CUDA graph, plain {plain_ms:.3f} ms, cuDNN "
          f"(one direction) {_ms(library_ms)}, bound {bound_ms:.4f} ms "
          f"({bound_by})", flush=True)
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{src}",
                replaces=f"src/repro/kernels/lstm_cell.py:{line}",
                max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                shape=shape, directions=1)


def _uni_grads_check(tag, ws, x, lens, **kw):
    """blstm_sequence against the forward and the reversed lstm_sequence
    (bit for bit, forward and every gradient), and each lstm_sequence
    against its plain version (``UNI_TOL``); returns the worst abs
    error against plain."""
    import torch

    from repro_torch.kernels import lstm_cell as LC

    H = ws[1].shape[-2]
    dy = torch.randn(*x.shape[:-1], 2 * H, generator=torch.Generator(
        ).manual_seed(7)).to(x.device, torch.bfloat16)

    def run(fused, plain=False):
        leaves = [t.detach().clone().requires_grad_() for t in ws + [x]]
        *w, xi = leaves
        if fused:
            y = LC.blstm_sequence(*w, xi, lens, plain=plain, **kw)
        else:
            y = torch.cat([
                LC.lstm_sequence(*w[:3], xi, lens, plain=plain, **kw),
                LC.lstm_sequence(*w[3:], xi, lens, reverse=True,
                                 plain=plain, **kw)], dim=-1)
        y.backward(dy)
        return [y.detach()] + [t.grad for t in leaves]
    fused, passes = run(True), run(False)
    if not all(torch.equal(a, b) for a, b in zip(fused, passes)):
        _fail(f"{tag}: blstm_sequence is not bit-identical to the two "
              f"lstm_sequence passes")
    want = run(False, plain=True)
    names = ["y", "dwx_f", "dwh_f", "db_f", "dwx_b", "dwh_b", "db_b", "dx"]
    worst, errs = 0.0, []
    for n, g, w_ in zip(names, passes, want):
        abs_err, norm = _norm_err(g, w_)
        errs.append(f"{n} {norm:.3g}")
        worst = max(worst, abs_err)
        if not norm <= UNI_TOL:
            _fail(f"{tag}: {n} of the one-direction kernels disagrees with "
                  f"its plain version: {norm}")
    print(f"[{tag}] fused ≡ two one-direction passes bit for bit (y and "
          f"every gradient); vs plain {', '.join(errs)} (tol {UNI_TOL})",
          flush=True)
    return worst


def check_uni_lstm(gen):
    """(a) The one-direction kernels at the paper's width: K1 (B = 16,
    T = 21), K1-stash + K2 (the same rows under a gradient) and K1-chunk
    + K3 (16 learners x 2 rows, T = 2000, seq_chunk -1), both directions,
    var-len, against their plain versions, the bidirectional launches
    equal to the two one-direction passes bit for bit, and each timed."""
    import torch

    from repro_torch.kernels import lstm_cell as LC

    D, H = TRAIN_D, TRAIN_H
    ws, x, lens = _stacked_inputs(1, UNI_B, UNI_T, D, H, gen, True)
    # K1: inference, each direction vs plain and vs the fused launch
    y2 = LC.blstm_layer(*ws, x, lens)
    worst_k1 = 0.0
    for d in range(2):
        wx, wh, b = ws[3 * d:3 * d + 3]
        y = LC.lstm_layer(wx, wh, b, x, lens, reverse=bool(d))
        abs_err, norm = _norm_err(y, LC.lstm_layer_train(
            wx, wh, b, x, lens, reverse=bool(d), plain=True)[0])
        worst_k1 = max(worst_k1, abs_err)
        if not norm <= UNI_TOL:
            _fail(f"K1 (one direction, d={d}) disagrees with its plain "
                  f"version: {norm}")
        if not torch.equal(y, y2[..., d * H:(d + 1) * H]):
            _fail(f"K1 (one direction, d={d}) is not bit-identical to its "
                  f"half of the bidirectional launch")
    print(f"[K1-uni] B={UNI_B} T={UNI_T} D={D} H={H} var-len, both "
          f"directions: max_abs_err {worst_k1:.3g} vs plain (tol {UNI_TOL}); "
          f"bit-identical to the bidirectional launch's halves", flush=True)
    worst_train = _uni_grads_check("K1-stash-uni + K2-uni", ws, x, lens)
    K = LC.chunk_length(LONG_T, -1)
    lws, lx, llens = _long_inputs(gen, LONG_L, LONG_ROWS, LONG_T, D, H,
                                  LONG_K)
    worst_chunk = _uni_grads_check("K1-chunk-uni + K3-uni", lws, lx, llens,
                                   seq_chunk=-1)
    plan = LC.recur_plan(LONG_ROWS, LONG_T, H)
    waves = (LC.recur_waves(plan, LONG_L, LONG_ROWS,
                            LC.active_clusters(plan, H), n_dir=1)
             if plan.path == "resident" else 0)
    print(f"[K1-chunk-uni] L={LONG_L} B={LONG_ROWS} T={LONG_T} K={K}: the "
          f"forward recurrence {plan.path}, tiles of {plan.block_rows} rows, "
          f"{waves} wave(s) of one direction's clusters", flush=True)

    # timing: the forward direction (the reverse runs the same work)
    wx, wh, b = ws[:3]
    n_valid = int(lens.sum())
    fwd, bwd = _library_ms(lambda: _cudnn_uni(x, wx, wh, b), "K1-uni") or \
        (None, None)
    shape = f"B={UNI_B} T={UNI_T} D={D} H={H}"
    entries = [_uni_entry(
        "lstm_layer", "K1-uni", "lstm_fwd.cu", 498,
        lambda: LC.lstm_layer(wx, wh, b, x, lens),
        lambda: LC.lstm_layer_train(wx, wh, b, x, lens, plain=True),
        fwd, worst_k1, *_uni_bound(1, UNI_B, UNI_T, D, H, n_valid, "fwd"),
        shape)]
    entries.append(_uni_entry(
        "lstm_layer_train", "K1-stash-uni", "lstm_fwd.cu", 498,
        lambda: LC.lstm_layer_train(wx, wh, b, x, lens),
        lambda: LC.lstm_layer_train(wx, wh, b, x, lens, plain=True),
        fwd, worst_train,
        *_uni_bound(1, UNI_B, UNI_T, D, H, n_valid, "stash"), shape))
    y, acts, cseq = LC.lstm_layer_train(wx, wh, b, x, lens)
    dy = torch.randn(1, UNI_B, UNI_T, H, generator=gen).to(x.device,
                                                           torch.bfloat16)
    entries.append(_uni_entry(
        "lstm_layer_bwd", "K2-uni", "lstm_bwd.cu", 656,
        lambda: LC.lstm_layer_bwd(wx, wh, x, y, acts, cseq, dy, lens),
        lambda: LC.lstm_layer_bwd(wx, wh, x, y, acts, cseq, dy, lens,
                                  plain=True),
        bwd, worst_train,
        *_uni_bound(1, UNI_B, UNI_T, D, H, n_valid, "bwd"), shape))
    del y, acts, cseq
    wx, wh, b = lws[:3]
    n_valid = int(llens.sum())
    lfwd, lbwd = _library_ms(lambda: _cudnn_uni(lx, wx, wh, b),
                             "K1-chunk-uni") or (None, None)
    shape = f"L={LONG_L} B={LONG_ROWS} T={LONG_T} K={K} D={D} H={H}"
    entries.append(_uni_entry(
        "lstm_layer_train_chunked", "K1-chunk-uni", "lstm_fwd.cu", 498,
        lambda: LC.lstm_layer_train_chunked(wx, wh, b, lx, llens, chunk=K),
        lambda: LC.lstm_layer_train_chunked(wx, wh, b, lx, llens, chunk=K,
                                            plain=True),
        lfwd, worst_chunk, *_uni_bound(LONG_L, LONG_ROWS, LONG_T, D, H,
                                       n_valid, "chunk", K), shape))
    y, hb, cb = LC.lstm_layer_train_chunked(wx, wh, b, lx, llens, chunk=K)
    dy = torch.randn(LONG_L, LONG_ROWS, LONG_T, H, generator=gen).to(
        lx.device, torch.bfloat16)
    args = (wx, wh, b, lx, y, hb, cb, dy, llens)
    entries.append(_uni_entry(
        "lstm_layer_bwd_chunked", "K3-uni", "lstm_bwd_chunked.cu", 823,
        lambda: LC.lstm_layer_bwd_chunked(*args, chunk=K),
        lambda: LC.lstm_layer_bwd_chunked(*args, chunk=K, plain=True),
        lbwd, worst_chunk, *_uni_bound(LONG_L, LONG_ROWS, LONG_T, D, H,
                                       n_valid, "chunked_bwd", K), shape))
    return entries


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count: each module-level int of the
    kernel modules whose name ends in ``launches``."""
    from repro_torch.decode import kernel as DK
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import lstm_cell as LC
    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels import ssd_scan as SSD

    return {f"{m.__name__.rsplit('.', 1)[1]}.{k}": v
            for m in (DK, DA, FA, LC, MD, SSD)
            for k, v in vars(m).items()
            if k.endswith("launches") and isinstance(v, int)}


def _check_ops_on_card(gen):
    """(b) Every ``kernels/ops`` wrapper equals the wrapper it names on
    the card, bit for bit (``ops.blstm_stack``'s own inference branch
    included)."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import lstm_cell as LC
    from repro_torch.kernels import moe_dense as MD
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD

    r = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen).to(
        "cuda", dt)
    q, k, v = r(2, 64, 4, 64), r(2, 64, 2, 64), r(2, 64, 2, 64)
    ws = [r(1, 32, 64), r(1, 16, 64), r(1, 64, dt=torch.float32)] * 2
    one = [w[0] for w in ws[:3]]         # one model's weights
    x, lx = r(1, 3, 9, 32), torch.tensor([[9, 4, 1]], dtype=torch.int32,
                                         device="cuda")
    xs, dt_, A = r(1, 64, 4, 16), r(1, 64, 4, dt=torch.float32).abs(), \
        -r(4, dt=torch.float32).abs()
    Bm, Cm = r(1, 64, 1, 16), r(1, 64, 1, 16)
    xm, rw = r(8, 64), torch.softmax(r(8, 4, dt=torch.float32), -1)
    wi, wg, wo = r(4, 64, 64), r(4, 64, 64), r(4, 64, 64)
    pairs = [
        ("attention", ops.attention(q, k, v), FA.flash_attention(q, k, v)),
        ("lstm_sequence", ops.lstm_sequence(*one, x[0], lx[0], reverse=True),
         LC.lstm_sequence(*one, x[0], lx[0], reverse=True)),
        ("blstm_sequence", ops.blstm_sequence(*ws, x, lx),
         LC.blstm_sequence(*ws, x, lx)),
        ("blstm_stack", ops.blstm_stack([ws], x, lx),
         LC.blstm_stack([ws], x, lx)),
        ("ssd", ops.ssd(xs, dt_, A, Bm, Cm, chunk=16)[0],
         SSD.ssd(xs, dt_, A, Bm, Cm, chunk=16)[0]),
        ("moe_dense", ops.moe_dense(xm, rw, wi, wg, wo),
         MD.moe_dense(xm, rw, wi, wg, wo)),
    ]
    for name, a, b in pairs:
        if not torch.equal(a, b):
            _fail(f"ops.{name} differs from the wrapper it calls")
    print(f"[impl-dryrun] ops.{{{', '.join(n for n, _, _ in pairs)}}} equal "
          f"the wrappers they call, bit for bit", flush=True)


def _check_dryrun_on_card():
    """(c) Local dry-run records at full width on fake CUDA tensors:
    smollm-360m's training step (ad_psgd over its 16 learners, one
    sequence a microbatch, each layer under activation checkpointing,
    forward and backward) and its
    prefill at B = 4, S = 600.  Neither launches a kernel: a fake tensor
    takes every wrapper's plain version, in the checkpoint's recompute
    and the backward too.  Then the same prefill on the card, on the
    kernel path: the argument bytes exactly, and the predicted peak (the
    plain path's) at or above ``max_memory_allocated`` and at most
    ``DRYRUN_PEAK_TOL`` above it."""
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import build_model
    from repro_torch.params import init_params

    cfg = get_arch("smollm-360m")
    train = ShapeConfig(f"train_{DRYRUN_S}", DRYRUN_S,
                        cfg.n_learners * cfg.microbatches, "train")
    shape = ShapeConfig(f"prefill_{DRYRUN_S}", DRYRUN_S, DRYRUN_B, "prefill")
    before = _launch_counts()
    t0 = time.perf_counter()
    trec = DR.run_one(cfg.name, train.name, device="cuda", shape=train)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = DR.run_one(cfg.name, shape.name, device="cuda", shape=shape)
    trace_s = time.perf_counter() - t0
    after = _launch_counts()
    for r in (trec, rec):
        if r["status"] != "ok" or r["path"] != "plain":
            _fail(f"the dry-run record of {cfg.name} {r['shape']}: {r}")
    moved = {k: (before[k], after[k]) for k in after
             if after[k] != before.get(k)}
    if moved:
        _fail(f"the dry-run on fake tensors launched kernels: {moved}")
    tm = trec["memory"]
    print(f"[impl-dryrun] dry-run {cfg.name} {train.name} (ad_psgd, "
          f"{trec['n_learners']} learners, trace {train_s:.1f}s) on fake "
          f"CUDA tensors: argument {tm['argument_gb']:.3f} GB, peak "
          f"{tm['peak_gb']:.3f} GB (plain path), flops "
          f"{trec['cost']['flops']:.4g}; no kernel launched "
          f"({len(after)} counts unchanged)", flush=True)
    model = build_model(cfg)
    _free_all()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model.param_specs(), SEED, "cuda")
    tokens = torch.zeros(DRYRUN_B, DRYRUN_S, dtype=torch.int32,
                         device="cuda")
    real_args = sum(t.untyped_storage().nbytes() for t in
                    _leaf_tensors(params) + [tokens])
    alloc_args = torch.cuda.memory_allocated() - base
    n = FA.launches
    with torch.no_grad():
        model.prefill_fn(params, {"tokens": tokens}, cache_len=DRYRUN_S)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if FA.launches == n:
        _fail("the prefill on the card launched no K11")
    pred = rec["peak_bytes"]
    over = pred / peak - 1.0
    print(f"[impl-dryrun] dry-run {cfg.name} {shape.name} (trace "
          f"{trace_s:.1f}s): argument_bytes {rec['argument_bytes']} vs the "
          f"card's params + inputs {real_args} (allocator blocks "
          f"{alloc_args}); predicted peak (plain path) {pred} B "
          f"({pred / 2**30:.3f} GiB) vs the kernel path's "
          f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB): "
          f"{100 * over:+.2f} % (bound 0 to +{100 * DRYRUN_PEAK_TOL:.0f} %)"
          f"; flops {rec['cost']['flops']:.4g}, bytes "
          f"{rec['cost']['bytes']:.4g}, roofline {rec['roofline']}, fits "
          f"{rec['fits']}", flush=True)
    if rec["argument_bytes"] != real_args:
        _fail(f"the dry-run's argument bytes {rec['argument_bytes']} are not "
              f"the card's {real_args}")
    if not 0.0 <= over <= DRYRUN_PEAK_TOL:
        _fail(f"the dry-run's peak is {100 * over:+.2f} % off the kernel "
              f"path's (bound 0 to +{100 * DRYRUN_PEAK_TOL:.0f} %)")
    del params, tokens
    _free_all()
    return dict(argument_bytes=real_args, predicted_peak=pred,
                measured_peak=peak, over=over)


def _leaf_tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaf_tensors(v)]
    return [tree]


def _check_card_identity():
    """(d) The port's Hardware record against the card: the name as
    nvidia-smi gives it, the memory (the data sheet's "80 GB": the card's
    total_memory lies between 80e9 B and 80 GiB; the record's 80e9 is
    the smaller reading, which ``fits`` holds a peak to), and the power
    limit beside its 700 W."""
    import torch

    card = _card_line()
    name, limit = (s.strip() for s in card.split(",", 1))
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[impl-dryrun] Hardware {HW.name!r}, {HW.hbm_per_chip:.0f} B, "
          f"{HW.power_limit_w} W; nvidia-smi {card!r}; total_memory {total} "
          f"B ({total / 2**30:.2f} GiB)", flush=True)
    if name != HW.name:
        _fail(f"the card is {name!r}, the Hardware record {HW.name!r}")
    if not HW.hbm_per_chip <= total <= HW.hbm_per_chip / 1e9 * 2**30:
        _fail(f"the card's memory {total} B is not the record's "
              f"{HW.hbm_per_chip / 1e9:.0f} GB read in GB or GiB")
    if not limit.startswith(f"{HW.power_limit_w:.2f}"):
        print(f"[impl-dryrun] the card's power limit {limit} is below the "
              f"data sheet's {HW.power_limit_w} W: its peaks are lower",
              flush=True)


def phase_impl_dryrun(gen):
    """Phase 26: (a) the one-direction kernels' main path (counted) and
    checks, (b) the public wrappers on the card, (c) the dry-run on fake
    CUDA tensors and against the card, (d) the card's identity.  Returns (the five one-direction entries,
    their main-path launches)."""
    counts = _uni_main_path(gen)
    entries = check_uni_lstm(gen)
    _check_ops_on_card(gen)
    _check_dryrun_on_card()
    _check_card_identity()
    return entries, counts


def _io_run(fn, argv):
    """``fn(argv)`` with its standard output captured: (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(argv)
    return res, buf.getvalue()


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def main() -> int:
    try:
        import torch
    except ImportError as e:
        _fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the port is not importable from {HERE / 'src'}: {e}")
    t_start = time.perf_counter()

    def done(phase):
        print(f"[time] {phase} done at {time.perf_counter() - t_start:.1f}s",
              flush=True)

    try:
        phase_device()
        phase_build()
        done("build")
        gen = torch.Generator().manual_seed(SEED)
        k1 = check_k1(gen)
        k1s = check_k1_stash(gen)
        k2 = check_k2(gen)
        k1s["f64_err"], k2["f64_err"] = check_gemm_precision(gen)
        k5 = check_k5(gen)
        k4 = check_k4(gen)
        done("kernels")
        launches = phase_serve()
        phase_profile()
        done("serve")
        state, step, ds, counts, steps, train_ms, train_losses = \
            phase_train()
        phase_train_profile(state, step, ds, steps)
        done("train")
        eval_counts, k1_check_launches = phase_evaluate(state)
        del state, step, ds
        done("evaluate")
        multirank_counts = phase_multirank(train_losses)
        done("multirank")
        comm_counts = phase_comm()
        done("comm")
        ctc_counts, ctc_decode = phase_ctc()
        done("ctc")
        elastic_counts = phase_elastic(train_ms)
        done("elastic")
        k1c, k3 = check_k3(gen)
        long_counts, long_steps = phase_train_long()
        done("train-long")
        k7, k8, k6 = check_k7(gen), check_k8(gen), check_k6(gen)
        k11 = check_k11(gen)
        lm_server, lm_pending, dense, lm_counts = phase_lm_serve()
        done("lm-serve")
        phase_lm_profile(lm_server, lm_pending)
        del lm_server
        done("lm-profile")
        paged_counts = phase_lm_paged(lm_pending, dense)
        done("lm-paged")
        k9 = check_k9(gen)
        ssm_server, ssm_pending, ssm_counts = phase_ssm_serve()
        done("ssm-serve")
        phase_two_window_profile(ssm_server, ssm_pending, "ssm-profile")
        del ssm_server
        done("ssm-profile")
        hyb_server, hyb_pending, hyb_counts = phase_hybrid_serve()
        done("hybrid-serve")
        phase_two_window_profile(hyb_server, hyb_pending, "hybrid-profile")
        del hyb_server
        done("hybrid-profile")
        k10 = check_k10(gen)
        done("k10")
        moe_server, moe_pending, moe_fin, moe_counts = phase_moe_serve()
        done("moe-serve")
        phase_two_window_profile(moe_server, moe_pending, "moe-profile")
        del moe_server
        done("moe-profile")
        moe_paged_counts = phase_moe_paged(moe_pending, moe_fin)
        done("moe-paged")
        load_counts, trace_counts = phase_load()
        done("load")
        encdec_counts = phase_encdec()
        done("encdec")
        vlm_counts, vlm_paged_counts = phase_vlm()
        done("vlm")
        dense_cfg_counts = phase_dense_configs()
        done("dense-configs")
        lm_train_counts, train_fns = phase_lm_train(gen)
        done("lm-train")
        uni, uni_counts = phase_impl_dryrun(gen)
        done("impl-dryrun")
    except SystemExit:
        raise
    except Exception:                    # any phase failing fails the run
        traceback.print_exc()
        _fail("a phase raised")
    for k in (k1s, k2):
        k["launches_per_step"] = counts[k["name"]] / steps
        k["launches_comm"] = comm_counts[k["name"]]
        k["launches_ctc"] = ctc_counts[k["name"]]
        k["launches_elastic"] = elastic_counts[k["name"]]
        k["launches_multirank"] = multirank_counts[k["name"]]
        launches[k["name"]] = (counts[k["name"]] + comm_counts[k["name"]]
                               + ctc_counts[k["name"]]
                               + elastic_counts[k["name"]]
                               + multirank_counts[k["name"]])
    # K4 is the forward of every serve admission (B = 1, the entry's own
    # times) and of evaluate (B = 8, its ``evaluate_shape``): each count
    # stands beside its shape's times.  K1's inference variant runs on no
    # main path now (serve and evaluate hold it at 0); the launches of the
    # loop K4 is held to are a check and stand apart
    k4["evaluate_shape"]["launches"] = eval_counts["blstm_stack"]
    # the CTC phase's held-out decode: K4 at B = 8, T = 21 and K5 under the
    # sum semiring, counted into the main-path totals
    k4["launches_ctc"] = ctc_decode["blstm_stack"]
    launches["blstm_stack"] += ctc_decode["blstm_stack"]
    launches["blstm_layer"] = eval_counts["blstm_layer"]
    k1["launches_check"] = k1_check_launches
    k5["beam_frame_step"]["launches_evaluate"] = \
        k5["beam_frame_step"]["evaluate_shape"]["launches"] = \
        eval_counts["beam_frame_step"]
    k5["beam_frame_step"]["launches_ctc"] = ctc_decode["beam_frame_step"]
    launches["beam_frame_step"] += ctc_decode["beam_frame_step"]
    launches["decode_attention"] = lm_counts["decode_attention"]
    launches["argmax_tokens"] = lm_counts["argmax_tokens"]
    launches["paged_decode_attention"] = paged_counts["paged_decode_attention"]
    k6["launches_paged"] = paged_counts["argmax_tokens"]
    k6["launches_ssm"] = ssm_counts["argmax_tokens"]
    launches["ssd_scan"] = ssm_counts["ssd_scan"]
    k9["launches_per_admission"] = ssm_counts["ssd_scan"] / SSM_REQUESTS
    launches["flash_attention"] = hyb_counts["flash_attention"]
    k11["launches_dense"] = lm_counts["flash_attention"]
    k11["launches_paged"] = paged_counts["flash_attention"]
    for k in (k6, k7, k9):
        k["launches_hybrid"] = hyb_counts[k["name"]]
    launches["moe_dense"] = moe_counts["moe_dense"]
    k10["launches_paged"] = moe_paged_counts["moe_dense"]
    for k in (k6, k7, k11):
        k["launches_moe"] = moe_counts[k["name"]]
    k8["launches_moe"] = moe_paged_counts["paged_decode_attention"]
    for k in (k1c, k3):
        k["launches_per_step"] = long_counts[k["name"]] / long_steps
        launches[k["name"]] = long_counts[k["name"]]
    # phase 21: the load runs (K4, K5; K11, K8, K6 of the paged LM) and
    # the traced train CLI (K1-stash, K2)
    for name, n in load_counts.items():
        launches[name] += n
    for k in (k4, k5["beam_frame_step"], k6, k8, k11):
        k["launches_load"] = load_counts[k["name"]]
    for k in (k1s, k2):
        k["launches_trace_cli"] = trace_counts[k["name"]]
        launches[k["name"]] += trace_counts[k["name"]]
    # phases 22-24: the encdec, vlm (dense and paged) and dense-configs
    # runs (K11, K7, K8, K6)
    for k in (k6, k7, k8, k11):
        name = k["name"]
        k["launches_encdec"] = encdec_counts[name]
        k["launches_vlm"] = vlm_counts[name] + vlm_paged_counts[name]
        k["launches_dense_cfgs"] = dense_cfg_counts[name]
        launches[name] += (k["launches_encdec"] + k["launches_vlm"]
                           + k["launches_dense_cfgs"])
    # phase 25: the transformer families' training (K11, K9, K10), each
    # also at its training shapes through its autograd Function
    for k in (k9, k10, k11):
        name = k["name"]
        k["launches_train_lm"] = lm_train_counts[name]
        launches[name] += lm_train_counts[name]
        k["train_shapes"] = {
            shape: dict(grad_err=e, ms=ms, plain_ms=pms)
            for shape, (e, ms, pms) in train_fns[name].items()}
    kernels = [k1, k1s, k2, k1c, k3, k4, k5["beam_frame_step"],
               k5["beam_frame_step_topc"], k6, k7, k8, k9, k10, k11]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    # phase 26: K1, K1-stash, K2, K1-chunk and K3 launched with one
    # direction (models/lstm.lstm_layer)
    for k in uni:
        k["launches"] = uni_counts[k["name"]]
    kernels += uni
    print(f"[total] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
