#!/usr/bin/env python3
"""Drive the PyTorch port of MACH serving (Algorithm 2, streaming and
count-min candidate decode), training (Algorithm 1, through the fused
logit-free loss), language-model serving (recurrentgemma-2b with the
MACH head, through the slot engine; the dense decoders and the MoE
decoder qwen2-moe-a2.7b through the paged and lockstep engines; the
xLSTM, enc-dec and vision models xlstm-350m, seamless-m4t-large-v2 and
paligemma-3b) and language-model training (recurrentgemma-2b through the
trainer; a cut of qwen2-moe-a2.7b; the three others at full width),
checkpoint-restart (ODP and tinyllama-1.1b resumed at full width, the
training and serving examples) and the sharded trainer on a mesh
(tinyllama-1.1b at full width, an NCCL world of one) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure exits non-zero and prints no result:

1. Device: requires CUDA, prints the card's name and power limit as
   ``nvidia-smi`` gives them, turns TF32 off.
2. Build: compiles every kernel from ``src/repro_torch/kernels/csrc``.
3. Kernels vs plain on the card: first kernel 1 (top-1) at ODP's shape
   for N in {256, 64, 37, 33, 31, 1}, so that both of its mappings (query
   per lane from N = 32, class per thread below) and the threshold
   between them run, and on rows whose maximum two classes in different
   K-splits share (the lowest id must win); then kernel 2 (streaming
   top-k) the same way at k in {1, 10, 32, 33, 100} and the three
   estimators (R = 25 is no multiple of the lane mapping's 4-repetition
   gather chunk, so min and median read its +inf pad row), each of its
   two mappings counted as launched (query per lane where N >= 32 and
   next_pow2(k) <= 32, class per thread otherwise); then the top-1 and
   streaming top-k kernels against their plain PyTorch versions — table
   and inline hashing, the
   three estimators, k in {1, 10, 100}, the ODP shape (R=25, B=32), the
   ImageNet-21k shape (R=20, B=512, even-R median) and a tiny-B, tiny-R
   shape where classes collide in bulk, with ragged N and K.  Dyadic
   inputs (multiples of 2^-10) must agree exactly, values and indices;
   random inputs to rtol 1e-6, indices equal except on near-ties.
3b. Candidate kernels vs plain on the card: bucket top-m (kernel 7)
   exactly (tau bit for bit, ids), at B in {4, 32, 37, 512, 1,000, 2,048,
   8,192} with m in {1, 2, 3, 12, 16, 32, 33, B-1, B} up to B, on dyadic,
   random, all-equal and signed-zero rows, every path of its wrapper
   counted as launched; the candidate filter (kernel 8) at
   N <= 5 and, at ODP, N in {1, 4, 37}, both hash sources, the three
   estimators, (m, t) in {(1, 1), (2, 2), (B, R)} and a flat-random
   (1, R) that exercises the backfill slot, k in {1, 10, 100}: values,
   bands and ids equal, dyadic and random; every layout of
   ``cand_layout`` (probabilities in shared or global memory, one or four
   keys a lane) counted as launched.  Shapes: ODP (R=25, B=32),
   ImageNet-21k (R=20, B=512), the JAX gate (R=16, B=8192, K=1,048,576)
   and a tiny collide one (R=B=4).
4. Main path at full ODP width: ``MACHLinear`` (K=105,033, d=422,713,
   B=32, R=25) with seeded random weights answers a 256-query CSR batch
   (nnz=120) through ``predict`` and ``estimators.predict_topk(k=10)``
   for each estimator, and ``ops.mach_top1``.  Launch counters are set
   to 0 just before and read just after; both kernels must have run.
   Then ms per answer, kernel ms, plain ms, the library yardstick — the
   float32 GEMM against the (R·B, K) multi-hot matrix, then ``torch.max``
   or ``torch.topk`` (the times over materialized sums kept apart, as a
   labelled extra) — and peak memory; kernels 1 and 2 also with the table
   hash and by CUDA-graph replay, their layouts and ptxas's registers and
   spills, and how often kernel 2's median ran its sorting network.
4b. Candidate main path at full width: ODP (phase 4's model and batch)
   and ImageNet-21k (K=21,841, d=6,144, B=512, R=20, dense features,
   N=256) through ``estimators.predict_topk(candidate_mode=(m, t))`` for
   each estimator, exact (B, R) and approximate ((2|4, 1) unbiased,
   (2|4, 2) min and median), and ``predict(candidate_mode=(B, R))``.
   Launch counters from 0; both candidate kernels must have run.  Exact
   mode must equal the streaming kernel's answer bit for bit, predict
   equal ``mach_top1`` up to near-ties, the approximate answers the
   plain path's on 16 queries; recall@10 is printed.  Then answer,
   kernel, plain, ``torch.topk`` and streaming-kernel times, bounds,
   peak memory, and the JAX gate shape (N=8, m=12, planted-signal
   batch): candidate kernels vs the plain streaming top-k, recall@10.
   Kernel 8 is timed by CUDA events and by CUDA-graph replay in every
   setting (its layout and ptxas's registers and spills printed), and at
   the LM engine's (2048, 8) and (16, 2) on its 4-slot pool (checked
   against the plain version there too); kernel 7 in each setting beside
   ``torch.topk``, and at the LM engine's settings and the gate's shape.
5. Fused-xent kernels vs plain on the card, forward and backward: the
   dense, ELL and gather families against their plain PyTorch versions
   (loss, lse, dW, dbias, dh) at the ODP shape (R=25, B=32), the
   ImageNet-21k shape (R=20, B=512) and an odd one (B=37, R·B=259,
   ragged N), with and without bias; CSR batches with duplicate ids, a
   row at exactly nnz_max, short and empty rows, at nnz 120 and 1,024
   through both sparse families.  Loss and lse to rtol 1e-5, gradients
   to rtol 1e-4 / atol 1e-6 (sums in another order; the dense kernel
   reduces across blocks with float atomics); each backward runs twice
   and the largest difference is printed, and the ELL and gather
   families', which use no float atomics, must be 0.  The
   dense kernel (3xTF32 on the tensor cores in float32) also runs each
   dense shape with bf16 operands, and the LM head's shape (N=8,192,
   d=2,560, R=8, B=2,048) in bf16 with and without bias, dh asked: loss
   and lse to rtol 1e-5, each bf16 gradient's largest error within 2^-7
   of its largest entry and its relative L2 error within 2^-8.  And at
   the float32 card test's N(0, 1) features (32 cases a shape), the dense
   kernel and cuBLAS's float32 plain version each against the plain
   version in float64 at the same tolerances: the kernel may have no
   violation; both sides' counts and largest errors are printed.
6. Training main path at full width: ``MACHLinear(fused=True)`` with
   AdamW (lr 0.05) — ODP (K=105,033, d=422,713, B=32, R=25, CSR nnz=120,
   N=512) 5 steps through the ELL kernels; the same model 2 steps on
   nnz=1,024 batches through the gather kernels; ImageNet-21k (K=21,841,
   d=6,144, B=512, R=20, dense, N=512) 3 steps through the dense
   kernels.  Launch counters are set to 0 just before and read just
   after; all six launch functions must have run, every loss must be
   finite, and each first step's loss and gradients must equal the plain
   version's.  Then ms per step, stage times (the fused-xent kernels by
   CUDA events and by CUDA-graph replay), peak memory.  Then kernel 4
   at the LM head's shape in bf16 (the fused LM loss's call, on the
   path in phase 10's fused run): forward and backward-with-dh ms, plain and library (bf16
   torch.matmul + F.cross_entropy) ms, peak memory of each, bound,
   ptxas registers and shared memory.
7. LM kernels vs plain on the card: the RG-LRU scan (kernel 9) equal to
   its plain sequential loop bit for bit, float32 at (1, 4096, 2560),
   (4, 1, 2560), a ragged (3, 37, 300) with nonzero h0 (and bfloat16
   there) and a ragged (2, 4097, 2570) (T and D past whole stages and
   channel tiles); flash attention (kernel 10) at (1, 4096, 10,
   256) / (1, 4096, 1, 256) bfloat16 with window 2048 and without, a
   GQA case (KV=2, H=8, hd=128, ragged T), tinyllama's width (hd 64,
   32 / 4 heads), phi3's (hd 96, padded to 128 in the kernel, 32 / 32
   heads), a ragged windowed hd-256 case and a float32 one: float32 to
   rtol 1e-5 / atol 1e-6, bfloat16 within 2 bf16 ulps of each (query,
   head) row's largest output.  Then kernel 10 in the modes phase 15
   runs (FLASH_NEW_MODES, bf16): seamless's encoder (1, 3072, 16/16, hd
   64) and cross-attention (1, 2048 q / 3072 kv) non-causal, its
   training cross-attention (2, 4096 / 1024) non-causal and decoder (2,
   4096) causal, paligemma's prefill (1, 2048, 8/1, hd 256) and training
   (2, 4096) causal; the training cases forward and backward (phase 9's
   rule), each timed beside SDPA with its bound.  Then the MACH decode kernels (1 and 2)
   at the LM head's shape (R=8, B=2048, K=256,000, inline multiply-shift
   hash; N=1 as after a prefill, N=4 as in the pooled decode, where a
   block holds 3 queries and the last block 1): top-1 and top-k (k 1 and
   50, the three estimators) against their plain versions, dyadic inputs
   exactly, random ones as in phase 3; kernel 1's time there beside its
   plain version and a sparse multi-hot product + ``torch.max``, kernel
   2's (k=50) beside it + ``torch.topk``.
8. LM serving at full width: recurrentgemma-2b (26 layers, bf16, MACH
   head B=2048, R=8 over V=256,000) with seeded random weights on the
   card, served by ``ServingEngine`` (4 slots, max_len 4,160, top_k 50,
   16 new tokens): a 4,096-token prompt (the flash branch, the ring-cache
   roll, kernel 9 at T=4,096) and prompts of 5, 77 and 300 tokens, the
   77-token one sampled at temperature 0.8.  Launch counters from 0:
   kernel 10 in the long prefill, kernel 9 in every prefill and decode
   step, kernel 2 in every serve step (the engine's greedy rows take the
   top-1 of its fused top-k, so the engine launches kernel 1 no time);
   then a direct greedy prefill + decode_step + next_token loop (kernel
   1), whose tokens the greedy requests must equal.  The two runs' counts
   are reported apart.  Then the path's own outputs: kernels 1 and 2 vs
   plain on the four prompts' last hidden states (k=50, the sampled
   rows' candidates); the 4,096-token prefill against the same model on
   the dense branch (flash_threshold raised), with a decode step on the
   rolled ring caches against a dense prefill of the 4,097 tokens: the
   first attention layer's K/V and every cache's positions and index
   exactly; the last hidden states and every cache held to the model in
   float32 on the dense branch, with at most twice the bf16 dense
   branch's relative L2 error there, plus 2^-9.  Then the same requests
   through ``ServeConfig(candidate_mode=(2048, 8))`` (exact: tokens must
   equal the streaming engine's bit for bit) and ``(16, 2)``
   (approximate: greedy tokens reported), kernels 7-8 launch counts from
   0 for each.  Then prefill ms, ms per pooled decode step, tokens/s,
   peak memory, and kernel, plain, bound and library times (kernel 9's
   prefill and decode calls also by CUDA-graph replay).
9. LM training kernels vs plain on the card: kernel 3 (the R-head CE
   on given logits), forward and backward, at ragged shapes (float32 and
   bfloat16, labels at 0 and B-1) and the training path's shape (8,192,
   8, 2048) in bf16 — loss to rtol 1e-5, gradient to rtol 1e-5 in
   float32 and within one bf16 ulp in bf16; kernel 9's backward bit for
   bit against its plain reverse loop at (2, 4096, 2560), (4, 1, 2560),
   (1, 1, 16), a ragged (3, 37, 300) in float32 and bf16 and a ragged
   (2, 4097, 2570) in float32, nonzero h0;
   kernel 10's backward at the training shape ((2, 4096, 10, 256) / KV=1,
   bf16, window 2048) and at small float32 shapes (causal, windowed,
   unmasked; G = 1, 2, 10) and bf16 ones: a ragged GQA case, tinyllama's
   and phi3's widths and head counts, a ragged windowed hd-256 case, an
   unmasked hd 48 and qwen2-moe-a2.7b's training shape ((2, 4096, 16,
   128) / 16 KV heads, causal): dq, dk, dv to rtol 1e-4 / atol 1e-5 in float32,
   within 2 bf16 ulps of each row's largest entry (past a 2^-20 float32
   floor) in bf16; the forward with lse equal to the forward without it,
   bit for bit.
10. LM training at full width: recurrentgemma-2b (26 layers, bf16 params,
   remat="full") with seeded random weights, trained through
   ``Trainer.step_fn`` (``make_train_step``) with launch/train.py's
   ``TrainConfig`` (AdamW, warmup 2, peak 3e-4, clip 1.0) for 6 steps on
   ``SyntheticLMStream`` batches of 2 x 4,096 tokens (global batch cut
   from the train_4k shape's 256 to one chip's memory).  First the first
   step's gradients, per group (embedding, RG-LRU blocks, attention
   blocks, MLPs, norms, head), against the same model in float32 on the
   dense branch: each group's relative L2 error at most twice the bf16
   dense branch's, plus 2^-9.  Launch counters from 0 over the 6 steps:
   kernels 3, 9 and 10 forward and backward, each at its count a step
   (remat runs 9 and 10 forward twice).  Every loss finite; batch 0's
   loss after the 6 steps below its loss at step 0.  Then ms per step,
   tokens/s, peak memory, the split into forward + backward and clip +
   AdamW + apply, and kernel, plain, bound and library times at the
   path's shapes (``F.cross_entropy`` and SDPA's backward as yardsticks;
   kernel 9 forward and backward also by CUDA-graph replay).
   Then the same training with ``mach_fused_loss=True`` (same params,
   stream and trainer): the loss runs kernel 4 on the bf16 hidden states
   and head kernel, forward and backward with dh.  Launch counters from
   0: kernel 4 forward and backward once a step, kernel 3 never.  The
   first step's loss is held to the unfused loss of the same params and
   batch within 2^-8 of it (one bf16 unit roundoff: the unfused loss
   rounds its logits to bf16, the fused one never forms them).  Ms per
   step, tokens/s and peak memory beside the unfused run's.
11. Dynamic bucket selection at the JAX package's 500k-label workload
   (``benchmarks/bench_train_xent.py`` EXTREME_500K: K=500,000, B=4,096,
   R=8, d=1,024, N=512, c_sel=512, refresh every 10 steps), trained
   through ``Trainer`` with a ``bucket_proxy_fn`` for 6 AdamW steps,
   selection on and off, on CSR batches at nnz 64 (kernel 5) and 1,024
   (kernel 6) and on the nnz-64 batches densified (kernel 4, float32).
   Launch counters from 0 for each run: the family's forward and
   backward once a step, the proxy once.  Every loss finite; the
   selected first loss at most the full one (the bias is one-sided).  Ms
   per step and peak memory, on and off.  Then kernels 4-6 at B' = c_sel
   on the gathered columns against their plain versions, forward and
   backward (gradients through the gather to the full W and bias), at
   R=8, c_sel=512 and at R=5, c_sel=511 (R·c_sel = 2,555 odd: unaligned
   rows, kernel 6's scalar dW path): the unselected columns' gradients
   exactly zero, the card's selected ids equal to the CPU's, the ops'
   ``bucket_select`` dispatch equal to the kernel at the gathered
   columns; each family's kernel times at B' and at B on the same inputs.
12. The one-vs-all baseline: ``OAAClassifier`` trained at ImageNet-21k
   width (K=21,841, d=6,144, N=512, dense float32, 5 AdamW steps) beside
   the fused ``MACHLinear`` on the same stream (ms a step, peak memory;
   first losses near ln K and R ln B); ODP's OAA (105,033 x 422,713
   float32 = 177.6 GB) sized and not tried: it does not fit on one card.
   Then recurrentgemma-2b with ``mach="off"`` (the tied 256,000 x 2,560
   softmax head): phase 8's requests served by the engine (greedy tokens
   must equal the direct greedy loop; kernels 9-10 counted), and phase
   10's training (first loss near ln V, batch 0's loss falling), ms a
   step and peak beside the MACH head's.
13. The dense decoders through the paged and lockstep engines:
   kernel 2 against its plain version at tinyllama-1.1b's MACH head
   (R=8, B=2048, K=32,000; N 1 and 4, k 1 and 50, the three estimators,
   table and inline hashes, dyadic inputs exactly; timed beside its
   bound and ``torch.topk`` over a sparse multi-hot product), kernels 7
   and 8 against theirs at the same head's candidate_mode=(B, R) =
   (2048, 8) with tinyllama's inverted table (k=50, N 1 and 4, the
   three estimators, both hashes, dyadic and random rows), kernel 10
   against its plain version (phase 7's rule) and timed at tinyllama,
   phi3-mini and granite-20b's 2,048-token prefills (bf16, causal; SDPA
   beside it) and at tinyllama's in float32 (the float32 engines'
   prefill).  Then, launch counters from 0 over the
   engines' runs: tinyllama-1.1b at full width (22 layers, d=2,048,
   32 / 4 heads, d_ff 5,632, V=32,000; seeded random weights) serves 8
   greedy requests over 4 slots (prompts of 2,048, 5, 77, 300, 1,000,
   17, 2,048 and 40 tokens, ragged max_new_tokens; max_len 4,096)
   with the MACH head (B=2048, R=8) and with the OAA head, in bf16,
   through the contiguous continuous, contiguous lockstep, paged
   (page_size 16, the default pool) and paged half-pool (half the
   workload's worst-case pages) engines; lockstep tokens must equal
   continuous ones in more ticks; each paged row's hidden state after
   the first pooled decode step, against the same step of the model in
   float32 (the bf16 params cast up) on the same inputs, is within 1.25
   times the contiguous engine's relative L2 error plus 2^-10 (the two
   engines round attention at other points: softmax weights against
   unnormalized exponentials; equal greedy tokens are counted), and two
   faults planted in the page walk (the newest position masked, each
   slot's newest page dropped) must each break that limit; the half pool must
   defer admissions (reservation_failures > 0) and finish; the MACH paged
   engine with candidate_mode=(B, R) must equal its streaming tokens
   bit for bit (kernels 7-8); the OAA model also runs 16 slots paged
   inside the 4-slot contiguous pool's KV bytes.  The MACH model again
   in float32: paged greedy tokens must equal contiguous ones exactly.
   Each engine run's kernel-10 launches must be one an attention layer
   for each 2,048-token prompt, kernel 2's at least one on a MACH head.
   Then phi3-mini-3.8b and granite-20b at full width (bf16, OAA heads;
   each freed before the next) serve a 2,048-token prompt and a 33-token
   one through the paged engine: each first token must equal a batch-1
   prefill's greedy pick.  mistral-large-123b is sized (it does not
   fit) and served at its smoke config.  Printed per engine: ticks, time
   to the first token of the 2,048-token prompt, median pooled decode
   tick after admission, tokens/s, the pool's KV bytes, peak memory,
   pages_peak, fragmentation and reservation_failures.
14. The MoE decoders: kernel 2 against its plain version at
   qwen2-moe-a2.7b's MACH head (R=8, B=2048, K=151,936; phase 13's cases;
   timed at N=4, k=50 beside its bound and ``torch.topk`` over a sparse
   multi-hot product), kernels 7 and 8 at its (2048, 8), kernel 10 at its
   2,048-token prefill (q (1, 2048, 16, 128), 16 KV heads, bf16, causal;
   SDPA beside it).  The MoE block (``models/moe.py``) at qwen2's full
   block widths (d=2,048, 60 experts top-4 of f=1,408, 4 shared of
   5,632, groups of 512) against its plain sequential version
   ``moe_ref`` on the card, float32 and bf16, at n = 2,048 (4 groups, cap
   42), 2,049 (a padded group) and 4 (a decode pool, cap 1), each input
   the first seed whose routing drops a choice: expert ids and the kept
   mask equal, y and the aux losses at rtol 1e-5 (float32) and a
   relative L2 of 2^-8 (bf16); the dropped share printed.  Then
   qwen2-moe-a2.7b at full width (24 layers, 14.0 B params, bf16, MACH
   head; seeded random weights) serves phase 13's 8 ragged requests over
   4 slots through the contiguous continuous, lockstep, paged and
   contiguous candidate_mode = (2048, 8) engines, launch counters from 0
   over the four runs: kernel 10 once an attention layer for each
   2,048-token prompt in each run, kernel 2 in the streaming runs,
   kernels 7-8 in the candidate run.  Each first token must equal a
   batch-1 prefill's greedy pick; candidate tokens must equal streaming
   ones bit for bit; lockstep tokens must equal continuous ones on the
   tokens emitted while the two pools hold the same live rows (capacity
   couples a pooled step's rows, and free or held rows differ between
   schedulers), in more ticks; paged tokens are reported.  Layer 0's
   dropped share on the 2,048-token prefill and on a 4-slot decode step
   is printed, and each engine as in phase 13.  Then the same config
   cut to 4 of its 24 layers (every width kept) in float32: paged tokens
   must equal contiguous ones on every token emitted before a slot fell
   free.  Then the 4-layer cut in bf16 trained 3 AdamW steps (remat) on
   2 x 4,096-token batches: the router's gradient nonzero in every
   layer, every loss, load_balance and router_z finite (the last two
   positive), kernels 3 and 10 forward and backward at their counts a
   step; ms a step, tokens/s, peak memory.  mixtral-8x22b is sized
   (param_count_estimate within (120e9, 150e9); it does not fit) and its
   smoke config (sliding window 8, ring caches, OAA head) served paged.
15. xlstm-350m, seamless-m4t-large-v2 and paligemma-3b at full width
   (bf16, seeded random weights): kernels 2 and 1 against their plain
   versions at the three models' MACH heads (xlstm's with mach="on";
   K=50,304 / 256,206 / 257,216; kernel 2 at phase 13's cases, kernel 1
   at N=1 and 4, table and inline hashes; each timed at N=4 (kernel 2 at
   k=50) beside its bound and ``torch.topk`` / ``torch.max`` over a
   sparse multi-hot product).  Then, launch counters from 0, phase
   13's 8 ragged requests over 4 slots (max_len 4,096): xlstm-350m with
   its OAA head through the contiguous and lockstep engines (lockstep
   tokens == contiguous ones) and with ``mach="on"`` (B=2048, R=8 over
   50,304) through the contiguous engine; seamless (every request with
   its own 3,072 x 1,024 audio frames: kernel 10 non-causal in the
   encoder, S != T in the cross-attention of the 2,048-token prompts)
   and paligemma (256 x 1,152 patches a request; the two long prompts
   1,792 tokens, so 2,048 positions take the flash branch) through the
   contiguous and paged engines; each MACH model's requests also through
   a direct greedy prefill + decode_step + next_token loop (kernel 1) in
   a 4-row pool, whose tokens the contiguous engine's must equal; every
   engine's first tokens equal the loop's batch-1 prefills' picks; each
   engine run's kernel-10 launches as its encoder frames and prompts take
   the flash branch.
   xlstm-350m runs here at 4 of its 24 layers (two (mLSTM, sLSTM)
   periods, every width: its sLSTM's eager loop took most of the phase).
   Then each model trained 3 AdamW steps (remat) through
   ``Trainer.step_fn``: seamless on 2 x 4,096 tokens with 1,024 frames a
   row, paligemma on 2 x (3,840 + 256 patches), xlstm-350m (MACH) on 2 x
   1,024 and on 2 x 64 (sequence cuts: the sLSTM is an eager loop of T
   steps a layer); kernels 3 and 10 at their counts a step, every loss
   and gradient norm finite, but at 1,024 only its first loss: at random
   init the sLSTM's gradients through time overflow, in the JAX package
   too (ROADMAP.md §3), so its gradient norm is non-finite from the
   first step (printed with the run); ms a step, tokens/s, peak.  Counts
   read: kernels 1, 2, 3 and 10 (forward and backward) must each have
   run.  Then, off the count: xlstm-350m's first mLSTM and sLSTM blocks
   in float32 over 2,048 tokens, a prefill + a decode step against the
   longer prefill and the card against the CPU (rel L2 <= 2^-12; the
   sLSTM's r scaled by 1/sqrt(hd), since at the reference's init its
   recurrence amplifies rounding, see ``_xlstm_blocks_check``);
   seamless's and paligemma's longest prefill on the flash branch
   against the float32 model on the dense branch (at most twice the bf16
   dense branch's rel L2 + 2^-9).
16. Checkpoints and restarts, launch counters from 0, every directory
   under one temporary directory removed at the end: ODP (phase 6's model
   and AdamW state, 4.06 GB, through ``Trainer`` with a
   ``CheckpointManager(keep=2)``) on nnz=1,024 batches (kernel 6, no
   float atomics) trained 7 steps twice uninterrupted and once through
   ``run_with_restarts`` with a non-blocking save after step 4 and a
   failure at step 7 once that save is durable: the resumed state must
   equal the saved one and the three final states each other, bit for
   bit.  The same at nnz=120 (kernel 5, no float atomics either), bit
   for bit.  tinyllama-1.1b at full width (bf16 params,
   float32 moments, 11 GB a checkpoint) with launch/train.py's
   ``train_config`` and ``data_stream`` on 2 x 2,048 tokens (kernel 10
   forward and backward), 8 steps, the non-blocking save after step 5
   and the failure at step 8: the resumed state bit for bit, the restart
   equal to an uninterrupted run bit for bit where two uninterrupted runs
   are; where they differ, a third run, and the restarted run's mean
   |difference| from the first at most twice the largest of the three
   pairs' (``_hold_restart``; the largest differences printed beside).
   Printed for each: the state's and the
   checkpoint's bytes, the blocking save's time and GB/s, how long a
   non-blocking save holds the step (the host snapshot), the restore's
   time, ms a step with the write in flight against the same steps
   without.  Then ``launch/train.main`` with ``--ckpt-dir`` (3 steps,
   smoke tinyllama), ``examples/train_lm.py`` twice on one directory
   (20 then 40 steps: the second run resumes at 20; kernel 3) and
   ``examples/serve_lm.py`` (kernels 2 and 9).  Each kernel named must
   have run in its part.
17. Multi-device on an NCCL world of one (a ``FileStore`` in a temporary
   directory), a (1, 1) ``("data", "model")`` mesh, the FSDP rules:
   kernel 10 held to plain and timed at tinyllama-1.1b's training shape
   (2 x 4,096, 32 / 4 heads of 64, causal, bf16, forward and backward);
   kernels 3 and 4 as each rank of tinyllama-1.1b's head split by
   repetition 2, 4 and 8 ways launches them (8,192 rows, d 2,048, R 8,
   B 2,048, bf16), on each repetition range in turn against the whole
   kernels: summed losses at float32 rtol 1e-6, kernel 3's dlogits and
   kernel 4's lse bit for bit, kernel 4's dW columns and summed dh by
   phase 5's bf16 rule, each range's ms beside the whole kernel's.
   tinyllama-1.1b with the MACH head (B=2,048, R=8; kernel 3) at full
   width, bf16 params and float32 moments, 2 x 4,096 tokens, 4 AdamW
   steps through the unsharded ``Trainer`` and 2 with the fused loss
   over the in-loss selection (c_sel 512; kernel 4), then, launch
   counters from 0, both through ``Trainer(mesh=)`` (the state
   ``DTensor``s, placed as it is built; each layer period's params
   gathered inside the recomputed period; the head split by repetition,
   n = 1) from the same seed: losses, params and moments bit for bit
   (fused: the first loss, as kernel 4's atomics part the runs after
   it), kernels 3, 4 and 10 launched, the gathered bytes alive at once (counted
   on the first step) within the leaves outside the stacks plus two
   periods, ms a step, the steps' and the init's peak memory both ways
   against what the phase expects (printed).  The sharded state
   saved (gathered, rank 0 writes) and restored unsharded and onto the
   mesh, both bit for bit, with their times.  One
   qwen2-moe-a2.7b MoE block (2 x 4,096 tokens) at each rank's shapes
   for n = 2, 4 (by expert: 30 and 15 of its 60 experts) and 8 (by
   columns: 176 of every expert's 1,408), built with the port's
   ``MoESplit`` / ``RangeSplit`` on the world-1 mesh: the n ranks'
   float32 partial outputs summed held to the whole block at rtol 1e-5,
   rank 0's bf16 forward + backward timed beside the whole block's, the
   expert bytes a rank gathers.  Then phase 14's qwen2-moe-a2.7b cut (4
   layers, bf16, its MACH head) trained 3 AdamW steps on 2 x 4,096
   tokens unsharded and, launch counters from 0, through
   ``Trainer(mesh=)`` (every MoE block's experts split by expert, n =
   1): losses, params and moments bit for bit, kernels 3 and 10
   launched, ms a step and the peaks both ways.  Then
   ``torchrun --standalone --nproc_per_node=1 -m
   repro_torch.launch.train --local-mesh --full --seq-len 4096
   --global-batch 2 --steps 3`` with ``--ckpt-dir`` in the temporary
   directory (rc 0; ``--local-mesh`` is ``--local``),
   and ``topk_compress`` / ``quantize_8bit`` on the card equal to the
   CPU, bit for bit.
18. The dry run (``repro_torch.launch.dryrun``) against the card: phase
   17's sharded tinyllama-1.1b step (MACH head, 2 x 4,096 tokens) dry-run
   at world 1 on fake CUDA tensors, and one untimed real step of the same
   trainer on an NCCL world of one counted by the same counter
   (``launch/cost_analysis.py``): flops, bytes and each kernel's
   ``work()`` equal exactly; the dry run's step peak within DRY_PEAK_RTOL
   of phase 17's measured peak; the counted 6·N·D and all counted flops
   over phase 17's ms a step, as TFLOP/s and a share of 989.  Then
   mistral-large-123b x train_4k on the (16, 16) mesh through ``python -m
   repro_torch.launch.dryrun`` (started at nice 10 when the script starts
   and run beside the card's phases: its eager step takes minutes of one
   host core): rc 0, its per-rank step and init peaks, fit and roofline
   (data-sheet arithmetic) printed.
19. The kernel report (one JSON line; rows 2, 7, 8 and 10 with their
   launches on phase 13's path, rows 2, 3, 7, 8 and 10 on phase 14's,
   rows 1, 2, 3 and 10 on phase 15's and kernel 10's new modes, rows 2,
   3, 5, 6, 9 and 10 on phase 16's, rows 3, 4 and 10 on phase 17's, rows
   3 and 10 on its sharded qwen2-moe run, with rows 3 and 4's times per
   repetition range), then the device line, last.  Every phase prints
   its wall time, and the script its total.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

# One process runs every phase, each with tensors of its own sizes.
# Phase 12's OAA training step peaks near the card's capacity and, with
# fixed segments, needs an allocator retry (a cache flush) in every run;
# in some runs a 7.8 GiB logits gradient then found no room beside 20-25
# GiB reserved but unallocated.  Expandable segments do not fragment so.
# Set before torch allocates on the card; every phase's numbers are taken
# under it (tools/smoke_memory.py prints the allocator's state by phase).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM float32, outside the tensor cores
TF32_OPS_PER_S = 494.7e12        # H100 SXM TF32 tensor cores, dense
BF16_TOPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
ESTIMATORS = ("unbiased", "min", "median")
N_MAIN, K_MAIN = 256, 10
# kernel-vs-plain shapes: (label, N, R, B, K) — ragged N and K tails
CHECK_SHAPES = [("odp", 37, 25, 32, 105033), ("imagenet21k", 37, 20, 512, 21841),
                ("collide", 5, 4, 2, 5003)]
# candidate-kernel checks: (label, N, R, B, K) — kernel 8 at small N,
# kernel 7 at N=37; the gate shape's R·B is beyond the streaming kernel
CAND_SHAPES = [("odp", 5, 25, 32, 105033), ("imagenet21k", 5, 20, 512, 21841),
               ("gate", 3, 16, 8192, 1048576), ("collide", 5, 4, 4, 5003)]
# kernel 1's two mappings at ODP's shape: N >= 32 query per lane (33 and 37
# one ragged 64-query tile, 64 and 256 full ones), 31 and 1 class per thread
TOP1_N = (256, 64, 37, 33, 31, 1)
# kernel 2 at the same N: query per lane where N >= 32 and next_pow2(k) <=
# 32 (lists of 1, 16 and 32 keys), class per thread at k = 33 and 100
TOPK_K = (1, 10, 32, 33, 100)
# kernel 8 at ODP beside CAND_SHAPES' N: one query, the LM engine's 4, and
# a ragged 37
CAND_N = (1, 4, 37)
# kernel 7 checks on 37 queries x 3 repetitions: each B with each m of
# TOPM_M up to B, and B - 1 and B, so every path of ``topm_layout`` runs
# (select: m <= 32 above B = 1,024, and below where next_pow2(m) <=
# next_pow2(B) / 32 >= 2; warp: B <= 1,024 otherwise; block: the rest)
TOPM_B = (4, 32, 37, 512, 1000, 2048, 8192)
TOPM_M = (1, 2, 3, 12, 16, 32, 33)
TOPM_ROWS = ("dyadic", "random", "all-equal", "signed zeros")
# kernel 7 timed beside torch.topk at the LM engine's settings (its 4-slot
# pool) and the JAX gate's: (label, N, R, B, m)
TOPM_TIMED = [("lm exact (2048, 8)", 4, 8, 2048, 2048),
              ("lm approx (16, 2)", 4, 8, 2048, 16),
              ("gate", 8, 16, 8192, 12)]
# the JAX benchmark's decode gate: K, R, B, N, k, m; t per estimator
GATE = {"K": 1048576, "R": 16, "B": 8192, "N": 8, "k": 10, "m": 12}
GATE_T = {"unbiased": 1, "min": 2, "median": 2}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def kernel_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``iters`` back-to-back calls replayed from
    a CUDA graph (CUDA events around one replay): the host's dispatch
    through a Python wrapper then hides no kernel that is shorter than
    it, as it does under ``kernel_ms``."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


# how rows 1, 2, 7 and 8 of the kernel report are timed
TIMING = ("ms, plain_ms and library_ms by kernel_ms (CUDA events around "
          "back-to-back calls, as every row); *_graph by graph_ms (device "
          "time, CUDA-graph replay)")


def wall_ms(fn, runs: int = 7, warmup: int = 2) -> float:
    """Median host time of a call that ends in a device synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_of(work, rate: float) -> tuple[float, str]:
    """Least time (ms) on this card for ``work`` = (operations, bytes), a
    kernel's ``work()`` (``src/repro_torch/kernels``: each kernel's
    bound is that one arithmetic): its operations at ``rate`` against
    its bytes at HBM's rate, and which of the two bounds it."""
    ops_, nbytes = work
    t_ops, t_bytes = ops_ / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_ms(n: int, r: int, b: int, num_classes: int, k: int,
             table: bool) -> tuple[float, str]:
    """Least time for the decode on this card (``mach_decode.work``: the
    probabilities, the table in table mode and the outputs read or
    written, one float32 operation a gathered value, N·K·R)."""
    from repro_torch.kernels import mach_decode as md
    return bound_of(md.work(n, r, b, num_classes, table, k), F32_OPS_PER_S)


# ---------------------------------------------------------------------------
# phase 3: kernels vs their plain versions
# ---------------------------------------------------------------------------

def _inputs(n, r, b, dyadic, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dyadic:
        return torch.randint(0, 1025, (n, r, b), generator=gen,
                             device=dev).float() / 1024
    return torch.softmax(torch.randn((n, r, b), generator=gen, device=dev), -1)


def _check_same(name, kv, ki, pv, pi, scores, exact) -> float:
    """Kernel (kv, ki) vs plain (pv, pi); returns max |value error|."""
    kv, ki, pv, pi = (t.reshape(t.shape[0], -1) for t in (kv, ki, pv, pi))
    if not torch.isfinite(kv).all():
        fail(f"{name}: non-finite kernel values")
    err = float((kv - pv).abs().max())
    if exact:
        if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
            bad = (ki != pi).any(-1).nonzero()[:3].flatten().tolist()
            fail(f"{name}: dyadic kernel != plain (rows {bad}, max err {err})")
        return err
    if not torch.allclose(kv, pv, rtol=1e-6, atol=1e-7):
        fail(f"{name}: values off by {err}")
    # indices may differ only where the plain scores tie within rtol
    at_kernel = torch.gather(scores, 1, ki.long())
    if not torch.allclose(at_kernel, pv, rtol=1e-6, atol=1e-7):
        fail(f"{name}: kernel indices not near-ties of the plain ones")
    for row in ki.tolist():
        if len(set(row)) != len(row):
            fail(f"{name}: duplicate class ids in a row")
    return err


def _top1_mappings(dev) -> dict:
    """Kernel 1 vs plain at ODP's shape (R=25, B=32, K=105,033) for each
    N of TOP1_N, both hash sources, dyadic inputs exactly and random ones
    as ``_check_same`` holds them; then rows whose maximum two classes in
    different K-splits share (256 rows in four 64-query tiles, and 31 rows
    class per thread): the lowest id must win.  Returns the comparisons
    made in each mapping."""
    from repro_torch.core.hashing import MultShiftFamily
    from repro_torch.kernels import mach_decode as md

    r, b, num_classes = 25, 32, 105033
    fam = MultShiftFamily(b, r, seed=1)
    table = fam.table(num_classes, dev)
    hashes = {"table": {"table": table},
              "inline": {"inline_coeffs": fam.coeffs_tensor(dev),
                         "inline_shift": fam.shift}}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_mapping = dict.fromkeys(md.MAPPINGS, 0)

    def check(tag, meta, exact):
        n = meta.shape[0]
        mapping = md.decode_layout(n, r, b, num_classes, sms).mapping
        sums = md.summed_scores(meta, table)
        for mode, hash_kw in hashes.items():
            before = md.mach_decode_cuda.launches
            kv, ki = md.mach_decode_cuda(meta, num_classes=num_classes,
                                         **hash_kw)
            pv, pi = md.mach_decode_plain(meta, num_classes=num_classes,
                                          **hash_kw)
            torch.cuda.synchronize()
            if md.mach_decode_cuda.launches != before + 1:
                fail("mach_decode_cuda did not count its launch")
            _check_same(f"top1 odp n={n} {tag} {mode} ({mapping})", kv, ki,
                        pv, pi, sums, exact)
            by_mapping[mapping] += 1
        return pi

    for n in TOP1_N:
        for dyadic in (True, False):
            check("dyadic" if dyadic else "random",
                  _inputs(n, r, b, dyadic, seed=n, dev=dev), dyadic)
    reps = torch.arange(r, device=dev)[None, :]
    for n in (256, 31):
        q = torch.arange(n, device=dev)
        low = 1000 + 211 * q                     # early K-splits
        high = num_classes - 1 - 97 * q          # the last ones
        meta = torch.zeros((n, r, b), device=dev)
        for k in (low, high):
            meta[q[:, None], reps, table[:, k].T.long()] = 0.5
        if not torch.equal(check("tied across K-splits", meta, True).long(),
                           low):
            fail(f"top1 n={n}: the tie does not go to the lowest class id")
    for mapping, count in by_mapping.items():
        if count < 1:
            fail(f"top1 mapping {mapping} never ran")
    print(f"top1 mappings vs plain at odp, N in {TOP1_N} and two tie "
          f"batches: {by_mapping} comparisons ok", flush=True)
    return by_mapping


def _topk_mappings(dev) -> dict:
    """Kernel 2 vs plain at ODP's shape (R=25, B=32, K=105,033) for each N
    of TOP1_N and k of TOPK_K, the three estimators (R = 25 is no multiple
    of the 4-repetition gather chunk, so the lane mapping's pad row is
    read), both hash sources, dyadic inputs exactly and random ones as
    ``_check_same`` holds them; then rows whose best value two classes in
    different K-splits share (256 rows in four 64-query tiles, and 31
    rows class per thread): the lowest id must rank first.  Returns the
    comparisons made in each mapping; both must run."""
    from repro_torch.core.hashing import MultShiftFamily
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt

    r, b, num_classes = 25, 32, 105033
    fam = MultShiftFamily(b, r, seed=1)
    table = fam.table(num_classes, dev)
    hashes = {"table": {"table": table},
              "inline": {"inline_coeffs": fam.coeffs_tensor(dev),
                         "inline_shift": fam.shift}}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_mapping = dict.fromkeys(md.MAPPINGS, 0)

    def check(tag, meta, exact, est):
        n = meta.shape[0]
        scores = mt.estimator_scores(meta, table, est)
        pv_all, pi_all = mt.mach_topk_plain(meta, table, num_classes=num_classes,
                                            k=max(TOPK_K), estimator=est)
        for k in TOPK_K:
            for mode, hash_kw in hashes.items():
                mapping = mt.topk_layout(n, r, b, num_classes, k, sms, est,
                                         inline=mode == "inline").mapping
                before = mt.mach_topk_cuda.launches
                kv, ki = mt.mach_topk_cuda(meta, num_classes=num_classes, k=k,
                                           estimator=est, **hash_kw)
                torch.cuda.synchronize()
                if mt.mach_topk_cuda.launches != before + 1:
                    fail("mach_topk_cuda did not count its launch")
                _check_same(f"topk odp n={n} {est} k={k} {tag} {mode} "
                            f"({mapping})", kv, ki, pv_all[:, :k],
                            pi_all[:, :k], scores, exact)
                by_mapping[mapping] += 1
        return pi_all

    for n in TOP1_N:
        for dyadic in (True, False):
            meta = _inputs(n, r, b, dyadic, seed=n + 1, dev=dev)
            for est in ESTIMATORS:
                check("dyadic" if dyadic else "random", meta, dyadic, est)
    reps = torch.arange(r, device=dev)[None, :]
    for n in (256, 31):
        q = torch.arange(n, device=dev)
        low = 1000 + 211 * q                     # early K-splits
        high = num_classes - 1 - 97 * q          # the last ones
        meta = torch.zeros((n, r, b), device=dev)
        for k in (low, high):
            meta[q[:, None], reps, table[:, k].T.long()] = 0.5
        for est in ESTIMATORS:
            pi = check("tied across K-splits", meta, True, est).long()
            if not torch.equal(pi[:, :2], torch.stack([low, high], 1)):
                fail(f"topk {est} n={n}: the tie does not go to the lowest "
                     f"class id")
    for mapping, count in by_mapping.items():
        if count < 1:
            fail(f"topk mapping {mapping} never ran")
    print(f"topk mappings vs plain at odp, N in {TOP1_N}, k in {TOPK_K} and "
          f"two tie batches: {by_mapping} comparisons ok", flush=True)
    return by_mapping


def phase_kernels_vs_plain(dev) -> tuple[int, dict]:
    from repro_torch.core.hashing import MultShiftFamily
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt

    mappings = {"mach_decode": _top1_mappings(dev),
                "mach_topk": _topk_mappings(dev)}
    checked = sum(sum(m.values()) for m in mappings.values())
    for label, n, r, b, num_classes in CHECK_SHAPES:
        fam = MultShiftFamily(b, r, seed=1)
        table = fam.table(num_classes, dev)
        coeffs, shift = fam.coeffs_tensor(dev), fam.shift
        for dyadic in (True, False):
            meta = _inputs(n, r, b, dyadic, seed=r * b, dev=dev)
            sums = md.summed_scores(meta, table)
            for mode in ("table", "inline"):
                hash_kw = ({"table": table} if mode == "table" else
                           {"inline_coeffs": coeffs, "inline_shift": shift})
                tag = f"{label} n={n} {'dyadic' if dyadic else 'random'} {mode}"
                kv, ki = md.mach_decode_cuda(meta, num_classes=num_classes,
                                             **hash_kw)
                pv, pi = md.mach_decode_plain(meta, num_classes=num_classes,
                                              **hash_kw)
                torch.cuda.synchronize()
                _check_same(f"top1 {tag}", kv, ki, pv, pi, sums, dyadic)
                checked += 1
                for est in ESTIMATORS:
                    scores = mt.estimator_scores(meta, table, est)
                    for k in (1, 10, 100):
                        kv, ki = mt.mach_topk_cuda(meta, num_classes=num_classes,
                                                   k=k, estimator=est, **hash_kw)
                        pv, pi = mt.mach_topk_plain(meta, num_classes=num_classes,
                                                    k=k, estimator=est, **hash_kw)
                        torch.cuda.synchronize()
                        _check_same(f"topk {est} k={k} {tag}", kv, ki, pv, pi,
                                    scores, dyadic)
                        checked += 1
        print(f"kernels vs plain: {label} (N={n}, R={r}, B={b}, K={num_classes})"
              f" ok", flush=True)
    return checked, mappings


# ---------------------------------------------------------------------------
# phase 3b: the candidate kernels (7 and 8) vs their plain versions
# ---------------------------------------------------------------------------

def _check_candidates(name, got, want) -> float:
    """Kernel 8's (value, band, id) top-k vs the plain version's, at
    the same k: bands equal (so dead and backfill slots sit in the same
    positions), values and ids equal (the kernel repeats the plain
    arithmetic, so this holds on random inputs too), no duplicate id.
    Returns the max abs error of the live values."""
    (kv, kb, ki), (pv, pb, pi) = got, want
    if not torch.equal(kb, pb):
        fail(f"{name}: bands differ (dead/backfill slots out of place)")
    live = kb > 0
    if not torch.isfinite(kv[live]).all():
        fail(f"{name}: non-finite kernel values")
    err = float((kv[live] - pv[live]).abs().max()) if live.any() else 0.0
    if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
        bad = (ki != pi).any(-1).nonzero()[:3].flatten().tolist()
        fail(f"{name}: kernel != plain (rows {bad}, max err {err})")
    for row, ok in zip(ki.tolist(), live.tolist()):
        ids = [i for i, o in zip(row, ok) if o]
        if len(set(ids)) != len(ids):
            fail(f"{name}: duplicate class ids in a row")
    return err


def _topm_inputs(kind, n, r, b, dev):
    """Kernel 7's rows: dyadic (ties in bulk), random softmax, all equal,
    or signed zeros — dyadic values >= 0.75 among -0.0 and +0.0, which
    the plain version's sort counts equal and orders by id."""
    if kind in ("dyadic", "random"):
        return _inputs(n, r, b, kind == "dyadic", seed=b, dev=dev)
    if kind == "all-equal":
        return torch.full((n, r, b), 0.25, device=dev)
    x = _inputs(n, r, b, True, seed=b + 1, dev=dev)
    gen = torch.Generator(device=dev).manual_seed(b)
    neg = torch.rand((n, r, b), generator=gen, device=dev) < 0.5
    zero = torch.where(neg, torch.full_like(x, -0.0), torch.zeros_like(x))
    return torch.where(x >= 0.75, x, zero)


def _topm_sweep(dev) -> dict:
    """Kernel 7 vs its plain version (on a host copy of the same rows),
    exactly — tau bit for bit, ids — at every (B, m) of TOPM_B / TOPM_M
    and each kind of TOPM_ROWS; each launch counted, and every path of
    ``topm_layout`` must run.  Returns the comparisons by path, their
    count and the largest tau error."""
    from repro_torch.kernels import mach_candidates as mc

    n, r = 37, 3
    by_path = dict.fromkeys(mc.TOPM_PATHS, 0)
    err = 0.0
    for b in TOPM_B:
        for kind in TOPM_ROWS:
            meta = _topm_inputs(kind, n, r, b, dev)
            host = meta.cpu()
            for m in sorted({m for m in TOPM_M if m <= b} | {max(1, b - 1), b}):
                path = mc.topm_layout(b, m).path
                before = mc.bucket_topm_cuda.launches
                kt, ki = mc.bucket_topm_cuda(meta, m)
                torch.cuda.synchronize()
                if mc.bucket_topm_cuda.launches != before + 1:
                    fail("bucket_topm_cuda did not count its launch")
                pt, pi = mc.bucket_topm(host, m)
                kt, ki = kt.cpu(), ki.cpu()
                if not (torch.equal(kt.view(torch.int32), pt.view(torch.int32))
                        and torch.equal(ki, pi)):
                    bad = (ki != pi).any(-1).flatten().nonzero()[:3].tolist()
                    fail(f"bucket_topm B={b} m={m} {kind} ({path}): kernel != "
                         f"plain (rows {bad})")
                err = max(err, float((kt - pt).abs().max()))
                by_path[path] += 1
    for path, count in by_path.items():
        if count < 1:
            fail(f"bucket_topm path {path} never ran")
    print(f"bucket_topm vs plain: {by_path} comparisons ok (B in {TOPM_B}, "
          f"rows {TOPM_ROWS})", flush=True)
    return {"bucket_topm": sum(by_path.values()), "topm_by_path": by_path,
            "topm_max_abs_err": err}


def phase_candidates_vs_plain(dev) -> dict:
    from repro_torch.core.hashing import MultShiftFamily, inverted_table
    from repro_torch.kernels import mach_candidates as mc

    stats = {"mach_candidate_topk": 0, "max_abs_err": 0.0, "backfill_rows": 0}
    stats.update(_topm_sweep(dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # kernel 8's layouts run: (probabilities in shared memory, keys a lane)
    by_layout = {(smem, keys): 0 for smem in (True, False) for keys in (1, 4)}
    shapes = CAND_SHAPES + [("odp", n, 25, 32, 105033) for n in CAND_N]
    for label, n, r, b, num_classes in shapes:
        fam = MultShiftFamily(b, r, seed=1)
        table = fam.table(num_classes, dev)
        inv = inverted_table(table, b, device=dev)
        hashes = {"table": {"table": table},
                  "inline": {"inline_coeffs": fam.coeffs_tensor(dev),
                             "inline_shift": fam.shift}}
        for dyadic in (True, False):
            kind = "dyadic" if dyadic else "random"
            meta = _inputs(n, r, b, dyadic, seed=r * b + 1, dev=dev)
            settings = [(1, 1), (2, 2), (b, r)] + ([] if dyadic else [(1, r)])
            for m, t in settings:
                tau, ids = mc.bucket_topm(meta, m)
                for mode, hash_kw in hashes.items():
                    for est in ESTIMATORS:
                        want = mc.mach_candidate_topk_plain(
                            meta, tau, ids, inv, num_classes=num_classes, k=100,
                            t=t, estimator=est, **hash_kw)
                        if (m, t) == (1, r):
                            stats["backfill_rows"] += int((want[1][:, 0] == 1).sum())
                        for k in (1, 10, 100):
                            lay = mc.cand_layout(n, r, b, m, inv.shape[1], k,
                                                 sms)
                            before = mc.mach_candidate_topk_cuda.launches
                            got = mc.mach_candidate_topk_cuda(
                                meta, tau, ids, inv, num_classes=num_classes,
                                k=k, t=t, estimator=est, **hash_kw)
                            torch.cuda.synchronize()
                            if mc.mach_candidate_topk_cuda.launches != before + 1:
                                fail("mach_candidate_topk_cuda did not count "
                                     "its launch")
                            by_layout[lay.smem_probs, lay.lane_keys] += 1
                            err = _check_candidates(
                                f"candidates {label} {kind} {mode} {est} m={m} "
                                f"t={t} k={k}", got, [x[:, :k] for x in want])
                            stats["max_abs_err"] = max(stats["max_abs_err"], err)
                            stats["mach_candidate_topk"] += 1
        print(f"candidate kernels vs plain: {label} (N={n}, R={r}, B={b}, "
              f"K={num_classes}, L={inv.shape[1]}) ok", flush=True)
    if stats["backfill_rows"] < 1:
        fail("no flat-random row exercised the backfill slot")
    for (smem, keys), count in by_layout.items():
        if count < 1:
            fail(f"kernel 8's layout (probabilities in "
                 f"{'shared' if smem else 'global'} memory, {keys} keys a "
                 f"lane) never ran")
    stats["cand_by_layout"] = {
        f"{'shared' if smem else 'global'} probabilities, {keys} "
        f"key{'s' if keys > 1 else ''} a lane": count
        for (smem, keys), count in by_layout.items()}
    print(f"kernel 8 layouts run: {stats['cand_by_layout']}", flush=True)
    return stats


# ---------------------------------------------------------------------------
# phase 4: the main path at full ODP width
# ---------------------------------------------------------------------------

def phase_main_path(dev) -> list[dict]:
    from repro_torch.configs.odp_mach import ODP
    from repro_torch.core import estimators as est
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import SparseExtremeDataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cfg = ODP.mach()
    head = MACHLinear(cfg, ODP.dim)
    params = head.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    data = SparseExtremeDataset(ODP.sparse_data(small=False), device=dev)
    batch, _ = data.batch_at(0, N_MAIN)
    table = head.table(dev)
    fam = cfg.family
    coeffs, shift = fam.coeffs_tensor(dev), fam.shift
    K, R, B = cfg.num_classes, cfg.num_repetitions, cfg.num_buckets
    torch.cuda.synchronize()
    print(f"main path: ODP K={K} d={ODP.dim} B={B} R={R}, batch N={N_MAIN} "
          f"nnz<={batch.nnz_max}, set-up {time.perf_counter() - t0:.1f} s",
          flush=True)

    def meta_nrb():
        return head.meta_probs(params, batch).movedim(0, -2)

    answers = {f"predict[{e}]": (lambda e=e: head.predict(params, batch, e))
               for e in ESTIMATORS}
    answers.update({
        f"predict_topk[{e},k={K_MAIN}]":
            (lambda e=e: est.predict_topk(head.meta_probs(params, batch),
                                          table, K_MAIN, e))
        for e in ESTIMATORS})
    answers["predict_topk[unbiased,k=1]"] = lambda: est.predict_topk(
        head.meta_probs(params, batch), table, 1, "unbiased")
    answers["mach_top1[inline]"] = lambda: ops.mach_top1(
        meta_nrb(), num_classes=K, inline_coeffs=coeffs, inline_shift=shift)

    # the main path's run: counts from 0, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    md.mach_decode_cuda.launches = 0
    mt.mach_topk_cuda.launches = 0
    out = {name: fn() for name, fn in answers.items()}
    torch.cuda.synchronize()
    launches = {"mach_decode": md.mach_decode_cuda.launches,
                "mach_topk": mt.mach_topk_cuda.launches}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"main path launches: {launches}, peak memory {peak_gib:.2f} GiB",
          flush=True)
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} never launched on the main path")

    # right answers: shapes, finiteness, kernel == plain on this batch,
    # and greedy agreement (top-1 = top-k(k=1) = predict, up to near-ties)
    meta = meta_nrb().contiguous()
    sums = md.summed_scores(meta, table)
    for name, res in out.items():
        vals = res if isinstance(res, torch.Tensor) else res[0]
        if not torch.isfinite(vals.float()).all():
            fail(f"{name}: non-finite output")
    errs = {"mach_decode": 0.0, "mach_topk": 0.0}
    kv, ki = md.mach_decode_cuda(meta, num_classes=K, inline_coeffs=coeffs,
                                 inline_shift=shift)
    pv, pi = md.mach_decode_plain(meta, num_classes=K, inline_coeffs=coeffs,
                                  inline_shift=shift)
    errs["mach_decode"] = _check_same("main mach_top1", kv, ki, pv, pi, sums,
                                      exact=True)
    for e in ESTIMATORS:
        kv, ki = mt.mach_topk_cuda(meta, table, num_classes=K, k=K_MAIN,
                                   estimator=e)
        pv, pi = mt.mach_topk_plain(meta, table, num_classes=K, k=K_MAIN,
                                    estimator=e)
        errs["mach_topk"] = max(errs["mach_topk"], _check_same(
            f"main topk {e}", kv, ki, pv, pi, None, exact=True))
        if tuple(out[f"predict_topk[{e},k={K_MAIN}]"][1].shape) != (N_MAIN, K_MAIN):
            fail(f"predict_topk[{e}] has the wrong shape")
    top1 = out["mach_top1[inline]"][1].long()
    for other in (out["predict_topk[unbiased,k=1]"][1][:, 0].long(),
                  out["predict[unbiased]"].long()):
        a = torch.gather(sums, 1, top1[:, None])
        c = torch.gather(sums, 1, other[:, None])
        if not torch.allclose(a, c, rtol=1e-6, atol=0):
            fail("greedy answers disagree beyond near-ties")
    n_diff = int((top1 != out["predict[unbiased]"].long()).sum())
    print(f"main path answers ok: kernels == plain exactly; greedy top-1 "
          f"agrees with predict on {N_MAIN - n_diff}/{N_MAIN} queries, the rest "
          f"near-ties", flush=True)

    for name, fn in answers.items():
        print(f"answer {name}: {wall_ms(fn):.3f} ms/batch", flush=True)
    print(f"stage meta_probs (CSR densify + f32 projection + softmax): "
          f"{wall_ms(meta_nrb):.3f} ms/batch", flush=True)

    # kernel, plain and library times on the main path's inputs.  The
    # library yardstick computes the whole function: a float32 GEMM
    # against the (R·B, K) multi-hot matrix (a model constant, built
    # outside the timed call; TF32 off), then torch.max / torch.topk.
    smi = _nvidia_smi()
    rows = []
    decode_kw = {"num_classes": K, "inline_coeffs": coeffs, "inline_shift": shift}
    multihot = torch.nn.functional.one_hot(table.long(), B).permute(0, 2, 1) \
        .reshape(R * B, K).float()
    meta2d = meta.reshape(N_MAIN, R * B)
    t_bound, by = bound_ms(N_MAIN, R, B, K, 1, table=False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows.append({
        "name": "mach_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_decode.cu",
        "replaces": "src/repro/kernels/mach_decode.py:202",
        "launches": launches["mach_decode"],
        "max_abs_err": errs["mach_decode"],
        "ms": kernel_ms(lambda: md.mach_decode_cuda(meta, **decode_kw)),
        "ms_graph": graph_ms(lambda: md.mach_decode_cuda(meta, **decode_kw)),
        "plain_ms": kernel_ms(lambda: md.mach_decode_plain(meta, **decode_kw),
                              iters=5),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": kernel_ms(lambda: torch.max(meta2d @ multihot, dim=-1)),
        "library_ms_graph": graph_ms(
            lambda: torch.max(meta2d @ multihot, dim=-1)),
        "library": "torch.max over meta2d @ multihot (f32 GEMM, TF32 off)",
        "library_ms_materialized": kernel_ms(lambda: torch.max(sums, dim=-1)),
        "shape": f"N={N_MAIN} R={R} B={B} K={K} inline hash",
        "timing": TIMING,
        "ms_table": kernel_ms(lambda: md.mach_decode_cuda(meta, table,
                                                          num_classes=K)),
        "ms_table_graph": graph_ms(lambda: md.mach_decode_cuda(
            meta, table, num_classes=K)),
        "layout": md.decode_layout(N_MAIN, R, B, K, sms)._asdict(),
        "ptxas": _ptxas_registers(_build.build_log("mach_decode")),
    })
    ms_est, graph_est, plain_est = {}, {}, {}
    for e in ESTIMATORS:
        ms_est[e] = kernel_ms(lambda e=e: mt.mach_topk_cuda(
            meta, table, num_classes=K, k=K_MAIN, estimator=e))
        graph_est[e] = graph_ms(lambda e=e: mt.mach_topk_cuda(
            meta, table, num_classes=K, k=K_MAIN, estimator=e))
        plain_est[e] = kernel_ms(lambda e=e: mt.mach_topk_plain(
            meta, table, num_classes=K, k=K_MAIN, estimator=e), iters=5)
    ms_inline = kernel_ms(lambda: mt.mach_topk_cuda(
        meta, num_classes=K, k=K_MAIN, inline_coeffs=coeffs,
        inline_shift=shift))
    graph_inline = graph_ms(lambda: mt.mach_topk_cuda(
        meta, num_classes=K, k=K_MAIN, inline_coeffs=coeffs,
        inline_shift=shift))
    ms_k100 = kernel_ms(lambda: mt.mach_topk_cuda(
        meta, table, num_classes=K, k=100))
    topk_layout = mt.topk_layout(N_MAIN, R, B, K, K_MAIN, sms)
    # how often the query-per-lane median ran its sorting network: runs
    # over (warp, class, query slot) steps, one per class, tile and slot;
    # inline hash, since the median in table mode runs class per thread
    runs = torch.zeros(1, dtype=torch.int64, device=dev)
    mt.mach_topk_cuda(meta, num_classes=K, k=K_MAIN, inline_coeffs=coeffs,
                      inline_shift=shift, estimator="median",
                      network_runs=runs)
    lane = mt.topk_layout(N_MAIN, R, B, K, K_MAIN, sms, "median", inline=True)
    steps = -(-N_MAIN // lane.queries) * K * (lane.queries // 32)
    network_share = int(runs) / steps
    t_bound, by = bound_ms(N_MAIN, R, B, K, K_MAIN, table=True)
    rows.append({
        "name": "mach_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_topk.cu",
        "replaces": "src/repro/kernels/mach_topk.py:132",
        "launches": launches["mach_topk"],
        "max_abs_err": errs["mach_topk"],
        "ms": ms_est["unbiased"], "plain_ms": plain_est["unbiased"],
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": kernel_ms(lambda: torch.topk(meta2d @ multihot, K_MAIN,
                                                   dim=-1)),
        "library": "torch.topk over meta2d @ multihot (f32 GEMM, TF32 off)",
        "library_ms_materialized": kernel_ms(
            lambda: torch.topk(sums, K_MAIN, dim=-1)),
        "shape": f"N={N_MAIN} R={R} B={B} K={K} k={K_MAIN} table hash, unbiased",
        "timing": TIMING,
        "ms_graph": graph_est["unbiased"],
        "ms_by_estimator": ms_est, "ms_graph_by_estimator": graph_est,
        "plain_ms_by_estimator": plain_est,
        "ms_unbiased_inline": ms_inline,
        "ms_graph_unbiased_inline": graph_inline, "ms_unbiased_k100": ms_k100,
        "layout": topk_layout._asdict(),
        "median_network_share": network_share,
        "ptxas": _ptxas_registers(_build.build_log("mach_topk"), "topk_lane"),
    })
    gemm_ms = kernel_ms(lambda: meta2d @ multihot)
    del multihot
    print(f"kernel mach_decode: graph {rows[0]['ms_graph']:.4f} ms (library "
          f"{rows[0]['library_ms_graph']:.4f}), table hash "
          f"{rows[0]['ms_table']:.4f} ms (graph "
          f"{rows[0]['ms_table_graph']:.4f}); "
          f"layout {rows[0]['layout']}; ptxas {rows[0]['ptxas']} [{smi}]",
          flush=True)
    for row in rows:
        print(f"kernel {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
              f"({row['library']}; over materialized sums alone "
              f"{row['library_ms_materialized']:.4f} ms), bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), launches "
              f"{row['launches']} [{smi}]", flush=True)
    print(f"kernel mach_topk by estimator (k={K_MAIN}, table): "
          + ", ".join(f"{e} {ms_est[e]:.4f} ms (graph {graph_est[e]:.4f}, "
                      f"plain {plain_est[e]:.4f})" for e in ESTIMATORS)
          + f"; unbiased inline {ms_inline:.4f} ms (graph {graph_inline:.4f})"
            f"; unbiased k=100 {ms_k100:.4f} ms; layout "
            f"{topk_layout._asdict()}; the median ran its sorting network "
            f"on {network_share:.4f} of its (warp, class, query slot) steps; "
            f"ptxas {rows[1]['ptxas']} [{smi}]", flush=True)
    print(f"yardstick: the multi-hot f32 GEMM alone {gemm_ms:.4f} ms [{smi}]",
          flush=True)
    return rows, {"head": head, "params": params, "batch": batch,
                  "table": table}


# ---------------------------------------------------------------------------
# phase 4b: the candidate decode main path at full ODP and ImageNet-21k
# width, and the JAX package's gate shape
# ---------------------------------------------------------------------------

def _candidate_bounds(meta, ids, inv, table, n, r, b, k, num_classes,
                      gathers):
    """Least time (ms) for kernel 8 and for kernel 7 on this card, and
    what bounds each.  Kernel 8: the ``gathers`` probability values its
    early stop leaves on these inputs (``pool_gathers``), one f32
    operation each, vs the bytes of the probabilities, tau and ids, the
    distinct inverted rows this batch touches (and, in table mode, the
    table entries of the classes in them), counted once, and the
    outputs.  Kernel 7: N·R·B comparisons vs the probabilities read and
    tau and ids written."""
    from repro_torch.kernels import mach_candidates as mc
    m, ell = ids.shape[-1], inv.shape[1]
    rows = torch.unique(mc.candidate_chunks(ids, b))
    classes = None
    if table is not None:
        cls = torch.unique(inv[rows.long()])
        classes = int((cls < num_classes).sum())
    k8 = bound_of(mc.work(n, r, b, m, ell, k, num_classes, table is not None,
                          gathers=gathers, rows=rows.numel(),
                          classes=classes), F32_OPS_PER_S)
    return k8, _topm_bound(n, r, b, m)


def _topm_bound(n, r, b, m) -> tuple[float, str]:
    """Least time (ms) for kernel 7 (``mach_candidates.topm_work``: N·R·B
    comparisons, the probabilities read and tau and ids written)."""
    from repro_torch.kernels import mach_candidates as mc
    return bound_of(mc.topm_work(n, r, b, m), F32_OPS_PER_S)


def _topm_timed(dev) -> dict:
    """Kernel 7 beside its plain version and ``torch.topk`` at the
    TOPM_TIMED shapes, on random softmax rows."""
    from repro_torch.kernels import mach_candidates as mc

    smi = _nvidia_smi()
    out = {}
    for label, n, r, b, m in TOPM_TIMED:
        meta = _inputs(n, r, b, False, seed=b + m, dev=dev)
        row = {"shape": f"N={n} R={r} B={b} m={m}",
               "path": mc.topm_layout(b, m).path,
               "ms": kernel_ms(lambda: mc.bucket_topm_cuda(meta, m)),
               "ms_graph": graph_ms(lambda: mc.bucket_topm_cuda(meta, m)),
               "plain_ms": kernel_ms(lambda: mc.bucket_topm(meta, m)),
               "library_ms": kernel_ms(lambda: torch.topk(meta, m, dim=-1)),
               "library_ms_graph": graph_ms(
                   lambda: torch.topk(meta, m, dim=-1))}
        row["bound_ms"], row["bound_by"] = _topm_bound(n, r, b, m)
        out[label] = row
        print(f"kernel bucket_topm {label} ({row['shape']}, {row['path']}): "
              f"{row['ms']:.4f} ms (graph {row['ms_graph']:.4f}), plain "
              f"{row['plain_ms']:.4f}, torch.topk "
              f"{row['library_ms']:.4f} (graph "
              f"{row['library_ms_graph']:.4f}), bound {row['bound_ms']:.5f} "
              f"({row['bound_by']}) [{smi}]", flush=True)
    return out


def _planted_probs(dev, n, r, b, coeffs, shift, num_classes, seed,
                   n_plant=20, lo=5.0, hi=9.0):
    """A trained-head-like batch, after the JAX benchmark's generator:
    per row, ``n_plant`` random classes get a logit boost U(lo, hi) in
    every repetition's bucket of them, over N(0, 1) noise logits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    classes = torch.randint(0, num_classes, (n, n_plant), generator=gen,
                            device=dev)
    w = lo + (hi - lo) * torch.rand((n, n_plant), generator=gen, device=dev)
    hc = ((coeffs[None, :, None] * classes[:, None, :]) & 0xFFFFFFFF) >> shift
    noise = torch.randn((n, r, b), generator=gen, device=dev)
    boost = torch.zeros((n, r, b), device=dev).scatter_add_(
        2, hc, w[:, None, :].expand(n, r, n_plant).contiguous())
    return torch.softmax(noise + boost, -1)


def _recall(got, want) -> float:
    k = want.shape[1]
    return sum(len(set(a) & set(c)) for a, c in
               zip(got.tolist(), want.tolist())) / (k * want.shape[0])


def _check_decoded(name, kv, ki, pv, pi) -> float:
    """Decoded candidate answers vs the plain path's: (-inf, -1) slots
    in the same positions, values and ids equal."""
    dead = ki < 0
    if not torch.equal(dead, pi < 0) or not (kv[dead] == -torch.inf).all():
        fail(f"{name}: filtered slots out of place")
    if not torch.isfinite(kv[~dead]).all():
        fail(f"{name}: non-finite values")
    err = float((kv[~dead] - pv[~dead]).abs().max()) if (~dead).any() else 0.0
    if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
        fail(f"{name}: answer != plain path's (max err {err})")
    return err


def _imagenet_serving(dev):
    from repro_torch.configs.odp_mach import IMAGENET
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import ExtremeDataConfig, ExtremeDataset
    head = MACHLinear(IMAGENET.mach(), IMAGENET.dim)
    params = head.init(torch.Generator(device=dev).manual_seed(1), device=dev)
    data = ExtremeDataset(ExtremeDataConfig(IMAGENET.num_classes, IMAGENET.dim),
                          device=dev)
    x, _ = data.batch_at(0, N_MAIN)
    return {"head": head, "params": params, "batch": x,
            "table": head.table(dev)}


def phase_candidate_main_path(dev, odp: dict, checks: dict) -> list[dict]:
    from repro_torch.core import estimators as est
    from repro_torch.kernels import _build
    from repro_torch.kernels import mach_candidates as mc
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    models = {"odp": odp, "imagenet21k": _imagenet_serving(dev)}
    for ctx in models.values():
        cfg = ctx["head"].cfg
        ctx["K"], ctx["R"], ctx["B"] = (cfg.num_classes, cfg.num_repetitions,
                                        cfg.num_buckets)
        ctx["inv"] = ctx["head"].inverted_table(dev)
        ctx["meta"] = ctx["head"].meta_probs(ctx["params"], ctx["batch"])
        ctx["meta_nrb"] = ctx["meta"].movedim(0, -2).contiguous()
        ctx["exact"] = {e: (ctx["B"], ctx["R"]) for e in ESTIMATORS}
    approx_m = {"odp": 2, "imagenet21k": 4}
    for name, ctx in models.items():
        ctx["approx"] = {e: (approx_m[name], 1 if e == "unbiased" else 2)
                         for e in ESTIMATORS}
    torch.cuda.synchronize()
    print(f"candidate main path: set-up {time.perf_counter() - t0:.1f} s; "
          + "; ".join(f"{name} K={c['K']} B={c['B']} R={c['R']} L="
                      f"{c['inv'].shape[1]}" for name, c in models.items()),
          flush=True)

    def answer(ctx, e, setting):
        return est.predict_topk(ctx["meta"], ctx["table"], K_MAIN, e,
                                candidate_mode=ctx[setting][e],
                                inverted=ctx["inv"])

    # the main path's run: counts from 0, read just after
    mc.bucket_topm_cuda.launches = 0
    mc.mach_candidate_topk_cuda.launches = 0
    out, peak_gib = {}, {}
    for name, ctx in models.items():
        torch.cuda.reset_peak_memory_stats(dev)
        for e in ESTIMATORS:
            for setting in ("exact", "approx"):
                out[name, e, setting] = answer(ctx, e, setting)
        out[name, "predict"] = ctx["head"].predict(
            ctx["params"], ctx["batch"], candidate_mode=(ctx["B"], ctx["R"]))
        torch.cuda.synchronize()
        peak_gib[name] = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {"bucket_topm": mc.bucket_topm_cuda.launches,
                "mach_candidate_topk": mc.mach_candidate_topk_cuda.launches}
    smi = _nvidia_smi()
    print(f"candidate main path launches: {launches}, peak memory "
          + ", ".join(f"{name} {v:.2f} GiB" for name, v in peak_gib.items())
          + f" [{smi}]", flush=True)
    for kname, count in launches.items():
        if count < 1:
            fail(f"kernel {kname} never launched on the candidate main path")

    # right answers: exact mode == streaming bit for bit; predict ==
    # mach_top1 up to near-ties; approximate == the plain path
    err = checks["max_abs_err"]
    recall = {}
    for name, ctx in models.items():
        K = ctx["K"]
        sums = md.summed_scores(ctx["meta_nrb"], ctx["table"])
        for e in ESTIMATORS:
            cv, ci = out[name, e, "exact"]
            sv, si = est.predict_topk(ctx["meta"], ctx["table"], K_MAIN, e)
            if tuple(ci.shape) != (N_MAIN, K_MAIN) or not torch.isfinite(cv).all():
                fail(f"{name} exact {e}: wrong shape or non-finite values")
            if not (torch.equal(cv, sv) and torch.equal(ci, si)):
                fail(f"{name} {e}: exact-mode candidates != streaming kernel")
            av, ai = out[name, e, "approx"]
            m, t = ctx["approx"][e]
            sub = ctx["meta_nrb"][:16]
            tau, ids = mc.bucket_topm(sub, m)
            pv, pi = mc.finish_candidates(
                *mc.mach_candidate_topk_plain(
                    sub, tau, ids, ctx["inv"], ctx["table"], num_classes=K,
                    k=K_MAIN, t=t, estimator=e),
                ctx["R"], ctx["B"], e)
            err = max(err, _check_decoded(f"{name} approx {e} (m={m}, t={t})",
                                          av[:16], ai[:16], pv, pi))
            recall[name, e] = _recall(ai, si)
        _, top1 = ops.mach_top1(ctx["meta_nrb"], ctx["table"], num_classes=K)
        pred = out[name, "predict"].long()
        a = torch.gather(sums, 1, top1.long()[:, None])
        c = torch.gather(sums, 1, pred[:, None])
        if not torch.allclose(a, c, rtol=1e-6, atol=0):
            fail(f"{name}: candidate predict disagrees with mach_top1 beyond "
                 f"near-ties")
        n_same = int((top1.long() == pred).sum())
        print(f"candidate answers ok ({name}): exact mode == streaming kernel "
              f"bit for bit for {', '.join(ESTIMATORS)}; predict(candidate_mode="
              f"({ctx['B']}, {ctx['R']})) == mach_top1 on {n_same}/{N_MAIN}, the "
              f"rest near-ties; approximate == plain on 16 queries; recall@"
              f"{K_MAIN} vs streaming (information, random weights): "
              + ", ".join(f"{e} (m, t)={ctx['approx'][e]} "
                          f"{recall[name, e]:.3f}" for e in ESTIMATORS),
              flush=True)

    timings = {}
    for name, ctx in models.items():
        for e in ESTIMATORS:
            stream_ms = wall_ms(lambda: est.predict_topk(
                ctx["meta"], ctx["table"], K_MAIN, e))
            for setting in ("exact", "approx"):
                timings[name, e, setting] = wall_ms(
                    lambda: answer(ctx, e, setting))
            print(f"answer {name} predict_topk[{e},k={K_MAIN}] from meta: "
                  f"streaming {stream_ms:.3f} ms/batch, candidates exact "
                  f"{ctx['exact'][e]} {timings[name, e, 'exact']:.3f}, approx "
                  f"{ctx['approx'][e]} {timings[name, e, 'approx']:.3f} [{smi}]",
                  flush=True)
        full = wall_ms(lambda: ctx["head"].predict(
            ctx["params"], ctx["batch"], candidate_mode=(ctx["B"], ctx["R"])))
        print(f"answer {name} predict(candidate_mode=({ctx['B']}, {ctx['R']})) "
              f"with the projection: {full:.3f} ms/batch [{smi}]", flush=True)

    # kernel, plain, library and streaming times on the main path's inputs
    by_setting, gathers = {}, {}
    for name, ctx in models.items():
        meta, inv, table = ctx["meta_nrb"], ctx["inv"], ctx["table"]
        K, R, B = ctx["K"], ctx["R"], ctx["B"]
        for setting in ("exact", "approx"):
            for e in ESTIMATORS:
                m, t = ctx[setting][e]
                tau, ids = mc.bucket_topm_cuda(meta, m)
                kw = {"num_classes": K, "k": K_MAIN, "t": t, "estimator": e}
                fam = ctx["head"].cfg.family
                inline_kw = {"inline_coeffs": fam.coeffs_tensor(dev),
                             "inline_shift": fam.shift}
                row = {
                    "m": m, "t": t,
                    "ms": kernel_ms(lambda: mc.mach_candidate_topk_cuda(
                        meta, tau, ids, inv, table, **kw), iters=5, warmup=1),
                    "ms_graph": graph_ms(lambda: mc.mach_candidate_topk_cuda(
                        meta, tau, ids, inv, table, **kw), iters=5),
                    # the same work with the hash recomputed in-register
                    # instead of read from the (R, K) table
                    "inline_ms": kernel_ms(lambda: mc.mach_candidate_topk_cuda(
                        meta, tau, ids, inv, **kw, **inline_kw), iters=5,
                        warmup=1),
                    "inline_ms_graph": graph_ms(
                        lambda: mc.mach_candidate_topk_cuda(
                            meta, tau, ids, inv, **kw, **inline_kw), iters=5),
                    "layout": mc.cand_layout(
                        N_MAIN, R, B, m, inv.shape[1], K_MAIN,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)._asdict(),
                    "plain_ms": kernel_ms(lambda: mc.mach_candidate_topk_plain(
                        meta, tau, ids, inv, table, **kw), iters=2, warmup=1),
                    "streaming_ms": kernel_ms(lambda: mt.mach_topk_cuda(
                        meta, table, num_classes=K, k=K_MAIN, estimator=e)),
                    "topm_ms": kernel_ms(lambda: mc.bucket_topm_cuda(meta, m)),
                    "topm_ms_graph": graph_ms(
                        lambda: mc.bucket_topm_cuda(meta, m)),
                    "topm_plain_ms": kernel_ms(lambda: mc.bucket_topm(meta, m)),
                    "topm_library_ms": kernel_ms(
                        lambda: torch.topk(meta, m, dim=-1)),
                    "topm_library_ms_graph": graph_ms(
                        lambda: torch.topk(meta, m, dim=-1)),
                    "topm_path": mc.topm_layout(B, m).path,
                }
                if (name, m) not in gathers:
                    gathers[name, m] = mc.pool_gathers(meta, tau, ids, inv,
                                                       table, num_classes=K)
                row["gathers"] = gathers[name, m]
                (row["bound_ms"], row["bound_by"]), \
                    (row["topm_bound_ms"], row["topm_bound_by"]) = \
                    _candidate_bounds(meta, ids, inv, table, N_MAIN, R, B,
                                      K_MAIN, K, row["gathers"])
                by_setting[f"{name} {setting} {e}"] = row
                print(f"kernel mach_candidate_topk {name} {e} (m, t)=({m}, {t})"
                      f": {row['ms']:.4f} ms (graph {row['ms_graph']:.4f}; "
                      f"inline hash {row['inline_ms']:.4f}, graph "
                      f"{row['inline_ms_graph']:.4f}; layout "
                      f"{row['layout']}), plain {row['plain_ms']:.4f} ms, "
                      f"library: none (no single PyTorch call computes the "
                      f"filter), streaming kernel 2 {row['streaming_ms']:.4f} "
                      f"ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}; "
                      f"{row['gathers']} gathers); "
                      f"bucket_topm ({row['topm_path']}) "
                      f"{row['topm_ms']:.4f} ms (graph "
                      f"{row['topm_ms_graph']:.4f}), plain "
                      f"{row['topm_plain_ms']:.4f}, torch.topk "
                      f"{row['topm_library_ms']:.4f} (graph "
                      f"{row['topm_library_ms_graph']:.4f}), bound "
                      f"{row['topm_bound_ms']:.5f} ({row['topm_bound_by']}) "
                      f"[{smi}]", flush=True)

    gate = phase_candidate_gate(dev)
    primary = by_setting["odp exact unbiased"]
    shape = (f"odp: N={N_MAIN} R={odp['R']} B={odp['B']} K={odp['K']} "
             f"L={odp['inv'].shape[1]} k={K_MAIN} table hash, unbiased, exact "
             f"mode (m, t)=({odp['B']}, {odp['R']})")
    rows = [{
        "name": "bucket_topm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_candidates.cu",
        "replaces": "src/repro/kernels/mach_candidates.py:140",
        "launches": launches["bucket_topm"],
        "max_abs_err": checks["topm_max_abs_err"],
        "ms": primary["topm_ms"], "plain_ms": primary["topm_plain_ms"],
        "ms_graph": primary["topm_ms_graph"],
        "library_ms_graph": primary["topm_library_ms_graph"],
        "timing": TIMING,
        "bound_ms": primary["topm_bound_ms"],
        "bound_by": primary["topm_bound_by"],
        "library_ms": primary["topm_library_ms"],
        "shape": f"N={N_MAIN} R={odp['R']} B={odp['B']} m={odp['B']} (odp "
                 f"exact mode)",
        "ms_by_setting": {key: {f: v[f] for f in ("m", "topm_path", "topm_ms",
                                                   "topm_ms_graph",
                                                   "topm_plain_ms",
                                                   "topm_library_ms",
                                                   "topm_library_ms_graph",
                                                   "topm_bound_ms")}
                          for key, v in by_setting.items()},
        "gate_ms": gate["topm_ms"], "gate_ms_graph": gate["topm_ms_graph"],
        "ms_lm_and_gate": _topm_timed(dev),
        "checks_by_path": checks["topm_by_path"],
        "ptxas": _ptxas_registers(_build.build_log("mach_candidates"),
                                  "topm_"),
    }, {
        "name": "mach_candidate_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_candidates.cu",
        "replaces": "src/repro/kernels/mach_candidates.py:377",
        "launches": launches["mach_candidate_topk"], "max_abs_err": err,
        "ms": primary["ms"], "plain_ms": primary["plain_ms"],
        "bound_ms": primary["bound_ms"], "bound_by": primary["bound_by"],
        "gathers": primary["gathers"],
        "library_ms": None, "streaming_ms": primary["streaming_ms"],
        "shape": shape,
        "ms_graph": primary["ms_graph"], "timing": TIMING,
        "ms_by_setting": {key: {f: v[f] for f in (
            "m", "t", "ms", "ms_graph", "inline_ms", "inline_ms_graph",
            "layout", "plain_ms", "streaming_ms", "gathers", "bound_ms",
            "bound_by")} for key, v in by_setting.items()},
        "ms_lm_engine": _cand_lm_timed(dev),
        "answer_ms": {" ".join(key): v for key, v in timings.items()},
        "peak_gib": peak_gib, "gate": gate,
        "checks_by_layout": checks["cand_by_layout"],
        "ptxas": _ptxas_registers(_build.build_log("mach_candidates"),
                                  "cand_"),
    }]
    return rows


def _cand_lm_timed(dev) -> dict:
    """Kernel 8 at the LM engine's candidate settings, (2048, 8) (exact)
    and (16, 2), on its 4-slot pool (N=4, R=8, B=2,048, K=256,000, the
    model's inline hash, k=50), unbiased, on random softmax rows: events
    and graph replay, the plain version and the bound."""
    from repro_torch.configs import get_config
    from repro_torch.core.hashing import inverted_table
    from repro_torch.kernels import mach_candidates as mc

    mach = get_config("recurrentgemma-2b").mach
    fam = mach.family
    r, b, num_classes = mach.num_repetitions, mach.num_buckets, mach.num_classes
    inv = inverted_table(fam.table_np(num_classes), b, device=dev)
    hash_kw = {"inline_coeffs": fam.coeffs_tensor(dev),
               "inline_shift": fam.shift}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = _nvidia_smi()
    out = {}
    for m, t in ((b, r), LM_CAND_APPROX):
        meta = _inputs(LM_SLOTS, r, b, False, seed=m, dev=dev)
        tau, ids = mc.bucket_topm(meta, m)
        kw = {"num_classes": num_classes, "k": LM_TOP_K, "t": t, **hash_kw}
        row = {"ms": kernel_ms(lambda: mc.mach_candidate_topk_cuda(
                   meta, tau, ids, inv, **kw)),
               "ms_graph": graph_ms(lambda: mc.mach_candidate_topk_cuda(
                   meta, tau, ids, inv, **kw)),
               "plain_ms": kernel_ms(lambda: mc.mach_candidate_topk_plain(
                   meta, tau, ids, inv, **kw), iters=2, warmup=1),
               "gathers": mc.pool_gathers(meta, tau, ids, inv,
                                          num_classes=num_classes, **hash_kw),
               "layout": mc.cand_layout(LM_SLOTS, r, b, m, inv.shape[1],
                                        LM_TOP_K, sms)._asdict()}
        (row["bound_ms"], row["bound_by"]), _ = _candidate_bounds(
            meta, ids, inv, None, LM_SLOTS, r, b, LM_TOP_K, num_classes,
            row["gathers"])
        got = mc.mach_candidate_topk_cuda(meta, tau, ids, inv, **kw)
        want = mc.mach_candidate_topk_plain(meta, tau, ids, inv, **kw)
        torch.cuda.synchronize()
        _check_candidates(f"candidates lm ({m}, {t})", got, want)
        out[f"({m}, {t})"] = row
        print(f"kernel mach_candidate_topk at the LM engine ({m}, {t}), "
              f"N={LM_SLOTS} R={r} B={b} K={num_classes} k={LM_TOP_K} inline "
              f"hash: {row['ms']:.4f} ms (graph {row['ms_graph']:.4f}), plain "
              f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.5f} "
              f"({row['bound_by']}; {row['gathers']} gathers); layout "
              f"{row['layout']} [{smi}]", flush=True)
    return out


def phase_candidate_gate(dev) -> dict:
    """The JAX package's decode gate shape (K=1,048,576, R=16, B=8192,
    N=8, m=12, inline multiply-shift), where the streaming kernel
    refuses R·B: the candidate kernels vs the plain streaming top-k."""
    from repro_torch.core.hashing import MultShiftFamily, inverted_table
    from repro_torch.kernels import mach_candidates as mc
    from repro_torch.kernels import mach_topk as mt

    g = GATE
    fam = MultShiftFamily(g["B"], g["R"], seed=0)
    coeffs, shift = fam.coeffs_tensor(dev), fam.shift
    inv = inverted_table(fam.table_np(g["K"]), g["B"], device=dev)
    meta = _planted_probs(dev, g["N"], g["R"], g["B"], coeffs, shift, g["K"],
                          seed=7)
    flat = _inputs(g["N"], g["R"], g["B"], False, seed=9, dev=dev)
    hash_kw = {"inline_coeffs": coeffs, "inline_shift": shift}
    smi = _nvidia_smi()
    res = {"shape": f"N={g['N']} R={g['R']} B={g['B']} K={g['K']} "
                    f"L={inv.shape[1]} k={g['k']} m={g['m']} inline hash",
           "topm_ms": kernel_ms(lambda: mc.bucket_topm_cuda(meta, g["m"])),
           "topm_ms_graph": graph_ms(
               lambda: mc.bucket_topm_cuda(meta, g["m"]))}
    tau, ids = mc.bucket_topm_cuda(meta, g["m"])
    res["gathers"] = mc.pool_gathers(meta, tau, ids, inv, num_classes=g["K"],
                                     **hash_kw)
    for e in ESTIMATORS:
        t = GATE_T[e]

        def cand(p, e=e, t=t):
            return mc.mach_candidate_topk(p, inv, num_classes=g["K"], k=g["k"],
                                          m=g["m"], t=t, estimator=e, **hash_kw)

        def stream(p, e=e):
            return mt.mach_topk_plain(p, num_classes=g["K"], k=g["k"],
                                      estimator=e, **hash_kw)

        kw = {"num_classes": g["K"], "k": g["k"], "t": t, "estimator": e}
        row = {"t": t,
               "ms": kernel_ms(lambda: mc.mach_candidate_topk_cuda(
                   meta, tau, ids, inv, **kw, **hash_kw), iters=10),
               "ms_graph": graph_ms(lambda: mc.mach_candidate_topk_cuda(
                   meta, tau, ids, inv, **kw, **hash_kw), iters=10),
               "decode_ms": kernel_ms(lambda: cand(meta), iters=10),
               "plain_streaming_ms": kernel_ms(lambda: stream(meta), iters=3),
               "recall_at_k": _recall(cand(meta)[1], stream(meta)[1]),
               "recall_at_k_flat_random": _recall(cand(flat)[1],
                                                  stream(flat)[1])}
        (row["bound_ms"], row["bound_by"]), _ = _candidate_bounds(
            meta, ids, inv, None, g["N"], g["R"], g["B"], g["k"], g["K"],
            res["gathers"])
        res[e] = row
        print(f"gate {res['shape']} {e} t={t}: kernel 8 {row['ms']:.4f} ms "
              f"(graph {row['ms_graph']:.4f}), "
              f"candidate decode (kernels 7 + 8 + decode) {row['decode_ms']:.4f}"
              f" ms vs plain streaming top-k {row['plain_streaming_ms']:.4f} ms "
              f"(the streaming kernel refuses R·B={g['R'] * g['B']}); bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}; {res['gathers']} "
              f"gathers); recall@{g['k']} "
              f"{row['recall_at_k']:.3f} planted, "
              f"{row['recall_at_k_flat_random']:.3f} flat-random [{smi}]",
              flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 5: fused-xent kernels vs their plain versions, forward and backward
# ---------------------------------------------------------------------------

# loss and lse: rtol 1e-5 (f32 products and sums in another order than
# cuBLAS / torch.logsumexp); gradients rtol 1e-4, atol 1e-6 (the dense
# kernel reduces dW, dh and dbias with float atomics across blocks, in an
# order that changes from run to run; the ELL and gather kernels sum each
# dW element and dbias in a fixed order of their own, so their backwards
# return the same bits every run).  Inputs at the model's own scales: unit
# L2 rows of features (as the data generators make them), dense W at its
# init scale 1/sqrt(d), and a N(0, 1) bias so each head's softmax is far
# from uniform; at those scales the f32 order noise of a d-long product
# stays below atol in entries that cancel to near zero.
LOSS_TOL = {"rtol": 1e-5, "atol": 1e-6}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}
# dense checks: (label, N, d, R, B) — ragged N; B=37 is no multiple of 32
# and R·B = 259 no multiple of the 128-column tile
XENT_DENSE_SHAPES = [("odp", 37, 2000, 25, 32),
                     ("imagenet21k", 37, 6144, 20, 512),
                     ("odd", 29, 333, 7, 37)]
# the dense kernel with bf16 operands: each shape above and the LM head's
# (recurrentgemma-2b's N = 2 x 4,096 tokens, d = 2,560, R = 8, B = 2,048).
# The kernel rounds dlogits to bf16 before its products (the plain version
# keeps them float32), so per gradient tensor the largest error is held to
# 2^-7 of its largest entry and the relative L2 error to 2^-8; loss and
# lse stay at LOSS_TOL (both sides sum exact bf16 products in float32).
XENT_DENSE_LM = ("lm head", 8192, 2560, 8, 2048)
BF16_GRAD_MAX, BF16_GRAD_L2 = 2.0 ** -7, 2.0 ** -8
# sparse checks: (label, N, d, R, B, nnz_max)
XENT_SPARSE_SHAPES = [("odp nnz=120", 37, 50000, 25, 32, 120),
                      ("odp nnz=1024", 11, 50000, 25, 32, 1024),
                      ("odd", 29, 3001, 7, 37, 50)]
N_TRAIN = 512


def _csr_check_batch(dev, n, d, nnz_max, seed):
    """A CSR batch with a row at exactly nnz_max holding duplicate ids,
    a short row, an empty row and ragged rest."""
    from repro_torch.data.extreme import SparseBatch
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(1, nnz_max + 1, (n,), generator=gen, device=dev)
    lengths[0], lengths[1], lengths[2] = nnz_max, 2, 0
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(lengths, 0)])
    total = int(indptr[-1])
    indices = torch.randint(0, d, (total,), generator=gen, device=dev)
    indices[1:4] = indices[0]
    values = torch.rand((total,), generator=gen, device=dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev), lengths)
    sq = torch.zeros(n, device=dev).index_add_(0, rows, values * values)
    values = values / torch.sqrt(sq.clamp(min=1e-12))[rows]    # unit rows
    return SparseBatch(indptr.to(torch.int32), indices.to(torch.int32), values,
                       d, nnz_max)


def _loss_and_grads(fn, leaves, g):
    """(loss, lse, grads) of fn() -> (loss, lse), under cotangent g."""
    loss, lse = fn()
    grads = torch.autograd.grad((loss * g).sum(), leaves)
    torch.cuda.synchronize()
    return loss.detach(), lse, [t.detach() for t in grads]


def _compare(tag, got, want, names) -> float:
    """Kernel (loss, lse, grads) vs plain; returns the max abs error."""
    err = 0.0
    pairs = [("loss", got[0], want[0], LOSS_TOL), ("lse", got[1], want[1], LOSS_TOL)]
    pairs += [(f"d{name}", a, b, GRAD_TOL)
              for name, a, b in zip(names, got[2], want[2])]
    for name, a, b, tol in pairs:
        if not torch.isfinite(a).all():
            fail(f"{tag}: non-finite kernel {name}")
        e = float((a - b).abs().max())
        if not torch.allclose(a, b, **tol):
            fail(f"{tag}: kernel {name} differs from plain by up to {e}")
        err = max(err, e)
    return err


def _compare_bf16(tag, got, want, names) -> float:
    """bf16 kernel (loss, lse, grads) vs plain; returns the max abs error."""
    err = 0.0
    for name, a, b in (("loss", got[0], want[0]), ("lse", got[1], want[1])):
        if not torch.isfinite(a).all():
            fail(f"{tag}: non-finite kernel {name}")
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, **LOSS_TOL):
            fail(f"{tag}: kernel {name} differs from plain by up to "
                 f"{float((a - b).abs().max())}")
    for name, a, b in zip(names, got[2], want[2]):
        if a.dtype != torch.bfloat16 or not torch.isfinite(a).all():
            fail(f"{tag}: kernel d{name} is {a.dtype}, finite "
                 f"{bool(torch.isfinite(a).all())}")
        diff = a.float() - b.float()
        e, top = float(diff.abs().max()), float(b.float().abs().max())
        rel = float(diff.norm() / b.float().norm())
        if e > BF16_GRAD_MAX * top or rel > BF16_GRAD_L2:
            fail(f"{tag}: kernel d{name} max error {e} (largest entry {top}), "
                 f"relative L2 {rel}")
        err = max(err, e)
    return err


# the float32 card test's inputs (tests/test_torch_cuda.py): N(0, 1)
# features, so dW entries of order 1 cancel to near 0 and float32 rounding
# of either side shows at atol 1e-6; 16 seeds each, with and without bias
XENT_F64_SHAPES = [(70, 200, 25, 32), (130, 256, 2, 300)]
XENT_F64_SEEDS = 16


def _dense_f64_yardstick(dev) -> dict:
    """The float32 kernel and the float32 plain version (cuBLAS) each
    against the plain version in float64, at GRAD_TOL / LOSS_TOL: the
    kernel must have no violation.  Returns both sides' violations and
    largest gradient errors."""
    from repro_torch.kernels import mach_fused_xent as mfx
    out = {"kernel_violations": 0, "plain_violations": 0,
           "kernel_max_err": 0.0, "plain_max_err": 0.0}
    for n, d, r, b in XENT_F64_SHAPES:
        for seed in range(XENT_F64_SEEDS):
            for bias in (True, False):
                gen = torch.Generator(device=dev).manual_seed(seed)
                w = torch.randn((d, r * b), generator=gen, device=dev) / d ** 0.5
                bb = 0.1 * torch.randn((r * b,), generator=gen, device=dev) \
                    if bias else None
                y = torch.randint(0, b, (n, r), generator=gen, device=dev,
                                  dtype=torch.int32)
                g = torch.rand((n,), generator=gen, device=dev) + 0.5
                h = torch.randn((n, d), generator=gen, device=dev)
                leaves = [t.requires_grad_(True) for t in (h, w, bb)
                          if t is not None]
                exact = [t.detach().double().requires_grad_(True)
                         for t in leaves]
                want = _loss_and_grads(lambda: mfx.fused_xent_dense_plain(
                    *exact[:2], exact[2] if bias else None, y, b), exact,
                    g.double())
                for side, fn in (("kernel", mfx.mach_fused_xent_dense),
                                 ("plain", mfx.fused_xent_dense_plain)):
                    got = _loss_and_grads(lambda: fn(h, w, bb, y, b), leaves, g)
                    for a, e, tol in ((got[0], want[0], LOSS_TOL),
                                      (got[1], want[1], LOSS_TOL),
                                      *((x, z, GRAD_TOL)
                                        for x, z in zip(got[2], want[2]))):
                        e = e.float()
                        out[f"{side}_violations"] += int(
                            (~torch.isclose(a, e, **tol)).sum())
                    out[f"{side}_max_err"] = max(
                        out[f"{side}_max_err"],
                        *(float((x - z.float()).abs().max())
                          for x, z in zip(got[2], want[2])))
    if out["kernel_violations"]:
        fail(f"dense float32 kernel vs the float64 plain version: "
             f"{out['kernel_violations']} entries outside tolerance")
    print(f"fused xent dense float32 against the float64 plain version at "
          f"N(0, 1) features ({len(XENT_F64_SHAPES) * XENT_F64_SEEDS * 2} "
          f"cases): kernel {out['kernel_violations']} entries outside "
          f"LOSS_TOL / GRAD_TOL, largest gradient error "
          f"{out['kernel_max_err']:.3e}; cuBLAS float32 plain "
          f"{out['plain_violations']}, {out['plain_max_err']:.3e}", flush=True)
    return out


def _run_to_run(fn, leaves, g) -> float:
    """Largest difference between the gradients of two backward runs."""
    a = _loss_and_grads(fn, leaves, g)[2]
    b = _loss_and_grads(fn, leaves, g)[2]
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def phase_xent_vs_plain(dev) -> dict:
    """Each family's kernels (forward + backward) against the plain
    version, with and without bias.  Returns per family the max abs
    error and the run-to-run backward difference."""
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import ops

    stats = {f: {"max_abs_err": 0.0, "run_to_run": 0.0}
             for f in ("dense", "dense_bf16", "dense_lm_bf16", "ell", "gather")}

    def record(family, err, r2r):
        s = stats[family]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["run_to_run"] = max(s["run_to_run"], r2r)

    dense_cases = [(shape, torch.float32, "dense") for shape in XENT_DENSE_SHAPES]
    dense_cases += [(shape, torch.bfloat16, "dense_bf16")
                    for shape in XENT_DENSE_SHAPES]
    dense_cases.append((XENT_DENSE_LM, torch.bfloat16, "dense_lm_bf16"))
    for (label, n, d, r, b), dtype, key in dense_cases:
        for bias in (True, False):
            gen = torch.Generator(device=dev).manual_seed(d + b)
            h = torch.nn.functional.normalize(
                torch.randn((n, d), generator=gen, device=dev), dim=1)
            w = torch.randn((d, r * b), generator=gen, device=dev) / d ** 0.5
            bb = torch.randn((r * b,), generator=gen, device=dev) \
                if bias else None
            y = torch.randint(0, b, (n, r), generator=gen, device=dev,
                              dtype=torch.int32)
            g = torch.rand((n,), generator=gen, device=dev) + 0.5
            h, w, bb = (None if t is None else t.to(dtype) for t in (h, w, bb))
            leaves = [t.requires_grad_(True) for t in (h, w, bb) if t is not None]
            names = ["h", "W"] + (["bias"] if bias else [])
            kern = lambda: mfx.mach_fused_xent_dense(h, w, bb, y, b)
            compare = _compare if dtype == torch.float32 else _compare_bf16
            err = compare(f"dense {label} {dtype} bias={bias}",
                          _loss_and_grads(kern, leaves, g),
                          _loss_and_grads(lambda: mfx.fused_xent_dense_plain(
                              h, w, bb, y, b), leaves, g), names)
            record(key, err, _run_to_run(kern, leaves, g))
            del leaves, h, w, bb
        print(f"fused xent vs plain: dense {label} (N={n}, d={d}, R={r}, "
              f"B={b}) {dtype} ok, with and without bias", flush=True)

    for label, n, d, r, b, nnz_max in XENT_SPARSE_SHAPES:
        batch = _csr_check_batch(dev, n, d, nnz_max, seed=nnz_max)
        cols, vals = ops.csr_to_ell(batch.indptr, batch.indices, batch.values,
                                    nnz_max, d)
        for bias in (True, False):
            gen = torch.Generator(device=dev).manual_seed(d + b + nnz_max)
            # unit rows of W's products: logits of order 1 from the
            # product itself (dW does not scale with W)
            w = torch.randn((d, r * b), generator=gen, device=dev)
            bb = torch.randn((r * b,), generator=gen, device=dev) \
                if bias else None
            y = torch.randint(0, b, (n, r), generator=gen, device=dev,
                              dtype=torch.int32)
            g = torch.rand((n,), generator=gen, device=dev) + 0.5
            leaves = [t.requires_grad_(True) for t in (w, bb) if t is not None]
            names = ["W"] + (["bias"] if bias else [])
            want = _loss_and_grads(lambda: mfx.fused_xent_ell_plain(
                cols, vals, w, bb, y, b), leaves, g)
            for impl, family in (("densify", "ell"), ("gather", "gather")):
                kern = lambda f=family: getattr(mfx, f"mach_fused_xent_{f}")(
                    cols, vals, w, bb, y, b)
                err = _compare(f"{family} {label} bias={bias}",
                               _loss_and_grads(kern, leaves, g), want, names)
                via_ops = ops.mach_fused_xent_csr(
                    batch.indptr, batch.indices, batch.values, w, y,
                    num_buckets=b, nnz_max=nnz_max, bias=bb,
                    sparse_impl=impl).detach()
                if not torch.allclose(via_ops, want[0], **LOSS_TOL):
                    fail(f"ops.mach_fused_xent_csr(sparse_impl={impl!r}) "
                         f"{label}: loss differs from plain")
                record(family, err, _run_to_run(kern, leaves, g))
        print(f"fused xent vs plain: ell and gather {label} (N={n}, d={d}, "
              f"R={r}, B={b}, nnz_max={nnz_max}, duplicates, empty and short "
              f"rows) ok, with and without bias", flush=True)
    stats["dense_f64"] = _dense_f64_yardstick(dev)
    for family, s in stats.items():
        if family == "dense_f64":
            continue
        how = ("no float atomics: must be 0" if family in ("ell", "gather")
               else "float atomics")
        print(f"fused xent {family}: max abs error vs plain "
              f"{s['max_abs_err']:.3e}; largest backward difference between "
              f"two runs {s['run_to_run']:.3e} ({how})", flush=True)
    for family in ("ell", "gather"):
        if stats[family]["run_to_run"] != 0.0:
            fail(f"{family} backward: two runs differ by up to "
                 f"{stats[family]['run_to_run']} (it has no float atomics)")
    return stats


# ---------------------------------------------------------------------------
# phase 6: the training main path at full width
# ---------------------------------------------------------------------------

def _bound(family, n, d, r, b, nnz=0, unique=0, j=0, dtype=torch.float32,
           need_dh=False):
    """Least time (ms) for the forward and the backward on this card, and
    what bounds each (``mach_fused_xent.work``, with the bias): the
    dense family's operations on the tensor cores — bf16 at the bf16
    rate, float32 as 3xTF32, three TF32 products an operation at the
    TF32 rate; the sparse families' float32 operations over this batch's
    ``nnz`` valid slots and its ``unique`` W rows.  The main path's dense
    backward runs without dh (its input features need no gradient)."""
    from repro_torch.kernels import mach_fused_xent as mfx
    if family == "dense":
        rate = BF16_TOPS_PER_S if dtype == torch.bfloat16 \
            else TF32_OPS_PER_S / 3
        kw = dict(dtype=dtype, need_dh=need_dh)
    else:
        rate, kw = F32_OPS_PER_S, dict(j=j, nnz=nnz, unique=unique)
    return [bound_of(mfx.work(family, n, d, r, b, backward=bwd, **kw), rate)
            for bwd in (False, True)]


def _train(head, params, batch_at, steps, opt, state):
    """``steps`` AdamW steps; returns (params, state, losses, step ms,
    first step's (params before, batch, loss, grads))."""
    from repro_torch.optim import apply_updates, value_and_grad
    losses, times, first = [], [], None
    for s in range(steps):
        x, y = batch_at(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(head.loss, params, x, y)
        upd, state = opt.update(grads, state, params)
        new = apply_updates(params, upd)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if s == 0:
            first = (params, (x, y), loss, grads)
        params = new
        del upd, grads
    return params, state, losses, times, first


def phase_training(dev, checks: dict) -> list[dict]:
    import dataclasses
    from repro_torch.configs.odp_mach import IMAGENET, ODP
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import (ExtremeDataConfig, ExtremeDataset,
                                          SparseExtremeDataset)
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    odp_head = MACHLinear(ODP.mach(), ODP.dim, fused=True)
    odp_params = odp_head.init(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    odp_data = SparseExtremeDataset(ODP.sparse_data(small=False), device=dev)
    bow_data = SparseExtremeDataset(
        dataclasses.replace(ODP.sparse_data(small=False), nnz=1024), device=dev)
    img_cfg = IMAGENET.mach()
    img_head = MACHLinear(img_cfg, IMAGENET.dim, fused=True)
    img_params = img_head.init(torch.Generator(device=dev).manual_seed(1),
                               device=dev)
    img_data = ExtremeDataset(ExtremeDataConfig(IMAGENET.num_classes,
                                                IMAGENET.dim), device=dev)
    torch.cuda.synchronize()
    print(f"training main path: set-up {time.perf_counter() - t0:.1f} s",
          flush=True)

    runs = {  # name: (head, params, batch_at, steps, family)
        "odp": (odp_head, odp_params,
                lambda s: odp_data.batch_at(s, N_TRAIN), 5, "ell"),
        "odp_bow": (odp_head, None,
                    lambda s: bow_data.batch_at(s, N_TRAIN), 2, "gather"),
        "imagenet21k": (img_head, img_params,
                        lambda s: img_data.batch_at(s, N_TRAIN), 3, "dense"),
    }
    opt = adamw(0.05)
    results = {}
    # the main path's run: counts from 0, read just after
    for fn in mfx.CUDA_WRAPPERS:
        fn.launches = 0
    odp_state = None
    for name, (head, params, batch_at, steps, family) in runs.items():
        if name == "odp_bow":        # the same ODP model, trained on
            params, state = results["odp"]["params"], odp_state
        else:
            state = opt.init(params)
        torch.cuda.reset_peak_memory_stats(dev)
        # the column order is one launch both sparse families share: its
        # count is taken around each run
        orders = mfx.gather_column_order_cuda.launches
        params, state, losses, times, first = _train(head, params, batch_at,
                                                     steps, opt, state)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        results[name] = {"params": params, "losses": losses, "times": times,
                         "first": first, "peak_gib": peak, "family": family,
                         "head": head, "state": state,
                         "column_order": mfx.gather_column_order_cuda.launches
                         - orders}
        if name == "odp":
            odp_state = state
        print(f"train {name}: {steps} AdamW steps through {family}, losses "
              f"{[round(v, 4) for v in losses]}, peak memory {peak:.2f} GiB",
              flush=True)
    launches = {fn.__name__: fn.launches for fn in mfx.CUDA_WRAPPERS}
    print(f"training main path launches: {launches}", flush=True)
    for fn_name, count in launches.items():
        if count < 1:
            fail(f"{fn_name} never launched on the training main path")
    for name, res in results.items():
        if not all(math.isfinite(v) for v in res["losses"]):
            fail(f"train {name}: non-finite loss {res['losses']}")
    r0 = results["odp"]["losses"][0]
    if abs(r0 - ODP.mach_r * math.log(ODP.mach_b)) > 5.0:
        fail(f"ODP first loss {r0} far from R ln B at random init")

    smi = _nvidia_smi()
    rows = []
    kernel_names = {"dense": ("mach_fused_xent_dense",
                              "src/repro/kernels/mach_fused_xent.py:724"),
                    "ell": ("mach_fused_xent_ell",
                            "src/repro/kernels/mach_fused_xent.py:848"),
                    "gather": ("mach_fused_xent_gather",
                               "src/repro/kernels/mach_fused_xent.py:983")}
    for name, res in results.items():
        head, family = res["head"], res["family"]
        params0, (x, y), loss0, grads0 = res["first"]
        c = head.cfg
        n, r, b, d = N_TRAIN, c.num_repetitions, c.num_buckets, head.dim
        w2 = params0["w"].reshape(d, -1).detach().requires_grad_(True)
        bias = params0["b"].reshape(-1).detach().requires_grad_(True)
        labels = c.hash_labels(y).movedim(0, -1).to(torch.int32).contiguous()
        g = torch.full((n,), 1.0 / n, device=dev)
        if family == "dense":
            inputs = (x.contiguous(),)
            plain = lambda: mfx.fused_xent_dense_plain(x, w2, bias, labels, b)
            fwd, bwd = mfx.dense_fwd_cuda, mfx.dense_bwd_cuda
            nnz = unique = j = 0
        else:
            cols, vals = ops.csr_to_ell(x.indptr, x.indices, x.values,
                                        x.nnz_max, d)
            inputs = (cols, vals)
            plain = lambda: mfx.fused_xent_ell_plain(cols, vals, w2, bias,
                                                     labels, b)
            fwd = getattr(mfx, f"{family}_fwd_cuda")
            bwd = getattr(mfx, f"{family}_bwd_cuda")
            valid = (cols >= 0) & (cols < d)
            nnz = int(valid.sum())
            unique = int(torch.unique(cols[valid]).numel())
            j = cols.shape[1]
        # first step == plain: the mean loss and its gradients (the
        # summed-loss scale is held by the checks above, at smaller N)
        pl, _, pgrads = _loss_and_grads(plain, [w2, bias], g)
        err = abs(float(loss0) - float(pl.sum() / n))
        if not math.isclose(float(loss0), float(pl.sum() / n), rel_tol=1e-5):
            fail(f"train {name}: first loss {float(loss0)} != plain "
                 f"{float(pl.sum() / n)}")
        for key, pg in (("w", pgrads[0]), ("b", pgrads[1])):
            kg = grads0[key].reshape(pg.shape)
            e = float((kg - pg).abs().max())
            if not torch.allclose(kg, pg, **GRAD_TOL):
                fail(f"train {name}: first-step d{key} differs from plain by {e}")
            print(f"train {name}: first-step d{key} max abs error {e:.3e} "
                  f"(largest entry {float(pg.abs().max()):.3e})", flush=True)
            err = max(err, e)
        # stage times on the first step's inputs (CUDA events)
        _, lse = fwd(*inputs, w2.detach(), bias.detach(), labels, b)
        ms_fwd = kernel_ms(lambda: fwd(*inputs, w2.detach(), bias.detach(),
                                       labels, b), iters=10)
        bwd_kw = {"need_dh": False} if family == "dense" else {}
        ms_bwd = kernel_ms(lambda: bwd(*inputs, w2.detach(), bias.detach(),
                                       labels, lse, g, b, **bwd_kw), iters=10)
        ms_fwd_graph = graph_ms(lambda: fwd(*inputs, w2.detach(),
                                            bias.detach(), labels, b),
                                iters=10)
        ms_bwd_graph = graph_ms(lambda: bwd(*inputs, w2.detach(),
                                            bias.detach(), labels, lse, g, b,
                                            **bwd_kw), iters=10)
        state = res["state"]
        ms_adamw = kernel_ms(lambda: opt.update(grads0, state, params0),
                             iters=5, warmup=1)
        plain_ms = kernel_ms(lambda: _loss_and_grads(plain, [w2, bias], g),
                             iters=3, warmup=1)
        library_ms = kernel_ms(
            lambda: _library_xent(family, x, w2, bias, labels, b, n, r, d),
            iters=3, warmup=1)
        step_ms = statistics.median(res["times"][1:])
        (bf, byf), (bb_, byb) = _bound(family, n, d, r, b, nnz, unique, j)
        print(f"train {name}: {step_ms:.3f} ms/step (host clock, median of "
              f"steps 2..{len(res['times'])}); stages: forward kernel "
              f"{ms_fwd:.3f} ms, backward kernel {ms_bwd:.3f} ms (graph "
              f"{ms_fwd_graph:.3f} + {ms_bwd_graph:.3f}; the dense "
              f"backward's dW zero-fill included), AdamW {ms_adamw:.3f} ms; "
              f"peak "
              f"{res['peak_gib']:.2f} GiB [{smi}]", flush=True)
        kname, replaces = kernel_names[family]
        row = {
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": replaces,
            "launches": launches[f"{family}_fwd_cuda"]
            + launches[f"{family}_bwd_cuda"],
            "launches_fwd": launches[f"{family}_fwd_cuda"],
            "launches_bwd": launches[f"{family}_bwd_cuda"],
            # the column order's launches in this family's run
            "launches_bwd_pieces": (
                {k: launches[f"{family}_{k}_cuda"] for k in ("dlogits", "dw")}
                | {"column_order": res["column_order"]}
                if family != "dense" else None),
            "max_abs_err": err,
            "ms": ms_fwd + ms_bwd, "ms_fwd": ms_fwd, "ms_bwd": ms_bwd,
            "ms_graph": ms_fwd_graph + ms_bwd_graph,
            "ms_fwd_graph": ms_fwd_graph, "ms_bwd_graph": ms_bwd_graph,
            "plain_ms": plain_ms, "bound_ms": bf + bb_,
            "bound_by": byf if bf >= bb_ else byb,
            "bound_ms_fwd": bf, "bound_by_fwd": byf,
            "bound_ms_bwd": bb_, "bound_by_bwd": byb,
            "library_ms": library_ms,
            "shape": (f"{name}: N={n} d={d} R={r} B={b}"
                      + (f" ELL J={j}, {nnz} valid slots, {unique} "
                         f"distinct features" if family != "dense" else "")
                      + ", with bias; forward + backward"),
            "dtype": "float32",
            "train_step_ms": step_ms, "adamw_ms": ms_adamw,
            "peak_gib": res["peak_gib"],
            "check_max_abs_err": checks[family]["max_abs_err"],
            "run_to_run_max_diff": checks[family]["run_to_run"]}
        if family == "dense":
            row["ms_bwd_with_dh"] = kernel_ms(lambda: bwd(
                *inputs, w2.detach(), bias.detach(), labels, lse, g, b),
                iters=10)
            row["vs_float64_plain"] = checks["dense_f64"]
        rows.append(row)
        print(f"kernel {kname} ({name}): forward {ms_fwd:.4f} ms + backward "
              f"{ms_bwd:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{library_ms:.4f} ms, bound {bf:.4f} ({byf}) + {bb_:.4f} "
              f"({byb}) ms, launches {row['launches']}, first-step max abs "
              f"err {err:.3e} [{smi}]", flush=True)
        del res["params"], res["first"], res["state"]
    return rows


def _library_xent(family, x, w2, bias, labels, b, n, r, d):
    """The materializing computation in PyTorch library calls (never used
    by the port): the logits by torch.matmul (dense) or torch.sparse.mm
    on the CSR batch, F.cross_entropy on the (N·R, B) view, autograd."""
    leaves = [w2, bias]
    if family == "dense":
        logits = x @ w2
    else:
        csr = torch.sparse_csr_tensor(x.indptr.long(), x.indices.long(),
                                      x.values, size=(n, d))
        logits = torch.sparse.mm(csr, w2)
    logits = logits + bias
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(n * r, b), labels.reshape(-1).long(), reduction="sum")
    return torch.autograd.grad(loss / n, leaves)


def _kernel_label(mangled: str) -> str:
    """A mangled kernel entry shortened to its name and template values:
    ``top1_lane_kernel<1, 2>``, ``lru_scan_kernel<float32, 16, 32>``;
    kernel 4's as ``bwd_kernel<bf16, cp.async>`` (the dtype and whether
    tiles arrive by 16-byte cp.async or plain loads)."""
    m = re.search(r"\d+([a-z_]+_kernel)I(f|13__nv_bfloat16)Lb([01])", mangled)
    if m:
        return (f"{m[1]}<{'float32' if m[2] == 'f' else 'bf16'}, "
                f"{'cp.async' if m[3] == '1' else 'plain loads'}>")
    for m in re.finditer(r"\d+", mangled):      # <length><identifier>
        name = mangled[m.end():m.end() + int(m[0])]
        if name.endswith("_kernel"):
            rest = mangled[m.end() + len(name):]
            args = (re.findall(r"L[a-z]+(\d+)E", rest[:rest.find("Ev")])
                    if rest.startswith("I") else [])
            for code, dtype in (("If", "float32"),
                                ("I13__nv_bfloat16", "bf16")):
                if rest.startswith(code):         # a type argument first
                    args.insert(0, dtype)
            return f"{name}<{', '.join(args)}>" if args else name
    return mangled


def _ptxas_registers(log: str, prefix: str = "") -> dict:
    """Kernel entry -> 'N registers; spills' from an ``nvcc -Xptxas -v``
    log, for the entries whose label starts with ``prefix``."""
    out, entry, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = _kernel_label(line.split("'")[1])
            if not entry.startswith(prefix):
                entry = None
        elif entry and "spill" in line:
            spill = line.split(":")[-1].strip()
        elif entry and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            out[entry] = f"{regs}; {spill}"
            entry = None
    return out


def _peak_mib(fn) -> float:
    """Device memory a call allocates at its peak, above what was live."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _library_dense(leaves, labels, b, n, r):
    """Yardstick (never used by the port): the bf16 logits by torch.matmul,
    F.cross_entropy on the (N·R, B) view, autograd to h, W and bias."""
    h, w, bias = leaves
    logits = h @ w + bias
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(n * r, b), labels.reshape(-1).long(), reduction="sum")
    return torch.autograd.grad(loss / n, leaves)


def phase_dense_lm_head(dev, checks: dict, launches: int, smi: str) -> dict:
    """Kernel 4 at the LM head's shape in bf16 (the fused LM loss's call:
    forward, then the backward with dh): times, plain and library times,
    peak memory of each, bound, ptxas registers and shared memory.
    ``launches`` is the main path's count (the
    ImageNet-21k training run); phase 10's fused run adds the LM path's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mach_fused_xent as mfx

    label, n, d, r, b = XENT_DENSE_LM
    gen = torch.Generator(device=dev).manual_seed(17)
    h = torch.nn.functional.normalize(
        torch.randn((n, d), generator=gen, device=dev), dim=1).bfloat16()
    w = (torch.randn((d, r * b), generator=gen, device=dev) / d ** 0.5).bfloat16()
    bias = torch.randn((r * b,), generator=gen, device=dev).bfloat16()
    y = torch.randint(0, b, (n, r), generator=gen, device=dev, dtype=torch.int32)
    g = torch.full((n,), 1.0 / n, device=dev)
    _, lse = mfx.dense_fwd_cuda(h, w, bias, y, b)
    ms_fwd = kernel_ms(lambda: mfx.dense_fwd_cuda(h, w, bias, y, b), iters=10)
    ms_bwd = kernel_ms(lambda: mfx.dense_bwd_cuda(h, w, bias, y, lse, g, b,
                                                  need_dh=True), iters=10)
    leaves = [t.detach().requires_grad_(True) for t in (h, w, bias)]
    plain = lambda: _loss_and_grads(
        lambda: mfx.fused_xent_dense_plain(*leaves, y, b), leaves, g)
    kern = lambda: _loss_and_grads(
        lambda: mfx.mach_fused_xent_dense(*leaves, y, b), leaves, g)
    library = lambda: _library_dense(leaves, y, b, n, r)
    plain_ms = kernel_ms(plain, iters=3, warmup=1)
    library_ms = kernel_ms(library, iters=3, warmup=1)
    peaks = {"kernel": _peak_mib(kern), "plain": _peak_mib(plain),
             "library": _peak_mib(library)}
    (bf, byf), (bb_, byb) = _bound("dense", n, d, r, b, dtype=torch.bfloat16,
                                   need_dh=True)
    smem = _build.load("mach_fused_xent_dense").fused_xent_dense_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    row = {
        "name": "mach_fused_xent_dense", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_fused_xent_dense.cu",
        "replaces": "src/repro/kernels/mach_fused_xent.py:724",
        "launches": launches,
        "max_abs_err": checks["dense_lm_bf16"]["max_abs_err"],
        "ms": ms_fwd + ms_bwd, "ms_fwd": ms_fwd, "ms_bwd_with_dh": ms_bwd,
        "plain_ms": plain_ms, "bound_ms": bf + bb_,
        "bound_by": byf if bf >= bb_ else byb,
        "bound_ms_fwd": bf, "bound_by_fwd": byf,
        "bound_ms_bwd": bb_, "bound_by_bwd": byb,
        "library_ms": library_ms, "dtype": "bfloat16",
        "shape": (f"{label}: N={n} d={d} R={r} B={b}, bf16, with bias; "
                  f"forward + backward with dh"),
        "peak_mib_kernel": peaks["kernel"], "peak_mib_plain": peaks["plain"],
        "peak_mib_library": peaks["library"],
        "smem_bytes_fwd": smem(1, 0), "smem_bytes_bwd": smem(1, 1),
        "ptxas": _ptxas_registers(_build.build_log("mach_fused_xent_dense")),
        "run_to_run_max_diff": checks["dense_lm_bf16"]["run_to_run"]}
    print(f"kernel mach_fused_xent_dense ({label}, bf16): forward "
          f"{ms_fwd:.4f} ms + backward with dh {ms_bwd:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bf:.4f} "
          f"({byf}) + {bb_:.4f} ({byb}) ms; peak MiB kernel "
          f"{peaks['kernel']:.1f}, plain {peaks['plain']:.1f}, library "
          f"{peaks['library']:.1f}; "
          f"shared memory {row['smem_bytes_fwd']} / {row['smem_bytes_bwd']} "
          f"bytes [{smi}]", flush=True)
    return row


# ---------------------------------------------------------------------------
# phase 7: the LM substrate kernels (9 and 10) vs their plain versions
# ---------------------------------------------------------------------------

LRU_SHAPES = [(1, 4096, 2560), (2, 4096, 2560), (4, 1, 2560), (3, 37, 300),
              (2, 4097, 2570)]
# flash checks: (label, B, T, H, KV, hd, window, dtype) — the prefill
# shape of recurrentgemma-2b with and without its window, GQA, float32
FLASH_SHAPES = [
    ("recurrentgemma prefill", 1, 4096, 10, 1, 256, 2048, torch.bfloat16),
    ("recurrentgemma no window", 1, 4096, 10, 1, 256, None, torch.bfloat16),
    ("GQA ragged", 2, 1000, 8, 2, 128, None, torch.bfloat16),
    ("tinyllama hd 64, 32/4 heads", 1, 2048, 32, 4, 64, None, torch.bfloat16),
    ("phi3 hd 96, 32/32 heads", 1, 1000, 32, 32, 96, None, torch.bfloat16),
    ("ragged windowed hd 256", 2, 1111, 10, 1, 256, 300, torch.bfloat16),
    ("float32 windowed", 1, 777, 4, 1, 64, 100, torch.float32),
]
FLASH_F32_TOL = {"rtol": 1e-5, "atol": 1e-6}
# kernel 10's modes on phase 15's paths, as _flash_times cases: (label,
# B, T, S, H, KV, hd, causal, backward too, dtype).  The encoder and the
# cross-attention are non-causal, the cross-attention's S differs from
# T; 3,072 and 1,024 frames are multiples of chunk_k (JAX's flash
# recurrence reads all).
FLASH_NEW_MODES = [
    ("seamless encoder", 1, 3072, 3072, 16, 16, 64, False, False,
     torch.bfloat16),
    ("seamless cross", 1, 2048, 3072, 16, 16, 64, False, False,
     torch.bfloat16),
    ("seamless training cross", 2, 4096, 1024, 16, 16, 64, False, True,
     torch.bfloat16),
    ("seamless training decoder", 2, 4096, 4096, 16, 16, 64, True, True,
     torch.bfloat16),
    ("paligemma prefill", 1, 2048, 2048, 8, 1, 256, True, False,
     torch.bfloat16),
    ("paligemma training", 2, 4096, 4096, 8, 1, 256, True, True,
     torch.bfloat16),
]
LM_PROMPTS = (4096, 5, 77, 300)  # the 4,096-token one hits the flash branch
LM_SAMPLED = 2                   # index of the request sampled at T = 0.8
LM_MAX_NEW, LM_SLOTS, LM_MAX_LEN, LM_TOP_K = 16, 4, 4160, 50
# the LM head's decode checks: N=1 (after a prefill) and the decode pool
LM_HEAD_N, LM_HEAD_K = (1, LM_SLOTS), (1, LM_TOP_K)
LM_CAND_APPROX = (16, 2)         # an approximate (m, t) on the LM engine


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |x| (8 significand bits)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _bf16_row_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of each (query, head) row's
    largest output.  An output entry that cancels towards zero carries
    the error of its row's scale: e is rounded to bfloat16 from scores
    whose float32 sums ran in another order, and one e on the other side
    of a rounding boundary moves the row by p·|v|·2^-8."""
    scale = want.float().abs().amax(dim=-1, keepdim=True)
    return float(((got.float() - want.float()).abs() / _bf16_ulp(scale)).max())


def _flash_inputs(dev, b, t, h, kv, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, t, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dtype)
    return q, k, v


def phase_lm_kernels_vs_plain(dev) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls

    errs = {"lru_scan": 0.0, "flash_attention": 0.0}
    cases = 0
    for b, t, d in LRU_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(t)
        a = torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5
        x = torch.randn((b, t, d), generator=gen, device=dev)
        h0 = torch.randn((b, d), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and t > 64:
                continue
            got = ls.lru_scan_cuda(a.to(dtype), x.to(dtype), h0)
            want = ls.lru_scan_plain(a.to(dtype), x.to(dtype), h0)
            torch.cuda.synchronize()
            if got.dtype != dtype or not torch.equal(got, want):
                err = float((got.float() - want.float()).abs().max())
                fail(f"lru_scan {(b, t, d)} {dtype}: kernel != plain "
                     f"(max err {err})")
            cases += 1
    for label, b, t, h, kv, hd, window, dtype in FLASH_SHAPES:
        q, k, v = _flash_inputs(dev, b, t, h, kv, hd, dtype, seed=t + h)
        got = fa.flash_attention_cuda(q, k, v, window=window)
        want = fa.flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        if got.dtype != dtype or not torch.isfinite(got.float()).all():
            fail(f"flash_attention {label}: wrong dtype or non-finite output")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if dtype == torch.float32:
            ok = torch.allclose(got, want, **FLASH_F32_TOL)
        else:
            ulps = _bf16_row_ulps(got, want)
            ok = ulps <= 2.0
            print(f"flash_attention {label}: max {ulps:.2f} bf16 ulps of the "
                  f"row scale from plain (elementwise max "
                  f"{float((diff / _bf16_ulp(want)).max()):.1f})", flush=True)
        if not ok:
            fail(f"flash_attention {label}: kernel vs plain max abs err {err}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        cases += 1
    flash_new = _flash_times(dev, _nvidia_smi(), FLASH_NEW_MODES)
    cases += sum(1 + row["backward"] for row in flash_new.values())
    errs["flash_attention"] = max([errs["flash_attention"]] + [
        row["max_abs_err"] for row in flash_new.values()])
    head_cases, errs["lm_head"], head_ms = _lm_head_vs_plain(dev)
    return {"cases": cases, "head_cases": head_cases, "errs": errs,
            "lm_head_top1": head_ms, "lm_head_topk": _lm_head_topk_times(dev),
            "flash_new": flash_new}


def _flash_bound(b, t, s, h, kv, hd, causal, window, backward,
                 dtype) -> tuple:
    """(bound ms, what bounds it, GFLOP) of kernel 10
    (``flash_attention.work``: 4·hd flops an attended (query, key) pair
    and head forward, 10·hd backward, at the dtype's peak — bf16 tensor
    cores, float32 outside them; q, k, v and out, backward also dout and
    lse read and dq, dk and dv written, at HBM's rate)."""
    from repro_torch.kernels import flash_attention as fa
    work = fa.work(b, t, s, h, kv, hd, dtype, causal, window, backward)
    rate = BF16_TOPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound_of(work, rate) + (work[0] / 1e9,)


def _flash_times(dev, smi, cases) -> dict:
    """Kernel 10 at each case (label, B, T, S, H, KV, hd, causal,
    backward too, dtype), unwindowed: the output held to the plain
    version's on the same inputs by phase 7's rule (bf16: at most 2 ulps
    of each row's scale; float32: FLASH_F32_TOL), the backward's dq, dk
    and dv by phase 9's; then kernel (also by CUDA-graph replay), plain
    and library (SDPA, k/v expanded to H heads; its backward) ms beside
    the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    out = {}
    for label, b, t, s, h, kv, hd, causal, backward, dtype in cases:
        gen = torch.Generator(device=dev).manual_seed(t + s + hd)
        q, k, v, dout = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                         for shape in ((b, t, h, hd), (b, s, kv, hd),
                                       (b, s, kv, hd), (b, t, h, hd)))
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                         return_lse=True)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if o.dtype != dtype or not torch.isfinite(o.float()).all():
            fail(f"flash_attention {label}: wrong dtype or non-finite output")
        err = float((o.float() - want.float()).abs().max())
        if dtype == torch.float32:
            ulps = None
            ok = torch.allclose(o, want, **FLASH_F32_TOL)
        else:
            ulps = _bf16_row_ulps(o, want)
            ok = ulps <= 2.0
        if not ok:
            fail(f"flash_attention {label}: kernel != plain (max abs err "
                 f"{err:.3e}, bf16 row ulps {ulps})")
        bound, bound_by, gflop = _flash_bound(b, t, s, h, kv, hd, causal,
                                              None, False, dtype)
        qh, kh, vh = (z.transpose(1, 2).detach().requires_grad_(backward)
                      for z in (q, k.repeat_interleave(h // kv, 2),
                                v.repeat_interleave(h // kv, 2)))
        row = {"max_abs_err": err, "bf16_row_ulps": ulps,
               "ms": kernel_ms(lambda: fa.flash_attention_cuda(
                   q, k, v, causal=causal), iters=10),
               "ms_graph": graph_ms(lambda: fa.flash_attention_cuda(
                   q, k, v, causal=causal), iters=10),
               "plain_ms": kernel_ms(lambda: fa.flash_attention_plain(
                   q, k, v, causal=causal), iters=2, warmup=1),
               "library_ms": kernel_ms(lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, is_causal=causal), iters=10),
               "bound_ms": bound, "bound_by": bound_by, "gflop": gflop,
               "backward": backward,
               "shape": f"q ({b}, {t}, {h}, {hd}), k/v ({b}, {s}, {kv}, "
                        f"{hd}) {str(dtype).removeprefix('torch.')}, "
                        f"{'causal' if causal else 'non-causal'}"}
        report = ""
        if backward:
            got = fa.flash_attention_bwd_cuda(q, k, v, o, dout, lse,
                                              causal=causal)
            want_g = fa.flash_attention_bwd_plain(q, k, v, o, dout, lse,
                                                  causal=causal)
            torch.cuda.synchronize()
            g_ulps = {}
            for name, gv, wv in zip(("dq", "dk", "dv"), got, want_g):
                g_ulps[name] = _bf16_backward_ulps(gv, wv)
                if not torch.isfinite(gv.float()).all() or g_ulps[name] > 2.0:
                    fail(f"flash backward {label}: {name} {g_ulps[name]:.2f} "
                         f"bf16 ulps from plain")
            row["max_abs_err"] = max(err, max(
                float((gv.float() - wv.float()).abs().max())
                for gv, wv in zip(got, want_g)))
            bbound, bbound_by, bgflop = _flash_bound(b, t, s, h, kv, hd,
                                                     causal, None, True,
                                                     dtype)
            sdpa = F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal)
            do_h = dout.transpose(1, 2)
            row.update({
                "bwd_ulps": g_ulps,
                "bwd_ms": kernel_ms(lambda: fa.flash_attention_bwd_cuda(
                    q, k, v, o, dout, lse, causal=causal), iters=5),
                "bwd_plain_ms": kernel_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, o, dout, lse, causal=causal), iters=1, warmup=1),
                "bwd_library_ms": kernel_ms(lambda: torch.autograd.grad(
                    sdpa, (qh, kh, vh), do_h, retain_graph=True), iters=5,
                    warmup=2),
                "bwd_bound_ms": bbound, "bwd_bound_by": bbound_by,
                "bwd_gflop": bgflop})
            del sdpa
            report = (f"; backward {g_ulps} bf16 ulps from plain, "
                      f"{row['bwd_ms']:.4f} ms, plain "
                      f"{row['bwd_plain_ms']:.4f}, library "
                      f"{row['bwd_library_ms']:.4f} (SDPA backward), bound "
                      f"{bbound:.4f} ({bbound_by})")
        out[label] = row
        close = (f"{ulps:.2f} bf16 ulps of the row scale" if ulps is not None
                 else "within FLASH_F32_TOL")
        print(f"kernel flash_attention {label} ({row['shape']}): == plain "
              f"({close}, max abs err {err:.3e}); {row['ms']:.4f} ms, graph "
              f"{row['ms_graph']:.4f}, plain {row['plain_ms']:.4f}, library "
              f"{row['library_ms']:.4f} (SDPA), bound {bound:.4f} "
              f"({bound_by}), {gflop / row['ms']:.1f} TFLOP/s{report} "
              f"[{smi}]", flush=True)
        del q, k, v, dout, o, lse, want, qh, kh, vh
    torch.cuda.empty_cache()
    return out


def _prefill_case(arch, dtype=torch.bfloat16) -> tuple:
    """The ``_flash_times`` case of ``arch``'s causal prefill of
    DENSE_OTHER_PROMPTS[0] tokens at its heads and width, labelled by the
    arch (and " float32")."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    t = DENSE_OTHER_PROMPTS[0]
    label = arch if dtype == torch.bfloat16 else f"{arch} float32"
    return (label, 1, t, t, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, True, False, dtype)


def _lm_head_vs_plain(dev) -> tuple[int, float]:
    """Kernels 1 and 2 vs their plain versions at the LM head's shape
    and hash source, on dyadic and random probabilities."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt

    mach = get_config("recurrentgemma-2b").mach
    fam = mach.family
    r, b, num_classes = mach.num_repetitions, mach.num_buckets, mach.num_classes
    table = fam.table(num_classes, dev)
    hash_kw = {"inline_coeffs": fam.coeffs_tensor(dev),
               "inline_shift": fam.shift}
    cases, err = 0, 0.0
    for n in LM_HEAD_N:
        for dyadic in (True, False):
            meta = _inputs(n, r, b, dyadic, seed=n + 7, dev=dev)
            tag = f"LM head n={n} {'dyadic' if dyadic else 'random'} inline"
            kv, ki = md.mach_decode_cuda(meta, num_classes=num_classes,
                                         **hash_kw)
            pv, pi = md.mach_decode_plain(meta, num_classes=num_classes,
                                          **hash_kw)
            torch.cuda.synchronize()
            err = max(err, _check_same(f"top1 {tag}", kv, ki, pv, pi,
                                       md.summed_scores(meta, table), dyadic))
            cases += 1
            for est in ESTIMATORS:
                scores = mt.estimator_scores(meta, table, est)
                for k in LM_HEAD_K:
                    kv, ki = mt.mach_topk_cuda(meta, num_classes=num_classes,
                                               k=k, estimator=est, **hash_kw)
                    pv, pi = mt.mach_topk_plain(meta, num_classes=num_classes,
                                                k=k, estimator=est, **hash_kw)
                    torch.cuda.synchronize()
                    err = max(err, _check_same(f"topk {est} k={k} {tag}", kv,
                                               ki, pv, pi, scores, dyadic))
                    cases += 1
    print(f"LM head decode kernels vs plain: {cases} comparisons ok (R={r}, "
          f"B={b}, K={num_classes}, N in {LM_HEAD_N}, k in {LM_HEAD_K})",
          flush=True)
    return cases, err, _lm_head_top1_times(dev, table, hash_kw, b)


def _sparse_multihot(table: torch.Tensor, b: int) -> torch.Tensor:
    """The (K, R·B) multi-hot matrix of an (R, K) bucket table as sparse
    CSR, R ones a row (a dense one at an LM head takes gigabytes): the
    library calls' operand, ``torch.sparse.mm(multihot, meta2d.T)``."""
    r, k = table.shape
    dev = table.device
    cols = (torch.arange(r, device=dev)[:, None] * b + table.long()).T
    return torch.sparse_csr_tensor(
        torch.arange(0, k * r + 1, r, device=dev), cols.reshape(-1),
        torch.ones(k * r, device=dev), size=(k, r * b))


def _lm_head_top1_times(dev, table, hash_kw, b) -> dict:
    """Kernel 1 at the LM head's shape, N in LM_HEAD_N: kernel, plain and
    library ms.  The library call is the multi-hot product as a sparse
    (K, R·B) CSR matrix (R ones a row; a dense one would take 16.8 GB)
    against the probabilities, then ``torch.max``."""
    from repro_torch.kernels import mach_decode as md

    r, k = table.shape
    multihot = _sparse_multihot(table, b)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = _nvidia_smi()
    out = {}
    for n in LM_HEAD_N:
        meta = _inputs(n, r, b, False, seed=n, dev=dev)
        meta2d_t = meta.reshape(n, r * b).T.contiguous()
        row = {"mapping": md.decode_layout(n, r, b, k, sms).mapping,
               "ms": kernel_ms(lambda: md.mach_decode_cuda(
                   meta, num_classes=k, **hash_kw)),
               "ms_graph": graph_ms(lambda: md.mach_decode_cuda(
                   meta, num_classes=k, **hash_kw)),
               "plain_ms": kernel_ms(lambda: md.mach_decode_plain(
                   meta, num_classes=k, **hash_kw), iters=5),
               "library_ms": kernel_ms(lambda: torch.max(
                   torch.sparse.mm(multihot, meta2d_t), dim=0)),
               "library_ms_graph": graph_ms(lambda: torch.max(
                   torch.sparse.mm(multihot, meta2d_t), dim=0))}
        out[f"N={n}"] = row
        print(f"kernel mach_decode at the LM head (N={n}, R={r}, B={b}, "
              f"K={k}, inline hash, {row['mapping']}): {row['ms']:.4f} ms "
              f"(graph {row['ms_graph']:.4f}), "
              f"plain {row['plain_ms']:.4f}, library {row['library_ms']:.4f} "
              f"(graph {row['library_ms_graph']:.4f}; torch.max over a "
              f"sparse multi-hot product) [{smi}]",
              flush=True)
    return out


def _lm_head_topk_times(dev) -> dict:
    """Kernel 2 at the LM head's shape and the engine's k (N in
    LM_HEAD_N, k=50, inline hash, unbiased): kernel ms by events and graph
    replay, plain ms and the library call, ``torch.topk`` over the sparse
    multi-hot product (as ``_lm_head_top1_times``'s)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mach_topk as mt

    mach = get_config("recurrentgemma-2b").mach
    fam = mach.family
    r, b, k = mach.num_repetitions, mach.num_buckets, mach.num_classes
    table = fam.table(k, dev)
    hash_kw = {"inline_coeffs": fam.coeffs_tensor(dev),
               "inline_shift": fam.shift}
    multihot = _sparse_multihot(table, b)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = _nvidia_smi()
    out = {}
    for n in LM_HEAD_N:
        meta = _inputs(n, r, b, False, seed=n, dev=dev)
        meta2d_t = meta.reshape(n, r * b).T.contiguous()
        kw = {"num_classes": k, "k": LM_TOP_K, **hash_kw}
        row = {"mapping": mt.topk_layout(n, r, b, k, LM_TOP_K, sms).mapping,
               "ms": kernel_ms(lambda: mt.mach_topk_cuda(meta, **kw)),
               "ms_graph": graph_ms(lambda: mt.mach_topk_cuda(meta, **kw)),
               "plain_ms": kernel_ms(lambda: mt.mach_topk_plain(meta, **kw),
                                     iters=5),
               "library_ms": kernel_ms(lambda: torch.topk(
                   torch.sparse.mm(multihot, meta2d_t), LM_TOP_K, dim=0)),
               "library_ms_graph": graph_ms(lambda: torch.topk(
                   torch.sparse.mm(multihot, meta2d_t), LM_TOP_K, dim=0))}
        out[f"N={n}"] = row
        print(f"kernel mach_topk at the LM head (N={n}, R={r}, B={b}, K={k}, "
              f"k={LM_TOP_K}, inline hash, {row['mapping']}): {row['ms']:.4f} "
              f"ms (graph {row['ms_graph']:.4f}), plain {row['plain_ms']:.4f}, "
              f"library {row['library_ms']:.4f} (graph "
              f"{row['library_ms_graph']:.4f}; torch.topk over a sparse "
              f"multi-hot product) [{smi}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: full-width recurrentgemma-2b served by the slot engine
# ---------------------------------------------------------------------------

def _serve(model, params, prompts, after_first_tick=None,
           candidate_mode=None):
    """Serve the LM phase's requests on a fresh engine, one tick at a
    time.  Returns (tokens per request, ms per tick, seconds)."""
    from repro_torch.serving import (Request, SamplingParams, ServeConfig,
                                     ServingEngine)
    engine = ServingEngine(model, params, ServeConfig(
        max_len=LM_MAX_LEN, num_slots=LM_SLOTS, top_k=LM_TOP_K,
        max_new_tokens=LM_MAX_NEW, seed=0, candidate_mode=candidate_mode))
    for i, p in enumerate(prompts):
        sampling = SamplingParams(temperature=0.8) if i == LM_SAMPLED \
            else SamplingParams()
        engine.submit(Request(prompt=p[0].tolist(), sampling=sampling))
    torch.cuda.synchronize()
    results, tick_ms = [], []
    t0 = time.perf_counter()
    while engine.metrics.completed < len(prompts):
        t1 = time.perf_counter()
        results += engine.step()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t1) * 1e3)
        if after_first_tick is not None and len(tick_ms) == 1:
            after_first_tick()
    run_s = time.perf_counter() - t0
    if len(results) != len(prompts):
        fail(f"lm serve: {len(results)} of {len(prompts)} requests finished")
    return ([r.tokens for r in sorted(results, key=lambda r: r.request_id)],
            tick_ms, run_s)


def _lm_candidates(model, params, prompts, engine_tokens) -> dict:
    """The engine's candidate-filtered decode at the LM head's shape
    (R=8, B=2048, K=256,000, the model's inline hash): the same requests
    through ServeConfig(candidate_mode=(B, R)), which keeps every class a
    candidate and must give the streaming engine's tokens bit for bit,
    and through an approximate (m, t), whose greedy tokens are reported.
    Kernels 7 and 8 launch counts from 0 for each run."""
    from repro_torch.kernels import mach_candidates as mc

    mach = model.cfg.mach
    exact = (mach.num_buckets, mach.num_repetitions)
    res = {}
    for mode in (exact, LM_CAND_APPROX):
        mc.bucket_topm_cuda.launches = 0
        mc.mach_candidate_topk_cuda.launches = 0
        tokens, _, run_s = _serve(model, params, prompts, candidate_mode=mode)
        launches = {
            "bucket_topm": mc.bucket_topm_cuda.launches,
            "mach_candidate_topk": mc.mach_candidate_topk_cuda.launches}
        if min(launches.values()) < 1:
            fail(f"lm serve candidate_mode={mode}: kernels 7-8 launches "
                 f"{launches}")
        res[mode] = {"tokens": tokens, "launches": launches,
                     "run_ms": run_s * 1e3}
    if res[exact]["tokens"] != engine_tokens:
        fail(f"lm serve candidate_mode={exact}: tokens differ from the "
             f"streaming engine's")
    approx = res[LM_CAND_APPROX]["tokens"]
    same = sum(a == b for i in range(len(prompts)) if i != LM_SAMPLED
               for a, b in zip(approx[i], engine_tokens[i]))
    n_greedy = (len(prompts) - 1) * LM_MAX_NEW
    print(f"lm serve candidate_mode={exact} (exact): tokens == the streaming "
          f"engine's, bit for bit; kernels 7-8 launches "
          f"{res[exact]['launches']}, run {res[exact]['run_ms']:.1f} ms. "
          f"candidate_mode={LM_CAND_APPROX}: launches "
          f"{res[LM_CAND_APPROX]['launches']}, run "
          f"{res[LM_CAND_APPROX]['run_ms']:.1f} ms, greedy tokens "
          f"{[approx[i] for i in range(len(prompts)) if i != LM_SAMPLED]} "
          f"({same}/{n_greedy} equal to streaming's at the same step; random "
          f"weights)", flush=True)
    return {"exact_launches": res[exact]["launches"],
            "approx_launches": res[LM_CAND_APPROX]["launches"],
            "approx_greedy_same": same}


def _direct_greedy(model, params, prompts, engine_tokens, dev):
    """A greedy prefill + decode_step + next_token loop straight off the
    model API.  The requests sit in the same 4-row pool at the same slots
    as in the engine (on the card a matrix product's rows depend on the
    batch shape it runs at, not on the other rows), and the sampled row
    is fed the engine's sampled tokens."""
    pool = model.init_caches(LM_SLOTS, LM_MAX_LEN, device=dev)
    toks = []
    for i, p in enumerate(prompts):
        caches, h = model.prefill(params, p, LM_MAX_LEN)
        model.insert_cache_slot(pool, caches, i)
        toks.append([int(model.next_token(params, h)[0][0])])
    toks[LM_SAMPLED] = list(engine_tokens[LM_SAMPLED][:1])
    for step in range(1, LM_MAX_NEW):
        last = torch.tensor([t[-1] for t in toks], device=dev)
        pos = torch.tensor([p.shape[1] + step - 1 for p in prompts],
                           device=dev)
        pool, h = model.decode_step(params, pool, last, pos, per_slot=True)
        ids = model.next_token(params, h)[0].tolist()
        for i in range(LM_SLOTS):
            toks[i].append(engine_tokens[i][step] if i == LM_SAMPLED
                           else ids[i])
    return toks


def phase_lm_serve(dev, checks: dict) -> tuple[list[dict], dict]:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt
    from repro_torch.models import LanguageModel

    t0 = time.perf_counter()
    cfg = get_config("recurrentgemma-2b")
    model = LanguageModel(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    rng = np.random.default_rng(0)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               device=dev) for n in LM_PROMPTS]
    torch.cuda.synchronize()
    print(f"lm serve: recurrentgemma-2b full width ({cfg.num_layers} layers, "
          f"d={cfg.d_model}, V={cfg.vocab_size}, MACH B={cfg.mach.num_buckets}"
          f" R={cfg.mach.num_repetitions}), {n_params:,} params "
          f"(param_count_estimate {cfg.param_count_estimate():,}) = "
          f"{n_bytes / 1e9:.3f} GB; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the main path's run: counts from 0, read just after
    kernels = {"lru_scan": ls.lru_scan_cuda,
               "flash_attention": fa.flash_attention_cuda,
               "mach_decode": md.mach_decode_cuda,
               "mach_topk": mt.mach_topk_cuda}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    after_tick0 = {}

    def first_tick():
        after_tick0.update({n: fn.launches for n, fn in kernels.items()})

    engine_tokens, tick_ms, run_s = _serve(model, params, prompts, first_tick)
    served = {n: fn.launches for n, fn in kernels.items()}
    direct = _direct_greedy(model, params, prompts, engine_tokens, dev)
    torch.cuda.synchronize()
    in_loop = {n: fn.launches - served[n] for n, fn in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"lm serve launches: engine {served} (after the admission tick "
          f"{after_tick0}); direct greedy loop {in_loop}; peak "
          f"{peak_gib:.2f} GiB", flush=True)

    # checks: every request done, greedy == the direct loop, the kernels ran
    for i, toks in enumerate(engine_tokens):
        if len(toks) != LM_MAX_NEW or not all(0 <= t < cfg.vocab_size
                                              for t in toks):
            fail(f"lm serve: request {i} gave {toks}")
        if i != LM_SAMPLED and list(toks) != direct[i]:
            fail(f"lm serve: greedy request {i} (prompt {LM_PROMPTS[i]}) "
                 f"gave {list(toks)}, the direct loop {direct[i]}")
    n_attn = cfg.layout().count("attn_local")
    n_rec = cfg.layout().count("rglru")
    decode_ticks = len(tick_ms)
    if served["flash_attention"] != n_attn:
        fail(f"flash_attention launched {served['flash_attention']} times, "
             f"expected {n_attn} (the 4,096-token prefill)")
    if after_tick0["lru_scan"] < n_rec * len(prompts) or \
            served["lru_scan"] != n_rec * (len(prompts) + decode_ticks):
        fail(f"lru_scan launches {after_tick0['lru_scan']} / "
             f"{served['lru_scan']}: not one a recurrent layer per prefill "
             f"and decode step")
    if served["mach_topk"] < 1:
        fail("the engine's serve steps did not launch mach_topk")
    if in_loop["mach_decode"] < 1:
        fail("the direct greedy loop's next_token did not launch mach_decode")
    print(f"lm serve ok: {len(engine_tokens)} requests, greedy tokens == the direct "
          f"greedy loop; request 0 (4,096-token prompt): "
          f"{list(engine_tokens[0])}", flush=True)
    head_err = _lm_head_on_path(model, params, prompts)
    _flash_vs_dense(model, params, prompts[0], rng)
    cand = _lm_candidates(model, params, prompts, engine_tokens)

    # end-to-end times (host clock, synchronized): the same requests on a
    # fresh engine again, warm; then the decode step split into the model
    # step and the MACH head + top-k
    warm_tokens, warm_ms, warm_s = _serve(model, params, prompts)
    if warm_tokens != engine_tokens:
        fail("lm serve: a second run of the same requests gave other tokens")
    tokens = sum(len(t) for t in warm_tokens)
    decode_ms = statistics.median(warm_ms[1:])
    prefill_ms = wall_ms(lambda: model.prefill(params, prompts[0], LM_MAX_LEN),
                         runs=3, warmup=1)
    pool = model.init_caches(LM_SLOTS, LM_MAX_LEN, device=dev)
    last = torch.zeros((LM_SLOTS,), dtype=torch.int64, device=dev)
    pos = torch.full((LM_SLOTS,), 100, dtype=torch.int64, device=dev)
    step_ms = wall_ms(lambda: model.decode_step(params, pool, last, pos,
                                                per_slot=True))
    hidden = torch.randn((LM_SLOTS, cfg.d_model), device=dev).to(cfg.dtype)
    head_ms = wall_ms(lambda: model.topk_candidates(params, hidden, LM_TOP_K))
    smi = _nvidia_smi()
    print(f"lm serve: prefill of the 4,096-token prompt {prefill_ms:.3f} ms "
          f"(median of 3); pooled decode step {decode_ms:.3f} ms (engine "
          f"tick, warm run, median of {len(warm_ms) - 1}); alone, the model's "
          f"decode_step {step_ms:.3f} ms and the MACH head + top-k "
          f"{head_ms:.3f} ms (medians of 7); admission tick (4 prefills + a "
          f"decode step) {warm_ms[0]:.3f} ms warm, {tick_ms[0]:.3f} ms in "
          f"the first run; {tokens} tokens in {warm_s * 1e3:.1f} ms = "
          f"{tokens / warm_s:.1f} tokens/s warm ({tokens / run_s:.1f} in the "
          f"first run); params {n_bytes / 2**30:.2f} GiB, peak "
          f"{peak_gib:.2f} GiB [{smi}]", flush=True)

    # kernel times at the main path's shapes
    rows = []
    b, t, d = 1, LM_PROMPTS[0], cfg.resolved_rnn_width
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5
    x = torch.randn((b, t, d), generator=gen, device=dev)
    h0 = torch.zeros((b, d), device=dev)
    ms9 = kernel_ms(lambda: ls.lru_scan_cuda(a, x, h0))
    ms9_graph = graph_ms(lambda: ls.lru_scan_cuda(a, x, h0))
    a4, x4 = a[:, :1].expand(LM_SLOTS, 1, d).contiguous(), \
        x[:, :1].expand(LM_SLOTS, 1, d).contiguous()
    h04 = torch.zeros((LM_SLOTS, d), device=dev)
    ms9_decode = kernel_ms(lambda: ls.lru_scan_cuda(a4, x4, h04))
    ms9_decode_graph = graph_ms(lambda: ls.lru_scan_cuda(a4, x4, h04))
    plain9 = kernel_ms(lambda: ls.lru_scan_plain(a, x, h0), iters=3, warmup=1)
    bound9 = bound_of(ls.work(b, t, d, x.dtype), F32_OPS_PER_S)
    rows.append({
        "name": "lru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lru_scan.cu",
        "replaces": "src/repro/kernels/lru_scan.py:46",
        "launches": served["lru_scan"],
        "max_abs_err": checks["errs"]["lru_scan"],
        "ms": ms9, "ms_graph": ms9_graph, "plain_ms": plain9,
        "bound_ms": bound9[0], "bound_by": bound9[1],
        "library_ms": None,
        "shape": f"prefill (B, T, D)=({b}, {t}, {d}) float32",
        "ms_decode": ms9_decode, "ms_decode_graph": ms9_decode_graph,
        "shape_decode": f"decode ({LM_SLOTS}, 1, {d}) float32",
        "ptxas": _ptxas_registers(_build.build_log("lru_scan")),
        "timing": "ms by kernel_ms (CUDA events); *_graph by graph_ms "
                  "(CUDA-graph replay, device time)"})
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    window = cfg.local_window
    q, k, v = _flash_inputs(dev, b, t, h, kv, hd, cfg.dtype, seed=2)
    ms10 = kernel_ms(lambda: fa.flash_attention_cuda(q, k, v, window=window),
                     iters=10)
    plain10 = kernel_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                         window=window),
                        iters=3, warmup=1)
    pairs = fa.attended_pairs(t, window)
    bound10, bound10_by, gflop = _flash_bound(b, t, t, h, kv, hd, True, window,
                                              False, cfg.dtype)
    rows_i = torch.arange(t, device=dev)[:, None]
    cols_i = torch.arange(t, device=dev)[None, :]
    mask = (cols_i <= rows_i) & (cols_i > rows_i - window)
    qh, kh, vh = (z.transpose(1, 2) for z in (q, k.expand(b, t, h, hd),
                                              v.expand(b, t, h, hd)))
    library10 = kernel_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), iters=5, warmup=2)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": served["flash_attention"],
        "max_abs_err": checks["errs"]["flash_attention"],
        "ms": ms10, "plain_ms": plain10,
        "bound_ms": bound10, "bound_by": bound10_by,
        "library_ms": library10,
        "shape": (f"prefill q ({b}, {t}, {h}, {hd}), k/v ({b}, {t}, {kv}, "
                  f"{hd}) bfloat16, causal, window {window}: {pairs:,} "
                  f"attended pairs a head, {gflop:.1f} GFLOP"),
        "tflops_per_s": gflop / ms10})
    for row in rows:
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"kernel {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {lib}, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), launches "
              f"{row['launches']} on the LM serve path; {row['shape']} "
              f"[{smi}]", flush=True)
    print(f"kernel lru_scan: graph {ms9_graph:.4f} ms at the prefill; at "
          f"decode ({LM_SLOTS}, 1, {d}): {ms9_decode:.4f} ms, graph "
          f"{ms9_decode_graph:.4f} ms; kernel flash_attention {rows[1]['tflops_per_s']:.1f} TFLOP/s "
          f"[{smi}]", flush=True)
    print(f"kernel lru_scan ptxas (registers; spills): {rows[0]['ptxas']}",
          flush=True)
    lm = {"launches_engine": served, "launches_direct_loop": in_loop,
          "candidates": cand, "head_err": head_err, "prefill_ms": prefill_ms,
          "decode_step_ms": decode_ms, "tokens_per_s": tokens / warm_s,
          "peak_gib": peak_gib}
    return rows, lm


def _lm_head_on_path(model, params, prompts) -> float:
    """Kernels 1 and 2 vs plain on the path's own inputs: the head's
    probabilities at the four prompts' last hidden states, k = top_k."""
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt

    mach = model.cfg.mach
    hidden = torch.cat([model.prefill(params, p, LM_MAX_LEN)[1]
                        for p in prompts])
    meta = torch.softmax(model.mach_logits(params, hidden).float(), dim=-1)
    fam = mach.family
    table = fam.table(mach.num_classes, meta.device)
    hash_kw = {"inline_coeffs": fam.coeffs_tensor(meta.device),
               "inline_shift": fam.shift}
    kv, ki = md.mach_decode_cuda(meta, num_classes=mach.num_classes, **hash_kw)
    pv, pi = md.mach_decode_plain(meta, num_classes=mach.num_classes,
                                  **hash_kw)
    torch.cuda.synchronize()
    err = _check_same("LM path top1", kv, ki, pv, pi,
                      md.summed_scores(meta, table), False)
    for est in ESTIMATORS:
        kv, ki = mt.mach_topk_cuda(meta, num_classes=mach.num_classes,
                                   k=LM_TOP_K, estimator=est, **hash_kw)
        pv, pi = mt.mach_topk_plain(meta, num_classes=mach.num_classes,
                                    k=LM_TOP_K, estimator=est, **hash_kw)
        torch.cuda.synchronize()
        err = max(err, _check_same(f"LM path topk {est} k={LM_TOP_K}", kv, ki,
                                   pv, pi, mt.estimator_scores(meta, table,
                                                               est), False))
    print(f"lm serve: kernels 1 and 2 == plain on the path's head "
          f"probabilities ({tuple(meta.shape)}, k={LM_TOP_K}, 3 estimators), "
          f"max abs err {err:.3e}", flush=True)
    return err


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _flash_vs_dense(model, params, prompt, rng) -> None:
    """The long prefill through the flash branch against the same model
    on its dense branch (flash_threshold raised), then a decode step on
    the rolled ring caches against a dense prefill of one more token.

    Positions, indices, and the first attention layer's K/V (no attention
    runs before it) must be equal.  The rest is held to the model in
    float32 on the dense branch, as FlashAttention's tests hold their
    kernels: each bf16 result's relative L2 error there is at most twice
    the bf16 dense branch's, plus 2^-9 (half a bf16 ulp).  A wrong layout
    or a wrong ring offset gives errors of order one."""
    from repro_torch.models import LanguageModel
    from repro_torch.models.transformer import tree_map

    cfg, f32 = model.cfg, torch.float32
    dense = LanguageModel(dataclasses.replace(cfg, flash_threshold=1 << 30))
    truth = LanguageModel(dataclasses.replace(
        cfg, flash_threshold=1 << 30, dtype=f32, param_dtype=f32))
    params32 = tree_map(lambda x: x.float() if x.is_floating_point() else x,
                        params)
    t, dev = prompt.shape[1], prompt.device
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1,)), device=dev)
    longer = torch.cat([prompt, tok[None]], 1)
    runs = {}
    for name, m, p in (("flash", model, params), ("dense", dense, params),
                       ("float32", truth, params32)):
        caches, h = m.prefill(p, prompt, LM_MAX_LEN)
        run = {"hidden": [h]}
        for st in caches:
            for c in st:
                for field in c._fields:
                    # a copy: the decode step below writes in place
                    run.setdefault(field, []).append(getattr(c, field).clone())
        if name == "flash":   # position t overwrites ring row t mod window
            run["next"] = [model.decode_step(params, caches, tok,
                                             torch.tensor([t], device=dev),
                                             per_slot=True)[1]]
        else:
            run["next"] = [m.prefill(p, longer, LM_MAX_LEN)[1]]
        runs[name] = run
    del params32
    for field in ("positions", "index"):
        for name in ("dense", "float32"):
            if not all(torch.equal(a, b) for a, b in
                       zip(runs["flash"][field], runs[name][field])):
                fail(f"flash vs {name} prefill: cache {field} differ")
    if not (torch.equal(runs["flash"]["k"][0][0], runs["dense"]["k"][0][0]) and
            torch.equal(runs["flash"]["v"][0][0], runs["dense"]["v"][0][0])):
        fail("flash vs dense prefill: the first attention layer's K/V differ")
    report = []
    for field, got in runs["flash"].items():
        if field in ("positions", "index"):
            continue
        want = runs["float32"][field]
        e_flash = max(_rel_l2(a, b) for a, b in zip(got, want))
        e_dense = max(_rel_l2(a, b) for a, b in zip(runs["dense"][field], want))
        e_pair = max(_rel_l2(a, b) for a, b in zip(got, runs["dense"][field]))
        report.append(f"{field} {e_flash:.5f} / {e_dense:.5f} ({e_pair:.5f})")
        if not e_flash <= 2 * e_dense + 2.0 ** -9:
            fail(f"flash path vs float32 dense: {field} relative L2 "
                 f"{e_flash:.5f}, more than twice the bf16 dense branch's "
                 f"{e_dense:.5f} + 2^-9")
    print(f"lm serve: prefill of {t} tokens, flash vs dense — positions, index "
          f"and the first attention layer's K/V equal; relative L2 to float32 "
          f"dense, flash / bf16 dense (flash vs bf16 dense): "
          + "; ".join(report) + f" (next = a decode step on the rolled ring "
          f"vs a dense prefill of {t + 1} tokens); bound 2 x dense + 2^-9",
          flush=True)


# ---------------------------------------------------------------------------
# phase 9: the LM training kernels vs their plain versions
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 6
# kernel 3 checks: (N, R, B, dtype) — ragged N and B, then the path's
# shape (B·T rows of the recurrentgemma head, R=8, B=2048) in bf16
XENT_LM_SHAPES = [(13, 4, 16, torch.float32), (37, 5, 37, torch.float32),
                  (37, 5, 37, torch.bfloat16), (70, 8, 2048, torch.float32),
                  (TRAIN_BATCH * TRAIN_SEQ, 8, 2048, torch.bfloat16)]
XENT_TOL = {"rtol": 1e-5, "atol": 1e-5}
# kernel 9 backward checks: (B, T, D, dtype), nonzero h0
LRU_BWD_SHAPES = [(TRAIN_BATCH, TRAIN_SEQ, 2560, torch.float32),
                  (4, 1, 2560, torch.float32), (3, 37, 300, torch.float32),
                  (3, 37, 300, torch.bfloat16), (1, 1, 16, torch.float32),
                  (2, 4097, 2570, torch.float32)]
# kernel 10 backward checks: (label, B, T, H, KV, hd, causal, window, dtype)
FLASH_BWD_SHAPES = [
    ("recurrentgemma train", TRAIN_BATCH, TRAIN_SEQ, 10, 1, 256, True, 2048,
     torch.bfloat16),
    ("causal G=1", 1, 200, 4, 4, 64, True, None, torch.float32),
    ("windowed G=2", 2, 150, 4, 2, 32, True, 40, torch.float32),
    ("windowed G=10", 1, 300, 10, 1, 64, True, 100, torch.float32),
    ("no mask G=2", 1, 97, 4, 2, 16, False, None, torch.float32),
    ("GQA ragged", 2, 333, 8, 2, 128, True, None, torch.bfloat16),
    ("tinyllama hd 64, 32/4 heads", 1, 1024, 32, 4, 64, True, None,
     torch.bfloat16),
    ("phi3 hd 96, 32/32 heads", 1, 700, 32, 32, 96, True, None,
     torch.bfloat16),
    ("ragged windowed hd 256", 1, 333, 10, 1, 256, True, 100, torch.bfloat16),
    ("no mask hd 48", 1, 97, 4, 2, 48, False, None, torch.bfloat16),
    ("qwen2-moe train hd 128, 16/16 heads", TRAIN_BATCH, TRAIN_SEQ, 16, 16,
     128, True, None, torch.bfloat16),
]
FLASH_BWD_F32_TOL = {"rtol": 1e-4, "atol": 1e-5}


def _bf16_backward_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of each row's largest entry,
    after a float32 noise floor of 2^-20 of the tensor's largest entry: a
    query row that sees one key has P = 1 and an exact dQ of zero, and
    both compute float32 rounding noise of dP - D there."""
    scale = want.float().abs().amax(dim=-1, keepdim=True)
    floor = 2.0 ** -20 * float(want.float().abs().max())
    excess = ((got.float() - want.float()).abs() - floor).clamp_min(0.0)
    return float((excess / _bf16_ulp(scale)).max())


def phase_lm_train_kernels_vs_plain(dev) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_xent as mx

    errs = {"mach_xent_fwd": 0.0, "mach_xent_bwd": 0.0, "lru_scan_bwd": 0.0,
            "flash_attention_bwd": 0.0}
    cases = 0
    for n, r, b, dtype in XENT_LM_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(n + b)
        logits = (torch.randn((n, r, b), generator=gen, device=dev) * 3
                  ).to(dtype)
        labels = torch.randint(0, b, (n, r), generator=gen, device=dev,
                               dtype=torch.int32)
        labels[0], labels[-1] = 0, b - 1
        g = torch.randn((n,), generator=gen, device=dev)
        loss = mx.mach_xent_cuda_fwd(logits, labels)
        grad = mx.mach_xent_cuda_bwd(logits, labels, g)
        want_loss = mx.mach_xent_plain(logits, labels)
        want_grad = mx.mach_xent_grad_plain(logits, labels, g)
        torch.cuda.synchronize()
        tag = f"mach_xent {(n, r, b)} {dtype}"
        if not torch.allclose(loss, want_loss, **XENT_TOL):
            fail(f"{tag}: loss off by {float((loss - want_loss).abs().max())}")
        if grad.dtype != dtype:
            fail(f"{tag}: gradient in {grad.dtype}")
        if dtype == torch.float32:
            ok = torch.allclose(grad, want_grad, rtol=1e-5, atol=1e-7)
        else:
            ok = bool(torch.all((grad.float() - want_grad.float()).abs()
                                <= _bf16_ulp(want_grad)))
        if not ok:
            fail(f"{tag}: gradient off by "
                 f"{float((grad.float() - want_grad.float()).abs().max())}")
        errs["mach_xent_fwd"] = max(errs["mach_xent_fwd"],
                                    float((loss - want_loss).abs().max()))
        errs["mach_xent_bwd"] = max(errs["mach_xent_bwd"], float(
            (grad.float() - want_grad.float()).abs().max()))
        cases += 2
    for b, t, d, dtype in LRU_BWD_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(t + d)
        a = (torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5
             ).to(dtype)
        x = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
        h0 = torch.randn((b, d), generator=gen, device=dev)
        dh = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
        h = ls.lru_scan_cuda(a, x, h0)
        got = ls.lru_scan_bwd_cuda(a, h, h0, dh)
        want = ls.lru_scan_bwd_plain(a, h, h0, dh)
        torch.cuda.synchronize()
        if not torch.equal(h, ls.lru_scan_plain(a, x, h0)):
            fail(f"lru_scan {(b, t, d)} {dtype}: the forward feeding the "
                 f"backward check != plain")
        for name, gv, wv in zip(("da", "dx", "dh0"), got, want):
            if gv.dtype != wv.dtype or not torch.equal(gv, wv):
                fail(f"lru_scan backward {(b, t, d)} {dtype}: {name} kernel "
                     f"!= plain (max err "
                     f"{float((gv.float() - wv.float()).abs().max())})")
        cases += 1
    for label, b, t, h, kv, hd, causal, window, dtype in FLASH_BWD_SHAPES:
        q, k, v = _flash_inputs(dev, b, t, h, kv, hd, dtype, seed=t + hd)
        gen = torch.Generator(device=dev).manual_seed(t)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        plain_out = fa.flash_attention_cuda(q, k, v, causal=causal,
                                            window=window)
        out, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                          causal=causal, window=window)
        want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                            causal=causal, window=window)
        torch.cuda.synchronize()
        if not torch.equal(out, plain_out):
            fail(f"flash_attention {label}: the forward with lse differs from "
                 f"the forward without it")
        report = []
        for name, gv, wv in zip(("dq", "dk", "dv"), got, want):
            if gv.dtype != dtype or not torch.isfinite(gv.float()).all():
                fail(f"flash backward {label}: {name} wrong dtype or "
                     f"non-finite")
            err = float((gv.float() - wv.float()).abs().max())
            if dtype == torch.float32:
                ok = torch.allclose(gv, wv, **FLASH_BWD_F32_TOL)
                report.append(f"{name} {err:.2e}")
            else:
                ulps = _bf16_backward_ulps(gv, wv)
                ok = ulps <= 2.0
                report.append(f"{name} {ulps:.2f} ulps")
            if not ok:
                fail(f"flash backward {label}: {name} kernel vs plain max abs "
                     f"err {err}")
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], err)
        print(f"flash_attention backward {label} {dtype}: kernel vs plain "
              + ", ".join(report) + " (bf16: of each row's largest entry, "
              "past a 2^-20 float32 floor); forward with lse == without",
              flush=True)
        cases += 1
    return {"cases": cases, "errs": errs}


# ---------------------------------------------------------------------------
# phase 10: recurrentgemma-2b trained at full width
# ---------------------------------------------------------------------------

GRAD_GROUPS = ("embedding", "rglru", "attention", "mlp", "norms", "head")


def _grad_group(path: str) -> str:
    if path.startswith("embed"):
        return "embedding"
    if path.startswith("mach_head"):
        return "head"
    for key, group in (("rglru", "rglru"), ("attn", "attention"),
                       ("mlp", "mlp")):
        if f"/{key}/" in path:
            return group
    return "norms"


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{path}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{path}{i}/")]
    return [(path, tree)]


def _group_errors(grads, truth) -> dict:
    """Relative L2 error of each parameter group's gradient to ``truth``."""
    num = dict.fromkeys(GRAD_GROUPS, 0.0)
    den = dict.fromkeys(GRAD_GROUPS, 0.0)
    for (path, g), (_, t) in zip(_named_leaves(grads), _named_leaves(truth)):
        group = _grad_group(path)
        num[group] += float((g.float() - t.float()).square().sum())
        den[group] += float(t.float().square().sum())
    return {k: math.sqrt(num[k] / max(den[k], 1e-30)) for k in GRAD_GROUPS}


def _first_step_grads_vs_float32(model, params, batch) -> dict:
    """The first step's gradients of the bf16 flash path against the same
    model in float32 on the dense branch, with the bf16 dense branch's
    error as the yardstick: each group's relative L2 error at most twice
    the bf16 dense branch's, plus 2^-9."""
    from repro_torch.models import LanguageModel
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim import value_and_grad

    cfg, f32 = model.cfg, torch.float32
    dense = LanguageModel(dataclasses.replace(cfg, flash_threshold=1 << 30))
    truth_model = LanguageModel(dataclasses.replace(
        cfg, flash_threshold=1 << 30, dtype=f32, param_dtype=f32))
    params32 = tree_map(lambda x: x.float() if x.is_floating_point() else x,
                        params)
    (loss32, _), truth = value_and_grad(truth_model.loss, params32, batch,
                                        has_aux=True)
    del params32
    errs, losses = {}, {"float32": float(loss32)}
    for name, m in (("dense", dense), ("flash", model)):
        (loss, _), grads = value_and_grad(m.loss, params, batch, has_aux=True)
        errs[name] = _group_errors(grads, truth)
        losses[name] = float(loss)
        del grads
    del truth
    for group in GRAD_GROUPS:
        e_flash, e_dense = errs["flash"][group], errs["dense"][group]
        if not e_flash <= 2 * e_dense + 2.0 ** -9:
            fail(f"lm train: {group} gradients of the bf16 flash path are "
                 f"{e_flash:.5f} from float32, more than twice the bf16 dense "
                 f"branch's {e_dense:.5f} + 2^-9")
    print("lm train: first-step gradients, relative L2 to the float32 dense "
          "model, bf16 flash path / bf16 dense branch: "
          + "; ".join(f"{g} {errs['flash'][g]:.5f} / {errs['dense'][g]:.5f}"
                      for g in GRAD_GROUPS)
          + f" (bound 2 x dense + 2^-9); loss float32 {losses['float32']:.6f}"
          f", bf16 dense {losses['dense']:.6f}, bf16 flash "
          f"{losses['flash']:.6f}", flush=True)
    return {"errs": errs, "losses": losses}


def phase_lm_train(dev, checks: dict) -> tuple[list[dict], dict]:
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, SyntheticLMStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_xent as mx
    from repro_torch.models import LanguageModel
    from repro_torch.train import TrainConfig, Trainer, new_train_state

    t0 = time.perf_counter()
    cfg = get_config("recurrentgemma-2b")
    model = LanguageModel(cfg)
    # launch/train.py's TrainConfig: AdamW, warmup 2, peak 3e-4, clip 1.0
    tcfg = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=2, peak_lr=3e-4,
                       log_every=min(5, TRAIN_STEPS))
    trainer = Trainer(model, tcfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    stream = SyntheticLMStream(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0), device=dev)
    batch0 = stream.batch_at(0)
    torch.cuda.synchronize()
    print(f"lm train: recurrentgemma-2b full width ({cfg.num_layers} layers, "
          f"{cfg.param_dtype}, remat={cfg.remat}), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, {TRAIN_STEPS} AdamW steps (warmup 2, peak "
          f"3e-4, clip 1.0); set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    grad_check = _first_step_grads_vs_float32(model, params, batch0)
    torch.cuda.empty_cache()

    # the main path's run: counts from 0, read just after
    kernels = {"mach_xent_fwd": mx.mach_xent_cuda_fwd,
               "mach_xent_bwd": mx.mach_xent_cuda_bwd,
               "lru_scan": ls.lru_scan_cuda,
               "lru_scan_bwd": ls.lru_scan_bwd_cuda,
               "flash_attention": fa.flash_attention_cuda,
               "flash_attention_bwd": fa.flash_attention_bwd_cuda}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    state = new_train_state(params, trainer.opt)
    del params
    losses, step_ms = [], []
    for s in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, metrics = trainer.step_fn(state, stream.batch_at(s))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    with torch.no_grad():
        after = float(model.loss(state.params, batch0)[0])
    n_attn = cfg.layout().count("attn_local")
    n_rec = cfg.layout().count("rglru")
    # remat: each forward kernel runs again when its period is recomputed
    expected = {"mach_xent_fwd": 1, "mach_xent_bwd": 1, "lru_scan": 2 * n_rec,
                "lru_scan_bwd": n_rec, "flash_attention": 2 * n_attn,
                "flash_attention_bwd": n_attn}
    print(f"lm train: losses {losses}; batch 0 after {TRAIN_STEPS} steps "
          f"{after:.6f}; launches {launches} (a step: {expected}); peak "
          f"{peak_gib:.2f} GiB", flush=True)
    if not all(math.isfinite(v) for v in losses + [after]):
        fail(f"lm train: non-finite loss in {losses} / {after}")
    if not after < losses[0]:
        fail(f"lm train: batch 0's loss {after} after {TRAIN_STEPS} steps is "
             f"not below its loss at step 0, {losses[0]}")
    for name, per_step in expected.items():
        if launches[name] != per_step * TRAIN_STEPS:
            fail(f"lm train: {name} launched {launches[name]} times, expected "
                 f"{per_step} a step")

    # the step split: forward + backward, then clip + AdamW + apply
    from repro_torch.optim import accumulate_grads, apply_updates
    from repro_torch.optim import clip_by_global_norm
    batch = stream.batch_at(TRAIN_STEPS)
    fb_ms = wall_ms(lambda: accumulate_grads(model.loss, state.params, batch,
                                             1), runs=2, warmup=1)
    (_, _), grads = accumulate_grads(model.loss, state.params, batch, 1)

    def update():
        clipped, _ = clip_by_global_norm(grads, tcfg.clip_norm)
        upd, _ = trainer.opt.update(clipped, state.opt_state, state.params)
        return apply_updates(state.params, upd)
    opt_ms = wall_ms(update, runs=2, warmup=1)
    del grads, state
    torch.cuda.empty_cache()
    smi = _nvidia_smi()
    train_ms = statistics.median(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"lm train: {train_ms:.3f} ms/step (host clock, median of steps "
          f"2..{TRAIN_STEPS}; the first {step_ms[0]:.3f} ms), "
          f"{tokens / train_ms * 1e3:.1f} tokens/s; alone, forward + backward "
          f"{fb_ms:.3f} ms and clip + AdamW + apply {opt_ms:.3f} ms (medians "
          f"of 2); peak {peak_gib:.2f} GiB [{smi}]", flush=True)

    rows = _lm_train_kernel_rows(dev, cfg, launches, checks, smi)
    train = {"launches": launches, "losses": losses, "after": after,
             "step_ms": train_ms, "peak_gib": peak_gib, "fb_ms": fb_ms,
             "opt_ms": opt_ms, "grad_check": grad_check}
    return rows, train


def _lm_train_kernel_rows(dev, cfg, launches, checks, smi) -> list[dict]:
    """Kernel times at the training path's shapes (CUDA events), beside
    their bounds, plain versions and library yardsticks."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_xent as mx

    rows = []
    errs = checks["errs"]
    b, t = TRAIN_BATCH, TRAIN_SEQ
    n, r, nb = b * t, cfg.mach.num_repetitions, cfg.mach.num_buckets
    gen = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn((n, r, nb), generator=gen, device=dev).to(cfg.dtype)
    labels = torch.randint(0, nb, (n, r), generator=gen, device=dev,
                           dtype=torch.int32)
    g = torch.randn((n,), generator=gen, device=dev)
    ms_f = kernel_ms(lambda: mx.mach_xent_cuda_fwd(logits, labels))
    ms_b = kernel_ms(lambda: mx.mach_xent_cuda_bwd(logits, labels, g))
    plain_f = kernel_ms(lambda: mx.mach_xent_plain(logits, labels), iters=3,
                        warmup=1)
    plain_b = kernel_ms(lambda: mx.mach_xent_grad_plain(logits, labels, g),
                        iters=3, warmup=1)
    flat = logits.reshape(n * r, nb).detach().requires_grad_(True)
    flat_y = labels.reshape(-1).long()
    lib_f = kernel_ms(lambda: F.cross_entropy(flat, flat_y, reduction="none"))
    ce = F.cross_entropy(flat, flat_y, reduction="none")
    g_rep = g.repeat_interleave(r)
    lib_b = kernel_ms(lambda: torch.autograd.grad(ce, flat, g_rep,
                                                  retain_graph=True))
    del ce, flat
    bound_f = bound_of(mx.work(n, r, nb, logits.dtype), F32_OPS_PER_S)
    bound_b = bound_of(mx.work(n, r, nb, logits.dtype, True), F32_OPS_PER_S)
    shape3 = f"(N, R, B)=({n}, {r}, {nb}) {str(cfg.dtype).split('.')[-1]}"
    for name, ms, plain, lib, bound, direction in (
            ("mach_xent_fwd", ms_f, plain_f, lib_f, bound_f, "forward"),
            ("mach_xent_bwd", ms_b, plain_b, lib_b, bound_b, "backward")):
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mach_xent.cu",
            "replaces": "src/repro/kernels/mach_xent.py:89",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib,
            "shape": f"{direction}, LM head logits {shape3}",
            "library": "F.cross_entropy over the (N·R, B) view, reduction "
                       "none" + (", its backward" if direction == "backward"
                                 else "")})
    del logits, labels, g, g_rep

    d = cfg.resolved_rnn_width
    a = torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5
    x = torch.randn((b, t, d), generator=gen, device=dev)
    h0 = torch.zeros((b, d), device=dev)
    dh = torch.randn((b, t, d), generator=gen, device=dev)
    h = ls.lru_scan_cuda(a, x, h0)
    ms9 = kernel_ms(lambda: ls.lru_scan_bwd_cuda(a, h, h0, dh))
    ms9_graph = graph_ms(lambda: ls.lru_scan_bwd_cuda(a, h, h0, dh))
    ms9_fwd = kernel_ms(lambda: ls.lru_scan_cuda(a, x, h0))
    ms9_fwd_graph = graph_ms(lambda: ls.lru_scan_cuda(a, x, h0))
    plain9 = kernel_ms(lambda: ls.lru_scan_bwd_plain(a, h, h0, dh), iters=2,
                       warmup=1)
    bound9 = bound_of(ls.work(b, t, d, h.dtype, True), F32_OPS_PER_S)
    rows.append({
        "name": "lru_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lru_scan_bwd.cu",
        "replaces": "src/repro/kernels/lru_scan.py:46",
        "launches": launches["lru_scan_bwd"],
        "max_abs_err": errs["lru_scan_bwd"],
        "ms": ms9, "ms_graph": ms9_graph, "plain_ms": plain9,
        "bound_ms": bound9[0], "bound_by": bound9[1],
        "library_ms": None,
        "shape": f"training (B, T, D)=({b}, {t}, {d}) float32",
        "ms_forward_at_this_shape": ms9_fwd,
        "ms_forward_at_this_shape_graph": ms9_fwd_graph,
        "bound_ms_forward_at_this_shape":
            bound_of(ls.work(b, t, d, x.dtype), F32_OPS_PER_S)[0],
        "ptxas": _ptxas_registers(_build.build_log("lru_scan_bwd")),
        "timing": "ms by kernel_ms (CUDA events); *_graph by graph_ms "
                  "(CUDA-graph replay, device time)"})
    del a, x, h, dh

    h_, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    window = cfg.local_window
    q, k, v = _flash_inputs(dev, b, t, h_, kv, hd, cfg.dtype, seed=4)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(cfg.dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, window=window, return_lse=True)
    ms10_fwd = kernel_ms(lambda: fa.flash_attention_cuda(
        q, k, v, window=window, return_lse=True), iters=5)
    ms10 = kernel_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, out, dout, lse, window=window), iters=5)
    plain10 = kernel_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, dout, lse, window=window), iters=2, warmup=1)
    pairs = fa.attended_pairs(t, window)
    bound10, bound10_by, gflop = _flash_bound(b, t, t, h_, kv, hd, True,
                                              window, True, cfg.dtype)
    rows_i = torch.arange(t, device=dev)[:, None]
    cols_i = torch.arange(t, device=dev)[None, :]
    mask = (cols_i <= rows_i) & (cols_i > rows_i - window)
    qh, kh, vh = (z.transpose(1, 2).detach().requires_grad_(True)
                  for z in (q, k.expand(b, t, h_, hd), v.expand(b, t, h_, hd)))
    lib10_fwd = kernel_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), iters=5, warmup=2)
    sdpa = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    do_h = dout.transpose(1, 2)
    lib10 = kernel_ms(lambda: torch.autograd.grad(
        sdpa, (qh, kh, vh), do_h, retain_graph=True), iters=5, warmup=2)
    del sdpa, qh, kh, vh, mask
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": launches["flash_attention_bwd"],
        "max_abs_err": errs["flash_attention_bwd"],
        "ms": ms10, "plain_ms": plain10,
        "bound_ms": bound10, "bound_by": bound10_by,
        "library_ms": lib10,
        "shape": (f"training q ({b}, {t}, {h_}, {hd}), k/v ({b}, {t}, {kv}, "
                  f"{hd}) bfloat16, causal, window {window}: {pairs:,} "
                  f"attended pairs a head, {gflop:.1f} GFLOP"),
        "library": "F.scaled_dot_product_attention backward, boolean mask, "
                   "k/v expanded to 10 heads",
        "ms_forward_with_lse_at_this_shape": ms10_fwd,
        "library_ms_forward_at_this_shape": lib10_fwd,
        "tflops_per_s": gflop / ms10})
    for row in rows:
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"kernel {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {lib}, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), launches "
              f"{row['launches']} on the LM train path; {row['shape']} "
              f"[{smi}]", flush=True)
    bwd = rows[-1]
    print(f"kernel lru_scan forward at ({b}, {t}, {d}): {ms9_fwd:.4f} ms "
          f"(graph {ms9_fwd_graph:.4f}), backward graph {ms9_graph:.4f} ms; "
          f"kernel flash_attention forward with lse at the training shape: "
          f"{ms10_fwd:.4f} ms (SDPA forward {lib10_fwd:.4f} ms); backward "
          f"{bwd['tflops_per_s']:.1f} TFLOP/s of its 10·hd flops a pair "
          f"[{smi}]", flush=True)
    ptxas = next(r["ptxas"] for r in rows if r["name"] == "lru_scan_bwd")
    print(f"kernel lru_scan_bwd ptxas (registers; spills): {ptxas}",
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 10, flag on: the same training with the fused logit-free LM loss
# ---------------------------------------------------------------------------

# the fused loss reads bf16 h and head kernel in float32 and never rounds
# the logits; the unfused loss rounds them to bf16 before its CE: the two
# first-step losses are held within one bf16 unit roundoff of the loss
FUSED_LOSS_RTOL = 2.0 ** -8


def phase_lm_train_fused(dev, train: dict) -> dict:
    """recurrentgemma-2b trained as in phase 10 (same params, stream and
    trainer settings) with ``mach_fused_loss=True``: the loss runs kernel 4
    on the bf16 hidden states and head kernel, forward and backward with
    dh, and kernel 3 not at all.  The first step's loss is held to the
    unfused loss of the same params and batch."""
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, SyntheticLMStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import mach_xent as mx
    from repro_torch.models import LanguageModel
    from repro_torch.train import TrainConfig, Trainer, new_train_state

    base = get_config("recurrentgemma-2b")
    cfg = dataclasses.replace(base, mach_fused_loss=True)
    model = LanguageModel(cfg)
    tcfg = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=2, peak_lr=3e-4,
                       log_every=min(5, TRAIN_STEPS))
    trainer = Trainer(model, tcfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    stream = SyntheticLMStream(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0), device=dev)
    batch0 = stream.batch_at(0)
    with torch.no_grad():
        unfused0 = float(LanguageModel(base).loss(params, batch0)[0])

    # the main path's run: counts from 0, read just after
    kernels = {"dense_fwd": mfx.dense_fwd_cuda, "dense_bwd": mfx.dense_bwd_cuda,
               "mach_xent_fwd": mx.mach_xent_cuda_fwd,
               "mach_xent_bwd": mx.mach_xent_cuda_bwd,
               "lru_scan": ls.lru_scan_cuda,
               "flash_attention": fa.flash_attention_cuda}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    state = new_train_state(params, trainer.opt)
    del params
    losses, step_ms = [], []
    for s in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, metrics = trainer.step_fn(state, stream.batch_at(s))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    del state
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in losses):
        fail(f"lm train fused: non-finite loss in {losses}")
    err = abs(losses[0] - unfused0)
    if err > FUSED_LOSS_RTOL * abs(unfused0):
        fail(f"lm train fused: first loss {losses[0]} vs the unfused loss "
             f"{unfused0} of the same params and batch: {err} > 2^-8 of it")
    want = {"dense_fwd": TRAIN_STEPS, "dense_bwd": TRAIN_STEPS,
            "mach_xent_fwd": 0, "mach_xent_bwd": 0}
    for name, count in want.items():
        if launches[name] != count:
            fail(f"lm train fused: {name} launched {launches[name]} times, "
                 f"expected {count}")
    smi = _nvidia_smi()
    ms = statistics.median(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"lm train fused (mach_fused_loss=True): losses {losses}; first "
          f"loss {losses[0]:.6f} vs unfused {unfused0:.6f} (|diff| {err:.3e},"
          f" bound 2^-8 of it); launches {launches}; {ms:.3f} ms/step (host "
          f"clock, median of steps 2..{TRAIN_STEPS}; the first "
          f"{step_ms[0]:.3f} ms), {tokens / ms * 1e3:.1f} tokens/s, peak "
          f"{peak_gib:.2f} GiB; unfused (phase 10) {train['step_ms']:.3f} "
          f"ms/step, {tokens / train['step_ms'] * 1e3:.1f} tokens/s, peak "
          f"{train['peak_gib']:.2f} GiB [{smi}]", flush=True)
    return {"launches": launches, "losses": losses, "unfused_loss0": unfused0,
            "step_ms": ms, "peak_gib": peak_gib}


# ---------------------------------------------------------------------------
# phase 11: dynamic bucket selection at the JAX package's 500k-label
# workload (benchmarks/bench_train_xent.py, EXTREME_500K)
# ---------------------------------------------------------------------------

SELECT = {"K": 500_000, "B": 4096, "R": 8, "d": 1024, "N": 512,
          "c_sel": 512, "refresh_every": 10}
# (label, nnz of the CSR stream, kernel family): CSR at nnz = 64 runs the
# ELL family (kernel 5), at nnz_max = 1,024 the gather family (kernel 6);
# the nnz = 64 stream densified runs the dense family (kernel 4, float32)
SELECT_RUNS = (("csr nnz=64", 64, "ell"), ("csr nnz=1024", 1024, "gather"),
               ("dense", 64, "dense"))
SELECT_STEPS = 6
# kernels vs plain at B' = c_sel: (R, c_sel); R·c_sel = 2,555 is odd, so
# the gathered W's rows are off 16-byte alignment (kernel 4's plain loads)
# and kernel 6's dW takes its scalar path (c % 4 != 0)
SELECT_CHECKS = ((8, 512), (5, 511))


class _HeadTask:
    """A MACH head trained through its fused loss, as the ``Trainer``
    takes a model: ``loss(params, batch) -> (loss, metrics)``, and a
    ``cfg.mach_bucket_select`` that sets the proxy's refresh cadence.
    Keeps each step's loss (detached, no synchronisation)."""

    def __init__(self, head, bucket_select):
        self.head = head
        self.cfg = types.SimpleNamespace(mach_bucket_select=bucket_select)
        self.losses = []

    def loss(self, params, batch):
        loss = self.head.fused_loss(params, batch["x"], batch["y"],
                                    bucket_select=self.cfg.mach_bucket_select,
                                    bucket_proxy=batch.get("bucket_proxy"))
        self.losses.append(loss.detach())
        return loss, {"loss": loss}


class _Stream:
    def __init__(self, batch_at):
        self._batch_at = batch_at

    def batch_at(self, step):
        x, y = self._batch_at(step)
        return {"x": x, "y": y}


class _StepTimes:
    """``Trainer.fit``'s monitor: each step's synchronized seconds."""

    def __init__(self):
        self.ms = []

    def record(self, step, seconds):
        self.ms.append(seconds * 1e3)


def _selection_kernel_checks(dev, trained) -> dict:
    """Kernels 4-6 at B' = c_sel on gathered columns against their plain
    versions, forward and backward (gradients through the column gather
    to the full W and bias), and the gathered W's unselected columns'
    gradients exactly zero; the selection itself equal to the CPU's.
    Then, at the workload's R = 8, c_sel = 512: kernel 5 against its
    plain version at B on the same inputs too, and each family's forward
    and backward times, bounds and library calls at B' = c_sel and at B
    on the same inputs; kernel 5's on ``trained``, the (CSR batch, hashed
    labels) that the nnz = 64 runs train first (every row 64 slots, Zipf
    background features)."""
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import ops

    n, d, b = SELECT["N"], SELECT["d"], SELECT["B"]
    out = {f: {"max_abs_err": 0.0, "cases": 0} for f in ("dense", "ell",
                                                        "gather")}
    for r, c_sel in SELECT_CHECKS:
        gen = torch.Generator(device=dev).manual_seed(r * c_sel)
        proxy = torch.randn((r, b), generator=gen, device=dev)
        y = torch.randint(0, b, (n, r), generator=gen, device=dev,
                          dtype=torch.int32)
        selected = ops.mach_select_buckets(proxy, y, num_buckets=b,
                                           c_sel=c_sel)
        on_cpu = ops.mach_select_buckets(proxy.cpu(), y.cpu(), num_buckets=b,
                                         c_sel=c_sel)
        if not torch.equal(selected.cpu(), on_cpu):
            fail(f"selection R={r} c_sel={c_sel}: the card's ids differ from "
                 f"the CPU's")
        keep = torch.zeros((r, b), dtype=torch.bool, device=dev)
        keep[torch.arange(r, device=dev)[:, None], selected.long()] = True
        g = torch.rand((n,), generator=gen, device=dev) + 0.5
        w = torch.randn((d, r * b), generator=gen, device=dev)
        bias = torch.randn((r * b,), generator=gen, device=dev)
        h = torch.nn.functional.normalize(
            torch.randn((n, d), generator=gen, device=dev), dim=1)
        for family in ("dense", "ell", "gather"):
            nnz_max = 64 if family == "ell" else 1024
            scale = d ** -0.5 if family == "dense" else 1.0
            wl = (w * scale).requires_grad_(True)
            bl = bias.clone().requires_grad_(True)
            if family == "dense":
                hl = h.clone().requires_grad_(True)
                leaves, names = [hl, wl, bl], ["h", "W", "bias"]
                inputs = (hl,)
                kern_fn, plain_fn = (mfx.mach_fused_xent_dense,
                                     mfx.fused_xent_dense_plain)
            else:
                batch = _csr_check_batch(dev, n, d, nnz_max,
                                         seed=nnz_max + c_sel)
                inputs = ops.csr_to_ell(batch.indptr, batch.indices,
                                        batch.values, nnz_max, d)
                leaves, names = [wl, bl], ["W", "bias"]
                kern_fn = getattr(mfx, f"mach_fused_xent_{family}")
                plain_fn = mfx.fused_xent_ell_plain

            def run(fn):
                wsel, bsel, pos = ops._apply_bucket_selection(wl, bl, y,
                                                              selected, b)
                return fn(*inputs, wsel, bsel, pos, c_sel)
            tag = f"selected {family} R={r} c_sel={c_sel} (R·c_sel={r * c_sel})"
            got = _loss_and_grads(lambda: run(kern_fn), leaves, g)
            err = _compare(tag, got, _loss_and_grads(lambda: run(plain_fn),
                                                     leaves, g), names)
            gw, gb = got[2][names.index("W")], got[2][names.index("bias")]
            if bool((gw.reshape(d, r, b)[:, ~keep] != 0).any()) or \
                    bool((gb.reshape(r, b)[~keep] != 0).any()):
                fail(f"{tag}: an unselected column's gradient is not zero")
            if family == "dense":
                via = ops.mach_fused_xent(
                    hl, wl, y, num_buckets=b, bias=bl,
                    bucket_select=(c_sel, 1), bucket_proxy=proxy)
            else:
                via = ops.mach_fused_xent_csr(
                    batch.indptr, batch.indices, batch.values, wl, y,
                    num_buckets=b, nnz_max=nnz_max, bias=bl,
                    bucket_select=(c_sel, 1), bucket_proxy=proxy)
            if not torch.allclose(via.detach(), got[0], **LOSS_TOL):
                fail(f"{tag}: ops' bucket_select dispatch differs from the "
                     f"kernel at the gathered columns")
            out[family]["max_abs_err"] = max(out[family]["max_abs_err"], err)
            out[family]["cases"] += 1
            if (r, c_sel) == (SELECT["R"], SELECT["c_sel"]):
                if family == "ell":      # selection off: the whole B
                    out[family]["max_abs_err_full_b"] = _compare(
                        f"ell at B={b} (selection off)",
                        _loss_and_grads(lambda: kern_fn(*inputs, wl, bl, y, b),
                                        leaves, g),
                        _loss_and_grads(lambda: plain_fn(*inputs, wl, bl, y,
                                                         b), leaves, g), names)
                timed = (inputs, hl if family == "dense" else batch, y,
                         selected)
                if family == "ell":      # the traffic phase 11 trains
                    tx, ty = trained
                    timed = (ops.csr_to_ell(tx.indptr, tx.indices, tx.values,
                                            tx.nnz_max, d), tx, ty,
                             ops.mach_select_buckets(proxy, ty, num_buckets=b,
                                                     c_sel=c_sel))
                out[family].update(_selection_times(
                    family, timed[0], timed[1], wl.detach(), bl.detach(),
                    timed[2], timed[3], g, b, c_sel))
            print(f"{tag}: kernel == plain, forward and backward (max abs "
                  f"err {err:.3e}); unselected columns' gradients exactly 0",
                  flush=True)
    return out


def _selection_times(family, inputs, x, w, bias, y, selected, g, b, c_sel
                     ) -> dict:
    """A family's forward and backward kernel times (CUDA events) at
    B' = c_sel over the gathered columns, and at B on the same inputs,
    each with its bound and its library call (``_library_xent`` on ``x``,
    the dense h or the CSR batch: forward and backward to W and bias)."""
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import ops

    fwd = getattr(mfx, f"{family}_fwd_cuda")
    bwd = getattr(mfx, f"{family}_bwd_cuda")
    kw = {"need_dh": False} if family == "dense" else {}
    wsel, bsel, pos = ops._apply_bucket_selection(w, bias, y, selected, b)
    n, r, d = y.shape[0], y.shape[1], w.shape[0]
    sparse = {}
    if family != "dense":
        cols = inputs[0]
        valid = (cols >= 0) & (cols < d)
        sparse = {"nnz": int(valid.sum()),
                  "unique": int(torch.unique(cols[valid]).numel()),
                  "j": cols.shape[1]}
    res = {}
    for key, (wk, bk, lk, nb) in (("selected", (wsel, bsel, pos, c_sel)),
                                  ("full", (w, bias, y, b))):
        (bf, _), (bb_, _) = _bound(family, n, d, r, nb, **sparse)
        res[f"bound_ms_{key}"] = bf + bb_
        _, lse = fwd(*[t.detach() for t in inputs], wk, bk, lk, nb)
        res[f"ms_fwd_{key}"] = kernel_ms(lambda: fwd(
            *[t.detach() for t in inputs], wk, bk, lk, nb), iters=10)
        res[f"ms_bwd_{key}"] = kernel_ms(lambda: bwd(
            *[t.detach() for t in inputs], wk, bk, lk, lse, g, nb, **kw),
            iters=10)
        leaves = [t.detach().requires_grad_(True) for t in (wk, bk)]
        res[f"library_ms_{key}"] = kernel_ms(lambda: _library_xent(
            family, x.detach() if family == "dense" else x, *leaves, lk, nb,
            n, r, d), iters=3, warmup=1)
        print(f"selection times {family} at {key} B={nb}: forward "
              f"{res[f'ms_fwd_{key}']:.4f} + backward {res[f'ms_bwd_{key}']:.4f}"
              f" ms, bound {res[f'bound_ms_{key}']:.4f}, library "
              f"{res[f'library_ms_{key}']:.4f} ms [{_nvidia_smi()}]",
              flush=True)
    return res


def phase_selection(dev) -> dict:
    """Train the 500k-label workload with selection on and off, CSR at
    nnz 64 and 1,024 and dense, through the ``Trainer`` with a
    ``bucket_proxy_fn`` refreshed every 10 steps; then kernels 4-6 held
    against their plain versions at B' = c_sel."""
    from repro_torch.core.mach import MACHConfig, MACHLinear
    from repro_torch.data.extreme import (SparseExtremeDataConfig,
                                          SparseExtremeDataset)
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.train import TrainConfig, Trainer, new_train_state

    p = SELECT
    t0 = time.perf_counter()
    head = MACHLinear(MACHConfig(p["K"], p["B"], p["R"]), p["d"], fused=True)
    data = {nnz: SparseExtremeDataset(SparseExtremeDataConfig(
        num_classes=p["K"], num_features=p["d"], nnz=nnz, sig_features=16),
        device=dev) for nnz in sorted({nnz for _, nnz, _ in SELECT_RUNS})}
    torch.cuda.synchronize()
    print(f"selection: K={p['K']:,} B={p['B']} R={p['R']} d={p['d']} "
          f"N={p['N']} c_sel={p['c_sel']} refresh_every="
          f"{p['refresh_every']} (the JAX package's EXTREME_500K); set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    select = (p["c_sel"], p["refresh_every"])
    runs = {}
    for label, nnz, family in SELECT_RUNS:
        fmt = "dense" if family == "dense" else "csr"
        stream = _Stream(lambda s, nnz=nnz, fmt=fmt: data[nnz].batch_at(
            s, p["N"], format=fmt))
        for mode in ("off", "on"):
            task = _HeadTask(head, select if mode == "on" else None)
            proxy_calls = []

            def proxy_fn(params, batch):
                proxy_calls.append(1)
                return head.bucket_proxy_scores(params, batch["x"])
            trainer = Trainer(task, TrainConfig(schedule="constant",
                                                peak_lr=0.05,
                                                log_every=10 ** 9),
                              bucket_proxy_fn=proxy_fn if mode == "on"
                              else None)
            params = head.init(torch.Generator(device=dev).manual_seed(5),
                               device=dev)
            state = new_train_state(params, trainer.opt)
            del params
            times = _StepTimes()
            # the main path's run: counts from 0, read just after
            for fn in mfx.CUDA_WRAPPERS:
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            state = trainer.fit(state, stream, SELECT_STEPS, monitor=times,
                                log=None)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            launches = {fn.__name__: fn.launches for fn in mfx.CUDA_WRAPPERS}
            losses = [float(v) for v in task.losses]
            del state
            if not all(math.isfinite(v) for v in losses):
                fail(f"selection {label} {mode}: non-finite loss {losses}")
            fam = launches[f"{family}_fwd_cuda"] + launches[f"{family}_bwd_cuda"]
            if launches[f"{family}_fwd_cuda"] != SELECT_STEPS or \
                    launches[f"{family}_bwd_cuda"] != SELECT_STEPS:
                fail(f"selection {label} {mode}: {family} kernels launched "
                     f"{launches}")
            if mode == "on" and len(proxy_calls) != 1:
                fail(f"selection {label}: the proxy ran {len(proxy_calls)} "
                     f"times in {SELECT_STEPS} steps (refresh every "
                     f"{p['refresh_every']})")
            runs[label, mode] = {"ms": statistics.median(times.ms[1:]),
                                 "first_ms": times.ms[0], "peak_gib": peak,
                                 "losses": losses, "launches": fam,
                                 "family": family}
        on, off = runs[label, "on"], runs[label, "off"]
        if on["losses"][0] > off["losses"][0] + 1e-4 * abs(off["losses"][0]):
            fail(f"selection {label}: the selected first loss "
                 f"{on['losses'][0]} is above the full one {off['losses'][0]} "
                 f"(its bias is one-sided)")
        print(f"selection {label} ({family}): on {on['ms']:.3f} ms/step "
              f"(first {on['first_ms']:.3f}), peak {on['peak_gib']:.2f} GiB, "
              f"losses {[round(v, 4) for v in on['losses']]}; off "
              f"{off['ms']:.3f} ms/step (first {off['first_ms']:.3f}), peak "
              f"{off['peak_gib']:.2f} GiB, losses "
              f"{[round(v, 4) for v in off['losses']]} (host clock, median "
              f"of steps 2..{SELECT_STEPS}) [{_nvidia_smi()}]", flush=True)
    tx, ty = data[64].batch_at(0, p["N"], format="csr")
    trained = (tx, head.cfg.hash_labels(ty).movedim(0, -1)
               .to(torch.int32).contiguous())
    del data
    torch.cuda.empty_cache()
    checks = _selection_kernel_checks(dev, trained)
    return {"runs": runs, "checks": checks}


# ---------------------------------------------------------------------------
# phase 12: the one-vs-all baseline (the paper's comparison point)
# ---------------------------------------------------------------------------

OAA_STEPS = 5


def _oaa_classifier_runs(dev) -> dict:
    """OAAClassifier at ImageNet-21k width (K=21,841, d=6,144, dense
    float32) beside the fused MACHLinear, on the same stream: ms a step
    and peak memory.  ODP's OAA is only sized: it does not fit."""
    from repro_torch.configs.odp_mach import IMAGENET, ODP
    from repro_torch.core import OAAClassifier
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import ExtremeDataConfig, ExtremeDataset
    from repro_torch.optim import adamw

    data = ExtremeDataset(ExtremeDataConfig(IMAGENET.num_classes,
                                            IMAGENET.dim), device=dev)
    heads = {"oaa": OAAClassifier(IMAGENET.num_classes, IMAGENET.dim),
             "mach": MACHLinear(IMAGENET.mach(), IMAGENET.dim, fused=True)}
    want0 = {"oaa": math.log(IMAGENET.num_classes),
             "mach": IMAGENET.mach_r * math.log(IMAGENET.mach_b)}
    out = {}
    for name, head in heads.items():
        params = head.init(torch.Generator(device=dev).manual_seed(1),
                           device=dev)
        opt = adamw(0.05)
        torch.cuda.reset_peak_memory_stats(dev)
        _, _, losses, times, _ = _train(
            head, params, lambda s: data.batch_at(s, N_TRAIN), OAA_STEPS, opt,
            opt.init(params))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        del params
        if not all(math.isfinite(v) for v in losses) or \
                abs(losses[0] - want0[name]) > 1.0:
            fail(f"imagenet21k {name}: losses {losses} (first expected near "
                 f"{want0[name]:.3f} at random init)")
        out[name] = {"ms": statistics.median(times[1:]), "peak_gib": peak,
                     "losses": losses, "params": head.param_count()}
    smi = _nvidia_smi()
    print(f"oaa imagenet21k (K={IMAGENET.num_classes:,}, d={IMAGENET.dim}, "
          f"N={N_TRAIN}, dense float32; W {out['oaa']['params'] * 4 / 1e6:.1f}"
          f" MB): OAA {out['oaa']['ms']:.3f} ms/step, peak "
          f"{out['oaa']['peak_gib']:.2f} GiB, {out['oaa']['params']:,} params;"
          f" MACH B={IMAGENET.mach_b} R={IMAGENET.mach_r} "
          f"{out['mach']['ms']:.3f} ms/step, peak {out['mach']['peak_gib']:.2f}"
          f" GiB, {out['mach']['params']:,} params (host clock, median of "
          f"steps 2..{OAA_STEPS}; AdamW) [{smi}]", flush=True)
    odp_bytes = ODP.num_classes * ODP.dim * 4
    print(f"oaa odp: W would be {ODP.num_classes:,} x {ODP.dim:,} float32 = "
          f"{odp_bytes / 1e9:.1f} GB, more than the card's 80 GB before any "
          f"gradient or optimizer state: not tried (MACH B={ODP.mach_b} "
          f"R={ODP.mach_r}: {ODP.dim * ODP.mach_b * ODP.mach_r * 4 / 1e9:.2f}"
          f" GB)", flush=True)
    return out


def phase_oaa(dev, train: dict) -> dict:
    """The one-vs-all baseline: the classifier at ImageNet-21k width, then
    recurrentgemma-2b with ``mach="off"`` (the tied 256,000 x 2,560 head)
    served by the engine (greedy tokens == a direct greedy loop) and
    trained as in phase 10, beside the MACH head's numbers."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, SyntheticLMStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.models import LanguageModel
    from repro_torch.train import TrainConfig, Trainer, new_train_state

    out = {"classifier": _oaa_classifier_runs(dev)}
    torch.cuda.empty_cache()
    cfg = get_config("recurrentgemma-2b", mach="off")
    model = LanguageModel(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               device=dev) for n in LM_PROMPTS]
    kernels = {"lru_scan": ls.lru_scan_cuda,
               "flash_attention": fa.flash_attention_cuda}
    for fn in kernels.values():
        fn.launches = 0
    engine_tokens, tick_ms, run_s = _serve(model, params, prompts)
    served = {n: fn.launches for n, fn in kernels.items()}
    direct = _direct_greedy(model, params, prompts, engine_tokens, dev)
    for i, toks in enumerate(engine_tokens):
        if len(toks) != LM_MAX_NEW or not all(0 <= t < cfg.vocab_size
                                              for t in toks):
            fail(f"oaa lm serve: request {i} gave {toks}")
        if i != LM_SAMPLED and list(toks) != direct[i]:
            fail(f"oaa lm serve: greedy request {i} gave {list(toks)}, the "
                 f"direct loop {direct[i]}")
    if min(served.values()) < 1:
        fail(f"oaa lm serve: kernels 9-10 launches {served}")
    decode_ms = statistics.median(tick_ms[1:])     # after the admission tick
    print(f"oaa lm serve: recurrentgemma-2b mach='off' (tied {cfg.vocab_size:,}"
          f" x {cfg.d_model} head): {len(LM_PROMPTS)} requests, greedy tokens"
          f" == the direct greedy loop; launches {served}; decode tick "
          f"{decode_ms:.3f} ms (median), run {run_s * 1e3:.1f} ms "
          f"[{_nvidia_smi()}]", flush=True)

    tcfg = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=2, peak_lr=3e-4,
                       log_every=min(5, TRAIN_STEPS))
    trainer = Trainer(model, tcfg)
    stream = SyntheticLMStream(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0), device=dev)
    batch0 = stream.batch_at(0)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    state = new_train_state(params, trainer.opt)
    del params
    losses, step_ms = [], []
    for s in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, metrics = trainer.step_fn(state, stream.batch_at(s))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {n: fn.launches for n, fn in kernels.items()}
    with torch.no_grad():
        after = float(model.loss(state.params, batch0)[0])
    del state
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in losses + [after]) or \
            abs(losses[0] - math.log(cfg.vocab_size)) > 1.0 or \
            not after < losses[0]:
        fail(f"oaa lm train: losses {losses}, batch 0 after {after} (first "
             f"expected near ln V = {math.log(cfg.vocab_size):.3f})")
    if min(launches.values()) < 1:
        fail(f"oaa lm train: kernels 9-10 launches {launches}")
    ms = statistics.median(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"oaa lm train: {TRAIN_BATCH} x {TRAIN_SEQ} tokens, losses {losses};"
          f" batch 0 after {TRAIN_STEPS} steps {after:.6f}; {ms:.3f} ms/step "
          f"(median of steps 2..{TRAIN_STEPS}; the first {step_ms[0]:.3f} ms),"
          f" {tokens / ms * 1e3:.1f} tokens/s, peak {peak_gib:.2f} GiB; the "
          f"MACH head (phase 10) {train['step_ms']:.3f} ms/step, peak "
          f"{train['peak_gib']:.2f} GiB [{_nvidia_smi()}]", flush=True)
    out["lm"] = {"serve_decode_ms": decode_ms, "step_ms": ms,
                 "peak_gib": peak_gib, "losses": losses}
    return out


# ---------------------------------------------------------------------------
# phase 13: the dense decoders through the paged and lockstep engines
# ---------------------------------------------------------------------------

DENSE_PROMPTS = (2048, 5, 77, 300, 1000, 17, 2048, 40)  # 2,048: kernel 10
DENSE_MAX_NEW = (16, 4, 12, 8, 16, 2, 6, 10)            # ragged
DENSE_SLOTS, DENSE_MAX_LEN, DENSE_PAGE, DENSE_TOP_K = 4, 4096, 16, 50
DENSE_WIDE_SLOTS = 16        # paged, inside the 4-slot contiguous KV bytes
# a paged row's hidden state after the first pooled decode step may be at
# most SLOPE x the contiguous engine's rel L2 error (both against the
# float32 model) + ATOL: the sound engines' ratio was 0.97-1.04 (PERF.md)
DENSE_HIDDEN_SLOPE, DENSE_HIDDEN_ATOL = 1.25, 2.0 ** -10
DENSE_OTHERS = ("phi3-mini-3.8b", "granite-20b")
DENSE_OTHER_PROMPTS, DENSE_OTHER_MAX_NEW = (2048, 33), 8
DENSE_OTHER_MAX_LEN = 2064   # 2,048 + 8 new tokens, page-rounded
DENSE_KERNELS = ("flash_attention", "mach_topk", "bucket_topm",
                 "mach_candidate_topk")


def _dense_launchers() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mach_candidates as mc
    from repro_torch.kernels import mach_topk as mt
    return {"flash_attention": fa.flash_attention_cuda,
            "mach_topk": mt.mach_topk_cuda,
            "bucket_topm": mc.bucket_topm_cuda,
            "mach_candidate_topk": mc.mach_candidate_topk_cuda}


def _dense_head_vs_plain(dev, arch="tinyllama-1.1b", top1=False) -> dict:
    """Kernel 2 vs its plain version at ``arch``'s MACH head (tinyllama:
    R=8, B=2048, K=32,000): N=1 (a prefill) and 4 (the pool), k 1 and 50,
    the three estimators, table and inline hashes, dyadic inputs exactly
    and random ones as in phase 3; then its time at the pool's N=4, k=50.
    With ``top1``, kernel 1 too (the direct greedy loop's): N=1 and 4,
    both hashes, dyadic and random, then its time at N=4 beside its bound
    and the library call (``torch.max`` over the sparse multi-hot
    product), under ``out["top1"]``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt

    mach = get_config(arch, mach="on").mach
    name = arch.split("-")[0]
    fam = mach.family
    r, b, num_classes = mach.num_repetitions, mach.num_buckets, mach.num_classes
    table = fam.table(num_classes, dev)
    inline = {"inline_coeffs": fam.coeffs_tensor(dev),
              "inline_shift": fam.shift}
    sources = {"table": ((table,), {}), "inline": ((), inline)}
    cases, err, cases1, err1 = 0, 0.0, 0, 0.0
    for n in LM_HEAD_N:
        for dyadic in (True, False):
            meta = _inputs(n, r, b, dyadic, seed=n + 11, dev=dev)
            rows = "dyadic" if dyadic else "random"
            for est in ESTIMATORS:
                scores = mt.estimator_scores(meta, table, est)
                for k in LM_HEAD_K:
                    for src, (args, kw) in sources.items():
                        kv, ki = mt.mach_topk_cuda(
                            meta, *args, num_classes=num_classes, k=k,
                            estimator=est, **kw)
                        pv, pi = mt.mach_topk_plain(
                            meta, *args, num_classes=num_classes, k=k,
                            estimator=est, **kw)
                        torch.cuda.synchronize()
                        tag = f"{name} head n={n} {est} k={k} {src} {rows}"
                        err = max(err, _check_same(tag, kv, ki, pv, pi,
                                                   scores, dyadic))
                        cases += 1
            if not top1:
                continue
            summed = md.summed_scores(meta, table)
            for src, (args, kw) in sources.items():
                kv, ki = md.mach_decode_cuda(meta, *args,
                                             num_classes=num_classes, **kw)
                pv, pi = md.mach_decode_plain(meta, *args,
                                              num_classes=num_classes, **kw)
                torch.cuda.synchronize()
                err1 = max(err1, _check_same(
                    f"top1 {name} head n={n} {src} {rows}", kv, ki, pv, pi,
                    summed, dyadic))
                cases1 += 1
    n = DENSE_SLOTS
    meta = _inputs(n, r, b, False, seed=n, dev=dev)
    meta2d_t = meta.reshape(n, r * b).T.contiguous()
    multihot = _sparse_multihot(table, b)
    kw = {"num_classes": num_classes, "k": DENSE_TOP_K, **inline}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bound, bound_by = bound_ms(n, r, b, num_classes, DENSE_TOP_K, table=False)
    smi = _nvidia_smi()
    out = {"cases": cases, "max_abs_err": err,
           "ms": kernel_ms(lambda: mt.mach_topk_cuda(meta, **kw)),
           "ms_graph": graph_ms(lambda: mt.mach_topk_cuda(meta, **kw)),
           "plain_ms": kernel_ms(lambda: mt.mach_topk_plain(meta, **kw),
                                 iters=5),
           "library_ms": kernel_ms(lambda: torch.topk(
               torch.sparse.mm(multihot, meta2d_t), DENSE_TOP_K, dim=0)),
           "bound_ms": bound, "bound_by": bound_by,
           "mapping": mt.topk_layout(n, r, b, num_classes, DENSE_TOP_K,
                                     sms).mapping,
           "shape": f"{name} head N={n} R={r} B={b} K={num_classes} "
                    f"k={DENSE_TOP_K} inline hash, unbiased"}
    print(f"{name} head: kernel 2 vs plain, {cases} comparisons ok (R={r},"
          f" B={b}, K={num_classes}, N in {LM_HEAD_N}, k in {LM_HEAD_K}, "
          f"table and inline); at N={n} k={DENSE_TOP_K} ({out['mapping']}) "
          f"{out['ms']:.4f} ms (graph {out['ms_graph']:.4f}), plain "
          f"{out['plain_ms']:.4f} ms, library {out['library_ms']:.4f} ms "
          f"(torch.topk over a sparse multi-hot product), bound "
          f"{bound:.5f} ms ({bound_by}) [{smi}]", flush=True)
    if top1:
        kw1 = {"num_classes": num_classes, **inline}
        bound1, bound1_by = bound_ms(n, r, b, num_classes, 1, table=False)
        one = {"cases": cases1, "max_abs_err": err1,
               "ms": kernel_ms(lambda: md.mach_decode_cuda(meta, **kw1)),
               "ms_graph": graph_ms(lambda: md.mach_decode_cuda(meta, **kw1)),
               "plain_ms": kernel_ms(lambda: md.mach_decode_plain(meta, **kw1),
                                     iters=5),
               "library_ms": kernel_ms(lambda: torch.max(
                   torch.sparse.mm(multihot, meta2d_t), dim=0)),
               "bound_ms": bound1, "bound_by": bound1_by,
               "mapping": md.decode_layout(n, r, b, num_classes,
                                           sms).mapping,
               "shape": f"{name} head N={n} R={r} B={b} K={num_classes} "
                        f"inline hash"}
        out["top1"] = one
        print(f"{name} head: kernel 1 vs plain, {cases1} comparisons ok "
              f"(N in {LM_HEAD_N}, table and inline, dyadic exactly); at "
              f"N={n} ({one['mapping']}) {one['ms']:.4f} ms (graph "
              f"{one['ms_graph']:.4f}), plain {one['plain_ms']:.4f} ms, "
              f"library {one['library_ms']:.4f} ms (torch.max over a sparse "
              f"multi-hot product), bound {bound1:.5f} ms ({bound1_by}) "
              f"[{smi}]", flush=True)
    return out


def _dense_candidates_vs_plain(dev, arch="tinyllama-1.1b") -> dict:
    """Kernels 7 and 8 vs their plain versions at ``arch``'s MACH engine's
    candidate_mode = (B, R) (tinyllama-1.1b: (2048, 8), R=8, B=2,048,
    K=32,000), with its inverted table, k=50, N=1 (a prefill) and 4 (the
    pool), the three estimators, table and inline hashes, dyadic (ties in
    bulk) and random softmax rows.  Kernel 7's tau and ids bit for bit;
    kernel 8 by ``_check_candidates``."""
    from repro_torch.configs import get_config
    from repro_torch.core.hashing import inverted_table
    from repro_torch.kernels import mach_candidates as mc

    mach = get_config(arch, mach="on").mach
    name = arch.split("-")[0]
    fam = mach.family
    r, b, num_classes = mach.num_repetitions, mach.num_buckets, mach.num_classes
    table = fam.table(num_classes, dev)
    inv = inverted_table(fam.table_np(num_classes), b, device=dev)
    sources = {"table": ((table,), {}),
               "inline": ((), {"inline_coeffs": fam.coeffs_tensor(dev),
                               "inline_shift": fam.shift})}
    m, t = b, r
    topm = cand = 0
    err = 0.0
    for n in LM_HEAD_N:
        for dyadic in (True, False):
            meta = _inputs(n, r, b, dyadic, seed=n + 21, dev=dev)
            tag = f"n={n} {'dyadic' if dyadic else 'random'}"
            tau, ids = mc.bucket_topm_cuda(meta, m)
            p_tau, p_ids = mc.bucket_topm(meta.cpu(), m)
            if not (torch.equal(tau.cpu().view(torch.int32),
                                p_tau.view(torch.int32))
                    and torch.equal(ids.cpu(), p_ids)):
                fail(f"{name} candidates {tag}: bucket_topm kernel != "
                     f"plain at m={m}")
            topm += 1
            for est in ESTIMATORS:
                for src, (args, kw) in sources.items():
                    kw = {"num_classes": num_classes, "k": DENSE_TOP_K,
                          "t": t, "estimator": est, **kw}
                    got = mc.mach_candidate_topk_cuda(meta, tau, ids, inv,
                                                      *args, **kw)
                    want = mc.mach_candidate_topk_plain(meta, tau, ids, inv,
                                                        *args, **kw)
                    torch.cuda.synchronize()
                    err = max(err, _check_candidates(
                        f"{name} candidates {tag} {est} {src}", got, want))
                    cand += 1
    print(f"{name} candidates: kernel 7 vs plain {topm} and kernel 8 vs "
          f"plain {cand} comparisons ok (R={r}, B={b}, K={num_classes}, L="
          f"{inv.shape[1]}, m={m}, t={t}, k={DENSE_TOP_K}, N in {LM_HEAD_N}, "
          f"the three estimators, table and inline), max abs err {err:.3e}",
          flush=True)
    return {"bucket_topm": topm, "mach_candidate_topk": cand,
            "max_abs_err": err}


def _pool_kv_bytes(pool) -> int:
    """K and V bytes of the attention caches; every byte of a recurrent
    state (xLSTM)."""
    return sum(c.k.numel() * c.k.element_size() * 2 if hasattr(c, "k")
               else sum(x.numel() * x.element_size() for x in c)
               for stack in pool for c in stack)


def _takes_flash(cfg, t: int) -> bool:
    return t >= cfg.flash_threshold and t % min(cfg.chunk_q, t) == 0


def _expected_flash(model, prompts, feats) -> int:
    """Kernel-10 launches of an engine run: for each request, every
    encoder layer where its frames take the flash branch, and every
    decoder attention (self and cross) where its prefix + prompt does."""
    cfg = model.cfg
    kinds = model._dec_layout()
    per_prompt = sum(k in ("attn", "attn_local", "moe", "xattn")
                     for k in kinds) + kinds.count("xattn")
    total = 0
    for i, p in enumerate(prompts):
        f = feats[i] if feats else {}
        t = len(p) + (cfg.num_prefix_tokens if "prefix_feats" in f else 0)
        if "enc_feats" in f and _takes_flash(cfg, f["enc_feats"].shape[0]):
            total += cfg.num_encoder_layers
        if _takes_flash(cfg, t):
            total += per_prompt
    return total


def _dense_serve(model, params, prompts, max_new, counts, *, capture=False,
                 max_len=DENSE_MAX_LEN, num_slots=DENSE_SLOTS, feats=None,
                 **scfg_kw):
    """Serve greedy requests on a fresh engine, one tick at a time, the
    device synchronized after each; ``feats`` gives each request its
    frontend features (a dict each).  Adds the run's kernel launches to
    ``counts``.  Returns tokens per request, the tick that emitted each,
    ms and admission per tick, whether every slot decoded a live request
    at each tick, run seconds, time to the first token of request 0, the
    engine's metrics and ticks, the pool's KV bytes, peak GiB and
    (``capture``) the hidden states of the first pooled decode step."""
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    engine = ServingEngine(model, params, ServeConfig(
        max_len=max_len, num_slots=num_slots, top_k=DENSE_TOP_K,
        max_new_tokens=max(max_new), seed=0, **scfg_kw))
    first_token, first_h = [], {}
    token_ticks = [[] for _ in prompts]

    def on_token(i):
        def record(tok):
            if i == 0 and not first_token:
                first_token.append(time.perf_counter())
            token_ticks[i].append(engine._tick)
        return record

    if capture:
        step = model.decode_step

        def recording(*args, **kwargs):
            caches, h = step(*args, **kwargs)
            first_h.setdefault("h", h.clone())
            return caches, h
        model.decode_step = recording
    launchers = _dense_launchers()
    before = {n: fn.launches for n, fn in launchers.items()}
    try:
        for i, (p, mn) in enumerate(zip(prompts, max_new)):
            engine.submit(Request(prompt=p, max_new_tokens=mn,
                                  on_token=on_token(i),
                                  **(feats[i] if feats else {})))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        results, tick_ms, admitted, full = [], [], [], []
        t0 = time.perf_counter()
        while engine.metrics.completed < len(prompts):
            prefills = engine.metrics.prefills
            live = engine.metrics.live_slot_steps
            t1 = time.perf_counter()
            results += engine.step()
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t1) * 1e3)
            admitted.append(engine.metrics.prefills > prefills)
            full.append(engine.metrics.live_slot_steps - live == num_slots)
        run_s = time.perf_counter() - t0
    finally:
        if capture:
            del model.decode_step
    launched = {n: fn.launches - before[n] for n, fn in launchers.items()}
    for n, c in launched.items():
        counts[n] = counts.get(n, 0) + c
    cfg = model.cfg
    want = {"flash_attention": _expected_flash(model, prompts, feats)}
    cand = scfg_kw.get("candidate_mode") is not None
    if cfg.mach is None:
        want.update(mach_topk=0, bucket_topm=0, mach_candidate_topk=0)
    elif not cand:
        want.update(bucket_topm=0, mach_candidate_topk=0)
    for n, c in want.items():
        if launched[n] != c:
            fail(f"dense serve {cfg.name}: {n} launched {launched[n]} times, "
                 f"expected {c}")
    wanted = (("bucket_topm", "mach_candidate_topk") if cand
              else ("mach_topk",)) if cfg.mach is not None else ()
    if any(launched[n] < 1 for n in wanted):
        fail(f"dense serve {cfg.name}: launches {launched}")
    tokens = [list(r.tokens) for r in sorted(results,
                                             key=lambda r: r.request_id)]
    for i, (toks, mn) in enumerate(zip(tokens, max_new)):
        if len(toks) != mn or not all(0 <= t < model.cfg.vocab_size
                                      for t in toks):
            fail(f"dense serve {model.cfg.name}: request {i} gave {toks}")
    steady = [ms for ms, adm in zip(tick_ms, admitted) if not adm]
    return {"tokens": tokens, "token_ticks": token_ticks, "full": full,
            "tick_ms": tick_ms, "run_s": run_s,
            "launches": launched, "prompt0": len(prompts[0]),
            "ttft_ms": (first_token[0] - t0) * 1e3,
            "decode_ms": statistics.median(steady) if steady else None,
            "tokens_per_s": sum(map(len, tokens)) / run_s,
            "metrics": engine.metrics, "ticks": engine._tick,
            "kv_bytes": _pool_kv_bytes(engine._pool),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "h": first_h.get("h")}


def _worst_case_pages(prompts, max_new) -> int:
    return sum(-(-(len(p) + mn - 1) // DENSE_PAGE)
               for p, mn in zip(prompts, max_new))


def _print_dense_run(label, res, smi) -> None:
    m = res["metrics"]
    pages = (f", pages_peak {m.pages_peak} of {m.num_pages}, fragmentation "
             f"{m.fragmentation}, reservation_failures "
             f"{m.reservation_failures}" if m.num_pages else "")
    decode = ("none" if res["decode_ms"] is None
              else f"{res['decode_ms']:.3f} ms")
    print(f"dense serve {label}: {res['ticks']} ticks, time to first token "
          f"of request 0 ({res['prompt0']:,}-token prompt) "
          f"{res['ttft_ms']:.3f} ms, pooled decode tick after "
          f"admission {decode} (median), {res['tokens_per_s']:.1f} tokens/s, "
          f"pool KV {res['kv_bytes'] / 2**30:.3f} GiB, peak "
          f"{res['peak_gib']:.2f} GiB{pages} [{smi}]", flush=True)


def _newest_masked(cache):
    """A planted fault: the walk sees each slot's index one short, so
    the token just written is masked out."""
    return cache._replace(index=cache.index - 1)


def _last_page_dropped(cache):
    """A planted fault: each slot's newest page is left out of the walk."""
    col = (cache.index.long() - 1).clamp(min=0) // cache.page_size
    return cache._replace(page_table=cache.page_table.scatter(
        1, col[:, None], -1))


# negative controls of the paged hidden-state check: each must fail it
DENSE_FAULTS = {"newest position masked": _newest_masked,
                "last page dropped": _last_page_dropped}


def _faulted_first_step(model, params, prompts, fault) -> torch.Tensor:
    """The paged engine's first pooled decode step's hidden states (the
    first DENSE_SLOTS prompts, as in the engines' runs) with ``fault``
    applied to every cache its page walk reads."""
    from repro_torch.models import attention as attn_lib
    walk = attn_lib.paged_decode_attend

    def planted(q1, cache, **kw):
        return walk(q1, fault(cache), **kw)

    attn_lib.paged_decode_attend = planted
    try:
        res = _dense_serve(model, params, prompts[:DENSE_SLOTS],
                           (2,) * DENSE_SLOTS, {}, capture=True,
                           page_size=DENSE_PAGE)
    finally:
        attn_lib.paged_decode_attend = walk
    return res["h"]


def _paged_rows_ok(err_c, err_p) -> list:
    return [ep <= DENSE_HIDDEN_SLOPE * ec + DENSE_HIDDEN_ATOL
            for ec, ep in zip(err_c, err_p)]


def _rel_l2_rows(got: torch.Tensor, want: torch.Tensor) -> list:
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()


def _first_step_float32(model, params, prompts, first_tokens, dev):
    """The engines' first pooled decode step, recomputed by the same model
    in float32 (the bf16 params cast up, exact) on the same inputs: the
    first DENSE_SLOTS prompts prefilled into slots 0.. of a contiguous
    pool, then one step on their first tokens."""
    import dataclasses

    from repro_torch.models import LanguageModel
    from repro_torch.models.transformer import tree_map

    model32 = LanguageModel(dataclasses.replace(
        model.cfg, dtype=torch.float32, param_dtype=torch.float32))
    params32 = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                        params)
    pool = model32.init_caches(DENSE_SLOTS, DENSE_MAX_LEN, device=dev)
    for i, p in enumerate(prompts[:DENSE_SLOTS]):
        caches, _ = model32.prefill(params32, torch.tensor([p], device=dev),
                                    DENSE_MAX_LEN)
        model32.insert_cache_slot(pool, caches, i)
    last = torch.tensor(first_tokens[:DENSE_SLOTS], device=dev)
    pos = torch.tensor([len(p) for p in prompts[:DENSE_SLOTS]], device=dev)
    _, h = model32.decode_step(params32, pool, last, pos, per_slot=True)
    return model32, params32, h


def _tinyllama_engines(dev, mach: str, prompts, counts, smi) -> dict:
    """tinyllama-1.1b at full width, bf16, ``mach`` head: the workload
    through the contiguous continuous, contiguous lockstep, paged
    (default pool) and paged half-pool engines; with the MACH head also
    the paged engine with candidate_mode = (B, R), and then the same
    model in float32 (the bf16 params cast up) through the contiguous
    and paged engines; with the OAA head 16 paged slots inside the
    4-slot contiguous pool's KV bytes.  Fails unless lockstep ==
    continuous in more ticks; each paged row's hidden state after the
    first pooled decode step is, against the float32 model on the same
    inputs, within DENSE_HIDDEN_SLOPE x the contiguous engine's error +
    DENSE_HIDDEN_ATOL, and each fault of DENSE_FAULTS planted in the
    page walk breaks that limit on some row; the half pool defers
    admissions and finishes; the candidate tokens equal the streaming
    ones; float32 paged tokens equal contiguous ones."""
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel

    cfg = get_config("tinyllama-1.1b", mach=mach)
    model = LanguageModel(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    label = f"tinyllama-1.1b {'MACH' if cfg.mach else 'OAA'}"
    print(f"dense serve: {label} bf16 ({cfg.num_layers} layers, "
          f"d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff "
          f"{cfg.d_ff}, V={cfg.vocab_size}), {n_bytes / 1e9:.3f} GB of params",
          flush=True)
    total = sum(DENSE_MAX_NEW)
    runs = {"contiguous": _dense_serve(model, params, prompts, DENSE_MAX_NEW,
                                       counts, capture=True),
            "paged": _dense_serve(model, params, prompts, DENSE_MAX_NEW,
                                  counts, capture=True, page_size=DENSE_PAGE)}
    cont, paged = runs["contiguous"], runs["paged"]
    runs["lockstep"] = lock = _dense_serve(
        model, params, prompts, DENSE_MAX_NEW, counts, scheduler="lockstep")
    if lock["tokens"] != cont["tokens"]:
        fail(f"dense serve {label}: lockstep tokens differ from continuous")
    if lock["ticks"] <= cont["ticks"]:
        fail(f"dense serve {label}: lockstep took {lock['ticks']} ticks, "
             f"continuous {cont['ticks']}")
    half = _worst_case_pages(prompts, DENSE_MAX_NEW) // 2
    runs["paged half pool"] = _dense_serve(
        model, params, prompts, DENSE_MAX_NEW, counts, page_size=DENSE_PAGE,
        num_pages=half)
    m = runs["paged half pool"]["metrics"]
    if m.reservation_failures < 1 or m.pages_peak > half:
        fail(f"dense serve {label}: a {half}-page pool gave "
             f"{m.reservation_failures} reservation failures, peak "
             f"{m.pages_peak}")
    print(f"dense serve {label}: lockstep == continuous tokens in "
          f"{lock['ticks']} ticks against {cont['ticks']}; paged == "
          f"contiguous greedy tokens {_same_tokens(paged, cont)}/{total}; the "
          f"{half}-page pool (half the workload's worst case) == the default "
          f"pool's {_same_tokens(runs['paged half pool'], paged)}/{total}",
          flush=True)
    if cfg.mach is not None:
        exact = (cfg.mach.num_buckets, cfg.mach.num_repetitions)
        runs["paged candidates"] = _dense_serve(
            model, params, prompts, DENSE_MAX_NEW, counts,
            page_size=DENSE_PAGE, candidate_mode=exact)
        if runs["paged candidates"]["tokens"] != paged["tokens"]:
            fail(f"dense serve {label}: candidate_mode={exact} tokens differ "
                 f"from the streaming paged engine's")
        print(f"dense serve {label}: paged candidate_mode={exact} == "
              f"streaming tokens, bit for bit", flush=True)
    else:
        wide_prompts = prompts + prompts
        kv_page = (2 * cfg.num_layers * DENSE_PAGE * cfg.num_kv_heads
                   * cfg.resolved_head_dim * cfg.dtype.itemsize)
        pages = cont["kv_bytes"] // kv_page - 1      # + the spare page
        runs[f"paged {DENSE_WIDE_SLOTS} slots"] = wide = _dense_serve(
            model, params, wide_prompts, DENSE_MAX_NEW + DENSE_MAX_NEW,
            counts, num_slots=DENSE_WIDE_SLOTS, page_size=DENSE_PAGE,
            num_pages=pages)
        if wide["kv_bytes"] > cont["kv_bytes"]:
            fail(f"dense serve {label}: the {DENSE_WIDE_SLOTS}-slot pool "
                 f"holds {wide['kv_bytes']} KV bytes, more than the "
                 f"contiguous {cont['kv_bytes']}")
        print(f"dense serve {label}: {DENSE_WIDE_SLOTS} slots, "
              f"{len(wide_prompts)} requests, {pages} pages (+1 spare) in "
              f"{wide['kv_bytes']:,} KV bytes (the 4-slot contiguous pool "
              f"{cont['kv_bytes']:,})", flush=True)

    # the first pooled step's hidden states against the float32 model
    firsts = [t[0] for t in cont["tokens"]]
    if [t[0] for t in paged["tokens"]] != firsts:
        fail(f"dense serve {label}: paged and contiguous prefills differ")
    model32, params32, h32 = _first_step_float32(model, params, prompts,
                                                 firsts, dev)
    err_c, err_p = (_rel_l2_rows(r["h"], h32) for r in (cont, paged))
    print(f"dense serve {label}: first pooled decode step's hidden states, "
          f"rel L2 per row: paged vs contiguous "
          f"{[f'{e:.2e}' for e in _rel_l2_rows(paged['h'], cont['h'])]}; "
          f"against the float32 model, contiguous "
          f"{[f'{e:.2e}' for e in err_c]}, paged "
          f"{[f'{e:.2e}' for e in err_p]}", flush=True)
    for i, ok in enumerate(_paged_rows_ok(err_c, err_p)):
        if not ok:
            fail(f"dense serve {label}: row {i}'s paged hidden state is "
                 f"{err_p[i]:.3e} off the float32 model, more than "
                 f"{DENSE_HIDDEN_SLOPE} x the contiguous engine's "
                 f"{err_c[i]:.3e} + 2^-10")
    for name, fault in DENSE_FAULTS.items():
        err_f = _rel_l2_rows(_faulted_first_step(model, params, prompts,
                                                 fault), h32)
        ok = _paged_rows_ok(err_c, err_f)
        print(f"dense serve {label}: negative control, {name} in the page "
              f"walk: rel L2 per row against the float32 model "
              f"{[f'{e:.2e}' for e in err_f]}, rows within the limit {ok}",
              flush=True)
        if all(ok):
            fail(f"dense serve {label}: the paged hidden-state check passed "
                 f"a planted fault ({name})")
    if cfg.mach is not None:
        del model, params
        torch.cuda.empty_cache()
        for name in ("contiguous", "paged"):
            runs[f"float32 {name}"] = _dense_serve(
                model32, params32, prompts, DENSE_MAX_NEW, counts,
                **({"page_size": DENSE_PAGE} if name == "paged" else {}))
        f32 = (runs["float32 contiguous"], runs["float32 paged"])
        if f32[1]["tokens"] != f32[0]["tokens"]:
            fail(f"dense serve {label} float32: paged tokens differ from "
                 f"contiguous ({_same_tokens(*f32)}/{total} equal)")
        print(f"dense serve {label} float32: paged == contiguous tokens, "
              f"{total}/{total}", flush=True)
    for name, res in runs.items():
        _print_dense_run(f"{label} {name}", res, smi)
    del model32, params32
    torch.cuda.empty_cache()
    return {name: {k: v for k, v in res.items() if k not in ("h", "metrics")}
            | {"pages_peak": res["metrics"].pages_peak,
               "fragmentation": res["metrics"].fragmentation,
               "reservation_failures": res["metrics"].reservation_failures}
            for name, res in runs.items()}


def _dense_other(dev, arch, counts, smi) -> dict:
    """``arch`` at full width, bf16, OAA head: a 2,048-token prompt and a
    short one through the paged engine; each first token must equal a
    batch-1 prefill's greedy pick."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel

    t0 = time.perf_counter()
    cfg = get_config(arch)
    model = LanguageModel(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in DENSE_OTHER_PROMPTS]
    max_new = (DENSE_OTHER_MAX_NEW,) * len(prompts)
    res = _dense_serve(model, params, prompts, max_new, counts,
                       max_len=DENSE_OTHER_MAX_LEN, num_slots=len(prompts),
                       page_size=DENSE_PAGE)
    for p, toks in zip(prompts, res["tokens"]):
        _, h = model.prefill(params, torch.tensor([p], device=dev),
                             DENSE_OTHER_MAX_LEN)
        want = int(model.next_token(params, h)[0][0])
        if toks[0] != want:
            fail(f"dense serve {arch}: first token {toks[0]} != a batch-1 "
                 f"prefill's greedy pick {want}")
    print(f"dense serve {arch} ({cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd "
          f"{cfg.resolved_head_dim}, {cfg.norm}, {cfg.activation}), "
          f"{n_bytes / 1e9:.3f} GB of params, set-up and run "
          f"{time.perf_counter() - t0:.1f} s: first tokens == a batch-1 "
          f"prefill's greedy pick; tokens {res['tokens']}", flush=True)
    _print_dense_run(f"{arch} paged", res, smi)
    del model, params
    torch.cuda.empty_cache()
    return {k: v for k, v in res.items() if k not in ("h", "metrics")}


def _add_dense_launches(rows, dense) -> None:
    """Rows 2, 7, 8 and 10 gain their launches on phase 13's path; row 2
    its check, times and bound at tinyllama's MACH head, rows 7 and 8
    their checks at tinyllama's candidate setting, row 10 its checks and
    times at the dense decoders' prefills."""
    for row in rows:
        if row["name"] not in DENSE_KERNELS:
            continue
        row["launches_dense_serve"] = dense["launches"][row["name"]]
        if row["name"] == "mach_topk":
            head = dense["head"]
            row.update({"max_abs_err_dense_head": head["max_abs_err"],
                        "ms_dense_head": head["ms"],
                        "ms_dense_head_graph": head["ms_graph"],
                        "plain_ms_dense_head": head["plain_ms"],
                        "library_ms_dense_head": head["library_ms"],
                        "bound_ms_dense_head": head["bound_ms"],
                        "bound_by_dense_head": head["bound_by"],
                        "shape_dense_head": head["shape"]})
        if row["name"] in ("bucket_topm", "mach_candidate_topk"):
            row["checks_dense_head"] = dense["cand"][row["name"]]
            row["max_abs_err_dense_head"] = dense["cand"]["max_abs_err"]
        if row["name"] == "flash_attention":
            row["dense_prefill"] = dense["flash"]


def phase_dense_serve(dev) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel

    smi = _nvidia_smi()
    head = _dense_head_vs_plain(dev)
    cand = _dense_candidates_vs_plain(dev)
    flash = _flash_times(dev, smi, [_prefill_case(arch) for arch in (
        ("tinyllama-1.1b",) + DENSE_OTHERS)]
        + [_prefill_case("tinyllama-1.1b", torch.float32)])
    rng = np.random.default_rng(0)
    vocab = get_config("tinyllama-1.1b").vocab_size
    prompts = [rng.integers(0, vocab, n).tolist() for n in DENSE_PROMPTS]
    # the path's run: counts from 0, read just after
    for fn in _dense_launchers().values():
        fn.launches = 0
    counts = {}
    out = {"head": head, "cand": cand, "flash": flash, "tinyllama": {}}
    for mach in ("on", "off"):
        out["tinyllama"][mach] = _tinyllama_engines(dev, mach, prompts,
                                                    counts, smi)
    for arch in DENSE_OTHERS:
        out[arch] = _dense_other(dev, arch, counts, smi)
    if min(counts.values()) < 1:
        fail(f"dense serve: a kernel of the path never ran: {counts}")
    out["launches"] = counts
    # mistral-large-123b: sized, and served at its smoke config
    big = get_config("mistral-large-123b")
    size = big.param_count_estimate() * 2
    total = torch.cuda.get_device_properties(dev).total_memory
    model = LanguageModel(get_config("mistral-large-123b", smoke=True))
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    res = _dense_serve(model, params, [[1, 2, 3], [4, 5, 6, 7, 8]], (4, 4),
                       {}, max_len=64, num_slots=2, page_size=DENSE_PAGE)
    print(f"dense serve mistral-large-123b: {big.param_count_estimate():,} "
          f"params = {size / 1e9:.1f} GB in bf16 does not fit the card's "
          f"{total / 1e9:.1f} GB; its smoke config served paged: tokens "
          f"{res['tokens']}", flush=True)
    print(f"dense serve launches on the path: {counts} [{smi}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: the MoE block; qwen2-moe-a2.7b served and trained; mixtral sized
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
# block checks: 4 groups of 512 (cap 42), one padded group, a 4-slot decode
# (one group of 4, cap 1)
MOE_BLOCK_N = (2048, 2049, 4)
MOE_SEED_TRIES = 8           # input seeds tried until a choice is dropped
MOE_F32_TOL = 1e-5           # rtol, and atol of the largest entry
MOE_BF16_REL_L2 = 2.0 ** -8
MOE_CUT = 4                  # layers of the float32 and training cuts
MOE_TRAIN_STEPS = 3
MOE_KERNELS = ("mach_xent_fwd", "mach_xent_bwd", "flash_attention",
               "flash_attention_bwd")


def _moe_kwargs(cfg, activation=True) -> dict:
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_top_k,
              capacity_factor=cfg.capacity_factor,
              group_size=cfg.moe_group_size)
    return dict(kw, activation=cfg.activation) if activation else kw


def _dropped_share(r) -> float:
    """The share of a routing's real tokens' choices that capacity dropped."""
    keep = r.keep.reshape(-1, r.keep.shape[-1])[:r.n]
    return 1.0 - float(keep.float().mean())


def _moe_close(tag, got, want, dtype) -> float:
    """float32: rtol MOE_F32_TOL, atol MOE_F32_TOL of the largest entry
    (returns the max abs error); bf16: relative L2 within 2^-8 (returns
    it).  The CPU tests' rules."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=MOE_F32_TOL,
                              atol=MOE_F32_TOL * float(want.abs().max())):
            fail(f"{tag}: apply_moe vs moe_ref max abs err {err:.3e}")
        return err
    rel = float((got - want).norm() / want.norm().clamp(min=1e-30))
    if rel > MOE_BF16_REL_L2:
        fail(f"{tag}: apply_moe vs moe_ref rel L2 {rel:.3e} > 2^-8")
    return rel


def _moe_block_vs_ref(dev, cfg, smi) -> dict:
    """``apply_moe`` against ``moe_ref`` on the card at ``cfg``'s full
    block widths, float32 and bf16, at each n of MOE_BLOCK_N: expert ids
    and the kept mask equal, y and the aux losses by ``_moe_close`` (aux in
    float32 in both).  The inputs come from the first seed (of
    MOE_SEED_TRIES) whose float32 routing drops a choice."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import tree_map

    params = moe.init_moe(torch.Generator(device=dev).manual_seed(0),
                          cfg.d_model, cfg.moe_d_ff, cfg.num_experts,
                          cfg.num_shared_experts, cfg.shared_d_ff, dev,
                          cfg.activation)
    kw, rkw = _moe_kwargs(cfg), _moe_kwargs(cfg, activation=False)
    out = {}
    for n in MOE_BLOCK_N:
        for seed in range(MOE_SEED_TRIES):
            x = torch.randn((1, n, cfg.d_model), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(seed))
            if _dropped_share(moe.route(params, x, **rkw)) > 0:
                break
        else:
            fail(f"moe block n={n}: no seed of {MOE_SEED_TRIES} drops a choice")
        row = {"seed": seed}
        for dtype in (torch.float32, torch.bfloat16):
            p = tree_map(lambda t: t.to(dtype), params)
            xd = x.to(dtype)
            r = moe.route(p, xd, **rkw)
            y, aux = moe.apply_moe(p, xd, **kw)
            ry, raux, ids, keep = moe.moe_ref(p, xd, **kw)
            torch.cuda.synchronize()
            tag = f"moe block n={n} {str(dtype).removeprefix('torch.')}"
            if not (torch.equal(ids, r.experts) and torch.equal(keep, r.keep)):
                fail(f"{tag}: expert ids or the kept mask differ from moe_ref")
            if not torch.isfinite(y.float()).all():
                fail(f"{tag}: non-finite output")
            err = _moe_close(f"{tag} y", y, ry, dtype)
            err_aux = max(_moe_close(f"{tag} {k}", aux[k], raux[k],
                                     torch.float32) for k in aux)
            row[str(dtype).removeprefix("torch.")] = {
                "dropped": _dropped_share(r), "err_y": err, "err_aux": err_aux,
                "groups": r.logits.shape[0], "cap": r.cap}
            del p, xd, y, ry
        f32, bf16 = row["float32"], row["bfloat16"]
        print(f"moe block n={n} ({f32['groups']} groups, cap {f32['cap']}; "
              f"input seed {seed}): apply_moe == moe_ref ids and kept mask; "
              f"float32 y max abs err {f32['err_y']:.3e}, aux "
              f"{f32['err_aux']:.3e}; bf16 y rel L2 {bf16['err_y']:.3e}, aux "
              f"{bf16['err_aux']:.3e}; dropped share of choices float32 "
              f"{f32['dropped']:.4f}, bf16 {bf16['dropped']:.4f} (d="
              f"{cfg.d_model}, E={cfg.num_experts}, top-{cfg.experts_top_k}, "
              f"f={cfg.moe_d_ff}, {cfg.num_shared_experts} shared of "
              f"{cfg.shared_d_ff}) [{smi}]", flush=True)
        out[n] = row
    del params
    torch.cuda.empty_cache()
    return out


def _shared_prefix(a: dict, b: dict) -> list:
    """The (request, token) pairs two runs of the same requests must agree
    on under MoE blocks, which couple a pooled decode step's rows through
    expert capacity: each request's first token (its batch-1 prefill), and
    every token emitted before either run first decoded a pool with a slot
    not holding a live request (a free slot, or lockstep's held row: those
    rows differ between schedulers and layouts)."""
    stop = min(r["full"].index(False) if False in r["full"]
               else len(r["full"]) for r in (a, b))
    return [(i, j) for i, ticks in enumerate(a["token_ticks"])
            for j, tick in enumerate(ticks) if j == 0 or tick < stop]


def _same_on(pairs, a, b) -> int:
    return sum(a["tokens"][i][j] == b["tokens"][i][j] for i, j in pairs)


def _same_tokens(a, b) -> int:
    return sum(x == y for ra, rb in zip(a["tokens"], b["tokens"])
               for x, y in zip(ra, rb))


def _record_routing(first: dict):
    """Wrap ``moe.route`` so that the first routing of a (B, T) input
    shape in ``first`` (keyed by shape) is kept there; returns the undo."""
    from repro_torch.models import moe
    route = moe.route

    def recording(params, x, **kw):
        r = route(params, x, **kw)
        key = tuple(x.shape[:2])
        if key in first and first[key] is None:
            first[key] = _dropped_share(r)
        return r

    moe.route = recording
    return lambda: setattr(moe, "route", route)


def _moe_engines(dev, cfg, smi) -> dict:
    """qwen2-moe-a2.7b at full width (bf16, MACH head): the 8-request
    ragged mix through the contiguous continuous, lockstep, paged and
    contiguous candidate_mode = (B, R) engines, launch counters from 0
    over the four runs.  Each first token must equal a batch-1 prefill's
    greedy pick; lockstep tokens must equal continuous ones on
    ``_shared_prefix`` (and take more ticks); candidate tokens must equal
    streaming ones bit for bit; paged tokens are reported.  Returns the
    runs, the launches and the first 4-layer cut of the params (cloned,
    bf16); the full params are freed."""
    import numpy as np

    from repro_torch.models import LanguageModel

    t0 = time.perf_counter()
    model = LanguageModel(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"moe serve: {cfg.name} bf16 ({cfg.num_layers} layers, d="
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.num_experts} experts top-{cfg.experts_top_k} of f="
          f"{cfg.moe_d_ff} + {cfg.num_shared_experts} shared of "
          f"{cfg.shared_d_ff}, groups of {cfg.moe_group_size}, V="
          f"{cfg.vocab_size}, MACH B={cfg.mach.num_buckets} R="
          f"{cfg.mach.num_repetitions}), {n_bytes / 1e9:.3f} GB of params "
          f"(param_count_estimate {cfg.param_count_estimate():,}), drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in DENSE_PROMPTS]
    exact = (cfg.mach.num_buckets, cfg.mach.num_repetitions)
    # the path's run: counts from 0, read just after
    for fn in _dense_launchers().values():
        fn.launches = 0
    counts: dict = {}
    runs = {"contiguous": _dense_serve(model, params, prompts, DENSE_MAX_NEW,
                                       counts),
            "lockstep": _dense_serve(model, params, prompts, DENSE_MAX_NEW,
                                     counts, scheduler="lockstep"),
            "paged": _dense_serve(model, params, prompts, DENSE_MAX_NEW,
                                  counts, page_size=DENSE_PAGE)}
    first = {(1, DENSE_PROMPTS[0]): None, (DENSE_SLOTS, 1): None}
    undo = _record_routing(first)
    try:
        runs["candidates"] = _dense_serve(model, params, prompts,
                                          DENSE_MAX_NEW, counts,
                                          candidate_mode=exact)
    finally:
        undo()
    launches = dict(counts)
    if min(launches.values()) < 1:
        fail(f"moe serve: a kernel of the path never ran: {launches}")
    cont, lock = runs["contiguous"], runs["lockstep"]
    total = sum(DENSE_MAX_NEW)
    if runs["candidates"]["tokens"] != cont["tokens"]:
        fail(f"moe serve: candidate_mode={exact} tokens differ from the "
             f"streaming engine's")
    pairs = _shared_prefix(cont, lock)
    if _same_on(pairs, cont, lock) != len(pairs):
        fail(f"moe serve: lockstep tokens differ from continuous ones while "
             f"their pools match ({_same_on(pairs, cont, lock)}/{len(pairs)})")
    if lock["ticks"] <= cont["ticks"]:
        fail(f"moe serve: lockstep took {lock['ticks']} ticks, continuous "
             f"{cont['ticks']}")
    for i, p in enumerate(prompts):
        _, h = model.prefill(params, torch.tensor([p], device=dev),
                             DENSE_MAX_LEN)
        want = int(model.next_token(params, h)[0][0])
        for name, res in runs.items():
            got = res["tokens"][i][0]
            if got != want:
                fail(f"moe serve {name}: first token {got} of a {len(p)}-token "
                     f"prompt != a batch-1 prefill's greedy pick {want}")
    print(f"moe serve {cfg.name}: first tokens == a batch-1 prefill's greedy "
          f"pick in every engine; candidate_mode={exact} == streaming tokens, "
          f"{total}/{total}; lockstep == continuous on the {len(pairs)} tokens "
          f"emitted while their pools match ({_same_tokens(lock, cont)}/"
          f"{total} in all, {lock['ticks']} ticks against {cont['ticks']}); "
          f"paged == contiguous {_same_tokens(runs['paged'], cont)}/{total} "
          f"(reported: capacity couples the rows); dropped share of choices "
          f"in layer 0: the {DENSE_PROMPTS[0]:,}-token prefill "
          f"{first[(1, DENSE_PROMPTS[0])]:.4f}, the first {DENSE_SLOTS}-slot "
          f"decode step {first[(DENSE_SLOTS, 1)]:.4f}", flush=True)
    for name, res in runs.items():
        _print_dense_run(f"{cfg.name} {name}", res, smi)
    print(f"moe serve launches on the path: {launches} [{smi}]", flush=True)
    from repro_torch.models.transformer import tree_map
    cut = {k: v for k, v in params.items() if k != "stacks"}
    cut["stacks"] = [[tree_map(lambda t: t[:MOE_CUT], p) for p in st]
                     for st in params["stacks"]]
    cut = tree_map(torch.Tensor.clone, cut)
    del model, params
    torch.cuda.empty_cache()
    return {"runs": {name: {k: v for k, v in res.items()
                            if k not in ("h", "metrics")}
                     for name, res in runs.items()},
            "launches": launches, "prompts": prompts, "cut": cut,
            "dropped_prefill": first[(1, DENSE_PROMPTS[0])],
            "dropped_decode": first[(DENSE_SLOTS, 1)]}


def _moe_cut_float32(dev, cfg, cut, prompts, smi) -> dict:
    """The MOE_CUT-layer cut in float32 (the bf16 params cast up): the
    ragged mix through the contiguous and paged engines; paged greedy
    tokens must equal contiguous ones exactly on ``_shared_prefix``."""
    import dataclasses

    from repro_torch.models import LanguageModel
    from repro_torch.models.transformer import tree_map

    model = LanguageModel(dataclasses.replace(
        cfg, num_layers=MOE_CUT, dtype=torch.float32,
        param_dtype=torch.float32))
    params = tree_map(lambda t: t.float() if t.is_floating_point() else t, cut)
    n_params = sum(t.numel() for t in _leaves(params))
    runs = {name: _dense_serve(model, params, prompts, DENSE_MAX_NEW, {},
                               **kw)
            for name, kw in (("contiguous", {}),
                             ("paged", {"page_size": DENSE_PAGE}))}
    cont, paged = runs["contiguous"], runs["paged"]
    pairs = _shared_prefix(cont, paged)
    same = _same_on(pairs, cont, paged)
    if same != len(pairs):
        fail(f"moe float32 cut: paged tokens differ from contiguous ones "
             f"while every slot is live ({same}/{len(pairs)})")
    total = sum(DENSE_MAX_NEW)
    print(f"moe float32 cut ({MOE_CUT} of {cfg.num_layers} layers, every "
          f"width kept, {n_params:,} params): paged == contiguous on the "
          f"{len(pairs)} tokens emitted before a slot fell free "
          f"({_same_tokens(paged, cont)}/{total} in all)", flush=True)
    for name, res in runs.items():
        _print_dense_run(f"{cfg.name} float32 cut {name}", res, smi)
    del model, params
    torch.cuda.empty_cache()
    return {name: {k: v for k, v in res.items() if k not in ("h", "metrics")}
            for name, res in runs.items()} | {"shared_prefix": len(pairs)}


def _moe_train(dev, cfg, params, smi) -> dict:
    """The MOE_CUT-layer cut (bf16, remat) trained MOE_TRAIN_STEPS AdamW
    steps on TRAIN_BATCH x TRAIN_SEQ tokens through ``Trainer.step_fn``:
    first the router's gradient on batch 0 (nonzero in every layer), then
    launch counters from 0 over the steps: kernels 3 and 10 forward and
    backward at their counts a step; every loss, load_balance and
    router_z finite, the last two positive."""
    import dataclasses

    from repro_torch.data import LMDataConfig, SyntheticLMStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mach_xent as mx
    from repro_torch.models import LanguageModel
    from repro_torch.optim import value_and_grad
    from repro_torch.train import TrainConfig, Trainer, new_train_state

    full_layers = cfg.num_layers
    cfg = dataclasses.replace(cfg, num_layers=MOE_CUT)
    model = LanguageModel(cfg)
    tcfg = TrainConfig(total_steps=MOE_TRAIN_STEPS, warmup_steps=2,
                       peak_lr=3e-4, log_every=MOE_TRAIN_STEPS)
    trainer = Trainer(model, tcfg)
    stream = SyntheticLMStream(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0), device=dev)
    (_, met0), grads = value_and_grad(model.loss, params, stream.batch_at(0),
                                      has_aux=True)
    router = grads["stacks"][0][0]["moe"]["router"]["kernel"].float()
    router_norms = router.flatten(1).norm(dim=1).tolist()
    del grads
    torch.cuda.empty_cache()
    if not all(v > 0 and math.isfinite(v) for v in router_norms):
        fail(f"moe train: the router's gradient norms by layer {router_norms}")
    kernels = {"mach_xent_fwd": mx.mach_xent_cuda_fwd,
               "mach_xent_bwd": mx.mach_xent_cuda_bwd,
               "flash_attention": fa.flash_attention_cuda,
               "flash_attention_bwd": fa.flash_attention_bwd_cuda}
    # the path's run: counts from 0, read just after
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    state = new_train_state(params, trainer.opt)
    del params
    step_ms, metrics = [], []
    for s in range(MOE_TRAIN_STEPS):
        t1 = time.perf_counter()
        state, met = trainer.step_fn(state, stream.batch_at(s))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        metrics.append({k: float(met[k]) for k in ("loss", "load_balance",
                                                   "router_z", "grad_norm")})
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    n_attn = cfg.layout().count("moe")
    expected = {"mach_xent_fwd": 1, "mach_xent_bwd": 1,
                "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    for name, per_step in expected.items():
        if launches[name] != per_step * MOE_TRAIN_STEPS:
            fail(f"moe train: {name} launched {launches[name]} times, "
                 f"expected {per_step} a step")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()) or \
                m["load_balance"] <= 0 or m["router_z"] <= 0:
            fail(f"moe train: metrics {metrics}")
    n_params = sum(t.numel() for t in _leaves(state.params))
    del state
    torch.cuda.empty_cache()
    ms = statistics.median(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"moe train: {cfg.name} cut to {MOE_CUT} of {full_layers} layers (every width "
          f"kept, {n_params:,} params, bf16, remat={cfg.remat}), "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, AdamW: router gradient norms "
          f"by layer {[f'{v:.3e}' for v in router_norms]} (batch 0, loss "
          f"{float(met0['loss']):.4f}); metrics by step {metrics}; launches "
          f"{launches} (a step: {expected}); {ms:.3f} ms/step (host clock, "
          f"median of steps 2..{MOE_TRAIN_STEPS}; the first {step_ms[0]:.3f} "
          f"ms), {tokens / ms * 1e3:.1f} tokens/s, peak {peak_gib:.2f} GiB "
          f"[{smi}]", flush=True)
    return {"launches": launches, "metrics": metrics, "step_ms": ms,
            "step_ms_all": step_ms, "peak_gib": peak_gib,
            "router_grad_norms": router_norms, "params": n_params}


def _mixtral(dev) -> dict:
    """mixtral-8x22b sized (param_count_estimate within (120e9, 150e9),
    the JAX package's bound), and its smoke config (SWA window 8, ring
    caches, OAA head) served through the paged engine."""
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel

    big = get_config("mixtral-8x22b")
    n = big.param_count_estimate()
    if not 120e9 < n < 150e9:
        fail(f"mixtral-8x22b: param_count_estimate {n:,} outside (120e9, "
             f"150e9)")
    total = torch.cuda.get_device_properties(dev).total_memory
    model = LanguageModel(get_config("mixtral-8x22b", smoke=True))
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    res = _dense_serve(model, params, [[1, 2, 3], list(range(4, 17))], (6, 6),
                       {}, max_len=64, num_slots=2, page_size=DENSE_PAGE)
    print(f"moe serve mixtral-8x22b: {n:,} params = {n * 2 / 1e9:.1f} GB in "
          f"bf16 does not fit the card's {total / 1e9:.1f} GB; its smoke "
          f"config (window {model.cfg.window}, ring caches) served paged: "
          f"tokens {res['tokens']}", flush=True)
    return {"params": n, "tokens": res["tokens"]}


def phase_moe(dev) -> dict:
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    smi = _nvidia_smi()
    cfg = get_config(MOE_ARCH)
    out = {"head": _dense_head_vs_plain(dev, MOE_ARCH),
           "cand": _dense_candidates_vs_plain(dev, MOE_ARCH),
           "flash": _flash_times(dev, smi, [_prefill_case(MOE_ARCH)]),
           "block": _moe_block_vs_ref(dev, cfg, smi)}
    serve = _moe_engines(dev, cfg, smi)
    cut = serve.pop("cut")
    out["serve"] = serve
    out["float32_cut"] = _moe_cut_float32(dev, cfg, cut, serve["prompts"], smi)
    out["train"] = _moe_train(dev, cfg, cut, smi)
    del cut
    out["mixtral"] = _mixtral(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"moe: phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def _add_moe_launches(rows, moe) -> None:
    """Rows 2, 7, 8 and 10 gain their launches on the MoE serving path,
    rows 3 and 10 (forward and backward) on its training cut; row 2 its
    check, times and bound at qwen2-moe's MACH head, rows 7 and 8 their
    checks at its (2048, 8), row 10 its check and times at its prefill."""
    for row in rows:
        name = row["name"]
        if name in DENSE_KERNELS:
            row["launches_moe_serve"] = moe["serve"]["launches"][name]
        if name in MOE_KERNELS:
            row["launches_moe_train"] = moe["train"]["launches"][name]
        if name == "mach_topk":
            head = moe["head"]
            row.update({f"{k}_moe_head": head[k] for k in (
                "max_abs_err", "ms", "ms_graph", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "shape")})
        if name in ("bucket_topm", "mach_candidate_topk"):
            row["checks_moe_head"] = moe["cand"][name]
            row["max_abs_err_moe_head"] = moe["cand"]["max_abs_err"]
        if name == "flash_attention":
            row["moe_prefill"] = moe["flash"]


def _add_new_path_launches(rows, fused, selection) -> None:
    """Kernel 4's launches on the fused LM loss's path (its LM-head row),
    and kernels 4-6's on the selected training paths (their training
    rows), with the kernels' times, errors and bounds at B' = c_sel."""
    families = {"mach_fused_xent_dense": "dense",
                "mach_fused_xent_ell": "ell",
                "mach_fused_xent_gather": "gather"}
    for row in rows:
        family = families.get(row["name"])
        if family is None:
            continue
        if "train_step_ms" not in row:           # kernel 4 at the LM head
            row["launches_lm_path"] = (fused["launches"]["dense_fwd"]
                                       + fused["launches"]["dense_bwd"])
            row["lm_fused_step_ms"] = fused["step_ms"]
            row["lm_fused_peak_gib"] = fused["peak_gib"]
            continue
        label = next(lb for lb, _, f in SELECT_RUNS if f == family)
        on = selection["runs"][label, "on"]
        off = selection["runs"][label, "off"]
        chk = selection["checks"][family]
        row.update({
            "launches_selected": on["launches"],
            "max_abs_err_selected": chk["max_abs_err"],
            "ms_selected": chk["ms_fwd_selected"] + chk["ms_bwd_selected"],
            "ms_fwd_selected": chk["ms_fwd_selected"],
            "ms_bwd_selected": chk["ms_bwd_selected"],
            "ms_full_b_same_inputs": chk["ms_fwd_full"] + chk["ms_bwd_full"],
            "ms_fwd_full_b": chk["ms_fwd_full"],
            "ms_bwd_full_b": chk["ms_bwd_full"],
            "bound_ms_selected": chk["bound_ms_selected"],
            "bound_ms_full_b": chk["bound_ms_full"],
            "library_ms_selected": chk["library_ms_selected"],
            "library_ms_full_b": chk["library_ms_full"],
            "max_abs_err_full_b": chk.get("max_abs_err_full_b"),
            "selected_shape": (f"{label}: N={SELECT['N']} d={SELECT['d']} "
                               f"R={SELECT['R']} B'={SELECT['c_sel']} of "
                               f"B={SELECT['B']}, float32, with bias"),
            "selected_train_step_ms": on["ms"],
            "unselected_train_step_ms": off["ms"],
            "selected_peak_gib": on["peak_gib"],
            "unselected_peak_gib": off["peak_gib"]})


# ---------------------------------------------------------------------------
# phase 15: xlstm-350m, seamless-m4t-large-v2 and paligemma-3b served and
# trained at full width
# ---------------------------------------------------------------------------

XLSTM_ARCH = "xlstm-350m"
ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH = "paligemma-3b"
ENC_FRAMES = 3072            # a request's audio frames: a multiple of chunk_k
# paligemma's prompts: 256 patches + 1,792 tokens = 2,048, the flash branch
VLM_PROMPTS = (1792, 5, 77, 300, 1000, 17, 1792, 40)
OTHER_TRAIN_STEPS = 3
ENC_TRAIN_FRAMES = 1024      # launch/train.py's seq_len // 4 at 4,096
# (arch, mach, batch, text tokens a row, every loss and gradient norm
# held finite, steps): seamless and paligemma at 4,096 positions a row;
# xlstm cut in sequence (its sLSTM runs T eager steps a layer, forward,
# again under remat, and backward) to 1,024 and to XLSTM_FINITE_T.  At
# random init the sLSTM's gradients through time overflow (the JAX
# package's too, ROADMAP.md §3): at 1,024 tokens the gradient norm is
# non-finite from the first step, so only its first loss is held and its
# second step (~35 s) runs on non-finite parameters, timed; at
# XLSTM_FINITE_T every loss and gradient norm is held, the 24-layer
# backward checked on the card.
XLSTM_FINITE_T = 64
# xlstm-350m's depth on phase 15's path: two of its 12 (mLSTM, sLSTM)
# periods, every width.  The sLSTM's eager scan took most of the phase
# at all 24 layers (a 1,024-token training step ~32 s, a 2,048-token
# prefill ~5 s); each kernel of the path (1, 2, 3) runs at the head,
# whose shape depth does not change, and the block checks read layer 0.
XLSTM_LAYERS = 4
OTHER_TRAIN = [
    (ENCDEC_ARCH, "auto", TRAIN_BATCH, TRAIN_SEQ, True, OTHER_TRAIN_STEPS),
    (VLM_ARCH, "auto", TRAIN_BATCH, TRAIN_SEQ - 256, True,
     OTHER_TRAIN_STEPS),
    (XLSTM_ARCH, "on", TRAIN_BATCH, 1024, False, 2),
    (XLSTM_ARCH, "on", TRAIN_BATCH, XLSTM_FINITE_T, True, OTHER_TRAIN_STEPS)]
OTHER_KERNELS = ("mach_decode", "mach_topk", "mach_xent_fwd", "mach_xent_bwd",
                 "flash_attention", "flash_attention_bwd")
# xLSTM blocks at full width in float32: step form against the prefill
# and card against CPU (rel L2), over a long prompt's length
XLSTM_CONSISTENCY_TOL = 2.0 ** -12
XLSTM_BLOCK_T = 2048


def _other_launchers() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt
    from repro_torch.kernels import mach_xent as mx
    return {"mach_decode": md.mach_decode_cuda, "mach_topk": mt.mach_topk_cuda,
            "mach_xent_fwd": mx.mach_xent_cuda_fwd,
            "mach_xent_bwd": mx.mach_xent_cuda_bwd,
            "flash_attention": fa.flash_attention_cuda,
            "flash_attention_bwd": fa.flash_attention_bwd_cuda}


def _request_feats(dev, cfg, n: int) -> list:
    """Each of ``n`` requests' frontend features, drawn on the card: an
    enc-dec model's (ENC_FRAMES, 1,024) audio frames, a vision model's
    (256, 1,152) patches; empty dicts otherwise."""
    from repro_torch.models import frontends

    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for _ in range(n):
        f = {}
        if cfg.num_encoder_layers:
            f["enc_feats"] = torch.randn(
                (ENC_FRAMES, frontends.AUDIO_FEATURE_DIM), generator=gen,
                device=dev)
        if cfg.frontend == "vision":
            f["prefix_feats"] = torch.randn(
                (cfg.num_prefix_tokens, frontends.VISION_FEATURE_DIM),
                generator=gen, device=dev)
        out.append(f)
    return out


def _prefill_one(model, params, prompt, feats, dev):
    """A batch-1 prefill at DENSE_MAX_LEN with the request's features:
    (caches, enc_kvs, last hidden)."""
    kvs = None
    if "enc_feats" in feats:
        with torch.no_grad():
            kvs = model.enc_kvs(params, model.encode(
                params, feats["enc_feats"][None]))
    prefix = feats.get("prefix_feats")
    caches, h = model.prefill(
        params, torch.tensor([prompt], device=dev), DENSE_MAX_LEN, enc_kvs=kvs,
        prefix_feats=None if prefix is None else prefix[None])
    return caches, kvs, h


def _direct_greedy_waves(model, params, prompts, max_new, feats, dev):
    """Greedy tokens straight off the model API: batch-1 prefills, then
    ``decode_step`` + ``next_token`` (kernel 1 on a MACH head) over a
    DENSE_SLOTS-row pool, the requests taken DENSE_SLOTS at a time (a
    row's result depends on the pool's shape, not on its neighbours)."""
    from repro_torch.models.transformer import tree_map

    out = [None] * len(prompts)
    for w0 in range(0, len(prompts), DENSE_SLOTS):
        wave = list(range(w0, min(w0 + DENSE_SLOTS, len(prompts))))
        pool = model.init_caches(DENSE_SLOTS, DENSE_MAX_LEN, device=dev)
        enc_pool, toks = None, {}
        for slot, i in enumerate(wave):
            caches, kvs, h = _prefill_one(model, params, prompts[i], feats[i],
                                          dev)
            model.insert_cache_slot(pool, caches, slot)
            if kvs is not None:
                if enc_pool is None:
                    enc_pool = tree_map(lambda x: x.new_zeros(
                        x.shape[:1] + (DENSE_SLOTS,) + x.shape[2:]), kvs)
                model.insert_cache_slot(enc_pool, kvs, slot)
            toks[i] = [int(model.next_token(params, h)[0][0])]
        pad = DENSE_SLOTS - len(wave)
        prefix = [model.cfg.num_prefix_tokens if "prefix_feats" in feats[i]
                  else 0 for i in wave]
        for step in range(1, max(max_new[i] for i in wave)):
            last = torch.tensor([toks[i][-1] for i in wave] + [0] * pad,
                                device=dev)
            pos = torch.tensor([prefix[j] + len(prompts[i]) + step - 1
                                for j, i in enumerate(wave)] + [0] * pad,
                               device=dev)
            pool, h = model.decode_step(params, pool, last, pos,
                                        per_slot=True, enc_kvs=enc_pool)
            ids = model.next_token(params, h)[0].tolist()
            for slot, i in enumerate(wave):
                toks[i].append(ids[slot])
        for i in wave:
            out[i] = toks[i][:max_new[i]]
    return out


def _xlstm_cut(cfg):
    """xlstm-350m at XLSTM_LAYERS layers on phase 15's path; the other
    models as they are."""
    if cfg.name != XLSTM_ARCH:
        return cfg
    return dataclasses.replace(cfg, num_layers=XLSTM_LAYERS)


def _model_on_card(dev, cfg):
    from repro_torch.models import LanguageModel

    t0 = time.perf_counter()
    model = LanguageModel(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    head = (f"MACH B={cfg.mach.num_buckets} R={cfg.mach.num_repetitions}"
            if cfg.mach is not None else "OAA")
    print(f"other archs: {cfg.name} bf16 ({cfg.num_layers} layers"
          f"{f' + {cfg.num_encoder_layers} encoder' if cfg.num_encoder_layers else ''}"
          f", d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"pattern {cfg.block_pattern}, V={cfg.vocab_size}, {head}), "
          f"{n:,} params (param_count_estimate "
          f"{cfg.param_count_estimate():,}), drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model, params, n


def _other_engines(dev, cfg, prompt_lens, engines, smi, direct=True) -> dict:
    """``cfg`` at full width (bf16, seeded random weights) serving the
    8-request ragged mix over DENSE_SLOTS slots through ``engines`` (name
    -> ServeConfig keywords), each request with its frontend features;
    lockstep's tokens must equal the contiguous engine's.  Then
    (``direct``) the direct greedy loop, whose tokens the contiguous
    engine's must equal, and whose batch-1 prefills' greedy picks every
    engine's first tokens."""
    import numpy as np

    model, params, n_params = _model_on_card(dev, cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in prompt_lens]
    feats = _request_feats(dev, cfg, len(prompts))
    runs = {name: _dense_serve(model, params, prompts, DENSE_MAX_NEW, {},
                               feats=feats, **kw)
            for name, kw in engines.items()}
    cont = runs["contiguous"]
    total = sum(DENSE_MAX_NEW)
    if "lockstep" in runs:
        lock = runs["lockstep"]
        if lock["tokens"] != cont["tokens"] or lock["ticks"] <= cont["ticks"]:
            fail(f"other archs {cfg.name}: lockstep tokens "
                 f"({_same_tokens(lock, cont)}/{total} equal) or ticks "
                 f"({lock['ticks']} against {cont['ticks']}) wrong")
    out = {"runs": runs, "params": n_params, "prompts": prompt_lens}
    others = {name: _same_tokens(res, cont) for name, res in runs.items()
              if name != "contiguous"}
    checked = "lockstep == contiguous" if "lockstep" in runs else ""
    if direct:
        t0 = time.perf_counter()
        toks = _direct_greedy_waves(model, params, prompts, DENSE_MAX_NEW,
                                    feats, dev)
        out["direct_s"] = time.perf_counter() - t0
        same = sum(a == b for ra, rb in zip(toks, cont["tokens"])
                   for a, b in zip(ra, rb))
        if toks != cont["tokens"]:
            fail(f"other archs {cfg.name}: the direct greedy loop's tokens "
                 f"differ from the engine's ({same}/{total})")
        for name, res in runs.items():
            for i, tk in enumerate(toks):
                if res["tokens"][i][0] != tk[0]:
                    fail(f"other archs {cfg.name} {name}: first token "
                         f"{res['tokens'][i][0]} of request {i} != a batch-1 "
                         f"prefill's greedy pick {tk[0]}")
        checked = (f"first tokens == a batch-1 prefill's greedy pick in "
                   f"every engine; contiguous == the direct greedy loop, "
                   f"{total}/{total} ({out['direct_s']:.1f} s)")
    print(f"other archs {cfg.name}: {checked}; tokens equal to contiguous: "
          f"{others} of {total}", flush=True)
    for name, res in runs.items():
        _print_dense_run(f"{cfg.name} {name}", res, smi)
    out["model"], out["params_tree"], out["feats"] = model, params, feats
    out["prompt_tokens"] = prompts
    return out


def _flash_vs_dense_full_width(dev, served, smi) -> dict:
    """The longest request's prefill at full width through the flash
    branch (kernel 10: seamless's encoder non-causal and its
    cross-attention at S != T, paligemma's prefix + prompt causal),
    against the same model in float32 (the bf16 params cast up) on the
    dense branch: the bf16 flash hidden state's relative L2 error at most
    twice the bf16 dense branch's, plus 2^-9 (phase 8's rule)."""
    import dataclasses

    from repro_torch.models import LanguageModel
    from repro_torch.models.transformer import tree_map

    model, params = served["model"], served["params_tree"]
    i = int(max(range(len(served["prompts"])),
                key=lambda j: served["prompts"][j]))
    prompt, feats = served["prompt_tokens"][i], served["feats"][i]
    dense_cfg = dataclasses.replace(model.cfg, flash_threshold=1 << 30)
    h_flash = _prefill_one(model, params, prompt, feats, dev)[2].float()
    dense = LanguageModel(dense_cfg)
    h_dense = _prefill_one(dense, params, prompt, feats, dev)[2].float()
    f32 = LanguageModel(dataclasses.replace(dense_cfg, dtype=torch.float32,
                                            param_dtype=None))
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    truth = _prefill_one(f32, p32, prompt, feats, dev)[2]
    del p32
    torch.cuda.empty_cache()
    err_flash, err_dense = _rel_l2(h_flash, truth), _rel_l2(h_dense, truth)
    if not err_flash <= 2 * err_dense + 2.0 ** -9:
        fail(f"other archs {model.cfg.name}: the flash prefill's rel L2 "
             f"{err_flash:.3e} to float32 > 2 x the dense branch's "
             f"{err_dense:.3e} + 2^-9")
    print(f"other archs {model.cfg.name}: the {len(prompt):,}-token prefill "
          f"on the flash branch, rel L2 to float32 dense {err_flash:.3e} "
          f"(bf16 dense {err_dense:.3e}) [{smi}]", flush=True)
    return {"err_flash": err_flash, "err_dense": err_dense}


def _xlstm_blocks_check(dev, served) -> dict:
    """xlstm-350m's first mLSTM and sLSTM blocks at full width in float32
    (the bf16 params cast up), on N(0, 1) inputs of XLSTM_BLOCK_T tokens:
    a prefill of all but the last token + one decode step (the step form)
    against the prefill of all (chunkwise; the sLSTM's loop), the last
    output's rel L2; and the block on the card against the same block on
    a CPU copy, every output's rel L2; each at most 2^-12.  For this check
    the sLSTM's recurrent weights r are scaled by 1/sqrt(hd): at the
    reference's init (its fan-in rule takes the 4 gates as the fan-in, a
    stddev of 0.5) the recurrence is chaotic at these widths, a 1e-7
    relative input difference grows to O(1) within ~100 steps, so two
    summation orders part over a long scan.  Scaled, the same difference
    stays near 5e-7 over 2,048 steps (``tools/slstm_sensitivity.py``),
    and a fault that builds up along the scan still shows."""
    from repro_torch.models import xlstm
    from repro_torch.models.transformer import tree_map

    period = served["params_tree"]["stacks"][0]
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg = served["model"].cfg
    d, t = cfg.d_model, XLSTM_BLOCK_T
    hd = d // cfg.num_heads
    out = {}
    for pi, kind in enumerate(("mlstm", "slstm")):
        p = tree_map(lambda v: v[0].float(), period[pi][kind])
        if kind == "slstm":
            p["r"] = {"kernel": p["r"]["kernel"] * hd ** -0.5}
        apply = getattr(xlstm, f"apply_{kind}_block")
        x = torch.randn((1, t, d), generator=gen, device=dev)
        y, _ = apply(p, x)
        _, st = apply(p, x[:, :-1])
        y1, _ = apply(p, x[:, -1:], st, decode=True)
        yc, _ = apply(tree_map(lambda v: v.cpu(), p), x.cpu())
        errs = {"step_vs_prefill": _rel_l2(y1[:, 0], y[:, -1]),
                "card_vs_cpu": _rel_l2(y.cpu(), yc)}
        if not max(errs.values()) <= XLSTM_CONSISTENCY_TOL:
            fail(f"other archs xlstm {kind} block: {errs} > 2^-12")
        out[kind] = errs
        tame = ", r scaled by 1/sqrt(hd)" if kind == "slstm" else ""
        print(f"other archs xlstm-350m {kind} block (layer 0, float32{tame},"
              f" T={t}): prefill of {t - 1} + a decode step vs the {t}-token"
              f" prefill rel L2 {errs['step_vs_prefill']:.3e}; card vs CPU "
              f"{errs['card_vs_cpu']:.3e}", flush=True)
    return out


def _other_train(dev, arch, mach, batch, seq, hold_all, steps, smi) -> dict:
    """``arch`` at full width and depth (xlstm-350m at XLSTM_LAYERS
    layers; bf16, remat) trained ``steps``
    AdamW steps through ``Trainer.step_fn`` on
    SyntheticLMStream batches of ``batch`` x ``seq`` tokens (enc-dec:
    ENC_TRAIN_FRAMES frames a row; vision: 256 patches a row): kernel 3
    forward and backward once a step, kernel 10 twice forward (remat) and
    once backward a flash attention a step; every loss and gradient norm
    finite (``hold_all``), else the first loss.  The step at which the
    gradient norm is first non-finite is recorded and printed: the steps
    after it run on non-finite parameters."""
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, SyntheticLMStream
    from repro_torch.models import LanguageModel
    from repro_torch.models import frontends
    from repro_torch.train import TrainConfig, Trainer

    cfg = _xlstm_cut(get_config(arch, mach=mach))
    model = LanguageModel(cfg)
    trainer = Trainer(model, TrainConfig(
        total_steps=OTHER_TRAIN_STEPS, warmup_steps=2, peak_lr=3e-4,
        log_every=OTHER_TRAIN_STEPS))
    prefix = cfg.num_prefix_tokens if cfg.frontend == "vision" else 0
    stream = SyntheticLMStream(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0,
        enc_feats_dim=(frontends.AUDIO_FEATURE_DIM if cfg.num_encoder_layers
                       else 0), enc_len=ENC_TRAIN_FRAMES,
        prefix_feats_dim=frontends.VISION_FEATURE_DIM if prefix else 0,
        prefix_len=prefix), device=dev)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in _leaves(state.params))
    kernels = _other_launchers()
    before = {n: fn.launches for n, fn in kernels.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, losses, norms = [], [], []
    for s in range(steps):
        b = stream.batch_at(s)
        t1 = time.perf_counter()
        state, met = trainer.step_fn(state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    launches = {n: fn.launches - before[n] for n, fn in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    kinds = model._dec_layout()
    t_dec = prefix + seq
    n_flash = sum(k in ("attn", "xattn") for k in kinds) \
        * _takes_flash(cfg, t_dec) \
        + kinds.count("xattn") * _takes_flash(cfg, t_dec) \
        + cfg.num_encoder_layers * _takes_flash(cfg, ENC_TRAIN_FRAMES)
    expected = {"mach_xent_fwd": 1, "mach_xent_bwd": 1,
                "flash_attention": 2 * n_flash, "flash_attention_bwd": n_flash}
    for name, per_step in expected.items():
        if launches[name] != per_step * steps:
            fail(f"other train {arch}: {name} launched {launches[name]} "
                 f"times, expected {per_step} a step")
    held = losses + norms if hold_all else losses[:1]
    if not all(math.isfinite(v) for v in held):
        fail(f"other train {arch}: losses {losses}, gradient norms {norms}")
    del state
    torch.cuda.empty_cache()
    ms = statistics.median(step_ms[1:])
    positions = batch * t_dec
    cut = (f"; sequence cut to {seq} (the sLSTM's eager scan: {seq} steps a "
           f"layer forward, twice under remat, and backward)"
           if arch == XLSTM_ARCH else "")
    bad = next((i + 1 for i, v in enumerate(norms)
                if not math.isfinite(v)), None)
    if not hold_all:
        cut += ("; only the first loss held: the random-init sLSTM's "
                "gradients through time overflow (ROADMAP.md §3)")
    if bad is not None:
        cut += (f"; the gradient norm is non-finite from step {bad}, so the "
                f"steps after it run on non-finite parameters and their ms "
                f"is the time of such steps")
    depth = ("every layer" if cfg.num_layers == get_config(arch).num_layers
             else f"{cfg.num_layers} layers")
    print(f"other train: {cfg.name} (mach={mach}, {depth} and every width, "
          f"{n_params:,} params, bf16, remat={cfg.remat}), {batch} x {seq} "
          f"text tokens{f' + {prefix} patches' if prefix else ''}"
          f"{f', {ENC_TRAIN_FRAMES} frames a row' if cfg.num_encoder_layers else ''}"
          f", AdamW: losses {losses}, gradient norms {norms}; launches "
          f"{launches} (a step: "
          f"{expected}); {ms:.3f} ms/step (host clock, median of steps 2.."
          f"{steps}; the first {step_ms[0]:.3f} ms), "
          f"{batch * seq / ms * 1e3:.1f} text tokens/s "
          f"({positions / ms * 1e3:.1f} positions/s), peak {peak_gib:.2f} GiB"
          f"{cut} [{smi}]", flush=True)
    return {"launches": launches, "losses": losses, "grad_norms": norms,
            "step_ms": ms, "step_ms_all": step_ms, "peak_gib": peak_gib,
            "params": n_params, "tokens_per_s": batch * seq / ms * 1e3,
            "batch": batch, "seq": seq, "prefix": prefix,
            "held": "all" if hold_all else "first loss",
            "non_finite_grad_from_step": bad}


def _uncounted(fn):
    """Run a check that calls the model off the path; the launch counters
    are put back as they were before it."""
    launchers = _other_launchers()
    before = {n: f.launches for n, f in launchers.items()}
    try:
        return fn()
    finally:
        for n, f in launchers.items():
            f.launches = before[n]


def _summary(served) -> dict:
    return {"params": served["params"], "direct_s": served.get("direct_s"),
            "runs": {name: {k: v for k, v in res.items()
                            if k not in ("h", "metrics")}
                     for name, res in served["runs"].items()}}


def phase_other_archs(dev) -> dict:
    """Kernels 1 and 2 vs plain at the three models' MACH heads (xlstm's
    with mach="on"), each timed at N=4 beside its bound; then,
    launch counters from 0, xlstm-350m (cut to XLSTM_LAYERS layers) with
    its OAA head through the
    contiguous and lockstep engines and with a MACH head (B=2048 R=8 over
    50,304) through the contiguous one, seamless and paligemma through the
    contiguous and paged engines, each MACH run also through the direct
    greedy loop (kernel 1), and the three trained 3 steps; counts read.
    Then the numeric checks at full width, off the count: xLSTM's blocks
    (step form, card against CPU) in float32, seamless's and paligemma's
    flash prefills against the float32 dense branch."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    smi = _nvidia_smi()
    out = {"head": {arch: _dense_head_vs_plain(dev, arch, top1=True)
                    for arch in (XLSTM_ARCH, ENCDEC_ARCH, VLM_ARCH)}}
    launchers = _other_launchers()
    # the path's run: counts from 0, read just after
    for fn in launchers.values():
        fn.launches = 0
    contiguous_lockstep = {"contiguous": {}, "lockstep": {"scheduler":
                                                          "lockstep"}}
    contiguous_paged = {"contiguous": {}, "paged": {"page_size": DENSE_PAGE}}
    xl_oaa = _other_engines(dev, _xlstm_cut(get_config(XLSTM_ARCH)),
                            DENSE_PROMPTS, contiguous_lockstep, smi,
                            direct=False)
    out["xlstm_oaa"] = _summary(xl_oaa)
    del xl_oaa
    xl = _other_engines(dev, _xlstm_cut(get_config(XLSTM_ARCH, mach="on")),
                        DENSE_PROMPTS, {"contiguous": {}}, smi)
    out["xlstm_mach"] = _summary(xl)
    out["xlstm_blocks"] = _uncounted(lambda: _xlstm_blocks_check(dev, xl))
    del xl
    torch.cuda.empty_cache()
    for arch, prompts in ((ENCDEC_ARCH, DENSE_PROMPTS),
                          (VLM_ARCH, VLM_PROMPTS)):
        served = _other_engines(dev, get_config(arch), prompts,
                                contiguous_paged, smi)
        out[arch] = _summary(served)
        out[arch]["flash_vs_dense"] = _uncounted(
            lambda: _flash_vs_dense_full_width(dev, served, smi))
        del served
        torch.cuda.empty_cache()
    out["train"] = {
        f"{arch} x {seq}": _other_train(dev, arch, mach, batch, seq,
                                        hold_all, steps, smi)
        for arch, mach, batch, seq, hold_all, steps in OTHER_TRAIN}
    launches = {n: fn.launches for n, fn in launchers.items()}
    if min(launches.values()) < 1:
        fail(f"other archs: a kernel of the path never ran: {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"other archs launches on the path: {launches} [{smi}]", flush=True)
    print(f"other archs: phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def _add_other_launches(rows, other, flash_new) -> None:
    """Rows 1, 2, 3 and 10 (forward and backward) gain their launches on
    phase 15's path; rows 1 and 2 their checks, times and bounds at the
    three models' MACH heads; row 10 its non-causal and S != T cases."""
    for row in rows:
        name = row["name"]
        if name in OTHER_KERNELS:
            row["launches_other_archs"] = other["launches"][name]
        if name in ("mach_decode", "mach_topk"):
            for arch, head in other["head"].items():
                tag = arch.split("-")[0]
                if name == "mach_decode":
                    head = head["top1"]
                row.update({f"{k}_{tag}_head": head[k] for k in (
                    "max_abs_err", "ms", "ms_graph", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "shape")})
        if name == "flash_attention":
            row["encdec_vision_modes"] = flash_new


# ---------------------------------------------------------------------------
# phase 16: checkpoints and restarts
# ---------------------------------------------------------------------------

CKPT_ODP_STEPS = 7           # ODP: a non-blocking save after step 4 (steps
CKPT_ODP_EVERY = 4           # 5 and 6 run with the write in flight), the
CKPT_ODP_FAIL = 6            # failure at step 7, a blocking save at 7
CKPT_LM_ARCH = "tinyllama-1.1b"
CKPT_LM_STEPS = 8            # launch/train.py's checkpoint_every: max(5, 2)
CKPT_LM_FAIL = 7
CKPT_LM_SEQ, CKPT_LM_BATCH = 2048, 2
CKPT_EXAMPLE_STEPS = (20, 40)  # examples/train_lm.py's two runs
CKPT_LAUNCH_STEPS = 3          # launch/train.main, its smoke config


def _ckpt_launchers() -> dict:
    """Row name -> the launch counters of the kernels on phase 16's paths."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import mach_topk as mt
    from repro_torch.kernels import mach_xent as mx
    return {"mach_topk": (mt.mach_topk_cuda,),
            "mach_xent_fwd": (mx.mach_xent_cuda_fwd,),
            "mach_xent_bwd": (mx.mach_xent_cuda_bwd,),
            "mach_fused_xent_ell": (mfx.ell_fwd_cuda, mfx.ell_bwd_cuda),
            "mach_fused_xent_gather": (mfx.gather_fwd_cuda,
                                       mfx.gather_bwd_cuda),
            "lru_scan": (ls.lru_scan_cuda,),
            "flash_attention": (fa.flash_attention_cuda,),
            "flash_attention_bwd": (fa.flash_attention_bwd_cuda,)}


def _ckpt_counts() -> dict:
    return {name: sum(fn.launches for fn in fns)
            for name, fns in _ckpt_launchers().items()}


class _TimedManager:
    """A ``CheckpointManager`` that times each save (a non-blocking one:
    how long it holds the step, the host snapshot) and each restore, and
    copies the state it saves at ``hold_step`` into ``held`` (a state of
    the same shapes, allocated beforehand, so that no allocation on the
    card lands in the steps timed beside the write)."""

    def __init__(self, manager, hold_step, held):
        self.manager = manager
        self.hold_step = hold_step
        self.held = held
        self.saves, self.restores = [], []

    def save(self, step, state, blocking=True):
        if step == self.hold_step:
            self.held = _copy_state(self.held, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.manager.save(step, state, blocking)
        self.saves.append({"step": step, "blocking": blocking,
                           "s": time.perf_counter() - t0})

    def restore(self, template, step=None, device=None):
        t0 = time.perf_counter()
        out = self.manager.restore(template, step, device)
        torch.cuda.synchronize()
        self.restores.append({"step": out[1], "s": time.perf_counter() - t0})
        return out

    def __getattr__(self, name):
        return getattr(self.manager, name)


class _InFlightTimes:
    """``Trainer.fit``'s monitor: each step's synchronized ms and whether
    a checkpoint write was still in flight when the step ended."""

    def __init__(self, manager=None):
        self.manager = manager
        self.steps = []

    def record(self, step, seconds):
        self.steps.append((step, seconds * 1e3, self.manager is not None
                           and self.manager.in_flight()))
        return False


class _FailOnce:
    """A stream that fails once, at ``step``, after ``manager``'s latest
    save is durable (a node lost after the first checkpoint)."""

    def __init__(self, inner, step, manager):
        self.inner, self.step, self.manager = inner, step, manager
        self.failed = False

    def batch_at(self, s):
        if s == self.step and not self.failed:
            self.failed = True
            self.manager.wait()
            raise RuntimeError(f"injected node failure at step {s + 1}")
        return self.inner.batch_at(s)


def _copy_state(dst, src):
    """``src``'s values in ``dst``'s tensors (same structure and shapes);
    int leaves from ``src``."""
    from repro_torch.checkpoint import tree_flatten, tree_unflatten
    return tree_unflatten(dst, [
        d.copy_(x) if isinstance(x, torch.Tensor) else x
        for (_, d), (_, x) in zip(tree_flatten(dst), tree_flatten(src))])


def _state_bytes(state) -> int:
    from repro_torch.checkpoint import tree_flatten
    return sum(x.numel() * x.element_size() for _, x in tree_flatten(state)
               if isinstance(x, torch.Tensor))


def _leaf_diffs(a, b) -> list:
    """[(path, largest |a - b|, summed |a - b|)] over the leaves whose bits
    differ (nan for an int leaf)."""
    from repro_torch.checkpoint import tree_flatten
    out = []
    for (path, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)):
        if not isinstance(x, torch.Tensor):
            if x != y:
                out.append((path, float("nan"), float("nan")))
        elif x.is_floating_point():
            bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
            if not torch.equal(x.view(bits), y.view(bits)):
                d = (x.float() - y.float()).abs_()
                out.append((path, float(d.max()),
                            float(d.sum(dtype=torch.float64))))
        elif not torch.equal(x, y):
            out.append((path, float("nan"), float("nan")))
    return out


def _compare_states(a, b) -> tuple[bool, float, float]:
    """(every leaf the same bits, the largest |a - b| and the mean |a - b|
    over the float leaves' entries)."""
    from repro_torch.checkpoint import tree_flatten
    diffs = _leaf_diffs(a, b)
    n = sum(x.numel() for _, x in tree_flatten(a)
            if isinstance(x, torch.Tensor) and x.is_floating_point())
    return (not diffs,
            max((d for _, d, _ in diffs if d == d), default=0.0),
            sum(s for _, _, s in diffs if s == s) / max(n, 1))


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _restart_runs(label, trainer, init_state, stream, steps, every, fail_at,
                  directory, smi) -> dict:
    """Two uninterrupted runs of ``steps`` steps through ``Trainer.fit``
    (and a third where the two differ), then one through
    ``run_with_restarts`` (``CheckpointManager(keep=2)``,
    a non-blocking save every ``every`` steps, a blocking one at the end)
    that fails once at step ``fail_at + 1``, after the first save is
    durable.  The resumed state must equal the saved one bit for bit.
    Returns the three runs' comparisons and the checkpoint's numbers."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import run_with_restarts
    mon0 = _InFlightTimes()
    first = trainer.fit(init_state(), stream, steps, monitor=mon0, log=None)
    second = trainer.fit(init_state(), stream, steps, log=None)
    two_same, two_diff, two_mean = _compare_states(first, second)
    runs = 2
    if not two_same:        # a third run: the largest spread of three pairs
        third = trainer.fit(init_state(), stream, steps, log=None)
        for a in (first, second):
            _, d, m = _compare_states(a, third)
            two_diff, two_mean = max(two_diff, d), max(two_mean, m)
        runs = 3
        del third
    del second
    mgr = _TimedManager(CheckpointManager(directory, keep=2), every,
                        init_state())
    mon = _InFlightTimes(mgr)
    failing = _FailOnce(stream, fail_at, mgr)
    resumed = {}

    def train_once(state, remaining):
        if state.step:                  # the restored state == the saved one
            resumed["step"] = state.step
            resumed["same"], resumed["diff"], _ = _compare_states(state,
                                                                  mgr.held)
            mgr.held = None
        return trainer.fit(state, failing, remaining, manager=mgr,
                           monitor=mon, log=None)

    t0 = time.perf_counter()
    final = run_with_restarts(
        train_once, init_state, mgr, steps,
        log=lambda m: print(f"checkpoint {label}: {m}", flush=True))
    wall = time.perf_counter() - t0
    if not failing.failed or resumed.get("step") != every:
        fail(f"checkpoint {label}: the run did not fail and resume at step "
             f"{every} ({resumed})")
    if not resumed["same"]:
        fail(f"checkpoint {label}: the restored state differs from the saved "
             f"one (largest difference {resumed['diff']})")
    restart_same, restart_diff, restart_mean = _compare_states(final, first)
    nbytes = _state_bytes(final)
    disk = _dir_bytes(os.path.join(directory, f"step_{steps:012d}"))
    shutil.rmtree(directory)
    del final, first
    torch.cuda.empty_cache()
    blocking = [s["s"] for s in mgr.saves if s["blocking"]]
    held = [s["s"] for s in mgr.saves if not s["blocking"]]
    in_flight = {step: ms for step, ms, flying in mon.steps if flying}
    without = [ms for step, ms, _ in mon0.steps if step in in_flight]
    out = {"state_bytes": nbytes, "disk_bytes": disk,
           "blocking_save_s": blocking[-1],
           "blocking_save_gb_s": nbytes / blocking[-1] / 1e9,
           "snapshot_s": held[0], "restore_s": mgr.restores[0]["s"],
           "restore_gb_s": nbytes / mgr.restores[0]["s"] / 1e9,
           "in_flight_steps": sorted(in_flight),
           "step_ms_write_in_flight": (statistics.median(in_flight.values())
                                       if in_flight else None),
           "step_ms_without": statistics.median(without) if without else None,
           "step_ms_uninterrupted": statistics.median(
               ms for _, ms, _ in mon0.steps[1:]),
           "uninterrupted_runs": runs, "two_runs_same_bits": two_same,
           "runs_max_diff": two_diff, "runs_mean_diff": two_mean,
           "restart_same_bits": restart_same,
           "restart_max_diff": restart_diff,
           "restart_mean_diff": restart_mean, "restart_wall_s": wall}
    print(f"checkpoint {label}: state {nbytes / 1e9:.3f} GB, on disk "
          f"{disk / 1e9:.3f} GB; blocking save {out['blocking_save_s']:.3f} s "
          f"({out['blocking_save_gb_s']:.3f} GB/s); a non-blocking save holds "
          f"the step {out['snapshot_s']:.3f} s (the host snapshot); restore "
          f"{out['restore_s']:.3f} s ({out['restore_gb_s']:.3f} GB/s); ms a "
          f"step with the write in flight {out['step_ms_write_in_flight']} "
          f"(steps {out['in_flight_steps']}), without {out['step_ms_without']}"
          f" (the same steps of an uninterrupted run); two uninterrupted runs "
          f"the same bits: {two_same} (over {runs} runs' pairs, largest "
          f"difference {two_diff:.3e}, mean {two_mean:.3e}); the restarted "
          f"run the same bits as the "
          f"first: {restart_same} (largest difference {restart_diff:.3e}, "
          f"mean {restart_mean:.3e}); restarted run "
          f"{wall:.1f} s [{smi}]", flush=True)
    return out


def _odp_restart(dev, nnz, directory, smi) -> dict:
    import dataclasses
    from repro_torch.configs.odp_mach import ODP
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import SparseExtremeDataset
    from repro_torch.train import TrainConfig, Trainer, new_train_state
    head = MACHLinear(ODP.mach(), ODP.dim, fused=True)
    data = SparseExtremeDataset(dataclasses.replace(
        ODP.sparse_data(small=False), nnz=nnz), device=dev)
    trainer = Trainer(_HeadTask(head, None), TrainConfig(
        schedule="constant", peak_lr=0.05, checkpoint_every=CKPT_ODP_EVERY,
        log_every=10 ** 9))

    def init_state():
        return new_train_state(head.init(
            torch.Generator(device=dev).manual_seed(0), device=dev),
            trainer.opt)

    return _restart_runs(
        f"ODP nnz={nnz}", trainer, init_state,
        _Stream(lambda s: data.batch_at(s, N_TRAIN)), CKPT_ODP_STEPS,
        CKPT_ODP_EVERY, CKPT_ODP_FAIL, directory, smi)


def _lm_restart(dev, directory, smi) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LanguageModel
    from repro_torch.train import Trainer
    cfg = get_config(CKPT_LM_ARCH)
    tcfg = launch_train.train_config(CKPT_LM_STEPS, 3e-4)
    trainer = Trainer(LanguageModel(cfg), tcfg)
    stream = launch_train.data_stream(cfg, CKPT_LM_SEQ, CKPT_LM_BATCH, 0, dev)

    def init_state():
        return trainer.init_state(torch.Generator(device=dev).manual_seed(0),
                                  dev)

    return _restart_runs(
        f"{CKPT_LM_ARCH} {CKPT_LM_BATCH} x {CKPT_LM_SEQ}", trainer,
        init_state, stream, CKPT_LM_STEPS, tcfg.checkpoint_every,
        CKPT_LM_FAIL, directory, smi)


def _entry_point(main, argv) -> str:
    """Run an entry point's ``main(argv)``; its standard output, printed
    here too.  Fails on a non-zero return."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.strip().splitlines():
        print(f"  | {line}", flush=True)
    print(f"  ({main.__module__}.main {' '.join(argv)}: "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if rc != 0:
        fail(f"{main.__module__}.main {argv} returned {rc}")
    return out


def phase_checkpoint(dev) -> dict:
    """Checkpoints and restarts at full width, launch counters from 0:
    ODP (kernel 6 at nnz=1,024, then kernel 5 at nnz=120) and
    tinyllama-1.1b (kernel 10 forward and backward) each trained twice
    uninterrupted and once through ``run_with_restarts`` with a failure
    after the first durable checkpoint; then ``launch/train.main`` with
    ``--ckpt-dir``, ``examples/train_lm.py`` twice on one directory (the
    second run resumes; kernel 3) and ``examples/serve_lm.py`` (kernels 2
    and 9); counts read.  Every directory it makes is removed."""
    import shutil
    import tempfile
    from repro_torch.examples import serve_lm, train_lm
    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    smi = _nvidia_smi()
    for fns in _ckpt_launchers().values():
        for fn in fns:
            fn.launches = 0
    out, parts = {}, {}
    before = _ckpt_counts()

    def counted(part):
        nonlocal before
        now = _ckpt_counts()
        parts[part] = {k: now[k] - before[k] for k in now}
        before = now

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        print(f"checkpoint: directory {root}, "
              f"{shutil.disk_usage(root).free / 1e9:.1f} GB free", flush=True)
        for nnz, sub in ((1024, "a"), (120, "b")):
            key = f"odp_nnz{nnz}"
            out[key] = _odp_restart(dev, nnz, os.path.join(root, sub), smi)
            counted(key)
            a = out[key]
            if not (a["two_runs_same_bits"] and a["restart_same_bits"]):
                fail(f"checkpoint ODP nnz={nnz}: the runs' final states "
                     f"differ (uninterrupted runs {a['runs_max_diff']}, "
                     f"restart {a['restart_max_diff']}): a nondeterministic "
                     f"op on a path the JAX test calls bit-exact")
        need = 3.2 * _lm_state_bytes()
        free = shutil.disk_usage(root).free
        if free < need:
            fail(f"checkpoint: {free / 1e9:.1f} GB free under {root}, "
                 f"{CKPT_LM_ARCH} needs {need / 1e9:.1f} (keep 2 + a .tmp)")
        out["lm"] = _lm_restart(dev, os.path.join(root, "c"), smi)
        counted("lm")
        c = out["lm"]
        if c["two_runs_same_bits"] and not c["restart_same_bits"]:
            fail(f"checkpoint {CKPT_LM_ARCH}: two uninterrupted runs agree "
                 f"bit for bit, the restarted one differs by "
                 f"{c['restart_max_diff']}")
        _hold_restart(CKPT_LM_ARCH, c)
        torch.cuda.empty_cache()
        launch_out = _entry_point(launch_train.main, [
            "--device", "cuda", "--arch", CKPT_LM_ARCH, "--steps",
            str(CKPT_LAUNCH_STEPS), "--ckpt-dir", os.path.join(root, "d")])
        if f"finished at step {CKPT_LAUNCH_STEPS} on cuda" not in launch_out:
            fail("checkpoint: launch/train.main did not finish its steps")
        counted("launch_train")
        ex_dir = os.path.join(root, "e")
        for i, steps in enumerate(CKPT_EXAMPLE_STEPS):
            ex_out = _entry_point(train_lm.main, [
                "--device", "cuda", "--steps", str(steps), "--ckpt-dir",
                ex_dir])
            resumed = f"resumed from checkpoint at step {CKPT_EXAMPLE_STEPS[0]}"
            if (resumed in ex_out) != (i == 1) or \
                    f"done at step {steps}" not in ex_out:
                fail(f"checkpoint: examples/train_lm.py run {i + 1} did not "
                     f"{'resume' if i else 'start afresh'}")
        counted("train_lm")
        serve_out = _entry_point(serve_lm.main, ["--device", "cuda"])
        if "5 requests" not in serve_out:
            fail("checkpoint: examples/serve_lm.py served no requests")
        counted("serve_lm")
    launches = _ckpt_counts()
    need_parts = {"mach_fused_xent_gather": "odp_nnz1024",
                  "mach_fused_xent_ell": "odp_nnz120",
                  "flash_attention": "lm", "flash_attention_bwd": "lm",
                  "mach_xent_fwd": "train_lm", "mach_xent_bwd": "train_lm",
                  "mach_topk": "serve_lm", "lru_scan": "serve_lm"}
    for name, part in need_parts.items():
        if parts[part][name] < 1:
            fail(f"checkpoint: {name} never launched in {part} ({parts})")
    out.update(launches=launches, parts=parts,
               seconds=time.perf_counter() - t0)
    print(f"checkpoint launches on the paths: {launches}; by part {parts} "
          f"[{smi}]", flush=True)
    print(f"checkpoint: phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def _hold_restart(label, res) -> None:
    """Where runs differ from run to run: the restarted run's mean
    |difference| from the first uninterrupted run at most twice the
    largest of the three uninterrupted runs' pairs.  The mean, not the
    largest difference: over 5 ODP nnz=120 runs of 7 steps, while kernel 5
    summed dW by float atomics, the pairs' largest differences spread 4.5x
    and their means 1.9x (tools/train_determinism.py --runs), so a 2x rule
    on the largest fails on runs without a fault."""
    if res["restart_mean_diff"] > 2 * res["runs_mean_diff"]:
        fail(f"checkpoint {label}: the restarted run is "
             f"{res['restart_mean_diff']} from an uninterrupted one (mean "
             f"|difference|), over twice the uninterrupted runs' "
             f"{res['runs_mean_diff']}")


def _lm_state_bytes() -> int:
    """Bytes of the checkpointed LM state: params, and float32 moments."""
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.optim.optimizers import tree_leaves
    meta = LanguageModel(get_config(CKPT_LM_ARCH)).init(device="meta")
    return sum(p.numel() * (p.element_size() + 8) for p in tree_leaves(meta))


def _add_checkpoint_launches(rows, ckpt) -> None:
    """Rows 2, 3, 5, 6, 9 and 10 gain their launches on phase 16's paths."""
    for row in rows:
        if row["name"] in ckpt["launches"]:
            row["launches_checkpoint"] = ckpt["launches"][row["name"]]


# ---------------------------------------------------------------------------
# phase 17: multi-device — the sharded trainer on an NCCL world of one
# ---------------------------------------------------------------------------

MD_ARCH = "tinyllama-1.1b"
MD_SEQ, MD_BATCH, MD_STEPS = 4096, 2, 4
MD_LAUNCH_STEPS = 3
# kernel 10 held to plain and timed at the path's shape: tinyllama's
# 32 / 4 heads of 64, causal, 2 x 4,096, forward and backward
MD_FLASH = [("tinyllama train", MD_BATCH, MD_SEQ, MD_SEQ, 32, 4, 64, True,
             True, torch.bfloat16)]
MD_KERNELS = ("mach_xent_fwd", "mach_xent_bwd", "flash_attention",
              "flash_attention_bwd", "dense_fwd", "dense_bwd")
# the fused sharded run: kernel 4 over the in-loss bucket selection (c_sel
# of B = 2,048 buckets, every step), MD_FUSED_STEPS steps each way
MD_SELECT = (512, 1)
MD_FUSED_STEPS = 3
# the head split by repetition as each rank launches kernels 3 and 4:
# tinyllama-1.1b's head at the path's rows (N, d, R, B), bf16, split n ways
MD_HEAD = (MD_BATCH * MD_SEQ, 2048, 8, 2048)
MD_SPLITS = (2, 4, 8)
# the decoder split by heads and hidden as each rank launches kernel 10:
# tinyllama-1.1b's training attention (B, T, H, KV, hd), bf16, causal
MD_FLASH_SHAPE = (MD_BATCH, MD_SEQ, 32, 4, 64)
# one tinyllama-1.1b decoder layer timed at a rank's shapes, n ways
MD_LAYER_SPLITS = (1, 2, 4, 8)
# the MoE experts split at world 1: phase 14's qwen2-moe-a2.7b cut
# (MOE_CUT layers, bf16, remat) trained MOE_TRAIN_STEPS AdamW steps on
# MD_BATCH x MD_SEQ tokens, unsharded and sharded; and one qwen2-moe MoE
# block at each rank's shapes, n -> how the rules split its 60 experts
# on n ``model`` ranks (n divides E: by expert; else by d_ff columns)
MD_MOE_SPLITS = {2: "experts", 4: "experts", 8: "columns"}
# the n ranks' float32 partial outputs summed, against the whole block:
# rtol, and atol of the largest entry
MD_MOE_F32_RTOL = 1e-5
# the RG-LRU split by channels: kernel 9 as each rank launches it at
# recurrentgemma-2b's training shape (B, T, W), float32 as ``_rglru``
# feeds it; one RG-LRU block at a rank's shapes (MD_LAYER_SPLITS); its
# one-period cut (rglru, rglru, attn_local) at full width with the MACH
# head, MD_RG_STEPS AdamW steps unsharded and sharded at world 1
MD_RG_ARCH = "recurrentgemma-2b"
MD_SCAN_SHAPE = (MD_BATCH, MD_SEQ, 2560)
MD_RG_STEPS = 3
MD_RG_KERNELS = ("lru_scan", "lru_scan_bwd", "mach_xent_fwd",
                 "mach_xent_bwd", "flash_attention", "flash_attention_bwd")
# the enc-dec's cross-attention split by heads: kernel 10 at
# seamless-m4t-large-v2's training cross shape (B, T queries, S keys, H,
# KV, hd), bf16, non-causal, on a rank's H/n heads and KV/n kv heads
MD_XATTN_SHAPE = (MD_BATCH, MD_SEQ, 1024, 16, 16, 64)


def _md_launchers() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import mach_xent as mx
    return {"mach_xent_fwd": mx.mach_xent_cuda_fwd,
            "mach_xent_bwd": mx.mach_xent_cuda_bwd,
            "flash_attention": fa.flash_attention_cuda,
            "flash_attention_bwd": fa.flash_attention_bwd_cuda,
            "dense_fwd": mfx.dense_fwd_cuda, "dense_bwd": mfx.dense_bwd_cuda,
            "lru_scan": ls.lru_scan_cuda,
            "lru_scan_bwd": ls.lru_scan_bwd_cuda}


def _md_bf16_rule(got, want) -> tuple[float, float]:
    """Phase 5's bf16 rule: (largest error over the largest entry,
    relative L2 error), held to BF16_GRAD_MAX and BF16_GRAD_L2."""
    err = got.float() - want.float()
    return (float(err.abs().max() / want.float().abs().max()),
            float(err.norm() / want.float().norm()))


def _md_per_range(dev, smi) -> dict:
    """Kernels 3 and 4 as each rank of tinyllama-1.1b's head split n ways
    by repetition launches them (MD_HEAD, bf16; n in MD_SPLITS), on each
    of the n repetition ranges in turn, against the whole-R kernels on
    the same inputs: the per-token losses summed over the ranges at
    float32 rtol 1e-6; kernel 3's dlogits the whole kernel's columns bit
    for bit (one warp a head); kernel 4's lse the whole kernel's columns
    bit for bit, its dW columns and the dh summed over the ranges (in
    float32) by phase 5's bf16 rule (kernel 4 sums dW and dh across
    blocks by float atomics, in an order that changes from run to run).
    Each range's forward and backward ms (CUDA events) beside the whole
    kernel's and its own bound.  Not counted on the path."""
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import mach_xent as mx
    n_rows, d, r, b = MD_HEAD
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(29)
    logits = (torch.randn((n_rows, r, b), generator=gen, device=dev)
              * 3).to(bf16)
    h = torch.randn((n_rows, d), generator=gen, device=dev).to(bf16)
    w = (torch.randn((d, r * b), generator=gen, device=dev)
         / d ** 0.5).to(bf16)
    y = torch.randint(0, b, (n_rows, r), generator=gen, device=dev,
                      dtype=torch.int32)
    g = torch.rand((n_rows,), generator=gen, device=dev) + 0.5
    loss3 = mx.mach_xent_cuda_fwd(logits, y)
    dlogits = mx.mach_xent_cuda_bwd(logits, y, g)
    loss4, lse = mfx.dense_fwd_cuda(h, w, None, y, b)
    dh, dw, _ = mfx.dense_bwd_cuda(h, w, None, y, lse, g, b)

    def times(lg, yy, ww):
        _, ls = mfx.dense_fwd_cuda(h, ww, None, yy, b)
        return {"xent_fwd": kernel_ms(lambda: mx.mach_xent_cuda_fwd(lg, yy)),
                "xent_bwd": kernel_ms(
                    lambda: mx.mach_xent_cuda_bwd(lg, yy, g)),
                "dense_fwd": kernel_ms(
                    lambda: mfx.dense_fwd_cuda(h, ww, None, yy, b)),
                "dense_bwd": kernel_ms(
                    lambda: mfx.dense_bwd_cuda(h, ww, None, yy, ls, g, b))}

    def bounds(reps):
        bf16 = torch.bfloat16
        dense = [bound_of(mfx.work("dense", n_rows, d, reps, b, bf16,
                                   backward=bwd, need_dh=True, bias=False),
                          BF16_TOPS_PER_S)[0] for bwd in (False, True)]
        return {"xent_fwd": bound_of(mx.work(n_rows, reps, b, bf16),
                                     F32_OPS_PER_S)[0],
                "xent_bwd": bound_of(mx.work(n_rows, reps, b, bf16, True),
                                     F32_OPS_PER_S)[0],
                "dense_fwd": dense[0], "dense_bwd": dense[1]}

    out = {"whole": {"ms": times(logits, y, w), "bound_ms": bounds(r)},
           "shape": f"N={n_rows} d={d} R={r} B={b} bfloat16"}
    for n in MD_SPLITS:
        per = r // n
        sum3, sum4 = torch.zeros_like(loss3), torch.zeros_like(loss4)
        dh_sum = torch.zeros((n_rows, d), dtype=torch.float32, device=dev)
        ranges, dw_rule = [], (0.0, 0.0)
        for k in range(n):
            r0, r1 = k * per, (k + 1) * per
            pl, py = logits[:, r0:r1].contiguous(), y[:, r0:r1].contiguous()
            pw = w[:, r0 * b:r1 * b].contiguous()
            sum3 += mx.mach_xent_cuda_fwd(pl, py)
            if not torch.equal(mx.mach_xent_cuda_bwd(pl, py, g),
                               dlogits[:, r0:r1]):
                fail(f"multidevice: kernel 3's dlogits on repetitions "
                     f"[{r0}, {r1}) of {n} ranges differ from the whole "
                     f"kernel's columns")
            part_loss, part_lse = mfx.dense_fwd_cuda(h, pw, None, py, b)
            sum4 += part_loss
            if not torch.equal(part_lse, lse[:, r0:r1]):
                fail(f"multidevice: kernel 4's lse on repetitions "
                     f"[{r0}, {r1}) differs from the whole kernel's")
            part_dh, part_dw, _ = mfx.dense_bwd_cuda(h, pw, None, py,
                                                     part_lse, g, b)
            rule = _md_bf16_rule(part_dw, dw[:, r0 * b:r1 * b])
            dw_rule = tuple(max(a, c) for a, c in zip(dw_rule, rule))
            dh_sum += part_dh.float()
            ranges.append({"reps": [r0, r1], "ms": times(pl, py, pw)})
        dh_rule = _md_bf16_rule(dh_sum.to(bf16), dh)
        loss_rel = [float(((a - c).abs() / c.abs()).max())
                    for a, c in ((sum3, loss3), (sum4, loss4))]
        mean = {k: statistics.mean(x["ms"][k] for x in ranges)
                for k in out["whole"]["ms"]}
        res = {"ranges": ranges, "mean_ms": mean, "bound_ms": bounds(per),
               "loss_rel_err": {"xent": loss_rel[0], "dense": loss_rel[1]},
               "dw_rule": dw_rule, "dh_rule": dh_rule}
        out[f"n={n}"] = res
        share = {k: mean[k] / out["whole"]["ms"][k] for k in mean}
        print(f"multidevice: head split {n} ways ({per} of {r} repetitions a "
              f"rank, {out['shape']}): per range ms (mean of {n}) "
              + ", ".join(f"{k} {mean[k]:.4f} ({share[k]:.3f} of the whole "
                          f"{out['whole']['ms'][k]:.4f}; bound "
                          f"{res['bound_ms'][k]:.4f})" for k in mean)
              + f"; summed losses rel err kernel 3 {loss_rel[0]:.2e}, kernel "
              f"4 {loss_rel[1]:.2e}; dlogits and lse bit for bit; dW "
              f"{dw_rule[0]:.2e} / {dw_rule[1]:.2e}, summed dh "
              f"{dh_rule[0]:.2e} / {dh_rule[1]:.2e} (largest / rel L2) "
              f"[{smi}]", flush=True)
        if max(loss_rel) > 1e-6:
            fail(f"multidevice: losses summed over {n} repetition ranges "
                 f"off the whole kernels' by {loss_rel}")
        if max(dw_rule[0], dh_rule[0]) > BF16_GRAD_MAX or \
                max(dw_rule[1], dh_rule[1]) > BF16_GRAD_L2:
            fail(f"multidevice: kernel 4 over {n} ranges outside the bf16 "
                 f"rule: dW {dw_rule}, dh {dh_rule}")
    del logits, dlogits, h, w, dh, dw
    torch.cuda.empty_cache()
    return out


def _md_flash_per_rank(dev, smi) -> dict:
    """Kernel 10 as each rank of tinyllama-1.1b's decoder split n ways
    launches it (MD_FLASH_SHAPE, n in MD_SPLITS): on each rank's query
    heads [k·H/n, (k+1)·H/n) and the kv heads they read
    (``sharding.kv_heads``) in turn, forward and backward, against the
    whole kernel on the same inputs.  Held: the output and dq by phase
    7's rule (2 bf16 ulps of each row's scale), dk and dv summed over the
    ranks that share a kv head (in float32) by phase 9's; reported: which
    of out, lse, dq and (where a rank owns whole groups) dk and dv are
    the whole kernel's heads bit for bit.  Each rank's forward and
    backward ms (CUDA events) beside the whole kernel's and its own
    bound.  Not counted on the path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.sharding import kv_heads
    b, t, h, kv, hd = MD_FLASH_SHAPE
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(30)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(bf16)
                   for shape in ((b, t, h, hd), (b, t, kv, hd),
                                 (b, t, kv, hd), (b, t, h, hd)))
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse)

    def times(qq, kk, vv, oo, dd, ll):
        return {"fwd": kernel_ms(lambda: fa.flash_attention_cuda(
                    qq, kk, vv, return_lse=True), iters=10),
                "bwd": kernel_ms(lambda: fa.flash_attention_bwd_cuda(
                    qq, kk, vv, oo, dd, ll), iters=5)}

    def bounds(heads, kv_local):
        return {"fwd": _flash_bound(b, t, t, heads, kv_local, hd, True, None,
                                    False, bf16)[0],
                "bwd": _flash_bound(b, t, t, heads, kv_local, hd, True, None,
                                    True, bf16)[0]}

    res = {"whole": {"ms": times(q, k, v, out, do, lse),
                     "bound_ms": bounds(h, kv)},
           "shape": f"q ({b}, {t}, {h}, {hd}), k/v ({b}, {t}, {kv}, {hd}) "
                    f"bfloat16, causal"}
    for n in MD_SPLITS:
        per = h // n
        dk_sum = torch.zeros(dk.shape, dtype=torch.float32, device=dev)
        dv_sum = torch.zeros_like(dk_sum)
        ranks, ulps = [], {"out": 0.0, "dq": 0.0}
        same = {"out": True, "lse": True, "dq": True, "dk": True, "dv": True}
        for rank in range(n):
            q0, q1 = rank * per, (rank + 1) * per
            k0, k1 = kv_heads(q0, q1, h, kv)
            rq, rdo = q[:, :, q0:q1].contiguous(), do[:, :, q0:q1].contiguous()
            rk, rv = k[:, :, k0:k1].contiguous(), v[:, :, k0:k1].contiguous()
            r_out, r_lse = fa.flash_attention_cuda(rq, rk, rv,
                                                   return_lse=True)
            r_dq, r_dk, r_dv = fa.flash_attention_bwd_cuda(rq, rk, rv, r_out,
                                                           rdo, r_lse)
            torch.cuda.synchronize()
            ulps["out"] = max(ulps["out"], _bf16_row_ulps(
                r_out, out[:, :, q0:q1]))
            ulps["dq"] = max(ulps["dq"], _bf16_backward_ulps(
                r_dq, dq[:, :, q0:q1]))
            same["out"] &= torch.equal(r_out, out[:, :, q0:q1])
            same["lse"] &= torch.equal(r_lse, lse[:, q0:q1])
            same["dq"] &= torch.equal(r_dq, dq[:, :, q0:q1])
            if per >= h // kv:                     # whole groups of G
                same["dk"] &= torch.equal(r_dk, dk[:, :, k0:k1])
                same["dv"] &= torch.equal(r_dv, dv[:, :, k0:k1])
            else:
                same["dk"] = same["dv"] = None     # summed over ranks
            dk_sum[:, :, k0:k1] += r_dk.float()
            dv_sum[:, :, k0:k1] += r_dv.float()
            ranks.append({"heads": [q0, q1], "kv_heads": [k0, k1],
                          "ms": times(rq, rk, rv, r_out, rdo, r_lse)})
        ulps["dk"] = _bf16_backward_ulps(dk_sum.to(bf16), dk)
        ulps["dv"] = _bf16_backward_ulps(dv_sum.to(bf16), dv)
        mean = {key: statistics.mean(r["ms"][key] for r in ranks)
                for key in ("fwd", "bwd")}
        kv_local = ranks[0]["kv_heads"][1] - ranks[0]["kv_heads"][0]
        out_n = {"ranks": ranks, "mean_ms": mean,
                 "bound_ms": bounds(per, kv_local), "bf16_ulps": ulps,
                 "bit_for_bit": same}
        res[f"n={n}"] = out_n
        share = {key: mean[key] / res["whole"]["ms"][key] for key in mean}
        print(f"multidevice: kernel 10 on a rank's heads, {n} ways ({per} "
              f"of {h} query heads, {kv_local} kv head(s) a rank, "
              f"{res['shape']}): ms a rank (mean of {n}) "
              + ", ".join(f"{key} {mean[key]:.4f} ({share[key]:.3f} of the "
                          f"whole {res['whole']['ms'][key]:.4f}; bound "
                          f"{out_n['bound_ms'][key]:.4f})" for key in mean)
              + f"; bf16 ulps from the whole {ulps}; bit for bit {same} "
              f"[{smi}]", flush=True)
        if max(ulps.values()) > 2.0:
            fail(f"multidevice: kernel 10 on {n} ranks' heads off the whole "
                 f"kernel by {ulps} bf16 ulps")
    del q, k, v, do, out, lse, dq, dk, dv
    torch.cuda.empty_cache()
    return res


def _md_rank_block(params, cfg, n, rank, mesh):
    """One decoder block as rank ``rank`` of n holds and splits it on the
    ``model`` dim of ``mesh``: (its params, its ``BlockSplit``).  The
    params: its query heads of q and o and its columns of wi, wg and wo
    (the shards a split block's gather keeps), k and v whole; the split:
    those heads and columns, and the kv heads [k0, k1) that
    ``apply_block`` cuts from k and v (``sharding.kv_heads``).  On a
    world-1 mesh its ``into`` and ``out_of`` are the identity."""
    from repro_torch.sharding import BlockSplit, RangeSplit, kv_heads
    h, kv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    q0, q1 = rank * h // n, (rank + 1) * h // n
    c0, c1 = rank * f // n, (rank + 1) * f // n
    names = mesh.mesh_dim_names
    dims, batch = (names.index("model"),), (names.index("data"),)
    split = BlockSplit(RangeSplit(mesh, q0, q1, dims, batch),
                       kv_heads(q0, q1, h, kv),
                       RangeSplit(mesh, c0, c1, dims, batch))
    a, m = params["attn"], params["mlp"]
    cut = lambda x, *idx: {"kernel": x["kernel"][idx].contiguous()}  # noqa: E731
    local = {"norm1": params["norm1"], "norm2": params["norm2"],
             "attn": {"q": cut(a["q"], slice(None), slice(q0, q1)),
                      "k": a["k"], "v": a["v"],
                      "o": cut(a["o"], slice(q0, q1))},
             "mlp": {key: cut(m[key], slice(None), slice(c0, c1))
                     for key in ("wi", "wg")}
             | {"wo": cut(m["wo"], slice(c0, c1))}}
    return local, split


def _md_layer_times(dev, smi, mesh) -> dict:
    """One tinyllama-1.1b decoder layer (bf16 params and activations,
    MD_BATCH x MD_SEQ tokens) forward and backward (every input's and
    param's gradient) through ``transformer.apply_block(split=)`` at rank
    0's shapes of the split n ways (n in MD_LAYER_SPLITS;
    ``_md_rank_block``, on the world-1 ``mesh``, so no collectives): what
    a rank computes.  Rank 0's output at n = 1 is held to the whole
    layer's bit for bit; for n > 1 the ranks' partial attention and MLP
    outputs (``_self_attention(kv=)`` and ``apply_mlp`` on each rank's
    params), summed in bf16 as the split's all-reduces sum them, are
    reported against the whole layer in bf16 ulps of each row's scale
    (not held: each sum rounds in another order)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, transformer
    cfg = get_config(MD_ARCH)
    gen = torch.Generator(device=dev).manual_seed(31)
    block = transformer.tree_map(
        lambda x: x.to(cfg.param_dtype),
        transformer.init_block(gen, cfg, "attn", dev))
    x = torch.randn((MD_BATCH, MD_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(cfg.dtype)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(cfg.dtype)
    pos = torch.arange(MD_SEQ, dtype=torch.int32,
                       device=dev)[None].expand(MD_BATCH, -1)
    with torch.no_grad():
        whole = transformer.apply_block(block, cfg, "attn", x, pos)[0]
    out = {"shape": f"{MD_ARCH} layer, {MD_BATCH} x {MD_SEQ} tokens, bf16"}
    for n in MD_LAYER_SPLITS:
        local, split = _md_rank_block(block, cfg, n, 0, mesh)
        local = transformer.tree_map(
            lambda z: z.detach().clone().requires_grad_(True), local)
        leaves = _leaves(local)
        xg = x.detach().clone().requires_grad_(True)

        def fwd_bwd():
            y = transformer.apply_block(local, cfg, "attn", xg, pos,
                                        split=split)[0]
            return torch.autograd.grad(y, [xg] + leaves, dy)

        ms = kernel_ms(fwd_bwd, iters=5, warmup=2)
        with torch.no_grad():
            if n == 1:
                got = transformer.apply_block(local, cfg, "attn", x, pos,
                                              split=split)[0]
                if not torch.equal(got, whole):
                    fail("multidevice: rank 0's layer at n = 1 is not the "
                         "whole layer bit for bit")
                ulps = 0.0
            else:
                ranks = [_md_rank_block(block, cfg, n, r, mesh)
                         for r in range(n)]
                h = layers.apply_norm(block["norm1"], x, cfg.norm)
                attn = None
                for r, s in ranks:
                    part = transformer._self_attention(
                        r["attn"], cfg, h, pos, None, None, kv=s.kv)[0]
                    attn = part if attn is None else attn + part
                x1 = x + attn
                h2 = layers.apply_norm(block["norm2"], x1, cfg.norm)
                mlp = None
                for r, _ in ranks:
                    part = layers.apply_mlp(r["mlp"], h2, cfg.activation)
                    mlp = part if mlp is None else mlp + part
                ulps = _bf16_row_ulps(x1 + mlp, whole)
                del ranks, h, attn, x1, h2, mlp
        out[f"n={n}"] = {"ms": ms, "sum_bf16_row_ulps": ulps}
        del local, leaves, xg
        torch.cuda.empty_cache()
    base = out["n=1"]["ms"]
    print(f"multidevice: one decoder layer forward + backward at rank 0's "
          f"shapes ({out['shape']}): "
          + ", ".join(f"n={n} {out[f'n={n}']['ms']:.3f} ms "
                      f"({out[f'n={n}']['ms'] / base:.3f} of n=1, expected "
                      f"{1 / n:.3f}-{min(1.0, 2 / n):.3f})"
                      for n in MD_LAYER_SPLITS)
          + "; n=1 == the whole layer bit for bit; the ranks' summed "
          f"partials {', '.join(str(round(out[f'n={n}']['sum_bf16_row_ulps'], 2)) for n in MD_LAYER_SPLITS[1:])} "
          f"bf16 ulps of the row scale from it (n = "
          f"{', '.join(str(n) for n in MD_LAYER_SPLITS[1:])}) [{smi}]",
          flush=True)
    del block, x, dy, whole
    torch.cuda.empty_cache()
    return out


class _SplitMoECalls:
    """Within the block, counts ``moe.apply_moe`` calls (the model calls
    it by its module attribute) by how their ``split`` splits the
    experts: "experts", "columns", "whole" (a split that leaves them
    whole) or "unsplit" (no split: one device)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.counts = dict.fromkeys(("experts", "columns", "whole",
                                     "unsplit"), 0)
        self.ranges = set()
        self._module, self._fn = moe, moe.apply_moe

        def counted(params, x, *args, split=None, **kw):
            if split is None:
                how = "unsplit"
            elif split.experts is not None:
                how = "experts"
            elif split.columns is not None:
                how = "columns"
            else:
                how = "whole"
            self.counts[how] += 1
            if split is not None and split.routed is not None:
                self.ranges.add((how, split.routed.r0, split.routed.r1))
            return self._fn(params, x, *args, split=split, **kw)

        moe.apply_moe = counted
        return self

    def __exit__(self, *exc):
        self._module.apply_moe = self._fn
        return False


def _md_cut_train(dev, smi, mesh, rules, cfg, label, kernels, per_step,
                  calls, steps) -> dict:
    """``cfg`` (a full-width cut) trained ``steps`` AdamW steps on
    MD_BATCH x MD_SEQ tokens from seed 0's state through the unsharded
    ``Trainer``, then, the ``kernels`` (``_md_launchers`` names) counted
    from 0, through ``Trainer(mesh=)`` on the world-1 ``mesh``, each
    run inside a fresh ``calls()`` (a context manager counting how the
    blocks split).  Losses, params and moments compared on the card;
    fails unless they are the same bits and every kernel launched
    ``per_step`` times a step.  Returns both runs, the launches, both
    ``calls`` counters and the unsharded state's GiB (kept on the card
    for the comparison: the sharded run's peak includes it)."""
    from repro_torch.checkpoint import tree_flatten
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import gather
    from repro_torch.train import TrainConfig, Trainer

    model = LanguageModel(cfg)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=2, peak_lr=3e-4,
                       log_every=steps)
    stream = launch_train.data_stream(cfg, MD_SEQ, MD_BATCH, 0, dev)
    with calls() as one:
        unsharded, un = _md_train(f"{label}, unsharded Trainer",
                                  Trainer(model, tcfg), stream, dev, smi,
                                  steps=steps)
    resident = torch.cuda.memory_allocated(dev) / 2**30
    counted = {name: fn for name, fn in _md_launchers().items()
               if name in kernels}
    for fn in counted.values():
        fn.launches = 0
    with calls() as split:
        sharded, sh = _md_train(f"{label}, sharded Trainer(mesh=)",
                                Trainer(model, tcfg, mesh=mesh, rules=rules),
                                stream, dev, smi, steps=steps)
    launches = {name: fn.launches for name, fn in counted.items()}
    for name, want in per_step.items():
        if launches[name] != want * steps:
            fail(f"multidevice {cfg.name}: {name} launched {launches[name]} "
                 f"times in the sharded run, expected {want} a step")
    differ = []
    for (path, x), (_, y) in zip(tree_flatten(gather(sharded)),
                                 tree_flatten(unsharded)):
        same = torch.equal(x, y) if isinstance(y, torch.Tensor) else x == y
        if not same:
            differ.append(path)
    torch.cuda.synchronize()
    same = not differ and sh["losses"] == un["losses"]
    slower = sh["step_ms"] / un["step_ms"] - 1.0
    print(f"multidevice {cfg.name}: sharded vs unsharded after {steps} "
          f"steps: losses "
          f"{'equal' if sh['losses'] == un['losses'] else 'differ'}, "
          f"params and moments "
          f"{'the same bits' if not differ else f'differ at {differ[:4]}'}; "
          f"{un['step_ms']:.3f} ms a step unsharded, {sh['step_ms']:.3f} "
          f"sharded ({slower:+.2%}), peak {un['peak_gib']:.2f} / "
          f"{sh['peak_gib']:.2f} GiB (the latter with the unsharded "
          f"state's {resident:.2f} GiB kept); launches on the sharded path "
          f"{launches} (a step: {per_step}) [{smi}]", flush=True)
    del sharded, unsharded
    torch.cuda.empty_cache()
    if not same:
        fail(f"multidevice {cfg.name}: at world size 1 the sharded step is "
             f"not the single-device step bit for bit ({differ[:8]})")
    return {"unsharded": un, "sharded": sh, "same_bits": same,
            "launches": launches, "launches_per_step": per_step,
            "one": one, "split": split, "resident_gib": resident}


def _md_moe_train(dev, smi, mesh, rules) -> dict:
    """Phase 14's qwen2-moe-a2.7b cut (MOE_CUT layers at full width,
    bf16, remat, its MACH head) through ``_md_cut_train`` for
    MOE_TRAIN_STEPS steps: each MoE block's experts split by expert
    with n = 1 (the rules shard E = 60 on a ``model`` axis of one), the
    attention by heads and the shared MLP by columns, the head by
    repetition; kernels 3 and 10 counted."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_CUT)
    label = (f"{MOE_ARCH} cut to {MOE_CUT} layers ({cfg.num_experts} "
             f"experts of d_ff {cfg.moe_d_ff}, top-{cfg.experts_top_k}, "
             f"{cfg.num_shared_experts} shared of {cfg.shared_d_ff}; MACH "
             f"B={cfg.mach.num_buckets} R={cfg.mach.num_repetitions})")
    n_moe = cfg.layout().count("moe")
    per_step = {"mach_xent_fwd": 1, "mach_xent_bwd": 1,
                "flash_attention": 2 * n_moe, "flash_attention_bwd": n_moe}
    res = _md_cut_train(dev, smi, mesh, rules, cfg, label, MOE_KERNELS,
                        per_step, _SplitMoECalls, MOE_TRAIN_STEPS)
    one, split = res.pop("one"), res.pop("split")
    # forward and remat's recompute of every MoE block, every step
    calls = 2 * n_moe * MOE_TRAIN_STEPS
    print(f"multidevice moe: MoE blocks split by expert (n = 1) "
          f"{split.counts['experts']} calls", flush=True)
    if split.counts["experts"] != calls or one.counts["unsplit"] != calls \
            or split.ranges != {("experts", 0, cfg.num_experts)}:
        fail(f"multidevice moe: the MoE blocks ran {split.counts} sharded "
             f"({split.ranges}) and {one.counts} unsharded, expected "
             f"{calls} calls split by expert over all {cfg.num_experts}")
    return dict(res, calls=split.counts)


class _SplitRGLRUCalls:
    """Within the block, the ``recurrent.apply_rglru_block`` calls (the
    model calls it by its module attribute): ``split`` those with a
    split, their channel ranges in ``ranges``, ``whole`` the rest."""

    def __enter__(self):
        from repro_torch.models import recurrent
        self.split = self.whole = 0
        self.ranges = set()
        self._module, self._fn = recurrent, recurrent.apply_rglru_block

        def counted(params, x, state=None, split=None):
            if split is None:
                self.whole += 1
            else:
                self.split += 1
                self.ranges.add((split.r0, split.r1))
            return self._fn(params, x, state, split=split)

        recurrent.apply_rglru_block = counted
        return self

    def __exit__(self, *exc):
        self._module.apply_rglru_block = self._fn
        return False


def _md_rglru_train(dev, smi, mesh, rules) -> dict:
    """recurrentgemma-2b's one period, (rglru, rglru, attn_local), at
    full width with its MACH head (bf16, remat) through
    ``_md_cut_train`` for MD_RG_STEPS steps: each RG-LRU block split by
    channels with n = 1 (the rules shard W = 2,560 on a ``model`` axis
    of one), the MLP by columns, the head by repetition (the 10 heads
    whole); kernels 9, 3 and 10 counted."""
    from repro_torch.configs import get_config

    cfg = get_config(MD_RG_ARCH)
    cfg = dataclasses.replace(cfg, num_layers=len(cfg.block_pattern))
    label = (f"{MD_RG_ARCH} cut to one period {cfg.block_pattern} (RG-LRU "
             f"width {cfg.resolved_rnn_width}; MACH "
             f"B={cfg.mach.num_buckets} R={cfg.mach.num_repetitions})")
    n_rg = cfg.layout().count("rglru")
    n_attn = cfg.num_layers - n_rg
    per_step = {"lru_scan": 2 * n_rg, "lru_scan_bwd": n_rg,
                "mach_xent_fwd": 1, "mach_xent_bwd": 1,
                "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    res = _md_cut_train(dev, smi, mesh, rules, cfg, label, MD_RG_KERNELS,
                        per_step, _SplitRGLRUCalls, MD_RG_STEPS)
    one, split = res.pop("one"), res.pop("split")
    calls = 2 * n_rg * MD_RG_STEPS
    w = cfg.resolved_rnn_width
    print(f"multidevice {MD_RG_ARCH}: RG-LRU blocks split by channels (n = "
          f"1, channels {sorted(split.ranges)}) {split.split} calls, "
          f"kernel 9 launched {res['launches']['lru_scan']} + "
          f"{res['launches']['lru_scan_bwd']} (fwd + bwd) on the split "
          f"path", flush=True)
    if split.split != calls or split.whole or one.whole != calls \
            or split.ranges != {(0, w)}:
        fail(f"multidevice {MD_RG_ARCH}: the RG-LRU blocks ran {split.split} "
             f"split ({split.ranges}) and {split.whole} whole sharded, "
             f"{one.whole} unsharded; expected {calls} split over all {w} "
             f"channels")
    return dict(res, calls={"split": split.split, "whole": split.whole})


def _md_scan_per_rank(dev, smi) -> dict:
    """Kernel 9 as each rank of recurrentgemma-2b's RG-LRU split n ways
    by channels launches it (MD_SCAN_SHAPE, float32; n in MD_SPLITS):
    forward and backward on each rank's channels [k·W/n, (k+1)·W/n) in
    turn, against the whole kernels on the same inputs: h, da, dx and
    dh0 must be the whole kernels' channels bit for bit (every channel's
    recurrence is its own, and each step rounds its product and its sum
    alone, as the plain version does).  Each rank's forward and backward
    ms (CUDA events; mean of the n) beside the whole kernel's and its
    own bound.  Not counted on the path."""
    from repro_torch.kernels import lru_scan as ls
    b, t, w = MD_SCAN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(41)
    a = torch.rand((b, t, w), generator=gen, device=dev) * 0.5 + 0.5
    x = torch.randn((b, t, w), generator=gen, device=dev)
    h0 = torch.randn((b, w), generator=gen, device=dev)
    dh = torch.randn((b, t, w), generator=gen, device=dev)
    h = ls.lru_scan_cuda(a, x, h0)
    whole_bwd = ls.lru_scan_bwd_cuda(a, h, h0, dh)

    def times(aa, xx, hh0, hh, ddh):
        return {"fwd": kernel_ms(lambda: ls.lru_scan_cuda(aa, xx, hh0)),
                "bwd": kernel_ms(lambda: ls.lru_scan_bwd_cuda(aa, hh, hh0,
                                                              ddh))}

    def bounds(d):
        return {"fwd": bound_of(ls.work(b, t, d, a.dtype), F32_OPS_PER_S)[0],
                "bwd": bound_of(ls.work(b, t, d, a.dtype, True),
                                F32_OPS_PER_S)[0]}

    res = {"whole": {"ms": times(a, x, h0, h, dh), "bound_ms": bounds(w)},
           "shape": f"(B, T, W)=({b}, {t}, {w}) float32"}
    for n in MD_SPLITS:
        per = w // n
        ranks = []
        for k in range(n):
            c = slice(k * per, (k + 1) * per)
            ra, rx, rh0, rdh = (z[..., c].contiguous()
                                for z in (a, x, h0, dh))
            rh = ls.lru_scan_cuda(ra, rx, rh0)
            got = (rh,) + ls.lru_scan_bwd_cuda(ra, rh, rh0, rdh)
            torch.cuda.synchronize()
            for name, g, want in zip(("h", "da", "dx", "dh0"), got,
                                     (h,) + whole_bwd):
                if not torch.equal(g, want[..., c]):
                    fail(f"multidevice: kernel 9 on channels [{c.start}, "
                         f"{c.stop}) of {n} ranges: {name} is not the whole "
                         f"kernel's bit for bit (max err "
                         f"{float((g - want[..., c]).abs().max()):.3e})")
            ranks.append({"channels": [c.start, c.stop],
                          "ms": times(ra, rx, rh0, rh, rdh)})
            del ra, rx, rh0, rdh, rh, got
        mean = {key: statistics.mean(r["ms"][key] for r in ranks)
                for key in ("fwd", "bwd")}
        out_n = {"ranks": ranks, "mean_ms": mean, "bound_ms": bounds(per),
                 "bit_for_bit": True}
        res[f"n={n}"] = out_n
        print(f"multidevice: kernel 9 on a rank's channels, {n} ways ({per} "
              f"of {w}, {res['shape']}): ms a rank (mean of {n}) "
              + ", ".join(f"{key} {mean[key]:.4f} "
                          f"({mean[key] / res['whole']['ms'][key]:.3f} of "
                          f"the whole {res['whole']['ms'][key]:.4f}; bound "
                          f"{out_n['bound_ms'][key]:.4f})" for key in mean)
              + f"; h, da, dx, dh0 the whole kernels' bit for bit [{smi}]",
              flush=True)
    del a, x, h0, dh, h, whole_bwd
    torch.cuda.empty_cache()
    return res


def _md_xattn_per_rank(dev, smi) -> dict:
    """Kernel 10 as each rank of seamless-m4t-large-v2's cross-attention
    split n ways by heads launches it (MD_XATTN_SHAPE: H/n query and
    KV/n kv heads; n in MD_SPLITS) and whole, non-causal at S != T, bf16,
    forward and backward, each held to the plain version by phases 7
    and 9's rules and timed beside its bound (``_flash_times``; every
    rank's shape is the same, MHA).  Not counted on the path."""
    b, t, s, h, kv, hd = MD_XATTN_SHAPE
    cases = [(f"seamless cross {h // n} of {h} heads", b, t, s, h // n,
              kv // n, hd, False, True, torch.bfloat16)
             for n in (1,) + MD_SPLITS]
    rows = _flash_times(dev, smi, cases)
    res = {"shape": f"q ({b}, {t}, H/n, {hd}), k/v ({b}, {s}, KV/n, {hd}) "
                    f"bfloat16, non-causal"}
    for n, row in zip((1,) + MD_SPLITS, rows.values()):
        res["whole" if n == 1 else f"n={n}"] = {
            key: row[key] for key in ("ms", "bwd_ms", "bound_ms",
                                      "bwd_bound_ms", "plain_ms",
                                      "bwd_plain_ms", "library_ms",
                                      "bwd_library_ms", "bf16_row_ulps",
                                      "bwd_ulps", "max_abs_err")}
    whole = res["whole"]
    print(f"multidevice: kernel 10 on a rank's cross-attention heads "
          f"({res['shape']}), held to plain: " + "; ".join(
              f"n={n} fwd {res[f'n={n}']['ms']:.4f} "
              f"({res[f'n={n}']['ms'] / whole['ms']:.3f} of the whole "
              f"{whole['ms']:.4f}; bound {res[f'n={n}']['bound_ms']:.4f}), "
              f"bwd {res[f'n={n}']['bwd_ms']:.4f} "
              f"({res[f'n={n}']['bwd_ms'] / whole['bwd_ms']:.3f} of "
              f"{whole['bwd_ms']:.4f}; bound "
              f"{res[f'n={n}']['bwd_bound_ms']:.4f})" for n in MD_SPLITS)
          + f" [{smi}]", flush=True)
    return res


def _md_rglru_block(dev, smi, mesh) -> dict:
    """One recurrentgemma-2b RG-LRU block (kind "rglru": the RG-LRU and
    its MLP; full width, bf16 params and activations, MD_BATCH x MD_SEQ
    tokens) forward and backward (every input's and param's gradient)
    through ``transformer.apply_block(split=)`` at rank 0's shapes of
    the split n ways (n in MD_LAYER_SPLITS): its channels of every
    RG-LRU leaf and its MLP columns, a ``BlockSplit`` of the port's
    ``RangeSplit``s on the world-1 ``mesh`` (no collectives; each gate's
    partial is cut to the rank's channels, what it computes).  At n = 1
    the output must be the whole block's bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.sharding import BlockSplit, RangeSplit
    from torch_multidevice_ranks import rglru_channels

    cfg = get_config(MD_RG_ARCH)
    w, f = cfg.resolved_rnn_width, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(43)
    block = transformer.tree_map(
        lambda z: z.to(cfg.param_dtype),
        transformer.init_block(gen, cfg, "rglru", dev))
    x = torch.randn((MD_BATCH, MD_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(cfg.dtype)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(cfg.dtype)
    pos = torch.arange(MD_SEQ, dtype=torch.int32,
                       device=dev)[None].expand(MD_BATCH, -1)
    names = mesh.mesh_dim_names
    dims, batch = (names.index("model"),), (names.index("data"),)
    with torch.no_grad():
        whole = transformer.apply_block(block, cfg, "rglru", x, pos)[0]
    out = {"shape": f"{MD_RG_ARCH} RG-LRU block (W {w}, d_ff {f}), "
                    f"{MD_BATCH} x {MD_SEQ} tokens, bf16"}
    for n in MD_LAYER_SPLITS:
        c1, m1 = w // n, f // n
        m = block["mlp"]
        local = {"norm1": block["norm1"], "norm2": block["norm2"],
                 "rglru": rglru_channels(block["rglru"], 0, c1),
                 "mlp": {key: {"kernel": m[key]["kernel"][:, :m1]
                               .contiguous()} for key in ("wi", "wg")}
                 | {"wo": {"kernel": m["wo"]["kernel"][:m1].contiguous()}}}
        split = BlockSplit(None, None, RangeSplit(mesh, 0, m1, dims, batch),
                           rglru=RangeSplit(mesh, 0, c1, dims, batch))
        local = transformer.tree_map(
            lambda z: z.detach().clone().requires_grad_(True), local)
        leaves = _leaves(local)
        xg = x.detach().clone().requires_grad_(True)

        def fwd_bwd():
            y = transformer.apply_block(local, cfg, "rglru", xg, pos,
                                        split=split)[0]
            return torch.autograd.grad(y, [xg] + leaves, dy)

        ms = kernel_ms(fwd_bwd, iters=5, warmup=2)
        with torch.no_grad():
            got = transformer.apply_block(local, cfg, "rglru", x, pos,
                                          split=split)[0]
        if not torch.isfinite(got.float()).all():
            fail(f"multidevice: rank 0's RG-LRU block at n = {n} is not "
                 f"finite")
        if n == 1 and not torch.equal(got, whole):
            fail("multidevice: rank 0's RG-LRU block at n = 1 is not the "
                 "whole block bit for bit")
        out[f"n={n}"] = {"ms": ms}
        del local, leaves, xg, got
        torch.cuda.empty_cache()
    base = out["n=1"]["ms"]
    print(f"multidevice: one RG-LRU block forward + backward at rank 0's "
          f"shapes ({out['shape']}): "
          + ", ".join(f"n={n} {out[f'n={n}']['ms']:.3f} ms "
                      f"({out[f'n={n}']['ms'] / base:.3f} of n=1)"
                      for n in MD_LAYER_SPLITS)
          + f"; n=1 == the whole block bit for bit [{smi}]", flush=True)
    del block, x, dy, whole
    torch.cuda.empty_cache()
    return out


def _md_moe_block(dev, smi, mesh) -> dict:
    """One qwen2-moe-a2.7b MoE block (its full widths, routed and shared
    experts) on MD_BATCH x MD_SEQ tokens at each rank's shapes for n in
    MD_MOE_SPLITS, built with the port's own ``MoESplit`` /
    ``RangeSplit`` on the world-1 ``mesh`` (``moe_rank_block``, whose
    ``into`` and ``out_of`` are the identity there, so each rank's
    ``apply_moe(split=)`` returns its partial output): in float32 the n
    ranks' partial outputs summed on the card held to the whole block at
    rtol MD_MOE_F32_RTOL (atol of the largest entry), the aux losses the
    whole block's bit for bit; in bf16 rank 0's forward + backward (every
    input's and param's gradient) timed beside the whole block's; the
    expert bytes a rank gathers (bf16, one layer)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.transformer import tree_map
    from torch_multidevice_ranks import moe_rank_block

    cfg = get_config(MOE_ARCH)
    kw = _moe_kwargs(cfg)
    gen = torch.Generator(device=dev).manual_seed(37)
    params = moe.init_moe(gen, cfg.d_model, cfg.moe_d_ff, cfg.num_experts,
                          cfg.num_shared_experts, cfg.shared_d_ff, dev,
                          cfg.activation)
    x = torch.randn((MD_BATCH, MD_SEQ, cfg.d_model), generator=gen,
                    device=dev)
    names = mesh.mesh_dim_names
    dims, batch = (names.index("model"),), (names.index("data"),)
    expert_keys = ("wi", "wg", "wo", "shared")
    out = {"shape": f"{MOE_ARCH} block, {MD_BATCH} x {MD_SEQ} tokens"}
    with torch.no_grad():
        whole, aux = moe.apply_moe(params, x, **kw)
        for n, how in MD_MOE_SPLITS.items():
            total = torch.zeros_like(whole)
            for rank in range(n):
                local, split = moe_rank_block(params, how, n, rank, mesh,
                                              dims, batch)
                y, rank_aux = moe.apply_moe(local, x, split=split, **kw)
                if not all(torch.equal(rank_aux[k], aux[k]) for k in aux):
                    fail(f"multidevice moe block n={n}: rank {rank}'s aux "
                         f"losses are not the whole block's")
                total += y
                del local, y
            torch.cuda.synchronize()
            scale = float(whole.abs().max())
            err = float((total - whole).abs().max())
            out[f"n={n}"] = {"split": how, "max_abs_err": err,
                             "largest": scale}
            if not torch.allclose(total, whole, rtol=MD_MOE_F32_RTOL,
                                  atol=MD_MOE_F32_RTOL * scale):
                fail(f"multidevice moe block n={n} ({how}): the ranks' "
                     f"float32 partials summed are {err:.3e} from the whole "
                     f"block (largest {scale:.3e}), past rtol "
                     f"{MD_MOE_F32_RTOL}")
            del total
    del whole
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    torch.cuda.empty_cache()
    x16 = x.to(torch.bfloat16)
    dy = torch.randn(x16.shape, generator=gen, device=dev).to(torch.bfloat16)

    def timed(local, split):
        local = tree_map(lambda z: z.detach().clone().requires_grad_(True),
                         local)
        leaves = _leaves(local)
        xg = x16.detach().clone().requires_grad_(True)

        def fwd_bwd():
            y, _ = moe.apply_moe(local, xg, split=split, **kw)
            return torch.autograd.grad(y, [xg] + leaves, dy)

        nbytes = sum(t.numel() * t.element_size() for key in expert_keys
                     if key in local for t in _leaves(local[key]))
        return kernel_ms(fwd_bwd, iters=5, warmup=2), nbytes

    out["whole"] = dict(zip(("ms", "expert_bytes"), timed(p16, None)))
    for n, how in MD_MOE_SPLITS.items():
        local, split = moe_rank_block(p16, how, n, 0, mesh, dims, batch)
        ms, nbytes = timed(local, split)
        out[f"n={n}"].update(ms=ms, expert_bytes=nbytes)
        del local
        torch.cuda.empty_cache()
    base = out["whole"]
    print(f"multidevice: one MoE block at rank 0's shapes ({out['shape']}; "
          f"float32 sums of the n ranks' partials against the whole block "
          f"at rtol {MD_MOE_F32_RTOL}, bf16 forward + backward timed): "
          f"whole {base['ms']:.3f} ms, experts {base['expert_bytes']:,} "
          f"bytes; " + "; ".join(
              f"n={n} {how} {out[f'n={n}']['ms']:.3f} ms "
              f"({out[f'n={n}']['ms'] / base['ms']:.3f} of whole), experts "
              f"{out[f'n={n}']['expert_bytes']:,} bytes, float32 sum max "
              f"abs err {out[f'n={n}']['max_abs_err']:.3e} (largest "
              f"{out[f'n={n}']['largest']:.3e})"
              for n, how in MD_MOE_SPLITS.items()) + f" [{smi}]",
          flush=True)
    del p16, x, x16, dy
    torch.cuda.empty_cache()
    return out


def _md_train(label, trainer, stream, dev, smi, count=None,
              steps=MD_STEPS):
    """``steps`` steps from seed 0's state: (the state, losses, gradient
    norms, ms a step (host clock, synchronized), the steps' peak GiB and
    the init's).  ``count`` (a ``GatherCount``) watches the first step,
    which the median leaves out."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0),
                               dev)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, step_ms = [], [], []
    for s in range(steps):
        batch = stream.batch_at(s)
        t1 = time.perf_counter()
        with (count if count is not None and s == 0
              else contextlib.nullcontext()):
            state, met = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ms = statistics.median(step_ms[1:])
    print(f"multidevice: {label}: losses {losses}, gradient norms {norms}; "
          f"{ms:.3f} ms/step (host clock, median of steps 2..{steps}; "
          f"the first {step_ms[0]:.3f} ms), "
          f"{MD_BATCH * MD_SEQ / ms * 1e3:.1f} tokens/s, peak {peak:.2f} GiB "
          f"in the steps ({init_peak:.2f} GiB drawing and placing the "
          f"state) [{smi}]", flush=True)
    if not all(math.isfinite(v) for v in losses + norms):
        fail(f"multidevice {label}: losses {losses}, gradient norms {norms}")
    return state, {"losses": losses, "grad_norms": norms, "step_ms": ms,
                   "step_ms_all": step_ms, "peak_gib": peak,
                   "init_peak_gib": init_peak}


def _md_host(state):
    """``state`` gathered whole and copied to the host."""
    from repro_torch.checkpoint import tree_flatten, tree_unflatten
    from repro_torch.sharding import gather
    return tree_unflatten(state, [
        x.cpu() if isinstance(x, torch.Tensor) else x
        for _, x in tree_flatten(gather(state))])


def _md_diffs(state, host) -> dict:
    """Per tree (params, mu, nu, ...): the largest |state - host| over the
    leaves whose bits differ, leaf by leaf on the card ({} if none)."""
    from repro_torch.checkpoint import tree_flatten
    from repro_torch.sharding import gather
    out = {}
    for (path, x), (_, y) in zip(tree_flatten(gather(state)),
                                 tree_flatten(host)):
        tree = path.split("[")[0]
        if isinstance(x, torch.Tensor):
            diff = _leaf_diffs({"x": x}, {"x": y.to(x.device)})
        else:
            diff = [] if x == y else [(path, float("nan"), 0.0)]
        if diff:
            out[tree] = max(out.get(tree, 0.0), diff[0][1])
    return out


def _md_compression(dev) -> dict:
    """``topk_compress`` (two rounds of error feedback) and
    ``quantize_8bit`` on the card against the same calls on a CPU copy,
    bit for bit, on a tinyllama-sized MLP gradient with ties at its
    top-k threshold and an all-zero leaf."""
    from repro_torch.optim import (dequantize_8bit, init_error_feedback,
                                   quantize_8bit, topk_compress)
    from repro_torch.optim.optimizers import tree_leaves
    gen = torch.Generator(device=dev).manual_seed(17)
    g = {"wi": torch.randn((2048, 5632), generator=gen, device=dev),
         "b": torch.randn((5632,), generator=gen, device=dev).to(
             torch.bfloat16),
         "zero": torch.zeros((64, 64), device=dev)}
    g["wi"].view(-1)[:4096:7] = 9.5                   # tied largest values
    cpu = {k: v.cpu() for k, v in g.items()}
    results = {}
    for where, tree in (("cuda", g), ("cpu", cpu)):
        ef, rounds = init_error_feedback(tree), []
        for _ in range(2):
            kept, ef = topk_compress(tree, ef, 0.01)
            rounds.append((kept, ef.residual))
        q = quantize_8bit(tree)
        results[where] = (rounds, q, dequantize_8bit(q))
    torch.cuda.synchronize()
    checked = 0
    for a, b in zip(tree_leaves(results["cuda"]), tree_leaves(results["cpu"])):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            fail(f"multidevice: gradient compression differs on the card "
                 f"({a.dtype}, max {float((a.cpu().float() - b.float()).abs().max())})")
        checked += 1
    kept = results["cuda"][0][0][0]["wi"]
    print(f"multidevice: topk_compress (2 rounds of error feedback, 1% of "
          f"{kept.numel():,} kept: {int((kept != 0).sum()):,} with the ties) "
          f"and quantize_8bit / dequantize_8bit on the card == on the CPU, "
          f"{checked} tensors bit for bit", flush=True)
    return {"tensors_equal": checked}


def _md_entry_point(directory: str, smi: str) -> dict:
    """``torchrun --standalone --nproc_per_node=1 -m
    repro_torch.launch.train --local-mesh --full ...`` as a subprocess
    (torchrun is ``python -m torch.distributed.run``; ``--local-mesh`` is
    ``--local``, which torchrun's parser refuses under Python 3.12.3 as
    an abbreviation of its ``--local-addr``); its output printed here."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m", "repro_torch.launch.train",
           "--local-mesh", "--full", "--seq-len", str(MD_SEQ), "--global-batch",
           str(MD_BATCH), "--steps", str(MD_LAUNCH_STEPS), "--ckpt-dir",
           directory]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    seconds = time.perf_counter() - t0
    for line in (res.stdout.strip().splitlines()
                 + res.stderr.strip().splitlines()[-5:]):
        print(f"  | {line}", flush=True)
    print(f"multidevice: torchrun --standalone --nproc_per_node=1 -m "
          f"repro_torch.launch.train --local-mesh --full --seq-len {MD_SEQ} "
          f"--global-batch {MD_BATCH} --steps {MD_LAUNCH_STEPS} --ckpt-dir "
          f"...: rc {res.returncode} in {seconds:.1f} s [{smi}]", flush=True)
    if res.returncode != 0:
        fail(f"multidevice: the torchrun entry point returned "
             f"{res.returncode}")
    if (f"finished at step {MD_LAUNCH_STEPS} on cuda:0 x 1, mesh (1, 1)"
            not in res.stdout):
        fail("multidevice: the torchrun entry point did not finish its "
             "steps on a (1, 1) mesh")
    return {"rc": res.returncode, "seconds": seconds}


def phase_multidevice(dev) -> dict:
    """The sharded trainer on an NCCL world of one (a ``FileStore`` in a
    temporary directory) and a (1, 1) ``("data", "model")`` mesh with the
    FSDP rules: tinyllama-1.1b (MACH head) at full width, 2 x 4,096
    tokens, MD_STEPS steps through the unsharded ``Trainer``, and
    MD_FUSED_STEPS with the fused loss over the in-loss selection, then,
    launch counters from 0, both through ``Trainer(mesh=)`` from the same
    seed (each layer period's params gathered inside the recomputed
    period, the head split by repetition and the decoder by heads and
    hidden with n = 1, the state placed as it is built): losses, params
    and moments bit for bit (fused: the first loss), kernels 3, 4 and 10
    launched, the gathered bytes alive at once within the leaves outside
    the stacks plus two periods; ms a step, the steps' peak and the
    init's both ways.  Kernel 10 held to plain at the path's shape
    first, kernels 3 and 4 on each repetition range of the head split 2,
    4 and 8 ways, kernel 10 on each rank's heads of the decoder split 2,
    4 and 8 ways, and one decoder layer timed at a rank's shapes through
    ``apply_block(split=)`` on the world-1 mesh (none counted).  The
    sharded state saved once and restored unsharded and onto the mesh,
    bit for bit; one qwen2-moe-a2.7b MoE block at each rank's shapes
    (``_md_moe_block``) and phase 14's qwen2-moe cut sharded against
    unsharded, its experts split by expert with n = 1 (``_md_moe_train``,
    launch counters from 0 for its sharded run); then the torchrun entry
    point, and gradient compression on the card against the CPU."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import ShardingRules
    from repro_torch.train import Trainer
    # the gathered-bytes counter the CPU tests hold the worlds with
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_multidevice_ranks import GatherCount, gather_bounds

    t0 = time.perf_counter()
    smi = _nvidia_smi()
    out = {"flash": _flash_times(dev, smi, MD_FLASH),
           "per_range": _md_per_range(dev, smi),
           "flash_per_rank": _md_flash_per_rank(dev, smi),
           "scan_per_rank": _md_scan_per_rank(dev, smi),
           "xattn_per_rank": _md_xattn_per_rank(dev, smi)}
    torch.cuda.empty_cache()
    cfg = get_config(MD_ARCH, mach="on")
    fused_cfg = dataclasses.replace(cfg, mach_fused_loss=True,
                                    mach_bucket_select=MD_SELECT)
    tcfg = launch_train.train_config(MD_STEPS, 3e-4)
    model, fused_model = LanguageModel(cfg), LanguageModel(fused_cfg)
    stream = launch_train.data_stream(cfg, MD_SEQ, MD_BATCH, 0, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root:
        dist.init_process_group("nccl", init_method=f"file://{root}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            rules = ShardingRules(fsdp=True, sp=False)
            out["layer"] = _md_layer_times(dev, smi, mesh)
            out["rglru_block"] = _md_rglru_block(dev, smi, mesh)
            print(f"multidevice: {MD_ARCH} (MACH B={cfg.mach.num_buckets} "
                  f"R={cfg.mach.num_repetitions}, {cfg.num_layers} layers, "
                  f"{cfg.param_dtype} params, float32 moments, "
                  f"remat={cfg.remat}), {MD_BATCH} x {MD_SEQ} tokens, "
                  f"{MD_STEPS} AdamW steps (launch/train.py's train_config); "
                  f"an NCCL world of {dist.get_world_size()}, mesh "
                  f"{tuple(mesh.shape)} {mesh.mesh_dim_names}, "
                  f"ShardingRules(fsdp=True, sp=False)", flush=True)
            state, out["unsharded"] = _md_train(
                "unsharded Trainer", Trainer(model, tcfg), stream, dev, smi)
            host = _md_host(state)
            del state
            fused_label = (f"the fused loss over the selection (c_sel "
                           f"{MD_SELECT[0]} of {cfg.mach.num_buckets})")
            state, out["unsharded_fused"] = _md_train(
                f"unsharded Trainer, {fused_label}",
                Trainer(fused_model, tcfg), stream, dev, smi,
                steps=MD_FUSED_STEPS)
            del state
            launchers = {name: fn for name, fn in _md_launchers().items()
                         if name in MD_KERNELS}
            for fn in launchers.values():
                fn.launches = 0
            state, out["sharded_fused"] = _md_train(
                f"sharded Trainer(mesh=), {fused_label}",
                Trainer(fused_model, tcfg, mesh=mesh, rules=rules), stream,
                dev, smi, steps=MD_FUSED_STEPS)
            del state
            count = GatherCount()
            sharded, out["sharded"] = _md_train(
                "sharded Trainer(mesh=)", Trainer(model, tcfg, mesh=mesh,
                                                  rules=rules),
                stream, dev, smi, count)
            out["launches"] = {n: fn.launches for n, fn in launchers.items()}
            _md_hold_fused(out)
            out["gathered"] = dict(gather_bounds(host.params),
                                   peak=count.peak, calls=count.calls)
            _md_report(out, smi)
            print(f"multidevice: launches on the sharded path "
                  f"{out['launches']}", flush=True)
            if min(out["launches"].values()) < 1:
                fail(f"multidevice: a kernel of the path never ran: "
                     f"{out['launches']}")
            diffs = _md_diffs(sharded, host)
            same = (not diffs and out["sharded"]["losses"]
                    == out["unsharded"]["losses"])
            out["same_bits"], out["diffs"] = same, diffs
            print(f"multidevice: sharded vs unsharded after {MD_STEPS} "
                  f"steps: losses "
                  f"{'equal' if out['sharded']['losses'] == out['unsharded']['losses'] else 'differ'}"
                  f", params and moments "
                  f"{'the same bits' if not diffs else f'differ, largest by tree {diffs}'}",
                  flush=True)
            if not same:
                fail(f"multidevice: at world size 1 the sharded step is not "
                     f"the single-device step bit for bit ({diffs})")

            need = 1.1 * sum(x.numel() * x.element_size()
                             for x in _leaves(host.params)
                             + _leaves(host.opt_state)
                             if isinstance(x, torch.Tensor))
            free = shutil.disk_usage(root).free
            if free < need:
                fail(f"multidevice: {free / 1e9:.1f} GB free under {root}, "
                     f"the checkpoint needs {need / 1e9:.1f}")
            # one checkpoint, written by the sharded state, read back both
            # ways: the file holds each leaf whole, as an unsharded save
            # writes it (phase 16 writes tinyllama-1.1b's unsharded)
            mgr = CheckpointManager(os.path.join(root, "ckpt"), keep=2)
            times = {}
            t1 = time.perf_counter()
            mgr.save(MD_STEPS, sharded)
            times["save_sharded_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            restored, _ = mgr.restore(host, MD_STEPS, device=dev)
            torch.cuda.synchronize()
            times["restore_unsharded_s"] = time.perf_counter() - t1
            back = _md_diffs(restored, host)
            del restored
            t1 = time.perf_counter()
            restored, _ = mgr.restore(sharded, MD_STEPS)
            torch.cuda.synchronize()
            times["restore_sharded_s"] = time.perf_counter() - t1
            forth = _md_diffs(restored, host)
            placed = all(type(x).__name__ == "DTensor"
                         for x in _leaves(restored.params))
            del restored, sharded
            out["checkpoint"] = dict(times, sharded_to_unsharded=back,
                                     onto_the_mesh=forth)
            print(f"multidevice: checkpoint sharded -> unsharded "
                  f"{'bit for bit' if not back else back}, -> sharded "
                  f"{'bit for bit' if not forth else forth} "
                  f"(restored as DTensors: {placed}); "
                  + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
                  + f" [{smi}]", flush=True)
            if back or forth or not placed:
                fail(f"multidevice: a checkpoint did not restore across "
                     f"meshes bit for bit ({back}, {forth}, {placed})")
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            out["moe_block"] = _md_moe_block(dev, smi, mesh)
            out["moe"] = _md_moe_train(dev, smi, mesh, rules)
            out["moe_seconds"] = time.perf_counter() - t1
            print(f"multidevice: the MoE experts' parts in "
                  f"{out['moe_seconds']:.1f} s", flush=True)
            t1 = time.perf_counter()
            out["rglru"] = _md_rglru_train(dev, smi, mesh, rules)
            print(f"multidevice: the RG-LRU cut in "
                  f"{time.perf_counter() - t1:.1f} s", flush=True)
        finally:
            dist.destroy_process_group()
        del host
        torch.cuda.empty_cache()
        out["entry_point"] = _md_entry_point(os.path.join(root, "launch"),
                                             smi)
    out["compression"] = _md_compression(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"multidevice: phase wall time {out['seconds']:.1f} s", flush=True)
    return out


def _md_hold_fused(out) -> None:
    """The fused runs over the in-loss selection: the first step's loss
    the same bits sharded and unsharded (at world 1 the head split's
    n = 1: the same selection, and kernel 4's forward is deterministic);
    every loss and gradient norm finite.  Later steps are printed, not
    held: kernel 4 sums dW by float atomics, so its runs part in the last
    bits from the first update."""
    sh, un = out["sharded_fused"], out["unsharded_fused"]
    rel = max(abs(a - c) / abs(c) for a, c in zip(sh["losses"],
                                                   un["losses"]))
    print(f"multidevice: fused over the selection, sharded vs unsharded: "
          f"first loss {'the same bits' if sh['losses'][0] == un['losses'][0] else 'differs'}, "
          f"largest relative loss difference over {MD_FUSED_STEPS} steps "
          f"{rel:.3e}", flush=True)
    if sh["losses"][0] != un["losses"][0]:
        fail(f"multidevice: the fused sharded step's first loss "
             f"{sh['losses'][0]} is not the unsharded one's "
             f"{un['losses'][0]}")


# what phase 17 expects of the per-period sharded step at world 1
MD_STEP_SLOWDOWN = 0.03          # at most +3% on the unsharded step
MD_STEP_PEAK_GIB = 16.86 + 0.25  # the whole-tree gathering step's peak
MD_INIT_PEAK_GIB = 12.5          # the state placed as it is built


def _md_report(out, smi) -> None:
    """The sharded run's gathered-bytes peak against its bound (fails
    above it), and ms a step, the steps' peak and the init's peak both
    ways against what phase 17 expects (printed, not held: one call's
    host clock)."""
    g, un, sh = out["gathered"], out["unsharded"], out["sharded"]
    print(f"multidevice: per-period gathering, the first sharded step: "
          f"{g['calls']} leaves gathered, at most {g['peak']:,} bytes "
          f"alive at once (world 1: the gathers alias the shards, so the "
          f"schedule); bound {g['bound']:,} = outside the stacks "
          f"{g['rest']:,} + 2 x the largest period {g['period']:,}; whole "
          f"tree {g['whole']:,} [{smi}]", flush=True)
    if not 0 < g["peak"] <= g["bound"] < g["whole"]:
        fail(f"multidevice: gathered bytes alive at once {g['peak']:,} "
             f"above the per-period bound {g['bound']:,} (whole "
             f"{g['whole']:,})")
    slower = sh["step_ms"] / un["step_ms"] - 1.0
    checks = {
        "ms a step": (f"{un['step_ms']:.3f} unsharded, {sh['step_ms']:.3f} "
                      f"sharded ({slower:+.2%})",
                      slower <= MD_STEP_SLOWDOWN),
        "step peak": (f"{un['peak_gib']:.2f} / {sh['peak_gib']:.2f} GiB",
                      sh["peak_gib"] <= MD_STEP_PEAK_GIB),
        "init peak": (f"{un['init_peak_gib']:.2f} drawing / "
                      f"{sh['init_peak_gib']:.2f} drawing and placing GiB",
                      sh["init_peak_gib"] <= MD_INIT_PEAK_GIB)}
    out["expected"] = {k: ok for k, (_, ok) in checks.items()}
    print("multidevice: against the expected (+3% a step, step peak <= "
          f"{MD_STEP_PEAK_GIB:.2f} GiB, init peak <= {MD_INIT_PEAK_GIB} "
          "GiB): " + "; ".join(f"{k} {text} {'inside' if ok else 'OUTSIDE'}"
                               for k, (text, ok) in checks.items())
          + f" [{smi}]", flush=True)


def _add_multidevice_launches(rows, md) -> None:
    """Rows 3, 4 (its LM-head row) and 10 gain their launches on phase
    17's sharded path, rows 3 and 10 on its sharded qwen2-moe path, rows
    3, 9 and 10 on its sharded recurrentgemma-2b cut; row 10 its check
    and times at that path's shape, on each rank's heads of the decoder
    split and of seamless's cross-attention split 2, 4 and 8 ways, and
    one decoder layer's at rank 0's shapes; row 9 its times on each
    rank's channels of the RG-LRU split 2, 4 and 8 ways and one RG-LRU
    block's at rank 0's shapes; rows 3 and 4 their times on each
    repetition range of the head split 2, 4 and 8 ways, beside the whole
    kernel's."""
    per = md["per_range"]
    kinds = {"mach_xent_fwd": "xent_fwd", "mach_xent_bwd": "xent_bwd"}
    for row in rows:
        name = row["name"]
        if name in md["launches"]:
            row["launches_multidevice"] = md["launches"][name]
        if name in md["moe"]["launches"]:
            row["launches_multidevice_moe"] = md["moe"]["launches"][name]
        if name in md["rglru"]["launches"]:
            row["launches_multidevice_rglru"] = md["rglru"]["launches"][name]
        if name == "lru_scan":
            row["per_rank_multidevice"] = md["scan_per_rank"]
            row["block_per_rank_multidevice"] = md["rglru_block"]
        if name == "flash_attention":
            row["multidevice_shape"] = md["flash"]
            row["per_rank_multidevice"] = md["flash_per_rank"]
            row["cross_per_rank_multidevice"] = md["xattn_per_rank"]
            row["layer_per_rank_multidevice"] = md["layer"]
        if name == "mach_fused_xent_dense" and "train_step_ms" not in row:
            row["launches_multidevice"] = (md["launches"]["dense_fwd"]
                                           + md["launches"]["dense_bwd"])
            kinds_here = ("dense_fwd", "dense_bwd")
        elif name in kinds:
            kinds_here = (kinds[name],)
        else:
            continue
        row["per_range_multidevice"] = {
            "shape": per["shape"],
            "whole_ms": {k: per["whole"]["ms"][k] for k in kinds_here},
            **{split: {"ms": {k: [x["ms"][k] for x in per[split]["ranges"]]
                              for k in kinds_here},
                       "bound_ms": {k: per[split]["bound_ms"][k]
                                    for k in kinds_here},
                       "loss_rel_err": per[split]["loss_rel_err"]}
               for split in per if split.startswith("n=")}}


# ---------------------------------------------------------------------------
# phase 18: the dry run (launch/dryrun.py) against the card
# ---------------------------------------------------------------------------

# the production cell run through the dry run's entry point (the JAX
# package's perf.py "mistral_train" cell)
DRY_CELL = ("mistral-large-123b", "train_4k")
# the dry run's step peak against phase 17's measured one: at most this
# far apart (relative)
DRY_PEAK_RTOL = 0.02


class _BackgroundCell:
    """``python -m repro_torch.launch.dryrun --arch A --shape S`` started as
    a subprocess at nice 10 when the script starts: the dry run computes
    nothing on the card (rank 0 of the (16, 16) mesh on fake tensors on
    the CPU), and its eager step takes minutes of one host core, so it
    runs beside the card's phases and phase 18 waits for it.  ``stop``
    ends it if it still runs."""

    def __init__(self, arch: str, shape: str):
        import tempfile
        self.arch, self.shape = arch, shape
        self.cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")]
            + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.log = tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.cmd, cwd=ROOT, env=env,
                                     stdout=self.log,
                                     stderr=subprocess.STDOUT)
        os.setpriority(os.PRIO_PROCESS, self.proc.pid, 10)

    def wait(self, timeout: float) -> tuple[int, str]:
        """(its return code, its output) once it ends; fails after
        ``timeout`` seconds more."""
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            fail(f"dry run: {' '.join(self.cmd[2:])} still running after "
                 f"{time.perf_counter() - self.t0:.0f} s")
        self.log.seek(0)
        return rc, self.log.read()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def _dry_world1(dev) -> dict:
    """Phase 17's sharded trainer (MD_ARCH with its MACH head, MD_BATCH x
    MD_SEQ tokens, launch/train.py's train_config, the FSDP rules) as the
    dry run runs it: a fake world of one, a (1, 1) mesh, fake CUDA
    tensors (``dryrun.lower_cell`` with a spec)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    spec = dict(kind="train", seq_len=MD_SEQ, global_batch=MD_BATCH, world=1,
                train_config=launch_train.train_config(MD_STEPS, 3e-4))
    res = dryrun.lower_cell(MD_ARCH, "train_4k", mach="on", spec=spec,
                            device=dev)
    if not res.ok:
        fail(f"dry run: {MD_ARCH} at world 1: {res.reason}")
    return res.data


def _counted_real_step(dev) -> tuple[dict, dict]:
    """One untimed step of phase 17's sharded trainer on the card (an NCCL
    world of one, the (1, 1) mesh, seed 0's state, the stream's first
    batch) under the dry run's counter: its counts, and the launches of
    the path's kernels over the step."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mach_xent as mx
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import ShardingRules, activate
    from repro_torch.train import Trainer
    launchers = {"flash_attention": fa.flash_attention_cuda,
                 "flash_attention_bwd": fa.flash_attention_bwd_cuda,
                 "mach_xent_fwd": mx.mach_xent_cuda_fwd,
                 "mach_xent_bwd": mx.mach_xent_cuda_bwd}
    cfg = get_config(MD_ARCH, mach="on")
    rules = ShardingRules(fsdp=True, sp=False)
    batch = launch_train.data_stream(cfg, MD_SEQ, MD_BATCH, 0,
                                     dev).batch_at(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dry_") as root:
        dist.init_process_group("nccl", init_method=f"file://{root}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            trainer = Trainer(LanguageModel(cfg),
                              launch_train.train_config(MD_STEPS, 3e-4),
                              mesh=mesh, rules=rules)
            state = trainer.init_state(
                torch.Generator(device=dev).manual_seed(0), dev)
            before = {k: f.launches for k, f in launchers.items()}
            with activate(mesh, rules), CostCounter() as counter:
                state, _ = trainer.step_fn(state, batch)
            torch.cuda.synchronize()
            launched = {k: f.launches - before[k]
                        for k, f in launchers.items()}
            del state
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return counter.summary(), launched


def phase_dry_run(dev, md: dict, cell: _BackgroundCell) -> dict:
    """(a) The dry run at world 1 against the card: phase 17's sharded
    step dry-run on fake CUDA tensors, and one real step counted by the
    same counter — flops, bytes and each kernel's ``work()`` equal
    exactly; the dry run's step peak within DRY_PEAK_RTOL of phase 17's
    measured peak; the counted model flops (6·N·D) and all counted flops
    over phase 17's measured ms a step, the port's whole-step share of
    the H100's 989 TFLOP/s.  (b) DRY_CELL through the entry point (started
    when the script started, ``_BackgroundCell``): rc 0, its JSON read
    back and its per-rank peak, init peak, fit and roofline printed."""
    t0 = time.perf_counter()
    smi = _nvidia_smi()
    dry = _dry_world1(dev)
    t_dry = time.perf_counter() - t0
    real, launched = _counted_real_step(dev)
    out = {"dry": {k: dry[k] for k in ("cost", "kernels", "memory",
                                        "roofline")},
           "real": real, "launched": launched, "dry_seconds": t_dry}
    cost = dry["cost"]
    same = (cost["flops_per_device"] == real["flops"]
            and cost["bytes_accessed_per_device"] == real["bytes"]
            and dry["kernels"] == real["kernels"])
    print(f"dry run: {MD_ARCH} (MACH head) {MD_BATCH} x {MD_SEQ}, world 1, "
          f"fake CUDA tensors ({t_dry:.1f} s): {cost['flops_per_device']:.6e} "
          f"flops, {cost['bytes_accessed_per_device']:.6e} bytes; one real "
          f"step of phase 17's sharded trainer counted: {real['flops']:.6e} "
          f"flops, {real['bytes']:.6e} bytes; kernels' work "
          f"{'equal' if dry['kernels'] == real['kernels'] else 'DIFFER'} "
          f"{ {k: v['count'] for k, v in real['kernels'].items()} }",
          flush=True)
    if not same:
        fail(f"dry run: the dry run's counts differ from the card's step: "
             f"dry {cost}, {dry['kernels']}; real {real['flops']}, "
             f"{real['bytes']}, {real['kernels']}")
    # the real tensors took the kernels: each launched as often as counted
    if launched != {k: v["count"] for k, v in real["kernels"].items()}:
        fail(f"dry run: the real step's kernel launches {launched} are not "
             f"the counted ones {real['kernels']}")
    peak = dry["memory"]["per_device_peak_bytes"]
    measured = md["sharded"]["peak_gib"] * 2**30
    gap = peak / measured - 1.0
    out["peak"] = {"dry_bytes": peak, "measured_bytes": measured, "gap": gap}
    print(f"dry run: step peak {peak / 2**30:.3f} GiB (PeakTracker on fake "
          f"tensors) against phase 17's sharded steps' "
          f"max_memory_allocated {md['sharded']['peak_gib']:.3f} GiB: "
          f"{gap:+.2%} (bound {DRY_PEAK_RTOL:.0%}); argument bytes "
          f"{dry['memory']['per_device_argument_bytes'] / 2**30:.3f} GiB, "
          f"init peak {dry['memory']['init_peak_bytes'] / 2**30:.3f} GiB "
          f"(measured {md['sharded']['init_peak_gib']:.3f}) [{smi}]",
          flush=True)
    if abs(gap) > DRY_PEAK_RTOL:
        fail(f"dry run: step peak {peak} bytes {gap:+.2%} from the "
             f"measured {measured:.0f}")
    ms = md["sharded"]["step_ms"]
    share = {}
    for name, flops in (("model_flops", dry["roofline"]["model_flops"]),
                        ("counted_flops", cost["flops_per_device"])):
        rate = flops / (ms * 1e-3)
        share[name] = {"flops": flops, "tflops_per_s": rate / 1e12,
                       "share_of_989": rate / BF16_TOPS_PER_S}
        print(f"dry run: {name} {flops:.6e} a step over phase 17's "
              f"{ms:.3f} ms a step (sharded, measured): "
              f"{rate / 1e12:.2f} TFLOP/s, {rate / BF16_TOPS_PER_S:.2%} of "
              f"989 TFLOP/s [{smi}]", flush=True)
    out["share_of_peak"] = share

    t1 = time.perf_counter()
    rc, text = cell.wait(timeout=max(60.0, 900.0 - (t1 - cell.t0)))
    waited = time.perf_counter() - t1
    for line in text.strip().splitlines()[:2]:
        print(f"  | {line}", flush=True)
    if rc != 0:
        print(text[-3000:], flush=True)
        fail(f"dry run: {' '.join(cell.cmd[2:])} returned {rc}")
    path = (ROOT / "artifacts" / "dryrun_torch" / "pod16x16"
            / f"{cell.arch}__{cell.shape}.json")
    rec = json.loads(path.read_text())
    data = rec["data"]
    mem, rf = data["memory"], data["roofline"]
    out["cell"] = {"seconds": rec["seconds"], "waited_s": waited,
                   "memory": mem, "roofline": rf}
    print(f"dry run: {cell.arch} x {cell.shape} on the (16, 16) mesh through "
          f"the entry point (rc {rc}, its step {rec['seconds']:.0f} s of "
          f"host time beside the phases, {waited:.1f} s waited here): "
          f"per-rank step peak {mem['per_device_peak_bytes'] / 2**30:.2f} "
          f"GiB, init peak {mem['init_peak_bytes'] / 2**30:.2f} GiB, "
          f"fits_hbm {mem['fits_hbm']} (at init {mem['fits_hbm_at_init']}); "
          f"roofline (H100 data-sheet arithmetic, not measured): compute "
          f"{rf['compute_s'] * 1e3:.1f} ms, memory "
          f"{rf['memory_s'] * 1e3:.1f} ms, collectives "
          f"{rf['collective_s'] * 1e3:.1f} ms -> {rf['bottleneck']}, useful "
          f"flops {rf['useful_flops_fraction']:.3f}", flush=True)
    if not rec["ok"]:
        fail(f"dry run: {cell.arch} x {cell.shape} not ok: {rec['reason']}")
    out["seconds"] = time.perf_counter() - t0
    print(f"dry run: phase wall time {out['seconds']:.1f} s ({waited:.1f} s "
          f"of it waiting for the production cell)", flush=True)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    cell = _BackgroundCell(*DRY_CELL)
    try:
        return _phases(dev, smi, cell)
    finally:
        cell.stop()


def _phases(dev, smi: str, cell: _BackgroundCell) -> int:
    """Phases 2-18 and the kernel report; ``cell`` is phase 18's
    production cell, running since the script started."""
    from repro_torch.kernels import _build
    t_script = time.perf_counter()
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(_build.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    checked, mappings = phase_kernels_vs_plain(dev)
    print(f"kernels vs plain: {checked} comparisons ok in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    cand_checks = phase_candidates_vs_plain(dev)
    print(f"candidate kernels vs plain: {cand_checks['bucket_topm']} bucket_topm "
          f"and {cand_checks['mach_candidate_topk']} mach_candidate_topk "
          f"comparisons ok ({cand_checks['backfill_rows']} backfill rows), max "
          f"abs err {cand_checks['max_abs_err']:.3e}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    rows, odp = phase_main_path(dev)
    print(f"main path: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    for row in rows:
        row["checks_by_mapping"] = mappings[row["name"]]
    t0 = time.perf_counter()
    rows += phase_candidate_main_path(dev, odp, cand_checks)
    print(f"candidate main path: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del odp

    t0 = time.perf_counter()
    checks = phase_xent_vs_plain(dev)
    print(f"fused xent vs plain: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    rows += phase_training(dev, checks)
    print(f"training: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    dense_launches = next(row["launches"] for row in rows
                          if row["name"] == "mach_fused_xent_dense")
    t0 = time.perf_counter()
    rows.append(phase_dense_lm_head(dev, checks, dense_launches, smi))
    print(f"dense LM head: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    lm_checks = phase_lm_kernels_vs_plain(dev)
    print(f"LM kernels vs plain: {lm_checks['cases']} comparisons ok "
          f"(and {lm_checks['head_cases']} of the LM head's decode) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    lm_rows, lm = phase_lm_serve(dev, lm_checks)
    print(f"lm serve: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    for row in rows:
        if row["name"] in ("mach_decode", "mach_topk"):
            row["launches_lm_serve"] = lm["launches_engine"][row["name"]]
            row["launches_lm_direct_greedy_loop"] = \
                lm["launches_direct_loop"][row["name"]]
            row["max_abs_err_lm_head"] = max(lm_checks["errs"]["lm_head"],
                                             lm["head_err"])
            row["lm_head"] = lm_checks["lm_head_top1" if row["name"] ==
                                       "mach_decode" else "lm_head_topk"]
        if row["name"] in ("bucket_topm", "mach_candidate_topk"):
            row["launches_lm_serve_exact"] = \
                lm["candidates"]["exact_launches"][row["name"]]
            row["launches_lm_serve_approx"] = \
                lm["candidates"]["approx_launches"][row["name"]]
    rows += lm_rows

    t0 = time.perf_counter()
    train_checks = phase_lm_train_kernels_vs_plain(dev)
    print(f"LM training kernels vs plain: {train_checks['cases']} comparisons "
          f"ok in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    train_rows, train = phase_lm_train(dev, train_checks)
    print(f"lm train: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    for row in rows:
        if row["name"] in ("lru_scan", "flash_attention"):
            row["launches_lm_train"] = train["launches"][row["name"]]
    rows += train_rows

    t0 = time.perf_counter()
    fused = phase_lm_train_fused(dev, train)
    print(f"lm train fused: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    selection = phase_selection(dev)
    print(f"selection: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_oaa(dev, train)
    print(f"oaa: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    _add_new_path_launches(rows, fused, selection)
    t0 = time.perf_counter()
    dense = phase_dense_serve(dev)
    print(f"dense serve: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    _add_dense_launches(rows, dense)
    t0 = time.perf_counter()
    moe = phase_moe(dev)
    print(f"moe: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    _add_moe_launches(rows, moe)
    t0 = time.perf_counter()
    other = phase_other_archs(dev)
    print(f"other archs: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    _add_other_launches(rows, other, lm_checks["flash_new"])
    t0 = time.perf_counter()
    ckpt = phase_checkpoint(dev)
    print(f"checkpoint: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    _add_checkpoint_launches(rows, ckpt)
    t0 = time.perf_counter()
    md = phase_multidevice(dev)
    print(f"multidevice: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    _add_multidevice_launches(rows, md)
    t0 = time.perf_counter()
    phase_dry_run(dev, md, cell)
    print(f"dry run: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"all phases: {time.perf_counter() - t_script:.1f} s, the build "
          f"included", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
