#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line per result:

1. card: name and power limit (``nvidia-smi``); builds every CUDA source
   of the port with ``nvcc`` (one process per source, all at once) and
   prints the build time, each source's registers and spills, and each
   tensor-core kernel's registers, spills and dynamic shared memory;
2. kernels against their plain PyTorch versions: the paged-attention
   kernels at the serving path's shapes (llama_1b MHA and a GQA case;
   bf16, fp32 and int8 pools; decode with contexts of 1, kSplit,
   kSplit + 1 and the whole table, each request decoded alone equal to
   its row of the batch (tolerance 0); multi-query with T in {1, 16,
   512}, q_start > 0 and padding rows, T = 1 equal to decode; and at the
   speculative verify's shape, B 8, T 4, q_start 430-1536, over bf16 and
   int8 pools); the flash-attention forward, dq
   and dkv kernels, without rope and in their rope form (pre-rotary q and
   k, the llama tables), at the training shape (B 16, H 12, S 1024, D 64,
   bf16, causal), at llama_1b's heads (D 128, S 2048), in bf16 at D 32
   (with D 64 and 128 above: the bf16 tensor-core bodies of all three
   kernels at every head dim), in fp32 at D 32, 64 and 128 (the CUDA-core
   bodies),
   non-causal, at BERT-base's shape (B 128, H 12, S 128, D 64, bf16,
   non-causal), at a ragged S = 1000, and GQA 32/8 through the autograd
   Function; the MoE expert FFN at the Llama-MoE shape (E 8,
   C 5120, h 768, I 2048) in bf16 and fp32 and at ragged small shapes in
   both dtypes (bf16: the tensor-core body, fp32: the CUDA-core body); the
   fused add + RMSNorm and the fused add + LayerNorm at 16384 x 768 in bf16
   and fp32 and at ragged shapes (the residual bit for bit);
3. times (CUDA events, median after warm-up) of each kernel, its plain
   version and the PyTorch library call computing the same function,
   beside the least time the card could take, with the achieved TFLOP/s
   (and, for the MoE kernel, the bytes its design reads through L2); the
   decode kernel also over an int8 pool, each decode line naming its
   body; the multi-query kernel also at the verify's shape;
4. serving end to end: ``LLMEngine`` serves llama_1b (bf16, random weights
   from a seed) to 8 greedy requests of 16 new tokens, per step (host
   sampling) and then with decode windows of 8
   (``decode_steps_per_sync=8``: one CUDA graph replay a window) on the
   same model; the paged kernels' launch counts
   over each run must equal layers x decode iterations (through graph
   replays for the windows) and layers x prefill chunks, and in a
   profiled repeat the kernels' device tally; the window's
   tokens must equal the per-step run's, with one host sync a window;
   tokens/s, ITL p50, busy time and idle share of both; then per step
   with synchronous staging, in turns with the default ingest thread
   (identical tokens); then speculative with 3 drafts: a self-draft with
   the fused catch-up (graph replays) and without (identical tokens and
   accept ratio, the ratio at least 0.5) and a random llama_125m draft,
   whose launches must be target layers x (chunks + verify steps) + draft
   layers x chunks (#2) and draft layers x draft decode iterations (#1),
   equal to the device tally in a profiled repeat; the share of
   requests equal to the per-step run's is reported; then ``generate``
   on 8 x 512 prompts (ms a step, agreement with the engine reported);
5. training end to end (every fused step a captured CUDA graph after its
   first, eager call): ``fused_train_step`` with AdamW(1e-4) trains
   llama_125m (bf16, random weights from a seed) on one fixed 16 x 1024
   batch, 2 warm-up and 10 timed steps through ``FusedTrainStep.drive``;
   the loss must be finite and fall, and each flash kernel must launch
   exactly layers x steps times; tokens/s, ms/step, MFU, peak memory and
   one profiled step; the same again with ``PT_ATTN_EINSUM`` set for
   that run only (the head-major attention block), with ms/step and the
   copy kernels' share beside the default run's; then the same for the
   Llama-MoE of
   scripts/bench_moe_ffn.py (8 layers, 8 experts, top-2, MoE every 2nd
   layer) with ``PT_FUSED_MOE``, ``PT_FUSED_NORM`` and ``PT_FUSED_ROPE``
   set for that run only: the MoE kernel launches MoE layers x steps
   times, the fused norm and each rope flash kernel layers x steps, the
   flash kernels without rope never; then BERT-base sequence-
   classification fine-tuning as ``bench.py bert`` sets it up (bf16, both
   dropouts 0, AdamW(2e-5), 128 x 128 random ids and labels) with
   ``PT_FUSED_NORM`` set for that run only: the fused add + LayerNorm
   launches 2 x layers x steps times, each flash kernel without rope
   layers x steps, every other kernel never; and again with BERT's
   default 0.1 dropouts in training mode (attention takes the plain dense
   route with its keep mask: the flash kernels never launch, the fused
   add + LayerNorm 2 x layers x steps; the loss finite); then training
   recipes, each from a fresh model: llama_125m on the same batch under
   AdamW with a warmup + cosine schedule, no decay on norms and
   embeddings and a global-norm clip; Momentum(0.9) with an L2Decay
   regularizer; and SGD; and BERT-base under AdamW with a warmup + linear
   decay, a layer-wise ``lr_ratio`` and no decay on biases and LayerNorms:
   losses finite (falling on llama), exact launches, one host sync a
   window, ``get_lr()`` after each step equal to the schedule computed on
   the host, ms/step beside the float-LR AdamW runs;
6. card against CPU: the port engine on fp32 llama_tiny gives identical
   greedy tokens on the CPU (plain versions) and on the card (kernels),
   per step and in decode windows (graph replays on the card), and the
   window equals the per-step path over an int8 pool on the card; so do
   the speculative engines (a self-draft and a 1-layer draft, fused and
   unfused catch-up, equal to the plain engine too) and ``generate``
   (tokens; ``cached_step`` logits within ATOL);
   three fused AdamW steps on fp32 llama_tiny give the same losses and
   parameters on both, with and without ``PT_ATTN_EINSUM``; and so do
   three on fp32 llama_tiny with 4 experts
   and the three switches, after the first batch's top-k routing is found
   identical on both; three on fp32 bert_tiny with ``PT_FUSED_NORM``, and
   one padded (masked) ``BertModel`` forward; the training recipes at
   tiny size (the three Llama ones on llama_tiny, BERT's on bert_tiny) and
   each of the 11 eager optimizers on llama_tiny, three steps each;
   attention dropout's keep rate, scaling and seeding on the card;
7. the fused step as captured CUDA graphs: llama_125m, BERT-base and the
   Llama-MoE as in phase 5, 2 + 10 steps through the graph and through
   the private eager step body, interleaved graph, eager, graph, eager,
   each from the seed weights: ms/step on the host clock and on CUDA
   events, busy time and idle share of one profiled step, peak memory,
   losses equal within 1e-2, exact launches, one compile a graph run;
   then fp32 llama_tiny graphs on the card against the CPU over 12 steps
   of phase 5d's AdamW recipe: as it is, under
   ``FLAGS_check_nan_inf_action=skip`` with a NaN batch (the skipped step
   leaves parameters and moments bit for bit), under
   ``GradScaler(init_loss_scaling=2**126)`` (the same scales) and with
   ``shape_buckets=[64, 128, 256]`` over 12 lengths (3 compiles);
8. DeepFM on the row-sparse route: ``deepfm_criteo`` (vocab 1,000,001,
   dim 9, 26 fields, 13 dense, MLP 512/256/128, fp32) on one fixed
   16384-example batch, 2 + 10 steps through ``drive`` under
   ``Adam(1e-3, lazy_mode=True)`` (captured lookups, segment sum and the
   lazy row update inside the graph) and under ``lazy_mode=False``,
   interleaved lazy, dense, lazy, dense from the seed weights: losses
   finite and falling, the same first loss, the touched rows within 1e-6
   across arms after step 1, the lazy arm's untouched rows and moments
   bit for bit after 12, one compile and 11 hits; examples/s, ms/step
   (host and CUDA events), peak memory, one profiled step; then a tiny
   fp32 DeepFM (padding row, repeated ids) on the card against the CPU:
   three lazy steps, under ``skip`` with a NaN batch (tables and moments
   bit for bit across it), with a global-norm clip; the eager lazy Adam
   on a ``SparseEmbedding``; a table read outside its lookup (warns,
   trains dense on both);
9. the supervised loop (``drive``) on llama_125m's width at 4 layers
   (``SUP_LAYERS``): prefetch, checkpoints, resume, rollback,
   preemption, the stall guard; then (9g) fp32
   llama_tiny on the card against the CPU at AdamW lr 1e-4 and 1e-3,
   each beside each device's rounding floor (its run from weights
   perturbed by 1e-7), the card-vs-CPU parameter difference within 2x
   the larger floor (and within 1e-5 at lr 1e-4);
10. serving artifacts on llama_1b's width at 8 layers
   (``SERVE_CUT_LAYERS``; 22 in phase 4), phase 4's eight prompts
   zero-padded to 1536, windows of 8, artifacts in ``TMPDIR``: (a) a bf16 artifact
   saved and served by ``create_predictor`` under
   ``set_default_dtype("bfloat16")``, tokens equal an engine over the
   in-memory model bit for bit, #1/#2 launches equal to the device tally;
   (b) ``reload_weights`` from the artifact and from a
   ``CheckpointManager`` after poisoning the embedding: tokens restored
   bit for bit, every ``data_ptr()`` kept, the captured window graph the
   same and still replaying; (c) an fp32 model saved with
   ``quantize="int8"`` (sampled codes equal to numpy's), served over an
   int8 KV pool: llama_tiny's first-token logits within the reference's
   0.08 of its fp32 model's, llama_1b's error and token agreement
   reported, the loaded llama_1b artifact's logits on the card equal to
   the CPU's plain forward of the same file within 1e-4, a reload bit for
   bit; (d) PTQ on llama_125m
   fp32: the converted logits equal the fake-quant simulation's within
   2e-4 and its int8 codes the CPU's bit for bit;
11. KV pages that leave and re-enter the pool, llama_1b bf16 (8 layers)
   with phase 4's prompts, windows of 8, 32 new tokens: (a) a ``prefill_only``
   engine prefills each prompt, its pages are exported, packed, unpacked
   and imported by a second engine that decodes them: tokens equal a
   colocated engine's bit for bit, the prefill engine builds no window
   and launches no #1, the decode engine launches no #2, each equal to
   the device tally; page bytes, export/pack/unpack/import ms and
   GB/s, tokens/s and decode-side TTFT; (a') the same on int8 pools
   (bytes ~0.52 of bf16's); (b) the host tier on a pool that holds the
   eight prompts but not their growth: spills revived by import, no
   miss, tokens equal the never-evicting run's, beside the same pool
   re-prefilling; (c) the prefix store: a cold engine saves it on
   ``close`` (``TMPDIR``), a new engine boots from it, revives the
   chains (every revived block equal to its stored payload) and runs
   fewer #2 launches; fp32 llama_tiny warm tokens card = CPU;
12. deadlines, tenants and QoS tiers, and serving integrity, llama_1b
   bf16 (8 layers) with phase 4's prompts, windows of 8, four slots, the host tier:
   (a) four "bronze" batch-tier requests decoding when four "gold"
   latency-tier ones arrive (weights 1:3), against the same engine
   arguments under FIFO: tokens bit for bit, yields = spills = revives
   with no miss, TTFT p50 by tier, tenant tokens, the gold:bronze ratio
   while both wait, tokens/s, one window graph, #1/#2 launches equal to
   the device tally; a quota arm (bronze throttled, nothing shed); (b) two
   of four running requests with deadlines expiring mid-decode: streams
   end in (-1, "timeout"), blocks back, the freed slot admits a waiting
   request whose tokens equal its batch-of-one run, the abort's lag
   against a window, ``generate`` with a passed deadline raising with the
   allocator untouched; (c) (a) with ``kv_page_checksums``: verified =
   spilled blocks, none rejected, same tokens, seal and verify ms and
   GB/s; a flipped host-tier entry rejected and re-prefilled; a sealed
   handoff verified, a flipped one refused before any block moves; the
   weight audit (ms; a weight flip in place fails it; ``reload_weights``
   from a bf16 artifact re-anchors it with the tokens of before and no
   recapture); a pool page flipped in place under a decoding request
   (no CRC sees it; whether its tokens changed is reported); (d) fp32
   llama_tiny with tenants, tiers, a quota, a deadline and a flipped
   spill: the card's admission order, tokens and tenant tokens equal the
   CPU's;
13. the serving fleet (``inference.serving.fleet``), llama_1b bf16 (8
   layers) from a bf16 artifact in ``TMPDIR``, phase 4's prompts and phase 10's engine
   arguments in every replica process (the kernels built in this process
   first, so each replica only loads them): (a) two colocated replicas:
   tokens equal one in-process engine's bit for bit, each replica's
   spawn-to-ready s, TTFT p50 and tokens/s against the in-process
   engine, each replica's #1/#2 launches (from its ``stats`` event, since
   its ``ready``) equal to layers x its decode iterations and chunks;
   (d) on the same fleet, ``drain(0, then="reload")`` mid-burst from a
   ``CheckpointManager`` in ``TMPDIR``: nothing dropped, no typed error,
   the reloaded step, tokens unchanged, the drain's wall; (b)
   ``serve.replica_crash`` on replica 0 after its first windows:
   death-to-detection ms, respawn-to-ready s, restarts, redispatches, the
   liveness gauge's dip and recovery, every request complete with its
   pre-kill tokens unchanged, the agreement after the kill; (c) a
   ``["prefill", "decode"]`` fleet serving the four shortest prompts:
   tokens equal (a)'s, page bytes,
   frames and GB/s on each pipe hop, no #1 on the prefill replica and no
   #2 on the decode replica; (e) fp32 llama_tiny: a colocated fleet on
   the card and a drill fleet of three (a crash, a hang under
   ``hang_timeout_s``) equal a CPU fleet of the port bit for bit, with the
   hang's escalation times;
14. sharding plans, llama_1b bf16 (8 layers) from a bf16 artifact in
   ``TMPDIR``, phase 4's prompts and phase 10's engine arguments per step (a
   multi-process plan's collectives cannot be captured in a window
   graph): #1 and #2 at a tensor-parallel rank's shape (8 query and 8
   KV heads) against their plain versions; (a) a tp=2 group of two
   ``--tp-child`` processes on the one card, joined over gloo by
   ``init_parallel_env``, each serving ``LLMEngine(plan=Plan.build(
   {"tp": 2}, ["tp"]))``: both ranks' tokens equal, their agreement with
   the single-process engine, each rank's #1/#2 launches = layers x its
   decode iterations and chunks = the kernels' device tally, tokens/s,
   TTFT p50 and the host time blocked in ``all_reduce`` over the wall,
   decode windows refused with ``PlanError``; (b) two fleets whose slot
   is a tp=2 group, booted together: one bit for bit (a)'s, drained and
   retired (every member ended), the other with rank 1 SIGKILLing itself
   mid-burst: the group felled and respawned on a fresh port, the
   tokens before the kill (a)'s, every replay equal to its replay prompt
   served afresh; (c) fp32 llama_tiny tp=2 tokens card = CPU; (d) a
   stale ``plan.json`` refused with ``PlanMismatchError``, the weights
   untouched;
15. ``bench.py bert_varlen``'s bucketed stream on the port
   (``scripts/bench_bucketing.py``'s harness, ported as ``varlen_*``):
   #3, #4 and #5 at BERT-base's heads (bf16, non-causal, B 32, H 12, D
   64) against their plain versions at S 72 and 232; then the three arms
   of ``run_stream`` (naive exact-length padding, the
   ``BucketedBatchSampler`` + ``PadToBucket`` pipeline, ``shape_buckets``
   inside the step), each from a fresh BERT-base (bf16, both dropouts 0,
   ``PT_FUSED_NORM``, AdamW(2e-5), loss ``o[0]``) over 2 epochs of 20
   batches of 32 drawn from 10 lengths in [72, 232) into buckets [96,
   160, 232]: tokens/s on real tokens, wall with the captures, captures
   and hits, pad waste, the bucket histogram, the last loss; naive's
   captures equal its distinct batch shapes, pipeline's and jit's at most
   3, every loss finite, each flash kernel launched 12 x steps and #8 24
   x steps; then fp32 bert_tiny (its sizing) through the three arms on
   the card and on the CPU: the same batches and capture counts, losses
   within ``TRAIN_LOSS_RTOL``;
16. the launcher (``python -m paddle_tpu_torch.distributed.launch
   --nproc_per_node 2 --devices 0 --max_restart 2``) over ``chip_smoke.py
   --launch-child``: two ranks of phase 9's llama_125m run share the card
   as independent replicas (no process group, a checkpoint directory a
   rank, a committed checkpoint every second window), in three jobs:
   kill (rank 1 SIGKILLs itself after its first committed window: the
   group felled and restarted under the budget), preempt (every rank
   SIGTERMs itself at its first window boundary and exits 123 with a
   checkpoint: relaunched with the budget untouched) and hang (rank 1
   stalls with the stall guard off: the heartbeat watchdog, its timeout
   twice the kill job's first incarnation's largest heartbeat gap,
   condemns the group): each ends in exit 0 with both ranks' losses,
   keyed by global step, bit for bit 9c's uninterrupted run and no
   re-trained step's loss different; kill and hang charge one restart,
   preempt none; the liveness log dips and recovers; each rank's flash
   launches in its last incarnation are 12 x the steps it trained; the
   detection time (from the death, or from the last heartbeat, to the
   launcher's kill) and relaunch to resume; then a crash loop whose
   workers always exit 3 (``--max_restart 1``, no torch, no card) ends
   the launcher with exit 3;
17. the high-level API (``paddle_tpu_torch.Model``): (a) BERT-base sequence
   classification as ``bench.py bert`` sets it up (128 x 128, both dropouts
   0, fp32 weights), ``Model(net).prepare(AdamW(2e-5),
   nn.CrossEntropyLoss(), metric.Accuracy(), amp_configs={"level":
   "O1"}).fit(...)`` with ``PT_FUSED_NORM`` over 20 seeded batches (each
   row's first token names its label), then one eval of 4 batches: ms/step
   on the host clock after 3 warm-up steps, tokens/s, peak memory, the
   first and last losses, accuracy and eval_loss; every loss finite and the
   last quarter's mean below the first quarter's; #3 launched layers x
   (steps + eval batches), #4 and #5 layers x steps, #8 2 x layers x (steps
   + eval batches), nothing else; q reaching the flash wrappers as bf16 in
   training (the tensor-core bodies) and fp32 in the eval (``eval_batch``
   runs outside ``auto_cast``, as the reference's); (d) ``flops`` of
   BERT-base on a [1, 128] input equal to the Linear + LayerNorm count by
   hand;
   (b) ``amp.decorate(net, level="O2")`` on a fresh BERT-base: the
   parameters bf16 but the LayerNorms' (fp32), 3 steps under O2, losses
   finite, exact launches; (c) fp32 bert_tiny through ``Model.fit`` on the
   card and on the CPU, the same batches with ``shuffle=False``: losses
   within ``TRAIN_LOSS_RTOL``, accuracies equal; ``Model.save`` on the card
   and ``Model.load`` into a CPU ``Model``: ``evaluate`` gives the same
   eval_loss and accuracy;
18. ``jit`` (``to_static`` on ``torch.compile``, the kernels as
   ``torch.library`` ops, ``jit.save``/``jit.load`` on ``torch.export``,
   the predictor): (a) BERT-base's width at ``JIT_TRAIN_LAYERS`` (4) of
   its 12 layers (fp32 weights, hidden dropout 0.1, attention dropout 0,
   ``PT_FUSED_NORM``) through ``jit.to_static``
   under AMP O1 with AdamW(2e-5), 20 seeded 128 x 128 batches (phase 17's
   label token): the first step's wall (the compile), ms/step and
   tokens/s on the host clock after 3 warm-up steps, peak memory, the
   losses; the same for 10 eager steps from the same weights on the same
   batches; losses finite and falling, one compile and 19 hits, no eager
   fallback, no Dynamo graph break, q reaching every flash launch as bf16,
   #3, #4 and #5 layers x steps and #8 2 x layers x steps, nothing else;
   (b) a 1-layer BERT-base-width model, compiled against eager on the same
   weights and one batch with dropout off: eval logits within 1e-4, one
   fp32 training step's loss within ``TRAIN_LOSS_RTOL`` and each gradient
   within 1e-3 of its largest magnitude (plus 1e-6 of the model's); (c)
   ``jit.save`` of BERT-base with ``InputSpec([None, 128], "int64",
   "input_ids")`` and ``create_predictor(Config(path))`` at batches 1, 8
   and 32: logits within 1e-4 of eager's, #3 layers and #8 2 x layers a
   run; two ``clone()``s on two threads equal to the predictor; save, load
   and a batch of 32's ms; ``convert_to_mixed_precision(..., "bfloat16")``:
   the stored weights half the bytes, logits within 1e-4 of eager on the
   bf16-rounded weights; (d) ``torch.library.opcheck`` of every registered
   op (#3-#9) on the card;
19. the cost ledger and the profiler: (a) llama_125m's step as phase 5
   trains it (bf16, AdamW(1e-4), 16 x 1024) through ``hlo_cost_report``
   and ``lowered_flops`` (fake-mode traces: no launch, no
   ``jit.cache_stats`` entry, no gradient, the card's RNG state bit for
   bit; the attention on the card's route): 12 nodes each of #3-#5 and no
   other kernel node, each costing phase 3's ops and bytes (the ops'
   formulas, ``kernel_cost``), the top 10 ops by bytes, the FLOPs a token
   beside the hand formula's; then one replayed step under
   ``profiler.Profiler(targets=[CPU, GPU], scheduler=(1, 2))``: 12
   launches of each flash kernel, the three ``flash_*_tc_kernel`` names in
   the device trace's chrome file and the profiler's summary, the
   window's ``RecordEvent`` span in the exported host trace,
   ``step_info``'s tokens/s, the profiler's kernel count printed; (b)
   the Llama-MoE's ledger under the three fused switches (4 #9, 8 #7 and
   8 of each rope op, each at phase 3's cost) and BERT-base's under
   ``PT_FUSED_NORM`` (24 #8 at phase 3's cost, 12 of each flash op,
   non-causal); (c) DeepFM criteo's dense and lazy steps:
   ``vocab_sized_ops`` of the top 10 non-empty dense, empty lazy; (d) a
   ``to_static`` compile's ``jit::compile::<name>`` span in a CPU-target
   profile; (e) ``device.memory_stats`` against ``torch.cuda``'s figures,
   and a product on a ``device.Stream`` under ``stream_guard``, ordered
   by a ``device.Event``, equal to the default stream's;
20. serving the Llama-MoE (phase 5b's configuration: llama_125m's width,
   8 layers, 8 experts, top-2, MoE every 2nd layer; bf16, seeded weights,
   ``PT_FUSED_MOE=1``) through ``LLMEngine`` (1024 blocks of 16, batch 8,
   512-token prefill chunks): 8 greedy requests of 96-880 tokens + 16,
   (a) per step and (b) in decode windows of 8 (one graph replay a
   window): tokens/s, TTFT and ITL p50, a profiled repeat's idle share;
   #1, #2 and #9 equal to their device tallies and to layers x decode
   iterations, layers x chunks and MoE layers x (chunks + iterations);
   (b)'s tokens against (a)'s reported (capacity is shared across the
   batch at factor 1.25, and the schedules differ); (c) at capacity
   factor 4.0 (nothing drops; whole-prompt chunks): windows = per step
   bit for bit, the longest and the shortest prompt served alone = in
   the batch; (d) fp32 llama_tiny with 4 experts at 1.25 on one schedule:
   card = CPU per step and in windows, and on the card #9's fp32 body
   against ``PT_FUSED_MOE=0`` (tokens equal, logits within 1e-4); (e) #9
   against its plain version at E 8, C 3 and C 160 in both bodies, and
   its bf16 times there (kernel, plain, three ``torch.bmm``, the bound).

The five launch cross-checks of phases 4, 10a, 11a and 12a hold the
wrappers' counts to the counts the paged kernels keep on the device
(``device_tally``), not to the profiler's (printed beside them); phase
20's hold #1, #2 and #9 to theirs (``paged_attention.device_tally`` and
``moe_ffn.device_tally``).

Then one JSON line with every kernel's numbers (``launches`` from the
run named in the phase that returns them; #1 and #2 also
``launches_phase10``, the count of each of 10a's and 10c's predictor
runs, ``launches_phase11``, each of phase 11's counted runs,
``launches_phase12``, phase 12's QoS, FIFO and checksummed runs, and
``launches_phase13``, phase 13's replicas: (a)'s two summed, (c)'s
prefill and decode replica, and ``launches_phase14``, phase 14a's two
ranks; #3, #4, #5 and #8 ``launches_phase15``, each of phase 15's arms;
#3, #4 and #5 ``launches_phase16``, each phase 16 job's ranks in their
last incarnation; #3, #4, #5 and #8 ``launches_phase17``, phase 17's O1
fit and O2 steps, and ``launches_phase18``, phase 18a's compiled run and
18c's three predictor runs; #3, #4 and #5 ``launches_phase19``, phase
19a's profiled step; #1, #2 and #9 ``launches_phase20``, phase 20a's and
20b's counted runs, and #9 ``serving_shapes``, phase 20e's times at C 3
and C 160), the card line, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without CUDA it exits 1.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, 700 W
# kernel vs plain version (evaluated in fp32 on the same, exactly upcast,
# values): |got - want| <= ATOL + RTOL[q dtype] * |want|. ATOL covers fp32
# summation order; RTOL is the kernel's final rounding of its fp32 result
# to the output dtype (half an ulp: 2^-8 relative for bf16, exact in fp32).
ATOL = 1e-4
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
# flash-attention lse (fp32 on both sides): summation order only
LSE_ATOL = 1e-4
# flash-attention gradients: RTOL[dtype]*|want| (the output rounding) plus
# GRAD_FRAC * max|want|: fp32 sums of terms of both signs in another order,
# whose cancellation makes an error relative to the element meaningless
GRAD_FRAC = 1e-4
SEED = 0
# card vs CPU training on fp32 llama_tiny: losses rtol, parameters atol
# after three AdamW(lr 1e-3, epsilon 1e-6) steps -- cuBLAS and the CPU
# sum in other orders; epsilon 1e-6 keeps a gradient near zero from
# flipping its update (tests/test_torch_training.py makes the same choice)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_ATOL = 1e-5


def say(*parts):
    print(*parts, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms():
    """The rate of ``torch.cuda._sleep``, measured once with CUDA events."""
    import torch

    cycles = 10_000_000
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / a.elapsed_time(b)


def time_ms(fn, warmup=3, iters=20):
    """Median device time of one call of ``fn``, after ``warmup`` calls,
    between two CUDA events. Each timed call is queued behind a device-side
    sleep twice as long as the host takes to issue it (at most 50 ms), so
    the start event fires when the call's work is already queued: without
    it a kernel shorter than the host's launch overhead would be timed at
    that overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(min(2 * issue_ms, 50.0) * sleep_cycles_per_ms())
    events = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)



def reset_peak_memory():
    """Collect cyclic garbage and free the cache before resetting the
    peak, so a phase's peak memory is its own: objects of a finished phase
    caught in a reference cycle (an engine and its graph steps refer to
    each other) keep their memory until a collection."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

class Case:
    """Random paged-attention inputs on the card: pools [N, bs, Hkv, D]
    (N = B*P + 1, block 0 left as the null block), a random permutation
    of the other blocks as block tables, ragged context lengths."""

    def __init__(self, gen, *, B, H, Hkv, D, bs, P, q_dtype, kv, lens,
                 T=None, starts=None):
        import torch

        dev = "cuda"
        n = B * P + 1
        shape = (n, bs, Hkv, D)
        self.kv = kv
        if kv == "int8":
            self.k = torch.randint(-127, 128, shape, generator=gen,
                                   device=dev).to(torch.int8)
            self.v = torch.randint(-127, 128, shape, generator=gen,
                                   device=dev).to(torch.int8)
            self.ks = torch.rand(shape[:-1], generator=gen, device=dev) \
                * 0.02 + 1e-3
            self.vs = torch.rand(shape[:-1], generator=gen, device=dev) \
                * 0.02 + 1e-3
        else:
            dt = getattr(torch, kv)
            self.k = torch.randn(shape, generator=gen, device=dev).to(dt)
            self.v = torch.randn(shape, generator=gen, device=dev).to(dt)
            self.ks = self.vs = None
        perm = torch.randperm(n - 1, generator=gen, device=dev) + 1
        self.tables = perm[:B * P].view(B, P).to(torch.int32).contiguous()
        self.lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        qshape = (B, H, D) if T is None else (B, T, H, D)
        self.q = torch.randn(qshape, generator=gen, device=dev).to(
            getattr(torch, q_dtype))
        self.starts = (None if starts is None else
                       torch.tensor(starts, dtype=torch.int32, device=dev))
        self.scale = D ** -0.5
        self.H, self.Hkv, self.D, self.T = H, Hkv, D, T

    def pools(self, upcast=False):
        """(k, v, k_scale, v_scale); ``upcast`` gives float pools as fp32
        (exact for bf16) for the plain version's fp32 reference."""
        if upcast and self.kv != "int8":
            return self.k.float(), self.v.float(), None, None
        return self.k, self.v, self.ks, self.vs

    def kv_bytes(self, tokens):
        """Bytes of K and V rows (plus int8 scales) for ``tokens`` rows
        per kv head."""
        row = self.D * self.k.element_size() + (4 if self.kv == "int8"
                                                else 0)
        return 2 * tokens * self.Hkv * row


def decode_kernel(c):
    from paddle_tpu_torch.ops.cuda.paged_attention import (
        paged_decode_attention_cuda)

    k, v, ks, vs = c.pools()
    return paged_decode_attention_cuda(c.q, k, v, c.tables, c.lens, c.scale,
                                       k_scale=ks, v_scale=vs)


def decode_plain(c, upcast=False):
    from paddle_tpu_torch.inference.serving.paged_attention import (
        _torch_fallback)

    k, v, ks, vs = c.pools(upcast)
    q = c.q.float() if upcast else c.q
    return _torch_fallback(q[:, None], k, v, c.tables, c.lens, c.scale,
                           k_scale=ks, v_scale=vs)[:, 0]


def one_request(c, b):
    """Case ``c`` cut to its request ``b`` alone (same pools)."""
    import copy

    one = copy.copy(c)
    one.q, one.tables, one.lens = (t[b:b + 1].contiguous()
                                   for t in (c.q, c.tables, c.lens))
    if c.starts is not None:
        one.starts = c.starts[b:b + 1].contiguous()
    return one


def mq_kernel(c):
    from paddle_tpu_torch.ops.cuda.paged_attention import (
        paged_multiquery_attention_cuda)

    k, v, ks, vs = c.pools()
    return paged_multiquery_attention_cuda(c.q, k, v, c.tables, c.lens,
                                           c.starts, c.scale, k_scale=ks,
                                           v_scale=vs)


def mq_plain(c, upcast=False):
    from paddle_tpu_torch.inference.serving.paged_attention import (
        _torch_multiquery_fallback)

    k, v, ks, vs = c.pools(upcast)
    q = c.q.float() if upcast else c.q
    return _torch_multiquery_fallback(q, k, v, c.tables, c.lens, c.starts,
                                      c.scale, k_scale=ks, v_scale=vs)


def library_call(c):
    """``scaled_dot_product_attention`` on K/V gathered (outside the
    timed call) from the pages, with the same visibility mask."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.inference.serving.paged_attention import _gather_kv

    k, v, ks, vs = c.pools()
    kg = _gather_kv(k, ks, c.tables).to(c.q.dtype)
    vg = _gather_kv(v, vs, c.tables).to(c.q.dtype)
    if c.H != c.Hkv:
        kg = kg.repeat_interleave(c.H // c.Hkv, dim=2)
        vg = vg.repeat_interleave(c.H // c.Hkv, dim=2)
    kt = kg.transpose(1, 2).contiguous()
    vt = vg.transpose(1, 2).contiguous()
    pos = torch.arange(kt.shape[2], device="cuda")
    if c.T is None:
        qt = c.q[:, :, None]
        mask = (pos[None] < c.lens[:, None].long())[:, None, None]
    else:
        qt = c.q.transpose(1, 2).contiguous()
        row = torch.arange(c.T, device="cuda")
        mask = ((pos[None, None] <= c.starts.long()[:, None, None]
                 + row[None, :, None])
                & (pos[None, None] < c.lens.long()[:, None, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  scale=c.scale)


def compare(got, want, q_dtype):
    """(max abs error, max excess over the tolerance) of got vs want."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    excess = diff - (ATOL + RTOL[q_dtype] * want.abs())
    return float(diff.max()), float(excess.max())


def phase_kernels(gen):
    """Phase 2. Returns {kernel: max abs error over every case}."""
    import numpy as np

    from paddle_tpu_torch.ops.cuda.paged_attention import split_tokens

    rng = np.random.RandomState(SEED)
    worst = {"paged_decode_attention": 0.0,
             "paged_multiquery_attention": 0.0}
    B, bs, P, D = 8, 16, 128, 128
    split = split_tokens()
    for H, Hkv in ((16, 16), (32, 8)):
        for q_dtype, kv in (("bfloat16", "bfloat16"), ("float32", "float32"),
                            ("bfloat16", "int8"), ("float32", "int8")):
            tol = f"{ATOL:g} + {RTOL[q_dtype]:g}*|want|"
            lens = rng.randint(1, bs * P + 1, B)
            lens[0], lens[1] = 1, bs * P
            lens[2], lens[3] = split, split + 1   # a span's edge
            c = Case(gen, B=B, H=H, Hkv=Hkv, D=D, bs=bs, P=P,
                     q_dtype=q_dtype, kv=kv, lens=lens)
            got = decode_kernel(c)
            err, excess = compare(got, decode_plain(c, upcast=True), q_dtype)
            say(f"kernel decode H={H} Hkv={Hkv} q={q_dtype} kv={kv}: "
                f"max_abs_err {err:.3e} (tol {tol}; contexts "
                f"{sorted(int(x) for x in lens)}, kSplit {split})")
            check(excess <= 0, f"decode {H}/{Hkv} {q_dtype}/{kv}")
            # each request decoded alone is its row of the batch
            alone = max(float((decode_kernel(one_request(c, b))[0].float()
                               - got[b].float()).abs().max())
                        for b in range(B))
            say(f"kernel decode alone vs batch H={H} q={q_dtype} kv={kv}: "
                f"max_abs_diff {alone:.3e} over {B} requests (tol 0)")
            check(alone == 0.0, "decode alone equals decode in a batch")
            worst["paged_decode_attention"] = max(
                worst["paged_decode_attention"], err)
            # T = 1 multi-query at q_start = ctx - 1 is the decode step
            c1 = Case(gen, B=B, H=H, Hkv=Hkv, D=D, bs=bs, P=P,
                      q_dtype=q_dtype, kv=kv, lens=lens, T=1,
                      starts=lens - 1)
            c1.k, c1.v, c1.ks, c1.vs, c1.tables = c.k, c.v, c.ks, c.vs, \
                c.tables
            c1.q = c.q[:, None].contiguous()
            same = float((mq_kernel(c1)[:, 0].float() - got.float())
                         .abs().max())
            say(f"kernel mq T=1 vs decode H={H} q={q_dtype} kv={kv}: "
                f"max_abs_diff {same:.3e} (tol 0)")
            check(same == 0.0, "mq T=1 equals decode")
            for T in (1, 16, 512):
                valid = rng.randint(1, T + 1, B)
                valid[0] = T
                if T > 1:
                    valid[1] = max(1, T // 3)   # padding rows
                starts = np.array([rng.randint(0, bs * P - T + 1)
                                   for _ in range(B)])
                starts[0] = 0
                ctx = starts + valid
                c = Case(gen, B=B, H=H, Hkv=Hkv, D=D, bs=bs, P=P,
                         q_dtype=q_dtype, kv=kv, lens=ctx, T=T,
                         starts=starts)
                got = mq_kernel(c)
                want = mq_plain(c, upcast=True)
                err = excess = -1.0
                for b in range(B):
                    e, x = compare(got[b, :valid[b]], want[b, :valid[b]],
                                   q_dtype)
                    err, excess = max(err, e), max(excess, x)
                say(f"kernel mq T={T} H={H} Hkv={Hkv} q={q_dtype} kv={kv}: "
                    f"max_abs_err {err:.3e} (tol {tol}, valid rows only)")
                check(excess <= 0, f"mq T={T} {H}/{Hkv} {q_dtype}/{kv}")
                worst["paged_multiquery_attention"] = max(
                    worst["paged_multiquery_attention"], err)
    for kv in ("bfloat16", "int8"):
        c = verify_case(gen, rng, kv)
        err, excess = compare(mq_kernel(c), mq_plain(c, upcast=True),
                              "bfloat16")
        say(f"kernel paged_multiquery verify B={VERIFY_B} T={VERIFY_T} "
            f"H=16 D=128 q=bfloat16 kv={kv}: max_abs_err {err:.3e} (tol "
            f"{ATOL:g} + {RTOL['bfloat16']:g}*|want|; q_start "
            f"{sorted(int(x) for x in c.starts.tolist())})")
        check(excess <= 0, f"mq verify shape, kv={kv}")
        worst["paged_multiquery_attention"] = max(
            worst["paged_multiquery_attention"], err)
    return worst


VERIFY_B, VERIFY_T = 8, 4   # the serving phase's verify: 8 rows, K + 1 = 4


def verify_case(gen, rng, kv):
    """#2 at the speculative verify's shape on llama_1b: 8 requests of
    K + 1 = 4 query rows, each at its own q_start in 430-1536 (the serving
    prompts' span), bf16 q over a bf16 or int8 pool."""
    starts = rng.randint(430, 1537, VERIFY_B)
    starts[0], starts[1] = 430, 1536
    return Case(gen, B=VERIFY_B, H=16, Hkv=16, D=128, bs=16, P=128,
                q_dtype="bfloat16", kv=kv, lens=starts + VERIFY_T,
                T=VERIFY_T, starts=starts)


def phase_times(gen):
    """Phase 3, at the llama_1b serving shapes in bf16: the decode batch
    (B=8, ragged ctx up to 2048) and the longest prompt's prefill chunk
    (T=2048 bucket rows, 1536 real, q_start 0)."""
    import numpy as np

    from paddle_tpu_torch.ops.cuda import paged_attention as K

    rng = np.random.RandomState(SEED + 1)
    H = Hkv = 16
    D, bs, P = 128, 16, 128
    out = {}
    lens = rng.randint(64, bs * P + 1, 8)
    dc = Case(gen, B=8, H=H, Hkv=Hkv, D=D, bs=bs, P=P, q_dtype="bfloat16",
              kv="bfloat16", lens=lens)
    tokens = int(lens.sum())
    ops = 4 * tokens * H * D
    body = (f"{K.multiquery_route(dc.q.dtype, dc.k.dtype, 1, D)} body: "
            f"split-KV, kSplit {K.split_tokens()}, then the combine")
    for name, c in (("paged_decode_attention", dc),
                    ("paged_decode_attention int8",
                     Case(gen, B=8, H=H, Hkv=Hkv, D=D, bs=bs, P=P,
                          q_dtype="bfloat16", kv="int8", lens=lens))):
        byt = c.kv_bytes(tokens) + 2 * c.q.numel() * 2 \
            + 4 * (int(np.ceil(lens / bs).sum()) + 8)
        out[name] = dict(
            ms=time_ms(lambda: decode_kernel(c)),
            plain_ms=time_ms(lambda: decode_plain(c)),
            library_ms=time_ms(library_call(c)), bytes=byt, ops=ops,
            library="sdpa on gathered K/V",
            shape=f"B=8 H={H} D={D} bs={bs} ctx_sum={tokens} bf16 q, "
                  f"{c.kv} pool", note=body)
    T, real = 2048, 1536
    mc = Case(gen, B=1, H=H, Hkv=Hkv, D=D, bs=bs, P=P, q_dtype="bfloat16",
              kv="bfloat16", lens=[real], T=T, starts=[0])
    pairs = real * (real + 1) // 2          # causal pairs of the real rows
    byt = mc.kv_bytes(real) + 2 * real * H * D * 2 \
        + 4 * (-(-real // bs) + 2)
    ops = 4 * pairs * H * D
    out["paged_multiquery_attention"] = dict(
        ms=time_ms(lambda: mq_kernel(mc)),
        plain_ms=time_ms(lambda: mq_plain(mc)),
        library_ms=time_ms(library_call(mc)), bytes=byt, ops=ops,
        library="sdpa on gathered K/V",
        shape=f"B=1 T={T} (real {real}) q_start=0 H={H} D={D} bf16",
        note=f"{K.multiquery_route(mc.q.dtype, mc.k.dtype, T, D)} body")
    # the speculative verify's call: every row sees its own context
    vc = verify_case(gen, rng, "bfloat16")
    ctx = vc.lens.long()
    pairs = int((ctx * VERIFY_T - VERIFY_T * (VERIFY_T - 1) // 2).sum())
    byt = vc.kv_bytes(int(ctx.sum())) + 2 * vc.q.numel() * 2 \
        + 4 * (int((-(-ctx // bs)).sum()) + 2 * VERIFY_B)
    out["paged_multiquery_attention verify"] = dict(
        ms=time_ms(lambda: mq_kernel(vc)),
        plain_ms=time_ms(lambda: mq_plain(vc)),
        library_ms=time_ms(library_call(vc)), bytes=byt,
        ops=4 * pairs * H * D, library="sdpa on gathered K/V, offset "
        "causal mask", shape=f"B={VERIFY_B} T={VERIFY_T} q_start "
        f"{int(vc.starts.min())}-{int(vc.starts.max())} H={H} D={D} bf16",
        note=f"{K.multiquery_route(vc.q.dtype, vc.k.dtype, VERIFY_T, D)} "
             "body")
    return report_times(out)


def kernel_cost(name, *args):
    """``{"ops", "bytes"}`` of one call of kernel op ``name`` on ``args``
    (its arguments in the op's order): the op's cost formulas
    (``ops/cuda/library.cost``), which ``jit.hlo_audit``'s ledger and
    ``FlopCounterMode`` use too."""
    from paddle_tpu_torch.ops.cuda import library

    c = library.cost(name, *args)
    return {"ops": c["flops"], "bytes": c["bytes"]}


def report_times(out):
    """Add each kernel's bound (the larger of bytes / 3.35 TB/s and
    operations / the bf16 peak) to its timing record and print it."""
    for name, r in out.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_OPS_PER_S["bfloat16"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = ("not available" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        say(f"time {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} "
            f"({r['library']}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bytes']} B, {r['ops']} ops); achieved "
            f"{r['ops'] / r['ms'] / 1e9:.1f} TFLOP/s"
            + (f"; {r['note']}" if r.get("note") else ""))
    return out


# -- flash attention --------------------------------------------------------

FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
         "flash_attention_bwd_dkv")
ROPE = tuple(n.replace("attention_", "attention_rope_") for n in FLASH)


def flash_inputs(gen, bh, s, d, dtype):
    """q, k, v, dO [B*H, S, D] on the card, standard normal."""
    import torch

    return [torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)
            for _ in range(4)]


def compare_grad(got, want, dtype):
    """(max abs error, max excess) of a flash gradient against its plain
    version: tolerance RTOL[dtype]*|want| + GRAD_FRAC*max|want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = RTOL[dtype] * want.abs() + GRAD_FRAC * float(want.abs().max())
    return float(diff.max()), float((diff - tol).max())


def rope_tables(s, d):
    """The llama rope tables for S positions, widened to fp32 [S, D] on
    the card, as ``flash_attention_rope`` passes them to the kernels."""
    import torch

    from paddle_tpu_torch.models.llama import _rope_cache
    from paddle_tpu_torch.ops.cuda.flash_attention import widen_tables

    cos, sin = (torch.from_numpy(t).cuda() for t in _rope_cache(s, d,
                                                                 10000.0))
    return widen_tables(cos, sin)


def flash_calls(rope, s, d):
    """(fwd, dq, dkv, plain fwd, plain dq, plain dkv) of the flash kernels
    without or with rope, all taking (q, k, v[, out, lse, dout], scale,
    causal); the rope forms get the llama tables for S and D."""
    from paddle_tpu_torch.ops.cuda import flash_attention as K

    if not rope:
        return (K.flash_attention_fwd_cuda, K.flash_attention_bwd_dq_cuda,
                K.flash_attention_bwd_dkv_cuda, K.flash_attention_fwd_plain,
                K.flash_attention_bwd_dq_plain,
                K.flash_attention_bwd_dkv_plain)
    c2, s2 = rope_tables(s, d)

    def bind(fn, n):  # the tables go after the first n arguments
        return lambda *a: fn(*a[:n], c2, s2, *a[n:])

    return (bind(K.flash_attention_rope_fwd_cuda, 3),
            bind(K.flash_attention_rope_bwd_dq_cuda, 6),
            bind(K.flash_attention_rope_bwd_dkv_cuda, 6),
            bind(K.flash_attention_rope_fwd_plain, 3),
            bind(K.flash_attention_rope_bwd_dq_plain, 6),
            bind(K.flash_attention_rope_bwd_dkv_plain, 6))


def flash_case(gen, case, rope=False):
    """One flash case ``(B, H, S, D, dtype, causal, what)``: the forward,
    dq and dkv kernels (``rope``: their rope forms, on pre-rotary q and k
    with the llama tables) against their plain versions (evaluated in fp32
    on the exactly upcast inputs; the backward's plain versions take the
    kernel's own out and lse). Returns the max abs errors (out, dq, dkv)."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as K

    b, h, s, d, dt, causal, what = case
    tag = "flash rope" if rope else "flash"
    fwd, bdq, bdkv, p_fwd, p_dq, p_dkv = flash_calls(rope, s, d)
    q, k, v, do = flash_inputs(gen, b * h, s, d, getattr(torch, dt))
    scale = d ** -0.5
    up = [t.float() for t in (q, k, v, do)]
    out, lse = fwd(q, k, v, scale, causal)
    w_out, w_lse = p_fwd(*up[:3], scale, causal)
    e_out, x_out = compare(out, w_out, dt)
    e_lse = float((lse - w_lse).abs().max())
    del w_out, w_lse
    res = (*up[:3], out.float(), lse, up[3])
    dq = bdq(q, k, v, out, lse, do, scale, causal)
    e_dq, x_dq = compare_grad(dq, p_dq(*res, scale, causal), dt)
    dk, dv = bdkv(q, k, v, out, lse, do, scale, causal)
    w_dk, w_dv = p_dkv(*res, scale, causal)
    e_dk, x_dk = compare_grad(dk, w_dk, dt)
    e_dv, x_dv = compare_grad(dv, w_dv, dt)
    torch.cuda.synchronize()
    route = K.flash_route(getattr(torch, dt), d)
    check(route == ("tensor_core" if dt == "bfloat16" else "cuda_core"),
          f"{tag} forward and backward route {route} for {dt}")
    say(f"kernel {tag} B={b} H={h} S={s} D={d} {dt} causal={causal} "
        f"({what}; forward, dq and dkv {route}): out {e_out:.3e} "
        f"(tol {ATOL:g} + "
        f"{RTOL[dt]:g}*|want|)"
        f", lse {e_lse:.3e} (tol {LSE_ATOL:g}), dq {e_dq:.3e}, dk "
        f"{e_dk:.3e}, dv {e_dv:.3e} (tol {RTOL[dt]:g}*|want| + "
        f"{GRAD_FRAC:g}*max|want|)")
    check(x_out <= 0 and e_lse <= LSE_ATOL, f"{tag} fwd {what}")
    check(x_dq <= 0, f"{tag} dq {what}")
    check(x_dk <= 0 and x_dv <= 0, f"{tag} dkv {what}")
    del q, k, v, do, up, res, out, lse, dq, dk, dv, w_dk, w_dv
    torch.cuda.empty_cache()
    return e_out, e_dq, max(e_dk, e_dv)


def phase_flash_kernels(gen, rope=False):
    """Phase 2b: each flash kernel (``rope``: its rope form) against its
    plain version over the cases below (``flash_case``). Returns {kernel:
    max abs error}."""
    names = ROPE if rope else FLASH
    worst = dict.fromkeys(names, 0.0)
    cases = [  # (B, H, S, D, dtype, causal, what)
        (16, 12, 1024, 64, "bfloat16", True, "llama_125m training"),
        (2, 16, 2048, 128, "bfloat16", True, "llama_1b heads"),
        (2, 4, 512, 32, "bfloat16", True, "bf16 D=32"),
        (2, 4, 512, 32, "float32", True, "fp32 D=32"),
        (2, 4, 512, 64, "float32", True, "fp32 D=64"),
        (2, 8, 512, 64, "bfloat16", False, "non-causal"),
        (128, 12, 128, 64, "bfloat16", False, "BERT-base training"),
        (2, 4, 1000, 64, "bfloat16", True, "ragged S"),
        (1, 4, 1000, 128, "float32", False, "ragged S fp32 D=128")]
    if not rope:  # hapi O1's eval runs outside auto_cast: #3's fp32 body
        cases.append((128, 12, 128, 64, "float32", False,
                      "BERT-base eval fp32 (hapi O1)"))
    for case in cases:
        for name, e in zip(names, flash_case(gen, case, rope)):
            worst[name] = max(worst[name], e)
    flash_gqa_check(gen, rope)
    if not rope:
        sdpa_route_check(gen)
    return worst


def sdpa_route_check(gen):
    """On the card, ``F.scaled_dot_product_attention`` at a head_dim or
    dtype the flash kernels are not built for (96 in bf16, 64 in fp16)
    takes the plain dense attention, as the reference's ``_sdpa_ref``, and
    equals it."""
    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional import flash_attention as sdpa

    for d, dt in ((96, torch.bfloat16), (64, torch.float16)):
        q, k, v = (torch.randn(2, 256, 4, d, generator=gen, device="cuda")
                   .to(dt) for _ in range(3))
        got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        path = sdpa.LAST_PATH
        want = F.sdpa_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        say(f"kernel sdpa route D={d} {dt}: {path}")
        check(path == "reference" and torch.equal(got, want),
              f"sdpa at D={d} {dt} takes the plain dense attention")


def flash_gqa_check(gen, rope=False):
    """GQA 32/8 through the autograd Function (kernels, fp32) against the
    plain dense attention differentiated by autograd on the card; with
    ``rope`` the pre-rotary q and k are rotated in fp32 on the plain
    side."""
    import torch

    from paddle_tpu_torch.models.llama import _rope_cache
    from paddle_tpu_torch.nn.functional import sdpa_reference
    from paddle_tpu_torch.ops.cuda import flash_attention as K

    b, s, h, hkv, d = 1, 512, 32, 8, 128
    shapes = ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))
    arrs = [torch.randn(sh, generator=gen, device="cuda") for sh in shapes]
    w = torch.randn(b, s, h, d, generator=gen, device="cuda")
    cos, sin = (torch.from_numpy(t).cuda() for t in _rope_cache(s, d,
                                                                 10000.0))
    c2, s2 = K.widen_tables(cos, sin)

    def rot(x):  # fp32 rope on [B, S, H, D]
        return K.rope_rotate(x.transpose(1, 2), c2, s2).transpose(1, 2)

    if rope:
        fns = (lambda q, k, v: K.flash_attention_rope(q, k, v, cos, sin),
               lambda q, k, v: sdpa_reference(rot(q), rot(k), v,
                                              causal=True))
    else:
        fns = (lambda q, k, v: K.flash_attention(q, k, v, causal=True),
               lambda q, k, v: sdpa_reference(q, k, v, causal=True))
    got = []
    for fn in fns:
        ts = [a.clone().requires_grad_() for a in arrs]
        out = fn(*ts)
        (out * w).sum().backward()
        got.append([out.detach()] + [t.grad for t in ts])
    torch.cuda.synchronize()
    e_out, x_out = compare(got[0][0], got[1][0], "float32")
    errs = [compare_grad(a, b_, "float32") for a, b_ in zip(got[0][1:],
                                                            got[1][1:])]
    tag = "flash rope" if rope else "flash"
    say(f"kernel {tag} GQA {h}/{hkv} S={s} D={d} fp32 through the autograd "
        f"Function vs plain sdpa + autograd: out {e_out:.3e}, dq/dk/dv "
        f"{', '.join(f'{e:.3e}' for e, _ in errs)}")
    check(x_out <= 0 and all(x <= 0 for _, x in errs), f"{tag} GQA")


def phase_flash_times(gen, rope=False):
    """Phase 3b, at the training shape (llama_125m: B 16, H 12, S 1024,
    D 64, bf16, causal), without or with rope. Library:
    ``scaled_dot_product_attention`` forward on [B, H, S, D] (with rope, on
    q and k rotated beforehand, outside the timed call), and its autograd
    backward (dq, dk and dv together) beside dq and dkv. The bound's bytes
    and operations are the ops' cost formulas (``kernel_cost``): with rope
    they add the two fp32 [S, D] tables to the bytes and the rotation of q
    and k (6 operations an element) to the operations."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda.flash_attention import rope_rotate

    b, h, s, d = 16, 12, 1024, 64
    bh, scale = b * h, d ** -0.5
    fwd, bdq, bdkv, p_fwd, p_dq, p_dkv = flash_calls(rope, s, d)
    q, k, v, do = flash_inputs(gen, bh, s, d, torch.bfloat16)
    out, lse = fwd(q, k, v, scale, True)
    # with rope the tables go after q, k, v (and after the backward's six
    # tensors) in the ops' cost formulas
    tabs = rope_tables(s, d) if rope else ()
    qk = (q, k)
    if rope:
        qk = tuple(rope_rotate(t, *tabs).to(t.dtype) for t in qk)
    lib = [t.view(b, h, s, d).clone().requires_grad_() for t in (*qk, v)]
    lib_out = F.scaled_dot_product_attention(*lib, is_causal=True)
    lib_do = do.view(b, h, s, d)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, lib, lib_do, retain_graph=True))
    fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *lib, is_causal=True))
    pairs = bh * s * (s + 1) // 2               # causal visible pairs
    shape = f"B={b} H={h} S={s} D={d} bf16 causal" + (" rope" if rope
                                                      else "")
    res = (q, k, v, out, lse, do, scale, True)
    names = ROPE if rope else FLASH
    times = {
        names[0]: dict(
            ms=time_ms(lambda: fwd(q, k, v, scale, True)),
            plain_ms=time_ms(lambda: p_fwd(q, k, v, scale, True)),
            library_ms=fwd_ms, library="sdpa forward",
            **kernel_cost(names[0], q, k, v, *tabs, scale, True)),
        names[1]: dict(
            ms=time_ms(lambda: bdq(*res)),
            plain_ms=time_ms(lambda: p_dq(*res)),
            library_ms=bwd_ms, library="sdpa backward, dq+dk+dv",
            **kernel_cost(names[1], *res[:6], *tabs, scale, True)),
        names[2]: dict(
            ms=time_ms(lambda: bdkv(*res)),
            plain_ms=time_ms(lambda: p_dkv(*res)),
            library_ms=bwd_ms, library="sdpa backward, dq+dk+dv",
            **kernel_cost(names[2], *res[:6], *tabs, scale, True))}
    for r in times.values():
        r["shape"] = shape
    report_times(times)
    # the forward's bf16 tensor-core products per visible pair: S (2 D;
    # with rope 3 products, the rotated q and k split: 6 D) and P V (P
    # split: 4 D)
    tc_fwd = (10 if rope else 6) * d
    f = times[names[0]]
    say(f"time {'flash rope' if rope else 'flash'} forward: kernel "
        f"{f['ms']:.4f} ms vs sdpa forward {fwd_ms:.4f} ms; achieved "
        f"{f['ops'] / f['ms'] / 1e9:.1f} TFLOP/s of the counted work; "
        f"tensor-core work with the splits ({tc_fwd // d}*D a pair): "
        f"{tc_fwd * pairs / f['ms'] / 1e9:.1f} TFLOP/s")
    bwd = times[names[1]]["ms"] + times[names[2]]["ms"]
    # the bf16 tensor-core bodies' products per visible pair: S, dP and
    # dq (dS split: 2 products) = 8 D; S, dP, dv and dk (P, dS split) =
    # 12 D; with rope S, dq and dk take 3 products (rotated q, k split)
    tc_ops = (14 * d, 18 * d) if rope else (8 * d, 12 * d)
    rates = [(times[n]["ops"] / times[n]["ms"] / 1e9,
              per * pairs / times[n]["ms"] / 1e9)
             for n, per in zip(names[1:], tc_ops)]
    say(f"time {'flash rope' if rope else 'flash'} backward: dq + dkv "
        f"kernels {bwd:.4f} ms vs sdpa backward {bwd_ms:.4f} ms; achieved "
        f"dq {rates[0][0]:.1f}, dkv {rates[1][0]:.1f} TFLOP/s of the counted "
        f"work; tensor-core work with the splits ({tc_ops[0] // d}*D, "
        f"{tc_ops[1] // d}*D a pair): dq {rates[0][1]:.1f}, dkv "
        f"{rates[1][1]:.1f} TFLOP/s")
    del q, k, v, do, out, lse, lib, lib_out, qk, tabs
    torch.cuda.empty_cache()
    return times


# -- MoE expert FFN, fused add + RMSNorm and fused add + LayerNorm ---------

MOE_SHAPE = (8, 5120, 768, 2048)     # Llama-MoE training: E, C, h, I
RMS_SHAPE = (16384, 768)             # 16 x 1024 tokens, hidden 768
RMS_EPS = 1e-5
LN_SHAPE = (16384, 768)              # BERT-base: 128 x 128 tokens, hidden 768
LN_EPS = 1e-12                       # BertConfig.layer_norm_eps


def moe_inputs(gen, e, c, h, i, dtype):
    """x [E, C, h] standard normal and Wg, Wu [E, h, I], Wd [E, I, h]
    from N(0, 0.02), as the model draws them, on the card."""
    import torch

    x = torch.randn(e, c, h, generator=gen, device="cuda").to(dtype)
    ws = [(torch.randn(*sh, generator=gen, device="cuda") * 0.02).to(dtype)
          for sh in ((e, h, i), (e, h, i), (e, i, h))]
    return x, ws


def rms_inputs(gen, rows, h, dtype):
    import torch

    x, y = (torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    return x, y, w


def ln_inputs(gen, rows, h, dtype):
    """x, y with a mean of 1 (so the variance's two passes matter), the
    weight near 1 and the bias near 0, on the card."""
    import torch

    x, y, w = rms_inputs(gen, rows, h, dtype)
    b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    return x + 1, y, w, b


def phase_fused_kernels(gen):
    """Phase 2c: the MoE expert FFN kernel and the fused add + RMSNorm
    kernel against their plain versions (fp32 on the exactly upcast
    inputs), at the Llama-MoE training shapes and at small ragged ones.
    Returns {kernel: max abs error}."""
    import torch

    from paddle_tpu_torch.ops.cuda import moe_ffn as MF
    from paddle_tpu_torch.ops.cuda import rms_norm as RN

    worst = {"moe_ffn": 0.0, "fused_add_rms_norm": 0.0,
             "fused_add_layer_norm": 0.0}
    for (e, c, h, i), dt, what in ((MOE_SHAPE, "bfloat16", "training"),
                                   (MOE_SHAPE, "float32", "training fp32"),
                                   ((2, 20, 128, 384), "float32",
                                    "ragged C"),
                                   ((3, 20, 128, 100), "float32",
                                    "ragged C and I"),
                                   ((2, 20, 128, 384), "bfloat16",
                                    "ragged C"),
                                   ((3, 20, 128, 100), "bfloat16",
                                    "ragged C and I")):
        x, ws = moe_inputs(gen, e, c, h, i, getattr(torch, dt))
        got = MF.moe_ffn_cuda(x, *ws)
        err, excess = compare(got, MF.moe_ffn_plain(
            x.float(), *(w.float() for w in ws)), dt)
        torch.cuda.synchronize()
        say(f"kernel moe_ffn E={e} C={c} h={h} I={i} {dt} ({what}): "
            f"max_abs_err {err:.3e} (tol {ATOL:g} + {RTOL[dt]:g}*|want|)")
        check(excess <= 0, f"moe_ffn {what}")
        worst["moe_ffn"] = max(worst["moe_ffn"], err)
        del x, ws, got
    for (rows, h), dt in ((RMS_SHAPE, "bfloat16"), (RMS_SHAPE, "float32"),
                          ((37, 256), "bfloat16")):
        x, y, w = rms_inputs(gen, rows, h, getattr(torch, dt))
        out, r = RN.fused_add_rms_norm_cuda(x, y, w, RMS_EPS)
        _, w_r = RN.fused_add_rms_norm_plain(x, y, w, RMS_EPS)
        same_r = bool(torch.equal(r, w_r))
        # the norm in fp32 from the rounded residual, unrounded
        w_out, _ = RN.fused_add_rms_norm_plain(
            w_r.float(), torch.zeros_like(w_r, dtype=torch.float32),
            w.float(), RMS_EPS)
        err, excess = compare(out, w_out, dt)
        torch.cuda.synchronize()
        say(f"kernel fused_add_rms_norm {rows}x{h} {dt}: out max_abs_err "
            f"{err:.3e} (tol {ATOL:g} + {RTOL[dt]:g}*|want|), residual "
            f"identical: {same_r}")
        check(excess <= 0 and same_r, f"fused_add_rms_norm {rows}x{h} {dt}")
        worst["fused_add_rms_norm"] = max(worst["fused_add_rms_norm"], err)
    for (rows, h), dt in ((LN_SHAPE, "bfloat16"), (LN_SHAPE, "float32"),
                          ((37, 200), "bfloat16"), ((9, 13000), "float32")):
        x, y, w, b = ln_inputs(gen, rows, h, getattr(torch, dt))
        out, r = RN.fused_add_layer_norm_cuda(x, y, w, b, LN_EPS)
        _, w_r = RN.fused_add_layer_norm_plain(x, y, w, b, LN_EPS)
        same_r = bool(torch.equal(r, w_r))
        # the norm in fp32 from the rounded residual, unrounded
        w_out, _ = RN.fused_add_layer_norm_plain(
            w_r.float(), torch.zeros_like(w_r, dtype=torch.float32),
            w.float(), b.float(), LN_EPS)
        err, excess = compare(out, w_out, dt)
        torch.cuda.synchronize()
        say(f"kernel fused_add_layer_norm {rows}x{h} {dt}: out max_abs_err "
            f"{err:.3e} (tol {ATOL:g} + {RTOL[dt]:g}*|want|), residual "
            f"identical: {same_r}")
        check(excess <= 0 and same_r,
              f"fused_add_layer_norm {rows}x{h} {dt}")
        worst["fused_add_layer_norm"] = max(worst["fused_add_layer_norm"],
                                            err)
    torch.cuda.empty_cache()
    return worst


def moe_l2_bytes(e, c, h, i):
    """(all, weights): bytes the MoE kernel's bf16 body reads through L2 in
    one call. Each cluster (64 tokens, 768 output columns) reads its
    expert's three bf16 weights once and its x tile once per 128-column I
    tile (csrc/moe_ffn.cu)."""
    clusters = e * -(-c // 64) * -(-h // 768)
    weights = clusters * 3 * h * i * 2
    return weights + clusters * 2 * -(-i // 128) * 64 * h * 2, weights


def phase_fused_times(gen):
    """Phase 3c, at the Llama-MoE and BERT-base training shapes in bf16.
    Library: the expert FFN's composition in three ``torch.bmm`` calls (the
    [E, C, I] intermediates in device memory), and the residual add
    followed by ``torch.nn.functional.rms_norm`` or ``layer_norm``."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import moe_ffn as MF
    from paddle_tpu_torch.ops.cuda import rms_norm as RN

    e, c, h, i = MOE_SHAPE
    x, (gw, uw, dw) = moe_inputs(gen, e, c, h, i, torch.bfloat16)

    def moe_library():
        return torch.bmm(F.silu(torch.bmm(x, gw)) * torch.bmm(x, uw), dw)

    times = {"moe_ffn": dict(
        ms=time_ms(lambda: MF.moe_ffn_cuda(x, gw, uw, dw)),
        plain_ms=time_ms(lambda: MF.moe_ffn_plain(x, gw, uw, dw)),
        library_ms=time_ms(moe_library), library="3 x torch.bmm",
        **kernel_cost("moe_ffn", x, gw, uw, dw),
        shape=f"E={e} C={c} h={h} I={i} bf16",
        note=f"{MF.moe_ffn_route(x.dtype)} body, L2 reads %d B of which "
             "weights %d B" % moe_l2_bytes(e, c, h, i))}
    del x, gw, uw, dw
    rows, h = RMS_SHAPE
    x, y, w = rms_inputs(gen, rows, h, torch.bfloat16)
    lib_rms = getattr(F, "rms_norm", None)
    times["fused_add_rms_norm"] = dict(
        ms=time_ms(lambda: RN.fused_add_rms_norm_cuda(x, y, w, RMS_EPS)),
        plain_ms=time_ms(lambda: RN.fused_add_rms_norm_plain(x, y, w,
                                                             RMS_EPS)),
        library_ms=None if lib_rms is None else time_ms(
            lambda: lib_rms(x + y, (h,), w, RMS_EPS)),
        library="x + y, then F.rms_norm",
        **kernel_cost("fused_add_rms_norm", x, y, w, RMS_EPS),
        shape=f"{rows}x{h} bf16")
    del x, y, w
    rows, h = LN_SHAPE
    x, y, w, b = ln_inputs(gen, rows, h, torch.bfloat16)
    times["fused_add_layer_norm"] = dict(
        ms=time_ms(lambda: RN.fused_add_layer_norm_cuda(x, y, w, b, LN_EPS)),
        plain_ms=time_ms(lambda: RN.fused_add_layer_norm_plain(x, y, w, b,
                                                               LN_EPS)),
        library_ms=time_ms(lambda: F.layer_norm(x + y, (h,), w, b, LN_EPS)),
        library="x + y, then F.layer_norm",
        **kernel_cost("fused_add_layer_norm", x, y, w, b, LN_EPS),
        shape=f"{rows}x{h} bf16")
    del x, y, w, b
    torch.cuda.empty_cache()
    return report_times(times)


SERVE_WINDOW = 8   # decode_steps_per_sync of the window run
SERVE_NEW = 16     # new tokens a request in phase 4's runs
SPEC_K = 3         # spec_tokens of the speculative runs
MQ_KERNELS = ("paged_multiquery_tc_kernel", "paged_multiquery_kernel")


def serve_run(model, prompts, new, label, profile=True, cross_check=False,
              **engine_kw):
    """One llama_1b serving run: a fresh engine (2048 blocks of 16, batch
    8), a warm-up request outside the counted run (cuBLAS handles, the
    allocator, and for a window engine the graph's capture), the counted
    run, then (``profile``) one profiled repeat whose paged-kernel launches
    (counted through graph replays) must equal the kernels' own device
    tally of the split and multi-query kernels (``cross_check``: see
    ``device_profile``). The counted run's launches must be
    layers x decode iterations (#1) and layers x prefill chunks (#2); with
    a draft, #1 the draft's layers x its decode iterations, and #2 the
    target's layers x (chunks + verify steps) plus the draft's x chunks
    (every chunk is mirrored into the draft). Returns (outputs, wall s,
    launch counts, metrics, profile)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    t_life = time.perf_counter()
    engine = LLMEngine(model, num_blocks=2048, block_size=16,
                       max_batch_size=8, max_model_len=2048, device="cuda",
                       **engine_kw)
    rng = np.random.RandomState(SEED + 2)
    draft = engine_kw.get("draft_model")
    # a speculative warm-up runs through several verify steps, so a draft
    # that gets a whole window accepted captures the catch-up's graph (of
    # 2 feeds: the bucket a steady state needs) outside the counted run
    engine.generate([rng.randint(0, model.config.vocab_size, 64)],
                    SamplingParams(max_new_tokens=2 if draft is None
                                   else 32))
    engine.reset_metrics()
    reset_peak_memory()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, SamplingParams(max_new_tokens=new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    m = engine.metrics()
    reset_paged_counts()
    prof = None
    if profile:
        prof = device_profile(lambda: engine.generate(
            prompts, SamplingParams(max_new_tokens=new)),
            f"serve {label} (same batch again)",
            mark=("paged_decode", "paged_multiquery"),
            cross_check=cross_check)
    if profile:
        check_device_launches(prof, K.launch_counts(), f"serve {label}")
    engine.close()
    t_life = time.perf_counter() - t_life
    L = model.config.num_hidden_layers
    for p, o in zip(prompts, outs):
        check(len(o) == len(p) + new, "every request finished")
        gen_toks = o[len(p):]
        check(((gen_toks >= 0) & (gen_toks < model.config.vocab_size)).all(),
              "tokens inside the vocab")
    check(m["finished"] == len(prompts), "all requests finished")
    chunks = m["prefill_chunks"]
    if draft is None:
        want_dec, want_mq = L * m["decode_steps"], L * chunks
        iters = f"{m['decode_steps']} decode steps"
    else:
        Ld = draft.config.num_hidden_layers
        want_dec = Ld * m["spec_draft_steps"]
        want_mq = L * (chunks + m["spec_verify_steps"]) + Ld * chunks
        iters = (f"{m['spec_draft_steps']} draft decode iterations, "
                 f"{m['spec_verify_steps']} verify steps")
    check(counts["paged_decode_attention_cuda"] == want_dec and want_dec > 0,
          f"decode launches {counts} == {want_dec} ({iters})")
    check(counts["paged_multiquery_attention_cuda"] == want_mq and chunks > 0,
          f"multi-query launches {counts} == {want_mq} ({chunks} chunks, "
          f"{iters})")
    toks = len(prompts) * new
    spec = ("" if draft is None else
            f", verify steps {m['spec_verify_steps']}, draft decode "
            f"iterations {m['spec_draft_steps']}, accept ratio "
            f"{m['spec_accept_ratio']:.4f} ({m['spec_accepted']} of "
            f"{m['spec_proposed']} proposed)")
    say(f"serve llama_1b {label}: {len(prompts)} requests, prompts "
        f"{sorted(len(p) for p in prompts)}, {new} new tokens each: wall "
        f"{wall:.3f} s, {toks / wall:.1f} tokens/s, ttft p50 "
        f"{m['ttft_ms'].get('p50')} ms, itl p50 {m['itl_ms'].get('p50')} "
        f"ms, decode steps {m['decode_steps']}, host syncs "
        f"{m['host_syncs']}, fetch bytes {m['decode_fetch_bytes']}, "
        f"prefill chunks {chunks}{spec}, launches {counts}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the "
        f"engine's life (warm-up, run, profiled repeat) {t_life:.1f} s")
    return outs, wall, counts, m, prof


def serve_prompts(vocab):
    """Phase 4's eight greedy prompts (430-1536 tokens, int32)."""
    import numpy as np

    rng = np.random.RandomState(SEED + 2)
    rng.randint(0, vocab, 64)   # the warm-up prompt's draw
    lens = rng.randint(64, 1537, 8)
    lens[0] = 1536
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def reset_paged_counts():
    """Zero the paged wrappers' launch counts and the kernels' own device
    tally, together, before a cross-checked run."""
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    K.reset_launch_counts()
    K.device_tally(reset=True)


def check_device_launches(prof, launched, label, zero=()):
    """The paged kernels' launches the wrappers counted over a profiled
    run (``launched``, since ``reset_paged_counts``) equal the launches
    the kernels themselves counted on the device over it
    (``device_tally``: exact, whatever the profiler keeps): more than
    none, or none for the wrappers named in ``zero``. The profiler's
    count of the same kernels is printed beside them, not checked (it
    came up short in some whole runs, PERF.md)."""
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    tally = K.device_tally()
    for kernels, wrapper in (
            (("paged_decode_split_kernel",), "paged_decode_attention_cuda"),
            (MQ_KERNELS, "paged_multiquery_attention_cuda")):
        ran = sum(tally[k] for k in kernels)
        seen = ("not measured" if prof is None else
                sum(n for name, (_, n) in prof["kernels"].items()
                    if any(k in name for k in kernels)))
        say(f"{label}: the kernels counted {ran} {'/'.join(kernels)} "
            f"launches on the device, the wrapper {launched[wrapper]} "
            f"(the profiler saw {seen})")
        check(ran == launched[wrapper]
              and (ran == 0 if wrapper in zero else ran > 0),
              f"{wrapper} launches {launched[wrapper]} == the device "
              f"tally's {ran}{' == 0' if wrapper in zero else ''}")


def same_share(outs, ref):
    """Share of requests whose tokens equal ``ref``'s."""
    return sum(bool((a == b).all()) for a, b in zip(outs, ref)) / len(ref)


def phase_serve():
    """Phase 4: llama_1b through LLMEngine, per step (host sampling), with
    decode windows of ``SERVE_WINDOW`` (one CUDA graph replay each), per
    step with synchronous staging, then speculative with ``SPEC_K`` drafts
    (a self-draft, fused and unfused catch-up; a random llama_125m draft),
    on the same model and prompts; then ``generate`` on 8 x 512 prompts.
    The per-step run's profile holds ``device_profile``'s reader to
    ``prof.events()``. Returns the paged kernels' launch counts over the
    per-step run."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_1b, llama_125m

    cfg = llama_1b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"serve setup: llama_1b bf16 ({n_params} params) + 2048-block "
        f"pool in {time.perf_counter() - t0:.2f} s")
    prompts = serve_prompts(cfg.vocab_size)
    new = SERVE_NEW
    step_out, step_wall, counts, ms, ps = serve_run(model, prompts, new,
                                                    "per-step",
                                                    cross_check=True)
    win_out, win_wall, _, mw, pw = serve_run(
        model, prompts, new, f"window {SERVE_WINDOW}",
        decode_steps_per_sync=SERVE_WINDOW)
    same = all((a == b).all() for a, b in zip(step_out, win_out))
    check(same, "window tokens equal the per-step run's")
    check(ms["host_syncs"] == ms["decode_steps"]
          and mw["decode_steps"] == SERVE_WINDOW * mw["host_syncs"]
          and mw["host_syncs"] < ms["host_syncs"],
          f"host syncs: per-step {ms['host_syncs']} (one a step), window "
          f"{mw['host_syncs']} (one a window of {SERVE_WINDOW})")
    if ps is not None and pw is not None:
        # cuBLAS must choose the same GEMM kernels under capture as eagerly
        gemms = [sorted(n for n in p["kernels"] if "nvjet" in n
                        or "gemm" in n.lower()) for p in (ps, pw)]
        say(f"serve GEMM kernels, per-step vs window: {gemms[0]} vs "
            f"{gemms[1]}")
        check(gemms[0] == gemms[1], "the window's GEMMs are the per-step "
              "run's")
    toks = len(prompts) * new

    def busy(p):
        return ("not measured" if p is None else
                f"busy {p['busy_ms']:.1f} ms, idle share {p['idle']:.3f}")

    say(f"serve per-step vs window {SERVE_WINDOW}: greedy tokens identical: "
        f"{same}; tokens/s {toks / step_wall:.1f} vs {toks / win_wall:.1f}; "
        f"itl p50 {ms['itl_ms'].get('p50')} vs {mw['itl_ms'].get('p50')} "
        f"ms; host syncs {ms['host_syncs']} vs {mw['host_syncs']}; decode "
        f"iterations {ms['decode_steps']} vs {mw['decode_steps']}; "
        f"{busy(ps)} vs {busy(pw)}")
    # the default engine stages on its ingest thread; the same run staged
    # synchronously must give the same tokens. Runs in turns (async above,
    # sync, sync, async), so order effects show
    walls = {True: [step_wall], False: []}
    same = True
    for ingest_async in (False, False, True):
        out, wall, _, _, _ = serve_run(
            model, prompts, new,
            f"per-step ingest {'async' if ingest_async else 'sync'}",
            profile=False, ingest_async=ingest_async)
        walls[ingest_async].append(wall)
        same = same and all((a == b).all() for a, b in zip(step_out, out))
    say(f"serve llama_1b ingest sync vs async: greedy tokens identical: "
        f"{same}; tokens/s in turns async, sync, sync, async: "
        f"{toks / walls[True][0]:.1f}, {toks / walls[False][0]:.1f}, "
        f"{toks / walls[False][1]:.1f}, {toks / walls[True][1]:.1f}")
    check(same, "async and sync ingest give the same tokens")
    draft = LlamaForCausalLM(llama_125m(), device="cuda",
                             dtype=torch.bfloat16, seed=SEED + 5)
    spec = {}
    for label, d, fused, profile in (
            (f"spec self k{SPEC_K}", model, True, True),
            (f"spec self k{SPEC_K} unfused", model, False, False),
            (f"spec draft llama_125m k{SPEC_K}", draft, True, False)):
        spec[label] = serve_run(model, prompts, new, label, profile=profile,
                                draft_model=d, spec_tokens=SPEC_K,
                                fuse_draft_catchup=fused)
        out, wall, _, m, _ = spec[label]
        say(f"serve {label} vs per-step: {same_share(out, step_out):.3f} "
            f"of requests with identical tokens (reported, not asserted: "
            f"bf16 GEMMs of {VERIFY_B} x {SPEC_K + 1} rows and #2's "
            f"tensor-core body round apart from the per-step decode); "
            f"tokens/s {toks / wall:.1f} vs {toks / step_wall:.1f}")
    fused, unfused, rnd = spec.values()
    same = all((a == b).all() for a, b in zip(fused[0], unfused[0]))
    say(f"serve spec self k{SPEC_K} fused vs unfused catch-up: tokens "
        f"identical: {same}; accept ratio {fused[3]['spec_accept_ratio']} "
        f"vs {unfused[3]['spec_accept_ratio']}")
    check(same and fused[3]["spec_accept_ratio"]
          == unfused[3]["spec_accept_ratio"],
          "fused and unfused catch-up give the same tokens and accepts")
    check(fused[3]["spec_accept_ratio"] >= 0.5,
          f"self-draft accept ratio {fused[3]['spec_accept_ratio']} >= 0.5")
    check(rnd[3]["spec_proposed"] > rnd[3]["spec_accepted"],
          "the random draft's proposals are rejected")
    del draft
    phase_generate_1b(model, LLMEngine, SamplingParams)
    del model
    torch.cuda.empty_cache()
    return counts


def phase_generate_1b(model, LLMEngine, SamplingParams, B=8, S=512,
                      new=32):
    """``generate`` (the static-cache decode, plain dense attention) on
    llama_1b bf16 over B x S random prompts: ms per token, and the share
    of requests whose tokens equal the per-step engine's (reported)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 6)
    ids = rng.randint(0, model.config.vocab_size, (B, S)).astype(np.int32)
    model.generate(ids[:, :64], max_new_tokens=2)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new).cpu().numpy()
    wall = time.perf_counter() - t0
    with LLMEngine(model, num_blocks=2048, block_size=16, max_batch_size=B,
                   max_model_len=2048, device="cuda") as eng:
        ref = eng.generate(list(ids), SamplingParams(max_new_tokens=new))
    check(out.shape == (B, S + new) and (out[:, :S] == ids).all(),
          "generate returns prompt + new tokens")
    say(f"generate llama_1b bf16 [{B}, {S}] + {new}: wall {wall:.3f} s, "
        f"{wall * 1e3 / new:.2f} ms per decode step ({B} rows), "
        f"{B * new / wall:.1f} tokens/s; {same_share(list(out), ref):.3f} "
        f"of requests equal the per-step engine's tokens (reported)")


def device_profile(run, label, top=8, mark=None, cross_check=False):
    """``run()`` once under ``torch.profiler``: the device's busy time (the
    union of its kernel and copy intervals, so nothing is counted twice)
    and idle share of the wall time, and the top kernels by device time.
    ``mark`` names kernels whose shares are printed as well. Returns
    ``{"busy_ms", "idle", "kernels": {name: (device us, launches)}}``, or
    None when the profiler recorded no device time.

    The device intervals are read from the profiler's own event records
    as ``prof.events()`` reads them (its filter, its start and end in us
    from the trace's start, its names), without building an event object
    for every CPU op (which took longer than the serving runs it
    profiled). ``cross_check`` also reads them through ``prof.events()``
    and fails unless the two sorted lists are equal."""
    import torch
    from torch.autograd import DeviceType
    from torch.autograd.profiler import _filter_name
    from torch.autograd.profiler_util import _rewrite_name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    records = prof.profiler.kineto_results
    start_ns = records.trace_start_ns()
    spans = sorted(
        ((e.start_ns() - start_ns) / 1000, (e.end_ns() - start_ns) / 1000,
         _rewrite_name(e.name(), with_wildcard=True))
        for e in records.events()
        if e.device_type() == DeviceType.CUDA and not _filter_name(e.name())
        and not getattr(e, "is_hidden_event", lambda: False)())
    if cross_check:
        t1 = time.perf_counter()
        old = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
        say(f"profile {label}: the records give {len(spans)} device "
            f"intervals, prof.events() {len(old)} (read in "
            f"{time.perf_counter() - t1:.1f} s); equal: {spans == old}")
        check(spans == old, f"profile {label}: the device intervals read "
              "from the records equal prof.events()'s")
    busy, reach, by_name = 0.0, spans[0][0], {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
        n = by_name.setdefault(name, [0.0, 0])
        n[0] += b - a
        n[1] += 1
    total = sum(us for us, _ in by_name.values())
    say(f"profile {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms = {busy / wall_us:.3f} of wall (idle share "
        f"{1 - busy / wall_us:.3f}); {len(spans)} device ops, "
        f"{total / 1e3:.1f} ms of device time")
    rows = sorted(((us, name, cnt) for name, (us, cnt) in by_name.items()),
                  reverse=True)
    for us, name, cnt in rows[:top]:
        say(f"  {us / total:.3f} of device time, {us / 1e3:.2f} ms, "
            f"{cnt} calls: {name[:90]}")
    for key in mark or ():
        us = sum(u for u, name, _ in rows if key in name)
        say(f"  {key}*: {us / total:.3f} of device time, {us / 1e3:.2f} ms")
    return {"busy_ms": busy / 1e3, "idle": 1 - busy / wall_us,
            "kernels": {name: (us, cnt) for us, name, cnt in rows}}


def phase_card_vs_cpu():
    """Phase 6: identical greedy tokens on the CPU and on the card."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         load_paddle_tpu_state_dict,
                                         llama_tiny)

    cfg = llama_tiny()
    rng = np.random.RandomState(SEED + 3)
    ref = LlamaForCausalLM(cfg, device="cpu")
    state = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in ref.state_dict().items()}
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40, 77, 130)]
    for chunk in (None, 32):
        outs = {}
        for dev in ("cpu", "cuda"):
            m = LlamaForCausalLM(cfg, device=dev)
            load_paddle_tpu_state_dict(m, state)
            with LLMEngine(m, num_blocks=64, block_size=16,
                           max_batch_size=3, max_prefill_tokens_per_step=chunk,
                           device=dev) as eng:
                outs[dev] = eng.generate(prompts,
                                         SamplingParams(max_new_tokens=16))
        same = all((a == b).all() for a, b in zip(outs["cpu"],
                                                  outs["cuda"]))
        say(f"card vs cpu llama_tiny fp32 (chunk budget {chunk}): greedy "
            f"tokens identical: {same}")
        check(same, "card and CPU greedy tokens agree")
    # decode windows: eager on the CPU, graph replays on the card; equal to
    # the per-step path on both, and over an int8 pool on the card
    outs = {}
    for dev, kv, k in (("cpu", None, 1), ("cpu", None, SERVE_WINDOW),
                       ("cuda", None, 1), ("cuda", None, SERVE_WINDOW),
                       ("cuda", "int8", 1), ("cuda", "int8", SERVE_WINDOW)):
        m = LlamaForCausalLM(cfg, device=dev)
        load_paddle_tpu_state_dict(m, state)
        with LLMEngine(m, num_blocks=64, block_size=16, max_batch_size=3,
                       kv_dtype=kv, decode_steps_per_sync=k,
                       device=dev) as eng:
            outs[dev, kv, k] = eng.generate(
                prompts, SamplingParams(max_new_tokens=16))
            if k > 1 and dev == "cuda":
                check(eng._window.graph is not None
                      and eng._window.replays == eng.metrics()["host_syncs"],
                      "every window was one graph replay")

    def agree(a, b):
        return all((x == y).all() for x, y in zip(outs[a], outs[b]))

    fp = [key for key in outs if key[1] is None]
    same = all(agree(fp[0], key) for key in fp[1:])
    same8 = agree(("cuda", "int8", 1), ("cuda", "int8", SERVE_WINDOW))
    say(f"card vs cpu llama_tiny fp32, decode windows of {SERVE_WINDOW}: "
        f"window and per-step tokens identical on the card and the CPU: "
        f"{same}; int8 pool on the card, window vs per-step: {same8}")
    check(same and same8, "window tokens agree with the per-step path")
    spec_card_vs_cpu(cfg, state, prompts, outs[("cpu", None, 1)])
    generate_card_vs_cpu(cfg, state, prompts)


def spec_card_vs_cpu(cfg, state, prompts, plain):
    """fp32 llama_tiny speculative engines (a self-draft and a 1-layer
    draft, fused and unfused catch-up, ``SPEC_K`` drafts) on the card and
    on the CPU: tokens identical to each other and to the plain engine's,
    spec counters identical card vs CPU."""
    import dataclasses

    import numpy as np

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         load_paddle_tpu_state_dict)

    dcfg = dataclasses.replace(cfg, num_hidden_layers=1)
    rng = np.random.RandomState(SEED + 4)
    dstate = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                  (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
              for k, v in LlamaForCausalLM(dcfg, device="cpu")
              .state_dict().items()}
    rows = []
    for kind in ("self", "1-layer"):
        for fused in (True, False):
            got = {}
            for dev in ("cpu", "cuda"):
                m = LlamaForCausalLM(cfg, device=dev)
                load_paddle_tpu_state_dict(m, state)
                d = m
                if kind != "self":
                    d = LlamaForCausalLM(dcfg, device=dev)
                    load_paddle_tpu_state_dict(d, dstate)
                with LLMEngine(m, num_blocks=64, block_size=16,
                               max_batch_size=3, draft_model=d,
                               spec_tokens=SPEC_K, fuse_draft_catchup=fused,
                               device=dev) as eng:
                    out = eng.generate(prompts,
                                       SamplingParams(max_new_tokens=16))
                    mm = eng.metrics()
                    graphs = sum(g.graph is not None
                                 for g in eng._catchups.values())
                got[dev] = (out, mm["spec_proposed"], mm["spec_accepted"],
                            graphs)
            same = (all((a == b).all() for a, b in zip(got["cpu"][0],
                                                       got["cuda"][0]))
                    and got["cpu"][1:3] == got["cuda"][1:3])
            plain_ok = all((a == b).all() for a, b in zip(got["cuda"][0],
                                                          plain))
            rows.append(same and plain_ok)
            say(f"card vs cpu llama_tiny fp32 spec {kind} draft, "
                f"{'fused' if fused else 'unfused'} catch-up: tokens and "
                f"counters identical card vs cpu: {same}; equal to the "
                f"plain engine: {plain_ok}; accepted {got['cuda'][2]} of "
                f"{got['cuda'][1]}; catch-up graphs on the card "
                f"{got['cuda'][3]}")
            check(not fused or kind != "self" or got["cuda"][3] > 0,
                  "the fused catch-up ran as a graph on the card")
    check(all(rows), "speculative tokens agree card vs cpu vs plain")


def generate_card_vs_cpu(cfg, state, prompts):
    """fp32 llama_tiny ``generate`` tokens and ``cached_step`` logits, card
    vs CPU (logits within ATOL: fp32 sums in another order)."""
    import numpy as np

    from paddle_tpu_torch.models import (LlamaForCausalLM, StaticKVCache,
                                         load_paddle_tpu_state_dict)

    ids = np.stack([p[:5] for p in prompts])
    toks, logits = {}, {}
    for dev in ("cpu", "cuda"):
        m = LlamaForCausalLM(cfg, device=dev)
        load_paddle_tpu_state_dict(m, state)
        toks[dev] = m.generate(ids, max_new_tokens=16).cpu().numpy()
        cache = StaticKVCache(cfg, len(ids), 64, device=dev)
        logits[dev] = [m.cached_step(x, cache).float().cpu().numpy()
                       for x in (ids, toks[dev][:, 5:6], toks[dev][:, 6:7])]
    same = (toks["cpu"] == toks["cuda"]).all()
    err = max(float(np.abs(a - b).max())
              for a, b in zip(logits["cpu"], logits["cuda"]))
    say(f"card vs cpu llama_tiny fp32 generate: tokens identical: {same}; "
        f"cached_step logits (prefill + 2 decode steps) max_abs_diff "
        f"{err:.3e} (tol {ATOL:g})")
    check(same and err <= ATOL, "generate agrees card vs cpu")


def copy_share(prof):
    """Share of device time in copy kernels (names holding "copy"), or
    None when the profiler recorded no device time."""
    if prof is None:
        return None
    kernels = prof["kernels"].items()
    total = sum(us for _, (us, _) in kernels)
    return sum(us for name, (us, _) in kernels
               if "copy" in name.lower()) / total


def phase_train(switch=None):
    """Phase 5: llama_125m (bf16, full width and depth, random weights
    from a seed) trained by ``fused_train_step`` with AdamW(1e-4) on one
    fixed 16 x 1024 batch: 2 warm-up and 10 timed steps through
    ``FusedTrainStep.drive``, then one profiled step; with ``switch`` (an
    environment switch such as ``PT_ATTN_EINSUM``) set to 1 for this run
    only. Returns the flash kernels' launch counts over the 12 steps,
    ms/step and the copy kernels' share of device time."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_125m
    from paddle_tpu_torch.nn.functional import flash_attention as sdpa
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops.cuda import flash_attention as K
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_125m()
    batch, seq, warmup, steps = 16, 1024, 2, 10
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    step = fused_train_step(model, AdamW(learning_rate=1e-4,
                                         parameters=model.parameters()))
    rng = np.random.RandomState(SEED + 4)
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                (batch, seq))).cuda()
                   for _ in range(2))
    n_params = sum(p.numel() for p in model.parameters())
    # PaLM-appendix accounting, as bench.py's _train_flops_per_token
    flops_per_token = 6.0 * n_params + 12.0 * cfg.num_hidden_layers \
        * cfg.hidden_size * seq
    torch.cuda.synchronize()
    label = f"llama_125m {switch}=1" if switch else "llama_125m"
    say(f"train setup: {label} bf16 ({n_params} params), batch "
        f"{batch} x {seq}, in {time.perf_counter() - t0:.2f} s")
    with fused_switches((switch,) if switch else ()):
        reset_peak_memory()
        K.reset_launch_counts()
        first = step.drive([(ids, labels)] * warmup, log_every=warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = step.drive([(ids, labels)] * steps, log_every=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        path = sdpa.LAST_PATH
        prof = device_profile(lambda: step(ids, labels),
                              f"train {label} (one step)", top=10,
                              mark=("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"))
    losses = first["loss"] + hist["loss"]
    L = cfg.num_hidden_layers
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls {losses}")
    want_path = "einsum_block" if switch == "PT_ATTN_EINSUM" else "cuda"
    check(path == want_path, f"attention took {path}, not {want_path}")
    for name in FLASH:
        check(counts[name + "_cuda"] == L * (warmup + steps),
              f"{name} launches {counts} == {L} x {warmup + steps} steps")
    tokens = batch * seq * steps
    tok_s = tokens / wall
    gauge = metrics.REGISTRY.get("train_items_per_sec").value(
        instance=step._stats_name)
    share = copy_share(prof)
    say(f"train {label}: losses {[round(x, 4) for x in losses]}; "
        f"{steps} timed steps in {wall:.3f} s = {wall / steps * 1e3:.1f} "
        f"ms/step, {tok_s:.0f} tokens/s (train_items_per_sec {gauge:.0f}), "
        f"MFU {tok_s * flops_per_token / PEAK_OPS_PER_S['bfloat16']:.4f} "
        f"({flops_per_token / 1e6:.1f} MFLOP/token vs 989 TFLOP/s), peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"copy kernels {'not measured' if share is None else f'{share:.3f}'}"
        f" of device time, launches {counts}")
    del model, step
    torch.cuda.empty_cache()
    return counts, wall / steps * 1e3, share


def phase_train_card_vs_cpu(switch=None):
    """Phase 6b: three fused AdamW steps on fp32 llama_tiny (GQA 4/2,
    head_dim 32) from the same numpy weights and batches, on the card
    (kernels) and on the CPU (plain versions); with ``switch`` (such as
    ``PT_ATTN_EINSUM``) set to 1 for this run only."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         load_paddle_tpu_state_dict,
                                         llama_tiny, to_numpy_state_dict)
    from paddle_tpu_torch.nn.functional import flash_attention as sdpa
    from paddle_tpu_torch.ops.cuda import flash_attention as K
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_tiny()
    rng = np.random.RandomState(SEED + 5)
    ref = LlamaForCausalLM(cfg, device="cpu")
    state = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in ref.state_dict().items()}
    batches = [tuple(rng.randint(0, cfg.vocab_size, (4, 128))
                     for _ in range(2)) for _ in range(3)]
    losses, params = {}, {}
    for dev in ("cpu", "cuda"):
        model = LlamaForCausalLM(cfg, device=dev)
        load_paddle_tpu_state_dict(model, state)
        step = fused_train_step(model, AdamW(
            learning_rate=1e-3, epsilon=1e-6, parameters=model.parameters()))
        K.reset_launch_counts()
        with fused_switches((switch,) if switch else ()):
            losses[dev] = [float(step(*(torch.from_numpy(x).to(dev)
                                        for x in b))) for b in batches]
        if switch == "PT_ATTN_EINSUM":
            check(sdpa.LAST_PATH == "einsum_block",
                  f"attention on {dev} took {sdpa.LAST_PATH}")
        if dev == "cuda":
            counts = K.launch_counts()
            check(all(counts[n + "_cuda"] == 3 * cfg.num_hidden_layers
                      for n in FLASH), f"tiny launches {counts}")
        params[dev] = to_numpy_state_dict(model)
    dl = max(abs(a / b - 1) for a, b in zip(losses["cuda"], losses["cpu"]))
    dp = max(float(np.abs(params["cuda"][k] - params["cpu"][k]).max())
             for k in params["cpu"])
    label = f" with {switch}=1" if switch else ""
    say(f"card vs cpu training llama_tiny fp32{label}, 3 AdamW steps: "
        f"losses cuda "
        f"{losses['cuda']} cpu {losses['cpu']}, max rel diff {dl:.2e} (tol "
        f"{TRAIN_LOSS_RTOL:g}); parameters max abs diff {dp:.2e} (tol "
        f"{TRAIN_PARAM_ATOL:g})")
    check(dl <= TRAIN_LOSS_RTOL and dp <= TRAIN_PARAM_ATOL,
          "card and CPU training agree")


# -- Llama-MoE training with the fused switches -----------------------------

SWITCHES = ("PT_FUSED_MOE", "PT_FUSED_NORM", "PT_FUSED_ROPE")


@contextlib.contextmanager
def fused_switches(names=SWITCHES):
    """Set the fused switches ``names`` to "1" inside a ``with`` block and
    restore what was there before, whatever happens inside."""
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(dict.fromkeys(names, "1"))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def llama_moe_config():
    """The Llama-MoE of scripts/bench_moe_ffn.py:55-60: llama_125m's width
    with 8 layers, 8 experts, top-2 routing, MoE every 2nd layer."""
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(hidden_size=768, intermediate_size=2048,
                       num_hidden_layers=8, num_attention_heads=12,
                       num_key_value_heads=12, vocab_size=32000,
                       max_position_embeddings=1024, num_experts=8,
                       num_experts_per_tok=2, moe_every=2)


def kernel_modules():
    from paddle_tpu_torch.ops.cuda import (flash_attention, moe_ffn,
                                           paged_attention, rms_norm)

    return flash_attention, moe_ffn, paged_attention, rms_norm


def all_launch_counts():
    out = {}
    for mod in kernel_modules():
        out.update(mod.launch_counts())
    return out


def reset_all_launch_counts():
    for mod in kernel_modules():
        mod.reset_launch_counts()


def launches_want(**nonzero):
    """Every kernel wrapper's expected count: ``nonzero`` as given (by
    wrapper name), 0 for the rest."""
    want = dict.fromkeys(all_launch_counts(), 0)
    want.update(nonzero)
    return want


def phase_train_moe():
    """Phase 5b: the Llama-MoE (bf16, full width and depth, random weights
    from a seed) trained by ``fused_train_step`` with AdamW(1e-4) on one
    fixed 16 x 1024 batch with the three fused switches on: 2 warm-up and
    10 timed steps through ``FusedTrainStep.drive``, then one profiled
    step. Every new kernel launches exactly as often as the model calls
    it; the flash kernels without rope not at all. Returns the launch
    counts over the 12 steps."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_moe_config()
    batch, seq, warmup, steps = 16, 1024, 2, 10
    L = cfg.num_hidden_layers
    n_moe = L // cfg.moe_every
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    step = fused_train_step(model, AdamW(learning_rate=1e-4,
                                         parameters=model.parameters()))
    rng = np.random.RandomState(SEED + 6)
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                (batch, seq))).cuda()
                   for _ in range(2))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 237_933_312, f"Llama-MoE parameters {n_params}")
    # each token runs top_k of the E experts: count those weights only
    expert = 3 * cfg.hidden_size * cfg.intermediate_size
    active = n_params - n_moe * (cfg.num_experts
                                 - cfg.num_experts_per_tok) * expert
    flops_per_token = 6.0 * active + 12.0 * L * cfg.hidden_size * seq
    torch.cuda.synchronize()
    say(f"train-moe setup: Llama-MoE bf16 ({n_params} params, {active} "
        f"active per token), batch {batch} x {seq}, capacity "
        f"{model.llama.layers[1].mlp.capacity_factor}, in "
        f"{time.perf_counter() - t0:.2f} s")
    with fused_switches():
        reset_peak_memory()
        reset_all_launch_counts()
        first = step.drive([(ids, labels)] * warmup, log_every=warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = step.drive([(ids, labels)] * steps, log_every=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        device_profile(lambda: step(ids, labels), "train-moe (one step)",
                       top=10, mark=("moe_ffn", "fused_add_rms_norm",
                                     "flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"))
    losses = first["loss"] + hist["loss"]
    n = warmup + steps
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls {losses}")
    want = launches_want(moe_ffn_cuda=n_moe * n,
                         fused_add_rms_norm_cuda=L * n,
                         **{f"{k}_cuda": L * n for k in ROPE})
    check(counts == want, f"Llama-MoE launches {counts} == {want}")
    tok_s = batch * seq * steps / wall
    say(f"train-moe Llama-MoE: losses {[round(x, 4) for x in losses]}; "
        f"{steps} timed steps in {wall:.3f} s = {wall / steps * 1e3:.1f} "
        f"ms/step, {tok_s:.0f} tokens/s, MFU "
        f"{tok_s * flops_per_token / PEAK_OPS_PER_S['bfloat16']:.4f} "
        f"({flops_per_token / 1e6:.1f} MFLOP/token on the active "
        f"parameters vs 989 TFLOP/s), peak memory {peak:.2f} GiB, launches "
        f"{counts}")
    del model, step
    torch.cuda.empty_cache()
    return counts


def phase_train_moe_card_vs_cpu():
    """Phase 6c: fp32 llama_tiny with 4 experts (GQA 4/2, head_dim 32) and
    the three fused switches on, from the same numpy weights and batches,
    on the card (kernels) and on the CPU (plain versions). The routing of
    the first batch is compared first, exactly: a flipped top-k choice is
    a routing difference, reported as such. Then three fused AdamW steps
    give the same losses and parameters on both."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        moe_capacity, top_k_capacity_gating)
    from paddle_tpu_torch.models import (LlamaForCausalLM, LlamaMoE,
                                         load_paddle_tpu_state_dict,
                                         llama_tiny, to_numpy_state_dict)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_tiny(num_experts=4)
    rng = np.random.RandomState(SEED + 7)
    ref = LlamaForCausalLM(cfg, device="cpu")
    state = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in ref.state_dict().items()}
    batches = [tuple(rng.randint(0, cfg.vocab_size, (4, 128))
                     for _ in range(2)) for _ in range(3)]
    losses, params, routes = {}, {}, {}
    with fused_switches():
        for dev in ("cpu", "cuda"):
            model = LlamaForCausalLM(cfg, device=dev)
            load_paddle_tpu_state_dict(model, state)
            seen = []
            hooks = [m.register_forward_hook(
                lambda m, a, out: seen.append((m, a[0].detach())))
                for m in model.modules() if isinstance(m, LlamaMoE)]
            with torch.no_grad():
                model(torch.from_numpy(batches[0][0]).to(dev))
            for h in hooks:
                h.remove()
            routes[dev] = []
            for m, x in seen:
                t = x.shape[0] * x.shape[1]
                # no graph: one kept alive would hold the router's
                # gradient stream (the default one) into the capture
                with torch.no_grad():
                    probs = torch.softmax(m.router(x).reshape(t, -1).float(),
                                          -1)
                routes[dev].append(top_k_capacity_gating(
                    probs, m.top_k, moe_capacity(
                        t, m.num_experts, m.top_k,
                        m.capacity_factor))[0].cpu())
            step = fused_train_step(model, AdamW(
                learning_rate=1e-3, epsilon=1e-6,
                parameters=model.parameters()))
            reset_all_launch_counts()
            losses[dev] = [float(step(*(torch.from_numpy(x).to(dev)
                                        for x in b))) for b in batches]
            if dev == "cuda":
                counts = all_launch_counts()
                L = cfg.num_hidden_layers
                want = launches_want(
                    moe_ffn_cuda=3 * (L // cfg.moe_every),
                    fused_add_rms_norm_cuda=3 * L,
                    **{f"{k}_cuda": 3 * L for k in ROPE})
                check(counts == want, f"tiny MoE launches {counts}")
            params[dev] = to_numpy_state_dict(model)
    flipped = sum(int((a != b).sum()) for a, b in zip(routes["cpu"],
                                                      routes["cuda"]))
    say(f"card vs cpu llama_tiny MoE routing of the first batch: "
        f"{sum(r.numel() for r in routes['cpu'])} top-k choices, {flipped} "
        "differ")
    check(flipped == 0, f"routing difference: {flipped} top-k choices "
          "flipped between the card and the CPU")
    dl = max(abs(a / b - 1) for a, b in zip(losses["cuda"], losses["cpu"]))
    dp = max(float(np.abs(params["cuda"][k] - params["cpu"][k]).max())
             for k in params["cpu"])
    say(f"card vs cpu training llama_tiny MoE fp32 with the fused switches, "
        f"3 AdamW steps: losses cuda {losses['cuda']} cpu {losses['cpu']}, "
        f"max rel diff {dl:.2e} (tol {TRAIN_LOSS_RTOL:g}); parameters max "
        f"abs diff {dp:.2e} (tol {TRAIN_PARAM_ATOL:g})")
    check(dl <= TRAIN_LOSS_RTOL and dp <= TRAIN_PARAM_ATOL,
          "card and CPU MoE training agree")


# -- BERT-base fine-tuning with the fused add + LayerNorm -------------------

BERT_PARAMS = 109_483_778


def bert_tiny_state(model, rng):
    """Random fp32 weights for ``model``'s state dict: LayerNorm weights
    near one, everything else N(0, 0.02)."""
    import numpy as np

    return {k: ((1 + 0.1 * rng.standard_normal(v.shape)) if "norm" in k
                and k.endswith(".weight") else
                rng.standard_normal(v.shape) * 0.02).astype(np.float32)
            for k, v in model.state_dict().items()}


def phase_train_bert(dropout=False):
    """Phase 5c: BERT-base sequence classification (bf16, full width and
    depth, random weights from a seed) fine-tuned as ``bench.py bert`` sets
    it up (``bench.py:401-466``: both dropouts 0, AdamW(2e-5) through
    ``fused_train_step`` with loss ``o[0]`` and labels by keyword) on one
    fixed 128 x 128 batch of random ids and labels, with ``PT_FUSED_NORM``
    on for this run only: 2 warm-up and 10 timed steps through
    ``FusedTrainStep.drive`` (dict batches), then one profiled step. The
    fused add + LayerNorm launches twice a layer a step, each flash kernel
    without rope once; no other kernel. With ``dropout`` the config keeps
    its default 0.1 dropouts (training mode): attention takes the plain
    dense route with its keep mask, so the flash kernels never launch.
    Returns the launch counts over the 12 steps and ms/step."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_base)
    from paddle_tpu_torch.optimizer import AdamW

    from paddle_tpu_torch.nn.functional import flash_attention as sdpa

    cfg = (bert_base() if dropout else
           bert_base(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0))
    label = "BERT-base dropout 0.1" if dropout else "BERT-base"
    batch, seq, warmup, steps = 128, 128, 2, 10
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = BertForSequenceClassification(cfg, device="cuda",
                                          dtype=torch.bfloat16, seed=SEED)
    step = fused_train_step(model, AdamW(learning_rate=2e-5,
                                         parameters=model.parameters()),
                            loss_fn=lambda out: out[0])
    rng = np.random.RandomState(SEED + 8)
    data = {"input_ids": torch.from_numpy(
                rng.randint(0, cfg.vocab_size, (batch, seq))).cuda(),
            "labels": torch.from_numpy(
                rng.randint(0, cfg.num_labels, batch)).cuda()}
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == BERT_PARAMS, f"BERT-base parameters {n_params}")
    # PaLM-appendix accounting, as bench.py's _train_flops_per_token
    flops_per_token = 6.0 * n_params + 12.0 * L * cfg.hidden_size * seq
    torch.cuda.synchronize()
    say(f"train-bert setup: {label} bf16 ({n_params} params), batch "
        f"{batch} x {seq}, in {time.perf_counter() - t0:.2f} s")
    with fused_switches(("PT_FUSED_NORM",)):
        reset_peak_memory()
        reset_all_launch_counts()
        first = step.drive([data] * warmup, log_every=warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = step.drive([data] * steps, log_every=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_launch_counts()
        path = sdpa.LAST_PATH
        peak = torch.cuda.max_memory_allocated() / 2**30
        device_profile(lambda: step(**data),
                       f"train-bert {label} (one step)", top=10,
                       mark=("fused_add_layer_norm", "flash_fwd",
                             "flash_bwd_dq", "flash_bwd_dkv"))
    losses = first["loss"] + hist["loss"]
    n = warmup + steps
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    want = launches_want(fused_add_layer_norm_cuda=2 * L * n,
                         **{f"{k}_cuda": 0 if dropout else L * n
                            for k in FLASH})
    check(counts == want, f"{label} launches {counts} == {want}")
    want_path = "reference" if dropout else "cuda"
    check(path == want_path, f"attention took {path}, not {want_path}")
    tok_s = batch * seq * steps / wall
    say(f"train-bert {label}: losses {[round(x, 4) for x in losses]}; "
        f"{steps} timed steps in {wall:.3f} s = {wall / steps * 1e3:.1f} "
        f"ms/step, {tok_s:.0f} tokens/s, MFU "
        f"{tok_s * flops_per_token / PEAK_OPS_PER_S['bfloat16']:.4f} "
        f"({flops_per_token / 1e6:.1f} MFLOP/token vs 989 TFLOP/s), peak "
        f"memory {peak:.2f} GiB, launches {counts}")
    del model, step, data
    torch.cuda.empty_cache()
    return counts, wall / steps * 1e3


def phase_bert_card_vs_cpu():
    """Phase 6d: fp32 bert_tiny with ``PT_FUSED_NORM`` from the same numpy
    weights and batches on the card (kernels) and on the CPU (plain
    versions): three fused AdamW steps give the same losses and
    parameters; then one ``BertModel`` forward of a padded batch (the
    additive mask; plain dense attention on both) gives the same hidden
    states and pooled output."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         BertModel, bert_tiny,
                                         load_paddle_tpu_state_dict,
                                         to_numpy_state_dict)
    from paddle_tpu_torch.nn.functional import flash_attention as sdpa
    from paddle_tpu_torch.optimizer import AdamW

    cfg = bert_tiny(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(SEED + 9)
    state = bert_tiny_state(BertForSequenceClassification(cfg, device="cpu"),
                            rng)
    batches = [(rng.randint(0, cfg.vocab_size, (4, 128)),
                rng.randint(0, cfg.num_labels, 4)) for _ in range(3)]
    losses, params = {}, {}
    with fused_switches(("PT_FUSED_NORM",)):
        for dev in ("cpu", "cuda"):
            model = BertForSequenceClassification(cfg, device=dev)
            load_paddle_tpu_state_dict(model, state)
            step = fused_train_step(model, AdamW(
                learning_rate=1e-3, epsilon=1e-6,
                parameters=model.parameters()), loss_fn=lambda out: out[0])
            reset_all_launch_counts()
            losses[dev] = [float(step(torch.from_numpy(i).to(dev),
                                      labels=torch.from_numpy(l).to(dev)))
                           for i, l in batches]
            if dev == "cuda":
                counts = all_launch_counts()
                want = launches_want(fused_add_layer_norm_cuda=3 * 2 * L,
                                     **{f"{k}_cuda": 3 * L for k in FLASH})
                check(counts == want, f"bert_tiny launches {counts}")
            params[dev] = to_numpy_state_dict(model)
    dl = max(abs(a / b - 1) for a, b in zip(losses["cuda"], losses["cpu"]))
    dp = max(float(np.abs(params["cuda"][k] - params["cpu"][k]).max())
             for k in params["cpu"])
    say(f"card vs cpu training bert_tiny fp32 with PT_FUSED_NORM, 3 AdamW "
        f"steps: losses cuda {losses['cuda']} cpu {losses['cpu']}, max rel "
        f"diff {dl:.2e} (tol {TRAIN_LOSS_RTOL:g}); parameters max abs diff "
        f"{dp:.2e} (tol {TRAIN_PARAM_ATOL:g})")
    check(dl <= TRAIN_LOSS_RTOL and dp <= TRAIN_PARAM_ATOL,
          "card and CPU BERT training agree")
    enc = bert_tiny_state(BertModel(cfg, device="cpu"), rng)
    ids = rng.randint(0, cfg.vocab_size, (4, 128))
    mask = np.ones((4, 128), np.int64)
    mask[1:, 96:] = 0       # padding in the last quarter
    mask[3, 64:] = 0
    outs = {}
    for dev in ("cpu", "cuda"):
        model = BertModel(cfg, device=dev)
        load_paddle_tpu_state_dict(model, enc)
        with torch.no_grad():
            outs[dev] = [t.cpu() for t in model(
                torch.from_numpy(ids).to(dev),
                attention_mask=torch.from_numpy(mask).to(dev))]
        check(sdpa.LAST_PATH == "reference", f"masked attention on {dev} "
              f"took {sdpa.LAST_PATH}")
    dh = max(float((a - b).abs().max()) for a, b in zip(outs["cuda"],
                                                        outs["cpu"]))
    say(f"card vs cpu BertModel bert_tiny fp32, padded batch (additive "
        f"mask, plain dense attention): hidden and pooled max abs diff "
        f"{dh:.2e} (tol {TRAIN_PARAM_ATOL:g})")
    check(dh <= TRAIN_PARAM_ATOL, "card and CPU masked BERT forward agree")


def phase_dropout_card():
    """Phase 6e: attention dropout on the card (``sdpa_reference`` with a
    CUDA generator): with q = k = 0 every probability is 1/S and V the
    identity makes each output row the dropped probability row, so the
    keep rate must lie within 4 sigma of 1 - p, kept values equal
    (1/S) / (1 - p) and one seed give one mask; a training call routes to
    the reference, a call at p = 0 or in eval mode to the kernels, with
    the output of a call without dropout."""
    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional import flash_attention as sdpa

    b, h, n, p = 4, 8, 128, 0.1
    q = torch.zeros(b, n, h, n, device="cuda")
    v = torch.eye(n, device="cuda")[None, :, None, :].expand(
        b, n, h, n).contiguous()

    def draw(seed, prob=p):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return F.scaled_dot_product_attention(q, q, v, dropout_p=prob,
                                              generator=gen)

    out = draw(SEED)
    check(sdpa.LAST_PATH == "reference", f"dropout took {sdpa.LAST_PATH}")
    kept = out != 0
    rate = kept.float().mean().item()
    sigma = (p * (1 - p) / kept.numel()) ** 0.5
    scale_err = (out[kept] - (1.0 / n) / (1 - p)).abs().max().item()
    same_seed = torch.equal(out, draw(SEED))
    other_seed = not torch.equal(out, draw(SEED + 1))
    # p = 0 and eval calls route as without dropout (the kernels)
    plain = F.scaled_dot_product_attention(q, q, v)
    zero = torch.equal(draw(SEED, 0.0), plain)
    zero_path = sdpa.LAST_PATH
    ev = F.scaled_dot_product_attention(q, q, v, dropout_p=p,
                                        training=False)
    eval_path = sdpa.LAST_PATH
    zero = zero and zero_path == "cuda" and torch.equal(ev, plain)
    say(f"card dropout p={p}: keep rate {rate:.5f} (1 - p within 4 sigma "
        f"= {4 * sigma:.5f}), kept values off (1/S)/(1-p) by "
        f"{scale_err:.2e}; one seed one mask {same_seed}, another seed "
        f"another {other_seed}; p = 0 and eval give the output without "
        f"dropout: {zero} (routes {zero_path}, {eval_path})")
    check(abs(rate - (1 - p)) <= 4 * sigma and scale_err <= 1e-7
          and same_seed and other_seed and zero and eval_path == "cuda",
          "attention dropout semantics on the card")


# -- training recipes: schedules, per-parameter decay and step sizes, SGD and
# Momentum in the fused step, the eager optimizers -------------------------

# llama_125m bf16 learning rates of the SGD and Momentum runs, large enough
# that an update outlasts the cast back to bf16 (no master weights, as in
# the reference) and the fixed batch's loss falls in 12 steps
SGD_LR = 1.0
MOMENTUM_LR = 0.1


def warmup_cosine_lr(k, peak, warmup, t_max):
    """The LR after k steps of ``LinearWarmup(CosineAnnealingDecay(peak,
    t_max), warmup, 0, peak)``, computed here on the host."""
    if k < warmup:
        return peak * k / warmup
    return peak * (1 + math.cos(math.pi * (k - warmup) / t_max)) / 2


def warmup_poly_lr(k, peak, warmup, decay_steps):
    """The LR after k steps of ``LinearWarmup(PolynomialDecay(peak,
    decay_steps, end_lr=0), warmup, 0, peak)``, computed here."""
    if k < warmup:
        return peak * k / warmup
    return peak * (1 - min(k - warmup, decay_steps) / decay_steps)


def llama_recipes(sgd_lr, momentum_lr, epsilon):
    """The Llama recipes: name -> make(model) -> (optimizer, the LR after
    k steps). (a) the Llama pretraining recipe: AdamW(weight_decay 0.1)
    under a 4-step linear warmup into a cosine decay to 0 at step 16, no
    decay on the norms and the embeddings, a global-norm clip at 1.0;
    (b) Momentum(0.9) with an L2Decay(1e-4) regularizer; (c) SGD."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.regularizer import L2Decay

    def adamw(model):
        keep = {p.name for n, p in model.named_parameters()
                if "norm" not in n and "embed" not in n}
        sched = O.lr.LinearWarmup(O.lr.CosineAnnealingDecay(3e-4, T_max=12),
                                  warmup_steps=4, start_lr=0.0, end_lr=3e-4)
        return (O.AdamW(learning_rate=sched, epsilon=epsilon,
                        weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0),
                        apply_decay_param_fun=lambda n: n in keep,
                        parameters=model.parameters()),
                lambda k: warmup_cosine_lr(k, 3e-4, 4, 12))

    def momentum(model):
        return (O.Momentum(learning_rate=momentum_lr, momentum=0.9,
                           weight_decay=L2Decay(1e-4),
                           parameters=model.parameters()),
                lambda k: momentum_lr)

    def sgd(model):
        return (O.SGD(learning_rate=sgd_lr, parameters=model.parameters()),
                lambda k: sgd_lr)

    return {"AdamW warmup-cosine decay-fun clip": adamw,
            "Momentum L2Decay": momentum, "SGD": sgd}


def bert_recipe(model, peak, epsilon):
    """BERT fine-tuning: AdamW(weight_decay 0.01) under a 2-step warmup into
    a linear decay to 0 over 10 steps, layer-wise LR decay 0.8
    (``lr_ratio``: 0.8 ** (L - i) in layer i, 0.8 ** (L + 1) for the
    embeddings, 1 for the pooler and classifier) and no decay on the biases
    and LayerNorms. Returns (optimizer, the LR after k steps)."""
    from paddle_tpu_torch import optimizer as O

    layers = model.bert.config.num_hidden_layers
    keep, ratios = set(), {}
    for n, p in model.named_parameters():
        if not (n.endswith(".bias") or "norm" in n):
            keep.add(p.name)
        if "embeddings" in n:
            ratios[id(p)] = 0.8 ** (layers + 1)
        elif ".layers." in n:
            ratios[id(p)] = 0.8 ** (layers -
                                    int(n.split(".layers.")[1].split(".")[0]))
    sched = O.lr.LinearWarmup(O.lr.PolynomialDecay(peak, decay_steps=10,
                                                   end_lr=0.0),
                              warmup_steps=2, start_lr=0.0, end_lr=peak)
    return (O.AdamW(learning_rate=sched, epsilon=epsilon, weight_decay=0.01,
                    apply_decay_param_fun=lambda n: n in keep,
                    lr_ratio=lambda p: ratios.get(id(p), 1.0),
                    parameters=model.parameters()),
            lambda k: warmup_poly_lr(k, peak, 2, 10))


def drive_reading_lr(step, opt, batch, n):
    """``step.drive`` over ``batch`` n times in one fetch window; returns
    (drive's history, ``opt.get_lr()`` after each step). The batches come
    from a generator that reads the host LR when drive asks for the next
    batch, after the step before: no device work, no sync. The pulls must
    be the loop's own (``prefetch=False``): a transfer thread reads
    ahead."""
    lrs = []

    def batches():
        for _ in range(n):
            yield batch
            lrs.append(opt.get_lr())

    return step.drive(batches(), log_every=n, prefetch=False), lrs


def check_lrs(lrs, host_lr, label):
    want = [host_lr(k) for k in range(1, len(lrs) + 1)]
    check(all(math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-18)
              for a, b in zip(lrs, want)),
          f"{label}: get_lr() {lrs} == host schedule {want}")


def float_lr_adamw(lr):
    """Phases 5 and 5c's optimizer, AdamW at a float learning rate, in the
    recipes' form: make(model) -> (optimizer, the LR after k steps)."""
    from paddle_tpu_torch.optimizer import AdamW

    return lambda model: (AdamW(learning_rate=lr,
                                parameters=model.parameters()),
                          lambda k: lr)


def recipe_run(label, model, make, batch, check_launches, **step_kw):
    """One recipe run of phase 5d: 2 warm-up and 10 timed steps through
    ``FusedTrainStep.drive`` (one fetch window each) with every launch
    count reset first. Checks finite losses, one host sync a window, the
    launches (``check_launches(counts, steps)``) and ``get_lr()`` after
    each step against the host's schedule. Returns (losses, ms/step)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step

    warmup, steps = 2, 10
    opt, host_lr = make(model)
    step = fused_train_step(model, opt, **step_kw)
    torch.cuda.synchronize()
    reset_peak_memory()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    reset_all_launch_counts()
    first, lrs = drive_reading_lr(step, opt, batch, warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist, more = drive_reading_lr(step, opt, batch, steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    counts = all_launch_counts()
    losses = first["loss"] + hist["loss"]
    check(all(np.isfinite(losses)), f"{label}: finite losses {losses}")
    check(first["host_syncs"] == hist["host_syncs"] == 1,
          f"{label}: one host sync a window")
    check_launches(counts, warmup + steps)
    check_lrs(lrs + more, host_lr, label)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    say(f"train-recipe {label}: losses {[round(x, 4) for x in losses]}; "
        f"lr after each step {[float(f'{x:.6g}') for x in lrs + more]}; "
        f"{ms:.1f} ms/step, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, allocator "
        f"retries {retries}")
    return losses, ms


def phase_train_recipes(dense_ms, bert_ms):
    """Phase 5d: training recipes at full width, each run on a fresh model
    from the seed (``recipe_run``): llama_125m (bf16, phase 5's fixed 16 x
    1024 batch) under the three ``llama_recipes``, between two runs of
    phase 5's float-LR AdamW(1e-4); then BERT-base (phase 5c's setup with
    ``PT_FUSED_NORM``) under ``bert_recipe`` at 2e-5, between two runs of
    phase 5c's AdamW(2e-5). Llama losses fall; each flash kernel launches
    layers x 12 times, BERT's fused add + LayerNorm 2 x layers x 12 and
    nothing else; ms/step beside the float-LR runs of this phase and of
    phases 5 and 5c (``dense_ms``, ``bert_ms``). Returns {run: ms/step}."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         LlamaForCausalLM, bert_base,
                                         llama_125m)

    cfg = llama_125m()
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(SEED + 4)
    batch = tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                               (16, 1024))).cuda()
                  for _ in range(2))

    def llama_launches(counts, n):
        want = launches_want(**{f"{k}_cuda": L * n for k in FLASH})
        check(counts == want, f"llama_125m launches {counts} == {want}")

    runs = [("AdamW(1e-4) float LR", float_lr_adamw(1e-4)),
            *llama_recipes(SGD_LR, MOMENTUM_LR, 1e-8).items(),
            ("AdamW(1e-4) float LR again", float_lr_adamw(1e-4))]
    out = {}
    for name, make in runs:
        label = f"llama_125m {name}"
        model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                 seed=SEED)
        losses, out[label] = recipe_run(label, model, make, batch,
                                        llama_launches)
        check(losses[-1] < losses[0], f"{label}: loss falls {losses}")
        del model
        torch.cuda.empty_cache()

    cfg = bert_base(hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(SEED + 8)
    data = {"input_ids": torch.from_numpy(
                rng.randint(0, cfg.vocab_size, (128, 128))).cuda(),
            "labels": torch.from_numpy(
                rng.randint(0, cfg.num_labels, 128)).cuda()}

    def bert_launches(counts, n):
        want = launches_want(fused_add_layer_norm_cuda=2 * L * n,
                             **{f"{k}_cuda": L * n for k in FLASH})
        check(counts == want, f"BERT-base launches {counts} == {want}")

    def recipe(model):
        opt, host_lr = bert_recipe(model, 2e-5, 1e-8)
        check(len({opt._param_lr_ratio(p) for p in model.parameters()})
              == L + 2, "BERT-base: one LR ratio a depth")
        return opt, host_lr

    runs = [("AdamW(2e-5) float LR", float_lr_adamw(2e-5)),
            ("AdamW warmup-linear layer-decay 0.8", recipe),
            ("AdamW(2e-5) float LR again", float_lr_adamw(2e-5))]
    with fused_switches(("PT_FUSED_NORM",)):
        for name, make in runs:
            label = f"BERT-base {name}"
            model = BertForSequenceClassification(
                cfg, device="cuda", dtype=torch.bfloat16, seed=SEED)
            _, out[label] = recipe_run(label, model, make, data,
                                       bert_launches,
                                       loss_fn=lambda o: o[0])
            del model
            torch.cuda.empty_cache()
    say("train-recipe ms/step (H100 card line above): " + ", ".join(
        f"{k} {v:.1f}" for k, v in out.items()) + f"; phase 5 llama_125m "
        f"{dense_ms:.1f}, phase 5c BERT-base {bert_ms:.1f}")
    return out


# the eager optimizers on fp32 llama_tiny, card against CPU: hyperparameters
# keep every update's sensitivity to the frameworks' rounding under the
# parameter tolerance -- epsilon 1e-6 where an update is ~g / (|g| + eps),
# and Rprop's step sizes within [1e-7, 1e-5], since a gradient element
# within rounding noise of zero may take the other sign on the other device
EAGER_OPTIMIZERS = {
    "SGD": lambda O, ps: O.SGD(learning_rate=0.05, parameters=ps,
                               weight_decay=1e-4),
    "Momentum nesterov": lambda O, ps: O.Momentum(
        learning_rate=0.02, momentum=0.9, use_nesterov=True, parameters=ps),
    "Adagrad": lambda O, ps: O.Adagrad(learning_rate=1e-3, parameters=ps),
    "Adam": lambda O, ps: O.Adam(learning_rate=1e-3, epsilon=1e-6,
                                 weight_decay=0.01, parameters=ps),
    "AdamW": lambda O, ps: O.AdamW(learning_rate=1e-3, epsilon=1e-6,
                                   parameters=ps),
    "Adamax": lambda O, ps: O.Adamax(learning_rate=1e-3, epsilon=1e-6,
                                     parameters=ps),
    "Adadelta": lambda O, ps: O.Adadelta(learning_rate=1.0, parameters=ps),
    "RMSProp centered": lambda O, ps: O.RMSProp(
        learning_rate=1e-3, centered=True, momentum=0.5, parameters=ps),
    "Lamb": lambda O, ps: O.Lamb(learning_rate=1e-3, parameters=ps),
    "Rprop": lambda O, ps: O.Rprop(learning_rate=1e-6,
                                   learning_rate_range=(1e-7, 1e-5),
                                   parameters=ps),
    "LBFGS": lambda O, ps: O.LBFGS(learning_rate=1e-3, max_iter=3,
                                   history_size=5, parameters=ps),
}


def phase_recipes_card_vs_cpu():
    """Phase 6f: the recipes and the 11 eager optimizers on fp32 tiny models
    from the same numpy weights and batches, 3 steps each on the card
    (kernels) and on the CPU (plain versions): the three ``llama_recipes``
    on llama_tiny (epsilon 1e-6, SGD 0.05, Momentum 0.02, as the CPU tests
    use) and ``bert_recipe`` on bert_tiny with ``PT_FUSED_NORM`` through
    the fused step, every ``EAGER_OPTIMIZERS`` entry on llama_tiny through
    ``loss.backward(); step()`` (LBFGS: ``step(closure)``). Losses and
    parameters agree at the tolerances of phase 6b, and the scheduled LRs
    equal the host's on both."""
    import numpy as np
    import torch

    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         LlamaForCausalLM, bert_tiny,
                                         llama_tiny,
                                         load_paddle_tpu_state_dict,
                                         to_numpy_state_dict)

    def compare(label, runs):
        (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
        dl = max(abs(a / b - 1) for a, b in zip(lg, lc))
        dp = max(float(np.abs(pg[k] - pc[k]).max()) for k in pc)
        moved = max(float(np.abs(pc[k] - start[k]).max()) for k in pc)
        say(f"card vs cpu {label}, 3 steps: losses max rel diff {dl:.2e} "
            f"(tol {TRAIN_LOSS_RTOL:g}); parameters max abs diff {dp:.2e} "
            f"(tol {TRAIN_PARAM_ATOL:g}), moved up to {moved:.2e}")
        check(dl <= TRAIN_LOSS_RTOL and dp <= TRAIN_PARAM_ATOL,
              f"card and CPU agree: {label}")
        check(moved > 0, f"{label}: the parameters moved")

    cfg = llama_tiny()
    rng = np.random.RandomState(SEED + 10)
    ref = LlamaForCausalLM(cfg, device="cpu")
    start = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in ref.state_dict().items()}
    batches = [tuple(rng.randint(0, cfg.vocab_size, (4, 128))
                     for _ in range(2)) for _ in range(3)]

    def llama(dev):
        model = LlamaForCausalLM(cfg, device=dev)
        load_paddle_tpu_state_dict(model, start)
        return model

    for name, make in llama_recipes(0.05, 0.02, 1e-6).items():
        runs = {}
        for dev in ("cpu", "cuda"):
            model = llama(dev)
            opt, host_lr = make(model)
            step = fused_train_step(model, opt)
            losses, lrs = [], []
            for b in batches:
                losses.append(float(step(*(torch.from_numpy(x).to(dev)
                                           for x in b))))
                lrs.append(opt.get_lr())
            check_lrs(lrs, host_lr, f"llama_tiny {name} on {dev}")
            runs[dev] = losses, to_numpy_state_dict(model)
        compare(f"fused llama_tiny fp32 {name}", runs)

    for name, make in EAGER_OPTIMIZERS.items():
        runs = {}
        for dev in ("cpu", "cuda"):
            model = llama(dev)
            opt = make(O, model.parameters())
            losses = []
            for b in batches:
                ids, labels = (torch.from_numpy(x).to(dev) for x in b)

                def closure(model=model, opt=opt, ids=ids, labels=labels):
                    opt.clear_grad()
                    loss = model(ids, labels)[0]
                    loss.backward()
                    return loss

                if name == "LBFGS":
                    loss = opt.step(closure)
                else:
                    loss = closure()
                    opt.step()
                losses.append(float(loss.detach()))
            runs[dev] = losses, to_numpy_state_dict(model)
        compare(f"eager llama_tiny fp32 {name}", runs)

    cfg = bert_tiny(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    start = bert_tiny_state(BertForSequenceClassification(cfg, device="cpu"),
                            rng)
    batches = [(rng.randint(0, cfg.vocab_size, (4, 128)),
                rng.randint(0, cfg.num_labels, 4)) for _ in range(3)]
    runs = {}
    with fused_switches(("PT_FUSED_NORM",)):
        for dev in ("cpu", "cuda"):
            model = BertForSequenceClassification(cfg, device=dev)
            load_paddle_tpu_state_dict(model, start)
            opt, host_lr = bert_recipe(model, 1e-3, 1e-6)
            step = fused_train_step(model, opt, loss_fn=lambda o: o[0])
            losses, lrs = [], []
            for i, l in batches:
                losses.append(float(step(torch.from_numpy(i).to(dev),
                                         labels=torch.from_numpy(l).to(dev))))
                lrs.append(opt.get_lr())
            check_lrs(lrs, host_lr, f"bert_tiny recipe on {dev}")
            runs[dev] = losses, to_numpy_state_dict(model)
    compare("fused bert_tiny fp32 AdamW warmup-linear layer-decay 0.8 with "
            "PT_FUSED_NORM", runs)


# -- the fused step as captured CUDA graphs ---------------------------------

# graph against eager body on bf16 models from the same seed weights: the
# same kernels on the same inputs in the same order, so the losses agree to
# a few bf16 roundings of the loss (2^-8 relative each) after 12 steps
GRAPH_LOSS_RTOL = 1e-2


def loss_weighted(model):
    """A module whose loss is ``model(ids, labels)``'s times the mean of a
    float input ``w`` (a scalar, or one per row): a NaN ``w`` poisons one
    batch of a token model (its ids cannot hold NaN), and the
    ``train.spike`` site scales it (the site's target is the first
    floating-point input)."""
    import torch

    class LossWeighted(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = model

        def forward(self, ids, labels, w):
            return self.inner(ids, labels)[0] * w.mean()

    return LossWeighted()


def graph_setups():
    """The A/B's three models: name -> make() -> (model, step, args,
    kwargs, fused switches, want(launch counts, steps) -> expected counts).
    Phase 5's llama_125m, phase 5c's BERT-base and phase 5b's Llama-MoE,
    each on its phase's batch, with AdamW at a float LR."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         LlamaForCausalLM, bert_base,
                                         llama_125m)
    from paddle_tpu_torch.optimizer import AdamW

    def llama(cfg, seed, switches, want):
        def make():
            model = LlamaForCausalLM(cfg, device="cuda",
                                     dtype=torch.bfloat16, seed=SEED)
            step = fused_train_step(model, AdamW(
                learning_rate=1e-4, parameters=model.parameters()))
            rng = np.random.RandomState(seed)
            ids, labels = (torch.from_numpy(rng.randint(
                0, cfg.vocab_size, (16, 1024))).cuda() for _ in range(2))
            return model, step, (ids, labels), {}, switches, want
        return make

    dense = llama_125m()
    moe = llama_moe_config()
    n_moe = moe.num_hidden_layers // moe.moe_every
    bert = bert_base(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)

    def make_bert():
        model = BertForSequenceClassification(bert, device="cuda",
                                              dtype=torch.bfloat16,
                                              seed=SEED)
        step = fused_train_step(model, AdamW(
            learning_rate=2e-5, parameters=model.parameters()),
            loss_fn=lambda out: out[0])
        rng = np.random.RandomState(SEED + 8)
        kw = {"input_ids": torch.from_numpy(
                  rng.randint(0, bert.vocab_size, (128, 128))).cuda(),
              "labels": torch.from_numpy(
                  rng.randint(0, bert.num_labels, 128)).cuda()}
        return model, step, (), kw, ("PT_FUSED_NORM",), lambda n: \
            launches_want(fused_add_layer_norm_cuda=2 * bert.num_hidden_layers
                          * n, **{f"{k}_cuda": bert.num_hidden_layers * n
                                  for k in FLASH})

    return {
        "llama_125m": llama(dense, SEED + 4, (), lambda n: launches_want(
            **{f"{k}_cuda": dense.num_hidden_layers * n for k in FLASH})),
        "BERT-base": make_bert,
        "Llama-MoE": llama(moe, SEED + 6, SWITCHES, lambda n: launches_want(
            moe_ffn_cuda=n_moe * n,
            fused_add_rms_norm_cuda=moe.num_hidden_layers * n,
            **{f"{k}_cuda": moe.num_hidden_layers * n for k in ROPE})),
    }


def graph_arm(name, make, arm, warmup=2, steps=10):
    """One run of the A/B on a fresh model from the seed: ``warmup`` +
    ``steps`` steps, arm "graph" through ``step(...)`` (a warm-up, a
    capture, then replays) or arm "eager" through the private eager body
    ``step._step_body`` (guard off, the same LR), one host sync at the end.
    Times the ``steps`` on the host clock and between two CUDA events, then
    profiles one more step. Checks the launches (layers x 12) and, for the
    graph, 1 compile and 11 hits. Returns the run's numbers."""
    import gc

    import torch

    from paddle_tpu_torch import jit

    model, step, args, kw, switches, want = make()
    lr = step._lr_dev
    lr.fill_(step.optimizer.get_lr())

    def one():
        if arm == "graph":
            return step(*args, **kw)
        return step._step_body(args, kw, lr, step._scale_dev, "off")[0]

    with fused_switches(switches):
        torch.cuda.synchronize()
        reset_peak_memory()
        reset_all_launch_counts()
        losses = [one() for _ in range(warmup)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses += [one() for _ in range(steps)]
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / steps * 1e3
        event_ms = start.elapsed_time(end) / steps
        counts = all_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = torch.stack(losses).float().tolist()
        stats = jit.cache_stats(step._stats_name)
        prof = device_profile(one, f"train-graphs {name} {arm} (one step)",
                              top=5)
    n = warmup + steps
    check(counts == want(n), f"{name} {arm} launches {counts} == {want(n)}")
    if arm == "graph":
        entry, = step._compiled.values()
        check(entry.graph is not None and stats["compiles"] == 1
              and stats["hits"] == n - 1,
              f"{name} graph: one compile, {n - 1} hits, a captured graph "
              f"({stats})")
    else:
        check(stats is None and not step._compiled,
              f"{name} eager: the body ran outside the dispatch")
    del model, step, args, kw, one
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "host_ms": host_ms, "event_ms": event_ms,
            "peak": peak, "prof": prof}


def phase_graph_ab():
    """Phase 7a: each of ``graph_setups`` at full width and depth runs 2 + 10
    steps through its captured graph (A) and through the eager body (B),
    interleaved A, B, A, B, each from the seed weights: ms/step on the host
    clock and on CUDA events, busy time and idle share of one profiled
    step, peak memory, exact launches, one compile a graph run, and the
    graph's losses against the eager body's (``GRAPH_LOSS_RTOL``)."""
    out = {}
    for name, make in graph_setups().items():
        runs = {"graph": [], "eager": []}
        for arm in ("graph", "eager", "graph", "eager"):
            runs[arm].append(graph_arm(name, make, arm))
        ref = runs["eager"][0]["losses"]
        diff = max(abs(a / b - 1) for r in runs["graph"] + runs["eager"]
                   for a, b in zip(r["losses"], ref))
        check(diff <= GRAPH_LOSS_RTOL and all(
            math.isfinite(x) for x in runs["graph"][0]["losses"]),
              f"{name}: graph and eager losses agree ({diff:.2e})")

        def fmt(arm, key, f="{:.2f}"):
            return "/".join(f.format(r[key]) for r in runs[arm])

        def prof(arm):
            p = runs[arm][0]["prof"]
            return ("not measured" if p is None else
                    f"busy {p['busy_ms']:.2f} ms, idle {p['idle']:.3f}")

        say(f"train-graphs {name}: graph vs eager, ms/step host "
            f"{fmt('graph', 'host_ms')} vs {fmt('eager', 'host_ms')}, CUDA "
            f"events {fmt('graph', 'event_ms')} vs "
            f"{fmt('eager', 'event_ms')}; one step: graph {prof('graph')}, "
            f"eager {prof('eager')}; peak memory "
            f"{fmt('graph', 'peak')} vs {fmt('eager', 'peak')} GiB; losses "
            f"graph {[round(x, 4) for x in runs['graph'][0]['losses']]}, max "
            f"rel diff to eager {diff:.2e} (tol {GRAPH_LOSS_RTOL:g}), "
            f"identical {runs['graph'][0]['losses'] == ref}")
        out[name] = runs
    return out


def phase_graphs_card_vs_cpu():
    """Phase 7b: fp32 llama_tiny from the same numpy weights and batches on
    the CPU (eager body) and on the card (graphs), 12 steps each, under
    phase 5d's AdamW recipe (warmup + cosine, decay function, clip;
    epsilon 1e-6): (a) as it is; (b) under ``FLAGS_check_nan_inf_action=
    skip`` with batch 6 poisoned (a NaN loss weight): on the card the
    skipped step leaves parameters and moments bit for bit, and one step
    is skipped; (c) under ``GradScaler(init_loss_scaling=2^126)``: the
    scale after each step equals the CPU's; (d) with ``shape_buckets=[64,
    128, 256]`` over 12 lengths in 33-256: 3 compiles on each. Losses and
    parameters agree at the tolerances of phase 6b throughout."""
    import numpy as np
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                         load_paddle_tpu_state_dict,
                                         to_numpy_state_dict)

    cfg = llama_tiny()
    rng = np.random.RandomState(SEED + 12)
    start = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in LlamaForCausalLM(cfg, device="cpu")
             .state_dict().items()}
    make_opt = llama_recipes(0.05, 0.02, 1e-6)[
        "AdamW warmup-cosine decay-fun clip"]

    def batches(lengths, bad_at=()):
        return [(rng.randint(0, cfg.vocab_size, (4, n)),
                 rng.randint(0, cfg.vocab_size, (4, n)),
                 np.array(np.nan if i in bad_at else 1.0, np.float32))
                for i, n in enumerate(lengths)]

    def run(dev, data, snap_at=None, **step_kw):
        model = LlamaForCausalLM(cfg, device=dev)
        load_paddle_tpu_state_dict(model, start)
        opt, host_lr = make_opt(model)
        step = fused_train_step(loss_weighted(model), opt, **step_kw)
        scaler = step_kw.get("grad_scaler")
        losses, lrs, scales, snap = [], [], [], None
        for i, b in enumerate(data):
            if i == snap_at:
                snap = [t.clone() for t in
                        [*model.parameters(), *step._m1, *step._m2]]
            losses.append(float(step(*(torch.from_numpy(x).to(dev)
                                       for x in b))))
            if i == snap_at:
                same = all(torch.equal(a, b) for a, b in zip(
                    snap, [*model.parameters(), *step._m1, *step._m2]))
                check(same, f"{dev}: the skipped step left parameters and "
                      "moments bit for bit")
            lrs.append(opt.get_lr())
            if scaler is not None:
                scales.append(scaler._scale)
        return {"losses": losses, "params": to_numpy_state_dict(model),
                "scales": scales, "stats": jit.cache_stats(step._stats_name),
                "guard": step.guard_stats(), "lrs": lrs, "host_lr": host_lr,
                "compiled": step._compiled}

    def compare(label, runs):
        c, g = runs["cpu"], runs["cuda"]
        kept = [i for i, x in enumerate(c["losses"]) if math.isfinite(x)]
        dl = max(abs(g["losses"][i] / c["losses"][i] - 1) for i in kept)
        dp = max(float(np.abs(g["params"][k] - c["params"][k]).max())
                 for k in c["params"])
        graphs = sum(e.graph is not None for e in g["compiled"].values())
        say(f"train-graphs card vs cpu llama_tiny fp32 {label}, "
            f"{len(c['losses'])} steps (card: {graphs} graphs): losses max "
            f"rel diff {dl:.2e} (tol {TRAIN_LOSS_RTOL:g}); parameters max "
            f"abs diff {dp:.2e} (tol {TRAIN_PARAM_ATOL:g}); compiles cuda "
            f"{g['stats']['compiles']} cpu {c['stats']['compiles']}; guard "
            f"{g['guard']}" + (f"; scales {g['scales']}" if g["scales"]
                               else ""))
        check(dl <= TRAIN_LOSS_RTOL and dp <= TRAIN_PARAM_ATOL,
              f"card graphs and CPU agree: {label}")
        check([math.isfinite(x) for x in g["losses"]]
              == [math.isfinite(x) for x in c["losses"]]
              and len(kept) > len(c["losses"]) // 2,
              f"{label}: the same steps finite on both")
        check(g["guard"] == c["guard"] and g["scales"] == c["scales"]
              and g["lrs"] == c["lrs"],
              f"{label}: guard counters, scales and LRs equal the CPU's")
        check(graphs == len(g["compiled"]) > 0,
              f"{label}: every signature runs as a graph on the card")

    data = batches([128] * 12)
    runs = {d: run(d, data) for d in ("cpu", "cuda")}
    compare("AdamW recipe", runs)
    check_lrs(runs["cuda"]["lrs"], runs["cuda"]["host_lr"],
              "llama_tiny AdamW recipe on cuda (graphs)")

    data = batches([128] * 12, bad_at={5})
    paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf_action": "skip"})
    try:
        runs = {d: run(d, data, snap_at=5) for d in ("cpu", "cuda")}
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf_action": "none"})
    check(runs["cuda"]["guard"]["skipped"] == 1
          and math.isnan(runs["cuda"]["losses"][5]),
          "one skipped step, its loss NaN")
    compare("AdamW recipe, skip, NaN batch 6", runs)

    data = batches([128] * 12)
    runs = {d: run(d, data, grad_scaler=amp.GradScaler(
        init_loss_scaling=2.0 ** 126)) for d in ("cpu", "cuda")}
    compare("AdamW recipe, GradScaler(2^126)", runs)

    lengths = [33, 64, 65, 100, 128, 129, 200, 256, 40, 90, 150, 250]
    data = batches(lengths)
    runs = {d: run(d, data, shape_buckets=[64, 128, 256])
            for d in ("cpu", "cuda")}
    check(runs["cuda"]["stats"]["compiles"] == runs["cpu"]["stats"][
        "compiles"] == 3, f"3 compiles {runs['cuda']['stats']}")
    compare("AdamW recipe, shape_buckets [64, 128, 256]", runs)


def phase_train_graphs():
    """Phase 7: the fused step as captured CUDA graphs (7a, 7b)."""
    phase_graph_ab()
    phase_graphs_card_vs_cpu()


# -- DeepFM on the row-sparse route ------------------------------------------

# bench.py's largest DeepFM batch (bench.py:262-303)
DEEPFM_BATCH = 16384
# the touched rows after one step, lazy arm against dense arm: the same
# gradient summed in another order (the dense gather's backward against
# the segment sum's atomics), through one Adam step of size ~lr = 1e-3
DEEPFM_ROW_ATOL = 1e-6


def deepfm_with_loss(model):
    """``bench.py``'s loss wrapper: BCE on DeepFM's click probability."""
    import torch

    from paddle_tpu_torch.nn import functional as F

    class WithLoss(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = model

        def forward(self, ids, dense, label):
            return F.binary_cross_entropy(self.inner(ids, dense), label)

    return WithLoss()


def deepfm_batch(rng):
    """A criteo batch on the card as ``bench.py``'s ``make_batch``: random
    int32 ids over 1,000,001 rows for 26 fields, 13 normal dense features
    and 0/1 labels from the numpy ``rng``."""
    import torch

    ids = rng.randint(0, 1000001, (DEEPFM_BATCH, 26)).astype("int32")
    dense = rng.randn(DEEPFM_BATCH, 13).astype("float32")
    label = rng.randint(0, 2, (DEEPFM_BATCH, 1)).astype("float32")
    return tuple(torch.from_numpy(x).cuda() for x in (ids, dense, label))


def deepfm_arm(lazy, batch, warmup=2, steps=10):
    """One run of phase 8a from the seed weights: ``deepfm_criteo`` under
    ``Adam(1e-3, lazy_mode=lazy)``, ``warmup`` + ``steps`` steps through
    ``drive`` on the fixed ``batch`` (one call a warm-up step, then one
    timed call of ``steps``), one more step profiled. Returns the losses,
    the touched rows of both tables after step 1, the tables and moments
    at the end (copies on the host, so the next arm's peak memory is its
    own), times, peak memory and the profile."""
    import gc

    import torch

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import deepfm_criteo
    from paddle_tpu_torch.optimizer import Adam

    torch.cuda.synchronize()
    reset_peak_memory()
    reset_all_launch_counts()
    # what earlier phases still hold (module caches, workspaces): the
    # arm's peak is read above it
    base = torch.cuda.memory_allocated()
    model = deepfm_criteo(device="cuda", seed=SEED)
    tables = (model.embedding.weight, model.first_order_weight.weight)
    init = [w.detach().cpu() for w in tables]
    step = fused_train_step(deepfm_with_loss(model), Adam(
        learning_rate=1e-3, parameters=model.parameters(), lazy_mode=lazy))
    touched = torch.zeros(tables[0].shape[0], dtype=torch.bool,
                          device="cuda")
    touched[batch[0].reshape(-1).long()] = True
    losses = step.drive([batch], steps=1)["loss"]
    after1 = [w.detach()[touched].cpu() for w in tables]
    for _ in range(warmup - 1):
        losses += step.drive([batch], steps=1)["loss"]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    hist = step.drive([batch] * steps, log_every=steps)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    event_ms = start.elapsed_time(end) / steps
    losses += hist["loss"]
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    stats = jit.cache_stats(step._stats_name)
    counts = all_launch_counts()
    idx = [step._names.index(n) for n in ("inner.embedding.weight",
                                          "inner.first_order_weight.weight")]
    out = {"losses": losses, "host_ms": host_ms, "event_ms": event_ms,
           "peak": peak, "base": base / 2**30, "stats": stats,
           "after1": after1,
           "touched": touched.cpu(), "init": init,
           "final": [w.detach().cpu() for w in tables],
           "m1": [step._m1[i].cpu() for i in idx],
           "m2": [step._m2[i].cpu() for i in idx],
           "sparse": step._sparse_names, "host_syncs": hist["host_syncs"]}
    out["prof"] = device_profile(
        lambda: step(*batch), f"deepfm criteo {'lazy' if lazy else 'dense'} "
        "(one step, a replay)", top=8)
    n = warmup + steps
    check(counts == launches_want(),
          f"deepfm: no kernel of the port launches ({counts})")
    check(stats["compiles"] == 1 and stats["hits"] == n - 1
          and all(e.graph is not None for e in step._compiled.values()),
          f"deepfm {'lazy' if lazy else 'dense'}: one compile, {n - 1} hits, "
          f"a captured graph ({stats})")
    check(hist["host_syncs"] == 1, "deepfm: one host sync a window")
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_deepfm_criteo():
    """Phase 8a: DeepFM at the criteo width (vocab 1,000,001, dim 9, 26
    fields, 13 dense, MLP 512/256/128, fp32) on one fixed 16384-example
    batch, 2 + 10 steps through ``drive`` in each arm, interleaved lazy
    (``Adam(lazy_mode=True)``: the row-sparse route in the graph), dense,
    lazy, dense, each from the seed weights. Checks: losses finite and
    falling, both arms' first loss equal, the touched rows of both tables
    after step 1 within ``DEEPFM_ROW_ATOL`` across arms, and after 12 steps
    the lazy arm's untouched rows and their moments as they started (bit
    for bit, moments 0); one compile and 11 hits a run. Prints examples/s,
    ms/step (host and CUDA events), peak memory and one profiled step."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED + 14)
    batch = deepfm_batch(rng)
    runs = {"lazy": [], "dense": []}
    for arm in ("lazy", "dense", "lazy", "dense"):
        runs[arm].append(deepfm_arm(arm == "lazy", batch))
    for arm, rs in runs.items():
        for r in rs:
            ls = r["losses"]
            check(all(math.isfinite(x) for x in ls) and ls[-1] < ls[0],
                  f"deepfm {arm}: finite, falling losses {ls}")
            check(bool(r["sparse"]) == (arm == "lazy"),
                  f"deepfm {arm}: sparse tables {r['sparse']}")
    lazy, dense = runs["lazy"][0], runs["dense"][0]
    first = {r["losses"][0] for rs in runs.values() for r in rs}
    check(len(first) == 1, f"deepfm: both arms' first loss equal {first}")
    row_diff = max(float((a - b).abs().max())
                   for a, b in zip(lazy["after1"], dense["after1"]))
    check(row_diff <= DEEPFM_ROW_ATOL,
          f"deepfm: touched rows after step 1 agree ({row_diff:.2e})")
    kept = ~lazy["touched"]
    same = all(torch.equal(f[kept], i[kept])
               for f, i in zip(lazy["final"], lazy["init"]))
    zero = all(not m[kept].any() for m in lazy["m1"] + lazy["m2"])
    check(same and zero, "deepfm lazy: untouched rows and their moments "
          "as they started, bit for bit")
    n_touched = int(lazy["touched"].sum())

    def fmt(arm, key, f="{:.3f}"):
        return "/".join(f.format(r[key]) for r in runs[arm])

    def prof(arm):
        # idle of the profiled step's wall, and of the timed steps: one
        # step's busy time against its CUDA-event time
        r = runs[arm][0]
        p = r["prof"]
        return ("not measured" if p is None else
                f"busy {p['busy_ms']:.3f} ms, idle {p['idle']:.3f} (timed "
                f"steps {1 - p['busy_ms'] / r['event_ms']:.3f})")

    eps = {arm: "/".join(f"{DEEPFM_BATCH / r['host_ms'] * 1e3:.0f}"
                         for r in rs) for arm, rs in runs.items()}
    say(f"deepfm criteo {DEEPFM_BATCH} examples, lazy vs dense: ms/step "
        f"host {fmt('lazy', 'host_ms')} vs {fmt('dense', 'host_ms')}, CUDA "
        f"events {fmt('lazy', 'event_ms')} vs {fmt('dense', 'event_ms')}; "
        f"examples/s {eps['lazy']} vs {eps['dense']}; one step: lazy "
        f"{prof('lazy')}, dense {prof('dense')}; peak memory "
        f"{fmt('lazy', 'peak', '{:.3f}')} vs {fmt('dense', 'peak', '{:.3f}')}"
        f" GiB above the {lazy['base']:.2f} GiB held at an arm's start; "
        f"losses lazy {[round(x, 5) for x in lazy['losses']]}, dense "
        f"{[round(x, 5) for x in dense['losses']]}; touched rows "
        f"{n_touched} of 1000001 (K = {DEEPFM_BATCH * 26}), max diff after "
        f"step 1 {row_diff:.2e} (tol {DEEPFM_ROW_ATOL:g}); untouched rows "
        f"and their moments as they started (lazy) {same and zero}")


# card vs CPU on the tiny DeepFM: phase 6b's tolerances after a few
# Adam(1e-2, epsilon 1e-6) steps -- cuBLAS and the CPU sum in other orders,
# and the card sums duplicate ids with atomics
DEEPFM_TINY = dict(sparse_feature_number=1000, sparse_feature_dim=4,
                   dense_feature_dim=3, sparse_num_field=6,
                   layer_sizes=(16, 8))


def phase_deepfm_card_vs_cpu():
    """Phase 8b: the tiny fp32 DeepFM (vocab 1000, dim 4, 6 fields, 3
    dense, MLP 16/8, padding row 0) from the same numpy weights and
    batches (repeated ids and padding ids in every batch) on the CPU
    (eager body) and on the card (graphs): three lazy Adam steps; four
    under ``FLAGS_check_nan_inf_action=skip`` with batch 3 poisoned (the
    skipped step leaves tables and moments bit for bit); three with
    ``ClipGradByGlobalNorm(1.0)``; three eager ``Adam(lazy_mode=True)``
    steps on a ``SparseEmbedding``; and a model that reads its table
    outside the lookup (warns and trains dense on both). Losses within
    ``TRAIN_LOSS_RTOL``, parameters within ``TRAIN_PARAM_ATOL``; untouched
    rows and the padding row bit for bit on both."""
    import warnings

    import numpy as np
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.distributed.ps import SparseEmbedding
    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (DeepFM, load_paddle_tpu_state_dict,
                                         to_numpy_state_dict)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Linear
    from paddle_tpu_torch.optimizer import Adam

    vocab, nf, dd = 1000, 6, 3
    start = to_numpy_state_dict(DeepFM(**DEEPFM_TINY, padding_idx=0,
                                       device="cpu", seed=SEED + 15))
    rng = np.random.RandomState(SEED + 16)

    def batches(n, bad_at=()):
        out = []
        for i in range(n):
            ids = rng.randint(1, 200, (64, nf))
            ids[:, 0] = ids[0, 0]  # one id in every example
            ids[::4, 1] = 0  # padding
            dense = rng.randn(64, dd).astype(np.float32)
            if i in bad_at:
                dense[3, 1] = np.nan
            out.append((ids, dense,
                        rng.randint(0, 2, (64, 1)).astype(np.float32)))
        return out

    def untouched(data):
        mask = np.ones(vocab, bool)
        for ids, _, _ in data:
            mask[ids.ravel()] = False
        mask[0] = True  # the padding row: looked up, never moved
        return mask

    def run(dev, data, snap_at=None, **opt_kw):
        model = DeepFM(**DEEPFM_TINY, padding_idx=0, device=dev)
        load_paddle_tpu_state_dict(model, start)
        step = fused_train_step(deepfm_with_loss(model), Adam(
            learning_rate=1e-2, epsilon=1e-6, parameters=model.parameters(),
            lazy_mode=True, **opt_kw))
        def state():
            return [t.clone() for t in
                    [*model.parameters(), *step._m1, *step._m2]]

        losses = []
        for i, b in enumerate(data):
            before = state() if i == snap_at else None
            losses.append(float(step(*(torch.from_numpy(x).to(dev)
                                       for x in b))))
            if before is not None:
                check(all(torch.equal(a, c)
                          for a, c in zip(before, state())),
                      f"deepfm tiny {dev}: the skipped step left tables, "
                      "parameters and moments bit for bit")
        names = ("embedding.weight", "first_order_weight.weight")
        idx = [step._names.index("inner." + n) for n in names]
        return {"losses": losses, "params": to_numpy_state_dict(model),
                "m": [step._m1[i].cpu().numpy() for i in idx]
                + [step._m2[i].cpu().numpy() for i in idx],
                "guard": step.guard_stats(), "names": names,
                "graphs": sum(e.graph is not None
                              for e in step._compiled.values())}

    def compare(label, runs, data):
        c, g = runs["cpu"], runs["cuda"]
        kept = [i for i, x in enumerate(c["losses"]) if math.isfinite(x)]
        dl = max(abs(g["losses"][i] / c["losses"][i] - 1) for i in kept)
        dp = max(float(np.abs(g["params"][k] - c["params"][k]).max())
                 for k in c["params"])
        mask = untouched(data)
        fixed = all(np.array_equal(r["params"][n][mask], start[n][mask])
                    for r in (c, g) for n in c["names"])
        zero = all(not m[mask].any() for r in (c, g) for m in r["m"])
        say(f"deepfm card vs cpu tiny fp32 {label}, {len(c['losses'])} "
            f"steps (card: {g['graphs']} graphs): losses max rel diff "
            f"{dl:.2e} (tol {TRAIN_LOSS_RTOL:g}); parameters max abs diff "
            f"{dp:.2e} (tol {TRAIN_PARAM_ATOL:g}); untouched rows and the "
            f"padding row bit for bit {fixed}, their moments 0 {zero}; "
            f"guard {g['guard']}")
        check(dl <= TRAIN_LOSS_RTOL and dp <= TRAIN_PARAM_ATOL,
              f"deepfm card and CPU agree: {label}")
        check(fixed and zero, f"deepfm {label}: untouched rows kept")
        check(g["guard"] == c["guard"] and [math.isfinite(x) for x in
                                            g["losses"]]
              == [math.isfinite(x) for x in c["losses"]],
              f"deepfm {label}: the same steps finite on both")
        check(g["graphs"] >= 1, f"deepfm {label}: graphs on the card")

    data = batches(3)
    compare("lazy Adam", {d: run(d, data) for d in ("cpu", "cuda")}, data)
    data = batches(4, bad_at={2})
    paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf_action": "skip"})
    try:
        runs = {d: run(d, data, snap_at=2) for d in ("cpu", "cuda")}
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf_action": "none"})
    check(runs["cuda"]["guard"]["skipped"] == 1
          and math.isnan(runs["cuda"]["losses"][2]),
          "deepfm skip: one skipped step, its loss NaN")
    compare("lazy Adam, skip, NaN batch 3", runs, data)
    data = batches(3)
    compare("lazy Adam, ClipGradByGlobalNorm(1.0)",
            {d: run(d, data, grad_clip=ClipGradByGlobalNorm(1.0))
             for d in ("cpu", "cuda")}, data)

    # the eager lazy update on a SparseEmbedding, and a table read outside
    # its lookup (the fused step's safety gate)
    emb_start = rng.uniform(-0.5, 0.5, (vocab, 4)).astype(np.float32)
    lin_start = {"weight": rng.randn(4, 1).astype(np.float32),
                 "bias": np.zeros(1, np.float32)}
    eager_ids = [rng.randint(0, 300, (32, nf)) for _ in range(3)]

    class Pair(torch.nn.Module):
        def __init__(self, dev, tied=False):
            super().__init__()
            self.emb = SparseEmbedding(vocab, 4, device=dev)
            self.lin = Linear(4, 1, device=dev)
            self.tied = tied
            load_paddle_tpu_state_dict(self, {
                "emb.weight": emb_start,
                **{f"lin.{k}": v for k, v in lin_start.items()}})

        def forward(self, ids):
            loss = (self.lin(self.emb(ids)) ** 2).mean()
            if self.tied:
                loss = loss + (self.emb.weight ** 2).sum() * 1e-3
            return loss

    def eager(dev):
        m = Pair(dev)
        opt = Adam(learning_rate=1e-2, epsilon=1e-6,
                   parameters=m.parameters(), lazy_mode=True)
        for ids in eager_ids:
            m(torch.from_numpy(ids).to(dev)).backward()
            opt.step()
            opt.clear_grad()
        return m.emb.weight.detach().cpu().numpy()

    def tied(dev):
        m = Pair(dev, tied=True)
        step = fused_train_step(m, Adam(
            learning_rate=1e-2, epsilon=1e-6, parameters=m.parameters(),
            lazy_mode=True))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for ids in eager_ids:
                step(torch.from_numpy(ids).to(dev))
        warned = sum("outside embedding lookups" in str(x.message)
                     for x in w)
        return m.emb.weight.detach().cpu().numpy(), warned, step._sparse_idx

    mask = np.ones(vocab, bool)
    for ids in eager_ids:
        mask[ids.ravel()] = False
    e = {d: eager(d) for d in ("cpu", "cuda")}
    de = float(np.abs(e["cuda"] - e["cpu"]).max())
    kept = all(np.array_equal(e[d][mask], emb_start[mask]) for d in e)
    t = {d: tied(d) for d in ("cpu", "cuda")}
    dt = float(np.abs(t["cuda"][0] - t["cpu"][0]).max())
    dense_moved = all(not np.array_equal(t[d][0][mask], emb_start[mask])
                      for d in t)
    say(f"deepfm card vs cpu eager Adam(lazy_mode=True) on a "
        f"SparseEmbedding, 3 steps: table max abs diff {de:.2e} (tol "
        f"{TRAIN_PARAM_ATOL:g}), untouched rows bit for bit {kept}; tied "
        f"use: warnings cpu {t['cpu'][1]} cuda {t['cuda'][1]}, dense on "
        f"both {dense_moved}, max abs diff {dt:.2e}")
    check(de <= TRAIN_PARAM_ATOL and kept,
          "deepfm eager lazy Adam: card and CPU agree, untouched rows kept")
    check(dt <= TRAIN_PARAM_ATOL and dense_moved
          and t["cpu"][1] == t["cuda"][1] == 1
          and t["cpu"][2] == t["cuda"][2] == [],
          "deepfm tied use: warns once and trains dense on both")


def phase_deepfm():
    """Phase 8: DeepFM on the row-sparse route (8a, 8b)."""
    phase_deepfm_criteo()
    phase_deepfm_card_vs_cpu()


# -- the supervised training loop ---------------------------------------------

# phase 9: llama_125m batches of 16 x 1024 in windows of 4; 32 batches an
# epoch of seeded token ids
SUP_BATCH, SUP_SEQ, SUP_LOG, SUP_EPOCH = 16, 1024, 4, 32
# the preemption drill's run: the child's steps and the uninterrupted run's
SUP_CHILD_STEPS = 16
# phases 9 and 16 train llama_125m's width at this depth (12 layers in
# phases 5 and 7): their boots, captures and checkpoint files scale with
# the layers, and the whole smoke has to fit its time limit on the slower
# hosts
SUP_LAYERS = 4
SUP_CHILD_MARK = "supervised-child result "
# 9g's AdamW step sizes. Adam scales an update's sensitivity to a
# gradient near zero by lr / epsilon, and over 9g's 16 steps at lr 1e-3
# rounding alone moves the parameters about as far as TRAIN_PARAM_ATOL.
# 9g measures that floor (each device's run against itself from weights
# perturbed by SUP_TINY_NOISE, relative) and holds the card-vs-CPU
# difference within SUP_FLOOR_MULTIPLE of the larger floor: if each
# device stays within its own floor of the unperturbed trajectory, the
# two differ by at most the sum of the floors
SUP_TINY_LRS = (1e-4, 1e-3)
SUP_TINY_NOISE = 1e-7
SUP_FLOOR_MULTIPLE = 2.0


def sup_loader(vocab, n, seq, batch, seed, weighted=False):
    """``DataLoader(TensorDataset(ids, labels[, w]),
    batch_sampler=BucketedBatchSampler(..., seed=0))`` over ``n`` seeded
    numpy samples of ``seq`` token ids (w: ones)."""
    import numpy as np

    from paddle_tpu_torch import io

    rng = np.random.RandomState(seed)
    arrays = [rng.randint(0, vocab, (n, seq)).astype(np.int64)
              for _ in range(2)]
    if weighted:
        arrays.append(np.ones(n, np.float32))
    ds = io.TensorDataset(arrays)
    sampler = io.BucketedBatchSampler(ds, batch_size=batch, boundaries=[seq],
                                      lengths=[seq] * n, shuffle=True,
                                      seed=0)
    return io.DataLoader(ds, batch_sampler=sampler)


def sup_config():
    """Phase 9's and 16's model: llama_125m's width at SUP_LAYERS layers."""
    import dataclasses

    from paddle_tpu_torch.models import llama_125m

    return dataclasses.replace(llama_125m(), num_hidden_layers=SUP_LAYERS)


def sup_setup(weighted=False):
    """Phase 9's stack: llama_125m (bf16, weights from the seed) with a
    fused AdamW(1e-4) step, and its loader (the same batches on every
    call, in the parent and in ``--supervised-child``)."""
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = sup_config()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    net = loss_weighted(model) if weighted else model
    step = fused_train_step(net, AdamW(learning_rate=1e-4,
                                       parameters=net.parameters()))
    loader = sup_loader(cfg.vocab_size, SUP_BATCH * SUP_EPOCH, SUP_SEQ,
                        SUP_BATCH, SEED + 9, weighted)
    return net, step, loader


def host_state(net, step):
    """(parameters, moments) copied to the host: tensors, fp32 arrays."""
    params = {k: v.detach().cpu().clone()
              for k, v in net.state_dict().items()}
    moments = {k: v for k, v in step.state_dict().items()
               if k.startswith(("m1.", "m2."))}
    return params, moments


def state_diff(a, b):
    """(bit for bit, largest absolute difference) of two ``host_state``s."""
    import numpy as np
    import torch

    same, worst = True, 0.0
    for k, v in a[0].items():
        same &= bool(torch.equal(v, b[0][k]))
        worst = max(worst, float((v.float() - b[0][k].float()).abs().max()))
    for k, v in a[1].items():
        same &= bool(np.array_equal(v, b[1][k]))
        worst = max(worst, float(np.abs(v - b[1][k]).max()))
    return same, worst


def free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def fs_type(path):
    """The file system type of the mount holding ``path`` (/proc/mounts)."""
    best, kind = "", "unknown"
    path = os.path.realpath(path)
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            if len(parts) > 2 and path.startswith(parts[1]) \
                    and len(parts[1]) > len(best):
                best, kind = parts[1], parts[2]
    return f"{kind} at {best}"


def sup_prefetch_arm(prefetch, profile=False):
    """Phase 9a, one arm: a fresh stack from the seed, 2 warm-up and 8
    timed steps through ``drive(prefetch=...)`` (host clock and CUDA
    events), the loader's cursor advanced per trained batch; with
    ``profile``, 4 more steps under the profiler whose flash kernel counts
    must equal the wrappers'. Returns the run and the stack."""
    import torch

    net, step, loader = sup_setup()
    L = net.config.num_hidden_layers
    torch.cuda.synchronize()
    reset_all_launch_counts()
    kw = dict(log_every=SUP_LOG, sampler=loader, prefetch=prefetch)
    warm = step.drive(loader, steps=2, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    hist = step.drive(loader, steps=8, **kw)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 8 * 1e3
    event_ms = start.elapsed_time(end) / 8
    counts = all_launch_counts()
    want = launches_want(**{f"{k}_cuda": L * 10 for k in FLASH})
    check(counts == want, f"prefetch={prefetch} launches {counts} == {want}")
    seen = None
    if profile:
        reset_all_launch_counts()
        prof = device_profile(lambda: step.drive(loader, steps=4, **kw),
                              "train-supervised llama_125m prefetch "
                              "(4 steps)", top=6,
                              mark=("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"))
        launched = all_launch_counts()
        if prof is not None:
            seen = {}
            for key, name in zip(("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"), FLASH):
                seen[name] = sum(n for kname, (_, n) in
                                 prof["kernels"].items() if key in kname)
                check(seen[name] == launched[name + "_cuda"] == L * 4,
                      f"{name}: profiler {seen[name]} == wrapper "
                      f"{launched[name + '_cuda']} == {L} x 4")
    return {"losses": warm["loss"] + hist["loss"], "host_ms": host_ms,
            "event_ms": event_ms, "stats": hist["prefetch"],
            "counts": counts, "seen": seen}, (net, step, loader)


def phase_supervised_prefetch():
    """Phase 9a: ``drive(prefetch=False)`` against ``drive(prefetch=True)``
    from the same weights, interleaved off, on, off, on: losses bit for
    bit, ms/step, the prefetcher's stats, launches. Returns the last
    arm's stack (trained 14 steps) and its ms/step."""
    runs, stack = {False: [], True: []}, None
    for i, prefetch in enumerate((False, True, False, True)):
        run, stack = sup_prefetch_arm(prefetch, profile=i == 3)
        runs[prefetch].append(run)
        if i < 3:
            del stack
            stack = None
            free_cuda()
    ref = runs[False][0]["losses"]
    same = all(r["losses"] == ref for arm in runs.values() for r in arm)
    check(same and all(math.isfinite(x) for x in ref),
          "prefetch on and off: the same losses bit for bit")

    def fmt(arm, key):
        return "/".join(f"{r[key]:.2f}" for r in runs[arm])

    on = runs[True][-1]
    say(f"train-supervised (a) llama_125m prefetch off vs on, 2 + 8 steps "
        f"each: ms/step host {fmt(False, 'host_ms')} vs "
        f"{fmt(True, 'host_ms')}, CUDA events {fmt(False, 'event_ms')} vs "
        f"{fmt(True, 'event_ms')}; losses identical {same} "
        f"{[round(x, 4) for x in ref]}; prefetcher stats {on['stats']}; "
        f"flash launches {[on['counts'][n + '_cuda'] for n in FLASH]} "
        f"({SUP_LAYERS} layers x 10), profiled 4 steps: profiler "
        f"{on['seen'] if on['seen'] is not None else 'not measured'}")
    return stack, statistics.median(r["event_ms"] for r in runs[True])


def phase_supervised_checkpoint(stack, root, ms_ref):
    """Phase 9b: a synchronous and an asynchronous ``CheckpointManager``
    save of the 9a stack at a window boundary: bytes, ms the caller is
    blocked, ms until the save lands; ms/step of the window that trains
    while the asynchronous write is in flight, against a window before
    the saves; the asynchronous snapshot equal to the synchronous one
    (taken at the same step) bit for bit."""
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch import CheckpointManager
    from paddle_tpu_torch.distributed.checkpoint.manager import dir_bytes

    net, step, loader = stack

    def window():
        """(ms/step host clock, CUDA events, ms the loop waited for the
        prefetcher) of one window of 4 steps."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start.record()
        hist = step.drive(loader, steps=SUP_LOG, log_every=SUP_LOG,
                          sampler=loader)
        end.record()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t1) / SUP_LOG * 1e3,
                start.elapsed_time(end) / SUP_LOG,
                hist["prefetch"]["host_blocked_ms"])

    quiet = window()  # the control: no write in flight
    n = step.device_metrics()["step_count"]
    sync = CheckpointManager(os.path.join(root, "sync"), keep_last_n=2)
    t0 = time.perf_counter()
    sync.save(n, model=net, optimizer=step, sampler=loader)
    sync_ms = (time.perf_counter() - t0) * 1e3
    nbytes = dir_bytes(sync.step_dir(n))
    amgr = CheckpointManager(os.path.join(root, "async"), keep_last_n=2,
                             async_save=True)
    landed = []
    t0 = time.perf_counter()
    handle = amgr.save(n, model=net, optimizer=step, sampler=loader)
    blocked_ms = (time.perf_counter() - t0) * 1e3

    def watch():
        while not handle.done():
            time.sleep(0.002)
        landed.append(time.perf_counter())

    watcher = threading.Thread(target=watch, name="ckpt-watch")
    watcher.start()
    busy = window()
    in_flight = not landed
    amgr.wait()
    watcher.join(timeout=600)
    check(not watcher.is_alive() and landed, "the async save landed")
    lands_ms = (landed[0] - t0) * 1e3
    a, b = (np.load(os.path.join(m.step_dir(n), "rank0.npz"))
            for m in (sync, amgr))
    same = sorted(a.files) == sorted(b.files) and all(
        np.array_equal(a[k], b[k]) for k in a.files)
    a.close()
    b.close()
    check(same and amgr.latest_valid_step() == sync.latest_valid_step() == n,
          "the async snapshot equals the sync save of the same step")
    say(f"train-supervised (b) checkpoint of llama_125m at step {n} "
        f"({fs_type(root)}): {nbytes} bytes; sync save blocks "
        f"{sync_ms:.1f} ms (landed); async save blocks {blocked_ms:.1f} ms, "
        f"lands after {lands_ms:.1f} ms (in flight through the next window "
        f"{in_flight}); that window's ms/step host {busy[0]:.2f}, CUDA "
        f"events {busy[1]:.2f}, prefetch waits {busy[2]:.1f} ms, against "
        f"{quiet[0]:.2f} / {quiet[1]:.2f} / {quiet[2]:.1f} ms for the "
        f"window before the saves (9a prefetch median {ms_ref:.2f}); "
        f"async snapshot = sync save bit for bit {same}")


def phase_supervised_resume(root):
    """Phase 9c: the uninterrupted run (16 steps, a checkpoint at step 4,
    the state copied to the host at step 8), then a fresh stack resumed
    from step 4 in place drives 4 steps: its losses, parameters and
    moments equal the uninterrupted run's at step 8. Returns that run's
    16 losses (9e's reference)."""
    from paddle_tpu_torch import CheckpointManager

    net, step, loader = sup_setup()
    mgr = CheckpointManager(os.path.join(root, "resume"), keep_last_n=2)
    snap = {}

    def on_window(win):
        n = step.device_metrics()["step_count"]
        if n == 4:
            mgr.save(4, model=net, optimizer=step, sampler=loader)
        if n == 8:
            snap["state"] = host_state(net, step)

    whole = step.drive(loader, steps=SUP_CHILD_STEPS, log_every=SUP_LOG,
                       checkpoint=mgr, on_window=on_window)["loss"]
    del net, step, loader
    free_cuda()
    net, step, loader = sup_setup()
    ptrs = [p.data_ptr() for p in net.parameters()]
    t0 = time.perf_counter()
    check(mgr.auto_resume(model=net, optimizer=step, sampler=loader,
                          step=4) == 4, "auto_resume restored step 4")
    restore_ms = (time.perf_counter() - t0) * 1e3
    check([p.data_ptr() for p in net.parameters()] == ptrs,
          "the restore wrote the parameters in place")
    rest = step.drive(loader, steps=4, log_every=SUP_LOG,
                      sampler=loader)["loss"]
    same, worst = state_diff(host_state(net, step), snap["state"])
    say(f"train-supervised (c) resume from step 4 ({restore_ms:.1f} ms to "
        f"restore): losses 5-8 {[round(x, 5) for x in rest]} vs "
        f"uninterrupted {[round(x, 5) for x in whole[4:8]]}, equal "
        f"{rest == whole[4:8]}; parameters and moments at step 8 bit for "
        f"bit {same} (max abs diff {worst:.3e})")
    check(rest == whole[4:8] and same,
          "the resumed run equals the uninterrupted one bit for bit")
    return whole, (net, step, loader)


def phase_supervised_stall(stack):
    """Phase 9f: ``FLAGS_step_timeout_s`` 2 with the ``train.stall`` site
    armed: ``drive`` raises ``TrainStallError``."""
    from paddle_tpu_torch import TrainStallError, set_flags
    from paddle_tpu_torch.utils import fault_injection

    net, step, loader = stack
    set_flags({"FLAGS_step_timeout_s": 2.0})
    stalled = None
    t0 = time.perf_counter()
    try:
        with fault_injection.inject("train.stall", every_n=2):
            step.drive(loader, steps=4, log_every=SUP_LOG, sampler=loader)
    except TrainStallError as e:
        stalled = e
    finally:
        set_flags({"FLAGS_step_timeout_s": 0.0})
    wall = time.perf_counter() - t0
    say(f"train-supervised (f) stall: FLAGS_step_timeout_s 2, train.stall "
        f"armed: {type(stalled).__name__ if stalled else 'nothing'} raised "
        f"after {wall:.2f} s ({stalled})")
    check(stalled is not None and wall < 60, "the stall guard raised")


def phase_supervised_rollback(root):
    """Phase 9d: ``FLAGS_sentinel_action=rollback`` (z-score 6, 2 warm-up
    windows, healthy after 1 clean window), the weighted llama_125m, 16
    steps in windows of 4 with checkpoints at steps 8 and 12, and the
    ``train.spike`` site armed over window 4 (the loss x 1e3: a z-score
    far past 6 for certain). One rollback, to step 8, in place and bit for
    bit; the cursor stays past the poisoned batches; 8 more steps
    finite."""
    import numpy as np
    import torch

    from paddle_tpu_torch import CheckpointManager, load, set_flags
    from paddle_tpu_torch.distributed.checkpoint import load_state_dict
    from paddle_tpu_torch.utils import fault_injection

    set_flags({"FLAGS_sentinel_action": "rollback",
               "FLAGS_sentinel_warmup_windows": 2,
               "FLAGS_sentinel_healthy_windows": 1})
    try:
        net, step, loader = sup_setup(weighted=True)
        mgr = CheckpointManager(os.path.join(root, "rollback"),
                                keep_last_n=2)
        state = {"w": 0, "cm": None}

        def on_window(win):
            state["w"] += 1
            if state["cm"] is not None:
                state["cm"].__exit__(None, None, None)
                state["cm"] = None
            if state["w"] in (2, 3):
                mgr.save(step.device_metrics()["step_count"], model=net,
                         optimizer=step, sampler=loader)
            if state["w"] == 3:
                state["cm"] = fault_injection.inject("train.spike")
                state["cm"].__enter__()

        ptrs = [p.data_ptr() for p in net.parameters()]
        t0 = time.perf_counter()
        hist = step.drive(loader, steps=4 * SUP_LOG, log_every=SUP_LOG,
                          checkpoint=mgr, on_window=on_window)
        wall = time.perf_counter() - t0
        check(hist["rollbacks"] == 1 and hist["sentinel"]["spikes"] == 1,
              f"one spike, one rollback ({hist['sentinel']})")
        check([p.data_ptr() for p in net.parameters()] == ptrs,
              "the rollback restored the parameters in place")
        ref = {k: v.detach().cpu().clone()
               for k, v in net.state_dict().items()}
        load_state_dict(ref, mgr.step_dir(8))
        opt = load(os.path.join(mgr.step_dir(8), "optimizer.pdopt"))
        now = host_state(net, step)
        same = all(torch.equal(now[0][k], ref[k]) for k in ref) and all(
            np.array_equal(v, opt[k]) for k, v in now[1].items())
        cursor = loader.state_dict()["cursor"]
        check(same and step.device_metrics()["step_count"] == 8
              and cursor == 16 and mgr.committed_steps() == [8],
              f"restored step 8 bit for bit ({same}), the cursor at 16 "
              f"({cursor}), newer checkpoints dropped "
              f"({mgr.committed_steps()})")
        after = step.drive(loader, steps=2 * SUP_LOG, log_every=SUP_LOG,
                           checkpoint=mgr)
        check(after["rollbacks"] == 0
              and all(math.isfinite(x) and x < 100 for x in after["loss"])
              and loader.state_dict()["cursor"] == 24,
              f"8 more steps finite and unpoisoned {after['loss']}")
    finally:
        set_flags({"FLAGS_sentinel_action": "none",
                   "FLAGS_sentinel_warmup_windows": 3,
                   "FLAGS_sentinel_healthy_windows": 2})
    say(f"train-supervised (d) rollback: losses "
        f"{[round(x, 3) for x in hist['loss']]} then "
        f"{[round(x, 4) for x in after['loss']]}; rollbacks "
        f"{hist['rollbacks']} to step 8 in {wall:.2f} s for 16 steps, "
        f"parameters and moments = checkpoint step 8 bit for bit {same}, "
        f"data_ptr() kept, cursor 16 (poisoned batches 13-16 not replayed), "
        f"sentinel {hist['sentinel']}")


def supervised_child(root, total):
    """``chip_smoke.py --supervised-child ROOT TOTAL``: phase 9's stack
    resumed from ``ROOT/ckpt`` (if committed), trained to ``TOTAL`` steps
    through ``drive`` with the default heartbeats and SIGTERM handling;
    prints its start and losses on one line (no result line)."""
    import torch

    from paddle_tpu_torch import CheckpointManager

    if not torch.cuda.is_available():
        print("chip_smoke --supervised-child: no CUDA device",
              file=sys.stderr)
        return 1
    net, step, loader = sup_setup()
    mgr = CheckpointManager(os.path.join(root, "ckpt"), keep_last_n=2)
    start = mgr.auto_resume(model=net, optimizer=step, sampler=loader) or 0
    hist = step.drive(loader, steps=total - start, log_every=SUP_LOG,
                      checkpoint=mgr)
    say(SUP_CHILD_MARK + json.dumps({"start": start, "loss": hist["loss"]}))
    return 0


def phase_supervised_preemption(root, whole):
    """Phase 9e: a ``--supervised-child`` with ``PADDLE_HEARTBEAT_DIR`` set
    gets SIGTERM once a heartbeat shows a step past the first window: it
    exits 123 with a committed checkpoint; a relaunched child resumes and
    finishes with the uninterrupted run's losses (9c's) bit for bit."""
    import signal

    from paddle_tpu_torch import CheckpointManager
    from paddle_tpu_torch.distributed.launch import heartbeat as hb

    run_root = os.path.join(root, "preempt")
    hb_dir = os.path.join(run_root, "hb")
    env = dict(os.environ, PADDLE_HEARTBEAT_DIR=hb_dir, PADDLE_TRAINER_ID="0")
    cmd = [sys.executable, os.path.abspath(__file__), "--supervised-child",
           run_root, str(SUP_CHILD_STEPS)]
    procs = []
    try:
        t0 = time.perf_counter()
        first = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
        procs.append(first)
        beat = None
        while time.perf_counter() - t0 < 600 and first.poll() is None:
            beat = hb.read_all(hb_dir).get("0", {}).get("step")
            if beat is not None and beat > SUP_LOG:
                break
            time.sleep(0.02)
        check(first.poll() is None and beat is not None and beat > SUP_LOG,
              f"the child heartbeat a step past the first window ({beat})")
        first.send_signal(signal.SIGTERM)
        out1, err1 = first.communicate(timeout=600)
        t_first = time.perf_counter() - t0
        saved = CheckpointManager(os.path.join(run_root, "ckpt")) \
            .latest_valid_step()
        check(first.returncode == hb.PREEMPT_EXIT_CODE and saved is not None
              and saved % SUP_LOG == 0 and SUP_LOG < saved < SUP_CHILD_STEPS,
              f"the child exited {first.returncode} with a committed "
              f"checkpoint at {saved}: {err1[-2000:]}")
        t1 = time.perf_counter()
        second = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env)
        procs.append(second)
        out2, err2 = second.communicate(timeout=600)
        t_second = time.perf_counter() - t1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(second.returncode == 0,
          f"the relaunched child finished: {err2[-2000:]}")
    line = next(ln for ln in out2.splitlines()
                if ln.startswith(SUP_CHILD_MARK))
    res = json.loads(line[len(SUP_CHILD_MARK):])
    final = hb.read_all(hb_dir)["0"]["step"]
    quiet = not any('"ok"' in o for o in (out1, out2))
    say(f"train-supervised (e) preemption: SIGTERM after the heartbeat at "
        f"step {beat}; the child exited {first.returncode} after "
        f"{t_first:.1f} s with checkpoint step {saved}; the relaunch "
        f"resumed at {res['start']}, finished step {final} after "
        f"{t_second:.1f} s, losses {[round(x, 5) for x in res['loss']]} = "
        f"uninterrupted {res['loss'] == whole[saved:]}; no result line in "
        f"the children's output {quiet}")
    check(res["start"] == saved and final == SUP_CHILD_STEPS
          and res["loss"] == whole[saved:] and quiet,
          "the relaunched child resumed and matched the uninterrupted run")


def perturbed(state, noise=SUP_TINY_NOISE, seed=SEED):
    """numpy ``state`` times (1 + noise * N(0, 1)), drawn per tensor in
    name order, in float64, rounded to fp32."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {k: (v.astype(np.float64) * (1.0 + noise * rng.standard_normal(
        v.shape))).astype(np.float32) for k, v in sorted(state.items())}


def phase_supervised_card_vs_cpu():
    """Phase 9g: fp32 llama_tiny (weighted loss, AdamW with epsilon 1e-6
    at each of ``SUP_TINY_LRS``) through ``drive`` with prefetch, a
    checkpoint a window, the ``train.spike`` site over window 4 and a
    rollback sentinel, 12 steps in windows of 2; then a fresh stack
    resumed from the newest checkpoint drives 4 more. Each lr runs on the
    CPU and on the card, and again on both from weights perturbed by
    ``SUP_TINY_NOISE`` (each device's rounding floor: the run against
    itself). At lr 1e-4 the card and the CPU give the same losses (rtol)
    and parameters (atol) at ``TRAIN_*``; at every lr the card-vs-CPU
    parameter difference stays within ``SUP_FLOOR_MULTIPLE`` of the
    larger floor."""
    import shutil
    import tempfile

    import numpy as np

    from paddle_tpu_torch import CheckpointManager
    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.incubate.sentinel import TrainingSentinel
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                         load_paddle_tpu_state_dict,
                                         to_numpy_state_dict)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import fault_injection

    cfg = llama_tiny()
    rng = np.random.RandomState(SEED + 10)
    shapes = LlamaForCausalLM(cfg, device="cpu").state_dict()
    state = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in shapes.items()}
    bumped = perturbed(state)

    def stack(dev, weights, lr):
        model = LlamaForCausalLM(cfg, device=dev)
        load_paddle_tpu_state_dict(model, weights)
        net = loss_weighted(model)
        step = fused_train_step(net, AdamW(
            learning_rate=lr, epsilon=1e-6, parameters=net.parameters()))
        return net, step, sup_loader(cfg.vocab_size, 24, 64, 2, SEED + 11,
                                     weighted=True)

    def run(root, dev, weights, lr):
        net, step, loader = stack(dev, weights, lr)
        mgr = CheckpointManager(root, keep_last_n=3)
        sentinel = TrainingSentinel(action="rollback", zscore=4.0,
                                    warmup_windows=2, ema_beta=0.8,
                                    healthy_windows=1)
        st = {"w": 0, "cm": None}

        def on_window(win):
            mgr.save(step.device_metrics()["step_count"], model=net,
                     optimizer=step, sampler=loader)
            st["w"] += 1
            if st["cm"] is not None:
                st["cm"].__exit__(None, None, None)
                st["cm"] = None
            if st["w"] == 3:
                st["cm"] = fault_injection.inject("train.spike")
                st["cm"].__enter__()

        hist = step.drive(loader, log_every=2, checkpoint=mgr,
                          on_window=on_window, sentinel=sentinel)
        net2, step2, loader2 = stack(dev, weights, lr)
        resumed = mgr.auto_resume(model=net2, optimizer=step2,
                                  sampler=loader2)
        more = step2.drive(loader2, steps=4, log_every=2,
                           sampler=loader2)["loss"]
        return (hist["loss"] + more, hist["rollbacks"], resumed,
                to_numpy_state_dict(net2))

    root = tempfile.mkdtemp(prefix="supervised-tiny-")
    try:
        for lr in SUP_TINY_LRS:
            out = {}
            for name, dev, weights in (("cpu", "cpu", state),
                                       ("cuda", "cuda", state),
                                       ("cpu_floor", "cpu", bumped),
                                       ("cuda_floor", "cuda", bumped)):
                out[name] = run(os.path.join(root, f"{lr:g}-{name}"), dev,
                                weights, lr)

            def param_diff(a, b):
                return max(float(np.abs(out[a][3][k] - out[b][3][k]).max())
                           for k in out[b][3])

            lc, lg = out["cpu"][0], out["cuda"][0]
            dl = max(abs(a / b - 1) for a, b in zip(lg, lc))
            dp = param_diff("cuda", "cpu")
            floors = (param_diff("cpu_floor", "cpu"),
                      param_diff("cuda_floor", "cuda"))
            floor = max(floors)
            say(f"train-supervised (g) card vs cpu llama_tiny fp32 (AdamW "
                f"lr {lr:g}), 12 steps with a spike window and a rollback, "
                f"then 4 resumed: rollbacks cuda {out['cuda'][1]} cpu "
                f"{out['cpu'][1]}, resumed at {out['cuda'][2]}/"
                f"{out['cpu'][2]}; losses max rel diff {dl:.3e} (tol "
                f"{TRAIN_LOSS_RTOL:g}); parameters max abs diff {dp:.3e}; "
                f"rounding's floor, each device against itself from weights "
                f"perturbed by {SUP_TINY_NOISE:g}: cpu {floors[0]:.3e}, "
                f"cuda {floors[1]:.3e}; card vs cpu / larger floor "
                f"{dp / floor:.3f} (limit {SUP_FLOOR_MULTIPLE:g})")
            check(all(out[k][1] == 1 and out[k][2] == out["cpu"][2]
                      and len(out[k][0]) == 16 for k in out)
                  and dl <= TRAIN_LOSS_RTOL
                  and 0 < floor and dp <= SUP_FLOOR_MULTIPLE * floor
                  and (lr != 1e-4 or dp <= TRAIN_PARAM_ATOL),
                  f"card and CPU agree through the supervised loop at lr "
                  f"{lr:g}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_supervised():
    """Phase 9: the supervised loop (9a-9g) on llama_125m's full width at
    SUP_LAYERS layers (flash #3-#5) and fp32 llama_tiny; its checkpoints live in a
    temporary directory removed at the end. Returns 9c's uninterrupted
    losses (phase 16's reference)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="supervised-")
    try:
        stack, ms_ref = timed(phase_supervised_prefetch)
        timed(phase_supervised_checkpoint, stack, root, ms_ref)
        del stack
        free_cuda()
        whole, stack = timed(phase_supervised_resume, root)
        timed(phase_supervised_stall, stack)
        del stack
        free_cuda()
        timed(phase_supervised_rollback, root)
        free_cuda()
        timed(phase_supervised_preemption, root, whole)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timed(phase_supervised_card_vs_cpu)
    return whole


# -- serving artifacts -------------------------------------------------------

# phase 10: LLMEngine's arguments (phase 4's pool and batch, windows of 8)
# phases 10 to 14 serve llama_1b's width at this depth (22 layers in
# phase 4): their artifact files, boots and captures scale with the
# layers, and the whole smoke has to fit its time limit on the slower
# hosts
SERVE_CUT_LAYERS = 8


def serve_cut_config():
    """llama_1b's width at SERVE_CUT_LAYERS layers."""
    import dataclasses

    from paddle_tpu_torch.models import llama_1b

    return dataclasses.replace(llama_1b(), num_hidden_layers=SERVE_CUT_LAYERS)


ART_ENGINE = dict(num_blocks=2048, block_size=16, max_batch_size=8,
                  decode_steps_per_sync=SERVE_WINDOW)
ART_NEW = 32
# the reference's int8 contract (tests/test_quantized_serving.py:39)
LOGIT_REL_TOL = 0.08
# the converted int8 model against its fake-quant simulation
# (tests/test_quantization.py:206-240)
PTQ_ATOL = 2e-4


def padded_batch(prompts):
    """(ids [B, longest] int32 zero-padded, seq_lens [B])."""
    import numpy as np

    lens = np.array([len(p) for p in prompts])
    ids = np.zeros((len(prompts), lens.max()), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    return ids, lens


def engine_tokens(model, prompts, **kw):
    """Greedy tokens of an ``LLMEngine`` over ``model`` (phase 10's pool;
    ``kw`` overrides), after a warm-up request."""
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    with LLMEngine(model, device="cuda", **{**ART_ENGINE, **kw}) as eng:
        eng.generate([prompts[1][:64]], SamplingParams(max_new_tokens=2))
        return eng.generate(prompts, SamplingParams(max_new_tokens=ART_NEW))


def first_logits(model, prompts, **kw):
    """Each prompt's first-token logits through a per-step engine with
    ``capture_logits`` (the prefill's last row, fp32 numpy)."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    out = []
    with LLMEngine(model, device="cuda", capture_logits=True,
                   **{**ART_ENGINE, "decode_steps_per_sync": 1, **kw}) as eng:
        for p in prompts:
            rid = eng.add_request(p, SamplingParams(max_new_tokens=1))
            for _ in eng.stream():
                pass
            out.append(np.asarray(eng.request(rid).last_logits, np.float32))
            eng.release(rid)
    return out


def timed_ms(fn, *args, **kwargs):
    """(fn(...), its wall ms after a device sync)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def artifact_bytes(path):
    return sum(os.path.getsize(path + ext) for ext in (
        ".llamacfg.json", ".pdiparams", ".qscales.pdiparams", ".quant.json")
        if os.path.exists(path + ext))


def predictor_run(pred, batch, label):
    """``pred.run`` over ``batch`` counted: the paged kernels' launches
    must be layers x decode iterations (#1, through graph replays) and
    layers x prefill chunks (#2). Returns (tokens, wall s, counts)."""
    import torch

    from paddle_tpu_torch.ops.cuda import paged_attention as K

    eng = pred.engine
    eng.reset_metrics()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = pred.run(list(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    m = eng.metrics()
    L = eng.config.num_hidden_layers
    check(m["finished"] == len(outs) and all(
        len(o) == n + ART_NEW for o, n in zip(outs, batch[1])),
        f"{label}: every request finished")
    check(counts["paged_decode_attention_cuda"] == L * m["decode_steps"] > 0
          and counts["paged_multiquery_attention_cuda"]
          == L * m["prefill_chunks"] > 0,
          f"{label}: launches {counts} == {L} x ({m['decode_steps']} decode "
          f"iterations, {m['prefill_chunks']} chunks)")
    say(f"serve-artifact {label}: {len(outs)} requests x {ART_NEW} new "
        f"tokens in {wall:.3f} s, {len(outs) * ART_NEW / wall:.1f} tokens/s, "
        f"itl p50 {m['itl_ms'].get('p50')} ms, host syncs "
        f"{m['host_syncs']}, prefill chunks {m['prefill_chunks']}, "
        f"launches {counts}")
    return outs, wall, counts


def same_tokens(a, b):
    return len(a) == len(b) and all((x == y).all() for x, y in zip(a, b))


def phase_artifact_bf16(root, where, prompts, batch):
    """Phase 10a-b: llama_1b bf16 saved as an artifact, served by
    ``create_predictor`` (default dtype bf16) bit for bit as an engine
    over the in-memory model, the paged kernels' launches equal to the
    profiler's; then ``reload_weights`` in place under the captured
    window graph, from the artifact and from a ``CheckpointManager``.
    Returns the counted run's launches."""
    import torch

    from paddle_tpu_torch import CheckpointManager, set_default_dtype
    from paddle_tpu_torch.inference import (Config, LLMEnginePredictor,
                                            create_predictor)
    from paddle_tpu_torch.inference.serving import (quantize_state_dict,
                                                    save_llama_artifact)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    cfg = serve_cut_config()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    art = os.path.join(root, "llama_1b_bf16")
    _, save_ms = timed_ms(save_llama_artifact, model, art)
    nbytes = artifact_bytes(art)
    packed, scales = quantize_state_dict(model.state_dict())
    passthrough = len(packed) - len(scales)
    say(f"serve-artifact (a) llama_1b bf16 ({n_params} params): artifact "
        f"{nbytes} bytes ({nbytes / (2 * n_params):.4f} x 2 bytes a "
        f"parameter), saved in {save_ms:.1f} ms to TMPDIR ({where}); "
        f"quantize_state_dict of this bf16 model quantizes {len(scales)} "
        f"and passes {passthrough} of {len(packed)} through (the "
        f"reference's rule: bf16 is not a numpy float kind)")
    check(len(scales) == 0
          and passthrough == len(packed) == len(model.state_dict()),
          "a bf16 model's int8 packing is all passthrough")
    del packed
    ref = engine_tokens(model, prompts)
    del model
    free_cuda()
    set_default_dtype("bfloat16")
    try:
        pred, load_ms = timed_ms(
            create_predictor,
            Config(art).enable_llm_engine(max_new_tokens=ART_NEW,
                                          **ART_ENGINE))
    finally:
        set_default_dtype("float32")
    eng = pred.engine
    check(isinstance(pred, LLMEnginePredictor)
          and eng.model.dtype == torch.bfloat16
          and eng.device == torch.device("cuda:0"),
          "create_predictor gave an LLMEnginePredictor over bf16 weights on "
          "cuda:0")
    # warm-up: cuBLAS, the allocator, the window graph's capture
    pred.run([batch[0][:1, :64], [64]])
    outs, wall, counts = predictor_run(pred, batch, "(a) predictor bf16")
    same = same_tokens(outs, ref)
    say(f"serve-artifact (a) predictor loaded in {load_ms:.1f} ms from "
        f"TMPDIR ({where}); tokens equal an LLMEngine over the in-memory "
        f"model, same windows: {same}")
    check(same, "the predictor's tokens equal the in-memory engine's")
    reset_paged_counts()
    prof = device_profile(lambda: pred.run(list(batch)),
                          "serve-artifact (a) predictor (same batch again)",
                          mark=("paged_decode", "paged_multiquery"))
    check_device_launches(prof, K.launch_counts(), "serve-artifact (a)")

    # (b) hot swap in place under the captured window graph
    window = eng._window
    check(window is not None and window.graph is not None,
          "the window graph is captured")
    graph, replays = window.graph, window.replays
    ptrs = [p.data_ptr() for p in eng.model.parameters()]
    with torch.no_grad():
        eng.model.llama.embed_tokens.weight.add_(1.0)
    poisoned = pred.run(list(batch))
    check(not same_tokens(poisoned, ref), "poisoned weights change tokens")
    got, reload_ms = timed_ms(eng.reload_weights, art)
    after = pred.run(list(batch))
    kept = [p.data_ptr() for p in eng.model.parameters()] == ptrs
    same_graph = eng._window is window and window.graph is graph
    check(got is None and same_tokens(after, ref) and kept and same_graph
          and window.replays > replays,
          f"reload_weights(artifact): None ({got}), tokens restored, "
          f"data_ptr() kept ({kept}), the same graph replayed "
          f"({same_graph}, replays {replays} -> {window.replays})")
    mgr = CheckpointManager(os.path.join(root, "ckpt"))
    _, ckpt_ms = timed_ms(mgr.save, 3, model=eng.model)
    mgr.tag_healthy(3)
    with torch.no_grad():
        eng.model.llama.embed_tokens.weight.add_(1.0)
    step, mgr_ms = timed_ms(eng.reload_weights, mgr)
    after = pred.run(list(batch))
    kept = [p.data_ptr() for p in eng.model.parameters()] == ptrs
    same_graph = eng._window is window and window.graph is graph
    check(step == 3 and same_tokens(after, ref) and kept and same_graph,
          f"reload_weights(manager): step 3 ({step}), tokens restored, "
          f"data_ptr() kept ({kept}), the same graph ({same_graph})")
    say(f"serve-artifact (b) hot swap under the captured window graph: "
        f"poisoned tokens differ; reload_weights(artifact) {reload_ms:.1f} "
        f"ms, reload_weights(CheckpointManager step 3) {mgr_ms:.1f} ms "
        f"(checkpoint saved in {ckpt_ms:.1f} ms), both from TMPDIR "
        f"({where}); tokens restored bit for bit, every data_ptr() kept, "
        f"no recapture (graph replays {replays} -> {window.replays})")
    pred.close()
    return counts, wall


def rel_err(got, want):
    """The reference's logit error: max |got - want| / max |want|, the
    worst over the prompts."""
    import numpy as np

    return max(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))
               for a, b in zip(got, want))


def int8_artifact_predictor(model, path, prompts):
    """``model`` (fp32) saved with ``quantize="int8"`` at ``path`` and
    served by a predictor over an int8 KV pool; returns (predictor, the
    fp32 model's first-token logits over an fp32 pool and over an int8
    pool, the predictor's over both, ms of the save and the load)."""
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.inference.serving import save_llama_artifact

    _, save_ms = timed_ms(save_llama_artifact, model, path, quantize="int8")
    ref = first_logits(model, prompts)
    kv = first_logits(model, prompts, kv_dtype="int8")
    pred, load_ms = timed_ms(create_predictor, Config(path).enable_llm_engine(
        max_new_tokens=ART_NEW, kv_dtype="int8", **ART_ENGINE))
    w = first_logits(pred.engine.model, prompts)
    both = first_logits(pred.engine.model, prompts, kv_dtype="int8")
    return pred, {"ref": ref, "kv": kv, "w": w, "both": both}, save_ms, \
        load_ms


def phase_artifact_int8(root, where, prompts, batch):
    """Phase 10c: llama_1b fp32 saved with ``quantize="int8"`` (the codes
    made on the card, a sample held to the numpy quantizer bit for bit),
    loaded in fp32 and served by a predictor over an int8 KV pool: its
    first-token logits against the fp32 model's (the weights' and the
    pool's shares of the error apart), token agreement and tokens/s
    reported, the loaded artifact's logits on the card equal to the CPU's
    plain forward of the same file within ``ATOL`` (the full-width gate
    of the int8 path), a reload of the artifact bit for bit. The reference's
    ``LOGIT_REL_TOL`` is held where it defines it, on llama_tiny
    (``tests/test_quantized_serving.py``): the same path on the card."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.serving import (load_llama_artifact,
                                                    quantize_state_dict)
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.nn.layer.layers import set_state_dict
    from paddle_tpu_torch.quantization.base import per_channel_int8

    tiny = LlamaForCausalLM(llama_tiny(), device="cuda", dtype=torch.float32,
                            seed=SEED)
    rng = np.random.RandomState(SEED + 13)
    tiny_prompts = [rng.randint(0, 512, n).astype(np.int32)
                    for n in rng.randint(5, 200, 8)]
    pred, lg, _, _ = int8_artifact_predictor(
        tiny, os.path.join(root, "llama_tiny_int8"), tiny_prompts)
    pred.close()
    tiny_rel = rel_err(lg["both"], lg["ref"])
    say(f"serve-artifact (c) llama_tiny fp32 -> int8 artifact -> predictor "
        f"over an int8 pool: first-token logits max rel err {tiny_rel:.4f} "
        f"(the reference's LOGIT_REL_TOL {LOGIT_REL_TOL}, defined on this "
        f"model); int8 weights alone {rel_err(lg['w'], lg['ref']):.4f}, "
        f"int8 KV alone {rel_err(lg['kv'], lg['ref']):.4f}")
    check(tiny_rel < LOGIT_REL_TOL, f"llama_tiny int8 first-token logits "
          f"rel err {tiny_rel} < {LOGIT_REL_TOL}")
    del tiny, pred

    cfg = serve_cut_config()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float32,
                             seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    (packed, scales), quant_ms = timed_ms(quantize_state_dict,
                                          model.state_dict())
    sd = model.state_dict()
    for name in ("llama.layers.0.self_attn.q_proj.weight",
                 "llama.layers.0.mlp.down_proj.weight"):
        codes, absmax = per_channel_int8(sd[name].cpu().numpy())
        check(np.array_equal(codes, packed[name]) and np.array_equal(
            (absmax / 127.0).astype(np.float32), scales[name]),
            f"{name}: the card's codes and scales = numpy's bit for bit")
    n_q, n_pass = len(scales), len(packed) - len(scales)
    del packed, scales, sd
    ref_tokens = engine_tokens(model, prompts)
    art = os.path.join(root, "llama_1b_int8")
    pred, lg, save_ms, load_ms = int8_artifact_predictor(model, art, prompts)
    nbytes = artifact_bytes(art)
    # the int8 weights' error on one short prompt, on the card and, by the
    # plain PyTorch forward, on the CPU: the same number on both says the
    # error is the quantization's on this model, not the card's
    short = torch.from_numpy(prompts[0][None, :64].astype(np.int64))
    with torch.no_grad():
        card = [m(short.cuda())[0, -1].cpu().numpy()
                for m in (model, pred.engine.model)]
        state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    free_cuda()
    cpu = LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32)
    set_state_dict(cpu, state)
    del state
    with torch.no_grad():
        host = [m(short)[0, -1].numpy()
                for m in (cpu, load_llama_artifact(art, device="cpu"))]
    del cpu
    short_rel = (rel_err([card[1]], [card[0]]), rel_err([host[1]], [host[0]]))
    # the full-width int8 path's own gate: the card's forward of the
    # loaded artifact against the CPU's plain forward of the same file,
    # both fp32 (TF32 off), beside the same comparison of the fp32 model
    card_cpu = [float(np.abs(c - h).max()) for c, h in zip(card, host)]
    say(f"serve-artifact (c) llama_1b on a 64-token prompt, card vs CPU "
        f"plain forward, last-position logits max abs diff: int8 artifact "
        f"{card_cpu[1]:.3e} (tol {ATOL:g}), fp32 model {card_cpu[0]:.3e}; "
        f"logits max |x| {float(np.abs(host[1]).max()):.3f}")
    check(card_cpu[1] <= ATOL, f"llama_1b int8 artifact: card = CPU within "
          f"{ATOL:g} ({card_cpu[1]:.3e})")
    eng = pred.engine
    check(eng.model.dtype == torch.float32 and eng.kv_dtype == "int8",
          "the int8 artifact serves in fp32 over an int8 pool")
    pred.run([batch[0][:1, :64], [64]])
    outs, wall, counts = predictor_run(pred, batch, "(c) predictor int8")
    agree = np.mean([float(np.mean(o[n:] == r[n:]))
                     for o, r, n in zip(outs, ref_tokens, batch[1])])
    got, reload_ms = timed_ms(eng.reload_weights, art)
    again = pred.run(list(batch))
    rel = {k: rel_err(lg[k], lg["ref"]) for k in ("both", "w", "kv")}
    say(f"serve-artifact (c) llama_1b fp32 -> int8: quantize_state_dict "
        f"{quant_ms:.1f} ms on the card (with its device-to-host copies), "
        f"save_llama_artifact(quantize='int8') {save_ms:.1f} ms (its own "
        f"quantize included) to TMPDIR ({where}); artifact {nbytes} bytes "
        f"against {4 * n_params} for fp32 weights "
        f"({nbytes / (4 * n_params):.4f}); {n_q} tensors quantized, {n_pass} "
        f"passed through; loaded in {load_ms:.1f} ms; first-token logits "
        f"max rel err against the fp32 model (reported): {rel['both']:.4f} "
        f"with int8 weights and int8 KV, {rel['w']:.4f} with the weights "
        f"alone, {rel['kv']:.4f} with the KV alone; the weights alone on "
        f"a 64-token prompt {short_rel[0]:.4f} on the card, "
        f"{short_rel[1]:.4f} on the CPU (plain forward); greedy tokens agree "
        f"with the fp32 model's on {agree:.4f} of generated positions "
        f"(reported); {len(outs) * ART_NEW / wall:.1f} tokens/s; "
        f"reload_weights {reload_ms:.1f} ms, tokens unchanged: "
        f"{same_tokens(again, outs)}")
    check(got is None and same_tokens(again, outs),
          "reloading the int8 artifact leaves the tokens bit for bit")
    pred.close()
    return counts


def phase_ptq():
    """Phase 10d: PTQ on llama_125m fp32 (abs-max activations, per-channel
    weights), calibrated over 4 seeded batches: the converted model's
    logits equal the fake-quant simulation's within ``PTQ_ATOL``, and its
    int8 codes equal the same flow's on the CPU bit for bit."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_125m,
                                         load_paddle_tpu_state_dict,
                                         to_numpy_state_dict)
    from paddle_tpu_torch.quantization import (PTQ, QuantConfig,
                                               QuantedLinear)
    from paddle_tpu_torch.quantization.base import fake_quant
    from paddle_tpu_torch.quantization.observers import (
        AbsmaxObserver, PerChannelAbsmaxObserver)

    cfg = llama_125m()
    rng = np.random.RandomState(SEED + 12)
    batches = [rng.randint(0, cfg.vocab_size, (2, 128)) for _ in range(4)]
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))

    def flow(model, dev):
        ptq = PTQ(QuantConfig(activation=AbsmaxObserver(),
                              weight=PerChannelAbsmaxObserver()))
        qm, q_ms = timed_ms(ptq.quantize, model)
        n, c_ms = timed_ms(ptq.calibrate, qm, [torch.from_numpy(b).to(dev)
                                               for b in batches])
        conv, v_ms = timed_ms(ptq.convert, qm)
        return qm, conv, (q_ms, c_ms, v_ms)

    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float32,
                             seed=SEED)
    state = to_numpy_state_dict(model)
    qm, conv, ms = flow(model, "cuda")
    with torch.no_grad():
        got = conv(x.cuda()).cpu().numpy()
        # the simulation: each weight fake-quantized at its frozen scales
        for mod in qm.modules():
            if isinstance(mod, QuantedLinear):
                w = mod._inner.weight
                w.copy_(fake_quant(w, mod.weight_quanter.scales()))
        sim = qm(x.cuda()).cpu().numpy()
    err = float(np.abs(got - sim).max())
    codes = {n: m.weight_q.cpu().numpy() for n, m in conv.named_modules()
             if hasattr(m, "weight_q")}
    del model, qm, conv
    free_cuda()
    cpu = LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32)
    load_paddle_tpu_state_dict(cpu, state)
    _, cpu_conv, _ = flow(cpu, "cpu")
    cpu_codes = {n: m.weight_q.numpy() for n, m in cpu_conv.named_modules()
                 if hasattr(m, "weight_q")}
    same = codes.keys() == cpu_codes.keys() and all(
        np.array_equal(v, cpu_codes[k]) for k, v in codes.items())
    say(f"serve-artifact (d) PTQ llama_125m fp32 (abs-max activations, "
        f"per-channel weights), 4 calibration batches of 2 x 128: quantize "
        f"{ms[0]:.1f} ms, calibrate {ms[1]:.1f} ms, convert {ms[2]:.1f} ms "
        f"on the card; {len(codes)} linears converted; logits max abs diff "
        f"converted vs fake-quant simulation {err:.3e} (limit {PTQ_ATOL:g}); "
        f"int8 codes card = CPU bit for bit: {same}")
    check(len(codes) == 12 * 7 + 1 and err <= PTQ_ATOL and same,
          "PTQ converts every linear, matches its simulation, and the "
          "card's codes are the CPU's")


def phase_serve_artifact():
    """Phase 10: serving artifacts on llama_1b's width at SERVE_CUT_LAYERS
    layers (10a-c) and PTQ on llama_125m (10d); the artifacts live in a temporary directory under
    ``TMPDIR``, removed at the end. Returns the paged kernels' launches
    in each counted predictor run, {"bf16": (a)'s, "int8": (c)'s}, each
    read from its own run with the counts set to 0 just before it."""
    import shutil
    import tempfile

    from paddle_tpu_torch.models import llama_1b

    prompts = serve_prompts(llama_1b().vocab_size)
    batch = padded_batch(prompts)
    root = tempfile.mkdtemp(prefix="serve-artifact-")
    where = fs_type(root)
    try:
        counts, _ = timed(phase_artifact_bf16, root, where, prompts, batch)
        free_cuda()
        int8 = timed(phase_artifact_int8, root, where, prompts, batch)
        free_cuda()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timed(phase_ptq)
    free_cuda()
    return {"bf16": counts, "int8": int8}


# -- pages that leave and re-enter the pool ----------------------------------

# phase 11: phase 4's pool, batch and prompts, decode windows of 8
DISAGG_ENGINE = dict(num_blocks=2048, block_size=16, max_batch_size=8,
                     max_model_len=2048, decode_steps_per_sync=SERVE_WINDOW)
DISAGG_NEW = 32
# (b): the host tier's budget, more than the small pool holds
TIER_HOST_BLOCKS = 512
# (c): eight prompts sharing a 1024-token prefix, with suffixes of 64-512
# tokens, prefilled in chunks of at most 256 new tokens a step, so the
# chains the warm engine revives show as chunks it does not run
STORE_PREFIX = 1024
STORE_SUFFIX = (64, 512)
STORE_CHUNK = 256
STORE_HOST_BLOCKS = 1024
# (c) at fp32 llama_tiny, card against CPU
STORE_TINY = dict(num_blocks=64, block_size=16, max_batch_size=3,
                  decode_steps_per_sync=SERVE_WINDOW,
                  max_prefill_tokens_per_step=32)


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def dev_ms(dev, fn, *args):
    """(fn(*args), its wall ms between two device syncs)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def counted(dev, fn):
    """(fn(), the paged kernels' launches over it, its wall s): the counts
    are set to 0 just before ``fn`` and read just after."""
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    sync(dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    wall = time.perf_counter() - t0
    return out, K.launch_counts(), wall


def launches_str(c):
    return (f"#1 {c['paged_decode_attention_cuda']}, "
            f"#2 {c['paged_multiquery_attention_cuda']}")


def page_bytes(pages):
    import numpy as np

    return sum(int(v.nbytes) for v in pages.values()
               if isinstance(v, np.ndarray))


def warmup_prompt(vocab):
    import numpy as np

    return np.random.RandomState(SEED + 14).randint(0, vocab, 64).astype(
        np.int32)


def prefill_handoffs(pre, prompts, dev):
    """Each prompt through the prefill-only engine ``pre`` to its first
    token; its pages exported, packed and unpacked (the wire format), the
    request cancelled. Returns ``(handoffs, t)``: (prompt + first token,
    unpacked pages) pairs, and each request's export, pack and unpack ms
    and page bytes."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import (SamplingParams,
                                                    pack_kv_pages,
                                                    unpack_kv_pages)

    handoffs = []
    t = {"export": [], "pack": [], "unpack": [], "bytes": []}
    for p in prompts:
        rid = pre.add_request(p, SamplingParams(max_new_tokens=DISAGG_NEW))
        first = None
        while first is None:
            for out in pre.step():
                first = out
        pages, ms = dev_ms(dev, pre.export_kv_pages, rid)
        t["export"].append(ms)
        pre.cancel(rid, reason="handoff")
        pre.release(rid)
        blob, ms = dev_ms(dev, pack_kv_pages, pages)
        t["pack"].append(ms)
        back, ms = dev_ms(dev, unpack_kv_pages, blob)
        t["unpack"].append(ms)
        t["bytes"].append(page_bytes(pages))
        handoffs.append((np.concatenate([p, [first.token]]).astype(
            np.int32), back))
    return handoffs, t


def decode_handoffs(dec, handoffs):
    """Every handoff admitted to ``dec`` with its pages and decoded to the
    end; returns each request's tokens."""
    from paddle_tpu_torch.inference.serving import SamplingParams

    rids = [dec.add_request_with_pages(
        p2, pages, SamplingParams(max_new_tokens=DISAGG_NEW - 1))
        for p2, pages in handoffs]
    for _ in dec.stream():
        pass
    outs = [dec.output_tokens(r) for r in rids]
    for r in rids:
        dec.release(r)
    return outs


def import_ms(cache, payloads, dev):
    """Each payload's ``import_request_pages`` into free blocks of
    ``cache`` (ms between device syncs)."""
    out = []
    for pages in payloads:
        blocks = cache.allocator.allocate(pages["k"].shape[1])
        _, ms = dev_ms(dev, cache.import_request_pages, blocks, pages)
        cache.allocator.free(blocks)
        out.append(ms)
    return out


def ttft(m):
    return m["ttft_ms"].get("p50")


def handoff_arm(model, prompts, dev, kv_dtype=None, profile=True):
    """Phase 11a (11a' with ``kv_dtype="int8"`` on both sides): a
    colocated window engine serves ``prompts``; then a ``prefill_only``
    engine prefills each, its pages go through export, pack and unpack,
    and a second window engine imports and decodes them. Gates: the
    tokens equal the colocated run's bit for bit, the prefill engine
    launched no #1 and built no window graph, the decode engine launched
    no #2, and (``profile``) each engine's launches equal the kernels'
    device tally in a repeat. Returns tokens, launches and page bytes."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    label = ("serve-disagg (a') int8" if kv_dtype == "int8"
             else "serve-disagg (a) bf16")
    kw = dict(DISAGG_ENGINE, kv_dtype=kv_dtype, device=dev)
    warm = [warmup_prompt(model.config.vocab_size)]
    sp = SamplingParams(max_new_tokens=DISAGG_NEW)
    L = model.config.num_hidden_layers
    with LLMEngine(model, **kw) as col:
        col.generate(warm, SamplingParams(max_new_tokens=2))  # capture
        col.reset_metrics()
        ref, col_counts, col_wall = counted(
            dev, lambda: col.generate(prompts, sp))
        cm = col.metrics()
    pre = LLMEngine(model, prefill_only=True, **kw)
    dec = LLMEngine(model, **kw)
    try:
        # outside the counted runs: cuBLAS, the allocators, the pinned
        # host buffers, the decode window's capture
        decode_handoffs(dec, prefill_handoffs(pre, warm, dev)[0])
        pre.reset_metrics()
        dec.reset_metrics()
        (handoffs, t), pre_counts, pre_wall = counted(
            dev, lambda: prefill_handoffs(pre, prompts, dev))
        outs, dec_counts, dec_wall = counted(
            dev, lambda: decode_handoffs(dec, handoffs))
        pm, dm = pre.metrics(), dec.metrics()
        imp = import_ms(dec.cache, [pg for _, pg in handoffs], dev)
        graphs = (pre._window is not None, dec._window is not None
                  and dec._window.graph is not None)
        again = None
        if profile:
            reset_paged_counts()
            rep = {}
            prof = device_profile(
                lambda: rep.update(t=prefill_handoffs(pre, prompts, dev)[1]),
                f"{label} prefill engine (same prompts again)",
                mark=("paged_decode", "paged_multiquery"))
            check_device_launches(
                prof, K.launch_counts(), f"{label} prefill engine",
                zero=("paged_decode_attention_cuda",))
            again = sum(rep["t"]["export"])
            reset_paged_counts()
            prof = device_profile(
                lambda: decode_handoffs(dec, handoffs),
                f"{label} decode engine (same pages again)",
                mark=("paged_decode", "paged_multiquery"))
            check_device_launches(
                prof, K.launch_counts(), f"{label} decode engine",
                zero=("paged_multiquery_attention_cuda",))
    finally:
        pre.close()
        dec.close()
    same = len(outs) == len(ref) and all(
        np.array_equal(a, b) for a, b in zip(outs, ref))
    total = sum(t["bytes"])
    n_tok = len(prompts) * DISAGG_NEW
    exp_s, imp_s = sum(t["export"]) / 1e3, sum(imp) / 1e3
    cached = ("not measured" if again is None else
              f"{again:.1f} ms ({total / again / 1e6:.2f} GB/s)")
    say(f"{label}: {len(prompts)} requests x {DISAGG_NEW} new tokens; "
        f"pages per request {t['bytes']} bytes, {total} in all; export "
        f"{sum(t['export']):.1f} ms ({total / exp_s / 1e9:.2f} GB/s device "
        f"to host; the profiled repeat, its pinned buffers cached: "
        f"{cached}), pack {sum(t['pack']):.1f} ms, unpack "
        f"{sum(t['unpack']):.1f} ms, import {sum(imp):.1f} ms "
        f"({total / imp_s / 1e9:.2f} GB/s host to device); prefill side "
        f"(with export, pack, unpack) {pre_wall:.3f} s, decode side "
        f"{dec_wall:.3f} s: {n_tok / (pre_wall + dec_wall):.1f} tokens/s "
        f"end to end in one process vs colocated {n_tok / col_wall:.1f} "
        f"({col_wall:.3f} s), decode side alone "
        f"{len(prompts) * (DISAGG_NEW - 1) / dec_wall:.1f} tokens/s; TTFT "
        f"p50 decode side {ttft(dm)} ms (submit to first decoded token) "
        f"vs colocated {ttft(cm)} ms; launches: colocated "
        f"{launches_str(col_counts)}, prefill engine "
        f"{launches_str(pre_counts)} ({pm['prefill_chunks']} chunks, "
        f"{pm['decode_steps']} decode steps, window built: {graphs[0]}), "
        f"decode engine {launches_str(dec_counts)} ({dm['decode_steps']} "
        f"decode iterations, {dm['prefill_chunks']} chunks, window graph "
        f"captured: {graphs[1]}); tokens equal the colocated run's: {same}")
    check(same, f"{label}: disaggregated tokens equal colocated bit for bit")
    check(not graphs[0] and pre_counts["paged_decode_attention_cuda"] == 0
          and pm["decode_steps"] == 0
          and pre_counts["paged_multiquery_attention_cuda"]
          == L * pm["prefill_chunks"] > 0,
          f"{label}: the prefill engine built no window and launched no "
          f"#1 ({launches_str(pre_counts)})")
    check(dec_counts["paged_multiquery_attention_cuda"] == 0
          and dm["prefill_chunks"] == 0
          and dec_counts["paged_decode_attention_cuda"]
          == L * dm["decode_steps"] > 0,
          f"{label}: the decode engine launched no #2 "
          f"({launches_str(dec_counts)})")
    return {"ref": ref, "prefill": pre_counts, "decode": dec_counts,
            "bytes": total}


def tier_arm(model, prompts, ref, dev):
    """Phase 11b: a window engine that admits every request in its first
    step into a pool that holds them but not their growth, with the host
    tier (``TIER_HOST_BLOCKS``), then the same pool without it
    (re-prefill). Gates on the tier arm: a decode-ready
    request spilled, every spill revived, no revive missed, tokens equal
    the never-evicting run's (``ref``) bit for bit. The re-prefill arm's
    tokens are a share (a re-prefill recomputes the generated tokens' K/V
    in prefill-sized GEMMs). Returns the tier arm's launches."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    bs = DISAGG_ENGINE["block_size"]
    nb = 1 + sum(-(-(len(p) + 1) // bs) for p in prompts) + 8
    warm = [warmup_prompt(model.config.vocab_size)]
    cuda = torch.device(dev).type == "cuda"
    arms = {}
    for arm, host in (("tier", TIER_HOST_BLOCKS), ("re-prefill", 0)):
        with LLMEngine(model, kv_host_blocks=host, device=dev,
                       max_prefills_per_step=len(prompts),
                       **dict(DISAGG_ENGINE, num_blocks=nb)) as eng:
            eng.generate(warm, SamplingParams(max_new_tokens=2))
            eng.reset_metrics()
            if cuda:
                reset_peak_memory()
            outs, counts, wall = counted(dev, lambda: eng.generate(
                prompts, SamplingParams(max_new_tokens=DISAGG_NEW)))
            m, st = eng.metrics(), eng.stats()
            peak = (torch.cuda.max_memory_allocated() / 2**30 if cuda
                    else float("nan"))
        arms[arm] = dict(outs=outs, counts=counts, wall=wall, m=m, st=st,
                         peak=peak)
    t, r = arms["tier"], arms["re-prefill"]
    m = t["m"]
    same = all(np.array_equal(a, b) for a, b in zip(t["outs"], ref))
    share = same_share(r["outs"], ref)
    n_tok = len(prompts) * DISAGG_NEW
    sp, rv = m["kv_spill_ms"], m["kv_revive_ms"]

    def rate(nbytes, ms):
        return "not measured" if not ms else f"{nbytes / ms / 1e6:.2f} GB/s"

    say(f"serve-disagg (b) host tier: pool {nb} blocks (1 + sum of "
        f"ceil((len+1)/{bs}) + 8), all {len(prompts)} admitted in one step, "
        f"kv_host_blocks {TIER_HOST_BLOCKS}: "
        f"evictions {t['st']['evictions']}, spills {m['kv_spills']}, "
        f"revives {m['kv_revives']}, revive misses {m['revive_misses']}, "
        f"host evictions {m['kv_host_evictions']}; spilled "
        f"{m['kv_spill_bytes']} bytes in {sp['sum']:.1f} ms on the "
        f"transfer thread ({rate(m['kv_spill_bytes'], sp['sum'])}, p50 "
        f"{sp['p50']} ms an event), revived {m['kv_revive_bytes']} bytes "
        f"in {rv['sum']:.1f} ms ({rate(m['kv_revive_bytes'], rv['sum'])}); "
        f"prefills {m['prefills']} vs {r['m']['prefills']} without the "
        f"tier; launches {launches_str(t['counts'])} vs "
        f"{launches_str(r['counts'])} without the tier ({r['st']['evictions']}"
        f" evictions, re-prefilled); tokens/s {n_tok / t['wall']:.1f} vs "
        f"{n_tok / r['wall']:.1f} without the tier; peak memory "
        f"{t['peak']:.2f} vs {r['peak']:.2f} GiB; tier tokens equal the "
        f"2048-block run's: {same}; without the tier {share:.3f} of "
        f"requests equal (reported: a re-prefill recomputes the generated "
        f"tokens' K/V in prefill-sized GEMMs, which round apart)")
    check(t["st"]["evictions"] >= 1 and m["kv_spills"] >= 1
          and m["kv_revives"] == m["kv_spills"] and m["revive_misses"] == 0,
          f"host tier: a decode-ready request spilled ({m['kv_spills']}), "
          f"every spill revived ({m['kv_revives']}), no revive missed")
    check(same, "host tier tokens equal the never-evicting run's")
    return t["counts"]


def store_prompts(vocab, prefix_len, suffix, seed):
    """Eight prompts sharing a ``prefix_len``-token prefix, with suffixes
    of ``suffix`` (lo, hi) tokens."""
    import numpy as np

    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, prefix_len)
    return [np.concatenate([prefix, rng.randint(0, vocab, n)]).astype(
        np.int32) for n in rng.randint(suffix[0], suffix[1] + 1, 8)]


def store_header_entries(path):
    """The entry count a prefix store's header (its first record)
    promises, read without the entries."""
    from paddle_tpu_torch.io.streaming import MAGIC, _FRAME

    with open(path, "rb") as f:
        f.seek(len(MAGIC))
        n, _ = _FRAME.unpack(f.read(_FRAME.size))
        return json.loads(f.read(n))["entries"]


def revived_match_store(eng, path):
    """(the revived chains of ``eng``'s prefix cache: published on the
    device, found in the store at ``path`` and gone from the host tier;
    whether every such block's pool bytes equal the stored payload). A
    stored chain prefilled again (a prompt's last full block, which the
    match leaves to prefill) is still in the tier and not compared."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import load_prefix_store

    stored = dict(load_prefix_store(path,
                                    fingerprint=eng._store_fingerprint,
                                    geometry=eng._store_geometry))
    chains = [(h, b) for h, b in eng.prefix_cache.registered_chains()
              if h in stored and not eng.kv_tier.has_prefix(h)]
    same = True
    for h, b in chains:
        got = eng.cache.export_request_pages([b], eng.block_size)
        same = same and all(np.array_equal(got[k], stored[h][k])
                            for k in got if isinstance(got[k], np.ndarray))
    return len(chains), same


def store_engine_run(model, prompts, path, dev, kw, check_store=False):
    """One engine with the prefix cache, the host tier and the store at
    ``path``: booted (its load counted), a warm-up request, ``prompts``
    counted, then (``check_store``) the revived blocks against the store,
    then ``close`` (which saves the store). Returns a dict."""
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    eng, boot_ms = dev_ms(dev, lambda: LLMEngine(
        model, enable_prefix_cache=True, prefix_store_path=path,
        device=dev, **kw))
    loaded = eng.metrics()["prefix_store_loaded"]
    eng.generate([warmup_prompt(model.config.vocab_size)],
                 SamplingParams(max_new_tokens=2))
    eng.reset_metrics()
    outs, counts, wall = counted(dev, lambda: eng.generate(
        prompts, SamplingParams(max_new_tokens=DISAGG_NEW)))
    m = eng.metrics()
    matched = revived_match_store(eng, path) if check_store else None
    _, close_ms = dev_ms(dev, eng.close)
    return dict(outs=outs, counts=counts, wall=wall, m=m, boot_ms=boot_ms,
                loaded=loaded, close_ms=close_ms, matched=matched)


def store_arm(model, root, dev):
    """Phase 11c: a cold engine serves prompts sharing a prefix and saves
    the store on ``close``; a new engine boots from it and serves them
    again. Gates: entries loaded equal entries saved, revives, fewer #2
    launches by the chunks the revived chains spared, every revived block
    equal to its stored payload. The warm tokens against the cold ones are
    a share (the warm prefill runs shorter chunks, whose bf16 GEMMs round
    apart). Returns the warm run's launches."""
    import numpy as np

    prompts = store_prompts(model.config.vocab_size, STORE_PREFIX,
                            STORE_SUFFIX, SEED + 13)
    path = os.path.join(root, "prefix.pdstream")
    kw = dict(DISAGG_ENGINE, kv_host_blocks=STORE_HOST_BLOCKS,
              max_prefill_tokens_per_step=STORE_CHUNK)
    cold = store_engine_run(model, prompts, path, dev, kw)
    saved, nbytes = store_header_entries(path), os.path.getsize(path)
    warm = store_engine_run(model, prompts, path, dev, kw, check_store=True)
    L = model.config.num_hidden_layers
    cm, wm = cold["m"], warm["m"]
    c_mq = cold["counts"]["paged_multiquery_attention_cuda"]
    w_mq = warm["counts"]["paged_multiquery_attention_cuda"]
    chains, same_bytes = warm["matched"]
    share = same_share(warm["outs"], cold["outs"])
    n_tok = len(prompts) * DISAGG_NEW
    say(f"serve-disagg (c) prefix store: 8 prompts sharing a "
        f"{STORE_PREFIX}-token prefix, suffixes "
        f"{sorted(len(p) - STORE_PREFIX for p in prompts)}, chunks of "
        f"{STORE_CHUNK}; cold engine: {cm['prefill_chunks']} chunks, "
        f"{launches_str(cold['counts'])}, {n_tok / cold['wall']:.1f} "
        f"tokens/s, TTFT p50 {ttft(cm)} ms; close saved {saved} entries, "
        f"{nbytes} bytes, in {cold['close_ms']:.1f} ms (close) to TMPDIR "
        f"({fs_type(root)}); warm engine booted in {warm['boot_ms']:.1f} "
        f"ms (weight fingerprint and load), {warm['loaded']} entries "
        f"loaded; warm run: {wm['kv_revives']} blocks revived "
        f"({wm['kv_revive_bytes']} bytes in "
        f"{wm['kv_revive_ms']['sum']:.1f} ms), {wm['prefill_chunks']} "
        f"chunks, {launches_str(warm['counts'])}, "
        f"{n_tok / warm['wall']:.1f} tokens/s, TTFT p50 {ttft(wm)} ms; "
        f"{chains} revived blocks equal the stored payload: {same_bytes}; "
        f"warm tokens vs cold: {share:.3f} of requests equal (reported: "
        f"the warm prefill runs shorter chunks, whose bf16 GEMMs round "
        f"apart)")
    check(warm["loaded"] == saved > 0,
          f"entries loaded {warm['loaded']} == entries saved {saved}")
    check(wm["kv_revives"] > 0, "the warm run revived from the store")
    check(w_mq < c_mq and c_mq - w_mq == L * (cm["prefill_chunks"]
                                              - wm["prefill_chunks"]),
          f"#2 launches warm {w_mq} < cold {c_mq}, by the revived chunks")
    check(chains > 0 and same_bytes,
          "every revived block's bytes equal the stored payload")
    return warm["counts"]


def store_card_vs_cpu(root):
    """Phase 11c on fp32 llama_tiny, card against CPU: the cold run saves
    the store, the warm run boots from it and revives; the warm tokens on
    the card equal the CPU's."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                         load_paddle_tpu_state_dict)

    cfg = llama_tiny()
    rng = np.random.RandomState(SEED + 15)
    ref = LlamaForCausalLM(cfg, device="cpu")
    state = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in ref.state_dict().items()}
    prompts = store_prompts(cfg.vocab_size, 64, (8, 40), SEED + 16)
    outs, revived = {}, {}
    for dev in ("cpu", "cuda"):
        m = LlamaForCausalLM(cfg, device=dev)
        load_paddle_tpu_state_dict(m, state)
        kw = dict(STORE_TINY, enable_prefix_cache=True, kv_host_blocks=64,
                  prefix_store_path=os.path.join(root, f"tiny-{dev}"),
                  device=dev)
        runs = []
        for _ in ("cold", "warm"):
            with LLMEngine(m, **kw) as eng:
                runs.append(eng.generate(prompts,
                                         SamplingParams(max_new_tokens=16)))
                revived[dev] = eng.metrics()["kv_revives"]
        outs[dev] = runs
    same = all((a == b).all() for a, b in zip(outs["cpu"][1],
                                              outs["cuda"][1]))
    say(f"serve-disagg (c) card vs cpu llama_tiny fp32 warm restart: "
        f"blocks revived {revived['cuda']} (card), {revived['cpu']} (CPU); "
        f"warm tokens card = CPU: {same}; warm = cold: card "
        f"{same_share(outs['cuda'][1], outs['cuda'][0]):.3f}, CPU "
        f"{same_share(outs['cpu'][1], outs['cpu'][0]):.3f} of requests")
    check(same and revived["cuda"] > 0 and revived["cpu"] > 0,
          "the card's warm tokens equal the CPU's, both revived")


def phase_serve_disagg():
    """Phase 11: pages that leave and re-enter the pool, llama_1b bf16 at
    full width and SERVE_CUT_LAYERS layers with phase 4's prompts: (a) the disaggregated handoff, (a')
    the same on int8 pools, (b) the host tier under pool pressure, (c) the
    prefix store's warm restart (the store under ``TMPDIR``, removed at
    the end) and its fp32 llama_tiny card-vs-CPU check. Returns the paged
    kernels' launches of each counted run, each read from its own run with
    the counts set to 0 just before it."""
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = serve_cut_config()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    prompts = serve_prompts(cfg.vocab_size)
    a = timed(handoff_arm, model, prompts, "cuda")
    free_cuda()
    a8 = timed(handoff_arm, model, prompts, "cuda", kv_dtype="int8",
               profile=False)
    say(f"serve-disagg (a') int8 pages {a8['bytes']} bytes = "
        f"{a8['bytes'] / a['bytes']:.4f} of bf16's {a['bytes']}")
    free_cuda()
    tier = timed(tier_arm, model, prompts, a["ref"], "cuda")
    free_cuda()
    root = tempfile.mkdtemp(prefix="serve-disagg-")
    try:
        warm = timed(store_arm, model, root, "cuda")
        del model
        free_cuda()
        timed(store_card_vs_cpu, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_cuda()
    return {"prefill": a["prefill"], "decode": a["decode"],
            "int8_prefill": a8["prefill"], "int8_decode": a8["decode"],
            "tier": tier, "warm": warm}


# -- deadlines, tenants and QoS tiers; serving integrity ----------------------

# phase 12: phase 4's pool and prompts, windows of 8, four slots; the first
# four prompts are tenant "bronze" (batch tier), the last four "gold"
# (latency tier), all admitted in one step when slots allow
QOS_ENGINE = dict(num_blocks=2048, block_size=16, max_batch_size=4,
                  max_prefills_per_step=4, max_model_len=2048,
                  decode_steps_per_sync=SERVE_WINDOW, ingest_async=False)
QOS_NEW = 32
QOS_HOST_BLOCKS = 512        # more than the four bronze requests' pages
QOS_WEIGHTS = {"gold": 3.0, "bronze": 1.0}
QOS_QUOTA = 500.0            # bronze tokens/s in the quota arm: one
                             # prefill puts it over for the 1 s window
QOS_LONG_NEW = 512           # (a'): bronze tokens when it holds its slots
                             # long enough for a yield to pay
# (b): five 256-token prompts; two of four running requests expire
# DEADLINE_S after submission, long before DEADLINE_NEW tokens
DEADLINE_PROMPT = 256
DEADLINE_NEW = 1024
DEADLINE_S = 0.5
# (d): fp32 llama_tiny, the same traffic at tiny size
QOS_TINY = dict(num_blocks=160, block_size=4, max_batch_size=4,
                max_prefills_per_step=4, decode_steps_per_sync=SERVE_WINDOW,
                ingest_async=False, kv_host_blocks=96,
                kv_page_checksums=True)
QOS_TINY_NEW = 16


def qos_arm(eng, prompts, dev, qos=True, flip=False, deadlines=None,
            hook=None, new=QOS_NEW, bronze_new=None):
    """One run of phase 12's traffic on ``eng``: the first half of
    ``prompts`` submitted (``qos``: tenant "bronze", batch tier) and
    stepped until each has its first token, then the second half (``qos``:
    "gold", latency tier); driven to the end. ``flip`` flips one byte of
    the oldest host-tier entry as soon as one is resident (the
    ``host_entry`` drill); ``deadlines`` maps a prompt index to its
    absolute deadline; ``hook(eng, step, reqs)`` runs after every step;
    ``bronze_new`` gives the first half another token budget.
    Returns a dict: tokens in prompt order, finish reasons, TTFT ms a
    request, wall s, the tenant tokens when the gold requests arrived and
    when the last finished, the flip's description, steps, and the wall
    ms of each step and of its admission (``pick_prefills``: yields and
    their spills' snapshots included)."""
    from paddle_tpu_torch.inference.serving import (TIER_BATCH,
                                                    TIER_LATENCY,
                                                    SamplingParams)
    from paddle_tpu_torch.inference.serving import integrity as I

    half = len(prompts) // 2
    deadlines = deadlines or {}

    def submit(i, tenant, tier):
        tags = dict(tenant=tenant, tier=tier) if qos else {}
        n = bronze_new if bronze_new and i < half else new
        return eng.add_request(prompts[i], SamplingParams(max_new_tokens=n),
                               deadline=deadlines.get(i), **tags)

    step_ms, admit_ms = [], []
    pick = eng.scheduler.pick_prefills

    def timed_pick():
        t = time.perf_counter()
        try:
            return pick()
        finally:
            admit_ms[-1] += (time.perf_counter() - t) * 1e3

    eng.scheduler.pick_prefills = timed_pick
    sync(dev)
    t0 = time.perf_counter()
    rids = [submit(i, "bronze", TIER_BATCH) for i in range(half)]
    reqs = [eng.request(r) for r in rids]
    flipped, steps = None, 0

    def step():
        nonlocal flipped, steps
        admit_ms.append(0.0)
        t = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - t) * 1e3)
        steps += 1
        if flip and flipped is None and eng.kv_tier is not None \
                and len(eng.kv_tier):
            flipped = I.flip_bit(eng, "host_entry")
        if hook is not None:
            hook(eng, steps, reqs)

    while not all(r.output_tokens or r.finished for r in reqs):
        step()
    before = dict(eng.metrics()["tenant_tokens"])
    rids += [submit(i, "gold", TIER_LATENCY)
             for i in range(half, len(prompts))]
    reqs = [eng.request(r) for r in rids]
    t_gold = time.perf_counter()
    during, gold_done = None, {}
    while eng.has_work():
        step()
        for r in reqs[half:]:
            if r.finished and r.rid not in gold_done:
                gold_done[r.rid] = time.perf_counter() - t_gold
        if during is None and all(r.finished for r in reqs[half:]):
            during = dict(eng.metrics()["tenant_tokens"])
    sync(dev)
    wall = time.perf_counter() - t0
    eng.scheduler.pick_prefills = pick
    out = dict(outs=[eng.output_tokens(r) for r in rids],
               reasons=[r.finish_reason() for r in reqs],
               ttft=[(r.t_first_token - r.t_submit) / 1e6
                     if r.t_first_token is not None else None for r in reqs],
               wall=wall, before=before, during=during or before,
               flipped=flipped, steps=steps, rids=list(rids),
               step_ms=step_ms, admit_ms=admit_ms,
               gold_done_s=list(gold_done.values()))
    for r in rids:
        eng.release(r)
    return out


def qos_engine(model, dev, **kw):
    """A phase 12 engine over ``model``, its window captured by a warm-up
    request outside the counted runs, its metrics reset."""
    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    eng = LLMEngine(model, device=dev, **{**QOS_ENGINE, **kw})
    eng.generate([warmup_prompt(model.config.vocab_size)],
                 SamplingParams(max_new_tokens=2))
    eng.reset_metrics()
    return eng


def configure_tiers(eng, **bronze):
    for name, w in QOS_WEIGHTS.items():
        eng.configure_tenant(name, weight=w,
                             **(bronze if name == "bronze" else {}))


def steps_str(run):
    return ", ".join(f"{w:.1f} ({a:.1f})"
                     for w, a in zip(run["step_ms"], run["admit_ms"]))


def p50(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else float("nan")


def new_tokens(outs, prompts):
    return sum(len(o) - len(p) for o, p in zip(outs, prompts))


def window_graph(eng):
    """(the window's graph step, its captures, its replays)."""
    w = eng._window
    return w, (w.captures if w is not None else 0), \
        (w.replays if w is not None else 0)


def qos_arms(model, prompts, dev, profile=True):
    """Phase 12a: the FIFO arm (default traffic) and the QoS arm (bronze
    batch then gold latency, weights 3:1) on two engines with the same
    arguments and the host tier, then the QoS arm again under the profiler
    and the quota arm. Gates: the QoS tokens equal FIFO's bit for bit,
    yields = spills = revives with no miss, no recapture, #1/#2 launches
    equal to the device tally; the quota arm throttles, sheds nothing and
    finishes every request. Returns both arms' tokens and launches."""
    import torch

    from paddle_tpu_torch.ops.cuda import paged_attention as K

    cuda = torch.device(dev).type == "cuda"
    kw = dict(kv_host_blocks=QOS_HOST_BLOCKS)
    fifo_eng = qos_engine(model, dev, **kw)
    fifo, fifo_counts, _ = counted(dev, lambda: qos_arm(
        fifo_eng, prompts, dev, qos=False))
    fm = fifo_eng.metrics()
    fifo_eng.close()
    eng = qos_engine(model, dev, **kw)
    configure_tiers(eng)
    graph0, cap0, rep0 = window_graph(eng)
    qos, counts, _ = counted(dev, lambda: qos_arm(eng, prompts, dev))
    m, st = eng.metrics(), eng.stats()
    graph1, cap1, rep1 = window_graph(eng)
    half = len(prompts) // 2
    same = same_tokens(qos["outs"], fifo["outs"])
    toks = new_tokens(qos["outs"], prompts)
    gold = qos["during"].get("gold", 0) - qos["before"].get("gold", 0)
    bronze = qos["during"].get("bronze", 0) - qos["before"].get(
        "bronze", 0)
    ratio = gold / bronze if bronze else float("inf")
    say(f"serve-qos (a) llama_1b: {len(prompts)} requests x {QOS_NEW} new "
        f"tokens, {half} bronze (batch tier, weight 1) decoding when {half} "
        f"gold (latency tier, weight 3) arrive, batch "
        f"{QOS_ENGINE['max_batch_size']}, kv_host_blocks {QOS_HOST_BLOCKS}: "
        f"batch yields {m['batch_yields']}, spills {m['kv_spills']}, revives "
        f"{m['kv_revives']}, revive misses {m['revive_misses']}, evictions "
        f"{st['evictions']}; TTFT p50 gold {p50(qos['ttft'][half:]):.1f} ms "
        f"vs the same requests under FIFO {p50(fifo['ttft'][half:]):.1f} ms; "
        f"bronze {p50(qos['ttft'][:half]):.1f} vs "
        f"{p50(fifo['ttft'][:half]):.1f} ms; tenant_tokens "
        f"{m['tenant_tokens']}; gold:bronze tokens while both were "
        f"backlogged {gold}:{bronze} = {ratio:.2f}; tokens/s "
        f"{toks / qos['wall']:.1f} vs FIFO {toks / fifo['wall']:.1f} "
        f"({qos['steps']} vs {fifo['steps']} steps); spilled "
        f"{m['kv_spill_bytes']} bytes in {m['kv_spill_ms']['sum']:.1f} ms, "
        f"revived {m['kv_revive_bytes']} in {m['kv_revive_ms']['sum']:.1f} "
        f"ms; launches QoS {launches_str(counts)}, FIFO "
        f"{launches_str(fifo_counts)}; window graph captures "
        f"{cap0} -> {cap1}, replays {rep0} -> {rep1}; tokens equal FIFO's: "
        f"{same}")
    say(f"serve-qos (a) step wall ms (admission ms, yields' snapshots "
        f"included): QoS {steps_str(qos)}; FIFO {steps_str(fifo)}")
    check(same, "QoS tokens equal the FIFO arm's bit for bit (QoS moves "
          "when work runs, never which tokens)")
    check(m["batch_yields"] > 0
          and m["batch_yields"] == m["kv_spills"] == m["kv_revives"]
          and m["revive_misses"] == 0,
          f"yields {m['batch_yields']} = spills {m['kv_spills']} = revives "
          f"{m['kv_revives']}, no miss")
    check(set(m["tenant_tokens"]) <= {"gold", "bronze", "default"}
          and m["tenant_tokens"]["gold"] > 0
          and m["tenant_tokens"]["bronze"] > 0, "tenant tokens by tenant")
    check(graph1 is graph0 and cap1 == cap0 == (1 if cuda else 0)
          and (rep1 > rep0 or not cuda),
          f"no recapture: one window graph, {cap1} capture(s)")
    if cuda:
        L = model.config.num_hidden_layers
        check(counts["paged_decode_attention_cuda"] == L * m["decode_steps"]
              and counts["paged_multiquery_attention_cuda"]
              == L * m["prefill_chunks"],
              f"QoS launches {launches_str(counts)} == layers x decode "
              f"iterations, layers x chunks")
        if profile:
            reset_paged_counts()
            prof = device_profile(lambda: qos_arm(eng, prompts, dev),
                                  "serve-qos (a) QoS arm (again)",
                                  mark=("paged_decode", "paged_multiquery"))
            check_device_launches(prof, K.launch_counts(),
                                    "serve-qos (a) QoS arm")
    # the quota arm: bronze over its rate after its first prefills
    eng.reset_metrics()
    configure_tiers(eng, rate_tokens_per_s=QOS_QUOTA, window_s=1.0)
    quota = qos_arm(eng, prompts, dev)
    qm = eng.metrics()
    configure_tiers(eng)
    eng.close()
    done = all(r == "length" for r in quota["reasons"])
    say(f"serve-qos (a) quota arm: bronze {QOS_QUOTA} tokens/s over 1 s: "
        f"throttled admission passes {qm['quota_throttled']}, finished "
        f"{qm['finished']} of {len(prompts)} (reasons "
        f"{sorted(set(quota['reasons']))}), wall {quota['wall']:.3f} s vs "
        f"{qos['wall']:.3f} s without the quota; tokens equal FIFO's: "
        f"{same_share(quota['outs'], fifo['outs']):.3f} of requests; "
        f"tenant_tokens {qm['tenant_tokens']}")
    check(qm["quota_throttled"] > 0 and done
          and qm["finished"] == len(prompts),
          "the quota throttles bronze, sheds nothing, every request "
          "finishes")
    # (a'): bronze holding its slots for QOS_LONG_NEW tokens, QoS vs FIFO
    long = {}
    for arm, on in (("qos", True), ("fifo", False)):
        e = qos_engine(model, dev, **kw)
        if on:
            configure_tiers(e)
        long[arm] = qos_arm(e, prompts, dev, qos=on,
                            bronze_new=QOS_LONG_NEW)
        long[arm]["m"] = e.metrics()
        e.close()
    lq, lf = long["qos"], long["fifo"]
    lsame = same_tokens(lq["outs"], lf["outs"])
    say(f"serve-qos (a') bronze of {QOS_LONG_NEW} new tokens: TTFT p50 gold "
        f"{p50(lq['ttft'][half:]):.1f} ms under QoS vs "
        f"{p50(lf['ttft'][half:]):.1f} ms under FIFO; the gold requests' "
        f"last token {max(lq['gold_done_s'], default=0):.3f} s vs "
        f"{max(lf['gold_done_s'], default=0):.3f} s after they arrived; "
        f"yields {lq['m']['batch_yields']}, spills {lq['m']['kv_spills']}, "
        f"revives {lq['m']['kv_revives']}; wall {lq['wall']:.3f} vs "
        f"{lf['wall']:.3f} s; tokens equal FIFO's: {lsame}")
    check(lsame and lq["m"]["batch_yields"] == lq["m"]["kv_spills"]
          == lq["m"]["kv_revives"] > 0 and lq["m"]["revive_misses"] == 0,
          "(a') tokens equal FIFO's, yields = spills = revives")
    return dict(fifo=fifo, qos=qos, counts=counts, fifo_counts=fifo_counts,
                fm=fm)


def deadline_prompts(vocab):
    import numpy as np

    rng = np.random.RandomState(SEED + 17)
    return [rng.randint(0, vocab, DEADLINE_PROMPT).astype(np.int32)
            for _ in range(5)]


def deadline_arm(model, dev):
    """Phase 12b: four requests of ``DEADLINE_NEW`` tokens fill the slots,
    two with a deadline ``DEADLINE_S`` out; a fifth waits. Gates: the two
    streams end in (-1, "timeout") mid-decode, their blocks are back, the
    freed slot admits the waiting request at the same step and its tokens
    equal its batch-of-one run's; no recapture; ``generate`` with a passed
    deadline raises with the allocator untouched."""
    import torch

    from paddle_tpu_torch.inference.serving import (RequestTimeoutError,
                                                    SamplingParams)

    cuda = torch.device(dev).type == "cuda"
    prompts = deadline_prompts(model.config.vocab_size)
    eng = qos_engine(model, dev)
    try:
        want = eng.generate([prompts[4]],
                            SamplingParams(max_new_tokens=QOS_NEW))[0]
        usable = eng.cache.num_blocks - 1
        free0 = eng.cache.allocator.num_free
        graph0, cap0, _ = window_graph(eng)
        deadline = time.time() + DEADLINE_S
        rids = [eng.add_request(
            p, SamplingParams(max_new_tokens=DEADLINE_NEW),
            deadline=deadline if i < 2 else None)
            for i, p in enumerate(prompts[:4])]
        waiting = eng.add_request(prompts[4],
                                  SamplingParams(max_new_tokens=QOS_NEW))
        ends, windows = [], []
        lag, admitted_with, balanced = float("nan"), (None, False, None), \
            False
        while eng.has_work():
            t = time.time()
            outs = eng.step()
            sync(dev)
            timed_out = [o for o in outs if o.finish_reason == "timeout"]
            if timed_out:
                ends += timed_out
                lag = (t - deadline) * 1e3
                r = eng.request(waiting)
                admitted_with = (r.state, r.blocks != [],
                                 [eng.request(x).blocks for x in rids[:2]])
                held = sum(len(q.blocks) for q in eng.scheduler.running)
                balanced = held + eng.cache.allocator.num_free == usable
            elif not ends and all(eng.request(x).output_tokens
                                  for x in rids):
                windows.append((time.time() - t) * 1e3)
            if eng.request(waiting).finished:
                break
        got = eng.output_tokens(waiting)
        decoded = [len(eng.request(x).output_tokens) for x in rids[:2]]
        for x in rids[2:]:
            eng.cancel(x)
        free1 = eng.cache.allocator.num_free
        graph1, cap1, _ = window_graph(eng)
        m = eng.metrics()
        n_req = len(eng._requests)
        with contextlib.suppress(RequestTimeoutError):
            eng.generate([prompts[0]], SamplingParams(max_new_tokens=4),
                         deadline=time.time() - 1.0)
            check(False, "generate(deadline=<past>) raised")
        untouched = (eng.cache.allocator.num_free == free1
                     and len(eng._requests) == n_req and not eng.has_work())
    finally:
        eng.close()
    same = bool((got == want).all()) and len(got) == len(want)
    win = statistics.median(windows) if windows else float("nan")
    say(f"serve-qos (b) deadlines: 4 x {DEADLINE_PROMPT}-token requests of "
        f"{DEADLINE_NEW} new tokens, two with a deadline {DEADLINE_S} s out, "
        f"a fifth waiting: streams ended {[(o.token, o.finish_reason) for o in ends]} "
        f"after {decoded} tokens; the abort came {lag:.1f} ms after the "
        f"deadline against a window's wall {win:.1f} ms (median of "
        f"{len(windows)}); the waiting request was {admitted_with[0]} with "
        f"blocks {admitted_with[1]} in that step, the expired ones' blocks "
        f"{admitted_with[2]}, held + free = usable: {balanced}; its tokens "
        f"equal its batch-of-one run: {same}; deadline_expired "
        f"{m['deadline_expired']}; blocks free after {free1} of {free0}; "
        f"window captures {cap0} -> {cap1}; generate(deadline=<past>) "
        f"raised with the allocator untouched: {untouched}")
    check(len(ends) == 2 and all(o.token == -1 and o.finished for o in ends)
          and all(0 < d < DEADLINE_NEW for d in decoded),
          "two streams end in (-1, timeout) mid-decode")
    check(admitted_with[0] == "running" and admitted_with[1]
          and admitted_with[2] == [[], []] and balanced,
          "the freed slot admits the waiting request; the expired blocks "
          "are back")
    check(same, "the admitted request's tokens equal its batch-of-one run")
    check(m["deadline_expired"] == 2 and free1 == free0 and untouched
          and graph1 is graph0 and cap1 == cap0 == (1 if cuda else 0),
          "deadline counter, every block back, no recapture, past deadline "
          "raises")
    return lag, win


@contextlib.contextmanager
def crc_timing():
    """Time every ``seal_pages`` and ``verify_pages`` the engine's pages go
    through (the kv_cache module calls them through the integrity
    module). Yields {"seal"|"verify": [ms, bytes, blocks]}."""
    from paddle_tpu_torch.inference.serving import integrity as I

    acc = {"seal": [0.0, 0, 0], "verify": [0.0, 0, 0]}
    seal, verify = I.seal_pages, I.verify_pages

    def timed_call(kind, fn, pages, **kw):
        t0 = time.perf_counter()
        try:
            return fn(pages, **kw)
        finally:
            a = acc[kind]
            a[0] += (time.perf_counter() - t0) * 1e3
            a[1] += sum(int(v.nbytes) for k, v in pages.items()
                        if k != "crc" and hasattr(v, "nbytes"))
            a[2] += int(pages["k"].shape[1])

    I.seal_pages = functools.partial(timed_call, "seal", seal)
    I.verify_pages = functools.partial(timed_call, "verify", verify)
    try:
        yield acc
    finally:
        I.seal_pages, I.verify_pages = seal, verify


def rate_str(a):
    ms, nbytes, blocks = a
    if not ms:
        return "not measured"
    return (f"{blocks} blocks, {nbytes} bytes in {ms:.1f} ms "
            f"({nbytes / ms / 1e6:.2f} GB/s)")


def integrity_arms(model, prompts, a, dev, root):
    """Phase 12c: (a)'s QoS arm with ``kv_page_checksums=True`` (verified
    blocks = spilled blocks, none rejected, tokens = (a)'s); the same with
    a host-tier entry flipped (rejected once, re-prefilled); a sealed
    handoff between a prefill-only and a decode engine (verified; a flipped
    payload raises before any block moves); the weight audit (its ms; a
    weight flip in place fails it; ``reload_weights`` from a bf16 artifact
    re-anchors it with the tokens of before and no recapture; a pool-page
    flip in place, which no CRC sees). Returns the checksummed arm's
    launches."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.serving import (
        KVIntegrityError, LLMEngine, SamplingParams, pack_kv_pages,
        save_llama_artifact, unpack_kv_pages)
    from paddle_tpu_torch.inference.serving import integrity as I

    cuda = torch.device(dev).type == "cuda"
    half = len(prompts) // 2
    fifo = a["fifo"]["outs"]
    eng = qos_engine(model, dev, kv_host_blocks=QOS_HOST_BLOCKS,
                     kv_page_checksums=True)
    configure_tiers(eng)
    with crc_timing() as acc:
        sealed, counts, _ = counted(dev, lambda: qos_arm(eng, prompts, dev))
    m = eng.metrics()
    per_block = (2 * model.config.num_hidden_layers * eng.block_size
                 * model.config.num_key_value_heads * model.config.head_dim
                 * eng.cache.k[0].element_size())
    spilled = (m["kv_spill_bytes"] - 4 * acc["seal"][2]) // per_block
    same = same_tokens(sealed["outs"], a["qos"]["outs"])
    say(f"serve-qos (c) checksums on (a)'s QoS arm: yields "
        f"{m['batch_yields']}, spilled blocks {spilled}, sealed "
        f"{acc['seal'][2]}, verified {m['kv_pages_verified']}, rejected "
        f"{m['kv_pages_rejected']}; seal {rate_str(acc['seal'])}, verify "
        f"{rate_str(acc['verify'])}; tokens/s "
        f"{new_tokens(sealed['outs'], prompts) / sealed['wall']:.1f} vs "
        f"{new_tokens(a['qos']['outs'], prompts) / a['qos']['wall']:.1f} "
        f"without; launches {launches_str(counts)}; tokens equal (a)'s: "
        f"{same}")
    check(spilled > 0 and m["kv_pages_verified"] == spilled
          == acc["seal"][2] and m["kv_pages_rejected"] == 0 and same,
          "checksums: verified = spilled blocks, none rejected, tokens = (a)'s")
    # the host_entry drill: the oldest resident spill flipped after its seal
    eng.reset_metrics()
    misses0 = eng.scheduler.revive_misses
    with warnings_ignored():
        drill = qos_arm(eng, prompts, dev, flip=True)
    dm = eng.metrics()
    eng.close()
    key = drill["flipped"]["key"] if drill["flipped"] else None
    idx = drill["rids"].index(key[1]) if key else None
    flip_same = idx is not None and bool(
        (drill["outs"][idx] == fifo[idx]).all())
    say(f"serve-qos (c) host_entry flip on spill {key}: rejected "
        f"{dm['kv_pages_rejected']}, verified {dm['kv_pages_verified']}, "
        f"revive misses {eng.scheduler.revive_misses - misses0}, revives "
        f"{dm['kv_revives']} of {dm['kv_spills']} spills, prefills "
        f"{dm['prefills']} (one a request plus the re-prefill); the flipped "
        f"request's tokens equal FIFO's: {flip_same} (reported: the "
        f"re-prefill recomputes its generated tokens' K/V in prefill-sized "
        f"bf16 GEMMs, which round apart from the decode's, as phase 11b's "
        f"re-prefill arm; (d) gates the re-prefilled tokens in fp32); all "
        f"requests: {same_share(drill['outs'], fifo):.3f}")
    check(key is not None and dm["kv_pages_rejected"] == 1
          and eng.scheduler.revive_misses - misses0 == 1
          and dm["prefills"] == len(prompts) + 1
          and all(r == "length" for r in drill["reasons"]),
          "the flipped spill is rejected once and its request re-prefilled")
    # a sealed handoff: prefill-only engine -> wire format -> decode engine
    pre = LLMEngine(model, device=dev, prefill_only=True,
                    kv_page_checksums=True, **QOS_ENGINE)
    dec = qos_engine(model, dev)
    try:
        hs, _ = prefill_handoffs(pre, [prompts[1]], dev)
        (p2, pages), = hs
        rid, imp_ms = dev_ms(dev, dec.add_request_with_pages, p2, pages,
                             SamplingParams(max_new_tokens=QOS_NEW - 1))
        for _ in dec.stream():
            pass
        got = dec.output_tokens(rid)
        dm = dec.metrics()
        n_blocks = int(pages["k"].shape[1])
        flipped = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                   for k, v in pages.items()}
        flipped["k"].view(np.uint8).flat[flipped["k"].nbytes // 3] ^= 0x10
        free0, n0 = dec.cache.allocator.num_free, len(dec._requests)
        try:
            dec.add_request_with_pages(p2, flipped,
                                       SamplingParams(max_new_tokens=4))
            raised = False
        except KVIntegrityError:
            raised = True
        moved = (dec.cache.allocator.num_free != free0
                 or len(dec._requests) != n0 or dec.has_work())
        rejected = dec.metrics()["kv_pages_rejected"]
    finally:
        pre.close()
        dec.close()
    hand_same = len(got) == len(fifo[1]) and bool((got == fifo[1]).all())
    say(f"serve-qos (c) sealed handoff: {n_blocks} blocks "
        f"({page_bytes(pages)} bytes) verified on import "
        f"({dm['kv_pages_verified']}), add_request_with_pages {imp_ms:.1f} ms "
        f"with the verify; decoded tokens equal FIFO's: {hand_same}; a "
        f"flipped payload raised KVIntegrityError: {raised}, blocks or "
        f"requests moved: {moved}, rejected {rejected}")
    check(dm["kv_pages_verified"] == n_blocks and hand_same,
          "the sealed handoff verifies every block and decodes FIFO's tokens")
    check(raised and not moved and rejected == 1,
          "a flipped payload raises KVIntegrityError before any block moves")
    # the weight audit
    path = os.path.join(root, "llama_1b")
    _, save_ms = dev_ms(dev, save_llama_artifact, model, path)
    aud, boot_ms = dev_ms(dev, lambda: LLMEngine(
        model, device=dev, weight_audit=True, **QOS_ENGINE))
    plain, plain_ms = dev_ms(dev, lambda: LLMEngine(model, device=dev,
                                                    **QOS_ENGINE))
    plain.close()
    try:
        sp = SamplingParams(max_new_tokens=QOS_NEW)
        before = aud.generate(prompts[:half], sp)
        graph0, cap0, rep0 = window_graph(aud)
        ok0, audit_ms = dev_ms(dev, aud.audit_weights)
        ptrs = [p.data_ptr() for p in model.parameters()]
        flip = I.flip_bit(aud, "weights")
        ok1 = aud.audit_weights()
        fails = aud.metrics()["weight_audit_failures"]
        flipped_toks = aud.generate(prompts[:half], sp)
        _, reload_ms = dev_ms(dev, aud.reload_weights, path)
        ok2 = aud.audit_weights()
        after = aud.generate(prompts[:half], sp)
        in_place = [p.data_ptr() for p in model.parameters()] == ptrs
        # a pool page flipped in place under a decoding request, against
        # the same request alone unflipped
        clean = aud.generate([prompts[0]], sp)[0]
        rid = aud.add_request(prompts[0], sp)
        while not aud.request(rid).output_tokens:
            aud.step()
        page = aud.request(rid).blocks[0]
        pool_ptr = aud.cache._groups["k"].data_ptr()
        kv_flip = I.flip_bit(aud, "kv_page", block=page)
        for _ in aud.stream():
            pass
        kv_toks = aud.output_tokens(rid)
        kv_ptr_same = aud.cache._groups["k"].data_ptr() == pool_ptr
        graph1, cap1, rep1 = window_graph(aud)
        am = aud.metrics()
    finally:
        aud.close()
    restored = same_tokens(after, before)
    changed = not same_tokens(flipped_toks, before)
    kv_changed = not bool((kv_toks == clean).all())
    say(f"serve-qos (c) weight audit: artifact saved in {save_ms:.1f} ms; "
        f"engine built in {boot_ms:.1f} ms with the audit's anchor vs "
        f"{plain_ms:.1f} ms without; audit_weights {audit_ms:.1f} ms "
        f"({ok0}); flip_bit(weights) flipped {flip['flips']} tensors in "
        f"place ({in_place}): audit {ok1}, failures {fails}, tokens changed "
        f"{changed}; reload_weights(artifact) {reload_ms:.1f} ms: audit "
        f"{ok2}, tokens equal before the flip {restored}; window captures "
        f"{cap0} -> {cap1}, replays {rep0} -> {rep1}; flip_bit(kv_page) on "
        f"block {page} under a decoding request in place ({kv_ptr_same}): "
        f"pages rejected {am['kv_pages_rejected']} (no CRC covers the pool), "
        f"its tokens changed: {kv_changed}; audits {am['weight_audits']}")
    check(ok0 and not ok1 and fails == 1 and ok2 and restored and in_place
          and am["weight_audit_failures"] == 1,
          "the weight audit fails on the flip and passes after the reload, "
          "tokens restored, in place")
    check(graph1 is graph0 and cap1 == cap0 == (1 if cuda else 0)
          and (rep1 > rep0 or not cuda),
          "no recapture across the flip and the reload")
    check(kv_flip == {"target": "kv_page", "block": page} and kv_ptr_same
          and am["kv_pages_rejected"] == 0,
          "the pool-page flip lands in place, unseen by the page CRCs")
    return counts


@contextlib.contextmanager
def warnings_ignored():
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def tiny_prompts(vocab, seed=SEED + 18):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32)
            for n in rng.randint(20, 61, 8)]


def qos_tiny_run(dev, state, prompts, qos=True):
    """Phase 12d on ``dev``: fp32 llama_tiny, (a)'s traffic at tiny size
    with tenants and tiers, bronze's quota on a step clock, checksums and
    a ``host_entry`` flip, and gold request 5's deadline expiring at the
    start of step 3, mid-decode. Returns (tokens, reasons, tenant_tokens, admission order,
    metrics)."""
    from paddle_tpu_torch.inference.serving import LLMEngine
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                         load_paddle_tpu_state_dict)

    model = LlamaForCausalLM(llama_tiny(), device=dev)
    load_paddle_tpu_state_dict(model, state)
    eng = LLMEngine(model, device=dev, **QOS_TINY)
    try:
        if qos:
            configure_tiers(eng)
            eng.scheduler.configure_tenant(
                "bronze", weight=QOS_WEIGHTS["bronze"],
                rate_tokens_per_s=40.0, window_s=1.0,
                clock=lambda: eng.stats_extra["steps"] * 0.25)
        order = []
        pick = eng.scheduler.pick_prefills

        def recording():
            got = pick()
            order.extend(int(r.rid) for _, r in got)
            return got

        eng.scheduler.pick_prefills = recording

        def expire(e, step, reqs):
            if qos and step == 2 and len(reqs) > 5:
                reqs[5].deadline = time.time() - 1.0

        run = qos_arm(eng, prompts, dev, qos=qos, flip=qos,
                      deadlines={5: time.time() + 3600} if qos else None,
                      hook=expire, new=QOS_TINY_NEW)
        m = eng.metrics()
        order = [run["rids"].index(r) for r in order]
        return run["outs"], run["reasons"], m["tenant_tokens"], order, m
    finally:
        eng.close()


def qos_card_vs_cpu():
    """Phase 12d: the tiny run on the CPU and on the card. Gates: equal
    admission order, tokens and tenant tokens; the run throttled, yielded,
    rejected the flipped spill and timed out one request; every finished
    request (the flipped one re-prefilled) equals its FIFO run's."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    cfg = llama_tiny()
    rng = np.random.RandomState(SEED + 19)
    ref = LlamaForCausalLM(cfg, device="cpu")
    state = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in ref.state_dict().items()}
    prompts = tiny_prompts(cfg.vocab_size)
    runs = {dev: qos_tiny_run(dev, state, prompts)
            for dev in ("cpu", "cuda")}
    fifo = {dev: qos_tiny_run(dev, state, prompts, qos=False)
            for dev in ("cpu", "cuda")}
    c, g = runs["cpu"], runs["cuda"]
    same = same_tokens(c[0], g[0])
    m = g[4]
    live = [i for i, r in enumerate(g[1]) if r != "timeout"]
    fifo_share = {dev: sum(bool((runs[dev][0][i] == fifo[dev][0][i]).all())
                           for i in live) / len(live) for dev in runs}
    say(f"serve-qos (d) card vs cpu llama_tiny fp32: admission order "
        f"{g[3]} (card) vs {c[3]} (CPU); reasons {g[1]}; tenant_tokens "
        f"{g[2]} vs {c[2]}; throttled {m['quota_throttled']}, yields "
        f"{m['batch_yields']}, rejected {m['kv_pages_rejected']}, verified "
        f"{m['kv_pages_verified']}, deadline_expired {m['deadline_expired']}; "
        f"tokens card = CPU: {same}; requests that finished equal their FIFO "
        f"run's: card {fifo_share['cuda']:.3f}, CPU {fifo_share['cpu']:.3f}")
    check(same and g[1:4] == c[1:4],
          "card = CPU: admission order, tokens, reasons and tenant tokens")
    check(fifo_share["cuda"] == fifo_share["cpu"] == 1.0,
          "every finished request, the re-prefilled one included, equals "
          "its FIFO run on both devices")
    check(m["quota_throttled"] > 0 and m["batch_yields"] > 0
          and m["kv_pages_rejected"] == 1 and m["deadline_expired"] == 1,
          "the tiny run throttled, yielded, rejected the flip, timed out")
    return fifo_share


def phase_serve_qos():
    """Phase 12: deadlines, tenants and QoS tiers, and serving integrity,
    llama_1b bf16 at full width and SERVE_CUT_LAYERS layers with phase
    4's prompts: (a) QoS against
    FIFO, the quota arm; (b) deadlines; (c) page checksums, the
    host_entry drill, a sealed handoff, the weight audit and the pool-page
    flip (the artifact under ``TMPDIR``, removed at the end); (d) fp32
    llama_tiny card = CPU. Returns the paged kernels' launches of the QoS,
    FIFO and checksummed runs, each read from its own run with the counts
    set to 0 just before it."""
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = serve_cut_config()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    prompts = serve_prompts(cfg.vocab_size)
    a = timed(qos_arms, model, prompts, "cuda")
    free_cuda()
    timed(deadline_arm, model, "cuda")
    free_cuda()
    root = tempfile.mkdtemp(prefix="serve-qos-")
    try:
        integrity = timed(integrity_arms, model, prompts, a, "cuda", root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model
    free_cuda()
    timed(qos_card_vs_cpu)
    free_cuda()
    return {"qos": a["counts"], "fifo": a["fifo_counts"],
            "integrity": integrity}


# -- the serving fleet ---------------------------------------------------------

# phase 13: phase 10's engine arguments (the serving cell: 2048 blocks of 16,
# eight slots, windows of 8) in every replica, phase 4's prompts, 32 new
# tokens; replica 0 of the kill arm SIGKILLs itself at its 4th busy loop
# tick (after its prefills and first windows: a replica's whole burst is
# seven or eight steps)
FLEET_ENGINE = dict(ART_ENGINE)
FLEET_NEW = ART_NEW
FLEET_KILL_AFTER = 4
# (c)'s split fleet serves the FLEET_SPLIT_REQUESTS shortest prompts: its
# pages cross two pipes as base64 JSON at 0.03-0.07 GB/s
FLEET_SPLIT_REQUESTS = 4
# (e): fp32 llama_tiny, windows of 4; the drill's crash and hang fire at
# each victim's 3rd busy tick, the hang condemned after FLEET_HANG_S
FLEET_TINY = dict(num_blocks=64, block_size=8, max_batch_size=4,
                  decode_steps_per_sync=4)
FLEET_TINY_NEW = 16
FLEET_HANG_S = 3.0
FLEET_BOOT_S = 180.0


@contextlib.contextmanager
def fleets(*specs, meanwhile=None):
    """One ``Router`` for each spec (``artifact``, ``n``, ``dev``,
    ``engine``, ``log_dir`` and Router keywords), all
    spawned at once so their boots overlap (``meanwhile()``, if given,
    runs while they boot); yields [(router, {replica: spawn-to-ready s})]
    once every replica is ready, and closes every router (with the tail
    of each replica log on stderr when the block raised)."""
    from paddle_tpu_torch.inference.serving.fleet import Router

    routers = []
    try:
        for spec in specs:
            spec = dict(spec)
            ekw = dict(spec.pop("engine"), device=spec.pop("dev"))
            routers.append(Router(
                artifact=spec.pop("artifact"), n_replicas=spec.pop("n"),
                engine_kwargs=ekw, wait_ready=False, **spec))
        if meanwhile is not None:
            meanwhile()
        yield [(r, fleet_boot(r)) for r in routers]
    except BaseException:
        for r in routers:
            fleet_logs(r.supervisor.log_dir)
        raise
    finally:
        for r in routers:
            r.close()


def fleet_boot(r):
    """Wait for every replica's ``ready``; returns {replica: spawn-to-ready
    s}."""
    sup = r.supervisor
    sup.wait_ready(FLEET_BOOT_S)
    check(not sup.deaths, f"serve-fleet: no replica died while booting "
          f"({sup.deaths})")
    return {h.id: h.ready_time - h.spawn_time for h in sup.handles}


def fleet_logs(log_dir):
    """The tail of each replica's log on stderr (what a failed arm needs)."""
    for f in sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else ():
        if f.startswith("replica."):
            with open(os.path.join(log_dir, f), errors="replace") as fh:
                tail = fh.read()[-3000:]
            print(f"--- {f}\n{tail}", file=sys.stderr)


def fleet_pump(r, gids, until=None, timeout=180.0, each=None):
    """Step ``r`` until every request in ``gids`` finished and
    ``until()`` (if given) holds, calling ``each()`` after every step.
    Returns the wall s."""
    t0 = time.perf_counter()
    t_end = time.time() + timeout
    while (any(not r.request(g).finished for g in gids)
           or (until is not None and not until())):
        if not r.step():
            time.sleep(0.0005)
        if each is not None:
            each()
        check(time.time() < t_end, "serve-fleet: the burst finished in time")
    return time.perf_counter() - t0


def fleet_serve(r, prompts, new, each=None):
    """Submit every prompt, pump to the end: (outputs, wall s, gids)."""
    gids = [r.submit(p, max_new=new) for p in prompts]
    wall = fleet_pump(r, gids, each=each)
    return [r.result(g) for g in gids], wall, gids


def fleet_stats(r):
    """{replica: its ``stats`` event} for every live replica."""
    out = {h.id: r.replica_stats(h.id) for h in r.supervisor.handles
           if h.alive}
    check(all(s is not None for s in out.values()),
          "serve-fleet: every replica answered stats")
    return out


def fleet_launches(stats, layers, dev, label, zero=()):
    """Each replica's paged-kernel launches since its ``ready``: #1 =
    layers x decode iterations and #2 = layers x prefill chunks (graph
    replays included), none of a kernel in ``zero`` (a role that never
    runs it), and on the card each other kernel launched. Returns the
    counts summed over ``stats``."""
    total = {"paged_decode_attention_cuda": 0,
             "paged_multiquery_attention_cuda": 0}
    for i, s in stats.items():
        c = s["launches"]
        want = {"paged_decode_attention_cuda": layers * s["decode_steps"],
                "paged_multiquery_attention_cuda":
                    layers * s["prefill_chunks"]}
        if dev != "cuda":
            want = dict.fromkeys(want, 0)
        check(c == want, f"serve-fleet {label}: replica {i} launches {c} "
              f"== {layers} x ({s['decode_steps']} decode iterations, "
              f"{s['prefill_chunks']} chunks)")
        for k in c:
            total[k] += c[k]
    for k in total:
        if k in zero:
            check(total[k] == 0, f"serve-fleet {label}: no {k}")
        elif dev == "cuda":
            check(total[k] > 0, f"serve-fleet {label}: {k} launched")
    return total


def fleet_clean(stats, engine, label):
    for i, s in stats.items():
        check(s["blocks_free"] == engine["num_blocks"] - 1
              and s["running"] == 0 and s["waiting"] == 0,
              f"serve-fleet {label}: replica {i}'s allocator clean")


def liveness(log_dir):
    """The ``fleet_replicas_live`` gauge's values, transition by
    transition (``<log_dir>/fleet_liveness.log``: time, value a line)."""
    with open(os.path.join(log_dir, "fleet_liveness.log")) as f:
        return [int(ln.split()[1]) for ln in f]


class DeathWatch:
    """Polls ``/proc/<pid>/stat`` of one process every millisecond on a
    thread; ``.t`` is the wall time it was first seen dead (a zombie or
    gone), for the death-to-detection lag of a kill."""

    def __init__(self, pid):
        import threading

        self.pid, self.t = pid, None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                with open(f"/proc/{self.pid}/stat") as f:
                    dead = f.read().rsplit(")", 1)[1].split()[0] == "Z"
            except OSError:
                dead = True
            if dead:
                self.t = time.time()
                return
            time.sleep(0.001)

    def stop(self):
        self._stop.set()
        self._thread.join()


def fleet_spec(art, n, dev, label, root, engine=None, **kw):
    return dict(artifact=art, n=n, dev=dev, engine=engine or FLEET_ENGINE,
                log_dir=os.path.join(root, label), **kw)


def fleet_colocated_arm(r, boot, prompts, ref, dev, layers, ckpt):
    """(a) two ``"both"`` replicas: tokens equal the in-process engine's
    bit for bit; boot s, TTFT p50, tokens/s, launches. Then (d) on the
    same fleet: ``drain(0, then="reload")`` mid-burst from the
    ``CheckpointManager`` at ``ckpt["root"]``: nothing dropped, no typed error, the reloaded
    step, tokens unchanged, and again after the reload. Returns (a)'s
    launches summed over both replicas."""
    outs, wall, served = fleet_serve(r, prompts, FLEET_NEW)
    check(same_tokens(outs, ref["outs"]),
          "serve-fleet (a): tokens equal the in-process engine's bit for "
          "bit")
    stats = fleet_stats(r)
    counts = fleet_launches(stats, layers, dev, "(a)")
    fleet_clean(stats, FLEET_ENGINE, "(a)")
    n_tok = len(prompts) * FLEET_NEW
    say(f"serve-fleet (a) colocated, 2 replicas: boot "
        + ", ".join(f"replica {i} {boot[i]:.1f} s" for i in sorted(boot))
        + f"; {n_tok} tokens in {wall:.3f} s, {n_tok / wall:.1f} "
        f"tokens/s vs in-process {ref['tps']:.1f}; TTFT p50 "
        f"{p50(r.ttft_seconds()) * 1e3:.1f} ms (router) vs "
        f"{ref['ttft_p50']:.1f} ms (in-process engine); launches "
        + "; ".join(f"replica {i} {launches_str(s['launches'])} = "
                    f"{layers} x ({s['decode_steps']} decode iterations, "
                    f"{s['prefill_chunks']} chunks)"
                    for i, s in sorted(stats.items()))
        + "; tokens bit for bit")
    for g in served:
        r.release(g)
    # (d) drain-reload mid-burst
    gids = [r.submit(p, max_new=FLEET_NEW) for p in prompts]
    while not r.inflight(0) or r.metrics()["queue_depth"]:
        r.step()
    held = len(r.inflight(0))
    t0 = time.perf_counter()
    drained = []
    r.drain(0, then="reload", ckpt_root=ckpt["root"])

    def watch():
        if not drained and r.drains_completed:
            drained.append(time.perf_counter() - t0)

    fleet_pump(r, gids, until=lambda: bool(drained), each=watch)
    outs_d = [r.result(g) for g in gids]
    m = r.metrics()
    errors = [g for g in gids if r.request(g).error is not None]
    check(not errors and same_tokens(outs_d, ref["outs"])
          and m["requests_shed"] == 0 and m["deadline_expired"] == 0,
          "serve-fleet (d): nothing dropped, no typed error, tokens "
          "unchanged")
    check(r.reloads == [(0, ckpt["step"])] and r.drains_completed == 1,
          f"serve-fleet (d): replica 0 reloaded step {ckpt['step']} "
          f"({r.reloads})")
    again, _, _ = fleet_serve(r, prompts, FLEET_NEW)
    check(same_tokens(again, ref["outs"]),
          "serve-fleet (d): the reloaded fleet's tokens unchanged")
    say(f"serve-fleet (d) drain(0, then='reload') with {held} requests in "
        f"flight on replica 0: drain wall {drained[0]:.3f} s (they "
        f"finished, then the weights reloaded from step {ckpt['step']}); "
        f"dropped 0, typed errors 0, tokens bit for bit before and after "
        f"the reload")
    return counts


def fleet_kill_arm(r, boot, prompts, ref):
    """(b) ``serve.replica_crash`` on replica 0 after its first windows:
    death-to-detection, respawn-to-ready, restarts, redispatches, the
    liveness gauge's dip and recovery; every request ends with its 32
    tokens, the tokens emitted before the kill unchanged, the agreement
    after it reported."""
    sup = r.supervisor
    watch = DeathWatch(sup.handles[0].pid)
    cut = {}
    gids = [r.submit(p, max_new=FLEET_NEW) for p in prompts]

    def each():
        for g in gids:
            q = r.request(g)
            if q.redispatches and g not in cut:
                cut[g] = len(q.emitted)

    def respawned():
        h = sup.handles[0]
        return h.incarnation == 1 and h.ready

    wall = fleet_pump(r, gids, each=each)
    check(bool(sup.deaths), "serve-fleet (b): replica 0 was killed "
          "mid-burst")
    fleet_pump(r, [], until=respawned, each=each)
    watch.stop()
    h = sup.handles[0]
    ready = h.ready_time - h.spawn_time
    deaths = sup.deaths
    outs = [r.result(g) for g in gids]
    m = r.metrics()
    dip = liveness(sup.log_dir)
    check(len(deaths) == 1 and deaths[0]["reason"] == "crash",
          f"serve-fleet (b): one crash reported ({deaths})")
    check(all(len(o) == len(p) + FLEET_NEW for o, p in zip(outs, prompts)),
          "serve-fleet (b): every request ends with its new tokens")
    check(cut and all(
        (outs[i][:len(prompts[i]) + cut[g]]
         == ref["outs"][i][:len(prompts[i]) + cut[g]]).all()
        for i, g in enumerate(gids) if g in cut),
        "serve-fleet (b): the tokens emitted before the kill unchanged")
    check(all(same_tokens([outs[i]], [ref["outs"][i]])
              for i, g in enumerate(gids) if g not in cut),
          "serve-fleet (b): requests never on the killed replica equal "
          "(a)'s")
    check(m["replica_restarts"] == 1 and m["redispatches"] == len(cut)
          and m["replicas_live"] == 2 and min(dip) == 1 and dip[-1] == 2,
          f"serve-fleet (b): restarts {m['replica_restarts']}, "
          f"redispatches {m['redispatches']}, liveness {dip}")
    fleet_clean(fleet_stats(r), FLEET_ENGINE, "(b)")
    after = [(outs[i][len(prompts[i]) + cut[g]:],
              ref["outs"][i][len(prompts[i]) + cut[g]:])
             for i, g in enumerate(gids) if g in cut]
    same_req = sum(bool((a == b).all()) for a, b in after)
    same_tok = sum(int((a == b).sum()) for a, b in after)
    n_tok = sum(len(a) for a, _ in after)
    say(f"serve-fleet (b) kill: replica 0 SIGKILLed itself at its busy "
        f"tick {FLEET_KILL_AFTER}; death-to-detection "
        f"{(deaths[0]['detected'] - watch.t) * 1e3:.1f} ms (its main "
        f"thread dead to the supervisor's waitpid; the final events "
        f"drained in "
        f"{(deaths[0]['handled'] - deaths[0]['detected']) * 1e3:.1f} ms); "
        f"respawn-to-ready "
        f"{ready:.1f} s (first boot {boot[0]:.1f} s); replica_restarts "
        f"{m['replica_restarts']}, redispatches {m['redispatches']} "
        f"(tokens emitted before the kill {sorted(cut.values())}, "
        f"unchanged); liveness gauge {dip}; after the kill {same_req} of "
        f"{len(after)} redispatched requests and {same_tok} of {n_tok} "
        f"tokens equal (a)'s; all {len(prompts)} requests complete in "
        f"{wall:.3f} s")


def fleet_split_arm(r, boot, prompts, ref, dev, layers):
    """(c) a ``["prefill", "decode"]`` fleet: tokens equal (a)'s bit for
    bit; page bytes, frames and GB/s on each pipe hop; #1 = 0 on the
    prefill replica, #2 = 0 on the decode replica. Returns the two
    replicas' launches."""
    outs, wall, _ = fleet_serve(r, prompts, FLEET_NEW)
    m = r.metrics()
    check(same_tokens(outs, ref["outs"]),
          "serve-fleet (c): tokens equal (a)'s bit for bit")
    check(m["prefill_handoffs"] == len(prompts)
          and m["kv_transfer_retries"] == 0 and m["handoff_failovers"] == 0,
          f"serve-fleet (c): {len(prompts)} handoffs, no retry ({m})")
    stats = fleet_stats(r)
    pre = fleet_launches({0: stats[0]}, layers, dev, "(c) prefill",
                         zero=("paged_decode_attention_cuda",))
    dec = fleet_launches({1: stats[1]}, layers, dev, "(c) decode",
                         zero=("paged_multiquery_attention_cuda",))
    fleet_clean(stats, FLEET_ENGINE, "(c)")
    nbytes = stats[0]["kv_sent_bytes"]
    check(stats[1]["kv_recv_bytes"] == nbytes,
          f"serve-fleet (c): the decode replica received the "
          f"{nbytes} page bytes the prefill replica sent "
          f"({stats[1]['kv_recv_bytes']})")
    up_s = stats[0]["kv_send_ms"] / 1e3
    down_s = stats[1]["kv_recv_ms"] / 1e3
    n_tok = len(prompts) * FLEET_NEW
    say(f"serve-fleet (c) split prefill/decode: boot {boot[0]:.1f} / "
        f"{boot[1]:.1f} s; {m['prefill_handoffs']} handoffs, {nbytes} "
        f"page bytes in {m['kv_pages_transferred']} frames; "
        f"prefill->router {nbytes / up_s / 1e9:.3f} GB/s "
        f"({up_s * 1e3:.1f} ms: export, pack, base64 frames on the pipe), "
        f"router->decode {nbytes / down_s / 1e9:.3f} GB/s "
        f"({down_s * 1e3:.1f} ms: a handoff's first frame to its "
        f"submit_pages at the decode replica); {n_tok} tokens in "
        f"{wall:.3f} s, {n_tok / wall:.1f} "
        f"tokens/s; TTFT p50 {p50(r.ttft_seconds()) * 1e3:.1f} ms; "
        f"launches prefill {launches_str(pre)}, decode "
        f"{launches_str(dec)}; tokens bit for bit")
    return pre, dec


def fleet_tiny_run(r, prompts):
    """fp32 llama_tiny prompts through fleet ``r``, pumped until every
    replica is back up: (outputs, metrics, the deaths its supervisor
    reported)."""
    sup = r.supervisor
    gids = [r.submit(p, max_new=FLEET_TINY_NEW) for p in prompts]
    fleet_pump(r, gids, until=lambda: all(
        h.ready and h.alive for h in sup.handles))
    return [r.result(g) for g in gids], r.metrics(), sup.deaths


def fleet_tiny_card_vs_cpu(root):
    """(e) fp32 llama_tiny: the colocated fleet on the card, and a drill
    fleet of three (replica 0 crashes, replica 1 hangs under
    ``hang_timeout_s``: SIGTERM, then SIGKILL after the grace), each equal
    bit for bit to a colocated fleet of the port on the CPU; the
    escalation's times. The three fleets boot together."""
    from paddle_tpu_torch.inference.serving import save_llama_artifact
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    model = LlamaForCausalLM(llama_tiny(), device="cpu", seed=SEED)
    art = os.path.join(root, "tiny")
    save_llama_artifact(model, art)
    prompts = tiny_prompts(llama_tiny().vocab_size)
    sites = [{"site": "serve.replica_crash", "replica": 0, "after": 3},
             {"site": "serve.replica_hang", "replica": 1, "after": 3}]
    specs = [fleet_spec(art, 2, "cpu", "tiny-cpu", root, FLEET_TINY),
             fleet_spec(art, 2, "cuda", "tiny-card", root, FLEET_TINY),
             fleet_spec(art, 3, "cuda", "tiny-drill", root, FLEET_TINY,
                        env_extra={"CHAOS_SERVE_SITES": json.dumps(sites)},
                        hang_timeout_s=FLEET_HANG_S, max_restarts=2)]
    with fleets(*specs) as ((cpu_r, _), (card_r, _), (drill_r, _)):
        cpu, _, _ = fleet_tiny_run(cpu_r, prompts)
        card, _, _ = fleet_tiny_run(card_r, prompts)
        check(same_tokens(card, cpu),
              "serve-fleet (e): fp32 colocated fleet card = CPU bit for bit")
        drill, m, deaths = fleet_tiny_run(drill_r, prompts)
    check(same_tokens(drill, cpu),
          "serve-fleet (e): the crash and hang replays on the card = the "
          "CPU fleet bit for bit")
    kinds = sorted((d["replica"], d["reason"]) for d in deaths)
    check(kinds == [(0, "crash"), (1, "hang")]
          and m["replica_restarts"] == 2 and m["redispatches"] >= 2,
          f"serve-fleet (e): deaths {kinds}, restarts "
          f"{m['replica_restarts']}, redispatches {m['redispatches']}")
    hang = next(d for d in deaths if d["reason"] == "hang")
    crash = next(d for d in deaths if d["reason"] == "crash")
    how = ("SIGTERM sufficed" if hang["rc"] == -15
           else "SIGKILL after the grace")
    say(f"serve-fleet (e) fp32 llama_tiny card = CPU: colocated fleet "
        f"bit for bit; drill fleet of 3 bit for bit with replica 0 "
        f"crashed (rc {crash['rc']}) and replica 1 hung: condemned "
        f"{hang['detected'] - hang['last_beat']:.3f} s after its last "
        f"heartbeat (hang_timeout_s {FLEET_HANG_S}), SIGTERM to exit and "
        f"the final events drained in "
        f"{(hang['handled'] - hang['detected']) * 1e3:.1f} ms, rc "
        f"{hang['rc']} ({how}); restarts {m['replica_restarts']}, "
        f"redispatches {m['redispatches']}")


def phase_serve_fleet():
    """Phase 13: the serving fleet, llama_1b bf16 at full width and
    SERVE_CUT_LAYERS layers from a bf16 artifact (``TMPDIR``, removed at the end) with phase 4's prompts
    and phase 10's engine arguments in each replica process: (a) two
    colocated replicas against one in-process engine, then (d) a
    drain-reload on the same fleet; (b) a replica killed mid-burst and
    (c) a prefill/decode split, their fleets booted together; (e) fp32
    llama_tiny fleets on the card against the CPU. Returns the replicas'
    paged-kernel launches of (a) (both replicas summed) and of (c)'s
    prefill and decode replicas, each counted since the replica's
    ``ready``."""
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.inference.serving import (LLMEngine,
                                                    SamplingParams,
                                                    save_llama_artifact)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.cuda import _build

    _build.build_all()  # every replica only loads the libraries
    free_cuda()
    cfg = serve_cut_config()
    layers = cfg.num_hidden_layers
    prompts = serve_prompts(cfg.vocab_size)
    root = tempfile.mkdtemp(prefix="serve-fleet-")
    try:
        model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                 seed=SEED)
        art = os.path.join(root, "llama_1b")
        save_llama_artifact(model, art)
        with LLMEngine(model, device="cuda", ingest_async=False,
                       **FLEET_ENGINE) as eng:
            eng.generate([prompts[1][:64]], SamplingParams(max_new_tokens=2))
            eng.reset_metrics()
            sync("cuda")
            t0 = time.perf_counter()
            outs = eng.generate(prompts, SamplingParams(
                max_new_tokens=FLEET_NEW))
            sync("cuda")
            wall = time.perf_counter() - t0
            ttft = eng.metrics()["ttft_ms"]["p50"]
        ref = {"outs": outs, "tps": len(prompts) * FLEET_NEW / wall,
               "ttft_p50": ttft}
        free_cuda()
        ckpt = {"root": os.path.join(root, "ckpt"), "step": 1}
        t0 = time.perf_counter()
        with fleets(fleet_spec(art, 2, "cuda", "colocated", root,
                               ckpt_root=ckpt["root"]),
                    # the checkpoint (d) reloads, written during the boot
                    meanwhile=lambda: CheckpointManager(ckpt["root"]).save(
                        ckpt["step"], model=model)) as [(r, b)]:
            colocated = fleet_colocated_arm(r, b, prompts, ref, "cuda",
                                            layers, ckpt)
        say(f"wall serve-fleet (a), (d): {time.perf_counter() - t0:.1f} s")
        del model
        free_cuda()
        t0 = time.perf_counter()
        with fleets(fleet_spec(art, 2, "cuda", "kill", root, max_restarts=2,
                               env_extra={
                                   "CHAOS_SERVE_SITE": "serve.replica_crash",
                                   "CHAOS_SERVE_REPLICA": "0",
                                   "CHAOS_SERVE_AFTER_STEPS":
                                       str(FLEET_KILL_AFTER)}),
                    fleet_spec(art, 2, "cuda", "split", root,
                               roles=["prefill", "decode"])) as (
                (kill_r, kill_b), (split_r, split_b)):
            fleet_kill_arm(kill_r, kill_b, prompts, ref)
            short = sorted(range(len(prompts)),
                           key=lambda i: len(prompts[i]))
            short = short[:FLEET_SPLIT_REQUESTS]
            pre, dec = fleet_split_arm(
                split_r, split_b, [prompts[i] for i in short],
                {"outs": [ref["outs"][i] for i in short]}, "cuda", layers)
        say(f"wall serve-fleet (b), (c): {time.perf_counter() - t0:.1f} s")
        timed(fleet_tiny_card_vs_cpu, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_cuda()
    return {"colocated": colocated, "split_prefill": pre,
            "split_decode": dec}


# phase 14: phase 10's engine arguments per step (a multi-process plan's
# collectives cannot be captured in a window graph on the card), TP_NEW
# new tokens; the group's rank 1 is killed at its TP_KILL_AFTER-th busy
# tick in (b)
TP_ENGINE = dict(ART_ENGINE, decode_steps_per_sync=1)
TP_PLAN = {"axes": {"tp": 2}, "strategies": ["tp"]}
TP_NEW = 16
TP_KILL_AFTER = 12   # mid-burst: before any request has its TP_NEW tokens
TP_TINY = dict(num_blocks=64, block_size=8, max_batch_size=4)
TP_CHILD_S = 300.0


def tp_kernel_cases(gen):
    """#1 and #2 at a tensor-parallel rank's shape on llama_1b (8 query
    and 8 KV heads, D 128, bf16 q and pool, block 16, 128 pages): the
    decode of phase 4's batch at its contexts after 16 new tokens, and
    the prefill chunk of its longest prompt (T 2048, 1536 real), each held
    to its plain version. Returns {kernel: max abs error}."""
    import numpy as np

    prompts = serve_prompts(32000)
    lens = np.array([len(p) + 16 for p in prompts])
    c = Case(gen, B=8, H=8, Hkv=8, D=128, bs=16, P=128, q_dtype="bfloat16",
             kv="bfloat16", lens=lens)
    err, excess = compare(decode_kernel(c), decode_plain(c, upcast=True),
                          "bfloat16")
    check(excess <= 0, "decode at the tp rank's shape (8 heads)")
    c2 = Case(gen, B=1, H=8, Hkv=8, D=128, bs=16, P=128, q_dtype="bfloat16",
              kv="bfloat16", lens=[1536], T=2048, starts=[0])
    got, want = mq_kernel(c2), mq_plain(c2, upcast=True)
    err2, excess2 = compare(got[:, :1536], want[:, :1536], "bfloat16")
    check(excess2 <= 0, "multi-query at the tp rank's shape (8 heads)")
    tol = f"{ATOL:g} + {RTOL['bfloat16']:g}*|want|"
    say(f"serve-plan kernels at a rank's shape (H 8, Hkv 8, D 128, bf16): "
        f"decode B 8, contexts {sorted(int(x) for x in lens)}: max_abs_err "
        f"{err:.3e}; multi-query T 2048 (1536 real): max_abs_err "
        f"{err2:.3e} (tol {tol})")
    return {"paged_decode_attention": err,
            "paged_multiquery_attention": err2}


def tp_child(rank, port, art, tiny_art, stale, out):
    """``chip_smoke.py --tp-child RANK PORT ARTIFACT TINY STALE OUT``: one
    rank of phase 14a's tp=2 group, joined over gloo by
    ``init_parallel_env`` (two ranks share the one card), serving the
    llama_1b artifact ``ARTIFACT`` per step with phase 10's engine
    arguments: a warm-up request, then phase 4's prompts timed (tokens,
    wall, TTFT p50, decode iterations and chunks, #1/#2 launches by the
    wrapper and by the kernels' device tally, the all_reduce calls and
    host seconds); the window refusal; then (c) fp32 llama_tiny
    (``TINY``) on the card and on the CPU in the same group, and (d)
    ``reload_weights`` from the stale checkpoint root ``STALE``. Writes
    its results as JSON to ``OUT``."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import (communication,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         PlanMismatchError)
    from paddle_tpu_torch.distributed.plan import Plan, PlanError
    from paddle_tpu_torch.inference.serving import (LLMEngine,
                                                    SamplingParams,
                                                    load_llama_artifact)
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    if not torch.cuda.is_available():
        print("chip_smoke --tp-child: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    init_parallel_env(rank=rank, world_size=2,
                      init_method=f"tcp://127.0.0.1:{port}", device="cuda",
                      timeout_s=TP_CHILD_S)
    import torch.distributed as dist

    res = {"backend": dist.get_backend()}
    plan = Plan.build(TP_PLAN["axes"], TP_PLAN["strategies"])
    model = load_llama_artifact(art, device="cuda", dtype="saved")
    try:
        LLMEngine(model, plan=plan, device="cuda", ingest_async=False,
                  **ART_ENGINE)
        res["window_refused"] = None
    except PlanError as e:
        res["window_refused"] = str(e)
    prompts = serve_prompts(model.config.vocab_size)
    with LLMEngine(model, plan=plan, device="cuda", ingest_async=False,
                   **TP_ENGINE) as eng:
        attn = model.llama.layers[0].self_attn
        res["local"] = [attn.num_heads, attn.num_kv_heads,
                        list(eng.cache.k[0].shape)]
        eng.generate([prompts[1][:64]], SamplingParams(max_new_tokens=2))
        eng.reset_metrics()
        reset_paged_counts()
        communication.reset_collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=TP_NEW))
        torch.cuda.synchronize()
        res["wall"] = time.perf_counter() - t0
        m = eng.metrics()
        res.update(tokens=[o.tolist() for o in outs],
                   ttft_p50=m["ttft_ms"]["p50"],
                   decode_steps=m["decode_steps"],
                   chunks=m["prefill_chunks"], launches=K.launch_counts(),
                   tally=K.device_tally(),
                   collectives=communication.collective_stats())
    del model
    torch.cuda.empty_cache()
    tiny = {}
    for dev in ("cuda", "cpu"):
        m = load_llama_artifact(tiny_art, device=dev)
        with LLMEngine(m, plan=Plan.build(TP_PLAN["axes"],
                                          TP_PLAN["strategies"]),
                       device=dev, ingest_async=False, **TP_TINY) as eng:
            tiny[dev] = [o.tolist() for o in eng.generate(
                tiny_prompts(m.config.vocab_size),
                SamplingParams(max_new_tokens=FLEET_TINY_NEW))]
            if dev == "cuda":
                before = {n: p.detach().clone()
                          for n, p in m.named_parameters()}
                try:
                    eng.reload_weights(CheckpointManager(stale))
                    res["stale"] = None
                except PlanMismatchError as e:
                    res["stale"] = str(e)
                res["stale_untouched"] = all(
                    torch.equal(p, before[n])
                    for n, p in m.named_parameters())
    res["tiny"] = tiny
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def tp_group_direct(art, tiny_art, stale, root):
    """Phase 14a: the two ``--tp-child`` ranks at once; returns their
    results (rank order). Both processes end before it returns."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    outs = [os.path.join(root, f"tp-rank{r}.json") for r in (0, 1)]
    logs = [open(os.path.join(root, f"tp-rank{r}.log"), "w") for r in (0, 1)]
    env = dict(os.environ, TORCH_CPP_LOG_LEVEL="ERROR")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-child", str(r),
         str(port), art, tiny_art, stale, outs[r]], env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in (0, 1)]
    try:
        for p in procs:
            p.wait(timeout=TP_CHILD_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        for r in (0, 1):
            with open(os.path.join(root, f"tp-rank{r}.log"),
                      errors="replace") as f:
                print(f"--- tp rank {r}\n{f.read()[-4000:]}",
                      file=sys.stderr)
    check(all(p.returncode == 0 for p in procs),
          f"serve-plan (a): both ranks ran ({[p.returncode for p in procs]})")
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    return res


def tp_direct_report(ranks, ref, layers):
    """Phase 14a's checks and line: both ranks' tokens identical, their
    agreement with the single-process engine, each rank's #1/#2 launches
    against layers x its iterations and chunks (wrapper and device tally),
    tokens/s, TTFT p50 and the all_reduce share of the wall. Returns the
    ranks' launches."""
    import numpy as np

    r0, r1 = ranks
    check(r0["tokens"] == r1["tokens"], "serve-plan (a): rank 0 and rank 1 "
          "emit the same tokens")
    check(all(r["backend"] == "gloo" for r in ranks),
          "serve-plan (a): gloo, chosen for two ranks on one card")
    check(all(r["local"] == [8, 8, [2048, 16, 8, 128]] for r in ranks),
          f"serve-plan (a): each rank holds 8 query and 8 KV heads and a "
          f"pool of its own heads ({r0['local']})")
    check(all(r["window_refused"] and "decode_steps_per_sync"
              in r["window_refused"] for r in ranks),
          "serve-plan (a): decode windows refused with PlanError on the "
          "card")
    launches = {}
    for i, r in enumerate(ranks):
        want = {"paged_decode_attention_cuda": layers * r["decode_steps"],
                "paged_multiquery_attention_cuda": layers * r["chunks"]}
        t = r["tally"]
        dev = {"paged_decode_attention_cuda": t["paged_decode_split_kernel"],
               "paged_multiquery_attention_cuda":
                   t["paged_multiquery_kernel"]
                   + t["paged_multiquery_tc_kernel"]}
        check(r["launches"] == want == dev and r["chunks"] > 0
              and r["decode_steps"] > 0,
              f"serve-plan (a): rank {i} launches {r['launches']} == device "
              f"tally {dev} == {layers} x ({r['decode_steps']} decode "
              f"iterations, {r['chunks']} chunks)")
        launches[f"rank{i}"] = r["launches"]
    outs = [np.asarray(t) for t in r0["tokens"]]
    same = same_share(outs, ref["outs"])
    n = sum(len(o) - len(p) for o, p in zip(outs, ref["prompts"]))
    agree = sum(int((o[len(p):] == w[len(p):]).sum()) for o, w, p in
                zip(outs, ref["outs"], ref["prompts"]))
    ar = r0["collectives"].get("all_reduce", {"calls": 0, "seconds": 0.0})
    tps = len(outs) * TP_NEW / r0["wall"]
    say(f"serve-plan (a) llama_1b bf16 tp=2, two ranks on one card over "
        f"gloo, per step: {tps:.1f} tokens/s (rank 0's wall "
        f"{r0['wall']:.3f} s; the single-process engine per step "
        f"{ref['tps']:.1f}), TTFT p50 {r0['ttft_p50']} ms (single "
        f"{ref['ttft_p50']} ms); all_reduce {ar['calls']} calls, "
        f"{ar['seconds']:.3f} s of host time blocked in them = "
        f"{ar['seconds'] / r0['wall']:.3f} of the wall; tokens equal the "
        f"single-process engine's in {same:.3f} of requests, {agree} of "
        f"{n} tokens; launches a rank {r0['launches']} (rank 1 "
        f"{r1['launches']}), {r0['decode_steps']} decode iterations, "
        f"{r0['chunks']} chunks")
    return launches


def tp_fleet_exact(r, boot, prompts, direct):
    """Phase 14b, the clean fleet: its tp=2 group's tokens bit for bit
    (a)'s, rank 0's allocator clean, both members live; then drain and
    retire end every member."""
    outs, wall, _ = fleet_serve(r, prompts, TP_NEW)
    check(same_tokens(outs, direct),
          "serve-plan (b): the fleet's tp=2 group equals the directly "
          "launched group bit for bit")
    h = r.supervisor.handles[0]
    stats = r.replica_stats(0)
    check(stats["blocks_free"] == TP_ENGINE["num_blocks"] - 1
          and stats["running"] == 0 and h.members_live == 2,
          "serve-plan (b): rank 0's allocator clean, both members live")
    t0 = time.perf_counter()
    r.drain(0, then="retire", wait=True, timeout=120)
    procs = [h.proc] + list(h.members)
    check(h.retired and all(p.poll() is not None for p in procs),
          "serve-plan (b): drain then retire ended every member")
    say(f"serve-plan (b) fleet: Router(group_size=2, plan=tp2) over the "
        f"artifact, boot {boot[0]:.1f} s, 8 requests in {wall:.3f} s "
        f"({len(prompts) * TP_NEW / wall:.1f} tokens/s), bit for bit (a)'s; "
        f"drain and retire {time.perf_counter() - t0:.3f} s, every member "
        f"ended (rc {[p.poll() for p in procs]})")


def tp_fleet_kill(r, boot, prompts, direct):
    """Phase 14b, the drill fleet: rank 1 SIGKILLs itself at its
    TP_KILL_AFTER-th busy tick. The whole group is felled and respawned
    on a fresh port, the tokens emitted before the kill equal (a)'s, and
    each replay equals the respawned group serving its replay prompt
    (prompt + tokens before the kill) afresh."""
    sup = r.supervisor
    h = sup.handles[0]
    port0 = h.coord_port
    watch = DeathWatch(h.members[0].pid)
    cut = {}
    gids = [r.submit(p, max_new=TP_NEW) for p in prompts]

    def each():
        for g in gids:
            q = r.request(g)
            if q.redispatches and g not in cut:
                cut[g] = len(q.emitted)

    def respawned():
        x = sup.handles[0]
        return x.incarnation == 1 and x.ready

    wall = fleet_pump(r, gids, each=each)
    fleet_pump(r, [], until=respawned, each=each)
    watch.stop()
    deaths = sup.deaths
    check(len(deaths) == 1 and deaths[0]["reason"] == "crash"
          and deaths[0]["rank"] == 1,
          f"serve-plan (b): one crash, at group rank 1 ({deaths})")
    new = sup.handles[0]
    check(new.coord_port != port0 and new.members_live == 2,
          f"serve-plan (b): the group respawned whole on a fresh port "
          f"(port {port0} -> {new.coord_port}, members live "
          f"{new.members_live})")
    killed = [r.result(g) for g in gids]
    check(all(len(o) == len(p) + TP_NEW for o, p in zip(killed, prompts)),
          "serve-plan (b): every request ends with its new tokens")
    hit = [(i, g) for i, g in enumerate(gids) if g in cut]
    check(hit and all((killed[i][:len(prompts[i]) + cut[g]]
                       == direct[i][:len(prompts[i]) + cut[g]]).all()
                      for i, g in hit),
          "serve-plan (b): the tokens emitted before the kill equal (a)'s")
    # each replay against the respawned group serving its replay prompt
    again = [r.submit(killed[i][:len(prompts[i]) + cut[g]],
                      max_new=TP_NEW - cut[g]) for i, g in hit]
    fleet_pump(r, again)
    replays = [killed[i] for i, _ in hit]
    check(same_tokens([r.result(g) for g in again], replays),
          "serve-plan (b): every replay equals the respawned group serving "
          "its replay prompt afresh")
    same_after = sum(bool((killed[i] == direct[i]).all()) for i, _ in hit)
    m = r.metrics()
    dip = liveness(sup.log_dir)
    check(m["replica_restarts"] == 1 and m["redispatches"] == len(cut)
          and min(dip) == 0 and dip[-1] == 1,
          f"serve-plan (b): restarts {m['replica_restarts']}, "
          f"redispatches {m['redispatches']}, liveness {dip}")
    say(f"serve-plan (b) kill: rank 1 of the group SIGKILLed itself at its "
        f"busy tick {TP_KILL_AFTER}: death-to-detection "
        f"{(deaths[0]['detected'] - watch.t) * 1e3:.1f} ms, the group "
        f"felled (rc {deaths[0]['rc']}) and respawned on a fresh port, "
        f"ready {new.ready_time - new.spawn_time:.1f} s after its spawn "
        f"(first boot {boot[0]:.1f} s); restarts {m['replica_restarts']}, "
        f"redispatches {m['redispatches']} (tokens before the kill "
        f"{sorted(cut.values())}, equal (a)'s), liveness {dip}; every "
        f"replay equals its replay prompt served afresh, {same_after} of "
        f"{len(hit)} also equal (a)'s uninterrupted tokens; the burst took "
        f"{wall:.3f} s")


def phase_serve_plan():
    """Phase 14: sharding plans, llama_1b bf16 at full width and
    SERVE_CUT_LAYERS layers from a bf16 artifact (``TMPDIR``) with phase 4's prompts and phase 10's engine
    arguments per step: #1 and #2 at a rank's shape against their plain
    versions; (a) a tp=2 group of two ``--tp-child`` processes on the one
    card, against the single-process engine; (b) a ``Router`` whose slot
    is a tp=2 group: bit for bit (a), a member's kill, drain and retire;
    (c) fp32 llama_tiny tp=2, card = CPU; (d) a stale ``plan.json``
    refused. Returns ({kernel: max abs error}, each rank's launches in
    (a))."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.plan import Plan
    from paddle_tpu_torch.inference.serving import (LLMEngine,
                                                    SamplingParams,
                                                    save_llama_artifact)
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    worst = tp_kernel_cases(gen)
    free_cuda()
    cfg = serve_cut_config()
    prompts = serve_prompts(cfg.vocab_size)
    root = tempfile.mkdtemp(prefix="serve-plan-")
    try:
        model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                 seed=SEED)
        art = os.path.join(root, "llama_1b")
        save_llama_artifact(model, art)
        with LLMEngine(model, device="cuda", ingest_async=False,
                       **TP_ENGINE) as eng:
            eng.generate([prompts[1][:64]], SamplingParams(max_new_tokens=2))
            eng.reset_metrics()
            sync("cuda")
            t0 = time.perf_counter()
            outs = eng.generate(prompts, SamplingParams(
                max_new_tokens=TP_NEW))
            sync("cuda")
            wall = time.perf_counter() - t0
            ttft = eng.metrics()["ttft_ms"]["p50"]
        ref = {"outs": outs, "prompts": prompts,
               "tps": len(prompts) * TP_NEW / wall, "ttft_p50": ttft}
        del model, eng
        free_cuda()
        tiny = LlamaForCausalLM(llama_tiny(), device="cpu", seed=SEED)
        tiny_art = os.path.join(root, "tiny")
        save_llama_artifact(tiny, tiny_art)
        stale = os.path.join(root, "stale")
        CheckpointManager(stale).save(
            1, model=tiny, plan=Plan.build({"tp": 4}, ["tp"],
                                           devices=range(4)))
        t0 = time.perf_counter()
        ranks = tp_group_direct(art, tiny_art, stale, root)
        launches = tp_direct_report(ranks, ref, cfg.num_hidden_layers)
        say(f"wall serve-plan (a): {time.perf_counter() - t0:.1f} s")
        direct = [np.asarray(t) for t in ranks[0]["tokens"]]
        cpu, card = ranks[0]["tiny"]["cpu"], ranks[0]["tiny"]["cuda"]
        check(card == cpu and ranks[1]["tiny"] == ranks[0]["tiny"],
              "serve-plan (c): fp32 llama_tiny tp=2 tokens card = CPU")
        say(f"serve-plan (c) fp32 llama_tiny tp=2 over gloo: {len(card)} "
            f"requests, tokens card = CPU")
        check(all(r["stale"] and "mesh" in r["stale"] and
                  r["stale_untouched"] for r in ranks),
              "serve-plan (d): a stale plan.json refused with "
              "PlanMismatchError, weights untouched")
        say(f"serve-plan (d) stale plan.json refused: {ranks[0]['stale']}")
        t0 = time.perf_counter()
        group = dict(artifact=art, n=1, dev="cuda", engine=TP_ENGINE,
                     group_size=2, plan=TP_PLAN)
        kill = {"CHAOS_SERVE_SITES": json.dumps(
            [{"site": "serve.group_member_crash", "replica": 0, "rank": 1,
              "after": TP_KILL_AFTER}])}
        # the clean fleet and the drill fleet boot together
        with fleets(dict(group, log_dir=os.path.join(root, "clean")),
                    dict(group, log_dir=os.path.join(root, "kill"),
                         max_restarts=2, env_extra=kill)) as (
                (clean_r, clean_b), (kill_r, kill_b)):
            tp_fleet_exact(clean_r, clean_b, prompts, direct)
            tp_fleet_kill(kill_r, kill_b, prompts, direct)
        say(f"wall serve-plan (b): {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_cuda()
    return worst, launches


# -- bench.py bert_varlen on the port (phase 15) ------------------------------

# the arms of scripts/bench_bucketing.py:run_stream, in the order they run
VARLEN_ARMS = ("naive", "pipeline", "jit")
VARLEN_EPOCHS = 2
# phase 15's kernel cases: BERT-base's heads at the stream's shortest and
# longest bucket (B, H, S, D, dtype, causal, what)
VARLEN_FLASH_CASES = [(32, 12, s, 64, "bfloat16", False, f"bert_varlen S={s}")
                      for s in (72, 232)]


def varlen_sizing(tiny):
    """``(cfg, bs, lengths, boundaries, samples_per_len)`` as
    ``scripts/bench_bucketing.py:default_sizing``: BERT-base (or
    bert_tiny) with both dropouts 0, 32 x 10 lengths in [72, 232) into
    buckets [96, 160, 232], 64 samples a length (tiny: 4, [8, 28), [12,
    20, 28], 4)."""
    from paddle_tpu_torch.models import bert_base, bert_tiny

    cfg = (bert_tiny if tiny else bert_base)(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    bs = 4 if tiny else 32
    lengths = list(range(8, 28, 2)) if tiny else list(range(72, 232, 16))
    boundaries = [12, 20, 28] if tiny else [96, 160, 232]
    return cfg, bs, lengths, boundaries, bs * (1 if tiny else 2)


def varlen_dataset(cfg, lengths, samples_per_len, seed=0):
    """Map-style ``(ids[L], label)`` samples, every length
    ``samples_per_len`` times, drawn from ``RandomState(seed)`` as
    ``scripts/bench_bucketing.py:varlen_dataset`` draws them (ids in
    [1, vocab): 0 is the pad)."""
    import numpy as np

    from paddle_tpu_torch import io

    rng = np.random.RandomState(seed)
    samples = [(rng.randint(1, cfg.vocab_size, (n,)).astype(np.int64),
                np.int64(rng.randint(0, cfg.num_labels)))
               for n in lengths for _ in range(samples_per_len)]

    class VarLenDS(io.Dataset):
        def __len__(self):
            return len(samples)

        def __getitem__(self, i):
            return samples[i]

    return VarLenDS()


def varlen_step(cfg, dev, dtype, shape_buckets=None, state=None):
    """``scripts/bench_bucketing.py:build_step`` on the port: a
    ``BertForSequenceClassification`` (weights from the seed, or the
    numpy ``state``) in training mode under ``fused_train_step`` with
    AdamW(2e-5), loss ``o[0]`` and ``shape_buckets``."""
    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         load_paddle_tpu_state_dict)
    from paddle_tpu_torch.optimizer import AdamW

    model = BertForSequenceClassification(cfg, device=dev, dtype=dtype,
                                          seed=SEED)
    if state is not None:
        load_paddle_tpu_state_dict(model, state)
    model.train()
    return fused_train_step(
        model, AdamW(learning_rate=2e-5, parameters=model.parameters()),
        loss_fn=lambda o: o[0], shape_buckets=shape_buckets)


def varlen_stream(step, ds, bs, boundaries, arm, epochs):
    """``scripts/bench_bucketing.py:run_stream`` on the port: the whole
    stream through ``step`` under one arm. naive: shuffled batches padded
    to their own longest sample (one capture a distinct shape); pipeline:
    ``BucketedBatchSampler`` + ``PadToBucket`` (captures O(buckets));
    jit: naive's batches, padded up to a bucket inside the step. Tokens
    (real and padded) are counted over the batches that dispatch; wall
    time includes the captures and ends at the one host sync that fetches
    every step's loss. Returns the reference's record plus ``losses``
    (per step) and ``batches`` (each step's ids)."""
    import torch

    from paddle_tpu_torch import io, jit

    jit.reset_cache_stats()
    spec = jit.BucketSpec.normalize(boundaries)
    if arm == "pipeline":
        sampler = io.BucketedBatchSampler(
            ds, batch_size=bs, boundaries=boundaries, shuffle=True, seed=0,
            drop_last=True)
        collate = io.PadToBucket(boundaries, with_mask=False)
        hist = sampler.bucket_histogram()
    else:
        sampler = io.BatchSampler(ds, batch_size=bs, shuffle=True,
                                  drop_last=True)
        collate = io.PadToBucket([], with_mask=False)  # exact-length pad
        hist = None
    loader = io.DataLoader(ds, batch_sampler=sampler, collate_fn=collate)
    losses, batches, real_tokens, padded_tokens = [], [], 0, 0
    sync(step._device)
    t0 = time.perf_counter()
    for epoch in range(epochs):
        if hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)
        for ids, labels in loader:
            real_tokens += int((ids != 0).sum())
            w = ids.shape[1]
            if arm == "jit":
                w = spec.bucketed_dim(1, w)
            padded_tokens += ids.shape[0] * w
            batches.append(ids)
            losses.append(step(ids.to(torch.int32), labels=labels))
    losses = torch.stack(losses).tolist()
    wall = time.perf_counter() - t0
    stats = jit.cache_stats(step._stats_name) or {}
    rec = {
        "arm": arm,
        "tokens_per_sec": round(real_tokens / wall, 1),
        "wall_s": round(wall, 2),
        "real_tokens": real_tokens,
        "pad_waste": round(1.0 - real_tokens / max(padded_tokens, 1), 4),
        "compiles": stats.get("compiles", 0),
        "hits": stats.get("hits", 0),
        "bucket_pads": stats.get("bucket_pads", 0),
        "losses": losses, "batches": batches,
    }
    if hist is not None:
        rec["bucket_histogram"] = {str(k): v for k, v in hist.items()}
    return rec


def varlen_arm(arm, sizing, ds, dev, dtype, epochs=VARLEN_EPOCHS,
               state=None):
    """One arm from a fresh model: ``varlen_stream``'s record plus the
    kernel wrappers' launches over it. numpy's global generator (which the
    naive and jit arms shuffle with) is seeded first."""
    import numpy as np

    cfg, bs, _, boundaries, _ = sizing
    step = varlen_step(cfg, dev, dtype,
                       boundaries if arm == "jit" else None, state)
    np.random.seed(SEED)
    reset_all_launch_counts()
    rec = varlen_stream(step, ds, bs, boundaries, arm, epochs)
    rec["launches"] = all_launch_counts()
    return rec


def varlen_tiny_card_vs_cpu():
    """Phase 15b: fp32 bert_tiny (``tiny=True`` sizing, ``PT_FUSED_NORM``)
    from the same numpy weights through the three arms on the CPU and on
    the card: the same batches, capture counts and losses (rtol)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import BertForSequenceClassification

    sizing = varlen_sizing(tiny=True)
    cfg, _, lengths, _, per_len = sizing
    state = bert_tiny_state(BertForSequenceClassification(cfg, device="cpu"),
                            np.random.RandomState(SEED + 15))
    ds = varlen_dataset(cfg, lengths, per_len)
    worst = 0.0
    with fused_switches(("PT_FUSED_NORM",)):
        for arm in VARLEN_ARMS:
            cpu, card = (varlen_arm(arm, sizing, ds, dev, torch.float32,
                                    state=state) for dev in ("cpu", "cuda"))
            dl = max(abs(a / b - 1) for a, b in zip(card["losses"],
                                                     cpu["losses"]))
            same = (len(card["batches"]) == len(cpu["batches"]) and all(
                torch.equal(a, b) for a, b in zip(card["batches"],
                                                  cpu["batches"])))
            say(f"bert_varlen card vs cpu bert_tiny fp32 {arm}: "
                f"{len(card['losses'])} steps, batches identical {same}, "
                f"captures {card['compiles']} vs compiles "
                f"{cpu['compiles']}, losses max rel diff {dl:.3e} (tol "
                f"{TRAIN_LOSS_RTOL:g})")
            check(same and card["compiles"] == cpu["compiles"]
                  and dl <= TRAIN_LOSS_RTOL,
                  f"bert_tiny {arm}: card and CPU agree")
            worst = max(worst, dl)
    return worst


def phase_bert_varlen():
    """Phase 15: ``bench.py bert_varlen``'s bucketed stream on the port.
    (a) #3, #4 and #5 at BERT-base's heads (bf16, non-causal, B 32, H 12,
    D 64) against their plain versions at S 72 and 232; (b) the three arms
    of ``run_stream``, each from a fresh BERT-base (bf16, both dropouts 0,
    ``PT_FUSED_NORM``, AdamW(2e-5)), 2 epochs of 20 batches of 32 over 10
    lengths: tokens/s on real tokens and wall (captures included),
    captures and hits, pad waste, the bucket histogram, the last loss and
    the launches; naive captures equal its distinct batch shapes, pipeline
    and jit at most one a bucket, every loss finite, each flash kernel
    launched 12 x steps and #8 24 x steps; (c) fp32 bert_tiny card = CPU
    (``varlen_tiny_card_vs_cpu``). Returns the flash kernels' worst errors
    and each arm's launches."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    worst = dict.fromkeys(FLASH, 0.0)
    for case in VARLEN_FLASH_CASES:
        for name, e in zip(FLASH, flash_case(gen, case)):
            worst[name] = max(worst[name], e)
    sizing = varlen_sizing(tiny=False)
    cfg, bs, lengths, boundaries, per_len = sizing
    ds = varlen_dataset(cfg, lengths, per_len)
    L = cfg.num_hidden_layers
    launches = {}
    with fused_switches(("PT_FUSED_NORM",)):
        for arm in VARLEN_ARMS:
            rec = varlen_arm(arm, sizing, ds, "cuda", torch.bfloat16)
            free_cuda()
            n = len(rec["losses"])
            shapes = len({tuple(b.shape) for b in rec["batches"]})
            counts = rec["launches"]
            want = launches_want(fused_add_layer_norm_cuda=2 * L * n,
                                 **{f"{k}_cuda": L * n for k in FLASH})
            say(f"bert_varlen BERT-base {arm}: {n} steps, "
                f"{rec['real_tokens']} real tokens in {rec['wall_s']} s "
                f"(captures included) = {rec['tokens_per_sec']} tokens/s; "
                f"captures {rec['compiles']}, hits {rec['hits']}, distinct "
                f"loader batch shapes {shapes}; pad waste "
                f"{rec['pad_waste']}; "
                f"bucket histogram {rec.get('bucket_histogram')}; last loss "
                f"{rec['losses'][-1]:.4f}; launches #3/#4/#5/#8 "
                f"{[counts[k + '_cuda'] for k in FLASH]}/"
                f"{counts['fused_add_layer_norm_cuda']} ({L} x {n}, "
                f"{2 * L} x {n})")
            check(all(math.isfinite(x) for x in rec["losses"]),
                  f"bert_varlen {arm}: finite losses")
            check(counts == want, f"bert_varlen {arm} launches {counts} "
                  f"== {want}")
            check(rec["compiles"] == shapes if arm == "naive"
                  else rec["compiles"] <= len(boundaries),
                  f"bert_varlen {arm}: {rec['compiles']} captures for "
                  f"{shapes} batch shapes")
            launches[arm] = counts
    timed(varlen_tiny_card_vs_cpu)
    return worst, launches


# -- the launcher on the card (phase 16) --------------------------------------

# each rank trains phase 9's run: SUP_CHILD_STEPS steps in windows of
# SUP_LOG, a committed checkpoint every second window
LAUNCH_STEPS = SUP_CHILD_STEPS
LAUNCH_SAVE_EVERY = 2 * SUP_LOG
LAUNCH_FAULT_RANK = 1          # the rank that is killed or hangs
LAUNCH_PREEMPT_AT = SUP_LOG    # every rank SIGTERMs itself at this step
# the hang job's FLAGS_worker_hang_timeout_s: this multiple of the largest
# heartbeat gap of the kill job's first incarnation
LAUNCH_HANG_MARGIN = 2.0
# the hang job's FLAGS_worker_term_grace_s: the stalled rank sleeps
# through SIGTERM, so only the SIGKILL after the grace ends it
LAUNCH_HANG_GRACE_S = 2.0
LAUNCH_JOB_S = 600.0
LAUNCH_SCENARIOS = ("kill", "preempt", "hang")


def launch_stack(dev):
    """Phase 16's worker stack: phase 9's on the card (llama_125m bf16,
    16 x 1024 batches), fp32 llama_tiny on 2 x 64 batches on the CPU."""
    if dev == "cuda":
        return sup_setup()
    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_tiny()
    model = LlamaForCausalLM(cfg, device="cpu", seed=SEED)
    step = fused_train_step(model, AdamW(learning_rate=1e-4,
                                         parameters=model.parameters()))
    return model, step, sup_loader(cfg.vocab_size, 2 * SUP_EPOCH, 64, 2,
                                   SEED + 9)


def launch_child(root, total):
    """``chip_smoke.py --launch-child ROOT TOTAL``: phase 16's worker, one
    process a rank under ``python -m paddle_tpu_torch.distributed.launch``
    (``PADDLE_TRAINER_ID``). ``launch_stack`` on ``LAUNCH_DRILL_DEVICE``
    (default ``cuda``) with a checkpoint directory of its own
    (``ROOT/rank<r>/ckpt``), resumed if one is committed, trained to TOTAL
    steps through ``drive`` (windows of 4, a committed checkpoint every
    second window, the default heartbeats and SIGTERM handling). Each
    window's losses go to ``ROOT/rank<r>/loss.log`` keyed by global step,
    its events (``resumed``, ``fault``, ``done`` with this incarnation's
    flash launches) to ``ROOT/rank<r>/events.jsonl``.
    ``LAUNCH_DRILL_SCENARIO`` arms one fault a job (a marker file keeps a
    later incarnation from arming it again): ``kill``/``hang``: rank
    ``LAUNCH_FAULT_RANK`` fires ``proc.kill``/``train.stall`` at the
    batch fetch after its first committed window; ``preempt``: every rank
    raises SIGTERM at step ``LAUNCH_PREEMPT_AT``."""
    import contextlib
    import signal

    from paddle_tpu_torch import CheckpointManager
    from paddle_tpu_torch.distributed.launch import heartbeat as hb
    from paddle_tpu_torch.utils import fault_injection

    # beats between the bootstrap's and drive's first, as the reference's
    # drill worker beats after its imports: the watchdog's timeout then
    # need not cover the whole start-up in one gap
    hb.write(step="imported")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    scenario = os.environ.get("LAUNCH_DRILL_SCENARIO", "none")
    rdir = os.path.join(root, f"rank{rank}")
    os.makedirs(rdir, exist_ok=True)
    marker = os.path.join(rdir, f"fired.{scenario}")
    with open(os.path.join(rdir, "events.jsonl"), "a") as events, \
            open(os.path.join(rdir, "loss.log"), "a") as log:

        def note(event, **kw):
            events.write(json.dumps({"t": time.time(), "event": event,
                                     **kw}) + "\n")
            events.flush()

        net, step, loader = launch_stack(
            os.environ.get("LAUNCH_DRILL_DEVICE", "cuda"))
        hb.write(step="built")
        mgr = CheckpointManager(os.path.join(rdir, "ckpt"), keep_last_n=2)
        base = mgr.auto_resume(model=net, optimizer=step,
                               sampler=loader) or 0
        note("resumed", step=base)
        fire = (scenario in ("kill", "hang") and rank == LAUNCH_FAULT_RANK
                and base < LAUNCH_SAVE_EVERY and not os.path.exists(marker))

        def on_window(win):
            end = base + win["step"]
            for i, loss in enumerate(win["losses"]):
                log.write(f"{end - len(win['losses']) + i + 1} "
                          f"{float(loss)!r}\n")
            log.flush()
            if end % LAUNCH_SAVE_EVERY == 0 and end < total:
                mgr.save(end, model=net, optimizer=step, sampler=loader)
                if fire and end == LAUNCH_SAVE_EVERY:
                    note("fault")  # fires at the next batch fetch
            if scenario == "preempt" and end >= LAUNCH_PREEMPT_AT \
                    and not os.path.exists(marker):
                open(marker, "w").close()
                signal.raise_signal(signal.SIGTERM)

        reset_all_launch_counts()
        with contextlib.ExitStack() as stack:
            if fire:
                open(marker, "w").close()
                stack.enter_context(fault_injection.inject(
                    "proc.kill" if scenario == "kill" else "train.stall",
                    every_n=LAUNCH_SAVE_EVERY - base + 1))
            step.drive(loader, steps=total - base, log_every=SUP_LOG,
                       checkpoint=mgr, on_window=on_window)
        counts = all_launch_counts()
        note("done", base=base, flash={n: counts[n + "_cuda"]
                                       for n in FLASH})
    return 0


class BeatLog:
    """Every heartbeat the launched workers write, read from the
    heartbeat directory by a thread every 20 ms: ``beats[rank]`` lists
    ``(time, step)`` as each new beat appears."""

    def __init__(self, hb_dir):
        self.hb_dir, self.beats = hb_dir, {}
        self._stop = None

    def _run(self):
        from paddle_tpu_torch.distributed.launch import heartbeat as hb

        while not self._stop.wait(0.02):
            for rank, beat in hb.read_all(self.hb_dir).items():
                seen = self.beats.setdefault(rank, [])
                if not seen or seen[-1][0] != beat["time"]:
                    seen.append((beat["time"], beat.get("step")))

    def __enter__(self):
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def launcher(args, script_args, env, timeout):
    """``python -m paddle_tpu_torch.distributed.launch ARGS SCRIPT_ARGS``
    in a session of its own (the workers too), killed whole if it outlives
    ``timeout``. Returns (exit code, stderr, wall s)."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", *args,
         *script_args], env=env, cwd=os.path.dirname(os.path.abspath(
             __file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        raise RuntimeError(f"check failed: the launcher outlived {timeout} "
                           f"s: {err[-3000:]}")
    return proc.returncode, err, time.perf_counter() - t0


def launch_job(root, scenario, dev, **flags):
    """One phase 16 job: two ``launch_child`` ranks under the launcher
    (``--nproc_per_node 2 --max_restart 2 --log_dir ROOT/logs``, on the
    card ``--devices 0``: both ranks share it), independent replicas
    (``PADDLE_SKIP_DIST_INIT=1``, no process group), ``flags`` as
    ``FLAGS_*`` in the launcher's environment. Returns {rc, stderr, wall,
    t0 (epoch s), beats}."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, PADDLE_SKIP_DIST_INIT="1",
               FLAGS_restart_backoff_s="0.1", LAUNCH_DRILL_SCENARIO=scenario,
               LAUNCH_DRILL_DEVICE=dev)
    env.update({f"FLAGS_{k}": str(v) for k, v in flags.items()})
    if dev == "cpu":
        # one thread a rank: with several, the two ranks' fp32 losses were
        # seen to differ in their last bits in 5 of 16 jobs on one host
        env["OMP_NUM_THREADS"] = "1"
    logs = os.path.join(root, "logs")
    args = ["--nproc_per_node", "2", "--max_restart", "2", "--log_dir", logs]
    if dev == "cuda":
        args += ["--devices", "0"]
    os.makedirs(root, exist_ok=True)
    t0 = time.time()
    with BeatLog(os.path.join(logs, "heartbeats")) as beats:
        rc, err, wall = launcher(
            args, [os.path.join(here, "chip_smoke.py"), "--launch-child",
                   root, str(LAUNCH_STEPS)], env, LAUNCH_JOB_S)
    return {"rc": rc, "stderr": err, "wall": wall, "t0": t0,
            "beats": beats.beats}


def launch_losses(rdir):
    """``{global step: loss repr}`` of one rank over every incarnation;
    fails if a re-trained step's loss differs."""
    seen = {}
    with open(os.path.join(rdir, "loss.log")) as f:
        for line in f:
            step, val = line.split()
            check(seen.setdefault(int(step), val) == val,
                  f"{rdir}: step {step} re-trained with another loss "
                  f"({seen[int(step)]} then {val})")
    return seen


def launch_events(rdir):
    with open(os.path.join(rdir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def launch_liveness(logs):
    """The launcher's ``liveness.log``: ``[(epoch s, live ranks)]``."""
    with open(os.path.join(logs, "liveness.log")) as f:
        return [(float(t), int(n)) for t, n in
                (line.split() for line in f)]


def launch_baseline(root, dev):
    """An uninterrupted job (no fault): rank 0's losses, equal to rank
    1's (the CPU drill's reference; on the card phase 9c's run is)."""
    job = launch_job(root, "none", dev)
    check(job["rc"] == 0, f"the baseline job exited {job['rc']}: "
          f"{job['stderr'][-3000:]}")
    losses = [launch_losses(os.path.join(root, f"rank{r}")) for r in (0, 1)]
    check(losses[0] == losses[1]
          and sorted(losses[0]) == list(range(1, LAUNCH_STEPS + 1)),
          "the baseline's ranks logged the same contiguous run")
    return [float(losses[0][s]) for s in sorted(losses[0])]


def launch_report(name, root, job, whole, dev, layers):
    """Checks and one line for a finished scenario job: exit 0; both ranks'
    losses keyed by step bit for bit ``whole``; the restarts charged (kill
    and hang 1, preempt 0) and the preemptions; ``liveness.log`` dipping
    and recovering; each rank's flash launches in its last incarnation =
    layers x the steps it trained (0 off the card). Returns ({rank: flash
    launches}, the epoch s at which the launcher reaped the first
    incarnation)."""
    check(job["rc"] == 0, f"launch {name}: the job exited {job['rc']}: "
          f"{job['stderr'][-3000:]}")
    restarts = job["stderr"].count("[launch] worker failed")
    preempts = job["stderr"].count("[launch] clean preemption")
    live = launch_liveness(os.path.join(root, "logs"))
    values = [n for _, n in live]
    dip = next((i for i, n in enumerate(values) if n < 2), None)
    rec = next((i for i in range(dip or 0, len(values)) if values[i] == 2),
               None) if dip is not None else None
    check(rec is not None, f"launch {name}: liveness {values} dips and "
          "recovers")
    reaped, relaunched = live[rec - 1][0], live[rec][0]
    want = {i + 1: repr(float(x)) for i, x in enumerate(whole)}
    ranks, resumed = {}, []
    for r in (0, 1):
        rdir = os.path.join(root, f"rank{r}")
        losses = launch_losses(rdir)
        check(losses == want, f"launch {name} rank {r}: losses bit for bit "
              f"the uninterrupted run's ({len(losses)} of {len(want)} "
              "steps logged)")
        ev = launch_events(rdir)
        last = max(i for i, e in enumerate(ev) if e["event"] == "resumed")
        resumed.append(ev[last])
        done = ev[-1]
        check(done["event"] == "done", f"launch {name} rank {r}: finished")
        n = layers * (LAUNCH_STEPS - done["base"]) if dev == "cuda" else 0
        check(all(v == n for v in done["flash"].values()),
              f"launch {name} rank {r}: flash launches {done['flash']} == "
              f"{n} in its last incarnation")
        ranks[f"rank{r}"] = done["flash"]
    want_restarts = 0 if name == "preempt" else 1
    check(restarts == want_restarts and preempts == int(name == "preempt"),
          f"launch {name}: {restarts} restarts charged (want "
          f"{want_restarts}), {preempts} clean preemptions")
    detect = None
    if name == "kill":
        fault = next(e for e in launch_events(os.path.join(
            root, f"rank{LAUNCH_FAULT_RANK}")) if e["event"] == "fault")
        detect = reaped - fault["t"]
    elif name == "hang":
        last_beat = max(t for t, _ in job["beats"][str(LAUNCH_FAULT_RANK)]
                        if t < reaped)
        detect = reaped - last_beat
    resume_s = max(e["t"] for e in resumed) - relaunched
    say(f"launch {name}: exit {job['rc']} in {job['wall']:.1f} s; restarts "
        f"charged {restarts}, preemptions {preempts}; detection "
        + (f"{detect * 1e3:.0f} ms ("
           + ("death" if name == "kill" else "last heartbeat")
           + " to the launcher's kill)" if detect is not None else
           "n/a (clean exits)")
        + f"; relaunch to resume {resume_s:.1f} s (resumed at steps "
        f"{[e['step'] for e in resumed]}); liveness {values}; losses of "
        f"both ranks = the uninterrupted run's bit for bit "
        f"({len(want)} steps); flash launches in the last incarnation "
        f"{ranks}")
    return ranks, reaped


def launch_max_gap(job, until):
    """The largest gap between consecutive heartbeats of any rank before
    ``until`` (epoch s), the job's start counting as each rank's first:
    (gap s, rank, the steps of the beats that bound it: "start", None
    for the bootstrap's, "imported" and "built" for ``launch_child``'s
    start-up beats)."""
    best = (0.0, None, None)
    for rank, beats in job["beats"].items():
        prev = (job["t0"], "start")
        for t, step in beats:
            if t >= until:
                break
            best = max(best, (t - prev[0], rank, (prev[1], step)),
                       key=lambda g: g[0])
            prev = (t, step)
    return best


def launch_crash_loop(root):
    """A job whose two workers always exit 3, under ``--max_restart 1``:
    the launcher ends with exit 3 and its crash-loop message, and neither
    the launcher's bootstrap nor the worker imported torch."""
    os.makedirs(root, exist_ok=True)
    script = os.path.join(root, "exit3.py")
    with open(script, "w") as f:
        f.write("import os, sys\n"
                f"open(os.path.join({root!r}, 'torch.' + "
                "os.environ['PADDLE_TRAINER_ID']), 'w').write(\n"
                "    str('torch' in sys.modules))\n"
                "sys.exit(3)\n")
    env = dict(os.environ, FLAGS_restart_backoff_s="0.1",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    rc, err, wall = launcher(["--nproc_per_node", "2", "--max_restart", "1"],
                             [script], env, 120)
    with open(os.path.join(root, "torch.0")) as f:
        torch_seen = f.read()
    line = next((ln for ln in err.splitlines() if "crash loop" in ln), "")
    say(f"launch crash loop (workers exit 3, --max_restart 1, no card, no "
        f"torch: {torch_seen == 'False'}): exit {rc} in {wall:.1f} s; "
        f"{line.strip()}")
    check(rc == 3 and line.startswith("[launch] crash loop")
          and torch_seen == "False", "the crash loop ends the launcher with "
          "exit 3 and its message")


def launch_drill(root, whole, dev):
    """Phase 16's three scenario jobs in ``root`` (``launch_job`` and
    ``launch_report`` each): kill, then preempt, then hang, whose
    ``FLAGS_worker_hang_timeout_s`` is ``LAUNCH_HANG_MARGIN`` x the
    largest heartbeat gap of the kill job's first incarnation. Returns
    {scenario: {rank: flash launches of its last incarnation}}."""
    import shutil

    from paddle_tpu_torch.models import llama_tiny

    layers = (sup_config() if dev == "cuda" else
              llama_tiny()).num_hidden_layers
    out, flags = {}, {}
    for name in LAUNCH_SCENARIOS:
        sroot = os.path.join(root, name)
        if name == "hang":
            flags = dict(worker_hang_timeout_s=hang_s,
                         worker_term_grace_s=LAUNCH_HANG_GRACE_S)
        job = launch_job(sroot, name, dev, **flags)
        out[name], reaped = launch_report(name, sroot, job, whole, dev,
                                          layers)
        for r in (0, 1):  # the next job's disk
            shutil.rmtree(os.path.join(sroot, f"rank{r}", "ckpt"))
        if name == "kill":
            gap, rank, steps = launch_max_gap(job, reaped)
            hang_s = round(LAUNCH_HANG_MARGIN * gap, 1)
            say(f"launch hang timeout: the kill job's first incarnation's "
                f"largest heartbeat gap (boot and first capture included) "
                f"{gap:.2f} s, rank {rank} between its beats at steps "
                f"{steps[0]} and {steps[1]}, x {LAUNCH_HANG_MARGIN:g} = "
                f"FLAGS_worker_hang_timeout_s {hang_s:g}")
    return out


def phase_launch(whole):
    """Phase 16: the launcher on the card (the port of
    ``scripts/chaos_train.py``'s base drill). Three jobs of ``python -m
    paddle_tpu_torch.distributed.launch --nproc_per_node 2 --devices 0
    --max_restart 2`` over ``--launch-child``: both ranks train phase 9's
    llama_125m run on the one card as independent replicas, each with its
    own checkpoints. kill: rank 1 SIGKILLs itself after its first
    committed window; preempt: every rank takes SIGTERM at a window
    boundary and exits 123 with a checkpoint; hang: rank 1 stalls with
    the stall guard off until the watchdog condemns it. Each ends in exit
    0 with both ranks' losses bit for bit 9c's (``whole``), kill and hang
    charging one restart and preempt none; then a crash loop with no card
    and no torch. Returns each scenario's flash launches a rank."""
    import shutil
    import tempfile

    free_cuda()
    root = tempfile.mkdtemp(prefix="launch-")
    try:
        out = launch_drill(root, whole, "cuda")
        launch_crash_loop(os.path.join(root, "crash-loop"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# phase 17: bench.py bert's BERT-base (bench.py:401-447: 128 x 128, both
# dropouts 0, fp32 weights) fine-tuned through the high-level API under AMP
# O1 with PT_FUSED_NORM: HAPI_BATCHES distinct batches for HAPI_EPOCHS
# epochs, then one eval of HAPI_EVAL_BATCHES batches; ms/step after
# HAPI_WARMUP steps. Each row's first token names its label
# (HAPI_LABEL_TOKEN + label), so the loss falls as the model learns to read
# it, where random labels leave it at ln 2
HAPI_BATCH, HAPI_SEQ, HAPI_BATCHES, HAPI_EPOCHS = 128, 128, 20, 1
HAPI_LABEL_TOKEN = 1000
HAPI_EVAL_BATCHES = 4
HAPI_WARMUP = 3
HAPI_O2_STEPS = 3
# (c)'s fp32 bert_tiny: batch, sequence, train and eval batches, epochs
HAPI_TINY = (4, 64, 3, 2, 2)


def hapi_data(cfg, batches, batch, seq, seed, label_token=None):
    """``io.TensorDataset`` of ``batches`` x ``batch`` seeded rows: int64
    ids [seq] and a label; with ``label_token`` each row's first id is
    ``label_token + label``."""
    import numpy as np

    from paddle_tpu_torch import io

    rng = np.random.RandomState(seed)
    n = batches * batch
    ids = rng.randint(0, cfg.vocab_size, (n, seq)).astype(np.int64)
    labels = rng.randint(0, cfg.num_labels, n).astype(np.int64)
    if label_token is not None:
        ids[:, 0] = label_token + labels
    return io.TensorDataset([ids, labels])


def hapi_recorder(dev):
    """A ``hapi`` callback recording each train step's loss, accuracy and
    host time at its end (after a synchronize on the card: O1's
    GradScaler and the Accuracy metric read the host every step anyway),
    and each eval's logs."""
    import torch

    from paddle_tpu_torch.hapi.callbacks import Callback

    class Recorder(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.accs, self.times, self.evals = [], [], [], []

        def on_train_batch_end(self, step, logs=None):
            if dev == "cuda":
                torch.cuda.synchronize()
            self.times.append(time.perf_counter())
            self.losses.append(float(logs["loss"]))
            self.accs.append(float(logs.get("acc", math.nan)))

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs))

    return Recorder()


@contextlib.contextmanager
def flash_dtypes():
    """q's dtype at every launch of the three flash kernels (without
    rope) inside the block, by name (``FLASH``): recorded where the CUDA
    wrappers launch (``flash_attention._launch``, after their check that
    k and v share q's dtype), so launches from inside a compiled graph
    count too."""
    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    seen = {n: [] for n in FLASH}
    orig = FA._launch

    def recording(name, q, ptrs, tables, *args):
        if tables is None:
            seen[f"flash_attention_{name}"].append(q.dtype)
        return orig(name, q, ptrs, tables, *args)

    FA._launch = recording
    try:
        yield seen
    finally:
        FA._launch = orig


def hapi_model(net, level=None, lr=2e-5, epsilon=1e-8):
    """``Model(net).prepare(AdamW(lr), nn.CrossEntropyLoss(),
    metric.Accuracy(), amp_configs={"level": level})``."""
    from paddle_tpu_torch import Model, metric, nn
    from paddle_tpu_torch.optimizer import AdamW

    return Model(net).prepare(
        AdamW(learning_rate=lr, epsilon=epsilon,
              parameters=net.parameters()),
        nn.CrossEntropyLoss(), metric.Accuracy(),
        amp_configs={"level": level} if level else None)


def phase_hapi_o1(cfg):
    """Phase 17a: BERT-base (fp32 weights) through ``Model.fit`` under O1
    with ``PT_FUSED_NORM``: ms/step (host clock, after HAPI_WARMUP
    steps), tokens/s, peak memory, first and last loss, accuracy,
    eval_loss; every loss finite and the last quarter's mean below the
    first quarter's; #3 = layers x (steps + eval batches), #4 = #5 = layers x
    steps, #8 = 2 x layers x (steps + eval batches), no other kernel; q
    reaches every training call of the flash wrappers as bf16 (the
    tensor-core bodies) and the eval's as fp32 (``eval_batch`` runs
    outside ``auto_cast``, as the reference's); the parameters stay fp32.
    Returns (the launch counts, the model)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import BertForSequenceClassification
    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    L = cfg.num_hidden_layers
    steps = HAPI_BATCHES * HAPI_EPOCHS
    t0 = time.perf_counter()
    net = BertForSequenceClassification(cfg, device="cuda", seed=SEED)
    train = hapi_data(cfg, HAPI_BATCHES, HAPI_BATCH, HAPI_SEQ, SEED + 20,
                      HAPI_LABEL_TOKEN)
    evald = hapi_data(cfg, HAPI_EVAL_BATCHES, HAPI_BATCH, HAPI_SEQ,
                      SEED + 21, HAPI_LABEL_TOKEN)
    model = hapi_model(net, "O1")
    rec = hapi_recorder("cuda")
    torch.cuda.synchronize()
    say(f"hapi setup: BERT-base fp32 weights, batches {HAPI_BATCHES} x "
        f"{HAPI_BATCH} x {HAPI_SEQ}, {HAPI_EPOCHS} epoch(s), eval "
        f"{HAPI_EVAL_BATCHES} batches, in {time.perf_counter() - t0:.2f} s")
    with fused_switches(("PT_FUSED_NORM",)), flash_dtypes() as seen:
        reset_peak_memory()
        reset_all_launch_counts()
        t0 = time.perf_counter()
        model.fit(train, eval_data=evald, batch_size=HAPI_BATCH,
                  epochs=HAPI_EPOCHS, eval_freq=HAPI_EPOCHS, shuffle=False,
                  verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = rec.losses
    check(len(losses) == steps and len(rec.evals) == 1,
          f"hapi O1: {len(losses)} steps, {len(rec.evals)} evals")
    quarter = steps // 4
    first = np.mean(losses[:quarter])
    last = np.mean(losses[-quarter:])
    check(all(np.isfinite(losses)) and last < first,
          f"hapi O1: losses finite and falling ({first:.4f} -> {last:.4f})")
    n_eval = HAPI_EVAL_BATCHES
    want = launches_want(
        flash_attention_fwd_cuda=L * (steps + n_eval),
        flash_attention_bwd_dq_cuda=L * steps,
        flash_attention_bwd_dkv_cuda=L * steps,
        fused_add_layer_norm_cuda=2 * L * (steps + n_eval))
    check(counts == want, f"hapi O1 launches {counts} == {want}")
    bf16, fp32 = torch.bfloat16, torch.float32
    dt = {n: [str(d).split(".")[1] for d in v] for n, v in seen.items()}
    check(seen["flash_attention_fwd"]
          == [bf16] * (L * steps) + [fp32] * (L * n_eval)
          and seen["flash_attention_bwd_dq"] == [bf16] * (L * steps)
          and seen["flash_attention_bwd_dkv"] == [bf16] * (L * steps)
          and FA.flash_route(bf16, cfg.hidden_size
                             // cfg.num_attention_heads) == "tensor_core",
          f"hapi O1: q reached the flash wrappers as "
          f"{ {n: sorted(set(v)) for n, v in dt.items()} }")
    check(all(p.dtype == fp32 for p in net.parameters()),
          "hapi O1: the parameters stay fp32")
    ms = (rec.times[-1] - rec.times[HAPI_WARMUP - 1]) / (
        steps - HAPI_WARMUP) * 1e3
    ev = rec.evals[0]
    say(f"hapi BERT-base O1 Model.fit: {steps} steps + {n_eval} eval "
        f"batches in {wall:.2f} s; {ms:.1f} ms/step (host clock, after "
        f"{HAPI_WARMUP} warm-up steps), "
        f"{HAPI_BATCH * HAPI_SEQ / ms * 1e3:.0f} tokens/s, peak memory "
        f"{peak:.2f} GiB; losses {[round(x, 4) for x in losses]} (first "
        f"{losses[0]:.4f}, last {losses[-1]:.4f}); train acc "
        f"{rec.accs[-1]:.4f}; eval_loss {ev['eval_loss']:.4f}, eval_acc "
        f"{ev['eval_acc']:.4f}; q dtypes at the flash wrappers: train "
        f"bf16 ({L * steps} forward, {L * steps} dq, {L * steps} dkv, "
        f"tensor-core bodies), eval fp32 ({L * n_eval} forward); "
        f"launches {counts}")
    return counts, net


def phase_hapi_o2(cfg):
    """Phase 17b: ``amp.decorate(net, level="O2")`` on a fresh BERT-base:
    every parameter bf16 but the LayerNorms' (fp32); HAPI_O2_STEPS steps
    of ``Model.fit`` under O2 with ``PT_FUSED_NORM``, every loss finite;
    #3-#5 layers x steps, #8 2 x layers x steps. Returns the launch
    counts."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import BertForSequenceClassification
    from paddle_tpu_torch.nn import LayerNorm

    L = cfg.num_hidden_layers
    net = BertForSequenceClassification(cfg, device="cuda", seed=SEED)
    amp.decorate(net, level="O2")
    norms = {id(p) for m in net.modules() if isinstance(m, LayerNorm)
             for p in m.parameters()}
    dtypes = {p.dtype for p in net.parameters() if id(p) not in norms}
    ln = {p.dtype for p in net.parameters() if id(p) in norms}
    check(dtypes == {torch.bfloat16} and ln == {torch.float32},
          f"hapi O2: parameters {dtypes}, LayerNorms {ln}")
    model = hapi_model(net, "O2")
    rec = hapi_recorder("cuda")
    train = hapi_data(cfg, HAPI_O2_STEPS, HAPI_BATCH, HAPI_SEQ, SEED + 20,
                      HAPI_LABEL_TOKEN)
    with fused_switches(("PT_FUSED_NORM",)):
        reset_all_launch_counts()
        model.fit(train, batch_size=HAPI_BATCH, epochs=1, shuffle=False,
                  verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        counts = all_launch_counts()
    steps = HAPI_O2_STEPS
    want = launches_want(
        **{f"{n}_cuda": L * steps for n in FLASH},
        fused_add_layer_norm_cuda=2 * L * steps)
    check(np.isfinite(rec.losses).all() and len(rec.losses) == steps
          and counts == want,
          f"hapi O2: losses {rec.losses}, launches {counts} == {want}")
    say(f"hapi BERT-base O2 (decorate): {len(norms)} LayerNorm parameters "
        f"fp32, the other {sum(1 for _ in net.parameters()) - len(norms)} "
        f"bf16; {steps} steps, losses "
        f"{[round(x, 4) for x in rec.losses]}; "
        f"{(rec.times[-1] - rec.times[0]) / (steps - 1) * 1e3:.1f} ms/step "
        f"after the first; launches {counts}")
    return counts


def hapi_tiny_card_vs_cpu(root):
    """Phase 17c: fp32 bert_tiny (numpy weights from a seed) through
    ``Model.fit`` (AdamW, Accuracy, an eval each epoch, ``shuffle=False``,
    ``PT_FUSED_NORM``) on the card and on the CPU: each step's loss
    within TRAIN_LOSS_RTOL, accuracies and eval accuracies equal; then
    ``Model.save`` on the card and ``Model.load`` into a CPU ``Model``:
    its ``evaluate`` gives the card's eval_loss within TRAIN_LOSS_RTOL and
    the same accuracy."""
    import numpy as np

    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_tiny,
                                         load_paddle_tpu_state_dict)

    batch, seq, n_train, n_eval, epochs = HAPI_TINY
    cfg = bert_tiny(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    state = bert_tiny_state(BertForSequenceClassification(cfg, device="cpu"),
                            np.random.RandomState(SEED + 22))
    train = hapi_data(cfg, n_train, batch, seq, SEED + 23)
    evald = hapi_data(cfg, n_eval, batch, seq, SEED + 24)
    path = os.path.join(root, "bert_tiny")
    runs, models = {}, {}
    with fused_switches(("PT_FUSED_NORM",)):
        for dev in ("cpu", "cuda"):
            net = BertForSequenceClassification(cfg, device=dev)
            load_paddle_tpu_state_dict(net, state)
            models[dev] = hapi_model(net, lr=1e-3, epsilon=1e-6)
            runs[dev] = hapi_recorder(dev)
            models[dev].fit(train, eval_data=evald, batch_size=batch,
                            epochs=epochs, shuffle=False, verbose=0,
                            callbacks=[runs[dev]])
        models["cuda"].save(path)
        loaded = hapi_model(BertForSequenceClassification(cfg, device="cpu"),
                            lr=1e-3, epsilon=1e-6).load(path)
        ev_card = models["cuda"].evaluate(evald, batch_size=batch, verbose=0)
        ev_load = loaded.evaluate(evald, batch_size=batch, verbose=0)
    a, b = runs["cuda"], runs["cpu"]
    dl = max(abs(x / y - 1) for x, y in zip(a.losses, b.losses))
    de = abs(ev_load["eval_loss"] / ev_card["eval_loss"] - 1)
    same_acc = (a.accs == b.accs and [e["eval_acc"] for e in a.evals]
                == [e["eval_acc"] for e in b.evals])
    say(f"hapi card vs cpu bert_tiny fp32 Model.fit, {len(a.losses)} steps "
        f"and {epochs} evals: losses max rel diff {dl:.2e} (tol "
        f"{TRAIN_LOSS_RTOL:g}); accuracies equal {same_acc}; saved on the "
        f"card, loaded on the CPU: eval_loss "
        f"{ev_load['eval_loss']:.6f} vs the card's "
        f"{ev_card['eval_loss']:.6f} (rel diff {de:.2e}), eval_acc "
        f"{ev_load['eval_acc']:.4f} vs {ev_card['eval_acc']:.4f}")
    check(len(a.losses) == n_train * epochs and dl <= TRAIN_LOSS_RTOL
          and same_acc, "hapi: card and CPU Model.fit agree")
    check(de <= TRAIN_LOSS_RTOL and ev_load["eval_acc"] == ev_card["eval_acc"],
          "hapi: the card's checkpoint evaluates the same on the CPU")


def phase_hapi_flops(net, cfg):
    """Phase 17d: ``flops`` of BERT-base on a [1, 128] input (int ids:
    the synthetic float input of ``input_size`` cannot index an
    embedding, in either package) under 17a's ``PT_FUSED_NORM``, whose
    encoder norms run in #8's entry and not in their layers, against the
    Linear + LayerNorm count by hand: rows x in x out per Linear (the
    pooler and classifier on one row), 2 an element per LayerNorm."""
    import torch

    from paddle_tpu_torch import flops

    s, h, i, L = (HAPI_SEQ, cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_hidden_layers)
    want = (L * (4 * s * h * h + 2 * s * h * i) + h * h + h * cfg.num_labels
            + (2 * L + 1) * 2 * s * h)
    with fused_switches(("PT_FUSED_NORM",)):
        got = flops(net, inputs=torch.zeros(1, s, dtype=torch.long,
                                            device="cuda"))
    say(f"hapi flops(BERT-base, [1, {s}]) under PT_FUSED_NORM=1: {got:,} "
        f"MACs; Linear + LayerNorm by hand {want:,}")
    check(got == want, f"hapi flops {got} == {want}")


def phase_hapi():
    """Phase 17: the high-level API on the card (17a-17d). Returns the
    flash kernels' and #8's launches of (a) and (b)."""
    import shutil
    import tempfile

    from paddle_tpu_torch.models import bert_base

    cfg = bert_base(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    o1, net = phase_hapi_o1(cfg)
    phase_hapi_flops(net, cfg)
    del net
    free_cuda()
    o2 = phase_hapi_o2(cfg)
    free_cuda()
    root = tempfile.mkdtemp(prefix="hapi-")
    try:
        timed(hapi_tiny_card_vs_cpu, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"o1": o1, "o2": o2}


# phase 18: jit.to_static, jit.save and the predictor. (a)'s run: steps
# compiled, the warm-up its ms/step skips, the eager steps beside it
JIT_STEPS, JIT_WARMUP, JIT_EAGER_STEPS = 20, 3, 10
# (a)'s depth: BERT-base's width at 4 of its 12 layers. Inductor's first
# compile grows with the graph (72-209 s of first step at 12 layers on
# the card's hosts); (b) still compiles all 12 layers, (c) exports them
JIT_TRAIN_LAYERS = 4
JIT_BATCHES = (1, 8, 32)     # the predictor's batches (c)
JIT_TIMED_RUNS = 10          # runs timed at the largest batch (c)
# compiled against eager in fp32 (b, c): logits within 1e-4 (the same
# kernels; inductor fuses the elementwise work and the embeddings'
# LayerNorm in another summation order, across 12 layers); one training
# step's loss within TRAIN_LOSS_RTOL and each gradient within 1e-3 of its
# largest magnitude plus 1e-6 of the model's largest (the key projections'
# biases have a zero gradient, softmax being invariant to a shift of a
# row of scores: both sides' values there are rounding noise)
JIT_LOGIT_ATOL = 1e-4
JIT_GRAD_FRAC = 1e-3
JIT_GRAD_FLOOR = 1e-6
# the bf16 predictor against the eager model on the same bf16-rounded
# weights (what convert_to_mixed_precision computes: the program in fp32
# on the stored bf16 values)
JIT_MIXED_ATOL = 1e-4


def jit_batches(cfg, n, seed):
    """``n`` seeded BERT batches on the card (HAPI_BATCH x HAPI_SEQ int64
    ids whose first token names the label, as phase 17's)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, cfg.vocab_size, (HAPI_BATCH, HAPI_SEQ))
        labels = rng.randint(0, cfg.num_labels, HAPI_BATCH)
        ids[:, 0] = HAPI_LABEL_TOKEN + labels
        out.append((torch.from_numpy(ids).cuda(),
                    torch.from_numpy(labels).cuda()))
    return out


def jit_train_run(net, batches, steps):
    """``steps`` AdamW(2e-5) steps of ``net`` (compiled or not) under AMP
    O1 on ``batches``: (losses, host times after each step's synchronize,
    the first step's forward and whole walls, each step's launches)."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=2e-5, parameters=net.parameters())
    losses, times, per_step = [], [], []
    before = all_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        ids, labels = batches[i]
        with amp.auto_cast(level="O1"):
            loss, _ = net(ids, labels=labels)
        if i == 0:
            torch.cuda.synchronize()
            first_fwd = time.perf_counter() - t0
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        losses.append(float(loss))
        now = all_launch_counts()
        per_step.append({k: now[k] - before[k] for k in now})
        before = now
    return losses, times, (first_fwd, times[0] - t0), per_step


def jit_ms(times, warmup):
    return (times[-1] - times[warmup - 1]) / (len(times) - warmup) * 1e3


def phase_jit_train(cfg):
    """Phase 18a: BERT-base's width at ``cfg``'s depth (fp32 weights,
    hidden dropout 0.1, attention dropout 0) through ``jit.to_static``
    under AMP O1 with
    ``PT_FUSED_NORM``, AdamW(2e-5), JIT_STEPS seeded 128 x 128 batches:
    the first step's wall (the compile) on its own line, ms/step and
    tokens/s after JIT_WARMUP steps, peak memory, first and last loss;
    the same for JIT_EAGER_STEPS eager steps from the same weights on the
    same batches. Every loss finite and the last quarter's mean below the
    first quarter's; one compile, JIT_STEPS - 1 hits, no eager fallback,
    no graph break; q reaching every flash launch as bf16; in every step
    #3, #4 and #5 launched layers times and #8 2 x layers times, nothing
    else. Returns the compiled run's launch counts."""
    import numpy as np
    import torch
    from torch._dynamo.utils import counters

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import BertForSequenceClassification

    L = cfg.num_hidden_layers
    batches = jit_batches(cfg, JIT_STEPS, SEED + 30)
    tokens = HAPI_BATCH * HAPI_SEQ
    runs = {}
    with fused_switches(("PT_FUSED_NORM",)):
        for arm, steps in (("to_static", JIT_STEPS),
                           ("eager", JIT_EAGER_STEPS)):
            torch.manual_seed(SEED)
            net = BertForSequenceClassification(cfg, device="cuda",
                                                seed=SEED)
            if arm == "to_static":
                net = jit.to_static(net)
                jit.reset_cache_stats()
            breaks = sum(counters["graph_break"].values())
            reset_peak_memory()
            reset_all_launch_counts()
            with flash_dtypes() as seen:
                losses, times, first, per_step = jit_train_run(
                    net, batches, steps)
            runs[arm] = dict(
                losses=losses, first=first, per_step=per_step,
                ms=jit_ms(times, JIT_WARMUP),
                peak=torch.cuda.max_memory_allocated() / 2**30,
                counts=all_launch_counts(), seen=seen,
                breaks=sum(counters["graph_break"].values()) - breaks,
                stats=(jit.cache_stats(net.forward._stats_name)
                       if arm == "to_static" else None))
            del net
            free_cuda()
    for arm, r in runs.items():
        steps = len(r["losses"])
        q = steps // 4
        ms = r["ms"]
        say(f"jit BERT-base O1 {arm} first step: {r['first'][1]:.2f} s, its "
            f"forward call {r['first'][0]:.2f} s"
            + (" (the compile: Dynamo's capture, AOTAutograd's forward and "
               "backward graphs, inductor's code)"
               if arm == "to_static" else ""))
        say(f"jit BERT-base O1 {arm} ({L} layers): {steps} steps; "
            f"{ms:.1f} ms/step "
            f"(host clock, after "
            f"{JIT_WARMUP} warm-up steps), {tokens / ms * 1e3:.0f} "
            f"tokens/s, peak memory {r['peak']:.2f} GiB; losses "
            f"{[round(x, 4) for x in r['losses']]} (first "
            f"{r['losses'][0]:.4f}, last {r['losses'][-1]:.4f}); launches "
            f"{r['counts']}")
        check(np.isfinite(r["losses"]).all() and np.mean(r["losses"][-q:])
              < np.mean(r["losses"][:q]),
              f"jit {arm}: losses finite and falling")
        want = launches_want(**{f"{n}_cuda": L for n in FLASH},
                             fused_add_layer_norm_cuda=2 * L)
        check(all(c == want for c in r["per_step"]),
              f"jit {arm} launches a step {r['per_step']} == {want}")
        dts = {n: sorted({str(d) for d in v}) for n, v in r["seen"].items()}
        check(all(v == [torch.bfloat16] * (L * steps)
                  for v in r["seen"].values()),
              f"jit {arm}: q reached the flash launches as {dts}")
    st, r = runs["to_static"]["stats"], runs["to_static"]
    say(f"jit to_static cache_stats: compiles {st['compiles']}, hits "
        f"{st['hits']}, eager fallbacks {st['eager_fallbacks']}; Dynamo "
        f"graph breaks {r['breaks']}; compiled vs eager "
        f"{r['ms']:.1f} vs {runs['eager']['ms']:.1f} ms/step")
    check((st["compiles"], st["hits"], st["eager_fallbacks"], r["breaks"])
          == (1, JIT_STEPS - 1, 0, 0),
          "jit to_static: one compile, the rest hits, no fallback or break")
    return r["counts"]


def jit_grads(net):
    return {n: p.grad.detach().clone() for n, p in net.named_parameters()}


def phase_jit_vs_eager(net, cfg):
    """Phase 18b: BERT-base (``net``: fp32, both dropouts 0, seed weights,
    the model 18c saves), one batch, ``PT_FUSED_NORM``, compiled and eager
    on the same weights in one fp32 training forward and backward: one
    inductor compile at full depth, whose logits are the eval logits (no
    layer but dropout depends on the mode, and both dropouts are 0).
    Logits within JIT_LOGIT_ATOL, loss within TRAIN_LOSS_RTOL, each
    gradient within JIT_GRAD_FRAC of its largest magnitude plus
    JIT_GRAD_FLOOR of the model's. Leaves ``net`` in eval mode with no
    gradients and returns the batch."""
    import torch

    from paddle_tpu_torch import jit

    ids, labels = jit_batches(cfg, 1, SEED + 31)[0]
    with fused_switches(("PT_FUSED_NORM",)):
        net.train()
        jit.to_static(net)
        t0 = time.perf_counter()
        loss_c, logits_c = net(ids, labels=labels)
        loss_c.backward()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        g_c = jit_grads(net)
        net.zero_grad(set_to_none=True)
        jit.enable_to_static(False)
        try:
            loss_e, logits_e = net(ids, labels=labels)
            loss_e.backward()
        finally:
            jit.enable_to_static(True)
        g_e = jit_grads(net)
        net.zero_grad(set_to_none=True)
        net.eval()
    err = float((logits_c - logits_e).abs().max())
    dl = abs(float(loss_c) / float(loss_e) - 1)
    top = max(float(g.abs().max()) for g in g_e.values())
    worst = max(float((g_c[n] - g_e[n]).abs().max())
                / (float(g_e[n].abs().max()) + JIT_GRAD_FLOOR / JIT_GRAD_FRAC
                   * top) for n in g_e)
    say(f"jit compiled vs eager BERT-base fp32, "
        f"{cfg.num_hidden_layers} layers, batch {tuple(ids.shape)}, one "
        f"training step (compile + run {train_s:.2f} s): logits max abs "
        f"diff {err:.3e} (tol {JIT_LOGIT_ATOL:g}); loss "
        f"{float(loss_c):.6f} vs {float(loss_e):.6f} (rel diff {dl:.2e}, "
        f"tol {TRAIN_LOSS_RTOL:g}), worst gradient diff over its largest "
        f"magnitude (+ {JIT_GRAD_FLOOR / JIT_GRAD_FRAC:g} of the model's "
        f"largest) {worst:.2e} (tol {JIT_GRAD_FRAC:g})")
    check(err <= JIT_LOGIT_ATOL, "jit: compiled logits equal eager's")
    check(dl <= TRAIN_LOSS_RTOL and worst <= JIT_GRAD_FRAC,
          "jit: a compiled fp32 training step equals eager's")
    return ids


def jit_logits(net, ids):
    """``net``'s eager logits (a ``to_static`` forward taken uncompiled)."""
    import torch

    from paddle_tpu_torch import jit

    jit.enable_to_static(False)
    try:
        with torch.no_grad():
            return net(ids).float().cpu().numpy()
    finally:
        jit.enable_to_static(True)


def phase_jit_predictor(net, ids, root):
    """Phase 18c: ``jit.save`` of BERT-base (``net``: seed weights, eval
    mode) with ``InputSpec([None, 128], "int64", "input_ids")`` under
    ``PT_FUSED_NORM``, then ``create_predictor(Config(path))`` on the
    card at JIT_BATCHES: logits within JIT_LOGIT_ATOL of eager's, #3
    layers and #8 2 x layers a run, nothing else; two ``clone()``s on two
    threads equal to the predictor on the same rows; the save, load and
    a batch of 32's ms; then ``convert_to_mixed_precision(..., "bfloat16")``:
    stored weights half the bytes, logits within JIT_MIXED_ATOL of eager
    on the bf16-rounded weights. Returns the launches of the
    JIT_BATCHES runs, summed."""
    import pickle
    import threading

    import numpy as np
    import torch

    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.static import InputSpec

    L = len(net.bert.encoder.layers)
    path = os.path.join(root, "bert")
    x = ids.cpu().numpy()
    with fused_switches(("PT_FUSED_NORM",)):
        t0 = time.perf_counter()
        jit.save(net, path, input_spec=[InputSpec([None, HAPI_SEQ], "int64",
                                                  "input_ids")])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = inference.create_predictor(inference.Config(path))
        load_s = time.perf_counter() - t0
    total = dict.fromkeys(all_launch_counts(), 0)
    errs = {}
    for b in JIT_BATCHES:
        reset_all_launch_counts()
        (out,) = pred.run([x[:b]])
        torch.cuda.synchronize()
        counts = all_launch_counts()
        want = launches_want(flash_attention_fwd_cuda=L,
                             fused_add_layer_norm_cuda=2 * L)
        check(counts == want, f"jit predictor batch {b}: launches {counts} "
              f"== {want}")
        for k, v in counts.items():
            total[k] += v
        errs[b] = float(np.abs(out - jit_logits(net, ids[:b])).max())
        check(out.shape == (b, 2) and errs[b] <= JIT_LOGIT_ATOL,
              f"jit predictor batch {b}: logits max abs diff {errs[b]:.3e}")
    big = x[:JIT_BATCHES[-1]]
    pred.run([big])
    t0 = time.perf_counter()
    for _ in range(JIT_TIMED_RUNS):
        pred.run([big])
    ms = (time.perf_counter() - t0) / JIT_TIMED_RUNS * 1e3
    halves = (x[:8], x[8:16])
    want = [pred.run([h])[0] for h in halves]
    got = {}

    def worker(i):
        got[i] = pred.clone().run([halves[i]])[0]

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    clone_diff = max(float(np.abs(got[i] - want[i]).max()) for i in (0, 1))
    check(len(got) == 2 and clone_diff <= JIT_LOGIT_ATOL,
          f"jit predictor clones on two threads agree ({clone_diff:.3e})")
    mixed = os.path.join(root, "bert_bf16")
    t0 = time.perf_counter()
    inference.convert_to_mixed_precision(
        path + ".pdmodel", path + ".pdiparams", mixed + ".pdmodel",
        mixed + ".pdiparams", "bfloat16")
    convert_s = time.perf_counter() - t0
    sizes = [os.path.getsize(p + ".pdmodel") for p in (path, mixed)]
    weights = []
    for p in (path, mixed):
        with open(p + ".pdmodel", "rb") as f:
            weights.append(sum(a.nbytes for a in pickle.load(f)["consts"]))
    mpred = inference.create_predictor(inference.Config(mixed))
    (mout,) = mpred.run([x[:8]])
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    rounded = jit_logits(net, ids[:8])
    merr = float(np.abs(mout - rounded).max())
    mfull = float(np.abs(mout - want[0]).max())
    say(f"jit predictor BERT-base: jit.save {save_s:.2f} s, "
        f"create_predictor {load_s:.2f} s, .pdmodel {sizes[0]:,} bytes; "
        f"logits vs eager max abs diff "
        f"{ {b: f'{e:.2e}' for b, e in errs.items()} } (tol "
        f"{JIT_LOGIT_ATOL:g}); {ms:.2f} ms a batch of {len(big)} (host, "
        f"run() with its copies); two clones on two threads within "
        f"{clone_diff:.2e} (bit for bit: {clone_diff == 0.0}); launches "
        f"over batches {JIT_BATCHES}: {total}")
    say(f"jit convert_to_mixed_precision bf16: {convert_s:.2f} s, weights "
        f"{weights[1]:,} bytes ({weights[1] / weights[0]:.3f} of fp32's), "
        f".pdmodel {sizes[1]:,} bytes ({sizes[1] / sizes[0]:.3f}); "
        f"logits vs eager on the bf16-rounded weights max abs diff "
        f"{merr:.2e} (tol {JIT_MIXED_ATOL:g}), vs the fp32 predictor "
        f"{mfull:.2e}")
    check(weights[1] * 2 == weights[0] and merr <= JIT_MIXED_ATOL,
          "jit: the bf16 conversion halves the weights and computes on them")
    return total


def jit_op_args(gen):
    """Small arguments on the card for each registered op (bf16 and fp32
    flash at D 64, rope tables, norms and the MoE FFN in fp32)."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    out = []
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = flash_inputs(gen, 4, 128, 64, dt)
        o, lse = FA.flash_attention_fwd_cuda(q, k, v, 0.125, True)
        c2, s2 = rope_tables(128, 64)
        bwd = (q, k, v, o, lse, do)
        out += [("flash_attention_fwd", (q, k, v, 0.125, True)),
                ("flash_attention_bwd_dq", bwd + (0.125, True)),
                ("flash_attention_bwd_dkv", bwd + (0.125, False)),
                ("flash_attention_rope_fwd", (q, k, v, c2, s2, 0.125, True)),
                ("flash_attention_rope_bwd_dq", bwd + (c2, s2, 0.125, True)),
                ("flash_attention_rope_bwd_dkv",
                 bwd + (c2, s2, 0.125, True))]
    out += [("fused_add_rms_norm", (*rms_inputs(gen, 37, 256,
                                                torch.float32), RMS_EPS)),
            ("fused_add_layer_norm", (*ln_inputs(gen, 37, 256,
                                                 torch.float32), LN_EPS))]
    x, ws = moe_inputs(gen, 2, 20, 128, 384, torch.float32)
    out.append(("moe_ffn", (x, *ws)))
    return out


def phase_jit_opcheck(gen):
    """Phase 18d: ``torch.library.opcheck`` (schema, autograd
    registration, fake tensor, AOT dispatch) of every registered op on the
    card."""
    import torch

    from paddle_tpu_torch.ops.cuda import library

    results = {}
    for name, args in jit_op_args(gen):
        got = torch.library.opcheck(library.OPS[name], args)
        results.setdefault(name, []).append(
            all(v == "SUCCESS" for v in got.values()))
    torch.cuda.synchronize()
    passed = {n: all(v) for n, v in results.items()}
    say(f"jit opcheck on the card: {passed}")
    check(set(results) == set(library.OPS)
          and all(all(v) for v in results.values()), "jit: opcheck")


def phase_jit():
    """Phase 18: ``jit.to_static``, ``jit.save`` and the predictor on the
    card (18a-18d). Returns #3-#5 and #8's launches of (a) and (c)."""
    import shutil
    import tempfile

    import torch

    from paddle_tpu_torch.models import BertForSequenceClassification, bert_base

    train = phase_jit_train(bert_base(num_hidden_layers=JIT_TRAIN_LAYERS,
                                      hidden_dropout_prob=0.1,
                                      attention_probs_dropout_prob=0.0))
    cfg = bert_base(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    net = BertForSequenceClassification(cfg, device="cuda", seed=SEED)
    ids = phase_jit_vs_eager(net, cfg)
    free_cuda()
    root = tempfile.mkdtemp(prefix="jit-")
    try:
        pred = phase_jit_predictor(net, ids, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del net
    free_cuda()
    phase_jit_opcheck(torch.Generator(device="cuda").manual_seed(SEED + 32))
    from torch._inductor.async_compile import shutdown_compile_workers

    shutdown_compile_workers()
    return {"to_static": train, "predictor": pred}


# -- phase 19: the cost ledger and the profiler -----------------------------

def ledger_kernels(rep):
    """{kernel op: [(flops, bytes), ...]} of an audit report's kernel op
    nodes."""
    from paddle_tpu_torch.ops.cuda import library

    out = {}
    for o in rep["ops"]:
        if o["op_name"].startswith(library.NAMESPACE + "."):
            out.setdefault(o["opcode"], []).append((int(o["flops"]),
                                                    int(o["bytes"])))
    return out


def check_ledger(rep, want, rows, label):
    """The report holds ``want`` ({op: nodes}) kernel nodes and no other;
    the nodes of each op in ``rows`` ({op: (ops, bytes)}) cost exactly
    that."""
    got = ledger_kernels(rep)
    check({k: len(v) for k, v in got.items()} == want,
          f"{label}: kernel nodes {({k: len(v) for k, v in got.items()})} "
          f"== {want}")
    for name, row in rows.items():
        check(set(got[name]) == {row}, f"{label}: {name} nodes cost "
              f"{sorted(set(got[name]))}, not {row}")


def table_rows(table, names):
    """{op: (ops, bytes)} of phase 3's kernel table for ``names``."""
    return {n: (table[n]["ops"], table[n]["bytes"]) for n in names}


def audit_unchanged(step, before, label):
    """After a cost trace: no launch counter moved, no gradient or
    ``jit.cache_stats`` entry appeared and the card's RNG state is
    bit for bit what ``before`` (``(cache stats, RNG state)``) held."""
    import torch

    from paddle_tpu_torch import jit

    stats, rng = before
    counts = all_launch_counts()
    check(counts == launches_want(), f"{label}: the trace launched "
          f"nothing ({counts})")
    check(jit.cache_stats(step._stats_name) == stats,
          f"{label}: the trace recorded no compile, hit or pad")
    check(torch.equal(torch.cuda.get_rng_state(), rng),
          f"{label}: the card's RNG state is unchanged")
    check(all(p.grad is None for p in step._params),
          f"{label}: no gradient appeared")


def audit_trace(step, args, kwargs, label, lowered=False):
    """``hlo_cost_report`` (and with ``lowered`` ``lowered_flops``, a
    second trace) of ``step`` on the inputs, checked to change nothing.
    Returns (report, its FLOPs, seconds of the traces)."""
    import torch

    from paddle_tpu_torch import jit

    reset_all_launch_counts()
    before = (jit.cache_stats(step._stats_name), torch.cuda.get_rng_state())
    t0 = time.perf_counter()
    rep = step.hlo_cost_report(*args, **kwargs)
    flops = rep["backend_flops"]
    if lowered:
        flops = step.lowered_flops(*args, **kwargs)
    secs = time.perf_counter() - t0
    audit_unchanged(step, before, label)
    check(flops == rep["backend_flops"] > 0,
          f"{label}: lowered_flops {flops} == the report's backend_flops "
          f"{rep['backend_flops']}")
    return rep, flops, secs


def phase_audit_llama(table):
    """Phase 19a: the ledger of llama_125m's step as phase 5 trains it
    (bf16, AdamW(1e-4), 16 x 1024), then one real replayed step under
    ``profiler.Profiler(targets=[CPU, GPU], scheduler=(1, 2))``. Returns
    the flash kernels' launches in the profiled step."""
    import json as _json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.jit import hlo_audit
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_125m
    from paddle_tpu_torch.nn.functional import flash_attention as sdpa
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_125m()
    batch, seq = 16, 1024
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    step = fused_train_step(model, AdamW(learning_rate=1e-4,
                                         parameters=model.parameters()))
    rng = np.random.RandomState(SEED + 4)
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                (batch, seq))).cuda()
                   for _ in range(2))
    rep, flops, secs = audit_trace(step, (ids, labels), {},
                                   "audit llama_125m", lowered=True)
    check(sdpa.LAST_PATH == "cuda", f"the trace took the card's attention "
          f"route ({sdpa.LAST_PATH})")
    check_ledger(rep, {n: L for n in FLASH}, table_rows(table, FLASH),
                 "audit llama_125m")
    say(hlo_audit.format_table(
        rep, top_n=10, title=f"audit llama_125m bf16 16 x 1024 AdamW step "
        f"(traces {secs:.1f} s): top 10 of {rep['n_ops']} ops by bytes"))
    tokens = batch * seq
    n_params = sum(p.numel() for p in model.parameters())
    hand = 6.0 * n_params + 12.0 * L * cfg.hidden_size * seq
    kernel = sum(f for costs in ledger_kernels(rep).values()
                 for f, _ in costs)
    say(f"audit llama_125m: lowered_flops {flops:.0f} = "
        f"{flops / tokens / 1e6:.1f} MFLOP/token (products "
        f"{(flops - kernel) / tokens / 1e6:.1f}, flash kernels "
        f"{kernel / tokens / 1e6:.1f}) vs the hand formula's "
        f"{hand / 1e6:.1f} (6N + 12 L h s): ratio "
        f"{flops / tokens / hand:.4f}; "
        f"per-op estimate {rep['total_flops'] / tokens / 1e6:.1f} MFLOP and "
        f"{rep['total_bytes'] / tokens / 1e3:.1f} kB a token")
    # one real replayed step under the profiler: the first call is the
    # eager warm-up, the second captures and replays
    step(ids, labels)
    step(ids, labels)
    torch.cuda.synchronize()
    out_dir = tempfile.mkdtemp(prefix="audit-profile-")
    p = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=(1, 2))
    states = []
    with p:
        for i in range(2):
            if i == 1:
                reset_all_launch_counts()
            states.append(p.current_state.name)
            with profiler.RecordEvent(f"audit.train_step{i}"):
                step(ids, labels)
            if i == 1:
                torch.cuda.synchronize()
                counts = all_launch_counts()
            p.step(num_samples=tokens)
    host = p.export(os.path.join(out_dir, "host.json"))
    doc = profiler.load_profiler_result(host)
    spans = {e["name"] for e in doc["traceEvents"]}
    dev_dir = doc["metadata"]["device_trace_dir"]
    with open(os.path.join(dev_dir, "device_trace.json")) as f:
        device = _json.load(f)
    names = [e.get("name", "") for e in device.get("traceEvents", ())
             if e.get("cat") == "kernel"]
    seen = {k: sum(k in name for name in names)
            for k in ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                      "flash_bwd_dkv_tc_kernel")}
    info = p.step_info("tokens/s")
    say(f"audit profile llama_125m (scheduler (1, 2), states {states}): "
        f"{info}; launches {counts}; the profiler's kernel count {seen} "
        f"(not checked); {len(set(names))} kernel names in the device "
        "trace; "
        f"host spans {sorted(s for s in spans if s.startswith('audit.'))}")
    check(states == ["READY", "RECORD_AND_RETURN"],
          f"profiler states {states}")
    check(counts == launches_want(**{f"{n}_cuda": L for n in FLASH}),
          f"a replayed step launches each flash kernel {L} times ({counts})")
    summary = p.summary()
    shutil.rmtree(out_dir)
    shutil.rmtree(dev_dir)
    for k, n in seen.items():
        check(n > 0 and k in summary, f"the device trace and the "
              f"profiler's summary name {k}")
    check("audit.train_step1" in spans and "audit.train_step0" not in spans,
          "the host trace holds the window's RecordEvent span only")
    check("tokens/s" in info and p._benchmark.ips > 0,
          f"step_info reports the window's tokens/s ({info})")
    del model, step
    free_cuda()
    return {f"{n}_cuda": counts[f"{n}_cuda"] for n in FLASH}


def phase_audit_fused(table):
    """Phase 19b: the ledgers of phase 5's Llama-MoE under the three
    fused switches and of BERT-base under ``PT_FUSED_NORM``, their kernel
    nodes costed by the ops' formulas."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         LlamaForCausalLM, bert_base)
    from paddle_tpu_torch.ops.cuda import library
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_moe_config()
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    step = fused_train_step(model, AdamW(learning_rate=1e-4,
                                         parameters=model.parameters()))
    rng = np.random.RandomState(SEED + 6)
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                (16, 1024))).cuda()
                   for _ in range(2))
    with fused_switches():
        rep, flops, secs = audit_trace(step, (ids, labels), {},
                                       "audit Llama-MoE")
    want = {"moe_ffn": L // cfg.moe_every, "fused_add_rms_norm": L,
            **{n: L for n in ROPE}}
    check_ledger(rep, want, table_rows(table, want), "audit Llama-MoE")
    say(f"audit Llama-MoE (PT_FUSED_MOE/NORM/ROPE, 16 x 1024): kernel "
        f"nodes {({k: len(v) for k, v in ledger_kernels(rep).items()})}, "
        f"each costing the kernel table's ops and bytes; backend_flops "
        f"{flops / (16 * 1024) / 1e6:.1f} MFLOP/token; traces "
        f"{secs:.1f} s")
    del model, step
    free_cuda()
    cfg = bert_base(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    model = BertForSequenceClassification(cfg, device="cuda",
                                          dtype=torch.bfloat16, seed=SEED)
    step = fused_train_step(model, AdamW(learning_rate=2e-5,
                                         parameters=model.parameters()),
                            loss_fn=lambda out: out[0])
    rng = np.random.RandomState(SEED + 8)
    data = {"input_ids": torch.from_numpy(
                rng.randint(0, cfg.vocab_size, (128, 128))).cuda(),
            "labels": torch.from_numpy(
                rng.randint(0, cfg.num_labels, 128)).cuda()}
    with fused_switches(("PT_FUSED_NORM",)):
        rep, flops, secs = audit_trace(step, (), data, "audit BERT-base")
    # the flash nodes at BERT-base's heads, non-causal: their formulas at
    # [128 x 12, 128, 64] bf16 (the kernel table's flash rows are llama's)
    bh, s, d = 128 * cfg.num_attention_heads, 128, cfg.hidden_size \
        // cfg.num_attention_heads
    q = torch.empty(bh, s, d, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(bh, s, dtype=torch.float32, device="meta")
    non_causal = {n: library.cost(n, *((q,) * 3 if n == FLASH[0] else
                                       (q, q, q, q, lse, q)),
                                  d ** -0.5, False) for n in FLASH}
    rows = {n: (c["flops"], c["bytes"]) for n, c in non_causal.items()}
    rows.update(table_rows(table, ["fused_add_layer_norm"]))
    check_ledger(rep, {"fused_add_layer_norm": 2 * L,
                       **{n: L for n in FLASH}}, rows, "audit BERT-base")
    say(f"audit BERT-base (PT_FUSED_NORM, 128 x 128): kernel nodes "
        f"{({k: len(v) for k, v in ledger_kernels(rep).items()})}, the "
        f"flash nodes non-causal ({non_causal[FLASH[0]]['flops']} FLOPs a "
        "forward), the LayerNorms the kernel table's; "
        f"backend_flops {flops / (128 * 128) / 1e6:.1f} MFLOP/token; "
        f"traces {secs:.1f} s")
    del model, step, data
    free_cuda()


def phase_audit_deepfm():
    """Phase 19c: the reference's acceptance probe on DeepFM criteo at
    phase 8's width: the dense path's top 10 ops by bytes stream
    vocab-sized tensors, the lazy path's none."""
    import numpy as np

    from paddle_tpu_torch.incubate import fused_train_step
    from paddle_tpu_torch.jit import hlo_audit
    from paddle_tpu_torch.models import deepfm_criteo
    from paddle_tpu_torch.optimizer import Adam

    vocab = 1_000_001
    batch = deepfm_batch(np.random.RandomState(SEED + 30))
    hits = {}
    for lazy in (False, True):
        model = deepfm_criteo(device="cuda", seed=SEED)
        step = fused_train_step(deepfm_with_loss(model), Adam(
            learning_rate=1e-3, parameters=model.parameters(),
            lazy_mode=lazy))
        arm = "lazy" if lazy else "dense"
        rep, _, secs = audit_trace(step, batch, {}, f"audit deepfm {arm}")
        hits[arm] = hlo_audit.vocab_sized_ops(rep, vocab, top_n=10)
        say(hlo_audit.format_table(
            rep, top_n=5, title=f"audit deepfm criteo {arm} (traces "
            f"{secs:.1f} s): top 5 of {rep['n_ops']} ops; vocab-sized in "
            f"the top 10: {[o['opcode'] for o in hits[arm]]}"))
        del model, step
        free_cuda()
    check(hits["dense"], "audit deepfm: the dense path streams vocab-sized "
          "ops in its top 10")
    check(not hits["lazy"], "audit deepfm: the lazy path streams none")


def phase_audit_compile_span():
    """Phase 19d: a ``to_static`` compile's ``jit::compile::<name>`` span
    in a CPU-target profile."""
    import torch

    from paddle_tpu_torch import jit, profiler

    def audit_scaled(x):
        return x * 2 + 1

    fn = jit.to_static(audit_scaled)
    p = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU])
    with p:
        fn(torch.ones(64, device="cuda"))
        fn(torch.ones(64, device="cuda"))
    names = [e[0] for e in p._events_snapshot]
    say(f"audit compile span: {names}")
    check(names == ["jit::compile::audit_scaled"],
          f"one compile span in the profile ({names})")


def phase_audit_device():
    """Phase 19e: ``device/`` on the card: the allocator's figures under
    the reference's keys equal ``torch.cuda``'s, and work queued on a
    ``device.Stream`` inside ``stream_guard`` is ordered by a
    ``device.Event``."""
    import torch

    from paddle_tpu_torch import device

    x = torch.randn(4096, 4096, device="cuda")
    stats = device.memory_stats()
    check(stats["bytes_in_use"] == torch.cuda.memory_allocated()
          == device.cuda.memory_allocated("gpu:0")
          and stats["pool_bytes"] == torch.cuda.memory_reserved()
          and stats["bytes_limit"] > stats["peak_bytes_in_use"] > 0,
          f"device.memory_stats under the reference's keys ({stats})")
    side, done = device.Stream(), device.Event()
    side.wait_stream(device.current_stream())
    with device.stream_guard(side):
        check(device.current_stream() == side, "stream_guard makes the "
              "stream current")
        y = x @ x
        done.record()
    check(device.current_stream() != side, "stream_guard restores")
    device.current_stream().wait_event(done)
    want = x @ x
    device.synchronize()
    check(torch.equal(y, want), "work on a device.Stream, ordered by a "
          "device.Event, equals the same work on the default stream")
    say(f"audit device: memory_stats {stats}; a product on a "
        f"device.Stream equal to the default stream's")
    del x, y, want


def phase_audit(table):
    """Phase 19 (19a-19e): the cost ledger of the training steps phase 5
    and phase 8 run, the profiler and ``device/`` on the card. ``table`` is phase 3's
    kernel records. Returns the flash kernels' launches in 19a's profiled
    step."""
    launches = timed(phase_audit_llama, table)
    timed(phase_audit_fused, table)
    timed(phase_audit_deepfm)
    timed(phase_audit_compile_span)
    timed(phase_audit_device)
    return launches


# -- phase 20: serving the Llama-MoE ----------------------------------------

MOE_SERVE_ENGINE = dict(num_blocks=1024, block_size=16, max_batch_size=8,
                        max_model_len=1024, max_prefill_tokens_per_step=512)
MOE_SERVE_NEW = 16
MOE_SERVE_WINDOW = 8
# num_experts / num_experts_per_tok: every expert's capacity is the rows of
# the forward, so no choice is dropped and a row's output does not depend
# on its neighbours (phase 20c)
MOE_NODROP_FACTOR = 4.0
MOE_TINY_ENGINE = dict(num_blocks=64, block_size=16, max_batch_size=3,
                       ingest_async=False)
# fp32 logits of the tiny MoE, #9's fp32 body against PT_FUSED_MOE=0's
# einsum composition on the card: fp32 sums in another order
MOE_LOGIT_ATOL = 1e-4
# (E, C) of #9 in serving: decode (moe_capacity(8, 8, 2, 1.25)) and a
# 512-token prefill chunk (moe_capacity(512, 8, 2, 1.25))
MOE_SERVE_SHAPES = ((8, 3), (8, 160))


def moe_serve_prompts(vocab):
    """Phase 20's eight greedy prompts (96-880 tokens, int32)."""
    import numpy as np

    rng = np.random.RandomState(SEED + 40)
    lens = rng.randint(96, 881, 8)
    lens[0], lens[1] = 880, 96
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def serving_counts():
    """The launches of #1, #2 and #9's wrappers, and of their kernels by
    their device tallies."""
    from paddle_tpu_torch.ops.cuda import moe_ffn as MF
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    counts = dict(K.launch_counts(), **MF.launch_counts())
    tally = K.device_tally()
    dev = {"paged_decode_attention_cuda": tally["paged_decode_split_kernel"],
           "paged_multiquery_attention_cuda": sum(tally[k]
                                                  for k in MQ_KERNELS),
           "moe_ffn_cuda": sum(MF.device_tally().values())}
    return counts, dev


def reset_serving_counts():
    from paddle_tpu_torch.ops.cuda import moe_ffn as MF
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    for mod in (K, MF):
        mod.reset_launch_counts()
        mod.device_tally(reset=True)


def check_serving_counts(label, want):
    """#1, #2 and #9: the wrappers' counts since ``reset_serving_counts``
    equal the kernels' device tallies and ``want``. Returns the counts."""
    counts, dev = serving_counts()
    say(f"{label}: launches {counts}, the kernels' device tally {dev}, "
        f"expected {want}")
    for name, n in want.items():
        check(counts[name] == dev[name] == n,
              f"{label}: {name} launches {counts[name]}, device tally "
              f"{dev[name]}, expected {n}")
    return counts


def moe_serve_run(model, prompts, label, profile=True, engine=None,
                  **engine_kw):
    """One Llama-MoE serving run: a fresh engine, a warm-up request outside
    the counted run (for a window engine the graph's capture), the counted
    run with #1, #2 and #9 held to their device tallies and to layers x
    decode iterations, layers x prefill chunks and MoE layers x (chunks +
    decode iterations), then (``profile``) a profiled repeat for the busy
    and idle share. Returns (outputs, wall s, launch counts, metrics,
    profile)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams

    cfg = model.config
    engine = dict(MOE_SERVE_ENGINE if engine is None else engine,
                  **engine_kw)
    eng = LLMEngine(model, device="cuda", **engine)
    rng = np.random.RandomState(SEED + 41)
    eng.generate([rng.randint(0, cfg.vocab_size, 64)],
                 SamplingParams(max_new_tokens=2))
    replays = 0 if eng._window is None else eng._window.replays
    eng.reset_metrics()
    reset_serving_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, SamplingParams(max_new_tokens=MOE_SERVE_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = eng.metrics()
    L = cfg.num_hidden_layers
    n_moe = L // cfg.moe_every
    chunks, steps = m["prefill_chunks"], m["decode_steps"]
    counts = check_serving_counts(f"serve-moe {label}", {
        "paged_decode_attention_cuda": L * steps,
        "paged_multiquery_attention_cuda": L * chunks,
        "moe_ffn_cuda": n_moe * (chunks + steps)})
    check(chunks > 0 and steps > 0, f"{label}: chunks and decode steps ran")
    if eng._window is not None:
        w = eng._window
        check(w.graph is not None and w.captures == 1
              and w.replays - replays == m["host_syncs"],
              f"{label}: one capture, one replay a window ({w.captures} "
              f"captures, {w.replays - replays} replays, {m['host_syncs']} "
              "windows)")
    prof = None
    if profile:
        prof = device_profile(lambda: eng.generate(
            prompts, SamplingParams(max_new_tokens=MOE_SERVE_NEW)),
            f"serve-moe {label} (same batch again)",
            mark=("paged_decode", "paged_multiquery", "moe_ffn"))
    eng.close()
    for p, o in zip(prompts, outs):
        check(len(o) == len(p) + MOE_SERVE_NEW
              and ((o[len(p):] >= 0) & (o[len(p):] < cfg.vocab_size)).all(),
              f"{label}: every request finished inside the vocab")
    toks = len(prompts) * MOE_SERVE_NEW
    busy = ("busy/idle not measured" if prof is None else
            f"busy {prof['busy_ms']:.1f} ms, idle share {prof['idle']:.3f}")
    say(f"serve-moe {label}: {len(prompts)} requests, prompts "
        f"{sorted(len(p) for p in prompts)}, {MOE_SERVE_NEW} new tokens "
        f"each: wall {wall:.3f} s, {toks / wall:.1f} tokens/s, ttft p50 "
        f"{m['ttft_ms'].get('p50')} ms, itl p50 {m['itl_ms'].get('p50')} "
        f"ms, prefill chunks {chunks}, decode iterations {steps}, host "
        f"syncs {m['host_syncs']}; {busy}")
    return outs, wall, counts, m, prof


def set_capacity_factor(model, factor):
    from paddle_tpu_torch.models import LlamaMoE

    model.config.moe_capacity_factor = factor
    for mod in model.modules():
        if isinstance(mod, LlamaMoE):
            mod.capacity_factor = factor


def phase_serve_moe_full():
    """Phase 20a-c on the Llama-MoE at full width (bf16, seeded weights,
    ``PT_FUSED_MOE=1``). Returns {arm: launch counts}."""
    import torch

    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = llama_moe_config()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"serve-moe setup: Llama-MoE bf16 ({n_params} params), "
        f"capacity factor {cfg.moe_capacity_factor}, engine "
        f"{MOE_SERVE_ENGINE}")
    prompts = moe_serve_prompts(cfg.vocab_size)
    launches = {}
    with fused_switches(("PT_FUSED_MOE",)):
        step = moe_serve_run(model, prompts, "(a) per-step")
        win = moe_serve_run(model, prompts,
                            f"(b) window {MOE_SERVE_WINDOW}",
                            decode_steps_per_sync=MOE_SERVE_WINDOW)
        launches["per_step"], launches["window"] = step[2], win[2]
        toks = len(prompts) * MOE_SERVE_NEW
        say(f"serve-moe (a) vs (b): {same_share(win[0], step[0]):.3f} of "
            f"requests with identical tokens (reported: capacity is shared "
            f"across the batch and the schedules differ); tokens/s "
            f"{toks / step[1]:.1f} vs {toks / win[1]:.1f}; itl p50 "
            f"{step[3]['itl_ms'].get('p50')} vs "
            f"{win[3]['itl_ms'].get('p50')} ms; idle share "
            f"{step[4] and round(step[4]['idle'], 3)} vs "
            f"{win[4] and round(win[4]['idle'], 3)}")
        # (c) nothing drops: windows = per step, alone = batched. Each
        # prompt is prefilled in one chunk, so its chunks do not depend on
        # its neighbours either
        set_capacity_factor(model, MOE_NODROP_FACTOR)
        whole = dict(MOE_SERVE_ENGINE, max_prefill_tokens_per_step=None)
        ns = moe_serve_run(model, prompts, "(c) no-drop per-step",
                           profile=False, engine=whole)
        nw = moe_serve_run(model, prompts,
                           f"(c) no-drop window {MOE_SERVE_WINDOW}",
                           profile=False, engine=whole,
                           decode_steps_per_sync=MOE_SERVE_WINDOW)
        same_w = all((a == b).all() for a, b in zip(ns[0], nw[0]))
        alone = []
        for i in (0, 1):
            out = moe_serve_run(model, [prompts[i]], f"(c) no-drop alone "
                                f"{len(prompts[i])}", profile=False,
                                engine=whole)[0][0]
            alone.append(bool((out == ns[0][i]).all()))
        say(f"serve-moe (c) capacity factor {MOE_NODROP_FACTOR}: windows "
            f"equal per step: {same_w}; prompts of {len(prompts[0])} and "
            f"{len(prompts[1])} tokens served alone equal the batch: "
            f"{alone}")
        check(same_w and all(alone), "no-drop serving: windows = per step, "
              "alone = batched")
    del model
    free_cuda()
    return launches


def moe_tiny_run(dev, state, prompts, **kw):
    """Tokens and per-step logits rows of fp32 llama_tiny with 4 experts
    from ``state`` on ``dev`` (phase 20d)."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         load_paddle_tpu_state_dict,
                                         llama_tiny)

    m = LlamaForCausalLM(llama_tiny(num_experts=4), device=dev)
    load_paddle_tpu_state_dict(m, state)
    logits = []
    with LLMEngine(m, device=dev, **MOE_TINY_ENGINE, **kw) as eng:
        rids = [eng.add_request(p, SamplingParams(max_new_tokens=16))
                for p in prompts]
        while eng.has_work():
            for out in eng.step():
                row = eng.request(out.rid).last_logits
                if out.token >= 0 and row is not None:
                    logits.append(np.array(row))
        toks = [eng.output_tokens(r) for r in rids]
    return toks, logits


def phase_serve_moe_tiny():
    """Phase 20d: fp32 llama_tiny with 4 experts at capacity factor 1.25
    (choices drop), from numpy weights, on one schedule (synchronous
    staging): per step and in windows, the card's tokens equal the CPU's
    with ``PT_FUSED_MOE=1`` (the kernel's fp32 body on the card, its plain
    version on the CPU); on the card, ``PT_FUSED_MOE=1`` against ``=0``:
    tokens equal, logits within ``MOE_LOGIT_ATOL``, #9 launched (and
    tallied) only with the switch."""
    import numpy as np

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.ops.cuda import moe_ffn as MF

    cfg = llama_tiny(num_experts=4)
    rng = np.random.RandomState(SEED + 42)
    ref = LlamaForCausalLM(cfg, device="cpu")
    state = {k: (np.ones(v.shape, np.float32) if "norm" in k else
                 (rng.standard_normal(v.shape) * 0.02).astype(np.float32))
             for k, v in ref.state_dict().items()}
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40, 77, 130)]

    def same(a, b):
        return all((x == y).all() for x, y in zip(a, b))

    runs = {}
    with fused_switches(("PT_FUSED_MOE",)):
        for dev in ("cpu", "cuda"):
            for k in (1, MOE_SERVE_WINDOW):
                reset_serving_counts()
                runs[dev, k] = moe_tiny_run(
                    dev, state, prompts, decode_steps_per_sync=k,
                    capture_logits=k == 1)
                if dev == "cuda":
                    counts, tally = serving_counts()
                    fp32 = MF.device_tally()["moe_ffn_kernel"]
                    check(counts["moe_ffn_cuda"] == tally["moe_ffn_cuda"]
                          == fp32 > 0, f"tiny MoE k={k}: #9 launches "
                          f"{counts['moe_ffn_cuda']} == its fp32 body's "
                          f"tally {fp32} > 0")
    reset_serving_counts()
    unfused = moe_tiny_run("cuda", state, prompts, capture_logits=True)
    counts, _ = serving_counts()
    check(counts["moe_ffn_cuda"] == 0, "PT_FUSED_MOE=0 launches no #9")
    cpu_card = [same(runs["cpu", k][0], runs["cuda", k][0])
                for k in (1, MOE_SERVE_WINDOW)]
    fused, plain = runs["cuda", 1], unfused
    err = max(float(np.abs(a - b).max())
              for a, b in zip(fused[1], plain[1]))
    say(f"serve-moe (d) llama_tiny MoE fp32, capacity factor 1.25, 4 "
        f"prompts + 16: card = CPU per step {cpu_card[0]}, windows of "
        f"{MOE_SERVE_WINDOW} {cpu_card[1]}; on the card PT_FUSED_MOE=1 vs "
        f"=0: tokens identical {same(fused[0], plain[0])}, logits max abs "
        f"diff {err:.3e} over {len(fused[1])} rows (tol {MOE_LOGIT_ATOL:g})")
    check(all(cpu_card), "tiny MoE: the card's tokens equal the CPU's")
    check(same(fused[0], plain[0]) and len(fused[1]) == len(plain[1])
          and err <= MOE_LOGIT_ATOL, "tiny MoE: #9's fp32 body = the "
          "einsum composition")


def phase_serve_moe_kernel(gen):
    """Phase 20e: #9 at its serving shapes (E 8, C 3 and C 160; h 768, I
    2048) against its plain version in both bodies, and its times in bf16:
    kernel, plain, library (three ``torch.bmm``) and the bound. Returns
    {"C<c>": timing record}."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import moe_ffn as MF

    _, _, h, i = MOE_SHAPE
    times = {}
    for e, c in MOE_SERVE_SHAPES:
        for dt in ("bfloat16", "float32"):
            x, ws = moe_inputs(gen, e, c, h, i, getattr(torch, dt))
            got = MF.moe_ffn_cuda(x, *ws)
            err, excess = compare(got, MF.moe_ffn_plain(
                x.float(), *(w.float() for w in ws)), dt)
            torch.cuda.synchronize()
            say(f"kernel moe_ffn E={e} C={c} h={h} I={i} {dt} (serving, "
                f"{MF.moe_ffn_route(x.dtype)} body): max_abs_err {err:.3e} "
                f"(tol {ATOL:g} + {RTOL[dt]:g}*|want|)")
            check(excess <= 0, f"moe_ffn serving C={c} {dt}")
            if dt == "bfloat16":
                gw, uw, dw = ws
                times[f"C{c}"] = dict(
                    ms=time_ms(lambda: MF.moe_ffn_cuda(x, gw, uw, dw)),
                    plain_ms=time_ms(lambda: MF.moe_ffn_plain(x, gw, uw,
                                                              dw)),
                    library_ms=time_ms(lambda: torch.bmm(
                        F.silu(torch.bmm(x, gw)) * torch.bmm(x, uw), dw)),
                    library="3 x torch.bmm",
                    **kernel_cost("moe_ffn", x, gw, uw, dw),
                    shape=f"E={e} C={c} h={h} I={i} bf16",
                    note=f"{e * -(-c // 64)} clusters, L2 reads %d B of "
                         "which weights %d B" % moe_l2_bytes(e, c, h, i))
            del x, ws, got
    report_times(times)
    free_cuda()
    return times


def phase_serve_moe():
    """Phase 20: the Llama-MoE through ``LLMEngine`` (a-d) and #9 at its
    serving shapes (e). Returns ({arm: launch counts of (a) and (b)},
    {shape: #9's timing record})."""
    import torch

    launches = timed(phase_serve_moe_full)
    timed(phase_serve_moe_tiny)
    times = timed(phase_serve_moe_kernel,
                  torch.Generator(device="cuda").manual_seed(SEED + 43))
    return launches, times


def tensor_core_ptxas(built):
    """Registers and spills (``ptxas -v``) of each tensor-core kernel (the
    ``tcr`` namespace of moe_ffn.cu, paged_attention.cu and
    flash_attention.cu), and their dynamic shared memory from the sources'
    size functions."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    from paddle_tpu_torch.ops.cuda import moe_ffn as MF
    from paddle_tpu_torch.ops.cuda import paged_attention as K

    for stem in ("moe_ffn", "paged_attention", "flash_attention"):
        for entry in built[stem][1].split("Compiling entry function '")[1:]:
            name = entry.split("'")[0]
            if "tcr" not in name:
                continue
            regs = entry.split("Used ")[1].split()[0]
            spill = next(ln.strip() for ln in entry.splitlines()
                         if "spill stores" in ln)
            say(f"  ptxas {name}: {regs} registers, {spill}")
    tc = ", ".join(f"D={d} {kv}: {K.multiquery_tc_smem_bytes(d, kv)} B"
                   for d in K.TC_HEAD_DIMS
                   for kv in (torch.bfloat16, torch.int8))
    fa = ", ".join(f"{w}{' rope' if r else ''} D={d}: "
                   f"{FA.tc_smem_bytes(w, d, r)} B"
                   for w in ("fwd", "dq", "dkv") for r in (False, True)
                   for d in FA.HEAD_DIMS)
    say(f"  dynamic shared memory: moe_ffn_bf16_kernel "
        f"{MF._lib().moe_ffn_smem_bytes(768, 1)} B; "
        f"paged_multiquery_tc_kernel {tc}; flash_*_tc_kernel {fa}")


def timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then a line with its wall time (what each
    phase adds to the command's time)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    named = ", ".join([repr(a) for a in args if isinstance(a, str)]
                      + [f"{k}={v!r}" for k, v in kwargs.items()])
    say(f"wall {fn.__name__}({named}): {time.perf_counter() - t0:.1f} s")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build_all()
    say(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for stem, (_, log) in built.items():
        regs = [int(w.split()[0]) for w in log.split("Used ")[1:]]
        spills = sum("0 bytes spill stores" not in line
                     for line in log.splitlines() if "spill stores" in line)
        say(f"  ptxas {stem}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{spills} with spills")
    tensor_core_ptxas(built)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = phase_kernels(gen)
    worst.update(phase_flash_kernels(gen))
    worst.update(phase_flash_kernels(gen, rope=True))
    worst.update(phase_fused_kernels(gen))
    times = phase_times(gen)
    times.update(phase_flash_times(gen))
    times.update(phase_flash_times(gen, rope=True))
    times.update(phase_fused_times(gen))
    # each kernel's launches from the main path that runs it
    counts = timed(phase_serve)
    train, train_ms, train_copy = timed(phase_train)
    counts.update({f"{n}_cuda": train[f"{n}_cuda"] for n in FLASH})
    _, einsum_ms, einsum_copy = timed(phase_train, "PT_ATTN_EINSUM")

    def share(x):
        return "not measured" if x is None else f"{x:.3f}"

    say(f"train llama_125m default vs PT_ATTN_EINSUM=1: {train_ms:.1f} vs "
        f"{einsum_ms:.1f} ms/step; copy kernels {share(train_copy)} vs "
        f"{share(einsum_copy)} of device time")
    moe = timed(phase_train_moe)
    counts.update({k: moe[k] for k in ("moe_ffn_cuda",
                                       "fused_add_rms_norm_cuda",
                                       *(f"{n}_cuda" for n in ROPE))})
    bert, bert_ms = timed(phase_train_bert)
    counts["fused_add_layer_norm_cuda"] = bert["fused_add_layer_norm_cuda"]
    timed(phase_train_bert, dropout=True)
    timed(phase_train_recipes, train_ms, bert_ms)
    timed(phase_card_vs_cpu)
    timed(phase_train_card_vs_cpu)
    timed(phase_train_card_vs_cpu, "PT_ATTN_EINSUM")
    timed(phase_train_moe_card_vs_cpu)
    timed(phase_bert_card_vs_cpu)
    timed(phase_recipes_card_vs_cpu)
    timed(phase_dropout_card)
    timed(phase_train_graphs)
    timed(phase_deepfm)
    whole = timed(phase_supervised)
    # phase 10's predictor runs, each counted on its own (not added to
    # phase 4's, which ``launches`` keeps)
    art = timed(phase_serve_artifact)
    # phase 11's runs, each counted on its own as well
    disagg = timed(phase_serve_disagg)
    # and phase 12's
    qos = timed(phase_serve_qos)
    # phase 13's replica processes, each counted in its replica
    fleet = timed(phase_serve_fleet)
    # phase 14's tp=2 ranks, each counted in its rank
    tp_worst, tp_launches = timed(phase_serve_plan)
    for name, err in tp_worst.items():
        worst[name] = max(worst[name], err)
    # phase 15's arms and phase 16's ranks, each counted on its own
    varlen_worst, varlen_launches = timed(phase_bert_varlen)
    for name, err in varlen_worst.items():
        worst[name] = max(worst[name], err)
    launch_launches = timed(phase_launch, whole)
    # phase 17's O1 fit and O2 steps, each counted on its own
    hapi_launches = timed(phase_hapi)
    # phase 18's compiled training run and predictor runs
    jit_launches = timed(phase_jit)
    # phase 19's profiled replay
    audit_launches = timed(phase_audit, times)
    # phase 20's per-step and window runs of the Llama-MoE, and #9 at its
    # serving shapes
    moe_serve, moe_times = timed(phase_serve_moe)
    sources = {"paged": "paddle_tpu_torch/csrc/paged_attention.cu",
               "flash": "paddle_tpu_torch/csrc/flash_attention.cu",
               "moe": "paddle_tpu_torch/csrc/moe_ffn.cu",
               "fused": "paddle_tpu_torch/csrc/rms_norm.cu"}
    fa = "paddle_tpu/ops/pallas/flash_attention.py"
    replaces = {
        "paged_decode_attention": "paddle_tpu/ops/pallas/paged_attention.py:157",
        "paged_multiquery_attention":
            "paddle_tpu/ops/pallas/paged_attention.py:278",
        "flash_attention_fwd": f"{fa}:136",
        "flash_attention_bwd_dq": f"{fa}:280",
        "flash_attention_bwd_dkv": f"{fa}:296",
        # the same three kernels with rope=True, under _flash_mha_rope
        "flash_attention_rope_fwd": f"{fa}:348",
        "flash_attention_rope_bwd_dq": f"{fa}:348",
        "flash_attention_rope_bwd_dkv": f"{fa}:348",
        "fused_add_rms_norm": "paddle_tpu/ops/pallas/rms_norm.py:66",
        "fused_add_layer_norm": "paddle_tpu/ops/pallas/rms_norm.py:155",
        "moe_ffn": "paddle_tpu/ops/pallas/moe_ffn.py:72"}
    kernels = [dict(name=name, route="cuda",
                    source=sources[name.split("_")[0]],
                    replaces=replaces[name],
                    launches=counts[name + "_cuda"],
                    max_abs_err=worst[name], ms=times[name]["ms"],
                    plain_ms=times[name]["plain_ms"],
                    bound_ms=times[name]["bound_ms"],
                    bound_by=times[name]["bound_by"],
                    library_ms=times[name]["library_ms"])
               for name in replaces]
    for k in kernels:
        if k["name"].startswith("paged_"):
            k["launches_phase10"] = {arm: c[k["name"] + "_cuda"]
                                     for arm, c in art.items()}
            k["launches_phase11"] = {arm: c[k["name"] + "_cuda"]
                                     for arm, c in disagg.items()}
            k["launches_phase12"] = {arm: c[k["name"] + "_cuda"]
                                     for arm, c in qos.items()}
            k["launches_phase13"] = {arm: c[k["name"] + "_cuda"]
                                     for arm, c in fleet.items()}
            k["launches_phase14"] = {arm: c[k["name"] + "_cuda"]
                                     for arm, c in tp_launches.items()}
        if k["name"] in FLASH + ("fused_add_layer_norm",):
            k["launches_phase15"] = {arm: c[k["name"] + "_cuda"]
                                     for arm, c in varlen_launches.items()}
            k["launches_phase17"] = {arm: c[k["name"] + "_cuda"]
                                     for arm, c in hapi_launches.items()}
            k["launches_phase18"] = {arm: c[k["name"] + "_cuda"]
                                     for arm, c in jit_launches.items()}
        if k["name"] in ("paged_decode_attention",
                         "paged_multiquery_attention", "moe_ffn"):
            k["launches_phase20"] = {arm: c[k["name"] + "_cuda"]
                                     for arm, c in moe_serve.items()}
        if k["name"] == "moe_ffn":
            k["serving_shapes"] = {
                shape: {key: r[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for shape, r in moe_times.items()}
        if k["name"] in FLASH:
            k["launches_phase19"] = audit_launches[k["name"] + "_cuda"]
            k["launches_phase16"] = {
                job: {rank: c[k["name"]] for rank, c in ranks.items()}
                for job, ranks in launch_launches.items()}
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--supervised-child"]:
        sys.exit(supervised_child(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--launch-child"]:
        sys.exit(launch_child(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--tp-child"]:
        sys.exit(tp_child(int(sys.argv[2]), int(sys.argv[3]),
                          *sys.argv[4:8]))
    sys.exit(main())
