#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a,
   checks in the SASS (cuobjdump) that every instantiation of the
   flash_attention kernels runs on the tensor cores (HGMMA for the bf16
   forward and backward, HMMA for the float32 forward's and backward's
   3xTF32), and in ptxas's report that the hd-256 instantiations of the
   backward's kernels and of the float32 forward, the hd-64, hd-96 and
   hd-128 ones of the bf16 backward's kernels, all 5 of the rmsnorm backward's
   warp kernel, the N-64 ones of the wkv6 backward's kernels (its row
   passes, chunk contributions and scan) and all 4 of the rglru backward
   do not spill (the bf16 forward's registers at every head dim are
   printed);
3. kernels: each of the nine kernels (the five forward kernels and the
   rmsnorm, flash_attention, wkv6 and rglru backward kernels) against its plain
   torch version on the card, at the serving paths' shapes (gemma-2b: bf16, batch 4, prompt
   512, cache 544; rwkv6-1.6b: wkv6 at (4, 32, 512, 64); recurrentgemma-9b:
   flash_attention at (4, 16, 2048, 256), flash_decode over a 2048-slot
   ring, rmsnorm at width 4096, rglru at (4, 2048, 4096) with float32 and
   with bf16 inputs; deepseek-7b, granite-3-2b, qwen2.5-3b, olmoe-1b-7b,
   phi-3-vision-4.2b and kimi-k2-1t-a32b: flash_attention and its backward
   at (4, 32, 512, 128) MHA, (4, 32, 512, 64) g 4, (4, 16, 512, 128) g 8,
   (4, 16, 512, 128) MHA, (4, 32, 768, 96) MHA (phi-3-vision's 256 image
   and 512 text positions; also in float32, forward and backward) and (4,
   64, 512, 112) g 8 (kimi-k2's head dim, bf16 only: its float32 calls
   must raise ValueError and launch nothing), flash_decode over their
   544-slot caches (phi-3-vision's 800), each twice for the same bits,
   rmsnorm and its backward at (2048, 4096) and at kimi-k2's (2048, 7168)
   bf16) plus ragged / window / ring / empty-row /
   strong-decay / float32 / head-dim cases (flash_attention's float32
   route also at hd 256 with a window, with a base one element off, at the
   train_llm surface (8, 8, 2048, 256) and at gemma-2b's serve shape in
   float32, each with its lse and two calls giving the same bits), the
   reference's own test shapes of wkv6 (head sizes 8, 16, 32) and rglru,
   wkv6's S = 1 and odd-grid cases and the check that its serve grid is
   one wave, and
   rglru's S = 1, short-tile, unaligned-row, long-sequence and
   extreme-decay cases; the backward kernels at the training shapes
   (rmsnorm_bwd at (2048, 2048) bf16 and f32, its device time split by
   kernel, and at (2048, 4096), 2049 rows, a width and a base the warp
   kernel does not take, ragged float32 widths; flash_attention_bwd at
   gemma-2b's shape, recurrentgemma-9b's window shape, a float32 shape,
   gemma-2b's shape in float32 and the train_llm surface's (8, 8, 2048,
   256) in float32 (untimed; the kernel and the float32 plain version each
   also against the plain formulas in float64), and ragged / window /
   not-causal / head-dim / misaligned-dout cases; wkv6_bwd at rwkv6-1.6b's
   training shape (4, 32, 512, 64) in bf16 and in float32 (the float32
   kernel and plain version each also against the formulas in float64),
   its five launches' plan against ``rwkv6.bwd_plan`` with the warps an SM
   resident, its device time split by kernel, and ragged, short-tile, S =
   1, chunk-boundary (S = C + 1, 2C - 1, 3C), wlog = -8 (against float64,
   over several chunks), contiguous-dy and the reference test's shapes;
   rglru_bwd at recurrentgemma-9b's training
   shape (4, 512, 4096) in float32 and at the forward's (4, 2048, 4096) in
   float32 and with bf16 log_a, a nonzero h0 and dh_final, the float32
   kernel and plain version each also against the formulas in float64,
   and the forward's edge cases), each also run twice and required to give
   the same bits, and the forward's lse; whisper-tiny's attention
   (``whisper_rows``): flash_attention with a key length of its own, not
   causal, bf16 and float32, at its cross shape q (4, 6, 416, 64) over k/v
   (4, 6, 1500, 64) and its encoder's (4, 6, 1500, 64), the ragged key
   lengths 1, 63, 65 and 1500 beside 40 and 100 queries (and 65 keys at
   head dim 96), and flash_decode
   over the 1500-frame memory with every slot valid, each with its lse
   (flash_attention) and the same bits twice; a causal or windowed call
   with its own key length must raise; the backward with a key length of
   its own (``cross_backward_rows``): flash_attention_bwd at whisper-tiny's
   cross shape and its encoder's, bf16 and float32 (the float32 kernel and
   plain version each also against the formulas in float64), timed beside
   SDPA's autograd backward with the same key length, and the ragged key
   lengths beside 40 and 100 queries, g 1 and 2, head dims 64 and 96, both
   routes, dk / dv of Sk rows; the int8 cache's dequantize of k
   and v at gemma-2b's decode shape, timed beside its flash_decode row;
   each timed per call with CUDA events and on the device alone with
   torch.profiler, beside its plain version, its bound and, where one
   exists, one PyTorch library call. A profiler trace counts only the
   kernels after a marker kernel that follows one extra call, and only
   when it holds every kernel its calls launched (``trace_complete``);
   after three that do not, the run fails;
   moe layer: olmoe-1b-7b's mixture-of-experts FFN alone at full width
   (bf16, batch 4 x 512, 64 experts, top-8, capacity factor 1.25):
   forward and backward twice giving the same bits, the dropped slots, the
   device ms of the router, dispatch, expert products, combine and a
   forward and backward; in float32 and drop-free against the dense
   oracle ``moe_ref``;
   mesh: the sharding slice on a one-rank NCCL mesh (``mesh_phase``): the
   same MoE layer on the expert-parallel path (``moe_apply_manual``: the
   same bits twice, dropped slots and device ms beside the auto path's, the
   one-rank all-reduce of its output, float32 drop-free against
   ``moe_ref``), olmoe-1b-7b manual at full width and MESH_LAYERS layers
   through prefill and decode with rules (exact launches; logits and
   greedy tokens against the auto path), ``pipeline_apply`` over gemma-2b
   blocks against the blocks in sequence, kimi-k2-1t-a32b at full width, 1
   layer and MESH_KIMI_EXPERTS experts under its own rules (FSDP over
   "data", Adafactor's whole-leaf statistics, bf16 masters: ``mesh_kimi``),
   one train step against the same step without rules, and a reduced train
   step with rules before and after ``remesh_rules``; it destroys its
   process group;
   tp: the "model"-axis split (``tp_phase``): two processes share the card
   in a (1, 2) mesh over gloo (its collectives on the CUDA tensors),
   gemma-2b, rwkv6-1.6b and
   recurrentgemma-9b at full width in float32, depth cut (TP_ARCHS), each
   rank on its shards: prefill logits, the greedy tokens of 8 decode steps,
   the loss and every gradient leaf against the same run on one rank, and
   every kernel forward and backward launched on each rank on its local
   slices (its counter, and the profiler's kernels by name); first the
   attention kernels on a kv-head view at an offset, bit for bit as on a
   contiguous copy; rwkv6's ``layers/0/tm/ln_bias`` gradient on one rank,
   kernel path and plain path, each against the same loss's gradient in
   float64 (``leaf_f64_check``); then FSDP of the dense leaves
   (``fsdp_run``): the same two processes in a (2, 1) mesh with
   fsdp=True, FSDP_ARCH at full width in float32, each rank on its rows
   and shards against the same run without rules on that rank: logits,
   tokens, loss, gradients, an AdamW step with int8 compression and an
   Adafactor step, the bytes gathered and scattered;
   dryrun: ``python -m repro_torch.launch.dryrun`` on the DRYRUN_CELLS
   (deepseek-7b with FSDP, kimi-k2's train_4k on both meshes among them),
   each in a subprocess on fake tensors (no device memory), started before
   the mesh phase: argument and peak GB a device and the three roofline
   terms, analytic from the H100's data-sheet peaks;
4. serve: gemma-2b (prompt 512), rwkv6-1.6b (prompt 512),
   recurrentgemma-9b (prompt 2048, its window), deepseek-7b, granite-3-2b,
   qwen2.5-3b and olmoe-1b-7b (prompt 512), whisper-tiny (1500 seeded
   frames, prompt 416: its decoder context of 448 with the new tokens),
   phi-3-vision-4.2b (256 seeded image embeddings before a prompt of 512:
   768 prefilled positions, decode steps after them),
   gemma-2b with its KV cache in int8 (its logits' distance from the
   bf16-cache run printed) and kimi-k2-1t-a32b at one of its 61 layers with
   all 384 experts (KIMI_SERVE; its MoE layer alone after the run:
   ``moe_at_width``) at full width, random weights from a seed,
   through ``repro_torch.launch.serve``: 4 requests, 32 new tokens each.
   For each: the exact kernel launch counts of the run (counts set to 0
   just before it), finite logits, the prefill and the first decode steps
   against the plain versions on the same weights, and a profile of a
   prefill and a few decode steps. Then each of the nine others at full
   width in float32, kernel path against plain path (5 tokens; qwen's and
   whisper's qkv biases made nonzero; not kimi-k2, whose float32 attention
   routes have no head dim 112 and whose float32 weights would not fit),
   and a reduced float32 model of gemma, rwkv6,
   recurrentgemma (5 layers, so that its remainder stack runs), qwen2.5,
   olmoe, whisper, gemma with the int8 cache, phi-3-vision (4 image
   tokens) and kimi-k2 on the card against the
   same weights on the CPU, each printing the launches of the float32
   attention routes it made;
   train: gemma-2b and rwkv6-1.6b at full width and depth, and
   recurrentgemma-9b, granite-3-2b, qwen2.5-3b, deepseek-7b, olmoe-1b-7b,
   phi-3-vision-4.2b and kimi-k2-1t-a32b (its experts cut too:
   TRAIN_EXPERTS) at full width and a cut depth (TRAIN_ARCHS) through
   ``repro_torch.launch.train`` (bf16 activations, float32 masters and
   AdamW, kimi-k2's bf16 masters and Adafactor, batch 4 x 512, 5 steps on
   one repeated batch), and whisper-tiny
   at full width and depth through ``train.step.make_train_step`` (batch 4
   x 448 tokens with 1500 seeded frames a row: the encoder, the decoder's
   self- and cross-attention forward and backward): the exact launch
   counts of the run, including the backward kernels (every decoder block
   recomputed once in the backward, the encoder not), a falling loss, step
   s, tokens/s and peak memory; one step's gradients against the plain
   path's, leaf by leaf (rwkv6's in float32 activations, its bf16 readings
   printed: GRAD_F32_ARCHS; kimi-k2's plain path on the kernel path's
   expert choices: GRAD_PINNED_ROUTING; phi-3-vision's batch with 256 seeded image
   embeddings a row, so that the loss's image offset runs forward and
   backward; whisper-tiny's with its frames, its k biases, zero in exact
   arithmetic, held against their wk's gradient); a
   profile of a step; the FTTrainer's lossless invariant at reduced size
   under hybrid, agent, core and checkpoint (gemma) and
   hybrid (rwkv6, recurrentgemma, olmoe), and ``launch.fig15``'s two tables; one
   hybrid run of gemma-2b at full width and FT_FULL_LAYERS layers with a
   predicted failure (one migration of the whole state through host
   memory) bit-identical to a failure-free run. Each phase ends by collecting and emptying the
   allocator's cache; before each full-width training run the device
   memory still allocated is printed, and more than LEFTOVER_BYTES fails
   the run. The reduced FT runs must launch both float32 attention routes,
   forward and backward; they and fig15 print those launches;
5. paper: the paper's own path, which launches none of the nine kernels
   (their counts must stay 0): ``repro_torch.launch.tables`` on the card
   (an unpinned ``measure_micro``, the failure predictor trained on the
   card), every check of Tables 1-2 and of the predictor passing; the
   card-trained predictor against the CPU-trained one (weights within
   PREDICTOR_TOL, equal threshold); the genome job of
   ``configs/paper_genome.CONFIG`` (PAPER_BASES bases, 5000 patterns of
   15-25 bases, 3 search nodes x 4 chunks) through
   ``repro_torch.launch.genome``: a failure-free run and, for each of the
   seven strategies, a run with a predicted failure and a migration whose
   hit table must equal the failure-free one, with every planted
   occurrence found; the fast search against ``_match_positions_plain``
   over one 2^20-base chunk with all 5000 patterns; the search timed per
   chunk beside its bound. Prints the search's seconds and Mbases/s, the
   Tables' wall seconds and the predictor's training ms;
6. figures: the paper's Figures 8-13 through ``repro_torch.launch.figures``
   on the card (the migrated payload a float32 tensor there) at
   FIGURE_TRIALS trials a point, as in the paper: every one of the 10
   paper-claim checks passing, the three CSVs written, the nine kernels'
   counts staying 0. Prints each sweep's seconds;
7. campaign: the paper's job under streams of failures, which launches
   none of the nine kernels either (their counts must stay 0). All 17
   registered families under all seven strategies, at CAMPAIGN_SEEDS seeds
   (FLEET_CHECK_SEEDS for fleet_stress): the replay fold on the card
   against ``CampaignEngine`` trial for trial (the reference tests'
   tolerances, ``launch/campaign.trial_mismatches``, which holds the SLO
   bills of ``decode_fleet_churn`` to the engine's bit for bit) and
   against the same fold on the CPU bit for bit, under one MicroCosts per
   family; the engine's structured trace against the trace that
   ``obs.trace.reconstruct_traces`` rebuilds from the card's fold, for
   TRACE_SEEDS seeds of every family under TRACE_STRATEGIES. Then
   ``mc_trajectories`` at full size on the card, ``mc_stress`` at 2000
   seeds and ``fleet_stress`` at 256 under ``central_single`` and
   ``core``, each checked bit for bit against the CPU fold and its first
   trials against the engine, timed (host clock; the trials are on the host
   when it is read) and profiled (``torch.profiler``: kernel launches per
   slot and the device's busy share of an unprofiled fold); the two LLM
   families (``decode_fleet_churn``, ``llm_pretrain_storm``) at 256 seeds
   under all seven strategies, bit for bit against the CPU fold (SLO bills
   included) and their first trials against the engine (SLO bills bit for
   bit), fold and engine timed; ``tile_slots`` 1 / 8 / 64 bit-identical on
   ``fleet_stress`` on the card; ``mc_totals`` at 2000 seeds of
   ``table1_random`` on the card, its mean within 4 standard errors of the
   closed form's expectation; with more than one card, ``fleet_stress`` x
   256 split over every card against one card, bit for bit, and the
   default split (one card) bit for bit and no slower than
   ``n_devices=1``. Prints the folds' seconds, seeds/s, launches per slot,
   busy share and the engine's seconds per trial;
8. workloads: the measured step surfaces of ``serve_decode`` and
   ``train_llm`` (``Workload.measured_step_surface``) on the card at the
   reference's default shape and at gemma-2b's width (SURFACE_SHAPES,
   float32, heads = KV heads), per shard count (1, 2, 4): the
   ``flash_decode`` / ``flash_attention`` launch counters (set to 0 just
   before each) must rise by n_shards x (warmup + n), ``impl`` must read
   ``kernel`` and ``backend`` ``cuda``; one output per case held against its
   plain version within tests/test_kernels.py's float32 tolerances (those
   calls are made after the counts are read), and one call of it at one
   shard timed beside one library call on the same inputs (SDPA, causal;
   masked SDPA for decode) and its bound. Prints the per-shard step times
   beside the card;
9. orchestrator: the live orchestrator (``repro_torch.orchestrator``)
   supervising real ``python -m repro_torch.orchestrator.worker`` processes
   on the card, after ``check_free_memory``. (a) The genome live cert of
   the reference's slow test: ``live_genome_single``, the oracle over
   ORACLE_CANDIDATES at ORACLE_SEEDS seeds, time scale LIVE_TIME_SCALE, the
   kill injector, deadline LIVE_DEADLINE_S: the campaign survives with one
   failure handled, results from shards 0-3, failure < verdict < migrate
   in the trace, the live makespan within LIVE_REL_ERR of the engine's
   prediction, no worker crashed, every shard holder's heartbeats from
   ``cuda``, none of the nine kernels launched, and the merged hits equal
   to ``search_chunk_plain`` over the same genome on the CPU. (b)
   ``train_llm`` under the stall injector (SIGSTOP, reaped by the heartbeat
   stall detector) with STALL_STRATEGY pinned: the plan's calibration
   surface launches flash_attention's float32 route (``impl`` kernel,
   ``backend`` cuda), one stall, the same checks, and each shard's loss
   within TRAIN_LOSS_RTOL of a failure-free ``TrainProgram`` on the card.
   Prints the live and predicted makespans, the relative error, the
   oracle's choice, each worker's seconds from spawn to first heartbeat
   and to warm, and the calibrated against the paced step wall seconds;
10. prints each phase's seconds, the ``kernels`` JSON line (a float32 attention row's launches are
   its route's, summed over the float32 serve checks, the reduced FT runs,
   fig15, the train_llm surfaces and the orchestrator's train_llm
   calibration; every other row's over the serve and train runs), then the
   final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense): memory rate and peak rates by operand type.
# "float32 3xTF32" is the card's fastest float32-accurate product: three
# TF32 tensor-core passes (hi·hi + hi·lo + lo·hi) at 495 TFLOP/s, faster
# than float32 FMA's 67; the float32 attention rows count it.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "float32 3xTF32": 495e12 / 3}

TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # tests/test_kernels.py tolerances
DECODE_TOL_F32 = 3e-5
# flash_decode bf16 against its plain version: absolute 4e-3 (the readings
# are <= 1e-3 at the decode shapes) plus one bf16 step (2^-7) of the value,
# the most that rounding the same float32 result two ways can differ by.
# At recurrentgemma-9b's shape the outputs are ~0.03: a dropped chunk of
# the cache reads well above this limit (the decode rows check that).
DECODE_TOL_BF16 = (4e-3, 2.0 ** -7)
# Greedy tokens of the kernel path and the plain path must agree; where they
# differ, the plain path must rank the kernel's token within TOKEN_TIE_TOL
# of its top logit: a near-tie, not an error. In bf16 the two paths' logits
# drift apart with depth as one-step roundings compound. Both limits are
# about twice the largest reading over the prefill and 4 decode steps of
# the seed-0 serve runs on an NVIDIA H100 80GB HBM3 (700 W):
#   arch               largest gap   max |kernel - plain|
#   gemma-2b           0.03125       0.1133
#   rwkv6-1.6b         0.04688       0.1904
#   recurrentgemma-9b  0.09375       0.2812
#   deepseek-7b        0.03125       0.3213
#   granite-3-2b       0.03125       0.1807
#   qwen2.5-3b         0             0.2051
#   olmoe-1b-7b        0.01562       0.1484
#   whisper-tiny       0             0.01625
#   phi-3-vision-4.2b  0             0.2539
#   kimi-k2-1t-a32b    0             0.07031   (1 layer, all 384 experts)
# gemma-2b's, rwkv6-1.6b's, the dense swiglu configs' and whisper-tiny's
# near-tie is the tighter 0.0625, two bf16 steps for logits in [4, 8)
# (qwen2.5-3b's, whisper-tiny's, phi-3-vision-4.2b's and kimi-k2's tokens
# all agreed, so twice their reading would be 0); olmoe-1b-7b's is twice its reading,
# one bf16 step for logits in [4, 8). whisper-tiny's drift limit is about
# twice its reading (4 decoder layers of d 384: the smallest drift of the
# served configs), phi-3-vision-4.2b's too (its 256 image tokens and 512
# text tokens, the chip runs of its slice), and kimi-k2's (one layer: the
# chip runs of its slice). The float32 full-width phase
# shows that the kernels themselves agree (tokens equal, logits within 1e-3)
# at the same shapes.
TOKEN_TIE_TOL = {"gemma-2b": 0.0625, "rwkv6-1.6b": 0.0625, "recurrentgemma-9b": 0.1875,
                 "deepseek-7b": 0.0625, "granite-3-2b": 0.0625, "qwen2.5-3b": 0.0625,
                 "olmoe-1b-7b": 0.03125, "whisper-tiny": 0.0625, "phi-3-vision-4.2b": 0.0625,
                 "kimi-k2-1t-a32b": 0.0625}
BF16_LOGITS_DRIFT = {"gemma-2b": 0.25, "rwkv6-1.6b": 0.4, "recurrentgemma-9b": 0.55,
                     "deepseek-7b": 0.65, "granite-3-2b": 0.37, "qwen2.5-3b": 0.42,
                     "olmoe-1b-7b": 0.3, "whisper-tiny": 0.035, "phi-3-vision-4.2b": 0.5,
                     "kimi-k2-1t-a32b": 0.15}
# The backward kernels against their plain versions, (atol, rtol). Both sum
# in float32 from the same inputs in another order; in bf16 the outputs are
# rounded once more, and a value that lies on a rounding boundary may land
# one bf16 step (2^-7 of it at most) away. float32: sums over up to
# g·S = 4096 terms (dK/dV) or 2048 rows (dscale) in another order.
BWD_TOL = {"bfloat16": (1e-3, 2.0 ** -7), "float32": (1e-4, 1e-4)}
LSE_TOL = (1e-4, 1e-5)  # the forward's log-sum-exp, float32 either way
LOGITS_TOL_F32 = 1e-4  # reduced float32 model, card kernels vs CPU plain versions
LOGITS_TOL_FULL_F32 = 1e-3  # full-width float32 model, card kernels vs plain versions

ARCH, BATCH, PROMPT, NEW = "gemma-2b", 4, 512, 32
# the serve runs: (arch, prompt length); recurrentgemma's prompt is its
# window; whisper-tiny's 416 + NEW = 448 is its published decoder context;
# phi-3-vision's 512 text tokens follow its 256 image tokens: 768 prefilled
# positions, a cache of 800
SERVES = (("gemma-2b", 512), ("rwkv6-1.6b", 512), ("recurrentgemma-9b", 2048),
          ("deepseek-7b", 512), ("granite-3-2b", 512), ("qwen2.5-3b", 512),
          ("olmoe-1b-7b", 512), ("whisper-tiny", 416), ("phi-3-vision-4.2b", 512))
# the int8 KV cache's serve run: ARCH at full width with its cache in int8
# (the dry run's kv_int8 cell's arch), held to ARCH's limits above against
# its own plain replay (the same int8 cache on the plain path)
INT8 = {"kv_cache_dtype": "int8"}
# whisper-tiny's attention rows: its 6 heads of 64 over its 1500 frames, its
# serve prompt; the cross calls' ragged key lengths (one key, a k-tile less
# one, a k-tile and one, the frames), each beside fewer and more queries
WHISPER, WHISPER_PROMPT = "whisper-tiny", 416
CROSS_KEY_LENGTHS = (1, 63, 65, 1500)
CROSS_QUERY_LENGTHS = (40, 100)
# the configs whose attention and decode shapes get rows of their own in the
# kernel phase: the dense swiglu configs, olmoe (MHA, 16 heads of 128),
# phi-3-vision (MHA, 32 heads of 96, PROMPT text tokens after its image
# tokens: ``row_seq``) and kimi-k2 (64 heads of 112 on 8 KV heads, g 8)
ROW_ARCHS = ("deepseek-7b", "granite-3-2b", "qwen2.5-3b", "olmoe-1b-7b", "phi-3-vision-4.2b",
             "kimi-k2-1t-a32b")
# the vision config: its float32 attention rows and its training
VISION_ARCH = "phi-3-vision-4.2b"
# the mixture-of-experts config: its MoE layer alone at full width, bf16,
# BATCH x PROMPT (moe_layer_phase)
MOE_ARCH = "olmoe-1b-7b"
MOE_TOL_F32 = 2e-5  # the dispatch path against the dense oracle, float32, drop-free
# kimi-k2-1t-a32b: its 1 T parameters (61 layers of 384 experts) fit no
# card, so it runs at full width (d 7168, 64 heads of 112 on 8 KV heads,
# expert width 2048, top-8 and its shared expert, vocab 163840) with its
# depth cut. Served at one layer with all 384 experts (KIMI_SERVE: 19.42 G
# parameters, 38.8 GB of bf16 weights; two layers would be 73.0 GB of
# weights alone). Trained at one layer with its experts cut to
# TRAIN_EXPERTS (top-8 and the expert width kept): bf16 masters and bf16
# gradients are 4 bytes a parameter and the gradient check holds a second
# gradient set (6 bytes a parameter), 117 GB at 384 experts.
KIMI = "kimi-k2-1t-a32b"
KIMI_SERVE = {"n_layers": 1}
# the mesh phase: MOE_ARCH on the manual path at full width with its depth
# cut to MESH_LAYERS (a quarter of its 16: enough for one layer's experts to
# feed the next layer's router, at a few seconds), MESH_STEPS decode steps;
# pipeline_apply over PIPE_LAYERS gemma-2b attention blocks in PIPE_MICRO
# microbatches, held to tests/test_pipeline.py's tolerance
MESH_LAYERS, MESH_STEPS = 4, 4
# kimi-k2 under its own rules on the one-rank mesh (mesh_phase): full width,
# 1 layer, its experts cut to MESH_KIMI_EXPERTS (fewer than TRAIN_EXPERTS:
# the phase holds two train states), fsdp=True, Adafactor, bf16 masters; a
# TRAIN_BATCH x TRAIN_SEQ step with the rules against the same step
# without them
MESH_KIMI_EXPERTS = 64
PIPE_LAYERS, PIPE_MICRO, PIPE_TOL = 2, 4, 1e-5
WKV6_TOL_F32 = 3e-5  # tests/test_kernels.py: y and the float32 state against the chunked form
WKV6_TOL_STRONG_DECAY = 1e-4
# the wkv6 backward against its plain version, per output: atol 1e-4 of the
# plain output's largest magnitude (tests/test_torch_rwkv_train.py's limit
# against jax.vjp: float32 sums in another order; dwlog is a difference of
# suffix sums), plus one bf16 step (2^-7 of the value) for bf16 dr/dk/dv
WKV6_BWD_REL = 1e-4
WKV6_BWD_NAMES = ("dr", "dk", "dv", "dwlog", "du", "dstate")
# warps an SM the wkv6 backward's row passes must keep resident (its
# chunked design at the training shape: the first pass's blocks of 2 warps
# at 168 registers, 12; the second's of 8 warps at 128, 16)
WKV6_BWD_ROW_WARPS = 12
# the rglru backward against its plain version, per output: atol 1e-4 of the
# plain output's largest magnitude (tests/test_torch_rglru_train.py's limit
# against jax.vjp: the reverse recurrence summed in another order), plus one
# bf16 step (2^-7 of the value) for bf16 dlog_a and dm
RGLRU_BWD_REL = 1e-4
RGLRU_BWD_NAMES = ("dlog_a", "dm", "dh0")
# the paper phase: the card-trained predictor against the CPU-trained one,
# float32 sums in another order (tests/test_torch_paper.py holds the port to
# the JAX predictor with the same limit); the genome's size (the paper's
# 2^29 bases unless cut, see PERF.md) and the plain check's chunk
PREDICTOR_TOL = 1e-5
PAPER_BASES = 2 ** 29
PLAIN_CHECK_BASES = 2 ** 20
# the campaign phase: seeds per (family, strategy) cell of the sweep; the
# full-size Monte-Carlo runs (the reference bench's --seeds default and its
# fleet-family cap, benchmarks/bench_scenarios.py); trials checked against
# the engine in those; mc_totals' seeds and its limit in standard errors
CAMPAIGN_SEEDS = 4
FLEET_CHECK_SEEDS = 2
MC_FULL = (("mc_stress", 2000), ("fleet_stress", 256))
MC_STRATEGIES = ("central_single", "core")
MC_ENGINE_CHECKS = 4
MC_TOTALS_SEEDS = 2000
MC_TOTALS_SE = 4.0
# the LLM families folded at full size (the reference bench's fleet cap)
LLM_FULL = (("decode_fleet_churn", 256), ("llm_pretrain_storm", 256))
# engine-vs-fold traces: seeds per family (1 for fleet_stress, ~1.4 s a trial)
TRACE_SEEDS = 2
TRACE_STRATEGIES = ("central_single", "core", "hybrid")
# the default seed split against n_devices=1: host-clock noise allowed
# between two calls of the same one-card program
SPLIT_NOISE = 0.10
# the figures: trials a point (the paper's 30)
FIGURE_TRIALS = 30
# the measured step surfaces: (batch, seq_len, heads, head_dim), float32 —
# the reference's default shape (obs/profile.py::time_pallas_kernel) and
# gemma-2b's width (8 query heads of 256, the serve_decode workload's batch
# 8 and 2048-token cache)
SURFACE_SHAPES = ((8, 256, 4, 64), (8, 2048, 8, 256))
SURFACE_SHARDS = (1, 2, 4)
SURFACE_N, SURFACE_WARMUP = 2, 1
# the orchestrator phase: the reference's genome live cert (its slow test's
# settings: the oracle over ORACLE_CANDIDATES at ORACLE_SEEDS seeds, the
# kill injector, its deadline and its bound on the live makespan's relative
# error), then train_llm under the stall injector with a pinned strategy at
# a faster time scale, its stall timeout STALL_STEPS paced steps (the
# reference's stall test's), each shard's final loss against a failure-free
# in-process run on the card within TRAIN_LOSS_RTOL
LIVE_SCENARIO = "live_genome_single"
LIVE_TIME_SCALE = 240.0
ORACLE_CANDIDATES = ("central_single", "core")
ORACLE_SEEDS = 24
LIVE_DEADLINE_S = 240.0
LIVE_REL_ERR = 0.25
STALL_TIME_SCALE = 480.0
STALL_STRATEGY = "core"
STALL_STEPS = 3.0
TRAIN_LOSS_RTOL = 1e-6
WORKER_ABORT_S = 300.0
# the train phase: TRAIN_ARCHS at full width, bf16 activations, float32
# masters and AdamW moments (kimi-k2: bf16 masters and Adafactor), batch 4 x
# 512, TRAIN_STEPS steps on one repeated batch through
# ``repro_torch.launch.train``. Each is (arch, layers): None keeps the full
# depth. recurrentgemma-9b's 38 layers (~9.4 B parameters) need ~113 GB of
# masters and moments, more than the card's 80 GB: it runs 9, three (rec,
# rec, attn) groups (~3.02 B parameters, ~34 GiB of state), through the
# launcher's make_trainer (it has no depth flag). deepseek-7b's 30 layers
# (~6.91 B parameters) would need ~77 GiB of masters and moments alone
# (tools/train_peak.py on an NVIDIA H100 80GB HBM3 at 700 W: 56.57, 62.60,
# 68.63 and 74.66 GiB allocated at 12, 14, 16 and 18 layers of its 79.18,
# 3.02 GiB a layer). olmoe-1b-7b's 16 layers (6.92 B parameters, 419.6 M a
# layer) would need ~111 GB of masters, moments and gradients
# (tools/train_peak.py on the same card: 56.16, 62.41 and 68.66 GiB
# allocated at 8, 9 and 10 layers, 6.25 GiB a layer). The script's time
# (it must stay within the 912.2 s it took before kimi-k2 trained and
# served, NVIDIA H100 80GB HBM3 at 700 W) pays for kimi-k2's phases by
# cutting training depths that memory allowed. Much of an arch's train
# time is spent on the host in proportion to its state (the trainer's final
# ``tree_hash`` copies the whole state to the host) and its layers (the
# profile's trace). So: rwkv6-1.6b 24 -> 8 layers,
# recurrentgemma-9b 9 -> 3 (one (rec, rec, attn) group), granite-3-2b 40
# -> 10, qwen2.5-3b 36 -> 9, deepseek-7b 16 -> 4, olmoe-1b-7b 10 -> 2,
# phi-3-vision-4.2b 32 -> 8; gemma-2b keeps its 18 through ``launch.train
# --full``. kimi-k2 trains at 1 of its 61 layers (TRAIN_EXPERTS). The FSDP
# case of the tp phase and kimi-k2 under its rules in the mesh phase are
# paid for by halving four of those depths again: rwkv6-1.6b 8 -> 4,
# granite-3-2b 10 -> 5, qwen2.5-3b 9 -> 4, phi-3-vision-4.2b 8 -> 4.
TRAIN_ARCHS = (("gemma-2b", None), ("rwkv6-1.6b", 4), ("recurrentgemma-9b", 3),
               ("granite-3-2b", 5), ("qwen2.5-3b", 4), ("deepseek-7b", 4),
               ("olmoe-1b-7b", 2), ("phi-3-vision-4.2b", 4), (KIMI, 1))
# experts a layer where TRAIN_ARCHS cuts them too. kimi-k2: the most that
# leave 8 GiB of the card's 79.18 GiB unreserved through its gradient
# check, which holds bf16 masters and two bf16 gradient sets
# (tools/train_peak.py --grad-check on an NVIDIA H100 80GB HBM3 at 700 W:
# 45.62 / 57.43 GiB allocated and 52.85 / 63.19 GiB reserved at 128 / 176
# experts, 0.2154 GiB reserved an expert; training alone 32.94 / 40.70 GiB
# allocated): 208 reserves ~70.1 GiB
TRAIN_EXPERTS = {KIMI: 208}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 4, 512
# the encoder-decoder trained at full width and depth (4 encoder layers over
# its 1500 frames, 4 decoder layers) through ``make_train_step``:
# ``launch.train`` feeds no frames, as the reference's launcher does not.
# Its rows hold its decoder context of 448 tokens (WHISPER_PROMPT + NEW),
# TRAIN_BATCH of them, with seeded frames
WHISPER_TRAIN_SEQ = WHISPER_PROMPT + NEW
# the FT invariant at reduced size (tests/test_trainer_integration.py's
# schedule: 16 steps, a checkpoint every 4, a predicted failure at t = 5 and
# an unpredicted one at t = 11) and at full width (hybrid, FT_FULL_STEPS
# steps, one predicted failure landing at FT_FULL_FAIL_T with a lead of
# FT_FULL_LEAD_S: one migration of the whole training state)
FT_POLICIES = ("hybrid", "agent", "core", "checkpoint")
FT_STEPS, FT_CKPT_EVERY = 16, 4
FT_FULL_STEPS, FT_FULL_FAIL_T, FT_FULL_LEAD_S = 6, 3.0, 0.5
# one step's gradients at full width, kernel path against plain path, per
# leaf: max |g_kernel - g_plain| <= GRAD_TOL_BF16 * max |g_plain|. In bf16
# the two paths round at other places (the kernel's P·V takes P in bf16, as
# SDPA does) and the differences compound over 18 layers: the largest
# reading was 0.067 (layers/16/attn/wk) on an NVIDIA H100 80GB HBM3 at
# 700 W; the limit is about twice that. A gradient that is dropped or of
# the wrong sign reads 1 or more. The losses agree within LOSS_TOL_TRAIN
# relative (the reading: 1.3e-5). phi-3-vision-4.2b's 32 layers, with its
# image embeddings in the batch, read 0.1242 (layers/31/attn/wq; median
# 0.06959) on the same card: the limit holds it as it is.
GRAD_TOL_BF16 = 0.15
LOSS_TOL_TRAIN = 1e-3
# rwkv6-1.6b's bf16 gradients of the leaves that feed r and k (mu_r, mu_k,
# wr, wk, u) are rounding noise at init on either path: the plain path's own
# bf16 step lies up to 1339 times such a leaf's largest magnitude (at
# layers/1/tm/mu_k; median leaf 0.98) from its float32 step, and the kernel
# path's 51.6 (both on an NVIDIA H100 80GB HBM3 at 700 W; the run prints the
# plain path's). Its step is held in float32 activations instead (float32
# masters as always), at about three times the largest reading there
# (0.0313 at layers/2/tm/u, median 0.0106: the step amplifies the kernels'
# ~1e-6 differences ~10^4 times through 24 layers); the bf16 step's
# readings are printed beside it. olmoe-1b-7b's bf16 expert gradients move
# with the routing: a token whose 8th and 9th expert probabilities tie in
# bf16 goes to either expert on paths that round otherwise. At 10 layers
# the plain path's bf16 step lies 0.2838 of a leaf's largest magnitude
# (layers/6/ffn/wg; median 0.03387) from its float32 step, and the kernel
# path's bf16 step 0.2355 from the plain one, while the float32 steps agree
# within 0.002175 (layers/1/ln2/scale) on the same card: it is held in
# float32 too, under the same limit.
GRAD_F32_ARCHS = ("rwkv6-1.6b", "olmoe-1b-7b")
GRAD_TOL_F32 = 0.1
# kimi-k2's bf16 expert gradients move with the routing as olmoe's do (top-8
# of 128 experts: the kernel path against the plain path read 0.5364 at
# layers/0/ffn/wo, median 0.05566, on an NVIDIA H100 80GB HBM3 at 700 W), and
# it has no float32 step to hold instead: the float32 attention routes have
# no head dim 112 (ROADMAP item 9.11). Its plain path takes the experts that
# the kernel path's router chose, call for call (``pinned_routing``), so the
# bf16 step is held under GRAD_TOL_BF16 with the same routing on both paths:
# what differs is then the kernels' arithmetic, as for the dense configs.
GRAD_PINNED_ROUTING = (KIMI,)
# device memory that may still be allocated before a full-width training
# run: a full-width state is 19-50 GiB, so more than this is a leak
LEFTOVER_BYTES = 2 ** 30
# the full-width FT run: ARCH at full width with its depth cut to
# FT_FULL_LAYERS of 18 (its two runs took 293.4 and 370.6 s of 1111.2 and
# 1298.7 s at full depth, the 28 GiB migration 122-197 s of that, on an
# NVIDIA H100 80GB HBM3 at 700 W; at 4 layers the script took 815.1 s, and
# 907.3 and 1125.3 s once phi-3-vision served and trained too, its 11.58 GB
# migration 49.7 and 59.0 s of that; at 2 the state is 8.9 GB): one
# migration of the whole state, bit-identical to the failure-free run
FT_FULL_LAYERS = 2
# the "model"-axis split on the card (tp_phase): TP_RANKS processes share
# the one card in a (1, TP_RANKS) mesh over gloo, each arch at full width
# in float32 with its depth cut (arch, layers): two layers of gemma-2b and
# rwkv6-1.6b, one (rec, rec, attn) group of recurrentgemma-9b; a batch of
# TP_BATCH x TP_PROMPT, TP_STEPS greedy decode steps and one train step,
# against the same run on one rank without rules: prefill logits within
# TP_LOGITS_TOL, the greedy tokens equal, the loss within TP_LOSS_RTOL
# relative, each gradient leaf within TP_GRAD_RTOL of its largest magnitude,
# or within twice the float32 noise of the one-rank gradient itself where
# that is larger: the one-rank run's kernel path against its plain path
# (``ops.plain_versions``) on the same leaf. A leaf whose entries are sums
# that cancel (rwkv6's group-norm bias) reads its float32 rounding far
# above 1e-4 of its magnitude (2.92e-4 for layers/0/tm/ln_bias on an
# NVIDIA H100 80GB HBM3 at 700 W), on one rank as on two
TP_RANKS = 2
TP_ARCHS = (("gemma-2b", 2), ("rwkv6-1.6b", 2), ("recurrentgemma-9b", 3))
# that leaf's one-rank gradient on the kernel path and on the plain path,
# each against the same loss's gradient in float64 (``leaf_f64_check``):
# which of the two float32 paths carries the difference between them
F64_LEAF = ("rwkv6-1.6b", "layers/0/tm/ln_bias")
# the kernels on that leaf's path, each run alone on the kernel path
F64_LEAF_KERNELS = ("rmsnorm", "rmsnorm_bwd", "wkv6", "wkv6_bwd")
TP_BATCH, TP_PROMPT, TP_STEPS = 2, 256, 8
TP_LOGITS_TOL, TP_LOSS_RTOL, TP_GRAD_RTOL = 1e-4, 1e-5, 1e-4
# FSDP of the dense leaves on the card (tp_phase): the same TP_RANKS
# processes in a (TP_RANKS, 1) mesh with fsdp=True, so that each rank holds
# half of every leaf with an "embed" or "mlp" dim and gathers it at its
# block's entry, FSDP_ARCH at full width in float32 and its depth cut
# (arch, layers), each rank on its rows of the TP_BATCH x TP_PROMPT batch;
# held on each rank against the same run without rules on that rank: the
# logits, tokens, loss and gradients to the tp limits above, then one
# AdamW step with int8 gradient compression and one Adafactor step from the
# same state (lr FSDP_LR): their losses to TP_LOSS_RTOL, AdamW's first
# moment and Adafactor's statistics to TP_GRAD_RTOL (twice that for a
# statistic of squares) of their leaf's largest magnitude, the error
# feedback to one int8 step where the rounding went the other way
# (counted) and TP_GRAD_RTOL of the leaf's largest |g| elsewhere, AdamW's
# masters within the largest move of a first step (2 lr), Adafactor's
# within FSDP_ADAFACTOR_RTOL of the leaf's largest move: its update divides
# each gradient element's error by the element's row and column
# statistics, which are small where the gradient is, so an error of
# TP_GRAD_RTOL of the largest gradient becomes a larger share of the
# largest move there (the reading: 0.0022 on an NVIDIA H100 80GB HBM3 at
# 700 W). Where the one-rank gradient lies within TP_GRAD_RTOL of the
# leaf's largest of zero its sign is noise, and a leaf with a factor of
# size 1 (gemma-2b's one kv head: wk / wv of (d, 1, hd), whose statistics
# are each element's own square) steps by lr sign(g): there the master is
# held within twice the leaf's largest move and the float32 rounding of the
# two masters (FSDP_SIGN_FLIP; counted as sign flips: 4 elements of rank
# 1's shard of layers/0/attn/wk read 1.99997 moves)
FSDP_SIGN_FLIP = 2.001
FSDP_ARCH = ("gemma-2b", 2)
# greedy decode steps of the FSDP case: each gathers every leaf, the 1 GB
# halves of the tied embedding twice, through gloo's host copies (4.9 s a
# step on an NVIDIA H100 80GB HBM3 at 700 W)
FSDP_STEPS = 2
FSDP_LR = 1e-4
FSDP_ADAFACTOR_RTOL = 1e-2
# kernel -> the names of its CUDA kernels in a profiler trace (substrings)
TP_KERNEL_NAMES = {
    "rmsnorm": ("rmsnorm_kernel", "rmsnorm_warp_kernel"),
    "rmsnorm_bwd": ("rmsnorm_bwd_kernel", "rmsnorm_bwd_warp_kernel", "rmsnorm_dscale_kernel"),
    "flash_attention": ("flash_f32_kernel", "flash_tc_kernel"),
    "flash_attention_bwd": ("flash_bwd_f32_kernel", "flash_bwd_tc_kernel"),
    "flash_decode": ("decode_kernel",),
    "wkv6": ("wkv6_kernel",), "wkv6_bwd": ("wkv6_bwd_",),
    "rglru": ("rglru_kernel",), "rglru_bwd": ("rglru_bwd_kernel",)}
# the dry run's cells on the card's host (dryrun_phase): fake tensors, no
# device memory; their roofline terms are analytic, from data-sheet peaks.
# (arch, shape, mesh, variant): deepseek-7b with FSDP of its dense leaves,
# and kimi-k2's cells (its config's FSDP and Adafactor) that tests/
# test_torch_dryrun.py leaves out: its train_4k cells trace in ~67 s on a
# CPU, past the tests' 60 s a cell
DRYRUN_CELLS = (("deepseek-7b", "train_4k", "multi", "baseline"),
                ("olmoe-1b-7b", "decode_32k", "single", "baseline"),
                ("deepseek-7b", "train_4k", "single", "fsdp"),
                ("kimi-k2-1t-a32b", "train_4k", "single", "baseline"),
                ("kimi-k2-1t-a32b", "train_4k", "multi", "baseline"),
                ("kimi-k2-1t-a32b", "prefill_32k", "multi", "baseline"),
                ("kimi-k2-1t-a32b", "decode_32k", "single", "baseline"))
DRYRUN_TIMEOUT_S = 400


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def free_device_memory() -> None:
    """Frees what a finished phase held on the card: a collection first (a
    trainer's runtime, hosts and shards refer to one another, so only the
    cycle collector frees them), then the allocator's cached blocks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def check_free_memory(what: str) -> None:
    """Before a full-width training run: frees what earlier work left
    unreferenced, prints the device memory still allocated and fails beyond
    LEFTOVER_BYTES, naming the run, so that a leak shows here and not as an
    out-of-memory error inside the run."""
    import torch

    free_device_memory()
    held = torch.cuda.memory_allocated()
    print(f"  device memory allocated before {what}: {held / 2**30:.3f} GiB")
    if held > LEFTOVER_BYTES:
        fail(f"{held / 2**30:.2f} GiB of device memory survive from earlier work before {what} "
             f"(limit {LEFTOVER_BYTES / 2**30:.0f} GiB)")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


TRACE_TRIES = 3  # profiler traces of a timed function before the run fails


def fn_name(fn) -> str:
    """A timed function's name and where it is defined (a lambda's line)."""
    code = getattr(fn, "__code__", None)
    where = f" at {Path(code.co_filename).name}:{code.co_firstlineno}" if code else ""
    return f"{getattr(fn, '__qualname__', repr(fn))}{where}"


MARK_CYCLES = 1_000_000  # the marker kernel's spin, ~0.6 ms


def kernel_trace(fn, calls: int):
    """One torch.profiler trace of ``calls`` calls of ``fn``: (their CUDA
    kernel events, their device us, [(kernel, events, device us)]). The
    trace makes one call more first, then launches a marker kernel
    (torch.cuda._sleep's spin kernel); only the events after the marker
    count, so kernels that a trace drops at its start fall on the extra
    call. A trace that lost the marker counts no events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = after_marker([e for e in prof.events() if e.device_type.name == "CUDA"])
    return sum(n for _, n, _ in rows), sum(us for _, _, us in rows), rows


def after_marker(device_events) -> list:
    """[(kernel, events, device us)] of the device events (torch.profiler
    FunctionEvents) that start after the trace's one marker kernel ends;
    [] when the trace does not hold exactly one marker."""
    marks = [e for e in device_events if "spin_kernel" in e.name]
    if len(marks) != 1:
        return []
    rows = {}
    for e in device_events:
        if e.time_range.start >= marks[0].time_range.end:
            n, us = rows.get(e.name, (0, 0.0))
            rows[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return [(name, n, us) for name, (n, us) in rows.items()]


def trace_complete(events: int, iters: int, k: int, device_us: float) -> bool:
    """Whether a trace of ``iters`` calls that each launch ``k`` kernels
    (counted in a trace of one call) holds every one of them: exactly
    ``iters * k`` kernel events and some device time. A trace that missed
    kernels reads a time that is too low."""
    return k > 0 and device_us > 0 and events == iters * k


def complete_trace(fn, iters: int):
    """(device us, [(kernel, events, device us)]) of a trace of ``iters``
    calls of ``fn`` that holds all their kernels (``trace_complete``): a
    trace of one call counts them, then the trace is taken; up to
    TRACE_TRIES times, after which the run fails, naming ``fn``."""
    name = fn_name(fn)
    for _ in range(TRACE_TRIES):
        k = kernel_trace(fn, 1)[0]
        events, us, rows = kernel_trace(fn, iters)
        if trace_complete(events, iters, k, us):
            return us, rows
        print(f"  trace of {name}: {events} kernel events where {iters} x {k} were launched, "
              f"{us} device us; taken again")
    fail(f"{name}: {TRACE_TRIES} torch.profiler traces missed kernels")


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: the kernels' own time in a torch.profiler trace
    of ``iters`` calls, summed and divided by ``iters``. Unlike time_ms it
    leaves out the host's launch gaps. Only a trace that holds every kernel
    of the calls counts (``complete_trace``)."""
    for _ in range(warmup):
        fn()
    us, _ = complete_trace(fn, iters)
    return us / 1e3 / iters


def device_top(fn, iters: int = 3, k: int = 6):
    """The ``k`` CUDA kernels with the most device time in a torch.profiler
    trace of ``iters`` calls of ``fn`` that holds them all: [(name, ms per
    call)]."""
    fn()
    _, rows = complete_trace(fn, iters)
    rows = [(key, us / 1e3 / iters) for key, _, us in rows if us > 0]
    return sorted(rows, key=lambda r: -r[1])[:k]


def timings(kernel, plain, library=None, iters: int = 20) -> dict:
    """A row's times: per call (CUDA events over back-to-back calls) and on
    the device alone (profiler), for the kernel and the library call, and
    per call for the plain version."""
    return dict(ms=time_ms(kernel, iters), device_ms=device_ms(kernel, iters),
                plain_ms=time_ms(plain, iters),
                library_ms=None if library is None else time_ms(library, iters),
                library_device_ms=None if library is None else device_ms(library, iters))


# kernel -> (instantiations, the tensor-core instruction each one's SASS
# must hold): the bf16 forward at 7 head dims (kimi-k2's 112 among them) and
# the bf16 backward's dK/dV and dQ kernels at 7 each on wgmma (HGMMA); the
# float32 forward and the float32 backward (its dK/dV and dQ blocks in one
# kernel) at 6 head dims each on mma.sync (HMMA: not hd 112)
TENSOR_CORE_KERNELS = {"flash_tc_kernel": (7, "HGMMA"), "flash_bwd_tc_kernel": (14, "HGMMA"),
                       "flash_f32_kernel": (6, "HMMA"), "flash_bwd_f32_kernel": (6, "HMMA")}


def sass_check(lib_path: Path) -> None:
    """The attention kernels of TENSOR_CORE_KERNELS must run on Hopper's
    tensor cores: count HGMMA / HMMA instructions in the SASS of each
    instantiation (cuobjdump on the built library) and require the
    kernel's instruction in every one."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[:500]}")
    counts = {kernel: {} for kernel in TENSOR_CORE_KERNELS}
    name = None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            kernel = next((k for k in TENSOR_CORE_KERNELS if k in fn), None)
            name = (kernel, fn) if kernel else None
            if name:
                counts[kernel][fn] = {"HGMMA": 0, "HMMA": 0}
        elif name:
            for op in ("HGMMA", "HMMA"):
                if op + "." in line:
                    counts[name[0]][name[1]][op] += 1
    for kernel, (want, op) in TENSOR_CORE_KERNELS.items():
        found = counts[kernel]
        print(f"sass: {len(found)} {kernel} instantiation(s)")
        for fn, c in found.items():
            print(f"  {fn}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}")
        if len(found) != want:
            fail(f"sass: {len(found)} {kernel} instantiations, want {want}")
        if not all(c[op] > 0 for c in found.values()):
            fail(f"a {kernel} instantiation has no {op} instruction in its SASS")


def ptxas_report(lib_path: Path, kernel: str) -> list:
    """Registers and spill bytes of each instantiation of ``kernel``, from
    the ptxas output the build keeps beside the library: printed, and
    returned as [(mangled name, registers, spill store bytes, spill load
    bytes)]."""
    name, out = None, []
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
            name = name if kernel in name else None
        elif name and "spill stores" in line:
            spills = line.strip()
            stores = int(spills.split("bytes spill stores")[0].split(",")[-1])
            loads = int(spills.split("bytes spill loads")[0].split(",")[-1])
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            print(f"ptxas: {name[:100]}: {regs} registers; {spills}")
            out.append((name, int(regs), stores, loads))
            name = None
    return out


# the rmsnorm backward's warp kernel: 1 or 2 16-byte packs a lane in bf16,
# 1, 2 or 4 in float32
RMSNORM_BWD_WARP_KERNELS = 5


def spill_check(lib_path: Path) -> None:
    """The hd-256 instantiations (``Li256E`` in the mangled name: gemma's and
    recurrentgemma's training and serve shapes) of the bf16 backward's two
    kernels and of the float32 forward and backward, the hd-64, hd-96,
    hd-112 and hd-128 ones of the bf16 backward's two kernels (the dense
    swiglu configs', phi-3-vision's and kimi-k2's training shapes), every
    instantiation of the rmsnorm backward's warp
    kernel and of the rglru backward, and the N-64 ones (``Li64E``) of the
    wkv6 backward's kernels must not spill. (``main`` prints the bf16
    forward's registers at every head dim before this check.)"""
    bwd = ptxas_report(lib_path, "flash_bwd_tc_kernel")
    checks = [("flash_bwd_tc_kernel", 2, [r for r in bwd if f"Li{hd}E" in r[0]], f"hd-{hd} ")
              for hd in (256, 64, 96, 112, 128)]
    checks += [(kernel, 1, [r for r in ptxas_report(lib_path, kernel) if "Li256E" in r[0]],
                "hd-256 ") for kernel in ("flash_f32_kernel", "flash_bwd_f32_kernel")]
    checks.append(("rmsnorm_bwd_warp_kernel", RMSNORM_BWD_WARP_KERNELS,
                   ptxas_report(lib_path, "rmsnorm_bwd_warp_kernel"), ""))
    # the wkv6 backward's kernels at N = 64 (rwkv6-1.6b): the two row
    # passes and the chunk contributions in bf16 and f32, and the scan
    for kernel, want in (("wkv6_bwd_rows_kernel", 4), ("wkv6_bwd_chunk_kernel", 2),
                         ("wkv6_bwd_scan_kernel", 1)):
        checks.append((kernel, want, [r for r in ptxas_report(lib_path, kernel)
                                      if "Li64E" in r[0]], "N-64 "))
    # the rglru backward: float32 and bf16 log_a, 16- and 4-byte copies
    checks.append(("rglru_bwd_kernel", 4, ptxas_report(lib_path, "rglru_bwd_kernel"), ""))
    for kernel, want, found, which in checks:
        if len(found) != want:
            fail(f"ptxas: {len(found)} {which}{kernel} instantiations in the log, want {want}")
        for name, regs, stores, loads in found:
            if stores or loads:
                fail(f"ptxas: {name} spills ({stores} bytes stored, {loads} loaded)")


def compare(name: str, got, want, tol) -> float:
    """max |got - want|; fails beyond atol + rtol * |want|, where ``tol`` is
    (atol, rtol) or one number for both."""
    import torch

    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel gave {got.dtype} {tuple(got.shape)}, plain "
             f"{want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    worst = float((err - rtol * w.abs()).max())
    max_err = float(err.max())
    if worst > atol:
        fail(f"{name}: max |kernel - plain| {max_err:.3g} exceeds atol {atol}, rtol {rtol}")
    print(f"  {name}: max_abs_err {max_err:.3g} (tol {tol})")
    return max_err


def exceeds(got, want, tol) -> bool:
    """Whether ``compare`` would fail ``got`` against ``want``."""
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    return float(((got.float() - want.float()).abs() - rtol * want.float().abs()).max()) > atol


def bound(nbytes: float, ops: float, dtype: str) -> dict:
    """A row's bound: the larger of its bytes over the memory rate and its
    operations over ``dtype``'s peak (``bound_rate`` names the one taken)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes * 1e3, bound_by="bytes",
                    bound_rate=f"{HBM_BYTES_PER_S / 1e12:g} TB/s")
    return dict(bound_ms=t_ops * 1e3, bound_by="operations",
                bound_rate=f"{PEAK_OPS_PER_S[dtype] / 1e12:.4g} TFLOP/s {dtype}")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def f32_launches(what: str) -> dict:
    """The launches of the float32 attention routes since the last reset,
    printed under ``what``."""
    from repro_torch.kernels import ops

    counts = ops.f32_launch_counts()
    print(f"{what}: float32 route launches {counts}")
    return counts


def row_seq(cfg) -> int:
    """The positions a ROW_ARCHS config's serve run prefills: PROMPT text
    tokens after its image tokens (none but phi-3-vision's 256)."""
    return PROMPT + cfg.num_img_tokens


def ring_kpos(B: int, W: int, pos: int, device):
    """kpos of a ring of W slots after positions 0..pos were written at
    slot p % W (the latest write wins); never-written slots are -1."""
    import torch

    s = torch.arange(W, device=device)
    latest = s + W * torch.div(pos - s, W, rounding_mode="floor")
    kp = torch.where(s <= pos, latest, torch.full_like(s, -1))
    return kp.to(torch.int32).expand(B, W).contiguous()


def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    cfg = get_arch(ARCH)
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, S = BATCH, PROMPT
    bf = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    rows = []

    # -- rmsnorm: (B*S, d) rows, as in every prefill norm --------------------
    print("kernel rmsnorm")
    x, scale = randn(B * S, d), randn(d, dtype=torch.float32)
    err = compare("rmsnorm bf16 (2048, 2048)", rn.rmsnorm(x, scale), rn.rmsnorm_ref(x, scale),
                  TOL["bfloat16"])
    xf, sf = randn(37, 100, dtype=torch.float32), randn(100, dtype=torch.float32)
    compare("rmsnorm f32 (37, 100) unvectorised", rn.rmsnorm(xf, sf), rn.rmsnorm_ref(xf, sf),
            TOL["float32"])
    xd = randn(B, 1, d)
    compare("rmsnorm bf16 decode (4, 1, 2048)", rn.rmsnorm(xd, scale), rn.rmsnorm_ref(xd, scale),
            TOL["bfloat16"])
    for shape in ((16, 4096), (B, 1, 4096)):  # recurrentgemma-9b's / deepseek-7b's width
        xr_, sr_ = randn(*shape), randn(4096, dtype=torch.float32)
        compare(f"rmsnorm bf16 {shape}", rn.rmsnorm(xr_, sr_), rn.rmsnorm_ref(xr_, sr_),
                TOL["bfloat16"])
    # timed: gemma-2b's width, deepseek-7b's (recurrentgemma-9b's too) and
    # kimi-k2's 7168 (28 x 256: the block-per-row kernel, not the warp kernel)
    timed = [(x, scale, err, f"x ({B * S}, {d}) bf16")]
    for arch in ("deepseek-7b", KIMI):
        dw = get_arch(arch).d_model
        xw, sw = randn(B * S, dw), randn(dw, dtype=torch.float32)
        err_w = compare(f"rmsnorm bf16 ({B * S}, {dw})", rn.rmsnorm(xw, sw),
                        rn.rmsnorm_ref(xw, sw), TOL["bfloat16"])
        timed.append((xw, sw, err_w, f"x ({B * S}, {dw}) bf16 ({arch})"))
    for xn, sn, e, label in timed:
        bnd = bound(2 * nbytes(xn) + nbytes(sn), 4 * xn.numel(), "float32")
        w16 = sn.to(bf)
        rows.append(dict(
            name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:27", shape=label, max_abs_err=e, **bnd,
            **timings(lambda: rn.rmsnorm(xn, sn), lambda: rn.rmsnorm_ref(xn, sn),
                      lambda: F.rms_norm(xn, (xn.shape[-1],), weight=w16, eps=1e-6)),
        ))

    # -- flash_attention: prefill, q/k/v as transposed (B, S, h, hd) views ---
    print("kernel flash_attention")

    def qkv(B_, S_, H_, K_, hd_, dtype=bf):
        q5, k5, v5 = randn(B_, S_, H_, hd_, dtype=dtype), randn(B_, S_, K_, hd_, dtype=dtype), \
            randn(B_, S_, K_, hd_, dtype=dtype)
        return q5.transpose(1, 2), k5.transpose(1, 2), v5.transpose(1, 2)

    q, k, v = qkv(B, S, H, K, hd)
    err = compare("flash_attention bf16 causal (4,8,512,256)/(4,1,512,256)",
                  fa.flash_attention(q, k, v), fa.flash_attention_ref(q, k, v), TOL["bfloat16"])
    qr, kr, vr = qkv(2, 300, H, K, hd)
    compare("flash_attention bf16 causal ragged S=300", fa.flash_attention(qr, kr, vr),
            fa.flash_attention_ref(qr, kr, vr), TOL["bfloat16"])
    compare("flash_attention bf16 window 128", fa.flash_attention(q, k, v, window=128),
            fa.flash_attention_ref(q, k, v, window=128), TOL["bfloat16"])

    def f32_case(label, q_, k_, v_, **kw):
        """The float32 kernel (3xTF32) and its lse against the plain
        version; two calls must give the same bits."""
        out, lse = fa.flash_attention(q_, k_, v_, return_lse=True, **kw)
        ref, lse_ref = fa.flash_attention_ref(q_, k_, v_, return_lse=True, **kw)
        err = compare(f"flash_attention f32 {label}", out, ref, TOL["float32"])
        compare(f"flash_attention f32 lse {label}", lse, lse_ref, LSE_TOL)
        if not torch.equal(fa.flash_attention(q_, k_, v_, **kw), out):
            fail(f"flash_attention f32 {label}: two calls on the same inputs differ")
        return err

    qf, kf, vf = qkv(1, 200, 4, 2, 64, dtype=torch.float32)
    f32_case("causal GQA (1,4,200,64)/(1,2,200,64)", qf, kf, vf)
    f32_case("window 48", qf, kf, vf, window=48)
    f32_case("hd 256 window 128 GQA g 2 (2,4,300)", *qkv(2, 300, 4, 2, 256, dtype=torch.float32),
             window=128)
    # a base one element off 16 bytes: the wrapper copies q, the same kernel runs
    qo = randn(1 * 200 * 4 * 64 + 1, dtype=torch.float32)[1:].view(1, 200, 4, 64).transpose(1, 2)
    f32_case("q base one element off (1,4,200,64)", qo, kf, vf)
    for hd_ in fa.HEAD_DIMS[:-1]:  # the other instantiations of both routes, ragged S = 200
        qh, kh, vh = qkv(1, 200, 4, 2, hd_)
        compare(f"flash_attention bf16 GQA hd {hd_} (1,4,200)/(1,2,200) window 80",
                fa.flash_attention(qh, kh, vh, window=80),
                fa.flash_attention_ref(qh, kh, vh, window=80), TOL["bfloat16"])
        if hd_ in fa.F32_HEAD_DIMS:
            f32_case(f"GQA hd {hd_} (1,4,200)/(1,2,200) window 80",
                     *qkv(1, 200, 4, 2, hd_, dtype=torch.float32), window=80)
    f32_refused(qkv)
    pairs = S * (S + 1) // 2  # causal (query, key) pairs per (b, h)
    bnd = bound(2 * nbytes(q) + nbytes(k, v), 4 * hd * pairs * B * H, "bfloat16")
    rows.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:75",
        shape="q (4,8,512,256), k/v (4,1,512,256) bf16, causal", max_abs_err=err,
        **bnd,
        **timings(lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_ref(q, k, v),
                  lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                         enable_gqa=True)),
    ))
    # recurrentgemma-9b's attn_local layers: 16 query heads on one KV head,
    # window 2048 = S, so every causal pair is in the window
    rg = get_arch("recurrentgemma-9b")
    Sg, Hg = rg.window, rg.n_heads
    qg, kg, vg = qkv(B, Sg, Hg, rg.n_kv_heads, rg.resolved_head_dim)
    err = compare(f"flash_attention bf16 window {Sg} (4,16,2048,256)/(4,1,2048,256)",
                  fa.flash_attention(qg, kg, vg, window=Sg),
                  fa.flash_attention_ref(qg, kg, vg, window=Sg), TOL["bfloat16"])
    pairs = Sg * (Sg + 1) // 2
    bnd = bound(2 * nbytes(qg) + nbytes(kg, vg), 4 * rg.resolved_head_dim * pairs * B * Hg,
                "bfloat16")
    rows.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:75",
        shape="q (4,16,2048,256), k/v (4,1,2048,256) bf16, causal, window 2048",
        max_abs_err=err, **bnd,
        **timings(lambda: fa.flash_attention(qg, kg, vg, window=Sg),
                  lambda: fa.flash_attention_ref(qg, kg, vg, window=Sg),
                  lambda: F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                         enable_gqa=True), iters=5),
    ))
    del qg, kg, vg
    # the dense swiglu configs', olmoe's and phi-3-vision's prefill: batch
    # 4, prompt 512 (phi-3-vision: 768 with its image tokens), causal, bf16
    # (deepseek-7b MHA at hd 128, granite-3-2b g 4 at hd 64, qwen2.5-3b g 8
    # at hd 128, olmoe-1b-7b MHA 16 heads at hd 128, phi-3-vision MHA at hd 96)
    t0_s = time.perf_counter()
    for arch in ROW_ARCHS:
        c = get_arch(arch)
        Hc, Kc, hdc, Sa = c.n_heads, c.n_kv_heads, c.resolved_head_dim, row_seq(c)
        qa, ka, va = qkv(B, Sa, Hc, Kc, hdc)
        label = f"q ({B},{Hc},{Sa},{hdc}), k/v ({B},{Kc},{Sa},{hdc}) bf16, causal ({arch})"
        err = compare(f"flash_attention {label}", fa.flash_attention(qa, ka, va),
                      fa.flash_attention_ref(qa, ka, va), TOL["bfloat16"])
        if not torch.equal(fa.flash_attention(qa, ka, va), fa.flash_attention(qa, ka, va)):
            fail(f"flash_attention {label}: two calls on the same inputs differ")
        bnd = bound(2 * nbytes(qa) + nbytes(ka, va), 4 * hdc * Sa * (Sa + 1) // 2 * B * Hc,
                    "bfloat16")
        rows.append(dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:75", shape=label, max_abs_err=err,
            **bnd,
            **timings(lambda: fa.flash_attention(qa, ka, va),
                      lambda: fa.flash_attention_ref(qa, ka, va),
                      lambda: F.scaled_dot_product_attention(qa, ka, va, is_causal=True,
                                                             enable_gqa=True)),
        ))
        del qa, ka, va
    print(f"  the dense configs', olmoe's and phi-3-vision's flash_attention rows: "
          f"{time.perf_counter() - t0_s:.1f} s")
    # the train_llm surface at gemma-2b's width (heads = KV heads),
    # gemma-2b's serve shape and phi-3-vision's, in float32
    vc = get_arch(VISION_ARCH)
    Sv, Hv, hdv = row_seq(vc), vc.n_heads, vc.resolved_head_dim
    for label, (B_, S_, H_, K_, hd_) in (
            ("q, k/v (8,8,2048,256) f32, causal (train_llm surface)", (8, 2048, H, H, hd)),
            (f"q (4,{H},512,{hd}), k/v (4,{K},512,{hd}) f32, causal", (B, S, H, K, hd)),
            (f"q, k/v (4,{Hv},{Sv},{hdv}) f32, causal ({VISION_ARCH})",
             (B, Sv, Hv, vc.n_kv_heads, hdv))):
        q32, k32, v32 = qkv(B_, S_, H_, K_, hd_, dtype=torch.float32)
        err = f32_case(label, q32, k32, v32)
        pairs = S_ * (S_ + 1) // 2
        bnd = bound(2 * nbytes(q32) + nbytes(k32, v32), 4 * hd_ * pairs * B_ * H_,
                    "float32 3xTF32")
        rows.append(dict(
            name="flash_attention", route="cuda", f32_route=True,
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:75", shape=label, max_abs_err=err,
            **bnd,
            **timings(lambda: fa.flash_attention(q32, k32, v32),
                      lambda: fa.flash_attention_ref(q32, k32, v32),
                      lambda: F.scaled_dot_product_attention(q32, k32, v32, is_causal=True,
                                                             enable_gqa=True), iters=10),
        ))
        del q32, k32, v32
    rows += backward_rows(dev, randn, qkv)

    # -- flash_decode: the model's (B, W, n, hd) cache read as a view --------
    decode_cases(dev, randn)
    rows += decode_rows(dev, randn)
    int8_dequantize_timing(dev, randn, rows)
    rows += whisper_rows(dev, randn)
    rows += cross_backward_rows(dev, randn)
    rows.append(wkv6_row(randn, dev))
    rows.append(wkv6_bwd_row(randn, dev))
    rows += rglru_row(randn, dev)
    rows += rglru_bwd_rows(randn, dev)
    def fmt(t):
        return "none" if t is None else f"{t:.5f}"

    for r in rows:
        print(f"  {r['name']} {r['shape']}: {r['ms']:.5f} ms per call, {fmt(r['device_ms'])} on "
              f"the device (plain {r['plain_ms']:.4f}; library {fmt(r['library_ms'])} per call, "
              f"{fmt(r['library_device_ms'])} on the device; bound {r['bound_ms']:.5f} by "
              f"{r['bound_by']} at {r['bound_rate']})")
    return rows


def attention_bwd_f64(q, k, v, o, dout, lse, *, causal: bool = True, window: int = 0):
    """The plain backward's formulas (``flash_attention_bwd_ref``) in
    float64 on the card, one batch row at a time: the yardstick that tells
    the kernel's rounding from the float32 plain version's. (dq, dk, dv)
    in float64; k / v may hold their own number of keys Sk (not causal)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    B, H, S, hd = q.shape
    g, Sk = H // k.shape[1], k.shape[2]
    f64 = torch.float64
    mask = fa._mask(S, causal, window, q.device, Sk)
    out = ([], [], [])
    for b in range(B):
        qf, of, gf, lf = (t[b].to(f64) for t in (q, o, dout, lse))
        kk = torch.repeat_interleave(k[b], g, dim=0).to(f64)
        vv = torch.repeat_interleave(v[b], g, dim=0).to(f64)
        s = torch.einsum("hqd,hkd->hqk", qf, kk) / math.sqrt(hd)
        p = torch.where(mask, torch.exp(s - lf[..., None]), torch.zeros((), dtype=f64,
                                                                        device=q.device))
        del s
        dv = torch.einsum("hqk,hqd->hkd", p, gf)
        dp = torch.einsum("hqd,hkd->hqk", gf, vv)
        ds = p * (dp - torch.sum(gf * of, dim=-1, keepdim=True))
        del p, dp
        dq = torch.einsum("hqk,hkd->hqd", ds, kk) / math.sqrt(hd)
        dk = torch.einsum("hqk,hqd->hkd", ds, qf) / math.sqrt(hd)
        for acc, t in zip(out, (dq, dk.reshape(-1, g, Sk, hd).sum(dim=1),
                                dv.reshape(-1, g, Sk, hd).sum(dim=1))):
            acc.append(t)
    return tuple(torch.stack(t) for t in out)


def backward_rows(dev, randn, qkv):
    """The two backward kernels against their plain versions on the same
    inputs, at the training path's shapes, timed beside the library's
    autograd backward: rmsnorm at (2048, 2048) bf16 and f32, plus wider,
    ragged and misaligned cases; flash attention at gemma-2b's shape (bf16,
    causal), recurrentgemma-9b's window shape, a float32 shape and
    gemma-2b's shape in float32, plus the train_llm surface's shape in
    float32 (untimed) and ragged / GQA / head-dim / misaligned-dout cases.
    Also the forward's lse against the plain log-sum-exp."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    cfg = get_arch(ARCH)
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rows = []
    print("kernel rmsnorm_bwd")

    def norm_case(label, x, dy, scale):
        """rmsnorm_bwd against its plain version: dx at the dtype's
        tolerance, dscale at float32's; two calls must give the same bits.
        Returns the max |kernel - plain| of dx."""
        name = "bf16" if x.dtype == torch.bfloat16 else "f32"
        split = rn.bwd_warp_split(x.shape[-1], x.element_size())
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, scale))
        route = f"warp kernel, packs a lane / warps a row {split}" if split and aligned \
            else "block kernel"
        got, want = rn.rmsnorm_bwd(x, scale, dy), rn.rmsnorm_bwd_ref(x, scale, dy)
        err = compare(f"rmsnorm_bwd dx {name} {label} ({route})", got[0], want[0],
                      BWD_TOL[str(x.dtype)[6:]])
        compare(f"rmsnorm_bwd dscale {name} {label}", got[1], want[1], BWD_TOL["float32"])
        again = rn.rmsnorm_bwd(x, scale, dy)
        if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
            fail(f"rmsnorm_bwd {name} {label}: two calls on the same inputs differ")
        return err

    # timed: gemma-2b's width in bf16 and float32, deepseek-7b's and
    # kimi-k2's in bf16 (7168: 28 warps a row, more than the warp kernel's
    # BWD_MAX_WARPS, so the block kernel)
    dw, dk = get_arch("deepseek-7b").d_model, get_arch(KIMI).d_model
    for width, dt, arch in ((d, torch.bfloat16, ""), (d, torch.float32, ""),
                            (dw, torch.bfloat16, " (deepseek-7b)"),
                            (dk, torch.bfloat16, f" ({KIMI})")):
        name = "bf16" if dt == torch.bfloat16 else "f32"
        x, dy, scale = randn(BATCH * PROMPT, width, dtype=dt), \
            randn(BATCH * PROMPT, width, dtype=dt), randn(width, dtype=torch.float32)
        label = f"({BATCH * PROMPT}, {width})"
        err = norm_case(label, x, dy, scale)
        split = [(n.replace("void (anonymous namespace)::", "")[:48], round(ms, 5)) for n, ms in
                 device_top(lambda: rn.rmsnorm_bwd(x, scale, dy))]
        print(f"  rmsnorm_bwd {name} {label}: device ms by kernel {split}")
        bnd = bound(3 * nbytes(x) + 2 * nbytes(scale), 10 * x.numel(), "float32")
        xg, wg = x.clone().requires_grad_(), scale.to(dt).requires_grad_()
        yg = F.rms_norm(xg, (width,), weight=wg, eps=1e-6)
        rows.append(dict(
            name="rmsnorm_bwd", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:27 (its gradient: jax.grad of the jnp norm)",
            shape=f"x, dy {label} {name}{arch}", max_abs_err=err, **bnd,
            **timings(lambda: rn.rmsnorm_bwd(x, scale, dy), lambda: rn.rmsnorm_bwd_ref(x, scale, dy),
                      lambda: torch.autograd.grad(yg, (xg, wg), dy, retain_graph=True)),
        ))
    # recurrentgemma-9b's / deepseek-7b's width in float32 (a row over eight
    # warps), a last block and slot partly empty (2049 rows), rows over six and three
    # warps (phi-3-vision's width 3072; 384 in float32), widths the warp
    # kernel does not take (100; 8192: sixteen warps) and a base one element
    # off 16 bytes (the block kernel), ragged float32 widths, one block, many
    # blocks
    cases = [("(2048, 4096)", (2048, 4096), torch.float32)]
    cases += [("(2049, 2048)", (2049, 2048), dt) for dt in (torch.bfloat16, torch.float32)]
    cases += [("(300, 3072)", (300, 3072), torch.bfloat16), ("(37, 384)", (37, 384), torch.float32)]
    cases += [("(64, 100)", (64, 100), torch.bfloat16), ("(16, 8192)", (16, 8192), torch.bfloat16)]
    cases += [(str(shape), shape, torch.float32) for shape in ((37, 100), (3, 5, 4096), (1, 64))]
    for label, shape, dt in cases:
        norm_case(label, randn(*shape, dtype=dt), randn(*shape, dtype=dt),
                  randn(shape[-1], dtype=torch.float32))
    xo = randn(64 * d + 1)[1:].view(64, d)
    norm_case("(64, 2048) x base one element off", xo, randn(64, d), randn(d, dtype=torch.float32))

    print("kernel flash_attention_bwd")
    rg = get_arch("recurrentgemma-9b")

    def case(label, B_, S_, H_, K_, hd_, dtype=torch.bfloat16, window=0, causal=True,
             row=False, iters=20, dout_offset=0, f64=False):
        q, k, v = qkv(B_, S_, H_, K_, hd_, dtype=dtype)
        out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
        _, lse_ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                            return_lse=True)
        compare(f"flash_attention lse {label}", lse, lse_ref, LSE_TOL)
        # dout_offset: a view whose base is that many elements off 16 bytes
        n = B_ * S_ * H_ * hd_
        dout = randn(n + dout_offset, dtype=dtype)[dout_offset:].view(B_, S_, H_, hd_)
        dout = dout.transpose(1, 2)
        args = (q, k, v, out, dout, lse)
        got = fa.flash_attention_bwd(*args, causal=causal, window=window)
        want = fa.flash_attention_bwd_ref(*args, causal=causal, window=window)
        tol = BWD_TOL[str(dtype)[6:]]
        errs = [compare(f"flash_attention_bwd {n} {label}", a, b, tol)
                for n, a, b in zip(("dq", "dk", "dv"), got, want)]
        again = fa.flash_attention_bwd(*args, causal=causal, window=window)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            fail(f"flash_attention_bwd {label}: two calls on the same inputs differ")
        if f64:  # whose rounding: the kernel's and the plain version's error in float64
            exact = attention_bwd_f64(*args, causal=causal, window=window)
            for n, a, b, e in zip(("dq", "dk", "dv"), got, want, exact):
                print(f"  flash_attention_bwd {n} {label}: max |kernel - float64| "
                      f"{float((a.double() - e).abs().max()):.3g}, max |plain - float64| "
                      f"{float((b.double() - e).abs().max()):.3g}, max |float64| "
                      f"{float(e.abs().max()):.3g}")
            del exact
        del want, again
        if not row:
            return
        vis = fa._mask(S_, causal, window, dev).sum().item()  # visible (query, key) pairs
        pk = "bfloat16" if dtype == torch.bfloat16 else "float32 3xTF32"
        # the function's own traffic: each input read once, each output written once
        bnd = bound(nbytes(q, k, v, out, dout, lse, *got), 10 * hd_ * vis * B_ * H_, pk)
        split = [(n.replace("void (anonymous namespace)::", "")[:36], round(ms, 5)) for n, ms in
                 device_top(lambda: fa.flash_attention_bwd(*args, causal=causal, window=window))]
        print(f"  flash_attention_bwd {label}: device ms by kernel {split}")
        if dtype == torch.bfloat16:  # a cost of the design, not of the function: not in the bound
            scratch = 2 * 2 * B_ * H_ * S_ * hd_ * 4  # float32 dK/dV partials, written and read
            print(f"  flash_attention_bwd {label}: per-head partials {scratch / 1e6:.1f} MB "
                  f"round trip, {scratch / HBM_BYTES_PER_S * 1e3:.5f} ms at the memory rate")
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=True)
        rows.append(dict(
            name="flash_attention_bwd", route="cuda", f32_route=dtype == torch.float32,
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/flash_attention.py:75 (its gradient: jax.grad of "
                     "the jnp attention)",
            shape=label, max_abs_err=max(errs), **bnd,
            **timings(lambda: fa.flash_attention_bwd(*args, causal=causal, window=window),
                      lambda: fa.flash_attention_bwd_ref(*args, causal=causal, window=window),
                      lambda: torch.autograd.grad(og, (qg, kg, vg), dout, retain_graph=True),
                      iters=iters),
        ))

    case(f"q (4,{H},512,{hd}), k/v (4,{K},512,{hd}) bf16, causal", BATCH, PROMPT, H, K, hd,
         row=True)
    case(f"q (4,{rg.n_heads},{rg.window},256), k/v (4,1,{rg.window},256) bf16, causal, window "
         f"{rg.window}", BATCH, rg.window, rg.n_heads, rg.n_kv_heads, rg.resolved_head_dim,
         window=rg.window, row=True, iters=3)
    # MHA at hd 128, g 4 at hd 64, g 8 at hd 128, MHA 16 x 128, MHA 32 x 96
    # over 768 positions (phi-3-vision's image tokens and its 512 text tokens)
    for arch in ROW_ARCHS:
        c = get_arch(arch)
        Hc, Kc, hdc, Sa = c.n_heads, c.n_kv_heads, c.resolved_head_dim, row_seq(c)
        case(f"q (4,{Hc},{Sa},{hdc}), k/v (4,{Kc},{Sa},{hdc}) bf16, causal ({arch})", BATCH,
             Sa, Hc, Kc, hdc, row=True)
    vc = get_arch(VISION_ARCH)
    Sv, Hv, hdv = row_seq(vc), vc.n_heads, vc.resolved_head_dim
    case(f"q, k/v (4,{Hv},{Sv},{hdv}) f32, causal ({VISION_ARCH})", BATCH, Sv, Hv,
         vc.n_kv_heads, hdv, dtype=torch.float32, row=True, iters=10)
    case("q (2,4,512,64), k/v (2,2,512,64) f32, causal", 2, 512, 4, 2, 64,
         dtype=torch.float32, row=True)
    case(f"q (4,{H},512,{hd}), k/v (4,{K},512,{hd}) f32, causal", BATCH, PROMPT, H, K, hd,
         dtype=torch.float32, row=True, iters=10)
    # the train_llm surface's shape (8, 8, 2048, 256): a dK / dV row sums up
    # to 2048 queries (512 a head at gemma-2b's shape); held, not timed (the
    # plain version's four score matrices are 4.3 GB)
    case("f32 causal (8,8,2048,256) (train_llm surface)", 8, 2048, H, H, hd,
         dtype=torch.float32, f64=True)
    torch.cuda.empty_cache()
    case("bf16 window 128 (4,8,512,256)", BATCH, PROMPT, H, K, hd, window=128)
    case("bf16 ragged S=300 g 8", 2, 300, H, K, hd)
    case("f32 window 48 GQA g 2 (1,4,200,64)", 1, 200, 4, 2, 64, dtype=torch.float32, window=48)
    case("bf16 window 48 GQA g 2 (1,4,200,64)", 1, 200, 4, 2, 64, window=48)
    case("f32 not causal (1,2,100,32)", 1, 100, 2, 2, 32, dtype=torch.float32, causal=False)
    case("f32 hd 256 window 128 GQA g 2 (2,4,300)", 2, 300, 4, 2, 256, dtype=torch.float32,
         window=128)
    case("f32 not causal, window 40, g 1 (1,2,130,256)", 1, 130, 2, 2, 256, dtype=torch.float32,
         causal=False, window=40)
    case("f32 dout base one element off (1,4,200,64)/(1,2,200,64)", 1, 200, 4, 2, 64,
         dtype=torch.float32, dout_offset=1)
    case("bf16 not causal (1,2,100,64)", 1, 100, 2, 2, 64, causal=False)
    case("bf16 not causal, window 40, GQA g 2 (2,4,300,256)", 2, 300, 4, 2, 256, causal=False,
         window=40)
    for hd_ in fa.HEAD_DIMS[:-1]:
        case(f"bf16 hd {hd_} g 4 (1,4,200) window 80", 1, 200, 4, 1, hd_, window=80)
        if hd_ in fa.F32_HEAD_DIMS:
            case(f"f32 hd {hd_} g 1 (2,2,77)", 2, 77, 2, 2, hd_, dtype=torch.float32)
    return rows


def f32_refused(qkv) -> None:
    """At a head dim the float32 routes lack (kimi-k2's 112), the float32
    forward and backward raise ValueError on CUDA tensors and launch
    nothing: no plain version stands in for them."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    for hd_ in sorted(set(fa.HEAD_DIMS) - set(fa.F32_HEAD_DIMS)):
        q, k, v = qkv(1, 64, 2, 1, hd_, dtype=torch.float32)
        lse = torch.zeros((1, 2, 64), device=q.device)
        before = ops.launch_counts()
        for name, call in (("flash_attention", lambda: fa.flash_attention(q, k, v)),
                           ("flash_attention_bwd",
                            lambda: fa.flash_attention_bwd(q, k, v, q, q, lse)),
                           ("ops.flash_attention",
                            lambda: ops.flash_attention(q, k, v))):
            try:
                call()
            except ValueError as e:
                print(f"  {name} float32 hd {hd_}: raises ValueError ({str(e)[:80]}...)")
            else:
                fail(f"{name} float32 hd {hd_}: no ValueError; the float32 route has no "
                     f"hd {hd_}")
        if ops.launch_counts() != before:
            fail(f"float32 hd {hd_}: a refused call launched a kernel")


def decode_cases(dev, randn):
    """flash_decode against its plain version off the two timed shapes:
    ragged, windowed, wrapped, empty and float32 caches; and the grid at
    gemma-2b's shape fills the card."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da

    print("kernel flash_decode")
    cfg = get_arch(ARCH)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, W = BATCH, PROMPT + NEW
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, n_chunks = da.decode_plan(W, B * K, sms)
    grid = -(-n_chunks // da.CLUSTER) * da.CLUSTER * B * K
    print(f"  flash_decode grid at gemma-2b's shape: {n_chunks} chunks of {chunk} slots x "
          f"{B * K} rows = {n_chunks * B * K} blocks ({grid} with the cluster padding) on "
          f"{sms} SMs")
    if n_chunks * B * K < sms:
        fail(f"flash_decode: {n_chunks * B * K} blocks at gemma-2b's shape, fewer than {sms} SMs")
    pos = PROMPT + 3
    kc, vc = randn(B, W, K, hd).transpose(1, 2), randn(B, W, K, hd).transpose(1, 2)
    kpos = ring_kpos(B, W, pos, dev)
    qd = randn(B, 1, H, hd)[:, 0]

    def check(name, q, k, v, kp, p, tol=DECODE_TOL_BF16, window=0, calls=1):
        """``calls`` back-to-back calls, each held against the plain version:
        every call reuses the counters and scratch of the one before."""
        want = da.flash_decode_ref(q, k, v, kp, p, window=window)
        got = [da.flash_decode(q, k, v, kp, p, window=window) for _ in range(calls)]
        bad = [o for o in got if exceeds(o, want, tol)]
        compare(f"flash_decode {name}" + (f", {calls} calls" if calls > 1 else ""),
                (bad or got)[0], want, tol)

    check("bf16 window 128", qd, kc, vc, kpos, pos, window=128)
    check("bf16 window 40 (whole chunks empty)", qd, kc, vc, kpos, pos, window=40)
    kring = ring_kpos(B, 128, 700, dev)  # wrapped ring of 128 slots
    check("bf16 wrapped ring W=128", qd, kc[:, :, :128], vc[:, :, :128], kring, 700)
    check("bf16 wrapped ring W=128 window 24", qd, kc[:, :, :128], vc[:, :, :128], kring, 700,
          window=24)
    check("bf16 ragged cache 300", qd, kc[:, :, :300], vc[:, :, :300], kpos[:, :300], 299)
    empty_row = kpos.clone()
    empty_row[1] = -1  # batch row 1 has no valid slot: the mean of V
    check("bf16 batch row 1 with no valid slot", qd, kc, vc, empty_row, pos)
    qf = randn(2, 4, 64, dtype=torch.float32)
    kf = randn(2, 200, 2, 64, dtype=torch.float32).transpose(1, 2)
    vf = randn(2, 200, 2, 64, dtype=torch.float32).transpose(1, 2)
    kpf = ring_kpos(2, 200, 150, dev)
    check("f32 GQA (2,4,64) cache 200", qf, kf, vf, kpf, 150, DECODE_TOL_F32)
    check("f32 no valid slot in any row", qf, kf, vf, torch.full_like(kpf, -1), 150,
          DECODE_TOL_F32)
    for hd_ in da.HEAD_DIMS[:-1]:  # the other bf16 head dims, 16 heads on one KV head
        qh, kh, vh = randn(2, 16, hd_), randn(2, 1, 100, hd_), randn(2, 1, 100, hd_)
        check(f"bf16 (2,16,{hd_}) cache 100 window 50", qh, kh, vh, ring_kpos(2, 100, 130, dev),
              130, window=50)
    # groups that are not a multiple of the cluster size, over several
    # clusters: a rank's column slice then starts inside a head
    for B_, H_, K_, S_, hd_, dt in ((4, 4, 4, 600, 64, torch.bfloat16),
                                    (2, 4, 2, 1000, 128, torch.bfloat16),
                                    (2, 4, 2, 1000, 128, torch.float32),
                                    (4, 4, 1, 300, 16, torch.bfloat16)):
        _, n_ = da.decode_plan(S_, B_ * K_, sms)
        qg = randn(B_, H_, hd_, dtype=dt)
        kg_, vg_ = (randn(B_, S_, K_, hd_, dtype=dt).transpose(1, 2) for _ in range(2))
        check(f"{'bf16' if dt == torch.bfloat16 else 'f32'} g {H_ // K_} ({B_},{H_},{hd_}) "
              f"cache {S_}, {-(-n_ // da.CLUSTER)} clusters", qg, kg_, vg_,
              ring_kpos(B_, S_, S_ + 7, dev), S_ + 7,
              DECODE_TOL_BF16 if dt == torch.bfloat16 else DECODE_TOL_F32, calls=20)
    # two streams at once: each has its own counters and scratch
    side = torch.cuda.Stream(dev)
    want = da.flash_decode_ref(qd, kc, vc, kpos, pos)
    side.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for _ in range(10):
        outs.append(da.flash_decode(qd, kc, vc, kpos, pos))
        with torch.cuda.stream(side):
            outs.append(da.flash_decode(qd, kc, vc, kpos, pos))
    torch.cuda.current_stream(dev).wait_stream(side)
    worst = max(float((o.float() - want.float()).abs().max()) for o in outs)
    if any(exceeds(o, want, DECODE_TOL_BF16) for o in outs):
        fail(f"flash_decode on two streams at once: max |kernel - plain| {worst:.3g}")
    print(f"  flash_decode bf16 on two streams at once, 20 calls: max_abs_err {worst:.3g} "
          f"(tol {DECODE_TOL_BF16})")


def decode_rows(dev, randn):
    """flash_decode at the decode shapes of the serve runs, against its
    plain version, timed beside masked SDPA: gemma-2b (8 heads on one KV
    head, cache 544, 516 valid), recurrentgemma-9b (16 heads on one KV
    head, a full 2048-slot ring, window 2048), the dense swiglu configs
    and olmoe over their 544-slot caches (deepseek-7b 32 heads on 32 KV
    heads of 128, granite-3-2b 32 on 8 of 64, qwen2.5-3b 16 on 2 of 128,
    olmoe-1b-7b 16 on 16 of 128), phi-3-vision over its 800 (32 on 32 of
    96)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da

    rows = []
    cases = [(ARCH, PROMPT + NEW, PROMPT + 3, 0), ("recurrentgemma-9b", 2048, 2048 + 3, 2048)]
    cases += [(arch, row_seq(get_arch(arch)) + NEW, row_seq(get_arch(arch)) + 3, 0)
              for arch in ROW_ARCHS]
    for arch, W, pos, window in cases:
        cfg = get_arch(arch)
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        assert not window or window == cfg.window
        kc, vc = randn(BATCH, W, K, hd).transpose(1, 2), randn(BATCH, W, K, hd).transpose(1, 2)
        kpos = ring_kpos(BATCH, W, pos, dev)
        qd = randn(BATCH, H, hd)
        valid = (kpos >= 0) & (kpos <= pos)
        if window:
            valid &= kpos > pos - window
        n_valid = int(valid.sum())  # (row, slot) pairs the data needs
        shape = f"q ({BATCH},{H},{hd}) bf16, cache {W} slots, {n_valid // BATCH} valid" + (
            f", window {window}" if window else "") + f" ({arch})"
        want = da.flash_decode_ref(qd, kc, vc, kpos, pos, window=window)
        out = da.flash_decode(qd, kc, vc, kpos, pos, window=window)
        err = compare(f"flash_decode {shape}", out, want, DECODE_TOL_BF16)
        if not torch.equal(da.flash_decode(qd, kc, vc, kpos, pos, window=window), out):
            fail(f"flash_decode {shape}: two calls on the same inputs differ")
        # what the limit would see: the plain version with one chunk of valid
        # slots dropped (the rule's chunk at this shape, the first one)
        chunk, _ = da.decode_plan(W, BATCH * K, torch.cuda.get_device_properties(dev)
                                  .multi_processor_count)
        s0 = 0
        if not bool(valid[:, s0:s0 + chunk].all()):
            fail(f"flash_decode {shape}: the chunk at slot {s0} is not all valid")
        dropped = kpos.clone()
        dropped[:, s0:s0 + chunk] = -1
        drop = da.flash_decode_ref(qd, kc, vc, dropped, pos, window=window)
        drop_err = float((drop.float() - want.float()).abs().max())
        print(f"  a dropped chunk of {chunk} slots ({s0}..{s0 + chunk - 1}) reads max_abs_err "
              f"{drop_err:.3g} against the limit {DECODE_TOL_BF16}")
        if not exceeds(drop, want, DECODE_TOL_BF16):
            fail(f"flash_decode {shape}: a dropped chunk stays inside {DECODE_TOL_BF16}")
        bnd = bound(2 * nbytes(qd) + 2 * n_valid * K * hd * kc.element_size()
                           + nbytes(kpos), 4 * hd * H * n_valid, "bfloat16")
        mask, q4 = valid[:, None, None, :], qd[:, :, None]
        rows.append(dict(
            name="flash_decode", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:60", shape=shape, max_abs_err=err,
            **bnd,
            **timings(lambda: da.flash_decode(qd, kc, vc, kpos, pos, window=window),
                      lambda: da.flash_decode_ref(qd, kc, vc, kpos, pos, window=window),
                      lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                                             enable_gqa=True)),
        ))
    return rows


def int8_dequantize_timing(dev, randn, rows) -> None:
    """An int8 cache's dequantize (``models.layers._dequantize_kv``, plain
    torch: no Pallas kernel computes it) of k and v at ARCH's decode shape
    (BATCH x 544 slots, its one KV head of 256), as a decode step runs it
    before flash_decode in every layer: per call and on the device, beside
    the bf16 flash_decode row of the same shape, with its bound (the int8
    values and float16 scales read once, the bf16 cache written once)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.layers import _dequantize_kv

    cfg = get_arch(ARCH)
    W, K, hd = PROMPT + NEW, cfg.n_kv_heads, cfg.resolved_head_dim
    q8 = [randn(BATCH, W, K, hd, dtype=torch.float32).mul_(40).round_().clamp_(-127, 127)
          .to(torch.int8) for _ in range(2)]
    sc = [randn(BATCH, W, K, dtype=torch.float32).abs().mul_(0.01).to(torch.float16)
          for _ in range(2)]

    def deq():
        return [_dequantize_kv(q, s_, torch.bfloat16) for q, s_ in zip(q8, sc)]

    out = deq()
    for o, q, s_ in zip(out, q8, sc):  # the arithmetic, element by element
        if not torch.equal(o, (q.float() * s_.float()[..., None]).to(torch.bfloat16)):
            fail("int8 dequantize: not q * scale rounded to bf16")
    ms, dev_ms = time_ms(deq), device_ms(deq)
    bnd = bound(nbytes(*q8, *sc, *out), 2 * sum(q.numel() for q in q8), "float32")
    row3 = next(r for r in rows if r["name"] == "flash_decode")
    print(f"  int8 dequantize of k and v ({BATCH},{W},{K},{hd}) at {ARCH}'s decode shape: "
          f"{ms:.5f} ms per call, {dev_ms:.5f} on the device (bound {bnd['bound_ms']:.6f} by "
          f"{bnd['bound_by']}), beside flash_decode's {row3['device_ms']:.5f} on the device at "
          f"the same shape ({row3['shape']})")


def whisper_rows(dev, randn):
    """flash_attention with a key length of its own (not causal), the
    encoder's not-causal self-attention and flash_decode over the memory, at
    whisper-tiny's shapes (BATCH x WHISPER_PROMPT queries, 6 heads of 64, its
    1500 frames), each against its plain version, two calls the same bits,
    timed beside SDPA: bf16 and float32 (the 3xTF32 route, with its lse).
    First the ragged key lengths CROSS_KEY_LENGTHS beside fewer and more
    queries (CROSS_QUERY_LENGTHS), both routes, MHA and g 2."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    cfg = get_arch(WHISPER)
    H, hd, Fr = cfg.n_heads, cfg.resolved_head_dim, cfg.encoder_seq
    B, S = BATCH, WHISPER_PROMPT
    print(f"kernel flash_attention with its own key length, flash_decode over the memory "
          f"({WHISPER})")

    def tensors(B_, S_, Sk, H_, K_, dtype, hd=hd):
        """q (B, H, S, hd), k / v (B, K, Sk, hd): views of (B, S, heads, hd)."""
        q = randn(B_, S_, H_, hd, dtype=dtype).transpose(1, 2)
        k, v = (randn(B_, Sk, K_, hd, dtype=dtype).transpose(1, 2) for _ in range(2))
        return q, k, v

    def check(label, q, k, v, dtype):
        """The kernel against its plain version (and its lse in float32);
        two calls the same bits. Returns max |kernel - plain|."""
        tol = TOL["bfloat16" if dtype == torch.bfloat16 else "float32"]
        out, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
        ref, lse_ref = fa.flash_attention_ref(q, k, v, causal=False, return_lse=True)
        err = compare(f"flash_attention {label}", out, ref, tol)
        compare(f"flash_attention lse {label}", lse, lse_ref, LSE_TOL)
        if not torch.equal(fa.flash_attention(q, k, v, causal=False), out):
            fail(f"flash_attention {label}: two calls on the same inputs differ")
        return err

    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for Sk in CROSS_KEY_LENGTHS:
            for Sq in CROSS_QUERY_LENGTHS:
                for K_ in (H, H // 2):
                    check(f"{name} ({2},{H},{Sq},{hd}) over {Sk} keys, {K_} KV heads",
                          *tensors(2, Sq, Sk, H, K_, dtype), dtype)
        for S_ in (1, 64):  # a single query, exactly a q-tile of keys and queries
            check(f"{name} ({2},{H},{S_},{hd}) over 64 keys", *tensors(2, S_, 64, H, H, dtype),
                  dtype)
        # phi-3-vision's head dim: a k-tile and one key, g 2
        check(f"{name} (2,4,100,96) over 65 keys, 2 KV heads",
              *tensors(2, 100, 65, 4, 2, dtype, hd=96), dtype)
    for causal, window in ((True, 0), (False, 8)):
        q, k, v = tensors(1, 16, 24, 2, 2, torch.bfloat16)
        try:
            fa.flash_attention(q, k, v, causal=causal, window=window)
        except ValueError:
            continue
        fail(f"flash_attention: 24 keys for 16 queries with causal={causal}, window={window} "
             f"did not raise")

    rows = []
    for dtype, rate in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32 3xTF32")):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for what, S_ in (("cross-attention", S), ("encoder self-attention", Fr)):
            q, k, v = tensors(B, S_, Fr, H, H, dtype)
            label = (f"q ({B},{H},{S_},{hd}), k/v ({B},{H},{Fr},{hd}) {name}, not causal "
                     f"({WHISPER} {what})")
            err = check(label, q, k, v, dtype)
            bnd = bound(2 * nbytes(q) + nbytes(k, v), 4 * hd * S_ * Fr * B * H, rate)
            rows.append(dict(
                name="flash_attention", route="cuda", f32_route=dtype == torch.float32,
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:75", shape=label,
                max_abs_err=err, **bnd,
                **timings(lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, causal=False),
                          lambda q=q, k=k, v=v: fa.flash_attention_ref(q, k, v, causal=False),
                          lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
                          iters=10),
            ))
            del q, k, v
    # a decode step's cross-attention: one query a row over all 1500 frames
    qd = randn(B, H, hd)
    kc, vc = (randn(B, Fr, H, hd).transpose(1, 2) for _ in range(2))
    kpos = torch.arange(Fr, dtype=torch.int32, device=dev).expand(B, Fr).contiguous()
    label = f"q ({B},{H},{hd}) bf16, memory {Fr} slots, all valid ({WHISPER} cross-attention)"
    want = da.flash_decode_ref(qd, kc, vc, kpos, Fr - 1)
    out = da.flash_decode(qd, kc, vc, kpos, Fr - 1)
    err = compare(f"flash_decode {label}", out, want, DECODE_TOL_BF16)
    if not torch.equal(da.flash_decode(qd, kc, vc, kpos, Fr - 1), out):
        fail(f"flash_decode {label}: two calls on the same inputs differ")
    n_valid = B * Fr
    bnd = bound(2 * nbytes(qd) + 2 * n_valid * H * hd * kc.element_size() + nbytes(kpos),
                4 * hd * H * n_valid, "bfloat16")
    q4 = qd[:, :, None]
    rows.append(dict(
        name="flash_decode", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:60", shape=label, max_abs_err=err, **bnd,
        **timings(lambda: da.flash_decode(qd, kc, vc, kpos, Fr - 1),
                  lambda: da.flash_decode_ref(qd, kc, vc, kpos, Fr - 1),
                  lambda: F.scaled_dot_product_attention(q4, kc, vc)),
    ))
    return rows


def cross_backward_rows(dev, randn):
    """flash_attention_bwd with k / v of their own length (a cross-attention,
    not causal) and the encoder's not-causal backward, at whisper-tiny's
    training shapes: BATCH x (WHISPER_PROMPT, its 1500 frames) queries, 6
    heads of 64, over its 1500 frames; bf16 and float32 (3xTF32), each
    against its plain version under BWD_TOL, the same bits on two calls,
    dk / dv of Sk rows; the float32 cases also against the formulas in
    float64 (``attention_bwd_f64``: the kernel's and the plain version's
    errors beside each other), timed beside SDPA's autograd backward with
    the same key length, the device ms split by kernel. First the ragged
    key lengths CROSS_KEY_LENGTHS beside CROSS_QUERY_LENGTHS queries, g 1
    and 2, head dims 64 and 96, both routes (untimed)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa

    cfg = get_arch(WHISPER)
    H, hd, Fr = cfg.n_heads, cfg.resolved_head_dim, cfg.encoder_seq
    B, S = BATCH, WHISPER_PROMPT
    print(f"kernel flash_attention_bwd with its own key length ({WHISPER})")

    def case(label, B_, S_, Sk, H_, K_, hd_, dtype, f64=False):
        """q, dout (B, H, S, hd) and k / v (B, K, Sk, hd), views of (B, S,
        heads, hd) buffers as the model's projections give them; the forward
        (its lse too) and the backward against their plain versions, two
        calls the same bits. Returns (the backward's inputs, its outputs,
        max |kernel - plain| over dq, dk, dv)."""
        q = randn(B_, S_, H_, hd_, dtype=dtype).transpose(1, 2)
        k, v = (randn(B_, Sk, K_, hd_, dtype=dtype).transpose(1, 2) for _ in range(2))
        dout = randn(B_, S_, H_, hd_, dtype=dtype).transpose(1, 2)
        out, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
        _, lse_ref = fa.flash_attention_ref(q, k, v, causal=False, return_lse=True)
        compare(f"flash_attention lse {label}", lse, lse_ref, LSE_TOL)
        args = (q, k, v, out, dout, lse)
        got = fa.flash_attention_bwd(*args, causal=False)
        want = fa.flash_attention_bwd_ref(*args, causal=False)
        if got[1].shape != k.shape or got[2].shape != v.shape:
            fail(f"flash_attention_bwd {label}: dk {tuple(got[1].shape)}, dv "
                 f"{tuple(got[2].shape)} for k / v {tuple(k.shape)}")
        tol = BWD_TOL["bfloat16" if dtype == torch.bfloat16 else "float32"]
        errs = [compare(f"flash_attention_bwd {n} {label}", a, b, tol)
                for n, a, b in zip(("dq", "dk", "dv"), got, want)]
        again = fa.flash_attention_bwd(*args, causal=False)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            fail(f"flash_attention_bwd {label}: two calls on the same inputs differ")
        if f64:  # whose rounding, the kernel's or the plain version's; held to BWD_TOL too
            exact = attention_bwd_f64(*args, causal=False)
            for n, a, b, e in zip(("dq", "dk", "dv"), got, want, exact):
                print(f"  flash_attention_bwd {n} {label}: max |kernel - float64| "
                      f"{float((a.double() - e).abs().max()):.3g}, max |plain - float64| "
                      f"{float((b.double() - e).abs().max()):.3g}, max |float64| "
                      f"{float(e.abs().max()):.3g}")
                if exceeds(a.double(), e, tol):
                    fail(f"flash_attention_bwd {n} {label}: the kernel is beyond {tol} of the "
                         f"formulas in float64")
            del exact
        del want, again
        return args, got, max(errs)

    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for hd_ in (hd, 96):
            for Sk in CROSS_KEY_LENGTHS:
                for Sq in CROSS_QUERY_LENGTHS:
                    for K_ in (H, H // 2):
                        case(f"{name} (2,{H},{Sq},{hd_}) over {Sk} keys, {K_} KV heads", 2, Sq,
                             Sk, H, K_, hd_, dtype)
    for causal, window in ((True, 0), (False, 8)):
        q = torch.zeros((1, 2, 16, 64), device=dev, dtype=torch.bfloat16)
        k = torch.zeros((1, 2, 24, 64), device=dev, dtype=torch.bfloat16)
        lse = torch.zeros((1, 2, 16), device=dev)
        try:
            fa.flash_attention_bwd(q, k, k, q, q, lse, causal=causal, window=window)
        except ValueError:
            continue
        fail(f"flash_attention_bwd: 24 keys for 16 queries with causal={causal}, "
             f"window={window} did not raise")

    rows = []
    for dtype, rate in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32 3xTF32")):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for what, S_ in (("cross-attention", S), ("encoder self-attention", Fr)):
            label = (f"q ({B},{H},{S_},{hd}), k/v ({B},{H},{Fr},{hd}) {name}, not causal "
                     f"({WHISPER} {what})")
            args, got, err = case(label, B, S_, Fr, H, H, hd, dtype,
                                  f64=dtype == torch.float32)
            # the function's own traffic: each input read once, each output written once
            bnd = bound(nbytes(*args, *got), 10 * hd * S_ * Fr * B * H, rate)
            split = [(n.replace("void (anonymous namespace)::", "")[:36], round(ms, 5))
                     for n, ms in device_top(lambda: fa.flash_attention_bwd(*args, causal=False))]
            print(f"  flash_attention_bwd {label}: device ms by kernel {split}")
            scratch = 2 * 2 * B * H * Fr * hd * 4  # float32 dK/dV partials, written and read
            print(f"  flash_attention_bwd {label}: per-head partials {scratch / 1e6:.1f} MB "
                  f"round trip, {scratch / HBM_BYTES_PER_S * 1e3:.5f} ms at the memory rate "
                  f"(not in the bound)")
            q, k, v, _, dout, _ = args
            qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
            og = F.scaled_dot_product_attention(qg, kg, vg)
            rows.append(dict(
                name="flash_attention_bwd", route="cuda", f32_route=dtype == torch.float32,
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention.py:75 (its gradient: jax.grad of "
                         "the jnp attention)",
                shape=label, max_abs_err=err, **bnd,
                **timings(lambda a=args: fa.flash_attention_bwd(*a, causal=False),
                          lambda a=args: fa.flash_attention_bwd_ref(*a, causal=False),
                          lambda og=og, ins=(qg, kg, vg), d=dout: torch.autograd.grad(
                              og, ins, d, retain_graph=True),
                          iters=10),
            ))
            del args, got, qg, kg, vg, og
            torch.cuda.empty_cache()
    return rows


def wkv6_row(randn, dev):
    """wkv6 at rwkv6-1.6b's prefill shape, r/k/v/wlog as the (B, S, H, N)
    views the model passes, after checking that the built kernel's launch
    plan is launch_plan's and that its serve grid is resident in one wave;
    then the ragged, odd-grid, S = 1, strong-decay and reference-shape
    cases. No single PyTorch call computes it."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import rwkv6

    print("kernel wkv6")
    cfg = get_arch("rwkv6-1.6b")
    H, N = cfg.n_heads, cfg.resolved_head_dim

    def inputs(B_, S_, H_, N_, dtype, strong_decay=False):
        """tests/test_kernels.py's distributions, as (B, H, S, N) views."""
        r, k, v = (0.5 * randn(B_, S_, H_, N_, dtype=torch.float32) for _ in range(3))
        if strong_decay:
            wlog = torch.full((B_, S_, H_, N_), -8.0, dtype=torch.float32, device=dev)
            u = torch.zeros((H_, N_), dtype=torch.float32, device=dev)
            st = torch.zeros((B_, H_, N_, N_), dtype=torch.float32, device=dev)
        else:
            wlog = -torch.exp(0.5 * randn(B_, S_, H_, N_, dtype=torch.float32) - 1)
            u = 0.3 * randn(H_, N_, dtype=torch.float32)
            st = 0.1 * randn(B_, H_, N_, N_, dtype=torch.float32)
        r, k, v = (t.to(dtype).transpose(1, 2) for t in (r, k, v))
        return r, k, v, wlog.transpose(1, 2), u, st

    def check(name, args, tol_y, tol_state):
        y, st = rwkv6.wkv6(*args)
        y_ref, st_ref = rwkv6.wkv6_ref(*args)
        return max(compare(f"{name} y", y, y_ref, tol_y),
                   compare(f"{name} state", st, st_ref, tol_state))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        blocks, threads, smem = rwkv6.launch_plan(BATCH, H, N)
        got = rwkv6.device_plan(dtype, N)
        print(f"  wkv6 grid at ({BATCH},{H},{PROMPT},{N}) {dtype}: {blocks} blocks of "
              f"{threads} threads, {smem} B shared, {got['per_sm']} resident per SM x {sms} "
              f"SMs = {got['per_sm'] * sms}")
        if (got["threads"], got["smem"], got["slabs"] * BATCH * H) != (threads, smem, blocks):
            fail(f"wkv6 {dtype}: the kernel's plan {got} differs from launch_plan's "
                 f"{(blocks, threads, smem)}")
        if blocks > got["per_sm"] * sms:
            fail(f"wkv6 {dtype}: {blocks} blocks do not fit one wave ({got['per_sm']} per SM)")
    args = inputs(BATCH, PROMPT, H, N, torch.bfloat16)
    err = check(f"wkv6 bf16 r/k/v ({BATCH},{H},{PROMPT},{N})", args, TOL["bfloat16"],
                WKV6_TOL_F32)
    check("wkv6 f32 ragged S=300 (2,8,300,64)", inputs(2, 300, 8, N, torch.float32),
          WKV6_TOL_F32, WKV6_TOL_F32)
    check("wkv6 f32 (3,5,130,64): B*H*slabs = 60 blocks, a short tile",
          inputs(3, 130, 5, N, torch.float32), WKV6_TOL_F32, WKV6_TOL_F32)
    for tag, dtype, tol_y in (("f32", torch.float32, WKV6_TOL_F32),
                              ("bf16 r/k/v", torch.bfloat16, TOL["bfloat16"])):
        check(f"wkv6 {tag} S=1 (2,4,1,64)", inputs(2, 1, 4, N, dtype), tol_y, WKV6_TOL_F32)
    strong = inputs(1, 256, 2, N, torch.float32, strong_decay=True)
    check("wkv6 f32 wlog=-8 (1,2,256,64)", strong, WKV6_TOL_STRONG_DECAY, WKV6_TOL_STRONG_DECAY)
    for B_, H_, S_, N_ in ((1, 1, 32, 8), (2, 4, 128, 16), (1, 2, 96, 32)):  # tests/test_kernels.py
        check(f"wkv6 f32 ({B_},{H_},{S_},{N_})", inputs(B_, S_, H_, N_, torch.float32),
              WKV6_TOL_F32, WKV6_TOL_F32)
        check(f"wkv6 bf16 r/k/v ({B_},{H_},{S_},{N_})", inputs(B_, S_, H_, N_, torch.bfloat16),
              TOL["bfloat16"], WKV6_TOL_F32)
    r, k, v, wlog, u, st = args
    n_elem = r.numel()  # (b, h, t, n)
    bnd = bound(nbytes(r, k, v, wlog, u) + 2 * nbytes(st) + nbytes(r),
                       4 * n_elem * N, "float32")
    return dict(
        name="wkv6", route="cuda", source="src/repro_torch/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6.py:73",
        shape=f"r/k/v ({BATCH},{H},{PROMPT},{N}) bf16, wlog/u/state f32", max_abs_err=err,
        **bnd,
        **timings(lambda: rwkv6.wkv6(*args), lambda: rwkv6.wkv6_ref(*args)),
    )


def wkv6_bwd_f64(r, k, v, wlog, u, state, dy, ds_T):
    """The wkv6 backward's formulas in float64 on the card, token by token,
    with dwlog_t = exp(w_t) * rowsum(dS_{t+1} * S_t) taken directly from
    every S_t kept: the yardstick that tells the kernel's rounding from the
    float32 plain version's. (dr, dk, dv, dwlog, du, dstate) in float64."""
    import torch

    f64 = torch.float64
    r, k, v, wlog, dy = (t.to(f64) for t in (r, k, v, wlog, dy))
    u, X = u.to(f64), state.to(f64)
    ew = torch.exp(wlog)
    s = (v * dy).sum(-1, keepdim=True)  # (B, H, S, 1)
    states = []
    for t in range(r.shape[2]):
        states.append(X)
        X = X * ew[:, :, t, :, None] + k[:, :, t, :, None] * v[:, :, t, None, :]
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    D = ds_T.to(f64)
    for t in reversed(range(r.shape[2])):
        St, rt, kt, vt, yt, st = states[t], r[:, :, t], k[:, :, t], v[:, :, t], dy[:, :, t], \
            s[:, :, t]
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", St, yt) + u * kt * st
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", D, vt) + u * rt * st
        dv[:, :, t] = torch.einsum("bhij,bhi->bhj", D, kt) + (rt * u * kt).sum(-1, True) * yt
        dw[:, :, t] = ew[:, :, t] * (D * St).sum(-1)
        du += (rt * kt * st).sum(0)
        D = D * ew[:, :, t, :, None] + rt[..., None] * yt[..., None, :]
    return dr, dk, dv, dw, du, D


def wkv6_bwd_plan_check(dev, B: int, H: int, S: int, N: int) -> None:
    """The wkv6 backward's five launches at (B, H, S, N): the built
    kernels' own plan (blocks, threads, static shared bytes, blocks resident
    on one SM) against ``rwkv6.bwd_plan``, the Python mirror that sizes the
    scratch, in both dtypes; printed with the warps resident an SM. Fails
    if they differ or if a row pass has fewer than WKV6_BWD_ROW_WARPS warps
    resident."""
    import torch

    from repro_torch.kernels import rwkv6

    want = rwkv6.bwd_plan(B, H, S, N)
    for dtype in (torch.float32, torch.bfloat16):
        got = rwkv6.device_bwd_plan(dtype, B, H, S, N)
        print(f"  wkv6_bwd plan at ({B},{H},{S},{N}) {dtype}, {want['chunks']} chunks of "
              f"{rwkv6.BWD_CHUNK}:")
        for name, (blocks, threads, smem, per_sm) in got.items():
            print(f"    {name}: {blocks} blocks of {threads} threads, {smem} B shared, "
                  f"{per_sm} blocks = {per_sm * threads // 32} warps resident an SM")
            if (blocks, threads, smem) != want["launches"][name]:
                fail(f"wkv6_bwd {dtype} {name}: the kernel's plan {(blocks, threads, smem)} "
                     f"differs from bwd_plan's {want['launches'][name]}")
            if name.startswith("rows") and per_sm * threads // 32 < WKV6_BWD_ROW_WARPS:
                fail(f"wkv6_bwd {dtype} {name}: {per_sm * threads // 32} warps resident an "
                     f"SM, fewer than {WKV6_BWD_ROW_WARPS}")


def wkv6_bwd_row(randn, dev):
    """The wkv6 backward against its plain version (autograd through the
    chunked form in float32) at rwkv6-1.6b's training shape (4, 32, 512,
    64), r/k/v/dy as the (B, S, H, N) views the model passes, with a
    nonzero state and dS_T: bf16 (timed) and float32 (the kernel and the
    plain version each also against the formulas in float64); its plan
    (``wkv6_bwd_plan_check``); then ragged, short-tile, S = 1, the chunk
    boundaries (S = C + 1, 2C - 1 and 3C with C = ``rwkv6.BWD_CHUNK``, in
    both dtypes), wlog = -8 over several chunks, contiguous-dy and the
    reference test's shapes. Every case twice, the same bits. Prints the
    device time split by kernel. No single PyTorch call computes it."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import rwkv6

    print("kernel wkv6_bwd")
    cfg = get_arch("rwkv6-1.6b")
    H, N = cfg.n_heads, cfg.resolved_head_dim
    f32 = torch.float32

    def inputs(B_, S_, H_, N_, dtype, strong_decay=False, dy_bhsn=False):
        """wkv6_row's distributions, a nonzero state and dS_T; dy as a view
        like r's, or (dy_bhsn) a contiguous (B, H, S, N) tensor."""
        r, k, v, dy = (0.5 * randn(B_, S_, H_, N_, dtype=f32) for _ in range(4))
        wlog = torch.full((B_, S_, H_, N_), -8.0, dtype=f32, device=dev) if strong_decay \
            else -torch.exp(0.5 * randn(B_, S_, H_, N_, dtype=f32) - 1)
        u = 0.3 * randn(H_, N_, dtype=f32)
        st, ds_T = (0.1 * randn(B_, H_, N_, N_, dtype=f32) for _ in range(2))
        r, k, v, dy = (t.to(dtype).transpose(1, 2) for t in (r, k, v, dy))
        if dy_bhsn:
            dy = dy.contiguous()
        return r, k, v, wlog.transpose(1, 2), u, st, dy, ds_T

    def check(label, args, strong_decay=False):
        """The kernel against the plain version; at wlog = -8 the plain
        version's own float32 rounding (its cumulative log decays reach
        -512 in a chunk) is held to the forward's strong-decay limit, and
        the kernel to the float64 formulas at WKV6_BWD_REL."""
        got, want = rwkv6.wkv6_bwd(*args), rwkv6.wkv6_bwd_ref(*args)
        exact = wkv6_bwd_f64(*args) if strong_decay else None
        errs = []
        for i, (name, a, b) in enumerate(zip(WKV6_BWD_NAMES, got, want)):
            atol = WKV6_BWD_REL * float(b.float().abs().max())
            tol = (atol, 2.0 ** -7 if a.dtype == torch.bfloat16 else 0.0)
            if strong_decay:
                e = exact[i]
                compare(f"wkv6_bwd {name} {label} against float64", a.double(), e,
                        (WKV6_BWD_REL * float(e.abs().max()), 0.0))
                print(f"  wkv6_bwd {name} {label}: max |plain - float64| "
                      f"{float((b.double() - e).abs().max()):.3g}")
                tol = WKV6_TOL_STRONG_DECAY
            errs.append(compare(f"wkv6_bwd {name} {label}", a, b, tol))
        again = rwkv6.wkv6_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            fail(f"wkv6_bwd {label}: two calls on the same inputs differ")
        return max(errs), got, want

    shape = (BATCH, H, PROMPT, N)
    wkv6_bwd_plan_check(dev, *shape)
    args = inputs(BATCH, PROMPT, H, N, torch.bfloat16)
    err, _, _ = check(f"bf16 r/k/v/dy {shape}", args)
    args32 = inputs(BATCH, PROMPT, H, N, f32)
    _, got, want = check(f"f32 {shape}", args32)
    exact = wkv6_bwd_f64(*args32)
    for name, a, b, e in zip(WKV6_BWD_NAMES, got, want, exact):
        print(f"  wkv6_bwd {name} f32 {shape}: max |kernel - float64| "
              f"{float((a.double() - e).abs().max()):.3g}, max |plain - float64| "
              f"{float((b.double() - e).abs().max()):.3g}, max |float64| "
              f"{float(e.abs().max()):.3g}")
    del args32, got, want, exact
    torch.cuda.empty_cache()
    check("f32 ragged S=300 (2,8,300,64)", inputs(2, 300, 8, N, f32))
    check("f32 (3,5,130,64): a short tile", inputs(3, 130, 5, N, f32))
    for tag, dtype in (("f32", f32), ("bf16", torch.bfloat16)):
        check(f"{tag} S=1 (2,4,1,64)", inputs(2, 1, 4, N, dtype))
    check("f32 wlog=-8 (1,2,256,64)", inputs(1, 256, 2, N, f32, strong_decay=True),
          strong_decay=True)
    C = rwkv6.BWD_CHUNK
    for S_ in (C + 1, 2 * C - 1, 3 * C):  # the chunk boundaries
        for tag, dtype in (("f32", f32), ("bf16", torch.bfloat16)):
            check(f"{tag} (2,4,{S_},64), chunks of {C}", inputs(2, S_, 4, N, dtype))
    check(f"f32 wlog=-8 over 4 chunks (2,4,{3 * C + 5},64)",
          inputs(2, 3 * C + 5, 4, N, f32, strong_decay=True), strong_decay=True)
    check("bf16 dy contiguous (2,4,128,64)", inputs(2, 128, 4, N, torch.bfloat16, dy_bhsn=True))
    for B_, H_, S_, N_ in ((1, 1, 32, 8), (2, 4, 128, 16), (1, 2, 96, 32)):  # tests/test_kernels.py
        for tag, dtype in (("f32", f32), ("bf16", torch.bfloat16)):
            check(f"{tag} ({B_},{H_},{S_},{N_})", inputs(B_, S_, H_, N_, dtype))
    r, k, v, wlog, u, st, dy, ds_T = args
    # the function's own traffic (each input read once, each output written
    # once; the A scratch's round trip is the design's) and 10 float32 flops
    # a state element a token: S and dS carried, S_t dy_t, dS v_t, dS^T k_t
    bnd = bound(2 * nbytes(r, k, v, dy, wlog) + nbytes(u, st, ds_T, u, st),
                10 * r.numel() * N, "float32")
    split = [(n.replace("void (anonymous namespace)::", "")[:48], round(ms, 5)) for n, ms in
             device_top(lambda: rwkv6.wkv6_bwd(*args))]
    print(f"  wkv6_bwd bf16 {shape}: device ms by kernel {split}")
    return dict(
        name="wkv6_bwd", route="cuda", source="src/repro_torch/csrc/wkv6_bwd.cu",
        replaces="src/repro/kernels/rwkv6.py:73 (its gradient: jax.grad of "
                 "src/repro/models/rwkv6.py:55 wkv6_chunked)",
        shape=f"r/k/v/dy {shape} bf16, wlog/u/state/dS_T f32", max_abs_err=err, **bnd,
        **timings(lambda: rwkv6.wkv6_bwd(*args), lambda: rwkv6.wkv6_bwd_ref(*args)),
    )


def rglru_row(randn, dev):
    """rglru at recurrentgemma-9b's prefill shape (batch 4, prompt 2048, lru
    4096) with float32 and with bf16 log_a/m, each timed beside its bound;
    then the reference's test shapes and the edge cases of the kernel's
    ring (S = 1, a short last tile, partial slabs, rows that are not
    16-byte aligned, a long sequence on two slabs, no decay and full
    decay), each against the plain version within the float32 tolerance.
    No single PyTorch call computes the recurrence."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import rglru as lru

    print("kernel rglru")
    W = get_arch("recurrentgemma-9b").lru_width
    f32, bf = torch.float32, torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def inputs(B_, S_, W_, dtype=f32):
        """tests/test_kernels.py's distributions; log_a and m in ``dtype``."""
        return ((-torch.exp(0.5 * randn(B_, S_, W_, dtype=f32))).to(dtype),
                randn(B_, S_, W_, dtype=dtype), randn(B_, W_, dtype=f32))

    def check(name, args):
        log_a, m, _ = lru.kernel_inputs(*args)  # as the wrapper passes them on
        vec = lru.copy_bytes(log_a.shape[-1], log_a.element_size(), log_a.data_ptr(),
                             m.data_ptr())
        name = f"rglru {'bf16' if log_a.dtype == bf else 'f32'} {name}, {vec}-byte copies"
        (h_seq, h_final), (r_seq, r_final) = lru.rglru(*args), lru.rglru_ref(*args)
        return max(compare(f"{name} h_seq", h_seq, r_seq, TOL["float32"]),
                   compare(f"{name} h_final", h_final, r_final, TOL["float32"]))

    rows = []
    for dtype in (f32, bf):
        blocks, per_sm = BATCH * -(-W // lru.SLAB), lru.blocks_per_sm(dtype, 16)
        print(f"  rglru grid at ({BATCH},2048,{W}) {dtype}: {blocks} blocks, {per_sm} resident "
              f"per SM x {sms} SMs = {per_sm * sms}")
        if blocks > per_sm * sms:
            fail(f"rglru {dtype}: {blocks} blocks do not fit one wave ({per_sm} per SM)")
        args = inputs(BATCH, 2048, W, dtype)
        err = check(f"({BATCH},2048,{W})", args)
        log_a, m, h0 = args
        bnd = bound(nbytes(log_a, m, h0) + 4 * log_a.numel() + nbytes(h0),
                           3 * log_a.numel(), "float32")
        tag = "f32" if dtype == f32 else "bf16"
        rows.append(dict(
            name="rglru", route="cuda", source="src/repro_torch/csrc/rglru.cu",
            replaces="src/repro/kernels/rglru.py:46",
            shape=f"log_a/m ({BATCH},2048,{W}) {tag}, h0 f32", max_abs_err=err,
            **bnd,
            **timings(lambda: lru.rglru(*args), lambda: lru.rglru_ref(*args)),
        ))
        del args, log_a, m, h0
    for dtype in (f32, bf):
        for shape in ((1, 64, 32), (2, 128, 64), (2, 192, 128),  # tests/test_kernels.py
                      (2, 300, 96), (2, 1, 64), (2, 200, 48)):  # ragged, S = 1, short tile
            check(f"{shape}", inputs(*shape, dtype))
        for W_ in (98, 99, 100):  # rows not 16-byte aligned; bf16 99: odd rows
            check(f"unaligned rows (2,130,{W_})", inputs(2, 130, W_, dtype))
        flat = randn(2 * 130 * 64 + 1, dtype=dtype)  # bases one element off alignment
        log_a, m, h0 = inputs(2, 130, 64, dtype)
        log_a = flat[1:].copy_(log_a.flatten()).view(2, 130, 64)
        check("(2,130,64) on bases one element off", (log_a, m, h0))
        extreme = inputs(2, 256, 160, dtype)
        extreme[0][..., 0::3] = -30.0  # decay to 0 in one step
        extreme[0][..., 1::3] = 0.0  # no decay: h sums m
        check("log_a -30 and 0 (2,256,160)", extreme)
    check("long (1,16384,64) on two slabs", inputs(1, 16384, 64))
    return rows


def rglru_bwd_f64(log_a, h_seq, h0, dh_seq, dh_final):
    """The rglru backward's formulas in float64 on the card, token by token
    in reverse order: the yardstick that tells the kernel's rounding from
    the float32 plain version's. (dlog_a, dm, dh0) in float64."""
    import torch

    f64 = torch.float64
    a, h_seq, dh = torch.exp(log_a.to(f64)), h_seq.to(f64), dh_seq.to(f64)
    dlog_a, dm = torch.empty_like(a), torch.empty_like(a)
    c = dh_final.to(f64)
    for t in reversed(range(a.shape[1])):
        g = dh[:, t] + c
        c = a[:, t] * g
        dm[:, t] = g
        dlog_a[:, t] = c * (h_seq[:, t - 1] if t else h0.to(f64))
    return dlog_a, dm, c


def rglru_bwd_rows(randn, dev):
    """The rglru backward against its plain version, with a nonzero h0 and
    dh_final, at recurrentgemma-9b's training shape (4, 512, 4096) in
    float32 and at the forward row's (4, 2048, 4096) in float32 and with
    bf16 log_a, each timed beside its bound (the float32 kernel and plain
    version also against the formulas in float64); then the forward row's
    edge cases: the reference's test shapes, S = 1, short tiles, partial
    slabs, rows that are not 16-byte aligned, bases one element off, no
    decay and full decay, a long sequence. Every case twice, the same bits.
    No single PyTorch call computes it."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import rglru as lru

    print("kernel rglru_bwd")
    W = get_arch("recurrentgemma-9b").lru_width
    f32, bf = torch.float32, torch.bfloat16

    def inputs(B_, S_, W_, dtype=f32, extreme=False):
        """The forward row's distributions (``extreme``: every third
        channel's log_a -30, the next one's 0); h_seq the plain forward's."""
        log_a = (-torch.exp(0.5 * randn(B_, S_, W_, dtype=f32))).to(dtype)
        if extreme:
            log_a[..., 0::3] = -30.0
            log_a[..., 1::3] = 0.0
        m, h0 = randn(B_, S_, W_, dtype=dtype), randn(B_, W_, dtype=f32)
        h_seq, _ = lru.rglru_ref(log_a, m, h0)
        return log_a, h_seq, h0, randn(B_, S_, W_, dtype=f32), randn(B_, W_, dtype=f32)

    def off_by_one(t):
        """t's values on a base one element past an aligned allocation."""
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        return flat[1:].view(t.shape).copy_(t)

    def check(label, args):
        log_a, h_seq, _, dh_seq, _ = args
        la_ptr = log_a.data_ptr() if log_a.data_ptr() % 4 == 0 else 0  # else copied: aligned
        vec = lru.copy_bytes(log_a.shape[-1], log_a.element_size(), la_ptr, h_seq.data_ptr(),
                             dh_seq.data_ptr())
        label = f"{'bf16' if log_a.dtype == bf else 'f32'} {label}, {vec}-byte copies"
        got, want = lru.rglru_bwd(*args), lru.rglru_bwd_ref(*args)
        errs = []
        for name, a, b in zip(RGLRU_BWD_NAMES, got, want):
            tol = (RGLRU_BWD_REL * float(b.float().abs().max()),
                   2.0 ** -7 if a.dtype == bf else 0.0)
            errs.append(compare(f"rglru_bwd {name} {label}", a, b, tol))
        if not all(torch.equal(a, b) for a, b in zip(lru.rglru_bwd(*args), got)):
            fail(f"rglru_bwd {label}: two calls on the same inputs differ")
        return max(errs), got, want

    rows = []
    for S_, dtype in ((512, f32), (2048, f32), (2048, bf)):
        args = inputs(BATCH, S_, W, dtype)
        shape = f"({BATCH},{S_},{W})"
        err, got, want = check(shape, args)
        if dtype == f32:
            for name, a, b, e in zip(RGLRU_BWD_NAMES, got, want, rglru_bwd_f64(*args)):
                print(f"  rglru_bwd {name} f32 {shape}: max |kernel - float64| "
                      f"{float((a.double() - e).abs().max()):.3g}, max |plain - float64| "
                      f"{float((b.double() - e).abs().max()):.3g}, max |float64| "
                      f"{float(e.abs().max()):.3g}")
        del got, want
        log_a, h_seq, h0, dh_seq, dh_final = args
        # log_a, h_seq, dh_seq, h0 and dh_final read once; dlog_a, dm (log_a's
        # type) and dh0 written once; ~5 flops an element
        bnd = bound(nbytes(log_a, h_seq, dh_seq, h0, dh_final, log_a, log_a, h0),
                    5 * log_a.numel(), "float32")
        tag = "f32" if dtype == f32 else "bf16"
        rows.append(dict(
            name="rglru_bwd", route="cuda", source="src/repro_torch/csrc/rglru.cu",
            replaces="src/repro/kernels/rglru.py:46 (its gradient: jax.grad of "
                     "src/repro/models/rglru.py:56 rglru_scan)",
            shape=f"log_a {shape} {tag}, h_seq/dh_seq f32, h0/dh_final f32", max_abs_err=err,
            **bnd, **timings(lambda: lru.rglru_bwd(*args), lambda: lru.rglru_bwd_ref(*args)),
        ))
        del args, log_a, h_seq, h0, dh_seq, dh_final
    for dtype in (f32, bf):
        for shape in ((1, 64, 32), (2, 128, 64), (2, 192, 128),  # tests/test_kernels.py
                      (2, 300, 96), (2, 1, 64), (2, 200, 48)):  # ragged, S = 1, short tile
            check(f"{shape}", inputs(*shape, dtype))
        for W_ in (98, 99, 100):  # rows not 16-byte aligned; bf16 99: odd rows
            check(f"unaligned rows (2,130,{W_})", inputs(2, 130, W_, dtype))
        log_a, h_seq, h0, dh_seq, dh_final = inputs(2, 130, 64, dtype)
        check("(2,130,64), log_a on a base one element off",
              (off_by_one(log_a), h_seq, h0, dh_seq, dh_final))
        check("(2,130,64), h_seq and dh_seq on bases one element off",
              (log_a, off_by_one(h_seq), h0, off_by_one(dh_seq), dh_final))
        check("log_a -30 and 0 (2,256,160)", inputs(2, 256, 160, dtype, extreme=True))
    check("long (1,16384,64) on two slabs", inputs(1, 16384, 64))
    return rows


def plain_replay(model, params, prompt, tokens, n_steps: int, frames=None, image_embeds=None):
    """The same weights through the plain versions on the card, fed the
    kernel run's greedy tokens: logits of the prefill and n_steps decodes
    (at positions after the prefilled ones, as ``serve.generate`` decodes)."""
    import torch

    from repro_torch.kernels import ops

    P = prompt.shape[1] + model.image_tokens(image_embeds)
    with torch.inference_mode(), ops.plain_versions():
        ref, caches = model.prefill(params, prompt, cache_len=P + NEW, frames=frames,
                                    image_embeds=image_embeds)
        steps = [ref]
        for i in range(n_steps):
            ref, caches = model.decode(params, tokens[:, i:i + 1], P + i, caches)
            steps.append(ref)
    return steps


def want_launches(model) -> dict:
    """The exact launches of one prefill and NEW - 1 decode steps: two RMS
    norms per layer and the final one per forward (none with layer norms:
    plain torch); per attention layer one flash_attention in the prefill
    and one flash_decode per step, and per xattn layer one more of each
    (its cross-attention over the memory); one flash_attention per encoder
    layer, in the prefill; one wkv6 per rwkv layer and one rglru per rec
    layer, in the prefill only (their decode steps are plain torch, as in
    the reference)."""
    kinds, cfg = model.kinds, model.cfg
    n_attn = sum(k in ("attn", "attn_local", "xattn") for k in kinds) + kinds.count("xattn")
    rms = (2 * len(kinds) + 1) * NEW if cfg.norm == "rms" else 0
    return {"rmsnorm": rms, "flash_attention": n_attn + cfg.encoder_layers,
            "flash_decode": n_attn * (NEW - 1), "wkv6": kinds.count("rwkv"),
            "rglru": kinds.count("rec"), "rmsnorm_bwd": 0, "flash_attention_bwd": 0,
            "wkv6_bwd": 0, "rglru_bwd": 0}


def serve_phase(arch: str, prompt_len: int, card: str, changes=None, moe_route_kernels=None):
    """One serve run at full width through ``launch.serve`` (with the config
    ``changes``: the int8 cache, kimi-k2's depth): exact launches, finite
    logits, the prefill and 4 decode steps against the plain path's replay,
    a profile; with ``moe_route_kernels`` (the router and plan's kernels at
    MOE_ARCH's width) also ``moe_at_width`` on the served layer. Returns
    (the launch counts, the logits of every step on the host)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    model, params, prompt = serve.setup(arch, full=True, batch=BATCH, prompt_len=prompt_len,
                                        device="cuda", seed=0, changes=changes)
    frames = serve.make_frames(model, BATCH, prompt.device)
    image_embeds = serve.make_image_embeds(model, BATCH, prompt.device)
    cfg = model.cfg
    label = arch + (f" {cfg.kv_cache_dtype} cache" if cfg.kv_cache_dtype else "")
    serve.generate(model, params, prompt, 3, frames, image_embeds)  # warm-up (cuBLAS, allocator)

    ops.reset_launch_counts()
    gen = serve.generate(model, params, prompt, NEW, frames, image_embeds)
    counts = ops.launch_counts()
    want = want_launches(model)
    print(f"serve {label} launches {counts} (want {want})")
    if counts != want:
        fail(f"{label}: kernel launch counts {counts} != {want}")
    logits = torch.stack(gen.logits)
    if logits.shape != (NEW, BATCH, cfg.vocab) or not torch.isfinite(logits).all():
        fail(f"{label} serve logits: shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")

    steps = plain_replay(model, params, prompt, gen.tokens, 4, frames, image_embeds)
    gaps, diffs = [], []
    for i, ref in enumerate(steps):
        got_tok = gen.tokens[:, i]
        ref_f = ref.float()
        top = ref_f.max(dim=-1).values
        at_tok = ref_f.gather(1, got_tok[:, None])[:, 0]
        exact = int((ref_f.argmax(dim=-1) == got_tok).sum())
        diff = float((gen.logits[i].float() - ref_f).abs().max())
        gap = float((top - at_tok).max())
        print(f"  step {i}: tokens equal {exact}/{BATCH}, max |logits kernel - plain| {diff:.4g}, "
              f"largest plain-logit gap to the kernel's token {gap:.4g}")
        gaps.append(gap)
        diffs.append(diff)
        if gap > TOKEN_TIE_TOL[arch]:
            fail(f"{label} step {i}: greedy token {got_tok.tolist()} vs plain "
                 f"{ref_f.argmax(dim=-1).tolist()} beyond a near-tie ({gap:.4g} > "
                 f"{TOKEN_TIE_TOL[arch]})")
        if diff > BF16_LOGITS_DRIFT[arch]:
            fail(f"{label} step {i}: max |logits kernel - plain| {diff:.4g} > "
                 f"{BF16_LOGITS_DRIFT[arch]}")
    print(f"  {label} over the prefill and 4 decode steps: largest gap {max(gaps):.4g} (limit "
          f"{TOKEN_TIE_TOL[arch]}), largest max |kernel - plain| {max(diffs):.4g} (limit "
          f"{BF16_LOGITS_DRIFT[arch]})")

    res = serve.summary(arch, gen)
    extra = f", {cfg.encoder_seq} frames" if cfg.encoder_layers else ""
    extra += f", {cfg.num_img_tokens} image tokens" if cfg.num_img_tokens else ""
    extra += "".join(f", {cut}" for cut in cuts(cfg))
    extra += f", all {cfg.n_experts} experts top-{cfg.top_k}" if cfg.moe else ""
    print(f"serve {label} full width, batch {BATCH}, prompt {prompt_len}{extra}, {NEW} new "
          f"tokens on {card}: prefill_s {res['prefill_s']} decode_p50_s {res['decode_p50_s']} "
          f"decode_p99_s {res['decode_p99_s']} tokens_per_s {res['tokens_per_s']}")
    print(json.dumps({"serve": res, "prompt": prompt_len, "kv_cache_dtype": cfg.kv_cache_dtype,
                      "launches": counts, "card": card}))
    profile_serve(model, params, prompt, res, frames, image_embeds)
    if cfg.moe and moe_route_kernels:
        moe_at_width(model, params, card, moe_route_kernels)
    host_logits = logits.float().cpu()
    del model, params, gen, logits, steps
    torch.cuda.empty_cache()
    return counts, host_logits


def moe_at_width(model, params, card: str, ref_route_kernels: int) -> None:
    """The served model's first MoE layer alone (kimi-k2: 384 experts, top-8,
    capacity factor 1.25, its shared expert) on seeded bf16 inputs of
    BATCH x PROMPT tokens: two forward calls give the same bits, the
    dropped slots, and the router and plan's kernel launches beside
    MOE_ARCH's (``ref_route_kernels``): the plan has no loop over the
    experts, so the count does not grow with E."""
    import torch

    from repro_torch.models import moe as M

    cfg, p = model.cfg, params["layers"][0]["ffn"]
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    x = torch.randn((BATCH, PROMPT, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        first, second = M.moe_apply(p, x, cfg), M.moe_apply(p, x, cfg)
        plan, _ = M.route(p, x, cfg)
        route_kernels = kernel_trace(lambda: M.route(p, x, cfg), 1)[0]
        route_ms = device_ms(lambda: M.route(p, x, cfg), iters=10)
        layer_ms = device_ms(lambda: M.moe_apply(p, x, cfg), iters=5)
    for name, a, b in zip(("y", "aux"), first, second):
        if not torch.isfinite(a.float()).all():
            fail(f"moe {cfg.name}: non-finite {name}")
        if not torch.equal(a, b):
            fail(f"moe {cfg.name}: {name} differs between two calls on the same inputs")
    slots = BATCH * PROMPT * cfg.top_k
    dropped = int(plan.dropped)
    print(f"moe {cfg.name} full width bf16 ({BATCH} x {PROMPT} tokens, {cfg.n_experts} experts, "
          f"top-{cfg.top_k}, {cfg.n_shared_experts} shared, capacity_factor "
          f"{cfg.capacity_factor}: C = {plan.capacity}): two calls give the same bits; dropped "
          f"slots {dropped} of {slots} ({100 * dropped / slots:.2f}%); the router and plan "
          f"launch {route_kernels} kernels ({MOE_ARCH}'s {ref_route_kernels} at 64 experts), "
          f"{route_ms:.5f} device ms; the layer {layer_ms:.5f} device ms on {card}")
    if route_kernels > ref_route_kernels:
        fail(f"moe {cfg.name}: the router and plan launch {route_kernels} kernels at "
             f"{cfg.n_experts} experts, more than {ref_route_kernels} at 64")


def int8_against_bf16_cache(int8_logits, bf16_logits) -> None:
    """How far ARCH's int8-cache serve run lies from its bf16-cache run on
    the same weights and prompt (printed, not a limit: the caches hold other
    numbers): max |logits diff| of each step while the greedy tokens agree,
    and the steps they agree for."""
    agree = (int8_logits.argmax(-1) == bf16_logits.argmax(-1)).all(dim=-1)
    n_agree = int(agree.int().cumprod(0).sum())
    diffs = [float((int8_logits[i] - bf16_logits[i]).abs().max())
             for i in range(min(n_agree + 1, len(agree)))]
    print(f"serve {ARCH} int8 cache against the bf16 cache (same weights and prompt): greedy "
          f"tokens equal for {n_agree} of {len(agree)} steps; max |logits int8 - bf16| by step "
          f"up to the first other token {[round(d, 4) for d in diffs]}")


def profile_serve(model, params, prompt, res, frames=None, image_embeds=None) -> None:
    """Where a prefill and a decode step spend their time: device time per
    step (torch.profiler), its share of the unprofiled wall time of the
    serve run (prefill_s, decode_p50_s), and the kernels with the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    P = prompt.shape[1] + model.image_tokens(image_embeds)
    with torch.inference_mode():
        _, caches = model.prefill(params, prompt, cache_len=P + NEW, frames=frames,
                                  image_embeds=image_embeds)
        tok = prompt[:, -1:]

        def prefill():
            model.prefill(params, prompt, cache_len=P + NEW, frames=frames,
                          image_embeds=image_embeds)

        def decode_steps(n=8):
            for i in range(n):
                model.decode(params, tok, P + i, caches)

        for name, fn, n_steps, unprofiled_s in (("prefill", prefill, 1, res["prefill_s"]),
                                                ("decode", decode_steps, 8, res["decode_p50_s"])):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0_s = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0_s
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            device_us = sum(e.self_device_time_total for e in events)
            if device_us <= 0:
                print(f"profile {name}: no device time in the trace (not measured)")
                continue
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
            busy_s = device_us / 1e6 / n_steps
            print(f"profile {name} ({n_steps} step(s)): device busy {busy_s * 1e3:.3f} ms/step = "
                  f"{100 * busy_s / unprofiled_s:.1f}% of the unprofiled {unprofiled_s * 1e3:.3f} "
                  f"ms (profiled wall {wall_s * 1e3 / n_steps:.3f} ms/step)")
            for e in top:
                print(f"    {e.self_device_time_total / 1e3 / n_steps:9.3f} ms/step "
                      f"{e.count // n_steps:5d}x/step  {e.key[:90]}")


def random_qkv_bias(params, gen) -> None:
    """Fills the qkv biases (qwen2.5, whisper's self- and cross-attention in
    the encoder and the decoder), zeros at init as in the reference, with
    normal values from ``gen``, so that a check also holds the add."""
    for lp in params["layers"] + params.get("encoder", []):
        for mixer in ("attn", "xattn"):
            for key in ("bq", "bk", "bv"):
                if key in lp.get(mixer, {}):
                    lp[mixer][key].normal_(generator=gen)


def full_width_f32_phase(dev, arch: str, prompt_len: int):
    """A model at full width in float32 (qkv biases made nonzero): the
    kernel path against the plain path on the same weights. Every kernel
    keeps float32's own error (~1e-6; flash_attention's float32 route by
    three TF32 tensor-core passes), so the two must give the same greedy
    tokens and logits within 1e-3.
    Returns the float32 attention routes' launches of the kernel path."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    model = build_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = model.init(g, dev)
    random_qkv_bias(params, g)
    prompt = torch.randint(0, cfg.vocab, (BATCH, prompt_len), generator=g, device=dev,
                           dtype=torch.int64)
    frames = serve.make_frames(model, BATCH, dev, seed=3)
    image_embeds = serve.make_image_embeds(model, BATCH, dev, seed=3)
    ops.reset_launch_counts()
    gen = serve.generate(model, params, prompt, 5, frames, image_embeds)
    counts = f32_launches(f"full-width f32 {arch}")
    steps = plain_replay(model, params, prompt, gen.tokens, 4, frames, image_embeds)
    worst = 0.0
    for i, ref in enumerate(steps):
        worst = max(worst, float((gen.logits[i] - ref).abs().max()))
        if not torch.equal(gen.tokens[:, i], ref.argmax(dim=-1)):
            fail(f"full-width f32 {arch} step {i}: tokens {gen.tokens[:, i].tolist()} vs plain "
                 f"{ref.argmax(dim=-1).tolist()}")
    if not worst <= LOGITS_TOL_FULL_F32:
        fail(f"full-width f32 {arch}: max |logits kernel - plain| {worst:.3g} > "
             f"{LOGITS_TOL_FULL_F32}")
    print(f"full-width f32 {arch}: kernel path == plain path, tokens equal over 5 steps, "
          f"max |logits diff| {worst:.3g} (tol {LOGITS_TOL_FULL_F32})")
    del model, params, gen, steps
    torch.cuda.empty_cache()
    return counts


def moe_layer_phase(dev, card: str) -> dict:
    """The MoE FFN alone at MOE_ARCH's full width (64 experts, top-8,
    capacity factor 1.25, d 2048, expert width 1024; random weights from a
    seed, bf16, BATCH x PROMPT tokens, groups of PROMPT, C = 80): forward and
    backward twice, every output and gradient the same bits (the FT
    trainer's bit-identical state rests on it); the slots dropped; the
    device ms (torch.profiler) of the router and its plan, the dispatch, the
    expert products, the combine and a whole forward and backward. Then, in
    float32 and drop-free (capacity factor E), the dispatch path against
    the dense oracle ``moe_ref`` on the same inputs: the two select from the
    same float32 probabilities, so they differ only by the order of float32
    sums. Returns {"device_ms": the parts' device ms, "dropped": slots}
    for the mesh phase to print beside its own."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M

    cfg = get_arch(MOE_ARCH)
    E, k = cfg.n_experts, cfg.top_k
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    bf = torch.bfloat16
    p = M.moe_init(g, cfg, dev, bf)
    x = torch.randn((BATCH, PROMPT, cfg.d_model), generator=g, device=dev).to(bf)
    dy = torch.randn(x.shape, generator=g, device=dev).to(bf)
    one = torch.ones((), device=dev)
    live = {name: w.requires_grad_() for name, w in p.items()}

    def fwd_bwd():
        xg = x.detach().requires_grad_()
        y, aux = M.moe_apply(live, xg, cfg)
        grads = torch.autograd.grad((y, aux), [xg, *live.values()], (dy, one))
        return [y.detach(), aux.detach(), *grads]

    names = ["y", "aux", "dx"] + [f"d{name}" for name in live]
    first, second = fwd_bwd(), fwd_bwd()
    for name, a, b in zip(names, first, second):
        if not torch.isfinite(a.float()).all():
            fail(f"moe layer {MOE_ARCH}: non-finite {name}")
        if not torch.equal(a, b):
            fail(f"moe layer {MOE_ARCH}: {name} differs between two calls on the same inputs")
    with torch.no_grad():
        plan, aux = M.route(p, x, cfg)
        buf = M.dispatch(x, plan)
        out_buf = M.expert_ffn(p, buf)
    slots = BATCH * PROMPT * k
    dropped = int(plan.dropped)
    print(f"moe layer {MOE_ARCH} full width bf16 ({BATCH} x {PROMPT} tokens, {E} experts, top-{k}, "
          f"capacity_factor {cfg.capacity_factor}: C = {plan.capacity}, buffer "
          f"{tuple(buf.shape)}): forward and backward twice give the same bits ({len(names)} "
          f"tensors); dropped slots {dropped} of {slots} ({100 * dropped / slots:.2f}%), aux "
          f"{float(aux):.6f}")
    with torch.no_grad():
        parts = {"router and plan": lambda: M.route(p, x, cfg),
                 "dispatch": lambda: M.dispatch(x, plan),
                 "expert products": lambda: M.expert_ffn(p, buf),
                 "combine": lambda: M.combine(out_buf, plan)}
        ms = {name: device_ms(fn, iters=10) for name, fn in parts.items()}
    ms["forward and backward"] = device_ms(fwd_bwd, iters=5)
    with torch.no_grad():
        route_kernels = kernel_trace(lambda: M.route(p, x, cfg), 1)[0]
    flops = 2 * 3 * E * buf.shape[1] * cfg.d_model * cfg.d_ff
    print(f"moe layer {MOE_ARCH} device ms on {card}: "
          + ", ".join(f"{name} {v:.5f}" for name, v in ms.items())
          + f" (the expert products' {flops / 1e12:.3f} TFLOP over {E} x {buf.shape[1]} buffer "
          f"rows: bound {flops / PEAK_OPS_PER_S['bfloat16'] * 1e3:.5f} ms at 989 TFLOP/s)")
    print(json.dumps({"moe_layer": {"arch": MOE_ARCH, "card": card, "capacity": plan.capacity,
                                    "dropped": dropped, "slots": slots, "device_ms": ms,
                                    "route_kernels": route_kernels}}))
    del live, first, second, plan, buf, out_buf, p
    # float32, drop-free: the dispatch path against the dense oracle
    cfg32 = dataclasses.replace(cfg, dtype="float32", capacity_factor=float(E))
    p32 = M.moe_init(g, cfg32, dev, torch.float32)
    x32 = torch.randn((BATCH, PROMPT, cfg.d_model), generator=g, device=dev)
    with torch.no_grad():
        got, _ = M.moe_apply(p32, x32, cfg32)
        want = M.moe_ref(p32, x32, cfg32)
        plan32, _ = M.route(p32, x32, cfg32)
    if int(plan32.dropped):
        fail(f"moe layer f32 at capacity_factor {E}: {int(plan32.dropped)} slots dropped")
    err = compare(f"moe layer {MOE_ARCH} f32 drop-free, dispatch path vs moe_ref", got, want,
                  MOE_TOL_F32)
    print(f"moe layer {MOE_ARCH} f32: max |y - moe_ref| {err:.3g}, max |y| "
          f"{float(want.abs().max()):.3g}")
    del p32, x32, got, want
    free_device_memory()
    return {"device_ms": ms, "dropped": dropped, "route_kernels": route_kernels}


def mesh_phase(dev, card: str, auto: dict):
    """The sharding slice on a one-rank NCCL mesh (``launch.mesh.make_host_mesh(1,
    1)``, ``MeshRules`` over it):

    - MOE_ARCH's MoE layer at full width through ``moe_apply_manual`` (the
      expert-parallel path: one group of BATCH x PROMPT tokens, C = 320;
      the same seed and inputs as ``moe_layer_phase``, whose auto-path
      numbers ``auto`` holds): forward and backward twice giving the same
      bits; its dropped slots and the device ms of its parts, of the
      one-rank all-reduce of the (T, d) output (``collectives.psum``) and of
      a forward and backward, printed beside the auto path's; in float32
      and drop-free against the dense oracle ``moe_ref``;
    - MOE_ARCH with ``moe_impl="manual"`` at full width and MESH_LAYERS
      layers through ``ModelDef.prefill`` / ``decode`` with the rules
      (float32, batch 1, prompt PROMPT, MESH_STEPS decode steps): the exact
      launches of the rmsnorm, flash_attention and flash_decode kernels, and
      its logits and greedy tokens against the same weights on the auto
      path (at batch 1 both paths have one group of PROMPT tokens and the
      same capacity);
    - ``sharding.pipeline.pipeline_apply`` over PIPE_LAYERS gemma-2b
      attention blocks at full width (float32, 1 stage, PIPE_MICRO
      microbatches of BATCH x PROMPT): within PIPE_TOL of the blocks applied
      in sequence to each microbatch, and within LOGITS_TOL_FULL_F32 of
      them applied to the whole batch (whose matrix products may round
      otherwise), the same bits on two calls, the rmsnorm and
      flash_attention kernels launched;
    - a train step with rules of MOE_ARCH reduced on the manual path, then a
      simulated permanent loss of a host (``replan``, ``reshard_batch``),
      the process group destroyed and ``remesh_rules(1, 1)`` building a new
      one, and the step from the same state again: the same loss, as
      ``tests/test_beyond_paper.py`` holds the reference.

    Frees its memory and destroys its process group. Returns (launches of
    the kernels outside the float32 attention routes, the float32 routes'
    launches)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core.elastic import remesh_rules, replan, reshard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.pipeline import pipeline_apply
    from repro_torch.sharding.rules import MeshRules
    from repro_torch.train.step import make_train_step, shard_state

    check_free_memory("the mesh phase")
    mesh = make_host_mesh(1, 1)  # device_type "cuda": NCCL
    rules = MeshRules(mesh)
    print(f"mesh phase on {card}: {dist.get_backend()} process group of "
          f"{dist.get_world_size()}, mesh {dict(rules.axes)}")
    totals, totals_f32 = {}, {}

    def tally(what: str, need) -> None:
        counts, f32 = ops.launch_counts(), ops.f32_launch_counts()
        print(f"  {what} launches {counts} (float32 routes {f32})")
        missing = [name for name in need if not counts[name]]
        if missing:
            fail(f"mesh phase, {what}: no launch of {missing}")
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n - f32.get(name, 0)
        for name, n in f32.items():
            totals_f32[name] = totals_f32.get(name, 0) + n

    # -- the MoE layer on the manual path, full width, bf16 ------------------
    cfg = dataclasses.replace(get_arch(MOE_ARCH), moe_impl="manual")
    if not M.uses_manual(cfg, rules):
        fail("mesh phase: the manual MoE path is not taken on the one-rank mesh")
    E, k, bf = cfg.n_experts, cfg.top_k, torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    p = M.moe_init(g, cfg, dev, bf)
    x = torch.randn((BATCH, PROMPT, cfg.d_model), generator=g, device=dev).to(bf)
    dy = torch.randn(x.shape, generator=g, device=dev).to(bf)
    one = torch.ones((), device=dev)
    live = {name: w.requires_grad_() for name, w in p.items()}

    def fwd_bwd():
        xg = x.detach().requires_grad_()
        y, aux = M.moe_apply_manual(live, xg, cfg, rules)
        grads = torch.autograd.grad((y, aux), [xg, *live.values()], (dy, one))
        return [y.detach(), aux.detach(), *grads]

    names = ["y", "aux", "dx"] + [f"d{name}" for name in live]
    first, second = fwd_bwd(), fwd_bwd()
    for name, a, b in zip(names, first, second):
        if not torch.isfinite(a.float()).all():
            fail(f"mesh phase manual moe {MOE_ARCH}: non-finite {name}")
        if not torch.equal(a, b):
            fail(f"mesh phase manual moe {MOE_ARCH}: {name} differs between two calls")
    T = BATCH * PROMPT
    cap = int(math.ceil(k * T * cfg.capacity_factor / E))
    with torch.no_grad():
        xs = x.reshape(T, cfg.d_model)
        probs = torch.softmax((xs @ p["router"]).float(), dim=-1)
        plan = M.manual_plan(probs, bf, cfg, 0, E, cap)
        buf = M.dispatch(xs, plan)
        out_buf = M.expert_ffn(p, buf)
        y_part = M.combine(out_buf, plan)
        parts = {"router and plan": lambda: M.manual_plan(
                     torch.softmax((xs @ p["router"]).float(), dim=-1), bf, cfg, 0, E, cap),
                 "dispatch": lambda: M.dispatch(xs, plan),
                 "expert products": lambda: M.expert_ffn(p, buf),
                 "combine": lambda: M.combine(out_buf, plan),
                 "psum over model": lambda: C.psum(y_part, mesh, "model")}
        ms = {name: device_ms(fn, iters=10) for name, fn in parts.items()}
        psum_call_ms = time_ms(lambda: C.psum(y_part, mesh, "model"))
    ms["forward and backward"] = device_ms(fwd_bwd, iters=5)
    dropped, slots = int(plan.dropped), T * k
    print(f"mesh phase manual moe {MOE_ARCH} full width bf16 ({BATCH} x {PROMPT} tokens in one "
          f"group, C = {cap}): forward and backward twice give the same bits; dropped slots "
          f"{dropped} of {slots} ({100 * dropped / slots:.2f}%; auto path, groups of {PROMPT}: "
          f"{auto['dropped']})")
    print(f"mesh phase manual moe device ms on {card} (auto path's beside): "
          + ", ".join(f"{name} {v:.5f}" + (f" (auto {auto['device_ms'][name]:.5f})"
                                           if name in auto["device_ms"] else "")
                      for name, v in ms.items())
          + f"; psum per call (CUDA events) {psum_call_ms:.5f} ms for a ({T}, {cfg.d_model}) "
          f"bf16 tensor")
    print(json.dumps({"mesh_moe": {"arch": MOE_ARCH, "card": card, "capacity": cap,
                                   "dropped": dropped, "slots": slots, "device_ms": ms,
                                   "psum_call_ms": psum_call_ms, "auto": auto}}))
    del live, first, second, plan, buf, out_buf, y_part, p, probs
    cfg32 = dataclasses.replace(cfg, dtype="float32", capacity_factor=float(E))
    p32 = M.moe_init(g, cfg32, dev, torch.float32)
    x32 = torch.randn((BATCH, PROMPT, cfg.d_model), generator=g, device=dev)
    with torch.no_grad():
        got, _ = M.moe_apply_manual(p32, x32, cfg32, rules)
        want = M.moe_ref(p32, x32, cfg32)
    err = compare(f"mesh phase manual moe {MOE_ARCH} f32 drop-free vs moe_ref", got, want,
                  MOE_TOL_F32)
    print(f"mesh phase manual moe f32: max |y - moe_ref| {err:.3g}")
    del p32, x32, got, want
    free_device_memory()

    # -- olmoe on the manual path through prefill and decode, with rules -----
    mcfg = dataclasses.replace(cfg, n_layers=MESH_LAYERS, dtype="float32")
    model = build_model(mcfg)
    g.manual_seed(11)
    params = model.init(g, dev)
    prompt = torch.randint(0, mcfg.vocab, (1, PROMPT), generator=g, device=dev, dtype=torch.int64)
    S = PROMPT
    with torch.inference_mode():
        ops.reset_launch_counts()
        logits, caches = model.prefill(params, prompt, rules, cache_len=S + MESH_STEPS)
        steps, tokens = [logits], []
        for i in range(MESH_STEPS):
            tokens.append(steps[-1].argmax(dim=-1, keepdim=True))
            logits, caches = model.decode(params, tokens[-1], S + i, caches, rules)
            steps.append(logits)
        tally(f"{MOE_ARCH} manual prefill and {MESH_STEPS} decode steps",
              ("rmsnorm", "flash_attention", "flash_decode"))
        n = len(model.kinds)
        want = {"rmsnorm": (2 * n + 1) * (1 + MESH_STEPS), "flash_attention": n,
                "flash_decode": n * MESH_STEPS}
        got_counts = {name: totals[name] + totals_f32.get(name, 0) for name in want}
        if got_counts != want:
            fail(f"mesh phase {MOE_ARCH} manual: launches {got_counts} != {want}")
        auto_model = build_model(dataclasses.replace(mcfg, moe_impl="auto"))
        ref, ref_caches = auto_model.prefill(params, prompt, cache_len=S + MESH_STEPS)
        worst = float((steps[0] - ref).abs().max())
        for i in range(MESH_STEPS):
            if not torch.equal(tokens[i][:, 0], ref.argmax(dim=-1)):
                fail(f"mesh phase {MOE_ARCH} step {i}: manual token {tokens[i].tolist()} vs "
                     f"auto {ref.argmax(dim=-1).tolist()}")
            ref, ref_caches = auto_model.decode(params, tokens[i], S + i, ref_caches)
            worst = max(worst, float((steps[i + 1] - ref).abs().max()))
    if not all(torch.isfinite(t).all() for t in steps) or worst > LOGITS_TOL_FULL_F32:
        fail(f"mesh phase {MOE_ARCH} manual vs auto: max |logits diff| {worst:.3g} "
             f"(tol {LOGITS_TOL_FULL_F32})")
    print(f"mesh phase {MOE_ARCH} manual, full width, {MESH_LAYERS} layers, float32, batch 1, "
          f"prompt {S}: prefill + {MESH_STEPS} decode steps with rules == auto path: tokens "
          f"equal, max |logits diff| {worst:.3g} (tol {LOGITS_TOL_FULL_F32})")
    del model, auto_model, params, caches, ref_caches, steps
    free_device_memory()

    # -- the pipeline over gemma-2b attention blocks ---------------------------
    pcfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=PIPE_LAYERS, dtype="float32")
    pmodel = build_model(pcfg)
    g.manual_seed(13)
    blocks = [pmodel._block_init("attn", g, dev, torch.float32) for _ in range(PIPE_LAYERS)]
    stacked = _stack_trees(blocks)
    h0 = torch.randn((BATCH, PROMPT, pcfg.d_model), generator=g, device=dev)
    positions = torch.arange(PROMPT, dtype=torch.int32, device=dev)

    def block(lp, h):
        return pmodel._block_train("attn", lp, h, positions.expand(h.shape[0], PROMPT))[0]

    with torch.no_grad():
        ops.reset_launch_counts()
        y1 = pipeline_apply(block, stacked, h0, mesh, PIPE_MICRO)
        tally(f"pipeline_apply over {PIPE_LAYERS} gemma-2b blocks", ("rmsnorm", "flash_attention"))
        y2 = pipeline_apply(block, stacked, h0, mesh, PIPE_MICRO)
        seq_micro, seq_full = [], h0
        for m in h0.split(BATCH // PIPE_MICRO):
            for b in blocks:
                m = block(b, m)
            seq_micro.append(m)
        for b in blocks:
            seq_full = block(b, seq_full)
    if not torch.equal(y1, y2):
        fail("mesh phase pipeline_apply: two calls differ")
    what = (f"mesh phase pipeline_apply ({PIPE_LAYERS} gemma-2b blocks, 1 stage, {PIPE_MICRO} "
            f"microbatches)")
    err = compare(f"{what} vs the blocks in sequence on each microbatch", y1,
                  torch.cat(seq_micro), PIPE_TOL)
    # the whole batch's matrix products (M = BATCH * PROMPT rows, not PROMPT)
    # may take other cuBLAS kernels, whose float32 sums round otherwise
    err_full = compare(f"{what} vs the blocks in sequence on the whole batch", y1, seq_full,
                       LOGITS_TOL_FULL_F32)
    print(f"mesh phase pipeline: max |pipeline - sequential| {err:.3g} by microbatch, "
          f"{err_full:.3g} on the whole batch (max |y| {float(seq_full.abs().max()):.3g}); the "
          f"same bits twice")
    del pmodel, blocks, stacked, h0, y1, y2, seq_micro, seq_full
    free_device_memory()

    # -- kimi-k2 under its own rules (FSDP, Adafactor, bf16 masters) ---------
    mesh_kimi(dev, card, mesh, tally)

    # -- a train step with rules, a host lost, remesh_rules, the step again ---
    tcfg = dataclasses.replace(get_arch(MOE_ARCH).reduced(), moe_impl="manual")
    tmodel = build_model(tcfg)
    g.manual_seed(17)
    batch = {"tokens": torch.randint(0, tcfg.vocab, (4, 16), generator=g, device=dev)}

    def one_step(rules_):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        ts, init = make_train_step(tmodel, rules=rules_, lr=1e-4)
        _, m = ts(shard_state(tmodel, rules_, init(gen)), batch)
        return float(m["loss"])

    ops.reset_launch_counts()
    loss1 = one_step(rules)
    tally(f"train step with rules ({tcfg.name} reduced, manual)",
          ("rmsnorm", "flash_attention", "rmsnorm_bwd", "flash_attention_bwd"))
    plan = replan(n_shards=4, alive_hosts=[0, 2, 3])  # host 1 died, no spare
    if sorted(s for v in plan.assignment.values() for s in v) != [0, 1, 2, 3]:
        fail(f"mesh phase replan: {plan}")
    if sum(reshard_batch(4, 3)) != 4:
        fail("mesh phase reshard_batch lost rows")
    del mesh, rules
    dist.destroy_process_group()
    rules2 = remesh_rules(1, 1)  # a new process group and mesh
    loss2 = one_step(rules2)
    if not (math.isfinite(loss1) and abs(loss1 - loss2) <= 1e-5):
        fail(f"mesh phase remesh: loss {loss2} after remesh_rules, {loss1} before")
    print(f"mesh phase remesh_rules(1, 1) after losing host 1 of 4 (replan, reshard_batch): "
          f"train step loss {loss2:.6f} == {loss1:.6f} before")
    del rules2
    dist.destroy_process_group()
    free_device_memory()
    return totals, totals_f32


def mesh_kimi(dev, card: str, mesh, tally) -> None:
    """KIMI at full width (d 7168, 64 heads of 112), 1 layer and
    MESH_KIMI_EXPERTS experts, under its config's rules on the one-rank
    mesh (fsdp=True: every leaf with an "embed" or "mlp" dim lies on "data"
    and is gathered at its block's entry; Adafactor's statistics taken over
    the whole leaf; bf16 masters): one train step against the same step
    without rules, from the same state and batch. Every collective is over
    one rank, so the loss within LOSS_TOL_TRAIN relative and each leaf's
    update within GRAD_TOL_BF16 of its largest magnitude (the kimi phase's
    bf16 limits); the largest difference is printed. The hd-112
    flash_attention, its backward and the rmsnorm kernels launch under the
    rules (their counters)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import MeshRules
    from repro_torch.train.optim import _paths
    from repro_torch.train.step import make_train_step, shard_state
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(get_arch(KIMI), n_layers=1, n_experts=MESH_KIMI_EXPERTS)
    rules = MeshRules(mesh, fsdp=cfg.fsdp)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    ts_plain, init = make_train_step(model, lr=1e-4)
    ts_rules, _ = make_train_step(model, rules=rules, lr=1e-4)
    state = init(gen)
    old = dict(_paths(tree_map(lambda t: t.clone(), state["params"])))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in train_batch(model, dev).items()}
    on_data = sum("data" in str(spec) for _, spec in _paths(model.run_specs(rules)))
    t0 = time.perf_counter()
    plain_state, m_plain = ts_plain(tree_map(lambda t: t.clone(), state), batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ops.reset_launch_counts()
    rules_state, m_rules = ts_rules(shard_state(model, rules, state), batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tally(f"{KIMI} train step under its rules (fsdp, adafactor, bf16 masters)",
          ("rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd"))
    loss_p, loss_r = float(m_plain["loss"]), float(m_rules["loss"])
    worst, where = 0.0, ""
    got = dict(_paths(rules_state["params"]))
    for path, t in _paths(plain_state["params"]):
        if got[path].dtype != torch.bfloat16 or got[path].shape != t.shape:
            fail(f"mesh phase {KIMI} under rules: {'/'.join(path)} {got[path].dtype} "
                 f"{tuple(got[path].shape)}, without rules {t.dtype} {tuple(t.shape)}")
        move = float((t.float() - old[path].float()).abs().max())
        rel = float((got[path].float() - t.float()).abs().max()) / max(move, 1e-30)
        if rel > worst:
            worst, where = rel, "/".join(path)
    loss_rel = abs(loss_r - loss_p) / abs(loss_p)
    if not (math.isfinite(loss_r) and loss_rel <= LOSS_TOL_TRAIN and worst <= GRAD_TOL_BF16):
        fail(f"mesh phase {KIMI} under its rules vs without: loss {loss_r} vs {loss_p}, worst "
             f"update {worst:.3g} of its largest magnitude at {where} (tol {GRAD_TOL_BF16})")
    print(f"mesh phase {KIMI} full width, 1 layer, {MESH_KIMI_EXPERTS} experts, under its rules "
          f"(fsdp, {on_data} leaves on 'data', adafactor, bf16 masters) on {card}: train step "
          f"loss {loss_r:.6f} vs {loss_p:.6f} without rules (rel {loss_rel:.3g}), the largest "
          f"difference of an update {worst:.3g} of its largest magnitude ({where}); step "
          f"{t2 - t1:.3f} s under the rules, {t1 - t0:.3f} s without")
    del state, old, plain_state, rules_state, got, batch
    free_device_memory()


def _stack_trees(trees):
    """One tree whose leaves are the trees' leaves stacked along a new first dim."""
    import torch

    from repro_torch.utils.tree import flatten, unflatten

    flat = [flatten(t) for t in trees]
    return unflatten(flat[0][1], [torch.stack(ls) for ls in zip(*(f[0] for f in flat))])


def reduced_reference_phase(dev):
    """A reduced float32 model of each family on the card (kernels) against
    the same weights on the CPU (plain versions): gemma, rwkv6,
    recurrentgemma with 5 layers (its pattern group plus the remainder
    stack) and a prompt of three windows, qwen2.5 (its qkv bias made
    nonzero), olmoe (its mixture of experts on the card against the CPU),
    whisper (16 frames, 40 tokens: a cross call of 16 keys at hd 16, its
    biases nonzero), gemma with the int8 cache, phi-3-vision (4 image
    tokens before 40 text tokens) and kimi-k2 (4 experts top-2 and its
    shared expert). Returns the float32
    attention routes' launches of the card's runs."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cpu(v) for v in t]
        return t.cpu()

    ops.reset_launch_counts()
    for arch, n_layers, prompt_len, changes in (
            ("gemma-2b", 2, 40, {}), ("rwkv6-1.6b", 2, 40, {}), ("recurrentgemma-9b", 5, 48, {}),
            ("qwen2.5-3b", 2, 40, {}), ("olmoe-1b-7b", 2, 40, {}), (WHISPER, 2, 40, {}),
            ("gemma-2b", 2, 40, INT8), (VISION_ARCH, 2, 40, {}), (KIMI, 2, 40, {})):
        cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=n_layers, **changes)
        model = build_model(cfg)
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        params = model.init(g, dev)
        random_qkv_bias(params, g)
        prompt = torch.randint(0, cfg.vocab, (2, prompt_len), generator=g, device=dev,
                               dtype=torch.int64)
        frames = serve.make_frames(model, 2, dev, seed=5)
        image_embeds = serve.make_image_embeds(model, 2, dev, seed=5)
        got = serve.generate(model, params, prompt, 6, frames, image_embeds)
        want = serve.generate(model, to_cpu(params), prompt.cpu(), 6,
                              None if frames is None else frames.cpu(),
                              None if image_embeds is None else image_embeds.cpu())
        for i, (a, b) in enumerate(zip(got.logits, want.logits)):
            err = float((a.cpu() - b).abs().max())
            if not err <= LOGITS_TOL_F32:
                fail(f"reduced f32 {arch}, step {i}: max |card - cpu| {err:.3g} > "
                     f"{LOGITS_TOL_F32}")
        if not torch.equal(got.tokens.cpu(), want.tokens):
            fail(f"reduced f32 {arch}: greedy tokens differ between card and CPU")
        print(f"reduced f32 {arch}{' int8 cache' if changes else ''} ({n_layers} layers "
              f"{model.kinds}): card kernels == CPU plain versions within {LOGITS_TOL_F32}, "
              f"tokens equal")
    return f32_launches("reduced f32 models")


def paper_phase(card: str) -> None:
    import torch

    from repro_torch.configs.paper_genome import CONFIG
    from repro_torch.core.predictor import FailurePredictor
    from repro_torch.data import genome
    from repro_torch.kernels import ops
    from repro_torch.launch import genome as genome_launch
    from repro_torch.launch import tables
    from repro_torch.strategies import registry

    ops.reset_launch_counts()
    res = tables.run(str(ROOT / "bench_out_torch"), device="cuda")
    failed = sorted(k for k, v in res["checks"].items() if not v)
    print(f"paper tables: {len(res['checks'])} checks, failed {failed}; "
          f"{len(res['table1'])} + {len(res['table2'])} rows in {res['tables_s']:.6f} s (host)")
    for r in res["table1"]:
        print(f"  table1 {r['strategy']:15s} 1rnd {r['exec_1random']} "
              f"(+{r['overhead_pct_1random']} %) paper {r.get('paper_1random', '-')}")
    if failed:
        fail(f"paper tables: checks failed: {failed}")
    pred = res["predictor"]
    if pred.device.type != "cuda":
        fail(f"the predictor trained on {pred.device}, not the card")
    cpu_pred = FailurePredictor.train(seed=0, device="cpu")
    werr = max(float((pred.params[k].cpu() - cpu_pred.params[k]).abs().max()) for k in ("w", "b"))
    print(f"paper predictor: trained on the card in {res['predictor_train_ms']:.3f} ms; "
          f"max |w, b card - cpu| {werr:.3g} (tol {PREDICTOR_TOL}), threshold card "
          f"{pred.threshold} cpu {cpu_pred.threshold}; {res['prediction']}")
    if werr > PREDICTOR_TOL or pred.threshold != cpu_pred.threshold:
        fail("the card-trained predictor disagrees with the CPU-trained one")

    if PAPER_BASES != CONFIG.input_bytes:
        print(f"paper genome: CUT to {PAPER_BASES} bases from the paper's {CONFIG.input_bytes}")
    run = genome_launch.run(PAPER_BASES, CONFIG.n_patterns, registry.names(), device="cuda")
    job = run.pop("job")
    print(f"paper genome: {run['bases']} bases, {run['patterns']} patterns of "
          f"{CONFIG.pattern_len_min}-{CONFIG.pattern_len_max} bases, {job.n_search} search nodes x "
          f"{job.chunks_per_node} chunks on {card}: {run['n_hits']} hits, planted "
          f"{run['truth'] - run['missing']}/{run['truth']}; made in {run['make_s']:.3f} s, "
          f"uploaded in {run['upload_s']:.4f} s")
    for r in run["runs"]:
        print(f"  ft {r['strategy']:15s} node 0 -> {r['to']} via {r['mechanism']} ({r['outcome']}), "
              f"hash_ok {r['hash_ok']}, identical {r['identical']}, {r['seconds']:.3f} s")
    if not run["ok"] or len(run["runs"]) != 7:
        fail(f"paper genome: recall {run['truth'] - run['missing']}/{run['truth']}, runs "
             f"{[(r['strategy'], r['identical'], r['hash_ok']) for r in run['runs']]}")

    g, index = job.upload()
    chunk = g[:PLAIN_CHECK_BASES]
    t0 = time.perf_counter()
    fast = genome.search_chunk(chunk, job.patterns, index=index)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = genome.search_chunk_plain(chunk, job.patterns)
    plain_s = time.perf_counter() - t0
    print(f"paper search vs plain: {PLAIN_CHECK_BASES} bases x {2 * len(job.patterns)} "
          f"(pattern, strand): {len(fast)} hits, equal {fast == plain}; fast {fast_s:.4f} s, "
          f"plain {plain_s:.4f} s")
    if fast != plain or not fast:
        fail("paper search: the fast search disagrees with _match_positions_plain")

    start, end = job.chunk_bounds(0, 0)
    one = g[start:end]
    ms = time_ms(lambda: genome._match_hits(one, index), iters=5, warmup=1)
    dev_ms = device_ms(lambda: genome._match_hits(one, index), iters=5, warmup=1)
    n_len = len(index.groups)
    bound_ms = 1e3 * n_len * (end - start) / HBM_BYTES_PER_S
    print(f"paper search per chunk: {end - start} bases, {n_len} length groups: {ms:.4f} ms per "
          f"call, device {dev_ms} ms, bound {bound_ms:.4f} ms (the chunk's bytes read once per "
          f"length group at {HBM_BYTES_PER_S:.3g} B/s)")
    top = device_top(lambda: genome._match_hits(one, index))
    for name, t in top:
        print(f"  device {t:9.4f} ms  {name[:100]}")
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"the paper path launched a kernel of the serve path: {counts}")
    print(json.dumps({"paper": {
        "card": card, "bases": run["bases"], "patterns": run["patterns"], "n_hits": run["n_hits"],
        "search_s": run["search_s"], "mbases_per_s": run["mbases_per_s"],
        "make_s": run["make_s"], "upload_s": run["upload_s"],
        "ft_s": {r["strategy"]: r["seconds"] for r in run["runs"]},
        "chunk_bases": end - start, "chunk_ms": ms, "chunk_device_ms": dev_ms,
        "chunk_bound_ms": bound_ms, "chunk_top": top, "plain_check_s": plain_s, "fast_check_s": fast_s,
        "tables_s": res["tables_s"], "predictor_train_ms": res["predictor_train_ms"],
        "predictor_max_abs_err": werr, "prediction": res["prediction"], "launches": counts}}))
    print(f"paper: search {run['search_s']:.4f} s, {run['mbases_per_s']:.1f} Mbases/s")
    print(f"paper: tables {res['tables_s']:.6f} s")
    print(f"paper: predictor training {res['predictor_train_ms']:.3f} ms")
    del g, index, chunk, one, job
    torch.cuda.empty_cache()


def fold_profile(fn, args, n_slots: int) -> dict:
    """One replay fold on the card: its wall seconds unprofiled (the output
    is numpy, so the device is done when the clock is read), then a
    torch.profiler trace of another: kernel launches per slot, copies, and
    device busy time as a share of the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(*args)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    kernels = copies = 0
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.self_device_time_total <= 0:
            continue
        busy_us += e.self_device_time_total
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels += e.count
    return {"wall_s": wall_s, "launches": kernels, "launches_per_slot": kernels / n_slots,
            "copies": copies, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e6 / wall_s if busy_us else None}


def split_check(micro):
    """With more than one card: ``fleet_stress`` x 256 seeds split over every
    card (``n_devices``) against one card, bit for bit; and the default call
    (no ``n_devices``: one card) bit for bit and no slower than
    ``n_devices=1`` (the better of three warm calls each, in turns, within
    SPLIT_NOISE). With one card (how the script runs by default) it is not
    run."""
    import numpy as np
    import torch

    from repro_torch.scenarios import registry as scenarios
    from repro_torch.scenarios.trajectory import compile_batch, replay_batch

    n = torch.cuda.device_count()
    if n < 2:
        print("campaign n_devices split: one card, not run")
        return None
    spec = scenarios.get("fleet_stress")
    batch = compile_batch(spec, 256)
    runs = {1: [], n: [], None: []}
    res = {}
    for d in runs:
        replay_batch(spec, batch, "core", micro=micro, n_devices=d, device="cuda")  # warm
    for _ in range(3):
        for d in runs:
            t0 = time.perf_counter()
            res[d] = replay_batch(spec, batch, "core", micro=micro, n_devices=d, device="cuda")
            runs[d].append(time.perf_counter() - t0)
    best = {d: min(ts) for d, ts in runs.items()}

    def differs(a, b):
        return [k for k in a if not np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f")]

    diff, diff_default = differs(res[1], res[n]), differs(res[1], res[None])
    print(f"campaign n_devices split: fleet_stress x 256 over {n} cards "
          f"{'bit-identical to' if not diff else f'DIFFERS in {diff} from'} one card; "
          f"{best[n]:.4f} s against {best[1]:.4f} s; the default "
          f"{'bit-identical' if not diff_default else f'DIFFERS in {diff_default}'}, "
          f"{best[None]:.4f} s (best of 3 each)")
    if diff or diff_default:
        fail(f"campaign: the seed split changed {diff or diff_default}")
    if best[None] > best[1] * (1 + SPLIT_NOISE):
        fail(f"campaign: the default seed split is slower than one card: {best[None]:.4f} s "
             f"against {best[1]:.4f} s")
    return {"cards": n, "seconds": best[n], "one_card_seconds": best[1],
            "default_seconds": best[None], "default_runs": runs[None], "one_card_runs": runs[1],
            "split_runs": runs[n]}


def campaign_phase(card: str) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.campaign import SLO, trial_mismatches
    from repro_torch.obs.trace import reconstruct_traces
    from repro_torch.scenarios import registry as scenarios
    from repro_torch.scenarios.engine import CampaignEngine
    from repro_torch.scenarios.montecarlo import (
        _n_windows, mc_totals, mc_trajectories, params_from_scenario)
    from repro_torch.scenarios.trajectory import compile_batch, replay_batch, replay_program
    from repro_torch.strategies import registry as strategies
    from repro_torch.workloads import resolve as resolve_workload

    def same(a: dict, b: dict) -> list:
        """Keys whose arrays differ in a bit, a dtype or a shape."""
        return [k for k in a if k not in b or a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
                or not np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f")]

    ops.reset_launch_counts()
    families = scenarios.names()
    micros = {}
    t0 = time.perf_counter()
    cells = engine_trials = 0
    engine_s = 0.0
    for family in families:
        spec = scenarios.get(family)
        n = FLEET_CHECK_SEEDS if family == "fleet_stress" else CAMPAIGN_SEEDS
        wl = resolve_workload(None, spec, device="cuda")
        micros[family] = micro = wl.micro("placentia", n_nodes=spec.n_nodes)
        batch = compile_batch(spec, n)
        for name in strategies.names():
            card_out = replay_batch(spec, batch, name, micro=micro, device="cuda")
            cpu_out = replay_batch(spec, batch, name, micro=micro, device="cpu")
            diff = same(cpu_out, card_out)
            if diff:
                fail(f"campaign {family}/{name}: the card's fold differs from the CPU's in {diff}")
            for k in range(n):
                e0 = time.perf_counter()
                res = CampaignEngine(spec, name, micro=micro, seed=k, workload=wl,
                                     device="cuda").run()
                engine_s += time.perf_counter() - e0
                engine_trials += 1
                bad = trial_mismatches(card_out, k, res)
                if bad:
                    fail(f"campaign {family}/{name} seed {k}: the card's fold differs from "
                         f"the engine in {bad}")
            cells += 1
    sweep_s = time.perf_counter() - t0
    print(f"campaign sweep: {len(families)} families x {len(strategies.names())} strategies = "
          f"{cells} cells at {CAMPAIGN_SEEDS} seeds ({FLEET_CHECK_SEEDS} for fleet_stress) on "
          f"{card}: card fold = CPU fold bit for bit, = engine in {engine_trials} trials "
          f"(SLO bills bit for bit on decode_fleet_churn); {sweep_s:.3f} s")

    t0 = time.perf_counter()
    traced = 0
    for family in families:
        spec = scenarios.get(family)
        n = 1 if family == "fleet_stress" else TRACE_SEEDS
        for name in TRACE_STRATEGIES:
            fold = reconstruct_traces(spec, name, n_seeds=n, micro=micros[family], device="cuda")
            for k in range(n):
                eng = CampaignEngine(spec, name, micro=micros[family], seed=k, trace=True,
                                     device="cuda").run().trace
                if eng.comparable() != fold[k].comparable():
                    fail(f"campaign {family}/{name} seed {k}: the engine's trace differs from "
                         f"the one rebuilt from the card's fold")
                traced += 1
    trace_s = time.perf_counter() - t0
    print(f"campaign traces: engine = rebuilt from the card's fold in {traced} trials "
          f"({len(families)} families x {TRACE_STRATEGIES}); {trace_s:.3f} s")

    runs = []
    for family, n_seeds in MC_FULL:
        spec = scenarios.get(family)
        micro = micros[family]
        b0 = time.perf_counter()
        batch = compile_batch(spec, n_seeds)
        compile_s = time.perf_counter() - b0
        for name in MC_STRATEGIES:
            m0 = time.perf_counter()
            mc = mc_trajectories(spec, name, n_seeds, batch=batch, micro=micro, device="cuda")
            mc_s = time.perf_counter() - m0
            out = mc["trials"]
            cpu_out = replay_batch(spec, batch, name, micro=micro, device="cpu")
            diff = same(cpu_out, out)
            if diff:
                fail(f"campaign {family}/{name} x {n_seeds}: card fold differs from CPU in {diff}")
            e0 = time.perf_counter()
            for k in range(MC_ENGINE_CHECKS):
                res = CampaignEngine(spec, name, micro=micro, seed=k, device="cuda").run()
                bad = trial_mismatches(out, k, res)
                if bad:
                    fail(f"campaign {family}/{name} seed {k}: fold differs from engine in {bad}")
            eng = (time.perf_counter() - e0) / MC_ENGINE_CHECKS
            fn, args = replay_program(spec, batch, name, micro=micro, device="cuda")
            n_slots = args[1]["times"].shape[1]
            prof = fold_profile(fn, args, n_slots)
            if not all(np.isfinite(out["total_s"][out["survived"]])) or mc["n_seeds"] != n_seeds:
                fail(f"campaign {family}/{name}: non-finite totals or a wrong seed count")
            row = {"scenario": family, "strategy": name, "n_seeds": n_seeds,
                   "n_hosts": batch.n_hosts, "n_slots": n_slots, "compile_s": compile_s,
                   "mc_s": mc_s, "seeds_per_s": n_seeds / mc_s, "fold_s": prof["wall_s"],
                   "fold_seeds_per_s": n_seeds / prof["wall_s"], "launches": prof["launches"],
                   "launches_per_slot": prof["launches_per_slot"], "copies": prof["copies"],
                   "busy_ms": prof["busy_ms"], "busy_share": prof["busy_share"],
                   "engine_s_per_trial": eng, "survival_rate": mc["survival_rate"],
                   "mean_s": mc["mean_s"], "p5_s": mc["p5_s"], "p50_s": mc["p50_s"],
                   "p95_s": mc["p95_s"]}
            runs.append(row)
            print(f"campaign mc {family} {name}: {n_seeds} seeds x {batch.n_hosts} hosts x "
                  f"{n_slots} slots, survival {mc['survival_rate']:.4f}, mean {mc['mean_s']} s, "
                  f"p5/p50/p95 {mc['p5_s']}/{mc['p50_s']}/{mc['p95_s']} s; = CPU fold bitwise, "
                  f"= engine on {MC_ENGINE_CHECKS} trials; tapes {compile_s:.4f} s (host)")

    llm = []
    for family, n_seeds in LLM_FULL:
        spec = scenarios.get(family)
        micro = micros[family]
        b0 = time.perf_counter()
        batch = compile_batch(spec, n_seeds)
        compile_s = time.perf_counter() - b0
        for name in strategies.names():
            m0 = time.perf_counter()
            mc = mc_trajectories(spec, name, n_seeds, batch=batch, micro=micro, device="cuda")
            mc_s = time.perf_counter() - m0
            out = mc["trials"]
            cpu_out = replay_batch(spec, batch, name, micro=micro, device="cpu")
            diff = same(cpu_out, out)
            if diff:
                fail(f"campaign {family}/{name} x {n_seeds}: card fold differs from CPU in {diff}")
            e0 = time.perf_counter()
            for k in range(MC_ENGINE_CHECKS):
                res = CampaignEngine(spec, name, micro=micro, seed=k, device="cuda").run()
                bad = trial_mismatches(out, k, res)
                if bad:
                    fail(f"campaign {family}/{name} seed {k}: fold differs from engine in {bad}")
            eng = (time.perf_counter() - e0) / MC_ENGINE_CHECKS
            fn, args = replay_program(spec, batch, name, micro=micro, device="cuda")
            fn(*args)
            f0 = time.perf_counter()
            fn(*args)
            fold_s = time.perf_counter() - f0
            has_slo = all(k in out for k in SLO)
            if (spec.traffic is not None) != has_slo or not np.isfinite(
                    out["total_s"][out["survived"]]).all():
                fail(f"campaign {family}/{name}: SLO bills {has_slo} for traffic "
                     f"{spec.traffic is not None}, or non-finite totals")
            row = {"scenario": family, "strategy": name, "n_seeds": n_seeds,
                   "n_hosts": batch.n_hosts, "n_slots": batch.n_slots, "compile_s": compile_s,
                   "mc_s": mc_s, "fold_s": fold_s, "engine_s_per_trial": eng,
                   "survival_rate": mc["survival_rate"], "mean_s": mc["mean_s"],
                   "slo": mc.get("slo")}
            llm.append(row)
            slo = mc.get("slo")
            slo_txt = "" if slo is None else (
                f"; SLO p50 {slo['p50_s']}, p99 {slo['p99_s']}, dropped {slo['dropped_mean']}, "
                f"availability {slo['availability_mean']} (least {slo['availability_min']})")
            print(f"campaign llm {family} {name}: {n_seeds} seeds x {batch.n_hosts} hosts x "
                  f"{batch.n_slots} slots on {card}: mc_trajectories {mc_s:.4f} s, fold "
                  f"{fold_s:.4f} s, engine {eng:.4f} s/trial; survival {mc['survival_rate']:.4f}, "
                  f"mean {mc['mean_s']} s{slo_txt}; = CPU fold bitwise, = engine on "
                  f"{MC_ENGINE_CHECKS} trials")

    spec = scenarios.get("fleet_stress")
    batch = compile_batch(spec, 256)
    outs = [replay_batch(spec, batch, "core", micro=micros["fleet_stress"], tile_slots=t,
                         device="cuda") for t in (1, 8, 64)]
    diff = same(outs[1], outs[0]) + same(outs[1], outs[2])
    print(f"campaign tile_slots 1/8/64 on fleet_stress x 256 on the card: "
          f"{'bit-identical' if not diff else diff}")
    if diff:
        fail(f"campaign: tile_slots changed {diff}")

    params = params_from_scenario(scenarios.get("table1_random"), "central_single",
                                  micros["table1_random"])
    t0 = time.perf_counter()
    tot = mc_totals(params, n_seeds=MC_TOTALS_SEEDS, seed=0, device="cuda")
    totals_s = time.perf_counter() - t0
    n_fail = _n_windows(params.J_s, params.period_s) * params.per_window
    expect = (params.J_s + params.probe_per_hour_s * params.J_s / 3600.0
              + n_fail * (params.period_s / 2 + params.reinstate_s + params.overhead_s
                          + params.lead_s))
    se = tot["std_s"] / MC_TOTALS_SEEDS ** 0.5
    print(f"campaign mc_totals table1_random central_single x {MC_TOTALS_SEEDS} on the card: "
          f"mean {tot['mean_s']} s, closed form {expect} s, {abs(tot['mean_s'] - expect) / se:.3f} "
          f"standard errors (limit {MC_TOTALS_SE}); {totals_s:.4f} s")
    if not abs(tot["mean_s"] - expect) <= MC_TOTALS_SE * se:
        fail("campaign: mc_totals' mean is off the closed form's expectation")

    split = split_check(micros["fleet_stress"])

    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"the campaign path launched a kernel of the serve path: {counts}")
    print(json.dumps({"campaign": {
        "card": card, "families": families, "cells": cells,
        "sweep_s": sweep_s, "engine_trials": engine_trials,
        "sweep_engine_s_per_trial": engine_s / engine_trials, "traced_trials": traced,
        "trace_s": trace_s, "mc": runs, "llm": llm,
        "mc_totals": {"n_seeds": MC_TOTALS_SEEDS, "mean_s": tot["mean_s"], "std_s": tot["std_s"],
                      "expect_s": expect, "seconds": totals_s},
        "split": split, "launches": counts}}))
    for r in runs:
        tag = f"{r['scenario']} {r['strategy']} x {r['n_seeds']}"
        print(f"campaign: {tag}: mc_trajectories {r['mc_s']:.4f} s, {r['seeds_per_s']:.1f} seeds/s; "
              f"fold {r['fold_s']:.4f} s, {r['fold_seeds_per_s']:.1f} seeds/s")
        print(f"campaign: {tag}: {r['launches_per_slot']:.2f} launches per slot "
              f"({r['launches']} over {r['n_slots']} slots), {r['copies']} copies")
        print(f"campaign: {tag}: device busy {r['busy_ms']:.3f} ms, share {r['busy_share']}")
        print(f"campaign: {tag}: engine {r['engine_s_per_trial']:.4f} s per trial")
    torch.cuda.empty_cache()


def figures_phase(card: str) -> None:
    """The paper's Figures 8-13 on the card: 10 of 10 checks at
    FIGURE_TRIALS trials, no serve kernel launched."""
    from repro_torch.kernels import ops
    from repro_torch.launch import figures

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = figures.run(str(ROOT / "bench_out_torch"), trials=FIGURE_TRIALS, device="cuda")
    total_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    failed = sorted(k for k, v in res["checks"].items() if not v)
    print(f"figures: {len(res['checks'])} checks, failed {failed}; {FIGURE_TRIALS} trials a "
          f"point on {card} ({res['device']} payload); "
          + ", ".join(f"{k} {v:.3f} s" for k, v in res["seconds"].items())
          + f"; {total_s:.3f} s in all")
    at = {(r["mechanism"], r["cluster"], r["Z"]): r["reinstate_mean_s"]
          for r in res["rows"]["dependencies"]}
    print(f"  placentia Z=50: agent {at[('agent', 'placentia', 50)]} s, core "
          f"{at[('core', 'placentia', 50)]} s, agent_batched {at[('agent_batched', 'placentia', 50)]} s")
    if len(res["checks"]) != 10 or failed:
        fail(f"figures: checks failed: {failed}")
    if any(counts.values()):
        fail(f"the figures launched a kernel of the serve path: {counts}")
    print(json.dumps({"figures": {"card": card, "trials": FIGURE_TRIALS, "checks": res["checks"],
                                  "seconds": res["seconds"], "total_s": total_s,
                                  "launches": counts}}))


def train_launches(model, steps: int) -> dict:
    """The exact launches of ``steps`` train steps with remat of ``model``:
    every block's forward runs twice (once more in the backward), the final
    norm once, each backward kernel once per norm, attention, rwkv or rec
    layer. An ``xattn`` block (an encoder-decoder's decoder) runs two
    attentions, its causal self-attention and its cross-attention to the
    memory; the encoder's ``enc`` blocks run once each, not recomputed.
    A layer-norm config launches no rmsnorm."""
    kinds, n_enc = model.kinds, model.cfg.encoder_layers
    n, n_attn = len(kinds), sum(k in ("attn", "attn_local") for k in kinds)
    n_attn += 2 * kinds.count("xattn")
    n_rwkv, n_rec = kinds.count("rwkv"), kinds.count("rec")
    rms = model.cfg.norm == "rms"
    return {"rmsnorm": steps * (4 * n + 1) * rms, "flash_attention": steps * (2 * n_attn + n_enc),
            "flash_decode": 0, "wkv6": steps * 2 * n_rwkv, "rglru": steps * 2 * n_rec,
            "rmsnorm_bwd": steps * (2 * n + 1) * rms,
            "flash_attention_bwd": steps * (n_attn + n_enc),
            "wkv6_bwd": steps * n_rwkv, "rglru_bwd": steps * n_rec}


def train_seq(cfg) -> int:
    """The tokens of a training row: an encoder-decoder's decoder context
    (WHISPER_TRAIN_SEQ), else TRAIN_SEQ."""
    return WHISPER_TRAIN_SEQ if cfg.encoder_layers else TRAIN_SEQ


def train_batch(model, dev) -> dict:
    """The seeded batch of the grad check, the profile and an encoder-
    decoder's steps: TRAIN_BATCH x ``train_seq`` tokens, and a vision
    config's image embeddings or an encoder-decoder's frames (seed 7)."""
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch import serve

    cfg = model.cfg
    batch = token_batches(0, TRAIN_BATCH, train_seq(cfg), cfg.vocab)(0)
    if cfg.num_img_tokens:  # a vision config: the loss's image offset
        batch["image_embeds"] = serve.make_image_embeds(model, TRAIN_BATCH, dev, seed=7)
    if cfg.encoder_layers:  # an encoder-decoder: its memory
        batch["frames"] = serve.make_frames(model, TRAIN_BATCH, dev, seed=7)
    return batch


def train_config(arch: str, layers):
    """``arch``'s registered config, its depth cut to ``layers`` unless None
    and its experts to TRAIN_EXPERTS where that names it."""
    import dataclasses

    from repro_torch.configs import get_arch

    changes = {} if layers is None else {"n_layers": layers}
    if arch in TRAIN_EXPERTS:
        changes["n_experts"] = TRAIN_EXPERTS[arch]
    return dataclasses.replace(get_arch(arch), **changes)


def cuts(cfg) -> list:
    """How ``cfg`` is cut from its registered config: its layers and its
    experts, where fewer."""
    from repro_torch.configs import get_arch

    reg = get_arch(cfg.name)
    out = []
    if cfg.n_layers != reg.n_layers:
        out.append(f"{cfg.n_layers} layer{'s' if cfg.n_layers != 1 else ''}")
    if cfg.n_experts != reg.n_experts:
        out.append(f"{cfg.n_experts} of {reg.n_experts} experts")
    return out


def train_label(cfg) -> str:
    cut = cuts(cfg)
    return f"{cfg.name} ({', '.join(cut)})" if cut else cfg.name


def full_width_train(card: str, cfg) -> dict:
    """``cfg`` (a registered config, or one with its depth cut) at full
    width through ``launch.train``: TRAIN_STEPS steps on one repeated
    batch, through the launcher's flags (a registered config) or its
    ``make_trainer`` and ``summary`` (a cut). The loss must fall and every
    kernel of the path must launch exactly as ``train_launches`` says."""
    import shutil

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import build_model

    arch = train_label(cfg)
    check_free_memory(f"train {arch}")
    ops.reset_launch_counts()
    if cfg == get_arch(cfg.name):
        res = train.run(["--arch", cfg.name, "--full", "--steps", str(TRAIN_STEPS), "--batch",
                         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--repeat-batch",
                         "--policy", "none", "--json"])
    else:
        torch.cuda.reset_peak_memory_stats()
        tr, losses = train.make_trainer(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, policy="none",
                                        repeat_batch=True, device="cuda")
        try:
            rep = tr.run(TRAIN_STEPS, failures=[])
        finally:
            shutil.rmtree(tr.store.root, ignore_errors=True)
        res = train.summary(arch, "none", rep, losses, TRAIN_BATCH, TRAIN_SEQ,
                            torch.cuda.max_memory_allocated())
        del tr, losses
    counts = ops.launch_counts()
    want = train_launches(build_model(cfg), TRAIN_STEPS)
    print(f"train {arch} launches {counts} (want {want})")
    if counts != want:
        fail(f"train {arch}: kernel launch counts {counts} != {want}")
    losses = res["losses"]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train {arch}: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train {arch}: the loss on a repeated batch did not fall: {losses}")
    print(f"train {arch} full width, batch {TRAIN_BATCH} x {TRAIN_SEQ}, {cfg.dtype} "
          f"activations, {cfg.param_dtype} masters + {cfg.optimizer}, {TRAIN_STEPS} steps on "
          f"{card}: step_s median "
          f"{res['step_s_median']:.4f}, tokens/s {res['tokens_per_s']:.1f}, peak "
          f"max_memory_allocated {res['peak_device_bytes'] / 2**30:.2f} GiB, max_memory_reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB, losses {losses}")
    print(json.dumps({"train": res, "card": card, "launches": counts}))
    free_device_memory()
    return counts


def encdec_train(dev, card: str, cfg) -> dict:
    """An encoder-decoder at full width through ``make_train_step`` (bf16
    activations, float32 masters and AdamW): TRAIN_STEPS steps on one
    repeated ``train_batch`` with its seeded frames. The loss must fall
    and every kernel of the path must launch exactly as ``train_launches``
    says (counts set to 0 just before the steps and read just after)."""
    import statistics

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.step import make_train_step

    arch = train_label(cfg)
    check_free_memory(f"train {arch}")
    model = build_model(cfg)
    ts, init_state = make_train_step(model)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    state = init_state(g)
    batch = train_batch(model, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = ts(state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    want = train_launches(model, TRAIN_STEPS)
    print(f"train {arch} launches {counts} (want {want})")
    if counts != want:
        fail(f"train {arch}: kernel launch counts {counts} != {want}")
    if not all(map(math.isfinite, losses)):
        fail(f"train {arch}: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train {arch}: the loss on a repeated batch did not fall: {losses}")
    seq = train_seq(cfg)
    median = statistics.median(step_s[1:])  # the first step builds the allocator's pools
    res = {"arch": arch, "batch": TRAIN_BATCH, "seq": seq, "frames": cfg.encoder_seq,
           "losses": losses, "step_s": step_s, "step_s_median": median,
           "tokens_per_s": TRAIN_BATCH * seq / median,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    print(f"train {arch} full width, batch {TRAIN_BATCH} x {seq} tokens + {cfg.encoder_seq} "
          f"frames, bf16 activations, float32 masters + AdamW, {TRAIN_STEPS} steps through "
          f"make_train_step on {card}: step_s median {median:.4f} (of steps 2-{TRAIN_STEPS}), "
          f"tokens/s {res['tokens_per_s']:.1f}, peak max_memory_allocated "
          f"{res['peak_device_bytes'] / 2**30:.2f} GiB, max_memory_reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB, losses {losses}")
    print(json.dumps({"train": res, "card": card, "launches": counts}))
    del state, batch
    free_device_memory()
    return counts


def zero_grad_leaves(model) -> dict:
    """{leaf: its sibling} of the leaves whose gradient is zero in exact
    arithmetic: the k bias of an attention without RoPE (an encoder's, a
    learned-position decoder's self-attention, every cross-attention).
    Softmax ignores a shift that every key of a row shares: each row of dS
    sums to 0, so dbk = scale · Σ_q (Σ_k dS_qk) q vanishes, and what either
    path computes for it is rounding noise, which a relative comparison of
    the two would read as ~1. Such a leaf is held to its sibling's (the
    same keys' wk) gradient instead."""
    cfg = model.cfg
    if not cfg.qkv_bias:
        return {}
    no_rope = model.learned_pos or cfg.rope_theta <= 0
    mixers = [f"encoder/{i}/attn" for i in range(cfg.encoder_layers)]
    for i, kind in enumerate(model.kinds):
        if kind == "xattn":
            mixers.append(f"layers/{i}/xattn")
        if no_rope and kind in ("attn", "attn_local", "xattn"):
            mixers.append(f"layers/{i}/attn")
    return {f"{m}/bk": f"{m}/wk" for m in mixers}


@contextlib.contextmanager
def pinned_routing(chosen: list, replay: bool):
    """``models.moe.top_k`` recording each call's chosen experts into
    ``chosen`` (``replay`` False), or handing them back in the same order
    (``replay`` True): a second run of the same step (with remat, every
    layer's router runs twice, in the forward and again in the backward)
    then routes every token to the experts of the first."""
    from repro_torch.models import moe as M

    real, calls = M.top_k, iter(chosen)

    def top_k(probs, k):
        if replay:
            return next(calls)
        chosen.append(real(probs, k))
        return chosen[-1]

    M.top_k = top_k
    try:
        yield
    finally:
        M.top_k = real


def train_grad_check(dev, cfg) -> None:
    """One step's gradients at full width on the kernel path against the same
    step under ``ops.plain_versions()``, leaf by leaf: in bf16 activations
    within GRAD_TOL_BF16, or for GRAD_F32_ARCHS in float32 activations
    within GRAD_TOL_F32, with the bf16 step's readings beside it (the plain
    bf16 step against the plain float32 step, and the bf16 kernel path
    against the bf16 plain path). The batch is ``train_batch``'s: a vision
    config's holds TRAIN_BATCH x num_img_tokens seeded image embeddings, an
    encoder-decoder's its seeded frames. A leaf whose gradient is zero in
    exact arithmetic (``zero_grad_leaves``) is held near zero instead."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.optim import _paths
    from repro_torch.utils.tree import flatten, unflatten

    chosen = []  # the kernel path's experts, where the routing is pinned

    def step_grads(cfg, plain: bool):
        model = build_model(cfg)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        params = model.init(g, dev, param_dtype=getattr(torch, cfg.param_dtype))
        batch = train_batch(model, dev)
        leaves, treedef = flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        pin = pinned_routing(chosen, plain) if cfg.name in GRAD_PINNED_ROUTING \
            else contextlib.nullcontext()
        with ops.plain_versions() if plain else contextlib.nullcontext(), pin:
            loss = model.loss(unflatten(treedef, live), batch)
            grads = torch.autograd.grad(loss, live)
        names = ["/".join(p) for p, _ in _paths(params)]
        return float(loss.detach()), grads, names

    zero = zero_grad_leaves(build_model(cfg))

    def worst(got, want):
        """(largest max|got - want| / max|want| over the leaves, its leaf,
        median), the leaves of ``zero`` left out"""
        rels = sorted((float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30), n)
                      for n, a, b in zip(got[2], got[1], want[1]) if n not in zero)
        return rels[-1][0], rels[-1][1], rels[len(rels) // 2][0]

    def near_zero(tag: str, kernel, plain, held: bool) -> None:
        """Each ``zero`` leaf on both paths against its sibling's gradient
        (``zero[leaf]``) on the plain path: max |g| / max |g_sibling|."""
        if not zero:
            return
        by_name = dict(zip(plain[2], plain[1]))
        reads = []
        for path in (kernel, plain):
            for name, a in zip(path[2], path[1]):
                if name in zero:
                    ref = max(float(by_name[zero[name]].abs().max()), 1e-30)
                    reads.append((float(a.abs().max()) / ref, name))
        rel, leaf = max(reads)
        print(f"train grads {arch} {tag}: {len(zero)} leaves zero in exact arithmetic, largest "
              f"max|g| / max|g of its wk| {rel:.4g} at {leaf}, kernel and plain paths"
              + (f" (tol {tol})" if held else ""))
        if held and rel > tol:
            fail(f"train grads {arch}: {leaf} reads {rel:.4g} of its sibling's gradient "
                 f"(> {tol}) where it is zero in exact arithmetic")

    arch = train_label(cfg)
    check_free_memory(f"train grads {arch}")
    torch.cuda.reset_peak_memory_stats()
    if cfg.name in GRAD_PINNED_ROUTING:
        print(f"train grads {arch}: the plain path routes every token to the kernel path's "
              f"experts (GRAD_PINNED_ROUTING)")
    f32 = cfg.name in GRAD_F32_ARCHS
    tol = GRAD_TOL_F32 if f32 else GRAD_TOL_BF16

    def kernel_vs_plain(tag: str, kernel, plain, held: bool) -> None:
        for name, a in zip(kernel[2], kernel[1]):
            if not torch.isfinite(a).all():
                fail(f"train grads {arch} {tag}: non-finite kernel-path gradient at {name}")
        rel, leaf, med = worst(kernel, plain)
        near_zero(tag, kernel, plain, held)
        print(f"train grads {arch} {tag} kernel vs plain, {len(kernel[2]) - len(zero)} leaves: "
              f"loss "
              f"{kernel[0]:.6f} vs {plain[0]:.6f}; largest max|dg| / max|g_plain| {rel:.4g} at "
              f"{leaf}, median {med:.4g}" + (f" (tol {tol})" if held else ""))
        if abs(kernel[0] - plain[0]) > LOSS_TOL_TRAIN * abs(plain[0]):
            fail(f"train grads {arch} {tag}: loss {kernel[0]} on the kernel path vs {plain[0]} "
                 f"plain")
        if held and rel > tol:
            fail(f"train grads {arch}: {leaf} differs by {rel:.4g} of its largest magnitude "
                 f"(> {tol})")

    # At most three gradient-sized sets are alive at once (a step's float32
    # parameters and gradients, and one kept set): 17.6 GB each for olmoe at
    # 10 layers.
    if not f32:
        kernel_vs_plain("bf16", step_grads(cfg, False), step_grads(cfg, True), held=True)
    else:
        plain32 = step_grads(dataclasses.replace(cfg, dtype="float32"), True)
        kernel_vs_plain("f32", step_grads(dataclasses.replace(cfg, dtype="float32"), False),
                        plain32, held=True)
        # how far bf16 itself moves the gradients, and the bf16 kernel path
        plain16 = step_grads(cfg, True)
        rel, leaf, med = worst(plain16, plain32)
        print(f"train grads {arch} bf16 plain vs f32 plain: largest {rel:.4g} at {leaf}, "
              f"median {med:.4g}")
        del plain32
        kernel_vs_plain("bf16", step_grads(cfg, False), plain16, held=False)
        del plain16
    print(f"train grads {arch}: peak max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, max_memory_reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")
    free_device_memory()


def profile_train(dev, card: str, cfg) -> None:
    """Where a full-width train step spends its time: device time of one
    step (torch.profiler) as a share of its unprofiled wall time, and the
    kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    from repro_torch.train.step import make_train_step

    arch = train_label(cfg)
    check_free_memory(f"profile train {arch}")
    model = build_model(cfg)
    ts, init_state = make_train_step(model)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    state = init_state(g)
    batch = train_batch(model, dev)
    state, _ = ts(state, batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = ts(state, batch)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = ts(state, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        print("profile train: no device time in the trace (not measured)")
    else:
        print(f"profile train step {arch} full width on {card}: device busy "
              f"{device_us / 1e3:.3f} ms = {100 * device_us / 1e6 / wall_s:.1f}% of the "
              f"unprofiled {wall_s * 1e3:.3f} ms")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    del state, batch
    free_device_memory()


def train_phase(dev, card: str) -> dict:
    """The training path: for each of TRAIN_ARCHS full-width steps through
    ``launch.train``, and for whisper-tiny through ``make_train_step`` with
    its frames (``encdec_train``; their launch counts are returned, summed,
    with the float32 attention routes' launches of the reduced FT runs and
    Fig 15), gradients against the plain path and a profile of a step; the FT
    invariant at reduced size (rwkv6 and recurrentgemma under hybrid) and
    Fig 15's tables; then the FT invariant at full width (gemma-2b)."""
    counts, spent = {}, []
    for arch, layers in TRAIN_ARCHS:
        t0 = time.perf_counter()
        cfg = train_config(arch, layers)
        for name, n in full_width_train(card, cfg).items():
            counts[name] = counts.get(name, 0) + n
        train_grad_check(dev, cfg)
        profile_train(dev, card, cfg)
        spent.append(f"{time.perf_counter() - t0:.1f} s {train_label(cfg)} full-width steps, "
                     f"grads and profile")
    # the encoder-decoder, through make_train_step with its frames
    t0 = time.perf_counter()
    cfg = train_config(WHISPER, None)
    for name, n in encdec_train(dev, card, cfg).items():
        counts[name] = counts.get(name, 0) + n
    train_grad_check(dev, cfg)
    profile_train(dev, card, cfg)
    spent.append(f"{time.perf_counter() - t0:.1f} s {WHISPER} full-width steps, grads and "
                 f"profile")
    t1 = time.perf_counter()
    f32 = reduced_ft(card)
    for arch in REDUCED_FT_KERNELS:
        for name, n in reduced_ft(card, arch, ("hybrid",)).items():
            f32[name] += n
    for name, n in fig15_phase(card).items():
        f32[name] += n
    t2 = time.perf_counter()
    full_width_ft(card)
    print(f"train phase: {'; '.join(spent)}; {t2 - t1:.1f} s reduced FT and fig15; "
          f"{time.perf_counter() - t2:.1f} s full-width FT")
    return counts, f32


# the other families trained at reduced size under hybrid, and the forward
# and backward kernels their runs must launch: the recurrent families'
# scans; olmoe's attention (its mixture of experts has no kernel)
REDUCED_FT_KERNELS = {"rwkv6-1.6b": ("wkv6", "wkv6_bwd"),
                      "recurrentgemma-9b": ("rglru", "rglru_bwd"),
                      "olmoe-1b-7b": ("flash_attention", "flash_attention_bwd")}


def reduced_ft(card: str, arch: str = ARCH, policies=FT_POLICIES) -> dict:
    """The trainer's lossless invariant on the card at reduced size (float32):
    under each of ``policies`` the run with failures ends bit-identical to
    the failure-free run. Returns the float32 attention routes' launches;
    gemma's must include the backward's, and another family's runs must
    launch the forward and backward kernels of REDUCED_FT_KERNELS."""
    from repro_torch.configs import get_arch
    from repro_torch.core.failure import FailureEvent
    from repro_torch.kernels import ops
    from repro_torch.launch.fig15 import _run
    from repro_torch.launch.train import make_trainer
    from repro_torch.utils.tree import tree_hash

    cfg = get_arch(arch).reduced()
    fails = [FailureEvent(t=5.0, node=0, predictable=True),
             FailureEvent(t=11.0, node=0, predictable=False)]
    ops.reset_launch_counts()
    for policy in policies:
        hashes, reps = [], []
        for name, failures in ((policy + "_ref", []), (policy, fails)):
            tr, _ = make_trainer(cfg, lr=1e-4, batch=2, seq=32, policy=name,
                                 ckpt_every=FT_CKPT_EVERY, trainer_seed=2, device="cuda")
            reps.append(_run(tr, FT_STEPS, failures, step_time_s=1.0))
            hashes.append(tree_hash(tr.state))
        rep = reps[1]
        print(f"ft reduced {arch} {policy} on {card}: migrations {rep.migrations} restores "
              f"{rep.restores} reexecuted {rep.steps_reexecuted} checkpoints {rep.checkpoints}; "
              f"final state == failure-free: {hashes[0] == hashes[1]}")
        if hashes[0] != hashes[1]:
            fail(f"ft reduced {arch} {policy}: the final state differs from the failure-free "
                 f"run's")
        if policy == "checkpoint" and rep.restores != 2:
            fail(f"ft reduced checkpoint: {rep.restores} restores, want 2")
        if policy != "checkpoint" and not (rep.migrations >= 1 and rep.steps_reexecuted <= 4):
            fail(f"ft reduced {policy}: migrations {rep.migrations}, reexecuted "
                 f"{rep.steps_reexecuted}")
    if arch != ARCH:
        counts = ops.launch_counts()
        print(f"ft reduced {arch}: launches {counts}")
        if not all(counts[name] for name in REDUCED_FT_KERNELS[arch]):
            fail(f"ft reduced {arch}: the {REDUCED_FT_KERNELS[arch]} kernels were not both "
                 f"launched: {counts}")
        return f32_launches(f"ft reduced {arch}")
    counts = f32_launches("ft reduced")
    if not all(counts.values()):
        fail(f"ft reduced: the float32 attention routes were not all launched: {counts}")
    return counts


def fig15_phase(card: str) -> None:
    """Fig 15's four states and the three-policy table on the card, through
    ``launch.fig15``: every check passing. Returns the float32 attention
    routes' launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch import fig15

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = fig15.main(["--device", "cuda", "--out", str(ROOT / "bench_out_torch")])
    print(f"fig15 on {card}: {time.perf_counter() - t0:.3f} s")
    if rc != 0:
        fail("fig15: a check failed")
    return f32_launches("fig15")


def full_width_ft(card: str) -> None:
    """One hybrid run of gemma-2b at full width and FT_FULL_LAYERS layers
    with a predicted failure, so one migration of the whole training state
    through host memory, against a failure-free run: the final states must
    be bit-identical."""
    import shutil

    from repro_torch.core.failure import FailureEvent
    from repro_torch.launch.train import make_trainer
    from repro_torch.utils.tree import tree_bytes, tree_hash

    cfg = train_config(ARCH, FT_FULL_LAYERS)
    print(f"ft full width: {train_label(cfg)}")
    hashes, reps = [], []
    fails = [FailureEvent(t=FT_FULL_FAIL_T, node=0, predictable=True, lead_s=FT_FULL_LEAD_S)]
    for policy, failures in (("hybrid_ref", []), ("hybrid", fails)):
        t0 = time.perf_counter()
        check_free_memory(f"ft full width {ARCH} {policy}")
        tr, _ = make_trainer(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, policy=policy,
                             ckpt_every=FT_FULL_STEPS, device="cuda")
        state_bytes = tree_bytes(tr.state)
        try:
            rep = tr.run(FT_FULL_STEPS, failures=failures)
        finally:
            shutil.rmtree(tr.store.root, ignore_errors=True)
        hashes.append(tree_hash(tr.state))
        reps.append(rep)
        moved = [e for e in rep.events if e.get("kind") == "predicted_failure_avoided"]
        print(f"ft full width {train_label(cfg)} {policy} on {card}: state "
              f"{state_bytes / 2**30:.2f} GiB, {rep.steps_run} steps, migrations "
              f"{rep.migrations}, checkpoints {rep.checkpoints}, train_time_s "
              f"{rep.train_time_s:.3f}, ft_time_s {rep.ft_time_s:.3f}, overhead_fraction "
              f"{rep.overhead_fraction:.6f}, moved {[(e['bytes'], round(e['migrate_s'], 3)) for e in moved]} "
              f"(bytes, s); {time.perf_counter() - t0:.1f} s in all")
        del tr
        free_device_memory()
    if reps[1].migrations != 1:
        fail(f"ft full width: {reps[1].migrations} migrations, want 1")
    if hashes[0] != hashes[1]:
        fail("ft full width: the migrated run's final state differs from the failure-free run's")
    print(f"ft full width: final state == failure-free run's ({hashes[0][:16]})")


def surface_library(kernel: str, batch: int, seq_len: int, heads: int, head_dim: int):
    """One PyTorch call computing a measured surface's function on its
    inputs (``obs/profile.py``'s cases: seed-0 numpy normals, float32, heads
    = KV heads): SDPA, causal, for flash_attention; SDPA with the cache's
    validity mask (every slot, ``pos = seq_len - 1``) for flash_decode."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.obs import profile

    rng, dev = np.random.default_rng(0), torch.device("cuda")
    if kernel == "decode_attention":
        q = profile._normal(rng, (batch, heads, head_dim), dev)[:, :, None]
        k = profile._normal(rng, (batch, heads, seq_len, head_dim), dev)
        v = profile._normal(rng, (batch, heads, seq_len, head_dim), dev)
        mask = torch.ones((batch, 1, 1, seq_len), dtype=torch.bool, device=dev)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    q, k, v = (profile._normal(rng, (batch, heads, seq_len, head_dim), dev) for _ in range(3))
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)


def surface_bound(kernel: str, batch: int, seq_len: int, heads: int, head_dim: int) -> dict:
    """A measured surface's bound at one shard (float32, heads = KV heads):
    decode reads one query row and the whole cache; prefill attention is
    causal, its products counted at the float32-accurate tensor-core rate."""
    elems = batch * heads * seq_len * head_dim
    if kernel == "decode_attention":
        return bound(4 * (2 * elems + 2 * batch * heads * head_dim),
                     4 * head_dim * seq_len * batch * heads, "float32")
    return bound(4 * 4 * elems, 4 * head_dim * seq_len * (seq_len + 1) // 2 * batch * heads,
                 "float32 3xTF32")


def workloads_phase(card: str) -> dict:
    """The measured step surfaces on the card: the CUDA attention kernels'
    launches on this path, per-shard step times, and one output per case
    against its plain version. Returns the float32 attention routes'
    launches (every surface is float32)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.obs import profile
    from repro_torch.workloads import registry as workloads

    expect = len(SURFACE_SHARDS) * (SURFACE_WARMUP + SURFACE_N)
    launches = {"flash_decode": 0, "flash_attention": 0}
    rows = []
    for name, kernel, counter, tol in (
            ("serve_decode", "decode_attention", "flash_decode", DECODE_TOL_F32),
            ("train_llm", "flash_attention", "flash_attention", TOL["float32"])):
        for batch, seq_len, heads, head_dim in SURFACE_SHAPES:
            ops.reset_launch_counts()
            rec = workloads.get(name).measured_step_surface(
                n_shards=SURFACE_SHARDS, batch=batch, seq_len=seq_len, heads=heads,
                head_dim=head_dim, n=SURFACE_N, warmup=SURFACE_WARMUP, device="cuda")
            counts = ops.launch_counts()
            launches[counter] += counts[counter]
            f32 = ops.f32_launch_counts()
            if name == "train_llm" and f32["flash_attention"] != counts[counter]:
                fail(f"workloads train_llm: {f32} float32 route launches of {counts[counter]}")
            others = {k: v for k, v in counts.items() if k != counter and v}
            if counts[counter] != expect or rec["launches"] != expect or others:
                fail(f"workloads {name} {(batch, seq_len, heads, head_dim)}: launches {counts} "
                     f"(record {rec['launches']}), want {counter} {expect} and no other")
            if rec["impl"] != "kernel" or rec["backend"] != "cuda" or rec["kernel"] != kernel:
                fail(f"workloads {name}: impl {rec['impl']}, backend {rec['backend']}")
            fn = profile._KERNEL_CASES[kernel][0](batch, seq_len, heads, head_dim,
                                                  torch.device("cuda"))
            got = fn()
            with ops.plain_versions():
                want = fn()
            err = compare(f"workloads {name} {kernel} f32 {(batch, seq_len, heads, head_dim)}",
                          got, want, tol)
            per_call = dict(kernel_ms=time_ms(fn),
                            library_ms=time_ms(surface_library(kernel, batch, seq_len, heads,
                                                               head_dim)))
            del fn, got, want
            torch.cuda.empty_cache()
            bnd = surface_bound(kernel, batch, seq_len, heads, head_dim)
            rows.append(dict(rec, max_abs_err=err, **per_call, **bnd))
            print(f"workloads {name} ({kernel}) batch {batch}, seq {seq_len}, heads {heads}, "
                  f"head_dim {head_dim}, f32 on {card}: per-shard step s at n_shards "
                  f"{rec['n_shards']}: {rec['step_time_s']}; {counts[counter]} launches; one "
                  f"call at 1 shard {per_call['kernel_ms']:.5f} ms, the library's "
                  f"{per_call['library_ms']:.5f} ms, bound {bnd['bound_ms']:.5f} by "
                  f"{bnd['bound_by']} at {bnd['bound_rate']}")
    print(json.dumps({"workloads": {"card": card, "surfaces": rows, "launches": launches}}))
    print(f"workloads: float32 route launches {{'flash_attention': "
          f"{launches['flash_attention']}}} (the train_llm surfaces)")
    return {"flash_attention": launches["flash_attention"], "flash_attention_bwd": 0}


def live_campaign(plan, injector: str, **daemon_kw):
    """One supervised campaign of real worker processes on the card: the
    report, the daemon, and the workers' last heartbeats and death
    certificates. Every worker is reaped however the run ends, and the
    spool is removed."""
    import shutil
    import tempfile

    from repro_torch.orchestrator.daemon import OrchestratorDaemon, SubprocessLauncher
    from repro_torch.orchestrator.spool import Spool

    root = tempfile.mkdtemp(prefix="chip_smoke_spool_")
    spool = Spool(root)
    launcher = SubprocessLauncher(spool, plan.workload, plan.seed,
                                  abort_after_s=WORKER_ABORT_S, device="cuda")
    daemon = OrchestratorDaemon(plan, spool, launcher, injector=injector,
                                deadline_wall_s=LIVE_DEADLINE_S, **daemon_kw)
    try:
        rep = daemon.run_sync()
        hbs = {wid: spool.read_heartbeat(wid) for wid in daemon.handles}
        finals = {wid: spool.read_final(wid) for wid in daemon.handles}
    finally:
        for handle in daemon.handles.values():
            handle.reap()
        shutil.rmtree(root, ignore_errors=True)
    return rep, daemon, hbs, finals


def live_checks(what: str, rep, daemon, hbs, finals, n_shards: int) -> None:
    """What every live campaign must show: it survived, one failure handled,
    a result from every shard, the engine's event order, no worker crashed
    (by its death certificate or its exit code), and every shard holder's
    heartbeats from the card."""
    from repro_torch.orchestrator import contract

    kinds = [e.kind for e in rep.trace.events] if rep.trace is not None else []
    if not rep.survived:
        fail(f"orchestrator {what}: campaign lost: {rep.to_dict()}")
    if rep.n_handled != 1 or sorted(rep.results) != list(range(n_shards)):
        fail(f"orchestrator {what}: {rep.n_handled} failures handled, results for shards "
             f"{sorted(rep.results)}: {rep.to_dict()}")
    if not all(k in kinds for k in ("failure", "verdict", "migrate")) or not (
            kinds.index("failure") < kinds.index("verdict") < kinds.index("migrate")):
        fail(f"orchestrator {what}: trace events {kinds}")
    for wid, handle in daemon.handles.items():
        code = handle.poll_exit()
        cause = (finals[wid] or {}).get("cause")
        if cause == "crashed" or code is None or contract.classify_exit(code) == "crashed":
            fail(f"orchestrator {what}: worker {wid} exit {code}, final {finals[wid]}")
    holders = {wid: hb for wid, hb in hbs.items() if hb is not None and hb["shard"] is not None}
    if len(holders) < n_shards or any(hb.get("device") != "cuda" for hb in holders.values()):
        fail(f"orchestrator {what}: shard holders' devices "
             f"{ {w: hb.get('device') for w, hb in holders.items()} }, want cuda")


def orchestrator_phase(card: str) -> dict:
    """The live orchestrator (``repro_torch.orchestrator``) supervising real
    worker processes on the card. (a) The genome live cert: the oracle picks
    the strategy, the kill injector SIGKILLs the tape's victim, the daemon
    migrates its shard, and the merged hits equal the plain search's on the
    CPU. (b) train_llm under the stall injector (SIGSTOP, reaped by the
    heartbeat stall detector), a pinned strategy: the plan's calibration
    launches the float32 flash-attention route, and every shard's final loss
    matches a failure-free run on the card. Returns the float32 attention
    routes' launches (the calibration's)."""
    import torch

    from repro_torch.data.genome import make_genome, search_chunk_plain
    from repro_torch.kernels import ops
    from repro_torch.orchestrator.plan import make_live_plan
    from repro_torch.orchestrator.worker import TrainProgram
    from repro_torch.scenarios import registry as scenarios

    out = {"card": card}

    # (a) the genome live cert, oracle-chosen strategy, kill injector
    ops.reset_launch_counts()
    t0_s = time.perf_counter()
    spec = scenarios.get(LIVE_SCENARIO)
    plan = make_live_plan(spec, time_scale=LIVE_TIME_SCALE, seed=0, strategy=None,
                          candidates=ORACLE_CANDIDATES, n_seeds=ORACLE_SEEDS, device="cuda")
    plan_s = time.perf_counter() - t0_s
    if not plan.scores or plan.workload != "genome_search":
        fail(f"orchestrator genome: plan {plan.to_dict()}")
    rep, daemon, hbs, finals = live_campaign(plan, "kill")
    live_s = time.perf_counter() - t0_s - plan_s
    live_checks("genome", rep, daemon, hbs, finals, spec.n_nodes)
    if rep.rel_err is None or rep.rel_err >= LIVE_REL_ERR:
        fail(f"orchestrator genome: live {rep.live_total_s} s against predicted "
             f"{rep.predicted_total_s} s, relative error {rep.rel_err} (limit {LIVE_REL_ERR})")
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"orchestrator genome: launched {counts}; the genome job runs none of the kernels")
    genome, patterns, _ = make_genome(length=2048 * spec.n_nodes * plan.n_steps, n_patterns=6,
                                      seed=plan.seed)
    want = set(search_chunk_plain(torch.from_numpy(genome), patterns))
    got = {tuple(h) for r in rep.results.values() for h in r["payload"]["hits"]}
    if got != want or not want:
        fail(f"orchestrator genome: {len(got)} merged hits, the plain search's {len(want)}, "
             f"{len(got ^ want)} differ")
    spawn = daemon.ready_s["first heartbeat"]
    warm = daemon.ready_s["warm"]
    print(f"orchestrator genome on {card}: oracle chose {plan.strategy} of "
          f"{list(ORACLE_CANDIDATES)} ({ {k: round(v['mean_s'], 3) for k, v in plan.scores.items()} } "
          f"mean s over {ORACLE_SEEDS} seeds); live {rep.live_total_s:.3f} s against predicted "
          f"{rep.predicted_total_s:.3f} s (sim), relative error {rep.rel_err:.5f}; "
          f"{rep.n_migrations} migrations, {len(got)} hits equal to the plain search's")
    print(f"orchestrator genome: spawn to first heartbeat s "
          f"{ {w: round(v, 3) for w, v in sorted(spawn.items())} }, to warm "
          f"{ {w: round(v, 3) for w, v in sorted(warm.items())} }; step wall s calibrated "
          f"{plan.calibration['step_wall_s']:.6f}, paced {plan.step_wall_s:.6f}; "
          f"plan {plan_s:.1f} s, live run {live_s:.1f} s")
    out["genome"] = dict(rep.to_dict(), strategy=plan.strategy, scores=plan.scores,
                         spawn_to_heartbeat_s=spawn, spawn_to_warm_s=warm,
                         calibrated_step_wall_s=plan.calibration["step_wall_s"],
                         paced_step_wall_s=plan.step_wall_s, plan_s=plan_s, live_s=live_s)

    # (b) train_llm under the stall injector, a pinned strategy
    ops.reset_launch_counts()
    t0_s = time.perf_counter()
    spec = scenarios.get(LIVE_SCENARIO)
    spec.workload = "train_llm"
    plan = make_live_plan(spec, time_scale=STALL_TIME_SCALE, seed=0, strategy=STALL_STRATEGY,
                          device="cuda")
    counts, f32 = ops.launch_counts(), ops.f32_launch_counts()
    surface = plan.calibration["surface"]
    if (surface["impl"], surface["backend"]) != ("kernel", "cuda") or not (
            counts["flash_attention"] == f32["flash_attention"] == surface["launches"] > 0):
        fail(f"orchestrator train_llm: calibration surface impl {surface['impl']}, backend "
             f"{surface['backend']}, {surface['launches']} launches; counts {counts}, "
             f"float32 routes {f32}")
    plan_s = time.perf_counter() - t0_s
    rep, daemon, hbs, finals = live_campaign(
        plan, "stall", stall_timeout_wall_s=STALL_STEPS * plan.step_wall_s)
    live_s = time.perf_counter() - t0_s - plan_s
    live_checks("train_llm", rep, daemon, hbs, finals, spec.n_nodes)
    if rep.n_stalls != 1:
        fail(f"orchestrator train_llm: {rep.n_stalls} stalls detected, want 1")
    losses = {}
    for shard, r in sorted(rep.results.items()):
        ref = TrainProgram(plan.seed, shard, device="cuda")
        for _ in range(plan.n_steps):
            ref.step()
        want, got = ref.result()["loss"], r["payload"]["loss"]
        if r["steps_done"] != plan.n_steps or abs(got - want) > TRAIN_LOSS_RTOL * abs(want):
            fail(f"orchestrator train_llm shard {shard}: loss {got} after {r['steps_done']} "
                 f"steps, failure-free {want}")
        losses[shard] = (got, want)
    spawn = daemon.ready_s["first heartbeat"]
    warm = daemon.ready_s["warm"]
    print(f"orchestrator train_llm (stall, {STALL_STRATEGY}) on {card}: live "
          f"{rep.live_total_s:.3f} s against predicted {rep.predicted_total_s:.3f} s (sim), "
          f"relative error {rep.rel_err:.5f}; {rep.n_stalls} stall reaped; losses against "
          f"failure-free { {k: (round(a, 8), round(b, 8)) for k, (a, b) in losses.items()} }")
    print(f"orchestrator train_llm: spawn to first heartbeat s "
          f"{ {w: round(v, 3) for w, v in sorted(spawn.items())} }, to warm "
          f"{ {w: round(v, 3) for w, v in sorted(warm.items())} }; step wall s calibrated "
          f"{plan.calibration['step_wall_s']:.6f}, paced {plan.step_wall_s:.6f}; calibration "
          f"surface {surface['kernel']} {surface['impl']} on {surface['backend']}, "
          f"{surface['launches']} launches, step s {surface['step_time_s']}; plan {plan_s:.1f} s, "
          f"live run {live_s:.1f} s")
    out["train_llm"] = dict(rep.to_dict(), strategy=plan.strategy, spawn_to_heartbeat_s=spawn,
                            spawn_to_warm_s=warm,
                            calibrated_step_wall_s=plan.calibration["step_wall_s"],
                            paced_step_wall_s=plan.step_wall_s, surface=surface,
                            losses=losses, plan_s=plan_s, live_s=live_s)
    print(json.dumps({"orchestrator": out}))
    return {"flash_attention": f32["flash_attention"], "flash_attention_bwd": 0}


def tp_config(arch: str, layers: int):
    """``arch`` at full width in float32 activations, its depth cut."""
    import dataclasses

    return dataclasses.replace(train_config(arch, layers), dtype="float32")


def tp_run(cfg, rules, dev, seed: int, plain: bool = False) -> dict:
    """One run of ``cfg`` on this rank's shards (all of it without rules):
    parameters from ``seed`` (float32 masters, the same draw on every rank,
    then cut as ``run_specs`` lays them out), the prefill of a TP_BATCH x
    TP_PROMPT prompt, TP_STEPS greedy decode steps, and the loss and its
    gradients on the prompt (the plain versions with ``plain``). Returns the
    logits, tokens, loss, gradients (by leaf path, this rank's shard) and
    the seconds of each part."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import map_specs
    from repro_torch.train.optim import _paths
    from repro_torch.utils.tree import flatten, unflatten

    model = build_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = model.init(g, dev, param_dtype=torch.float32)
    prompt = torch.randint(0, cfg.vocab, (TP_BATCH, TP_PROMPT), generator=g, device=dev)
    if rules is not None:
        specs = model.run_specs(rules)
        params = map_specs(lambda spec, t: rules.local_shard(t, spec).clone(), specs, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), ops.plain_versions() if plain else contextlib.nullcontext():
        logits, cache = model.prefill(params, prompt, rules, cache_len=TP_PROMPT + TP_STEPS)
        first, tokens = logits.cpu(), []
        for i in range(TP_STEPS):
            tok = logits.argmax(dim=-1)[:, None]
            tokens.append(tok[:, 0].cpu())
            logits, cache = model.decode(params, tok, TP_PROMPT + i, cache, rules)
    del cache
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with ops.plain_versions() if plain else contextlib.nullcontext():
        loss = model.loss(unflatten(treedef, live), {"tokens": prompt}, rules)
        grads = torch.autograd.grad(loss, live)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    names = ["/".join(path) for path, _ in _paths(unflatten(treedef, list(range(len(live)))))]
    order = [i for _, i in _paths(unflatten(treedef, list(range(len(live)))))]
    return {"logits": first, "tokens": torch.stack(tokens, 1), "loss": float(loss.detach()),
            "grads": {n: grads[i].cpu() for n, i in zip(names, order)},
            "serve_s": t1 - t0, "train_s": t2 - t1}


class _Float64Torch:
    """``torch`` with ``torch.float32`` read as ``torch.float64``: a module
    that names float32 for its arithmetic (norms, the RWKV group norm and
    wkv6's plain version, the cross-entropy) computes in float64 when its
    ``torch`` is this."""

    def __init__(self, torch):
        self._torch = torch

    def __getattr__(self, name):
        return self._torch.float64 if name == "float32" else getattr(self._torch, name)


@contextlib.contextmanager
def float64_plain_path():
    """The plain versions, with every float32 that the modules of the
    model's loss name read as float64 while it is open."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k_rmsnorm
    from repro_torch.kernels import rwkv6 as k_rwkv6
    from repro_torch.models import layers, model_api, rglru, rwkv6

    mods = (ops, k_rmsnorm, k_rwkv6, layers, model_api, rglru, rwkv6)
    saved = [m.torch for m in mods]
    for m in mods:
        m.torch = _Float64Torch(torch)
    try:
        with ops.plain_versions():
            yield
    finally:
        for m, t in zip(mods, saved):
            m.torch = t


@contextlib.contextmanager
def only_kernel(name: str):
    """Every kernel entry of ``kernels.ops`` but ``name`` (a forward, or a
    backward as "<kernel>_bwd") runs its plain version while this is open:
    which kernel carries a path's error."""
    from repro_torch.kernels import ops

    saved = []
    for table, suffix in ((ops._FWD, ""), (ops._BWD, "_bwd")):
        for kernel, impls in table.items():
            if kernel + suffix != name:
                saved.append((impls, impls["kernel"]))
                impls["kernel"] = impls["plain"]
    try:
        yield
    finally:
        for impls, fn in saved:
            impls["kernel"] = fn


def leaf_f64_check(cfg, dev, g_kernel, g_plain) -> None:
    """F64_LEAF's one-rank gradient (``tp_run``'s parameters and prompt,
    seed 5) on the kernel path and on the plain path, each against the same
    loss's gradient in float64 (the float32 parameters widened, the plain
    path in float64: ``float64_plain_path``). Prints each path's max error
    as a share of the float64 gradient's largest magnitude, and which is the
    larger; then the same for each of F64_LEAF_KERNELS alone on the kernel
    path (``only_kernel``)."""
    import dataclasses

    import torch

    from repro_torch.models import build_model
    from repro_torch.train.optim import _paths
    from repro_torch.utils.tree import flatten, unflatten

    model = build_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    params = model.init(g, dev, param_dtype=torch.float32)
    prompt = torch.randint(0, cfg.vocab, (TP_BATCH, TP_PROMPT), generator=g, device=dev)
    leaves, treedef = flatten(params)
    live = [p.detach().double().requires_grad_() for p in leaves]
    names = ["/".join(path) for path, _ in _paths(unflatten(treedef, list(range(len(live)))))]
    order = [i for _, i in _paths(unflatten(treedef, list(range(len(live)))))]
    index = order[names.index(F64_LEAF[1])]
    del params, leaves
    t0 = time.perf_counter()
    with float64_plain_path():
        model64 = build_model(dataclasses.replace(cfg, dtype="float64"))
        loss = model64.loss(unflatten(treedef, live), {"tokens": prompt})
        (g64,) = torch.autograd.grad(loss, [live[index]])
    g64 = g64.cpu()
    if g64.dtype != torch.float64 or not torch.isfinite(g64).all():
        fail(f"tp {F64_LEAF}: the float64 gradient is {g64.dtype}, finite "
             f"{bool(torch.isfinite(g64).all())}")
    scale = float(g64.abs().max())
    errs = {path: float((gr.double() - g64).abs().max()) / scale
            for path, gr in (("kernel", g_kernel), ("plain", g_plain))}
    # each kernel alone on the kernel path (the others' plain versions): the
    # one that carries the kernel path's error
    alone = {}
    for name in F64_LEAF_KERNELS:
        live32 = [p.detach().float().requires_grad_() for p in live]
        with only_kernel(name):
            loss32 = model.loss(unflatten(treedef, live32), {"tokens": prompt})
            (g32,) = torch.autograd.grad(loss32, [live32[index]])
        alone[name] = float((g32.double().cpu() - g64).abs().max()) / scale
    worse = max(errs, key=errs.get)
    print(f"  each kernel alone on the kernel path (the others plain), against float64: "
          f"{ {k: float(f'{v:.3g}') for k, v in alone.items()} }")
    print(f"tp {F64_LEAF[0]} {F64_LEAF[1]} against float64 (one rank, loss "
          f"{float(loss.detach()):.6f}, {time.perf_counter() - t0:.1f} s): kernel path "
          f"{errs['kernel']:.3g}, plain path {errs['plain']:.3g} of the float64 gradient's "
          f"largest magnitude {scale:.4g}; the {worse} path's error is the larger; kernel - plain "
          f"{float((g_kernel - g_plain).abs().max()) / scale:.3g}")
    del live, g64, loss
    free_device_memory()


def fsdp_run(cfg, rules, dev, seed: int) -> dict:
    """FSDP of the dense leaves on this rank (``rules``: fsdp=True over
    "data"): ``cfg``'s parameters from ``seed`` (float32 masters, the same
    draw on every rank), this rank's rows of a TP_BATCH x TP_PROMPT prompt
    through the prefill and FSDP_STEPS greedy decode steps, the loss and its
    gradients on the whole batch (each rank its rows), then one AdamW step
    with int8 compression and one Adafactor step; and the same without
    rules on this rank, against which each is held here (see FSDP_ARCH).
    Returns the readings: the largest differences, the bytes that the
    collectives gathered and scattered (``roofline.counter``), the
    seconds, the kernels' launches under the rules."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.model_api import _stacks_for
    from repro_torch.roofline.counter import StepCounter
    from repro_torch.sharding.rules import map_specs
    from repro_torch.train.optim import _paths, init_error_fb, make_optimizer
    from repro_torch.train.step import make_train_step, shard_state, state_specs
    from repro_torch.utils.tree import flatten, tree_map, unflatten

    model = build_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = model.init(g, dev, param_dtype=torch.float32)
    prompt = torch.randint(0, cfg.vocab, (TP_BATCH, TP_PROMPT), generator=g, device=dev)
    n = TP_BATCH // rules.axes["data"]
    d = rules.coordinate()["data"]
    rows = prompt[d * n:(d + 1) * n]
    specs = model.run_specs(rules)
    local = map_specs(lambda spec, t: rules.local_shard(t, spec).clone(), specs, params)
    out = {"seconds": {}, "launches": {}}

    def serve(p, r):
        with torch.no_grad():
            logits, cache = model.prefill(p, rows, r, cache_len=TP_PROMPT + FSDP_STEPS)
            first, tokens = logits.float().cpu(), []
            for i in range(FSDP_STEPS):
                tok = logits.argmax(dim=-1)[:, None]
                tokens.append(tok[:, 0].cpu())
                logits, cache = model.decode(p, tok, TP_PROMPT + i, cache, r)
        return first, torch.stack(tokens, 1)

    def grads(p, r, batch):
        leaves, treedef = flatten(p)
        live = [t.detach().requires_grad_() for t in leaves]
        loss = model.loss(unflatten(treedef, live), {"tokens": batch}, r)
        gs = torch.autograd.grad(loss, live)
        return float(loss.detach()), dict(_paths(unflatten(treedef, list(gs))))

    def step(kind: str, compress: bool, r):
        scfg = dataclasses.replace(cfg, optimizer=kind)
        smodel = build_model(scfg)
        ts, _ = make_train_step(smodel, rules=r, lr=FSDP_LR, grad_compression=compress)
        stacks = _stacks_for(scfg)
        opt_init, _ = make_optimizer(kind, stacks)
        st = {"params": tree_map(lambda t: t.clone(), params), "opt": opt_init(params),
              "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if compress:
            st["efb"] = init_error_fb(params, stacks)
        if r is not None:
            st = shard_state(smodel, r, st)
            st = {k: v if k == "step" else tree_map(lambda t: t.clone(), v)
                  for k, v in st.items()}
        new, m = ts(st, {"tokens": prompt if r is None else rows})
        return float(m["loss"]), new

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_logits, want_tokens = serve(params, None)
    want_loss, want_grads = grads(params, None, prompt)
    torch.cuda.synchronize()
    out["seconds"]["one rank serve and grads"] = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with StepCounter() as c_serve:
        logits, tokens = serve(local, rules)
    torch.cuda.synchronize()
    out["seconds"]["fsdp serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with StepCounter() as c_train:
        loss, got_grads = grads(local, rules, rows)
    torch.cuda.synchronize()
    out["seconds"]["fsdp loss and grads"] = time.perf_counter() - t0
    out["launches"] = ops.launch_counts()
    out["bytes"] = {what: {k: v["operand_bytes"] for k, v in c.stats()["collectives"].items()
                           if v["count"]} for what, c in (("serve", c_serve),
                                                          ("loss and grads", c_train))}
    out["logits"] = float((logits - want_logits).abs().max())  # both this rank's rows
    out["tokens_equal"] = bool(torch.equal(tokens, want_tokens))
    out["loss"] = abs(loss - want_loss) / abs(want_loss)
    flat_specs = dict(_paths(specs))
    worst, where = 0.0, ""
    for path, gr in got_grads.items():
        w = rules.local_shard(want_grads[path], flat_specs[path])
        rel = float((gr - w).abs().max()) / max(float(want_grads[path].abs().max()), 1e-30)
        if rel > worst:
            worst, where = rel, "/".join(path)
    out["grads"] = (worst, where)
    # the elements of this rank's shards whose one-rank gradient lies within
    # its error of zero (their sign is noise)
    near0 = {path: rules.local_shard(g1, flat_specs[path]).abs()
             <= TP_GRAD_RTOL * float(g1.abs().max()) for path, g1 in want_grads.items()}
    del got_grads, want_grads
    free_device_memory()

    # the steps: AdamW with int8 compression, then Adafactor, each from the
    # same state with and without rules
    for kind, compress in (("adamw", True), ("adafactor", False)):
        label = f"{kind}{' int8' if compress else ''}"
        t0 = time.perf_counter()
        ref_loss, ref = step(kind, compress, None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with StepCounter() as c_step:
            got_loss, new = step(kind, compress, rules)
        torch.cuda.synchronize()
        out["seconds"][f"fsdp {label} step"] = time.perf_counter() - t1
        out["seconds"][f"one rank {label} step"] = t1 - t0
        out["bytes"][f"{label} step"] = {k: v["operand_bytes"] for k, v in
                                         c_step.stats()["collectives"].items() if v["count"]}
        sspec = state_specs(build_model(dataclasses.replace(cfg, optimizer=kind)), rules,
                            compress)
        res = {"loss": abs(got_loss - ref_loss) / abs(ref_loss)}
        flipped = {}  # leaf -> the elements whose int8 rounding went the other way
        for key in ("efb", "opt"):
            key_specs, key_ref = dict(_paths(sspec.get(key, {}))), dict(_paths(ref.get(key, {})))
            for path, t in _paths(new.get(key, {})):
                w = rules.local_shard(key_ref[path], key_specs[path])
                scale = max(float(key_ref[path].abs().max()), 1e-30)
                if key == "efb":
                    # one int8 step of the leaf: the largest |g + e| / 127, which the
                    # error feedback bounds by half a step from below
                    step_ = 2 * scale
                    err = (t - w).abs()
                    flipped[path] = err > 0.5 * step_
                    flips = int(flipped[path].sum())
                    res["efb flips"] = res.get("efb flips", 0) + flips
                    rest = float(torch.where(err > 0.5 * step_, 0.0, err).max()) / (127 * step_)
                    res["efb"] = max(res.get("efb", 0.0), rest)
                    res["efb over a step"] = max(res.get("efb over a step", 0.0),
                                                 float(err.max()) / step_)
                    continue
                if path[-1] == "v" and kind == "adamw":
                    continue  # the second moment, a square of the first's gradient
                err = (t - w).abs()
                if path[:-1] in flipped:  # a flipped element's moment moves by 0.1 step
                    err = torch.where(flipped[path[:-1]], 0.0, err)
                rel = float(err.max()) / scale
                limit = 2 * TP_GRAD_RTOL if path[-1] in ("vr", "vc", "v") else TP_GRAD_RTOL
                res[f"{path[-1]}"] = max(res.get(path[-1], 0.0), rel / limit)
        worst_move, ref_params, first = 0.0, dict(_paths(ref["params"])), dict(_paths(params))
        for path, t in _paths(new["params"]):
            w = rules.local_shard(ref_params[path], flat_specs[path])
            err = float((t - w).abs().max())
            if kind == "adamw":
                ratio = err / (2 * FSDP_LR)
            else:
                # where the gradient is within its error of zero the update
                # may change sign (a factor of size 1 makes it sign(g))
                moved = max(float((ref_params[path] - first[path]).abs().max()), 1e-30)
                diff, zero = (t - w).abs(), near0[path]
                ratio = max(float(torch.where(zero, 0.0, diff).max()) / (FSDP_ADAFACTOR_RTOL
                                                                         * moved),
                            float(torch.where(zero, diff, 0.0).max()) / (FSDP_SIGN_FLIP * moved))
                flips = int((zero & (diff > FSDP_ADAFACTOR_RTOL * moved)).sum())
                res["sign flips"] = res.get("sign flips", 0) + flips
            if ratio >= worst_move:
                worst_move, res["params at"] = ratio, "/".join(path)
        res["params"] = worst_move
        out[label] = res
        del ref, new, ref_params, first
        free_device_memory()
    return out


def _tp_rank(rank: int, tmp: str) -> None:
    """One of TP_RANKS processes on the card: a gloo group through a file
    store, a check that gloo runs every collective of the split on CUDA
    tensors (``gloo_on_cuda``), the (1, TP_RANKS) mesh, every TP_ARCHS run
    on its shards under a profiler; its results, launch counts and the
    profiler's kernels by name saved to ``tmp``."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import MeshRules

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=TP_RANKS)
    try:
        gloo_on_cuda()
        rules = MeshRules(make_host_mesh(1, TP_RANKS, "cuda"))
        out = {"coord": rules.coordinate(), "runs": {}}
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for arch, layers in TP_ARCHS:
                out["runs"][arch] = tp_run(tp_config(arch, layers), rules, dev, seed=5)
                free_device_memory()
        out["launches"] = ops.launch_counts()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        out["profiled"] = {k: sum(any(p in n for p in pats) for n in names)
                           for k, pats in TP_KERNEL_NAMES.items()}
        del prof
        frules = MeshRules(make_host_mesh(TP_RANKS, 1, "cuda"), fsdp=True)
        t0 = time.perf_counter()
        out["fsdp"] = fsdp_run(tp_config(*FSDP_ARCH), frules, dev, seed=5)
        out["fsdp"]["seconds"]["all"] = time.perf_counter() - t0
        out["fsdp"]["coord"] = frules.coordinate()
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def gloo_on_cuda() -> None:
    """Each collective kind the split uses, once on CUDA tensors through the
    job's gloo group: a gloo build that does not take CUDA tensors for one
    of them fails here, by name, before the runs."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size()
    x = torch.ones(4 * n, device="cuda")
    tries = {"all-reduce": lambda: dist.all_reduce(x.clone()),
             "all-gather": lambda: dist.all_gather_into_tensor(x.new_empty(4 * n * n), x),
             "reduce-scatter": lambda: dist.reduce_scatter_tensor(x.new_empty(4), x)}
    for kind, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError, TypeError, NotImplementedError) as e:
            fail(f"tp phase: gloo does not run {kind} on CUDA tensors: {e}")


def tp_slice_check(dev) -> None:
    """The kv heads a rank's q heads read, where the heads split over
    "model" and the kv heads do not, reach the kernels as a view of the
    whole (B, S, K, hd) projection or cache (``models.layers._select``): its
    base moves by whole heads and its strides are the whole tensor's. Here
    each attention kernel, forward and backward, at head dim 64 and 128 in
    bf16 and float32, runs on a view of kv head 3 of 8 and must give the
    same bits as on a contiguous copy of it (no kernel refuses or copies
    it into another result)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.layers import _select

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (64, 128):
            B, S, H, K = 2, 256, 4, 8
            q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
            kv = [torch.randn((B, S, K, hd), generator=g, device=dev).to(dtype)
                  for _ in range(2)]
            view = [_select(t, (3, 1), 2).transpose(1, 2) for t in kv]
            copy = [v.contiguous() for v in view]
            qt = q.transpose(1, 2)
            outs = []
            for k, v in (view, copy):
                qg, kg, vg = (t.detach().requires_grad_() for t in (qt, k, v))
                o = ops.flash_attention(qg, kg, vg, causal=True)
                grads = torch.autograd.grad(o.float().square().sum(), (qg, kg, vg))
                outs.append((o.detach(), *grads))
            kpos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
            dec = [ops.flash_decode(q[:, -1], k, v, kpos, S - 1) for k, v in (view, copy)]
            same = all(torch.equal(a, b) for a, b in zip(*outs)) and torch.equal(*dec)
            if not same:
                fail(f"tp: the kernels on a kv-head view ({dtype}, hd {hd}) differ from a copy")
    print("tp: flash_attention (forward, backward) and flash_decode on kv-head views at an "
          "offset give the bits of a contiguous copy (bf16, float32; hd 64, 128)")


def tp_phase(card: str) -> dict:
    """The "model"-axis split on the card: TP_RANKS processes share the one
    H100 in a (1, TP_RANKS) mesh. NCCL refuses two ranks on one device, so
    they join a gloo group, which runs the all-reduce, all-gather and
    reduce-scatter on the CUDA tensors themselves (``gloo_on_cuda`` checks
    each first). Each TP_ARCHS config at
    full width in float32, depth cut, runs on each rank's shards as
    ``run_specs`` lays them out, and the same run on one rank without rules
    here first: the ranks' prefill logits within TP_LOGITS_TOL of it, the
    greedy tokens of TP_STEPS decode steps equal, the loss within
    TP_LOSS_RTOL relative, each gradient leaf (the rank's shard) within
    TP_GRAD_RTOL of the leaf's largest magnitude. On every rank each of the
    nine kernels launches (its counter) and shows in a profiler trace by
    name. Returns the ranks' launches, summed."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import MeshRules, MeshShape

    check_free_memory("the tp phase")
    dev = torch.device("cuda", 0)
    tp_slice_check(dev)
    want, noise = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # the ranks start (their torch import, their CUDA context) while the
        # one-rank runs take the card here
        ctx = mp.spawn(_tp_rank, args=(tmp,), nprocs=TP_RANKS, join=False)
        for arch, layers in TP_ARCHS:
            want[arch] = tp_run(tp_config(arch, layers), None, dev, seed=5)
            free_device_memory()
            plain = tp_run(tp_config(arch, layers), None, dev, seed=5, plain=True)
            noise[arch] = {n: float((g - want[arch]["grads"][n]).abs().max())
                           for n, g in plain["grads"].items()}
            if arch == F64_LEAF[0]:
                free_device_memory()
                leaf_f64_check(tp_config(arch, layers), dev, want[arch]["grads"][F64_LEAF[1]],
                               plain["grads"][F64_LEAF[1]])
            del plain
            print(f"tp {arch} ({layers} layers) one rank: prefill + {TP_STEPS} decode "
                  f"{want[arch]['serve_s']:.3f} s, loss and grads {want[arch]['train_s']:.3f} s")
            free_device_memory()
        while not ctx.join():
            pass
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(TP_RANKS)]
    print(f"tp phase on {card}: {TP_RANKS} ranks in {time.perf_counter() - t0:.1f} s; gloo ran "
          f"the all-reduce, all-gather and reduce-scatter on CUDA tensors")
    launches = {}
    for r in ranks:
        rules = MeshRules(MeshShape(("data", "model"), (1, TP_RANKS)))
        for arch, layers in TP_ARCHS:
            got, ref = r["runs"][arch], want[arch]
            tag = f"tp {arch} rank {r['coord']['model']}"
            err = float((got["logits"] - ref["logits"]).abs().max())
            if not err <= TP_LOGITS_TOL:
                fail(f"{tag}: prefill logits {err:.3g} from one rank's > {TP_LOGITS_TOL}")
            if not torch.equal(got["tokens"], ref["tokens"]):
                fail(f"{tag}: greedy tokens {got['tokens'].tolist()} vs one rank's "
                     f"{ref['tokens'].tolist()}")
            loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
            if not loss_err <= TP_LOSS_RTOL:
                fail(f"{tag}: loss {got['loss']} vs one rank's {ref['loss']}")
            specs = dict(_tp_paths(build_model(tp_config(arch, layers)).run_specs(rules)))
            worst, where, over = 0.0, "", []
            for name, g in got["grads"].items():
                w = rules.local_shard(ref["grads"][name], specs[name], r["coord"])
                if tuple(g.shape) != tuple(w.shape):
                    fail(f"{tag}: gradient {name} {tuple(g.shape)}, its shard {tuple(w.shape)}")
                scale = max(float(ref["grads"][name].abs().max()), 1e-30)
                rel = float((g - w).abs().max()) / scale
                if rel > max(TP_GRAD_RTOL, 2 * noise[arch][name] / scale):
                    over.append(f"{name} {rel:.3g} (float32 noise {noise[arch][name] / scale:.3g})")
                if rel > worst:
                    worst, where = rel, f"{name}, float32 noise {noise[arch][name] / scale:.3g}"
            if over:
                fail(f"{tag}: gradients from one rank's beyond {TP_GRAD_RTOL} of their largest "
                     f"magnitude and twice their float32 noise: {over}")
            print(f"{tag} of {TP_RANKS}: prefill logits {err:.3g}, tokens equal over "
                  f"{TP_STEPS} steps, loss rel {loss_err:.3g}, worst gradient {worst:.3g} of "
                  f"its largest magnitude ({where}); prefill + decode {got['serve_s']:.3f} s, "
                  f"loss and grads {got['train_s']:.3f} s (the ranks share the card)")
        missing = [k for k, n in r["launches"].items() if n == 0]
        unseen = [k for k, n in r["profiled"].items() if n == 0]
        if missing or unseen:
            fail(f"tp rank {r['coord']['model']}: no launch of {missing}, not in the trace "
                 f"{unseen}")
        print(f"tp rank {r['coord']['model']}: launches {r['launches']}; profiler kernels by "
              f"name {r['profiled']}")
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
        fsdp_check(card, r["fsdp"])
        for k, n in r["fsdp"]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    del want, ranks
    free_device_memory()
    ops.reset_launch_counts()
    return launches


def fsdp_check(card: str, r: dict) -> None:
    """One rank's ``fsdp_run`` readings, printed, then held to FSDP_ARCH's
    limits."""
    tag = f"tp fsdp {FSDP_ARCH[0]} ({FSDP_ARCH[1]} layers) rank {r['coord']['data']}"
    worst, where = r["grads"]
    print(f"{tag} of {TP_RANKS} on {card}: prefill logits {r['logits']:.3g}, tokens equal "
          f"{r['tokens_equal']} over {FSDP_STEPS} steps, loss rel {r['loss']:.3g}, worst gradient "
          f"{worst:.3g} of its largest magnitude ({where}); adamw int8 step {r['adamw int8']}; "
          f"adafactor step {r['adafactor']} (shares of their limits; efb flips = elements "
          f"whose int8 rounding went the other way); bytes gathered / scattered "
          f"{json.dumps(r['bytes'])}; seconds "
          f"{json.dumps({k: round(v, 3) for k, v in r['seconds'].items()})}; launches "
          f"{r['launches']}")
    if not (r["logits"] <= TP_LOGITS_TOL and r["tokens_equal"] and r["loss"] <= TP_LOSS_RTOL
            and worst <= TP_GRAD_RTOL):
        fail(f"{tag}: prefill logits, tokens, loss or gradients beyond the tp limits "
             f"({TP_LOGITS_TOL}, equal, {TP_LOSS_RTOL}, {TP_GRAD_RTOL}) against one rank")
    for label in ("adamw int8", "adafactor"):
        res = r[label]
        over = {k: v for k, v in res.items() if k not in ("loss", "efb flips", "efb",
                                                          "efb over a step", "params at",
                                                          "sign flips") and v > 1.0}
        if res["loss"] > TP_LOSS_RTOL or over or res.get("efb", 0.0) > TP_GRAD_RTOL \
                or res.get("efb over a step", 0.0) > 1.5:
            fail(f"{tag} {label} step against one rank: beyond its limits {over or res}")
    missing = [k for k in ("rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd",
                           "flash_decode") if not r["launches"].get(k)]
    if missing:
        fail(f"{tag}: no launch of {missing} under the FSDP rules")


def _tp_paths(specs):
    from repro_torch.train.optim import _paths

    return [("/".join(path), spec) for path, spec in _paths(specs)]


def dryrun_start() -> list:
    """Starts ``python -m repro_torch.launch.dryrun`` on each of
    DRYRUN_CELLS, a subprocess each, all at once (fake tensors over a fake
    process group of 256 or 512 ranks; the card is hidden from them; they
    run on the host's cores while the card does other work). Any still
    running when the script exits are killed."""
    import atexit
    import os

    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    procs = []
    for arch, shape, mesh, variant in DRYRUN_CELLS:
        out = ROOT / "build" / "dryrun" / f"{arch}.{shape}.{mesh}.{variant}.json"
        procs.append((f"{arch} {shape} {mesh} {variant}", out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", mesh, "--variant", variant, "--out", str(out)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=env)))
    atexit.register(lambda: [p.kill() for *_, p in procs if p.poll() is None])
    return procs


def dryrun_phase(card: str, procs: list) -> None:
    """The dry-run cells that ``dryrun_start`` started: each must write its
    record; the peak GB a device and the three roofline terms are printed,
    analytic from the H100's data-sheet peaks (989 TFLOP/s bf16, 3.35 TB/s,
    450 GB/s a link direction), not measured."""
    for cell, out, proc in procs:
        try:
            _, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for *_, p in procs:
                p.kill()
            fail(f"dryrun {cell}: over {DRYRUN_TIMEOUT_S} s")
        if proc.returncode != 0:
            fail(f"dryrun {cell}: exit {proc.returncode}: {err[-2000:]}")
        r = json.loads(out.read_text())
        if "roofline" not in r:
            fail(f"dryrun {cell}: no roofline in {r}")
        rf, mem = r["roofline"], r["memory"]
        print(f"dryrun {cell} (host of {card}; analytic, H100 data-sheet peaks, not measured): "
              f"arguments {mem['argument_bytes'] / 1e9:.4f} GB, peak "
              f"{mem['peak_per_device'] / 1e9:.3f} GB a device (fits 80 GB: "
              f"{mem['fits_hbm']}), compute {rf['compute_s']:.5f} s, memory "
              f"{rf['memory_s']:.5f} s, collective {rf['collective_s']:.5f} s, bottleneck "
              f"{rf['bottleneck']}, useful FLOP ratio {r['useful_compute_ratio']:.4f}, traced in "
              f"{r['trace_s']:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch/csrc beside {Path(__file__).name}: run it from the repository")
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0_s = time.perf_counter()
    _build.lib()  # compiles the sources on first use, then loads the library
    build_s = time.perf_counter() - t0_s
    print(f"build: {build_s:.1f} s -> {_build.library_path().relative_to(ROOT)}")
    ptxas_report(_build.library_path(), "flash_tc_kernel")
    spill_check(_build.library_path())
    ptxas_report(_build.library_path(), "decode_kernel")
    ptxas_report(_build.library_path(), "rglru_kernel")
    ptxas_report(_build.library_path(), "wkv6_kernel")
    sass_check(_build.library_path())
    seconds = {}

    def lap(phase: str) -> None:
        """Adds the seconds since the last lap (the build's start) to ``phase``."""
        nonlocal t0_s
        now = time.perf_counter()
        seconds[phase] = seconds.get(phase, 0.0) + now - t0_s
        t0_s = now

    lap("build and checks")

    rows = kernel_phase(dev)
    lap("kernels")
    auto_moe = moe_layer_phase(dev, card)
    lap("moe layer")
    # the float32 attention routes' launches, summed over the paths that run them
    f32 = {"flash_attention": 0, "flash_attention_bwd": 0}

    def add_f32(counts):
        for name, n in counts.items():
            f32[name] += n

    # the dry-run cells run on the host's cores from here, beside the card's phases
    dry = dryrun_start()
    mesh_counts, mesh_f32 = mesh_phase(dev, card, auto_moe)
    add_f32(mesh_f32)
    lap("mesh")
    tp_phase(card)
    lap("tp")
    dryrun_phase(card, dry)
    lap("dryrun")
    launches = {r["name"]: 0 for r in rows}  # summed over the serve, mesh and train runs
    for name, n in mesh_counts.items():
        launches[name] += n
    for arch, prompt_len in SERVES:
        t1_s = time.perf_counter()
        counts, logits = serve_phase(arch, prompt_len, card)
        for name, n in counts.items():
            launches[name] += n
        if arch == ARCH:
            bf16_cache_logits = logits
        del logits
        print(f"serve {arch}: {time.perf_counter() - t1_s:.1f} s")
    t1_s = time.perf_counter()
    counts, int8_logits = serve_phase(ARCH, PROMPT, card, changes=INT8)
    for name, n in counts.items():
        launches[name] += n
    int8_against_bf16_cache(int8_logits, bf16_cache_logits)
    del int8_logits, bf16_cache_logits
    print(f"serve {ARCH} int8 cache: {time.perf_counter() - t1_s:.1f} s")
    t1_s = time.perf_counter()
    counts, _ = serve_phase(KIMI, PROMPT, card, changes=KIMI_SERVE,
                            moe_route_kernels=auto_moe["route_kernels"])
    for name, n in counts.items():
        launches[name] += n
    print(f"serve {KIMI}: {time.perf_counter() - t1_s:.1f} s")
    lap("serve")
    for arch, prompt_len in SERVES:
        t1_s = time.perf_counter()
        add_f32(full_width_f32_phase(dev, arch, prompt_len))
        print(f"full-width f32 {arch}: {time.perf_counter() - t1_s:.1f} s")
    add_f32(reduced_reference_phase(dev))
    lap("serve f32 checks")
    train_counts, train_f32 = train_phase(dev, card)
    for name, n in train_counts.items():
        launches[name] += n
    add_f32(train_f32)
    lap("train")
    paper_phase(card)
    lap("paper")
    figures_phase(card)
    lap("figures")
    campaign_phase(card)
    lap("campaign")
    add_f32(workloads_phase(card))
    lap("workloads")
    check_free_memory("the orchestrator phase")
    add_f32(orchestrator_phase(card))
    lap("orchestrator")
    print(f"float32 route launches: {f32} (float32 serve checks, reduced FT, fig15, "
          f"train_llm surfaces, the orchestrator's train_llm calibration)")

    for r in rows:
        # a float32 attention row counts its route's launches on the float32 paths
        r["launches"] = (f32 if r.get("f32_route") else launches)[r["name"]]
        if r["launches"] == 0:
            fail(f"{r['name']} {r['shape']}: no launch on the paths that run it")
    keys = ("name", "route", "source", "replaces", "shape", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "bound_rate", "library_ms",
            "library_device_ms")
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, "
          f"{sum(seconds.values()):.1f} s in all")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
