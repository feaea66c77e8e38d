#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (into ``build/repro_torch/``), one nvcc per source, all at once.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths (the lookup and its backward bit for bit, the
   k-means assignment by the tie-tolerant rule, one column a launch, the
   four columns of a table in one, and every chunk shape the transition
   launches) and times kernel, plain
   version and a library call that computes the same function (the
   lookup at the LM's table and at the wide widths with the L2 flushed
   before each call, as a serving caller finds the table).
3. Trains the full-width Criteo DLRM configuration (26 features, 33.7M ids,
   random weights from a seed) for 8 steps at batch 2048, holding the
   first step against the same step on CPU copies of the state; runs one
   CCE clustering transition with the optimizer moments remapped (checked
   for its invariants and for bitwise repeatability); trains 4 more steps;
   then serves the trained state through ``DLRMServeEngine.update_state``.
   Then trains it model-parallel (``shard_train``): a (1, 1) mesh of one
   NCCL rank, ``launch.train.build_dlrm_sharded_trainer`` at k_multiple 4
   (k_pad 308), 4 steps with the lookup routed by all-to-all, a sharded
   transition, 2 steps, held bit for bit against the 1-device step and
   serial transition; the 4-shard route emulated in one process (each
   shard's lookup and backward at k_loc 77, summed and concatenated)
   held bit for bit against the unsharded launches, and timed.  Then the
   (data, model) mesh (``mesh``) on a world of one NCCL rank: command-r-35b
   at full width cut to 8 of its 40 layers through
   ``launch.steps.build_serve_step`` (4 prompts of 16-1900 tokens, each
   prefilled alone into its row, 16 batched ticks), every logit and cache
   leaf held bit for bit against ``lm.prefill``/``lm.decode_step``, and a
   2-layer cut against CPU copies; 4 model ranks emulated in one process on
   its first layer, token table and head (each rank's flash heads, MLP
   slices, lookup slice and head scores through ``models/lm.py``'s share
   functions, gathered and summed in rank order) against the unsharded
   layer, flash and the lookup timed for a rank's slice and the whole; and
   ``build_train_step`` on a 2-layer float32 cut (2 x 1024 tokens) held
   bit for bit against the unsharded step.  The other families on the
   same mesh: paligemma-3b, musicgen-medium and phi3.5-moe ((e)-(g)),
   hymba-1.5b at 8 of 32 layers (prompts on both sides of its 1024-token
   window) and xlstm-1.3b at 16 of 48 ((h)), each served bit for bit,
   trained on a float32 cut bit for bit, its model ranks emulated (hymba's
   uneven whole KV groups at 2 and 4 ranks) and its kernels timed at a
   rank's shapes.
4. Runs the paper's training loop at that width through
   ``launch.train.build_dlrm_trainer``: a ``Trainer`` with the sketch
   frequency tracker (cell count in the step, host fold on a background
   thread), the entropy/drift trigger beside a periodic fallback,
   telemetry, a run log and async checkpoints, for 32 steps (windows of 8
   batches) with up to 2 transitions.  Holds one step's in-step sketch
   delta against the host cell count; crashes a second run at step 28,
   restores and resumes it, and holds it bit for bit against the first;
   restores the card's last checkpoint into a CPU Trainer; serves a batch
   with the trained tracker's heads in the hot cache.  Then times the
   step against the plain step, and the Trainer's own loop with the fold
   on its thread, on the step's thread and without a tracker.
5. Serves freshly initialised weights through ``DLRMServeEngine``
   (submit/step/drain), the serving path of the first slice.
6. Trains the paper's comparison methods (full, hashing trick, CE, hash
   embeddings, ROBE, DHE, TT-Rec) at that width, 8 steps each, the first
   against the same step on CPU copies; holds the lookup kernels at the
   hashing trick's and CE's supertable shapes against their plain
   versions and times them; serves both through ``DLRMServeEngine``;
   product-quantises the full run's largest table through the assignment
   kernel; runs least-squares CCE (Algorithms 1 and 2) at Figure 1b's
   scale against Theorem 3.1's bound.
7. Holds the flash-attention kernel against its plain version (float32
   and bfloat16 at both CTA heights, GQA and plain heads, hymba's group
   of 5 among them, D 64 and 128, ragged lengths, causal and not; and
   paligemma-3b's MQA heads at D 256, 64-row CTAs; musicgen-medium's 24
   MHA heads of 64) and times it beside ``scaled_dot_product_attention`` at
   the LM's prefill buckets and at hymba-1.5b's, paligemma-3b's,
   phi3.5-moe's and musicgen-medium's heads.
8. Serves full-width qwen2-1.5b (28 layers, CCE token table and factored
   CCE head, random weights from a seed) through the LM ``ServeEngine``:
   16 requests of 16-1900 prompt tokens over 8 slots, 16 greedy tokens
   each; holds a 2-layer cut's prefill logits and cache against CPU copies.
9. Serves full-width hymba-1.5b (32 layers of sliding-window attention
   beside a selective-SSM branch, CCE token table and factored CCE head,
   random weights from a seed) the same way: prompts past the 1024-token
   window take the windowed ``_sdpa``, the others flash; holds a 2-layer
   cut's prefill past the window and 4 decode steps over the ring (logits,
   ring k/v, SSM and conv states) against CPU copies; times the SSM scan's
   share of a prefill and the lookup at hymba's table.
10. Serves full-width paligemma-3b (18 layers, MQA at head_dim 256, a GELU
   MLP, a CCE token table that is also the head, random weights from a
   seed) the same way, text only, prompts padded into buckets: the flash
   kernel at D 256 in every prefill; holds each request alone against
   itself in the batch by its prefill logits, a 2-layer cut's prefill, 4
   decode steps and a forward with 256 patch embeddings prepended
   against CPU copies, and the lookup at paligemma's table (dsub 512).
11. Serves full-width xlstm-1.3b (48 blocks: 6 superblocks of 7 chunkwise
   mLSTM blocks and one recurrent sLSTM block, no attention, CCE token
   table and factored CCE head, random weights from a seed) the same way,
   prompts unpadded, the recurrent states in the cache: no flash; holds
   each request alone against itself in the batch, a cut of the first
   mLSTM and sLSTM blocks (a 300-token prefill, the last mLSTM chunk
   ragged, then 4 decode steps: logits and every state) against CPU
   copies; times the sLSTM blocks' share of a prefill and the lookup at
   xlstm's table (dsub 512).
12. Trains full-width qwen2-1.5b through ``launch.train.build_lm_trainer``
   (adamw, cosine schedule, remat, a dense token tracker): 3 steps of 2 x
   4096 tokens, the CCE token table's transition (the assignment kernel
   over all 151,936 ids at d=384), 2 steps; holds the lookup backward at a
   step's token rows and the assignment at the transition's inputs
   against their plain versions; holds a 2-layer cut's first loss and
   gradients against CPU copies, and its runs (one crashed and resumed)
   against each other bit for bit.
13. Trains full-width xlstm-1.3b the same way, cut to 3 of its 6
   superblocks (24 of 48 blocks): 1 step of 2 x 4096 tokens
   (traced), the token table's transition (the assignment over all 50,304
   ids at d=512), 1 step (timed); the sLSTM blocks' share of the step; the
   kernels at the step's token rows and the transition's inputs; the
   first mLSTM and sLSTM blocks' first loss and gradients against CPU
   copies (bfloat16 against the CPU's float32), and their runs against
   each other bit for bit.
14. Serves phi3.5-moe-42b-a6.6b at full width (d 4096, 32 query heads over
   8 KV heads of 128, 16 experts of d_ff 6400 top-2 at capacity 1.25, CCE
   token table and factored CCE head at dsub 1024, random weights from a
   seed), cut to 8 of its 32 layers, through the LM ``ServeEngine`` with the
   LM traffic, prompts padded into buckets (run before item 12, as
   ``moe_serve``): flash in every prefill, the einsum route over the whole
   padded prompt, every expert on every decode token; holds each request
   alone against itself in the batch (its tokens up to its first decode
   step routed otherwise), a cut's prefill and 4 decode steps against CPU
   copies with every routing decision traced (2 layers in float32, every
   decision equal; the first layer in bfloat16, the flips counted and only
   what none reached compared), the lookup at its table in float32 and
   bfloat16 bit for bit; times the MoE layers' share of a prefill's and a
   tick's busy.
15. Runs musicgen-medium at full width and depth (48 layers, d 1536, 24
   MHA heads of 64, 4 codebooks of 2048 summed at the input and predicted
   by 4 heads, a full table, layernorm, GELU, sinusoidal positions,
   random weights from a seed) through ``lm.prefill`` and
   ``lm.decode_step`` (the engine takes no codebook model, as in JAX;
   ``audio_serve``, run before item 12): 8 requests of 16-1500 frames,
   each prefilled alone into its own row of an 8-row cache, then 16
   batched greedy ticks: flash in every prefill; holds the longest request
   alone against its row, a 2-layer cut's prefill and 4 decode steps
   against CPU copies; then trains the reduced CCE model through
   ``launch.train.main`` as a user runs it (both lookup kernels, the
   assignment), holding each kernel at its shapes there.
Each path runs with the launch counts reset just before it and read just
after.  Prints the kernels' JSON line, the card line and, last,
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --phases flash,lm_serve

runs only the named phases (of lookup, bwd, kmeans, train, shard_train, mesh, loop,
serve, methods, flash, lm_serve, hybrid_serve, vlm_serve, xlstm_serve, moe_serve,
audio_serve, lm_train, xlstm_train)
and prints neither result line.

Exits non-zero, with no result line, when there is no CUDA device, when the
port is missing, or when any phase fails.  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import concurrent.futures
import gc
import json
import math
import multiprocessing
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
H100_SM_HZ = 1.98e9  # the SM's boost clock, H100 SXM data sheet
FADD_CYCLES = 4  # latency of a dependent float32 add on the SM (Hopper)
SERVE_BATCH = 256
SERVE_BATCHES = 4  # host-side id sampling over 10M-row vocabularies costs ~1 s a batch
TRAIN_BATCH = 2048
TRAIN_STEPS = 8  # before the transition
POST_STEPS = 4  # after it
TRAIN_LR = 0.05  # constant, with momentum 0.9 and clip 1.0
LOOP_STEPS = 24  # the loop phase's run, cut in depth
LOOP_WINDOW = 8  # tracker window in batches (the deployment's STREAM has 256)
LOOP_CLUSTER_EVERY = 24  # the periodic fallback beside the trigger: the run's last step
LOOP_CLUSTER_MAX = 1  # one a run: a full-width transition costs ~11 s of host on an H100 machine
LOOP_CKPT_EVERY = 8
LOOP_KEEP_LAST = 2
LOOP_FAIL_AT = 20  # the crash run's injected failure: restores step 16, transitions after
LOOP_SEED = 4
LOOP_TIMED_STEPS = 16  # each unsynchronised Trainer run of the loop's timing
SHARD_STEPS = 4  # the model-parallel trainer's steps before its transition
SHARD_POST = 2  # and after it
SHARD_ROUTE = 4  # model shards of the route emulated in one process (and CONFIG's k_multiple)
SHARD_SEED = 5
SHARD_TIMED = 5  # synchronised steps a timing of the sharded and the 1-device step
MESH_ARCH = "command-r-35b"  # the mesh phase's LM, at full width
MESH_SEED = 6
MESH_SERVE_LAYERS = 8  # (a): 8 of its 40 layers, 22.6 GB of float32 weights beside the tables
MESH_PROMPT_LENS = (16, 640, 1281, 1900)  # (a): each prefilled alone into its cache row
MESH_TICKS = 16  # (a): batched decode ticks after the prefills
MESH_MAX_SEQ = 2048
MESH_CUT_PROMPT = 64  # (a): the 2-layer cut's prompt, card vs CPU (the CPU's bf16 is slow)
MESH_CUT_DECODE = 2
MESH_RANKS = 4  # (b): the model ranks emulated in one process
MESH_LAYER_SEQ = 512  # (b): the emulated layer's prompt (float32)
MESH_TIMED_B = (2048, 8)  # (b): the lookup's rows, a prefill's tokens and a decode tick's
MESH_TRAIN_LAYERS = 2  # (c): build_train_step's cut, float32
MESH_TRAIN_SEQ = 1024  # (c): one micro-batch of 2 x 1024 tokens
MESH_TRAIN_BATCH = 2
MESH_TRAIN_STEPS = 2  # the schedule's first lr is 0: the second step moves the params
# (e)-(g): the vlm, audio and moe families on the mesh, at full width
MESH_FAMILIES = ("paligemma-3b", "musicgen-medium", "phi3.5-moe-42b-a6.6b")
# (e): their depth, full but for phi3.5-moe's 2 of 32 layers (10.4 GB of float32)
MESH_FAMILY_LAYERS = {"phi3.5-moe-42b-a6.6b": 2}
MESH_FAMILY_TICKS = 8  # (e): batched decode ticks after MESH_PROMPT_LENS' prefills
MESH_EP_RANKS = 4  # (f): phi3.5-moe's data ranks emulated, 4 of its 16 experts each
MESH_EP_ROWS = 4  # (f): rows of the MoE layer's input, each one moe_group of 2048 tokens
MESH_MOE_TRAIN_LAYERS = 2  # (g): phi3.5-moe's cut, float32: ~42 GB of state and gradients
# (h): the hybrid and xlstm families: each served at full width cut to these layers
MESH_RECURRENT = {"hymba-1.5b": 8, "xlstm-1.3b": 16}  # of 32 and of 48 (2 of 6 superblocks)
MESH_RECURRENT_TICKS = 4
MESH_RECURRENT_TRAIN = {"hymba-1.5b": (2, 512), "xlstm-1.3b": (8, 256)}  # (layers, seq), f32
MESH_RECURRENT_RANKS = {"hymba-1.5b": (2, 4), "xlstm-1.3b": (4,)}  # model ranks emulated
MESH_RECURRENT_SEQ = 512  # the emulated cut's prompt, within hymba's window (flash)
MESH_RANK_FLASH_S = 1024  # hymba's flash at a rank's heads: its window
MESH_RANK_ROWS = (2048, 8)  # the lookup at a rank's dsub slice: a prefill's and a tick's rows
LOOKUP_BATCHES = (1, 7, SERVE_BATCH, TRAIN_BATCH, 4096)
BWD_BATCHES = (256, TRAIN_BATCH, 4096)
LM_DSUB = 384  # the LM token table's sub-row width (qwen2-1.5b: d 1536 over c=4)
# other widths of both lookup kernels: (c, T, k, dsub) -> the layout each
# dtype takes; the first is the LM token table's shape, the fourth the
# hashing trick's supertable (HASH_SHAPE), the seventh a narrow one with two
# sub-tables and two row ranges a column (k > 512), the last phi3.5-moe's
# token table (rows of 4 KB in float32)
WIDE_LOOKUP = {
    (4, 2, 4748, LM_DSUB): {"float32": "wide_vector", "bfloat16": "wide_vector"},
    (26, 2, 305, 36): {"float32": "wide_vector", "bfloat16": "wide_scalar"},
    (26, 2, 305, 6): {"float32": "wide_scalar", "bfloat16": "wide_scalar"},
    (26, 1, 500, 16): {"float32": "narrow", "bfloat16": "narrow"},
    (26, 1, 500, 8): {"float32": "narrow", "bfloat16": "wide_vector"},
    (26, 1, 500, 64): {"float32": "narrow", "bfloat16": "narrow"},
    (26, 2, 1000, 16): {"float32": "narrow", "bfloat16": "narrow"},
    (4, 2, 1002, 1024): {"float32": "wide_vector", "bfloat16": "wide_vector"},
}
HASH_SHAPE = (26, 1, 500, 16)  # emb_method="hash" on CONFIG: the narrow layout's main path
# the wide backward (a sort, then a walk) at the token tables of the LM
# training slices still to come, on a training step's token rows
# (lm_step_rows): name -> (architecture, (c, T, k, dsub) its table has);
# hymba-1.5b's dsub 400 is a d tail past three 128-float slices
WIDE_BWD_TABLES = {"hymba": ("hymba-1.5b", (4, 2, 1000, 400)),
                   "paligemma": ("paligemma-3b", (4, 2, 8038, 512))}
WIDE_BWD_RAGGED = 5003  # a batch that is not a whole number of sort chunks (1024)
WIDE_BATCHES = (1, 8, TRAIN_BATCH)
ASSIGN_SHAPES = ((1 << 18, 250, 4), (64000, 250, 4))  # an assign_all chunk; a Lloyd sample
ASSIGN_BATCHED = (4, 1 << 18, 250, 4)  # (c, n, k, d): an assign_all chunk of a c=4 table
# (c, n, k, d, ties planted) off the d = 4 kernel, through the tiled one: hymba-1.5b's token
# table (a d tail past the 32-float step), paligemma-3b's (n cut to 2^16), n on either side of
# 40 CTAs of 128 points with k one past 9 tiles of 128 centroids, d 3 (4-byte copies) and 16,
# and d = 4 one centroid past the d = 4 kernel's slots (kmeans_assign.FAST_MAX_K + 1)
ASSIGN_GENERAL = (
    (4, 32001, 1000, 400, False),
    (4, 1 << 16, 8038, 512, False),
    (2, 128 * 40 + 1, 128 * 9 + 1, 64, True),
    (2, 128 * 40 - 1, 128 * 9 + 1, 64, True),
    (2, 5000, 250, 3, False),
    (2, 3000, 40, 16, False),
    (2, 4096, 2457, 4, False),
)
ASSIGN_LM_TABLE = (4, 151936, 4748, 384)  # qwen2-1.5b's token table (c, n, k, d), timed
ASSIGN_PALIGEMMA_TABLE = (4, 257216, 8038, 512)  # paligemma-3b's, timed (cdist a column a call)
ASSIGN_RTOL = 1e-5  # the plain distance of the kernel's pick vs the plain minimum
STEP_RTOL = 1e-4  # card vs CPU, per leaf, relative to the leaf's largest magnitude
# (H, KVH): qwen2-1.5b, qwen3-4b/14b style, no GQA, hymba-1.5b (a group of 5)
FLASH_HEADS = ((12, 2), (32, 8), (4, 4), (25, 5))
FLASH_DIMS = (64, 128)
FLASH_LENGTHS = (1, 7, 127, 128, 129, 1000, 2048)  # Sq = S, causal
FLASH_NONCAUSAL = ((129, 129), (1000, 1000), (129, 300))  # (Sq, S) without the causal mask
FLASH_STRIDED = 129  # the causal case at this length reads q from a (B, H, S, D) layout
FLASH_TIMED = (128, 512, 1024, 2048)  # bf16, qwen2-1.5b's heads: the LM's prefill buckets
FLASH_HYMBA_TIMED = (128, 512, 1024)  # bf16, hymba-1.5b's heads at D 64: its flash prefills
# (H, KVH, D): paligemma-3b, MQA (a group of 8) at head_dim 256, the only D of
# 256 the repo's configurations use; held over FLASH_LENGTHS and FLASH_NONCAUSAL
# alone, not crossed with FLASH_HEADS, and timed at FLASH_TIMED
FLASH_PALIGEMMA = (8, 1, 256)
FLASH_MOE = (32, 8, 128)  # (H, KVH, D) of phi3.5-moe-42b-a6.6b, timed at FLASH_TIMED
FLASH_MUSICGEN = (24, 24, 64)  # musicgen-medium's MHA: checked, and timed at FLASH_TIMED
# kernel vs plain on unit-normal inputs: float32 sums in another order;
# bfloat16 rounds P to bf16 for the tensor cores and the output once
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# bfloat16, each row's error over that row's scale (flash_row_err): a late causal
# row averages ~1/sqrt(i) and is small against FLASH_TOL, but rounding P to bf16
# leaves every row ~2^-9 of its own scale, at any length; a key masked wrongly on
# late rows gives > 0.1 (tests/test_torch_flash.py emulates both on the CPU)
FLASH_ROW_TOL = 2 ** -6
LM_ARCH = "qwen2-1.5b"
LM_SEED = 0
LM_REQUESTS = 16
LM_MAX_BATCH = 8
LM_MAX_SEQ = 2048
LM_PROMPTS = (16, 1900)  # prompt lengths, uniform: buckets 16..2048
LM_MAX_TOKENS = 16
LM_CHECK_LAYERS = 2  # the depth of the card-vs-CPU prefill check
LM_CHECK_PROMPT = 256
HYBRID_ARCH = "hymba-1.5b"  # served like LM_ARCH (LM_PROMPTS, LM_MAX_SEQ, slots, tokens)
HYBRID_CHECK_PROMPT = 1100  # the cut's prompt: past the 1024-token window, ragged to 256
HYBRID_CHECK_DECODE = 4  # decode steps of the cut after its prefill
VLM_ARCH = "paligemma-3b"  # served like LM_ARCH (LM_PROMPTS, LM_MAX_SEQ, slots, tokens)
VLM_CHECK_DECODE = 4  # decode steps of the cut after its LM_CHECK_PROMPT prefill
HYBRID_IDLE_PREFILLS = (1024, 1900)  # the longest flash prefill; one past the window
XLSTM_ARCH = "xlstm-1.3b"  # served like LM_ARCH (LM_PROMPTS, LM_MAX_SEQ, slots, tokens)
XLSTM_CHECK_PROMPT = 300  # the cut's prompt: a 256-token mLSTM chunk and a ragged one
XLSTM_CHECK_DECODE = 4
XLSTM_IDLE_PREFILLS = (256, 1900)  # one mLSTM chunk; about the longest prompt
MOE_ARCH = "phi3.5-moe-42b-a6.6b"  # served like LM_ARCH (LM_PROMPTS, LM_MAX_SEQ, slots, tokens)
# its depth, cut from 32 layers: a layer holds 1.30 B float32 params (5.2 GB: 16
# experts of 3 x 4096 x 6400), so 8 hold 41.6 GB and leave room on an 80 GB card for
# each use's bf16 casts of the experts (2.5 GB a layer), the cache and what earlier
# phases leave allocated
MOE_LAYERS = 8
# the depth of its card-vs-CPU cut (lm_cut_check) in each dtype: in bfloat16 a
# routing flip at layer 0 reaches every later position from layer 1 on, the last
# position's logits with it (on an H100 at 2 layers: 17 flips in 520 decisions, and
# no bf16 logits left to compare), so bfloat16 runs the first layer alone
MOE_CHECK_LAYERS = {"float32": 2, "bfloat16": 1}
MOE_CHECK_DECODE = 4
MOE_IDLE_PREFILLS = (LM_MAX_SEQ, 1900)  # a whole bucket; the longest prompt's length
# bfloat16 routing decisions of the cut that may differ between the card and the
# CPU, as a share of its (token, layer) decisions: the router's product rounds to
# bf16 on either side after another summation order, and a near tie then picks
# another expert.  tools/probe_moe_flips.py on an H100 (8 prompts of 256 tokens,
# layer 0): card vs CPU 0.0117-0.0234 of the tokens, the CPU's own bf16 vs its f32
# 0.0117-0.0430, float32 card vs CPU none; the limit is about twice the largest
MOE_FLIP_SHARE = 0.05
# card vs CPU prefill logits, relative to the largest logit: float32 sums
# in other orders; bfloat16 also rounds every activation (8 mantissa bits)
LM_LOGIT_RTOL = {"float32": 1e-4, "bfloat16": 3e-2}
# musicgen-medium (the audio_serve phase): 8 requests of 4 codebook streams
# whose prompts have 16-1500 frames (1500 frames are 30 s of EnCodec at 50
# Hz), each prefilled alone into its own row of an 8-row cache, then
# batched greedy decode ticks, every row at its own position
AUDIO_ARCH = "musicgen-medium"
AUDIO_REQUESTS = 8
AUDIO_PROMPTS = (16, 1500)  # frames, uniform
AUDIO_MAX_SEQ = 2048
AUDIO_TICKS = 16
AUDIO_CHECK_DECODE = 4  # decode steps of the cut after its LM_CHECK_PROMPT prefill
# the launcher as a user runs it: the reduced CCE model (transitions at steps 2 and 4)
AUDIO_LAUNCHER = ("--arch", AUDIO_ARCH, "--steps", "4", "--cluster-every", "2")
# LM training (launch.train.build_lm_trainer): train_4k's 256 sequences of
# 4096 tokens in microbatches of 32 (src/repro/launch/shapes.py) cut to one
# microbatch of 2: at 32 the float32 logits alone take 80 GB
LM_TRAIN_BATCH = 2
LM_TRAIN_SEQ = 4096
LM_TRAIN_STEPS = 3  # then the token table's transition
LM_TRAIN_POST = 2  # steps after it
LM_TRAIN_LR = 1e-3  # adamw's peak under the cosine schedule (the launcher's default)
LM_TRAIN_WARMUP = 2
LM_CUT_SEQ = 256  # the LM_CHECK_LAYERS cut's sequences: card vs CPU, repeats
LM_CUT_STEPS = 4  # the cut's runs: 4 steps, a transition, 2 steps
# xlstm-1.3b's training (the xlstm_train phase): train_4k's length, one
# microbatch; a step is ~20 s of host (the sLSTM's loops over 6 x 4096
# steps), so few steps: the first traced (the step's busy and top kernels),
# the one after the transition timed.  Cut to 3 of its 6 superblocks (24 of 48
# blocks, each at full width) for the script's time since the mesh phase.  The
# init draws every mLSTM block before the sLSTM blocks, so this depth also picks
# the 2-block cut's weights: at 16 blocks its bfloat16 check fails (the mLSTM's
# bf at 1.63 x the CPU's own error; tools/probe_bf16_grads.py --layers 16)
XLSTM_TRAIN_LAYERS = 24
XLSTM_TRAIN_BATCH = 2
XLSTM_TRAIN_STEPS = 1  # then the token table's transition
XLSTM_TRAIN_POST = 1
# card vs CPU loss of the cut's first step, relative, and every gradient
# leaf, relative to the leaf's largest magnitude: float32 sums in other
# orders; bfloat16 rounds every activation.  The bfloat16 limits stand
# above an H100's readings (PERF.md): the loss 6.2e-6, the worst leaf
# 8.6e-3, about one bfloat16 rounding (2^-7)
LM_LOSS_RTOL = {"float32": STEP_RTOL, "bfloat16": 1e-3}
LM_GRAD_RTOL = {"float32": STEP_RTOL, "bfloat16": 3e-2}
# the xlstm family's bfloat16 gradients: its recurrences carry each
# rounding through every later step, so the card's and the CPU's bfloat16
# drift apart by more than LM_GRAD_RTOL (wq 0.0378 on an H100) while each
# stays near float32.  A leaf of the card's bfloat16 is held against the
# CPU's float32 within the larger of LM_GRAD_RTOL and this many times the
# CPU's own bfloat16 error of that leaf: the card about as accurate as the
# CPU.  An H100's leaves read 0.91-1.27 times the CPU's (1.45 with cuBLAS's
# reduced-precision reductions off; tools/probe_bf16_grads.py), and both
# sides repeat bit for bit
BF16_OWN_RATIO = 1.5
# a gradient leaf that is float noise -> the leaf whose largest magnitude it
# is held against instead of its own: the mLSTM's output is invariant to a
# shift of every input gate (the normaliser divides it out), so the
# input-gate bias's gradient sum_t dL/di_t vanishes but for rounding, while
# the input-gate weights' sum_t x_t dL/di_t does not
NOISE_GRAD_SCALE = {"['blocks']['mlstm']['bi']": "['blocks']['mlstm']['wi']"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def reset_peak() -> int:
    """Resets the card's peak-memory counter and returns the bytes
    allocated at the reset: a peak is reported less it (what earlier
    phases left allocated would count otherwise), beside the raw peak."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, *, iters: int = 200, reps: int = 5, warmup: int = 10) -> float:
    """Median over ``reps`` of CUDA-event time per call, over ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _profile(fn, iters: int, flush=None):
    """torch.profiler's per-name averages over ``iters`` calls of ``fn``
    (after one warm-up call), each after a call of ``flush`` where one is
    given.  A trace may come back with fewer records than the calls made,
    or with none: the callers take it again over more calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def _device_us(event) -> float:
    return getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0.0)


_L2_BYTES = 128 << 20  # over twice the H100's 50 MB L2
_l2_flush = {}


def l2_flush():
    """(flush, counts): ``flush()`` reads a buffer of _L2_BYTES, so that
    the call after it finds its inputs in HBM, not in the L2, as a caller
    does whose other work streams through the L2 between calls (an LM's
    weights between two prefills).  It sums rows of 4096 floats, one
    kernel with no memset, and writes 32 KB; ``counts`` holds its launches
    a call by kernel name."""
    import torch

    if not _l2_flush:
        buf = torch.ones((_L2_BYTES // 4 // 4096, 4096), device="cuda")

        def flush():
            buf.sum(dim=1)

        counts = {}
        for n_calls in (100, 400, 1600):
            counts = {e.key: round(e.count / n_calls) for e in _profile(flush, n_calls)
                      if _device_us(e) and round(e.count / n_calls)}
            if counts:
                break
        check(bool(counts), "three traces of the L2 flush hold none of its kernels")
        _l2_flush.update(flush=flush, counts=counts)
    return _l2_flush["flush"], _l2_flush["counts"]


# The profiler drops records now and then, up to a few dozen a trace of any
# length (PERF.md section 7), so device_ms and device_busy_ms take traces of
# at least TRACE_RECORDS records, and take one that lacks too many again
# over four times as many calls, at most three times.
TRACE_RECORDS = 400


def device_ms(fn, kernel_name: str, *, iters: int = TRACE_RECORDS,
              cold: bool = False) -> float:
    """Device time a call of ``fn`` spent in the CUDA kernel whose name
    holds ``kernel_name`` (launched once a call), from torch.profiler over
    ``iters`` calls; with ``cold``, every call comes after ``l2_flush``.
    Where the trace lacks launches the time is the mean over those it
    holds, with a line that says so, and one that holds fewer than nine
    tenths is taken again.  Fails where a trace holds more than one a call,
    or none holds nine tenths, so that a renamed kernel cannot lose its
    time without a word."""
    flush = l2_flush()[0] if cold else None
    for attempt in range(4):
        n_calls = iters * 4 ** attempt
        hits = [e for e in _profile(fn, n_calls, flush) if kernel_name in e.key and e.count]
        n = sum(e.count for e in hits)
        us = sum(_device_us(e) for e in hits)
        check(n <= n_calls, f"{n} launches of *{kernel_name}* in {n_calls} calls")
        if n >= n_calls - n_calls // 10 and us > 0:
            if n < n_calls:
                print(f"chip_smoke: the trace holds {n} of {n_calls} launches of "
                      f"*{kernel_name}*; its time is their mean", flush=True)
            return us / 1e3 / n
        print(f"chip_smoke: trace {attempt + 1} holds {n} launches of *{kernel_name}* in "
              f"{n_calls} calls; taken again", flush=True)
    check(False, f"four traces without one launch of *{kernel_name}* a call")


def device_busy_ms(fn, *, iters: int = 5, cold: bool = False) -> float:
    """Device time of every CUDA kernel and copy that a call of ``fn``
    runs, from torch.profiler over at least ``iters`` (and 5) calls, as
    many more as TRACE_RECORDS needs; with ``cold``, every call comes after
    ``l2_flush``, whose kernels are not counted.  Each kernel counts as its
    mean time a record times its launches a call, the trace's count over
    the calls rounded; a line says when the trace lacks records, and one
    that lacks more than a tenth is taken again, over more calls where the
    trace took less than a second."""
    flush, flushed = l2_flush() if cold else (None, {})
    n_calls = max(iters, 5)
    for attempt in range(5):
        us = lost = want = 0
        t0 = time.perf_counter()
        for e in _profile(fn, n_calls, flush):
            check(e.count <= flushed.get(e.key, 1 << 60) * n_calls,
                  f"the call launches {e.key[:80]}, a kernel of the L2 flush")
            per_call = round(e.count / n_calls)
            if e.key not in flushed and per_call and _device_us(e):
                us += _device_us(e) / e.count * per_call
                lost += max(0, per_call * n_calls - e.count)
                want += per_call * n_calls
        if want >= TRACE_RECORDS and lost <= want // 10:
            if lost:
                print(f"chip_smoke: the trace lacks {lost} of {want} records; each kernel's "
                      f"time is its mean over those it holds", flush=True)
            return us / 1e3
        if lost or not want:
            print(f"chip_smoke: a trace of {n_calls} calls lacks {lost} of {want} records"
                  f"{'' if want else ' (it holds no device activity)'}; taken again", flush=True)
        if time.perf_counter() - t0 < 1.0:  # a second or more of calls: take as many again
            n_calls = max(4 * n_calls, -(-TRACE_RECORDS * n_calls // want) if want else 0)
    check(False, "five traces without nine tenths of their records")


def device_busy_long(fn) -> tuple[float, dict]:
    """Device time of every CUDA kernel and copy in one call of ``fn``
    (the caller has made one before: no warm-up here), summed from the
    profiler's raw records: for calls of 10^5-10^6 launches (an xLSTM
    prefill's or training step's sLSTM loops), whose ``key_averages``
    would take minutes to build.  Prints the trace's kernel records beside
    the launches the host made, and fails where it holds fewer than nine
    tenths of them or none.  Returns (ms, {name: (ms, records)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    ns = kernels = launches = 0
    by_name = collections.defaultdict(lambda: [0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not getattr(e, "is_user_annotation", lambda: False)():
                name = e.name()
                ns += e.duration_ns()
                by_name[name][0] += e.duration_ns()
                by_name[name][1] += 1
                kernels += "memcpy" not in name.lower() and "memset" not in name.lower()
        elif "LaunchKernel" in e.name():
            launches += 1
    check(kernels > 0 and kernels >= launches - launches // 10,
          f"a one-call trace holds {kernels} kernel records of {launches} launches")
    print(f"chip_smoke: one-call trace of {kernels} kernel records ({launches} launches), "
          f"read in {time.perf_counter() - t0:.3f} s", flush=True)
    return ns / 1e6, {k: (v[0] / 1e6, v[1]) for k, v in by_name.items()}


def device_busy_long_ms(fn) -> float:
    """``device_busy_long``'s ms."""
    return device_busy_long(fn)[0]


def cl_path(t) -> str:
    """The layout both lookup kernels take for rows along the last dim of
    ``t`` (a table or an upstream gradient) at its address."""
    from repro_torch.kernels import cce_lookup as cl

    return cl.lookup_path(t.shape[-1], t.element_size(), t.data_ptr())


def lookup_kernel(entry: str, t) -> str:
    """The CUDA function that ``entry`` launches for the float tensor
    ``t`` (outputs are fresh allocations, so aligned)."""
    return f"{entry}_{cl_path(t)}_kernel"


def lookup_case(collection, B: int, dtype, seed: int, device="cuda"):
    """idx and tables at the supertable's shape, in the serving layout
    (rows (B, c, T) seen as a (c, B, T) view).  Columns of full tables
    carry -1 in their second slot, as host translation gives them; on top,
    10% random -1 sentinels and 5% rows at or past k."""
    import numpy as np
    import torch

    from repro_torch.core.embeddings import FullTable

    (g,) = collection.univ_groups
    grp = collection.groups[g]
    c, T, k, dsub = grp.n_cols, grp.n_tables, grp.k_pad, grp.dsub
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, k, (B, c, T)).astype(np.int32)
    full_col = np.array([isinstance(collection.tables[f], FullTable)
                         for f in collection.rows_col_feature])
    rows[:, full_col, 1] = -1
    u = rng.random((B, c, T))
    rows[u < 0.10] = -1
    rows[(u >= 0.10) & (u < 0.15)] = k + rng.integers(0, 3 * k, int(((u >= 0.10) & (u < 0.15)).sum()))
    tables = torch.from_numpy(rng.normal(size=(c, T, k, dsub)).astype(np.float32))
    idx = torch.from_numpy(rows).to(device).movedim(0, 1)  # (c, B, T), strided
    return idx, tables.to(device=device, dtype=dtype)


def lookup_bound(idx, tables):
    """Least time for the lookup on an H100: bytes it must move (idx read
    once, the distinct rows this data gathers read once, the output written
    once) over the memory rate, against its float adds over the float32
    rate.  Returns (ms, "bytes" | "operations")."""
    import torch

    c, B, T = idx.shape
    k, dsub, esize = tables.shape[2], tables.shape[3], tables.element_size()
    r = idx.to(torch.int64)
    valid = (r >= 0) & (r < k)
    key = (torch.arange(c, device=r.device)[:, None, None] * T
           + torch.arange(T, device=r.device)[None, None, :]) * k + r
    n_rows = int(torch.unique(key[valid]).numel())
    n_bytes = B * c * T * 4 + n_rows * dsub * esize + B * c * dsub * esize
    n_ops = int(valid.sum()) * dsub
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def embedding_bag_args(idx, tables):
    """The same lookup as one F.embedding_bag(mode="sum") over the
    flattened slab: one bag per (b, column) holding its valid rows."""
    import torch

    c, B, T = idx.shape
    k = tables.shape[2]
    r = idx.movedim(0, 1).to(torch.int64)  # (B, c, T)
    flat = (torch.arange(c, device=r.device)[None, :, None] * T
            + torch.arange(T, device=r.device)[None, None, :]) * k + r
    valid = (r >= 0) & (r < k)
    counts = valid.sum(-1).reshape(-1)
    offsets = torch.zeros_like(counts)
    offsets[1:] = torch.cumsum(counts, 0)[:-1]
    return flat[valid], tables.reshape(-1, tables.shape[3]), offsets


def random_lookup(c: int, T: int, k: int, dsub: int, B: int, dtype, seed: int, device="cuda",
                  offset: int = 0):
    """idx and tables of one shape, in the serving layout (the (c, B, T)
    view of (B, c, T) rows) with 10% -1 sentinels and 5% rows at or past
    k; ``offset`` > 0 starts the tables that many elements into their
    storage, so that they are not aligned."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, k, (B, c, T)).astype(np.int32)
    u = rng.random((B, c, T))
    rows[u < 0.10] = -1
    rows[(u >= 0.10) & (u < 0.15)] = k + 7
    n = c * T * k * dsub
    flat = torch.from_numpy(rng.normal(size=n + offset).astype(np.float32))
    tables = flat.to(device=device, dtype=dtype)[offset:].view(c, T, k, dsub)
    return torch.from_numpy(rows).to(device).movedim(0, 1), tables


def wide_lookup_cases(card: str, device="cuda") -> float:
    """The lookup at widths other than the Criteo supertable's dsub=4: the
    LM token table's 384, 36 and 6, and the narrow layout's 16 (the
    hashing trick's, and at T=2, k=1000), 8 and 64, at B in WIDE_BATCHES,
    on strided idx;
    float32 bit for bit, bfloat16 within one bf16 step; each takes the
    layout ``lookup_path`` names for it, and an unaligned table takes
    wide_scalar.  Times the largest batch with the L2 flushed before each
    call, beside ``embedding_bag`` (float32), flushed the same way.
    Returns the largest float32 error."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    max_err = 0.0
    for (c, T, k, dsub), paths in WIDE_LOOKUP.items():
        for dtype, offset in ((torch.float32, 0), (torch.bfloat16, 0), (torch.float32, 1)):
            dn = str(dtype).split(".")[-1]
            path = paths[dn] if not offset else "wide_scalar"
            for B in WIDE_BATCHES:
                idx, tables = random_lookup(c, T, k, dsub, B, dtype, seed=dsub * 10 + B,
                                            device=device, offset=offset)
                check(cl_path(tables) == path,
                      f"dsub={dsub} {dn} offset {offset} does not take {path}")
                got = cl.cce_lookup_fwd(idx, tables)
                want = ref.cce_lookup_ref(idx, tables)
                err = (got.float() - want.float()).abs().max().item()
                if dtype == torch.float32:
                    check(torch.equal(got, want),
                          f"f32 kernel != plain at dsub={dsub} B={B} {path} (max err {err})")
                    max_err = max(max_err, err)
                else:
                    check(torch.allclose(got.float(), want.float(), rtol=2**-7, atol=0.0),
                          f"bf16 kernel vs plain beyond 2^-7 relative at dsub={dsub} B={B}")
            dev = device_ms(lambda: cl.cce_lookup_fwd(idx, tables),
                            lookup_kernel("cce_lookup_fwd", tables), cold=True)
            bound, bound_by = lookup_bound(idx, tables)
            line = (f"[{card}] cce_lookup_fwd c={c} T={T} k={k} dsub={dsub} {dn} {path}: equal to "
                    f"plain at B={WIDE_BATCHES}; B={B} L2 flushed: device_ms={dev!r} "
                    f"bound_ms={bound!r} ({bound_by})")
            if dtype == torch.float32:
                bag, weight, offsets = embedding_bag_args(idx, tables)
                lib_dev = device_busy_ms(
                    lambda: F.embedding_bag(bag, weight, offsets, mode="sum"), iters=20, cold=True)
                line += f" library_device_ms(embedding_bag)={lib_dev!r}"
            print(line, flush=True)
    return max_err


def narrow_ptxas(card: str) -> None:
    """Prints ptxas' registers and spill of every build of both narrow
    kernels (one a dtype and row width) from the build logs kept beside
    the libraries."""
    from repro_torch.kernels import build

    for lib in ("cce_lookup", "cce_lookup_bwd"):
        regs = {fn: r for fn, r in ptxas_registers(build.BUILD_LOGS.get(lib, "")).items()
                if "narrow_kernel" in fn}
        for fn, (n, spill) in sorted(regs.items()):
            print(f"[{card}] ptxas {fn}: {n} registers, {spill} bytes spill stores")
        if not regs:
            print(f"[{card}] ptxas {lib}: no build log kept beside the library")


def wide_bwd_ptxas(card: str) -> None:
    """Prints ptxas' registers and spill of the wide backward's kernels (the
    sort, and the walk a dtype and layout) from the build log kept beside
    the library, and fails where one spills or the log is missing."""
    from repro_torch.kernels import build

    regs = {fn: r for fn, r in ptxas_registers(build.BUILD_LOGS.get("cce_lookup_bwd", "")).items()
            if "sort_kernel" in fn or "wide_" in fn}
    check(bool(regs), "no ptxas report of the wide backward's kernels kept beside the library")
    for fn, (n, spill) in sorted(regs.items()):
        print(f"[{card}] ptxas {fn}: {n} registers, {spill} bytes spill stores")
        check(spill == 0, f"{fn} spills {spill} bytes")


def kernel_phase(card: str, collection, device="cuda"):
    """The lookup kernel against its plain version at the supertable's
    shape, with its times, then at other widths (``wide_lookup_cases``).
    Returns (max float32 error, {batch: numbers} at the serve and the train
    batch)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    (g,) = collection.univ_groups
    grp = collection.groups[g]
    print(f"supertable: c={grp.n_cols} T={grp.n_tables} k={grp.k_pad} dsub={grp.dsub}")
    narrow_ptxas(card)
    max_err = 0.0
    at = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B in LOOKUP_BATCHES:
            idx, tables = lookup_case(collection, B, dtype, seed=B, device=device)
            got = cl.cce_lookup_fwd(idx, tables)
            want = ref.cce_lookup_ref(idx, tables)
            contig = cl.cce_lookup_fwd(idx.contiguous(), tables)
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                check(torch.equal(got, want), f"f32 kernel != plain at B={B} (max err {err})")
                check(torch.equal(contig, got), f"contiguous idx differs at B={B}")
                max_err = max(max_err, err)
            else:
                # both round the same float32 sum to bf16: allow one step
                check(torch.allclose(got.float(), want.float(), rtol=2**-7, atol=0.0),
                      f"bf16 kernel vs plain beyond 2^-7 relative at B={B} (max err {err})")
            ms = time_ms(lambda: cl.cce_lookup_fwd(idx, tables))
            plain = time_ms(lambda: ref.cce_lookup_ref(idx, tables))
            dev = device_ms(lambda: cl.cce_lookup_fwd(idx, tables),
                            lookup_kernel("cce_lookup_fwd", tables))
            plain_dev = device_busy_ms(lambda: ref.cce_lookup_ref(idx, tables), iters=20)
            bound, bound_by = lookup_bound(idx, tables)
            line = (f"[{card}] cce_lookup_fwd {str(dtype).split('.')[-1]} B={B}: "
                    f"max_abs_err={err!r} ms={ms!r} device_ms={dev!r} plain_ms={plain!r} "
                    f"plain_device_ms={plain_dev!r} bound_ms={bound!r} ({bound_by})")
            lib = lib_dev = None
            if dtype == torch.float32:
                bag, weight, offsets = embedding_bag_args(idx, tables)
                lib_out = F.embedding_bag(bag, weight, offsets, mode="sum")
                check(torch.allclose(lib_out.reshape(B, -1), got, rtol=1e-6, atol=1e-6),
                      f"embedding_bag yardstick computes another function at B={B}")
                lib = time_ms(lambda: F.embedding_bag(bag, weight, offsets, mode="sum"))
                lib_dev = device_busy_ms(
                    lambda: F.embedding_bag(bag, weight, offsets, mode="sum"), iters=20)
                line += f" library_ms(embedding_bag)={lib!r} library_device_ms={lib_dev!r}"
            print(line, flush=True)
            if dtype == torch.float32 and B in (SERVE_BATCH, TRAIN_BATCH):
                at[B] = dict(ms=ms, device_ms=dev, plain_ms=plain, plain_device_ms=plain_dev,
                             bound_ms=bound, bound_by=bound_by, library_ms=lib,
                             library_device_ms=lib_dev)
    max_err = max(max_err, wide_lookup_cases(card, device=device))
    return max_err, at


def column_ks(collection) -> list[int]:
    """The real codebook size of every supertable column (its feature's k;
    rows from there to k_pad are padding)."""
    return [collection.tables[f].fuse_spec.k for f in collection.rows_col_feature]


def bwd_case(collection, B: int, dtype, seed: int, device="cuda"):
    """idx with uniform rows (the (c, B, T) view of rows drawn below each
    column's real k, the second slot of full-table columns -1 where T is
    2, 10% more -1 sentinels) and a random upstream gradient."""
    import numpy as np
    import torch

    from repro_torch.core.embeddings import FullTable

    (g,) = collection.univ_groups
    grp = collection.groups[g]
    c, T, dsub = grp.n_cols, grp.n_tables, grp.dsub
    rng = np.random.default_rng(seed)
    ks = np.array(column_ks(collection))
    rows = (rng.random((B, c, T)) * ks[None, :, None]).astype(np.int32)
    full_col = np.array([isinstance(collection.tables[f], FullTable)
                         for f in collection.rows_col_feature])
    if T > 1:
        rows[:, full_col, 1] = -1
    rows[rng.random((B, c, T)) < 0.10] = -1
    idx = torch.from_numpy(rows).to(device).movedim(0, 1)  # (c, B, T), strided
    dout = torch.from_numpy(rng.normal(size=(B, c, dsub)).astype(np.float32))
    return idx, dout.to(device=device, dtype=dtype)


def bwd_train_case(cfg, B: int, seed: int, device="cuda"):
    """idx as the train step gives it to the backward: the rows
    ``EmbeddingCollection.group_rows`` makes on fresh buffers from one
    synthetic clickstream batch (Zipf 1.1 ids), and a random float32
    upstream gradient."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches

    coll = cfg.collection
    (g,) = coll.univ_groups
    grp = coll.groups[g]
    _, buffers = coll.init(torch.Generator().manual_seed(seed), device)
    batch = next(clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=seed), B))
    ids = torch.from_numpy(batch["sparse"]).to(device)[:, list(grp.features)]
    idx = coll.group_rows(grp, buffers[g], ids)
    del buffers
    rng = np.random.default_rng(seed)
    dout = torch.from_numpy(rng.normal(size=(B, grp.n_cols, grp.dsub)).astype(np.float32))
    return idx, dout.to(device)


def lm_step_rows(cfg, device="cuda", toks=None):
    """idx (c, B, 2) as a LM training step gives it to the lookup
    backward: the CCE token table's rows, through its initial pointers and
    hashes, of batch 0 of the training stream (LM_TRAIN_BATCH x
    LM_TRAIN_SEQ tokens of ``lm_token_batches`` at LM_SEED: seconds of
    host numpy), or of ``toks``, that batch made elsewhere."""
    import numpy as np
    import torch

    from repro_torch.models import lm

    table = lm.make_emb(cfg)
    b = table.init_buffers()
    buffers = {"ptr": torch.from_numpy(b["ptr"]).to(device),
               "hs": torch.from_numpy(b["hs"].astype(np.int64)).to(device)}
    if toks is None:
        toks = _lm_batch(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_SEED, 0)[0]["tokens"]
    return table._rows(buffers, torch.from_numpy(toks).to(device).reshape(-1)).reshape(
        table.c, -1, 2)


def bwd_bound(idx, dout, k: int):
    """Least time for the backward on an H100: idx and dout read once, the
    (c, T, k, dsub) gradient written once, against one float add per valid
    index and element.  Returns (ms, "bytes" | "operations")."""
    c, B, T = idx.shape
    dsub, esize = dout.shape[2], dout.element_size()
    n_valid = int(((idx >= 0) & (idx < k)).sum())
    n_bytes = B * c * T * 4 + B * c * dsub * esize + c * T * k * dsub * esize
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_valid * dsub / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def index_add_args(idx, dout, k: int):
    """The same gradient as one ``index_add_`` into the flattened
    (c*T*k, dsub) slab: destination rows and source rows of dout."""
    import torch

    c, B, T = idx.shape
    r = idx.to(torch.int64)
    col_t = (torch.arange(c, device=r.device)[:, None, None] * T
             + torch.arange(T, device=r.device)[None, None, :])
    src = (torch.arange(B, device=r.device)[None, :, None] * c
           + torch.arange(c, device=r.device)[:, None, None]).expand(c, B, T)
    valid = (r >= 0) & (r < k)
    return (col_t * k + r)[valid], dout.reshape(B * c, -1)[src[valid]]


def hottest_share(idx, k: int) -> float:
    """The largest share of the batch that one row of one (column,
    sub-table) holds."""
    import torch

    c, B, T = idx.shape
    r = idx.to(torch.int64)
    valid = (r >= 0) & (r < k)
    key = ((torch.arange(c, device=r.device)[:, None, None] * T
            + torch.arange(T, device=r.device)[None, None, :]) * k + r)[valid]
    return torch.bincount(key).max().item() / B if key.numel() else 0.0


def chain_floor_ms(terms: int) -> float:
    """Least time for one row of ``terms`` terms summed in increasing b:
    that many dependent float32 adds a chain, FADD_CYCLES each at the
    SM's boost clock.  No bit-equal kernel splits a row along b, so its
    hottest row's chain bounds the backward from below beside bwd_bound."""
    return terms * FADD_CYCLES / H100_SM_HZ * 1e3


def bwd_check(card: str, label: str, idx, dout, k: int, ks=None, *, timed=True,
              plain_busy=True):
    """The backward kernel on one input against its plain version: equal
    bit for bit (both sum each row in float32 in increasing b and round
    once), equal to itself across calls, exactly zero on rows no index
    names and on padding rows past a column's real k (``ks``).  With
    ``timed``, prints and returns its numbers beside its bound, its plain
    version's and (float32) ``zeros``+``index_add_``'s, and the hottest
    row's chain floor (``chain_floor_ms``), its device time the sum over
    every kernel a call launches; the plain version is timed over one call
    after one warm-up (it takes 20-470 ms a call, and its time is no
    yardstick); ``plain_busy=False`` leaves out the plain version's device
    busy (a trace of tens of thousands of records, ~35 s to read).
    Returns (max error, numbers or None)."""
    import torch

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    device = idx.device
    c, B, T = idx.shape
    dsub = dout.shape[2]
    got = cl.cce_lookup_bwd(idx, dout, k)
    again = cl.cce_lookup_bwd(idx, dout, k)
    want = ref.cce_lookup_bwd_ref(idx, dout, k)
    err = (got.float() - want.float()).abs().max().item()
    check(torch.equal(got, want), f"bwd kernel != plain on {label} (max err {err})")
    check(torch.equal(got, again), f"bwd kernel not repeatable on {label}")
    named = torch.zeros((c, T, k), dtype=torch.bool, device=device)
    r = idx.to(torch.int64)
    valid = (r >= 0) & (r < k)
    cc, _, tt = torch.nonzero(valid, as_tuple=True)
    named[cc, tt, r[valid]] = True
    check(not got[~named].any(), f"bwd kernel wrote a row no index names on {label}")
    if ks is not None:
        pad = torch.arange(k, device=device)[None, None, :] >= ks[:, None, None]
        check(not got[pad.expand(c, T, k)].any(), f"bwd padding rows not zero on {label}")
    hot = hottest_share(idx, k)
    chain = chain_floor_ms(round(hot * B))
    if not timed:
        print(f"[{card}] cce_lookup_bwd {label}: equal to plain, repeatable, zero on unnamed "
              f"rows; hottest row {hot!r} of the batch, chain_floor_ms={chain!r}", flush=True)
        return err, None
    ms = time_ms(lambda: cl.cce_lookup_bwd(idx, dout, k))
    plain = time_ms(lambda: ref.cce_lookup_bwd_ref(idx, dout, k), iters=1, reps=1, warmup=1)
    # every kernel a call launches (the wide layouts: the sort and the walk)
    dev = device_busy_ms(lambda: cl.cce_lookup_bwd(idx, dout, k), iters=TRACE_RECORDS)
    plain_dev = device_busy_ms(lambda: ref.cce_lookup_bwd_ref(idx, dout, k)) if plain_busy else None
    bound, bound_by = bwd_bound(idx, dout, k)
    line = (f"[{card}] cce_lookup_bwd {label}: max_abs_err={err!r} repeatable=True "
            f"zero_unnamed_rows=True hottest_row_share={hot!r} ms={ms!r} device_ms={dev!r} "
            f"plain_ms={plain!r} plain_device_ms={plain_dev!r} bound_ms={bound!r} ({bound_by}) "
            f"chain_floor_ms={chain!r}")
    lib = lib_dev = None
    if dout.dtype == torch.float32:
        dest, rows = index_add_args(idx, dout, k)
        flat = (c * T * k, dsub)

        def call():
            return torch.zeros(flat, device=device).index_add_(0, dest, rows)

        # atomics add a hot row's hundreds of terms in another order
        lib_err = (call().reshape(got.shape) - got).abs().max().item()
        check(lib_err <= 1e-5 * got.abs().max().item(),
              f"index_add_ yardstick computes another function on {label} ({lib_err})")
        lib = time_ms(call)
        lib_dev = device_busy_ms(call, iters=20)
        line += f" library_ms(zeros+index_add_)={lib!r} library_device_ms={lib_dev!r}"
    print(line, flush=True)
    return err, dict(ms=ms, device_ms=dev, plain_ms=plain, plain_device_ms=plain_dev,
                     bound_ms=bound, bound_by=bound_by, chain_floor_ms=chain, library_ms=lib,
                     library_device_ms=lib_dev, hottest_row_share=hot)


def bwd_kernel_phase(card: str, cfg, device="cuda"):
    """The backward kernel against its plain version (``bwd_check``) at the
    supertable's shape on uniform rows at BWD_BATCHES, on the rows a real
    train batch gives (Zipf ids through ``group_rows``), on every valid
    index of a column naming one row, on an unaligned dout (wide_scalar),
    then at the hashing trick's supertable (``hash_bwd_cases``), then at
    the widths of WIDE_LOOKUP.  Returns (max error, numbers at the train
    batch: uniform ids at the top level, the skewed, the one-row, the
    hash-shape and the LM-shape cases under their own keys)."""
    import torch

    collection = cfg.collection
    (g,) = collection.univ_groups
    k = collection.groups[g].k_pad
    ks = torch.tensor(column_ks(collection), device=device)
    max_err, at = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for B in BWD_BATCHES:
            idx, dout = bwd_case(collection, B, dtype, seed=100 + B, device=device)
            # no trace of the plain version's device busy (PERF.md section 6
            # keeps one at the train batch: 21.4 ms)
            err, nums = bwd_check(card, f"{dn} B={B}", idx, dout, k, ks, plain_busy=False)
            max_err = max(max_err, err)
            if dtype == torch.float32 and B == TRAIN_BATCH:
                at.update(nums)
                uniform = idx
    idx, dout = bwd_train_case(cfg, TRAIN_BATCH, seed=3, device=device)
    err, at["at_skewed_train_batch"] = bwd_check(
        card, f"float32 B={TRAIN_BATCH} skewed (a train batch's rows)", idx, dout, k, ks,
        plain_busy=False)
    max_err = max(max_err, err)
    valid = (uniform >= 0) & (uniform < ks[:, None, None])
    one_row = torch.where(valid, (ks - 1).to(torch.int32)[:, None, None], uniform)
    err, at["at_one_row"] = bwd_check(
        card, f"float32 B={TRAIN_BATCH} one row a column", one_row, dout, k, ks,
        plain_busy=False)
    max_err = max(max_err, err)
    flat = torch.empty(dout.numel() + 1, device=device)[1:]
    odd = flat.view(dout.shape).copy_(dout)
    check(cl_path(odd) == "wide_scalar", "an unaligned dout does not take wide_scalar")
    err, _ = bwd_check(card, f"float32 B={TRAIN_BATCH} unaligned dout", uniform, odd, k, ks,
                       timed=False)
    max_err = max(max_err, err)
    err, hash_at = hash_bwd_cases(card, cfg, device=device)
    max_err = max(max_err, err)
    at.update(hash_at)
    for (c, T, kw, dsub), paths in WIDE_LOOKUP.items():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            idx, _ = random_lookup(c, T, kw, dsub, TRAIN_BATCH, torch.float32, seed=dsub,
                                   device=device)
            gen = torch.Generator(device=device).manual_seed(dsub)
            dout = torch.randn((TRAIN_BATCH, c, dsub), generator=gen, device=device).to(dtype)
            check(cl_path(dout) == paths[dn], f"dsub={dsub} {dn} dout does not take {paths[dn]}")
            label = f"{dn} B={TRAIN_BATCH} c={c} T={T} k={kw} dsub={dsub} {paths[dn]}"
            err, nums = bwd_check(card, label, idx, dout, kw, timed=dtype == torch.float32)
            if dtype == torch.float32:
                max_err = max(max_err, err)
                if dsub == LM_DSUB:
                    at["at_lm_shape"] = nums
    err, wide_at = wide_bwd_cases(card, device=device)
    return max(max_err, err), {**at, **wide_at}


def wide_bwd_cases(card: str, device="cuda"):
    """The wide backward (a sort, then a walk; ptxas: no spill) through
    ``bwd_check`` on a training step's token rows (``lm_step_rows``) at the
    token tables of WIDE_BWD_TABLES (float32 timed beside its bound and
    ``zeros``+``index_add_``, bfloat16 checked), then on qwen2-1.5b's step
    rows at its token table's shape: the first WIDE_BWD_RAGGED of them (not
    a whole number of sort chunks), in the serving layout's strided view,
    with every index of a column on one row, on an unaligned dout
    (wide_scalar) and at B=1.  Returns (max error,
    {"at_<table>_train_shape": numbers})."""
    import torch

    from repro_torch import configs

    wide_bwd_ptxas(card)
    # each vocabulary's batch 0 of the token stream, made in parallel: each
    # takes seconds of numpy
    archs = [arch for arch, _ in WIDE_BWD_TABLES.values()] + [LM_ARCH]
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(archs), mp_context=multiprocessing.get_context("spawn")) as pool:
        made = pool.map(_lm_batch, *zip(*[(configs.get(a).vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                            LM_SEED, 0) for a in archs]))
        toks = {a: b["tokens"] for a, (b, _) in zip(archs, made)}
    max_err, at = 0.0, {}
    for n, (name, (arch, shape)) in enumerate(WIDE_BWD_TABLES.items()):
        idx = lm_step_rows(configs.get(arch), device=device, toks=toks[arch])
        c, B, T = idx.shape
        k, dsub = shape[2:]
        check((c, T) == shape[:2], f"{arch}'s step rows are not (c, T) = {shape[:2]}")
        check(int(idx.max()) < k, f"{arch}'s step rows name a row past k={k}")
        gen = torch.Generator(device=device).manual_seed(50 + n)
        dout32 = torch.randn((B, c, dsub), generator=gen, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            dout = dout32.to(dtype)
            check(cl_path(dout) == "wide_vector", f"the {name} shape's {dn} dout is not wide")
            timed = dtype == torch.float32
            err, nums = bwd_check(card, f"{dn} B={B} {name} token table c={c} T={T} k={k} "
                                  f"dsub={dsub} wide_vector, a step's token rows", idx, dout, k,
                                  timed=timed, plain_busy=False)
            max_err = max(max_err, err)
            if timed:
                at[f"at_{name}_train_shape"] = nums
    step = lm_step_rows(configs.get(LM_ARCH), device=device, toks=toks[LM_ARCH])
    c, B, T = step.shape
    k = 4748
    check(int(step.max()) < k, f"{LM_ARCH}'s step rows name a row past k={k}")
    strided = step.movedim(1, 0).contiguous().movedim(0, 1)  # (c, B, T) of (B, c, T) rows
    check(not strided.is_contiguous(), "the serving layout's idx view is contiguous")
    one_row = torch.full_like(step, k - 1)
    dout = torch.randn((B, c, LM_DSUB),
                       generator=torch.Generator(device=device).manual_seed(61), device=device)
    flat = torch.empty(dout.numel() + 1, device=device)[1:]
    odd = flat.view(dout.shape).copy_(dout)
    check(cl_path(odd) == "wide_scalar", "an unaligned dout does not take wide_scalar")
    ragged = step[:, :WIDE_BWD_RAGGED].contiguous()
    both = (torch.float32, torch.bfloat16)
    for label, rows, d, dtypes in (
            ("the first rows, not whole sort chunks", ragged, dout[:WIDE_BWD_RAGGED], both),
            ("a strided idx view", strided, dout, both),
            ("every index of a column on one row", one_row, dout, both),
            ("unaligned dout, wide_scalar", step, odd, (torch.float32,)),
            ("B=1", step[:, :1], dout[:1], (torch.float32,))):
        for dtype in dtypes:
            dn = str(dtype).split(".")[-1]
            err, _ = bwd_check(card, f"{dn} B={rows.shape[1]} LM token table shape, a step's "
                               f"token rows, {label}", rows, d.to(dtype), k, timed=False)
            max_err = max(max_err, err)
    return max_err, at


def hash_bwd_cases(card: str, cfg, device="cuda"):
    """The backward at the hashing trick's supertable (``emb_method="hash"``
    on ``cfg``: HASH_SHAPE, the narrow layout) on the rows a train batch
    gives (Zipf ids through ``group_rows``) and on every valid index of a
    column naming its last real row (a 2048-term chain), in float32 and
    bfloat16, through ``bwd_check``; float32 timed.  Then, untimed, on a
    Zipf batch of 4096 (two chunks: a hot row's sums carried from one to
    the next).  Returns (max error, {"at_hash_train_batch": numbers,
    "at_hash_one_row": numbers})."""
    import dataclasses

    import torch

    hcfg = dataclasses.replace(cfg, emb_method="hash")
    coll = hcfg.collection
    (g,) = coll.univ_groups
    grp = coll.groups[g]
    k = grp.k_pad
    check((grp.n_cols, grp.n_tables, k, grp.dsub) == HASH_SHAPE,
          f"the hash supertable is not {HASH_SHAPE}")
    ks = torch.tensor(column_ks(coll), device=device)
    idx, dout32 = bwd_train_case(hcfg, TRAIN_BATCH, seed=3, device=device)
    valid = (idx >= 0) & (idx < ks[:, None, None])
    one_row = torch.where(valid, (ks - 1).to(torch.int32)[:, None, None], idx)
    max_err, at = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        dout = dout32.to(dtype)
        check(cl_path(dout) == "narrow", f"the hash shape's {dn} dout does not take narrow")
        f32 = dtype == torch.float32
        for key, what, rows in (("at_hash_train_batch", "a train batch's rows", idx),
                                ("at_hash_one_row", "one row a column", one_row)):
            # no trace of the plain version's device busy: one row a column is
            # 2048 rounds of index_add_, a trace of ~10^5 records, and PERF.md
            # section 6 keeps the train batch's (31.2 ms)
            err, nums = bwd_check(
                card, f"{dn} B={TRAIN_BATCH} hash shape c={grp.n_cols} T=1 k={k} dsub={grp.dsub} "
                f"narrow, {what}", rows, dout, k, ks, timed=f32, plain_busy=False)
            max_err = max(max_err, err)
            if f32:
                at[key] = nums
    idx, dout32 = bwd_train_case(hcfg, 4096, seed=4, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        err, _ = bwd_check(card, f"{dn} B=4096 hash shape narrow, a Zipf batch's rows", idx,
                           dout32.to(dtype), k, ks, timed=False)
        max_err = max(max_err, err)
    return max_err, at


def assign_bound(n: int, k: int, d: int, c: int = 1):
    """Least time for the assignment of c columns on an H100: x, the
    centroids and the output moved once, against c*n*k*(d+1) float32 FMAs
    (2 operations each) at the data-sheet rate.  Returns (ms, "bytes" |
    "operations")."""
    n_bytes = c * ((n * d + k * d) * 4 + n * 4)
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, 2 * c * n * k * (d + 1) / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_registers(log: str) -> dict:
    """{function: (registers, spill store bytes)} from an ``nvcc -Xptxas -v``
    log."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            out[fn] = (out.get(fn, (None, 0))[0], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = (int(m.group(1)), out.get(fn, (None, 0))[1])
    return out


def assign_excess(got, x, cent):
    """Per point, how far the plain distance of the kernel's pick lies
    above the plain minimum, checked against ASSIGN_RTOL*(|min|+1)
    (float32 sums in another order may swap near ties); x (n, d), cent
    (k, d).  Returns the largest excess."""
    dist = (cent * cent).sum(-1)[None, :] - 2.0 * (x @ cent.T)
    best = dist.min(1).values
    excess = dist.gather(1, got.long()[:, None])[:, 0] - best
    check(bool((excess <= ASSIGN_RTOL * (best.abs() + 1)).all()),
          f"kmeans_assign picks beyond tolerance at n={x.shape[0]} k={cent.shape[0]} "
          f"(max excess {excess.max().item()})")
    return excess.max().item()


def assign_chunk_shapes(cfg) -> list[tuple[int, int, int, int]]:
    """Every distinct (c, n, k, d) launch of the transition's
    ``CCE.assign_all`` over cfg's CCE tables: each table's full chunks and
    its last, ragged one, as ``CCE.assign_all`` cuts them with no group."""
    from repro_torch.core import cce as cce_lib

    shapes = set()
    for t in cfg.collection.tables:
        if isinstance(t, cce_lib.CCE):
            ch = cfg.emb_cluster_chunk
            step = ch if ch and ch < t.d1 else t.d1
            shapes.update((t.c, min(step, t.d1 - s), t.k, t.dsub) for s in range(0, t.d1, step))
    return sorted(shapes)


def check_batched_assign(c, n, k, d, device):
    """One batched launch over random (c, n, d) points and (c, k, d)
    centroids into columns [5, 5 + n) of a (c, n + 9) table, as
    ``CCE.assign_all`` writes a chunk: nothing outside the slice written,
    every pick within ASSIGN_RTOL of the plain minimum (column by column),
    and a second launch, into a new array, bit for bit.  Returns (x,
    centroids, the table, picks, max excess, agreement with
    ``ref.kmeans_assign_batched_ref``)."""
    import torch

    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(n)
    x = torch.randn((c, n, d), generator=g, device=device)
    cent = torch.randn((c, k, d), generator=g, device=device)
    table = torch.full((c, n + 9), -1, dtype=torch.int32, device=device)
    got = ka.kmeans_assign(x, cent, out=table[:, 5:5 + n]).clone()
    check(bool((table[:, :5] == -1).all() and (table[:, 5 + n:] == -1).all()),
          f"the batched kernel wrote outside its slice at c={c} n={n}")
    excess = max(assign_excess(got[i], x[i], cent[i]) for i in range(c))
    check(torch.equal(ka.kmeans_assign(x, cent), got), f"a second launch differs at c={c} n={n}")
    agree = (got == ref.kmeans_assign_batched_ref(x, cent)).float().mean().item()
    return x, cent, table, got, excess, agree


def kmeans_phase(card: str, cfg, device="cuda"):
    """The assignment kernel against its plain version at an assign_all
    chunk and at a Lloyd-sample shape (one column), at the chunk of a c=4
    table in one launch (ASSIGN_BATCHED, written into a strided slice of a
    pointer table, as ``CCE.assign_all`` does), at every other chunk shape
    the transition over cfg's tables launches (``assign_chunk_shapes``:
    each template instance and each table's ragged last chunk) and,
    through the tiled kernel, at every ASSIGN_GENERAL shape (planted ties
    go to the lower j) and at the full token tables of ASSIGN_LM_TABLE and
    ASSIGN_PALIGEMMA_TABLE: for every point the plain distance of the
    kernel's pick is within ASSIGN_RTOL*(|min|+1) of the plain minimum,
    and a second launch gives the same picks bit for bit.  Times each
    d = 4 shape of ASSIGN_SHAPES and ASSIGN_BATCHED, and both token
    tables, beside ``cdist``+``argmin``.  Returns (max excess, numbers at
    the chunk shape, with the others under ``at_lloyd_sample``,
    ``batched``, ``at_lm_table_shape_random_inputs`` and
    ``at_paligemma_table_shape``)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import ref

    sm = torch.cuda.get_device_properties(device).multi_processor_count if device == "cuda" else 132
    regs = {fn: r for fn, r in ptxas_registers(build.BUILD_LOGS.get("kmeans_assign", "")).items()
            if "kmeans_assign" in fn}
    max_excess, at = 0.0, []
    for c, n, k, d in [(None, n, k, d) for n, k, d in ASSIGN_SHAPES] + [ASSIGN_BATCHED]:
        if c is None:
            g = torch.Generator(device=device).manual_seed(n)
            x = torch.randn((n, d), generator=g, device=device)
            cent = torch.randn((k, d), generator=g, device=device)
            got = ka.kmeans_assign(x, cent)
            excess = assign_excess(got, x, cent)
            check(torch.equal(ka.kmeans_assign(x, cent), got), f"a second launch differs at n={n}")
            agree = (got == ref.kmeans_assign_ref(x, cent)).float().mean().item()
            run = (lambda: ka.kmeans_assign(x, cent))
            plain_fn = (lambda: ref.kmeans_assign_ref(x, cent))
        else:
            x, cent, table, got, excess, agree = check_batched_assign(c, n, k, d, device)
            run = (lambda: ka.kmeans_assign(x, cent, out=table[:, 5:5 + n]))
            plain_fn = (lambda: ref.kmeans_assign_batched_ref(x, cent))
        max_excess = max(max_excess, excess)
        ms = time_ms(run)
        plain = time_ms(plain_fn, iters=50)
        dev = device_ms(run, "kmeans_assign_kernel")
        plain_dev = device_busy_ms(plain_fn, iters=10)

        def library():
            return torch.cdist(x, cent).argmin(-1)

        lib_agree = (library() == got.long()).float().mean().item()
        lib = time_ms(library, iters=50)
        lib_dev = device_busy_ms(library, iters=10)
        bound, bound_by = assign_bound(n, k, d, c or 1)
        p, threads = ka.assign_geometry(n, c or 1, k, d, sm)
        reg = next((r for fn, r in regs.items() if f"kmeans_assign_kernelILi{p}E" in fn),
                   "not measured")
        print(f"[{card}] kmeans_assign c={c or 1} n={n} k={k} d={d}: max_excess={excess!r} "
              f"agree_with_plain={agree!r} agree_with_cdist={lib_agree!r}; repeats bit for bit; "
              f"ms={ms!r} device_ms={dev!r} plain_ms={plain!r} plain_device_ms={plain_dev!r} "
              f"library_ms(cdist+argmin, two calls)={lib!r} library_device_ms={lib_dev!r} "
              f"bound_ms={bound!r} ({bound_by}), share of bound {bound / dev!r}; points a "
              f"thread {p}, threads a CTA {threads}, (registers, spill bytes) {reg}", flush=True)
        at.append(dict(c=c or 1, n=n, k=k, d=d, agree_with_plain=agree, ms=ms, device_ms=dev,
                       plain_ms=plain, plain_device_ms=plain_dev, bound_ms=bound,
                       bound_by=bound_by, library_ms=lib, library_device_ms=lib_dev,
                       points_per_thread=p, threads=threads))
    tiled_regs = next((r for fn, r in regs.items() if "kmeans_assign_tiled_kernel" in fn),
                      "not measured")
    for c, n, k, d, ties in ASSIGN_GENERAL:  # the tiled kernel
        x, cent = tiled_assign_inputs(c, n, k, d, device)
        planted = plant_ties(x, cent) if ties else None
        got = ka.kmeans_assign(x, cent)
        excess = max(assign_excess(got[i], x[i], cent[i]) for i in range(c))
        check(torch.equal(ka.kmeans_assign(x, cent), got), f"a second launch differs at d={d}")
        if planted is not None:
            points, want = planted
            check(torch.equal(got[:, points], want),
                  f"a planted tie at c={c} n={n} k={k} d={d} does not go to the lower j")
        max_excess = max(max_excess, excess)
        t = ka.tiles(n, c, k, d)
        print(f"[{card}] kmeans_assign (tiled kernel) c={c} n={n} k={k} d={d}: "
              f"max_excess={excess!r}; repeats bit for bit"
              f"{'; planted ties go to the lower j' if planted is not None else ''}; grid "
              f"{t.grid}, {t.k_tiles} centroid tiles of {t.d_steps} steps, "
              f"{'16' if t.vec else '4'}-byte copies, (registers, spill bytes) {tiled_regs}",
              flush=True)
    at_tables = {key: tiled_assign_numbers(card, *tiled_assign_inputs(*shape, device),
                                           "random inputs", plain=plain, library_by_column=lc)
                 for key, shape, plain, lc in (
                     ("at_lm_table_shape_random_inputs", ASSIGN_LM_TABLE, True, False),
                     ("at_paligemma_table_shape", ASSIGN_PALIGEMMA_TABLE, False, True))}
    max_excess = max(max_excess, *(a["max_excess"] for a in at_tables.values()))
    main_path = assign_chunk_shapes(cfg)
    geometries = collections.Counter()
    for c, n, k, d in main_path:  # what the transition launches, held as above
        *_, excess, agree = check_batched_assign(c, n, k, d, device)
        max_excess = max(max_excess, excess)
        geometries[ka.assign_geometry(n, c, k, d, sm)] += 1
        print(f"[{card}] kmeans_assign (transition chunk) c={c} n={n} k={k} d={d}: "
              f"max_excess={excess!r} agree_with_plain={agree!r}; repeats bit for bit; "
              f"(points a thread, threads a CTA) {ka.assign_geometry(n, c, k, d, sm)}", flush=True)
    print(f"[{card}] kmeans_assign: all {len(main_path)} chunk shapes of the transition held; "
          f"launch geometries {dict(geometries)}", flush=True)
    chunk, lloyd, batched = at
    return max_excess, dict(chunk, at_lloyd_sample=lloyd, batched=batched,
                            transition_chunk_shapes_held=len(main_path),
                            tiled_shapes_held=len(ASSIGN_GENERAL), **at_tables)


def tiled_assign_inputs(c, n, k, d, device):
    """Random (c, n, d) points and (c, k, d) centroids from a generator
    seeded with n * d + k."""
    import torch

    g = torch.Generator(device=device).manual_seed(n * d + k)
    return (torch.randn((c, n, d), generator=g, device=device),
            torch.randn((c, k, d), generator=g, device=device))


def plant_ties(x, cent):
    """Copies centroid j to a j' > j where the tiled kernel splits the
    scan (``kmeans_assign.tiles``): j' = j + bn // tn (the same thread's
    block), j + bn (the next centroid tile) and k - 1 (the ragged last
    tile), in every column, and puts a few points on each centroid j,
    spread over the CTAs.  Returns (those points, (c, len) int32 the j each
    must pick)."""
    import torch

    from repro_torch.kernels import kmeans_assign as ka

    (c, n, _), k = x.shape, cent.shape[1]
    t = ka.tiles(n, c, k, x.shape[2])
    pairs = ((3, 3 + t.bn // t.tn), (5, 5 + t.bn), (7, k - 1))
    check(k - 1 >= (t.k_tiles - 1) * t.bn > 5 + t.bn, f"k={k} leaves no ragged tile to plant in")
    points, want = [], []
    for q, (j, jj) in enumerate(pairs):
        cent[:, jj] = cent[:, j]
        for r in range(4):
            p = (q * 997 + r * (n // 4)) % n
            x[:, p] = cent[:, j]
            points.append(p)
            want.append(j)
    want = torch.tensor(want, dtype=torch.int32, device=x.device).expand(c, -1)
    return torch.tensor(points, device=x.device), want


def tiled_assign_numbers(card: str, x, cent, inputs: str, *, plain: bool = True,
                         library_by_column: bool = False) -> dict:
    """The tiled kernel at a token table's full shape, x (c, n, d) and cent
    (c, k, d) (``inputs`` says whose): every pick within ASSIGN_RTOL of the
    plain minimum, a second launch bit for bit, timed (device ms from a
    10-call trace) beside its bound, the plain version (where ``plain``)
    and ``cdist``+``argmin`` over all c columns, in one call or, with
    ``library_by_column``, in c calls, one a column (the sum of their
    device times).  Returns the numbers."""
    import torch

    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import ref

    (c, n, d), k = x.shape, cent.shape[1]
    name = "kmeans_assign_tiled_kernel"

    def run():
        return ka.kmeans_assign(x, cent)

    got = run()
    check(torch.equal(run(), got), f"a second launch differs at n={n} d={d}")
    excess = max(assign_excess(got[i], x[i], cent[i]) for i in range(c))
    ms = time_ms(run, iters=2, reps=3, warmup=1)
    dev = device_ms(run, name, iters=10)
    bound, bound_by = assign_bound(n, k, d, c)
    nums = dict(c=c, n=n, k=k, d=d, kernel=name, max_excess=excess, ms=ms, device_ms=dev,
                bound_ms=bound, bound_by=bound_by)
    if plain:
        def plain_fn():
            return ref.kmeans_assign_batched_ref(x, cent)

        nums.update(agree_with_plain=(got == plain_fn()).float().mean().item(),
                    plain_ms=time_ms(plain_fn, iters=1, reps=3, warmup=1),
                    plain_device_ms=device_busy_ms(plain_fn))
    calls = c if library_by_column else 1

    def column(i):
        return torch.cdist(x[i], cent[i]).argmin(-1)

    def library():
        if library_by_column:  # c distance matrices of (n, k) at a time, not one of (c, n, k)
            return [column(i) for i in range(c)]
        return torch.cdist(x, cent).argmin(-1)

    agree = sum((a == b.long()).float().mean().item() for a, b in zip(library(), got)) / c
    lib_dev = (sum(device_busy_ms(lambda i=i: column(i)) for i in range(c)) if library_by_column
               else device_busy_ms(library))
    nums.update(library_calls=calls, agree_with_cdist=agree,
                library_ms=time_ms(library, iters=1, reps=3, warmup=1),
                library_device_ms=lib_dev)
    print(f"[{card}] kmeans_assign (tiled kernel) token table c={c} n={n} k={k} d={d}, {inputs}: "
          f"max_excess={excess!r}; repeats bit for bit; ms={ms!r} device_ms={dev!r} "
          f"bound_ms={bound!r} ({bound_by}), share of bound {bound / dev!r}; "
          + (f"plain_ms={nums['plain_ms']!r} plain_device_ms={nums['plain_device_ms']!r} "
             f"agree_with_plain={nums['agree_with_plain']!r}; " if plain else "")
          + f"library_ms(cdist+argmin over {c} columns in {calls} call(s))="
          f"{nums['library_ms']!r} "
          f"library_device_ms={nums['library_device_ms']!r} "
          f"agree_with_cdist={nums['agree_with_cdist']!r}", flush=True)
    return nums


class PhaseClock:
    """Host ms of the transition by phase: wraps the functions that make up
    the phases so that each top-level call (not one nested in another
    phase) is timed between two synchronisations."""

    def __init__(self, targets):
        self.ms = collections.Counter()
        self.calls = collections.Counter()
        self._targets = targets  # (owner, attribute, phase)
        self._saved = []
        self._depth = 0

    def _measure(self, phase, call):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return call()
        finally:
            torch.cuda.synchronize()
            self.ms[phase] += (time.perf_counter() - t0) * 1e3

    def __enter__(self):
        for owner, name, phase in self._targets:
            orig = getattr(owner, name)

            def wrapped(*args, _orig=orig, _phase=phase, **kw):
                if self._depth:
                    return _orig(*args, **kw)
                self._depth += 1
                self.calls[_phase] += 1
                try:
                    return self._measure(_phase, lambda: _orig(*args, **kw))
                finally:
                    self._depth -= 1

            self._saved.append((owner, name, orig))
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()


class PhaseBusy(PhaseClock):
    """Device busy of the transition by phase: each top-level call of a
    phase runs under its own torch.profiler trace of the card, and the
    device time of every kernel and copy in it adds up in ``ms``."""

    def _measure(self, phase, call):
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        self.ms[phase] += sum(_device_us(e) for e in prof.key_averages()) / 1e3
        return out


def _leaf_errors(got, want) -> list[tuple[float, float]]:
    """(max |got - want|, max |want|) of every leaf of two trees."""
    from repro_torch.tree import tree_leaves

    out = []
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        out.append(((a - b).abs().max().item(), b.abs().max().item()))
    return out


def _check_close(errs, what: str, rtol: float = STEP_RTOL, floors=None) -> float:
    """Every leaf within ``rtol`` of its largest magnitude, or within its
    ``floors`` entry where that is larger; returns the largest relative
    error."""
    floors = floors or [0.0] * len(errs)
    rel = max(e / max(m, 1e-30) for e, m in errs)
    check(all(e <= max(rtol, f) * m + 1e-7 for (e, m), f in zip(errs, floors)),
          f"{what}: card vs CPU beyond {rtol} relative (largest {rel})")
    return rel


def train_phase(card: str, cfg, device="cuda"):
    """Full-width DLRM training with one clustering transition: 8 steps,
    ``dlrm.cluster_tables`` with dense id counts and the moments remapped,
    4 steps, then serving the trained state.  Returns {path: launches}."""
    import numpy as np
    import torch

    from repro_torch import random as jr
    from repro_torch.core import cce as cce_lib
    from repro_torch.core import hashing
    from repro_torch.core import kmeans as km
    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.optim import sgd
    from repro_torch.serve.dlrm import DLRMServeEngine
    from repro_torch.train import loop
    from repro_torch.train.transition import transition_table
    from repro_torch.tree import tree_leaves, tree_map

    coll = cfg.collection
    t0 = time.perf_counter()
    params, buffers = dlrm.init(cfg, torch.Generator().manual_seed(1), device=device)
    engine = DLRMServeEngine(params, buffers, cfg, max_batch=SERVE_BATCH)
    print(f"train init: {time.perf_counter() - t0:.3f} s (with the serve engine)")
    t0 = time.perf_counter()
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=1),
                                 TRAIN_BATCH)
    raw = [next(stream) for _ in range(TRAIN_STEPS + POST_STEPS)]
    print(f"train data: {len(raw)} batches of {TRAIN_BATCH} in {time.perf_counter() - t0:.3f} s")

    def on(batch, dev):  # one microbatch: leaves (1, B, ...)
        return {k: torch.from_numpy(batch[k][None]).to(dev) for k in ("dense", "sparse", "label")}

    batches = [on(b, device) for b in raw]

    def loss_fn(p, b, mb):
        return dlrm.bce_loss(p, b, cfg, mb), {}

    opt = sgd(momentum=0.9)
    step = loop.make_train_step(loss_fn, opt, lambda s: TRAIN_LR, clip_norm=1.0)
    state = loop.init_state(params, opt, buffers)
    launches = {}

    # the first step on CPU copies of the state, with the plain versions
    cpu_state = loop.TrainState(*(tree_map(lambda t: t.detach().to("cpu", copy=True), x)
                                  for x in (state.params, state.opt, state.ebuf)), step=0)
    cpu_mb = on(raw[0], "cpu")
    loss_dev, g_dev = loop.value_and_grad(loss_fn, state.params, state.ebuf,
                                          tree_map(lambda x: x[0], batches[0]))
    loss_cpu, g_cpu = loop.value_and_grad(loss_fn, cpu_state.params, cpu_state.ebuf,
                                          tree_map(lambda x: x[0], cpu_mb))
    check(abs(loss_dev.item() - loss_cpu.item()) <= 1e-5 * abs(loss_cpu.item()),
          f"first-step loss card {loss_dev.item()} vs CPU {loss_cpu.item()}")
    grad_rel = _check_close(_leaf_errors(g_dev, g_cpu), "first-step gradients")
    del g_dev, g_cpu

    ops.LAUNCHES.clear()
    losses, step_ms = [], []
    for i, mb in enumerate(batches[:TRAIN_STEPS]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, mb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        if i == 0:
            first_params = tree_map(torch.clone, state.params)
    launches["train"] = dict(ops.LAUNCHES)
    check(launches["train"].get("cce_lookup_fwd") == TRAIN_STEPS
          and launches["train"].get("cce_lookup_bwd") == TRAIN_STEPS,
          f"train steps {TRAIN_STEPS}, launches {launches['train']}")
    check(all(math.isfinite(x) for x in losses), f"non-finite train loss {losses}")
    cpu_state, cpu_m = step(cpu_state, cpu_mb)
    check(abs(cpu_m["loss"].item() - losses[0]) <= 1e-5 * abs(losses[0]),
          f"first step loss card {losses[0]} vs CPU {cpu_m['loss'].item()}")
    param_rel = _check_close(_leaf_errors(first_params, cpu_state.params), "first-step params")
    del cpu_state, first_params
    print(f"[{card}] train: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, losses {losses!r}; "
          f"launches {launches['train']}; first step vs CPU: loss {loss_cpu.item()!r} vs "
          f"{loss_dev.item()!r}, gradients max rel err {grad_rel!r}, params max rel err "
          f"{param_rel!r}", flush=True)

    # the transition, with dense per-feature id counts from the batches seen
    counts = [np.bincount(np.concatenate([b["sparse"][:, f] for b in raw[:TRAIN_STEPS]]),
                          minlength=v) for f, v in enumerate(cfg.vocab_sizes)]
    cce_feats = [i for i, t in enumerate(coll.tables) if isinstance(t, cce_lib.CCE)]
    # one launch a chunk, for all c columns of a table
    want_assign = sum(-(-coll.tables[i].d1 // cfg.emb_cluster_chunk) for i in cce_feats)
    key = jr.PRNGKey(2)
    phases = [(cce_lib.CCE, "materialize", "sample materialize"),
              (km, "kmeans_columns", "kmeans++/Lloyd"),
              (cce_lib.CCE, "assign_all", "assign_all"),
              (cce_lib.CCE, "remap_moments", "moment remap")]
    ops.LAUNCHES.clear()
    with PhaseClock(phases) as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_p, new_b, new_opt = dlrm.cluster_tables(key, state.params, state.ebuf, cfg, state.opt,
                                                    id_counts=counts)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
    launches["transition"] = dict(ops.LAUNCHES)
    check(launches["transition"].get("kmeans_assign") == want_assign,
          f"kmeans_assign launches {launches['transition']} != {want_assign}")

    # its invariants
    ptr_device = state.params["top"][0]["w"].device
    for i in cce_feats:
        t = coll.tables[i]
        old_b, nb = coll.feature_buffers(state.ebuf["emb"], i), coll.feature_buffers(new_b["emb"], i)
        epoch = int(old_b["epoch"])
        check(int(nb["epoch"]) == epoch + 1, f"feature {i}: epoch {int(nb['epoch'])}")
        _, k2 = jr.split(jr.fold_in(jr.fold_in(key, i), epoch))
        hs = hashing.pack_hashes(hashing.make_hashes(hashing._seed_of(jr.fold_in(k2, 777)),
                                                     t.c, t.k)).astype(np.int64)
        check(np.array_equal(nb["hs"].cpu().numpy(), hs), f"feature {i}: hs off the key schedule")
        check(nb["hs"].dtype == torch.int64 and nb["hs"].device == ptr_device,
              f"feature {i}: hs {nb['hs'].dtype} on {nb['hs'].device}")
        ptr = nb["ptr"]
        check(int(ptr.min()) >= 0 and int(ptr.max()) < t.k, f"feature {i}: ptr outside [0, k)")
        check(not coll.feature_params(new_p["emb"], i)["tables"][:, 1].any(),
              f"feature {i}: helper table not zero")
        check(not coll.feature_params(new_opt["m"]["emb"], i)["tables"][:, 1].any(),
              f"feature {i}: helper moments not zero")
    # bitwise repeatable from the same state and key; this run also takes
    # the device busy of assign_all (each of its calls profiled; the other
    # phases' busy comes from feature 2 alone, below)
    with PhaseBusy([ph for ph in phases if ph[2] == "assign_all"]) as busy:
        again = dlrm.cluster_tables(key, state.params, state.ebuf, cfg, state.opt,
                                    id_counts=counts)
    for a, b, what in ((new_p["emb"], again[0]["emb"], "tables"), (new_b["emb"], again[1]["emb"],
                       "ptr/hs/epoch"), (new_opt["m"]["emb"], again[2]["m"]["emb"], "moments")):
        check(all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b))),
              f"a second transition from the same state differs in {what}")
    del again
    phase_ms = dict(clock.ms)
    other = total_ms - sum(phase_ms.values())
    print(f"[{card}] transition: {len(cce_feats)} CCE features, {total_ms!r} ms host; "
          f"launches {launches['transition']} (expected kmeans_assign {want_assign}); "
          f"invariants hold; a second run from the same state is bitwise equal", flush=True)
    print(f"[{card}] transition by phase: " + ", ".join(
        f"{k}: host {v!r} ms" + (f", device busy {busy.ms[k]!r} ms" if k in busy.ms else "")
        for k, v in phase_ms.items())
        + f"; other host {other!r} ms (host: the first run; device busy: the second, "
        f"each assign_all call profiled)", flush=True)

    # device busy by phase: the largest CCE table's transition alone, profiled
    from torch.profiler import ProfilerActivity, profile

    big = max(cce_feats, key=lambda i: coll.tables[i].d1)
    (g,) = [g for g, grp in enumerate(coll.groups) if big in grp.features]
    grp = coll.groups[g]
    f_local = grp.features.index(big)
    per_p = coll.unstack_group_params(grp, state.params["emb"][g])[f_local]
    per_m = coll.unstack_group_params(grp, state.opt["m"]["emb"][g])[f_local]
    per_b = state.ebuf["emb"][g][f_local]

    def feature_transition():
        _, _, upd = transition_table(coll.tables[big], jr.fold_in(key, big), per_p, per_b,
                                     counts=counts[big], chunk_size=cfg.emb_cluster_chunk)
        upd(per_m)
        torch.cuda.synchronize()

    with PhaseClock(phases) as one, profile(activities=[ProfilerActivity.CPU,
                                                          ProfilerActivity.CUDA]) as prof:
        feature_transition()
    with PhaseBusy(phases) as one_busy:
        feature_transition()
    print(f"[{card}] transition of feature {big} (d1={coll.tables[big].d1}) alone, by phase: "
          + ", ".join(f"{k}: host {v!r} ms, device busy {one_busy.ms[k]!r} ms"
                      for k, v in one.ms.items()) + " (host: profiled for the top list below; "
          "device busy: a second run, each call of a phase profiled)", flush=True)
    top = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)[:8]
    print(f"[{card}] transition of feature {big}, top device time: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3!r} ms x{e.count}" for e in top), flush=True)
    del per_p, per_m, per_b

    state = loop.TrainState(new_p, new_opt, new_b, state.step)
    ops.LAUNCHES.clear()
    post = []
    for mb in batches[TRAIN_STEPS:]:
        state, m = step(state, mb)
        post.append(m["loss"].item())
    launches["train_after_transition"] = dict(ops.LAUNCHES)
    check(launches["train_after_transition"].get("cce_lookup_fwd") == POST_STEPS
          and launches["train_after_transition"].get("cce_lookup_bwd") == POST_STEPS,
          f"post-transition steps {POST_STEPS}, launches {launches['train_after_transition']}")
    check(all(math.isfinite(x) for x in post), f"non-finite loss after the transition {post}")
    print(f"[{card}] train after the transition: losses {post!r}; "
          f"launches {launches['train_after_transition']}", flush=True)

    # one train step's breakdown (host clock, device busy from the profiler)
    mb = batches[-1]
    busy_ms = device_busy_ms(lambda: step(state, mb))
    host_ms = statistics.median(step_ms[1:])
    print(f"[{card}] train step breakdown, batch {TRAIN_BATCH}: host {host_ms!r} ms (median of "
          f"steps 2-{TRAIN_STEPS}; first {step_ms[0]!r} ms), device busy {busy_ms!r} ms "
          f"(idle share {1 - busy_ms / host_ms!r})", flush=True)

    # serving the trained, transitioned state
    engine.update_state(state.params, state.ebuf)
    dense, sparse = raw[-1]["dense"][:SERVE_BATCH], raw[-1]["sparse"][:SERVE_BATCH]
    served = engine.predict(dense, sparse)
    with torch.no_grad():
        fwd = dlrm.forward(state.params, state.ebuf, cfg, {
            "dense": torch.from_numpy(dense).to(device),
            "sparse": torch.from_numpy(sparse).to(device)}).cpu().numpy()
    diff = float(np.abs(fwd - served).max())
    check(bool(np.isfinite(served).all()) and diff <= 1e-5,
          f"served logits after training differ from forward by {diff}")
    print(f"[{card}] serve after train: {len(served)} requests through update_state, "
          f"logits vs forward max_abs_diff={diff!r}", flush=True)
    return launches


def shard_fwd_numbers(card: str, label: str, idx, tables) -> dict:
    """The lookup kernel on one input against its plain version (bit for
    bit), with its times (warm), its bound and ``embedding_bag``'s."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    c, B, _ = idx.shape
    got = cl.cce_lookup_fwd(idx, tables)
    check(torch.equal(got, ref.cce_lookup_ref(idx, tables)), f"lookup kernel != plain ({label})")
    bag, weight, offsets = embedding_bag_args(idx, tables)

    def library():
        return F.embedding_bag(bag, weight, offsets, mode="sum")

    check(torch.allclose(library().reshape(B, -1), got, rtol=1e-6, atol=1e-6),
          f"embedding_bag yardstick computes another function ({label})")
    out = dict(ms=time_ms(lambda: cl.cce_lookup_fwd(idx, tables)),
               device_ms=device_ms(lambda: cl.cce_lookup_fwd(idx, tables),
                                   lookup_kernel("cce_lookup_fwd", tables)),
               plain_ms=time_ms(lambda: ref.cce_lookup_ref(idx, tables)),
               plain_device_ms=device_busy_ms(lambda: ref.cce_lookup_ref(idx, tables), iters=20),
               library_ms=time_ms(library), library_device_ms=device_busy_ms(library, iters=20))
    out["bound_ms"], out["bound_by"] = lookup_bound(idx, tables)
    out["valid_share"] = ((idx >= 0) & (idx < tables.shape[2])).float().mean().item()
    print(f"[{card}] cce_lookup_fwd {label}: c={c} T={idx.shape[2]} k={tables.shape[2]} "
          f"dsub={tables.shape[3]} f32 {cl_path(tables)} B={B}, valid rows "
          f"{out['valid_share']!r}: equal to plain, " + " ".join(
              f"{k}={v!r}" for k, v in out.items() if k != "valid_share"), flush=True)
    return out


def shard_train_phase(card: str, cfg, device="cuda"):
    """The model-parallel DLRM trainer at full width on a world of one
    rank: a (1, 1) mesh over an NCCL group made in-process
    (``init_method="file://"`` in a temp dir), destroyed at the end so
    later phases run without it.
    ``launch.train.build_dlrm_sharded_trainer`` on CONFIG at
    ``emb_k_multiple=SHARD_ROUTE`` (k_pad 308), batch TRAIN_BATCH:
    SHARD_STEPS sharded steps (host-translated rows, the lookup routed
    through all-to-alls), one sharded transition (dense counts of the
    global ids, the moments remapped, the pointer tables through their
    id tiles), SHARD_POST steps.  Held bit for bit against the 1-device
    step and serial transition on the card from the same state: every
    loss, ptr and hs, and every state leaf (this is the mesh's DLRM check:
    the 2-D builder at (1, 1)).  Then the sharded and the
    1-device step timed A B B A, and the SHARD_ROUTE-shard route emulated
    in one process: a batch's rows bucketed into SHARD_ROUTE, each shard's
    lookup (k_loc 77) summed equals the unsharded launch bit for bit and
    each shard's backward, concatenated along k, the unsharded backward;
    each timed beside the unsharded launch, its bound and the library
    call.  Returns ({"shard_train": launches}, {"fwd": numbers, "bwd":
    numbers, "max_abs_err": e})."""
    import argparse
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import random as jr
    from repro_torch.core import cce as cce_lib
    from repro_torch.core.collection import bucket_rows
    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches
    from repro_torch.data.translate import HostTranslator
    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.launch.train import sharded_batches
    from repro_torch.models import dlrm
    from repro_torch.optim import sgd
    from repro_torch.train import loop
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(cfg, emb_k_multiple=SHARD_ROUTE)
    coll = cfg.collection
    (g,) = coll.univ_groups
    grp = coll.groups[g]
    k_loc = grp.k_pad // SHARD_ROUTE
    cce_feats = [i for i, t in enumerate(coll.tables) if isinstance(t, cce_lib.CCE)]
    want_assign = sum(-(-coll.tables[i].d1 // cfg.emb_cluster_chunk) for i in cce_feats)
    n_steps = SHARD_STEPS + SHARD_POST
    t0 = time.perf_counter()
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=SHARD_SEED),
                                 TRAIN_BATCH)
    raw = [next(stream) for _ in range(n_steps)]
    print(f"shard data: {n_steps} batches of {TRAIN_BATCH} in {time.perf_counter() - t0:.3f} s; "
          f"supertable c={grp.n_cols} T={grp.n_tables} k_pad={grp.k_pad} (k_multiple "
          f"{SHARD_ROUTE}) dsub={grp.dsub}", flush=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    mesh = init_mesh(1, 1, "cuda", rank=0, init_method=f"file://{tmp / 'store'}")
    group = mesh.model
    try:
        args = argparse.Namespace(
            device=device, seed=SHARD_SEED, momentum=0.9, lr=TRAIN_LR, clip=1.0, accum=1,
            emb="cce", batch=TRAIN_BATCH, ckpt_dir=None, ckpt_every=0,
            cluster_every=SHARD_STEPS, cluster_max=1, fail_at=[])
        t0 = time.perf_counter()
        trainer = launch.build_dlrm_sharded_trainer(cfg, args, mesh=mesh,
                                                    data_from=lambda s: iter(raw[s:]))
        print(f"shard: Trainer built over a (1, 1) mesh, a {dist.get_backend(group)} group of "
              f"{dist.get_world_size(group)}, in {time.perf_counter() - t0:.3f} s", flush=True)
        # the 1-device reference starts from the same state (a world of one holds it whole)
        ref_state = loop.TrainState(*(tree_map(torch.clone, x) for x in (
            trainer.state.params, trainer.state.opt, trainer.state.ebuf)), step=0)
        trans_ms = []
        sharded_cluster = trainer.cluster_fn

        def cluster_fn(key, p, b, opt):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = sharded_cluster(key, p, b, opt)
            torch.cuda.synchronize()
            trans_ms.append((time.perf_counter() - t) * 1e3)
            return out

        trainer.cluster_fn = cluster_fn
        from repro_torch import shard as shard_mod
        from repro_torch.core import kmeans as km

        targets = [(dlrm, "_transition_layout", "gather slabs, ptr to tiles"),
                   (cce_lib.CCE, "materialize", "sample materialize"),
                   (km, "kmeans_columns", "kmeans++/Lloyd"),
                   (cce_lib.CCE, "assign_all", "assign_all"),
                   (cce_lib.CCE, "remap_moments", "moment remap"),
                   (dlrm, "_ptr_at_rest", "ptr to its layout")]
        n_reduce = collections.Counter()
        all_reduce = shard_mod.all_reduce_

        def counted(x, grp):
            n_reduce[x.device.type] += 1
            return all_reduce(x, grp)

        shard_mod.all_reduce_ = counted
        # the process's first torch.use_deterministic_algorithms (kmeans' cumsum and the
        # remap's index_add_ take it) imports torch._inductor: taken here, before either
        # transition is timed
        t = time.perf_counter()
        with km.deterministic():
            pass
        warm_ms = (time.perf_counter() - t) * 1e3
        ops.LAUNCHES.clear()
        try:
            with PhaseClock(targets) as clock:
                trainer.run(n_steps)
            torch.cuda.synchronize()
        finally:
            shard_mod.all_reduce_ = all_reduce
        launches = dict(ops.LAUNCHES)
        check(launches.get("cce_lookup_fwd") == n_steps and launches.get("cce_lookup_bwd")
              == n_steps and launches.get("kmeans_assign") == want_assign,
              f"shard_train launches {launches}: want {n_steps} a lookup kernel and "
              f"{want_assign} kmeans_assign")
        losses = [h["loss"] for h in trainer.history]
        check(trainer.clusters_done == 1 and all(math.isfinite(x) for x in losses),
              f"sharded run: {trainer.clusters_done} transitions, losses {losses}")

        # the 1-device step and the serial transition, on the same rows
        opt = sgd(momentum=0.9)

        def loss_fn(p, b, mb):
            return dlrm.bce_loss(p, b, cfg, mb), {}

        step = loop.make_train_step(loss_fn, opt, lambda s: TRAIN_LR, clip_norm=1.0)
        translator = HostTranslator(coll, ref_state.ebuf["emb"])

        def on(batch):
            rows = torch.from_numpy(translator.rows(batch["sparse"]))
            return {k: v[None].to(device) for k, v in (
                ("dense", torch.from_numpy(batch["dense"])),
                ("label", torch.from_numpy(batch["label"])), ("rows", rows))}

        serial_phases = [(cce_lib.CCE, "materialize", "sample materialize"),
                         (km, "kmeans_columns", "kmeans++/Lloyd"),
                         (cce_lib.CCE, "assign_all", "assign_all"),
                         (cce_lib.CCE, "remap_moments", "moment remap")]
        state, ref_losses, serial_ms = ref_state, [], None
        for i, batch in enumerate(raw):
            if i == SHARD_STEPS:
                counts = [np.bincount(np.concatenate([b["sparse"][:, f] for b in raw[:i]]),
                                      minlength=v) for f, v in enumerate(cfg.vocab_sizes)]
                with PhaseClock(serial_phases) as serial_clock:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    p2, b2, o2 = dlrm.cluster_tables(jr.fold_in(jr.PRNGKey(SHARD_SEED), i),
                                                     state.params, state.ebuf, cfg, state.opt,
                                                     id_counts=counts)
                    torch.cuda.synchronize()
                    serial_ms = (time.perf_counter() - t) * 1e3
                state = loop.TrainState(p2, o2, b2, state.step)
                translator.update(b2["emb"])
            state, m = step(state, on(batch))
            ref_losses.append(m["loss"].item())
        check(losses == ref_losses, f"sharded losses {losses} != 1-device {ref_losses}")
        for a, b, what in ((trainer.state.ebuf["emb"], state.ebuf["emb"], "ptr/hs/epoch"),
                           (trainer.state.params, state.params, "params"),
                           (trainer.state.opt, state.opt, "moments")):
            check(all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b))),
                  f"the sharded run's {what} differ from the 1-device run's")
        print(f"[{card}] shard_train: {n_steps} sharded steps at batch {TRAIN_BATCH}, a sharded "
              f"transition after step {SHARD_STEPS}; losses {losses!r}; launches {launches}; "
              f"every loss, the transition's ptr and hs, and every state leaf equal the 1-device "
              f"step's and serial transition's on the card bit for bit (mesh (d): the 2-D "
              f"builder at (1, 1))", flush=True)
        print(f"[{card}] shard_train transition: sharded (world of 1) host {trans_ms[0]!r} ms, "
              f"serial host {serial_ms!r} ms (by phase: " + ", ".join(
                  f"{k} {v!r} ms" for k, v in serial_clock.ms.items()) + "); both after a "
              f"first use of deterministic algorithms ({warm_ms!r} ms here)", flush=True)

        # one collective's cost on this group
        x = torch.ones((250, 5), device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            all_reduce(x, group)
        torch.cuda.synchronize()
        ar_ms = (time.perf_counter() - t) * 1e3 / 200
        print(f"[{card}] shard_train transition by phase (the Trainer's, each top-level call "
              f"synchronised): " + ", ".join(f"{k}: host {v!r} ms ({clock.calls[k]} calls)"
                                             for k, v in clock.ms.items())
              + f"; {sum(n_reduce.values())} all-reduces in the run (steps included); an "
              f"all-reduce of 250 x 5 floats back to back {ar_ms!r} ms", flush=True)

        # the steps' times, A B B A in this call
        shard_mb = trainer._to_device(next(sharded_batches(iter(raw[-1:]), trainer.translator,
                                                           0, 1)))
        one_mb = on(raw[-1])

        def timed(fn):
            ms = []
            for _ in range(SHARD_TIMED):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            return statistics.median(ms), device_busy_ms(fn)

        def shard_step():
            trainer.state = trainer.train_step(trainer.state, shard_mb)[0]

        def one_step():
            nonlocal state
            state = step(state, one_mb)[0]

        runs = [("sharded", timed(shard_step)), ("1-device", timed(one_step)),
                ("1-device", timed(one_step)), ("sharded", timed(shard_step))]
        print(f"[{card}] shard_train step, batch {TRAIN_BATCH} (A B B A): " + "; ".join(
            f"{k} host {h!r} ms, device busy {b!r} ms" for k, (h, b) in runs), flush=True)

        # the SHARD_ROUTE-shard route in one process, on a train batch's rows
        rows = torch.from_numpy(trainer.translator.rows(raw[-1]["sparse"])).to(device)
        idx = rows.movedim(0, 1)  # (c, B, T), the strided view the path gives
        tables = trainer.state.params["emb"][g]["tables"]
        dout = torch.randn((TRAIN_BATCH, grp.n_cols, grp.dsub),
                           generator=torch.Generator(device=device).manual_seed(SHARD_SEED),
                           device=device)
        buckets = bucket_rows(rows, k_loc, SHARD_ROUTE)  # (M, B, c, T)
        shard_idx = [buckets[s].movedim(0, 1) for s in range(SHARD_ROUTE)]
        slabs = [tables[:, :, s * k_loc:(s + 1) * k_loc].contiguous() for s in range(SHARD_ROUTE)]
        whole_fwd = cl.cce_lookup_fwd(idx, tables)
        parts = torch.stack([cl.cce_lookup_fwd(i, t) for i, t in zip(shard_idx, slabs)])
        check(torch.equal(parts.sum(0), whole_fwd),
              f"the {SHARD_ROUTE} shards' lookups summed differ from the unsharded launch")
        whole_bwd = cl.cce_lookup_bwd(idx, dout, grp.k_pad)
        bwd_parts = [cl.cce_lookup_bwd(i, dout, k_loc) for i in shard_idx]
        check(torch.equal(torch.cat(bwd_parts, dim=2), whole_bwd),
              f"the {SHARD_ROUTE} shards' backwards concatenated differ from the unsharded one")
        label = f"shard 0 of {SHARD_ROUTE} (k_loc {k_loc}, a train batch's rows)"
        fwd = shard_fwd_numbers(card, label, shard_idx[0], slabs[0])
        bwd_err, bwd = bwd_check(card, label, shard_idx[0], dout, k_loc, plain_busy=False)
        fwd_kernel = lookup_kernel("cce_lookup_fwd", tables)
        shard_fwd = [device_ms(lambda i=i, t=t: cl.cce_lookup_fwd(i, t), fwd_kernel)
                     for i, t in zip(shard_idx, slabs)]
        shard_bwd = [device_busy_ms(lambda i=i: cl.cce_lookup_bwd(i, dout, k_loc),
                                    iters=TRACE_RECORDS) for i in shard_idx]
        fwd["unsharded_device_ms"] = device_ms(lambda: cl.cce_lookup_fwd(idx, tables), fwd_kernel)
        bwd["unsharded_device_ms"] = device_busy_ms(
            lambda: cl.cce_lookup_bwd(idx, dout, grp.k_pad), iters=TRACE_RECORDS)
        fwd["by_shard_device_ms"], bwd["by_shard_device_ms"] = shard_fwd, shard_bwd
        print(f"[{card}] shard route emulated at {SHARD_ROUTE} shards: the shards' lookups summed "
              f"and backwards concatenated equal the unsharded launches bit for bit; lookup "
              f"device_ms by shard {shard_fwd!r} vs unsharded {fwd['unsharded_device_ms']!r}; "
              f"backward device_ms by shard {shard_bwd!r} vs unsharded "
              f"{bwd['unsharded_device_ms']!r}", flush=True)
        shape = dict(c=grp.n_cols, T=grp.n_tables, k_loc=k_loc, dsub=grp.dsub, B=TRAIN_BATCH,
                     shards=SHARD_ROUTE, valid_share=fwd["valid_share"])
        return ({"shard_train": launches}, dict(fwd=dict(fwd, shape=shape),
                                                bwd=dict(bwd, shape=shape), max_abs_err=bwd_err))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _host_cells(tracker, sparse):
    """The tracker's sketch cells of one batch, counted on the host with
    ``CountMinSketch.cells``: (F_tracked, depth, width) int32."""
    import numpy as np

    cms0 = tracker.features[tracker.tracked[0]].cms
    out = np.zeros((len(tracker.tracked), cms0.depth, cms0.width), np.int32)
    for j, f in enumerate(tracker.tracked):
        cells = tracker.features[f].cms.cells(sparse[:, f])
        for r in range(cells.shape[0]):
            np.add.at(out[j, r], cells[r], 1)
    return out


def loop_phase(card: str, cfg, device="cuda"):
    """The paper's training loop at full width, through
    ``launch.train.build_dlrm_trainer``: a Trainer with the sketch tracker
    (cell count in the step, async host fold), the entropy/drift trigger
    and the periodic fallback, telemetry, a run log and async checkpoints.
    One run of LOOP_STEPS steps; a second run crashes at LOOP_FAIL_AT,
    restores the latest checkpoint and resumes, and must end bit for bit
    where the first ended; the last checkpoint restores into a CPU
    Trainer; the trained tracker's heads feed a served batch.  Then the
    timings: the step against the plain step, synchronised, and the
    Trainer's loop unsynchronised three ways.  Returns {"loop": launches}."""
    import argparse
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import list_checkpoints
    from repro_torch.configs.dlrm_criteo import STREAM
    from repro_torch.core import cce as cce_lib
    from repro_torch.core import kmeans as km
    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models import dlrm
    from repro_torch.obs.pump import MetricsPump
    from repro_torch.obs.runlog import read_runlog
    from repro_torch.optim import sgd
    from repro_torch.serve.dlrm import DLRMServeEngine
    from repro_torch.stream.trigger import ClusterTrigger
    from repro_torch.train import loop
    from repro_torch.train import transition as trans_mod
    from repro_torch.tree import jax_leaves, jax_leaves_with_paths

    coll = cfg.collection
    cce_feats = [i for i, t in enumerate(coll.tables) if isinstance(t, cce_lib.CCE)]
    assign_per_transition = sum(-(-coll.tables[i].d1 // cfg.emb_cluster_chunk)
                                for i in cce_feats)
    t0 = time.perf_counter()
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=LOOP_SEED),
                                 TRAIN_BATCH)
    raw = [next(stream) for _ in range(LOOP_STEPS)]  # made once, replayed from any step
    print(f"loop data: {len(raw)} batches of {TRAIN_BATCH} in {time.perf_counter() - t0:.3f} s",
          flush=True)

    def data_from(start):
        return iter(raw[start:])

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_loop_"))
    stream_cfg = dataclasses.replace(STREAM, window=LOOP_WINDOW)

    def build(tag, fail_at=(), dev=device, ckpt_dir=None, obs=True):
        args = argparse.Namespace(
            device=dev, seed=LOOP_SEED, momentum=0.9, lr=TRAIN_LR, clip=1.0, accum=1,
            emb="cce", batch=TRAIN_BATCH, ckpt_dir=ckpt_dir or str(tmp / tag / "ckpt"),
            ckpt_every=LOOP_CKPT_EVERY, keep_last=LOOP_KEEP_LAST,
            cluster_every=LOOP_CLUSTER_EVERY, cluster_max=LOOP_CLUSTER_MAX,
            fail_at=list(fail_at), obs=str(tmp / tag / "run.jsonl") if obs else None)
        if obs:
            (tmp / tag).mkdir(parents=True, exist_ok=True)
        t = time.perf_counter()
        trainer = launch.build_dlrm_trainer(
            cfg, args, stream=stream_cfg, data_from=data_from,
            trigger=ClusterTrigger(entropy_drop=0.1, drift_threshold=0.25, warmup=2))
        print(f"loop: {tag} Trainer built on {dev} in {time.perf_counter() - t:.3f} s", flush=True)
        return trainer

    phases = [(trans_mod, "_draw_points", "sketch points"),
              (trans_mod, "_dense_weights", "sketch id_weights"),
              (cce_lib.CCE, "materialize", "sample materialize"),
              (km, "kmeans_columns", "kmeans++/Lloyd"),
              (cce_lib.CCE, "assign_all", "assign_all"),
              (cce_lib.CCE, "remap_moments", "moment remap")]
    try:
        # the uninterrupted run; its first step's in-step delta kept aside
        clean = build("clean")
        tracker = clean.id_tracker
        seen, observe_ms = {}, []
        orig_observe = tracker.observe

        def observe(batch, *, delta=None):
            if "delta" not in seen:
                seen.update(delta=delta.clone(), sparse=np.asarray(batch["sparse"]).copy())
            t = time.perf_counter()
            orig_observe(batch, delta=delta)
            observe_ms.append((time.perf_counter() - t) * 1e3)

        tracker.observe = observe
        ops.LAUNCHES.clear()
        t0 = time.perf_counter()
        with PhaseClock([(loop.Trainer, "_transition", "transition")]) as whole, \
                PhaseClock(phases) as by_phase:
            clean.run(LOOP_STEPS)
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t0
        launches_clean = dict(ops.LAUNCHES)
        n_trans = whole.calls["transition"]
        check(clean.state.step == LOOP_STEPS and clean.clusters_done == n_trans >= 1,
              f"clean run: step {clean.state.step}, clusters {clean.clusters_done}, "
              f"transitions {n_trans}")
        check(launches_clean.get("cce_lookup_fwd") == LOOP_STEPS
              and launches_clean.get("cce_lookup_bwd") == LOOP_STEPS
              and launches_clean.get("kmeans_assign") == assign_per_transition * n_trans,
              f"clean run launches {launches_clean}: {LOOP_STEPS} steps, {n_trans} transitions "
              f"of {assign_per_transition} assignment launches")
        losses = {h["step"]: h["loss"] for h in clean.history}
        check(sorted(losses) == list(range(LOOP_STEPS))
              and all(math.isfinite(x) for x in losses.values()), f"clean losses {losses}")
        trig = [e.as_dict() for e in clean.trigger.events]
        print(f"[{card}] loop: {LOOP_STEPS} steps at batch {TRAIN_BATCH} in {clean_s:.3f} s, "
              f"{n_trans} transitions (steps {[r['step'] for r in read_runlog(clean.runlog.path) if r['event'] == 'transition']}), "
              f"launches {launches_clean}; losses first {losses[0]!r} last "
              f"{losses[LOOP_STEPS - 1]!r}; trigger {[(e['step'], round(e['entropy'], 4), round(e['drift'], 4), e['reason'] or 'held') for e in trig]}",
              flush=True)

        # check 2: the in-step delta of step 0 == the host cells of its batch
        want = _host_cells(tracker, seen["sparse"])
        got = seen["delta"].cpu().numpy()
        check(got.dtype == np.int32 and got.shape == want.shape and np.array_equal(got, want),
              f"step 0's in-step sketch delta differs from the host cells "
              f"({int(np.abs(got.astype(np.int64) - want).sum())} counts off)")
        print(f"[{card}] loop: step 0's in-step sketch delta {got.shape} equals the host "
              f"CountMinSketch.cells count of its batch bit for bit ({int(got.sum())} counts)",
              flush=True)

        # check 3: crash at LOOP_FAIL_AT, restore, resume: bit for bit
        crash = build("crash", fail_at=(LOOP_FAIL_AT,))
        ops.LAUNCHES.clear()
        with PhaseClock([(loop.Trainer, "_transition", "transition")]) as crash_whole:
            try:
                crash.run(LOOP_STEPS)
                check(False, f"no failure at step {LOOP_FAIL_AT}")
            except loop.InjectedFailure:
                pass
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restored = crash.restore_latest()
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            check(restored == LOOP_FAIL_AT // LOOP_CKPT_EVERY * LOOP_CKPT_EVERY,
                  f"restored to step {restored}")
            crash.data_iter = data_from(restored)
            crash.run(LOOP_STEPS - restored)
        launches_crash = dict(ops.LAUNCHES)
        n_steps_run = LOOP_FAIL_AT + LOOP_STEPS - restored
        n_trans_crash = crash_whole.calls["transition"]
        check(launches_crash.get("cce_lookup_fwd") == n_steps_run
              and launches_crash.get("cce_lookup_bwd") == n_steps_run
              and launches_crash.get("kmeans_assign") == assign_per_transition * n_trans_crash,
              f"crash run launches {launches_crash}: {n_steps_run} steps run, "
              f"{n_trans_crash} transitions")
        diffs = []
        for what, a, b in (("params", crash.state.params, clean.state.params),
                           ("moments", crash.state.opt, clean.state.opt),
                           ("ptr/hs/epoch", crash.state.ebuf, clean.state.ebuf)):
            la, lb = jax_leaves(a), jax_leaves(b)
            if len(la) != len(lb) or not all(torch.equal(x, y) for x, y in zip(la, lb)):
                diffs.append(what)
        for what, a, b in (("tracker", crash.id_tracker.state_tree(), tracker.state_tree()),
                           ("trigger", crash.trigger.state_tree(), clean.trigger.state_tree())):
            if len(a) != len(b) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
                diffs.append(what)
        if crash.clusters_done != clean.clusters_done or crash.state.step != LOOP_STEPS:
            diffs.append(f"clusters_done {crash.clusters_done} / step {crash.state.step}")
        bad_loss = sorted({h["step"] for h in crash.history if h["loss"] != losses[h["step"]]})
        if bad_loss or sorted({h["step"] for h in crash.history}) != list(range(LOOP_STEPS)):
            diffs.append(f"losses at steps {bad_loss}")
        check(not diffs, f"crash and resume differs from the uninterrupted run in {diffs}")
        recs = read_runlog(crash.runlog.path)
        keys = [(r["event"], r["step"]) for r in recs
                if "step" in r and r["event"] not in ("fault", "checkpoint_restore")]
        dup = sorted({k for k in keys if keys.count(k) > 1})
        check(not dup, f"the crash run's log repeats {dup}")
        check([r["step"] for r in recs if r["event"] == "step"] == list(range(LOOP_STEPS)),
              "the crash run's log does not hold each step once")
        print(f"[{card}] loop: crash at step {LOOP_FAIL_AT}, restore from step {restored} in "
              f"{restore_ms!r} ms, resume to {LOOP_STEPS}: params, moments, ptr/hs/epoch, "
              f"tracker, trigger, clusters_done ({crash.clusters_done}) and all {LOOP_STEPS} "
              f"losses equal the uninterrupted run bit for bit ({n_steps_run} steps run, "
              f"launches {launches_crash}); its run log holds no (event, step) twice",
              flush=True)
        del crash

        # check 4: the card's last checkpoint restores into a CPU Trainer
        last = list_checkpoints(clean.ckpt.directory)[-1]
        with open(pathlib.Path(last[1]) / "manifest.json") as f:
            manifest = json.load(f)
        on_cpu = build("cpu", dev="cpu", ckpt_dir=clean.ckpt.directory, obs=False)
        t0 = time.perf_counter()
        check(on_cpu.restore_latest() == LOOP_STEPS, "the CPU restore found another step")
        cpu_restore_ms = (time.perf_counter() - t0) * 1e3
        paths = [p for p, _ in jax_leaves_with_paths(on_cpu._ckpt_tree())]
        hs = [i for i, p in enumerate(paths) if p.endswith("['hs']")]
        check(manifest["n_leaves"] == len(paths) and hs
              and all(manifest["leaves"][i]["dtype"] == "uint32" for i in hs),
              f"the checkpoint's hs leaves on disk: "
              f"{sorted({manifest['leaves'][i]['dtype'] for i in hs})}")
        bad = [p for (p, x), y in zip(jax_leaves_with_paths(on_cpu.state), jax_leaves(clean.state))
               if not (torch.equal(x, y.cpu()) if isinstance(x, torch.Tensor) else x == y)]
        bad += ["tracker"] * (not all(np.array_equal(x, y) for x, y in zip(
            on_cpu.id_tracker.state_tree(), tracker.state_tree())))
        check(not bad and on_cpu.clusters_done == clean.clusters_done
              and all(x.device.type == "cpu" for x in jax_leaves(on_cpu.state.params)),
              f"the card checkpoint restored on the CPU differs at {bad[:5]}")
        print(f"[{card}] loop: the card's checkpoint of step {LOOP_STEPS} ({manifest['n_leaves']} "
              f"leaves, {len(hs)} hs leaves uint32 on disk) restores into a CPU Trainer in "
              f"{cpu_restore_ms!r} ms with every leaf equal", flush=True)
        del on_cpu

        # check 5: serve a batch from the final state with the trained tracker's heads
        engine = DLRMServeEngine(clean.state.params, clean.state.ebuf, cfg, tracker=tracker,
                                 max_batch=SERVE_BATCH)
        dense, sparse = raw[-1]["dense"][:SERVE_BATCH], raw[-1]["sparse"][:SERVE_BATCH]
        ops.LAUNCHES.clear()
        served = engine.predict(dense, sparse)
        launches_serve = dict(ops.LAUNCHES)
        with torch.no_grad():
            fwd = dlrm.forward(clean.state.params, clean.state.ebuf, cfg, {
                "dense": torch.from_numpy(dense).to(device),
                "sparse": torch.from_numpy(sparse).to(device)}).cpu().numpy()
        diff = float(np.abs(fwd - served).max())
        hits = engine.counters["n_id_hits"]
        check(bool(np.isfinite(served).all()) and diff <= 1e-5,
              f"served logits differ from forward by {diff}")
        check(hits > 0 and launches_serve.get("cce_lookup_fwd", 0) == engine.counters["n_launches"],
              f"serve: {hits} cache hits, launches {launches_serve}, engine {engine.counters}")
        print(f"[{card}] loop: served {len(served)} requests from the final state with the "
              f"tracker's heads ({engine.cache.n_slots} cache slots): logits vs forward "
              f"max_abs_diff={diff!r}, {hits} of {engine.counters['n_id_lookups']} id lookups "
              f"hit the cache, launches {launches_serve}", flush=True)
        launches = collections.Counter(launches_clean)
        launches.update(launches_crash)
        launches.update(launches_serve)

        # where the time goes
        dts = [h["dt"] * 1e3 for h in clean.history if h.get("dt") is not None]
        folds = tracker._folder.fold_ms
        print(f"[{card}] loop step timing: dispatch-to-dispatch host {statistics.median(dts)!r} "
              f"ms (median of {len(dts)}; max {max(dts)!r}); tracker.observe on the step's "
              f"thread {statistics.median(observe_ms)!r} ms (median; max {max(observe_ms)!r}); "
              f"sketch fold on its thread {statistics.median(folds)!r} ms (median of "
              f"{len(folds)}; max {max(folds)!r})", flush=True)
        print(f"[{card}] loop checkpoints: enqueue (host copy) ms {clean.ckpt.enqueue_ms!r}, "
              f"write ms {clean.ckpt.write_ms!r}; restore {restore_ms!r} ms on the card, "
              f"{cpu_restore_ms!r} ms on the CPU", flush=True)
        print(f"[{card}] loop transition by phase ({n_trans} transitions): total host "
              f"{whole.ms['transition']!r} ms; " + ", ".join(
                  f"{k}: host {v!r} ms over {by_phase.calls[k]} calls"
                  for k, v in by_phase.ms.items())
              + f"; other host {whole.ms['transition'] - sum(by_phase.ms.values())!r} ms",
              flush=True)

        # the step with the tracker and telemetry against the plain step, on
        # one state and batch: plain; the step with its sketch count and
        # telemetry alone; that and the tracker's observe and the pump
        # (the loop's step); in turns, forth and back
        batch = clean._to_device(raw[-1])

        def loss_fn(p, b, mb):
            return dlrm.bce_loss(p, b, cfg, mb), {}

        plain_step = loop.make_train_step(loss_fn, sgd(momentum=0.9), lambda s: TRAIN_LR,
                                          clip_norm=1.0)
        pump = MetricsPump(lag=8)

        def plain():
            clean.state, _ = plain_step(clean.state, batch)

        def hooks():
            clean.state, _ = clean.train_step(clean.state, batch)

        def full():
            clean.state, m = clean.train_step(clean.state, batch)
            tracker.observe(raw[-1], delta=m.pop("sketch_delta"))
            pump.push(clean.state.step, m)

        def drain():
            # the loop step's folds run on the fold thread after it returns:
            # no variant is timed while an earlier one's backlog drains
            tracker.flush()
            pump.flush()

        def host_ms(fn, n=8):
            ts = []
            for _ in range(n):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t) * 1e3)
            drain()
            return statistics.median(ts)

        variants = {"plain": plain, "step with hooks": hooks, "loop step": full}
        order = list(variants) + list(variants)[::-1]
        host = collections.defaultdict(list)
        for name in order:
            host[name].append(host_ms(variants[name]))
        busy = {}
        for name, fn in variants.items():
            busy[name] = device_busy_ms(fn)
            drain()
        print(f"[{card}] loop step vs the plain step, batch {TRAIN_BATCH}, synchronised "
              f"({', '.join(order)}; medians of 8, the fold drained after each block): "
              + "; ".join(f"{name}: host {host[name]!r} ms, device busy {busy[name]!r} ms"
                          for name in variants), flush=True)

        # the Trainer's own loop, unsynchronised, dispatch to dispatch: the
        # fold on its thread (as the loop runs it), on the step's thread
        # (after each step), and no tracker.  If the fold and the step's
        # dispatch serialise on the host, the first two are alike and near
        # the third plus a fold; if they overlap, the first is near the
        # larger of the third and a fold
        clean.ckpt = None  # no saves in these runs
        folder = tracker._folder

        def run_loop(mode):
            clean.id_tracker = None if mode == "no tracker" else tracker
            tracker._folder = None if mode == "fold on the step's thread" else folder
            clean.data_iter = iter(raw[:LOOP_TIMED_STEPS])
            clean._last_dispatch = None
            start, n_folds, n_observes = clean.state.step, len(folder.fold_ms), len(observe_ms)
            clean.run(LOOP_TIMED_STEPS)
            tracker._folder = folder
            clean.id_tracker = tracker
            drain()
            # a fold's ms: on its thread, or inside observe on the step's
            folds = list(folder.fold_ms)[n_folds:] or observe_ms[n_observes:]
            return (statistics.median(h["dt"] * 1e3 for h in clean.history
                                      if h["step"] >= start and h.get("dt") is not None),
                    statistics.median(folds) if folds else None)

        modes = ("fold on its thread", "fold on the step's thread", "no tracker")
        order = list(modes) + list(modes)[::-1]
        d2d, fold = collections.defaultdict(list), collections.defaultdict(list)
        for mode in order:
            dt, fold_ms = run_loop(mode)
            d2d[mode].append(dt)
            fold[mode].append(fold_ms)
        print(f"[{card}] loop dispatch to dispatch, the Trainer unsynchronised ({', '.join(order)}; "
              f"medians of {LOOP_TIMED_STEPS - 1} steps): " + "; ".join(
                  f"{mode}: {d2d[mode]!r} ms (a fold {fold[mode]!r} ms)" for mode in modes),
              flush=True)
        return {"loop": dict(launches)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def serve_phase(card: str, cfg, n_batches: int, device="cuda") -> int:
    """Serve ``n_batches`` batches of requests through DLRMServeEngine
    (submit/step/drain), with the launch counts reset just before; hold
    the logits against the port's forward.  Returns the lookup kernel's
    launches in that run."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.serve.dlrm import DLRMServeEngine, ServeRequest

    t0 = time.perf_counter()
    params, buffers = dlrm.init(cfg, torch.Generator().manual_seed(0), device=device)
    engine = DLRMServeEngine(params, buffers, cfg, max_batch=SERVE_BATCH)
    on_card = torch.cuda.memory_allocated() / 2**20 if device == "cuda" else 0.0
    print(f"init: {sum(cfg.vocab_sizes)} ids, {cfg.n_emb_params()} embedding params, "
          f"{on_card:.1f} MiB on the card, {time.perf_counter() - t0:.3f} s")
    print(f"hot cache: {len(engine.cache.ids)} features, {engine.cache.n_slots} slots")
    t0 = time.perf_counter()
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes), SERVE_BATCH)
    batches = [next(stream) for _ in range(n_batches + 1)]
    print(f"data: {n_batches + 1} batches of {SERVE_BATCH} in {time.perf_counter() - t0:.3f} s")
    warm = batches.pop()
    engine.predict(warm["dense"], warm["sparse"])  # first-call set-up stays out of the run

    ops.LAUNCHES.clear()
    n0 = engine.counters["n_launches"]
    results = []
    t0 = time.perf_counter()
    uid = 0
    for batch in batches:
        for i in range(SERVE_BATCH):
            engine.submit(ServeRequest(uid=uid, dense=batch["dense"][i], sparse=batch["sparse"][i]))
            uid += 1
            results.extend(engine.step())
    results.extend(engine.drain())
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["cce_lookup_fwd"]
    served_launches = engine.counters["n_launches"] - n0
    check(served_launches > 0, "the serve run launched no lookup")
    check(launches == served_launches,
          f"kernel launches {launches} != engine cold launches {served_launches}")
    check(sorted(r.uid for r in results) == list(range(uid)), "not every request was answered once")
    logits = np.array([r.logit for r in sorted(results, key=lambda r: r.uid)], np.float32)
    check(bool(np.isfinite(logits).all()), "non-finite served logits")

    diffs = []
    with torch.no_grad():
        for j, batch in enumerate(batches):
            fwd = dlrm.forward(params, buffers, cfg, {
                "dense": torch.from_numpy(batch["dense"]).to(device),
                "sparse": torch.from_numpy(batch["sparse"]).to(device).long(),
            }).cpu().numpy()
            diffs.append(float(np.abs(fwd - logits[j * SERVE_BATCH:(j + 1) * SERVE_BATCH]).max()))
    check(max(diffs) <= 1e-5, f"served logits differ from forward by {max(diffs)}")
    lat = np.array([r.latency_s for r in results]) * 1e3
    print(f"[{card}] serve: {uid} requests, {engine.counters['n_batches'] - 1} batches, "
          f"{served_launches} cold launches, cce_lookup_fwd launches {launches}, "
          f"{wall:.3f} s wall, {uid / wall:.1f} requests/s")
    print(f"[{card}] serve latency (submit to result, host clock): "
          f"p50={float(np.percentile(lat, 50))!r} ms p99={float(np.percentile(lat, 99))!r} ms")
    print(f"served logits vs forward: max_abs_diff={max(diffs)!r}; "
          f"logit range [{float(logits.min())!r}, {float(logits.max())!r}]")

    # where one full batch's time goes (host clock, device busy from the profiler)
    dense, sparse = batches[0]["dense"], batches[0]["sparse"].astype(np.int64)
    t0 = time.perf_counter()
    _, hit = engine.cache.slots(sparse)
    t1 = time.perf_counter()
    engine.translator.rows_masked(sparse, hit)
    t2 = time.perf_counter()
    engine.predict(dense, sparse)
    if device == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    busy = device_busy_ms(lambda: engine.predict(dense, sparse))
    predict_ms = (t3 - t2) * 1e3
    print(f"[{card}] serve breakdown, one batch of {SERVE_BATCH}: cache.slots "
          f"{(t1 - t0) * 1e3!r} ms, translator.rows_masked {(t2 - t1) * 1e3!r} ms, "
          f"predict {predict_ms!r} ms, device busy {busy!r} ms "
          f"(idle share {1 - busy / predict_ms!r})")
    return launches


METHODS = ("full", "hash", "ce", "hemb", "robe", "dhe", "tt")  # the paper's comparisons
METHOD_STEPS = 8  # timed steps a method, after the first step's check
METHOD_KERNEL_SHAPES = ("hash", "ce")  # the methods whose supertable takes the lookup kernels
PQ_FEATURE = 2  # Criteo's largest table (10,131,227 ids), from the full run
PQ_C, PQ_K, PQ_SAMPLE, PQ_NITER = 4, 250, 1 << 18, 50
LS_SHAPE = (10_000, 1000, 10)  # (n, d1, d2): Figure 1b's scale
LS_K, LS_ITERS = 100, 25
# Card vs CPU, final loss, relative.  Dense CCE has no discrete step: the two
# differ by float sums alone.  Sparse CCE's k-means picks may part on the card
# and the CPU, after which the two are runs of Algorithm 2 that share a key and
# no more: its limit sits above the spread of the final loss over LS_KEYS.
LS_RTOL = {"dense": 1e-4, "sparse": 4e-3}
LS_KEYS = (2, 3, 4, 5)  # further keys of sparse CCE on the card: the spread of its final loss


def top_kernels(fn, n: int = 4) -> list[tuple[str, float]]:
    """The ``n`` CUDA kernels with the most device time a call of ``fn``
    (torch.profiler over 4 calls after one warm-up): (name cut to 60
    characters, ms a call)."""
    events = [e for e in _profile(fn, 4) if _device_us(e)]
    events.sort(key=lambda e: _device_us(e), reverse=True)
    return [(e.key[:60], _device_us(e) / 1e3 / 4) for e in events[:n]]


def method_kernel_numbers(card: str, m: str, mcfg, params, buffers, raw, device="cuda"):
    """The lookup and its backward at the shape ``m``'s supertable gives
    them (the rows ``group_rows`` makes from train batches): forward bit
    for bit against the plain version at the serve and the train batch,
    backward through ``bwd_check``, each timed at the train batch beside
    its bound and ``embedding_bag`` / ``zeros``+``index_add_``.  Returns
    (max error, {"fwd": numbers, "bwd": numbers})."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    coll = mcfg.collection
    (g,) = coll.univ_groups
    grp = coll.groups[g]
    tables = params["emb"][g]["tables"].detach()
    c, T, k, dsub = tables.shape
    shape = dict(c=c, T=T, k=k, dsub=dsub, layout=cl_path(tables))
    want_layout = {16: "narrow", 4: "vec4"}.get(dsub)
    check(want_layout is None or shape["layout"] == want_layout,
          f"{m}: dsub={dsub} takes {shape['layout']}, not {want_layout}")
    max_err = 0.0
    for B in (SERVE_BATCH, TRAIN_BATCH):
        ids = torch.from_numpy(raw[1]["sparse"][:B]).to(device)[:, list(grp.features)]
        idx = coll.group_rows(grp, buffers["emb"][g], ids)  # (c, B, 1)
        got = cl.cce_lookup_fwd(idx, tables)
        want = ref.cce_lookup_ref(idx, tables)
        err = (got - want).abs().max().item()
        check(torch.equal(got, want), f"{m}: lookup kernel != plain at B={B} (max err {err})")
        max_err = max(max_err, err)
    ms = time_ms(lambda: cl.cce_lookup_fwd(idx, tables))
    dev = device_ms(lambda: cl.cce_lookup_fwd(idx, tables), lookup_kernel("cce_lookup_fwd", tables))
    plain = time_ms(lambda: ref.cce_lookup_ref(idx, tables))
    plain_dev = device_busy_ms(lambda: ref.cce_lookup_ref(idx, tables), iters=20)
    bound, bound_by = lookup_bound(idx, tables)
    bag, weight, offsets = embedding_bag_args(idx, tables)
    lib_out = F.embedding_bag(bag, weight, offsets, mode="sum")
    check(torch.allclose(lib_out.reshape(TRAIN_BATCH, -1), got, rtol=1e-6, atol=1e-6),
          f"{m}: embedding_bag yardstick computes another function")
    lib = time_ms(lambda: F.embedding_bag(bag, weight, offsets, mode="sum"))
    lib_dev = device_busy_ms(lambda: F.embedding_bag(bag, weight, offsets, mode="sum"), iters=20)
    fwd = dict(ms=ms, device_ms=dev, plain_ms=plain, plain_device_ms=plain_dev, bound_ms=bound,
               bound_by=bound_by, library_ms=lib, library_device_ms=lib_dev, batch=TRAIN_BATCH,
               **shape)
    print(f"[{card}] cce_lookup_fwd at the {m} shape c={c} T={T} k={k} dsub={dsub} "
          f"{shape['layout']} B={TRAIN_BATCH}: equal to plain at B={SERVE_BATCH} and "
          f"{TRAIN_BATCH}; ms={ms!r} device_ms={dev!r} plain_ms={plain!r} "
          f"plain_device_ms={plain_dev!r} bound_ms={bound!r} ({bound_by}) "
          f"library_ms(embedding_bag)={lib!r} library_device_ms={lib_dev!r}", flush=True)
    gen = torch.Generator(device=device).manual_seed(len(m))
    dout = torch.randn((TRAIN_BATCH, c, dsub), generator=gen, device=device)
    ks = torch.tensor(column_ks(coll), device=device)
    err, bwd = bwd_check(card, f"at the {m} shape c={c} T={T} k={k} dsub={dsub} "
                         f"{cl_path(dout)} B={TRAIN_BATCH}", idx, dout, k, ks, plain_busy=False)
    return max(max_err, err), {"fwd": fwd, "bwd": dict(bwd, batch=TRAIN_BATCH, **shape)}


def pq_numbers(card: str, table, device="cuda") -> dict:
    """Post-training PQ of one trained full table (Figure 4a's baseline):
    k-means of each of PQ_C blocks on PQ_SAMPLE rows, then every row
    assigned by the assignment kernel, one launch a chunk of 2^18 rows for
    all blocks; each chunk's picks held to ``assign_excess``.  Returns
    {"launches": counts, numbers}."""
    import torch

    from repro_torch import random as jr
    from repro_torch.core import pq
    from repro_torch.kernels import ops

    d1 = table.shape[0]
    ops.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pq.product_quantize(jr.PRNGKey(9), table, PQ_K, PQ_C, niter=PQ_NITER, sample=PQ_SAMPLE)
    torch.cuda.synchronize()
    pq_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.LAUNCHES)
    chunks = -(-d1 // pq.CHUNK)
    check(launches.get("kmeans_assign") == chunks,
          f"PQ assignment launches {launches} != {chunks} chunks")
    t0 = time.perf_counter()
    again = pq.assign_rows(table, res.codebooks)
    torch.cuda.synchronize()
    assign_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(again, res.assignments), "PQ assignment not repeatable")
    blocks = table.reshape(d1, PQ_C, -1)
    excess = 0.0
    for s in range(0, d1, pq.CHUNK):
        for i in range(PQ_C):
            excess = max(excess, assign_excess(res.assignments[i, s: s + pq.CHUNK],
                                               blocks[s: s + pq.CHUNK, i], res.codebooks[i]))
    recon = pq.pq_lookup(res, torch.arange(min(d1, 4096), device=device))
    check(recon.shape == (min(d1, 4096), table.shape[1]) and bool(torch.isfinite(recon).all()),
          "PQ reconstruction not finite")
    print(f"[{card}] pq: feature {PQ_FEATURE}'s trained table ({d1} x {table.shape[1]}), c={PQ_C} "
          f"k={PQ_K} sample={PQ_SAMPLE} niter={PQ_NITER}: mse={res.mse!r}, {pq_ms!r} ms "
          f"(assignment alone {assign_ms!r} ms host), kmeans_assign launches {launches}; "
          f"picks within the assign_excess rule of the plain distances (max excess {excess!r})",
          flush=True)
    return {"launches": launches, "mse": res.mse, "ms": pq_ms, "assign_ms": assign_ms,
            "max_excess": excess}


def least_squares_numbers(card: str, device="cuda") -> dict:
    """Algorithms 1 and 2 at Figure 1b's scale on the card beside the same
    runs on the CPU (the same Gaussian draws: they come from the key on
    the host).  Dense CCE must lie under Theorem 3.1's bound at every
    iteration after the first (where both equal ||Y||^2); sparse CCE,
    which the theorem does not cover, must lower its loss and is printed
    beside it, with the spread of its final loss over LS_KEYS on the card
    (``tests/test_torch_least_squares.py`` holds it to JAX's Algorithm 2 at
    this scale, which lies above the bound too)."""
    import numpy as np
    import torch

    from repro_torch import random as jr
    from repro_torch.core import least_squares as ls

    n, d1, d2 = LS_SHAPE
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(n, d1)).astype(np.float32))
    Y = torch.from_numpy(rng.normal(size=(n, d2)).astype(np.float32))
    out = {}
    for dev in (device, "cpu"):
        x, y = X.to(dev), Y.to(dev)
        t0 = time.perf_counter()
        bound = ls.theorem_bound(x, y, LS_K, LS_ITERS)
        opt, _ = ls.optimal_loss(x, y)
        dense = ls.dense_cce(jr.PRNGKey(1), x, y, LS_K, LS_ITERS)
        sparse = ls.sparse_cce(jr.PRNGKey(1), x, y, LS_K, LS_ITERS)
        losses = [t.cpu().numpy() for t in (bound, dense.losses, sparse.losses)]
        out[dev] = dict(ms=(time.perf_counter() - t0) * 1e3, opt=float(opt), bound=losses[0],
                        dense=losses[1], sparse=losses[2])
    card_, cpu = out[device], out["cpu"]
    x, y = X.to(device), Y.to(device)
    finals = [float(card_["sparse"][-1])] + [
        float(ls.sparse_cce(jr.PRNGKey(key), x, y, LS_K, LS_ITERS).losses[-1]) for key in LS_KEYS]
    spread = (max(finals) - min(finals)) / float(np.median(finals))
    gaps = {}
    for name in ("dense", "sparse"):
        check(bool(np.isfinite(card_[name]).all()), f"least squares: non-finite {name} losses")
        gaps[name] = float(abs(card_[name][-1] - cpu[name][-1]) / cpu[name][-1])
        check(gaps[name] <= LS_RTOL[name], f"least squares: {name} final loss card "
              f"{card_[name][-1]} vs CPU {cpu[name][-1]} (relative {gaps[name]})")
    over = card_["dense"][1:] - card_["bound"][1:]
    check(bool((over <= 0).all()),
          f"dense CCE above Theorem 3.1's bound at iterations {np.nonzero(over > 0)[0] + 1}")
    check(card_["sparse"][-1] < card_["sparse"][0], "sparse CCE did not lower the loss")
    s_over = card_["sparse"] - card_["bound"]
    print(f"[{card}] least squares n={n} d1={d1} d2={d2} k={LS_K} {LS_ITERS} iterations: "
          f"opt {card_['opt']!r}; dense CCE final {float(card_['dense'][-1])!r} under the "
          f"bound {float(card_['bound'][-1])!r} at every iteration (smallest margin "
          f"{float(-over.max())!r}); sparse CCE final {float(card_['sparse'][-1])!r}, above the "
          f"bound at {int((s_over[1:] > 0).sum())} of {LS_ITERS} iterations (the theorem "
          f"bounds dense CCE); the CPU's final losses dense {float(cpu['dense'][-1])!r}, sparse "
          f"{float(cpu['sparse'][-1])!r}, relative gaps card vs CPU dense {gaps['dense']!r} "
          f"(limit {LS_RTOL['dense']}), sparse {gaps['sparse']!r} (limit {LS_RTOL['sparse']}); "
          f"sparse CCE's final loss over keys {(1, *LS_KEYS)} on the card {finals}, spread "
          f"(max - min) / median {spread!r}; {card_['ms']!r} ms on the card, {cpu['ms']!r} ms "
          f"on the CPU", flush=True)
    return dict(card_ms=card_["ms"], cpu_ms=cpu["ms"], dense=float(card_["dense"][-1]),
                sparse=float(card_["sparse"][-1]), bound=float(card_["bound"][-1]),
                gaps=gaps, sparse_spread=spread)


def methods_phase(card: str, cfg, device="cuda"):
    """The paper's comparison methods on DLRM at full Criteo width: for
    each of METHODS, ``replace(cfg, emb_method=m)`` trained from a seed at
    batch TRAIN_BATCH (sgd momentum 0.9, lr TRAIN_LR, clip 1.0): the first
    step's loss and every gradient and updated parameter against the same
    step on CPU copies, then METHOD_STEPS timed steps (host ms, device
    busy, launches, allocated GB).  At the hash and CE shapes the lookup
    kernels against their plain versions and timed, and 4 cold batches
    served through DLRMServeEngine against the forward.  Then PQ of the
    full run's feature-2 table and least squares on the card.  Returns
    (launches on the path, max kernel error, {method: kernel numbers},
    per-method numbers)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data.synthetic import ClickstreamConfig, clickstream_batches
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.optim import sgd
    from repro_torch.serve.dlrm import DLRMServeEngine
    from repro_torch.train import loop
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    stream = clickstream_batches(ClickstreamConfig(vocab_sizes=cfg.vocab_sizes, seed=5),
                                 TRAIN_BATCH)
    raw = [next(stream) for _ in range(METHOD_STEPS)]
    print(f"methods data: {len(raw)} batches of {TRAIN_BATCH} in {time.perf_counter() - t0:.3f} s")

    def on(batch, dev):  # one microbatch: leaves (1, B, ...)
        return {k: torch.from_numpy(batch[k][None]).to(dev) for k in ("dense", "sparse", "label")}

    opt = sgd(momentum=0.9)
    total = collections.Counter()
    max_err, at, numbers, pq_table = 0.0, {}, {}, None
    for m in METHODS:
        t_m = time.perf_counter()
        mcfg = dataclasses.replace(cfg, emb_method=m)
        coll = mcfg.collection
        torch.cuda.empty_cache()
        left = reset_peak()  # earlier phases' and methods' leftovers
        params, buffers = dlrm.init(mcfg, torch.Generator(device=device).manual_seed(1), device)

        def loss_fn(p, b, mb, mcfg=mcfg):
            return dlrm.bce_loss(p, b, mcfg, mb), {}

        step = loop.make_train_step(loss_fn, opt, lambda s: TRAIN_LR, clip_norm=1.0)
        state = loop.init_state(params, opt, buffers)
        batches = [on(b, device) for b in raw]

        # the first step on CPU copies of the state (the python-int hash
        # coefficients as they are), with the plain versions
        def to_cpu(t):
            return t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor) else t

        cpu_state = loop.TrainState(*(tree_map(to_cpu, x)
                                      for x in (state.params, state.opt, state.ebuf)), step=0)
        cpu_mb = on(raw[0], "cpu")
        loss_dev, g_dev = loop.value_and_grad(loss_fn, state.params, state.ebuf,
                                              tree_map(lambda x: x[0], batches[0]))
        loss_cpu, g_cpu = loop.value_and_grad(loss_fn, cpu_state.params, cpu_state.ebuf,
                                              tree_map(lambda x: x[0], cpu_mb))
        check(abs(loss_dev.item() - loss_cpu.item()) <= STEP_RTOL * abs(loss_cpu.item()),
              f"{m}: first-step loss card {loss_dev.item()} vs CPU {loss_cpu.item()}")
        grad_rel = _check_close(_leaf_errors(g_dev, g_cpu), f"{m}: first-step gradients")
        del g_dev, g_cpu

        t_check = time.perf_counter() - t_m
        ops.LAUNCHES.clear()
        losses, step_ms = [], []
        for i, mb in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, mb)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(met["loss"].item())
            if i == 0:
                first_params = tree_map(torch.clone, state.params)
        launches = dict(ops.LAUNCHES)
        total.update(launches)
        want = METHOD_STEPS if m in METHOD_KERNEL_SHAPES else 0
        check(launches.get("cce_lookup_fwd", 0) == want and launches.get("cce_lookup_bwd", 0) == want,
              f"{m}: {METHOD_STEPS} steps launched {launches}, expected {want} + {want}")
        check(all(math.isfinite(x) for x in losses), f"{m}: non-finite loss {losses}")
        cpu_state, cpu_met = step(cpu_state, cpu_mb)
        check(abs(cpu_met["loss"].item() - losses[0]) <= STEP_RTOL * abs(losses[0]),
              f"{m}: first step loss card {losses[0]} vs CPU {cpu_met['loss'].item()}")
        param_rel = _check_close(_leaf_errors(first_params, cpu_state.params),
                                 f"{m}: first-step params")
        del cpu_state, first_params
        peak_gb = (torch.cuda.max_memory_allocated() - left) / 2**30
        held_gb = (torch.cuda.memory_allocated() - left) / 2**30
        host_ms = statistics.median(step_ms[1:])
        busy_ms = device_busy_ms(lambda: step(state, batches[-1]))
        top = top_kernels(lambda: step(state, batches[-1]))
        numbers[m] = dict(host_ms=host_ms, first_ms=step_ms[0], device_busy_ms=busy_ms,
                          idle_share=1 - busy_ms / host_ms, peak_gb=peak_gb, held_gb=held_gb,
                          launches=launches, groups=coll.n_groups,
                          lookups=coll.n_lookup_launches, emb_params=mcfg.n_emb_params(),
                          losses=losses, top_kernels=top)
        print(f"[{card}] methods {m}: {coll.n_groups} groups, {coll.n_lookup_launches} lookups a "
              f"forward, {mcfg.n_emb_params()} embedding params (compression "
              f"{mcfg.compression()!r}); {METHOD_STEPS} steps at batch {TRAIN_BATCH}, losses "
              f"{losses!r}; launches {launches}; first step vs CPU: loss {loss_cpu.item()!r} vs "
              f"{loss_dev.item()!r}, gradients max rel err {grad_rel!r}, params max rel err "
              f"{param_rel!r}; step host {host_ms!r} ms (median of steps 2-{METHOD_STEPS}; "
              f"first {step_ms[0]!r} ms), device busy {busy_ms!r} ms (idle share "
              f"{1 - busy_ms / host_ms!r}); allocated {held_gb!r} GB, peak {peak_gb!r} GB "
              f"(each less the {left / 2**30!r} GB allocated before the init); "
              f"top device time a step: " + "; ".join(f"{k} {v!r} ms" for k, v in top),
              flush=True)
        t_steps = time.perf_counter() - t_m

        if m in METHOD_KERNEL_SHAPES:
            err, at[m] = method_kernel_numbers(card, m, mcfg, state.params, state.ebuf, raw,
                                               device)
            max_err = max(max_err, err)
            engine = DLRMServeEngine(state.params, state.ebuf, mcfg, max_batch=SERVE_BATCH,
                                     cache=False)
            parts = [{k: raw[-1][k][j * SERVE_BATCH:(j + 1) * SERVE_BATCH]
                      for k in ("dense", "sparse")} for j in range(SERVE_BATCHES)]
            ops.LAUNCHES.clear()
            served = [engine.predict(b["dense"], b["sparse"]) for b in parts]
            served_launches = dict(ops.LAUNCHES)
            diffs = []
            with torch.no_grad():
                for b, logits in zip(parts, served):
                    fwd = dlrm.forward(state.params, state.ebuf, mcfg, {
                        "dense": torch.from_numpy(b["dense"]).to(device),
                        "sparse": torch.from_numpy(b["sparse"]).to(device)}).cpu().numpy()
                    diffs.append(float(np.abs(fwd - logits).max()))
            total.update(served_launches)
            check(served_launches.get("cce_lookup_fwd") == SERVE_BATCHES,
                  f"{m}: {SERVE_BATCHES} cold batches launched {served_launches}")
            check(max(diffs) <= 1e-5, f"{m}: served logits differ from forward by {max(diffs)}")
            print(f"[{card}] methods {m} serve: {SERVE_BATCHES} cold batches of {SERVE_BATCH} "
                  f"through DLRMServeEngine, launches {served_launches}, logits vs forward "
                  f"max_abs_diff={max(diffs)!r}", flush=True)
            del engine
        if m == "full":
            pq_table = coll.feature_params(state.params["emb"], PQ_FEATURE)["table"].clone()
        del state, params, buffers, batches
        print(f"[{card}] methods {m}: {time.perf_counter() - t_m:.1f} s (init and the first-step "
              f"check {t_check:.1f} s, then the steps' timing to {t_steps:.1f} s, then kernels, "
              f"serving and clean-up)", flush=True)
    torch.cuda.empty_cache()

    pq_out = pq_numbers(card, pq_table, device)
    total.update(pq_out.pop("launches"))
    del pq_table
    ls_out = least_squares_numbers(card, device)
    return dict(total), max_err, at, dict(numbers, pq=pq_out, least_squares=ls_out)


def flash_flops(B: int, Sq: int, S: int, H: int, D: int, causal: bool) -> int:
    """The two products' operations over the (query, key) pairs the mask
    keeps: 4*D a pair and head."""
    pairs = sum(min(i + 1, S) for i in range(Sq)) if causal else Sq * S
    return 4 * D * H * B * pairs


def flash_bound(B: int, Sq: int, S: int, H: int, KVH: int, D: int, esize: int, causal: bool,
                flops: float):
    """Least time for the attention on an H100: q, k, v read once and the
    output written once, against the two products over the (query, key)
    pairs the mask keeps (4*D flops a pair and head) at ``flops``.
    Returns (ms, "bytes" | "operations")."""
    n_bytes = (2 * B * Sq * H * D + 2 * B * S * KVH * D) * esize
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flash_flops(B, Sq, S, H, D, causal) / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_row_err(got, want) -> float:
    """The largest over (b, s, h) rows of max_d |got - want| / (max_d |want|
    + 1e-3): the error of each query row and head against its own scale."""
    want = want.float()
    diff = (got.float() - want).abs().amax(-1)
    return (diff / (want.abs().amax(-1) + 1e-3)).max().item()


def flash_inputs(B, Sq, S, H, KVH, D, dtype, seed, head_major=False, device="cuda"):
    """Unit-normal q (B, Sq, H, D), k, v (B, S, KVH, D) from a generator of
    ``seed``; with ``head_major`` q is a (B, H, Sq, D) tensor seen as
    (B, Sq, H, D)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    if head_major:
        q = torch.randn((B, H, Sq, D), generator=g, device=device).to(dtype).transpose(1, 2)
    else:
        q = torch.randn((B, Sq, H, D), generator=g, device=device).to(dtype)
    k = torch.randn((B, S, KVH, D), generator=g, device=device).to(dtype)
    v = torch.randn((B, S, KVH, D), generator=g, device=device).to(dtype)
    return q, k, v


def flash_timed(card: str, S: int, H: int, KVH: int, D: int, device="cuda") -> dict:
    """The kernel at B=1, causal, bf16 (S, H, KVH, D), both CTA heights,
    beside its plain version, SDPA (which must compute the same function)
    and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    q, k, v = flash_inputs(1, S, S, H, KVH, D, torch.bfloat16, seed=10_000 + S, device=device)
    got = fa.flash_attention(q, k, v)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    # each side rounds to bf16 on its own: two roundings apart at most
    lib_err = (library().transpose(1, 2).float() - got.float()).abs().max().item()
    check(lib_err <= 2 * FLASH_TOL["bfloat16"],
          f"SDPA yardstick computes another function at S={S} H={H} ({lib_err})")
    ms = time_ms(lambda: fa.flash_attention(q, k, v), iters=50)
    dev = device_ms(lambda: fa.flash_attention(q, k, v), "flash_fwd_wgmma_kernel")
    # every CTA height the kernel takes at D, whichever the wrapper picks
    by_rows = {r: device_ms(lambda r=r: fa._launch(q, k, v, True, r),
                            "flash_fwd_wgmma_kernel") for r in cta_rows(D)}
    picked = fa.block_rows(1, S, H, torch.cuda.get_device_properties(0).multi_processor_count, D)
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v), iters=10, reps=3)
    plain_dev = device_busy_ms(lambda: ref.flash_attention_ref(q, k, v), iters=5)
    lib = time_ms(library, iters=50)
    lib_dev = device_busy_ms(library, iters=20)
    bound, bound_by = flash_bound(1, S, S, H, KVH, D, 2, True, H100_BF16_FLOPS)
    tflops = flash_flops(1, S, S, H, D, True) / (dev * 1e-3) / 1e12
    print(f"[{card}] flash_attention bf16 B=1 H={H} KVH={KVH} D={D} S={S} causal: "
          f"ms={ms!r} device_ms={dev!r} (rows {picked}; "
          + ", ".join(f"{r} rows {t!r}" for r, t in by_rows.items()) + f") {tflops!r} TFLOP/s, "
          f"{bound / dev!r} of bound_ms={bound!r} ({bound_by}) plain_ms={plain!r} "
          f"plain_device_ms={plain_dev!r} library_ms(sdpa)={lib!r} "
          f"library_device_ms={lib_dev!r} sdpa_vs_kernel_max_abs_diff={lib_err!r}",
          flush=True)
    return dict(ms=ms, device_ms=dev, device_ms_by_rows=by_rows, rows=picked, tflops=tflops,
                bound_share=bound / dev, plain_ms=plain, plain_device_ms=plain_dev,
                bound_ms=bound, bound_by=bound_by, library_ms=lib, library_device_ms=lib_dev)


def cta_rows(D: int) -> tuple:
    """The query rows a bf16 CTA can take at head_dim D."""
    return (64,) if D == 256 else (64, 128)


def flash_phase(card: str, device="cuda"):
    """The flash-attention kernel against its plain version on unit-normal
    inputs: within FLASH_TOL, bfloat16 also within FLASH_ROW_TOL of each
    row's scale against the plain version in float32, repeatable bit for
    bit, the causal first row equal to v's first row; a strided
    (B, H, S, D)-layout view read in place.  Times the kernel, the plain
    version and SDPA at FLASH_TIMED with qwen2-1.5b's heads, at
    FLASH_HYMBA_TIMED with hymba-1.5b's, at FLASH_TIMED with
    paligemma-3b's (D 256), with phi3.5-moe's (FLASH_MOE) and with
    musicgen-medium's (FLASH_MUSICGEN).  Returns ({dtype: max error}, {S:
    numbers}, {S: numbers at hymba's heads}, {S: numbers at paligemma's},
    {dtype: max error at paligemma's}, {S: numbers at phi3.5-moe's}, {S:
    numbers at musicgen-medium's})."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    max_err = {"float32": 0.0, "bfloat16": 0.0}
    paligemma_err = dict(max_err)  # the FLASH_PALIGEMMA cases alone
    max_row_err = 0.0
    n_cases = 0
    heads_dims = ([(H, KVH, D) for H, KVH in FLASH_HEADS for D in FLASH_DIMS]
                  + [FLASH_PALIGEMMA, FLASH_MUSICGEN])
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        tol = FLASH_TOL[dn]
        for H, KVH, D in heads_dims:
            shapes = [(n, n, True) for n in FLASH_LENGTHS]
            shapes += [(sq, sk, False) for sq, sk in FLASH_NONCAUSAL]
            for Sq, S, causal in shapes:
                B = 1 if S >= 1000 else 2
                q, k, v = flash_inputs(B, Sq, S, H, KVH, D, dtype, seed=n_cases,
                                       head_major=(Sq == FLASH_STRIDED and causal),
                                       device=device)
                want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                                 causal=causal)
                want = want32.to(dtype)
                # bf16: every CTA height the kernel takes at D, whichever the
                # wrapper picks
                for rows in (None,) if dtype == torch.float32 else cta_rows(D):
                    if rows:
                        got = fa._launch(q, k, v, causal, rows)
                        again = fa._launch(q, k, v, causal, rows)
                    else:
                        got = fa.flash_attention(q, k, v, causal=causal)
                        again = fa.flash_attention(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    what = (f"{dn} H={H} KVH={KVH} D={D} Sq={Sq} S={S} causal={causal}"
                            f"{f' rows={rows}' if rows else ''}")
                    check(err <= tol, f"flash kernel vs plain {err} > {tol} at {what}")
                    if rows:
                        row_err = flash_row_err(got, want32)
                        check(row_err <= FLASH_ROW_TOL, f"flash kernel vs plain {row_err} "
                              f"> {FLASH_ROW_TOL} of a row's scale at {what}")
                        max_row_err = max(max_row_err, row_err)
                    check(torch.equal(got, again), f"flash kernel not repeatable at {what}")
                    if causal:
                        first = v[:, 0].repeat_interleave(H // KVH, dim=1)
                        row_err = (got[:, 0].float() - first.float()).abs().max().item()
                        check(row_err <= tol, f"flash first row != v[0] ({row_err}) at {what}")
                    max_err[dn] = max(max_err[dn], err)
                    if (H, KVH, D) == FLASH_PALIGEMMA:
                        paligemma_err[dn] = max(paligemma_err[dn], err)
                n_cases += 1
    print(f"[{card}] flash_attention: {n_cases} cases (heads {FLASH_HEADS}, D {FLASH_DIMS}, "
          f"and (H, KVH, D) {FLASH_PALIGEMMA} and {FLASH_MUSICGEN}; causal S {FLASH_LENGTHS}, "
          f"non-causal (Sq, S) "
          f"{FLASH_NONCAUSAL}) in float32 and bfloat16 (at 64 and 128 query rows a CTA, 64 "
          f"at D 256): max_abs_err {max_err!r} (at D 256 {paligemma_err!r}), bfloat16 "
          f"max_row_scaled_err {max_row_err!r} (<= {FLASH_ROW_TOL!r}), repeatable, "
          f"causal first row == v[0]",
          flush=True)
    # every other head_dim is refused, by the wrapper and by the C entry
    # behind it, and so are 128-row CTAs at D 256
    def refused(fn) -> bool:
        try:
            fn()
        except (ValueError, RuntimeError):
            return True
        return False

    at96 = flash_inputs(1, 8, 8, 8, 1, 96, torch.bfloat16, seed=0, device=device)
    at256 = flash_inputs(1, 8, 8, *FLASH_PALIGEMMA, torch.bfloat16, seed=0, device=device)
    check(refused(lambda: fa.flash_attention(*at96))
          and refused(lambda: fa._launch(*at96, True, 64))
          and refused(lambda: fa._launch(*at256, True, 128)),
          "the flash kernel took D 96, or 128-row CTAs at D 256")
    at = {S: flash_timed(card, S, *FLASH_HEADS[0], FLASH_DIMS[-1], device=device)
          for S in FLASH_TIMED}
    at_hymba = {S: flash_timed(card, S, *FLASH_HEADS[-1], FLASH_DIMS[0], device=device)
                for S in FLASH_HYMBA_TIMED}
    at_paligemma = {S: flash_timed(card, S, *FLASH_PALIGEMMA, device=device)
                    for S in FLASH_TIMED}
    at_moe = {S: flash_timed(card, S, *FLASH_MOE, device=device) for S in FLASH_TIMED}
    at_musicgen = {S: flash_timed(card, S, *FLASH_MUSICGEN, device=device) for S in FLASH_TIMED}
    return max_err, at, at_hymba, at_paligemma, paligemma_err, at_moe, at_musicgen


def _lm_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] + 1, LM_REQUESTS)
    return [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in lens]


def lm_fwd_numbers(card: str, label: str, idx, tables) -> dict:
    """The lookup kernel at the LM's token-table shape (c=emb_c, T=2, the
    table's k and dsub) on rows ``idx``, against its plain version (bit for
    bit in float32), with its times.  Device times of kernel and
    ``embedding_bag`` are taken with the L2 flushed before each call, as
    serving finds the table (the layers' weights stream through the L2
    between two lookups), and warm beside."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref

    c, n, T = idx.shape
    got = cl.cce_lookup_fwd(idx, tables)
    want = ref.cce_lookup_ref(idx, tables)
    err = (got - want).abs().max().item()
    check(torch.equal(got, want), f"LM-shape lookup kernel != plain at B={n} ({label})")
    bag, weight, offsets = embedding_bag_args(idx, tables)
    check(torch.allclose(F.embedding_bag(bag, weight, offsets, mode="sum").reshape(n, -1),
                         got, rtol=1e-6, atol=1e-6),
          f"embedding_bag yardstick computes another function at B={n} ({label})")
    ms = time_ms(lambda: cl.cce_lookup_fwd(idx, tables))
    kernel = lookup_kernel("cce_lookup_fwd", tables)
    dev = device_ms(lambda: cl.cce_lookup_fwd(idx, tables), kernel, cold=True)
    dev_warm = device_ms(lambda: cl.cce_lookup_fwd(idx, tables), kernel)
    plain = time_ms(lambda: ref.cce_lookup_ref(idx, tables))
    plain_dev = device_busy_ms(lambda: ref.cce_lookup_ref(idx, tables), iters=20)

    def library():
        return F.embedding_bag(bag, weight, offsets, mode="sum")

    lib = time_ms(library)
    lib_dev = device_busy_ms(library, iters=20, cold=True)
    lib_dev_warm = device_busy_ms(library, iters=20)
    bound, bound_by = lookup_bound(idx, tables)
    print(f"[{card}] cce_lookup_fwd LM shape c={c} T={T} k={tables.shape[2]} "
          f"dsub={tables.shape[3]} f32 {cl_path(tables)} B={n} ({label}): equal to plain, "
          f"ms={ms!r} "
          f"device_ms(L2 flushed)={dev!r} device_ms(warm)={dev_warm!r} plain_ms={plain!r} "
          f"plain_device_ms={plain_dev!r} "
          f"bound_ms={bound!r} ({bound_by}) library_ms(embedding_bag)={lib!r} "
          f"library_device_ms(L2 flushed)={lib_dev!r} library_device_ms(warm)="
          f"{lib_dev_warm!r}", flush=True)
    return dict(B=n, layout=cl_path(tables), max_abs_err=err, ms=ms, device_ms=dev,
                device_ms_warm=dev_warm, plain_ms=plain,
                plain_device_ms=plain_dev, bound_ms=bound, bound_by=bound_by,
                library_ms=lib, library_device_ms=lib_dev, library_device_ms_warm=lib_dev_warm)


def lm_lookup_numbers(card: str, cfg, params, buffers, prompts, prefill_rows: int,
                      bf16: bool = False) -> dict:
    """``lm_fwd_numbers`` at a prefill's ``prefill_rows`` tokens and an
    LM_MAX_BATCH-slot decode tick; with ``bf16`` also the kernel on the
    table cast to bfloat16 at both, equal to its plain version bit for
    bit (both sum in float32 and round once)."""
    import numpy as np
    import torch

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ref
    from repro_torch.models import lm

    table = lm.make_emb(cfg)
    tables = params["emb"]["tables"].contiguous()
    toks = np.concatenate(prompts)
    out = {}
    for name, n in (("prefill", prefill_rows), ("decode", LM_MAX_BATCH)):
        ids = torch.from_numpy(np.resize(toks, n).astype(np.int64)).to(tables.device)
        idx = table._rows(buffers["emb"], ids).reshape(table.c, -1, 2)
        out[name] = lm_fwd_numbers(card, f"{cfg.name} {name}", idx, tables)
        if bf16:
            half = tables.to(torch.bfloat16)
            check(cl_path(half) == out[name]["layout"], f"the bfloat16 table takes "
                  f"{cl_path(half)}, not {out[name]['layout']}")
            got, want = cl.cce_lookup_fwd(idx, half), ref.cce_lookup_ref(idx, half)
            check(torch.equal(got, want), f"bfloat16 lookup kernel != plain at B={n} "
                  f"({cfg.name} {name})")
            out[name]["bfloat16_equal"] = True
            print(f"[{card}] cce_lookup_fwd {cfg.name} {name} B={n} bfloat16 "
                  f"{cl_path(half)}: equal to plain bit for bit", flush=True)
    return out


def _max_rel(got, want) -> float:
    """max |got - want| over the largest |want|, both as float32 on the CPU."""
    want = want.float()
    return ((got.float().cpu() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def cut_layers(cfg, dn: str = "float32") -> int:
    """The depth of ``lm_cut``'s cut (in dtype ``dn``): MOE_CHECK_LAYERS
    for the moe family, else LM_CHECK_LAYERS."""
    return MOE_CHECK_LAYERS[dn] if cfg.family == "moe" else LM_CHECK_LAYERS


def lm_cut(cfg, params):
    """(config, params) of a ``cut_layers`` cut of the model (views of its
    params).  The xlstm family's stacks are (n_super, n_m, ...): its cut
    is one superblock of the model's first mLSTM block and first sLSTM
    block (n_layers 2, slstm_every 2), so both kinds run at full width."""
    from repro_torch.tree import tree_map

    blocks = params["blocks"]
    if cfg.family == "xlstm":
        first = {"mlstm": tree_map(lambda t: t[:1, :1], blocks["mlstm"]),
                 "slstm": tree_map(lambda t: t[:1], blocks["slstm"]),
                 "norms": {"m": tree_map(lambda t: t[:1, :1], blocks["norms"]["m"]),
                           "s": tree_map(lambda t: t[:1], blocks["norms"]["s"])}}
        return lm_cut_config(cfg), dict(params, blocks=first)
    return (lm_cut_config(cfg),
            dict(params, blocks=tree_map(lambda t: t[:cut_layers(cfg)], blocks)))


def lm_cut_config(cfg):
    """The configuration of ``lm_cut``'s cut."""
    import dataclasses

    if cfg.family == "xlstm":
        return dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS, slstm_every=LM_CHECK_LAYERS)
    return dataclasses.replace(cfg, n_layers=cut_layers(cfg))


def moe_traced(fn):
    """(fn(), [(kind, gate_idx, keep)] of every moe route it ran, on the
    CPU): ``models.moe.TRACE`` on for the call."""
    from repro_torch.models import moe as moe_lib

    moe_lib.TRACE = []
    try:
        out = fn()
    finally:
        trace, moe_lib.TRACE = moe_lib.TRACE, None
    return out, [(kind, g.cpu(), None if keep is None else keep.cpu())
                 for kind, g, keep in trace]


class MoeReach:
    """What routing flips between the card and the CPU can have reached in
    an L-layer moe cut run on one sequence, call by call.  A position
    whose decision (``gate_idx`` or ``keep``) differs at layer l leaves
    layer l with another output, and every later position's input to
    layer l + 1 on reads it through attention (a flip that costs another
    token its slot is that token's own flip).  ``reached[l]`` marks, by
    position, the inputs to layer l (``reached[L]``: the final hidden
    state) that a flip may have changed: k and v of layer l are compared
    only at positions it leaves unmarked, the logits only where the last
    position is unmarked."""

    def __init__(self, n_layers: int):
        import torch

        self.n_layers = n_layers
        self.reached = [torch.zeros(0, dtype=torch.bool) for _ in range(n_layers + 1)]
        self.flips = 0
        self.decisions = 0

    def step(self, on_card, on_cpu) -> None:
        """One call's traces (``moe_traced``: a route a layer, each over
        the call's n new positions of one sequence)."""
        import torch

        check(len(on_card) == len(on_cpu) == self.n_layers,
              f"{len(on_card)} and {len(on_cpu)} moe routes traced, not {self.n_layers}")
        n = on_card[0][1].shape[1]
        new_in = torch.zeros(n, dtype=torch.bool)
        for layer, ((_, g_card, k_card), (_, g_cpu, k_cpu)) in enumerate(zip(on_card, on_cpu)):
            flip = (g_card != g_cpu).any(-1)[0]
            if k_card is not None:
                flip |= (k_card != k_cpu).any(-1)[0]
            self.flips += int(flip.sum())
            self.decisions += n
            self.reached[layer] = torch.cat([self.reached[layer], new_in])
            seen = torch.cummax(self.reached[layer].to(torch.int32), 0).values.bool()
            new_in = seen[-n:] | flip
        self.reached[-1] = torch.cat([self.reached[-1], new_in])


def lm_cut_check(card: str, label: str, cfg, params, buffers, prompt, n_decode: int,
                 device="cuda") -> dict:
    """A ``cut_layers`` cut of the served model (``lm_cut``) on the card
    against CPU copies, in float32 and bfloat16 (the moe family's
    bfloat16: its first layer alone): a prefill of ``prompt``, then
    ``n_decode`` greedy decode steps (the CPU's picks fed to both), the
    logits and every cache leaf after each call within LM_LOGIT_RTOL of the
    CPU's largest magnitude; for the vlm family also ``forward`` with
    ``cfg.n_patches`` patch embeddings (unit normal, from LM_SEED) before
    the prompt, which serving never runs.  For the moe family every
    routing decision of every call is traced on both sides: in float32 all
    must agree; in bfloat16 those that differ are counted (a share above
    MOE_FLIP_SHARE fails) and only what none of them reached is compared
    (``MoeReach``: logits, and k and v row by row).  Returns {dtype: worst
    relative error} and, for the moe family, {dtype: (flips, decisions,
    comparisons skipped)} beside it."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    cut_cfg, cut_p = lm_cut(cfg, params)
    cpu_p = tree_map(lambda t: t.detach().to("cpu", copy=True), cut_p)
    cpu_b = tree_map(lambda t: t.detach().to("cpu", copy=True), buffers)
    S = len(prompt)
    toks = torch.from_numpy(np.asarray(prompt, np.int64)[None])
    moe = cfg.family == "moe"
    worst, routes = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        n_cut = cut_layers(cfg, dn)
        cut = dataclasses.replace(cut_cfg, dtype=dtype)
        on_p, off_p = cut_p, cpu_p
        if cut.n_layers > n_cut:  # the moe family's bfloat16: its first layer(s)
            cut = dataclasses.replace(cut, n_layers=n_cut)
            on_p, off_p = (dict(p, blocks=tree_map(lambda t: t[:n_cut], p["blocks"]))
                           for p in (cut_p, cpu_p))
        card_c, cpu_c = (lm.init_cache(cut, 1, S + n_decode, device=d) for d in (device, "cpu"))
        errs = {}
        reach = MoeReach(n_cut) if moe else None
        skipped = []

        def compare(what, on_card, on_cpu):
            check(bool(torch.isfinite(on_card).all()), f"{label} cut {what} ({dn}) not finite")
            err = _max_rel(on_card, on_cpu)
            check(err <= LM_LOGIT_RTOL[dn], f"{n_cut}-layer {label} cut {what} card "
                  f"vs CPU ({dn}): {err} of the largest > {LM_LOGIT_RTOL[dn]}")
            errs[what] = max(errs.get(what, 0.0), err)

        def compare_call(what, card_call, cpu_call):
            """The logits and every cache leaf after one call on each side;
            for the moe family only what no routing flip reached."""
            (on_card, _), card_r = card_call
            (on_cpu, _), cpu_r = cpu_call
            if reach is None:
                compare(f"{what} logits", on_card, on_cpu)
                for key in cpu_c:
                    compare(f"{what} {key}", card_c[key], cpu_c[key])
                return on_cpu
            reach.step(card_r, cpu_r)
            if dtype == torch.float32:
                check(reach.flips == 0, f"{label} cut {what} (float32): {reach.flips} routing "
                      f"decisions differ between the card and the CPU")
            if reach.reached[-1][-1]:
                skipped.append(f"{what} logits")
            else:
                compare(f"{what} logits", on_card, on_cpu)
            for key in cpu_c:  # k and v, (L, 1, S, KVH, D)
                for layer in range(n_cut):
                    rows = (~reach.reached[layer]).nonzero()[:, 0]
                    if len(rows) < len(reach.reached[layer]):
                        skipped.append(f"{what} {key} layer {layer}: "
                                       f"{len(reach.reached[layer]) - len(rows)} rows")
                    if len(rows):
                        compare(f"{what} {key}", card_c[key][layer, 0, rows.to(device)],
                                cpu_c[key][layer, 0, rows])
            return on_cpu

        with torch.inference_mode():
            on_cpu = compare_call(
                "prefill",
                moe_traced(lambda: lm.prefill(on_p, buffers, cut, toks.to(device), card_c)),
                moe_traced(lambda: lm.prefill(off_p, cpu_b, cut, toks, cpu_c)))
            for t in range(n_decode):
                nxt = on_cpu.float().argmax(-1)
                pos = torch.tensor([S + t])
                on_cpu = compare_call(
                    "decode",
                    moe_traced(lambda: lm.decode_step(on_p, buffers, cut, nxt.to(device),
                                                      pos.to(device), card_c)),
                    moe_traced(lambda: lm.decode_step(off_p, cpu_b, cut, nxt, pos, cpu_c)))
            if cfg.family == "vlm":
                pe = torch.randn((1, cfg.n_patches, cfg.d_model),
                                 generator=torch.Generator().manual_seed(LM_SEED))
                on_card, _ = lm.forward(on_p, buffers, cut, {"tokens": toks.to(device),
                                                              "patch_emb": pe.to(device)})
                on_cpu, _ = lm.forward(off_p, cpu_b, cut, {"tokens": toks, "patch_emb": pe})
                check(on_cpu.shape == (1, S, cfg.vocab), f"patch forward logits {on_cpu.shape}")
                compare(f"forward logits after {cfg.n_patches} patches", on_card, on_cpu)
        worst[dn] = max(errs.values())
        flips = ""
        if moe:
            share = reach.flips / reach.decisions
            routes[dn] = (reach.flips, reach.decisions, len(skipped))
            flips = (f"; routing: {reach.flips} of {reach.decisions} (token, layer) decisions "
                     f"differ ({share!r}; limit {MOE_FLIP_SHARE} in bfloat16, 0 in float32), "
                     f"not compared where a flip reached: {skipped or 'nothing'}")
            check(share <= MOE_FLIP_SHARE, f"{label} cut ({dn}): {share} of the routing "
                  f"decisions differ between the card and the CPU > {MOE_FLIP_SHARE}")
        print(f"[{card}] {label} {n_cut}-layer cut, a {S}-token prefill"
              f"{f' and {n_decode} decode steps' if n_decode else ''}, {dn}: card vs CPU, "
              f"each relative to the CPU's largest magnitude (tolerance {LM_LOGIT_RTOL[dn]}): "
              + ", ".join(f"{k} {v!r}" for k, v in errs.items()) + flips, flush=True)
    return (worst, routes) if moe else worst


def lm_serve_phase(card: str, cfg, device="cuda", *, label="lm", check_prompt=LM_CHECK_PROMPT,
                   check_decode=0, idle_prefills=(LM_MAX_SEQ,)):
    """Full-width LM serving through ``ServeEngine``: LM_REQUESTS prompts
    over LM_MAX_BATCH slots, greedy, LM_MAX_TOKENS tokens each, with the
    launch counts reset just before the run and read just after (flash
    once a layer for each prefill that takes it: all but those past a
    sliding window, and none for the xlstm family, which has no
    attention); then a request served alone against itself in the
    batch, the host time, device busy and idle share of one decode tick and
    of a prefill of each of ``idle_prefills`` tokens (for the hybrid
    family also the SSM scan's share, for the xlstm family the sLSTM
    blocks' share of its busy and host time), the lookup kernel at the model's
    table, and a LM_CHECK_LAYERS cut on the card against CPU copies
    (``lm_cut_check``: a ``check_prompt``-token prefill, then
    ``check_decode`` decode steps).  Returns (launches, lookup numbers,
    serve numbers)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    left = torch.cuda.memory_allocated()  # what earlier phases left allocated
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params, buffers = lm.init(cfg, gen, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    on_card = (torch.cuda.memory_allocated() - left) / 2**30 if device == "cuda" else 0.0
    extra = (f" ssm inner {cfg.ssm_inner} state {cfg.ssm_state} conv {cfg.ssm_conv}"
             if cfg.family == "hybrid" else "")
    if cfg.family == "vlm":
        extra = (f" act={cfg.act} tied={cfg.tie_embeddings} emb_scale={cfg.emb_scale} "
                 f"patches {cfg.n_patches}")
    counted = "without biases, branch norms and patch_proj"
    if cfg.family == "xlstm":
        n_super, n_m = lm._xlstm_shape(cfg)
        extra = (f" {n_super} superblocks of {n_m} mLSTM (head dim "
                 f"{2 * cfg.d_model // cfg.n_heads}, chunk {xlstm_lib.MLSTM_CHUNK}) and 1 sLSTM (ffn "
                 f"{xlstm_lib.slstm_ffn_dim(cfg)})")
        counted = "every block as an mLSTM block, its gates as 2 di"
    if cfg.family == "moe":
        extra = (f" {cfg.n_experts} experts top-{cfg.top_k} capacity {cfg.capacity_factor} "
                 f"group {cfg.moe_group} route {cfg.moe_impl}")
        counted = (f"without biases: {cfg.n_params()}; active a token {cfg.n_active_params()}, "
                   f"which counts a full vocab x d token table and head under CCE")
    print(f"[{card}] {label} init: {cfg.name} {cfg.n_layers}L d={cfg.d_model} {cfg.n_heads}H/"
          f"{cfg.n_kv_heads}KV hd={cfg.head_dim} ff={cfg.d_ff} vocab={cfg.vocab} "
          f"window={cfg.sliding_window}{extra} emb={cfg.emb_method}: {n_params} params "
          f"(analytic, as the JAX package counts them, "
          f"{counted if cfg.family == 'moe' else f'{counted}: {cfg.n_params()}'}), "
          f"{on_card:.2f} GiB on the card, {time.perf_counter() - t0:.3f} s", flush=True)
    prompts = _lm_prompts(cfg)

    def engine():
        return ServeEngine(cfg, params, buffers, max_batch=LM_MAX_BATCH, max_seq=LM_MAX_SEQ)

    warm = engine()  # first-call set-up (cuBLAS handles, the kernels' libraries) stays out
    warm.submit(Request(uid=-1, prompt=prompts[0][:LM_PROMPTS[0]], max_tokens=2))
    warm.run()
    del warm

    eng = engine()
    prefill_ms, decode_ms = collections.defaultdict(list), []
    prefill_logits = []  # in admission order, which is the order of submission
    orig_prefill, orig_decode = eng._prefill_one, eng._decode
    moe = cfg.family == "moe"
    solo_uid = max(range(len(prompts)), key=lambda i: len(prompts[i]))  # served alone below
    solo_slots = []  # its slot at each decode tick of the batch (None when not in one)

    def timed_prefill(slot, toks, last_idx):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_prefill(slot, toks, last_idx)
        torch.cuda.synchronize()
        prefill_ms[toks.shape[1]].append((time.perf_counter() - t) * 1e3)
        prefill_logits.append(out)
        return out

    def timed_decode():
        solo_slots.append(next((i for i, r in enumerate(eng.slots)
                                if r is not None and r.uid == solo_uid), None))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_decode()
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng._prefill_one, eng._decode = timed_prefill, timed_decode
    reqs = [Request(uid=i, prompt=p, max_tokens=LM_MAX_TOKENS) for i, p in enumerate(prompts)]
    n_flash = 0 if cfg.family == "xlstm" else sum(
        1 for p in prompts if not cfg.sliding_window or len(p) <= cfg.sliding_window)
    reset_peak()
    moe_lib.TRACE = [] if moe else None  # every routing decision, kept on the card
    ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    batch_routes, moe_lib.TRACE = moe_lib.TRACE, None
    raw_peak = torch.cuda.max_memory_allocated()
    peak = (raw_peak - left) / 1e9
    n_dec = len(decode_ms)
    check(len(done) == LM_REQUESTS and eng.prefills == LM_REQUESTS,
          f"served {len(done)} requests with {eng.prefills} prefills")
    check(launches.get("flash_attention", 0) == cfg.n_layers * n_flash,
          f"flash_attention launches {launches} != {cfg.n_layers} x {n_flash} prefills")
    check(launches.get("cce_lookup_fwd") == eng.prefills + n_dec,
          f"cce_lookup_fwd launches {launches} != {eng.prefills} prefills + {n_dec} decodes")
    check(all(len(r.generated) == LM_MAX_TOKENS and all(0 <= t < cfg.vocab for t in r.generated)
              for r in done), "a request came back with the wrong number or range of tokens")
    n_tok = sum(len(r.generated) for r in done)
    lat = np.array([r.latency_s for r in done]) * 1e3
    hist = eng.flush_stats()
    by_len = {b: statistics.median(v) for b, v in sorted(prefill_ms.items())}
    counts = {b: len(v) for b, v in sorted(prefill_ms.items())}
    print(f"[{card}] {label} serve: {LM_REQUESTS} requests (prompts "
          f"{sorted(len(p) for p in prompts)}) over {LM_MAX_BATCH} slots, max_seq {LM_MAX_SEQ}, "
          f"{n_tok} tokens in {wall!r} s ({n_tok / wall!r} tokens/s), {eng.prefills} prefills "
          f"({n_flash} through flash), {n_dec} decode ticks; launches {launches}; peak "
          f"{peak!r} GB allocated ({raw_peak / 1e9!r} GB less the {left / 1e9!r} GB earlier "
          f"phases left)", flush=True)
    print(f"[{card}] {label} serve prefill host ms by prefill length (median, count): "
          + ", ".join(f"{b}: {by_len[b]!r} ({counts[b]})" for b in by_len)
          + f"; decode tick host ms median {statistics.median(decode_ms)!r} "
          f"(min {min(decode_ms)!r}, max {max(decode_ms)!r})", flush=True)
    print(f"[{card}] {label} serve request latency (admit to retire, host clock): histogram "
          f"p50={hist['p50']!r} s p99={hist['p99']!r} s (upper bucket edges); exact "
          f"p50={float(np.percentile(lat, 50))!r} ms p99={float(np.percentile(lat, 99))!r} ms",
          flush=True)
    numbers = dict(tokens_per_s=n_tok / wall, p50_ms=float(np.percentile(lat, 50)),
                   p99_ms=float(np.percentile(lat, 99)), peak_gb=peak,
                   decode_tick_ms=statistics.median(decode_ms), prefill_ms=by_len)

    # a request served alone gives the prefill logits and the tokens it gave
    # in the batch (the logits too: with random tied weights greedy decoding
    # can echo the prompt's last token whatever the layers compute)
    solo_req = next(r for r in done if r.uid == solo_uid)
    solo = engine()
    solo_logits = []
    solo_prefill = solo._prefill_one

    def kept_prefill(*a):
        solo_logits.append(solo_prefill(*a))
        return solo_logits[-1]

    solo._prefill_one = kept_prefill
    solo.submit(Request(uid=0, prompt=solo_req.prompt, max_tokens=LM_MAX_TOKENS))
    moe_lib.TRACE = [] if moe else None
    alone = solo.run()[0].generated
    solo_routes, moe_lib.TRACE = moe_lib.TRACE, None
    same = len(alone)  # tokens held equal: all but where the decode routing differs
    routed = ""
    if moe:
        # a tick's router product can round otherwise with other slots' rows
        # beside it: hold the tokens up to the first decode step whose routing
        # differs (token j comes out of the request's j-th decode tick)
        in_batch = moe_decode_routes(batch_routes, solo_slots, cfg.n_layers)
        by_itself = moe_decode_routes(solo_routes, None, cfg.n_layers)
        differ = [j for j, (a, b) in enumerate(zip(in_batch, by_itself), 1)
                  if not torch.equal(a, b)]
        check(len(in_batch) == len(by_itself) == LM_MAX_TOKENS - 1,
              f"{len(in_batch)} and {len(by_itself)} decode steps traced for request "
              f"{solo_uid}, not {LM_MAX_TOKENS - 1}")
        same = differ[0] if differ else len(alone)
        numbers["solo_decode_routing_differs"] = len(differ)
        routed = (f"; its {len(in_batch)} decode steps' routing ({cfg.n_layers} layers) "
                  f"differs from the batch's at {len(differ)} (steps {differ}), tokens held "
                  f"up to the first")
    del batch_routes, solo_routes
    check(alone[:same] == solo_req.generated[:same],
          f"request {solo_req.uid} alone {alone} != in the batch {solo_req.generated}"
          f" over the first {same} tokens")
    dn = str(cfg.dtype).split(".")[-1]
    solo_err = _max_rel(solo_logits[0], prefill_logits[solo_req.uid].cpu())
    check(solo_err <= LM_LOGIT_RTOL[dn], f"request {solo_req.uid}'s prefill logits alone vs in "
          f"the batch: {solo_err} of the largest > {LM_LOGIT_RTOL[dn]}")
    del solo, prefill_logits
    numbers["solo_logits_max_rel_err"] = solo_err
    rest = (f" (then {alone[same:]} against {solo_req.generated[same:]})"
            if same < len(alone) else "")
    print(f"[{card}] {label} serve: request {solo_req.uid} ({len(solo_req.prompt)} prompt "
          f"tokens) alone gives its batch tokens {alone[:same]}{rest}"
          f" and its prefill logits within {solo_err!r} of the largest (tolerance "
          f"{LM_LOGIT_RTOL[dn]}){routed}", flush=True)

    # host, device busy and idle share of one decode tick and of prefills
    with torch.inference_mode():
        flat = np.concatenate(prompts)
        cases = [("decode tick", orig_decode, None)]
        for n in idle_prefills:
            toks = np.resize(flat, (1, n)).astype(np.int64)
            cases.append((f"prefill {n}", lambda t=toks: orig_prefill(0, t, t.shape[1] - 1),
                          toks))
        inner_slstm = xlstm_lib.slstm_seq
        for name, fn, toks in cases:
            fn()
            host, in_slstm = [], []  # a run's host ms, and its host ms inside slstm_seq

            def timed_slstm(*a, **kw):
                t = time.perf_counter()
                out = inner_slstm(*a, **kw)
                in_slstm[-1] += (time.perf_counter() - t) * 1e3
                return out

            xlstm_lib.slstm_seq = timed_slstm  # lm calls it through the module
            try:
                for _ in range(3):
                    in_slstm.append(0.0)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    host.append((time.perf_counter() - t) * 1e3)
            finally:
                xlstm_lib.slstm_seq = inner_slstm
            # an xlstm prefill launches ~10^5 kernels (the sLSTM loops): one call's raw trace
            long = toks is not None and cfg.family == "xlstm"
            busy = device_busy_long_ms(fn) if long else device_busy_ms(fn)
            h = statistics.median(host)
            numbers[name] = dict(host_ms=h, busy_ms=busy, idle_share=1 - busy / h)
            ssm = ""
            if long:
                # the sLSTM blocks' host time inside the timed prefills (the host
                # enqueues while the card idles); their busy time from superblock 0's
                # block alone on its normed input (here the embedding: the cost does
                # not depend on the values), times the superblocks
                n_s = lm._xlstm_shape(cfg)[0]
                s_host = statistics.median(in_slstm)
                s_share = statistics.median(a / b for a, b in zip(in_slstm, host))
                sp = lm.layer_params(params["blocks"]["slstm"], 0)
                x = lm.embed(params, buffers, cfg, torch.from_numpy(toks).to(device))
                hin = L.apply_norm(lm.layer_params(params["blocks"]["norms"]["s"], 0), x)
                xlstm_lib.slstm_seq(sp, cfg, hin)
                s_busy = n_s * device_busy_long_ms(lambda: xlstm_lib.slstm_seq(sp, cfg, hin))
                numbers[name].update(slstm_host_ms=s_host, slstm_busy_ms=s_busy,
                                     slstm_host_share=s_share, slstm_busy_share=s_busy / busy)
                ssm = (f"; the {n_s} sLSTM blocks host {s_host!r} ms inside it ({s_share!r} of "
                       f"host), busy {s_busy!r} ms ({s_busy / busy!r} of busy)")
            if toks is not None and cfg.family == "hybrid":
                # layer 0's SSM branch and its chunked scan alone, on that layer's
                # own input, times the layers
                lp = lm.layer_params(params["blocks"], 0)
                x = lm.embed(params, buffers, cfg, torch.from_numpy(toks).to(device))
                hin = L.apply_norm(lp["ln1"], x)
                xc, _, proj, _ = ssm_lib.ssm_project(lp["ssm"], cfg, hin)
                dt, B_t, C_t = ssm_lib._split_proj(lp["ssm"], cfg, proj)
                A = -torch.exp(lp["ssm"]["A_log"].float())
                terms = (dt, B_t.float(), C_t.float(), xc.float(), A)
                branch = cfg.n_layers * device_busy_ms(
                    lambda: ssm_lib.ssm_train(lp["ssm"], cfg, hin))
                scan = cfg.n_layers * device_busy_ms(lambda: ssm_lib.selective_scan(*terms))
                numbers[name].update(ssm_branch_busy_ms=branch, ssm_scan_busy_ms=scan,
                                     ssm_scan_share=scan / busy)
                ssm = (f"; the SSM branch {branch!r} ms busy over {cfg.n_layers} layers "
                       f"({branch / busy!r} of busy), its chunked scan {scan!r} ms "
                       f"({scan / busy!r} of busy)")
            if moe:
                parts = moe_busy(cfg, params, buffers, toks, device)
                numbers[name].update({f"moe_{k}": v for k, v in parts.items()},
                                     moe_busy_share=parts["layers"] / busy)
                ssm = (f"; the {cfg.n_layers} MoE layers busy {parts['layers']!r} ms "
                       f"({parts['layers'] / busy!r} of busy): "
                       + ", ".join(f"{k} {v!r}" for k, v in parts.items() if k != "layers"))
            print(f"[{card}] {label} serve {name}: host {h!r} ms, device busy {busy!r} ms "
                  f"(idle share {1 - busy / h!r}){ssm}", flush=True)

    lookup = lm_lookup_numbers(card, cfg, params, buffers, prompts, max(idle_prefills),
                               bf16=moe)
    cut = lm_cut_check(card, label, cfg, params, buffers, np.resize(prompts[-1], check_prompt),
                       check_decode, device=device)
    if moe:
        cut, numbers["cut_routing_flips"] = cut
    numbers["cut_max_rel_err"] = cut
    return launches, lookup, numbers


def moe_decode_routes(trace, slots, n_layers: int) -> list:
    """The routing of one request at each decode tick it took part in:
    ``trace`` a run's ``models.moe.TRACE``, ``slots`` its slot at each
    tick (None where it had none; ``slots`` None: slot 0 at every tick, a
    request served alone).  Returns one (n_layers, k) gate_idx a tick, on
    the CPU."""
    import torch

    ticks = [g for kind, g, _ in trace if kind == "decode"]
    if slots is None:
        slots = [0] * (len(ticks) // n_layers)
    check(len(ticks) == n_layers * len(slots),
          f"{len(ticks)} decode routes traced over {len(slots)} ticks of {n_layers} layers")
    return [torch.stack([ticks[i * n_layers + layer][slot, 0] for layer in range(n_layers)]).cpu()
            for i, slot in enumerate(slots) if slot is not None]


def moe_busy(cfg, params, buffers, toks, device="cuda") -> dict:
    """Device busy ms of the moe layers in one prefill of ``toks`` (1, S)
    (``toks`` None: one decode tick of LM_MAX_BATCH tokens), from layer
    0's routes on its normed input (the embedding: the route's cost does
    not depend on the values, its capacity fixes every product's size),
    times the layers: "layers" the route whole; for a prefill also its
    parts, "router" (the product, softmax and sort), "dispatch" (the
    capacity positions, the combine weights and the dispatch einsum),
    "experts" (the three batched products and the casts) and "combine"
    (the last einsum)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib

    lp = lm.layer_params(params["blocks"], 0)
    p = lp["moe"]
    n = cfg.n_layers
    with torch.inference_mode():
        if toks is None:
            ids = torch.zeros((LM_MAX_BATCH, 1), dtype=torch.int64, device=device)
            hin = L.apply_norm(lp["ln2"], lm.embed(params, buffers, cfg, ids))
            return {"layers": n * device_busy_ms(lambda: moe_lib.apply_moe_decode(p, cfg, hin))}
        x = lm.embed(params, buffers, cfg, torch.as_tensor(toks, device=device))
        hin = L.apply_norm(lp["ln2"], x)
        B, S, d = hin.shape
        g, G, C = moe_lib._groups(cfg, B * S, cfg.moe_group)
        xg = hin.reshape(G, g, d)
        _, gate_vals, gate_idx = moe_lib.route(p, cfg, xg)
        combine, _ = moe_lib._combine_weights(cfg, gate_vals, gate_idx, C)

        def dispatch():
            w, _ = moe_lib._combine_weights(cfg, gate_vals, gate_idx, C)
            return torch.einsum("gtec,gtd->gecd", (w > 0).to(hin.dtype), xg)

        expert_in = dispatch()
        expert_out = moe_lib.grouped_experts(p, expert_in)
        return {"layers": n * device_busy_ms(
                    lambda: moe_lib.apply_moe(p, cfg, hin, group_size=cfg.moe_group)),
                "router": n * device_busy_ms(lambda: moe_lib.route(p, cfg, xg)),
                "dispatch": n * device_busy_ms(dispatch),
                "experts": n * device_busy_ms(lambda: moe_lib.grouped_experts(p, expert_in)),
                "combine": n * device_busy_ms(lambda: torch.einsum(
                    "gtec,gecd->gtd", combine.to(hin.dtype), expert_out))}


def hybrid_serve_phase(card: str, cfg, device="cuda"):
    """``lm_serve_phase`` on the hybrid family (hymba-1.5b): prompts past
    the window take ``_sdpa`` under the windowed mask, those within it the
    flash kernel; the cut's check runs a prompt past the window and not a
    multiple of the SSM's chunk, then decode steps over the ring."""
    return lm_serve_phase(card, cfg, device, label="hybrid", check_prompt=HYBRID_CHECK_PROMPT,
                          check_decode=HYBRID_CHECK_DECODE, idle_prefills=HYBRID_IDLE_PREFILLS)


def vlm_serve_phase(card: str, cfg, device="cuda"):
    """``lm_serve_phase`` on the vlm family (paligemma-3b): text prompts
    padded into buckets, every prefill through the flash kernel at D 256
    (8 query heads over one KV head), the tied CCE head; the cut's check
    adds 4 decode steps and a forward with patch embeddings prepended."""
    return lm_serve_phase(card, cfg, device, label="vlm", check_decode=VLM_CHECK_DECODE,
                          idle_prefills=(LM_MAX_SEQ,))


def xlstm_serve_phase(card: str, cfg, device="cuda"):
    """``lm_serve_phase`` on the xlstm family (xlstm-1.3b): prompts
    unpadded, no attention (flash 0), the recurrent states in the cache;
    the cut (the first mLSTM and sLSTM blocks) prefills a prompt of one
    whole and one ragged mLSTM chunk, then takes 4 decode steps."""
    return lm_serve_phase(card, cfg, device, label="xlstm", check_prompt=XLSTM_CHECK_PROMPT,
                          check_decode=XLSTM_CHECK_DECODE, idle_prefills=XLSTM_IDLE_PREFILLS)


def moe_serve_phase(card: str, cfg, device="cuda"):
    """``lm_serve_phase`` on the moe family (phi3.5-moe-42b-a6.6b at full
    width, MOE_LAYERS of its layers): prompts padded into buckets, the
    pads routed and taking capacity, every prefill through the flash
    kernel (32 query heads over 8 KV heads of 128) and the einsum route,
    every tick through all the experts; the request alone held by its
    tokens up to its first decode step routed otherwise; the lookup at
    dsub 1024 also in bfloat16; the cut's routing traced (``MoeReach``),
    4 decode steps after its prefill."""
    return lm_serve_phase(card, cfg, device, label="moe", check_decode=MOE_CHECK_DECODE,
                          idle_prefills=MOE_IDLE_PREFILLS)


def _audio_prompts(cfg) -> list:
    """AUDIO_REQUESTS prompts of (frames, n_codebooks) int32, their lengths
    uniform over AUDIO_PROMPTS (from LM_SEED), each from its own step of
    ``lm_token_batches(n_codebooks=...)`` (no delay pattern: the model's
    inputs have it applied upstream)."""
    import numpy as np

    from repro_torch.data.synthetic import lm_token_batches

    lens = np.random.default_rng(LM_SEED).integers(AUDIO_PROMPTS[0], AUDIO_PROMPTS[1] + 1,
                                                   AUDIO_REQUESTS)
    return [next(lm_token_batches(cfg.vocab, 1, int(n), seed=LM_SEED, start_step=i,
                                  n_codebooks=cfg.n_codebooks))["tokens"][0]
            for i, n in enumerate(lens)]


def audio_serve(cfg, params, buffers, prompts, device="cuda", timings=None):
    """The audio family served through ``lm.prefill`` and ``lm.decode_step``
    (the engine refuses codebooks, as the JAX package's does): a cache of
    AUDIO_REQUESTS rows and AUDIO_MAX_SEQ frames, each prompt prefilled
    alone and unpadded into its own row, then AUDIO_TICKS batched decode
    ticks over every row, each at its own position, greedy (an argmax per
    codebook); rows past the prompts idle at position 0.  ``timings`` (a
    dict) gets the host ms of each prefill by length and of each tick.
    Returns (frames (AUDIO_TICKS + 1, len(prompts), n_codebooks) on the
    CPU: the prefills' picks, then each tick's; the prefill logits (cb,
    vocab) of each prompt)."""
    import torch

    from repro_torch.models import lm

    cache = lm.init_cache(cfg, AUDIO_REQUESTS, AUDIO_MAX_SEQ, device=device)
    nxt = torch.zeros((AUDIO_REQUESTS, cfg.n_codebooks), dtype=torch.int64, device=device)
    pos = torch.zeros((AUDIO_REQUESTS,), dtype=torch.int64, device=device)
    logits, frames = [], []

    def timed(kind, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if timings is not None:
            timings.setdefault(kind, []).append((time.perf_counter() - t) * 1e3)
        return out

    with torch.inference_mode():
        for row, p in enumerate(prompts):
            toks = torch.from_numpy(p.astype("int64")).to(device)[None]
            view = {k: c.narrow(1, row, 1) for k, c in cache.items()}
            out, _ = timed(len(p), lambda: lm.prefill(params, buffers, cfg, toks, view))
            logits.append(out[0])
            nxt[row] = out[0].argmax(-1)
            pos[row] = len(p)
        frames.append(nxt[:len(prompts)].cpu())
        for _ in range(AUDIO_TICKS):
            out, _ = timed("tick", lambda: lm.decode_step(params, buffers, cfg, nxt, pos, cache))
            nxt = out.argmax(-1)
            pos += 1
            frames.append(nxt[:len(prompts)].cpu())
    return torch.stack(frames), logits


def audio_launcher(card: str) -> dict:
    """``launch.train.main`` with AUDIO_LAUNCHER on the card, the launch
    counts reset just before and read just after: the reduced CCE model
    (vocab x n_codebooks rows of codebook-offset tokens, no tracker), one
    lookup and one backward a step, one assignment a transition.  Then
    each kernel against its plain version at the shapes the run gave it:
    the lookup on its first batch's rows through the trained table, and
    the backward on them with a unit-normal dout, bit for bit; the
    assignment at (c, the table's rows, k, dsub) within ASSIGN_RTOL of the
    plain minimum.  Returns the launch counts."""
    import torch

    from repro_torch.kernels import cce_lookup as cl
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm

    ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    tr = launch_train.main(list(AUDIO_LAUNCHER))
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    losses = [h["loss"] for h in tr.history]
    steps = int(tr.state.step)
    check(tr.id_tracker is None and all(math.isfinite(x) for x in losses),
          f"audio launcher: tracker {tr.id_tracker}, losses {losses}")
    check(launches.get("cce_lookup_fwd") == launches.get("cce_lookup_bwd") == steps
          and launches.get("kmeans_assign") == tr.clusters_done >= 1,
          f"audio launcher launches {launches} != a lookup and a backward a step "
          f"({steps}), an assignment a transition ({tr.clusters_done})")
    args = launch_train.parser().parse_args(list(AUDIO_LAUNCHER))
    cfg = launch_train.lm_config(args.arch, args.emb)
    table = lm.make_emb(cfg)
    toks = torch.from_numpy(next(launch_train.lm_data(cfg, args)(0))["tokens"]).long()
    ids = toks + torch.arange(cfg.n_codebooks) * cfg.vocab  # embed's rows
    tables = tr.state.params["emb"]["tables"].contiguous()
    idx = table._rows(tr.state.ebuf["emb"], ids.reshape(-1).to(tables.device)).reshape(
        table.c, -1, 2)
    check(torch.equal(cl.cce_lookup_fwd(idx, tables), ref.cce_lookup_ref(idx, tables)),
          "audio launcher: the lookup kernel != plain at its rows")
    dout = torch.randn((idx.shape[1], table.c, table.dsub), device=tables.device,
                       generator=torch.Generator(device=tables.device).manual_seed(LM_SEED))
    shape = f"c={table.c} B={idx.shape[1]} k={table.k} dsub={table.dsub} {cl_path(tables)}"
    bwd_err, _ = bwd_check(card, f"audio launcher {shape}", idx, dout, table.k, timed=False)
    *_, excess, agree = check_batched_assign(table.c, table.d1, table.k, table.dsub,
                                             tables.device)
    check(excess <= ASSIGN_RTOL, f"audio launcher: assignment excess {excess} at its shape")
    print(f"[{card}] audio launcher: main({list(AUDIO_LAUNCHER)}) on the card in {wall!r} s: "
          f"{steps} steps, {tr.clusters_done} transitions (no tracker: rows sampled "
          f"uniformly), losses {losses}; launches {launches}; at its shapes the lookup "
          f"({shape}) equal to plain, the backward equal to plain ({bwd_err!r}), the "
          f"assignment at ({table.c}, {table.d1}, {table.k}, {table.dsub}) within {excess!r} "
          f"of the plain minimum (equal picks {agree!r})", flush=True)
    return launches


def audio_serve_phase(card: str, cfg, device="cuda"):
    """Full-width musicgen-medium (48 layers, MHA of 24 heads of 64, a
    full table of 4 x 2048 rows and 4 heads, sinusoidal positions) from a
    CUDA generator, served by ``audio_serve`` with the launch counts reset
    just before and read just after (flash once a layer a prefill, no
    other kernel); then the longest request alone against its row in the
    batch (frames and prefill logits), the host time, device busy and idle
    share of one tick and of a prefill of AUDIO_PROMPTS[1] frames with their
    top kernels, the peak
    less what earlier phases left, the params the init holds beside the
    JAX package's formula, a LM_CHECK_LAYERS cut on the card against CPU
    copies (``lm_cut_check``: a LM_CHECK_PROMPT-frame prefill, then
    AUDIO_CHECK_DECODE decode steps), and the launcher as a user runs it
    (``audio_launcher``).  Returns (launches, the launcher's launches,
    numbers)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    left = torch.cuda.memory_allocated()  # what earlier phases left allocated
    params, buffers = lm.init(cfg, torch.Generator(device=device).manual_seed(LM_SEED),
                              device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    on_card = (torch.cuda.memory_allocated() - left) / 2**30 if device == "cuda" else 0.0
    print(f"[{card}] audio init: {cfg.name} {cfg.n_layers}L d={cfg.d_model} {cfg.n_heads}H/"
          f"{cfg.n_kv_heads}KV hd={cfg.head_dim} ff={cfg.d_ff} vocab={cfg.vocab} x "
          f"{cfg.n_codebooks} codebooks norm={cfg.norm} act={cfg.act} pos={cfg.pos_emb} "
          f"emb={cfg.emb_method}: {n_params} params (the JAX package's formula "
          f"{cfg.n_params()}: it counts the table as vocab x d and no biases), {on_card:.2f} GiB "
          f"on the card, {time.perf_counter() - t0:.3f} s", flush=True)
    prompts = _audio_prompts(cfg)
    audio_serve(cfg, params, buffers, [p[:AUDIO_PROMPTS[0]] for p in prompts[:2]],
                device)  # first-call set-up (cuBLAS handles, the kernels' libraries) stays out
    timings = {}
    reset_peak()
    ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    frames, logits = audio_serve(cfg, params, buffers, prompts, device, timings)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    raw_peak = torch.cuda.max_memory_allocated()
    peak = (raw_peak - left) / 1e9
    check(launches == {"flash_attention": cfg.n_layers * AUDIO_REQUESTS},
          f"audio serve launches {launches} != flash {cfg.n_layers} x {AUDIO_REQUESTS} prefills")
    check(tuple(frames.shape) == (AUDIO_TICKS + 1, AUDIO_REQUESTS, cfg.n_codebooks)
          and bool(((frames >= 0) & (frames < cfg.vocab)).all())
          and all(bool(torch.isfinite(x).all()) for x in logits),
          f"audio serve: frames {tuple(frames.shape)} or logits out of range")
    n_frames = frames.shape[0] * frames.shape[1]
    ticks = timings.pop("tick")
    print(f"[{card}] audio serve: {AUDIO_REQUESTS} requests (prompts "
          f"{sorted(len(p) for p in prompts)} frames of {cfg.n_codebooks} codebooks), each "
          f"prefilled alone into its row of a cache of {AUDIO_REQUESTS} rows and {AUDIO_MAX_SEQ} "
          f"frames, then {AUDIO_TICKS} batched greedy ticks: {n_frames} frames in {wall!r} s "
          f"({n_frames / wall!r} frames/s); prefill host ms by length "
          + ", ".join(f"{n}: {v[0]!r}" for n, v in sorted(timings.items()))
          + f"; tick host ms median {statistics.median(ticks)!r} (min {min(ticks)!r}, max "
          f"{max(ticks)!r}); launches {launches}; peak {peak!r} GB allocated ({raw_peak / 1e9!r}"
          f" GB less the {left / 1e9!r} GB earlier phases left)", flush=True)
    numbers = dict(frames_per_s=n_frames / wall, tick_ms=statistics.median(ticks),
                   prefill_ms={n: v[0] for n, v in timings.items()}, peak_gb=peak,
                   n_params=n_params, n_params_formula=cfg.n_params())

    # the longest request alone: its frames and prefill logits as in the batch
    solo = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    alone, alone_logits = audio_serve(cfg, params, buffers, [prompts[solo]], device)
    same = torch.equal(alone[:, 0], frames[:, solo])
    dn = str(cfg.dtype).split(".")[-1]
    solo_err = _max_rel(alone_logits[0], logits[solo].cpu())
    check(same, f"request {solo} alone gives frames {alone[:, 0].tolist()} != its row in the "
          f"batch {frames[:, solo].tolist()}")
    check(solo_err <= LM_LOGIT_RTOL[dn], f"request {solo}'s prefill logits alone vs in the "
          f"batch: {solo_err} of the largest > {LM_LOGIT_RTOL[dn]}")
    numbers["solo_logits_max_rel_err"] = solo_err
    print(f"[{card}] audio serve: request {solo} ({len(prompts[solo])} frames) alone gives "
          f"its batch frames ({AUDIO_TICKS + 1} x {cfg.n_codebooks}, first "
          f"{frames[:3, solo].tolist()}) and its prefill logits within {solo_err!r} of the "
          f"largest (tolerance {LM_LOGIT_RTOL[dn]})", flush=True)
    del logits, alone_logits

    # host, device busy and idle share of one tick and of the longest prefill
    cache = lm.init_cache(cfg, AUDIO_REQUESTS, AUDIO_MAX_SEQ, device=device)
    row0 = {k: c.narrow(1, 0, 1) for k, c in cache.items()}
    longest = np.resize(np.concatenate(prompts), (AUDIO_PROMPTS[1], cfg.n_codebooks))
    toks = torch.from_numpy(longest.astype(np.int64)).to(device)[None]
    nxt = frames[-1].to(device)
    pos = torch.tensor([len(p) for p in prompts], device=device)
    with torch.inference_mode():
        cases = [("decode tick", lambda: lm.decode_step(params, buffers, cfg, nxt, pos, cache)),
                 (f"prefill {AUDIO_PROMPTS[1]}",
                  lambda: lm.prefill(params, buffers, cfg, toks, row0))]
        for name, fn in cases:
            fn()
            host = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1e3)
            busy = device_busy_ms(fn)
            top = top_kernels(fn, 5)
            h = statistics.median(host)
            numbers[name] = dict(host_ms=h, busy_ms=busy, idle_share=1 - busy / h,
                                 top_kernels=top)
            print(f"[{card}] audio serve {name}: host {h!r} ms, device busy {busy!r} ms "
                  f"(idle share {1 - busy / h!r}); top kernels (ms a call) {top}", flush=True)
    del cache, row0
    cut = lm_cut_check(card, "audio", cfg, params, buffers,
                       np.resize(prompts[-1], (LM_CHECK_PROMPT, cfg.n_codebooks)),
                       AUDIO_CHECK_DECODE, device=device)
    numbers["cut_max_rel_err"] = cut
    del params, buffers
    return launches, audio_launcher(card), numbers


def lm_table_assign_numbers(card: str, x, cent, ptr, *,
                            library_by_column: bool = False) -> tuple[float, dict]:
    """The assignment kernel at the LM token table's transition: x the
    materialised vocabulary (c, d1, dsub) and cent the centroids (c, k,
    dsub) that ``assign_all`` took, ptr the pointers it wrote.  The kernel
    gives ptr again bit for bit, then ``tiled_assign_numbers`` on the same
    inputs.  Returns (max excess, numbers)."""
    import torch

    from repro_torch.kernels import kmeans_assign as ka

    check(torch.equal(ka.kmeans_assign(x, cent), ptr),
          "the assignment kernel on the transition's inputs != its ptr")
    nums = tiled_assign_numbers(card, x, cent, "the transition's own inputs, equal to its ptr",
                                library_by_column=library_by_column)
    return nums["max_excess"], nums


def _lm_batch(vocab: int, batch: int, seq: int, seed: int, step: int):
    """Batch ``step`` of ``lm_token_batches`` and the host ms it took: one
    worker's job (each batch depends only on the seed and its step)."""
    from repro_torch.data.synthetic import lm_token_batches

    t0 = time.perf_counter()
    out = next(lm_token_batches(vocab, batch, seq, seed=seed, start_step=step))
    return out, (time.perf_counter() - t0) * 1e3


def lm_train_phase(card: str, cfg, device="cuda", *, label="lm", batch=LM_TRAIN_BATCH,
                   steps=LM_TRAIN_STEPS, post=LM_TRAIN_POST):
    """Full-width LM training through ``launch.train.build_lm_trainer``:
    ``steps`` steps of ``batch`` x LM_TRAIN_SEQ tokens, the CCE token
    table's transition from the dense token counts (moments remapped),
    ``post`` more steps, with the launch counts reset just before and read
    just after; the transition's invariants, its by-phase host ms and
    device busy (a second run from the same inputs, bitwise equal), the
    step's host ms, device busy and top kernels, and the peak memory less
    what was allocated at the reset and at the phase's start.  For the
    xlstm family the step's busy and top kernels come
    from the first step's raw trace, its host from the steps after it, and
    the 6 sLSTM blocks' share of the step's host (summed inside the timed
    steps: ``slstm_seq``'s forwards and the recurrence's backward) and of
    its busy (superblock 0's block alone, forward twice and backward as
    remat runs it, times the superblocks).  Then the lookup backward at a
    step's own token rows and the assignment at the transition's own
    inputs against their plain versions, timed, and the lookup forward at
    the same rows on the tables before the transition; and on a
    LM_CHECK_LAYERS cut of the configuration (``lm_cut``): the first loss
    and gradients on the card against CPU copies (float32 and bfloat16;
    the xlstm family's bfloat16 gradients against the CPU's float32 ones,
    BF16_OWN_RATIO),
    two runs of LM_CUT_STEPS steps, a transition and 2 steps from one seed
    equal bit for bit, and a run crashed after its checkpoint at
    LM_CUT_STEPS and resumed equal to them.  Returns ({label_train:
    launches}, the lookup forward's numbers, max lookup-backward error,
    its numbers, max assignment excess, its numbers, step numbers)."""
    import argparse
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import random as jr
    from repro_torch.core import cce as cce_lib
    from repro_torch.core import hashing
    from repro_torch.core import kmeans as km
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_lm_trainer, run_with_restart
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.train import loop
    from repro_torch.tree import jax_leaves, jax_leaves_with_paths, tree_leaves, tree_map

    path = f"{label}_train"
    xlstm = cfg.family == "xlstm"
    left = torch.cuda.memory_allocated()  # what earlier phases left allocated
    n_steps = steps + post
    print(f"[{card}] {label} train: {cfg.name} {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab} "
          f"emb={cfg.emb_method} remat={cfg.remat} attn={cfg.attn_impl}; train_4k's 256 x "
          f"4096 tokens in microbatches of {cfg.train_microbatch} cut to one microbatch of "
          f"{batch} x {LM_TRAIN_SEQ} (accum 1), {steps} steps, the token table's transition, "
          f"{post} step(s)", flush=True)

    def make_args(seq, n, cluster_every, **kw):
        return argparse.Namespace(**dict(dict(
            device=device, seed=LM_SEED, lr=LM_TRAIN_LR, warmup=LM_TRAIN_WARMUP, steps=n,
            batch=batch, seq=seq, accum=1, emb="cce", ckpt_dir=None, ckpt_every=0,
            cluster_every=cluster_every, fail_at=[]), **kw))

    def cut_batches(n):  # batch x LM_CUT_SEQ tokens take milliseconds
        return [_lm_batch(cfg.vocab, batch, LM_CUT_SEQ, LM_SEED, st)[0] for st in range(n)]

    # batches 0..n_steps-1 of the run's token stream, made in parallel: a
    # full-width batch takes seconds of numpy
    args = make_args(LM_TRAIN_SEQ, n_steps, steps, cluster_max=1)
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(n_steps, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        made = list(pool.map(_lm_batch, *zip(*[
            (cfg.vocab, batch, LM_TRAIN_SEQ, LM_SEED, st) for st in range(n_steps)])))
    data_wall = (time.perf_counter() - t0) * 1e3
    raw, data_ms = [b for b, _ in made], statistics.mean(ms for _, ms in made)
    check([b["step"] for b in raw] == list(range(n_steps)), "token batches out of order")
    print(f"[{card}] {label} train data: {n_steps} batches of {batch} x {LM_TRAIN_SEQ} "
          f"tokens (lm_token_batches, host numpy), {data_ms!r} ms a batch in its process "
          f"({data_wall!r} ms for all, in parallel)", flush=True)
    t0 = time.perf_counter()
    trainer = build_lm_trainer(cfg, args, data_from=lambda s: iter(raw[s:]))
    n_params = sum(t.numel() for t in tree_leaves(trainer.state.params))
    print(f"[{card}] {label} train init: {n_params} params, "
          f"{(torch.cuda.memory_allocated() - left) / 1e9!r} GB allocated with the adamw "
          f"moments, {time.perf_counter() - t0:.3f} s", flush=True)
    table = lm.make_emb(cfg)

    # the first loss and gradients of a LM_CHECK_LAYERS cut, card vs CPU copies
    toks = torch.from_numpy(cut_batches(1)[0]["tokens"]).to(torch.int64)
    params, buffers = trainer.state.params, trainer.state.ebuf
    cut_cfg, cut_p = lm_cut(cfg, params)
    cpu_p = tree_map(lambda t: t.detach().to("cpu", copy=True), cut_p)
    cpu_b = tree_map(lambda t: t.detach().to("cpu", copy=True), buffers)
    paths, cpu_f32 = None, None  # the CPU's float32 gradients

    def rel_errors(got, want):  # (max |got - want|, the leaf's or NOISE_GRAD_SCALE's largest)
        errs = _leaf_errors(got, want)
        scale = {p: m for p, (_, m) in zip(paths, errs)}
        return [(e, max(m, scale.get(NOISE_GRAD_SCALE.get(p), 0.0)))
                for p, (e, m) in zip(paths, errs)]

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        cut = dataclasses.replace(cut_cfg, dtype=dtype)

        def loss_fn(p, b, mb, cut=cut):
            return lm.next_token_loss(p, b, cut, mb)

        l_dev, g_dev = loop.value_and_grad(loss_fn, cut_p, buffers, {"tokens": toks.to(device)})
        t0 = time.perf_counter()
        l_cpu, g_cpu = loop.value_and_grad(loss_fn, cpu_p, cpu_b, {"tokens": toks})
        cpu_s = time.perf_counter() - t0
        rel = abs(l_dev.item() - l_cpu.item()) / abs(l_cpu.item())
        paths = [p for p, _ in jax_leaves_with_paths(g_cpu)]
        g_dev, g_cpu = jax_leaves(g_dev), jax_leaves(g_cpu)
        errs, floors = rel_errors(g_dev, g_cpu), None
        what = "card vs CPU"
        if cpu_f32 is not None:
            # bfloat16 rounding alone on the CPU: its bfloat16 against its float32
            own = [e / max(m, 1e-30) for e, m in rel_errors(g_cpu, cpu_f32)]
            worst_own = max(zip(own, paths))
            what += (f" (the CPU's own {dn} against its float32: largest {worst_own[0]!r}, "
                     f"{worst_own[1]})")
            if xlstm:
                vs_cpu = max(e / max(m, 1e-30) for e, m in errs)
                errs, floors = rel_errors(g_dev, cpu_f32), [BF16_OWN_RATIO * o for o in own]
                what = (f"card {dn} vs CPU float32, each within the larger of "
                        f"{LM_GRAD_RTOL[dn]} and {BF16_OWN_RATIO} x the CPU's own {dn} error "
                        f"against its float32 (card vs CPU {dn}: largest {vs_cpu!r})")
        worst = sorted(zip((e / max(m, 1e-30) for e, m in errs), paths,
                           floors or [0.0] * len(errs)), reverse=True)[:3]
        print(f"[{card}] {label} train, {LM_CHECK_LAYERS}-layer cut, {batch} x "
              f"{LM_CUT_SEQ} tokens, {dn}: first loss card {l_dev.item()!r} vs CPU "
              f"{l_cpu.item()!r} (relative {rel!r}, tolerance {LM_LOSS_RTOL[dn]}; CPU "
              f"{cpu_s:.1f} s); gradient leaves relative to the leaf's largest magnitude "
              f"(NOISE_GRAD_SCALE's to another's), {what}, tolerance {LM_GRAD_RTOL[dn]}; worst: "
              + ", ".join(f"{p} {r!r}" + (f" (limit {max(LM_GRAD_RTOL[dn], f)!r})" if f else "")
                          for r, p, f in worst),
              flush=True)
        check(math.isfinite(l_dev.item()) and rel <= LM_LOSS_RTOL[dn],
              f"{LM_CHECK_LAYERS}-layer cut's loss card {l_dev.item()} vs CPU {l_cpu.item()} "
              f"({dn})")
        _check_close(errs, f"{dn} cut gradients", LM_GRAD_RTOL[dn], floors)
        if cpu_f32 is None:
            cpu_f32 = g_cpu
        del g_dev, g_cpu
    del cut_p, cpu_p, cpu_b, params, buffers, cpu_f32

    # the main run: steps timed between synchronisations, the transition by
    # phase; for the xlstm family the host time inside the sLSTM blocks and
    # the mLSTM blocks' forwards, and the first step traced, not timed (its
    # ~10^6 launches make a step of its own too dear)
    step_ms, slstm_ms, mlstm_ms, seen, traced = [], [], [], {}, {}
    orig_step, orig_cluster = trainer.train_step, trainer.cluster_fn
    phases = [(cce_lib.CCE, "materialize", "sample materialize"),
              (km, "kmeans_columns", "kmeans++/Lloyd"),
              (cce_lib.CCE, "assign_all", "assign_all"),
              (cce_lib.CCE, "remap_moments", "moment remap")]

    def timed_step(state, mb):
        torch.cuda.synchronize()
        slstm_ms.append(0.0)
        mlstm_ms.append(0.0)
        if xlstm and len(slstm_ms) == 1:  # the first step: one raw trace
            out = []
            traced.update(zip(("busy", "by_name"),
                              device_busy_long(lambda: out.append(orig_step(state, mb)))))
            return out[0]
        t = time.perf_counter()
        out = orig_step(state, mb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def cluster(key, p, b, opt):
        distinct = int(np.count_nonzero(trainer.id_tracker.counts[0]))
        check(distinct > table.k, f"{distinct} distinct tokens observed, not over k={table.k}")
        orig_kmeans = km.kmeans_columns

        def kmeans(keys, x, k, *a, **kw):  # keeps the first column's sample
            seen.setdefault("sample", (keys[0], x[0], kw.get("weights"), kw.get("niter", 50)))
            return orig_kmeans(keys, x, k, *a, **kw)

        km.kmeans_columns = kmeans
        try:
            with PhaseClock(phases) as clock:
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = orig_cluster(key, p, b, opt)
                torch.cuda.synchronize()
                total = (time.perf_counter() - t) * 1e3
        finally:
            km.kmeans_columns = orig_kmeans
        launched = dict(ops.LAUNCHES)
        # a second run from the same inputs, each call of a phase but the
        # k-means profiled (a trace of its ~6e4 kernels a column takes minutes
        # to read: its busy is measured on the first column's sample below)
        with PhaseBusy([ph for ph in phases if ph[0] is not km]) as busy:
            again = orig_cluster(key, p, b, opt)
        ops.LAUNCHES.clear()  # the second run is not the main path's
        ops.LAUNCHES.update(launched)
        check(all(torch.equal(x, y) for x, y in zip(tree_leaves(out), tree_leaves(again))),
              "a second transition from the same inputs differs")
        # the steps after it update the new tables and moments in place
        new_p, new_b, new_opt = out
        seen.update(key=key, old_p=p["emb"], old_b=b["emb"], new_b=new_b, total=total,
                    new=tree_map(torch.clone, (new_p["emb"]["tables"], new_opt["m"]["emb"],
                                               new_opt["v"]["emb"])),
                    clock=dict(clock.ms), busy=dict(busy.ms), distinct=distinct)
        return out

    inner = (xlstm_lib.slstm_seq, xlstm_lib._Recurrence.backward, xlstm_lib.mlstm_train)

    def add_ms(fn, to):  # adds fn's host ms to the current step's entry of ``to``
        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if to:
                    to[-1] += (time.perf_counter() - t) * 1e3
        return timed

    trainer.train_step, trainer.cluster_fn = timed_step, cluster
    ops.LAUNCHES.clear()
    at_reset = reset_peak()
    # lm calls the blocks through the module, autograd the backward through its class
    xlstm_lib.slstm_seq = add_ms(inner[0], slstm_ms)
    xlstm_lib._Recurrence.backward = staticmethod(add_ms(inner[1], slstm_ms))
    xlstm_lib.mlstm_train = add_ms(inner[2], mlstm_ms)
    try:
        trainer.run(n_steps)
    finally:
        xlstm_lib.slstm_seq, xlstm_lib.mlstm_train = inner[0], inner[2]
        xlstm_lib._Recurrence.backward = staticmethod(inner[1])
    launches = {path: dict(ops.LAUNCHES)}
    raw_peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in trainer.history]
    check(len(losses) == n_steps and all(math.isfinite(x) for x in losses),
          f"{label} train losses {losses}")
    check(trainer.clusters_done == 1, f"{trainer.clusters_done} transitions, not 1")
    want = {"cce_lookup_fwd": n_steps, "cce_lookup_bwd": n_steps,
            "kmeans_assign": -(-table.d1 // (1 << 18))}
    check(launches[path] == want, f"{label} train launches {launches[path]} != {want}")
    print(f"[{card}] {label} train: {n_steps} steps of {batch * LM_TRAIN_SEQ} tokens, "
          f"losses {losses!r}; launches {launches[path]}; peak {(raw_peak - at_reset) / 1e9!r} "
          f"GB over the {(at_reset - left) / 1e9!r} GB of params, moments and buffers at the "
          f"reset, {(raw_peak - left) / 1e9!r} GB in all (max_memory_allocated "
          f"{raw_peak / 1e9!r} GB less the {left / 1e9!r} GB earlier phases left)", flush=True)

    # the transition's invariants
    new_tables, new_m, new_v = seen["new"]
    new_b = seen["new_b"]
    old_b, nb = seen["old_b"], new_b["emb"]
    epoch = int(old_b["epoch"])
    _, k2 = jr.split(jr.fold_in(seen["key"], epoch))
    hs = hashing.pack_hashes(hashing.make_hashes(hashing._seed_of(jr.fold_in(k2, 777)),
                                                 table.c, table.k)).astype(np.int64)
    ptr = nb["ptr"]
    check(int(nb["epoch"]) == epoch + 1, f"token table epoch {int(nb['epoch'])}")
    check(np.array_equal(nb["hs"].cpu().numpy(), hs), "token table hs off the key schedule")
    check(ptr.dtype == torch.int32 and tuple(ptr.shape) == (table.c, table.d1)
          and int(ptr.min()) >= 0 and int(ptr.max()) < table.k,
          f"token table ptr {ptr.dtype} {tuple(ptr.shape)} outside [0, {table.k})")
    check(not new_tables[:, 1].any(), "token table helper not zero")
    for slot, moments in (("m", new_m), ("v", new_v)):
        mt = moments["tables"]
        check(mt.shape == new_tables.shape and bool(torch.isfinite(mt).all())
              and not mt[:, 1].any(), f"remapped adamw {slot}: {tuple(mt.shape)}, not finite "
              f"or helper not zero")
    check(int(new_b["head"]["epoch"]) == 0, "the head's table was transitioned")
    # kmeans++/Lloyd's device busy: c x ((k - 1) kmeans++ iterations + niter
    # Lloyd steps), each measured on the first column's sample (every
    # iteration does the same work over the sample)
    key0, x0, w0, niter = seen.pop("sample")
    pp_iter = device_busy_ms(lambda: km.kmeans_plus_plus(key0, x0, 65, w0)) / 64
    cent0 = new_tables[0, 0].contiguous()
    lloyd = device_busy_ms(lambda: km._lloyd_step(x0, cent0, table.k, False, w0))
    seen["busy"]["kmeans++/Lloyd"] = table.c * ((table.k - 1) * pp_iter + niter * lloyd)
    phase_ms = seen["clock"]
    print(f"[{card}] {label} transition: {seen['distinct']} distinct tokens observed "
          f"(k={table.k}), epoch {epoch} -> {epoch + 1}, ptr in [0, k) for all {table.d1} ids, "
          f"hs on the key schedule, helper table and its m/v zero, m/v finite of the table's "
          f"shape; a second run from the same inputs is bitwise equal; {seen['total']!r} ms "
          f"host", flush=True)
    print(f"[{card}] {label} transition by phase: " + ", ".join(
        f"{k}: host {v!r} ms, device busy {seen['busy'].get(k, 0.0)!r} ms"
        for k, v in phase_ms.items()) + f"; other host {seen['total'] - sum(phase_ms.values())!r}"
        f" ms (host: the first run; device busy: the second, each call profiled, but "
        f"kmeans++/Lloyd's: {table.c} columns x ({table.k - 1} kmeans++ iterations of "
        f"{pp_iter!r} ms + {niter} Lloyd steps of {lloyd!r} ms), on {x0.shape[0]} sample "
        f"points)", flush=True)

    # the step: host ms, device busy, top kernels
    mb = trainer._to_device(raw[-1])

    def one_step():
        orig_step(trainer.state, mb)

    if xlstm:
        # the first step's raw trace (~10^6 kernel records: key_averages would
        # take minutes); the steps after it timed
        host, first, timed = statistics.median(step_ms), None, f"steps 2-{n_steps}"
        busy, by_name = traced["busy"], traced["by_name"]
        top = sorted(((v[0], v[1], k) for k, v in by_name.items()), reverse=True)[:4]
        top_txt = "; ".join(f"{k[:60]} {ms!r} ms x{n}" for ms, n, k in top)
        n_rec = sum(n for _, n in by_name.values())
        trace = f"step 1's raw trace, {n_rec} records"
    else:
        # one trace of 2 steps (after a warm-up step) gives the busy and the top
        # kernels: a step launches thousands of kernels, and reading a trace
        # costs about a second a few thousand records
        events = [e for e in _profile(one_step, 2) if _device_us(e)]
        busy = sum(_device_us(e) for e in events) / 1e3 / 2
        top_txt = "; ".join(f"{e.key[:60]} {_device_us(e) / 1e3 / 2!r} ms x{e.count / 2:g}"
                            for e in sorted(events, key=_device_us, reverse=True)[:4])
        trace = f"one trace of 2 steps, {sum(e.count for e in events)} kernel records"
        host, first = statistics.median(step_ms[1:]), step_ms[0]
        timed = f"steps 2-{len(step_ms)}; first {first!r}"
    step_at = dict(host_ms=host, first_ms=first, busy_ms=busy, idle_share=1 - busy / host,
                   peak_gb=(raw_peak - left) / 1e9, peak_over_reset_gb=(raw_peak - at_reset) / 1e9)
    print(f"[{card}] {label} train step, {batch} x {LM_TRAIN_SEQ} tokens: host {host!r} ms "
          f"(synchronised, median of {timed}), device busy {busy!r} ms (idle share "
          f"{1 - busy / host!r}; {trace}); top kernels: {top_txt}", flush=True)

    if xlstm:
        # the sLSTM blocks: host inside the timed steps; busy of superblock 0's
        # block alone on its normed input (the step's shape: the cost does not
        # depend on the values), as a remat step runs it, times the superblocks
        n_s, n_m = lm._xlstm_shape(cfg)
        s_host = statistics.median(slstm_ms[1:])  # the timed steps: all but the traced first
        s_share = statistics.median(a / b for a, b in zip(slstm_ms[1:], step_ms))
        m_host = statistics.median(mlstm_ms[1:])
        sp = {k: v.detach().requires_grad_(True)
              for k, v in lm.layer_params(trainer.state.params["blocks"]["slstm"], 0).items()}
        with torch.no_grad():
            x = lm.embed(trainer.state.params, trainer.state.ebuf, cfg, mb["tokens"][0])
            hin = L.apply_norm(lm.layer_params(trainer.state.params["blocks"]["norms"]["s"], 0),
                               x)
        w = torch.randn(hin.shape, generator=torch.Generator(device=device).manual_seed(1),
                        device=device, dtype=hin.dtype)

        def slstm_block(x=hin):  # forward twice (the checkpointed superblock's, its recompute)
            xlstm_lib.slstm_seq(sp, cfg, x)
            y, _ = xlstm_lib.slstm_seq(sp, cfg, x)
            torch.autograd.grad((y * w[:, :x.shape[1]]).sum(), list(sp.values()))

        s_busy = n_s * device_busy_long_ms(slstm_block)  # the step ran its kernels: warm
        step_at.update(slstm_host_ms=s_host, slstm_host_share=s_share, slstm_busy_ms=s_busy,
                       slstm_busy_share=s_busy / busy, mlstm_forward_host_ms=m_host)
        print(f"[{card}] {label} train step: the {n_s} sLSTM blocks host {s_host!r} ms inside "
              f"it ({s_share!r} of host: slstm_seq's forwards and the recurrence's backward), "
              f"busy {s_busy!r} ms ({s_busy / busy!r} of busy: superblock 0's block alone, "
              f"forward twice and backward, x{n_s}); the {n_s * n_m} mLSTM blocks' forwards "
              f"(3 a block under remat) host {m_host!r} ms", flush=True)
        del sp, x, hin, w

    # the kernels at this slice's shapes, on the path's own inputs
    toks = torch.from_numpy(raw[0]["tokens"]).to(device).reshape(-1)
    idx = table._rows(seen["old_b"], toks).reshape(table.c, -1, 2)
    g = torch.Generator(device=device).manual_seed(LM_SEED)
    dout = torch.randn((idx.shape[1], table.c, table.dsub), generator=g, device=device)
    bwd_err, bwd_at = bwd_check(
        card, f"float32 {label} train B={idx.shape[1]} c={table.c} T=2 k={table.k} "
        f"dsub={table.dsub} (a step's token rows)", idx, dout, table.k, plain_busy=False)
    old_p, cent = seen["old_p"], new_tables[:, 0].contiguous()
    fwd_at = lm_fwd_numbers(card, f"{label} train, a step's token rows", idx,
                            old_p["tables"].contiguous())
    del trainer, mb, seen, dout, new_tables, new_m, new_v
    x = table.materialize(old_p, old_b, torch.arange(table.d1, device=device))
    assign_err, assign_at = lm_table_assign_numbers(card, x, cent, ptr, library_by_column=xlstm)
    del x, cent, old_p, old_b

    # repeats on the cut: run A, and B from the same seed crashed after its
    # checkpoint at LM_CUT_STEPS and resumed, equal bit for bit (B's steps up to
    # its checkpoint repeat A's, so this holds the run's repeatability too)
    cut_steps = LM_CUT_STEPS + 2
    cut_raw = cut_batches(cut_steps)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_lm_"))
    runs = {}
    try:
        for tag, fail_at in (("A", []), ("B", [LM_CUT_STEPS + 1])):
            a = make_args(LM_CUT_SEQ, cut_steps, LM_CUT_STEPS, ckpt_dir=str(tmp / tag),
                          ckpt_every=LM_CUT_STEPS, fail_at=fail_at)
            tr = build_lm_trainer(cut_cfg, a, data_from=lambda st: iter(cut_raw[st:]))
            restored = run_with_restart(tr, cut_steps, lambda st: iter(cut_raw[st:]))
            check(restored == ([LM_CUT_STEPS] if fail_at else []), f"run {tag} restored "
                  f"at {restored}")
            check(tr.clusters_done == 1 and tr.state.step == cut_steps,
                  f"run {tag}: {tr.clusters_done} transitions, step {tr.state.step}")
            runs[tag] = (tr.state, {h["step"]: h["loss"] for h in tr.history},
                         tr.id_tracker.counts[0])
            del tr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref_state, ref_loss, ref_counts = runs["A"]
    state, loss, counts = runs["B"]
    for part in ("params", "opt", "ebuf"):
        check(all(torch.equal(a, b) for a, b in zip(tree_leaves(getattr(state, part)),
                                                    tree_leaves(getattr(ref_state, part)))),
              f"{label} cut run B differs from run A in {part}")
    check(loss == ref_loss and np.array_equal(counts, ref_counts),
          f"{label} cut run B: losses or token counts differ from run A")
    print(f"[{card}] {label} train, {LM_CHECK_LAYERS}-layer cut, {batch} x {LM_CUT_SEQ} "
          f"tokens: run A ({LM_CUT_STEPS} steps, a transition, 2 steps); run B from the same "
          f"seed crashed at step {LM_CUT_STEPS + 1} after its checkpoint at "
          f"{LM_CUT_STEPS}, resumed, equals it bit for bit (params, adamw state, ptr/hs/epoch, "
          f"losses, token counts)", flush=True)
    return launches, fwd_at, bwd_err, bwd_at, assign_err, assign_at, step_at


def xlstm_train_phase(card: str, cfg, device="cuda"):
    """``lm_train_phase`` on the xlstm family (xlstm-1.3b): XLSTM_TRAIN_STEPS
    steps of XLSTM_TRAIN_BATCH x LM_TRAIN_SEQ tokens, the transition,
    XLSTM_TRAIN_POST step(s), the first traced; the cut is the first mLSTM
    and first sLSTM block."""
    return lm_train_phase(card, cfg, device, label="xlstm", batch=XLSTM_TRAIN_BATCH,
                          steps=XLSTM_TRAIN_STEPS, post=XLSTM_TRAIN_POST)

KERNELS = {  # name -> (CUDA source, the TPU kernel's pallas_call it replaces)
    "cce_lookup_fwd": ("src/repro_torch/kernels/csrc/cce_lookup.cu",
                       "src/repro/kernels/cce_lookup.py:106"),
    "cce_lookup_bwd": ("src/repro_torch/kernels/csrc/cce_lookup_bwd.cu",
                       "src/repro/kernels/cce_lookup.py:134"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:67"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:97"),
}


def _clone_tree(tree):
    import torch

    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _all_equal(a, b) -> bool:
    import torch

    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def _n_params(params) -> int:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() for t in tree_leaves(params))


def mesh_serve(card: str, cfg, mesh, params, buffers, device="cuda", *, part="(a)",
               ticks=None, timing_iters=(3, 10)) -> dict:
    """(a), and (e) and (h) for the other families:
    ``launch.steps.build_serve_step`` on the (1, 1) mesh: the
    MESH_PROMPT_LENS prompts (the audio family's of n_codebooks streams;
    hymba's on both sides of its 1024-token window), each prefilled alone
    into its row of a 4-row cache, then ``ticks`` (MESH_TICKS) batched
    greedy ticks, held bit for bit against ``lm.prefill``/``lm.decode_step``
    on the card (every logit and every cache leaf); the launches of the
    sharded run (flash in every prefill within the window); a 1900-token
    prefill's and a tick's host and device busy time, over
    ``timing_iters`` calls each.  Returns the launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.shard import shard_tree

    prefill, _, (pspecs, cspecs) = steps.build_serve_step(cfg, mesh, "prefill_32k")
    decode, _, _ = steps.build_serve_step(cfg, mesh, "decode_32k")
    local = shard_tree(params, pspecs, mesh.coords[1], mesh.shape["model"])
    ticks = MESH_TICKS if ticks is None else ticks
    rng = np.random.default_rng(MESH_SEED)
    nc = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, (1, n, *nc))).to(device)
               for n in MESH_PROMPT_LENS]
    lens = torch.tensor(MESH_PROMPT_LENS, device=device)
    B = len(prompts)
    axes = lm.cache_batch_axis(cfg)

    def rows(cache, i, n=1):  # rows i..i+n of every cache leaf, along its batch axis
        return {k: v.narrow(axes[k], i, n) for k, v in cache.items()}

    def serve(pre, dec, cache, picks=None):
        """Each prompt into its row, then the ticks: (logits of every call,
        the tokens each tick was fed: ``picks``, else the greedy ones)."""
        out, fed = [], []
        for i, toks in enumerate(prompts):
            lg, _ = pre(toks, rows(cache, i))
            out.append(lg)
        nxt = torch.cat(out).float().argmax(-1)
        for t in range(ticks):
            nxt = nxt if picks is None else picks[t]
            fed.append(nxt)
            lg, _ = dec(nxt, lens + t, cache)
            out.append(lg)
            nxt = lg.float().argmax(-1)
        return out, fed

    with torch.inference_mode():
        cache = lm.init_cache(cfg, B, MESH_MAX_SEQ, device=device, group=mesh.model)
        ref_cache = lm.init_cache(cfg, B, MESH_MAX_SEQ, device=device)
        check(set(cache) == set(ref_cache) and all(cache[k].shape == ref_cache[k].shape
                                                   for k in cache)
              and ("k" not in cspecs or cspecs["k"].model == 3),
              f"the (1, 1) cache {({k: tuple(v.shape) for k, v in cache.items()})} is not the "
              f"unsharded one")
        torch.cuda.synchronize()
        ops.LAUNCHES.clear()
        t0 = time.perf_counter()
        got, fed = serve(lambda t, c: prefill(local, buffers, t, c),
                         lambda n, p, c: decode(local, buffers, n, p, c), cache)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        want, _ = serve(lambda t, c: lm.prefill(params, buffers, cfg, t, c),
                        lambda n, p, c: lm.decode_step(params, buffers, cfg, n, p, c),
                        ref_cache, picks=fed)
        lookups = B + ticks if cfg.emb_method == "cce" else 0
        flash = 0 if cfg.family == "xlstm" else cfg.n_layers * sum(
            1 for n in MESH_PROMPT_LENS if not cfg.sliding_window or n <= cfg.sliding_window)
        check(launches.get("flash_attention", 0) == flash
              and launches.get("cce_lookup_fwd", 0) == lookups,
              f"mesh serve launches {launches}: want {flash} flash and {lookups} lookups")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              "the (1, 1) serve step's logits differ from lm.prefill/decode_step's")
        check(all(torch.equal(cache[k], ref_cache[k]) for k in ref_cache),
              "the (1, 1) serve step's cache differs from lm.prefill/decode_step's")
        check(all(bool(torch.isfinite(x).all()) for x in got), "non-finite mesh logits")
        print(f"[{card}] mesh {part} {cfg.name}: build_serve_step on a (1, 1) mesh of one "
              f"{dist.get_backend(mesh.world)} rank: {B} prompts {list(MESH_PROMPT_LENS)} "
              f"prefilled alone into their rows, {ticks} batched ticks, {host_s!r} s; "
              f"launches {launches}; every logit ({len(got)} calls) and cache leaf equal to "
              f"lm.prefill/decode_step's on the card bit for bit", flush=True)
        row = rows(cache, B - 1)

        def one_prefill():
            prefill(local, buffers, prompts[-1], row)

        def one_tick():
            decode(local, buffers, fed[-1], lens + ticks, cache)

        timing = {}
        for name, fn, iters in (("prefill", one_prefill, timing_iters[0]),
                                ("tick", one_tick, timing_iters[1])):
            # an xlstm prefill launches ~27 kernels a token: one call's raw trace
            long = cfg.family == "xlstm" and name == "prefill"
            timing[name] = (time_ms(fn, iters=iters, reps=3, warmup=2),
                            device_busy_long_ms(fn) if long else device_busy_ms(fn, iters=iters))
        print(f"[{card}] mesh {part} {cfg.name} {cfg.n_layers} layers: prefill "
              f"{MESH_PROMPT_LENS[-1]}: host {timing['prefill'][0]!r} ms, device busy "
              f"{timing['prefill'][1]!r} ms; decode tick ({B} rows): host {timing['tick'][0]!r} "
              f"ms, device busy {timing['tick'][1]!r} ms", flush=True)
    return launches


def emulate_model_ranks(cfg, params, buffers, M: int, S: int, device="cuda") -> dict:
    """The model axis of M ranks emulated in one process on the first
    full-width layer of ``params`` (the xlstm family's first superblock),
    the token table and the head, in float32 on an S-token prompt: each
    rank's slices (``lm.param_specs``) run in turn through the functions
    the sharded ``lm.prefill`` calls around its collectives
    (``lm.embed_share``: its slice of the lookup;
    ``lm.prefill_attention_share``: its query and KV heads (whole GQA groups
    where M divides neither head count) through flash; ``ssm.ssm_project``
    and ``ssm_scan``: its SSM channels, ``lm.hybrid_mix``;
    ``xlstm.mlstm_up`` and ``mlstm_heads``: its mLSTM heads;
    ``xlstm.slstm_input``, ``slstm_recur`` and ``slstm_ffn``: its sLSTM
    pre-activations and FFN slices around the whole recurrence;
    ``lm.parallel_share``, ``layers.mlp_partial`` or ``moe.apply_moe`` on
    its ff slices; ``lm.head_share``'s partial scores or
    ``lm.vocab_share``'s rows of the logits), with the all-gathers and
    all-reduces replaced by concatenations and sums in rank order.  Held
    against the unsharded prefill of the cut: the lookup bit for bit, the
    logits and each rank's cache slices within LM_LOGIT_RTOL of the
    largest magnitude.  Returns {"logits", and each cache leaf}: those
    errors."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.shard import shard_tree
    from repro_torch.tree import tree_map

    layers = cfg.slstm_every if cfg.family == "xlstm" else 1
    cut = dataclasses.replace(cfg, n_layers=layers, dtype=torch.float32)
    cut_p = dict(params, blocks=tree_map(lambda t: t[:1], params["blocks"]))
    ranks = [shard_tree(cut_p, lm.param_specs(cut, M), r, M) for r in range(M)]
    nc = (cut.n_codebooks,) if cut.n_codebooks else ()
    toks = torch.from_numpy(np.random.default_rng(MESH_SEED + 1).integers(
        0, cut.vocab, (1, S, *nc))).to(device)
    errs = collections.defaultdict(float)

    def held(key, got, want):
        errs[key] = max(errs[key], _max_rel(got, want.cpu()))

    with torch.inference_mode():
        ref_cache = lm.init_cache(cut, 1, S, device=device)
        want, _ = lm.prefill(cut_p, buffers, cut, toks, ref_cache)
        x = torch.cat([lm.embed_share(rp, buffers, cut, toks) for rp in ranks], dim=-1)
        x = x.reshape(1, S, cut.d_model)
        x = (x * math.sqrt(cut.d_model) if cut.emb_scale else x).to(cut.dtype)
        check(torch.equal(x, lm.embed(cut_p, buffers, cut, toks)),
              f"{cfg.name}: the ranks' lookup slices gathered differ from the lookup")
        positions = torch.arange(S, device=device)[None]
        x = lm._add_positions(cut, x, positions)
        if cut.family == "xlstm":
            walks = [lm._xlstm_blocks(cut_p["blocks"], cut)]
            walks += [lm._xlstm_blocks(rp["blocks"], cut) for rp in ranks]
            H = cut.n_heads // M
            for (kind, at, _, norm), *rest in zip(*walks):
                qs = [p for _, _, p, _ in rest]
                hn = L.apply_norm(norm, x)
                if kind == "m":
                    ups = [xlstm_lib.mlstm_up(q, hn) for q in qs]
                    xm = torch.cat([u[0] for u in ups], dim=-1)
                    outs = [xlstm_lib.mlstm_heads(q, cut, xm, u[1]) for q, u in zip(qs, ups)]
                    for r, (_, state) in enumerate(outs):
                        for key, t in zip(("C", "n", "m"), state):
                            held(key, t, ref_cache[key][at][:, r * H:(r + 1) * H])
                    x = x + sum(o[0] for o in outs)
                else:
                    zx = torch.cat([xlstm_lib.slstm_input(q, hn) for q in qs], dim=-1)
                    h, state = xlstm_lib.slstm_recur(qs[0], cut, zx)
                    for key, t in zip(("s_c", "s_n", "s_h", "s_m"), state):
                        held(key, t, ref_cache[key][at])
                    x = x + sum(xlstm_lib.slstm_ffn(q, h) for q in qs)
        else:
            freqs = L.rope_freqs(cut, device=device)
            lp = lm.layer_params(cut_p["blocks"], 0)
            lps = [lm.layer_params(rp["blocks"], 0) for rp in ranks]
            h = L.apply_norm(lp["ln1"], x)
            attn = []
            for r, q in enumerate(lps):
                a, k, v = lm.prefill_attention_share(q, cut, h, positions, freqs, r, M)
                lo, hi = L.kv_range(cut, r, M)
                check(a.shape == x.shape and k.shape[2] == hi - lo,
                      f"a rank's attention {tuple(a.shape)}, KV heads {k.shape[2]}")
                attn.append(a)
                for key, t in (("k", k), ("v", v)):
                    held(key, t, ref_cache[key][0, :, :, lo:hi])
            if cut.parallel_block:
                x = lm.parallel_residual(lp, cut, x, sum(lm.parallel_share(q, cut, a, h)
                                                         for q, a in zip(lps, attn)))
            else:
                if cut.family == "hybrid":  # the selective projection summed inside the branch
                    proj = [ssm_lib.ssm_project(q["ssm"], cut, h) for q in lps]
                    whole = sum(p[2] for p in proj)
                    scans = [ssm_lib.ssm_scan(q["ssm"], cut, p[0], p[1], whole)
                             for q, p in zip(lps, proj)]
                    di = cut.ssm_inner // M
                    for r, (p, (_, state)) in enumerate(zip(proj, scans)):
                        held("ssm", state, ref_cache["ssm"][0, :, r * di:(r + 1) * di])
                        held("conv", p[3], ref_cache["conv"][0, ..., r * di:(r + 1) * di])
                    x = lm.hybrid_mix(lp, x, sum(attn), sum(s for s, _ in scans))
                else:
                    x = x + sum(attn)
                h2 = L.apply_norm(lp["ln2"], x)
                if cut.family == "moe":  # each rank's experts' ff slices, combined in token space
                    x = x + sum(moe_lib.apply_moe(q["moe"], cut, h2, group_size=cut.moe_group)[0]
                                for q in lps)
                else:
                    x = x + L.mlp_bias(lp["mlp"], cut,
                                       sum(L.mlp_partial(q["mlp"], cut, h2) for q in lps))
        y = L.apply_norm(cut_p["ln_f"], x)[:, -1]
        if cut.emb_method == "full":
            got = torch.cat([lm.vocab_share(rp, cut, y) for rp in ranks], dim=-1)
            got = got.reshape(want.shape)
        else:
            got = lm.head_logits(buffers, cut, sum(lm.head_share(rp, cut, y, r, M)
                                                   for r, rp in enumerate(ranks)))
        errs = {"logits": _max_rel(got, want.cpu()), **errs}
        for what, err in errs.items():
            check(err <= LM_LOGIT_RTOL["float32"], f"{cfg.name} {what}: the {M} ranks' sum vs "
                  f"the unsharded cut {err} of the largest > {LM_LOGIT_RTOL['float32']}")
    return errs


def mesh_emulated(card: str, cfg, params, buffers, device="cuda") -> dict:
    """(b) the model axis of MESH_RANKS ranks emulated in one process
    (``emulate_model_ranks``) on MESH_ARCH's first layer, token table and
    head, on a MESH_LAYER_SEQ-token prompt.  Then times flash and the
    lookup for a rank's slice and for the whole, beside their bounds and
    SDPA's or ``embedding_bag``'s time.  Returns {"flash": {...},
    "lookup": {...}} of those numbers."""
    from repro_torch.models import lm

    M, S = MESH_RANKS, MESH_LAYER_SEQ
    kvh = cfg.n_kv_heads // M
    emb = lm.make_emb(cfg)
    errs = emulate_model_ranks(cfg, params, buffers, M, S, device)
    print(f"[{card}] mesh (b) {M} model ranks emulated on {cfg.name}'s first layer, token table "
          f"and head (float32, a {S}-token prompt): each rank {cfg.n_heads // M} query and "
          f"{kvh} KV heads, d_ff {cfg.d_ff // M}, dsub {emb.dsub // M}; the lookup slices "
          f"gathered equal the lookup bit for bit; vs the unsharded 1-layer prefill, relative "
          f"to the largest magnitude: " + ", ".join(f"{k} {v!r}" for k, v in errs.items()),
          flush=True)
    out = {"flash": {}, "lookup": {}}
    for name, H, KVH in (("whole", cfg.n_heads, cfg.n_kv_heads),
                         (f"rank_of_{M}", cfg.n_heads // M, kvh)):
        out["flash"][name] = flash_timed(card, 2048, H, KVH, cfg.head_dim, device=device)
    out["lookup"] = rank_lookup_numbers(card, cfg, params, buffers, M, whole=True, device=device)
    return out


def rank_lookup_numbers(card: str, cfg, params, buffers, M: int, *, whole: bool = False,
                        rows=None, device="cuda") -> dict:
    """The lookup kernel on a rank's dsub slice of the token table (and on
    the whole table), at ``rows`` (MESH_TIMED_B) rows: held against its
    plain version bit for bit and timed, L2 flushed, beside
    ``embedding_bag`` (``lm_fwd_numbers``).  Returns {name: {B: numbers}}."""
    import numpy as np
    import torch

    from repro_torch.models import lm

    emb = lm.make_emb(cfg)
    rows = MESH_TIMED_B if rows is None else rows
    tables = params["emb"]["tables"].contiguous()
    ids = torch.from_numpy(np.random.default_rng(MESH_SEED + 3).integers(
        0, cfg.vocab, max(rows))).to(device)
    named = [("whole", tables)] if whole else []
    named.append((f"rank_of_{M}", tables[..., :emb.dsub // M].contiguous()))
    out = {}
    for name, tab in named:
        out[name] = {}
        for n in rows:
            idx = emb._rows(buffers["emb"], ids[:n]).reshape(emb.c, -1, 2)
            out[name][n] = lm_fwd_numbers(card, f"{cfg.name} {name}", idx, tab)
    return out


def flash_rank_case(card: str, H: int, KVH: int, D: int, device="cuda", S=None) -> dict:
    """The flash kernel at a model rank's heads (H, KVH, D), causal, B=1,
    S (FLASH_TIMED[-1]): held against its plain version as the flash phase
    holds it (float32 within FLASH_TOL; bfloat16 at every CTA height
    within FLASH_TOL and FLASH_ROW_TOL of each row's scale), then timed
    beside SDPA and its bound (``flash_timed``)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    S = FLASH_TIMED[-1] if S is None else S
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        q, k, v = flash_inputs(1, S, S, H, KVH, D, dtype, seed=20_000 + H, device=device)
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
        for rows in (None,) if dtype == torch.float32 else cta_rows(D):
            got = fa.flash_attention(q, k, v) if rows is None else fa._launch(q, k, v, True, rows)
            err = (got.float() - want32.to(dtype).float()).abs().max().item()
            what = f"{dn} H={H} KVH={KVH} D={D} S={S}{f' rows={rows}' if rows else ''}"
            check(err <= FLASH_TOL[dn], f"flash kernel vs plain {err} > {FLASH_TOL[dn]} at {what}")
            if rows:
                row_err = flash_row_err(got, want32)
                check(row_err <= FLASH_ROW_TOL, f"flash kernel vs plain {row_err} > "
                      f"{FLASH_ROW_TOL} of a row's scale at {what}")
            errs[dn] = max(errs.get(dn, 0.0), err)
    print(f"[{card}] flash_attention at a rank's heads H={H} KVH={KVH} D={D} S={S}: vs plain "
          f"max_abs_err {errs!r}", flush=True)
    return dict(flash_timed(card, S, H, KVH, D, device=device), max_abs_err=errs["bfloat16"],
                max_abs_err_float32=errs["float32"], S=S)


def moe_ep_emulated(card: str, cfg, params, device="cuda") -> dict:
    """(f) the data axis of MESH_EP_RANKS ranks emulated on the first MoE
    layer of ``params`` (float32): MESH_EP_ROWS rows of one moe_group of
    tokens each (unit normal), a row's groups routed by its data rank
    (``moe.dispatch``), the all-to-alls replaced by transposes in rank
    order (rank s takes every rank's slots of its E/D experts, which
    ``moe.grouped_experts`` runs, and each rank takes its slots back), held
    against the unsharded layer (``moe.apply_moe``): every routing
    decision equal, the output within LM_LOGIT_RTOL of its largest
    magnitude, and whether bit for bit.  Returns the numbers."""
    import dataclasses

    import torch

    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.shard import shard_tree
    from repro_torch.tree import tree_map

    D = MESH_EP_RANKS
    cut = dataclasses.replace(cfg, n_layers=1, dtype=torch.float32)
    stacked = tree_map(lambda t: t[:1], params["blocks"]["moe"])
    specs = lm.param_specs(cut)["blocks"]["moe"]
    p = lm.layer_params(stacked, 0)
    ranks = [lm.layer_params(shard_tree(stacked, specs, d, D, "data"), 0) for d in range(D)]
    x = torch.randn((MESH_EP_ROWS, cut.moe_group, cut.d_model),
                    generator=torch.Generator(device=device).manual_seed(MESH_SEED + 4),
                    device=device)
    rows = MESH_EP_ROWS // D
    moe_lib.TRACE = []
    try:
        with torch.inference_mode():
            want, _ = moe_lib.apply_moe(p, cut, x, group_size=cut.moe_group)
            routed = [moe_lib.dispatch(p, cut, x[d * rows:(d + 1) * rows], impl="einsum",
                                       group_size=cut.moe_group) for d in range(D)]
            G, E, C, _ = routed[0].slots.shape
            El = E // D
            at = [torch.cat([r.slots[:, s * El:(s + 1) * El] for r in routed]) for s in range(D)]
            out = [moe_lib.grouped_experts(ranks[s], at[s]) for s in range(D)]
            got = torch.cat([routed[d].combine(torch.cat([out[s][d * G:(d + 1) * G]
                                                          for s in range(D)], dim=1))
                             for d in range(D)]).reshape(x.shape)
            whole, parts = moe_lib.TRACE[0], moe_lib.TRACE[1:]
            same_routes = all(torch.equal(torch.cat([t[i] for t in parts]), whole[i])
                              for i in (1, 2))
    finally:
        moe_lib.TRACE = None
    err = _max_rel(got, want.cpu())
    bitwise = bool(torch.equal(got, want))
    check(same_routes, "the data ranks' routing differs from the unsharded layer's")
    check(err <= LM_LOGIT_RTOL["float32"], f"{cfg.name} expert parallel emulated: {err} of "
          f"the largest > {LM_LOGIT_RTOL['float32']}")
    print(f"[{card}] mesh (f) {D} data ranks emulated on {cfg.name}'s first MoE layer (float32, "
          f"{MESH_EP_ROWS} rows of {cut.moe_group} tokens, {El} experts a rank, {G} group(s) of "
          f"{cut.moe_group} a rank, capacity {C}): every routing decision equal; vs the "
          f"unsharded layer {err!r} of the largest, "
          f"{'bit for bit' if bitwise else 'not bit for bit'}", flush=True)
    return dict(max_rel=err, bitwise=bitwise, experts_a_rank=El, capacity=C)


def mesh_family(card: str, mesh, arch: str, device="cuda") -> tuple[dict, dict]:
    """(e) and (f) for one of MESH_FAMILIES at full width: (e)
    ``mesh_serve`` on the (1, 1) mesh; (f) MESH_RANKS model ranks emulated
    on its first layer (``emulate_model_ranks``), flash at a rank's heads
    and the lookup at a rank's dsub slice (``flash_rank_case``,
    ``rank_lookup_numbers``), and for the moe family its data axis
    (``moe_ep_emulated``).  Returns (the serve launches, the numbers)."""
    import torch

    from repro_torch import configs
    from repro_torch.models import lm

    full = configs.get(arch)
    cfg = configs.get(arch, n_layers=MESH_FAMILY_LAYERS.get(arch, full.n_layers))
    t0 = time.perf_counter()
    params, buffers = lm.init(cfg, torch.Generator(device=device).manual_seed(MESH_SEED),
                              device=device)
    torch.cuda.synchronize()
    n = _n_params(params)
    print(f"[{card}] mesh (e) init: {cfg.name} {cfg.n_layers} of {full.n_layers} layers, "
          f"d={cfg.d_model} {cfg.n_heads}H/{cfg.n_kv_heads}KV d_ff={cfg.d_ff}: {n} params, "
          f"{n * 4 / 2**30:.2f} GiB in {time.perf_counter() - t0:.3f} s", flush=True)
    launches = mesh_serve(card, cfg, mesh, params, buffers, device, part="(e)",
                          ticks=MESH_FAMILY_TICKS)
    M = MESH_RANKS
    errs = emulate_model_ranks(cfg, params, buffers, M, MESH_LAYER_SEQ, device)
    kvh = cfg.n_kv_heads // M if cfg.n_kv_heads % M == 0 else cfg.n_kv_heads
    print(f"[{card}] mesh (f) {M} model ranks emulated on {cfg.name}'s first layer, token table "
          f"and head (float32, a {MESH_LAYER_SEQ}-token prompt): each rank {cfg.n_heads // M} "
          f"query and {kvh} KV heads, d_ff {cfg.d_ff // M}"
          + (f" of each of {cfg.n_experts} experts" if cfg.n_experts else "")
          + ("; the full table's d and head's rows" if cfg.emb_method == "full"
             else f"; dsub {lm.make_emb(cfg).dsub // M}")
          + "; the lookup gathered bit for bit; vs the unsharded 1-layer prefill, relative to "
          "the largest magnitude: " + ", ".join(f"{k} {v!r}" for k, v in errs.items()),
          flush=True)
    numbers = {"emulated": errs,
               "flash": flash_rank_case(card, cfg.n_heads // M, kvh, cfg.head_dim, device)}
    if cfg.emb_method == "cce":  # a prefill's rows: the tick's were timed at command-r's slice
        numbers["lookup"] = rank_lookup_numbers(card, cfg, params, buffers, M, rows=(2048,),
                                                device=device)[f"rank_of_{M}"]
    if cfg.family == "moe":
        numbers["ep"] = moe_ep_emulated(card, cfg, params, device)
    return launches, numbers


def mesh_train(card: str, mesh, device="cuda", *, arch=MESH_ARCH, layers=MESH_TRAIN_LAYERS,
               seq=MESH_TRAIN_SEQ, part="(c)") -> dict:
    """(c), and (h) for the hybrid and xlstm families:
    ``launch.steps.build_train_step`` on the (1, 1) mesh: ``arch``
    (MESH_ARCH) at full width cut to ``layers`` (MESH_TRAIN_LAYERS) layers
    in float32, one micro-batch of MESH_TRAIN_BATCH x ``seq``
    (MESH_TRAIN_SEQ) tokens, MESH_TRAIN_STEPS steps, held bit for bit
    against the unsharded ``make_train_step`` (the same adamw, schedule
    and clip): every loss, gnorm, param and moment.  Prints the peak.
    Returns the sharded steps' launches."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import shapes, steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import loop

    cfg = configs.get(arch, n_layers=layers, dtype=torch.float32,
                      train_microbatch=MESH_TRAIN_BATCH)
    shape = shapes.Shape("mesh_train", seq, MESH_TRAIN_BATCH, "train")
    step, (_, batch_struct), specs = steps.build_train_step(cfg, mesh, shape=shape)
    check(batch_struct["tokens"][0] == (1, MESH_TRAIN_BATCH, seq),
          f"one micro-batch: {batch_struct}")
    t0 = time.perf_counter()
    params, buffers = lm.init(cfg, torch.Generator(device=device).manual_seed(MESH_SEED),
                              device=device)
    opt = adamw(weight_decay=0.1)
    ref = loop.init_state(_clone_tree(params), opt, _clone_tree(buffers))
    state = steps.shard_state(loop.init_state(params, opt, buffers), specs, mesh)
    torch.cuda.synchronize()
    print(f"[{card}] mesh {part} {cfg.name} cut to {cfg.n_layers} layers, float32: "
          f"{_n_params(params)} params, two adamw states in {time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    toks = torch.from_numpy(np.random.default_rng(MESH_SEED + 2).integers(
        0, cfg.vocab, (1, MESH_TRAIN_BATCH, seq))).to(device)
    ref_step = loop.make_train_step(lambda p, b, mb: lm.next_token_loss(p, b, cfg, mb), opt,
                                    cosine_schedule(3e-4, 100, 10_000), accum=1, clip_norm=1.0)
    base = reset_peak()
    ops.LAUNCHES.clear()
    got, host = [], []
    for _ in range(MESH_TRAIN_STEPS):
        t = time.perf_counter()
        state, m = step(state, {"tokens": toks})
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        got.append((m["loss"].item(), m["gnorm"].item()))
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = []
    for _ in range(MESH_TRAIN_STEPS):
        ref, m = ref_step(ref, {"tokens": toks})
        want.append((m["loss"].item(), m["gnorm"].item()))
    check(launches.get("cce_lookup_fwd") == MESH_TRAIN_STEPS
          and launches.get("cce_lookup_bwd") == MESH_TRAIN_STEPS,
          f"mesh train launches {launches}: want {MESH_TRAIN_STEPS} of each lookup kernel")
    check(got == want, f"build_train_step's (loss, gnorm) {got} != the unsharded step's {want}")
    check(_all_equal(state.params, ref.params) and _all_equal(state.opt, ref.opt),
          "build_train_step's params or moments differ from the unsharded step's")
    print(f"[{card}] mesh {part} {cfg.name} build_train_step on the (1, 1) mesh, "
          f"{MESH_TRAIN_STEPS} steps of {MESH_TRAIN_BATCH} x {seq} tokens: (loss, gnorm) {got!r}, host "
          f"{host!r} ms, peak {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} over the "
          f"{base / 1e9:.2f} GB of both states at the reset); launches {launches}; every loss, "
          f"gnorm, param and adamw moment equal to the unsharded step's bit for bit", flush=True)
    return launches


def mesh_moe_train(card: str, mesh, device="cuda") -> dict:
    """(g) ``launch.steps.build_train_step`` on the (1, 1) mesh for
    phi3.5-moe at full width cut to MESH_MOE_TRAIN_LAYERS layers in
    float32: one micro-batch of MESH_TRAIN_BATCH x MESH_TRAIN_SEQ tokens
    (one moe_group), MESH_TRAIN_STEPS steps, held bit for bit against the
    unsharded ``make_train_step`` from the same init (every loss, gnorm,
    param and adamw moment).  The two runs take turns on the card, the
    sharded run's params kept there and its moments in pinned host
    memory meanwhile: both states and the gradients would not fit 80 GB.
    Returns the sharded steps' launches."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import shapes, steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import loop
    from repro_torch.tree import tree_leaves, tree_map

    cfg = configs.get(MOE_ARCH, n_layers=MESH_MOE_TRAIN_LAYERS, dtype=torch.float32,
                      train_microbatch=MESH_TRAIN_BATCH)
    shape = shapes.Shape("mesh_moe_train", MESH_TRAIN_SEQ, MESH_TRAIN_BATCH, "train")
    step, (_, batch_struct), specs = steps.build_train_step(cfg, mesh, shape=shape)
    check(batch_struct["tokens"][0] == (1, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ),
          f"one micro-batch: {batch_struct}")
    opt = adamw(weight_decay=0.1)
    toks = {"tokens": torch.from_numpy(np.random.default_rng(MESH_SEED + 5).integers(
        0, cfg.vocab, (1, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ))).to(device)}

    def init():
        params, buffers = lm.init(cfg, torch.Generator(device=device).manual_seed(MESH_SEED),
                                  device=device)
        return loop.init_state(params, opt, buffers)

    state = steps.shard_state(init(), specs, mesh)
    base = reset_peak()
    print(f"[{card}] mesh (g) {cfg.name} cut to {cfg.n_layers} layers, float32: "
          f"{_n_params(state.params)} params, {base / 1e9:.2f} GB with the adamw moments",
          flush=True)
    ops.LAUNCHES.clear()
    got, host, aux = [], [], []
    for _ in range(MESH_TRAIN_STEPS):
        t = time.perf_counter()
        state, m = step(state, toks)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        got.append((m["loss"].item(), m["gnorm"].item()))
        aux.append(m["aux"].item())
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()

    def to_host(x):
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
        return out.copy_(x, non_blocking=True)

    kept = (state.params, tree_map(to_host, state.opt))
    torch.cuda.synchronize()
    keep_s = time.perf_counter() - t
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    ref = init()
    ref_step = loop.make_train_step(lambda p, b, mb: lm.next_token_loss(p, b, cfg, mb), opt,
                                    cosine_schedule(3e-4, 100, 10_000), accum=1, clip_norm=1.0)
    want = []
    for _ in range(MESH_TRAIN_STEPS):
        ref, m = ref_step(ref, toks)
        want.append((m["loss"].item(), m["gnorm"].item()))
    check(launches.get("cce_lookup_fwd") == MESH_TRAIN_STEPS
          and launches.get("cce_lookup_bwd") == MESH_TRAIN_STEPS,
          f"mesh moe train launches {launches}: want {MESH_TRAIN_STEPS} of each lookup kernel")
    check(got == want, f"build_train_step's (loss, gnorm) {got} != the unsharded step's {want}")
    check(all(math.isfinite(a) for a in aux), f"non-finite aux {aux}")
    check(all(torch.equal(a.to(device), b) for a, b in
              zip(tree_leaves(kept), tree_leaves((ref.params, ref.opt)))),
          "build_train_step's moe params or moments differ from the unsharded step's")
    print(f"[{card}] mesh (g) build_train_step on the (1, 1) mesh, {cfg.name} {cfg.n_layers} "
          f"layers, {MESH_TRAIN_STEPS} steps of {MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ} tokens: "
          f"(loss, gnorm) {got!r}, aux {aux!r}, host {host!r} ms, peak {peak / 1e9:.2f} GB "
          f"({(peak - base) / 1e9:.2f} over the {base / 1e9:.2f} GB of params and adamw moments "
          f"at the reset); launches {launches}; every loss, gnorm, param and adamw moment equal "
          f"to the unsharded step's bit for bit (the sharded moments kept in pinned host memory "
          f"meanwhile, {keep_s:.3f} s)", flush=True)
    return launches


def rank_bwd_numbers(card: str, cfg, buffers, M: int, B: int = MESH_RANK_ROWS[0],
                     device="cuda") -> dict:
    """The lookup backward at one model rank's slice of ``cfg``'s token
    table (c, T, k, dsub/M), float32, on B rows of uniform tokens:
    ``bwd_check`` (bit for bit against its plain version, timed beside
    its bound and ``index_add_``).  Returns its numbers."""
    import numpy as np
    import torch

    from repro_torch.models import lm

    emb = lm.make_emb(cfg)
    ids = torch.from_numpy(np.random.default_rng(MESH_SEED + 7).integers(
        0, cfg.vocab, B)).to(device)
    idx = emb._rows(buffers["emb"], ids).reshape(emb.c, -1, 2)
    dout = torch.randn((B, emb.c, emb.dsub // M), device=device,
                       generator=torch.Generator(device=device).manual_seed(MESH_SEED + 8))
    err, nums = bwd_check(card, f"{cfg.name} rank_of_{M} c={emb.c} k={emb.k} "
                          f"dsub={emb.dsub // M} B={B}", idx, dout, emb.k, plain_busy=False)
    return dict(nums, max_abs_err=err, B=B, dsub=emb.dsub // M)


def mesh_recurrent(card: str, mesh, arch: str, device="cuda") -> tuple[dict, dict]:
    """(h) for the hybrid and xlstm families at full width: ``mesh_serve``
    on the (1, 1) mesh cut to MESH_RECURRENT[arch] layers;
    ``mesh_train`` on a float32 cut (MESH_RECURRENT_TRAIN); the model
    ranks of MESH_RECURRENT_RANKS emulated (``emulate_model_ranks``: hymba
    at 2 and 4 ranks, whose 5 KV groups split 3 / 2 and 2 / 1 / 1 / 1); the
    kernels at a rank's shapes: flash at hymba's rank heads at
    MESH_RANK_FLASH_S, the lookup at a rank's dsub slice, and the lookup
    backward at one of xlstm's 4 ranks.  Returns ({path: launches},
    numbers)."""
    import torch

    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    full = configs.get(arch)
    cfg = configs.get(arch, n_layers=MESH_RECURRENT[arch])
    fam = full.family
    t0 = time.perf_counter()
    params, buffers = lm.init(cfg, torch.Generator(device=device).manual_seed(MESH_SEED),
                              device=device)
    torch.cuda.synchronize()
    n = _n_params(params)
    print(f"[{card}] mesh (h) init: {cfg.name} {cfg.n_layers} of {full.n_layers} layers, "
          f"d={cfg.d_model} {cfg.n_heads}H/{cfg.n_kv_heads}KV: {n} params, "
          f"{n * 4 / 2**30:.2f} GiB in {time.perf_counter() - t0:.3f} s", flush=True)
    launches = {f"mesh_serve_{fam}": mesh_serve(
        card, cfg, mesh, params, buffers, device, part="(h)", ticks=MESH_RECURRENT_TICKS,
        timing_iters=(1, 5))}
    numbers = {"emulated": {}, "flash": {}, "lookup": {}}
    for M in MESH_RECURRENT_RANKS[arch]:
        errs = emulate_model_ranks(cfg, params, buffers, M, MESH_RECURRENT_SEQ, device)
        numbers["emulated"][M] = errs
        groups = "" if fam == "xlstm" else f"KV heads {L.kv_split(full, M)}, "
        print(f"[{card}] mesh (h) {M} model ranks emulated on {cfg.name}'s first "
              f"{'superblock' if fam == 'xlstm' else 'layer'}, token table and head (float32, a "
              f"{MESH_RECURRENT_SEQ}-token prompt): {groups}dsub {lm.make_emb(cfg).dsub // M}; the "
              f"lookup gathered bit for bit; vs the unsharded cut, relative to the largest "
              f"magnitude: " + ", ".join(f"{k} {v!r}" for k, v in errs.items()), flush=True)
        numbers["lookup"][M] = rank_lookup_numbers(
            card, cfg, params, buffers, M, rows=MESH_RANK_ROWS, device=device)[f"rank_of_{M}"]
        if fam == "hybrid":
            G = cfg.n_heads // cfg.n_kv_heads
            for kvh in sorted(set(L.kv_split(full, M)), reverse=True):
                if f"{G * kvh}/{kvh}" not in numbers["flash"]:
                    numbers["flash"][f"{G * kvh}/{kvh}"] = flash_rank_case(
                        card, G * kvh, kvh, cfg.head_dim, device, S=MESH_RANK_FLASH_S)
    if fam == "xlstm":
        numbers["bwd"] = rank_bwd_numbers(card, cfg, buffers, MESH_RECURRENT_RANKS[arch][-1],
                                          device=device)
    del params, buffers
    gc.collect()
    torch.cuda.empty_cache()
    layers, seq = MESH_RECURRENT_TRAIN[arch]
    launches[f"mesh_train_{fam}"] = mesh_train(card, mesh, device, arch=arch, layers=layers,
                                               seq=seq, part="(h)")
    return launches, numbers


def mesh_phase(card: str, device="cuda"):
    """The (data, model) mesh on the card, a world of one NCCL rank (one
    card), and the model and data axes emulated in one process: (a)
    ``mesh_serve`` at MESH_ARCH's full width cut to MESH_SERVE_LAYERS
    layers, and its 2-layer cut through ``lm_cut_check`` against CPU
    copies; (b) ``mesh_emulated``; (c) ``mesh_train``.  (d), DLRM through
    the 2-D builder at (1, 1), is ``shard_train_phase``: its trainer is
    that builder.  (e) and (f), ``mesh_family`` for each of MESH_FAMILIES;
    (g) ``mesh_moe_train``; (h) ``mesh_recurrent`` for each of
    MESH_RECURRENT.  Returns ({path: launches}, (b)'s numbers, {arch:
    (f)'s numbers}, {arch: (h)'s numbers})."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import lm

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    mesh = init_mesh(1, 1, "cuda", rank=0, init_method=f"file://{tmp / 'store'}")
    try:
        check(dist.get_backend(mesh.world) == "nccl", "the mesh's world is not NCCL")
        full = configs.get(MESH_ARCH)
        cfg = configs.get(MESH_ARCH, n_layers=MESH_SERVE_LAYERS)
        base = reset_peak()
        t0 = time.perf_counter()
        params, buffers = lm.init(cfg, torch.Generator(device=device).manual_seed(MESH_SEED),
                                  device=device)
        torch.cuda.synchronize()
        n = _n_params(params)
        print(f"[{card}] mesh init: {cfg.name} {cfg.n_layers} of {full.n_layers} layers, "
              f"d={cfg.d_model} {cfg.n_heads}H/{cfg.n_kv_heads}KV d_ff={cfg.d_ff} "
              f"({full.n_params()} params at full depth): {n} params, {n * 4 / 2**30:.2f} GiB "
              f"in {time.perf_counter() - t0:.3f} s", flush=True)
        launches = {"mesh_serve": mesh_serve(card, cfg, mesh, params, buffers, device)}
        cut = lm_cut_check(card, cfg.name, cfg, params, buffers,
                           list(range(1, MESH_CUT_PROMPT + 1)), MESH_CUT_DECODE, device)
        emulated = mesh_emulated(card, cfg, params, buffers, device)
        peak = torch.cuda.max_memory_allocated()
        print(f"[{card}] mesh (a)-(b) peak {(peak - base) / 1e9:.2f} GB over the "
              f"{base / 1e9:.2f} GB allocated before ({peak / 1e9:.2f} GB raw); the cut's worst "
              f"{cut!r}", flush=True)
        del params, buffers
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        launches["mesh_train"] = mesh_train(card, mesh, device)
        seconds = {"(a)-(c)": time.perf_counter() - t0}
        families = {}
        for arch in MESH_FAMILIES:
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            served, families[arch] = mesh_family(card, mesh, arch, device)
            launches[f"mesh_serve_{configs.get(arch).family}"] = served
            seconds[f"(e)-(f) {arch}"] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        launches["mesh_train_moe"] = mesh_moe_train(card, mesh, device)
        seconds["(g)"] = time.perf_counter() - t
        recurrent = {}
        for arch in MESH_RECURRENT:
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            base = reset_peak()
            served, recurrent[arch] = mesh_recurrent(card, mesh, arch, device)
            launches.update(served)
            peak = torch.cuda.max_memory_allocated()
            seconds[f"(h) {arch}"] = time.perf_counter() - t
            print(f"[{card}] mesh (h) {arch} peak {(peak - base) / 1e9:.2f} GB over the "
                  f"{base / 1e9:.2f} GB allocated before", flush=True)
        print(f"[{card}] mesh parts, s: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()),
              flush=True)
        return launches, emulated, families, recurrent
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


PHASES = ("lookup", "bwd", "kmeans", "train", "shard_train", "mesh", "loop", "serve", "methods",
          "flash", "lm_serve", "hybrid_serve", "vlm_serve", "xlstm_serve", "moe_serve",
          "audio_serve", "lm_train", "xlstm_train")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (a subset prints no result line)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    check(set(phases) <= set(PHASES), f"unknown phase in {phases}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.configs.dlrm_criteo import CONFIG
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t_run = time.perf_counter()
    libs = sorted({pathlib.Path(src).stem for src, _ in KERNELS.values()})
    t0 = time.perf_counter()
    build.build(*libs)
    for lib in libs:
        build.library(lib)
    print(f"[{card}] build: {', '.join(f'{n}.cu' for n in libs)} in parallel, "
          f"{time.perf_counter() - t0:.3f} s")
    for lib in libs:
        for line in build.BUILD_LOGS.get(lib, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}: {line.strip()}")

    def phase(name, fn, *a):
        if name not in phases:
            return None
        # free what earlier phases left in reference cycles (tens of GB of them
        # can still be allocated when a phase begins)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out = fn(*a)
        print(f"[{card}] phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    fwd = phase("lookup", kernel_phase, card, CONFIG.collection)
    bwd = phase("bwd", bwd_kernel_phase, card, CONFIG)
    assign = phase("kmeans", kmeans_phase, card, CONFIG)
    launches = phase("train", train_phase, card, CONFIG) or {}
    shard = phase("shard_train", shard_train_phase, card, CONFIG)
    if shard is not None:
        launches.update(shard[0])
    mesh = phase("mesh", mesh_phase, card)
    if mesh is not None:
        launches.update(mesh[0])
    launches.update(phase("loop", loop_phase, card, CONFIG) or {})
    serve = phase("serve", serve_phase, card, CONFIG, SERVE_BATCHES)
    if serve is not None:
        launches["serve"] = {"cce_lookup_fwd": serve}
    methods = phase("methods", methods_phase, card, CONFIG)
    if methods is not None:
        launches["methods"] = methods[0]
    flash = phase("flash", flash_phase, card)
    lm_out = phase("lm_serve", lm_serve_phase, card, configs.get(LM_ARCH))
    if lm_out is not None:
        launches["lm_serve"] = lm_out[0]
    hybrid = phase("hybrid_serve", hybrid_serve_phase, card, configs.get(HYBRID_ARCH))
    if hybrid is not None:
        launches["hybrid_serve"] = hybrid[0]
    vlm = phase("vlm_serve", vlm_serve_phase, card, configs.get(VLM_ARCH))
    if vlm is not None:
        launches["vlm_serve"] = vlm[0]
    xlstm = phase("xlstm_serve", xlstm_serve_phase, card, configs.get(XLSTM_ARCH))
    if xlstm is not None:
        launches["xlstm_serve"] = xlstm[0]
    moe = phase("moe_serve", moe_serve_phase, card, configs.get(MOE_ARCH, n_layers=MOE_LAYERS))
    if moe is not None:
        launches["moe_serve"] = moe[0]
    audio = phase("audio_serve", audio_serve_phase, card, configs.get(AUDIO_ARCH))
    if audio is not None:
        launches["audio_serve"], launches["audio_train"] = audio[0], audio[1]
    lm_train = phase("lm_train", lm_train_phase, card, configs.get(LM_ARCH))
    if lm_train is not None:
        launches.update(lm_train[0])
    xlstm_train = phase("xlstm_train", xlstm_train_phase, card,
                        configs.get(XLSTM_ARCH, n_layers=XLSTM_TRAIN_LAYERS))
    if xlstm_train is not None:
        launches.update(xlstm_train[0])
    if set(phases) != set(PHASES):
        print(f"chip_smoke: phases {phases} passed in {time.perf_counter() - t_run:.1f} s "
              f"(a partial run: no result line)")
        return 0
    (fwd_err, fwd_at), (bwd_err, bwd_at), (assign_err, assign_at) = fwd, bwd, assign
    (flash_err, flash_at, flash_hymba_at, flash_paligemma_at, flash_paligemma_err, flash_moe_at,
     flash_musicgen_at) = flash
    lm_lookup, hybrid_lookup, vlm_lookup, xlstm_lookup, moe_lookup = (
        lm_out[1], hybrid[1], vlm[1], xlstm[1], moe[1])
    _, methods_err, methods_at, _ = methods
    _, lm_fwd_at, lm_bwd_err, lm_bwd_at, lm_assign_err, lm_assign_at, _ = lm_train
    _, xl_fwd_at, xl_bwd_err, xl_bwd_at, xl_assign_err, xl_assign_at, _ = xlstm_train

    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in launches.items()}

    def entry(name, main_paths, err, at, **extra):
        src, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(launches[p].get(name, 0) for p in main_paths),
                "launches_by_path": by_path(name), "max_abs_err": err, **at, **extra}

    shard_at = shard[1]
    mesh_at, mesh_families, mesh_rec = mesh[1], mesh[2], mesh[3]
    steps = ("train", "train_after_transition", "shard_train", "loop", "methods", "lm_train",
             "xlstm_train", "audio_train", "mesh_train", "mesh_train_moe", "mesh_train_hybrid",
             "mesh_train_xlstm")
    rank_lookups = {a: f["lookup"] for a, f in mesh_families.items() if "lookup" in f}
    rank_lookups |= {f"{a} at {M} model ranks": by_rows for a, r in mesh_rec.items()
                     for M, by_rows in r["lookup"].items()}
    hymba_flash = mesh_rec["hymba-1.5b"]["flash"]
    rank_bwd = mesh_rec["xlstm-1.3b"]["bwd"]
    S = FLASH_TIMED[-1]
    kernels = [
        entry("cce_lookup_fwd",
              steps + ("lm_serve", "hybrid_serve", "vlm_serve", "xlstm_serve", "moe_serve",
                       "mesh_serve", "mesh_serve_vlm", "mesh_serve_moe", "mesh_serve_hybrid",
                       "mesh_serve_xlstm"),
              max(fwd_err, methods_err, lm_fwd_at["max_abs_err"], xl_fwd_at["max_abs_err"],
                  shard_at["max_abs_err"],
                  *(v["max_abs_err"] for v in (*hybrid_lookup.values(), *vlm_lookup.values(),
                                                *xlstm_lookup.values(), *moe_lookup.values(),
                                                *(n for r in rank_lookups.values()
                                                  for n in r.values())))),
              fwd_at[TRAIN_BATCH], batch=TRAIN_BATCH, at_serve_batch=fwd_at[SERVE_BATCH],
              at_lm_shape=lm_lookup, at_lm_train_shape=lm_fwd_at, at_hymba_shape=hybrid_lookup,
              at_paligemma_shape=vlm_lookup, at_xlstm_shape=xlstm_lookup,
              at_xlstm_train_shape=xl_fwd_at, at_phi3_5_moe_shape=moe_lookup,
              at_shard_shape=shard_at["fwd"], at_command_r_shape=mesh_at["lookup"],
              at_mesh_rank_shapes=rank_lookups,
              **{f"at_{m}_shape": methods_at[m]["fwd"] for m in METHOD_KERNEL_SHAPES}),
        entry("cce_lookup_bwd", steps,
              max(bwd_err, methods_err, lm_bwd_err, xl_bwd_err, shard_at["max_abs_err"],
                  rank_bwd["max_abs_err"]), bwd_at,
              batch=TRAIN_BATCH, at_lm_train_shape=lm_bwd_at, at_xlstm_train_shape=xl_bwd_at,
              at_shard_shape=shard_at["bwd"], at_xlstm_rank_of_4_shape=rank_bwd,
              **{f"at_{m}_shape": methods_at[m]["bwd"] for m in METHOD_KERNEL_SHAPES}),
        entry("kmeans_assign",
              ("transition", "shard_train", "loop", "methods", "lm_train", "xlstm_train",
               "audio_train"),
              max(assign_err, lm_assign_err, xl_assign_err), assign_at,
              at_lm_table_shape=lm_assign_at, at_xlstm_table_shape=xl_assign_at),
        entry("flash_attention",
              ("lm_serve", "hybrid_serve", "vlm_serve", "moe_serve", "audio_serve", "mesh_serve",
               "mesh_serve_vlm", "mesh_serve_audio", "mesh_serve_moe", "mesh_serve_hybrid"),
              max(flash_err["bfloat16"], *(f["flash"]["max_abs_err"]
                                           for f in mesh_families.values()),
                  *(f["max_abs_err"] for f in hymba_flash.values())),
              flash_at[S],
              max_abs_err_float32=flash_err["float32"],
              shape=dict(B=1, S=S, H=FLASH_HEADS[0][0], KVH=FLASH_HEADS[0][1], D=FLASH_DIMS[-1],
                         dtype="bfloat16", causal=True),
              library="scaled_dot_product_attention",
              at_other_lengths={s: flash_at[s] for s in FLASH_TIMED[:-1]},
              at_hymba_shape=dict(shape=dict(B=1, H=FLASH_HEADS[-1][0], KVH=FLASH_HEADS[-1][1],
                                             D=FLASH_DIMS[0], dtype="bfloat16", causal=True),
                                  by_length=flash_hymba_at),
              at_paligemma_shape=dict(
                  shape=dict(B=1, H=FLASH_PALIGEMMA[0], KVH=FLASH_PALIGEMMA[1],
                             D=FLASH_PALIGEMMA[2], dtype="bfloat16", causal=True),
                  max_abs_err=flash_paligemma_err["bfloat16"],
                  max_abs_err_float32=flash_paligemma_err["float32"],
                  by_length=flash_paligemma_at),
              at_phi3_5_moe_shape=dict(
                  shape=dict(B=1, H=FLASH_MOE[0], KVH=FLASH_MOE[1], D=FLASH_MOE[2],
                             dtype="bfloat16", causal=True),
                  by_length=flash_moe_at),
              at_musicgen_medium_shape=dict(
                  shape=dict(B=1, H=FLASH_MUSICGEN[0], KVH=FLASH_MUSICGEN[1],
                             D=FLASH_MUSICGEN[2], dtype="bfloat16", causal=True),
                  by_length=flash_musicgen_at),
              at_command_r_shape=dict(S=2048, dtype="bfloat16", causal=True,
                                      **mesh_at["flash"]),
              at_mesh_rank_shapes={a: dict(dtype="bfloat16", causal=True, **f["flash"])
                                   for a, f in mesh_families.items()},
              at_hymba_rank_shapes={f"H/KVH {k} D=64": dict(dtype="bfloat16", causal=True, **f)
                                    for k, f in hymba_flash.items()}),
    ]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_run:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
