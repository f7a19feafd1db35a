"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``); TF32 off for convs
   and matmuls, so float32 means float32;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together), with each kernel's
   registers and spills from ``ptxas`` and the count of tensor-core MMA
   instructions (HMMA) in the flash kernels' SASS (``cuobjdump``);
3. each kernel against its plain PyTorch version on the card over the
   shapes of its sweep and its main paths' shapes: the int8 link kernel and
   the wire format's quantize/dequantize pair bit for bit (NaN positions
   included; widths that reach both paths of ``csrc/quant_int8.cu``, all
   four dtype pairs, misaligned views; pixtral's split-LM link (2048,
   5120) among them), the int8 launch plans against their Python mirror
   with a ``[launch]`` line at both link shapes and the ``[hetero]``
   buckets' (the vector path, one wave at (12,544, 32)) and at pixtral's,
   the flash attention kernel within
   the reference's own tolerances (f32 2e-5, bf16 3e-2), a case with
   fully masked rows (finite everywhere, the rows that see a key equal),
   and its gradient (kernel forward + closed-form backward) against
   autograd through the plain version; the
   WKV scan kernel within the reference's atol/rtol 1e-4 at head sizes 16
   to 256, its final state S_T too; the WKV backward kernel's five
   gradients (with a cotangent of S_T, with w holding exact zeros, and at T
   on the edges of its 4-step sub-segments and 16-step segments) against
   autograd of the plain loop, and at the rwkv6-7b shape against its plain
   closed form, within 1e-4, two calls there giving the same bits; both
   WKV kernels from a carried state S_0 (the decode path's T = 1 and T
   around the sub-segments and segments, head sizes 16 to 256, and the
   rwkv6-7b decode shape (4, 64, 1, 64)): y and S_T within 1e-4 of the
   plain loop from S_0, the first checkpoint S_0 bit for bit, and the six
   gradients, dS_0 from the backward kernel included, within 1e-4 of
   autograd of that loop;
4. each kernel's time at its main paths' shapes, beside its plain
   version's time, its bound and, where one PyTorch call computes the same
   function, that call's time; the memory-bound int8 kernels are timed
   with the L2 cold (inputs rotated through 256 MiB), as their bytes bound
   assumes, each beside a PyTorch copy of the same bytes timed the same
   way (the floor a streaming kernel reaches); the flash kernel's bound
   is its 3xTF32 tensor-core work, and it is timed in bf16 beside SDPA
   too (informational); the WKV backward's
   launch (blocks, threads, shared bytes, resident blocks a SM) is printed;
   the WKV kernel at the decode shape from S_0 in a CUDA graph, L2-resident
   and L2 cold, beside its bytes bound (S_0 in, S_T out) and its plain
   version;
5. the CNN path: ``sl/scan`` (Algorithm 3) on MobileNetV2 at 224x224,
   4 clients, batch 16, 2 local steps, 2 rounds, int8 link on the fused
   kernel, UAV mission; with the kernel's launch count over exactly that
   run, one more round under the profiler (device busy share and the
   kernels that take the device's time), and a tinycnn run on the card held
   against the same run on the CPU;
6. ``fl/scan`` on the same spec for one round (and one profiled): SL's
   client energy per round must be below FL's; then the paper's experiment
   (``[paper]``): the link kernel at the (rows, D) of the paper's cuts that
   no other phase runs (10 shapes, D 24 to 832), its launch plan from the
   library equal to the Python copy's and its result bit-equal to the
   plain version, and 4 of them timed L2 cold against their bytes bound;
   ``core.paper_train.paper_spec`` of ResNet-18, GoogLeNet and MobileNetV2
   under FL, SL_75_25, SL_40_60, SL_25_75 and SL_15_85 (15 cases: 224x224,
   4 clients, batch 16, 2 local steps, 2 rounds, 12 classes, the port's
   ``SyntheticPestImages``, int8 link on the fused kernel), each case's
   cut and smashed shape, rounds, held-out metrics, energy sums and int8
   launches (16 on each SL case, 0 on each FL case), one profiled
   SL_25_75 round of ResNet-18 and of GoogLeNet, every setting's client
   energy against FL's in the form of the paper's Table III beside its
   "up to 86%" headline, and ResNet-18 SL_15_85 and GoogLeNet SL_40_60 at
   32x32 on the card (cuDNN's deterministic algorithms) held against the
   CPU;
7. the split-LM path: SmolLM-135M at full width (30 layers, d 576,
   vocab 49,152), sequences of 1024 tokens, batch 8, 4 clients, cut 8/30,
   int8 link on the fused kernel, attention on the flash kernel, 2 rounds;
   with both kernels' launch counts over exactly that run, the "pallas"
   plan's FLOP bill against the "ref" plan's, one profiled round, and a
   reduced SmolLM on the card held against the same run on the CPU;
8. the fleet engines (``client_axis="vmap"``): the ``vmap`` rules of the
   int8 boundary (bit-equal to the plain version client by client, one
   launch for 4 clients) and of flash attention (within 2e-5, one launch;
   its gradient within 2e-4, by ``vmap(grad)`` and by the engines' form,
   a vmapped forward and one autograd backward), all at the vmap paths'
   shapes, and both kernels timed there (int8 (50,176, 32) and
   (16,384, 576) L2 cold, flash (16, 9, 1024, 64)); ``sl/vmap`` (parallel
   SL, one server update a step on the
   clients' mean gradient) on the MobileNetV2 spec of 5 with dropout 0.25
   for 2 rounds, with its int8 launches (one a local step) and a profiled
   round, and a tinycnn ``sl/vmap`` run with dropout on the card held
   against the CPU; ``fl/vmap`` on the same spec for one round (SL's
   client energy below FL's on the same clients); ``sl/vmap`` on the
   SmolLM spec of 7 (batch 8; its server loss over chunks of tokens)
   for 2 rounds, with its flash and int8 launches, its
   peak memory, a profiled round, and a reduced SmolLM ``sl/vmap`` with
   dropout on the card held against the CPU; then population cohorts
   (``[cohort]``): ``sl/vmap`` on the MobileNetV2 spec of 5 with dropout
   0.25 and a cohort of 4 drawn out of 1,000,000 clients (the EPSL
   shared client tier), 2 rounds, its int8 launches (one a local step),
   each round's cohort, and the engine state's bytes after ``init()``,
   equal at populations of 10,000 and 1,000,000; ``fl/vmap`` on the same
   cohort for one round (SL's client energy below FL's); SmolLM-135M
   ``sl/vmap`` on the shared tier, a cohort of 4 out of 10,000 at batch
   8, 1 round, with its flash and int8 launches and its peak memory; and
   a tinycnn ``sl/vmap`` cohort run on the card held against the CPU on
   the same ``Plan.cohorts``; then per-client adaptive cuts
   (``[hetero]``): ``sl/vmap`` on the MobileNetV2 spec of 5 with
   ``CutPolicy(mode="adaptive")``, edges (Jetson AGX Orin, an MCU-class
   profile) cycled over the 4 clients, dropout 0.25 and the mission's 20 s
   per-step link deadline, 2 rounds: the cuts must be [2, 1, 2, 1] (two
   buckets of 2, each its own fleet round and server suffix; smashed
   (16, 112, 112, 32) at cut 1 and (16, 112, 112, 16) at cut 2), with the
   int8 launches (one a local step a bucket), each round's wall time and
   record, the buckets' state bytes and a profiled round, and a tinycnn
   run with per-client cuts on the card held against the CPU (the vmap
   rules above include the int8 boundary at both buckets' shapes, 2
   clients folded into (401,408, 32) and (401,408, 16), and time the kernel
   there); then the scenario layer (``[scenario]``): ``sl/vmap`` on the
   MobileNetV2 spec of 5 under the reference tests' stochastic scenario
   (the ``a2g`` channel at its defaults, markov availability p_drop 0.4,
   p_recover 0.6, two UAVs relaying from their partitions' centroids,
   seed 1), 2 rounds: the rolled-out mission (rounds budget, each route's
   clients, the serve distances, the nominal rates), each round's mask
   and rate ratios, its records and wall time and the int8 launches (one
   a local step), and tinycnn under the same scenario on the card and on
   the CPU from the same injected draws (``Plan.env_draws``); and the
   Monte-Carlo sweep (``[mc]``): ``run_monte_carlo`` of that plan over 4
   seeds x 2 rounds in both modes, the seed axis (``vmap``: one program a
   local step for all seeds and clients) and the per-seed loop, masks,
   active clients, bytes and bills equal seed by seed and losses within
   ``FLEET_EQUIV_ATOL`` (the first round's under cuDNN's default
   algorithms, every round's under its deterministic ones: the default
   ones drift past it run to run by the second round), each mode's
   fenced wall time, their ratio and the peak memory, the int8 launches of each (one a local step for all
   16 seed-client rows in ``vmap`` mode), and the kernel through the
   nested ``vmap`` rule at (200,704, 32), bit-equal and one launch, timed
   L2 cold; then the sweep on the scan engines (``[mc-scan]``), 4 seeds x
   2 rounds in both modes gated as ``[mc]`` is: (a) the MobileNetV2
   ``sl/scan`` spec of 5 under the channel alone (``a2g``, two UAVs
   relaying, seed 1), whose seeds share one round in ``vmap`` mode (the
   int8 kernel once a client step for all seeds: 24 launches against the
   loop's 72; the seeds' losses bit-equal, their bills their own), and
   (b) the ``fl/scan`` spec of 6 with a cohort of 4 out of 1,000,000,
   each seed its own, on the seed axis (the seeds' losses differ), each
   part's wall times, their ratio and peaks beside the card's name and
   power limit; then run telemetry and the metrics bus (``[obs]``, under
   cuDNN's deterministic algorithms): the ``sl/vmap`` spec with dropout
   0.25, 2 rounds with a run directory under ``results/runs/``, the full
   tap set and round 1 profiled, against the same 2 rounds without
   telemetry (records and engine state bit-equal, 4 int8 launches each,
   round 0's ``quant_error`` against the plain version on the kernel's own
   inputs, 0 kernel builds a gauge window, ``state_bytes`` equal to
   ``tensor_bytes``, ``round/execute`` fenced, the int8 kernel in the
   profiler's trace, ``tools/obs_report.py --coverage-min 0.95
   --health-gate`` exiting 0), the host syncs of one ``raw_round`` with
   taps equal to without, the raw round timed in turns; a NaN planted at
   (client 2, step 1) of a tinycnn round localized on the card as on the
   CPU, and raised under ``on_nonfinite="raise"``; the ``[mc]`` plan's
   sweep with taps (6 int8 launches, its ``mc/*`` spans, seed 0 against
   ``plan.run()``'s metrics in the loop and on the seed axis); and a
   reduced SmolLM ``sl/vmap`` with taps on the card against the CPU, its
   flash and int8 launches equal with and without taps; the host syncs of
   a raw round (and the Python lines that made any), ``round/execute``'s
   ``sync_s`` share of ``dur_s``, and SmolLM-135M ``sl/vmap`` at batch 8
   with the default taps, its peak memory; then the explicit-collective
   engines (``[shard_map]``) on a one-rank NCCL group set up from a
   ``FileStore`` in a temporary directory and destroyed at the end:
   MobileNetV2 ``sl/shard_map`` and ``fl/shard_map`` on the spec of 5
   with dropout 0.25 against the same plans on ``vmap`` (round 0 under
   cuDNN's default algorithms and 2 rounds under its deterministic ones,
   losses within ``FLEET_EQUIV_ATOL``, masks, bytes and bills equal), the
   int8 launches, a raw round's collectives (counted at the call and from
   the profiler) and host syncs, the raw rounds timed in turns beside the
   card's name and power limit; and SmolLM-135M ``sl/shard_map`` at batch
   8 with the flash kernel, 2 rounds, its flash and int8 launches and
   peak memory; then ``[server-mesh]``: the MobileNetV2 ``sl/vmap`` round
   rebuilt with its server state as DTensors on a (1, 1, 1)
   ``DeviceMesh`` of a one-rank NCCL group, bit-equal to the plain run
   under cuDNN's deterministic algorithms, and the ``[mc]`` sweep (its
   plan, ``MC_SEEDS`` seeds x ``MC_ROUNDS`` rounds, both modes) on that
   mesh, each seed bit-equal to the plain ``[mc]`` sweep of its mode, the
   server state seed-stacked DTensors with shifted placements, the int8
   launches of the vmap sweep ``(1 + MC_ROUNDS) x local steps``;
9. the RWKV path: ``repro_torch.launch.train.train`` on rwkv6-7b at full
   width (d 4096, 64 heads of 64, d_ff 14336, vocab 65,536, bf16) cut to 4
   of its 32 layers, cut 1, batch 4 x 1024 tokens, AdamW, 3 steps, the
   parameters drawn on the card; with the WKV kernel's launch count over
   exactly those steps (4 x 3 forward and 4 x 3 backward), the peak
   memory, one profiled step, and the reduced rwkv6-7b (head size 256) on
   the card held against the same run on the CPU;
10. the serving path (``[serve]``): ``repro_torch.launch.serve`` with
    the reduced rwkv6-7b (head size 256) and the reduced SmolLM on the card
    held against the CPU (logits within 1e-4, tokens equal); rwkv6-7b at
    full width and all 32 layers (bf16, ~15 GB of weights drawn on the
    card) at the reference serve's defaults, batch 4, prompt 32, gen 32,
    with its tokens/s, peak memory and the WKV kernel's launches over
    exactly that run (64 steps x 32 layers = 2,048), and one decode step
    profiled; SmolLM-135M at full width, batch 8, prompt 128, gen 128;
    SmolLM-135M teacher-forced over 128 tokens with a bf16 and an int8 KV
    cache against ``model_forward`` (relative max error < 0.05, the
    reference's criterion; the int8 state under half the bytes of an f32
    cache). The wire-format pair's launch counts cover paths 5 to 10;
11. the MoE and hybrid families (``[moe]``), each model freed before the
    next: (a) one deepseek-moe-16b MoE layer (d 2048, 64 experts of 1408,
    top 6, 2 shared, bf16) over 4 x 256 tokens, ``moe_apply`` at a capacity
    that drops nothing against the dense oracle ``moe_ref`` (relative max
    error < 2^-7), and the share of picks dropped at the config's 1.25
    read off the dispatch table; (b) deepseek-moe-16b at full width cut to
    4 of its 28 layers (layer 0 dense, 3 MoE, cut 1) through
    ``launch.train.train``, batch 4 x 1024, AdamW lr 3e-4, 3 steps (each
    step's loss, aux and wall time), its peak memory and one profiled
    step; (c) deepseek-moe-16b at all 28 layers (32.2 GB of bf16 weights)
    through ``launch.serve.serve`` at batch 4, prompt 32, gen 32: tokens/s,
    ms a step, peak memory and one profiled decode step; (d)
    jamba-1.5-large's Mamba sub-layer at its published width (d 8192,
    d_inner 16,384, N 16, conv 4, dt_rank 512, bf16) over 4 x 512 tokens
    forward and backward (gradients finite), 32 decode steps from its
    state, and step by step over 64 tokens against one pass (relative max
    error < 2^-5); (e) the reduced deepseek-moe-16b, arctic-480b and
    jamba-1.5-large-398b on the card and on the CPU from the same weights:
    ``lm_loss`` and every gradient, 16 teacher-forced decode steps and 4
    greedy tokens, within 1e-4 and the tokens equal. The port's kernels'
    launches over the phase are printed: the trainer and the server attend
    with the plain path, as the reference's do, so none runs;
12. the encoder-decoder groups and the frontends (``[encdec]``): (a) the
    flash kernel at every head dim from 144 to 256 against its plain
    version (f32 and bf16; causal, non-causal and windowed; S, Sk in
    ``FLASH_NEW_PAIRS``), at pixtral-12b's split-LM shape (2, 32, 1024,
    160) in both dtypes with its gradient, and timed there in f32 beside
    SDPA and its 3xTF32 bound; the int8 link kernel timed at pixtral's
    link (2048, 5120) f32 (held against its plain version in phase 3);
    (b) pixtral-12b's decoder
    (hf:mistralai/Pixtral-12B-2409 at its published width: d 5120, 32/8
    heads of 160, d_ff 14336, vocab 131,072) cut to 4 of its 40 layers as
    a split-LM plan on the flash kernel (``sl/scan``, 2 clients, batch
    2 x 1024, 1 round, int8 link on the fused kernel): the flash (20) and
    int8 (4) launches over exactly that run, its peak memory and a
    profiled round; (c) the same 4 layers
    through ``launch.train`` at batch 2 x (1024 patch + 1024 text), 3
    steps, peak and a profiled step; (d) whisper-tiny (arXiv:2212.04356)
    whole through ``launch.train`` (batch 8 x 448 over 1500 frames, 3
    steps) and ``launch.serve.transcribe`` (batch 8, 64 tokens: tokens/s,
    ms a step); (e) pixtral-12b served whole at 40 layers, text only,
    batch 4, 32 + 32, with a profiled decode step; (f) the reduced
    whisper-tiny and pixtral-12b card == CPU (logits, loss and gradients
    within 1e-4, tokens equal). (c)-(f) launch no kernel: the trainer and
    the server attend with the plain path, as the reference's do;
13. checkpoints (``[ckpt]``): rwkv6-7b at full width cut to 4 layers
    (1.14B bf16 parameters; the WKV kernels, 4 forward and 4 backward
    launches a step) and SmolLM-135M whole, each trained 2 steps at batch
    4 x 1024 through ``launch.train.train(ckpt=)``: the file's size and
    meta, a second save of the same tree timed (its bytes equal to the
    trainer's file), the file restored straight onto the card into a fresh
    model and timed, its parameters and one forward's logits bit-equal to
    the trained model's;
14. the step builders (``[steps]``): ``launch.steps.build_train_step`` for
    that rwkv6-7b on a one-rank mesh at batch 4 x 1024, with remat and
    without: loss and gradients bit-equal to ``launch.train.train_step``'s
    (remat off) on the same params and batch, wall time, peak memory and
    WKV launches (8 forward + 4 backward with remat, 4 + 4 without), the
    host syncs of a scheduled AdamW step and FunctionalAdamW update (0);
    the dry run's per-rank bytes estimate (``launch.dryrun.
    BytesEstimate``) of the remat step against ``torch.cuda.
    max_memory_allocated`` over the same step, as a ratio;
    SmolLM-135M's built prefill and decode steps bit-equal to
    ``model_forward`` and ``model_decode_step``;
15. the dry run (``[dryrun]``): ``python -m repro_torch.launch.dryrun``
    for smollm-135m x {train_4k, prefill_32k, decode_32k}, rwkv6-7b x
    {decode_32k, train_4k} and deepseek-moe-16b x decode_32k on the 16x16
    fake mesh, one process each (rwkv6-7b x train_4k, whose WKV loops are
    scaled from one settled step, started after the kernel build, the
    others together at the phase): each record's status, global FLOPs,
    rank 0's argument bytes and estimated peak, collectives, its
    ``loops`` and trace seconds;
16. the analysis passes (``[analyze]``): ``src/repro_torch`` through the
    AST lint; the variant matrix of ``repro_torch.analyze.variants`` (22
    entries: fl/sl x scan/vmap/shard_map, dropout, cohorts, the flash and
    fused int8 kernels in split rounds, the metrics twins, the Monte-Carlo
    seed-axis rounds) compiled on the card, its ``shard_map`` entries on a
    one-rank NCCL group, each raw round run once under the runtime audit
    with a line of its host syncs (the dispatch audit's and CUDA's
    sync-debug count, which must agree), float64 tensors, collectives and
    their group, and the kernel seams' calls and launches against the
    engines' design; then ``fleet.hetero.arch_split_program`` on
    SmolLM-135M whole (30 layers, f32) cut at 8, batch 8 x 1024 on the
    flash kernel: one split step's smashed tensor and loss against the
    same program on the plain attention, within the flash tolerance of
    their largest magnitudes, and
    the step timed with its flash launches (30). Any finding fails;
17. one JSON line listing the kernels, then the card, then the result
    line.

It imports nothing of JAX or of the JAX package. Without a CUDA device it
exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12            # H100 SXM FP32 rate outside tensor cores
TF32_FLOP_PER_S = 495e12           # H100 SXM dense TF32 tensor-core rate
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core rate
SWEEP_M = (1, 7, 509, 2048, 12544)
SWEEP_D = (8, 16, 32, 256)
MAIN_M, MAIN_D = 12544, 32         # MobileNetV2 cut at batch 16, 224x224
# row widths that reach every path of the int8 kernels (csrc/quant_int8.cu):
# generic (3; 36 in bf16; 1028 and 2048 in f32: too many chunks), vector
# with 16 lanes a row (36 f32), 32 lanes and 5 or 8 chunks a lane (576,
# 1000; 2048 in bf16); and the widths whose launch plans are checked
INT8_EXTRA_M = (7, 509, 2048)
INT8_EXTRA_D = (3, 36, 576, 1000, 1028, 2048)
INT8_PLAN_D = (1, 3, 4, 5, 8, 16, 32, 33, 36, 256, 576, 1000, 1024, 1028,
               2048)
INT8_DTYPES = (torch.float32, torch.bfloat16)
LM_M, LM_D = 8 * 1024, 576         # SmolLM-135M cut: batch 8 x 1024 tokens
# the flash kernel's sweep: S, head dims, masks; Sk != S in extra pairs
FLASH_S = (1, 7, 100, 131, 257, 1024)
FLASH_SK_PAIRS = ((100, 257), (131, 1024), (7, 64))
FLASH_D = (32, 64, 128)
FLASH_WINDOWS = (None, 16, 100)
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
FLASH_MAIN = (8, 9, 1024, 64)      # SmolLM-135M attention at batch 8
# S, Sk, window of a causal case with fully masked rows: rows from
# Sk + window - 1 = 115 on see no key
FLASH_MASKED = (1024, 100, 16)
# the WKV kernel's sweep (at B, H = 2, 3) and the rwkv6-7b training shape
WKV_T = (1, 7, 64, 1000, 1024)
WKV_HD = (16, 32, 64, 128, 256)
WKV_MAIN = (4, 64, 1024, 64)
WKV_TOL = 1e-4                     # atol and rtol, the reference's own
# the WKV kernels from a carried state S_0: T around the 4-step
# sub-segments and 16-step segments, at (B, H) = (2, 3); and the rwkv6-7b
# decode step at the serve's batch 4 (T = 1 from S_0, one call a layer)
WKV_STATE_T = (1, 3, 4, 15, 16, 17, 64)
WKV_STATE_HD = (16, 64, 128, 256)
WKV_DECODE = (4, 64, 1, 64)
# the [serve] phase: the reference serve's defaults for rwkv6-7b at its 32
# layers, and SmolLM-135M at 128 + 128 tokens; the int8 KV cache's
# criterion, the reference's own (tests/test_perf_options.py:37-58)
SERVE_RWKV = {"batch": 4, "prompt_len": 32, "gen": 32}
SERVE_LM = {"batch": 8, "prompt_len": 128, "gen": 128}
INT8_KV_REL = 0.05
L2_ROTATE_BYTES = 256 * 2 ** 20    # > 5x the H100's 50 MB L2
RWKV_LAYERS = 4                    # of rwkv6-7b's 32: the only cut
# the [moe] phase: one deepseek-moe-16b MoE layer over 4 x 256 tokens;
# deepseek cut to 4 of its 28 layers (layer 0 dense, 3 MoE) through the
# trainer at batch 4 x 1024, 3 steps; all 28 layers served at the
# reference serve's defaults; jamba-1.5-large's Mamba sub-layer at its
# published width (d 8192, d_inner 16,384, N 16, conv 4, dt_rank 512)
# over 4 x 512 tokens, then 32 decode steps, and step by step over the
# first 64 tokens against one pass
MOE_TOKENS = (4, 256)
MOE_LAYERS = 4
MOE_TRAIN = {"steps": 3, "batch": 4, "seq": 1024}
SERVE_MOE = {"batch": 4, "prompt_len": 32, "gen": 32}
MAMBA_TOKENS = (4, 512)
MAMBA_STEPS = 32
MAMBA_CHECK = 64
# bf16 criteria, relative to the reference's largest magnitude: the
# dispatch against the dense oracle differs by the expert matmuls' shapes
# (cuBLAS's accumulation order, one bf16 rounding of an expert's output)
# and the f32 sum's order (index_add_ accumulates with atomics on the
# card): 2^-7, one bf16 rounding twice over. Mamba step by step against
# one pass: the projections at M = B and M = B S round apart at a dozen
# places, 2^-5
MOE_BF16_REL = 2 ** -7
MAMBA_STEP_REL = 2 ** -5
# the reduced configs on the card against the CPU (f32, TF32 off; the MoE
# scatter's f32 sums run in another order on the card)
MOE_CPU_TOL = 1e-4
# the [encdec] phase: the flash kernel's head dims above 128 over lengths
# and masks, and at pixtral-12b's split-LM shape (batch 2, 32 heads of
# 160); pixtral-12b's decoder at its published width cut to
# PIXTRAL_LAYERS of its 40 layers as a split-LM plan on the flash kernel
# and through the trainer (1024 patch + 1024 text positions), and served
# whole, text only; whisper-tiny whole through the trainer (448 text
# tokens over 1500 frames) and transcribe
FLASH_NEW_D = tuple(range(144, 257, 16))
FLASH_NEW_PAIRS = ((1, 1), (257, 257), (131, 1024), (1024, 100))
FLASH_NEW_MASKS = ((True, None), (False, None), (True, 100), (False, 16))
FLASH_PIXTRAL = (2, 32, 1024, 160)
PIXTRAL_LAYERS = 4
# pixtral's split-LM link: the f32 smashed activations of batch 2 x 1024
# tokens at d 5120 (the int8 kernel's generic path: 1280 chunks a row)
PIXTRAL_INT8 = (2 * 1024, 5120)
PIXTRAL_TRAIN = {"steps": 3, "batch": 2, "seq": 1024}
SERVE_PIXTRAL = {"batch": 4, "prompt_len": 32, "gen": 32}
WHISPER_TRAIN = {"steps": 3, "batch": 8, "seq": 448}
WHISPER_GEN = {"batch": 8, "gen": 64}
# the reduced configs on the card against the CPU (f32, TF32 off): the
# CPU tests' tolerance against the reference
ENCDEC_CPU_TOL = 1e-4
# the [ckpt] phase: rwkv6-7b cut to RWKV_LAYERS layers and SmolLM-135M
# whole, each trained through launch.train for 2 steps at batch 4 x 1024
# with a checkpoint, restored into a fresh model on the card; the [steps]
# phase: the built train step at that batch (an InputShape of its own:
# train_4k's 256 x 4096 does not fit one card), the built prefill at
# batch 4 x 1024 and 8 built decode steps; the [dryrun] phase's six
# combinations, one process each, all started together (deepseek-moe-16b's
# decode runs its MoE dispatch, whose scatters are out of place, on
# DTensors; rwkv6-7b's train_4k, the longest, its WKV loops scaled), and
# two of them again on the 2x16x16 mesh beside the six, each held to its
# 16x16 record: equal global FLOPs, no more argument bytes on rank 0
CKPT_TRAIN = {"steps": 2, "batch": 4, "seq": 1024}
STEPS_SEQ, STEPS_BATCH = 1024, 4
STEPS_DECODE = 8
DRYRUN = (("rwkv6-7b", "train_4k"), ("smollm-135m", "train_4k"),
          ("smollm-135m", "prefill_32k"), ("smollm-135m", "decode_32k"),
          ("rwkv6-7b", "decode_32k"), ("deepseek-moe-16b", "decode_32k"))
DRYRUN_MULTI_POD = (("smollm-135m", "decode_32k"),
                    ("rwkv6-7b", "decode_32k"))
DRYRUN_TIMEOUT_S = 300
# the [analyze] phase's transformer split through fleet.hetero's
# stacked-block interface: SmolLM-135M's whole 30-layer stack in f32, cut
# at 8, one split step at batch 8 x 1024 on the flash kernel against the
# same program on the plain (chunked) attention
ARCH_SPLIT = {"cut": 8, "batch": 8, "seq": 1024}
# the fleet engines (client_axis="vmap") fold their 4 clients into each
# kernel's batch. The split LM's vmap step holds all 4 clients'
# activations at once; it runs at lm_spec's batch 8, its server loss over
# chunks of tokens (fleet.hetero.chunked_lm_loss: the whole logits, their
# log-softmax and its gradient at 6 GiB each made it run out of the card's
# 80 GB before). The vmap rules are checked, and the kernels timed, at the
# vmap paths' shapes.
FLEET = 4
LM_VMAP_BATCH = 8
# the population the cohort phase draws its 4 clients from
COHORT_POPULATION = 1_000_000
VMAP_INT8 = ((FLEET * MAIN_M, MAIN_D), (FLEET * LM_VMAP_BATCH * 1024, LM_D))
# the [hetero] phase's cut buckets: 2 clients each, MobileNetV2 at batch 16
# cut after the stem (16, 112, 112, 32) and after ir0_0 (16, 112, 112, 16)
HETERO_CUTS = [2, 1, 2, 1]
HETERO_INT8_SHAPES = ((2, 16, 112, 112, 32), (2, 16, 112, 112, 16))
HETERO_INT8 = tuple((math.prod(s[:-1]), s[-1]) for s in HETERO_INT8_SHAPES)
FLASH_VMAP = ((FLEET * LM_VMAP_BATCH,) + FLASH_MAIN[1:],)
FLEET_DROPOUT = 0.25
# the [mc] phase's Monte-Carlo sweep: MC_SEEDS scenario seeds of the
# [scenario] plan (4 clients), both folded into the int8 kernel's rows by
# the seed axis's nested vmap rule: (4, 4, 16, 28, 28, 32) -> (200,704, 32)
MC_SEEDS = 4
MC_ROUNDS = 2
MC_INT8_SHAPE = (MC_SEEDS, FLEET, 16, 28, 28, MAIN_D)
MC_INT8 = (math.prod(MC_INT8_SHAPE[:-1]), MAIN_D)
# the [paper] phase: the paper's three backbones through its FL and SL_{a,b}
# specs (Fig. 3 / Table III) at 224x224, 4 clients, batch 16, 2 local
# steps, 12 classes, int8 link on the fused kernel
PAPER_BACKBONES = ("resnet18", "googlenet", "mobilenetv2")
PAPER_SETTINGS = (("FL", "fl", None), ("SL_75_25", "sl", 0.75),
                  ("SL_40_60", "sl", 0.40), ("SL_25_75", "sl", 0.25),
                  ("SL_15_85", "sl", 0.15))
PAPER_ROUNDS = 2
PAPER_IMAGE = 224
PAPER_N_TRAIN, PAPER_N_TEST = 480, 96
# each SL setting's cut (the last client stage) and smashed (N, H, W, C)
PAPER_SMASHED = {
    ("resnet18", 0.75): ("block6", (16, 7, 7, 512)),
    ("resnet18", 0.40): ("block3", (16, 28, 28, 128)),
    ("resnet18", 0.25): ("block1", (16, 56, 56, 64)),
    ("resnet18", 0.15): ("block0", (16, 56, 56, 64)),
    ("googlenet", 0.75): ("inc4e", (16, 7, 7, 832)),
    ("googlenet", 0.40): ("inc4a", (16, 14, 14, 512)),
    ("googlenet", 0.25): ("inc3b", (16, 14, 14, 480)),
    ("googlenet", 0.15): ("inc3a", (16, 28, 28, 256)),
    ("mobilenetv2", 0.75): ("ir5_0", (16, 7, 7, 160)),
    ("mobilenetv2", 0.40): ("ir3_0", (16, 14, 14, 64)),
    ("mobilenetv2", 0.25): ("ir2_0", (16, 28, 28, 32)),
    ("mobilenetv2", 0.15): ("ir1_0", (16, 56, 56, 24)),
}
# the link kernel's (rows, D) at those cuts that no earlier phase runs
PAPER_INT8 = tuple(sorted({(math.prod(s[:-1]), s[-1])
                           for _, s in PAPER_SMASHED.values()}
                          - {(MAIN_M, MAIN_D)}))
PAPER_INT8_TIMED = ((50176, 24), (784, 832), (3136, 480), (50176, 64))
# the paper's headline: SL cuts on-device energy by up to 86% against FL
PAPER_SAVING_HEADLINE = 0.86


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal values with NaN in the same places."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def int8_input(m, d, dtype, dev, g, misaligned=False, special=False):
    """Rows of different magnitudes; ``misaligned``: a contiguous view 2 or
    4 bytes past an allocation (the generic path); ``special``: a NaN, an
    inf and an all-zero row where M allows."""
    flat = torch.empty(m * d + 1, dtype=dtype, device=dev)
    x = flat[int(misaligned):][:m * d].view(m, d)
    x.copy_(torch.randn(m, d, device=dev, generator=g)
            * torch.rand(m, 1, device=dev, generator=g) * 10)
    if special and m >= 4:
        x[1, 0] = float("nan")
        x[2, d - 1] = float("inf")
        x[3, :] = 0.0
    return x


def check_quant_kernel(dev) -> float:
    """The fused kernel against its plain version, bit for bit (NaN
    positions included): the sweep in all four (in, out) dtype pairs, with
    and without a residual; the widths of ``INT8_EXTRA_D`` (every path)
    with NaN, inf and zero rows; misaligned contiguous views; the split
    LM's shape; and a NaN/inf case. Returns the largest |kernel - plain|."""
    from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                                quant_dequant_int8_plain,
                                                quant_int8_launch_plan)
    g = torch.Generator(device=dev).manual_seed(0)
    cases = 0
    max_err = 0.0

    def check(x, r, out_dtype, what):
        nonlocal cases, max_err
        got = quant_dequant_int8(x, residual=r, out_dtype=out_dtype)
        want = quant_dequant_int8_plain(x, residual=r, out_dtype=out_dtype)
        torch.cuda.synchronize()
        if got.dtype != out_dtype or not same(got, want):
            raise AssertionError(f"quant_dequant_int8 kernel != plain at "
                                 f"{what}")
        max_err = max(max_err, float(
            (got.float() - want.float()).nan_to_num(0.0).abs().max()))
        cases += 1

    shapes = ([(m, d, False) for m in SWEEP_M for d in SWEEP_D]
              + [(m, d, True) for m in INT8_EXTRA_M for d in INT8_EXTRA_D])
    paths = set()
    for m, d, special in shapes:
        for dtype in INT8_DTYPES:
            for out_dtype in INT8_DTYPES:
                for residual in (False, True):
                    x = int8_input(m, d, dtype, dev, g, special=special)
                    r = (torch.randn(m, d, device=dev, generator=g).to(dtype)
                         if residual else None)
                    paths.add(quant_int8_launch_plan(m, d, dtype)["path"])
                    check(x, r, out_dtype, f"M={m} D={d} {dtype} -> "
                          f"{out_dtype} residual={residual}")
    for d in (32, 576):                        # contiguous, not aligned
        for dtype in INT8_DTYPES:
            for out_dtype in INT8_DTYPES:
                x = int8_input(509, d, dtype, dev, g, misaligned=True,
                               special=True)
                r = int8_input(509, d, dtype, dev, g, misaligned=True)
                if x.data_ptr() % 16 == 0 or quant_int8_launch_plan(
                        509, d, dtype, aligned=False)["path"] != "generic":
                    raise AssertionError("the misaligned view is aligned")
                for res in (None, r):
                    check(x, res, out_dtype, f"a misaligned view (509, {d}) "
                          f"{dtype} -> {out_dtype} residual={res is not None}")
    for m, d in ((LM_M, LM_D), PIXTRAL_INT8):  # the split LMs' cuts
        for dtype in INT8_DTYPES:
            x = torch.randn(m, d, device=dev, generator=g).to(dtype)
            check(x, None, dtype, f"M={m} D={d} {dtype}")
    x = torch.randn(64, 32, device=dev, generator=g)
    x[3, 5] = float("nan")
    x[9, 0] = float("inf")
    x[10, :] = 0.0
    got, want = quant_dequant_int8(x), quant_dequant_int8_plain(x)
    torch.cuda.synchronize()
    if not same(got, want) or not torch.isnan(got[3]).all():
        raise AssertionError("quant_dequant_int8: NaN/inf rows differ")
    print(f"[check] quant_dequant_int8: {cases + 1} cases bit-equal to the "
          f"plain version (all four dtype pairs, with and without a "
          f"residual; paths {sorted(paths)} and misaligned views; NaN, inf "
          f"and zero rows included)")
    return max_err


def time_ms(fn, iters=200, warmup=20) -> float:
    """Per-call time of ``fn`` from CUDA events around ``iters`` eager
    calls: host dispatch included (it sets the time when it is slower
    than the device)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=200) -> float:
    """Per-call device time of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so no host dispatch sits between the kernels. The
    input stays in L2, as the smashed tensor does when the link follows the
    client's last conv."""
    for _ in range(3):
        fn()                      # warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return time_ms(graph.replay, iters=5, warmup=1) / iters


def device_ms_cold(fn, make_inputs, nbytes: int) -> float:
    """Per-call device time of ``fn(*inputs)`` with the L2 cold: ``n`` input
    sets from ``make_inputs()``, enough that the ``n * nbytes`` bytes the
    calls move (inputs and outputs) exceed ``L2_ROTATE_BYTES``, called in
    turn inside one CUDA graph with every output kept alive. Each call then
    reads and writes memory that no call since its last turn touched, so a
    memory-bound kernel is timed against device memory, as its bound is."""
    n = max(2, -(-L2_ROTATE_BYTES // nbytes))
    sets = [make_inputs() for _ in range(n)]
    for ins in sets[:2]:
        fn(*ins)                  # warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*ins) for ins in sets]
    graph.replay()
    torch.cuda.synchronize()
    ms = time_ms(graph.replay, iters=20, warmup=2) / n
    del graph, outs, sets
    torch.cuda.empty_cache()
    return ms


def cold_and_warm(label: str, kernel, plain, make_inputs, nbytes: int,
                  bound_ms: float, floor) -> dict:
    """A memory-bound kernel and its plain version at L2-cold device time
    (``device_ms_cold``; in turns kernel, floor, plain, plain, floor,
    kernel, each keeping its best), which is what the bytes bound compares
    with; ``floor`` is a PyTorch copy that streams the same bytes, timed
    the same way (informational: not the function); beside them the
    kernel's L2-resident time (one input replayed, ``device_ms``) and both
    eager times."""
    def cold(fn):
        return device_ms_cold(fn, make_inputs, nbytes)

    k1, f1, p1, p2, f2, k2 = (cold(kernel), cold(floor), cold(plain),
                              cold(plain), cold(floor), cold(kernel))
    kernel_ms, plain_ms, floor_ms = min(k1, k2), min(p1, p2), min(f1, f2)
    ins = make_inputs()
    warm_ms = device_ms(lambda: kernel(*ins))
    print(f"[time] {label}, device time per call, L2 cold (CUDA graph over "
          f"inputs rotated through {L2_ROTATE_BYTES / 2 ** 20:.0f} MiB): "
          f"kernel {kernel_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain "
          f"{plain_ms:.6f} ms ({p1:.6f}, {p2:.6f}); bound {bound_ms:.6f} ms "
          f"(bytes: {nbytes / 1e6:.2f} MB at 3.35 TB/s), kernel at "
          f"{100 * bound_ms / kernel_ms:.1f}% of it; same-bytes streaming "
          f"floor {floor_ms:.6f} ms ({f1:.6f}, {f2:.6f}), kernel at "
          f"{100 * floor_ms / kernel_ms:.1f}% of it; L2-resident "
          f"(one input replayed): kernel {warm_ms:.6f} ms; eager per call "
          f"(host dispatch included): kernel "
          f"{time_ms(lambda: kernel(*ins)):.6f} ms, plain "
          f"{time_ms(lambda: plain(*ins)):.6f} ms")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def time_quant_kernel(dev, m=MAIN_M, d=MAIN_D) -> dict:
    """The fused kernel at (m, d) f32 beside its plain version; its floor
    is ``out.copy_(x)`` into a fresh f32 tensor, the same 2*m*d*4 bytes."""
    from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                                quant_dequant_int8_plain)
    nbytes = 2 * m * d * 4                      # x read, the f32 result written
    return cold_and_warm(f"quant_dequant_int8 M={m} D={d} f32",
                         quant_dequant_int8, quant_dequant_int8_plain,
                         lambda: (torch.randn(m, d, device=dev),), nbytes,
                         nbytes / HBM_BYTES_PER_S * 1e3,
                         floor=lambda x: torch.empty_like(x).copy_(x))


def flash_sweep(dev, g, dims, pairs, masks) -> tuple:
    """The flash kernel against its plain version over ``dims`` x ``pairs``
    (S, Sk) x ``masks`` (causal, window) in f32 and bf16, standard normal
    inputs at (B, H) = (2, 3): finite everywhere, and within the
    reference's tolerances on the rows that see a key (the others differ
    by design: ROADMAP queue 3). Returns (the largest |kernel - plain| per
    dtype, the number of cases)."""
    from repro_torch.kernels.attn.flash import (flash_attention_fwd,
                                                flash_attention_plain)
    errs = {name: 0.0 for name in FLASH_ATOL}
    cases = 0
    for d in dims:
        for s, sk in pairs:
            qp = torch.arange(s, device=dev)[:, None]
            kp = torch.arange(sk, device=dev)[None, :]
            for causal, window in masks:
                seen = torch.ones(s, sk, dtype=torch.bool, device=dev)
                if causal:
                    seen &= qp >= kp
                if window is not None:
                    seen &= qp - kp < window
                sees = seen.any(dim=1)
                for dtype in (torch.float32, torch.bfloat16):
                    q = torch.randn(2, 3, s, d, device=dev,
                                    generator=g).to(dtype)
                    k, v = (torch.randn(2, 3, sk, d, device=dev,
                                        generator=g).to(dtype)
                            for _ in range(2))
                    got = flash_attention_fwd(q, k, v, causal=causal,
                                              window=window)
                    want = flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
                    torch.cuda.synchronize()
                    name = str(dtype).split(".")[-1]
                    err = float((got.float() - want.float())[:, :, sees]
                                .abs().max())
                    finite = bool(torch.isfinite(got.float()).all())
                    if not (got.dtype == dtype and finite
                            and err <= FLASH_ATOL[name]):
                        raise AssertionError(
                            f"flash_attention kernel != plain at D={d} "
                            f"S={s} Sk={sk} causal={causal} window={window} "
                            f"{name}: {err}, finite {finite}")
                    errs[name] = max(errs[name], err)
                    cases += 1
    return errs, cases


def flash_at_shape(dev, g, shape, errs: dict):
    """The flash kernel at a main path's own (B, H, S, D), causal, against
    its plain version in f32 and bf16; folds the errors into ``errs``."""
    from repro_torch.kernels.attn.flash import (flash_attention_fwd,
                                                flash_attention_plain)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(*shape, device=dev, generator=g).to(dtype)
                   for _ in range(3))
        got = flash_attention_fwd(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        err = float((got.float() - want.float()).abs().max())
        print(f"[check] flash_attention at the main path's shape {shape} "
              f"{name} causal: max_abs_err {err:.3e} (atol "
              f"{FLASH_ATOL[name]:g})")
        if not (got.dtype == dtype and err <= FLASH_ATOL[name]):
            raise AssertionError(f"flash_attention kernel != plain at "
                                 f"{shape} {name}: {err}")
        errs[name] = max(errs[name], err)


def flash_grad_err(dev, g, cases) -> float:
    """The flash kernel's gradient (kernel forward + closed-form backward)
    against autograd through the plain version at each (shape, causal,
    window) of ``cases``, f32, within 2e-4. Returns the largest error."""
    from repro_torch.kernels.attn.flash import (flash_attention,
                                                flash_attention_plain)
    gmax = 0.0
    for shape, causal, window in cases:
        ins = [torch.randn(*shape, device=dev, generator=g) for _ in range(3)]
        grads = []
        for fn in (flash_attention, flash_attention_plain):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            o = fn(*leaves, causal=causal, window=window)
            (o * torch.cos(o)).sum().backward()
            grads.append([t.grad for t in leaves])
        for got, want in zip(*grads):
            err = float((got - want).abs().max())
            if not err <= 2e-4:
                raise AssertionError(f"flash_attention gradient differs at "
                                     f"{shape}: {err}")
            gmax = max(gmax, err)
        del grads, ins
    torch.cuda.empty_cache()
    return gmax


def check_flash_kernel(dev) -> dict:
    """The flash kernel against its plain version over the sweep and at the
    split LM's shape ``FLASH_MAIN``, in f32 and bf16 (standard normal
    inputs), then its gradient (kernel forward + closed-form backward)
    against autograd through the plain version, ``FLASH_MAIN`` included.
    Returns the largest |kernel - plain| per dtype over all these cases."""
    from repro_torch.kernels.attn.flash import (flash_attention_fwd,
                                                flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(1)
    pairs = [(s, s) for s in FLASH_S] + list(FLASH_SK_PAIRS)
    errs, cases = flash_sweep(dev, g, FLASH_D, pairs,
                              [(c, w) for c in (True, False)
                               for w in FLASH_WINDOWS])
    flash_at_shape(dev, g, FLASH_MAIN, errs)
    cases += 2
    # fully masked rows: finite everywhere (no NaN from 0/0), and the rows
    # that see a key equal the plain version; the rows that see none differ
    # by design (the kernel: the mean over its live tiles or 0; the plain
    # version: the mean over all Sk values; ROADMAP queue 3)
    s, sk, window = FLASH_MASKED
    qp = torch.arange(s, device=dev)[:, None]
    kp = torch.arange(sk, device=dev)[None, :]
    sees = ((qp >= kp) & (qp - kp < window)).any(dim=1)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 3, s, 64, device=dev, generator=g).to(dtype)
        k, v = (torch.randn(2, 3, sk, 64, device=dev, generator=g).to(dtype)
                for _ in range(2))
        got = flash_attention_fwd(q, k, v, causal=True, window=window)
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        err = float((got.float() - want.float())[:, :, sees].abs().max())
        finite = bool(torch.isfinite(got.float()).all())
        print(f"[check] flash_attention fully masked rows (S {s}, Sk {sk}, "
              f"window {window}, causal) {name}: all finite {finite}; "
              f"{int(sees.sum())} rows that see a key: max_abs_err {err:.3e} "
              f"(atol {FLASH_ATOL[name]:g})")
        if not (finite and err <= FLASH_ATOL[name]):
            raise AssertionError(f"flash_attention with fully masked rows "
                                 f"{name}: finite {finite}, err {err}")
        errs[name] = max(errs[name], err)
        cases += 1
    print(f"[check] flash_attention: {cases} cases within the reference's "
          f"tolerances of the plain version; max_abs_err f32 "
          f"{errs['float32']:.3e} (atol 2e-5), bf16 {errs['bfloat16']:.3e} "
          f"(atol 3e-2)")
    gmax = flash_grad_err(dev, g, (((2, 3, 257, 64), True, None),
                                   ((2, 3, 131, 128), False, 16),
                                   ((2, 3, 100, 32), True, 100),
                                   (FLASH_MAIN, True, None)))
    print(f"[check] flash_attention gradients (kernel forward + closed-form "
          f"backward) vs autograd of the plain version, {FLASH_MAIN} "
          f"included: max_abs_err "
          f"{gmax:.3e} (atol 2e-4)")
    return errs


def time_flash_kernel(dev, shape=FLASH_MAIN, bf16=True) -> dict:
    """The flash kernel at ``shape`` (f32, causal; by default the split
    LM's) beside its plain version and
    ``F.scaled_dot_product_attention(is_causal=True)``, the library
    yardstick (timed here only; the port never calls it), in turns; then,
    with ``bf16``, the same shape in bf16, kernel beside SDPA
    (informational: no path runs it). The f32 bound is the 3xTF32
    tensor-core work the kernel does (3 TF32 products per f32 product); the
    FP32 bound of the first, SIMT version is printed beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels.attn.flash import (flash_attention_fwd,
                                                flash_attention_plain)
    b, h, s, d = shape
    q, k, v = (torch.randn(b, h, s, d, device=dev) for _ in range(3))
    kernel = lambda: flash_attention_fwd(q, k, v, causal=True)   # noqa: E731
    plain = lambda: flash_attention_plain(q, k, v, causal=True)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(               # noqa: E731
        q, k, v, is_causal=True)
    k1, p1, l1 = (device_ms(kernel, iters=20), device_ms(plain, iters=20),
                  device_ms(sdpa, iters=20))
    l2, p2, k2 = (device_ms(sdpa, iters=20), device_ms(plain, iters=20),
                  device_ms(kernel, iters=20))
    kernel_ms, plain_ms, lib_ms = min(k1, k2), min(p1, p2), min(l1, l2)
    flops = 2.0 * b * h * d * s * (s + 1)      # causal halves of 2 products
    nbytes = 4 * b * h * s * d * 4             # q, k, v read; out written
    tf32_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
    fp32_ms = flops / FP32_FLOP_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(tf32_ms, bytes_ms)
    print(f"[time] flash_attention {shape} f32 causal, device time per "
          f"call (CUDA graph): kernel {kernel_ms:.6f} ms ({k1:.6f}, "
          f"{k2:.6f}), plain {plain_ms:.6f} ms ({p1:.6f}, {p2:.6f}), SDPA "
          f"{lib_ms:.6f} ms ({l1:.6f}, {l2:.6f}); kernel/SDPA "
          f"{kernel_ms / lib_ms:.3f}; bound {bound_ms:.6f} ms (operations, "
          f"3xTF32: 3 x {flops / 1e9:.3f} GFLOP at 495 TFLOP/s = "
          f"{tf32_ms:.6f} ms; bytes: {nbytes / 1e6:.1f} MB = "
          f"{bytes_ms:.6f} ms), kernel at {100 * bound_ms / kernel_ms:.1f}% "
          f"of it; the first version's FP32 bound {fp32_ms:.6f} ms "
          f"({flops / 1e9:.3f} GFLOP at 67 TFLOP/s)")
    print(f"[time] flash_attention {shape} eager per call (host dispatch "
          f"included): kernel {time_ms(kernel, iters=20, warmup=3):.6f} ms, "
          f"plain {time_ms(plain, iters=20, warmup=3):.6f} ms, SDPA "
          f"{time_ms(sdpa, iters=20, warmup=3):.6f} ms")
    del q, k, v
    result = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "library_ms": lib_ms}
    if not bf16:
        return result
    qb, kb, vb = (torch.randn(b, h, s, d, device=dev).to(torch.bfloat16)
                  for _ in range(3))
    kernel = lambda: flash_attention_fwd(qb, kb, vb, causal=True)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(                 # noqa: E731
        qb, kb, vb, is_causal=True)
    k1, l1, l2, k2 = (device_ms(kernel, iters=20), device_ms(sdpa, iters=20),
                      device_ms(sdpa, iters=20), device_ms(kernel, iters=20))
    bf_ops_ms = flops / BF16_FLOP_PER_S * 1e3
    bf_bytes_ms = nbytes / 2 / HBM_BYTES_PER_S * 1e3
    print(f"[time] flash_attention {shape} bf16 causal (no path runs "
          f"it), device time per call (CUDA graph): kernel "
          f"{min(k1, k2):.6f} ms ({k1:.6f}, {k2:.6f}), SDPA {min(l1, l2):.6f}"
          f" ms ({l1:.6f}, {l2:.6f}); bound {max(bf_ops_ms, bf_bytes_ms):.6f}"
          f" ms (operations {bf_ops_ms:.6f} ms at 989 TFLOP/s bf16, bytes "
          f"{bf_bytes_ms:.6f} ms)")
    return result


def check_wire_kernels(dev) -> float:
    """``quantize_int8`` / ``dequantize_int8`` against their plain versions,
    bit for bit: codes, scales (NaN in the same places) and the
    dequantized rows in f32 and bf16, over the fused kernel's sweep, the
    widths of ``INT8_EXTRA_D``, the two link shapes, misaligned contiguous
    views, and rows holding NaN, inf and zeros. Returns the largest
    |kernel - plain| over the dequantized values (0 when bit-equal)."""
    from repro_torch.kernels.quant.int8 import dequantize_int8, quantize_int8
    from repro_torch.kernels.quant.ref import (dequantize_int8_ref,
                                               quantize_int8_ref)
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = ([(m, d, False) for m in SWEEP_M for d in SWEEP_D]
              + [(m, d, False) for m in INT8_EXTRA_M for d in INT8_EXTRA_D]
              + [(MAIN_M, MAIN_D, False), (LM_M, LM_D, False),
                 (509, 32, True), (509, 576, True)])
    cases = 0
    max_err = 0.0
    for m, d, misaligned in shapes:
        for dtype in INT8_DTYPES:
            x = int8_input(m, d, dtype, dev, g, misaligned=misaligned,
                           special=True)
            codes, scales = quantize_int8(x)
            want_c, want_s = quantize_int8_ref(x)
            torch.cuda.synchronize()
            if not (codes.dtype == torch.int8 and torch.equal(codes, want_c)
                    and same(scales, want_s)):
                raise AssertionError(f"quantize_int8 kernel != plain at M={m} "
                                     f"D={d} {dtype} misaligned={misaligned}")
            for out_dtype in INT8_DTYPES:
                got = dequantize_int8(codes, scales, out_dtype=out_dtype)
                want = dequantize_int8_ref(codes, scales, out_dtype=out_dtype)
                torch.cuda.synchronize()
                if not (got.dtype == out_dtype and same(got, want)):
                    raise AssertionError(f"dequantize_int8 kernel != plain at "
                                         f"M={m} D={d} {out_dtype}")
                max_err = max(max_err, float(
                    (got.float() - want.float()).nan_to_num(0.0).abs().max()))
                cases += 1
    print(f"[check] quantize_int8/dequantize_int8: {cases} cases bit-equal to "
          f"the plain versions (codes, scales, f32/bf16 rows; NaN, inf and "
          f"zero rows included; D {INT8_EXTRA_D} among the widths, "
          f"misaligned views), the link shapes ({MAIN_M}, {MAIN_D}) and "
          f"({LM_M}, {LM_D}) among them")
    return max_err


def check_int8_plans(dev):
    """The library's launch plans (``quant_int8_device_plan``) equal to the
    Python mirror (``quant_int8_launch_plan``) over ``INT8_PLAN_D`` x
    dtypes x alignment x kernel; then a ``[launch]`` line for the fused
    kernel and ``quantize_int8`` at both link shapes (f32, as the paths
    call them), and for the fused kernel at the ``[hetero]`` buckets'
    shapes, held equal to the mirror too. The vector path must take every
    shape, in one wave at the MobileNetV2 cut. Last, the fused kernel's
    plan at pixtral's link (``PIXTRAL_INT8``), held equal to the mirror."""
    from repro_torch.kernels.quant.int8 import (quant_int8_device_plan,
                                                quant_int8_launch_plan)
    n = 0
    for d in INT8_PLAN_D:
        for m in (1, 7, MAIN_M):
            for in_dtype in INT8_DTYPES:
                for out_dtype in INT8_DTYPES:
                    for aligned in (True, False):
                        for kernel, res in (("quant_dequant_int8", False),
                                            ("quant_dequant_int8", True),
                                            ("quantize_int8", False)):
                            want = quant_int8_launch_plan(
                                m, d, in_dtype, out_dtype, aligned, kernel)
                            got = quant_int8_device_plan(
                                m, d, in_dtype, out_dtype, aligned, kernel,
                                res)
                            if {k: got[k] for k in want} != want:
                                raise AssertionError(
                                    f"int8 launch plan for ({m}, {d}) "
                                    f"{in_dtype} -> {out_dtype} aligned="
                                    f"{aligned} {kernel} residual={res}: "
                                    f"library {got}, mirror {want}")
                            n += 1
    print(f"[check] int8 launch plans: {n} from the library equal to the "
          f"Python mirror")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kernel in ("quant_dequant_int8", "quantize_int8"):
        for m, d in ((MAIN_M, MAIN_D), (LM_M, LM_D)) + (
                HETERO_INT8 if kernel == "quant_dequant_int8" else ()):
            p = quant_int8_device_plan(m, d, torch.float32, kernel=kernel)
            want = quant_int8_launch_plan(m, d, torch.float32, kernel=kernel)
            if {k: p[k] for k in want} != want:
                raise AssertionError(f"{kernel} at ({m}, {d}): library plan "
                                     f"{p}, mirror {want}")
            waves = p["blocks"] / (p["blocks_per_sm"] * sms)
            print(f"[launch] {kernel} ({m}, {d}) f32: {p['path']} path, G "
                  f"{p['lanes_per_row']} lanes a row, V "
                  f"{p['chunks_per_lane']} chunks a lane, "
                  f"{p['rows_per_block']} rows a block, {p['blocks']} blocks "
                  f"of {p['threads']} threads "
                  f"({p['blocks'] * p['threads']} threads), "
                  f"{p['blocks_per_sm']} resident a SM x {sms} SMs: "
                  f"{waves:.3f} waves")
            if p["path"] != "vector" or ((m, d) == (MAIN_M, MAIN_D)
                                         and waves > 1):
                raise AssertionError(f"{kernel} at ({m}, {d}): want the "
                                     f"vector path (in one wave at "
                                     f"({MAIN_M}, {MAIN_D})), got {p}")
    m, d = PIXTRAL_INT8
    p = quant_int8_device_plan(m, d, torch.float32)
    want = quant_int8_launch_plan(m, d, torch.float32)
    if {k: p[k] for k in want} != want:
        raise AssertionError(f"quant_dequant_int8 at ({m}, {d}): library "
                             f"plan {p}, mirror {want}")
    print(f"[launch] quant_dequant_int8 ({m}, {d}) f32 (pixtral's split "
          f"LM): {p['path']} path, {p['rows_per_block']} rows a block, "
          f"{p['blocks']} blocks of {p['threads']} threads")


def wkv_inputs(shape, dev, g):
    """The reference test's law (tests/test_kernels.py:276-283): r, k, v
    0.5 N(0, 1); w sigmoid(N(0, 1)); u 0.3 N(0, 1)."""
    b, h, t, hd = shape
    r, k, v = (0.5 * torch.randn(shape, device=dev, generator=g)
               for _ in range(3))
    w = torch.sigmoid(torch.randn(shape, device=dev, generator=g))
    u = 0.3 * torch.randn(h, hd, device=dev, generator=g)
    return r, k, v, w, u


def check_wkv_kernel(dev) -> tuple:
    """The WKV kernel against its plain version over T x hd at (B, H) = (2,
    3) and at the rwkv6-7b shape ``WKV_MAIN``, within atol/rtol
    ``WKV_TOL``: y and the final state S_T from the call without
    checkpoints, and y, S_T and the checkpoints the backward starts from
    from the call that writes them (as training runs it); two calls at
    ``WKV_MAIN`` give the same bits. Then ``ops.wkv``'s gradients (forward
    kernel + backward kernel) against autograd of the plain loop, with a
    cotangent of S_T and with w holding exact zeros, at head sizes 32 to
    256, and the backward kernel against its plain closed form at
    ``WKV_MAIN``. Returns the largest |kernel - plain| of the forward (y,
    S_T, checkpoints) and of the backward (the five gradients)."""
    from repro_torch.kernels.rwkv.ops import wkv
    from repro_torch.kernels.rwkv.ref import (rwkv6_scan_bwd_ref,
                                              rwkv6_scan_ref)
    from repro_torch.kernels.rwkv.scan import rwkv6_scan, rwkv6_scan_bwd
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = [(2, 3, t, hd) for t in WKV_T for hd in WKV_HD] + [WKV_MAIN]
    max_err = 0.0
    for shape in shapes:
        ins = wkv_inputs(shape, dev, g)
        y, st = rwkv6_scan(*ins, return_state=True)
        yc, stc, ck = rwkv6_scan(*ins, return_state=True, checkpoints=True)
        want_y, want_s, want_c = rwkv6_scan_ref(*ins, return_state=True,
                                                checkpoints=True)
        torch.cuda.synchronize()
        errs = {}
        for name, got, want in (("y", y, want_y), ("S_T", st, want_s),
                                ("y with checkpoints", yc, want_y),
                                ("S_T with checkpoints", stc, want_s),
                                ("checkpoints", ck, want_c)):
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=WKV_TOL, rtol=WKV_TOL):
                raise AssertionError(f"rwkv6_scan kernel != plain at {shape} "
                                     f"({name}): max_abs_err {err}")
            errs[name] = err
            max_err = max(max_err, err)
        if shape == WKV_MAIN:
            print(f"[check] rwkv6_scan at the main path's shape {WKV_MAIN} "
                  f"f32: max_abs_err y {errs['y']:.3e}, S_T "
                  f"{errs['S_T']:.3e}; writing checkpoints: y "
                  f"{errs['y with checkpoints']:.3e}, S_T "
                  f"{errs['S_T with checkpoints']:.3e}, checkpoints "
                  f"{errs['checkpoints']:.3e} (atol/rtol {WKV_TOL:g})")
            again = rwkv6_scan(*ins, return_state=True, checkpoints=True)
            torch.cuda.synchronize()
            for name, a, b_ in zip(("y", "S_T", "checkpoints"),
                                   (yc, stc, ck), again):
                if not torch.equal(a, b_):
                    raise AssertionError(f"rwkv6_scan {name} at {WKV_MAIN}: "
                                         f"two calls on the same inputs "
                                         f"differ")
            print(f"[check] rwkv6_scan at {WKV_MAIN}: two calls give "
                  f"bit-equal y, S_T and checkpoints")
            del again
        del ins, y, st, yc, stc, ck, want_y, want_s, want_c
    print(f"[check] rwkv6_scan: {len(shapes)} shapes (T {WKV_T} x hd "
          f"{WKV_HD}, and {WKV_MAIN}) within atol/rtol {WKV_TOL:g} of the "
          f"plain version, y and S_T with and without checkpoints, and the "
          f"checkpoints; max_abs_err {max_err:.3e}")

    def check(label, got, want, shape):
        errs = []
        for name, a, b in zip("rkvwu", got, want):
            err = float((a - b).abs().max())
            if not torch.allclose(a, b, atol=WKV_TOL, rtol=WKV_TOL):
                raise AssertionError(f"wkv gradient d{name} != {label} at "
                                     f"{shape}: max_abs_err {err}")
            errs.append(err)
        return max(errs)

    gmax = 0.0
    # T at the edges of the backward's 4-step sub-segments and 16-step
    # segments among them: (2, 3, 17, 64), (1, 2, 5, 48)
    grad_shapes = [(2, 3, 64, 64), (1, 2, 100, 32), (2, 3, 40, 48),
                   (1, 2, 50, 128), (2, 2, 37, 256), (2, 3, 17, 64),
                   (1, 2, 5, 48)]
    for n, shape in enumerate(grad_shapes):
        ins = list(wkv_inputs(shape, dev, g))
        if n % 2 == 0:                      # decays that underflowed to 0
            ins[3][..., ::5] = 0.0
            ins[3][..., 1::7] = 1e-30
        grads = []
        for fn in (wkv, rwkv6_scan_ref):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            y, st = fn(*leaves, return_state=True)
            ((y * torch.cos(y)).sum() + (st * st).sum()).backward()
            grads.append([t.grad for t in leaves])
        gmax = max(gmax, check("autograd of the plain loop", *grads, shape))
    print(f"[check] wkv gradients (forward kernel + backward kernel) vs "
          f"autograd of the plain loop, y and S_T cotangents, w with exact "
          f"zeros in {(len(grad_shapes) + 1) // 2} of {len(grad_shapes)} "
          f"shapes {grad_shapes}: max_abs_err {gmax:.3e} (atol/rtol "
          f"{WKV_TOL:g})")
    ins = wkv_inputs(WKV_MAIN, dev, g)
    gy = torch.randn(WKV_MAIN, device=dev, generator=g)
    b, h, _, hd = WKV_MAIN
    gs = torch.randn((b, h, hd, hd), device=dev, generator=g)
    _, _, ckpt = rwkv6_scan(*ins, checkpoints=True)
    got = rwkv6_scan_bwd(*ins, gy, gs, ckpt)
    want = rwkv6_scan_bwd_ref(*ins, gy, gs, ckpt)
    torch.cuda.synchronize()
    main_err = check("the plain closed form", got, want, WKV_MAIN)
    print(f"[check] rwkv6_scan_bwd at the main path's shape {WKV_MAIN} f32, "
          f"with G_T, vs its plain closed form on the same checkpoints: "
          f"max_abs_err {main_err:.3e} (atol/rtol {WKV_TOL:g})")
    again = rwkv6_scan_bwd(*ins, gy, gs, ckpt)       # hd 64: no atomics
    torch.cuda.synchronize()
    for name, a, b_ in zip("rkvwu", got, again):
        if not torch.equal(a, b_):
            raise AssertionError(f"rwkv6_scan_bwd d{name} at {WKV_MAIN}: two "
                                 f"calls on the same inputs differ")
    print(f"[check] rwkv6_scan_bwd at {WKV_MAIN}: two calls give bit-equal "
          f"gradients")
    return max_err, max(gmax, main_err)


def check_wkv_state_kernels(dev) -> tuple:
    """The WKV kernels from a carried state S_0 ~ N(0, 0.5^2): the forward
    over T ``WKV_STATE_T`` x hd ``WKV_STATE_HD`` at (B, H) = (2, 3) and at
    the decode shape ``WKV_DECODE``, y and S_T (with and without the
    checkpoints) within atol/rtol ``WKV_TOL`` of the plain loop from the
    same S_0 and the first checkpoint S_0 bit for bit; then ``ops.wkv``'s
    six gradients (r, k, v, w, u and S_0: the backward kernel's ``gs0_out``)
    against autograd of the plain loop from S_0, for sum(G_y y) + sum(G_T
    S_T) with fixed random cotangents. Returns the largest |kernel -
    plain| of the forward and of the gradients."""
    from repro_torch.kernels.rwkv.ops import wkv
    from repro_torch.kernels.rwkv.ref import rwkv6_scan_ref
    from repro_torch.kernels.rwkv.scan import rwkv6_scan, rwkv6_scan_bwd
    g = torch.Generator(device=dev).manual_seed(10)
    shapes = [(2, 3, t, hd) for hd in WKV_STATE_HD for t in WKV_STATE_T] \
        + [WKV_DECODE]
    max_err = 0.0
    for shape in shapes:
        ins = wkv_inputs(shape, dev, g)
        b, h, _, hd = shape
        s0 = 0.5 * torch.randn((b, h, hd, hd), device=dev, generator=g)
        y, st, ck = rwkv6_scan(*ins, state=s0, return_state=True,
                               checkpoints=True)
        y2, st2 = rwkv6_scan(*ins, state=s0, return_state=True)
        want_y, want_s = rwkv6_scan_ref(*ins, state=s0, return_state=True)
        torch.cuda.synchronize()
        for name, got, want in (("y", y, want_y), ("S_T", st, want_s),
                                ("y, no checkpoints", y2, want_y),
                                ("S_T, no checkpoints", st2, want_s)):
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=WKV_TOL, rtol=WKV_TOL):
                raise AssertionError(f"rwkv6_scan from S_0 != plain at "
                                     f"{shape} ({name}): max_abs_err {err}")
            max_err = max(max_err, err)
        if not torch.equal(ck[:, :, 0], s0):
            raise AssertionError(f"rwkv6_scan at {shape}: the first "
                                 f"checkpoint is not S_0 bit for bit")
        if shape == WKV_DECODE:
            print(f"[check] rwkv6_scan from S_0 at the decode shape "
                  f"{WKV_DECODE}: max_abs_err y "
                  f"{float((y - want_y).abs().max()):.3e}, S_T "
                  f"{float((st - want_s).abs().max()):.3e}")
    print(f"[check] rwkv6_scan from a carried S_0: {len(shapes)} shapes (T "
          f"{WKV_STATE_T} x hd {WKV_STATE_HD} at (2, 3), and "
          f"{WKV_DECODE}) within atol/rtol {WKV_TOL:g} of the plain loop "
          f"from S_0, y and S_T with and without checkpoints, the first "
          f"checkpoint S_0 bit for bit; max_abs_err {max_err:.3e}")
    gmax = 0.0
    grad_shapes = [(2, 3, 1, 64), (2, 3, 17, 64), (1, 2, 5, 16),
                   (1, 2, 17, 48), (1, 2, 17, 128), (2, 2, 3, 256),
                   (1, 2, 40, 256), WKV_DECODE]
    before = rwkv6_scan_bwd.launches
    for shape in grad_shapes:
        ins = wkv_inputs(shape, dev, g)
        b, h, _, hd = shape
        s0 = 0.5 * torch.randn((b, h, hd, hd), device=dev, generator=g)
        gy = torch.randn(shape, device=dev, generator=g)
        gs = torch.randn((b, h, hd, hd), device=dev, generator=g)
        grads = []
        for fn in (wkv, rwkv6_scan_ref):
            leaves = [t.clone().requires_grad_(True) for t in (*ins, s0)]
            y, st = fn(*leaves[:5], state=leaves[5], return_state=True)
            ((y * gy).sum() + (st * gs).sum()).backward()
            grads.append([t.grad for t in leaves])
        for name, a, b_ in zip(("r", "k", "v", "w", "u", "S_0"), *grads):
            err = float((a - b_).abs().max())
            if not torch.allclose(a, b_, atol=WKV_TOL, rtol=WKV_TOL):
                raise AssertionError(f"wkv gradient d{name} from S_0 != "
                                     f"autograd of the plain loop at {shape}"
                                     f": max_abs_err {err}")
            gmax = max(gmax, err)
    if rwkv6_scan_bwd.launches != before + len(grad_shapes):
        raise AssertionError("wkv's backward from S_0 did not launch the "
                             "backward kernel once a call")
    print(f"[check] wkv's six gradients from a carried S_0 (backward kernel "
          f"with gs0_out) vs autograd of the plain loop at {grad_shapes}: "
          f"max_abs_err {gmax:.3e} (atol/rtol {WKV_TOL:g})")
    return max_err, gmax


def time_wkv_decode(dev) -> dict:
    """The WKV kernel at the rwkv6-7b decode shape ``WKV_DECODE`` (T = 1
    from a carried S_0, returning S_T: one call a layer a token of the
    serve path) beside its plain version, in a CUDA graph with its 8.7 MB
    of inputs replayed (L2-resident) and rotated through 256 MiB (L2
    cold). No single PyTorch call computes it. The bound: bytes S_0 in and
    S_T out (2 B H hd^2 4) plus r, k, v, w in and y out (5 B H T hd 4) at
    3.35 TB/s, against operations B H T (5 hd^2 + 3 hd) at 67 TFLOP/s."""
    from repro_torch.kernels.rwkv.ref import rwkv6_scan_ref
    from repro_torch.kernels.rwkv.scan import rwkv6_scan
    g = torch.Generator(device=dev).manual_seed(11)
    b, h, t, hd = WKV_DECODE

    def make():
        return (*wkv_inputs(WKV_DECODE, dev, g),
                0.5 * torch.randn((b, h, hd, hd), device=dev, generator=g))

    ins = make()

    def kernel(*a):
        return rwkv6_scan(*a[:5], state=a[5], return_state=True)

    def plain(*a):
        return rwkv6_scan_ref(*a[:5], state=a[5], return_state=True)

    k1, p1, p2, k2 = (device_ms(lambda: kernel(*ins)),
                      device_ms(lambda: plain(*ins), iters=50),
                      device_ms(lambda: plain(*ins), iters=50),
                      device_ms(lambda: kernel(*ins)))
    kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
    nbytes = 2 * b * h * hd * hd * 4 + 5 * b * h * t * hd * 4
    flops = b * h * t * (5 * hd * hd + 3 * hd)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    c1, c2 = (device_ms_cold(kernel, make, nbytes),
              device_ms_cold(kernel, make, nbytes))
    cold_ms = min(c1, c2)
    print(f"[time] rwkv6_scan decode step {WKV_DECODE} f32 from S_0, device "
          f"time per call (CUDA graph): L2-resident kernel {kernel_ms:.6f} ms "
          f"({k1:.6f}, {k2:.6f}), plain {plain_ms:.6f} ms ({p1:.6f}, "
          f"{p2:.6f}); L2 cold kernel {cold_ms:.6f} ms ({c1:.6f}, "
          f"{c2:.6f}); bound {bound_ms:.6f} ms (bytes: {nbytes} B = "
          f"{bytes_ms:.6f} ms; operations: {flops / 1e6:.3f} MFLOP = "
          f"{ops_ms:.6f} ms); cold kernel at "
          f"{100 * bound_ms / cold_ms:.1f}% of its bound")
    print(f"[time] rwkv6_scan decode step eager per call (host dispatch "
          f"included): kernel {time_ms(lambda: kernel(*ins)):.6f} ms, plain "
          f"{time_ms(lambda: plain(*ins), iters=50, warmup=5):.6f} ms")
    return {"ms": kernel_ms, "cold_ms": cold_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms}


def time_wire_kernels(dev, m, d) -> dict:
    """quantize_int8 and dequantize_int8 at (m, d) f32 beside their plain
    versions; both move m*d*(4 + 1) + 4*m bytes. Their floors copy the
    same m*d*(4 + 1) bytes without the scales: x into a fresh int8 tensor,
    the codes into a fresh f32 one."""
    from repro_torch.kernels.quant.int8 import dequantize_int8, quantize_int8
    from repro_torch.kernels.quant.ref import (dequantize_int8_ref,
                                               quantize_int8_ref)
    nbytes = m * d * 5 + 4 * m
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3

    def x_only():
        return (torch.randn(m, d, device=dev),)

    def codes_and_scales():
        return quantize_int8(torch.randn(m, d, device=dev))

    def to_int8(x):
        return torch.empty(x.shape, dtype=torch.int8, device=dev).copy_(x)

    def to_f32(codes, _scales):
        return torch.empty(codes.shape, device=dev).copy_(codes)

    return {name: cold_and_warm(f"{name} M={m} D={d} f32", kernel, plain,
                                make, nbytes, bound_ms, floor)
            for name, kernel, plain, make, floor in (
                ("quantize_int8", quantize_int8, quantize_int8_ref, x_only,
                 to_int8),
                ("dequantize_int8", dequantize_int8, dequantize_int8_ref,
                 codes_and_scales, to_f32))}


def time_wkv_kernel(dev) -> dict:
    """The WKV kernel at the rwkv6-7b shape beside its plain version (a
    loop of about 6 small kernels per step). No single PyTorch call
    computes this function. The bound: bytes 5*B*H*T*hd*4 (r, k, v, w read,
    y written) at 3.35 TB/s, against operations B*H*T*(5*hd^2 + 3*hd) (the
    least a step needs: kv, the w*S + kv update and r.S as FMAs, the bonus
    as (r . (u*k)) v) at 67 TFLOP/s FP32. The call that training makes
    also writes the checkpoints, B*H*ceil(T/16)*hd^2*4 bytes more: it is
    timed beside its own bound, with the forward's launch."""
    from repro_torch.kernels.rwkv.ref import rwkv6_scan_ref
    from repro_torch.kernels.rwkv.scan import (CHECKPOINT_EVERY, rwkv6_scan,
                                               rwkv6_scan_launch_config)
    g = torch.Generator(device=dev).manual_seed(4)
    ins = wkv_inputs(WKV_MAIN, dev, g)
    kernel = lambda: rwkv6_scan(*ins)                 # noqa: E731
    plain = lambda: rwkv6_scan_ref(*ins)              # noqa: E731
    k1, p1, p2, k2 = (device_ms(kernel, iters=20), device_ms(plain, iters=1),
                      device_ms(plain, iters=1), device_ms(kernel, iters=20))
    kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
    b, h, t, hd = WKV_MAIN
    nbytes = 5 * b * h * t * hd * 4
    flops = b * h * t * (5 * hd * hd + 3 * hd)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[time] rwkv6_scan {WKV_MAIN} f32, device time per call (CUDA "
          f"graph): kernel {kernel_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain "
          f"{plain_ms:.6f} ms ({p1:.6f}, {p2:.6f}); bound {bound_ms:.6f} ms "
          f"(bytes: {nbytes / 1e6:.1f} MB = {bytes_ms:.6f} ms; operations: "
          f"{flops / 1e9:.3f} GFLOP at 67 TFLOP/s = {ops_ms:.6f} ms); kernel "
          f"at {100 * bound_ms / kernel_ms:.1f}% of its bound")
    print(f"[time] rwkv6_scan eager per call (host dispatch included): "
          f"kernel {time_ms(kernel, iters=20, warmup=3):.6f} ms, plain "
          f"{time_ms(plain, iters=2, warmup=1):.6f} ms")
    ckpt_ms = device_ms(lambda: rwkv6_scan(*ins, checkpoints=True),
                        iters=20)
    ck_bytes = nbytes + b * h * -(-t // CHECKPOINT_EVERY) * hd * hd * 4
    ck_bound_ms = max(ck_bytes / HBM_BYTES_PER_S * 1e3, ops_ms)
    print(f"[time] rwkv6_scan {WKV_MAIN} writing the backward's checkpoints "
          f"every {CHECKPOINT_EVERY} steps (as a training step runs it): "
          f"{ckpt_ms:.6f} ms device; bound {ck_bound_ms:.6f} ms (bytes: "
          f"{ck_bytes / 1e6:.1f} MB with the checkpoints); kernel at "
          f"{100 * ck_bound_ms / ckpt_ms:.1f}% of that bound")
    cfg = rwkv6_scan_launch_config(b, h, hd)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[launch] rwkv6_scan {WKV_MAIN}: {cfg['blocks']} blocks of "
          f"{cfg['threads']} threads, {cfg['smem_bytes']} bytes of dynamic "
          f"shared memory, {cfg['blocks_per_sm']} resident a SM x {sms} SMs "
          f"= {cfg['blocks_per_sm'] * sms} slots")
    if cfg["blocks_per_sm"] * sms < cfg["blocks"]:
        raise AssertionError(f"rwkv6_scan at {WKV_MAIN} needs more than one "
                             f"wave: {cfg}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def time_wkv_bwd(dev) -> dict:
    """The WKV backward kernel at the rwkv6-7b shape (no cotangent of S_T,
    as in training) beside its plain closed form on the same checkpoints.
    No single PyTorch call computes it. The bound: bytes 9*B*H*T*hd*4 (r, k,
    v, w, gy read, dr, dk, dv, dw written) plus the checkpoints read once,
    at 3.35 TB/s, against operations 14*hd^2 per (b, h, t) at 67 TFLOP/s
    FP32 (recomputing S: 3 hd^2; dr, dk, dv, dw: 2 hd^2 each; the G update:
    3 hd^2)."""
    from repro_torch.kernels.rwkv.ref import rwkv6_scan_bwd_ref
    from repro_torch.kernels.rwkv.scan import (rwkv6_scan, rwkv6_scan_bwd,
                                               rwkv6_scan_bwd_launch_config)
    g = torch.Generator(device=dev).manual_seed(5)
    ins = wkv_inputs(WKV_MAIN, dev, g)
    gy = torch.randn(WKV_MAIN, device=dev, generator=g)
    _, _, ckpt = rwkv6_scan(*ins, checkpoints=True)
    args = (*ins, gy, None, ckpt)
    kernel = lambda: rwkv6_scan_bwd(*args)            # noqa: E731
    plain = lambda: rwkv6_scan_bwd_ref(*args)         # noqa: E731
    k1, p1, p2, k2 = (device_ms(kernel, iters=10), device_ms(plain, iters=1),
                      device_ms(plain, iters=1), device_ms(kernel, iters=10))
    kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
    b, h, t, hd = WKV_MAIN
    nbytes = 9 * b * h * t * hd * 4 + ckpt.numel() * 4
    flops = 14 * b * h * t * hd * hd
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[time] rwkv6_scan_bwd {WKV_MAIN} f32, device time per call (CUDA "
          f"graph): kernel {kernel_ms:.6f} ms ({k1:.6f}, {k2:.6f}), plain "
          f"{plain_ms:.6f} ms ({p1:.6f}, {p2:.6f}); bound {bound_ms:.6f} ms "
          f"(bytes: {nbytes / 1e6:.1f} MB = {bytes_ms:.6f} ms, checkpoints "
          f"{ckpt.numel() * 4 / 1e6:.1f} MB of it; operations: "
          f"{flops / 1e9:.3f} GFLOP at 67 TFLOP/s = {ops_ms:.6f} ms); kernel "
          f"at {100 * bound_ms / kernel_ms:.1f}% of its bound")
    print(f"[time] rwkv6_scan_bwd eager per call (host dispatch included): "
          f"kernel {time_ms(kernel, iters=10, warmup=2):.6f} ms")
    cfg = rwkv6_scan_bwd_launch_config(b, h, hd)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[launch] rwkv6_scan_bwd {WKV_MAIN}: {cfg['blocks']} blocks of "
          f"{cfg['threads']} threads, {cfg['smem_bytes']} bytes of dynamic "
          f"shared memory, {cfg['blocks_per_sm']} resident a SM x {sms} SMs "
          f"= {cfg['blocks_per_sm'] * sms} slots")
    if cfg["blocks_per_sm"] * sms < cfg["blocks"]:
        raise AssertionError(f"rwkv6_scan_bwd at {WKV_MAIN} needs more than "
                             f"one wave: {cfg}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def mcu_profile():
    """The microcontroller-class edge profile of the reference's tests."""
    from repro_torch.core.energy import HardwareProfile
    return HardwareProfile("mcu-class", fp32_tflops=0.02, mem_bw_gbs=2.0,
                           tensor_tflops=0.04, cpu_passmark=400.0,
                           power_w=2.0)


def main_spec(api, kind: str, rounds: int, *, client_axis="scan",
              dropout_rate=0.0, population=None, adaptive=False):
    """MobileNetV2 at 224x224 (the CNN paths' spec). ``adaptive``: per-client
    cuts, edges (Jetson AGX Orin, MCU) cycled over the clients."""
    from repro_torch.core.energy import JETSON_AGX_ORIN
    return api.ExperimentSpec(
        model=api.ModelSpec(name="mobilenetv2", num_classes=12),
        data=api.DataSpec(image_size=224),
        clients=api.ClientSpec(num_clients=4, dropout_rate=dropout_rate,
                               population=population,
                               edge_profiles=((JETSON_AGX_ORIN, mcu_profile())
                                              if adaptive
                                              else (JETSON_AGX_ORIN,))),
        cut_policy=api.CutPolicy(mode="adaptive" if adaptive else "fraction",
                                 fraction=0.25),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind=kind, client_axis=client_axis,
                              link_kernel="fused", server_reduce="mean"),
        mission=api.MissionSpec(),
        global_rounds=rounds, local_steps=2, batch_size=16)


def run_plan(plan, label: str):
    """Run the plan's rounds; print each record, its wall time and its
    active clients."""
    state = plan.init()
    records = []
    for _ in range(plan.num_rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rec = plan.run_round(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[{label}] round {rec.round} wall_s={wall:.4f} "
              f"active_clients={rec.active_clients} "
              f"record={json.dumps(rec.to_dict())}")
        if not math.isfinite(rec.loss):
            raise AssertionError(f"{label}: non-finite loss {rec.loss}")
        records.append(rec)
    return state, records


def profile_call(fn, label: str, what: str, top: int = 12, cpu=True):
    """``fn()`` once under ``torch.profiler``: the device's busy share of its
    wall time and the kernels that take the most device time. (Profiling
    slows the host side, so the busy share is a lower bound.) ``cpu=False``
    traces the device alone: the busy share needs no host operator events,
    and a call of ~100,000 small kernels takes a minute to read back with
    them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    t_read = time.perf_counter()
    per_kernel: dict = {}
    for e in prof.events():              # device-side events: the kernels
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            t_us, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (t_us + e.time_range.elapsed_us(), n + 1)
    rows = [(t_us, name, n) for name, (t_us, n) in per_kernel.items()]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        print(f"[profile] {label}: the profiler recorded no device time "
              f"(device busy share not measured)")
        return
    print(f"[profile] {label}: {what} wall {wall_us / 1e3:.3f} ms under the "
          f"profiler, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%); trace read in "
          f"{time.perf_counter() - t_read:.1f} s")
    for t_us, key, count in sorted(rows, reverse=True)[:top]:
        print(f"[profile] {label}: {t_us / 1e3:9.3f} ms "
              f"{100 * t_us / busy_us:5.1f}%  x{count:<5d} {key[:90]}")


def check_against_cpu(api, spec=None, label="tinycnn sl/scan int8",
                      data=None, deterministic=False):
    """A plan on the card (fused kernel) vs the same plan on the CPU (its
    plain version): same params and data; losses agree within 1e-3, wire
    bytes and the contraction FLOP counts exactly. ``spec`` defaults to
    tinycnn ``sl/scan`` with the int8 link; ``data`` is handed to both
    compiles; ``deterministic`` runs the card under cuDNN's deterministic
    algorithms (restored after)."""
    spec = spec or api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=3),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", link_kernel="fused"),
        global_rounds=2, batch_size=4)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic or was
    try:
        gpu = api.compile_experiment(spec, data=data)
        _, rec_gpu = gpu.run()
    finally:
        torch.backends.cudnn.deterministic = was
    cpu = api.compile_experiment(spec, data=data, device="cpu")
    _, rec_cpu = cpu.run()
    for g, c in zip(rec_gpu, rec_cpu):
        if abs(g.loss - c.loss) > 1e-3 or g.link_bytes != c.link_bytes:
            raise AssertionError(f"{label}: card vs CPU records differ: {g} "
                                 f"vs {c}")
    k = gpu.cut_of_client[0]
    if [f.contraction for f in gpu.flops[k][:2]] != \
            [f.contraction for f in cpu.flops[k][:2]]:
        raise AssertionError(f"{label}: card vs CPU contraction FLOP counts "
                             f"differ")
    print(f"[check] {label} on the card == on the CPU "
          f"(losses {[round(r.loss, 6) for r in rec_gpu]} vs "
          f"{[round(r.loss, 6) for r in rec_cpu]}, link bytes "
          f"{[r.link_bytes for r in rec_gpu]}, contractions "
          f"{[f.contraction for f in gpu.flops[k][:2]]})")


def paper_data(image_size: int, n_train: int, n_test: int):
    """``(x_train, y_train, x_test, y_test)`` from the port's
    ``SyntheticPestImages`` (12 classes, NHWC float32), seed 0."""
    import numpy as np

    from repro_torch.data.synthetic import SyntheticPestImages
    gen = SyntheticPestImages(num_classes=12, image_size=image_size)
    x, y = gen.sample(np.random.default_rng(0), n_train + n_test)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def paper_spec_fused(model: str, kind: str, fraction, **fields):
    """``paper_spec`` of ``model`` with the int8 link on the fused kernel
    (``paper_spec`` keeps the reference's ``"xla"`` seam)."""
    from repro_torch.core.paper_train import PaperTrainConfig, paper_spec
    cfg = PaperTrainConfig(model=model, compress_link=True,
                           client_fraction=fraction or 0.25, **fields)
    spec = paper_spec(cfg, kind)
    return dataclasses.replace(spec, engine=dataclasses.replace(
        spec.engine, link_kernel="fused"))


def check_paper_int8_shapes(dev) -> dict:
    """The link kernel at the paper's cuts' (rows, D) that no earlier
    phase runs (``PAPER_INT8``): its launch plan from the library equal to
    the Python copy's, and bit-equal to its plain version in f32 (NaN, inf
    and zero rows, with and without a residual); then timed L2 cold at
    ``PAPER_INT8_TIMED``. Returns the largest |kernel - plain| and the
    times by shape."""
    from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                                quant_dequant_int8_plain,
                                                quant_int8_device_plan,
                                                quant_int8_launch_plan)
    g = torch.Generator(device=dev).manual_seed(1)
    max_err = 0.0
    for m, d in PAPER_INT8:
        plan = quant_int8_device_plan(m, d, torch.float32)
        want = quant_int8_launch_plan(m, d, torch.float32)
        if any(plan[key] != want[key] for key in want):
            raise AssertionError(f"[paper] int8 launch plan at ({m}, {d}): "
                                 f"library {plan}, Python copy {want}")
        x = int8_input(m, d, torch.float32, dev, g, special=True)
        for r in (None, torch.randn(m, d, device=dev, generator=g)):
            got = quant_dequant_int8(x, residual=r)
            ref = quant_dequant_int8_plain(x, residual=r)
            torch.cuda.synchronize()
            if not same(got, ref):
                raise AssertionError(f"[paper] quant_dequant_int8 kernel != "
                                     f"plain at ({m}, {d}) f32 residual="
                                     f"{r is not None}")
            max_err = max(max_err, float(
                (got - ref).nan_to_num(0.0).abs().max()))
        print(f"[paper] int8 link ({m}, {d}) f32: {plan['path']} path, "
              f"G={plan['lanes_per_row']} V={plan['chunks_per_lane']}, "
              f"{plan['blocks']} blocks of {plan['rows_per_block']} rows, "
              f"{plan['blocks_per_sm']} resident an SM; bit-equal to the "
              f"plain version with and without a residual")
    times = {shape: time_quant_kernel(dev, *shape)
             for shape in PAPER_INT8_TIMED}
    return {"max_err": max_err, "times": times}


def paper_case(api, model: str, setting: str, kind: str, fraction,
               data) -> dict:
    """One case of the grid: compile, run ``PAPER_ROUNDS`` rounds,
    print the cut, each round, the held-out metrics, the energy sums and
    the int8 launches; SL launches one a client step, FL none."""
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    label = f"paper {model} {setting}"
    t0 = time.perf_counter()
    plan = api.compile_experiment(paper_spec_fused(
        model, kind, fraction, image_size=PAPER_IMAGE, num_clients=4,
        batch_size=16, global_rounds=PAPER_ROUNDS, local_steps=2),
        data=data)
    if kind == "sl":
        k = plan.cut_of_client[0]
        cut = (plan.stages[k - 1].name, tuple(plan.flops[k][2].shape))
        if cut != PAPER_SMASHED[(model, fraction)]:
            raise AssertionError(f"[{label}] cut {cut}, want "
                                 f"{PAPER_SMASHED[(model, fraction)]}")
        where = f"cut after {cut[0]} (stage {k}), smashed {cut[1]}"
    else:
        where = "the full model on every client"
    print(f"[{label}] compiled in {time.perf_counter() - t0:.2f} s: {where}")
    quant_dequant_int8.launches = 0
    state, recs = run_plan(plan, label)
    launches = quant_dequant_int8.launches
    spec = plan.spec
    want = (plan.num_rounds * spec.local_steps * spec.clients.num_clients
            if kind == "sl" else 0)
    sums = {f: sum(getattr(r, f) for r in recs)
            for f in ("client_time_s", "client_energy_j", "server_time_s",
                      "server_energy_j", "link_energy_j", "link_bytes")}
    print(f"[{label}] last_metrics "
          f"{ {key: round(v, 6) for key, v in state.last_metrics.items()} }; "
          f"sums over {plan.num_rounds} rounds {sums}; quant_dequant_int8 "
          f"launches {launches} (want {want}); case "
          f"{time.perf_counter() - t0:.2f} s")
    if launches != want:
        raise AssertionError(f"[{label}] launched the int8 kernel "
                             f"{launches} times, want {want}")
    if model != "mobilenetv2" and setting == "SL_25_75":
        profile_call(lambda: plan.run_round(state), label, "round",
                     cpu=False)
    return {"launches": launches, "rounds": plan.num_rounds, **sums,
            "metrics": dict(state.last_metrics)}


def run_paper_path(api, dev) -> dict:
    """The paper's experiment (``[paper]``): ``paper_spec`` of ResNet-18,
    GoogLeNet and MobileNetV2 under FL and SL_75_25 ... SL_15_85 at
    224x224 (``paper_case``), the link kernel at the new cut shapes, the
    client energy of each SL setting against FL in Table III's form, and
    ResNet-18 and GoogLeNet at 32x32 on the card against the CPU. Returns
    the int8 launches over the grid and the kernel's check and times."""
    import gc
    kernel = check_paper_int8_shapes(dev)
    data = paper_data(PAPER_IMAGE, PAPER_N_TRAIN, PAPER_N_TEST)
    cases = {}
    for model in PAPER_BACKBONES:
        for setting, kind, fraction in PAPER_SETTINGS:
            cases[(model, setting)] = paper_case(api, model, setting, kind,
                                                 fraction, data)
            gc.collect()
            torch.cuda.empty_cache()
    del data
    print(f"[paper] Table III form, the port's bill (summed over each "
          f"case's rounds; per round below), against the paper's headline "
          f"SL client-energy saving of up to "
          f"{100 * PAPER_SAVING_HEADLINE:.0f}% over FL:")
    best = 0.0
    for model in PAPER_BACKBONES:
        fl = cases[(model, "FL")]
        fl_round = fl["client_energy_j"] / fl["rounds"]
        for setting, _, _ in PAPER_SETTINGS:
            c = cases[(model, setting)]
            per_round = c["client_energy_j"] / c["rounds"]
            saving = 1.0 - per_round / fl_round
            if setting != "FL":
                best = max(best, saving)
            print(f"[paper] table {model:11s} {setting:8s} client "
                  f"{c['client_time_s'] / c['rounds']:.6g} s "
                  f"{per_round:.6g} J, server "
                  f"{c['server_time_s'] / c['rounds']:.6g} s "
                  f"{c['server_energy_j'] / c['rounds']:.6g} J, link "
                  f"{c['link_energy_j'] / c['rounds']:.6g} J "
                  f"{c['link_bytes'] / c['rounds']:.0f} B a round; client "
                  f"energy SL/FL {per_round / fl_round:.4f} (saving "
                  f"{100 * saving:.1f}%); accuracy "
                  f"{c['metrics']['accuracy']:.4f} f1 "
                  f"{c['metrics']['f1']:.4f} mcc {c['metrics']['mcc']:.4f}")
    print(f"[paper] largest SL client-energy saving over FL in the port's "
          f"bill: {100 * best:.1f}% (paper: up to "
          f"{100 * PAPER_SAVING_HEADLINE:.0f}%)")
    small = paper_data(32, 96, 24)
    for model, fraction in (("resnet18", 0.15), ("googlenet", 0.40)):
        check_against_cpu(api, paper_spec_fused(
            model, "sl", fraction, image_size=32, num_clients=2,
            global_rounds=1, local_steps=1, batch_size=4),
            f"{model} SL_{round(100 * fraction)}_"
            f"{round(100 * (1 - fraction))} 32x32 int8 (cudnn "
            f"deterministic)", data=small, deterministic=True)
    return {"launches": sum(c["launches"] for c in cases.values()),
            **kernel}


def lm_spec(api, arch, attn_impl: str, *, seq_len=1024, n_train=96,
            n_test=16, num_clients=4, batch_size=8, mission=True,
            client_axis="scan", dropout_rate=0.0, population=None):
    return api.ExperimentSpec(
        model=api.ModelSpec(family="transformer", arch=arch,
                            attn_impl=attn_impl),
        data=api.DataSpec(kind="tokens", partition="iid", seq_len=seq_len,
                          n_train=n_train, n_test=n_test),
        clients=api.ClientSpec(num_clients=num_clients,
                               dropout_rate=dropout_rate,
                               population=population),
        cut_policy=api.CutPolicy(fraction=0.25),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", client_axis=client_axis,
                              link_kernel="fused", server_reduce="mean"),
        mission=api.MissionSpec() if mission else None,
        global_rounds=2, local_steps=2, batch_size=batch_size, seed=0)


def run_lm_path(api) -> dict:
    """SmolLM-135M at full width through both kernels: launch counts over
    exactly the 2-round run, the FLOP bill against the "ref" plan's, one
    profiled round. Returns the launch counts."""
    from repro_torch.api.plan import LM_EVAL_CHUNK
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.kernels.quant.int8 import quant_dequant_int8

    t0 = time.perf_counter()
    lm = api.compile_experiment(lm_spec(api, smollm_135m, "pallas"))
    k = lm.cut_of_client[0]
    fl_c, fl_s, smashed = lm.flops[k]
    print(f"[lm] compiled in {time.perf_counter() - t0:.2f} s: "
          f"{smollm_135m.name} {smollm_135m.n_layers} layers, d "
          f"{smollm_135m.d_model}, vocab {smollm_135m.vocab}; cut {k}/"
          f"{smollm_135m.n_layers}, smashed {smashed.shape}; FLOPs per split "
          f"step client {float(fl_c):.6g}, server {float(fl_s):.6g}")
    flash_attention.launches = 0
    quant_dequant_int8.launches = 0
    lm_state, _ = run_plan(lm, "lm")
    launches = {"flash_attention": flash_attention.launches,
                "quant_dequant_int8": quant_dequant_int8.launches}
    spec = lm.spec
    steps = spec.local_steps * spec.clients.num_clients
    chunks = -(-len(lm.x_test) // LM_EVAL_CHUNK)
    n_layers = smollm_135m.n_layers
    want = {"flash_attention": lm.num_rounds * n_layers * (steps + chunks),
            "quant_dequant_int8": lm.num_rounds * steps}
    print(f"[lm] launches over the {lm.num_rounds}-round run: {launches} "
          f"(want {want}: {n_layers} x {steps} split steps + {n_layers} x "
          f"{chunks} evaluation chunks per round; one int8 boundary per "
          f"step)")
    if lm.num_rounds != 2 or launches != want:
        raise AssertionError(f"split-LM path launches {launches}, want {want}")
    profile_call(lambda: lm.run_round(lm_state), "lm", "round", cpu=False)
    del lm, lm_state
    torch.cuda.empty_cache()

    ref = api.compile_experiment(lm_spec(api, smollm_135m, "ref"))
    ref_flops = ref.flops[ref.cut_of_client[0]][:2]
    print(f"[lm] FLOPs per split step, pallas plan {[float(fl_c), float(fl_s)]}"
          f" == ref plan {[float(f) for f in ref_flops]}")
    if [float(fl_c), float(fl_s)] != [float(f) for f in ref_flops]:
        raise AssertionError("the pallas plan's FLOP bill differs from the "
                             "ref plan's")
    del ref
    torch.cuda.empty_cache()

    small = dict(seq_len=64, n_train=32, n_test=8, num_clients=2,
                 batch_size=4, mission=False)
    spec = lm_spec(api, smollm_135m.reduced(), "pallas", **small)
    _, rec_gpu = api.compile_experiment(spec).run()
    _, rec_cpu = api.compile_experiment(spec, device="cpu").run()
    for g, c in zip(rec_gpu, rec_cpu):
        if abs(g.loss - c.loss) > 1e-3 or g.link_bytes != c.link_bytes:
            raise AssertionError(f"reduced LM card vs CPU records differ: "
                                 f"{g} vs {c}")
    print(f"[check] reduced SmolLM sl/scan pallas+int8 on the card == on the "
          f"CPU (losses {[round(r.loss, 6) for r in rec_gpu]} vs "
          f"{[round(r.loss, 6) for r in rec_cpu]})")
    return launches


def check_vmap_rules(dev) -> dict:
    """The vmap rules of the fleet paths' two Functions on the card, over
    ``FLEET`` clients at the vmap paths' own shapes: the int8 boundary at
    both cuts (MobileNetV2's (16, 28, 28, 32) NHWC rows, SmolLM's
    (``LM_VMAP_BATCH``, 1024, 576)) and, over the 2 clients of a
    ``[hetero]`` bucket, at both of its cuts ((16, 112, 112, 32) and (16,
    112, 112, 16)); NaN, inf and zero rows; bit-equal to the plain version
    client by client, in ONE launch; flash attention at
    (``LM_VMAP_BATCH``, 9, 1024, 64) per client within 2e-5 of the plain
    version, in one launch, and its gradient (kernel forward + closed-form
    backward) within 2e-4 of autograd through the plain version client by
    client, both as ``vmap(grad)`` and as the engines take it: one vmapped
    forward and one autograd backward of the clients' summed losses.
    Returns the largest errors."""
    from torch.func import grad, vmap
    from repro_torch.kernels.attn.flash import (flash_attention,
                                                flash_attention_plain)
    from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                                quant_dequant_int8_plain)
    from repro_torch.kernels.quant.ops import make_link_compress
    g = torch.Generator(device=dev).manual_seed(6)
    compress = make_link_compress(kernel="fused")
    for shape in ((FLEET, 16, 28, 28, MAIN_D),
                  (FLEET, LM_VMAP_BATCH, 1024, LM_D)) + HETERO_INT8_SHAPES:
        x = torch.randn(shape, device=dev, generator=g) * 3
        x[1, 0, 2, 3] = float("nan")
        x[0, 1, 0, 0] = float("inf")
        x[1, 0, 0, 1] = 0.0
        before = quant_dequant_int8.launches
        got = vmap(compress)(x)
        torch.cuda.synchronize()
        launches = quant_dequant_int8.launches - before
        clients, d = shape[0], shape[-1]
        want = torch.stack([quant_dequant_int8_plain(x[c].reshape(-1, d))
                            .reshape(shape[1:]) for c in range(clients)])
        ok = same(got, want)
        print(f"[vmap-rules] int8 boundary vmapped over {clients} clients of "
              f"{tuple(shape[1:])} ({x.numel() // d} rows of {d}): "
              f"bit-equal to the plain version client by client {ok} (NaN, "
              f"inf and zero rows included), {launches} launch")
        if not ok or launches != 1:
            raise AssertionError(f"int8 vmap rule at {shape}: bit-equal "
                                 f"{ok}, {launches} launches")
        del x, got, want
    per_client = (LM_VMAP_BATCH,) + FLASH_MAIN[1:]
    q, k, v = (torch.randn((FLEET,) + per_client, device=dev, generator=g)
               for _ in range(3))

    def attend(a, b_, c):
        return flash_attention(a, b_, c, causal=True)

    before = flash_attention.launches
    got = vmap(attend)(q, k, v)
    torch.cuda.synchronize()
    launches = flash_attention.launches - before
    want = torch.stack([flash_attention_plain(q[c], k[c], v[c], causal=True)
                        for c in range(FLEET)])
    err = float((got - want).abs().max())
    print(f"[vmap-rules] flash_attention vmapped over {FLEET} clients of "
          f"{per_client} f32 causal: max_abs_err {err:.3e} (atol 2e-5), "
          f"{launches} launch at {FLASH_VMAP[0]}")
    if not (err <= 2e-5 and launches == 1):
        raise AssertionError(f"flash vmap rule: err {err}, {launches} "
                             f"launches")
    del q, k, v, got, want

    def loss(a, b_, c):
        o = attend(a, b_, c)
        return (o * torch.cos(o)).sum()

    def engine_grads(*ins):
        """The engines' form: one vmapped forward, one backward."""
        leaves = [t.clone().requires_grad_(True) for t in ins]
        vmap(loss)(*leaves).sum().backward()
        return [t.grad for t in leaves]

    gerr = {}
    for form, grads_of in (("vmap(grad)",
                            vmap(grad(loss, argnums=(0, 1, 2)))),
                           ("vmapped forward, one backward", engine_grads)):
        err_f = 0.0
        for shape in ((FLEET, 2, 3, 257, 64), (FLEET,) + per_client):
            ins = [torch.randn(shape, device=dev, generator=g)
                   for _ in range(3)]
            before = flash_attention.launches
            grads = grads_of(*ins)
            launches = flash_attention.launches - before
            for c in range(FLEET):
                leaves = [t[c].clone().requires_grad_(True) for t in ins]
                o = flash_attention_plain(*leaves, causal=True)
                (o * torch.cos(o)).sum().backward()
                for got_g, leaf in zip(grads, leaves):
                    err_f = max(err_f,
                                float((got_g[c] - leaf.grad).abs().max()))
                del leaves, o
            if launches != 1 or not err_f <= 2e-4:
                raise AssertionError(f"flash {form} at {shape}: err "
                                     f"{err_f}, {launches} launches")
            del ins, grads
        gerr[form] = err_f
        print(f"[vmap-rules] flash_attention gradient over {FLEET} clients "
              f"as {form} (one forward launch; closed-form backward) vs "
              f"autograd of the plain version client by client, "
              f"{per_client} per client included: max_abs_err "
              f"{err_f:.3e} (atol 2e-4)")
    torch.cuda.empty_cache()
    return {"flash": err, "flash_grad": max(gerr.values())}


def check_fleet_against_cpu(api, spec, label: str, cohorts=None,
                            env_draws=None):
    """``spec`` on the card against the same plan on the CPU (the kernels'
    plain versions), same params and data (and, for a population, the same
    ``Plan.cohorts``; for a scenario, the same ``Plan.env_draws``): losses
    within the reference's ``FLEET_EQUIV_ATOL``, each client's cut, active
    clients, wire bytes, link time and cohort ids exactly."""
    from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
    records, cuts = [], []
    for device in ("cuda", "cpu"):
        plan = api.compile_experiment(spec, device=device)
        plan.cohorts = cohorts
        plan.env_draws = env_draws
        records.append(plan.run()[1])
        cuts.append(plan.cut_of_client)
    rec_gpu, rec_cpu = records
    if cuts[0] != cuts[1]:
        raise AssertionError(f"{label}: cuts on the card {cuts[0]}, on the "
                             f"CPU {cuts[1]}")
    for a, b in zip(rec_gpu, rec_cpu):
        if (abs(a.loss - b.loss) > FLEET_EQUIV_ATOL
                or a.active_clients != b.active_clients
                or a.link_bytes != b.link_bytes
                or a.link_time_s != b.link_time_s
                or a.cohort_pids != b.cohort_pids):
            raise AssertionError(f"{label} card vs CPU records differ: {a} "
                                 f"vs {b}")
    print(f"[check] {label} on the card == on the CPU (losses "
          f"{[round(r.loss, 6) for r in rec_gpu]} vs "
          f"{[round(r.loss, 6) for r in rec_cpu]}, max_abs_diff "
          f"{max(abs(a.loss - b.loss) for a, b in zip(rec_gpu, rec_cpu)):.3e}"
          f", active clients {[r.active_clients for r in rec_gpu]})")


def run_fleet_cnn_paths(api) -> dict:
    """``sl/vmap`` (parallel SL, one server update a step on the clients'
    mean gradient) on MobileNetV2 with ``main_spec``, dropout
    ``FLEET_DROPOUT``, 2 rounds, then ``fl/vmap`` for one round: the int8
    launches over exactly the SL run (masked clients still run, so one a
    local step), a profiled round of each, SL's client energy below FL's
    in the first round (both draw the same masks), and a tinycnn
    ``sl/vmap`` run with dropout on the card against the CPU."""
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    t0 = time.perf_counter()
    sl = api.compile_experiment(main_spec(api, "sl", 2, client_axis="vmap",
                                          dropout_rate=FLEET_DROPOUT))
    print(f"[sl-vmap] compiled in {time.perf_counter() - t0:.2f} s: "
          f"{sl.engine_label}, dropout {FLEET_DROPOUT}, server_reduce "
          f"{sl.spec.engine.server_reduce}")
    quant_dequant_int8.launches = 0
    sl_state, sl_recs = run_plan(sl, "sl-vmap")
    launches = {"quant_dequant_int8": quant_dequant_int8.launches}
    want = sl.num_rounds * sl.spec.local_steps
    print(f"[sl-vmap] quant_dequant_int8 launches over the "
          f"{sl.num_rounds}-round run: {launches['quant_dequant_int8']} "
          f"(want {want}: one a local step for all {FLEET} clients, masked "
          f"ones included)")
    if sl.num_rounds != 2 or launches["quant_dequant_int8"] != want:
        raise AssertionError(f"sl/vmap launched the int8 kernel {launches}, "
                             f"want {want}")
    profile_call(lambda: sl.run_round(sl_state), "sl-vmap", "round",
                 cpu=False)
    del sl, sl_state
    check_fleet_against_cpu(api, api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=3, dropout_rate=0.34),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", client_axis="vmap",
                              link_kernel="fused"),
        global_rounds=3, batch_size=4), "tinycnn sl/vmap int8 dropout")
    stamp("sl/vmap path")

    fl = api.compile_experiment(main_spec(api, "fl", 1, client_axis="vmap",
                                          dropout_rate=FLEET_DROPOUT))
    quant_dequant_int8.launches = 0
    fl_state, fl_recs = run_plan(fl, "fl-vmap")
    fl_launches = {"quant_dequant_int8": quant_dequant_int8.launches}
    profile_call(lambda: fl.run_round(fl_state), "fl-vmap", "round",
                 cpu=False)
    del fl, fl_state
    sl_client = sl_recs[0].client_energy_j
    fl_client = fl_recs[0].client_energy_j
    print(f"[fl-vmap] client energy in round 0 ({sl_recs[0].active_clients} "
          f"and {fl_recs[0].active_clients} active): SL {sl_client:.6g} J "
          f"< FL {fl_client:.6g} J; int8 launches {fl_launches} (FL has no "
          f"link)")
    if not (sl_client < fl_client and fl_launches["quant_dequant_int8"] == 0
            and sl_recs[0].active_clients == fl_recs[0].active_clients):
        raise AssertionError("fl/vmap: SL client energy is not below FL's "
                             "on the same clients, or FL launched the link")
    torch.cuda.empty_cache()
    stamp("fl/vmap path")
    return {"sl-vmap": launches, "fl-vmap": fl_launches}


def run_lm_vmap_path(api) -> dict:
    """SmolLM-135M at full width on ``sl/vmap`` with ``lm_spec`` at batch
    ``LM_VMAP_BATCH``: the flash and int8 launches over exactly the 2-round
    run (one flash launch a layer a local step for all clients, plus the
    evaluation's; one int8 launch a local step), the peak memory, one
    profiled round, and a reduced SmolLM ``sl/vmap`` with dropout on the
    card against the CPU."""
    import gc

    from repro_torch.api.plan import LM_EVAL_CHUNK
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = api.compile_experiment(lm_spec(api, smollm_135m, "pallas",
                                        client_axis="vmap",
                                        batch_size=LM_VMAP_BATCH))
    print(f"[lm-vmap] compiled in {time.perf_counter() - t0:.2f} s: "
          f"{lm.engine_label}, {lm.spec.clients.num_clients} clients x batch "
          f"{lm.spec.batch_size} x {lm.spec.data.seq_len} tokens")
    flash_attention.launches = 0
    quant_dequant_int8.launches = 0
    lm_state, _ = run_plan(lm, "lm-vmap")
    launches = {"flash_attention": flash_attention.launches,
                "quant_dequant_int8": quant_dequant_int8.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = lm.spec.local_steps
    chunks = -(-len(lm.x_test) // LM_EVAL_CHUNK)
    n_layers = smollm_135m.n_layers
    want = {"flash_attention": lm.num_rounds * n_layers * (steps + chunks),
            "quant_dequant_int8": lm.num_rounds * steps}
    print(f"[lm-vmap] launches over the {lm.num_rounds}-round run: "
          f"{launches} (want {want}: {n_layers} x {steps} local steps, all "
          f"{FLEET} clients in each launch, + {n_layers} x {chunks} "
          f"evaluation chunks per round; one int8 boundary a local step); "
          f"peak memory {peak / 2 ** 30:.2f} GiB ({peak} bytes)")
    if lm.num_rounds != 2 or launches != want:
        raise AssertionError(f"sl/vmap LM launches {launches}, want {want}")
    profile_call(lambda: lm.run_round(lm_state), "lm-vmap", "round",
                 cpu=False)
    del lm, lm_state
    gc.collect()
    torch.cuda.empty_cache()
    check_fleet_against_cpu(
        api, lm_spec(api, smollm_135m.reduced(), "pallas", seq_len=64,
                     n_train=32, n_test=8, num_clients=2, batch_size=4,
                     mission=False, client_axis="vmap",
                     dropout_rate=FLEET_DROPOUT),
        "reduced SmolLM sl/vmap pallas+int8 dropout")
    return {"lm-vmap": launches, "peak_bytes": peak}


def run_cohort_paths(api) -> dict:
    """Population cohorts on the fleet engines: MobileNetV2 ``sl/vmap``
    (the EPSL shared client tier) with ``main_spec`` at a population of
    ``COHORT_POPULATION``, cohort 4, dropout ``FLEET_DROPOUT``, 2 rounds
    (one int8 launch a local step, each round's cohort printed), its
    engine state after ``init()`` equal in bytes at populations of 10,000
    and 1,000,000; ``fl/vmap`` for one round on the same cohort, SL's
    client energy below FL's; SmolLM-135M ``sl/vmap`` on the shared tier
    at a population of 10,000 and batch ``LM_VMAP_BATCH``, 1 round (one
    flash launch a layer a local step for the cohort, plus the
    evaluation's; one int8 launch a local step), its peak memory; and a
    tinycnn ``sl/vmap`` cohort run on the card against the CPU with the
    same ``Plan.cohorts``."""
    import gc

    from repro_torch.api.plan import LM_EVAL_CHUNK
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    from repro_torch.obs import tensor_bytes
    from repro_torch.sim.scenario import cohort_generator, sample_cohort

    sizes = {}
    for pop in (10_000, COHORT_POPULATION):
        t0 = time.perf_counter()
        sl = api.compile_experiment(main_spec(
            api, "sl", 2, client_axis="vmap", dropout_rate=FLEET_DROPOUT,
            population=pop))
        sizes[pop] = tensor_bytes(sl.init().engine_state)
        print(f"[cohort] sl/vmap MobileNetV2 compiled in "
              f"{time.perf_counter() - t0:.2f} s: population {pop}, cohort "
              f"{sl.spec.clients.num_clients}, {len(sl.parts)} partitions, "
              f"client tier {sl._engine.client_tier}; engine state "
              f"{sizes[pop]} bytes after init()")
    if sizes[10_000] != sizes[COHORT_POPULATION]:
        raise AssertionError(f"cohort engine state depends on the "
                             f"population: {sizes}")
    quant_dequant_int8.launches = 0
    sl_state, sl_recs = run_plan(sl, "cohort-sl")
    launches = {"quant_dequant_int8": quant_dequant_int8.launches}
    want = sl.num_rounds * sl.spec.local_steps
    print(f"[cohort] sl/vmap cohorts {[r.cohort_pids for r in sl_recs]}; "
          f"quant_dequant_int8 launches over the {sl.num_rounds}-round run: "
          f"{launches['quant_dequant_int8']} (want {want}: one a local step "
          f"for the cohort)")
    if (sl.num_rounds != 2 or launches["quant_dequant_int8"] != want
            or any(len(r.cohort_pids) != 4 for r in sl_recs)):
        raise AssertionError(f"cohort sl/vmap launched the int8 kernel "
                             f"{launches}, want {want}, or lost its cohort")
    del sl, sl_state

    fl = api.compile_experiment(main_spec(
        api, "fl", 1, client_axis="vmap", dropout_rate=FLEET_DROPOUT,
        population=COHORT_POPULATION))
    quant_dequant_int8.launches = 0
    fl_state, fl_recs = run_plan(fl, "cohort-fl")
    fl_launches = {"quant_dequant_int8": quant_dequant_int8.launches}
    del fl, fl_state
    sl_client = sl_recs[0].client_energy_j
    fl_client = fl_recs[0].client_energy_j
    print(f"[cohort] client energy in round 0 (cohort "
          f"{fl_recs[0].cohort_pids}, {sl_recs[0].active_clients} and "
          f"{fl_recs[0].active_clients} active): SL {sl_client:.6g} J < FL "
          f"{fl_client:.6g} J; FL int8 launches {fl_launches}")
    if not (sl_client < fl_client and fl_launches["quant_dequant_int8"] == 0
            and sl_recs[0].cohort_pids == fl_recs[0].cohort_pids
            and sl_recs[0].active_clients == fl_recs[0].active_clients):
        raise AssertionError("cohort fl/vmap: SL client energy is not below "
                             "FL's on the same cohort, or FL launched the "
                             "link")
    gc.collect()
    torch.cuda.empty_cache()
    stamp("cohort CNN paths")

    torch.cuda.reset_peak_memory_stats()
    spec = lm_spec(api, smollm_135m, "pallas", client_axis="vmap",
                   batch_size=LM_VMAP_BATCH, population=10_000)
    spec = dataclasses.replace(spec, global_rounds=1)
    t0 = time.perf_counter()
    lm = api.compile_experiment(spec)
    print(f"[cohort] sl/vmap SmolLM-135M compiled in "
          f"{time.perf_counter() - t0:.2f} s: population 10000, cohort "
          f"{lm.spec.clients.num_clients} x batch {lm.spec.batch_size} x "
          f"{lm.spec.data.seq_len} tokens, client tier "
          f"{lm._engine.client_tier}")
    flash_attention.launches = 0
    quant_dequant_int8.launches = 0
    _, lm_recs = run_plan(lm, "cohort-lm")
    lm_launches = {"flash_attention": flash_attention.launches,
                   "quant_dequant_int8": quant_dequant_int8.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = lm.spec.local_steps
    chunks = -(-len(lm.x_test) // LM_EVAL_CHUNK)
    n_layers = smollm_135m.n_layers
    want = {"flash_attention": lm.num_rounds * n_layers * (steps + chunks),
            "quant_dequant_int8": lm.num_rounds * steps}
    print(f"[cohort] sl/vmap SmolLM-135M cohort {lm_recs[0].cohort_pids}; "
          f"launches over the {lm.num_rounds}-round run: {lm_launches} "
          f"(want {want}); peak memory {peak / 2 ** 30:.2f} GiB ({peak} "
          f"bytes)")
    if lm.num_rounds != 1 or lm_launches != want:
        raise AssertionError(f"cohort SmolLM launches {lm_launches}, want "
                             f"{want}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()

    cohorts = [tuple(int(p) for p in sample_cohort(
        cohort_generator(7, r), 10_000, 3)) for r in range(3)]
    check_fleet_against_cpu(api, api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=3, dropout_rate=0.34,
                               population=10_000),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", client_axis="vmap",
                              link_kernel="fused"),
        global_rounds=3, batch_size=4), "tinycnn sl/vmap cohort int8 dropout",
        cohorts=cohorts)
    return {"cohort-sl": launches, "cohort-fl": fl_launches,
            "cohort-lm": lm_launches, "cohort_lm_peak_bytes": peak,
            "state_bytes": sizes}


def run_hetero_path(api) -> dict:
    """Per-client adaptive cuts on ``sl/vmap``: MobileNetV2 with
    ``main_spec(adaptive=True)`` (edges Jetson AGX Orin and MCU cycled over
    the 4 clients), dropout ``FLEET_DROPOUT``, int8 on the fused kernel and
    the UAV mission, whose dwell gives the per-step link deadline, 2
    rounds: the cuts must be ``HETERO_CUTS`` (two buckets of 2 clients,
    each its own fleet round and server suffix), the int8 launches over
    exactly that run one a local step a bucket (masked clients, and a
    bucket with no active client, still run), each round's wall time and
    record, the buckets' state bytes, one profiled round, and a tinycnn
    run with per-client cuts on the card against the CPU."""
    import gc

    from repro_torch.api.runtime import mission_max_link_s
    from repro_torch.core.energy import JETSON_AGX_ORIN
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    from repro_torch.obs import tensor_bytes
    t0 = time.perf_counter()
    plan = api.compile_experiment(main_spec(
        api, "sl", 2, client_axis="vmap", dropout_rate=FLEET_DROPOUT,
        adaptive=True))
    spec = plan.spec
    deadline = mission_max_link_s(spec.mission.hover_s_per_stop,
                                  spec.mission.comm_s_per_stop,
                                  spec.local_steps)
    buckets = plan._engine.fleet.buckets
    print(f"[hetero] compiled in {time.perf_counter() - t0:.2f} s: "
          f"{plan.engine_label}, link deadline {deadline} s a step, "
          f"cut_of_client {plan.cut_of_client}, buckets "
          f"{[(b.cut_index, b.client_ids) for b in buckets]}, smashed "
          f"{ {k: plan.flops[k][2].shape for k in sorted(plan.flops)} }")
    if plan.cut_of_client != HETERO_CUTS:
        raise AssertionError(f"[hetero] cuts {plan.cut_of_client}, want "
                             f"{HETERO_CUTS}")
    quant_dequant_int8.launches = 0
    state, _ = run_plan(plan, "hetero")
    launches = {"quant_dequant_int8": quant_dequant_int8.launches}
    want = plan.num_rounds * spec.local_steps * len(buckets)
    sizes = [tensor_bytes(st) for st in state.engine_state]
    print(f"[hetero] quant_dequant_int8 launches over the "
          f"{plan.num_rounds}-round run: {launches['quant_dequant_int8']} "
          f"(want {want}: one a local step a bucket, each for its 2 "
          f"clients); buckets' state bytes {sizes}")
    if plan.num_rounds != 2 or launches["quant_dequant_int8"] != want:
        raise AssertionError(f"[hetero] launched the int8 kernel "
                             f"{launches}, want {want}")
    profile_call(lambda: plan.run_round(state), "hetero", "round", cpu=False)
    del plan, state
    gc.collect()
    torch.cuda.empty_cache()
    check_fleet_against_cpu(api, api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=4, dropout_rate=0.3,
                               edge_profiles=(JETSON_AGX_ORIN,
                                              mcu_profile())),
        cut_policy=api.CutPolicy(mode="adaptive"),
        link_policy=api.LinkPolicy(compress="int8", rate_bps=1e6),
        engine=api.EngineSpec(kind="sl", client_axis="vmap",
                              link_kernel="fused"),
        global_rounds=3, batch_size=4),
        "tinycnn sl/vmap per-client cuts [2, 1, 2, 1] int8 dropout")
    return {"hetero": launches, "state_bytes": sizes}


def stoch_scenario(sim):
    """The reference tests' stochastic scenario (``tests/test_sim.py``):
    the ``a2g`` channel at its defaults, markov availability, two UAVs
    relaying from their partitions' centroids, seed 1."""
    return sim.ScenarioSpec(
        channel=sim.ChannelParams(kind="a2g"),
        availability=sim.AvailabilityParams(kind="markov", p_drop=0.4,
                                            p_recover=0.6),
        num_uavs=2, serve_mode="relay", seed=1)


def check_seed_rule(dev):
    """The int8 boundary through the seed axis's nested ``vmap`` rule at
    the ``[mc]`` sweep's shape (``MC_SEEDS`` seeds x ``FLEET`` clients of
    the MobileNetV2 cut, (200,704, 32) rows): NaN, inf and zero rows,
    bit-equal to the plain version seed by seed and client by client, in
    ONE launch."""
    from torch.func import vmap
    from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                                quant_dequant_int8_plain)
    from repro_torch.kernels.quant.ops import make_link_compress
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(MC_INT8_SHAPE, device=dev, generator=g) * 3
    x[3, 1, 0, 2, 3] = float("nan")
    x[0, 2, 1, 0, 0] = float("inf")
    x[2, 0, 0, 0, 1] = 0.0
    before = quant_dequant_int8.launches
    got = vmap(vmap(make_link_compress(kernel="fused")))(x)
    torch.cuda.synchronize()
    launches = quant_dequant_int8.launches - before
    want = torch.stack([torch.stack([
        quant_dequant_int8_plain(x[s_, c].reshape(-1, MAIN_D))
        .reshape(MC_INT8_SHAPE[2:]) for c in range(FLEET)])
        for s_ in range(MC_SEEDS)])
    ok = same(got, want)
    print(f"[vmap-rules] int8 boundary through the nested (seed, client) "
          f"vmap rule, {MC_SEEDS} seeds x {FLEET} clients of "
          f"{MC_INT8_SHAPE[2:]} ({MC_INT8[0]} rows of {MC_INT8[1]}): "
          f"bit-equal to the plain version seed by seed, client by client "
          f"{ok} (NaN, inf and zero rows included), {launches} launch")
    if not ok or launches != 1:
        raise AssertionError(f"nested int8 vmap rule: bit-equal {ok}, "
                             f"{launches} launches")


def run_scenario_path(api):
    """``sl/vmap`` on MobileNetV2 (``main_spec``, no dropout) under
    ``stoch_scenario``, 2 rounds: the timeline, each round's mask and rate
    ratios (nominal / sampled) and record, the int8 launches over exactly
    that run (one a local step), and tinycnn under the same scenario on
    the card against the CPU from the same injected draws. Returns the
    plan (the [mc] phase sweeps it) and the launch count."""
    import numpy as np
    from repro_torch import sim
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    from repro_torch.sim.scenario import availability_step
    from repro_torch.sim.streams import draw_env
    t0 = time.perf_counter()
    plan = api.compile_experiment(dataclasses.replace(
        main_spec(api, "sl", 2, client_axis="vmap"),
        scenario=stoch_scenario(sim)))
    tl = plan.timeline
    print(f"[scenario] compiled in {time.perf_counter() - t0:.2f} s: "
          f"{plan.engine_label}, {tl.num_uavs} UAVs relaying, rounds budget "
          f"{plan.rounds_budget}, routes "
          f"{[r.client_ids for r in tl.routes]}, serve distances "
          f"{np.round(plan.serve_dist_m, 3).tolist()} m, nominal rates "
          f"{np.round(plan.rate_nominal / 1e6, 3).tolist()} Mb/s, round "
          f"{tl.round_duration_s:.1f} s on the mission clock")
    quant_dequant_int8.launches = 0
    state = plan.init()
    records = []
    for _ in range(plan.num_rounds):
        env = plan.round_env(state.round)
        mask, _ = availability_step(env.mask, state.avail_up,
                                    plan.spec.scenario.availability)
        ratio = plan._round_rate_ratio(env)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rec = plan.run_round(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[scenario] round {rec.round} wall_s={wall:.4f} mask "
              f"{mask.astype(int).tolist()} rate ratios "
              f"{np.round(ratio, 4).tolist()} "
              f"record={json.dumps(rec.to_dict())}")
        if not math.isfinite(rec.loss) or rec.active_clients != mask.sum():
            raise AssertionError(f"[scenario] round {rec.round}: {rec}")
        records.append(rec)
    launches = quant_dequant_int8.launches
    want = plan.num_rounds * plan.spec.local_steps
    print(f"[scenario] quant_dequant_int8 launches over the "
          f"{plan.num_rounds}-round run: {launches} (want {want}: one a "
          f"local step for all {FLEET} clients)")
    if plan.num_rounds != 2 or launches != want:
        raise AssertionError(f"[scenario] launched the int8 kernel "
                             f"{launches} times, want {want}")
    spec = api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=4),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", client_axis="vmap",
                              link_kernel="fused"),
        mission=api.MissionSpec(), scenario=stoch_scenario(sim),
        global_rounds=3, batch_size=4)
    draws = [draw_env(7, r, mask_n=4, rates_n=4) for r in range(3)]
    check_fleet_against_cpu(api, spec, "tinycnn sl/vmap under the "
                            "stochastic scenario, injected draws",
                            env_draws=draws)
    return plan, launches


def mc_modes(plan, label: str, want: dict) -> tuple:
    """``run_monte_carlo(plan, MC_SEEDS, rounds=MC_ROUNDS)`` in both modes
    with cuDNN's default algorithms, each printed with its fenced wall time
    (after its warm-up round), the seconds with that round, the peak memory
    and the int8 launches, which must equal ``want[mode]``; then both modes
    again with cuDNN's deterministic algorithms. Returns ``({mode:
    (result, launches, peak, phase_s)}, {mode: deterministic result})``."""
    import numpy as np
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    from repro_torch.sim import run_monte_carlo
    out, det = {}, {}
    for mode in ("vmap", "loop"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        quant_dequant_int8.launches = 0
        t0 = time.perf_counter()
        mc = run_monte_carlo(plan, MC_SEEDS, rounds=MC_ROUNDS, mode=mode)
        phase_s = time.perf_counter() - t0
        launches = quant_dequant_int8.launches
        peak = torch.cuda.max_memory_allocated()
        s = mc.stacks
        print(f"[{label}] {mode}: {MC_SEEDS} seeds x {MC_ROUNDS} rounds, "
              f"wall_s={mc.wall_s:.4f} (fenced, after one warm-up round; "
              f"{phase_s:.2f} s with it), peak "
              f"{peak / 2 ** 30:.2f} GiB, quant_dequant_int8 launches "
              f"{launches} (want {want[mode]}); loss "
              f"{s['loss'].round(6).tolist()}, active clients "
              f"{s['active_clients'].tolist()}, link_time_s "
              f"{s['link_time_s'].tolist()}, final accuracy "
              f"{s['final_accuracy'].tolist()}")
        if not np.isfinite(s["loss"]).all() or launches != want[mode]:
            raise AssertionError(f"[{label}] {mode}: non-finite losses or "
                                 f"{launches} int8 launches")
        out[mode] = (mc, launches, peak, phase_s)
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("vmap", "loop"):
            det[mode] = run_monte_carlo(plan, MC_SEEDS, rounds=MC_ROUNDS,
                                        mode=mode)
    finally:
        torch.backends.cudnn.deterministic = False
    return out, det


def mc_agreement(out: dict, det: dict) -> tuple:
    """The two modes seed by seed: ``(exact, equal, diff, diff_det)``, the
    stacks held exactly (all but the losses and accuracies), whether they
    are equal in both runs of each mode and across the two algorithms, and
    the losses' max_abs_diff by round with cuDNN's default and its
    deterministic algorithms."""
    import numpy as np
    v, l = out["vmap"][0], out["loop"][0]
    exact = [k for k in v.stacks if k not in ("loss", "final_accuracy")]
    pairs = ((v, l), (det["vmap"], det["loop"]), (v, det["vmap"]))
    equal = all(np.array_equal(a.stacks[k], b.stacks[k]) for k in exact
                for a, b in pairs)
    diff = np.abs(v.stacks["loss"] - l.stacks["loss"]).max(axis=0)
    diff_det = np.abs(det["vmap"].stacks["loss"]
                      - det["loop"].stacks["loss"]).max(axis=0)
    return exact, equal, diff, diff_det


def run_mc_path(plan) -> dict:
    """``run_monte_carlo(plan, MC_SEEDS, rounds=MC_ROUNDS)`` in both modes
    on the [scenario] plan (``mc_modes``), timed with cuDNN's default
    algorithms: each mode's fenced wall time, the phase's seconds, the peak
    memory and the int8 launches (``vmap``: one a local step for all seeds
    and clients, its warm-up round's included); per seed the masks, active
    clients, bytes and bills equal, the first round's losses within
    ``FLEET_EQUIV_ATOL``. cuDNN's default algorithms are not reproducible
    run to run, and at this width the loop against itself (run once more
    and printed) drifts past ``FLEET_EQUIV_ATOL`` by the second round
    (PERF.md, ROADMAP fault H): so both modes run again with cuDNN's
    deterministic algorithms, bitwise reproducible run to run, and there
    every round's losses must agree within ``FLEET_EQUIV_ATOL``."""
    import numpy as np
    from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
    from repro_torch.sim import run_monte_carlo
    steps = plan.spec.local_steps
    out, det = mc_modes(plan, "mc", {
        "vmap": (1 + MC_ROUNDS) * steps,
        "loop": (1 + MC_SEEDS * MC_ROUNDS) * steps})
    # the loop once more, same code and inputs: its drift against itself
    again = run_monte_carlo(plan, MC_SEEDS, rounds=MC_ROUNDS, mode="loop")
    v, l = out["vmap"][0], out["loop"][0]
    self_drift = np.abs(again.stacks["loss"] - l.stacks["loss"]).max(axis=0)
    exact, equal, diff, diff_det = mc_agreement(out, det)
    print(f"[mc] vmap == loop seed by seed: {exact} equal {equal}; loss "
          f"max_abs_diff by round, default algorithms "
          f"{[f'{x:.3e}' for x in diff]} (round 0 gated at "
          f"{FLEET_EQUIV_ATOL}; the loop against itself "
          f"{[f'{x:.3e}' for x in self_drift]}), deterministic algorithms "
          f"{[f'{x:.3e}' for x in diff_det]} (gated at {FLEET_EQUIV_ATOL}); "
          f"wall loop/vmap {l.wall_s / v.wall_s:.3f}")
    if not (equal and diff[0] <= FLEET_EQUIV_ATOL
            and diff_det.max() <= FLEET_EQUIV_ATOL
            and len(np.unique(v.stacks["active_clients"])) > 1):
        raise AssertionError("[mc] the two modes disagree")
    torch.cuda.empty_cache()
    return {"mc-vmap": out["vmap"][1], "wall": (v.wall_s, l.wall_s),
            "peak": (out["vmap"][2], out["loop"][2]),
            "phase_s": (out["vmap"][3], out["loop"][3]),
            "det": {mode: det[mode].stacks for mode in det}}


def channel_scenario(sim):
    """``stoch_scenario`` without its availability trace, which the scan
    engines refuse: the ``a2g`` channel, two UAVs relaying, seed 1."""
    return sim.ScenarioSpec(channel=sim.ChannelParams(kind="a2g"),
                            num_uavs=2, serve_mode="relay", seed=1)


def run_mc_scan_path(api) -> dict:
    """``run_monte_carlo`` on the scan engines ([mc-scan]), ``MC_SEEDS``
    seeds x ``MC_ROUNDS`` rounds in both modes (``mc_modes``), gated as
    ``run_mc_path`` is. (a) MobileNetV2 on ``sl/scan`` (``main_spec``:
    Algorithm 3, the int8 link on the fused kernel, the UAV mission) under
    ``channel_scenario``: nothing drawn a seed reaches the engine, so the
    ``vmap`` mode runs the plan's own round once a round for all seeds, and
    the int8 kernel launches once a client step, warm-up round included;
    the seeds' losses and accuracies are bit-equal, their bills each
    seed's channel's. (b) ``main_spec`` on ``fl/scan`` with a cohort of 4
    out of ``COHORT_POPULATION``, each seed its own: the seed axis
    (``core.split.make_fl_seeds_round``), one program a client step for
    all seeds; no kernel (FL has no link), and the seeds' losses differ.
    Each part's wall times, their ratio and the peaks are printed beside
    the card's name and power limit."""
    import numpy as np
    from repro_torch import sim
    from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
    card = card_line()
    res = {}
    for part, kind in (("a", "sl"), ("b", "fl")):
        label = f"mc-scan {part}"
        t0 = time.perf_counter()
        if kind == "sl":
            plan = api.compile_experiment(dataclasses.replace(
                main_spec(api, "sl", MC_ROUNDS),
                scenario=channel_scenario(sim)))
        else:
            plan = api.compile_experiment(main_spec(
                api, "fl", MC_ROUNDS, population=COHORT_POPULATION))
        spec = plan.spec
        per_round = (spec.clients.num_clients * spec.local_steps
                     if kind == "sl" else 0)
        print(f"[{label}] compiled in {time.perf_counter() - t0:.2f} s: "
              f"{plan.engine_label}, population {spec.clients.population}")
        out, det = mc_modes(plan, label, {
            "vmap": (1 + MC_ROUNDS) * per_round,
            "loop": (1 + MC_SEEDS * MC_ROUNDS) * per_round})
        exact, equal, diff, diff_det = mc_agreement(out, det)
        v, l = out["vmap"][0], out["loop"][0]
        loss = v.stacks["loss"]
        if kind == "sl":
            # one trajectory: every seed's row is seed 0's, in both runs
            seeds_ok = all((r.stacks[k] == r.stacks[k][:1]).all()
                           for r in (v, det["vmap"])
                           for k in ("loss", "final_accuracy"))
            what = "seed rows bit-equal"
        else:
            seeds_ok = len(np.unique(loss[:, -1])) > 1
            what = "seeds' losses differ"
        ratio = l.wall_s / v.wall_s
        print(f"[{label}] vmap == loop seed by seed: {exact} equal {equal}; "
              f"loss max_abs_diff by round, default algorithms "
              f"{[f'{x:.3e}' for x in diff]} (round 0 gated at "
              f"{FLEET_EQUIV_ATOL}), deterministic algorithms "
              f"{[f'{x:.3e}' for x in diff_det]} (gated at "
              f"{FLEET_EQUIV_ATOL}); {what} {seeds_ok}; wall vmap/loop "
              f"{v.wall_s:.4f}/{l.wall_s:.4f} s, loop/vmap {ratio:.3f}, "
              f"peak vmap/loop {out['vmap'][2] / 2 ** 30:.2f}/"
              f"{out['loop'][2] / 2 ** 30:.2f} GiB; {card}")
        if not (equal and diff[0] <= FLEET_EQUIV_ATOL
                and diff_det.max() <= FLEET_EQUIV_ATOL and seeds_ok):
            raise AssertionError(f"[{label}] the two modes disagree")
        res[part] = {"launches": out["vmap"][1], "ratio": ratio,
                     "wall": (v.wall_s, l.wall_s),
                     "peak": (out["vmap"][2], out["loop"][2])}
        del plan, out, det, v, l
        torch.cuda.empty_cache()
    return res


OBS_RUN_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "results", "runs")       # git-ignored
OBS_QERR_RTOL = 1e-5
NON_METRIC_FIELDS = ("round", "loss", "accuracy", "link_bytes",
                     "link_time_s", "link_energy_j", "client_energy_j",
                     "server_energy_j", "uav_energy_j", "client_time_s",
                     "server_time_s", "active_clients", "engine",
                     "cohort_pids")


def poison(batches, client: int, step: int) -> dict:
    """An SL batch stack with NaN planted at one (client, local step), the
    reference tests' ``_poison``."""
    bx = batches["inputs"].clone()
    bx[client, step] = float("nan")
    return {"inputs": bx, "targets": batches["targets"]}


def same_tensors(a, b) -> bool:
    """Every tensor of two engine states (dicts, tuples, ``OptState``s)
    bit-equal."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tensors(a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_tensors(x, y)
                                        for x, y in zip(a, b))
    if dataclasses.is_dataclass(a):
        return all(same_tensors(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


def load_events(run_dir: str) -> list:
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def obs_sl_vmap(api, run_id: str) -> dict:
    """MobileNetV2 ``sl/vmap`` (``main_spec``, dropout ``FLEET_DROPOUT``),
    2 rounds with telemetry and the full tap set (round 1 under the
    profiler), then the same 2 rounds without telemetry, same ``params0``
    and batches. Checks: the non-metric record fields and the engine
    state bit-equal, 4 int8 launches in each run, no nonfinite slot, round
    0's ``quant_error/mean`` against the RMS of the plain version's
    output minus its input on the boundary tensors the kernel saw, 0
    kernel builds in every gauge window, the gauges' ``state_bytes``
    equal to ``tensor_bytes`` of the engine state, ``round/execute``'s
    ``0 < sync_s <= dur_s``, the profiler's trace holding the int8
    kernel, and ``tools/obs_report.py --coverage-min 0.95 --health-gate``
    exiting 0. The round wall times of both runs are printed, not gated."""
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.kernels.quant.int8 import (quant_dequant_int8,
                                                quant_dequant_int8_plain)
    import numpy as np
    from repro_torch.obs import MetricsConfig, ObsConfig, tensor_bytes
    from repro_torch.obs.timeline import time_fenced
    spec = main_spec(api, "sl", 2, client_axis="vmap",
                     dropout_rate=FLEET_DROPOUT)
    on = api.compile_experiment(spec, obs=ObsConfig(
        run_root=OBS_RUN_ROOT, run_id=run_id, metrics=MetricsConfig(),
        profile_rounds=(1, 1)))
    off = api.compile_experiment(spec)
    off.params0 = on.params0
    steps = spec.local_steps
    # the boundary's inputs of round 0, for the quant_error recomputation
    seen = []
    kernel_call = quant_ops.quant_dequant

    def keep_input(x, *, kernel="xla"):
        if len(seen) < steps:
            seen.append(x.detach().clone())
        return kernel_call(x, kernel=kernel)

    quant_ops.quant_dequant = keep_input
    quant_dequant_int8.launches = 0
    try:
        state_on, recs_on = on.run()
    finally:
        quant_ops.quant_dequant = kernel_call
    launches_on = quant_dequant_int8.launches
    on.obs.close()
    quant_dequant_int8.launches = 0
    state_off, recs_off, walls_off = off.init(), [], []
    for _ in range(off.num_rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state_off, rec = off.run_round(state_off)
        torch.cuda.synchronize()
        walls_off.append(time.perf_counter() - t0)
        recs_off.append(rec)
    launches_off = quant_dequant_int8.launches
    want = off.num_rounds * steps

    fields_equal = all(getattr(a, f) == getattr(b, f) for a, b in
                       zip(recs_on, recs_off) for f in NON_METRIC_FIELDS)
    state_equal = same_tensors(state_on.engine_state, state_off.engine_state)
    rms = [torch.sqrt(torch.mean(torch.square(
        quant_dequant_int8_plain(x[c].reshape(-1, x.shape[-1])).float()
        - x[c].reshape(-1, x.shape[-1]).float()))).item()
        for x in seen for c in range(x.shape[0])]
    want_qerr = float(np.mean(rms))
    qerr = recs_on[0].metrics["quant_error/mean"]
    qerr_rel = abs(qerr - want_qerr) / want_qerr
    events = load_events(on.obs.run_dir)
    gauges = [e for e in events if e["ev"] == "gauge"]
    execute = [e for e in events if e.get("path") == "run/round/execute"]
    walls_on = [e["dur_s"] for e in events if e.get("path") == "run/round"]
    nonfinite = [m.metrics["health/nonfinite"] for m in recs_on]
    status = on.obs.profiler.status
    trace = on.obs.profiler.trace_path
    in_trace = os.path.isfile(trace) and any(
        "quant_dequant_int8" in e.get("name", "")
        for e in json.load(open(trace))["traceEvents"]
        if e.get("cat") == "kernel")
    report = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tools", "obs_report.py"), on.obs.run_dir,
         "--coverage-min", "0.95", "--health-gate"],
        capture_output=True, text=True, timeout=300)
    print(f"[obs] sl/vmap MobileNetV2 dropout {FLEET_DROPOUT}, taps "
          f"{list(on.graph_taps)}: int8 launches {launches_on} with taps, "
          f"{launches_off} without (want {want} each); non-metric record "
          f"fields bit-equal {fields_equal}, engine state bit-equal "
          f"{state_equal}; health/nonfinite {nonfinite}")
    print(f"[obs] quant_error/mean round 0 {qerr:.9g} vs the plain "
          f"version's RMS on the kernel's inputs {want_qerr:.9g} (rel "
          f"{qerr_rel:.2e}, gated at {OBS_QERR_RTOL})")
    print(f"[obs] gauges: compiles {[g['compiles'] for g in gauges]}, "
          f"state_bytes {[g['state_bytes'] for g in gauges]} vs "
          f"tensor_bytes {tensor_bytes(state_on.engine_state)}, rss "
          f"{[g['rss_bytes'] for g in gauges]}")
    print(f"[obs] round wall s with telemetry+taps {walls_on} (round 1 "
          f"under the profiler), without {[round(w, 6) for w in walls_off]}"
          f"; round/execute sync_s/dur_s "
          f"{[(e['sync_s'], e['dur_s']) for e in execute]}")
    print(f"[obs] profiler {status}; trace {os.path.getsize(trace) if os.path.isfile(trace) else 0} "
          f"bytes, int8 kernel in it {in_trace}; metrics round 0 "
          f"{json.dumps(recs_on[0].metrics)}")
    print("[obs] obs_report: " + " | ".join(
        ln for ln in report.stdout.splitlines()
        if "coverage" in ln or "obs-report" in ln))
    if not (launches_on == launches_off == want and fields_equal
            and state_equal and nonfinite == [0] * len(recs_on)
            and qerr_rel <= OBS_QERR_RTOL
            and all(g["compiles"] == 0 for g in gauges)
            and all(g["state_bytes"] == tensor_bytes(state_on.engine_state)
                    for g in gauges)
            and len(execute) == 2
            and all(0 < e["sync_s"] <= e["dur_s"] for e in execute)
            and status.startswith("captured -> ") and in_trace
            and report.returncode == 0):
        raise AssertionError(f"[obs] sl/vmap telemetry checks failed "
                             f"(obs_report rc {report.returncode}: "
                             f"{report.stdout[-2000:]})")
    # the host syncs of one engine round: taps on against taps off (the
    # AdamW scalars are made once on the card: ROADMAP fault J)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=on.device)
    counts, sites = [], []
    for plan in (on, off):
        for warm in (True, False):
            st = plan.init()
            batches = plan.round_batches(st)
            torch.cuda.synchronize()
            n, where = host_sync_sites(
                lambda: plan.raw_round(st.engine_state, batches, mask))
            torch.cuda.synchronize()
        counts.append(n)
        sites.append(where)
    share = [e["sync_s"] / e["dur_s"] for e in execute]
    print(f"[obs] host syncs in one raw_round (a client masked): with taps "
          f"{counts[0]}, without {counts[1]} (12 before the AdamW scalars "
          f"moved to the card); where: {sites}; round/execute sync_s share "
          f"of dur_s {[round(x, 4) for x in share]}")
    if counts[0] != counts[1]:
        raise AssertionError(f"[obs] taps add host syncs: {counts}")
    # the engine round alone, warm, in turns: without, with, with, without
    raw_s = {"on": [], "off": []}
    for name in ("off", "on", "on", "off"):
        plan = on if name == "on" else off
        st = plan.init()
        batches = plan.round_batches(st)
        raw_s[name].append(time_fenced(
            lambda: plan.raw_round(st.engine_state, batches, mask),
            repeats=3) / 3)
    print(f"[obs] raw_round wall s (fenced, 3 back to back, a client "
          f"masked), in turns off/on/on/off: without taps {raw_s['off']}, "
          f"with {raw_s['on']} (with/without "
          f"{sum(raw_s['on']) / sum(raw_s['off']):.3f})")
    return {"launches": launches_on, "walls": (walls_on, walls_off),
            "execute": [(e["sync_s"], e["dur_s"]) for e in execute],
            "sync_share": share, "syncs": counts, "raw_s": raw_s}


def host_sync_sites(fn) -> tuple:
    """``(n, sites)``: the synchronizing CUDA operations ``fn()`` ran (under
    ``torch.cuda.set_sync_debug_mode("warn")``, as ``obs.timeline.
    count_host_syncs`` counts them) and, for each distinct one, the call
    stack's innermost frame in this repository and innermost frame in
    torch (``file:line function``)."""
    import traceback
    import warnings
    here = os.path.dirname(os.path.abspath(__file__))
    sites = []

    def frame(f) -> str:
        name = (os.path.relpath(f.filename, here)
                if f.filename.startswith(here)
                else f.filename.split("site-packages/")[-1])
        return f"{name}:{f.lineno} {f.name}"

    inside = []

    def show(message, category, filename, lineno, file=None, line=None):
        # only what fn() runs: not the switch of the debug mode itself
        if "synchronizing" not in str(message) or not inside:
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if f.filename.startswith(here)]
        torch_frames = [f for f in stack if "site-packages/torch" in
                        f.filename]
        sites.append(" <- ".join(frame(f) for f in (
            torch_frames[-1:] + ours[-1:])) or f"{filename}:{lineno}")

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside.append(True)
            fn()
        finally:
            inside.clear()
            torch.cuda.set_sync_debug_mode(prev)
    return len(sites), sorted(set(sites))


def obs_lm_taps_peak(api) -> dict:
    """SmolLM-135M at full width on ``sl/vmap`` at batch ``LM_VMAP_BATCH``
    with the default taps, one round without evaluation: the per-client
    server gradients of the taps' second backward are formed a client at a
    time (ROADMAP fault I), so it fits the card; its peak memory and the
    record's ``grad_norm_server/mean`` are printed."""
    import gc

    from repro_torch.configs import smollm_135m
    from repro_torch.obs import MetricsConfig, ObsConfig
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plan = api.compile_experiment(
        lm_spec(api, smollm_135m, "pallas", client_axis="vmap",
                batch_size=LM_VMAP_BATCH),
        obs=ObsConfig(enabled=False, metrics=MetricsConfig()))
    state = plan.init()
    t0 = time.perf_counter()
    state, rec = plan.run_round(state, with_eval=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gns = rec.metrics["grad_norm_server/mean"]
    print(f"[obs] SmolLM-135M sl/vmap batch {LM_VMAP_BATCH} with taps "
          f"{list(plan.graph_taps)}: fits, peak {peak / 2 ** 30:.2f} GiB "
          f"({peak} bytes), round wall {wall:.4f} s, loss {rec.loss:.6f}, "
          f"grad_norm_server/mean {gns:.6g}, health/nonfinite "
          f"{rec.metrics['health/nonfinite']}")
    if not (math.isfinite(rec.loss) and math.isfinite(gns)
            and rec.metrics["health/nonfinite"] == 0):
        raise AssertionError("[obs] SmolLM sl/vmap with taps")
    del plan, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"lm_taps_peak": peak}


def obs_nan_check(api):
    """tinycnn ``sl/vmap``, int8 on the fused kernel, the full tap set: a
    NaN planted at (client 2, step 1) of round 1 is localized there on the
    card as on the CPU, and ``on_nonfinite="raise"`` raises with it."""
    from repro_torch.obs import MetricsConfig, NonfiniteError, ObsConfig
    spec = api.ExperimentSpec(
        model=api.ModelSpec(name="tinycnn"),
        data=api.DataSpec(image_size=16, n_train=96, n_test=24),
        clients=api.ClientSpec(num_clients=3),
        link_policy=api.LinkPolicy(compress="int8"),
        engine=api.EngineSpec(kind="sl", client_axis="vmap",
                              link_kernel="fused"),
        global_rounds=2, local_steps=2, batch_size=4)
    found = {}
    for device in ("cuda", "cpu"):
        coords = []
        for policy in ("record", "raise"):
            plan = api.compile_experiment(spec, device=device, obs=ObsConfig(
                enabled=False, metrics=MetricsConfig(on_nonfinite=policy)))
            st = plan.init()
            st, rec0 = plan.run_round(st, with_eval=False)
            bad = poison(plan.round_batches(st), client=2, step=1)
            try:
                st, rec1 = plan.run_round(st, bad, with_eval=False)
            except NonfiniteError as e:
                coords.append(("raise", e.round_index, e.step, e.client,
                               e.count))
            else:
                m = rec1.metrics
                coords.append(("record", rec0.metrics["health/nonfinite"],
                               m["health/first_step"],
                               m["health/first_client"],
                               m["health/nonfinite"]))
        found[device] = coords
    print(f"[obs] NaN at (client 2, step 1) of round 1, tinycnn sl/vmap "
          f"fused int8: card {found['cuda']}, CPU {found['cpu']}")
    want_raise = ("raise", 1, 1, 2)
    if not (found["cuda"] == found["cpu"]
            and found["cuda"][0][:4] == ("record", 0, 1, 2)
            and found["cuda"][1][:4] == want_raise):
        raise AssertionError(f"[obs] NaN localization: {found}")


def metrics_replay(recs, replay, rtol: float) -> tuple:
    """Two record streams' metrics: whether the keys and the health and
    mask entries are equal, and each round's float tap farthest from
    ``recs``'s by ``|d| - rtol |a|`` as (key, |d|, |d| / |a|, a)."""
    exact, worst = True, []
    for a, b in zip(recs, replay):
        exact &= set(a.metrics) == set(b.metrics)
        rows = []
        for k, v in a.metrics.items():
            if k.startswith(("health/", "mask/")):
                exact &= v == b.metrics[k]
            else:
                d = abs(v - b.metrics[k])
                rows.append((d - rtol * abs(v), (k, d, d / max(abs(v),
                                                                1e-30), v)))
        worst.append(max(rows)[1])
    return exact, worst


def obs_mc_path(api, run_id: str) -> dict:
    """The ``[mc]`` plan (MobileNetV2 ``sl/vmap`` under ``stoch_scenario``)
    with the full tap set, ``MC_SEEDS`` seeds x ``MC_ROUNDS`` rounds on
    the seed axis under cuDNN's deterministic algorithms: the ``mc/*``
    spans and the ``sweep`` manifest entry, the int8 launches ((1 +
    MC_ROUNDS) x local steps, as without taps), seed 0's metrics against
    ``plan.run()``'s: the loop's within rtol 2e-5 (atol 1e-7), the seed
    axis's round 0 within ``FLEET_EQUIV_ATOL`` (relative and absolute; its
    batched convolutions sum in another order, and the AdamW steps of a
    round amplify that: round 1 is printed, ROADMAP fault H), and the peak
    memory."""
    import numpy as np
    from repro_torch import sim
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    from repro_torch.obs import MetricsConfig, ObsConfig
    plan = api.compile_experiment(
        dataclasses.replace(main_spec(api, "sl", MC_ROUNDS,
                                      client_axis="vmap"),
                            scenario=stoch_scenario(sim)),
        obs=ObsConfig(run_root=OBS_RUN_ROOT, run_id=run_id,
                      metrics=MetricsConfig()))
    steps = plan.spec.local_steps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    quant_dequant_int8.launches = 0
    mc = sim.run_monte_carlo(plan, MC_SEEDS, rounds=MC_ROUNDS, mode="vmap")
    launches = quant_dequant_int8.launches
    peak = torch.cuda.max_memory_allocated()
    _, recs = plan.run(MC_ROUNDS, with_eval=False)
    loop = sim.run_monte_carlo(plan, MC_SEEDS, rounds=MC_ROUNDS, mode="loop")
    plan.obs.close()
    from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
    exact, worst = metrics_replay(recs, mc.records_for_seed(0),
                                  FLEET_EQUIV_ATOL)
    exact_loop, worst_loop = metrics_replay(recs, loop.records_for_seed(0),
                                            2e-5)
    # round 0's raw tap stacks, seed axis against loop, step by step
    steps_rel = {k.split("/", 1)[1]: [float(np.max(
        np.abs(mc.stacks[k][0, 0, s_] - loop.stacks[k][0, 0, s_])
        / np.maximum(np.abs(loop.stacks[k][0, 0, s_]), 1e-30)))
        for s_ in range(steps)]
        for k in sorted(mc.stacks) if k.startswith("metrics/")
        and k != "metrics/nonfinite"}
    events = load_events(plan.obs.run_dir)
    spans = {e["path"] for e in events if e["ev"] == "span"}
    with open(os.path.join(plan.obs.run_dir, "manifest.json")) as f:
        sweeps = json.load(f).get("sweeps", [])
    want = (1 + MC_ROUNDS) * steps
    print(f"[obs] mc: {MC_SEEDS} seeds x {MC_ROUNDS} rounds with taps, "
          f"wall_s={mc.wall_s:.4f}, peak {peak / 2 ** 30:.2f} GiB ({peak} "
          f"bytes), int8 launches {launches} (want {want}); seed 0 vs "
          f"plan.run() metrics, the loop's: keys, health, mask equal "
          f"{exact_loop}, float taps' worst (key, abs, rel, value) by round "
          f"{worst_loop} (gated at rtol 2e-5, atol 1e-7); the seed axis's: "
          f"equal {exact}, {worst} (round 0 gated at FLEET_EQUIV_ATOL "
          f"relative and absolute; round 1 printed: fault H); round 0's "
          f"taps, seed axis vs loop, max rel diff by step {steps_rel}; "
          f"spans "
          f"{sorted(p for p in spans if p.startswith('mc/'))}, sweeps "
          f"{[(w['mode'], w['seeds']) for w in sweeps]}; summary "
          f"grad_norm_server {mc.summary()['metrics']['grad_norm_server']}")
    if not (launches == want and exact and exact_loop
            and all(w[1] <= 1e-7 + 2e-5 * abs(w[3]) for w in worst_loop)
            and worst[0][1] <= FLEET_EQUIV_ATOL * (1 + abs(worst[0][3]))
            and {"mc/setup", "mc/compile", "mc/execute",
                 "mc/summarize"} <= spans
            and [w["mode"] for w in sweeps] == ["vmap", "loop"]):
        raise AssertionError("[obs] Monte-Carlo sweep with taps failed")
    return {"launches": launches, "peak": peak}


def obs_lm_check(api) -> dict:
    """A reduced SmolLM ``sl/vmap`` (dropout ``FLEET_DROPOUT``, int8 fused,
    flash attention) with the full tap set, on the card against the CPU on
    the same data and ``params0``: losses within ``FLEET_EQUIV_ATOL``, the
    health and mask entries exactly, the float taps within
    ``FLEET_EQUIV_ATOL`` relative and absolute (the CPU tests' bound); and
    the flash and int8 launches of its card run equal to those of the same
    run without taps (the taps' second backward launches neither)."""
    from repro_torch.configs import smollm_135m
    from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    from repro_torch.obs import MetricsConfig, ObsConfig
    spec = lm_spec(api, smollm_135m.reduced(), "pallas", seq_len=64,
                   n_train=32, n_test=8, num_clients=2, batch_size=4,
                   mission=False, client_axis="vmap",
                   dropout_rate=FLEET_DROPOUT)
    recs, launches = [], []
    for device, metrics in (("cuda", None), ("cuda", MetricsConfig()),
                            ("cpu", MetricsConfig())):
        flash_attention.launches = quant_dequant_int8.launches = 0
        recs.append(api.compile_experiment(spec, device=device, obs=ObsConfig(
            enabled=False, metrics=metrics)).run()[1])
        launches.append((flash_attention.launches,
                         quant_dequant_int8.launches))
    recs = recs[1:]
    worst, ok = 0.0, True
    for a, b in zip(*recs):
        ok &= (abs(a.loss - b.loss) <= FLEET_EQUIV_ATOL
               and set(a.metrics) == set(b.metrics))
        for k in b.metrics:
            if k.startswith(("health/", "mask/")):
                ok &= a.metrics[k] == b.metrics[k]
            else:
                d = abs(a.metrics[k] - b.metrics[k])
                ok &= d <= FLEET_EQUIV_ATOL * (1 + abs(b.metrics[k]))
                worst = max(worst, d / max(abs(b.metrics[k]), 1e-12))
    print(f"[obs] reduced SmolLM sl/vmap with taps on the card == on the CPU "
          f"{ok} (losses {[round(r.loss, 6) for r in recs[0]]} vs "
          f"{[round(r.loss, 6) for r in recs[1]]}; float taps max rel diff "
          f"{worst:.2e}); (flash, int8) launches on the card without taps "
          f"{launches[0]}, with {launches[1]}")
    if not ok or launches[0] != launches[1]:
        raise AssertionError("[obs] reduced SmolLM taps card vs CPU")
    return {"lm_launches": launches[1]}


def run_obs_path(api) -> dict:
    """The ``[obs]`` phase: run telemetry and the metrics bus on the card
    (``obs_sl_vmap``, ``obs_nan_check``, ``obs_mc_path``, ``obs_lm_check``),
    under cuDNN's deterministic algorithms (bit-equal runs with and without
    taps; ROADMAP fault H)."""
    import gc
    run_id = f"chip-smoke-{os.getpid()}"
    torch.backends.cudnn.deterministic = True
    try:
        out = obs_sl_vmap(api, run_id)
        gc.collect()
        torch.cuda.empty_cache()
        obs_nan_check(api)
        out["mc"] = obs_mc_path(api, run_id + "-mc")
        gc.collect()
        torch.cuda.empty_cache()
        out.update(obs_lm_check(api))
    finally:
        torch.backends.cudnn.deterministic = False
    out.update(obs_lm_taps_peak(api))
    return out


def nccl_group() -> str:
    """A one-rank NCCL default process group on this card, set up from a
    ``FileStore`` in a new temporary directory (no TCP port); returns the
    directory. A failed init raises."""
    import datetime
    import tempfile

    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip-smoke-nccl-")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=600),
        device_id=torch.device("cuda", torch.cuda.current_device()))
    return tmp


class CollectiveCount:
    """Counts of ``torch.distributed.all_reduce`` / ``all_gather`` calls
    while in the ``with`` block (the engines call them through the
    module)."""

    def __enter__(self):
        import torch.distributed as dist
        self.counts = {"all_reduce": 0, "all_gather": 0}
        self._real = {k: getattr(dist, k) for k in self.counts}

        def counted(name):
            def call(*a, **kw):
                self.counts[name] += 1
                return self._real[name](*a, **kw)
            return call
        for k in self.counts:
            setattr(dist, k, counted(k))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for k, fn in self._real.items():
            setattr(dist, k, fn)
        return False


def profiled_collectives(fn) -> dict:
    """``fn()`` once under ``torch.profiler`` (host and device): the events
    whose names carry ``nccl`` or ``c10d``, with their counts (the host's
    c10d ops and NCCL's kernels; on one rank NCCL may launch no kernel)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts: dict = {}
    for e in prof.events():
        name = e.name
        if "nccl" in name.lower() or name.startswith("c10d::"):
            key = ("device " if e.device_type == torch.autograd.DeviceType
                   .CUDA else "host ") + name[:60]
            counts[key] = counts.get(key, 0) + 1
    return counts


def shard_map_cnn(api, mesh, kind: str) -> dict:
    """MobileNetV2 ``main_spec`` (4 clients, int8 on the fused kernel,
    dropout ``FLEET_DROPOUT``) on ``{kind}/shard_map`` over ``mesh`` against
    the same plan on ``{kind}/vmap``: round 0 under cuDNN's default
    algorithms, then 2 rounds under its deterministic ones, every round's
    loss within ``FLEET_EQUIV_ATOL`` and the host's fields (masks, bytes,
    bills) equal; the int8 launches of the deterministic shard_map run; the
    collectives of one raw round (counted at the call and from the
    profiler); the raw round's host syncs; and the raw round of each
    engine timed in turns (``time_fenced``)."""
    from repro_torch.fleet.engine import FLEET_EQUIV_ATOL
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    from repro_torch.obs.timeline import time_fenced
    host_fields = ("round", "link_bytes", "link_time_s", "link_energy_j",
                   "client_time_s", "client_energy_j", "server_time_s",
                   "server_energy_j", "uav_energy_j", "active_clients")
    plans = {}
    for axis in ("shard_map", "vmap"):
        plans[axis] = api.compile_experiment(
            main_spec(api, kind, 2, client_axis=axis,
                      dropout_rate=FLEET_DROPOUT),
            mesh=mesh if axis == "shard_map" else None)
    plans["vmap"].params0 = plans["shard_map"].params0
    diffs, launches = {}, 0
    for det, rounds in ((False, 1), (True, 2)):
        torch.backends.cudnn.deterministic = det
        try:
            recs = {}
            for axis, plan in plans.items():
                quant_dequant_int8.launches = 0
                recs[axis] = plan.run(rounds)[1]
                if axis == "shard_map" and det:
                    launches = quant_dequant_int8.launches
        finally:
            torch.backends.cudnn.deterministic = False
        for a, b in zip(recs["shard_map"], recs["vmap"]):
            if any(getattr(a, f) != getattr(b, f) for f in host_fields):
                raise AssertionError(f"[shard_map] {kind}: host fields "
                                     f"differ: {a} vs {b}")
        diffs["deterministic" if det else "default"] = [
            abs(a.loss - b.loss) for a, b in zip(recs["shard_map"],
                                                 recs["vmap"])]
    sm = plans["shard_map"]
    steps = sm.spec.local_steps
    want = 2 * steps if kind == "sl" else 0
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=sm.device)
    st = sm.init()
    batches = sm.round_batches(st)
    sm.raw_round(st.engine_state, batches, mask)      # warm
    torch.cuda.synchronize()
    with CollectiveCount() as calls:
        sm.raw_round(st.engine_state, batches, mask)
        torch.cuda.synchronize()
    prof = profiled_collectives(
        lambda: sm.raw_round(st.engine_state, batches, mask))
    syncs, sites = host_sync_sites(
        lambda: sm.raw_round(st.engine_state, batches, mask))
    want_calls = ({"all_reduce": steps + 1, "all_gather": 1} if kind == "sl"
                  else {"all_reduce": 1, "all_gather": 1})
    walls = {"shard_map": [], "vmap": []}
    for axis in ("vmap", "shard_map", "shard_map", "vmap"):
        plan = plans[axis]
        st_a = plan.init()
        b_a = plan.round_batches(st_a)
        plan.raw_round(st_a.engine_state, b_a, mask)
        walls[axis].append(time_fenced(
            lambda: plan.raw_round(st_a.engine_state, b_a, mask),
            repeats=3) / 3)
    card = card_line()
    print(f"[shard_map] {kind}/shard_map MobileNetV2 on a one-rank NCCL "
          f"group vs {kind}/vmap: |loss diff| round 0 under cuDNN's default "
          f"algorithms {diffs['default']}, rounds 0-1 deterministic "
          f"{diffs['deterministic']} (gate {FLEET_EQUIV_ATOL}); host fields "
          f"equal; int8 launches over the deterministic 2-round run "
          f"{launches} (want {want})")
    print(f"[shard_map] {kind} collectives in one raw round (a client "
          f"masked): called {calls.counts} (want {want_calls}: "
          + ("one all_reduce a local step for the server's gradient, one "
             "for FedAvg, one all_gather of the rows"
             if kind == "sl" else "one all_reduce for FedAvg, one "
             "all_gather of the losses")
          + f"); profiler {prof}; host syncs {syncs} {sites}")
    print(f"[shard_map] {kind} raw_round wall s (fenced, 3 back to back, a "
          f"client masked), in turns vmap/shard_map/shard_map/vmap: "
          f"shard_map {walls['shard_map']}, vmap {walls['vmap']} "
          f"({card})")
    if not (diffs["default"][0] <= FLEET_EQUIV_ATOL
            and max(diffs["deterministic"]) <= FLEET_EQUIV_ATOL
            and launches == want and calls.counts == want_calls):
        raise AssertionError(f"[shard_map] {kind}/shard_map checks failed")
    del plans, sm, st, batches
    torch.cuda.empty_cache()
    return {"launches": launches, "calls": calls.counts, "syncs": syncs,
            "walls": walls, "diffs": diffs, "profiler": prof}


def shard_map_lm(api, mesh) -> dict:
    """SmolLM-135M at full width on ``sl/shard_map`` over ``mesh``
    (``lm_spec`` at batch ``LM_VMAP_BATCH``, flash attention): 2 rounds,
    the flash and int8 launches over exactly the run (as ``sl/vmap``'s),
    the peak memory, each round's wall time."""
    import gc

    from repro_torch.api.plan import LM_EVAL_CHUNK
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = api.compile_experiment(lm_spec(api, smollm_135m, "pallas",
                                        client_axis="shard_map",
                                        batch_size=LM_VMAP_BATCH), mesh=mesh)
    flash_attention.launches = quant_dequant_int8.launches = 0
    with CollectiveCount() as calls:
        run_plan(lm, "shard_map-lm")
    launches = {"flash_attention": flash_attention.launches,
                "quant_dequant_int8": quant_dequant_int8.launches}
    peak = torch.cuda.max_memory_allocated()
    steps, n_layers = lm.spec.local_steps, smollm_135m.n_layers
    chunks = -(-len(lm.x_test) // LM_EVAL_CHUNK)
    want = {"flash_attention": lm.num_rounds * n_layers * (steps + chunks),
            "quant_dequant_int8": lm.num_rounds * steps}
    print(f"[shard_map] SmolLM-135M sl/shard_map batch {LM_VMAP_BATCH} x "
          f"{lm.spec.data.seq_len}: launches over the {lm.num_rounds}-round "
          f"run {launches} (want {want}); collectives called {calls.counts}"
          f"; peak memory {peak / 2 ** 30:.2f} GiB ({peak} bytes) "
          f"({card_line()})")
    if launches != want:
        raise AssertionError(f"[shard_map] LM launches {launches}, want "
                             f"{want}")
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "peak": peak}


def run_shard_map_path(api) -> dict:
    """The ``[shard_map]`` phase: the explicit-collective fleet engines on
    a one-rank NCCL group (``launch.mesh.data_mesh`` over a default group
    from a ``FileStore``), destroyed at the end: MobileNetV2 ``sl`` and
    ``fl`` against ``vmap`` (``shard_map_cnn``), then the SmolLM split LM
    (``shard_map_lm``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import data_mesh
    tmp = nccl_group()
    try:
        mesh = data_mesh()
        print(f"[shard_map] mesh {mesh.shape} on {mesh.device}, backend "
              f"{dist.get_backend(mesh.group)}")
        out = {"sl": shard_map_cnn(api, mesh, "sl"),
               "fl": shard_map_cnn(api, mesh, "fl"),
               "lm": shard_map_lm(api, mesh)}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


SERVER_MESH_SIZES = ((2, 1), (2, 2), (4, 1))


def explicit_server_pspecs(params_s: dict, mesh) -> dict:
    """Specs that shard on both server axes wherever the reference's rule
    would shard with axes of size > 1, whatever the axes' sizes
    (``compile_experiment(server_pspecs=)``): a matrix-like leaf's
    reference dims -2 over ``fsdp`` and -1 over ``tp``, a vector's channel
    over ``tp`` (``launch.steps.reference_dims`` maps them to the port's
    layout)."""
    from repro_torch.launch.steps import reference_dims
    from repro_torch.parallel.sharding import P
    out = {}
    for k, v in params_s.items():
        axes = [None] * v.dim()
        dims = reference_dims(v.dim())
        if v.dim() >= 1:
            axes[dims[-1]] = "tp"
        if v.dim() >= 2:
            axes[dims[-2]] = "fsdp"
        out[k] = P(*axes)
    return out


def server_state_bytes(params_s: dict, fsdp: int, tp: int) -> int:
    """One rank's bytes of the server params and both AdamW moments (f32)
    and the step counter, under ``fleet_server_pspecs`` at ``(fsdp, tp)``:
    arithmetic from the placements."""
    from repro_torch.launch.steps import fleet_server_pspecs
    specs = fleet_server_pspecs(params_s, {"fsdp": fsdp, "tp": tp})
    total = 0
    for k, v in params_s.items():
        n = v.numel()
        for ax in specs[k]:
            n //= {"fsdp": fsdp, "tp": tp}.get(ax, 1)
        total += 3 * n * 4
    return total + 4


def server_mesh_sweep(api, mesh, mc_det: dict) -> dict:
    """The ``[mc]`` sweep over the server sub-mesh: the ``[mc]`` plan (the
    ``[scenario]`` spec under ``stoch_scenario``) compiled over ``mesh``
    with its server placed by ``explicit_server_pspecs``, then
    ``run_monte_carlo(plan, MC_SEEDS, rounds=MC_ROUNDS)`` in both modes
    under cuDNN's deterministic algorithms, through the engine's own
    rounds. Gates: each mode's stacks (each seed's losses, masks, bytes,
    bills and accuracy) bit-equal to the plain ``[mc]`` sweep's of that
    mode (``mc_det``); the vmap sweep's ``final_state``: the server params
    and both moments DTensors whose placements are the plain ones shifted
    by the seed axis, the step counter a replicated (seeds,) tensor; the
    vmap sweep's int8 launches ``(1 + MC_ROUNDS) x local steps``. Prints
    each mode's fenced wall time and peak memory beside the card's name
    and power limit."""
    import numpy as np
    from repro_torch import sim
    from repro_torch.fleet.engine import shift_placements
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    from repro_torch.sim import run_monte_carlo
    plan = api.compile_experiment(dataclasses.replace(
        main_spec(api, "sl", 2, client_axis="vmap"),
        scenario=stoch_scenario(sim)), mesh=mesh,
        server_pspecs=explicit_server_pspecs)
    placements = plan._engine.server_placements
    res, peaks, launches = {}, {}, None
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("vmap", "loop"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            quant_dequant_int8.launches = 0
            res[mode] = run_monte_carlo(plan, MC_SEEDS, rounds=MC_ROUNDS,
                                        mode=mode)
            peaks[mode] = torch.cuda.max_memory_allocated()
            if mode == "vmap":
                launches = quant_dequant_int8.launches
    finally:
        torch.backends.cudnn.deterministic = False
    equal = {mode: set(r.stacks) == set(mc_det[mode]) and all(
        np.array_equal(r.stacks[k], mc_det[mode][k]) for k in r.stacks)
        for mode, r in res.items()}
    _, ps, _, os_ = res["vmap"].final_state
    shifted = all(
        list(v.placements) == list(shift_placements(placements[k], 1))
        and v.shape[0] == MC_SEEDS
        for tree in (ps, os_.mu, os_.nu) for k, v in tree.items())
    step_ok = (tuple(os_.step.shape) == (MC_SEEDS,)
               and all(p.is_replicate() for p in os_.step.placements))
    want = (1 + MC_ROUNDS) * plan.spec.local_steps
    card = card_line()
    v, l = res["vmap"], res["loop"]
    v_wall, l_wall = v.wall_s, l.wall_s
    print(f"[server-mesh] mc: the [mc] plan's {MC_SEEDS} seeds x "
          f"{MC_ROUNDS} rounds over the sharded server, cuDNN deterministic:"
          f" stacks bit-equal to the plain [mc] sweep's, vmap {equal['vmap']}"
          f", loop {equal['loop']}; server params and moments seed-stacked "
          f"DTensors with placements shifted by the seed axis {shifted}, "
          f"step counter replicated (seeds,) {step_ok}; int8 launches of "
          f"the vmap sweep {launches} (want {want}); losses "
          f"{v.stacks['loss'].round(6).tolist()}")
    print(f"[server-mesh] mc: fenced wall (after one warm-up round) vmap "
          f"{v.wall_s:.4f} s, loop {l.wall_s:.4f} s (loop/vmap "
          f"{l.wall_s / v.wall_s:.3f}); peak vmap "
          f"{peaks['vmap'] / 2 ** 30:.2f} GiB ({peaks['vmap']} bytes), loop "
          f"{peaks['loop'] / 2 ** 30:.2f} GiB ({peaks['loop']} bytes) "
          f"({card})")
    if not (all(equal.values()) and shifted and step_ok
            and launches == want):
        raise AssertionError("[server-mesh] mc checks failed")
    del plan, res, v, l, ps, os_
    torch.cuda.empty_cache()
    return {"launches": launches, "wall": (v_wall, l_wall),
            "peak": (peaks["vmap"], peaks["loop"])}


def run_server_mesh_path(api, mc_det: dict) -> dict:
    """The ``[server-mesh]`` phase: MobileNetV2 ``sl/vmap`` as ``[sl-vmap]``
    runs it (``main_spec``, dropout ``FLEET_DROPOUT``, 2 rounds), then the
    same spec compiled over a ``(1, 1, 1)`` ``DeviceMesh`` on a one-rank
    NCCL group with its server placed by ``explicit_server_pspecs``
    (``compile_experiment(mesh=, server_pspecs=)``): Shard placements on
    the size-1 ``(fsdp, tp)`` axes, the server params and moments
    DTensors, gathered every local step. Both runs under cuDNN's
    deterministic algorithms; records and final state bit-equal, the int8
    launches of the sharded run counted; the two runs again in turns,
    timed. Prints each rank's server-state bytes at ``SERVER_MESH_SIZES``
    (arithmetic). Then, on the same mesh, the ``[mc]`` sweep
    (``server_mesh_sweep``, held to ``mc_det``, the plain ``[mc]`` sweep's
    deterministic stacks by mode)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.fleet.engine import gather_server_state
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    from repro_torch.launch.mesh import fleet_mesh_of
    tmp = nccl_group()
    try:
        mesh = fleet_mesh_of(init_device_mesh(
            "cuda", (1, 1, 1), mesh_dim_names=("data", "fsdp", "tp")))
        spec = main_spec(api, "sl", 2, client_axis="vmap",
                         dropout_rate=FLEET_DROPOUT)
        plans = {"plain": api.compile_experiment(spec),
                 "server-mesh": api.compile_experiment(
                     spec, mesh=mesh, server_pspecs=explicit_server_pspecs)}
        plan = plans["server-mesh"]
        params_s = plan._engine.params0_tiers(plan.params0)[1]
        placements = plan._engine.server_placements
        runs, walls = {}, {"plain": [], "server-mesh": []}
        torch.backends.cudnn.deterministic = True
        try:
            # in turns: the first run of each is the one compared
            for label in ("plain", "server-mesh", "server-mesh", "plain"):
                quant_dequant_int8.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = plans[label].run()
                torch.cuda.synchronize()
                walls[label].append(time.perf_counter() - t0)
                if label not in runs:
                    runs[label] = out
                    if label == "server-mesh":
                        launches = quant_dequant_int8.launches
        finally:
            torch.backends.cudnn.deterministic = False
        (st_p, recs_p), (st_s, recs_s) = runs["plain"], runs["server-mesh"]
        dtensors = all(hasattr(v, "placements") for v in
                       list(st_s.engine_state[1].values())
                       + list(st_s.engine_state[3].mu.values()))
        equal_recs = recs_p == recs_s
        plain_state = st_p.engine_state
        gathered = (st_s.engine_state[0], gather_server_state(
            st_s.engine_state[1]), st_s.engine_state[2],
            gather_server_state(st_s.engine_state[3]))
        equal_state = same_tensors(plain_state, gathered)
        want = plan.num_rounds * plan.spec.local_steps
        card = card_line()
        n_sharded = sum(any(p.is_shard() for p in pl)
                        for pl in placements.values())
        print(f"[server-mesh] mesh {mesh.shape} on {mesh.device} (backend "
              f"{dist.get_backend(mesh.group)}), Shard placements on the "
              f"size-1 (fsdp, tp) axes for {n_sharded} of {len(placements)} "
              f"server leaves; server params and moments DTensors at rest: "
              f"{dtensors}")
        print(f"[server-mesh] MobileNetV2 sl/vmap dropout {FLEET_DROPOUT}, "
              f"{plan.num_rounds} rounds, cuDNN deterministic: records "
              f"bit-equal {equal_recs}, final state bit-equal {equal_state}"
              f"; losses {[r.loss for r in recs_s]}; int8 launches of the "
              f"sharded run {launches} (want {want}); run wall s (2 "
              f"rounds, evaluation included) in turns plain/server-mesh/"
              f"server-mesh/plain: plain {walls['plain']}, server-mesh "
              f"{walls['server-mesh']} ({card})")
        sizes = {f"{f}x{t}": server_state_bytes(params_s, f, t)
                 for f, t in ((1, 1),) + SERVER_MESH_SIZES}
        print(f"[server-mesh] server state bytes a rank (params + AdamW mu, "
              f"nu in f32 + step) by (fsdp x tp), arithmetic from "
              f"fleet_server_pspecs, not measured: {sizes}")
        print("[server-mesh] the multi-rank path (data x fsdp x tp over "
              "several ranks) is checked on the CPU only (4 gloo ranks, "
              "tests/test_torch_server_mesh.py) until a run on several "
              "cards exists")
        if not (dtensors and equal_recs and equal_state
                and launches == want):
            raise AssertionError("[server-mesh] checks failed")
        del plan, plans, runs, st_p, st_s, plain_state, gathered
        torch.cuda.empty_cache()
        sweep = server_mesh_sweep(api, mesh, mc_det)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "bytes": sizes, "walls": walls,
            "mc": sweep}


def run_rwkv_path() -> int:
    """rwkv6-7b at full width, cut to ``RWKV_LAYERS`` layers, through the
    port's trainer: 3 steps of 4 x 1024 tokens with the WKV forward and
    backward launch counts over exactly those steps, the peak memory, one
    profiled step, and the reduced rwkv6-7b (head size 256) on the card
    against the same run on the CPU. Returns the launch counts."""
    import dataclasses
    import gc

    from repro_torch.configs import rwkv6_7b
    from repro_torch.kernels.rwkv.scan import rwkv6_scan, rwkv6_scan_bwd
    from repro_torch.launch.train import cuda_hardware_profile, train, \
        train_step
    from repro_torch.models.transformer import default_cut_layer, model_init
    from repro_torch.optim import AdamW

    dev = torch.device("cuda")
    cfg = dataclasses.replace(rwkv6_7b, n_layers=RWKV_LAYERS)
    steps, batch, seq = 3, 4, 1024
    print(f"[rwkv] {cfg.name} at full width (d {cfg.d_model}, "
          f"{cfg.d_model // cfg.hd} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.dtype}), cut to {cfg.n_layers} of "
          f"{rwkv6_7b.n_layers} layers (the only cut from the published "
          f"model); batch {batch} x {seq} tokens, {steps} steps")
    torch.cuda.reset_peak_memory_stats()
    rwkv6_scan.launches = rwkv6_scan_bwd.launches = 0
    t0 = time.perf_counter()
    losses = train(cfg, steps=steps, batch=batch, seq=seq, lr=3e-4,
                   client_fraction=0.15, device=dev, log_every=1,
                   generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rwkv6_scan": rwkv6_scan.launches,
                "rwkv6_scan_bwd": rwkv6_scan_bwd.launches}
    want = cfg.n_layers * steps
    peak = torch.cuda.max_memory_allocated()
    print(f"[rwkv] losses {losses}; train() took {wall:.2f} s (init "
          f"included); peak memory {peak / 2 ** 30:.2f} GiB "
          f"({peak} bytes); WKV launches over the {steps} steps: "
          f"{launches} (want {cfg.n_layers} layers x {steps} steps = {want} "
          f"each)")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        raise AssertionError(f"rwkv: losses {losses}")
    if set(launches.values()) != {want}:
        raise AssertionError(f"rwkv path launched the WKV kernels "
                             f"{launches} times, want {want} each")
    gc.collect()
    torch.cuda.empty_cache()
    stamp("RWKV training run")

    # one more step under the profiler, on a fresh model after a warm step
    cut = default_cut_layer(cfg, 0.15)
    model = model_init(cfg, torch.Generator(device=dev).manual_seed(1),
                       cut_layer=cut)
    opt = AdamW(model.parameters(), 3e-4, weight_decay=0.01)
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), device=dev,
                           generator=g)
    batch_ = {"tokens": tokens, "labels": tokens}
    train_step(cfg, model, opt, batch_, cut_layer=cut)
    profile_call(lambda: train_step(cfg, model, opt, batch_, cut_layer=cut),
                 "rwkv", "step", top=20, cpu=False)    # the WKV kernels too
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    stamp("RWKV profiled step")

    small = rwkv6_7b.reduced()
    kw = dict(steps=2, batch=2, seq=64, lr=3e-4, client_fraction=0.15,
              log_every=1, hardware=cuda_hardware_profile(dev))
    gpu = train(small, device=dev, generator=torch.Generator().manual_seed(0),
                **kw)
    cpu = train(small, device="cpu",
                generator=torch.Generator().manual_seed(0), **kw)
    if any(abs(a - b) > 1e-3 for a, b in zip(gpu, cpu)) or len(gpu) != 2:
        raise AssertionError(f"reduced RWKV on the card {gpu} != on the CPU "
                             f"{cpu}")
    print(f"[check] reduced rwkv6-7b (hd {small.hd}) trained on the card "
          f"== on the CPU: losses {gpu} vs {cpu} (atol 1e-3)")
    return launches


def state_bytes(state) -> int:
    return sum(a.numel() * a.element_size() for g in state for a in g.values())


def run_serve_path() -> dict:
    """The port's serving entry point, ``launch.serve``: the reduced
    rwkv6-7b (head size 256: the column-split WKV kernel from a carried
    state) and the reduced SmolLM served on the card and on the CPU from the
    same weights and prompts (every step's logits within 1e-4, the tokens
    equal); rwkv6-7b at full width and all 32 layers through ``serve`` at
    the reference's defaults (batch 4, prompt 32, gen 32) with the WKV
    kernel's launches over exactly that run (64 steps x 32 layers), its
    peak memory and one profiled decode step; SmolLM-135M at full width
    through ``serve`` (batch 8, prompt 128, gen 128); and SmolLM-135M
    teacher-forced over 128 tokens with a bf16 and an int8 KV cache
    against ``model_forward``, the int8 run within the reference's
    relative max error ``INT8_KV_REL`` and its state under half the bytes
    of an f32 cache (the reference's criterion). Returns the launches."""
    import gc

    from repro_torch.configs import rwkv6_7b, smollm_135m
    from repro_torch.kernels.rwkv.scan import rwkv6_scan
    from repro_torch.launch.serve import generate, serve
    from repro_torch.models.transformer import (decode_state_init,
                                                default_cut_layer,
                                                model_decode_step,
                                                model_forward, model_init)
    dev = torch.device("cuda")
    for cfg in (rwkv6_7b.reduced(), smollm_135m.reduced()):
        cut = default_cut_layer(cfg, 0.15)
        model = model_init(cfg, torch.Generator().manual_seed(0),
                           cut_layer=cut)
        prompts = torch.randint(0, cfg.vocab, (2, 8),
                                generator=torch.Generator().manual_seed(1))
        want, want_logits = generate(cfg, model, prompts, 8, cut_layer=cut,
                                     keep_logits=True)
        got, logits = generate(cfg, model.to(dev), prompts.to(dev), 8,
                               cut_layer=cut, keep_logits=True)
        err = float((logits.cpu() - want_logits).abs().max())
        if (not torch.allclose(logits.cpu(), want_logits, atol=1e-4,
                               rtol=1e-4)
                or not torch.equal(got.cpu(), want)):
            raise AssertionError(f"reduced {cfg.name} served on the card != "
                                 f"on the CPU: logits max_abs_err {err}, "
                                 f"tokens {got.tolist()} vs {want.tolist()}")
        print(f"[serve] reduced {cfg.name} (hd {cfg.hd}) served on the card "
              f"== on the CPU: 16 steps' logits max_abs_err {err:.3e} (atol/"
              f"rtol 1e-4), tokens equal {got[0].tolist()}")
        del model
    stamp("serve card vs CPU")

    cfg = rwkv6_7b
    cut = default_cut_layer(cfg, 0.15)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = model_init(cfg, gen, cut_layer=cut)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[serve] {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.d_model // cfg.hd} heads of "
          f"{cfg.hd}, {cfg.dtype}): {n_bytes / 1e9:.2f} GB of weights drawn "
          f"on the card in {time.perf_counter() - t0:.2f} s, cut {cut}")
    torch.cuda.reset_peak_memory_stats()
    rwkv6_scan.launches = 0
    toks, dt = serve(cfg, device=dev, generator=gen, model=model,
                     **SERVE_RWKV)
    launches = {"rwkv6_scan": rwkv6_scan.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_RWKV["prompt_len"] + SERVE_RWKV["gen"]
    want = steps * cfg.n_layers
    tps = SERVE_RWKV["batch"] * steps / dt
    print(f"[serve] {cfg.name}: {tps:.2f} tok/s ({dt:.4f} s for "
          f"{SERVE_RWKV['batch']} x {steps} tokens, prefill included), "
          f"{1e3 * dt / steps:.3f} ms a step; peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({peak} bytes); rwkv6_scan launches "
          f"{launches['rwkv6_scan']} (want {steps} steps x {cfg.n_layers} "
          f"layers = {want})")
    if launches["rwkv6_scan"] != want:
        raise AssertionError(f"serve launched rwkv6_scan "
                             f"{launches['rwkv6_scan']} times, want {want}")
    if toks.shape != (SERVE_RWKV["batch"], SERVE_RWKV["gen"]) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        raise AssertionError(f"serve's tokens {toks.shape}: {toks.tolist()}")
    with torch.no_grad():
        state = decode_state_init(cfg, SERVE_RWKV["batch"], steps,
                                  cut_layer=cut, device=dev)
        tok = toks[:, :1]
        logits, _ = model_decode_step(cfg, model, state, tok, 0,
                                      cut_layer=cut)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("rwkv6-7b decode logits are not finite")
        profile_call(lambda: model_decode_step(cfg, model, state, tok, 1,
                                               cut_layer=cut),
                     "serve", "rwkv6-7b decode step (batch 4)", top=10,
                     cpu=False)
    del model, state, logits
    gc.collect()
    torch.cuda.empty_cache()
    stamp("serve rwkv6-7b")

    cfg = smollm_135m
    cut = default_cut_layer(cfg, 0.15)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = model_init(cfg, gen, cut_layer=cut)
    torch.cuda.reset_peak_memory_stats()
    toks, dt = serve(cfg, device=dev, generator=gen, model=model, **SERVE_LM)
    steps = SERVE_LM["prompt_len"] + SERVE_LM["gen"]
    print(f"[serve] {cfg.name} at full width ({cfg.n_layers} layers): "
          f"{SERVE_LM['batch'] * steps / dt:.2f} tok/s ({dt:.4f} s, "
          f"{1e3 * dt / steps:.3f} ms a step); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if toks.shape != (SERVE_LM["batch"], SERVE_LM["gen"]):
        raise AssertionError(f"serve's tokens {toks.shape}")
    b, n = SERVE_LM["batch"], 128
    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (b, n), device=dev, generator=g)
    rel, nbytes = {}, {}
    with torch.no_grad():
        full, _ = model_forward(cfg, model, {"tokens": tokens}, cut_layer=cut)
        for kv in ("param", "int8"):
            state = decode_state_init(cfg, b, n, cut_layer=cut, kv_dtype=kv,
                                      device=dev)
            nbytes[kv] = state_bytes(state)
            outs = [model_decode_step(cfg, model, state, tokens[:, t:t + 1],
                                      t, cut_layer=cut)[0]
                    for t in range(n)]
            dec = torch.cat(outs, dim=1).float()
            rel[kv] = float((dec - full.float()).abs().max()
                            / full.float().abs().max())
        nbytes["f32"] = state_bytes(decode_state_init(
            cfg, b, n, cut_layer=cut, dtype=torch.float32, device=dev))
    print(f"[serve] {cfg.name} teacher-forced over {n} tokens at batch {b} "
          f"against model_forward: relative max error bf16 KV "
          f"{rel['param']:.4e}, int8 KV {rel['int8']:.4e} (criterion < "
          f"{INT8_KV_REL}); state bytes int8 {nbytes['int8']}, bf16 "
          f"{nbytes['param']} (int8/bf16 "
          f"{nbytes['int8'] / nbytes['param']:.5f} = (hd + 4) / (2 hd) with "
          f"the f32 scales), f32 {nbytes['f32']} (int8/f32 "
          f"{nbytes['int8'] / nbytes['f32']:.5f}, criterion < 0.5)")
    if not rel["int8"] < INT8_KV_REL:
        raise AssertionError(f"int8 KV decode != forward beyond "
                             f"{INT8_KV_REL}: {rel}")
    if not (nbytes["int8"] < 0.5 * nbytes["f32"]
            and nbytes["int8"] < nbytes["param"]):
        raise AssertionError(f"int8 KV state bytes {nbytes}")
    del model, full, state, outs, dec
    gc.collect()
    torch.cuda.empty_cache()
    stamp("serve SmolLM-135M")
    return launches


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in f32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def moe_dispatch_check(dev) -> dict:
    """One deepseek-moe-16b MoE layer (d 2048, 64 experts of width 1408,
    top 6, 2 shared, bf16) over ``MOE_TOKENS``: ``moe_apply`` at a capacity
    that drops nothing (C = T) against ``moe_ref``, the share of picks
    dropped at the config's 1.25 (read off the dispatch table), and the
    layer's forward time at 1.25."""
    from repro_torch.configs import deepseek_moe_16b as cfg
    from repro_torch.models.moe import (MoE, _router, capacity_of,
                                        dispatch_table, moe_apply, moe_ref)
    e, k = cfg.n_experts, cfg.top_k
    with torch.device(dev):
        moe = MoE(cfg.d_model, e, cfg.moe_d_ff, k,
                  n_shared=cfg.n_shared_experts, dtype=torch.bfloat16)
    moe.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    b, s = MOE_TOKENS
    t = b * s
    x = torch.randn(b, s, cfg.d_model, device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        y, aux = moe_apply(moe, x, top_k=k, capacity_factor=e / k)
        y_ref, aux_ref = moe_ref(moe, x, top_k=k)
        top_p, top_i, _ = _router(moe, x.reshape(t, -1), k)
        cap = capacity_of(t, k, e, cfg.capacity_factor)
        table, _ = dispatch_table(top_p, top_i, e, cap)
        kept = int((table < t).sum())
        ms = time_ms(lambda: moe_apply(moe, x, top_k=k,
                                       capacity_factor=cfg.capacity_factor),
                     iters=20, warmup=3)
    rel = rel_err(y, y_ref)
    drop = 1.0 - kept / (t * k)
    print(f"[moe] (a) {cfg.name} MoE layer (d {cfg.d_model}, {e} experts of "
          f"{cfg.moe_d_ff}, top {k}, {cfg.n_shared_experts} shared, bf16) "
          f"over {b} x {s} tokens: moe_apply at C = {capacity_of(t, k, e, e / k)}"
          f" (nothing drops) against moe_ref: relative max error {rel:.4e} "
          f"(criterion < {MOE_BF16_REL:g}), aux {float(aux):.6f} vs "
          f"{float(aux_ref):.6f}; at capacity factor {cfg.capacity_factor} "
          f"(C = {cap}) {t * k - kept} of {t * k} picks dropped, share "
          f"{drop:.6f}; moe_apply there {ms:.3f} ms a call (eager)")
    if not (rel < MOE_BF16_REL and bool(torch.isfinite(y).all())
            and abs(float(aux) - float(aux_ref)) <= 1e-6):
        raise AssertionError(f"moe_apply != moe_ref: rel {rel}, aux "
                             f"{float(aux)} vs {float(aux_ref)}")
    del moe, x, y, y_ref
    torch.cuda.empty_cache()
    return {"rel": rel, "drop_share": drop, "ms": ms}


def moe_train_path(dev) -> dict:
    """deepseek-moe-16b at full width cut to ``MOE_LAYERS`` layers through
    ``launch.train.train`` (its log lines: each step's loss, aux and wall
    time), the peak memory, then one step under the profiler on a fresh
    model after a warm step."""
    import gc

    from repro_torch.configs import deepseek_moe_16b
    from repro_torch.launch.train import train, train_step
    from repro_torch.models.transformer import default_cut_layer, model_init
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(deepseek_moe_16b, n_layers=MOE_LAYERS)
    cut = default_cut_layer(cfg, 0.15)
    n = MOE_TRAIN
    print(f"[moe] (b) {cfg.name} at full width (d {cfg.d_model}, {cfg.n_heads}"
          f" heads, {cfg.n_experts} experts of {cfg.moe_d_ff}, top "
          f"{cfg.top_k}, {cfg.n_shared_experts} shared, vocab {cfg.vocab}, "
          f"{cfg.dtype}) cut to {cfg.n_layers} of {deepseek_moe_16b.n_layers}"
          f" layers (layer 0 dense, {cfg.n_layers - 1} MoE), cut {cut}; batch"
          f" {n['batch']} x {n['seq']}, AdamW lr 3e-4, {n['steps']} steps")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train(cfg, lr=3e-4, client_fraction=0.15, device=dev,
                   log_every=1,
                   generator=torch.Generator(device=dev).manual_seed(0), **n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[moe] (b) losses {losses}; train() took {wall:.2f} s (init "
          f"included); peak memory {peak / 2 ** 30:.2f} GiB ({peak} bytes)")
    if len(losses) != n["steps"] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"deepseek training losses {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    model = model_init(cfg, torch.Generator(device=dev).manual_seed(1),
                       cut_layer=cut)
    opt = AdamW(model.parameters(), 3e-4, weight_decay=0.01)
    tokens = torch.randint(0, cfg.vocab, (n["batch"], n["seq"]), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    batch = {"tokens": tokens, "labels": tokens}
    train_step(cfg, model, opt, batch, cut_layer=cut)
    profile_call(lambda: train_step(cfg, model, opt, batch, cut_layer=cut),
                 "moe-train", "deepseek 4-layer step", top=15, cpu=False)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "peak": peak}


def moe_serve_path(dev) -> dict:
    """deepseek-moe-16b at all 28 layers through ``launch.serve.serve`` at
    the reference serve's defaults: tokens/s, ms a step, peak memory, then
    one decode step profiled."""
    import gc

    from repro_torch.configs import deepseek_moe_16b as cfg
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import (decode_state_init,
                                                default_cut_layer,
                                                model_decode_step,
                                                model_init)
    cut = default_cut_layer(cfg, 0.15)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = model_init(cfg, gen, cut_layer=cut)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[moe] (c) {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers): {n_params} parameters, {n_bytes / 1e9:.2f} GB drawn on "
          f"the card in {time.perf_counter() - t0:.2f} s, cut {cut}")
    torch.cuda.reset_peak_memory_stats()
    toks, dt = serve(cfg, device=dev, generator=gen, model=model,
                     **SERVE_MOE)
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_MOE["prompt_len"] + SERVE_MOE["gen"]
    tps = SERVE_MOE["batch"] * steps / dt
    print(f"[moe] (c) {cfg.name}: {tps:.2f} tok/s ({dt:.4f} s for "
          f"{SERVE_MOE['batch']} x {steps} tokens, prefill included), "
          f"{1e3 * dt / steps:.3f} ms a step; peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({peak} bytes)")
    if toks.shape != (SERVE_MOE["batch"], SERVE_MOE["gen"]) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        raise AssertionError(f"deepseek serve's tokens {toks.tolist()}")
    with torch.no_grad():
        state = decode_state_init(cfg, SERVE_MOE["batch"], steps,
                                  cut_layer=cut, device=dev)
        tok = toks[:, :1]
        logits, _ = model_decode_step(cfg, model, state, tok, 0,
                                      cut_layer=cut)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("deepseek decode logits are not finite")
        profile_call(lambda: model_decode_step(cfg, model, state, tok, 1,
                                               cut_layer=cut),
                     "moe-serve", "deepseek decode step (batch 4)", top=12,
                     cpu=False)
    del model, state, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"tok_s": tps, "ms_step": 1e3 * dt / steps, "peak": peak}


def mamba_width_path(dev) -> dict:
    """jamba-1.5-large-398b's Mamba sub-layer at its published width, bf16:
    ``mamba_apply`` over ``MAMBA_TOKENS`` forward and backward (gradients
    finite), ``MAMBA_STEPS`` ``mamba_step``s continuing from its state, and
    step by step over the first ``MAMBA_CHECK`` tokens against one pass."""
    import gc

    from repro_torch.configs import jamba_1_5_large_398b as cfg
    from repro_torch.models.ssm import (Mamba, mamba_apply,
                                        mamba_empty_state, mamba_step)
    kw = dict(expand=cfg.ssm_expand, state_dim=cfg.ssm_state_dim,
              conv_width=cfg.ssm_conv_width)
    with torch.device(dev):
        mix = Mamba(cfg.d_model, dtype=torch.bfloat16, **kw)
    mix.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    b, s = MAMBA_TOKENS
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(b, s, cfg.d_model, device=dev, dtype=torch.bfloat16,
                    generator=g)
    x_next = torch.randn(b, MAMBA_STEPS, cfg.d_model, device=dev,
                         dtype=torch.bfloat16, generator=g)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, st = mamba_apply(mix, x, **kw)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0 - t_fwd
    peak = torch.cuda.max_memory_allocated()
    bad = [name for name, p in mix.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    with torch.no_grad():
        st = {k_: v.detach() for k_, v in st.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MAMBA_STEPS):
            y1, st = mamba_step(mix, x_next[:, i:i + 1], st)
        torch.cuda.synchronize()
        t_step = (time.perf_counter() - t0) / MAMBA_STEPS
        whole, _ = mamba_apply(mix, x[:, :MAMBA_CHECK], **kw)
        st1 = mamba_empty_state(b, cfg.d_model, dtype=torch.bfloat16,
                                device=dev, **kw)
        outs = []
        for i in range(MAMBA_CHECK):
            y1_, st1 = mamba_step(mix, x[:, i:i + 1], st1)
            outs.append(y1_)
        rel = rel_err(torch.cat(outs, dim=1), whole)
    d_inner = cfg.ssm_expand * cfg.d_model
    print(f"[moe] (d) {cfg.name} Mamba sub-layer (d {cfg.d_model}, d_inner "
          f"{d_inner}, N {cfg.ssm_state_dim}, conv {cfg.ssm_conv_width}, "
          f"dt_rank {mix.w_dt_a.shape[1]}, bf16): mamba_apply over {b} x {s} "
          f"forward {1e3 * t_fwd:.1f} ms, backward {1e3 * t_bwd:.1f} ms "
          f"(host clock, fenced), peak {peak / 2 ** 30:.2f} GiB; "
          f"{MAMBA_STEPS} mamba_steps from its state {1e3 * t_step:.3f} ms "
          f"each; step by step over {MAMBA_CHECK} tokens against one pass: "
          f"relative max error {rel:.4e} (criterion < {MAMBA_STEP_REL:g}); "
          f"non-finite gradients {bad}")
    if bad or not rel < MAMBA_STEP_REL or not bool(
            torch.isfinite(y1).all()):
        raise AssertionError(f"Mamba at jamba's width: gradients {bad}, "
                             f"step vs pass {rel}")
    del mix, x, y, st
    gc.collect()
    torch.cuda.empty_cache()
    return {"fwd_s": t_fwd, "bwd_s": t_bwd, "step_s": t_step, "rel": rel,
            "peak": peak}


def moe_card_vs_cpu(dev) -> dict:
    """The reduced deepseek-moe-16b, arctic-480b and jamba-1.5-large-398b
    with the same weights on the card and on the CPU: ``lm_loss``'s loss
    and every gradient, a 16-token teacher-forced decode, a 4-token greedy
    ``generate``; tokens equal, the rest within ``MOE_CPU_TOL``."""
    import copy

    from repro_torch.configs import (arctic_480b, deepseek_moe_16b,
                                     jamba_1_5_large_398b)
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import (decode_state_init,
                                                default_cut_layer, lm_loss,
                                                model_decode_step,
                                                model_init)
    errs = {}
    for full in (deepseek_moe_16b, arctic_480b, jamba_1_5_large_398b):
        cfg = full.reduced()
        cut = default_cut_layer(cfg, 0.15)
        cpu = model_init(cfg, torch.Generator().manual_seed(0), cut_layer=cut)
        card = copy.deepcopy(cpu).to(dev)
        tokens = torch.randint(0, cfg.vocab, (2, 16),
                               generator=torch.Generator().manual_seed(1))
        res = []
        for model, d in ((cpu, "cpu"), (card, dev)):
            tk = tokens.to(d)
            loss, metrics = lm_loss(cfg, model, {"tokens": tk, "labels": tk},
                                    cut_layer=cut)
            loss.backward()
            with torch.no_grad():
                state = decode_state_init(cfg, 2, 16, cut_layer=cut, device=d)
                dec = torch.cat([model_decode_step(
                    cfg, model, state, tk[:, t:t + 1], t,
                    cut_layer=cut)[0] for t in range(16)], dim=1)
            gen, gen_logits = generate(cfg, model, tk[:, :8], 4,
                                       cut_layer=cut, keep_logits=True)
            res.append({"loss": loss.detach(), "aux": metrics["aux"].detach(),
                        "dec": dec, "gen_logits": gen_logits,
                        **{f"grad {n}": p.grad
                           for n, p in model.named_parameters()}, "gen": gen})
        want, got = res
        err = max(float((got[k_].cpu().float() - v.float()).abs().max())
                  for k_, v in want.items() if k_ != "gen")
        bad = [k_ for k_, v in want.items() if k_ != "gen" and not
               torch.allclose(got[k_].cpu(), v, atol=MOE_CPU_TOL,
                              rtol=MOE_CPU_TOL)]
        same = torch.equal(got["gen"].cpu(), want["gen"])
        errs[cfg.name] = err
        print(f"[moe] (e) reduced {cfg.name} on the card == on the CPU: loss "
              f"{float(got['loss']):.6f} vs {float(want['loss']):.6f}, aux "
              f"{float(got['aux']):.6f}, {sum(1 for k_ in want if k_.startswith('grad'))}"
              f" gradients, 16 decode steps, 4 greedy tokens "
              f"{got['gen'][0].tolist()}: max_abs_err {err:.3e} (atol/rtol "
              f"{MOE_CPU_TOL:g}; the MoE scatter's f32 sums in another "
              f"order on the card), tokens equal {same}")
        if bad or not same:
            raise AssertionError(f"reduced {cfg.name} card != CPU: {bad[:8]}"
                                 f", tokens equal {same}")
        del cpu, card
    return errs


def run_moe_path() -> dict:
    """The ``[moe]`` phase, (a) to (e) in order, each model freed before the
    next so that each peak printed is its own; the port's kernels' launches
    over the phase (the reference's trainer and server attend with the
    plain path: none of them runs here)."""
    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.kernels.quant.int8 import (dequantize_int8,
                                                quant_dequant_int8,
                                                quantize_int8)
    from repro_torch.kernels.rwkv.scan import rwkv6_scan, rwkv6_scan_bwd
    counted = (quant_dequant_int8, quantize_int8, dequantize_int8,
               flash_attention, rwkv6_scan, rwkv6_scan_bwd)
    for fn in counted:
        fn.launches = 0
    dev = torch.device("cuda")
    out = {"dispatch": moe_dispatch_check(dev)}
    stamp("moe (a) dispatch")
    out["train"] = moe_train_path(dev)
    stamp("moe (b) deepseek training")
    out["serve"] = moe_serve_path(dev)
    stamp("moe (c) deepseek serving")
    out["mamba"] = mamba_width_path(dev)
    stamp("moe (d) Mamba at jamba's width")
    out["cpu"] = moe_card_vs_cpu(dev)
    stamp("moe (e) reduced configs card vs CPU")
    out["launches"] = {fn.__name__: fn.launches for fn in counted}
    print(f"[moe] the port's kernels launched over the [moe] phase: "
          f"{out['launches']}")
    return out


def check_flash_head_dims(dev) -> dict:
    """The flash kernel at every head dim above 128 (``FLASH_NEW_D``) over
    ``FLASH_NEW_PAIRS`` x ``FLASH_NEW_MASKS`` (``flash_sweep``), at
    ``FLASH_PIXTRAL`` causal in both dtypes, and its gradient there.
    Returns the largest |kernel - plain| per dtype."""
    g = torch.Generator(device=dev).manual_seed(5)
    errs, cases = flash_sweep(dev, g, FLASH_NEW_D, FLASH_NEW_PAIRS,
                              FLASH_NEW_MASKS)
    print(f"[encdec] (a) flash_attention at D {FLASH_NEW_D[0]}.."
          f"{FLASH_NEW_D[-1]}: {cases} cases (S, Sk in {FLASH_NEW_PAIRS}; "
          f"causal, non-causal, windowed) within the reference's "
          f"tolerances of the plain version; max_abs_err f32 "
          f"{errs['float32']:.3e}, bf16 {errs['bfloat16']:.3e}")
    flash_at_shape(dev, g, FLASH_PIXTRAL, errs)
    gerr = flash_grad_err(dev, g, ((FLASH_PIXTRAL, True, None),))
    print(f"[encdec] (a) flash_attention gradients at {FLASH_PIXTRAL} "
          f"(kernel forward + closed-form backward) vs autograd of the plain "
          f"version: max_abs_err {gerr:.3e} (atol 2e-4)")
    return errs


def pixtral_split_lm_path(api) -> dict:
    """pixtral-12b's decoder at full width cut to ``PIXTRAL_LAYERS`` layers
    as a split-LM plan on the flash kernel at head dim 160 (``sl/scan``, 2
    clients, batch 2 x 1024, 1 round, int8 link): the flash and int8
    launches over exactly the run, the peak memory from the compile on,
    one profiled round."""
    import gc

    from repro_torch.api.plan import LM_EVAL_CHUNK
    from repro_torch.configs import pixtral_12b
    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    cfg = dataclasses.replace(pixtral_12b, n_layers=PIXTRAL_LAYERS)
    spec = dataclasses.replace(
        lm_spec(api, cfg, "pallas", n_train=16, n_test=LM_EVAL_CHUNK,
                num_clients=2, batch_size=2), global_rounds=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = api.compile_experiment(spec)
    k = plan.cut_of_client[0]
    print(f"[encdec] (b) {cfg.name} split LM ({cfg.n_layers} of "
          f"{pixtral_12b.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}) compiled in {time.perf_counter() - t0:.2f} s: cut "
          f"{k}/{cfg.n_layers}, smashed {plan.flops[k][2].shape}, "
          f"{spec.clients.num_clients} clients, batch {spec.batch_size} x "
          f"{spec.data.seq_len}, sl/scan, int8 link, attention on the flash "
          f"kernel")
    flash_attention.launches = 0
    quant_dequant_int8.launches = 0
    state, _ = run_plan(plan, "encdec-lm")
    launches = {"flash_attention": flash_attention.launches,
                "quant_dequant_int8": quant_dequant_int8.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = spec.local_steps * spec.clients.num_clients
    chunks = -(-len(plan.x_test) // LM_EVAL_CHUNK)
    want = {"flash_attention": plan.num_rounds * cfg.n_layers
            * (steps + chunks),
            "quant_dequant_int8": plan.num_rounds * steps}
    print(f"[encdec] (b) launches over the {plan.num_rounds}-round run: "
          f"{launches} (want {want}: flash {cfg.n_layers} x ({steps} split "
          f"steps + {chunks} evaluation chunk), int8 one link {PIXTRAL_INT8} "
          f"a split step); peak memory {peak / 2 ** 30:.2f} GiB ({peak} "
          f"bytes)")
    if launches != want or 0 in launches.values():
        raise AssertionError(f"pixtral split LM launches {launches}, want "
                             f"{want}")
    profile_call(lambda: plan.run_round(state), "encdec-lm",
                 "pixtral 4-layer round", cpu=False)
    del plan, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "peak": peak}


def pixtral_train_path(dev) -> dict:
    """pixtral-12b at full width cut to ``PIXTRAL_LAYERS`` layers through
    ``launch.train.train`` (1024 patch embeddings + 1024 text tokens a
    sequence; each step's loss and wall time on its log line), the peak
    memory, then one step profiled on a fresh model after a warm step."""
    import gc

    import numpy as np

    from repro_torch.configs import pixtral_12b
    from repro_torch.launch.train import step_batch, train, train_step
    from repro_torch.models.transformer import default_cut_layer, model_init
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(pixtral_12b, n_layers=PIXTRAL_LAYERS)
    cut = default_cut_layer(cfg, 0.15)
    n = PIXTRAL_TRAIN
    print(f"[encdec] (c) {cfg.name} through launch.train: {cfg.n_layers} of "
          f"{pixtral_12b.n_layers} layers, cut {cut}, batch {n['batch']} x "
          f"({cfg.frontend_tokens} patch + {n['seq']} text) positions, "
          f"{cfg.dtype}, AdamW lr 3e-4, {n['steps']} steps")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train(cfg, lr=3e-4, client_fraction=0.15, device=dev,
                   log_every=1,
                   generator=torch.Generator(device=dev).manual_seed(0), **n)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[encdec] (c) losses {losses}; train() took "
          f"{time.perf_counter() - t0:.2f} s (init included); peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({peak} bytes)")
    if len(losses) != n["steps"] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"pixtral training losses {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    model = model_init(cfg, torch.Generator(device=dev).manual_seed(1),
                       cut_layer=cut)
    opt = AdamW(model.parameters(), 3e-4, weight_decay=0.01)
    batch = step_batch(cfg, np.random.default_rng(2), n["batch"], n["seq"],
                       dev)
    train_step(cfg, model, opt, batch, cut_layer=cut)
    profile_call(lambda: train_step(cfg, model, opt, batch, cut_layer=cut),
                 "encdec-train", "pixtral 4-layer step", top=12, cpu=False)
    del model, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "peak": peak}


def whisper_paths(dev) -> dict:
    """whisper-tiny whole through ``launch.train.train`` (``WHISPER_TRAIN``,
    frames (B, 1500, 384)) with its peak memory, then ``transcribe`` at
    ``WHISPER_GEN`` after a 2-token warm-up: tokens/s and ms a step
    (the encoder's prefill included), its peak memory."""
    import gc

    from repro_torch.configs import whisper_tiny as cfg
    from repro_torch.launch.serve import transcribe
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import default_cut_layer, model_init
    from repro_torch.obs.timeline import fenced
    n = WHISPER_TRAIN
    torch.cuda.reset_peak_memory_stats()
    losses = train(cfg, lr=3e-4, client_fraction=0.15, device=dev,
                   log_every=1,
                   generator=torch.Generator(device=dev).manual_seed(0), **n)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[encdec] (d) {cfg.name} through launch.train ({cfg.n_enc_layers}"
          f" + {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.enc_seq_len} frames, batch {n['batch']} x {n['seq']}): "
          f"losses {losses}; peak memory {peak / 2 ** 30:.2f} GiB")
    if len(losses) != n["steps"] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"whisper training losses {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    cut = default_cut_layer(cfg, 0.15)
    model = model_init(cfg, torch.Generator(device=dev).manual_seed(1),
                       cut_layer=cut)
    b, gen = WHISPER_GEN["batch"], WHISPER_GEN["gen"]
    frames = 0.02 * torch.randn(b, cfg.enc_seq_len, cfg.d_model, device=dev,
                                generator=torch.Generator(
                                    device=dev).manual_seed(2))
    transcribe(cfg, model, frames, 2, cut_layer=cut)
    torch.cuda.reset_peak_memory_stats()
    toks, dt = fenced(lambda: transcribe(cfg, model, frames, gen,
                                         cut_layer=cut))
    serve_peak = torch.cuda.max_memory_allocated()
    tps = b * gen / dt
    print(f"[encdec] (d) {cfg.name} transcribe, batch {b}, {gen} tokens "
          f"(cut {cut}): {tps:.2f} tok/s ({dt:.4f} s, the encoder's prefill "
          f"included), {1e3 * dt / gen:.3f} ms a step; peak memory "
          f"{serve_peak / 2 ** 30:.3f} GiB; tokens {toks[0, :10].tolist()}")
    if toks.shape != (b, gen) or not (0 <= int(toks.min())
                                      and int(toks.max()) < cfg.vocab):
        raise AssertionError(f"whisper transcribe tokens {toks.tolist()}")
    del model, frames
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "peak": peak, "tok_s": tps,
            "ms_step": 1e3 * dt / gen}


def pixtral_serve_path(dev) -> dict:
    """pixtral-12b at all 40 layers through ``launch.serve.serve``, text
    only: tokens/s, ms a step, peak memory, one decode step profiled."""
    import gc

    from repro_torch.configs import pixtral_12b as cfg
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import (decode_state_init,
                                                default_cut_layer,
                                                model_decode_step,
                                                model_init)
    cut = default_cut_layer(cfg, 0.15)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = model_init(cfg, gen, cut_layer=cut)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[encdec] (e) {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers): {n_bytes / 1e9:.2f} GB drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s, cut {cut}")
    torch.cuda.reset_peak_memory_stats()
    toks, dt = serve(cfg, device=dev, generator=gen, model=model,
                     **SERVE_PIXTRAL)
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_PIXTRAL["prompt_len"] + SERVE_PIXTRAL["gen"]
    tps = SERVE_PIXTRAL["batch"] * steps / dt
    print(f"[encdec] (e) {cfg.name}: {tps:.2f} tok/s ({dt:.4f} s for "
          f"{SERVE_PIXTRAL['batch']} x {steps} tokens, prefill included), "
          f"{1e3 * dt / steps:.3f} ms a step; peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({peak} bytes)")
    if toks.shape != (SERVE_PIXTRAL["batch"], SERVE_PIXTRAL["gen"]) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab):
        raise AssertionError(f"pixtral serve's tokens {toks.tolist()}")
    with torch.no_grad():
        state = decode_state_init(cfg, SERVE_PIXTRAL["batch"], steps,
                                  cut_layer=cut, device=dev)
        tok = toks[:, :1]
        model_decode_step(cfg, model, state, tok, 0, cut_layer=cut)
        profile_call(lambda: model_decode_step(cfg, model, state, tok, 1,
                                               cut_layer=cut),
                     "encdec-serve", "pixtral decode step (batch 4)",
                     top=10, cpu=False)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"tok_s": tps, "ms_step": 1e3 * dt / steps, "peak": peak}


def encdec_card_vs_cpu(dev, names=("whisper-tiny", "pixtral-12b")) -> dict:
    """The reduced whisper-tiny (cut inside its encoder) and pixtral-12b
    with the same weights and batch on the card and on the CPU: the logits,
    ``lm_loss`` and every gradient within ``ENCDEC_CPU_TOL`` (f32, TF32
    off); whisper's 8 ``transcribe`` tokens and pixtral's 4 greedy
    ``generate`` tokens (and their logits) equal. Neither launches the
    flash kernel: their attention is the plain path, as the reference's.
    ``tests/test_torch_cuda.py`` runs the same check a config a case."""
    import copy

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.launch.serve import generate, transcribe
    from repro_torch.models.transformer import (default_cut_layer, lm_loss,
                                                model_forward, model_init)
    before = flash_attention.launches
    errs = {}
    for name in names:
        cfg = ARCHS[name].reduced()
        cut = default_cut_layer(cfg, 0.15)
        cpu = model_init(cfg, torch.Generator().manual_seed(0), cut_layer=cut)
        card = copy.deepcopy(cpu).to(dev)
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (2, 16), generator=g)
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.enc_dec:
            batch["frames"] = torch.randn(2, cfg.enc_seq_len, cfg.d_model,
                                          generator=g)
        else:
            batch["patch_embeds"] = torch.randn(
                2, cfg.frontend_tokens, cfg.d_model, generator=g)
        res = []
        for model, d in ((cpu, "cpu"), (card, dev)):
            b = {k_: v.to(d) for k_, v in batch.items()}
            loss, _ = lm_loss(cfg, model, b, cut_layer=cut)
            loss.backward()
            with torch.no_grad():
                logits, _ = model_forward(cfg, model, b, cut_layer=cut)
            out = {"loss": loss.detach(), "logits": logits,
                   **{f"grad {n}": p.grad for n, p in model.named_parameters()}}
            if cfg.enc_dec:
                toks = transcribe(cfg, model, b["frames"], 8, cut_layer=cut)
            else:
                toks, out["gen_logits"] = generate(
                    cfg, model, b["tokens"][:, :8], 4, cut_layer=cut,
                    keep_logits=True)
            res.append((out, toks))
        (want, want_toks), (got, got_toks) = res
        err = max(float((got[k_].cpu().float() - v.float()).abs().max())
                  for k_, v in want.items())
        bad = [k_ for k_, v in want.items() if not torch.allclose(
            got[k_].cpu(), v, atol=ENCDEC_CPU_TOL, rtol=ENCDEC_CPU_TOL)]
        same = torch.equal(got_toks.cpu(), want_toks)
        errs[cfg.name] = err
        print(f"[encdec] (f) reduced {cfg.name} on the card == on the CPU: "
              f"loss {float(got['loss']):.6f} vs {float(want['loss']):.6f}, "
              f"logits and {sum(1 for k_ in want if k_.startswith('grad'))} "
              f"gradients max_abs_err {err:.3e} (atol/rtol "
              f"{ENCDEC_CPU_TOL:g}), tokens {got_toks[0].tolist()} equal "
              f"{same}")
        if bad or not same:
            raise AssertionError(f"reduced {cfg.name} card != CPU: {bad[:8]}"
                                 f", tokens equal {same}")
        del cpu, card
    torch.cuda.synchronize()
    if flash_attention.launches != before:
        raise AssertionError(f"the reduced {names} launched flash "
                             f"{flash_attention.launches - before} times")
    return errs


def run_encdec_path(api) -> dict:
    """The ``[encdec]`` phase, (a) to (f) in order, each model freed before
    the next so that each peak printed is its own. The flash kernel's
    launches are counted over (b)'s run alone: the trainer's and the
    server's attention is the plain path, as the reference's is."""
    from repro_torch.kernels.attn.flash import flash_attention
    dev = torch.device("cuda")
    out = {"flash_err": check_flash_head_dims(dev)}
    out["flash_timing"] = time_flash_kernel(dev, FLASH_PIXTRAL)
    out["int8_timing"] = time_quant_kernel(dev, *PIXTRAL_INT8)
    stamp("encdec (a) flash head dims, pixtral's int8 link")
    out["lm"] = pixtral_split_lm_path(api)
    stamp("encdec (b) pixtral split LM")
    flash_attention.launches = 0
    out["train"] = pixtral_train_path(dev)
    stamp("encdec (c) pixtral training")
    out["whisper"] = whisper_paths(dev)
    stamp("encdec (d) whisper training and transcribe")
    out["serve"] = pixtral_serve_path(dev)
    stamp("encdec (e) pixtral serving")
    out["cpu"] = encdec_card_vs_cpu(dev)
    stamp("encdec (f) reduced configs card vs CPU")
    if flash_attention.launches:
        raise AssertionError(f"the trainer, transcribe and the server "
                             f"launched flash {flash_attention.launches} "
                             f"times; their attention is the plain path")
    return out


def ckpt_round_trip(cfg, dev, tmp: str) -> dict:
    """``cfg`` trained through ``launch.train.train(ckpt=)``, its file read
    back into a fresh model on the card: the file's size, a second save of
    the same tree timed (its bytes equal to the trainer's file), the
    restore timed, the parameters and one forward's logits bit-equal to the
    trained model's; the WKV launches over the training run."""
    import filecmp
    import gc

    from repro_torch.checkpoint import (checkpoint_meta, restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.checkpoint.ckpt import (tree_flatten_with_paths,
                                             tree_unflatten_like)
    from repro_torch.convert import model_from_reference, model_to_reference
    from repro_torch.kernels.rwkv.scan import rwkv6_scan, rwkv6_scan_bwd
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import (Model, build_groups,
                                                default_cut_layer,
                                                model_forward)
    path = os.path.join(tmp, f"{cfg.name}.msgpack")
    trained = []
    rwkv6_scan.launches = rwkv6_scan_bwd.launches = 0
    losses = train(cfg, **CKPT_TRAIN, lr=3e-4, client_fraction=0.15,
                   device=dev, log_every=1, ckpt=path, model_out=trained,
                   generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    launches = {"rwkv6_scan": rwkv6_scan.launches,
                "rwkv6_scan_bwd": rwkv6_scan_bwd.launches}
    model = trained[0]
    meta = checkpoint_meta(path)
    if meta != {"arch": cfg.name, "steps": CKPT_TRAIN["steps"],
                "loss": losses[-1]} or not all(map(math.isfinite, losses)):
        raise AssertionError(f"ckpt {cfg.name}: meta {meta}, losses {losses}")
    size = os.path.getsize(path)
    again = path + ".again"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    save_checkpoint(again, model_to_reference(model, cfg), meta=meta)
    save_s = time.perf_counter() - t0
    save_extra = torch.cuda.max_memory_allocated() - before
    same_bytes = filecmp.cmp(path, again, shallow=False)
    os.remove(again)
    cut = default_cut_layer(cfg, 0.15)
    with torch.device("meta"):
        like = model_to_reference(Model(cfg, build_groups(cfg, cut_layer=cut)),
                                  cfg)
    to_card = tree_unflatten_like(like, {k: dev for k in
                                         tree_flatten_with_paths(like)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = restore_checkpoint(path, like, shardings=to_card)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    fresh = model_from_reference(tree, cfg, cut)
    want, got = model.state_dict(), fresh.state_dict()
    params_equal = want.keys() == got.keys() and all(
        torch.equal(want[k], got[k]) for k in want)
    tokens = torch.randint(0, cfg.vocab, (CKPT_TRAIN["batch"],
                                          CKPT_TRAIN["seq"]), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        a, _ = model_forward(cfg, model, {"tokens": tokens}, cut_layer=cut)
        b, _ = model_forward(cfg, fresh, {"tokens": tokens}, cut_layer=cut)
    logits_equal = torch.equal(a, b)
    mib = size / 2 ** 20
    print(f"[ckpt] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{sum(t.numel() for t in want.values())} parameters): losses "
          f"{losses}; file {size} bytes ({mib:.1f} MiB, {len(want)} port "
          f"leaves); save {save_s:.3f} s ({mib / save_s:.1f} MiB/s, the "
          f"card's tensors copied to the host row by row; the card's "
          f"peak {save_extra} bytes above its allocation before), restore "
          f"{restore_s:.3f} s ({mib / restore_s:.1f} MiB/s, each leaf read "
          f"into a buffer and copied to the card before the next); a "
          f"second save's bytes == the trainer's file: {same_bytes}; "
          f"params bit-equal {params_equal}; "
          f"logits bit-equal {logits_equal}; WKV launches over the 2 steps "
          f"{launches}")
    # the save streams rows to the host: at most one row's copy on the card
    row_bytes = max(t.numel() * t.element_size() for t in want.values())
    if not (same_bytes and params_equal and logits_equal
            and save_extra <= row_bytes):
        raise AssertionError(f"ckpt {cfg.name}: bytes {same_bytes}, params "
                             f"{params_equal}, logits {logits_equal}, the "
                             f"save's peak {save_extra} above the card's "
                             f"allocation (at most {row_bytes})")
    del model, fresh, tree, trained, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return {"size": size, "save_s": save_s, "restore_s": restore_s,
            "save_extra": save_extra, "launches": launches}


def run_ckpt_path() -> dict:
    """The ``[ckpt]`` phase: rwkv6-7b at full width cut to RWKV_LAYERS
    layers (on the WKV kernels: 4 forward and 4 backward launches a step),
    then SmolLM-135M whole, each through ``ckpt_round_trip``; the files in
    a temporary directory, removed after."""
    import tempfile

    from repro_torch.configs import rwkv6_7b, smollm_135m
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="ckpt_")
    try:
        rwkv = ckpt_round_trip(dataclasses.replace(
            rwkv6_7b, n_layers=RWKV_LAYERS), dev, tmp)
        want = RWKV_LAYERS * CKPT_TRAIN["steps"]
        if set(rwkv["launches"].values()) != {want}:
            raise AssertionError(f"ckpt: rwkv6-7b launched the WKV kernels "
                                 f"{rwkv['launches']}, want {want} each")
        stamp("ckpt rwkv6-7b")
        lm = ckpt_round_trip(smollm_135m, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"rwkv": rwkv, "lm": lm}


def _zero_opt_state(params: dict, dev):
    from repro_torch.optim import OptState
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu={k: torch.zeros_like(v, dtype=torch.float32)
                        for k, v in params.items()},
                    nu={k: torch.zeros_like(v, dtype=torch.float32)
                        for k, v in params.items()})


def steps_train_path(dev) -> dict:
    """``launch.steps.build_train_step`` for rwkv6-7b cut to RWKV_LAYERS
    layers on a one-rank mesh (every spec replicated) at batch
    STEPS_BATCH x STEPS_SEQ, with remat and without: each step's loss and
    gradients against ``launch.train.train_step``'s (remat off) on the
    same params and batch, its wall time (a warm call first), peak memory
    and WKV launches; then the host syncs of a scheduled AdamW step and a
    scheduled FunctionalAdamW update."""
    import gc

    from repro_torch.configs import rwkv6_7b
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels.rwkv.scan import rwkv6_scan, rwkv6_scan_bwd
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import train_step
    from repro_torch.models.transformer import model_init
    from repro_torch.obs.timeline import count_host_syncs
    from repro_torch.optim import AdamW, FunctionalAdamW, warmup_cosine
    cfg = dataclasses.replace(rwkv6_7b, n_layers=RWKV_LAYERS)
    shape = InputShape("train_steps", STEPS_SEQ, STEPS_BATCH, "train")
    mesh = abstract_mesh((1, 1), ("data", "model"))
    built = {remat: build_train_step(cfg, shape, mesh, remat=remat)
             for remat in (True, False)}
    cut = built[True].meta["cut_layer"]
    model = model_init(cfg, torch.Generator(device=dev).manual_seed(3),
                       cut_layer=cut)
    tokens = torch.randint(0, cfg.vocab, (STEPS_BATCH, STEPS_SEQ),
                           dtype=torch.int32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(4))
    batch = {"tokens": tokens, "labels": tokens}
    params = {k: v.detach() for k, v in model.named_parameters()}
    out, grads_remat = {}, {}
    for remat in (True, False):
        fn = built[remat].fn
        fn(params, _zero_opt_state(params, dev), batch)          # warm
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st = _zero_opt_state(params, dev)
        grads = {}
        rwkv6_scan.launches = rwkv6_scan_bwd.launches = 0
        t0 = time.perf_counter()
        new_p, new_st, metrics = fn(params, st, batch, grads_out=grads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[remat] = {"wall": wall, "peak": torch.cuda.max_memory_allocated(),
                      "launches": {"rwkv6_scan": rwkv6_scan.launches,
                                   "rwkv6_scan_bwd": rwkv6_scan_bwd.launches},
                      "loss": metrics["loss"]}
        if remat:
            grads_remat = grads
        else:
            out["remat_diff"] = max(float((grads[k].float() - g.float())
                                          .abs().max())
                                    for k, g in grads_remat.items())
        del new_p, new_st, st, grads, metrics
    out["estimate"] = steps_bytes_estimate(built[True].fn, params, batch,
                                           dev)
    want_launches = {True: {"rwkv6_scan": 2 * RWKV_LAYERS,
                            "rwkv6_scan_bwd": RWKV_LAYERS},
                     False: {"rwkv6_scan": RWKV_LAYERS,
                             "rwkv6_scan_bwd": RWKV_LAYERS}}
    gc.collect()
    torch.cuda.empty_cache()
    want_grads = []
    opt = AdamW(model.parameters(), 1e-4, weight_decay=0.01)
    loss, _, _ = train_step(cfg, model, opt, batch, cut_layer=cut,
                            grads_out=want_grads)
    diffs = {k: float((grads_remat[k].float() - g.float()).abs().max())
             for (k, _), g in zip(model.named_parameters(), want_grads)}
    loss_equal = torch.equal(out[True]["loss"], loss)
    grads_equal = all(torch.equal(grads_remat[k], g) for (k, _), g in
                      zip(model.named_parameters(), want_grads))
    del grads_remat, want_grads
    # a scheduled AdamW step and FunctionalAdamW update: no host sync
    sched = AdamW(model.parameters(), warmup_cosine(3e-4, 2, 10),
                  weight_decay=0.01)
    sched.step()                          # makes its scalars and moments
    torch.cuda.synchronize()
    _, syncs = count_host_syncs(sched.step)
    sub = dict(list(params.items())[:6])
    fopt = FunctionalAdamW(warmup_cosine(3e-4, 2, 10), weight_decay=0.01)
    fst = fopt.init(sub)
    g_sub = {k: torch.ones_like(v) for k, v in sub.items()}
    _, fst = fopt.update(g_sub, fst, sub)
    torch.cuda.synchronize()
    _, fsyncs = count_host_syncs(lambda: fopt.update(g_sub, fst, sub))
    torch.cuda.synchronize()
    est = out["estimate"]
    print(f"[steps] {cfg.name} built train step (remat) once more under the "
          f"dry run's bytes estimate (launch.dryrun.BytesEstimate): "
          f"estimated peak {est['estimate']} bytes (arguments "
          f"{est['arguments']} + temporary {est['temp']}), "
          f"torch.cuda.max_memory_allocated over the same step "
          f"{est['measured']} bytes ({est['base']} allocated before it): "
          f"estimate / measured {est['ratio']:.4f}, temporary estimate / "
          f"(measured - before) {est['ratio_temp']:.4f} ({card_line()})")
    for remat in (True, False):
        r = out[remat]
        print(f"[steps] {cfg.name} ({cfg.n_layers} layers) built train "
              f"step, remat {remat}, batch {STEPS_BATCH} x {STEPS_SEQ} on a "
              f"one-rank mesh: loss {float(r['loss']):.6f}, wall "
              f"{r['wall']:.4f} s, peak {r['peak'] / 2 ** 30:.2f} GiB "
              f"({r['peak']} bytes), WKV launches {r['launches']} (want "
              f"{want_launches[remat]})")
    print(f"[steps] built step (remat) vs launch.train.train_step (remat "
          f"off) on the same params and batch: loss bit-equal {loss_equal} "
          f"({float(out[True]['loss'])!r} vs {float(loss)!r}), gradients "
          f"bit-equal {grads_equal} (max abs diff {max(diffs.values())}); "
          f"remat on vs off max abs grad diff {out['remat_diff']}; host "
          f"syncs of a scheduled AdamW step {syncs}, of a scheduled "
          f"FunctionalAdamW update {fsyncs}")
    bad = [remat for remat in (True, False)
           if out[remat]["launches"] != want_launches[remat]]
    if not est["ratio"] > 0:
        raise AssertionError(f"steps: bytes estimate {est}")
    if bad or not (loss_equal and grads_equal) or syncs or fsyncs:
        raise AssertionError(f"steps: launches off for remat {bad}, loss "
                             f"{loss_equal}, grads {grads_equal} "
                             f"({sorted(diffs.items(), key=lambda kv: -kv[1])[:4]}"
                             f"), syncs {syncs}/{fsyncs}")
    del model, opt, sched, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def steps_bytes_estimate(fn, params: dict, batch: dict, dev) -> dict:
    """One more call of the built train step ``fn`` under the dry run's
    bytes estimate (``launch.dryrun.BytesEstimate``, on real tensors of
    the card): its peak (the arguments' bytes plus the most live during
    the step) against ``torch.cuda.max_memory_allocated`` over the same
    call, after a reset of the peak."""
    import gc
    from repro_torch.launch.dryrun import BytesEstimate, _rank0_bytes
    gc.collect()
    torch.cuda.synchronize()
    st = _zero_opt_state(params, dev)
    arguments = _rank0_bytes((params, st, batch))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    estimate = BytesEstimate()
    with estimate:
        res = fn(params, st, batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated()
    del res, st
    gc.collect()
    torch.cuda.empty_cache()
    total = arguments + estimate.peak
    return {"estimate": total, "arguments": arguments, "temp": estimate.peak,
            "measured": measured, "base": base, "ratio": total / measured,
            "ratio_temp": estimate.peak / max(measured - base, 1)}


def steps_serve_path(dev) -> dict:
    """``build_prefill_step`` and ``build_decode_step`` for SmolLM-135M on
    the one-rank mesh against ``model_forward`` and ``model_decode_step``
    on the same model: the logits bit-equal, prefill at batch
    STEPS_BATCH x STEPS_SEQ, STEPS_DECODE decode steps from empty states."""
    import gc

    from repro_torch.configs import smollm_135m as cfg
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models.transformer import (decode_state_init,
                                                model_decode_step,
                                                model_forward, model_init)
    mesh = abstract_mesh((1, 1), ("data", "model"))
    prefill = build_prefill_step(cfg, InputShape(
        "prefill_steps", STEPS_SEQ, STEPS_BATCH, "prefill"), mesh)
    decode = build_decode_step(cfg, InputShape(
        "decode_steps", STEPS_SEQ, STEPS_BATCH, "decode"), mesh)
    cut = prefill.meta["cut_layer"]
    model = model_init(cfg, torch.Generator(device=dev).manual_seed(6),
                       cut_layer=cut)
    params = {k: v.detach() for k, v in model.named_parameters()}
    tokens = torch.randint(0, cfg.vocab, (STEPS_BATCH, STEPS_SEQ),
                           dtype=torch.int32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    with torch.no_grad():
        got = prefill.fn(params, {"tokens": tokens})
        want, _ = model_forward(cfg, model, {"tokens": tokens},
                                cut_layer=cut)
        prefill_equal = torch.equal(got, want)
        states = [decode_state_init(cfg, STEPS_BATCH, STEPS_SEQ, cut_layer=cut,
                                    device=dev) for _ in range(2)]
        decode_equal = True
        for t in range(STEPS_DECODE):
            a, states[0] = decode.fn(params, states[0], tokens[:, t:t + 1], t)
            b, states[1] = model_decode_step(cfg, model, states[1],
                                             tokens[:, t:t + 1], t,
                                             cut_layer=cut)
            decode_equal &= torch.equal(a, b)
    print(f"[steps] {cfg.name} built prefill (batch {STEPS_BATCH} x "
          f"{STEPS_SEQ}) == model_forward: {prefill_equal}; built decode "
          f"{STEPS_DECODE} steps == model_decode_step: {decode_equal}")
    if not (prefill_equal and decode_equal):
        raise AssertionError("steps: a built serving step differs")
    del model, params, states, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_equal": prefill_equal, "decode_equal": decode_equal}


def run_steps_path() -> dict:
    """The ``[steps]`` phase: ``steps_train_path``, ``steps_serve_path``."""
    dev = torch.device("cuda")
    out = {"train": steps_train_path(dev)}
    stamp("steps train")
    out["serve"] = steps_serve_path(dev)
    return out


def run_dryrun_path() -> dict:
    """The ``[dryrun]`` phase: ``python -m repro_torch.launch.dryrun`` for
    each combination of DRYRUN on the 16x16 mesh and of DRYRUN_MULTI_POD
    on the 2x16x16 one, one process each (the dry run starts a fake
    process group of its own), all started together, each writing its
    record and its output to a temporary directory; each record's mesh,
    status, global FLOPs, rank 0's argument bytes and estimated peak and
    temporary bytes, collectives, the ops resharded or run on an added
    rule and the retries' own collectives, its scaled ``loops`` and trace
    seconds. A process that exits non-zero or outlives
    ``DRYRUN_TIMEOUT_S``, a record not ``ok``, or a 2x16x16 record whose
    global FLOPs differ from its 16x16 record's or whose rank 0 holds more
    argument bytes, fails the phase."""
    import tempfile
    t0 = time.perf_counter()
    outdir = tempfile.mkdtemp(prefix="dryrun_")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    combos = [(arch, shape, "pod16x16") for arch, shape in DRYRUN] + [
        (arch, shape, "pod2x16x16") for arch, shape in DRYRUN_MULTI_POD]
    procs = []
    try:
        for arch, shape, mesh in combos:
            with open(os.path.join(outdir, f"{arch}__{shape}__{mesh}.log"),
                      "w") as log:
                procs.append(((arch, shape, mesh), subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--outdir", outdir,
                     *(["--multi-pod"] if mesh == "pod2x16x16" else [])],
                    env=env, stdout=log, stderr=subprocess.STDOUT)))
        recs = {}
        for (arch, shape, mesh), proc in procs:
            left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
            proc.wait(timeout=max(left, 1))
            name = f"{arch}__{shape}__{mesh}"
            if proc.returncode != 0:
                with open(os.path.join(outdir, f"{name}.log")) as f:
                    log = f.read()
                raise AssertionError(f"dryrun {arch} x {shape} on {mesh} "
                                     f"exited {proc.returncode}: "
                                     f"{log[-4000:]}")
            with open(os.path.join(outdir, f"{name}.json")) as f:
                rec = json.load(f)
            if rec["status"] != "ok":
                raise AssertionError(f"dryrun {arch} x {shape} on {mesh}: "
                                     f"{rec}")
            coll = {k: v for k, v in rec["collectives"].items()
                    if k != "total_bytes" and v["count"]}
            print(f"[dryrun] {arch} x {shape} on {mesh}: {rec['status']}, "
                  f"flops_global {rec['flops_global']:.6e}, argument bytes "
                  f"rank 0 {rec['argument_bytes_rank0']}, output bytes rank 0 "
                  f"{rec['output_bytes_rank0']}, collectives {coll} (total "
                  f"{rec['collectives']['total_bytes']} bytes), resharded "
                  f"{rec['resharded']} (their collectives "
                  f"{rec['collectives_resharded']['total_bytes']} bytes), "
                  f"rules added {rec['rules_added']}, trace "
                  f"{rec['trace_s']} s, bodies "
                  f"{[(b['kind'], b['count'], b['flops_global']) for b in rec['bodies']]}"
                  f", arguments fit {rec['fits']['card']} "
                  f"({rec['fits']['card_from']}): "
                  f"{rec['fits']['arguments_fit']}; peak bytes rank 0 "
                  f"estimate {rec['peak_bytes_rank0_estimate']} (temporary "
                  f"{rec['temp_bytes_rank0_estimate']}), fits: "
                  f"{rec['fits']['peak_fits_estimate']}")
            if rec["loops"]:
                print(f"[dryrun] {arch} x {shape} on {mesh} loops (one "
                      f"settled step traced, counted once a step): "
                      f"{rec['loops']}; trace {rec['trace_s']} s")
            recs[(arch, shape, mesh)] = rec
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(outdir, ignore_errors=True)
    for arch, shape in DRYRUN_MULTI_POD:
        one, two = recs[(arch, shape, "pod16x16")], \
            recs[(arch, shape, "pod2x16x16")]
        print(f"[dryrun] {arch} x {shape} pod2x16x16 against pod16x16: "
              f"flops_global {two['flops_global']:.6e} / "
              f"{one['flops_global']:.6e}, argument bytes rank 0 "
              f"{two['argument_bytes_rank0']} / "
              f"{one['argument_bytes_rank0']}")
        if two["flops_global"] != one["flops_global"] or \
                two["argument_bytes_rank0"] > one["argument_bytes_rank0"]:
            raise AssertionError(f"dryrun {arch} x {shape}: the 2x16x16 "
                                 f"record breaks the mesh invariants")
    wall = time.perf_counter() - t0
    print(f"[dryrun] {len(procs)} combinations read in {wall:.1f} s (one "
          f"process each, started together)")
    return {"recs": recs, "wall": wall}


def analyze_lint() -> int:
    """The port's source tree through the AST lint
    (``analyze.lint_paths``): any finding fails. Returns the files
    linted."""
    from pathlib import Path

    from repro_torch.analyze import lint_paths
    here = Path(__file__).resolve().parent
    report = lint_paths([here / "src" / "repro_torch"], repo_root=here)
    print(f"[analyze] lint: {len(report.checked)} files of src/repro_torch, "
          f"{len(report.findings)} finding(s)")
    if not report.ok:
        raise AssertionError("lint findings: " + "; ".join(
            str(f) for f in report.findings))
    return len(report.checked)


def analyze_matrix(dev, mesh=None) -> dict:
    """The variant matrix (``analyze.variants``: 22 entries) compiled on
    ``dev`` and audited (``analyze.audit_all``), its ``shard_map`` entries
    on ``mesh``: one line a raw or Monte-Carlo round with its host syncs
    (the dispatch audit's, and on the card CUDA's sync-debug count), float64
    tensors, collectives and their groups, and the kernel seams' calls and
    launches. Any finding fails. Returns the entries' names and the
    launches summed over the audited rounds."""
    from repro_torch.analyze import audit_all
    names = []

    def entry(name, report):
        names.append(name)
        for line in report.checked:
            print(f"[analyze] {line}")
        for f in report.findings:
            print(f"[analyze] finding: {f}")

    t0 = time.perf_counter()
    report = audit_all(device=dev, mesh=mesh, on_entry=entry)
    print(f"[analyze] {len(names)} matrix entries audited on {dev} in "
          f"{time.perf_counter() - t0:.1f} s: {len(report.findings)} "
          f"finding(s)")
    if not report.ok or len(names) != 22:
        raise AssertionError(f"the variant matrix ({len(names)} entries) has "
                             f"findings: " + "; ".join(
                                 str(f) for f in report.findings))
    return {"names": names, "checked": report.checked}


def arch_split_path(dev, cfg=None, *, cut=ARCH_SPLIT["cut"],
                    batch=ARCH_SPLIT["batch"], seq=ARCH_SPLIT["seq"]) -> dict:
    """``fleet.hetero.arch_split_program`` on ``cfg`` (SmolLM-135M whole)
    in f32 cut at ``cut``, attention on the flash kernel, against the
    same program on the plain chunked attention (``stack_split_program``
    over the same blocks): one split step's smashed tensor and loss within
    the flash tolerance (``FLASH_ATOL``) of each one's largest magnitude,
    then the step (forward and backward) timed, with its flash
    launches."""
    from repro_torch.configs import smollm_135m
    from repro_torch.fleet.hetero import (arch_split_program,
                                          stack_split_program,
                                          transformer_block_apply)
    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.obs.timeline import fenced
    cfg = dataclasses.replace(cfg or smollm_135m, dtype="float32")

    def loss_fn(h, targets):
        return ((h.mean(-1) - targets) ** 2).mean()

    g = torch.Generator(device=dev).manual_seed(0)
    prog = arch_split_program(cfg, g, cut, loss_fn=loss_fn,
                              attn_impl="pallas")
    plain = stack_split_program(
        torch.nn.ModuleList([*prog.client, *prog.server]), cut,
        block_apply=transformer_block_apply(cfg, attn_impl="xla"),
        loss_fn=loss_fn)
    x = 0.5 * torch.randn(batch, seq, cfg.d_model, device=dev, generator=g)
    batch_d = {"inputs": x,
               "targets": torch.randn(batch, seq, device=dev, generator=g)}
    with torch.no_grad():
        out = {}
        for name, p in (("flash", prog), ("plain", plain)):
            sm = p.step.client_fwd(p.client, x)
            loss, _ = p.step.loss_fn(p.client, p.server, batch_d)
            out[name] = (sm, loss)
    tol = FLASH_ATOL["float32"]
    err_sm = float((out["flash"][0] - out["plain"][0]).abs().max())
    err_loss = abs(float(out["flash"][1]) - float(out["plain"][1]))
    scale = float(out["plain"][0].abs().max())
    loss_scale = max(1.0, abs(float(out["plain"][1])))
    print(f"[analyze] arch_split_program {cfg.name} ({cfg.n_layers} layers, "
          f"d {cfg.d_model}, f32) cut {cut}, batch {batch} x {seq}: smashed "
          f"{tuple(out['flash'][0].shape)} max_abs_err {err_sm:.3e} (max "
          f"|smashed| {scale:.4g}: {err_sm / scale:.3e} of it), loss flash "
          f"{float(out['flash'][1]):.8f} plain {float(out['plain'][1]):.8f} "
          f"(abs err {err_loss:.3e}); tolerance {tol} of each one's largest "
          f"magnitude (at least 1)")
    # the flash kernel's tolerance on the residual stream's scale: its
    # values reach ~15 after 8 layers, where one f32 rounding is ~1e-6
    if not (err_sm <= tol * max(1.0, scale) and err_loss <= tol * loss_scale):
        raise AssertionError("arch_split_program on the flash kernel "
                             "differs from the plain attention")
    del out

    def step():
        for p in (*prog.client.parameters(), *prog.server.parameters()):
            p.grad = None
        loss, _ = prog.step.loss_fn(prog.client, prog.server, batch_d)
        loss.backward()
        return loss

    step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    before = flash_attention.launches
    (loss, wall) = fenced(step)
    launches = flash_attention.launches - before
    print(f"[analyze] arch_split_program split step (forward + backward) "
          f"{wall:.4f} s, flash launches {launches} (want {cfg.n_layers}: "
          f"one a layer), loss {float(loss.detach()):.8f}")
    if dev.type == "cuda" and launches != cfg.n_layers:
        raise AssertionError(f"the split step launched flash {launches} "
                             f"times, want {cfg.n_layers}")
    return {"wall": wall, "launches": launches, "err": err_sm,
            "loss_err": err_loss}


def run_analyze_path() -> dict:
    """The ``[analyze]`` phase: the lint (``analyze_lint``), the variant
    matrix audited on the card with the flash and fused int8 kernels on,
    its ``shard_map`` entries on a one-rank NCCL group
    (``analyze_matrix``), and SmolLM-135M's stack split on the flash
    kernel (``arch_split_path``). Returns the flash and int8 launches of
    the phase, counted from 0."""
    import torch.distributed as dist

    from repro_torch.kernels.attn.flash import flash_attention
    from repro_torch.kernels.quant.int8 import quant_dequant_int8
    from repro_torch.launch.mesh import data_mesh
    dev = torch.device("cuda")
    analyze_lint()
    flash_attention.launches = 0
    quant_dequant_int8.launches = 0
    tmp = nccl_group()
    try:
        matrix = analyze_matrix(dev, data_mesh())
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    stamp("analyze matrix")
    split = arch_split_path(dev)
    launches = {"flash_attention": flash_attention.launches,
                "quant_dequant_int8": quant_dequant_int8.launches}
    print(f"[analyze] launches over the phase: {launches}")
    if not (launches["flash_attention"] and launches["quant_dequant_int8"]):
        raise AssertionError(f"[analyze] did not run both kernels: "
                             f"{launches}")
    return {"launches": launches, "matrix": matrix, "split": split}


def demangle(names):
    """C++ names as ``c++filt`` prints them, or as they are without it."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


# the int8 kernels' vector instantiations the link shapes launch (f32, no
# residual): G 8, V 1 at (12544, 32); G 32, V 5 at (8192, 576)
INT8_MAIN_INSTANCES = ("quant_dequant_int8_vec<float, float, false, 8, 1>",
                       "quant_dequant_int8_vec<float, float, false, 32, 5>",
                       "quantize_int8_vec<float, 8, 1>",
                       "quantize_int8_vec<float, 32, 5>")


def print_ptxas(logs: dict):
    """Each kernel's registers, stack and spills from the ``-Xptxas=-v``
    build logs (empty when the library was already built). The int8
    kernels' many vector instantiations get one summary line, with the
    main paths' own in full; any spill in the int8 library raises."""
    for lib, log in logs.items():
        rows, name = [], None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = m.group(1)
                rows.append([name, ""])
            elif name and ("spill" in line or "registers" in line):
                rows[-1][1] += line.strip().replace("ptxas info    : ", "") \
                    + " "
        vec, loop = [], []
        for (_, props), pretty in zip(rows, demangle([r[0] for r in rows])):
            pretty = pretty.replace("(anonymous namespace)::", "")
            loop.append(props)
            if lib == "quant_int8" and "int8_vec" in pretty:
                loop.pop()
                vec.append((pretty, props))
                if not (any(k in pretty for k in INT8_MAIN_INSTANCES)
                        or re.search(r"[1-9]\d* bytes (spill|stack)", props)):
                    continue
            print(f"[ptxas] {lib}: {pretty}: {props.strip()}")
        if lib != "quant_int8":
            continue
        regs = [int(r) for _, p in vec for r in re.findall(
            r"Used (\d+) registers", p)]
        spilled = [name for name, p in vec
                   if re.search(r"[1-9]\d* bytes spill", p)]
        spills = sum(int(b) for _, p in vec for b in re.findall(
            r"(\d+) bytes spill", p))
        if vec:
            print(f"[ptxas] quant_int8: {len(vec)} vector-path "
                  f"instantiations, {min(regs)}-{max(regs)} registers; "
                  f"{len(spilled)} of them (printed above) spill, "
                  f"{spills} bytes of spill stores and loads in all")
        main = [n for n in spilled if any(k in n for k in INT8_MAIN_INSTANCES)]
        if main or any(re.search(r"[1-9]\d* bytes spill", p) for p in loop):
            raise AssertionError(f"an int8 kernel of the link shapes or of "
                                 f"the loop path spills registers: {main}")


def print_hmma(lib: str):
    """The count of tensor-core MMA instructions (HMMA) in each kernel of
    ``lib``'s SASS, from ``cuobjdump -sass``, where the toolkit has it."""
    from repro_torch.kernels.build import library_path, nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        print(f"[sass] {lib}: no cuobjdump beside nvcc")
        return
    sass = subprocess.run([tool, "-sass", str(library_path(lib))],
                          capture_output=True, text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    for (_, n), pretty in zip(counts.items(), demangle(list(counts))):
        print(f"[sass] {lib}: "
              f"{pretty.replace('(anonymous namespace)::', '')}: {n} HMMA")


T_START = time.perf_counter()


def stamp(phase: str):
    """The script's elapsed host time at the end of a phase."""
    print(f"[phase] {phase} done at {time.perf_counter() - T_START:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build_all     # the port, or fail
    card = card_line()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = build_all()
    print(f"[setup] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    print_ptxas(logs)
    print_hmma("flash_attn")

    stamp("build")

    max_err = check_quant_kernel(dev)
    wire_err = check_wire_kernels(dev)
    check_int8_plans(dev)
    flash_err = check_flash_kernel(dev)
    wkv_err, wkv_bwd_err = check_wkv_kernel(dev)
    wkv_state_err, wkv_state_bwd_err = check_wkv_state_kernels(dev)
    stamp("kernel checks")
    time_quant_kernel(dev)
    timing = time_quant_kernel(dev, LM_M, LM_D)
    time_wire_kernels(dev, MAIN_M, MAIN_D)
    wire_timing = time_wire_kernels(dev, LM_M, LM_D)
    flash_timing = time_flash_kernel(dev)
    wkv_timing = time_wkv_kernel(dev)
    wkv_bwd_timing = time_wkv_bwd(dev)
    time_wkv_decode(dev)
    stamp("kernel times")

    import repro_torch.api as api
    from repro_torch.kernels.quant.int8 import (dequantize_int8,
                                                quant_dequant_int8,
                                                quantize_int8)

    # the wire pair's counts cover every main path (CNN, split LM, RWKV)
    # and nothing else: the checks and times above come before the reset
    quantize_int8.launches = 0
    dequantize_int8.launches = 0
    t0 = time.perf_counter()
    sl = api.compile_experiment(main_spec(api, "sl", rounds=2))
    print(f"[sl] compiled in {time.perf_counter() - t0:.2f} s: cut after "
          f"{sl.stages[sl.cut_of_client[0] - 1].name}, smashed "
          f"{sl.flops[sl.cut_of_client[0]][2].shape}")
    quant_dequant_int8.launches = 0
    sl_state, sl_recs = run_plan(sl, "sl")
    launches = quant_dequant_int8.launches
    spec = sl.spec
    want = (sl.num_rounds * spec.local_steps * spec.clients.num_clients)
    print(f"[sl] quant_dequant_int8 launches on the CNN path: {launches} "
          f"(want {want})")
    if sl.num_rounds != 2 or launches != want:
        raise AssertionError(f"main path launched the kernel {launches} "
                             f"times over {sl.num_rounds} rounds, want {want}")
    profile_call(lambda: sl.run_round(sl_state), "sl", "round")
    check_against_cpu(api)

    fl = api.compile_experiment(main_spec(api, "fl", rounds=1))
    fl_state, fl_recs = run_plan(fl, "fl")
    profile_call(lambda: fl.run_round(fl_state), "fl", "round")
    sl_client = sl_recs[0].client_energy_j
    fl_client = fl_recs[0].client_energy_j
    print(f"[fl] client energy per round: SL {sl_client:.6g} J < "
          f"FL {fl_client:.6g} J")
    if not sl_client < fl_client:
        raise AssertionError("SL client energy is not below FL's")

    stamp("CNN paths")
    paper = run_paper_path(api, dev)
    stamp("paper path")
    lm_launches = run_lm_path(api)
    stamp("split-LM path")

    # the fleet engines: the two kernels' vmap rules and their times at
    # the batched shapes (outside any path's counts), then the three vmap
    # paths, each read over its own run
    vmap_errs = check_vmap_rules(dev)
    check_seed_rule(dev)
    for m, d in VMAP_INT8 + HETERO_INT8:
        time_quant_kernel(dev, m, d)
    time_quant_kernel(dev, *MC_INT8)
    for shape in FLASH_VMAP:
        time_flash_kernel(dev, shape, bf16=False)
    stamp("vmap rules and batched kernel times")
    fleet_launches = run_fleet_cnn_paths(api)
    fleet_launches.update(run_lm_vmap_path(api))
    stamp("lm/vmap path")
    cohort = run_cohort_paths(api)
    stamp("cohort paths")
    hetero = run_hetero_path(api)
    stamp("hetero path")
    scenario_plan, scenario_launches = run_scenario_path(api)
    stamp("scenario path")
    mc = run_mc_path(scenario_plan)
    del scenario_plan
    stamp("Monte-Carlo path")
    mc_scan = run_mc_scan_path(api)
    stamp("Monte-Carlo scan-engine path")
    obs = run_obs_path(api)
    stamp("obs path")
    sm = run_shard_map_path(api)
    stamp("shard_map path")
    srv = run_server_mesh_path(api, mc["det"])
    stamp("server-mesh path")

    rwkv_launches = run_rwkv_path()
    stamp("RWKV path")
    serve_launches = run_serve_path()
    stamp("serve path")
    wire_launches = {"quantize_int8": quantize_int8.launches,
                     "dequantize_int8": dequantize_int8.launches}
    print(f"[paths] wire-format pair launches over the CNN, split-LM, vmap, "
          f"RWKV and serve paths: {wire_launches} (no path of the port calls "
          f"them)")
    moe = run_moe_path()
    stamp("moe path")
    encdec = run_encdec_path(api)
    stamp("encdec path")
    ckpt = run_ckpt_path()
    stamp("ckpt path")
    steps = run_steps_path()
    stamp("steps path")
    dry = run_dryrun_path()
    stamp("dryrun path")
    analyze = run_analyze_path()
    stamp("analyze path")
    print(f"[paths] ckpt: rwkv6-7b {RWKV_LAYERS} layers "
          f"{ckpt['rwkv']['size']} bytes, save/restore "
          f"{ckpt['rwkv']['save_s']:.3f}/{ckpt['rwkv']['restore_s']:.3f} s, "
          f"WKV launches {ckpt['rwkv']['launches']}; smollm-135m "
          f"{ckpt['lm']['size']} bytes, save/restore "
          f"{ckpt['lm']['save_s']:.3f}/{ckpt['lm']['restore_s']:.3f} s; "
          f"steps: rwkv6-7b train step remat on/off "
          f"{steps['train'][True]['wall']:.4f}/"
          f"{steps['train'][False]['wall']:.4f} s, peak "
          f"{steps['train'][True]['peak'] / 2 ** 30:.2f}/"
          f"{steps['train'][False]['peak'] / 2 ** 30:.2f} GiB, WKV launches "
          f"{steps['train'][True]['launches']}/"
          f"{steps['train'][False]['launches']}; dryrun "
          f"{len(dry['recs'])} combinations ok in {dry['wall']:.1f} s")
    print(f"[paths] encdec: flash at D 144..256 max_abs_err "
          f"{encdec['flash_err']}; pixtral {FLASH_PIXTRAL} f32 causal "
          f"{encdec['flash_timing']['ms']:.6f} ms (bound "
          f"{encdec['flash_timing']['bound_ms']:.6f}, SDPA "
          f"{encdec['flash_timing']['library_ms']:.6f}); pixtral "
          f"{PIXTRAL_LAYERS}-layer split LM launches {encdec['lm']['launches']}"
          f" (int8 link {PIXTRAL_INT8} f32 "
          f"{encdec['int8_timing']['ms']:.6f} ms L2 cold, bound "
          f"{encdec['int8_timing']['bound_ms']:.6f}), peak "
          f"{encdec['lm']['peak'] / 2 ** 30:.2f} GiB; "
          f"{PIXTRAL_LAYERS}-layer training losses {encdec['train']['losses']}"
          f" peak {encdec['train']['peak'] / 2 ** 30:.2f} GiB; whisper-tiny "
          f"training losses {encdec['whisper']['losses']}, transcribe "
          f"{encdec['whisper']['tok_s']:.2f} tok/s "
          f"{encdec['whisper']['ms_step']:.3f} ms a step; pixtral 40 layers "
          f"served {encdec['serve']['tok_s']:.2f} tok/s, "
          f"{encdec['serve']['ms_step']:.3f} ms a step, peak "
          f"{encdec['serve']['peak'] / 2 ** 30:.2f} GiB; reduced card vs CPU "
          f"{encdec['cpu']}")
    print(f"[paths] moe: deepseek-moe-16b MoE layer drop share at 1.25 "
          f"{moe['dispatch']['drop_share']:.6f}; 4-layer training losses "
          f"{moe['train']['losses']} peak "
          f"{moe['train']['peak'] / 2 ** 30:.2f} GiB; 28 layers served "
          f"{moe['serve']['tok_s']:.2f} tok/s, {moe['serve']['ms_step']:.3f} "
          f"ms a step, peak {moe['serve']['peak'] / 2 ** 30:.2f} GiB; jamba "
          f"Mamba fwd/bwd {moe['mamba']['fwd_s']:.4f}/"
          f"{moe['mamba']['bwd_s']:.4f} s; reduced card vs CPU "
          f"{moe['cpu']}; kernel launches {moe['launches']}")
    print(f"[paths] serve: rwkv6-7b at 32 layers {serve_launches} (RWKV "
          f"training {rwkv_launches})")
    print(f"[paths] fleet engines: sl/vmap MobileNetV2 "
          f"{fleet_launches['sl-vmap']}, fl/vmap MobileNetV2 "
          f"{fleet_launches['fl-vmap']}, sl/vmap SmolLM-135M "
          f"{fleet_launches['lm-vmap']} (peak "
          f"{fleet_launches['peak_bytes'] / 2 ** 30:.2f} GiB); vmap rules "
          f"max_abs_err {vmap_errs}")
    print(f"[paths] cohorts: sl/vmap MobileNetV2 {cohort['cohort-sl']}, "
          f"fl/vmap MobileNetV2 {cohort['cohort-fl']}, sl/vmap SmolLM-135M "
          f"{cohort['cohort-lm']} (peak "
          f"{cohort['cohort_lm_peak_bytes'] / 2 ** 30:.2f} GiB); engine "
          f"state bytes by population {cohort['state_bytes']}")
    print(f"[paths] per-client cuts: sl/vmap MobileNetV2 {HETERO_CUTS} "
          f"{hetero['hetero']}; buckets' state bytes "
          f"{hetero['state_bytes']}")
    print(f"[paths] scenario: sl/vmap MobileNetV2 {scenario_launches} int8 "
          f"launches; Monte-Carlo {MC_SEEDS} seeds x {MC_ROUNDS} rounds: "
          f"vmap {mc['mc-vmap']} int8 launches, wall vmap/loop "
          f"{mc['wall'][0]:.4f}/{mc['wall'][1]:.4f} s (loop/vmap "
          f"{mc['wall'][1] / mc['wall'][0]:.3f}), peak vmap/loop "
          f"{mc['peak'][0] / 2 ** 30:.2f}/{mc['peak'][1] / 2 ** 30:.2f} GiB, "
          f"phase s vmap/loop {mc['phase_s'][0]:.2f}/{mc['phase_s'][1]:.2f}")
    print(f"[paths] Monte-Carlo on the scan engines, {MC_SEEDS} seeds x "
          f"{MC_ROUNDS} rounds: " + "; ".join(
              f"{name} vmap {r['launches']} int8 launches, wall vmap/loop "
              f"{r['wall'][0]:.4f}/{r['wall'][1]:.4f} s (loop/vmap "
              f"{r['ratio']:.3f}), peak vmap/loop "
              f"{r['peak'][0] / 2 ** 30:.2f}/{r['peak'][1] / 2 ** 30:.2f} GiB"
              for name, r in (("sl/scan", mc_scan["a"]),
                              ("fl/scan cohort", mc_scan["b"]))))

    print(f"[paths] obs: sl/vmap MobileNetV2 with telemetry and taps "
          f"{obs['launches']} int8 launches, round walls with/without "
          f"{obs['walls']}, round/execute sync_s/dur_s {obs['execute']}, "
          f"host syncs a raw round with/without taps {obs['syncs']}, "
          f"raw round s with/without {obs['raw_s']['on']}/"
          f"{obs['raw_s']['off']}; "
          f"Monte-Carlo with taps {obs['mc']['launches']} int8 launches, "
          f"peak {obs['mc']['peak'] / 2 ** 30:.2f} GiB; reduced SmolLM "
          f"sl/vmap with taps (flash, int8) launches {obs['lm_launches']}"
          f"; full-width SmolLM sl/vmap with taps at batch {LM_VMAP_BATCH} "
          f"peak {obs['lm_taps_peak'] / 2 ** 30:.2f} GiB")
    print(f"[paths] shard_map on a one-rank NCCL group: sl MobileNetV2 "
          f"{sm['sl']['launches']} int8 launches, collectives a round "
          f"{sm['sl']['calls']}, host syncs {sm['sl']['syncs']}; fl "
          f"{sm['fl']['calls']}; SmolLM-135M {sm['lm']['launches']}, peak "
          f"{sm['lm']['peak'] / 2 ** 30:.2f} GiB")
    print(f"[paths] server-mesh on a (1, 1, 1) DeviceMesh: sl/vmap "
          f"MobileNetV2 {srv['launches']} int8 launches, bit-equal to the "
          f"plain run; server state bytes a rank by (fsdp x tp), "
          f"arithmetic: {srv['bytes']}; Monte-Carlo {MC_SEEDS} seeds x "
          f"{MC_ROUNDS} rounds over it bit-equal to [mc], vmap "
          f"{srv['mc']['launches']} int8 launches, wall vmap/loop "
          f"{srv['mc']['wall'][0]:.4f}/{srv['mc']['wall'][1]:.4f} s, peak "
          f"vmap/loop {srv['mc']['peak'][0] / 2 ** 30:.2f}/"
          f"{srv['mc']['peak'][1] / 2 ** 30:.2f} GiB")

    # launches: the counts over the split-LM path's run for the two kernels
    # on it (the CNN path's int8 count is checked above), the int8 kernel's
    # with the [paper] grid's 15 runs (each read over its own run), the
    # [hetero], [scenario], [mc] and [mc-scan] vmap runs added
    # (each count read over its own run, and the [obs] phase's sl/vmap and
    # Monte-Carlo runs with taps, the [shard_map] phase's MobileNetV2
    # sl/shard_map and SmolLM sl/shard_map runs and the [server-mesh]
    # phase's sharded sl/vmap run and its vmap sweep; the flash kernel's
    # with the SmolLM
    # sl/shard_map run's),
    # both with the [encdec] pixtral split LM's run added; over the RWKV
    # path's 3 steps, the [serve] phase's rwkv6-7b generation
    # (rwkv6_scan), the [ckpt] phase's 2 training steps and the [steps]
    # phase's two built steps (remat on and off) for the WKV kernels, over
    # all the paths for the wire-format pair
    wire = [{"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/quant_int8.cu",
             "replaces": f"src/repro/kernels/quant/int8.py:{line}",
             "launches": wire_launches[name], "max_abs_err": wire_err,
             "ms": wire_timing[name]["ms"],
             "plain_ms": wire_timing[name]["plain_ms"],
             "bound_ms": wire_timing[name]["bound_ms"], "bound_by": "bytes",
             "library_ms": None}
            for name, line in (("quantize_int8", 27), ("dequantize_int8", 36))]
    kernels = [{"name": "quant_dequant_int8", "route": "cuda",
                "source": "src/repro_torch/csrc/quant_int8.cu",
                "replaces": "src/repro/kernels/quant/int8.py:40",
                "launches": (lm_launches["quant_dequant_int8"]
                             + paper["launches"]
                             + analyze["launches"]["quant_dequant_int8"]
                             + hetero["hetero"]["quant_dequant_int8"]
                             + scenario_launches + mc["mc-vmap"]
                             + mc_scan["a"]["launches"]
                             + obs["launches"] + obs["mc"]["launches"]
                             + sm["sl"]["launches"] + srv["launches"]
                             + srv["mc"]["launches"]
                             + sm["lm"]["launches"]["quant_dequant_int8"]
                             + encdec["lm"]["launches"]["quant_dequant_int8"]),
                "max_abs_err": max(max_err, paper["max_err"]),
                "ms": timing["ms"], "plain_ms": timing["plain_ms"],
                "bound_ms": timing["bound_ms"], "bound_by": "bytes",
                "library_ms": None},
               {"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attn.cu",
                "replaces": "src/repro/kernels/attn/flash.py:35",
                "launches": (lm_launches["flash_attention"]
                             + analyze["launches"]["flash_attention"]
                             + sm["lm"]["launches"]["flash_attention"]
                             + encdec["lm"]["launches"]["flash_attention"]),
                "max_abs_err": max(flash_err["float32"],
                                   encdec["flash_err"]["float32"]),
                "ms": flash_timing["ms"],
                "plain_ms": flash_timing["plain_ms"],
                "bound_ms": flash_timing["bound_ms"],
                "bound_by": "operations",
                "library_ms": flash_timing["library_ms"]},
               *wire,
               {"name": "rwkv6_scan", "route": "cuda",
                "source": "src/repro_torch/csrc/rwkv6_scan.cu",
                "replaces": "src/repro/kernels/rwkv/scan.py:28",
                "launches": (rwkv_launches["rwkv6_scan"]
                             + serve_launches["rwkv6_scan"]
                             + ckpt["rwkv"]["launches"]["rwkv6_scan"]
                             + steps["train"][True]["launches"]["rwkv6_scan"]
                             + steps["train"][False]["launches"][
                                 "rwkv6_scan"]),
                "max_abs_err": max(wkv_err, wkv_state_err),
                "ms": wkv_timing["ms"], "plain_ms": wkv_timing["plain_ms"],
                "bound_ms": wkv_timing["bound_ms"],
                "bound_by": wkv_timing["bound_by"], "library_ms": None},
               {"name": "rwkv6_scan_bwd", "route": "cuda",
                "source": "src/repro_torch/csrc/rwkv6_scan_bwd.cu",
                # the reference's gradient: JAX's autodiff of this oracle's
                # lax.scan (its Pallas kernel has no backward)
                "replaces": "src/repro/kernels/rwkv/ref.py:9",
                "launches": (rwkv_launches["rwkv6_scan_bwd"]
                             + ckpt["rwkv"]["launches"]["rwkv6_scan_bwd"]
                             + steps["train"][True]["launches"][
                                 "rwkv6_scan_bwd"]
                             + steps["train"][False]["launches"][
                                 "rwkv6_scan_bwd"]),
                "max_abs_err": max(wkv_bwd_err, wkv_state_bwd_err),
                "ms": wkv_bwd_timing["ms"],
                "plain_ms": wkv_bwd_timing["plain_ms"],
                "bound_ms": wkv_bwd_timing["bound_ms"],
                "bound_by": wkv_bwd_timing["bound_by"], "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
