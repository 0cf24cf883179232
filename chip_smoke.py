#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving paths — retrieval-conditioned RDM sampling at
the ImageNet RDM width (exact bf16, and the int8 and encoder-reuse serving
modes), and KV-cached RARM token sampling at the ImageNet-dogs RARM width
— RDM training at the ImageNet RDM width, and the CLIP-queried requests
(captions, inpainting, adaptive re-retrieval, the nn-memory build) with a
ViT-B/32 CLIP, RARM training at the ImageNet-dogs width, and the
quality gates (the train -> sample -> FID micro gates from scratch, the
serving modes' fidelity against exact sampling), through their public
entry points, on random weights made from a seed.
Phases (each prints one line or a few; any failure raises and the script
exits non-zero):

  1. device    CUDA must be available; prints nvidia-smi's name and power
               limit of the card, and its maximum SM clock.
  2. build     builds the hand-written CUDA kernels from rdm_tpu_torch/csrc.
  3. kernels   each block kernel against its plain PyTorch version at the
               three SpatialTransformer sites of the ImageNet U-Net
               (C/S/heads = 384/1024/12, 576/256/18, 960/64/30; 2B = 8
               images, bf16): error, median CUDA-event times and device
               time (torch.profiler, per launch; phases 6, 9, 12 and 14
               give it too). The
               attention core (packed_attn, csrc/attn_fwd_sm90.cuh) also
               gives its device time (20 calls in a CUDA graph) beside
               SDPA's, its exp2 floor (ex2 count / (132 SMs x 16 a clock x
               the max SM clock)), its output equal bit for bit to
               flash_fwd's on the same memory (one core), and the host
               microseconds of one call (wrapper and bare launcher).
               ln_qkv, post_cross and geglu_ff (one, three and two
               launches of the block-GEMM core, csrc/block_gemm_sm90.cuh)
               give each launch's device time in a CUDA graph, the host us
               of a call and of the bare launcher, and, as context only,
               the same products through torch.matmul; all three are also
               held and timed at 32 images (bench.py's batch-16 op point
               under shared CFG). Then a SpatialTransformer at the C = 384
               site with a 20-token context (past one 16-token chunk of
               the cross-attention epilogue): it must launch each block
               kernel once and agree with the same module's unfused
               blocks in f32 on the CPU within FORWARD_TOL (relative L2,
               as phase 4 holds the forward).
  4. forward   one full-width U-Net forward, CUDA bf16 (kernel path)
               against CPU f32 (plain path), x batch 1 with a 2-row
               (cond, uncond) context; each kernel must launch 16 times.
  5. serve     an RDMPipeline over a 1,281,280 x 512 table made on the
               card answers a sample_with_query and a sample_unconditional
               request (batch 4, DDIM-50, guidance 2.0, k = 4, shared CFG).
  6. rarm_kernels  each RARM decode kernel against its plain PyTorch version
               at full width (C = 768, 12 heads of 64, T = 256, F = 3072,
               bf16) at B = 16 and 32, pos 0/63/200/255, k = 4 context
               rows: error and median CUDA-event times; decode_attn's two
               launches (csrc/decode_attn.cu: the projection, a kQkv
               launch of the block-GEMM core, and the split-KV
               attention) apart in CUDA graphs as plain stream launches,
               beside SDPA's device time for the attention alone, and a
               second call, a graph replay and a call with programmatic
               dependent launch off bit-equal to the first call;
               commit_rows (csrc/commit_rows.cu: TMA bulk copies under
               programmatic dependent launch; the step's call, a
               RowCommit built once a case, and the wrapper's) bit-equal
               to its plain version (every other row untouched) beside
               torch._foreach_copy_ over the caches' row-pos views, with
               host us a call; decode_post_ff's five launches of
               the block-GEMM core (csrc/decode_post_ff.cu) each timed in
               a CUDA graph, a second call, a graph replay and a call with
               PDL off bit-equal to the first call; then decode_attn's attention output on 24
               more seeds (144 cases).
  7. rarm_forward  32 teacher-forced decode steps of the full-width RARM
               (depth 18) through the kernel path, CUDA bf16, against the
               CPU f32 teacher-forced forward over the same tokens.
  8. rarm_serve    a RARMPipeline (VQ-f16 first stage) over phase 5's table
               answers a sample_with_query (batch 16, k = 4, top_k 256,
               guidance 1.0) and a sample_unconditional (batch 16,
               guidance 2.0: a decode batch of 32) request, 256 tokens
               each; then a greedy 32-step decode with the batched
               commit_rows path must give the default path's tokens.
  9. int8_kernels  each int8 block kernel against its plain version at the
               three sites of phase 3, on the same int8 weights and scales
               (the absmax of each quantized activation along the plain
               bf16 block): error, share of gated-hidden codes differing,
               median CUDA-event times, bound; for ln_qkv_q's one,
               post_cross_q's three and geglu_ff_q's two s8 launches of
               the block-GEMM core each launch's device time in a CUDA
               graph, host us a call, and a second call bit-equal to the
               first (the hidden codes too); for packed_attn_q8's three
               launches (absmax, codes, the s8 wgmma attention) each
               launch's device time, the exp2 floor, host us a call, two
               calls bit-equal, and the same tensors as heads of 64
               against the plain version.
 10. int8_forward  one full-width int8 U-Net forward, CUDA bf16 against the
               CPU bf16 and CPU f32 plain int8 forwards on the same int8
               weights and scales, and its distance from the bf16 forward;
               then one with RDM_TPU_INT8_ATTN=1 against the CPU f32 plain
               forward of that mode (16 packed_attn_q8 launches).
 11. serve_modes   over phase 5's table, batch 4, DDIM-50, guidance 2.0,
               k = 4: bf16 requests with encoder_reuse 1 (bit-identical to
               the default), 2 and 3; an int8_weights pipeline's first
               request (it calibrates), an int8 request, one with
               RDM_TPU_INT8_ATTN=1 and one with encoder_reuse=3. Launch
               counts are checked against the steps that run the full
               U-Net and those that run only its up path.
 12. rarm_int8_kernels  the decode kernels' int8 variants against their
               plain versions at phase 6's width, B = 16/32, pos
               0/63/200/255: the attention with int8 weights, with an int8
               KV cache and with both (its cache commit too: codes of row
               pos within one step of the plain ones on at most 0.1%,
               scales within 1e-5 relative, every other row untouched), and
               decode_post_ff with int8 weights: error, median CUDA-event
               times, bound; each decode_attn variant's two launches and
               bit equalities, and decode_post_ff_w8's five launches and
               bit equalities, as in phase 6.
 13. rarm_serve_modes  over phase 5's table, batch 16, 256 tokens, top_k
               256, k = 4: RARMPipeline requests with int8_weights, int8_kv,
               both (guidance 2.0: decode batch 32) and approx_top_k, launch
               counts checked per request; then 32 teacher-forced decode
               steps with int8_weights + int8_kv held against int8_weights
               alone (relative L2 of the logits).
 14. post_ff   the post-attention half in one call (RDM_TPU_SPLIT_K3=0:
               post_cross's three launches of the block-GEMM core, then
               its FF launch over a cluster, csrc/post_ff.cu) against its
               plain version at phase 3's sites, and against the split
               pair (post_cross + geglu_ff kernels) on the same inputs (its
               xm bit-equal to post_cross's, two calls bit-equal), timed
               beside the pair: kernel ms, device ms in a CUDA graph, each
               of its four launches' (the pair's five) and host us a call;
               a full-width U-Net forward through it against the split
               forward, with 16 post_ff calls, 64 block_gemm_kernel and
               16 block_gemm_ff_kernel launches (ln_qkv's and post_cross's
               three a block; torch.profiler) and none of the split pair's;
               batch-4 DDIM-50 requests, split pair and post_ff in turns,
               with 16 post_ff calls per forward.
 15. flash_kernels  the flash-attention forward and backward kernels
               against their plain versions in bf16 at the U-Net's training
               shapes [40, 1024, 12, 32] and [40, 256, 18, 32] and the
               RARM's causal [16, 256, 12, 64]: o, dq, dk, dv each within
               KERNEL_TOL of its own max|ref|; median CUDA-event times of
               kernel, plain version, SDPA (forward; forward + backward
               through autograd) and the eager-recompute backward
               (RDM_TPU_FLASH_BWD=xla); bound; for both their device
               time (a CUDA graph) beside SDPA's (forward; forward +
               backward) and the exp2 floor (one ex2 per visible score), as
               in phase 3; for the backward (csrc/flash_attn_bwd.cu, three
               TMA + wgmma launches, no atomics) also the host microseconds
               of one call, each launch's device time (torch.profiler) and
               two calls bit-equal.
 16. train     RDMTrainer at the ImageNet RDM width (VQ-f4 first stage,
               p_uncond 0.1, batch 40, bf16 compute, f32 master weights,
               random 256^2 images, neighbours from phase 5's table):
               8 steps of `fit` with a checkpoint mid-way and validation;
               10 flash_fwd + 10 flash_bwd launches per step and no block
               kernel; finite loss and grad_norm; every parameter with a
               gradient; a second trainer resumes equal to the saved state
               and continues; steps with RDM_TPU_FLASH_BWD=xla; then 2
               steps of `fit` with RDM_TPU_FUSED_BLOCK_TRAIN=1 (the fused
               blocks' training path, fused_transformer_block_ad): 16
               launches of each of ln_qkv, packed_attn, post_cross and
               geglu_ff per step and no flash launch (the blocks are the
               U-Net's only attention sites), step time and peak memory
               beside the unfused steps (context: the default stays off);
               a batch-2 step's gradients, unfused and fused blocks, each
               against the CUDA f32 plain path (TRAIN_GRAD_TOL); step
               time, samples/s, peak memory.
 17. knn       the kNN kernel pair (csrc/knn_topk.cu: a TMA + wgmma
               search, then the merge) against its plain version (f64
               sums, stable sort) over phase 5's 1,281,280 x 512 table in
               bf16 at (B, k) = (4, 4), (16, 4), (32, 4), (256, 20): scores
               within KNN_SCORE_TOL, ids equal but at near-tie ranks
               (counted); a ragged N, duplicate rows in four stripes
               (ascending ids back) and a 10-row table with negative scores
               (no id >= N); median CUDA-event times of kernel, plain
               version and torch.topk(q @ db.T); the kernel's and topk's
               device times (CUDA graph), each launch's device time
               (torch.profiler), host microseconds a call, the plan and the
               bytes it reads from HBM (one pass per query group); bound.
 18. clip_serve  a seeded ViT-B/32 CLIP: both towers in bf16 on the card
               against CPU f32 (CLIP_TOWER_TOL); an RDMPipeline with CLIP
               over phase 5's table serves sample_with_caption,
               sample_retro_adaptive (retro_every 10) and sample_inpaint
               (half mask), batch 4, DDIM-50, guidance 2.0, k = 4, with
               2 knn launches per search (2, 10 and 2) and 16 launches of
               each block kernel per U-Net forward; NNMemory.
               build_from_queries over 4,096 table rows at k = 20, batch
               256 (top-1 the query itself unless a duplicate ties); the
               RARMPipeline's caption embedding equals the RDMPipeline's.

 19. rarm_train  RARMTrainer at the ImageNet-dogs width (depth 18, C =
               768, 12 heads of 64, S = 256; phase 8's VQ-f16 first stage,
               configs/rarm/dogs.yaml's batch 16, base lr 5e-6 and
               accumulate 2, bf16 compute, f32 master weights, random
               256^2 images, k = 4 neighbours from phase 5's table): 8
               steps of `fit` with a checkpoint mid-way and validation; 18
               flash_fwd launches per step (one causal self-attention a
               block) and 18 flash_bwd where the d = 64 backward is the
               kernel by default, 0 where it is the eager recompute, no
               other kernel; finite loss and grad_norm; every parameter
               with a gradient; a second trainer resumes equal to the saved
               state and continues; one step with p_mask_max 0.25; step
               time, samples/s and peak memory with RDM_TPU_FLASH_BWD=pallas
               and =xla in one P X X P round; a batch-2 step's gradients
               against the CUDA f32 plain path (RARM_TRAIN_GRAD_TOL, over
               all of them and over each part: attn1's q, k, v and out
               projections, the cross-attention, the FF, the norms, the
               head, the embeddings), and the same gate refusing each of
               RARM_GRAD_FAULTS planted in flash_bwd's output.
 20. parallel  training at scale and data-parallel serving, every number
               beside the card's name and power limit. (a) remat: the
               ImageNet RDM through RDMTrainer's state, batches and
               optimizer at batch 40, one step without remat and one under
               each of JAX's four policies (dots, nothing, dots_no_batch,
               save_lowres) from one state and seed: the loss equal,
               grad_norm within PARALLEL_GRAD_TOL, step ms and peak GiB;
               the forward-and-backward peaks at batch 20 and 40 for the
               memory slopes, then two steps under nothing and
               save_lowres at the first even batch whose extrapolated
               no-remat peak passes the card (a policy runs there only
               where its own extrapolated peak fits). (b)
               world 1 over NCCL (a file:// store in a temporary
               directory): two DDP and two FSDP steps of the RDM at batch
               40 and the RARM at batch 16 against the plain steps from the
               same state (cuDNN deterministic): losses equal, params
               within PARALLEL_PARAM_TOL relative L2, the flash launches
               equal; an FSDP RARMTrainer's checkpoint resumed in a plain
               RARMTrainer gives the same next loss. (c) the table split
               into 2 and 4 row shards at (B, k) = (16, 4) and (256, 20):
               a kernel search a shard, ids offset, the merge the
               db-sharded search runs after its all-gather; ids as the
               unsharded kernel's but at near ties (phase 17's rule),
               device ms beside the unsharded search's; the db-sharded
               search itself over NCCL. (d) one RDM and one RARM request
               through `mesh=` pipelines, bit-equal to the plain ones.
 21. quality   the quality gates (rdm_tpu_torch/eval/). (a) Each kernel
               the gates launch at the gates' shapes against its plain
               version (KERNEL_TOL): ln_qkv, packed_attn, post_cross and
               geglu_ff at C = 64 as 2 heads of 32, 4 x 4 tokens, T = 3
               context rows, 64 images; decode_attn and decode_post_ff at
               C = 64 as 1 head of 64, B = 64, T = 64, pos 0 / 31 / 63;
               the kNN pair over the 256 x 48 pool at k = 3. (b) Both
               micro gates (procedural shapes -> a VQ-f2 trained from
               scratch -> an RDM / a RARM trained from the JAX
               initialisers through the trainers -> the pipelines'
               sampling -> FID / precision / recall against the random
               init), the kernels' head split: the RDM at its fast tier
               (900 steps, the JAX gate's ratio 0.8) at seed 0, the RARM
               at its full tier (3000 steps, 0.7) at seeds 0-4 on the
               median fid_ratio (QUALITY_GATES says why): the fid_ratio
               (the median) under the ratio and every seed's precision
               above its random init's; the RARM's fast tier (900 steps,
               0.93) at seed 0, the JAX gate's own run, is run and its
               verdict printed, and gates nothing. Each run must have
               launched each of its model's kernels, and each report is
               one JSON line. Every gate run is a process of its own,
               side by side with (c) in this one: all are host-bound.
               (c) The fidelity harness at phase 5's op point
               (batch 4, DDIM-50, guidance 2.0, k = 4, shared CFG): an
               exact run, a second one and encoder_reuse=1 bit-equal to
               it, then reuse 2 / 3 / 5, int8, int8 + reuse 2 and int8 +
               reuse 3 against it (per-step pred_x0 cosine, latent and
               image PSNR; the int8 modes on the pipeline's int8 twin),
               then an exact run bit-equal to the first; every record
               finite, each with its wall seconds and the card.

Each phase's wall seconds follow it on a line of their own.

The second-to-last line is one JSON object with the per-kernel numbers:
name, route, source, replaces, launches, max_abs_err, ms, plain_ms,
bound_ms (the larger of operations over the card's peak for their type
and bytes over its memory rate, for this run's shapes), bound_by and
library_ms (scaled_dot_product_attention where it computes the same
function, else null). For the block kernels and their int8 variants the
times are the sum over the three sites, `max_abs_err` the largest over the
sites, and `launches` the count over the two RDM serve requests and, for
the four bf16 block kernels, phase 16's fused-block training steps
(`launches_by_phase` splits it; int8: over the int8 requests of phase 11); for the decode kernels the times are
the mean over the eight (B, pos) cases, `max_abs_err` the largest, and
`launches` the count over the two RARM requests (`commit_rows`: over the
batched-commit decode, the path that runs it); their int8 variants the
same over phase 12's cases, `launches` over phase 13's requests
(decode_attn's rows also give each launch's device ms apart, the
projection's `qkv_device_ms` and the attention's `attn_device_ms`, and
SDPA's `library_device_ms` over the same rows, an int8 cache's rows
dequantized; commit_rows' `library_ms` / `library_device_ms`
torch._foreach_copy_ over the row-pos views); post_ff
the sum over the sites, `launches` over phase 14's post_ff requests;
flash_fwd / flash_bwd the sum over phase 15's three shapes (`library_ms`:
SDPA forward, and forward + backward), `launches` over the first
trainers' 8 steps of phases 16 and 19 and phase 20's steps
(`launches_by_phase` splits it; `parallel` holds phase 20's remat and
world-1 numbers); knn the op point B = 16, k = 4 of phase 17
(every case under `cases`; `library_ms` torch.topk(q @ db.T), two calls
with no promise on tie order), `launches` over phase 18's requests and
nn-memory build and phase 20's searches (`launches_by_phase`; `parallel`
the sharded cases). Phase 21's launches (the gates' and the fidelity
pass's) are added to the rows of the kernels they ran, under
`launches_by_phase` "quality"; the rows of the kernels phase 21 (a) held
give their `quality_rel_err`, and knn's row carries the gate reports and
fidelity records under `quality`. The rows of packed_attn and
flash_fwd, one core, name its
header beside their launchers under `sources`, as the rows of the core's
launchers and packed_attn_q8's do theirs (packed_attn_q8's also its
`exp2_floor_ms` over the sites).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
SITES = ((384, 1024, 12), (576, 256, 18), (960, 64, 30))  # C, S, heads
CFG_BATCH = 8   # 2B images at the block sites (batch 4 under shared CFG)
CONTEXT = 4     # k = 4 neighbors
# Kernel vs plain version, both bf16: max|err| / max|ref|. The two round
# to bf16 (2^-9 relative) at different points and sum in different
# orders, so a correct kernel sits near 1e-2 of the output scale at worst.
KERNEL_TOL = 2e-2
# CUDA bf16 forward vs CPU f32 forward of the whole U-Net, relative L2:
# bf16 activations through ~60 residual layers.
FORWARD_TOL = 3e-2
TIMING_RUNS = 20

KERNEL_INFO = {
    "ln_qkv": ("rdm_tpu_torch/csrc/ln_qkv.cu",
               "rdm_tpu/ops/block_kernel.py:127"),
    "packed_attn": ("rdm_tpu_torch/csrc/packed_attn.cu",
                    "rdm_tpu/ops/block_kernel.py:154"),
    "post_cross": ("rdm_tpu_torch/csrc/post_cross.cu",
                   "rdm_tpu/ops/block_kernel.py:361"),
    "geglu_ff": ("rdm_tpu_torch/csrc/geglu_ff_sm90.cu",
                 "rdm_tpu/ops/block_kernel.py:423"),
}
# the block-GEMM core that ln_qkv (one launch), post_cross (three) and
# geglu_ff (two) run, over the attention header's PTX pieces
GEMM_CORE = ["rdm_tpu_torch/csrc/block_gemm_sm90.cuh",
             "rdm_tpu_torch/csrc/attn_fwd_sm90.cuh"]
GEMM_LAUNCHES = {"ln_qkv": ("qkv",),
                 "post_cross": ("x1", "cross", "xmid"),
                 "geglu_ff": ("geglu_up", "ff_down")}
LONG_CONTEXT = 20  # past one 16-token chunk of the cross epilogue
# bench.py's batch-16 op point under shared CFG: 32 images at the sites
OP_POINT_IMAGES = 32
# ln_qkv_q (one), post_cross_q (three) and geglu_ff_q (two) are s8
# launches of the block-GEMM core (its block_gemm_s8_kernel)
INT8_GEMM_LAUNCHES = {"ln_qkv_q": ("qkv",),
                      "post_cross_q": ("x1", "cross", "xmid"),
                      "geglu_ff_q": ("geglu_up", "ff_down")}
# packed_attn_q8's three launches (csrc/packed_attn_q8.cu, rdmk::attn8),
# over the core's s8 wgmma and the attention header's PTX pieces
ATTN8_LAUNCHES = ("absmax", "codes", "attention")
ATTN8_SOURCES = ["rdm_tpu_torch/csrc/packed_attn_q8.cu",
                 "rdm_tpu_torch/csrc/block_gemm_sm90.cuh",
                 "rdm_tpu_torch/csrc/attn_fwd_sm90.cuh"]
INT8_INFO = {
    "ln_qkv_q": ("rdm_tpu_torch/csrc/ln_qkv_q.cu",
                 "rdm_tpu/ops/block_kernel.py:140"),
    "packed_attn_q8": ("rdm_tpu_torch/csrc/packed_attn_q8.cu",
                       "rdm_tpu/ops/block_kernel.py:193"),
    "post_cross_q": ("rdm_tpu_torch/csrc/post_cross_q.cu",
                     "rdm_tpu/ops/block_kernel.py:397"),
    "geglu_ff_q": ("rdm_tpu_torch/csrc/geglu_ff_q.cu",
                   "rdm_tpu/ops/block_kernel.py:456"),
}
# decode_attn: the projection (a kQkv launch of the block-GEMM core) and
# the split-KV attention, both launched from csrc/decode_attn.cu
DECODE_ATTN_SOURCES = ["rdm_tpu_torch/csrc/decode_attn.cu",
                       "rdm_tpu_torch/csrc/block_gemm_sm90.cuh"]
DECODE_INFO = {
    "decode_attn": ("rdm_tpu_torch/csrc/decode_attn.cu",
                    "rdm_tpu/ops/decode_kernel.py:135",
                    DECODE_ATTN_SOURCES),
    "decode_post_ff": ("rdm_tpu_torch/csrc/decode_post_ff.cu",
                       "rdm_tpu/ops/decode_kernel.py:275",
                       ["rdm_tpu_torch/csrc/decode_post_ff.cu",
                        "rdm_tpu_torch/csrc/block_gemm_sm90.cuh"]),
    "commit_rows": ("rdm_tpu_torch/csrc/commit_rows.cu",
                    "rdm_tpu/ops/decode_kernel.py:352",
                    ["rdm_tpu_torch/csrc/commit_rows.cu",
                     "rdm_tpu_torch/csrc/attn_fwd_sm90.cuh"]),
}
INT8_DECODE_INFO = {
    "decode_attn_w8": ("rdm_tpu_torch/csrc/decode_attn.cu",
                       "rdm_tpu/ops/decode_kernel.py:135",
                       DECODE_ATTN_SOURCES),
    "decode_attn_kv8": ("rdm_tpu_torch/csrc/decode_attn.cu",
                        "rdm_tpu/ops/decode_kernel.py:135",
                        DECODE_ATTN_SOURCES),
    "decode_attn_w8_kv8": ("rdm_tpu_torch/csrc/decode_attn.cu",
                           "rdm_tpu/ops/decode_kernel.py:135",
                           DECODE_ATTN_SOURCES),
    "decode_post_ff_w8": ("rdm_tpu_torch/csrc/decode_post_ff.cu",
                          "rdm_tpu/ops/decode_kernel.py:275",
                          ["rdm_tpu_torch/csrc/decode_post_ff.cu",
                           "rdm_tpu_torch/csrc/block_gemm_sm90.cuh"]),
}
# decode_post_ff's five launches of the block-GEMM core, in launch order
DECODE_CHAIN = ("x1", "cross", "xm", "geglu_up", "ff_down")
POST_FF_INFO = ("rdm_tpu_torch/csrc/post_ff.cu",
                "rdm_tpu/ops/block_kernel.py:264")
# post_ff's four launches of the core (post_cross's three, its FF launch)
# and the split pair's five, in launch order
POST_FF_LAUNCHES = ("x1", "cross", "xmid", "ff")
SPLIT_PAIR_LAUNCHES = ("x1", "cross", "xmid", "geglu_up", "ff_down")
FLASH_INFO = {
    "flash_fwd": ("rdm_tpu_torch/csrc/flash_attn_fwd.cu",
                  "rdm_tpu/ops/flash_attention.py:38"),
    "flash_bwd": ("rdm_tpu_torch/csrc/flash_attn_bwd.cu",
                  "rdm_tpu/ops/flash_attention.py:126"),
}
# the attention-forward core that packed_attn and flash_fwd launch
ATTN_CORE = "rdm_tpu_torch/csrc/attn_fwd_sm90.cuh"
KNN_INFO = ("rdm_tpu_torch/csrc/knn_topk.cu",
            "rdm_tpu/ops/knn_kernel.py:57")
# (B, k) of phase 17: the RDM requests' batch 4, the kNN op point B = 16
# (ROADMAP), the RARM requests' B = 32 and the nn-memory build's 256 x 20
KNN_CASES = ((4, 4), (16, 4), (32, 4), (256, 20))
KNN_OP_POINT = (16, 4)  # the case whose times head the kernel's JSON row
# Kernel against plain, both f32 sums of the same bf16 products in another
# order: scores within 1e-5 (a unit-norm score's f32 sums carry ~1e-7),
# ids equal except at a rank whose plain score lies within 2e-6 of a
# neighbouring rank's, where another summation order may swap the two.
KNN_SCORE_TOL = 1e-5
KNN_NEAR_TIE = 2e-6
# Phase 18: the ViT-B/32 towers in bf16 on the card against CPU f32,
# relative L2: bf16 activations through 12 residual layers, as the U-Net's
# FORWARD_TOL.
CLIP_TOWER_TOL = 3e-2
SMOKE_CAPTIONS = ["a photograph of a golden retriever on a beach",
                  "an oil painting of a lighthouse at dusk",
                  "two cats asleep on a red sofa",
                  "a bowl of ramen, top view"]
# B, S, heads, head_dim, causal: the ImageNet U-Net's ds-2 and ds-4
# self-attention at the training batch, and the RARM's causal shape
FLASH_SHAPES = ((40, 1024, 12, 32, False), (40, 256, 18, 32, False),
                (16, 256, 12, 64, True))
TRAIN_BATCH = 40   # configs/rdm/imagenet.yaml:44
TRAIN_STEPS = 8    # the first trainer's; a checkpoint after the 5th
FLASH_PER_STEP = 10  # ds-2 and ds-4 sites hold 5 blocks each
# Phase 16's fit with RDM_TPU_FUSED_BLOCK_TRAIN=1: each of the four block
# kernels once a block a step, over the U-Net's 16 blocks
FUSED_TRAIN_STEPS = 2
FUSED_TRAIN_KERNELS = ("ln_qkv", "packed_attn", "post_cross", "geglu_ff")
FUSED_PER_STEP = 16
# Phase 19: the RARM at configs/rarm/dogs.yaml's batch, 8 steps of fit (a
# checkpoint after the 5th), one step of the mask-token augmentation, and
# the d = 64 backward's A/B (RDM_TPU_FLASH_BWD) in one P X X P round
RARM_TRAIN_BATCH = 16
RARM_TRAIN_STEPS = 8
RARM_P_MASK_MAX = 0.25
RARM_AB_ROUNDS = ("pallas", "xla", "xla", "pallas")
RARM_AB_STEPS = 4
# A batch-2 RARM step, the bf16 kernel path against the CUDA f32 plain
# path, relative L2 of all 230.9M gradients and of each part (attn1's q,
# k, v and out projections, the cross-attention, the FF, the norms, the
# head, the embeddings). The residual stream grows through 18 layers
# (norm ~120 at the head at these weights) and every layer rounds it to
# bf16: the JAX package's own bf16 step sits 3.05e-2 from its f32 step at
# depth 18 (tests/test_torch_port_rarm_train.py's slow test, on the CPU at
# C = 128 with 2 heads, where the port's sits 2.8e-2 from its own). On an NVIDIA H100
# 80GB HBM3 at 700 W the sound runs measured 3.0e-2 to 3.9e-2 over all and
# 2.8e-2 to 4.6e-2 in the parts; the planted faults below put their worst
# part at 0.85 to 1.0 and the whole at 0.19 to 0.65. The limit sits
# between: 8e-2, not the RDM's TRAIN_GRAD_TOL.
RARM_TRAIN_GRAD_TOL = 8e-2
# Faults planted in the flash backward kernel's (dq, dk, dv) for the
# batch-2 step above: the gate must refuse each of them
RARM_GRAD_FAULTS = {
    "dq zeroed": lambda dq, dk, dv: (torch.zeros_like(dq), dk, dv),
    "dk zeroed": lambda dq, dk, dv: (dq, torch.zeros_like(dk), dv),
    "dv halved": lambda dq, dk, dv: (dq, dk, dv * 0.5),
}
# One full-width train step at batch 2, the bf16 kernel path against the
# CUDA f32 plain path (RDM_TPU_FLASH=0) on the same draws, relative L2 of
# all 400.9M gradients: bf16 activations through the U-Net's ~60 residual
# layers and back. On an NVIDIA H100 80GB HBM3 at 700 W it measured
# 5.569e-3 (losses 7.1e-4 apart, cosine 0.999987), so the limit is 2e-2:
# room for other draws and weights, and well below what a lost or wrong
# gradient path (a whole block's share of the norm) would give.
TRAIN_GRAD_TOL = 2e-2
# Phase 20: remat under each of JAX's four policies at batch 40 (the same
# state and seed: the loss is computed before any recompute, so it must be
# equal; grad_norm within PARALLEL_GRAD_TOL relative, the backward's sums
# in another order), then a batch past what no remat holds: the smallest
# even batch whose forward-and-backward peak, extrapolated from batches 20
# and 40, passes PARALLEL_OVER of the card, run under a policy only where
# its own extrapolated peak stays under PARALLEL_FIT of the card (no OOM is
# provoked). World-1 DDP / FSDP steps over NCCL against the plain step
# from the same state: equal losses, params within PARALLEL_PARAM_TOL
# relative L2 after two steps. The db-sharded kNN at 2 and 4 shards.
PARALLEL_SEED = 7
PARALLEL_POLICIES = ("dots", "nothing", "dots_no_batch", "save_lowres")
PARALLEL_GRAD_TOL = 1e-3
PARALLEL_OVER = 1.0
PARALLEL_FIT = 0.9
PARALLEL_BIG_STEPS = 2
PARALLEL_PARAM_TOL = 1e-5
PARALLEL_KNN_CASES = ((16, 4), (256, 20))
PARALLEL_SHARDS = (2, 4)
PARALLEL_DDIM_STEPS = 10
RARM_BATCHES = (16, 32)           # B = 16, and 32 under CFG
RARM_POSITIONS = (0, 63, 200, 255)
RARM_SWEEP_SEEDS = 24             # more inputs for decode_attn's attention
RARM_FORWARD_STEPS = 32
# CUDA bf16 decode path vs CPU f32 teacher-forced forward, relative L2 of
# the logits: bf16 activations through 18 residual layers, as the U-Net's.
RARM_FORWARD_TOL = 3e-2
# int8 U-Net forward on the same int8 weights and scales, CUDA bf16 vs the
# CPU plain versions in bf16 and in f32, relative L2. Any rounding
# difference before a static-scale quantizer moves the codes near a
# rounding edge one step, and ~90 quantized layers compound those steps
# to the size of the int8 error itself: on an NVIDIA H100 80GB HBM3 at
# 700 W the two PLAIN forwards (CPU bf16, CPU f32) differ by 5.6e-2 and
# the int8 forward is 5.1e-2 from the bf16 one at these random weights,
# so the limit is 8e-2, not phase 4's 3e-2. The kernels themselves are
# held per call in phase 9.
INT8_FORWARD_TOL = 8e-2
# The int8 cache commit against the plain one: both quantize an f32
# projection summed in another order, so a code on a rounding edge may
# land one step apart (as the int8 block kernels' checks allow), and a
# scale, its row's absmax / 127, carries the absmax's last-bit
# differences.
CODE_SHARE = 1e-3
SCALE_RTOL = 1e-5
# 32 teacher-forced steps, int8_weights + int8_kv against int8_weights
# alone, relative L2 of the logits: the int8 cache's own error (a code is
# within half a step, 1/254 of its row's absmax) through 18 residual
# layers; bf16 activations add phase 7's ~2e-2.
RARM_KV8_TOL = 5e-2
SERVE_STEPS = 50
# Phase 21: the micro quality gates (rdm_tpu_torch/eval/micro_gate.py)
# with the JAX gate's ratios, run with the kernels' head split at the
# gates' C = 64 (the RDM 2 heads of 32, the RARM 1 head of 64); their
# sampling batch (64, guidance 1.0), the RDM's ds-2 blocks over 4 x 4
# tokens with T = 3 neighbours of the 48-wide pixel embedding, the RARM's
# 64-token code grid, the 256-image pool. The RDM at its fast tier (900
# steps, ratio 0.8) at seed 0, as the JAX gate runs it (0.575-0.602 over
# five runs on the card). The RARM's one-seed verdict depends on the seed
# for the JAX package too: on the CPU its own gate fails the fast tier's
# 0.93 at seeds 2 and 5 of 0-5 and the full tier's 0.7 at seed 2 of 0-4.
# From one start (JAX's trained first stage and RARM init, JAX's split)
# the port's trainer and sampler give JAX's reading (fast 0.8858 against
# 0.8843, full 0.5329 against 0.5966; tests/_rarm_gate_witness.py). The
# card's 1 x 64 split fits the code grid more slowly than JAX's 4 x 16
# (training loss 3.8 against 0.36 at step 2700 on the CPU, in JAX's gate
# and the port's alike; recall 0.004 against 0.1 at 3000) and training
# on the card is not bit-reproducible, so its seed 0 has read 0.97-1.05
# at the fast tier and 0.54-0.82 at the full tier. So the RARM gates on
# the full tier at seeds 0-4: the median fid_ratio under 0.7 and every
# seed's precision above its random init's (medians 0.546-0.557 in
# three sweeps on an NVIDIA H100 80GB HBM3 at 700 W). The JAX gate's own
# run, the fast tier at seed 0, is run beside it and its verdict
# printed; it gates nothing. PERF.md section 5 has every seed's reading.
QUALITY_SEED = 0
QUALITY_C = 64
QUALITY_IMAGES = 64
QUALITY_TOKENS = 16
QUALITY_T = 3
QUALITY_DC = 48
QUALITY_POOL = 256
QUALITY_SEQ = 64
QUALITY_POSITIONS = (0, 31, 63)
# (model, fast tier, seeds, gating): one gate process a seed, all side by
# side; a gate that does not gate is run and its verdict printed
QUALITY_GATES = (("rdm", True, (0,), True),
                 ("rarm", False, (0, 1, 2, 3, 4), True),
                 ("rarm", True, (0,), False))
# the fidelity pass at the main op point (batch 4, DDIM-50, guidance 2.0,
# k = 4, shared CFG): every mode of COVERAGE.md's fidelity table
FIDELITY_MODES = ("reuse2", "reuse3", "reuse5", "int8", "int8+reuse2",
                  "int8+reuse3")
FIDELITY_BATCH = 4
# The card's published dense peaks and memory rate (H100 SXM data sheet),
# for each kernel's bound: the larger of its operations over the peak of
# their type and its bytes (inputs read once, outputs written once) over
# the memory rate.
PEAK_BF16, PEAK_INT8, HBM_BYTES_S = 989e12, 1979e12, 3.35e12
# The SFU's rate, which bounds attention at small head_dim: 16 ex2 results
# per SM per clock, on the H100 SXM's 132 SMs.
SMS, EX2_PER_SM_CLOCK = 132, 16
HOST_CALLS = 200  # back-to-back calls that time one call's host cost
LOG2E = 1.4426950408889634


def bound(ops16: float = 0.0, ops8: float = 0.0, nbytes: float = 0.0):
    """(least ms, 'operations' or 'bytes') for this work on the card."""
    t_ops = (ops16 / PEAK_BF16 + ops8 / PEAK_INT8) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def block_cost(name: str, c: int, s: int, t: int = CONTEXT,
               b: int = CFG_BATCH):
    """(bf16 operations, int8 operations, bytes) of one call of a block
    kernel at C = c, S = s, b images, t context tokens. int8 weights are
    one byte each plus an f32 scale per output column."""
    r, f = b * s, 4 * c
    q8 = name.endswith("_q") or name.endswith("_q8")
    wb = 1 if q8 else 2
    if name.startswith("ln_qkv"):
        mm = 2 * r * c * 3 * c
        nbytes = r * c * 2 + 3 * c * c * wb + 2 * c * 4 + 3 * r * c * 2
        return (0, mm, nbytes + 3 * c * 4) if q8 else (mm, 0, nbytes)
    if name.startswith("packed_attn"):
        mm, nbytes = 4 * b * s * s * c, 4 * r * c * 2
        return (0, mm, nbytes) if q8 else (mm, 0, nbytes)
    if name.startswith("post_cross"):
        mm, cross = 3 * 2 * r * c * c, 4 * r * t * c
        nbytes = (3 * r * c * 2 + 2 * b * t * c * 2 + 3 * c * c * wb
                  + 4 * c * 4)
        return (cross, mm, nbytes + 3 * c * 4) if q8 else \
            (mm + cross, 0, nbytes)
    if name == "post_ff":  # post_cross + geglu_ff, f kept on chip
        ops = (block_cost("post_cross", c, s, t, b)[0]
               + block_cost("geglu_ff", c, s, t, b)[0])
        nbytes = (3 * r * c * 2 + 2 * b * t * c * 2
                  + (3 * c * c + 3 * c * f) * 2 + (7 * c + 2 * f) * 4)
        return ops, 0, nbytes
    mm = 6 * r * c * f  # geglu_ff
    nbytes = 2 * r * c * 2 + 3 * c * f * wb + (2 * f + 3 * c) * 4
    return (0, mm, nbytes + (2 * f + c) * 4) if q8 else (mm, 0, nbytes)


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(mhz) * 1e6


def exp2_floor_ms(n_exp: float) -> float:
    """Least time of n_exp ex2 on the SFU at the maximum SM clock."""
    return n_exp / (SMS * EX2_PER_SM_CLOCK * sm_clock_hz()) * 1e3


def _capture(fn, calls: int) -> torch.cuda.CUDAGraph:
    """A CUDA graph of `calls` fn() calls, after a warm-up on a side
    stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def graph_ms(fn, calls: int = 20) -> float:
    """Device time of one fn() call: `calls` calls captured in a CUDA graph
    and replayed (median over TIMING_RUNS replays), so no host work sits
    between them, as it does in median_ms for a short kernel."""
    graph = _capture(fn, calls)
    ms = median_ms(graph.replay) / calls
    del graph
    return ms


def graph_launch_ms(fn, n_launches: int, match: str, calls: int = 20):
    """Device ms of each of the n_launches kernels (names containing
    `match`) of one fn() call, in launch order: torch.profiler's kernel
    records over three replays of a CUDA graph of `calls` calls, averaged
    by position in the call. None where the profiler saw another count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph = _capture(fn, calls)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    del graph
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and match in e.name),
                 key=lambda e: e.time_range.start)
    if len(evs) != 3 * calls * n_launches:
        return None
    us = [e.time_range.elapsed_us() for e in evs]
    return [float(np.mean(us[i::n_launches])) / 1e3
            for i in range(n_launches)]


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds of one fn() call: `calls` calls back to back with
    no synchronisation (the launch queue takes them all), wall time over
    the count."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def kernel_device_ms(fn, calls: int = 10) -> dict:
    """Device ms of one fn() call by kernel name (torch.profiler over
    `calls` calls), for a wrapper of several launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", None)
              or getattr(ev, "cuda_time_total", 0))
        if us > 0:
            name = ev.key.split("(")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + us / calls / 1e3
    return out


def wrapper_device(fn) -> dict:
    """A wrapper call's device time (graph_ms: every launch of the call,
    in a CUDA graph) and, by kernel name, what torch.profiler saw of each
    launch (kernel_device_ms), for phases 3, 6, 9, 12 and 14. The graph
    is the number to use: in a long run the profiler has missed launches
    (a whole post_ff call read as 0)."""
    return {"kernel_device_ms": graph_ms(fn),
            "launch_device_ms": kernel_device_ms(fn, calls=5)}


def _sdpa_ms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> float:
    """Median time of one scaled_dot_product_attention call on BHSD
    copies: the library yardstick, never used by the port."""
    import torch.nn.functional as F

    q, k, v = (a.contiguous() for a in (q, k, v))
    return median_ms(lambda: F.scaled_dot_product_attention(q, k, v))


def _sum_bound(res: dict, costs) -> None:
    """Adds bound_ms (sum over sites or cases) and bound_by (that of the
    largest one) to a kernel's results."""
    bounds = [bound(*cost) for cost in costs]
    res["bound_ms"] = sum(b for b, _ in bounds)
    res["bound_by"] = max(bounds)[1]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median CUDA-event time of fn() over `runs` calls, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def seeded_state_dict(module: torch.nn.Module, seed: int) -> dict:
    """Every leaf from a seed, so no zero-init layer hides a block:
    >=2-D weights fan-in scaled normal, 1-D `weight`s (norm scales) near
    1, other 1-D leaves small normal."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in module.state_dict().items():
        shape = tuple(p.shape)
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            v = torch.randn(shape, generator=g) / math.sqrt(fan_in)
        elif name.endswith(".weight"):
            v = 1.0 + 0.1 * torch.randn(shape, generator=g)
        else:
            v = 0.1 * torch.randn(shape, generator=g)
        sd[name] = v
    return sd


# ------------------------------------------------------------------ phases

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    say("device", f"max SM clock {sm_clock_hz() / 1e6:.0f} MHz "
        "(nvidia-smi clocks.max.sm; the exp2 floors use it)")
    say("device", f"{torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    return smi


def phase_build() -> None:
    from rdm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.load()._name
    nvcc = ("found built" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.2f} s")
    say("build", f"{path} ready in {time.perf_counter() - t0:.2f} s "
        f"({nvcc})")


def _site_tensors(c: int, s: int, heads: int, g: torch.Generator,
                  images: int = CFG_BATCH):
    dev, bf = "cuda", torch.bfloat16
    f = 4 * c

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    def w(k, n):
        return rn(k, n, scale=k ** -0.5)

    def norm():
        return (1.0 + 0.1 * torch.randn(c, generator=g, device=dev),
                0.1 * torch.randn(c, generator=g, device=dev))

    n1s, n1b = norm()
    n2s, n2b = norm()
    n3s, n3b = norm()
    return dict(
        x=rn(images, s, c), ck=rn(images, CONTEXT, c),
        cv=rn(images, CONTEXT, c),
        n1s=n1s, n1b=n1b, wqkv=w(c, 3 * c), wo=w(c, c),
        bo=rn(c, scale=0.1, dtype=torch.float32), n2s=n2s, n2b=n2b,
        wq2=w(c, c), wo2=w(c, c),
        bo2=rn(c, scale=0.1, dtype=torch.float32), n3s=n3s, n3b=n3b,
        wa=w(c, f), wg=w(c, f), ba=rn(f, scale=0.1, dtype=torch.float32),
        bg=rn(f, scale=0.1, dtype=torch.float32), w2=w(f, c),
        b2=rn(c, scale=0.1, dtype=torch.float32))


def _flat(out) -> torch.Tensor:
    """A kernel's output (a tensor or a tuple of them) as one f32 vector."""
    outs = out if isinstance(out, tuple) else (out,)
    return torch.cat([o.reshape(-1).float() for o in outs])


def _attn_core_site(q, k, v, heads: int, hd: int) -> dict:
    """Phase 3's extra numbers of the attention core at one site: device
    time beside SDPA's, the exp2 floor, the host cost of one call, and
    packed_attn equal bit for bit to flash_fwd on the same memory."""
    import torch.nn.functional as F

    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.ops import flash_attention as fa

    b, s, c = q.shape
    shp = (b, s, heads, hd)
    packed = bk.packed_attn(q, k, v, heads=heads, head_dim=hd)
    flash = fa.flash_fwd(q.view(shp), k.view(shp), v.view(shp),
                         scale=hd ** -0.5, causal=False)
    if not torch.equal(packed, flash.view(b, s, c)):
        raise RuntimeError(f"packed_attn and flash_fwd differ at C={c}, "
                           f"S={s}: they run one core")
    bhsd = [a.view(shp).transpose(1, 2).contiguous() for a in (q, k, v)]
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(q)
    out = {
        "device_ms": graph_ms(
            lambda: bk.packed_attn(q, k, v, heads=heads, head_dim=hd)),
        "library_device_ms": graph_ms(
            lambda: F.scaled_dot_product_attention(*bhsd)),
        "exp2_floor_ms": exp2_floor_ms(b * heads * s * s),
        "equal_flash_fwd": True,
        "host_us": host_us(
            lambda: bk.packed_attn(q, k, v, heads=heads, head_dim=hd)),
        "launcher_host_us": host_us(lambda: lib.rdm_packed_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
            heads, hd, hd ** -0.5 * 1.4426950408889634, stream)),
    }
    say("kernels", f"attention core C={c:4d} S={s:4d}: device "
        f"{out['device_ms']:.4f} ms (SDPA {out['library_device_ms']:.4f}), "
        f"exp2 floor {out['exp2_floor_ms']:.4f} ms, equal to flash_fwd; "
        f"host per call {out['host_us']:.1f} us (bare launcher "
        f"{out['launcher_host_us']:.1f})")
    return out


def _gemm_calls(t: dict, attn: torch.Tensor, heads: int):
    """ln_qkv, post_cross and geglu_ff on one site's tensors: {name:
    (kernel call, plain call, bare launcher call, the same products through
    torch.matmul)}. The bare launchers take the wrappers' plans and
    outputs, computed once and kept alive by their lambdas."""
    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.ops import block_kernel as bk

    b, s, c = t["x"].shape
    r, hd, f = b * s, c // heads, 4 * c
    pc = (t["x"], attn, t["ck"], t["cv"], t["wo"], t["bo"], t["n2s"],
          t["n2b"], t["wq2"], t["wo2"], t["bo2"])
    xm2 = bk.post_cross_reference(*pc, heads=heads,
                                  head_dim=hd).reshape(r, c)
    ff = (xm2, t["n3s"], t["n3b"], t["wa"], t["wg"], t["ba"], t["bg"],
          t["w2"], t["b2"])
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    x1, o, out, y, q, k, v = (torch.empty_like(xm2) for _ in range(7))
    hidden = torch.empty((r, f), dtype=xm2.dtype, device=xm2.device)
    ptr = lambda *ts: [a.data_ptr() for a in ts]  # noqa: E731
    sms = bk.sm_count(xm2.device.index)
    pc_bare = ptr(*pc, x1, o, out) + [r, s, c, CONTEXT, hd, hd ** -0.5] + [
        *bk.gemm_plan("residual", r, c, c, sms).args,
        *bk.gemm_plan("cross", r, c, c, sms).args, stream]
    ff_bare = ptr(*ff, hidden, y) + [r, c, f] + [
        *bk.gemm_plan("geglu", r, f, c, sms).args,
        *bk.gemm_plan("residual", r, c, f, sms).args, stream]
    a2, x2 = attn.reshape(r, c), t["x"].reshape(r, c)
    qkv = (x2, t["n1s"], t["n1b"], t["wqkv"])
    qkv_bare = ptr(*qkv, q, k, v) + [r, c] + [
        *bk.gemm_plan("qkv", r, 3 * c, c, sms).args, stream]
    return {
        "ln_qkv": (
            lambda: bk.ln_qkv(*qkv), lambda: bk.ln_qkv_reference(*qkv),
            lambda keep=(q, k, v): lib.rdm_ln_qkv(*qkv_bare),
            lambda: x2 @ t["wqkv"]),
        "post_cross": (
            lambda: bk.post_cross(*pc, heads=heads, head_dim=hd),
            lambda: bk.post_cross_reference(*pc, heads=heads, head_dim=hd),
            lambda keep=(x1, o, out): lib.rdm_post_cross(*pc_bare),
            lambda: (a2 @ t["wo"], x2 @ t["wq2"], x2 @ t["wo2"])),
        "geglu_ff": (
            lambda: bk.geglu_ff(*ff), lambda: bk.geglu_ff_reference(*ff),
            lambda keep=(hidden, y): lib.rdm_geglu_ff_sm90(*ff_bare),
            lambda: (xm2 @ t["wa"], xm2 @ t["wg"], hidden @ t["w2"])),
    }


def _gemm_site(name: str, calls: tuple) -> dict:
    """Phase 3's extra numbers of a block-GEMM kernel at one site: each
    launch's device time in a CUDA graph, the host us of a wrapper call
    and of its bare launcher, and, as context only (no kernel of the port
    calls it, and it is not the Library column), the device time of the
    same products through torch.matmul, none of their epilogues."""
    kern, _, bare, mm = calls
    parts = graph_launch_ms(kern, len(GEMM_LAUNCHES[name]),
                            "block_gemm_kernel")
    out = {"launch_device_ms": None if parts is None else
           dict(zip(GEMM_LAUNCHES[name], parts)),
           "host_us": host_us(kern), "launcher_host_us": host_us(bare),
           "matmul_context_device_ms": graph_ms(mm)}
    launches = ("not seen by the profiler" if parts is None else ", ".join(
        f"{k} {v:.4f}" for k, v in out["launch_device_ms"].items()))
    say("kernels", f"  {name} launches (device ms, CUDA graph): {launches}; "
        f"host per call {out['host_us']:.1f} us (bare launcher "
        f"{out['launcher_host_us']:.1f}); context only, the same products "
        f"through torch.matmul: {out['matmul_context_device_ms']:.4f} ms")
    return out


def _gemm_op_point(g: torch.Generator) -> dict:
    """ln_qkv, post_cross and geglu_ff at OP_POINT_IMAGES images of each
    site against their plain versions (KERNEL_TOL), with their device
    times."""
    out = {name: [] for name in GEMM_LAUNCHES}
    for c, s, heads in SITES:
        t = _site_tensors(c, s, heads, g, images=OP_POINT_IMAGES)
        attn = 0.5 * torch.randn(t["x"].shape, generator=g, device="cuda",
                                 dtype=torch.bfloat16)
        for name, calls in _gemm_calls(t, attn, heads).items():
            kern, plain = calls[:2]
            got = _flat(kern())
            torch.cuda.synchronize()
            want = _flat(plain())
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            if not (torch.isfinite(got).all() and rel <= KERNEL_TOL):
                raise RuntimeError(f"{name} at {OP_POINT_IMAGES} images, "
                                   f"C={c}: relative error {rel}")
            bound_ms, by = bound(*block_cost(name, c, s,
                                             b=OP_POINT_IMAGES))
            site = {"C": c, "S": s, "R": OP_POINT_IMAGES * s,
                    "max_abs_err": err, "rel_err": rel,
                    "kernel_device_ms": graph_ms(kern),
                    "bound_ms": bound_ms, "bound_by": by}
            say("kernels", f"{name:11s} C={c:4d} R={site['R']:5d} "
                f"({OP_POINT_IMAGES} images): /max|ref| {rel:.3e} (limit "
                f"{KERNEL_TOL:g}); device {site['kernel_device_ms']:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({by})")
            site.update(_gemm_site(name, calls))
            out[name].append(site)
        del t, attn
    torch.cuda.empty_cache()
    return out


def phase_kernels() -> dict:
    """Per kernel: {'max_abs_err', 'ms', 'plain_ms', 'sites': [...]}."""
    from rdm_tpu_torch.ops import block_kernel as bk

    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": 0.0 if name == "packed_attn" else None,
                      "sites": []} for name in KERNEL_INFO}
    for c, s, heads in SITES:
        t = _site_tensors(c, s, heads, g)
        r, hd = CFG_BATCH * s, c // heads
        x2 = t["x"].reshape(r, c)
        q, k, v = bk.ln_qkv_reference(x2, t["n1s"], t["n1b"], t["wqkv"])
        q, k, v = (a.contiguous().reshape(CFG_BATCH, s, c) for a in (q, k, v))
        attn = bk.packed_attn_reference(q, k, v, heads=heads, head_dim=hd)
        xm = bk.post_cross_reference(
            t["x"], attn, t["ck"], t["cv"], t["wo"], t["bo"], t["n2s"],
            t["n2b"], t["wq2"], t["wo2"], t["bo2"], heads=heads, head_dim=hd)
        xm2 = xm.reshape(r, c)
        pc_args = (t["x"], attn, t["ck"], t["cv"], t["wo"], t["bo"],
                   t["n2s"], t["n2b"], t["wq2"], t["wo2"], t["bo2"])
        ff_args = (xm2, t["n3s"], t["n3b"], t["wa"], t["wg"], t["ba"],
                   t["bg"], t["w2"], t["b2"])
        gemm = _gemm_calls(t, attn, heads)
        calls = {
            "ln_qkv": gemm["ln_qkv"][:2],
            "packed_attn": (
                lambda: bk.packed_attn(q, k, v, heads=heads, head_dim=hd),
                lambda: bk.packed_attn_reference(q, k, v, heads=heads,
                                                 head_dim=hd)),
            "post_cross": (
                lambda: bk.post_cross(*pc_args, heads=heads, head_dim=hd),
                lambda: bk.post_cross_reference(*pc_args, heads=heads,
                                                head_dim=hd)),
            "geglu_ff": (lambda: bk.geglu_ff(*ff_args),
                         lambda: bk.geglu_ff_reference(*ff_args)),
        }
        for name, (kern, plain) in calls.items():
            got = _flat(kern())
            torch.cuda.synchronize()
            want = _flat(plain())
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} at C={c}: non-finite output")
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            ms, plain_ms = median_ms(kern), median_ms(plain)
            dev = wrapper_device(kern)
            say("kernels", f"{name:11s} C={c:4d} S={s:4d} heads={heads:2d}: "
                f"max|err| {err:.4g}, /max|ref| {rel:.3e} (limit "
                f"{KERNEL_TOL:g}); kernel {ms:.4f} ms (device "
                f"{dev['kernel_device_ms']:.4f}), plain {plain_ms:.4f} ms")
            if not rel <= KERNEL_TOL:
                raise RuntimeError(f"{name} at C={c}: relative error {rel} "
                                   f"> {KERNEL_TOL}")
            res = results[name]
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            bound_ms, by = bound(*block_cost(name, c, s))
            site = {"C": c, "S": s, "heads": heads, "max_abs_err": err,
                    "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, **dev}
            if name in GEMM_LAUNCHES:
                site.update(_gemm_site(name, gemm[name]))
            if name == "packed_attn":
                shp = (CFG_BATCH, s, heads, hd)
                site["library_ms"] = _sdpa_ms(
                    *(a.reshape(shp).transpose(1, 2) for a in (q, k, v)))
                res["library_ms"] += site["library_ms"]
                site.update(_attn_core_site(q, k, v, heads, hd))
            res["sites"].append(site)
    for name, res in results.items():
        _sum_bound(res, [block_cost(name, c, s) for c, s, _ in SITES])
        res["kernel_device_ms"] = sum(x["kernel_device_ms"]
                                      for x in res["sites"])
    for name, sites in _gemm_op_point(g).items():
        results[name]["op_point_sites"] = sites
    _long_context_on_card()
    return results


def _long_context_on_card() -> None:
    """A SpatialTransformer at phase 3's first site (C = 384, S = 1024,
    8 images) with a LONG_CONTEXT-token context, in eval mode on the card:
    its block must run the four block kernels, once each, and its output
    must agree with the same module's unfused blocks in f32 on the CPU
    (relative L2 within FORWARD_TOL, as phase 4 holds the forward)."""
    import copy

    from rdm_tpu_torch.models.layers import SpatialTransformer
    from rdm_tpu_torch.ops import block_kernel as bk

    c, s, heads = SITES[0]
    side = int(math.isqrt(s))
    ref = SpatialTransformer(c, 512, heads, c // heads)
    ref.load_state_dict(seeded_state_dict(ref, SEED + 30))
    g = torch.Generator().manual_seed(SEED + 31)
    x = torch.randn((CFG_BATCH, c, side, side), generator=g)
    ctx = torch.randn((CFG_BATCH, LONG_CONTEXT, 512), generator=g)
    with torch.inference_mode():
        want = ref.train()(x, ctx)  # the unfused blocks, f32, CPU
    st = copy.deepcopy(ref).to("cuda", torch.bfloat16).eval()
    bk.reset_launch_counts()
    with torch.inference_mode():
        got = st(x.to("cuda", torch.bfloat16),
                 ctx.to("cuda", torch.bfloat16)).float().cpu()
    counts = bk.launch_counts()
    rel = ((got - want).norm() / want.norm()).item()
    say("kernels", f"SpatialTransformer C={c} S={s} T={LONG_CONTEXT}: "
        f"block kernel launches {counts}; rel L2 err CUDA bf16 vs CPU f32 "
        f"unfused {rel:.3e} (limit {FORWARD_TOL:g})")
    if (any(n != (1 if k in KERNEL_INFO else 0) for k, n in counts.items())
            or not torch.isfinite(got).all() or not rel <= FORWARD_TOL):
        raise RuntimeError(f"T={LONG_CONTEXT}: launches {counts}, relative "
                           f"error {rel}")


def phase_forward(rdm_sd: dict) -> None:
    from rdm_tpu_torch.config import UNetConfig
    from rdm_tpu_torch.models.unet import UNet
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.pipeline import cast_params_for_inference

    cfg = UNetConfig.imagenet_rdm()
    pre = "model.diffusion_model."
    sd = {k[len(pre):]: v for k, v in rdm_sd.items() if k.startswith(pre)}
    g = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn(1, 3, 64, 64, generator=g)
    t = torch.tensor([501])
    ctx = torch.randn(2, CONTEXT, 512, generator=g)

    with torch.device("meta"):  # bound to the seeded weights below
        cpu, gpu = UNet(cfg), UNet(cfg, dtype=torch.bfloat16)
    cpu.load_state_dict(sd, assign=True)
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu(x, t, ctx)
    cpu_s = time.perf_counter() - t0
    del cpu

    gpu.load_state_dict(sd, assign=True)
    gpu = cast_params_for_inference(gpu.cuda().eval(), torch.bfloat16)
    bk.reset_launch_counts()
    with torch.inference_mode():
        got = gpu(x.cuda(), t.cuda(), ctx.cuda()).cpu()
    counts = bk.launch_counts()
    if tuple(got.shape) != (2, 3, 64, 64) or not torch.isfinite(got).all():
        raise RuntimeError(f"forward output {tuple(got.shape)} not finite")
    rel = ((got - want).norm() / want.norm()).item()
    say("forward", f"ImageNet U-Net, x [1,3,64,64] + context [2,4,512]: "
        f"rel L2 err CUDA bf16 vs CPU f32 {rel:.3e} (limit {FORWARD_TOL:g});"
        f" CPU f32 {cpu_s:.1f} s; launches {counts}")
    if not rel <= FORWARD_TOL:
        raise RuntimeError(f"forward relative error {rel} > {FORWARD_TOL}")
    if any(n != (16 if k in KERNEL_INFO else 0) for k, n in counts.items()):
        raise RuntimeError(f"expected 16 launches per bf16 kernel, got "
                           f"{counts}")
    del gpu
    torch.cuda.empty_cache()


def make_table(n_db: int = 1_281_280) -> torch.Tensor:
    """The retrieval table, made on the card: n_db unit rows x 512."""
    from rdm_tpu_torch.retrieval.engine import l2_normalize

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    return l2_normalize(torch.randn(n_db, 512, generator=g, device="cuda"))


def phase_serve(rdm_sd: dict, vq_sd: dict, emb: torch.Tensor) -> dict:
    """Two requests through the pipeline; returns the launch counts."""
    from rdm_tpu_torch.config import AutoencoderConfig, RDMConfig
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.pipeline import RDMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool
    from rdm_tpu_torch.retrieval.engine import knn_search, l2_normalize

    n_db, batch, steps = emb.shape[0], 4, 50
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    queries = torch.randn(batch, 512, generator=g, device="cuda")
    qids = torch.randint(0, n_db, (batch,), generator=g,
                         device="cuda").cpu().numpy()
    t0 = time.perf_counter()
    pipe = RDMPipeline(RDMConfig.imagenet(), rdm_sd,
                       AutoencoderConfig.vq_f4(), vq_sd,
                       pool=DataPool(embeddings=emb), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # exact-kNN check on the full table: ids against an f32 brute force
    _, ids = knn_search(pipe.retrieval.db_norm, l2_normalize(queries), 4)
    brute = l2_normalize(queries).to(torch.bfloat16).float() @ \
        pipe.retrieval.db_norm.float().t()
    if not torch.equal(ids, brute.topk(4, dim=1).indices):
        raise RuntimeError("kNN ids disagree with the brute-force top-k")

    # warm-up at the request shapes (cuDNN picks its algorithms here)
    pipe.sample_with_query(queries, steps=2, seed=99)
    bk.reset_launch_counts()
    for i, kind in enumerate(("sample_with_query", "sample_unconditional")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "sample_with_query":
            out = pipe.sample_with_query(queries, k_nn=4, steps=steps,
                                         guidance_scale=2.0, seed=1)
            images = out["query_samples"]
        else:
            out = pipe.sample_unconditional(batch, k_nn=4, steps=steps,
                                            guidance_scale=2.0, qids=qids,
                                            seed=2)
            images = out["samples_with_sampled_nns"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = bk.launch_counts()
        want = 16 * steps * (i + 1)
        if any(n != (want if k in KERNEL_INFO else 0)
               for k, n in counts.items()):
            raise RuntimeError(f"{kind}: expected {want} launches per "
                               f"kernel so far, got {counts}")
        if images.shape != (batch, 256, 256, 3) or images.dtype != np.uint8:
            raise RuntimeError(f"{kind}: images {images.shape} "
                               f"{images.dtype}")
        if images.std() == 0:
            raise RuntimeError(f"{kind}: constant images")
        say("serve", f"{kind}: batch {batch}, DDIM-{steps}, guidance 2.0, "
            f"k=4 over {n_db}x512: {wall:.3f} s, {batch / wall:.3f} img/s; "
            f"launches so far {counts}")
    say("serve", f"pipeline set-up {setup_s:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return bk.launch_counts()


def _decode_tensors(b: int, g: torch.Generator) -> dict:
    """Full-width RARM layer inputs and kernel-layout weights, bf16 (f32
    norms and biases): C = 768, 12 heads, T = 256, F = 3072, k = 4."""
    from rdm_tpu_torch.config import RARMConfig

    cfg = RARMConfig.imagenet_dogs()
    c, t, f, s = cfg.inner_dim, cfg.seq_len, 4 * cfg.inner_dim, CONTEXT
    dev, bf = "cuda", torch.bfloat16

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    def w(k, n):
        return rn(k, n, scale=k ** -0.5)

    def vec(n, mean=0.0):
        return mean + 0.1 * torch.randn(n, generator=g, device=dev)

    return dict(
        x=rn(b, c), kc=rn(t, b, c), vc=rn(t, b, c), ck=rn(s, b, c),
        cv=rn(s, b, c), n1s=vec(c, 1.0), n1b=vec(c), wqkv=w(c, 3 * c),
        wo=w(c, c), bo=vec(c), n2s=vec(c, 1.0), n2b=vec(c), wq2=w(c, c),
        wo2=w(c, c), bo2=vec(c), n3s=vec(c, 1.0), n3b=vec(c), wa=w(c, f),
        wg=w(c, f), ba=vec(f), bg=vec(f), w2=w(f, c), b2=vec(c),
        rows=[rn(1, b, c) for _ in range(2 * cfg.depth)],
        caches=[rn(t, b, c) for _ in range(2 * cfg.depth)])


def _hold(what: str, outs, exact: bool = False) -> list:
    """Holds each (label, kernel output, plain output) against the plain
    output's own max|ref| (KERNEL_TOL), or bit for bit with `exact`;
    returns [(label, max|err|, max|err| / max|ref|)]."""
    errs = []
    for label, got, want in outs:
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{what}: non-finite {label}")
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if exact and not torch.equal(got, want):
            raise RuntimeError(f"{what}: {label} differs from the plain "
                               f"version (max|err| {err})")
        if not rel <= KERNEL_TOL:
            raise RuntimeError(f"{what}: {label} relative error {rel} > "
                               f"{KERNEL_TOL}")
        errs.append((label, err, rel))
    return errs


def decode_cost(name: str, b: int, pos: int, c: int = 768, t: int = CONTEXT,
                layers: int = 18):
    """(bf16 operations, 0, bytes) of one decode-kernel call at batch b and
    position pos (the RARM width: C = 768, F = 4C, k = t context rows):
    decode_attn reads the pos cache rows before pos and writes the current
    row of both caches; commit_rows copies 2L rows. The int8 variants
    (`_w8`: int8 weights, one byte each plus a bf16 scale per output
    column; `_kv8`: int8 cache rows plus an f32 scale per row and batch
    row) run their products on the bf16 tensor cores."""
    f = 4 * c
    wb = 1 if "_w8" in name else 2
    if name.startswith("decode_attn"):
        kv8 = name.endswith("_kv8")
        row = b * c * (1 if kv8 else 2) + (b * 4 if kv8 else 0)
        ops = 2 * b * c * 3 * c + 4 * b * (pos + 1) * c
        nbytes = (b * c * 2 + 2 * c * 4 + 3 * c * c * wb + 2 * pos * row
                  + 3 * b * c * 2 + 2 * row)
        return ops, 0, nbytes + (3 * c * 2 if wb == 1 else 0)
    if name.startswith("decode_post_ff"):
        ops = 2 * b * (3 * c * c + 3 * c * f) + 4 * b * t * c
        nbytes = (2 * b * c * 2 + 2 * t * b * c * 2 + (3 * c * c + 3 * c * f)
                  * wb + (7 * c + 2 * f) * 4 + b * c * 2)
        return ops, 0, nbytes + ((4 * c + 2 * f) * 2 if wb == 1 else 0)
    return 0, 0, 2 * 2 * layers * b * c * 2  # commit_rows


def _decode_attn_apart(x, pos: int, kc, vc, n1s, n1b, wqkv, *, heads: int,
                       hd: int, wqkv_s=None, ks=None, vs=None) -> dict:
    """decode_attn's two launches apart, each in a CUDA graph as a plain
    stream launch (programmatic dependent launch off, so a launch's own
    time and not its overlap with the next): LN1, the q/k/v projection
    and the row commit (the block-GEMM core's kQkv launch,
    `rdm_decode_proj`), then the split-KV attention over rows < pos and
    the current position (`rdm_decode_attn`, which also commits an int8
    row); beside SDPA's device time over the same q and cache rows <= pos
    (BHSD copies made outside the timed call; an int8 cache's rows
    dequantized to bf16 first), and the two plans."""
    import torch.nn.functional as F

    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.ops import decode_kernel as dk

    lib = _build.load()
    (b, c), t, kv8 = x.shape, kc.shape[0], ks is not None
    sms = bk.sm_count(x.device.index)
    proj = bk.gemm_plan("qkv", b, 3 * c, c, sms, split_k=True,
                        w8=wqkv_s is not None)
    ap = dk.attn_plan(b, heads, pos, sms)
    q, out = torch.empty_like(x), torch.empty_like(x)
    kn, vn = ((torch.empty_like(x), torch.empty_like(x)) if kv8
              else (kc[pos], vc[pos]))
    f32 = [torch.empty((b, c), device=x.device) for _ in range(2)] \
        if kv8 else [None, None]

    def p(a):
        return None if a is None else a.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def projection():
        _build.check(lib.rdm_decode_proj(
            p(x), p(n1s), p(n1b), p(wqkv), p(wqkv_s), p(q), p(kn), p(vn),
            p(f32[0]), p(f32[1]), b, c, *proj.args, proj.ks, 0, stream()),
            "decode_attn projection")

    def attention():
        _build.check(lib.rdm_decode_attn(
            p(q), p(kn), p(vn), p(kc), p(vc), p(ks), p(vs), p(f32[0]),
            p(f32[1]), p(out), pos, t, b, c, heads, hd ** -0.5 * LOG2E,
            ap.group, ap.splits, ap.rows, 0, stream()),
            "decode_attn attention")

    projection()
    torch.cuda.synchronize()

    def bhsd(a, n):
        return a.reshape(n, b, heads, hd).permute(1, 2, 0, 3).contiguous()

    keys, vals = kc[:pos], vc[:pos]
    if kv8:
        keys = (keys.float() * ks[:pos]).bfloat16()
        vals = (vals.float() * vs[:pos]).bfloat16()
    lib_in = (bhsd(q, 1), bhsd(torch.cat([keys, kn[None]]), pos + 1),
              bhsd(torch.cat([vals, vn[None]]), pos + 1))
    return {"qkv_device_ms": graph_ms(projection),
            "attn_device_ms": graph_ms(attention),
            "library_device_ms": graph_ms(
                lambda: F.scaled_dot_product_attention(*lib_in)),
            "qkv_plan": {"ks": proj.ks, "stages": proj.stages,
                         "ctas": 3 * c // 64 * proj.ks * -(-b // 64)},
            "attn_plan": ap._asdict()}


def _apart_text(what: str, case: dict) -> str:
    pl = case["attn_plan"]
    return (f"{what:13s}: device {case['qkv_device_ms']:.4f} ms projection "
            f"(kQkv, KS {case['qkv_plan']['ks']}, "
            f"{case['qkv_plan']['ctas']} CTAs) + "
            f"{case['attn_device_ms']:.4f} ms attention ({pl['splits']} "
            f"splits x {pl['rows']} rows, {pl['ctas']} CTAs), PDL off; "
            f"SDPA over rows <= pos {case['library_device_ms']:.4f} ms, the "
            "attention launch's work only")


def _same_bits(what: str, kern, got, no_pdl) -> None:
    """A decode wrapper's checks beyond its error: a second call, the
    replay of a CUDA graph of one call (clusters and programmatic
    dependent launches captured) and `no_pdl`, the same launches with
    programmatic dependent launch off, each give the first call's outputs
    (`got`: a tensor or a tuple) bit for bit: rank-ordered sums, no
    atomics."""
    first = [a.clone() for a in (got if isinstance(got, tuple) else (got,))]

    def same(outs, how):
        torch.cuda.synchronize()
        outs = outs if isinstance(outs, tuple) else (outs,)
        if not all(torch.equal(a, b) for a, b in zip(outs, first)):
            raise RuntimeError(f"{what}: {how} differs from the first call")

    same(kern(), "a second call")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kern()
    graph.replay()
    same(out, "a CUDA graph's replay")
    del graph
    same(no_pdl(), "a call without programmatic dependent launch")


def _mean_apart(res: dict) -> None:
    """A decode_attn row's mean of each launch's and SDPA's device ms over
    its cases."""
    cases = res["cases"]
    for key in ("qkv_device_ms", "attn_device_ms", "library_device_ms"):
        res[key] = sum(c[key] for c in cases) / len(cases)


def _post_ff_chain(what: str, kern, got: torch.Tensor, no_pdl) -> dict:
    """decode_post_ff's checks beyond its error (`_same_bits`), and each of
    its five launches' device ms in a graph (graph_launch_ms, None where
    the profiler saw another count)."""
    _same_bits(what, kern, got, no_pdl)
    parts = graph_launch_ms(kern, len(DECODE_CHAIN), "block_gemm_kernel")
    return {"chain_launch_ms": parts and dict(zip(DECODE_CHAIN, parts))}


def _mean_chain(res: dict) -> None:
    """A decode_post_ff row's mean of each launch's device ms over its
    cases (where the profiler saw every case's launches)."""
    parts = [c["chain_launch_ms"] for c in res["cases"]]
    if all(parts):
        res["chain_launch_ms"] = {k: sum(p[k] for p in parts) / len(parts)
                                  for k in DECODE_CHAIN}


def _chain_text(case: dict) -> str:
    parts = case["chain_launch_ms"]
    return "; two calls, a graph and PDL off bit-equal; launches " + (
        " / ".join(f"{v:.4f}" for v in parts.values()) + " ms"
        if parts else "not seen by the profiler")


def phase_rarm_kernels() -> dict:
    """Per decode kernel: {'max_abs_err', 'ms', 'plain_ms', 'cases'}.

    decode_attn's attention output, k_new and v_new are each held against
    their own scale (the attention output, an average over pos + 1 rows,
    is ~10x smaller than the caches), and its cache commit bit for bit:
    row pos holds k_new / v_new, every other row is untouched. Its
    `max_abs_err` is the attention output's. commit_rows must match its
    plain version exactly."""
    from rdm_tpu_torch.ops import decode_kernel as dk

    heads, hd = 12, 64
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": None, "cases": []}
               for name in DECODE_INFO}
    for b in RARM_BATCHES:
        t = _decode_tensors(b, g)
        caches_k = [a.clone() for a in t["caches"]]
        caches_p = [a.clone() for a in t["caches"]]
        commit = dk.RowCommit(caches_k, t["rows"])
        keep = torch.ones(t["kc"].shape[0], dtype=torch.bool, device="cuda")
        for pos in RARM_POSITIONS:
            what = f"B={b} pos={pos}"
            kc_k, vc_k = t["kc"].clone(), t["vc"].clone()   # kernel's caches
            kc_p, vc_p = t["kc"].clone(), t["vc"].clone()   # plain's caches
            attn_args = (t["n1s"], t["n1b"], t["wqkv"])
            ff = [t["x"], None, t["ck"], t["cv"], t["wo"], t["bo"],
                  t["n2s"], t["n2b"], t["wq2"], t["wo2"], t["bo2"],
                  t["n3s"], t["n3b"], t["wa"], t["wg"], t["ba"], t["bg"],
                  t["w2"], t["b2"]]
            calls = {
                "decode_attn": (
                    lambda: dk.decode_attn(t["x"], pos, kc_k, vc_k,
                                           *attn_args, heads=heads,
                                           head_dim=hd),
                    lambda: dk.decode_attn_reference(
                        t["x"], pos, kc_p, vc_p, *attn_args, heads=heads,
                        head_dim=hd)),
                "decode_post_ff": (
                    lambda: dk.decode_post_ff(*ff, heads=heads, head_dim=hd),
                    lambda: dk.decode_post_ff_reference(*ff, heads=heads,
                                                        head_dim=hd)),
                # the step's call: a RowCommit built once a request
                "commit_rows": (
                    lambda: commit(pos),
                    lambda: dk.commit_rows_reference(pos, caches_p,
                                                     t["rows"])),
            }
            for name, (kern, plain) in calls.items():
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                if name == "decode_attn":
                    errs = _hold(f"decode_attn {what}", zip(
                        ("attn", "k_new", "v_new"), got, want))
                    keep[pos] = False
                    for label, cache, new, old in (
                            ("k", kc_k, got[1], t["kc"]),
                            ("v", vc_k, got[2], t["vc"])):
                        if not (torch.equal(cache[pos], new)
                                and torch.equal(cache[keep], old[keep])):
                            raise RuntimeError(
                                f"decode_attn {what}: the {label} cache is "
                                f"not its old rows with row {pos} = "
                                f"{label}_new")
                    keep[pos] = True
                    ff[1] = want[0]   # decode_post_ff's input
                    _same_bits(f"decode_attn {what}", kern, got,
                               lambda: dk._decode_attn(
                                   t["x"], pos, kc_k, vc_k, *attn_args,
                                   heads=heads, head_dim=hd, pdl=False))
                    detail = "; ".join(f"{lab} {rel:.3e}"
                                       for lab, _, rel in errs[1:])
                    detail += ("; cache rows exact; two calls, a graph and "
                               "PDL off bit-equal")
                elif name == "commit_rows":
                    errs = _hold(f"commit_rows {what}", [
                        (f"cache {i}", k, p)
                        for i, (k, p) in enumerate(zip(got, want))],
                        exact=True)
                    errs = [max(errs, key=lambda e: e[1])]
                    detail = f"all {len(got)} caches exact"
                else:
                    errs = _hold(f"decode_post_ff {what}",
                                 [("x_out", got, want)])
                    chain = _post_ff_chain(
                        f"decode_post_ff {what}", kern, got,
                        lambda: dk._decode_post_ff(*ff, heads=heads,
                                                   head_dim=hd, pdl=False))
                    detail = _chain_text(chain)[2:]
                _, err, rel = errs[0]
                ms, plain_ms = median_ms(kern), median_ms(plain)
                dev = wrapper_device(kern)
                if name == "decode_post_ff":
                    dev.update(chain)
                say("rarm_kernels", f"{name:14s} {what:13s}: max|err| "
                    f"{err:.4g}, /max|ref| {rel:.3e} (limit {KERNEL_TOL:g})"
                    f"{'; ' + detail if detail else ''}; kernel {ms:.4f} "
                    f"ms (device {dev['kernel_device_ms']:.4f}), plain "
                    f"{plain_ms:.4f} ms")
                res = results[name]
                res["max_abs_err"] = max(res["max_abs_err"], err)
                bound_ms, by = bound(*decode_cost(name, b, pos))
                case = {"B": b, "pos": pos, "max_abs_err": err,
                        "rel_err": {lab: r for lab, _, r in errs}, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": by, **dev}
                if name == "decode_attn":  # SDPA over the cache rows <= pos
                    def bhsd(a, n):
                        return a.reshape(n, b, heads, hd).permute(1, 2, 0, 3)
                    case["library_ms"] = _sdpa_ms(
                        bhsd(t["x"], 1), bhsd(t["kc"][:pos + 1], pos + 1),
                        bhsd(t["vc"][:pos + 1], pos + 1))
                    case.update(_decode_attn_apart(
                        t["x"], pos, kc_k, vc_k, *attn_args, heads=heads,
                        hd=hd))
                    say("rarm_kernels", "decode_attn    "
                        + _apart_text(what, case))
                elif name == "commit_rows":  # one PyTorch call, same rows
                    views = [k[pos:pos + 1] for k in caches_k]

                    def library():
                        torch._foreach_copy_(views, t["rows"])

                    def wrapper():
                        dk.commit_rows(pos, caches_k, t["rows"])
                    case["library_ms"] = median_ms(library)
                    case["library_device_ms"] = graph_ms(library)
                    case["host_us"] = host_us(kern)
                    case["wrapper_ms"] = median_ms(wrapper)
                    case["wrapper_host_us"] = host_us(wrapper)
                    say("rarm_kernels", f"commit_rows    {what:13s}: device "
                        f"{dev['kernel_device_ms']:.4f} ms, host "
                        f"{case['host_us']:.1f} us a call (commit_rows' "
                        f"checks and table each call: "
                        f"{case['wrapper_ms']:.4f} ms, host "
                        f"{case['wrapper_host_us']:.1f} us); "
                        f"torch._foreach_copy_ over the {len(views)} row-pos "
                        f"views {case['library_ms']:.4f} ms, device "
                        f"{case['library_device_ms']:.4f} ms")
                res["cases"].append(case)
        del t, caches_k, caches_p, kc_k, vc_k, kc_p, vc_p, commit
        torch.cuda.empty_cache()
    for res in results.values():
        n = len(res["cases"])
        for key in ("ms", "plain_ms", "bound_ms", "kernel_device_ms") + (
                ("library_ms",) if "library_ms" in res["cases"][0] else ()):
            res[key] = sum(c[key] for c in res["cases"]) / n
        res["bound_by"] = max(res["cases"], key=lambda c: c["bound_ms"])[
            "bound_by"]
    _mean_chain(results["decode_post_ff"])
    _mean_apart(results["decode_attn"])
    cases = results["commit_rows"]["cases"]
    for key in ("library_device_ms", "host_us", "wrapper_ms",
                "wrapper_host_us"):
        results["commit_rows"][key] = sum(c[key] for c in cases) / len(cases)

    # The attention output is the output most sensitive to rounding (the
    # softmax amplifies any difference in q), so hold it on more inputs.
    rels = []
    for seed in range(RARM_SWEEP_SEEDS):
        g = torch.Generator(device="cuda").manual_seed(SEED + 100 + seed)
        for b in RARM_BATCHES:
            t = _decode_tensors(b, g)
            for pos in RARM_POSITIONS[1:]:
                got, want = (fn(t["x"], pos, t["kc"].clone(), t["vc"].clone(),
                                t["n1s"], t["n1b"], t["wqkv"], heads=heads,
                                head_dim=hd)[0]
                             for fn in (dk.decode_attn,
                                        dk.decode_attn_reference))
                rels.append(_hold(f"decode_attn seed {seed} B={b} pos={pos}",
                                  [("attn", got, want)])[0][2])
            del t
    results["decode_attn"]["sweep_rel_err"] = {
        "cases": len(rels), "max": max(rels), "median": float(np.median(rels))}
    say("rarm_kernels", f"decode_attn over {RARM_SWEEP_SEEDS} more seeds x "
        f"B {RARM_BATCHES} x pos {RARM_POSITIONS[1:]}: attention output "
        f"/max|ref| max {max(rels):.3e}, median {np.median(rels):.3e} "
        f"(limit {KERNEL_TOL:g})")
    return results


def phase_rarm_forward(rarm_sd: dict) -> None:
    from rdm_tpu_torch.config import RARMConfig
    from rdm_tpu_torch.models.rarm import (RARM, FusedDecoder,
                                           extract_decode_weights)
    from rdm_tpu_torch.ops import decode_kernel as dk
    from rdm_tpu_torch.pipeline import cast_params_for_inference

    cfg = RARMConfig.imagenet_dogs()
    steps, batch = RARM_FORWARD_STEPS, 2
    g = torch.Generator().manual_seed(SEED + 5)
    tokens = torch.cat([
        torch.full((batch, 1), cfg.sos_token, dtype=torch.long),
        torch.randint(0, cfg.out_vocab, (batch, steps - 1), generator=g)],
        dim=1)
    ctx = torch.randn(batch, CONTEXT, cfg.context_dim, generator=g)
    with torch.device("meta"):  # bound to the seeded weights below
        cpu, gpu = RARM(cfg), RARM(cfg, dtype=torch.bfloat16)
    cpu.load_state_dict(rarm_sd, assign=True)
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu.eval()(tokens, ctx)
    cpu_s = time.perf_counter() - t0
    del cpu

    gpu.load_state_dict(rarm_sd, assign=True)
    gpu = cast_params_for_inference(gpu.cuda().eval(), torch.bfloat16)
    weights = extract_decode_weights(gpu, torch.bfloat16)
    dk.reset_launch_counts()
    with torch.inference_mode():
        dec = FusedDecoder(gpu, ctx.cuda(), weights)
        tok = tokens.cuda()
        got = torch.stack([dec.step(tok[:, p], p) for p in range(steps)],
                          dim=1).cpu()
    counts = dk.launch_counts()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"decode logits {tuple(got.shape)} not finite")
    rel = ((got - want).norm() / want.norm()).item()
    say("rarm_forward", f"ImageNet-dogs RARM, {steps} teacher-forced decode "
        f"steps at batch {batch}, context [{batch},{CONTEXT},512]: rel L2 "
        f"err of the logits, CUDA bf16 kernel path vs CPU f32 forward "
        f"{rel:.3e} (limit {RARM_FORWARD_TOL:g}); CPU f32 {cpu_s:.1f} s; "
        f"launches {counts}")
    if not rel <= RARM_FORWARD_TOL:
        raise RuntimeError(f"RARM decode relative error {rel} > "
                           f"{RARM_FORWARD_TOL}")
    want_n = cfg.depth * steps
    if counts["decode_attn"] != want_n or counts["decode_post_ff"] != want_n:
        raise RuntimeError(f"expected {want_n} launches per decode kernel, "
                           f"got {counts}")
    del gpu, dec, weights
    torch.cuda.empty_cache()


def phase_rarm_serve(rarm_sd: dict, vq_sd: dict, emb: torch.Tensor) -> dict:
    """Two 256-token requests through the RARM pipeline, then the batched
    commit path; returns the launch counts of each path."""
    from rdm_tpu_torch.config import AutoencoderConfig, RARMConfig
    from rdm_tpu_torch.models.rarm import sample_tokens_fused
    from rdm_tpu_torch.ops import decode_kernel as dk
    from rdm_tpu_torch.pipeline import RARMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool

    cfg = RARMConfig.imagenet_dogs()
    n_db, batch = emb.shape[0], 16
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    queries = torch.randn(batch, 512, generator=g, device="cuda")
    qids = torch.randint(0, n_db, (batch,), generator=g,
                         device="cuda").cpu().numpy()
    t0 = time.perf_counter()
    pipe = RARMPipeline(cfg, rarm_sd, AutoencoderConfig.vq_f16(), vq_sd,
                        pool=DataPool(embeddings=emb), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    neighbors = pipe.retrieval.search(queries, k=4)["embeddings"]

    # warm-up at the request shapes: a few decode steps at both decode
    # batches, and one VQ-f16 decode
    with torch.inference_mode():
        for guidance in (1.0, 2.0):
            sample_tokens_fused(pipe.model, neighbors, torch.Generator(
                device="cuda").manual_seed(0), steps=4,
                guidance_scale=guidance, weights=pipe.decode_weights)
        pipe.first_stage.decode_code(torch.zeros(
            (batch, cfg.code_side, cfg.code_side), dtype=torch.long,
            device="cuda"))
    dk.reset_launch_counts()
    per_request = cfg.depth * cfg.seq_len
    for i, kind in enumerate(("sample_with_query", "sample_unconditional")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "sample_with_query":
            guidance = 1.0
            out = pipe.sample_with_query(queries, k_nn=4, top_k=256,
                                         guidance_scale=guidance, seed=1,
                                         return_tokens=True)
            images = out["query_samples"]
        else:
            guidance = 2.0
            out = pipe.sample_unconditional(batch, k_nn=4, top_k=256,
                                            guidance_scale=guidance,
                                            qids=qids, seed=2,
                                            return_tokens=True)
            images = out["samples_with_sampled_nns"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dk.launch_counts()
        want = dict.fromkeys(counts, 0)
        want.update(decode_attn=per_request * (i + 1),
                    decode_post_ff=per_request * (i + 1))
        if counts != want:
            raise RuntimeError(f"{kind}: expected launches {want} so far, "
                               f"got {counts}")
        toks = out["tokens"]
        if toks.shape != (batch, cfg.seq_len) or toks.min() < 0 or \
                toks.max() >= cfg.out_vocab:
            raise RuntimeError(f"{kind}: tokens {toks.shape} in "
                               f"[{toks.min()}, {toks.max()}]")
        if images.shape != (batch, 256, 256, 3) or images.dtype != np.uint8:
            raise RuntimeError(f"{kind}: images {images.shape} "
                               f"{images.dtype}")
        if images.std() == 0:
            raise RuntimeError(f"{kind}: constant images")
        n_tok = batch * cfg.seq_len
        say("rarm_serve", f"{kind}: batch {batch}, {cfg.seq_len} tokens, "
            f"top_k 256, guidance {guidance}, k=4 over {n_db}x512: "
            f"{wall:.3f} s, {n_tok / wall:.1f} tokens/s, "
            f"{batch / wall:.3f} img/s; launches so far {counts}")
    launches = dk.launch_counts()

    # the batched cross-layer commit (one commit_rows launch per step)
    # must decode the default path's tokens
    steps, toks = RARM_FORWARD_STEPS, {}
    with torch.inference_mode():
        for batched in (False, True):
            dk.reset_launch_counts()
            toks[batched] = sample_tokens_fused(
                pipe.model, neighbors, torch.Generator(
                    device="cuda").manual_seed(3), steps=steps, top_k=1,
                batched_commit=batched, weights=pipe.decode_weights).cpu()
            counts = dk.launch_counts()
            if counts["commit_rows"] != (steps if batched else 0):
                raise RuntimeError(f"batched_commit={batched}: launches "
                                   f"{counts}")
    launches["commit_rows"] = counts["commit_rows"]
    if not torch.equal(toks[False], toks[True]):
        raise RuntimeError("batched_commit tokens differ from the default "
                           "commit's")
    say("rarm_serve", f"greedy {steps}-step decode at batch {batch}: "
        f"batched_commit tokens equal the in-place commit's; launches "
        f"{counts}")
    say("rarm_serve", f"pipeline set-up {setup_s:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _site_int8(t: dict, s: int, heads: int) -> tuple:
    """The int8 weights of a site's tensors and the activation scales a
    calibration would give them: the absmax of each quantized activation
    along the plain bf16 block."""
    from rdm_tpu_torch.ops import block_kernel as bk

    images, c = t["x"].shape[0], t["x"].shape[-1]
    r, hd = images * s, c // heads
    x2 = t["x"].reshape(r, c)
    q, k, v = (a.contiguous().reshape(images, s, c) for a in
               bk.ln_qkv_reference(x2, t["n1s"], t["n1b"], t["wqkv"]))
    attn = bk.packed_attn_reference(q, k, v, heads=heads, head_dim=hd)
    x1 = t["x"] + bk._linear(attn.reshape(r, c), t["wo"], t["bo"]).reshape(
        attn.shape)
    h2 = bk.layer_norm(x1, t["n2s"], t["n2b"])
    o = bk._cross_attention_f32(
        bk._linear(h2.reshape(r, c), t["wq2"]).reshape(attn.shape), t["ck"],
        t["cv"], heads, hd)
    xm = bk.post_cross_reference(
        t["x"], attn, t["ck"], t["cv"], t["wo"], t["bo"], t["n2s"],
        t["n2b"], t["wq2"], t["wo2"], t["bo2"], heads=heads, head_dim=hd)
    h3 = bk.layer_norm(xm.reshape(r, c), t["n3s"], t["n3b"])
    f = (bk._linear(h3, t["wa"], t["ba"]).float() * torch.nn.functional.gelu(
        bk._linear(h3, t["wg"], t["bg"]).float()))
    absmax = [bk.layer_norm(x2, t["n1s"], t["n1b"]), attn, h2, o, h3, f]
    a = {n: bk.act_scale(m.float().abs().max().item())
         for n, m in zip(bk.QSCALE_NAMES, absmax)}
    w = bk.quantize_block_weights(dict(t))
    return w, a, (q, k, v, attn, xm.reshape(r, c))


def hidden_codes_differ(xm2: torch.Tensor, w: dict, a: dict,
                        hidden: torch.Tensor) -> float:
    """The share of geglu_ff_q's hidden codes (`hidden`, as a call wrote
    them) that differ from the plain int8 math's on the card."""
    from rdm_tpu_torch.ops import block_kernel as bk

    h3q = bk.quantize_act(bk.layer_norm(xm2, w["n3s"], w["n3b"]), a["a_ff"])
    a3 = torch.tensor(a["a_ff"], device=xm2.device)
    av = bk._int_matmul(h3q, w["wa_q"]).float() * (a3 * w["wa_s"]) + w["ba"]
    gv = bk._int_matmul(h3q, w["wg_q"]).float() * (a3 * w["wg_s"]) + w["bg"]
    f = av * (0.5 * gv * (1.0 + torch.erf(gv * 0.7071067811865476)))
    return (bk.quantize_act(f, a["h_ff"]) != hidden).float().mean().item()


def _int8_gemm_site(name: str, kern, pos: tuple, kw: dict,
                    hidden: torch.Tensor) -> dict:
    """Phase 9's extra numbers of ln_qkv_q / post_cross_q / geglu_ff_q at
    one site: each s8 launch's device time in a CUDA graph, host us a
    call, and a second call bit-equal to the first (geglu_ff_q's hidden
    codes too). Raises where two calls differ."""
    n = len(INT8_GEMM_LAUNCHES[name])
    extra = {"hidden": hidden} if name == "geglu_ff_q" else {}
    first = _flat(kern(*pos, **kw, **extra))
    codes = hidden.clone()
    again = _flat(kern(*pos, **kw, **extra))
    torch.cuda.synchronize()
    equal = torch.equal(first, again) and torch.equal(codes, hidden)
    if not equal:
        raise RuntimeError(f"{name}: two calls differ")
    parts = graph_launch_ms(lambda: kern(*pos, **kw), n,
                            "block_gemm_s8_kernel")
    out = {"s8_launch_device_ms": None if parts is None else
           dict(zip(INT8_GEMM_LAUNCHES[name], parts)),
           "host_us": host_us(lambda: kern(*pos, **kw)),
           "two_calls_bit_equal": equal}
    launches = ("not seen by the profiler" if parts is None else ", ".join(
        f"{k} {v:.4f}" for k, v in out["s8_launch_device_ms"].items()))
    say("int8_kernels", f"  {name} s8 launches (device ms, CUDA graph): "
        f"{launches}; host per call {out['host_us']:.1f} us; two calls "
        f"bit-equal")
    return out


def _int8_attn_site(q, k, v, heads: int, hd: int) -> dict:
    """Phase 9's extra numbers of packed_attn_q8 at one site: each of its
    three launches' device time in a CUDA graph, the exp2 floor (one ex2 a
    score), host us a call, a second call bit-equal to the first; and the
    same q, k, v read as heads of 64 against the plain version, its device
    time and exp2 floor. Raises where two calls differ or the 64-wide
    heads miss KERNEL_TOL."""
    from rdm_tpu_torch.ops import block_kernel as bk

    b, s, c = q.shape
    kw = dict(heads=heads, head_dim=hd)
    first = bk.packed_attn_q8(q, k, v, **kw)
    again = bk.packed_attn_q8(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise RuntimeError(f"packed_attn_q8 at C={c}: two calls differ")
    parts = graph_launch_ms(lambda: bk.packed_attn_q8(q, k, v, **kw),
                            len(ATTN8_LAUNCHES), "attn8::")
    kw64 = dict(heads=c // 64, head_dim=64)
    got = bk.packed_attn_q8(q, k, v, **kw64)
    torch.cuda.synchronize()
    want = bk.packed_attn_q8_reference(q, k, v, **kw64).float()
    rel64 = ((got.float() - want).abs().max() / want.abs().max()).item()
    if not (torch.isfinite(got).all() and rel64 <= KERNEL_TOL):
        raise RuntimeError(f"packed_attn_q8 head_dim 64 at C={c}: relative "
                           f"error {rel64} > {KERNEL_TOL}")
    out = {"attn8_launch_device_ms": None if parts is None else
           dict(zip(ATTN8_LAUNCHES, parts)),
           "exp2_floor_ms": exp2_floor_ms(b * heads * s * s),
           "host_us": host_us(lambda: bk.packed_attn_q8(q, k, v, **kw)),
           "two_calls_bit_equal": True,
           "head_dim_64": {
               "rel_err": rel64,
               "kernel_device_ms": graph_ms(
                   lambda: bk.packed_attn_q8(q, k, v, **kw64)),
               "exp2_floor_ms": exp2_floor_ms(b * (c // 64) * s * s)}}
    launches = ("not seen by the profiler" if parts is None else ", ".join(
        f"{n} {t:.4f}" for n, t in out["attn8_launch_device_ms"].items()))
    h64 = out["head_dim_64"]
    say("int8_kernels", f"  packed_attn_q8 launches (device ms, CUDA "
        f"graph): {launches}; exp2 floor {out['exp2_floor_ms']:.4f} ms; "
        f"host per call {out['host_us']:.1f} us; two calls bit-equal; "
        f"heads of 64: /max|ref| {rel64:.3e}, device "
        f"{h64['kernel_device_ms']:.4f} ms, exp2 floor "
        f"{h64['exp2_floor_ms']:.4f} ms")
    return out


def phase_int8_kernels() -> dict:
    """Phase 9: each int8 kernel against its plain version at the three
    sites, on the same int8 weights and scales. Per kernel: {'max_abs_err',
    'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by', 'sites'}."""
    from rdm_tpu_torch.ops import block_kernel as bk

    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": None, "sites": []} for name in INT8_INFO}
    for c, s, heads in SITES:
        t = _site_tensors(c, s, heads, g)
        w, a, (q, k, v, attn, xm2) = _site_int8(t, s, heads)
        r, hd = CFG_BATCH * s, c // heads
        x2 = t["x"].reshape(r, c)
        hidden = torch.empty((r, 4 * c), dtype=torch.int8, device="cuda")
        args = {
            "ln_qkv_q": ((x2, w["n1s"], w["n1b"], w["wqkv_q"], w["wqkv_s"],
                          a["a_qkv"]), {}),
            "packed_attn_q8": ((q, k, v), dict(heads=heads, head_dim=hd)),
            "post_cross_q": ((t["x"], attn, t["ck"], t["cv"], w["wo_q"],
                              w["wo_s"], w["bo"], w["n2s"], w["n2b"],
                              w["wq2_q"], w["wq2_s"], w["wo2_q"], w["wo2_s"],
                              w["bo2"], a["o_attn1"], a["a_attn2"],
                              a["o_attn2"]), dict(heads=heads, head_dim=hd)),
            "geglu_ff_q": ((xm2, w["n3s"], w["n3b"], w["wa_q"], w["wa_s"],
                            w["wg_q"], w["wg_s"], w["ba"], w["bg"],
                            w["w2_q"], w["w2_s"], w["b2"], a["a_ff"],
                            a["h_ff"]), {}),
        }
        for name, (pos, kw) in args.items():
            kern = getattr(bk, name)
            plain = getattr(bk, name + "_reference")
            extra = {"hidden": hidden} if name == "geglu_ff_q" else {}
            got = _flat(kern(*pos, **kw, **extra))
            torch.cuda.synchronize()
            want = _flat(plain(*pos, **kw))
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} at C={c}: non-finite output")
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            site = {"C": c, "S": s, "heads": heads, "max_abs_err": err,
                    "rel_err": rel}
            codes = ""
            if name == "geglu_ff_q":  # the hidden codes the kernel wrote
                site["hidden_codes_differ"] = hidden_codes_differ(
                    xm2, w, a, hidden)
                codes = (f"; hidden codes differing "
                         f"{site['hidden_codes_differ']:.3e}")
            ms = median_ms(lambda: kern(*pos, **kw))
            plain_ms = median_ms(lambda: plain(*pos, **kw))
            site["bound_ms"], site["bound_by"] = bound(*block_cost(name, c, s))
            site.update(ms=ms, plain_ms=plain_ms,
                        **wrapper_device(lambda: kern(*pos, **kw)))
            if name in INT8_GEMM_LAUNCHES:
                site.update(_int8_gemm_site(name, kern, pos, kw, hidden))
            if name == "packed_attn_q8":
                site.update(_int8_attn_site(q, k, v, heads, hd))
            say("int8_kernels", f"{name:14s} C={c:4d} S={s:4d} heads="
                f"{heads:2d}: max|err| {err:.4g}, /max|ref| {rel:.3e} "
                f"(limit {KERNEL_TOL:g}){codes}; kernel {ms:.4f} ms (device "
                f"{site['kernel_device_ms']:.4f}), plain {plain_ms:.4f} ms, "
                f"bound {site['bound_ms']:.4f} ms ({site['bound_by']})")
            if not rel <= KERNEL_TOL:
                raise RuntimeError(f"{name} at C={c}: relative error {rel} "
                                   f"> {KERNEL_TOL}")
            res = results[name]
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            res["sites"].append(site)
        del t, w, q, k, v, attn, xm2, hidden
        torch.cuda.empty_cache()
    for name, res in results.items():
        _sum_bound(res, [block_cost(name, c, s) for c, s, _ in SITES])
        res["kernel_device_ms"] = sum(x["kernel_device_ms"]
                                      for x in res["sites"])
    results["packed_attn_q8"]["exp2_floor_ms"] = sum(
        x["exp2_floor_ms"] for x in results["packed_attn_q8"]["sites"])
    return results


def _unet_trio(rdm_sd: dict):
    """The ImageNet U-Net on the card in bf16, and on the CPU in f32 and in
    bf16, on the same weights rounded to bf16 (so all quantize to the same
    codes)."""
    from rdm_tpu_torch.config import UNetConfig
    from rdm_tpu_torch.models.unet import UNet
    from rdm_tpu_torch.pipeline import cast_params_for_inference

    pre = "model.diffusion_model."
    sd = {k[len(pre):]: (v.bfloat16().float() if v.ndim >= 2 else v)
          for k, v in rdm_sd.items() if k.startswith(pre)}
    cfg, bf = UNetConfig.imagenet_rdm(), torch.bfloat16
    with torch.device("meta"):  # bound to the seeded weights below
        cpu, cpu_bf, gpu = UNet(cfg), UNet(cfg, dtype=bf), UNet(cfg, dtype=bf)
    for m in (cpu, cpu_bf, gpu):
        m.load_state_dict(sd, assign=True)
    return (cpu.eval(), cast_params_for_inference(cpu_bf.eval(), bf),
            cast_params_for_inference(gpu.cuda().eval(), bf))


def phase_int8_forward(rdm_sd: dict) -> None:
    """Phase 10: one full-width int8 U-Net forward, CUDA bf16 against the
    CPU plain int8 forwards (bf16 and f32) on the same int8 weights and
    scales; then one with RDM_TPU_INT8_ATTN=1 (the int8 attention core)
    against the CPU f32 plain forward of that mode."""
    from rdm_tpu_torch.models.layers import TransformerBlock
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(SEED + 21)
    x = torch.randn(1, 3, 64, 64, generator=g)
    t = torch.tensor([501])
    ctx = torch.randn(2, CONTEXT, 512, generator=g)
    cpu, cpu_bf, gpu = _unet_trio(rdm_sd)
    xc, tc, cc = x.cuda(), t.cuda(), ctx.cuda()
    with torch.inference_mode():
        bf = gpu(xc, tc, cc).cpu()
        with quant.calibrate():
            gpu(xc, tc, cc)
        quant.quantize_conv_tree(gpu, quant.collect_absmax(gpu),
                                 exclude=quant.unet_exclude(gpu))
        for m in gpu.modules():
            if isinstance(m, TransformerBlock):
                m.pack(torch.bfloat16)
        qstate = {k: v.cpu() for k, v in gpu.state_dict().items()
                  if k.rsplit(".", 1)[-1] in ("qweight", "kernel_scale",
                                              "act_scale", "qabsmax")}
        cpu.load_state_dict(qstate, strict=False)
        cpu_bf.load_state_dict(qstate, strict=False)
        n_q, n_cpu = quant.num_quantized(gpu), quant.num_quantized(cpu)
        bk.reset_launch_counts()
        got = gpu(xc, tc, cc).cpu()
        counts = bk.launch_counts()
        t0 = time.perf_counter()
        want = cpu(x, t, ctx)
        cpu_s = time.perf_counter() - t0
        want_bf = cpu_bf(x, t, ctx)
    if tuple(got.shape) != (2, 3, 64, 64) or not torch.isfinite(got).all():
        raise RuntimeError(f"int8 forward output {tuple(got.shape)} not "
                           "finite")
    def rel_l2(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    rel, rel_cpu_bf = rel_l2(got, want), rel_l2(got, want_bf)
    d = (got - want).abs().flatten()
    say("int8_forward", f"ImageNet U-Net int8, x [1,3,64,64] + context "
        f"[2,4,512], same int8 weights and scales: rel L2 err CUDA bf16 vs "
        f"CPU bf16 plain {rel_cpu_bf:.3e}, vs CPU f32 plain {rel:.3e} (limit "
        f"{INT8_FORWARD_TOL:g} each; |err| "
        f"quantiles 50/99/100% {d.quantile(0.5).item():.3e} / "
        f"{d.quantile(0.99).item():.3e} / {d.max().item():.3e}, max|ref| "
        f"{want.abs().max().item():.3e}); CPU bf16 vs CPU f32 "
        f"{rel_l2(want_bf, want):.3e}; int8 vs bf16 forward on the card "
        f"{rel_l2(got, bf):.3e}; {n_q} convs int8 (CPU {n_cpu}); CPU f32 "
        f"{cpu_s:.1f} s; launches {counts}")
    if not max(rel, rel_cpu_bf) <= INT8_FORWARD_TOL:
        raise RuntimeError(f"int8 forward relative errors {rel_cpu_bf}, "
                           f"{rel} > {INT8_FORWARD_TOL}")
    want_counts = {k: 0 for k in counts}
    want_counts.update(ln_qkv_q=16, packed_attn=16, post_cross_q=16,
                       geglu_ff_q=16)
    if counts != want_counts or n_q != n_cpu or n_q == 0:
        raise RuntimeError(f"int8 forward: launches {counts}, int8 convs "
                           f"{n_q} / {n_cpu}")
    os.environ["RDM_TPU_INT8_ATTN"] = "1"
    try:
        with torch.inference_mode():
            bk.reset_launch_counts()
            got8 = gpu(xc, tc, cc).cpu()
            counts = bk.launch_counts()
            want8 = cpu(x, t, ctx)
    finally:
        os.environ.pop("RDM_TPU_INT8_ATTN")
    rel8 = rel_l2(got8, want8)
    say("int8_forward", f"RDM_TPU_INT8_ATTN=1: rel L2 err CUDA bf16 vs CPU "
        f"f32 plain {rel8:.3e} (limit {INT8_FORWARD_TOL:g}); vs the int8 "
        f"forward on the bf16 core {rel_l2(got8, got):.3e}; launches "
        f"{counts}")
    want_counts.update(packed_attn=0, packed_attn_q8=16)
    if not (torch.isfinite(got8).all() and rel8 <= INT8_FORWARD_TOL
            and counts == want_counts):
        raise RuntimeError(f"int8 forward with RDM_TPU_INT8_ATTN=1: rel L2 "
                           f"{rel8}, launches {counts}")
    del cpu, cpu_bf, gpu
    torch.cuda.empty_cache()


def phase_serve_modes(rdm_sd: dict, vq_sd: dict, emb: torch.Tensor) -> dict:
    """Phase 11: the serving modes through the pipeline over phase 5's
    table; returns the int8 kernels' launches over the int8 requests."""
    import os

    from rdm_tpu_torch.config import AutoencoderConfig, RDMConfig
    from rdm_tpu_torch.models.layers import Conv2d, SpatialTransformer
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.ops import quant
    from rdm_tpu_torch.pipeline import RDMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool

    batch, steps = 4, SERVE_STEPS
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    queries = torch.randn(batch, 512, generator=g, device="cuda")
    finite = []

    def build(int8: bool):
        pipe = RDMPipeline(RDMConfig.imagenet(), rdm_sd,
                           AutoencoderConfig.vq_f4(), vq_sd,
                           pool=DataPool(embeddings=emb), device="cuda",
                           int8_weights=int8)
        pipe.first_stage.decoder.register_forward_hook(
            lambda m, i, o: finite.append(bool(torch.isfinite(o).all())))
        return pipe

    def request(pipe, label, reuse=1, attn8=False):
        os.environ["RDM_TPU_INT8_ATTN"] = "1" if attn8 else "0"
        bk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = pipe.sample_with_query(queries, k_nn=4, steps=steps,
                                        guidance_scale=2.0, seed=1,
                                        encoder_reuse=reuse)["query_samples"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = bk.launch_counts()
        if images.shape != (batch, 256, 256, 3) or images.std() == 0 \
                or not all(finite):
            raise RuntimeError(f"{label}: images {images.shape}, std "
                               f"{images.std()}, finite {finite}")
        say("serve_modes", f"{label}: batch {batch}, DDIM-{steps}, guidance "
            f"2.0, k=4 over {emb.shape[0]}x512: {wall:.3f} s, "
            f"{batch / wall:.3f} img/s; launches {counts}")
        return images, counts, wall

    def blocks(module):  # transformer blocks under a module
        return sum(len(m.transformer_blocks) for m in module.modules()
                   if isinstance(m, SpatialTransformer))

    def full(n):  # full U-Net forwards of a request under reuse n
        return sum(1 for i in range(steps) if i % n == 0)

    pipe = build(False)
    n_blocks = blocks(pipe.model.unet)
    n_up = blocks(pipe.model.unet.output_blocks)
    request(pipe, "warm-up bf16")
    default, _, _ = request(pipe, "bf16 default")
    reuse1, _, _ = request(pipe, "bf16 encoder_reuse=1", reuse=1)
    if not np.array_equal(default, reuse1):
        raise RuntimeError("encoder_reuse=1 images differ from the default")
    for n in (2, 3):
        _, counts, _ = request(pipe, f"bf16 encoder_reuse={n}", reuse=n)
        want = full(n) * n_blocks + (steps - full(n)) * n_up
        if any(counts[k] != want for k in
               ("ln_qkv", "packed_attn", "post_cross", "geglu_ff")):
            raise RuntimeError(f"reuse {n}: expected {want} launches per "
                               f"kernel, got {counts}")
    del pipe
    torch.cuda.empty_cache()

    pipe = build(True)
    unet = pipe.model.unet
    expect_q = sum(1 for m in unet.modules() if isinstance(m, Conv2d)
                   and m.quantizable) - len(quant.unet_exclude(unet))
    _, counts, wall = request(pipe, "int8 (calibrates)")
    n_q = quant.num_quantized(unet)
    say("serve_modes", f"int8 calibration {pipe.calibration_seconds:.3f} s "
        f"of the first request's {wall:.3f} s; {n_q} U-Net convs int8 "
        f"(module tree: {expect_q}), {quant.num_quantized(pipe.first_stage)}"
        f" VQ decoder convs int8")
    if n_q != expect_q:
        raise RuntimeError(f"num_quantized {n_q} != {expect_q}")
    q8 = {k: 0 for k in counts}
    # the calibration's bf16 sampling run, then the int8 request
    n = n_blocks * steps
    want = dict(q8, ln_qkv=n, packed_attn=2 * n, post_cross=n, geglu_ff=n,
                ln_qkv_q=n, post_cross_q=n, geglu_ff_q=n)
    if counts != want:
        raise RuntimeError(f"int8 first request: launches {counts} != {want}")
    launches = dict(q8)
    for label, reuse, attn8 in (("int8", 1, False),
                                ("int8 + RDM_TPU_INT8_ATTN=1", 1, True),
                                ("int8 + encoder_reuse=3", 3, False)):
        _, counts, _ = request(pipe, label, reuse=reuse, attn8=attn8)
        n = full(reuse) * n_blocks + (steps - full(reuse)) * n_up
        want = dict(q8, ln_qkv_q=n, post_cross_q=n, geglu_ff_q=n,
                    **({"packed_attn_q8": n} if attn8 else {"packed_attn": n}))
        if counts != want:
            raise RuntimeError(f"{label}: launches {counts} != {want}")
        for k in launches:
            launches[k] += counts[k]
    os.environ.pop("RDM_TPU_INT8_ATTN")
    say("serve_modes", f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pipe
    torch.cuda.empty_cache()
    return launches


def _int8_layer(t: dict) -> dict:
    """The int8_weights form of a layer's tensors (`_decode_tensors`), and
    its caches as int8 codes with their per-(row, batch row) scales."""
    from rdm_tpu_torch.ops import decode_kernel as dk

    w = dict(t)
    for name in dk.INT8_WEIGHTS:
        w[name + "_q"], w[name + "_s"] = dk.quantize_weight(t[name])
    for name in ("kc", "vc"):
        codes, scale = dk.quantize_rows(t[name].float().reshape(
            -1, t[name].shape[-1]))
        w[name + "8"] = codes.reshape(t[name].shape)
        w[name[0] + "s"] = scale.reshape(*t[name].shape[:2], 1)
    return w


def phase_rarm_int8_kernels() -> dict:
    """Phase 12: the int8 variants of the decode kernels against their plain
    versions at full width. Per variant: {'max_abs_err', 'ms', 'plain_ms',
    'library_ms', 'bound_ms', 'bound_by', 'cases'}."""
    from rdm_tpu_torch.ops import decode_kernel as dk

    heads, hd = 12, 64
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "library_ms": None, "cases": []}
               for name in INT8_DECODE_INFO}
    for b in RARM_BATCHES:
        t = _int8_layer(_decode_tensors(b, g))
        keep = torch.ones(t["kc"].shape[0], dtype=torch.bool, device="cuda")
        for pos in RARM_POSITIONS:
            what = f"B={b} pos={pos}"
            for name in INT8_DECODE_INFO:
                if name == "decode_post_ff_w8":
                    ff = [t["x"], t["attn_" + str(pos)], t["ck"], t["cv"]] + [
                        t[n + "_q" if n + "_q" in t else n] for n in (
                            "wo", "bo", "n2s", "n2b", "wq2", "wo2", "bo2",
                            "n3s", "n3b", "wa", "wg", "ba", "bg", "w2",
                            "b2")]
                    sc = tuple(t[n + "_s"] for n in dk.POST_FF_WEIGHTS)
                    kern = lambda: dk.decode_post_ff(  # noqa: E731
                        *ff, heads=heads, head_dim=hd, scales=sc)
                    plain = lambda: dk.decode_post_ff_reference(  # noqa: E731
                        *ff, heads=heads, head_dim=hd, scales=sc)
                    got = kern()
                    torch.cuda.synchronize()
                    errs = _hold(f"{name} {what}", [("x_out", got, plain())])
                    chain = _post_ff_chain(
                        f"{name} {what}", kern, got,
                        lambda: dk._decode_post_ff(*ff, heads=heads,
                                                   head_dim=hd, scales=sc,
                                                   pdl=False))
                    detail = _chain_text(chain)[2:]
                else:
                    w8, kv8 = "_w8" in name, name.endswith("_kv8")
                    kw = dict(heads=heads, head_dim=hd,
                              wqkv_s=t["wqkv_s"] if w8 else None)
                    wq = t["wqkv_q"] if w8 else t["wqkv"]
                    caches = ("kc8", "vc8", "ks", "vs") if kv8 else \
                        ("kc", "vc")
                    mine = [t[n].clone() for n in caches]
                    ref = [t[n].clone() for n in caches]

                    def call(fn, cs):
                        extra = dict(ks_cache=cs[2], vs_cache=cs[3]) \
                            if kv8 else {}
                        return fn(t["x"], pos, cs[0], cs[1], t["n1s"],
                                  t["n1b"], wq, **kw, **extra)

                    kern = lambda: call(dk.decode_attn, mine)  # noqa: E731
                    plain = lambda: call(  # noqa: E731
                        dk.decode_attn_reference, ref)
                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                    errs = _hold(f"{name} {what}", zip(
                        ("attn", "k_new", "v_new"), got, want))
                    keep[pos] = False
                    for i, n in enumerate(caches):
                        if not torch.equal(mine[i][keep], t[n][keep]):
                            raise RuntimeError(f"{name} {what}: rows other "
                                               f"than {pos} of {n} changed")
                    keep[pos] = True
                    if kv8:
                        diff = (mine[0][pos].int() - ref[0][pos].int()).abs()
                        diff = torch.cat([diff.flatten(), (
                            mine[1][pos].int() - ref[1][pos].int()).abs()
                            .flatten()])
                        share = (diff > 0).float().mean().item()
                        srel = max(((m[pos] - r[pos]).abs() / r[pos])
                                   .max().item()
                                   for m, r in zip(mine[2:], ref[2:]))
                        if diff.max().item() > 1 or share > CODE_SHARE or \
                                srel > SCALE_RTOL:
                            raise RuntimeError(
                                f"{name} {what}: committed codes differ by "
                                f"up to {diff.max().item()} on {share:.3e} "
                                f"of row {pos} (limits 1, {CODE_SHARE:g}); "
                                f"scales {srel:.3e} (limit {SCALE_RTOL:g})")
                        detail = (f"; commit codes off by one {share:.3e}, "
                                  f"scales rel {srel:.3e}")
                    else:
                        if not (torch.equal(mine[0][pos], got[1])
                                and torch.equal(mine[1][pos], got[2])):
                            raise RuntimeError(f"{name} {what}: cache row "
                                               f"{pos} is not k_new / v_new")
                        detail = "; cache rows exact"
                    if name == "decode_attn_w8":
                        t["attn_" + str(pos)] = want[0]  # post_ff's input
                    _same_bits(f"{name} {what}", kern, got,
                               lambda: call(functools.partial(
                                   dk._decode_attn, pdl=False), mine))
                    detail = "; ".join(f"{lab} {rel:.3e}"
                                       for lab, _, rel in errs[1:]) + detail
                    detail += "; two calls, a graph and PDL off bit-equal"
                    apart = _decode_attn_apart(
                        t["x"], pos, *mine[:2], t["n1s"], t["n1b"], wq,
                        heads=heads, hd=hd, wqkv_s=kw["wqkv_s"],
                        ks=mine[2] if kv8 else None,
                        vs=mine[3] if kv8 else None)
                    say("rarm_int8_kernels", f"{name:18s} "
                        + _apart_text(what, apart)
                        + ("; an int8 cache dequantized for SDPA" if kv8
                           else ""))
                _, err, rel = errs[0]
                ms, plain_ms = median_ms(kern), median_ms(plain)
                dev = wrapper_device(kern)
                if name == "decode_post_ff_w8":
                    dev.update(chain)
                bound_ms, by = bound(*decode_cost(name, b, pos))
                say("rarm_int8_kernels", f"{name:18s} {what:13s}: max|err| "
                    f"{err:.4g}, /max|ref| {rel:.3e} (limit {KERNEL_TOL:g})"
                    f"{'; ' + detail if detail else ''}; kernel {ms:.4f} "
                    f"ms (device {dev['kernel_device_ms']:.4f}), plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
                res = results[name]
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["cases"].append({
                    "B": b, "pos": pos, "max_abs_err": err,
                    "rel_err": {lab: r for lab, _, r in errs}, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, **dev,
                    **(apart if name != "decode_post_ff_w8" else {})})
        del t
        torch.cuda.empty_cache()
    for res in results.values():
        n = len(res["cases"])
        for key in ("ms", "plain_ms", "bound_ms", "kernel_device_ms"):
            res[key] = sum(c[key] for c in res["cases"]) / n
        res["bound_by"] = max(res["cases"], key=lambda c: c["bound_ms"])[
            "bound_by"]
    _mean_chain(results["decode_post_ff_w8"])
    for name in INT8_DECODE_INFO:
        if name.startswith("decode_attn"):
            _mean_apart(results[name])
    return results


def phase_rarm_serve_modes(rarm_sd: dict, vq_sd: dict,
                           emb: torch.Tensor) -> dict:
    """Phase 13: the RARM serving modes through the pipeline, then the int8
    cache held against int8 weights alone; returns the launches of the
    int8 variants over the requests."""
    from rdm_tpu_torch.config import AutoencoderConfig, RARMConfig
    from rdm_tpu_torch.models.rarm import FusedDecoder, sample_tokens_fused
    from rdm_tpu_torch.ops import decode_kernel as dk
    from rdm_tpu_torch.pipeline import RARMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool

    cfg = RARMConfig.imagenet_dogs()
    n_db, batch = emb.shape[0], 16
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    queries = torch.randn(batch, 512, generator=g, device="cuda")
    qids = torch.randint(0, n_db, (batch,), generator=g,
                         device="cuda").cpu().numpy()
    pipe = RARMPipeline(cfg, rarm_sd, AutoencoderConfig.vq_f16(), vq_sd,
                        pool=DataPool(embeddings=emb), device="cuda")
    neighbors = pipe.retrieval.search(queries, k=4)["embeddings"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w8 = pipe.serving_decode_weights(True)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    with torch.inference_mode():  # warm-up: every variant, both batches
        for guidance in (1.0, 2.0):
            for opts in (dict(int8_weights=True), dict(int8_kv=True),
                         dict(int8_weights=True, int8_kv=True)):
                sample_tokens_fused(
                    pipe.model, neighbors, torch.Generator(
                        device="cuda").manual_seed(0), steps=4,
                    guidance_scale=guidance,
                    weights=w8 if opts.get("int8_weights") else
                    pipe.decode_weights, **opts)
    n8 = sum(w[k].numel() for w in w8 for k in dk.INT8_WEIGHTS)
    say("rarm_serve_modes", f"int8 decode weights packed in {pack_s:.3f} s "
        f"({n8 / 2**20:.1f} MiB of int8 codes)")

    per_request = cfg.depth * cfg.seq_len
    launches = dict.fromkeys(dk.KERNEL_NAMES, 0)
    both = dict(int8_weights=True, int8_kv=True)
    for label, opts, guidance in (
            ("int8_weights", dict(int8_weights=True), 1.0),
            ("int8_kv", dict(int8_kv=True), 1.0),
            ("int8_weights + int8_kv", both, 2.0),
            ("approx_top_k", dict(approx_top_k=True), 1.0)):
        dk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if guidance == 1.0:
            out = pipe.sample_with_query(queries, k_nn=4, top_k=256,
                                         guidance_scale=guidance, seed=1,
                                         return_tokens=True, **opts)
            images = out["query_samples"]
        else:
            out = pipe.sample_unconditional(batch, k_nn=4, top_k=256,
                                            guidance_scale=guidance,
                                            qids=qids, seed=2,
                                            return_tokens=True, **opts)
            images = out["samples_with_sampled_nns"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dk.launch_counts()
        q8, kv8 = opts.get("int8_weights", False), opts.get("int8_kv", False)
        want = dict.fromkeys(counts, 0)
        want["decode_attn" + ("_w8" if q8 else "") + ("_kv8" if kv8 else "")] \
            = per_request
        want["decode_post_ff_w8" if q8 else "decode_post_ff"] = per_request
        if counts != want:
            raise RuntimeError(f"{label}: launches {counts} != {want}")
        toks = out["tokens"]
        if toks.shape != (batch, cfg.seq_len) or toks.min() < 0 or \
                toks.max() >= cfg.out_vocab:
            raise RuntimeError(f"{label}: tokens {toks.shape} in "
                               f"[{toks.min()}, {toks.max()}]")
        if images.shape != (batch, 256, 256, 3) or images.std() == 0:
            raise RuntimeError(f"{label}: images {images.shape}, std "
                               f"{images.std()}")
        say("rarm_serve_modes", f"{label}: batch {batch}, {cfg.seq_len} "
            f"tokens, top_k 256, guidance {guidance}, k=4 over {n_db}x512: "
            f"{wall:.3f} s, {batch * cfg.seq_len / wall:.1f} tokens/s, "
            f"{batch / wall:.3f} img/s; launches {counts}")
        for k in launches:
            launches[k] += counts[k]

    # the int8 cache against int8 weights alone, teacher-forced
    steps = RARM_FORWARD_STEPS
    tokens = torch.cat([
        torch.full((batch, 1), cfg.sos_token, device="cuda"),
        torch.randint(0, cfg.out_vocab, (batch, steps - 1), generator=g,
                      device="cuda")], dim=1)
    logits = {}
    with torch.inference_mode():
        for label, weights, kv8 in (("bf16", pipe.decode_weights, False),
                                    ("int8_weights", w8, False),
                                    ("int8_weights + int8_kv", w8, True)):
            dec = FusedDecoder(pipe.model, neighbors, weights, int8_kv=kv8)
            logits[label] = torch.stack(
                [dec.step(tokens[:, p], p) for p in range(steps)], dim=1)
    for v in logits.values():
        if not torch.isfinite(v).all():
            raise RuntimeError("teacher-forced int8 logits not finite")

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    rel = rel_l2(logits["int8_weights + int8_kv"], logits["int8_weights"])
    say("rarm_serve_modes", f"{steps} teacher-forced steps at batch {batch}:"
        f" rel L2 of the logits, int8_weights + int8_kv vs int8_weights "
        f"{rel:.3e} (limit {RARM_KV8_TOL:g}); int8_weights vs bf16 "
        f"{rel_l2(logits['int8_weights'], logits['bf16']):.3e}; "
        f"int8_weights + int8_kv vs bf16 "
        f"{rel_l2(logits['int8_weights + int8_kv'], logits['bf16']):.3e}")
    if not rel <= RARM_KV8_TOL:
        raise RuntimeError(f"int8_kv relative error {rel} > {RARM_KV8_TOL}")
    say("rarm_serve_modes", f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pipe, w8, dec
    torch.cuda.empty_cache()
    return launches


def phase_post_ff(rdm_sd: dict, vq_sd: dict, emb: torch.Tensor) -> dict:
    """Phase 14: post_ff, the post-attention half in one call; returns its
    results with `launches`, the count over the post_ff requests."""
    import os

    from rdm_tpu_torch.config import AutoencoderConfig, RDMConfig
    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.pipeline import RDMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool

    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "split_ms": 0.0,
           "library_ms": None, "sites": []}
    for c, s, heads in SITES:
        t = _site_tensors(c, s, heads, g)
        r, hd = CFG_BATCH * s, c // heads
        q, k, v = (a.contiguous().reshape(CFG_BATCH, s, c) for a in
                   bk.ln_qkv_reference(t["x"].reshape(r, c), t["n1s"],
                                       t["n1b"], t["wqkv"]))
        attn = bk.packed_attn_reference(q, k, v, heads=heads, head_dim=hd)
        args = [t["x"], attn] + [t[n] for n in (
            "ck", "cv", "wo", "bo", "n2s", "n2b", "wq2", "wo2", "bo2", "n3s",
            "n3b", "wa", "wg", "ba", "bg", "w2", "b2")]
        kw = dict(heads=heads, head_dim=hd)
        kern = lambda: bk.post_ff(*args, **kw)  # noqa: E731
        plain = lambda: bk.post_ff_reference(*args, **kw)  # noqa: E731
        split = lambda: bk.geglu_ff(  # noqa: E731
            bk.post_cross(*args[:11], **kw).reshape(r, c), *args[11:])
        got, xm = bk._post_ff(*args, **kw)
        xm_pair = bk.post_cross(*args[:11], **kw)
        pair = bk.geglu_ff(xm_pair.reshape(r, c), *args[11:]).reshape(
            got.shape)
        again = kern()
        torch.cuda.synchronize()
        _, err, rel = _hold(f"post_ff at C={c}", [("y", got, plain())])[0]
        # post_ff runs post_cross's launcher with its plans, so xm is
        # post_cross's to the bit; no atomics, so two calls are bit-equal
        if not torch.equal(xm, xm_pair):
            raise RuntimeError(f"post_ff at C={c}: xm differs from "
                               "post_cross's")
        if not torch.equal(got, again):
            raise RuntimeError(f"post_ff at C={c}: two calls differ")
        pair_err = (got.float() - pair.float()).abs().max().item()
        # the FF launch sums f's slices across its cluster in rank order,
        # the pair's down launch f's K-steps in one walk, so the two agree
        # within the kernel tolerance, not bit for bit
        pair_rel = pair_err / pair.float().abs().max().item()
        if not pair_rel <= KERNEL_TOL:
            raise RuntimeError(f"post_ff at C={c}: {pair_rel} from the split "
                               f"pair > {KERNEL_TOL}")
        ms, split_ms, plain_ms = (median_ms(fn) for fn in (kern, split,
                                                           plain))
        dev = wrapper_device(kern)
        split_dev = wrapper_device(split)["kernel_device_ms"]
        parts = graph_launch_ms(kern, len(POST_FF_LAUNCHES), "block_gemm")
        split_parts = graph_launch_ms(split, len(SPLIT_PAIR_LAUNCHES),
                                      "block_gemm")
        host, split_host = host_us(kern), host_us(split)
        plan = bk.ff_plan(c, 4 * c, rows=r,
                          capacity=bk.ff_capacity(got.device.index))
        # the FF launch alone through its C entry, and post_cross's three
        # (the profiler has missed launches in a long run): device ms
        y = torch.empty_like(xm)
        ff_bare = [a.data_ptr() for a in [xm] + args[11:] + [y]] + [
            r, c, 4 * c, *plan.args]
        lib = _build.load()
        ff_ms = graph_ms(lambda keep=(xm, y): lib.rdm_ff(
            *ff_bare, torch.cuda.current_stream().cuda_stream))
        pc_ms = graph_ms(lambda: bk.post_cross(*args[:11], **kw))
        bound_ms, by = bound(*block_cost("post_ff", c, s))
        say("post_ff", f"C={c:4d} S={s:4d} heads={heads:2d}: max|err| "
            f"{err:.4g}, /max|ref| {rel:.3e} (limit {KERNEL_TOL:g}); against "
            f"the split pair's kernels max|err| {pair_err:.4g} (/max "
            f"{pair_rel:.3e}, limit {KERNEL_TOL:g})"
            f"{' (bit-equal)' if torch.equal(got, pair) else ''}; xm "
            f"bit-equal to post_cross's, two calls bit-equal; kernel "
            f"{ms:.4f} ms (device {dev['kernel_device_ms']:.4f}), split pair "
            f"{split_ms:.4f} ms (device {split_dev:.4f}), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
        say("post_ff", f"  launches (device ms, CUDA graph) "
            f"{_launch_text(POST_FF_LAUNCHES, parts)}; split pair "
            f"{_launch_text(SPLIT_PAIR_LAUNCHES, split_parts)}; apart in "
            f"CUDA graphs: post_cross's three {pc_ms:.4f} ms, the FF "
            f"launch {ff_ms:.4f} ms; host {host:.1f} us a call (split pair "
            f"{split_host:.1f}); FF plan {plan.ranks} ranks a cluster, "
            f"{plan.stages} stages, {plan.round_units} units a round, "
            f"{plan.smem} bytes")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["split_ms"] += split_ms
        res["sites"].append({
            "C": c, "S": s, "heads": heads, "max_abs_err": err,
            "rel_err": rel, "split_pair_max_abs_err": pair_err, "ms": ms,
            "split_ms": split_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "split_device_ms": split_dev, **dev,
            "launches_device_ms": parts and dict(zip(POST_FF_LAUNCHES,
                                                     parts)),
            "split_launches_device_ms": split_parts and dict(
                zip(SPLIT_PAIR_LAUNCHES, split_parts)),
            "host_us": host, "split_host_us": split_host,
            "post_cross_device_ms": pc_ms, "ff_launch_device_ms": ff_ms,
            "ff_plan": plan._asdict()})
        del t, q, k, v, attn, args, got, pair, xm, xm_pair, again, y
    _sum_bound(res, [block_cost("post_ff", c, s) for c, s, _ in SITES])
    for key in ("kernel_device_ms", "split_device_ms",
                "ff_launch_device_ms"):
        res[key] = sum(x[key] for x in res["sites"])
    torch.cuda.empty_cache()

    # the full-width U-Net and requests through it
    batch, steps = 4, SERVE_STEPS
    pipe = RDMPipeline(RDMConfig.imagenet(), rdm_sd,
                       AutoencoderConfig.vq_f4(), vq_sd,
                       pool=DataPool(embeddings=emb), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    x = torch.randn(1, 3, 64, 64, generator=gen, device="cuda")
    tt = torch.tensor([501], device="cuda")
    ctx = torch.randn(2, CONTEXT, 512, generator=gen,
                      device="cuda").bfloat16()
    queries = torch.randn(batch, 512, generator=gen, device="cuda")
    outs, walls, images = {}, {"1": [], "0": []}, {}
    for split in ("1", "0"):
        os.environ["RDM_TPU_SPLIT_K3"] = split
        bk.reset_launch_counts()
        with torch.inference_mode():
            outs[split] = pipe.model.unet(x, tt, ctx).float()
        counts = bk.launch_counts()
        single = split == "0"
        if (counts["post_ff"], counts["post_cross"], counts["geglu_ff"]) != \
                ((16, 0, 0) if single else (0, 16, 16)):
            raise RuntimeError(f"U-Net forward, RDM_TPU_SPLIT_K3={split}: "
                               f"launches {counts}")
        # the core's launches underneath: ln_qkv's one and post_cross's
        # three a block, then post_ff's FF launch or geglu_ff's two
        core = _core_launches(lambda: pipe.model.unet(x, tt, ctx))
        if core != ((64, 16) if single else (96, 0)):
            raise RuntimeError(f"U-Net forward, RDM_TPU_SPLIT_K3={split}: "
                               f"block_gemm_kernel / block_gemm_ff_kernel "
                               f"launches {core}")
        res.setdefault("forward_core_launches", {})[split] = core
    if not torch.isfinite(outs["0"]).all():
        raise RuntimeError("RDM_TPU_SPLIT_K3=0 forward not finite")
    rel = ((outs["0"] - outs["1"]).norm() / outs["1"].norm()).item()
    say("post_ff", f"ImageNet U-Net forward, x [1,3,64,64] + context "
        f"[2,4,512], CUDA bf16: RDM_TPU_SPLIT_K3=0 vs the split forward rel "
        f"L2 {rel:.3e} (limit {FORWARD_TOL:g})"
        f"{'; bit-equal' if torch.equal(outs['0'], outs['1']) else ''}; "
        f"block_gemm_kernel / block_gemm_ff_kernel launches a forward "
        f"{res['forward_core_launches']}")
    if not rel <= FORWARD_TOL:
        raise RuntimeError(f"RDM_TPU_SPLIT_K3=0 forward rel error {rel}")
    launches = 0
    for split in ("0", "1", "0", "0", "1"):  # the first one warms up
        os.environ["RDM_TPU_SPLIT_K3"] = split
        bk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.sample_with_query(queries, k_nn=4, steps=steps,
                                     guidance_scale=2.0, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = bk.launch_counts()
        n = 16 * steps
        want = dict.fromkeys(counts, 0)
        want.update(ln_qkv=n, packed_attn=n)
        if split == "0":
            want.update(post_ff=n)
        else:
            want.update(post_cross=n, geglu_ff=n)
        if counts != want:
            raise RuntimeError(f"RDM_TPU_SPLIT_K3={split} request: launches "
                               f"{counts} != {want}")
        img = out["query_samples"]
        if img.shape != (batch, 256, 256, 3) or img.std() == 0:
            raise RuntimeError(f"RDM_TPU_SPLIT_K3={split}: images "
                               f"{img.shape}, std {img.std()}")
        if split in images or split == "1":
            walls[split].append(wall)
            if split == "0":
                launches += counts["post_ff"]
        images[split] = img
        say("post_ff", f"request, RDM_TPU_SPLIT_K3={split}: batch {batch}, "
            f"DDIM-{steps}, guidance 2.0, k=4: {wall:.3f} s, "
            f"{batch / wall:.3f} img/s; launches {counts}")
    os.environ.pop("RDM_TPU_SPLIT_K3")
    diff = np.abs(images["0"].astype(np.int32) - images["1"].astype(np.int32))
    say("post_ff", f"post_ff vs split pair: request latency "
        f"{walls['0']} vs {walls['1']} s; images differ in "
        f"{(diff > 0).mean():.3e} of pixels, max {diff.max()} levels")
    res.update(launches=launches, request_s={"single": walls["0"],
                                             "split": walls["1"]},
               forward_rel_l2=rel)
    del pipe
    torch.cuda.empty_cache()
    return res


def _launch_text(names, parts) -> str:
    return ("not seen by the profiler" if parts is None else ", ".join(
        f"{k} {v:.4f}" for k, v in zip(names, parts)))


def _core_launches(fn) -> tuple:
    """(block_gemm_kernel, block_gemm_ff_kernel) launches of one fn() call
    under inference mode, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return (sum("block_gemm_kernel" in n for n in names),
            sum("block_gemm_ff_kernel" in n for n in names))


def flash_cost(name: str, b: int, s: int, h: int, d: int, causal: bool):
    """(bf16 operations, int8 operations, bytes) of one flash kernel call:
    the TPU cost estimates' 4 (forward) and 10 (backward) x B H S^2 d,
    halved under causal (the kernels skip the masked tiles); q, k, v (+ dO)
    read once, o (dq, dk, dv) written once, bf16."""
    ops = (4 if name == "flash_fwd" else 10) * b * h * s * s * d
    tensors = 4 if name == "flash_fwd" else 7
    return ops / (2 if causal else 1), 0, tensors * b * s * h * d * 2


def phase_flash_kernels() -> dict:
    """Phase 15: the flash forward and backward kernels against their plain
    versions at the training shapes; per kernel {'max_abs_err', 'ms',
    'plain_ms', 'library_ms', 'bound_ms', 'bound_by', 'cases'} (times
    summed over the shapes) and the eager-recompute backward beside the
    kernel."""
    import torch.nn.functional as F

    from rdm_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 50)
    res = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "cases": []} for n in FLASH_INFO}
    for b, s, h, d, causal in FLASH_SHAPES:
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                       .bfloat16() for _ in range(4))
        sc = d ** -0.5
        qkv_t = [a.transpose(1, 2).contiguous() for a in (q, k, v)]
        do_t = do.transpose(1, 2).contiguous()

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*qkv_t, is_causal=causal)

        lib_in = [a.detach().requires_grad_() for a in qkv_t]

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(*lib_in, is_causal=causal)
            return torch.autograd.grad(out, lib_in, do_t)

        def eager_bwd():  # the backward under RDM_TPU_FLASH_BWD=xla
            with torch.enable_grad():
                qq = [a.detach().requires_grad_() for a in (q, k, v)]
                out = fa._xla_reference(*qq, sc, causal)
                return torch.autograd.grad(out, qq, do)

        calls = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale=sc,
                                               causal=causal),
                          lambda: fa.flash_attention_forward_reference(
                              q, k, v, sc, causal), sdpa_fwd),
            "flash_bwd": (lambda: fa.flash_bwd(q, k, v, do, scale=sc,
                                               causal=causal),
                          lambda: fa.flash_attention_backward_reference(
                              q, k, v, do, sc, causal), sdpa_fwd_bwd),
        }
        for name, (kern, plain, library) in calls.items():
            got = kern()
            torch.cuda.synchronize()
            outs = got if isinstance(got, tuple) else (got,)
            labels = ("dq", "dk", "dv") if name == "flash_bwd" else ("o",)
            held = _hold(f"{name} [{b},{s},{h},{d}] causal={causal}",
                         list(zip(labels, outs, _as_tuple(plain()))))
            err = max(e for _, e, _ in held)
            ms, plain_ms, lib_ms = (median_ms(fn) for fn in
                                    (kern, plain, library))
            bound_ms, by = bound(*flash_cost(name, b, s, h, d, causal))
            case = {"B": b, "S": s, "heads": h, "head_dim": d,
                    "causal": causal, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound_ms,
                    "bound_by": by,
                    "rel_err": {lab: rel for lab, _, rel in held}}
            case["device_ms"] = graph_ms(kern)
            case["library_device_ms"] = graph_ms(library)
            # one ex2 per visible score: the forward's floor, and the least
            # any backward that saves no P can do
            case["exp2_floor_ms"] = exp2_floor_ms(
                b * h * s * s / (2 if causal else 1))
            if name == "flash_bwd":
                case["eager_bwd_ms"] = median_ms(eager_bwd)
                case["host_us"] = host_us(kern)
                case["launch_device_ms"] = kernel_device_ms(kern)
                if not all(torch.equal(a, b_) for a, b_ in zip(kern(), outs)):
                    raise RuntimeError(f"flash_bwd [{b},{s},{h},{d}]: two "
                                       "calls differ (it has no atomics)")
            say("flash_kernels", f"{name} [{b},{s},{h},{d}] causal="
                f"{causal}: /max|ref| " + ", ".join(
                    f"{lab} {rel:.3e}" for lab, _, rel in held)
                + f" (limit {KERNEL_TOL:g}); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, SDPA {'fwd+bwd ' if name == 'flash_bwd' else ''}"
                f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})"
                + f"; device {case['device_ms']:.4f} ms (SDPA "
                f"{'fwd+bwd ' if name == 'flash_bwd' else ''}"
                f"{case['library_device_ms']:.4f}), exp2 floor "
                f"{case['exp2_floor_ms']:.4f} ms"
                + (f"; eager-recompute backward {case['eager_bwd_ms']:.4f} "
                   f"ms; host per call {case['host_us']:.1f} us; by launch "
                   + ", ".join(f"{n} {t:.4f}" for n, t in
                               case["launch_device_ms"].items())
                   + " ms; two calls bit-equal"
                   if name == "flash_bwd" else ""))
            r = res[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["library_ms"] += lib_ms
            r["cases"].append(case)
            del got, outs
        del q, k, v, do, qkv_t, do_t, lib_in
        torch.cuda.empty_cache()
    for name, r in res.items():
        _sum_bound(r, [flash_cost(name, *shape) for shape in FLASH_SHAPES])
    return res


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _train_batches(emb: torch.Tensor, batch: int, seed: int):
    """Endless batches made on the card: random 256^2 images in [-1, 1]
    (NHWC) and neighbours [B, 1, 4, 512] gathered from the table."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    while True:
        ids = torch.randint(0, emb.shape[0], (batch * CONTEXT,), generator=g,
                            device="cuda")
        yield {"image": torch.rand(batch, 256, 256, 3, generator=g,
                                   device="cuda") * 2 - 1,
               "nn_embeddings": emb[ids].reshape(batch, 1, CONTEXT, 512)}


class _Take:
    """The first n items of an endless iterator, again on each pass."""

    def __init__(self, it, n: int):
        self.it, self.n = it, n

    def __iter__(self):
        for _ in range(self.n):
            yield next(self.it)


def phase_train(rdm_sd: dict, vq_sd: dict, emb: torch.Tensor) -> dict:
    """Phase 16: RDMTrainer at the full ImageNet RDM width; returns the
    flash kernels' launches over the first trainer's steps and the step
    numbers."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from rdm_tpu_torch.config import AutoencoderConfig, RDMConfig
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.ops import flash_attention as fa
    from rdm_tpu_torch.training.train_state import compute_grads, fold_in
    from rdm_tpu_torch.training.trainer import RDMTrainer, TrainerConfig

    cfg = dataclasses.replace(RDMConfig.imagenet(), p_uncond=0.1)
    batch = TRAIN_BATCH
    tmp = tempfile.mkdtemp(prefix="rdm_train_smoke_")
    per_step, step_s = [], []

    def make(max_steps: int):
        tcfg = TrainerConfig(
            logdir=os.path.join(tmp, "run"), base_lr=1e-4,
            max_steps=max_steps, log_every=1, ckpt_every=4,
            image_log_every=0, max_ckpts=1, val_batches=1,
            adam_mu_dtype="bfloat16")
        tr = RDMTrainer(cfg, tcfg, AutoencoderConfig.vq_f4(), vq_sd,
                        batch_size=batch, device="cuda",
                        init_state_dict=rdm_sd)
        inner = tr.step_fn

        def counted(state, z, nns, seed, **draws):
            fa.reset_launch_counts()
            bk.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(state, z, nns, seed, **draws)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append({**fa.launch_counts(), **bk.launch_counts()})
            m = out[1]
            if not (torch.isfinite(m["loss"]) and torch.isfinite(
                    m["grad_norm"])):
                raise RuntimeError(f"train step: non-finite metrics {m}")
            return out

        tr.step_fn = counted
        return tr

    def check_counts(steps, fwd, bwd, what, blocks=0):
        for c in steps:
            want = dict.fromkeys(c, 0)
            want.update(flash_fwd=fwd, flash_bwd=bwd)
            want.update(dict.fromkeys(FUSED_TRAIN_KERNELS, blocks))
            if c != want:
                raise RuntimeError(f"{what}: launches per step {c}, "
                                   f"expected {want}")

    try:
        batches = _train_batches(emb, batch, SEED + 60)
        torch.cuda.reset_peak_memory_stats()
        tr1 = make(TRAIN_STEPS)
        saved, save = [], tr1.ckpt.save
        tr1.ckpt.save = lambda step, *a, **k: (saved.append(step),
                                               save(step, *a, **k))
        t0 = time.perf_counter()
        state1 = tr1.fit(_Take(batches, TRAIN_STEPS),
                         val_loader=_Take(batches, 1))
        fit_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check_counts(per_step, FLASH_PER_STEP, FLASH_PER_STEP, "fit")
        launches = {n: sum(c[n] for c in per_step) for n in FLASH_INFO}
        missing = [n for n, p in state1.model.named_parameters()
                   if p.grad is None]
        if missing or state1.step != TRAIN_STEPS:
            raise RuntimeError(f"step {state1.step}; parameters without a "
                               f"gradient: {missing[:5]} ({len(missing)})")
        if saved != [5, TRAIN_STEPS]:  # mid-way (loop step 4) and the end
            raise RuntimeError(f"checkpoints saved at steps {saved}")
        n_params = sum(p.numel() for p in state1.model.parameters())
        ckpts = tr1.ckpt.steps()
        times = step_s[1:TRAIN_STEPS]
        med = float(np.median(times))
        say("train", f"ImageNet RDM ({n_params / 1e6:.1f}M parameters, "
            f"VQ-f4 first stage), batch {batch}, p_uncond 0.1, bf16 compute "
            f"/ f32 master weights, lr {tr1.lr:.2e}: {TRAIN_STEPS} steps in "
            f"{fit_s:.1f} s (fit, checkpoints and validation included); "
            f"step {med * 1e3:.1f} ms median after the first ({step_s[0]:.2f}"
            f" s), {batch / med:.2f} samples/s; peak device memory "
            f"{peak_gib:.2f} GiB; {FLASH_PER_STEP} flash_fwd + "
            f"{FLASH_PER_STEP} flash_bwd launches per step, no block kernel;"
            f" every parameter has a gradient; checkpoints saved at steps "
            f"{saved}, kept {ckpts}")

        # resume: equal to the saved state, then continue
        tr2 = make(TRAIN_STEPS + 2)
        state2 = tr2.resume_or_init()
        a, b_ = state1.state_dict(), state2.state_dict()
        same = (a["step"] == b_["step"]
                and a["ema"]["count"] == b_["ema"]["count"]
                and a["opt_state"]["count"] == b_["opt_state"]["count"]
                and all(torch.equal(a["params"][n], b_["params"][n])
                        for n in a["params"])
                and all(torch.equal(a["opt_state"][m][n],
                                    b_["opt_state"][m][n])
                        for m in ("mu", "nu") for n in a["opt_state"][m])
                and all(torch.equal(a["ema"]["params"][n],
                                    b_["ema"]["params"][n])
                        for n in a["ema"]["params"]))
        if not same:
            raise RuntimeError("resumed state differs from the saved one")
        del a, b_, state1, tr1
        torch.cuda.empty_cache()
        per_step.clear()
        state2 = tr2.fit(_Take(batches, 2), state=state2)
        check_counts(per_step, FLASH_PER_STEP, FLASH_PER_STEP, "resumed fit")
        say("train", f"resumed at step {TRAIN_STEPS}: step counter, "
            f"parameters, Adam moments and EMA equal the saved ones; "
            f"continued to step {state2.step}")

        # the eager-recompute backward (RDM_TPU_FLASH_BWD=xla)
        os.environ["RDM_TPU_FLASH_BWD"] = "xla"
        per_step.clear()
        step_s.clear()
        for _ in range(3):
            z, nns = tr2.prepare_batch(next(batches))
            state2, _ = tr2.step_fn(state2, z, nns, 1)
        os.environ.pop("RDM_TPU_FLASH_BWD")
        check_counts(per_step, FLASH_PER_STEP, 0, "RDM_TPU_FLASH_BWD=xla")
        xla_med = float(np.median(step_s[1:]))
        say("train", f"RDM_TPU_FLASH_BWD=xla (eager-recompute backward): "
            f"step {xla_med * 1e3:.1f} ms median of the last two, "
            f"{batch / xla_med:.2f} samples/s, against {med * 1e3:.1f} ms "
            f"with the backward kernel")

        # the fused blocks in training (RDM_TPU_FUSED_BLOCK_TRAIN=1, off by
        # default): context only, beside the unfused steps above
        os.environ["RDM_TPU_FUSED_BLOCK_TRAIN"] = "1"
        per_step.clear()
        step_s.clear()
        torch.cuda.reset_peak_memory_stats()
        tr2.ckpt.save = lambda *a, **k: None  # nothing reads these
        state2 = tr2.fit(_Take(batches, FUSED_TRAIN_STEPS), state=state2,
                         max_steps=state2.step + FUSED_TRAIN_STEPS)
        fused_peak = torch.cuda.max_memory_allocated() / 2**30
        os.environ.pop("RDM_TPU_FUSED_BLOCK_TRAIN")
        check_counts(per_step, 0, 0, "RDM_TPU_FUSED_BLOCK_TRAIN=1",
                     blocks=FUSED_PER_STEP)
        fused_launches = {n: sum(c[n] for c in per_step)
                          for n in FUSED_TRAIN_KERNELS}
        fused_ms = [t * 1e3 for t in step_s]
        say("train", f"RDM_TPU_FUSED_BLOCK_TRAIN=1: {FUSED_TRAIN_STEPS} steps "
            f"of fit at batch {batch}, {FUSED_PER_STEP} launches of each of "
            f"{', '.join(FUSED_TRAIN_KERNELS)} per step (the U-Net's 16 "
            "blocks), no flash_fwd / flash_bwd (the blocks are the U-Net's "
            "only attention sites); step " + " / ".join(
                f"{t:.1f}" for t in fused_ms) + f" ms against the unfused "
            f"{med * 1e3:.1f} ms median; peak device memory "
            f"{fused_peak:.2f} GiB (the unfused fit's {peak_gib:.2f})")

        # one batch-2 step, the bf16 kernel paths (unfused blocks, fused
        # blocks) against the CUDA f32 plain path on the same draws
        model = state2.model
        z, nns = tr2.prepare_batch(next(_train_batches(emb, 2, SEED + 61)))
        z = z.float()
        grads, losses = {}, {}
        for path in ("bf16", "fused", "f32"):
            if path == "fused":
                os.environ["RDM_TPU_FUSED_BLOCK_TRAIN"] = "1"
            if path == "f32":
                os.environ["RDM_TPU_FLASH"] = "0"
                model.unet.dtype = torch.float32
            fa.reset_launch_counts()
            bk.reset_launch_counts()
            loss, _, g = compute_grads(model, z, nns,
                                       fold_in(SEED, 0, "cuda"), tr2.schedule)
            os.environ.pop("RDM_TPU_FUSED_BLOCK_TRAIN", None)
            counts = {**fa.launch_counts(), **bk.launch_counts()}
            want = dict.fromkeys(counts, 0)
            if path == "bf16":
                want.update(flash_fwd=FLASH_PER_STEP,
                            flash_bwd=FLASH_PER_STEP)
            if path == "fused":
                want.update(dict.fromkeys(FUSED_TRAIN_KERNELS,
                                          FUSED_PER_STEP))
            if counts != want:
                raise RuntimeError(f"{path} step: launches {counts}")
            losses[path] = loss.item()
            grads[path] = torch.cat([
                (torch.zeros_like(p) if g[n] is None else g[n]).reshape(-1)
                .float() for n, p in model.named_parameters()])
        os.environ.pop("RDM_TPU_FLASH")
        model.unet.dtype = torch.bfloat16
        gf = grads["f32"]
        rels, loss_rels = {}, {}
        for path in ("bf16", "fused"):
            gb = grads[path]
            rels[path] = ((gb - gf).norm() / gf.norm()).item()
            loss_rels[path] = (abs(losses[path] - losses["f32"])
                               / abs(losses["f32"]))
            say("train", f"batch-2 step, bf16 kernel path "
                f"({'fused blocks' if path == 'fused' else 'unfused blocks'})"
                f" vs CUDA f32 plain path (RDM_TPU_FLASH=0), same draws: "
                f"loss {losses[path]:.6f} vs {losses['f32']:.6f} (rel "
                f"{loss_rels[path]:.3e}); gradients rel L2 {rels[path]:.3e} "
                f"(limit {TRAIN_GRAD_TOL:g}), cosine "
                f"{torch.nn.functional.cosine_similarity(gb, gf, dim=0).item():.6f}")
            if not (rels[path] <= TRAIN_GRAD_TOL
                    and torch.isfinite(gb).all()):
                raise RuntimeError(f"{path} gradients rel L2 {rels[path]} > "
                                   f"{TRAIN_GRAD_TOL}")
        return {"launches": launches, "step_ms": med * 1e3,
                "samples_per_s": batch / med, "xla_bwd_step_ms":
                xla_med * 1e3, "peak_gib": peak_gib,
                "grad_rel_l2": rels["bf16"], "loss_rel": loss_rels["bf16"],
                "batch": batch, "fused_launches": fused_launches,
                "fused_step_ms": fused_ms, "fused_peak_gib": fused_peak,
                "fused_grad_rel_l2": rels["fused"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def knn_cost(b: int, n: int, d: int, k: int):
    """(bf16 operations, int8 operations, bytes) of one search: 2 B N D
    products; the table and the queries read once (bf16), scores (f32)
    and ids (int64) written once."""
    return 2 * b * n * d, 0, n * d * 2 + b * d * 2 + b * k * 12


def _knn_hold(what: str, got, plain, n: int) -> int:
    """Holds a kernel search against the plain one (computed with k + 1
    columns where the table has them, so that a near tie at the last rank
    shows): scores within KNN_SCORE_TOL, ids in [0, n), ids equal except
    at near-tie ranks; returns the count of near-tie ranks whose ids
    differ."""
    gs, gi = got
    ps, pi = plain
    k = gs.shape[1]
    if gi.min().item() < 0 or gi.max().item() >= n:
        raise RuntimeError(f"{what}: an id outside [0, {n}) came back")
    err = (gs - ps[:, :k]).abs().max().item()
    if err > KNN_SCORE_TOL:
        raise RuntimeError(f"{what}: scores {err:.3e} from the plain "
                           f"version (limit {KNN_SCORE_TOL:g})")
    near_pair = (ps[:, :-1] - ps[:, 1:]).abs() <= KNN_NEAR_TIE
    near = torch.zeros_like(ps, dtype=torch.bool)
    near[:, :-1] |= near_pair
    near[:, 1:] |= near_pair
    diff = gi != pi[:, :k]
    if (diff & ~near[:, :k]).any():
        raise RuntimeError(f"{what}: ids differ from the plain version "
                           "away from any near tie")
    return int((diff & near[:, :k]).sum().item())


def _knn_launch_ms(db: torch.Tensor, q: torch.Tensor, k: int) -> dict:
    """Device ms of knn_topk's two launches apart, each through its bare
    launcher in a CUDA graph, on the wrapper's plan and buffers."""
    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.ops import knn_kernel as kk

    (n, d), b = db.shape, q.shape[0]
    p = kk.device_plan(b, n, d, k, 0)
    lib = _build.load()
    qb = q.to(torch.bfloat16).contiguous()
    part_s = torch.empty((b, p.n_slices, k), device="cuda")
    part_i = torch.empty((b, p.n_slices, k), dtype=torch.int32,
                         device="cuda")
    out_s = torch.empty((b, k), device="cuda")
    out_i = torch.empty((b, k), dtype=torch.int64, device="cuda")

    def search():
        return lib.rdm_knn_search(
            qb.data_ptr(), db.data_ptr(), part_s.data_ptr(),
            part_i.data_ptr(), b, n, d, k, p.queries, p.cluster, p.groups,
            p.slice_rows, p.n_slices, p.stages,
            torch.cuda.current_stream().cuda_stream)

    def merge():
        return lib.rdm_knn_merge(
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), b, p.n_slices * k, p.merge_pad, k,
            torch.cuda.current_stream().cuda_stream)

    _build.check(search(), "knn_search")
    _build.check(merge(), "knn_merge")
    return {"knn_search": graph_ms(search), "knn_merge": graph_ms(merge)}


def phase_knn(emb: torch.Tensor) -> dict:
    """Phase 17: the kNN kernel pair against its plain version over the
    1,281,280 x 512 table in bf16 at KNN_CASES, a ragged N, duplicate rows
    in different slices and a 10-row table whose top k holds negative
    scores; {'max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
    'bound_by'} of the op point and every case under 'cases'."""
    from rdm_tpu_torch.ops import knn_kernel as kk
    from rdm_tpu_torch.retrieval.engine import knn_search, l2_normalize

    db = emb.to(torch.bfloat16)
    n, d = db.shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 60)
    cases, near_total, worst = [], 0, 0.0
    for b, k in KNN_CASES:
        q = l2_normalize(torch.randn(b, d, generator=g, device="cuda"))
        got = knn_search(db, q, k)
        plain = knn_search(db, q, k + 1, impl="reference")
        torch.cuda.synchronize()
        near = _knn_hold(f"B={b} k={k}", got, plain, n)
        near_total += near
        err = (got[0] - plain[0][:, :k]).abs().max().item()
        worst = max(worst, err)
        qb = q.to(torch.bfloat16)
        kernel = functools.partial(kk.knn_topk, db, q, k)

        def library():
            return torch.topk(qb @ db.t(), k)

        ms, plain_ms, lib_ms = (median_ms(fn) for fn in (
            kernel, lambda: knn_search(db, q, k, impl="reference"),
            library))
        dev_ms, lib_dev_ms = graph_ms(kernel), graph_ms(library)
        per_launch = _knn_launch_ms(db, q, k)
        us = host_us(kernel)
        bound_ms, by = bound(*knn_cost(b, n, d, k))
        p = kk.device_plan(b, n, d, k, 0)
        read_gb = p.groups * n * d * 2 / 1e9  # one pass per query group
        cases.append({"B": b, "k": k, "N": n, "D": d, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
                      "launch_device_ms": per_launch, "host_us": us,
                      "table_read_gb": read_gb,
                      "bound_ms": bound_ms, "bound_by": by,
                      "max_abs_err": err, "near_tie_ranks": near,
                      "slices": p.n_slices, "slice_rows": p.slice_rows,
                      "queries": p.queries, "cluster": p.cluster,
                      "groups": p.groups, "stages": p.stages})
        launches_txt = ", ".join(f"{name} {t:.4f}"
                                 for name, t in per_launch.items())
        say("knn", f"B={b:3d} k={k:2d} over {n}x{d}: scores max|err| "
            f"{err:.3e} (limit {KNN_SCORE_TOL:g}), ids equal but {near} "
            f"near-tie ranks; {p.groups} group(s) of {p.cluster} x "
            f"{p.queries} queries, {p.n_slices} stripes of {p.slice_rows} "
            f"rows, {p.stages} stages, table read {read_gb:.3f} GB; device "
            f"{dev_ms:.4f} ms ({launches_txt}) against torch.topk(q @ "
            f"db.T) {lib_dev_ms:.4f} ms; host {us:.1f} us a call; event "
            f"kernel {ms:.4f} ms, plain sort {plain_ms:.4f} ms, topk "
            f"{lib_ms:.4f} ms (two calls, no tie order); bound "
            f"{bound_ms:.4f} ms ({by})")

    # a ragged N: the first n - 1 rows
    q = l2_normalize(torch.randn(16, d, generator=g, device="cuda"))
    got = knn_search(db[:n - 1], q, 4)
    near_total += _knn_hold("ragged N", got,
                            knn_search(db[:n - 1], q, 5, impl="reference"),
                            n - 1)
    # duplicate rows in four stripes of the B = 16 split, and a query
    # equal to them: their ids must come back in ascending order
    p = kk.device_plan(16, n, d, 4, 0)
    dup = torch.tensor([1000, 1000 + p.slice_rows + 7,
                        1000 + 9 * p.slice_rows + 3, n - 5], device="cuda")
    saved = db[dup].clone()
    db[dup] = db[dup[0]].clone()
    q[0] = db[dup[0]].float()
    got = knn_search(db, q, 4)
    near_total += _knn_hold("duplicates", got,
                            knn_search(db, q, 5, impl="reference"), n)
    if got[1][0].tolist() != dup.tolist():
        raise RuntimeError(f"duplicate rows came back as {got[1][0]}, "
                           f"want {dup.tolist()} in ascending order")
    db[dup] = saved
    # the reference's padding fault: 10 rows, negative scores in the top 8
    small = l2_normalize(torch.randn(10, d, generator=g, device="cuda")
                         ).to(torch.bfloat16)
    q = l2_normalize(torch.randn(4, d, generator=g, device="cuda"))
    got = knn_search(small, q, 8)
    want = knn_search(small, q, 8, impl="reference")
    if not torch.equal(got[1], want[1]) or (got[0] >= 0).all():
        raise RuntimeError(f"N=10: ids {got[1].tolist()} against "
                           f"{want[1].tolist()}, or no negative score")
    say("knn", f"ragged N={n - 1}, duplicate rows {dup.tolist()} (one per "
        f"stripe, ascending ids back), N=10 with negative scores in the top "
        f"8 (no id >= N): ids equal; near-tie ranks over all cases "
        f"{near_total}")
    del db
    torch.cuda.empty_cache()
    res = dict(next(c for c in cases if (c["B"], c["k"]) == KNN_OP_POINT))
    res.update(max_abs_err=worst, cases=cases, near_tie_ranks=near_total)
    return res


class _Recorder:
    """A retrieval engine that keeps the ids of every search it serves."""

    def __init__(self, engine):
        self.engine, self.ids = engine, []

    def search(self, queries, k, **kw):
        out = self.engine.search(queries, k, **kw)
        self.ids.append(out["nns"])
        return out


def _request(what: str, knn_want: int, fn, steps: int = SERVE_STEPS):
    """Runs one request between synchronisations with the kNN and block
    launch counts at 0; checks its knn launches (2 per search) and its
    block-kernel launches (16 per U-Net forward), and the images; returns
    (seconds, images)."""
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.ops import knn_kernel as kk

    kk.reset_launch_counts()
    bk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    knn = kk.launch_counts()["knn"]
    blocks = {n: bk.launch_counts()[n] for n in KERNEL_INFO}
    if knn != knn_want:
        raise RuntimeError(f"{what}: {knn} knn launches, want {knn_want}")
    if any(n != 16 * steps for n in blocks.values()):
        raise RuntimeError(f"{what}: block launches {blocks}, want "
                           f"{16 * steps} each")
    if images.shape != (4, 256, 256, 3) or images.dtype != np.uint8 or \
            images.std() == 0:
        raise RuntimeError(f"{what}: images {images.shape} {images.dtype} "
                           f"std {images.std()}")
    say("clip_serve", f"{what}: batch 4, DDIM-{steps}, guidance 2.0, k=4: "
        f"{wall:.3f} s, {4 / wall:.3f} img/s; knn launches {knn}, block "
        f"launches {blocks}")
    return wall, images


def phase_clip_serve(rdm_sd: dict, vq_sd: dict, emb: torch.Tensor,
                     rarm_sd: dict, vq16_sd: dict) -> dict:
    """Phase 18: a full-width ViT-B/32 CLIP (seeded) with the full-width
    RDM over phase 5's table: both towers on the card in bf16 against CPU
    f32; caption, adaptive re-retrieval and inpainting requests with their
    knn launches; the nn-memory build at k = 20; the RARM pipeline's
    caption embedding against the RDM pipeline's. Returns the knn launches
    of these runs and the request seconds."""
    from rdm_tpu_torch.config import (AutoencoderConfig, ClipConfig,
                                      RARMConfig, RDMConfig)
    from rdm_tpu_torch.models.clip import CLIP, preprocess
    from rdm_tpu_torch.models.retrievers import bind_clip
    from rdm_tpu_torch.ops import knn_kernel as kk
    from rdm_tpu_torch.pipeline import RARMPipeline, RDMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool, NNMemory
    from rdm_tpu_torch.utils.tokenizer import tokenize

    cfg = ClipConfig.vit_b32()
    with torch.device("meta"):
        meta = CLIP(cfg)
    clip_sd = seeded_state_dict(meta, SEED + 70)
    g = torch.Generator().manual_seed(SEED + 71)
    images = torch.rand(4, 256, 256, 3, generator=g) * 2 - 1
    toks = torch.from_numpy(tokenize(SMOKE_CAPTIONS)).long()
    cpu = CLIP(cfg).eval()
    cpu.load_state_dict(clip_sd)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = (cpu.encode_image(preprocess(images).permute(0, 3, 1, 2)),
                cpu.encode_text(toks))
    cpu_s = time.perf_counter() - t0
    del cpu
    gpu = bind_clip(clip_sd, cfg, "cuda", torch.bfloat16)
    with torch.inference_mode():
        got = (gpu.encode_image(preprocess(images.cuda()).permute(0, 3, 1, 2)),
               gpu.encode_text(toks.cuda()))
    rels = [((a.cpu() - b).norm() / b.norm()).item()
            for a, b in zip(got, want)]
    say("clip_serve", f"ViT-B/32 CLIP towers, CUDA bf16 vs CPU f32 (4 "
        f"images 256 -> 224, 4 captions): rel L2 image {rels[0]:.3e}, text "
        f"{rels[1]:.3e} (limit {CLIP_TOWER_TOL:g}); CPU f32 {cpu_s:.1f} s")
    if max(rels) > CLIP_TOWER_TOL or not all(
            torch.isfinite(a).all() for a in got):
        raise RuntimeError(f"CLIP towers: rel L2 {rels}")
    del gpu

    t0 = time.perf_counter()
    pipe = RDMPipeline(RDMConfig.imagenet(), rdm_sd,
                       AutoencoderConfig.vq_f4(), vq_sd,
                       pool=DataPool(embeddings=emb), clip_params=clip_sd,
                       clip_config=cfg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    caption, kw = SMOKE_CAPTIONS[0], dict(k_nn=4, guidance_scale=2.0)
    mask = np.zeros((4, 64, 64, 1), np.float32)
    mask[:, :, :32] = 1.0  # keep the left half
    # warm-up at the request shapes; the first inpaint binds the encoder
    pipe.sample_with_caption(caption, 4, steps=2, seed=99, **kw)
    t0 = time.perf_counter()
    pipe.sample_inpaint(images.numpy(), mask, steps=2, seed=99, **kw)
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    out = {"request_s": {}, "launches": 0}
    for name, knn_want, fn in (
            ("sample_with_caption", 2, lambda: pipe.sample_with_caption(
                caption, 4, steps=SERVE_STEPS, seed=1, **kw)[
                    "query_samples"]),
            ("sample_retro_adaptive", 2 * (1 + (SERVE_STEPS - 1) // 10),
             lambda: pipe.sample_retro_adaptive(
                 4, steps=SERVE_STEPS, retro_every=10, seed=2, **kw)[
                     "retro_adaptive_samples"]),
            ("sample_inpaint", 2, lambda: pipe.sample_inpaint(
                images.numpy(), mask, steps=SERVE_STEPS, seed=3, **kw)[
                    "inpaint_samples"])):
        wall, _ = _request(name, knn_want, fn)
        out["request_s"][name] = wall
        out["launches"] += knn_want
    say("clip_serve", f"the first inpaint request (DDIM-2) bound the VQ "
        f"encoder: {bind_s:.2f} s; pipeline set-up {setup_s:.1f} s")

    # the nn-memory build: 4096 table rows as queries, k = 20, batch 256
    n_q, k_mem = 4096, 20
    rec = _Recorder(pipe.retrieval)
    kk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mem = NNMemory.build_from_queries(rec, emb[:n_q], k=k_mem,
                                      batch_size=256)
    build_s = time.perf_counter() - t0
    launches = kk.launch_counts()["knn"]
    if launches != 2 * n_q // 256:
        raise RuntimeError(f"nn-memory build: {launches} knn launches, "
                           f"want {2 * n_q // 256}")
    ids = torch.cat(rec.ids)
    own = torch.arange(n_q, device=ids.device)
    off = (ids[:, 0] != own).nonzero().flatten()
    table = pipe.retrieval.db_norm
    if off.numel() and not torch.equal(table[ids[off, 0]], table[own[off]]):
        raise RuntimeError(f"nn-memory build: top-1 of {off.numel()} "
                           "queries is neither the query nor a duplicate")
    if sum(mem.id_count.values()) != n_q * k_mem:
        raise RuntimeError("nn-memory build: counts do not sum to "
                           f"{n_q * k_mem}")
    out["launches"] += launches
    out["memory_build_s"] = build_s
    say("clip_serve", f"NNMemory.build_from_queries: {n_q} table rows as "
        f"queries, k={k_mem}, batch 256: {build_s:.3f} s, {launches} knn "
        f"launches, top-1 the query's own id for all but {off.numel()} "
        f"(duplicate rows), {len(mem.ids)} distinct ids")

    rarm = RARMPipeline(RARMConfig.imagenet_dogs(), rarm_sd,
                        AutoencoderConfig.vq_f16(), vq16_sd,
                        clip_params=clip_sd, clip_config=cfg, device="cuda")
    a, b = rarm.embed_caption(caption, 4), pipe.embed_caption(caption, 4)
    if not torch.equal(a, b):
        raise RuntimeError("RARMPipeline.embed_caption differs from "
                           "RDMPipeline's on the same CLIP")
    say("clip_serve", "RARMPipeline.embed_caption equals RDMPipeline's bit "
        f"for bit; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pipe, rarm
    torch.cuda.empty_cache()
    return out


def _rarm_part(name: str) -> str:
    """The part of the RARM a parameter belongs to, for the gradient
    gate: each of attn1's projections, the cross-attention, the FF, the
    norms, the head and the embeddings."""
    if name.startswith("proj_out"):
        return "head"
    if not name.startswith("transformer_blocks"):
        return "embeddings"
    for key, part in ((".attn1.to_q.", "attn1.q"), (".attn1.to_k.", "attn1.k"),
                      (".attn1.to_v.", "attn1.v"),
                      (".attn1.to_out.", "attn1.out"), (".attn2.", "cross"),
                      (".ff.", "ff")):
        if key in name:
            return part
    return "norms"


def _rarm_grad_rel(model, got: torch.Tensor, want: torch.Tensor):
    """Relative L2 of flat gradients (in named_parameters' order) over all
    of them and over each `_rarm_part`."""
    parts, at = {}, 0
    for n, p in model.named_parameters():
        parts.setdefault(_rarm_part(n), []).append(slice(at, at + p.numel()))
        at += p.numel()
    by_part = {}
    for part, sl in parts.items():
        g_, w_ = (torch.cat([t[x] for x in sl]) for t in (got, want))
        by_part[part] = ((g_ - w_).norm() / w_.norm()).item()
    return ((got - want).norm() / want.norm()).item(), by_part


def phase_rarm_train(rarm_sd: dict, vq_sd: dict, emb: torch.Tensor) -> dict:
    """Phase 19: RARMTrainer at the ImageNet-dogs width; returns the flash
    kernels' launches over the first trainer's steps and the step
    numbers."""
    import os
    import shutil
    import tempfile

    from rdm_tpu_torch.config import AutoencoderConfig, RARMConfig
    from rdm_tpu_torch.ops import flash_attention as fa
    from rdm_tpu_torch.training.train_state import (compute_rarm_grads,
                                                    make_rarm_train_step)
    from rdm_tpu_torch.training.trainer import RARMTrainer, TrainerConfig

    cfg = RARMConfig.imagenet_dogs()
    batch = RARM_TRAIN_BATCH
    per_fwd = cfg.depth  # one causal self-attention a block
    kernel_bwd = fa._use_kernel_bwd(cfg.head_dim, "cuda")
    tmp = tempfile.mkdtemp(prefix="rarm_train_smoke_")
    per_step, step_s = [], []

    def make(max_steps: int):
        tcfg = TrainerConfig(
            logdir=os.path.join(tmp, "run"), base_lr=5e-6,
            accumulate_grad_batches=2, max_steps=max_steps, log_every=1,
            ckpt_every=4, image_log_every=0, max_ckpts=1, val_batches=1,
            monitor="val/loss_ema")
        tr = RARMTrainer(cfg, tcfg, AutoencoderConfig.vq_f16(), vq_sd,
                         batch_size=batch, device="cuda",
                         init_state_dict=rarm_sd)
        inner = tr.step_fn

        def counted(state, z, nns, seed, **kw):
            _reset_all_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(state, z, nns, seed, **kw)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append(_all_launch_counts())
            m = out[1]
            if not (torch.isfinite(m["loss"]) and torch.isfinite(
                    m["grad_norm"])):
                raise RuntimeError(f"RARM train step: non-finite {m}")
            return out

        tr.step_fn = counted
        return tr

    def check_counts(steps, bwd, what):
        for c in steps:
            want = dict.fromkeys(c, 0)
            want.update(flash_fwd=per_fwd, flash_bwd=bwd)
            if c != want:
                raise RuntimeError(f"{what}: launches per step {c}, "
                                   f"expected {want}")

    bwd_default = per_fwd if kernel_bwd else 0
    try:
        batches = _train_batches(emb, batch, SEED + 70)
        torch.cuda.reset_peak_memory_stats()
        tr1 = make(RARM_TRAIN_STEPS)
        saved, save = [], tr1.ckpt.save
        tr1.ckpt.save = lambda step, *a, **k: (saved.append(step),
                                               save(step, *a, **k))
        t0 = time.perf_counter()
        state1 = tr1.fit(_Take(batches, RARM_TRAIN_STEPS),
                         val_loader=_Take(batches, 1))
        fit_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check_counts(per_step, bwd_default, "fit")
        launches = {n: sum(c[n] for c in per_step) for n in FLASH_INFO}
        missing = [n for n, p in state1.model.named_parameters()
                   if p.grad is None]
        if missing or state1.step != RARM_TRAIN_STEPS:
            raise RuntimeError(f"step {state1.step}; parameters without a "
                               f"gradient: {missing[:5]} ({len(missing)})")
        if saved != [5, RARM_TRAIN_STEPS]:
            raise RuntimeError(f"checkpoints saved at steps {saved}")
        with open(os.path.join(tmp, "run", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        val = [r["val/loss_ema"] for r in rows if "val/loss_ema" in r]
        loss = [r["loss"] for r in rows if "loss" in r]
        if len(val) != 1 or not np.isfinite(val + loss).all():
            raise RuntimeError(f"validation {val}, losses {loss}")
        n_params = sum(p.numel() for p in state1.model.parameters())
        # a step's operations: 6 per matmul weight per token (the embedding
        # and positional tables are lookups), the causal self-attention's
        # 12 B S^2 C / 2 a block (forward and backward; the k cross rows
        # are left out), and the time they take at the bf16 peak
        m = state1.model
        n_mm = n_params - m.proj_in.weight.numel() \
            - m.positional_encoding.numel()
        tokens, s_ = batch * cfg.seq_len, cfg.seq_len
        step_ops = (6 * n_mm * tokens
                    + cfg.depth * 6 * batch * s_ * s_ * cfg.inner_dim)
        peak_ms = bound(ops16=step_ops)[0]
        med = float(np.median(step_s[1:]))
        say("rarm_train", f"ImageNet-dogs RARM ({n_params / 1e6:.1f}M "
            f"parameters, VQ-f16 first stage), batch {batch}, bf16 compute / "
            f"f32 master weights, lr {tr1.lr:.2e}: {RARM_TRAIN_STEPS} steps "
            f"in {fit_s:.1f} s (fit, checkpoints and validation included); "
            f"step {med * 1e3:.1f} ms median after the first "
            f"({step_s[0]:.2f} s), {batch / med:.2f} samples/s; peak device "
            f"memory {peak_gib:.2f} GiB; {step_ops / 1e12:.2f} TFLOP a "
            f"step, {peak_ms:.2f} ms at the bf16 peak; loss {loss[0]:.4f} -> "
            f"{loss[-1]:.4f}"
            f", val/loss_ema {val[0]:.4f}; {per_fwd} flash_fwd + "
            f"{bwd_default} flash_bwd launches per step (the d = 64 "
            f"backward: {'kernel' if kernel_bwd else 'eager recompute'} by "
            f"default); every parameter has a gradient; checkpoints saved at "
            f"steps {saved}")

        # resume: equal to the saved state, then continue
        tr2 = make(RARM_TRAIN_STEPS + 2)
        state2 = tr2.resume_or_init()
        a, b_ = state1.state_dict(), state2.state_dict()
        same = (a["step"] == b_["step"]
                and a["ema"]["count"] == b_["ema"]["count"]
                and a["opt_state"]["count"] == b_["opt_state"]["count"]
                and all(torch.equal(a["params"][n], b_["params"][n])
                        for n in a["params"])
                and all(torch.equal(a["opt_state"][m][n],
                                    b_["opt_state"][m][n])
                        for m in ("mu", "nu") for n in a["opt_state"][m])
                and all(torch.equal(a["ema"]["params"][n],
                                    b_["ema"]["params"][n])
                        for n in a["ema"]["params"]))
        if not same:
            raise RuntimeError("resumed RARM state differs from the saved "
                               "one")
        del a, b_, state1, tr1
        torch.cuda.empty_cache()
        per_step.clear()
        state2 = tr2.fit(_Take(batches, 2), state=state2)
        check_counts(per_step, bwd_default, "resumed fit")

        # the mask-token augmentation, one step
        aug = make_rarm_train_step(tr2.tx, ema_decay=tr2.tcfg.ema_decay,
                                   p_mask_max=RARM_P_MASK_MAX)
        z, nns = tr2.prepare_batch(next(batches))
        state2, m = aug(state2, z, nns, 1)
        if not (torch.isfinite(m["loss"]) and torch.isfinite(
                m["grad_norm"])):
            raise RuntimeError(f"p_mask_max {RARM_P_MASK_MAX} step: {m}")
        say("rarm_train", f"resumed at step {RARM_TRAIN_STEPS}: step "
            f"counter, parameters, Adam moments and EMA equal the saved "
            f"ones; continued to step {RARM_TRAIN_STEPS + 2}; one step with "
            f"p_mask_max {RARM_P_MASK_MAX}: loss {float(m['loss']):.4f}, "
            f"grad_norm {float(m['grad_norm']):.4f}")

        # the d = 64 backward: the kernel against the eager recompute, in
        # turns; each step's peak memory from a reset just before it
        ab = {"pallas": [], "xla": []}
        peaks = {"pallas": 0.0, "xla": 0.0}
        for mode in RARM_AB_ROUNDS:
            os.environ["RDM_TPU_FLASH_BWD"] = mode
            per_step.clear()
            step_s.clear()
            for _ in range(RARM_AB_STEPS):
                z, nns = tr2.prepare_batch(next(batches))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                state2, _ = tr2.step_fn(state2, z, nns, 1)
                peaks[mode] = max(peaks[mode],
                                  torch.cuda.max_memory_allocated() / 2**30)
            check_counts(per_step, per_fwd if mode == "pallas" else 0,
                         f"RDM_TPU_FLASH_BWD={mode}")
            ab[mode] += [t * 1e3 for t in step_s[1:]]
        os.environ.pop("RDM_TPU_FLASH_BWD")
        ab_ms = {k: float(np.median(v)) for k, v in ab.items()}
        rate = {k: batch / v * 1e3 for k, v in ab_ms.items()}
        faster = min(ab_ms, key=ab_ms.get)
        say("rarm_train", "RDM_TPU_FLASH_BWD A/B, rounds " + " ".join(
            RARM_AB_ROUNDS) + f", {RARM_AB_STEPS} steps a round (the last "
            f"{RARM_AB_STEPS - 1} timed): kernel backward step "
            f"{ab_ms['pallas']:.2f} ms median ({rate['pallas']:.2f} "
            "samples/s; " + ", ".join(f"{t:.2f}" for t in ab["pallas"])
            + f"), eager recompute {ab_ms['xla']:.2f} ms ("
            f"{rate['xla']:.2f} samples/s; " + ", ".join(
                f"{t:.2f}" for t in ab["xla"]) + f"); peak device memory a "
            f"step {peaks['pallas']:.2f} / {peaks['xla']:.2f} GiB; faster: "
            f"{'kernel' if faster == 'pallas' else 'eager recompute'}, the "
            f"default: {'kernel' if kernel_bwd else 'eager recompute'}")

        # one batch-2 step, bf16 kernel path against CUDA f32 plain path
        model = state2.model
        z, nns = tr2.prepare_batch(next(_train_batches(emb, 2, SEED + 71)))
        grads, losses = {}, {}
        for path in ("bf16", "f32"):
            if path == "f32":
                os.environ["RDM_TPU_FLASH"] = "0"
                model.dtype = torch.float32
            _reset_all_launch_counts()
            loss, _, g = compute_rarm_grads(model, z, nns)
            c = _all_launch_counts()
            want = dict.fromkeys(c, 0)
            if path == "bf16":
                want.update(flash_fwd=per_fwd, flash_bwd=bwd_default)
            if c != want:
                raise RuntimeError(f"RARM {path} step: launches {c}")
            losses[path] = loss.item()
            grads[path] = torch.cat([
                (torch.zeros_like(p) if g[n] is None else g[n]).reshape(-1)
                .float() for n, p in model.named_parameters()])
        os.environ.pop("RDM_TPU_FLASH")
        model.dtype = torch.bfloat16
        gb, gf = grads["bf16"], grads["f32"]
        loss_rel = abs(losses["bf16"] - losses["f32"]) / abs(losses["f32"])
        rel, part_rel = _rarm_grad_rel(model, gb, gf)
        say("rarm_train", f"batch-2 step, bf16 kernel path vs CUDA f32 plain "
            f"path (RDM_TPU_FLASH=0): loss {losses['bf16']:.6f} vs "
            f"{losses['f32']:.6f} (rel {loss_rel:.3e}); gradients rel L2 "
            f"{rel:.3e} (limit {RARM_TRAIN_GRAD_TOL:g}, each part too: "
            + ", ".join(f"{k} {v:.3e}" for k, v in part_rel.items())
            + "), cosine "
            f"{torch.nn.functional.cosine_similarity(gb, gf, dim=0).item():.6f}")
        worst = max([rel, *part_rel.values()])
        if not (worst <= RARM_TRAIN_GRAD_TOL and torch.isfinite(gb).all()):
            raise RuntimeError(f"RARM bf16 gradients rel L2 {rel} (parts "
                               f"{part_rel}) > {RARM_TRAIN_GRAD_TOL}")

        # the same gate read against planted faults in the backward kernel's
        # output: each must fail it
        faults = {}
        real_bwd = fa.flash_bwd
        os.environ["RDM_TPU_FLASH_BWD"] = "pallas"
        try:
            for fault, cut in RARM_GRAD_FAULTS.items():
                def faulty(*a, cut=cut, **k):
                    return cut(*real_bwd(*a, **k))
                faulty.launches = 0
                fa.flash_bwd = faulty
                _, _, g = compute_rarm_grads(model, z, nns)
                fa.flash_bwd = real_bwd
                gx = torch.cat([
                    (torch.zeros_like(p) if g[n] is None else g[n])
                    .reshape(-1).float() for n, p in model.named_parameters()])
                f_rel, f_parts = _rarm_grad_rel(model, gx, gf)
                faults[fault] = {"rel_l2": f_rel, "by_part": f_parts}
                f_worst = max(f_parts, key=f_parts.get)
                say("rarm_train", f"planted fault ({fault}): gradients rel "
                    f"L2 {f_rel:.3e}, worst part {f_worst} "
                    f"{f_parts[f_worst]:.3e} (limit {RARM_TRAIN_GRAD_TOL:g}; "
                    + ", ".join(f"{k} {v:.3e}" for k, v in f_parts.items())
                    + ")")
                if max(f_rel, *f_parts.values()) <= RARM_TRAIN_GRAD_TOL:
                    raise RuntimeError(f"RARM gradient gate passes a planted "
                                       f"fault ({fault}): {faults[fault]}")
        finally:
            fa.flash_bwd = real_bwd
            os.environ.pop("RDM_TPU_FLASH_BWD")
        return {"launches": launches, "step_ms": med * 1e3,
                "samples_per_s": batch / med, "peak_gib": peak_gib,
                "step_tflop": step_ops / 1e12, "step_bound_ms": peak_ms,
                "kernel_bwd_step_ms": ab_ms["pallas"],
                "xla_bwd_step_ms": ab_ms["xla"],
                "kernel_bwd_peak_gib": peaks["pallas"],
                "xla_bwd_peak_gib": peaks["xla"],
                "kernel_bwd_default": kernel_bwd, "grad_rel_l2": rel,
                "grad_rel_l2_by_part": part_rel, "loss_rel": loss_rel,
                "planted_faults": faults, "batch": batch}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# ------------------------------------------------------ phase 20: parallel

def _cpu_tree(tree):
    """A deep copy of a state dict tree in host memory."""
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _whole_params(state) -> dict:
    """A step's parameters, whole, in host f32 (gathered under FSDP)."""
    return {k: v.float() for k, v in
            _cpu_tree(state.full(state.params)).items()}


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float((got[k] - want[k]).double().pow(2).sum()) for k in want)
    den = sum(float(want[k].double().pow(2).sum()) for k in want)
    return math.sqrt(num / den)


def _gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def _remat_step(step_fn, state, snap, z, nns) -> dict:
    """One step of `step_fn` from the snapshot: loss, grad_norm, wall ms,
    peak GiB (from the state alone) and the flash launches."""
    from rdm_tpu_torch.ops import flash_attention as fa

    state.load_state_dict(snap)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step_fn(state, z, nns, PARALLEL_SEED)
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "ms": (time.perf_counter() - t0) * 1e3, "peak_gib": _gib(),
           **fa.launch_counts()}
    if not (math.isfinite(out["loss"]) and math.isfinite(out["grad_norm"])):
        raise RuntimeError(f"remat step: non-finite metrics {out}")
    return out


def _fb_peak(tr, state, z, nns, policy) -> float:
    """Peak GiB of one forward and backward under `policy` (None: no
    remat), without the optimizer, whose foreach temporaries set the
    step's peak at small batches: the part that grows with the batch."""
    from rdm_tpu_torch.training.train_state import (compute_grads, fold_in,
                                                    remat_region,
                                                    remat_scope)

    region = remat_region(policy) if policy else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with remat_scope(state.model, region):
        compute_grads(state.model, z, nns,
                      fold_in(PARALLEL_SEED, 0, z.device), tr.schedule)
    torch.cuda.synchronize()
    for p in state.model.parameters():
        p.grad = None
    return _gib()


def _parallel_remat(rdm_sd, vq_sd, emb, tmp, card) -> dict:
    """(a): the ImageNet RDM through RDMTrainer's state, batches and
    optimizer: one step without remat and one under each policy from one
    state and seed at batch 40, each twice; the forward-and-backward peaks
    at batches 20 and 40 give each policy's slope, and from them a batch
    past no remat's memory, where `nothing` and `save_lowres` take two
    steps each if their predicted peak fits."""
    import dataclasses
    import os

    from rdm_tpu_torch.config import AutoencoderConfig, RDMConfig
    from rdm_tpu_torch.training.train_state import make_train_step
    from rdm_tpu_torch.training.trainer import RDMTrainer, TrainerConfig

    cfg = dataclasses.replace(RDMConfig.imagenet(), p_uncond=0.1)
    tcfg = TrainerConfig(logdir=os.path.join(tmp, "remat"), base_lr=1e-4,
                         image_log_every=0, adam_mu_dtype="bfloat16")
    resident = torch.cuda.memory_allocated() / 2**30
    say("parallel", f"{resident:.2f} GiB resident from earlier phases "
        f"(in every peak below) ({card})")
    tr = RDMTrainer(cfg, tcfg, AutoencoderConfig.vq_f4(), vq_sd,
                    batch_size=TRAIN_BATCH, device="cuda",
                    init_state_dict=rdm_sd)
    state = tr.init_state()
    snap = _cpu_tree(state.state_dict())

    def step_fn(policy):
        if policy is None:
            return tr.step_fn
        return make_train_step(tr.tx, tr.schedule, ema_decay=tcfg.ema_decay,
                               remat=True, remat_policy=policy)

    def batch_of(b, seed):
        return tr.prepare_batch(next(_train_batches(emb, b, seed)))

    names = (None,) + PARALLEL_POLICIES
    probed = ("nothing", "save_lowres")
    z, nns = batch_of(TRAIN_BATCH, SEED + 80)
    _remat_step(tr.step_fn, state, snap, z, nns)  # warm-up (cuDNN picks)
    fb = {TRAIN_BATCH: {p: _fb_peak(tr, state, z, nns, p)
                        for p in (None,) + probed}}
    at40 = {}
    for p in names:
        runs = [_remat_step(step_fn(p), state, snap, z, nns)
                for _ in range(2)]
        r = dict(runs[0], ms_2=runs[1]["ms"])
        at40[p] = r
        if runs[1]["loss"] != r["loss"]:
            raise RuntimeError(f"remat {p}: two runs of one step differ")
    base = at40[None]
    for p in PARALLEL_POLICIES:
        r = at40[p]
        rel = abs(r["grad_norm"] - base["grad_norm"]) / base["grad_norm"]
        r["grad_norm_rel"] = rel
        if r["loss"] != base["loss"] or rel > PARALLEL_GRAD_TOL:
            raise RuntimeError(f"remat {p}: loss {r['loss']!r} vs "
                               f"{base['loss']!r}, grad_norm {rel:.2e} "
                               f"relative (limit {PARALLEL_GRAD_TOL:g})")
        if (r["flash_fwd"], r["flash_bwd"]) == (0, 0):
            raise RuntimeError(f"remat {p}: no flash launches")
    for p in names:
        r = at40[p]
        say("parallel", f"remat {p or 'none'} at batch {TRAIN_BATCH}: step "
            f"{r['ms']:.1f} / {r['ms_2']:.1f} ms (two runs), peak "
            f"{r['peak_gib']:.2f} GiB, loss {r['loss']:.6f}, grad_norm "
            f"{r['grad_norm']:.6f}, flash {r['flash_fwd']} fwd / "
            f"{r['flash_bwd']} bwd ({card})")
    del z, nns
    half = TRAIN_BATCH // 2
    z, nns = batch_of(half, SEED + 81)
    fb[half] = {p: _fb_peak(tr, state, z, nns, p) for p in (None,) + probed}
    del z, nns
    total = torch.cuda.get_device_properties(0).total_memory / 2**30

    def predict(p, b):
        slope = (fb[TRAIN_BATCH][p] - fb[half][p]) / (TRAIN_BATCH - half)
        return fb[TRAIN_BATCH][p] + slope * (b - TRAIN_BATCH)

    big = TRAIN_BATCH
    while predict(None, big) < total * PARALLEL_OVER:
        big += 2
    fits = {p: predict(p, big) for p in probed}
    say("parallel", "forward + backward peaks at batch 20 / 40: " + ", ".join(
        f"{p or 'none'} {fb[half][p]:.2f} / {fb[TRAIN_BATCH][p]:.2f} GiB"
        for p in (None,) + probed) + f"; no remat predicted "
        f"{predict(None, big):.1f} GiB at batch {big} (card {total:.1f} "
        f"GiB); nothing {fits['nothing']:.1f}, save_lowres "
        f"{fits['save_lowres']:.1f} GiB predicted there ({card})")
    runs = [p for p, g in fits.items() if g < total * PARALLEL_FIT]
    if "nothing" not in runs:
        raise RuntimeError(f"remat nothing predicted {fits['nothing']:.1f} "
                           f"GiB at batch {big}: past the card")
    z, nns = batch_of(big, SEED + 82)
    at_big = {}
    for p in runs:
        r = _remat_step(step_fn(p), state, snap, z, nns)
        torch.cuda.reset_peak_memory_stats()
        _, m = step_fn(p)(state, z, nns, PARALLEL_SEED)
        torch.cuda.synchronize()
        r["loss_2"] = float(m["loss"])
        r["peak_gib"] = max(r["peak_gib"], _gib())
        if not math.isfinite(r["loss_2"]):
            raise RuntimeError(f"{p}: non-finite second loss")
        at_big[p] = r
    del z, nns
    for p in probed:
        if p in at_big:
            r = at_big[p]
            say("parallel", f"remat {p} at batch {big}: two steps, losses "
                f"{r['loss']:.6f}, {r['loss_2']:.6f}, first step "
                f"{r['ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB "
                f"(predicted {fits[p]:.1f}) ({card})")
        else:
            say("parallel", f"remat {p} at batch {big}: not run, predicted "
                f"{fits[p]:.1f} GiB past {PARALLEL_FIT:.0%} of the card "
                f"({card})")
    launches = {n: sum(r[n] for r in at40.values()) for n in FLASH_INFO}
    del state
    torch.cuda.empty_cache()
    return {"resident_gib": resident,
            "batch_40": {str(k): v for k, v in at40.items()},
            "fb_peak_gib": {b: {str(k): v for k, v in d.items()}
                            for b, d in fb.items()},
            "big_batch": big, "big": at_big, "predicted_gib": fits,
            "launches": launches}


def _dp_run(make, batches, steps=2) -> dict:
    """Steps of a trainer made by `make()` on prepared batches: losses,
    whole params, flash launches, peak GiB."""
    from rdm_tpu_torch.ops import flash_attention as fa

    tr = make()
    state = tr.init_state()
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for z, nns in batches[:steps]:
        t0 = time.perf_counter()
        state, m = tr.step_fn(state, z, nns, PARALLEL_SEED)
        losses.append(float(m["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"losses": losses, "step_ms": ms, "launches": fa.launch_counts(),
           "peak_gib": _gib(), "params": _whole_params(state)}
    return out, tr, state


def _parallel_steps(rdm_sd, vq_sd, rarm_sd, vq16_sd, emb, mesh, tmp,
                    card) -> dict:
    """(b): two DDP and two FSDP steps at world 1 over NCCL against the
    plain steps from the same state, the RDM at batch 40 and the RARM at
    batch 16; an FSDP RARMTrainer's checkpoint resumed in a plain one."""
    import dataclasses

    from rdm_tpu_torch.config import AutoencoderConfig, RARMConfig, RDMConfig
    from rdm_tpu_torch.training.trainer import RARMTrainer, RDMTrainer

    res = {}
    models = {
        "rdm": (RDMTrainer, dataclasses.replace(RDMConfig.imagenet(),
                                                p_uncond=0.1),
                AutoencoderConfig.vq_f4(), vq_sd, rdm_sd, TRAIN_BATCH,
                "val/loss_simple_ema"),
        "rarm": (RARMTrainer, dataclasses.replace(
            RARMConfig.imagenet_dogs(), p_mask_max=RARM_P_MASK_MAX),
            AutoencoderConfig.vq_f16(), vq16_sd, rarm_sd, RARM_TRAIN_BATCH,
            "val/loss_ema")}
    launches = dict.fromkeys(FLASH_INFO, 0)
    # cuDNN's deterministic algorithms, so that two runs of one step sum
    # their gradients in one order and the losses can be held equal
    torch.backends.cudnn.deterministic = True
    try:
        for name, item in models.items():
            _parallel_model(name, *item, emb, mesh, tmp, card, res,
                            launches)
    finally:
        torch.backends.cudnn.deterministic = False
    res["launches"] = launches
    return res


def _parallel_model(name, cls, cfg, fs_cfg, fs_sd, init_sd, batch, mon,
                    emb, mesh, tmp, card, res, launches) -> None:
    """(b) for one model: see `_parallel_steps`."""
    import os

    from rdm_tpu_torch.training.trainer import TrainerConfig

    def make(mode, logdir=name):
        tcfg = TrainerConfig(
            logdir=os.path.join(tmp, logdir), base_lr=1e-4,
            image_log_every=0, log_every=10**9, ckpt_every=10**9,
            max_ckpts=1, monitor=mon, param_sharding=mode or
            "replicated")
        return cls(cfg, tcfg, fs_cfg, fs_sd, mesh=mesh if mode else None,
                   batch_size=batch, device="cuda",
                   init_state_dict=init_sd)

    prep = make(None)
    it = _train_batches(emb, batch, SEED + 90)
    batches = [prep.prepare_batch(next(it)) for _ in range(3)]
    del prep
    runs = {}
    for mode in (None, "replicated", "fsdp"):
        runs[mode], tr, state = _dp_run(lambda: make(mode), batches)
        if name == "rarm" and mode == "fsdp":
            tr._save(state, {})  # step 2, whole tensors
            state, m = tr.step_fn(state, *batches[2], PARALLEL_SEED)
            runs[mode]["next_loss"] = float(m["loss"])
        del tr, state
        torch.cuda.empty_cache()
    plain = runs[None]
    for mode in ("replicated", "fsdp"):
        r = runs[mode]
        rel = _rel_l2(r["params"], plain["params"])
        r["params_rel_l2"] = rel
        if r["losses"] != plain["losses"] or rel > PARALLEL_PARAM_TOL \
                or r["launches"] != plain["launches"]:
            raise RuntimeError(
                f"{name} {mode}: losses {r['losses']} vs "
                f"{plain['losses']}, params {rel:.2e} relative L2 "
                f"(limit {PARALLEL_PARAM_TOL:g}), flash launches "
                f"{r['launches']} vs {plain['launches']}")
        say("parallel", f"{name} {mode} at world 1 (NCCL), batch "
            f"{batch}: losses {r['losses']} equal to the plain step's; "
            f"params {rel:.2e} relative L2 after 2 steps; flash "
            f"{r['launches']}; step ms {r['step_ms'][0]:.1f}, "
            f"{r['step_ms'][1]:.1f} (plain {plain['step_ms'][0]:.1f}, "
            f"{plain['step_ms'][1]:.1f}); peak {r['peak_gib']:.2f} GiB "
            f"(plain {plain['peak_gib']:.2f}) ({card})")
        for n in FLASH_INFO:
            launches[n] += r["launches"][n]
    for r in runs.values():
        del r["params"]
    res[name] = {str(k): v for k, v in runs.items()}
    if name == "rarm":
        tr = make(None, logdir="rarm")  # the FSDP trainer's directory
        state = tr.resume_or_init()
        if state.step != 2:
            raise RuntimeError(f"resumed at step {state.step}, want 2")
        _, m = tr.step_fn(state, *batches[2], PARALLEL_SEED)
        want = runs["fsdp"]["next_loss"]
        if float(m["loss"]) != want:
            raise RuntimeError(f"FSDP checkpoint resumed plain: next "
                               f"loss {float(m['loss'])!r} vs {want!r}")
        say("parallel", f"rarm: an FSDP RARMTrainer's checkpoint "
            f"resumed in a plain one, next loss {want:.6f} equal ({card})")
        res["resume_next_loss"] = want
        del tr, state
        torch.cuda.empty_cache()


def _parallel_knn(emb, mesh, card) -> dict:
    """(c): the table's rows split into 2 and 4 shards, a kernel search a
    shard with its ids offset, and the merge the db-sharded search makes
    after its all-gather, against the unsharded kernel; then the
    db-sharded search itself over NCCL at world 1."""
    from rdm_tpu_torch.ops import knn_kernel as kk
    from rdm_tpu_torch.retrieval.engine import (knn_search,
                                                knn_search_shard,
                                                l2_normalize,
                                                merge_candidates)

    db = emb.to(torch.bfloat16)
    n, d = db.shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 91)
    cases, launches = [], 0

    def counted(fn):  # the launches of one sharded search
        nonlocal launches
        kk.reset_launch_counts()
        out = fn()
        launches += sum(kk.launch_counts().values())
        return out

    for b, k in PARALLEL_KNN_CASES:
        q = l2_normalize(torch.randn(b, d, generator=g, device="cuda"))
        whole = knn_search(db, q, k)
        plain = knn_search(db, q, k + 1, impl="reference")
        for s in PARALLEL_SHARDS:
            rows = n // s

            def sharded():
                parts = [kk.knn_topk(db[r * rows:(r + 1) * rows], q, k)
                         for r in range(s)]
                return merge_candidates(
                    torch.cat([p[0] for p in parts], 1),
                    torch.cat([p[1] + r * rows
                               for r, p in enumerate(parts)], 1), k)

            got = counted(sharded)
            near = _knn_hold(f"{s} shards B={b} k={k}", got, plain, n)
            differ = int((got[1] != whole[1]).sum().item())
            _knn_hold(f"{s} shards vs the unsharded kernel", got,
                      (whole[0], whole[1]), n)
            ms, whole_ms = median_ms(sharded), median_ms(
                lambda: kk.knn_topk(db, q, k))
            cases.append({"shards": s, "b": b, "k": k, "ms": ms,
                          "unsharded_ms": whole_ms, "near_tie_ranks": near,
                          "ids_differ_from_unsharded": differ})
            say("parallel", f"knn {s} shards B={b} k={k}: {ms:.3f} ms "
                f"(unsharded kernel {whole_ms:.3f} ms); ids differ from "
                f"the unsharded kernel at {differ} near-tie ranks ({card})")
    q = l2_normalize(torch.randn(16, d, generator=g, device="cuda"))
    got = counted(lambda: knn_search_shard(db, 0, q, 4, mesh))
    if not torch.equal(got[1], knn_search(db, q, 4)[1]):
        raise RuntimeError("knn_search_shard at world 1 differs from the "
                           "unsharded search")
    return {"cases": cases, "launches": launches}


def _parallel_sampling(rdm_sd, vq_sd, rarm_sd, vq16_sd, emb, mesh) -> dict:
    """(d): one RDM and one RARM request through `mesh=` pipelines at
    world 1, bit-equal to the plain pipelines' on the same seeds."""
    from rdm_tpu_torch.config import AutoencoderConfig, RARMConfig, RDMConfig
    from rdm_tpu_torch.ops import knn_kernel as kk
    from rdm_tpu_torch.pipeline import RARMPipeline, RDMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool

    g = torch.Generator(device="cuda").manual_seed(SEED + 92)
    q = torch.randn(4, 512, generator=g, device="cuda")
    pool = DataPool(embeddings=emb)
    kk.reset_launch_counts()
    out = {}
    for name, cls, cfg, fs, fs_sd, sd, kw in (
            ("rdm", RDMPipeline, RDMConfig.imagenet(),
             AutoencoderConfig.vq_f4(), vq_sd, rdm_sd,
             dict(steps=PARALLEL_DDIM_STEPS, guidance_scale=2.0, seed=4)),
            ("rarm", RARMPipeline, RARMConfig.imagenet_dogs(),
             AutoencoderConfig.vq_f16(), vq16_sd, rarm_sd,
             dict(top_k=64, temperature=1.0, seed=4,
                  return_tokens=True))):
        imgs = []
        for m in (None, mesh):
            pipe = cls(cfg, sd, fs, fs_sd, pool=pool, device="cuda", mesh=m)
            r = pipe.sample_with_query(q, **kw)
            imgs.append(r)
            del pipe
            torch.cuda.empty_cache()
        a, b = imgs
        same = np.array_equal(a["query_samples"], b["query_samples"]) and (
            name == "rdm" or np.array_equal(a["tokens"], b["tokens"]))
        if not same:
            raise RuntimeError(f"{name}: the mesh pipeline's request differs "
                               "from the plain one's")
        out[name] = "bit-equal"
        say("parallel", f"{name} request through mesh= at world 1: "
            f"bit-equal to the plain pipeline's")
    out["knn_launches"] = sum(kk.launch_counts().values())
    return out


def phase_parallel(rdm_sd: dict, vq_sd: dict, rarm_sd: dict, vq16_sd: dict,
                   emb: torch.Tensor, card: str) -> dict:
    """Phase 20: remat, world-1 DDP / FSDP over NCCL, the db-sharded kNN
    and data-parallel sampling; returns each part's numbers and the
    flash and knn launches."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from rdm_tpu_torch.parallel import distributed as pdist
    from rdm_tpu_torch.parallel.mesh import make_mesh

    tmp = tempfile.mkdtemp(prefix="parallel_smoke_")
    try:
        remat = _parallel_remat(rdm_sd, vq_sd, emb, tmp, card)
        pdist.initialize(f"file://{tmp}/store", 1, 0, device="cuda")
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"process group on {dist.get_backend()}")
        mesh = make_mesh(data=1)
        steps = _parallel_steps(rdm_sd, vq_sd, rarm_sd, vq16_sd, emb, mesh,
                                tmp, card)
        knn = _parallel_knn(emb, mesh, card)
        sampling = _parallel_sampling(rdm_sd, vq_sd, rarm_sd, vq16_sd, emb,
                                      mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {n: remat["launches"][n] + steps["launches"][n]
                for n in FLASH_INFO}
    launches["knn"] = knn["launches"] + sampling["knn_launches"]
    return {"remat": remat, "steps": steps, "knn": knn,
            "sampling": sampling, "launches": launches}


# ------------------------------------------------------------- quality

def _quality_kernels() -> dict:
    """Phase 21 (a): each kernel the gates launch, at their shapes,
    against its plain version (KERNEL_TOL of its own max|ref|): ln_qkv,
    packed_attn, post_cross and geglu_ff at the RDM gate's ds-2 site (C =
    64 as 2 heads of 32, 4 x 4 tokens, T = 3 context rows of 48, 64
    images); decode_attn and decode_post_ff at the RARM gate's width (C =
    64 as 1 head of 64, B = 64, T = 64, 3 context rows) at pos 0 / 31 /
    63; the kNN pair over the gates' 256 x 48 pool at k = 3 (phase 17's
    rule). Returns {kernel: max|err| / max|ref|}."""
    from rdm_tpu_torch.eval.micro_gate import make_shapes, pixel_embed
    from rdm_tpu_torch.models.layers import TransformerBlock
    from rdm_tpu_torch.models.rarm import _Block
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.ops import decode_kernel as dk
    from rdm_tpu_torch.ops import knn_kernel as kk
    from rdm_tpu_torch.retrieval.engine import l2_normalize

    g = torch.Generator(device="cuda").manual_seed(SEED + 80)
    c, b, s, t = QUALITY_C, QUALITY_IMAGES, QUALITY_TOKENS, QUALITY_T

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    def worst(errs):
        return max(rel for _, _, rel in errs)

    out = {}
    hd = 32
    heads = c // hd
    blk = TransformerBlock(c, QUALITY_DC, heads, hd)
    blk.load_state_dict(seeded_state_dict(blk, SEED + 81))
    w = bk.pack_block_weights(blk.cuda(), torch.bfloat16)
    x, ctx = rn(b, s, c), rn(b, t, QUALITY_DC)
    ck, cv = bk.context_kv(ctx, w)
    x2 = x.reshape(b * s, c)
    qkv_in = (x2, w["n1s"], w["n1b"], w["wqkv"])
    qkv = bk.ln_qkv(*qkv_in)
    torch.cuda.synchronize()
    out["ln_qkv"] = worst(_hold("ln_qkv (gate)", zip(
        "qkv", qkv, bk.ln_qkv_reference(*qkv_in))))
    q, k, v = (a.reshape(b, s, c) for a in qkv)
    attn = bk.packed_attn(q, k, v, heads=heads, head_dim=hd)
    torch.cuda.synchronize()
    out["packed_attn"] = worst(_hold("packed_attn (gate)", [(
        "o", attn, bk.packed_attn_reference(q, k, v, heads=heads,
                                            head_dim=hd))]))
    pc = (x, attn, ck, cv, w["wo"], w["bo"], w["n2s"], w["n2b"], w["wq2"],
          w["wo2"], w["bo2"])
    xm = bk.post_cross(*pc, heads=heads, head_dim=hd)
    torch.cuda.synchronize()
    out["post_cross"] = worst(_hold("post_cross (gate)", [(
        "xmid", xm, bk.post_cross_reference(*pc, heads=heads,
                                            head_dim=hd))]))
    ff = (xm.reshape(b * s, c), w["n3s"], w["n3b"], w["wa"], w["wg"],
          w["ba"], w["bg"], w["w2"], w["b2"])
    y = bk.geglu_ff(*ff)
    torch.cuda.synchronize()
    out["geglu_ff"] = worst(_hold("geglu_ff (gate)", [
        ("y", y, bk.geglu_ff_reference(*ff))]))

    dhd = 64
    dheads = c // dhd
    rblk = _Block(c, QUALITY_DC, dheads, dhd)
    rblk.load_state_dict(seeded_state_dict(rblk, SEED + 82))
    w = bk.pack_block_weights(rblk.cuda(), torch.bfloat16)
    hdk = dict(heads=dheads, head_dim=dhd)
    out["decode_attn"] = out["decode_post_ff"] = 0.0
    for pos in QUALITY_POSITIONS:
        x, kc, vc = rn(b, c), rn(QUALITY_SEQ, b, c), rn(QUALITY_SEQ, b, c)
        cross_k, cross_v = rn(t, b, c), rn(t, b, c)
        a_in = (w["n1s"], w["n1b"], w["wqkv"])
        got = dk.decode_attn(x, pos, kc.clone(), vc.clone(), *a_in, **hdk)
        torch.cuda.synchronize()
        want = dk.decode_attn_reference(x, pos, kc.clone(), vc.clone(),
                                        *a_in, **hdk)
        out["decode_attn"] = max(out["decode_attn"], worst(_hold(
            f"decode_attn (gate) pos={pos}",
            zip(("attn", "k_new", "v_new"), got, want))))
        ff = (x, want[0], cross_k, cross_v, w["wo"], w["bo"], w["n2s"],
              w["n2b"], w["wq2"], w["wo2"], w["bo2"], w["n3s"], w["n3b"],
              w["wa"], w["wg"], w["ba"], w["bg"], w["w2"], w["b2"])
        got = dk.decode_post_ff(*ff, **hdk)
        torch.cuda.synchronize()
        out["decode_post_ff"] = max(out["decode_post_ff"], worst(_hold(
            f"decode_post_ff (gate) pos={pos}",
            [("x_out", got, dk.decode_post_ff_reference(*ff, **hdk))])))

    pool = pixel_embed(make_shapes(QUALITY_POOL, size=16, seed=QUALITY_SEED))
    db = l2_normalize(torch.as_tensor(pool, device="cuda")).bfloat16()
    qids = torch.randint(0, QUALITY_POOL, (b,), generator=g, device="cuda")
    queries = l2_normalize(torch.as_tensor(pool, device="cuda")[qids])
    got = kk.knn_topk(db, queries, 3)
    torch.cuda.synchronize()
    near = _knn_hold("knn (gate pool)", got,
                     kk.knn_search_reference(db, queries, 4), QUALITY_POOL)
    out["knn"] = (got[0] - kk.knn_search_reference(db, queries, 3)[0]
                  ).abs().max().item()
    say("quality", "gate-shape kernels against their plain versions, "
        "/max|ref| (limit %g): %s; knn over %d x %d, k = 3, B = %d: scores "
        "max|err| %.2e, %d near-tie ranks apart" % (
            KERNEL_TOL, ", ".join(f"{n} {out[n]:.3e}" for n in (
                "ln_qkv", "packed_attn", "post_cross", "geglu_ff",
                "decode_attn", "decode_post_ff")),
            QUALITY_POOL, pool.shape[1], b, out["knn"], near))
    return out


def _all_launch_counts() -> dict:
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.ops import decode_kernel as dk
    from rdm_tpu_torch.ops import flash_attention as fa
    from rdm_tpu_torch.ops import knn_kernel as kk

    return {**bk.launch_counts(), **dk.launch_counts(), **fa.launch_counts(),
            **kk.launch_counts()}


def _reset_all_launch_counts() -> None:
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.ops import decode_kernel as dk
    from rdm_tpu_torch.ops import flash_attention as fa
    from rdm_tpu_torch.ops import knn_kernel as kk

    for mod in (bk, dk, fa, kk):
        mod.reset_launch_counts()


# the kernels each gate must have launched while it ran
GATE_KERNELS = {"rdm": ("ln_qkv", "packed_attn", "post_cross", "geglu_ff",
                        "knn"),
                "rarm": ("decode_attn", "decode_post_ff", "knn")}
FIDELITY_KERNELS = {"bf16": ("ln_qkv", "packed_attn", "post_cross",
                             "geglu_ff"),
                    "int8": ("ln_qkv_q", "post_cross_q", "geglu_ff_q")}


def gate_in_this_process(model: str, fast: bool, seed: int) -> dict:
    """One micro gate through the CLI's `gate` (the kernels' head split on
    the card), in this process: its report with its wall seconds, its
    tier and the launch counts of its run (set to 0 just before it).
    Phase 21 (b) runs each gate and seed in a process of its own."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rdm_tpu_torch.scripts.micro_quality_gate import gate

    _reset_all_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = gate(model, fast, seed=seed, device="cuda", logdir=tmp)
    torch.cuda.synchronize()
    report["wall_s"] = time.perf_counter() - t0
    report["fast"] = fast
    report["launches"] = {k: v for k, v in _all_launch_counts().items()
                          if v}
    report.pop("logdir")
    return report


GATE_MARK = "quality gate report: "
GATE_TIMEOUT_S = 900


def _start_gates(tmp: str) -> dict:
    """Phase 21 (b), started: each gate and seed of QUALITY_GATES in a
    process of its own (`gate_in_this_process`, the kernels already
    built), its output to a file under `tmp`. The gates are host-bound,
    so side by side they share the card and take one gate's wall time."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for model, fast, seeds, _ in QUALITY_GATES:
        for seed in seeds:
            code = ("import json, chip_smoke as cs\n"
                    f"r = cs.gate_in_this_process({model!r}, {fast!r}, "
                    f"{seed})\n"
                    f"print({GATE_MARK!r} + json.dumps(r), flush=True)\n")
            log = open(os.path.join(tmp, f"{model}_{fast}_{seed}.log"),
                       "w+")
            procs[model, fast, seed] = (subprocess.Popen(
                [sys.executable, "-c", code], cwd=here, stdout=log,
                stderr=subprocess.STDOUT), log)
    return procs


def _gate_report(model: str, seed: int, proc, log) -> dict:
    """One gate process's report: it must exit 0 and have launched each
    of its model's kernels."""
    rc = proc.wait(timeout=GATE_TIMEOUT_S)
    log.seek(0)
    text = log.read()
    lines = [ln for ln in text.splitlines() if ln.startswith(GATE_MARK)]
    if rc != 0 or not lines:
        raise RuntimeError(f"{model} gate (seed {seed})'s process exited "
                           f"{rc}:\n" + text[-4000:])
    report = json.loads(lines[-1][len(GATE_MARK):])
    counts = report["launches"]
    quiet = [k for k in GATE_KERNELS[model] if not counts.get(k)]
    if quiet:
        raise RuntimeError(f"{model} gate (seed {seed}): no launch of "
                           f"{quiet} (launches {counts})")
    return report


def _finish_gates(procs: dict, card: str) -> dict:
    """Phase 21 (b), finished: every report printed as one JSON line; a
    gate passes when the median over its seeds of fid_trained /
    fid_random_init is under the JAX gate's ratio for the tier (one seed:
    the JAX gate's verdict) and every seed's precision_trained is above
    its precision_random. A gate of QUALITY_GATES that does not gate has
    its verdict printed and fails nothing."""
    out = {"reports": {}, "launches": {}}
    for model, fast, seeds, gating in QUALITY_GATES:
        reports = []
        for seed in seeds:
            r = _gate_report(model, seed, *procs[model, fast, seed])
            r.update(seed=seed, card=card)
            print(json.dumps(r), flush=True)
            reports.append(r)
            for k, v in r["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
        limit = reports[0]["gate_ratio"]
        ratio = float(np.median([r["fid_trained"] / r["fid_random_init"]
                                 for r in reports]))
        leads = [round(r["precision_trained"] - r["precision_random"], 4)
                 for r in reports]
        tier = "fast" if fast else "full"
        verdict = (f"{model} gate ({tier} tier, seeds {list(seeds)}): "
                   f"median fid_ratio {ratio:.4f} (limit {limit}), "
                   f"precision leads over the random init {leads} "
                   f"(ratios {[r['fid_ratio'] for r in reports]})")
        passed = ratio < limit and min(leads) > 0.0
        if gating and not passed:
            raise RuntimeError(f"{verdict}: failed")
        say("quality", f"{verdict}: {'passed' if passed else 'failed'}"
            f"{'' if gating else ', recorded (it does not gate)'}; "
            f"{max(r['wall_s'] for r in reports):.1f} s; {card}")
        out["reports"][f"{model}_{tier}"] = {
            "median_fid_ratio": ratio, "precision_leads": leads,
            "gate_ratio": limit, "gating": gating, "passed": passed,
            "runs": reports}
    return out


def _same_run(what: str, a: dict, b: dict) -> None:
    for key in ("z", "images", "traj"):
        if not np.array_equal(a[key], b[key]):
            raise RuntimeError(f"fidelity: {what} is not bit-equal to the "
                               f"exact run ({key})")


def _quality_fidelity(rdm_sd: dict, vq_sd: dict, emb: torch.Tensor,
                      card: str) -> dict:
    """Phase 21 (c): the fidelity harness at the main op point (the
    seeded ImageNet RDM, VQ-f4, the 1,281,280 x 512 table, batch 4,
    DDIM-50, guidance 2.0, k = 4, shared CFG): an exact run, a second one
    and encoder_reuse=1 (both bit-equal to it), then FIDELITY_MODES
    against it (the int8 modes on the pipeline's int8 twin), then an exact
    run again (bit-equal: the twin left the exact modules exact). Every
    record finite; each mode's record and wall seconds printed."""
    from rdm_tpu_torch.config import AutoencoderConfig, RDMConfig
    from rdm_tpu_torch.eval.fidelity import compare_runs
    from rdm_tpu_torch.pipeline import RDMPipeline, _query_embeddings
    from rdm_tpu_torch.retrieval.database import DataPool
    from rdm_tpu_torch.scripts.quality_eval import parse_mode

    pipe = RDMPipeline(RDMConfig.imagenet(), rdm_sd,
                       AutoencoderConfig.vq_f4(), vq_sd,
                       pool=DataPool(embeddings=emb), device="cuda")
    q = _query_embeddings(pipe.retrieval, None, FIDELITY_BATCH, 0.01, False,
                          None, QUALITY_SEED)
    neighbors = pipe.retrieval.search(q, k=4)["embeddings"]
    common = dict(steps=SERVE_STEPS, guidance_scale=2.0, seed=QUALITY_SEED)
    out = {"modes": {}, "wall_s": {}, "launches": {}}

    def run(label, **kw):
        _reset_all_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = pipe.fidelity_run(neighbors, **common, **kw)
        torch.cuda.synchronize()
        out["wall_s"][label] = time.perf_counter() - t0
        counts = {k: v for k, v in _all_launch_counts().items() if v}
        for k, v in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        want = FIDELITY_KERNELS["int8" if kw.get("int8") else "bf16"]
        quiet = [k for k in want if not counts.get(k)]
        if quiet:
            raise RuntimeError(f"fidelity {label}: no launch of {quiet}")
        for key in ("z", "traj"):
            if not np.isfinite(r[key]).all():
                raise RuntimeError(f"fidelity {label}: non-finite {key}")
        return r

    exact = run("exact")
    _same_run("a second exact run", exact, run("exact_again"))
    _same_run("encoder_reuse=1", exact, run("reuse1", encoder_reuse=1))
    for mode in FIDELITY_MODES:
        int8, reuse = parse_mode(mode)
        rec = compare_runs(exact, run(mode, int8=int8, encoder_reuse=reuse))
        brief = {k: v for k, v in rec.items()
                 if k != "pred_x0_cosine_per_step"}
        if not all(np.isfinite(v) for v in brief.values()):
            raise RuntimeError(f"fidelity {mode}: a non-finite record "
                               f"{brief}")
        out["modes"][mode] = rec
        say("quality", f"fidelity {mode}: {json.dumps(brief)}; "
            f"{out['wall_s'][mode]:.2f} s; {card}")
    _same_run("the exact run after the int8 runs", exact,
              run("exact_after_int8"))
    say("quality", "fidelity: a second exact run, encoder_reuse=1 and the "
        "exact run after the int8 runs bit-equal to the first (latent PSNR "
        "inf, pred_x0 cosine min 1.0); exact run %.2f s; int8 twin "
        "calibrated in the first int8 run; %s" % (out["wall_s"]["exact"],
                                                   card))
    del pipe
    torch.cuda.empty_cache()
    return out


def phase_quality(rdm_sd: dict, vq_sd: dict, emb: torch.Tensor,
                  card: str) -> dict:
    """Phase 21: (a) the gate-shape kernels, then (b) the micro gates, in
    processes of their own, and (c) the fidelity pass, in this one, side
    by side; returns {'kernels', 'gates', 'fidelity', 'launches'} (the
    launches of (b) and (c), the paths)."""
    t0 = time.perf_counter()
    kernels = _quality_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        procs = _start_gates(tmp)
        try:  # the fidelity pass in this process while the gates run
            fidelity = _quality_fidelity(rdm_sd, vq_sd, emb, card)
            gates = _finish_gates(procs, card)
        finally:
            for proc, log in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
    launches = dict(gates["launches"])
    for k, v in fidelity["launches"].items():
        launches[k] = launches.get(k, 0) + v
    say("quality", f"phase 21 wall {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "gates": gates["reports"],
            "fidelity": {m: {k: v for k, v in r.items()
                             if k != "pred_x0_cosine_per_step"}
                         for m, r in fidelity["modes"].items()},
            "fidelity_wall_s": fidelity["wall_s"], "launches": launches}


def _timed(phase, *args):
    """phase(*args), and its wall seconds on a line of their own."""
    t0 = time.perf_counter()
    out = phase(*args)
    say(phase.__name__[len("phase_"):], f"phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 scores stay f32
    torch.backends.cudnn.allow_tf32 = False
    from rdm_tpu_torch.config import (AutoencoderConfig, RARMConfig,
                                      RDMConfig)
    from rdm_tpu_torch.models.autoencoder import VQModel
    from rdm_tpu_torch.models.rarm import RARM
    from rdm_tpu_torch.models.rdm import RDM

    card = _timed(phase_device)
    _timed(phase_build)
    kernels = _timed(phase_kernels)
    int8_kernels = _timed(phase_int8_kernels)
    with torch.device("meta"):  # shapes only
        rdm, vq = RDM(RDMConfig.imagenet()), VQModel(AutoencoderConfig.vq_f4())
        rarm = RARM(RARMConfig.imagenet_dogs())
        vq16 = VQModel(AutoencoderConfig.vq_f16())
    rdm_sd = seeded_state_dict(rdm, SEED + 10)
    vq_sd = seeded_state_dict(vq, SEED + 11)
    _timed(phase_forward, rdm_sd)
    emb = make_table()
    launches = _timed(phase_serve, rdm_sd, vq_sd, emb)
    decode = _timed(phase_rarm_kernels)
    rarm_sd = seeded_state_dict(rarm, SEED + 12)
    _timed(phase_rarm_forward, rarm_sd)
    vq16_sd = seeded_state_dict(vq16, SEED + 13)
    decode_launches = _timed(phase_rarm_serve, rarm_sd, vq16_sd, emb)
    _timed(phase_int8_forward, rdm_sd)
    int8_launches = _timed(phase_serve_modes, rdm_sd, vq_sd, emb)
    int8_decode = _timed(phase_rarm_int8_kernels)
    int8_decode_launches = _timed(phase_rarm_serve_modes, rarm_sd, vq16_sd,
                                  emb)
    post_ff = _timed(phase_post_ff, rdm_sd, vq_sd, emb)
    flash = _timed(phase_flash_kernels)
    train = _timed(phase_train, rdm_sd, vq_sd, emb)
    knn = _timed(phase_knn, emb)
    clip = _timed(phase_clip_serve, rdm_sd, vq_sd, emb, rarm_sd, vq16_sd)
    rarm_train = _timed(phase_rarm_train, rarm_sd, vq16_sd, emb)
    par = _timed(phase_parallel, rdm_sd, vq_sd, rarm_sd, vq16_sd, emb, card)
    quality = _timed(phase_quality, rdm_sd, vq_sd, emb, card)
    qlaunch = quality["launches"]

    def row(name, info, launches_, r, **extra):
        # device ms of a call in a CUDA graph: the sum over the sites or
        # cases (packed_attn, flash_*: theirs), the mean over the decode
        # cases, knn's op point
        sites = r.get("sites") or r.get("cases") or ()
        device = r.get("kernel_device_ms", r.get("device_ms"))
        if device is None and sites and all("device_ms" in x
                                            for x in sites):
            device = sum(x["device_ms"] for x in sites)
        return {"name": name, "route": "cuda", "source": info[0],
                "replaces": info[1], "launches": launches_[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "device_ms": device, **extra}

    core = {"packed_attn": {"sources": [KERNEL_INFO["packed_attn"][0],
                                        ATTN_CORE]},
            "flash_fwd": {"sources": [FLASH_INFO["flash_fwd"][0],
                                      ATTN_CORE]}}
    for n in GEMM_LAUNCHES:
        core[n] = {"sources": [KERNEL_INFO[n][0]] + GEMM_CORE,
                   "op_point_sites": kernels[n]["op_point_sites"]}
    # the block kernels' launches: phase 5's two requests and phase 16's
    # fused-block training steps
    fused = train["fused_launches"]
    block_launches = {n: launches[n] + fused[n] + qlaunch.get(n, 0)
                      for n in kernels}
    rows = [row(n, KERNEL_INFO[n], block_launches, r, sites=r["sites"],
                launches_by_phase={"serve": launches[n],
                                   "train_fused_blocks": fused[n],
                                   "quality": qlaunch.get(n, 0)},
                quality_rel_err=quality["kernels"][n],
                **core.get(n, {}))
            for n, r in kernels.items()]
    for n in INT8_GEMM_LAUNCHES:
        core[n] = {"sources": [INT8_INFO[n][0]] + GEMM_CORE}
    core["packed_attn_q8"] = {
        "sources": ATTN8_SOURCES,
        "exp2_floor_ms": int8_kernels["packed_attn_q8"]["exp2_floor_ms"]}
    int8_all = {n: int8_launches[n] + qlaunch.get(n, 0)
                for n in int8_kernels}
    rows += [row(n, INT8_INFO[n], int8_all, r, sites=r["sites"],
                 launches_by_phase={"serve_modes": int8_launches[n],
                                    "quality": qlaunch.get(n, 0)},
                 **core.get(n, {}))
             for n, r in int8_kernels.items()]
    apart = ("sweep_rel_err", "qkv_device_ms", "attn_device_ms",
             "library_device_ms")  # decode_attn's (and commit_rows' last)
    apart += ("chain_launch_ms",)  # decode_post_ff's five launches
    apart += ("host_us", "wrapper_ms", "wrapper_host_us")  # commit_rows'
    decode_all = {n: decode_launches[n] + qlaunch.get(n, 0) for n in decode}
    rows += [row(n, DECODE_INFO[n], decode_all, r,
                 sources=DECODE_INFO[n][2], cases=r["cases"],
                 launches_by_phase={"rarm_serve": decode_launches[n],
                                    "quality": qlaunch.get(n, 0)},
                 **{k: r[k] for k in apart if k in r},
                 **({"quality_rel_err": quality["kernels"][n]}
                    if n in quality["kernels"] else {}))
             for n, r in decode.items()]
    rows += [row(n, INT8_DECODE_INFO[n], int8_decode_launches, r,
                 sources=INT8_DECODE_INFO[n][2], cases=r["cases"],
                 **{k: r[k] for k in apart if k in r})
             for n, r in int8_decode.items()]
    rows.append(row("post_ff", POST_FF_INFO,
                    {"post_ff": post_ff["launches"]}, post_ff,
                    split_ms=post_ff["split_ms"],
                    split_device_ms=post_ff["split_device_ms"],
                    ff_launch_device_ms=post_ff["ff_launch_device_ms"],
                    forward_core_launches=post_ff["forward_core_launches"],
                    sites=post_ff["sites"],
                    request_s=post_ff["request_s"],
                    forward_rel_l2=post_ff["forward_rel_l2"]))
    # the flash kernels' launches: phase 16's and phase 19's first
    # trainers and phase 20's steps
    flash_launches = {n: train["launches"][n] + rarm_train["launches"][n]
                      + par["launches"][n] for n in flash}
    parallel = {k: par[k] for k in ("remat", "steps")}
    rows += [row(n, FLASH_INFO[n], flash_launches, r, cases=r["cases"],
                 launches_by_phase={"train_rdm": train["launches"][n],
                                    "train_rarm": rarm_train["launches"][n],
                                    "parallel": par["launches"][n]},
                 parallel=parallel,
                 train={k: v for k, v in train.items() if k != "launches"},
                 rarm_train={k: v for k, v in rarm_train.items()
                             if k != "launches"},
                 **core.get(n, {}))
             for n, r in flash.items()]
    rows.append(row("knn", KNN_INFO,
                    {"knn": clip["launches"] + par["launches"]["knn"]
                     + qlaunch.get("knn", 0)}, knn,
                    cases=knn["cases"], near_tie_ranks=knn["near_tie_ranks"],
                    serve=clip,
                    launches_by_phase={"clip_serve": clip["launches"],
                                       "parallel": par["launches"]["knn"],
                                       "quality": qlaunch.get("knn", 0)},
                    parallel=par["knn"],
                    quality={k: quality[k] for k in (
                        "gates", "fidelity", "fidelity_wall_s")}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
