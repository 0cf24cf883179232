#!/usr/bin/env python3
"""Where a RARM request's time goes, on one NVIDIA GPU (rdm_tpu_torch).

    python3 profile_rarm.py [--repeats 3] [--out profile_rarm.json]

Builds the RARM serving pipeline of `chip_smoke.py` phase 8: the
ImageNet-dogs RARM at full width (depth 18, C = 768, 12 heads of 64,
T = 256) with a VQ-f16 first stage, random weights from a seed, over the
1,281,280 x 512 table made on the card. Then measures, in this order, for
each serving mode (exact bf16, int8_weights, int8_kv, both, approx_top_k):

  requests  `sample_with_query` (batch 16, k = 4, top_k 256, guidance 1.0)
            and `sample_unconditional` (batch 16, guidance 2.0: a decode
            batch of 32), every (mode, request) in turn, `repeats` times:
            host-clock seconds around a synchronised call.
  parts     the kNN search of 16 queries, the VQ-f16 `decode_code` of 16
            token grids (median CUDA-event ms of 10), and the 256-step
            `sample_tokens_fused` at guidance 1.0 and 2.0 in each mode,
            in bf16 also with the batched commit, in turn, `repeats` times
            each (host-clock ms per step).
  profile   `torch.profiler` over one whole 256-step decode per (guidance,
            mode or commit): device time (the sum over kernels, memcpys
            and memsets), the host-clock wall time of the same synchronised
            decode, the device's idle share (1 - the union of the device
            intervals / wall), launches per step, and device time per
            kernel.

Prints one line per measurement, the card's name, power limit, SM clock
and power draw first and last, and writes everything to --out as JSON.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

BATCH, K_NN, TOP_K = 16, 4, 256
GUIDANCES = (1.0, 2.0)        # decode batch 16, and 32 under CFG
MODES = {"bf16": {}, "int8_weights": dict(int8_weights=True),
         "int8_kv": dict(int8_kv=True),
         "int8_weights+int8_kv": dict(int8_weights=True, int8_kv=True),
         "approx_top_k": dict(approx_top_k=True)}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def timed(fn) -> float:
    """Host-clock seconds of fn() between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def event_ms(fn, runs: int = 10) -> float:
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


def device_intervals(prof) -> list:
    """(name, start us, duration us) of every device event of a trace."""
    return [(e.name, e.time_range.start, e.time_range.elapsed_us())
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(intervals) -> float:
    """The union of the device intervals, in us."""
    total, end = 0.0, -float("inf")
    for _, start, dur in sorted(intervals, key=lambda e: e[1]):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def profile_decode(decode, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_us = timed(decode) * 1e6
    ev = device_intervals(prof)
    if not ev:
        raise RuntimeError("the trace holds no device events")
    per_kernel = defaultdict(lambda: [0.0, 0])
    for name, _, dur in ev:
        per_kernel[name][0] += dur
        per_kernel[name][1] += 1
    device_us = sum(d for _, _, d in ev)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    # the attention-forward core (csrc/attn_fwd_sm90.cuh), which packed_attn
    # and flash_fwd launch, whether or not it is among the top kernels
    # the flash backward's three launches (csrc/flash_attn_bwd.cu): its
    # statistics launch is the core with kStats, attn_fwd_kernel<D, C, true>
    def is_bwd(name):
        return ("attn_bwd_" in name
                or re.search(r"attn_fwd_kernel<\d+, \w+, true>", name))

    bwd = [v for n, v in per_kernel.items() if is_bwd(n)]
    core = [v for n, v in per_kernel.items()
            if "attn_fwd_kernel" in n and not is_bwd(n)]
    core_us = sum(t for t, _ in core)
    bwd_us = sum(t for t, _ in bwd)
    # the block-GEMM core (csrc/block_gemm_sm90.cuh): ln_qkv's launch,
    # post_cross's three and geglu_ff's two, or post_ff's FF launch
    gemm = [v for n, v in per_kernel.items()
            if "block_gemm_kernel" in n or "block_gemm_ff_kernel" in n]
    gemm_us = sum(t for t, _ in gemm)
    # its s8 launches: ln_qkv_q's one, post_cross_q's three and geglu_ff_q's
    # two
    gemm8 = [v for n, v in per_kernel.items() if "block_gemm_s8_kernel" in n]
    gemm8_us = sum(t for t, _ in gemm8)
    # the int8 attention core's three launches (csrc/packed_attn_q8.cu)
    attn8 = [v for n, v in per_kernel.items() if "attn8::" in n]
    attn8_us = sum(t for t, _ in attn8)
    return {
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_ms_per_step": device_us / steps / 1e3,
        "idle_share": 1.0 - busy_us(ev) / wall_us,
        "launches_per_step": len(ev) / steps,
        "top": [{"name": n[:90], "ms_per_step": t / steps / 1e3,
                 "share": t / device_us, "per_step": c / steps}
                for n, (t, c) in top],
        "attn_core": {"ms_per_step": core_us / steps / 1e3,
                      "share": core_us / device_us,
                      "per_step": sum(c for _, c in core) / steps},
        "attn_bwd": {"ms_per_step": bwd_us / steps / 1e3,
                     "share": bwd_us / device_us,
                     "per_step": sum(c for _, c in bwd) / steps},
        "gemm_core": {"ms_per_step": gemm_us / steps / 1e3,
                      "share": gemm_us / device_us,
                      "per_step": sum(c for _, c in gemm) / steps},
        "gemm_s8": {"ms_per_step": gemm8_us / steps / 1e3,
                    "share": gemm8_us / device_us,
                    "per_step": sum(c for _, c in gemm8) / steps},
        "attn8": {"ms_per_step": attn8_us / steps / 1e3,
                  "share": attn8_us / device_us,
                  "per_step": sum(c for _, c in attn8) / steps}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="profile_rarm.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_rarm: torch.cuda.is_available() is false; this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from chip_smoke import SEED, make_table, seeded_state_dict
    from rdm_tpu_torch.config import AutoencoderConfig, RARMConfig
    from rdm_tpu_torch.models.autoencoder import VQModel
    from rdm_tpu_torch.models.rarm import RARM, sample_tokens_fused
    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.pipeline import RARMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool

    out = {"card_before": card()}
    print(out["card_before"], flush=True)
    _build.load()
    cfg, vq_cfg = RARMConfig.imagenet_dogs(), AutoencoderConfig.vq_f16()
    with torch.device("meta"):  # shapes only
        rarm, vq = RARM(cfg), VQModel(vq_cfg)
    rarm_sd = seeded_state_dict(rarm, SEED + 12)
    vq_sd = seeded_state_dict(vq, SEED + 13)
    emb = make_table()
    pipe = RARMPipeline(cfg, rarm_sd, vq_cfg, vq_sd,
                        pool=DataPool(embeddings=emb), device="cuda")
    del rarm_sd, vq_sd
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    queries = torch.randn(BATCH, 512, generator=g, device="cuda")
    qids = torch.randint(0, emb.shape[0], (BATCH,), generator=g,
                         device="cuda").cpu().numpy()
    neighbors = pipe.retrieval.search(queries, k=K_NN)["embeddings"]
    grids = torch.zeros((BATCH, cfg.code_side, cfg.code_side),
                        dtype=torch.long, device="cuda")
    steps = cfg.seq_len

    def decode(guidance: float, mode: str, n: int = steps):
        opts = dict(MODES.get(mode, {}), batched_commit=mode == "batched")
        return lambda: sample_tokens_fused(
            pipe.model, neighbors, torch.Generator(
                device="cuda").manual_seed(0), steps=n, top_k=TOP_K,
            guidance_scale=guidance, weights=pipe.serving_decode_weights(
                opts.get("int8_weights", False)), **opts)

    requests = {}
    for mode, opts in MODES.items():
        requests[f"sample_with_query {mode}"] = \
            lambda opts=opts: pipe.sample_with_query(
                queries, k_nn=K_NN, top_k=TOP_K, guidance_scale=1.0, seed=1,
                **opts)
        requests[f"sample_unconditional {mode}"] = \
            lambda opts=opts: pipe.sample_unconditional(
                BATCH, k_nn=K_NN, top_k=TOP_K, guidance_scale=2.0,
                qids=qids, seed=2, **opts)
    with torch.inference_mode():
        for guidance in GUIDANCES:      # warm-up at the request shapes
            for mode in (*MODES, "batched"):
                decode(guidance, mode, 4)()
        pipe.first_stage.decode_code(grids)

        out["request_s"] = {k: [] for k in requests}
        for _ in range(args.repeats):
            for kind, fn in requests.items():
                out["request_s"][kind].append(timed(fn))
        for kind, s in out["request_s"].items():
            print(f"request {kind}: s {s}; tokens/s "
                  f"{[BATCH * steps / x for x in s]}", flush=True)

        out["knn_ms"] = event_ms(
            lambda: pipe.retrieval.search(queries, k=K_NN))
        out["decode_code_ms"] = event_ms(
            lambda: pipe.first_stage.decode_code(grids))
        print(f"kNN search of {BATCH} over {emb.shape[0]}x512: "
              f"{out['knn_ms']} ms; VQ-f16 decode_code of {BATCH} grids: "
              f"{out['decode_code_ms']} ms", flush=True)

        pairs = [(gd, mode) for gd in GUIDANCES
                 for mode in (*MODES, "batched")]
        label = {p: f"guidance {p[0]} {p[1]}" for p in pairs}
        out["decode_ms_per_step"] = {label[p]: [] for p in pairs}
        for _ in range(args.repeats):
            for p in pairs:
                out["decode_ms_per_step"][label[p]].append(
                    timed(decode(*p)) * 1e3 / steps)
        for name, ms in out["decode_ms_per_step"].items():
            print(f"decode {steps} steps, {name}: ms per step {ms}",
                  flush=True)

        out["profile"] = {}
        for p in pairs:
            r = profile_decode(decode(*p), steps)
            out["profile"][label[p]] = r
            print(f"profile {label[p]}: wall {r['wall_ms_per_step']:.4f} "
                  f"ms/step, device {r['device_ms_per_step']:.4f} ms/step, "
                  f"idle {r['idle_share']:.4f}, launches/step "
                  f"{r['launches_per_step']:.2f}", flush=True)
            for k in r["top"]:
                print(f"    {k['ms_per_step']:.4f} ms/step "
                      f"{k['share']:7.2%} x{k['per_step']:g}  {k['name']}",
                      flush=True)
    out["card_after"] = card()
    print(out["card_after"], flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
