#!/usr/bin/env python3
"""Where an RDM request's time goes in each serving mode, on one NVIDIA GPU
(rdm_tpu_torch).

    python3 profile_rdm.py [--repeats 3] [--out profile_rdm.json]

Builds the RDM serving pipeline of `chip_smoke.py` phases 5 and 11 twice,
exact bf16 and `int8_weights=True`: the ImageNet RDM U-Net at full width
with a VQ-f4 first stage, random weights from a seed, over the
1,281,280 x 512 table made on the card. The int8 pipeline calibrates on a
first request. Then measures, in this order:

  requests  `sample_with_query` (batch 4, DDIM-50, guidance 2.0, k = 4,
            shared CFG) in seven modes: bf16, bf16 with RDM_TPU_SPLIT_K3=0
            (the single post_ff block kernel), bf16 with encoder_reuse 2
            and 3, int8, int8 with RDM_TPU_INT8_ATTN=1, int8 with
            encoder_reuse 3; alternating, `repeats` times each:
            host-clock seconds around a synchronised call.
  parts     the VQ-f4 decode of 4 latents, bf16 and int8 (median
            CUDA-event ms of 10).
  profile   `torch.profiler` over one U-Net forward at the request's
            shapes (x batch 4, a (cond, uncond) context of 8 rows) per
            mode: the full forward in bf16 (also with RDM_TPU_SPLIT_K3=0)
            and int8 (also with RDM_TPU_INT8_ATTN=1), and the up path
            alone against cached down-path
            features (encoder reuse) in bf16 and int8: device time,
            host-clock wall time of the same synchronised forward, idle
            share (1 - the union of the device intervals / wall),
            launches, device time per kernel, and the attention core's
            (packed_attn: csrc/attn_fwd_sm90.cuh) and the block-GEMM
            core's (ln_qkv, post_cross, geglu_ff:
            csrc/block_gemm_sm90.cuh; apart, its s8 launches of
            ln_qkv_q, post_cross_q and geglu_ff_q) and the int8
            attention core's (packed_attn_q8's three launches) time and
            share.

Prints one line per measurement, the card's name, power limit, SM clock
and power draw first and last, and writes everything to --out as JSON.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

BATCH, K_NN, STEPS, GUIDANCE = 4, 4, 50, 2.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="profile_rdm.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_rdm: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from chip_smoke import SEED, make_table, seeded_state_dict
    from profile_rarm import card, event_ms, profile_decode, timed
    from rdm_tpu_torch.config import AutoencoderConfig, RDMConfig
    from rdm_tpu_torch.models.autoencoder import VQModel
    from rdm_tpu_torch.models.rdm import RDM
    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.pipeline import RDMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool

    out = {"card_before": card()}
    print(out["card_before"], flush=True)
    _build.load()
    cfg, vq_cfg = RDMConfig.imagenet(), AutoencoderConfig.vq_f4()
    with torch.device("meta"):  # shapes only
        rdm, vq = RDM(cfg), VQModel(vq_cfg)
    rdm_sd = seeded_state_dict(rdm, SEED + 10)
    vq_sd = seeded_state_dict(vq, SEED + 11)
    emb = make_table()
    pipes = {mode: RDMPipeline(cfg, rdm_sd, vq_cfg, vq_sd,
                               pool=DataPool(embeddings=emb), device="cuda",
                               int8_weights=mode == "int8")
             for mode in ("bf16", "int8")}
    del rdm_sd, vq_sd
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    queries = torch.randn(BATCH, 512, generator=g, device="cuda")

    def request(mode: str, reuse: int = 1, attn8: bool = False,
                split: bool = True):
        def run():
            os.environ["RDM_TPU_INT8_ATTN"] = "1" if attn8 else "0"
            os.environ["RDM_TPU_SPLIT_K3"] = "1" if split else "0"
            pipes[mode].sample_with_query(
                queries, k_nn=K_NN, steps=STEPS, guidance_scale=GUIDANCE,
                seed=1, encoder_reuse=reuse)
        return run

    def int8_attn(fn):  # fn under RDM_TPU_INT8_ATTN=1
        def run():
            os.environ["RDM_TPU_INT8_ATTN"] = "1"
            fn()
            os.environ["RDM_TPU_INT8_ATTN"] = "0"
        return run

    def single_kernel(fn):  # fn under RDM_TPU_SPLIT_K3=0
        def run():
            os.environ["RDM_TPU_SPLIT_K3"] = "0"
            fn()
            os.environ["RDM_TPU_SPLIT_K3"] = "1"
        return run

    requests = {
        "bf16": request("bf16"),
        "bf16 RDM_TPU_SPLIT_K3=0": request("bf16", split=False),
        "bf16 encoder_reuse=2": request("bf16", 2),
        "bf16 encoder_reuse=3": request("bf16", 3),
        "int8": request("int8"),
        "int8 RDM_TPU_INT8_ATTN=1": request("int8", attn8=True),
        "int8 encoder_reuse=3": request("int8", 3),
    }
    with torch.inference_mode():
        out["int8_first_request_s"] = timed(requests["int8"])
        out["int8_calibration_s"] = pipes["int8"].calibration_seconds
        print(f"int8 first request {out['int8_first_request_s']:.4f} s, "
              f"of which calibration {out['int8_calibration_s']:.4f} s",
              flush=True)
        for fn in requests.values():  # warm-up at the request shapes
            fn()
        out["request_s"] = {k: [] for k in requests}
        for _ in range(args.repeats):
            for kind, fn in requests.items():
                out["request_s"][kind].append(timed(fn))
        for kind, s in out["request_s"].items():
            print(f"request {kind}: s {s}; img/s {[BATCH / x for x in s]}",
                  flush=True)
        os.environ["RDM_TPU_INT8_ATTN"] = "0"
        os.environ["RDM_TPU_SPLIT_K3"] = "1"

        neighbors = pipes["bf16"].retrieval.search(
            queries, k=K_NN)["embeddings"]
        z = torch.randn((BATCH, 3, 64, 64), generator=g, device="cuda")
        out["vq_decode_ms"] = {
            mode: event_ms(lambda: p.first_stage.decode(z))
            for mode, p in pipes.items()}
        print(f"VQ-f4 decode of {BATCH} latents: {out['vq_decode_ms']} ms",
              flush=True)

        out["profile"] = {}
        t = torch.full((BATCH,), 501, device="cuda")
        for mode, p in pipes.items():
            model = p.model
            ctx = model.encode_neighbors(neighbors)
            ctx2 = torch.cat([ctx, model.uncond_context(
                BATCH, ctx.shape[1], 0.0).to(ctx.device)])
            _, cache = model(z, t, ctx2, return_cache=True)
            runs = {"full forward": lambda: model(z, t, ctx2),
                    "up path (reuse)": lambda: model(
                        z, t, ctx2, encoder_cache=cache)}
            if mode == "bf16":
                runs["full forward RDM_TPU_SPLIT_K3=0"] = single_kernel(
                    runs["full forward"])
            else:
                runs["full forward RDM_TPU_INT8_ATTN=1"] = int8_attn(
                    runs["full forward"])
            for kind, fn in runs.items():
                fn()
                r = profile_decode(fn, 1)
                label = f"{mode} {kind}"
                out["profile"][label] = r
                print(f"profile {label}: wall {r['wall_ms_per_step']:.4f} "
                      f"ms, device {r['device_ms_per_step']:.4f} ms, idle "
                      f"{r['idle_share']:.4f}, launches "
                      f"{r['launches_per_step']:.0f}", flush=True)
                for k in r["top"]:
                    print(f"    {k['ms_per_step']:.4f} ms {k['share']:7.2%} "
                          f"x{k['per_step']:g}  {k['name']}", flush=True)
                a, m = r["attn_core"], r["gemm_core"]
                print(f"    attention core (packed_attn): "
                      f"{a['ms_per_step']:.4f} ms {a['share']:7.2%} "
                      f"x{a['per_step']:g}", flush=True)
                print(f"    block-GEMM core (ln_qkv, post_cross, geglu_ff): "
                      f"{m['ms_per_step']:.4f} ms {m['share']:7.2%} "
                      f"x{m['per_step']:g}", flush=True)
                m = r["gemm_s8"]
                print(f"    its s8 launches (ln_qkv_q, post_cross_q, "
                      f"geglu_ff_q): {m['ms_per_step']:.4f} ms "
                      f"{m['share']:7.2%} x{m['per_step']:g}", flush=True)
                m = r["attn8"]
                print(f"    int8 attention core (packed_attn_q8): "
                      f"{m['ms_per_step']:.4f} ms {m['share']:7.2%} "
                      f"x{m['per_step']:g}", flush=True)
    os.environ.pop("RDM_TPU_INT8_ATTN")
    os.environ.pop("RDM_TPU_SPLIT_K3")
    out["card_after"] = card()
    print(out["card_after"], flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
