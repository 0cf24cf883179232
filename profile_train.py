#!/usr/bin/env python3
"""Where an RDM train step's time goes, on one NVIDIA GPU (rdm_tpu_torch).

    python3 profile_train.py [--batch 40] [--steps 3] [--out profile_train.json]

Builds `chip_smoke.py` phase 16's trainer: the ImageNet RDM U-Net at full
width (random weights from a seed, f32 master weights, bf16 compute) with
a VQ-f4 first stage, p_uncond 0.1, batch `--batch` of random 256^2 images
and neighbours gathered from the 1,281,280 x 512 table made on the card.
After two warm-up steps it measures, for the flash backward kernel and
for the eager-recompute backward (RDM_TPU_FLASH_BWD=xla), in turns:

  step      host-clock seconds of `--steps` synchronised train steps
            (`prepare_batch` + the step: VQ encode, loss, backward,
            optimizer, EMA), their median, samples/s;
  profile   `torch.profiler` over `--steps` steps: device time per step,
            idle share (1 - the union of the device intervals / wall),
            launches per step, and device time by kernel (the flash
            kernels, the first stage's encode and the optimizer's
            foreach kernels among them; the forward kernel, the attention
            core of csrc/attn_fwd_sm90.cuh, and the backward kernel's
            three launches of csrc/flash_attn_bwd.cu (the core's
            statistics instantiation attn_fwd_kernel<D, causal, true>,
            attn_bwd_dkdv_kernel, attn_bwd_dq_kernel), always);
  memory    peak device memory of the steps.

Prints one line per measurement, the card's name, power limit, SM clock
and power draw first and last, and writes everything to --out as JSON.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=40)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="profile_train.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: torch.cuda.is_available() is false; this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import (SEED, _train_batches, make_table,
                            seeded_state_dict)
    from profile_rarm import card, profile_decode, timed
    from rdm_tpu_torch.config import AutoencoderConfig, RDMConfig
    from rdm_tpu_torch.models.autoencoder import VQModel
    from rdm_tpu_torch.models.rdm import RDM
    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.training.trainer import RDMTrainer, TrainerConfig

    out = {"card_before": card(), "batch": args.batch}
    print(out["card_before"], flush=True)
    _build.load()
    cfg = dataclasses.replace(RDMConfig.imagenet(), p_uncond=0.1)
    vq_cfg = AutoencoderConfig.vq_f4()
    with torch.device("meta"):  # shapes only
        rdm, vq = RDM(cfg), VQModel(vq_cfg)
    rdm_sd = seeded_state_dict(rdm, SEED + 10)
    vq_sd = seeded_state_dict(vq, SEED + 11)
    emb = make_table()
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainerConfig(logdir=tmp, image_log_every=0,
                             adam_mu_dtype="bfloat16")
        tr = RDMTrainer(cfg, tcfg, vq_cfg, vq_sd, batch_size=args.batch,
                        device="cuda", init_state_dict=rdm_sd)
        del rdm_sd
        state = tr.init_state()
        batches = _train_batches(emb, args.batch, SEED + 70)

        def steps(n: int):
            nonlocal state
            for _ in range(n):
                z, nns = tr.prepare_batch(next(batches))
                state, _ = tr.step_fn(state, z, nns, tcfg.seed + 1)

        steps(2)  # warm-up
        for mode in ("kernel", "xla", "kernel", "xla"):
            if mode == "xla":
                os.environ["RDM_TPU_FLASH_BWD"] = "xla"
            torch.cuda.reset_peak_memory_stats()
            walls = [timed(lambda: steps(1)) for _ in range(args.steps)]
            rec = out.setdefault(mode, {"step_s": []})
            rec["step_s"] += walls
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            if "profile" not in rec:
                steps(1)  # the other mode's first step is past
                rec["profile"] = profile_decode(lambda: steps(args.steps),
                                                args.steps)
            os.environ.pop("RDM_TPU_FLASH_BWD", None)
            med = float(np.median(rec["step_s"]))
            rec.update(median_step_s=med, samples_per_s=args.batch / med)
            p = rec["profile"]
            print(f"{mode}: steps {[round(w, 4) for w in walls]} s, median "
                  f"{med:.4f} s, {args.batch / med:.2f} samples/s, peak "
                  f"{rec['peak_gib']:.2f} GiB; device "
                  f"{p['device_ms_per_step']:.1f} ms/step of wall "
                  f"{p['wall_ms_per_step']:.1f}, idle {p['idle_share']:.3f}, "
                  f"{p['launches_per_step']:.0f} launches/step", flush=True)
        for mode in ("kernel", "xla"):
            for t in out[mode]["profile"]["top"]:
                print(f"  {mode}: {t['ms_per_step']:9.3f} ms/step "
                      f"{t['share']:.3f} x{t['per_step']:.0f} {t['name']}",
                      flush=True)
            a = out[mode]["profile"]["attn_core"]
            print(f"  {mode}: {a['ms_per_step']:9.3f} ms/step "
                  f"{a['share']:.3f} x{a['per_step']:.0f} attention core "
                  "(flash_fwd)", flush=True)
            a = out[mode]["profile"]["attn_bwd"]
            print(f"  {mode}: {a['ms_per_step']:9.3f} ms/step "
                  f"{a['share']:.3f} x{a['per_step']:.0f} flash backward "
                  "(flash_bwd's statistics, dK / dV and dQ launches)",
                  flush=True)
    out["card_after"] = card()
    print(out["card_after"], flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
