#!/usr/bin/env python3
"""Accuracy of the attention kernels on one NVIDIA GPU (rdm_tpu_torch).

    python3 attn_accuracy.py [TREE]

Runs the port of TREE (a checkout; default: the one holding this script),
so that two trees can be compared on one card in turns, e.g. the parent
commit unpacked by `git archive` into a git-ignored directory, then this
checkout, then this checkout, then the parent:

  forward    flash_fwd at chip_smoke.py phase 15's shapes on seeded bf16
             inputs against the exact attention of the same inputs in
             float64: max|err| / max|o|, relative L2, and the mean signed
             error over mean|o| (a bias);
  backward   flash_bwd's dq, dk and dv at the same shapes against the
             exact gradients of that float64 attention (autograd):
             max|err| / max|ref| and relative L2 of each;
  gradients  one batch-2 train step of the ImageNet RDM on chip_smoke.py's
             seeded (untrained) weights, the bf16 kernel path against the
             CUDA f32 plain path (RDM_TPU_FLASH=0) on the same draws:
             relative L2 and cosine of all gradients, and both losses.

Prints one line per measurement; exits non-zero without CUDA.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from pathlib import Path


def main() -> int:
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("attn_accuracy: torch.cuda.is_available() is false; this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from rdm_tpu_torch.config import AutoencoderConfig, RDMConfig
    from rdm_tpu_torch.models.autoencoder import VQModel
    from rdm_tpu_torch.models.rdm import RDM
    from rdm_tpu_torch.ops import flash_attention as fa
    from rdm_tpu_torch.training.train_state import compute_grads, fold_in
    from rdm_tpu_torch.training.trainer import RDMTrainer, TrainerConfig

    print(f"tree {tree}; {cs.phase_device()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 50)
    for b, s, h, d, causal in cs.FLASH_SHAPES:
        q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda")
                   .bfloat16() for _ in range(3))
        o = fa.flash_fwd(q, k, v, scale=d ** -0.5, causal=causal).double()
        qd, kd, vd = (a.double().transpose(1, 2) for a in (q, k, v))
        sc = qd @ kd.transpose(-1, -2) * d ** -0.5
        if causal:
            sc = sc.masked_fill(~fa._causal_keep(s, s, q.device), -1e9)
        exact = (torch.softmax(sc, -1) @ vd).transpose(1, 2)
        err = o - exact
        print(f"forward [{b},{s},{h},{d}] causal={causal}: max|err|/max|o| "
              f"{(err.abs().max() / exact.abs().max()).item():.4e}, rel L2 "
              f"{(err.norm() / exact.norm()).item():.4e}, bias "
              f"{(err.mean() / exact.abs().mean()).item():+.3e}", flush=True)
        del q, k, v, o, qd, kd, vd, sc, exact, err
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 51)
    for b, s, h, d, causal in cs.FLASH_SHAPES:
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda")
                       .bfloat16() for _ in range(4))
        got = fa.flash_bwd(q, k, v, do, scale=d ** -0.5, causal=causal)
        qkv = [a.double().transpose(1, 2).requires_grad_() for a in (q, k, v)]
        sc = qkv[0] @ qkv[1].transpose(-1, -2) * d ** -0.5
        if causal:
            sc = sc.masked_fill(~fa._causal_keep(s, s, q.device), -1e9)
        out = torch.softmax(sc, -1) @ qkv[2]
        exact = torch.autograd.grad(out, qkv, do.double().transpose(1, 2))
        parts = []
        for name, a, w in zip(("dq", "dk", "dv"), got, exact):
            err = a.double() - w.transpose(1, 2)
            mx = (err.abs().max() / w.abs().max()).item()
            parts.append(f"{name} max|err|/max {mx:.4e} rel L2 "
                         f"{(err.norm() / w.norm()).item():.4e}")
        print(f"backward [{b},{s},{h},{d}] causal={causal}: "
              + ", ".join(parts), flush=True)
        del q, k, v, do, got, qkv, sc, out, exact, err
        torch.cuda.empty_cache()

    cfg = dataclasses.replace(RDMConfig.imagenet(), p_uncond=0.1)
    with torch.device("meta"):  # shapes only
        rdm, vq = RDM(cfg), VQModel(AutoencoderConfig.vq_f4())
    rdm_sd = cs.seeded_state_dict(rdm, cs.SEED + 10)
    vq_sd = cs.seeded_state_dict(vq, cs.SEED + 11)
    emb = cs.make_table(n_db=4096)
    with tempfile.TemporaryDirectory() as tmp:
        tr = RDMTrainer(cfg, TrainerConfig(logdir=tmp, image_log_every=0),
                        AutoencoderConfig.vq_f4(), vq_sd, batch_size=2,
                        device="cuda", init_state_dict=rdm_sd)
        model = tr.init_state().model
        z, nns = tr.prepare_batch(next(cs._train_batches(emb, 2,
                                                         cs.SEED + 61)))
        z = z.float()
        grads, losses = {}, {}
        for path in ("bf16", "f32"):
            if path == "f32":
                os.environ["RDM_TPU_FLASH"] = "0"
                model.unet.dtype = torch.float32
            loss, _, gr = compute_grads(model, z, nns,
                                        fold_in(cs.SEED, 0, "cuda"),
                                        tr.schedule)
            losses[path] = loss.item()
            grads[path] = torch.cat([
                (torch.zeros_like(p) if gr[n] is None else gr[n])
                .reshape(-1).float() for n, p in model.named_parameters()])
        os.environ.pop("RDM_TPU_FLASH")
    gb, gf = grads["bf16"], grads["f32"]
    cos = torch.nn.functional.cosine_similarity(gb, gf, dim=0).item()
    print(f"gradients: rel L2 {((gb - gf).norm() / gf.norm()).item():.4e}, "
          f"cosine {cos:.6f}; loss bf16 {losses['bf16']:.6f}, f32 "
          f"{losses['f32']:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
