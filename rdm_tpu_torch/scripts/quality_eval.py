"""Fidelity of the approximate RDM serving modes (int8, encoder reuse)
against the exact sampler.

Runs the exact sampler and each requested mode on the same seed and noise
(`RDMPipeline.fidelity_run`) and reports per-step pred_x0 cosine, final
latent / image PSNR and, with CLIP weights, the CLIP image-image
similarity (`eval/fidelity.compare_runs`); writes the report JSON and a
side-by-side PNG grid (the exact row on top, one row per mode) to --out.

    python -m rdm_tpu_torch.scripts.quality_eval --model_path DIR \
        --database DB [--modes int8,reuse2,reuse3,reuse5,int8+reuse2]
        [--random_init [--randomize_head]] [--device cuda|cpu]

Random weights (--random_init) show the mechanics and relative envelopes
only; the JAX initialisers zero the residual heads, so every mode would
match bit for bit: --randomize_head draws those heads normal(0.02). The
last line of the output is the modes' records as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import zlib

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--database", type=str, default=None)
    p.add_argument("--nn_memory", type=str, default=None)
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="adds the CLIP image-image similarity")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--randomize_head", action="store_true",
                   help="with --random_init: draw the zero-init residual "
                        "heads and eps head normal(0.02), so the modes give "
                        "distinct trajectories")
    p.add_argument("--modes", type=str, default="int8,reuse2,reuse3,reuse5",
                   help="comma list: int8, reuseN, int8+reuseN")
    p.add_argument("-bs", "--batch_size", type=int, default=4)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=2.0)
    p.add_argument("--k_nn", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="out/quality_eval",
                   help="report JSON + PNG grid directory")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def parse_mode(mode: str):
    """"int8", "reuseN" or "int8+reuseN" -> (int8, encoder_reuse)."""
    parts = set(mode.split("+"))
    int8 = "int8" in parts
    parts.discard("int8")
    reuse = 1
    if parts:
        (r,) = parts
        if not r.startswith("reuse"):
            raise SystemExit(f"unknown mode '{mode}'")
        reuse = int(r[5:])
    return int8, reuse


@torch.no_grad()
def randomize_zero_heads(model: torch.nn.Module, seed: int) -> int:
    """Draw every zero-init Linear / Conv weight of `model` (the modules
    `models/init.zero_init` marks) normal(0.02) from `seed`; returns how
    many."""
    g = torch.Generator().manual_seed(seed)
    n = 0
    for m in model.modules():
        if getattr(m, "zero_init", False):
            w = m.weight
            w.copy_((torch.randn(w.shape, generator=g) * 0.02).to(w))
            n += 1
    return n


def write_png(path: str, img: np.ndarray) -> None:
    """An RGB uint8 image [H, W, 3] as a PNG, with the standard library."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in img)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def main(argv=None) -> dict:
    opt = parse_args(argv)
    os.makedirs(opt.out, exist_ok=True)
    from rdm_tpu_torch.eval.fidelity import compare_runs
    from rdm_tpu_torch.pipeline import RDMPipeline, _query_embeddings

    pipe = RDMPipeline.from_model_dir(
        opt.model_path, database=opt.database, nn_memory=opt.nn_memory,
        clip_ckpt=opt.clip_ckpt, random_init=opt.random_init,
        device=opt.device)
    if opt.randomize_head:
        randomize_zero_heads(pipe.model, opt.seed)
    if pipe.retrieval is None:
        raise SystemExit("quality_eval needs a database (a fixed neighbour "
                         "batch)")
    q_emb = _query_embeddings(pipe.retrieval, pipe.memory, opt.batch_size,
                              0.01, False, None, opt.seed)
    neighbors = pipe.retrieval.search(q_emb, k=opt.k_nn)["embeddings"]

    common = dict(steps=opt.steps, guidance_scale=opt.guidance_scale,
                  seed=opt.seed)
    print("running the exact baseline...", flush=True)
    exact = pipe.fidelity_run(neighbors, **common)
    report = {
        "model_path": opt.model_path,
        "random_init": opt.random_init,
        "weights": "random-synthetic" if opt.random_init else "checkpoint",
        "batch": opt.batch_size, "steps": opt.steps,
        "guidance_scale": opt.guidance_scale, "seed": opt.seed,
        "device": str(pipe.device), "modes": {},
    }
    rows = [exact["images"]]
    for mode in [m.strip() for m in opt.modes.split(",") if m.strip()]:
        print(f"running mode {mode}...", flush=True)
        int8, reuse = parse_mode(mode)
        var = pipe.fidelity_run(neighbors, int8=int8, encoder_reuse=reuse,
                                **common)
        rec = compare_runs(exact, var, clip=pipe.clip)
        report["modes"][mode] = rec
        rows.append(var["images"])
        print(f"# {mode}: " + json.dumps(
            {k: v for k, v in rec.items()
             if k != "pred_x0_cosine_per_step"}), flush=True)

    with open(os.path.join(opt.out, "quality_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    grid = np.concatenate([np.concatenate(list(r), axis=1) for r in rows],
                          axis=0)
    write_png(os.path.join(opt.out, "quality_grid.png"), grid)
    print(f"report + grid written to {opt.out}", flush=True)
    print(json.dumps({k: {kk: vv for kk, vv in v.items()
                          if kk != "pred_x0_cosine_per_step"}
                      for k, v in report["modes"].items()}))
    return report


if __name__ == "__main__":
    main()
