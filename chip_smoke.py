#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two serving paths — retrieval-conditioned RDM sampling
at the ImageNet RDM width, and KV-cached RARM token sampling at the
ImageNet-dogs RARM width — through their public entry points, on random
weights made from a seed. Phases (each prints one line or a few; any
failure raises and the script exits non-zero):

  1. device    CUDA must be available; prints nvidia-smi's name and power
               limit of the card.
  2. build     builds the hand-written CUDA kernels from rdm_tpu_torch/csrc.
  3. kernels   each block kernel against its plain PyTorch version at the
               three SpatialTransformer sites of the ImageNet U-Net
               (C/S/heads = 384/1024/12, 576/256/18, 960/64/30; 2B = 8
               images, bf16): error and median CUDA-event times.
  4. forward   one full-width U-Net forward, CUDA bf16 (kernel path)
               against CPU f32 (plain path), x batch 1 with a 2-row
               (cond, uncond) context; each kernel must launch 16 times.
  5. serve     an RDMPipeline over a 1,281,280 x 512 table made on the
               card answers a sample_with_query and a sample_unconditional
               request (batch 4, DDIM-50, guidance 2.0, k = 4, shared CFG).
  6. rarm_kernels  each RARM decode kernel against its plain PyTorch version
               at full width (C = 768, 12 heads of 64, T = 256, F = 3072,
               bf16) at B = 16 and 32, pos 0/63/200/255, k = 4 context
               rows: error and median CUDA-event times; then decode_attn's
               attention output on 24 more seeds (144 cases).
  7. rarm_forward  32 teacher-forced decode steps of the full-width RARM
               (depth 18) through the kernel path, CUDA bf16, against the
               CPU f32 teacher-forced forward over the same tokens.
  8. rarm_serve    a RARMPipeline (VQ-f16 first stage) over phase 5's table
               answers a sample_with_query (batch 16, k = 4, top_k 256,
               guidance 1.0) and a sample_unconditional (batch 16,
               guidance 2.0: a decode batch of 32) request, 256 tokens
               each; then a greedy 32-step decode with the batched
               commit_rows path must give the default path's tokens.

The second-to-last line is one JSON object with the per-kernel numbers. For
the block kernels `ms` / `plain_ms` are the sum over the three sites of the
median kernel / plain-version times, `max_abs_err` the largest over the
sites and `launches` the count over the two RDM serve requests; for the
decode kernels `ms` / `plain_ms` are the mean over the eight (B, pos) cases,
`max_abs_err` the largest, and `launches` the count over the two RARM
requests (`commit_rows`: over the batched-commit decode, the path that
runs it). The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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
    "geglu_ff": ("rdm_tpu_torch/csrc/geglu_ff.cu",
                 "rdm_tpu/ops/block_kernel.py:423"),
}
DECODE_INFO = {
    "decode_attn": ("rdm_tpu_torch/csrc/decode_attn.cu",
                    "rdm_tpu/ops/decode_kernel.py:135",
                    ["rdm_tpu_torch/csrc/decode_qkv.cu",
                     "rdm_tpu_torch/csrc/decode_attn.cu"]),
    "decode_post_ff": ("rdm_tpu_torch/csrc/decode_post_ff.cu",
                       "rdm_tpu/ops/decode_kernel.py:275",
                       ["rdm_tpu_torch/csrc/decode_post_ff.cu",
                        "rdm_tpu_torch/csrc/geglu_ff.cu"]),
    "commit_rows": ("rdm_tpu_torch/csrc/commit_rows.cu",
                    "rdm_tpu/ops/decode_kernel.py:352",
                    ["rdm_tpu_torch/csrc/commit_rows.cu"]),
}
RARM_BATCHES = (16, 32)           # B = 16, and 32 under CFG
RARM_POSITIONS = (0, 63, 200, 255)
RARM_SWEEP_SEEDS = 24             # more inputs for decode_attn's attention
RARM_FORWARD_STEPS = 32
# CUDA bf16 decode path vs CPU f32 teacher-forced forward, relative L2 of
# the logits: bf16 activations through 18 residual layers, as the U-Net's.
RARM_FORWARD_TOL = 3e-2


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


def _site_tensors(c: int, s: int, heads: int, g: torch.Generator):
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
        x=rn(CFG_BATCH, s, c), ck=rn(CFG_BATCH, CONTEXT, c),
        cv=rn(CFG_BATCH, CONTEXT, c),
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


def phase_kernels() -> dict:
    """Per kernel: {'max_abs_err', 'ms', 'plain_ms', 'sites': [...]}."""
    from rdm_tpu_torch.ops import block_kernel as bk

    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
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
        calls = {
            "ln_qkv": (lambda: bk.ln_qkv(x2, t["n1s"], t["n1b"], t["wqkv"]),
                       lambda: bk.ln_qkv_reference(x2, t["n1s"], t["n1b"],
                                                   t["wqkv"])),
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
            say("kernels", f"{name:11s} C={c:4d} S={s:4d} heads={heads:2d}: "
                f"max|err| {err:.4g}, /max|ref| {rel:.3e} (limit "
                f"{KERNEL_TOL:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms")
            if not rel <= KERNEL_TOL:
                raise RuntimeError(f"{name} at C={c}: relative error {rel} "
                                   f"> {KERNEL_TOL}")
            res = results[name]
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            res["sites"].append({"C": c, "S": s, "heads": heads,
                                 "max_abs_err": err, "rel_err": rel,
                                 "ms": ms, "plain_ms": plain_ms})
    return results


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
    if any(n != 16 for n in counts.values()):
        raise RuntimeError(f"expected 16 launches per kernel, got {counts}")
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
        if any(n != want for n in counts.values()):
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
                      "cases": []} for name in DECODE_INFO}
    for b in RARM_BATCHES:
        t = _decode_tensors(b, g)
        caches_k = [a.clone() for a in t["caches"]]
        caches_p = [a.clone() for a in t["caches"]]
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
                "commit_rows": (
                    lambda: dk.commit_rows(pos, caches_k, t["rows"]),
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
                    detail = "; ".join(f"{lab} {rel:.3e}"
                                       for lab, _, rel in errs[1:])
                    detail += "; cache rows exact"
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
                    detail = ""
                _, err, rel = errs[0]
                ms, plain_ms = median_ms(kern), median_ms(plain)
                say("rarm_kernels", f"{name:14s} {what:13s}: max|err| "
                    f"{err:.4g}, /max|ref| {rel:.3e} (limit {KERNEL_TOL:g})"
                    f"{'; ' + detail if detail else ''}; kernel {ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms")
                res = results[name]
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["cases"].append({
                    "B": b, "pos": pos, "max_abs_err": err,
                    "rel_err": {lab: r for lab, _, r in errs}, "ms": ms,
                    "plain_ms": plain_ms})
        del t, caches_k, caches_p, kc_k, vc_k, kc_p, vc_p
        torch.cuda.empty_cache()
    for res in results.values():
        n = len(res["cases"])
        res["ms"] = sum(c["ms"] for c in res["cases"]) / n
        res["plain_ms"] = sum(c["plain_ms"] for c in res["cases"]) / n

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
        want = {"decode_attn": per_request * (i + 1),
                "decode_post_ff": per_request * (i + 1), "commit_rows": 0}
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

    phase_device()
    phase_build()
    kernels = phase_kernels()
    with torch.device("meta"):  # shapes only
        rdm, vq = RDM(RDMConfig.imagenet()), VQModel(AutoencoderConfig.vq_f4())
        rarm = RARM(RARMConfig.imagenet_dogs())
        vq16 = VQModel(AutoencoderConfig.vq_f16())
    rdm_sd = seeded_state_dict(rdm, SEED + 10)
    vq_sd = seeded_state_dict(vq, SEED + 11)
    phase_forward(rdm_sd)
    emb = make_table()
    launches = phase_serve(rdm_sd, vq_sd, emb)
    del rdm_sd, vq_sd
    decode = phase_rarm_kernels()
    rarm_sd = seeded_state_dict(rarm, SEED + 12)
    phase_rarm_forward(rarm_sd)
    decode_launches = phase_rarm_serve(
        rarm_sd, seeded_state_dict(vq16, SEED + 13), emb)
    rows = [{"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
             "replaces": KERNEL_INFO[name][1], "launches": launches[name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "sites": r["sites"]}
            for name, r in kernels.items()]
    rows += [{"name": name, "route": "cuda", "source": DECODE_INFO[name][0],
              "sources": DECODE_INFO[name][2],
              "replaces": DECODE_INFO[name][1],
              "launches": decode_launches[name],
              "max_abs_err": r["max_abs_err"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "cases": r["cases"],
              **({"sweep_rel_err": r["sweep_rel_err"]}
                 if "sweep_rel_err" in r else {})}
             for name, r in decode.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
