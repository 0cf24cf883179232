#!/usr/bin/env python3
"""Where the block-GEMM core's time goes, on one NVIDIA GPU.

    python3 profile_gemm.py [--decode] [--out profile_gemm.json]
    python3 profile_gemm.py --host TREE [TREE ...] [--int8] [--out FILE]
    python3 profile_gemm.py --tiles [--out FILE]
    python3 profile_gemm.py --attn [--out FILE]
    python3 profile_gemm.py --int8 [--out FILE]
    python3 profile_gemm.py --tiles8 [KIND ...] [--out FILE]
    python3 profile_gemm.py --ff [--out FILE]

Builds the launchers of `ln_qkv`, `post_cross`, `geglu_ff`, the RARM
decode chain `decode_post_ff` and `decode_attn` (rdm_tpu_torch/csrc/
ln_qkv.cu, post_cross.cu, geglu_ff_sm90.cu, decode_post_ff.cu,
decode_attn.cu) over
rdm_tpu_torch/csrc/block_gemm_sm90.cuh with nvcc as they are, and with
one part of the core cut each time: the wgmma products, the LayerNorm
prologue's arithmetic (its rows still arrive by TMA), the epilogues, the
GEGLU's erf; for the decode chain also programmatic dependent launch
(plain stream launches instead), the int8 weights' conversion to bf16
and rank 0's sum of the K split's partial tiles. Each build runs in a
process of its own and times the three U-Net wrappers at chip_smoke.py
phase 3's three U-Net sites (8 images, its tensors) and `decode_post_ff`
(bf16 and int8 weights) at decode batch 16 and 32 (chip_smoke.py phase
7's tensors, C = 768, F = 3072, 4 context rows), and decode_attn's
projection alone (its kQkv launch, bf16 and int8 weights), in CUDA
graphs, each
launch by torch.profiler over the graph's replays (chip_smoke.py
`graph_ms`, `graph_launch_ms`); the uncut build also times the decode
chain with its K split turned off (KS = 1 in every plan). With --decode,
only the decode chain is timed. The cut builds' outputs are wrong by
design; only their time is read. Prints one JSON
line per build and writes them all to --out, with the card's name and
power limit.

With --host (and --int8: the int8 block wrappers alone), builds nothing
of its own: for each TREE in the order given
(a checkout of this repo, such as an older commit unpacked by `git
archive`; `.` for this one), a process of its own imports that tree's
`rdm_tpu_torch`, builds its kernels and times its `ln_qkv`, `post_cross`
and `geglu_ff` wrappers at the same sites on the same seeded tensors, and
its `post_ff` at the same sites, its `decode_post_ff` (bf16 and int8
weights) at decode batch 16 and 32, its `commit_rows` over the 36 caches
of a decode step at decode batch 16 and 32 and pos 0 / 63 / 200 / 255
(the call its decode step makes, a `RowCommit` built once where the tree
has one, and `commit_rows` itself; also kernel ms, the median CUDA-event
time of a call), and its `decode_attn` in each variant (bf16, int8 weights, int8 cache,
both) at decode batch 16 and 32 and pos 0 / 63 / 200 / 255 (chip_smoke.py
phase 6's tensors, C = 768, T = 256), and its int8 block wrappers
`ln_qkv_q`, `packed_attn_q8`, `post_cross_q` and `geglu_ff_q` at the U-Net
sites (phase 9's tensors and scales, with the share of hidden codes that
differ from the plain int8 math): host us a call (chip_smoke.py
`host_us`) and device ms a call
(`graph_ms`); and `decode_attn`'s two
launches alone, both and each apart (its C entry points on arguments made
once: the rest of a wrapper call is its Python), with each tree's mean
over the positions. Naming two trees in turns (A B B A) compares their
host cost and device time in one run.

With --tiles, times `ln_qkv` through each tile that
`block_kernel.GEMM_TILES["qkv"]` lists, forced alone (the ring depth and
column tiles a CTA as `gemm_plan` sets them for it), at the three sites at
2, 8 and 32 images, each output held against the plain version
(chip_smoke.py KERNEL_TOL), beside the plan `gemm_plan` picks: device ms
a call in a CUDA graph.

With --attn, builds `decode_attn`'s launcher (rdm_tpu_torch/csrc/
decode_attn.cu over the core's header) as it is and with one part of its
attention launch cut: the consumers' arithmetic (they still wait for
every box and hand it back), or the cache loads (no TMA: the consumers
read whatever the ring holds), or the int8 cache's commit of row pos.
Each build, in a process of its own,
runs the projection once and then times the attention launch alone (a
plain stream launch) at decode batch 16 and 32, pos 63 / 200 / 255, with
bf16 and int8 caches, in CUDA graphs of 20 calls: warm (the same caches
each call, so the rows may stay in the 50 MB L2) and cold (20 sets of
caches in turn, 250-500 MB, as the RARM step's 18 layers read theirs);
the uncut build also times SDPA over the same rows, warm and cold.

With --int8, builds the launchers of the int8 block's `ln_qkv_q`,
`post_cross_q` and `geglu_ff_q` (rdm_tpu_torch/csrc/ln_qkv_q.cu,
post_cross_q.cu, geglu_ff_q.cu: the core's s8 launches) and
`packed_attn_q8` (csrc/packed_attn_q8.cu, which only the ex2 cut touches)
as they are and with one part cut: the code prologue (no row loads,
LayerNorm or quantization: the panel keeps whatever it holds), the s8
wgmma products, the epilogues, the GEGLU's erf, the int8 attention's ex2
(p = its argument: the SFU's share), its K and V tile loads (the ring's
barriers arrive with no copy: the TMA and L2 share) or the products of
its first pass over the keys (the tiles still awaited). Each build, in a
process of its
own, times the four wrappers at chip_smoke.py phase 9's three sites (8
images, its int8 weights and scales) in CUDA graphs, each launch by
torch.profiler (packed_attn_q8's absmax, codes and attention).

With --tiles8, times the int8 block's s8 launches through each tile of
their kinds (`block_kernel.GEMM_TILES` "resq8", "cross8", "residual8",
"geglu8", "qkv8"), one kind's tiles forced alone at a time (ring depth
and column tiles a CTA as `gemm_plan` sets them for it), at the three
sites at 2, 8 and 32 images: the device ms of each launch of the wrapper
that runs the kind (post_cross_q, geglu_ff_q for "geglu8", ln_qkv_q for
"qkv8"; "residual8" in post_cross_q and geglu_ff_q), in a CUDA graph,
beside the plan `gemm_plan` picks; each output held against the plain
version (chip_smoke.py KERNEL_TOL). Naming kinds times those alone.

With --ff, builds `post_ff`'s launcher (rdm_tpu_torch/csrc/post_ff.cu,
with post_cross.cu, whose three launches it runs first, and
geglu_ff_sm90.cu, the split pair's other half) over the core's
header as it is and with one part of its FF launch (block_gemm_ff_kernel)
cut: the GEGLU epilogue (no f written: the slice keeps whatever it
holds), the K split's sum across the cluster (no partial unit sent, an
owner's sum its own slot alone; the cluster barriers stay), the LN3
arithmetic (xm's rows still arrive by TMA), the wgmma products, or the
weight loads (each ring stage's barrier arrives with no copy). Each build,
in a process of its own, times `post_ff` at chip_smoke.py phase 3's three
sites (8 images, its tensors): device ms a call in a CUDA graph and each
of its four launches by torch.profiler; the uncut build also times the
FF launch at every cluster size `ff_plan` fits at each site (the plan's
own marked), and the split pair (`post_cross`, `geglu_ff`) beside it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

# (text of block_gemm_sm90.cuh, its replacement), or several, of each cut
CUTS = {
    "kernel": None,
    "no wgmma": ("            wgmma_ss_mn<BN>(",
                 "            if (p.R < 0) wgmma_ss_mn<BN>("),
    "no LayerNorm arithmetic": (
        "  for (int r0 = warp; r0 < rows; r0 += 2 * kWarps) {",
        "  for (int r0 = warp; r0 < 0; r0 += 2 * kWarps) {"),
    "no epilogue": ("    const int n0 = t * BN;\n#pragma unroll\n",
                    "    if (p.R > 0) continue;\n"
                    "    const int n0 = t * BN;\n#pragma unroll\n"),
    "no erf": (("          f[e] = av * (0.5f * gv * (1.0f + erff(gv * "
                "0.7071067811865476f)));",
                "          f[e] = av * gv;"),
               ("          f[u] = av * (0.5f * gv * (1.0f + erff(gv * "
                "0.7071067811865476f)));",
                "          f[u] = av * gv;")),
    "no PDL": ("    attr[n].val.programmaticStreamSerializationAllowed = 1;",
               "    attr[n].val.programmaticStreamSerializationAllowed = 0;"),
    "no int8 conversion": ("        convert_w8<NW>(",
                           "        if (p.R < 0) convert_w8<NW>("),
    "no K-split sum": ("        for (int r = 1; r < (live ? ks : 1); ++r)",
                       "        for (int r = 1; r < (p.R < 0 ? ks : 1); ++r)"),
}
LAUNCHERS = ("ln_qkv.cu", "post_cross.cu", "geglu_ff_sm90.cu",
             "decode_post_ff.cu", "decode_attn.cu")
# (text of block_gemm_sm90.cuh, its replacement) of each cut of the s8
# launches (--int8)
INT8_CUTS = {
    "kernel": None,
    "no code prologue": (
        "  for (int r0 = warp; r0 < BM; r0 += 2 * kWarps) {",
        "  for (int r0 = warp; r0 < 0; r0 += 2 * kWarps) {"),
    "no s8 wgmma": ("            wgmma_s8<BN>(acc[w][m], da,",
                    "            if (p.R < 0) wgmma_s8<BN>(acc[w][m], da,"),
    "no epilogue": ("    const int n0 = t * BN;  // the tile's first column\n",
                    "    if (p.R > 0) continue;\n"
                    "    const int n0 = t * BN;  // the tile's first column\n"),
    "no erf": ("              av * (0.5f * gv * (1.0f + erff(gv * "
               "0.7071067811865476f)));",
               "              av * gv;"),
    "no ex2": (
        "          const float pe = attn::ex2(__int_as_float(cur[idx]));",
        "          const float pe = __int_as_float(cur[idx]);"),
    "no attention loads": (
        "    attn::mbar_expect_tx(bar, L::kKTile + (u < nkt ? 0 : "
        "L::kVTile));\n"
        "    attn::tma_load(tk, st, bar, 0, h, t * kKeys, b);\n"
        "    if (u >= nkt)\n"
        "      attn::tma_load_2d(tv, st + L::kKTile, bar, t * kKeys, b * C + "
        "h * D);\n",
        "    attn::mbar_arrive(bar);\n"),
    "no pass-1 products": (
        "    issue_qk(sa, i);\n    issue_qk(sb, i + 1);\n",
        "    attn::mbar_wait(full + 8 * (i % kRing), (i / kRing) & 1);\n"
        "    attn::mbar_wait(full + 8 * ((i + 1) % kRing), "
        "((i + 1) / kRing) & 1);\n"),
}
# the file a cut patches, where it is not the core's header
CUT_FILES = {"no PDL": "attn_fwd_sm90.cuh",
             "no ex2": "packed_attn_q8.cu",
             "no attention loads": "packed_attn_q8.cu",
             "no pass-1 products": "packed_attn_q8.cu"}
INT8_LAUNCHERS = ("ln_qkv_q.cu", "post_cross_q.cu", "geglu_ff_q.cu",
                  "packed_attn_q8.cu")
# (text of block_gemm_sm90.cuh, its replacement), or several, of each cut
# of post_ff's FF launch (--ff)
FF_CUTS = {
    "kernel": None,
    "no GEGLU epilogue": (
        "    ff_geglu_smem(acc, p, gbase + (fs - base), lt, (f0 + lt) * 64, "
        "r_in, q);",
        "    if (p.R < 0) ff_geglu_smem(acc, p, gbase + (fs - base), lt, "
        "(f0 + lt) * 64, r_in, q);"),
    "no reduction": (("        if (u >= u1) break;\n",
                      "        if (u >= u1 || p.R > 0) break;\n"),
                     ("      for (int j = 1; j < n; ++j)\n",
                      "      for (int j = 1; j < (p.R < 0 ? n : 1); ++j)"
                      "\n")),
    "no LN3": CUTS["no LayerNorm arithmetic"],
    "no wgmma": (("        wgmma_ss_mn<128>(\n            acc,\n",
                  "        if (p.R < 0) wgmma_ss_mn<128>(\n"
                  "            acc,\n"),
                 ("          wgmma_ss_mn<128>(\n              acc,\n",
                  "          if (p.R < 0) wgmma_ss_mn<128>(\n"
                  "              acc,\n")),
    "no weight loads": (
        ("      mbar_expect_tx(bar, kFFStage);\n"
         "      tma_load_2d(&twa, st, bar, col, k0);\n"
         "      tma_load_2d(&twg, st + kFFBox, bar, col, k0);\n",
         "      mbar_arrive(bar);\n"),
        ("      mbar_expect_tx(bar, nbox * kFFBox);\n"
         "      for (int b = 0; b < nbox; ++b)\n"
         "        tma_load_2d(&tw2, st + b * kFFBox, bar, n0 + 64 * b, k0);\n",
         "      mbar_arrive(bar);\n")),
}
FF_LAUNCHERS = ("post_ff.cu", "post_cross.cu", "geglu_ff_sm90.cu")
FF_RANKS = range(2, 17)  # the cluster sizes the uncut --ff build tries
DECODE_BATCHES = (16, 32)  # chip_smoke.py RARM_BATCHES
ATTN_POSITIONS = (0, 63, 200, 255)  # chip_smoke.py RARM_POSITIONS
TILE_IMAGES = (2, 8, 32)
HERE = os.path.dirname(os.path.abspath(__file__))
HEADER = "block_gemm_sm90.cuh"


# (text of decode_attn.cu, its replacement) of each attention cut
ATTN_SOURCE = "decode_attn.cu"
ATTN_CUTS = {
    "kernel": None,
    "no attention arithmetic": (
        "    mbar_wait(full + 8 * s, (i / ST) & 1);\n",
        "    mbar_wait(full + 8 * s, (i / ST) & 1);\n"
        "    if (p.pos >= 0) {\n      __syncwarp();\n"
        "      if (lane == 0) mbar_arrive(empty + 8 * s);\n"
        "      continue;\n    }\n"),
    "no cache loads": (
        "      mbar_expect_tx(bar, 2 * kBox);\n"
        "      tma_load_2d(&tk, st, bar, c0, t0 + i * kRB);\n"
        "      tma_load_2d(&tv, st + kBox, bar, c0, t0 + i * kRB);\n",
        "      mbar_arrive(bar);\n"),
    "no int8 commit": ("      commit_int8_row(p, b, lane, rowf, cbar);",
                       "      if (p.pos < 0) commit_int8_row(p, b, lane, "
                       "rowf, cbar);"),
}
ATTN_TIMED = (63, 200, 255)
COLD_SETS = 20


def build_dir(variant: str) -> str:
    return os.path.join(tempfile.gettempdir(), "profile_gemm",
                        variant.replace(" ", "_"))


def build(variant: str, int8: bool = False,
          ff: bool = False) -> subprocess.Popen:
    """Starts nvcc on the launchers (the int8 block's with int8, post_ff's
    with ff) over the cut header, in a directory of the build's own (a
    quoted include finds the cut header beside the launchers first)."""
    from rdm_tpu_torch.ops import _build

    out = build_dir(("int8 " if int8 else "ff " if ff else "") + variant)
    launchers = (INT8_LAUNCHERS if int8 else FF_LAUNCHERS if ff
                 else LAUNCHERS)
    os.makedirs(out, exist_ok=True)
    target = CUT_FILES.get(variant, HEADER)
    files = {n: (_build.CSRC / n).read_text()
             for n in {HEADER, target, *launchers}}
    src = files[target]
    cut = (INT8_CUTS if int8 else FF_CUTS if ff else CUTS)[variant]
    pairs = () if cut is None else cut if isinstance(cut[0], tuple) else (cut,)
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"{target} changed; update profile_gemm.py's "
                               f"cut {variant!r}")
        src = src.replace(old, new)
    files[target] = src
    for name, text in files.items():
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    return subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", "-o", os.path.join(out, "lib.so"),
         *(os.path.join(out, n) for n in launchers),
         str(_build.CSRC / "runtime.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_attn(variant: str) -> subprocess.Popen:
    """Starts nvcc on decode_attn.cu with the attention cut `variant`, over
    the core's header as it is, in a directory of the build's own."""
    from rdm_tpu_torch.ops import _build

    out = build_dir("attn " + variant)
    os.makedirs(out, exist_ok=True)
    src = (_build.CSRC / ATTN_SOURCE).read_text()
    cut = ATTN_CUTS[variant]
    pairs = () if cut is None else cut if isinstance(cut[0], tuple) else (cut,)
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"{ATTN_SOURCE} changed; update "
                               f"profile_gemm.py's cut {variant!r}")
        src = src.replace(old, new)
    with open(os.path.join(out, ATTN_SOURCE), "w") as f:
        f.write(src)
    return subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", "-o", os.path.join(out, "lib.so"),
         os.path.join(out, ATTN_SOURCE), str(_build.CSRC / "runtime.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def run_attn(variant: str) -> dict:
    """The attention launch's device ms through the variant's library, warm
    and cold, per decode batch, position and cache type (and SDPA's in the
    uncut build)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.ops import block_kernel as bk
    from rdm_tpu_torch.ops import decode_kernel as dk

    lib = ctypes.CDLL(os.path.join(build_dir("attn " + variant), "lib.so"))
    for name in ("rdm_decode_proj", "rdm_decode_attn"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {"build": variant, "cases": []}

    def p(a):
        return None if a is None else a.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for b in DECODE_BATCHES:
        t = cs._int8_layer(cs._decode_tensors(b, g))
        x, c = t["x"], t["x"].shape[1]
        sms = bk.sm_count(x.device.index)
        proj = bk.gemm_plan("qkv", b, 3 * c, c, sms, split_k=True)
        q, kn, vn, o = (torch.empty_like(x) for _ in range(4))
        f32 = [torch.empty((b, c), device="cuda") for _ in range(2)]
        if lib.rdm_decode_proj(p(x), p(t["n1s"]), p(t["n1b"]), p(t["wqkv"]),
                               None, p(q), p(kn), p(vn), p(f32[0]),
                               p(f32[1]), b, c, *proj.args, proj.ks, 0,
                               stream()):
            raise RuntimeError("rdm_decode_proj failed")
        for kv8 in (False, True):
            names = ("kc8", "vc8", "ks", "vs") if kv8 else ("kc", "vc")
            sets = [[t[n].clone() for n in names] for _ in range(COLD_SETS)]
            for pos in ATTN_TIMED:
                ap = dk.attn_plan(b, 12, pos, sms)

                def attention(cs_):
                    sc = (cs_[2], cs_[3], f32[0], f32[1]) if kv8 else \
                        (None,) * 4
                    rc = lib.rdm_decode_attn(
                        p(q), p(kn), p(vn), p(cs_[0]), p(cs_[1]),
                        *(p(a) for a in sc), p(o), pos, cs_[0].shape[0], b,
                        c, 12, 64 ** -0.5 * cs.LOG2E, ap.group, ap.splits,
                        ap.rows, 0, stream())
                    if rc:
                        raise RuntimeError(f"rdm_decode_attn: {rc}")

                turn = iter(range(10 ** 9))
                case = {"B": b, "pos": pos, "kv8": kv8, "ctas": ap.ctas,
                        "warm_ms": cs.graph_ms(lambda: attention(sets[0])),
                        "cold_ms": cs.graph_ms(lambda: attention(
                            sets[next(turn) % COLD_SETS]))}
                if variant == "kernel":
                    def bhsd(a, n):
                        return a.reshape(n, b, 12, 64).permute(
                            1, 2, 0, 3).contiguous()

                    def sdpa_in(cs_):
                        k, v = cs_[0][:pos], cs_[1][:pos]
                        if kv8:
                            k = (k.float() * cs_[2][:pos]).bfloat16()
                            v = (v.float() * cs_[3][:pos]).bfloat16()
                        return (bhsd(q, 1), bhsd(torch.cat([k, kn[None]]),
                                                 pos + 1),
                                bhsd(torch.cat([v, vn[None]]), pos + 1))
                    ins = [sdpa_in(cs_) for cs_ in sets]
                    turn = iter(range(10 ** 9))
                    case["sdpa_warm_ms"] = cs.graph_ms(
                        lambda: F.scaled_dot_product_attention(*ins[0]))
                    case["sdpa_cold_ms"] = cs.graph_ms(
                        lambda: F.scaled_dot_product_attention(
                            *ins[next(turn) % COLD_SETS]))
                    del ins
                out["cases"].append(case)
            del sets
        del t
        torch.cuda.empty_cache()
    return out


def attn_builds(card: str, path: str) -> int:
    """Builds every attention variant at once, runs each in a process of
    its own, one at a time; prints a line a case, writes all to `path`."""
    procs = {v: build_attn(v) for v in ATTN_CUTS}
    for v, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v!r}:\n{log}")
    results = {"card": card, "builds": []}
    for v in ATTN_CUTS:
        proc = subprocess.run([sys.executable, __file__, "--attn-build", v],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{v!r} failed:\n{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        for case in r["cases"]:
            sdpa = (f"; SDPA warm {case['sdpa_warm_ms']:.4f}, cold "
                    f"{case['sdpa_cold_ms']:.4f}" if "sdpa_warm_ms" in case
                    else "")
            print(f"{v:24s} B={case['B']:2d} pos={case['pos']:3d} "
                  f"{'int8' if case['kv8'] else 'bf16'} cache "
                  f"({case['ctas']} CTAs): attention warm "
                  f"{case['warm_ms']:.4f} ms, cold {case['cold_ms']:.4f}"
                  f"{sdpa}", flush=True)
        results["builds"].append(r)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


def run_build(variant: str, decode_only: bool) -> dict:
    """Times the three U-Net wrappers (unless decode_only) and the decode
    chain through the variant's library."""
    import torch

    import chip_smoke as cs
    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.ops import block_kernel as bk

    lib = ctypes.CDLL(os.path.join(build_dir(variant), "lib.so"))
    for name in ("rdm_ln_qkv", "rdm_post_cross", "rdm_geglu_ff_sm90",
                 "rdm_decode_post_ff", "rdm_decode_proj"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.rdm_error_string.argtypes = [ctypes.c_int]
    lib.rdm_error_string.restype = ctypes.c_char_p
    _build._lib = lib  # the wrappers launch this build
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {"build": variant, "sites": []}
    for c, s, heads in () if decode_only else cs.SITES:
        t = cs._site_tensors(c, s, heads, g)
        attn = 0.5 * torch.randn(t["x"].shape, generator=g, device="cuda",
                                 dtype=torch.bfloat16)
        for name, calls in cs._gemm_calls(t, attn, heads).items():
            parts = cs.graph_launch_ms(calls[0], len(cs.GEMM_LAUNCHES[name]),
                                       "block_gemm_kernel")
            out["sites"].append({
                "name": name, "C": c, "S": s,
                "device_ms": cs.graph_ms(calls[0]),
                "launch_device_ms": parts and dict(
                    zip(cs.GEMM_LAUNCHES[name], parts))})
        del t, attn
    out["decode"] = decode_times(cs, g)
    if variant == "kernel":  # the same launches without the K split
        bk._MAX_KS = 1
        bk.gemm_plan.cache_clear()
        out["decode_ks1"] = decode_times(cs, g)
    return out


def _int8_args(cs, t: dict, s: int, heads: int):
    """post_cross_q's and geglu_ff_q's arguments on chip_smoke.py phase
    9's int8 weights and scales of one site's tensors, the weights, the
    scales, xm2, ln_qkv_q's arguments and packed_attn_q8's q, k, v."""
    w, a, (q, k, v, attn, xm2) = cs._site_int8(t, s, heads)
    pc = (t["x"], attn, t["ck"], t["cv"], w["wo_q"], w["wo_s"], w["bo"],
          w["n2s"], w["n2b"], w["wq2_q"], w["wq2_s"], w["wo2_q"],
          w["wo2_s"], w["bo2"], a["o_attn1"], a["a_attn2"], a["o_attn2"])
    ff = (xm2, w["n3s"], w["n3b"], w["wa_q"], w["wa_s"], w["wg_q"],
          w["wg_s"], w["ba"], w["bg"], w["w2_q"], w["w2_s"], w["b2"],
          a["a_ff"], a["h_ff"])
    c = t["x"].shape[-1]
    qkv = (t["x"].reshape(-1, c), w["n1s"], w["n1b"], w["wqkv_q"],
           w["wqkv_s"], a["a_qkv"])
    return pc, ff, w, a, xm2, qkv, (q, k, v)


def int8_plain(cs, t: dict, s: int, heads: int) -> dict:
    """The int8 block wrappers' plain outputs, flattened."""
    from rdm_tpu_torch.ops import block_kernel as bk

    pc, ff, _, _, _, qkv, attn_in = _int8_args(cs, t, s, heads)
    hd = t["x"].shape[-1] // heads
    return {"ln_qkv_q": cs._flat(bk.ln_qkv_q_reference(*qkv)),
            "packed_attn_q8": cs._flat(bk.packed_attn_q8_reference(
                *attn_in, heads=heads, head_dim=hd)),
            "post_cross_q": cs._flat(bk.post_cross_q_reference(
                *pc, heads=heads, head_dim=hd)),
            "geglu_ff_q": cs._flat(bk.geglu_ff_q_reference(*ff))}


def int8_calls(cs, t: dict, s: int, heads: int) -> tuple:
    """The int8 block wrappers (ln_qkv_q, packed_attn_q8, post_cross_q,
    geglu_ff_q) on chip_smoke.py phase 9's int8 weights and scales of one
    site's tensors: ({name: call}, a function that runs geglu_ff_q into a
    hidden buffer and returns the share of its codes that differ from the
    plain int8 math's)."""
    import torch

    from rdm_tpu_torch.ops import block_kernel as bk

    pc, ff, w, a, xm2, qkv, attn_in = _int8_args(cs, t, s, heads)
    hd = t["x"].shape[-1] // heads
    hidden = torch.empty((xm2.shape[0], 4 * xm2.shape[1]), dtype=torch.int8,
                         device="cuda")
    calls = {"ln_qkv_q": lambda: bk.ln_qkv_q(*qkv),
             "packed_attn_q8": lambda: bk.packed_attn_q8(
                 *attn_in, heads=heads, head_dim=hd),
             "post_cross_q": lambda: bk.post_cross_q(*pc, heads=heads,
                                                     head_dim=hd),
             "geglu_ff_q": lambda: bk.geglu_ff_q(*ff)}

    def differ():
        bk.geglu_ff_q(*ff, hidden=hidden)
        return cs.hidden_codes_differ(xm2, w, a, hidden)

    return calls, differ


def _launches8(cs, name: str, fn):
    """Each launch's device ms of an int8 wrapper's call, by name, or None
    where the profiler saw another count."""
    names, match = ((cs.ATTN8_LAUNCHES, "attn8::")
                    if name == "packed_attn_q8" else
                    (cs.INT8_GEMM_LAUNCHES[name], "block_gemm_s8_kernel"))
    parts = cs.graph_launch_ms(fn, len(names), match)
    return parts and dict(zip(names, parts))


def run_build_int8(variant: str) -> dict:
    """Times the int8 block wrappers through the variant's library of the
    int8 launchers, per launch, at phase 9's sites."""
    import torch

    import chip_smoke as cs
    from rdm_tpu_torch.ops import _build

    lib = ctypes.CDLL(os.path.join(build_dir("int8 " + variant), "lib.so"))
    for name in ("rdm_ln_qkv_q", "rdm_packed_attn_q8", "rdm_post_cross_q",
                 "rdm_geglu_ff_q"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.rdm_error_string.argtypes = [ctypes.c_int]
    lib.rdm_error_string.restype = ctypes.c_char_p
    _build._lib = lib  # the wrappers launch this build
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 20)
    out = {"build": variant, "sites": []}
    for c, s, heads in cs.SITES:
        t = cs._site_tensors(c, s, heads, g)
        calls, _ = int8_calls(cs, t, s, heads)
        with torch.inference_mode():
            for name, fn in calls.items():
                out["sites"].append({
                    "name": name, "C": c, "S": s,
                    "device_ms": cs.graph_ms(fn),
                    "launch_device_ms": _launches8(cs, name, fn)})
        del t, calls
    return out


def run_build_ff(variant: str) -> dict:
    """Times post_ff through the variant's library of its launchers at
    phase 3's sites: device ms a call and per launch; for the uncut build
    the FF launch at every cluster size that fits, and the split pair."""
    import torch

    import chip_smoke as cs
    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.ops import block_kernel as bk

    lib = ctypes.CDLL(os.path.join(build_dir("ff " + variant), "lib.so"))
    for name in ("rdm_post_ff", "rdm_post_cross", "rdm_geglu_ff_sm90"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.rdm_error_string.argtypes = [ctypes.c_int]
    lib.rdm_error_string.restype = ctypes.c_char_p
    _build._lib = lib  # post_ff launches this build
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 40)
    out = {"build": variant, "sites": []}
    plan = bk.ff_plan
    for c, s, heads in cs.SITES:
        t = cs._site_tensors(c, s, heads, g)
        attn = 0.5 * torch.randn(t["x"].shape, generator=g, device="cuda",
                                 dtype=torch.bfloat16)
        args = [t["x"], attn] + [t[n] for n in (
            "ck", "cv", "wo", "bo", "n2s", "n2b", "wq2", "wo2", "bo2", "n3s",
            "n3b", "wa", "wg", "ba", "bg", "w2", "b2")]
        kw = dict(heads=heads, head_dim=c // heads)
        fn = lambda: bk.post_ff(*args, **kw)  # noqa: E731
        site = {"name": "post_ff", "C": c, "S": s,
                "plan": plan(c, 4 * c, rows=8 * s, capacity=bk.ff_capacity(
                    t["x"].device.index))._asdict(),
                "device_ms": cs.graph_ms(fn),
                "launch_device_ms": cs.graph_launch_ms(fn, 4, "block_gemm")}
        if variant == "kernel":
            site["ff_ms_by_ranks"] = {}
            for n in FF_RANKS:
                try:
                    forced = plan(c, 4 * c, n)
                except ValueError:
                    continue
                bk.ff_plan = lambda *a, p_=forced, **k: p_
                bk.kernel_refusal.cache_clear()
                parts = cs.graph_launch_ms(fn, 4, "block_gemm")
                site["ff_ms_by_ranks"][n] = {
                    "stages": forced.stages,
                    "ff_ms": parts and parts[3]}
                bk.ff_plan = plan
                bk.kernel_refusal.cache_clear()
            r = 8 * s
            pair = lambda: bk.geglu_ff(  # noqa: E731
                bk.post_cross(*args[:11], **kw).reshape(r, c), *args[11:])
            site["split_pair_device_ms"] = cs.graph_ms(pair)
            site["split_pair_launch_device_ms"] = cs.graph_launch_ms(
                pair, 5, "block_gemm")
        out["sites"].append(site)
        del t, attn, args
    return out


def ff_builds(card: str, path: str) -> int:
    """Every FF_CUTS build at once, then run_build_ff for each, one process
    a build; prints a line a site, writes `path`."""
    procs = {v: build(v, ff=True) for v in FF_CUTS}
    for v, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v!r}:\n{log}")
    results = {"card": card, "builds": []}
    for v in FF_CUTS:
        proc = subprocess.run([sys.executable, __file__, "--ff-build", v],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{v!r} failed:\n{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        for site in r["sites"]:
            parts = site["launch_device_ms"]
            print(f"{v:18s} post_ff C={site['C']:4d}: device "
                  f"{site['device_ms']:.4f} ms; launches x1, cross, xm, ff "
                  f"{parts if parts else 'not seen by the profiler'}",
                  flush=True)
            if "ff_ms_by_ranks" in site:
                print(f"{v:18s} post_ff C={site['C']:4d}: plan "
                      f"{site['plan']}; FF launch by ranks "
                      f"{site['ff_ms_by_ranks']}; split pair device "
                      f"{site['split_pair_device_ms']:.4f} ms, launches "
                      f"{site['split_pair_launch_device_ms']}", flush=True)
        results["builds"].append(r)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


DECODE_LAUNCHES = ("x1", "cross", "xm", "geglu_up", "ff_down")


def decode_calls(cs, g, b: int) -> dict:
    """decode_post_ff with bf16 and int8 weights at decode batch b on
    chip_smoke.py's seeded full-width layer (x and attn as its tensors)."""
    from rdm_tpu_torch.ops import decode_kernel as dk

    t = cs._int8_layer(cs._decode_tensors(b, g))
    names = ("wo", "bo", "n2s", "n2b", "wq2", "wo2", "bo2", "n3s", "n3b",
             "wa", "wg", "ba", "bg", "w2", "b2")
    head = [t["x"], t["x"], t["ck"], t["cv"]]
    ff = head + [t[n] for n in names]
    ff8 = head + [t[n + "_q" if n + "_q" in t else n] for n in names]
    sc = tuple(t[n + "_s"] for n in dk.POST_FF_WEIGHTS)
    return {"bf16": lambda: dk.decode_post_ff(*ff, heads=12, head_dim=64),
            "int8": lambda: dk.decode_post_ff(*ff8, heads=12, head_dim=64,
                                              scales=sc)}


def proj_calls(cs, g, b: int) -> dict:
    """decode_attn's projection alone (the bare kQkv launcher of the loaded
    library, its plan, programmatic dependent launch on, row 0 of bf16
    caches as k and v), bf16 and int8 weights: LN1 + [q | k | v] at decode
    batch b on chip_smoke.py's seeded full-width layer."""
    import torch

    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.ops import block_kernel as bk

    t = cs._int8_layer(cs._decode_tensors(b, g))
    x, c = t["x"], t["x"].shape[1]
    sms = bk.sm_count(x.device.index)
    q = torch.empty_like(x)

    def call(w8):
        plan = bk.gemm_plan("qkv", b, 3 * c, c, sms, split_k=True, w8=w8)
        ts = (x, t["n1s"], t["n1b"], t["wqkv_q"] if w8 else t["wqkv"],
              t["wqkv_s"] if w8 else None, q, t["kc"][0], t["vc"][0])
        rc = _build._lib.rdm_decode_proj(
            *(None if a is None else a.data_ptr() for a in ts), None, None,
            b, c, *plan.args, plan.ks, 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"rdm_decode_proj: {rc}")
    return {"proj bf16": lambda: call(False), "proj int8": lambda: call(True)}


def attn_calls(cs, t: dict, pos: int) -> dict:
    """decode_attn in each variant at position pos on one layer's tensors
    (`chip_smoke._int8_layer`), each on caches of its own."""
    from rdm_tpu_torch.ops import decode_kernel as dk

    calls = {}
    for mode, (w8, kv8) in (("bf16", (False, False)), ("w8", (True, False)),
                            ("kv8", (False, True)), ("w8_kv8", (True, True))):
        cs_ = [t[n].clone() for n in (("kc8", "vc8", "ks", "vs") if kv8
                                      else ("kc", "vc"))]
        kw = dict(heads=12, head_dim=64, wqkv_s=t["wqkv_s"] if w8 else None,
                  ks_cache=cs_[2] if kv8 else None,
                  vs_cache=cs_[3] if kv8 else None)
        wq = t["wqkv_q"] if w8 else t["wqkv"]
        calls[mode] = (lambda cs_=cs_, kw=kw, wq=wq: dk.decode_attn(
            t["x"], pos, cs_[0], cs_[1], t["n1s"], t["n1b"], wq, **kw))
    return calls


def attn_launches(t: dict, pos: int, mode: str) -> dict:
    """decode_attn's two launches alone, as the tree's wrapper makes them
    in variant `mode` at position pos (its C entry points called through
    ctypes on arguments made once, on caches of their own): both, and each
    apart. What a wrapper call costs beyond them is its Python."""
    import torch

    from rdm_tpu_torch.ops import _build
    from rdm_tpu_torch.ops import block_kernel as bk

    lib = _build.load()
    w8, kv8 = "w8" in mode, "kv8" in mode
    x = t["x"]
    b, c = x.shape
    kc, vc = (t[n].clone() for n in (("kc8", "vc8") if kv8 else ("kc", "vc")))
    ks, vs = (t["ks"].clone(), t["vs"].clone()) if kv8 else (None, None)
    wq, wqs = (t["wqkv_q"], t["wqkv_s"]) if w8 else (t["wqkv"], None)
    q, kn, vn, out = (torch.empty_like(x) for _ in range(4))
    knf, vnf = ((torch.empty((b, c), device="cuda") for _ in range(2))
                if kv8 else (None, None))
    st = torch.cuda.current_stream().cuda_stream
    scale = 64 ** -0.5 * 1.4426950408889634

    def p(a):
        return None if a is None else a.data_ptr()

    if "rdm_decode_proj" in _build._SIGNATURES:  # the two-launch design
        from rdm_tpu_torch.ops import decode_kernel as dk

        sms = bk.sm_count(x.device.index)
        proj = bk.gemm_plan("qkv", b, 3 * c, c, sms, split_k=True, w8=w8)
        ap = dk.attn_plan(b, 12, pos, sms)
        if not kv8:
            kn, vn = kc[pos], vc[pos]
        first = (lib.rdm_decode_proj, (
            p(x), p(t["n1s"]), p(t["n1b"]), p(wq), p(wqs), p(q), p(kn),
            p(vn), p(knf), p(vnf), b, c, *proj.args, proj.ks, 1, st))
        second = (lib.rdm_decode_attn, (
            p(q), p(kn), p(vn), p(kc), p(vc), p(ks), p(vs), p(knf), p(vnf),
            p(out), pos, kc.shape[0], b, c, 12, scale, ap.group, ap.splits,
            ap.rows, 1, st))
    else:  # the first version: rdm_decode_qkv, then the attention
        first = (lib.rdm_decode_qkv, (
            p(x), p(t["n1s"]), p(t["n1b"]), p(wq), p(wqs), p(q), p(kn),
            p(vn), None if kv8 else p(kc), None if kv8 else p(vc), p(knf),
            p(vnf), pos, b, c, st))
        second = (lib.rdm_decode_attn, (
            p(q), p(kn), p(vn), p(kc), p(vc), p(ks), p(vs), p(knf), p(vnf),
            p(out), pos, b, c, 12, scale, st))
    for fn, args in (first, second):
        if fn(*args):
            raise RuntimeError(f"decode_attn {mode}: a launch failed")
    (f1, a1), (f2, a2) = first, second
    return {"launches": lambda: (f1(*a1), f2(*a2)),
            "projection launch": lambda: f1(*a1),
            "attention launch": lambda: f2(*a2)}


def decode_times(cs, g) -> list:
    """decode_post_ff's device ms a call and each launch's, per mode and
    decode batch."""
    import torch

    out = []
    for b in DECODE_BATCHES:
        with torch.inference_mode():
            calls = {**decode_calls(cs, g, b), **proj_calls(cs, g, b)}
            for mode, fn in calls.items():
                parts = None if mode.startswith("proj") else \
                    cs.graph_launch_ms(fn, len(DECODE_LAUNCHES),
                                       "block_gemm_kernel")
                out.append({"mode": mode, "B": b,
                            "device_ms": cs.graph_ms(fn),
                            "launch_device_ms": parts and dict(
                                zip(DECODE_LAUNCHES, parts))})
    return out


def run_tiles() -> dict:
    """ln_qkv's device ms a call through each "qkv" tile forced alone, and
    through gemm_plan's pick, at the sites at TILE_IMAGES images."""
    import torch

    import chip_smoke as cs
    from rdm_tpu_torch.ops import block_kernel as bk

    tiles = bk.GEMM_TILES["qkv"]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {"tiles": tiles, "sites": []}
    for c, s, heads in cs.SITES:
        for images in TILE_IMAGES:
            t = cs._site_tensors(c, s, heads, g, images=images)
            r = images * s
            args = (t["x"].reshape(r, c), t["n1s"], t["n1b"], t["wqkv"])
            want = cs._flat(bk.ln_qkv_reference(*args))
            site = {"C": c, "S": s, "images": images, "R": r,
                    "plan": bk.gemm_plan("qkv", r, 3 * c, c,
                                         bk.sm_count(0)),
                    "plan_ms": cs.graph_ms(lambda: bk.ln_qkv(*args)),
                    "tile_ms": {}}
            for tile in tiles:
                bk.GEMM_TILES["qkv"] = (tile,)
                bk.gemm_plan.cache_clear()
                bk.kernel_refusal.cache_clear()
                if bk.kernel_refusal("ln_qkv", c) is not None:
                    continue  # the tile does not fit at this C
                got = cs._flat(bk.ln_qkv(*args))
                rel = ((got - want).abs().max() / want.abs().max()).item()
                if not rel <= cs.KERNEL_TOL:
                    raise RuntimeError(f"tile {tile} at C={c}, R={r}: "
                                       f"relative error {rel}")
                site["tile_ms"][str(tile)] = cs.graph_ms(
                    lambda: bk.ln_qkv(*args))
            bk.GEMM_TILES["qkv"] = tiles
            bk.gemm_plan.cache_clear()
            bk.kernel_refusal.cache_clear()
            print(f"C={c:4d} R={r:5d}: plan {tuple(site['plan'])} "
                  f"{site['plan_ms']:.4f} ms; " + ", ".join(
                      f"{k} {v:.4f}" for k, v in site["tile_ms"].items()),
                  flush=True)
            out["sites"].append(site)
            del t, args
    return out


def run_tiles8(only=()) -> dict:
    """The s8 launches' device ms through each tile of their kinds (those
    in `only`, if any) forced alone, and through gemm_plan's picks, at the
    sites at TILE_IMAGES images."""
    import torch

    import chip_smoke as cs
    from rdm_tpu_torch.ops import block_kernel as bk

    kinds = {"resq8": ("post_cross_q",), "cross8": ("post_cross_q",),
             "residual8": ("post_cross_q", "geglu_ff_q"),
             "geglu8": ("geglu_ff_q",), "qkv8": ("ln_qkv_q",)}
    kinds = {k: v for k, v in kinds.items() if not only or k in only}
    tiles = {k: bk.GEMM_TILES[k] for k in kinds}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 20)
    out = {"tiles": tiles, "sites": []}

    def launches(fn, name):
        return _launches8(cs, name, fn)

    def refit():
        bk.gemm_plan.cache_clear()
        bk.kernel_refusal.cache_clear()

    for c, s, heads in cs.SITES:
        for images in TILE_IMAGES:
            t = cs._site_tensors(c, s, heads, g, images=images)
            calls, _ = int8_calls(cs, t, s, heads)
            plain = int8_plain(cs, t, s, heads)
            site = {"C": c, "S": s, "images": images, "R": images * s,
                    "plan_ms": {n: launches(fn, n)
                                for n, fn in calls.items()
                                if any(n in v for v in kinds.values())},
                    "tile_ms": {}}
            for kind, names in kinds.items():
                for tile in tiles[kind]:
                    bk.GEMM_TILES[kind] = (tile,)
                    refit()
                    for name in names:
                        if bk.kernel_refusal(name, c, f=4 * c) is not None:
                            continue  # the tile does not fit at this C
                        got = cs._flat(calls[name]())
                        want = plain[name]
                        rel = ((got - want).abs().max()
                               / want.abs().max()).item()
                        if not rel <= cs.KERNEL_TOL:
                            raise RuntimeError(
                                f"{kind} tile {tile} at C={c}, images "
                                f"{images}: relative error {rel}")
                        site["tile_ms"][f"{kind} {tile} {name}"] = \
                            launches(calls[name], name)
                bk.GEMM_TILES[kind] = tiles[kind]
                refit()
            print(f"C={c:4d} images={images:2d}: plan {site['plan_ms']}; "
                  + "; ".join(f"{k}: {v}" for k, v in
                              site["tile_ms"].items()), flush=True)
            out["sites"].append(site)
            del t, calls, plain
    return out


def run_host(tree: str, int8_only: bool = False) -> dict:
    """Host us and device ms a wrapper call of the tree's `ln_qkv`,
    `post_cross`, `geglu_ff`, `decode_post_ff` and `decode_attn`. The
    tree's package comes first on the path; the timing helpers and tensors
    are this script's chip_smoke.py."""
    import importlib.util

    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from rdm_tpu_torch.ops import block_kernel as bk

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {"tree": tree, "module": bk.__file__, "sites": []}
    for c, s, heads in cs.SITES:
        t = cs._site_tensors(c, s, heads, g)
        if int8_only:
            calls8, differ = int8_calls(cs, t, s, heads)
            with torch.inference_mode():
                for name, fn in calls8.items():
                    out["sites"].append({"name": name, "C": c, "S": s,
                                         "host_us": cs.host_us(fn),
                                         "device_ms": cs.graph_ms(fn)})
                out["sites"][-1]["hidden_codes_differ"] = differ()
            del t, calls8
            continue
        attn = 0.5 * torch.randn(t["x"].shape, generator=g, device="cuda",
                                 dtype=torch.bfloat16)
        pc = (t["x"], attn, t["ck"], t["cv"], t["wo"], t["bo"], t["n2s"],
              t["n2b"], t["wq2"], t["wo2"], t["bo2"])
        xm2 = bk.post_cross_reference(*pc, heads=heads,
                                      head_dim=32).reshape(-1, c)
        ff = (xm2, t["n3s"], t["n3b"], t["wa"], t["wg"], t["ba"], t["bg"],
              t["w2"], t["b2"])
        qkv = (t["x"].reshape(-1, c), t["n1s"], t["n1b"], t["wqkv"])
        calls = {"ln_qkv": lambda: bk.ln_qkv(*qkv),
                 "post_cross": lambda: bk.post_cross(*pc, heads=heads,
                                                     head_dim=32),
                 "geglu_ff": lambda: bk.geglu_ff(*ff),
                 "post_ff": lambda: bk.post_ff(*pc, *ff[1:], heads=heads,
                                               head_dim=32)}
        with torch.inference_mode():
            for name, fn in calls.items():
                out["sites"].append({"name": name, "C": c, "S": s,
                                     "host_us": cs.host_us(fn),
                                     "device_ms": cs.graph_ms(fn)})
            calls8, differ = int8_calls(cs, t, s, heads)
            for name, fn in calls8.items():
                out["sites"].append({"name": name, "C": c, "S": s,
                                     "host_us": cs.host_us(fn),
                                     "device_ms": cs.graph_ms(fn)})
            out["sites"][-1]["hidden_codes_differ"] = differ()
        del t, attn, pc, ff, qkv, calls, calls8
    for b in () if int8_only else DECODE_BATCHES:
        with torch.inference_mode():
            for mode, fn in decode_calls(cs, g, b).items():
                out["sites"].append({"name": f"decode_post_ff {mode}",
                                     "C": 768, "S": b,
                                     "host_us": cs.host_us(fn),
                                     "device_ms": cs.graph_ms(fn)})
            t = cs._int8_layer(cs._decode_tensors(b, g))
            for pos in ATTN_POSITIONS:
                for mode, fn in commit_calls(t, pos).items():
                    out["sites"].append({
                        "name": f"commit_rows {mode} pos={pos}", "C": 768,
                        "S": b, "host_us": cs.host_us(fn),
                        "kernel_ms": cs.median_ms(fn),
                        "device_ms": cs.graph_ms(fn)})
                for mode, fn in attn_calls(cs, t, pos).items():
                    out["sites"].append({
                        "name": f"decode_attn {mode} pos={pos}", "C": 768,
                        "S": b, "host_us": cs.host_us(fn),
                        "device_ms": cs.graph_ms(fn)})
                    for part, lfn in attn_launches(t, pos, mode).items():
                        out["sites"].append({
                            "name": f"decode_attn {mode} pos={pos} {part}",
                            "C": 768, "S": b, "host_us": cs.host_us(lfn)})
            del t
    return out


def commit_calls(t: dict, pos: int) -> dict:
    """commit_rows of a decode step (the 36 caches and rows of chip_smoke.py
    phase 6's tensors at pos): the call the tree's decode step makes (a
    `RowCommit` built once, where the tree has one; else commit_rows) and
    commit_rows itself."""
    from rdm_tpu_torch.ops import decode_kernel as dk

    caches = [a.clone() for a in t["caches"]]
    rows = t["rows"]
    calls = {"wrapper": lambda: dk.commit_rows(pos, caches, rows)}
    if hasattr(dk, "RowCommit"):
        commit = dk.RowCommit(caches, rows)
        calls["step"] = lambda: commit(pos)
    else:
        calls["step"] = calls["wrapper"]
    return calls


def host_turns(trees, card: str, path: str, int8_only: bool) -> int:
    """run_host for each tree in turn, one process each; prints a line a
    site and wrapper, writes every run to `path`."""
    results = {"card": card, "runs": []}
    for i, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, __file__, "--host-tree", tree]
                              + ["--int8"] * int8_only,
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{tree!r} failed:\n{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        means = {}
        for site in r["sites"]:
            dev = (f", device {site['device_ms']:.4f} ms"
                   if "device_ms" in site else "")
            if "kernel_ms" in site:
                dev += f", kernel {site['kernel_ms']:.4f} ms"
            if "hidden_codes_differ" in site:
                dev += (f", hidden codes differing "
                        f"{site['hidden_codes_differ']:.3e}")
            print(f"turn {i + 1} {tree:16s} {site['name']:10s} "
                  f"C={site['C']:4d} S={site['S']:4d}: host "
                  f"{site['host_us']:.1f} us a call{dev}", flush=True)
            if site["name"].startswith(("decode_attn", "commit_rows")):
                key = (re.sub(r" pos=\d+", "", site["name"]), site["S"])
                means.setdefault(key, []).append(site["host_us"])
        for (name, s), us in means.items():
            print(f"turn {i + 1} {tree:16s} mean over pos {name} "
                  f"S={s:4d}: host {sum(us) / len(us):.1f} us", flush=True)
        results["runs"].append(r)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


def int8_builds(card: str, path: str) -> int:
    """Every INT8_CUTS build at once, then run_build_int8 for each, one
    process a build; prints a line a site and wrapper, writes `path`."""
    procs = {v: build(v, int8=True) for v in INT8_CUTS}
    for v, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v!r}:\n{log}")
    results = {"card": card, "builds": []}
    for v in INT8_CUTS:
        proc = subprocess.run([sys.executable, __file__, "--int8-build", v],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{v!r} failed:\n{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        for site in r["sites"]:
            parts = site["launch_device_ms"]
            print(f"{v:18s} {site['name']:12s} C={site['C']:4d}: device "
                  f"{site['device_ms']:.4f} ms; launches "
                  f"{parts if parts else 'not seen by the profiler'}",
                  flush=True)
        results["builds"].append(r)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="profile_gemm.json")
    ap.add_argument("--host", nargs="+", metavar="TREE",
                    help="time the wrappers' host cost of each tree in turn")
    ap.add_argument("--tiles", action="store_true",
                    help="time ln_qkv through each of its tiles")
    ap.add_argument("--decode", action="store_true",
                    help="time only the decode chain in the cut builds")
    ap.add_argument("--attn", action="store_true",
                    help="time decode_attn's attention launch in cut builds")
    ap.add_argument("--tiles8", nargs="*", metavar="KIND",
                    help="time the s8 launches through each of their tiles "
                    "(of the kinds named, else of all)")
    ap.add_argument("--int8", action="store_true",
                    help="time the int8 block's s8 launches in cut builds")
    ap.add_argument("--ff", action="store_true",
                    help="time post_ff's FF launch in cut builds")
    ap.add_argument("--ff-build", help=argparse.SUPPRESS)
    ap.add_argument("--int8-build", help=argparse.SUPPRESS)
    ap.add_argument("--attn-build", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--host-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_gemm: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.host_tree:
        print(json.dumps(run_host(args.host_tree, args.int8)), flush=True)
        return 0
    sys.path.insert(0, HERE)
    if args.attn_build:
        print(json.dumps(run_attn(args.attn_build)), flush=True)
        return 0
    if args.build:
        print(json.dumps(run_build(args.build, args.decode)), flush=True)
        return 0
    if args.int8_build:
        print(json.dumps(run_build_int8(args.int8_build)), flush=True)
        return 0
    if args.ff_build:
        print(json.dumps(run_build_ff(args.ff_build)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    if args.host:
        return host_turns(args.host, card, args.out, args.int8)
    if args.attn:
        return attn_builds(card, args.out)
    if args.int8:
        return int8_builds(card, args.out)
    if args.ff:
        return ff_builds(card, args.out)
    if args.tiles or args.tiles8 is not None:
        res = run_tiles() if args.tiles else run_tiles8(args.tiles8)
        with open(args.out, "w") as f:
            json.dump({"card": card, **res}, f, indent=1)
        print(f"wrote {args.out}", flush=True)
        return 0
    procs = {v: build(v) for v in CUTS}  # every build at once
    for v, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {v!r}:\n{log}")
    results = {"card": card, "builds": []}
    for v in CUTS:  # one process a build, one at a time on the card
        proc = subprocess.run([sys.executable, __file__, "--build", v]
                              + ["--decode"] * args.decode,
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{v!r} failed:\n{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        for site in r["sites"]:
            parts = site["launch_device_ms"]
            print(f"{v:24s} {site['name']:26s} C={site['C']:4d}: device "
                  f"{site['device_ms']:.4f} ms; launches "
                  f"{parts if parts else 'not seen by the profiler'}",
                  flush=True)
        for key in ("decode", "decode_ks1"):
            for d in r.get(key, ()):
                parts = d["launch_device_ms"]
                print(f"{v:24s} {key} {d['mode']:4s} B={d['B']:2d}: device "
                      f"{d['device_ms']:.4f} ms; launches "
                      f"{parts if parts else 'not seen by the profiler'}",
                      flush=True)
        results["builds"].append(r)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
