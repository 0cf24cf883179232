#!/usr/bin/env python3
"""Where the kNN search kernel's time goes, on one NVIDIA GPU.

    python3 profile_knn.py [--out profile_knn.json]

Builds rdm_tpu_torch/csrc/knn_topk.cu twice with nvcc: as it is, and with
its selection cut to a stripe's first and last chunk, which leaves the
TMA ring, the products and the turns of the two warpgroups. Each build
runs in a process of its own over a 1,281,280 x 512 bf16 table made on
the card and times knn_topk's device time in a CUDA graph (chip_smoke.py
`graph_ms`) at (B, k) = (4, 4), (32, 4), (64, 20), (128, 20), (256, 20),
beside torch.topk(q @ db.T). The cut build's ids are wrong by design; only
its time is read. Prints one JSON line per build and writes them all to
--out, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

CASES = ((4, 4), (32, 4), (64, 20), (128, 20), (256, 20))
# the selection loop of a chunk, and the same loop run only on a stripe's
# first chunk and on its last (which merges every buffer)
SELECT = ("      uint64_t todo = ~0ull >> (64 - kVals);\n"
          "      while (true) {")
CUT = ("      uint64_t todo = ~0ull >> (64 - kVals);\n"
       "      while (c < 1 || last) {")
BUILDS = ("kernel", "products only")


def _build(variant: str):
    """The kNN launchers of knn_topk.cu (cut to `variant`) in a library of
    their own, bound as rdm_tpu_torch.ops._build binds the real one."""
    from rdm_tpu_torch.ops import _build as build

    src = (build.CSRC / "knn_topk.cu").read_text()
    if variant == "products only":
        if SELECT not in src:
            raise RuntimeError("knn_topk.cu's selection loop moved; update "
                               "profile_knn.py's SELECT")
        src = src.replace(SELECT, CUT, 1)
    tmp = tempfile.mkdtemp()
    cu, lib_path = os.path.join(tmp, "knn.cu"), os.path.join(tmp, "knn.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
         "-shared", "-o", lib_path, cu, str(build.CSRC / "runtime.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for name in ("rdm_knn_search", "rdm_knn_merge", "rdm_knn_cluster_slots"):
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.rdm_error_string.argtypes = [ctypes.c_int]
    lib.rdm_error_string.restype = ctypes.c_char_p
    build._lib = lib


def run_build(variant: str) -> dict:
    import torch

    import chip_smoke as cs
    from rdm_tpu_torch.ops import knn_kernel as kk

    _build(variant)
    db = cs.make_table().to(torch.bfloat16)
    n, d = db.shape
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 80)
    out = {"build": variant, "cases": []}
    for b, k in CASES:
        q = torch.nn.functional.normalize(
            torch.randn(b, d, generator=g, device="cuda"), dim=1)
        qb = q.to(torch.bfloat16)
        p = kk.device_plan(b, n, d, k, 0)
        out["cases"].append({
            "B": b, "k": k, "queries": p.queries, "cluster": p.cluster,
            "groups": p.groups, "stripes": p.n_slices,
            "device_ms": cs.graph_ms(lambda: kk.knn_topk(db, q, k)),
            "topk_device_ms": cs.graph_ms(lambda: torch.topk(qb @ db.t(),
                                                             k)),
            "bound_ms": cs.bound(*cs.knn_cost(b, n, d, k))[0]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_knn.json")
    ap.add_argument("--build", choices=BUILDS, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_knn: no CUDA device", file=sys.stderr)
        return 1
    if args.build:  # one build, in this process
        print(json.dumps(run_build(args.build)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    results = []
    for variant in BUILDS:
        proc = subprocess.run(
            [sys.executable, __file__, "--build", variant],
            capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    with open(args.out, "w") as f:
        json.dump({"card": card, "builds": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
