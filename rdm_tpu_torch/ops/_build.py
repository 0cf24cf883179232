"""Build and load the hand-written CUDA kernels under `rdm_tpu_torch/csrc/`.

The kernels have a plain C interface (device pointers, ints, floats and the
CUDA stream as `void*`), so they are compiled by `nvcc` alone — no PyTorch
headers — one object per source, all sources at once in parallel, then
linked into one shared library and bound with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -shared -o librdm_kernels.so *.o

The compiler's output (ptxas register, shared-memory and spill counts per
kernel) is kept beside the library as `nvcc.log`.

The library is built at first use into `rdm_tpu_torch/_build/<digest>/`,
keyed by a hash of the sources and flags, so `python3 chip_smoke.py` on a
fresh checkout builds everything and a rebuilt tree never loads a stale
library. A missing `nvcc` or a failed build raises; nothing falls back to
the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
CUDA_HOME_DEFAULT = Path("/usr/local/cuda")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argument types of every exported launcher (all return a cudaError_t int)
_SIGNATURES = {
    "rdm_ln_qkv": [_P] * 7 + [_I] * 2 + [_I] * 5 + [_P],
    "rdm_packed_attn": [_P] * 4 + [_I, _I, _I, _I, _F, _P],
    "rdm_post_cross": [_P] * 14 + [_I] * 5 + [_F] + [_I] * 10 + [_P],
    "rdm_geglu_ff_sm90": [_P] * 11 + [_I] * 3 + [_I] * 10 + [_P],
    "rdm_ln_qkv_q": [_P] * 8 + [_I, _I, _F] + [_I] * 5 + [_P],
    "rdm_packed_attn_q8": [_P] * 9 + [_I] * 5 + [_F, _P],
    "rdm_post_cross_q": [_P] * 17 + [_I] * 5 + [_F] * 4 + [_I] * 15 + [_P],
    "rdm_geglu_ff_q": [_P] * 14 + [_I] * 3 + [_F, _F] + [_I] * 10 + [_P],
    "rdm_post_ff": [_P] * 23 + [_I] * 6 + [_F] + [_I] * 13 + [_P],
    "rdm_ff": [_P] * 10 + [_I] * 6 + [_P],
    "rdm_ff_clusters": [_I],
    "rdm_decode_proj": [_P] * 10 + [_I] * 9 + [_P],
    "rdm_decode_attn": [_P] * 10 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    "rdm_decode_post_ff": [_P] * 30 + [_I] * 4 + [_F] + [_I] * 25 + [_P],
    "rdm_commit_rows": [_P] + [_I] * 5 + [_P],
    "rdm_flash_fwd": [_P] * 4 + [_I] * 6 + [_F, _P],
    "rdm_flash_bwd": [_P] * 8 + [_I] * 6 + [_F, _F, _P],
    "rdm_knn_search": [_P] * 4 + [_I] * 10 + [_P],
    "rdm_knn_cluster_slots": [_I] * 5,
    "rdm_knn_merge": [_P] * 4 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def sources() -> List[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_digest() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, the default toolkit path, or PATH."""
    cands = [CUDA_HOME_DEFAULT / "bin" / "nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH): "
        "the rdm_tpu_torch CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernel library if this source digest has none yet;
    returns its path."""
    global build_seconds
    out_dir = BUILD_ROOT / source_digest()
    lib_path = out_dir / "librdm_kernels.so"
    if lib_path.is_file():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [p for p in sources() if p.suffix == ".cu"]
    t0 = time.perf_counter()
    # build in a temp directory beside the library, then rename into
    # place: a concurrent or interrupted build never leaves a half-written
    # library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        (out_dir / "nvcc.log").write_text("".join(
            f"== {src.name}\n{log}" for src, log in zip(cu, logs)))
        failed = [(src.name, p.returncode, log)
                  for src, p, log in zip(cu, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        tmp_lib = os.path.join(tmp, lib_path.name)
        proc = subprocess.run([nvcc, "-shared", "-o", tmp_lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                f"{proc.stderr}")
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and bound once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rdm_error_string.argtypes = [ctypes.c_int]
            lib.rdm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def refuse_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and an input requires grad: a ctypes-bound
    kernel's output has no autograd graph, so its gradients would be lost
    without an error (differentiable callers wrap a kernel in an
    autograd.Function, whose forward runs with grad mode off)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: a CUDA kernel without a backward got an input that "
            "requires grad; run it under torch.no_grad() / inference_mode, "
            "or take the differentiable unfused path (module.train())")


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = load().rdm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
