"""The self-contained train -> sample -> FID quality gate (no network).

Runs `rdm_tpu_torch.eval.micro_gate`: procedural coloured shapes -> a tiny
VQ first stage from scratch -> a tiny RDM (or RARM, --model rarm) through
the port's trainer -> sampling through the port's pipeline -> FID /
precision / recall. It passes when the trained model's FID is far below
the random-init model's and its precision above it; otherwise it exits
non-zero.

    python -m rdm_tpu_torch.scripts.micro_quality_gate [--model rdm|rarm]
        [--fast] [--out report.json] [--seed 0] [--device cuda|cpu]
        [--split kernels|jax]

The attention runs the kernels' head split at the gate's widths (the
RDM's C = 64 as 2 heads of 32, the RARM's as 1 head of 64) on cuda, and
JAX's 8-wide and 4 x 16 heads on the cpu; `--split` picks one on either
device (JAX's raises on cuda, where the kernels take heads 32 or 64
wide). The report names the split. The last line of the output is one
JSON record, {"metric": "quality_gate", ...}.
"""

from __future__ import annotations

import argparse
import json

# pass iff fid_trained < ratio * fid_random, per (model, --fast): the JAX
# gate's ratios (scripts/micro_quality_gate.py)
GATE_RATIOS = {("rdm", False): 0.6, ("rdm", True): 0.8,
               ("rarm", False): 0.7, ("rarm", True): 0.93}
FAST_STEPS = 900
# the kernels' head split at the gates' widths (C = 64)
CUDA_SPLIT = {"rdm": {"num_head_channels": 32},
              "rarm": {"heads": 1, "head_dim": 64}}


def gate(model: str, fast: bool, seed: int = 0, device: str = "cuda",
         gate_ratio=None, split=None, **kw) -> dict:
    """Run one gate; the report with its verdict under "passed". split:
    "kernels" or "jax" (module docstring), by default the device's."""
    from rdm_tpu_torch.eval.micro_gate import run_gate, run_gate_rarm

    kw = dict(kw, seed=seed, device=device)
    if fast:
        kw.setdefault("rdm_steps" if model == "rdm" else "rarm_steps",
                      FAST_STEPS)
    if split is None:
        split = "kernels" if str(device).startswith("cuda") else "jax"
    if split == "kernels":
        kw = {**CUDA_SPLIT[model], **kw}
    ratio = gate_ratio or GATE_RATIOS[(model, fast)]
    report = (run_gate if model == "rdm" else run_gate_rarm)(**kw)
    report["metric"] = "quality_gate"
    report["model"] = model
    report["gate_ratio"] = ratio
    report["passed"] = bool(
        report["fid_trained"] < ratio * report["fid_random_init"]
        and report["precision_trained"] > report["precision_random"])
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, default="rdm",
                   choices=["rdm", "rarm"])
    p.add_argument("--fast", action="store_true",
                   help=f"{FAST_STEPS} training steps instead of 3000")
    p.add_argument("--out", type=str, default=None,
                   help="write the report JSON here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gate_ratio", type=float, default=None,
                   help="pass iff fid_trained < ratio * fid_random; by "
                        "default the JAX gate's: RDM 0.6 (--fast 0.8), "
                        "RARM 0.7 (--fast 0.93)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--split", type=str, default=None,
                   choices=["kernels", "jax"],
                   help="the attention's head split: the kernels' (the "
                        "default on cuda) or JAX's (the default on cpu)")
    opt = p.parse_args(argv)

    report = gate(opt.model, opt.fast, opt.seed, opt.device,
                  opt.gate_ratio, opt.split)
    if opt.out:
        with open(opt.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))
    if not report["passed"]:
        raise SystemExit(
            f"GATE FAILED: fid_trained={report['fid_trained']} not < "
            f"{report['gate_ratio']} * fid_random="
            f"{report['fid_random_init']}, or precision_trained="
            f"{report['precision_trained']} not > precision_random="
            f"{report['precision_random']}")


if __name__ == "__main__":
    main()
