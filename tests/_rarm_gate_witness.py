"""The RARM micro gate, the JAX package's and the port's, on the CPU from
one start: which part of a reading comes from the code, and which from
the random start (the first stage's init and training, the RARM's init).

    python tests/_rarm_gate_witness.py jax SEED STEPS OUT.pkl [HEADS HEAD_DIM]
        JAX's `run_gate_rarm` (what `scripts/micro_quality_gate.py --model
        rarm [--fast] --seed SEED` runs; STEPS 900 is --fast), keeping the
        weights it sampled with in OUT.pkl: its trained first stage, the
        RARM's EMA weights and its random-init baseline. HEADS HEAD_DIM
        replace the gate's 4 x 16 split (the same C = 64).
    python tests/_rarm_gate_witness.py port-sample OUT.pkl SEED HEADS HEAD_DIM
        those JAX weights sampled and scored by the port's pipeline.
    python tests/_rarm_gate_witness.py port-train OUT.pkl SEED STEPS HEADS \
        HEAD_DIM
        the port's `run_gate_rarm` from JAX's start: the first stage of
        OUT.pkl, the RARM init JAX's trainer draws at SEED, JAX's
        random-init baseline; the port trains, samples and scores.

Each prints one line `RESULT <mode> <json>` with the gate's report (the
JAX reading beside it where it applies). The script imports both
packages, as the tests do; the port's own gate needs no JAX.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

KEYS = ("fid_trained", "fid_random_init", "fid_ratio", "precision_trained",
        "precision_random", "recall_trained", "recall_random")


def jax_gate(seed: int, steps: int, out: str, heads: int = 4,
             head_dim: int = 16) -> dict:
    import rdm_tpu.models.rarm as jr
    import rdm_tpu.pipeline as jp
    from rdm_tpu.eval.micro_gate import run_gate_rarm

    seen = []

    def split(**kw):  # the gate builds its config with heads=4, head_dim=16
        return real_cfg(**dict(kw, heads=heads, head_dim=head_dim))

    class Keep(jp.RARMPipeline):
        def __init__(self, cfg, params, fs_cfg, fs_params, **kw):
            seen.append((jax.device_get(params), jax.device_get(fs_params)))
            super().__init__(cfg, params, fs_cfg, fs_params, **kw)

    real, jp.RARMPipeline = jp.RARMPipeline, Keep
    real_cfg = jr.RARMConfig
    if (heads, head_dim) != (4, 16):
        jr.RARMConfig = split
    try:
        report = run_gate_rarm(rarm_steps=steps, seed=seed)
    finally:
        jp.RARMPipeline, jr.RARMConfig = real, real_cfg
    report.update(heads=heads, head_dim=head_dim)
    report.pop("logdir", None)
    with open(out, "wb") as f:
        pickle.dump({"trained": seen[0][0], "random": seen[1][0],
                     "fs": seen[0][1], "seed": seed, "report": report}, f)
    return report


def _port_config(heads: int, head_dim: int):
    from rdm_tpu_torch.config import RARMConfig
    from rdm_tpu_torch.eval import micro_gate as pmg

    side = 16 // pmg._vq_config(16).downsample_factor
    return RARMConfig(vocab_size=130, out_vocab=128, heads=heads,
                      head_dim=head_dim, depth=3, context_dim=48,
                      seq_len=side * side, sos_token=129, mask_token=128,
                      code_side=side, p_mask_max=0.1)


def port_sample(capture: str, seed: int, heads: int, head_dim: int) -> dict:
    from rdm_tpu_torch.eval import micro_gate as pmg
    from rdm_tpu_torch.pipeline import RARMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool
    from rdm_tpu_torch.utils.from_jax import (rarm_state_dict_from_jax,
                                              vq_state_dict_from_jax)

    with open(capture, "rb") as f:
        d = pickle.load(f)
    images = pmg.make_shapes(256, size=16, seed=seed)
    emb = pmg.pixel_embed(images)
    fs_cfg, cfg = pmg._vq_config(16), _port_config(heads, head_dim)
    fs = vq_state_dict_from_jax(d["fs"], fs_cfg)
    pool = DataPool(embeddings=emb.astype(np.float32))

    def sample_with(params):
        pipe = RARMPipeline(cfg, rarm_state_dict_from_jax(params, cfg),
                            fs_cfg, fs, pool=pool, device="cpu")
        return np.concatenate([pipe.sample_unconditional(
            64, k_nn=3, top_k=32, seed=seed + 7 + i)[
                "samples_with_sampled_nns"] for i in (0, 64)])

    report = pmg._report(images, sample_with(d["trained"]),
                         sample_with(d["random"]), "cpu")
    report["jax"] = {k: d["report"][k] for k in KEYS}
    return report


def port_train(capture: str, seed: int, steps: int, heads: int,
               head_dim: int) -> dict:
    from rdm_tpu.models.rarm import RARM as JRARM
    from rdm_tpu.models.rarm import RARMConfig as JRARMConfig
    from rdm_tpu_torch.eval import micro_gate as pmg
    from rdm_tpu_torch.training import trainer as ptr
    from rdm_tpu_torch.utils.from_jax import (rarm_state_dict_from_jax,
                                              vq_state_dict_from_jax)

    with open(capture, "rb") as f:
        d = pickle.load(f)

    def jax_init(cfg):
        jc = JRARMConfig(**{k: getattr(cfg, k)
                            for k in cfg.__dataclass_fields__})
        p = jax.jit(JRARM(jc).init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32),
            jnp.zeros((1, cfg.seq_len, cfg.context_dim)))
        return rarm_state_dict_from_jax(p, cfg)

    def start(model, generator):
        model.load_state_dict(jax_init(model.config))
        return model

    real = pmg.train_vq, ptr.jax_init_, pmg._fit

    def fit(trainer, loader):
        return (rarm_state_dict_from_jax(d["random"], trainer.cfg),
                real[2](trainer, loader)[1])

    pmg.train_vq = lambda images, fs_cfg, **kw: (
        vq_state_dict_from_jax(d["fs"], fs_cfg), d["report"]["vq_recon_mse"])
    ptr.jax_init_, pmg._fit = start, fit
    try:
        report = pmg.run_gate_rarm(rarm_steps=steps, seed=seed, heads=heads,
                                   head_dim=head_dim, device="cpu")
    finally:
        pmg.train_vq, ptr.jax_init_, pmg._fit = real
    report.pop("logdir", None)
    report["jax"] = {k: d["report"][k] for k in KEYS}
    return report


def main(argv) -> None:
    torch.set_num_threads(2)
    mode, t0 = argv[0], time.time()
    if mode == "jax":
        report = jax_gate(int(argv[1]), int(argv[2]), argv[3],
                          *map(int, argv[4:6]))
    elif mode == "port-sample":
        report = port_sample(argv[1], *map(int, argv[2:5]))
    elif mode == "port-train":
        report = port_train(argv[1], *map(int, argv[2:6]))
    else:
        raise SystemExit(__doc__)
    report["wall_s"] = round(time.time() - t0, 1)
    print("RESULT", mode, json.dumps(report), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
