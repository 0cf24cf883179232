"""One rank of the two-process scenarios that tests/test_torch_port_parallel.py
holds against JAX and against one process.

    python tests/_torch_parallel_worker.py DIR RANK WORLD

joins a gloo group through the file store DIR/store, reads DIR/inputs.pt
(written by the test), runs every scenario on the CPU and writes
DIR/out_RANK.pt. It imports torch and the port only (no JAX); the
port's configurations come in the inputs, under "cfg", as the test files
define them.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

LR, CLIP, EMA, P_MASK_MAX = 1e-3, 1e-3, 0.99, 0.25
MIN_SIZE = 64  # fsdp_min_size at these widths: most leaves cut, some whole
STEPS, GUIDANCE = 5, 2.0


def rdm_tx():
    from rdm_tpu_torch.training import optim
    return optim.make_optimizer(LR, warm_up_steps=2, grad_clip=CLIP)


def rarm_tx():
    from rdm_tpu_torch.training.optim import AdamW, lambda_linear_schedule
    return AdamW(lambda_linear_schedule(LR, warm_up_steps=2), b1=0.9,
                 b2=0.95, weight_decay=1e-2)


def rdm_state(c, sd):
    from rdm_tpu_torch.models.rdm import RDM
    from rdm_tpu_torch.training.train_state import init_train_state
    model = RDM(c["t_rdm"])
    model.load_state_dict(sd)
    return init_train_state(model, rdm_tx())


def rarm_state(c, sd):
    from rdm_tpu_torch.models.rarm import RARM
    from rdm_tpu_torch.training.train_state import init_train_state
    model = RARM(c["t_rarm"])
    model.load_state_dict(sd)
    return init_train_state(model, rarm_tx())


def rarm_trainer(c, logdir, mesh=None, sharding="replicated"):
    """The RARM trainer of tests/test_torch_port_rarm_train.py (a tiny VQ
    first stage), batch 2 a rank."""
    from rdm_tpu_torch.models.autoencoder import VQModel
    from rdm_tpu_torch.training.trainer import RARMTrainer, TrainerConfig
    fs = c["tr_ae"]
    torch.manual_seed(0)
    fs_sd = VQModel(fs).state_dict()
    tcfg = TrainerConfig(logdir=logdir, base_lr=1e-3, max_steps=2,
                         log_every=1, ckpt_every=100, image_log_every=0,
                         warm_up_steps=1, param_sharding=sharding)
    tr = RARMTrainer(c["tr_rarm"], tcfg, fs, fs_sd, mesh=mesh,
                     batch_size=2, device="cpu")
    tr.fsdp_min_size = MIN_SIZE
    return tr


def trainer_batches(seed, n, rows=slice(None)):
    """n global batches of 4 images (this rank's rows of each)."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.uniform(-1, 1, (4, 16, 16, 3)).astype(
        np.float32)[rows], "nn_embeddings": rng.standard_normal(
        (4, 1, 4, 16)).astype(np.float32)[rows]} for _ in range(n)]


def _steps(state, step, batches, rows):
    """Steps on this rank's rows; the metrics and the whole state."""
    out = {"loss": [], "grad_norm": []}
    for a, b, draws in batches:
        state, m = step(state, a[rows], b[rows], 0, **draws)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["state"] = state.state_dict()
    return out


def _layout(state):
    """{tree: {name: (dim, local shape)}} of a sharded state."""
    lay = state.layout
    trees = {"params": state.shards, "mu": state.opt_state.mu,
             "nu": state.opt_state.nu, "ema": state.ema.params}
    return {t: {n: (lay.dims[n], tuple(v.shape)) for n, v in tree.items()}
            for t, tree in trees.items()}


def main(d: str, rank: int, world: int) -> None:
    from rdm_tpu_torch.parallel import distributed as pdist
    from rdm_tpu_torch.parallel.mesh import make_mesh, shard_train_state
    from rdm_tpu_torch.pipeline import RARMPipeline, RDMPipeline
    from rdm_tpu_torch.retrieval.database import DataPool
    from rdm_tpu_torch.retrieval.engine import (RetrievalEngine, knn_search,
                                                l2_normalize)
    from rdm_tpu_torch.ops.schedules import DiffusionSchedule
    from rdm_tpu_torch.training.train_state import (make_rarm_train_step,
                                                    make_train_step)

    torch.set_num_threads(2)
    pdist.initialize(f"file://{d}/store", world, rank, device="cpu")
    pdist.initialize(f"file://{d}/store", world, rank, device="cpu")
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    out = {"host_info": pdist.host_info(),
           "shard_for_host": pdist.shard_for_host(8)}
    try:
        pdist.shard_for_host(7)
    except ValueError as e:
        out["shard_7"] = str(e)
    mesh = make_mesh(data=world)
    mesh_db = make_mesh(data=1, db=world)
    start, per = pdist.shard_for_host(4)
    rows = slice(start, start + per)
    c = inp["cfg"]
    cfg = c["t_rdm"]
    sched = DiffusionSchedule.create(cfg.timesteps, cfg.beta_schedule,
                                     cfg.linear_start, cfg.linear_end)

    # DDP and FSDP steps against JAX's data=2 mesh steps (global draws)
    rdm_batches = list(zip(inp["rdm_z"], inp["rdm_nns"], inp["rdm_draws"]))
    step = make_train_step(rdm_tx(), sched, mesh=mesh, ema_decay=EMA)
    out["rdm_ddp"] = _steps(rdm_state(c, inp["rdm_sd"]), step, rdm_batches,
                            rows)
    st = shard_train_state(rdm_state(c, inp["rdm_sd"]), mesh, MIN_SIZE)
    out["rdm_fsdp_layout"] = _layout(st)
    step = make_train_step(rdm_tx(), sched, mesh=mesh, ema_decay=EMA,
                           param_sharding="fsdp", remat=True,
                           remat_policy="dots")
    out["rdm_fsdp"] = _steps(st, step, rdm_batches, rows)
    rarm_batches = [(z, n, {"mask": m}) for z, n, m in zip(
        inp["rarm_z"], inp["rarm_nns"], inp["rarm_mask"])]
    for mode in ("replicated", "fsdp"):
        st = rarm_state(c, inp["rarm_sd"])
        if mode == "fsdp":
            st = shard_train_state(st, mesh, MIN_SIZE)
        step = make_rarm_train_step(rarm_tx(), ema_decay=EMA,
                                    p_mask_max=P_MASK_MAX, mesh=mesh,
                                    param_sharding=mode)
        out[f"rarm_{mode}"] = _steps(st, step, rarm_batches, rows)

    # no injected draws: the ranks draw the global batch's and cut rows
    for mode in ("replicated", "fsdp"):
        st = rdm_state(c, inp["rdm_sd"])
        if mode == "fsdp":
            st = shard_train_state(st, mesh, MIN_SIZE)
        step = make_train_step(rdm_tx(), sched, mesh=mesh, ema_decay=EMA,
                               param_sharding=mode)
        out[f"rdm_free_{mode}"] = _steps(
            st, step, [(inp["rdm_z"][0], inp["rdm_nns"][0], {})], rows)
    step = make_rarm_train_step(rarm_tx(), ema_decay=EMA,
                                p_mask_max=P_MASK_MAX, mesh=mesh)
    out["rarm_free"] = _steps(rarm_state(c, inp["rarm_sd"]), step,
                              [(inp["rarm_z"][0], inp["rarm_nns"][0], {})],
                              rows)

    # trainers: the lr scaling; FSDP checkpoints from and to world 1
    tr = rarm_trainer(c, os.path.join(d, "w2"), mesh, "fsdp")
    out["lr"] = tr.lr
    state = tr.fit(trainer_batches(1, 2, rows))
    out["trainer_layout"] = _layout(state)
    tr.fit(trainer_batches(2, 1, rows), state=state, max_steps=3)
    tr = rarm_trainer(c, os.path.join(d, "w1to2"), mesh, "fsdp")
    tr.fit(trainer_batches(2, 1, rows), max_steps=3)
    dist.barrier()

    # the db-sharded search and engine
    emb = inp["knn_emb"]
    table, _ = DataPool(emb).device_table(dtype=torch.float32)
    s, i = knn_search(table, l2_normalize(inp["knn_q"]), 6, mesh=mesh_db)
    out["knn"] = {"scores": s, "ids": i}
    eng = RetrievalEngine(DataPool(emb), dtype=torch.float32, mesh=mesh_db)
    out["engine_rows"] = eng.db_norm.shape[0]
    out["engine"] = eng.search(inp["knn_q"], k=6)
    try:
        RetrievalEngine(DataPool(emb[:63]), dtype=torch.float32,
                        mesh=mesh_db)
    except ValueError as e:
        out["engine_63"] = str(e)

    # data-parallel sampling
    p = inp["pipe_rdm"]
    pipe = RDMPipeline(c["p_rdm"], p["sd"], c["p_rdm_ae"], p["vq_sd"],
                       pool=DataPool(p["emb"]), dtype=torch.float32,
                       mesh=mesh)
    out["dp_rdm"] = pipe.sample_with_query(
        p["q"], steps=STEPS, guidance_scale=GUIDANCE, seed=3)["query_samples"]
    try:
        pipe.sample_with_query(p["q"][:3], steps=STEPS, seed=3)
    except ValueError as e:
        out["dp_rdm_3"] = str(e)
    p = inp["pipe_rarm"]
    pipe = RARMPipeline(c["p_rarm"], p["sd"], c["p_rarm_ae"], p["vq_sd"],
                        pool=DataPool(p["emb"]), dtype=torch.float32,
                        mesh=mesh)
    out["dp_rarm"] = pipe.sample_with_query(
        p["q"], top_k=1, guidance_scale=2.0, seed=3, return_tokens=True,
        partition=True)
    out["dp_rarm_t"] = pipe.sample_with_query(
        p["q"], top_k=8, temperature=1.0, seed=5, return_tokens=True)
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
