"""The port's data parallelism, FSDP, db-sharded search and data-parallel
sampling across two real processes, against JAX meshes and one process.

A module fixture spawns two gloo ranks once (tests/_torch_parallel_worker.py,
a file store in the test's temporary directory, so parallel test files
never share a port) and every scenario runs in that spawn; the tests here
read what the ranks wrote. JAX runs here, on two of its CPU devices.

- DDP and FSDP train steps of a tiny RDM (p_uncond, retro_noise, grad
  clip; the FSDP one under remat "dots") and RARM (p_mask) on half
  batches against JAX's `make_mesh(data=2)` steps on the global batch,
  the global draws injected: loss and grad_norm within 1e-5 relative,
  params after two steps within 1e-5 relative L2.
- Without injected draws, the two ranks step as one process on the
  global batch from the same seed (the draw slicing).
- The FSDP layout: every leaf of at least min_size elements cut on
  `fsdp_spec`'s dim, in the params, both moments and the EMA;
  `fsdp_spec` against JAX's on a table of shapes.
- Trainer checkpoints: FSDP at world 2 resumed at world 1 and back, the
  next loss equal; the lr scaled by the data ranks.
- `knn_search` over db = 2 against JAX's `make_mesh(data=1, db=2)`
  search (ids exact, scores within 1e-5), the sharded engine's
  embeddings against one process's.
- Data-parallel sampling: a tiny RDMPipeline and RARMPipeline over two
  ranks against one process of the port and JAX's `_maybe_data_parallel`.
- `initialize` / `host_info` / `shard_for_host` as tests/test_distributed.py
  holds JAX's.
"""

import functools
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parallel_worker as W
from rdm_tpu.models import rarm as jrarm
from rdm_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from rdm_tpu.models.autoencoder import VQModel as JVQModel
from rdm_tpu.models.rdm import RDM as JRDM
from rdm_tpu.parallel.mesh import fsdp_spec as j_fsdp_spec
from rdm_tpu.parallel.mesh import make_mesh as j_make_mesh
from rdm_tpu.parallel.mesh import shard_train_state as j_shard
from rdm_tpu.pipeline import RARMPipeline as JRARMPipeline
from rdm_tpu.pipeline import _maybe_data_parallel
from rdm_tpu.pipeline import to_uint8 as j_to_uint8
from rdm_tpu.retrieval import database as jdb
from rdm_tpu.retrieval import engine as jeng
from rdm_tpu.sampling import DDIMSamplerConfig as JSampler
from rdm_tpu.sampling import ddim_sample as j_ddim_sample
from rdm_tpu.ops.schedules import DiffusionSchedule as JSchedule
from rdm_tpu.training import optim as joptim
from rdm_tpu.training.optim import lambda_linear_schedule as j_schedule
from rdm_tpu.training.train_state import init_train_state as j_init
from rdm_tpu.training.train_state import make_rarm_train_step as j_rarm_step
from rdm_tpu.training.train_state import make_train_step as j_step
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.parallel import distributed as pdist
from rdm_tpu_torch.parallel.mesh import fsdp_spec
from rdm_tpu_torch.pipeline import RARMPipeline, RDMPipeline
from rdm_tpu_torch.retrieval.database import DataPool
from rdm_tpu_torch.retrieval.engine import RetrievalEngine
from rdm_tpu_torch.training.train_state import (make_rarm_train_step,
                                                make_train_step)
from rdm_tpu_torch.utils.from_jax import (rarm_state_dict_from_jax,
                                          rdm_state_dict_from_jax,
                                          train_state_from_jax)
import test_torch_port_rarm as trarm
import test_torch_port_rarm_train as trt
import test_torch_port_slice as tslice
import test_torch_port_train as ttrain

WORLD = 2
GB = 4  # the global batch; two rows a rank
KEY = 3  # the JAX steps' PRNGKey


def _cfgs():
    """The port configurations the ranks build from: the tiny RDM of
    test_torch_port_train (with p_uncond and retro_noise, so every draw of
    the loss is made), the tiny RARMs, trainer and pipelines of the RARM
    and slice tests."""
    return {"t_rdm": ttrain._configs(p_uncond=0.5, retro_noise=True)[1],
            "t_rarm": pc.RARMConfig(**trt.TINY),
            "tr_rarm": pc.RARMConfig(**trt.TRAINER_RARM,
                                     p_mask_max=W.P_MASK_MAX),
            "tr_ae": pc.AutoencoderConfig(**trt.AE),
            "p_rdm": pc.RDMConfig(unet=pc.UNetConfig(**tslice.UNET),
                                  **tslice.RDM_KW),
            "p_rdm_ae": pc.AutoencoderConfig(**tslice.AE_KW),
            "p_rarm": pc.RARMConfig(**trarm.PIPE),
            "p_rarm_ae": pc.AutoencoderConfig(**trarm.AE_KW)}


def _rdm_inputs():
    """The JAX RDM, two global batches and the JAX step's draws."""
    jcfg = ttrain._configs(p_uncond=0.5, retro_noise=True)[0]
    jm, params = ttrain._jax_model(jcfg)
    z, nns, draws = [], [], []
    for i in range(2):
        zi, ni = ttrain._batch(GB, seed=10 + i)
        z.append(torch.from_numpy(zi).permute(0, 3, 1, 2).contiguous())
        nns.append(torch.from_numpy(ni))
        draws.append(ttrain._jax_draws(jcfg, jax.random.fold_in(
            jax.random.PRNGKey(KEY), i), GB, 2))
    return jcfg, jm, params, z, nns, draws


def _rarm_inputs():
    jm, params, cfg, _ = trt._models()
    z, nns, masks = [], [], []
    key = jax.random.PRNGKey(KEY)
    for i in range(2):
        rng = np.random.default_rng(20 + i)
        z.append(rng.integers(0, trt.TINY["out_vocab"],
                              (GB, trt.TINY["seq_len"])).astype(np.int32))
        nns.append(rng.standard_normal(
            (GB, trt.S_CTX, trt.TINY["context_dim"])).astype(np.float32))
        r = jax.random.fold_in(key, i)
        p_mask = jax.random.uniform(jax.random.fold_in(r, 2),
                                    maxval=W.P_MASK_MAX)
        masks.append(np.array(jax.random.bernoulli(
            jax.random.fold_in(r, 3), p_mask, nns[-1].shape)))
    return jm, params, cfg, z, nns, masks


def _rel_l2(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    num = sum(float((got[k].float() - want[k].float()).pow(2).sum())
              for k in want)
    den = sum(float(want[k].float().pow(2).sum()) for k in want)
    return (num / den) ** 0.5


def _jax_rdm_steps(jcfg, jm, params, z, nns):
    jsched = JSchedule.create(jcfg.timesteps, jcfg.beta_schedule,
                              jcfg.linear_start, jcfg.linear_end)
    jtx = joptim.make_optimizer(W.LR, warm_up_steps=2, grad_clip=W.CLIP)
    jstate = j_init(params, jtx)
    step = j_step(jm, jtx, jsched, mesh=j_make_mesh(data=WORLD),
                  ema_decay=W.EMA, remat=False)
    mets = []
    for zi, ni in zip(z, nns):
        jstate, m = step(jstate, jnp.asarray(zi.permute(0, 2, 3, 1).numpy()),
                         jnp.asarray(ni.numpy()), jax.random.PRNGKey(KEY))
        mets.append({k: float(v) for k, v in m.items()})
    return jstate, mets


def _jax_rarm_steps(jm, params, z, nns):
    """JAX's FSDP RARM steps (param_sharding="fsdp" on data=2)."""
    jtx = optax.adamw(j_schedule(W.LR, warm_up_steps=2), b1=0.9, b2=0.95,
                      weight_decay=1e-2)
    mesh = j_make_mesh(data=WORLD)
    jstate = j_shard(j_init(params, jtx), mesh, min_size=W.MIN_SIZE)
    step = j_rarm_step(jm, jtx, mesh=mesh, ema_decay=W.EMA,
                       p_mask_max=W.P_MASK_MAX, param_sharding="fsdp",
                       fsdp_min_size=W.MIN_SIZE)
    mets = []
    for zi, ni in zip(z, nns):
        jstate, m = step(jstate, jnp.asarray(zi), jnp.asarray(ni),
                         jax.random.PRNGKey(KEY))
        mets.append({k: float(v) for k, v in m.items()})
    return jstate, mets


def _trainer_world1(d, c):
    """One process: a plain RARM trainer's two steps and checkpoint (for
    the world-2 resume), and the next loss from there."""
    tr = W.rarm_trainer(c, os.path.join(d, "w1"))
    state = tr.fit(W.trainer_batches(1, 2))
    tr.fit(W.trainer_batches(2, 1), state=state, max_steps=3)
    _copy_step(d, "w1", "w1to2", 2)


def _copy_step(d, src, dst, step):
    """The checkpoint of `step` alone into another run's directory."""
    shutil.copytree(os.path.join(d, src, "checkpoints", str(step)),
                    os.path.join(d, dst, "checkpoints", str(step)))


def _losses(logdir):
    import json
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks"))
    c = _cfgs()
    jcfg, jm, params, z, nns, draws = _rdm_inputs()
    cfg = c["t_rdm"]
    rjm, rparams, rcfg, rz, rnns, masks = _rarm_inputs()
    (pjm, pparams, pjvq, pvq_params), (_, psd, _, pvq_sd) = tslice._models(11)
    pemb = tslice._table(seed=12)
    pq = np.random.default_rng(13).standard_normal((GB, 24)).astype(
        np.float32)
    _, aparams, _, amodel = trarm._models(trarm.PIPE, seed=20)
    _, avq_params, _, avq_sd = trarm._vq(seed=21)
    aemb = np.random.default_rng(22).standard_normal((300, 24)).astype(
        np.float32)
    aq = np.random.default_rng(23).standard_normal((GB, 24)).astype(
        np.float32)
    kemb = np.random.default_rng(30).standard_normal((64, 16)).astype(
        np.float32)
    kemb[[40, 41, 50]] = kemb[7]  # 7, 40, 41, 50 tie across both shards
    kemb[60] = 2.0 * kemb[3]      # same direction: equal scores
    kq = np.concatenate([kemb[[7, 3]], np.random.default_rng(31)
                         .standard_normal((3, 16)).astype(np.float32)])
    inputs = {
        "cfg": c, "rdm_sd": rdm_state_dict_from_jax(params, cfg),
        "rdm_z": z, "rdm_nns": nns, "rdm_draws": draws,
        "rarm_sd": rarm_state_dict_from_jax(rparams, rcfg),
        "rarm_z": [torch.from_numpy(t).long() for t in rz],
        "rarm_nns": [torch.from_numpy(t) for t in rnns],
        "rarm_mask": [torch.from_numpy(m) for m in masks],
        "knn_emb": torch.from_numpy(kemb), "knn_q": torch.from_numpy(kq),
        "pipe_rdm": {"sd": psd, "vq_sd": pvq_sd,
                     "emb": torch.from_numpy(pemb),
                     "q": torch.from_numpy(pq)},
        "pipe_rarm": {"sd": amodel.state_dict(), "vq_sd": avq_sd,
                      "emb": torch.from_numpy(aemb),
                      "q": torch.from_numpy(aq)}}
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    _trainer_world1(d, c)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    logs = [open(os.path.join(d, f"log_{r}.txt"), "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, W.__file__, d, str(r), str(WORLD)], env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        # the JAX references while the ranks run
        refs = {"rdm": _jax_rdm_steps(jcfg, jm, params, z, nns),
                "rarm": _jax_rarm_steps(rjm, rparams, rz, rnns),
                "dp_rdm": _dp_rdm_refs(c, inputs, pjm, pparams, pjvq,
                                       pvq_params, pemb, pq),
                "dp_rarm": _dp_rarm_refs(c, inputs, aparams, avq_params,
                                         aemb, aq)}
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    for r, rc in enumerate(rcs):
        with open(os.path.join(d, f"log_{r}.txt")) as f:
            assert rc == 0, f"rank {r} exited {rc}:\n{f.read()[-4000:]}"
    outs = [torch.load(os.path.join(d, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return {"d": d, "c": c, "inputs": inputs, "refs": refs, "outs": outs,
            "cfg": cfg, "rcfg": rcfg}


# ------------------------------------------------------- single process

def test_initialize_host_info_shard_single_process():
    pdist.initialize()  # alone in a process: a no-op
    assert not torch.distributed.is_initialized()
    assert pdist.host_info() == (0, 1)
    assert pdist.shard_for_host(32) == (0, 32)
    t = torch.arange(6.0).reshape(3, 2)
    assert pdist.gather_from_ranks(t) is t


def test_initialize_refuses_what_it_cannot_run(tmp_path):
    store = f"file://{tmp_path}/store"
    with pytest.raises(ValueError, match="want 'cuda' or 'cpu'"):
        pdist.initialize(store, 1, 0, device="tpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="take NCCL"):
            pdist.initialize(store, 1, 0, backend="gloo")
    else:  # a CUDA rank never falls back to gloo
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pdist.initialize(store, 1, 0)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("shape,n,min_size", [
    ((3, 4), 2, 1), ((512, 768), 2, 16384), ((512, 768), 4, 16384),
    ((768, 512), 3, 16384), ((100, 7), 2, 16), ((7, 9), 2, 16),
    ((64,), 2, 16384), ((4096,), 8, 16), ((3, 3, 320, 640), 8, 16384),
    ((5, 10, 10), 5, 16), ((16, 16), 32, 1), ((), 2, 1)])
def test_fsdp_spec_matches_jax(shape, n, min_size):
    spec = tuple(j_fsdp_spec(shape, n, min_size=min_size))
    want = spec.index("data") if "data" in spec else None
    assert fsdp_spec(shape, n, min_size) == want


def test_step_options_raise():
    from rdm_tpu_torch.training import optim
    tx = optim.make_optimizer(1e-3)
    with pytest.raises(ValueError, match="unknown param_sharding"):
        make_train_step(tx, None, param_sharding="zero")
    with pytest.raises(ValueError, match="'fsdp' needs a mesh"):
        make_rarm_train_step(tx, param_sharding="fsdp")


# ------------------------------------------------------------ two ranks

def test_ranks_plumbing(ranks):
    for r, out in enumerate(ranks["outs"]):
        assert out["host_info"] == (r, WORLD)
        assert out["shard_for_host"] == (4 * r, 4)
        assert "not divisible by 2" in out["shard_7"]


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_rdm_steps_match_jax_mesh(ranks, mode):
    jstate, jmets = ranks["refs"]["rdm"]
    want = train_state_from_jax(jstate, ranks["cfg"])
    for out in ranks["outs"]:
        got = out[f"rdm_{mode}"]
        for i, m in enumerate(jmets):
            np.testing.assert_allclose(got["loss"][i], m["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"][i], m["grad_norm"],
                                       rtol=1e-5)
        assert got["state"]["step"] == 2
        assert _rel_l2(got["state"]["params"], want["params"]) < 1e-5
        assert _rel_l2(got["state"]["ema"]["params"],
                       want["ema"]["params"]) < 1e-5


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_rarm_steps_match_jax_mesh(ranks, mode):
    jstate, jmets = ranks["refs"]["rarm"]
    want = train_state_from_jax(jstate, ranks["rcfg"])
    for out in ranks["outs"]:
        got = out[f"rarm_{mode}"]
        for i, m in enumerate(jmets):
            np.testing.assert_allclose(got["loss"][i], m["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"][i], m["grad_norm"],
                                       rtol=1e-5)
        assert _rel_l2(got["state"]["params"], want["params"]) < 1e-5
        for t in ("mu", "nu"):
            assert _rel_l2(got["state"]["opt_state"][t],
                           want["opt_state"][t]) < 1e-4


def _one_process_step(make_state, make_step, batch):
    state = make_state()
    state, m = make_step()(state, *batch, 0)
    return m, state.state_dict()


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_rdm_ranks_draw_as_one_process(ranks, mode):
    c, inp = ranks["c"], ranks["inputs"]
    cfg = ranks["cfg"]
    sched = ttrain._port_schedule(cfg)
    m, sd = _one_process_step(
        lambda: W.rdm_state(c, inp["rdm_sd"]),
        lambda: make_train_step(W.rdm_tx(), sched, ema_decay=W.EMA),
        (inp["rdm_z"][0], inp["rdm_nns"][0]))
    for out in ranks["outs"]:
        got = out[f"rdm_free_{mode}"]
        np.testing.assert_allclose(got["loss"][0], float(m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"][0],
                                   float(m["grad_norm"]), rtol=1e-5)
        assert _rel_l2(got["state"]["params"], sd["params"]) < 1e-5


def test_rarm_ranks_draw_as_one_process(ranks):
    c, inp = ranks["c"], ranks["inputs"]
    m, sd = _one_process_step(
        lambda: W.rarm_state(c, inp["rarm_sd"]),
        lambda: make_rarm_train_step(W.rarm_tx(), ema_decay=W.EMA,
                                     p_mask_max=W.P_MASK_MAX),
        (inp["rarm_z"][0], inp["rarm_nns"][0]))
    for out in ranks["outs"]:
        got = out["rarm_free"]
        np.testing.assert_allclose(got["loss"][0], float(m["loss"]),
                                   rtol=1e-5)
        assert _rel_l2(got["state"]["params"], sd["params"]) < 1e-5


@pytest.mark.parametrize("which", ["rdm_fsdp_layout", "trainer_layout"])
def test_fsdp_leaves_are_cut_on_fsdp_spec(ranks, which):
    cut = 0
    for r, out in enumerate(ranks["outs"]):
        layout = out[which]
        params = layout["params"]
        for tree in ("params", "mu", "nu", "ema"):
            assert sorted(layout[tree]) == sorted(params)
            for name, (dim, local) in layout[tree].items():
                pdim, plocal = params[name]
                assert (dim, local) == (pdim, plocal), (tree, name)
        for name, (dim, local) in params.items():
            full = list(local)
            if dim is not None:
                full[dim] *= WORLD
                cut += 1
            assert fsdp_spec(full, WORLD, W.MIN_SIZE) == dim, name
            spec = tuple(j_fsdp_spec(full, WORLD, min_size=W.MIN_SIZE))
            assert dim == (spec.index("data") if "data" in spec else None)
            if int(np.prod(full)) >= W.MIN_SIZE and any(
                    s % WORLD == 0 for s in full):
                assert dim is not None, name
    assert cut > 0


def test_trainer_lr_is_scaled_by_the_data_ranks(ranks):
    for out in ranks["outs"]:
        # accumulate 1 x 2 data ranks x batch 2 x base 1e-3
        assert out["lr"] == pytest.approx(4e-3)


def test_fsdp_checkpoint_world2_resumes_at_world1(ranks):
    d, c = ranks["d"], ranks["c"]
    want = _losses(os.path.join(d, "w2"))[2]
    _copy_step(d, "w2", "w2to1", 2)
    tr = W.rarm_trainer(c, os.path.join(d, "w2to1"))
    state = tr.fit(W.trainer_batches(2, 1), max_steps=3)
    assert state.step == 3
    np.testing.assert_allclose(_losses(os.path.join(d, "w2to1"))[2], want,
                               rtol=1e-5)


def test_checkpoint_world1_resumes_in_fsdp_at_world2(ranks):
    d = ranks["d"]
    np.testing.assert_allclose(_losses(os.path.join(d, "w1to2"))[2],
                               _losses(os.path.join(d, "w1"))[2], rtol=1e-5)


def test_db_sharded_knn_matches_jax(ranks):
    inp = ranks["inputs"]
    emb, q = inp["knn_emb"].numpy(), inp["knn_q"].numpy()
    table = jdb.DataPool(embeddings=emb).device_table(
        dtype=jnp.float32)[:emb.shape[0]]
    search = jax.jit(functools.partial(
        jeng.knn_search, k=6, mesh=j_make_mesh(data=1, db=WORLD)))
    want_s, want_i = search(table, jeng.l2_normalize(jnp.asarray(q)))
    single = RetrievalEngine(DataPool(emb), dtype=torch.float32).search(q, 6)
    for out in ranks["outs"]:
        np.testing.assert_array_equal(out["knn"]["ids"].numpy(),
                                      np.asarray(want_i))
        np.testing.assert_allclose(out["knn"]["scores"].numpy(),
                                   np.asarray(want_s), atol=1e-5)
        assert out["engine_rows"] == emb.shape[0] // WORLD
        for k in ("nns", "scores", "embeddings"):
            torch.testing.assert_close(out["engine"][k], single[k], rtol=0,
                                       atol=0)
        assert "does not divide into 2 db shards" in out["engine_63"]
    assert list(ranks["outs"][0]["knn"]["ids"][0, :4]) == [7, 40, 41, 50]
    assert list(ranks["outs"][0]["knn"]["ids"][1, :2]) == [3, 60]


def _dp_rdm_refs(c, inputs, jm, params, jvq, vq_params, emb, q):
    """One process of the port and JAX's `_maybe_data_parallel` over
    data=2 on the RDM request the ranks make (the port's x_T given to the
    JAX chain as x_init): (port images, JAX images as int32)."""
    p = inputs["pipe_rdm"]
    pipe = RDMPipeline(c["p_rdm"], p["sd"], c["p_rdm_ae"], p["vq_sd"],
                       pool=DataPool(emb), dtype=torch.float32, device="cpu")
    one = pipe.sample_with_query(q, steps=W.STEPS, guidance_scale=W.GUIDANCE,
                                 seed=3)["query_samples"]
    r_emb = np.asarray(jeng.RetrievalEngine(jdb.DataPool(emb)).search(
        jnp.asarray(q), k=4)["embeddings"])
    neighbors = np.concatenate([q[:, None], r_emb[:, :3]], axis=1)
    x_t = torch.randn((GB, 3, 8, 8), generator=torch.Generator().manual_seed(
        3)).numpy().transpose(0, 2, 3, 1)
    sched = JSchedule.create(50, "linear", 0.0015, 0.0195)

    def run(ps, nb, xt):
        prm, vqp = ps
        b, s, _ = nb.shape
        uncond = jm.apply(prm, b, s, 0.0, method=JRDM.uncond_context)
        z, _ = j_ddim_sample(
            lambda x, t, c: jm.apply(prm, x, t, c), sched,
            JSampler(num_steps=W.STEPS, guidance_scale=W.GUIDANCE,
                     cfg_mode="shared"),
            (b, 8, 8, 3), nb, jax.random.PRNGKey(0), uncond_context=uncond,
            x_init=xt)
        return jvq.apply(vqp, z, force_not_quantize=False,
                         method=JVQModel.decode)

    px = _maybe_data_parallel(run, j_make_mesh(data=WORLD), GB)(
        (params, vq_params), jnp.asarray(neighbors), jnp.asarray(x_t))
    return one, j_to_uint8(px).astype(np.int32)


def _dp_rarm_refs(c, inputs, params, vq_params, emb, q):
    """One process of the port (greedy and sampled) and JAX's pipeline
    over data=2 (greedy) on the RARM requests the ranks make."""
    p = inputs["pipe_rarm"]
    pipe = RARMPipeline(c["p_rarm"], p["sd"], c["p_rarm_ae"], p["vq_sd"],
                        pool=DataPool(emb), dtype=torch.float32,
                        device="cpu")
    greedy = pipe.sample_with_query(q, top_k=1, guidance_scale=2.0, seed=3,
                                    return_tokens=True)
    sampled = pipe.sample_with_query(q, top_k=8, temperature=1.0, seed=5,
                                     return_tokens=True)
    jpipe = JRARMPipeline(jrarm.RARMConfig(**trarm.PIPE), params,
                          JAEConfig(**trarm.AE_KW), vq_params,
                          pool=jdb.DataPool(emb), dtype=jnp.float32,
                          mesh=j_make_mesh(data=WORLD))
    want = jpipe.sample_with_query(q, top_k=1, guidance_scale=2.0,
                                   seed=3)["query_samples"].astype(np.int32)
    return greedy, sampled, want


def test_dp_rdm_sampling_matches_one_process_and_jax(ranks):
    one, want = ranks["refs"]["dp_rdm"]
    for out in ranks["outs"]:
        got = out["dp_rdm"]
        assert got.shape == (GB, 16, 16, 3) and got.dtype == np.uint8
        # uint8 truncation may flip a level where pixels differ by less
        # than the f32 tolerance
        assert np.abs(got.astype(np.int32) - one.astype(np.int32)).max() <= 1
        assert np.abs(got.astype(np.int32) - want).max() <= 1
        assert "not divisible by the data axis (2)" in out["dp_rdm_3"]


def test_dp_rarm_sampling_matches_one_process_and_jax(ranks):
    greedy, sampled, want = ranks["refs"]["dp_rarm"]
    for out in ranks["outs"]:
        got = out["dp_rarm"]
        np.testing.assert_array_equal(got["tokens"], greedy["tokens"])
        img = got["query_samples"].astype(np.int32)
        assert np.abs(img - greedy["query_samples"].astype(np.int32)
                      ).max() <= 1
        assert np.abs(img - want).max() <= 1
        np.testing.assert_array_equal(out["dp_rarm_t"]["tokens"],
                                      sampled["tokens"])
