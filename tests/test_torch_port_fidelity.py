"""The fidelity harness in the port (`RDMPipeline.fidelity_run` +
`eval/fidelity.py`) on the CPU.

- JAX's envelope tests (tests/test_fidelity.py:92-149) on the port's tiny
  pipeline, built by `from_model_dir(random_init=True)` from the same
  YAML, its eps head drawn normal(0.05) as JAX's test does (the JAX
  initialisers zero it, which makes every mode bit-identical), with the
  same thresholds: exact self-agreement, encoder reuse, int8 and int8 +
  reuse.
- The int8 twin: an int8 run quantizes a twin bound to the same weights
  and leaves the pipeline's modules exact (an exact run after it is bit
  for bit the one before); a pipeline whose own modules run int8 refuses
  an exact run.
- The trajectory `fidelity_run` takes (z and every step's pred_x0) against
  JAX's `sample_with_neighbors(return_intermediates=True)` from the same
  x_T (the pipeline's generator draws it first; JAX's `ddim_sample` gets
  it as `x_init`, as tests/test_torch_port_slice.py shares it), f32 on
  both sides, within 2e-3 x max(1, |ref|).
- `rdm_tpu_torch.scripts.quality_eval` end to end on a random-init model
  directory: the report JSON and the PNG grid.
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import rdm as jrdm
from rdm_tpu.ops.schedules import DiffusionSchedule as JSchedule
from rdm_tpu.sampling import DDIMSamplerConfig as JSampler
from rdm_tpu_torch.eval.fidelity import compare_runs
from rdm_tpu_torch.ops import quant
from rdm_tpu_torch.pipeline import RDMPipeline
from rdm_tpu_torch.retrieval.database import DataPool
from test_torch_port_slice import _close, _models

@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny models: one intra-op thread, so that the suite's workers do
    not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


YAML = """
model:
  target: rdm.models.diffusion.ddpm.MinimalRETRODiffusion
  params:
    k_nn: 3
    timesteps: 50
    image_size: 8
    channels: 3
    unet_config:
      params:
        in_channels: 3
        out_channels: 3
        model_channels: 16
        attention_resolutions: [2]
        num_res_blocks: 1
        channel_mult: [1, 2]
        num_head_channels: 8
        context_dim: 24
    first_stage_config:
      params:
        embed_dim: 3
        n_embed: 32
        ddconfig:
          z_channels: 3
          resolution: 16
          in_channels: 3
          out_ch: 3
          ch: 8
          ch_mult: [1, 2]
          num_res_blocks: 1
          attn_resolutions: []
"""


@pytest.fixture(scope="module")
def tiny_pipe(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("fid")
    mdir, db = tmp_path / "rdm", tmp_path / "db"
    mdir.mkdir()
    db.mkdir()
    (mdir / "config.yaml").write_text(textwrap.dedent(YAML))
    emb = np.random.default_rng(0).standard_normal(
        (64, 24)).astype(np.float32)
    np.savez(db / "part0.npz", embedding=emb, img_id=np.arange(64),
             patch_coords=np.zeros((64, 4), int))
    pipe = RDMPipeline.from_model_dir(str(mdir), database=str(db),
                                      random_init=True, device="cpu")
    # the eps head is zero at the JAX init, which makes every serving mode
    # bit-identical: drawn as JAX's test draws it
    head = pipe.model.unet.out[2].weight
    with torch.no_grad():
        head.copy_((torch.randn(head.shape, generator=torch.Generator()
                                .manual_seed(9)) * 0.05).to(head))
    neighbors = pipe.retrieval.search(emb[:2], k=3)["embeddings"]
    return pipe, neighbors


def test_fidelity_exact_self_agreement(tiny_pipe):
    pipe, neighbors = tiny_pipe
    a = pipe.fidelity_run(neighbors, steps=4, seed=0)
    b = pipe.fidelity_run(neighbors, steps=4, seed=0)
    assert a["traj"].shape[0] >= 4
    assert a["traj"].shape[1:] == a["z"].shape
    assert a["images"].shape == (2, 16, 16, 3)
    rec = compare_runs(a, b)
    assert rec["latent_psnr_db"] == float("inf")
    assert rec["pred_x0_cosine_min"] == 1.0
    c = pipe.fidelity_run(neighbors, steps=4, seed=1)
    assert not np.array_equal(a["z"], c["z"])


def test_fidelity_encoder_reuse_envelope(tiny_pipe):
    pipe, neighbors = tiny_pipe
    exact = pipe.fidelity_run(neighbors, steps=8, seed=0)
    reuse2 = pipe.fidelity_run(neighbors, steps=8, seed=0, encoder_reuse=2)
    rec = compare_runs(exact, reuse2)
    assert rec["latent_cosine"] > 0.98
    assert rec["pred_x0_cosine_min"] > 0.95
    assert np.isfinite(rec["latent_psnr_db"])
    reuse1 = pipe.fidelity_run(neighbors, steps=8, seed=0, encoder_reuse=1)
    np.testing.assert_array_equal(exact["z"], reuse1["z"])


def test_fidelity_int8_envelope_and_twin(tiny_pipe):
    pipe, neighbors = tiny_pipe
    exact = pipe.fidelity_run(neighbors, steps=4, seed=0)
    q = pipe.fidelity_run(neighbors, steps=4, seed=0, int8=True)
    twin, twin_fs = pipe._twin
    assert quant.num_quantized(twin) > 0
    assert quant.num_quantized(twin_fs) > 0  # the calibrated int8 decoder
    assert quant.num_quantized(pipe.model) == 0
    assert quant.num_quantized(pipe.first_stage) == 0
    rec = compare_runs(exact, q)
    assert rec["pred_x0_cosine_min"] > 0.95
    assert rec["latent_cosine"] > 0.95
    assert rec["image_psnr_db"] > 20.0
    assert rec["latent_psnr_db"] < float("inf")  # int8 is approximate
    combo = pipe.fidelity_run(neighbors, steps=4, seed=0, int8=True,
                              encoder_reuse=2)
    rec2 = compare_runs(exact, combo)
    assert rec2["latent_cosine"] > 0.9
    assert np.isfinite(rec2["image_psnr_db"])
    # the twin shares the weights and leaves the exact modules exact
    again = pipe.fidelity_run(neighbors, steps=4, seed=0)
    for key in ("z", "images", "traj"):
        np.testing.assert_array_equal(again[key], exact[key])
    assert pipe._twin[0] is twin  # calibrated once
    assert (twin.unet.out[2].weight.data_ptr()
            == pipe.model.unet.out[2].weight.data_ptr())


def test_int8_pipeline_runs_its_own_int8_and_refuses_exact(tiny_pipe):
    pipe, neighbors = tiny_pipe
    p8 = RDMPipeline(pipe.config, pipe.model.state_dict(),
                     pipe.first_stage.config, pipe._first_stage_params,
                     dtype=pipe.dtype, device="cpu", int8_weights=True)
    q = p8.fidelity_run(neighbors, steps=4, seed=0, int8=True)
    assert p8._twin is None and quant.num_quantized(p8.model) > 0
    want = pipe.fidelity_run(neighbors, steps=4, seed=0, int8=True)
    np.testing.assert_array_equal(q["z"], want["z"])
    with pytest.raises(ValueError, match="exact"):
        p8.fidelity_run(neighbors, steps=4, seed=0)


def test_trajectory_matches_jax_sample_with_neighbors(monkeypatch):
    (jm, params, _, _), (cfg, sd, ae, vq_sd) = _models(seed=21)
    emb = np.random.default_rng(22).standard_normal((50, 24)).astype(
        np.float32)
    pipe = RDMPipeline(cfg, sd, ae, vq_sd, pool=DataPool(emb),
                       dtype=torch.float32, device="cpu")
    neighbors = emb[np.random.default_rng(23).integers(0, 50, (2, 4))]
    seed, steps, guidance = 5, 6, 2.0
    got = pipe.fidelity_run(neighbors, steps=steps, seed=seed,
                            guidance_scale=guidance)
    x_t = torch.randn((2, 3, 8, 8), generator=torch.Generator().manual_seed(
        seed)).numpy().transpose(0, 2, 3, 1)
    real = jrdm.ddim_sample
    monkeypatch.setattr(jrdm, "ddim_sample", lambda *a, **k: real(
        *a, x_init=jnp.asarray(x_t), **k))
    z, traj = jrdm.sample_with_neighbors(
        jm, params, jnp.asarray(neighbors),
        JSchedule.create(50, "linear", 0.0015, 0.0195),
        JSampler(num_steps=steps, guidance_scale=guidance, cfg_mode="shared",
                 log_every_t=1),
        jax.random.PRNGKey(0), guidance_label=0.0,
        return_intermediates=True)
    assert got["traj"].shape == np.asarray(traj).shape
    assert got["traj"].shape[0] >= steps  # the DDIM ladder may round up
    _close(got["z"], z)
    _close(got["traj"], traj)


def test_quality_eval_cli(tmp_path):
    """The CLI end to end on a random-init model directory: the report
    JSON (JAX's keys), the PNG grid (exact row on top, one row per mode)
    and, with --randomize_head, modes that differ from exact."""
    import json

    from PIL import Image

    from rdm_tpu_torch.scripts import quality_eval

    mdir, db, out = tmp_path / "rdm", tmp_path / "db", tmp_path / "out"
    mdir.mkdir()
    db.mkdir()
    (mdir / "config.yaml").write_text(textwrap.dedent(YAML))
    emb = np.random.default_rng(1).standard_normal((64, 24)).astype(
        np.float32)
    np.savez(db / "part0.npz", embedding=emb, img_id=np.arange(64),
             patch_coords=np.zeros((64, 4), int))
    report = quality_eval.main([
        "--model_path", str(mdir), "--database", str(db), "--random_init",
        "--randomize_head", "--modes", "reuse2,int8,int8+reuse2",
        "-bs", "2", "--steps", "4", "--k_nn", "3", "--out", str(out),
        "--device", "cpu"])
    assert json.load(open(out / "quality_report.json")) == json.loads(
        json.dumps(report))
    assert set(report["modes"]) == {"reuse2", "int8", "int8+reuse2"}
    assert report["weights"] == "random-synthetic"
    for rec in report["modes"].values():
        assert rec["latent_psnr_db"] < float("inf")  # not exact's latents
        assert rec["latent_cosine"] > 0.9
        assert len(rec["pred_x0_cosine_per_step"]) >= 4
    grid = np.asarray(Image.open(out / "quality_grid.png"))
    assert grid.shape == (4 * 16, 2 * 16, 3) and grid.dtype == np.uint8
    with pytest.raises(SystemExit, match="unknown mode"):
        quality_eval.parse_mode("int8+fast")
