"""Serving pipelines, in PyTorch: RDM (retrieval -> DDIM sampling -> VQ
decode) and RARM (retrieval -> KV-cached token sampling -> VQ decode_code).

Counterpart of `rdm_tpu/pipeline.py` `RDMPipeline` and `RARMPipeline` on
one device, with the RDM serving modes (`int8_weights`, `encoder_reuse`)
and the RARM ones (`int8_weights`, `int8_kv`, `approx_top_k`), and, given
CLIP weights, captions (`embed_caption`, `sample_with_caption`),
inpainting (`sample_inpaint`) and adaptive re-retrieval
(`sample_retro_adaptive`). `from_model_dir` builds either pipeline from
a model directory (config.yaml, and params.npz + first_stage_params.npz
or model.ckpt, or a seeded init); `RDMPipeline.fidelity_run` is the
sampling run the fidelity harness (`eval/fidelity.py`) compares. Public
inputs and outputs keep the JAX layouts: query embeddings [B, D],
neighbors [B, k, D], images NHWC (in: float [-1, 1]; out: uint8 numpy).
Inside, images and latents are NCHW.

Data-parallel sampling (`mesh=`, the counterpart of JAX's
`_maybe_data_parallel`): every rank of the mesh makes the same request;
the batch is split over the `data` axis (it must divide), each rank
samples its rows through the kernels with every draw made at the global
batch's shape and cut to its rows, and the images are gathered in rank
order, so each rank returns what one process would. The table is split
over the `db` axis (`RetrievalEngine`). Inpainting and adaptive
re-retrieval are not split: under a data axis above 1 they raise.

Semantics kept (reference ddpm.py:688-984): unconditional sampling draws
query ids from the nn-memory (or uniformly from the pool), retrieves k
neighbors and conditions on them; query sampling puts the query embedding
in as neighbor #0 unless omitted; the CFG null context is the guidance
vector scaled to norm 0.0, as both reference CLIs pass.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rdm_tpu_torch.config import (AutoencoderConfig, ClipConfig,
                                  DDIMSamplerConfig, RARMConfig, RDMConfig,
                                  first_stage_config_from_yaml, load_config,
                                  model_config_from_yaml)
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.models.clip import (clip_config_from_state_dict,
                                       encode_captions, load_clip_state_dict)
from rdm_tpu_torch.models.init import jax_init_
from rdm_tpu_torch.models.layers import TransformerBlock
from rdm_tpu_torch.models.rarm import (RARM, extract_decode_weights,
                                       sample_tokens_fused)
from rdm_tpu_torch.models.rdm import (RDM, make_denoise_fn,
                                      sample_with_neighbors)
from rdm_tpu_torch.models.retrievers import bind_clip, embed_images
from rdm_tpu_torch.ops import quant
from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.parallel import mesh as pmesh
from rdm_tpu_torch.parallel.distributed import gather_from_ranks
from rdm_tpu_torch.retrieval.database import DataPool, NNMemory
from rdm_tpu_torch.retrieval.engine import RetrievalEngine, l2_normalize
from rdm_tpu_torch.sampling import ddim_retro_sample, ddim_sample
from rdm_tpu_torch.utils import params_io
from rdm_tpu_torch.utils.from_jax import (clip_state_dict_from_jax,
                                          rarm_state_dict_from_jax,
                                          rdm_state_dict_from_jax,
                                          vq_state_dict_from_jax)


def to_uint8(images: torch.Tensor) -> np.ndarray:
    """float [-1, 1] NHWC -> uint8 numpy (truncating, as numpy's astype)."""
    x = ((images.float() + 1.0) / 2.0).clamp(0.0, 1.0)
    return (x * 255).to(torch.uint8).cpu().numpy()


def cast_params_for_inference(module: nn.Module,
                              dtype: torch.dtype = torch.bfloat16
                              ) -> nn.Module:
    """Cast >=2-D parameters to the compute dtype once, keep 1-D ones
    (biases, norm scales, the guidance vector) in f32 — the JAX rule — and
    pack every transformer block's kernel-layout weights once, so no
    sampling step re-casts or re-packs a weight."""
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim >= 2:
                p.data = p.data.to(dtype)
    for m in module.modules():
        if isinstance(m, TransformerBlock):
            m.pack(dtype)
    return module


def _bind(module: nn.Module, params: Mapping[str, Any], device: torch.device,
          dtype: torch.dtype) -> nn.Module:
    """A module built on the meta device, bound to `params`, moved to
    `device` and cast for inference."""
    module.load_state_dict(params, assign=True)
    return cast_params_for_inference(module.to(device).eval(), dtype)


def _load_clip_weights(clip_ckpt: Optional[str]):
    """(CLIP state dict, ClipConfig) from a converted JAX tree (.npz, the
    ViT-B/32 config) or an OpenAI torch checkpoint loaded as it is; (None,
    None) without a file."""
    if not clip_ckpt or not os.path.isfile(clip_ckpt):
        return None, None
    if clip_ckpt.endswith(".npz"):
        cfg = ClipConfig.vit_b32()
        return clip_state_dict_from_jax(
            params_io.load_params_npz(clip_ckpt), cfg), cfg
    sd = load_clip_state_dict(clip_ckpt)
    return sd, clip_config_from_state_dict(sd)


def _scratch_state_dict(module: nn.Module, seed: int) -> Dict[str, Any]:
    """The state dict of `module` under the JAX package's initialisers,
    drawn from `seed` (a trainer's step 0)."""
    return jax_init_(module, torch.Generator().manual_seed(seed)).state_dict()


def _model_dir(model_dir: str, random_init: bool, from_jax, from_ckpt,
               scratch, database: Optional[str], nn_memory: Optional[str],
               clip_ckpt: Optional[str]) -> Dict[str, Any]:
    """What `from_model_dir` hands the pipeline: config.yaml's configs,
    the weights (params.npz through `from_jax` + first_stage_params.npz,
    else model.ckpt through `from_ckpt`, else, or with random_init,
    `scratch`), CLIP and the database files."""
    cfg_yaml = load_config([os.path.join(model_dir, "config.yaml")])
    config = model_config_from_yaml(cfg_yaml)
    fs_config = first_stage_config_from_yaml(cfg_yaml)
    npz = os.path.join(model_dir, "params.npz")
    fs_npz = os.path.join(model_dir, "first_stage_params.npz")
    ckpt = os.path.join(model_dir, "model.ckpt")
    if os.path.isfile(npz) and os.path.isfile(fs_npz) and not random_init:
        params = from_jax(params_io.load_params_npz(npz), config)
        fs_params = vq_state_dict_from_jax(
            params_io.load_params_npz(fs_npz), fs_config)
    elif os.path.isfile(ckpt) and not random_init:
        params, fs_params = from_ckpt(
            params_io.load_torch_state_dict(ckpt), config, fs_config)
    else:
        params, fs_params = scratch(config, fs_config)
    clip_params, clip_config = _load_clip_weights(clip_ckpt)
    return dict(config=config, params=params, first_stage_config=fs_config,
                first_stage_params=fs_params,
                pool=DataPool.load(database) if database else None,
                memory=NNMemory.load(nn_memory) if nn_memory else None,
                clip_params=clip_params, clip_config=clip_config)


def _query_embeddings(retrieval: Optional[RetrievalEngine],
                      memory: Optional[NNMemory], n: int, memsize,
                      use_weights: bool, qids: Optional[np.ndarray],
                      seed: int) -> torch.Tensor:
    """Unnormalised pool rows [n, D] of the unconditional queries: the
    given ids, or ids drawn (numpy, from `seed`) from the top-`memsize` of
    the nn-memory, or uniformly from the pool."""
    if retrieval is None:
        raise ValueError("unconditional sampling requires a database")
    if qids is None:
        rng = np.random.default_rng(seed)
        qids = (memory.sample_qids(n, memsize=memsize,
                                   use_weights=use_weights, rng=rng)
                if memory is not None
                else rng.integers(0, retrieval.size, size=n))
    pool = retrieval.pool.embeddings
    return pool[torch.as_tensor(np.asarray(qids), device=pool.device)]


def _data_rows(mesh, batch: int) -> Optional[Tuple[int, int]]:
    """(first row, global batch) of this rank's rows of a request under a
    data axis above 1, else None."""
    n = pmesh.axis_size(mesh, pmesh.DATA_AXIS)
    if n <= 1:
        return None
    if batch % n:
        raise ValueError(
            f"batch {batch} not divisible by the data axis ({n})")
    return pmesh.axis_rank(mesh, pmesh.DATA_AXIS) * (batch // n), batch


def _split(x: torch.Tensor, rows: Optional[Tuple[int, int]], mesh
           ) -> torch.Tensor:
    """This rank's rows of a global batch."""
    if rows is None:
        return x
    per = rows[1] // pmesh.axis_size(mesh, pmesh.DATA_AXIS)
    return x[rows[0]:rows[0] + per]


def _join(x: torch.Tensor, rows: Optional[Tuple[int, int]], mesh
          ) -> torch.Tensor:
    """Every rank's rows in rank order: the global batch."""
    if rows is None:
        return x
    return gather_from_ranks(x, pmesh.axis_group(mesh, pmesh.DATA_AXIS))


def _no_split(mesh, what: str) -> None:
    if pmesh.axis_size(mesh, pmesh.DATA_AXIS) > 1:
        raise NotImplementedError(f"{what} is not split over a data axis")


class RDMPipeline:
    """Retrieval-augmented diffusion sampling, end to end, on `device`.

    params / first_stage_params are state dicts in the reference names
    (`RDM.state_dict()`, `VQModel.state_dict()`; see
    `utils/from_jax.py` for JAX trees, int8 serving trees included).

    int8 serving mode (`int8_weights=True`, ops/quant.py): the U-Net convs
    but conv_in and the eps head, the VQ decoder's convs but conv_in,
    conv_out and post_quant_conv, and the transformer blocks run weight +
    activation int8. The first request calibrates (`_calibrate_int8`) and
    quantizes the pipeline's modules in place; parameters that already
    carry int8 state need no calibration. Approximate, opt-in; under a
    data axis every rank calibrates on the whole request's neighbors.

    mesh: data-parallel sampling (module docstring); the pipeline then
    runs on this rank's device."""

    def __init__(self, config: RDMConfig, params: Mapping[str, Any],
                 first_stage_config: AutoencoderConfig,
                 first_stage_params: Mapping[str, Any],
                 pool: Optional[DataPool] = None,
                 memory: Optional[NNMemory] = None,
                 clip_params: Optional[Mapping[str, Any]] = None,
                 clip_config: Optional[ClipConfig] = None,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 int8_weights: bool = False, mesh=None):
        self.config = config
        self.dtype = dtype
        self.int8_weights = int8_weights
        self.calibration_seconds: Optional[float] = None
        self.mesh = mesh
        self.device = (pmesh.mesh_device(mesh) if mesh is not None
                       else torch.device(device))
        # built without initialising (meta), then bound to the given
        # weights: the random init of 400M parameters would be thrown away
        with torch.device("meta"):
            model = RDM(config, dtype=dtype)
            first_stage = VQModel(first_stage_config, dtype=dtype,
                                  encoder=False)
        self.model = _bind(model, params, self.device, dtype)
        self.first_stage = _bind(
            first_stage, VQModel.decode_side(first_stage_params),
            self.device, dtype)
        # the encoder side is bound at the first inpaint request
        self._first_stage_params = first_stage_params
        self._first_stage_config = first_stage_config
        self._encoder: Optional[VQModel] = None
        self.clip = (bind_clip(clip_params, clip_config, self.device, dtype)
                     if clip_params is not None else None)
        self.schedule = DiffusionSchedule.create(
            config.timesteps, config.beta_schedule, config.linear_start,
            config.linear_end, device=self.device)
        self.memory = memory
        self.retrieval = (RetrievalEngine(pool, device=self.device, mesh=mesh)
                          if pool is not None else None)
        self._int8_ready = quant.num_quantized(self.model) > 0
        self._twin: Optional[Tuple[RDM, VQModel]] = None

    # ---------- loading ----------

    @classmethod
    def from_model_dir(cls, model_dir: str, *,
                       database: Optional[str] = None,
                       nn_memory: Optional[str] = None,
                       clip_ckpt: Optional[str] = None,
                       random_init: bool = False, seed: int = 0,
                       **kw) -> "RDMPipeline":
        """model_dir holds config.yaml and params.npz +
        first_stage_params.npz (converted JAX trees) or model.ckpt (a
        released checkpoint, its EMA weights); without them, or with
        random_init, the model and first stage take the JAX package's
        initialisers from `seed` and `seed + 1`. database / nn_memory:
        `DataPool` / `NNMemory` files; clip_ckpt: CLIP weights (.npz or an
        OpenAI checkpoint). `kw` go to the constructor (device, dtype,
        int8_weights, mesh)."""
        def from_ckpt(sd, config, fs_config):
            return params_io.rdm_state_dicts(sd, config, fs_config,
                                             use_ema=True)

        def scratch(config, fs_config):
            return (_scratch_state_dict(RDM(config), seed),
                    _scratch_state_dict(VQModel(fs_config), seed + 1))

        return cls(**_model_dir(model_dir, random_init,
                                rdm_state_dict_from_jax, from_ckpt, scratch,
                                database, nn_memory, clip_ckpt), **kw)

    # ---------- conditioning assembly ----------

    def embed_caption(self, caption: str, batch_size: int) -> torch.Tensor:
        """The caption's CLIP text embedding [batch_size, D] f32 on the
        pipeline's device."""
        if self.clip is None:
            raise ValueError("caption sampling requires CLIP weights "
                             "(clip_ckpt)")
        return encode_captions(self.clip, [caption] * batch_size)

    # ---------- sampling ----------

    def sample_unconditional(self, batch_size: int, *,
                             k_nn: Optional[int] = None, steps: int = 100,
                             guidance_scale: float = 2.0, memsize=0.01,
                             use_weights: bool = False,
                             qids: Optional[np.ndarray] = None,
                             seed: int = 0, return_nns: bool = False,
                             encoder_reuse: int = 1) -> Dict[str, Any]:
        """sample_from_rdata equivalent (ddpm.py:877-984)."""
        k_nn = k_nn or self.config.k_nn
        q_emb = _query_embeddings(self.retrieval, self.memory, batch_size,
                                  memsize, use_weights, qids, seed)
        found = self.retrieval.search(q_emb, k=k_nn)
        out = {"samples_with_sampled_nns": self._run_ddim(
            found["embeddings"], steps, guidance_scale, seed, encoder_reuse)}
        if return_nns:
            out["nn_embeddings"] = found["embeddings"].cpu().numpy()
            out["nn_ids"] = found["nns"].cpu().numpy()
        return out

    def sample_with_query(self, query_embeddings, *,
                          k_nn: Optional[int] = None, steps: int = 100,
                          guidance_scale: float = 2.0,
                          omit_query: bool = False, only_query: bool = False,
                          seed: int = 0, encoder_reuse: int = 1
                          ) -> Dict[str, Any]:
        """sample_with_query equivalent (ddpm.py:688-844): the query
        embedding becomes neighbor #0 unless omitted; only_query skips
        retrieval."""
        k_nn = k_nn or self.config.k_nn
        q = torch.as_tensor(query_embeddings, dtype=torch.float32,
                            device=self.device)
        if only_query:
            neighbors = q[:, None]
        else:
            if self.retrieval is None:
                raise ValueError("query sampling with retrieval requires a "
                                 "database")
            r_emb = self.retrieval.search(q, k=k_nn)["embeddings"]
            neighbors = (r_emb if omit_query
                         else torch.cat([q[:, None], r_emb[:, :k_nn - 1]],
                                        dim=1))
        return {"query_samples": self._run_ddim(neighbors, steps,
                                                guidance_scale, seed,
                                                encoder_reuse)}

    def sample_with_caption(self, caption: str, batch_size: int,
                            **kw) -> Dict[str, Any]:
        """Text-to-image: the caption's CLIP embedding as the query of
        `sample_with_query`."""
        return self.sample_with_query(self.embed_caption(caption,
                                                         batch_size), **kw)

    def _vq_encoder(self) -> VQModel:
        """The whole VQ model, encoder side included, bound at first use:
        only inpainting encodes, so serving pipelines skip it until then."""
        if self._encoder is None:
            with torch.device("meta"):
                vq = VQModel(self._first_stage_config, dtype=self.dtype)
            self._encoder = _bind(vq, self._first_stage_params, self.device,
                                  self.dtype)
        return self._encoder

    def sample_inpaint(self, images, mask, neighbors=None, *,
                       k_nn: Optional[int] = None, steps: int = 100,
                       guidance_scale: float = 2.0, seed: int = 0
                       ) -> Dict[str, Any]:
        """Inpainting (the reference's DDIM mask blend, ddim.py:187-190):
        keep `images` where mask == 1, regenerate the rest.

        images [B, H, W, 3] float [-1, 1]; mask [B, h, w, 1] (or
        broadcastable to the NHWC latent) at latent resolution, 1 = keep.
        neighbors [B, k, D] default to a search by the images' own CLIP
        embedding, which needs CLIP weights and a database."""
        _no_split(self.mesh, "inpainting")
        cfg = self.config
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            z0 = self._vq_encoder().encode_prequant(
                x.permute(0, 3, 1, 2)).float() * cfg.scale_factor
            if neighbors is None:
                if self.clip is None or self.retrieval is None:
                    raise ValueError("provide neighbors, or CLIP weights + "
                                     "a database for auto-retrieval")
                neighbors = self.retrieval.search(
                    embed_images(self.clip, x),
                    k=k_nn or cfg.k_nn)["embeddings"]
            ctx = self.model.encode_neighbors(torch.as_tensor(
                neighbors, dtype=torch.float32, device=self.device))
            uncond = (self.model.uncond_context(ctx.shape[0], ctx.shape[1],
                                                0.0).to(self.device)
                      if guidance_scale != 1.0 else None)
            b, c, h, w = z0.shape
            m = torch.as_tensor(mask, dtype=torch.float32,
                                device=self.device).broadcast_to(
                (b, h, w, c)).permute(0, 3, 1, 2)
            sampler = DDIMSamplerConfig(num_steps=steps,
                                        guidance_scale=guidance_scale,
                                        cfg_mode="shared")
            gen = torch.Generator(device=self.device).manual_seed(seed)
            z, _ = ddim_sample(make_denoise_fn(self.model), self.schedule,
                               sampler, tuple(z0.shape), ctx, gen,
                               uncond_context=uncond, mask=m, x0=z0)
            out = self.first_stage.decode(z / cfg.scale_factor)
            return {"inpaint_samples": to_uint8(out.permute(0, 2, 3, 1))}

    def sample_retro_adaptive(self, batch_size: int, *,
                              k_nn: Optional[int] = None, steps: int = 100,
                              guidance_scale: float = 2.0,
                              retro_every: int = 10, memsize=0.01,
                              use_weights: bool = False, seed: int = 0
                              ) -> Dict[str, Any]:
        """Adaptive re-retrieval (the reference's DDIMRetroSampler,
        ddim.py:270-415): queries drawn as in `sample_unconditional`, then
        every `retro_every` DDIM steps the current pred_x0 is decoded,
        CLIP-embedded and searched, and its neighbours become the context,
        all on the pipeline's device. Needs CLIP weights and a database."""
        _no_split(self.mesh, "adaptive re-retrieval")
        if self.retrieval is None:
            raise ValueError("retro sampling requires a database")
        if self.clip is None:
            raise ValueError("retro sampling requires CLIP weights")
        cfg = self.config
        k_nn = k_nn or cfg.k_nn
        eng = self.retrieval
        q_emb = _query_embeddings(eng, self.memory, batch_size, memsize,
                                  use_weights, None, seed)
        with torch.inference_mode():
            init_ctx = eng.search(q_emb, k=k_nn)["embeddings"]

            def reembed(pred_x0):
                img = self.first_stage.decode(pred_x0 / cfg.scale_factor)
                emb = embed_images(self.clip, img.permute(0, 2, 3, 1))
                return eng.neighbors(l2_normalize(emb), k_nn)[2]

            uncond = (self.model.uncond_context(batch_size, k_nn, 0.0)
                      .to(self.device) if guidance_scale != 1.0 else None)
            sampler = DDIMSamplerConfig(num_steps=steps,
                                        guidance_scale=guidance_scale,
                                        cfg_mode="shared")
            gen = torch.Generator(device=self.device).manual_seed(seed)
            z = ddim_retro_sample(
                make_denoise_fn(self.model), self.schedule, sampler,
                (batch_size, cfg.channels, cfg.image_size, cfg.image_size),
                init_ctx, gen, reembed_fn=reembed, retro_every=retro_every,
                uncond_context=uncond)
            out = self.first_stage.decode(z / cfg.scale_factor)
            return {"retro_adaptive_samples": to_uint8(
                out.permute(0, 2, 3, 1))}

    # ---------- int8 serving ----------

    def serving_params(self, neighbors=None, *, steps: int = 50,
                       guidance_scale: float = 2.0, seed: int = 0) -> RDM:
        """The model sampling runs with: int8 (calibrated on `neighbors`
        the first time) when int8_weights is on, else the compute-dtype
        one."""
        if not self.int8_weights:
            return self.model
        if neighbors is None and not self._int8_ready:
            raise ValueError("int8 calibration needs a neighbor batch")
        return self.quantized_params(neighbors, steps=steps,
                                     guidance_scale=guidance_scale,
                                     seed=seed)

    def quantized_params(self, neighbors, *, steps: int = 50,
                         guidance_scale: float = 2.0, seed: int = 0) -> RDM:
        """The int8 model, calibrated once on a real sampling trajectory
        for `neighbors`. The port quantizes the pipeline's own modules in
        place, so this needs int8_weights=True."""
        if not self.int8_weights:
            raise ValueError("quantized_params quantizes the pipeline's "
                             "modules in place; build the pipeline with "
                             "int8_weights=True")
        if not self._int8_ready:
            t0 = time.perf_counter()
            self._calibrate_int8(neighbors.to(self.device), steps,
                                 guidance_scale, seed, self.model,
                                 self.first_stage)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.calibration_seconds = time.perf_counter() - t0
            self._int8_ready = True
        return self.model

    def _calibrate_int8(self, neighbors: torch.Tensor, steps: int,
                        guidance_scale: float, seed: int, model: RDM,
                        fs: VQModel) -> None:
        """Quantize the U-Net `model` and the VQ decoder `fs` in place
        (ops/quant.py): one compute-dtype sampling run gives the final
        latents; the decoder is calibrated on decoding them, the U-Net on
        n_points forwards at q_sample(latents, t) over the DDIM ladder, in
        the exact serving form (shared-prefix CFG context)."""
        with torch.inference_mode():
            z_raw = self._sample(model, neighbors, steps, guidance_scale,
                                 seed, 1).permute(0, 3, 1, 2)
            with quant.calibrate():
                fs.decode(z_raw)
            quant.quantize_conv_tree(fs, quant.collect_absmax(fs),
                                     exclude=quant.decoder_exclude(fs))
            ctx = model.encode_neighbors(neighbors)
            if guidance_scale != 1.0:
                ctx = torch.cat([ctx, model.uncond_context(
                    ctx.shape[0], ctx.shape[1], 0.0).to(ctx.device)])
            gen = torch.Generator(device=self.device).manual_seed(seed)
            absmax = quant.ddim_trajectory_absmax(
                model, z_raw * self.config.scale_factor, self.schedule,
                steps, ctx, model, gen)
            quant.quantize_conv_tree(model, absmax,
                                     exclude=quant.unet_exclude(model.unet))
        for m in model.modules():  # the int8 kernel-layout weights, once
            if isinstance(m, TransformerBlock):
                m.pack(self.dtype)

    # ---------- fidelity ----------

    def fidelity_run(self, neighbors, *, steps: int = 50,
                     guidance_scale: float = 2.0, seed: int = 0,
                     encoder_reuse: int = 1,
                     int8: bool = False) -> Dict[str, np.ndarray]:
        """One sampling run instrumented for the fidelity harness
        (`eval/fidelity.py`): {"z": final latents [B, h, w, C] f32, "images":
        uint8 pixels, "traj": pred_x0 of every step [steps, B, h, w, C] in
        model scale}. Shared-prefix CFG, the null context scaled to norm
        0.0 as in serving; every mode draws the same noise, so runs with
        one seed differ only by the serving approximation under test.

        int8 runs the int8 U-Net and VQ decoder: the pipeline's own where
        it serves int8 (`int8_weights`, or int8 weights given), else a twin
        bound to the same weights and calibrated, as `quantized_params`
        calibrates, on this call's request (kept for later calls), which
        leaves the exact modules exact. An exact run needs modules that are
        not int8."""
        _no_split(self.mesh, "fidelity_run")
        nbrs = torch.as_tensor(neighbors, dtype=torch.float32,
                               device=self.device)
        if int8:
            model, fs = self._int8_modules(nbrs, steps, guidance_scale,
                                           seed)
        elif self._int8_ready:
            raise ValueError("the pipeline's modules run int8: an exact "
                             "fidelity run needs a pipeline built without "
                             "int8 weights")
        else:
            model, fs = self.model, self.first_stage
        sampler = DDIMSamplerConfig(num_steps=steps,
                                    guidance_scale=guidance_scale,
                                    cfg_mode="shared", log_every_t=1,
                                    encoder_reuse=encoder_reuse)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            z, traj = sample_with_neighbors(
                model, nbrs, self.schedule, sampler, gen,
                guidance_label=0.0, return_intermediates=True)
            images = fs.decode(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            return {"z": z.float().cpu().numpy(), "images": to_uint8(images),
                    "traj": traj.float().cpu().numpy()}

    def _int8_modules(self, neighbors: torch.Tensor, steps: int,
                      guidance_scale: float, seed: int
                      ) -> Tuple[RDM, VQModel]:
        """(int8 U-Net, VQ decoder) for an int8 fidelity run: the
        pipeline's own where they serve int8 (the decoder int8 where
        calibration made it so), else the calibrated twin."""
        if self.int8_weights or self._int8_ready:
            return (self.serving_params(neighbors, steps=steps,
                                        guidance_scale=guidance_scale,
                                        seed=seed), self.first_stage)
        if self._twin is None:
            with torch.device("meta"):
                model = RDM(self.config, dtype=self.dtype)
                fs = VQModel(self.first_stage.config, dtype=self.dtype,
                             encoder=False)
            # bound to the exact modules' tensors: quantizing adds int8
            # state to the twin's modules and changes none of the weights
            model = _bind(model, self.model.state_dict(), self.device,
                          self.dtype)
            fs = _bind(fs, self.first_stage.state_dict(), self.device,
                       self.dtype)
            self._calibrate_int8(neighbors, steps, guidance_scale, seed,
                                 model, fs)
            self._twin = (model, fs)
        return self._twin

    def serving_fs_params(self) -> VQModel:
        """The first stage the decode runs with (int8 after the int8
        calibration)."""
        return self.first_stage

    def _sample(self, model: RDM, neighbors: torch.Tensor, steps: int,
                guidance_scale: float, seed: int, encoder_reuse: int,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        sampler = DDIMSamplerConfig(num_steps=steps,
                                    guidance_scale=guidance_scale,
                                    cfg_mode="shared",
                                    encoder_reuse=encoder_reuse)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return sample_with_neighbors(model, neighbors, self.schedule,
                                     sampler, gen, guidance_label=0.0,
                                     rows=rows)

    def _run_ddim(self, neighbors: torch.Tensor, steps: int,
                  guidance_scale: float, seed: int,
                  encoder_reuse: int = 1) -> np.ndarray:
        neighbors = neighbors.to(self.device)
        model = self.serving_params(neighbors, steps=steps,
                                    guidance_scale=guidance_scale, seed=seed)
        rows = _data_rows(self.mesh, neighbors.shape[0])
        with torch.inference_mode():
            z = self._sample(model, _split(neighbors, rows, self.mesh),
                             steps, guidance_scale, seed, encoder_reuse,
                             rows)
            images = self.serving_fs_params().decode(z.permute(0, 3, 1, 2))
            images = _join(images.permute(0, 2, 3, 1).contiguous(), rows,
                           self.mesh)
            return to_uint8(images)


class RARMPipeline:
    """Retrieval-augmented autoregressive sampling (KV-cached), end to end,
    on `device`.

    params / first_stage_params are state dicts in the reference names
    (`RARM.state_dict()`, `VQModel.state_dict()`; see `utils/from_jax.py`
    for JAX trees). Every layer's kernel-layout decode weights are packed
    once here, and their int8 form once, at the first request with
    `int8_weights` (quantized from the bf16 parameters, as the JAX pipeline
    quantizes its bf16-cast tree). Sampling always runs
    `sample_tokens_fused`: the decode kernels on CUDA, their plain versions
    on the CPU. Semantics kept from
    the JAX pipeline (reference transformer.py:296-391): unconditional
    sampling draws query ids from the top-`memsize` of the nn-memory (or
    uniformly from the pool) and conditions on their k neighbors; query
    sampling puts the query embedding in as neighbor #0 followed by k - 1
    retrieved ones, or alone (`only_query`), or a zero context
    (`unconditional`); the CFG null context is zeros_like(neighbors);
    token grids go through `decode_code` to NHWC uint8. mesh:
    data-parallel sampling (module docstring)."""

    def __init__(self, config: RARMConfig, params: Mapping[str, Any],
                 first_stage_config: AutoencoderConfig,
                 first_stage_params: Mapping[str, Any],
                 pool: Optional[DataPool] = None,
                 memory: Optional[NNMemory] = None,
                 clip_params: Optional[Mapping[str, Any]] = None,
                 clip_config: Optional[ClipConfig] = None,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 mesh=None):
        self.config = config
        self.mesh = mesh
        self.device = (pmesh.mesh_device(mesh) if mesh is not None
                       else torch.device(device))
        with torch.device("meta"):  # bound to the given weights below
            model = RARM(config, dtype=dtype)
            first_stage = VQModel(first_stage_config, dtype=dtype,
                                  encoder=False)
        self.model = _bind(model, params, self.device, dtype)
        self.first_stage = _bind(
            first_stage, VQModel.decode_side(first_stage_params),
            self.device, dtype)
        self.decode_weights = extract_decode_weights(self.model, dtype)
        self._decode_weights_int8 = None
        self.memory = memory
        self.retrieval = (RetrievalEngine(pool, device=self.device, mesh=mesh)
                          if pool is not None else None)
        self.clip = (bind_clip(clip_params, clip_config, self.device, dtype)
                     if clip_params is not None else None)

    @classmethod
    def from_model_dir(cls, model_dir: str, *,
                       database: Optional[str] = None,
                       nn_memory: Optional[str] = None,
                       clip_ckpt: Optional[str] = None,
                       random_init: bool = False, seed: int = 0,
                       **kw) -> "RARMPipeline":
        """As `RDMPipeline.from_model_dir`: params.npz +
        first_stage_params.npz, else model.ckpt (the transformer under
        `transformer.`, no EMA swap, as the JAX pipeline reads it), else,
        or with random_init, the JAX package's initialisers from `seed`
        (the first stage's decode side from `seed + 1`)."""
        def scratch(config, fs_config):
            return (_scratch_state_dict(RARM(config), seed),
                    _scratch_state_dict(VQModel(fs_config, encoder=False),
                                        seed + 1))

        return cls(**_model_dir(model_dir, random_init,
                                rarm_state_dict_from_jax,
                                params_io.rarm_state_dicts, scratch,
                                database, nn_memory, clip_ckpt), **kw)

    def embed_caption(self, caption: str, batch_size: int) -> torch.Tensor:
        """The caption's CLIP text embedding [batch_size, D] f32 on the
        pipeline's device."""
        if self.clip is None:
            raise ValueError("caption sampling requires CLIP weights")
        return encode_captions(self.clip, [caption] * batch_size)

    def sample_unconditional(self, batch_size: int, *, k_nn: int = 4,
                             top_k: int = 256, temperature: float = 1.0,
                             guidance_scale: float = 1.0, memsize=100,
                             use_weights: bool = False,
                             qids: Optional[np.ndarray] = None,
                             seed: int = 0, **options) -> Dict[str, Any]:
        """sample_from_rdata equivalent. `options` go to `_generate`."""
        q_emb = _query_embeddings(self.retrieval, self.memory, batch_size,
                                  memsize, use_weights, qids, seed)
        found = self.retrieval.search(q_emb, k=k_nn)
        return self._generate(found["embeddings"], "samples_with_sampled_nns",
                              top_k, temperature, guidance_scale, seed,
                              **options)

    def sample_with_query(self, query_embeddings, *, k_nn: int = 4,
                          top_k: int = 256, temperature: float = 1.0,
                          guidance_scale: float = 1.0,
                          only_query: bool = False,
                          unconditional: bool = False, seed: int = 0,
                          **options) -> Dict[str, Any]:
        """Query-conditioned sampling. `options` go to `_generate`."""
        q = torch.as_tensor(query_embeddings, dtype=torch.float32,
                            device=self.device)
        if unconditional:
            neighbors = torch.zeros_like(q)[:, None]
        elif only_query:
            neighbors = q[:, None]
        else:
            if self.retrieval is None:
                raise ValueError("query sampling with retrieval requires a "
                                 "database (use only_query/unconditional "
                                 "otherwise)")
            r_emb = self.retrieval.search(q, k=k_nn)["embeddings"]
            neighbors = torch.cat([q[:, None], r_emb[:, :k_nn - 1]], dim=1)
        return self._generate(neighbors, "query_samples", top_k, temperature,
                              guidance_scale, seed, **options)

    def _generate(self, neighbors: torch.Tensor, key: str, top_k: int,
                  temperature: float, guidance_scale: float, seed: int, *,
                  return_tokens: bool = False, partition: bool = False,
                  **options) -> Dict[str, Any]:
        """{key: images [B, H, W, 3] uint8} (+ 'tokens' [B, seq_len]).
        `options` (batched_commit, approx_top_k, int8_weights, int8_kv) go
        to `sample_tokens_fused`. `partition` is accepted for the JAX
        pipeline's callers and changes nothing: under a data axis each
        rank's decode kernels already see only its rows."""
        del partition
        gen = torch.Generator(device=self.device).manual_seed(seed)
        side = self.config.code_side
        rows = _data_rows(self.mesh, neighbors.shape[0])
        neighbors = _split(neighbors.to(self.device, torch.float32), rows,
                           self.mesh)
        with torch.inference_mode():
            tokens = sample_tokens_fused(
                self.model, neighbors, gen,
                temperature=temperature, top_k=top_k,
                guidance_scale=guidance_scale,
                weights=self.serving_decode_weights(
                    options.get("int8_weights", False)),
                rows=rows, **options)
            images = self.first_stage.decode_code(
                tokens.reshape(-1, side, side))
            images = _join(images.permute(0, 2, 3, 1).contiguous(), rows,
                           self.mesh)
            tokens = _join(tokens, rows, self.mesh)
            out = {key: to_uint8(images)}
        if return_tokens:
            out["tokens"] = tokens.cpu().numpy()
        return out

    def serving_decode_weights(self, int8_weights: bool = False):
        """The decode weights a request runs with: the bf16 ones, or their
        int8 form, packed at first use and kept."""
        if not int8_weights:
            return self.decode_weights
        if self._decode_weights_int8 is None:
            with torch.inference_mode():
                self._decode_weights_int8 = extract_decode_weights(
                    self.model, self.model.dtype, int8_weights=True)
        return self._decode_weights_int8
