"""The fused block's training path (`fused_transformer_block_ad`) against
the JAX package, on the CPU.

- Gradients with respect to every parameter, x and the context, and the
  value, against JAX's `FusedTransformerBlock` in training
  (`fused_transformer_block_ad`, its Pallas kernels in interpret mode) and
  against the port's own unfused block, at the cases and tolerances of
  tests/test_block_kernel.py's `test_fused_block_training_grad_parity`:
  (heads 4, f32, 2e-4), (6, f32, 2e-4), (4, bf16, 5e-2), each gradient
  held relative to max(max|ref|, 1e-3) of its own leaf.
- The training forward equals the inference path's bit for bit (the same
  kernel sequence; the plain versions here), under RDM_TPU_SPLIT_K3=0 too.
- `block_reference` against the JAX `_xla_block_reference` on the same
  packed weights (f32, 1e-4).
- The routes of a SpatialTransformer: train mode plus
  RDM_TPU_FUSED_BLOCK_TRAIN=1 takes the AD path, dropout > 0 the unfused
  blocks, eval the fused inference path on the `pack()` snapshot; after an
  optimizer step a training forward sees the new weights.
- A tiny RDM train step with the flag: every gradient equal to the
  unfused step's (f32, atol 1e-5 x the largest gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models.layers import FusedTransformerBlock as JFused
from rdm_tpu.models.layers import TransformerBlock as JBlock
from rdm_tpu.ops import block_kernel as jbk
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models import layers
from rdm_tpu_torch.models.rdm import RDM
from rdm_tpu_torch.ops import block_kernel as bk
from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.training.train_state import compute_grads
from rdm_tpu_torch.utils import from_jax
from test_torch_port_unet import seeded_params

B, S, T, DC = 2, 16, 4, 64  # tests/test_block_kernel.py's _mk
CASES = [(4, 32, "float32", 2e-4), (6, 32, "float32", 2e-4),
         (4, 32, "bfloat16", 5e-2)]


def _port_sd(tree):
    """A JAX TransformerBlock tree (params or their gradients) in the
    port's TransformerBlock names."""
    inv = from_jax._Inverse(tree)
    from_jax._transformer_block(inv, "", "")
    return inv.sd


def _setup(heads, head_dim, dtype, seed=11):
    c = heads * head_dim
    rng = np.random.default_rng(seed)
    x, wgt = (rng.standard_normal((B, S, c)).astype(np.float32)
              for _ in range(2))
    ctx = rng.standard_normal((B, T, DC)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    x, ctx, wgt = (np.array(jnp.asarray(a).astype(jdt).astype(jnp.float32))
                   for a in (x, ctx, wgt))  # the dtype's values, exactly
    params = seeded_params(JBlock(heads=heads, head_dim=head_dim).init(
        jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(ctx)), seed)
    blk = layers.TransformerBlock(c, DC, heads, head_dim)
    blk.load_state_dict(_port_sd(params["params"]))
    return params, blk, x, ctx, wgt


def _jax_grads(params, x, ctx, wgt, heads, head_dim, dtype):
    jdt = jnp.dtype(dtype)
    fused = JFused(heads=heads, head_dim=head_dim, dtype=jdt, interpret=True)
    w = jnp.asarray(wgt).astype(jdt)

    def loss(p, x_, c_):
        y = fused.apply(p, x_, c_, deterministic=False)
        return jnp.sum((y * w).astype(jnp.float32))

    v, (gp, gx, gc) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        params, jnp.asarray(x).astype(jdt), jnp.asarray(ctx).astype(jdt))
    want = _port_sd(gp["params"])
    want["x"] = torch.from_numpy(np.array(gx, np.float32))
    want["context"] = torch.from_numpy(np.array(gc, np.float32))
    return float(v), want


def _port_grads(blk, x, ctx, wgt, dtype, fused: bool):
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(dt).requires_grad_()
    ct = torch.from_numpy(ctx).to(dt).requires_grad_()
    blk.zero_grad(set_to_none=True)
    y = blk.forward_fused_ad(xt, ct) if fused else blk(xt, ct)
    v = (y * torch.from_numpy(wgt).to(dt)).float().sum()
    v.backward()
    got = {n: p.grad for n, p in blk.named_parameters()}
    got.update(x=xt.grad, context=ct.grad)
    return v.item(), got


def _assert_grads(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for n, a in want.items():
        a = a.float().numpy()
        b = got[n].float().numpy()
        denom = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(b / denom, a / denom, rtol=tol, atol=tol,
                                   err_msg=f"{what}: {n}")


@pytest.mark.parametrize("heads,head_dim,dtype,tol", CASES)
def test_block_ad_gradients_match_jax_and_unfused(heads, head_dim, dtype,
                                                  tol):
    params, blk, x, ctx, wgt = _setup(heads, head_dim, dtype)
    v_ref, want = _jax_grads(params, x, ctx, wgt, heads, head_dim, dtype)
    v, got = _port_grads(blk, x, ctx, wgt, dtype, fused=True)
    assert all(g is not None for g in got.values())
    sc = max(1.0, abs(v_ref))
    assert abs(v - v_ref) / sc < tol
    _assert_grads(got, want, tol, "vs JAX fused_transformer_block_ad")
    v_unf, unfused = _port_grads(blk, x, ctx, wgt, dtype, fused=False)
    assert abs(v - v_unf) / sc < tol
    _assert_grads(got, unfused, tol, "vs the port's unfused block")


@pytest.mark.parametrize("split_k3", ["1", "0"])
def test_block_ad_value_equals_inference(split_k3, monkeypatch):
    monkeypatch.setenv("RDM_TPU_SPLIT_K3", split_k3)
    _, blk, x, ctx, _ = _setup(4, 32, "float32", seed=13)
    xt, ct = torch.from_numpy(x), torch.from_numpy(ctx)
    with torch.no_grad():
        want = blk.forward_fused(xt, ct)
    got = blk.forward_fused_ad(xt.requires_grad_(), ct)
    assert got.requires_grad and torch.equal(got.detach(), want)


def test_block_reference_matches_jax_reference():
    heads, hd = 6, 32
    _, blk, x, ctx, _ = _setup(heads, hd, "float32", seed=5)
    w = bk.pack_block_weights(blk, torch.float32)
    ck, cv = bk.context_kv(torch.from_numpy(ctx), w)
    got = bk.block_reference(torch.from_numpy(x), ck, cv, w, heads=heads,
                             head_dim=hd)
    # JAX's packing: each third of wqkv padded to 128 lanes per head
    # group, wo padded to match, [1, n] norms and biases
    cp = 256
    jw = {k: jnp.asarray(v.numpy()) for k, v in w.items()}
    jw = {k: (v[None] if v.ndim == 1 else v) for k, v in jw.items()}
    jw["wqkv"] = jnp.concatenate([
        jbk.pack_head_lanes(jw["wqkv"][:, i * 192:(i + 1) * 192], heads, hd,
                            cp) for i in range(3)], axis=1)
    jw["wo"] = jnp.pad(jw["wo"], ((0, cp - 192), (0, 0)))
    want = jbk._xla_block_reference(jnp.asarray(x), jnp.asarray(ck.numpy()),
                                    jnp.asarray(cv.numpy()), jw, heads=heads,
                                    head_dim=hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------------ routes

def _spatial(dropout=0.0):
    torch.manual_seed(0)
    st = layers.SpatialTransformer(32, 8, heads=1, head_dim=32,
                                   dropout=dropout)
    return st, torch.randn(1, 32, 4, 4), torch.randn(1, 2, 8)


def _spy(monkeypatch, calls):
    for name in ("forward_fused", "forward_fused_ad"):
        real = getattr(layers.TransformerBlock, name)

        def spy(self, x, c, _real=real, _name=name):
            calls.append(_name)
            return _real(self, x, c)

        monkeypatch.setattr(layers.TransformerBlock, name, spy)


def test_routes_train_flag_dropout_eval(monkeypatch):
    calls = []
    _spy(monkeypatch, calls)
    st, x, ctx = _spatial()
    st.train()
    st(x, ctx)
    assert calls == []  # default off: the unfused blocks
    monkeypatch.setenv("RDM_TPU_FUSED_BLOCK_TRAIN", "1")
    y = st(x, ctx)
    assert calls == ["forward_fused_ad"] and y.requires_grad
    y.sum().backward()
    blk = st.transformer_blocks[0]
    assert all(p.grad is not None for p in blk.parameters())
    monkeypatch.setenv("RDM_TPU_FUSED_BLOCK", "0")  # the master switch
    st(x, ctx)
    assert calls == ["forward_fused_ad"]
    monkeypatch.delenv("RDM_TPU_FUSED_BLOCK")
    st.eval()
    blk.pack(torch.float32)
    seen = []
    real = layers.fused_transformer_block
    monkeypatch.setattr(layers, "fused_transformer_block",
                        lambda x_, c_, w, **kw: seen.append(w) or real(
                            x_, c_, w, **kw))
    with torch.no_grad():
        st(x, ctx)
    assert calls[-1] == "forward_fused" and seen[0] is blk._packed
    dropped, x, ctx = _spatial(dropout=0.1)
    dropped.train()
    n = len(calls)
    dropped(x, ctx)
    assert len(calls) == n  # dropout > 0: unfused, as in JAX


def test_training_forward_sees_the_new_weights(monkeypatch):
    monkeypatch.setenv("RDM_TPU_FUSED_BLOCK_TRAIN", "1")
    st, x, ctx = _spatial()
    blk = st.transformer_blocks[0]
    blk.pack(torch.float32)  # a serving snapshot, stale after the step
    opt = torch.optim.SGD(st.parameters(), lr=0.5)
    st.train()
    st(x, ctx).square().mean().backward()
    opt.step()
    h = torch.randn(1, 16, 32)
    got = blk.forward_fused_ad(h, ctx)
    with torch.no_grad():
        want = blk(h, ctx)  # the unfused block on the live weights
        stale = bk.fused_transformer_block(h, ctx, blk._packed, heads=1,
                                           head_dim=32)
    torch.testing.assert_close(got.detach(), want, rtol=1e-5, atol=1e-5)
    assert (got.detach() - stale).abs().max() > 1e-3


def test_rdm_train_step_fused_equals_unfused(monkeypatch):
    unet = pc.UNetConfig(in_channels=2, out_channels=2, model_channels=32,
                         num_res_blocks=1, attention_resolutions=(1,),
                         channel_mult=(1,), num_head_channels=32,
                         context_dim=8)
    cfg = pc.RDMConfig(unet=unet, image_size=4, channels=2, timesteps=20,
                       context_dim=8, k_nn=2, p_uncond=0.5)
    torch.manual_seed(3)
    model = RDM(cfg)
    schedule = DiffusionSchedule.create(cfg.timesteps, cfg.beta_schedule,
                                        cfg.linear_start, cfg.linear_end)
    g = torch.Generator().manual_seed(4)
    z = torch.randn(2, 2, 4, 4, generator=g)
    nns = torch.randn(2, 1, 2, 8, generator=g)
    draws = dict(t=torch.tensor([3, 17]), noise=torch.randn(2, 2, 4, 4),
                 drop=torch.tensor([False, True]))
    grads, calls = {}, []
    real = layers.TransformerBlock.forward_fused_ad
    monkeypatch.setattr(layers.TransformerBlock, "forward_fused_ad",
                        lambda self, x, c: calls.append(1) or real(
                            self, x, c))
    for flag in ("0", "1"):
        monkeypatch.setenv("RDM_TPU_FUSED_BLOCK_TRAIN", flag)
        calls.clear()
        _, _, grads[flag] = compute_grads(model, z, nns, g, schedule,
                                          **draws)
        n_blocks = sum(isinstance(m, layers.TransformerBlock)
                       for m in model.modules())
        assert len(calls) == (n_blocks if flag == "1" else 0) and n_blocks
    scale = max(t.abs().max().item() for t in grads["0"].values()
                if t is not None)
    for n, want in grads["0"].items():
        got = grads["1"][n]
        assert (got is None) == (want is None), n
        if want is not None:
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-5 * scale, msg=n)
