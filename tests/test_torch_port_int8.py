"""The port's RDM serving modes against the JAX package, on the CPU: int8
weights + activations (the int8 conv, calibration, the four int8 block
kernels' plain versions, the int8 U-Net and VQ decode, `num_quantized`)
and encoder reuse (the DDIM chain with a cached down path).

Inputs come from numpy seeds and go to both sides. The JAX block kernels
run in Pallas interpret mode, as tests/test_block_kernel.py runs them; a
spy on `pl.pallas_call` captures each int8 kernel's inputs and outputs, so
each plain version is held against its own TPU kernel on the same inputs.
Tolerances: the int8 kernels, U-Net and decode atol = 1e-3 x max|ref|,
the rule of tests/test_torch_convert.py:786-789 (f32 on both sides).
Where a kernel quantizes a value it computed itself (a LayerNorm output,
the cross-attention output, the gated hidden) the two f32 computations
differ in the last bit (sums in another order, per-head vs row-global
softmax max, exact erf vs the TPU's A&S 7.1.26 polynomial), and a value on
a rounding edge lands one code apart; a LayerNorm code one step apart
then moves every gated hidden value of its row. So at most 0.1% of those
kernels' outputs may exceed the atol, and none 2e-2 x max|ref|, the card
tolerance of chip_smoke.py (`_close_int8`); the int8 VQ decode, whose 3x3
convs spread such a step over its neighbours, 1%. `quantize_cols`
and the int32 conv bit for bit, the dequantized conv 1e-6 relative,
calibration absmax rtol 1e-5; encoder reuse at the DDIM chain's 2e-3 x
max(1, |ref|) (tests/test_torch_port_slice.py).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import layers as jlayers
from rdm_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from rdm_tpu.models.autoencoder import VQModel as JVQModel
from rdm_tpu.models.layers import FusedTransformerBlock
from rdm_tpu.models.layers import QuantizableConv
from rdm_tpu.models.rdm import RDM as JRDM
from rdm_tpu.models.rdm import make_denoise_feats_fn as j_feats_fn
from rdm_tpu.models.unet import UNet as JUNet
from rdm_tpu.models.unet import UNetConfig as JUNetConfig
from rdm_tpu.ops import block_kernel as jbk
from rdm_tpu.ops import quant as jquant
from rdm_tpu.ops.schedules import DiffusionSchedule as JSchedule
from rdm_tpu.sampling import DDIMSamplerConfig as JSampler
from rdm_tpu.sampling import ddim_sample as j_ddim_sample
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.models.autoencoder import VQModel
from rdm_tpu_torch.models.layers import (Conv2d, int8_conv2d,
                                         int8_conv2d_reference)
from rdm_tpu_torch.models.rdm import RDM, make_denoise_fn
from rdm_tpu_torch.models.unet import UNet
from rdm_tpu_torch.ops import block_kernel as bk
from rdm_tpu_torch.ops import quant
from rdm_tpu_torch.ops.schedules import DiffusionSchedule
from rdm_tpu_torch.pipeline import RDMPipeline
from rdm_tpu_torch.retrieval.database import DataPool
from rdm_tpu_torch.sampling import ddim_sample
from rdm_tpu_torch.utils import from_jax
from test_torch_port_block import HD, _setup
from test_torch_port_slice import AE_KW, RDM_KW, UNET
from test_torch_port_slice import _models as _rdm_models
from test_torch_port_slice import _table
from test_torch_port_unet import seeded_params


def _close(got, want, rel=1e-3):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want,
                               atol=rel * float(np.abs(want).max()), rtol=0)


def _close_int8(got, want, rel=1e-3, share=1e-3, edge=2e-2):
    """atol rel x max|ref| on all but `share` of the elements, and edge x
    max|ref| on every one (codes on a rounding edge, module docstring)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    scale = float(np.abs(want).max())
    assert (err > rel * scale).mean() <= share, (err > rel * scale).mean()
    assert err.max() <= edge * scale, err.max() / scale


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("shape", [(96, 288), (40, 7)])
def test_quantize_cols_matches_jax_bitwise(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column: scale 1e-12 / 127, codes 0
    w[5, 1] = 1e-30
    want_q, want_s = jbk.quantize_cols(jnp.asarray(w))
    got_q, got_s = bk.quantize_cols(torch.from_numpy(w))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s)[0])
    assert got_q.dtype == torch.int8 and not got_q[:, 3].any()


@pytest.mark.parametrize("kernel,cin,cout", [(3, 16, 24), (1, 32, 8)])
def test_int8_conv_matches_jax(kernel, cin, cout):
    rng = np.random.default_rng(kernel)
    x = rng.standard_normal((2, 6, 6, cin)).astype(np.float32) * 2.0
    w = (rng.standard_normal((kernel, kernel, cin, cout))
         / np.sqrt(kernel * kernel * cin)).astype(np.float32)
    b = 0.1 * rng.standard_normal(cout).astype(np.float32)
    absmax = np.float32(np.abs(x).max() * 0.8)  # some inputs saturate
    node = jquant._quantize_node({"kernel": jnp.asarray(w),
                                  "bias": jnp.asarray(b)}, absmax)
    conv = Conv2d(cin, cout, kernel, padding=kernel // 2)
    conv.load_state_dict({"weight": _t(w.transpose(3, 2, 0, 1)),
                          "bias": _t(b)})
    conv.quantize(torch.tensor(absmax))
    np.testing.assert_array_equal(conv.qweight.numpy(), np.asarray(
        node["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(conv.kernel_scale.numpy(),
                                  np.asarray(node["kernel_scale"]))
    assert float(conv.act_scale) == float(node["act_scale"])
    xq = jlayers.quantize_to_int8(jnp.asarray(x), node["act_scale"])
    want_acc = np.asarray(jax.lax.conv_general_dilated(
        xq, node["kernel"], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)).reshape(-1, cout)
    xt = _t(x.transpose(0, 3, 1, 2))
    got_acc = int8_conv2d(xt, conv)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), want_acc)
    np.testing.assert_array_equal(int8_conv2d_reference(xt, conv).numpy(),
                                  want_acc)
    want = QuantizableConv(cout, kernel).apply({"params": node},
                                               jnp.asarray(x))
    with torch.no_grad():
        got = conv(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ int8 block kernels

class _Spy:
    """Stands in for `pl` inside rdm_tpu.ops.block_kernel: every
    pallas_call records (kernel name, inputs, outputs)."""

    def __init__(self, real):
        self._real, self.calls = real, {}

    def __getattr__(self, name):
        return getattr(self._real, name)

    def pallas_call(self, kernel, **kw):
        f = self._real.pallas_call(kernel, **kw)
        name = getattr(kernel, "func", kernel).__name__

        def call(*args):
            out = f(*args)
            self.calls[name] = ([np.asarray(a) for a in args], out)
            return out

        return call


@functools.lru_cache(maxsize=None)
def _block_params(heads):
    """The JAX block, its seeded params and the port block (shared by the
    cases of one width; each case gets its own copy of the port block)."""
    ref, params, blk, w, _, _ = _setup(heads, 1, 8, 4, 40, seed=heads)
    return ref, params, blk, w


def _jax_int8_block(monkeypatch, heads, b, s, seed):
    """The port block, its int8 weights, and the JAX FusedTransformerBlock
    (interpret mode, int8 attention core) run on its own calibration;
    returns the spy's captures too."""
    monkeypatch.setenv("RDM_TPU_PARTITION_KERNELS", "0")
    monkeypatch.setenv("RDM_TPU_INT8_ATTN", "1")
    ref, params, blk, w = _block_params(heads)
    blk = copy.deepcopy(blk)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, heads * HD)).astype(np.float32)
    ctx = rng.standard_normal((b, 4, 40)).astype(np.float32)
    with jquant.calibrate():
        _, inter = ref.apply(params, jnp.asarray(x), jnp.asarray(ctx),
                             mutable=["intermediates"])
    spy = _Spy(jbk.pl)
    monkeypatch.setattr(jbk, "pl", spy)
    fused = FusedTransformerBlock(heads=heads, head_dim=HD, interpret=True)
    want = fused.apply({**params, "quant": inter["intermediates"]},
                       jnp.asarray(x), jnp.asarray(ctx))
    rec = inter["intermediates"]
    absmax = [rec[m][k] for m, k in (
        ("attn1", "act_absmax"), ("attn1", "out_absmax"),
        ("attn2", "act_absmax"), ("attn2", "out_absmax"),
        ("ff", "act_absmax"), ("ff", "hidden_absmax"))]
    return blk, w, x, ctx, absmax, spy.calls, want


def _cols(wq, ws, c, cp, parts):
    """A JAX int8 weight [K, parts*cp] (lane padded) and its [1, N] scale
    -> the port's [parts*c, K] (out, in) codes and [parts*c] scale."""
    idx = np.concatenate([np.arange(i * cp, i * cp + c)
                          for i in range(parts)])
    return _t(wq[:, idx].T), _t(ws[0, idx])


@pytest.mark.parametrize("heads", [4, 6])
@pytest.mark.parametrize("b,s", [(2, 16), (8, 16), (2, 512), (1, 1024)])
def test_int8_kernels_match_jax(monkeypatch, heads, b, s):
    """Each int8 kernel's plain version on the inputs the JAX kernel got.
    The (B, S) cases cover both TPU attention grids (images packed per
    cell at S <= 256, 512-row q-blocks at S = 1024: two q scale cells);
    heads 6 leaves the second 128-channel group half filled."""
    blk, w, x, ctx, absmax, calls, want = _jax_int8_block(
        monkeypatch, heads, b, s, seed=heads + s)
    c = heads * HD
    cp = -(-c // 128) * 128
    r = b * s

    # kernel 5: LN1 + int8 q/k/v
    args, out = calls["_ln_qkv_kernel_q"]
    wqkv, ws = _cols(args[3], args[4], c, cp, 3)
    got = bk.ln_qkv_q_reference(_t(args[0]), _t(args[1][0]), _t(args[2][0]),
                                wqkv, ws, float(args[5][0, 0]))
    for g, o in zip(got, out):
        _close(g, _np(o)[:, :c])

    # kernel 6: int8 attention core
    args, out = calls["_packed_attn_kernel_q8"]
    q, k, v = (_t(a[..., :c]) for a in args)
    _close(bk.packed_attn_q8_reference(q, k, v, heads=heads, head_dim=HD),
           _np(out)[..., :c])

    # kernel 7: int8 out-proj + LN2 + cross-attention + out-proj
    args, out = calls["_post_cross_kernel_q"]
    ctx_t = torch.from_numpy(ctx)
    ck = (ctx_t @ w["wk2"]).reshape(b, -1, c)
    cv = (ctx_t @ w["wv2"]).reshape(b, -1, c)
    got = bk.post_cross_q_reference(
        _t(args[0]), _t(args[1][..., :c]), ck, cv,
        _t(args[6][:c].T), _t(args[7][0]), _t(args[9][0]), _t(args[10][0]),
        _t(args[11][0]), _t(args[12].T), _t(args[13][0]), _t(args[15].T),
        _t(args[16][0]), _t(args[18][0]), float(args[8][0, 0]),
        float(args[14][0, 0]), float(args[17][0, 0]), heads=heads,
        head_dim=HD)
    _close_int8(got, _np(out))

    # kernel 8: int8 GEGLU feed-forward
    args, out = calls["_geglu_ff_kernel_q"]
    got = bk.geglu_ff_q_reference(
        _t(args[0]), _t(args[1][0]), _t(args[2][0]), _t(args[3].T),
        _t(args[4][0]), _t(args[5].T), _t(args[6][0]), _t(args[7][0]),
        _t(args[8][0]), _t(args[9].T), _t(args[10][0]), _t(args[13][0]),
        float(args[11][0, 0]), float(args[12][0, 0]))
    _close_int8(got, _np(out))
    assert r == out.shape[0]


def test_int8_block_chain_matches_jax(monkeypatch):
    """The whole int8 block: the port's fused route (plain versions on the
    CPU, weights quantized once) against the JAX kernels end to end."""
    blk, w, x, ctx, absmax, _, want = _jax_int8_block(
        monkeypatch, 4, 2, 16, seed=7)
    blk.set_qabsmax(torch.tensor([float(a) for a in absmax]))
    with torch.no_grad():
        got = blk.forward_fused(torch.from_numpy(x), torch.from_numpy(ctx))
    _close(got, want)
    bk.reset_launch_counts()
    assert set(bk.launch_counts().values()) == {0}


def test_int8_attn_core_is_opt_in(monkeypatch):
    blk, w, x, ctx, absmax, _, _ = _jax_int8_block(monkeypatch, 4, 2, 16,
                                                   seed=8)
    blk.set_qabsmax(torch.tensor([float(a) for a in absmax]))
    xt, ct = torch.from_numpy(x), torch.from_numpy(ctx)
    with torch.no_grad():
        q8 = blk.forward_fused(xt, ct)
        monkeypatch.delenv("RDM_TPU_INT8_ATTN")
        assert not bk.use_int8_attn_core()
        bf = blk.forward_fused(xt, ct)
    assert not torch.allclose(q8, bf)


# ------------------------------------------------------- U-Net and decode

@functools.lru_cache(maxsize=None)
def _jax_unet(seed):
    """The tiny JAX U-Net with seeded params, its port state dict and the
    module name map, shared-CFG inputs, and one JAX calibration forward's
    intermediates on them."""
    jm = JUNet(JUNetConfig(**UNET))
    params = seeded_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 4, 24))), seed)
    inv = from_jax._Inverse(params["params"])
    from_jax._unet(inv, pc.UNetConfig(**UNET))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    t = np.asarray([11, 700])
    ctx = rng.standard_normal((4, 4, 24)).astype(np.float32)  # shared CFG
    with jquant.calibrate():  # a trace-time flag: jit inside it
        _, inter = jax.jit(lambda *a: jm.apply(
            *a, mutable=["intermediates"]))(
            params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t),
            jnp.asarray(ctx))
    return jm, params, inv.sd, dict(inv.names), (x, t, ctx), \
        inter["intermediates"]


def _unet(seed=5):
    jm, params, sd, names, inputs, inter = _jax_unet(seed)
    port = UNet(pc.UNetConfig(**UNET)).eval()
    port.load_state_dict(sd)
    return jm, params, port, names, inputs, inter


@functools.lru_cache(maxsize=None)
def _jax_int8_unet(seed=5):
    """The JAX int8 serving tree of `_jax_unet(seed)` and its forward on
    the same inputs, the fused int8 blocks in interpret mode."""
    jm, params, _, _, (x, t, ctx), inter = _jax_unet(seed)
    qtree = jquant.quantize_conv_tree(params, {"intermediates": inter})
    with pytest.MonkeyPatch.context() as mp:
        _patch_fused_jax(mp)
        want = jax.jit(jm.apply)(qtree, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                 jnp.asarray(t), jnp.asarray(ctx))
    return qtree, np.asarray(want)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = float(v)
    return out


def test_calibration_absmax_matches_jax():
    _, _, port, names, (x, t, ctx), inter = _unet()
    want = _flat(inter)
    with quant.calibrate(), torch.no_grad():
        port(_t(x), _t(t), _t(ctx))
    rec = quant.collect_absmax(port)
    got = {f"{f}/{k}": float(rec[p][k])
           for f, p in names.items() if p in rec for k in rec[p]}
    assert set(got) == set(want)  # Downsample records nothing on both sides
    for key, v in want.items():
        assert got[key] == pytest.approx(v, rel=1e-5), key
    assert quant.collect_absmax(port) == {}  # collected records are cleared


def _patch_fused_jax(monkeypatch):
    """The JAX U-Net's int8 path on the CPU: fused blocks on, the kernels
    in interpret mode, no batch partitioning."""
    orig = jbk.fused_transformer_block
    monkeypatch.setenv("RDM_TPU_PARTITION_KERNELS", "0")
    monkeypatch.setattr(jlayers, "use_fused_spatial_block", lambda: True)
    monkeypatch.setattr(jbk, "fused_transformer_block",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("source", ["calibrated", "from_jax"])
def test_int8_unet_forward_matches_jax(source):
    """The int8 U-Net (shared-CFG context) against the JAX int8 forward:
    the port quantized by `quant.quantize_conv_tree` from the JAX
    calibration tree (its own calibration is held to JAX's above; one ulp
    apart, a scale moves codes across the whole net), or loaded from the
    JAX int8 serving tree through utils.from_jax."""
    _, _, port, names, (x, t, ctx), inter = _unet()
    qtree, want = _jax_int8_unet()
    if source == "calibrated":
        calib = {}
        for f, p in names.items():
            node = inter
            for key in f.split("/"):
                node = node.get(key, {})
            if node:
                calib[p] = {k: torch.tensor(float(v)) for k, v in node.items()}
        quant.quantize_conv_tree(port, calib,
                                 exclude=quant.unet_exclude(port))
    else:
        port = UNet(pc.UNetConfig(**UNET)).eval()
        port.load_state_dict(from_jax.unet_state_dict_from_jax(
            qtree, pc.UNetConfig(**UNET)))
    assert quant.num_quantized(port) == jquant.num_quantized(qtree)
    with torch.no_grad():
        got = port(_t(x), _t(t), _t(ctx))
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("config", ["tiny", "imagenet"])
def test_num_quantized_matches_jax(config):
    """The convs that run int8 (conv_in, the eps head and the Downsample
    convs stay out), counted on the module tree against JAX's count on
    its quantized tree (shapes only for the ImageNet width)."""
    kw = UNET if config == "tiny" else {}
    jm, cfg = JUNet(JUNetConfig(**kw)), pc.UNetConfig(**kw)
    side = 8
    args = (jnp.zeros((1, side, side, cfg.in_channels)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((2, 4, cfg.context_dim)))

    def quantized(p):
        with jquant.calibrate():
            _, inter = jm.apply(p, *args, mutable=["intermediates"])
        return jquant.quantize_conv_tree(p, inter)

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), args[0],
                            args[1], args[2][:1])
    qtree = jax.eval_shape(quantized, shapes)
    want = sum(1 for leaf in jax.tree_util.tree_leaves(qtree)
               if leaf.dtype == jnp.int8 and len(leaf.shape) == 4)
    with torch.device("meta"):
        port = UNet(cfg)
        with quant.calibrate(), torch.no_grad():
            port(torch.zeros(1, cfg.in_channels, side, side),
                 torch.zeros(1, dtype=torch.long),
                 torch.zeros(2, 4, cfg.context_dim))
        quant.quantize_conv_tree(port, quant.collect_absmax(port),
                                 exclude=quant.unet_exclude(port))
    assert quant.num_quantized(port) == want > 0


def test_int8_vq_decode_matches_jax():
    jae, ae = JAEConfig(**AE_KW), pc.AutoencoderConfig(**AE_KW)
    jvq = JVQModel(jae)
    vq_params = seeded_params(jax.eval_shape(
        jvq.init, jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))), 21)
    vq = VQModel(ae).eval()
    vq.load_state_dict(from_jax.vq_state_dict_from_jax(vq_params, ae))
    z = np.random.default_rng(22).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    with jquant.calibrate():
        _, calib = jvq.apply(vq_params, jnp.asarray(z),
                             force_not_quantize=False, method=JVQModel.decode,
                             mutable=["intermediates"])
    qtree = jquant.quantize_conv_tree(
        vq_params, calib, exclude=("conv_in", "conv_out", "post_quant_conv"))
    want = jvq.apply(qtree, jnp.asarray(z), force_not_quantize=False,
                     method=JVQModel.decode)
    zt = _t(z.transpose(0, 3, 1, 2))
    with quant.calibrate(), torch.no_grad():
        vq.decode(zt)
    quant.quantize_conv_tree(vq, quant.collect_absmax(vq),
                             exclude=quant.decoder_exclude(vq))
    assert quant.num_quantized(vq) == jquant.num_quantized(qtree) > 0
    assert vq.decoder.conv_in.qweight is None
    # and the JAX int8 serving tree carried across by utils.from_jax
    carried = VQModel(ae).eval()
    carried.load_state_dict(from_jax.vq_state_dict_from_jax(qtree, ae))
    assert quant.num_quantized(carried) == quant.num_quantized(vq)
    # a decoder conv's code on a rounding edge moves its 3x3 neighbourhood
    # in every later layer: up to 1% of the pixels past the atol
    with torch.no_grad():
        for port in (vq, carried):
            _close_int8(port.decode(zt).permute(0, 2, 3, 1), want,
                        share=1e-2)


# -------------------------------------------------------- encoder reuse

@pytest.mark.parametrize("reuse", [2, 3])
def test_encoder_reuse_chain_matches_jax(reuse):
    (jm, params, _, _), (cfg, sd, _, _) = _rdm_models(seed=31)
    model = RDM(cfg).eval()
    model.load_state_dict(sd)
    rng = np.random.default_rng(32)
    neighbors = rng.standard_normal((2, 4, 24)).astype(np.float32)
    x_t = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    steps = 5
    uncond = jm.apply(params, 2, 4, 0.0, method=JRDM.uncond_context)
    want, _ = j_ddim_sample(
        lambda x, t, c: jm.apply(params, x, t, c),
        JSchedule.create(50, "linear", 0.0015, 0.0195),
        JSampler(num_steps=steps, guidance_scale=2.0, cfg_mode="shared",
                 encoder_reuse=reuse),
        (2, 8, 8, 3), jnp.asarray(neighbors), jax.random.PRNGKey(0),
        uncond_context=uncond, x_init=jnp.asarray(x_t.transpose(0, 2, 3, 1)),
        denoise_feats_fn=j_feats_fn(jm, params))
    schedule = DiffusionSchedule.create(50, "linear", 0.0015, 0.0195)
    calls = []

    def feats(x, t, c, cache):
        calls.append(cache is None)
        return model(x, t, c, encoder_cache=cache, return_cache=True)

    with torch.no_grad():
        got, _ = ddim_sample(
            make_denoise_fn(model), schedule,
            pc.DDIMSamplerConfig(num_steps=steps, guidance_scale=2.0,
                                 cfg_mode="shared", encoder_reuse=reuse),
            (2, 3, 8, 8), _t(neighbors), torch.Generator().manual_seed(0),
            uncond_context=model.uncond_context(2, 4, 0.0), x_init=_t(x_t),
            denoise_feats_fn=feats)
    # the full U-Net on step 0 and every reuse-th step, the up path between
    assert calls == [i % reuse == 0 for i in range(len(calls))]
    assert len(calls) > reuse
    want = np.asarray(want)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=2e-3 * max(1.0, np.abs(want).max()))


def test_unet_cache_roundtrip_is_exact():
    _, _, port, _, (x, t, ctx), _ = _unet()
    with torch.no_grad():
        full, cache = port(_t(x), _t(t), _t(ctx), return_cache=True)
        again = port(_t(x), _t(t), _t(ctx), encoder_cache=cache)
    assert len(cache[0]) == len(port.input_blocks)
    assert cache[1].shape[0] == 4  # cached after the shared-CFG tiling
    assert torch.equal(full, again)


# -------------------------------------------------------------- pipeline

def _pipeline(int8: bool):
    _, (cfg, sd, ae, vq_sd) = _rdm_models(seed=41)
    return RDMPipeline(cfg, sd, ae, vq_sd, pool=DataPool(_table(seed=42)),
                       dtype=torch.float32, device="cpu", int8_weights=int8)


def test_pipeline_encoder_reuse_one_is_the_default():
    pipe = _pipeline(False)
    q = np.random.default_rng(43).standard_normal((2, 24)).astype(np.float32)
    kw = dict(steps=4, guidance_scale=2.0, seed=5)
    plain = pipe.sample_with_query(q, **kw)["query_samples"]
    np.testing.assert_array_equal(
        pipe.sample_with_query(q, encoder_reuse=1, **kw)["query_samples"],
        plain)
    reused = pipe.sample_unconditional(2, qids=np.asarray([3, 9]),
                                       encoder_reuse=2, **kw)
    assert reused["samples_with_sampled_nns"].shape == (2, 16, 16, 3)
    with pytest.raises(ValueError, match="int8_weights=True"):
        pipe.quantized_params(torch.zeros(2, 4, 24))


def test_pipeline_int8_serves_and_calibrates_once():
    pipe = _pipeline(True)
    q = np.random.default_rng(44).standard_normal((2, 24)).astype(np.float32)
    kw = dict(steps=4, guidance_scale=2.0, seed=6)
    assert quant.num_quantized(pipe.model) == 0
    first = pipe.sample_with_query(q, **kw)["query_samples"]
    unet = pipe.model.unet
    n = quant.num_quantized(pipe.model)
    assert n == quant.num_quantized(unet) > 0
    assert quant.num_quantized(pipe.first_stage) > 0
    assert unet.input_blocks[0][0].qweight is None
    assert unet.out[2].qweight is None
    blocks = [m for m in unet.modules() if hasattr(m, "set_qabsmax")]
    assert blocks and all(m.qabsmax is not None for m in blocks)
    assert "wqkv_q" in blocks[0]._packed
    seconds = pipe.calibration_seconds
    assert seconds is not None and seconds > 0
    again = pipe.sample_with_query(q, encoder_reuse=3, **kw)["query_samples"]
    assert pipe.calibration_seconds == seconds  # calibrated once
    assert first.shape == again.shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(
        pipe.sample_with_query(q, **kw)["query_samples"], first)
