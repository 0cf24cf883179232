"""rdm_tpu_torch flash attention against the JAX package, on the CPU.

The plain versions of the two CUDA kernels (`flash_attention_forward_
reference`, `flash_attention_backward_reference`) are held against the
JAX Pallas kernels `_flash_forward` / `_flash_backward` run with
interpret=True, causal and not, head_dim 32 and 64, at Sq = 768, where
the TPU kernels take three 256-row q blocks (so the backward's dK / dV
accumulation across q blocks is exercised). Inputs come from numpy seeds,
f32 on both sides; tolerance atol 2e-5, rtol 1e-4 (f32 sums in another
order over up to 768 keys). The autograd.Function is held against the
plain backward and against autograd through `_xla_reference`, and the
gates `_pick_impl` / `_use_kernel_bwd` are checked with their env
overrides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.ops import flash_attention as jfa
from rdm_tpu_torch.ops import attention as pattn
from rdm_tpu_torch.ops import flash_attention as fa

ATOL, RTOL = 2e-5, 1e-4


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d))]


CASES = [  # b, sq, sk, h, d, causal
    (1, 768, 768, 2, 32, False),
    (1, 768, 768, 2, 32, True),
    (1, 768, 512, 1, 64, True),
    (2, 768, 256, 1, 64, False),
]


@pytest.mark.parametrize("b,sq,sk,h,d,causal", CASES)
def test_plain_forward_matches_pallas_interpret(b, sq, sk, h, d, causal):
    q, k, v, _ = _inputs(b, sq, sk, h, d, seed=sq + sk + d)
    scale = d ** -0.5
    want = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), scale, causal, interpret=True)
    got = fa.flash_attention_forward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), scale, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("b,sq,sk,h,d,causal", CASES)
def test_plain_backward_matches_pallas_interpret(b, sq, sk, h, d, causal):
    q, k, v, g = _inputs(b, sq, sk, h, d, seed=1 + sq + sk + d)
    scale = d ** -0.5
    want = jfa._flash_backward(*(jnp.asarray(a) for a in (q, k, v, g)),
                               scale, causal, interpret=True)
    got = fa.flash_attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v, g)), scale, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL * np.abs(w).max(),
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bwd", ["pallas", "xla"])
def test_autograd_function_gradients(causal, bwd, monkeypatch):
    """flash_attention's gradients on the CPU: with RDM_TPU_FLASH_BWD=pallas
    the plain backward kernel version, with xla the eager recompute; both
    against autograd through `_xla_reference` (f32: atol 1e-5 x max|ref|)
    and the first also bit for bit against the plain backward. Sk >= Sq:
    a causal row that sees no key has no gradient through the masked
    scores, while the kernels (as the TPU one) give it one."""
    monkeypatch.setenv("RDM_TPU_FLASH_BWD", bwd)
    q, k, v, g = (torch.from_numpy(a) for a in
                  _inputs(2, 80, 96, 2, 32, seed=11))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*qkv, causal=causal)
    got = torch.autograd.grad(out, qkv, g)
    ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out = fa._xla_reference(*ref_in, 32 ** -0.5, causal)
    want = torch.autograd.grad(ref_out, ref_in, g)
    torch.testing.assert_close(out, ref_out.detach(), atol=1e-5, rtol=1e-5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5 * w.abs().max().item(),
                                   rtol=1e-4)
    if bwd == "pallas":
        plain = fa.flash_attention_backward_reference(q, k, v, g,
                                                      32 ** -0.5, causal)
        for a, w in zip(got, plain):
            assert torch.equal(a, w)


def test_flash_attention_refuses_masks():
    q = torch.zeros(1, 8, 1, 32)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, q, q, mask=torch.ones(1, 8, dtype=torch.bool))


def _meta(b, s, h, d, dtype=torch.bfloat16):
    return torch.empty((b, s, h, d), dtype=dtype, device="meta")


@pytest.mark.parametrize("sq,sk,d,dtype,device,mask,want", [
    (1024, 1024, 32, torch.bfloat16, "cuda", False, "pallas"),  # ds 2
    (256, 256, 32, torch.bfloat16, "cuda", False, "pallas"),    # ds 4
    (64, 64, 32, torch.bfloat16, "cuda", False, "xla"),         # ds 8
    (1024, 4, 32, torch.bfloat16, "cuda", False, "xla"),        # cross
    (256, 256, 64, torch.bfloat16, "cuda", False, "pallas"),    # RARM
    (384, 384, 32, torch.bfloat16, "cuda", False, "pallas"),
    (320, 320, 32, torch.bfloat16, "cuda", False, "xla"),       # % 128
    (256, 256, 48, torch.bfloat16, "cuda", False, "xla"),       # d % 32
    (256, 256, 160, torch.bfloat16, "cuda", False, "xla"),      # d > 128
    (4096, 4096, 512, torch.bfloat16, "cuda", False, "xla"),    # VQ attn
    (1024, 1024, 32, torch.float32, "cuda", False, "xla"),      # f32
    (1024, 1024, 32, torch.bfloat16, "cpu", False, "xla"),
    (1024, 1024, 32, torch.bfloat16, "cuda", True, "xla"),      # mask
])
def test_pick_impl(sq, sk, d, dtype, device, mask, want, monkeypatch):
    monkeypatch.delenv("RDM_TPU_FLASH", raising=False)
    q, k = _meta(2, sq, 1, d, dtype), _meta(2, sk, 1, d, dtype)
    m = torch.ones(2, sk, dtype=torch.bool) if mask else None
    assert pattn._pick_impl(q, k, False, m, device) == want
    monkeypatch.setenv("RDM_TPU_FLASH", "0")
    assert pattn._pick_impl(q, k, False, m, device) == "xla"


@pytest.mark.parametrize("env,d,device,want", [
    ("", 32, "cuda", True), ("", 64, "cuda", False),
    ("", 32, "cpu", False), ("pallas", 64, "cuda", True),
    ("pallas", 32, "cpu", True), ("xla", 32, "cuda", False),
])
def test_use_kernel_bwd(env, d, device, want, monkeypatch):
    monkeypatch.setenv("RDM_TPU_FLASH_BWD", env)
    assert fa._use_kernel_bwd(d, device) is want


def test_dot_product_attention_pallas_on_cpu_is_the_plain_kernel_math():
    """impl="pallas" on CPU tensors runs the kernels' plain versions and
    agrees with the plain path (f32, atol 1e-5)."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 256, 256, 2, 32,
                                                       seed=5))
    for causal in (False, True):
        a = pattn.dot_product_attention(q, k, v, causal=causal,
                                        impl="pallas")
        b = pattn.dot_product_attention(q, k, v, causal=causal, impl="xla")
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_wrappers_refuse_inputs_that_require_grad():
    """The grad guard's routing, checked on the CPU: the CPU path is the
    differentiable plain version (no raise), and `_build.refuse_grad`,
    which every CUDA launch path calls first, raises in grad mode only."""
    from rdm_tpu_torch.ops import _build

    x = torch.zeros(1, 8, 1, 32, requires_grad=True)
    out = fa.flash_fwd(x, x, x, scale=1.0, causal=False)  # CPU: plain
    assert out.requires_grad
    with pytest.raises(RuntimeError, match="requires grad"):
        _build.refuse_grad("flash_fwd", x)
    with torch.no_grad():
        _build.refuse_grad("flash_fwd", x)
    _build.refuse_grad("flash_fwd", x.detach())
