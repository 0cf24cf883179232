"""The Hopper flash-attention backward's tiling, emulated on the CPU.

`rdm_tpu_torch/csrc/flash_attn_bwd.cu` computes dq, dk, dv in three
launches: (1) per 64 query rows, the forward core's online-softmax walk
over the key tiles, writing each row's max m (log2 domain), 1 / l and
delta = rowsum(dO O) for Sq padded to 64 rows (zeros past Sq); (2) per 64
keys, a walk over query tiles (64 wide at head_dim <= 64, 32 wide above)
from the first one that sees the keys, summing dV = bf16(P^T) dO and
dK = bf16(dS^T) Q; (3) per 64 query rows, a walk over the key tiles
summing dQ = bf16(dS) K. No CUDA runs here, so this file emulates the
three launches in plain torch with the kernels' tile sizes, walk order,
skip rules, zero padding, masks (-1e9 for a causal key after the query,
-inf for a key past Sk) and bf16 roundings, and holds the emulation
against `flash_attention_backward_reference` and the JAX Pallas
`_flash_backward` (interpret=True) at tiny ragged and causal shapes,
including Sk < Sq rows that see no key. Tolerances:

- roundings off, f32 inputs: atol 2e-5 x max|ref|, rtol 1e-4 against
  both (f32 sums in another order, exp2 in the log2 domain against exp);
- the kernels' bf16 roundings on bf16 inputs against the plain version:
  max|err| <= 2e-2 x max|ref|, as the card holds the kernel;
- the skip rules against walking every tile: equal bit for bit (a skipped
  tile's p is exactly 0).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.ops import flash_attention as jfa
from rdm_tpu_torch.ops import flash_attention as fa

ROWS = 64          # query rows of launches 1 and 3, keys of a tile
MASKED = -1e9      # the causal mask value (log2 domain, unscaled)
LOG2E = 1.4426950408889634
ATOL, RTOL = 2e-5, 1e-4
KERNEL_TOL = 2e-2


def _query_tile(d: int) -> int:
    """Query rows of launch 2's tiles (KVSmem::kTQ)."""
    return 64 if d <= 64 else 32


def _key_tiles(r0: int, sq: int, sk: int, causal: bool, skip: bool) -> int:
    """Key tiles that rows [r0, r0 + 64) walk (attn_fwd_sm90.cuh)."""
    n = -(-sk // ROWS)
    if skip and causal and sk >= sq:
        n = min(n, (min(r0 + ROWS, sq) - 1 + sk - sq) // ROWS + 1)
    return n


def _first_query_tile(k0: int, sq: int, sk: int, causal: bool, tq: int,
                      skip: bool) -> int:
    if not (skip and causal) or sk < sq:
        return 0
    first = k0 - (sk - sq)
    return 0 if first <= 0 else first // tq


def _pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Rows past x's own are zero, as the TMA box fills them."""
    out = x.new_zeros((rows, x.shape[1]))
    out[:x.shape[0]] = x
    return out


def _scores(qt, kt, q0, k0, sq, sk, scale_log2, causal):
    """log2-domain scores of a query tile against a key tile, masked."""
    s = qt @ kt.T * scale_log2
    qpos = torch.arange(q0, q0 + qt.shape[0])[:, None] + (sk - sq)
    key = torch.arange(k0, k0 + kt.shape[0])[None, :]
    if causal:
        s = torch.where(key > qpos, torch.tensor(MASKED), s)
    return torch.where(key >= sk, torch.tensor(-math.inf), s)


def _emulate_head(q, k, v, do, scale, causal, rnd, skip):
    """dq, dk, dv of one (image, head): q, do [Sq, D], k, v [Sk, D] f32."""
    bf = (lambda x: x.bfloat16().float()) if rnd else (lambda x: x)
    sq, d = q.shape
    sk = k.shape[0]
    sl2 = scale * LOG2E
    sqp, skp = -(-sq // ROWS) * ROWS, -(-sk // ROWS) * ROWS
    qp, dop, kp, vp = _pad(q, sqp), _pad(do, sqp), _pad(k, skp), _pad(v, skp)
    valid = torch.arange(sqp) < sq

    # 1. statistics: the forward's walk, p rounded to bf16 for PV
    m_all, il_all, dl_all = (torch.zeros(sqp) for _ in range(3))
    for r0 in range(0, sqp, ROWS):
        rows = slice(r0, r0 + ROWS)
        m = torch.full((ROWS,), -math.inf)
        l, o = torch.zeros(ROWS), torch.zeros(ROWS, d)
        for t in range(_key_tiles(r0, sq, sk, causal, skip)):
            keys = slice(t * ROWS, (t + 1) * ROWS)
            s = _scores(qp[rows], kp[keys], r0, t * ROWS, sq, sk, sl2, causal)
            n = torch.maximum(m, s.amax(1))
            a = torch.exp2(m - n)
            p = torch.exp2(s - n[:, None])
            l = l * a + p.sum(1)
            o = o * a[:, None] + bf(p) @ vp[keys]
            m = n
        il = 1.0 / l
        dl = (dop[rows] * o).sum(1) * il
        ok = valid[rows]
        m_all[rows] = torch.where(ok, m, 0.0)
        il_all[rows] = torch.where(ok, il, 0.0)
        dl_all[rows] = torch.where(ok, dl, 0.0)

    # 2. dK, dV per 64 keys over query tiles
    tq = _query_tile(d)
    nqt = -(-sq // tq)
    dk, dv = torch.zeros(skp, d), torch.zeros(skp, d)
    for k0 in range(0, skp, ROWS):
        keys = slice(k0, k0 + ROWS)
        for t in range(_first_query_tile(k0, sq, sk, causal, tq, skip), nqt):
            cols = slice(t * tq, (t + 1) * tq)
            s_t = _scores(qp[cols], kp[keys], t * tq, k0, sq, sk, sl2,
                          causal).T
            dp_t = vp[keys] @ dop[cols].T
            p = torch.exp2(s_t - m_all[cols]) * il_all[cols]
            ds = p * (dp_t - dl_all[cols])
            dv[keys] += bf(p) @ dop[cols]
            dk[keys] += bf(ds) @ qp[cols]

    # 3. dQ per 64 query rows over key tiles
    dq = torch.zeros(sqp, d)
    for r0 in range(0, sqp, ROWS):
        rows = slice(r0, r0 + ROWS)
        for t in range(_key_tiles(r0, sq, sk, causal, skip)):
            keys = slice(t * ROWS, (t + 1) * ROWS)
            s = _scores(qp[rows], kp[keys], r0, t * ROWS, sq, sk, sl2, causal)
            dp = dop[rows] @ vp[keys].T
            p = torch.exp2(s - m_all[rows, None]) * il_all[rows, None]
            ds = p * (dp - dl_all[rows, None])
            dq[rows] += bf(ds) @ kp[keys]
    return dq[:sq] * scale, dk[:sk] * scale, dv[:sk]


def emulate_bwd(q, k, v, do, scale, causal, rnd=True, skip=True):
    """The three launches over BSHD q, do [B, Sq, H, D], k, v [B, Sk, H, D];
    returns (dq, dk, dv) in f32 (the kernels then round to bf16)."""
    b, _, h, _ = q.shape
    outs = [torch.zeros_like(t, dtype=torch.float32) for t in (q, k, v)]
    for i in range(b):
        for j in range(h):
            got = _emulate_head(*(t[i, :, j].float() for t in (q, k, v, do)),
                                scale, causal, rnd, skip)
            for out, g in zip(outs, got):
                out[i, :, j] = g
    return tuple(outs)


CASES = [  # b, sq, sk, h, d, causal
    (2, 100, 70, 2, 32, False),    # ragged Sq and Sk
    (1, 100, 130, 2, 32, True),    # causal Sk > Sq: skipped tiles
    (1, 130, 100, 1, 64, True),    # causal Sk < Sq: 30 rows see no key
    (1, 70, 130, 1, 96, True),     # 32-wide query tiles
    (1, 200, 200, 1, 128, True),   # Sq = Sk, four tiles, causal
    (1, 64, 200, 1, 32, True),     # one query tile, keys ending past it
]


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d))]


@pytest.mark.parametrize("b,sq,sk,h,d,causal", CASES)
def test_tiling_matches_plain_and_pallas(b, sq, sk, h, d, causal):
    """Without the bf16 roundings the three launches' tiling gives the
    plain version's and the Pallas kernel's gradients on f32 inputs."""
    arrs = _inputs(b, sq, sk, h, d, seed=sq + 3 * sk + d)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    scale = d ** -0.5
    got = emulate_bwd(q, k, v, do, scale, causal, rnd=False)
    plain = fa.flash_attention_backward_reference(q, k, v, do, scale, causal)
    pallas = jfa._flash_backward(*(jnp.asarray(a) for a in arrs), scale,
                                 causal, interpret=True)
    for name, a, p, w in zip(("dq", "dk", "dv"), got, plain, pallas):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), p.numpy(),
                                   atol=ATOL * np.abs(w).max(), rtol=RTOL,
                                   err_msg=f"{name} against the plain version")
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL * np.abs(w).max(),
                                   rtol=RTOL, err_msg=f"{name} against Pallas")


@pytest.mark.parametrize("b,sq,sk,h,d,causal", CASES)
def test_kernel_roundings_within_kernel_tol(b, sq, sk, h, d, causal):
    """With the kernels' roundings (p to bf16 for PV and dV, dS to bf16) on
    bf16 inputs, each gradient is within the card's tolerance of the plain
    version."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in
                   _inputs(b, sq, sk, h, d, seed=7 + sq + sk + d))
    scale = d ** -0.5
    got = emulate_bwd(q, k, v, do, scale, causal)
    want = fa.flash_attention_backward_reference(q, k, v, do, scale, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.bfloat16().float(), w.float()
        assert torch.isfinite(a).all(), name
        rel = ((a - w).abs().max() / w.abs().max()).item()
        assert rel <= KERNEL_TOL, (name, rel)


@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    c for c in CASES if c[-1] and c[2] >= c[1]])
def test_skipped_tiles_contribute_nothing(b, sq, sk, h, d, causal):
    """The causal skip rules (key tiles past a row block's last visible
    key; query tiles before a key tile's first viewer) drop only tiles
    whose p is exactly 0: the walk with them skipped equals the full walk
    bit for bit, with the kernels' roundings."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in
                   _inputs(b, sq, sk, h, d, seed=11 + sq + sk + d))
    scale = d ** -0.5
    fast = emulate_bwd(q, k, v, do, scale, causal)
    full = emulate_bwd(q, k, v, do, scale, causal, skip=False)
    for a, w in zip(fast, full):
        assert torch.equal(a, w)

