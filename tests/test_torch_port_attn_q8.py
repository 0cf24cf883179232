"""The int8 attention core (`packed_attn_q8`, csrc/packed_attn_q8.cu)
emulated on the CPU, against the port's plain version and the JAX
`_packed_attn_kernel_q8` in Pallas interpret mode.

No GPU runs here, so `attn_q8_walk` does in plain torch what the three
launches do: the per-cell absmax (128-channel groups; q per q-block of
`_q8_block_rows(S)` rows) from the absmax launch's 64-row maxima, the
codes launch (q and k codes [B, S, C], v's
transposed into [B, C, S'] with S' = S rounded up to 64, each 32 keys in
the order of the p fragment, `key_slot`, and zero for keys past S), and
the
attention's walk over 64-key tiles: pass 1 an int32 row max of the exact
integer scores (keys past S: INT_MIN), pass 2 per score float(s) * c,
minus the row's max, exp2, the f32 den and rint(127 p), with p v summed
exactly in int32 through v8t's key order. Held:

- the codes launch's layout (codes as the plain version makes them, v8t
  zero at the slots of keys past S, `key_slot` placing each key where the
  kernel's register fragment of p finds it);
- pass 1's premise: max(float(s) c) == float(max s) c on the scores;
- the int32 p v through v8t equal to p v in key order, exactly;
- the output against `packed_attn_q8_reference` (f32: 1e-5 x max|ref|,
  the two differ only in the order of den's f32 sum; bf16: chip_smoke.py's
  2e-2 x max|ref|) and against the JAX kernel by `_close_int8`'s rule
  (1e-3 x max|ref| on all but 0.1% of the elements, 2e-2 on every one:
  JAX's exp2 may put a p on the other side of a code's rounding edge);

at head_dim 32 and 64, S = 40 / 100 (not a multiple of 64), 520 (q-blocks
of 8 rows), 576 (nine 64-row q-blocks), 1024 (two 512-row q-blocks),
C = 160 (5 x 32: a last group of one head) and 192 (3 x 64: a last group
of one head).

The kernel itself is held on the card by chip_smoke.py phase 9 and
tests/test_torch_port_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rdm_tpu.ops import block_kernel as jbk
from rdm_tpu_torch.ops import block_kernel as bk
from test_torch_port_int8 import _close_int8

KEYS = 64  # keys of a tile, query rows of a CTA (kKeys, kQRows)
GROUP = 128  # channels of a scale cell
INT_MIN = -2 ** 31
LOG2E = 1.4426950408889634
CARD_TOL = 2e-2


def key_slot(kappa: int) -> int:
    """csrc/packed_attn_q8.cu `key_slot`: where key kappa (0 .. 63) of a
    64-key block lies in v8t."""
    return ((kappa & 48) | ((kappa & 6) << 1) | ((kappa >> 2) & 2)
            | (kappa & 1))


SLOTS = torch.tensor([key_slot(k) for k in range(KEYS)])


def _cell_scales(q, k, v, bq):
    """max(absmax, 1e-12) / 127 per (image, group): q's per q-block
    [B, G, S / bq], k's and v's [B, G], as the launches make them: the
    absmax launch's maxima of each 64 rows (zero rows past S), reduced by
    the codes launch over a cell's blocks; where q-blocks are shorter than
    64 rows (they divide 64) the absmax launch's per-q-block maxima. Each
    is held equal to the max over the cell's elements."""
    b, s, c = q.shape
    groups, sp = -(-c // GROUP), -(-s // KEYS) * KEYS
    nblk, nqb = sp // KEYS, s // bq
    qs = torch.empty(b, groups, nqb)
    ks, vs = torch.empty(b, groups), torch.empty(b, groups)
    for g in range(groups):
        lanes = slice(g * GROUP, min(c, (g + 1) * GROUP))
        t3 = [torch.zeros(b, sp, lanes.stop - lanes.start) for _ in range(3)]
        for t, x in zip(t3, (q, k, v)):
            t[:, :s] = x[..., lanes].float().abs()
        part = [t.reshape(b, nblk, KEYS, -1).amax(dim=(2, 3)) for t in t3]
        ks[:, g], vs[:, g] = part[1].amax(dim=1), part[2].amax(dim=1)
        if bq % KEYS == 0 or bq >= s:  # the codes launch, from the parts
            for qb in range(nqb):
                p1 = nblk if bq >= s else (qb + 1) * bq // KEYS
                qs[:, g, qb] = part[0][:, qb * bq // KEYS:p1].amax(dim=1)
        else:  # the absmax launch, each q-block inside one 64-row block
            assert KEYS % bq == 0
            qs[:, g] = t3[0][:, :s].reshape(b, nqb, -1).amax(dim=2)
        direct = q[..., lanes].float().abs().reshape(b, nqb, -1).amax(dim=2)
        assert torch.equal(qs[:, g], direct)
        assert torch.equal(ks[:, g], k[..., lanes].float().abs().amax((1, 2)))
        assert torch.equal(vs[:, g], v[..., lanes].float().abs().amax((1, 2)))
    return tuple(t.clamp_min(1e-12) / 127.0 for t in (qs, ks, vs))


def _codes(t, scale):
    """clip(rint(t / scale), +-127), the f32 division rounded."""
    return torch.clamp(torch.round(t.float() / scale), -127, 127).to(
        torch.int8)


def codes_launch(q, k, v, heads, head_dim):
    """The codes launch: (q8, k8 [B, S, C], v8t [B, C, S'], the scales).
    Each channel's scale is its 128-channel group's; q's also its row's
    q-block's."""
    b, s, c = q.shape
    bq = bk._q8_block_rows(s)
    qs, ks, vs = _cell_scales(q, k, v, bq)
    grp = torch.arange(c) // GROUP
    q8 = _codes(q, qs[:, grp].transpose(1, 2).repeat_interleave(bq, dim=1))
    k8 = _codes(k, ks[:, None, grp])
    v8 = _codes(v, vs[:, None, grp])
    sp = -(-s // KEYS) * KEYS
    keys = torch.arange(s)
    pos = keys // KEYS * KEYS + SLOTS[keys % KEYS]
    v8t = torch.zeros(b, c, sp, dtype=torch.int8)
    v8t[:, :, pos] = v8.transpose(1, 2)
    return q8, k8, v8t, (qs, ks, vs)


def attn_q8_walk(q, k, v, *, heads, head_dim):
    """packed_attn_q8 as the three launches compute it; returns the output
    (q's dtype) and the intermediates {"q8", "k8", "v8t", "c", "max_int",
    "scores", "pv", "pv_keys"} (scores: the exact int32 q k^T per head,
    keys past S dropped; pv, pv_keys: the int32 p v through v8t and in key
    order)."""
    b, s, c = q.shape
    d = head_dim
    bq = bk._q8_block_rows(s)
    q8, k8, v8t, (qs, ks, vs) = codes_launch(q, k, v, heads, d)
    sp = v8t.shape[-1]
    g = torch.arange(heads) * d // GROUP  # each head's group
    qh = q8.reshape(b, s, heads, d).permute(0, 2, 1, 3).long()
    kh = k8.reshape(b, s, heads, d).permute(0, 2, 1, 3).long()
    vt = v8t.reshape(b, heads, d, sp).long()
    # c = ((qs ks) d^-1/2) log2 e per (image, head, row), in f32 as JAX
    rows_qs = qs[:, g].repeat_interleave(bq, dim=2)  # [B, H, S]
    c_row = ((rows_qs * ks[:, g, None]) * d ** -0.5) * LOG2E
    nkt = -(-s // KEYS)

    def tile_scores(t):  # exact int32 scores of key tile t, [B, H, S, 64]
        kt = torch.zeros(b, heads, KEYS, d, dtype=torch.long)
        n = min(KEYS, s - t * KEYS)
        kt[:, :, :n] = kh[:, :, t * KEYS:t * KEYS + n]
        return qh @ kt.transpose(2, 3), n

    # pass 1: integer row maxima, keys past S at INT_MIN
    mx = torch.full((b, heads, s), INT_MIN, dtype=torch.long)
    for t in range(nkt):
        st, n = tile_scores(t)
        st[..., n:] = INT_MIN
        mx = torch.maximum(mx, st.amax(dim=-1))
    m = mx.float() * c_row
    # pass 2: p, den, the codes, the int32 p v through v8t's key slots
    den = torch.zeros(b, heads, s)
    pv = torch.zeros(b, heads, s, d, dtype=torch.long)
    pv_keys = torch.zeros_like(pv)
    v_keys = _v_keys(v, vs, g, heads, d)
    for t in range(nkt):
        st, n = tile_scores(t)
        x = st.float() * c_row[..., None] - m[..., None]
        x[..., n:] = -float("inf")
        p = torch.exp2(x)
        den += p.sum(dim=-1)
        codes = torch.round(p * 127.0).long()
        slots = torch.zeros_like(codes)
        slots[..., SLOTS] = codes
        pv += slots @ vt[..., t * KEYS:(t + 1) * KEYS].transpose(2, 3)
        vk = torch.zeros(b, heads, KEYS, d, dtype=torch.long)
        vk[:, :, :n] = v_keys[:, :, t * KEYS:t * KEYS + n]
        pv_keys += codes @ vk
    v127 = (vs[:, g] / 127.0)[..., None, None]
    o = (pv.float() * v127) * (1.0 / den)[..., None]
    out = o.to(q.dtype).permute(0, 2, 1, 3).reshape(b, s, c)
    scores = qh @ kh.transpose(2, 3)
    return out, {"q8": q8, "k8": k8, "v8t": v8t, "c": c_row,
                 "max_int": mx, "scores": scores, "pv": pv,
                 "pv_keys": pv_keys}


def _v_keys(v, vs, g, heads, d):
    """v's codes per head in key order, [B, H, S, d] (int64): p v's
    reference order."""
    b, s, c = v.shape
    grp = torch.arange(c) // GROUP
    v8 = _codes(v, vs[:, None, grp]).long()
    return v8.reshape(b, s, heads, d).permute(0, 2, 1, 3)


def _inputs(b, s, heads, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(
        (scale * rng.standard_normal((b, s, heads * d))).astype(np.float32))
        for scale in (1.0, 1.5, 0.7))
    return tuple(t.to(dtype) for t in (q, k, v))


# (B, S, heads, head_dim): S = 40 / 100 one ragged key tile, 520 65 q-blocks
# of 8 rows (shorter than a 64-row block), 576 nine 64-row q-blocks, 1024
# two 512-row q-blocks; C = 160 and 192 a last group of one head
CASES = [(2, 40, 5, 32), (2, 100, 4, 32), (1, 520, 4, 32), (1, 576, 5, 32),
         (1, 1024, 4, 32), (2, 40, 3, 64), (2, 100, 2, 64), (1, 520, 2, 64),
         (1, 576, 3, 64), (1, 1024, 2, 64)]


@pytest.mark.parametrize("b,s,heads,d", CASES)
def test_codes_launch_layout(b, s, heads, d):
    q, k, v = _inputs(b, s, heads, d, torch.bfloat16, seed=s + d)
    q8, k8, v8t, (qs, ks, vs) = codes_launch(q, k, v, heads, d)
    c = heads * d
    sp = -(-s // KEYS) * KEYS
    assert q8.dtype == k8.dtype == v8t.dtype == torch.int8
    assert q8.shape == k8.shape == (b, s, c) and v8t.shape == (b, c, sp)
    pad = torch.arange(s, sp)  # keys past S: zero where their slots are
    assert not v8t[..., pad // KEYS * KEYS + SLOTS[pad % KEYS]].any()
    # the codes are the plain version's, cell by cell
    bq = bk._q8_block_rows(s)
    for g0 in range(0, c, GROUP):
        lanes = slice(g0, min(c, g0 + GROUP))
        want_k = bk._codes(k[..., lanes].float(),
                           bk._absmax_scale(k[..., lanes].float()))
        assert torch.equal(k8[..., lanes].double(), want_k)
        for q0 in range(0, s, bq):
            qg = q[:, q0:q0 + bq, lanes].float()
            assert torch.equal(q8[:, q0:q0 + bq, lanes].double(),
                               bk._codes(qg, bk._absmax_scale(qg)))
        want_v = bk._codes(v[..., lanes].float(),
                           bk._absmax_scale(v[..., lanes].float()))
        keys = torch.arange(s)
        pos = keys // KEYS * KEYS + SLOTS[keys % KEYS]
        assert torch.equal(v8t[:, lanes][..., pos].transpose(1, 2).double(),
                           want_v)


def test_key_slot_is_the_p_fragment_order():
    """Each 32 keys' slots are a permutation of them, and the kernel's
    packing of p (csrc/packed_attn_q8.cu `step2`, `issue_pv`) puts the code
    of every score a thread holds at its key's slot: thread t of a quad
    (lane = 4 g + t) holds S columns 8 j + 2 t + {0, 1} of rows g and
    g + 8 (accumulator element 4 j + 2 hh + e); its register 2 jp + hh is
    A register 2 jp + hh - 4 kc of k32 step kc, whose byte e holds row
    g + 8 (reg % 2), K position 32 kc + 16 (reg // 2) + 4 t + e (the 8-bit
    A fragment, as mma.m16n8k32's)."""
    assert sorted(key_slot(k) for k in range(32)) == list(range(32))
    assert sorted(key_slot(k) for k in range(32, 64)) == list(range(32, 64))
    seen = set()
    for t in range(4):
        for jp in range(KEYS // 16):
            for hh in range(2):
                for e in range(4):
                    idx = 8 * jp + 4 * (e >> 1) + 2 * hh + (e & 1)
                    key = 8 * (idx >> 2) + 2 * t + (idx & 1)
                    row_half = idx >> 1 & 1
                    reg = 2 * jp + hh
                    kc, r = reg // 4, reg % 4
                    assert r % 2 == row_half == hh
                    k_pos = 32 * kc + 16 * (r // 2) + 4 * t + e
                    assert key_slot(key) == k_pos
                    seen.add((hh, key))
    assert len(seen) == 2 * KEYS  # every key of both rows once


@pytest.mark.parametrize("b,s,heads,d", CASES)
def test_pass1_max_and_exact_pv(b, s, heads, d):
    """Pass 1's integer max, scaled, is the max of the scaled scores, row
    by row; the int32 p v through v8t's key slots equals p v in key
    order; both fit int32."""
    q, k, v = _inputs(b, s, heads, d, torch.bfloat16, seed=s + d + 1)
    _, got = attn_q8_walk(q, k, v, heads=heads, head_dim=d)
    sc, c = got["scores"], got["c"]
    assert torch.equal(got["max_int"], sc.amax(dim=-1))
    scaled = sc.float() * c[..., None]  # f32 products, each rounded
    assert torch.equal(scaled.amax(dim=-1),
                       got["max_int"].float() * c)
    assert sc.abs().max() < 2 ** 22  # float(s) by the 1.5 * 2^23 add
    assert torch.equal(got["pv"], got["pv_keys"])
    assert got["pv"].abs().max() <= 127 * 127 * s < 2 ** 31


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,heads,d", CASES)
def test_walk_matches_plain(b, s, heads, d, dtype):
    q, k, v = _inputs(b, s, heads, d, dtype, seed=s + 7 * d)
    got, _ = attn_q8_walk(q, k, v, heads=heads, head_dim=d)
    want = bk.packed_attn_q8_reference(q, k, v, heads=heads, head_dim=d)
    assert got.dtype == dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= (1e-5 if dtype == torch.float32 else CARD_TOL), rel


def _pallas_attn_q8(q, k, v, d):
    """The TPU kernel in interpret mode on C padded to 128-lane groups:
    grid (image, group, q-block), a cell's q [1, bq, 128] and its group's
    whole k, v [1, S, 128], as the JAX wrapper's row-tiled grid gives
    them."""
    b, s, c = q.shape
    cp = -(-c // GROUP) * GROUP
    bq = bk._q8_block_rows(s)
    pad = [np.pad(a, ((0, 0), (0, 0), (0, cp - c))) for a in (q, k, v)]
    qspec = pl.BlockSpec((1, bq, GROUP), lambda bi, gi, qi: (bi, qi, gi))
    kvspec = pl.BlockSpec((1, s, GROUP), lambda bi, gi, qi: (bi, 0, gi))
    out = pl.pallas_call(
        functools.partial(jbk._packed_attn_kernel_q8, head_dim=d,
                          scale=float(d) ** -0.5),
        grid=(b, cp // GROUP, s // bq), in_specs=[qspec, kvspec, kvspec],
        out_specs=qspec,
        out_shape=jax.ShapeDtypeStruct((b, s, cp), jnp.float32),
        interpret=True)(*(jnp.asarray(a) for a in pad))
    return np.asarray(out)[..., :c]


@pytest.mark.parametrize("b,s,heads,d", [(2, 40, 5, 32), (1, 100, 4, 32),
                                         (1, 520, 4, 32), (1, 1024, 4, 32),
                                         (2, 40, 3, 64), (1, 100, 2, 64),
                                         (1, 1024, 2, 64)])
def test_walk_matches_jax_kernel(b, s, heads, d):
    q, k, v = _inputs(b, s, heads, d, torch.float32, seed=s + 3 * d)
    want = _pallas_attn_q8(*(a.numpy() for a in (q, k, v)), d)
    got, _ = attn_q8_walk(q, k, v, heads=heads, head_dim=d)
    _close_int8(got, want)
    _close_int8(bk.packed_attn_q8_reference(q, k, v, heads=heads,
                                            head_dim=d), want)
