"""Flash and decode attention of the PyTorch port vs the JAX reference.

On the CPU the port's wrappers run their plain torch versions (the CUDA
kernels run only on a card, ``tests/test_torch_card.py``).  They are held
against the reference's Pallas kernels in interpret mode and its ``ref.py``
oracles, on the cases of ``tests/test_kernels.py`` and
``tests/test_decode_attention_kernel.py``, with inputs made by numpy from a
seed.  Tolerances are the reference tests' own: 2e-5 in float32 (another
summation order), 3e-2 in bfloat16 (the output is rounded to bf16).  The
decode kernels' split-S plan (per-chunk softmax statistics combined in
chunk order) is emulated in plain torch and held at 1e-5 in float32.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels.decode_attention import decode_attention_bhsd as ref_decode
from repro.kernels.flash_attention import flash_attention_bhld as ref_flash
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

F32 = dict(rtol=2e-5, atol=2e-5)

FLASH_SHAPES = [
    # (B, Hq, Hkv, L, D, block) as in tests/test_kernels.py
    (1, 2, 2, 64, 32, 32),      # MHA
    (2, 4, 2, 96, 32, 32),      # GQA 2:1, ragged L vs block
    (1, 8, 1, 128, 64, 64),     # MQA
    (1, 2, 2, 50, 16, 32),      # L not divisible by block (padding path)
]


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("b,hq,hkv,sl,d,blk", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 24])
def test_flash_plain_matches_reference_kernel(b, hq, hkv, sl, d, blk, causal,
                                              window):
    q, k, v = _normal(sl * d + hq, (b, hq, sl, d), (b, hkv, sl, d),
                      (b, hkv, sl, d))
    before = fa.LAUNCHES
    got = fa.flash_attention_bhld(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window)
    assert fa.LAUNCHES == before           # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == q.shape
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = ref_flash(jq, jk, jv, causal=causal, window=window, block_q=blk,
                     block_k=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    oracle = ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_head_dim_256_windowed_matches_oracle(causal):
    """RecurrentGemma's local attention: MQA at head dim 256 with a window
    shorter than L (the card's mma.sync route at D 256 is held against
    this plain version in ``tests/test_torch_card.py``)."""
    q, k, v = _normal(256, (2, 4, 80, 256), (2, 1, 80, 256),
                      (2, 1, 80, 256))
    got = fa.flash_attention_bhld(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=24)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    oracle = ref.attention_ref(jq, jk, jv, causal=causal, window=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)
    want = ref_flash(jq, jk, jv, causal=causal, window=24, block_q=32,
                     block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_plain_bf16_matches_reference_kernel():
    q, k, v = (x.astype(ml_dtypes.bfloat16) for x in
               _normal(7, (1, 2, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
    tq, tk, tv = (torch.from_numpy(x.view(np.uint16).copy())
                  .view(torch.bfloat16) for x in (q, k, v))
    got = fa.flash_attention_bhld(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    want = ref_flash(*map(jnp.asarray, (q, k, v)), causal=True, block_q=32,
                     block_k=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("window", [0, 24])
def test_flash_model_layout_wrapper_matches_ops(window):
    q, k, v = _normal(3, (2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             window=window)
    assert got.shape == q.shape
    want = ops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                               window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_backward_raises():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in
               _normal(4, (1, 2, 16, 16), (1, 2, 16, 16), (1, 2, 16, 16)))
    out = fa.flash_attention_bhld(q, k, v)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.sum().backward()


def test_flash_rejects_mismatched_inputs():
    q, k, v = map(torch.from_numpy, _normal(5, (1, 4, 16, 16),
                                            (1, 3, 16, 16), (1, 3, 16, 16)))
    with pytest.raises(ValueError):
        fa.flash_attention_bhld(q, k, v)
    with pytest.raises(TypeError):
        fa.flash_attention_bhld(q, q.double(), q)


DECODE_CASES = [
    # (B, Hq, Hkv, S, D, block) as in tests/test_decode_attention_kernel.py
    (2, 4, 2, 128, 32, 64),
    (1, 8, 1, 200, 64, 64),     # MQA, ragged S
    (3, 2, 2, 64, 16, 32),
]


def _decode_inputs(seed, b, hq, hkv, s, d, fill_frac=1.0):
    q, k, v = _normal(seed, (b, hq, d), (b, hkv, s, d), (b, hkv, s, d))
    n_valid = max(1, int(s * fill_frac))
    pos = np.where(np.arange(s)[None] < n_valid, np.arange(s)[None], -1)
    pos = np.broadcast_to(pos, (b, s)).astype(np.int32)
    q_pos = np.full((b,), n_valid - 1, np.int32)
    return q, k, v, pos, q_pos


def _both_decode(args, window, blk):
    got = da.decode_attention_bhsd(*(torch.from_numpy(np.ascontiguousarray(x))
                                     for x in args), window=window)
    jargs = [jnp.asarray(x) for x in args]
    return (got, ref_decode(*jargs, window=window, block_s=blk),
            ref.decode_attention_ref(*jargs, window=window))


@pytest.mark.parametrize("b,hq,hkv,s,d,blk", DECODE_CASES)
@pytest.mark.parametrize("window", [0, 48])
def test_decode_plain_matches_reference_kernel(b, hq, hkv, s, d, blk, window):
    args = _decode_inputs(s + d + b, b, hq, hkv, s, d)
    before = da.LAUNCHES
    got, want, oracle = _both_decode(args, window, blk)
    assert da.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)


@pytest.mark.parametrize("window", [0, 48])
def test_decode_plain_on_a_ring_with_empty_slots(window):
    """A wrapped ring buffer: slots hold positions out of order, some are
    empty (pos = -1) and some lie past the query (pos > q_pos)."""
    q, k, v, _, _ = _decode_inputs(9, 2, 4, 2, 128, 32)
    rng = np.random.default_rng(10)
    pos = np.stack([np.roll(np.arange(300, 428), 37),
                    np.where(rng.random(128) < 0.3, -1,
                             rng.permutation(128))]).astype(np.int32)
    q_pos = np.array([400, 90], np.int32)
    got, want, oracle = _both_decode((q, k, v, pos, q_pos), window, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)


def test_decode_takes_the_model_cache_layout_without_a_copy():
    """k/v as the model caches them, [B, S, Hkv, D], viewed as [B,Hkv,S,D]."""
    q, k, v, pos, q_pos = _decode_inputs(11, 2, 4, 2, 96, 32, fill_frac=0.8)
    kc = torch.from_numpy(np.ascontiguousarray(k.swapaxes(1, 2)))
    vc = torch.from_numpy(np.ascontiguousarray(v.swapaxes(1, 2)))
    got = da.decode_attention_bhsd(torch.from_numpy(q), kc.transpose(1, 2),
                                   vc.transpose(1, 2), torch.from_numpy(pos),
                                   torch.from_numpy(q_pos))
    want = ref.decode_attention_ref(*map(jnp.asarray, (q, k, v, pos, q_pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ------------------------------------------------- the card kernels' plans --

def test_flash_route_is_a_function_of_dtype_and_head_dim():
    """bf16 at D 64, 128 and 256 takes the wgmma + TMA kernel, bf16 at D 16
    and 32 the mma.sync kernel, float32 the 3xTF32 tensor-core kernel."""
    assert [fa.route(torch.bfloat16, d) for d in fa.HEAD_DIMS] == [
        "mma-sync", "mma-sync", "wgmma-tma", "wgmma-tma", "wgmma-tma"]
    assert {fa.route(torch.float32, d) for d in fa.HEAD_DIMS} == {
        "f32-3xtf32"}
    assert set(fa.ROUTES) == {"f32-3xtf32", "mma-sync", "wgmma-tma"}


def test_decode_split_fills_the_card_at_the_yi6b_shape():
    """B 4, Hkv 4, group 8, S 4,096: at least 132 CTAs, and at least 132
    whose chunk holds a valid slot of the half-full ring; where B·Hkv
    alone fills the card, one chunk."""
    b, hkv, group, s = 4, 4, 8, 4096
    chunk, n_split = da.plan(b, hkv, group, s)
    assert chunk % da.KEY_BLOCK == 0 and n_split == -(-s // chunk)
    assert b * hkv * n_split >= 132
    assert b * hkv * (-(-(s // 2) // chunk)) >= 132
    assert da.plan(34, 4, 8, 300) == (300, 1)
    assert da.plan(34, 4, 8, 100_000)[0] == da.MAX_CHUNK


def _split_decode(q, k, v, pos, q_pos, *, window, chunk):
    """The decode kernels' algorithm in plain torch: per S chunk of
    ``chunk`` slots its (m, l, acc) in base 2 (m = -1e30, l = 0, acc = 0
    for a chunk with no valid slot), then the chunks combined in order."""
    b, hq, d = q.shape
    group = hq // k.shape[1]
    s_len = k.shape[2]
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    kk = k.repeat_interleave(group, 1)
    vv = v.repeat_interleave(group, 1)
    valid = (pos >= 0) & (pos <= q_pos[:, None])
    if window > 0:
        valid &= (q_pos[:, None] - pos) < window
    parts = []
    for c0 in range(0, s_len, chunk):
        sl = slice(c0, min(c0 + chunk, s_len))
        sc = torch.einsum("bhd,bhsd->bhs", q, kk[:, :, sl]) * scale_log2
        ok = valid[:, None, sl].expand_as(sc)
        m = torch.where(ok, sc, torch.full_like(sc, -1e30)).amax(-1)
        p = torch.where(ok, torch.exp2(sc - m[..., None]),
                        torch.zeros_like(sc))
        parts.append((m, p.sum(-1),
                      torch.einsum("bhs,bhsd->bhd", p, vv[:, :, sl])))
    big = torch.stack([m for m, _, _ in parts])
    ls = torch.stack([l for _, l, _ in parts])
    mx = torch.where(ls > 0, big, torch.full_like(big, -1e30)).amax(0)
    out = torch.zeros_like(q)
    lsum = torch.zeros_like(ls[0])
    for m, l, acc in parts:                      # in chunk order
        f = torch.where(l > 0, torch.exp2(m - mx), torch.zeros_like(m))
        lsum = lsum + l * f
        out = out + acc * f[..., None]
    return out / lsum.clamp_min(1e-30)[..., None]


def _split_rings(kind, rng, b, s):
    slot = np.arange(s)
    if kind == "empty_chunks":
        # row 0 keeps its first 100 slots, row 1 none, row 2 the second
        # half, positions out of order
        pos = np.stack([np.where(slot < 100, slot, -1), np.full(s, -1),
                        np.where(slot >= s // 2, rng.permutation(s), -1)])
        return pos, np.array([99, 5, s - 1])
    # a half-full ring that has wrapped, q_pos a little behind the newest
    pos = np.where(slot < s // 2, slot + s, -1)[None].repeat(b, 0)
    return pos, s + s // 2 - 1 - 7 * np.arange(b)


@pytest.mark.parametrize("kind,window", [("empty_chunks", 0),
                                         ("empty_chunks", 300),
                                         ("half_ring", 0),
                                         ("half_ring", 100)])
def test_decode_split_combine_matches_plain_and_reference(kind, window):
    b, hq, hkv, s, d = 3, 8, 2, 1024, 32
    chunk, n_split = da.plan(b, hkv, hq // hkv, s)
    assert n_split > 1
    q, k, v = _normal(s + window, (b, hq, d), (b, hkv, s, d), (b, hkv, s, d))
    pos, q_pos = _split_rings(kind, np.random.default_rng(1), b, s)
    pos, q_pos = pos.astype(np.int32), q_pos.astype(np.int32)
    tq, tk, tv, tpos, tqp = map(torch.from_numpy, (q, k, v, pos, q_pos))
    got = _split_decode(tq, tk, tv, tpos, tqp, window=window, chunk=chunk)
    assert bool(torch.isfinite(got).all())
    want = ref_decode(*map(jnp.asarray, (q, k, v, pos, q_pos)),
                      window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the plain version averages v over a row with no valid slot; the
    # kernels (and the reference kernel) give 0 there
    keep = (pos >= 0) & (pos <= q_pos[:, None])
    if window:
        keep &= (q_pos[:, None] - pos) < window
    rows = keep.any(-1)
    plain = da.decode_attention_plain(tq, tk, tv, tpos, tqp, window=window)
    np.testing.assert_allclose(got.numpy()[rows], plain.numpy()[rows],
                               rtol=1e-5, atol=1e-5)
    assert bool((got[torch.from_numpy(~rows)] == 0).all())
