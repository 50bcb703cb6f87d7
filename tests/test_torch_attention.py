"""Flash and decode attention of the PyTorch port vs the JAX reference.

On the CPU the port's wrappers run their plain torch versions (the CUDA
kernels run only on a card, ``tests/test_torch_card.py``).  They are held
against the reference's Pallas kernels in interpret mode and its ``ref.py``
oracles, on the cases of ``tests/test_kernels.py`` and
``tests/test_decode_attention_kernel.py``, with inputs made by numpy from a
seed.  Tolerances are the reference tests' own: 2e-5 in float32 (another
summation order), 3e-2 in bfloat16 (the output is rounded to bf16).
"""
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
