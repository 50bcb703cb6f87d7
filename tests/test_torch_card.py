"""The port's CUDA kernels on the card, each against its plain version.

Imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_card.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)

Without a CUDA card every test skips.  Tolerances: Eq. 8 at
1e-6·(1 + max|p|), since nvcc contracts the kernel's multiply-adds into
FMAs.  Attention is held against its plain version run in float32 on the
same values: float32 outputs at 5e-5 (another summation order over up to L
keys); bfloat16 outputs row by row, ||got - want|| / ||want|| over the head
dim, as ``chip_smoke.py`` holds them (a single rounding of the output to
bf16 stays under 2^-8; the flash kernel also rounds P to bf16 for its
tensor-core product).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import stale_aggregate as agg

F32_TOL = 5e-5
BF16_ROW_RTOL = {"flash": 1e-2, "decode": 4e-3}


def _assert_attn_close(kernel, got, want):
    """``want`` is the plain version in float32."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
        return
    rel = (got.float() - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(
        1e-30)
    assert float(rel.max()) <= BF16_ROW_RTOL[kernel]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a card")


def _inputs(c, n, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    buf = rng.normal(size=(c, n)).astype(np.float32)
    mask = rng.choice([0.0, 1.0, 0.5, 0.7 ** 3], size=c).astype(np.float32)
    mask[0] = 1.0
    return (torch.from_numpy(x).cuda() for x in (p, buf, mask))


@pytest.mark.parametrize("c,n", [(1, 79_510), (5, 79_510), (8, 79_510),
                                 (128, 79_510), (16, 1_000_003), (3, 7)])
def test_stale_aggregate_kernel_matches_plain(c, n):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a card")
    p, buf, mask = _inputs(c, n, seed=c + n)
    before = agg.LAUNCHES
    got = agg.stale_aggregate_flat(p, buf, mask, beta=0.07)
    torch.cuda.synchronize()
    assert agg.LAUNCHES == before + 1
    want = agg.stale_aggregate_plain(p, buf, mask, beta=0.07)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * (1 + float(p.abs().max()))


def test_stale_aggregate_kernel_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a card")
    p, buf, mask = _inputs(4, 64, seed=0)
    with pytest.raises(ValueError):
        agg.stale_aggregate_flat(p, buf.cpu(), mask, beta=0.1)
    with pytest.raises(TypeError):
        agg.stale_aggregate_flat(p.half(), buf, mask, beta=0.1)


def _randn(seed, dtype, *shapes):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(sh, generator=g, device="cuda").to(dtype)
            for sh in shapes]


FLASH_CASES = [
    # (B, Hq, Hkv, L, D, causal, window)
    (1, 2, 2, 64, 32, True, 0),
    (2, 4, 2, 96, 32, False, 24),
    (1, 8, 1, 128, 64, True, 24),
    (1, 2, 2, 50, 16, False, 0),
    (2, 8, 2, 333, 128, True, 0),
    (1, 4, 4, 1000, 128, True, 200),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sl,d,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain(dtype, b, hq, hkv, sl, d, causal,
                                    window):
    _need_card()
    q, k, v = _randn(sl + d, dtype, (b, hq, sl, d), (b, hkv, sl, d),
                     (b, hkv, sl, d))
    before = fa.LAUNCHES
    got = fa.flash_attention_bhld(q, k, v, causal=causal, window=window)
    # the model layout, read through strides
    got_m = fa.flash_attention(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(),
                               causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 2
    want = fa.attention_plain(q.float(), k.float(), v.float(), causal=causal,
                              window=window)
    assert got.dtype == dtype
    _assert_attn_close("flash", got, want)
    _assert_attn_close("flash", got_m.transpose(1, 2), want)


def test_flash_kernel_rejects_what_it_does_not_take():
    _need_card()
    q, k, v = _randn(0, torch.float32, (1, 2, 64, 48), (1, 2, 64, 48),
                     (1, 2, 64, 48))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bhld(q, k, v)
    q, k, v = _randn(0, torch.float16, (1, 2, 64, 32), (1, 2, 64, 32),
                     (1, 2, 64, 32))
    with pytest.raises(TypeError):
        fa.flash_attention_bhld(q, k, v)
    q, k, v = _randn(0, torch.float32, (1, 2, 64, 32), (1, 2, 64, 32),
                     (1, 2, 64, 32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.flash_attention_bhld(q.requires_grad_(), k, v).sum().backward()


def _ring(b, s, seed):
    g = np.random.default_rng(seed)
    pos = np.stack([np.roll(np.arange(s, 2 * s), g.integers(s)),
                    np.where(g.random(s) < 0.3, -1, g.permutation(s))]
                   + [np.arange(s)] * (b - 2))[:b]
    q_pos = np.array([2 * s - 10, s // 2] + [s - 1] * (b - 2))[:b]
    return (torch.from_numpy(pos.astype(np.int32)).cuda(),
            torch.from_numpy(q_pos.astype(np.int32)).cuda())


DECODE_CASES = [
    # (B, Hq, Hkv, S, D, window)
    (2, 4, 2, 128, 32, 0),
    (2, 8, 1, 200, 64, 48),
    (3, 2, 2, 64, 16, 0),
    (4, 32, 4, 4096, 128, 0),
    (2, 32, 2, 777, 128, 100),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,window", DECODE_CASES)
def test_decode_kernel_matches_plain(dtype, b, hq, hkv, s, d, window):
    _need_card()
    q, kc, vc = _randn(s + d, dtype, (b, hq, d), (b, s, hkv, d),
                       (b, s, hkv, d))
    pos, q_pos = _ring(b, s, seed=s)
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)     # the cache, in place
    before = da.LAUNCHES
    got = da.decode_attention_bhsd(q, k, v, pos, q_pos, window=window)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 1
    want = da.decode_attention_plain(q.float(), k.float(), v.float(), pos,
                                     q_pos, window=window)
    assert got.dtype == dtype
    _assert_attn_close("decode", got, want)
