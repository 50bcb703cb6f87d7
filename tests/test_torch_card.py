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
tensor-core product).  The flash cases cover both bf16 routes (wgmma + TMA
at D 64 and 128, mma.sync at D 16, 32 and 256) and the wgmma tiling's
edges;
the decode cases the split-S plan's edges (empty chunks, ragged S, one
chunk, two head chunks a kv head, a row with no valid slot).  The SSD
chunk kernel's four outputs are each held relative to their own scale,
max |got - want| / max |want| <= 5e-4: the
kernel sums cum = cumsum(dt * a) in its own order (a warp scan) and
torch.cumsum in another, and exp(cum_i - cum_j) turns the rounding of cum
(up to ~4e3 in magnitude at mamba2's a = -16) into relative error; its
products run in 3xTF32 on the tensor cores (about 21 bits an operand).
The SSD cases cover the m16n8k8 tiles' edges (ragged Q, P, N and heads,
and P, N not multiples of 4, which take 4-byte copies), the Eq.-8 cases
the grid's edges (N under a slice, a few groups past a full pass, C 0 and
256, rows only 4-byte aligned).  Fused Adam: bf16 p within one bf16
ulp, f32 p within 1e-6 relative, m and v within 1e-6 relative.  Every
kernel check is also shown a planted fault (the plain version with it),
which it must reject.  The mobile path's cell→cloud hierarchy and a moving
3-cell open-world run are held against the same on the CPU: protocol
decisions and host numbers bitwise, params within rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_adam as adam
from repro_torch.kernels import ssd_scan as ssd
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
    mask[:1] = 1.0
    return (torch.from_numpy(x).cuda() for x in (p, buf, mask))


@pytest.mark.parametrize("c,n", [
    (1, 79_510), (5, 79_510), (8, 79_510), (128, 79_510), (16, 1_000_003),
    (3, 7),
    (2, 1),              # N under one CTA's slice
    (256, 79_510),       # the engine's largest padded bucket
    (0, 79_510),         # no rows: A clamps to 1, the output is p
    (128, 1_001),        # N odd: rows only 4-byte aligned
    (8, 135_171),        # a few groups past a full pass at V = 1 on 132 SMs
])
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


@pytest.mark.parametrize("vec", [1, 2, 4])
def test_stale_aggregate_kernel_grid_edges(vec):
    """N at and a few columns past a whole number of the grid's slices on
    this card: the launch shape covers N and fills the SMs evenly."""
    _need_card()
    slots = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    for n in (slots * 512 * vec, slots * 512 * vec + 3 * vec,
              slots * 37 * vec + vec):
        p, buf, mask = _inputs(5, n, seed=n)
        v = agg.vector_width(n, p, buf)       # the width the wrapper takes
        ctas, threads, per = agg.launch_shape(n, v)
        groups = n // v
        assert ctas <= slots and threads <= 512
        assert ctas * threads * per >= groups > (ctas - 1) * threads * per
        got = agg.stale_aggregate_flat(p, buf, mask, beta=0.07)
        want = agg.stale_aggregate_plain(p, buf, mask, beta=0.07)
        assert float((got - want).abs().max()) <= 1e-6 * (
            1 + float(p.abs().max()))


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
    # the wgmma route's edges: L not a multiple of its 128-row tiles, a
    # window edge inside a tile, MQA and GQA group 8, non-causal
    (1, 2, 2, 129, 128, True, 0),
    (1, 2, 1, 4095, 128, True, 0),
    (1, 4, 2, 2047, 128, True, 512),
    (1, 8, 1, 300, 64, True, 0),
    (1, 8, 1, 300, 128, True, 0),
    (1, 16, 2, 257, 64, True, 0),
    (1, 16, 2, 257, 128, True, 0),
    (2, 4, 2, 200, 128, False, 0),
    # D 16 and 32 stay on the mma.sync route
    (1, 4, 2, 130, 16, True, 0),
    (1, 8, 2, 150, 32, True, 40),
    # D 256 (RecurrentGemma's local attention: MQA, Hq 10) on the mma.sync
    # route with Q read from shared memory: ragged L, a window edge inside
    # a tile, a window wider than L, non-causal
    (1, 10, 1, 300, 256, True, 64),
    (2, 10, 1, 1000, 256, True, 200),
    (1, 4, 2, 129, 256, True, 0),
    (1, 2, 1, 200, 256, False, 0),
    (1, 10, 1, 4096, 256, True, 2048),
    # Mixtral's sliding window on its scoring path: GQA group 6 at D 128
    # with the window as long as the sequence (it must cut nothing beyond
    # the causal mask), at a tile multiple and at a ragged L
    (1, 12, 2, 1024, 128, True, 1024),
    (2, 12, 2, 1000, 128, True, 1000),
]

ROUTE = {16: "mma-sync", 32: "mma-sync", 64: "wgmma-tma", 128: "wgmma-tma",
         256: "mma-sync"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sl,d,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain(dtype, b, hq, hkv, sl, d, causal,
                                    window):
    _need_card()
    assert fa.route(dtype, d) == (ROUTE[d] if dtype == torch.bfloat16
                                  else "f32-fma")
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_kernel_broadcast_kv(dtype, d):
    """k/v expanded from one head of one batch row (stride 0 over B and
    H): the f32 and mma.sync routes read it in place; the wgmma route's
    tensor maps cannot step a stride of 0, so the wrapper and the C entry
    refuse it.  A stride of 0 on a size-1 dim is fine on every route."""
    _need_card()
    b, hq, hkv, sl = 2, 4, 2, 200
    q, kb, vb = _randn(d, dtype, (b, hq, sl, d), (1, 1, sl, d),
                       (1, 1, sl, d))
    k, v = kb.expand(b, hkv, sl, d), vb.expand(b, hkv, sl, d)
    want = fa.attention_plain(q.float(), k.float(), v.float(), causal=True)
    before = fa.LAUNCHES
    if fa.route(dtype, d) == "wgmma-tma":
        with pytest.raises(ValueError, match="broadcast"):
            fa.flash_attention_bhld(q, k, v, causal=True)
        assert fa.LAUNCHES == before
        out = torch.empty_like(q)
        if fa._FN is None:
            fa.build()
        err = fa._FN(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), fa.ROUTES["wgmma-tma"], b, hq, hkv, sl,
                     d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *out.stride()[:3], 1, 0, 1.0 / d ** 0.5,
                     torch.cuda.current_stream().cuda_stream)
        assert err == 1                         # cudaErrorInvalidValue
    else:
        got = fa.flash_attention_bhld(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == before + 1
        _assert_attn_close("flash", got, want)
    # batch 1 with k/v expanded over it: stride 0 on a dim of size 1
    before = fa.LAUNCHES
    k1, v1 = (t[0].contiguous().as_strided((1, hkv, sl, d),
                                           (0, sl * d, d, 1))
              for t in (k, v))
    got = fa.flash_attention_bhld(q[:1], k1, v1, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    _assert_attn_close("flash", got, want[:1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("sl", [1024, 1000])
def test_flash_kernel_window_of_l_equals_causal(dtype, sl):
    """A window as long as the sequence keeps every causal key: the
    kernel's output equals its causal output without a window, bitwise
    (group 6 at D 128, Mixtral's scoring shape cut to 12 heads)."""
    _need_card()
    q, k, v = _randn(sl, dtype, (1, 12, sl, 128), (1, 2, sl, 128),
                     (1, 2, sl, 128))
    windowed = fa.flash_attention_bhld(q, k, v, causal=True, window=sl)
    causal = fa.flash_attention_bhld(q, k, v, causal=True, window=0)
    assert torch.equal(windowed, causal)


def _moe_case(seed):
    """A DeepSeek-V2-like MoE in bf16 (16 experts, top-6, one shared
    expert, capacity factor 1 so that some pairs drop) and its input."""
    from repro_torch.config import ModelConfig, MoEConfig
    from repro_torch.models import layers as L
    cfg = ModelConfig(d_model=256, num_layers=2, d_ff=128, dtype="bfloat16",
                      moe=MoEConfig(num_experts=16, experts_per_token=6,
                                    num_shared_experts=1, expert_d_ff=128,
                                    capacity_factor=1.0))
    params = L.moe_init(torch.Generator().manual_seed(seed), cfg)
    x = torch.randn((4, 64, 256), generator=torch.Generator().manual_seed(
        seed + 1)).to(torch.bfloat16)
    return L, cfg, params, x


def test_moe_gather_on_card_is_deterministic_and_matches_cpu():
    """The fixed-order combine: two calls on the card give the same bits
    (a scatter-add with atomics would not, at top-6 in bf16), and the
    output rows agree with the CPU's within 1e-2 relative (bf16 expert
    products in another summation order).  The router's top-6 gaps exceed
    1e-5 on these inputs, so no token routes differently on the card."""
    _need_card()
    L, cfg, params, x = _moe_case(0)
    xf = x.reshape(-1, 256).double()
    full = torch.softmax(xf @ params["router"].double(), -1)
    srt = full.sort(-1, descending=True).values
    assert float((srt[:, 5] - srt[:, 6]).min()) > 1e-5
    want, want_aux = L.moe_apply_gather(params, x, cfg)
    dparams = {k: v.cuda() for k, v in params.items()}
    got, aux = L.moe_apply_gather(dparams, x.cuda(), cfg)
    again, _ = L.moe_apply_gather(dparams, x.cuda(), cfg)
    assert torch.equal(got, again)
    cap = L.moe_capacity(x.shape[0] * x.shape[1], cfg.moe)
    _, idx, _ = L._route(dparams, x.cuda().reshape(-1, 256).float(), cfg.moe)
    dst = L.moe_dispatch(idx, 16, cap).cpu()
    _, want_idx, _ = L._route(params, x.reshape(-1, 256).float(), cfg.moe)
    assert torch.equal(idx.cpu(), want_idx)
    assert torch.equal(dst, L.moe_dispatch(want_idx, 16, cap))
    assert bool((dst == 16 * cap).any())            # some pairs dropped
    got, want = got.float().cpu(), want.float()
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert float(rel.max()) <= 1e-2
    assert abs(float(aux) - float(want_aux)) <= 1e-6


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
    (4, 32, 4, 1000, 128, 0),       # S not a multiple of the chunk (32)
    (34, 8, 4, 300, 64, 0),         # B·Hkv >= 132: one chunk, no combine
    (2, 32, 2, 512, 128, 0),        # group 16: two head chunks a kv head
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 300])
def test_decode_kernel_empty_chunks_and_rows(dtype, window):
    """Row 0 keeps its first 100 slots only, so most S chunks are empty;
    row 1 keeps none and must read 0 (the plain softmax would average v
    there); row 2 keeps the second half, positions out of order."""
    _need_card()
    b, hq, hkv, s, d = 3, 16, 2, 1024, 128
    assert da.plan(b, hkv, hq // hkv, s)[1] > 1
    q, kc, vc = _randn(s + window, dtype, (b, hq, d), (b, s, hkv, d),
                       (b, s, hkv, d))
    slot = np.arange(s)
    rng = np.random.default_rng(3)
    pos = np.stack([np.where(slot < 100, slot, -1), np.full(s, -1),
                    np.where(slot >= s // 2, rng.permutation(s), -1)])
    pos = torch.from_numpy(pos.astype(np.int32)).cuda()
    q_pos = torch.tensor([99, 5, s - 1], dtype=torch.int32, device="cuda")
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    before = da.LAUNCHES
    got = da.decode_attention_bhsd(q, k, v, pos, q_pos, window=window)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 1
    want = da.decode_attention_plain(q.float(), k.float(), v.float(), pos,
                                     q_pos, window=window)
    assert bool(torch.isfinite(got.float()).all())
    assert bool((got[1] == 0).all())
    _assert_attn_close("decode", got[0::2], want[0::2])


# ------------------------------------------------------------- SSD chunk --

SSD_RTOL = 5e-4

SSD_CASES = [
    # (B, NC, Q, H, P, N, model-like decay a = -linspace(1, 16))
    (1, 2, 16, 1, 4, 4, False),
    (2, 3, 64, 4, 16, 8, False),
    (1, 2, 100, 3, 8, 16, True),
    (1, 1, 200, 9, 64, 128, True),
    (1, 4, 256, 8, 32, 32, False),
    (2, 2, 256, 32, 64, 128, True),
    # the m16n8k8 tiles' edges: P and N not multiples of 8, Q 17, one head
    # past a group of 8, P and N not multiples of 4 (4-byte copies)
    (1, 2, 64, 4, 12, 20, False),
    (2, 1, 17, 3, 8, 8, True),
    (1, 1, 128, 33, 16, 32, True),
    (1, 2, 40, 3, 6, 10, False),
]


def _ssd_case(b, nc, q, h, p, n, model_decay, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = randn(b, nc, q, h, p)
    dt = torch.nn.functional.softplus(randn(b, nc, q, h))
    a = (-torch.linspace(1.0, 16.0, h, device="cuda") if model_decay
         else -torch.exp(randn(h) * 0.5))
    return x, dt, a, randn(b, nc, q, n), randn(b, nc, q, n)


def ssd_unmasked(x, dt, a, b, c):
    """The plain version with the j <= i mask dropped (a planted fault)."""
    da = (dt * a).movedim(-1, -2)
    cum = torch.cumsum(da, dim=-1)
    lmat = torch.exp(cum[..., :, None] - cum[..., None, :])
    scores = torch.einsum("bzin,bzjn->bzij", c, b)
    return torch.einsum("bzhij,bzjhp->bzihp", scores[:, :, None] * lmat,
                        x * dt[..., None])


def _scaled_err(got, want):
    """max |got - want| / max |want|; NaN or inf if either is not finite."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


@pytest.mark.parametrize("b,nc,q,h,p,n,model_decay", SSD_CASES)
def test_ssd_kernel_matches_plain(b, nc, q, h, p, n, model_decay):
    _need_card()
    args = _ssd_case(b, nc, q, h, p, n, model_decay, seed=q + h)
    before = ssd.LAUNCHES
    got = ssd.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == before + 1
    want = ssd.ssd_chunk_plain(*args)
    for name, g, w in zip(("y", "states", "chunk_decay", "in_decay"), got,
                          want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _scaled_err(g, w) <= SSD_RTOL, (name, _scaled_err(g, w))
    fault = _scaled_err(ssd_unmasked(*args), want[0])
    assert not fault <= SSD_RTOL, fault      # NaN (overflow) also rejects


def test_ssd_chunked_on_card_matches_plain_model_scan():
    _need_card()
    from repro_torch.models.ssm import ssd_chunked as plain_chunked
    g = torch.Generator(device="cuda").manual_seed(5)
    bs, sl, h, p, n = 2, 333, 8, 16, 32
    x = torch.randn((bs, sl, h, p), generator=g, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((bs, sl, h), generator=g, device="cuda"))
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    bm, cm = (torch.randn((bs, sl, n), generator=g, device="cuda")
              for _ in range(2))
    y, s = ssd.ssd_chunked(x, dt, a, bm, cm, 64)
    want_y, want_s = plain_chunked(x, dt, a, bm, cm, 64)
    assert _scaled_err(y, want_y) <= SSD_RTOL
    assert _scaled_err(s, want_s) <= SSD_RTOL


def test_ssd_kernel_rejects_what_it_does_not_take():
    _need_card()
    args = list(_ssd_case(1, 1, 32, 2, 8, 8, False, seed=0))
    with pytest.raises(TypeError):
        ssd.ssd_chunk(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_chunk(args[0].transpose(3, 4).contiguous().transpose(3, 4),
                      *args[1:])
    big = _ssd_case(1, 1, 32, 2, 8, 256, False, seed=0)
    with pytest.raises(ValueError, match="N <= 128"):
        ssd.ssd_chunk(*big)
    x = args[0].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="attn_impl='xla'"):
        ssd.ssd_chunk(x, *args[1:])[0].sum().backward()


# ------------------------------------------------------------- fused Adam --

ADAM_CASES = [
    # (N, p dtype, g dtype, offset: 1 = views off the 4-element alignment)
    (1, torch.float32, torch.float32, 0),
    (3, torch.float32, torch.bfloat16, 0),
    (4097, torch.bfloat16, torch.bfloat16, 0),
    (4097, torch.float32, torch.bfloat16, 1),
    (1_000_003, torch.bfloat16, torch.float32, 0),
    (1_000_003, torch.float32, torch.float32, 1),
]


def _adam_inputs(n, p_dtype, g_dtype, offset, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(scale=1.0):
        return torch.randn(n + offset, generator=g, device="cuda")[offset:] \
            * scale

    p = randn().to(p_dtype)
    m = randn(0.1)
    v = randn(0.01).abs()
    grad = randn(1e-3).to(g_dtype)
    return p, m, v, grad


def bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (f32)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def adam_close(got, want):
    """(p, m, v) of the kernel vs the plain version: bf16 p within one bf16
    ulp, f32 p within 1e-6 relative, m and v within 1e-6 relative."""
    gp, gm, gv = got
    wp, wm, wv = want
    if gp.dtype == torch.bfloat16:
        ok_p = bool(((gp.float() - wp.float()).abs()
                     <= bf16_ulp(wp.float())).all())
    else:
        ok_p = bool(((gp - wp).abs() <= 1e-6 * wp.abs() + 1e-30).all())
    ok_mv = all(bool(((g - w).abs() <= 1e-6 * w.abs() + 1e-30).all())
                for g, w in ((gm, wm), (gv, wv)))
    return ok_p and ok_mv


@pytest.mark.parametrize("n,p_dtype,g_dtype,offset", ADAM_CASES)
@pytest.mark.parametrize("t", [1, 10])
def test_fused_adam_kernel_matches_plain(n, p_dtype, g_dtype, offset, t):
    _need_card()
    p, m, v, grad = _adam_inputs(n, p_dtype, g_dtype, offset, seed=n + t)
    lr = torch.tensor(3e-3, device="cuda")
    tt = torch.tensor(t, dtype=torch.int32, device="cuda")
    before = adam.LAUNCHES
    got = adam.fused_adam_flat(p, m, v, grad, lr=lr, t=tt)
    torch.cuda.synchronize()
    assert adam.LAUNCHES == before + 1
    assert got[0].dtype == p_dtype
    scal = adam.adam_scalars(lr, tt, 0.9, 0.95, "cuda")
    want = adam.fused_adam_plain(p, m, v, grad, scal, b1=0.9, b2=0.95,
                                 eps=1e-8)
    assert adam_close(got, want)
    # planted fault: bias corrections dropped
    no_bc = torch.stack([scal[0], torch.ones_like(scal[1]),
                         torch.ones_like(scal[2])])
    fault = adam.fused_adam_plain(p, m, v, grad, no_bc, b1=0.9, b2=0.95,
                                  eps=1e-8)
    assert not adam_close(fault, want)


def test_fused_adam_kernel_rejects_what_it_does_not_take():
    _need_card()
    p, m, v, grad = _adam_inputs(64, torch.float32, torch.float32, 0, 0)
    with pytest.raises(TypeError):
        adam.fused_adam_flat(p.half(), m, v, grad, lr=1e-3, t=1)
    with pytest.raises(TypeError):
        adam.fused_adam_flat(p, m.double(), v, grad, lr=1e-3, t=1)
    with pytest.raises(ValueError, match="contiguous"):
        adam.fused_adam_flat(p[::2], m[::2], v[::2], grad[::2], lr=1e-3,
                             t=1)
    with pytest.raises(ValueError):
        adam.fused_adam_flat(p, m.cpu(), v, grad, lr=1e-3, t=1)


# ---------------------------------------------------------------------------
# the mobile multi-cell path: the same runs on the card and on the CPU
# ---------------------------------------------------------------------------

def _hier_servers(device):
    from repro_torch.core.hierarchy import HierarchicalServer, HierarchyConfig
    from repro_torch.core.server import ServerConfig
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(size=4096).astype(
        np.float32)).to(device)}
    kw = dict(n_ues=12, participants_per_round=3, staleness_bound=2,
              beta=0.1, staleness_discount=0.6)
    return HierarchicalServer(
        params, [ServerConfig(**kw) for _ in range(3)],
        HierarchyConfig(n_cells=3, cloud_sync_every=2),
        [np.arange(c, 12, 3) for c in range(3)])


def test_hierarchy_segment_feed_on_card_matches_cpu():
    """Interleaved cells (the gather of lanes), one-cell drains (the
    slice), handovers and cloud merges: each round closes through the
    Eq.-8 kernel on the card, and every protocol decision and param
    matches the CPU's plain version."""
    _need_card()
    card, cpu = _hier_servers("cuda"), _hier_servers("cpu")
    rng = np.random.default_rng(1)
    before = agg.LAUNCHES
    for k in range(9):
        card.handover(k, int(card.member_cell[k]), (k + 1) % 3)
        cpu.handover(k, int(cpu.member_cell[k]), (k + 1) % 3)
        # one drain: other cells' lanes short of their close, shuffled,
        # then the closing cell's last lane (the driver's drain invariant)
        close = k % 3
        cells = []
        for c in range(3):
            need = card.arrivals_until_round(c)
            cells += [c] * (need if c == close else
                            int(rng.integers(0, need)))
        cells.remove(close)
        rng.shuffle(cells)
        cells = np.array(cells + [close])
        ues = rng.permutation(12)[:len(cells)]
        pay = rng.normal(size=(len(cells), 4096)).astype(np.float32)
        got = card.on_arrival_batch(cells, ues,
                                    {"w": torch.from_numpy(pay).cuda()})
        want = cpu.on_arrival_batch(cells, ues, {"w": torch.from_numpy(pay)})
        assert (got is None) == (want is None)
        if got is not None:
            for key in ("round", "cell", "distribute", "cloud_synced"):
                assert got[key] == want[key]
            torch.testing.assert_close(got["params"]["w"].cpu(),
                                       want["params"]["w"], rtol=1e-5,
                                       atol=1e-6)
    torch.cuda.synchronize()
    assert agg.LAUNCHES > before
    assert card.cloud_rounds == cpu.cloud_rounds > 0
    assert card.departed_arrivals == cpu.departed_arrivals
    np.testing.assert_array_equal(card.pi_matrix(), cpu.pi_matrix())


def test_mobile_run_on_card_matches_cpu():
    """The moving 3-cell hierarchy end to end: host event math bitwise,
    final params within float32 tolerance."""
    _need_card()
    import dataclasses

    from repro_torch.config import (ExperimentConfig, FLConfig,
                                    MobilityConfig, ScenarioConfig)
    from repro_torch.configs import get_config
    from repro_torch.data import partition_noniid, synthetic_mnist
    from repro_torch.fl.simulation import run_simulation
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves
    cfg = ExperimentConfig(
        model=get_config("mnist_dnn"),
        fl=FLConfig(n_ues=24, participants_per_round=6, staleness_bound=4,
                    alpha=0.03, beta=0.07, first_order=True, inner_batch=4,
                    outer_batch=4, hessian_batch=4),
        mobility=MobilityConfig(enabled=True, model="random_waypoint",
                                speed_mps=150.0, n_cells=3, hierarchy=True,
                                cloud_sync_every=3, step_s=0.05),
        scenario=ScenarioConfig(enabled=True, initial_active_frac=0.75,
                                arrival_rate=4.0, departure_rate=0.3,
                                min_active=4, drift_rate=0.5))
    data = synthetic_mnist(n=1200, seed=21)
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = run_simulation(
            cfg, build_model(cfg.model),
            partition_noniid(data, 24, n_labels=4, seed=0),
            bandwidth_policy="theorem2", max_rounds=6, eval_every=3, seed=0,
            device=device)
    card, cpu = out["cuda"], out["cpu"]
    for f in dataclasses.fields(card):
        if f.name in ("params", "losses", "global_losses", "accs", "name",
                      "telemetry"):
            continue
        np.testing.assert_array_equal(getattr(card, f.name),
                                      getattr(cpu, f.name), err_msg=f.name)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-5, atol=1e-6)
    for g, w in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-6)
    assert card.cloud_rounds == 2 and card.ue_departures > 0
    assert card.label_drifts > 0
