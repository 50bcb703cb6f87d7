"""The yardstick's counts against hand-worked cases (CPU, milliseconds)."""
import pytest

from portbench import work

TINY_LM = dict(family="audio", num_layers=2, d_model=8, num_heads=2,
               num_kv_heads=1, d_ff=16, vocab_size=10, activation="gelu",
               num_audio_codebooks=3, dtype="bfloat16")
TINY_SSM = dict(family="ssm", num_layers=2, d_model=4, vocab_size=10,
                dtype="bfloat16",
                ssm=dict(state_dim=2, head_dim=2, expand=2, chunk_size=2,
                         conv_width=4))


@pytest.mark.parametrize("sl, causal, window, want", [
    (4, True, 0, 10), (4, False, 0, 16), (5, True, 2, 9), (1, True, 0, 1)])
def test_kept_pairs(sl, causal, window, want):
    assert work.kept_pairs(sl, causal, window) == want


def test_transformer_forward_flops_by_hand():
    # a layer: q 8x8, k and v 8x4 each, o 8x8, gated MLP 3 x 8x16 -> 576;
    # heads 3 x 8 x 10 = 240
    assert work.transformer_matrix_params(TINY_LM) == (576, 240)
    # 2 x (2 x 576 + 240) x (2 x 3 positions) + 2 layers x 4 x D 4 x
    # (2 rows x 2 heads x 6 pairs)
    assert work.transformer_forward_flops(TINY_LM, 2, 3) == \
        2 * 1392 * 6 + 2 * 4 * 4 * 2 * 2 * 6


def test_musicgen_large_counts_as_published():
    cfg = dict(TINY_LM, num_layers=48, d_model=2048, num_heads=32,
               num_kv_heads=32, d_ff=8192, vocab_size=2048,
               num_audio_codebooks=4)
    layer, heads = work.transformer_matrix_params(cfg)
    assert (layer, heads) == (67_108_864, 16_777_216)
    # one flash launch at B 2, L 4,096, D 64: operations bound it
    pairs = 2 * 32 * 4096 * 4097 // 2
    assert work.flash_launch_bound_s(cfg, 2, 4096) == pytest.approx(
        4 * 64 * pairs / work.H100_BF16_FLOPS)


def test_ssd_chunk_work_by_hand():
    # B 1, 1 chunk of Q 2, H 1, P 2, N 2: 3 pairs (i, j <= i)
    nbytes, ops, products = work.ssd_chunk_work(1, 1, 2, 1, 2, 2)
    assert products == 2 * 2 * 3 + 2 * 1 * 2 * 3 + 2 * 1 * 2 * 2 * 2
    assert ops == products + 3 * 1 * 3
    assert nbytes == 4 * (2 * 2 * 2 + 2 + 1 + 2 * 2 * 2 + 4 + 1 + 2)


def test_mamba2_forward_flops_by_hand():
    # d_inner 8, heads 4 of P 2, N 2: in_proj 4 x (16 + 4 + 4), out 8 x 4
    layer, head = work.mamba2_matrix_params(TINY_SSM)
    assert (layer, head) == (4 * 24 + 32, 40)
    _, chunk_ops, _ = work.ssd_chunk_work(1, 2, 2, 4, 2, 2)
    assert work.mamba2_forward_flops(TINY_SSM, 1, 4) == \
        2 * (2 * layer + head) * 4 + 2 * (chunk_ops + 2 * 4 * 2 * 2 * 4)


def test_streams_are_the_ports_corpus_walked_side_by_side():
    # the frozen copy gives the port's synthetic_lm_corpus stream for
    # each seed, whether walked alone or beside others
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.data.synthetic import synthetic_lm_corpus

    from portbench import streams
    both = streams.lm_streams(300, 50, [[7], [2**31 + 11]])
    assert (both[0] == synthetic_lm_corpus(300, 50, 7)).all()
    assert (both[1] == synthetic_lm_corpus(300, 50, 2**31 + 11)).all()


def test_score_batches_and_check_rows_follow_the_traffic():
    from portbench import streams
    tr = dict(users=5, positions=6, pool=2, check_users=3)
    a = streams.score_batches(2**33 + 1, tr, 40, 4)
    b = streams.score_batches(2**33 + 1, tr, 40, 4)
    assert len(a) == 2 and a[0]["tokens"].shape == (5, 6, 4)
    assert (a[0]["tokens"][:, 1:] == a[0]["targets"][:, :-1]).all()
    assert all((x["tokens"] == y["tokens"]).all() for x, y in zip(a, b))
    assert not (a[0]["tokens"] == a[1]["tokens"]).all()
    # each codebook of a user is a stream of its own seed
    one = streams.lm_streams(7, 40, [(2**33 + 1, 1, 1, 2, 3)])[0]
    assert (a[1]["tokens"][2, :, 3] == one[:6]).all()
    rows = streams.check_rows(2**33 + 1, tr)
    assert len(rows) == 2
    for r in rows:
        assert len(set(r.tolist())) == 3 and list(r) == sorted(r)
        assert 0 <= r.min() and r.max() < 5
