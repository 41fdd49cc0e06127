"""K4's host-side split plan (``decode_attention.ops.split_plan``).

The split-KV kernel runs one block per (sequence, kv head, split); the
plan decides the number of splits from the batch, the heads, the page
table's width and the SM count alone (never from the lengths, which stay on
the card).  The kernel itself is held against its plain version on the
card (``tests/test_torch_gpu.py``)."""
import pytest

from repro_torch.kernels.decode_attention import ops

SMS = 132   # the H100 SXM


@pytest.mark.parametrize("B,Hq,Hkv,PS,MP", [
    (256, 24, 8, 16, 256),   # phase 5 of chip_smoke: minitron-4b, 4096
    (16, 24, 8, 16, 256),
    (1, 24, 8, 16, 256),
    (7, 6, 2, 8, 64),
    (3, 4, 4, 4, 64),
    (1, 1, 1, 4, 3),
    (64, 32, 1, 1, 2048),    # MQA: 32 query heads in 4 groups of 8
    (1000, 8, 8, 16, 8),
    (2, 8, 2, 256, 4),       # pages larger than a split's token budget
    (5, 3, 3, 16, 1),
])
def test_split_plan(B, Hq, Hkv, PS, MP):
    n = ops.split_plan(B, Hq, Hkv, PS, MP, SMS)
    chunk = -(-MP // n)
    assert 1 <= n <= MP
    assert (n - 1) * chunk < MP, "an empty trailing split"
    blocks = B * Hkv * -(-(Hq // Hkv) // ops.MAX_GROUP)
    wave = ops.RESIDENT_BLOCKS_PER_SM * SMS
    # at least one wave of blocks, unless every split is one page
    assert blocks * n >= wave / 2 or chunk == 1
    # a batch of several waves keeps its splits near the token budget
    if blocks * -(-MP // max(1, ops.MAX_SPLIT_TOKENS // PS)) >= 4 * wave:
        assert chunk * PS <= 2 * max(PS, ops.MAX_SPLIT_TOKENS)


def test_split_plan_at_the_serving_shapes():
    """phase 5's batch splits 4096 tokens in 4 chunks of 1024; a batch of
    16 in 3 (128 x 3 = 384 blocks, one wave of 3 per SM; 4 would leave a
    second wave part-filled); a batch of one in 43 chunks of 6 pages (one
    wave is 8 x 50 blocks)."""
    assert ops.split_plan(256, 24, 8, 16, 256, SMS) == 4
    assert ops.split_plan(16, 24, 8, 16, 256, SMS) == 3
    assert ops.split_plan(1, 24, 8, 16, 256, SMS) == 43
    assert ops.split_plan(4, 24, 8, 16, 0, SMS) == 1
