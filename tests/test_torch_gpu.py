"""The port's CUDA kernels and engine on the card (marker ``gpu``).

Each kernel against its plain PyTorch version on the same CUDA tensors, at
ragged and edge shapes the serving run does not reach, the serve_bench
storm trace on the card against the same trace on the CPU, and the model
engine (``MVServeEngine``) at reduced size on the card against the CPU.  These tests
need a GPU and ``nvcc``; without a card they skip.  Run them on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.convert import to_numpy
from repro_torch.core.telemetry import GCConfig
from repro_torch.kernels.compact import ops as compact_ops
from repro_torch.kernels.compact.ref import compact_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import paged_decode_ref
from repro_torch.kernels.flash_prefill import ops as flash_ops
from repro_torch.kernels.flash_prefill.ref import attention_ref
from repro_torch.kernels.version_search import ops as search_ops
from repro_torch.kernels.version_search.ref import search_gather_ref, search_ref
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import MVServeEngine, PagedKVEngine

pytestmark = pytest.mark.gpu
EMPTY, TS_MAX = -1, 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    return torch.device("cuda")


def slabs(rng, R, V):
    ts = rng.integers(0, 60, (R, V)).astype(np.int32)
    succ = (ts + rng.integers(1, 12, (R, V))).astype(np.int32)
    succ[rng.random((R, V)) < 0.3] = TS_MAX
    free = rng.random((R, V)) < 0.3
    ts[free], succ[free] = EMPTY, TS_MAX
    pay = np.where(free, EMPTY, rng.integers(0, 500, (R, V))).astype(np.int32)
    return ts, succ, pay


@pytest.mark.parametrize("R,V,P", [(1, 1, 1), (257, 5, 3), (1000, 16, 64),
                                   (4096, 8, 3000)])
def test_compact_kernel(cuda, R, V, P):
    rng = np.random.default_rng(R + V + P)
    ts, succ, pay = slabs(rng, R, V)
    ann = np.sort(np.where(rng.random(P) < 0.3, TS_MAX,
                           rng.integers(0, 70, P))).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in
            (ts, succ, pay, rng.random(R) < 0.7, ann)]
    args.append(torch.tensor(40, dtype=torch.int32, device=cuda))
    got = compact_ops.compact(*args)
    want = compact_ref(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,V,B,M", [(3, 1, 1, 1), (40, 8, 77, 33),
                                     (9, 40, 300, 257)])
def test_search_kernels(cuda, S, V, B, M):
    rng = np.random.default_rng(S * V + B)
    ts = np.full((S, V), EMPTY, np.int32)
    for s in range(S):
        n = int(rng.integers(0, V + 1))
        ts[s, rng.permutation(V)[:n]] = rng.permutation(100)[:n]
    pay = np.where(ts == EMPTY, EMPTY, rng.integers(0, 50, (S, V))
                   ).astype(np.int32)
    values = rng.integers(-1, 99, (50, M)).astype(np.int32)
    ids = rng.integers(0, S, B).astype(np.int32)
    t = rng.integers(-1, 110, B).astype(np.int32)
    ts, pay, values, ids, t = (torch.from_numpy(x).to(cuda)
                               for x in (ts, pay, values, ids, t))
    for a, b in zip(search_ops.search(ts, pay, ids, t),
                    search_ref(ts, pay, ids, t)):
        assert torch.equal(a, b)
    for a, b in zip(search_ops.search_gather(ts, pay, values, ids, t),
                    search_gather_ref(ts, pay, values, ids, t)):
        assert torch.equal(a, b)


# both versions sum in float32 in another order; a bf16 output may round to
# the neighbouring bf16 value, one step of 2**-7 relative
DECODE_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
              torch.bfloat16: dict(atol=4e-3, rtol=2**-7)}


def decode_inputs(cuda, dtype, Hq, Hkv, D, PS, MP, B=7, N=64):
    """A snapshot-view-shaped table: distinct pages, -1 past each length,
    row 0 of length 0."""
    rng = np.random.default_rng(Hq + D + PS)
    lengths = rng.integers(0, MP * PS + 1, B).astype(np.int32)
    lengths[0] = 0
    table = np.full((B, MP), -1, np.int32)
    pages = rng.permutation(N)
    cursor = 0
    for b in range(B):
        n = -(-int(lengths[b]) // PS)
        table[b, :n] = pages[cursor:cursor + n]
        cursor += n
    gen = torch.Generator(device=cuda).manual_seed(0)
    kp = torch.randn((N, PS, Hkv, D), generator=gen, device=cuda, dtype=dtype)
    vp = torch.randn((N, PS, Hkv, D), generator=gen, device=cuda, dtype=dtype)
    q = torch.randn((B, Hq, D), generator=gen, device=cuda, dtype=dtype)
    table, lengths = (torch.from_numpy(x).to(cuda) for x in (table, lengths))
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,PS,MP", [(1, 1, 16, 4, 3),
                                            (6, 2, 64, 8, 5),
                                            (24, 8, 128, 16, 9)])
def test_paged_decode_kernel(cuda, dtype, Hq, Hkv, D, PS, MP):
    q, kp, vp, table, lengths = decode_inputs(cuda, dtype, Hq, Hkv, D, PS, MP)
    got = decode_ops.paged_decode(q, kp, vp, table, lengths)
    want = paged_decode_ref(q, kp, vp, table, lengths)
    assert torch.allclose(got.float(), want.float(), **DECODE_TOL[dtype])
    assert bool((got[0] == 0).all())
    assert torch.equal(got, decode_ops.paged_decode(q, kp, vp, table,
                                                    lengths))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_marks_a_corrupt_view_nan(cuda, dtype):
    """A table entry inside the length that names no page (-1 or >= N)
    turns that sequence's output to NaN; the other rows are untouched."""
    q, kp, vp, table, lengths = decode_inputs(cuda, dtype, 6, 2, 64, 8, 5)
    good = decode_ops.paged_decode(q, kp, vp, table, lengths)
    rows = torch.nonzero(lengths > 0).squeeze(1)[:2].tolist()
    assert len(rows) == 2
    bad = table.clone()
    bad[rows[0], 0] = -1
    bad[rows[1], (int(lengths[rows[1]]) - 1) // 8] = kp.shape[0]
    got = decode_ops.paged_decode(q, kp, vp, bad, lengths)
    assert bool(got[rows].isnan().all())
    keep = torch.ones(len(lengths), dtype=torch.bool, device=cuda)
    keep[rows] = False
    assert torch.equal(got[keep], good[keep])


def storm(device, policy):
    B, steps = 8, 60
    eng = PagedKVEngine(B, 24, 4, 3, 1, 4,
                        gc=GCConfig(policy=policy, versions_per_slot=6,
                                    reader_lanes=4),
                        device=device)
    rng = np.random.default_rng(0)
    targets = rng.integers(4, 13, B)
    cur = np.zeros(B, np.int64)
    ids = torch.arange(B, dtype=torch.int32)
    log = []
    for step in range(steps):
        kv = torch.full((B, 1, 4), float(step))
        failed = eng.step(ids, kv, kv, torch.ones(B, dtype=torch.bool))
        cur += ~failed.cpu().numpy()
        done = cur >= targets
        if done.any():
            eng.reset(ids, done)
            cur[done] = 0
        if step % 5 == 0:
            ts = eng.pin(step % 4)
            log.append(to_numpy(eng.view_at(ts)[0]).tolist())
            eng.unpin(step % 4)
        log.append(eng.freed_pages())
    return eng, log


def leaves(x):
    if isinstance(x, tuple):
        return [leaf for v in x for leaf in leaves(v)]
    return [x]


@pytest.mark.parametrize("policy", ["ebr", "steam", "dlrt", "slrt", "sweep"])
def test_engine_on_the_card_matches_the_cpu(cuda, policy):
    g, g_log = storm(cuda, policy)
    c, c_log = storm("cpu", policy)
    assert g_log == c_log
    assert g.space() == c.space()
    for a, b in zip(leaves(to_numpy(g.st)), leaves(to_numpy(c.st)),
                    strict=True):
        np.testing.assert_array_equal(a, b)


# K6 against its plain version within DECODE_TOL: both compute in float32
# and sum in other orders.  A bf16 output may round to the neighbouring
# bf16 value, which rtol = 2**-7 allows (K6's largest bf16 differences on
# an H100 are one such step, above the atol); the float32 cases, at 1e-5,
# are the ones that catch a masking or indexing error
FLASH_CASES = [
    # B, Hq, Hkv, T, S, D, causal, window, softcap
    (2, 24, 8, 256, 256, 128, True, 0, 0.0),     # minitron-4b heads
    (1, 8, 4, 300, 300, 256, True, 64, 50.0),    # gemma2-2b local layer
    (2, 3, 1, 200, 200, 64, True, 0, 0.0),       # ragged T, G = 3
    (2, 2, 2, 77, 77, 16, True, 5, 0.0),         # reduced widths
    (1, 4, 1, 65, 65, 96, False, 0, 30.0),       # non-causal, odd D
    (1, 2, 1, 100, 70, 32, True, 0, 0.0),        # S < T
    (1, 2, 1, 90, 40, 32, True, 8, 0.0),         # rows that see nothing
    (1, 2, 2, 1, 1, 8, True, 0, 0.0),
]


def flash_inputs(cuda, dtype, B, Hq, Hkv, T, S, D, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda, dtype=dtype)
            for shape in ((B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,causal,window,cap", FLASH_CASES)
def test_flash_prefill_kernel(cuda, dtype, B, Hq, Hkv, T, S, D, causal,
                              window, cap):
    q, k, v = flash_inputs(cuda, dtype, B, Hq, Hkv, T, S, D)
    kw = dict(causal=causal, window=window, softcap=cap)
    before = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, **kw)
    assert flash_ops.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.allclose(got.float(), want.float(), **DECODE_TOL[dtype])
    assert torch.equal(got, flash_ops.flash_attention(q, k, v, **kw)), \
        "two calls gave different bits"


def test_flash_prefill_rejects_what_it_cannot_run(cuda):
    q, k, v = flash_inputs(cuda, torch.float32, 1, 2, 1, 8, 8, 16)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(*flash_inputs(cuda, torch.float32, 1, 2, 1,
                                                8, 8, 320))


def test_mv_serve_engine_on_the_card(cuda):
    """Reduced minitron-4b in float32: one K6 launch per layer per prefill,
    logits within 1e-4 of the CPU engine on the same weights, and the
    same GC trace (stats and space) step by step."""
    cfg = reduced_config("minitron-4b")
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                    versions_per_slot=4, reader_lanes=4)
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    def to_cpu(x):
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_cpu(v) for v in x]
        return x.cpu()

    g = MVServeEngine(cfg, run, params, batch=4, max_len=32, device=cuda)
    c = MVServeEngine(cfg, run, to_cpu(params), batch=4, max_len=32,
                      device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    before = flash_ops.flash_attention.launches
    g.prefill(prompt)
    assert flash_ops.flash_attention.launches - before == cfg.num_layers
    c.prefill(prompt)
    cand = c.state.last_tokens
    for i in range(10):
        g.step()
        c.step()
        assert g.last_stats == c.last_stats
        if i == 2:
            ts = g.pin(0)
            assert c.pin(0) == ts
    torch.testing.assert_close(g.score(cand, ts).cpu(), c.score(cand, ts),
                               atol=1e-4, rtol=1e-4)
    assert g.space() == c.space()
    assert flash_ops.flash_attention.launches - before == cfg.num_layers
