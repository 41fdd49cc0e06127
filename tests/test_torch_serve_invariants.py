"""The MVServeEngine invariants of ``tests/serve/test_engine.py`` on the
port's engine, for a dense model, local ring caches and a mixture of
experts: snapshot stability under decodes (the descriptor lengths and,
bit for bit, a pinned reader's score), no freed pinned descriptor version,
bounded descriptor space per policy, EBR's growth under a pin, dropped
retires from an undersized ring, and the fork counters of the paged
engine.

Reduced gemma2-2b runs with its window widened to 128 here, so that no
trace wraps its ring: once a ring wraps, a pinned reader's score changes
in both packages (trap C10, ``tests/test_torch_serve.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.telemetry import GCConfig
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import MVServeEngine, PagedKVEngine

ARCHS = {"minitron-4b": {}, "gemma2-2b": {"local_window": 128},
         "granite-moe-1b-a400m": {}}


def mk(arch, policy="slrt", B=4, L=64, V=8, ring_capacity=0):
    cfg = reduced_config(arch, **ARCHS[arch])
    run = RunConfig(model=cfg, shape=SHAPES["decode_32k"], gc_policy=policy,
                    versions_per_slot=V, reader_lanes=4,
                    ring_capacity=ring_capacity)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, MVServeEngine(cfg, run, params, batch=B, max_len=L,
                              dtype=torch.float32, device="cpu")


def prompt(cfg, seed, B=4, T=8):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_snapshot_is_stable_under_decodes(arch):
    """A lane pinned at step k keeps exactly the lengths it saw, and its
    score keeps its bits, after many more decode steps."""
    cfg, e = mk(arch, V=16, L=128)
    e.prefill(prompt(cfg, 1))
    for _ in range(3):
        e.step()
    t = e.pin(lane=0)
    want = e.lengths_at(t).clone()
    cand = e.state.last_tokens.clone()
    score = e.score(cand, t)
    for _ in range(6):
        e.step()
    assert torch.equal(e.lengths_at(t), want), "pinned snapshot changed"
    assert torch.equal(e.score(cand, t), score), "pinned score changed"
    assert int(e.state.cache_len.max()) == 8 + 3 + 6
    e.unpin(0)


@pytest.mark.parametrize("arch", ARCHS)
def test_gc_never_frees_pinned_descriptor_versions(arch):
    cfg, e = mk(arch, V=16, L=128)
    e.prefill(np.ones((4, 4), np.int32))
    t = e.pin(lane=1)
    want = e.lengths_at(t).clone()
    for _ in range(10):
        e.step()      # slrt GC runs inside; the pinned version survives
    assert torch.equal(e.lengths_at(t), want)
    assert e.space()["overflows"] == 0


@pytest.mark.parametrize("policy", ["slrt", "dlrt", "steam", "sweep"])
@pytest.mark.parametrize("arch", ARCHS)
def test_descriptor_space_bounded(arch, policy):
    """With no pins, live descriptor versions stay about one per slot
    under every non-EBR policy across many decode steps."""
    cfg, e = mk(arch, policy=policy, V=8, L=256)
    e.prefill(np.ones((4, 4), np.int32))
    for _ in range(24):
        e.step()
    rep = e.space()
    assert rep["overflows"] == 0, rep
    assert rep["live_versions"] <= 4 * 4, rep   # << 24 steps x 4 seqs


@pytest.mark.parametrize("arch", ARCHS)
def test_ebr_space_grows_with_pin(arch):
    """EBR under a pinned reader keeps every descriptor version; SL-RT
    keeps only the pinned one per sequence."""
    live = {}
    for policy in ("ebr", "slrt"):
        cfg, e = mk(arch, policy=policy, V=32, L=128)
        e.prefill(np.ones((4, 4), np.int32))
        e.pin(lane=0)
        for _ in range(12):
            e.step()
        live[policy] = e.space()["live_versions"]
    assert live["ebr"] >= live["slrt"] + 4 * 6, live


@pytest.mark.parametrize("arch", ARCHS)
def test_snapshot_score_runs(arch):
    cfg, e = mk(arch, V=16, L=64)
    e.prefill(np.ones((4, 6), np.int32))
    e.step()
    t = e.pin(lane=2)
    logits = e.score(np.ones((4, 1), np.int32), t)
    assert tuple(logits.shape) == (4, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_undersized_ring_surfaces_dropped_retires(arch):
    """A retire ring of 2 under a batch of 4 drops at least 2 retires per
    step, and the step stats show it; a ring of the default size drops
    none on the same workload."""
    def run_steps(ring_capacity):
        cfg, e = mk(arch, V=16, L=64, ring_capacity=ring_capacity)
        e.prefill(prompt(cfg, 2))
        for _ in range(6):
            e.step()
        return e.last_stats

    stats = run_steps(2)
    assert "dropped_retires" in stats and "overflow_count" in stats
    assert stats["dropped_retires"] >= 2, stats
    assert run_steps(0)["dropped_retires"] == 0


def test_fork_counters_dormant_zero_then_exact():
    """A fork-free decode run reports 0 forks; fork, join and release
    report exact op counts, and a masked-out lane never counts."""
    e = PagedKVEngine(4, 16, 4, 4, 1, 4,
                      gc=GCConfig(policy="slrt", versions_per_slot=8,
                                  reader_lanes=2), device="cpu")
    ids = torch.arange(4, dtype=torch.int32)
    kv = torch.ones((4, 1, 4))
    for _ in range(4):
        e.step(ids, kv, kv, torch.ones((4,), dtype=torch.bool))
    assert (e.forks, e.joins, e.releases) == (0, 0, 0)
    assert e.space()["forks"] == 0
    failed = e.fork(torch.tensor([0, 1, 0], dtype=torch.int32),
                    torch.tensor([2, 3, 3], dtype=torch.int32),
                    torch.tensor([True, True, False]))
    assert not bool(torch.as_tensor(failed)[:2].any())
    assert e.forks == 2
    assert set(e.dag.nodes) == {2, 3}
    e.join(torch.tensor([2], dtype=torch.int32),
           torch.tensor([0], dtype=torch.int32),
           torch.ones((1,), dtype=torch.bool))
    e.release(torch.tensor([3], dtype=torch.int32),
              torch.ones((1,), dtype=torch.bool))
    assert (e.forks, e.joins, e.releases) == (2, 1, 1)
    sp = e.space()
    assert (sp["forks"], sp["joins"], sp["releases"]) == (2, 1, 1)
    assert not e.dag.nodes
