"""The checkpoint safety and liveness pair through a crash
(``tests/ckpt/test_recovery.py``), replayed on the port's
``PagedKVEngine`` at that file's sizes.

* After ``restore``, a forced reclaim evicts the sequences idle since the
  checkpoint whose only version it holds (``stats.ckpt_freed > 0``,
  ``ckpt_evictions`` counted), while the active sequences keep every
  byte; the same run without a checkpoint frees none of those pages.  The
  port's reclaim counters after the restored run equal the JAX engine's
  on the same trace.
* The evicted sequences come back byte for byte from the checkpoint."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.core.telemetry import GCConfig as JGC
from repro.serve.engine import PagedKVEngine as JEngine

from repro_torch.core.telemetry import GCConfig
from repro_torch.serve import forking
from repro_torch.serve.engine import PagedKVEngine

B, PAGES, PS, MP, V = 8, 20, 4, 6, 8
IDLE = 5          # sequences 0..4 go idle after the warmup; 5..7 decode on
KV_HEADS, HEAD_DIM = 1, 4
NOW = 2**31 - 2


def mk(policy="slrt") -> PagedKVEngine:
    return PagedKVEngine(
        B, PAGES, PS, MP, KV_HEADS, HEAD_DIM,
        gc=GCConfig(policy=policy, versions_per_slot=V, reader_lanes=4,
                    hot_k=B),
        dtype=torch.float32, device="cpu")


def mk_jax(policy="slrt") -> JEngine:
    return JEngine(
        B, PAGES, PS, MP, KV_HEADS, HEAD_DIM,
        gc=JGC(policy=policy, versions_per_slot=V, reader_lanes=4, hot_k=B),
        dtype=jnp.float32)


def step(eng, mask, val):
    """One decode step, each (step, sequence) its own value, so that a
    recycled page changes content."""
    base = np.arange(B, dtype=np.float32) + B * val
    kv = np.ascontiguousarray(np.broadcast_to(
        base[:, None, None], (B, KV_HEADS, HEAD_DIM)))
    if isinstance(eng, JEngine):
        return np.asarray(eng.step(jnp.arange(B, dtype=jnp.int32),
                                   jnp.asarray(kv), jnp.asarray(kv),
                                   jnp.asarray(mask)))
    return eng.step(torch.arange(B, dtype=torch.int32), torch.from_numpy(kv),
                    torch.from_numpy(kv), torch.from_numpy(mask)).numpy()


def current_sig(eng, seqs):
    """Each named sequence's current length and visible values."""
    tbl, ln = (x.numpy() for x in eng.view_at(NOW))
    return tuple((int(ln[s]),) + forking.prefix_values(eng.st, tbl[s],
                                                       int(ln[s]))
                 for s in seqs)


def warmup(eng, steps=8):
    every = np.ones(B, bool)
    for i in range(steps):
        assert not step(eng, every, i + 1).any()


def active_mask():
    m = np.zeros(B, bool)
    m[IDLE:] = True
    return m


def test_restore_then_reclaim_frees_checkpointed_only(tmp_path):
    """``test_restore_then_reclaim_frees_checkpointed_only``: the pair
    through a crash, and the port's counters equal JAX's."""
    eng = mk()
    warmup(eng)
    eng.checkpoint(tmp_path / "port")
    del eng                                    # the crash, after the save

    eng = mk()
    eng.restore(tmp_path / "port")
    assert eng.ckpt_max >= 0
    live_before = int(eng.space()["live_pages"])
    step(eng, active_mask(), 100)              # active ones pass ckpt_max
    want_active = current_sig(eng, range(IDLE, B))
    eng.reclaim(B * V)
    assert eng.stats.ckpt_evictions >= IDLE
    assert eng.stats.ckpt_freed > 0
    assert int(eng.space()["live_pages"]) < live_before
    _, ln = eng.view_at(NOW)
    assert int(ln[:IDLE].sum()) == 0, "an idle sole survivor was kept"
    assert current_sig(eng, range(IDLE, B)) == want_active
    ok, leaked, premature = forking.check_no_leak(eng.st)
    assert ok, (leaked, premature)

    # the same through the JAX engine: the same decisions, counted alike
    jeng = mk_jax()
    warmup(jeng)
    jeng.checkpoint(tmp_path / "jax")
    jeng = mk_jax()
    jeng.restore(tmp_path / "jax")
    step(jeng, active_mask(), 100)
    jeng.reclaim(B * V)
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(jeng.stats)
    assert int(eng.space()["live_pages"]) == int(jeng.space()["live_pages"])

    # control: no checkpoint, so none of those pages can go
    ctl = mk()
    warmup(ctl)
    step(ctl, active_mask(), 100)
    ctl.reclaim(B * V)
    assert ctl.stats.ckpt_freed == 0 and ctl.stats.ckpt_evictions == 0
    _, ln = ctl.view_at(NOW)
    assert int(ln[:IDLE].sum()) > 0, "idle current versions must stay"
    assert int(ctl.space()["live_pages"]) > int(eng.space()["live_pages"])


@pytest.mark.parametrize("policy", ["slrt", "ebr"])
def test_evicted_sequences_restorable_from_checkpoint(tmp_path, policy):
    """``test_evicted_sequences_restorable_from_checkpoint`` (slrt, and
    ebr as well): after the idle sole survivors are evicted, restoring the
    checkpoint brings back their bytes exactly."""
    eng = mk(policy)
    warmup(eng)
    want_idle = current_sig(eng, range(IDLE))
    eng.checkpoint(tmp_path)
    step(eng, active_mask(), 100)
    eng.reclaim(B * V)
    assert eng.stats.ckpt_freed > 0
    _, ln = eng.view_at(NOW)
    assert int(ln[:IDLE].sum()) == 0, "the idle views are not gone"
    eng.restore(tmp_path)
    assert current_sig(eng, range(IDLE)) == want_idle
