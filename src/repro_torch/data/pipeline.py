"""Deterministic synthetic token pipeline (a copy of
``repro.data.pipeline``: numpy only, and not imported, since importing the
JAX package imports JAX).

A learnable synthetic language (Zipfian unigrams plus a copy structure
every ``copy_period`` tokens), so training shows a falling loss without any
dataset.  Every batch is a pure function of ``(seed, step)``: a restart
resumes bit-exactly from the step counter alone, and each data shard
slices the same global batch by its shard index.  The batches are numpy
arrays, bit-equal to the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2
    copy_period: int = 16    # induction structure: token repeats every period


class SyntheticLM:
    """Iterator over {tokens, loss_mask}; state = step counter only."""

    def __init__(self, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.step = step
        # fixed Zipfian unigram table
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks**cfg.zipf_a
        self._p = p / p.sum()
        self._perm = rng.permutation(cfg.vocab_size)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        base = rng.choice(cfg.vocab_size, size=(cfg.global_batch, cfg.seq_len),
                          p=self._p)
        base = self._perm[base]
        # copy structure: second half of each period repeats the first half
        t = np.arange(cfg.seq_len)
        half = cfg.copy_period // 2
        src = (t // cfg.copy_period) * cfg.copy_period + (t % half)
        copy_pos = (t % cfg.copy_period) >= half
        tokens = np.where(copy_pos[None, :], base[:, src], base)
        return {
            "tokens": tokens.astype(np.int32),
            "loss_mask": np.ones_like(tokens, np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step}

    def load_state_dict(self, s: Dict) -> None:
        self.step = int(s["step"])

    # -- per-host shard view ---------------------------------------------------
    def shard_batch(self, batch: Dict[str, np.ndarray], shard: int,
                    num_shards: int) -> Dict[str, np.ndarray]:
        n = self.cfg.global_batch // num_shards
        return {k: v[shard * n:(shard + 1) * n] for k, v in batch.items()}
