"""Deterministic, host-sharded, restart-safe synthetic LM data pipeline.

Fault-tolerance requirement: after a crash/restart (or an elastic rescale to
a different host count), the pipeline must reproduce exactly the batch for
any given step.  We therefore derive every batch *functionally* from
``(seed, step, host)`` with a counter-based Philox generator — no iterator
state exists to lose.  Tokens follow a Zipfian marginal with short-range
Markov structure so the LM loss actually decreases during the examples.

Own copy of ``repro.data.pipeline`` (numpy only): the same config and
step give the reference's batch byte for byte.  The reference's
``batch_specs`` (dry-run input stand-ins) comes with ROADMAP queue 1:
dry-run and roofline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLMDataset"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2


class SyntheticLMDataset:
    """batch_at(step) -> {"tokens": (B_host, S) i32, "labels": ...}."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.n_hosts
        # fixed per-seed "bigram" permutation for Markov structure
        perm_rng = np.random.Generator(np.random.Philox(key=cfg.seed))
        self._perm = perm_rng.permutation(cfg.vocab_size)

    def _rng_for(self, step: int) -> np.random.Generator:
        c = self.cfg
        key = (c.seed, step, c.host_id)
        return np.random.Generator(np.random.Philox(key=np.uint64(
            (key[0] * 1_000_003 + key[1]) * 1_000_003 + key[2])))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = self._rng_for(step)
        B, S = self.host_batch, c.seq_len
        # zipf marginal, clipped into vocab
        base = rng.zipf(c.zipf_a, size=(B, S + 1)) % c.vocab_size
        # Markov structure: with p=0.5 the next token is perm[prev]
        follow = rng.random((B, S)) < 0.5
        seq = base.copy()
        for t in range(1, S + 1):
            seq[:, t] = np.where(follow[:, t - 1],
                                 self._perm[seq[:, t - 1]], base[:, t])
        tokens = seq[:, :S].astype(np.int32)
        labels = seq[:, 1:S + 1].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
