"""Deterministic data pipelines, generated with numpy from a seed.

Determinism by step is the fault-tolerance contract: ``batch_at(step)`` is
a pure function of (seed, step, shard), so a restarted worker replays
exactly the batch it crashed on — no data-loader state in checkpoints
beyond the step count.

* :class:`TokenStream` — the reference's synthetic LM corpus
  (``repro.data.pipeline.TokenStream``): a Zipf-like marginal (u³ of a
  uniform, scaled to the vocabulary and clipped into it) with learnable
  bigram structure (each token flips, with probability ½, to
  ``(previous · 2 + 1) % vocab`` of the unflipped stream rolled by one).
  The construction is the reference's; the draws are not: it keys
  ``jax.random`` (threefry, ``fold_in(seed, step)``, ``fold_in(shard)``),
  which the port cannot import, and this stream keys a numpy generator on
  (seed, step, shard).  So the tokens differ from the reference's bits
  (ROADMAP Queue C); a test that holds training against the reference
  feeds both packages the same numpy batches.  Tokens are int32 numpy
  arrays on the host, the same on any machine; the driver moves them to
  the device.
* :class:`RegressionStream` — the reference's GP regression generator
  line for line; it returns numpy arrays, which every port entry point
  takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0

    def batch_at(self, step: int) -> dict:
        """{"tokens": int32 (batch // num_shards, seq_len + 1)} for ``step``
        (this shard's slice of the global batch when num_shards > 1)."""
        rng = np.random.default_rng([self.seed, step, self.shard])
        b = self.batch // self.num_shards
        # zipf-ish marginal via exponentiated uniforms, in f32 as the reference
        u = rng.uniform(1e-6, 1.0, (b, self.seq_len + 1)).astype(np.float32)
        toks = np.clip((self.vocab_size * (u**3)).astype(np.int32), 0, self.vocab_size - 1)
        # inject learnable bigram structure: token 2i+1 follows 2i
        flip = rng.random(toks.shape) < 0.5
        prev = np.roll(toks, 1, axis=1)
        structured = np.where(flip, (prev * 2 + 1) % self.vocab_size, toks)
        return {"tokens": structured.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class RegressionStream:
    """Synthetic UCI-like GP regression tasks with controllable size/dim."""

    n: int
    d: int
    seed: int = 0
    noise: float = 0.1
    kind: str = "smooth"  # smooth | multiscale | discontinuous

    def dataset(self):
        rng = np.random.default_rng(self.seed)
        X = rng.uniform(0.0, 1.0, (self.n, self.d)).astype(np.float32)
        w = rng.normal(size=(self.d,)).astype(np.float32)
        proj = X @ w
        if self.kind == "smooth":
            y = np.sin(4.0 * proj) + 0.4 * np.cos(7.0 * X[:, 0])
        elif self.kind == "multiscale":
            y = np.sin(3.0 * proj) + 0.3 * np.sin(25.0 * proj)
        else:
            y = np.sign(np.sin(5.0 * proj)) * np.abs(proj)
        y = y + self.noise * rng.normal(size=(self.n,)).astype(np.float32)
        y = (y - y.mean()) / y.std()
        return X, y

    def split(self, train_frac=0.9):
        X, y = self.dataset()
        n_tr = int(self.n * train_frac)
        return (X[:n_tr], y[:n_tr]), (X[n_tr:], y[n_tr:])
