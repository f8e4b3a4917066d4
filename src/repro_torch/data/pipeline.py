"""Synthetic GP regression tasks, generated with numpy from a seed.

:class:`RegressionStream` is the reference's generator
(``repro.data.pipeline.RegressionStream``) line for line; it returns
numpy arrays, which every port entry point takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
