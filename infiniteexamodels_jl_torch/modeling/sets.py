"""Infinite-parameter domains and uncertainty distributions.

Covers the domain kinds exercised by the reference examples: bounded
intervals (examples/hovercraft_example.jl), univariate distributions
(Uniform in examples/pandemic.jl:18), and multivariate normals
(MvNormal in examples/3node_design.jl:17, ESCAPE34/opf.jl:118).
Sampling uses a numpy Generator owned by the model (seed-reproducible,
the analogue of Random.seed! in the reference harness).
"""
from __future__ import annotations

import numpy as np


class IntervalDomain:
    def __init__(self, lo, hi):
        if not (np.isfinite(lo) and np.isfinite(hi) and lo < hi):
            raise ValueError(f"invalid interval [{lo}, {hi}]")
        self.lo = float(lo)
        self.hi = float(hi)

    def grid(self, n):
        return np.linspace(self.lo, self.hi, n)

    def __repr__(self):
        return f"[{self.lo}, {self.hi}]"


class Distribution:
    dim = 1

    def sample(self, rng, n):
        raise NotImplementedError


class UniformDist(Distribution):
    def __init__(self, lo, hi):
        self.lo, self.hi = float(lo), float(hi)

    def sample(self, rng, n):
        return rng.uniform(self.lo, self.hi, size=n)

    def __repr__(self):
        return f"Uniform({self.lo}, {self.hi})"


class NormalDist(Distribution):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = float(mean), float(std)

    def sample(self, rng, n):
        return rng.normal(self.mean, self.std, size=n)

    def __repr__(self):
        return f"Normal({self.mean}, {self.std})"


class MvNormalDist(Distribution):
    def __init__(self, mean, cov):
        self.mean = np.asarray(mean, dtype=np.float64)
        cov = np.asarray(cov, dtype=np.float64)
        if cov.ndim == 1:
            cov = np.diag(cov)
        self.cov = cov
        self.dim = len(self.mean)

    def sample(self, rng, n):
        return rng.multivariate_normal(self.mean, self.cov, size=n)

    def __repr__(self):
        return f"MvNormal(dim={self.dim})"


class ProductDist(Distribution):
    """Independent per-component distributions for a dependent parameter
    vector (the reference's `xi[c in 1:3] ~ Xi[c]`,
    examples/2stage_example.jl:22)."""

    def __init__(self, dists):
        self.dists = list(dists)
        self.dim = len(self.dists)

    def sample(self, rng, n):
        return np.stack([d.sample(rng, n) for d in self.dists], axis=1)


def uniform(lo, hi):
    return UniformDist(lo, hi)


def normal(mean=0.0, std=1.0):
    return NormalDist(mean, std)


def mvnormal(mean, cov):
    return MvNormalDist(mean, cov)
