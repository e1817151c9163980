"""Standalone probability distributions (ref: fl/distribution/*).

Port of ``dbot_ros_tpu/models/distributions.py``: plain function families
``<name>_logpdf / <name>_sample`` plus the particle-belief moments and
the Monte Carlo transform. Everything is batched float32. A sampler takes
its noise as an argument (``eps``, ``u``) or draws it from ``generator``;
the JAX package's PRNG keys have no torch counterpart.
"""

from __future__ import annotations

import math

import torch

from dbot_ros_tpu_torch.ops.resample import (kl_to_uniform,
                                             normalize_log_weights)

_LOG_SQRT2PI = 0.9189385332046727  # log sqrt(2*pi)


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ------------------------------------------------------------- Gaussian

def gaussian_logpdf(x, mean, cov):
    """Multivariate normal log-density; x, mean [..., D], cov [..., D, D]."""
    d = x - mean
    chol = torch.linalg.cholesky(cov)
    sol = torch.linalg.solve_triangular(chol, d[..., None], upper=False)
    maha = torch.sum(sol[..., 0] ** 2, dim=-1)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    k = x.shape[-1]
    return -0.5 * (maha + logdet) - k * _LOG_SQRT2PI


def gaussian_sample(mean, cov, shape=(), eps=None, generator=None):
    """``mean + L eps`` with ``L L^T = cov``; ``eps`` (``shape + mean.shape``
    standard normals) is drawn from ``generator`` when not given."""
    chol = torch.linalg.cholesky(cov)
    if eps is None:
        eps = torch.randn(tuple(shape) + tuple(mean.shape),
                          generator=generator, dtype=mean.dtype,
                          device=mean.device)
    return mean + torch.einsum("...ij,...j->...i", chol, eps)


def standard_gaussian_sample(dim, shape=(), generator=None, device=None):
    """ref: StandardGaussian, the unit-normal sampler feeding models."""
    return torch.randn(tuple(shape) + (dim,), generator=generator,
                       dtype=torch.float32, device=device)


# --------------------------------------------------- truncated Gaussian

def _norm_cdf(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def truncated_gaussian_logpdf(x, mean, sigma, lo, hi):
    """ref: TruncatedGaussian (Evaluation)."""
    x = _f32(x)
    mean, sigma, lo, hi = (_f32(v, x.device) for v in (mean, sigma, lo, hi))
    z = (x - mean) / sigma
    log_body = -0.5 * z * z - torch.log(sigma) - _LOG_SQRT2PI
    norm = _norm_cdf((hi - mean) / sigma) - _norm_cdf((lo - mean) / sigma)
    inside = (x >= lo) & (x <= hi)
    return torch.where(
        inside, log_body - torch.log(torch.clamp_min(norm, 1e-12)),
        -math.inf)


def truncated_gaussian_sample(mean, sigma, lo, hi, shape=(), u=None,
                              generator=None, device=None):
    """Inverse-CDF sampling (exact, vectorized); ``u`` uniforms in [0, 1)
    of ``shape`` are drawn from ``generator`` when not given."""
    mean, sigma, lo, hi = (_f32(v, device) for v in (mean, sigma, lo, hi))
    a = _norm_cdf((lo - mean) / sigma)
    b = _norm_cdf((hi - mean) / sigma)
    if u is None:
        u = torch.rand(tuple(shape), generator=generator,
                       device=mean.device)
    p = a + u * (b - a)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    return torch.minimum(torch.maximum(mean + sigma * z, lo), hi)


# ------------------------------------------------------------- uniform

def uniform_logpdf(x, lo, hi):
    x = _f32(x)
    lo, hi = (_f32(v, x.device) for v in (lo, hi))
    inside = (x >= lo) & (x <= hi)
    return torch.where(inside, -torch.log(hi - lo), -math.inf)


def uniform_sample(lo, hi, shape=(), generator=None, device=None):
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return lo + (hi - lo) * u


# --------------------------------------------------------- exponential

def exponential_logpdf(x, rate, lo=0.0, hi=math.inf):
    """Optionally truncated exponential (the beam model's occluder
    prior)."""
    x = _f32(x)
    rate, lo = (_f32(v, x.device) for v in (rate, lo))
    if hi != math.inf:
        norm = 1.0 - torch.exp(-rate * (_f32(hi, x.device) - lo))
    else:
        norm = _f32(1.0, x.device)
    inside = (x >= lo) & (x <= hi)
    return torch.where(
        inside,
        torch.log(rate) - rate * (x - lo)
        - torch.log(torch.clamp_min(norm, 1e-12)),
        -math.inf)


def exponential_sample(rate, shape=(), generator=None, device=None):
    e = torch.empty(tuple(shape), device=device).exponential_(
        generator=generator)
    return e / rate


def cauchy_logpdf(x, loc=0.0, scale=1.0):
    """Cauchy log-density (the heavy-tail option of the body-tail
    observation model)."""
    x = _f32(x)
    loc, scale = (_f32(v, x.device) for v in (loc, scale))
    z = (x - loc) / scale
    return -torch.log(math.pi * scale * (1.0 + z * z))


def cauchy_sample(loc=0.0, scale=1.0, shape=(), generator=None,
                  device=None):
    c = torch.empty(tuple(shape), device=device).cauchy_(
        generator=generator)
    return loc + scale * c


# ------------------------------------------ discrete / particle beliefs

def discrete_entropy(log_w):
    """ref: DiscreteDistribution::entropy (normalized weights)."""
    ln, _ = normalize_log_weights(log_w)
    w = torch.exp(ln)
    return -torch.sum(w * torch.where(w > 0, ln, 0.0), dim=-1)


def discrete_kl_to_uniform(log_w):
    return kl_to_uniform(log_w)


def discrete_sample(log_w, shape=(), generator=None):
    """Categorical sampling (ref: DiscreteDistribution sampling): indices
    of ``shape``, whose trailing axes are ``log_w``'s batch axes."""
    shape = tuple(shape)
    batch = tuple(log_w.shape[:-1])
    if shape[len(shape) - len(batch):] != batch:
        raise ValueError(f"shape {shape} must end with the batch shape "
                         f"{batch}")
    n = math.prod(shape[:len(shape) - len(batch)])
    probs = torch.softmax(log_w.reshape(-1, log_w.shape[-1]), dim=-1)
    idx = torch.multinomial(probs, n, replacement=True,
                            generator=generator)          # (B, n)
    return idx.T.reshape(shape)


def sum_of_deltas_moments(particles, log_w):
    """Weighted particle mean and covariance in Euclidean coordinates
    (ref: SumOfDeltas). For SE(3) states use ``se3.states_mean``."""
    ln, _ = normalize_log_weights(log_w)
    w = torch.exp(ln)
    mean = torch.einsum("p,p...->...", w, particles)
    c = particles - mean
    cov = torch.einsum("p,pi,pj->ij", w, c, c)
    return mean, cov


# ------------------------------------------------- Monte Carlo transform

def monte_carlo_transform(fn, mean, cov, num_samples: int = 256, eps=None,
                          generator=None):
    """ref: fl MonteCarloTransform: propagate a Gaussian through ``fn`` by
    sampling → (mean_y, cov_yy, cov_xy). ``eps`` (num_samples, D) standard
    normals, else drawn from ``generator``."""
    x = gaussian_sample(mean, cov, (num_samples,), eps=eps,
                        generator=generator)
    y = torch.func.vmap(fn)(x)
    my = torch.mean(y, dim=0)
    cy = y - my
    cx = x - mean
    cov_yy = torch.einsum("pi,pj->ij", cy, cy) / num_samples
    cov_xy = torch.einsum("pi,pj->ij", cx, cy) / num_samples
    return my, cov_yy, cov_xy
