"""Generic sequential-importance-resampling particle filter.

Port of ``dbot_ros_tpu/filters/pf.py`` (ref: fl/filter/particle/
particle_filter.hpp): the vanilla SIR PF over a tensor or a tree (tuple,
list, dict) of tensors with a leading particle axis, kept for the
reference library's surface (the tracker uses the Rao-Blackwellized
coordinate variant in ``filters/rbcpf.py``). The belief carries no
random key: ``propagate`` owns its noise, and the resampling uniform is
passed in (``u``) or drawn from ``generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from dbot_ros_tpu_torch.ops import resample as rs


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"particles must be tensors, got {type(tree)!r}")


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else tree
    return _first_leaf(next(iter(values)))


@dataclasses.dataclass(frozen=True)
class SirBelief:
    particles: Any              # (P, ...) tensor or a tree of them
    log_weights: torch.Tensor   # (P,)


def init(particles) -> SirBelief:
    leaf = _first_leaf(particles)
    return SirBelief(particles=particles,
                     log_weights=torch.zeros(leaf.shape[0],
                                             device=leaf.device))


def step(belief: SirBelief, obs, propagate: Callable, loglik: Callable,
         ess_threshold: float = 0.5, u=None, generator=None) -> SirBelief:
    """One SIR step: propagate → weight → ESS-triggered resample.

    ``propagate(particles) → particles``; ``loglik(particles, obs) →
    (P,)``. Systematic resampling with the uniform ``u`` (drawn from
    ``generator`` when not given) runs where the ESS falls under
    ``ess_threshold · P``; without a host read, the identity is gathered
    otherwise, as in the reference.
    """
    particles = propagate(belief.particles)
    log_w = belief.log_weights + loglik(particles, obs)
    p = log_w.shape[0]
    ess = rs.effective_sample_size(log_w)
    do = ess < ess_threshold * p
    idx = torch.where(do, rs.systematic_indices(log_w, p, u=u,
                                                generator=generator),
                      torch.arange(p, device=log_w.device))
    particles = _tree_map(lambda x: x[idx], particles)
    log_w = torch.where(do, torch.zeros_like(log_w), log_w)
    return SirBelief(particles=particles, log_weights=log_w)


def mean(belief: SirBelief):
    ln, _ = rs.normalize_log_weights(belief.log_weights)
    w = torch.exp(ln)
    return _tree_map(lambda x: torch.einsum("p,p...->...", w, x),
                     belief.particles)
