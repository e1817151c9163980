"""Belief checkpoint / resume.

Port of ``dbot_ros_tpu/runtime/checkpoint.py``: a belief (particles,
weights and occlusion leaf, or Gaussian moments, background map and
occlusion memory) serializes to one ``.npz`` in the reference's format:
one entry per field, an optional field that is None left out
(``occ_prior``), a multi-leaf field (the fused sensor's lazy ``(q, age)``
occlusion tuple) as ``name__i``, and a bfloat16 array as a bit-exact
uint16 view under ``name__bf16``. The port's beliefs carry no random
key; a particle tracker's generator state is saved beside the belief
(``generator_state``) so a resumed run continues the same stream.

For checkpoints written by the JAX package see
``interop.checkpoint_from_jax``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dbot_ros_tpu_torch.filters.rbcpf import ParticleBelief
from dbot_ros_tpu_torch.filters.rgf import GaussianBelief

_BF16 = "__bf16"
_KINDS = {"particle": ParticleBelief, "gaussian": GaussianBelief}


def _encode(t: torch.Tensor):
    """npz-safe ndarray: numpy has no bfloat16, so it round-trips as a
    bit-exact uint16 view plus a name tag."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    return t.numpy(), ""


def _decode(name, data, device):
    if name + _BF16 in data:
        bits = np.ascontiguousarray(data[name + _BF16]).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    if name in data:
        return torch.from_numpy(np.ascontiguousarray(data[name])).to(device)
    return None


def save_belief(path: str, belief, generator=None) -> None:
    """Write ``belief`` (and the state of ``generator``, if given)."""
    kinds = [k for k, cls in _KINDS.items() if isinstance(belief, cls)]
    if not kinds:
        raise TypeError(f"unknown belief type {type(belief)!r}")
    arrays = {}
    for f in dataclasses.fields(belief):
        v = getattr(belief, f.name)
        if v is None:
            continue                      # optional field (occ_prior)
        if isinstance(v, (tuple, list)):
            for i, leaf in enumerate(v):
                arr, tag = _encode(leaf)
                arrays[f"{f.name}__{i}{tag}"] = arr
        else:
            arr, tag = _encode(v)
            arrays[f.name + tag] = arr
    if generator is not None:
        arrays["generator_state"] = generator.get_state().cpu().numpy()
    np.savez(path, __kind__=np.array(kinds[0]), **arrays)


def load_belief(path: str, device=None, generator=None):
    """Read a belief onto ``device`` (default: the CPU). With
    ``generator``, its state is restored from the file when the file has
    one (a generator on another kind of device than the saved one keeps
    its own state)."""
    data = np.load(path, allow_pickle=False)
    kind = str(data["__kind__"])
    if kind not in _KINDS:
        raise ValueError(f"unknown belief kind {kind!r}")
    cls = _KINDS[kind]
    kwargs = {}
    for f in dataclasses.fields(cls):
        arr = _decode(f.name, data, device)
        if arr is None:
            leaves = []
            while True:
                leaf = _decode(f"{f.name}__{len(leaves)}", data, device)
                if leaf is None:
                    break
                leaves.append(leaf)
            if not leaves:
                if f.default is None:
                    continue             # optional field left at default
                raise KeyError(f"checkpoint missing field {f.name!r}")
            arr = tuple(leaves)
        kwargs[f.name] = arr
    if generator is not None and "generator_state" in data:
        state = torch.from_numpy(np.ascontiguousarray(
            data["generator_state"]))
        if state.numel() == generator.get_state().numel():
            generator.set_state(state)
    return cls(**kwargs)
