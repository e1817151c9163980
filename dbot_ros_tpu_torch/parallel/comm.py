"""The collectives of the distributed particle filter, over one
``torch.distributed`` process group.

The reference runs its filter under ``shard_map`` and names its
collectives by mesh axis (``psum``, ``pmax``, ``all_gather``,
``ppermute``; dbot_ros_tpu/parallel/dist_filter.py). Here each rank is a
process holding its block of particles, and :class:`Comm` gives those
four calls over a group:

* ``all_gather(t, tiled=False)``: every rank's ``t`` stacked on a new
  leading axis (``tiled``: concatenated along axis 0);
* ``all_reduce(t, op)``: elementwise ``"sum"`` or ``"max"``;
* ``ppermute(t, pairs)``: rank ``src`` sends to ``dst`` for each
  ``(src, dst)``; a rank no one sends to gets zeros. All sends and
  receives of one call go out as one ``batch_isend_irecv``.

Moves are bit-exact: ``all_gather`` and ``ppermute`` carry every tensor
as its raw bytes (a ``uint8`` view), so a bfloat16 map crosses gloo and
NCCL alike (gloo's all-gather refuses ``int16``, the view a bfloat16 map
would otherwise take). ``all_reduce`` works on values.

Transport: NCCL for CUDA tensors and gloo for CPU tensors, as the group's
backend says. A group that the caller creates with ``backend="gloo"`` may
still carry CUDA tensors: then each collective copies them into pinned
host buffers and back, explicitly (``staged`` is True, and
``staging_seconds`` sums the time of those copies). That is how two
ranks that share one card exchange; it is never a fallback from a
failed NCCL start, which raises.

Every group gets a timeout (:func:`init_process_group`, :func:`new_group`),
so a rank that skips a collective makes its peers fail, not hang.
``bytes_sent`` counts, per call kind, the payload bytes this rank's
tensors carried to the other ranks.
"""

from __future__ import annotations

import datetime
import socket
import time

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 60.0


def free_port() -> int:
    """A free TCP port on localhost for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(backend: str, rank: int, world_size: int,
                       port: int, timeout_s: float = DEFAULT_TIMEOUT_S,
                       device=None):
    """Start the default group at ``tcp://localhost:port`` and return its
    :class:`Comm`. With NCCL, ``device`` is the rank's card (default: the
    current one); one all-reduce there starts the communicator, so a
    failed NCCL start raises here, not in the first step."""
    if backend == "nccl":
        device = torch.device("cuda" if device is None else device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    comm = Comm()
    if backend == "nccl":
        comm.all_reduce(torch.ones((1,), device=device))
        torch.cuda.synchronize(device)
    return comm


def new_group(ranks, timeout_s: float = DEFAULT_TIMEOUT_S):
    """A subgroup of the default group's ``ranks`` with its own timeout.
    Every rank of the default group must call this, in the same order;
    a rank outside ``ranks`` gets None."""
    ranks = sorted(int(r) for r in ranks)
    group = dist.new_group(ranks,
                           timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_rank() not in ranks:
        return None
    return Comm(group)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(raw: torch.Tensor, like: torch.Tensor, shape):
    return raw.view(like.dtype).reshape(shape)


class Comm:
    """One process group's collectives (None: the default group)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self._global = [dist.get_global_rank(group, r) if group is not None
                        else r for r in range(self.size)]
        self.staging_seconds = 0.0
        self.bytes_sent = {"all_gather": 0, "all_reduce": 0, "ppermute": 0}

    def staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through pinned host buffers: a CUDA tensor
        on a gloo group."""
        return t.is_cuda and self.backend == "gloo"

    def _to_wire(self, t):
        if not self.staged(t):
            return t
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.staging_seconds += time.perf_counter() - t0
        return host

    def _from_wire(self, t, device):
        if t.device == device:
            return t
        t0 = time.perf_counter()
        out = t.to(device, non_blocking=False)
        self.staging_seconds += time.perf_counter() - t0
        return out

    def _empty_wire(self, shape, dtype, like):
        if self.staged(like):
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=like.device)

    def all_gather(self, t: torch.Tensor, tiled: bool = False):
        """Every rank's ``t`` (same shape and dtype on all): stacked
        ``(size, *t.shape)``, or with ``tiled`` concatenated along axis
        0."""
        raw = _as_bytes(t)
        parts = [self._empty_wire((raw.numel(),), torch.uint8, t)
                 for _ in range(self.size)]
        dist.all_gather(parts, self._to_wire(raw), group=self.group)
        self.bytes_sent["all_gather"] += raw.numel() * (self.size - 1)
        out = self._from_wire(torch.stack(parts), t.device)
        shape = (self.size,) + tuple(t.shape)
        res = _from_bytes(out, t, shape)
        if tiled:
            res = res.reshape((self.size * t.shape[0],) + tuple(t.shape[1:]))
        return res

    def all_reduce(self, t: torch.Tensor, op: str = "sum"):
        """Elementwise sum or max over the ranks (a new tensor)."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        wire = self._to_wire(t)
        wire = wire.clone() if wire is t else wire
        dist.all_reduce(wire, op=ops[op], group=self.group)
        self.bytes_sent["all_reduce"] += (wire.numel() * wire.element_size()
                                          * (self.size - 1))
        return self._from_wire(wire, t.device)

    def ppermute(self, t: torch.Tensor, pairs):
        """Rank ``src`` sends ``t`` to ``dst`` for every ``(src, dst)`` in
        ``pairs`` (each rank sends and receives at most once, as JAX's
        ``ppermute`` requires); returns what this rank received, zeros
        where no one sends to it."""
        sends = [d for s, d in pairs if s == self.rank]
        recvs = [s for s, d in pairs if d == self.rank]
        if len(sends) > 1 or len(recvs) > 1:
            raise ValueError(f"ppermute: rank {self.rank} would send to "
                             f"{sends} and receive from {recvs}")
        raw = _as_bytes(t)
        if sends == [self.rank]:          # a rank's own block
            return t.clone()
        ops = []
        if sends:
            ops.append(dist.P2POp(dist.isend, self._to_wire(raw),
                                  self._global[sends[0]], self.group))
            self.bytes_sent["ppermute"] += raw.numel()
        got = None
        if recvs:
            got = self._empty_wire((raw.numel(),), torch.uint8, t)
            ops.append(dist.P2POp(dist.irecv, got, self._global[recvs[0]],
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if got is None:
            return torch.zeros_like(t)
        return _from_bytes(self._from_wire(got, t.device), t, t.shape)

    def barrier(self):
        dist.barrier(group=self.group)
