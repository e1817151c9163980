"""The distributed particle filter: particles split over the ranks of a
process group, with explicit collectives.

Port of ``dbot_ros_tpu/parallel/dist_filter.py``. The reference runs one
program under ``shard_map`` over a mesh axis; here every rank is a
process that holds one block of ``L = P / S`` particles and calls the
step itself, and the collectives go through :class:`comm.Comm`:

* likelihoods: each rank's own (the sensor runs on its block);
* weight normalization, ESS and the KL trigger: all-reduced partial sums
  (``_global_log_normalizers``);
* systematic resampling: one all-gather of the weights, states and
  running logliks gives every rank the same parents; the parent
  occlusion rows, the O(P·N_pix) move, come by one of four exchanges
  (``"counts"``, ``"neighbor"``, ``"ring"``, ``"all_gather"``), each
  giving the all-gather resampler's result bit for bit;
* the posterior mean: all-reduced sums, the quaternion mean by 12 rounds
  of power iteration on the reduced 4×4 matrix.

:func:`make_island_step` keeps particle resampling on each rank and
exchanges whole blocks only when the islands' weights degenerate.
:func:`make_multi_scene_step` runs independent scenes, ranks laid out
scene-major, each scene's particles over its own subgroup.

**Collective order.** Every rank of a group runs the same collectives in
the same order, or the group fails at its timeout. The reference's
``lax.cond``\\ s become host branches; each reads only a value that came
out of a collective and is the same on every rank (the KL trigger from
the reduced sums, the hop span and surplus count from a max-reduce).

**Random numbers.** A rank's transition noise is its own, the systematic
``u`` is shared: the reference draws ``e1``/``e2`` from
``fold_in(fold_in(k_trans, b), rank)`` and ``u`` from a key every rank
holds. A step takes them as per-rank :class:`BlockNoise` (the tests
replay JAX's draws), or draws ``e1``/``e2`` from a rank-local generator
and ``u`` from a shared one, seeded alike on every rank and advanced by
one draw per block whether or not the trigger fires.

**The compiled step.** As the reference jits each step with the belief
donated, a step runs through a step program (utils/graphs.py): on the
card under NCCL its graphs are captured and replayed; over gloo, whose
collectives stage through the host, and with ``capture=False`` the same
functions run eagerly through the same buffers (:func:`resolve_capture`;
``capture=True`` over gloo raises). The body is split at its host reads,
and each graph is keyed by what the host read before it: per block a
proposal graph and, after the fused sensor's ladder read, one graph per
level that holds the weights, the normalizers and the resampling up to
its own read; where a read picks the exchange (the trigger, the hop span
or the counts' surplus; none on one rank), one graph per path after it.
The random numbers are drawn into named buffers from the same generators
before the replays, or the caller's noise is copied there. The belief is
donated: a step returns the program's buffers. ``plain`` is each step
without a program, the reference the programmed step is held to.
Captured steps at world size >= 2 need one card per rank and are not
verified yet (NCCL refuses two ranks on one card).

**Occlusion leaf.** The sensor's hooks (``gather_occlusion`` with
``num_in``, ``where_occlusion``, ``concat_occlusion``,
``particle_stride``, ``materialize_occlusion``: the fused sensor's
``(n_pad, p_pad)`` map and lazy ages) or the ``(P, N)`` defaults. The
fused sensor's map is updated in place by its compaction scatter: a
caller that steps one belief through two step functions clones it first.

**Lazy ages.** The fused sensor's map is lazy: one age per pixel and
rank, and the ranks' ages differ (each ladder selects its own pixels).
A column that crosses ranks must not meet the receiver's ages. So on a
frame where any offspring of any rank descends from another rank's
particle (``ex["cross"]``: the same on every rank, from the gathered
weights and the shared ``u``), every rank first materializes its map to
age 0 (``materialize_occlusion``), and all ages are zero; on other
frames each rank keeps its map and its own ages bit for bit, as one
rank would. After every exchange a rank's ages are its own (so
materialized), whichever block the hooks took them from. Each offspring's
materialized column is then its parent's on the parent's home rank,
rounded once to the map's dtype. This departs from the reference, which
keeps one shard's ages for the whole map. ``ex["cross"]`` is a device
flag, so the materialization (one pass over the map, the row-aging
kernel) runs on every exchange that moves columns, crossing or not: the
counts exchange on every frame, the others on resample frames; where
nothing crosses it rewrites the map unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from dbot_ros_tpu_torch.filters import rbcpf
from dbot_ros_tpu_torch.filters.rbcpf import BlockNoise, ParticleBelief
from dbot_ros_tpu_torch.models.transition import TransitionParams
from dbot_ros_tpu_torch.ops import resample as rs
from dbot_ros_tpu_torch.parallel import comm as comm_mod
from dbot_ros_tpu_torch.utils import graphs

EXCHANGES = ("counts", "neighbor", "ring", "all_gather")


def make_particle_group(n_ranks: int = None,
                        timeout_s: float = comm_mod.DEFAULT_TIMEOUT_S):
    """The particle axis over the first ``n_ranks`` ranks of the default
    group (all of them by default): the counterpart of
    ``make_particle_mesh``. Every rank must call it; a rank outside the
    group gets None."""
    world = dist.get_world_size()
    n = world if n_ranks is None else int(n_ranks)
    if not 1 <= n <= world:
        raise ValueError(f"need 1..{world} ranks, got {n}")
    if n == world:
        return comm_mod.Comm()
    return comm_mod.new_group(range(n), timeout_s)


@dataclasses.dataclass
class SceneGroups:
    """A rank's place in the scene × particle layout."""

    scene_index: int      # this rank's index on the scene axis
    n_scene: int          # ranks along the scene axis
    particles: object     # Comm of this rank's particle subgroup


def make_scene_groups(n_scene: int, n_particle: int,
                      timeout_s: float = comm_mod.DEFAULT_TIMEOUT_S):
    """Scenes on the first axis, particles on the second, ranks
    scene-major (rank ``r`` holds scene-axis index ``r // n_particle``):
    the counterpart of ``make_scene_mesh``. Every rank creates every
    particle subgroup, in the same order. Scenes carry no collectives."""
    world = dist.get_world_size()
    need = n_scene * n_particle
    if world < need:
        raise ValueError(f"need {need} ranks, have {world}")
    mine = None
    for s in range(n_scene):
        g = comm_mod.new_group(range(s * n_particle, (s + 1) * n_particle),
                               timeout_s)
        if g is not None:
            mine = SceneGroups(scene_index=s, n_scene=n_scene, particles=g)
    return mine


def _round_up128(n: int) -> int:
    return -(-int(n) // 128) * 128


def _tree_map(fn, occ):
    """``fn`` on every leaf of an occlusion leaf (a map or a tuple)."""
    if isinstance(occ, (tuple, list)):
        return tuple(fn(x) for x in occ)
    return fn(occ)


def _occ_hooks(loglik_fn):
    """(gather, where, concat, stride, materialize): the sensor's
    occlusion hooks, or the (P, N) defaults (dist_filter.py:86-118 of
    the reference; a map without ages has nothing to materialize)."""
    sensor_gather = getattr(loglik_fn, "gather_occlusion", None)
    if sensor_gather is None:
        def gather(occ, idx, num_in=None):
            return occ.index_select(
                0, idx.long().clamp(0, occ.shape[0] - 1))
    else:
        def gather(occ, idx, num_in=None):
            return sensor_gather(occ, idx, num_in=num_in)
    where = getattr(loglik_fn, "where_occlusion", None) or (
        lambda mask, a, b: torch.where(
            mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b))
    concat = getattr(loglik_fn, "concat_occlusion", None)
    if concat is None:
        def stride(n):
            return n

        def concat(blocks, num_each):
            return torch.cat(blocks, dim=0)
    else:
        stride = getattr(loglik_fn, "particle_stride", _round_up128)
    materialize = getattr(loglik_fn, "materialize_occlusion", None) or (
        lambda occ, now: occ)
    return gather, where, concat, stride, materialize


def init_distributed_belief(comm, initial_poses, num_particles: int,
                            num_pixels: int = None,
                            initial_occlusion_prob=0.1, sensor=None,
                            device=None) -> ParticleBelief:
    """This rank's block of ``num_particles / comm.size`` particles at the
    initial pose(s), zero velocity, uniform weights. The occlusion leaf
    is ``sensor.init_occlusion`` of the block where the sensor has one,
    else the block's ``(L, N)`` map. ``device`` defaults to the sensor's,
    else the card."""
    if device is None:
        device = getattr(sensor, "device", None) or "cuda"
    if num_particles % comm.size:
        raise ValueError(f"num_particles {num_particles} not divisible by "
                         f"the group size {comm.size}")
    L = num_particles // comm.size
    poses = torch.as_tensor(initial_poses, dtype=torch.float32,
                            device=device)
    if poses.ndim == 1:
        poses = poses[None]
    states = torch.zeros((L, poses.shape[0], 13), device=poses.device)
    states[..., :7] = poses[None]
    if sensor is not None and hasattr(sensor, "init_occlusion"):
        occ = sensor.init_occlusion(L, initial_occlusion_prob)
    else:
        occ = torch.full((L, num_pixels or 0),
                         float(initial_occlusion_prob), device=poses.device)
    return ParticleBelief(states=states,
                          log_weights=torch.zeros((L,), device=poses.device),
                          occlusion=occ)


def _global_log_normalizers(log_w, comm):
    """(logsumexp, sum of squared weights, KL to uniform) over all ranks.
    Three all-reduces: the max, the sum of exponentials, then the two
    sums that need the normalizer."""
    m = comm.all_reduce(torch.max(log_w), "max")
    s1 = comm.all_reduce(torch.sum(torch.exp(log_w - m)))
    lse = m + torch.log(s1)
    ln = log_w - lse
    w = torch.exp(ln)
    sums = comm.all_reduce(torch.stack([
        torch.sum(w * w), torch.sum(w * torch.where(w > 0, ln, 0.0))]))
    p_total = float(comm.size * log_w.shape[0])
    return lse, sums[0], sums[1] + math.log(p_total)


def _psum_mean_state(states, w, comm, power_iters=12):
    """Weighted mean over every rank's particles → (K, 13). Position and
    velocity by reduced sums; each object's quaternion as the principal
    eigenvector of the reduced 4×4 outer-product sum, by power iteration
    from its first column (not an eigendecomposition), sign-fixed to
    w >= 0."""
    K = states.shape[1]
    lin = torch.einsum("p,pkd->kd", w, states)
    q = states[..., 3:7]
    A = torch.einsum("p,pki,pkj->kij", w, q, q)
    red = comm.all_reduce(torch.cat([lin.reshape(-1), A.reshape(-1)]))
    lin, A = red[:K * 13].reshape(K, 13), red[K * 13:].reshape(K, 4, 4)
    qm = A[..., 0]
    qm = qm / torch.clamp_min(torch.linalg.norm(qm, dim=-1, keepdim=True),
                              1e-12)
    for _ in range(power_iters):
        qm = torch.einsum("kij,kj->ki", A, qm)
        qm = qm / torch.clamp_min(torch.linalg.norm(qm, dim=-1,
                                                    keepdim=True), 1e-20)
    qm = qm * torch.where(qm[..., :1] < 0, -1.0, 1.0)
    return torch.cat([lin[:, :3], qm, lin[:, 7:13]], dim=-1)


def _count_hops(max_hops: int, n_shards: int):
    """Signed hops of the counts exchange: one per residue mod S, the
    smallest |s| first, none ≡ 0 (a rank's own rows come from its local
    gather; on two ranks hops ±1 reach the same neighbour)."""
    hops, seen = [], set()
    for s in sorted(range(-max_hops, max_hops + 1), key=abs):
        r = s % n_shards
        if r != 0 and r not in seen:
            seen.add(r)
            hops.append(s)
    return hops


def counts_capacity(p_local: int, capacity: int = None) -> int:
    """Surplus-buffer columns of the counts exchange: ``max(128, L/8)`` by
    default, rounded up to 128 and at most ``round128(L)``."""
    C = capacity if capacity is not None else max(128, p_local // 8)
    return min(_round_up128(C), _round_up128(p_local))


def _static_path(exchange, n_shards, max_hops, capacity, p_local):
    """The exchange every block takes where no host read decides it:
    ``"local"`` on one rank, ``"counts"`` where its buffers cannot
    overflow; else None."""
    if n_shards == 1:
        return "local"
    if (exchange == "counts" and max_hops >= n_shards // 2
            and counts_capacity(p_local, capacity) >= p_local):
        return "counts"
    return None


def _choose_path(exchange, n_shards, max_hops, capacity, p_local, read):
    """The exchange of one block: the static one, else from the host's one
    read of ``read`` (values out of a collective, the same on every rank,
    so every rank takes the same branch and the collective order stays
    uniform)."""
    path = _static_path(exchange, n_shards, max_hops, capacity, p_local)
    if path is not None:
        return path
    vals = [int(v) for v in read.tolist()]
    if exchange == "counts":
        span, m_max = vals
        return ("counts" if span <= max_hops
                and m_max <= counts_capacity(p_local, capacity) else "ring")
    if not vals[0]:
        return "none"
    if exchange == "all_gather":
        return "all_gather"
    if exchange == "ring" or len(vals) == 1:
        return "ring"
    return "ring" if vals[1] > max_hops else "neighbor"


def _resample_prepare(states, log_w, occ, old_loglik, *, do, ln, u, comm,
                      exchange, max_hops, capacity, hooks):
    """Global systematic resampling of one coordinate block's aftermath, up
    to the host read that picks its exchange → (ex, read). ``ex`` holds
    the new ``states``, ``log_w`` and ``old_loglik`` and what the
    exchange takes; ``read`` the int64 values the read picks the path
    from (None where the path is static, :func:`_static_path`). Every
    exchange gives the all-gather resampler's output bit for bit; they
    differ only in how parent occlusion rows cross ranks. The trigger
    ``do`` where-selects between the systematic parents and the identity;
    the counts exchange runs its collectives every frame, the others only
    on resample frames (the neighbour exchange's hop span is reduced on
    every frame, so that one read picks its path). ``ex["cross"]`` says
    whether any offspring of any rank has its parent on another rank
    (see the module docstring on lazy ages)."""
    occ_gather = hooks[0]
    idx, S = comm.rank, comm.size
    p_local, K = states.shape[:2]
    dev = log_w.device
    # weights, parent states and running logliks in one all-gather
    packed = torch.cat([torch.exp(ln)[:, None], old_loglik[:, None],
                        states.reshape(p_local, K * 13)], dim=1)
    packed_all = comm.all_gather(packed, tiled=True)
    w_all = packed_all[:, 0].contiguous()
    cdf = rs.weight_cdf(w_all)
    total = w_all.shape[0]
    ar = torch.arange(p_local, dtype=torch.float32, device=dev)
    ar_i = torch.arange(p_local, device=dev)

    def shard_parents(shard):
        """Where-selected global parents of rank ``shard``'s offspring:
        systematic on resample frames, the identity otherwise."""
        pos = (ar + shard * p_local + u) / total
        p_rs = torch.clamp(torch.searchsorted(cdf, pos, side="left"),
                           0, total - 1)
        return torch.where(do, p_rs, shard * p_local + ar_i)

    all_parents = torch.stack([shard_parents(s) for s in range(S)])
    parents = all_parents[idx]
    picked = packed_all.index_select(0, parents)
    ex = {"states": picked[:, 2:].reshape(p_local, K, 13),
          "log_w": torch.where(do, torch.zeros_like(log_w), log_w),
          "old_loglik": picked[:, 1].contiguous(), "parents": parents}
    owner = torch.div(parents, p_local, rounding_mode="floor")
    ex["local_idx"] = torch.clamp(parents - idx * p_local, 0, p_local - 1)
    if S == 1:
        # one rank: every parent is local, the exchange is the lineage
        # gather (no collective, no host read)
        return ex, None
    ex["owner"] = owner
    home = torch.arange(S, device=dev)[:, None]
    ex["cross"] = torch.any(torch.div(all_parents, p_local,
                                      rounding_mode="floor") != home)
    if exchange != "counts":
        read = [do.to(torch.int64)]
        if exchange == "neighbor" and S > 2 * max_hops + 1:
            d = owner - idx
            read.append(comm.all_reduce(torch.maximum(d.max(), -d.min()),
                                        "max"))
        return ex, torch.stack(read)

    # counts: locally owned parent rows (all of them on frames without a
    # resample) come from one lineage gather; remote rows ride per-hop
    # C-column surplus buffers that the sender compacts from the shared
    # (cdf, u), one ppermute per hop on every frame. Frames whose hop span
    # or distinct-parent count overflow run the full ring.
    C = counts_capacity(p_local, capacity)
    hops = _count_hops(max_hops, S)
    half = S // 2
    dw = torch.remainder(owner - idx + half, S) - half   # minimal signed hop

    plans = []
    m_local = torch.zeros((), dtype=torch.int64, device=dev)
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    for s in hops:
        dest = (idx + s) % S
        p_d = all_parents[dest]
        mine = torch.div(p_d, p_local, rounding_mode="floor") == idx
        chg = torch.cat([one, p_d[1:] != p_d[:-1]])
        first = mine & chg
        slot = torch.cumsum(first.to(torch.int64), 0) - 1
        # rows[slot] = local parent row where `first`; everything else
        # (and slots past C) lands in slot C, which is dropped
        rows = torch.zeros((C + 1,), dtype=torch.int32, device=dev)
        rows.scatter_(0, torch.where(first, torch.clamp(slot, max=C), C),
                      torch.where(first, p_d - idx * p_local, 0).to(
                          torch.int32))
        plans.append(rows[:C])
        m_local = torch.maximum(m_local, first.sum())
    span_m = comm.all_reduce(torch.stack([dw.abs().max(), m_local]), "max")

    # receiver-side slots into the concatenated buffers (one C-column
    # block per hop, stride occ_stride(C)): offspring j's parent sits at
    # its distinct-rank within the run of parents its source owns
    Cs = hooks[3](C)
    chg_mine = torch.cat([one, parents[1:] != parents[:-1]])
    cidx = torch.zeros((p_local,), dtype=torch.int64, device=dev)
    for h, s in enumerate(hops):
        src = (idx - s) % S
        mask = owner == src
        slotm = torch.cumsum((mask & chg_mine).to(torch.int64), 0) - 1
        cidx = torch.where(mask, h * Cs + slotm, cidx)
    ex.update(plans=plans, cidx=cidx)
    static = _static_path(exchange, S, max_hops, capacity, p_local)
    return ex, None if static is not None else span_m


def _exchange(path, occ, ex, *, comm, max_hops, capacity, hooks):
    """The occlusion leaf after a block's resampling by exchange ``path``
    (:func:`_choose_path`) from what :func:`_resample_prepare` left in
    ``ex``; ``occ`` is the block's (committed) leaf."""
    occ_gather, _, _, _, occ_materialize = hooks
    if path == "local":
        return occ_gather(occ, ex["local_idx"])
    if path == "none":
        return occ
    # columns may cross ranks: materialize where they do (module
    # docstring, lazy ages)
    occ = occ_materialize(occ, ex["cross"])
    out = _move_columns(path, occ, ex, comm=comm, max_hops=max_hops,
                        capacity=capacity, hooks=hooks)
    # the rank's own ages, whichever block the hooks kept them from
    return (out[0], occ[1]) if isinstance(occ, (tuple, list)) else out


def _move_columns(path, occ, ex, *, comm, max_hops, capacity, hooks):
    """The parent columns of this rank's offspring by ``path`` (not
    ``"local"`` or ``"none"``) from the blocks' leaves; the ages of the
    result are whichever the hooks kept."""
    occ_gather, occ_where, occ_concat, occ_stride, _ = hooks
    idx, S = comm.rank, comm.size
    parents, owner = ex["parents"], ex["owner"]
    p_local = parents.shape[0]

    def ppermute(x, pairs):
        return _tree_map(lambda leaf: comm.ppermute(leaf, pairs), x)

    def pluck(out, blk, src):
        """Copy the rows of ``parents`` owned by rank ``src`` from blk."""
        src_idx = torch.clamp(parents - src * p_local, 0, p_local - 1)
        mask = (parents >= src * p_local) & (parents < (src + 1) * p_local)
        return occ_where(mask, occ_gather(blk, src_idx), out)

    if path == "ring":
        # at round r this rank holds rank (idx + r) % S's block, copies
        # the rows it owns, and passes the block along the ring
        ring = [(i, (i - 1) % S) for i in range(S)]
        held = occ
        out = _tree_map(torch.zeros_like, occ)
        for r in range(S):
            out = pluck(out, held, (idx + r) % S)
            if r < S - 1:
                held = ppermute(held, ring)
        return out
    if path == "all_gather":
        stride = occ_stride(p_local)
        occ_all = _tree_map(comm.all_gather, occ)           # (S, ...)
        blocks = [_tree_map(lambda x, s=s: x[s], occ_all) for s in range(S)]
        combined = occ_concat(blocks, p_local)
        gidx = owner * stride + (parents - owner * p_local)
        return occ_gather(combined, gidx, num_in=S * stride)
    if path == "neighbor":
        out = _tree_map(torch.zeros_like, occ)
        out = pluck(out, occ, idx)
        for h in range(1, max_hops + 1):
            for s in (h, -h):
                # blk on rank i is rank (i + s) mod S's block
                blk = ppermute(occ, [((i + s) % S, i) for i in range(S)])
                out = pluck(out, blk, (idx + s) % S)
        return out
    # counts
    C = counts_capacity(p_local, capacity)
    hops = _count_hops(max_hops, S)
    bufs = []
    for s, rows in zip(hops, ex["plans"]):
        buf = occ_gather(occ, rows, num_in=occ_stride(p_local))
        bufs.append(ppermute(buf, [(i, (i + s) % S) for i in range(S)]))
    combined = occ_concat(bufs, C)
    remote = occ_gather(combined, ex["cidx"],
                        num_in=occ_stride(C) * len(hops))
    return occ_where(owner != idx, remote, occ_gather(occ, ex["local_idx"]))


def _fill_noise(noise, e_gen, u_gen):
    """Fill per-block :class:`BlockNoise` buffers in place: ``e1``, ``e2``
    from ``e_gen``, ``u`` from ``u_gen``, block after block."""
    for nb in noise:
        nb.e1.normal_(generator=e_gen)
        nb.e2.normal_(generator=e_gen)
        nb.u.uniform_(generator=u_gen)
    return noise


def _draw_noise(num_objects, p_local, e_gen, u_gen, dev):
    """Per-block noise from the generators (the plain step's)."""
    return _fill_noise([BlockNoise(
        torch.empty((p_local, 6), device=dev),
        torch.empty((p_local, 6), device=dev), torch.empty((), device=dev))
        for _ in range(num_objects)], e_gen, u_gen)


def _program_noise(prog, belief, noise, gens):
    """The step's block noise in ``prog``'s buffers: the caller's
    ``noise`` copied in, else drawn from ``gens()`` (the e and u
    generators) outside the graphs, in the plain step's order."""
    if noise is not None:
        return prog.keep("noise", [BlockNoise(*(
            torch.as_tensor(x, dtype=torch.float32)
            for x in (nb.e1, nb.e2, nb.u))) for nb in noise])
    L = belief.num_particles
    return _fill_noise([BlockNoise(
        prog.buffer(f"noise.{b}.e1", (L, 6)),
        prog.buffer(f"noise.{b}.e2", (L, 6)), prog.buffer(f"noise.{b}.u", ()))
        for b in range(belief.num_objects)], *gens())


def _generators(seed: int, stream: int, rank: int, dev):
    """(rank-local, shared) generators of one scene: the shared one is
    seeded alike on every rank of the group."""
    local = torch.Generator(device=dev)
    local.manual_seed((int(seed) * 1_000_003 + stream) * 65_537 + rank + 1)
    shared = torch.Generator(device=dev)
    shared.manual_seed((int(seed) * 1_000_003 + stream) * 65_537)
    return local, shared


def resolve_capture(comm, capture=None) -> bool:
    """A step's capture policy over ``comm``: None means when its
    collectives can be captured (NCCL, :attr:`comm.Comm.capturable`), so a
    step over gloo is eager; ``True`` over gloo raises. A CPU device with
    ``True`` raises where the step's program is made."""
    if capture is None:
        return comm.capturable
    if capture and not comm.capturable:
        raise ValueError(
            f"capture=True needs an NCCL group, this one is "
            f"{comm.backend!r}: its collectives stage CUDA tensors through "
            "host memory, which a CUDA graph cannot hold")
    return bool(capture)


class _SceneBody:
    """One scene's step on one rank (the reference's ``step_one``), in the
    pieces between its host reads. :meth:`plain` runs them eagerly with
    the reads inline; :meth:`run` runs them as a step program's graphs,
    keyed by what the host read between them."""

    def __init__(self, loglik_fn, trans_params, dt, max_kl_divergence,
                 exchange, max_hops, capacity):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange mode: {exchange!r}")
        self.sensor = loglik_fn
        self.trans_params = trans_params
        self.dt = dt
        self.max_kl = max_kl_divergence
        self.exchange, self.max_hops, self.capacity = (exchange, max_hops,
                                                        capacity)
        self.hooks = _occ_hooks(loglik_fn)

    def _weigh(self, comm, states, log_w, occ, old_loglik, loglik, u):
        """After a block's sensor call: the weight update, the global
        normalizers and the resampling up to its host read → (ex, read)."""
        log_w = log_w + loglik - old_loglik
        lse, _, kl = _global_log_normalizers(log_w, comm)
        return _resample_prepare(
            states, log_w, occ, loglik, do=kl > self.max_kl, ln=log_w - lse,
            u=u, comm=comm, exchange=self.exchange, max_hops=self.max_hops,
            capacity=self.capacity, hooks=self.hooks)

    def _path(self, comm, p_local, read):
        return _choose_path(self.exchange, comm.size, self.max_hops,
                            self.capacity, p_local, read)

    def _exchange(self, comm, path, occ, ex):
        return _exchange(path, occ, ex, comm=comm, max_hops=self.max_hops,
                         capacity=self.capacity, hooks=self.hooks)

    @staticmethod
    def _summary(comm, states, log_w):
        lse2, s2, _ = _global_log_normalizers(log_w, comm)
        w = torch.exp(log_w - lse2)
        return _psum_mean_state(states, w, comm), 1.0 / s2

    def plain(self, comm, belief, z_obs, noise, trace):
        """The step without a program → (belief, mean_state, ess); the
        path of each block is appended to ``trace``."""
        states, log_w, occ = belief.states, belief.log_weights, \
            belief.occlusion
        old_loglik = torch.zeros_like(log_w)
        num_objects = belief.num_objects
        for b in range(num_objects):
            nb = noise[b]
            states = rbcpf.propose_block(states, b, self.dt,
                                         self.trans_params, nb)
            commit = b == num_objects - 1
            loglik, occ_post = self.sensor(states, occ, z_obs, self.dt,
                                           commit=commit)
            if commit:
                occ = occ_post
            u = torch.as_tensor(nb.u, dtype=torch.float32,
                                device=log_w.device)
            ex, read = self._weigh(comm, states, log_w, occ, old_loglik,
                                   loglik, u)
            path = self._path(comm, belief.num_particles, read)
            trace.append(path)
            occ = self._exchange(comm, path, occ, ex)
            states, log_w, old_loglik = (ex["states"], ex["log_w"],
                                         ex["old_loglik"])
        mean_state, ess = self._summary(comm, states, log_w)
        return ParticleBelief(states, log_w, occ), mean_state, ess

    def run(self, prog, comm, belief, z_obs, noise, trace):
        """The step through ``prog``: per block the sensor's graphs
        (``rbcpf.program_block``), whose last holds the resampling up to its
        read; where a read picks the exchange, an ``("exchange", b,
        path)`` graph after it. Returns (belief, mean_state, ess), all of
        them ``prog``'s buffers; ``noise`` is in its buffers."""
        bel = prog.keep("belief", belief)
        z = prog.keep("z", z_obs)
        dt = prog.scalar("dt", self.dt)
        num_objects = bel.num_objects
        static = _static_path(self.exchange, comm.size, self.max_hops,
                              self.capacity, bel.num_particles)
        for b in range(num_objects):
            last = b == num_objects - 1

            def finish(path, ex, last=last):
                new = prog.keep("belief", ParticleBelief(
                    ex["states"], ex["log_w"],
                    self._exchange(comm, path, bel.occlusion, ex)))
                if last:
                    return prog.keep("out", self._summary(
                        comm, new.states, new.log_weights))
                prog.keep("carry", ex["old_loglik"])
                return None

            def rest(states, plan, b=b, last=last):
                loglik, occ_post = rbcpf.sense(self.sensor, plan, states,
                                               bel.occlusion, z, dt, last)
                occ = (prog.keep("belief.occlusion", occ_post) if last
                       else bel.occlusion)
                old = (prog["carry"] if b
                       else torch.zeros_like(bel.log_weights))
                ex, read = self._weigh(comm, states, bel.log_weights, occ,
                                       old, loglik, noise[b].u)
                if static is not None:
                    return finish(static, ex)
                return prog.keep("ex", ex), prog.keep("read", read)

            out = rbcpf.program_block(prog, self.sensor, b, bel, z, dt,
                                      self.trans_params, noise[b], rest)
            if static is not None:
                trace.append(static)
                continue
            ex, read = out
            path = self._path(comm, bel.num_particles, read)
            trace.append(path)
            prog.run(("exchange", b, path),
                     lambda path=path, ex=ex: finish(path, ex))
        return dataclasses.replace(bel), prog["out.0"], prog["out.1"]


class DistributedStep:
    """``step(belief, z_obs, noise=None) → (belief, mean_state (K, 13),
    ess)`` on this rank's block (see :func:`make_distributed_step`).
    ``noise`` is one :class:`BlockNoise` per object with this rank's
    ``e1``/``e2`` (L, 6) and the shared ``u``; without it they come from
    ``generator`` (rank-local) and ``shared_generator``. ``paths`` holds
    the exchange path each block of the last call took.

    The step runs through its step program (``program``, made at the
    first call on the belief's device; ``capture`` says whether its
    graphs are captured, see :func:`resolve_capture`). **The belief is
    donated**: the returned belief is the program's buffers, which the
    next call overwrites (``ParticleBelief.clone()`` keeps a copy); a
    belief from elsewhere is copied in. ``mean_state`` and ``ess`` are
    copies out of the buffers, as in the reference, where only the
    belief is donated: they outlive the next call. :meth:`plain` is the
    same step without a program, the reference the programmed step is
    held to."""

    def __init__(self, comm, body, seed, capture=None):
        self.comm = comm
        self._body = body
        self.seed = seed
        self.capture = resolve_capture(comm, capture)
        self.generator = self.shared_generator = None
        self.program = None
        self.paths = []

    def _generators(self, dev):
        if self.generator is None:
            self.generator, self.shared_generator = _generators(
                self.seed, 0, self.comm.rank, dev)
        return self.generator, self.shared_generator

    def __call__(self, belief: ParticleBelief, z_obs,
                 noise: Optional[Sequence[BlockNoise]] = None):
        dev = belief.log_weights.device
        if self.program is None:
            self.program = graphs.StepProgram(dev, self.capture,
                                              counters=self.comm.counters())
        noise = _program_noise(self.program, belief, noise,
                               lambda: self._generators(dev))
        self.paths = []
        belief, mean_state, ess = self._body.run(
            self.program, self.comm, belief, z_obs, noise, self.paths)
        return (belief, *graphs.copy_out((mean_state, ess)))

    def plain(self, belief: ParticleBelief, z_obs,
              noise: Optional[Sequence[BlockNoise]] = None):
        """The step without a program: the same pieces run eagerly with
        their host reads inline (draws from the same generators)."""
        if noise is None:
            dev = belief.log_weights.device
            noise = _draw_noise(belief.num_objects, belief.num_particles,
                                *self._generators(dev), dev)
        self.paths = []
        return self._body.plain(self.comm, belief, z_obs, noise, self.paths)


def make_distributed_step(comm, loglik_fn: Callable,
                          trans_params: TransitionParams, dt: float,
                          max_kl_divergence: float = 1.0,
                          exchange: str = "counts", max_hops: int = 1,
                          capacity: int = None, seed: int = 0,
                          capture=None) -> DistributedStep:
    """The distributed RBC-PF step over ``comm``'s ranks (K objects per
    scene): the reference's sequential coordinate blocks with per-block
    KL-triggered global resampling, the semantics of ``rbcpf_step``.
    ``z_obs`` is the same frame on every rank; each rank passes and gets
    back its own block.

    ``exchange`` picks how resampling fetches parent occlusion rows:

    * ``"counts"`` (default): every rank recomputes each hop-neighbour's
      parents from the gathered weights, compacts the distinct rows that
      neighbour needs from it into a ``capacity``-column surplus buffer
      and ships only the buffers (one ppermute per hop, every frame);
      frames whose hop span or distinct-parent count overflow run the
      full ring;
    * ``"neighbor"``: whole blocks from up to ``max_hops`` ranks each way;
    * ``"ring"``: S - 1 ppermutes of whole blocks around the ring;
    * ``"all_gather"``: every block to every rank, then one gather.

    ``capacity`` (counts) defaults to ``max(128, L/8)``, rounded up to a
    multiple of 128. On one rank every mode is the lineage gather. Parent
    states always travel by all-gather. ``capture``: see
    :func:`resolve_capture` (the counterpart of the reference's
    ``jax.jit`` with the belief donated).
    """
    body = _SceneBody(loglik_fn, trans_params, dt, max_kl_divergence,
                      exchange, max_hops, capacity)
    return DistributedStep(comm, body, seed, capture)


# ---------------------------------------------------------------------------
# Scenes on one axis, particles on the other
# ---------------------------------------------------------------------------

def _local_scenes(groups: SceneGroups, num_scenes: int):
    if num_scenes % groups.n_scene:
        raise ValueError(f"num_scenes {num_scenes} not divisible by the "
                         f"scene axis ({groups.n_scene} ranks)")
    per = num_scenes // groups.n_scene
    return list(range(groups.scene_index * per,
                      (groups.scene_index + 1) * per))


def init_multi_scene_belief(groups: SceneGroups, initial_poses,
                            num_scenes: int, num_particles: int,
                            num_pixels: int = None,
                            initial_occlusion_prob=0.1, sensor=None,
                            device=None) -> List[ParticleBelief]:
    """This rank's blocks of its scenes, one belief per local scene
    (scenes ``scene_index · S/n_scene`` onward). ``initial_poses`` is
    (7,) / (K, 7) for every scene or (S, K, 7); ``device`` as in
    :func:`init_distributed_belief`."""
    if device is None:
        device = getattr(sensor, "device", None) or "cuda"
    poses = torch.as_tensor(initial_poses, dtype=torch.float32,
                            device=device)
    if poses.ndim == 1:
        poses = poses[None]
    if poses.ndim == 2:
        poses = poses[None].expand((num_scenes,) + tuple(poses.shape))
    return [init_distributed_belief(groups.particles, poses[s],
                                    num_particles, num_pixels,
                                    initial_occlusion_prob, sensor,
                                    device=poses.device)
            for s in _local_scenes(groups, num_scenes)]


class MultiSceneStep:
    """``step(beliefs, z_obs, noise=None) → (beliefs, mean_states
    (S_local, K, 13), ess (S_local,))`` over this rank's scenes: one
    belief and one frame ``z_obs[s]`` per local scene, ``noise[s]`` one
    list of :class:`BlockNoise` per scene (else each scene draws from its
    own pair of generators). Each local scene runs through its own step
    program (``programs``), all of them on one capture stream and memory
    pool; the beliefs are donated, as in :class:`DistributedStep`."""

    def __init__(self, groups, body, seed, capture=None):
        self.groups = groups
        self._body = body
        self.seed = seed
        self.capture = resolve_capture(groups.particles, capture)
        self._gens = None
        self.programs = []
        self.paths = []

    def _generators(self, n, dev):
        if self._gens is None:
            first = self.groups.scene_index * n
            self._gens = [_generators(self.seed, first + s + 1,
                                      self.groups.particles.rank, dev)
                          for s in range(n)]
        return self._gens

    def __call__(self, beliefs, z_obs, noise=None):
        comm = self.groups.particles
        dev = beliefs[0].log_weights.device
        gens = self._generators(len(beliefs), dev)
        while len(self.programs) < len(beliefs):
            self.programs.append(graphs.StepProgram(
                dev, self.capture, counters=comm.counters(),
                share=self.programs[0] if self.programs else None))
        out, means, ess = [], [], []
        self.paths = []
        # scenes carry no collectives: a rank steps its scenes in turn,
        # each over its particle subgroup
        for s, belief in enumerate(beliefs):
            prog = self.programs[s]
            nz = _program_noise(prog, belief,
                                None if noise is None else noise[s],
                                lambda s=s: gens[s])
            b, ms, e = self._body.run(prog, comm, belief, z_obs[s], nz,
                                      self.paths)
            out.append(b)
            means.append(ms)
            ess.append(e)
        return out, torch.stack(means), torch.stack(ess)

    def plain(self, beliefs, z_obs, noise=None):
        """The step without programs (see :meth:`DistributedStep.plain`)."""
        comm = self.groups.particles
        dev = beliefs[0].log_weights.device
        gens = self._generators(len(beliefs), dev)
        out, means, ess = [], [], []
        self.paths = []
        for s, belief in enumerate(beliefs):
            nz = (noise[s] if noise is not None else _draw_noise(
                belief.num_objects, belief.num_particles, *gens[s], dev))
            b, ms, e = self._body.plain(comm, belief, z_obs[s], nz,
                                        self.paths)
            out.append(b)
            means.append(ms)
            ess.append(e)
        return out, torch.stack(means), torch.stack(ess)


def make_multi_scene_step(groups: SceneGroups, loglik_fn: Callable,
                          trans_params: TransitionParams, dt: float,
                          max_kl_divergence: float = 1.0,
                          exchange: str = "counts", max_hops: int = 1,
                          capacity: int = None, seed: int = 0,
                          capture=None) -> MultiSceneStep:
    """Independent scenes over ``make_scene_groups``' layout: each scene
    runs the distributed step of :func:`make_distributed_step` over its
    particle subgroup; the scene axis carries no collectives.
    ``torch.func.vmap`` cannot batch the fused sensor (its kernels are
    ctypes calls on raw pointers), so a rank loops over its scenes, where
    the reference runs one ``jit(vmap)``."""
    body = _SceneBody(loglik_fn, trans_params, dt, max_kl_divergence,
                      exchange, max_hops, capacity)
    return MultiSceneStep(groups, body, seed, capture)


# ---------------------------------------------------------------------------
# Island model: no per-particle exchange on the common path
# ---------------------------------------------------------------------------

class _IslandBody:
    """The island step on one rank, in the pieces between its host reads
    (the ladder's in each block, the island trigger after the last):
    :meth:`plain` eagerly, :meth:`run` through a step program."""

    def __init__(self, loglik_fn, trans_params, dt, max_kl_divergence,
                 island_max_kl):
        self.sensor = loglik_fn
        self.trans_params = trans_params
        self.dt = dt
        self.max_kl = max_kl_divergence
        self.island_max_kl = island_max_kl
        self.gather = _occ_hooks(loglik_fn)[0]

    def _local(self, states, occ, old_loglik, ln_local, b_acc, loglik, u):
        """After a block's sensor call: the island decomposition and the
        local KL-triggered resampling → (states, occ, old_loglik,
        ln_local, b_acc)."""
        p_local = states.shape[0]
        dev = loglik.device
        log_p = math.log(float(p_local))
        ar = torch.arange(p_local, dtype=torch.float32, device=dev)
        ar_i = torch.arange(p_local, device=dev)
        ln_local = ln_local + loglik - old_loglik
        old_loglik = loglik
        # island decomposition: b = local logsumexp, ln sums to 1
        m_loc = torch.max(ln_local)
        b = m_loc + torch.log(torch.sum(torch.exp(ln_local - m_loc)))
        b_acc = b_acc + b
        ln_local = ln_local - b
        w_loc = torch.exp(ln_local)
        kl_local = (torch.sum(w_loc * torch.where(w_loc > 0, ln_local, 0.0))
                    + log_p)
        # the trigger is island-local and touches no collective: a
        # where-select, no host read
        do_l = kl_local > self.max_kl
        p_rs = torch.clamp(torch.searchsorted(
            rs.weight_cdf(w_loc), (ar + u) / p_local, side="left"),
            0, p_local - 1)
        parents = torch.where(do_l, p_rs, ar_i)
        return (states.index_select(0, parents), self.gather(occ, parents),
                old_loglik.index_select(0, parents),
                torch.where(do_l, torch.full_like(ln_local, -log_p),
                            ln_local), b_acc)

    def _islands(self, comm, b_acc):
        """Island bookkeeping (scalar collectives only) → (the normalized
        island log weight, whether the island weights degenerated)."""
        m_b = comm.all_reduce(b_acc, "max")
        sum_b = comm.all_reduce(torch.exp(b_acc - m_b))
        bn = b_acc - (m_b + torch.log(sum_b))
        w_isl = torch.exp(bn)
        kl_islands = (comm.all_reduce(w_isl * torch.where(w_isl > 0, bn,
                                                          0.0))
                      + math.log(float(comm.size)))
        return bn, kl_islands > self.island_max_kl

    @staticmethod
    def _finish(comm, states, occ, ln_local, bn, island_u, exchange):
        """The island resampling when ``exchange`` (read from the island
        trigger: the same on every rank), the mean and ESS → (states,
        log_w, occ, mean_state, ess)."""
        idx, n_islands = comm.rank, comm.size
        if exchange:
            bn_all = comm.all_gather(bn)                         # (S,)
            cdf = rs.weight_cdf(torch.exp(bn_all))
            pos = ((torch.full((), float(idx), device=bn.device)
                    + island_u) / n_islands)
            src = torch.clamp(torch.searchsorted(cdf, pos[None],
                                                 side="left"),
                              0, n_islands - 1)                  # (1,)

            def pick(x):
                return comm.all_gather(x).index_select(0, src)[0]

            states = pick(states)
            occ = _tree_map(pick, occ)
            ln_local = pick(ln_local)
            bn = torch.full_like(bn, -math.log(float(n_islands)))
        log_w = bn + ln_local
        lse2, s2, _ = _global_log_normalizers(log_w, comm)
        w = torch.exp(log_w - lse2)
        mean_state = _psum_mean_state(states, w, comm, power_iters=10)
        return states, log_w, occ, mean_state, 1.0 / s2

    def plain(self, comm, belief, z_obs, noise, island_u, trace):
        """The step without a program → (belief, mean_state, ess); the
        island exchange's path (``"islands"`` or ``"none"``) is appended
        to ``trace``."""
        states, occ = belief.states, belief.occlusion
        dev = belief.log_weights.device
        old_loglik = torch.zeros_like(belief.log_weights)
        b_acc = torch.zeros((), device=dev)
        ln_local = belief.log_weights
        num_objects = belief.num_objects
        for blk in range(num_objects):
            nb = noise[blk]
            states = rbcpf.propose_block(states, blk, self.dt,
                                         self.trans_params, nb)
            commit = blk == num_objects - 1
            loglik, occ_post = self.sensor(states, occ, z_obs, self.dt,
                                           commit=commit)
            if commit:
                occ = occ_post
            u = torch.as_tensor(nb.u, dtype=torch.float32, device=dev)
            states, occ, old_loglik, ln_local, b_acc = self._local(
                states, occ, old_loglik, ln_local, b_acc, loglik, u)
        bn, do = self._islands(comm, b_acc)
        do = bool(do)
        trace.append("islands" if do else "none")
        states, log_w, occ, mean_state, ess = self._finish(
            comm, states, occ, ln_local, bn, island_u, do)
        return ParticleBelief(states, log_w, occ), mean_state, ess

    def run(self, prog, comm, belief, z_obs, noise, island_u, trace):
        """The step through ``prog``: per block the sensor's graphs, the
        last of them with the island bookkeeping up to its trigger; the
        trigger's host read; a ``("finish", do)`` graph. Returns (belief,
        mean_state, ess), all ``prog``'s buffers; ``noise`` and
        ``island_u`` are in its buffers."""
        bel = prog.keep("belief", belief)
        z = prog.keep("z", z_obs)
        dt = prog.scalar("dt", self.dt)
        num_objects = bel.num_objects
        for blk in range(num_objects):
            last = blk == num_objects - 1

            def rest(states, plan, blk=blk, last=last):
                loglik, occ_post = rbcpf.sense(self.sensor, plan, states,
                                               bel.occlusion, z, dt, last)
                occ = occ_post if last else bel.occlusion
                if blk:
                    c = (prog["carry.old_loglik"], prog["carry.ln_local"],
                         prog["carry.b_acc"])
                else:
                    c = (torch.zeros_like(bel.log_weights), bel.log_weights,
                         torch.zeros((), device=bel.log_weights.device))
                states, occ, old, ln_local, b_acc = self._local(
                    states, occ, *c, loglik, noise[blk].u)
                prog.keep("belief.states", states)
                prog.keep("belief.occlusion", occ)
                prog.keep("carry", {"old_loglik": old, "ln_local": ln_local,
                                    "b_acc": b_acc})
                if not last:
                    return None
                bn, do = self._islands(comm, b_acc)
                prog.keep("bn", bn)
                return prog.keep("read", do)

            read = rbcpf.program_block(prog, self.sensor, blk, bel, z, dt,
                                       self.trans_params, noise[blk], rest)
        do = bool(read)
        trace.append("islands" if do else "none")

        def finish():
            states, log_w, occ, mean_state, ess = self._finish(
                comm, bel.states, bel.occlusion, prog["carry.ln_local"],
                prog["bn"], island_u, do)
            prog.keep("belief", ParticleBelief(states, log_w, occ))
            return prog.keep("out", (mean_state, ess))

        mean_state, ess = prog.run(("finish", do), finish)
        return dataclasses.replace(bel), mean_state, ess


class IslandStep:
    """``step(belief, z_obs, noise=None, island_u=None) → (belief,
    mean_state, ess)``: ``noise`` per block with this rank's ``e1``,
    ``e2`` and its own local resampling ``u``; ``island_u`` the shared
    uniform of the island resampling. Without them: ``e1``, ``e2``, ``u``
    from the rank-local generator, ``island_u`` from the shared one (one
    draw a step on every rank). A step program runs it and the belief is
    donated, as in :class:`DistributedStep` (``plain``: without the
    program; ``mean_state`` and ``ess`` are copies that outlive the next
    call). ``paths`` holds ``["islands"]`` after a step that exchanged
    whole blocks, else ``["none"]``."""

    def __init__(self, comm, body, seed, capture=None):
        self.comm = comm
        self._body = body
        self.seed = seed
        self.capture = resolve_capture(comm, capture)
        self.generator = self.shared_generator = None
        self.program = None
        self.paths = []

    def _generators(self, dev):
        if self.generator is None:
            self.generator, self.shared_generator = _generators(
                self.seed, 0, self.comm.rank, dev)
        return self.generator, self.shared_generator

    def __call__(self, belief, z_obs, noise=None, island_u=None):
        dev = belief.log_weights.device
        if self.program is None:
            self.program = graphs.StepProgram(dev, self.capture,
                                              counters=self.comm.counters())
        prog = self.program
        noise = _program_noise(prog, belief, noise,
                               lambda: (self._generators(dev)[0],) * 2)
        if island_u is None:
            island_u = prog.buffer("island_u", ()).uniform_(
                generator=self._generators(dev)[1])
        else:
            island_u = prog.keep("island_u", torch.as_tensor(
                island_u, dtype=torch.float32))
        self.paths = []
        belief, mean_state, ess = self._body.run(
            prog, self.comm, belief, z_obs, noise, island_u, self.paths)
        return (belief, *graphs.copy_out((mean_state, ess)))

    def plain(self, belief, z_obs, noise=None, island_u=None):
        """The step without a program (see :meth:`DistributedStep.plain`)."""
        dev = belief.log_weights.device
        local, shared = self._generators(dev)
        if noise is None:
            noise = _draw_noise(belief.num_objects, belief.num_particles,
                                local, local, dev)
        if island_u is None:
            island_u = torch.rand((), generator=shared, device=dev)
        island_u = torch.as_tensor(island_u, dtype=torch.float32,
                                   device=dev)
        self.paths = []
        return self._body.plain(self.comm, belief, z_obs, noise, island_u,
                                self.paths)


def make_island_step(comm, loglik_fn: Callable,
                     trans_params: TransitionParams, dt: float,
                     max_kl_divergence: float = 1.0,
                     island_max_kl: float = 0.5, seed: int = 0,
                     capture=None) -> IslandStep:
    """Island-model RBC-PF step (Vergé et al.): every rank runs a whole
    local filter with local KL-triggered systematic resampling per block
    (no communication; the occlusion follows through the sensor's
    ``gather_occlusion``), and carries its island's log-weight, the
    logsumexp increments of its blocks. Only when the island weights
    degenerate (KL over the islands above ``island_max_kl``) are whole
    blocks exchanged, with a shared draw. The posterior mean and ESS
    weight each island's normalized particles by its island weight
    (reduced sums). The returned log weights carry the island offset, so
    the global weight vector is the full filter's. ``capture``: see
    :func:`resolve_capture`."""
    body = _IslandBody(loglik_fn, trans_params, dt, max_kl_divergence,
                       island_max_kl)
    return IslandStep(comm, body, seed, capture)
