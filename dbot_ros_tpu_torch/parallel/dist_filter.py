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

**Occlusion leaf.** The sensor's hooks (``gather_occlusion`` with
``num_in``, ``where_occlusion``, ``concat_occlusion``,
``particle_stride``: the fused sensor's ``(n_pad, p_pad)`` map and lazy
ages) or the ``(P, N)`` defaults. The fused sensor's map is updated in
place by its compaction scatter: a caller that steps one belief through
two step functions clones it first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from dbot_ros_tpu_torch.filters.rbcpf import BlockNoise, ParticleBelief
from dbot_ros_tpu_torch.models.transition import (TransitionParams,
                                                  sample_transition)
from dbot_ros_tpu_torch.parallel import comm as comm_mod

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
    """(gather, where, concat, stride): the sensor's occlusion hooks, or
    the (P, N) defaults (dist_filter.py:86-118 of the reference)."""
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
    return gather, where, concat, stride


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


def _resample_block(states, log_w, occ, old_loglik, *, do, ln, u, comm,
                    exchange, max_hops, capacity, hooks, trace):
    """Global systematic resampling of one coordinate block's aftermath →
    (states, log_w, occ, old_loglik). Every exchange gives the all-gather
    resampler's output bit for bit; they differ only in how parent
    occlusion rows cross ranks. The trigger ``do`` where-selects between
    the systematic parents and the identity; the counts exchange runs its
    collectives every frame, the others only on resample frames. The
    path taken is appended to ``trace`` (``"local"``, ``"none"``,
    ``"all_gather"``, ``"ring"``, ``"neighbor"``, ``"counts"``)."""
    occ_gather, occ_where, occ_concat, occ_stride = hooks
    idx, S = comm.rank, comm.size
    p_local, K = states.shape[:2]
    dev = log_w.device
    # weights, parent states and running logliks in one all-gather
    packed = torch.cat([torch.exp(ln)[:, None], old_loglik[:, None],
                        states.reshape(p_local, K * 13)], dim=1)
    packed_all = comm.all_gather(packed, tiled=True)
    w_all = packed_all[:, 0].contiguous()
    cdf = torch.cumsum(w_all, 0)
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

    parents = shard_parents(idx)
    picked = packed_all.index_select(0, parents)
    new_old_loglik = picked[:, 1].contiguous()
    new_states = picked[:, 2:].reshape(p_local, K, 13)
    new_log_w = torch.where(do, torch.zeros_like(log_w), log_w)

    owner = torch.div(parents, p_local, rounding_mode="floor")
    local_idx = torch.clamp(parents - idx * p_local, 0, p_local - 1)

    if S == 1:
        # one rank: every parent is local, the exchange is the lineage
        # gather (no collective, no host read)
        trace.append("local")
        return (new_states, new_log_w, occ_gather(occ, local_idx),
                new_old_loglik)

    def ppermute(x, pairs):
        return _tree_map(lambda leaf: comm.ppermute(leaf, pairs), x)

    def pluck(out, blk, src):
        """Copy the rows of ``parents`` owned by rank ``src`` from blk."""
        src_idx = torch.clamp(parents - src * p_local, 0, p_local - 1)
        mask = (parents >= src * p_local) & (parents < (src + 1) * p_local)
        return occ_where(mask, occ_gather(blk, src_idx), out)

    def full_ring(occ):
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

    # `do` is kl > max_kl with kl from all-reduced sums: the same on every
    # rank, so each host branch on it keeps the collective order uniform
    if exchange != "counts" and not bool(do):
        trace.append("none")
        return new_states, new_log_w, occ, new_old_loglik
    if exchange == "all_gather":
        trace.append("all_gather")
        stride = occ_stride(p_local)
        occ_all = _tree_map(comm.all_gather, occ)           # (S, ...)
        blocks = [_tree_map(lambda x, s=s: x[s], occ_all) for s in range(S)]
        combined = occ_concat(blocks, p_local)
        gidx = owner * stride + (parents - owner * p_local)
        new_occ = occ_gather(combined, gidx, num_in=S * stride)
        return new_states, new_log_w, new_occ, new_old_loglik

    if exchange == "ring" or (exchange == "neighbor"
                              and S <= 2 * max_hops + 1):
        trace.append("ring")
        return new_states, new_log_w, full_ring(occ), new_old_loglik

    if exchange == "neighbor":
        d = owner - idx
        span = comm.all_reduce(torch.maximum(d.max(), -d.min()), "max")
        # span comes from a max-reduce: the same branch on every rank
        if int(span) > max_hops:
            trace.append("ring")
            return new_states, new_log_w, full_ring(occ), new_old_loglik
        trace.append("neighbor")
        out = _tree_map(torch.zeros_like, occ)
        out = pluck(out, occ, idx)
        for h in range(1, max_hops + 1):
            for s in (h, -h):
                # blk on rank i is rank (i + s) mod S's block
                blk = ppermute(occ, [((i + s) % S, i) for i in range(S)])
                out = pluck(out, blk, (idx + s) % S)
        return new_states, new_log_w, out, new_old_loglik

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
        p_d = shard_parents(dest)
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
    Cs = occ_stride(C)
    chg_mine = torch.cat([one, parents[1:] != parents[:-1]])
    cidx = torch.zeros((p_local,), dtype=torch.int64, device=dev)
    for h, s in enumerate(hops):
        src = (idx - s) % S
        mask = owner == src
        slotm = torch.cumsum((mask & chg_mine).to(torch.int64), 0) - 1
        cidx = torch.where(mask, h * Cs + slotm, cidx)

    loc = occ_gather(occ, local_idx)

    def counts_path(loc):
        bufs = []
        for s, rows in zip(hops, plans):
            buf = occ_gather(occ, rows, num_in=occ_stride(p_local))
            bufs.append(ppermute(buf, [(i, (i + s) % S) for i in range(S)]))
        combined = occ_concat(bufs, C)
        remote = occ_gather(combined, cidx, num_in=Cs * len(hops))
        return occ_where(owner != idx, remote, loc)

    ok = max_hops >= S // 2 and C >= p_local      # overflow impossible
    if not ok:
        # span and m_max come from a max-reduce: the same on every rank
        span, m_max = (int(v) for v in span_m.tolist())
        ok = span <= max_hops and m_max <= C
    trace.append("counts" if ok else "ring")
    new_occ = counts_path(loc) if ok else full_ring(occ)
    return new_states, new_log_w, new_occ, new_old_loglik


def _draw_noise(num_objects, p_local, local_gen, shared_gen, dev):
    """Per-block noise from the generators: e1, e2 rank-local, u shared
    (one draw per block on every rank)."""
    out = []
    for _ in range(num_objects):
        e1 = torch.randn((p_local, 6), generator=local_gen, device=dev)
        e2 = torch.randn((p_local, 6), generator=local_gen, device=dev)
        u = torch.rand((), generator=shared_gen, device=dev)
        out.append(BlockNoise(e1=e1, e2=e2, u=u))
    return out


def _generators(seed: int, stream: int, rank: int, dev):
    """(rank-local, shared) generators of one scene: the shared one is
    seeded alike on every rank of the group."""
    local = torch.Generator(device=dev)
    local.manual_seed((int(seed) * 1_000_003 + stream) * 65_537 + rank + 1)
    shared = torch.Generator(device=dev)
    shared.manual_seed((int(seed) * 1_000_003 + stream) * 65_537)
    return local, shared


def _make_step_local(loglik_fn, trans_params, dt, max_kl_divergence,
                     exchange, max_hops, capacity):
    """One scene's step body on one rank: (comm, states, log_w, occ,
    z_obs, noise) → (states, log_w, occ, mean_state (K, 13), ess). Shared
    by the particle step and the multi-scene step."""
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange mode: {exchange!r}")
    hooks = _occ_hooks(loglik_fn)

    def step_one(comm, states, log_w, occ, z_obs, noise, trace):
        num_objects = states.shape[1]
        old_loglik = torch.zeros_like(log_w)
        for b in range(num_objects):
            nb = noise[b]
            new_block = sample_transition(states[:, b], dt, trans_params,
                                          e1=nb.e1, e2=nb.e2)
            states = states.clone()
            states[:, b] = new_block
            commit = b == num_objects - 1
            loglik, occ_post = loglik_fn(states, occ, z_obs, dt,
                                         commit=commit)
            if commit:
                occ = occ_post
            log_w = log_w + loglik - old_loglik
            old_loglik = loglik

            lse, _, kl = _global_log_normalizers(log_w, comm)
            u = torch.as_tensor(nb.u, dtype=torch.float32,
                                device=log_w.device)
            states, log_w, occ, old_loglik = _resample_block(
                states, log_w, occ, old_loglik,
                do=kl > max_kl_divergence, ln=log_w - lse, u=u, comm=comm,
                exchange=exchange, max_hops=max_hops, capacity=capacity,
                hooks=hooks, trace=trace)

        lse2, s2, _ = _global_log_normalizers(log_w, comm)
        w = torch.exp(log_w - lse2)
        mean_state = _psum_mean_state(states, w, comm)
        return states, log_w, occ, mean_state, 1.0 / s2

    return step_one


class DistributedStep:
    """``step(belief, z_obs, noise=None) → (belief, mean_state (K, 13),
    ess)`` on this rank's block (see :func:`make_distributed_step`).
    ``noise`` is one :class:`BlockNoise` per object with this rank's
    ``e1``/``e2`` (L, 6) and the shared ``u``; without it they come from
    ``generator`` (rank-local) and ``shared_generator``. ``paths`` holds
    the exchange path each block of the last call took."""

    def __init__(self, comm, body, seed):
        self.comm = comm
        self._body = body
        self.seed = seed
        self.generator = self.shared_generator = None
        self.paths = []

    def _ensure_generators(self, dev):
        if self.generator is None:
            self.generator, self.shared_generator = _generators(
                self.seed, 0, self.comm.rank, dev)

    def __call__(self, belief: ParticleBelief, z_obs,
                 noise: Optional[Sequence[BlockNoise]] = None):
        if noise is None:
            dev = belief.log_weights.device
            self._ensure_generators(dev)
            noise = _draw_noise(belief.num_objects, belief.num_particles,
                                self.generator, self.shared_generator, dev)
        self.paths = []
        states, log_w, occ, mean_state, ess = self._body(
            self.comm, belief.states, belief.log_weights, belief.occlusion,
            z_obs, noise, self.paths)
        return (ParticleBelief(states=states, log_weights=log_w,
                               occlusion=occ), mean_state, ess)


def make_distributed_step(comm, loglik_fn: Callable,
                          trans_params: TransitionParams, dt: float,
                          max_kl_divergence: float = 1.0,
                          exchange: str = "counts", max_hops: int = 1,
                          capacity: int = None,
                          seed: int = 0) -> DistributedStep:
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
    states always travel by all-gather.
    """
    body = _make_step_local(loglik_fn, trans_params, dt, max_kl_divergence,
                            exchange, max_hops, capacity)
    return DistributedStep(comm, body, seed)


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
    own pair of generators)."""

    def __init__(self, groups, body, seed):
        self.groups = groups
        self._body = body
        self.seed = seed
        self._gens = None
        self.paths = []

    def __call__(self, beliefs, z_obs, noise=None):
        comm = self.groups.particles
        first = (self.groups.scene_index * len(beliefs))
        if noise is None:
            dev = beliefs[0].log_weights.device
            if self._gens is None:
                self._gens = [_generators(self.seed, first + s + 1,
                                          comm.rank, dev)
                              for s in range(len(beliefs))]
            noise = [_draw_noise(b.num_objects, b.num_particles, g[0], g[1],
                                 dev) for b, g in zip(beliefs, self._gens)]
        out, means, ess = [], [], []
        self.paths = []
        # scenes carry no collectives: a rank steps its scenes in turn,
        # each over its particle subgroup
        for s, belief in enumerate(beliefs):
            st, lw, occ, ms, e = self._body(
                comm, belief.states, belief.log_weights, belief.occlusion,
                z_obs[s], noise[s], self.paths)
            out.append(ParticleBelief(states=st, log_weights=lw,
                                      occlusion=occ))
            means.append(ms)
            ess.append(e)
        return out, torch.stack(means), torch.stack(ess)


def make_multi_scene_step(groups: SceneGroups, loglik_fn: Callable,
                          trans_params: TransitionParams, dt: float,
                          max_kl_divergence: float = 1.0,
                          exchange: str = "counts", max_hops: int = 1,
                          capacity: int = None,
                          seed: int = 0) -> MultiSceneStep:
    """Independent scenes over ``make_scene_groups``' layout: each scene
    runs the distributed step of :func:`make_distributed_step` over its
    particle subgroup; the scene axis carries no collectives.
    ``torch.func.vmap`` cannot batch the fused sensor (its kernels are
    ctypes calls on raw pointers), so a rank loops over its scenes."""
    body = _make_step_local(loglik_fn, trans_params, dt, max_kl_divergence,
                            exchange, max_hops, capacity)
    return MultiSceneStep(groups, body, seed)


# ---------------------------------------------------------------------------
# Island model: no per-particle exchange on the common path
# ---------------------------------------------------------------------------

class IslandStep:
    """``step(belief, z_obs, noise=None, island_u=None) → (belief,
    mean_state, ess)``: ``noise`` per block with this rank's ``e1``,
    ``e2`` and its own local resampling ``u``; ``island_u`` the shared
    uniform of the island resampling. Without them: ``e1``, ``e2``, ``u``
    from the rank-local generator, ``island_u`` from the shared one (one
    draw a step on every rank)."""

    def __init__(self, comm, body, seed):
        self.comm = comm
        self._body = body
        self.seed = seed
        self.generator = self.shared_generator = None

    def __call__(self, belief, z_obs, noise=None, island_u=None):
        dev = belief.log_weights.device
        if noise is None or island_u is None:
            if self.generator is None:
                self.generator, self.shared_generator = _generators(
                    self.seed, 0, self.comm.rank, dev)
        if noise is None:
            noise = _draw_noise(belief.num_objects, belief.num_particles,
                                self.generator, self.generator, dev)
        if island_u is None:
            island_u = torch.rand((), generator=self.shared_generator,
                                  device=dev)
        states, log_w, occ, mean_state, ess = self._body(
            self.comm, belief.states, belief.log_weights, belief.occlusion,
            z_obs, noise, torch.as_tensor(island_u, dtype=torch.float32,
                                          device=dev))
        return (ParticleBelief(states=states, log_weights=log_w,
                               occlusion=occ), mean_state, ess)


def make_island_step(comm, loglik_fn: Callable,
                     trans_params: TransitionParams, dt: float,
                     max_kl_divergence: float = 1.0,
                     island_max_kl: float = 0.5, seed: int = 0) -> IslandStep:
    """Island-model RBC-PF step (Vergé et al.): every rank runs a whole
    local filter with local KL-triggered systematic resampling per block
    (no communication; the occlusion follows through the sensor's
    ``gather_occlusion``), and carries its island's log-weight, the
    logsumexp increments of its blocks. Only when the island weights
    degenerate (KL over the islands above ``island_max_kl``) are whole
    blocks exchanged, with a shared draw. The posterior mean and ESS
    weight each island's normalized particles by its island weight
    (reduced sums). The returned log weights carry the island offset, so
    the global weight vector is the full filter's."""
    occ_gather = _occ_hooks(loglik_fn)[0]

    def body(comm, states, log_w, occ, z_obs, noise, island_u):
        idx, n_islands = comm.rank, comm.size
        p_local, num_objects = states.shape[:2]
        dev = log_w.device
        log_p = math.log(float(p_local))
        ar = torch.arange(p_local, dtype=torch.float32, device=dev)
        ar_i = torch.arange(p_local, device=dev)
        old_loglik = torch.zeros_like(log_w)
        b_acc = torch.zeros((), device=dev)
        ln_local = log_w
        for blk in range(num_objects):
            nb = noise[blk]
            new_block = sample_transition(states[:, blk], dt, trans_params,
                                          e1=nb.e1, e2=nb.e2)
            states = states.clone()
            states[:, blk] = new_block
            commit = blk == num_objects - 1
            loglik, occ_post = loglik_fn(states, occ, z_obs, dt,
                                         commit=commit)
            if commit:
                occ = occ_post
            ln_local = ln_local + loglik - old_loglik
            old_loglik = loglik

            # island decomposition: b = local logsumexp, ln sums to 1
            m_loc = torch.max(ln_local)
            b = m_loc + torch.log(torch.sum(torch.exp(ln_local - m_loc)))
            b_acc = b_acc + b
            ln_local = ln_local - b
            w_loc = torch.exp(ln_local)
            kl_local = (torch.sum(w_loc * torch.where(w_loc > 0, ln_local,
                                                      0.0)) + log_p)
            # the trigger is island-local and touches no collective: a
            # where-select, no host read
            do_l = kl_local > max_kl_divergence
            u = torch.as_tensor(nb.u, dtype=torch.float32, device=dev)
            p_rs = torch.clamp(torch.searchsorted(
                torch.cumsum(w_loc, 0), (ar + u) / p_local, side="left"),
                0, p_local - 1)
            parents = torch.where(do_l, p_rs, ar_i)
            states = states.index_select(0, parents)
            occ = occ_gather(occ, parents)
            old_loglik = old_loglik.index_select(0, parents)
            ln_local = torch.where(do_l, torch.full_like(ln_local, -log_p),
                                   ln_local)

        # island bookkeeping: scalar collectives only
        m_b = comm.all_reduce(b_acc, "max")
        sum_b = comm.all_reduce(torch.exp(b_acc - m_b))
        bn = b_acc - (m_b + torch.log(sum_b))
        w_isl = torch.exp(bn)
        kl_islands = (comm.all_reduce(w_isl * torch.where(w_isl > 0, bn,
                                                          0.0))
                      + math.log(float(n_islands)))
        # kl_islands comes from an all-reduce: the same branch everywhere
        if bool(kl_islands > island_max_kl):
            bn_all = comm.all_gather(bn)                         # (S,)
            cdf = torch.cumsum(torch.exp(bn_all), 0)
            pos = ((torch.tensor(float(idx), device=dev) + island_u)
                   / n_islands)
            src = torch.clamp(torch.searchsorted(cdf, pos[None],
                                                 side="left")[0],
                              0, n_islands - 1)
            states = comm.all_gather(states)[src]
            occ = _tree_map(lambda x: comm.all_gather(x)[src], occ)
            ln_local = comm.all_gather(ln_local)[src]
            bn = torch.full_like(bn, -math.log(float(n_islands)))

        log_w_out = bn + ln_local
        lse2, s2, _ = _global_log_normalizers(log_w_out, comm)
        w = torch.exp(log_w_out - lse2)
        mean_state = _psum_mean_state(states, w, comm, power_iters=10)
        return states, log_w_out, occ, mean_state, 1.0 / s2

    return IslandStep(comm, body, seed)
