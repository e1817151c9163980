"""One rank of the multi-rank port tests (tests/test_torch_multirank.py).

Holds no tests: the parent test starts one process per rank,

    python -m tests.test_torch_dist_worker IN.npz OUT_DIR RANK WORLD PORT

and each rank joins a gloo group on the CPU, runs every case of
``CASES`` in order on the inputs in ``IN.npz`` and writes what it got to
``OUT_DIR/rank<RANK>.npz`` (keys ``<case>.<name>``). Every step runs
through its step program (over gloo eagerly: ``capture`` is False)
beside a twin step run by its ``plain`` body from the same belief and
draws; a case records whether the two were equal bit for bit, paths
included (``plain_equal``). On the first error
it writes what it has and the traceback, and exits non-zero. Imports
torch and the port only (no JAX): a spawned rank must run on a machine
without it.
"""

import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.filters import rbcpf
from dbot_ros_tpu_torch.filters.rbcpf import BlockNoise, ParticleBelief
from dbot_ros_tpu_torch.models.sensor import make_rb_sensor
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.parallel import comm as comm_mod
from dbot_ros_tpu_torch.parallel import dist_filter, dryrun, scaling

GROUP_TIMEOUT_S = 60.0
HANG_TIMEOUT_S = 3.0
MODES = ("all_gather", "ring", "neighbor", "counts")


def t(x):
    return torch.as_tensor(np.asarray(x))


def n(x):
    """A copy on the host: a step's results are its program's buffers
    (the belief is donated), which the next step overwrites."""
    return x.detach().cpu().float().numpy().copy()


class Inputs:
    """The parent's arrays, and the scene built from them."""

    def __init__(self, path):
        self.data = dict(np.load(path))

    def group(self, prefix):
        return {k[len(prefix) + 1:]: v for k, v in self.data.items()
                if k.startswith(prefix + ".")}

    def scene(self, num_objects=1):
        meshes = [interop.mesh_from_numpy(self.group(f"mesh{k}"))
                  for k in range(num_objects)]
        cam = interop.camera_from_numpy(self.group("cam"))
        bp = interop.beam_params_from_numpy(self.group("bp"))
        op = interop.occlusion_params_from_numpy(self.group("op"))
        tp = interop.transition_params_from_numpy(self.group("tp"))
        return meshes, cam, bp, op, tp

    def sensor(self, kind, num_objects=1):
        meshes, cam, bp, op, tp = self.scene(num_objects)
        if kind == "fused":
            return make_rb_sensor(meshes, cam, bp, op, backend="pallas",
                                  nb=32, occ_dtype=torch.bfloat16), tp, cam
        return make_rb_sensor(meshes, cam, bp, op, tri_chunk=128), tp, cam


def block(comm, x):
    L = x.shape[0] // comm.size
    return x[comm.rank * L:(comm.rank + 1) * L]


def belief_of(comm, sensor, cam, states, lw, occ_pn, age=None):
    """This rank's rows of a global belief, its occlusion as the sensor
    keeps it (the fused sensor's map with ``age``, zero by default)."""
    occ = block(comm, occ_pn)
    L = occ.shape[0]
    if hasattr(sensor, "init_occlusion"):
        leaf = interop.occlusion_from_jax(
            occ, L, cam.num_pixels, sensor.nb,
            age=(np.zeros(fs._round_up(cam.num_pixels, sensor.nb))
                 if age is None else age), occ_dtype=sensor.occ_dtype)
    else:
        leaf = t(occ).float()
    return ParticleBelief(states=t(block(comm, states)).float(),
                          log_weights=t(block(comm, lw)).float(),
                          occlusion=leaf)


def clone(belief):
    occ = belief.occlusion
    occ = (tuple(x.clone() for x in occ) if isinstance(occ, tuple)
           else occ.clone())
    return ParticleBelief(belief.states.clone(), belief.log_weights.clone(),
                          occ)


def replay(noise, comm, frame):
    """Per-block noise of this rank from the parent's arrays: e1/e2
    ``(F, S, K, L, 6)``, u ``(F, K)`` shared or ``(F, S, K)`` per rank."""
    e1, e2, u = noise
    u = u[:, comm.rank] if u.ndim == 3 else u
    return [BlockNoise(e1=t(e1[frame, comm.rank, b]),
                       e2=t(e2[frame, comm.rank, b]),
                       u=t(u[frame, b])) for b in range(u.shape[1])]


def local_noise(comm, num_objects, L, seed):
    """e1/e2 from a rank-local generator, u shared (the same seed on
    every rank)."""
    g = torch.Generator().manual_seed(seed * 100 + comm.rank + 1)
    gs = torch.Generator().manual_seed(seed)
    return [BlockNoise(e1=torch.randn((L, 6), generator=g),
                       e2=torch.randn((L, 6), generator=g),
                       u=torch.rand((), generator=gs))
            for _ in range(num_objects)]


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, ParticleBelief):
        return leaves([x.states, x.log_weights, x.occlusion])
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in leaves(y)]
    return []


def same(a, b):
    """Whether two step results are equal bit for bit (dtypes too)."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def occ_record(sensor, occ, L):
    """(map bits or values, ages, (L, N) view) of an occlusion leaf."""
    if isinstance(occ, tuple):
        q, age = occ
        return (q.view(torch.int16).numpy().copy()
                if q.dtype == torch.bfloat16 else n(q)), n(age), \
            n(sensor.occlusion_as_pn(occ, L))
    return n(occ), np.zeros(0, np.float32), n(occ)


def pre_exchange(sensor, tp, belief, z, noise):
    """What a one-object step's exchange starts from on this rank: the
    proposal's states and the sensor's committed leaf (map bits, ages and
    its (L, N) materialized view), from a copy of ``belief``."""
    states = rbcpf.propose_block(belief.states, 0, 1 / 30, tp, noise[0])
    _, leaf = sensor(states, clone(belief).occlusion, t(z), 1 / 30)
    q, age, pn = occ_record(sensor, leaf, belief.num_particles)
    return {"pre.states": n(states), "pre.q": q, "pre.age": age,
            "pre.occ": pn}


def run_modes(comm, sensor, tp, belief, frames, noises, max_kl, modes=MODES,
              **kw):
    """Every exchange mode from the same belief and noise over the frames
    → {mode.key: array}."""
    out = {}
    L = belief.num_particles
    for mode in modes:
        step, twin = (dist_filter.make_distributed_step(
            comm, sensor, tp, 1 / 30, max_kl_divergence=max_kl,
            exchange=mode, **kw) for _ in range(2))
        assert not step.capture
        b, ref = clone(belief), clone(belief)
        rec = {k: [] for k in ("states", "lw", "q", "age", "occ", "mean",
                               "ess")}
        paths, equal = [], []
        for f, z in enumerate(frames):
            got = step(b, t(z), noise=noises[f])
            ref, *want = twin.plain(ref, t(z), noise=noises[f])
            equal.append(same(got, [ref, *want])
                         and step.paths == twin.paths)
            b, mean, ess = got
            q, age, pn = occ_record(sensor, b.occlusion, L)
            for k, v in (("states", n(b.states)), ("lw", n(b.log_weights)),
                         ("q", q), ("age", age), ("occ", pn),
                         ("mean", n(mean)), ("ess", n(ess))):
                rec[k].append(v)
            paths.append(",".join(step.paths))
        for k, v in rec.items():
            out[f"{mode}.{k}"] = np.stack(v)
        out[f"{mode}.paths"] = np.array(paths)
        out[f"{mode}.plain_equal"] = np.array(equal)
    return out


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def case_jax_parity(comm, inp, name):
    """All four exchanges over the parent's frames with JAX's draws."""
    d = inp.group(name)
    K = int(d["num_objects"])
    sensor, tp, cam = inp.sensor("plain", K)
    belief = belief_of(comm, sensor, cam, d["states"], d["lw"], d["occ"])
    F = d["z"].shape[0]
    noises = [replay((d["e1"], d["e2"], d["u"]), comm, f) for f in range(F)]
    return run_modes(comm, sensor, tp, belief, d["z"], noises,
                     float(d["max_kl"]))


def case_skew(comm, inp, name):
    """The four exchanges on one forced frame (test_parallel.py's skew
    cases), with the plain or the fused sensor."""
    d = inp.group(name)
    sensor, _, cam = inp.sensor(str(d["sensor"]))
    # a still transition: the weights are the skew, not the draws
    tp = interop.transition_params_from_numpy(inp.group("quiet"))
    belief = belief_of(comm, sensor, cam, d["states"], d["lw"], d["occ"])
    noise = local_noise(comm, 1, belief.num_particles, 17)
    kw = {"max_hops": 1}
    if "capacity" in d:
        kw["capacity"] = int(d["capacity"])
    modes = tuple(str(m) for m in d["modes"])
    return run_modes(comm, sensor, tp, belief, d["z"][None], [noise],
                     float(d["max_kl"]), modes, **kw)


def case_generators(comm, inp, name):
    """Without noise: u from the shared generator (the same draws on every
    rank), e1/e2 from the rank-local one; two steps with one seed agree,
    and the programmed step draws what the plain one does."""
    d = inp.group(name)
    sensor, tp, cam = inp.sensor("plain")
    belief = belief_of(comm, sensor, cam, d["states"], d["lw"], d["occ"])
    outs, equal = [], []
    for mode in ("all_gather", "counts"):
        step, twin = (dist_filter.make_distributed_step(
            comm, sensor, tp, 1 / 30, max_kl_divergence=0.01, exchange=mode,
            seed=5) for _ in range(2))
        got = step(clone(belief), t(d["z"]))
        equal.append(same(got, twin.plain(clone(belief), t(d["z"])))
                     and torch.equal(step.generator.get_state(),
                                     twin.generator.get_state())
                     and torch.equal(step.shared_generator.get_state(),
                                     twin.shared_generator.get_state()))
        b, mean, _ = got
        outs.append((b, mean))
        shared = torch.rand((4,), generator=step.shared_generator)
        local = torch.rand((4,), generator=step.generator)
    return {"states": np.stack([n(b.states) for b, _ in outs]),
            "occ": np.stack([n(b.occlusion) for b, _ in outs]),
            "mean": np.stack([n(m) for _, m in outs]),
            "shared_all": n(comm.all_gather(shared)),
            "local_all": n(comm.all_gather(local)),
            "plain_equal": np.array(equal)}


def case_island(comm, inp, name):
    """The island step with JAX's draws (the island resample fires), and
    the same frames with a trigger that never fires (``quiet.*``)."""
    d = inp.group(name)
    sensor, tp, cam = inp.sensor("plain")
    start = belief_of(comm, sensor, cam, d["states"], d["lw"], d["occ"])
    out = {}
    for prefix, island_max_kl in (("", float(d["island_max_kl"])),
                                  ("quiet.", 1e6)):
        step, twin = (dist_filter.make_island_step(
            comm, sensor, tp, 1 / 30, max_kl_divergence=float(d["max_kl"]),
            island_max_kl=island_max_kl) for _ in range(2))
        b, ref = clone(start), clone(start)
        rec = {k: [] for k in ("states", "lw", "occ", "mean", "ess")}
        paths, equal = [], []
        for f, z in enumerate(d["z"]):
            noise = replay((d["e1"], d["e2"], d["u"]), comm, f)
            kw = dict(noise=noise, island_u=t(d["island_u"][f]))
            got = step(b, t(z), **kw)
            ref, *want = twin.plain(ref, t(z), **kw)
            equal.append(same(got, [ref, *want])
                         and step.paths == twin.paths)
            paths.append(",".join(step.paths))
            b, mean, ess = got
            for k, v in (("states", n(b.states)), ("lw", n(b.log_weights)),
                         ("occ", n(b.occlusion)), ("mean", n(mean)),
                         ("ess", n(ess))):
                rec[k].append(v)
        out.update({prefix + k: np.stack(v) for k, v in rec.items()})
        out[prefix + "paths"] = np.array(paths)
        out[prefix + "plain_equal"] = np.array(equal)
    return out


def case_scenes(comm, inp, name):
    """Two scenes × two ranks, scene-major: this rank's block of its
    scene, with that scene's JAX draws."""
    d = inp.group(name)
    sensor, tp, cam = inp.sensor("plain")
    groups = dist_filter.make_scene_groups(2, comm.size // 2,
                                           GROUP_TIMEOUT_S)
    pc = groups.particles
    s = groups.scene_index
    beliefs = dist_filter.init_multi_scene_belief(
        groups, d["poses"], 2, int(d["particles"]), cam.num_pixels,
        sensor=sensor, device="cpu")
    assert len(beliefs) == 1
    step, twin = (dist_filter.make_multi_scene_step(
        groups, sensor, tp, 1 / 30, max_kl_divergence=float(d["max_kl"]))
        for _ in range(2))
    refs = [clone(x) for x in beliefs]
    rec = {k: [] for k in ("states", "lw", "occ", "mean", "ess")}
    equal = []
    for f in range(d["z"].shape[0]):
        noise = replay((d["e1"][:, s], d["e2"][:, s], d["u"][:, s]), pc, f)
        got = step(beliefs, t(d["z"][f, s:s + 1]), noise=[noise])
        refs, *want = twin.plain(refs, t(d["z"][f, s:s + 1]), noise=[noise])
        equal.append(same(got, [refs, *want]) and step.paths == twin.paths)
        beliefs, mean, ess = got
        b = beliefs[0]
        for k, v in (("states", n(b.states)), ("lw", n(b.log_weights)),
                     ("occ", n(b.occlusion)), ("mean", n(mean[0])),
                     ("ess", n(ess[0]))):
            rec[k].append(v)
    out = {k: np.stack(v) for k, v in rec.items()}
    out["scene"] = np.array(s)
    out["particle_rank"] = np.array(pc.rank)
    out["plain_equal"] = np.array(equal)
    return out


def case_ages(comm, inp, name):
    """World size 2 (ranks 0 and 1), fused sensor, the two ranks' clouds
    1.5 cm apart, one frame without a resample: the leaf before the
    exchange (the sensor's own, whose ages differ between the ranks) and
    after each exchange."""
    d = inp.group(name)
    pair = comm_mod.new_group([0, 1], GROUP_TIMEOUT_S)
    if pair is None:
        return {}
    sensor, tp, cam = inp.sensor("fused")
    belief = belief_of(pair, sensor, cam, d["states"], d["lw"], d["occ"])
    noise = local_noise(pair, 1, belief.num_particles, 3)
    out = pre_exchange(sensor, tp, belief, d["z"], noise)
    out.update(run_modes(pair, sensor, tp, belief, d["z"][None], [noise],
                         1e6))
    return out


def case_ages_cross(comm, inp, name):
    """Four ranks, fused sensor, every particle at one pose under a still
    transition (the weights are the skew given), a map whose columns
    differ off the silhouette and ages that differ by rank: one frame in
    every exchange mode, the leaf before the exchange beside it."""
    d = inp.group(name)
    sensor, _, cam = inp.sensor("fused")
    tp = interop.transition_params_from_numpy(inp.group("quiet"))
    belief = belief_of(comm, sensor, cam, d["states"], d["lw"], d["occ"],
                       age=d["age"][comm.rank])
    noise = local_noise(comm, 1, belief.num_particles, 23)
    out = pre_exchange(sensor, tp, belief, d["z"], noise)
    out.update(run_modes(comm, sensor, tp, belief, d["z"][None], [noise],
                         float(d["max_kl"]), max_hops=1))
    return out


def case_ages_island(comm, inp, name):
    """The island step with the fused sensor and ages that differ by rank:
    all weight on island 2, so every rank takes island 2's block."""
    d = inp.group(name)
    sensor, _, cam = inp.sensor("fused")
    tp = interop.transition_params_from_numpy(inp.group("quiet"))
    start = belief_of(comm, sensor, cam, d["states"], d["lw"], d["occ"],
                      age=d["age"][comm.rank])
    noise = local_noise(comm, 1, start.num_particles, 29)
    step, twin = (dist_filter.make_island_step(
        comm, sensor, tp, 1 / 30, max_kl_divergence=0.5,
        island_max_kl=0.3) for _ in range(2))
    kw = dict(noise=noise, island_u=torch.tensor(0.5))
    got = step(clone(start), t(d["z"]), **kw)
    want = twin.plain(clone(start), t(d["z"]), **kw)
    b = got[0]
    q, age, pn = occ_record(sensor, b.occlusion, b.num_particles)
    return {"states": n(b.states), "q": q, "age": age, "occ": pn,
            "paths": np.array(step.paths),
            "plain_equal": np.array([same(got, want)
                                     and step.paths == twin.paths])}


def case_ages_scenes(comm, inp, name):
    """Two scenes × two ranks, fused sensor, ages that differ by rank, one
    resampling frame a scene (the counts exchange within each scene's
    pair): the leaf before the exchange beside the step's."""
    d = inp.group(name)
    sensor, _, cam = inp.sensor("fused")
    tp = interop.transition_params_from_numpy(inp.group("quiet"))
    groups = dist_filter.make_scene_groups(2, comm.size // 2,
                                           GROUP_TIMEOUT_S)
    pc, s = groups.particles, groups.scene_index
    belief = belief_of(pc, sensor, cam, d["states"][s], d["lw"][s],
                       d["occ"][s], age=d["age"][comm.rank])
    noise = local_noise(pc, 1, belief.num_particles, 31 + s)
    out = pre_exchange(sensor, tp, belief, d["z"][s], noise)
    step, twin = (dist_filter.make_multi_scene_step(
        groups, sensor, tp, 1 / 30, max_kl_divergence=float(d["max_kl"]))
        for _ in range(2))
    got = step([clone(belief)], t(d["z"][s:s + 1]), noise=[noise])
    want = twin.plain([clone(belief)], t(d["z"][s:s + 1]), noise=[noise])
    b = got[0][0]
    q, age, pn = occ_record(sensor, b.occlusion, b.num_particles)
    out.update({"states": n(b.states), "q": q, "age": age, "occ": pn,
                "scene": np.array(s), "paths": np.array(step.paths),
                "plain_equal": np.array([same(got, want)
                                         and step.paths == twin.paths])})
    return out


def case_scaling(comm, inp, name):
    d = inp.group(name)
    sensor, tp, cam = inp.sensor("plain")
    res = scaling.run_scaling(sensor, tp, cam, t(d["pose"]),
                              particles_per_device=16, device_counts=[1, 2],
                              frames=3, z_obs=t(d["z"]))
    return {k: np.asarray(v, np.float64) for k, v in res.to_dict().items()}


def case_dryrun(comm, inp, name):
    out = dryrun.dryrun(torch.device("cpu"), GROUP_TIMEOUT_S)
    return {"cases": np.array(out["cases"]), "world": np.array(out["world"])}


def case_hang(comm, inp, name):
    """Rank 1 skips a collective of a 2-rank group with a short timeout:
    rank 0 must raise within it, not hang."""
    pair = comm_mod.new_group([0, 1], HANG_TIMEOUT_S)
    if comm.rank == 1:
        time.sleep(HANG_TIMEOUT_S + 3.0)
        return {"skipped": np.array(1)}
    if comm.rank != 0:
        return {}
    t0 = time.perf_counter()
    try:
        pair.all_reduce(torch.ones(3))
        raised = ""
    except RuntimeError as e:
        raised = str(e)[:300]
    return {"seconds": np.array(time.perf_counter() - t0),
            "timeout": np.array(HANG_TIMEOUT_S), "raised": np.array(raised)}


CASES = [
    ("parity_k1", case_jax_parity),
    ("parity_k2", case_jax_parity),
    ("skew_plain_mild", case_skew),
    ("skew_plain_degenerate", case_skew),
    ("skew_fused_mild", case_skew),
    ("skew_fused_degenerate", case_skew),
    ("overflow", case_skew),
    ("generators", case_generators),
    ("island", case_island),
    ("scenes", case_scenes),
    ("ages", case_ages),
    ("ages_still", case_ages_cross),
    ("ages_fits", case_ages_cross),
    ("ages_overflow", case_ages_cross),
    ("ages_island", case_ages_island),
    ("ages_scenes", case_ages_scenes),
    ("scaling", case_scaling),
    ("dryrun", case_dryrun),
    ("hang", case_hang),           # last: it leaves a group broken
]


def main(argv):
    in_path, out_dir, rank, world, port = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    comm = comm_mod.init_process_group("gloo", rank, world, int(port),
                                       GROUP_TIMEOUT_S)
    inp = Inputs(in_path)
    out, seconds, error = {}, {}, ""
    for name, fn in CASES:
        t0 = time.perf_counter()
        try:
            res = fn(comm, inp, name)
        except Exception:
            error = f"case {name} on rank {rank}:\n{traceback.format_exc()}"
            break
        seconds[name] = time.perf_counter() - t0
        out.update({f"{name}.{k}": v for k, v in res.items()})
    out["seconds"] = np.array(json.dumps(seconds))
    out["error"] = np.array(error)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    sys.stdout.flush()
    # a broken group (the hang case) cannot be torn down cleanly
    os._exit(1 if error else 0)


if __name__ == "__main__":
    main(sys.argv[1:])
