"""Port parity of the distributed particle filter over several ranks.

Four gloo ranks on the CPU, started once for this file
(``tests/test_torch_dist_worker.py``, which imports no JAX), run every
case from inputs this process writes to a temporary ``.npz``; meanwhile
this process computes JAX's results on the conftest's 8-device CPU mesh
(``make_particle_mesh(4)``, ``make_scene_mesh(2, 2)``) with the same
inputs, and the ranks replay JAX's draws:

* the distributed step (``all_gather``) against JAX's, one and two
  objects; the island step; the multi-scene step scene by scene. States
  2e-5, log weights rtol 1e-6 + 1e-2 nats, occlusion 1e-5, with at most
  one parent per resampling block (island: per island and block) moved to
  its neighbour at a CDF tie (see test_torch_tracker.py);
* ``ring``, ``neighbor`` and ``counts`` bit-equal to the port's
  ``all_gather`` on the same inputs and draws, at mild and degenerate
  skew, with the plain and the fused sensor (its bfloat16 map compared as
  bits), and the counts overflow falling back to the ring;
* the default generators (``u`` shared, ``e1``/``e2`` per rank), the lazy
  ages of two ranks (ROADMAP.md §C), ``run_scaling`` at [1, 2], the dry
  run at world size 4, and a rank that skips a collective.

Every group has a timeout (60 s; 3 s in the skipped-collective case) and
the ranks have one as a whole, so a hang fails instead of blocking.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dbot_ros_tpu.filters import rbcpf as jrbcpf
from dbot_ros_tpu.models import beam as jbeam
from dbot_ros_tpu.models import occlusion as jocc
from dbot_ros_tpu.models import transition as jtrans
from dbot_ros_tpu.models.sensor import make_rb_sensor, render_scene
from dbot_ros_tpu.parallel import dist_filter as jdist
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
WORKER_TIMEOUT_S = 240
DT = 1 / 30
K_CAM = np.array([[28.0, 0, 10], [0, 28.0, 10], [0, 0, 1.0]])
POSES = np.array([[-0.06, 0.0, 0.6, 1, 0, 0, 0],
                  [0.07, 0.0, 0.62, 1, 0, 0, 0]], np.float32)
POSE0 = np.array([0.0, 0.0, 0.6, 1, 0, 0, 0], np.float32)


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


class Scene:
    """The JAX side of every case (test_parallel.py's setup)."""

    def __init__(self):
        self.cam = jcamera.make_camera(K_CAM, 20, 20)
        self.meshes = [jmesh.box_mesh(0.08, 0.06, 0.05),
                       jmesh.box_mesh(0.05, 0.05, 0.05)]
        self.bp = jbeam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
        self.op = jocc.make_occlusion_params()
        self.tp = jtrans.make_transition_params(0.4, 1.5, damping=8.0)
        self.N = self.cam.num_pixels

    def sensor(self, k):
        return make_rb_sensor(self.meshes[:k], self.cam, self.bp, self.op,
                              tri_chunk=128)

    def arrays(self):
        out = {}
        quiet = jtrans.make_transition_params(1e-6, 1e-6, damping=0.0)
        for name, x in (("cam", self.cam), ("bp", self.bp), ("op", self.op),
                        ("tp", self.tp), ("quiet", quiet),
                        ("mesh0", self.meshes[0]),
                        ("mesh1", self.meshes[1])):
            out.update({f"{name}.{k}": v for k, v in fields(x).items()})
        return out

    def marked_occlusion(self, P):
        """(P, N) occlusion whose rows differ, per particle, only off the
        object's silhouette at POSE0 (dilated by 2 pixels): a wrong
        parent shows in the map, but particles at one pose keep equal
        likelihoods, so the weights are the cases' skew."""
        hit = np.isfinite(np.asarray(render_scene(
            self.meshes[:1], jnp.asarray(POSE0[None]), self.cam.rays, 128)))
        hit = hit.reshape(self.cam.height, self.cam.width)
        grown = np.zeros_like(hit)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                grown |= np.roll(np.roll(hit, dy, 0), dx, 1)
        mark = np.linspace(0.05, 0.9, P, dtype=np.float32)[:, None]
        return np.where(grown.reshape(1, -1), np.float32(0.1),
                        mark * np.ones((1, self.N), np.float32))

    def frame(self, poses, g):
        z = np.asarray(render_scene(self.meshes[:poses.shape[0]],
                                    jnp.asarray(poses), self.cam.rays, 128))
        z = np.where(np.isfinite(z), z, 2.0).astype(np.float32)
        z += 0.002 * g.standard_normal(self.N).astype(np.float32)
        z[::37] = np.nan
        return z


def step_noise(key, K, counts):
    """JAX's draws of ``make_distributed_step`` from ``key``: e1/e2 of each
    shard (``counts`` particles) and block, u of each block; the next
    key."""
    key_next, k_trans, k_res = jax.random.split(key, 3)
    e = [[jax.random.split(jax.random.fold_in(jax.random.fold_in(k_trans, b),
                                              i)) for b in range(K)]
         for i in range(len(counts))]
    e1 = np.stack([[np.asarray(jax.random.normal(k[0], (L, 6)))
                    for k in row] for row, L in zip(e, counts)])
    e2 = np.stack([[np.asarray(jax.random.normal(k[1], (L, 6)))
                    for k in row] for row, L in zip(e, counts)])
    u = np.array([float(jax.random.uniform(jax.random.fold_in(k_res, b), ()))
                  for b in range(K)], np.float32)
    return e1, e2, u, key_next


def island_noise(key, K, S, L):
    """JAX's draws of ``make_island_step``: per-island e1/e2 and local u,
    the shared island u; the next key."""
    key_next, k_trans, k_res, k_isl = jax.random.split(key, 4)
    e1, e2, u = [], [], []
    for i in range(S):
        kt, kr = (jax.random.fold_in(k_trans, i),
                  jax.random.fold_in(k_res, i))
        ks = [jax.random.split(jax.random.fold_in(kt, b)) for b in range(K)]
        e1.append([np.asarray(jax.random.normal(k[0], (L, 6))) for k in ks])
        e2.append([np.asarray(jax.random.normal(k[1], (L, 6))) for k in ks])
        u.append([float(jax.random.uniform(jax.random.fold_in(kr, b), ()))
                  for b in range(K)])
    return (np.stack(e1), np.stack(e2), np.array(u, np.float32),
            float(jax.random.uniform(k_isl, ())), key_next)


def spread_states(g, poses, P):
    K = poses.shape[0]
    s = np.zeros((P, K, 13), np.float32)
    s[..., :7] = poses
    s[..., :3] += 0.004 * g.standard_normal((P, K, 3))
    s[..., 7:10] = 0.05 * g.standard_normal((P, K, 3))
    return s


def jax_belief(mesh, states, lw, occ, key):
    b = jrbcpf.ParticleBelief(states=jnp.asarray(states),
                              log_weights=jnp.asarray(lw),
                              occlusion=jnp.asarray(occ), key=key)
    return jdist.shard_belief(b, mesh)


def record(rec, b, mean, ess):
    for k, v in (("states", b.states), ("lw", b.log_weights),
                 ("occ", b.occlusion), ("mean", mean), ("ess", ess)):
        rec.setdefault(k, []).append(np.asarray(v))


def build(sc):
    """(inputs for the ranks, JAX jobs: name → fn() giving its results)."""
    g = np.random.default_rng(0)
    inp, jobs = sc.arrays(), {}
    P, L, F = 64, 16, 2
    mesh4 = jdist.make_particle_mesh(4)

    for K in (1, 2):
        name = f"parity_k{K}"
        poses = POSES[:K]
        states = spread_states(g, poses, P)
        lw = (3.0 * np.sin(np.arange(P))).astype(np.float32)  # resamples
        occ = np.full((P, sc.N), 0.1, np.float32)
        key = jax.random.PRNGKey(10 + K)
        zs, noise = [], []
        for f in range(F):
            truth = poses.copy()
            truth[:, 0] += 0.003 * (f + 1)
            zs.append(sc.frame(truth, g))
            e1, e2, u, key = step_noise(key, K, [L] * 4)
            noise.append((e1, e2, u))
        inp.update({f"{name}.num_objects": np.array(K),
                    f"{name}.states": states, f"{name}.lw": lw,
                    f"{name}.occ": occ, f"{name}.z": np.stack(zs),
                    f"{name}.max_kl": np.array(1.0),
                    f"{name}.e1": np.stack([x[0] for x in noise]),
                    f"{name}.e2": np.stack([x[1] for x in noise]),
                    f"{name}.u": np.stack([x[2] for x in noise])})

        def job(K=K, states=states, lw=lw, occ=occ, zs=zs, seed=10 + K):
            step = jdist.make_distributed_step(
                mesh4, sc.sensor(K), sc.tp, DT, max_kl_divergence=1.0,
                exchange="all_gather")
            b = jax_belief(mesh4, states, lw, occ, jax.random.PRNGKey(seed))
            rec = {}
            for z in zs:
                b, mean, ess = step(b, jnp.asarray(z))
                record(rec, b, mean, ess)
            return {k: np.stack(v) for k, v in rec.items()}
        jobs[name] = job

    z0 = sc.frame(POSE0[None], g)
    lin = sc.marked_occlusion(P)
    at_pose = np.zeros((P, 1, 13), np.float32)
    at_pose[..., :7] = POSE0
    skews = {"mild": 0.4 * np.sin(np.arange(P)),
             "degenerate": np.where(np.arange(P) == 40, 0.0, -500.0)}
    for sensor in ("plain", "fused"):
        for skew, lw in skews.items():
            name = f"skew_{sensor}_{skew}"
            inp.update({f"{name}.sensor": np.array(sensor),
                        f"{name}.states": at_pose,
                        f"{name}.lw": lw.astype(np.float32),
                        f"{name}.occ": lin, f"{name}.z": z0,
                        f"{name}.max_kl": np.array(0.01),
                        f"{name}.modes": np.array(
                            ["all_gather", "ring", "neighbor", "counts"])})
    # L = 256 against capacity 128: rank 0's particles weigh nothing, so
    # its 256 offspring descend from ~192 distinct particles of rank 1
    Po = 1024
    at_pose_o = np.zeros((Po, 1, 13), np.float32)
    at_pose_o[..., :7] = POSE0
    inp.update({"overflow.sensor": np.array("plain"),
                "overflow.states": at_pose_o,
                "overflow.lw": np.where(
                    np.arange(Po) < Po // WORLD, -500.0,
                    0.01 * np.sin(np.arange(Po))).astype(np.float32),
                "overflow.occ": sc.marked_occlusion(Po),
                "overflow.z": z0, "overflow.max_kl": np.array(1e-4),
                "overflow.capacity": np.array(128),
                "overflow.modes": np.array(["all_gather", "counts"])})
    inp.update({"generators.states": at_pose,
                "generators.lw": skews["mild"].astype(np.float32),
                "generators.occ": lin, "generators.z": z0})

    # island: all weight on island 2 at frame 0 (the island resample fires)
    states = spread_states(g, POSE0[None], P)
    lw = np.full(P, -400.0, np.float32)
    lw[2 * L:3 * L] = 0.0
    occ = lin.copy()
    key = jax.random.PRNGKey(21)
    zs, noise = [sc.frame(POSE0[None], g) for _ in range(F)], []
    for f in range(F):
        e1, e2, u, ui, key = island_noise(key, 1, 4, L)
        noise.append((e1, e2, u, ui))
    inp.update({"island.states": states, "island.lw": lw, "island.occ": occ,
                "island.z": np.stack(zs), "island.max_kl": np.array(0.5),
                "island.island_max_kl": np.array(0.3),
                "island.e1": np.stack([x[0] for x in noise]),
                "island.e2": np.stack([x[1] for x in noise]),
                "island.u": np.stack([x[2] for x in noise]),
                "island.island_u": np.array([x[3] for x in noise],
                                            np.float32)})

    def island_job(states=states, lw=lw, occ=occ, zs=zs):
        step = jdist.make_island_step(mesh4, sc.sensor(1), sc.tp, DT,
                                      max_kl_divergence=0.5,
                                      island_max_kl=0.3)
        b = jax_belief(mesh4, states, lw, occ, jax.random.PRNGKey(21))
        rec = {}
        for z in zs:
            b, mean, ess = step(b, jnp.asarray(z))
            record(rec, b, mean, ess)
        return {k: np.stack(v) for k, v in rec.items()}
    jobs["island"] = island_job

    # two scenes × two ranks, 32 particles a scene
    true = np.stack([np.array([0.02 * s - 0.01, 0.0, 0.55 + 0.03 * s,
                               1, 0, 0, 0], np.float32) for s in range(2)])
    mesh2d = jdist.make_scene_mesh(2, 2)
    jb = jdist.init_multi_scene_belief(jax.random.PRNGKey(7),
                                       true[:, None, :], 2, 32, mesh2d,
                                       num_pixels=sc.N)
    keys = np.asarray(jb.key)
    zs = np.stack([[sc.frame(true[s][None], g) for s in range(2)]
                   for _ in range(F)])                      # (F, S, N)
    e1s, e2s, us = [], [], []
    for f in range(F):
        per = [step_noise(jnp.asarray(keys[s]), 1, [16, 16])
               for s in range(2)]
        e1s.append(np.stack([p[0] for p in per]))
        e2s.append(np.stack([p[1] for p in per]))
        us.append(np.stack([p[2] for p in per]))
        keys = np.stack([np.asarray(p[3]) for p in per])
    inp.update({"scenes.poses": true[:, None, :], "scenes.particles":
                np.array(32), "scenes.z": zs, "scenes.max_kl": np.array(0.8),
                "scenes.e1": np.stack(e1s), "scenes.e2": np.stack(e2s),
                "scenes.u": np.stack(us)})

    def scenes_job(jb=jb, zs=zs):
        step = jdist.make_multi_scene_step(mesh2d, sc.sensor(1), sc.tp, DT,
                                           max_kl_divergence=0.8)
        rec = {}
        b = jb
        for z in zs:
            b, mean, ess = step(b, jnp.asarray(z))
            record(rec, b, mean, ess)
        return {k: np.stack(v) for k, v in rec.items()}
    jobs["scenes"] = scenes_job

    # two ranks whose clouds sit 1.5 cm apart, occlusion off its prior
    a = spread_states(g, POSE0[None], 64)
    b = spread_states(g, POSE0[None] + np.array(
        [[0.015, 0, 0, 0, 0, 0, 0]], np.float32), 64)
    inp.update({"ages.states": np.concatenate([a, b]),
                "ages.lw": np.zeros(128, np.float32),
                "ages.occ": np.full((128, sc.N), 0.6, np.float32),
                "ages.z": sc.frame(POSE0[None] + np.array(
                    [[0.0075, 0, 0, 0, 0, 0, 0]], np.float32), g)})
    inp.update({"scaling.pose": POSE0, "scaling.z": z0})
    return inp, jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks on this file's inputs, compute JAX's results while
    they run, and collect both."""
    tmp = tmp_path_factory.mktemp("ranks")
    sc = Scene()
    inp, jobs = build(sc)
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["OMP_NUM_THREADS"] = "1"
    from dbot_ros_tpu_torch.parallel.comm import free_port

    port = free_port()
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_dist_worker",
         str(tmp / "in.npz"), str(tmp), str(r), str(WORLD), str(port)],
        cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        want = {name: job() for name, job in jobs.items()}
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    got, errors = [], []
    for r in range(WORLD):
        path = tmp / f"rank{r}.npz"
        if not path.exists():
            errors.append(f"rank {r} wrote nothing:\n"
                          + (tmp / f"rank{r}.log").read_text()[-3000:])
            got.append({})
            continue
        d = dict(np.load(path))
        if str(d["error"]):
            errors.append(str(d["error"]))
        got.append(d)
    return got, want, "\n".join(errors), json.loads(
        str(got[0].get("seconds", "{}")))


def ranks(runs, case, key, which=range(WORLD)):
    """One result of ``case`` from each rank in ``which``."""
    got, _, errors, _ = runs
    if any(f"{case}.{key}" not in got[r] for r in which):
        pytest.fail(f"no result {case}.{key} from the ranks:\n{errors}")
    return [got[r][f"{case}.{key}"] for r in which]


def joined(runs, case, key, axis=1):
    """The ranks' blocks of a per-frame leaf, concatenated → global."""
    return np.concatenate(ranks(runs, case, key), axis=axis)


def assert_close_to_jax(got, want, num_objects, ties_per_frame):
    """Per frame: states, log weights and occlusion per particle except
    the moved parents (at most ``ties_per_frame``); means and ESS to the
    weight the moved ones carry."""
    for f in range(want["states"].shape[0]):
        sp, sj = got["states"][f], want["states"][f]
        P = sp.shape[0]
        moved = np.abs(sp - sj).reshape(P, -1).max(axis=1) > 2e-5
        assert moved.sum() <= ties_per_frame, (f, np.flatnonzero(moved))
        keep = ~moved
        np.testing.assert_allclose(sp[keep], sj[keep], atol=2e-5)
        np.testing.assert_allclose(got["lw"][f][keep], want["lw"][f][keep],
                                   rtol=1e-6, atol=1e-2)
        np.testing.assert_allclose(got["occ"][f][keep],
                                   want["occ"][f][keep], atol=1e-5)
        w = np.asarray(jax.nn.softmax(want["lw"][f]))
        carried = 2 * w[moved].sum()
        # the weights of the kept particles differ by the log-weight
        # tolerance: the mean moves by that share of the cloud's spread
        dw = np.abs(np.asarray(jax.nn.log_softmax(got["lw"][f]))[keep]
                    - np.asarray(jax.nn.log_softmax(want["lw"][f]))[keep])
        spread = np.ptp(sj, axis=0).max()
        np.testing.assert_allclose(
            got["mean"][f], want["mean"][f],
            atol=2e-5 + (carried + dw.max()) * spread)
        np.testing.assert_allclose(got["ess"][f], want["ess"][f],
                                   rtol=1e-4 + 10 * carried + 2 * dw.max())


@pytest.mark.parametrize("case", ["parity_k1", "parity_k2"])
def test_all_gather_step_matches_jax(runs, case):
    got = {k: joined(runs, case, f"all_gather.{k}")
           for k in ("states", "lw", "occ")}
    for k in ("mean", "ess"):
        per_rank = ranks(runs, case, f"all_gather.{k}")
        for other in per_rank[1:]:
            np.testing.assert_array_equal(other, per_rank[0])
        got[k] = per_rank[0]
    want = runs[1][case]
    K = got["states"].shape[2]
    assert_close_to_jax(got, want, K, ties_per_frame=K)
    paths = ranks(runs, case, "all_gather.paths")[0]
    assert "all_gather" in paths[0], paths    # the skewed start resampled


SKEW_CASES = ["parity_k1", "parity_k2", "skew_plain_mild",
              "skew_plain_degenerate", "skew_fused_mild",
              "skew_fused_degenerate"]


@pytest.mark.parametrize("mode", ["ring", "neighbor", "counts"])
@pytest.mark.parametrize("case", SKEW_CASES)
def test_exchange_is_bit_equal_to_all_gather(runs, case, mode):
    """States, log weights, means and the occlusion map (bfloat16 bits for
    the fused sensor) equal the all_gather resampler's on every rank.
    Mild skew stays within one hop (the counts buffers and the neighbor
    blocks); degenerate weights overflow the hop span and run the ring.
    The fused sensor's lazy ages are not compared here (see
    test_lazy_ages_of_two_ranks_differ_and_counts_swaps_them)."""
    for k in ("states", "lw", "q", "mean", "ess"):
        for r, (a, b) in enumerate(zip(ranks(runs, case, f"{mode}.{k}"),
                                       ranks(runs, case,
                                             f"all_gather.{k}"))):
            if k == "q" and "fused" in case:
                # the map's real particle columns; what padding columns
                # hold is left to each exchange, as in the reference
                L = ranks(runs, case, "all_gather.lw")[r].shape[-1]
                a, b = a[..., :L], b[..., :L]
            np.testing.assert_array_equal(a, b, err_msg=f"{k} rank {r}")
    paths = [str(p) for p in ranks(runs, case, f"{mode}.paths")[0]]
    if case.startswith("skew"):
        for lw in ranks(runs, case, f"{mode}.lw"):
            assert (lw == 0).all(), "the frame must resample"
        want = {"mild": {"ring": "ring", "neighbor": "neighbor",
                         "counts": "counts"},
                "degenerate": {"ring": "ring", "neighbor": "ring",
                               "counts": "ring"}}[case.split("_")[2]][mode]
        assert paths == [want], paths


def test_counts_overflow_falls_back_to_the_ring(runs):
    """256 particles a rank, capacity 128, near-uniform weights: ~256
    distinct parents a rank overflow the buffers; the full ring runs and
    the result is the all_gather resampler's."""
    for k in ("states", "lw", "q"):
        for a, b in zip(ranks(runs, "overflow", f"counts.{k}"),
                        ranks(runs, "overflow", f"all_gather.{k}")):
            np.testing.assert_array_equal(a, b)
    assert [str(p) for p in ranks(runs, "overflow", "counts.paths")[0]] \
        == ["ring"]
    for lw in ranks(runs, "overflow", "counts.lw"):
        assert (lw == 0).all()


def test_default_generators_share_u_and_keep_e_per_rank(runs):
    shared = ranks(runs, "generators", "shared_all")[0]
    local = ranks(runs, "generators", "local_all")[0]
    assert (shared == shared[0]).all()            # the same on every rank
    assert len({tuple(row) for row in local}) == WORLD
    for k in ("states", "occ", "mean"):
        for both in ranks(runs, "generators", k):
            np.testing.assert_array_equal(both[0], both[1])


def test_island_step_matches_jax(runs):
    """Frame 0: all weight on island 2, the island resample copies its
    block to every rank; frame 1 on the local triggers."""
    got = {k: joined(runs, "island", k) for k in ("states", "lw", "occ")}
    for k in ("mean", "ess"):
        got[k] = ranks(runs, "island", k)[0]
    want = runs[1]["island"]
    assert_close_to_jax(got, want, 1, ties_per_frame=WORLD)
    st = got["states"][0]
    np.testing.assert_array_equal(st.reshape(WORLD, 16, -1),
                                  np.broadcast_to(st[32:48].reshape(1, 16, -1),
                                                  (WORLD, 16, 13)))


def test_multi_scene_step_matches_jax_scene_by_scene(runs):
    want = runs[1]["scenes"]
    scene = ranks(runs, "scenes", "scene")
    prank = ranks(runs, "scenes", "particle_rank")
    assert [int(s) for s in scene] == [0, 0, 1, 1]
    assert [int(p) for p in prank] == [0, 1, 0, 1]
    for s in range(2):
        mine = [r for r in range(WORLD) if int(scene[r]) == s]
        got = {k: np.concatenate([ranks(runs, "scenes", k)[r] for r in mine],
                                 axis=1) for k in ("states", "lw", "occ")}
        for k in ("mean", "ess"):
            got[k] = ranks(runs, "scenes", k)[mine[0]]
        one = {k: v[:, s] for k, v in want.items()}
        assert_close_to_jax(got, one, 1, ties_per_frame=1)


def test_lazy_ages_of_two_ranks_differ_and_counts_swaps_them(runs):
    """The reference keeps one shard's ages for the whole map
    (raycast_pallas.py:1038, dist_filter.py:420). Two ranks whose clouds
    sit 1.5 cm apart select different pixels, so their ages differ after
    one frame; the counts exchange, on a frame without a resample, gives
    each rank its neighbour's ages over its own map, and the occlusion
    that ``occlusion_as_pn`` reads changes against all_gather's (which
    keeps the rank's own). The map's values stay bit-equal."""
    q_ag = ranks(runs, "ages", "all_gather.q", [0, 1])
    q_ct = ranks(runs, "ages", "counts.q", [0, 1])
    for a, b in zip(q_ag, q_ct):
        np.testing.assert_array_equal(a, b)
    own = ranks(runs, "ages", "all_gather.age", [0, 1])
    got = ranks(runs, "ages", "counts.age", [0, 1])
    assert not np.array_equal(own[0], own[1]), "ages equal on both ranks"
    np.testing.assert_array_equal(got[0], own[1])
    np.testing.assert_array_equal(got[1], own[0])
    pn_ag = ranks(runs, "ages", "all_gather.occ", [0, 1])
    pn_ct = ranks(runs, "ages", "counts.occ", [0, 1])
    assert max(np.abs(a - b).max() for a, b in zip(pn_ag, pn_ct)) > 1e-3


def test_run_scaling_mechanics(runs):
    res = {k: ranks(runs, "scaling", k) for k in
           ("device_counts", "particles", "steps_per_s", "efficiency")}
    for k, v in res.items():
        for other in v[1:]:
            np.testing.assert_array_equal(other, v[0])
    assert list(res["device_counts"][0]) == [1, 2]
    assert list(res["particles"][0]) == [16, 32]
    assert res["efficiency"][0][0] == 1.0
    assert (res["steps_per_s"][0] > 0).all()


def test_dry_run_on_four_ranks(runs):
    assert [int(c) for c in ranks(runs, "dryrun", "cases")] == [5] * WORLD
    assert [int(w) for w in ranks(runs, "dryrun", "world")] == [WORLD] * 4


def test_a_rank_that_skips_a_collective_fails_within_the_timeout(runs):
    raised = str(ranks(runs, "hang", "raised", [0])[0])
    seconds = float(ranks(runs, "hang", "seconds", [0])[0])
    timeout = float(ranks(runs, "hang", "timeout", [0])[0])
    assert raised, "the collective returned although its peer skipped it"
    assert seconds < timeout + 5.0, seconds
