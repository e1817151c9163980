"""Port parity of the RBC-PF step, plus the port's closed loop and its
import hygiene.

``rbcpf_step`` of both packages runs on the fused sensor (JAX: Pallas in
interpret mode; port: the plain kernels on the CPU) with float32
occlusion. The port replays JAX's random draws in the order JAX takes
them: ``split(key, 2 + K)`` (rbcpf.py:167), per block ``split`` + two
normals (transition.py:89-91) and ``uniform(fold_in(k_res_base, b))``
(resample.py:94). Tolerances: states, weights and means 2e-5 (float32,
sensor sums in another order), occlusion 1e-5, resample flags equal.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu.filters import rbcpf as jrbcpf
from dbot_ros_tpu.models import beam as jbeam
from dbot_ros_tpu.models import occlusion as jocc
from dbot_ros_tpu.models import transition as jtrans
from dbot_ros_tpu.ops import raycast_pallas as jrp
from dbot_ros_tpu.models.sensor import render_scene
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu.utils import se3 as jse3
from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.filters import rbcpf
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.runtime import node, sources
from dbot_ros_tpu_torch.runtime.service import TrackerService
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import camera, mesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def n(x):
    return np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def replayed_noise(key, num_objects, P):
    """The draws ``jrbcpf.rbcpf_step`` makes from ``key``, per block."""
    _, k_res_base, *block_keys = jax.random.split(key, 2 + num_objects)
    out = []
    for b in range(num_objects):
        k1, k2 = jax.random.split(block_keys[b])
        out.append(rbcpf.BlockNoise(
            e1=t(jax.random.normal(k1, (P, 6), jnp.float32)),
            e2=t(jax.random.normal(k2, (P, 6), jnp.float32)),
            u=t(jax.random.uniform(jax.random.fold_in(k_res_base, b), ()))))
    return out


REFS = np.array([[-0.02, 0.0, 0.62, 1, 0, 0, 0],
                 [0.03, 0.01, 0.55, 1, 0, 0, 0]], np.float32)


@pytest.mark.parametrize("num_objects", [1, 2])
def test_rbcpf_steps_match_jax_with_replayed_draws(num_objects):
    """Three steps: a forced resample (max_kl = -1), then two on the KL
    trigger (max_kl = 1). With two objects the first
    block's sensor call must not commit (the port's in-place scatter)."""
    K_cam = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    jcam, pcam = (jcamera.make_camera(K_cam, 32, 32),
                  camera.make_camera(K_cam, 32, 32))
    jmeshes = [jmesh.l_shape_mesh(), jmesh.box_mesh(0.05, 0.08, 0.04)]
    jmeshes = jmeshes[:num_objects]
    pmeshes = [interop.mesh_from_numpy(fields(m)) for m in jmeshes]
    jbp = jbeam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    jop = jocc.make_occlusion_params()
    jtp = jtrans.make_transition_params(0.3, 1.5, damping=6.0)
    js = jrp.make_fused_sensor(jmeshes, jcam, jbp, jop, interpret=True,
                               occ_dtype=jnp.float32)
    ps = fs.make_fused_sensor(
        pmeshes, pcam, interop.beam_params_from_numpy(fields(jbp)),
        interop.occlusion_params_from_numpy(fields(jop)),
        occ_dtype=torch.float32)
    tp = interop.transition_params_from_numpy(fields(jtp))
    P, N = 96, 1024
    refs = REFS[:num_objects]

    g = np.random.default_rng(0)
    states = np.zeros((P, num_objects, 13), np.float32)
    states[..., :7] = refs
    states[..., :3] += 0.006 * g.standard_normal((P, num_objects, 3))
    states[..., 7:10] = 0.05 * g.standard_normal((P, num_objects, 3))
    jbel = jrbcpf.init_belief(jax.random.PRNGKey(7), refs, P, N, 0.1,
                              sensor=js)
    jbel = dataclasses.replace(jbel, states=jnp.asarray(states))
    pbel = interop.belief_from_numpy(
        states, np.asarray(jbel.log_weights), np.asarray(jbel.occlusion[0]),
        N, age=np.asarray(jbel.occlusion[1]), occ_dtype=torch.float32)

    jsteps = {kl: jax.jit(functools.partial(
        jrbcpf.rbcpf_step, loglik_fn=js, trans_params=jtp,
        max_kl_divergence=kl)) for kl in (-1.0, 1.0)}
    resampled = []
    for f, max_kl in enumerate((-1.0, 1.0, 1.0)):
        truth = refs.copy()
        truth[:, 0] += 0.003 * (f + 1)
        z = np.asarray(render_scene(jmeshes, jnp.asarray(truth), jcam.rays))
        z = np.where(np.isfinite(z), z, 2.0).astype(np.float32)
        z += 0.002 * g.standard_normal(N).astype(np.float32)
        z[::41] = np.nan
        noise = replayed_noise(jbel.key, num_objects, P)
        jbel, jinfo = jsteps[max_kl](jbel, jnp.asarray(z),
                                     dt=jnp.float32(1 / 30))
        pbel, pinfo = rbcpf.rbcpf_step(pbel, t(z), ps, tp, 1 / 30,
                                       max_kl_divergence=max_kl,
                                       noise=noise)
        assert bool(pinfo.resampled) == bool(jinfo.resampled)
        resampled.append(bool(pinfo.resampled))
        assert_beliefs_match(pbel, pinfo, ps, jbel, jinfo, js)
    # frame 0 forced; the KL trigger fires on a later frame
    assert resampled[0] and any(resampled[1:]), resampled


def assert_beliefs_match(pbel, pinfo, ps, jbel, jinfo, js):
    """States, raw log weights and occlusion rows per particle; means,
    ESS and KL of the whole cloud.

    A systematic threshold (i + u)/P may fall within float rounding of a
    CDF step: the two sides sum each particle's loglik (~1e3 terms) in
    another order, ~1e-4 nats apart, and then that one particle takes the
    neighbouring parent. At most one such particle per resampling block
    is allowed; it is excluded from the per-particle checks, and the
    cloud statistics are held to the weight it carries.
    """
    P = pbel.num_particles
    sp, sj = n(pbel.states), np.asarray(jbel.states)
    moved = np.abs(sp - sj).reshape(P, -1).max(axis=1) > 2e-5
    assert moved.sum() <= pbel.num_objects, np.flatnonzero(moved)
    keep = ~moved
    np.testing.assert_allclose(sp[keep], sj[keep], atol=2e-5)
    lw_p, lw_j = n(pbel.log_weights), np.asarray(jbel.log_weights)
    np.testing.assert_allclose(lw_p[keep], lw_j[keep], rtol=1e-6, atol=1e-2)
    np.testing.assert_allclose(
        n(ps.occlusion_as_pn(pbel.occlusion, P))[keep],
        np.asarray(js.occlusion_as_pn(jbel.occlusion, P))[keep], atol=1e-5)
    w_p = n(torch.softmax(pbel.log_weights, 0))
    w_j = np.asarray(jax.nn.softmax(jbel.log_weights))
    carried = w_p[moved].sum() + w_j[moved].sum()
    spread = np.ptp(sj, axis=0).max()
    np.testing.assert_allclose(n(pinfo.mean_state),
                               np.asarray(jinfo.mean_state),
                               atol=2e-5 + carried * spread)
    np.testing.assert_allclose(w_p, w_j, atol=2e-5 + carried)
    # ESS and KL move by about |log w| times the weight carried
    for a, b in ((pinfo.ess, jinfo.ess), (pinfo.kl, jinfo.kl)):
        np.testing.assert_allclose(n(a), np.asarray(b),
                                   rtol=1e-4 + 10 * carried,
                                   atol=1e-5 + 10 * carried)


def test_init_belief_hypotheses_match_jax():
    """Particles split across hypotheses by systematic resampling of the
    logits, with the JAX call's uniform replayed (rbcpf.py:93-95)."""
    hyp = np.stack([REFS[0], REFS[1]])
    logits = np.array([0.3, -0.4], np.float32)
    key = jax.random.PRNGKey(5)
    want = jrbcpf.init_belief(key, hyp, 200, 64, 0.2,
                              hypothesis_logits=logits)
    _, k_h = jax.random.split(key)
    got = rbcpf.init_belief(hyp, 200, 64, 0.2, hypothesis_logits=logits,
                            u=t(jax.random.uniform(k_h, ())))
    np.testing.assert_array_equal(n(got.states), np.asarray(want.states))
    np.testing.assert_array_equal(n(got.occlusion),
                                  np.asarray(want.occlusion))
    assert got.num_objects == 1 and bool((got.log_weights == 0).all())


def closed_loop_traj(i):
    q = np.asarray(jse3.so3_exp_quat(jnp.asarray([0.0, 0.01 * i, 0.0])))
    return np.concatenate([[0.01 * np.sin(i / 5), 0.0025 * i / 10, 0.6],
                           q])[None].astype(np.float32)


def closed_loop(particles=256, frames=20, seed=1):
    K = np.array([[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]])
    cam = camera.make_camera(K, 30, 40)
    m = mesh.tagged_l_mesh()
    conf = cfg.ParticleTrackerConfig(
        evaluation_count=particles, backend="pallas", seed=seed,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.2, 1.0, damping=4.0))
    tracker = ParticleTracker(conf, meshes=[m], camera=cam, device="cpu")
    src = sources.SyntheticSource([m], cam, closed_loop_traj, frames,
                                  seed=seed + 1)
    return tracker, node.run(tracker, src)


def test_closed_loop_tracks_synthetic_trajectory():
    """Port only: 256 particles, 40×30 frames, the tagged L (no
    approximate π-twin), 20 frames of slow motion. Bounds are about twice
    the errors measured on this run (9 mm / 0.06 rad)."""
    tracker, run = closed_loop()
    assert run.poses.shape == (20, 1, 7) and np.isfinite(run.poses).all()
    assert len(run.metrics) == 20
    assert all(np.isfinite(r.ess) and r.ess > 0 for r in run.metrics.records)
    assert run.position_rmse() < 0.02, run.position_rmse()
    assert run.rotation_rmse() < 0.15, run.rotation_rmse()
    # restore from the live belief: the smoothed pose is the weighted mean
    tracker.restore(tracker.belief)
    poses, info = tracker.track(np.full(1200, 2.0, np.float32), dt=0.1)
    assert poses.shape == (1, 7) and bool(torch.isfinite(poses).all())


def test_restore_then_track_leaves_the_saved_belief_unchanged():
    """``track`` scatters into the tracker's occlusion map in place;
    ``restore`` must copy it, so one saved belief restored twice gives
    the same frame twice, and the saved belief itself never changes."""
    tracker, _ = closed_loop(frames=3)
    saved = tracker.belief
    q0, age0 = saved.occlusion[0].clone(), saved.occlusion[1].clone()
    depth = sources.SyntheticSource(
        tracker.meshes, tracker.camera, closed_loop_traj, 4,
        seed=9).render(torch.as_tensor(closed_loop_traj(3)))
    outs = []
    for _ in range(2):
        tracker.restore(saved)
        tracker.generator.manual_seed(11)
        poses, _ = tracker.track(depth.numpy())
        outs.append((poses, tracker.belief.occlusion[0]))
        assert torch.equal(saved.occlusion[0], q0)
        assert torch.equal(saved.occlusion[1], age0)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][1], q0)     # the frame did update q


def test_unported_entry_points_raise():
    """What this test held to raise before (island trials, watchdog,
    checkpoint, the "xla" and "deferred" backends, the control service)
    now runs."""
    K = np.array([[30.0, 0, 10], [0, 30.0, 8], [0, 0, 1.0]])
    tracker = ParticleTracker(
        cfg.ParticleTrackerConfig(evaluation_count=16, backend="pallas"),
        meshes=[mesh.box_mesh()], camera=camera.make_camera(K, 16, 20),
        device="cpu")
    tracker.initialize(REFS[0], hypotheses=np.stack([REFS[0]] * 2))
    assert tracker.trial_active == 2
    src = [sources.Frame(0, np.full(320, 2.0, np.float32), REFS[:1])]
    # the control service, held to raise until it was ported, runs
    svc = TrackerService()
    svc.submit({"cmd": "checkpoint", "path": "/nonexistent/dir/b.npz"})
    run = node.run(tracker, src, service=svc)
    assert run.poses.shape == (1, 1, 7)
    st = svc.status()
    assert st["frame"] == 0 and st["applied_seq"] == 1
    assert "checkpoint (seq 1)" in st["last_error"]
    # the "deferred" backend, held to raise until the sigma renderer was
    # ported, builds and runs
    deferred = ParticleTracker(
        cfg.ParticleTrackerConfig(evaluation_count=16, backend="deferred"),
        meshes=[mesh.box_mesh()], camera=camera.make_camera(K, 16, 20),
        device="cpu")
    run = node.run(deferred, src)
    assert run.poses.shape == (1, 1, 7) and np.isfinite(run.poses).all()
    xla = ParticleTracker(
        cfg.ParticleTrackerConfig(evaluation_count=16, backend="xla"),
        meshes=[mesh.box_mesh()], camera=camera.make_camera(K, 16, 20),
        device="cpu")
    run = node.run(xla, src)
    assert run.poses.shape == (1, 1, 7) and np.isfinite(run.poses).all()


def test_interop_occlusion_layouts_agree():
    g = np.random.default_rng(3)
    P, N = 200, 1200
    occ_pn = g.uniform(size=(P, N)).astype(np.float32)
    kern = np.asarray(jrp.occ_to_kernel(jnp.asarray(occ_pn)))
    a = interop.occlusion_from_jax(occ_pn, P, N)
    b = interop.occlusion_from_jax(kern, P, N)
    assert a.shape == (1216, 256)
    assert torch.equal(a[:N, :P], b[:N, :P])
    np.testing.assert_array_equal(n(fs.occ_from_map(a, N, P)), occ_pn)
    with pytest.raises(ValueError):
        interop.occlusion_from_jax(np.zeros((7, 7)), P, N)


def test_port_never_imports_jax():
    """Every module of the port, chip_smoke.py and the multi-rank tests'
    worker (tests/test_torch_dist_worker.py) load, and a tracker runs a
    step on the CPU, without ``jax`` and without anything of the JAX
    package (``dbot_ros_tpu``): in a fresh interpreter where importing
    either raises, checked again in its ``sys.modules``, and in the
    sources."""
    code = (
        "import importlib, pkgutil, sys, numpy as np\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'dbot_ros_tpu'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import chip_smoke\n"
        "import tests.test_torch_dist_worker\n"
        "import dbot_ros_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    dbot_ros_tpu_torch.__path__, 'dbot_ros_tpu_torch.')]\n"
        "assert len(names) > 30, names\n"
        "assert 'dbot_ros_tpu_torch.parallel.dist_filter' in names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from dbot_ros_tpu_torch import config as cfg\n"
        "from dbot_ros_tpu_torch.trackers.particle import ParticleTracker\n"
        "from dbot_ros_tpu_torch.utils.camera import make_camera\n"
        "from dbot_ros_tpu_torch.utils.mesh import box_mesh\n"
        "cam = make_camera(np.array([[30.0, 0, 10], [0, 30.0, 8],"
        " [0, 0, 1]]), 16, 20)\n"
        "tr = ParticleTracker(cfg.ParticleTrackerConfig(evaluation_count=32,"
        " backend='pallas'), meshes=[box_mesh()], camera=cam,"
        " device='cpu')\n"
        "tr.initialize(np.array([0, 0, 0.6, 1, 0, 0, 0], np.float32))\n"
        "poses, info = tr.track(np.full(320, 0.6, np.float32))\n"
        "assert tuple(poses.shape) == (1, 7)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'dbot_ros_tpu'))\n"
        "assert not bad, bad\n"
        "print('no jax')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("no jax")
    sources_ = list((REPO / "dbot_ros_tpu_torch").rglob("*.py"))
    sources_ += [REPO / "chip_smoke.py",
                 REPO / "tests" / "test_torch_dist_worker.py"]
    banned = ("jax", "jaxlib", "dbot_ros_tpu")
    for path in sources_:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0].rstrip(",") not in banned, \
                    (path, line)
