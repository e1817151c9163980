"""Port parity of the live-camera sources: the oracle raycaster,
``OracleSource``, ``U16CameraAdapter`` and ``ThreadedSource``, and the
port's tracker fed through them.

The same numpy inputs go through both packages. Tolerances:
  * ``raycast_oracle`` against JAX's: 1e-5 m, equal hit masks (both are
    float32 textbook Möller–Trumbore in the same operation order); against
    the port's production ``raycast_depth``: 1e-4 m, equal hit masks, as
    ``tests/test_raycast.py`` holds JAX's two;
  * ``OracleSource.render`` with JAX's five draws reproduced from the same
    key split and injected (``jax.random.bernoulli(k, p)`` is
    ``uniform(k) < p``): 1e-5 m, equal NaN masks;
  * ``U16CameraAdapter``: bit-equal (same NumPy rounding, same C++);
  * ``ThreadedSource`` with external pushes: the same indices, skipped
    counts, ground truths and frames;
  * closed loops of the port's tracker keep the reference tests' bounds
    (``tests/test_runtime.py``: 2 cm on the last frame when the producer
    outruns the tracker, 1.2 cm RMSE through the u16 pipeline).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu.ops import raycast as jraycast
from dbot_ros_tpu.runtime import sources as jsources
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.ops import raycast
from dbot_ros_tpu_torch.runtime import node, sources
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import camera, mesh

torch.set_num_threads(1)

K_SMALL = np.array([[44.0, 0, 14], [0, 44.0, 12], [0, 0, 1.0]])


def port_mesh(m):
    return interop.mesh_from_numpy(
        {f.name: np.asarray(getattr(m, f.name))
         for f in dataclasses.fields(m)})


def random_poses(n, seed=0, z=0.5):
    g = np.random.default_rng(seed)
    q = g.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.stack([0.05 * g.standard_normal(n), 0.05 * g.standard_normal(n),
                  z + 0.1 * g.random(n)], axis=1)
    return np.concatenate([t, q], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# raycast_oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["icosphere", "l_shape"])
def test_raycast_oracle_matches_jax_and_production(shape):
    jm = (jmesh.icosphere_mesh(radius=0.06, subdivisions=2)
          if shape == "icosphere" else jmesh.l_shape_mesh())
    pm = port_mesh(jm)
    jcam = jcamera.make_camera(K_SMALL, 24, 28)
    cam = camera.make_camera(K_SMALL, 24, 28)
    poses = random_poses(6, seed=1)
    prod = raycast.raycast_depth(pm, torch.as_tensor(poses), cam.rays)
    for i, pose in enumerate(poses):
        want = np.asarray(jraycast.raycast_oracle(jm, jnp.asarray(pose),
                                                  jcam.rays))
        got = raycast.raycast_oracle(pm, torch.as_tensor(pose), cam.rays)
        chunked = raycast.raycast_oracle(pm, torch.as_tensor(pose),
                                         cam.rays, ray_chunk=37)
        got = got.numpy()
        assert got.shape == (cam.num_pixels,)
        np.testing.assert_array_equal(chunked.numpy(), got)
        hit = np.isfinite(want)
        assert hit.sum() > 20
        np.testing.assert_array_equal(np.isfinite(got), hit)
        np.testing.assert_allclose(got[hit], want[hit], atol=1e-5, rtol=0)
        p = prod[i].numpy()
        np.testing.assert_array_equal(np.isfinite(p), hit)
        np.testing.assert_allclose(p[hit], got[hit], atol=1e-4, rtol=0)


def test_raycast_oracle_default_chunk_keeps_the_stated_budget():
    m = mesh.icosphere_mesh(radius=0.06, subdivisions=3)     # 1408 padded
    T = m.padded_triangles
    chunk = raycast.ORACLE_BUDGET_BYTES // (raycast._ORACLE_BYTES_PER_PAIR
                                            * T)
    # a 640×480 frame runs in chunks whose intermediates fit the budget
    assert 1000 < chunk < 640 * 480
    assert chunk * T * raycast._ORACLE_BYTES_PER_PAIR \
        <= raycast.ORACLE_BUDGET_BYTES


# ---------------------------------------------------------------------------
# OracleSource
# ---------------------------------------------------------------------------

def jax_draws(key, n, h, w):
    """The five fields JAX's OracleSource draws for one frame, in its key
    order (sources.py:148-168), flattened."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)

    def flat(x):
        return torch.from_numpy(np.array(x).reshape(-1))

    return sources.OracleDraws(
        normal=flat(jax.random.normal(k1, (n,))),
        dropout=flat(jax.random.uniform(k2, (n,))),
        edge_hit=flat(jax.random.uniform(k3, (h, w))),
        mode=flat(jax.random.uniform(k4, (h, w))),
        neighbour=flat(jax.random.uniform(k5, (h, w))))


def oracle_scene(quantize_mm):
    jm = jmesh.l_shape_mesh()
    jocc = jmesh.box_mesh(0.03, 0.03, 0.01)
    jcam = jsources.scale_camera(jcamera.make_camera(K_SMALL, 24, 28), 2)
    cam = sources.scale_camera(camera.make_camera(K_SMALL, 24, 28), 2)

    def traj(t):
        return np.array([[0.002 * t, 0.0, 0.55, 1, 0, 0, 0]], np.float32)

    # no ray grazes an edge of either mesh within float rounding (JAX's
    # jitted render fuses ops, so such a ray may hit in one package only)
    def occ(t):
        return np.array([0.0313 - 0.0117 * t, 0.0021, 0.45, 1, 0, 0, 0],
                        np.float32)

    kw = dict(num_frames=4, noise_sigma=0.002, seed=5, occluder_fn=occ,
              dropout_prob=0.2, dropout_frames=(1, 3), edge_artifacts=0.5,
              quantize_mm=quantize_mm)
    jsrc = jsources.OracleSource(jm, jcam, traj, occluder=jocc, **kw)
    src = sources.OracleSource(port_mesh(jm), cam, traj,
                               occluder=port_mesh(jocc), **kw)
    return jsrc, src, cam


@pytest.mark.parametrize("quantize_mm", [False, True])
def test_oracle_render_with_jax_draws_matches_jax(quantize_mm):
    jsrc, src, cam = oracle_scene(quantize_mm)
    key = jax.random.PRNGKey(5)
    frames = list(jsrc)
    n_edge_nan = 0
    for t, jf in enumerate(frames):
        key, k = jax.random.split(key)
        draws = jax_draws(k, cam.num_pixels, cam.height, cam.width)
        poses, occ, p_drop = src.frame_inputs(t)
        got = src.render(torch.as_tensor(poses), torch.as_tensor(occ),
                         p_drop, draws).numpy()
        want = np.asarray(jf.depth)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(jf.ground_truth, poses)
        if p_drop == 0:
            n_edge_nan += int(np.isnan(want).sum())
    # the edge artifacts fired (dropout is off outside the window)
    assert n_edge_nan > 0


def test_oracle_source_iterates_from_its_generator():
    _, src, cam = oracle_scene(quantize_mm=True)
    a = list(src)
    _, again, _ = oracle_scene(quantize_mm=True)
    b = list(again)
    assert [f.index for f in a] == [0, 1, 2, 3]
    for fa, fb in zip(a, b):
        assert fa.depth.shape == (cam.num_pixels,)
        assert fa.depth.dtype == np.float32
        np.testing.assert_array_equal(fa.depth, fb.depth)   # seeded
        ok = np.isfinite(fa.depth)
        np.testing.assert_allclose(fa.depth[ok] * 1000,
                                   np.round(fa.depth[ok] * 1000), atol=1e-3)
    # dropout only inside its window (frames 1-2): a fifth of the pixels
    nan_share = [float(np.isnan(f.depth).mean()) for f in a]
    assert nan_share[1] > nan_share[0] + 0.1
    assert nan_share[2] > nan_share[3] + 0.1


# ---------------------------------------------------------------------------
# U16CameraAdapter
# ---------------------------------------------------------------------------

def float_frames(h, w, count, seed=0):
    g = np.random.default_rng(seed)
    out = []
    for i in range(count):
        d = (0.3 + 3.0 * g.random((h, w))).astype(np.float32)
        d[g.random((h, w)) < 0.05] = np.nan
        d[0, :5] = [0.0, -0.2, 70.0, np.inf, 0.0004]     # → 0 → invalid
        d[1, :3] = [65.5344, 65.5355, 0.0005]            # edges of u16
        gt = np.array([[0.0, 0.0, 0.5 + i, 1, 0, 0, 0]], np.float32)
        out.append(sources.Frame(i, d.reshape(-1) if i % 2 else d, gt))
    return out


@pytest.mark.parametrize("use_native", [True, False])
def test_u16_adapter_is_bit_equal_to_jax(use_native):
    frames = float_frames(48, 56, 3)

    class Inner:
        camera = types.SimpleNamespace(height=48, width=56)

        def __iter__(self):
            return iter(frames)

        def __len__(self):
            return len(frames)

    want = list(jsources.U16CameraAdapter(Inner(), 4))
    adapter = sources.U16CameraAdapter(Inner(), 4, native=use_native)
    assert len(adapter) == 3
    got = list(adapter)
    for g, w in zip(got, want):
        assert g.index == w.index and g.depth.shape == (12, 14)
        np.testing.assert_array_equal(
            g.depth.view(np.uint32), np.asarray(w.depth).view(np.uint32))
        np.testing.assert_array_equal(g.ground_truth, w.ground_truth)
    flat = sources.U16CameraAdapter([frames[1]], 4)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        list(flat)


# ---------------------------------------------------------------------------
# ThreadedSource
# ---------------------------------------------------------------------------

def push_script(src):
    """Mixed explicit and implicit indices with pops in between: → what
    the consumer saw (index, skipped, ground truth z, frame value)."""
    it = iter(src)
    seen = []

    def record(f):
        seen.append((f.index, f.skipped,
                     None if f.ground_truth is None
                     else float(f.ground_truth[0, 2]),
                     float(f.depth[0, 0])))

    def pop():
        record(next(it))

    def push(i, idx=None, gt=True):
        src.push(np.full((4, 4), float(i), np.float32), index=idx,
                 ground_truth=(np.array([[0, 0, 0.5 + i, 1, 0, 0, 0]],
                                        np.float32) if gt else None))

    for i in range(3):
        push(i)
    pop()
    push(3)
    pop()
    for i in range(4, 11):                    # overflows the ring of 4
        push(i, gt=i % 3 != 0)
    pop()
    push(11, idx=20)                          # jump: 9 indices skipped
    push(12)                                  # implicit → 21
    pop()
    src.close()
    for f in it:
        record(f)
    return seen, src.skipped_total


@pytest.mark.parametrize("use_native", [True, False])
def test_threaded_source_external_push_matches_jax(use_native):
    want = push_script(jsources.ThreadedSource(frame_shape=(4, 4),
                                               capacity=4))
    got = push_script(sources.ThreadedSource(frame_shape=(4, 4), capacity=4,
                                             native=use_native))
    assert got == want
    seen, skipped = got
    assert [s[0] for s in seen] == [2, 3, 10, 21]
    assert skipped + len(seen) == 22


def test_threaded_source_prunes_dropped_ground_truths():
    src = sources.ThreadedSource(frame_shape=(2, 2), capacity=2)
    for i in range(6):
        src.push(np.zeros((2, 2)), ground_truth=np.zeros((1, 7)) + i)
    src.close()
    frames = list(src)
    assert [f.index for f in frames] == [5] and frames[0].skipped == 5
    assert src._gt == {}


def small_tracker(n=128, seed=0):
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1.0]])
    cam = camera.make_camera(K, 32, 32)
    m = mesh.box_mesh(0.08, 0.06, 0.05)
    conf = cfg.ParticleTrackerConfig(
        evaluation_count=n, max_kl_divergence=0.8, backend="pallas",
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.4, 1.5, damping=8.0), seed=seed)
    return ParticleTracker(conf, meshes=[m], camera=cam, device="cpu"), m, cam


def test_threaded_closed_loop_producer_outruns_tracker():
    tracker, m, cam = small_tracker()
    n_frames = 60

    def traj(t):
        return np.array([[0.0008 * t, 0.0, 0.6, 1, 0, 0, 0]], np.float32)

    inner = sources.SyntheticSource([m], cam, traj, num_frames=n_frames,
                                    noise_sigma=0.002, seed=3)
    src = sources.ThreadedSource(inner, capacity=4, rate_hz=300.0)
    run = node.run(tracker, src)
    assert src.wait_closed(timeout=30)
    assert run.poses.shape[0] < n_frames, "tracker never dropped a frame"
    assert src.skipped_total > 0
    assert run.poses.shape[0] + src.skipped_total == n_frames
    assert any((mt.skipped or 0) > 0 for mt in run.metrics.records)
    assert run.metrics.records[-1].frame == n_frames - 1
    err = np.linalg.norm(run.poses[-1, 0, :3] - traj(n_frames - 1)[0, :3])
    assert err < 0.02, err


def test_u16_camera_pipeline_tracks():
    """Oracle render at the native grid with edge artifacts and mm
    quantization, u16 transport, native strided downsample: the port's
    tracker still tracks (the reference's bound)."""
    K = K_SMALL
    cam = camera.make_camera(K, 24, 28)
    m = mesh.l_shape_mesh()

    def traj(t):
        return np.array([[0.0015 * t, 0.0, 0.55, 1, 0, 0, 0]], np.float32)

    native_cam = sources.scale_camera(cam, 4)
    assert (native_cam.height, native_cam.width) == (96, 112)
    inner = sources.OracleSource(m, native_cam, traj, num_frames=15,
                                 noise_sigma=0.002, seed=2,
                                 edge_artifacts=0.3, quantize_mm=True)
    src = sources.U16CameraAdapter(inner, downsampling=4)
    first = next(iter(src))
    assert first.depth.shape == (24, 28)
    valid = first.depth[np.isfinite(first.depth)]
    assert valid.size > 100
    assert np.allclose(valid * 1000, np.round(valid * 1000), atol=1e-3)
    conf = cfg.ParticleTrackerConfig(
        evaluation_count=192, max_kl_divergence=0.8, backend="pallas",
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.4, 1.5, damping=8.0), seed=0)
    tracker = ParticleTracker(conf, meshes=[m], camera=cam, device="cpu")
    run = node.run(tracker, src)
    assert run.position_rmse() < 0.012, run.position_rmse()
