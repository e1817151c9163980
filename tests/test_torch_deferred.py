"""Port parity of the candidate-set renderers: the spread-adaptive
candidate table, the one-hot and gather depth passes, the Gaussian
filter's sigma renderer, the particle filter's deferred renderer and the
``"deferred"`` sensor, held against dbot_ros_tpu on the same numpy
inputs (JAX on the CPU).

Tolerances, and why:
  * ``candidate_ids_dynamic`` and ``one_hot_selectors``: integer
    bookkeeping, equal entry for entry;
  * depths from the same candidate table: both sides run the same
    float32 formulas on constants that differ by rounding (a matmul
    against an einsum), so a ray within rounding of a triangle's edge
    may hit on one side and miss on the other: hit masks equal on all
    but at most 0.2 % of (pose, pixel) pairs, depths 1e-5 on the rest;
  * the sigma renderer, each side with its own reference raycast: the
    same tolerance, also at the full width (80×60 camera, the 1280-face
    icosphere whose faces are smaller than a pixel) on the sigma clouds
    of a tracker's first frame and of its steady state, where the share
    of the exact raycast's hits that the candidate sets cover is held
    from below too;
  * the ``"deferred"`` sensor: each side renders for itself, loglik rtol
    2e-5 + 1e-2 nats, occlusion posterior 1e-5 (the "xla" sensor's
    tolerances); two particle chunk sizes give bit-equal results.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu import config as jcfg
from dbot_ros_tpu.models import beam as jbeam
from dbot_ros_tpu.models import occlusion as jocc
from dbot_ros_tpu.models import sensor as jsensor
from dbot_ros_tpu.ops import deferred as jdeferred
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.models import sensor
from dbot_ros_tpu_torch.ops import budget, deferred, raycast
from dbot_ros_tpu_torch.runtime import node, sources
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker

torch.set_num_threads(1)

H, W = 24, 32
KMAT = np.array([[48.0, 0, 16], [0, 48.0, 12], [0, 0, 1.0]])
MISS_SHARE = 0.002
DEPTH_ATOL = 1e-5


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def cams():
    jc = jcamera.make_camera(KMAT, H, W)
    return jc, interop.camera_from_numpy(fields(jc))


def meshes():
    jms = [jmesh.l_shape_mesh(), jmesh.box_mesh(0.05, 0.08, 0.04)]
    return jms, [interop.mesh_from_numpy(fields(m)) for m in jms]


def sigma_like_poses(g, ref, count, pos=0.004, rot=0.03):
    """``count`` poses scattered around ``ref`` (row 0 is ``ref``)."""
    poses = np.tile(np.asarray(ref, np.float32), (count, 1))
    poses[1:, :3] += pos * g.standard_normal((count - 1, 3))
    q = poses[1:, 3:7] + rot * g.standard_normal((count - 1, 4))
    poses[1:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return poses.astype(np.float32)


def assert_depths_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    same = np.isfinite(got) == np.isfinite(want)
    assert 1.0 - same.mean() <= MISS_SHARE, 1.0 - same.mean()
    both = np.isfinite(got) & np.isfinite(want)
    assert both.sum() > 50
    np.testing.assert_allclose(got[both], want[both], atol=DEPTH_ATOL)


REF = np.array([0.01, -0.01, 0.5, 0.9, 0.1, 0.3, 0.2], np.float32)
REF[3:] /= np.linalg.norm(REF[3:])
# the second object sits at the image border
REF2 = np.array([-0.18, 0.08, 0.55, 1, 0, 0, 0], np.float32)


def id_image():
    """Triangle ids of two objects (one cut by the image border) with
    misses between them, from the JAX reference raycast."""
    jc, _ = cams()
    jms, _ = meshes()
    _, a = jdeferred.raycast_ids(jms[0], jnp.asarray(REF), jc.rays, 64)
    _, b = jdeferred.raycast_ids(jms[1], jnp.asarray(REF2), jc.rays, 64)
    a, b = np.asarray(a), np.asarray(b)
    ids = np.where(a >= 0, a, np.where(b >= 0, b + 40, -1))
    img = ids.reshape(H, W)
    assert (ids < 0).sum() > 100 and (ids >= 0).sum() > 100
    border = np.concatenate([img[0], img[-1], img[:, 0], img[:, -1]])
    assert (border >= 0).any(), "no object at the border"
    return ids.astype(np.int32)


@pytest.mark.parametrize("spread", [1.0, 2.4, 7.0, 40.0])
def test_candidate_ids_dynamic_equals_jax(spread):
    """40 px is above the pad (half the larger side, 16): clipped."""
    ids = id_image()
    for k in (4, 6):
        want = np.asarray(jdeferred.candidate_ids_dynamic(
            jnp.asarray(ids), H, W, spread, k, 128))
        for sp in (spread, torch.tensor(spread)):
            got = deferred.candidate_ids_dynamic(
                torch.as_tensor(ids.astype(np.int64)), H, W, sp, k, 128)
            assert got.dtype == torch.int64 and got.shape == (H * W, k)
            np.testing.assert_array_equal(got.numpy(), want)


def test_one_hot_selectors_take_misses():
    cand = np.array([[0, 3, -1], [-1, -1, -1], [5, 5, 2]], np.int32)
    want = np.asarray(jdeferred.one_hot_selectors(jnp.asarray(cand), 7))
    got = deferred.one_hot_selectors(torch.as_tensor(cand).long(), 7)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 1].sum() == 0            # a miss selects nothing


@pytest.mark.parametrize("slack", [0.0, 0.1])
def test_deferred_depths_match_jax_and_each_other(slack):
    jc, pc = cams()
    jms, pms = meshes()
    g = np.random.default_rng(0)
    poses = sigma_like_poses(g, REF, 25)
    _, ids = jdeferred.raycast_ids(jms[0], jnp.asarray(REF), jc.rays, 64)
    cand = np.array(jdeferred.candidate_ids_dynamic(
        ids, H, W, 3.0, 6, jms[0].padded_triangles))
    cand[5, 2:] = -1                        # explicit misses in the table
    jsel = jdeferred.one_hot_selectors(jnp.asarray(cand),
                                       jms[0].padded_triangles)
    want_mm = jdeferred.deferred_depth(jms[0], jnp.asarray(poses), jc.rays,
                                       jsel, bary_slack=slack)
    want_ga = jdeferred.deferred_depth_gather(
        jms[0], jnp.asarray(poses), jc.rays, jnp.asarray(cand),
        bary_slack=slack)
    tc = torch.as_tensor(cand).long()
    got_mm = deferred.deferred_depth(
        pms[0], t(poses), pc.rays,
        deferred.one_hot_selectors(tc, pms[0].padded_triangles), slack)
    got_ga = deferred.deferred_depth_gather(pms[0], t(poses), pc.rays, tc,
                                            torch.tensor(slack))
    assert got_mm.shape == got_ga.shape == (25, H * W)
    assert_depths_close(got_mm, want_mm)
    assert_depths_close(got_ga, want_ga)
    assert_depths_close(got_ga, got_mm)
    # the mesh's last row is a degenerate padding triangle: what a miss
    # in the gather's table is routed to never hits
    m = pms[0]
    assert m.padded_triangles > m.num_triangles
    assert float(m.g_det[-1].abs().sum()) == 0.0


@pytest.mark.parametrize("case", ["single", "scene", "subset",
                                  "scene_fixed_slack"])
def test_sigma_renderer_matches_jax(case):
    """The port's sigma renderer against JAX's. On the two-mesh scene
    with the automatic slack the port takes each object's slack in its
    own mesh's units, which is JAX's rule for a mesh alone: JAX's side
    is the elementwise minimum of its renderer run on each mesh alone.
    With a fixed slack both take one number for every mesh."""
    jc, pc = cams()
    jms, pms = meshes()
    g = np.random.default_rng(1)
    pixel_idx = np.arange(0, H * W, 3) if case == "subset" else None
    slack = 0.1 if case == "scene_fixed_slack" else None
    if case.startswith("scene"):
        ref2 = np.array([0.06, 0.02, 0.55, 1, 0, 0, 0], np.float32)
        poses = np.stack([sigma_like_poses(g, REF, 49),
                          sigma_like_poses(g, ref2, 49)], axis=1)
    else:
        jms, pms = jms[:1], pms[:1]
        poses = sigma_like_poses(g, REF, 25)

    def jax_render(ms, p):
        return jdeferred.make_sigma_renderer(
            ms, jc.rays, H, W,
            pixel_idx=None if pixel_idx is None else jnp.asarray(pixel_idx),
            tri_chunk=64, bary_slack=slack)(jnp.asarray(p))

    if case == "scene":
        want = np.minimum(*(np.asarray(jax_render([m], poses[:, k]))
                            for k, m in enumerate(jms)))
    else:
        want = jax_render(jms, poses)
    got = deferred.make_sigma_renderer(
        pms, pc.rays, H, W,
        pixel_idx=None if pixel_idx is None
        else torch.as_tensor(pixel_idx), tri_chunk=64,
        bary_slack=slack)(t(poses))
    assert_depths_close(got, want)
    n_sub = H * W if pixel_idx is None else len(pixel_idx)
    assert got.shape == (poses.shape[0], n_sub)


def test_sigma_renderer_follows_a_wide_cloud():
    """A cloud spread over many pixels (a prediction over a long gap):
    the rings scale with it, and the render still agrees with JAX's."""
    jc, pc = cams()
    jms, pms = meshes()
    g = np.random.default_rng(2)
    poses = sigma_like_poses(g, REF, 25, pos=0.03, rot=0.2)
    want = jdeferred.make_sigma_renderer(jms[:1], jc.rays, H, W,
                                         tri_chunk=64)(jnp.asarray(poses))
    got = deferred.make_sigma_renderer(pms[:1], pc.rays, H, W,
                                       tri_chunk=64)(t(poses))
    assert_depths_close(got, want)


def full_width_clouds():
    """The 80×60 camera, the 1280-face icosphere (padded to 1408) at
    0.8 m, and two clouds of 25 sigma poses: the one a default
    ``GaussianTracker`` renders first on frame 0 (wide, 7.8 cm: the
    initial covariance) and the same cloud shrunk tenfold about its mean
    (8 mm, the spread of a tracker's steady state)."""
    from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker

    jc = jcamera.default_kinect_camera(8)
    jm = jmesh.icosphere_mesh(radius=0.06, subdivisions=3)
    pc = interop.camera_from_numpy(fields(jc))
    pm = interop.mesh_from_numpy(fields(jm))
    assert (pc.height, pc.width, pm.padded_triangles) == (60, 80, 1408)
    pose = np.array([[0.0, 0.0, 0.8, 1, 0, 0, 0]], np.float32)
    conf = cfg.GaussianTrackerConfig(
        seed=0, transition=cfg.TransitionConfig(0.1, 0.5, damping=4.0))
    tracker = GaussianTracker(conf, meshes=[pm], camera=pc, device="cpu")
    frame = next(iter(sources.SyntheticSource([pm], pc, lambda i: pose, 1,
                                              seed=0)))
    tracker.initialize(pose, first_frame=frame.depth)
    render, seen = tracker.render_fn, []
    tracker.render_fn = lambda poses: (seen.append(poses), render(poses))[1]
    tracker.track(frame.depth)
    wide = seen[0]
    steady = wide[:1] + 0.1 * (wide - wide[:1])
    steady[:, 3:7] /= torch.linalg.norm(steady[:, 3:7], dim=1, keepdim=True)
    return jc, jm, pc, pm, conf, render, {"frame0": wide, "steady": steady}


def test_sigma_renderer_matches_jax_at_full_width():
    """Sub-pixel faces: a face that covers no pixel centre at the
    reference pose is in no candidate set, in either package. The port's
    hit masks are the reference's (same tolerance as above), and the
    share of the exact raycast's hits that the candidate sets cover
    stays above a floor set under what this scene gives."""
    jc, jm, pc, pm, conf, render, clouds = full_width_clouds()
    spreads = {k: float(torch.linalg.norm(p[:, :3] - p[0, :3], dim=1).max())
               for k, p in clouds.items()}
    assert spreads["frame0"] > 0.05 and spreads["steady"] < 0.01, spreads
    kw = dict(radius=conf.sigma_radius, num_candidates=conf.sigma_candidates)
    # the exact raycast of every pose is slow: the mean and four others
    some = torch.tensor([0, 1, 7, 13, 19])
    exact = {k: torch.isfinite(raycast.raycast_depth(pm, p[some], pc.rays))
             for k, p in clouds.items()}
    # (cloud, bary_slack; None = the automatic slack): the least share
    # of exact hits covered; this scene gives 0.481, 0.498, 0.575, 0.837
    floors = {("frame0", 0.0): 0.42, ("frame0", None): 0.44,
              ("steady", 0.0): 0.50, ("steady", None): 0.75}
    for (name, slack), floor in floors.items():
        poses = clouds[name]
        assert poses.shape == (25, 7)
        want = jdeferred.make_sigma_renderer(
            [jm], jc.rays, 60, 80, bary_slack=slack, **kw)(
                jnp.asarray(poses.numpy()))
        got = deferred.make_sigma_renderer(
            [pm], pc.rays, 60, 80, bary_slack=slack, **kw)(poses)
        assert_depths_close(got, want)
        if slack is None:        # the tracker's own renderer is this one
            assert torch.equal(got, render(poses))
        hit, ex = torch.isfinite(got[some]), exact[name]
        covered = float((hit & ex)[1:].sum()) / float(ex[1:].sum())
        assert covered >= floor, (name, slack, covered)
        if slack == 0.0:         # the exact inside-test invents no hit
            assert not bool((hit & ~ex).any())
            assert not bool((ex[0] & ~hit[0]).any())


def test_deferred_renderer_matches_jax():
    jc, pc = cams()
    jms, pms = meshes()
    g = np.random.default_rng(3)
    poses = sigma_like_poses(g, REF, 40, pos=0.006, rot=0.02)
    for slack in (None, 0.0):
        want = jdeferred.make_deferred_renderer(
            jms[0], jc.rays, H, W, tri_chunk=64, bary_slack=slack)(
                jnp.asarray(REF), jnp.asarray(poses))
        render = deferred.make_deferred_renderer(
            pms[0], pc.rays, H, W, tri_chunk=64, bary_slack=slack)
        assert_depths_close(render(t(REF), t(poses)), want)
    # the per-frame parts, computed once, give the same depths
    cand, sl = render.candidates(t(REF)), render.slack(t(poses))
    assert torch.equal(render(None, t(poses), cand, sl),
                       render(t(REF), t(poses)))


def sensor_inputs(num_objects, particles=48):
    jc, pc = cams()
    jms, pms = meshes()
    jms, pms = jms[:num_objects], pms[:num_objects]
    refs = np.array([[-0.02, 0.0, 0.62, 1, 0, 0, 0],
                     [0.05, 0.01, 0.55, 1, 0, 0, 0]],
                    np.float32)[:num_objects]
    g = np.random.default_rng(4)
    states = np.zeros((particles, num_objects, 13), np.float32)
    states[..., :7] = refs
    states[..., :3] += 0.004 * g.standard_normal((particles, num_objects, 3))
    z = np.asarray(jsensor.render_scene(jms, jnp.asarray(refs), jc.rays))
    z = np.where(np.isfinite(z), z, 2.0).astype(np.float32)
    z += 0.002 * g.standard_normal(H * W).astype(np.float32)
    z[::41] = np.nan
    occ = g.uniform(0, 0.5, (particles, H * W)).astype(np.float32)
    jbp = jbeam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    jop = jocc.make_occlusion_params()
    bp = interop.beam_params_from_numpy(fields(jbp))
    op = interop.occlusion_params_from_numpy(fields(jop))
    return (jms, pms, jc, pc, jbp, jop, bp, op, states, z, occ)


@pytest.mark.parametrize("num_objects", [1, 2])
def test_deferred_sensor_matches_jax(num_objects):
    (jms, pms, jc, pc, jbp, jop, bp, op, states, z,
     occ) = sensor_inputs(num_objects)
    js = jsensor.make_rb_sensor(jms, jc, jbp, jop, backend="deferred",
                                tri_chunk=64)
    want_ll, want_occ = js(jnp.asarray(states), jnp.asarray(occ),
                           jnp.asarray(z), jnp.float32(1 / 30))
    dt = float(np.float32(1 / 30))
    ps = sensor.make_rb_sensor(pms, pc, bp, op, backend="deferred",
                               tri_chunk=64)
    ll, occ_post = ps(t(states), t(occ), t(z), dt)
    np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll),
                               rtol=2e-5, atol=1e-2)
    np.testing.assert_allclose(occ_post.numpy(), np.asarray(want_occ),
                               atol=1e-5)
    # commit=False leaves the caller's map in place
    _, kept = ps(t(states), t(occ), t(z), dt, commit=False)
    np.testing.assert_array_equal(kept.numpy(), occ)


@pytest.mark.parametrize("num_objects", [1, 2])
def test_deferred_sensor_does_not_depend_on_the_chunk(num_objects):
    (_, pms, _, pc, _, _, bp, op, states, z,
     occ) = sensor_inputs(num_objects, particles=50)
    outs = []
    for chunk in (50, 16, 7):
        ps = sensor.make_rb_sensor(pms, pc, bp, op, backend="deferred",
                                   tri_chunk=64, particle_chunk=chunk)
        outs.append(ps(t(states), t(occ), t(z), 1 / 30))
        assert ps.last_particle_chunk == chunk
    for ll, occ_post in outs[1:]:
        assert torch.equal(ll, outs[0][0])
        assert torch.equal(occ_post, outs[0][1])
    # the chunk sized from a capacity (a tenth of it is the workspace)
    ps = sensor.make_rb_sensor(pms, pc, bp, op, backend="deferred",
                               tri_chunk=64, capacity_bytes=80 << 20)
    many = np.concatenate([states] * 6)           # 300 particles
    occ6 = np.concatenate([occ] * 6)
    ll, _ = ps(t(many), t(occ6), t(z), 1 / 30)
    assert ps.last_particle_chunk == 128 == budget.deferred_particle_chunk(
        300, H * W, 4, capacity_bytes=80 << 20)
    ps1 = sensor.make_rb_sensor(pms, pc, bp, op, backend="deferred",
                                tri_chunk=64, particle_chunk=300)
    assert torch.equal(ll, ps1(t(many), t(occ6), t(z), 1 / 30)[0])


def test_deferred_particle_chunk_asks_the_card():
    per_particle = 4800 * 4 * 32 * 4
    cap = 80 * 10 ** 9
    chunk = budget.deferred_particle_chunk(10000, 4800, 4,
                                           capacity_bytes=cap)
    assert chunk % 128 == 0 and chunk < 10000
    assert chunk * per_particle <= 0.1 * cap < (chunk + 128) * per_particle
    # everything fits: one chunk; nothing fits: one multiple
    assert budget.deferred_particle_chunk(
        100, 4800, 4, capacity_bytes=cap) == 100
    assert budget.deferred_particle_chunk(
        10000, 4800, 4, capacity_bytes=1 << 20) == 128
    assert budget.deferred_particle_chunk(
        10000, 4800, 4, capacity_bytes=3010 * per_particle) == 256
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            budget.deferred_particle_chunk(10000, 4800, 4)


def test_particle_tracker_tracks_with_the_deferred_backend():
    _, pc = cams()
    _, pms = meshes()
    conf = cfg.ParticleTrackerConfig(
        evaluation_count=96, backend="deferred", max_kl_divergence=0.5,
        seed=2, observation=cfg.ObservationConfig(model_sigma=0.005,
                                                  sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.3, 1.5, damping=4.0))
    assert conf.backend == jcfg.ParticleTrackerConfig(
        backend="deferred").backend
    tracker = ParticleTracker(conf, meshes=pms[:1], camera=pc, device="cpu")

    def traj(i):
        return np.array([[0.002 * i, 0.0, 0.6, 1, 0, 0, 0]], np.float32)

    run = node.run(tracker, sources.SyntheticSource(
        pms[:1], pc, traj, 8, noise_sigma=0.002, seed=1))
    assert run.poses.shape == (8, 1, 7)
    assert run.position_rmse() < 0.01
    # on the CPU the chunk comes from the host workspace: all 96 fit
    assert tracker.sensor.last_particle_chunk == 96
