"""Port parity of the fused sensor's options: the select merge, the
single-level caps, a fixed barycentric slack, multi-reference candidates,
two objects, and the eager compacted branch of a raw map (g < 0).

The JAX sensor runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does; the port runs the plain PyTorch versions of
its CUDA kernels (the CPU path of ops/kernels.py). Both sensors are built
from one dict of the JAX sensor's settings through
``interop.fused_sensor_kwargs_from_jax``, so a setting cannot differ
between them.

Tolerances, and why (those of tests/test_torch_fused.py):
  * port against JAX: slabs and candidates come from each side's own
    float32 products (another summation order), so loglik is held to
    rtol 2e-5 + 1e-2 nats and the float32 occlusion to 1e-5; a bfloat16
    map to one bf16 step (4e-3 on [0, 1]);
  * port against port (select against scatter, caps against levels):
    the same operations on the same inputs, rtol 1e-6 / atol 1e-6;
  * candidate ids are integers: equal.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu.models import beam as jbeam
from dbot_ros_tpu.models import occlusion as jocc
from dbot_ros_tpu.ops import raycast as jraycast
from dbot_ros_tpu.ops import raycast_pallas as jrp
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.models import beam, occlusion
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.runtime import node, sources
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import camera, mesh
from tests.test_torch_fused import (DTYPES, fields, n, observed_depth,
                                    perturbed_poses, scene, t)

torch.set_num_threads(1)

DT = 1.0 / 30.0


def settings_of(js):
    """The JAX sensor's settings as interop.fused_sensor_kwargs_from_jax
    reads them (the map dtype by name)."""
    out = {k: getattr(js, k) for k in interop.FUSED_SENSOR_SETTINGS}
    out["occ_dtype"] = js.occ_dtype.name
    return out


def sensor_pair(s, meshes=None, **opts):
    """The JAX sensor with ``opts`` (interpret mode) and the port's, built
    from the JAX sensor's settings."""
    jms, pms = meshes if meshes is not None else ([s.jm], [s.pm])
    js = jrp.make_fused_sensor(jms, s.jcam, s.jbp, s.jop, interpret=True,
                               **opts)
    ps = fs.make_fused_sensor(pms, s.pcam, s.bp, s.op,
                              **interop.fused_sensor_kwargs_from_jax(
                                  settings_of(js)))
    return js, ps


def unimodal(g, P, center):
    states = np.zeros((P, 1, 13), np.float32)
    states[:, 0, :7] = perturbed_poses(g, P, center)
    return states


def assert_ll(got, want):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-5,
                               atol=1e-2)


def assert_occ(ps, pocc, js, jocc_, P, atol=1e-5):
    np.testing.assert_allclose(
        n(ps.occlusion_as_pn(pocc, P)),
        np.asarray(js.occlusion_as_pn(jocc_, P), np.float32), atol=atol)


def test_signature_matches_the_reference():
    """``make_fused_sensor`` takes every parameter of the reference's, in
    its order and with its defaults (the map dtype's by name), and adds
    ``device``; ``interpret`` raises; nothing is left unported."""
    ref = list(inspect.signature(jrp.make_fused_sensor).parameters.values())
    port = list(inspect.signature(fs.make_fused_sensor).parameters.values())
    assert [p.name for p in port] == [p.name for p in ref] + ["device"]
    for r, p in zip(ref, port):
        if r.name == "occ_dtype":
            assert jnp.dtype(r.default).name == str(p.default).split(".")[-1]
        else:
            assert p.default == r.default, r.name
    assert "NotImplementedError" not in inspect.getsource(fs)
    s = scene((32, 32))
    with pytest.raises(ValueError, match="interpreter"):
        fs.make_fused_sensor(s.pm, s.pcam, s.bp, s.op, interpret=False)
    with pytest.raises(ValueError, match="unknown"):
        interop.fused_sensor_kwargs_from_jax({"interpret": True})


@pytest.mark.parametrize("opts,levels", [
    (dict(active_cap_frac=0.25, tri_cap_frac=0.5), [(0.25, 0.5)]),
    (dict(active_cap_frac=0.25), [(0.25, 1.0)]),
    (dict(tri_cap_frac=0.5), [(1.0, 0.5)]),
    (dict(active_cap_frac=0.25, levels=[(0.5, 0.75)]), [(0.5, 0.75)]),
])
def test_single_level_caps_resolve_as_the_reference(opts, levels):
    """The single-level ``active_cap_frac``/``tri_cap_frac`` pair; an
    explicit ``levels`` wins."""
    s = scene((32, 32))
    js, ps = sensor_pair(s, **opts)
    assert js.levels == levels
    assert fs.make_fused_sensor(s.pm, s.pcam, s.bp, s.op, **opts).levels \
        == ps.levels == levels


def test_select_merge_matches_jax_and_scatter():
    """(a) ``merge="select"`` against JAX's ``"select"`` and against the
    port's ``"scatter"``, two frames on a compacted level. The select
    merge writes a new map; the scatter merge the input map."""
    s = scene((32, 32))
    P, N = 64, 1024
    opts = dict(levels=[(0.5, 0.75)], occ_dtype=jnp.float32)
    js, ps = sensor_pair(s, merge="select", **opts)
    ps_scatter = fs.make_fused_sensor(s.pm, s.pcam, s.bp, s.op,
                                      levels=[(0.5, 0.75)],
                                      occ_dtype=torch.float32)
    jstep = jax.jit(lambda st, o, z: js(st, o, z, jnp.float32(DT)))
    jo, po, po_s = (js.init_occlusion(P, 0.15), ps.init_occlusion(P, 0.15),
                    ps_scatter.init_occlusion(P, 0.15))
    g = np.random.default_rng(21)
    for f in range(2):
        states = unimodal(g, P, (0.003 * f, 0.0, 0.6))
        z = observed_depth(g, s.jm, s.jcam, (0.003 * f, 0.0, 0.6))
        ll_j, jo = jstep(jnp.asarray(states), jo, jnp.asarray(z))
        q_in = po[0]
        ll_p, po = ps(t(states), po, t(z), DT)
        assert ps.last_level == 0
        assert po[0].data_ptr() != q_in.data_ptr()     # a new map
        ll_s, po_s = ps_scatter(t(states), po_s, t(z), DT)
        assert ps_scatter.last_level == 0
        assert_ll(ll_p, ll_j)
        assert_occ(ps, po, js, jo, P)
        np.testing.assert_array_equal(n(po[1]), np.asarray(jo[1]))
        np.testing.assert_allclose(n(ll_p), n(ll_s), rtol=1e-6, atol=1e-6)
        for a, b in zip(po, po_s):
            np.testing.assert_allclose(n(a), n(b), atol=1e-6)


def test_single_level_caps_match_jax():
    """(b) ``active_cap_frac``/``tri_cap_frac`` against JAX at the same
    fractions, on the compacted level (``last_level`` 0), and against
    ``levels=[(a, t)]`` in the port (the same operations)."""
    s = scene((30, 40))
    P = 96
    opts = dict(active_cap_frac=0.1, tri_cap_frac=0.5,
                occ_dtype=jnp.float32)
    js, ps = sensor_pair(s, **opts)
    ps_levels = fs.make_fused_sensor(s.pm, s.pcam, s.bp, s.op,
                                     levels=[(0.1, 0.5)],
                                     occ_dtype=torch.float32)
    assert len(ps.caps(1200)) == 1
    jstep = jax.jit(lambda st, o, z: js(st, o, z, jnp.float32(DT)))
    jo, po, pl = (js.init_occlusion(P, 0.1), ps.init_occlusion(P, 0.1),
                  ps_levels.init_occlusion(P, 0.1))
    g = np.random.default_rng(22)
    for f in range(2):
        states = unimodal(g, P, (0.004 * f, 0.0, 0.8))
        z = observed_depth(g, s.jm, s.jcam, (0.004 * f, 0.0, 0.8))
        ll_j, jo = jstep(jnp.asarray(states), jo, jnp.asarray(z))
        ll_p, po = ps(t(states), po, t(z), DT)
        ll_l, pl = ps_levels(t(states), pl, t(z), DT)
        assert ps.last_level == 0 == ps_levels.last_level
        assert_ll(ll_p, ll_j)
        assert_occ(ps, po, js, jo, P)
        np.testing.assert_allclose(n(ll_p), n(ll_l), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(n(po[0]), n(pl[0]), atol=1e-6)


@pytest.mark.parametrize("slack", [0.0, 0.5])
def test_fixed_bary_slack_matches_jax(slack):
    """(c) A fixed ``bary_slack`` against JAX, with the lazy ladder."""
    s = scene((32, 32))
    P = 64
    js, ps = sensor_pair(s, bary_slack=slack, occ_dtype=jnp.float32)
    assert ps.bary_slack == slack
    g = np.random.default_rng(23)
    states = unimodal(g, P, (0.0, 0.0, 0.6))
    states[:, 0, 0] += 0.01       # displaced from the observed pose
    z = observed_depth(g, s.jm, s.jcam, (0.0, 0.0, 0.6))
    ll_j, jo = jax.jit(js)(jnp.asarray(states), js.init_occlusion(P, 0.1),
                           jnp.asarray(z), jnp.float32(DT))
    ll_p, po = ps(t(states), ps.init_occlusion(P, 0.1), t(z), DT)
    assert_ll(ll_p, ll_j)
    assert_occ(ps, po, js, jo, P)


def test_bary_slack_fixes_displaced_pose_scoring():
    """(c) The reference's regression (tests/test_pallas.py) on the port:
    with faces finer than a pixel, the true pose wins at slack 0.5 and
    the stale reference pose at 0.0 (the exact inside-test misses the
    triangles no pixel centre of the reference image names). The cloud
    is the reference test's own (its JAX draws): the outcome depends on
    where the cloud's mean, the candidates' reference, falls."""
    cam = camera.default_kinect_camera(16)
    m = mesh.icosphere_mesh(radius=0.06, subdivisions=2)
    bp = beam.make_beam_params(model_sigma=0.005)
    op = occlusion.make_occlusion_params()
    from dbot_ros_tpu_torch.ops import raycast
    pose0 = torch.tensor([0.0, 0.0, 0.8, 1.0, 0.0, 0.0, 0.0])
    gt = pose0.clone()
    gt[0], gt[1] = 0.006, 0.003
    z = raycast.raycast_depth(m, gt, cam.rays)
    z_obs = torch.where(torch.isfinite(z), z, float("nan"))
    P = 64
    dpos = np.asarray(0.01 * jax.random.normal(jax.random.PRNGKey(0),
                                                (P, 3)))
    states = torch.zeros((P, 1, 13))
    states[:, 0, :3] = pose0[:3] + torch.as_tensor(dpos, dtype=torch.float32)
    states[:, 0, 3:7] = pose0[3:7]
    states[0, 0, :7] = gt          # particle 0: the truth
    states[1, 0, :7] = pose0       # particle 1: stale

    def loglik(slack):
        s = fs.make_fused_sensor(m, cam, bp, op, bary_slack=slack,
                                 num_candidates=2, radius=2)
        ll, _ = s(states, s.init_occlusion(P, 0.1), z_obs, DT)
        return n(ll)

    ll_fixed = loglik(0.5)
    assert ll_fixed[0] > ll_fixed[1] and int(ll_fixed.argmax()) == 0
    ll_exact = loglik(0.0)
    assert ll_exact[0] < ll_exact[1]


def bimodal(g, P, center, gap):
    """Two blocks of P/2 particles ``gap`` apart along x (the blocks a
    systematic two-hypothesis init allocates)."""
    states = np.zeros((P, 1, 13), np.float32)
    for b, dx in enumerate((-gap / 2, gap / 2)):
        c = (center[0] + dx, center[1], center[2])
        states[b * P // 2:(b + 1) * P // 2, 0, :7] = perturbed_poses(
            g, P // 2, c, dpos=0.002, drot=0.01)
    return states


def test_reference_poses_match_jax_on_a_bimodal_cloud():
    """(d) ``reference_poses=4`` against JAX on a bimodal cloud (two
    blocks 6 cm apart): the same candidate ids, bit for bit, and the
    same loglik. One reference at the cloud's mean (a ghost pose between
    the modes) gives other candidates."""
    s = scene((32, 32))
    P = 64
    g = np.random.default_rng(24)
    states = bimodal(g, P, (0.0, 0.0, 0.6), 0.06)
    z = observed_depth(g, s.jm, s.jcam, (0.03, 0.0, 0.6))
    js, ps = sensor_pair(s, reference_poses=4, occ_dtype=jnp.float32)
    assert ps.reference_poses == 4
    np.testing.assert_array_equal(
        ps.candidates(t(states)).numpy(),
        np.asarray(js.candidates(jnp.asarray(states))))
    one = fs.make_fused_sensor(s.pm, s.pcam, s.bp, s.op)
    assert not torch.equal(one.candidates(t(states)),
                           ps.candidates(t(states)))
    ll_j, jo = js(jnp.asarray(states), js.init_occlusion(P, 0.1),
                  jnp.asarray(z), jnp.float32(DT))
    ll_p, po = ps(t(states), ps.init_occlusion(P, 0.1), t(z), DT)
    assert_ll(ll_p, ll_j)
    assert_occ(ps, po, js, jo, P)


def test_two_objects_exact_slack_match_jax():
    """(e) Two objects (the box partly in front of the L, the scene of
    tests/test_pallas.py's multi-object oracle) with ``bary_slack=0.0``:
    the first coordinate block's call (``commit=False``) leaves the map
    as it was, the second's commits; both against the JAX sensor."""
    s = scene((32, 32))
    jms = [jmesh.l_shape_mesh(), jmesh.box_mesh(0.05, 0.08, 0.04)]
    pms = [interop.mesh_from_numpy(fields(m)) for m in jms]
    js, ps = sensor_pair(s, meshes=(jms, pms), bary_slack=0.0, nb=32)
    P = 64
    g = np.random.default_rng(25)
    refs = [(-0.02, 0.0, 0.62), (0.03, 0.01, 0.55)]
    states = np.zeros((P, 2, 13), np.float32)
    for k, c in enumerate(refs):
        states[:, k, :7] = perturbed_poses(g, P, c, dpos=0.004, drot=0.02)
    z = np.asarray(jraycast.raycast_depth(
        jms[0], jnp.asarray(list(refs[0]) + [1.0, 0, 0, 0]), s.jcam.rays))
    z_box = np.asarray(jraycast.raycast_depth(
        jms[1], jnp.asarray(list(refs[1]) + [1.0, 0, 0, 0]), s.jcam.rays))
    z = np.fmin(z, z_box)
    z = np.where(np.isfinite(z), z, 2.0).astype(np.float32)
    z[::29] = np.nan
    jo = js.init_occlusion(P, 0.15)
    ll_j, jo = js(jnp.asarray(states), jo, jnp.asarray(z), jnp.float32(DT))
    po = ps.init_occlusion(P, 0.15)
    q0 = po[0].clone()
    ll_dry, po_dry = ps(t(states), po, t(z), DT, commit=False)
    assert po_dry is po and torch.equal(po[0], q0)
    ll_p, po = ps(t(states), po, t(z), DT)
    assert torch.equal(ll_dry, ll_p)
    assert_ll(ll_p, ll_j)
    assert_occ(ps, po, js, jo, P, atol=4e-3)       # bfloat16 maps


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_eager_compacted_branch_matches_jax(dtype):
    """(f) g < 0: the raw map takes the eager compacted branch (the
    selected rows through the kernel, the whole map propagated in
    float32 and cast once, the rows written into it) against JAX's eager
    branch over two frames; ``commit=False`` leaves the map bit-equal."""
    jdt, tdt = DTYPES[dtype]
    s = scene((30, 40), p_ov=0.4, p_oo=0.1)
    P = 96
    js, ps = sensor_pair(s, levels=[(0.1, 0.5), (0.2, 0.75)],
                         occ_dtype=jdt)
    jo, po = js.init_occlusion(P, 0.2), ps.init_occlusion(P, 0.2)
    assert isinstance(po, torch.Tensor) and po.dtype == tdt
    jstep = jax.jit(lambda st, o, z: js(st, o, z, jnp.float32(DT)))
    g = np.random.default_rng(26)
    for f in range(2):
        states = unimodal(g, P, (0.004 * f, 0.0, 0.8))
        z = observed_depth(g, s.jm, s.jcam, (0.004 * f, 0.0, 0.8))
        ll_j, jo = jstep(jnp.asarray(states), jo, jnp.asarray(z))
        before = po.clone()
        ll_dry, po_dry = ps(t(states), po, t(z), DT, commit=False)
        assert po_dry is po and torch.equal(po, before)
        ll_p, po = ps(t(states), po, t(z), DT)
        assert ps.last_level == 0
        assert po.data_ptr() != before.data_ptr()
        assert torch.equal(ll_dry, ll_p)
        assert_ll(ll_p, ll_j)
        assert_occ(ps, po, js, jo, P, atol=1e-5 if dtype == "f32" else 4e-3)


TRACKER_OPTIONS = {
    "select": dict(merge="select"),
    "single_level": dict(active_cap_frac=0.25, tri_cap_frac=0.75),
    "exact_slack": dict(bary_slack=0.0),
    "four_references": dict(reference_poses=4),
    "windowed": dict(lineage_gather="windowed"),
    "eager": dict(),
}


@pytest.mark.parametrize("name", list(TRACKER_OPTIONS))
def test_two_object_tracker_takes_every_option(name):
    """A two-object ``ParticleTrackerConfig`` carrying each option in its
    ``backend_options`` (and, for ``eager``, g < 0) builds and tracks on
    the CPU: both objects within 2.5 cm over 8 frames."""
    K_cam = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    cam = camera.make_camera(K_cam, 32, 32)
    meshes = [mesh.l_shape_mesh(), mesh.box_mesh(0.05, 0.08, 0.04)]
    obs = (cfg.ObservationConfig(model_sigma=0.005, sigma_factor=0.0,
                                 p_occluded_visible=0.4,
                                 p_occluded_occluded=0.1)
           if name == "eager" else
           cfg.ObservationConfig(model_sigma=0.005, sigma_factor=0.0))
    config = cfg.ParticleTrackerConfig(
        evaluation_count=128, max_kl_divergence=0.8, backend="pallas",
        observation=obs, backend_options=TRACKER_OPTIONS[name],
        transition=cfg.TransitionConfig(0.4, 2.0, damping=4.0), seed=3)
    tracker = ParticleTracker(config, meshes=meshes, camera=cam,
                              device="cpu")
    want = dict(TRACKER_OPTIONS[name])
    if name == "single_level":
        want = {"levels": [(0.25, 0.75)]}
    for k, v in want.items():
        assert getattr(tracker.sensor, k) == v
    starts = np.array([[-0.04, 0, 0.62, 1, 0, 0, 0],
                       [0.05, 0.01, 0.55, 1, 0, 0, 0]], np.float32)

    def traj(i):
        p = starts.copy()
        p[0, 0] += 0.05 * i / 30.0
        p[1, 1] -= 0.04 * i / 30.0
        return p

    src = sources.SyntheticSource(meshes, cam, traj, num_frames=8,
                                  noise_sigma=0.003, seed=5)
    result = node.run(tracker, src)
    assert result.position_rmse() < 0.025, result.position_rmse()
    assert tracker.sensor.last_level is not None
