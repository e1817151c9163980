"""Port parity: SE(3) algebra, meshes, camera, raycast and the candidate
pass of dbot_ros_tpu_torch against dbot_ros_tpu on the same numpy inputs.

Tolerances: the same float32 formulas on both sides differ only by the
rounding of reductions and library transcendental functions, so pointwise
results are held to ~1e-6 (1e-5 after 12 power-iteration steps or
depth divisions); integer outputs (ids, candidates) must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu.ops import deferred as jdeferred
from dbot_ros_tpu.ops import raycast as jraycast
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu.utils import se3 as jse3
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.ops import deferred, raycast
from dbot_ros_tpu_torch.utils import camera, mesh, se3

torch.set_num_threads(1)


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def unit_quats(g, count):
    q = g.standard_normal((count, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def random_poses(g, count, center=(0.0, 0.0, 0.6), dpos=0.01, drot=0.3):
    q = np.asarray(jse3.quat_boxplus(
        jnp.asarray(np.tile([1.0, 0, 0, 0], (count, 1)), jnp.float32),
        jnp.asarray(drot * g.standard_normal((count, 3)), jnp.float32)))
    p = np.asarray(center) + dpos * g.standard_normal((count, 3))
    return np.concatenate([p, q], axis=1).astype(np.float32)


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(n(a), n(b), atol=atol, rtol=rtol)


def test_quaternion_ops_match_jax():
    g = np.random.default_rng(0)
    q1, q2 = unit_quats(g, 64), unit_quats(g, 64)
    w = (0.8 * g.standard_normal((64, 3))).astype(np.float32)
    w[:4] *= 1e-5                      # small-angle Taylor branch
    v = g.standard_normal((64, 3)).astype(np.float32)
    for name, args in (("quat_multiply", (q1, q2)),
                       ("quat_conjugate", (q1,)),
                       ("quat_rotate", (q1, v)),
                       ("quat_to_matrix", (q1,)),
                       ("so3_exp_quat", (w,)),
                       ("so3_log", (q1,)),
                       ("quat_boxplus", (q1, w)),
                       ("quat_boxminus", (q1, q2))):
        close(getattr(se3, name)(*map(t, args)),
              getattr(jse3, name)(*map(jnp.asarray, args)), atol=2e-6)
    R = np.asarray(jse3.quat_to_matrix(jnp.asarray(q1)))
    close(se3.matrix_to_quat(t(R)), jse3.matrix_to_quat(jnp.asarray(R)),
          atol=2e-6)


def test_pose_and_state_helpers_match_jax():
    g = np.random.default_rng(1)
    p1, p2 = random_poses(g, 32), random_poses(g, 32)
    s1 = np.concatenate([p1, g.standard_normal((32, 6))], 1).astype(
        np.float32)
    s2 = np.concatenate([p2, g.standard_normal((32, 6))], 1).astype(
        np.float32)
    xi = (0.1 * g.standard_normal((32, 12))).astype(np.float32)
    pts = g.standard_normal((32, 3)).astype(np.float32)
    for name, args in (("pose_compose", (p1, p2)), ("pose_inverse", (p1,)),
                       ("pose_apply", (p1, pts)),
                       ("pose_to_matrix", (p1,)),
                       ("pose_boxplus", (p1, xi[:, :6])),
                       ("pose_boxminus", (p1, p2)),
                       ("state_boxplus", (s1, xi)),
                       ("state_boxminus", (s1, s2))):
        close(getattr(se3, name)(*map(t, args)),
              getattr(jse3, name)(*map(jnp.asarray, args)), atol=2e-6)
    sym = se3.box_symmetry_quats()
    close(sym, jse3.box_symmetry_quats(), atol=1e-7)
    close(se3.rotation_error_symmetric(t(p1[:, 3:]), t(p2[:, 3:]), sym),
          jse3.rotation_error_symmetric(jnp.asarray(p1[:, 3:]),
                                        jnp.asarray(p2[:, 3:]),
                                        jse3.box_symmetry_quats()),
          atol=2e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_states_mean_matches_jax(weighted):
    """Weighted chordal mean with the 12-step power iteration and the
    w >= 0 sign fix; (P, K, 13) batched over objects."""
    g = np.random.default_rng(2)
    P = 200
    states = np.zeros((P, 2, 13), np.float32)
    for k in range(2):
        states[:, k, :7] = random_poses(g, P, center=(0.1 * k, 0, 0.7),
                                        drot=0.2)
        states[:, k, 7:] = g.standard_normal((P, 6))
    states[::3, :, 3:7] *= -1.0        # q and -q are the same rotation
    w = None
    if weighted:
        lw = g.standard_normal(P)
        w = (np.exp(lw) / np.exp(lw).sum()).astype(np.float32)
    got = se3.states_mean(t(states), None if w is None else t(w))
    want = jse3.states_mean(jnp.asarray(states),
                            None if w is None else jnp.asarray(w))
    close(got, want, atol=1e-5)


@pytest.mark.parametrize("name", ["box", "l_shape", "tagged_l",
                                  "icosphere"])
def test_mesh_constants_match_jax(name):
    make = {"box": lambda m: m.box_mesh(0.05, 0.08, 0.04),
            "l_shape": lambda m: m.l_shape_mesh(),
            "tagged_l": lambda m: m.tagged_l_mesh(scale=1.5),
            "icosphere": lambda m: m.icosphere_mesh(0.06, 2)}[name]
    got, want = make(mesh), make(jmesh)
    assert got.num_triangles == want.num_triangles
    assert got.num_vertices == want.num_vertices
    assert got.padded_triangles == want.padded_triangles
    # the last row is the guaranteed degenerate "no triangle" target
    assert float(got.g_det[-1].abs().sum()) == 0.0
    for f in dataclasses.fields(want):
        if f.name.startswith("num_"):
            continue
        # float64 numpy math cast once to float32 on both sides
        np.testing.assert_array_equal(n(getattr(got, f.name)),
                                      np.asarray(getattr(want, f.name)))


def test_obj_parsing_matches_jax(tmp_path):
    text = ("v 0 0 0\nv 0.1 0 0\nv 0.1 0.1 0\nv 0 0.1 0\nv 0 0 0.1\n"
            "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\nf -5 -4 -1\n# comment\n")
    v, f = mesh.parse_obj(text)
    vj, fj = jmesh.parse_obj(text)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)
    path = tmp_path / "quad.obj"
    path.write_text(text)
    got = mesh.load_obj(path, scale=2.0)
    want = jmesh.make_mesh(vj * 2.0, fj)
    np.testing.assert_array_equal(n(got.g_u), np.asarray(want.g_u))
    with pytest.raises(ValueError):
        mesh.parse_obj("v 1 2\n")
    with pytest.raises(ValueError):
        mesh.make_mesh(v, np.array([[0, 1, 9]]))


def test_camera_and_preprocess_match_jax():
    K = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    for ds in (1, 4, 8):
        got = camera.make_camera(K, 480, 640, ds)
        want = jcamera.make_camera(K, 480, 640, ds)
        assert (got.height, got.width) == (want.height, want.width)
        np.testing.assert_array_equal(n(got.rays), np.asarray(want.rays))
        np.testing.assert_array_equal(n(got.camera_matrix),
                                      np.asarray(want.camera_matrix))
    kin = camera.default_kinect_camera(8)
    assert kin.num_pixels == 4800
    jk = jcamera.default_kinect_camera(8)
    conv = interop.camera_from_numpy(
        {f.name: np.asarray(getattr(jk, f.name))
         for f in dataclasses.fields(jk)})
    assert (conv.height, conv.width) == (60, 80)
    assert torch.equal(conv.rays, kin.rays)
    raw = np.array([1.0, 0.0, -2.0, np.nan, np.inf, -np.inf, 0.4, 5e-4],
                   np.float32)
    np.testing.assert_array_equal(n(camera.preprocess_depth(raw)),
                                  np.asarray(jcamera.preprocess_depth(raw)))
    np.testing.assert_array_equal(
        n(camera.preprocess_depth(raw, invalid_value=0.0)),
        np.asarray(jcamera.preprocess_depth(raw, invalid_value=0.0)))


def _scene(seed=3, count=8):
    K = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    jm, jc = jmesh.l_shape_mesh(), jcamera.make_camera(K, 32, 32)
    pm = interop.mesh_from_numpy(
        {f.name: np.asarray(getattr(jm, f.name))
         for f in dataclasses.fields(jm)})
    pc = camera.make_camera(K, 32, 32)
    poses = random_poses(np.random.default_rng(seed), count, drot=0.3)
    return jm, jc, pm, pc, poses


def test_pose_tri_constants_match_jax():
    jm, _, pm, _, poses = _scene()
    G, tn = raycast.pose_tri_constants(pm, t(poses))
    Gj, tnj = jraycast.pose_tri_constants(jm, jnp.asarray(poses))
    close(G, Gj, atol=1e-6)
    close(tn, tnj, atol=1e-6)


def test_raycast_depth_matches_jax():
    """Hit masks equal; depths equal up to f32 division rounding."""
    jm, jc, pm, pc, poses = _scene()
    got = n(raycast.raycast_depth(pm, t(poses), pc.rays, tri_chunk=64))
    want = np.asarray(jraycast.raycast_depth(jm, jnp.asarray(poses),
                                             jc.rays, 64))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got).sum() > 100
    hit = np.isfinite(want)
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-5)
    img = raycast.render_depth_image(pm, t(poses[:2]), pc)
    assert img.shape == (2, 32, 32)


@pytest.mark.parametrize("radius,num_candidates", [(2, 2), (3, 4)])
def test_raycast_ids_and_candidates_match_jax(radius, num_candidates):
    """Nearest-triangle ids of the reference pass, then the dilated
    candidate sets (torch.roll wraps at the image edges as jnp.roll)."""
    jm, jc, pm, pc, poses = _scene(seed=4, count=3)
    for pose in poses:
        z, ids = deferred.raycast_ids(pm, t(pose), pc.rays, tri_chunk=64)
        zj, idsj = jdeferred.raycast_ids(jm, jnp.asarray(pose), jc.rays, 64)
        np.testing.assert_array_equal(n(ids), np.asarray(idsj))
        hit = np.isfinite(np.asarray(zj))
        np.testing.assert_allclose(n(z)[hit], np.asarray(zj)[hit],
                                   rtol=1e-5)
        # shift the id image so the object touches the wrapped edges
        ids_np = np.roll(np.asarray(idsj).reshape(32, 32), (14, 15),
                         axis=(0, 1)).reshape(-1)
        got = deferred.candidate_ids(torch.as_tensor(ids_np), 32, 32,
                                     radius, num_candidates)
        want = jdeferred.candidate_ids(jnp.asarray(ids_np), 32, 32,
                                       radius, num_candidates)
        np.testing.assert_array_equal(n(got), np.asarray(want))
