"""The fused sensor's automatic slack per object, and the fused kernel with
a slack per triangle.

The port gives object ``k``'s triangles ``clip(bary_slack_px · (1/fx) ·
z̄_k / median_edge(mesh_k), 0, 4)``: JAX's rule run on that object alone
(``dbot_ros_tpu/ops/slack.py`` with one mesh and one object's depths).
JAX's fused sensor takes the finest mesh's median edge and the deepest
object for every mesh; with one object the two rules are one number, and
the port's single-object sensor computes it with the same operations as
before the rule was made per object (held here bit for bit).

The plain fused kernel with two slacks is held to an exact inside-test
(the port's per-triangle raycast constants, each object's triangles
widened by its own slack) through ``image_loglik``, on a scene where each
slack decides pixels. Tolerances: the rule rtol 1e-6 (float32); loglik
rtol 2e-4 + 0.05 nats on particles with no ray within 1e-4 barycentric
units of a widened edge (the kernel's slabs come from another float32
product than the oracle's constants, so such a ray may fall either way).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu.ops import slack as jslack
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.models import beam, occlusion
from dbot_ros_tpu_torch.models.image_loglik import image_loglik
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import raycast
from dbot_ros_tpu_torch.ops import slack
from dbot_ros_tpu_torch.utils import camera, se3

torch.set_num_threads(1)

KMAT = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
HW = (32, 32)
FX = 48.0
# the sphere-and-box scene of the reference's two-object eval leg, small:
# faces of very different size
CENTERS = np.array([[-0.06, 0.0, 0.6], [0.07, 0.01, 0.7]], np.float32)
EDGE = 1e-4
LL_RTOL, LL_ATOL = 2e-4, 0.05


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def meshes(num_objects=2):
    jms = [jmesh.icosphere_mesh(0.05, 2),
           jmesh.box_mesh(0.05, 0.07, 0.03)][:num_objects]
    return jms, [interop.mesh_from_numpy(fields(m)) for m in jms]


def cloud(g, P, num_objects=2, dpos=0.005, drot=0.03):
    """(P, K, 13) particles scattered around CENTERS."""
    states = np.zeros((P, num_objects, 13), np.float32)
    for k in range(num_objects):
        states[:, k, :3] = CENTERS[k] + dpos * g.standard_normal((P, 3))
        q = se3.quat_boxplus(torch.tensor([1.0, 0, 0, 0]).expand(P, 4),
                             torch.tensor(drot * g.standard_normal((P, 3)),
                                          dtype=torch.float32))
        states[:, k, 3:7] = q.numpy()
    return torch.as_tensor(states)


def sensor(pms, **kw):
    return fs.make_fused_sensor(
        pms, camera.make_camera(KMAT, *HW), beam.make_beam_params(),
        occlusion.make_occlusion_params(), occ_dtype=torch.float32, nb=32,
        **kw)


def jax_rule(z, jm, px=0.25):
    """JAX's automatic slack of one object alone: its own depths, its own
    mesh."""
    return float(jslack.auto_bary_slack(
        jslack.cloud_depth(jnp.asarray(z)), 1.0 / FX,
        jslack.median_edge([jm]), px))


def test_one_object_slack_is_the_single_rule_bit_for_bit():
    """One object: every triangle's slack is the number the rule gave
    before it was made per object (max over one object's mean depth, the
    one mesh's edge), bit for bit, and JAX's to float32 rounding; the
    sensor's call with it equals the kernel given that one number for
    every triangle (the reference's one slack, expanded)."""
    jms, pms = meshes(1)
    s = sensor(pms, levels=[])
    states = cloud(np.random.default_rng(0), 64, 1)
    got = s.triangle_slack(states)
    assert got.shape == (pms[0].padded_triangles,)
    before = slack.auto_bary_slack(
        torch.max(torch.mean(states[..., 2], dim=0)), 1.0 / s._fx,
        slack.median_edge(pms), s.bary_slack_px)
    assert torch.equal(got, before.expand_as(got))
    np.testing.assert_allclose(float(got[0]),
                               jax_rule(states[:, 0, 2].numpy(), jms[0]),
                               rtol=1e-6)
    g = np.random.default_rng(1)
    z = torch.as_tensor(np.where(g.uniform(size=HW[0] * HW[1]) < 0.05,
                                 np.nan, 0.6 + 0.01 * g.standard_normal(
                                     HW[0] * HW[1])).astype(np.float32))
    occ = s.init_occlusion(64, 0.1)
    plan = s.plan(states, z, 1 / 30)
    ll, (q, _) = s.apply(plan, states, (occ[0].clone(), occ[1]), z)
    gt = s.pack_full(states, fs.particle_pad(64))
    params = fs.make_params_vec(s.bp, s.op, plan.dtf)
    ll_one, q_one = fs.fused_loglik_packed(
        gt, occ[0].clone(), z, plan.cand, s.camera.rays, params, 64,
        nb=s.nb, ages=occ[1][:z.shape[0]],
        tri_slack=before.expand(gt.shape[0]))
    assert s.last_level == 0 == len(s.caps(z.shape[0]))    # the full level
    assert torch.equal(ll, ll_one) and torch.equal(q, q_one)


def test_two_meshes_take_each_objects_own_slack():
    """Two meshes: the slack of every union triangle is JAX's rule on its
    object alone; the two numbers differ, and JAX's two-mesh sensor would
    give the coarse box the fine sphere's."""
    jms, pms = meshes()
    s = sensor(pms)
    states = cloud(np.random.default_rng(2), 96)
    got = s.triangle_slack(states).numpy()
    T0 = pms[0].padded_triangles
    assert got.shape == (T0 + pms[1].padded_triangles,)
    want = [jax_rule(states[:, k, 2].numpy(), jms[k]) for k in range(2)]
    np.testing.assert_allclose(got[:T0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[T0:], want[1], rtol=1e-6)
    assert want[0] > 2 * want[1]
    # the reference's two-mesh rule: the finest edge, the deepest object
    ref = float(jslack.auto_bary_slack(
        jslack.cloud_depth(jnp.asarray(states[..., 2].numpy())), 1.0 / FX,
        jslack.median_edge(jms), 0.25))
    assert ref > 2 * want[1]
    fixed = sensor(pms, bary_slack=0.3).triangle_slack(states)
    assert torch.equal(fixed, torch.full_like(fixed, 0.3))


def exact_depth(mesh, poses, cand, rays, tri_slack):
    """(P, N) nearest hit of each particle's ray over its pixel's
    candidates (ids into ``mesh``, -1 = none), each triangle's inside-test
    widened by its own ``tri_slack``."""
    G, tn = raycast.pose_tri_constants(mesh, poses)
    t = torch.full((poses.shape[0], rays.shape[0]), float("inf"))
    for k in range(cand.shape[1]):
        ids = cand[:, k].clamp(min=0)
        nums = torch.einsum("nd,pnid->pni", rays, G[:, ids])
        tk = raycast._intersect_from_numerators(
            nums[..., 0], nums[..., 1], nums[..., 2], tn[:, ids],
            slack=tri_slack[ids])
        t = torch.where(cand[:, k] >= 0, torch.minimum(t, tk), t)
    return t


def scene_depth(s, states, cand, slacks):
    """The oracle depth of the two-object scene with ``slacks[k]`` on
    object ``k``'s triangles."""
    depth, off = None, 0
    for k, m in enumerate(s.meshes):
        T = m.padded_triangles
        mine = (cand >= off) & (cand < off + T)
        d = exact_depth(m, states[:, k, :7], torch.where(mine, cand - off, -1),
                        s.camera.rays, torch.full((T,), slacks[k]))
        depth = d if depth is None else torch.minimum(depth, d)
        off += T
    return depth


@pytest.mark.parametrize("slacks", [(0.0, 0.6), (0.6, 0.0)])
def test_plain_kernel_with_two_slacks_matches_the_exact_inside_test(slacks):
    """The plain fused kernel given a slack per triangle (each object's
    own) against the exact per-triangle inside-test with the same slacks,
    through ``image_loglik``; each slack decides pixels: the oracle with
    either one slack for both objects differs on both objects' pixels,
    and so does the kernel given one slack for every triangle."""
    _, pms = meshes()
    s = sensor(pms, levels=[])
    P = 64
    states = cloud(np.random.default_rng(3), P, dpos=0.004, drot=0.05)
    rays, N = s.camera.rays, s.camera.num_pixels
    truth = torch.as_tensor(np.concatenate(
        [CENTERS, np.tile([[1.0, 0, 0, 0]], (2, 1))], 1), dtype=torch.float32)
    z = torch.minimum(*(raycast.raycast_depth(m, truth[k], rays)
                        for k, m in enumerate(pms)))
    z = torch.where(torch.isfinite(z), z, 1.5)
    z[::29] = float("nan")
    cand = s.candidates(states)
    T0 = pms[0].padded_triangles
    tri_slack = torch.cat([torch.full((T0,), slacks[0]),
                           torch.full((pms[1].padded_triangles,), slacks[1])])
    params = fs.make_params_vec(s.bp, s.op, 1.0)
    occ = torch.full((fs._round_up(N, s.nb), fs.particle_pad(P)), 0.2)
    gt = s.pack_full(states, fs.particle_pad(P))

    def kernel(ts):
        return fs.fused_loglik_packed(gt, occ, z, cand, rays, params, P,
                                      nb=s.nb, tri_slack=ts)[0]

    ll = kernel(tri_slack)
    depth = scene_depth(s, states, cand, slacks)
    ll_ref, _ = image_loglik(depth, z, torch.full_like(depth, 0.2), s.bp,
                             s.op, 1.0)
    pad = fs._round_up(N, s.nb) - N
    ll_ref = ll_ref + pad * torch.log(s.bp.p_invalid_background)
    lo = scene_depth(s, states, cand, [x - EDGE for x in slacks])
    hi = scene_depth(s, states, cand, [x + EDGE for x in slacks])
    edge = ((lo != hi) & (torch.isfinite(lo) | torch.isfinite(hi))).any(1)
    assert edge.sum() < P // 2, int(edge.sum())
    ok = (ll - ll_ref).abs() <= LL_ATOL + LL_RTOL * ll_ref.abs()
    assert bool(ok[~edge].all()), float((ll - ll_ref)[~edge].abs().max())
    # each object's own slack decides pixels: one slack for both objects
    # (either) moves hits in the oracle and the loglik in the kernel
    for one in slacks:
        other = scene_depth(s, states, cand, [one, one])
        assert bool((torch.isfinite(other) != torch.isfinite(depth)).any())
        far = ((kernel(torch.full_like(tri_slack, one)) - ll).abs()
               > LL_ATOL + LL_RTOL * ll.abs())
        assert bool(far.any()), one


def test_compacted_levels_keep_each_triangles_slack():
    """Two objects with their own slacks: a compacted level (packed
    triangles and selected pixels, the slack vector following the packed
    selection) gives the full level's loglik and map."""
    _, pms = meshes()
    states = cloud(np.random.default_rng(4), 96)
    ladder, full = sensor(pms), sensor(pms, levels=[])
    rays = ladder.camera.rays
    truth = torch.as_tensor(np.concatenate(
        [CENTERS, np.tile([[1.0, 0, 0, 0]], (2, 1))], 1), dtype=torch.float32)
    z = torch.minimum(*(raycast.raycast_depth(m, truth[k], rays)
                        for k, m in enumerate(pms)))
    z = torch.where(torch.isfinite(z), z, 1.5)
    out = {}
    for name, s in (("ladder", ladder), ("full", full)):
        out[name] = s(states, s.init_occlusion(96, 0.1), z, 1 / 30)
        out[name + ".level"] = s.last_level
    caps = ladder.caps(z.shape[0])
    level = out["ladder.level"]
    assert level < len(caps) and None not in caps[level], (level, caps)
    torch.testing.assert_close(out["ladder"][0], out["full"][0], rtol=2e-5,
                               atol=1e-2)
    torch.testing.assert_close(
        ladder.occlusion_as_pn(out["ladder"][1], 96),
        full.occlusion_as_pn(out["full"][1], 96), rtol=0, atol=1e-5)
