"""Port parity of the second estimator: sigma points, process noise, the
linear Kalman filter, the body-tail model, the robust Gaussian filter,
``GaussianTracker``, its checkpoints and its command line, held against
dbot_ros_tpu on the same numpy inputs (JAX on the CPU).

Tolerances, and why:
  * sigma points (states, deltas, weights) and reconstructed moments:
    1e-6 (a 12×12 or 24×24 float32 Cholesky factor, boxplus/boxminus);
  * ``process_noise_cov`` 1e-7; ``kf`` predict/update/step 1e-5 (a
    float32 solve in two libraries); ``body_responsibility`` 1e-6;
  * ``rgf.predict``: mean 1e-6, covariance 1e-6 absolute;
  * ``rgf.update`` **with the render injected**: the port's ``render_fn``
    hands its poses to the JAX exact renderer and takes the depths back,
    so both filters see the same (S, N) depths. The update is
    discontinuous in the render (a pixel hits or misses), so only this
    way is the filter's arithmetic held to rounding: mean 1e-5,
    covariance rtol 1e-3 + 1e-8, background 1e-6, ``occ_prior`` 1e-5
    + rtol 5e-4, ``mean_beta`` / ``innovation_rms`` / ``obs_loglik`` rtol
    1e-4. The relative part of ``occ_prior``: a pixel whose depth lies k
    sigmas off the hit-conditional mean m turns m's float32 rounding
    (the 25 sigma depths are summed in another order) into a relative
    error k/sigma · δm of its density, about 1e-4 at 5 sigmas and more
    further out, and the responsibilities of such a pixel carry it;
  * ``GaussianTracker`` against the JAX tracker, each rendering for
    itself: the pose within 1e-3 m and 1e-2 rad on every frame (edge
    pixels may flip between the two renderers), both within 5 mm of the
    truth when the background map is seeded from a frame of the empty
    scene (a pixel is 9 mm wide at this camera and depth; seeded from a
    frame that holds the object, as ``node.run`` does, either package
    stays within 1.5 cm, the bound of tests/test_runtime.py); a trial
    picks the same winner; the union mask is equal;
  * checkpoints: a round trip gives the same belief bit for bit; a file
    written by the JAX package gives the JAX tracker's next frame within
    1e-3 m;
  * ``make_batched_step``: 1e-6 against single steps (``occ_prior`` as
    above);
  * command line on the CPU: the bounds of the particle runs in
    tests/test_torch_cli.py (position RMSE 3 cm).
"""

import contextlib
import dataclasses
import functools
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu import config as jcfg
from dbot_ros_tpu.filters import kf as jkf
from dbot_ros_tpu.filters import rgf as jrgf
from dbot_ros_tpu.models import beam as jbeam
from dbot_ros_tpu.models import body_tail as jbody
from dbot_ros_tpu.models import occlusion as jocc
from dbot_ros_tpu.models import transition as jtrans
from dbot_ros_tpu.ops import deferred as jdeferred
from dbot_ros_tpu.ops import raycast as jraycast
from dbot_ros_tpu.ops import sigma_points as jsp
from dbot_ros_tpu.runtime import checkpoint as jcheckpoint
from dbot_ros_tpu.trackers.gaussian import GaussianTracker as JaxTracker
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu.utils import se3 as jse3
from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.filters import kf, rgf
from dbot_ros_tpu_torch.models import body_tail, transition
from dbot_ros_tpu_torch.ops import deferred, raycast
from dbot_ros_tpu_torch.ops import sigma_points as sp
from dbot_ros_tpu_torch.ops.deferred import make_sigma_renderer
from dbot_ros_tpu_torch.runtime import checkpoint, cli, node, sources
from dbot_ros_tpu_torch.trackers import base
from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker

torch.set_num_threads(1)

H, W = 32, 32
N = H * W
KMAT = np.array([[64.0, 0, 16], [0, 64.0, 16], [0, 0, 1.0]])
DT = 1.0 / 30.0
ITER = 2


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def random_spd(g, dim, scale=1e-3):
    a = g.standard_normal((dim, dim))
    return (scale * (a @ a.T / dim + 0.5 * np.eye(dim))).astype(np.float32)


def random_states(g, shape):
    s = np.zeros(shape + (13,), np.float32)
    s[..., :3] = [0.0, 0.0, 0.6] + 0.02 * g.standard_normal(shape + (3,))
    q = g.standard_normal(shape + (4,))
    s[..., 3:7] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    s[..., 7:] = 0.2 * g.standard_normal(shape + (6,))
    return s


# ---------------------------------------------------------------------------
# sigma points, process noise, Kalman filter, body-tail model
# ---------------------------------------------------------------------------

def test_sigma_points_match_jax():
    g = np.random.default_rng(0)
    mean, cov = random_states(g, ()), random_spd(g, 12)
    want = jsp.sigma_points(jnp.asarray(mean), jnp.asarray(cov),
                            **jsp.default_ut_params())
    got = sp.sigma_points(t(mean), t(cov), **sp.default_ut_params())
    assert got[0].shape == (25, 13) and got[1].shape == (25, 12)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-6)
    assert sp.default_ut_params() == jsp.default_ut_params()
    for kw in ({}, dict(alpha=0.5, beta=2.0, kappa=3.0)):
        wm, wc, lam = sp.unscented_weights(12, **kw)
        jwm, jwc, jlam = jsp.unscented_weights(12, **kw)
        np.testing.assert_allclose(n(wm), np.asarray(jwm), atol=1e-6)
        np.testing.assert_allclose(n(wc), np.asarray(jwc), atol=1e-6)
        assert lam == pytest.approx(jlam)
    # a covariance that is not positive definite gives garbage, never an
    # exception (the reference returns NaNs)
    sp.sigma_points(t(mean), t(-np.eye(12)))


@pytest.mark.parametrize("num_objects", [1, 2])
def test_scene_sigma_points_and_moments_match_jax(num_objects):
    g = np.random.default_rng(num_objects)
    D = 12 * num_objects
    mean, cov = random_states(g, (num_objects,)), random_spd(g, D)
    want = jsp.scene_sigma_points(jnp.asarray(mean), jnp.asarray(cov),
                                  kappa=1.0)
    got = sp.scene_sigma_points(t(mean), t(cov), kappa=1.0)
    assert got[0].shape == (2 * D + 1, num_objects, 13)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-6)
    # moments of the JAX sigma states, referenced off the mean
    ref = random_states(g, (num_objects,))
    ref[:, :7] = mean[:, :7]
    ref[:, :3] += 0.003
    jm, jc, jcen = jsp.scene_reconstruct_moments(
        want[0], jnp.asarray(ref), want[2], want[3])
    pm, pc, pcen = sp.scene_reconstruct_moments(
        t(want[0]), t(ref), t(want[2]), t(want[3]))
    np.testing.assert_allclose(n(pm), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(n(pc), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(n(pcen), np.asarray(jcen), atol=1e-6)
    np.testing.assert_allclose(n(pc), cov, atol=2e-6)    # the UT recovers P


def test_reconstruct_moments_matches_jax():
    g = np.random.default_rng(3)
    mean, cov = random_states(g, ()), random_spd(g, 12)
    states, _, wm, wc = jsp.sigma_points(jnp.asarray(mean),
                                         jnp.asarray(cov), kappa=1.0)
    ref = mean.copy()
    ref[:3] += 0.002
    want = jsp.reconstruct_moments(states, jnp.asarray(ref), wm, wc)
    got = sp.reconstruct_moments(t(states), t(ref), t(wm), t(wc))
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("dt", [DT, 0.25])
def test_process_noise_cov_matches_jax(dt):
    jp = jtrans.make_transition_params(0.3, 1.5, damping=6.0)
    tp = interop.transition_params_from_numpy(fields(jp))
    want = np.asarray(jtrans.process_noise_cov(jnp.float32(dt), jp))
    for d in (float(np.float32(dt)), torch.tensor(dt)):
        got = transition.process_noise_cov(d, tp)
        assert got.shape == (12, 12) and got.dtype == torch.float32
        np.testing.assert_allclose(n(got), want, atol=1e-7)


@pytest.mark.parametrize("control", [False, True])
def test_kalman_filter_matches_jax(control):
    g = np.random.default_rng(5)
    dim, m = 6, 3
    A = (np.eye(dim) + 0.1 * g.standard_normal((dim, dim))).astype(np.float32)
    Hm = g.standard_normal((m, dim)).astype(np.float32)
    Q, R = random_spd(g, dim, 1e-2), random_spd(g, m, 1e-1)
    B = g.standard_normal((dim, 2)).astype(np.float32) if control else None
    u = g.standard_normal(2).astype(np.float32) if control else None
    mean = g.standard_normal(dim).astype(np.float32)
    cov = random_spd(g, dim, 1.0)
    y = g.standard_normal(m).astype(np.float32)
    jb = jkf.LinearBelief(jnp.asarray(mean), jnp.asarray(cov))
    pb = kf.LinearBelief(t(mean), t(cov))
    j = lambda x: None if x is None else jnp.asarray(x)
    tt = lambda x: None if x is None else t(x)
    pairs = [
        (kf.predict(pb, t(A), t(Q), tt(B), tt(u)),
         jkf.predict(jb, j(A), j(Q), j(B), j(u))),
        (kf.update(pb, t(y), t(Hm), t(R)), jkf.update(jb, j(y), j(Hm), j(R))),
        (kf.step(pb, t(y), t(A), t(Q), t(Hm), t(R), tt(B), tt(u)),
         jkf.step(jb, j(y), j(A), j(Q), j(Hm), j(R), j(B), j(u)))]
    for got, want in pairs:
        np.testing.assert_allclose(n(got.mean), np.asarray(want.mean),
                                   atol=1e-5)
        np.testing.assert_allclose(n(got.cov), np.asarray(want.cov),
                                   atol=1e-5)


@pytest.mark.parametrize("body_weight", [1.0, "per_pixel"])
def test_body_responsibility_matches_jax(body_weight):
    g = np.random.default_rng(6)
    jbp = jbeam.make_beam_params()
    bp = interop.beam_params_from_numpy(fields(jbp))
    count = 400
    m = g.uniform(0.5, 1.5, count).astype(np.float32)
    y = (m + 0.01 * g.standard_normal(count)).astype(np.float32)
    y[::7] = np.nan                     # invalid returns
    y[1::11] = 0.2                      # below min_depth
    y[2::13] = 6.0                      # above max_depth
    y[3::5] = m[3::5] - 0.2             # in front of the prediction
    y[4::9] = m[4::9] + 0.3             # behind it
    S = g.uniform(1e-5, 1e-3, count).astype(np.float32)
    bw = (g.uniform(0, 1, count).astype(np.float32)
          if body_weight == "per_pixel" else 1.0)
    want = jbody.body_responsibility(jnp.asarray(y), jnp.asarray(m),
                                     jnp.asarray(S), jbp, jnp.asarray(bw))
    got = body_tail.body_responsibility(
        t(y), t(m), t(S), bp, t(bw) if body_weight == "per_pixel" else 1.0)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)
    invalid = ~(np.isfinite(y) & (y >= 0.4) & (y <= 5.0))
    assert invalid.sum() > 50 and np.all(n(got)[invalid] == 0.0)
    in_front = np.zeros(count, bool)
    in_front[3::5] = True
    assert n(got)[in_front & ~invalid].max() < 0.1     # occluder: rejected


# ---------------------------------------------------------------------------
# the filter
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def scene(num_objects=1):
    jc = jcamera.make_camera(KMAT, H, W)
    jms = [jmesh.l_shape_mesh(), jmesh.box_mesh(0.06, 0.10, 0.05)][:num_objects]
    jbp, jop = jbeam.make_beam_params(), jocc.make_occlusion_params()
    jtp = jtrans.make_transition_params(0.1, 0.5, damping=4.0)

    @jax.jit
    def jrender(poses):
        if poses.ndim == 2:
            return jraycast.raycast_depth(jms[0], poses, jc.rays, 128)
        d = None
        for k, m in enumerate(jms):
            dk = jraycast.raycast_depth(m, poses[:, k], jc.rays, 128)
            d = dk if d is None else jnp.minimum(d, dk)
        return d

    return dict(
        jc=jc, jms=jms, jbp=jbp, jop=jop, jtp=jtp, jrender=jrender,
        pc=interop.camera_from_numpy(fields(jc)),
        pms=[interop.mesh_from_numpy(fields(m)) for m in jms],
        bp=interop.beam_params_from_numpy(fields(jbp)),
        op=interop.occlusion_params_from_numpy(fields(jop)),
        tp=interop.transition_params_from_numpy(fields(jtp)))


TRUTH = np.array([[0.006, 0.004, 0.605, 0.9987503, 0.0, 0.0499792, 0.0],
                  [0.11, -0.02, 0.66, 1.0, 0.0, 0.0, 0.0]], np.float32)
START = np.array([[0.0, 0.0, 0.6, 1.0, 0.0, 0.0, 0.0],
                  [0.106, -0.017, 0.656, 1.0, 0.0, 0.0, 0.0]], np.float32)


def frame(s, poses, g, background=1.5, sigma=0.002):
    """A noisy frame of the scene at ``poses`` (K, 7) over a plane."""
    poses = np.asarray(poses, np.float32).reshape(-1, 7)
    d = np.asarray(s["jrender"](jnp.asarray(
        poses[None] if len(poses) > 1 else poses[:1])))[0]
    z = np.where(np.isfinite(d), d, background).astype(np.float32)
    return z + sigma * g.standard_normal(N).astype(np.float32)


def belief_pair(s, num_objects, memory=True, first=None, scale=1.0):
    pose = START[0] if num_objects == 1 else START[:num_objects]
    first = np.full(N, 1.5, np.float32) if first is None else first
    kw = dict(first_frame=None, pos_sigma=0.02 * scale,
              rot_sigma=0.1 * scale, vel_sigma=0.1 * scale,
              initial_occlusion_prob=0.1 if memory else None)
    jb = jrgf.init_belief(jax.random.PRNGKey(0), jnp.asarray(pose),
                          **{**kw, "first_frame": jnp.asarray(first)})
    pb = rgf.init_belief(pose, **{**kw, "first_frame": first})
    return jb, pb


def test_init_belief_matches_jax():
    s = scene()
    first = np.full(N, 1.2, np.float32)
    first[::5] = np.nan
    for k in (1, 2):
        jb, pb = belief_pair(s, k, first=first)
        for name in ("mean", "cov", "background", "occ_prior"):
            np.testing.assert_array_equal(n(getattr(pb, name)),
                                          np.asarray(getattr(jb, name)))
    jb, pb = belief_pair(s, 1, memory=False)
    assert pb.occ_prior is None and jb.occ_prior is None
    flat = rgf.init_belief(START[0], num_pixels=7, background_depth=3.0)
    assert flat.background.tolist() == [3.0] * 7
    assert not hasattr(pb, "key")


@pytest.mark.parametrize("num_objects", [1, 2])
def test_predict_matches_jax(num_objects):
    s = scene(num_objects)
    jb, pb = belief_pair(s, num_objects)
    g = np.random.default_rng(7)
    vel = 0.1 * g.standard_normal(jb.mean.shape[:-1] + (6,)).astype(
        np.float32)
    jb = dataclasses.replace(jb, mean=jb.mean.at[..., 7:].set(vel))
    pb = dataclasses.replace(pb, mean=torch.cat(
        [pb.mean[..., :7], t(vel)], dim=-1))
    for dt in (DT, 0.2):
        want = jrgf.predict(jb, jnp.float32(dt), s["jtp"])
        for d in (float(np.float32(dt)), torch.tensor(dt)):
            got = rgf.predict(pb, d, s["tp"])
            np.testing.assert_allclose(n(got.mean), np.asarray(want.mean),
                                       atol=1e-6)
            np.testing.assert_allclose(n(got.cov), np.asarray(want.cov),
                                       atol=1e-6)
            assert got.background is pb.background
            assert got.occ_prior is pb.occ_prior


def injected(s):
    """The port's render_fn: poses out to the JAX exact renderer, depths
    back, so both filters see the same depths."""
    def render(poses):
        return torch.as_tensor(np.asarray(s["jrender"](
            jnp.asarray(poses.numpy()))))
    return render


UPDATE_CASES = {
    # name: (objects, memory, learn_world, frame kind, belief scale)
    "memory_on": (1, True, True, "plain", 1.0),
    "memory_off": (1, False, True, "plain", 1.0),
    "frozen_world": (1, True, False, "plain", 1.0),
    "all_invalid": (1, True, True, "invalid", 1.0),
    "occluder_bar": (1, True, True, "bar", 1.0),
    "two_objects": (2, True, True, "plain", 1.0),
    "inflated_past_the_cap": (1, True, True, "plain", 8.0),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_with_injected_render_matches_jax(case):
    num_objects, memory, learn_world, kind, scale = UPDATE_CASES[case]
    s = scene(num_objects)
    g = np.random.default_rng(11)
    z = frame(s, TRUTH[:num_objects], g)
    z[::29] = np.nan
    z[5::53] = 0.2
    if kind == "invalid":
        z[:] = np.nan
    elif kind == "bar":
        z.reshape(H, W)[:, 12:17] = 0.45
    jb, pb = belief_pair(s, num_objects, memory=memory, scale=scale)
    if scale > 1.0:
        sig = np.sqrt(np.diag(n(pb.cov)))
        assert sig[0] > 0.04 and sig[3] > 0.25       # past lin_cap_*
    kw = dict(iterations=ITER, learn_world=learn_world)
    jn, ji = jax.jit(functools.partial(
        jrgf.update, render_fn=s["jrender"], bp=s["jbp"],
        occ_params=s["jop"], **kw))(jb, jnp.asarray(z))
    pn, pi = rgf.update(pb, t(z), injected(s), s["bp"],
                        occ_params=s["op"], **kw)
    np.testing.assert_allclose(n(pn.mean), np.asarray(jn.mean), atol=1e-5)
    np.testing.assert_allclose(n(pn.cov), np.asarray(jn.cov), rtol=1e-3,
                               atol=1e-8)
    np.testing.assert_allclose(n(pn.background), np.asarray(jn.background),
                               atol=1e-6)
    if memory:
        np.testing.assert_allclose(n(pn.occ_prior),
                                   np.asarray(jn.occ_prior), atol=1e-5,
                                   rtol=5e-4)
    else:
        assert pn.occ_prior is None and jn.occ_prior is None
    for name in ("mean_beta", "innovation_rms", "obs_loglik"):
        np.testing.assert_allclose(float(getattr(pi, name)),
                                   float(getattr(ji, name)), rtol=1e-4,
                                   atol=1e-7)
    np.testing.assert_array_equal(n(pi.mean_state), n(pn.mean))
    if not learn_world:
        # the world model comes back as the tensors that went in
        assert pn.background is pb.background
        assert pn.occ_prior is pb.occ_prior
        np.testing.assert_array_equal(np.asarray(jn.background),
                                      np.asarray(jb.background))
    if kind == "invalid":
        np.testing.assert_allclose(n(pn.mean), n(pb.mean), atol=1e-5)
        assert float(pi.mean_beta) > 0.1


def test_update_writes_nothing_in_place():
    s = scene()
    g = np.random.default_rng(12)
    z = t(frame(s, TRUTH[:1], g))
    _, pb = belief_pair(s, 1)
    before = {f.name: getattr(pb, f.name).clone()
              for f in dataclasses.fields(pb)}
    z0 = z.clone()
    rgf.rgf_step(pb, z, injected(s), s["tp"], DT, s["bp"], iterations=ITER,
                 occ_params=s["op"])
    for name, v in before.items():
        assert torch.equal(getattr(pb, name), v), name
    assert torch.equal(z, z0)


def test_batched_step_equals_single_steps():
    s = scene()
    g = np.random.default_rng(13)
    def exact(poses):
        return raycast.raycast_depth(s["pms"][0], poses, s["pc"].rays)

    for render in (exact, make_sigma_renderer(s["pms"], s["pc"].rays, H, W)):
        beliefs, frames = [], []
        for i in range(3):
            pose = START[0].copy()
            pose[0] += 0.01 * i
            truth = pose.copy()
            truth[:3] += [0.004, -0.003, 0.004]
            frames.append(t(frame(s, truth[None], g)))
            beliefs.append(rgf.init_belief(
                pose, first_frame=np.full(N, 1.5, np.float32),
                initial_occlusion_prob=0.1))
        kw = dict(iterations=ITER, occ_params=s["op"])
        step = rgf.make_batched_step(render, s["tp"], DT, s["bp"], **kw)
        stacked = rgf.stack_beliefs(beliefs)
        assert stacked.mean.shape == (3, 13) and stacked.cov.shape == (
            3, 12, 12)
        nb, info = step(stacked, torch.stack(frames))
        for i in range(3):
            b1, i1 = rgf.rgf_step(beliefs[i], frames[i], render, s["tp"],
                                  DT, s["bp"], **kw)
            for name in ("mean", "cov", "background"):
                np.testing.assert_allclose(
                    n(getattr(nb, name)[i]), n(getattr(b1, name)),
                    atol=1e-6)
            np.testing.assert_allclose(n(nb.occ_prior[i]), n(b1.occ_prior),
                                       atol=1e-5, rtol=5e-4)
            np.testing.assert_allclose(n(info.mean_state[i]),
                                       n(i1.mean_state), atol=1e-6)
            np.testing.assert_allclose(float(info.obs_loglik[i]),
                                       float(i1.obs_loglik), rtol=1e-5)
    # a memoryless stack stays memoryless
    plain = rgf.stack_beliefs([dataclasses.replace(b, occ_prior=None)
                               for b in beliefs])
    nb, _ = rgf.make_batched_step(render, s["tp"], DT, s["bp"],
                                  iterations=1)(plain, torch.stack(frames))
    assert nb.occ_prior is None and nb.mean.shape == (3, 13)


# ---------------------------------------------------------------------------
# the tracker
# ---------------------------------------------------------------------------

def tracker_pair(num_objects=1, bary_slack=None, **overrides):
    """A JAX and a port tracker of one configuration; ``bary_slack`` (not
    a tracker option) is handed to both sigma renderers as they are
    made, in place of the automatic slack."""
    s = scene(num_objects)
    kw = dict(update_iterations=ITER, **overrides)
    tr = dict(linear_acceleration_sigma=0.1, angular_acceleration_sigma=0.5,
              damping=4.0)
    with contextlib.ExitStack() as stack:
        if bary_slack is not None:
            for module in (jdeferred, deferred):
                stack.enter_context(mock.patch.object(
                    module, "make_sigma_renderer", functools.partial(
                        module.make_sigma_renderer, bary_slack=bary_slack)))
        jt = JaxTracker(jcfg.GaussianTrackerConfig(
            transition=jcfg.TransitionConfig(**tr), **kw),
            meshes=s["jms"], camera=s["jc"])
        pt = GaussianTracker(cfg.GaussianTrackerConfig(
            transition=cfg.TransitionConfig(**tr), **kw),
            meshes=s["pms"], camera=s["pc"], device="cpu")
    return s, jt, pt


@functools.lru_cache(maxsize=None)
def shared_pair():
    """One pair for the tests that can share the JAX tracker's compiled
    step (each re-initializes it)."""
    return tracker_pair()


def traj(i):
    p = TRUTH[:1].copy()
    p[0, 0] += 0.0015 * i
    p[0, 2] += 0.001 * i
    return p


EMPTY = np.full(N, 1.5, np.float32)     # the scene without the object


def tracker_frame(s, poses_model, g):
    """A frame of the scene at model-frame poses (what a tracker takes and
    gives; the filter and ``frame`` work in the centred-mesh frame)."""
    poses_model = np.asarray(poses_model, np.float32).reshape(-1, 7)
    centred = [n(base.to_center_frame(t(p), m.center))
               for p, m in zip(poses_model, s["pms"])]
    return frame(s, np.stack(centred), g)


def frames_of(s, count, seed=21):
    g = np.random.default_rng(seed)
    return [tracker_frame(s, traj(i), g) for i in range(count)]


def pose_errors(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    rot = np.asarray(jnp.linalg.norm(jse3.quat_boxminus(
        jnp.asarray(a[..., 3:7]), jnp.asarray(b[..., 3:7])), axis=-1))
    return np.linalg.norm(a[..., :3] - b[..., :3], axis=-1).max(), rot.max()


def test_gaussian_tracker_follows_the_jax_tracker():
    s, jt, pt = shared_pair()
    zs = frames_of(s, 6)
    jt.initialize(jnp.asarray(traj(0)[0]), first_frame=jnp.asarray(EMPTY))
    pt.initialize(traj(0)[0], first_frame=EMPTY)
    assert pt.trial_active is None
    for i, z in enumerate(zs):
        jp, ji = jt.track(jnp.asarray(z))
        pp, pi = pt.track(z.reshape(H, W))
        assert pp.shape == (7,) and pp.dtype == torch.float32
        dpos, drot = pose_errors(n(pp), np.asarray(jp))
        assert dpos < 1e-3 and drot < 1e-2, (i, dpos, drot)
        for pose in (n(pp), np.asarray(jp)):
            assert np.linalg.norm(pose[:3] - traj(i)[0, :3]) < 5e-3
        np.testing.assert_allclose(float(pi.mean_beta), float(ji.mean_beta),
                                   atol=0.02)
    # a real interval of two frames: dt scales the noise and the memory
    jp, _ = jt.track(jnp.asarray(zs[-1]), dt=2 * DT)
    pp, _ = pt.track(zs[-1], dt=2 * DT)
    dpos, drot = pose_errors(n(pp), np.asarray(jp))
    assert dpos < 1e-3 and drot < 1e-2
    np.testing.assert_allclose(n(pt.belief.cov), np.asarray(jt.belief.cov),
                               rtol=0.05, atol=1e-7)
    np.testing.assert_allclose(n(pt.centers), np.asarray(jt.centers),
                               atol=1e-7)


def test_track_takes_dt_as_a_tensor():
    s, _, pt = shared_pair()
    zs = frames_of(s, 2)
    outs = []
    for dt in (0.05, torch.tensor(0.05)):
        pt.initialize(traj(0)[0], first_frame=EMPTY)
        pt.track(zs[0])
        outs.append((pt.track(zs[1], dt=dt)[0], pt.belief.cov))
    np.testing.assert_allclose(n(outs[0][0]), n(outs[1][0]), atol=1e-6)
    np.testing.assert_allclose(n(outs[0][1]), n(outs[1][1]), rtol=1e-4,
                               atol=1e-9)


def test_trial_picks_the_jax_winner_and_commits_once():
    s, jt, pt = shared_pair()
    zs = frames_of(s, 5)
    good = traj(0)[0]
    off = good.copy()
    off[0] += 0.15                       # a rival out of the filter's reach
    hyp = np.stack([off, good])          # the search argmax is the rival
    kw = dict(trial_frames=3, trial_switch_margin=0.5)
    jt.initialize(jnp.asarray(off), first_frame=jnp.asarray(EMPTY),
                  hypotheses=jnp.asarray(hyp), **kw)
    pt.initialize(off, first_frame=EMPTY, hypotheses=hyp, **kw)
    assert pt.trial_active == jt.trial_active == 2
    # the union of both hypotheses' silhouettes is masked out of the seed
    jbg, pbg = np.asarray(jt.belief.background), n(pt.belief.background)
    np.testing.assert_array_equal(pbg == np.float32(5.0),
                                  jbg == np.float32(5.0))
    assert (pbg == np.float32(5.0)).sum() > 30
    bg0 = pt._trial["beliefs"][0].background
    seeded = bg0.clone()
    held = []
    for i in range(3):
        jp, _ = jt.track(jnp.asarray(zs[i]))
        pp, _ = pt.track(zs[i])
        held.append(n(pp))
        if i < 2:
            assert pt.trial_active == 2
            # frozen world: no hypothesis adapts its map during the trial
            assert all(torch.equal(b.background, seeded)
                       for b in pt._trial["beliefs"])
    assert pt.trial_active is None and jt.trial_active is None
    # slot 0 (the rival) was published during the trial; the commit at its
    # end jumps to the winner both packages pick
    assert np.linalg.norm(held[1][:3] - good[:3]) > 0.01
    dpos, drot = pose_errors(held[2], np.asarray(jp))
    assert dpos < 1e-3 and drot < 1e-2
    assert np.linalg.norm(held[2][:3] - traj(2)[0, :3]) < 5e-3
    assert torch.equal(pt.belief.background, seeded)
    # fewer than two hypotheses: no trial, as in the reference
    pt.initialize(good, first_frame=EMPTY, hypotheses=good[None])
    assert pt.trial_active is None


def test_trial_reads_the_scores_once_per_frame(monkeypatch):
    s, _, pt = shared_pair()
    zs = frames_of(s, 2)
    hyp = np.stack([traj(0)[0]] * 3)
    pt.initialize(traj(0)[0], first_frame=EMPTY, hypotheses=hyp,
                  hypothesis_logits=np.array([0.0, 1.0, 0.5]),
                  trial_frames=4)
    assert pt.trial_active == 3
    reads = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda self: reads.append(self.shape) or real(self))
    monkeypatch.setattr(torch.Tensor, "item", lambda self: 1 / 0)
    monkeypatch.setattr(torch.Tensor, "__float__", lambda self: 1 / 0)
    pt.track(zs[1])
    assert reads == [torch.Size([3])]
    assert len(pt._trial["scores"]) == 3 and pt._trial["left"] == 3


def test_reuse_background_keeps_the_learned_map():
    s, _, pt = shared_pair()
    zs = frames_of(s, 3)
    pt.initialize(traj(0)[0], first_frame=EMPTY)
    for z in zs:
        pt.track(z)
    learned = pt.belief.background
    hyp = np.stack([traj(2)[0], traj(0)[0]])
    pt.initialize(traj(2)[0], first_frame=zs[2], hypotheses=hyp,
                  reuse_background=True)
    assert pt.belief.background is learned           # no mask, no re-seed
    assert all(b.background is learned for b in pt._trial["beliefs"])
    pt.initialize(traj(2)[0], first_frame=zs[2])
    assert pt.belief.background is not learned


def test_restore_reseeds_a_missing_occlusion_memory():
    s, _, pt = shared_pair()
    zs = frames_of(s, 2)
    pt.initialize(traj(0)[0], first_frame=EMPTY)
    pt.track(zs[0])
    old = dataclasses.replace(pt.belief, occ_prior=None)
    pt.restore(old)
    assert pt.trial_active is None
    assert torch.equal(pt.belief.occ_prior,
                       torch.full((N,), np.float32(0.1)))
    pose, _ = pt.track(zs[1])
    assert np.linalg.norm(n(pose)[:3] - traj(1)[0, :3]) < 5e-3
    # without the memory configured the leaf stays absent
    _, _, plain = tracker_pair(occlusion_memory=False)[0:3]
    plain.restore(old)
    assert plain.belief.occ_prior is None
    plain.track(zs[1])
    assert plain.belief.occ_prior is None


def test_track_before_initialize_raises_and_the_card_is_the_default():
    s = scene()
    conf = cfg.GaussianTrackerConfig()
    tracker = GaussianTracker(conf, mesh=s["pms"][0], camera=s["pc"],
                              device="cpu")
    with pytest.raises(RuntimeError, match="initialize"):
        tracker.track(np.zeros(N, np.float32))
    with pytest.raises(ValueError, match="sigma_backend"):
        GaussianTracker(cfg.GaussianTrackerConfig(sigma_backend="opengl"),
                        mesh=s["pms"][0], camera=s["pc"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GaussianTracker(conf, mesh=s["pms"][0], camera=s["pc"])
    assert tracker.device.type == "cpu"


@pytest.mark.parametrize("stride", [2, 0])
def test_pixel_stride_matches_jax(stride):
    """stride 0 asks for the budget's stride (1 at this size)."""
    s, jt, pt = tracker_pair(pixel_stride=stride)
    want = stride or 1
    assert pt.pixel_stride == want
    zs = frames_of(s, 3)
    jt.initialize(jnp.asarray(traj(0)[0]), first_frame=jnp.asarray(EMPTY))
    pt.initialize(traj(0)[0], first_frame=EMPTY)
    assert pt.belief.background.shape == (N // want,)
    for i, z in enumerate(zs):
        jp, _ = jt.track(jnp.asarray(z))
        pp, _ = pt.track(z)
        dpos, drot = pose_errors(n(pp), np.asarray(jp))
        assert dpos < 1e-3 and drot < 1e-2, (i, dpos, drot)
        assert np.linalg.norm(n(pp)[:3] - traj(i)[0, :3]) < 5e-3


@pytest.mark.parametrize("num_objects,backend", [(1, "exact"),
                                                 (2, "deferred")])
def test_sigma_backends_and_scenes_match_jax(num_objects, backend):
    """The two-object scene takes a fixed slack: the port's automatic
    slack is per object, JAX's measures both meshes in the finer one's
    units (test_torch_deferred.py holds each rule to JAX's)."""
    s, jt, pt = tracker_pair(num_objects, sigma_backend=backend,
                             bary_slack=None if num_objects == 1 else 0.1)
    g = np.random.default_rng(31)
    start = START[0] if num_objects == 1 else START
    jt.initialize(jnp.asarray(start), first_frame=jnp.asarray(EMPTY))
    pt.initialize(start, first_frame=EMPTY)
    for _ in range(4):
        z = tracker_frame(s, TRUTH[:num_objects], g)
        jp, _ = jt.track(jnp.asarray(z))
        pp, _ = pt.track(z)
        dpos, drot = pose_errors(n(pp), np.asarray(jp))
        assert dpos < 1e-3 and drot < 1e-2
    assert pp.shape == ((7,) if num_objects == 1 else (2, 7))
    err = np.linalg.norm(n(pp).reshape(-1, 7)[:, :3]
                         - TRUTH[:num_objects, :3], axis=1)
    assert err.max() < 5e-3


def test_describe_covers_both_trackers():
    s, _, pt = shared_pair()
    text = base.describe(pt)
    assert text.startswith("GaussianTracker (robust multi-sensor GF): "
                           f"iterations={ITER}, trust_sigma=1, "
                           "pixel_stride=1")
    assert "sigma_backend=deferred" in text and "device=cpu" in text
    assert "camera: 32x32 (1024 px)" in text and "beam model:" in text
    particle = ParticleTracker(
        cfg.ParticleTrackerConfig(evaluation_count=32, backend="xla",
                                  moving_average_update_rate=0.5),
        meshes=s["pms"], camera=s["pc"], device="cpu")
    lines = base.describe(particle).splitlines()
    assert lines[0] == ("ParticleTracker (RBC-PF): 32 particles, "
                        "backend=xla, max_kl=1, device=cpu")
    assert lines[4].startswith("  occlusion chain: p_v->o=0.1")
    assert lines[-1] == "  output EMA rate=0.5" and len(lines) == 7


# ---------------------------------------------------------------------------
# checkpoints and the command line
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_gives_the_same_next_frame(tmp_path):
    s, _, pt = shared_pair()
    zs = frames_of(s, 4)
    pt.initialize(traj(0)[0], first_frame=EMPTY)
    for z in zs[:3]:
        pt.track(z)
    path = str(tmp_path / "gauss.npz")
    checkpoint.save_belief(path, pt.belief)
    want, _ = pt.track(zs[3])
    want_belief = pt.belief
    with np.load(path) as data:
        assert set(data.files) == {"__kind__", "mean", "cov", "background",
                                   "occ_prior"}
        assert str(data["__kind__"]) == "gaussian"
    back = checkpoint.load_belief(path)
    assert isinstance(back, rgf.GaussianBelief)
    pt.restore(back)
    got, _ = pt.track(zs[3])
    for f in dataclasses.fields(want_belief):
        assert torch.equal(getattr(pt.belief, f.name),
                           getattr(want_belief, f.name)), f.name
    # the published pose passes through the output smoothing, which
    # restarts at the restored mean: equal to rounding
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)
    # a belief without the memory leaves the entry out, and loads
    checkpoint.save_belief(path, dataclasses.replace(back, occ_prior=None))
    with np.load(path) as data:
        assert "occ_prior" not in data.files
    assert checkpoint.load_belief(path).occ_prior is None


@pytest.mark.parametrize("memory", [True, False])
def test_checkpoint_written_by_jax_loads_and_tracks(tmp_path, memory):
    s, jt, pt = shared_pair()
    zs = frames_of(s, 4)
    jt.initialize(jnp.asarray(traj(0)[0]), first_frame=jnp.asarray(EMPTY))
    for z in zs[:3]:
        jt.track(jnp.asarray(z))
    jbel = jt.belief if memory else dataclasses.replace(jt.belief,
                                                        occ_prior=None)
    path = str(tmp_path / "jax_gauss.npz")
    jcheckpoint.save_belief(path, jbel)
    with np.load(path) as data:
        assert "key" in data.files            # ignored by the port
    bel = interop.checkpoint_from_jax(path)
    np.testing.assert_array_equal(n(bel.mean), np.asarray(jbel.mean))
    np.testing.assert_array_equal(n(bel.cov), np.asarray(jbel.cov))
    assert (bel.occ_prior is None) == (not memory)
    same = checkpoint.load_belief(path)       # the port's own loader too
    assert torch.equal(same.background, bel.background)
    want, _ = jt.track(jnp.asarray(zs[3]))
    pt.restore(bel)                           # re-seeds a missing memory
    got, _ = pt.track(zs[3])
    if memory:
        dpos, drot = pose_errors(n(got), np.asarray(want))
        assert dpos < 1e-3 and drot < 1e-2
    assert np.linalg.norm(n(got)[:3] - traj(3)[0, :3]) < 5e-3


_BOX_OBJ = "\n".join(
    [f"v {x} {y} {z}" for x, y, z in
     [(-0.04, -0.03, -0.025), (0.04, -0.03, -0.025), (0.04, 0.03, -0.025),
      (-0.04, 0.03, -0.025), (-0.04, -0.03, 0.025), (0.04, -0.03, 0.025),
      (0.04, 0.03, 0.025), (-0.04, 0.03, 0.025)]]
    + ["f 1 4 3 2", "f 5 6 7 8", "f 1 2 6 5", "f 3 4 8 7",
       "f 2 3 7 6", "f 1 5 8 4"])


@pytest.fixture
def gaussian_config(tmp_path):
    obj = tmp_path / "box.obj"
    obj.write_text(_BOX_OBJ)
    conf = {
        "tracker": "gaussian",
        "object": {"meshes": [str(obj)]},
        "camera": {"camera_matrix": [48.0, 0, 16, 0, 48.0, 16, 0, 0, 1],
                   "resolution": [32, 32], "downsampling_factor": 1},
        "transition": {"linear_acceleration_sigma": 0.4,
                       "angular_acceleration_sigma": 2.0, "damping": 4.0},
        "update_iterations": 2,
    }
    path = tmp_path / "gaussian.json"
    path.write_text(json.dumps(conf))
    return str(path)


def test_cli_simulate_runs_a_gaussian_config(gaussian_config, capsys):
    assert cli.main(["simulate", "--config", gaussian_config, "--device",
                     "cpu", "--frames", "10", "--distance", "0.6",
                     "--noise-sigma", "0.002", "--max-rmse", "0.03"]) == 0
    printed = capsys.readouterr()
    summary = json.loads(printed.out.strip().splitlines()[-1].split(
        ": ", 1)[1])
    assert set(summary) == {"frames", "mean_latency_ms", "position_rmse_m",
                            "rotation_rmse_rad"}
    assert "GaussianTracker (robust multi-sensor GF)" in printed.err


def test_cli_record_track_recovers_with_a_gaussian_config(gaussian_config,
                                                          tmp_path, capsys):
    seq, out, met, ckpt = (str(tmp_path / name) for name in (
        "seq.npz", "states.jsonl", "metrics.jsonl", "belief.npz"))
    assert cli.main(["record", "--config", gaussian_config, "--device",
                     "cpu", "--output", seq, "--frames", "26", "--distance",
                     "0.6", "--noise-sigma", "0.002", "--trajectory",
                     "teleport"]) == 0
    capsys.readouterr()
    assert cli.main(["track", "--config", gaussian_config, "--device", "cpu",
                     "--input", seq, "--auto-init", "--init-budget",
                     "6,2,96,2", "--watchdog", "--checkpoint", ckpt,
                     "--checkpoint-every", "10", "--output", out,
                     "--metrics", met]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1].split(": ", 1)[1])
    # the keys the particle run prints
    assert set(summary) == {"frames", "mean_latency_ms", "position_rmse_m",
                            "rotation_rmse_rad", "watchdog_reinits",
                            "watchdog_reinit_seconds"}
    assert summary["frames"] == 26
    assert [ln for ln in lines if ln.startswith("auto-init: ")]
    reinit = summary["watchdog_reinits"]
    assert len(reinit) >= 1 and 12 <= reinit[0] <= 17
    truth = np.load(seq)["poses"][:, 0, :3]
    with open(out) as fh:
        est = np.array([json.loads(line)["position"] for line in fh])
    assert est.shape == (26, 3)
    assert np.linalg.norm(est[-4:] - truth[-4:], axis=1).max() < 0.03
    with open(met) as fh:
        frames = [json.loads(line) for line in fh]
    assert all(m["mean_beta"] is not None and m["ess"] is None
               for m in frames)
    after = [m["trial_hypotheses"] for m in frames
             if m["frame"] > reinit[0]]
    assert after[0] is not None and after[0] >= 2     # a hypothesis trial
    # the saved belief resumes
    tracker = GaussianTracker(cfg.load_config(gaussian_config), device="cpu")
    belief = checkpoint.load_belief(ckpt)
    assert belief.mean.shape == (13,) and belief.occ_prior is not None
    tracker.restore(belief)
    pose, _ = tracker.track(np.load(seq)["depth"][-1])
    assert np.linalg.norm(n(pose)[:3] - truth[-1]) < 0.03


def test_node_run_initializes_from_the_first_frame():
    s, _, pt = shared_pair()

    def fn(i):
        return traj(i)

    run = node.run(pt, sources.SyntheticSource(
        s["pms"], s["pc"], fn, 5, noise_sigma=0.002, seed=3))
    assert run.poses.shape == (5, 1, 7)
    assert run.position_rmse() < 1.5e-2
    m = run.metrics.records[-1]
    assert m.mean_beta > 0.5 and m.innovation_rms is not None
    assert m.ess is None and m.trial_hypotheses is None
