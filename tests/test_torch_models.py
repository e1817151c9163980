"""Port parity: transition, beam and occlusion models, resampling and the
slack rule of dbot_ros_tpu_torch against dbot_ros_tpu.

The port takes its random numbers as arguments; these tests draw them
with jax.random exactly as the JAX function does and pass them in.
Tolerances: float32 formulas evaluated in the same order, so ~1e-6
absolute (relative for densities, which reach ~1e2); resampling indices
must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu.models import beam as jbeam
from dbot_ros_tpu.models import occlusion as jocc
from dbot_ros_tpu.models import transition as jtrans
from dbot_ros_tpu.ops import raycast_pallas as jrp
from dbot_ros_tpu.ops import resample as jrs
from dbot_ros_tpu.ops import slack as jslack
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.models import beam, occlusion, sensor, transition
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import resample as rs
from dbot_ros_tpu_torch.ops import slack
from dbot_ros_tpu_torch.utils import camera, mesh

torch.set_num_threads(1)


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def random_states(g, count):
    s = np.zeros((count, 13), np.float32)
    s[:, :3] = [0.0, 0.0, 0.6] + 0.01 * g.standard_normal((count, 3))
    q = g.standard_normal((count, 4))
    s[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    s[:, 7:] = 0.2 * g.standard_normal((count, 6))
    return s


@pytest.mark.parametrize("dt", [1.0 / 30.0, 0.1])
def test_sample_transition_with_injected_noise_matches_jax(dt):
    g = np.random.default_rng(0)
    states = random_states(g, 64)
    jp = jtrans.make_transition_params(0.3, 1.5, damping=6.0)
    tp = interop.transition_params_from_numpy(fields(jp))
    key = jax.random.PRNGKey(11)
    want = jtrans.sample_transition(key, jnp.asarray(states),
                                    jnp.float32(dt), jp)
    # the JAX function's own draws (transition.py: split, two normals)
    k1, k2 = jax.random.split(key)
    e1 = jax.random.normal(k1, (64, 6), jnp.float32)
    e2 = jax.random.normal(k2, (64, 6), jnp.float32)
    got = transition.sample_transition(t(states), dt, tp, e1=t(e1),
                                       e2=t(e2))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(
        n(transition.transition_mean(t(states), dt, tp)),
        np.asarray(jtrans.transition_mean(jnp.asarray(states),
                                          jnp.float32(dt), jp)), atol=2e-6)
    # without injected noise the generator draws, reproducibly
    gen = torch.Generator().manual_seed(3)
    a = transition.sample_transition(t(states), dt, tp, generator=gen)
    gen.manual_seed(3)
    b = transition.sample_transition(t(states), dt, tp, generator=gen)
    assert torch.equal(a, b) and not torch.allclose(a, got)


@pytest.mark.parametrize("p_ov,p_oo", [(0.1, 0.7), (0.4, 0.1)])
def test_occlusion_propagate_matches_jax(p_ov, p_oo):
    """Covers g >= 0 (the lazy-aging regime) and g < 0."""
    jp = jocc.make_occlusion_params(p_ov, p_oo, 0.2)
    op = occlusion.make_occlusion_params(p_ov, p_oo, 0.2)
    p = np.random.default_rng(1).uniform(0, 1, (16, 50)).astype(np.float32)
    for dtf in (1.0, 2.5, 0.5):
        np.testing.assert_allclose(
            n(occlusion.propagate(t(p), op, dtf)),
            np.asarray(jocc.propagate(jnp.asarray(p), jp, dtf)), atol=1e-6)
    np.testing.assert_allclose(n(occlusion.stationary(op)),
                               np.asarray(jocc.stationary(jp)), atol=1e-7)


def test_beam_densities_match_jax():
    kw = dict(model_sigma=0.004, sigma_factor=0.001, min_depth=0.4,
              max_depth=5.0)
    jp, bp = jbeam.make_beam_params(**kw), beam.make_beam_params(**kw)
    g = np.random.default_rng(2)
    d = g.uniform(0.3, 1.5, 400).astype(np.float32)
    z = (d + 0.01 * g.standard_normal(400)).astype(np.float32)
    z[::17] = np.nan
    z[5::23] = 0.2                   # below the range
    z[7::29] = 6.0                   # above the range
    for name in ("density_visible", "density_occluded"):
        np.testing.assert_allclose(
            n(getattr(beam, name)(t(z), t(d), bp)),
            np.asarray(getattr(jbeam, name)(jnp.asarray(z), jnp.asarray(d),
                                            jp)), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(
        n(beam.density_background(t(z), bp)),
        np.asarray(jbeam.density_background(jnp.asarray(z), jp)),
        rtol=1e-6)


def test_params_vec_matches_jax():
    jb, jo = jbeam.make_beam_params(), jocc.make_occlusion_params()
    bp = interop.beam_params_from_numpy(fields(jb))
    op = interop.occlusion_params_from_numpy(fields(jo))
    # entry 15, the reference's one slack, stays 0 in the port (the
    # kernel reads a slack per triangle)
    for dtf in (1.0, 2.0):
        np.testing.assert_allclose(
            n(fs.make_params_vec(bp, op, dtf)),
            np.asarray(jrp.make_params_vec(jb, jo, jnp.float32(dtf), 0.0)),
            rtol=1e-6)


def test_weight_bookkeeping_matches_jax():
    g = np.random.default_rng(3)
    lw = (5.0 * g.standard_normal((3, 200))).astype(np.float32)
    lw[1, :50] = -np.inf              # zero-weight particles
    ln, lse = rs.normalize_log_weights(t(lw))
    lnj, lsej = jrs.normalize_log_weights(jnp.asarray(lw))
    np.testing.assert_allclose(n(ln), np.asarray(lnj), atol=2e-5)
    np.testing.assert_allclose(n(lse), np.asarray(lsej), rtol=1e-6)
    for name in ("effective_sample_size", "kl_to_uniform"):
        np.testing.assert_allclose(
            n(getattr(rs, name)(t(lw))),
            np.asarray(getattr(jrs, name)(jnp.asarray(lw))), rtol=2e-5)


@pytest.mark.parametrize("spread", [0.5, 4.0])
def test_systematic_indices_with_injected_u_match_jax(spread):
    """Parents equal, except where a threshold (i + u)/M lies within
    float32 rounding of a CDF step: XLA and torch accumulate the cumsum
    in different orders, so such a parent may move to its neighbour."""
    g = np.random.default_rng(4)
    lw = (spread * g.standard_normal(500)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jrs.systematic_indices(key, jnp.asarray(lw), 500))
        u = jax.random.uniform(key, ())      # resample.py: the one uniform
        got = n(rs.systematic_indices(t(lw), 500, u=t(u)))
        assert np.all(np.diff(got) >= 0)
        bad = np.flatnonzero(got != want)
        assert len(bad) <= 2, bad
        cdf = np.cumsum(np.exp(lw.astype(np.float64) - np.logaddexp.reduce(
            lw.astype(np.float64))))
        pos = (np.arange(500) + float(u)) / 500
        for i in bad:
            assert abs(int(got[i]) - int(want[i])) == 1
            edge = cdf[min(got[i], want[i])]
            assert abs(pos[i] - edge) < 1e-6, (pos[i], edge)


@pytest.mark.parametrize("shape", [(1,), (500,), (10_000,), (1, 500),
                                   (3, 50)])
def test_weight_cdf_is_the_sequential_cumsum(shape):
    """``weight_cdf`` scans a single row beside a copy of itself (on the
    card, a fixed order of additions); on the CPU that is ``torch.cumsum``
    bit for bit, whatever the shape, and the shape is kept."""
    w = torch.softmax(t(3.0 * np.random.default_rng(6).standard_normal(
        shape).astype(np.float32)), dim=-1)
    got = rs.weight_cdf(w)
    assert got.shape == w.shape
    assert torch.equal(got.view(torch.int32),
                       torch.cumsum(w, dim=-1).view(torch.int32))


def test_multinomial_indices_follow_weights():
    w = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    lw = np.full(4, -np.inf, np.float32)
    lw[w > 0] = np.log(w[w > 0])
    gen = torch.Generator().manual_seed(0)
    idx = rs.multinomial_indices(t(lw), 20000, generator=gen)
    freq = np.bincount(n(idx), minlength=4) / 20000.0
    np.testing.assert_allclose(freq, w, atol=0.015)


def test_slack_rule_matches_jax():
    """The automatic slack per object equals JAX's rule run on that
    object alone: its own mesh's median edge, its own mean depth (the
    port's rule; JAX's multi-mesh rule takes the finest mesh and the
    deepest object, ops/slack.py)."""
    jm = [jmesh.icosphere_mesh(0.06, 2), jmesh.l_shape_mesh()]
    pm = [mesh.icosphere_mesh(0.06, 2), mesh.l_shape_mesh()]
    assert slack.median_edge(pm) == jslack.median_edge(jm)
    for a, b in zip(pm, jm):
        assert slack.median_edge([a]) == jslack.median_edge([b])
    cam = camera.default_kinect_camera(8)
    jcam = jcamera.default_kinect_camera(8)
    assert slack.ray_pitch(cam.rays, 60, 80) == jslack.ray_pitch(
        jcam.rays, 60, 80)
    z = np.random.default_rng(5).uniform(0.5, 1.0, (40, 2)).astype(
        np.float32)
    zbar = slack.cloud_depth(t(z))
    assert zbar.shape == (2,)
    for k in range(2):
        want = jslack.cloud_depth(jnp.asarray(z[:, k]))
        np.testing.assert_allclose(n(zbar[k]), np.asarray(want), rtol=1e-6)
        np.testing.assert_allclose(n(slack.cloud_depth(t(z[:, k]))),
                                   np.asarray(want), rtol=1e-6)
        np.testing.assert_allclose(
            n(slack.auto_bary_slack(zbar[k], 1 / 65.625,
                                    slack.median_edge([pm[k]]))),
            np.asarray(jslack.auto_bary_slack(
                want, 1 / 65.625, jslack.median_edge([jm[k]]))), rtol=1e-6)


def test_sensor_factory_backends():
    cam = camera.default_kinect_camera(8)
    m = mesh.box_mesh()
    bp, op = beam.make_beam_params(), occlusion.make_occlusion_params()
    s = sensor.make_rb_sensor(m, cam, bp, op, backend="pallas", nb=32)
    assert isinstance(s, fs.FusedSensor) and s.nb == 32
    assert callable(sensor.make_rb_sensor(m, cam, bp, op, backend="xla"))
    deferred = sensor.make_rb_sensor(m, cam, bp, op, backend="deferred",
                                     particle_chunk=8)
    assert callable(deferred) and deferred.last_particle_chunk is None
    with pytest.raises(ValueError):
        sensor.make_rb_sensor(m, cam, bp, op, backend="opengl")
    # every lineage mode name and both merges of the reference build (the
    # modes select the port's one kernel); unknown names and Pallas's
    # interpreter raise
    for opts in (dict(lineage_gather="pallas"),
                 dict(lineage_gather="windowed"), dict(merge="select")):
        s = sensor.make_rb_sensor(m, cam, bp, op, backend="pallas", **opts)
        assert isinstance(s, fs.FusedSensor)
        assert all(getattr(s, k) == v for k, v in opts.items())
    for opts, match in ((dict(merge="bogus"), "merge"),
                        (dict(lineage_gather="bogus"), "lineage_gather"),
                        (dict(interpret=True), "interpreter")):
        with pytest.raises(ValueError, match=match):
            sensor.make_rb_sensor(m, cam, bp, op, backend="pallas", **opts)
