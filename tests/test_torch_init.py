"""Port parity of what acquires and recovers a track: the image
likelihood and the exact ("xla") sensor, the memory budget, the island
trial with its chain-free pose score, the 6-DoF initializer and the
watchdog.

Both packages get the same numpy inputs from a seed; where the JAX
function draws random numbers, the same draws are replayed into the port
(``draws`` of ``find_initial_pose``, ``BlockNoise`` of the filter step).

Tolerances, and why:
  * ``image_loglik`` on identical depths: the same float32 formulas,
    summed over ~1e3 pixels in another order: rtol 1e-5 (+1e-3 nats),
    occlusion posterior 1e-6;
  * the "xla" sensor: each side renders its own depths (float32 matmuls
    in another order), rtol 2e-5 + 1e-2 nats, occlusion 1e-5;
  * budget arithmetic, orientation grid, clustering, watchdog: exact;
  * island trial: accumulated scores rtol 1e-4 (four frames of summed
    image logliks of means that differ by float rounding), same winner,
    final pose 1e-4;
  * ``find_initial_pose`` with the JAX draws fed in: no argmax tie
    flipped on this scene, so the poses agree to 1e-3 m / 1e-2 rad and
    the scores to rtol 1e-4 (every beam, not only the winner).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu import config as jcfg
from dbot_ros_tpu.models import beam as jbeam
from dbot_ros_tpu.models import image_loglik as jil
from dbot_ros_tpu.models import occlusion as jocc
from dbot_ros_tpu.models import sensor as jsensor
from dbot_ros_tpu.ops import budget as jbudget
from dbot_ros_tpu.ops import raycast as jraycast
from dbot_ros_tpu.runtime import initializer as jinit
from dbot_ros_tpu.runtime import watchdog as jwatchdog
from dbot_ros_tpu.trackers.particle import ParticleTracker as JaxTracker
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu.utils import se3 as jse3
from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.filters import rbcpf
from dbot_ros_tpu_torch.models import image_loglik as il
from dbot_ros_tpu_torch.models import sensor
from dbot_ros_tpu_torch.ops import budget
from dbot_ros_tpu_torch.runtime import initializer, node, sources, watchdog
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import camera

torch.set_num_threads(1)

K32 = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def n(x):
    return np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def cams():
    return jcamera.make_camera(K32, 32, 32), camera.make_camera(K32, 32, 32)


def port_mesh(jm):
    return interop.mesh_from_numpy(fields(jm))


def params():
    jbp = jbeam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    jop = jocc.make_occlusion_params()
    return (jbp, jop, interop.beam_params_from_numpy(fields(jbp)),
            interop.occlusion_params_from_numpy(fields(jop)))


def rendered(jm, jcam, pose, g=None, sigma=0.0, background=np.nan):
    """A frame of ``jm`` at ``pose`` (JAX raycaster), flat float32."""
    d = np.asarray(jraycast.raycast_depth(jm, jnp.asarray(pose, jnp.float32),
                                          jcam.rays, 128))
    z = np.where(np.isfinite(d), d, background).astype(np.float32)
    if sigma:
        z = z + sigma * g.standard_normal(z.shape).astype(np.float32)
    return z


# ---------------------------------------------------------------------------
# image likelihood, the exact sensor, the budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt_frames", [1.0, 2.5])
def test_image_loglik_matches_jax(dt_frames):
    jbp, jop, bp, op = params()
    g = np.random.default_rng(0)
    P, N = 24, 600
    d = g.uniform(0.45, 1.2, (P, N)).astype(np.float32)
    d[g.uniform(size=(P, N)) < 0.5] = np.inf
    z = (0.8 + 0.3 * g.standard_normal(N)).astype(np.float32)
    z[::13] = np.nan
    z[5::31] = 0.2
    z[7::37] = 6.0
    occ = g.uniform(size=(P, N)).astype(np.float32)
    want_ll, want_occ = jil.image_loglik(jnp.asarray(d), jnp.asarray(z),
                                         jnp.asarray(occ), jbp, jop,
                                         dt_frames)
    ll, occ_post = il.image_loglik(t(d), t(z), t(occ), bp, op, dt_frames)
    np.testing.assert_allclose(n(ll), np.asarray(want_ll), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(n(occ_post), np.asarray(want_occ), atol=1e-6)
    jp, jq = jil.pixel_likelihoods(jnp.asarray(d), jnp.asarray(z),
                                   jnp.asarray(occ), jbp)
    pp, pq = il.pixel_likelihoods(t(d), t(z), t(occ), bp)
    np.testing.assert_allclose(n(pp), np.asarray(jp), rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(n(pq), np.asarray(jq), atol=1e-6)


@pytest.mark.parametrize("num_objects", [1, 2])
def test_xla_sensor_matches_jax(num_objects):
    jcam, pcam = cams()
    jmeshes = [jmesh.l_shape_mesh(),
               jmesh.box_mesh(0.05, 0.08, 0.04)][:num_objects]
    jbp, jop, bp, op = params()
    js = jsensor.make_rb_sensor(jmeshes, jcam, jbp, jop, backend="xla",
                                tri_chunk=64)
    ps = sensor.make_rb_sensor([port_mesh(m) for m in jmeshes], pcam, bp,
                               op, backend="xla", tri_chunk=64)
    refs = np.array([[-0.02, 0.0, 0.62, 1, 0, 0, 0],
                     [0.03, 0.01, 0.55, 1, 0, 0, 0]],
                    np.float32)[:num_objects]
    g = np.random.default_rng(1)
    P, N = 48, 1024
    states = np.zeros((P, num_objects, 13), np.float32)
    states[..., :7] = refs
    states[..., :3] += 0.006 * g.standard_normal((P, num_objects, 3))
    z = np.asarray(jsensor.render_scene(jmeshes, jnp.asarray(refs),
                                        jcam.rays))
    z = np.where(np.isfinite(z), z, 2.0).astype(np.float32)
    z += 0.002 * g.standard_normal(N).astype(np.float32)
    z[::41] = np.nan
    occ = g.uniform(0, 0.5, (P, N)).astype(np.float32)
    want_ll, want_occ = js(jnp.asarray(states), jnp.asarray(occ),
                           jnp.asarray(z), jnp.float32(1 / 30))
    ll, occ_post = ps(t(states), t(occ), t(z), float(np.float32(1 / 30)))
    np.testing.assert_allclose(n(ll), np.asarray(want_ll), rtol=2e-5,
                               atol=1e-2)
    np.testing.assert_allclose(n(occ_post), np.asarray(want_occ), atol=1e-5)
    np.testing.assert_allclose(
        n(sensor.render_scene([port_mesh(m) for m in jmeshes],
                              t(states[..., :7]), pcam.rays, 32)),
        np.asarray(jsensor.render_scene(jmeshes, jnp.asarray(
            states[..., :7]), jcam.rays, 32)), rtol=1e-5)
    # commit=False leaves the caller's map in place
    _, kept = ps(t(states), t(occ), t(z), 1 / 30, commit=False)
    np.testing.assert_array_equal(n(kept), occ)


def test_sensor_factory_names_what_is_not_ported():
    """Every backend of the reference is ported: "deferred" builds and
    scores like the exact sensor on poses its candidates cover; only an
    unknown name is refused."""
    _, pcam = cams()
    _, _, bp, op = params()
    m = port_mesh(jmesh.box_mesh())
    deferred = sensor.make_rb_sensor(m, pcam, bp, op, backend="deferred")
    exact = sensor.make_rb_sensor(m, pcam, bp, op, backend="xla")
    g = np.random.default_rng(2)
    states = np.zeros((12, 1, 13), np.float32)
    states[:, 0, :7] = [0.0, 0.0, 0.6, 1, 0, 0, 0]
    states[:, 0, :3] += 0.003 * g.standard_normal((12, 3))
    z = t(rendered(jmesh.box_mesh(), cams()[0], states[0, 0, :7],
                   background=2.0))
    occ = torch.full((12, 1024), 0.1)
    ll_d, occ_d = deferred(t(states), occ, z, 1 / 30)
    ll_x, occ_x = exact(t(states), occ, z, 1 / 30)
    assert ll_d.shape == (12,) and occ_d.shape == (12, 1024)
    # the candidate sets carry a quarter-pixel slack the exact test lacks:
    # an edge pixel flips for a few particles, the others agree
    assert np.isclose(n(ll_d), n(ll_x), rtol=1e-4).mean() >= 0.75
    np.testing.assert_allclose(n(ll_d), n(ll_x), rtol=0.1)
    with pytest.raises(ValueError):
        sensor.make_rb_sensor(m, pcam, bp, op, backend="opengl")


@pytest.mark.parametrize("particles", [1, 200, 2056, 8192, 100000])
@pytest.mark.parametrize("requested", [512, 64, 0, -1])
def test_xla_tri_chunk_is_the_reference_arithmetic(particles, requested):
    for pixels in (300, 1200, 4800):
        assert budget.xla_tri_chunk(particles, pixels, requested) == \
            jbudget.xla_tri_chunk(particles, pixels, requested)
    assert budget.xla_tri_chunk(particles, 4800, requested, 1 << 28, 32) \
        == jbudget.xla_tri_chunk(particles, 4800, requested, 1 << 28, 32)


@pytest.mark.parametrize("backend", ["pallas", "deferred", "xla"])
def test_memory_estimate_is_the_reference_arithmetic(backend):
    for p, npx, tri, k in ((200, 1200, 128, 1), (10000, 4800, 1408, 1),
                           (4096, 4800, 256, 3)):
        assert dataclasses.asdict(
            budget.estimate_memory(p, npx, tri, k, backend)) == \
            dataclasses.asdict(
                jbudget.estimate_memory(p, npx, tri, k, backend))
    assert budget.estimate_memory(10000, 4800, 1408).human() == \
        jbudget.estimate_memory(10000, 4800, 1408).human()
    assert budget.rgf_pixel_stride(4800, 1408, 2) == \
        jbudget.rgf_pixel_stride(4800, 1408, 2)
    # same capacity in, same particle count out (the JAX side reads its
    # capacity from a device's memory_stats)
    cap = 8 * 1024 ** 3
    fake = types.SimpleNamespace(memory_stats=lambda: {"bytes_limit": cap})
    assert budget.max_particles(4800, 1408, backend=backend,
                                capacity_bytes=cap) == \
        jbudget.max_particles(4800, 1408, backend=backend, device=fake)


def test_budget_asks_the_card_and_never_guesses():
    with pytest.warns(RuntimeWarning, match="device memory"):
        budget.check_fit(100000, 4800, 1408, capacity_bytes=1 << 30)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            budget.device_memory_bytes()
        with pytest.raises(RuntimeError, match="CUDA"):
            budget.max_particles(4800, 1408)


# ---------------------------------------------------------------------------
# the island trial
# ---------------------------------------------------------------------------

def trackers(particles=128, seed=7, backend="xla"):
    jcam, pcam = cams()
    jm = jmesh.l_shape_mesh()
    kw = dict(evaluation_count=particles, max_kl_divergence=0.5,
              backend=backend, seed=seed)
    jconf = jcfg.ParticleTrackerConfig(
        observation=jcfg.ObservationConfig(model_sigma=0.005,
                                           sigma_factor=0.0),
        transition=jcfg.TransitionConfig(0.3, 1.5, damping=4.0), **kw)
    pconf = cfg.ParticleTrackerConfig(
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.3, 1.5, damping=4.0), **kw)
    return (JaxTracker(jconf, meshes=[jm], camera=jcam),
            ParticleTracker(pconf, meshes=[port_mesh(jm)], camera=pcam,
                            device="cpu"), jm, jcam)


def replayed_noise(key, num_objects, P):
    """The draws the JAX ``rbcpf_step`` makes from a belief's ``key``."""
    _, k_res_base, *block_keys = jax.random.split(key, 2 + num_objects)
    out = []
    for b in range(num_objects):
        k1, k2 = jax.random.split(block_keys[b])
        out.append(rbcpf.BlockNoise(
            e1=t(jax.random.normal(k1, (P, 6), jnp.float32)),
            e2=t(jax.random.normal(k2, (P, 6), jnp.float32)),
            u=t(jax.random.uniform(jax.random.fold_in(k_res_base, b), ()))))
    return out


def twin_of(pose):
    flip = np.asarray(jse3.quat_multiply(
        jse3.so3_exp_quat(jnp.array([0.0, np.pi, 0.0])),
        jnp.asarray(pose[3:7], jnp.float32)))
    return np.concatenate([pose[:3], flip]).astype(np.float32)


def test_pose_score_matches_jax():
    jtr, ptr, jm, jcam = trackers()
    g = np.random.default_rng(2)
    true_pose = np.array([0.01, -0.01, 0.6, 1, 0, 0, 0], np.float32)
    z = rendered(jm, jcam, true_pose, g, 0.002, background=2.0)
    z[::29] = np.nan
    for pose in (true_pose, twin_of(true_pose)):
        mean_state = np.zeros((1, 13), np.float32)
        mean_state[0, :7] = pose
        mean_state[0, 7:] = 0.1
        want = float(jtr._pose_score(jnp.asarray(mean_state),
                                     jnp.asarray(z)))
        got = float(ptr._pose_score(t(mean_state), t(z)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_island_trial_with_replayed_draws_picks_the_jax_winner():
    """The wrong twin is slot 0 (the published choice); both packages race
    two islands for four frames on the same frames and draws, and the
    challenger wins by the margin in both."""
    jtr, ptr, jm, jcam = trackers()
    P = 128
    true_pose = np.array([0.0, 0.0, 0.6, 1, 0, 0, 0], np.float32)
    hyp = np.stack([twin_of(true_pose), true_pose])
    for tr in (jtr, ptr):
        tr.initialize(true_pose, hypotheses=hyp,
                      hypothesis_logits=np.zeros(2, np.float32),
                      trial_frames=4)
        assert tr.trial_active == 2
    jtrial, ptrial = jtr._trial, ptr._trial

    noise = {}

    def replaying_step(belief, z, dt, generator):
        slot = [i for i, gen in enumerate(ptrial["generators"])
                if gen is generator][0]
        return rbcpf.rbcpf_step(
            belief, z, ptr.sensor, ptr.trans_params, dt,
            max_kl_divergence=ptr.config.max_kl_divergence,
            noise=noise[slot])

    ptr._step = replaying_step
    g = np.random.default_rng(3)
    for f in range(4):
        z = rendered(jm, jcam, true_pose, g, 0.002, background=2.0)
        for i, b in enumerate(jtrial["beliefs"]):
            noise[i] = replayed_noise(b.key, 1, P)
        jposes, _ = jtr.track(z)
        pposes, _ = ptr.track(z)
        np.testing.assert_allclose(n(pposes), np.asarray(jposes), atol=1e-4)
        np.testing.assert_allclose(ptrial["scores"], jtrial["scores"],
                                   rtol=1e-4)
    assert jtr.trial_active is None and ptr.trial_active is None
    # the challenger (slot 1, the true pose) won in both
    assert np.argmax(jtrial["scores"]) == 1 == np.argmax(ptrial["scores"])
    assert ptr.belief is ptrial["beliefs"][1]
    assert ptr.generator is ptrial["generators"][1]
    rot_err = float(torch.linalg.norm(
        ptr.belief.states[:, 0, 3:7].mean(0) - t(true_pose[3:7])))
    assert rot_err < 0.2, rot_err


def test_island_trial_bookkeeping():
    """Islands keep to the best four by logit, own their maps and
    generators, slot 0 is published until the trial ends, a challenger
    below the margin does not take over, and ``restore`` ends a trial."""
    _, ptr, jm, jcam = trackers(particles=32, backend="pallas")
    base_pose = np.array([0.0, 0.0, 0.6, 1, 0, 0, 0], np.float32)
    hyp = np.stack([base_pose + np.array([0.002 * k, 0, 0, 0, 0, 0, 0],
                                         np.float32) for k in range(6)])
    logits = np.array([0.0, 5.0, 1.0, 4.0, 3.0, 2.0], np.float32)
    ptr.initialize(base_pose, hypotheses=hyp, hypothesis_logits=logits,
                   trial_frames=2, trial_switch_margin=1e9)
    assert ptr.trial_active == 4
    beliefs = ptr._trial["beliefs"]
    # hypotheses 1, 3, 4, 5 in that order, in the centred frame
    want = initializer.base.to_center_frame(t(hyp[[1, 3, 4, 5]]),
                                            ptr.centers[0])
    np.testing.assert_allclose(
        n(torch.stack([b.states[0, 0, :7] for b in beliefs])), n(want),
        atol=1e-6)
    maps = {b.occlusion[0].data_ptr() for b in beliefs}
    assert len(maps) == 4
    assert len({id(gen) for gen in ptr._trial["generators"]}) == 4
    seeds = {gen.initial_seed() for gen in ptr._trial["generators"]}
    assert len(seeds) == 4 and ptr.config.seed not in seeds
    z = rendered(jm, jcam, base_pose, background=2.0)
    ptr.track(z)
    assert ptr.trial_active == 4 and ptr.belief is ptr._trial["beliefs"][0]
    trial = ptr._trial
    ptr.track(z)
    # an unreachable margin: slot 0 stays whatever the scores say
    assert ptr.trial_active is None and ptr.belief is trial["beliefs"][0]
    # one hypothesis is no trial; restore clears a running one
    ptr.initialize(base_pose, hypotheses=hyp[:1])
    assert ptr.trial_active is None
    ptr.initialize(base_pose, hypotheses=hyp[:2])
    assert ptr.trial_active == 2
    ptr.restore(ptr.belief)
    assert ptr.trial_active is None


# ---------------------------------------------------------------------------
# the initializer
# ---------------------------------------------------------------------------

def test_nanmedian_follows_numpy_and_jax():
    g = np.random.default_rng(4)
    x = g.standard_normal((7, 12)).astype(np.float32)
    x[0, :] = np.nan                       # empty row → NaN
    x[1, 3:] = np.nan                      # odd count (3)
    x[2, 4:] = np.nan                      # even count (4): the mean of two
    x[3, ::2] = np.nan
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=-1))
    got = n(initializer.nanmedian(t(x), -1))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-7)
    np.testing.assert_allclose(got[2], 0.5 * np.sort(x[2, :4])[1:3].sum(),
                               rtol=1e-7)
    np.testing.assert_allclose(
        n(initializer.nanmedian(t(x[1:]), 0)),
        np.asarray(jnp.nanmedian(jnp.asarray(x[1:]), axis=0)), rtol=1e-7)


@pytest.mark.parametrize("n_axes,n_spins", [(12, 4), (6, 2), (12, 8)])
def test_orientation_candidates_match_jax(n_axes, n_spins):
    np.testing.assert_allclose(
        n(initializer.orientation_candidates(n_axes, n_spins)),
        np.asarray(jinit.orientation_candidates(n_axes, n_spins)),
        atol=1e-7)


def test_segment_centroid_matches_jax():
    jcam, pcam = cams()
    jm = jmesh.l_shape_mesh()
    z = rendered(jm, jcam, [0.02, -0.01, 0.6, 1, 0, 0, 0])
    z[100:104] = 2.0                       # background leaking in
    mask = np.zeros(1024, bool)
    mask[:700] = True
    for fg in (None, mask):
        jc, jn = jinit.segment_centroid(
            jnp.asarray(z), jcam, 0.3, 1.5,
            fg_mask=None if fg is None else jnp.asarray(fg))
        pc, pn = initializer.segment_centroid(z, pcam, 0.3, 1.5, fg_mask=fg)
        assert int(pn) == int(jn) > 20
        np.testing.assert_allclose(n(pc), np.asarray(jc), atol=1e-6)


def jax_refine_draws(steps, particles, beams=8, seed=0):
    """The normals ``jinit.find_initial_pose`` draws from PRNGKey(seed)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        out.append((np.asarray(jax.random.normal(k1, (beams, particles, 3))),
                    np.asarray(jax.random.normal(k2, (beams, particles, 3)))))
    return out


def test_find_initial_pose_with_jax_draws_matches_jax():
    jcam, pcam = cams()
    jm = jmesh.l_shape_mesh()
    true_pose = np.concatenate([
        [0.03, -0.02, 0.62],
        np.asarray(jse3.so3_exp_quat(jnp.array([0.0, 0.0, 0.4])))]
    ).astype(np.float32)
    z = rendered(jm, jcam, true_pose)
    kw = dict(n_axes=12, n_spins=2, refine_particles=32, refine_steps=2,
              polish_rounds=1)
    jpose, jscore, jn_fg, jbeams, jll = jinit.find_initial_pose(
        jnp.asarray(z), jm, jcam, return_beams=True, **kw)
    pose, score, n_fg, beams, ll = initializer.find_initial_pose(
        z, port_mesh(jm), pcam, draws=jax_refine_draws(2, 32),
        return_beams=True, **kw)
    assert n_fg == jn_fg > 20
    np.testing.assert_allclose(n(ll), np.asarray(jll), rtol=1e-4)
    np.testing.assert_allclose(n(beams)[:, :3], np.asarray(jbeams)[:, :3],
                               atol=1e-3)
    rot = n(torch.linalg.norm(initializer.se3.quat_boxminus(
        beams[:, 3:7], t(np.asarray(jbeams)[:, 3:7])), dim=-1))
    assert rot.max() < 1e-2, rot
    np.testing.assert_allclose(n(pose), np.asarray(jpose), atol=1e-3)
    np.testing.assert_allclose(float(score), float(jscore), rtol=1e-4)
    assert float(np.linalg.norm(n(pose)[:3] - true_pose[:3])) < 0.05
    # without draws the generator decides, reproducibly
    lean = dict(n_axes=6, n_spins=2, refine_particles=16, refine_steps=1,
                polish_rounds=0)
    a, b = (initializer.find_initial_pose(
        z, port_mesh(jm), pcam, generator=torch.Generator().manual_seed(5),
        **lean) for _ in range(2))
    assert torch.equal(a[0], b[0]) and a[2] == n_fg


def test_cluster_masks_match_jax():
    jcam, pcam = cams()
    d = None
    for x in (-0.12, 0.0, 0.12):
        di = rendered(jmesh.box_mesh(0.05, 0.05, 0.04), jcam,
                      [x, 0.0, 0.6, 1, 0, 0, 0], background=np.inf)
        d = di if d is None else np.minimum(d, di)
    z = np.where(np.isfinite(d), d, np.nan).astype(np.float32)
    want = jinit._cluster_masks(jnp.asarray(z), jcam, 3, 0.3, 1.5)
    got = initializer._cluster_masks(t(z), pcam, 3, 0.3, 1.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sum(int(m.sum()) for m in got) == int(np.isfinite(z).sum())


def test_find_initial_poses_places_two_objects():
    """Port only (the JAX two-object search draws from split keys): the
    greedy (mesh, cluster) assignment with explaining-away places both
    objects on the right mesh, within 5 cm (the reference test's bound)."""
    jcam, pcam = cams()
    m_l, m_box = jmesh.l_shape_mesh(), jmesh.box_mesh(0.05, 0.07, 0.03)
    pose_l = np.array([-0.07, 0.0, 0.62, 1, 0, 0, 0], np.float32)
    pose_box = np.array([0.08, 0.02, 0.55, 1, 0, 0, 0], np.float32)
    d = np.minimum(rendered(m_l, jcam, pose_l, background=np.inf),
                   rendered(m_box, jcam, pose_box, background=np.inf))
    z = np.where(np.isfinite(d), d, np.nan).astype(np.float32)
    poses, scores = initializer.find_initial_poses(
        z, [port_mesh(m_l), port_mesh(m_box)], pcam, n_axes=6, n_spins=2,
        refine_particles=32, refine_steps=2, polish_rounds=0,
        generator=torch.Generator().manual_seed(0))
    assert poses.shape == (2, 7) and scores.shape == (2,)
    assert float(torch.linalg.norm(poses[0, :3] - t(pose_l[:3]))) < 0.05
    assert float(torch.linalg.norm(poses[1, :3] - t(pose_box[:3]))) < 0.05


def test_initialize_tracker_keeps_hypotheses_and_tracks():
    """Port only: the search initializes the tracker; ``min_hypotheses=2``
    starts an island trial; after it the pose explains the frame about as
    well as the truth (the reference test's render-quality criterion)."""
    _, ptr, jm, jcam = trackers(particles=96, backend="pallas")
    true_pose = np.concatenate([
        [0.01, 0.02, 0.58],
        np.asarray(jse3.so3_exp_quat(jnp.array([0.0, 0.0, 0.3])))]
    ).astype(np.float32)
    z = rendered(jm, jcam, true_pose)
    pose0, score = initializer.initialize_tracker(
        ptr, z, min_hypotheses=2, n_axes=12, n_spins=4,
        refine_particles=64, refine_steps=2, polish_rounds=1,
        generator=torch.Generator().manual_seed(1))
    assert pose0.shape == (7,) and np.isfinite(float(score))
    assert ptr.trial_active is not None and ptr.trial_active >= 2
    for _ in range(9):
        poses, info = ptr.track(z)
    assert ptr.trial_active is None
    mean_state = torch.zeros((1, 13))
    mean_state[0, :7] = initializer.base.to_center_frame(poses[0],
                                                         ptr.centers[0])
    truth_state = torch.zeros((1, 13))
    truth_state[0, :7] = initializer.base.to_center_frame(
        t(true_pose), ptr.centers[0])
    zt = camera.preprocess_depth(t(z))
    assert float(ptr._pose_score(mean_state, zt)) > \
        float(ptr._pose_score(truth_state, zt)) - 60.0


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

def info_stream(kind, g, length=80):
    """A StepInfo-like sequence with a loss in the middle."""
    out = []
    for i in range(length):
        lost = 30 <= i < 45
        if kind == "particle":
            out.append(types.SimpleNamespace(
                ess=float(g.uniform(1, 4) if lost else g.uniform(40, 120)),
                mean_loglik=float(-1500 - (400 if lost else 0)
                                  + 3 * g.standard_normal())))
        else:
            beta = (g.uniform(0.02, 0.2) if lost else
                    g.uniform(0.45, 0.58) if 55 <= i else
                    g.uniform(0.8, 0.95))
            out.append(types.SimpleNamespace(mean_beta=float(beta)))
    return out


@pytest.mark.parametrize("kind", ["particle", "gaussian"])
@pytest.mark.parametrize("seed", [0, 1])
def test_watchdog_state_machine_matches_reference(kind, seed):
    infos = info_stream(kind, np.random.default_rng(seed))
    jdog = jwatchdog.TrackingWatchdog()
    pdog = watchdog.TrackingWatchdog()
    assert dataclasses.asdict(pdog.config) == dataclasses.asdict(jdog.config)
    trips = []
    for i, info in enumerate(infos):
        a, b = pdog.update(info, 200), jdog.update(info, 200)
        assert a == b, i
        assert vars(pdog) | {"config": None} == vars(jdog) | {"config": None}
        if a:
            trips.append(i)
    assert trips and pdog.trip_count == jdog.trip_count == len(trips)
    # 0-d tensors feed it as floats do
    tdog = watchdog.TrackingWatchdog()
    for info in infos:
        tdog.update(types.SimpleNamespace(**{
            k: torch.tensor(v) for k, v in vars(info).items()}), 200)
    assert tdog.trip_count == pdog.trip_count


def test_watchdog_rejects_a_detector_that_can_never_fire():
    with pytest.raises(ValueError, match="beta_cat_count"):
        watchdog.TrackingWatchdog(watchdog.WatchdogConfig(
            beta_cat_count=6, beta_cat_window=5))


def test_reinitialize_particle_tracker_spreads_around_the_pose():
    _, ptr, jm, jcam = trackers(particles=400, backend="pallas")
    pose = np.array([0.02, 0.0, 0.6, 1, 0, 0, 0], np.float32)
    ptr.initialize(pose, hypotheses=np.stack([pose, pose]))
    gen = torch.Generator().manual_seed(9)
    watchdog.reinitialize_particle_tracker(ptr, pose, 0.05, 0.3,
                                           generator=gen)
    assert ptr.trial_active is None and ptr.generator is gen
    s = ptr.belief.states
    assert s.shape == (400, 1, 13) and bool((s[..., 7:] == 0).all())
    centre = initializer.base.to_center_frame(t(pose)[None], ptr.centers)
    np.testing.assert_allclose(n(s[:, 0, :3].mean(0)), n(centre[0, :3]),
                               atol=0.01)
    np.testing.assert_allclose(n(s[:, 0, :3].std(0)), 0.05, atol=0.01)
    np.testing.assert_allclose(n(torch.linalg.norm(s[:, 0, 3:7], dim=-1)),
                               1.0, atol=1e-5)
    assert bool((ptr.belief.log_weights == 0).all())
    poses, _ = ptr.track(rendered(jm, jcam, pose, background=2.0))
    assert bool(torch.isfinite(poses).all())


def test_run_with_watchdog_reacquires_after_a_teleport():
    """Port only: the object jumps 12 cm at frame 8; the watchdog trips,
    the search re-acquires on that frame, and the frames after it race at
    least two island hypotheses."""
    _, ptr, jm, jcam = trackers(particles=96, backend="pallas")
    pm = ptr.meshes[0]

    def traj(i):
        return np.array([[0.001 * i if i < 8 else -0.12, 0.0, 0.6,
                          1, 0, 0, 0]], np.float32)

    src = sources.SyntheticSource([pm], ptr.camera, traj, 24,
                                  noise_sigma=0.002, seed=2)
    run = node.run(ptr, src, watchdog=watchdog.TrackingWatchdog(),
                   reinit_kwargs=dict(
                       n_axes=6, n_spins=2, refine_particles=32,
                       refine_steps=2, polish_rounds=1,
                       generator=torch.Generator().manual_seed(0)))
    assert run.reinit_frames and 8 <= run.reinit_frames[0] <= 16
    assert len(run.reinit_seconds) == len(run.reinit_frames)
    after = [r.trial_hypotheses for r in run.metrics.records
             if r.frame > run.reinit_frames[0] and r.trial_hypotheses]
    assert after and min(after) >= 2
    assert run.position_errors()[-5:].max() < 0.03
