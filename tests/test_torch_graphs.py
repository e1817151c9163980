"""The trackers' compiled step (dbot_ros_tpu_torch/utils/graphs.py) on
the CPU, where it runs without capture through the same buffers.

* ``sample_transition`` with ``dt`` a 0-d float32 tensor against the JAX
  function under ``jax.jit`` with ``dt`` traced, on the same draws.
* The fused sensor's call split at its one host read (``plan_device``,
  ``choose_level``, ``apply``) against ``__call__``, bit for bit.
* Each tracker's step through its step program against the plain eager
  step (``rbcpf.rbcpf_step``, ``rgf.rgf_step``) on the same draws, bit
  for bit: a varying ``dt``, a ``restore`` and a re-initialization
  between frames, one and two objects, a two-island trial, the Gaussian
  step and its frozen trial variant.
* The graphs' functions read nothing back and copy nothing from the host
  (what a capture forbids), seen through a dispatch mode: the trackers'
  steps, the scale-out steps on a gloo group of one rank (the segments
  the card captures: distributed, island with and without its exchange,
  two scenes), both sources' renders and the batched Gaussian step
  through ``graphs.compiled``; each of these programmed against its plain
  version, bit for bit.
* The programmed oracle render against JAX's jitted render on JAX's
  draws (1e-5, equal NaN masks).
* Launch counts and a group's byte counts over replays, with a stand-in
  for the CUDA graph.
* Only the belief is donated: the StepInfo of ``track`` (in a trial
  too) and the scale-out steps' means and ESS outlive the next step.
* ``capture=True`` on the CPU raises, and over gloo.

The CUDA graphs themselves are held against the eager step on the card
(tests/test_torch_cuda.py, chip_smoke.py's graph phase).
"""

import contextlib
import dataclasses
import datetime
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from dbot_ros_tpu.models import transition as jtrans
from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch.filters import rbcpf, rgf
from dbot_ros_tpu_torch.models import transition
from dbot_ros_tpu_torch.ops import kernels
from dbot_ros_tpu_torch.parallel import comm as comm_mod
from dbot_ros_tpu_torch.parallel import dist_filter
from dbot_ros_tpu_torch.runtime import sources, watchdog
from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import camera, graphs, mesh
from dbot_ros_tpu_torch.utils.camera import preprocess_depth
from tests.test_torch_sources import jax_draws, oracle_scene

torch.set_num_threads(1)

K_CAM = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
POSES = np.array([[-0.02, 0.0, 0.62, 1, 0, 0, 0],
                  [0.03, 0.01, 0.55, 1, 0, 0, 0]], np.float32)
# a dropped frame, node.run's cap after a re-initialization (0.25 s), ...
DTS = (1 / 30, 1 / 15, 0.25, 1 / 30, 0.1)
FRAMES = len(DTS)


def scene(num_objects, frames=FRAMES):
    """32×32 camera, the tagged L (and a box), noisy frames of a slow
    slide: (camera, meshes, flat depth frames)."""
    cam = camera.make_camera(K_CAM, 32, 32)
    meshes = [mesh.tagged_l_mesh(), mesh.box_mesh(0.05, 0.08, 0.04)]
    meshes = meshes[:num_objects]

    def traj(i):
        p = POSES[:num_objects].copy()
        p[:, 0] += 0.003 * i
        return p

    src = sources.SyntheticSource(meshes, cam, traj, frames, seed=5)
    return cam, meshes, [src.render(torch.as_tensor(traj(i))).numpy()
                         for i in range(frames)]


def particle_tracker(cam, meshes, particles=256, **kw):
    conf = cfg.ParticleTrackerConfig(
        evaluation_count=particles, backend="pallas", seed=3,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.2, 1.0, damping=4.0))
    return ParticleTracker(conf, meshes=meshes, camera=cam, device="cpu",
                           **kw)


def gaussian_tracker(cam, meshes, **kw):
    conf = cfg.GaussianTrackerConfig(
        update_iterations=2,
        transition=cfg.TransitionConfig(0.1, 0.5, damping=4.0))
    return GaussianTracker(conf, meshes=meshes, camera=cam, device="cpu",
                           **kw)


def twin(gen):
    """A generator in the same state as ``gen``."""
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x)
                for v in leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in leaves(y)]
    return []


def assert_same(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# dt as a device tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [1 / 30, 0.07, 0.25])
def test_sample_transition_with_a_tensor_dt_matches_jax_traced(dt):
    """The JAX step traces ``dt`` in float32 (``jnp.sqrt`` of it); the
    port takes a 0-d float32 tensor and follows it op for op. Tolerance
    2e-6 absolute, as the float-``dt`` parity test: the products of one
    float32 formula in another order. A float ``dt`` gives the same bits
    as its float32 tensor."""
    g = np.random.default_rng(4)
    states = np.zeros((64, 13), np.float32)
    states[:, :3] = [0.0, 0.0, 0.6] + 0.01 * g.standard_normal((64, 3))
    q = g.standard_normal((64, 4))
    states[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    states[:, 7:] = 0.2 * g.standard_normal((64, 6))
    jp = jtrans.make_transition_params(0.3, 1.5, damping=6.0)
    tp = transition.make_transition_params(0.3, 1.5, damping=6.0)
    key = jax.random.PRNGKey(2)
    step = jax.jit(lambda k, s, d: jtrans.sample_transition(k, s, d, jp))
    want = step(key, jnp.asarray(states), jnp.float32(dt))
    # the JAX function's own draws, handed to the port as numpy arrays
    k1, k2 = jax.random.split(key)
    e1 = np.array(jax.random.normal(k1, (64, 6), jnp.float32))
    e2 = np.array(jax.random.normal(k2, (64, 6), jnp.float32))
    args = (torch.from_numpy(states), )
    kw = dict(e1=torch.from_numpy(e1), e2=torch.from_numpy(e2))
    got = transition.sample_transition(
        *args, torch.tensor(dt, dtype=torch.float32), tp, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    assert torch.equal(got, transition.sample_transition(*args, dt, tp,
                                                         **kw))
    d = transition.as_dt(dt)
    assert d.dtype == torch.float32 and d.shape == ()
    assert transition.as_dt(d) is d


# ---------------------------------------------------------------------------
# the fused sensor split at its host read
# ---------------------------------------------------------------------------

def test_sensor_plan_split_equals_the_call_across_levels():
    """One sensor, three clouds whose silhouettes need the tight level,
    the second and the full one: ``plan_device`` (no level),
    ``choose_level`` (one read of two float32 counts) and ``apply`` give
    ``__call__``'s loglik, map and ages bit for bit, with ``dt`` a float
    or a 0-d tensor."""
    cam = camera.make_camera(K_CAM, 32, 32)
    tr = particle_tracker(cam, [mesh.icosphere_mesh(0.05, 2)], particles=96)
    sensor = tr.sensor
    g = torch.Generator().manual_seed(0)
    levels = []
    for f, z0 in enumerate((1.2, 0.3, 0.16)):
        states = torch.zeros((96, 1, 13))
        states[..., 2] = z0
        states[..., 3] = 1.0
        states[..., :3] += 0.004 * torch.randn((96, 1, 3), generator=g)
        z = torch.full((cam.num_pixels,), 2.0)
        z[::7] = z0
        occ = sensor.init_occlusion(96, 0.1)
        want = sensor(states, tuple(x.clone() for x in occ), z, 1 / 30)
        plan = sensor.plan_device(states, z, torch.tensor(1 / 30))
        assert plan.level is None and plan.book["counts"].dtype == \
            torch.float32 and plan.book["counts"].shape == (2,)
        plan = sensor.choose_level(plan)
        levels.append(plan.level)
        assert sensor.last_level == plan.level
        got = sensor.apply(plan, states, tuple(x.clone() for x in occ), z)
        assert_same(got, want)
    assert levels == [0, 1, 2], levels


# ---------------------------------------------------------------------------
# the step programs against the plain eager steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_objects", [1, 2])
def test_particle_program_equals_the_eager_step(num_objects):
    """Five frames through ``track`` against ``rbcpf_step`` drawing from a
    twin of the tracker's generator: a varying ``dt``, a ``restore`` of
    frame 0's belief before frame 2, a watchdog re-initialization before
    frame 4. The belief is donated: every step writes the same buffers."""
    cam, meshes, frames = scene(num_objects)
    tr = particle_tracker(cam, meshes)
    tr.initialize(POSES[:num_objects])
    ref, gen = tr.belief.clone(), twin(tr.generator)
    buffers = None
    for f, (depth, dt) in enumerate(zip(frames, DTS)):
        if f == 2:
            tr.restore(saved)
            ref = saved.clone()
        if f == 4:
            watchdog.reinitialize_particle_tracker(tr, POSES[:num_objects])
            ref, gen = tr.belief.clone(), twin(tr.generator)
        poses, info = tr.track(depth, dt=dt)
        z = preprocess_depth(torch.as_tensor(depth).reshape(-1))
        ref, ref_info = rbcpf.rbcpf_step(
            ref, z, tr.sensor, tr.trans_params, float(np.float32(dt)),
            max_kl_divergence=tr.config.max_kl_divergence, generator=gen)
        assert_same(tr.belief, ref)
        assert_same(info, ref_info)
        assert torch.equal(tr.generator.get_state(), gen.get_state())
        if buffers is None:
            buffers = [x.data_ptr() for x in leaves(tr.belief)]
        assert [x.data_ptr() for x in leaves(tr.belief)] == buffers
        if f == 0:
            saved = tr.belief.clone()
    assert list(tr.programs) == [0] and not tr.programs[0].capture
    assert tr.programs[0].graph_count == 0


def test_island_trial_programs_equal_the_eager_steps():
    """Two islands race for two frames, each through its own program,
    against ``rbcpf_step`` with twins of the islands' generators and the
    eager pose score; the winner's program then goes on as the tracker's
    step."""
    cam, meshes, frames = scene(1, frames=3)
    tr = particle_tracker(cam, meshes)
    rival = POSES[:1].copy()
    rival[0, 0] += 0.01
    tr.initialize(POSES[:1], hypotheses=np.stack([rival, POSES[:1]]),
                  trial_frames=2, trial_switch_margin=0.0)
    trial = tr._trial
    refs = [b.clone() for b in trial["beliefs"]]
    gens = [twin(g) for g in trial["generators"]]
    scores = [0.0, 0.0]
    for f in range(3):
        z = preprocess_depth(torch.as_tensor(frames[f]).reshape(-1))
        poses, info = tr.track(frames[f], dt=DTS[f])
        if f < 2:
            for i in range(2):
                refs[i], ref_info = rbcpf.rbcpf_step(
                    refs[i], z, tr.sensor, tr.trans_params,
                    float(np.float32(DTS[f])), generator=gens[i],
                    max_kl_divergence=tr.config.max_kl_divergence)
                scores[i] += float(tr._pose_score(ref_info.mean_state, z))
                assert_same(trial["beliefs"][i], refs[i])
            assert trial["scores"] == scores
            best = int(np.argmax(scores)) if f == 1 else 0
        else:
            refs[best], ref_info = rbcpf.rbcpf_step(
                refs[best], z, tr.sensor, tr.trans_params,
                float(np.float32(DTS[f])), generator=gens[best],
                max_kl_divergence=tr.config.max_kl_divergence)
            assert_same(info, ref_info)
        assert_same(tr.belief, refs[best])
    assert tr.trial_active is None and tr.generator is trial[
        "generators"][best]
    assert sorted(tr.programs) == [0, 1]


def gaussian_eager(tr, belief, z, dt, learn_world=True):
    c = tr.config
    dt = torch.tensor(np.float32(dt))
    return rgf.rgf_step(
        belief, z, render_fn=tr.render_fn, trans_params=tr.trans_params,
        dt=dt, bp=tr.beam_params, iterations=c.update_iterations,
        trust_sigma=c.trust_sigma, lin_floor_pos=c.lin_floor_pos,
        lin_floor_rot=c.lin_floor_rot, lin_cap_pos=c.lin_cap_pos,
        lin_cap_rot=c.lin_cap_rot, bg_sigma=c.bg_sigma,
        occ_params=tr._occ_params, occ_dt_frames=dt * tr._frame_rate,
        learn_world=learn_world)


def test_gaussian_programs_equal_the_eager_steps():
    """Two frozen trial frames of two hypotheses, then three steps with a
    varying ``dt`` and a ``restore`` between them, against ``rgf_step``;
    the belief is not donated (as in the JAX tracker), so a belief held
    across ``track`` stays as it was."""
    cam, meshes, frames = scene(1)
    tr = gaussian_tracker(cam, meshes)
    rival = POSES[0].copy()
    rival[0] += 0.01
    tr.initialize(POSES[0], first_frame=frames[0],
                  hypotheses=np.stack([POSES[0], rival]), trial_frames=2)
    refs = list(tr._trial["beliefs"])
    for f in range(2):
        z = tr._frame(frames[f])
        tr.track(frames[f], dt=DTS[f])
        if tr._trial:
            for i, b in enumerate(tr._trial["beliefs"]):
                refs[i], _ = gaussian_eager(tr, refs[i], z, DTS[f], False)
                assert_same(b, refs[i])
    held = tr.belief
    copy = dataclasses.replace(held, **{
        k: getattr(held, k).clone() for k in ("mean", "cov", "background",
                                              "occ_prior")})
    ref = held
    for f in range(2, FRAMES):
        if f == 4:
            tr.restore(copy)
            ref = copy
        z = tr._frame(frames[f])
        pose, info = tr.track(frames[f], dt=DTS[f])
        ref, ref_info = gaussian_eager(tr, ref, z, DTS[f])
        assert_same(tr.belief, ref)
        assert_same(info, ref_info)
    assert_same(held, copy)
    assert sorted(tr.programs) == [False, True]


# ---------------------------------------------------------------------------
# what a capture forbids, seen on the CPU
# ---------------------------------------------------------------------------

class HostTouches(TorchDispatchMode):
    """Records the ops a CUDA-graph capture refuses or would freeze: a
    read back to the host, a tensor made from host data (a copy from the
    host on the card), and indexing by a boolean mask (a read of its
    count)."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.split(".")[1] in ("_local_scalar_dense", "lift_fresh",
                                  "nonzero", "masked_select"):
            self.found.append(name)
        if name.startswith(("aten.index.", "aten.index_put")) and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ())
                if i is not None):
            self.found.append(name + " (mask)")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def audited_programs(monkeypatch):
    """Every call of a step program's graph function after its first (on
    the card: the capture and the replays) runs under
    :class:`HostTouches`; yields the list of what was found."""
    found, seen = [], set()
    real_tolist = torch.Tensor.tolist

    def run(self, key, fn):
        if (id(self), key) not in seen:
            seen.add((id(self), key))
            return fn()
        with HostTouches() as audit:
            with monkeypatch.context() as m:
                m.setattr(torch.Tensor, "tolist", lambda t: found.append(
                    (key, "tolist")) or real_tolist(t))
                out = fn()
        found.extend((key, op) for op in audit.found)
        return out

    monkeypatch.setattr(graphs.StepProgram, "run", run)
    yield found


def test_graph_functions_read_nothing_back(monkeypatch):
    """Two objects with the fused sensor, a two-island trial, the "xla"
    sensor, and both Gaussian steps: from its second call on, no graph
    function reads a value back, makes a tensor from host data or indexes
    by a mask (the ladder's one read is outside the graphs)."""
    cam, meshes, frames = scene(2, frames=3)
    with audited_programs(monkeypatch) as found:
        tr = particle_tracker(cam, meshes, particles=128)
        tr.initialize(POSES)
        for depth in frames:
            tr.track(depth)
        tr.initialize(POSES, hypotheses=np.stack([POSES, POSES]),
                      trial_frames=3)
        for depth in frames:
            tr.track(depth, dt=0.05)
        xla = ParticleTracker(dataclasses.replace(
            tr.config, backend="xla", evaluation_count=16),
            meshes=meshes, camera=cam, device="cpu")
        xla.initialize(POSES)
        for depth in frames[:2]:
            xla.track(depth)
        gt = gaussian_tracker(cam, meshes[:1])
        gt.initialize(POSES[0], first_frame=frames[0],
                      hypotheses=np.stack([POSES[0]] * 2), trial_frames=2)
        for depth in frames:
            gt.track(depth)
        gt.track(frames[0], dt=torch.tensor(0.05))
    assert found == []
    assert tr.programs[0].graph_count == 0      # no capture on the CPU


@pytest.fixture(scope="module")
def one_rank():
    """A gloo group of world size 1 on a HashStore, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield comm_mod.Comm()
    finally:
        dist.destroy_process_group()


def scale_out_runs(comm, what):
    """(programmed step, its plain twin, a belief, frames) of one of the
    scale-out steps on a one-rank group: the fused sensor, 128 particles,
    the island trigger forced (``island_max_kl`` -1) or never firing."""
    num_objects = 2 if what == "distributed" else 1
    cam, meshes, frames = scene(num_objects, frames=3)
    tr = particle_tracker(cam, meshes, particles=128)
    poses = torch.as_tensor(POSES[:num_objects])
    args = (tr.sensor, tr.trans_params, 1 / 30)
    if what == "multi_scene":
        groups = dist_filter.make_scene_groups(1, 1)
        belief = dist_filter.init_multi_scene_belief(
            groups, poses, 2, 128, sensor=tr.sensor, device="cpu")
        make = lambda: dist_filter.make_multi_scene_step(  # noqa: E731
            groups, *args, max_kl_divergence=-1.0, seed=4)
        frames = [np.stack([f, f]) for f in frames]
    else:
        belief = dist_filter.init_distributed_belief(
            comm, poses, 128, sensor=tr.sensor, device="cpu")
        if what == "distributed":
            make = lambda: dist_filter.make_distributed_step(  # noqa: E731
                comm, *args, max_kl_divergence=-1.0, seed=4)
        else:
            kl = -1.0 if what == "island_exchange" else 1e6
            make = lambda: dist_filter.make_island_step(  # noqa: E731
                comm, *args, max_kl_divergence=0.5, island_max_kl=kl,
                seed=4)
    return make(), make(), belief, frames


def clone_all(belief):
    return ([b.clone() for b in belief] if isinstance(belief, list)
            else belief.clone())


@pytest.mark.parametrize("what", ["distributed", "island_exchange",
                                  "island_quiet", "multi_scene"])
def test_scale_out_programs_read_nothing_back(monkeypatch, one_rank, what):
    """The scale-out steps on a one-rank group (the segments the card
    captures under NCCL), run through their programs eagerly: from its
    second call on no graph function reads back, makes a tensor from
    host data or indexes by a mask, and every frame equals the plain
    step's, bit for bit, paths included (the belief donated: the same
    buffers every frame)."""
    step, twin, belief, frames = scale_out_runs(one_rank, what)
    assert step.capture is False
    ref = clone_all(belief)
    buffers = None
    with audited_programs(monkeypatch) as found:
        for depth in frames:
            z = preprocess_depth(torch.as_tensor(depth).reshape(
                len(depth) if what == "multi_scene" else 1, -1))
            z = z if what == "multi_scene" else z[0]
            got = step(belief, z)
            ref, *want = twin.plain(ref, z)
            assert_same(got, [ref, *want])
            assert step.paths == twin.paths and step.paths
            belief = got[0]
            ptrs = [x.data_ptr() for x in leaves(belief)]
            assert buffers in (None, ptrs)
            buffers = ptrs
    assert found == []
    if what.startswith("island"):
        assert step.paths == ["islands" if what == "island_exchange"
                              else "none"]
    else:
        assert set(step.paths) == {"local"}


def test_capture_over_gloo_raises(one_rank):
    """``capture=True`` needs an NCCL group (a gloo group stages CUDA
    tensors through the host); None means eager over gloo."""
    cam, meshes, _ = scene(1, frames=1)
    tr = particle_tracker(cam, meshes, particles=16)
    args = (tr.sensor, tr.trans_params, 1 / 30)
    groups = dist_filter.make_scene_groups(1, 1)
    for make in (lambda **k: dist_filter.make_distributed_step(
                     one_rank, *args, **k),
                 lambda **k: dist_filter.make_island_step(
                     one_rank, *args, **k),
                 lambda **k: dist_filter.make_multi_scene_step(
                     groups, *args, **k)):
        with pytest.raises(ValueError, match="NCCL"):
            make(capture=True)
        assert make().capture is False and make(capture=False).capture \
            is False
    assert not one_rank.capturable


def test_call_site_programs_equal_their_plain_functions(monkeypatch):
    """Both sources' renders and the batched Gaussian step through
    ``graphs.compiled`` (its beliefs donated): under the audit from their
    second call on, and bit-equal to the plain functions on the same
    inputs and draws; the programmed oracle render equals JAX's jitted
    render on JAX's draws (1e-5, equal NaN masks)."""
    cam, meshes, frames = scene(1, frames=3)
    jsrc, osrc, ocam = oracle_scene(quantize_mm=True)
    gt = gaussian_tracker(cam, meshes)
    gt.initialize(POSES[0], first_frame=frames[0])
    c = gt.config
    plain_step = rgf.make_batched_step(
        gt.render_fn, gt.trans_params, gt._dt, gt.beam_params,
        iterations=c.update_iterations, occ_params=gt._occ_params)
    with audited_programs(monkeypatch) as found:
        step = graphs.compiled(plain_step, "cpu", donate=True)
        beliefs = rgf.stack_beliefs([gt.belief] * 2)
        ref = beliefs
        for f, depth in enumerate(frames):
            zs = torch.stack([gt._frame(depth)] * 2)
            got = step(beliefs, zs)
            ref, ref_info = plain_step(ref, zs)
            assert_same(got, (ref, ref_info))
            # donated: from the second call on, the state comes back in
            # the buffers it was passed in
            assert (got[0].cov is beliefs.cov) == (f > 0)
            beliefs = got[0]
        syn = sources.SyntheticSource(meshes, cam, lambda t: POSES[:1], 3,
                                      dropout_prob=0.1, seed=2)
        twin_gen = torch.Generator().manual_seed(2)
        for t in range(3):
            pose = torch.as_tensor(POSES[:1])
            got = syn.render(pose)
            noise = torch.randn(cam.num_pixels, generator=twin_gen)
            drop = torch.rand(cam.num_pixels, generator=twin_gen)
            plain = syn._render_plain(pose, noise, drop)
            assert torch.equal(torch.isnan(got), torch.isnan(plain))
            assert torch.equal(got.nan_to_num(), plain.nan_to_num())
            assert bool(torch.isnan(got).any())
        key = jax.random.PRNGKey(5)
        for t, jf in enumerate(jsrc):
            key, k = jax.random.split(key)
            draws = jax_draws(k, ocam.num_pixels, ocam.height, ocam.width)
            poses, occ, p_drop = osrc.frame_inputs(t)
            args = (torch.as_tensor(poses), torch.as_tensor(occ))
            got = osrc.render(*args, p_drop, draws)
            plain = osrc._render_plain(*args, torch.tensor(p_drop), draws)
            assert torch.equal(torch.isnan(got), torch.isnan(plain))
            assert torch.equal(got.nan_to_num(), plain.nan_to_num())
            want = np.asarray(jf.depth)
            np.testing.assert_array_equal(np.isnan(got.numpy()),
                                          np.isnan(want))
            ok = ~np.isnan(want)
            np.testing.assert_allclose(got.numpy()[ok], want[ok], atol=1e-5,
                                       rtol=0)
    assert found == []
    for prog in (step.program, syn._render.program, osrc._render.program):
        assert not prog.capture and prog.graph_count == 0


# ---------------------------------------------------------------------------
# only the belief is donated: the other outputs outlive the next step
# ---------------------------------------------------------------------------

def storages(x):
    return {v.untyped_storage().data_ptr() for v in leaves(x)}


def outlive_runs(comm, what):
    """(a function stepping one frame → (belief, the step's other
    outputs), frames) for ``track`` (plain, or a 2-island trial whose
    second frame returns the winner's info) and the one-rank
    ``DistributedStep`` and ``IslandStep``."""
    if what in ("track", "trial"):
        cam, meshes, frames = scene(1, frames=3)
        tr = particle_tracker(cam, meshes, particles=128)
        if what == "trial":
            rival = POSES[:1].copy()
            rival[0, 0] += 0.01
            tr.initialize(POSES[:1], hypotheses=np.stack([rival, POSES[:1]]),
                          trial_frames=2, trial_switch_margin=0.0)
        else:
            tr.initialize(POSES[:1])

        def track(depth):
            _, info = tr.track(depth)
            return tr.belief, info
        return track, frames
    step, _, belief, frames = scale_out_runs(comm, what)
    state = {"belief": belief}

    def call(depth):
        z = preprocess_depth(torch.as_tensor(depth).reshape(-1))
        state["belief"], *out = step(state["belief"], z)
        return state["belief"], tuple(out)
    return call, frames


@pytest.mark.parametrize("what", ["track", "trial", "distributed",
                                  "island_exchange"])
def test_step_outputs_outlive_the_next_step(one_rank, what):
    """A caller keeps each step's outputs other than the belief (the
    tracker's StepInfo, in a trial the winner's; the scale-out steps'
    ``mean_state`` and ``ess``): the next step leaves them as they were
    and shares no storage with them, as in the reference, which donates
    only the belief. The belief stays donated (the same buffers every
    frame)."""
    step, frames = outlive_runs(one_rank, what)
    kept, clones, beliefs = [], [], []
    for depth in frames:
        belief, out = step(depth)
        for k, c in zip(kept, clones):
            assert_same(k, c)
            assert not storages(k) & storages(out)
        kept.append(out)
        clones.append(graphs.copy_out(out))
        beliefs.append([x.data_ptr() for x in leaves(belief)])
    assert beliefs[-1] == beliefs[-2]
    assert not any(storages(a) & storages(b)
                   for i, a in enumerate(kept) for b in kept[i + 1:])


# ---------------------------------------------------------------------------
# launch counts over replays; capture=True on the CPU
# ---------------------------------------------------------------------------

class StandInGraph:
    """A CUDA graph stand-in on the CPU: a capture records nothing, a
    replay counts itself (it would run the kernels, and no Python)."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def stand_in_cuda(monkeypatch):
    """Swap what StepProgram asks of torch.cuda for CPU stand-ins."""
    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(graphs, "resolve_capture", lambda d, c=None: True)


def test_launch_counts_survive_replays(monkeypatch):
    """A graph function that launches (bumps) every counter a known number
    of times: its eager first call counts, its capture's bumps are taken
    back, and each replay adds them again, so N calls count N times; a
    function that returns a tensor it did not keep is refused."""
    stand_in_cuda(monkeypatch)
    per_call = {(w, a): i + 1 for i, (w, a) in enumerate(graphs.COUNTERS)}
    for (w, a) in per_call:
        monkeypatch.setattr(w, a, 0)
    prog = graphs.StepProgram("cpu")
    assert prog.capture

    def fn():
        for (w, a), k in per_call.items():
            setattr(w, a, getattr(w, a) + k)
        return prog.keep("out", torch.ones(3))

    outs = [prog.run("step", fn) for _ in range(5)]
    assert all(o is outs[0] for o in outs) and prog.graph_count == 1
    assert prog._graphs["step"].graph.replays == 4
    for (w, a), k in per_call.items():
        assert getattr(w, a) == 5 * k, (a, getattr(w, a))
    with pytest.raises(RuntimeError, match="not a kept buffer"):
        prog.run("loose", lambda: torch.ones(2))
    assert kernels.fused_loglik.launches == 5 * per_call[
        (kernels.fused_loglik, "launches")]


def test_a_failed_capture_raises(monkeypatch):
    """A capture that fails (here: the stand-in refuses, as CUDA refuses a
    host read while a stream captures) raises from the step; nothing
    falls back to the eager step, and nothing is kept as captured."""
    stand_in_cuda(monkeypatch)

    @contextlib.contextmanager
    def refusing(*a, **k):
        yield
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(torch.cuda, "graph", refusing)
    prog = graphs.StepProgram("cpu")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing the step's graph"):
            prog.run("step", lambda: prog.keep("out", torch.ones(2)))
    assert prog.graph_count == 0


def test_the_collector_is_off_while_a_graph_is_recorded(monkeypatch):
    """A collection during a capture could free a dead program's graphs,
    and destroying a graph while a stream captures invalidates the
    capture: the collector is off for the capture (not for the eager
    first call) and back as it was after it, after a failed capture too;
    one that was off stays off."""
    stand_in_cuda(monkeypatch)
    seen = []
    prog = graphs.StepProgram("cpu")

    def fn():
        seen.append(gc.isenabled())
        return prog.keep("out", torch.ones(2))

    assert gc.isenabled()
    prog.run("step", fn)
    prog.run("step", fn)                        # a replay runs no Python
    assert seen == [True, False] and gc.isenabled()

    @contextlib.contextmanager
    def refusing(*a, **k):
        yield
        raise RuntimeError("operation failed due to a previous error "
                           "during capture")

    monkeypatch.setattr(torch.cuda, "graph", refusing)
    with pytest.raises(RuntimeError, match="capturing the step's graph"):
        prog.run("refused", fn)
    assert seen[-1] is False and gc.isenabled()
    gc.disable()
    try:
        with pytest.raises(RuntimeError):
            prog.run("off", fn)
        assert not gc.isenabled()
    finally:
        gc.enable()


@pytest.mark.parametrize("guarded", [True, False])
def test_no_collection_holds_a_dying_cycle_until_the_block_ends(guarded):
    """What the `gpu` test of a program dying mid-capture relies on: a
    cycle that dies in a block which then allocates as many containers as
    the collector tracks is freed inside the block (a full collection
    runs there), and under ``_no_collection`` only after it."""
    class Node:
        pass

    held = [Node()]
    held[0].cycle = held[0]
    inside, freed_inside = [False], []
    weakref.finalize(held[0], lambda: freed_inside.append(inside[0]))
    gc.collect()
    count = len(gc.get_objects())
    with graphs._no_collection() if guarded else contextlib.nullcontext():
        inside[0] = True
        held.clear()
        junk = [[] for _ in range(count)]
        inside[0] = False
    del junk
    gc.collect()
    assert freed_inside == [not guarded]


def test_comm_byte_counts_survive_replays(monkeypatch, one_rank):
    """A graph function that all-reduces over a group (counted as three
    ranks, so that it sends bytes): with the group's byte counters given
    to the program, N calls count N all-reduces over replays."""
    stand_in_cuda(monkeypatch)
    monkeypatch.setattr(one_rank, "size", 3)
    prog = graphs.StepProgram("cpu", counters=one_rank.counters())
    x = torch.ones(4)
    before = dict(one_rank.bytes_sent)
    for _ in range(5):
        prog.run("step", lambda: prog.keep("out", one_rank.all_reduce(x)))
    assert prog._graphs["step"].graph.replays == 4
    sent = {k: one_rank.bytes_sent[k] - before[k] for k in before}
    assert sent == {"all_gather": 0, "all_reduce": 5 * 16 * 2,
                    "ppermute": 0}


def test_capture_on_the_cpu_raises():
    cam, meshes, _ = scene(1, frames=1)
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.StepProgram("cpu", capture=True)
    with pytest.raises(ValueError, match="CUDA device"):
        particle_tracker(cam, meshes, capture=True)
    with pytest.raises(ValueError, match="CUDA device"):
        gaussian_tracker(cam, meshes, capture=True)
    assert not particle_tracker(cam, meshes).capture
    assert not graphs.resolve_capture("cpu")
    assert graphs.resolve_capture("cuda") and graphs.resolve_capture(
        "cuda", None)
    assert not graphs.resolve_capture("cuda", False)
    prog = graphs.StepProgram("cpu")
    a = prog.keep("x", {"a": torch.ones(2), "b": None, "c": (3, 1.5)})
    assert a["b"] is None and a["c"] == (3, 1.5)
    assert prog.keep("x.a", a["a"]) is a["a"]
    with pytest.raises(ValueError, match="buffer 'x.a'"):
        prog.keep("x.a", torch.ones(3))
