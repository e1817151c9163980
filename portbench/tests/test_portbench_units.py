"""The generators, the readers and the work counts give known answers at
small sizes on the CPU."""

import json
import math

import numpy as np
import pytest
import torch

from portbench.core import report, spec, trace, traffic
from portbench.core.runner import FrameRec, Run
from portbench.reference import pf, scene

CAM = {"camera_matrix": None, "resolution": [480, 640],
       "downsampling_factor": 16, "frame_rate": 30.0}
MESH = {"subdivisions": 1, "semi_axes_m": [0.06, 0.045, 0.03]}


def _mix(name, **extra):
    params = spec.traffic(name)
    params.update(period_frames=30, **extra)
    return params


@pytest.mark.parametrize("name", ["stream", "fast_occluded"])
def test_traffic_is_a_function_of_the_seed(name):
    obj = scene.object_obj_text(MESH)
    conf = {"camera": CAM}
    params = _mix(name)
    if params.get("occluder"):
        params["occluder"]["frames"] = [5, 20]
        params["dropout"]["frames"] = [22, 25]
    a = traffic.make(params, conf, [obj], 2**33 + 5, "cpu")
    b = traffic.make(params, conf, [obj], 2**33 + 5, "cpu")
    c = traffic.make(params, conf, [obj], 2**33 + 6, "cpu")
    assert np.array_equal(a.frames, b.frames, equal_nan=True)
    assert np.array_equal(a.truth, b.truth)
    assert not np.array_equal(a.truth, c.truth)
    assert a.frames.shape == (30, 30, 40)
    on_object = np.isfinite(a.frames) & (a.frames < 1.2)
    assert on_object.sum(axis=(1, 2)).min() > 0


@pytest.mark.parametrize("name", ["stream", "fast_occluded", "live30hz"])
def test_trajectories_wrap_without_a_jump(name):
    params = spec.traffic(name)
    period = params["period_frames"]
    rng = np.random.default_rng(7)
    poses = scene.trajectory(params["motion"], rng, period,
                             params["rate_hz"])
    steps = np.linalg.norm(np.diff(poses[:, :3], axis=0), axis=1)
    wrap = np.linalg.norm(poses[0, :3] - poses[-1, :3])
    assert wrap <= 1.5 * steps.max()
    q = torch.as_tensor(poses[:, 3:])
    dots = torch.abs(torch.sum(q[1:] * q[:-1], dim=1))
    wrap_dot = abs(float(torch.sum(q[0] * q[-1])))
    assert wrap_dot >= float(dots.min()) - 1e-9
    # the rates the cells' whys state
    v = steps.max() * params["rate_hz"]
    assert v <= 0.05
    ang = 2 * np.arccos(np.clip(dots.numpy(), -1, 1)) * params["rate_hz"]
    if params["motion"]["rotation"]["kind"] == "spin":
        assert ang.max() == pytest.approx(2 * math.pi * 14 / 20, rel=1e-6)
    else:
        assert ang.max() <= 0.9


def test_u16_conversion_matches_the_transport():
    mm = np.array([[0, 800, 65535, 1], [2, 3, 4, 5]], np.uint16)
    got = scene.preprocess_u16(mm, 2)
    assert got.shape == (1, 2)
    assert np.isnan(got[0, 0])
    assert got[0, 1] == np.float32(65535) * np.float32(1e-3)


def _trace():
    dev = [("fused_loglik_kernel<2>", 0.10, 0.11),
           ("sum_partials_kernel", 0.11, 0.112),
           ("lineage_gather_kernel<bf16>", 0.12, 0.15),
           ("Memcpy DtoH (Device -> Pinned)", 0.20, 0.201),
           ("fused_loglik_kernel<2>", 0.60, 0.61),
           ("sum_partials_kernel", 0.61, 0.612),
           ("lineage_gather_kernel<bf16>", 0.62, 0.65),
           ("Memcpy DtoH (Device -> Pinned)", 0.70, 0.701)]
    host = [("aten::add", 0.0, 0.05), ("aten::mul", 0.05, 0.09),
            ("cudaGraphLaunch", 0.3, 0.55), ("aten::copy_", 0.3, 0.31)]
    return trace.Trace(dev, host, window_s=1.0, frames=2)


def _run(tr, counts=(100.0, 50.0)):
    frames = [FrameRec(index=i, hand=0.0, done=1.0, phase="device",
                       counts=counts, level=i % 2, resampled=bool(i))
              for i in range(2)]
    return Run(cell="pf10k.stream", kind="particle",
               settings={"backend_options": {}}, traffic=None, seconds=1.0,
               frames=frames, t_start=0.0, t_end=1.0, trace=tr,
               host_trace=tr, untraced_fps=1.5,
               num_pixels=4800, num_particles=10000)


def test_readers_on_a_recorded_trace():
    tr = _trace()
    run = _run(tr)
    busy = 0.012 + 0.03 + 0.001 + 0.012 + 0.03 + 0.001
    assert tr.busy_s() == pytest.approx(busy)
    r = lambda n: spec.reader(n).read(run)  # noqa: E731
    assert r("device.idle_share") == pytest.approx(1 - busy / 2 * 1.5)
    assert r("device.kernels_per_frame") == pytest.approx(4.0)
    assert r("step.host_reads_per_frame") == pytest.approx(1.0)
    assert r("step.host_ops_per_frame") == pytest.approx(1.5)
    assert r("filters.resampled_share") == pytest.approx(0.5)
    assert r("sensor.wide_level_share") == pytest.approx(0.5)
    fl, nb = spec.work_count("fused_loglik").work_at(100, 50, 10000, 2)
    least = 2 * max(fl / 67e12, nb / 3.35e12)
    assert r("fused_loglik_roofline") == pytest.approx(100 * least / 0.024)
    lb = 2 * (2 * 2 * 4800 * 10000 + 4 * 10000) / 3.35e12
    assert r("step_mfu") == pytest.approx(100 * (least + lb) / 2 * 1.5)
    gaps = dict(tr.idle_gaps())
    assert gaps["cudaGraphLaunch"] == pytest.approx(0.60 - 0.201)
    # gaps with no host event over their middle
    assert gaps["host idle"] == pytest.approx(
        (0.12 - 0.112) + (0.20 - 0.15) + (0.62 - 0.612) + (0.70 - 0.65)
        + (1.0 - 0.701))
    assert sum(gaps.values()) == pytest.approx(1 - busy)


def test_readers_find_nothing_without_a_trace_or_counts():
    run = _run(None)
    for name in ("device.idle_share", "fused_loglik_roofline", "step_mfu",
                 "step.host_ops_per_frame"):
        assert spec.reader(name).read(run) is None
    run = _run(_trace(), counts=None)
    assert spec.reader("fused_loglik_roofline").read(run) is None


@pytest.mark.parametrize("objects", [1, 2])
def test_work_counts_by_hand(objects):
    """A frame of K objects runs the fused kernel and the lineage gather
    once a coordinate block: K times one call's work."""
    fl, nb = spec.work_count("fused_loglik").work_at(2, 3, 4, 2)
    assert nb == 2 * 2 * 2 * 4 + 10 * 4 * 3 * 4 + 2 * (4 + 12 + 8 + 4) + 16
    assert fl == 2 * 4 * (31 * 2 + 50)
    fl, nb = spec.work_count("lineage_gather").work_at(3, 5)
    assert (fl, nb) == (0.0, 2 * 2 * 3 * 5 + 4 * 5)
    run = _run(None, counts=(2, 3))
    run.objects, run.num_particles, run.num_pixels = objects, 4, 3
    frame = run.frames[0]
    one = spec.work_count("fused_loglik").work_at(2, 3, 4, 2)
    assert spec.work_count("fused_loglik").work(run, frame) == tuple(
        objects * x for x in one)
    assert spec.work_count("lineage_gather").work(run, frame) == (
        0.0, objects * (2 * 2 * 3 * 4 + 4 * 4))


def test_percentile_counts_a_lost_frame_as_missing():
    assert report.p95_ms([0.001] * 18 + [math.inf] * 2) == math.inf
    assert report.p95_ms([0.001] * 19 + [math.inf]) == pytest.approx(1.0)
    assert report.p95_ms([0.001 * i for i in range(1, 21)]) == \
        pytest.approx(19.0)


def test_pose_gaps_read_rounding_as_rounding():
    q = torch.tensor([0.8876, -0.3090, 0.1559, -0.3039])
    q = q / torch.linalg.norm(q)
    a = torch.cat([torch.tensor([0.02, 0.01, 0.8]), q])
    # the same position scaled (a weight sum off 1), the same rotation
    b = torch.cat([torch.tensor([0.02, 0.01, 0.8], dtype=torch.float64)
                   * 1.00125, -q.double()])
    lat, scale, r = pf.pose_gaps(a, b)
    assert lat < 1e-8 and scale == pytest.approx(0.00125 / 1.00125, rel=1e-3)
    assert r < 1e-6
    c = torch.cat([torch.tensor([0.021, 0.01, 0.8]), q])
    lat, scale, r = pf.pose_gaps(c, a)
    assert lat == pytest.approx(0.001, rel=1e-2)



def test_split_cuts_the_trace_where_host_ops_are_recorded():
    raw = [("fused_loglik_kernel<2>", True, 1_000, 2_000),
           ("cudaGraphLaunch", False, 500, 900),
           ("portbench.host_trace", False, 5_000, 5_001),
           ("aten::add", False, 6_000, 7_000),
           ("Memcpy DtoH (Device -> Pinned)", True, 8_000, 9_000)]
    dev, host = trace.split(raw, "portbench.host_trace", 1.0, 0.5, 4, 2)
    assert [e[0] for e in dev.device] == ["fused_loglik_kernel<2>"]
    assert [e[0] for e in dev.host] == ["cudaGraphLaunch"]
    assert dev.device[0][1] == pytest.approx(500e-9)
    assert (dev.window_s, dev.frames) == (1.0, 4)
    assert host.count_host_ops() == 1 and host.count_device() == 1
    assert host.host[0][1] == pytest.approx(1_000e-9)
    assert (host.window_s, host.frames) == (0.5, 2)
    dev, host = trace.split(raw[:2], "portbench.host_trace", 1.0, 0.5, 4, 2)
    assert host is None and dev.count_device() == 1


@pytest.mark.parametrize("objects", [1, 2])
def test_the_references_counts_are_the_ladders_at_the_pose(tmp_path,
                                                           objects):
    """The fused likelihood's work is counted from the reference's
    candidate pass at the frame's true poses: where every particle sits
    at those poses, the program's own ladder counts are the same (at
    K = 2 over both meshes' triangles, the box crossing the ellipsoid)."""
    from portbench.core import runner
    from portbench.tests.test_portbench_objects import two_object_files

    if objects == 1:
        conf, params = spec.config("pf_rbcpf_10k"), spec.traffic("stream")
    else:
        conf, params = two_object_files()
    settings = dict(conf["settings"], evaluation_count=64, seed=1)
    objs = [scene.object_obj_text(m) for m in spec.meshes(conf)]
    paths = []
    for k, obj in enumerate(objs):
        (tmp_path / f"object{k}.obj").write_text(obj)
        paths.append(str(tmp_path / f"object{k}.obj"))
    settings["object"] = dict(settings["object"], meshes=paths)
    sensor = runner.build_tracker("particle", settings, "cpu").sensor
    ref = pf.ParticleReference(settings, objs, "cpu")
    truth = np.stack([scene.trajectory(
        m, np.random.default_rng(5 + k), params["period_frames"],
        params["rate_hz"]) for k, m in enumerate(spec.motions(params))],
        axis=1)                                       # (period, K, 7)
    both = 0
    for pose in truth[::50]:
        pc = scene.to_center_frame(
            torch.as_tensor(pose, dtype=torch.float32), ref.centers)
        states = torch.zeros((64, objects, 13))
        states[..., :7] = pc[None]
        plan = sensor.plan_device(states, torch.zeros(ref.N), 1 / 30)
        got = tuple(int(v) for v in plan.book["counts"].tolist())
        assert got == ref.candidate_counts(pose)
        assert got[0] > 0
        cand = ref.candidates(states)
        both += bool((cand < 1408).any() and (cand != ref.deg).any()
                     and ((cand >= 1408) & (cand != ref.deg)).any())
    if objects == 2:
        assert both > 0          # frames whose table names both meshes


PINNED_JSON = '''
{
 "stream": {
  "frames_sum": 229153.42915016413,
  "nan": 0,
  "pixels": [
   0.7511484026908875,
   0.7969187498092651,
   0.7449856400489807,
   0.7536699175834656
  ],
  "pixels2": [
   1.6016173362731934,
   1.5985361337661743
  ],
  "truth": [
   [
    -0.007220861501991749,
    0.010639963671565056,
    0.7802900671958923,
    0.9176523685455322,
    -0.12046406418085098,
    0.23415769636631012,
    -0.29761165380477905
   ],
   [
    0.0009894531685858965,
    0.012818126939237118,
    0.8199848532676697,
    0.7571326494216919,
    0.43644043803215027,
    -0.2619066536426544,
    -0.40948113799095154
   ],
   [
    0.009028682485222816,
    -0.01856200210750103,
    0.7806136012077332,
    0.9209045767784119,
    0.11947726458311081,
    0.29482364654541016,
    -0.22525301575660706
   ],
   [
    0.01550676953047514,
    -0.0013461792841553688,
    0.8179406523704529,
    0.9501593708992004,
    -0.09762746840715408,
    -0.26242804527282715,
    0.13710428774356842
   ],
   [
    0.019303595647215843,
    0.019393986091017723,
    0.7842892408370972,
    0.9194815754890442,
    0.22508910298347473,
    0.27081143856048584,
    -0.17478486895561218
   ]
  ],
  "pose": [
   -0.007224326953291893,
   0.010632538236677647,
   0.7802729606628418,
   0.9176545739173889,
   -0.12045557051897049,
   0.23414696753025055,
   -0.29761675000190735
  ],
  "mean_loglik": -8710.255859375,
  "kl": 0.006272792816162109,
  "resampled": false,
  "counts": [
   56,
   48
  ]
 },
 "fast_occluded": {
  "frames_sum": 212571.91406944394,
  "nan": 7166,
  "pixels": [
   0.7545873522758484,
   0.7868239283561707,
   0.7641004323959351,
   0.74589604139328
  ],
  "pixels2": [
   1.6016173362731934,
   1.5985361337661743
  ],
  "truth": [
   [
    -0.007220861501991749,
    0.010639963671565056,
    0.7802900671958923,
    0.9689124226570129,
    0.14393411576747894,
    0.0065393163822591305,
    -0.20111918449401855
   ],
   [
    0.0009894531685858965,
    0.012818126939237118,
    0.8199848532676697,
    0.5943149328231812,
    0.6185903549194336,
    0.5139221549034119,
    -0.00444771908223629
   ],
   [
    0.009028682485222816,
    -0.01856200210750103,
    0.7806136012077332,
    0.17356379330158234,
    -0.6839013695716858,
    -0.6812227368354797,
    -0.19516697525978088
   ],
   [
    0.01550676953047514,
    -0.0013461792841553688,
    0.8179406523704529,
    0.8265886306762695,
    -0.2966482937335968,
    -0.39773184061050415,
    -0.26563212275505066
   ],
   [
    0.019303595647215843,
    0.019393986091017723,
    0.7842892408370972,
    0.9326277375221252,
    0.28690844774246216,
    0.1489536464214325,
    -0.16031818091869354
   ]
  ],
  "pose": [
   -0.007225873414427042,
   0.010644853115081787,
   0.7806316614151001,
   0.9689111113548279,
   0.14394134283065796,
   0.0065264287404716015,
   -0.20112104713916779
  ],
  "mean_loglik": -8677.3642578125,
  "kl": -0.0014657974243164062,
  "resampled": false,
  "counts": [
   50,
   42
  ]
 }
}
'''


# the one-object path at a short period, seed 0, 512 particles, on the
# CPU, as it read before scenes of several objects were supported; floats
# to 1e-6 relative (pixels, poses: 1e-6 absolute), the KL to 1e-4
PINNED = json.loads(PINNED_JSON)


@pytest.mark.parametrize("name", ["stream", "fast_occluded"])
def test_the_one_object_path_reads_as_before(name):
    want = PINNED[name]
    conf = spec.config("pf_rbcpf_10k")
    settings = dict(conf["settings"], evaluation_count=512)
    obj = scene.object_obj_text(conf["assumed"]["mesh"])
    params = spec.traffic(name)
    params.update(period_frames=30, warmup_frames=6)
    if params.get("occluder"):
        params["occluder"]["frames"] = [0, 20]
        params["dropout"]["frames"] = [22, 25]
    t = traffic.make(params, settings, [obj], 0, "cpu")
    assert t.truth.shape == (30, 7)
    f = t.frames.astype(np.float64)
    assert np.nansum(f) == pytest.approx(want["frames_sum"], rel=1e-6)
    assert int(np.isnan(f).sum()) == want["nan"]
    got = [t.frames[i, 30, 40] for i in (0, 9, 17, 29)] + [
        t.frames[i, 25, 35] for i in (3, 12)]
    assert got == pytest.approx(want["pixels"] + want["pixels2"], abs=1e-6)
    assert t.truth[::7] == pytest.approx(np.asarray(want["truth"]),
                                         abs=1e-6)
    ref = pf.ParticleReference(settings, [obj], "cpu")
    st = ref.step(ref.initial(t.truth[0]), t.frames[0], 1 / 30,
                  ref.draw(ref.generator()))
    assert st.pose.reshape(-1).tolist() == pytest.approx(want["pose"],
                                                         abs=1e-6)
    assert float(st.mean_loglik) == pytest.approx(want["mean_loglik"],
                                                  rel=1e-6)
    assert st.kl == pytest.approx(want["kl"], abs=1e-4)
    assert st.resampled is want["resampled"]
    assert list(ref.candidate_counts(t.truth[5])) == want["counts"]
