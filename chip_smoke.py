#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
port's CUDA kernels from ``dbot_ros_tpu_torch/csrc`` and then:

1. device: checks that CUDA is available and TF32 matmul is off, prints
   the card's ``nvidia-smi`` name and power limit;
2. build: compiles the kernels (seconds printed);
3. kernels: runs each of the four kernels against its plain PyTorch
   version at the main path's shapes (10,000 particles, 448 selected
   pixels, 2 candidates, 288 packed triangles; the full 4800-pixel map),
   with the tolerances stated below, and times both with CUDA events:
   device time per call (CUDA-graph replay) and time per call from
   Python. The lineage gather runs on four parent vectors (systematic
   parents of a real step's weights, one parent for all, the identity, a
   random permutation) in bfloat16 and once in float32, bit-exact. Each
   kernel's bound (the least time the card could take: bytes over the
   memory rate, operations over the float32 rate) is computed from the
   run's inputs, and the one PyTorch call that computes the same
   function, where there is one, is timed beside it;
4. sensor: the fused sensor on the card against the same sensor on the
   CPU (plain kernels) on a small scene, three frames with lazy ages;
5. slice: ``ParticleTracker`` (10,000 particles, 80×60 Kinect frame,
   1280-face icosphere padded to 1408 triangles, backend "pallas")
   driven by ``runtime.node.run`` over a 60-frame synthetic trajectory;
   every frame must launch all four kernels, and the position RMSE
   must stay under 1 cm. Then the median ms per ``track`` call;
6. profile: ``torch.profiler`` over 10 ``track`` calls — device busy ms
   per step, idle share, kernels per step, the largest kernels (the full
   table goes to ``build/profile_step.txt``);
7. cli: the command-line tracker at the same width, in-process through
   ``dbot_ros_tpu_torch.runtime.cli.main``: ``record`` a 60-frame
   ``teleport`` trajectory of the icosphere (written to an ``.obj``),
   then ``track --auto-init --watchdog --checkpoint``. Checks the
   auto-init pose (within 1 cm of the truth), the 60 JSONL records, that
   the watchdog tripped and the frames after it raced at least two
   island hypotheses, the position error of the last 10 frames (under
   1 cm), the checkpoint (load, restore, one more frame) and that all
   four kernels launched. Prints the seconds of the search and of the
   re-init, and the per-frame latency inside and outside the trial.

Each phase prints one JSON line; any failure raises (exit code != 0).
The last line is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch.models import beam, occlusion, transition
from dbot_ros_tpu_torch.ops import build, kernels, raycast
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import resample
from dbot_ros_tpu_torch.runtime import checkpoint, cli, node, sources
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import se3
from dbot_ros_tpu_torch.utils.camera import default_kinect_camera, make_camera
from dbot_ros_tpu_torch.utils.mesh import icosphere_mesh, tagged_l_mesh

P = 10_000
SEED = 0
FRAMES = 60
RMSE_LIMIT_M = 0.01
TIMING_RUNS = 20
GRAPH_REPLAYS = 20
WARMUP = 5
# loglik: summation order differs (per-chunk partial sums vs one sum over
# pixels), each term is at most |log 1e-30| ≈ 69 nats, f32 eps 6e-8:
# |Δ| <= 1e-5·|ll| + 1e-4·n_pixels nats
LL_RTOL, LL_ATOL_PER_PIXEL = 1e-5, 1e-4
# occ': the same f32 math rounded to bf16 by both; 1 bf16 ulp allowed
OCC_ULPS = 1
PROFILE_TABLE = Path(__file__).resolve().parent / "build" / "profile_step.txt"
# published peaks of one H100 SXM: HBM3 bytes/s, float32 FLOP/s outside
# the tensor cores (none of the four kernels uses them)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# arithmetic of the fused kernel per (pixel, particle), a transcendental
# counted as one operation: 31 per candidate triangle (three 3-term dot
# products, the inside tests, one division, the running minimum) and 50
# for the beam likelihood and the occlusion posterior
FUSED_FLOPS_PER_CANDIDATE = 31
FUSED_FLOPS_PER_PIXEL = 50
CLI_FRAMES = 60
CLI_POS_LIMIT_M = 0.01

KERNELS = {
    "fused_loglik": ("dbot_ros_tpu_torch/csrc/fused_loglik.cu",
                     "dbot_ros_tpu/ops/raycast_pallas.py:192"),
    "gather_pixel_rows": ("dbot_ros_tpu_torch/csrc/pixel_rows.cu",
                          "dbot_ros_tpu/ops/raycast_pallas.py:584"),
    "scatter_pixel_rows": ("dbot_ros_tpu_torch/csrc/pixel_rows.cu",
                           "dbot_ros_tpu/ops/raycast_pallas.py:508"),
    "lineage_gather": ("dbot_ros_tpu_torch/csrc/lineage_gather.cu",
                       "dbot_ros_tpu/ops/raycast_pallas.py:430"),
}
WRAPPERS = {"fused_loglik": kernels.fused_loglik,
            "gather_pixel_rows": kernels.gather_pixel_rows,
            "scatter_pixel_rows": kernels.scatter_pixel_rows,
            "lineage_gather": kernels.lineage_gather}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _events_ms(run, count):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def device_ms(fn):
    """Median device time of one call of ``fn``: the call is captured once
    in a CUDA graph and replayed back to back between CUDA events, so the
    host's launch cost is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    return statistics.median(_events_ms(graph.replay, GRAPH_REPLAYS)
                             for _ in range(TIMING_RUNS))


def call_ms(fn):
    """Median time of one call from the host, launch included, timed
    alone with CUDA events after warm-up."""
    for _ in range(WARMUP):
        fn()
    return statistics.median(_events_ms(fn, 1) for _ in range(TIMING_RUNS))


def time_pair(plain, kernel, library=None):
    """Device and per-call times of both versions, measured in turns
    (plain, kernel, kernel, plain) and averaged per version. ``library``
    is the one PyTorch call that computes the same function, where there
    is one: its device time is taken in the same turns (``library_ms``,
    else None)."""
    out = {"ms": [], "plain_ms": [], "call_ms": [], "plain_call_ms": [],
           "library_ms": []}
    for pre, fn in (("plain_", plain), ("", kernel), ("", kernel),
                    ("plain_", plain)):
        out[pre + "ms"].append(device_ms(fn))
        out[pre + "call_ms"].append(call_ms(fn))
        if library is not None:
            out["library_ms"].append(device_ms(library))
    return {k: statistics.mean(v) if v else None for k, v in out.items()}


def roofline(bytes_moved, flops=0):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    by_bytes = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_F32_FLOPS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(bytes_moved), "flops": int(flops)}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_device():
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmul is on; the port packs constants in full float32")
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False})
    return card


def phase_build():
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": path.name})


def scene(dev, particles, camera, mesh, depth, seed):
    """Particles scattered around a reference pose and a noisy frame with
    NaN and out-of-range depths."""
    g = np.random.default_rng(seed)
    ref = np.array([0.0, 0.0, depth, 1.0, 0.0, 0.0, 0.0], np.float32)
    states = np.zeros((particles, 1, 13), np.float32)
    states[:, 0, :3] = ref[:3] + 0.005 * g.standard_normal((particles, 3))
    states = torch.as_tensor(states, device=dev)
    drot = torch.as_tensor(0.03 * g.standard_normal((particles, 3)),
                           dtype=torch.float32, device=dev)
    states[:, 0, 3:7] = se3.quat_boxplus(
        torch.as_tensor(ref[3:7], device=dev).expand(particles, 4), drot)
    z = raycast.raycast_depth(mesh, torch.as_tensor(ref, device=dev),
                              camera.rays)
    z = torch.where(torch.isfinite(z), z, 2.0).cpu().numpy()
    z = z + 0.002 * g.standard_normal(z.shape).astype(np.float32)
    hit = np.flatnonzero(z < 1.5)
    z[hit[::7]] = 0.3           # finite, below min_depth
    z[hit[3::11]] = 6.0         # finite, above max_depth
    z[::37] = np.nan
    return states, torch.as_tensor(z, device=dev)


def phase_kernels(dev):
    cam = default_kinect_camera(8, device=dev)
    mesh = icosphere_mesh(radius=0.06, subdivisions=3, device=dev)
    bp = beam.make_beam_params(device=dev)
    op = occlusion.make_occlusion_params(device=dev)
    sensor = fs.make_fused_sensor(mesh, cam, bp, op, device=dev)
    states, z = scene(dev, P, cam, mesh, 0.8, SEED)
    N = cam.num_pixels
    p_pad = fs.particle_pad(P)

    cand = sensor.candidates(states)
    book = sensor.selection(cand)
    pcap, tcap = sensor.caps(N)[0]
    n_active, n_uniq = (int(v) for v in torch.stack(
        [book["n_active"], book["n_uniq"]]).tolist())
    check(n_active <= pcap and n_uniq < tcap,
          f"scene does not fit the tight level: {n_active=} {n_uniq=}")
    sel, uniq = sensor.level_indices(book, pcap, tcap, N)
    gt = sensor.pack_selected(states, p_pad, uniq)
    inv = torch.clamp(book["cp"].to(torch.int64) - 1, 0, tcap - 1)
    cand_sel = inv[cand][sel].to(torch.int32).contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    ages = torch.randint(0, 6, (pcap,), generator=g, device=dev).float()
    occ = torch.rand((pcap, p_pad), generator=g,
                     device=dev).to(torch.bfloat16)
    params = fs.make_params_vec(bp, op, 1.0, 0.25)
    args = (gt, occ, z[sel].contiguous(), cand_sel,
            cam.rays[sel].contiguous(), ages, params)
    shapes = {"n": pcap, "K": cand_sel.shape[1], "T": gt.shape[0],
              "P": P, "p_pad": p_pad}
    check(shapes["n"] == 448 and shapes["T"] == 288,
          f"unexpected slice shapes {shapes}")

    ll_k, occ_k = kernels.fused_loglik(*args)
    ll_p, occ_p = kernels.fused_loglik_plain(*args)
    torch.cuda.synchronize()
    ll_k, ll_p = ll_k[:P], ll_p[:P]
    check(bool(torch.isfinite(ll_k).all()), "fused loglik not finite")
    err = (ll_k - ll_p).abs()
    bound = LL_RTOL * ll_p.abs() + LL_ATOL_PER_PIXEL * pcap
    ulps = (occ_k.view(torch.int16).int()
            - occ_p.view(torch.int16).int()).abs().max().item()
    check(bool((err <= bound).all()),
          f"fused loglik off: max err {err.max().item()}")
    check(ulps <= OCC_ULPS, f"fused occ' off by {ulps} bf16 ulps")
    out = {"fused_loglik": {"max_abs_err": err.max().item(),
                            "occ_max_ulps": ulps}}
    out["fused_loglik"].update(time_pair(
        lambda: kernels.fused_loglik_plain(*args),
        lambda: kernels.fused_loglik(*args)))
    # bytes: only the slabs some pixel's candidate names have to be read
    # (each once), the map rows in and out, the per-pixel inputs, loglik
    slabs_read = int(cand_sel.unique().numel())
    out["fused_loglik"].update(roofline(
        slabs_read * gt[0].numel() * 4 + 2 * nbytes(occ)
        + nbytes(*args[2:]) + 4 * p_pad,
        pcap * p_pad * (FUSED_FLOPS_PER_CANDIDATE * cand_sel.shape[1]
                        + FUSED_FLOPS_PER_PIXEL)))
    out["fused_loglik"]["slabs_read"] = slabs_read
    out["fused_loglik"]["bytes_all_slabs"] = nbytes(gt) + 2 * nbytes(occ)

    n_pad = fs._round_up(N, sensor.nb)
    q = torch.rand((n_pad, p_pad), generator=g,
                   device=dev).to(torch.bfloat16)
    sel32 = sel.to(torch.int32).contiguous()
    check(sel32.unique().numel() == sel32.numel(), "sel not distinct")
    rows_k = kernels.gather_pixel_rows(q, sel32)
    rows_p = kernels.gather_pixel_rows_plain(q, sel32)
    check(torch.equal(rows_k, rows_p), "gather_pixel_rows differs")
    out["gather_pixel_rows"] = {"max_abs_err": 0.0}
    sel64 = sel32.long()
    out["gather_pixel_rows"].update(time_pair(
        lambda: kernels.gather_pixel_rows_plain(q, sel32),
        lambda: kernels.gather_pixel_rows(q, sel32),
        library=lambda: q.index_select(0, sel64)))
    out["gather_pixel_rows"].update(roofline(2 * nbytes(rows_k)
                                          + nbytes(sel32)))

    vals = occ_k
    q_k, q_p = q.clone(), q.clone()
    kernels.scatter_pixel_rows(q_k, vals, sel32)
    kernels.scatter_pixel_rows_plain(q_p, vals, sel32)
    check(torch.equal(q_k, q_p), "scatter_pixel_rows differs")
    out["scatter_pixel_rows"] = {"max_abs_err": 0.0}
    out["scatter_pixel_rows"].update(time_pair(
        lambda: kernels.scatter_pixel_rows_plain(q_p, vals, sel32),
        lambda: kernels.scatter_pixel_rows(q_k, vals, sel32),
        library=lambda: q_p.index_copy_(0, sel64, vals)))
    out["scatter_pixel_rows"].update(roofline(2 * nbytes(vals)
                                           + nbytes(sel32)))
    del q_k, q_p

    out["lineage_gather"], lineage = lineage_results(dev, q, g)
    emit({"phase": "kernels", "shapes": shapes, "n_active": n_active,
          "n_uniq": n_uniq, "tolerance": {
              "loglik": f"|d| <= {LL_RTOL}*|ll| + {LL_ATOL_PER_PIXEL}*n",
              "occ": f"<= {OCC_ULPS} bf16 ulp", "rows": "bit-exact",
              "lineage": "bit-exact"},
          "results": out, "lineage_parents": lineage})
    return out


def real_step_parents(dev):
    """Systematic-resampling parents of a real step's weights: a tracker
    at the slice's configuration tracks five frames, then the next
    frame's transition and sensor call give the weights the step would
    resample (the uniform comes from the seed)."""
    tracker, source, traj = make_slice(dev, 6)
    frames = iter(source)
    tracker.initialize(traj(0))
    for _ in range(5):
        tracker.track(next(frames).depth)
    bel = tracker.belief
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    states = bel.states.clone()
    states[:, 0] = transition.sample_transition(
        states[:, 0], tracker._dt, tracker.trans_params, generator=gen)
    z = torch.as_tensor(next(frames).depth, device=dev)
    ll, _ = tracker.sensor(states, bel.occlusion, z, tracker._dt,
                           commit=False)
    log_w = bel.log_weights + ll
    parents = resample.systematic_indices(log_w, P, generator=gen)
    return parents, {"ess": float(resample.effective_sample_size(log_w)),
                     "kl": float(resample.kl_to_uniform(log_w))}


def lineage_results(dev, q, g):
    """``lineage_gather`` against ``lineage_gather_plain`` on the full map
    for four parent vectors, bit-exact, in bfloat16 and (systematic
    parents) float32; times for each. The kernels line takes the
    systematic parents of a real step: what the main path gives it."""
    n_pad, p_pad = q.shape
    pad = torch.arange(P, p_pad, device=dev)
    real, stats = real_step_parents(dev)
    parents = {
        "systematic": real,
        "one_parent": torch.full((P,), 4321, device=dev),
        "identity": torch.arange(P, device=dev),
        "permutation": torch.randperm(P, generator=g, device=dev),
    }
    per_case = {}
    main = None
    for name, par in parents.items():
        idx64 = torch.cat([par.long(), pad])
        idx = idx64.to(torch.int32)
        got = kernels.lineage_gather(q, idx)
        want = kernels.lineage_gather_plain(q, idx)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
              f"lineage_gather differs ({name}, bf16)")
        del got, want
        times = time_pair(lambda: kernels.lineage_gather_plain(q, idx),
                          lambda: kernels.lineage_gather(q, idx),
                          library=lambda: q.index_select(1, idx64))
        # bytes: the columns some output names are read once, the whole
        # map is written once, the indices are read once
        cols_read = int(idx.unique().numel())
        times.update(roofline(cols_read * n_pad * q.element_size()
                           + nbytes(q) + nbytes(idx)))
        # share of the kernel's column tiles whose source window fits its
        # shared-memory staging (1024 columns per tile, 2048 staged)
        tiles = idx.split(1024)
        fit = sum(int(t.max()) - int(t.min()) // 8 * 8 < 2048
                  for t in tiles) / len(tiles)
        times.update({"columns_read": cols_read, "tiles_staged": fit,
                      "bytes_whole_map": 2 * nbytes(q) + nbytes(idx)})
        per_case[name] = times
        if name == "systematic":
            main = dict(times, max_abs_err=0.0)
            q32 = q.float()
            check(torch.equal(kernels.lineage_gather(q32, idx),
                              kernels.lineage_gather_plain(q32, idx)),
                  "lineage_gather differs (systematic, f32)")
            per_case["systematic_f32_ms"] = device_ms(
                lambda: kernels.lineage_gather(q32, idx))
            del q32
    per_case["real_step"] = stats
    return main, per_case


def phase_sensor(dev):
    """The whole fused sensor on the card vs on the CPU, small scene."""
    K = np.array([[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]])
    mesh_c = tagged_l_mesh()
    res = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        cam = make_camera(K, 30, 40, device=d)
        mesh = mesh_c.to(d)
        bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0,
                                   device=d)
        op = occlusion.make_occlusion_params(device=d)
        sensor = fs.make_fused_sensor(mesh, cam, bp, op, device=d)
        occ = sensor.init_occlusion(256, 0.1)
        lls = []
        for f, depth in enumerate((0.6, 0.62, 0.58)):
            states, z = scene(torch.device("cpu"), 256, cam.to("cpu"),
                              mesh_c, depth, SEED + f)
            ll, occ = sensor(states.to(d), occ, z.to(d), 1.0 / 30.0)
            lls.append(ll.cpu())
        res[name] = (torch.stack(lls), sensor.occlusion_as_pn(occ, 256).cpu())
    rel = ((res["cuda"][0] - res["cpu"][0]).abs()
           / res["cpu"][0].abs().clamp_min(1.0))
    close = (rel <= 1e-4).float().mean().item()
    occ_err = (res["cuda"][1] - res["cpu"][1]).abs().mean().item()
    # matmuls and candidate raycasts round differently on the two
    # devices; a silhouette-edge pixel can flip for a particle, so hold
    # the share of agreeing particles, not every one
    check(close >= 0.98, f"sensor cuda vs cpu: only {close:.3f} agree")
    check(occ_err <= 1e-3, f"sensor occlusion mean err {occ_err}")
    emit({"phase": "sensor", "frames": 3, "particles": 256,
          "share_within_1e-4_rel": close, "occ_mean_abs_err": occ_err})


def slice_config():
    return cfg.ParticleTrackerConfig(
        evaluation_count=P, backend="pallas", seed=SEED,
        transition=cfg.TransitionConfig(0.1, 0.5, damping=4.0))


def make_slice(dev, frames):
    """The slice's tracker, its synthetic source and trajectory."""
    cam = default_kinect_camera(8)
    mesh = icosphere_mesh(radius=0.06, subdivisions=3)
    tracker = ParticleTracker(slice_config(), meshes=[mesh], camera=cam,
                              device=dev)

    def traj(t):
        a = 2 * np.pi * t / FRAMES
        return np.array([[0.01 * np.sin(a), 0.005 * (1 - np.cos(a)),
                          0.8 + 0.005 * np.sin(a), 1, 0, 0, 0]], np.float32)

    source = sources.SyntheticSource([mesh], tracker.camera, traj, frames,
                                     seed=SEED)
    return tracker, source, traj


def phase_slice(dev):
    tracker, source, traj = make_slice(dev, FRAMES)
    cam, mesh = tracker.camera, tracker.meshes[0]
    per_frame = []

    def on_frame(frame, poses, info):
        per_frame.append({k: w.launches for k, w in WRAPPERS.items()})

    for w in WRAPPERS.values():
        w.launches = 0
    run = node.run(tracker, source, on_frame=on_frame)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    prev = {k: 0 for k in WRAPPERS}
    for i, counts in enumerate(per_frame):
        for k in WRAPPERS:
            check(counts[k] > prev[k], f"{k} not launched on frame {i}")
        prev = counts
    check(np.all(np.isfinite(run.poses)) and run.poses.shape == (
        FRAMES, 1, 7), "bad pose output")
    rmse = run.position_rmse()
    check(rmse < RMSE_LIMIT_M, f"position RMSE {rmse} m >= {RMSE_LIMIT_M}")

    depth = source.render(torch.as_tensor(traj(FRAMES), device=dev)).cpu()
    ms = []
    for i in range(WARMUP + TIMING_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.track(depth)
        torch.cuda.synchronize()
        if i >= WARMUP:
            ms.append(1e3 * (time.perf_counter() - t0))
    med = statistics.median(ms)
    emit({"phase": "slice", "particles": P, "pixels": cam.num_pixels,
          "triangles": mesh.padded_triangles, "frames": FRAMES,
          "position_rmse_m": rmse, "launches": launches,
          "resampled_frames": run.metrics.resample_count(),
          "track_ms_median": med, "hz": 1e3 / med,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    return launches, tracker, depth


def phase_profile(tracker, depth, table_path, steps=10):
    """torch.profiler over ``steps`` track calls: device busy time per
    step, the idle share of the wall time, and the device time by kernel
    (the full table is written to ``table_path``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        tracker.track(depth)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tracker.track(depth)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side rows only: an operator's row repeats its kernels' time
    kernels_ = [e for e in events
                if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels_) / 1e3 / steps
    top = sorted(kernels_, key=dev_us, reverse=True)[:12]
    table_path.parent.mkdir(parents=True, exist_ok=True)
    table_path.write_text(events.table(sort_by="self_cuda_time_total",
                                       row_limit=80))
    emit({"phase": "profile", "steps": steps,
          "wall_ms_per_step_profiled": wall_ms,
          "device_busy_ms_per_step": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "device_kernels_per_step": sum(e.count for e in kernels_) / steps,
          "top_device_us_per_step": [
              [e.key[:80], dev_us(e) / steps] for e in top],
          "table": str(table_path)})


def write_icosphere_obj(path):
    """The slice's 1280-face icosphere as a Wavefront .obj."""
    mesh = icosphere_mesh(radius=0.06, subdivisions=3, center=False)
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}"
             for x, y, z in mesh.vertices[:mesh.num_vertices].tolist()]
    lines += [f"f {a + 1} {b + 1} {c + 1}"
              for a, b, c in mesh.faces[:mesh.num_triangles].tolist()]
    Path(path).write_text("\n".join(lines) + "\n")


def run_cli(argv):
    """``cli.main(argv)`` in-process; its standard output is echoed and
    returned as lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print("cli| " + line, flush=True)
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return lines


def tagged_json(lines, tag):
    """The JSON object of the line ``<tag>: {...}``."""
    found = [ln for ln in lines if ln.startswith(tag + ": ")]
    check(len(found) == 1, f"expected one '{tag}:' line, got {len(found)}")
    return json.loads(found[0].split(": ", 1)[1])


def phase_cli(dev):
    """record → track --auto-init --watchdog --checkpoint through the
    command line, at the slice's width (see the module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_icosphere_obj(tmp / "icosphere.obj")
        conf = {
            "tracker": "particle",
            "object": {"meshes": [str(tmp / "icosphere.obj")]},
            "camera": {"downsampling_factor": 8},
            "transition": {"linear_acceleration_sigma": 0.1,
                           "angular_acceleration_sigma": 0.5,
                           "damping": 4.0},
            "evaluation_count": P, "backend": "pallas", "seed": SEED,
        }
        (tmp / "tracker.json").write_text(json.dumps(conf))
        common = ["--config", str(tmp / "tracker.json"), "--device",
                  str(dev)]
        seq, out, met, ckpt = (str(tmp / n) for n in (
            "seq.npz", "states.jsonl", "metrics.jsonl", "belief.npz"))
        run_cli(["record", *common, "--output", seq, "--frames",
                 str(CLI_FRAMES), "--trajectory", "teleport", "--seed",
                 str(SEED)])
        data = np.load(seq)
        truth = data["poses"]                               # (T, 1, 7)
        check(data["depth"].shape == (CLI_FRAMES, 60, 80),
              f"recorded depth {data['depth'].shape}")

        for w in WRAPPERS.values():
            w.launches = 0
        t0 = time.perf_counter()
        lines = run_cli(["track", *common, "--input", seq, "--auto-init",
                         "--watchdog", "--checkpoint", ckpt,
                         "--checkpoint-every", "20", "--output", out,
                         "--metrics", met])
        seconds = time.perf_counter() - t0
        launches = {k: w.launches for k, w in WRAPPERS.items()}
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched by track: {launches}")

        init = tagged_json(lines, "auto-init")
        init_err = float(np.linalg.norm(
            np.asarray(init["pose"][0][:3]) - truth[0, 0, :3]))
        check(init_err < CLI_POS_LIMIT_M,
              f"auto-init is {init_err} m from the truth")
        summary = tagged_json(lines, "track")
        reinits = summary.get("watchdog_reinits", [])
        check(reinits, "the watchdog never tripped")

        records = [json.loads(ln) for ln in Path(out).read_text().splitlines()]
        check(len(records) == CLI_FRAMES, f"{len(records)} JSONL records")
        est = np.array([r["position"] for r in records])
        err = np.linalg.norm(est - truth[:, 0, :3], axis=1)
        check(np.all(np.isfinite(est)), "non-finite position in the JSONL")
        check(err[-10:].max() < CLI_POS_LIMIT_M,
              f"last 10 frames are up to {err[-10:].max()} m off")

        metrics = [json.loads(ln) for ln in Path(met).read_text().splitlines()]
        trial = [m for m in metrics if m["trial_hypotheses"]]
        after = [m["trial_hypotheses"] for m in trial
                 if m["frame"] > reinits[0]]
        check(after and min(after) >= 2,
              "no island trial of >= 2 hypotheses after the re-init")
        plain = [m["latency_s"] for m in metrics[2:]
                 if not m["trial_hypotheses"]]

        gen = torch.Generator(device=dev)
        belief = checkpoint.load_belief(ckpt, device=dev, generator=gen)
        tracker = ParticleTracker(cfg.load_config(str(tmp / "tracker.json")),
                                  device=dev)
        tracker.restore(belief)
        tracker.generator = gen
        poses, _ = tracker.track(data["depth"][-1])
        check(bool(torch.isfinite(poses).all()) and float(torch.linalg.norm(
            poses[0, :3].cpu() - torch.as_tensor(truth[-1, 0, :3])))
            < CLI_POS_LIMIT_M, "restored checkpoint does not track")

    emit({"phase": "cli", "particles": P, "frames": CLI_FRAMES,
          "track_command_seconds": seconds,
          "auto_init_seconds": init["seconds"],
          "auto_init_error_m": init_err,
          "reinit_frames": reinits,
          "reinit_seconds": summary["watchdog_reinit_seconds"],
          "trial_frames": [m["frame"] for m in trial],
          "trial_hypotheses": sorted({m["trial_hypotheses"] for m in trial}),
          "latency_ms_in_trial_median": 1e3 * statistics.median(
              m["latency_s"] for m in trial),
          "latency_ms_outside_trial_median": 1e3 * statistics.median(plain),
          "last10_max_error_m": float(err[-10:].max()),
          "position_rmse_m": summary["position_rmse_m"],
          "launches": launches})


def main():
    phase_device()
    dev = torch.device("cuda")
    phase_build()
    kres = phase_kernels(dev)
    phase_sensor(dev)
    launches, tracker, depth = phase_slice(dev)
    phase_profile(tracker, depth, PROFILE_TABLE)
    del tracker
    phase_cli(dev)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         **{k: kres[name][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for name, (src, rep) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
