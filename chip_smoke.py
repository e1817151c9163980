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
   device time per call (CUDA-graph replay; a call under 0.05 ms is
   captured 64 times in one graph and the replay divided by 64, since
   a replay alone costs 0.004-0.0075 ms) and time per call from
   Python. The fused kernel is also held to its plain version, and
   timed, on a candidate table in which no pixel shares a slab with a
   neighbour, on one in which every pixel misses, at the ladder's second
   level (2432 pixels, 1056 packed triangles) and at the full level
   (4800 pixels, 1408 triangles) on nearer scenes, in float32, and twice
   on the same inputs (the same bits). The lineage gather runs on four
   parent vectors (systematic parents of a real step's weights, one
   parent for all, the identity, a random permutation) in bfloat16 and
   once in float32, bit-exact. The row kernels run at the ladder's tight
   and second level (448 and 2,432 rows), the gather also on ``sel``
   with duplicates, out of range (clamped by both versions) and in
   float32, bit-exact. Every kernel is also timed cold: over copies of
   its inputs so many that a round touches at least twice the L2 cache,
   outputs included, with the library call on the same copies in turns
   (``library_cold_ms``); a device copy and a fill of the map are
   timed beside the lineage gather as yardsticks. Each kernel's bound
   (the least time the card could take: bytes over the memory rate,
   operations over the float32 rate) is computed from the run's inputs,
   and the one PyTorch call that computes the same function, where there
   is one, is timed beside it;
4. sensor: the fused sensor on the card against the same sensor on the
   CPU (plain kernels) on a small scene, three frames with lazy ages;
5. slice: ``ParticleTracker`` (10,000 particles, 80×60 Kinect frame,
   1280-face icosphere padded to 1408 triangles, backend "pallas")
   driven by ``runtime.node.run`` over a 60-frame synthetic trajectory;
   every frame must launch all four kernels, and the position RMSE
   must stay under 1 cm. Then the median ms per ``track`` call, and the
   device memory the slice holds and one step adds;
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
   re-init, and the per-frame latency inside and outside the trial;
8. rgf: the second estimator at the same width: ``GaussianTracker``
   (default config: 3 iterations, occlusion memory, the candidate-set
   sigma renderer, every pixel) over the slice's 60 frames through
   ``runtime.node.run``, position RMSE under 1 cm. The first 3 frames on
   the card against the same on the CPU (pose 1e-4 m / 1e-3 rad); the
   sigma renderer on the 25 sigma poses of frame 0, card against CPU
   (hit masks equal on all but 0.2 % of pixels, depths 1e-5) and, with
   the exact inside-test, against the exact raycast of every triangle
   (no invented hit, the reference pose covered, under 1 % of common
   depths off by more than 1e-4, at least 45 % of the exact hits
   covered by the candidate sets of that wide cloud; on a tracked
   frame's cloud the tracker's own renderer covers at least 80 %).
   Prints ``track`` median and p90 ms, and from ``torch.profiler`` the
   device busy ms, kernels, copies to the host and host-side waits per
   step, the idle share and the largest kernels (table in
   ``build/profile_rgf_step.txt``), the peak memory from the tracker's
   start; the same readings for the 6-iteration, ``trust_sigma=1.5``
   configuration, the two timed in turns (3, 6, 6, 3 iterations) before
   either is profiled; the one-hot product against the gather at 25
   poses and at the particle chunk; the batched step over 4 scenes;
9. rgf_cli: ``record --trajectory teleport`` then ``track --auto-init
   --watchdog --checkpoint`` with a Gaussian config: the watchdog trips
   after the jump at frame 12, the re-init races at least two
   hypotheses, the last 10 frames are within 1 cm, the checkpoint
   restores and tracks;
10. deferred: ``ParticleTracker(backend="deferred")``, 10,000 particles,
   20 frames, RMSE under 1 cm; the particle chunk the memory budget
   chose, peak memory, and 512 particles' depths against the exact
   raycast (share of (particle, pixel) pairs that differ);
11. live: the deployment path. 240 frames of the slice's trajectory are
   rendered first, into a host list, by ``OracleSource`` at the Kinect's
   native 640×480 grid (edge artifacts 0.3, whole millimetres) and
   converted by ``U16CameraAdapter`` (uint16 mm, the native 8× strided
   downsample); render and conversion are timed per frame. A
   ``ThreadedSource`` (capacity 8) replays them at 30 Hz from its
   producer thread into ``node.run`` with the slice's particle tracker
   and a socket ``TrackerService``; a client thread sends, through
   ``service.call``: status, pause (0.3 s) and resume, checkpoint,
   reset_pose to the ground truth, find_object at frame 60 (the search at
   its default budget; the ring drops the frames that arrive meanwhile)
   and shutdown at frame 225 or when the camera has 6 frames left.
   Checks: every tracked frame launched the four kernels; skipped plus
   tracked frames equal the last index; the pause held; the service
   applied every command without an error; ``reinit_frames`` holds the
   search's frame; the last 30 tracked frames within 1 cm; the
   checkpoint loads, restores and tracks. Prints ``track`` median and
   p90, frames dropped in all, in the pause and in the search, the
   search's seconds, render and conversion ms, ms from push to pose;
12. scale: the distributed filter (``dbot_ros_tpu_torch.parallel``).
   One rank under NCCL on the card: ``make_distributed_step(exchange=
   "counts")`` over the slice's 60 frames at its width (position RMSE
   under 1 cm, every kernel launched), three forced-resample frames
   against ``rbcpf_step`` with the same draws, 2 scenes × 10,000
   particles through the multi-scene step (each under 1 cm), and the
   step's median ms beside ``track``'s, timed in turns. Then two gloo
   ranks started with ``spawn`` share the card, 5,000 particles each,
   collectives staged through pinned host memory: on a frame whose
   surplus fits the counts buffers (C = 640) and on one that overflows
   to the ring, ``counts``, ``ring`` and ``neighbor`` must equal
   ``all_gather`` bit for bit in states, log weights and the map's
   particle columns (the lazy ages are compared and reported, not
   required); ms, bytes sent and staging seconds per step per mode; the
   two-width lineage gather must launch on both ranks; the dry run
   (``parallel.dryrun``) at world size 2. A rank that fails, or outlives
   its time, fails the phase. One card cannot measure scaling
   efficiency: these are mechanics.

The kernels phase also times the two row kernels cold, and the lineage
gather at two widths: the exchange's shapes for two ranks of 5,000
(a 640-column buffer out of a 5,120-column map, a map out of one buffer,
a map out of the 10,240-column concatenation of two), bit-exact. The rgf, rgf_cli
and deferred paths launch no hand-written kernel (the reference's are
plain array code too): their launch counts are printed and are zero.
The kernels line gives each kernel's launches in the slice
(``launches``), in the live phase (``live_launches``) and in the scale
phase's one-rank run (``scale_launches``), each counted from 0 just
before that path and read just after.

Each phase prints one JSON line; any failure raises (exit code != 0).
The last line is ``{"ok": true, "device": {...}}``. Imports no JAX.

``python3 chip_smoke.py --compare`` runs only what a comparison of two
commits reads: the device and build phases, the row kernels (``rows``:
the kernels phase's gather and scatter readings at both levels, without
the out-of-range gather) and the slice (``track`` median). To compare
with a parent commit, unpack it with ``git archive`` into a git-ignored
directory, copy this file over its own, and run ``--compare`` in both
trees in turns (parent, change, change, parent), one after another on
the same card.
"""

import contextlib
import dataclasses
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from dbot_ros_tpu_torch import config as cfg
from dbot_ros_tpu_torch.filters import rbcpf, rgf
from dbot_ros_tpu_torch.models import beam, occlusion, transition
from dbot_ros_tpu_torch.ops import build, deferred, kernels, raycast
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import resample
from dbot_ros_tpu_torch.parallel import comm as comm_mod
from dbot_ros_tpu_torch.parallel import dist_filter, dryrun
from dbot_ros_tpu_torch.runtime import checkpoint, cli, node, sources
from dbot_ros_tpu_torch.trackers import base
from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import se3
from dbot_ros_tpu_torch.utils.camera import (default_kinect_camera,
                                           make_camera, preprocess_depth)
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
# float32 maps: the same operations; expf/logf of the two may differ in
# the last place
OCC_F32_ATOL = 1e-6
# a CUDA-graph replay costs 0.004-0.0075 ms however small its work
# (graph_replay_floor_ms): a call that reads under SMALL_MS alone is timed
# CALLS_PER_GRAPH times in one graph and the replay divided by that count
CALLS_PER_GRAPH = 64
SMALL_MS = 0.05
# cold timings rotate over copies of a call's inputs that together, with
# the outputs, touch at least this many times the card's L2 cache a round
COLD_L2_FACTOR = 2
# lineage_gather.cu's tiling (kThreads * kVpt vectors of 16 bytes per
# column tile, 512-byte chunks, at most 256 of them, a 96 KB ring)
LINEAGE_TILE_VECS, LINEAGE_CHUNK = 480 * 3, 512
LINEAGE_MAX_CHUNKS, LINEAGE_RING = 256, 96 * 1024
BUILD_DIR = Path(__file__).resolve().parent / "build"
PROFILE_TABLE = BUILD_DIR / "profile_step.txt"
RGF_PROFILE_TABLE = BUILD_DIR / "profile_rgf_step.txt"
RGF6_PROFILE_TABLE = BUILD_DIR / "profile_rgf6_step.txt"
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
# Gaussian tracker on the card against the CPU, first frames
RGF_POS_ATOL_M, RGF_ROT_ATOL_RAD = 1e-4, 1e-3
# two renders of the same poses: share of pixels whose hit/miss may
# differ, depth tolerance on the rest
RENDER_FLIP_SHARE, RENDER_DEPTH_ATOL = 0.002, 1e-5
# least share of the exact raycast's hits that the sigma renderer's
# candidate sets cover on this scene: on frame 0's cloud (7.8 cm wide)
# with the exact inside-test, and on a tracked frame's (8 mm) with the
# tracker's own renderer (0.525 and 0.88 when these were set)
COVERAGE_FRAME0, COVERAGE_STEADY = 0.45, 0.80
DEFERRED_FRAMES = 20
BATCHED_SCENES = 4
# the live phase: a 30 Hz camera at 640×480 (8 s), a ring of 8 frames
LIVE_FRAMES = 240
LIVE_RATE_HZ = 30
LIVE_CAPACITY = 8
LIVE_PAUSE_S = 0.3
LIVE_FIND_FRAME = 60
LIVE_SHUTDOWN_FRAME = 225
LIVE_SHUTDOWN_MARGIN = 6
LIVE_LAST_FRAMES = 30
LIVE_CLIENT_TIMEOUT_S = 120.0
# how often the operator's client asks for the status while it waits
LIVE_POLL_S = 0.05
# the scale phase: one rank under NCCL, then two gloo ranks on the card
SCALE_BACKEND = "nccl"
SCALE_SCENES = 2
SCALE_SCENE_FRAMES = 30
SCALE_RANKS = 2
SCALE_GROUP_TIMEOUT_S = 120.0
SCALE_RANK_TIMEOUT_S = 300.0
SCALE_WARMUP, SCALE_STEPS = 2, 5
# one-rank step against rbcpf_step: occlusion of the particles that kept
# their parent within one bf16 step (a moved parent shifts the cloud's
# mean, and with it, rarely, a candidate pixel)
SCALE_OCC_ATOL = 4e-3

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


def device_reading(fn, warmup=WARMUP, replays=GRAPH_REPLAYS,
                   runs=TIMING_RUNS, calls=None):
    """(ms, calls): the median device time of one call of ``fn`` from
    CUDA-graph replays between CUDA events (the host's launch cost is not
    counted), and how many calls one graph held. A replay costs
    0.004-0.0075 ms however small its work, so a call that reads under
    ``SMALL_MS`` alone is captured ``CALLS_PER_GRAPH`` times into one
    graph and the replay's time divided by that count; ``calls`` fixes
    the count instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)

    def graph_of(n):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        return graph

    graph = graph_of(calls or 1)
    if calls is None:
        probe = statistics.median(_events_ms(graph.replay, replays)
                                  for _ in range(3))
        calls = CALLS_PER_GRAPH if probe < SMALL_MS else 1
        if calls > 1:
            del graph
            graph = graph_of(calls)
    ms = statistics.median(_events_ms(graph.replay, replays)
                           for _ in range(runs))
    return ms / calls, calls


def device_ms(fn, **kw):
    """The time of :func:`device_reading` alone."""
    return device_reading(fn, **kw)[0]


def l2_bytes():
    return torch.cuda.get_device_properties(0).L2_cache_size


def cold_copies(bytes_per_call):
    """How many copies of a call's inputs make a round that touches at
    least ``COLD_L2_FACTOR`` times the L2 cache (two at the least)."""
    return max(2, -(-COLD_L2_FACTOR * l2_bytes() // bytes_per_call))


def cold_device_ms(fns):
    """Device time of one call with what it reads and writes cold.
    ``fns`` are the same call on copies of its inputs, so many that a
    round over them touches at least twice the L2 cache
    (:func:`cold_copies`: bytes read and written per call, outputs
    included). One graph holds rounds over them, ``CALLS_PER_GRAPH``
    calls at the least; each call's output is kept to the end of its
    round, so the calls of a round write buffers of their own, and each
    call finds its inputs and its output evicted by the other copies'
    traffic since its last turn. Copies and not a flush between calls
    (a scratch write whose own time is subtracted): the copies keep the
    graph free of anything but the call. The time of a replay over the
    number of calls."""
    rounds = -(-CALLS_PER_GRAPH // len(fns))

    def run():
        for _ in range(rounds):
            outs = [fn() for fn in fns]
            del outs

    return device_ms(run, calls=1) / (rounds * len(fns))


def in_turns(named, reading):
    """``reading(x)`` for every ``x`` of the dict ``named``, in turns (its
    order, then the reverse: plain, kernel, kernel, plain for two), and
    averaged per name."""
    out = {k: [] for k in named}
    for k in list(named) + list(reversed(named)):
        out[k].append(reading(named[k]))
    return {k: statistics.mean(v) for k, v in out.items()}


def cold_pair(kernel_fns, library_fns):
    """Cold device times of the kernel and of the library call that
    computes the same function, on the same copies, in turns."""
    return in_turns({"library_cold_ms": library_fns,
                     "cold_ms": kernel_fns}, cold_device_ms)


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
    calls = {}
    for pre, fn in (("plain_", plain), ("", kernel), ("", kernel),
                    ("plain_", plain)):
        ms, calls[pre + "ms"] = device_reading(fn)
        out[pre + "ms"].append(ms)
        out[pre + "call_ms"].append(call_ms(fn))
        if library is not None:
            ms, calls["library_ms"] = device_reading(library)
            out["library_ms"].append(ms)
    res = {k: statistics.mean(v) if v else None for k, v in out.items()}
    res["calls_per_graph"] = calls
    return res


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


def fused_inputs(sensor, cam, states, z, level, g, dtype=torch.bfloat16):
    """The fused kernel's arguments as ``FusedSensor.__call__`` builds them
    at one level of its compaction ladder (``None``: the full kernel, all
    pixels and all triangles), with random ages and a random prior map.
    Returns (args, sel, info); ``info['ladder_level']`` is the level the
    sensor itself would run this scene at."""
    dev = z.device
    N = cam.num_pixels
    p_pad = fs.particle_pad(states.shape[0])
    cand = sensor.candidates(states)
    book = sensor.selection(cand)
    n_active, n_uniq = (int(v) for v in torch.stack(
        [book["n_active"], book["n_uniq"]]).tolist())
    caps = sensor.caps(N)
    ladder = next((i for i, (pc, tc) in enumerate(caps)
                   if n_active <= pc and n_uniq < tc), "full")
    sel = None
    if level is None:
        check(N % sensor.nb == 0, "the full level would pad the pixels")
        gt = sensor.pack_full(states, p_pad)
        cand_k, z_k, rays = cand, z, cam.rays
    else:
        pcap, tcap = caps[level]
        check(n_active <= pcap and n_uniq < tcap,
              f"scene does not fit level {level}: {n_active=} {n_uniq=}")
        sel, uniq = sensor.level_indices(book, pcap, tcap, N)
        gt = sensor.pack_selected(states, p_pad, uniq)
        inv = torch.clamp(book["cp"].to(torch.int64) - 1, 0, tcap - 1)
        cand_k, z_k, rays = inv[cand][sel], z[sel], cam.rays[sel]
    n = cand_k.shape[0]
    ages = torch.randint(0, 6, (n,), generator=g, device=dev).float()
    occ = torch.rand((n, p_pad), generator=g, device=dev).to(dtype)
    params = fs.make_params_vec(sensor.bp, sensor.op, 1.0, 0.25)
    args = (gt, occ, z_k.contiguous(), cand_k.to(torch.int32).contiguous(),
            rays.contiguous(), ages, params)
    return args, sel, {"n": n, "K": cand_k.shape[1], "T": gt.shape[0],
                       "n_active": n_active, "n_uniq": n_uniq,
                       "ladder_level": ladder}


def check_fused(args, what):
    """``fused_loglik`` against ``fused_loglik_plain`` on ``args`` with the
    stated tolerances, and against itself (two runs, the same bits).
    Returns the errors and the kernel's posterior map."""
    ll_k, occ_k = kernels.fused_loglik(*args)
    ll_2, occ_2 = kernels.fused_loglik(*args)
    ll_p, occ_p = kernels.fused_loglik_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(ll_2, ll_k) and torch.equal(occ_2, occ_k),
          f"fused kernel not deterministic ({what})")
    ll_k, ll_p = ll_k[:P], ll_p[:P]
    check(bool(torch.isfinite(ll_k).all()),
          f"fused loglik not finite ({what})")
    err = (ll_k - ll_p).abs()
    bound = LL_RTOL * ll_p.abs() + LL_ATOL_PER_PIXEL * args[1].shape[0]
    check(bool((err <= bound).all()),
          f"fused loglik off ({what}): max err {err.max().item()}")
    res = {"max_abs_err": err.max().item()}
    if occ_k.dtype == torch.bfloat16:
        ulps = (occ_k.view(torch.int16).int()
                - occ_p.view(torch.int16).int()).abs().max().item()
        check(ulps <= OCC_ULPS, f"fused occ' off by {ulps} bf16 ulps ({what})")
        res["occ_max_ulps"] = ulps
    else:
        occ_err = (occ_k - occ_p).abs().max().item()
        check(occ_err <= OCC_F32_ATOL, f"fused occ' off by {occ_err} ({what})")
        res["occ_max_abs_err"] = occ_err
    return res, occ_k


def fused_bound(args):
    """bytes: only the slabs some pixel's candidate names have to be read
    (each once), the map rows in and out, the per-pixel inputs, loglik"""
    gt, occ, cand = args[0], args[1], args[3]
    n, p_pad = occ.shape
    slabs_read = int(cand.unique().numel())
    out = roofline(
        slabs_read * gt[0].numel() * 4 + 2 * nbytes(occ)
        + nbytes(*args[2:]) + 4 * p_pad,
        n * p_pad * (FUSED_FLOPS_PER_CANDIDATE * cand.shape[1]
                     + FUSED_FLOPS_PER_PIXEL))
    out["slabs_read"] = slabs_read
    out["bytes_all_slabs"] = nbytes(gt) + 2 * nbytes(occ)
    return out


def fused_other_shapes(dev, sensor, cam, mesh, tight_args, g):
    """The fused kernel where the slice's frames do not take it: a
    candidate table in which no pixel shares a slab with a neighbour (at
    the tight level's shapes), float32 maps, and the ladder's second and
    full levels on nearer scenes. Each is held to the plain version;
    the kernel is timed as in the main comparison, the plain version with
    a few replays only (it takes tens of ms at the full level)."""
    out = {}
    n, K = tight_args[3].shape
    T = tight_args[0].shape[0]
    scattered = ((torch.arange(n, device=dev)[:, None] * K
                  + torch.arange(K, device=dev)) % (T - 1)).to(torch.int32)
    cases = {
        "tight_no_shared_slab": tight_args[:3] + (scattered,)
        + tight_args[4:],
        # no row on the silhouette: what the kernel costs before any beam
        "tight_degenerate_only": tight_args[:3]
        + (torch.full_like(scattered, T - 1),) + tight_args[4:],
        "tight_f32": (tight_args[0], tight_args[1].float()) + tight_args[2:],
    }
    infos = {}
    for name, level, depth in (("second_level", 1, 0.25),
                               ("full_level", None, 0.13)):
        states, z = scene(dev, P, cam, mesh, depth, SEED + 1)
        cases[name], _, infos[name] = fused_inputs(sensor, cam, states, z,
                                                   level, g)
    check(infos["second_level"]["n"] == 2432
          and infos["second_level"]["T"] == 1056
          and infos["full_level"]["n"] == 4800
          and infos["full_level"]["T"] == 1408,
          f"unexpected level shapes {infos}")
    for name, args in cases.items():
        res, _ = check_fused(args, name)
        res["ms"] = device_ms(lambda: kernels.fused_loglik(*args))
        res["plain_ms"] = device_ms(
            lambda: kernels.fused_loglik_plain(*args), warmup=1, replays=2,
            runs=3)
        res.update(fused_bound(args))
        res.update(infos.get(name, {}))
        out[name] = res
    return out


def phase_kernels(dev):
    cam = default_kinect_camera(8, device=dev)
    mesh = icosphere_mesh(radius=0.06, subdivisions=3, device=dev)
    bp = beam.make_beam_params(device=dev)
    op = occlusion.make_occlusion_params(device=dev)
    sensor = fs.make_fused_sensor(mesh, cam, bp, op, device=dev)
    states, z = scene(dev, P, cam, mesh, 0.8, SEED)
    N = cam.num_pixels
    p_pad = fs.particle_pad(P)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    args, sel, info = fused_inputs(sensor, cam, states, z, 0, g)
    shapes = {"n": info["n"], "K": info["K"], "T": info["T"], "P": P,
              "p_pad": p_pad}
    check(shapes["n"] == 448 and shapes["T"] == 288,
          f"unexpected slice shapes {shapes}")
    fused, occ_k = check_fused(args, "tight level")
    out = {"fused_loglik": fused}
    fused.update(time_pair(
        lambda: kernels.fused_loglik_plain(*args),
        lambda: kernels.fused_loglik(*args)))
    fused.update(fused_bound(args))
    # cold: copies of the inputs (slabs named + map rows: ~47 MB a call)
    copies = [args] + [tuple(a.clone() for a in args)
                       for _ in range(cold_copies(fused["bytes"]) - 1)]
    fused["cold_ms"] = cold_device_ms(
        [lambda c=c: kernels.fused_loglik(*c) for c in copies])
    fused["cold_copies"] = len(copies)
    del copies
    fused_more = fused_other_shapes(dev, sensor, cam, mesh, args, g)

    n_pad = fs._round_up(N, sensor.nb)
    q = torch.rand((n_pad, p_pad), generator=g,
                   device=dev).to(torch.bfloat16)
    rows = row_results(dev, sensor, cam, mesh, q, g, sel_tight=sel)
    for name, levels in rows.items():
        out[name] = dict(levels["tight"], second_level=levels["second"])

    out["lineage_gather"], lineage, real = lineage_results(dev, q, g)
    out["lineage_gather"]["two_widths"] = lineage_two_widths(dev, real, g)
    # what one graph replay costs for a kernel that does next to nothing,
    # and what such a kernel costs a call among CALLS_PER_GRAPH in a graph
    tiny = torch.zeros((1024,), device=dev)
    replay_floor = device_ms(lambda: tiny.add_(1.0), calls=1)
    floor_in_graph = device_ms(lambda: tiny.add_(1.0),
                               calls=CALLS_PER_GRAPH)
    emit({"phase": "kernels", "shapes": shapes,
          "graph_replay_floor_ms": replay_floor,
          "tiny_kernel_ms_in_graph": floor_in_graph,
          "calls_per_graph": CALLS_PER_GRAPH, "small_ms": SMALL_MS,
          "l2_bytes": l2_bytes(), "cold_l2_factor": COLD_L2_FACTOR,
          "n_active": info["n_active"], "n_uniq": info["n_uniq"],
          "tolerance": {
              "loglik": f"|d| <= {LL_RTOL}*|ll| + {LL_ATOL_PER_PIXEL}*n",
              "occ": f"<= {OCC_ULPS} bf16 ulp, {OCC_F32_ATOL} in float32",
              "fused_twice": "bit-identical",
              "rows": "bit-exact; the gather also on sel with duplicates "
                      "and out of range (clamped), and in float32",
              "lineage": "bit-exact", "lineage_two_widths": "bit-exact"},
          "results": out, "fused_other_shapes": fused_more,
          "lineage_parents": lineage})
    return out


def ladder_sel(sensor, cam, mesh, dev, depth, level, seed):
    """The pixels one level of the compaction ladder selects on a scene at
    ``depth`` (what the sensor hands the row kernels), int32."""
    states, _ = scene(dev, P, cam, mesh, depth, seed)
    book = sensor.selection(sensor.candidates(states))
    pcap, tcap = sensor.caps(cam.num_pixels)[level]
    sel, _ = sensor.level_indices(book, pcap, tcap, cam.num_pixels)
    return sel.to(torch.int32).contiguous()


def hostile_sel(sel, n_rows):
    """``sel`` with every seventh entry out of range, both ways."""
    bad = sel.clone()
    wild = torch.tensor([-1, n_rows, n_rows + 1000, 2**31 - 1, -2**31],
                        dtype=torch.int32, device=sel.device)
    k = bad[::7].numel()
    bad[::7] = wild.repeat(-(-k // wild.numel()))[:k]
    return bad


def row_results(dev, sensor, cam, mesh, q, g, sel_tight=None,
                hostile=True):
    """``gather_pixel_rows`` and ``scatter_pixel_rows`` at the ladder's
    tight and second level (448 and 2,432 selected pixels of the map
    ``q``): bit-exact against the plain versions; device times warm
    (:func:`time_pair`, ``index_select`` / ``index_copy_`` beside) and
    cold (over copies of the map, in turns with the library call); the
    bound. The gather's bulk-copy engine (not on the path) and a device
    copy of as many contiguous rows are timed beside it, warm and cold.
    The gather is also held to its plain version on ``sel`` with
    duplicates,
    in float32 and, with ``hostile``, on ``sel`` out of range (both
    clamp; a gather that does not would read outside the map)."""
    row_bytes = q.shape[1] * q.element_size()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bulk_plan = getattr(kernels, "bulk_rows_plan", None)
    res = {"gather_pixel_rows": {}, "scatter_pixel_rows": {}}
    for level, depth, seed, want in (("tight", 0.8, SEED, 448),
                                     ("second", 0.25, SEED + 1, 2432)):
        sel = ladder_sel(sensor, cam, mesh, dev, depth,
                         0 if level == "tight" else 1, seed)
        if level == "tight" and sel_tight is not None:
            check(torch.equal(sel, sel_tight.to(torch.int32)),
                  "tight level selects other pixels than the fused inputs")
        check(sel.numel() == want and sel.unique().numel() == want,
              f"{level} level: {sel.numel()} rows, expected {want} distinct")
        sel64 = sel.long()
        got = kernels.gather_pixel_rows(q, sel)
        check(torch.equal(got, kernels.gather_pixel_rows_plain(q, sel)),
              f"gather_pixel_rows differs ({level})")
        dup = sel.clone()
        dup[1::2] = sel[0::2][:dup[1::2].numel()]
        cases = {"duplicates": (q, dup), "float32": (q.float(), sel)}
        if hostile:
            bad = hostile_sel(sel, q.shape[0])
            cases["out_of_range"] = (q, bad)
            cases["float32_out_of_range"] = (cases["float32"][0], bad)
        for name, (m, s_) in cases.items():
            check(torch.equal(kernels.gather_pixel_rows(m, s_),
                              kernels.gather_pixel_rows_plain(m, s_)),
                  f"gather_pixel_rows differs ({level}, {name})")
        del cases
        per_call = 2 * nbytes(got) + nbytes(sel)
        maps = [q.clone() for _ in range(cold_copies(per_call))]
        gather = {"rows": want, "max_abs_err": 0.0,
                  "checked": ["real sel", "duplicates", "float32"]
                  + (["out_of_range", "float32_out_of_range"]
                     if hostile else [])}
        gather.update(time_pair(
            lambda: kernels.gather_pixel_rows_plain(q, sel),
            lambda: kernels.gather_pixel_rows(q, sel),
            library=lambda: q.index_select(0, sel64)))
        gather.update(roofline(per_call))
        # cold, in turns: the kernel, index_select, the bulk-copy engine
        # (this slice's attempt, not on the path), and a device copy of as
        # many contiguous rows (the yardstick: the same bytes with no
        # index to follow)
        warm = {"copy_ms": lambda: q[:want].clone()}
        cold = {"cold_ms": [lambda m=m: kernels.gather_pixel_rows(m, sel)
                            for m in maps],
                "library_cold_ms": [lambda m=m: m.index_select(0, sel64)
                                    for m in maps],
                "copy_cold_ms": [lambda m=m: m[:want].clone()
                                 for m in maps]}
        if bulk_plan is not None:
            bulk = bulk_plan(want, row_bytes, sms)
            check(torch.equal(kernels._gather_rows_launch(q, sel, bulk),
                              got), f"gather_pixel_rows' bulk engine "
                                    f"differs ({level})")
            gather.update(
                plan=kernels.gather_rows_plan(want, row_bytes)._asdict(),
                bulk_plan=bulk._asdict())
            warm["bulk_engine_ms"] = (
                lambda: kernels._gather_rows_launch(q, sel, bulk))
            cold["bulk_engine_cold_ms"] = [
                lambda m=m: kernels._gather_rows_launch(m, sel, bulk)
                for m in maps]
        gather.update(in_turns(warm, device_ms))
        gather.update(in_turns(cold, cold_device_ms))
        gather["cold_copies"] = len(maps)
        res["gather_pixel_rows"][level] = gather

        vals = torch.rand(got.shape, generator=g, device=dev).to(q.dtype)
        q_k, q_p = q.clone(), q.clone()
        kernels.scatter_pixel_rows(q_k, vals, sel)
        kernels.scatter_pixel_rows_plain(q_p, vals, sel)
        check(torch.equal(q_k, q_p), f"scatter_pixel_rows differs ({level})")
        scatter = {"rows": want, "max_abs_err": 0.0}
        scatter.update(time_pair(
            lambda: kernels.scatter_pixel_rows_plain(q_p, vals, sel),
            lambda: kernels.scatter_pixel_rows(q_k, vals, sel),
            library=lambda: q_p.index_copy_(0, sel64, vals)))
        scatter.update(roofline(2 * nbytes(vals) + nbytes(sel)))
        rows = [vals.clone() for _ in maps]
        scatter.update(cold_pair(
            [lambda m=m, r=r: kernels.scatter_pixel_rows(m, r, sel)
             for m, r in zip(maps, rows)],
            [lambda m=m, r=r: m.index_copy_(0, sel64, r)
             for m, r in zip(maps, rows)]))
        scatter["cold_copies"] = len(maps)
        res["scatter_pixel_rows"][level] = scatter
        del q_k, q_p, maps, rows
    return res


def phase_rows(dev):
    """The row kernels alone (``--compare``), on the kernels phase's map
    and ladder levels, without the out-of-range gather: the same
    comparison runs in a commit whose gather does not clamp."""
    cam = default_kinect_camera(8, device=dev)
    mesh = icosphere_mesh(radius=0.06, subdivisions=3, device=dev)
    sensor = fs.make_fused_sensor(
        mesh, cam, beam.make_beam_params(device=dev),
        occlusion.make_occlusion_params(device=dev), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    q = torch.rand((fs._round_up(cam.num_pixels, sensor.nb),
                    fs.particle_pad(P)), generator=g,
                   device=dev).to(torch.bfloat16)
    emit({"phase": "rows", "calls_per_graph": CALLS_PER_GRAPH,
          "l2_bytes": l2_bytes(),
          "results": row_results(dev, sensor, cam, mesh, q, g,
                                 hostile=False)})


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


def lineage_read_plan(idx, elem):
    """What ``lineage_gather.cu`` reads of every row for this ``idx``: per
    column tile, the 512-byte chunks of the window that some index names
    (a tile it cannot stage reads one 32-byte sector per element). The
    host-side mirror of the kernel's plan, for the record only."""
    vec = 16 // elem
    p_pad = idx.shape[0]
    n_vecs = p_pad // vec
    col_tiles = -(-n_vecs // LINEAGE_TILE_VECS)
    per_tile = -(-n_vecs // col_tiles)
    src = idx.clamp(0, p_pad - 1).cpu().numpy().astype(np.int64)
    staged, row_bytes = 0, 0
    for t in range(col_tiles):
        part = src[t * per_tile * vec:min((t + 1) * per_tile, n_vecs) * vec]
        lo_a = part.min() // vec * vec
        chunks = np.unique((part - lo_a) * elem // LINEAGE_CHUNK)
        need = int(sum(min(LINEAGE_CHUNK,
                           (p_pad - lo_a) * elem - c * LINEAGE_CHUNK)
                       for c in chunks))
        fits = (chunks.max() < LINEAGE_MAX_CHUNKS
                and LINEAGE_RING // need >= 2)
        staged += fits
        row_bytes += need if fits else 32 * len(part)
    return {"column_tiles": col_tiles, "tiles_staged": staged / col_tiles,
            "row_bytes_read": row_bytes, "row_bytes": p_pad * elem}


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
        times.update(lineage_read_plan(idx, q.element_size()))
        if name == "identity":
            # yardsticks for the same bytes: a device copy of the map (read
            # and write 97 MB each) and a fill (write only)
            spare = torch.empty_like(q)
            times["copy_ms"] = device_ms(lambda: spare.copy_(q))
            times["fill_ms"] = device_ms(lambda: spare.zero_())
            del spare
        times["bytes_whole_map"] = 2 * nbytes(q) + nbytes(idx)
        times["columns_read"] = cols_read
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
            # cold: maps in turn (a call moves 97 MB out and nearly all of
            # its 97 MB in, more than the L2 holds, so this should equal
            # the above), index_select on the same maps in turns
            maps = [q] + [q.clone()
                          for _ in range(cold_copies(times["bytes"]) - 1)]
            cold = cold_pair(
                [lambda m=m: kernels.lineage_gather(m, idx) for m in maps],
                [lambda m=m: m.index_select(1, idx64) for m in maps])
            times.update(cold, cold_copies=len(maps))
            main.update(cold)
            # the yardstick under the same conditions: a device copy of
            # each map into a new buffer
            times["copy_cold_ms"] = cold_device_ms(
                [lambda m=m: m.clone() for m in maps])
            del maps
    per_case["real_step"] = stats
    return main, per_case, real


def lineage_two_widths(dev, parents, g):
    """The lineage gather with a source and an output of different widths,
    at the exchange's shapes for two ranks of L = 5,000 (a real step's
    parents split in two): the C = 640 columns rank 0 ships to rank 1 out
    of its 5,120-column map (counts), rank 1's 5,120 columns out of one
    received 640-column buffer, and out of the 10,240-column concatenation
    of both maps (all_gather); the first two again with a full buffer.
    Bit-exact against the plain version; times, bound and
    ``index_select`` as for the equal widths."""
    L = P // 2
    p_l = fs.particle_pad(L)
    C = dist_filter.counts_capacity(L)
    n_rows = fs._round_up(default_kinect_camera(8).num_pixels, 64)
    par = parents[L:].long()
    owner = torch.div(par, L, rounding_mode="floor")
    chg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                     par[1:] != par[:-1]])
    shipped = par[(owner == 0) & chg][:C]
    rows = torch.zeros(C, dtype=torch.long, device=dev)
    rows[:shipped.shape[0]] = shipped
    mask = owner == 0
    slot = torch.cumsum((mask & chg).long(), 0) - 1
    pad = torch.arange(L, p_l, device=dev)
    cidx = torch.cat([torch.where(mask, slot, 0), pad.clamp(max=C - 1)])
    gidx = torch.cat([owner * p_l + (par - owner * L),
                      pad.clamp(max=2 * p_l - 1)])
    # the same shapes with every buffer column distinct: a frame whose
    # surplus fills the buffer (sorted rows spread over the map, every
    # slot of the buffer named by runs of offspring)
    full_rows = torch.sort(torch.randperm(L, generator=g, device=dev)[:C])[0]
    full_slots = torch.sort(torch.randint(0, C, (L,), generator=g,
                                          device=dev))[0]
    full_slots[:C] = torch.arange(C, device=dev)
    full_slots = torch.sort(full_slots)[0]
    cases = {"buffer": (p_l, rows), "receive": (C, cidx),
             "concat": (2 * p_l, gidx), "buffer_full": (p_l, full_rows),
             "receive_full": (C, torch.cat([full_slots,
                                            pad.clamp(max=C - 1)]))}
    out = {}
    for name, (p_in, idx64) in cases.items():
        src = torch.rand((n_rows, p_in), generator=g,
                         device=dev).to(torch.bfloat16)
        idx = idx64.to(torch.int32)
        got = kernels.lineage_gather(src, idx)
        want = kernels.lineage_gather_plain(src, idx)
        torch.cuda.synchronize()
        check(got.shape == (n_rows, idx.shape[0])
              and torch.equal(got.view(torch.int16), want.view(torch.int16)),
              f"lineage_gather differs at two widths ({name})")
        lib_idx = idx64.clamp(0, p_in - 1)
        times = time_pair(lambda: kernels.lineage_gather_plain(src, idx),
                          lambda: kernels.lineage_gather(src, idx),
                          library=lambda: src.index_select(1, lib_idx))
        cols_read = int(lib_idx.unique().numel())
        times.update(roofline(cols_read * n_rows * src.element_size()
                              + nbytes(got) + nbytes(idx)))
        srcs = [src] + [src.clone()
                        for _ in range(cold_copies(times["bytes"]) - 1)]
        times.update(cold_pair(
            [lambda m=m: kernels.lineage_gather(m, idx) for m in srcs],
            [lambda m=m: m.index_select(1, lib_idx) for m in srcs]))
        times["cold_copies"] = len(srcs)
        del srcs
        times.update({"p_in": p_in, "p_out": idx.shape[0], "rows": n_rows,
                      "columns_read": cols_read, "max_abs_err": 0.0})
        out[name] = times
    out["rows_shipped"] = int(shipped.shape[0])
    out["offspring_from_rank0"] = int(mask.sum())
    return out


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


def slice_scene():
    """The slice's camera, mesh and trajectory (host-side)."""
    cam = default_kinect_camera(8)
    mesh = icosphere_mesh(radius=0.06, subdivisions=3)

    def traj(t):
        a = 2 * np.pi * t / FRAMES
        return np.array([[0.01 * np.sin(a), 0.005 * (1 - np.cos(a)),
                          0.8 + 0.005 * np.sin(a), 1, 0, 0, 0]], np.float32)

    return cam, mesh, traj


def make_slice(dev, frames):
    """The slice's tracker, its synthetic source and trajectory."""
    cam, mesh, traj = slice_scene()
    tracker = ParticleTracker(slice_config(), meshes=[mesh], camera=cam,
                              device=dev)
    source = sources.SyntheticSource([mesh], tracker.camera, traj, frames,
                                     seed=SEED)
    return tracker, source, traj


def phase_slice(dev):
    # device memory: the peak is counted from here on (the kernels phase
    # before it holds float32 maps and plain versions' intermediates)
    torch.cuda.synchronize()
    peak_earlier = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
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
    peak = torch.cuda.max_memory_allocated()
    # one more step on its own: what it allocates above what is held
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tracker.track(depth)
    torch.cuda.synchronize()
    step_extra = torch.cuda.max_memory_allocated() - held
    emit({"phase": "slice", "particles": P, "pixels": cam.num_pixels,
          "triangles": mesh.padded_triangles, "frames": FRAMES,
          "position_rmse_m": rmse, "launches": launches,
          "resampled_frames": run.metrics.resample_count(),
          "track_ms_median": med, "hz": 1e3 / med,
          "peak_mem_bytes": peak,
          "peak_mem_bytes_earlier_phases": peak_earlier,
          "held_mem_bytes": held, "step_extra_mem_bytes": step_extra,
          "occlusion_map_bytes": nbytes(tracker.belief.occlusion[0])})
    return launches, tracker, depth


def profile_steps(tracker, depth, table_path, steps=10):
    """torch.profiler over ``steps`` track calls: device busy time per
    step, the idle share of the wall time, the device time by kernel (the
    full table is written to ``table_path``), and what makes the host
    wait for the card: copies to the host (a value read back) and
    stream or device synchronisations (the final one not counted)."""
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

    def count(*parts):
        return sum(e.count for e in events
                   if any(part in e.key for part in parts)) / steps

    # device-side rows only: an operator's row repeats its kernels' time
    kernels_ = [e for e in events
                if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels_) / 1e3 / steps
    top = sorted(kernels_, key=dev_us, reverse=True)[:12]
    table_path.parent.mkdir(parents=True, exist_ok=True)
    table_path.write_text(events.table(sort_by="self_cuda_time_total",
                                       row_limit=80))
    host_ops = [e for e in events
                if getattr(e, "device_type", None) == DeviceType.CPU
                and e.key.startswith("aten::")]
    return {"steps": steps,
            "wall_ms_per_step_profiled": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_kernels_per_step": sum(e.count for e in kernels_) / steps,
            "host_ops_per_step": sum(e.count for e in host_ops) / steps,
            "host_reads_per_step": count("Memcpy DtoH"),
            "copies_from_host_per_step": count("Memcpy HtoD"),
            "host_waits_per_step": count("cudaStreamSynchronize",
                                         "cudaDeviceSynchronize",
                                         "cudaEventSynchronize")
            - 1.0 / steps,
            "top_device_us_per_step": [
                [e.key[:80], dev_us(e) / steps] for e in top],
            "table": str(table_path)}


def phase_profile(tracker, depth, table_path):
    emit({"phase": "profile", **profile_steps(tracker, depth, table_path)})


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


def phase_cli(dev, kind="particle"):
    """record → track --auto-init --watchdog --checkpoint through the
    command line, at the slice's width (see the module docstring), with a
    particle-tracker config (phase ``cli``) or a Gaussian one
    (``rgf_cli``)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_icosphere_obj(tmp / "icosphere.obj")
        conf = {
            "tracker": kind,
            "object": {"meshes": [str(tmp / "icosphere.obj")]},
            "camera": {"downsampling_factor": 8},
            "transition": {"linear_acceleration_sigma": 0.1,
                           "angular_acceleration_sigma": 0.5,
                           "damping": 4.0},
            "seed": SEED,
        }
        if kind == "particle":
            conf.update(evaluation_count=P, backend="pallas")
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
        # the Gaussian path has no hand-written kernel to launch
        check(all(v > 0 for v in launches.values()) or kind == "gaussian",
              f"a kernel was not launched by track: {launches}")

        init = tagged_json(lines, "auto-init")
        init_err = float(np.linalg.norm(
            np.asarray(init["pose"][0][:3]) - truth[0, 0, :3]))
        check(init_err < CLI_POS_LIMIT_M,
              f"auto-init is {init_err} m from the truth")
        summary = tagged_json(lines, "track")
        reinits = summary.get("watchdog_reinits", [])
        check(reinits and reinits[0] > 12,
              f"the watchdog did not trip after the jump: {reinits}")

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
              "no trial of >= 2 hypotheses after the re-init")
        plain = [m["latency_s"] for m in metrics[2:]
                 if not m["trial_hypotheses"]]

        gen = torch.Generator(device=dev)
        belief = checkpoint.load_belief(ckpt, device=dev, generator=gen)
        loaded = cfg.load_config(str(tmp / "tracker.json"))
        if kind == "particle":
            tracker = ParticleTracker(loaded, device=dev)
            tracker.generator = gen
        else:
            tracker = GaussianTracker(loaded, device=dev)
        tracker.restore(belief)
        poses, _ = tracker.track(data["depth"][-1])
        poses = poses.reshape(-1, 7)
        check(bool(torch.isfinite(poses).all()) and float(torch.linalg.norm(
            poses[0, :3].cpu() - torch.as_tensor(truth[-1, 0, :3])))
            < CLI_POS_LIMIT_M, "restored checkpoint does not track")

    emit({"phase": "cli" if kind == "particle" else "rgf_cli",
          "tracker": kind, "particles": P if kind == "particle" else None,
          "frames": CLI_FRAMES,
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


def rgf_config(**overrides):
    """The Gaussian tracker's default configuration (3 iterations,
    occlusion memory, candidate-set sigma renderer, every pixel) with the
    slice's transition."""
    return cfg.GaussianTrackerConfig(
        seed=SEED, transition=cfg.TransitionConfig(0.1, 0.5, damping=4.0),
        **overrides)


def track_ms(tracker, depth, runs=TIMING_RUNS):
    """Synchronised ms of ``runs`` track calls after warm-up."""
    ms = []
    for i in range(WARMUP + runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.track(depth)
        torch.cuda.synchronize()
        if i >= WARMUP:
            ms.append(1e3 * (time.perf_counter() - t0))
    ms.sort()
    return {"track_ms_median": statistics.median(ms),
            "track_ms_p90": ms[int(0.9 * (len(ms) - 1))],
            "track_ms_min": ms[0], "track_ms_max": ms[-1]}


def compare_renders(got, want, what):
    """Two renders of the same poses by the same route: hit masks equal
    on all but RENDER_FLIP_SHARE of the pixels, depths equal on the rest."""
    got, want = got.cpu(), want.cpu()
    flips = (torch.isfinite(got) != torch.isfinite(want)).float().mean()
    both = torch.isfinite(got) & torch.isfinite(want)
    err = (got[both] - want[both]).abs().max().item()
    check(float(flips) <= RENDER_FLIP_SHARE,
          f"{what}: {float(flips):.4f} of the pixels flip")
    check(err <= RENDER_DEPTH_ATOL, f"{what}: depths differ by {err}")
    return {"flip_share": float(flips), "max_abs_err": err,
            "hits": int(both.sum())}


def rgf_against_cpu(dev, cam, mesh, traj):
    """The first three frames on the card against the same on the CPU,
    and the sigma renderer on frame 0's first 25 sigma poses: card
    against CPU, and (exact inside-test) against the exact raycast."""
    frames = list(sources.SyntheticSource([mesh], cam, traj, 3, seed=SEED))
    trackers = {d: GaussianTracker(rgf_config(), meshes=[mesh], camera=cam,
                                   device=d) for d in ("cpu", dev)}
    seen = []
    card = trackers[dev]
    render = card.render_fn
    card.render_fn = lambda poses: (seen.append(poses), render(poses))[1]
    pos_err = rot_err = 0.0
    for t_ in trackers.values():
        t_.initialize(traj(0), first_frame=frames[0].depth)
    for frame in frames:
        pc, _ = trackers["cpu"].track(frame.depth)
        pg, _ = card.track(frame.depth)
        pg = pg.cpu()
        pos_err = max(pos_err, float(torch.linalg.norm(pg[:3] - pc[:3])))
        rot_err = max(rot_err, float(torch.linalg.norm(
            se3.quat_boxminus(pg[3:7], pc[3:7]))))
    check(pos_err <= RGF_POS_ATOL_M and rot_err <= RGF_ROT_ATOL_RAD,
          f"card vs cpu: {pos_err} m, {rot_err} rad")
    poses = seen[0]
    check(poses.shape == (25, 7), f"sigma poses {tuple(poses.shape)}")
    out = {"frames": 3, "max_pos_err_m": pos_err, "max_rot_err_rad": rot_err,
           "sigma_renderer_card_vs_cpu": compare_renders(
               render(poses), trackers["cpu"].render_fn(poses.cpu()),
               "sigma renderer card vs cpu")}
    # against the exact raycast, with the reference's own bounds
    c, m = card.camera, card.meshes[0]
    conf = card.config
    tight = deferred.make_sigma_renderer(
        [m], c.rays, c.height, c.width, radius=conf.sigma_radius,
        num_candidates=conf.sigma_candidates, bary_slack=0.0)
    d_def, d_ex = tight(poses), raycast.raycast_depth(m, poses, c.rays)
    hit_def, hit_ex = torch.isfinite(d_def), torch.isfinite(d_ex)
    both = hit_def & hit_ex
    diff = d_def[both] - d_ex[both]
    off = int((diff.abs() > 1e-4).sum())
    invented = int((hit_def & ~hit_ex).sum())
    missed = int((hit_ex & ~hit_def).sum())
    check(invented == 0, f"{invented} hits the exact render lacks")
    check(off <= 0.01 * int(both.sum()) and float(diff.min()) > -1e-4,
          f"{off} common depths off, nearest {float(diff.min())}")
    check(not bool((hit_ex[0] & ~hit_def[0]).any()),
          "the reference pose itself is not covered")
    # This icosphere's faces are smaller than a pixel, and a face that
    # covers no pixel centre at the reference pose is in no candidate set
    # (the candidate pass's limit, and the reference's too: its renderer
    # gives these hit masks, tests/test_torch_deferred.py), so the
    # coverage is held from below, under what this wide cloud gives.
    coverage = 1.0 - missed / max(int(hit_ex.sum()), 1)
    check(coverage >= COVERAGE_FRAME0,
          f"{missed} of {int(hit_ex.sum())} exact hits missed on frame 0")
    out["sigma_renderer_vs_exact"] = {
        "exact_hits": int(hit_ex.sum()), "missed": missed,
        "coverage_share": coverage,
        "invented": invented, "depths_off_1e-4": off,
        "cloud_spread_m": float(torch.linalg.norm(
            poses[:, :3] - poses[0, :3], dim=1).max())}
    return out


def steady_coverage(tracker, depth):
    """The share of the exact raycast's hits that the tracker's own sigma
    renderer covers on the first sigma cloud of one more tracked frame."""
    seen = []
    render = tracker.render_fn
    tracker.render_fn = lambda poses: (seen.append(poses), render(poses))[1]
    tracker.track(depth)
    tracker.render_fn = render
    poses = seen[0]
    m, c = tracker.meshes[0], tracker.camera
    hit = torch.isfinite(render(poses))
    hit_ex = torch.isfinite(raycast.raycast_depth(m, poses, c.rays))
    coverage = float((hit & hit_ex).sum()) / float(hit_ex.sum())
    check(coverage >= COVERAGE_STEADY,
          f"the sigma renderer covers {coverage} of the exact hits")
    return {"coverage_share": coverage, "exact_hits": int(hit_ex.sum()),
            "hits_the_exact_render_lacks": int((hit & ~hit_ex).sum()),
            "cloud_spread_m": float(torch.linalg.norm(
                poses[:, :3] - poses[0, :3], dim=1).max())}


def select_times(dev, cam, mesh, traj, counts):
    """The one-hot product against the gather (ops/deferred.py) for each
    (poses, candidates) of ``counts``: device ms by graph replay and ms
    per call from Python, and that both give the same depths."""
    m, c = mesh.to(dev), cam.to(dev)
    g = np.random.default_rng(SEED)
    out = {}
    for num, k in counts:
        poses = np.tile(traj(0)[0], (num, 1))
        poses[1:, :3] += 0.003 * g.standard_normal((num - 1, 3))
        poses = torch.as_tensor(poses.astype(np.float32), device=dev)
        _, ids = deferred.raycast_ids(m, poses[0], c.rays)
        cand = deferred.candidate_ids_dynamic(ids, c.height, c.width, 3.0, k,
                                              m.padded_triangles)

        def gather():
            return deferred.deferred_depth_gather(m, poses, c.rays, cand,
                                                  0.1)

        def matmul():
            return deferred.deferred_depth(
                m, poses, c.rays,
                deferred.one_hot_selectors(cand, m.padded_triangles), 0.1)

        a, b = gather(), matmul()
        check(torch.equal(torch.isfinite(a), torch.isfinite(b))
              and float(torch.nan_to_num(a - b, posinf=0.0).abs().max())
              <= RENDER_DEPTH_ATOL, f"gather and matmul differ at {num}")
        del a, b
        res = {}
        for name, fn in (("gather", gather), ("matmul", matmul)):
            res[name + "_ms"] = device_ms(fn, warmup=2, replays=3, runs=5)
            res[name + "_call_ms"] = statistics.median(
                _events_ms(fn, 1) for _ in range(5))
        out[f"poses_{num}_candidates_{k}"] = res
    return out


def batched_step_ms(dev, cam, mesh, traj):
    """``rgf.make_batched_step`` over BATCHED_SCENES stacked scenes: ms per
    step, and that scene 0 equals the single step."""
    tracker = GaussianTracker(rgf_config(), meshes=[mesh], camera=cam,
                              device=dev)
    frames = list(sources.SyntheticSource([mesh], cam, traj, 2, seed=SEED))
    tracker.initialize(traj(0), first_frame=frames[0].depth)
    z = tracker._frame(frames[1].depth)
    conf = tracker.config
    step = rgf.make_batched_step(
        tracker.render_fn, tracker.trans_params, tracker._dt,
        tracker.beam_params, iterations=conf.update_iterations,
        trust_sigma=conf.trust_sigma, occ_params=tracker._occ_params)
    beliefs = rgf.stack_beliefs([tracker.belief] * BATCHED_SCENES)
    zs = torch.stack([z] * BATCHED_SCENES)
    nb, _ = step(beliefs, zs)
    single, _ = tracker._step(tracker.belief, z, tracker._dt)
    err = float((nb.mean[0] - single.mean).abs().max())
    check(err <= 1e-5, f"batched step differs from the single step: {err}")
    ms = []
    for i in range(WARMUP + 10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(beliefs, zs)
        torch.cuda.synchronize()
        if i >= WARMUP:
            ms.append(1e3 * (time.perf_counter() - t0))
    med = statistics.median(ms)
    return {"scenes": BATCHED_SCENES, "ms_per_step": med,
            "ms_per_scene": med / BATCHED_SCENES,
            "max_abs_err_vs_single": err}


def phase_rgf(dev):
    """The Gaussian tracker at the slice's width (see the module
    docstring)."""
    cam, mesh, traj = slice_scene()
    for w in WRAPPERS.values():
        w.launches = 0
    # the default configuration and the 6-iteration one: the same frames
    # and readings
    configs = {"three": rgf_config(),
               "six": rgf_config(update_iterations=6, trust_sigma=1.5)}
    trackers, res = {}, {}
    for name, conf in configs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
        tracker = GaussianTracker(conf, meshes=[mesh], camera=cam,
                                  device=dev)
        run = node.run(tracker, sources.SyntheticSource(
            [mesh], tracker.camera, traj, FRAMES, seed=SEED))
        check(np.all(np.isfinite(run.poses)) and run.poses.shape == (
            FRAMES, 1, 7), f"{name}: bad pose output")
        rmse = run.position_rmse()
        check(rmse < RMSE_LIMIT_M,
              f"{name}: position RMSE {rmse} m >= {RMSE_LIMIT_M}")
        torch.cuda.synchronize()
        trackers[name] = tracker
        res[name] = {
            "position_rmse_m": rmse, "rotation_rmse_rad": run.rotation_rmse(),
            "node_latency_ms_mean": 1e3 * run.metrics.steady_state_latency(),
            "peak_mem_bytes": torch.cuda.max_memory_allocated() - held_before}
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    depth = sources.SyntheticSource(
        [mesh], trackers["three"].camera, traj, 1, seed=SEED).render(
            torch.as_tensor(traj(FRAMES), device=dev)).cpu()
    # timed in turns (three, six, six, three) before any profiling: the
    # host's speed drifts within a run, and the profiler slows what
    # follows it
    turns = [(name, track_ms(trackers[name], depth))
             for name in ("three", "six", "six", "three")]
    for name in configs:
        pair = [t for n, t in turns if n == name]
        res[name].update({
            k: statistics.mean(t[k] for t in pair) for k in pair[0]})
        res[name]["track_ms_median_by_turn"] = [
            t["track_ms_median"] for t in pair]
    ratio = res["six"]["track_ms_median"] / res["three"]["track_ms_median"]
    coverage = steady_coverage(trackers["three"], depth)
    res["three"]["profile"] = profile_steps(trackers["three"], depth,
                                            RGF_PROFILE_TABLE)
    res["six"]["profile"] = profile_steps(trackers["six"], depth,
                                          RGF6_PROFILE_TABLE)
    del trackers, tracker

    chunk = sensor_chunk(dev, cam)
    emit({"phase": "rgf", "pixels": cam.num_pixels,
          "triangles": mesh.padded_triangles, "sigma_points": 25,
          "frames": FRAMES, "iterations": 3, **res["three"],
          "launches": launches,
          "six_iterations": {"trust_sigma": 1.5, **res["six"],
                             "track_ms_ratio_to_three": ratio},
          "steady_state_coverage": coverage,
          "card_vs_cpu": rgf_against_cpu(dev, cam, mesh, traj),
          "select": select_times(dev, cam, mesh, traj,
                                 ((25, 6), (chunk, 4))),
          "batched_step": batched_step_ms(dev, cam, mesh, traj)})


def sensor_chunk(dev, cam):
    """The particle chunk the memory budget gives the "deferred" sensor
    at the slice's size."""
    from dbot_ros_tpu_torch.ops.budget import deferred_particle_chunk
    return deferred_particle_chunk(P, cam.num_pixels, 4, device=dev)


def phase_deferred(dev):
    """The particle tracker with the candidate-set ("deferred") sensor at
    the slice's width (see the module docstring)."""
    cam, mesh, traj = slice_scene()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    for w in WRAPPERS.values():
        w.launches = 0
    conf = cfg.ParticleTrackerConfig(
        evaluation_count=P, backend="deferred", seed=SEED,
        transition=cfg.TransitionConfig(0.1, 0.5, damping=4.0))
    tracker = ParticleTracker(conf, meshes=[mesh], camera=cam, device=dev)
    source = sources.SyntheticSource([mesh], tracker.camera, traj,
                                     DEFERRED_FRAMES, seed=SEED)
    run = node.run(tracker, source)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    rmse = run.position_rmse()
    check(np.all(np.isfinite(run.poses)) and rmse < RMSE_LIMIT_M,
          f"position RMSE {rmse} m >= {RMSE_LIMIT_M}")
    chunk = tracker.sensor.last_particle_chunk
    check(chunk == sensor_chunk(dev, cam) and chunk < P,
          f"unexpected particle chunk {chunk}")
    depth = source.render(torch.as_tensor(traj(DEFERRED_FRAMES),
                                          device=dev)).cpu()
    times = track_ms(tracker, depth, runs=10)
    peak = torch.cuda.max_memory_allocated() - held_before

    # one frame's depths against the exact raycast at 512 particles
    states = tracker.belief.states[:512, 0]
    m, c = tracker.meshes[0], tracker.camera
    render = deferred.make_deferred_renderer(m, c.rays, c.height, c.width)
    d_def = render(se3.states_mean(states)[:7], states[:, :7])
    d_ex = raycast.raycast_depth(m, states[:, :7], c.rays, 128)
    hit_def, hit_ex = torch.isfinite(d_def), torch.isfinite(d_ex)
    both = hit_def & hit_ex
    differ = float((hit_def != hit_ex).float().mean())
    off = float(((d_def[both] - d_ex[both]).abs() > 1e-4).float().mean())
    check(differ < 0.005, f"{differ} of the depths differ in hit or miss")
    emit({"phase": "deferred", "particles": P, "pixels": cam.num_pixels,
          "triangles": mesh.padded_triangles, "frames": DEFERRED_FRAMES,
          "position_rmse_m": rmse, **times,
          "node_latency_ms_mean": 1e3 * run.metrics.steady_state_latency(),
          "particle_chunk": chunk, "peak_mem_bytes": peak,
          "launches": launches,
          "against_exact_512_particles": {
              "share_hit_miss_differ": differ,
              "share_of_hit_pixels": float(hit_ex.float().mean()),
              "share_common_depths_off_1e-4": off}})


class StampedSource(sources.ThreadedSource):
    """A ``ThreadedSource`` that notes when each frame index is pushed
    (for the push-to-pose latency)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pushed_at = {}

    def push(self, depth, index=None, ground_truth=None):
        self.pushed_at[index] = time.perf_counter()
        super().push(depth, index, ground_truth)


def render_live_frames(dev, cam, mesh, traj):
    """The live phase's whole sequence, rendered first into a host list:
    ``OracleSource`` at 8 × ``cam``'s grid (the Kinect's native 640×480
    for the slice's 80×60), then the u16
    transport and the native 8× downsample of ``U16CameraAdapter``. → the
    frames and the per-frame ms of the render (to the host) and of the
    conversion."""
    native_cam = sources.scale_camera(cam.to(dev), 8)
    oracle = sources.OracleSource(mesh, native_cam, traj, LIVE_FRAMES,
                                  edge_artifacts=0.3, quantize_mm=True,
                                  seed=SEED)
    adapter = sources.U16CameraAdapter(oracle, 8)
    frames, render_ms, u16_ms = [], [], []
    for t in range(LIVE_FRAMES):
        poses, occ, p_drop = oracle.frame_inputs(t)
        draws = oracle.draw()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = oracle.render(torch.as_tensor(poses, device=dev),
                          torch.as_tensor(occ, device=dev), p_drop,
                          draws).cpu().numpy()
        t1 = time.perf_counter()
        depth = adapter.convert(z)
        t2 = time.perf_counter()
        frames.append(sources.Frame(t, depth, poses))
        render_ms.append(1e3 * (t1 - t0))
        u16_ms.append(1e3 * (t2 - t1))
    return frames, native_cam, render_ms, u16_ms


def live_client(sock, traj, ckpt, frames_left, log):
    """The operator: status, pause ~0.3 s and resume, checkpoint,
    reset_pose to the current ground truth, find_object near frame
    ``LIVE_FIND_FRAME``, then shutdown at frame ``LIVE_SHUTDOWN_FRAME`` or
    when the camera has at most ``LIVE_SHUTDOWN_MARGIN`` frames left to
    send, whichever comes first; every call through the socket, with
    timeouts. Writes what it saw into ``log``."""
    from dbot_ros_tpu_torch.runtime.service import call

    deadline = time.time() + LIVE_CLIENT_TIMEOUT_S

    def status():
        return call(sock, {"cmd": "status"}, timeout=5.0)

    def wait_for(cond, what):
        while time.time() < deadline:
            st = status()
            if cond(st):
                return st
            time.sleep(LIVE_POLL_S)
        raise TimeoutError(what)

    def wait_frame(n):
        return wait_for(lambda st: st.get("frame") is not None
                        and st["frame"] >= n, f"the loop never reached "
                        f"frame {n}")

    def wait_applied(seq):
        return wait_for(lambda st: st["applied_seq"] >= seq,
                        f"command {seq} was never applied")

    def queued(cmd):
        r = call(sock, cmd, timeout=5.0)
        check(r.get("ok") and r.get("queued"), f"{cmd['cmd']}: {r}")
        log.setdefault("seqs", []).append(r["seq"])
        return r["seq"]

    try:
        log["status"] = wait_frame(5)
        wait_frame(15)
        check(call(sock, {"cmd": "pause"}, timeout=5.0)["paused"], "pause")
        time.sleep(0.1)
        first = status()
        time.sleep(LIVE_PAUSE_S - 0.1)
        held = status()
        check(call(sock, {"cmd": "resume"}, timeout=5.0)["paused"] is False,
              "resume")
        log["pause"] = {"frame": first["frame"], "paused": held["paused"],
                        "frame_after_hold": held["frame"]}
        wait_frame(held["frame"] + 1)
        seq = queued({"cmd": "checkpoint", "path": ckpt})
        log["checkpoint_frame"] = wait_applied(seq)["frame"]
        st = wait_frame(log["checkpoint_frame"] + 10)
        seq = queued({"cmd": "reset_pose",
                      "pose": traj(st["frame"] + 1)[0].tolist()})
        log["reset_frame"] = wait_applied(seq)["frame"]
        wait_frame(LIVE_FIND_FRAME)
        seq = queued({"cmd": "find_object"})
        wait_applied(seq)
        st = wait_for(lambda st: st["frame"] >= LIVE_SHUTDOWN_FRAME
                      or frames_left() <= LIVE_SHUTDOWN_MARGIN,
                      "no frame to shut down on")
        log["shutdown_sent_at"] = {"frame": st["frame"],
                                   "frames_left": frames_left()}
        queued({"cmd": "shutdown"})
    except Exception as e:  # noqa: BLE001 - raised by the phase
        log["error"] = f"{type(e).__name__}: {e}"


def phase_live(dev, card):
    """The live runtime at the slice's width (see the module docstring);
    the socket and the checkpoint live in a short temporary directory
    (AF_UNIX paths hold at most 108 bytes)."""
    tmp = tempfile.mkdtemp(prefix="dbt")
    try:
        return live_in(dev, card, Path(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def live_in(dev, card, tmp):
    from dbot_ros_tpu_torch.runtime.service import TrackerService

    cam, mesh, traj = slice_scene()
    frames, native_cam, render_ms, u16_ms = render_live_frames(
        dev, cam, mesh, traj)
    check(frames[0].depth.shape == (cam.height, cam.width),
          f"converted frame {frames[0].depth.shape}")
    valid = np.concatenate([f.depth[np.isfinite(f.depth)] for f in frames])
    check(np.allclose(valid * 1000, np.round(valid * 1000), atol=1e-3),
          "depth not in whole millimetres after the u16 transport")

    tracker = ParticleTracker(slice_config(), meshes=[mesh], camera=cam,
                              device=dev)
    # warm up (a live camera does not wait), then start from the truth
    tracker.initialize(frames[0].ground_truth)
    for _ in range(3):
        tracker.track(frames[0].depth)
    tracker.initialize(frames[0].ground_truth)

    sock, ckpt = str(tmp / "c.sock"), str(tmp / "belief.npz")
    service = TrackerService(sock)
    src = StampedSource(frames, rate_hz=LIVE_RATE_HZ, capacity=LIVE_CAPACITY)
    per_frame, posed_at, log = [], {}, {}

    def on_frame(frame, poses, info):
        posed_at[frame.index] = time.perf_counter()
        per_frame.append({k: w.launches for k, w in WRAPPERS.items()})

    client = threading.Thread(
        target=live_client, daemon=True,
        args=(sock, traj, ckpt, lambda: LIVE_FRAMES - len(src.pushed_at),
              log))
    for w in WRAPPERS.values():
        w.launches = 0
    client.start()
    try:
        run = node.run(tracker, src, on_frame=on_frame, service=service)
        launches = {k: w.launches for k, w in WRAPPERS.items()}
    finally:
        client.join(LIVE_CLIENT_TIMEOUT_S)
        service.close()
    check(not client.is_alive(), "the client thread did not finish")
    check("error" not in log, f"client: {log.get('error')}")
    check(src.wait_closed(timeout=30), "the producer did not finish")

    prev = {k: 0 for k in WRAPPERS}
    for i, counts in enumerate(per_frame):
        for k in WRAPPERS:
            check(counts[k] > prev[k], f"{k} not launched on tracked frame "
                  f"{run.metrics.records[i].frame}")
        prev = counts
    tracked = [m.frame for m in run.metrics.records]
    skipped = [m.skipped or 0 for m in run.metrics.records]
    check(sum(skipped) + len(tracked) == tracked[-1] + 1,
          "skipped + tracked frames != last tracked index + 1")
    # the frame the loop popped when it saw the shutdown is not tracked
    check(src.skipped_total + len(tracked) + 1 == src.last_index + 1,
          f"skipped {src.skipped_total} + tracked {len(tracked)} + the "
          f"shutdown frame != last popped index {src.last_index} + 1")
    st = service.status()
    check(st["applied_seq"] == log["seqs"][-1] and st["last_error"] is None,
          f"service status at the end: {st}")
    check(tracked[-1] < LIVE_FRAMES - 1, "the stream ended before shutdown")
    reinit = run.reinit_frames
    check(len(reinit) == 1 and reinit[0] >= LIVE_FIND_FRAME,
          f"reinit_frames {reinit}")
    check(log["pause"]["paused"] and log["pause"]["frame_after_hold"]
          == log["pause"]["frame"], f"the pause did not hold: {log['pause']}")

    err = np.linalg.norm(run.poses[:, 0, :3] - run.ground_truth[:, 0, :3],
                         axis=1)
    check(np.all(np.isfinite(run.poses)), "non-finite pose")
    check(err[-LIVE_LAST_FRAMES:].max() < RMSE_LIMIT_M,
          f"last {LIVE_LAST_FRAMES} frames up to "
          f"{err[-LIVE_LAST_FRAMES:].max()} m off; (frame, skipped, error "
          "mm, hypotheses, ESS) from the search on: " + json.dumps([
              (m.frame, m.skipped, round(1e3 * float(e), 2),
               m.trial_hypotheses, m.ess and round(m.ess))
              for m, e in zip(run.metrics.records, err)
              if m.frame >= reinit[0]]))

    # the checkpoint loads, restores and tracks one frame
    gen = torch.Generator(device=dev)
    belief = checkpoint.load_belief(ckpt, device=dev, generator=gen)
    restored = ParticleTracker(slice_config(), meshes=[mesh], camera=cam,
                               device=dev)
    restored.generator = gen
    restored.restore(belief)
    f_ck = log["checkpoint_frame"]
    poses, _ = restored.track(frames[f_ck].depth)
    ck_err = float(torch.linalg.norm(
        poses.reshape(-1, 7)[0, :3].cpu()
        - torch.as_tensor(frames[f_ck].ground_truth[0, :3])))
    check(ck_err < RMSE_LIMIT_M, f"restored checkpoint is {ck_err} m off")

    lat = np.array([m.latency_s for m in run.metrics.records]) * 1e3
    trial = np.array([bool(m.trial_hypotheses)
                      for m in run.metrics.records])
    push_pose = np.array([1e3 * (posed_at[i] - src.pushed_at[i])
                          for i in tracked])
    after = [i for i, f in enumerate(tracked) if f > reinit[0]]
    resumed = [i for i, f in enumerate(tracked) if f > log["pause"]["frame"]]
    emit({"phase": "live", "card": card, "particles": P,
          "native_grid": [native_cam.height, native_cam.width],
          "pixels": cam.num_pixels, "triangles": mesh.padded_triangles,
          "stream_frames": LIVE_FRAMES, "rate_hz": LIVE_RATE_HZ,
          "ring_capacity": LIVE_CAPACITY, "tracked_frames": len(tracked),
          "last_tracked_frame": tracked[-1],
          "last_popped_frame": src.last_index,
          "dropped_total": src.skipped_total,
          "dropped_in_search": skipped[after[0]] if after else None,
          # the frame popped before the hold is tracked after it; the
          # next pop finds the frames the ring dropped meanwhile
          "dropped_in_pause": skipped[resumed[1]],
          "search_seconds": run.reinit_seconds[0],
          "find_object_frame": reinit[0],
          "track_ms_median": float(np.median(lat)),
          "track_ms_p90": float(np.percentile(lat, 90)),
          "track_ms_median_outside_trial": float(np.median(lat[~trial])),
          "trial_frames": int(trial.sum()),
          "push_to_pose_ms_median": float(np.median(push_pose)),
          "push_to_pose_ms_p90": float(np.percentile(push_pose, 90)),
          "oracle_render_ms_median": statistics.median(render_ms),
          "u16_convert_ms_median": statistics.median(u16_ms),
          "last30_max_error_m": float(err[-LIVE_LAST_FRAMES:].max()),
          "position_rmse_m": run.position_rmse(),
          "checkpoint_frame": f_ck, "checkpoint_restored_error_m": ck_err,
          "reset_frame": log["reset_frame"], "pause": log["pause"],
          "shutdown_sent_at": log["shutdown_sent_at"],
          "status_fields": sorted(log["status"]),
          "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# scale: the distributed filter (one rank under NCCL, two gloo ranks on
# the one card)
# ---------------------------------------------------------------------------

def scale_scene(dev, particles, rank=0, size=1):
    """The slice's tracker (for its sensor, camera, transition and start
    belief), its source, trajectory, and this rank's block of the
    ``particles``-particle start belief."""
    cam, mesh, traj = slice_scene()
    conf = slice_config()
    conf.evaluation_count = particles
    tracker = ParticleTracker(conf, meshes=[mesh], camera=cam, device=dev)
    tracker.initialize(traj(0))
    bel = tracker.belief
    L = particles // size
    rows = slice(rank * L, (rank + 1) * L)
    q = tracker.sensor.init_occlusion(L, conf.observation
                                      .initial_occlusion_prob)
    block = rbcpf.ParticleBelief(bel.states[rows].clone(),
                                 bel.log_weights[rows].clone(), q)
    return tracker, traj, block


def depth_of(source, traj, t, dev):
    z = source.render(torch.as_tensor(traj(t), device=dev))
    return preprocess_depth(z.reshape(-1).to(dev))


def model_position(tracker, mean_state):
    return base.to_model_frame(mean_state[:, :7], tracker.centers)[:, :3]


def scale_track(dev, comm):
    """The counts step over the slice's 60 frames on one rank: kernel
    launches, position RMSE, the last belief."""
    tracker, traj, belief = scale_scene(dev, P)
    source = sources.SyntheticSource(tracker.meshes, tracker.camera, traj,
                                     FRAMES, seed=SEED)
    step = dist_filter.make_distributed_step(
        comm, tracker.sensor, tracker.trans_params, tracker._dt,
        max_kl_divergence=tracker.config.max_kl_divergence,
        exchange="counts", seed=SEED)
    for w in WRAPPERS.values():
        w.launches = 0
    err, paths = [], set()
    for t, frame in enumerate(source):
        z = preprocess_depth(torch.as_tensor(frame.depth, device=dev)
                             .reshape(-1))
        belief, mean, _ = step(belief, z)
        paths.update(step.paths)
        err.append(model_position(tracker, mean) - torch.as_tensor(
            traj(t)[:, :3], device=dev))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    for k, n in launches.items():
        check(n > 0, f"scale: {k} never launched on the distributed path")
    rmse = float(torch.sqrt(torch.mean(
        torch.stack(err).pow(2).sum(-1))))
    check(rmse < RMSE_LIMIT_M, f"scale: position RMSE {rmse} m")
    return tracker, traj, source, step, belief, launches, rmse, sorted(paths)


def scale_against_rbcpf(dev, comm, tracker, traj, source, belief):
    """Three forced-resample frames: the one-rank step and ``rbcpf_step``
    from one belief with the same draws. Parents may move at a CDF tie
    (the two normalize in another order): at most one per frame; the rest
    agree to float rounding."""
    step = dist_filter.make_distributed_step(
        comm, tracker.sensor, tracker.trans_params, tracker._dt,
        max_kl_divergence=-1.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    mine = dataclasses.replace(belief, occlusion=tuple(
        x.clone() for x in belief.occlusion))
    ref = dataclasses.replace(belief, occlusion=tuple(
        x.clone() for x in belief.occlusion))
    worst = {"states": 0.0, "log_weights": 0.0, "mean": 0.0, "occ": 0.0,
             "moved": 0}
    for t in range(3):
        z = depth_of(source, traj, FRAMES + t, dev)
        noise = [rbcpf.BlockNoise(
            e1=torch.randn((P, 6), generator=gen, device=dev),
            e2=torch.randn((P, 6), generator=gen, device=dev),
            u=torch.rand((), generator=gen, device=dev))]
        mine, mean, _ = step(mine, z, noise=noise)
        ref, info = rbcpf.rbcpf_step(ref, z, tracker.sensor,
                                     tracker.trans_params, tracker._dt,
                                     max_kl_divergence=-1.0, noise=noise)
        d = (mine.states - ref.states).abs().reshape(P, -1).amax(1)
        moved = d > 2e-5
        keep = ~moved
        qa = tracker.sensor.occlusion_as_pn(mine.occlusion, P)[keep]
        qb = tracker.sensor.occlusion_as_pn(ref.occlusion, P)[keep]
        for k, v in (("states", float(d[keep].max())),
                     ("log_weights", float((mine.log_weights
                                            - ref.log_weights).abs().max())),
                     ("mean", float((mean - info.mean_state).abs().max())),
                     ("occ", float((qa - qb).abs().max()))):
            worst[k] = max(worst[k], v)
        worst["moved"] = max(worst["moved"], int(moved.sum()))
    check(worst["moved"] <= 1 and worst["states"] <= 2e-5
          and worst["log_weights"] == 0.0 and worst["mean"] <= 1e-5
          and worst["occ"] <= SCALE_OCC_ATOL,
          f"scale: one-rank step against rbcpf_step {worst}")
    return worst


def scale_scenes(dev):
    """Two scenes of 10,000 particles each (the second 3 cm aside) through
    the multi-scene step on one rank; each scene's position RMSE."""
    groups = dist_filter.make_scene_groups(1, 1)
    tracker, traj, block = scale_scene(dev, P)

    def traj2(t):
        return traj(t) + np.array([[0.03, 0, 0, 0, 0, 0, 0]], np.float32)

    trajs = [traj, traj2]
    srcs = [sources.SyntheticSource(tracker.meshes, tracker.camera, tr,
                                    SCALE_SCENE_FRAMES, seed=SEED + s)
            for s, tr in enumerate(trajs)]
    beliefs = dist_filter.init_multi_scene_belief(
        groups, torch.stack([base.to_center_frame(
            torch.as_tensor(tr(0), device=dev), tracker.centers)
            for tr in trajs]), SCALE_SCENES, P,
        sensor=tracker.sensor, device=dev)
    step = dist_filter.make_multi_scene_step(
        groups, tracker.sensor, tracker.trans_params, tracker._dt,
        max_kl_divergence=tracker.config.max_kl_divergence, seed=SEED)
    err = []
    for t, frames in enumerate(zip(*srcs)):
        z = torch.stack([preprocess_depth(torch.as_tensor(
            f.depth, device=dev).reshape(-1)) for f in frames])
        beliefs, means, _ = step(beliefs, z)
        err.append(torch.stack([
            model_position(tracker, means[s]) - torch.as_tensor(
                trajs[s](t)[:, :3], device=dev)
            for s in range(SCALE_SCENES)]))
    rmse = torch.sqrt(torch.stack(err).pow(2).sum(-1).mean(0)).reshape(-1)
    rmse = [float(r) for r in rmse]
    check(max(rmse) < RMSE_LIMIT_M, f"scale: scene RMSE {rmse} m")
    return rmse


def scale_times(dev, step, belief, tracker, source, traj):
    """Median ms of the one-rank counts step and of ``track`` on the same
    frame, timed in turns (step, track, track, step)."""
    z = depth_of(source, traj, FRAMES, dev)
    depth = z.cpu()
    tracker.restore(tracker.belief)
    out = {"step": [], "track": []}
    for name in ("step", "track", "track", "step"):
        for i in range(WARMUP + TIMING_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "step":
                belief, _, _ = step(belief, z)
            else:
                tracker.track(depth)
            torch.cuda.synchronize()
            if i >= WARMUP:
                out[name].append(1e3 * (time.perf_counter() - t0))
    return {k: statistics.median(v) for k, v in out.items()}


def marked_block(dev, tracker, block, rank):
    """This rank's start block for the exchange checks: all particles at
    the start pose (a still transition keeps them there, so the weights
    are the skew given) and a map whose columns differ, by a seeded draw,
    only off the object's silhouette (dilated by 3 pixels), where the
    sensor never changes a row: a wrong parent shows in the map."""
    cam = tracker.camera
    z = raycast.raycast_depth(tracker.meshes[0], block.states[0, 0, :7],
                              cam.rays)
    hit = torch.isfinite(z).reshape(1, 1, cam.height, cam.width).float()
    grown = torch.nn.functional.max_pool2d(hit, 7, 1, 3).reshape(-1) > 0
    q, age = block.occlusion
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 31 + rank)
    marks = torch.rand(q.shape, generator=g, device=dev).to(q.dtype)
    rows = torch.zeros(q.shape[0], dtype=torch.bool, device=dev)
    rows[:grown.shape[0]] = ~grown
    q = torch.where(rows[:, None], marks, q)
    states = block.states[:1].expand_as(block.states).clone()
    return rbcpf.ParticleBelief(states, block.log_weights.clone(),
                                (q, age))


def scale_rank(rank, world, port, out_dir, device):
    """One of two gloo ranks sharing the card (started with ``spawn``):
    the exchanges against all_gather on skewed forced frames, times and
    traffic per mode, the dry run. Writes ``rank<r>.json``; raises on a
    failed check (the parent sees the exit code)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    comm = comm_mod.init_process_group("gloo", rank, world, port,
                                       SCALE_GROUP_TIMEOUT_S)
    L = P // world
    for w in WRAPPERS.values():
        w.launches = 0
    kernels.lineage_gather.two_width_launches = 0
    tracker, traj, block = scale_scene(dev, P, rank, world)
    base_block = marked_block(dev, tracker, block, rank)
    source = sources.SyntheticSource(tracker.meshes, tracker.camera, traj,
                                     1, seed=SEED)
    z = depth_of(source, traj, 0, dev)
    still = transition.make_transition_params(1e-6, 1e-6, 0.0, device=dev)
    idx = torch.arange(rank * L, (rank + 1) * L, device=dev)
    frames = {
        # within one hop, under the capacity: the counts buffers carry it
        "fits": 0.4 * torch.sin(idx.float()),
        # rank 0 weighs nothing: its offspring descend from ~2,500
        # distinct particles of rank 1, more than C = 640: the ring runs
        "overflow": (torch.full((L,), -500.0, device=dev) if rank == 0
                     else 0.01 * torch.sin(idx.float())),
    }
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 100 + rank)
    gs = torch.Generator(device=dev)
    gs.manual_seed(SEED + 100)
    res = {"rank": rank, "frames": {}}
    for fname, lw in frames.items():
        noise = [rbcpf.BlockNoise(
            e1=torch.randn((L, 6), generator=g, device=dev),
            e2=torch.randn((L, 6), generator=g, device=dev),
            u=torch.rand((), generator=gs, device=dev))]
        outs, rec = {}, {}
        for mode in dist_filter.EXCHANGES:
            step = dist_filter.make_distributed_step(
                comm, tracker.sensor, still, tracker._dt,
                max_kl_divergence=-1.0, exchange=mode)
            start = dataclasses.replace(
                base_block, log_weights=lw.clone(),
                occlusion=tuple(x.clone() for x in base_block.occlusion))
            before = dict(comm.bytes_sent)
            stage0 = comm.staging_seconds
            outs[mode], _, _ = step(start, z, noise=noise)
            torch.cuda.synchronize()
            rec[mode] = {"path": step.paths,
                         "bytes": sum(comm.bytes_sent[k] - before[k]
                                      for k in before),
                         "staging_s": comm.staging_seconds - stage0}
        ref = outs["all_gather"]
        check(bool((ref.log_weights == 0).all()), "scale: no resample")
        for mode, b in outs.items():
            same = (torch.equal(b.states, ref.states)
                    and torch.equal(b.log_weights, ref.log_weights)
                    and torch.equal(b.occlusion[0][:, :L].view(torch.int16),
                                    ref.occlusion[0][:, :L]
                                    .view(torch.int16)))
            check(same, f"scale: {mode} differs from all_gather on rank "
                        f"{rank} ({fname})")
            rec[mode]["bit_equal"] = same
            rec[mode]["age_equal"] = torch.equal(b.occlusion[1],
                                                 ref.occlusion[1])
        res["frames"][fname] = rec
    check(res["frames"]["fits"]["counts"]["path"] == ["counts"],
          f"scale: the fitting frame took {res['frames']['fits']}")
    check(res["frames"]["overflow"]["counts"]["path"] == ["ring"],
          "scale: the overflow frame did not fall back to the ring")

    # ms per step per mode on the fitting frame's weights
    res["ms_per_step"], res["bytes_per_step"], res["staging_s_per_step"] = \
        {}, {}, {}
    for mode in dist_filter.EXCHANGES:
        step = dist_filter.make_distributed_step(
            comm, tracker.sensor, still, tracker._dt,
            max_kl_divergence=-1.0, exchange=mode, seed=SEED)
        ms = []
        bytes0, stage0 = sum(comm.bytes_sent.values()), comm.staging_seconds
        for i in range(SCALE_WARMUP + SCALE_STEPS):
            start = dataclasses.replace(
                base_block, log_weights=frames["fits"].clone(),
                occlusion=tuple(x.clone() for x in base_block.occlusion))
            if i == SCALE_WARMUP:
                bytes0 = sum(comm.bytes_sent.values())
                stage0 = comm.staging_seconds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(start, z)
            torch.cuda.synchronize()
            if i >= SCALE_WARMUP:
                ms.append(1e3 * (time.perf_counter() - t0))
        res["ms_per_step"][mode] = statistics.median(ms)
        res["bytes_per_step"][mode] = (sum(comm.bytes_sent.values())
                                       - bytes0) / SCALE_STEPS
        res["staging_s_per_step"][mode] = ((comm.staging_seconds - stage0)
                                           / SCALE_STEPS)
    res["dryrun"] = dryrun.dryrun(dev, SCALE_GROUP_TIMEOUT_S)
    torch.cuda.synchronize()
    res["launches"] = {k: w.launches for k, w in WRAPPERS.items()}
    res["two_width_launches"] = kernels.lineage_gather.two_width_launches
    check(res["two_width_launches"] > 0,
          f"scale: the two-width gather never launched on rank {rank}")
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    comm.barrier()


def scale_two_ranks(dev):
    """Two gloo ranks sharing the card, collectives staged through pinned
    host memory; the parent fails if a rank fails or outlives its time."""
    out_dir = Path(tempfile.mkdtemp(prefix="dbt_scale"))
    ctx = torch.multiprocessing.get_context("spawn")
    port = comm_mod.free_port()
    procs = [ctx.Process(target=scale_rank,
                         args=(r, SCALE_RANKS, port, str(out_dir),
                               str(dev)))
             for r in range(SCALE_RANKS)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(SCALE_RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * SCALE_RANKS, f"scale: ranks exited with {codes}")
    res = [json.loads((out_dir / f"rank{r}.json").read_text())
           for r in range(SCALE_RANKS)]
    shutil.rmtree(out_dir, ignore_errors=True)
    return res, time.perf_counter() - t0


def phase_scale(dev, card):
    """One rank under NCCL (the slice, the check against rbcpf_step, two
    scenes, times), then two gloo ranks sharing the card."""
    t0 = time.perf_counter()
    comm = comm_mod.init_process_group(SCALE_BACKEND, 0, 1,
                                       comm_mod.free_port(),
                                       SCALE_GROUP_TIMEOUT_S, device=dev)
    try:
        (tracker, traj, source, step, belief, launches, rmse,
         paths) = scale_track(dev, comm)
        versus = scale_against_rbcpf(dev, comm, tracker, traj, source,
                                     belief)
        times = scale_times(dev, step, belief, tracker, source, traj)
        del tracker, belief, step
        scene_rmse = scale_scenes(dev)
    finally:
        torch.distributed.destroy_process_group()
    one_rank_s = time.perf_counter() - t0
    ranks, two_s = scale_two_ranks(dev)
    emit({"phase": "scale", "nvidia_smi": card,
          "one_rank": {"backend": SCALE_BACKEND, "world": 1,
                       "particles": P, "frames": FRAMES,
                       "position_rmse_m": rmse, "paths": paths,
                       "launches": launches,
                       "against_rbcpf_step": versus,
                       "scene_position_rmse_m": scene_rmse,
                       "step_ms_median": times["step"],
                       "track_ms_median": times["track"],
                       "seconds": one_rank_s},
          "two_ranks": {"transport": "gloo, staged through pinned host "
                                     "memory, both ranks on one card",
                        "world": SCALE_RANKS, "particles_per_rank":
                        P // SCALE_RANKS, "capacity":
                        dist_filter.counts_capacity(P // SCALE_RANKS),
                        "seconds": two_s, "ranks": ranks}})
    return launches


def main(argv=None):
    compare = "--compare" in (sys.argv[1:] if argv is None else argv)
    card = phase_device()
    dev = torch.device("cuda")
    phase_build()
    if compare:
        # what a comparison of two commits reads, in one run of each
        phase_rows(dev)
        phase_slice(dev)
        emit(ok_line())
        return 0
    kres = phase_kernels(dev)
    phase_sensor(dev)
    launches, tracker, depth = phase_slice(dev)
    phase_profile(tracker, depth, PROFILE_TABLE)
    del tracker
    phase_cli(dev)
    phase_rgf(dev)
    phase_cli(dev, kind="gaussian")
    phase_deferred(dev)
    live_launches = phase_live(dev, card)
    scale_launches = phase_scale(dev, card)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "live_launches": live_launches[name],
         "scale_launches": scale_launches[name],
         **{k: kres[name][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         **{k: kres[name].get(k) for k in (
             "cold_ms", "library_cold_ms", "calls_per_graph")},
         **{k: kres[name][k] for k in ("second_level", "two_widths")
            if k in kres[name]}}
        for name, (src, rep) in KERNELS.items()]})
    emit(ok_line())
    return 0


def ok_line():
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    sys.exit(main())
