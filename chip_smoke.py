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
   float32, bit-exact. The fifth kernel, the row aging that the
   distributed exchanges launch (``age_pixel_rows``, the port's own),
   runs on the whole map (4,800 rows, 10,000 particles) with ages of 0-6
   frames, bit-exact with NaN where NaN, and ``materialize_occlusion``
   as an exchange calls it is timed where columns cross and where they
   do not. Every kernel is also timed cold: over copies of
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
6b. graph: the compiled step. Each tracker's ``track`` replays CUDA
   graphs by default (``utils/graphs.py``; every phase here but this one
   runs that way); this phase holds it against the eager step
   (``capture=False``) on seven paths: the slice, the two objects below,
   a 4-island trial (the truth and three hypotheses 4-8 mm off, a trial
   that outlasts the phase), the Gaussian tracker at 3 and at 6
   iterations, its frozen trial step (the same four hypotheses), and the
   particle tracker with the "deferred" sensor at 10,000 particles. A
   captured and an eager tracker with the same seed run the same 12
   frames in lockstep: poses and every leaf of the belief (all islands'
   or hypotheses' in a trial) must be equal bit for bit, the kernels'
   launches per frame equal, the captured run's position RMSE under 1
   cm. Prints the largest differences, the launches per frame, ``track``
   median and p90 of both timed in turns (captured, eager, eager,
   captured), from ``torch.profiler`` the device busy ms, kernels, host
   ops, copies and waits per step and the idle share of both (tables in
   ``build/profile_graph/``), the number of graphs, the seconds their
   captures took and the memory their pool added;
7. objects: two tracked objects at the same width: the slice's sphere
   and the eval suite's ``box_mesh(0.05, 0.07, 0.03)``, which crosses in
   front of the sphere (its centre 8 cm nearer, partly hiding it over
   the middle frames), through ``node.run`` over 60 frames with the eval
   suite's process noise and the automatic slack, per object in its own
   mesh's units (ops/slack.py; the sphere ~0.32, the box ~0.05; printed
   at the last frame, ``auto_slack_last_frame``). The same run with one
   fixed ``bary_slack`` for both meshes (the box's own, 0.0506) is
   printed as a reading, ``fixed_slack_...``, not checked. Checks: each
   object's position RMSE under 1 cm
   over the last 30 frames; every frame launches the fused kernel and
   the row gather twice (one sensor call per coordinate block), the row
   scatter once (only the last block commits) and the lineage gather
   twice (once per block); one filter step from the belief before the
   crossing frame on the card against the same step on the CPU, with the
   same ``BlockNoise`` draws (poses 1e-4 m / 1e-3 rad). Prints ``track``
   median and p90 timed in turns with the slice's tracker (two, one,
   one, two), the device memory the tracker holds and one step adds;
8. options: the fused sensor's options at the same width, on the
   slice's belief after 10 frames and the next 3 frames: ``merge=
   "select"`` against ``"scatter"`` and ``active_cap_frac=1/12,
   tri_cap_frac=0.2`` against ``levels=[(1/12, 0.2)]`` (loglik, map and
   ages bit-equal); ``bary_slack=0.0`` against a plain-PyTorch exact
   intersection of the same candidate sets and ``image_loglik`` (rtol
   2e-4, 0.05 nats); ``reference_poses=4`` against 1 on the belief
   collapsed to its mean (1e-5; on the tracked cloud itself the two
   differ, printed), and on a bimodal cloud (the belief split into two
   blocks 3 cm apart) the share of each mode's exact silhouette with a
   candidate, R = 4 at least 90 % on both; g < 0 (``p_occluded_visible
   0.4, p_occluded_occluded 0.1``) on a raw map: the eager compacted
   branch against the full level over the 3 frames (loglik rtol 2e-5 +
   0.01 nats; float32 map 1e-5, bfloat16 one ulp), on a compacted level
   with both row kernels launched every frame. Prints the device ms of
   one call's device work (``FusedSensor.apply`` in a CUDA graph) on the
   eager and the full route, in turns; the select merge's gather (4,800
   rows out of 448) warm and cold against ``index_select`` on the same
   copies, with its bound and a device copy of its output; the whole
   call with the select and with the scatter merge;
9. cli: the command-line tracker at the same width, in-process through
   ``dbot_ros_tpu_torch.runtime.cli.main``: ``record`` a 60-frame
   ``teleport`` trajectory of the icosphere (written to an ``.obj``),
   then ``track --auto-init --watchdog --checkpoint``. Checks the
   auto-init pose (within 1 cm of the truth), the 60 JSONL records, that
   the watchdog tripped and the frames after it raced at least two
   island hypotheses, the position error of the last 10 frames (under
   1 cm), the checkpoint (load, restore, one more frame) and that all
   four kernels launched. Prints the seconds of the search and of the
   re-init, and the per-frame latency inside and outside the trial;
10. rgf: the second estimator at the same width: ``GaussianTracker``
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
   poses and at the particle chunk; the batched step over 4 scenes as
   its JAX callers jit it (``graphs.compiled``, beliefs donated),
   captured against eager over 4 frames bit for bit, ms per step and per
   scene of both in turns (captured, eager, eager, captured); one
   re-anchor (``node.run``'s gap rule) on a frame 150 dropped frames
   after the last tracked: its ms, the error before and after it, and
   the tracked pose, which must be within 1 cm and nearer than the same
   belief's propagated over the damping time;
11. rgf_cli: ``record --trajectory teleport`` then ``track --auto-init
   --watchdog --checkpoint`` with a Gaussian config: the watchdog trips
   after the jump at frame 12, the re-init races at least two
   hypotheses, the last 10 frames are within 1 cm, the checkpoint
   restores and tracks;
12. deferred: ``ParticleTracker(backend="deferred")``, 10,000 particles,
   20 frames, RMSE under 1 cm; the particle chunk the memory budget
   chose, peak memory, and 512 particles' depths against the exact
   raycast (share of (particle, pixel) pairs that differ);
13. live: the deployment path. 240 frames of the slice's trajectory are
   rendered first, into a host list, by ``OracleSource`` at the Kinect's
   native 640×480 grid (edge artifacts 0.3, whole millimetres) and
   converted by ``U16CameraAdapter`` (uint16 mm, the native 8× strided
   downsample); render and conversion are timed per frame. The render is
   captured (one CUDA graph); the first 10 frames are also rendered by
   an eager twin with the same draws (timed), the first 3 must be equal
   bit for bit. A
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
   search's frame; the last 30 tracked frames within 1 cm, and so every
   tracked frame from the search's on; the first frames after the search
   and after the pause (each more than the damping time after the frame
   before it) re-anchored (``TrackRun.reanchors``, the gap rule of
   ``runtime/node.py``); the checkpoint loads, restores and tracks the
   frame the loop went on with after it, over its real interval from the
   saved frame (the last tracked before the command applied).
   Prints ``track`` median and p90, frames dropped in all, in the pause
   and in the search, the search's seconds, per re-anchor its frame,
   frames dropped, ms, and the error of the stale pose and of the placed
   one against that frame's truth, render and conversion ms, ms from
   push to pose;
14. scale: the distributed filter (``dbot_ros_tpu_torch.parallel``).
   One rank under NCCL on the card, every step captured (CUDA-graph
   replays, NCCL collectives inside the graphs):
   ``make_distributed_step(exchange="counts")`` over the slice's 60
   frames at its width (position RMSE under 1 cm, every kernel
   launched), three forced-resample frames against ``rbcpf_step`` with
   the same draws; then each one-rank step held against its eager twin
   (``capture=False``) with the same seed in lockstep: the distributed
   step with ``counts`` and with ``all_gather`` and the island step over
   the same 12 frames, the multi-scene step with 2 scenes × 10,000
   particles (the second 3 cm aside) over 30. Means, ESS and every leaf
   of the belief must be equal bit for bit, the paths and the kernels'
   launches per frame equal, each scene's position RMSE under 1 cm;
   step ms median and p90 of both timed in turns (captured, eager,
   eager, captured) between two turns of the captured ``track`` on the
   same frame; graphs, capture seconds and pool MB. Before all of it
   the resampling CDF (``resample.weight_cdf``) at 10,000 and 100,000
   weights, called 1,000 times each while a side stream keeps the card
   busy, must repeat to the bit; the calls of a one-row ``torch.cumsum``
   on the same weights that differ from its first are counted beside it
   (what it replaced: its single-pass scan groups the sums by which tiles
   finished first, and a systematic threshold at such a CDF step picks
   another parent, so captured and eager steps drifted apart). Then two
   gloo ranks started with ``spawn`` share the card, 5,000 particles each,
   collectives staged through pinned host memory: on a frame whose
   surplus fits the counts buffers (C = 640) and on one that overflows
   to the ring, with lazy ages that differ by rank, ``counts``, ``ring``
   and ``neighbor`` must equal ``all_gather`` bit for bit in states, log
   weights, the map's particle columns and the lazy ages, and in every
   mode each offspring's materialized occlusion must equal its parent's
   on the parent's home rank to one bfloat16 rounding (the parent found
   by its state among both ranks' proposals, the leaf before the
   exchange recomputed from the same start and draws); ms, bytes sent
   and staging seconds per step per mode; the
   two-width lineage gather must launch on both ranks; the steps there
   are eager (``capture: false``: gloo stages through the host) and
   ``capture=True`` must raise; the row aging must launch on both
   ranks (its launches are the kernels line's ``launches`` for it and
   ``two_rank_launches`` for every kernel); the dry run
   (``parallel.dryrun``) at world size 2. A rank that fails, or outlives
   its time, fails the phase. One card cannot measure scaling
   efficiency: these are mechanics;
15. eval: the port held to the JAX tracker on the same frames
   (``runtime.eval_suite``, the counterpart of the reference's accuracy
   suite): the ``production`` set first (the 10k certification's four
   protocols at 80×60, 10,000 particles, the fused sensor's production
   defaults, and the Gaussian tracker at 6 iterations on two of them),
   then the ``eval`` set (six scenarios at 40×30, each with the four
   estimators ``pf-xla``, ``pf-deferred``, ``pf-pallas`` and ``rgf``),
   each leg over its rule's tracker seeds (1-10 for the particle
   filters, 1-3 for the deterministic Gaussian filter) with captured
   trackers, from the frames in ``tests/fixtures/torch_eval``, judged
   by the rule of ``jax_reference.json``'s ``bound_rule`` (a one-sided
   Welch test against JAX's seeds for the particle filters, a floor over
   JAX's mean for the Gaussian filter). One line per set: per leg the
   port's mean and spread, the JAX mean and spread, per metric ``diff``,
   ``threshold`` and ``slack``, the seeds of each side over 2 cm in the
   worst error, pass or fail, frames, particles, seconds, and on
   ``pf-pallas`` legs the four kernels' launches. Then the power check:
   ``eval/fast_rot/pf-pallas`` at its seeds with both transition sigmas
   × 0.1 (a belief too stiff to follow the rotation), its ``diff``,
   ``threshold`` and ``slack`` beside the real leg's. Every result goes
   to ``build/eval_results.json``. Fails if a leg fails its rule, if a
   kernel was not launched on a ``pf-pallas`` leg, if the power check
   passes the rule, or if the phase took over 180 s.

The kernels phase also times the two row kernels cold, and the lineage
gather at two widths: the exchange's shapes for two ranks of 5,000
(a 640-column buffer out of a 5,120-column map, a map out of one buffer,
a map out of the 10,240-column concatenation of two), bit-exact. The rgf, rgf_cli
and deferred paths launch no hand-written kernel (the reference's are
plain array code too): their launch counts are printed and are zero.
The kernels line gives each kernel's launches in the slice
(``launches``), in the live phase (``live_launches``), in the scale
phase's one-rank run (``scale_launches``), in the objects phase's 60
frames (``objects_launches``), in the options phase's checks
(``options_launches``), in the graph phase's captured runs
(``graph_launches``), in the scale phase's captured lockstep runs
(``scale_graph_launches``) and in the eval phase's legs
(``eval_launches``), each counted from 0 just before that path and
read just after.

Each phase prints one JSON line; any failure raises (exit code != 0);
the eval phase's failures raise after the kernels line.
The last line is ``{"ok": true, "device": {...}}``. Imports no JAX.

``python3 chip_smoke.py --compare [fused] [rows] [slice] [scale]`` runs
only what a comparison of two commits reads: the device and build
phases, then the phases named (all four without a name): the kernels
phase's reading of the fused kernel at the tight level (``fused``), the
row kernels (``rows``: the kernels phase's gather and scatter readings
at both levels, without the out-of-range gather), the slice (``track``
median) and the two gloo ranks' ms, bytes and staging seconds per step
per mode (``scale``, without the scale phase's checks; in turns as
they are and with the sensor's materialization replaced by the
identity, and a profile of the counts step). Name only the
phases whose entry points both commits share. To compare
with a parent commit, unpack it with ``git archive`` into a git-ignored
directory, copy this file over its own, and run ``--compare`` in both
trees in turns (parent, change, change, parent), one after another on
the same card.
"""

import contextlib
import copy
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
from dbot_ros_tpu_torch.models.image_loglik import image_loglik
from dbot_ros_tpu_torch.ops import build, deferred, kernels, raycast
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import resample
from dbot_ros_tpu_torch.ops import slack as slack_mod
from dbot_ros_tpu_torch.parallel import comm as comm_mod
from dbot_ros_tpu_torch.parallel import dist_filter, dryrun
from dbot_ros_tpu_torch.runtime import (checkpoint, cli, initializer, node,
                                        sources)
from dbot_ros_tpu_torch.runtime.service import TrackerService
from dbot_ros_tpu_torch.trackers import base
from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker
from dbot_ros_tpu_torch.trackers.particle import ParticleTracker
from dbot_ros_tpu_torch.utils import graphs, se3
from dbot_ros_tpu_torch.utils.camera import (default_kinect_camera,
                                           make_camera, preprocess_depth)
from dbot_ros_tpu_torch.utils.mesh import (box_mesh, icosphere_mesh,
                                         tagged_l_mesh)

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
# the rgf phase's gap: what a 5 s search drops at 30 Hz
RGF_GAP_SKIPPED = 150
DEFERRED_FRAMES = 20
BATCHED_SCENES = 4
BATCHED_FRAMES = 4
# the live phase: a 30 Hz camera at 640×480 (8 s), a ring of 8 frames
LIVE_FRAMES = 240
# the first frames rendered eagerly too (the same draws), and how many of
# them must equal the captured render bit for bit
LIVE_EAGER_FRAMES, LIVE_EAGER_CHECKED = 10, 3
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
CDF_SIZES, CDF_CALLS = (10_000, 100_000), 1_000
# one-rank step against rbcpf_step: occlusion of the particles that kept
# their parent within one bf16 step (a moved parent shifts the cloud's
# mean, and with it, rarely, a candidate pixel)
SCALE_OCC_ATOL = 4e-3
# the two gloo ranks: an offspring's materialized occlusion against its
# parent's on the parent's home rank, one rounding of a [0, 1] value to
# bfloat16 (half its 2^-8 step)
SCALE_HOME_ATOL = 2.0 ** -9

# the objects phase: the eval suite's box crossing in front of the slice's
# sphere (a centre 8 cm nearer, 3.7 mm a frame, 0.01 rad a frame about x)
OBJECTS_BOX = (0.05, 0.07, 0.03)
OBJECTS_BOX_X0, OBJECTS_BOX_SPEED = 0.11, 0.0037
OBJECTS_BOX_Z, OBJECTS_BOX_SPIN = 0.72, 0.01
OBJECTS_CROSS_FRAME = 30
OBJECTS_LAST_FRAMES = 30
OBJECTS_POS_ATOL_M, OBJECTS_ROT_ATOL_RAD = 1e-4, 1e-3
# a two-object frame: the fused kernel and the row gather once per
# coordinate block, the row scatter on the last block only (the first
# call does not commit), the lineage gather once per block (rbcpf_step
# gathers after every block, the parents or the identity)
OBJECTS_LAUNCHES_PER_FRAME = {"fused_loglik": 2, "gather_pixel_rows": 2,
                              "scatter_pixel_rows": 1, "lineage_gather": 2}
ROW_KERNELS = ("gather_pixel_rows", "scatter_pixel_rows")
# the kernels phase's two-slack case: the automatic slack of the objects
# phase's sphere and box at their depths, each in its own mesh's units
TWO_SLACKS = (0.32, 0.0506)
# the options phase: the slice's belief after 10 frames, 3 sensor frames
OPTIONS_TRACKED_FRAMES, OPTIONS_FRAMES = 10, 3
# the bimodal cloud: two blocks 3 cm apart; R = 4 must give candidates on
# at least this share of each mode's exact silhouette
OPTIONS_MODE_GAP_M, OPTIONS_MODE_COVERAGE = 0.03, 0.90
# (p_occluded_visible, p_occluded_occluded) of a chain with g < 0
OPTIONS_NEG_CHAIN = (0.4, 0.1)
# the exact inside-test against the exact intersection of the same
# candidates (tests/test_pallas.py's multi-object oracle): the two differ
# in the order of the sum over pixels and the kernel's exp/log, and on a
# ray within float rounding of a triangle's edge, which one computation
# may count as a hit and the other as a miss (a particle with a ray
# within SLACK0_EDGE barycentric units of an edge is counted, not held)
SLACK0_RTOL, SLACK0_ATOL = 2e-4, 0.05
SLACK0_EDGE = 1e-4

# graph phase: frames each path runs captured and eager in lockstep, the
# trial's hypotheses (offsets of the truth in x, m) and the profile tables
GRAPH_FRAMES = 12
GRAPH_TIMING_RUNS = 10
GRAPH_TRIAL_OFFSETS_M = (0.0, 0.004, -0.004, 0.008)
GRAPH_TRIAL_FRAMES = 1000
# the captured step must equal the eager one bit for bit (the same kernels
# on the same inputs): poses and every leaf of the belief
GRAPH_ATOL = 0.0
GRAPH_PROFILE_DIR = BUILD_DIR / "profile_graph"
EVAL_FIXTURES = (Path(__file__).resolve().parent / "tests" / "fixtures"
                 / "torch_eval")
EVAL_LIMIT_S = 180.0
EVAL_RESULTS = BUILD_DIR / "eval_results.json"
# the eval phase's power check: a leg whose transition is too stiff for
# its motion, which the rule must fail
EVAL_POWER_LEG = "eval/fast_rot/pf-pallas"
EVAL_POWER_SCALE = 0.1
KERNELS = {
    "fused_loglik": ("dbot_ros_tpu_torch/csrc/fused_loglik.cu",
                     "dbot_ros_tpu/ops/raycast_pallas.py:192"),
    "gather_pixel_rows": ("dbot_ros_tpu_torch/csrc/pixel_rows.cu",
                          "dbot_ros_tpu/ops/raycast_pallas.py:584"),
    "scatter_pixel_rows": ("dbot_ros_tpu_torch/csrc/pixel_rows.cu",
                           "dbot_ros_tpu/ops/raycast_pallas.py:508"),
    "lineage_gather": ("dbot_ros_tpu_torch/csrc/lineage_gather.cu",
                       "dbot_ros_tpu/ops/raycast_pallas.py:430"),
    # the port's own: no TPU kernel; the array code it computes
    "age_pixel_rows": ("dbot_ros_tpu_torch/csrc/pixel_rows.cu",
                       "none (the closed form of occlusion_as_pn, "
                       "dbot_ros_tpu/ops/raycast_pallas.py:1052)"),
}
# the kernels of every tracker step (the one only the distributed
# exchanges launch: all_wrappers)
WRAPPERS = kernels.WRAPPERS


def emit(obj):
    print(json.dumps(obj), flush=True)


def raises(exc, fn):
    """Whether ``fn()`` raises ``exc``."""
    try:
        fn()
    except exc:
        return True
    return False


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def all_wrappers():
    """Every kernel's wrapper by name: the tracker's and the exchanges'
    (its path: the two gloo ranks)."""
    return {**kernels.WRAPPERS, **kernels.EXCHANGE_WRAPPERS}


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
    averaged per name (per key where a reading is a dict)."""
    out = {k: [] for k in named}
    for k in list(named) + list(reversed(named)):
        out[k].append(reading(named[k]))
    return {k: ({f: statistics.mean(r[f] for r in v) for f in v[0]}
                if isinstance(v[0], dict) else statistics.mean(v))
            for k, v in out.items()}


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
    # one slack for every triangle
    params = fs.make_params_vec(sensor.bp, sensor.op, 1.0)
    tri_slack = torch.full((gt.shape[0],), 0.25, device=dev)
    args = (gt, occ, z_k.contiguous(), cand_k.to(torch.int32).contiguous(),
            rays.contiguous(), ages, params, tri_slack)
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
    the tight level's shapes), two slacks (the packed triangles' first
    half at the sphere's automatic slack beside the box, the rest at the
    box's: two objects' meshes), float32 maps, and the ladder's second and
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
        "tight_two_slacks": tight_args[:7] + (torch.where(
            torch.arange(T, device=dev) < T // 2, TWO_SLACKS[0],
            TWO_SLACKS[1]),),
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


def kernels_scene(dev):
    """The kernels phase's camera, mesh, sensor, a generator and the fused
    kernel's arguments at the ladder's tight level (``fused_inputs``)."""
    cam = default_kinect_camera(8, device=dev)
    mesh = icosphere_mesh(radius=0.06, subdivisions=3, device=dev)
    bp = beam.make_beam_params(device=dev)
    op = occlusion.make_occlusion_params(device=dev)
    sensor = fs.make_fused_sensor(mesh, cam, bp, op, device=dev)
    states, z = scene(dev, P, cam, mesh, 0.8, SEED)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    args, sel, info = fused_inputs(sensor, cam, states, z, 0, g)
    return cam, mesh, sensor, g, args, sel, info


def fused_tight(args):
    """The fused kernel's reading at the tight level: held to its plain
    version (``check_fused``), both timed in turns, its bound, and its
    cold time over copies of the inputs (slabs named + map rows: ~47 MB
    a call). Returns the reading and the kernel's posterior map."""
    res, occ_k = check_fused(args, "tight level")
    res.update(time_pair(
        lambda: kernels.fused_loglik_plain(*args),
        lambda: kernels.fused_loglik(*args)))
    res.update(fused_bound(args))
    copies = [args] + [tuple(a.clone() for a in args)
                       for _ in range(cold_copies(res["bytes"]) - 1)]
    res["cold_ms"] = cold_device_ms(
        [lambda c=c: kernels.fused_loglik(*c) for c in copies])
    res["cold_copies"] = len(copies)
    return res, occ_k


def phase_fused(dev):
    """``--compare``: the kernels phase's reading of the fused kernel at
    the tight level."""
    _, _, _, _, args, _, info = kernels_scene(dev)
    res, _ = fused_tight(args)
    emit({"phase": "fused", "n": info["n"], "T": info["T"], **res})


def phase_kernels(dev):
    cam, mesh, sensor, g, args, sel, info = kernels_scene(dev)
    N = cam.num_pixels
    p_pad = fs.particle_pad(P)
    shapes = {"n": info["n"], "K": info["K"], "T": info["T"], "P": P,
              "p_pad": p_pad}
    check(shapes["n"] == 448 and shapes["T"] == 288,
          f"unexpected slice shapes {shapes}")
    fused, occ_k = fused_tight(args)
    out = {"fused_loglik": fused}
    fused_more = fused_other_shapes(dev, sensor, cam, mesh, args, g)

    n_pad = fs._round_up(N, sensor.nb)
    q = torch.rand((n_pad, p_pad), generator=g,
                   device=dev).to(torch.bfloat16)
    rows = row_results(dev, sensor, cam, mesh, q, g, sel_tight=sel)
    for name, levels in rows.items():
        out[name] = dict(levels["tight"], second_level=levels["second"])

    out["lineage_gather"], lineage, real = lineage_results(dev, q, g)
    out["lineage_gather"]["two_widths"] = lineage_two_widths(dev, real, g)
    out["age_pixel_rows"] = age_results(dev, sensor, q, g)
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
              "lineage": "bit-exact", "lineage_two_widths": "bit-exact",
              "age_rows": "bit-exact (NaN where NaN)"},
          "results": out, "fused_other_shapes": fused_more,
          "lineage_parents": lineage})
    return out


def age_results(dev, sensor, q, g):
    """The row-aging kernel (the distributed exchanges' materialization,
    parallel/dist_filter.py) on the kernels phase's map, every pixel's row
    at 10,000 particles: ages of 0-6 frames drawn per pixel (every third
    0), NaN, 0 and 1 among the values. Held to its plain version bit for
    bit, both timed in turns, cold over copies; then
    ``materialize_occlusion`` as an exchange calls it (the factors from
    the ages, the kernel, the ages), on a frame where columns cross and on
    one where they do not: the same pass."""
    age = torch.randint(0, 7, (q.shape[0],), generator=g,
                        device=dev).float()
    age[::3] = 0.0
    q = q.clone()
    q[0, :8], q[1, :8], q[2, :8] = float("nan"), 0.0, 1.0
    geff, pi = sensor._chain(age)
    got = kernels.age_pixel_rows(q, geff, pi)
    want = kernels.age_pixel_rows_plain(q, geff, pi)
    torch.cuda.synchronize()
    same = (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(), want.nan_to_num()))
    err = float((got.float() - want.float()).nan_to_num().abs().max())
    check(same, f"age_pixel_rows differs from its plain version ({err})")
    res = {"max_abs_err": err, "rows": q.shape[0], "p_pad": q.shape[1],
           "aged_rows": int((age > 0).sum())}
    res.update(time_pair(lambda: kernels.age_pixel_rows_plain(q, geff, pi),
                         lambda: kernels.age_pixel_rows(q, geff, pi)))
    res.update(roofline(2 * nbytes(q) + nbytes(geff, pi)))
    copies = [q] + [q.clone() for _ in range(cold_copies(res["bytes"]) - 1)]
    res["cold_ms"] = cold_device_ms(
        [lambda c=c: kernels.age_pixel_rows(c, geff, pi) for c in copies])
    res["cold_copies"] = len(copies)
    leaf = (q, age)
    res["materialize_ms"] = {
        name: device_ms(lambda now=now: sensor.materialize_occlusion(
            leaf, now))
        for name, now in (("crossing", torch.tensor(True, device=dev)),
                          ("not_crossing",
                           torch.tensor(False, device=dev)))}
    return res


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


# ---------------------------------------------------------------------------
# graph: the compiled step (CUDA-graph replays) against the eager step
# ---------------------------------------------------------------------------

def belief_leaves(tracker):
    """Every tensor of the tracker's belief, or of all its trial's."""
    beliefs = (tracker._trial["beliefs"] if tracker._trial
               else [tracker.belief])
    out = []
    for b in beliefs:
        for f in dataclasses.fields(b):
            v = getattr(b, f.name)
            out += list(v) if isinstance(v, (tuple, list)) else [v]
    return [v for v in out if v is not None]


def graph_lockstep(make, init, frames):
    """A captured and an eager tracker (``make(capture)``, ``init``) over
    the same ``frames`` in lockstep: the largest difference of the poses
    and of the beliefs after each frame, each one's launches per frame,
    and the captured one's position RMSE."""
    trs = {c: make(c) for c in (True, False)}
    for tr in trs.values():
        init(tr)
    per_frame = {True: [], False: []}
    d_pose = d_belief = 0.0
    err = []
    for frame in frames:
        poses = {}
        for c, tr in trs.items():
            before = {k: w.launches for k, w in WRAPPERS.items()}
            poses[c], _ = tr.track(frame.depth)
            per_frame[c].append({k: w.launches - before[k]
                                 for k, w in WRAPPERS.items()})
        d_pose = max(d_pose, float((poses[True] - poses[False]).abs().max()))
        for a, b in zip(belief_leaves(trs[True]), belief_leaves(trs[False])):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  "graph: captured and eager beliefs differ in layout")
            d_belief = max(d_belief,
                           float((a.float() - b.float()).abs().max()))
        p = poses[True].reshape(-1, 7).cpu().numpy()
        truth = np.asarray(frame.ground_truth).reshape(-1, 7)
        err.append(np.linalg.norm(p[:, :3] - truth[:, :3], axis=1))
    rmse = np.sqrt(np.mean(np.square(err), axis=0)).tolist()
    return trs, per_frame, d_pose, d_belief, rmse


def graph_path(name, make, init, frames, depth):
    """One path of the graph phase (see the module docstring)."""
    t0 = time.perf_counter()
    for w in WRAPPERS.values():
        w.launches = 0
    trs, per_frame, d_pose, d_belief, rmse = graph_lockstep(make, init,
                                                            frames)
    launches = {k: sum(f[k] for f in per_frame[True]) for k in WRAPPERS}
    check(per_frame[True] == per_frame[False],
          f"graph {name}: launches per frame under replay "
          f"{per_frame[True]} differ from the eager step's "
          f"{per_frame[False]}")
    check(d_pose <= GRAPH_ATOL and d_belief <= GRAPH_ATOL,
          f"graph {name}: captured against eager: poses {d_pose}, "
          f"belief {d_belief}")
    check(max(rmse) < RMSE_LIMIT_M,
          f"graph {name}: position RMSE {rmse} m >= {RMSE_LIMIT_M}")
    stats = {"programs": len(trs[True].programs)}
    for prog in trs[True].programs.values():
        for k, v in prog.stats().items():
            stats[k] = stats.get(k, 0) + v
    # timed in turns (captured, eager, eager, captured), then profiled
    turns = [(c, track_ms(trs[c], depth, runs=GRAPH_TIMING_RUNS))
             for c in (True, False, False, True)]
    out = {"frames": len(frames), "position_rmse_m": rmse,
           "max_abs_diff_poses": d_pose, "max_abs_diff_belief": d_belief,
           "launches": launches,
           "launches_per_frame": {
               json.dumps(f, sort_keys=True): per_frame[True].count(f)
               for f in per_frame[True]},
           **stats}
    GRAPH_PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    for c, mode in ((True, "captured"), (False, "eager")):
        pair = [t for k, t in turns if k == c]
        out[mode] = {"track_ms_median": statistics.mean(
            t["track_ms_median"] for t in pair),
            "track_ms_median_by_turn": [t["track_ms_median"] for t in pair],
            "track_ms_p90": statistics.mean(t["track_ms_p90"] for t in pair),
            "profile": profile_steps(
                trs[c], depth, GRAPH_PROFILE_DIR / f"{name}_{mode}.txt")}
    out["median_ratio_eager_to_captured"] = (
        out["eager"]["track_ms_median"] / out["captured"]["track_ms_median"])
    out["seconds"] = time.perf_counter() - t0
    del trs
    return out, launches


def trial_init(hypotheses, **kw):
    """``initialize`` with a trial that outlasts the phase (the first
    hypothesis, the truth, is published)."""
    def init(tr):
        tr.initialize(hypotheses[0], hypotheses=hypotheses,
                      trial_frames=GRAPH_TRIAL_FRAMES, **kw)
    return init


def phase_graph(dev, card):
    """The compiled step against the eager step on each path (see the
    module docstring): the slice, two objects, a 4-island trial, the
    Gaussian tracker at 3 and 6 iterations and its frozen trial, the
    "deferred" particle sensor."""
    cam, mesh, traj = slice_scene()
    ocam, omeshes, otraj = objects_scene()
    slack = box_slack()

    def frames_of(meshes, c, tr):
        src = sources.SyntheticSource(meshes, c.to(dev), tr,
                                      GRAPH_FRAMES + 1, seed=SEED)
        frames = list(src)
        return frames[:GRAPH_FRAMES], frames[GRAPH_FRAMES].depth

    frames, depth = frames_of([mesh], cam, traj)
    oframes, odepth = frames_of(omeshes, ocam, otraj)
    hyp = np.repeat(traj(0)[None], len(GRAPH_TRIAL_OFFSETS_M), axis=0)
    hyp[:, 0, 0] += GRAPH_TRIAL_OFFSETS_M

    def particle(conf, meshes, c):
        return lambda capture: ParticleTracker(
            conf, meshes=meshes, camera=c, device=dev, capture=capture)

    def gaussian(conf):
        return lambda capture: GaussianTracker(
            conf, meshes=[mesh], camera=cam, device=dev, capture=capture)

    first = frames[0].depth
    paths = {
        "slice": (particle(slice_config(), [mesh], cam),
                  lambda tr: tr.initialize(traj(0)), frames, depth),
        "objects": (particle(objects_config(slack), omeshes, ocam),
                    lambda tr: tr.initialize(otraj(0)), oframes, odepth),
        "trial_4_islands": (particle(slice_config(), [mesh], cam),
                            trial_init(hyp), frames, depth),
        "rgf_3": (gaussian(rgf_config()),
                  lambda tr: tr.initialize(traj(0), first_frame=first),
                  frames, depth),
        "rgf_6": (gaussian(rgf_config(update_iterations=6,
                                      trust_sigma=1.5)),
                  lambda tr: tr.initialize(traj(0), first_frame=first),
                  frames, depth),
        "rgf_3_trial_4": (gaussian(rgf_config()),
                          trial_init(hyp[:, 0], first_frame=first),
                          frames, depth),
        "deferred": (particle(deferred_config(), [mesh], cam),
                     lambda tr: tr.initialize(traj(0)), frames, depth),
    }
    out, total = {}, {k: 0 for k in WRAPPERS}
    for name, (make, init, fr, d) in paths.items():
        out[name], launches = graph_path(name, make, init, fr, d)
        for k in WRAPPERS:
            total[k] += launches[k]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    emit({"phase": "graph", "nvidia_smi": card, "particles": P,
          "pixels": cam.num_pixels, "triangles": mesh.padded_triangles,
          "tolerance": GRAPH_ATOL, "paths": out,
          "graph_launches": total})
    return total


# ---------------------------------------------------------------------------
# objects: two tracked objects at the slice's width
# ---------------------------------------------------------------------------

def box_slack():
    """The automatic slack rule (ops/slack.py: 0.25 px of footprint) at
    the box's depth in the box's own barycentric units (0.0506): the
    fixed slack of the phase's reading. The sensor's automatic slack
    (the checked run) gives each object its own: the box this, the
    sphere 0.32 in units of its 9.4 mm edges."""
    box = box_mesh(*OBJECTS_BOX)
    fx = float(default_kinect_camera(8).camera_matrix[0, 0])
    return float(slack_mod.auto_bary_slack(
        torch.tensor(OBJECTS_BOX_Z), 1.0 / fx, slack_mod.median_edge([box])))


def objects_config(bary_slack=None):
    """The slice's configuration with the eval suite's process noise for
    its moving objects (benchmarks/eval_suite.py:147-149): the box moves
    at 0.11 m/s, which the slice's (0.1 m/s^1.5, damping 4) cannot
    follow; ``bary_slack`` None keeps the automatic slack."""
    conf = slice_config()
    conf.transition = cfg.TransitionConfig(0.4, 2.5, damping=6.0)
    if bary_slack is not None:
        conf.backend_options = {"bary_slack": bary_slack}
    return conf


def objects_scene():
    """The slice's camera and sphere (its trajectory) and the eval suite's
    box (benchmarks/eval_suite.py:57-62), which crosses in front of the
    sphere from right to left over the run, turning about x, its centre
    OBJECTS_BOX_Z (its back face 5 mm before the sphere's nearest point:
    the eval suite's 6 cm between centres would put the box inside this
    larger sphere). Its centre passes the sphere's at frame
    OBJECTS_CROSS_FRAME."""
    cam, sphere, sphere_traj = slice_scene()
    box = box_mesh(*OBJECTS_BOX)

    def traj(t):
        th = OBJECTS_BOX_SPIN * t
        box_pose = [OBJECTS_BOX_X0 - OBJECTS_BOX_SPEED * t, 0.01,
                    OBJECTS_BOX_Z, np.cos(th / 2), np.sin(th / 2), 0, 0]
        return np.concatenate([sphere_traj(t), [box_pose]]).astype(
            np.float32)

    return cam, [sphere, box], traj


def copy_leaf(occ, device=None):
    """A copy of an occlusion leaf (on ``device``): the sensor writes the
    map in place."""
    return (tuple(x.to(device).clone() for x in occ)
            if isinstance(occ, (tuple, list)) else occ.to(device).clone())


def clone_belief(belief, device=None):
    """A copy of a belief (on ``device``), its occlusion map included."""
    return rbcpf.ParticleBelief(belief.states.to(device).clone(),
                                belief.log_weights.to(device).clone(),
                                copy_leaf(belief.occlusion, device))


def objects_against_cpu(dev, tracker, belief, depth, conf):
    """One filter step (what ``track`` runs) from ``belief`` on the card
    and on the CPU (the kernels' plain versions), with the same
    ``BlockNoise`` draws for both blocks: the model-frame poses of the
    two."""
    cpu = torch.device("cpu")
    cam, meshes, _ = objects_scene()
    g = torch.Generator().manual_seed(SEED + 7)
    n = belief.states.shape[0]
    noise = [(torch.randn((n, 6), generator=g),
              torch.randn((n, 6), generator=g), torch.rand((), generator=g))
             for _ in meshes]
    poses = {}
    for d in (dev, cpu):
        tr = tracker if d == dev else ParticleTracker(
            conf, meshes=meshes, camera=cam, device=cpu)
        z = preprocess_depth(torch.as_tensor(depth, device=d).reshape(-1))
        _, info = rbcpf.rbcpf_step(
            clone_belief(belief, d), z, tr.sensor, tr.trans_params,
            tr._dt, max_kl_divergence=tr.config.max_kl_divergence,
            noise=[rbcpf.BlockNoise(e1.to(d), e2.to(d), u.to(d))
                   for e1, e2, u in noise])
        poses[d.type] = base.to_model_frame(info.mean_state[:, :7],
                                            tr.centers).cpu()
    a, b = poses["cuda" if dev.type == "cuda" else "cpu"], poses["cpu"]
    pos = float(torch.linalg.norm(a[:, :3] - b[:, :3], dim=1).max())
    rot = float(torch.linalg.norm(se3.quat_boxminus(a[:, 3:7], b[:, 3:7]),
                                  dim=1).max())
    check(pos <= OBJECTS_POS_ATOL_M and rot <= OBJECTS_ROT_ATOL_RAD,
          f"objects: card against cpu on the crossing frame: {pos} m, "
          f"{rot} rad")
    return {"frame": OBJECTS_CROSS_FRAME, "max_pos_err_m": pos,
            "max_rot_err_rad": rot}


def objects_run(dev, conf, on_frame=None):
    """The two-object tracker with ``conf`` over the phase's 60 frames:
    (tracker, source, traj, run, each object's position RMSE over the
    last OBJECTS_LAST_FRAMES frames)."""
    cam, meshes, traj = objects_scene()
    tracker = ParticleTracker(conf, meshes=meshes, camera=cam, device=dev)
    source = sources.SyntheticSource(meshes, tracker.camera, traj, FRAMES,
                                     seed=SEED)
    run = node.run(tracker, source,
                   on_frame=on_frame(tracker) if on_frame else None)
    err = run.position_errors()[-OBJECTS_LAST_FRAMES:]
    return (tracker, source, traj, run,
            np.sqrt(np.mean(err ** 2, axis=0)).tolist())


def phase_objects(dev, slice_tracker, slice_depth):
    """Two objects through ``node.run`` (see the module docstring)."""
    torch.cuda.synchronize()
    # a reading, not a check: the same run with one fixed slack, the
    # box's own automatic one, for both meshes
    slack = box_slack()
    fixed_rmse = objects_run(dev, objects_config(slack))[4]
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    per_frame, levels, saved = [], [], {}

    def watch(tracker):
        def on_frame(frame, poses, info):
            per_frame.append({k: w.launches for k, w in WRAPPERS.items()})
            levels.append(tracker.sensor.last_level)
            if frame.index == OBJECTS_CROSS_FRAME - 1:
                saved["belief"] = clone_belief(tracker.belief)
            if frame.index == OBJECTS_CROSS_FRAME:
                saved["depth"] = frame.depth
        return on_frame

    for w in WRAPPERS.values():
        w.launches = 0
    tracker, source, traj, run, rmse = objects_run(
        dev, objects_config(), watch)
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    check(tracker.sensor.bary_slack is None,
          "objects: the checked run does not take the automatic slack")
    tri_slack = tracker.sensor.triangle_slack(tracker.belief.states)
    first = np.cumsum([0] + [m.padded_triangles
                             for m in tracker.meshes[:-1]]).tolist()
    auto_slack = [float(tri_slack[i]) for i in first]
    prev = {k: 0 for k in WRAPPERS}
    for i, counts in enumerate(per_frame):
        got = {k: counts[k] - prev[k] for k in WRAPPERS}
        check(got == OBJECTS_LAUNCHES_PER_FRAME,
              f"objects: frame {i} launched {got}, expected "
              f"{OBJECTS_LAUNCHES_PER_FRAME}")
        prev = counts
    check(len(per_frame) == FRAMES and run.poses.shape == (FRAMES, 2, 7)
          and np.all(np.isfinite(run.poses)), "objects: bad pose output")
    check(max(rmse) < RMSE_LIMIT_M,
          f"objects: position RMSE {rmse} m over the last "
          f"{OBJECTS_LAST_FRAMES} frames")
    versus = objects_against_cpu(dev, tracker, saved["belief"],
                                 saved["depth"], tracker.config)
    del saved

    depth = source.render(torch.as_tensor(traj(FRAMES), device=dev)).cpu()
    times = in_turns({"two": (tracker, depth), "one": (slice_tracker,
                                                        slice_depth)},
                     lambda td: track_ms(*td))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tracker.track(depth)
    torch.cuda.synchronize()
    step_extra = torch.cuda.max_memory_allocated() - held
    emit({"phase": "objects", "particles": P, "objects": 2,
          "triangles": [m.padded_triangles for m in tracker.meshes],
          "pixels": tracker.camera.num_pixels, "frames": FRAMES,
          "launches": launches,
          "launches_per_frame": OBJECTS_LAUNCHES_PER_FRAME,
          "levels_taken": {str(lv): levels.count(lv)
                           for lv in sorted(set(levels))},
          "bary_slack": "automatic, per object",
          "auto_slack_last_frame": auto_slack,
          "median_edges_m": [slack_mod.median_edge([m])
                             for m in tracker.meshes],
          "position_rmse_m_last_frames": rmse,
          "fixed_slack": slack,
          "fixed_slack_position_rmse_m_last_frames": fixed_rmse,
          "last_frames": OBJECTS_LAST_FRAMES,
          "position_rmse_m_all_frames": np.sqrt(np.mean(
              run.position_errors() ** 2, axis=0)).tolist(),
          "resampled_frames": run.metrics.resample_count(),
          "against_cpu": versus,
          "track_ms_two_objects": times["two"],
          "track_ms_one_object": times["one"],
          "median_ratio": times["two"]["track_ms_median"]
          / times["one"]["track_ms_median"],
          "timed_in_turns": "two, one, one, two",
          "held_mem_bytes": held - held_before,
          "step_extra_mem_bytes": step_extra})
    return launches


# ---------------------------------------------------------------------------
# options: the fused sensor's options at the slice's width
# ---------------------------------------------------------------------------

def sensor_frames(sensor, states, occ, frames, dt):
    """``sensor`` over ``frames`` from ``occ``: the logliks (F, P), the
    last leaf, the levels taken and the row kernels' launches."""
    before = {k: WRAPPERS[k].launches for k in ROW_KERNELS}
    lls, levels = [], []
    for z in frames:
        ll, occ = sensor(states, occ, z, dt)
        lls.append(ll)
        levels.append(sensor.last_level)
    return (torch.stack(lls), occ, levels,
            {k: WRAPPERS[k].launches - before[k] for k in ROW_KERNELS})


def equal_leaves(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def exact_candidate_depth(mesh, poses, cand, rays, slack=0.0, chunk=1000):
    """(P, N) depth of each particle's intersection with its pixel's
    candidate triangles, the inside-test widened by ``slack`` barycentric
    units (0: exact), in particle chunks: the plain-PyTorch oracle of
    tests/test_pallas.py's multi-object test."""
    out = []
    for i in range(0, poses.shape[0], chunk):
        G, tn = raycast.pose_tri_constants(mesh, poses[i:i + chunk])
        t = None
        for k in range(cand.shape[1]):
            nums = torch.einsum("nd,pnid->pni", rays, G[:, cand[:, k]])
            tk = raycast._intersect_from_numerators(
                nums[..., 0], nums[..., 1], nums[..., 2], tn[:, cand[:, k]],
                slack=slack)
            t = tk if t is None else torch.minimum(t, tk)
        out.append(t)
    return torch.cat(out)


def edge_particles(mesh, poses, cand, rays):
    """The particles with a ray within ``SLACK0_EDGE`` barycentric units of
    a candidate's edge: their hits differ between the inside-test
    narrowed and widened by that much, so two float32 computations of the
    exact test may disagree on them."""
    lo, hi = (exact_candidate_depth(mesh, poses, cand, rays, s)
              for s in (-SLACK0_EDGE, SLACK0_EDGE))
    return ((lo != hi) & (torch.isfinite(lo) | torch.isfinite(hi))).any(1)


def bimodal_states(states, gap):
    """The belief's particles split into two blocks ``gap`` apart in x
    (the first half moved by −gap/2, the second by +gap/2), and the two
    modes' poses (the unweighted mean of each block)."""
    out = states.clone()
    half = states.shape[0] // 2
    out[:half, :, 0] -= gap / 2
    out[half:, :, 0] += gap / 2
    modes = [se3.states_mean(out[:half, 0])[:7],
             se3.states_mean(out[half:, 0])[:7]]
    return out, modes


def mode_coverage(sensor, states, modes):
    """Per mode: the share of its exact silhouette's pixels (a raycast of
    the mode's pose) whose candidate set is not all degenerate
    (``candidate``), and whose set holds the triangle that raycast hits
    there (``exact_triangle``)."""
    cand = sensor.candidates(states)
    deg = sensor.union_triangles - 1
    out = []
    for pose in modes:
        _, ids = deferred.raycast_ids(sensor.meshes[0], pose,
                                      sensor.camera.rays)
        sil = ids >= 0
        out.append({
            "silhouette_pixels": int(sil.sum()),
            "candidate": float((cand != deg).any(1)[sil].float().mean()),
            "exact_triangle": float((cand == ids[:, None]).any(1)[sil]
                                    .float().mean())})
    return out


def select_gather_times(dev, occ_post, slot):
    """The select merge's inverse row gather (every pixel's row out of the
    compacted posterior), warm and cold, beside ``index_select`` on the
    same copies and a device copy of as many rows."""
    slot32 = slot.to(torch.int32).contiguous()
    slot64 = slot.long()
    got = kernels.gather_pixel_rows(occ_post, slot32)
    check(torch.equal(got, kernels.gather_pixel_rows_plain(occ_post, slot32)),
          "options: the select merge's gather differs from its plain "
          "version")
    rows_read = int(slot.unique().numel())
    per_call = (rows_read * occ_post.shape[1] * occ_post.element_size()
                + nbytes(got, slot32))
    res = {"rows": slot.numel(), "source_rows": occ_post.shape[0],
           "source_rows_read": rows_read, "max_abs_err": 0.0}
    res.update(time_pair(
        lambda: kernels.gather_pixel_rows_plain(occ_post, slot32),
        lambda: kernels.gather_pixel_rows(occ_post, slot32),
        library=lambda: occ_post.index_select(0, slot64)))
    res.update(roofline(per_call))
    res["copy_ms"] = device_ms(lambda: got.clone())
    srcs = [occ_post.clone() for _ in range(cold_copies(
        2 * nbytes(got)))]
    res.update(cold_pair(
        [lambda s=s: kernels.gather_pixel_rows(s, slot32) for s in srcs],
        [lambda s=s: s.index_select(0, slot64) for s in srcs]))
    res["cold_copies"] = len(srcs)
    return res


def phase_options(dev):
    """The fused sensor's options (see the module docstring)."""
    torch.cuda.synchronize()
    tracker, source, traj = make_slice(dev, OPTIONS_TRACKED_FRAMES)
    node.run(tracker, source)
    states = tracker.belief.states
    leaf = tracker.belief.occlusion
    cam, mesh = tracker.camera, tracker.meshes[0]
    bp, op, dt = tracker.beam_params, tracker.occ_params, tracker._dt
    frames = [depth_of(source, traj, OPTIONS_TRACKED_FRAMES + i, dev)
              for i in range(OPTIONS_FRAMES)]

    def make(op=op, **opts):
        return fs.make_fused_sensor(mesh, cam, bp, op, device=dev, **opts)

    for w in WRAPPERS.values():
        w.launches = 0
    out = {}
    # select against scatter, the single-level caps against levels
    pairs = {"select_vs_scatter": (dict(merge="select"), {}),
             "caps_vs_levels": (dict(active_cap_frac=1 / 12,
                                     tri_cap_frac=0.2),
                                dict(levels=[(1 / 12, 0.2)]))}
    for name, (oa, ob) in pairs.items():
        a = sensor_frames(make(**oa), states, copy_leaf(leaf), frames, dt)
        b = sensor_frames(make(**ob), states, copy_leaf(leaf), frames, dt)
        check(torch.equal(a[0], b[0]) and equal_leaves(a[1], b[1])
              and a[2] == b[2],
              f"options: {name}: loglik or map not bit-equal")
        out[name] = {"levels": a[2], "row_launches": [a[3], b[3]],
                     "bit_equal": True}
    check(out["select_vs_scatter"]["row_launches"][0]["gather_pixel_rows"]
          == 2 * OPTIONS_FRAMES, "options: the select merge did not gather "
          "twice a frame")

    # the exact inside-test against the exact intersection of the same
    # candidate sets (float32 map, fresh)
    exact = make(bary_slack=0.0, occ_dtype=torch.float32)
    prior = float(op.initial_occlusion_prob)
    ll, _ = exact(states, exact.init_occlusion(P, prior), frames[0], dt)
    depth = exact_candidate_depth(mesh, states[:, 0, :7],
                                  exact.candidates(states), cam.rays)
    ll_ref, _ = image_loglik(depth, frames[0], torch.full_like(depth, prior),
                             bp, op, float(np.float32(dt)
                                           * np.float32(exact.frame_rate)))
    # the kernel's pixel padding counts as invalid background returns
    pad = fs._round_up(cam.num_pixels, exact.nb) - cam.num_pixels
    ll_ref = ll_ref + pad * torch.log(bp.p_invalid_background)
    err = (ll - ll_ref).abs()
    off = err > SLACK0_ATOL + SLACK0_RTOL * ll_ref.abs()
    edge = edge_particles(mesh, states[:, 0, :7], exact.candidates(states),
                          cam.rays)
    check(not bool((off & ~edge).any()),
          f"options: bary_slack=0 off the exact intersection by "
          f"{float(err[~edge].max())} on a particle with no ray at an edge")
    out["exact_slack_vs_oracle"] = {
        "max_abs_err": float(err[~edge].max()),
        "max_abs_err_edge_particles": float(err.max()),
        "edge_particles": int(edge.sum()),
        "edge_particles_off": int((off & edge).sum()),
        "level": exact.last_level,
        "tolerance": f"rtol {SLACK0_RTOL}, atol {SLACK0_ATOL} on particles "
                     f"with no ray within {SLACK0_EDGE} of an edge"}
    del depth

    # reference_poses: a collapsed cloud (every particle at the mean, where
    # all four references are one pose: the reference's own check), the
    # tracked cloud, and a bimodal one
    collapsed = se3.states_mean(states[:, 0])[None, None].expand(
        P, 1, 13).contiguous()
    refs = {}
    for R in (1, 4):
        s = make(reference_poses=R)
        refs[R] = {"collapsed": s(collapsed, s.init_occlusion(P, prior),
                                  frames[0], dt)[0],
                   "tracked": s(states, copy_leaf(leaf), frames[0], dt)[0],
                   "tracked_cand": s.candidates(states), "sensor": s}
    d_col = float((refs[4]["collapsed"] - refs[1]["collapsed"]).abs().max())
    check(d_col <= 1e-5, f"options: reference_poses=4 against 1 on a "
          f"collapsed cloud: {d_col}")
    two, modes = bimodal_states(states, OPTIONS_MODE_GAP_M)
    cover = {R: mode_coverage(refs[R]["sensor"], two, modes) for R in (1, 4)}
    check(all(m["candidate"] >= OPTIONS_MODE_COVERAGE for m in cover[4]),
          f"options: reference_poses=4 covers the modes at {cover[4]}")
    out["reference_poses"] = {
        "collapsed_max_abs_diff": d_col,
        "tracked_max_abs_diff": float(
            (refs[4]["tracked"] - refs[1]["tracked"]).abs().max()),
        "tracked_candidate_pixels_differing": int(
            (refs[4]["tracked_cand"] != refs[1]["tracked_cand"]).any(1)
            .sum()),
        "bimodal_gap_m": OPTIONS_MODE_GAP_M,
        "bimodal_coverage": {f"R={R}": c for R, c in cover.items()}}
    del refs

    # g < 0: the eager compacted branch against the full level
    op_neg = occlusion.make_occlusion_params(*OPTIONS_NEG_CHAIN,
                                             device=dev)
    eager_out = {}
    for dtype in (torch.float32, torch.bfloat16):
        e_s = make(op_neg, occ_dtype=dtype)
        f_s = make(op_neg, occ_dtype=dtype, levels=[(1.0, 1.0)])
        e = sensor_frames(e_s, states, e_s.init_occlusion(P, prior),
                          frames, dt)
        f = sensor_frames(f_s, states, f_s.init_occlusion(P, prior),
                          frames, dt)
        check(all(lv < len(e_s.caps(cam.num_pixels)) for lv in e[2])
              and all(v == OPTIONS_FRAMES for v in e[3].values()),
              f"options: g < 0 took levels {e[2]}, row launches {e[3]}")
        ll_err = (e[0] - f[0]).abs()
        check(bool((ll_err <= 1e-2 + 2e-5 * f[0].abs()).all()),
              f"options: g < 0 eager loglik off by {float(ll_err.max())}")
        res = {"levels": e[2], "row_launches": e[3],
               "ll_max_abs_err": float(ll_err.max())}
        if dtype == torch.float32:
            occ_err = float((e[1] - f[1]).abs().max())
            check(occ_err <= 1e-5, f"options: g < 0 map off by {occ_err}")
            res["occ_max_abs_err"] = occ_err
        else:
            ulps = int((e[1].view(torch.int16).int()
                        - f[1].view(torch.int16).int()).abs().max())
            check(ulps <= OCC_ULPS, f"options: g < 0 map off by {ulps} ulps")
            res["occ_max_ulps"] = ulps
        eager_out[str(dtype).split(".")[-1]] = res
    out["negative_chain"] = eager_out
    launches = {k: w.launches for k, w in WRAPPERS.items()}

    # device ms of one call's device work on each route (CUDA graphs:
    # the plan, with its host read, is made once outside)
    routes = {}
    for name, opts in (("eager_ms", {}), ("full_ms",
                                          dict(levels=[(1.0, 1.0)]))):
        s = make(op_neg, **opts)
        q = s.init_occlusion(P, prior)
        plan = s.plan(states, frames[0], dt)
        routes[name] = (lambda s=s, q=q, plan=plan:
                        s.apply(plan, states, q, frames[0]))
    timing = in_turns(routes, device_ms)
    # the select merge's gather at the tight level, and its whole merge
    s = make(merge="select")
    plan = s.plan(states, frames[0], dt)
    pcap = s.caps(cam.num_pixels)[plan.level][0]
    n_pad = fs._round_up(cam.num_pixels, s.nb)
    slot = torch.cat([torch.clamp(plan.book["slot"], 0, pcap - 1),
                      plan.book["slot"].new_zeros(
                          (n_pad - cam.num_pixels,))])
    occ_post = torch.rand((pcap, leaf[0].shape[1]), device=dev).to(
        leaf[0].dtype)
    timing["select_gather"] = select_gather_times(dev, occ_post, slot)
    q = copy_leaf(leaf)
    scatter = make()
    timing.update(in_turns({
        "select_merge_call_ms": lambda: s.apply(plan, states, q, frames[0]),
        "scatter_merge_call_ms": lambda: scatter.apply(plan, states, q,
                                                       frames[0])},
        device_ms))
    emit({"phase": "options", "particles": P, "tracked_frames":
          OPTIONS_TRACKED_FRAMES, "frames": OPTIONS_FRAMES,
          "launches": launches, "results": out, "times": timing})
    return launches


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
    renderer covers on the first sigma cloud of one more tracked frame.
    The frame is stepped by an eager twin from the tracker's belief: a
    graph replay calls no Python, so the render cannot be watched
    there."""
    twin = GaussianTracker(tracker.config, meshes=tracker.meshes,
                           camera=tracker.camera, device=tracker.device,
                           capture=False)
    twin.restore(tracker.belief)
    seen = []
    render = twin.render_fn
    twin.render_fn = lambda poses: (seen.append(poses), render(poses))[1]
    twin.track(depth)
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
    """``rgf.make_batched_step`` over BATCHED_SCENES stacked scenes as its
    JAX callers jit it: through ``graphs.compiled`` with the beliefs
    donated, captured against eager (``capture=False``) over
    BATCHED_FRAMES frames bit for bit, then ms per step of both in turns
    (captured, eager, eager, captured); scene 0 of the eager step against
    the tracker's single step."""
    tracker = GaussianTracker(rgf_config(), meshes=[mesh], camera=cam,
                              device=dev)
    frames = list(sources.SyntheticSource([mesh], cam, traj,
                                          BATCHED_FRAMES + 1, seed=SEED))
    tracker.initialize(traj(0), first_frame=frames[0].depth)
    conf = tracker.config
    plain = rgf.make_batched_step(
        tracker.render_fn, tracker.trans_params, tracker._dt,
        tracker.beam_params, iterations=conf.update_iterations,
        trust_sigma=conf.trust_sigma, occ_params=tracker._occ_params)
    steps = {c: graphs.compiled(plain, dev, c, donate=True)
             for c in (True, False)}
    start = rgf.stack_beliefs([tracker.belief] * BATCHED_SCENES)
    beliefs = {c: dataclasses.replace(start, **{
        f.name: getattr(start, f.name).clone()
        for f in dataclasses.fields(start)
        if getattr(start, f.name) is not None}) for c in steps}
    diff = 0.0
    for i, frame in enumerate(frames[1:]):
        zs = torch.stack([tracker._frame(frame.depth)] * BATCHED_SCENES)
        out = {c: step(beliefs[c], zs) for c, step in steps.items()}
        for a, b in zip(leaves_of(list(out[True])),
                        leaves_of(list(out[False]))):
            diff = max(diff, bit_diff(a, b))
        if i == 0:
            single, _ = tracker._step(tracker.belief, zs[0], tracker._dt)
            err = float((out[False][0].mean[0] - single.mean).abs().max())
        beliefs = {c: o[0] for c, o in out.items()}
    check(diff <= GRAPH_ATOL,
          f"batched step: captured against eager {diff}")
    check(err <= 1e-5, f"batched step differs from the single step: {err}")
    ms = {True: [], False: []}
    for c in (True, False, False, True):
        for i in range(WARMUP + 10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            beliefs[c], _ = steps[c](beliefs[c], zs)
            torch.cuda.synchronize()
            if i >= WARMUP:
                ms[c].append(1e3 * (time.perf_counter() - t0))
    out = {"scenes": BATCHED_SCENES, "frames": BATCHED_FRAMES,
           "tolerance": GRAPH_ATOL, "max_abs_diff_captured_eager": diff,
           "max_abs_err_vs_single": err,
           **steps[True].program.stats()}
    for c, mode in ((True, "captured"), (False, "eager")):
        med = statistics.median(ms[c])
        out[mode] = {"ms_per_step": med,
                     "ms_per_scene": med / BATCHED_SCENES}
    return out


def rgf_reanchor(dev, tracker, mesh, traj):
    """One re-anchor of the Gaussian tracker at the slice's width: the
    tracker (last tracked on frame ``FRAMES``) gets frame ``FRAMES +
    RGF_GAP_SKIPPED + 1``, reporting the frames between as dropped, as a
    push source reports a 5 s search's (``node.run``'s gap rule), and the
    same belief propagated over the damping time tracks that frame too.
    The tracked pose must be within ``RMSE_LIMIT_M`` and nearer than the
    capped propagation's; the ms are the process's first Gaussian
    re-anchor's."""
    t = FRAMES + RGF_GAP_SKIPPED + 1
    truth = traj(t)
    depth = sources.SyntheticSource([mesh], tracker.camera, traj, 1,
                                    seed=SEED).render(
        torch.as_tensor(truth, device=dev)).cpu()
    saved = dataclasses.replace(tracker.belief, **{
        f.name: getattr(tracker.belief, f.name).clone()
        for f in dataclasses.fields(tracker.belief)
        if getattr(tracker.belief, f.name) is not None})
    run = node.run(tracker, [sources.Frame(t, depth, truth,
                                           skipped=RGF_GAP_SKIPPED)])
    check([r.frame for r in run.reanchors] == [t],
          f"rgf: frame {t} after {RGF_GAP_SKIPPED} dropped frames was not "
          f"re-anchored ({run.reanchors}, {run.unanchored_frames})")
    r = run.reanchors[0]
    tracker.restore(saved)
    capped, _ = tracker.track(depth, dt=0.25)

    def err(poses):
        return float(np.linalg.norm(
            np.asarray(poses, np.float32).reshape(-1, 7)[0, :3]
            - truth[0, :3]))

    out = {"frame": t, "skipped": RGF_GAP_SKIPPED, "ms": 1e3 * r.seconds,
           "error_before_m": err(r.before), "error_after_m": err(r.after),
           "tracked_error_m": err(run.poses[0]),
           "capped_error_m": err(capped.cpu())}
    check(out["tracked_error_m"] < RMSE_LIMIT_M
          and out["tracked_error_m"] < out["capped_error_m"],
          f"rgf: the re-anchored frame: {out}")
    return out


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
    reanchor = rgf_reanchor(dev, trackers["three"], mesh, traj)
    del trackers, tracker

    chunk = sensor_chunk(dev, cam)
    emit({"phase": "rgf", "pixels": cam.num_pixels,
          "triangles": mesh.padded_triangles, "sigma_points": 25,
          "frames": FRAMES, "iterations": 3, **res["three"],
          "launches": launches,
          "six_iterations": {"trust_sigma": 1.5, **res["six"],
                             "track_ms_ratio_to_three": ratio},
          "steady_state_coverage": coverage,
          "reanchor": reanchor,
          "card_vs_cpu": rgf_against_cpu(dev, cam, mesh, traj),
          "select": select_times(dev, cam, mesh, traj,
                                 ((25, 6), (chunk, 4))),
          "batched_step": batched_step_ms(dev, cam, mesh, traj)})


def sensor_chunk(dev, cam):
    """The particle chunk the memory budget gives the "deferred" sensor
    at the slice's size."""
    from dbot_ros_tpu_torch.ops.budget import deferred_particle_chunk
    return deferred_particle_chunk(P, cam.num_pixels, 4, device=dev)


def deferred_config():
    return cfg.ParticleTrackerConfig(
        evaluation_count=P, backend="deferred", seed=SEED,
        transition=cfg.TransitionConfig(0.1, 0.5, damping=4.0))


def phase_deferred(dev):
    """The particle tracker with the candidate-set ("deferred") sensor at
    the slice's width (see the module docstring)."""
    cam, mesh, traj = slice_scene()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    for w in WRAPPERS.values():
        w.launches = 0
    tracker = ParticleTracker(deferred_config(), meshes=[mesh], camera=cam,
                              device=dev)
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
    eager = sources.OracleSource(mesh, native_cam, traj, LIVE_FRAMES,
                                 edge_artifacts=0.3, quantize_mm=True,
                                 seed=SEED, capture=False)
    check(oracle._render.program.capture, "live: the render is eager")
    adapter = sources.U16CameraAdapter(oracle, 8)
    frames, render_ms, u16_ms, eager_ms = [], [], [], []
    for t in range(LIVE_FRAMES):
        poses, occ, p_drop = oracle.frame_inputs(t)
        args = (torch.as_tensor(poses, device=dev),
                torch.as_tensor(occ, device=dev), p_drop, oracle.draw())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = oracle.render(*args).cpu().numpy()
        t1 = time.perf_counter()
        depth = adapter.convert(z)
        t2 = time.perf_counter()
        frames.append(sources.Frame(t, depth, poses))
        render_ms.append(1e3 * (t1 - t0))
        u16_ms.append(1e3 * (t2 - t1))
        if t < LIVE_EAGER_FRAMES:
            # the same draws through the eager render
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ze = eager.render(*args).cpu().numpy()
            eager_ms.append(1e3 * (time.perf_counter() - t0))
            if t < LIVE_EAGER_CHECKED:
                check(np.array_equal(z, ze, equal_nan=True),
                      f"live: captured render differs from eager on "
                      f"frame {t}")
    return frames, native_cam, render_ms, u16_ms, eager_ms


class NotedService(TrackerService):
    """A ``TrackerService`` that notes, for each command it applies, the
    last frame tracked before it and the frame it was applied before: a
    checkpoint saves the first one's belief, and the loop goes on with
    the second (a client's ``status`` after the command may already show
    a later frame)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.applied_between = {}

    def apply_pending(self, tracker, frame, reinit_kwargs=None):
        st = self.status()
        stop = super().apply_pending(tracker, frame, reinit_kwargs)
        for seq in range(st["applied_seq"] + 1,
                         self.status()["applied_seq"] + 1):
            self.applied_between[seq] = (st["frame"], int(frame.index))
        return stop


def live_client(sock, traj, ckpt, frames_left, log):
    """The operator: status, pause ~0.3 s and resume, checkpoint,
    reset_pose to the current ground truth, find_object near frame
    ``LIVE_FIND_FRAME``, then, once a frame after the search was tracked,
    shutdown at frame ``LIVE_SHUTDOWN_FRAME`` or when the camera has at
    most ``LIVE_SHUTDOWN_MARGIN`` frames left to send, whichever comes
    first; every call through the socket, with timeouts. Writes what it
    saw into ``log``."""
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
        seq = log["checkpoint_seq"] = queued({"cmd": "checkpoint",
                                              "path": ckpt})
        log["checkpoint_frame"] = wait_applied(seq)["frame"]
        st = wait_frame(log["checkpoint_frame"] + 10)
        seq = queued({"cmd": "reset_pose",
                      "pose": traj(st["frame"] + 1)[0].tolist()})
        log["reset_frame"] = wait_applied(seq)["frame"]
        wait_frame(LIVE_FIND_FRAME)
        seq = queued({"cmd": "find_object"})
        searched = wait_applied(seq)["reinit_frames"][-1]
        # a frame after the search is tracked first: its re-anchor is
        # checked (a search that ends near the stream's end would let the
        # shutdown in before it)
        st = wait_for(lambda st: st["frame"] > searched and (
            st["frame"] >= LIVE_SHUTDOWN_FRAME
            or frames_left() <= LIVE_SHUTDOWN_MARGIN),
            "no frame after the search to shut down on")
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
    cam, mesh, traj = slice_scene()
    frames, native_cam, render_ms, u16_ms, eager_ms = render_live_frames(
        dev, cam, mesh, traj)
    check(frames[0].depth.shape == (cam.height, cam.width),
          f"converted frame {frames[0].depth.shape}")
    valid = np.concatenate([f.depth[np.isfinite(f.depth)] for f in frames])
    check(np.allclose(valid * 1000, np.round(valid * 1000), atol=1e-3),
          "depth not in whole millimetres after the u16 transport")

    tracker = ParticleTracker(slice_config(), meshes=[mesh], camera=cam,
                              device=dev)
    # warm up the step and the re-anchor (a live camera does not wait; a
    # process's first re-anchor also loads its kernels: 0.15-0.25 s more on
    # an H100), then start from the truth
    tracker.initialize(frames[0].ground_truth)
    for _ in range(3):
        tracker.track(frames[0].depth)
    initializer.reanchor_tracker(tracker, frames[0].depth)
    tracker.initialize(frames[0].ground_truth)

    sock, ckpt = str(tmp / "c.sock"), str(tmp / "belief.npz")
    service = NotedService(sock)
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
    since_search = np.array([f >= reinit[0] for f in tracked])
    trace = ("(frame, skipped, error mm, hypotheses, ESS) from the search "
             "on: " + json.dumps([
                 (m.frame, m.skipped, round(1e3 * float(e), 2),
                  m.trial_hypotheses, m.ess and round(m.ess))
                 for m, e in zip(run.metrics.records, err)
                 if m.frame >= reinit[0]]))
    check(err[-LIVE_LAST_FRAMES:].max() < RMSE_LIMIT_M,
          f"last {LIVE_LAST_FRAMES} frames up to "
          f"{err[-LIVE_LAST_FRAMES:].max()} m off; " + trace)
    # the gap rule (runtime/node.py): the frames after the search and
    # after the pause came more than the damping time after the frame
    # before them, so each is re-anchored on, and none is lost
    check(err[since_search].max() < RMSE_LIMIT_M,
          f"a frame from the search on is {err[since_search].max()} m "
          "off; " + trace)
    after = [i for i, f in enumerate(tracked) if f > reinit[0]]
    resumed = [i for i, f in enumerate(tracked) if f > log["pause"]["frame"]]
    anchored = [r.frame for r in run.reanchors]
    for what, later in (("search", after), ("pause", resumed[1:])):
        check(later and tracked[later[0]] in anchored,
              f"the first frame after the {what} was not re-anchored: "
              f"re-anchored {anchored}; (frame, skipped): "
              + json.dumps(list(zip(tracked, skipped))))
    reanchors = []
    for r in run.reanchors:
        i = tracked.index(r.frame)
        truth = frames[r.frame].ground_truth[0, :3]
        reanchors.append({
            "frame": r.frame, "skipped": r.skipped, "ms": 1e3 * r.seconds,
            "error_before_m": float(np.linalg.norm(r.before[0, :3] - truth)),
            "error_after_m": float(np.linalg.norm(r.after[0, :3] - truth)),
            # what the re-anchor's own time cost the next frame
            "skipped_next": skipped[i + 1] if i + 1 < len(skipped) else None})

    # the checkpoint loads, restores and tracks the frame the loop went
    # on with, over its real interval from the saved frame
    gen = torch.Generator(device=dev)
    belief = checkpoint.load_belief(ckpt, device=dev, generator=gen)
    restored = ParticleTracker(slice_config(), meshes=[mesh], camera=cam,
                               device=dev)
    restored.generator = gen
    restored.restore(belief)
    f_ck, f_next = service.applied_between[log["checkpoint_seq"]]
    poses, _ = restored.track(frames[f_next].depth,
                              dt=(f_next - f_ck) / LIVE_RATE_HZ)
    ck_err = float(torch.linalg.norm(
        poses.reshape(-1, 7)[0, :3].cpu()
        - torch.as_tensor(frames[f_next].ground_truth[0, :3])))
    check(ck_err < RMSE_LIMIT_M, f"restored checkpoint is {ck_err} m off")

    lat = np.array([m.latency_s for m in run.metrics.records]) * 1e3
    trial = np.array([bool(m.trial_hypotheses)
                      for m in run.metrics.records])
    push_pose = np.array([1e3 * (posed_at[i] - src.pushed_at[i])
                          for i in tracked])
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
          "oracle_render_ms_median_first_frames": {
              "frames": f"1-{LIVE_EAGER_FRAMES - 1}",
              "captured": statistics.median(render_ms[1:LIVE_EAGER_FRAMES]),
              "eager": statistics.median(eager_ms[1:])},
          "render_captured_equals_eager_frames": LIVE_EAGER_CHECKED,
          "u16_convert_ms_median": statistics.median(u16_ms),
          "last30_max_error_m": float(err[-LIVE_LAST_FRAMES:].max()),
          "since_search_max_error_m": float(err[since_search].max()),
          "reanchors": reanchors,
          "unanchored_frames": run.unanchored_frames,
          "position_rmse_m": run.position_rmse(),
          "checkpoint_frame": f_ck, "checkpoint_next_frame": f_next,
          "checkpoint_status_frame": log["checkpoint_frame"],
          "checkpoint_restored_error_m": ck_err,
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
    # the step's belief is its program's buffers: copies for both
    mine, ref = clone_belief(belief), clone_belief(belief)
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


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64,
         torch.bfloat16: torch.int16, torch.float16: torch.int16}


def bit_diff(a, b):
    """0.0 where ``a`` and ``b`` hold the same bits (NaNs included), else
    the largest |a - b| (inf where only NaNs or infinities differ)."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"layouts differ: {a.shape} {a.dtype}, {b.shape} {b.dtype}")
    if torch.equal(*(x.view(_BITS.get(x.dtype, x.dtype)) for x in (a, b))):
        return 0.0
    d = float(torch.nan_to_num((a.double() - b.double()).abs(),
                               nan=float("inf")).max())
    return d if d > 0 else float("inf")


def leaves_of(x):
    """Every tensor of a tensor, a dataclass (a belief, a step's info) or
    a list or tuple of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in leaves_of(y)]
    if dataclasses.is_dataclass(x):
        return leaves_of([getattr(x, f.name)
                          for f in dataclasses.fields(x)])
    return []


def scale_step_paths(dev, comm, tracker, traj):
    """The one-rank steps of the scale phase, each a maker of a step
    (``capture``), its start belief, its frames (z per frame), its
    truth per frame (scenes, K, 3) and how many frames it runs."""
    tp, sensor, dt = tracker.trans_params, tracker.sensor, tracker._dt
    kl = tracker.config.max_kl_divergence

    def traj2(t):
        return traj(t) + np.array([[0.03, 0, 0, 0, 0, 0, 0]], np.float32)

    def frames_of(trajs, count):
        srcs = [sources.SyntheticSource(tracker.meshes, tracker.camera, tr,
                                        count, seed=SEED + s)
                for s, tr in enumerate(trajs)]
        zs = [torch.stack([preprocess_depth(torch.as_tensor(
            f.depth, device=dev).reshape(-1)) for f in fr])
            for fr in zip(*srcs)]
        truth = [np.stack([tr(t)[:, :3] for tr in trajs])
                 for t in range(count)]
        return zs, truth

    def center(tr):
        return base.to_center_frame(torch.as_tensor(tr(0), device=dev),
                                    tracker.centers)

    one, one_truth = frames_of([traj], GRAPH_FRAMES + 1)
    two, two_truth = frames_of([traj, traj2], SCALE_SCENE_FRAMES + 1)
    one = [z[0] for z in one]
    groups = dist_filter.make_scene_groups(1, 1)

    def dist_start():
        return dist_filter.init_distributed_belief(comm, center(traj), P,
                                                   sensor=sensor)

    def distributed(exchange):
        return (lambda capture: dist_filter.make_distributed_step(
            comm, sensor, tp, dt, max_kl_divergence=kl, exchange=exchange,
            seed=SEED, capture=capture), dist_start, one, one_truth)

    return {
        "distributed_counts": distributed("counts"),
        "distributed_all_gather": distributed("all_gather"),
        "island": (lambda capture: dist_filter.make_island_step(
            comm, sensor, tp, dt, max_kl_divergence=kl, seed=SEED,
            capture=capture), dist_start, one, one_truth),
        "multi_scene_2x10k": (
            lambda capture: dist_filter.make_multi_scene_step(
                groups, sensor, tp, dt, max_kl_divergence=kl, seed=SEED,
                capture=capture),
            lambda: dist_filter.init_multi_scene_belief(
                groups, torch.stack([center(traj), center(traj2)]),
                SCALE_SCENES, P, sensor=sensor), two, two_truth)}


def cdf_repeatability(dev):
    """The resampling CDF and a one-row ``torch.cumsum`` on the same
    weights, ``CDF_CALLS`` calls each per size while a side stream keeps
    the card busy: how many calls differ in any bit from the first. The
    CDF must repeat."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 41)
    busy, side = torch.randn(2048, 2048, device=dev), torch.cuda.Stream()
    out = {}
    for n in CDF_SIZES:
        w = torch.softmax(3.0 * torch.randn(n, generator=g, device=dev), 0)
        for name, fn in (("weight_cdf", resample.weight_cdf),
                         ("cumsum_one_row", lambda x: torch.cumsum(x, 0))):
            first = fn(w).clone()
            differ = 0
            for i in range(CDF_CALLS):
                if i % 8 == 0:
                    with torch.cuda.stream(side):
                        busy @ busy
                differ += int(bit_diff(fn(w), first) != 0.0)
            out[f"{name}/{n}"] = differ
    torch.cuda.synchronize()
    out["calls"] = CDF_CALLS
    check(all(out[f"weight_cdf/{n}"] == 0 for n in CDF_SIZES),
          f"scale: the resampling CDF does not repeat {out}")
    return out


def scale_lockstep(name, tracker, make, start, frames, truth):
    """A captured and an eager step (``make(capture)``) of the path ``name``
    from the same start belief over the same frames (all but the last) in
    lockstep: the largest difference of means, ESS and beliefs after each
    frame, the launches per frame, the paths, the captured run's position
    RMSE per scene; then step ms in turns with the captured ``track`` on
    the last frame."""
    steps = {c: make(c) for c in (True, False)}
    check(steps[True].capture and not steps[False].capture,
          f"scale: {name}: the one-rank NCCL step is not captured by "
          "default")
    beliefs = {c: start() for c in (True, False)}
    per_frame = {True: [], False: []}
    diff = {"mean": 0.0, "ess": 0.0, "belief": 0.0}
    paths, err = set(), []
    for t, z in enumerate(frames[:-1]):
        out = {}
        for c, step in steps.items():
            before = {k: w.launches for k, w in WRAPPERS.items()}
            beliefs[c], mean, ess = step(beliefs[c], z)
            per_frame[c].append({k: w.launches - before[k]
                                 for k, w in WRAPPERS.items()})
            out[c] = (mean.reshape(-1, *mean.shape[-2:]), ess)
        check(steps[True].paths == steps[False].paths,
              f"scale: {name}: paths {steps[True].paths} against "
              f"{steps[False].paths}")
        paths.update(steps[True].paths)
        for k, a, b in (("mean", out[True][0], out[False][0]),
                        ("ess", out[True][1], out[False][1])):
            diff[k] = max(diff[k], bit_diff(a, b))
        for a, b in zip(leaves_of(beliefs[True]), leaves_of(beliefs[False])):
            diff["belief"] = max(diff["belief"], bit_diff(a, b))
        pos = torch.stack([model_position(tracker, m)
                           for m in out[True][0]]).cpu().numpy()
        err.append(np.linalg.norm(pos - truth[t], axis=-1))
    rmse = np.sqrt(np.mean(np.square(err), axis=0)).reshape(-1).tolist()
    launches = {k: sum(f[k] for f in per_frame[True]) for k in WRAPPERS}
    check(per_frame[True] == per_frame[False],
          f"scale: {name}: launches per frame captured "
          f"{per_frame[True]} against "
          f"eager {per_frame[False]}")
    check(all(v <= GRAPH_ATOL for v in diff.values()),
          f"scale: {name}: captured against eager {diff}")
    check(max(rmse) < RMSE_LIMIT_M, f"scale: {name}: position RMSE {rmse} m")
    check(all(launches[k] > 0 for k in WRAPPERS),
          f"scale: {name}: a kernel never launched captured {launches}")
    # timed in turns: track, captured, eager, eager, captured, track
    z, depth = frames[-1], frames[-1].reshape(-1, frames[-1].shape[-1])[0]
    depth = depth.cpu()
    ms = {"track": [], True: [], False: []}
    for who in ("track", True, False, False, True, "track"):
        turn = []
        for i in range(WARMUP + GRAPH_TIMING_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if who == "track":
                tracker.track(depth)
            else:
                beliefs[who], _, _ = steps[who](beliefs[who], z)
            torch.cuda.synchronize()
            if i >= WARMUP:
                turn.append(1e3 * (time.perf_counter() - t0))
        ms[who].append(turn)

    def summary(turns):
        flat = sorted(x for t in turns for x in t)
        return {"ms_median": statistics.median(flat),
                "ms_p90": flat[int(0.9 * (len(flat) - 1))],
                "ms_median_by_turn": [statistics.median(t) for t in turns]}

    progs = getattr(steps[True], "programs", None) or [steps[True].program]
    stats = {}
    for prog in progs:
        for k, v in prog.stats().items():
            stats[k] = stats.get(k, 0) + v
    res = {"frames": len(frames) - 1, "paths": sorted(paths),
           "position_rmse_m": rmse, "tolerance": GRAPH_ATOL,
           "max_abs_diff": diff, "launches": launches,
           "launches_per_frame": {
               json.dumps(f, sort_keys=True): per_frame[True].count(f)
               for f in per_frame[True]},
           "captured": summary(ms[True]), "eager": summary(ms[False]),
           "track_captured": summary(ms["track"]),
           "programs": len(progs), "graphs": stats["graphs"],
           "capture_seconds": stats["capture_seconds"],
           "pool_mb": stats["pool_bytes"] / 2 ** 20,
           "buffer_mb": stats["buffer_bytes"] / 2 ** 20}
    res["median_ratio_eager_to_captured"] = (
        res["eager"]["ms_median"] / res["captured"]["ms_median"])
    return res, launches


def scale_steps(dev, comm, tracker, traj):
    """Each one-rank step captured against eager (see the module
    docstring) → (results by path, the captured runs' launches)."""
    out, total = {}, {k: 0 for k in WRAPPERS}
    for name, (make, start, frames, truth) in scale_step_paths(
            dev, comm, tracker, traj).items():
        out[name], launches = scale_lockstep(name, tracker, make, start,
                                             frames, truth)
        for k in WRAPPERS:
            total[k] += launches[k]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out, total


def marked_block(dev, tracker, block, rank):
    """This rank's start block for the exchange checks: all particles at
    the start pose (a still transition keeps them there, so the weights
    are the skew given), a map whose columns differ, by a seeded draw,
    only off the object's silhouette (dilated by 3 pixels), where the
    sensor never changes a row (a wrong parent shows in the map), and
    on those rows lazy ages drawn per rank (1-6 frames, plus the rank),
    so that the two ranks' ages differ where no particle's likelihood
    reads them."""
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
    age = torch.where(rows, torch.randint(1, 7, age.shape, generator=g,
                                          device=dev) + rank, 0).float()
    states = block.states[:1].expand_as(block.states).clone()
    return rbcpf.ParticleBelief(states, block.log_weights.clone(),
                                (q, age))


def home_columns(comm, tracker, dt, trans, start, z, noise):
    """What a one-object step's exchange starts from, gathered over the
    ranks in rank order: the proposal's states (P, 1, 13) and the
    sensor's committed map materialized, (P, N) float32 (from a copy of
    ``start``: the sensor writes the map in place)."""
    states = rbcpf.propose_block(start.states, 0, dt, trans, noise[0])
    _, leaf = tracker.sensor(states, copy_leaf(start.occlusion), z, dt)
    pn = tracker.sensor.occlusion_as_pn(leaf, start.num_particles)
    return (comm.all_gather(states, tiled=True),
            comm.all_gather(pn.contiguous(), tiled=True))


def parents_by_state(home_states, states):
    """Each offspring's parent: the row of the gathered proposals its
    state equals bit for bit (the proposal's velocity noise makes the
    rows distinct); None if a row has no parent or two rows are equal."""
    rows = home_states.reshape(home_states.shape[0], -1).cpu().numpy()
    index = {r.tobytes(): i for i, r in enumerate(rows)}
    if len(index) != rows.shape[0]:
        return None
    out = [index.get(r.tobytes()) for r in
           states.reshape(states.shape[0], -1).cpu().numpy()]
    return None if None in out else torch.tensor(out, device=states.device)


def scale_rank(rank, world, port, out_dir, device, compare=False):
    """One of two gloo ranks sharing the card (started with ``spawn``):
    the exchanges against all_gather on skewed forced frames, times and
    traffic per mode, the dry run; with ``compare`` (``--compare scale``)
    the times and traffic alone. Writes ``rank<r>.json``; raises on a
    failed check (the parent sees the exit code)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    comm = comm_mod.init_process_group("gloo", rank, world, port,
                                       SCALE_GROUP_TIMEOUT_S)
    L = P // world
    for w in ([] if compare else all_wrappers().values()):
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
        # within one hop, under the capacity: rank 1's particles weigh
        # e^0.1 more, so ~2.5 % of the offspring (~250 at 10k) on rank 0
        # descend from rank 1, fewer distinct parents than C = 640: the
        # counts buffers carry them
        "fits": 0.4 * torch.sin(idx.float()) + 0.1 * rank,
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
    for fname, lw in ({} if compare else frames).items():
        noise = [rbcpf.BlockNoise(
            e1=torch.randn((L, 6), generator=g, device=dev),
            e2=torch.randn((L, 6), generator=g, device=dev),
            u=torch.rand((), generator=gs, device=dev))]
        outs, rec = {}, {}
        start = dataclasses.replace(base_block, log_weights=lw.clone())
        home_states, home_occ = home_columns(comm, tracker, tracker._dt,
                                             still, start, z, noise)
        for mode in dist_filter.EXCHANGES:
            step = dist_filter.make_distributed_step(
                comm, tracker.sensor, still, tracker._dt,
                max_kl_divergence=-1.0, exchange=mode)
            check(step.capture is False,
                  f"scale: the gloo step {mode} is captured")
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
            check(rec[mode]["age_equal"], f"scale: {mode}'s ages differ "
                  f"from all_gather's on rank {rank} ({fname})")
            # each offspring's materialized column against its parent's on
            # the parent's home rank: one rounding to bfloat16
            parents = parents_by_state(home_states, b.states)
            check(parents is not None, f"scale: {mode}: offspring without "
                  f"a parent among the proposals on rank {rank} ({fname})")
            err = float((tracker.sensor.occlusion_as_pn(b.occlusion, L)
                         - home_occ[parents]).abs().max())
            check(err <= SCALE_HOME_ATOL, f"scale: {mode}: a materialized "
                  f"column {err} off its parent's on rank {rank} ({fname})")
            rec[mode]["home_column_max_abs_err"] = err
            rec[mode]["offspring_from_other_rank"] = int(
                (torch.div(parents, L, rounding_mode="floor") != rank).sum())
        res["frames"][fname] = rec
    if not compare:
        check(res["frames"]["fits"]["counts"]["path"] == ["counts"],
              f"scale: the fitting frame took {res['frames']['fits']}")
        check(res["frames"]["overflow"]["counts"]["path"] == ["ring"],
              "scale: the overflow frame did not fall back to the ring")

    # ms per step per mode on the fitting frame's weights
    if compare:
        scale_compare_times(res, comm, tracker, still, base_block, z,
                            frames["fits"], rank)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
        comm.barrier()
        return
    (res["ms_per_step"], res["bytes_per_step"],
     res["staging_s_per_step"]) = scale_step_times(
        comm, tracker, still, base_block, z, frames["fits"])
    res["capture"] = False
    res["capture_true_raises"] = raises(
        ValueError, lambda: dist_filter.make_distributed_step(
            comm, tracker.sensor, still, tracker._dt, capture=True))
    check(res["capture_true_raises"],
          "scale: capture=True over gloo did not raise")
    res["dryrun"] = dryrun.dryrun(dev, SCALE_GROUP_TIMEOUT_S)
    torch.cuda.synchronize()
    res["launches"] = {k: w.launches for k, w in all_wrappers().items()}
    res["two_width_launches"] = kernels.lineage_gather.two_width_launches
    check(res["two_width_launches"] > 0,
          f"scale: the two-width gather never launched on rank {rank}")
    check(res["launches"]["age_pixel_rows"] > 0,
          f"scale: the row aging never launched on rank {rank}")
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    comm.barrier()


def scale_step_times(comm, tracker, still, block, z, lw):
    """Per mode: the median ms of a step over ``SCALE_STEPS`` after
    ``SCALE_WARMUP`` (each on fresh copies of ``block`` with weights
    ``lw``, synchronised), bytes sent and staging seconds per step."""
    ms_per, bytes_per, staging_per = {}, {}, {}
    for mode in dist_filter.EXCHANGES:
        step = dist_filter.make_distributed_step(
            comm, tracker.sensor, still, tracker._dt,
            max_kl_divergence=-1.0, exchange=mode, seed=SEED)
        ms = []
        bytes0, stage0 = sum(comm.bytes_sent.values()), comm.staging_seconds
        for i in range(SCALE_WARMUP + SCALE_STEPS):
            start = dataclasses.replace(
                block, log_weights=lw.clone(),
                occlusion=tuple(x.clone() for x in block.occlusion))
            if i == SCALE_WARMUP:
                bytes0 = sum(comm.bytes_sent.values())
                stage0 = comm.staging_seconds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(start, z)
            torch.cuda.synchronize()
            if i >= SCALE_WARMUP:
                ms.append(1e3 * (time.perf_counter() - t0))
        ms_per[mode] = statistics.median(ms)
        bytes_per[mode] = (sum(comm.bytes_sent.values()) - bytes0) / SCALE_STEPS
        staging_per[mode] = (comm.staging_seconds - stage0) / SCALE_STEPS
    return ms_per, bytes_per, staging_per


def scale_compare_times(res, comm, tracker, still, block, z, lw, rank):
    """``--compare scale``: :func:`scale_step_times` in turns with the
    step as it is and with the sensor's materialization replaced by the
    identity (a tree without one times the same step twice; the ages are
    then wrong: a timing only), averaged per variant; then
    ``torch.profiler`` over three ``counts`` steps as they are (host
    time by operator, the table to ``build/profile_scale_rank<r>.txt``)."""
    from torch.profiler import ProfilerActivity, profile

    sensor = tracker.sensor
    turns = {"as_is": [], "no_materialization": []}
    for variant in ("as_is", "no_materialization", "no_materialization",
                    "as_is"):
        if variant == "as_is":
            sensor.__dict__.pop("materialize_occlusion", None)
        else:
            sensor.materialize_occlusion = lambda occ, now: occ
        turns[variant].append(scale_step_times(comm, tracker, still, block,
                                               z, lw))
    sensor.__dict__.pop("materialize_occlusion", None)
    for variant, runs in turns.items():
        suffix = "" if variant == "as_is" else "_no_materialization"
        for i, key in enumerate(("ms_per_step", "bytes_per_step",
                                 "staging_s_per_step")):
            res[key + suffix] = {m: statistics.mean(r[i][m] for r in runs)
                                 for m in runs[0][i]}
        res["ms_per_step_turns" + suffix] = [r[0] for r in runs]
    step = dist_filter.make_distributed_step(
        comm, sensor, still, tracker._dt, max_kl_divergence=-1.0,
        exchange="counts", seed=SEED)
    starts = [dataclasses.replace(
        block, log_weights=lw.clone(),
        occlusion=tuple(x.clone() for x in block.occlusion))
        for _ in range(4)]
    step(starts[0], z)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for start in starts[1:]:
            step(start, z)
        torch.cuda.synchronize()
    events = prof.key_averages()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (BUILD_DIR / f"profile_scale_rank{rank}.txt").write_text(
        events.table(sort_by="cpu_time_total", row_limit=60))
    top = sorted(events, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:12]
    res["counts_profile_self_cpu_ms_per_step"] = {
        e.key: e.self_cpu_time_total / 1e3 / 3 for e in top}


def scale_two_ranks(dev, compare=False):
    """Two gloo ranks sharing the card, collectives staged through pinned
    host memory; the parent fails if a rank fails or outlives its time."""
    out_dir = Path(tempfile.mkdtemp(prefix="dbt_scale"))
    ctx = torch.multiprocessing.get_context("spawn")
    port = comm_mod.free_port()
    procs = [ctx.Process(target=scale_rank,
                         args=(r, SCALE_RANKS, port, str(out_dir),
                               str(dev), compare))
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
    cdf = cdf_repeatability(dev)
    comm = comm_mod.init_process_group(SCALE_BACKEND, 0, 1,
                                       comm_mod.free_port(),
                                       SCALE_GROUP_TIMEOUT_S, device=dev)
    try:
        (tracker, traj, source, step, belief, launches, rmse,
         paths) = scale_track(dev, comm)
        versus = scale_against_rbcpf(dev, comm, tracker, traj, source,
                                     belief)
        capture = step.capture
        del belief, step
        torch.cuda.empty_cache()
        for w in WRAPPERS.values():
            w.launches = 0
        steps, graph_launches = scale_steps(dev, comm, tracker, traj)
        del tracker
    finally:
        torch.distributed.destroy_process_group()
    one_rank_s = time.perf_counter() - t0
    ranks, two_s = scale_two_ranks(dev)
    for fname in ranks[0]["frames"]:
        crossed = sum(r["frames"][fname]["counts"]["offspring_from_other_rank"]
                      for r in ranks)
        check(crossed > 0, f"scale: no column crossed ranks ({fname})")
    two_rank_launches = {k: sum(r["launches"][k] for r in ranks)
                         for k in all_wrappers()}
    emit({"phase": "scale", "nvidia_smi": card,
          "cdf_differing_calls": cdf,
          "one_rank": {"backend": SCALE_BACKEND, "world": 1,
                       "capture": capture, "particles": P, "frames": FRAMES,
                       "position_rmse_m": rmse, "paths": paths,
                       "launches": launches,
                       "against_rbcpf_step": versus,
                       "captured_against_eager": steps,
                       "scale_graph_launches": graph_launches,
                       "seconds": one_rank_s},
          "two_ranks": {"transport": "gloo, staged through pinned host "
                                     "memory, both ranks on one card",
                        "world": SCALE_RANKS, "particles_per_rank":
                        P // SCALE_RANKS, "capacity":
                        dist_filter.counts_capacity(P // SCALE_RANKS),
                        "seconds": two_s, "launches": two_rank_launches,
                        "ranks": ranks}})
    return launches, graph_launches, two_rank_launches


def phase_scale_steps(dev):
    """``--compare scale``: the two gloo ranks' ms, bytes and staging
    seconds per step per mode (the scale phase's times), without its
    checks, as they are and without the materialization
    (:func:`scale_compare_times`)."""
    ranks, seconds = scale_two_ranks(dev, compare=True)
    emit({"phase": "scale_steps", "particles_per_rank": P // SCALE_RANKS,
          "seconds": seconds, "ranks": [
              {k: v for k, v in r.items() if k != "frames"} for r in ranks]})


def stiff_leg(entry):
    """A copy of a leg of ``jax_reference.json`` whose configuration has
    both transition sigmas × ``EVAL_POWER_SCALE``: the power check's."""
    stiff = copy.deepcopy(entry)
    for k in ("linear_acceleration_sigma", "angular_acceleration_sigma"):
        stiff["config"]["transition"][k] *= EVAL_POWER_SCALE
    return stiff


def phase_eval(dev, card):
    """Both sets of the accuracy suite on the card, ``production`` first,
    one line per set, then the power check: ``EVAL_POWER_LEG`` with its
    transition's sigmas × ``EVAL_POWER_SCALE`` (a belief too stiff to
    follow the rotation), which the rule must fail. Returns each
    kernel's launches over the phase and what failed (a leg that fails
    its rule, a kernel a ``pf-pallas`` leg never launched, a power check
    that passes, the phase over its time), which ``main`` raises on after
    the kernels line."""
    from dbot_ros_tpu_torch.runtime import eval_suite

    keys = ("estimator", "frames", "particles", "rule", "seeds", "mean",
            "sd", "jax_mean", "jax_sd", "checks", "over_2cm", "passed",
            "failed_metrics", "seconds")
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    failed, results = [], {}
    for set_name in eval_suite.SETS:
        res = eval_suite.run_set(EVAL_FIXTURES, set_name, dev)
        torch.cuda.empty_cache()
        results[set_name] = res
        legs = {}
        for name, r in res["legs"].items():
            legs[name] = {k: r[k] for k in keys}
            if not r["passed"]:
                failed.append(f"{name} fails its rule in "
                              f"{r['failed_metrics']} ({r['checks']})")
            if r["estimator"] == "pf-pallas":
                legs[name]["launches"] = r["launches"]
                idle = [k for k, n in r["launches"].items() if n == 0]
                if idle:
                    failed.append(f"{name}: {idle} never launched")
        emit({"phase": "eval", "set": set_name, "nvidia_smi": card,
              "device": res["device"], "jax_commit": res["jax_commit"],
              "legs_passed": sum(r["passed"] for r in legs.values()),
              "legs": len(legs), "seconds": res["seconds"], "results": legs})
    ref = eval_suite.load_reference(EVAL_FIXTURES)
    stiff = stiff_leg(ref["legs"][EVAL_POWER_LEG])
    power = eval_suite.run_leg(EVAL_FIXTURES, EVAL_POWER_LEG, stiff,
                               ref["bound_rule"], dev)
    torch.cuda.empty_cache()
    if power["passed"]:
        failed.append(f"power check: {EVAL_POWER_LEG} with its transition "
                      f"sigmas × {EVAL_POWER_SCALE} passes the rule "
                      f"({power['checks']})")
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    emit({"phase": "eval", "power_check": EVAL_POWER_LEG,
          "transition": stiff["config"]["transition"],
          "failed_metrics": power["failed_metrics"],
          **{k: power[k] for k in ("mean", "sd", "checks", "over_2cm",
                                   "seconds")},
          "real_leg": {k: results["eval"]["legs"][EVAL_POWER_LEG][k]
                       for k in ("mean", "sd", "checks", "over_2cm")}})
    if seconds > EVAL_LIMIT_S:
        failed.append(f"{seconds:.1f} s, over its {EVAL_LIMIT_S:.0f} s")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(EVAL_RESULTS, "w") as fh:
        json.dump({"nvidia_smi": card, "sets": results, "power_check": power},
                  fh, indent=1)
    emit({"phase": "eval", "seconds": seconds, "launches": launches,
          "results_file": str(EVAL_RESULTS), "failed": failed})
    return launches, failed


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    compare = "--compare" in argv
    card = phase_device()
    dev = torch.device("cuda")
    phase_build()
    if compare:
        # what a comparison of two commits reads, in one run of each: the
        # phases named after --compare, else all of them
        phases = {"fused": phase_fused, "rows": phase_rows,
                  "slice": phase_slice, "scale": phase_scale_steps}
        named = [a for a in argv if a != "--compare"] or list(phases)
        check(set(named) <= set(phases), f"--compare takes {list(phases)}")
        for name in named:
            phases[name](dev)
        emit(ok_line())
        return 0
    kres = phase_kernels(dev)
    phase_sensor(dev)
    launches, tracker, depth = phase_slice(dev)
    phase_profile(tracker, depth, PROFILE_TABLE)
    graph_launches = phase_graph(dev, card)
    objects_launches = phase_objects(dev, tracker, depth)
    del tracker
    options_launches = phase_options(dev)
    phase_cli(dev)
    phase_rgf(dev)
    phase_cli(dev, kind="gaussian")
    phase_deferred(dev)
    live_launches = phase_live(dev, card)
    scale_launches, scale_graph_launches, two_rank_launches = phase_scale(
        dev, card)
    eval_launches, eval_failed = phase_eval(dev, card)
    # a tracker kernel's main path is the slice; the row aging's, the two
    # gloo ranks' exchanges (None: a path that does not count it)
    main_launches = {**launches, **{k: two_rank_launches[k]
                                    for k in kernels.EXCHANGE_WRAPPERS}}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name],
         "two_rank_launches": two_rank_launches[name],
         "live_launches": live_launches.get(name),
         "scale_launches": scale_launches.get(name),
         "scale_graph_launches": scale_graph_launches.get(name),
         "objects_launches": objects_launches.get(name),
         "options_launches": options_launches.get(name),
         "graph_launches": graph_launches.get(name),
         "eval_launches": eval_launches.get(name),
         **{k: kres[name][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         **{k: kres[name].get(k) for k in (
             "cold_ms", "library_cold_ms", "calls_per_graph")},
         **{k: kres[name][k] for k in ("second_level", "two_widths")
            if k in kres[name]}}
        for name, (src, rep) in KERNELS.items()]})
    check(not eval_failed, "eval: " + "; ".join(eval_failed))
    emit(ok_line())
    return 0


def ok_line():
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    sys.exit(main())
