"""Whether the timed path's poses are right: the comparison with the
plain reference that decides a run's ``correct``.

The reference cannot replay a whole window: the particle tracker's step
is chaotic (resampling picks parents at thresholds, so rounding makes
two exact runs drift apart within frames) and the Gaussian tracker's
iterated trust-region update is not far behind. So the check follows the
program step by step from the program's own state, on a sample of the
window's frames drawn from the seed:

* **step** — for a sampled frame, the reference works the step out again
  from the belief the tracker held before it (a copy taken before the
  frame was handed over), the frame, its interval and (particle filter)
  the tracker's random numbers for that step, drawn from a generator
  seeded as the tracker's; the pose the loop published for the frame
  must agree with the reference's, and so must the step's mean
  log-likelihood (Gaussian: the observation log-marginal);
* **carry** — the belief the tracker carried into the next frame must be
  the step's: its mean pose must agree with the reference's pose, and
  (particle filter) its particles with the reference's particles, by the
  median over particles of their position gap (a step that publishes a
  pose and keeps a stale belief, or keeps its state unchanged, fails
  here);
* **start** — the first frame after initialisation is worked out from the
  reference's own initial belief, not the tracker's;
* **camera** (open-loop cells) — the frame the loop got from the camera
  path must equal the reference's own conversion of the native frame.

Each number is the largest over the checked frames and, in a scene of
several tracked objects, over the objects (``carry_particles_mm``: the
median over the particles of each one's largest gap over the objects),
in plain units; each has its limit in the configuration's file
(``limits``). Where a block's KL lay within rounding of the resampling
trigger the reference has more than one answer, and each number is read
against the nearest.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.core import traffic as traffic_mod
from portbench.reference import gf, pf, scene

UNITS = {"lateral_mm": 1e3, "scale": 1.0, "rot_mrad": 1e3,
         "carry_lateral_mm": 1e3, "carry_scale": 1.0, "carry_rot_mrad": 1e3,
         "carry_particles_mm": 1e3, "carry_velocity_mm_s": 1e3,
         "loglik_gap": 1.0, "camera_gap_m": 1.0, "parents_mm": 1e3,
         "parents_cdf": 1.0}


class Verdict:
    """The numbers, their limits, and what was checked. A number compared
    is one the configuration gives a limit, or one the cell requires
    (``required``: a run whose configuration gives it no limit is not
    correct); the others are kept for the record (``uncompared``)."""

    def __init__(self, limits: dict):
        self.limits = dict(limits or {})
        self.values: dict = {}
        self.notes: list = []
        self.frames = 0
        self.expected: set = set()      # the numbers this cell reads
        self.required: set = set()      # ... that must have a limit

    def put(self, name, value):
        value = float(value) * UNITS.get(name, 1.0)
        if not math.isfinite(value):
            value = math.inf
        self.values[name] = max(self.values.get(name, -math.inf), value)

    def compared(self):
        return sorted({n for n in self.limits if n in self.expected}
                      | self.required)

    @property
    def correct(self) -> bool:
        """Every number this cell reads that has a limit, and every one it
        requires, was read, on at least one frame, and is within its
        limit."""
        names = self.compared()
        if not names or self.frames == 0:
            return False
        return all(self.values.get(n, math.inf)
                   <= self.limits.get(n, -math.inf) for n in names)

    def table(self) -> dict:
        return {n: {"value": self.values.get(n), "limit": self.limits.get(n)}
                for n in self.compared()}

    def uncompared(self) -> dict:
        return {n: v for n, v in sorted(self.values.items())
                if n not in self.compared()}


def check(kind, settings, obj_texts, conf, traffic, start, taken,
          device) -> Verdict:
    """The verdict on a run: ``obj_texts`` holds the tracked objects'
    meshes, ``start`` the first frame's published pose and info, ``taken``
    the sampled frames (see runner._Checks)."""
    v = Verdict(conf.get("limits"))
    v.expected = {p + n for p in ("", "carry_")
                  for n in ("lateral_mm", "scale", "rot_mrad")}
    v.expected.add("loglik_gap")
    if kind == "particle":
        v.expected |= {"carry_particles_mm", "carry_velocity_mm_s"}
        if len(obj_texts) > 1:
            # the blocks before the last resample through the parents
            # recovered from the program's carried particles: they must
            # be systematic resampling's over the reference's weights
            v.required |= {"parents_mm", "parents_cdf"}
            v.expected |= v.required
    if traffic.native:
        v.expected.add("camera_gap_m")
    if kind == "particle":
        _check_particle(v, settings, obj_texts, traffic, start, taken,
                        device)
    else:
        _check_gaussian(v, settings, obj_texts[0], traffic, start, taken,
                        device)
    return v


def _frame_depth(traffic, entry, v):
    """The frame the reference steps on: the playback's frame, through
    the reference's own conversion in an open-loop cell (and its gap to
    what the loop got)."""
    rec = entry["rec"]
    if not traffic.native:
        return traffic_mod.tracker_frame(traffic, rec.index)
    warm = traffic.warmup_frames
    native = traffic.frames[(warm + rec.index) % traffic.period]
    mine = scene.preprocess_u16(native, traffic.downsampling)
    got = np.asarray(rec.depth, np.float32).reshape(mine.shape)
    same_nan = np.isnan(mine) == np.isnan(got)
    gap = np.where(np.isnan(mine), 0.0, np.abs(mine - got))
    v.put("camera_gap_m", math.inf if not same_nan.all()
          else float(np.nanmax(gap)))
    return mine


def _usable(entry, settings, v):
    """A sampled frame the loop tracked as a plain step (not one after a
    gap long enough for the loop to re-anchor the belief)."""
    if "info" not in entry or entry["rec"].pose is None:
        v.notes.append(f"frame {entry['rec'].index}: not tracked")
        return False
    damping = float(settings["transition"]["damping"])
    if damping > 0 and entry["dt"] > 1.0 / damping:
        v.notes.append(f"frame {entry['rec'].index}: re-anchored after a "
                       "gap, not checked")
        return False
    return True


def _check_particle(v, settings, obj_texts, traffic, start, taken,
                    device):
    ref = pf.ParticleReference(settings, obj_texts, device)
    needed = {0} | {e["call"] for e in taken}
    gen = ref.generator()
    draws = {}
    for call in range(max(needed) + 1):
        d = ref.draw(gen)
        if call in needed:
            draws[call] = d
    dt0 = 1.0 / float(settings["camera"]["frame_rate"])

    # the start: the reference's own initial belief
    depth0 = traffic_mod.tracker_frame(traffic, 0)
    if traffic.native:
        depth0 = scene.preprocess_u16(traffic.frames[0], traffic.downsampling)
    st = ref.step(ref.initial(traffic.poses(0)), depth0, dt0, draws[0],
                  carried=start.get("carried"))
    if _replayable(v, st, "the first frame"):
        _compare_particle(v, st, start["pose"], start["info"].mean_loglik)
        v.frames += 1

    for e in taken:
        if not _usable(e, settings, v):
            continue
        depth = _frame_depth(traffic, e, v)
        bel = ref.from_program(*e["before"])
        st = ref.step(bel, depth, e["dt"], draws[e["call"]],
                      carried=e["carry"][0] if "carry" in e else None)
        if not _replayable(v, st, f"frame {e['rec'].index}"):
            continue
        _compare_particle(v, st, e["rec"].pose, e["info"].mean_loglik)
        if "carry" in e:
            states, log_w, _ = e["carry"]
            answers = st.answers()
            mp = pf.weighted_mean_pose(ref, states, log_w)
            _put_gaps(v, "carry_", mp, [a.pose for a in answers])
            v.put("carry_particles_mm", min(
                pf.particle_gap(states, a.states) for a in answers))
            ms = pf.weighted_mean_state(states, log_w)
            v.put("carry_velocity_mm_s", min(
                pf.velocity_gap(ms, a.mean_state) for a in answers))
        v.frames += 1
        del bel, st
    if v.frames and not v.required <= set(v.values):
        # no block before the last resampled on a checked frame: no
        # parents to recover, none that can be wrong
        v.notes.append("no block before the last resampled")
        for name in v.required:
            v.values.setdefault(name, 0.0)


def _replayable(v, st, what) -> bool:
    """Whether the step replays: no block before the last resampled, or
    the reference took such a block's parents from the particles the
    program carried out of the step (``ParticleReference.step``). A
    block's resampling parents flip with the float32 rounding of its
    log-likelihoods (~1 ulp of their ~10^4 nats moves the cumulative
    weights across systematic resampling's thresholds), and the blocks
    after it weigh the flipped particles by their own telescoped
    log-likelihoods, so a replay through its own parents parts from the
    program by far more than rounding. The last block's flips move the
    mean by rounding alone, as in a step of one object."""
    if st.parents_gap is not None:
        v.put("parents_mm", st.parents_gap)
        v.put("parents_cdf", st.parents_cdf)
    if st.early_resample and st.parents_gap is None:
        v.notes.append(f"{what}: a block before the last resampled and "
                       "no carried particles give its parents: not checked")
        return False
    return True


def _put_gaps(v, prefix, got, wants):
    """The pose gaps of ``got`` (K, 7) to the reference's answers
    ``wants`` (each (K, 7)), each the largest over the objects, to the
    nearest answer."""
    got = torch.as_tensor(np.asarray(got.cpu() if torch.is_tensor(got)
                                     else got), dtype=torch.float64)
    gaps = [pf.pose_gaps(got, want.cpu()) for want in wants]
    for name, g in zip(("lateral_mm", "scale", "rot_mrad"), zip(*gaps)):
        v.put(prefix + name, min(g))


def _compare_particle(v, st, published, mean_loglik):
    _put_gaps(v, "", published, [a.pose for a in st.answers()])
    ml_ref = float(st.mean_loglik)
    v.put("loglik_gap", abs(float(mean_loglik) - ml_ref)
          / max(1.0, abs(ml_ref)))


def _check_gaussian(v, settings, obj_text, traffic, start, taken, device):
    ref = gf.GaussianReference(settings, obj_text, device)
    dt0 = 1.0 / float(settings["camera"]["frame_rate"])
    depth0 = traffic_mod.tracker_frame(traffic, 0)
    if traffic.native:
        depth0 = scene.preprocess_u16(traffic.frames[0], traffic.downsampling)
    _, pose, info = ref.step(ref.initial(traffic.poses(0)[0], depth0),
                             depth0, dt0)
    _compare_gaussian(v, pose, info, start["pose"], start["info"])
    v.frames += 1
    for e in taken:
        if not _usable(e, settings, v):
            continue
        depth = _frame_depth(traffic, e, v)
        new, pose, info = ref.step(ref.from_program(e["before"]), depth,
                                   e["dt"])
        _compare_gaussian(v, pose, info, e["rec"].pose, e["info"])
        if "carry" in e:
            carried = scene.to_model_frame(e["carry"].mean[None, :7].float(),
                                           ref.mesh.center)
            _put_gaps(v, "carry_", carried, [pose])
        v.frames += 1


def _compare_gaussian(v, pose, info, published, pub_info):
    _put_gaps(v, "", published, [pose])
    ref_ll = float(info.obs_loglik)
    v.put("loglik_gap", abs(float(pub_info.obs_loglik) - ref_ll)
          / max(1.0, abs(ref_ll)))
