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

Each number is the largest over the checked frames, in plain units, and
each has its limit in the configuration's file (``limits``).
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
         "loglik_gap": 1.0, "camera_gap_m": 1.0}


class Verdict:
    """The numbers, their limits, and what was checked. A number compared
    is one the configuration gives a limit; the others are kept for the
    record (``uncompared``)."""

    def __init__(self, limits: dict):
        self.limits = dict(limits or {})
        self.values: dict = {}
        self.notes: list = []
        self.frames = 0
        self.expected: set = set()      # the numbers this cell reads

    def put(self, name, value):
        value = float(value) * UNITS.get(name, 1.0)
        if not math.isfinite(value):
            value = math.inf
        self.values[name] = max(self.values.get(name, -math.inf), value)

    def compared(self):
        return sorted(n for n in self.limits if n in self.expected)

    @property
    def correct(self) -> bool:
        """Every number this cell reads that has a limit was read, on at
        least one frame, and is within its limit."""
        names = self.compared()
        if not names or self.frames == 0:
            return False
        return all(self.values.get(n, math.inf) <= self.limits[n]
                   for n in names)

    def table(self) -> dict:
        return {n: {"value": self.values.get(n), "limit": self.limits[n]}
                for n in self.compared()}

    def uncompared(self) -> dict:
        return {n: v for n, v in sorted(self.values.items())
                if n not in self.compared()}


def check(kind, settings, obj_text, conf, traffic, start, taken,
          device) -> Verdict:
    """The verdict on a run: ``start`` holds the first frame's published
    pose and info, ``taken`` the sampled frames (see runner._Checks)."""
    v = Verdict(conf.get("limits"))
    v.expected = {p + n for p in ("", "carry_")
                  for n in ("lateral_mm", "scale", "rot_mrad")}
    v.expected.add("loglik_gap")
    if kind == "particle":
        v.expected |= {"carry_particles_mm", "carry_velocity_mm_s"}
    if traffic.native:
        v.expected.add("camera_gap_m")
    if kind == "particle":
        _check_particle(v, settings, obj_text, traffic, start, taken,
                        device)
    else:
        _check_gaussian(v, settings, obj_text, traffic, start, taken,
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


def _check_particle(v, settings, obj_text, traffic, start, taken, device):
    ref = pf.ParticleReference(settings, obj_text, device)
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
    st = ref.step(ref.initial(traffic.truth[0]), depth0, dt0, draws[0])
    _compare_particle(v, st, start["pose"], start["info"].mean_loglik)
    v.frames += 1

    for e in taken:
        if not _usable(e, settings, v):
            continue
        depth = _frame_depth(traffic, e, v)
        bel = ref.from_program(*e["before"])
        st = ref.step(bel, depth, e["dt"], draws[e["call"]])
        _compare_particle(v, st, e["rec"].pose, e["info"].mean_loglik)
        if "carry" in e:
            states, log_w, _ = e["carry"]
            mp = pf.weighted_mean_pose(ref, states, log_w)
            _put_gaps(v, "carry_", mp, st.pose, st.other_pose)
            gap = pf.particle_gap(states, st.belief.states)
            if st.other_states is not None:
                gap = min(gap, pf.particle_gap(states, st.other_states))
            v.put("carry_particles_mm", gap)
            vel = pf.weighted_mean_state(states, log_w)[:, 7:10].double()
            dv = [torch.linalg.norm(vel - ms[:, 7:10].double()).item()
                  for ms in (st.mean_state, st.other_mean_state)
                  if ms is not None]
            v.put("carry_velocity_mm_s", min(dv))
        v.frames += 1
        del bel, st


def _put_gaps(v, prefix, got, want, other=None):
    """The pose gaps of ``got`` to the reference's ``want`` (to the
    nearer of two reference answers where the KL sat on the trigger)."""
    got = torch.as_tensor(np.asarray(got.cpu() if torch.is_tensor(got)
                                     else got), dtype=torch.float64)
    gaps = pf.pose_gaps(got, want.cpu())
    if other is not None:
        gaps = tuple(min(x, y) for x, y in
                     zip(gaps, pf.pose_gaps(got, other.cpu())))
    for name, g in zip(("lateral_mm", "scale", "rot_mrad"), gaps):
        v.put(prefix + name, g)


def _compare_particle(v, st, published, mean_loglik):
    _put_gaps(v, "", published, st.pose, st.other_pose)
    ml_ref = float(st.mean_loglik)
    v.put("loglik_gap", abs(float(mean_loglik) - ml_ref)
          / max(1.0, abs(ml_ref)))


def _check_gaussian(v, settings, obj_text, traffic, start, taken, device):
    ref = gf.GaussianReference(settings, obj_text, device)
    dt0 = 1.0 / float(settings["camera"]["frame_rate"])
    depth0 = traffic_mod.tracker_frame(traffic, 0)
    if traffic.native:
        depth0 = scene.preprocess_u16(traffic.frames[0], traffic.downsampling)
    _, pose, info = ref.step(ref.initial(traffic.truth[0], depth0), depth0,
                             dt0)
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
            _put_gaps(v, "carry_", carried, pose)
        v.frames += 1


def _compare_gaussian(v, pose, info, published, pub_info):
    _put_gaps(v, "", published, pose)
    ref_ll = float(info.obs_loglik)
    v.put("loglik_gap", abs(float(pub_info.obs_loglik) - ref_ll)
          / max(1.0, abs(ref_ll)))
