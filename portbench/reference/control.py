"""The control of the check: the reference, put in the program's place
and computed in the precision below the configuration's (float32 with
TF32 off → TF32 matrix products). A run of a cell with the control as
its tracker has to come out not correct; its readings set the upper end
of each limit (``portbench/core/calibrate.py``).

The two trackers here have what the streaming loop reads of a tracker:
``initialize``, ``track``, ``belief``, ``config.evaluation_count``,
``_dt``, ``trans_params.damping`` and ``meshes``.
"""

from __future__ import annotations

import types

import torch

from . import gf, pf


class ControlParticleTracker:
    def __init__(self, settings: dict, obj_text: str, device,
                 dtype: str = "tf32"):
        self.ref = pf.ParticleReference(settings, obj_text, device)
        self.dtype = dtype
        self.config = types.SimpleNamespace(
            evaluation_count=self.ref.P, seed=self.ref.seed)
        self._dt = 1.0 / self.ref.frame_rate
        self.trans_params = self.ref.trans
        self.meshes = [self.ref.mesh]
        self.trial_active = None
        self._bel = None
        self.belief = None
        self._gen = None

    def _publish(self):
        b = self._bel
        # the tracker's layout: the map pixel-major, with its ages
        self.belief = types.SimpleNamespace(
            states=b.states, log_weights=b.log_weights,
            occlusion=(b.occ.T, b.age))

    def initialize(self, pose_model):
        self._bel = self.ref.initial(pose_model)
        self._gen = self.ref.generator()
        self._publish()

    def track(self, depth, dt=None):
        dt = self._dt if dt is None else dt
        st = self.ref.step(self._bel, depth, dt, self.ref.draw(self._gen),
                           self.dtype)
        self._bel = st.belief
        self._publish()
        info = types.SimpleNamespace(
            mean_state=st.mean_state, mean_loglik=st.mean_loglik,
            kl=torch.tensor(st.kl), resampled=torch.tensor(st.resampled),
            ess=None)
        return st.pose, info


class ControlGaussianTracker:
    def __init__(self, settings: dict, obj_text: str, device,
                 dtype: str = "tf32"):
        self.ref = gf.GaussianReference(settings, obj_text, device)
        self.dtype = dtype
        self.config = types.SimpleNamespace()
        self._dt = 1.0 / self.ref.frame_rate
        self.trans_params = self.ref.trans
        self.meshes = [self.ref.mesh]
        self.trial_active = None
        self.belief = None

    def initialize(self, pose_model, first_frame=None):
        self.belief = self.ref.initial(pose_model, first_frame)

    def track(self, depth, dt=None):
        dt = self._dt if dt is None else dt
        self.belief, pose, info = self.ref.step(self.belief, depth, dt,
                                                self.dtype)
        return pose, info


def factory(obj_text_of, dtype: str = "tf32"):
    """A ``tracker_factory`` for ``runner.run_cell`` that builds the
    control of the cell's configuration."""
    def make(kind, settings, device):
        obj = obj_text_of(settings)
        cls = (ControlParticleTracker if kind == "particle"
               else ControlGaussianTracker)
        return cls(settings, obj, device, dtype)
    return make


def obj_text_from_settings(settings: dict) -> str:
    with open(settings["object"]["meshes"][0]) as fh:
        return fh.read()

