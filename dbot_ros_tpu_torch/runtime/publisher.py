"""Object-state output.

Port of ``dbot_ros_tpu/runtime/publisher.py``: tracked poses become
plain records (name, mesh resource, frame, pose, velocity) streamed to a
JSONL file or kept in memory. The record format is the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ObjectState:
    """One tracked object's state at one frame (ref M1 ObjectState.msg)."""

    name: str
    mesh: str              # mesh resource path (ref M2 ObjectOri)
    frame: int
    position: List[float]          # [x, y, z] camera frame, meters
    orientation: List[float]       # quaternion [w, x, y, z]
    linear_velocity: Optional[List[float]] = None
    angular_velocity: Optional[List[float]] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class ObjectStatePublisher:
    """Collects per-frame ObjectStates; optionally appends to a JSONL file.

    Use as the ``on_frame`` callback of runtime.node.run.
    """

    def __init__(self, names, meshes=None, path: Optional[str] = None):
        self.names = list(names)
        self.meshes = list(meshes) if meshes is not None else [""] * len(
            self.names)
        self.path = path
        self.states: List[ObjectState] = []
        self._fh = open(path, "w") if path else None

    def __call__(self, frame, poses, info):
        poses = _host(poses)
        mean_state = _host(getattr(info, "mean_state", poses))
        if mean_state.ndim == 1:
            mean_state = mean_state[None]
        for k, name in enumerate(self.names):
            vel = (mean_state[k, 7:13].tolist()
                   if mean_state.shape[-1] >= 13 else None)
            st = ObjectState(
                name=name, mesh=self.meshes[k], frame=frame.index,
                position=poses[k, :3].tolist(),
                orientation=poses[k, 3:7].tolist(),
                linear_velocity=vel[:3] if vel else None,
                angular_velocity=vel[3:] if vel else None)
            self.states.append(st)
            if self._fh:
                self._fh.write(st.to_json() + "\n")
        if self._fh:
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
