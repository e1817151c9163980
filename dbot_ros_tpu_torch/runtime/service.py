"""In-band control service for a running tracker node.

Port of ``dbot_ros_tpu/runtime/service.py`` (an own copy; the protocol is
the same, so a client of either package drives the other). The
reference exposes small ROS service endpoints next to its tracker nodes
(the object-finding service for detection-assisted re-initialization)
plus an operator's implicit controls (re-drag the RViz marker, restart
the node). Here that surface is a newline-delimited-JSON channel on a
Unix domain socket, served by background threads and drained by
``node.run`` between frames: commands change the tracker only on the
loop thread, so the device step has one owner.

Protocol (one JSON object per line, one JSON response line each):

  {"cmd": "status"}                  → tracker snapshot (frame, pose,
                                       paused, applied_seq, pending,
                                       reinit_frames, last_error)
  {"cmd": "pause"} / {"cmd": "resume"} → gate the track step
  {"cmd": "reset_pose", "pose": [x y z qw qx qy qz]}
                                     → re-initialize at a given pose
  {"cmd": "find_object"}             → run the 6-DoF search on the next
                                       frame
  {"cmd": "checkpoint", "path": p}   → save the belief (and a particle
                                       tracker's generator state)
  {"cmd": "shutdown"}                → stop the run loop

Mutating commands are acked ``{"ok": true, "queued": true, "seq": n}``
and applied before the next frame; ``status`` reports ``applied_seq`` so
a client can poll for completion. :meth:`TrackerService.submit` gives the
same surface without a socket.
"""

from __future__ import annotations

import errno
import json
import os
import socket
import threading
import time
from typing import List, Optional

import numpy as np


class TrackerService:
    """Thread-safe command queue and an optional Unix-socket server.

    Construct (optionally with ``socket_path``) and pass to
    ``node.run(service=...)``; the loop calls :meth:`apply_pending` before
    and :meth:`update_status` after every frame and honours
    :attr:`paused`. :meth:`close` tears the socket down.
    """

    def __init__(self, socket_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._queue: List[dict] = []
        self._seq = 0
        self._applied_seq = 0
        self._status = {"frame": None, "poses": None}
        self._last_error = None
        self.paused = False
        self.shutdown_requested = False
        self.reinit_frames: List[int] = []
        # seconds each find_object search took (the port's addition, as
        # node.run's reinit_seconds for the watchdog)
        self.reinit_seconds: List[float] = []
        self._socket_path = socket_path
        self._server: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._closing = False
        if socket_path is not None:
            self._serve(socket_path)

    # ------------------------------------------------------------ client side
    def submit(self, command: dict) -> dict:
        """Programmatic command entry, with the socket's semantics."""
        cmd = command.get("cmd")
        if cmd == "status":
            return self.status()
        if cmd == "pause":
            self.paused = True
            return {"ok": True, "paused": True}
        if cmd == "resume":
            self.paused = False
            return {"ok": True, "paused": False}
        if cmd in ("reset_pose", "find_object", "checkpoint", "shutdown"):
            if cmd == "reset_pose" and "pose" not in command:
                return {"ok": False, "error": "reset_pose needs 'pose'"}
            if cmd == "checkpoint" and "path" not in command:
                return {"ok": False, "error": "checkpoint needs 'path'"}
            if cmd == "shutdown":
                self.shutdown_requested = True
            with self._lock:
                self._seq += 1
                seq = self._seq
                self._queue.append(dict(command, seq=seq))
            return {"ok": True, "queued": True, "seq": seq}
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    def status(self) -> dict:
        with self._lock:
            st = dict(self._status)
            st.update(ok=True, paused=self.paused,
                      applied_seq=self._applied_seq,
                      pending=len(self._queue),
                      reinit_frames=list(self.reinit_frames),
                      last_error=self._last_error)
        return st

    # -------------------------------------------------------------- loop side
    def update_status(self, frame_index: int, poses: np.ndarray):
        with self._lock:
            self._status = {"frame": int(frame_index),
                            "poses": np.asarray(poses).tolist()}

    def apply_pending(self, tracker, frame, reinit_kwargs=None) -> bool:
        """Drain queued commands on the loop thread. Returns True when the
        run loop should stop (shutdown).

        A command that fails (a malformed pose, an unwritable checkpoint
        path) does not stop the loop: the error is recorded and reported
        by ``status`` as ``last_error``.
        """
        with self._lock:
            pending, self._queue = self._queue, []
        stop = False
        for command in pending:
            cmd = command["cmd"]
            try:
                if cmd == "reset_pose":
                    pose = np.asarray(command["pose"],
                                      np.float32).reshape(-1, 7)
                    tracker.initialize(pose[0] if pose.shape[0] == 1
                                       else pose)
                elif cmd == "find_object":
                    from dbot_ros_tpu_torch.runtime.initializer import (
                        initialize_tracker)
                    t0 = time.perf_counter()
                    initialize_tracker(tracker, frame.depth,
                                       **(reinit_kwargs or {}))
                    self.reinit_frames.append(int(frame.index))
                    self.reinit_seconds.append(time.perf_counter() - t0)
                elif cmd == "checkpoint":
                    from dbot_ros_tpu_torch.runtime.checkpoint import (
                        save_belief)
                    save_belief(command["path"], tracker.belief,
                                generator=getattr(tracker, "generator",
                                                  None))
                elif cmd == "shutdown":
                    stop = True
            except Exception as e:  # noqa: BLE001 - contain, report
                with self._lock:
                    self._last_error = (f"{cmd} (seq {command['seq']}): "
                                        f"{type(e).__name__}: {e}")
            with self._lock:
                self._applied_seq = max(self._applied_seq, command["seq"])
        return stop

    # ---------------------------------------------------------------- server
    def _serve(self, path: str):
        if os.path.exists(path):
            # never take over a LIVE tracker's control socket: reclaim the
            # path only if nothing answers a connect probe (a stale socket
            # left by a crashed process)
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.settimeout(0.2)
            try:
                probe.connect(path)
                alive = True
            except (ConnectionRefusedError, FileNotFoundError):
                alive = False
            except OSError as e:
                # a timeout (busy backlog) means something IS listening;
                # only clearly dead conditions may be reclaimed
                alive = getattr(e, "errno", None) not in (
                    errno.ECONNREFUSED, errno.ENOENT, errno.ENOTSOCK)
            finally:
                probe.close()
            if alive:
                raise RuntimeError(
                    f"control socket {path!r} is in use by a live "
                    "process; choose another path")
            os.unlink(path)
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(path)
        # owner only: shutdown and checkpoint-to-any-path must not be
        # issuable by any local user
        os.chmod(path, 0o600)
        self._server.listen(4)
        self._server.settimeout(0.2)
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(0.2)
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()

    def _client_loop(self, conn: socket.socket):
        with conn:
            buf = b""
            while not self._closing:
                try:
                    chunk = conn.recv(4096)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    try:
                        cmd = json.loads(line)
                        if not isinstance(cmd, dict):
                            reply = {"ok": False,
                                     "error": "command must be a JSON "
                                              "object"}
                        else:
                            reply = self.submit(cmd)
                    except Exception as e:  # noqa: BLE001 - reply, not die
                        reply = {"ok": False, "error": str(e)}
                    try:
                        conn.sendall(json.dumps(reply).encode() + b"\n")
                    except OSError:
                        return

    def close(self, timeout: float = 5.0):
        """Stop serving, remove the socket file and wait up to
        ``timeout`` seconds for the accept thread to end."""
        self._closing = True
        if self._server is not None:
            try:
                self._server.close()
            finally:
                self._server = None
        if self._thread is not None:
            self._thread.join(timeout)
        if self._socket_path and os.path.exists(self._socket_path):
            try:
                os.unlink(self._socket_path)
            except OSError:
                pass


def call(socket_path: str, command: dict, timeout: float = 5.0) -> dict:
    """One-shot client: send a command, return the parsed response. Every
    connect, send and receive waits at most ``timeout`` seconds."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall(json.dumps(command).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.split(b"\n", 1)[0])
