"""Native (C++) host-runtime components: frame ring, depth conversion, OBJ.

Port of ``dbot_ros_tpu/native``: the same C++ source (an own copy,
``host_runtime.cpp``) bound by ctypes. The library is built by g++ at
first use (``native/build.py``), never when this module is imported, and
a failed build raises. Each entry point also has a plain NumPy/Python
version, chosen only by an explicit ``native=False``: the tests hold the
two against each other and against the JAX package.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np

from dbot_ros_tpu_torch.native import build as _build

_FP = ctypes.POINTER(ctypes.c_float)


class FrameRing:
    """SPSC depth-frame ring buffer with drop-oldest semantics (a tracker
    wants the freshest frame, not backpressure).

    ``native=True`` (default) uses the C++ ring; ``native=False`` the plain
    version, a ``collections.deque`` with the same pop sequence.
    """

    def __init__(self, frame_shape, capacity: int = 8, native: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.frame_shape = tuple(int(s) for s in frame_shape)
        self.frame_floats = int(np.prod(self.frame_shape))
        self.capacity = int(capacity)
        self._lib = None
        self._ring = None
        self._deque = None
        if native:
            lib = _build.load()
            ring = lib.dbot_ring_create(self.frame_floats, self.capacity)
            if not ring:
                raise MemoryError(
                    f"cannot allocate a ring of {self.capacity} frames "
                    f"of {self.frame_floats} floats")
            self._lib, self._ring = lib, ring
        else:
            self._deque = collections.deque(maxlen=self.capacity)

    @property
    def is_native(self) -> bool:
        return self._ring is not None

    def push(self, frame: np.ndarray, stamp: float = 0.0):
        frame = np.ascontiguousarray(frame, np.float32)
        if frame.size != self.frame_floats:
            raise ValueError(f"frame of {frame.size} values, ring holds "
                             f"{self.frame_floats}")
        if self._ring is not None:
            self._lib.dbot_ring_push(self._ring,
                                     frame.ctypes.data_as(_FP),
                                     float(stamp))
        else:
            self._deque.append((frame.reshape(self.frame_shape).copy(),
                                float(stamp)))

    def pop_latest(self):
        """→ (frame, stamp, skipped) or None if empty."""
        if self._ring is not None:
            out = np.empty(self.frame_shape, np.float32)
            stamp = ctypes.c_double()
            skipped = self._lib.dbot_ring_pop_latest(
                self._ring, out.ctypes.data_as(_FP), ctypes.byref(stamp))
            if skipped < 0:
                return None
            return out, stamp.value, int(skipped)
        if not self._deque:
            return None
        skipped = len(self._deque) - 1
        while len(self._deque) > 1:
            self._deque.popleft()
        frame, stamp = self._deque.popleft()
        return frame, stamp, skipped

    def __len__(self):
        if self._ring is not None:
            return int(self._lib.dbot_ring_size(self._ring))
        return len(self._deque)

    def __del__(self):
        if getattr(self, "_ring", None) is not None:
            self._lib.dbot_ring_destroy(self._ring)
            self._ring = None


def try_parse_obj_native(path: str):
    """Parse an OBJ with the native parser → (V (n,3) f64, F (m,3) i64), or
    None when the parser refuses the file (unreadable, a short vertex
    line, a face index 0 or out of range)."""
    lib = _build.load()
    vp, fp = ctypes.c_void_p(), ctypes.c_void_p()
    nv, nf = ctypes.c_longlong(), ctypes.c_longlong()
    rc = lib.dbot_parse_obj(str(path).encode(), ctypes.byref(vp),
                            ctypes.byref(nv), ctypes.byref(fp),
                            ctypes.byref(nf))
    if rc != 0:
        return None
    try:
        v = np.zeros((0, 3), np.float64)
        f = np.zeros((0, 3), np.int64)
        if nv.value:
            v = np.ctypeslib.as_array(
                ctypes.cast(vp, ctypes.POINTER(ctypes.c_double)),
                shape=(nv.value, 3)).copy()
        if nf.value:
            f = np.ctypeslib.as_array(
                ctypes.cast(fp, ctypes.POINTER(ctypes.c_longlong)),
                shape=(nf.value, 3)).copy()
    finally:
        lib.dbot_free(vp)
        lib.dbot_free(fp)
    return v, f


def preprocess_depth_u16(depth_mm: np.ndarray, downsampling: int,
                         invalid_value: float = float("nan"),
                         native: bool = True) -> np.ndarray:
    """uint16 millimetre depth → float32 metres, strided downsampling
    (the reference's ``ri::to_eigen``), 0 → ``invalid_value``.

    The native path takes uint16 input; other integer or float input
    goes through the plain version, which computes the same float32
    ``d * 1e-3f`` (so the two are bit-equal on uint16) and marks d <= 0.
    """
    downsampling = int(downsampling)
    if downsampling < 1:
        raise ValueError(f"downsampling must be >= 1, got {downsampling}")
    depth_mm = np.asarray(depth_mm)
    h, w = depth_mm.shape
    oh, ow = h // downsampling, w // downsampling
    if native and depth_mm.dtype == np.uint16:
        lib = _build.load()
        src = np.ascontiguousarray(depth_mm)
        out = np.empty((oh, ow), np.float32)
        lib.dbot_preprocess_depth(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), h, w,
            downsampling, 0, ctypes.c_float(invalid_value),
            out.ctypes.data_as(_FP))
        return out
    d = depth_mm[::downsampling, ::downsampling][:oh, :ow]
    out = d.astype(np.float32) * np.float32(1e-3)
    out[d <= 0] = np.float32(invalid_value)
    return out
