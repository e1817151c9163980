"""Triangle meshes as padded tensors + Wavefront OBJ loading.

Port of ``dbot_ros_tpu/utils/mesh.py``. A mesh is a frozen dataclass of
padded tensors plus the object-frame Möller–Trumbore constants
(camera at origin, ray ``t·d``; triangle ``(A, B, C)``, ``e1 = B−A``,
``e2 = C−A``):

    det   = d · g_det,   g_det = e2 × e1
    u_num = d · g_u,     g_u   = A × e2
    v_num = d · g_v,     g_v   = e1 × A
    t_num = A · g_det

Under a rigid transform ``x ↦ R x + τ`` they update affinely (see
ops/raycast.pose_tri_constants and ops/fused_sensor.pack_matrix).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """A single rigid object's triangle mesh, padded.

    Padding triangles are fully degenerate (all vertices 0) → ``g_det = 0``
    → ``det = 0`` for every ray → never a hit. The last row is always
    such a padding row: the "no triangle" target of the candidate pass.

    Tensor fields are float32 except ``faces`` (int64); ``center`` is the
    centroid subtracted at build time.
    """

    vertices: torch.Tensor
    faces: torch.Tensor
    tri_a: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    g_u: torch.Tensor
    g_v: torch.Tensor
    g_det: torch.Tensor
    t_num: torch.Tensor
    center: torch.Tensor
    num_triangles: int
    num_vertices: int

    @property
    def padded_triangles(self) -> int:
        return self.faces.shape[0]

    def to(self, device) -> "TriangleMesh":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def make_mesh(vertices, faces, center: bool = True, pad_to: int = 128,
              device=None) -> TriangleMesh:
    """Build a TriangleMesh from raw arrays (host-side, float64 NumPy math,
    cast to float32 on the way into torch)."""
    v = np.asarray(vertices, np.float64).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    nv, nt = len(v), len(f)
    if nt and (f.min() < 0 or f.max() >= nv):
        raise ValueError(
            f"mesh faces reference vertices outside [0, {nv}): "
            f"range [{f.min()}, {f.max()}]")
    c = v.mean(axis=0) if center else np.zeros(3)
    v = v - c

    a = v[f[:, 0]]
    e1 = v[f[:, 1]] - a
    e2 = v[f[:, 2]] - a
    g_det = np.cross(e2, e1)
    g_u = np.cross(a, e2)
    g_v = np.cross(e1, a)
    t_num = np.einsum("td,td->t", a, g_det)

    # nt + 1 guarantees at least one fully-degenerate padding row, the
    # safe "no triangle" target (candidate id -1 → last row).
    tp = _round_up(max(nt, 1) + 1, pad_to)
    vp = _round_up(max(nv, 1), 8)

    def padt(x):
        out = np.zeros((tp,) + x.shape[1:], np.float32)
        out[:nt] = x
        return torch.from_numpy(out).to(device)

    vpad = np.zeros((vp, 3), np.float32)
    vpad[:nv] = v
    fpad = np.zeros((tp, 3), np.int64)
    fpad[:nt] = f

    return TriangleMesh(
        vertices=torch.from_numpy(vpad).to(device),
        faces=torch.from_numpy(fpad).to(device),
        tri_a=padt(a), tri_e1=padt(e1), tri_e2=padt(e2),
        g_u=padt(g_u), g_v=padt(g_v), g_det=padt(g_det),
        t_num=padt(t_num[:, None])[:, 0].contiguous(),
        center=torch.from_numpy(c.astype(np.float32)).to(device),
        num_triangles=nt,
        num_vertices=nv,
    )


# ---------------------------------------------------------------------------
# Wavefront OBJ parsing
# ---------------------------------------------------------------------------

def parse_obj(text: str):
    """Parse OBJ text → (vertices (V,3) f64, faces (T,3) i64).

    ``v`` and ``f`` records; polygons are fan-triangulated; ``v/vt/vn``
    index forms and negative (relative) indices are handled; everything
    else is ignored.
    """
    verts: list = []
    faces: list = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if line.startswith("v "):
            parts = line.split()
            if len(parts) < 4:
                raise ValueError(
                    f"OBJ line {lineno}: vertex needs 3 coordinates: {line!r}")
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif line.startswith("f "):
            idx = []
            for tok in line.split()[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.append([idx[0], idx[k], idx[k + 1]])
    return np.array(verts, np.float64), np.array(faces, np.int64)


def load_obj(path, center: bool = True, scale: float = 1.0,
             pad_to: int = 128, device=None) -> TriangleMesh:
    """Load a Wavefront .obj file into a TriangleMesh.

    The native C++ parser reads it (built at first use, see
    ``dbot_ros_tpu_torch/native``); a file it refuses goes to the Python
    parser, which raises on what it cannot use, as in the reference.
    """
    from dbot_ros_tpu_torch.native import try_parse_obj_native

    result = try_parse_obj_native(str(path))
    if result is None:
        with open(path, "r") as fh:
            v, f = parse_obj(fh.read())
    else:
        v, f = result
    return make_mesh(v * scale, f, center=center, pad_to=pad_to,
                     device=device)


# ---------------------------------------------------------------------------
# Procedural test meshes
# ---------------------------------------------------------------------------

def _box_arrays(sx, sy, sz):
    """Vertices (8, 3) and faces (12, 3) of an axis-aligned box centred at
    the origin, faces wound counter-clockwise viewed from outside."""
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    v = np.array([[x, y, z] for z in (-hz, hz) for y in (-hy, hy)
                  for x in (-hx, hx)], np.float64)
    # vertex index = x + 2y + 4z (bit order)
    f = np.array([
        [0, 2, 1], [1, 2, 3],  # z = -hz (normal -z)
        [4, 5, 6], [5, 7, 6],  # z = +hz (normal +z)
        [0, 1, 4], [1, 5, 4],  # y = -hy
        [2, 6, 3], [3, 6, 7],  # y = +hy
        [0, 4, 2], [2, 4, 6],  # x = -hx
        [1, 3, 5], [3, 7, 5],  # x = +hx
    ], np.int64)
    return v, f


def _compound(boxes, offsets, center, pad_to, device):
    vs, fs, n = [], [], 0
    for (sx, sy, sz), off in zip(boxes, offsets):
        v, f = _box_arrays(sx, sy, sz)
        # float32 round trip: the reference builds each box as a mesh
        # (float32 storage) before combining
        vs.append(v.astype(np.float32).astype(np.float64)
                  + np.asarray(off, np.float64))
        fs.append(f + n)
        n += len(v)
    return make_mesh(np.concatenate(vs), np.concatenate(fs), center=center,
                     pad_to=pad_to, device=device)


def box_mesh(sx=0.1, sy=0.1, sz=0.1, center: bool = True,
             pad_to: int = 128, device=None) -> TriangleMesh:
    """Axis-aligned box of the given side lengths, 12 triangles."""
    v, f = _box_arrays(sx, sy, sz)
    return make_mesh(v, f, center=center, pad_to=pad_to, device=device)


def l_shape_mesh(center: bool = True, pad_to: int = 128,
                 scale: float = 1.0, device=None) -> TriangleMesh:
    """Asymmetric L-shaped compound (two boxes)."""
    s = scale
    return _compound([(0.12 * s, 0.04 * s, 0.06 * s),
                      (0.04 * s, 0.08 * s, 0.06 * s)],
                     [np.zeros(3), np.array([-0.04, 0.06, 0.0]) * s],
                     center, pad_to, device)


def tagged_l_mesh(center: bool = True, pad_to: int = 128,
                  scale: float = 1.0, device=None) -> TriangleMesh:
    """L-shape with a corner tag (three boxes): no approximate π-twin."""
    s = scale
    return _compound([(0.12 * s, 0.04 * s, 0.06 * s),
                      (0.04 * s, 0.08 * s, 0.06 * s),
                      (0.035 * s, 0.035 * s, 0.05 * s)],
                     [np.zeros(3), np.array([-0.04, 0.06, 0.0]) * s,
                      np.array([0.085, 0.005, 0.055]) * s],
                     center, pad_to, device)


def icosphere_mesh(radius=0.05, subdivisions=2, center: bool = True,
                   pad_to: int = 128, device=None) -> TriangleMesh:
    """Icosphere (20 · 4^s triangles) for curvature-bearing test scenes."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        cache: dict = {}
        verts = list(map(tuple, v))
        newf = []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (np.array(verts[i]) + np.array(verts[j])) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(tuple(m))
            return cache[key]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            newf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.array(verts, np.float64)
        f = np.array(newf, np.int64)
    return make_mesh(v * radius, f, center=center, pad_to=pad_to,
                     device=device)
