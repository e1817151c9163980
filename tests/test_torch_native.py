"""The port's native host runtime (``dbot_ros_tpu_torch/native``) against
the JAX package's and against its own plain versions.

Both packages compile the same C++ source, so the comparisons are exact:
the depth conversion bit for bit (NaN where the reference has NaN), the
ring's pop sequence (frame, stamp, skipped) value for value, the OBJ
parser's vertices and faces equal to the Python parser's. The plain
versions (``native=False``) must give the same bits, since the port
chooses between the two only by that argument, never by a failed build.
"""

import threading

import numpy as np
import pytest

from dbot_ros_tpu import native as jnative
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu_torch import native
from dbot_ros_tpu_torch.native import build
from dbot_ros_tpu_torch.utils import mesh

OBJ_TEXT = ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
            "f 1/1/1 2/2/1 3/3/1 4/4/1\nf 1//1 2//1 5//1\nf -3 -2 -1\n")


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("downsampling", [1, 3, 4])
@pytest.mark.parametrize("use_native", [True, False])
def test_preprocess_depth_u16_is_bit_equal_to_jax(downsampling, use_native):
    rng = np.random.default_rng(downsampling)
    raw = rng.integers(0, 65535, size=(48, 64), dtype=np.uint16)
    raw[::7, ::5] = 0                                   # dropouts
    raw[1, :] = 65535
    want = jnative.preprocess_depth_u16(raw, downsampling)
    got = native.preprocess_depth_u16(raw, downsampling, native=use_native)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(bits(got), bits(want))


def test_preprocess_depth_u16_invalid_value_and_bad_factor():
    raw = np.array([[0, 1500], [2000, 0]], np.uint16)
    for use_native in (True, False):
        out = native.preprocess_depth_u16(raw, 1, invalid_value=-1.0,
                                          native=use_native)
        mm = np.float32(1e-3)          # float32 d * 1e-3f, as the C++ does
        np.testing.assert_array_equal(out, np.array(
            [[-1.0, 1500 * mm], [2000 * mm, -1.0]], np.float32))
        with pytest.raises(ValueError, match="downsampling"):
            native.preprocess_depth_u16(raw, 0, native=use_native)


def ring_trace(ring, pushes, pops_after):
    """Push frames ``0..pushes-1`` (filled with their index), popping
    after the pushes named in ``pops_after``; → the pop sequence."""
    out = []
    for i in range(pushes):
        ring.push(np.full((4, 4), float(i), np.float32), stamp=float(i))
        if i in pops_after:
            item = ring.pop_latest()
            out.append(None if item is None else
                       (float(item[0][0, 0]), item[1], item[2], len(ring)))
    return out


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_frame_ring_pops_as_jax(use_native, capacity):
    pops_after = {0, 1, 4, 5, 11, 12, 13, 20, 29}
    want = ring_trace(jnative.FrameRing((4, 4), capacity), 30, pops_after)
    ring = native.FrameRing((4, 4), capacity, native=use_native)
    assert ring.is_native == use_native
    assert ring_trace(ring, 30, pops_after) == want
    assert ring.pop_latest() is None and len(ring) == 0


def test_frame_ring_refuses_a_frame_of_another_size():
    for use_native in (True, False):
        ring = native.FrameRing((4, 4), 2, native=use_native)
        with pytest.raises(ValueError, match="16"):
            ring.push(np.zeros(15, np.float32))


@pytest.mark.parametrize("use_native", [True, False])
def test_frame_ring_threaded_producer(use_native):
    ring = native.FrameRing((8, 8), capacity=16, native=use_native)
    n = 300

    def produce():
        for i in range(n):
            ring.push(np.full((8, 8), float(i), np.float32), stamp=float(i))

    t = threading.Thread(target=produce)
    t.start()
    seen, got = -1.0, 0
    while t.is_alive() or len(ring):
        item = ring.pop_latest()
        if item is not None:
            frame, stamp, _ = item
            assert stamp > seen                        # freshest, in order
            assert np.all(frame == stamp)              # no torn frame
            seen = stamp
            got += 1
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == float(n - 1)                        # last frame delivered
    assert got >= 1


def test_native_obj_parser_matches_python(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text(OBJ_TEXT)
    v_py, f_py = mesh.parse_obj(OBJ_TEXT)
    v_c, f_c = native.try_parse_obj_native(str(p))
    np.testing.assert_array_equal(v_c, v_py)
    np.testing.assert_array_equal(f_c, f_py)
    v_j, f_j = jnative.try_parse_obj_native(str(p))
    np.testing.assert_array_equal(v_c, v_j)
    np.testing.assert_array_equal(f_c, f_j)


@pytest.mark.parametrize("text", ["v 0 0 0\nf 1 2 3\n",      # missing verts
                                  "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 0 1 2\n",
                                  "v 0 0\n"])
def test_native_obj_parser_refuses_bad_files_as_jax(tmp_path, text):
    p = tmp_path / "bad.obj"
    p.write_text(text)
    assert native.try_parse_obj_native(str(p)) is None
    assert jnative.try_parse_obj_native(str(p)) is None
    # load_obj then hands the file to the Python parser, which raises
    # what the reference's load_obj raises
    with pytest.raises(Exception) as want:
        jmesh.load_obj(str(p))
    with pytest.raises(type(want.value)):
        mesh.load_obj(str(p))


def test_load_obj_reads_through_the_native_parser(tmp_path, monkeypatch):
    p = tmp_path / "m.obj"
    p.write_text(OBJ_TEXT)
    calls = []
    real = native.try_parse_obj_native

    def spy(path):
        calls.append(path)
        return real(path)

    monkeypatch.setattr(native, "try_parse_obj_native", spy)
    got = mesh.load_obj(str(p), scale=2.0)
    assert calls == [str(p)]
    want = jmesh.load_obj(str(p), scale=2.0)
    assert got.num_triangles == want.num_triangles == 4
    np.testing.assert_array_equal(got.faces.numpy(), np.asarray(want.faces))
    np.testing.assert_allclose(got.vertices.numpy(),
                               np.asarray(want.vertices), atol=1e-7)


def test_library_is_keyed_on_source_flags_and_cpu(monkeypatch):
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert build.build() == path and path.exists()
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ("-g",))
    assert build.library_path() != path
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS[:-1])
    monkeypatch.setattr(build, "_cpu_signature", lambda: "another cpu")
    assert build.library_path() != path


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "host_runtime.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(build.NativeBuildError, match="g\\+\\+ failed"):
        build.build()
    monkeypatch.setenv("CXX", "no-such-compiler-dbot")
    with pytest.raises(build.NativeBuildError, match="not found"):
        build.build()
