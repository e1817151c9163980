"""Port parity of the particle-lineage gather.

``FusedSensor.gather_occlusion`` of the port (through
``kernels.lineage_gather``; on the CPU its plain version) against the JAX
sensor's, for both of the reference's modes the port accepts:
``lineage_gather="pallas"`` (the Pallas kernel in interpret mode, with
its ``take`` fallback past the span cap) and ``"take"``. Compared on the
``(P, N)`` view of the real particles, as tests/test_pallas.py does (the
padding columns differ by design: the port keeps them in place, the
Pallas path maps them to the last real parent).

Tolerance: none. A gather moves bits, so every comparison is exact, in
float32 and in bfloat16. The CUDA kernel is held to the plain version on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu.models import beam as jbeam
from dbot_ros_tpu.models import occlusion as jocc
from dbot_ros_tpu.ops import raycast_pallas as jrp
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.filters import rbcpf
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import kernels
from dbot_ros_tpu_torch.ops import resample as rs
from dbot_ros_tpu_torch.utils import camera

torch.set_num_threads(1)

P = 200                      # two 128-lane groups, 56 padding columns
K_CAM = np.array([[30.0, 0, 10], [0, 30.0, 7.5], [0, 0, 1.0]])
HW = (15, 20)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def parents(kind, P=P):
    """Parent vectors of P entries, from a seed."""
    g = np.random.default_rng(11)
    if kind == "sorted":        # systematic parents of random weights
        w = g.gamma(0.3, size=P)
        cdf = np.cumsum(w / w.sum())
        return np.minimum(np.searchsorted(cdf, (np.arange(P) + 0.37) / P),
                          P - 1).astype(np.int32)
    if kind == "one_parent":
        return np.full(P, (141 * P) // 200, np.int32)
    if kind == "identity":
        return np.arange(P, dtype=np.int32)
    if kind == "unsorted":      # sorted parents with every pair swapped
        return parents("sorted", P).reshape(-1, 2)[:, ::-1].reshape(-1)
    return g.permutation(P).astype(np.int32)      # scattered


def sensors(dtype, mode):
    jdt, pdt = DTYPES[dtype]
    jm = jmesh.box_mesh(0.05, 0.08, 0.04)
    jbp, jop = jbeam.make_beam_params(), jocc.make_occlusion_params()
    js = jrp.make_fused_sensor(jm, jcamera.make_camera(K_CAM, *HW), jbp,
                               jop, interpret=True, occ_dtype=jdt,
                               lineage_gather=mode)
    ps = fs.make_fused_sensor(
        interop.mesh_from_numpy(fields(jm)), camera.make_camera(K_CAM, *HW),
        interop.beam_params_from_numpy(fields(jbp)),
        interop.occlusion_params_from_numpy(fields(jop)), occ_dtype=pdt,
        lineage_gather=mode)
    return js, ps


@pytest.mark.parametrize("kind", ["sorted", "one_parent", "identity",
                                  "scattered"])
@pytest.mark.parametrize("mode", ["pallas", "take"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_occlusion_matches_jax(dtype, mode, kind):
    js, ps = sensors(dtype, mode)
    N = HW[0] * HW[1]
    jdt, pdt = DTYPES[dtype]
    g = np.random.default_rng(5)
    occ_pn = g.uniform(size=(P, N)).astype(np.float32)
    age = g.integers(0, 4, size=(304,)).astype(np.float32)   # n_pad = 320
    age = np.concatenate([age, np.zeros(16, np.float32)])
    jocc_leaf = (jrp.occ_to_kernel(jnp.asarray(occ_pn)).astype(jdt),
                 jnp.asarray(age))
    pocc_leaf = interop.occlusion_from_jax(occ_pn, P, N, age=age,
                                           occ_dtype=pdt)
    par = parents(kind)

    want = js.gather_occlusion(jocc_leaf, jnp.asarray(par))
    before = pocc_leaf[0].clone()
    got = ps.gather_occlusion(pocc_leaf, torch.as_tensor(par).long())

    assert got[0].dtype == pdt and got[0].shape == before.shape
    np.testing.assert_array_equal(
        ps.occlusion_as_pn(got, P).numpy(),
        np.asarray(js.occlusion_as_pn(want, P)))
    # the stored bits themselves moved: real columns follow their parent,
    # padding columns stay, the input map and the ages are untouched
    assert torch.equal(got[0][:, :P], before[:, torch.as_tensor(par).long()])
    assert torch.equal(got[0][:, P:], before[:, P:])
    assert torch.equal(pocc_leaf[0], before)
    assert got[0].data_ptr() != pocc_leaf[0].data_ptr()
    assert got[1] is pocc_leaf[1]


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "one_parent"])
@pytest.mark.parametrize("num", [256, 40], ids=["tile_multiple",
                                                "below_one_tile"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_occlusion_matches_jax_at_tile_edges(dtype, num, kind):
    """The shapes a column-tiled kernel could get wrong: P a multiple of
    the 128-column tile (no padding column behind the parents), P smaller
    than one tile (88 padding columns beside 40 parents), with unsorted
    parents and with one parent for all."""
    js, ps = sensors(dtype, "pallas")
    N = HW[0] * HW[1]
    _, pdt = DTYPES[dtype]
    jdt = DTYPES[dtype][0]
    g = np.random.default_rng(6)
    occ_pn = g.uniform(size=(num, N)).astype(np.float32)
    age = np.zeros(320, np.float32)
    jocc_leaf = (jrp.occ_to_kernel(jnp.asarray(occ_pn)).astype(jdt),
                 jnp.asarray(age))
    pocc_leaf = interop.occlusion_from_jax(occ_pn, num, N, age=age,
                                           occ_dtype=pdt)
    par = parents(kind, num)
    if kind == "unsorted":
        assert (np.diff(par) < 0).any()

    want = js.gather_occlusion(jocc_leaf, jnp.asarray(par))
    before = pocc_leaf[0].clone()
    got = ps.gather_occlusion(pocc_leaf, torch.as_tensor(par).long())

    assert got[0].shape == (320, fs.particle_pad(num))
    np.testing.assert_array_equal(
        ps.occlusion_as_pn(got, num).numpy(),
        np.asarray(js.occlusion_as_pn(want, num)))
    assert torch.equal(got[0][:, :num],
                       before[:, torch.as_tensor(par).long()])
    assert torch.equal(got[0][:, num:], before[:, num:])
    assert torch.equal(pocc_leaf[0], before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lineage_gather_plain_is_a_column_take(dtype):
    g = torch.Generator().manual_seed(3)
    q = torch.rand((96, 256), generator=g).to(dtype)
    idx = torch.randint(0, 256, (256,), generator=g, dtype=torch.int32)
    launches = kernels.lineage_gather.launches
    out = kernels.lineage_gather(q, idx)          # CPU → the plain version
    want = np.take(q.float().numpy(), idx.numpy(), axis=1)
    np.testing.assert_array_equal(out.float().numpy(), want)
    assert out.dtype == dtype
    assert torch.equal(out, kernels.lineage_gather_plain(q, idx))
    # a CPU tensor never launches the kernel
    assert kernels.lineage_gather.launches == launches


def test_gather_occlusion_clamps_and_takes_raw_maps():
    """Out-of-range parents are clamped into the map (the reference's
    ``mode="clip"``); with g < 0 the leaf is the raw map, not a tuple."""
    cam = camera.make_camera(K_CAM, *HW)
    m = interop.mesh_from_numpy(fields(jmesh.box_mesh()))
    from dbot_ros_tpu_torch.models import beam, occlusion
    s = fs.make_fused_sensor(m, cam, beam.make_beam_params(),
                             occlusion.make_occlusion_params(0.4, 0.1),
                             occ_dtype=torch.float32)
    occ = s.init_occlusion(40, 0.1)
    assert isinstance(occ, torch.Tensor) and occ.shape == (320, 128)
    occ = torch.arange(128.0).expand(320, 128).contiguous()
    par = torch.tensor([-3, 500] + list(range(38)))
    out = s.gather_occlusion(occ, par)
    assert isinstance(out, torch.Tensor)
    assert out[0, :4].tolist() == [0.0, 127.0, 0.0, 1.0]
    assert torch.equal(out[:, 40:], occ[:, 40:])


@pytest.mark.parametrize("mode,ok", [("take", True), ("pallas", True),
                                     ("grouped", False),
                                     ("windowed", False)])
def test_lineage_modes_of_the_reference(mode, ok):
    """Configs written for the JAX package keep loading: its "take" and
    "pallas" select the port's one kernel; the TPU workarounds raise."""
    cam = camera.make_camera(K_CAM, *HW)
    m = interop.mesh_from_numpy(fields(jmesh.box_mesh()))
    from dbot_ros_tpu_torch.models import beam, occlusion
    args = (m, cam, beam.make_beam_params(),
            occlusion.make_occlusion_params())
    if ok:
        assert fs.make_fused_sensor(*args, lineage_gather=mode) is not None
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fs.make_fused_sensor(*args, lineage_gather=mode)


def test_rbcpf_resampling_goes_through_the_sensor_gather():
    """``_maybe_resample`` hands the sensor's hook either the systematic
    parents or the identity, every frame."""
    calls = []

    def gather(occ, idx):
        calls.append(idx.clone())
        return occ.index_select(0, idx)

    g = np.random.default_rng(0)
    log_w = torch.tensor(3.0 * g.standard_normal(64), dtype=torch.float32)
    states = torch.zeros((64, 1, 13))
    occ = torch.rand((64, 10))
    for max_kl, want_do in ((0.01, True), (1e3, False)):
        tree, lw2, do, kl = rbcpf._maybe_resample(
            log_w, states, occ, torch.zeros(64), max_kl, gather,
            u=torch.tensor(0.5))
        assert bool(do) == want_do
        idx = calls[-1]
        if want_do:
            assert torch.equal(idx, rs.systematic_indices(
                log_w, 64, u=torch.tensor(0.5)))
            assert bool((idx[1:] >= idx[:-1]).all()) and bool((lw2 == 0).all())
        else:
            assert torch.equal(idx, torch.arange(64))
            assert torch.equal(lw2, log_w)
        assert torch.equal(tree[1], occ.index_select(0, idx))
