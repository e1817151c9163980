"""Port parity of the fused sensor and its three kernels.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does; the port runs the plain PyTorch versions of
its CUDA kernels (the CPU path of ops/kernels.py). The CUDA kernels are
held against those plain versions on the card by tests/test_torch_cuda.py
and by chip_smoke.py.

Tolerances, and why:
  * kernel inputs identical (slabs converted from the JAX layout): the
    per-(pixel, particle) math is the same float32 sequence, so the
    occlusion posterior agrees to 1e-6 in float32 and to one bf16 step
    (4e-3 on [0, 1]) in bfloat16; loglik sums ~1e3 terms in another
    order: rtol 1e-5 + 1e-3 nats;
  * whole sensor: slabs and candidates come from each side's own float32
    products (different summation order), so loglik is held to
    rtol 2e-5 + 1e-2 nats, the occlusion to 1e-5 (f32) / 4e-3 (bf16);
  * row gather/scatter move bits: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu.models import beam as jbeam
from dbot_ros_tpu.models import occlusion as jocc
from dbot_ros_tpu.ops import deferred as jdeferred
from dbot_ros_tpu.ops import raycast as jraycast
from dbot_ros_tpu.ops import raycast_pallas as jrp
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu.utils import se3 as jse3
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import kernels
from dbot_ros_tpu_torch.utils import camera

torch.set_num_threads(1)

CAMERAS = {  # (height, width) → intrinsics
    (32, 32): [[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]],
    (30, 40): [[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]],
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LOG_P_INVALID_BG = float(np.log(np.float32(0.3)))


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def n(x):
    return np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def perturbed_poses(g, P, center, dpos=0.005, drot=0.03):
    q = np.asarray(jse3.quat_boxplus(
        jnp.asarray(np.tile([1.0, 0, 0, 0], (P, 1)), jnp.float32),
        jnp.asarray(drot * g.standard_normal((P, 3)), jnp.float32)))
    p = np.asarray(center) + dpos * g.standard_normal((P, 3))
    return np.concatenate([p, q], axis=1).astype(np.float32)


def observed_depth(g, jm, jcam, center):
    """A noisy frame of the mesh at ``center`` with NaN and finite
    out-of-range (0.3 m < min_depth) pixels."""
    ref = jnp.asarray(list(center) + [1.0, 0, 0, 0], jnp.float32)
    z = np.asarray(jraycast.raycast_depth(jm, ref, jcam.rays, 128))
    z = np.where(np.isfinite(z), z, 2.0).astype(np.float32)
    z = z + 0.002 * g.standard_normal(z.shape).astype(np.float32)
    hit = np.flatnonzero(z < 1.5)
    z[hit[::9]] = 0.3
    z[::37] = np.nan
    return z


@dataclasses.dataclass
class Scene:
    jcam: object
    pcam: object
    jm: object
    pm: object
    jbp: object
    jop: object
    bp: object
    op: object


def scene(hw, p_ov=0.1, p_oo=0.7):
    K = np.asarray(CAMERAS[hw])
    jm = jmesh.l_shape_mesh()
    jbp = jbeam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    jop = jocc.make_occlusion_params(p_ov, p_oo)
    return Scene(jcamera.make_camera(K, *hw), camera.make_camera(K, *hw),
                 jm, interop.mesh_from_numpy(fields(jm)), jbp, jop,
                 interop.beam_params_from_numpy(fields(jbp)),
                 interop.occlusion_params_from_numpy(fields(jop)))


def jax_slabs_to_port(jgt, P):
    """(T, 10·pr, 128) JAX slabs → the port's (T, 10, p_pad) layout."""
    a = np.asarray(jgt)
    T = a.shape[0]
    return t(a.reshape(T, 10, -1)[:, :, :fs.particle_pad(P)])


def test_pack_constants_matches_jax():
    s = scene((32, 32))
    P = 200
    poses = perturbed_poses(np.random.default_rng(0), P, (0.0, 0.0, 0.6),
                            drot=0.5)
    jp_pad, _ = interop.jax_particle_pads(P)
    want = np.asarray(jrp.pack_constants(s.jm, jnp.asarray(poses), jp_pad))
    want = want.reshape(want.shape[0], 10, jp_pad)
    got = n(fs.pack_constants(s.pm, t(poses), fs.particle_pad(P)))
    assert got.shape == (s.pm.padded_triangles, 10, 256)
    np.testing.assert_allclose(got[:, :, :P], want[:, :, :P], atol=1e-6)
    assert not got[:, :, P:].any()       # padding particles: zero → miss
    np.testing.assert_array_equal(n(fs.pack_matrix(s.pm)),
                                  np.asarray(jrp.pack_matrix(s.jm)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [(32, 32), (30, 40)])
def test_fused_loglik_plain_matches_pallas(hw, dtype):
    """The plain fused kernel vs ``fused_loglik_packed`` (interpret) on
    identical inputs, with lazy ages, NaN and out-of-range depths; at
    30×40 (N = 1200, N % 64 ≠ 0) both include the pixel-padding
    constant (n_pad − N)·log p_invalid_background."""
    jdt, tdt = DTYPES[dtype]
    s = scene(hw)
    g = np.random.default_rng(1)
    P, N = 96, hw[0] * hw[1]
    poses = perturbed_poses(g, P, (0.0, 0.0, 0.6))
    z = observed_depth(g, s.jm, s.jcam, (0.0, 0.0, 0.6))
    ref = jnp.asarray([0.0, 0.0, 0.6, 1.0, 0, 0, 0], jnp.float32)
    _, ids = jdeferred.raycast_ids(s.jm, ref, s.jcam.rays, 128)
    cand = jdeferred.candidate_ids(ids, *hw, 2, 2)
    cand = np.asarray(jnp.where(cand >= 0, cand, s.jm.padded_triangles - 1),
                      np.int32)
    occ0 = (0.4 * g.uniform(size=(P, N))).astype(np.float32)
    ages = g.integers(0, 5, N).astype(np.float32)
    pv = jrp.make_params_vec(s.jbp, s.jop, jnp.float32(1.0), 0.2)
    jgt = jrp.pack_constants(s.jm, jnp.asarray(poses),
                             interop.jax_particle_pads(P)[0])

    ll_j, occ_j = jrp.fused_loglik_packed(
        jgt, jrp.occ_to_kernel(jnp.asarray(occ0)).astype(jdt),
        jnp.asarray(z), jnp.asarray(cand), s.jcam.rays, pv, P,
        interpret=True, ages=jnp.asarray(ages))
    gt = jax_slabs_to_port(jgt, P)
    occ_m = fs.occ_to_map(t(occ0)).to(tdt)
    args = (t(z), torch.tensor(cand), s.pcam.rays, t(pv))
    ll_p, occ_p = fs.fused_loglik_packed(
        gt, occ_m, *args, P, ages=t(ages),
        tri_slack=t(pv)[15].expand(gt.shape[0]))
    assert occ_p.dtype == tdt and occ_p.shape == occ_m.shape
    np.testing.assert_allclose(n(ll_p), np.asarray(ll_j), rtol=1e-5,
                               atol=1e-3)
    want = np.asarray(jrp.occ_from_kernel(occ_j, N, P), np.float32)
    got = n(fs.occ_from_map(occ_p, N, P))
    np.testing.assert_allclose(got, want, atol=1e-6 if dtype == "f32"
                               else 4e-3)
    # the padding constant, explicitly: the same pixels unpadded
    ll_unpadded, _ = kernels.fused_loglik_plain(
        gt, occ_m[:N], args[0], args[1].int(), args[2], t(ages), args[3],
        args[3][15].expand(gt.shape[0]))
    n_pad = -(-N // 64) * 64
    np.testing.assert_allclose(n(ll_p - ll_unpadded[:P]),
                               (n_pad - N) * LOG_P_INVALID_BG, atol=2e-3)


def hard_candidates(case, g, N, T):
    """``(n_pixels, cand)`` for the inputs a kernel that reuses slabs
    between pixels, skips degenerate slabs and deals pixels to blocks in
    runs could get wrong. ``T - 1`` is the degenerate slab."""
    n_px, K = N, 2
    if case == "one_slab":           # every pixel, both slots: triangle 3
        cand = np.full((N, K), 3)
    elif case == "distinct_slabs":   # no pixel shares a slab with a neighbour
        cand = (np.arange(N)[:, None] * K + np.arange(K)) % (T - 1)
    elif case == "degenerate_only":
        cand = np.full((N, K), T - 1)
    elif case == "swapped_slots":    # a pixel's slabs in the other order next
        base = g.integers(0, T - 1, (N // 2, K))
        cand = np.stack([base, base[:, ::-1]], 1).reshape(N, K)
    elif case == "k1":
        cand = g.integers(0, T, (N, 1))
    elif case == "k3":
        cand = g.integers(0, T, (N, 3))
        cand[::5, 2] = cand[::5, 0]  # a repeated triangle within a pixel
    elif case == "k5":
        cand = g.integers(0, T, (N, 5))
    elif case == "ragged_n":         # 1000 pixels: 15 runs of 64 and 40 more
        n_px = 1000
        cand = g.integers(0, T, (n_px, K))
    else:
        raise ValueError(case)
    return n_px, cand.astype(np.int32)


HARD_CASES = ["one_slab", "distinct_slabs", "degenerate_only",
              "swapped_slots", "k1", "k3", "k5", "ragged_n"]


@pytest.mark.parametrize("case", HARD_CASES)
def test_fused_loglik_plain_matches_pallas_on_hard_candidates(case):
    """The plain fused kernel vs ``fused_loglik_packed`` (interpret) on
    hand-made candidate tables (see ``hard_candidates``), bfloat16 map,
    lazy ages, NaN and out-of-range depths."""
    jdt, tdt = DTYPES["bf16"]
    hw = (32, 32)
    s = scene(hw)
    g = np.random.default_rng(7)
    P = 96
    T = s.jm.padded_triangles
    N, cand = hard_candidates(case, g, hw[0] * hw[1], T)
    n_pad = -(-N // 64) * 64
    poses = perturbed_poses(g, P, (0.0, 0.0, 0.6))
    z = observed_depth(g, s.jm, s.jcam, (0.0, 0.0, 0.6))[:N]
    occ0 = (0.4 * g.uniform(size=(P, n_pad))).astype(np.float32)
    ages = g.integers(0, 5, N).astype(np.float32)
    pv = jrp.make_params_vec(s.jbp, s.jop, jnp.float32(1.0), 0.2)
    jgt = jrp.pack_constants(s.jm, jnp.asarray(poses),
                             interop.jax_particle_pads(P)[0])

    ll_j, occ_j = jrp.fused_loglik_packed(
        jgt, jrp.occ_to_kernel(jnp.asarray(occ0)).astype(jdt),
        jnp.asarray(z), jnp.asarray(cand), s.jcam.rays[:N], pv, P,
        interpret=True, ages=jnp.asarray(ages))
    gt = jax_slabs_to_port(jgt, P)
    occ_m = fs.occ_to_map(t(occ0)).to(tdt)
    ll_p, occ_p = fs.fused_loglik_packed(
        gt, occ_m, t(z), torch.tensor(cand), s.pcam.rays[:N], t(pv), P,
        ages=t(ages), tri_slack=t(pv)[15].expand(gt.shape[0]))
    assert occ_p.dtype == tdt and occ_p.shape == (n_pad, fs.particle_pad(P))
    np.testing.assert_allclose(n(ll_p), np.asarray(ll_j), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(
        n(fs.occ_from_map(occ_p, n_pad, P)),
        np.asarray(jrp.occ_from_kernel(occ_j, n_pad, P), np.float32),
        atol=4e-3)
    if case == "degenerate_only":    # no hit: every particle sums the
        assert np.ptp(n(ll_p)) == 0  # same background terms


def test_pixel_rows_match_pallas():
    """Row gather (duplicates allowed) and the in-place row scatter on the
    port's map vs the Pallas kernels (interpret) on the JAX layout."""
    g = np.random.default_rng(2)
    P, N = 300, 1200
    n_pad = 1216
    jp_pad, pr = interop.jax_particle_pads(P)
    qj = jnp.asarray(g.uniform(size=(n_pad * pr, 128)), jnp.bfloat16)
    q = interop.occlusion_from_jax(np.asarray(qj, np.float32), P, N,
                                   occ_dtype=torch.bfloat16)
    p_pad = fs.particle_pad(P)

    sel_g = g.integers(0, n_pad, 64).astype(np.int32)
    sel_g[5] = sel_g[9]                                  # a duplicate
    want = np.asarray(jrp.gather_pixel_rows(qj, jnp.asarray(sel_g), pr,
                                            interpret=True), np.float32)
    got = kernels.gather_pixel_rows(q, torch.as_tensor(sel_g))
    np.testing.assert_array_equal(
        n(got), want.reshape(64, jp_pad)[:, :p_pad])

    sel_s = g.permutation(n_pad)[:64].astype(np.int32)   # distinct
    vals_j = jnp.asarray(g.uniform(size=(64 * pr, 128)), jnp.bfloat16)
    vals = t(np.asarray(vals_j, np.float32).reshape(64, jp_pad)[:, :p_pad]
             ).to(torch.bfloat16)
    want = np.asarray(jrp.scatter_pixel_rows(qj, vals_j, jnp.asarray(sel_s),
                                             pr, interpret=True),
                      np.float32).reshape(n_pad, jp_pad)[:, :p_pad]
    before = q.clone()
    out = kernels.scatter_pixel_rows(q, vals, torch.as_tensor(sel_s))
    assert out is q                                      # in place
    np.testing.assert_array_equal(n(q), want)
    untouched = np.setdiff1d(np.arange(n_pad), sel_s)
    assert torch.equal(q[untouched], before[untouched])


LEVELS = [(0.1, 0.5), (0.2, 0.75)]
# object depth per frame → tight level (0.8 m), second level (0.5 m),
# full fallback (0.3 m: more active pixels than the second level holds)
FRAME_DEPTHS = [0.8, 0.8, 0.5, 0.3, 0.8, 0.5]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_sensor_ladder_matches_jax(dtype):
    """FusedSensor vs make_fused_sensor over frames that run the tight
    level, the second level and the full fallback, in a row, so lazy
    ages grow on the pixels a frame skips."""
    jdt, tdt = DTYPES[dtype]
    s = scene((30, 40))
    P, N = 96, 1200
    js = jrp.make_fused_sensor(s.jm, s.jcam, s.jbp, s.jop, interpret=True,
                               levels=LEVELS, occ_dtype=jdt)
    ps = fs.make_fused_sensor(s.pm, s.pcam, s.bp, s.op, levels=LEVELS,
                              occ_dtype=tdt)
    jstep = jax.jit(lambda st, o, z, dt: js(st, o, z, dt))
    jocc_ = js.init_occlusion(P, 0.1)
    pocc = ps.init_occlusion(P, 0.1)
    g = np.random.default_rng(3)
    caps = ps.caps(N)
    levels_run = []
    for f, depth in enumerate(FRAME_DEPTHS):
        center = (0.004 * f, -0.003 * f, depth)
        states = np.zeros((P, 1, 13), np.float32)
        states[:, 0, :7] = perturbed_poses(g, P, center)
        z = observed_depth(g, s.jm, s.jcam, center)
        ll_j, jocc_ = jstep(jnp.asarray(states), jocc_, jnp.asarray(z),
                            jnp.float32(1.0 / 30.0))
        book = ps.selection(ps.candidates(t(states)))
        levels_run.append(next(
            (i for i, (pc, tc) in enumerate(caps)
             if float(book["n_active"]) <= pc
             and float(book["n_uniq"]) < tc), len(caps)))
        ll_p, pocc = ps(t(states), pocc, t(z), 1.0 / 30.0)
        np.testing.assert_allclose(n(ll_p), np.asarray(ll_j), rtol=2e-5,
                                   atol=1e-2)
        np.testing.assert_allclose(
            n(ps.occlusion_as_pn(pocc, P)),
            np.asarray(js.occlusion_as_pn(jocc_, P), np.float32),
            atol=1e-5 if dtype == "f32" else 4e-3)
        np.testing.assert_array_equal(n(pocc[1][:N]),
                                      np.asarray(jocc_[1][:N]))
    assert sorted(set(levels_run)) == [0, 1, 2], levels_run


def test_fused_sensor_eager_chain_matches_jax():
    """With g < 0 the occlusion leaf is the raw map (no lazy ages): both
    take the eager branch on a compacted level (the selected rows through
    the kernel, the whole map propagated, the rows written back)."""
    s = scene((32, 32), p_ov=0.4, p_oo=0.1)
    P, N = 64, 1024
    js = jrp.make_fused_sensor(s.jm, s.jcam, s.jbp, s.jop, interpret=True,
                               occ_dtype=jnp.float32)
    ps = fs.make_fused_sensor(s.pm, s.pcam, s.bp, s.op,
                              occ_dtype=torch.float32)
    jocc_, pocc = js.init_occlusion(P, 0.2), ps.init_occlusion(P, 0.2)
    assert isinstance(pocc, torch.Tensor)
    g = np.random.default_rng(4)
    jstep = jax.jit(lambda st, o, z: js(st, o, z, jnp.float32(1 / 30.0)))
    for f in range(2):
        states = np.zeros((P, 1, 13), np.float32)
        states[:, 0, :7] = perturbed_poses(g, P, (0.0, 0.0, 0.6))
        z = observed_depth(g, s.jm, s.jcam, (0.0, 0.0, 0.6))
        ll_j, jocc_ = jstep(jnp.asarray(states), jocc_, jnp.asarray(z))
        ll_p, pocc = ps(t(states), pocc, t(z), 1.0 / 30.0)
        assert ps.last_level < len(ps.caps(N)), ps.last_level
        np.testing.assert_allclose(n(ll_p), np.asarray(ll_j), rtol=2e-5,
                                   atol=1e-2)
        np.testing.assert_allclose(n(ps.occlusion_as_pn(pocc, P)),
                                   np.asarray(js.occlusion_as_pn(jocc_, P)),
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_materialize_occlusion_is_occlusion_as_pn_rounded_once(dtype):
    """Where ``now``, ``materialize_occlusion`` gives every value of
    ``occlusion_as_pn`` (the reference's closed form) rounded once to the
    map's dtype, and zero ages; where not, the leaf's values and ages bit
    for bit. On the CPU the row aging is its plain version (no launch)."""
    _, tdt = DTYPES[dtype]
    s = scene((30, 40))
    P = 96
    ps = fs.make_fused_sensor(s.pm, s.pcam, s.bp, s.op, occ_dtype=tdt)
    q0, age0 = ps.init_occlusion(P, 0.1)
    g = np.random.default_rng(9)
    q = t(g.uniform(size=tuple(q0.shape))).to(tdt)
    q[0], q[1] = 0.0, 1.0
    age = t(g.integers(0, 7, tuple(age0.shape)))
    age[::3] = 0.0
    leaf = (q, age)
    launches = kernels.age_pixel_rows.launches
    q_now, age_now = ps.materialize_occlusion(leaf, torch.tensor(True))
    assert q_now.dtype == tdt and not torch.equal(q_now, q)
    assert torch.equal(age_now, torch.zeros_like(age))
    np.testing.assert_array_equal(
        n(ps.occlusion_as_pn((q_now, age_now), P)),
        n(ps.occlusion_as_pn(leaf, P).to(tdt)))
    q_still, age_still = ps.materialize_occlusion(leaf, torch.tensor(False))
    assert torch.equal(q_still, q) and torch.equal(age_still, age)
    assert kernels.age_pixel_rows.launches == launches


def test_fused_sensor_contract():
    """Leaf structure in == out, q in [0, 1], finite loglik; lineage
    gather replicates a parent; commit=False leaves the map alone."""
    s = scene((32, 32))
    P = 64
    ps = fs.make_fused_sensor(s.pm, s.pcam, s.bp, s.op, nb=32)
    g = np.random.default_rng(5)
    states = np.zeros((P, 1, 13), np.float32)
    states[:, 0, :7] = perturbed_poses(g, P, (0.0, 0.0, 0.6))
    z = t(observed_depth(g, s.jm, s.jcam, (0.0, 0.0, 0.6)))
    occ = ps.init_occlusion(P, 0.1)
    q_before = occ[0].clone()
    ll_dry, occ_dry = ps(t(states), occ, z, 1 / 30.0, commit=False)
    assert occ_dry is occ and torch.equal(occ[0], q_before)
    ll, occ_post = ps(t(states), occ, z, 1 / 30.0)
    torch.testing.assert_close(ll, ll_dry)
    assert ll.shape == (P,) and bool(torch.isfinite(ll).all())
    assert isinstance(occ_post, tuple) and len(occ_post) == 2
    for a, b in zip(occ_post, (q_before, occ[1])):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert bool(((occ_post[0] >= 0) & (occ_post[0] <= 1)).all())
    occ_pn = ps.occlusion_as_pn(occ_post, P)
    gathered = ps.gather_occlusion(occ_post, torch.full((P,), 5))
    np.testing.assert_array_equal(
        n(ps.occlusion_as_pn(gathered, P)),
        np.tile(n(occ_pn[5])[None], (P, 1)))
