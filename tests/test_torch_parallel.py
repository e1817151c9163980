"""Port parity of the scale-out slice inside one process: the fused
sensor's exchange hooks, the two-width lineage gather's plain version, the
state carried across from the JAX package, and the distributed step on a
group of one rank.

The hooks are held to the JAX sensor's (Pallas in interpret mode) on the
(P, N) view of the real particles: a gather moves bits, so these are
exact. The one-rank step runs on a gloo group over a ``HashStore`` and is
held to JAX's ``make_distributed_step`` on ``make_particle_mesh(1)`` with
JAX's draws replayed (``fold_in(fold_in(k_trans, b), 0)`` for the
transition, ``fold_in(k_res_base, b)`` for ``u``): states 2e-5, log
weights rtol 1e-6 + 1e-2 nats, occlusion 1e-5, and at most one parent per
resampling block may move to its neighbour at a CDF tie (the two packages
sum the loglik in another order; see test_torch_tracker.py).
"""

import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dbot_ros_tpu.models import beam as jbeam
from dbot_ros_tpu.models import occlusion as jocc
from dbot_ros_tpu.models import transition as jtrans
from dbot_ros_tpu.models.sensor import render_scene
from dbot_ros_tpu.ops import raycast_pallas as jrp
from dbot_ros_tpu.parallel import dist_filter as jdist
from dbot_ros_tpu.utils import camera as jcamera
from dbot_ros_tpu.utils import mesh as jmesh
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.filters import rbcpf
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import kernels
from dbot_ros_tpu_torch.parallel import comm as comm_mod
from dbot_ros_tpu_torch.parallel import dist_filter
from dbot_ros_tpu_torch.utils import camera

torch.set_num_threads(1)

K_CAM = np.array([[30.0, 0, 10], [0, 30.0, 7.5], [0, 0, 1.0]])
HW = (15, 20)
N = HW[0] * HW[1]


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def n(x):
    return np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def sensors():
    jm = jmesh.box_mesh(0.05, 0.08, 0.04)
    jbp, jop = jbeam.make_beam_params(), jocc.make_occlusion_params()
    js = jrp.make_fused_sensor(jm, jcamera.make_camera(K_CAM, *HW), jbp,
                               jop, interpret=True, occ_dtype=jnp.float32)
    ps = fs.make_fused_sensor(
        interop.mesh_from_numpy(fields(jm)), camera.make_camera(K_CAM, *HW),
        interop.beam_params_from_numpy(fields(jbp)),
        interop.occlusion_params_from_numpy(fields(jop)),
        occ_dtype=torch.float32)
    return js, ps


def leaves(num, seed):
    """The same occlusion state of ``num`` particles in both layouts."""
    g = np.random.default_rng(seed)
    occ_pn = g.uniform(size=(num, N)).astype(np.float32)
    age = np.concatenate([g.integers(0, 4, size=N),
                          np.zeros(320 - N)]).astype(np.float32)
    jleaf = (jrp.occ_to_kernel(jnp.asarray(occ_pn)), jnp.asarray(age))
    return occ_pn, jleaf, interop.occlusion_from_jax(occ_pn, num, N,
                                                     age=age)


def test_particle_stride_is_the_ports_128_column_rounding():
    """A divergence by design: the port's blocks are 128-column multiples,
    JAX's round the 128-lane row groups up to 8 (1024 lanes)."""
    js, ps = sensors()
    for num in (1, 40, 128, 200, 1100, 5000):
        assert ps.particle_stride(num) == -(-num // 128) * 128
        assert js.particle_stride(num) == interop.jax_particle_pads(num)[0]
    assert ps.particle_stride(200) == 256 and js.particle_stride(200) == 1024


def test_concat_and_gather_from_a_concat_match_jax():
    """Two 40-particle blocks concatenated, then a gather of 80 parents
    out of the concat (the all_gather exchange's ``num_in = S·stride``):
    equal to JAX's on the (P, N) view, ages of the first block."""
    js, ps = sensors()
    L = 40
    blocks = [leaves(L, s) for s in (1, 2)]
    jcat = js.concat_occlusion([b[1] for b in blocks], L)
    pcat = ps.concat_occlusion([b[2] for b in blocks], L)
    sj, sp = js.particle_stride(L), ps.particle_stride(L)
    assert pcat[0].shape == (320, 2 * sp)
    for s, (occ_pn, _, _) in enumerate(blocks):
        np.testing.assert_array_equal(n(pcat[0][:N, s * sp:s * sp + L]).T,
                                      occ_pn)
        np.testing.assert_array_equal(
            np.asarray(jcat[0]).reshape(320, -1)[:N, s * sj:s * sj + L].T,
            occ_pn)
    assert pcat[1] is blocks[0][2][1]
    np.testing.assert_array_equal(np.asarray(jcat[1]), n(pcat[1]))

    g = np.random.default_rng(3)
    parents = np.sort(g.integers(0, 2 * L, size=2 * L))
    owner, local = parents // L, parents % L
    jgot = js.gather_occlusion(jcat, jnp.asarray(owner * sj + local),
                               num_in=2 * sj)
    pgot = ps.gather_occlusion(pcat, torch.as_tensor(owner * sp + local),
                               num_in=2 * sp)
    assert pgot[0].shape == (320, ps.particle_stride(2 * L))
    want = np.concatenate([b[0] for b in blocks])[parents]
    np.testing.assert_array_equal(n(ps.occlusion_as_pn(pgot, 2 * L)),
                                  np.asarray(js.occlusion_as_pn(jgot, 2 * L)))
    np.testing.assert_array_equal(
        n(pgot[0][:N, :2 * L]).T, want)
    # padding columns take min(c, num_in - 1), as JAX's pad_idx
    pads = np.minimum(np.arange(2 * L, pgot[0].shape[1]), 2 * sp - 1)
    assert torch.equal(pgot[0][:, 2 * L:], pcat[0][:, pads])


def test_gather_into_and_out_of_a_surplus_buffer_matches_jax():
    """The counts exchange's two gathers: C = 128 columns out of a
    200-particle map (``num_in = stride(L)``), then 200 out of one
    received buffer (``num_in = stride(C)``)."""
    js, ps = sensors()
    L, C = 200, 128
    occ_pn, jleaf, pleaf = leaves(L, 4)
    rows = np.zeros(C, np.int32)
    rows[:37] = np.arange(0, 185, 5)
    jbuf = js.gather_occlusion(jleaf, jnp.asarray(rows),
                               num_in=js.particle_stride(L))
    pbuf = ps.gather_occlusion(pleaf, torch.as_tensor(rows),
                               num_in=ps.particle_stride(L))
    assert pbuf[0].shape == (320, C)
    np.testing.assert_array_equal(n(ps.occlusion_as_pn(pbuf, C)),
                                  np.asarray(js.occlusion_as_pn(jbuf, C)))
    cidx = np.sort(np.random.default_rng(2).integers(0, 37, size=L))
    jout = js.gather_occlusion(jbuf, jnp.asarray(cidx),
                               num_in=js.particle_stride(C))
    pout = ps.gather_occlusion(pbuf, torch.as_tensor(cidx),
                               num_in=ps.particle_stride(C))
    assert pout[0].shape == (320, ps.particle_stride(L))
    np.testing.assert_array_equal(n(ps.occlusion_as_pn(pout, L)),
                                  np.asarray(js.occlusion_as_pn(jout, L)))
    np.testing.assert_array_equal(n(pout[0][:N, :L]).T,
                                  occ_pn[rows[cidx]])
    with pytest.raises(ValueError, match="num_in"):
        ps.gather_occlusion(pbuf, torch.as_tensor(cidx), num_in=999)


def test_where_occlusion_matches_jax():
    js, ps = sensors()
    P = 200
    a_pn, ja, pa = leaves(P, 5)
    b_pn, jb, pb = leaves(P, 6)
    mask = np.random.default_rng(7).random(P) < 0.4
    jout = js.where_occlusion(jnp.asarray(mask), ja, jb)
    pout = ps.where_occlusion(torch.as_tensor(mask), pa, pb)
    np.testing.assert_array_equal(n(ps.occlusion_as_pn(pout, P)),
                                  np.asarray(js.occlusion_as_pn(jout, P)))
    np.testing.assert_array_equal(n(pout[0][:N, :P]).T,
                                  np.where(mask[:, None], a_pn, b_pn))
    assert torch.equal(pout[0][:, P:], pb[0][:, P:])   # padding takes b
    assert pout[1] is pa[1]                            # ages of a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p_in,p_out", [(256, 128), (128, 384), (384, 256)])
def test_lineage_gather_plain_at_two_widths(dtype, p_in, p_out):
    """``out[n, c] = q[n, clamp(idx[c], 0, p_in - 1)]`` with a source and
    an output of different widths; on the CPU the wrapper is the plain
    version and launches nothing."""
    g = np.random.default_rng(p_in + p_out)
    q = torch.as_tensor(g.random((24, p_in), np.float32)).to(dtype)
    idx = np.sort(g.integers(-3, p_in + 40, size=p_out)).astype(np.int32)
    launches = kernels.lineage_gather.launches
    out = kernels.lineage_gather(q, torch.as_tensor(idx))
    assert kernels.lineage_gather.launches == launches
    assert out.shape == (24, p_out) and out.dtype == dtype
    want = q.numpy() if dtype == torch.float32 else q.float().numpy()
    np.testing.assert_array_equal(n(out), want[:, np.clip(idx, 0, p_in - 1)])


def test_distributed_belief_from_jax_splits_the_concatenated_blocks():
    """JAX's fused-sensor leaf under ``init_distributed_belief`` is the
    concatenation of the shards' kernel-layout blocks (and of their
    ages); each rank takes its block and its rows of the states."""
    js, ps = sensors()
    S, P = 4, 160
    L = P // S
    g = np.random.default_rng(9)
    blocks = [g.uniform(size=(L, N)).astype(np.float32) for _ in range(S)]
    ages = [np.full(320, float(s), np.float32) for s in range(S)]
    q = np.concatenate([np.asarray(jrp.occ_to_kernel(jnp.asarray(b)))
                        for b in blocks])
    states = g.standard_normal((P, 2, 13)).astype(np.float32)
    lw = g.standard_normal(P).astype(np.float32)
    for r in range(S):
        bel = interop.distributed_belief_from_jax(
            states, lw, q, r, S, N, age=np.concatenate(ages))
        np.testing.assert_array_equal(n(bel.states),
                                      states[r * L:(r + 1) * L])
        np.testing.assert_array_equal(n(bel.log_weights),
                                      lw[r * L:(r + 1) * L])
        np.testing.assert_array_equal(n(ps.occlusion_as_pn(
            (bel.occlusion[0], torch.zeros(320)), L)), blocks[r])
        np.testing.assert_array_equal(n(bel.occlusion[1]), ages[r])
    plain = interop.distributed_belief_from_jax(
        states, lw, np.concatenate(blocks), 2, S, N)
    np.testing.assert_array_equal(n(fs.occ_from_map(plain.occlusion, N, L)),
                                  blocks[2])


# ---------------------------------------------------------------------------
# the distributed step on one rank against JAX's on a one-device mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    """A gloo group of world size 1 on a HashStore, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield comm_mod.Comm()
    finally:
        dist.destroy_process_group()


REFS = np.array([[-0.02, 0.0, 0.62, 1, 0, 0, 0],
                 [0.03, 0.01, 0.55, 1, 0, 0, 0]], np.float32)


def replayed_block_noise(key, num_objects, P):
    """The draws JAX's distributed step makes from ``key`` on a one-device
    mesh (shard 0, ``P`` particles): per block, e1, e2, u."""
    _, k_trans, k_res_base = jax.random.split(key, 3)
    out = []
    for b in range(num_objects):
        k_b = jax.random.fold_in(jax.random.fold_in(k_trans, b), 0)
        k1, k2 = jax.random.split(k_b)
        out.append(rbcpf.BlockNoise(
            e1=t(jax.random.normal(k1, (P, 6), jnp.float32)),
            e2=t(jax.random.normal(k2, (P, 6), jnp.float32)),
            u=t(jax.random.uniform(jax.random.fold_in(k_res_base, b), ()))))
    return out


def assert_matches(pstates, plw, pocc_pn, jstates, jlw, jocc_pn,
                   num_objects, blocks_resampled):
    """Per particle, except at most one moved parent per resampling
    block (a CDF tie); the moved particles are left out."""
    P = pstates.shape[0]
    moved = np.abs(pstates - jstates).reshape(P, -1).max(axis=1) > 2e-5
    assert moved.sum() <= blocks_resampled, np.flatnonzero(moved)
    keep = ~moved
    np.testing.assert_allclose(pstates[keep], jstates[keep], atol=2e-5)
    np.testing.assert_allclose(plw[keep], jlw[keep], rtol=1e-6, atol=1e-2)
    np.testing.assert_allclose(pocc_pn[keep], jocc_pn[keep], atol=1e-5)
    return moved


# the two-object parity cases' fixed barycentric slack
FIXED_SLACK = 0.1


@pytest.mark.parametrize("num_objects", [1, 2])
def test_one_rank_step_matches_jax_on_a_one_device_mesh(one_rank,
                                                        num_objects):
    """Three frames at max_kl = 1 (one compiled JAX step): skewed start
    weights force the first resample, later ones come from the trigger;
    the one-rank path is the lineage gather (``paths == ["local"]``).
    Two objects take a fixed slack: the port's automatic slack is per
    object, JAX's measures both meshes in the finer one's units."""
    K_cam = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    jcam = jcamera.make_camera(K_cam, 32, 32)
    jmeshes = [jmesh.l_shape_mesh(),
               jmesh.box_mesh(0.05, 0.08, 0.04)][:num_objects]
    jbp = jbeam.make_beam_params(model_sigma=0.005, sigma_factor=0.0)
    jop = jocc.make_occlusion_params()
    jtp = jtrans.make_transition_params(0.3, 1.5, damping=6.0)
    slack = None if num_objects == 1 else FIXED_SLACK
    js = jrp.make_fused_sensor(jmeshes, jcam, jbp, jop, interpret=True,
                               occ_dtype=jnp.float32, bary_slack=slack)
    ps = fs.make_fused_sensor(
        [interop.mesh_from_numpy(fields(m)) for m in jmeshes],
        camera.make_camera(K_cam, 32, 32),
        interop.beam_params_from_numpy(fields(jbp)),
        interop.occlusion_params_from_numpy(fields(jop)),
        occ_dtype=torch.float32, bary_slack=slack)
    tp = interop.transition_params_from_numpy(fields(jtp))
    P, Np = 96, 1024
    refs = REFS[:num_objects]
    g = np.random.default_rng(0)
    states = np.zeros((P, num_objects, 13), np.float32)
    states[..., :7] = refs
    states[..., :3] += 0.006 * g.standard_normal((P, num_objects, 3))
    states[..., 7:10] = 0.05 * g.standard_normal((P, num_objects, 3))

    mesh1 = jdist.make_particle_mesh(1)
    jbel = jdist.init_distributed_belief(jax.random.PRNGKey(7), refs, P,
                                         mesh1, Np, sensor=js)
    jbel = jdist.shard_belief(dataclasses.replace(
        jbel, states=jnp.asarray(states)), mesh1)
    lw0 = (3.0 * np.sin(np.arange(P))).astype(np.float32)
    jbel = dataclasses.replace(jbel, log_weights=jax.device_put(
        jnp.asarray(lw0), jbel.log_weights.sharding))
    pbel = interop.distributed_belief_from_jax(
        states, lw0, np.asarray(jbel.occlusion[0]),
        0, 1, Np, age=np.asarray(jbel.occlusion[1]))
    jstep = jdist.make_distributed_step(mesh1, js, jtp, 1 / 30,
                                        max_kl_divergence=1.0)
    pstep = dist_filter.make_distributed_step(one_rank, ps, tp, 1 / 30,
                                              max_kl_divergence=1.0)
    resampled = []
    for f in range(3):
        truth = refs.copy()
        truth[:, 0] += 0.003 * (f + 1)
        z = np.asarray(render_scene(jmeshes, jnp.asarray(truth), jcam.rays))
        z = np.where(np.isfinite(z), z, 2.0).astype(np.float32)
        z += 0.002 * g.standard_normal(Np).astype(np.float32)
        z[::41] = np.nan
        noise = replayed_block_noise(jbel.key, num_objects, P)
        jbel, jmean, jess = jstep(jbel, jnp.asarray(z))
        pbel, pmean, pess = pstep(pbel, t(z), noise=noise)
        assert pstep.paths == ["local"] * num_objects
        jlw = np.asarray(jbel.log_weights)
        did = bool((jlw == 0).all())
        resampled.append(did)
        assert bool((pbel.log_weights == 0).all()) == did
        moved = assert_matches(
            n(pbel.states), n(pbel.log_weights),
            n(ps.occlusion_as_pn(pbel.occlusion, P)),
            np.asarray(jbel.states), jlw,
            np.asarray(js.occlusion_as_pn(jbel.occlusion, P)),
            num_objects, num_objects)
        w = np.asarray(jax.nn.softmax(jbel.log_weights))
        carried = 2 * w[moved].sum()
        spread = np.ptp(np.asarray(jbel.states), axis=0).max()
        np.testing.assert_allclose(n(pmean), np.asarray(jmean),
                                   atol=2e-5 + carried * spread)
        np.testing.assert_allclose(n(pess), np.asarray(jess),
                                   rtol=1e-4 + 10 * carried)
    # the last block resampled on some frame (every block's trigger is
    # held equal through the weights above)
    assert any(resampled), resampled


def test_the_step_refuses_an_unknown_exchange(one_rank):
    with pytest.raises(ValueError, match="exchange"):
        dist_filter.make_distributed_step(one_rank, None, None, 1 / 30,
                                          exchange="broadcast")
