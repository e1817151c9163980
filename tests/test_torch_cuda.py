"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The
module imports no JAX (the machine with the card has none), so it runs
there without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest \\
        -o addopts="" -q -p no:cacheprovider

Tolerances: the kernel and the plain version evaluate the same float32
operation sequence (the kernel is built with -fmad=false); they differ
in the order of the per-particle sum over pixels (rtol 1e-5 + 1e-4 nats
per pixel) and by library exp/log rounding (occlusion 1e-6 in float32,
one bf16 step, 4e-3, in bfloat16). Row moves are bit-exact. The whole
sensor on the card against the CPU path is checked by ``chip_smoke.py``
(its ``sensor`` phase). The Gaussian filter has no kernel of its own; its
sigma renderer and one filter step are held card against CPU (hit masks
equal on all but 0.2 % of the pixels, depths 1e-5; mean 1e-5, covariance
rtol 1e-3 + 1e-8), which also shows that the ``_ex`` linear algebra and
``torch.func.vmap`` take the same path on both devices. The live path
(oracle frames, the u16 transport, the threaded source and the socket
service) runs once, short, with the kernels counted per frame.
"""

import numpy as np
import pytest
import torch

from dbot_ros_tpu_torch.models import beam, occlusion
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import kernels, raycast
from dbot_ros_tpu_torch.utils import camera, mesh, se3

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_scene(dev, P=1000, seed=0):
    K = np.array([[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]])
    cam = camera.make_camera(K, 30, 40, device=dev)
    m = mesh.tagged_l_mesh(device=dev)
    g = np.random.default_rng(seed)
    states = torch.zeros((P, 1, 13), device=dev)
    states[:, 0, :3] = torch.as_tensor(
        [0.0, 0.0, 0.6] + 0.005 * g.standard_normal((P, 3)),
        dtype=torch.float32, device=dev)
    states[:, 0, 3:7] = se3.quat_boxplus(
        se3.quat_identity((P,), device=dev),
        torch.as_tensor(0.03 * g.standard_normal((P, 3)),
                        dtype=torch.float32, device=dev))
    ref = torch.tensor([0.0, 0.0, 0.6, 1, 0, 0, 0], device=dev)
    z = raycast.raycast_depth(m, ref, cam.rays)
    z = torch.where(torch.isfinite(z), z, 2.0)
    z[::37] = float("nan")
    z[5::29] = 0.3
    return cam, m, states, z


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_loglik_matches_plain(cuda, dtype):
    cam, m, states, z = small_scene(cuda)
    P = states.shape[0]
    p_pad = fs.particle_pad(P)
    gt = fs.pack_constants(m, states[:, 0, :7], p_pad)
    g = torch.Generator(device=cuda).manual_seed(1)
    n_px = cam.num_pixels
    cand = torch.randint(0, m.padded_triangles, (n_px, 2), generator=g,
                         device=cuda, dtype=torch.int32)
    occ = torch.rand((n_px, p_pad), generator=g, device=cuda).to(dtype)
    ages = torch.randint(0, 5, (n_px,), generator=g, device=cuda).float()
    pv = fs.make_params_vec(beam.make_beam_params(device=cuda),
                            occlusion.make_occlusion_params(device=cuda),
                            1.0, 0.25)
    args = (gt, occ, z, cand, cam.rays, ages, pv)
    before = kernels.fused_loglik.launches
    ll_k, occ_k = kernels.fused_loglik(*args)
    assert kernels.fused_loglik.launches == before + 1
    ll_p, occ_p = kernels.fused_loglik_plain(*args)
    torch.testing.assert_close(ll_k, ll_p, rtol=1e-5, atol=1e-4 * n_px)
    torch.testing.assert_close(
        occ_k.float(), occ_p.float(), rtol=0,
        atol=1e-6 if dtype == torch.float32 else 4e-3)
    assert torch.equal(occ, args[1])               # input map untouched
    with pytest.raises(TypeError):
        kernels.fused_loglik(gt, occ, z, cand.long(), cam.rays, ages, pv)
    with pytest.raises(ValueError):
        kernels.fused_loglik(gt[:, :, :128], occ, z, cand, cam.rays, ages,
                             pv)


FUSED_CASES = ["one_slab", "distinct_slabs", "degenerate_only",
               "swapped_slots", "k1", "k3", "k5", "ragged_n"]


def hard_candidates(case, g, N, T):
    """``(n_pixels, cand)``: candidate tables the kernel's slab reuse, its
    skip of degenerate slabs (``T - 1``) and its dealing of pixel runs to
    blocks could get wrong (the same cases as tests/test_torch_fused.py
    holds the plain version to the reference on)."""
    n_px, K = N, 2
    if case == "one_slab":
        cand = np.full((N, K), 3)
    elif case == "distinct_slabs":
        cand = (np.arange(N)[:, None] * K + np.arange(K)) % (T - 1)
    elif case == "degenerate_only":
        cand = np.full((N, K), T - 1)
    elif case == "swapped_slots":
        base = g.integers(0, T - 1, (N // 2, K))
        cand = np.stack([base, base[:, ::-1]], 1).reshape(N, K)
    elif case == "k1":
        cand = g.integers(0, T, (N, 1))
    elif case == "k3":
        cand = g.integers(0, T, (N, 3))
        cand[::5, 2] = cand[::5, 0]
    elif case == "k5":
        cand = g.integers(0, T, (N, 5))
    elif case == "ragged_n":
        n_px = 1000
        cand = g.integers(0, T, (n_px, K))
    else:
        raise ValueError(case)
    return n_px, cand.astype(np.int32)


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_loglik_hard_candidates(cuda, dtype, case):
    """Kernel vs plain on hand-made candidate tables, with 1000 particles
    (24 idle lanes in the last block); two runs give the same bits."""
    cam, m, states, z = small_scene(cuda)
    P = states.shape[0]
    p_pad = fs.particle_pad(P)
    gt = fs.pack_constants(m, states[:, 0, :7], p_pad)
    rng = np.random.default_rng(4)
    n_px, cand = hard_candidates(case, rng, cam.num_pixels,
                                 m.padded_triangles)
    cand = torch.as_tensor(cand, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    occ = torch.rand((n_px, p_pad), generator=g, device=cuda).to(dtype)
    ages = torch.randint(0, 5, (n_px,), generator=g, device=cuda).float()
    pv = fs.make_params_vec(beam.make_beam_params(device=cuda),
                            occlusion.make_occlusion_params(device=cuda),
                            1.0, 0.25)
    args = (gt, occ, z[:n_px].contiguous(), cand,
            cam.rays[:n_px].contiguous(), ages, pv)
    ll_k, occ_k = kernels.fused_loglik(*args)
    ll_p, occ_p = kernels.fused_loglik_plain(*args)
    torch.testing.assert_close(ll_k, ll_p, rtol=1e-5, atol=1e-4 * n_px)
    torch.testing.assert_close(
        occ_k.float(), occ_p.float(), rtol=0,
        atol=1e-6 if dtype == torch.float32 else 4e-3)
    ll_2, occ_2 = kernels.fused_loglik(*args)
    assert torch.equal(ll_2, ll_k) and torch.equal(occ_2, occ_k)


def test_fused_loglik_ragged_particle_axis(cuda):
    """A particle axis that is no multiple of the kernel's 128-particle
    tile (1000 columns: 24 idle lanes that still vote) and a pixel count
    that is no multiple of its 4-pixel sub-run."""
    cam, m, states, z = small_scene(cuda)
    P = states.shape[0]
    gt = fs.pack_constants(m, states[:, 0, :7], P)
    assert gt.shape[2] == 1000
    n_px = 1198
    g = torch.Generator(device=cuda).manual_seed(8)
    cand = torch.randint(0, m.padded_triangles, (n_px, 2), generator=g,
                         device=cuda, dtype=torch.int32)
    cand[600:] = m.padded_triangles - 1          # a tail of misses
    occ = torch.rand((n_px, P), generator=g, device=cuda).to(torch.bfloat16)
    ages = torch.randint(0, 5, (n_px,), generator=g, device=cuda).float()
    pv = fs.make_params_vec(beam.make_beam_params(device=cuda),
                            occlusion.make_occlusion_params(device=cuda),
                            1.0, 0.25)
    args = (gt, occ, z[:n_px].contiguous(), cand,
            cam.rays[:n_px].contiguous(), ages, pv)
    ll_k, occ_k = kernels.fused_loglik(*args)
    ll_p, occ_p = kernels.fused_loglik_plain(*args)
    torch.testing.assert_close(ll_k, ll_p, rtol=1e-5, atol=1e-4 * n_px)
    torch.testing.assert_close(occ_k.float(), occ_p.float(), rtol=0,
                               atol=4e-3)


def lineage_parents(kind, P, g, dev):
    if kind == "sorted":
        return torch.sort(torch.randint(0, P, (P,), generator=g,
                                        device=dev)).values
    if kind == "unsorted":           # sorted, every pair swapped
        return lineage_parents("sorted", P, g, dev).view(-1, 2).flip(
            1).reshape(-1)
    if kind == "one_parent":
        return torch.full((P,), (2 * P) // 5, device=dev)
    if kind == "scattered":
        return torch.randperm(P, generator=g, device=dev)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "one_parent",
                                  "scattered"])
@pytest.mark.parametrize("dtype,rows,P,p_pad", [
    (torch.bfloat16, 333, 12288, 12288),   # exactly one full column tile
    (torch.bfloat16, 130, 12288, 12416),   # two tiles, padding in the 2nd
    (torch.bfloat16, 64, 40, 128),         # far smaller than one tile
    (torch.float32, 97, 10000, 10112),     # two tiles; scattered parents
                                           # need the whole 40 KB row
    (torch.bfloat16, 24, 300000, 300032),  # scattered: wider than can be
                                           # staged, read from global
], ids=["tile_multiple", "two_tiles", "below_one_tile", "f32", "huge"])
def test_lineage_gather_tile_edges(cuda, dtype, rows, P, p_pad, kind):
    """Kernel vs plain, bit-exact, at the edges of its column tiling and
    staging, with identity padding columns behind the parents."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.rand((rows, p_pad), generator=g, device=cuda).to(dtype)
    idx = torch.cat([lineage_parents(kind, P, g, cuda),
                     torch.arange(P, p_pad, device=cuda)]).to(torch.int32)
    out = kernels.lineage_gather(q, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, kernels.lineage_gather_plain(q, idx))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p_in,p_out", [
    (5120, 640),      # a counts surplus buffer out of a rank's map
    (640, 5120),      # a rank's map out of one received buffer
    (10240, 5120),    # out of the concatenation of two blocks
    (128, 384),       # an output wider than the source, indices clamped
], ids=["buffer", "receive", "concat", "clamped"])
def test_lineage_gather_two_widths(cuda, dtype, p_in, p_out):
    """Source and output of different widths, bit-exact against the
    plain version, with sorted parents, runs of one parent and indices
    past the source (clamped to its last column)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.rand((97, p_in), generator=g, device=cuda).to(dtype)
    idx = torch.sort(torch.randint(0, p_in + 50, (p_out,), generator=g,
                                   device=cuda)).values
    idx[: p_out // 4] = 3
    idx = idx.to(torch.int32)
    out = kernels.lineage_gather(q, idx)
    torch.cuda.synchronize()
    assert out.shape == (97, p_out)
    assert torch.equal(out, kernels.lineage_gather_plain(q, idx))


def test_pixel_rows_match_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.rand((1216, 384), generator=g, device=cuda).to(torch.bfloat16)
    sel = torch.randperm(1216, generator=g, device=cuda)[:100].to(
        torch.int32)
    dup = sel.clone()
    dup[7] = dup[3]
    for s in (sel, dup):
        assert torch.equal(kernels.gather_pixel_rows(q, s),
                           kernels.gather_pixel_rows_plain(q, s))
    vals = torch.rand((100, 384), generator=g, device=cuda).to(
        torch.bfloat16)
    a, b = q.clone(), q.clone()
    assert kernels.scatter_pixel_rows(a, vals, sel) is a
    kernels.scatter_pixel_rows_plain(b, vals, sel)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        kernels.gather_pixel_rows(q[:, :3], sel)
    with pytest.raises(TypeError):
        kernels.scatter_pixel_rows(a, vals, sel.long())
    # a contiguous view that starts 2 bytes into its storage
    shifted = torch.empty(100 * 384 + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(100, 384)
    shifted.copy_(vals)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        kernels.scatter_pixel_rows(a, shifted, sel)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("row_bytes", [16, 20_224, 20_240])
def test_gather_rows_edges(cuda, dtype, row_bytes):
    """The gather at its edges, through the wrapper (the register engine)
    and with the bulk-copy engine: rows of one 16-byte chunk, of three equal chunks and of a
    ragged last chunk; a map of one row; row counts around one item per
    block and at the ladder's levels; sel with duplicates and out of
    range. Bit-exact."""
    g = torch.Generator(device=cuda).manual_seed(row_bytes)
    width = row_bytes // torch.empty((), dtype=dtype).element_size()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n_rows in (1, 4800):
        q = torch.rand((n_rows, width), generator=g, device=cuda).to(dtype)
        for n_sel in (1, 131, 133, 448, 2432):
            sel = torch.randint(0, n_rows, (n_sel,), generator=g,
                                device=cuda, dtype=torch.int32)
            dup = sel.clone()
            dup[1::2] = sel[0]
            bad = sel.clone()
            bad[::3] = torch.tensor([-1, n_rows, 2**31 - 1, -2**31],
                                    dtype=torch.int32,
                                    device=cuda).repeat(n_sel)[:bad[::3]
                                                               .numel()]
            for s in (sel, dup, bad):
                want = kernels.gather_pixel_rows_plain(q, s)
                before = kernels.gather_pixel_rows.launches
                runs = [kernels.gather_pixel_rows(q, s)]
                assert kernels.gather_pixel_rows.launches == before + 1
                runs.append(kernels._gather_rows_launch(
                    q, s, kernels.bulk_rows_plan(n_sel, row_bytes, sms)))
                torch.cuda.synchronize()
                for got in runs:
                    assert got.shape == (n_sel, width)
                    assert torch.equal(got.view(torch.uint8),
                                       want.view(torch.uint8))


def test_lineage_gather_matches_plain_and_checks_its_arguments(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    for dtype, shape in ((torch.bfloat16, (333, 1288)),
                         (torch.float32, (64, 2052))):
        q = torch.rand(shape, generator=g, device=cuda).to(dtype)
        p_pad = shape[1]
        sorted_idx = torch.sort(torch.randint(
            0, p_pad, (p_pad,), generator=g, device=cuda)).values
        for idx in (sorted_idx,
                    torch.full((p_pad,), 77, device=cuda),
                    torch.arange(p_pad, device=cuda),
                    torch.randperm(p_pad, generator=g, device=cuda)):
            idx = idx.to(torch.int32)
            before = kernels.lineage_gather.launches
            out = kernels.lineage_gather(q, idx)
            assert kernels.lineage_gather.launches == before + 1
            assert torch.equal(out, kernels.lineage_gather_plain(q, idx))
            assert out.data_ptr() != q.data_ptr()
    q = torch.rand((64, 256), generator=g, device=cuda).to(torch.bfloat16)
    idx = torch.arange(256, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):                  # resampler's int64
        kernels.lineage_gather(q, idx.long())
    with pytest.raises(TypeError):
        kernels.lineage_gather(q.to(torch.float16), idx)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.lineage_gather(q.T, idx[:64])
    # an output narrower than the source is a two-width gather now
    half = kernels.lineage_gather(q, idx[:128])
    assert half.shape == (64, 128)
    assert torch.equal(half, kernels.lineage_gather_plain(q, idx[:128]))
    with pytest.raises(ValueError):                 # idx on another device
        kernels.lineage_gather(q, idx.cpu())
    with pytest.raises(ValueError, match="16-byte"):
        kernels.lineage_gather(q[:, :100].contiguous(), idx[:100])


# ---------------------------------------------------------------------------
# the Gaussian filter: card against CPU
# ---------------------------------------------------------------------------

def sigma_scene(seed=0):
    from dbot_ros_tpu_torch.filters import rgf
    from dbot_ros_tpu_torch.ops import sigma_points as sp

    K = np.array([[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]])
    cam = camera.make_camera(K, 30, 40)
    m = mesh.tagged_l_mesh()
    pose = np.array([0.01, 0.0, 0.6, 1, 0, 0, 0], np.float32)
    truth = torch.tensor([0.014, 0.003, 0.604, 1, 0, 0, 0])
    g = np.random.default_rng(seed)
    z = raycast.raycast_depth(m, truth, cam.rays)
    z = torch.where(torch.isfinite(z), z, 1.5) + torch.as_tensor(
        0.002 * g.standard_normal(cam.num_pixels), dtype=torch.float32)
    z[::31] = float("nan")
    belief = rgf.init_belief(
        pose, first_frame=np.full(cam.num_pixels, 1.5, np.float32),
        initial_occlusion_prob=0.1)
    states, _, _, _ = sp.sigma_points(
        belief.mean, 0.05 * belief.cov, **sp.default_ut_params())
    return cam, m, z, belief, states[:, :7]


def test_sigma_renderer_matches_cpu(cuda):
    from dbot_ros_tpu_torch.ops import deferred

    cam, m, _, _, poses = sigma_scene()
    outs = {}
    for dev in ("cpu", cuda):
        c, mm = cam.to(dev), m.to(dev)
        render = deferred.make_sigma_renderer([mm], c.rays, c.height,
                                              c.width)
        outs[str(dev)] = render(poses.to(dev)).cpu()
    want = outs["cpu"]
    assert torch.isfinite(want).sum() > 1000
    for key, got in outs.items():
        flips = (torch.isfinite(got) != torch.isfinite(want)).float().mean()
        both = torch.isfinite(got) & torch.isfinite(want)
        assert float(flips) <= 0.002, (key, float(flips))
        assert float((got[both] - want[both]).abs().max()) <= 1e-5, key


@pytest.mark.parametrize("batched", [False, True])
def test_rgf_step_matches_cpu(cuda, batched):
    import dataclasses

    from dbot_ros_tpu_torch.filters import rgf
    from dbot_ros_tpu_torch.models import transition

    cam, m, z, belief, _ = sigma_scene()
    outs = []
    for dev in ("cpu", cuda):
        c, mm = cam.to(dev), m.to(dev)
        bp = beam.make_beam_params(device=dev)
        op = occlusion.make_occlusion_params(device=dev)
        tp = transition.make_transition_params(0.1, 0.5, 4.0, device=dev)

        def render(poses, c=c, mm=mm):
            return raycast.raycast_depth(mm, poses, c.rays)

        b = dataclasses.replace(belief, **{
            f.name: getattr(belief, f.name).to(dev)
            for f in dataclasses.fields(belief)})
        if batched:
            step = rgf.make_batched_step(render, tp, 1 / 30, bp,
                                         iterations=2, occ_params=op)
            nb, info = step(rgf.stack_beliefs([b, b]),
                            torch.stack([z, z]).to(dev))
            nb = dataclasses.replace(nb, mean=nb.mean[1], cov=nb.cov[1])
        else:
            nb, info = rgf.rgf_step(b, z.to(dev), render, tp, 1 / 30, bp,
                                    iterations=2, occ_params=op)
        outs.append((nb.mean.cpu(), nb.cov.cpu()))
    (mean_c, cov_c), (mean_g, cov_g) = outs
    assert bool(torch.isfinite(mean_g).all())
    torch.testing.assert_close(mean_g, mean_c, atol=1e-5, rtol=0)
    torch.testing.assert_close(cov_g, cov_c, atol=1e-8, rtol=1e-3)


def test_live_path_through_the_u16_camera_and_the_socket(cuda):
    """A short live run on the card: 20 oracle frames at 4 × the tracker's
    grid through ``U16CameraAdapter`` into a ``ThreadedSource`` at 30 Hz,
    the particle tracker in ``node.run`` with a socket ``TrackerService``;
    a client reads ``status`` and sends ``shutdown``. Every tracked frame
    launches all four kernels."""
    import os
    import shutil
    import tempfile
    import threading
    import time

    from dbot_ros_tpu_torch import config as cfg
    from dbot_ros_tpu_torch.runtime import node, sources
    from dbot_ros_tpu_torch.runtime.service import TrackerService, call
    from dbot_ros_tpu_torch.trackers.particle import ParticleTracker

    K = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    cam = camera.make_camera(K, 32, 32, device=cuda)
    m = mesh.box_mesh(0.08, 0.06, 0.05)

    def traj(t):
        return np.array([[0.0005 * t, 0.0, 0.6, 1, 0, 0, 0]], np.float32)

    oracle = sources.OracleSource(m, sources.scale_camera(cam, 4), traj, 20,
                                  noise_sigma=0.002, edge_artifacts=0.3,
                                  quantize_mm=True)
    frames = list(sources.U16CameraAdapter(oracle, 4))
    assert frames[0].depth.shape == (32, 32)
    tracker = ParticleTracker(cfg.ParticleTrackerConfig(
        evaluation_count=1000, backend="pallas", seed=0), meshes=[m],
        camera=cam, device=cuda)
    # build the kernels and warm up first: a live camera does not wait
    tracker.initialize(frames[0].ground_truth)
    tracker.track(frames[0].depth)
    tracker.initialize(frames[0].ground_truth)
    tmp = tempfile.mkdtemp(prefix="dbt")
    sock = os.path.join(tmp, "c.sock")
    svc = TrackerService(sock)
    seen = {}

    def client():
        deadline = time.time() + 60
        while time.time() < deadline:
            st = call(sock, {"cmd": "status"}, timeout=5.0)
            if st.get("frame") is not None and st["frame"] >= 10:
                seen["status"] = st
                seen["shutdown"] = call(sock, {"cmd": "shutdown"},
                                        timeout=5.0)
                return
            time.sleep(0.01)

    counts = []
    wrappers = (kernels.fused_loglik, kernels.gather_pixel_rows,
                kernels.scatter_pixel_rows, kernels.lineage_gather)
    for w in wrappers:
        w.launches = 0

    def on_frame(frame, poses, info):
        counts.append([w.launches for w in wrappers])

    src = sources.ThreadedSource(frames, rate_hz=30, capacity=8)
    t = threading.Thread(target=client, daemon=True)
    t.start()
    try:
        run = node.run(tracker, src, on_frame=on_frame, service=svc)
    finally:
        t.join(60)
        svc.close()
        shutil.rmtree(tmp, ignore_errors=True)
    assert not t.is_alive()
    assert seen["status"]["ok"] and len(seen["status"]["poses"][0]) == 7
    assert seen["shutdown"]["ok"]
    assert svc.status()["applied_seq"] == 1 and svc.status()["last_error"] \
        is None
    assert 10 <= len(run.poses) < 20
    prev = [0] * 4
    for row in counts:
        assert all(c > p for c, p in zip(row, prev)), counts
        prev = row
    assert src.wait_closed(timeout=10)
    err = np.linalg.norm(run.poses[-1, 0, :3]
                         - traj(run.metrics.records[-1].frame)[0, :3])
    assert err < 0.01, err
