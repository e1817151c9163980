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

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from dbot_ros_tpu_torch.models import beam, occlusion
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import kernels, raycast
from dbot_ros_tpu_torch.ops import resample as rs
from dbot_ros_tpu_torch.utils import camera, graphs, mesh, se3

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
                            1.0)
    # two slacks: the even triangles widened by 0.5, the odd ones exact
    T = m.padded_triangles
    tri_slack = torch.where(torch.arange(T, device=cuda) % 2 == 0, 0.5, 0.0)
    args = (gt, occ, z, cand, cam.rays, ages, pv, tri_slack)
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
        kernels.fused_loglik(gt, occ, z, cand.long(), cam.rays, ages, pv,
                             tri_slack)
    with pytest.raises(ValueError):
        kernels.fused_loglik(gt[:, :, :128], occ, z, cand, cam.rays, ages,
                             pv, tri_slack)
    with pytest.raises(ValueError):
        kernels.fused_loglik(gt, occ, z, cand, cam.rays, ages, pv,
                             tri_slack[:-1])
    # the two slacks decide pixels: one slack for all moves the result
    ll_one, _ = kernels.fused_loglik(*args[:7], torch.full_like(tri_slack,
                                                                0.5))
    assert not torch.equal(ll_one, ll_k)


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
                            1.0)
    tri_slack = torch.full((gt.shape[0],), 0.25, device=cuda)
    args = (gt, occ, z[:n_px].contiguous(), cand,
            cam.rays[:n_px].contiguous(), ages, pv, tri_slack)
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
                            1.0)
    tri_slack = torch.full((gt.shape[0],), 0.25, device=cuda)
    args = (gt, occ, z[:n_px].contiguous(), cand,
            cam.rays[:n_px].contiguous(), ages, pv, tri_slack)
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


def sensor_frames(dev, frames=3, P=1000, **opts):
    """Three sensor calls of the small scene on ``dev`` with ``opts``:
    (logliks (frames, P) on the CPU, the (P, N) occlusion view on the CPU,
    the levels taken)."""
    K = np.array([[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]])
    cam = camera.make_camera(K, 30, 40, device=dev)
    m = mesh.tagged_l_mesh(device=dev)
    bp = beam.make_beam_params(model_sigma=0.005, sigma_factor=0.0,
                               device=dev)
    op = occlusion.make_occlusion_params(
        *opts.pop("occlusion", (0.1, 0.7)), device=dev)
    sensor = fs.make_fused_sensor(m, cam, bp, op, device=dev, **opts)
    occ = sensor.init_occlusion(P, 0.2)
    lls, levels = [], []
    for f in range(frames):
        _, _, states, z = small_scene(torch.device("cpu"), P, seed=f)
        states[:, 0, 0] += 0.003 * f
        ll, occ = sensor(states.to(dev), occ, z.to(dev), 1.0 / 30.0)
        lls.append(ll.cpu())
        levels.append(sensor.last_level)
    return (torch.stack(lls), sensor.occlusion_as_pn(occ, P).cpu(), levels,
            len(sensor.caps(cam.num_pixels)))


def assert_card_like_cpu(card, cpu):
    """The whole sensor on the card against the CPU path: candidate
    raycasts and constant products round differently on the two devices,
    so a silhouette-edge pixel can flip for a particle (chip_smoke.py's
    sensor phase holds the same share)."""
    rel = (card[0] - cpu[0]).abs() / cpu[0].abs().clamp_min(1.0)
    assert (rel <= 1e-4).float().mean().item() >= 0.98
    assert (card[1] - cpu[1]).abs().mean().item() <= 1e-3
    assert card[2] == cpu[2]


def test_select_merge_matches_scatter_and_cpu(cuda):
    """``merge="select"`` on the card: the loglik and map of
    ``"scatter"`` bit for bit (the same fused kernel; the rows move
    exactly), two row gathers a frame, and close to the CPU path."""
    gathers = kernels.gather_pixel_rows.launches
    select = sensor_frames(cuda, merge="select")
    assert kernels.gather_pixel_rows.launches - gathers == 6
    scatter = sensor_frames(cuda)
    assert all(lv < select[3] for lv in select[2])
    assert torch.equal(select[0], scatter[0])
    assert torch.equal(select[1], scatter[1])
    assert_card_like_cpu(select, sensor_frames(torch.device("cpu"),
                                               merge="select"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eager_branch_matches_full_level_and_cpu(cuda, dtype):
    """g < 0 (a raw map) on a compacted level on the card: the row
    kernels launch, and the result equals the full level's (loglik rtol
    2e-5 + 1e-2 nats; the map 1e-5 in float32, one bf16 step in
    bfloat16) and the CPU path's."""
    opts = dict(occlusion=(0.4, 0.1), occ_dtype=dtype)
    rows = (kernels.gather_pixel_rows.launches,
            kernels.scatter_pixel_rows.launches)
    eager = sensor_frames(cuda, **opts)
    assert (kernels.gather_pixel_rows.launches - rows[0],
            kernels.scatter_pixel_rows.launches - rows[1]) == (3, 3)
    assert all(lv < eager[3] for lv in eager[2])
    full = sensor_frames(cuda, levels=[(1.0, 1.0)], **opts)
    assert full[2] == [0, 0, 0] and full[3] == 0
    torch.testing.assert_close(eager[0], full[0], rtol=2e-5, atol=1e-2)
    torch.testing.assert_close(eager[1], full[1], rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 4e-3)
    assert_card_like_cpu(eager, sensor_frames(torch.device("cpu"), **opts))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_age_pixel_rows_matches_plain(cuda, dtype):
    """The row aging against its plain version bit for bit (NaN where
    NaN), with rows of age 0 and the values 0, 1 and NaN; one launch a
    call; a factor vector of the wrong length and rows that are not
    16-byte multiples raise."""
    g = torch.Generator(device=cuda).manual_seed(11)
    n_rows, p = 300, 1152
    q = torch.rand((n_rows, p), generator=g, device=cuda).to(dtype)
    q[0, :8], q[1, :8], q[2, :8] = float("nan"), 0.0, 1.0
    age = torch.randint(0, 7, (n_rows,), generator=g, device=cuda).float()
    age[::3] = 0.0
    geff = torch.exp(torch.log(torch.tensor(0.6, device=cuda)) * age)
    pi = torch.tensor(0.25, device=cuda)
    before = kernels.age_pixel_rows.launches
    got = kernels.age_pixel_rows(q, geff, pi)
    assert kernels.age_pixel_rows.launches == before + 1
    torch.testing.assert_close(got, kernels.age_pixel_rows_plain(q, geff, pi),
                               rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        kernels.age_pixel_rows(q, geff[:-1].contiguous(), pi)
    with pytest.raises(ValueError):
        kernels.age_pixel_rows(q[:, :p - 2].contiguous(), geff, pi)


def test_a_replayed_exchange_graph_counts_its_row_aging(cuda):
    """A captured ``("exchange", b, path)`` graph that ages the map's rows
    (as ``dist_filter._exchange`` does on a frame that moves columns)
    counts one ``age_pixel_rows`` launch a call, replays included, and
    each replay ages the rows it is given."""
    g = torch.Generator(device=cuda).manual_seed(12)
    prog = graphs.StepProgram(cuda, capture=True)
    q = prog.keep("q", torch.rand((64, 1152), generator=g, device=cuda))
    geff = prog.keep("geff", torch.full((64,), 0.6, device=cuda))
    pi = prog.keep("pi", torch.tensor(0.25, device=cuda))
    before = kernels.age_pixel_rows.launches
    for i in range(4):
        q.uniform_(generator=g)
        out = prog.run(("exchange", 0, "moves"), lambda: prog.keep(
            "aged", kernels.age_pixel_rows(q, geff, pi)))
        torch.testing.assert_close(
            out, kernels.age_pixel_rows_plain(q, geff, pi), rtol=0, atol=0)
    assert prog.graph_count == 1
    assert kernels.age_pixel_rows.launches == before + 4


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


@pytest.mark.parametrize("n", [10_000, 100_000])
def test_weight_cdf_is_the_same_bits_on_every_call(cuda, n):
    """The resampling CDF repeats to the bit while another stream keeps
    the card busy (a one-row ``torch.cumsum`` does not: its single-pass
    scan groups the sums by which tiles finished first), and it is the
    cumulative sum to float32 rounding."""
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    w = torch.softmax(3.0 * torch.randn(n, generator=g, device=cuda), 0)
    first = rs.weight_cdf(w).clone()
    busy, side = torch.randn(2048, 2048, device=cuda), torch.cuda.Stream()
    differ = 0
    for i in range(2000):
        if i % 8 == 0:
            with torch.cuda.stream(side):
                busy @ busy
        differ += int(not torch.equal(rs.weight_cdf(w).view(torch.int32),
                                      first.view(torch.int32)))
    torch.cuda.synchronize()
    assert differ == 0
    want = np.cumsum(w.double().cpu().numpy())
    np.testing.assert_allclose(first.cpu().numpy(), want, rtol=0,
                               atol=1e-5)


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


def test_captured_tracker_is_reanchored_between_replays(cuda):
    """A long frame gap in ``node.run`` with a captured particle tracker:
    the re-anchor (eager renders, then ``initialize``) runs between two
    replays; the re-anchored frame and the next one still launch all four
    kernels through the same graphs, within 3 mm of the truth."""
    from dbot_ros_tpu_torch import config as cfg
    from dbot_ros_tpu_torch.runtime import node, sources
    from dbot_ros_tpu_torch.trackers.particle import ParticleTracker

    K = np.array([[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]])
    cam = camera.make_camera(K, 30, 40, device=cuda)
    m = mesh.icosphere_mesh(radius=0.06, subdivisions=2)
    p0 = np.array([0.0, 0.0, 0.6, 1, 0, 0, 0], np.float32)
    p1 = np.array([0.009, -0.006, 0.605, 1, 0, 0, 0], np.float32)
    src = sources.SyntheticSource([m], cam, lambda t: (p0 if t < 3
                                                       else p1)[None],
                                  5, noise_sigma=0.002, seed=0)
    frames = list(src)
    for f, skipped in zip(frames, (None, 0, 0, 150, 0)):
        f.skipped = skipped
    frames[3].index, frames[4].index = 153, 154
    tracker = ParticleTracker(cfg.ParticleTrackerConfig(
        evaluation_count=1000, backend="pallas", seed=0,
        transition=cfg.TransitionConfig(0.1, 0.5, damping=4.0)),
        meshes=[m], camera=cam, device=cuda)
    assert tracker.capture
    tracker.initialize(p0)
    wrappers = (kernels.fused_loglik, kernels.gather_pixel_rows,
                kernels.scatter_pixel_rows, kernels.lineage_gather)
    for w in wrappers:
        w.launches = 0
    counts, graphs_after = [], []

    def on_frame(frame, poses, info):
        counts.append([w.launches for w in wrappers])
        graphs_after.append(tracker.programs[0].graph_count)

    run = node.run(tracker, frames, on_frame=on_frame)
    assert [r.frame for r in run.reanchors] == [153]
    prev = [0] * 4
    for row in counts:
        assert all(c > p for c, p in zip(row, prev)), counts
        prev = row
    assert graphs_after[0] > 0                  # captured by frame 0
    err = np.linalg.norm(run.poses[3:, 0, :3] - p1[:3], axis=-1)
    assert err.max() < 0.003, err


# ---------------------------------------------------------------------------
# the compiled step: CUDA-graph replays against the eager step
# ---------------------------------------------------------------------------

GRAPH_POSES = np.array([[-0.02, 0.0, 0.62, 1, 0, 0, 0],
                        [0.03, 0.01, 0.55, 1, 0, 0, 0]], np.float32)
GRAPH_DTS = (1 / 30, 1 / 15, 0.25, 1 / 30, 0.1, 1 / 30)


def graph_scene(num_objects):
    from dbot_ros_tpu_torch.runtime import sources

    K = np.array([[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]])
    cam = camera.make_camera(K, 30, 40)
    meshes = [mesh.tagged_l_mesh(), mesh.box_mesh(0.05, 0.08, 0.04)]
    meshes = meshes[:num_objects]

    def traj(i):
        p = GRAPH_POSES[:num_objects].copy()
        p[:, 0] += 0.003 * i
        return p

    src = sources.SyntheticSource(meshes, cam, traj, len(GRAPH_DTS), seed=5)
    return cam, meshes, [src.render(torch.as_tensor(traj(i))).numpy()
                         for i in range(len(GRAPH_DTS))]


def run_frames(tracker, frames, hypotheses=None, restore_at=3):
    """``tracker`` over ``frames`` (a two-hypothesis trial first when
    given, a restore of frame 0's belief before ``restore_at``): per frame
    the poses, a copy of the belief and the kernels' launches."""
    from dbot_ros_tpu_torch.trackers.particle import ParticleTracker

    particle = isinstance(tracker, ParticleTracker)
    init = GRAPH_POSES[:len(tracker.meshes)]
    if not particle:
        init = init[0]
    kw = {} if particle else {"first_frame": frames[0]}
    tracker.initialize(init, hypotheses=hypotheses, trial_frames=2, **kw)
    wrappers = (kernels.fused_loglik, kernels.gather_pixel_rows,
                kernels.scatter_pixel_rows, kernels.lineage_gather)
    out, saved = [], None
    for f, (depth, dt) in enumerate(zip(frames, GRAPH_DTS)):
        if f == restore_at:
            tracker.restore(saved)
        before = [w.launches for w in wrappers]
        poses, _ = tracker.track(depth, dt=dt)
        torch.cuda.synchronize()
        belief = tracker.belief
        copy = belief.clone() if particle else belief
        if f == 0:
            saved = copy
        out.append((poses.cpu(), [x.cpu().clone() for x in (
            [copy.states, copy.log_weights, *copy.occlusion] if particle
            else [copy.mean, copy.cov, copy.background])],
            [w.launches - b for w, b in zip(wrappers, before)]))
    return out


@pytest.mark.parametrize("num_objects,trial", [(1, False), (2, False),
                                               (1, True)])
def test_captured_particle_step_equals_eager(cuda, num_objects, trial):
    """The same frames and seed through a captured and an eager tracker:
    the same poses, beliefs and launches per frame, bit for bit, over a
    varying dt, a restore and (one object) a two-island trial."""
    from dbot_ros_tpu_torch import config as cfg
    from dbot_ros_tpu_torch.trackers.particle import ParticleTracker

    cam, meshes, frames = graph_scene(num_objects)
    conf = cfg.ParticleTrackerConfig(
        evaluation_count=1000, backend="pallas", seed=3,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.2, 1.0, damping=4.0))
    hyp = None
    if trial:
        rival = GRAPH_POSES[:1].copy()
        rival[0, 0] += 0.01
        hyp = np.stack([rival, GRAPH_POSES[:1]])
    runs = {}
    for capture in (True, False):
        tr = ParticleTracker(conf, meshes=meshes, camera=cam, device=cuda,
                             capture=capture)
        runs[capture] = run_frames(tr, frames, hyp,
                                   restore_at=None if trial else 3)
        if capture:
            progs = list(tr.programs.values())
            assert sum(p.graph_count for p in progs) >= 2
            # one capture stream and pool for all of a tracker's programs
            assert len({(id(p.stream), id(p.pool)) for p in progs}) == 1
    for (pa, ba, la), (pb, bb, lb) in zip(runs[True], runs[False]):
        assert torch.equal(pa, pb)
        assert all(torch.equal(x, y) for x, y in zip(ba, bb))
        assert la == lb and la[0] >= 1


def test_captured_gaussian_step_equals_eager(cuda):
    """The Gaussian step and its frozen trial variant, captured and eager,
    on the same frames: the same poses and beliefs, bit for bit."""
    from dbot_ros_tpu_torch import config as cfg
    from dbot_ros_tpu_torch.trackers.gaussian import GaussianTracker

    cam, meshes, frames = graph_scene(1)
    conf = cfg.GaussianTrackerConfig(
        update_iterations=2,
        transition=cfg.TransitionConfig(0.1, 0.5, damping=4.0))
    rival = GRAPH_POSES[0].copy()
    rival[0] += 0.01
    runs = {}
    for capture in (True, False):
        tr = GaussianTracker(conf, meshes=meshes, camera=cam, device=cuda,
                             capture=capture)
        runs[capture] = run_frames(tr, frames,
                                   np.stack([GRAPH_POSES[0], rival]),
                                   restore_at=4)
        if capture:
            assert sorted(tr.programs) == [False, True]
            assert all(p.graph_count == 1 for p in tr.programs.values())
    for (pa, ba, _), (pb, bb, _) in zip(runs[True], runs[False]):
        assert torch.equal(pa, pb)
        assert all(torch.equal(x, y) for x, y in zip(ba, bb))


# ---------------------------------------------------------------------------
# the scale-out steps and the renders, captured against eager
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_one_rank():
    """An NCCL group of one rank in this process (the card's scale-out
    path), torn down after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dbot_ros_tpu_torch.parallel import comm as comm_mod

    comm = comm_mod.init_process_group("nccl", 0, 1, comm_mod.free_port(),
                                       device="cuda")
    try:
        yield comm
    finally:
        torch.distributed.destroy_process_group()


def scale_out_step(what, comm, tracker, capture):
    """(step, start belief, frames as the step takes them) of one of the
    scale-out steps over ``comm`` with ``tracker``'s sensor."""
    from dbot_ros_tpu_torch.parallel import dist_filter

    args = (tracker.sensor, tracker.trans_params, 1 / 30)
    kw = dict(max_kl_divergence=0.5, seed=2, capture=capture)
    pose = torch.as_tensor(GRAPH_POSES[:1], device="cuda")
    P = tracker.config.evaluation_count
    if what == "multi_scene":
        groups = dist_filter.make_scene_groups(1, 1)
        return (dist_filter.make_multi_scene_step(groups, *args, **kw),
                dist_filter.init_multi_scene_belief(
                    groups, pose, 2, P, sensor=tracker.sensor))
    belief = dist_filter.init_distributed_belief(comm, pose, P,
                                                 sensor=tracker.sensor)
    if what == "island":
        return dist_filter.make_island_step(comm, *args, island_max_kl=-1.0,
                                            **kw), belief
    return dist_filter.make_distributed_step(
        comm, *args, exchange=what, **kw), belief


@pytest.mark.parametrize("what", ["counts", "all_gather", "island",
                                  "multi_scene"])
def test_captured_scale_out_step_equals_eager(cuda, nccl_one_rank, what):
    """One NCCL rank at 1,000 particles on 30×40: a captured and an eager
    step (``capture=False``) with the same seed over the same frames give
    the same beliefs, means and ESS bit for bit, the same paths and the
    same launches per frame; a multi-scene step's programs share one
    stream and pool."""
    from dbot_ros_tpu_torch import config as cfg
    from dbot_ros_tpu_torch.trackers.particle import ParticleTracker

    cam, meshes, frames = graph_scene(1)
    conf = cfg.ParticleTrackerConfig(
        evaluation_count=1000, backend="pallas", seed=3,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.2, 1.0, damping=4.0))
    tracker = ParticleTracker(conf, meshes=meshes, camera=cam, device=cuda)
    wrappers = (kernels.fused_loglik, kernels.gather_pixel_rows,
                kernels.scatter_pixel_rows, kernels.lineage_gather)
    runs = {}
    for capture in (True, False):
        step, belief = scale_out_step(what, nccl_one_rank, tracker, capture)
        assert step.capture is capture
        out = []
        for depth in frames:
            z = camera.preprocess_depth(torch.as_tensor(
                depth, device=cuda).reshape(-1))
            if what == "multi_scene":
                z = torch.stack([z, z])
            before = [w.launches for w in wrappers]
            belief, mean, ess = step(belief, z)
            torch.cuda.synchronize()
            leaves = []
            for b in (belief if isinstance(belief, list) else [belief]):
                leaves += [b.states, b.log_weights, *b.occlusion]
            out.append(([x.cpu().clone() for x in leaves + [mean, ess]],
                        list(step.paths),
                        [w.launches - b for w, b in zip(wrappers, before)]))
        runs[capture] = out
        if capture:
            progs = (step.programs if what == "multi_scene"
                     else [step.program])
            assert all(p.graph_count >= 2 for p in progs)
            assert len({(id(p.stream), id(p.pool)) for p in progs}) == 1
    for (la, pa, ka), (lb, pb, kb) in zip(runs[True], runs[False]):
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
        assert pa == pb and ka == kb and ka[0] >= 1


@pytest.mark.parametrize("what", ["track", "trial", "counts", "island"])
def test_captured_step_outputs_outlive_the_next_step(cuda, nccl_one_rank,
                                                     what):
    """Captured (graph replays): the outputs a step returns besides the
    belief (the tracker's StepInfo, in a two-island trial the winner's;
    the one-rank NCCL steps' mean and ESS) are left as they were by the
    next step and share no storage with its outputs; the belief stays
    donated (the same buffers every frame)."""
    from dbot_ros_tpu_torch import config as cfg
    from dbot_ros_tpu_torch.trackers.particle import ParticleTracker

    cam, meshes, frames = graph_scene(1)
    conf = cfg.ParticleTrackerConfig(
        evaluation_count=1000, backend="pallas", seed=3,
        observation=cfg.ObservationConfig(model_sigma=0.005,
                                          sigma_factor=0.0),
        transition=cfg.TransitionConfig(0.2, 1.0, damping=4.0))
    tracker = ParticleTracker(conf, meshes=meshes, camera=cam, device=cuda,
                              capture=True)
    if what in ("track", "trial"):
        hyp = None
        if what == "trial":
            rival = GRAPH_POSES[:1].copy()
            rival[0, 0] += 0.01
            hyp = np.stack([rival, GRAPH_POSES[:1]])
        tracker.initialize(GRAPH_POSES[:1], hypotheses=hyp, trial_frames=2)

        def step(depth):
            _, info = tracker.track(depth)
            return tracker.belief, dataclasses.astuple(info)
    else:
        prog_step, state = scale_out_step(what, nccl_one_rank, tracker, True)
        state = [state]

        def step(depth):
            z = camera.preprocess_depth(torch.as_tensor(
                depth, device=cuda).reshape(-1))
            state[0], mean, ess = prog_step(state[0], z)
            return state[0], (mean, ess)

    def storages(xs):
        return {x.untyped_storage().data_ptr() for x in xs}

    kept, clones, buffers = [], [], []
    for depth in frames:
        belief, out = step(depth)
        torch.cuda.synchronize()
        for k, c in zip(kept, clones):
            assert all(torch.equal(x, y) for x, y in zip(k, c))
            assert not storages(k) & storages(out)
        kept.append(out)
        clones.append(graphs.copy_out(out))
        buffers.append([x.data_ptr() for x in (
            belief.states, belief.log_weights, *belief.occlusion)])
    assert buffers[-1] == buffers[-2]
    progs = (tracker.programs.values() if what in ("track", "trial")
             else [prog_step.program])
    assert all(p.capture for p in progs)
    assert sum(p.graph_count for p in progs) >= 2


def test_a_program_that_dies_during_a_capture_is_not_freed_in_it(cuda):
    """A captured program in a reference cycle dies while another program
    records its graph, and the capture allocates enough long-lived
    objects to set off a full collection: the dead program (its graph
    with it) is freed after the capture, not inside it (which would
    invalidate the capture), and the graph replays right."""
    def program(value):
        prog = graphs.StepProgram(cuda, capture=True)
        x = prog.keep("x", torch.full((4,), value, device=cuda))
        prog.run("k", lambda: prog.keep("y", x * 2))
        prog.cycle = prog                     # only a collection frees it
        return prog

    held = [program(1.0)]
    freed_capturing = []
    weakref.finalize(held[0], lambda: freed_capturing.append(
        torch.cuda.is_current_stream_capturing()))
    gc.collect()
    # the oldest generation is collected once the objects promoted into
    # it since the last full collection reach a quarter of its size
    junk_count = len(gc.get_objects())
    prog = graphs.StepProgram(cuda, capture=True)
    x = prog.keep("x", torch.arange(4.0, device=cuda))
    calls, junk = [], []

    def fn():
        calls.append(len(calls))
        if len(calls) == 2:                   # the capture
            held.clear()
            junk.extend([] for _ in range(junk_count))
        return prog.keep("y", x + 1)

    first = prog.run("k", fn).clone()
    x.fill_(5.0)
    again = prog.run("k", fn)
    torch.cuda.synchronize()
    junk.clear()
    gc.collect()
    assert calls == [0, 1] and prog.graph_count == 1
    assert freed_capturing == [False]
    assert torch.equal(first, torch.arange(1.0, 5.0, device=cuda))
    assert torch.equal(again, torch.full((4,), 6.0, device=cuda))


@pytest.mark.parametrize("kind", ["synthetic", "oracle"])
def test_captured_render_equals_eager(cuda, kind):
    """Each source's render captured and eager, same seed and frames:
    the same depths bit for bit (NaN where one is NaN)."""
    from dbot_ros_tpu_torch.runtime import sources

    K = np.array([[60.0, 0, 20], [0, 60.0, 15], [0, 0, 1.0]])
    cam = camera.make_camera(K, 30, 40, device=cuda)
    m = mesh.tagged_l_mesh()

    def traj(t):
        return np.array([[0.002 * t, 0.0, 0.6, 1, 0, 0, 0]], np.float32)

    out = {}
    for capture in (True, False):
        if kind == "oracle":
            src = sources.OracleSource(
                m, sources.scale_camera(cam, 2), traj, 4, seed=1,
                occluder=mesh.box_mesh(0.03, 0.03, 0.01),
                occluder_fn=lambda t: np.array(
                    [0.03 - 0.01 * t, 0.0, 0.45, 1, 0, 0, 0], np.float32),
                dropout_prob=0.2, dropout_frames=(1, 3),
                edge_artifacts=0.5, quantize_mm=True, capture=capture)
        else:
            src = sources.SyntheticSource(m, cam, traj, 4, seed=1,
                                          dropout_prob=0.1, capture=capture)
        out[capture] = [f.depth for f in src]
        assert src._render.program.graph_count == (1 if capture else 0)
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)
