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
(its ``sensor`` phase).
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
    with pytest.raises(ValueError, match="one entry per column"):
        kernels.lineage_gather(q, idx[:128])
    with pytest.raises(ValueError):                 # idx on another device
        kernels.lineage_gather(q, idx.cpu())
    with pytest.raises(ValueError, match="16-byte"):
        kernels.lineage_gather(q[:, :100].contiguous(), idx[:100])
