"""The pixel-row gather: its plain version against the Pallas kernel, and
the work split its CUDA kernel is launched with.

The JAX side runs ``gather_pixel_rows`` in interpret mode, as
tests/test_pallas.py does. The port's gather clamps every index into the
map (its kernel and its plain version alike); the Pallas kernel is given
the clamped indices. Rows move as bits: equal.

``gather_rows_plan`` and ``bulk_rows_plan`` are the host half of
csrc/pixel_rows.cu's gather engines:
the tests walk its items the way the kernel does, for both engines, and
hold that they cover every byte of every row once, in 16-byte multiples
that fit a register (or a ring slot, with the ring inside the card's
shared memory). The
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu.ops import raycast_pallas as jrp
from dbot_ros_tpu_torch import interop
from dbot_ros_tpu_torch.ops import fused_sensor as fs
from dbot_ros_tpu_torch.ops import kernels

torch.set_num_threads(1)

# H100: 227 KB of shared memory a block can have, 228 KB an SM holds,
# 1 KB of it reserved per block; the kernel's static barriers
SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED = 232_448, 233_472, 1024
STATIC_SMEM = 8 * kernels.ROWS_MAX_SLOTS


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_plain_clamps_and_matches_pallas(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    g = np.random.default_rng(5)
    P, N, n_pad = 300, 1200, 1216
    jp_pad, pr = interop.jax_particle_pads(P)
    qj = jnp.asarray(g.uniform(size=(n_pad * pr, 128)), jdt)
    q = interop.occlusion_from_jax(np.asarray(qj, np.float32), P, N,
                                   occ_dtype=tdt)
    sel = g.integers(0, n_pad, 96).astype(np.int32)
    sel[5] = sel[9]                                      # a duplicate
    sel[10:16] = [-1, -7, n_pad, n_pad + 3, 2**31 - 1, -2**31]
    want = np.asarray(jrp.gather_pixel_rows(
        qj, jnp.asarray(np.clip(sel, 0, n_pad - 1)), pr, interpret=True),
        np.float32).reshape(96, jp_pad)[:, :fs.particle_pad(P)]
    got = kernels.gather_pixel_rows(q, torch.as_tensor(sel))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    # below the map: its first row; past it: its last
    assert torch.equal(got[10:16], q[[0, 0, n_pad - 1, n_pad - 1,
                                      n_pad - 1, 0]])


def kernel_items(plan, n_sel, row_bytes):
    """The items as pixel_rows.cu walks them: the C entry's
    chunks_per_row, then per item its row, byte offset and length."""
    cpr = -(-row_bytes // plan.chunk_bytes)
    assert cpr == plan.chunks_per_row
    assert plan.n_items == n_sel * cpr
    i = np.arange(plan.n_items)
    off = (i % cpr) * plan.chunk_bytes
    return i // cpr, off, np.minimum(plan.chunk_bytes, row_bytes - off)


SHAPES = [(448, 20_224, 132), (2432, 20_224, 132), (1, 16, 132),
          (131, 20_240, 132), (133, 16, 132), (5, 8192, 132),
          (7, 8208, 132), (300, 640, 132), (64, 2_000_016, 114),
          (3, 20_224, 1), (1409, 20_224, 132)]


@pytest.mark.parametrize("bulk", [False, True])
@pytest.mark.parametrize("n_sel,row_bytes,sms", SHAPES)
def test_gather_rows_plan_covers_every_byte_once(n_sel, row_bytes, sms,
                                                 bulk):
    plan = (kernels.bulk_rows_plan(n_sel, row_bytes, sms) if bulk
            else kernels.gather_rows_plan(n_sel, row_bytes))
    assert plan.bulk == bulk
    rows, off, size = kernel_items(plan, n_sel, row_bytes)
    assert plan.chunk_bytes % 16 == 0 and plan.chunk_bytes <= row_bytes
    assert plan.chunk_bytes <= kernels.ROWS_CHUNK_BYTES
    assert np.all(size > 0) and np.all(size % 16 == 0)
    assert np.all(size <= plan.chunk_bytes)    # fits a slot (a register)
    assert np.all(off % 16 == 0)
    # every byte of every row in exactly one item
    for j in {0, n_sel // 2, n_sel - 1}:
        mine = np.flatnonzero(rows == j)
        covered = np.zeros(row_bytes, np.int64)
        for s, n in zip(off[mine], size[mine]):
            covered[s:s + n] += 1
        assert np.all(covered == 1)
    assert np.bincount(rows, minlength=n_sel).min() == plan.chunks_per_row
    if not plan.bulk:
        # a block per row; thread t moves the row's vectors base + t +
        # u·T (u < U) for base = 0, T·U, 2·T·U, …: each exactly once
        assert plan.chunk_bytes == 16 and plan.smem_bytes == 0
        assert plan.grid == n_sel and plan.n_slots == 0
        T, U = kernels.ROWS_REG_THREADS, kernels.ROWS_REG_UNROLL
        vecs = plan.chunks_per_row
        walked = np.concatenate([
            base + u * T + np.arange(T) for base in range(0, vecs, T * U)
            for u in range(U)])
        walked = walked[walked < vecs]
        assert np.array_equal(np.sort(walked), np.arange(vecs))
        return
    # the ring: more slots than stores in flight, inside the card
    assert kernels.ROWS_LAG < plan.n_slots <= kernels.ROWS_MAX_SLOTS
    assert plan.smem_bytes == plan.n_slots * plan.chunk_bytes
    assert plan.smem_bytes <= kernels.ROWS_RING_BYTES
    block = plan.smem_bytes + STATIC_SMEM
    assert block <= SMEM_PER_BLOCK
    assert (kernels.ROWS_BLOCKS_PER_SM * (block + SMEM_RESERVED)
            <= SMEM_PER_SM)
    # items dealt in turn: every block has work, shares differ by one
    assert 0 < plan.grid <= min(plan.n_items,
                                kernels.ROWS_BLOCKS_PER_SM * sms)
    share = np.bincount(np.arange(plan.n_items) % plan.grid)
    assert share.min() >= 1 and share.max() - share.min() <= 1


def test_gather_plan_at_the_ladder_levels():
    """The register engine at the ladder's tight and second level and
    over the whole map: a 20,224-byte row (1,264 vectors) is one pass of
    a block."""
    T, U = kernels.ROWS_REG_THREADS, kernels.ROWS_REG_UNROLL
    for n_sel in (448, 2432, 4800):
        plan = kernels.gather_rows_plan(n_sel, 20_224)
        assert not plan.bulk and plan.n_slots == 0 and plan.grid == n_sel
        assert plan.n_items == n_sel * 1264 <= n_sel * T * U


def test_gather_keeps_its_cpu_path_and_empty_shortcut():
    q = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    sel = torch.tensor([5, 9, -2], dtype=torch.int32)
    assert torch.equal(kernels.gather_pixel_rows(q, sel), q[[5, 5, 0]])
    empty = kernels.gather_pixel_rows(q, sel[:0])
    assert empty.shape == (0, 4)
