"""Wrappers of the port's CUDA kernels, each beside its plain PyTorch version.

Four kernels carry the tracker's main path (sources in csrc/), and a
fifth, ``age_pixel_rows`` (pixel_rows.cu, the port's own), the
distributed exchanges (``EXCHANGE_WRAPPERS``):

=====================  ===================  =================================
wrapper                CUDA source          replaces (Pallas, TPU)
=====================  ===================  =================================
``fused_loglik``       fused_loglik.cu      ``_fused_kernel`` via
                                            ``fused_loglik_packed``
                                            (dbot_ros_tpu/ops/
                                            raycast_pallas.py:192, :640)
``gather_pixel_rows``  pixel_rows.cu        ``gather_pixel_rows`` (:584)
``scatter_pixel_rows`` pixel_rows.cu        ``scatter_pixel_rows`` (:508)
``lineage_gather``     lineage_gather.cu    ``lineage_gather_pallas`` (:430)
``age_pixel_rows``     pixel_rows.cu        none: the closed form of
                                            ``occlusion_as_pn`` (:1052,
                                            array code) over the map
=====================  ===================  =================================

Scratch and outputs are allocated here with ``torch.empty``, never in a
kernel: ``fused_loglik`` takes one ``(n_groups, p_pad)`` float32 buffer of
partial sums (``n_groups`` comes from the library, a function of the
shapes and the card's SM count: 13 rows at 448 pixels and 10,112
particles on an H100); ``lineage_gather`` takes none beside its output (its
staging ring is shared memory), nor does ``gather_pixel_rows``.

Dispatch: a tensor on the CPU goes to the plain version (``*_plain``); a
CUDA tensor launches the kernel, or raises on a wrong dtype, shape,
device or contiguity. There is no fallback from the CUDA path. Each
wrapper counts its kernel launches in ``<wrapper>.launches`` (a plain
int, never reset here), so a run can show it went through the kernel;
``lineage_gather.two_width_launches`` counts again the launches whose
source and output differ in width (the distributed exchanges).
The sources' headers say what bounds each kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_TINY = 1e-30
_DET_EPS = 1e-12
_NEAR = 1e-4
_BIG = 1e30
_SQRT2PI = 2.5066282746310002


def _lib():
    from dbot_ros_tpu_torch.ops import build
    return build.load()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name, t, dtypes, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{[str(d) for d in dtypes]}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# ---------------------------------------------------------------------------
# Fused candidate raycast + beam likelihood + occlusion posterior
# ---------------------------------------------------------------------------

def fused_loglik_plain(slabs, occ, z, cand, rays, ages, params, tri_slack):
    """Plain PyTorch version of the fused kernel (same op order).

    Args:
      slabs: (T, 10, p_pad) f32 transformed constants
        ``[g_u(3) | g_v(3) | g_det(3) | t_num]`` per triangle.
      occ: (n, p_pad) occlusion map rows of the n pixels (bf16 or f32).
      z: (n,) f32 observed depth, NaN = invalid; cand: (n, K) triangle ids
        into ``slabs``; rays: (n, 3) f32; ages: (n,) f32 staleness of
        each occ row in frame units; params: (16,) f32 (make_params_vec;
        entry 15 is not read); tri_slack: (T,) f32 barycentric slack of
        each triangle's inside-test.
    Returns (loglik (p_pad,) f32 = Σ_j log p(z_j), occ_out (n, p_pad) in
    occ's dtype).
    """
    (msig, sfac, wt, minz, maxz, lam, p_inv_occ, p_inv_vis, p_inv_bg,
     occ_pi, _gdt, inv_range, occ_lg, occ_dtf, occ_sgn,
     _slack) = params.unbind()
    dx, dy, dz = rays[:, 0:1], rays[:, 1:2], rays[:, 2:3]   # (n, 1)
    zc = z[:, None]
    z_real = zc == zc
    z_valid = z_real & (zc >= minz) & (zc <= maxz)
    zz = torch.where(z_real, zc, 1.0)

    t = None
    for k in range(cand.shape[1]):
        s = slabs[cand[:, k].long()]                         # (n, 10, p_pad)
        slack = tri_slack[cand[:, k].long()][:, None]        # (n, 1)
        u = s[:, 0] * dx + s[:, 1] * dy + s[:, 2] * dz
        v = s[:, 3] * dx + s[:, 4] * dy + s[:, 5] * dz
        det = s[:, 6] * dx + s[:, 7] * dy + s[:, 8] * dz
        tn = s[:, 9]
        sgn = torch.sign(det)
        adet = torch.abs(det)
        sa = slack * adet
        valid = ((adet > _DET_EPS)
                 & (sgn * u >= -sa)
                 & (sgn * v >= -sa)
                 & (sgn * (u + v) <= adet + sa)
                 & (sgn * tn > _NEAR * adet))
        tk = torch.where(valid, tn / torch.where(valid, det, 1.0), _BIG)
        t = tk if t is None else torch.minimum(t, tk)
    on_sil = t < _BIG * 0.5
    d = torch.where(on_sil, t, 1.0)

    geff = occ_sgn * torch.exp(occ_lg * (ages[:, None] + occ_dtf))
    q = torch.clamp(occ_pi + geff * (occ.float() - occ_pi), 0.0, 1.0)

    sig = msig + sfac * d * d
    zn = (zz - d) / sig
    body_vis = torch.exp(-0.5 * zn * zn) / (sig * _SQRT2PI)
    lik_vis = torch.where(
        z_valid, ((1.0 - wt) * body_vis + wt * inv_range) * (1.0 - p_inv_vis),
        p_inv_vis)

    d_eff = torch.minimum(torch.maximum(d, minz), maxz)
    span = torch.clamp_min(d_eff - minz, 1e-6)
    norm_occ = torch.clamp_min(1.0 - torch.exp(-lam * span), 1e-6)
    body_occ = lam * torch.exp(-lam * (zz - minz)) / norm_occ
    in_front = z_valid & (zz <= d_eff)
    lik_occ = torch.where(
        z_real,
        ((1.0 - wt) * torch.where(in_front, body_occ, 0.0)
         + wt * torch.where(z_valid, inv_range, 0.0)) * (1.0 - p_inv_occ),
        p_inv_occ)
    lik_bg = torch.where(
        z_real, torch.where(z_valid, inv_range, 0.0) * (1.0 - p_inv_bg),
        p_inv_bg)

    p_on = (1.0 - q) * lik_vis + q * lik_occ
    p_z = torch.clamp_min(torch.where(on_sil, p_on, lik_bg), _TINY)
    post = q * lik_occ / torch.clamp_min(p_on, _TINY)
    post = torch.where(on_sil, torch.clamp(post, 0.0, 1.0), q)
    return torch.log(p_z).sum(dim=0), post.to(occ.dtype)


def fused_loglik(slabs, occ, z, cand, rays, ages, params, tri_slack):
    """Fused raycast + likelihood + occlusion posterior (see
    :func:`fused_loglik_plain` for the arguments and results).

    On CUDA: ``cand`` must be int32, every float input float32 except
    ``occ`` (bfloat16 or float32), all contiguous and on one device; the
    kernel writes a new ``occ_out`` (the input map is not modified).
    Scratch: one ``(n_groups, p_pad)`` float32 buffer of partial sums.
    Each block sums its pixels in a fixed order and a second kernel adds
    the ``n_groups`` rows in a fixed order (no atomics), so two calls on
    the same inputs give the same bits; the order differs from the plain
    version's single sum over pixels.
    """
    if not occ.is_cuda:
        return fused_loglik_plain(slabs, occ, z, cand, rays, ages, params,
                                  tri_slack)
    dev = occ.device
    f32 = (torch.float32,)
    _check("occ", occ, (torch.bfloat16, torch.float32), 2, dev)
    _check("slabs", slabs, f32, 3, dev)
    _check("z", z, f32, 1, dev)
    _check("cand", cand, (torch.int32,), 2, dev)
    _check("rays", rays, f32, 2, dev)
    _check("ages", ages, f32, 1, dev)
    _check("params", params, f32, 1, dev)
    _check("tri_slack", tri_slack, f32, 1, dev)
    n, p_pad = occ.shape
    K = cand.shape[1]
    if slabs.shape[1:] != (10, p_pad):
        raise ValueError(f"slabs must be (T, 10, {p_pad}), got "
                         f"{tuple(slabs.shape)}")
    if (z.shape != (n,) or cand.shape[0] != n or K < 1
            or rays.shape != (n, 3) or ages.shape != (n,)
            or params.shape != (16,) or tri_slack.shape != slabs.shape[:1]):
        raise ValueError(
            f"shape mismatch: occ {tuple(occ.shape)}, z {tuple(z.shape)}, "
            f"cand {tuple(cand.shape)}, rays {tuple(rays.shape)}, ages "
            f"{tuple(ages.shape)}, params {tuple(params.shape)}, tri_slack "
            f"{tuple(tri_slack.shape)} for {slabs.shape[0]} slabs")
    loglik = torch.empty((p_pad,), dtype=torch.float32, device=dev)
    occ_out = torch.empty_like(occ)
    if n == 0:
        return loglik.zero_(), occ_out
    lib = _lib()
    n_groups = lib.dbot_fused_loglik_groups(n, K, p_pad)
    if n_groups <= 0:
        raise RuntimeError("fused_loglik: cannot read the card's SM count")
    partial = torch.empty((n_groups, p_pad), dtype=torch.float32,
                          device=dev)
    entry = (lib.dbot_fused_loglik_bf16 if occ.dtype == torch.bfloat16
             else lib.dbot_fused_loglik_f32)
    err = entry(slabs.data_ptr(), occ.data_ptr(), z.data_ptr(),
                cand.data_ptr(), rays.data_ptr(), ages.data_ptr(),
                params.data_ptr(), tri_slack.data_ptr(), occ_out.data_ptr(),
                partial.data_ptr(), loglik.data_ptr(), n, K, p_pad, n_groups,
                _stream(occ))
    fused_loglik.launches += 1
    _raise_on(err, "fused_loglik launch")
    return loglik, occ_out


fused_loglik.launches = 0


# ---------------------------------------------------------------------------
# Pixel-row gather / scatter on the (n_pad, p_pad) occlusion map
# ---------------------------------------------------------------------------

def gather_pixel_rows_plain(q, sel):
    """``out[j] = q[clamp(sel[j], 0, n_rows - 1)]`` (plain PyTorch
    version)."""
    return q.index_select(0, sel.long().clamp(0, q.shape[0] - 1))


def scatter_pixel_rows_plain(q, vals, sel):
    """``q[sel[j]] = vals[j]`` in place (plain PyTorch version)."""
    return q.index_copy_(0, sel.long(), vals)


def _check_rows(q, sel):
    dev = q.device
    if q.ndim != 2 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous 2-D map, got shape "
                         f"{tuple(q.shape)}")
    _check("sel", sel, (torch.int32,), 1, dev)
    row_bytes = q.shape[1] * q.element_size()
    if row_bytes % 16 or q.data_ptr() % 16:
        raise ValueError("rows of q must be 16-byte multiples and aligned "
                         f"(row of {row_bytes} B)")
    return row_bytes


class RowsPlan(NamedTuple):
    """How ``gather_pixel_rows``' kernel cuts its work into ``n_items``
    (row, chunk) items, every row into ``chunks_per_row`` chunks of
    ``chunk_bytes`` (the last one shorter), for one of its two engines.
    The register engine (``bulk`` false, the one on the path,
    :func:`gather_rows_plan`): 16-byte items, a block of
    ``ROWS_REG_THREADS`` threads per row (``grid`` = rows), each thread
    moving ``ROWS_REG_UNROLL`` of them a pass. The bulk-copy engine
    (:func:`bulk_rows_plan`): items dealt in
    turn to ``grid`` one-warp blocks, each with a ring of ``n_slots``
    chunk-sized slots (``smem_bytes`` of dynamic shared memory)."""
    bulk: bool
    chunk_bytes: int
    chunks_per_row: int
    n_items: int
    grid: int
    n_slots: int
    smem_bytes: int


# pixel_rows.cu's limits: the register engine's kRegThreads and
# kRegUnroll; the bulk engine's kMaxSlots, kMaxRingBytes and kLag stores
# in flight (a block needs more slots than that)
ROWS_REG_THREADS, ROWS_REG_UNROLL = 512, 3
ROWS_MAX_SLOTS = 32
ROWS_RING_BYTES = 112 * 1024
ROWS_LAG = 4
# the bulk plan's choices: an item is at most 8 KB (a 20 KB row is
# three), two one-warp blocks per SM, each with a ring of up to
# ROWS_RING_BYTES
ROWS_CHUNK_BYTES = 8192
ROWS_BLOCKS_PER_SM = 2


def gather_rows_plan(n_sel: int, row_bytes: int) -> RowsPlan:
    """The register engine's work split for ``n_sel`` rows of
    ``row_bytes`` (a multiple of 16): 16-byte items, a block per row."""
    vecs = row_bytes // 16
    return RowsPlan(False, 16, vecs, n_sel * vecs, n_sel, 0, 0)


def bulk_rows_plan(n_sel: int, row_bytes: int, sms: int) -> RowsPlan:
    """The bulk-copy engine's work split (this engine is measured beside
    the register engine by chip_smoke.py, not on the path: PERF.md §6)
    on a card with ``sms`` SMs. Items are the fewest chunks of at most
    ``ROWS_CHUNK_BYTES`` a row, of equal size up to 16 bytes."""
    vecs = row_bytes // 16
    max_vecs = ROWS_CHUNK_BYTES // 16
    chunk_vecs = -(-vecs // -(-vecs // max_vecs))
    chunks = -(-vecs // chunk_vecs)
    chunk = 16 * chunk_vecs
    n_slots = min(ROWS_MAX_SLOTS, ROWS_RING_BYTES // chunk)
    n_items = n_sel * chunks
    return RowsPlan(True, chunk, chunks, n_items,
                    min(n_items, ROWS_BLOCKS_PER_SM * sms), n_slots,
                    n_slots * chunk)


def gather_pixel_rows(q, sel):
    """Pixel-row gather ``out[j, :] = q[sel[j], :]``; duplicate ``sel``
    entries are allowed, and every entry is clamped into ``[0,
    q.shape[0])``, by the kernel too, so it never reads outside the map.

    On CUDA: ``q`` contiguous with 16-byte rows and alignment, ``sel``
    int32. The kernel's work split is :func:`gather_rows_plan`'s."""
    if not q.is_cuda:
        return gather_pixel_rows_plain(q, sel)
    row_bytes = _check_rows(q, sel)
    if sel.shape[0] == 0:
        return torch.empty((0, q.shape[1]), dtype=q.dtype, device=q.device)
    return _gather_rows_launch(q, sel,
                               gather_rows_plan(sel.shape[0], row_bytes))


def _gather_rows_launch(q, sel, plan):
    """Launch the gather kernel on checked arguments with ``plan``
    (chip_smoke.py also times the bulk-copy engine through it)."""
    out = torch.empty((sel.shape[0], q.shape[1]), dtype=q.dtype,
                      device=q.device)
    err = _lib().dbot_gather_pixel_rows(
        q.data_ptr(), sel.data_ptr(), out.data_ptr(), sel.shape[0],
        q.shape[0], q.shape[1] * q.element_size(), int(plan.bulk),
        plan.chunk_bytes, plan.n_slots, plan.grid, _stream(q))
    gather_pixel_rows.launches += 1
    _raise_on(err, "gather_pixel_rows launch")
    return out


gather_pixel_rows.launches = 0


def scatter_pixel_rows(q, vals, sel):
    """Pixel-row scatter ``q[sel[j], :] = vals[j, :]``, **in place**: ``q``
    itself is updated and returned; rows not in ``sel`` are untouched.

    Precondition: ``sel`` entries are distinct and in ``[0, q.shape[0])``
    (the compaction ladder's selection ranks are). With duplicates the
    row written last is unspecified.
    """
    if not q.is_cuda:
        return scatter_pixel_rows_plain(q, vals, sel)
    row_bytes = _check_rows(q, sel)
    _check("vals", vals, (q.dtype,), 2, q.device)
    if vals.shape != (sel.shape[0], q.shape[1]):
        raise ValueError(f"vals must be {(sel.shape[0], q.shape[1])}, got "
                         f"{tuple(vals.shape)}")
    if vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned (the kernel copies "
                         "rows in 16-byte words)")
    if sel.shape[0] == 0:
        return q
    err = _lib().dbot_scatter_pixel_rows(q.data_ptr(), vals.data_ptr(),
                                         sel.data_ptr(), sel.shape[0],
                                         row_bytes, _stream(q))
    scatter_pixel_rows.launches += 1
    _raise_on(err, "scatter_pixel_rows launch")
    return q


scatter_pixel_rows.launches = 0


# ---------------------------------------------------------------------------
# Row aging of the lazy occlusion map (the distributed exchanges)
# ---------------------------------------------------------------------------

def age_pixel_rows_plain(q, geff, pi):
    """The lazy map's closed form with one factor a row: ``out[n, c] =
    clamp(q[n, c] if geff[n] == 1 else pi + geff[n]·(q[n, c] − pi), 0, 1)``
    in float32, in ``q``'s dtype (plain PyTorch version; ``occlusion_as_pn``
    applies it in float32)."""
    qf = q.to(torch.float32)
    g = geff[:, None]
    q_now = pi + g * (qf - pi)
    return torch.clamp(torch.where(g == 1.0, qf, q_now), 0.0,
                       1.0).to(q.dtype)


def age_pixel_rows(q, geff, pi):
    """:func:`age_pixel_rows_plain` in one pass over the map, out of
    place: ``q`` is ``(n_rows, p)`` bfloat16 or float32, contiguous, rows
    16-byte multiples; ``geff`` ``(n_rows,)`` and ``pi`` (0-d) float32 on
    its device. The result is a new map, equal to the plain version's bit
    for bit (the kernel rounds op by op in the same order)."""
    if not q.is_cuda:
        return age_pixel_rows_plain(q, geff, pi)
    _check("q", q, (torch.bfloat16, torch.float32), 2, q.device)
    _check("geff", geff, (torch.float32,), 1, q.device)
    _check("pi", pi, (torch.float32,), 0, q.device)
    n_rows, p = q.shape
    if geff.shape[0] != n_rows:
        raise ValueError(f"geff must be ({n_rows},), got "
                         f"{tuple(geff.shape)}")
    row_bytes = p * q.element_size()
    if row_bytes % 16 or q.data_ptr() % 16:
        raise ValueError(f"rows of q must be 16-byte multiples and aligned "
                         f"(rows of {row_bytes} B)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    err = _lib().dbot_age_pixel_rows(
        q.data_ptr(), geff.data_ptr(), pi.data_ptr(), out.data_ptr(),
        n_rows, row_bytes, int(q.dtype == torch.bfloat16), _stream(q))
    age_pixel_rows.launches += 1
    _raise_on(err, "age_pixel_rows launch")
    return out


age_pixel_rows.launches = 0


# ---------------------------------------------------------------------------
# Particle-lineage gather along the particle axis of the occlusion map
# ---------------------------------------------------------------------------

def lineage_gather_plain(q, idx):
    """``out[n, c] = q[n, clamp(idx[c], 0, p_in - 1)]`` for ``q`` of shape
    ``(n_rows, p_in)`` and ``idx`` of ``(p_out,)``, any two widths (plain
    PyTorch version)."""
    return q.index_select(1, idx.long().clamp(0, q.shape[1] - 1))


def lineage_gather(q, idx):
    """Resampling lineage gather ``out[n, c] = q[n, idx[c]]``: ``q`` is
    ``(n_rows, p_in)``, ``idx`` ``(p_out,)``, the result ``(n_rows,
    p_out)``, exact for any ``idx`` (sorted or not).

    On one card ``p_out == p_in`` (the map's own ``p_pad``); the
    distributed exchanges gather from a source of another width (surplus
    buffers, concatenated blocks). Indices are clamped into ``[0, p_in)``,
    by the kernel too, so it never reads outside the source. On CUDA:
    ``q`` is bfloat16 or float32, contiguous, with rows of both widths
    16-byte multiples; ``idx`` is int32 (convert the resampler's int64
    parents once per call). Out of place: the result is a new buffer owned
    by the caller; ``q`` is only read. No other scratch: the kernel stages
    rows in shared memory.
    """
    if not q.is_cuda:
        return lineage_gather_plain(q, idx)
    _check("q", q, (torch.bfloat16, torch.float32), 2, q.device)
    _check("idx", idx, (torch.int32,), 1, q.device)
    n_rows, p_in = q.shape
    p_out = idx.shape[0]
    elem = q.element_size()
    if (p_in * elem) % 16 or (p_out * elem) % 16 or q.data_ptr() % 16:
        raise ValueError("rows of q and of the output must be 16-byte "
                         f"multiples and aligned (rows of {p_in * elem} "
                         f"and {p_out * elem} B)")
    out = torch.empty((n_rows, p_out), dtype=q.dtype, device=q.device)
    if n_rows == 0 or p_out == 0:
        return out
    lib = _lib()
    entry = (lib.dbot_lineage_gather_b16 if elem == 2
             else lib.dbot_lineage_gather_b32)
    err = entry(q.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows, p_in,
                p_out, _stream(q))
    lineage_gather.launches += 1
    if p_in != p_out:
        lineage_gather.two_width_launches += 1
    _raise_on(err, "lineage_gather launch")
    return out


lineage_gather.launches = 0
# launches with a source and an output of different widths (the
# distributed exchanges), counted again here
lineage_gather.two_width_launches = 0

# the wrappers by name, each counting its launches in ``launches``: the
# four of every tracker step, and the one that only the distributed
# exchanges launch
WRAPPERS = {"fused_loglik": fused_loglik,
            "gather_pixel_rows": gather_pixel_rows,
            "scatter_pixel_rows": scatter_pixel_rows,
            "lineage_gather": lineage_gather}
EXCHANGE_WRAPPERS = {"age_pixel_rows": age_pixel_rows}
