"""Int8 KV-cache decode attention: the CUDA kernels, their plain
PyTorch versions, and the routing predicates.

Counterpart of ``mpistragglers_jl_tpu/ops/decode_attention.py``. Both
TPU kernels there become ``csrc/decode_attention.cu``:

* ``_kernel`` (K5): single-query GQA attention over an int8
  ``(B, L, Hkv, D)`` cache with f32 ``(B, L, Hkv)`` scales, positional
  or ring mask, dequantised in registers, positions per row from a
  device vector;
* ``_paged_kernel`` (K6, ``page_table=``): the same ring math over a
  page pool shared by all rows, {"k","v"} int8 ``(n_pages * P, Hkv,
  D)`` and {"k_s","v_s"} f32 ``(n_pages * P, Hkv)``, read in place
  through a ``(B, max_pages)`` int32 page table, ``W = max_pages * P``.

So does K7, the attribution variants of
``benchmarks/decode_kernel_attrib.py`` (``variant(mode)``): K5 with
everything after the tile load stripped to ``dma``, ``dot``,
``dequant`` or ``full_nosm`` (:func:`decode_attention_attrib`), a
template mode of the same kernel.

All are bound by bytes: at the serving shape (B=8, W=1024, Hkv=2,
D=128, g=4) one launch moves about 4.36 MB, 1.30 us at the H100's
3.35 TB/s. K5 and K7 split the key range (flash-decoding): a grid of
(Hkv, B, n_split) blocks, each over a chunk of whole 32-key tiles, then
a combine kernel that folds the splits' partial softmax states.
:func:`split_plan` picks the chunk on the host from the shapes alone,
so a call never syncs and stays capturable in a CUDA graph; the wrapper
allocates the partials with ``torch.empty``. K6 runs the same kernel
and combine over :func:`paged_split_plan`'s chunks, K5's cut to whole
pages where a page divides them. The source note says how the design
meets the bound and what is left for later (TMA).

:func:`quantized_decode_attention` runs the plain versions only for
tensors on the CPU; for CUDA tensors it launches a kernel or raises.
``LAUNCHES`` counts wrapper calls whose kernels ran, one per call even
where a split kernel and its combine are two launches (never
plain-version calls, never calls recorded into a CUDA graph), one entry
per kernel, so a run can show its main path went through them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = [
    "ATTRIB_MODES",
    "LAUNCHES",
    "DEFAULT_BLOCK_K",
    "decode_attention_attrib",
    "decode_attention_attrib_ref",
    "decode_kernel_viable",
    "paged_block_viable",
    "paged_decode_attention_ref",
    "paged_ring_view",
    "paged_split_plan",
    "quantized_decode_attention",
    "quantized_decode_attention_ref",
    "sm_count",
    "split_plan",
]

_NEG = -1e30
_MAX_GROUP = 8  # q rows per kv head the kernel carries (one per warp)

# kernel name -> launches since the counter was last set to 0
LAUNCHES = {"quantized_decode_attention": 0, "paged_decode_attention": 0,
            "decode_attention_attrib": 0}

# K7's variants, by the reference's names -> the kernel's Mode
ATTRIB_MODES = {"dma": 1, "dot": 2, "dequant": 3, "full_nosm": 4}
_TILE = 32  # keys per tile of the kernel
# split_plan's floor: at least this many tiles a split, so the block's
# warps have tiles to share
_SPLIT_MIN_TILES = 4

# The routing predicate below keeps the reference's TPU block-picker
# arithmetic (its calibrated scoped-VMEM budget) so the port routes
# exactly the calls the JAX package routes. The CUDA kernel itself
# takes any length: re-deriving the gate for the H100 is later work
# (ROADMAP.md).
_VMEM_PER_ROW_HEAD = 11.3
_VMEM_CAP = 12 * 2 ** 20
DEFAULT_BLOCK_K = 8192


def _pick_block_128(L: int, block: int, Hkv: int = 2,
                    D: int = 128) -> int | None:
    """The reference's k-block picker, copied: the largest multiple of
    128 <= ``block`` dividing L within the TPU's calibrated VMEM
    budget, else the whole length when that fits, else None."""
    cap = int(_VMEM_CAP / (Hkv * D * _VMEM_PER_ROW_HEAD))
    b = min(block, L, max(cap, 128))
    b -= b % 128
    while b >= 128:
        if L % b == 0:
            return b
        b -= 128
    if L <= max(cap, 128):
        return L
    return None


def decode_kernel_viable(L: int, Hkv: int, D: int) -> bool:
    """Would the reference route a cache of length ``L`` to its kernel?
    True iff :func:`_pick_block_128` finds a block at
    ``DEFAULT_BLOCK_K``."""
    return _pick_block_128(L, DEFAULT_BLOCK_K, Hkv, D) is not None


def paged_block_viable(page_tokens: int) -> bool:
    """Would the reference route pages of ``page_tokens`` rows to its
    paged kernel where the parity tests run? Its interpreter takes any
    multiple of 8 rows (a compiled TPU kernel needs 32), so the port
    keeps ``P >= 8 and P % 8 == 0`` and both packages route the same
    calls. The CUDA kernel addresses every key through the table and
    takes any P; re-deriving the rule on the H100 is later work
    (ROADMAP.md)."""
    P = int(page_tokens)
    return P >= 8 and P % 8 == 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SM count of a CUDA ``device``, read once per device from its
    properties on the host (no sync with the card)."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def split_plan(B: int, Hkv: int, L: int, block_k: int | None = None, *,
               n_sm: int) -> tuple[int, int]:
    """K5's and K7's split of the key range: ``(chunk, n_split)``.

    Split s covers keys ``[s * chunk, (s + 1) * chunk)``; ``chunk`` is a
    whole number of 32-key tiles and ``n_split = ceil(L / chunk)``. The
    plan reads only these integers, never a tensor (nor the positions),
    so a decode step never syncs with the card. It aims the grid of
    ``Hkv * B * n_split`` blocks at about one block per SM of a card
    with ``n_sm`` SMs (one block of K5 fills an SM's shared memory;
    :func:`sm_count`), with at least four tiles a split, and one split
    when ``B * Hkv`` alone fills the card. K7 passes its ``block_k``:
    the chunk then divides it, so no split straddles two ``block_k``
    segments."""
    tiles = -(-int(L) // _TILE)
    want = max(1, int(n_sm) // (int(B) * int(Hkv)))
    per = max(_SPLIT_MIN_TILES, -(-tiles // want))
    if block_k is None:
        per = min(per, tiles)
    else:
        seg = int(block_k) // _TILE
        per = min((d for d in range(per, seg + 1) if seg % d == 0),
                  default=seg)
    chunk = per * _TILE
    return chunk, -(-int(L) // chunk)


def paged_split_plan(B: int, Hkv: int, W: int, P: int, *,
                     n_sm: int) -> tuple[int, int]:
    """K6's split of the ring's ``W = max_pages * P`` slots: ``(chunk,
    n_split)``, from the shapes alone, as :func:`split_plan`.

    It starts from K5's chunk at the same ``(B, Hkv, W)`` and card and
    rounds it up to whole units of ``lcm(P, 32)`` slots (whole pages and
    whole 32-key tiles) where that at most doubles it, so no split reads
    part of a page and the grid never holds more blocks than K5's (one
    block fills an SM: a second wave of blocks costs as much as the
    first). Otherwise (pages longer than twice the chunk) the chunk stays
    K5's, a whole number of tiles, and a page spans splits, which the
    kernel's page-table lookup per key allows."""
    chunk, _ = split_plan(B, Hkv, W, n_sm=n_sm)
    unit = math.lcm(int(P), _TILE)
    whole = -(-chunk // unit) * unit
    if whole <= 2 * chunk:
        chunk = whole
    return chunk, -(-int(W) // chunk)


def _pos_vector(pos, B: int, device) -> torch.Tensor:
    """Scalar or (B,) positions -> a contiguous (B,) int32 tensor on
    ``device``; a tensor already there is never fetched to the host."""
    p = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    return p.expand(B).contiguous()


def _check(q, Hkv: int, ring: bool, window):
    if ring and window is not None:
        raise ValueError(
            "ring mode encodes the window in the cache layout; pass "
            "window=None (the ring length IS the window)"
        )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"decode kernel is single-query, got T={T}")
    if H % Hkv != 0 or H // Hkv > _MAX_GROUP:
        raise ValueError(
            f"GQA group {H}/{Hkv} must be a whole number <= {_MAX_GROUP}"
        )
    return B, H, D, Hkv


def paged_ring_view(leaf, page_table, P: int):
    """Gather every row's ring view out of a page-pool leaf: page
    ``page_table[b, j]`` supplies ring slots ``[j*P, (j+1)*P)`` of row
    b. ``leaf`` ``(n_pages * P, ...)`` -> ``(B, max_pages * P, ...)``,
    a new tensor."""
    B, max_pages = page_table.shape
    tail = leaf.shape[1:]
    pages = leaf.reshape((leaf.shape[0] // P, P) + tail)
    return pages[page_table.reshape(-1).long()].reshape(
        (B, max_pages * P) + tail)


def quantized_decode_attention_ref(q, cache_l: dict, pos, scale,
                                   window=None, *, ring: bool = False):
    """Plain PyTorch version of the kernel, same function: q
    ``(B, 1, H, D)``; ``cache_l`` {"k","v"} int8 ``(B, L, Hkv, D)`` +
    {"k_s","v_s"} f32 ``(B, L, Hkv)``; ``pos`` scalar or ``(B,)``.
    Masked keys get p = 0 and the normaliser is clamped at 1e-20, so a
    row with nothing visible returns zeros, as the kernel does.
    Returns ``(B, 1, H, D)`` in q's dtype."""
    B, H, D, Hkv = _check(q, cache_l["k"].shape[2], ring, window)
    L = cache_l["k"].shape[1]
    g = H // Hkv
    posv = _pos_vector(pos, B, q.device)[:, None]
    kidx = torch.arange(L, device=q.device)[None, :]
    if ring:
        valid = (kidx <= posv) | (posv >= L)
    else:
        valid = kidx <= posv
        if window is not None:
            valid = valid & (posv - kidx < window)
    q5 = q.float().reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,blhd->bhgl", q5, cache_l["k"].float()) * scale
    s = s * cache_l["k_s"].permute(0, 2, 1)[:, :, None, :]
    vm = valid[:, None, None, :]
    s = torch.where(vm, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vm, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    pv = p * cache_l["v_s"].permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bhgl,blhd->bhgd", pv, cache_l["v"].float()) / l
    return o.reshape(B, 1, H, D).to(q.dtype)


def paged_decode_attention_ref(q, pool: dict, pos, scale, page_table,
                               page_tokens: int):
    """Plain PyTorch version of the paged kernel, same function: a
    page-block gather of every row's ``(B, W, ...)`` ring view, then
    :func:`quantized_decode_attention_ref` in ring mode."""
    _check_paged(q, pool, page_table, page_tokens)
    view = {kk: paged_ring_view(a, page_table, page_tokens)
            for kk, a in pool.items()}
    return quantized_decode_attention_ref(q, view, pos, scale, ring=True)


def _check_paged(q, pool, page_table, P: int):
    B, H, D, Hkv = _check(q, pool["k"].shape[1], True, None)
    N = pool["k"].shape[0]
    if P < 1 or N % P != 0:
        raise ValueError(f"page pool of {N} rows is not a multiple of "
                         f"page_tokens {P}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page table must be (B={B}, max_pages), got "
                         f"{tuple(page_table.shape)}")
    return B, H, D, Hkv, N // P


def _check_leaves(q, named):
    """Kernel inputs: on q's device, of the stated dtype and shape,
    contiguous; q itself bf16 or f32 with a head_dim the kernel has."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    D = q.shape[-1]
    if D % 128 != 0 or D > 512:
        raise ValueError(f"kernel takes head_dim in 128..512 step 128, "
                         f"got {D}")
    for name, t, dt, shape in named:
        if t.device != q.device or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"{name!r}: want {dt} {shape} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name!r} must be contiguous")


def _kernel_lib():
    from ._build import load

    lib = load("decode_attention")
    if lib.k5_decode_attention_int8.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        k5 = lib.k5_decode_attention_int8
        k5.argtypes = [vp] * 10 + [ci] * 5 + [cf] + [ci] * 5 + [vp]
        k5.restype = ci
        k6 = lib.k6_paged_decode_attention_int8
        k6.argtypes = [vp] * 11 + [ci] * 7 + [cf] + [ci] * 3 + [vp]
        k6.restype = ci
        k7 = lib.k7_decode_attention_attrib
        k7.argtypes = [ci] * 2 + [vp] * 9 + [ci] * 5 + [cf] + [ci] * 3 + [vp]
        k7.restype = ci
        lib.decode_attention_error_string.argtypes = [ci]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _split_scratch(q, B: int, Hkv: int, g: int, D: int, n_split: int):
    """The split kernel's f32 partials as data pointers (acc, m, l):
    ``(B, Hkv, n_split, g, D)`` then ``(B, Hkv, n_split, g)`` twice, cut
    from one ``torch.empty`` on q's device (inside a CUDA-graph capture,
    from the graph's pool); acc first, so its rows stay 16-byte
    aligned. Null pointers and no allocation for one split. The buffer
    is returned too, to live until the launch is enqueued."""
    if n_split == 1:
        return (None, None, None), None
    n = B * Hkv * n_split * g
    buf = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    base = buf.data_ptr()
    return (base, base + 4 * n * D, base + 4 * n * (D + 1)), buf


def _launched(lib, err: int, name: str) -> None:
    """Raise on a refused launch, else count it. A call during CUDA-graph
    capture only records the kernel into the graph, so it is not
    counted; nor are the graph's replays."""
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            + lib.decode_attention_error_string(err).decode()
        )
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1


def quantized_decode_attention(q, cache_l: dict, pos, scale, window=None,
                               *, ring: bool = False, page_table=None,
                               page_tokens: int | None = None):
    """Single-query grouped attention against an int8 cache layer,
    the reference's signature and layouts (see
    :func:`quantized_decode_attention_ref` for the function).

    CPU tensors run the plain version. CUDA tensors launch the split
    kernel and its combine (:func:`split_plan`) on the current stream
    (bf16 or f32 q; contiguous leaves; ``pos`` may be a device vector,
    so a decode step never syncs) or raise; there is no fallback.
    ``ring=True`` reads the O(W) ring layout (L == W), where ``window``
    must be None.

    ``page_table=`` (ring mode only, with ``page_tokens=P``) reads the
    paged ring layout: ``cache_l`` leaves are page pools shared by all
    rows and ``page_table`` the ``(B, max_pages)`` int32 map from row
    b's ring page j to its pool page (:func:`paged_decode_attention_ref`
    is the function)."""
    if page_table is not None:
        if not ring or window is not None:
            raise ValueError("page_table reads the ring layout: pass "
                             "ring=True and window=None")
        if page_tokens is None:
            raise ValueError("page_table needs page_tokens")
        return _paged(q, cache_l, pos, scale, page_table, int(page_tokens))
    if q.device.type == "cpu":
        return quantized_decode_attention_ref(q, cache_l, pos, scale,
                                              window, ring=ring)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    kc, vc, ks, vs = (cache_l[n] for n in ("k", "v", "k_s", "v_s"))
    B, H, D, Hkv = _check(q, kc.shape[2], ring, window)
    L = kc.shape[1]
    _check_leaves(q, (
        ("k", kc, torch.int8, (B, L, Hkv, D)),
        ("v", vc, torch.int8, (B, L, Hkv, D)),
        ("k_s", ks, torch.float32, (B, L, Hkv)),
        ("v_s", vs, torch.float32, (B, L, Hkv)),
    ))
    qc = q.contiguous()
    posv = _pos_vector(pos, B, q.device)
    out = torch.empty_like(qc)
    chunk, n_split = split_plan(B, Hkv, L, n_sm=sm_count(q.device))
    (acc, m, l), _keep = _split_scratch(q, B, Hkv, H // Hkv, D, n_split)
    lib = _kernel_lib()
    err = lib.k5_decode_attention_int8(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), posv.data_ptr(), out.data_ptr(), m, l, acc, B, L,
        Hkv, H // Hkv, D, float(scale), 0 if window is None else int(window),
        int(bool(ring)), chunk, n_split, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _launched(lib, err, "quantized_decode_attention")
    return out


def _paged(q, pool, pos, scale, page_table, P: int):
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pool, pos, scale, page_table,
                                          P)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, H, D, Hkv, n_pages = _check_paged(q, pool, page_table, P)
    kc, vc, ks, vs = (pool[n] for n in ("k", "v", "k_s", "v_s"))
    N, max_pages = kc.shape[0], page_table.shape[1]
    _check_leaves(q, (
        ("k", kc, torch.int8, (N, Hkv, D)),
        ("v", vc, torch.int8, (N, Hkv, D)),
        ("k_s", ks, torch.float32, (N, Hkv)),
        ("v_s", vs, torch.float32, (N, Hkv)),
        ("page_table", page_table, torch.int32, (B, max_pages)),
    ))
    qc = q.contiguous()
    posv = _pos_vector(pos, B, q.device)
    out = torch.empty_like(qc)
    chunk, n_split = paged_split_plan(B, Hkv, max_pages * P, P,
                                      n_sm=sm_count(q.device))
    (acc, m, l), _keep = _split_scratch(q, B, Hkv, H // Hkv, D, n_split)
    lib = _kernel_lib()
    err = lib.k6_paged_decode_attention_int8(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), posv.data_ptr(), page_table.data_ptr(),
        out.data_ptr(), m, l, acc, B, max_pages, P, n_pages, Hkv, H // Hkv,
        D, float(scale), chunk, n_split, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _launched(lib, err, "paged_decode_attention")
    return out


def _check_attrib(mode: str, block_k: int) -> None:
    if mode not in ATTRIB_MODES:
        raise ValueError(f"mode must be one of {sorted(ATTRIB_MODES)}, got "
                         f"{mode!r}")
    if block_k < _TILE or block_k % _TILE:
        raise ValueError(f"block_k must be a positive multiple of {_TILE}, "
                         f"got {block_k}")


def decode_attention_attrib_ref(q, cache_l: dict, pos, scale, mode: str,
                                block_k: int):
    """Plain PyTorch version of K7, the same function: for kv head h,
    q head i of its group and ``s_l = (q_i . k_l) * scale`` over every
    key l (``pos`` is not read: the reference runs the variants at
    ``pos = L - 1``), with segments ``[j * block_k, (j + 1) * block_k)``
    cut at L:

    * ``dma``: ``out[b, 0, 0] = sum_j (k[b, j*bk, 0, 0] + v[b, j*bk, 0,
      0])``;
    * ``dot``: ``out[b, h*g+i, 0] = sum_j max_{l in seg j} s_l``;
    * ``dequant``: the same with ``s_l * k_s[l, h]``;
    * ``full_nosm``: ``out[b, h*g+i, :] = sum_l s_l * k_s[l, h] *
      v_s[l, h] * v_l``;

    every other entry 0. q ``(B, 1, H, D)``; returns ``(B, H, D)`` f32
    (the reference's rows without its 8-row group padding)."""
    del pos
    _check_attrib(mode, block_k)
    B, H, D, Hkv = _check(q, cache_l["k"].shape[2], False, None)
    L, g = cache_l["k"].shape[1], H // Hkv
    kf, vf = cache_l["k"].float(), cache_l["v"].float()
    out = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    if mode == "dma":
        starts = torch.arange(0, L, block_k, device=q.device)
        out[:, 0, 0] = (kf[:, starts, 0, 0] + vf[:, starts, 0, 0]).sum(1)
        return out
    q5 = q.float().reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,blhd->bhgl", q5, kf) * scale
    if mode != "dot":
        s = s * cache_l["k_s"].permute(0, 2, 1)[:, :, None, :]
    if mode == "full_nosm":
        pv = s * cache_l["v_s"].permute(0, 2, 1)[:, :, None, :]
        return torch.einsum("bhgl,blhd->bhgd", pv, vf).reshape(B, H, D)
    seg = sum(c.amax(dim=-1) for c in s.split(block_k, dim=-1))
    out[:, :, 0] = seg.reshape(B, H)
    return out


def decode_attention_attrib(q, cache_l: dict, pos, scale, mode: str,
                            block_k: int):
    """K7: one of the reference's stripped decode kernels (``mode`` in
    :data:`ATTRIB_MODES`) over the positional int8 cache, every key
    visible; :func:`decode_attention_attrib_ref` is the function.

    CPU tensors run the plain version. CUDA tensors launch K5's kernel
    in the mode's template instance on K5's split grid
    (:func:`split_plan` with ``block_k``), then its combine, on the
    current stream, or raise. ``block_k`` (a multiple of 32) closes the
    segments of ``dma``, ``dot`` and ``dequant``. Returns ``(B, H, D)``
    f32."""
    if q.device.type == "cpu":
        return decode_attention_attrib_ref(q, cache_l, pos, scale, mode,
                                           block_k)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_attrib(mode, block_k)
    kc, vc, ks, vs = (cache_l[n] for n in ("k", "v", "k_s", "v_s"))
    B, H, D, Hkv = _check(q, kc.shape[2], False, None)
    L = kc.shape[1]
    _check_leaves(q, (
        ("k", kc, torch.int8, (B, L, Hkv, D)),
        ("v", vc, torch.int8, (B, L, Hkv, D)),
        ("k_s", ks, torch.float32, (B, L, Hkv)),
        ("v_s", vs, torch.float32, (B, L, Hkv)),
    ))
    qc = q.contiguous()
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    chunk, n_split = split_plan(B, Hkv, L, block_k,
                                n_sm=sm_count(q.device))
    (acc, m, l), _keep = _split_scratch(q, B, Hkv, H // Hkv, D, n_split)
    lib = _kernel_lib()
    err = lib.k7_decode_attention_attrib(
        ATTRIB_MODES[mode], int(block_k), qc.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), ks.data_ptr(), vs.data_ptr(), out.data_ptr(),
        m, l, acc, B, L, Hkv, H // Hkv, D, float(scale), chunk, n_split,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _launched(lib, err, "decode_attention_attrib")
    return out
