"""Kernel D: decode attention over the head-major KV cache
(`csrc/decode_attention.cu`).

Replaces `emu_tpu/ops/decode_attention.py:decode_attention` and
`:paged_decode_attention` (one kernel body there, one CUDA source here) in
every form the JAX package runs:

- the FULL stacked cache [L, B, Hkv, S, D] plus a layer index (a pointer
  offset in the kernel, no per-layer copy), a [B, S] validity mask, GQA
  (query head h reads kv head h // (H/Hkv));
- bf16 values, or int8 values with per-(head, token) fp32 scales
  [L, B, Hkv, S] folded into the score and the P·V step (no dequantized
  copy);
- Sq = 1 (the decode step), or Sq = qn <= 32 queries with k_new/v_new
  [B, Hkv, qn, D] as extra columns (the speculative verify chunk and the
  chunked-prefill mixed step): every query sees the valid cache columns and
  query i sees chunk column j iff j <= i;
- a page pool [L, n_pages, Hkv, page, D] read through a page table [B, P]
  (`paged_decode_attention`), with the int8 scales already gathered to the
  logical [L, B, Hkv, P*page] view.

The wrappers are `decode_attention` and `paged_decode_attention`: on a CPU
tensor each runs its plain twin, on a CUDA tensor it launches the kernel or
raises. Each counts its launches (`launches`) and, per form, in `forms`.
The twins follow the TPU kernel's arithmetic: the cache probabilities
(times the v scales) are rounded to the compute dtype before P·V, the extra
columns' probabilities and values stay fp32.

The kernel splits each (batch row, kv head) plane's key axis over blocks;
`decode_plan`, a function of the shape alone, picks the split and the grid
(at most one wave of co-resident blocks). The page pool takes the same
split kernels through the page table, the row kernel at Sq = 1 and the mma
kernel for its chunk forms (so a paged lane matches the dense one bit for
bit); rows that are not whole 16-byte units, and a bf16 pool's chunk forms
over pages that are not a multiple of 8 rows, keep the first designs.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from emu_tpu_torch.ops import _cuda

_NEG_INF = -1e30
MAX_CHUNK = 32       # queries per row the kernel takes with k_new/v_new

# The split designs (csrc/decode_attention.cu): cache positions per chunk of
# the row kernel (Sq = 1, rep <= 8) and of the mma kernel (the chunk form),
# the most chunks one split takes, the row kernel's ring depth by item size.
ROW_CHUNK, MMA_CHUNK = 32, 64
MAX_SPLIT_CHUNKS = 32
ROW_STAGES = {1: 6, 2: 4}
ITEM_COST = 4        # a work item's fixed cost, in chunks (decode_plan)


def _rows_smem(d: int, itemsize: int) -> int:
    """Dynamic shared memory of a row-kernel block (`rows_smem` in the
    source): the ring of K, V and scale chunks (ROW_STAGES deep, by item
    size), the split's valid bytes."""
    return (ROW_STAGES[itemsize] * (2 * ROW_CHUNK * d * itemsize
                                    + 2 * ROW_CHUNK * 4)
            + MAX_SPLIT_CHUNKS * ROW_CHUNK)


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, hkv: int, rep: int, qn: int, s: int, d: int,
                itemsize: int, sms: int = _cuda.H100_SMS,
                aligned: bool = True, page: int = 0) -> dict:
    """How kernel D runs over a cache of B rows, Hkv kv heads of rep query
    heads, qn queries, S positions of width D (itemsize 2: bf16, 1: int8),
    dense (page 0) or a page pool of `page`-row pages read through the
    table (S = P * page): a function of the shape (and of the operands'
    16-byte alignment) alone. A pool takes the dense cache's plan.

    - kernel: "rows" (Sq = 1, rep <= 8: the split row kernel), "mma" (the
      chunk form on the tensor cores), or "first" (rows that are not whole
      16-byte units, int8 scales of an S that is not a multiple of 4,
      unaligned operands, or a bf16 pool's chunk form whose pages are not
      a multiple of 8 rows, the mma kernel's TMA boxes being gcd(page, 64)
      rows on 8-row swizzle atoms: the first designs, one block per
      plane);
    - chunk: cache positions per chunk; splits: how many splits cut each
      plane's key axis, chunks_per_split chunks each (the last may hold
      fewer, none is empty, at most MAX_SPLIT_CHUNKS);
    - items = B * Hkv * splits work items, grid = min(items, blocks_per_sm
      * sms): at most one wave of co-resident blocks, each walking items in
      a fixed stride.

    The split count minimises rounds x (chunks per split + ITEM_COST): the
    rounds of items each block walks, and each item's chunks plus its fixed
    cost in chunks (the list, the ring's fill, the merge: about 5 us on an
    H100 against about 1.3 us a chunk with every block streaming)."""
    rows = qn == 1 and rep <= 8
    if (not aligned or (rows and ((d * itemsize) % 16
                                  or (itemsize == 1 and s % 4)))
            or (page and not rows and itemsize == 2 and page % 8)):
        return {"kernel": "first", "chunk": 0, "splits": 1,
                "chunks_per_split": 0, "items": b * hkv, "grid": b * hkv,
                "blocks_per_sm": 0}
    cs = ROW_CHUNK if rows else MMA_CHUNK
    per_sm = (min(4, _cuda.SMEM_PER_SM // (_rows_smem(d, itemsize) + 1024))
              if rows else 1)
    cap = sms * per_sm
    nch = -(-s // cs)
    pairs = b * hkv
    best = None
    for n in range(-(-nch // MAX_SPLIT_CHUNKS), nch + 1):
        cps = -(-nch // n)
        n = -(-nch // cps)           # no empty split
        items = pairs * n
        cost = -(-items // cap) * (cps + ITEM_COST)
        if best is None or cost < best[0]:
            best = (cost, n, cps)
    _, n, cps = best
    return {"kernel": "rows" if rows else "mma", "chunk": cs, "splits": n,
            "chunks_per_split": cps, "items": pairs * n,
            "grid": min(pairs * n, cap), "blocks_per_sm": per_sm}


_TICKETS: dict = {}


def _tickets(device, n: int):
    """Per-plane tickets of the split merge on one card: int32 zeros the
    kernel leaves at zero after every call (one buffer per card, grown when
    a call needs more planes)."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _group_q(q, hkv: int):
    """[B, qn, H, D] → [B, Hkv, rep * qn, D], queries innermost (row m is
    query m % qn of head g * rep + m // qn)."""
    b, qn, h, d = q.shape
    rep = h // hkv
    return (q.reshape(b, qn, hkv, rep, d).permute(0, 2, 3, 1, 4)
            .reshape(b, hkv, rep * qn, d))


def _ungroup(o, qn: int):
    """Inverse of `_group_q`: [B, Hkv, rep * qn, D] → [B, qn, H, D]."""
    b, hkv, m, d = o.shape
    rep = m // qn
    return (o.reshape(b, hkv, rep, qn, d).permute(0, 3, 1, 2, 4)
            .reshape(b, qn, hkv * rep, d))


def decode_attention_reference(q, k, v, kv_valid, k_scale=None, v_scale=None,
                               *, scale: float, layer: Optional[int] = None,
                               k_new=None, v_new=None):
    """Plain twin of `decode_attention` (the TPU kernel's math in one
    softmax over every column, instead of its online form)."""
    if layer is not None:
        k, v = k[layer], v[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    b, qn, h, d = q.shape
    hkv = k.shape[1]
    cdt = q.dtype
    qg = _group_q(q, hkv).float()                        # [B, G, M, D]
    s = torch.einsum("bgmd,bgsd->bgms", qg, k.to(cdt).float())
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    s = (s * scale).masked_fill(~kv_valid.bool()[:, None, None, :], _NEG_INF)
    mx = s.amax(-1, keepdim=True)
    if k_new is not None:
        sn = torch.einsum("bgmd,bgjd->bgmj", qg, k_new.to(cdt).float()) * scale
        if qn > 1:
            row_q = torch.arange(qg.shape[2], device=q.device)[:, None] % qn
            col = torch.arange(qn, device=q.device)[None, :]
            sn = sn.masked_fill(~(col <= row_q), _NEG_INF)
        mx = torch.maximum(mx, sn.amax(-1, keepdim=True))
    p = torch.exp(s - mx)
    denom = p.sum(-1)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    acc = torch.einsum("bgms,bgsd->bgmd", p.to(cdt).float(), v.to(cdt).float())
    if k_new is not None:
        pn = torch.exp(sn - mx)
        denom = denom + pn.sum(-1)
        acc = acc + torch.einsum("bgmj,bgjd->bgmd", pn, v_new.float())
    out = acc / (denom[..., None] + 1e-30)
    return _ungroup(out.to(q.dtype), qn)


def gather_pages(pool, page_table):
    """[n_pages, Hkv, page, ...] pool planes → the logical per-row view
    [B, Hkv, P * page, ...] through page_table [B, P] (entries >= 0)."""
    g = pool[page_table.long()]                          # [B, P, Hkv, page, ..]
    b, p, hkv, page = g.shape[:4]
    return g.transpose(1, 2).reshape(b, hkv, p * page, *g.shape[4:])


def paged_decode_attention_reference(q, k, v, page_table, kv_valid, *,
                                     scale: float, k_scale=None, v_scale=None,
                                     layer: Optional[int] = None, k_new=None,
                                     v_new=None):
    """Plain twin of `paged_decode_attention`: the dense twin over the
    pages gathered to each row's logical view."""
    if layer is not None:
        k, v = k[layer], v[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    return decode_attention_reference(
        q, gather_pages(k, page_table), gather_pages(v, page_table), kv_valid,
        k_scale, v_scale, scale=scale, k_new=k_new, v_new=v_new)


def kernel_fits(q, k, k_new=None, quant: bool = False) -> bool:
    """Whether kernel D takes this call: the envelope `_launch` enforces,
    for q [B, Sq, H, D] and a cache or page pool k [..., Hkv, S, D] (with
    or without its layer dim). A bf16 q (and k_new), a bf16 cache or an
    int8 one with scales, an even D <= 128; Sq > 1 only with k_new and
    Sq <= MAX_CHUNK; the chunk form (Sq > 1 or rep > 8) needs D in {16,
    32, 64, 128} and rep * Sq <= 64. Anything else takes the plain chain,
    as the JAX package takes XLA when `decode_attention_fits` fails."""
    b, qn, h, d = q.shape
    hkv = k.shape[-3]
    if q.dtype != torch.bfloat16 or k.dtype != (
            torch.int8 if quant else torch.bfloat16):
        return False
    if k_new is not None and k_new.dtype != torch.bfloat16:
        return False
    if hkv == 0 or h % hkv or k.shape[-1] != d or d % 2 or d > 128:
        return False
    if qn > 1 and (k_new is None or qn > MAX_CHUNK):
        return False
    rep = h // hkv
    if qn > 1 or rep > 8:
        return d in (16, 32, 64, 128) and rep * qn <= 64
    return True


def _launch(q, k, v, kv_valid, k_scale, v_scale, scale, layer, k_new, v_new,
            table, name, plans):
    """Checks and the one C entry point for every form; counts the kernel
    the plan gives in `plans`; returns (out, form name)."""
    n_layers = k.shape[0]
    b, qn, h, d = q.shape
    hkv = k.shape[2]
    if table is None:
        s, n_pages, page, n_tab = k.shape[3], 0, k.shape[3], 0
        _cuda.require(k.shape[1] == b, f"{name}: cache batch != q batch")
    else:
        n_pages, page = k.shape[1], k.shape[3]
        n_tab = table.shape[1]
        s = n_tab * page
        _cuda.require(table.shape[0] == b and table.dtype == torch.int32
                      and table.is_contiguous(),
                      f"{name}: page_table must be int32 [B, P], contiguous")
    rep = h // hkv if hkv else 0
    quant = k_scale is not None
    bf = torch.bfloat16
    _cuda.require(hkv > 0 and h % hkv == 0 and v.shape == k.shape
                  and k.shape[-1] == d, f"{name}: bad shapes q{tuple(q.shape)}"
                  f" k{tuple(k.shape)}")
    _cuda.require(qn == 1 or (k_new is not None and qn <= MAX_CHUNK),
                  f"{name}: Sq > 1 needs k_new/v_new and Sq <= {MAX_CHUNK}")
    chunk = qn > 1 or rep > 8
    _cuda.require(d % 2 == 0 and d <= 128
                  and (not chunk or d in (16, 32, 64, 128)),
                  f"{name}: head dim {d} (<= 128; 16, 32, 64 or 128 for the "
                  "chunk form)")
    _cuda.require(not chunk or rep * qn <= 64,
                  f"{name}: rep * Sq = {rep * qn} > 64 query rows per head")
    _cuda.require(0 <= int(layer) < n_layers, f"{name}: layer out of range")
    _cuda.require(q.dtype == bf and q.stride(-1) == 1,
                  f"{name}: q must be bfloat16 with unit last stride")
    _cuda.require(k.dtype == v.dtype == (torch.int8 if quant else bf),
                  f"{name}: the cache must be bfloat16, or int8 with scales")
    _cuda.require(k.is_contiguous() and v.is_contiguous(),
                  f"{name}: the cache must be contiguous")
    _cuda.require(kv_valid.shape == (b, s),
                  f"{name}: kv_valid must be [{b}, {s}]")
    _cuda.require((k_new is None) == (v_new is None)
                  and (k_scale is None) == (v_scale is None),
                  f"{name}: k_new/v_new and k_scale/v_scale come in pairs")
    if quant:
        _cuda.require(k_scale.shape == (n_layers, b, hkv, s)
                      and k_scale.shape == v_scale.shape
                      and k_scale.dtype == v_scale.dtype == torch.float32
                      and k_scale.is_contiguous() and v_scale.is_contiguous(),
                      f"{name}: scales must be fp32 [L, {b}, {hkv}, {s}]")

    def extra(t):
        _cuda.require(t.dtype == bf and t.shape == (b, hkv, qn, d)
                      and t.stride(-1) == 1,
                      f"{name}: k_new/v_new must be bfloat16 [B, Hkv, Sq, D]")
        return t.stride(0), t.stride(1), t.stride(2)

    kn_s = (0, 0, 0) if k_new is None else extra(k_new)
    vn_s = (0, 0, 0) if v_new is None else extra(v_new)
    valid = kv_valid.to(device=q.device, dtype=torch.bool).contiguous()
    out = torch.empty(b, qn, h, d, device=q.device, dtype=bf)
    nsplit, cps, grid, ws_o, ws_ml, cnt = 0, 0, 0, None, None, None
    aligned = all(t.data_ptr() % 16 == 0 for t in (k, v, k_scale, v_scale)
                  if t is not None)
    plan = decode_plan(b, hkv, rep, qn, s, d, k.element_size(),
                       _cuda.sm_count(q.device), aligned,
                       0 if table is None else page)
    kernel = plan["kernel"]
    if kernel != "first":
        nsplit, cps, grid = (plan["splits"], plan["chunks_per_split"],
                             plan["grid"])
        if nsplit > 1:
            rows = b * hkv * nsplit * rep * qn
            ws_o = torch.empty(rows * d, device=q.device)
            ws_ml = torch.empty(rows * 2, device=q.device)
            cnt = _tickets(q.device, b * hkv)
    plans[kernel] += 1
    with _cuda.device_of(q):
        status = _cuda.library().emu_decode_attention_fwd(
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), v.data_ptr(), _cuda.ptr(k_scale), _cuda.ptr(v_scale),
            valid.data_ptr(), _cuda.ptr(k_new), *kn_s, _cuda.ptr(v_new),
            *vn_s, _cuda.ptr(table), n_tab, n_pages, page, out.data_ptr(),
            b, h, hkv, qn, s, d, int(layer), float(scale), int(quant),
            nsplit, cps, grid, _cuda.ptr(ws_o), _cuda.ptr(ws_ml),
            _cuda.ptr(cnt), _cuda.stream(q))
    _cuda.check(status, name)
    form = ("chunk_" if qn > 1 else "") + ("int8" if quant else "bf16")
    return out, form



def decode_attention(q, k, v, kv_valid, k_scale=None, v_scale=None, *,
                     scale: float, layer: Optional[int] = None, k_new=None,
                     v_new=None) -> torch.Tensor:
    """q [B, Sq, H, D] (roped); k/v the cache, [L, B, Hkv, S, D] with
    `layer`, or [B, Hkv, S, D] without; bf16, or int8 with k_scale/v_scale
    [L, B, Hkv, S] ([B, Hkv, S] without `layer`); kv_valid [B, S] (nonzero
    = attend; must exclude the in-flight slots when k_new is given);
    k_new/v_new [B, Hkv, Sq, D] or None (needed for Sq > 1). → [B, Sq, H, D].
    """
    if _cuda.on_cpu(q, "decode_attention"):
        return decode_attention_reference(q, k, v, kv_valid, k_scale, v_scale,
                                          scale=scale, layer=layer,
                                          k_new=k_new, v_new=v_new)
    _cuda.refuse_grad("decode_attention", q, k, v, k_scale, v_scale, k_new,
                      v_new)
    if layer is None:
        k, v, layer = k[None], v[None], 0
        if k_scale is not None:
            k_scale, v_scale = k_scale[None], v_scale[None]
    out, form = _launch(q, k, v, kv_valid, k_scale, v_scale, scale, layer,
                        k_new, v_new, None, "decode_attention",
                        decode_attention.plans)
    decode_attention.launches += 1
    decode_attention.forms[form] += 1
    return out


decode_attention.launches = 0
decode_attention.forms = {"bf16": 0, "int8": 0, "chunk_bf16": 0,
                          "chunk_int8": 0}
# launches on the dense cache by `decode_plan`'s kernel
decode_attention.plans = {"rows": 0, "mma": 0, "first": 0}


def paged_decode_attention(q, k, v, page_table, kv_valid, *, scale: float,
                           k_scale=None, v_scale=None,
                           layer: Optional[int] = None, k_new=None,
                           v_new=None) -> torch.Tensor:
    """`decode_attention` straight out of a head-major page pool: k/v
    [L, n_pages, Hkv, page, D] ([n_pages, ...] without `layer`), page_table
    [B, P] physical page per logical page (unmapped entries clamped to 0 by
    the caller and masked by kv_valid [B, P * page]); int8 scales are the
    logical-view planes [L, B, Hkv, P * page]. → [B, Sq, H, D]."""
    if _cuda.on_cpu(q, "paged_decode_attention"):
        return paged_decode_attention_reference(
            q, k, v, page_table, kv_valid, scale=scale, k_scale=k_scale,
            v_scale=v_scale, layer=layer, k_new=k_new, v_new=v_new)
    _cuda.refuse_grad("paged_decode_attention", q, k, v, k_scale, v_scale,
                      k_new, v_new)
    if layer is None:
        k, v, layer = k[None], v[None], 0
        if k_scale is not None:
            k_scale, v_scale = k_scale[None], v_scale[None]
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    out, form = _launch(q, k, v, kv_valid, k_scale, v_scale, scale, layer,
                        k_new, v_new, table, "paged_decode_attention",
                        paged_decode_attention.plans)
    paged_decode_attention.launches += 1
    paged_decode_attention.forms[form] += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.forms = {"bf16": 0, "int8": 0, "chunk_bf16": 0,
                                "chunk_int8": 0}
# launches on the page pool by `decode_plan`'s kernel (the split kernels
# read through the page table)
paged_decode_attention.plans = {"rows": 0, "mma": 0, "first": 0}
