"""Kernels F and G: W4A8 products over fold-packed int4 weights
(`csrc/q4_matmul.cu`).

F, `matmul_q4`, replaces `emu_tpu/ops/q4_matmul.py:matmul_q4`: y = x @
dequant(W) (+ b) reading only the packed bytes, activations quantized to
int8 per row over all of K, each 128-row scale group of each nibble plane
an exact integer dot scaled into an fp32 sum, the per-row scale and the
bias last. G, `fused_swiglu_q4`, replaces `fused_swiglu_q4`: the decode MLP
x + down(silu(gate(rms(x))) * up(rms(x))) on the fused gate|up layout, with
silu(g) * u re-quantized per row within each block of `bf` hidden columns.

`q4_plan` and `swiglu_q4_plan` are the JAX package's route rules, without
its backend test: the kernel at <= 1024 rows (F) or <= 32 rows (G) with
128-aligned groups; otherwise the caller dequantizes (F) or runs the
unfused MLP (G). On a CPU tensor each wrapper runs its plain twin, whose
integer parts are exact: a 128-row s8 x s4 group dot stays below 2^24, so
fp32 products carry it exactly.
"""

from __future__ import annotations

import functools

import torch

from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops.quant import quantize_activations, unpack_int4


def _group_dots(xq, packed, scale4, act_scale=None, act_block: int = 0):
    """Σ over group pairs t of dl_t * sl_t + dh_t * sh_t in fp32, where
    dl_t / dh_t are the exact integer dots of the low / high nibble plane's
    group t with the matching x columns (k and K/2 + k). With act_scale
    [M, 2, nblk] the activation scale of the group's block multiplies into
    the weight scale first (the down projection of `fused_swiglu_q4`)."""
    m, k = xq.shape
    n = packed.shape[-1]
    groups = scale4.shape[-2]
    gh, gs = groups // 2, k // groups
    lo, hi = unpack_int4(packed)
    xl = xq[:, :k // 2].float().reshape(m, gh, gs).transpose(0, 1)
    xh = xq[:, k // 2:].float().reshape(m, gh, gs).transpose(0, 1)
    s = scale4.float()
    acc = torch.zeros(m, n, device=xq.device)
    chunk = 8
    for t0 in range(0, gh, chunk):
        t1 = min(t0 + chunk, gh)
        dl = torch.bmm(xl[t0:t1], lo[t0 * gs:t1 * gs].float().reshape(
            t1 - t0, gs, n))
        dh = torch.bmm(xh[t0:t1], hi[t0 * gs:t1 * gs].float().reshape(
            t1 - t0, gs, n))
        for i, t in enumerate(range(t0, t1)):
            sl, sh = s[t], s[gh + t]
            if act_scale is not None:
                b = t * gs // act_block
                sl = act_scale[:, 0, b:b + 1] * sl
                sh = act_scale[:, 1, b:b + 1] * sh
            acc = acc + (dl[i] * sl + dh[i] * sh)
    return acc


def matmul_q4_reference(x, packed, scale4, bias=None):
    """Plain twin of `matmul_q4`."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, sx = quantize_activations(x.reshape(-1, k))
    y = _group_dots(xq, packed, scale4) * sx
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*lead, packed.shape[-1])


def matmul_q4(x, packed, scale4, bias=None) -> torch.Tensor:
    """y = x @ dequant(packed, scale4) (+ bias): x [..., K]; packed
    [K/2, N] int8 (fold packing); scale4 [G, N] fp32 with K/G a multiple
    of 128. Returns x's dtype."""
    if _cuda.on_cpu(x, "matmul_q4"):
        return matmul_q4_reference(x, packed, scale4, bias)
    _cuda.refuse_grad("matmul_q4", x, scale4, bias)
    lead, k = x.shape[:-1], x.shape[-1]
    n, groups = packed.shape[-1], scale4.shape[-2]
    _cuda.require(x.dtype == torch.bfloat16 and packed.dtype == torch.int8,
                  "matmul_q4: x must be bfloat16, packed int8")
    _cuda.require(packed.shape == (k // 2, n) and scale4.shape == (groups, n),
                  f"matmul_q4: bad shapes x{tuple(x.shape)} "
                  f"packed{tuple(packed.shape)} scale4{tuple(scale4.shape)}")
    _cuda.require(groups % 2 == 0 and k % groups == 0
                  and (k // groups) % 128 == 0,
                  f"matmul_q4: group size must be a multiple of 128 with an "
                  f"even group count (K {k}, groups {groups})")
    xf = x.reshape(-1, k).contiguous()
    m = xf.shape[0]
    packed, scale4 = packed.contiguous(), scale4.float().contiguous()
    bias = None if bias is None else bias.to(torch.bfloat16).contiguous()
    xq = torch.empty(m, k, device=x.device, dtype=torch.int8)
    sx = torch.empty(m, device=x.device)
    out = torch.empty(m, n, device=x.device, dtype=torch.bfloat16)
    with _cuda.device_of(x):
        lib = _cuda.library()
        ws = _split_workspace(lib, x.device, (m, n, k, k // groups))
        status = lib.emu_matmul_q4_fwd(
            xf.data_ptr(), packed.data_ptr(), scale4.data_ptr(),
            _cuda.ptr(bias), xq.data_ptr(), sx.data_ptr(), _cuda.ptr(ws),
            out.data_ptr(), m, n, k, k // groups, _cuda.stream(x))
    _cuda.check(status, "matmul_q4")
    matmul_q4.launches += 1
    return out.reshape(*lead, n)


matmul_q4.launches = 0


def _split_workspace(lib, device, *products):
    """The fp32 scratch for the K splits the kernel takes at decode rows
    (`emu_w4a8_splits`): room for the largest [splits, M, N] of the given
    (M, N, K, group size) products, or None when none splits."""
    size = 0
    for m, n, k, gs in products:
        splits = lib.emu_w4a8_splits(m, n, k, gs)
        if splits > 1:
            size = max(size, splits * m * n)
    return torch.empty(size, device=device) if size else None


def _takes_dtype(x) -> bool:
    """Kernels F and G take bf16 activations only: on the card, fp32 ones
    dequantize (as they take the plain routes of kernels A-E). The plain
    twins, which CPU tensors run, compute any dtype as the TPU kernels do,
    so on the CPU the plans keep the JAX package's rules, which the CPU
    tests hold them to."""
    return x.device.type == "cpu" or x.dtype == torch.bfloat16


def q4_plan(params: dict, x) -> bool:
    """Whether `dense` takes kernel F: activations it takes
    (`_takes_dtype`), a 2-D packed kernel, groups of a multiple of 128
    rows, an even group count, and at most 1024 rows (above that the JAX
    package dequantizes and runs a plain matmul)."""
    packed = params["kernel_q4"]
    if packed.dim() != 2 or not _takes_dtype(x):
        return False
    k = x.shape[-1]
    groups = params["scale4"].shape[-2]
    if groups == 0 or groups % 2 or k % groups or (k // groups) % 128:
        return False
    return x.numel() // k <= 1024


def snap_bf(bf: int, f: int, gs_f: int) -> int:
    """The hidden block of `fused_swiglu_q4`: `bf` snapped down to the
    group grid, then shrunk until it divides F/2 (F = 17920: 384 → 256)."""
    bf = gs_f * max(1, bf // gs_f)
    while (f // 2) % bf:
        bf -= gs_f
        if bf < gs_f:
            raise ValueError(f"no hidden block: F/2 = {f // 2} is not "
                             f"tileable by multiples of {gs_f}")
    return bf


def fused_swiglu_q4_reference(x, rms_scale, gu_packed, gu_scale, dn_packed,
                              dn_scale, *, eps: float = 1e-6,
                              residual: bool = True, bf: int = 384):
    """Plain twin of `fused_swiglu_q4`, in the TPU kernel's order."""
    lead, d = x.shape[:-1], x.shape[-1]
    f = gu_packed.shape[-1] // 2
    bf = snap_bf(bf, f, f // dn_scale.shape[-2])
    xf = x.reshape(-1, d).float()
    rs = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xn = (xf * rs).to(x.dtype).float() * rms_scale.float()
    xq, sx = quantize_activations(xn)
    gu = _group_dots(xq, gu_packed, gu_scale) * sx
    g, u = gu[:, :f], gu[:, f:]
    h = (g / (1.0 + torch.exp(-g))) * u
    m, nf = h.shape[0], f // 2 // bf
    hq, hs = quantize_activations(h.reshape(m, 2, nf, bf))
    y = _group_dots(hq.reshape(m, f), dn_packed, dn_scale,
                    act_scale=hs[..., 0], act_block=bf)
    if residual:
        y = y + xf
    return y.to(x.dtype).reshape(*lead, d)


# G's decode plan (csrc/w4a8_decode.cuh): weight steps in flight per thread,
# threads of a gate|up and of a down block, down's columns per block.
WD_STAGES = 4
WD_GU_THREADS, WD_DN_THREADS, WD_DN_COLS = 256, 128, 256


def _wd_smem(nt: int, threads: int, kmax: int, cols: int) -> int:
    """Dynamic shared memory of a decode-plan block (`wd_smem`)."""
    return (2 * 8 * nt * (kmax + 16) + WD_STAGES * (threads // 32) * 2048
            + 8 * nt * cols * 4 + 128)


def k_splits(kp: int, gs: int, ks: int) -> list:
    """The packed-row ranges [r0, r1) of ks K splits of kp packed rows in
    whole scale-group pairs of gs rows (the kernel's rank formula)."""
    pairs = kp // gs
    return [(r * pairs // ks * gs, (r + 1) * pairs // ks * gs)
            for r in range(ks)]


@functools.lru_cache(maxsize=64)
def decode_plan(m: int, d: int, f: int, gs_d: int, gs_f: int, bf: int,
                sms: int = _cuda.H100_SMS) -> dict:
    """Kernel G's decode plan at m rows (<= 32), a function of the shape:
    for each product, the K splits (a thread-block cluster of ks = 1, 2, 4
    or 8 blocks, in whole scale-group pairs) and the blocks.

    - gate_up: one cluster per hidden block of bf units (F / bf of them),
      owning the block's gate and up columns, 256 threads a block;
    - down: one cluster per 256 output columns (D / 256), 128 threads.

    Each takes the largest ks whose blocks all fit in one wave of
    co-resident blocks (registers and shared memory per SM), so no block
    waits for a second wave; when no ks fits one wave, the smallest that
    fits a block's shared memory. Returns per product: ks, kmax (packed
    rows of the longest split), splits ([r0, r1) packed-row ranges),
    blocks, blocks_per_sm, smem (dynamic bytes a block); and nt (n8
    tiles of activation rows) and hidden_blocks ([(plane, j0, j1)] hidden
    units per gate|up cluster)."""
    nt = 1 if m <= 8 else 2 if m <= 16 else 4
    plan = {"nt": nt, "hidden_blocks": [
        (j0 // (f // 2), j0, j0 + bf) for j0 in range(0, f, bf)]}
    for name, kp, gs, tiles, threads, cols, regs in (
            ("gate_up", d // 2, gs_d, f // bf, WD_GU_THREADS, 2 * bf,
             2 if nt == 1 else 1),
            ("down", f // 2, gs_f, d // WD_DN_COLS, WD_DN_THREADS,
             WD_DN_COLS, 3 if nt == 1 else 1)):
        pairs = kp // gs
        best = None
        for ks in (1, 2, 4, 8):
            if ks > pairs:
                break
            kmax = -(-pairs // ks) * gs
            smem = _wd_smem(nt, threads, kmax, cols)
            if smem > _cuda.SMEM_PER_BLOCK:
                continue
            per_sm = min(regs, _cuda.SMEM_PER_SM // (smem + 1024))
            one_wave = tiles * ks <= sms * per_sm
            if best is None or one_wave:
                best = (ks, kmax, per_sm, smem)
            if not one_wave:
                break
        if best is None:
            raise ValueError(f"fused_swiglu_q4: no decode plan for {name} "
                             f"(K/2 {kp}, groups of {gs}, {m} rows)")
        ks, kmax, per_sm, smem = best
        plan[name] = {"ks": ks, "kmax": kmax, "splits": k_splits(kp, gs, ks),
                      "blocks": tiles * ks, "blocks_per_sm": per_sm,
                      "smem": smem}
    return plan


def fused_swiglu_q4(x, rms_scale, gu_packed, gu_scale, dn_packed, dn_scale,
                    *, eps: float = 1e-6, residual: bool = True,
                    bf: int = 384) -> torch.Tensor:
    """x + down(silu(gate(rms(x))) * up(rms(x))) over int4 weights: x
    [..., D] (at most 32 rows); gu_packed [D/2, 2F] (gate|up, fold
    packing); gu_scale [G_D, 2F]; dn_packed [F/2, D]; dn_scale [G_F, D]."""
    if _cuda.on_cpu(x, "fused_swiglu_q4"):
        return fused_swiglu_q4_reference(
            x, rms_scale, gu_packed, gu_scale, dn_packed, dn_scale, eps=eps,
            residual=residual, bf=bf)
    _cuda.refuse_grad("fused_swiglu_q4", x, rms_scale, gu_scale, dn_scale)
    lead, d = x.shape[:-1], x.shape[-1]
    f = gu_packed.shape[-1] // 2
    gdt, gft = gu_scale.shape[-2], dn_scale.shape[-2]
    gs_d, gs_f = d // gdt, f // gft
    _cuda.require(x.dtype == torch.bfloat16
                  and gu_packed.dtype == dn_packed.dtype == torch.int8,
                  "fused_swiglu_q4: x must be bfloat16, weights int8")
    _cuda.require(gu_packed.shape == (d // 2, 2 * f)
                  and dn_packed.shape == (f // 2, d),
                  f"fused_swiglu_q4: bad shapes gu{tuple(gu_packed.shape)} "
                  f"dn{tuple(dn_packed.shape)} for D {d}")
    _cuda.require(gs_d % 128 == 0 and gs_f % 128 == 0 and gdt % 2 == 0
                  and gft % 2 == 0 and (f // 2) % 128 == 0,
                  f"fused_swiglu_q4: groups must be multiples of 128 rows "
                  f"(got {gs_d}, {gs_f})")
    bf = snap_bf(bf, f, gs_f)
    xf = x.reshape(-1, d).contiguous()
    m = xf.shape[0]
    _cuda.require(m <= 32, f"fused_swiglu_q4: at most 32 rows (got {m})")
    _cuda.require(bf <= 1024 and d <= 16384, f"fused_swiglu_q4: hidden "
                  f"block {bf} > 1024 or D {d} > 16384")
    dev = x.device
    plan = decode_plan(m, d, f, gs_d, gs_f, bf, _cuda.sm_count(dev))
    rms = rms_scale.to(torch.bfloat16).contiguous()
    # the row kernel reads x and the norm weight 16 bytes at a time
    if xf.data_ptr() % 16:
        xf = xf.clone()
    if rms.data_ptr() % 16:
        rms = rms.clone()
    gu_packed, dn_packed = gu_packed.contiguous(), dn_packed.contiguous()
    gu_scale = gu_scale.float().contiguous()
    dn_scale = dn_scale.float().contiguous()
    xq = torch.empty(m, d, device=dev, dtype=torch.int8)
    sx = torch.empty(m, device=dev)
    hq = torch.empty(m, f, device=dev, dtype=torch.int8)
    hs = torch.empty(m, f // bf, device=dev)
    out = torch.empty(m, d, device=dev, dtype=torch.bfloat16)
    gp, dp = plan["gate_up"], plan["down"]
    with _cuda.device_of(x):
        status = _cuda.library().emu_fused_swiglu_q4_fwd(
            xf.data_ptr(), rms.data_ptr(), gu_packed.data_ptr(),
            gu_scale.data_ptr(), dn_packed.data_ptr(), dn_scale.data_ptr(),
            xq.data_ptr(), sx.data_ptr(), hq.data_ptr(), hs.data_ptr(),
            out.data_ptr(), m, d, f, gs_d, gs_f, bf, float(eps),
            int(residual), gp["ks"], gp["kmax"], dp["ks"], dp["kmax"],
            _cuda.stream(x))
    _cuda.check(status, "fused_swiglu_q4")
    fused_swiglu_q4.launches += 1
    return out.reshape(*lead, d)


fused_swiglu_q4.launches = 0


def swiglu_q4_plan(norm_scale, mlp_params: dict, x) -> bool:
    """Whether the decoder layer takes kernel G: activations it takes
    (`_takes_dtype`), int4 fused gate_up and down, 2-D, 128-aligned
    groups, F/2 a multiple of 128, <= 32 rows."""
    if ("gate_up" not in mlp_params or "down" not in mlp_params
            or not _takes_dtype(x)):
        return False
    gu, dn = mlp_params["gate_up"], mlp_params["down"]
    if "kernel_q4" not in gu or "kernel_q4" not in dn:
        return False
    if gu["kernel_q4"].dim() != 2 or norm_scale is None:
        return False
    d = x.shape[-1]
    f = gu["kernel_q4"].shape[-1] // 2
    gdt, gft = gu["scale4"].shape[-2], dn["scale4"].shape[-2]
    if gdt % 2 or gft % 2 or d % gdt or f % gft:
        return False
    if (d // gdt) % 128 or (f // gft) % 128 or (f // 2) % 128:
        return False
    return x.numel() // d <= 32
