"""Kernel A and its backward: tiled attention over head-major [B, H, S, D]
tensors, differentiable.

The forward kernel (`csrc/attention.cu`) takes the place of three TPU kernels
of `emu_tpu/ops/flash_attention.py`:

- `mha_bhsd`: the ViT's unmasked self-attention with per-head q/v
  projection biases folded in; here the ragged sequence edge (ViT-g's 257
  tokens) is masked inside the kernel instead of being padded by the
  caller;
- `flash_attention`'s `_flash_short` tier: end-aligned causal mask plus a
  [B, Skv] `kv_valid` padding mask, the LLaMA prefill contract, with the
  per-row log-sum-exp the backward needs (`with_lse`);
- its `_flash_streaming` tier (Skv > 4096): the kernel streams K/V in
  64-column tiles with an online softmax at every length and skips the
  causal tiles right of the diagonal.

The backward kernels (`csrc/attention_bwd.cu`, dQ and dK/dV, TMA + wgmma)
take the place of `_flash_bwd_whole` and `_flash_bwd_tiled`, the
recompute-based backward of `_flash_diff`.

`batched_mha` (`csrc/batched_mha.cu`) replaces the TPU's `batched_mha`,
the unmasked token-major attention of the UNets' latent self-attention,
and `mha_packed_qkv` the TPU's `mha_packed_qkv`: the same kernel reading
q, k and v as strided planes of the fused [B, S, 3·H·D] projection.

`attention` is the differentiable entry point: a `torch.autograd.Function`
whose forward is the custom op `emu_tpu_torch::attention_fwd` (so that
selective checkpointing can keep its output, `llama.forward_hidden`'s
"named" remat) and whose backward is `attention_bwd`. On CPU tensors every
wrapper runs its plain twin (`attention_reference`, `attention_bwd_
reference`) and counts no launch; on CUDA tensors it launches its kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops.attention_reference import grouped_attention

A_MAX_D = 128       # kernel A's widest head (its shared-memory plan)


def attention_reference(q, k, v, q_bias=None, v_bias=None, *, kv_valid=None,
                        scale: float, causal: bool = False,
                        with_lse: bool = False):
    """Plain twin of kernel A. q [B, H, Sq, D]; k/v [B, Hkv, Skv, D] (H a
    multiple of Hkv: query head h reads kv head h // (H/Hkv)); q_bias
    [H, D], v_bias [Hkv, D]; kv_valid [B, Skv] (nonzero = attend). With
    with_lse, also the per-row log-sum-exp of the masked logits (fp32,
    [B, H, Sq])."""
    if q_bias is not None:
        q = q + q_bias.to(q.dtype)[None, :, None, :]
    if v_bias is not None:
        v = v + v_bias.to(v.dtype)[None, :, None, :]
    out = grouped_attention(q.transpose(1, 2), k, v, scale=scale,
                            kv_valid=kv_valid, causal=causal,
                            kv_layout="bgkd", return_lse=with_lse)
    if with_lse:
        out, lse = out
        return out.transpose(1, 2), lse
    return out.transpose(1, 2)


def _check_bhsd(wrapper, *tensors, maps: bool = False):
    """bf16 views on one device with a contiguous last dim and 16-byte
    aligned strides and base; with `maps` (kernel A's tensor maps) no
    broadcast (stride-0) dim of extent > 1. Messages are built only on
    failure: this runs on every call."""
    dev = tensors[0][1].device
    for tname, t in tensors:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{wrapper}: {tname} must be bfloat16")
        st = t.stride()
        if not (t.device == dev and st[-1] == 1
                and all(s % 8 == 0 for s in st[:3])
                and t.data_ptr() % 16 == 0):
            raise ValueError(
                f"{wrapper}: {tname} {tuple(t.shape)} strides {st} needs a "
                "contiguous last dim and 16-byte aligned strides and base")
        if maps and any(s == 0 and n > 1 for n, s in zip(t.shape, st[:3])):
            raise ValueError(
                f"{wrapper}: {tname} {tuple(t.shape)} strides {st} "
                "broadcasts a dim (stride 0), which the kernel's tensor maps "
                "cannot step: pass .contiguous()")


def _attention_fwd(q, k, v, q_bias, v_bias, kv_valid, scale: float,
                   causal: bool, with_lse: bool):
    """Kernel A (or its twin on CPU tensors) → (out [B, H, Sq, D], lse
    [B, H, Sq] fp32, or an empty tensor without with_lse)."""
    if _cuda.on_cpu(q, "attention"):
        out = attention_reference(q, k, v, q_bias, v_bias, kv_valid=kv_valid,
                                  scale=scale, causal=causal,
                                  with_lse=with_lse)
        return out if with_lse else (out, q.new_empty(0, dtype=torch.float32))
    _cuda.refuse_grad("attention", q, k, v, q_bias, v_bias)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if not (k.shape == v.shape == (b, hkv, skv, d) and h % hkv == 0):
        raise ValueError(f"attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (d % 8 == 0 and d <= A_MAX_D and sq >= 1 and skv >= 1):
        raise ValueError(f"attention: head dim {d} must be a multiple of 8,"
                         f" <= {A_MAX_D}")
    _check_bhsd("attention", ("q", q), ("k", k), ("v", v), maps=True)
    if q_bias is not None:
        q_bias = q_bias.to(torch.bfloat16).reshape(h, d).contiguous()
    if v_bias is not None:
        v_bias = v_bias.to(torch.bfloat16).reshape(hkv, d).contiguous()
    if kv_valid is not None:
        if kv_valid.shape != (b, skv):
            raise ValueError(f"attention: kv_valid must be [{b}, {skv}]")
        kv_valid = kv_valid.to(device=q.device, dtype=torch.bool).contiguous()
    out = torch.empty(b, sq, h, d, device=q.device, dtype=q.dtype
                      ).transpose(1, 2)
    lse = torch.empty(b, h, sq if with_lse else 0, device=q.device,
                      dtype=torch.float32)
    with _cuda.device_of(q):
        status = _cuda.library().emu_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _cuda.ptr(q_bias),
            _cuda.ptr(v_bias), _cuda.ptr(kv_valid), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], b, h, hkv, sq, skv, d, float(scale),
            int(causal), _cuda.stream(q))
    _cuda.check(status, "attention")
    attention.launches += 1
    attention.forms["lse" if with_lse else "plain"] += 1
    return out, lse


# Kernel A as an operator the dispatcher sees, so that a selective
# checkpoint policy can name it (llama.forward_hidden's "named" remat keeps
# its output and lse instead of launching it again in the backward).
_attention_op = torch.library.custom_op(
    "emu_tpu_torch::attention_fwd", _attention_fwd, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? q_bias, Tensor? v_bias, "
           "Tensor? kv_valid, float scale, bool causal, bool with_lse) -> "
           "(Tensor, Tensor)")


def _bwd_reference(q, k, v, lse, do, d_row, kv_valid, scale, causal):
    """The backward's steps in fp32, D = rowsum(dO o O) given as d_row
    [B, H, Sq] → (dq, dk, dv) in the inputs' dtype."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = h // hkv
    dt = q.dtype

    def grouped(t):                    # [B, H, S, ...] → [B, Hkv, rep, S, ...]
        return t.float().reshape(b, hkv, rep, *t.shape[2:])

    qf, dof = grouped(q), grouped(do)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = qf @ kf.transpose(-1, -2) * scale        # [B, Hkv, rep, Sq, Skv]
    keep = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(skv, device=q.device)[None, :]
        keep = kj <= qi + (skv - sq)
    keep = keep[None, None, None]
    if kv_valid is not None:
        keep = keep & kv_valid.bool()[:, None, None, None, :]
    p = torch.where(keep, torch.exp(s - grouped(lse[..., None])), 0.0)
    dv = (p.to(dt).float().transpose(-1, -2) @ dof).sum(2)
    dp = dof @ vf.transpose(-1, -2)
    ds = (p * (dp - grouped(d_row[..., None]))).to(dt).float()
    dq = ds @ kf * scale
    dk = (ds.transpose(-1, -2) @ qf).sum(2) * scale
    return dq.reshape(b, h, sq, d).to(dt), dk.to(dt), dv.to(dt)


def _rowsum_do_o(o, do):
    return (do.float() * o.float()).sum(-1)


def attention_bwd_reference(q, k, v, o, lse, do, kv_valid=None, *,
                            scale: float, causal: bool = False):
    """Plain twin of the backward kernels, step by step as the TPU kernels
    compute it (`flash_attention.py:634-647`), in fp32: D = rowsum(dO o O),
    P = exp(S - lse) on the kept columns, dV = P^T dO, dS = P o (dO V^T -
    D), dQ = dS K * scale, dK = dS^T Q * scale; P and dS round to the input
    dtype before their products, as the TPU kernels round them. q/o/do
    [B, H, Sq, D], k/v [B, Hkv, Skv, D] (dK/dV sum the rep query heads of a
    kv head), lse [B, H, Sq]. → (dq, dk, dv) in the inputs' dtype."""
    return _bwd_reference(q, k, v, lse, do, _rowsum_do_o(o, do), kv_valid,
                          scale, causal)


def _bwd_check(name, q, k, v, o, lse, do, dvec, kv_valid):
    """The backward kernels' envelope: q/o/do [B, H, Sq, D] and k/v
    [B, Hkv, Skv, D] bf16 views (H a multiple of Hkv) with a contiguous
    last dim, 16-byte aligned strides and bases, and no broadcast dim in
    the tensor-mapped q, k, v, do; D % 8 == 0 and D <= A_MAX_D; lse and
    dvec fp32 [B, H, Sq]; kv_valid [B, Skv]. Raises ValueError, else
    returns kv_valid as the kernels read it (bool, contiguous, on q's
    card). o is None for the dK/dV kernel."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _cuda.require(k.shape == v.shape == (b, hkv, skv, d) and h % hkv == 0
                  and do.shape == q.shape and lse.shape == (b, h, sq)
                  and lse.dtype == dvec.dtype == torch.float32
                  and dvec.shape == (b, h, sq)
                  and (o is None or o.shape == q.shape),
                  f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                  f"do{tuple(do.shape)} lse{tuple(lse.shape)}")
    _cuda.require(d % 8 == 0 and d <= A_MAX_D,
                  f"{name}: head dim {d} must be a multiple of 8, <= "
                  f"{A_MAX_D}")
    _check_bhsd(name, ("q", q), ("k", k), ("v", v), ("do", do), maps=True)
    if o is not None:
        _check_bhsd(name, ("o", o))
    if kv_valid is not None:
        _cuda.require(kv_valid.shape == (b, skv),
                      f"{name}: kv_valid must be [{b}, {skv}]")
        kv_valid = kv_valid.to(device=q.device, dtype=torch.bool).contiguous()
    return kv_valid


def _bwd_launch(entry, name, q, k, v, o, lse, do, dvec, kv_valid, dq, dk,
                dv, scale, causal):
    """Checks shared by the two backward kernels, then one launch; the
    tensors a kernel does not take are None."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _cuda.refuse_grad(name, q, k, v, o, do)
    kv_valid = _bwd_check(name, q, k, v, o, lse, do, dvec, kv_valid)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv)
        for s in (t.stride()[:3] if t is not None else (0, 0, 0))))
    with _cuda.device_of(q):
        status = getattr(_cuda.library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _cuda.ptr(o),
            do.data_ptr(), lse.contiguous().data_ptr(), dvec.data_ptr(),
            _cuda.ptr(kv_valid), _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv),
            ctypes.addressof(strides), b, h, hkv, sq, skv, d, float(scale),
            int(causal), _cuda.stream(q))
    _cuda.check(status, name)


def _bwd_do(do):
    """The cotangent as the kernels read it: unit last stride, 16-byte
    aligned rows and no broadcast dim (what a tensor map can step); any
    other view is copied."""
    st = do.stride()
    if (st[-1] == 1 and all(s % 8 == 0 for s in st[:3])
            and do.data_ptr() % 16 == 0
            and not any(s == 0 and n > 1 for n, s in zip(do.shape, st[:3]))):
        return do
    return do.contiguous()


def attention_bwd_dq(q, k, v, o, lse, do, kv_valid=None, *, scale: float,
                     causal: bool = False):
    """The dQ kernel → (dq [B, H, Sq, D] as a view of [B, Sq, H, D] memory,
    D = rowsum(dO o O) fp32 [B, H, Sq], which `attention_bwd_dkv` reads)."""
    if _cuda.on_cpu(q, "attention_bwd_dq"):
        d_row = _rowsum_do_o(o, do)
        return (_bwd_reference(q, k, v, lse, do, d_row, kv_valid, scale,
                               causal)[0], d_row)
    b, h, sq, d = q.shape
    do = _bwd_do(do)
    dvec = torch.empty(b, h, sq, device=q.device, dtype=torch.float32)
    dq = torch.empty(b, sq, h, d, device=q.device, dtype=q.dtype
                     ).transpose(1, 2)
    _bwd_launch("emu_attention_bwd_dq", "attention_bwd_dq", q, k, v, o, lse,
                do, dvec, kv_valid, dq, None, None, scale, causal)
    attention_bwd_dq.launches += 1
    return dq, dvec


attention_bwd_dq.launches = 0


def attention_bwd_dkv(q, k, v, lse, do, d_row, kv_valid=None, *,
                      scale: float, causal: bool = False):
    """The dK/dV kernel, given D from `attention_bwd_dq` → (dk, dv)
    [B, Hkv, Skv, D] as views of [B, Skv, Hkv, D] memory; each kv head sums
    its rep query heads in the block, so the result is the same bits on
    every run."""
    if _cuda.on_cpu(q, "attention_bwd_dkv"):
        return _bwd_reference(q, k, v, lse, do, d_row, kv_valid, scale,
                              causal)[1:]
    b, hkv, skv, d = k.shape
    do = _bwd_do(do)
    dk = torch.empty(b, skv, hkv, d, device=q.device, dtype=q.dtype
                     ).transpose(1, 2)
    dv = torch.empty_like(dk)
    _bwd_launch("emu_attention_bwd_dkv", "attention_bwd_dkv", q, k, v, None,
                lse, do, d_row, kv_valid, None, dk, dv, scale, causal)
    attention_bwd_dkv.launches += 1
    return dk, dv


attention_bwd_dkv.launches = 0


def attention_bwd(q, k, v, o, lse, do, kv_valid=None, *, scale: float,
                  causal: bool = False):
    """(dq, dk, dv) of `attention` from its inputs, output and lse and the
    output's cotangent `do` (the shapes of `attention_bwd_reference`): the
    dQ kernel, then the dK/dV kernel on the same stream."""
    if _cuda.on_cpu(q, "attention_bwd"):
        return attention_bwd_reference(q, k, v, o, lse, do, kv_valid,
                                       scale=scale, causal=causal)
    dq, d_row = attention_bwd_dq(q, k, v, o, lse, do, kv_valid, scale=scale,
                                 causal=causal)
    dk, dv = attention_bwd_dkv(q, k, v, lse, do, d_row, kv_valid,
                               scale=scale, causal=causal)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Kernel A forward, the dQ and dK/dV kernels backward. The q/v biases
    (the ViT form) enter the backward as q + q_bias and v + v_bias, and
    their gradients are the sums of dq and dv over batch and sequence."""

    @staticmethod
    def forward(ctx, q, k, v, q_bias, v_bias, kv_valid, scale, causal,
                with_lse):
        out, lse = _attention_op(q, k, v, q_bias, v_bias, kv_valid, scale,
                                 causal, with_lse)
        if with_lse:
            ctx.save_for_backward(q, k, v, q_bias, v_bias, kv_valid, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_bias, v_bias, kv_valid, out, lse = ctx.saved_tensors
        if q_bias is not None:
            q = q + q_bias.to(q.dtype)[None, :, None, :]
        if v_bias is not None:
            v = v + v_bias.to(v.dtype)[None, :, None, :]
        dq, dk, dv = attention_bwd(q, k, v, out, lse, dout, kv_valid,
                                   scale=ctx.scale, causal=ctx.causal)
        dqb = None if q_bias is None else dq.float().sum((0, 2)).to(
            q_bias.dtype)
        dvb = None if v_bias is None else dv.float().sum((0, 2)).to(
            v_bias.dtype)
        return dq, dk, dv, dqb, dvb, None, None, None, None


def attention(q, k, v, q_bias=None, v_bias=None, *,
              kv_valid: Optional[torch.Tensor] = None, scale: float,
              causal: bool = False) -> torch.Tensor:
    """softmax(scale * (q + q_bias) kᵀ, masked) (v + v_bias) → [B, H, Sq, D].

    q [B, H, Sq, D], k/v [B, Hkv, Skv, D]: any strides with a contiguous
    last dim (views of a [B, S, 3, H, D] projection are read in place); on
    CUDA, 16-byte multiples and no broadcast (stride-0) dim.
    The causal mask is aligned to the end of the keys (query i sees key j
    iff j <= i + Skv - Sq). On CUDA the output's memory is [B, Sq, H, D],
    returned as its [B, H, Sq, D] view. Differentiable in q, k, v and the
    biases; the lse is computed only when autograd will need it."""
    _cuda.on_cpu(q, "attention")          # raises on other devices
    h, d, hkv = q.shape[1], q.shape[3], k.shape[1]
    if q_bias is not None:
        q_bias = q_bias.reshape(h, d)
    if v_bias is not None:
        v_bias = v_bias.reshape(hkv, d)
    need = _cuda.records(q, k, v, q_bias, v_bias)
    return _Attention.apply(q, k, v, q_bias, v_bias, kv_valid, float(scale),
                            bool(causal), need)


attention.launches = 0
attention.forms = {"plain": 0, "lse": 0}


def mha_bhsd(q, k, v, q_bias=None, v_bias=None, *, scale: float = 1.0):
    """Unmasked self-attention on head-major [B, H, S, D] inputs with
    per-head [H, D] q/v biases (the ViT form). Unlike the TPU kernel, S
    is the real length: no padding, no `s_real`."""
    return attention(q, k, v, q_bias, v_bias, scale=scale)


MHA_MAX_D = 256


def batched_mha_reference(q, k, v, *, scale: float = 1.0):
    """Plain twin of `batched_mha`, step by step as the TPU kernel
    (`emu_tpu/ops/flash_attention.py:_mha_kernel`): fp32 logits times
    scale, p = exp(s - max) in fp32, p rounded to v's dtype before P·V,
    the fp32 sum divided by the fp32 sum of p. q/k/v [B, S, H, D] →
    [B, S, H, D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (o / p.sum(-1).transpose(1, 2)[..., None]).to(q.dtype)


def _batched_mha_launch(name, q, k, v, scale):
    """Checks and one launch of the `csrc/batched_mha.cu` kernel on CUDA
    q/k/v [B, S, H, D] views → a new [B, S, H, D] tensor. Messages are
    built only on failure: this runs on every call."""
    _cuda.refuse_grad(name, q, k, v)
    b, s, h, d = q.shape
    if not k.shape == v.shape == q.shape:
        raise ValueError(f"{name}: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} must match")
    if not (d % 8 == 0 and d <= MHA_MAX_D):
        raise ValueError(f"{name}: head dim {d} must be a multiple of 8, <= "
                         f"{MHA_MAX_D}")
    _check_bhsd(name, ("q", q), ("k", k), ("v", v), maps=True)
    out = torch.empty(b, s, h, d, device=q.device, dtype=q.dtype)
    with _cuda.device_of(q):
        status = _cuda.library().emu_batched_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], b, s, h, d, float(scale), _cuda.stream(q))
    _cuda.check(status, name)
    return out


def batched_mha(q, k, v, *, scale: float = 1.0):
    """Unmasked self-attention over token-major q/k/v [B, S, H, D] →
    [B, S, H, D] (`emu_tpu.ops.flash_attention.batched_mha`): the CUDA
    kernel of `csrc/batched_mha.cu` on CUDA tensors (bf16, D a multiple of
    8 up to 256, strides that are 16-byte multiples with a contiguous last
    dim and no broadcast (stride-0) dim, which its tensor maps cannot step;
    S is the real length, the kernel masks the ragged edge), the plain twin
    on CPU tensors. Inference only, as the TPU kernel: no backward."""
    if _cuda.on_cpu(q, "batched_mha"):
        return batched_mha_reference(q, k, v, scale=scale)
    out = _batched_mha_launch("batched_mha", q, k, v, scale)
    batched_mha.launches += 1
    return out


batched_mha.launches = 0


def _packed_views(qkv, num_heads: int, head_dim: int):
    b, s, three_hd = qkv.shape
    if three_hd != 3 * num_heads * head_dim:
        raise ValueError(f"mha_packed_qkv: qkv {tuple(qkv.shape)} is not "
                         f"[B, S, 3 * {num_heads} * {head_dim}]")
    return qkv.view(b, s, 3, num_heads, head_dim).unbind(2)


def mha_packed_qkv_reference(qkv, num_heads: int, head_dim: int, *,
                             scale: float = 1.0):
    """Plain twin of `mha_packed_qkv`, in the TPU kernel's order
    (`_packed_kernel`): fp32 logits times scale, p = exp(s - max) in fp32,
    p rounded to v's dtype before P·V, the fp32 sum divided by the fp32
    sum of p; the arithmetic of `batched_mha_reference` on the q, k and v
    planes of the packed projection."""
    b, s = qkv.shape[:2]
    q, k, v = _packed_views(qkv, num_heads, head_dim)
    return batched_mha_reference(q, k, v, scale=scale).reshape(
        b, s, num_heads * head_dim)


def mha_packed_qkv(qkv, num_heads: int, head_dim: int, *,
                   scale: float = 1.0):
    """Unmasked self-attention read straight from the fused qkv projection
    (`emu_tpu.ops.flash_attention.mha_packed_qkv`): qkv [B, S, 3·H·D] (q|k|v
    planes) → [B, S, H·D]. On CUDA tensors the `batched_mha` kernel reads
    the three planes as strided [B, S, H, D] views of the one buffer (a
    token stride of 3·H·D; no copy, no transpose) and writes the output in
    the [B, S, H·D] layout the proj product reads; on CPU tensors the plain
    twin."""
    if _cuda.on_cpu(qkv, "mha_packed_qkv"):
        return mha_packed_qkv_reference(qkv, num_heads, head_dim,
                                        scale=scale)
    b, s = qkv.shape[:2]
    _cuda.require(qkv.stride(-1) == 1, "mha_packed_qkv: qkv needs a "
                  "contiguous last dim")
    q, k, v = _packed_views(qkv, num_heads, head_dim)
    out = _batched_mha_launch("mha_packed_qkv", q, k, v, scale)
    mha_packed_qkv.launches += 1
    return out.view(b, s, num_heads * head_dim)


mha_packed_qkv.launches = 0


def flash_attention(q, k, v, *, kv_valid=None, scale: float = 1.0,
                    causal: bool = False):
    """q [B, Sq, H, D], k/v [B, Skv, Hkv, D] (token-major, as
    `emu_tpu.ops.flash_attention.flash_attention`) → [B, Sq, H, D];
    differentiable through the backward kernels at every Skv (the TPU
    package's streaming tier, Skv > 4096, is forward-only)."""
    out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    kv_valid=kv_valid, scale=scale, causal=causal)
    return out.transpose(1, 2)
