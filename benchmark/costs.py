"""The yardstick's arithmetic: the H100's published peaks, the least time a
call could take (`bound`), and the operations and bytes of each kernel call
the benchmark counts, from the call's shapes alone.

Each input byte is counted as read once and each output byte as written
once, whatever the kernel reads again. Where the work depends on the data
(a causal mask, a ragged cache), the counts are of what these inputs need,
from the valid lengths the caller passes.

The peaks and `bound`, `attn_cost`, `mlp_cost`, `decode_cost` and
`norm_cost` are the kernel checks' arithmetic, kept here so that a change to
the program cannot change the yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
MFU_PEAK = PEAK_OPS["bf16"]


def bound(nbytes: float, ops: float, kind: str = "bf16"):
    """(least seconds the card could take, "bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BPS, ops / PEAK_OPS[kind]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def attn_cost(b, h, sq, skv, d, pairs=None):
    """Attention: bytes of q, k, v and out (bf16); operations of QK^T and
    PV over `pairs` (query, key) pairs of each head (default all)."""
    pairs = sq * skv if pairs is None else pairs
    return 2 * (2 * b * h * sq * d + 2 * b * h * skv * d), \
        4 * b * h * pairs * d


def mlp_cost(m, k, f, n, wbytes=2.0):
    """A two-product MLP x [m, k] -> [m, f] -> [m, n]: bytes of x, both
    weights (`wbytes` a weight), the biases and norm vectors, and out."""
    return (2 * m * k + wbytes * (k * f + f * n) + 2 * (f + n + 2 * k)
            + 2 * m * n), 2 * m * k * f + 2 * m * f * n


def decode_cost(b, h, hkv, d, n_valid, max_len, qn=1, itemsize=2,
                extra=True, scales=False):
    """Cached attention of `qn` new queries a row: bytes of q, the VALID
    cache rows of the layer (`n_valid` of them over the batch), their
    scales, the new keys and values, the mask and out; operations of QK^T
    and PV over each query's visible columns."""
    kv = 2 * n_valid * hkv * d * itemsize + (8 * n_valid * hkv
                                             if scales else 0)
    ex = 2 * 2 * b * hkv * qn * d if extra else 0
    nbytes = 4 * b * qn * h * d + kv + ex + b * max_len
    tri = qn * (qn + 1) // 2 if extra else 0
    ops = 4 * d * h * (qn * n_valid + b * tri)
    return nbytes, ops


def norm_cost(rows, w, add, wbytes=2):
    """RMSNorm (with the residual add when `add`): bytes of the rows in and
    out, the weight and the fp32 row statistics; about four operations an
    element."""
    return (2 * rows * w * (4 if add else 2) + wbytes * w
            + 4 * rows), 4 * rows * w


def q4_cost(m, k, n, groups, bias=False):
    """W4A8 product x [m, k] @ int4 [k, n]: bytes of x (bf16), the packed
    nibbles, the fp32 group scales, the bias and out (bf16); int8
    multiply-adds."""
    nbytes = 2 * m * k + k * n // 2 + 4 * groups * n + 2 * m * n
    return nbytes + (2 * n if bias else 0), 2 * m * k * n


def swiglu_q4_cost(m, d, f, groups_d, groups_f):
    """x + down(silu(gate(rms(x))) * up(rms(x))) over int4 weights: bytes
    of x, the norm weight, gate|up [d, 2f] and down [f, d] packed, their
    group scales and out; int8 multiply-adds of the three products."""
    nbytes = (4 * m * d + 2 * d + d * f + 4 * groups_d * 2 * f
              + f * d // 2 + 4 * groups_f * d)
    return nbytes, 2 * m * d * 2 * f + 2 * m * f * d


def w8a8_cost(m, k, n, bias=False):
    """W8A8 product x [m, k] (bf16, quantized per row) @ int8 [k, n]: bytes
    of x, the int8 kernel, the fp32 column scales, the bias and out."""
    nbytes = 2 * m * k + k * n + 4 * n + 2 * m * n
    return nbytes + (2 * n if bias else 0), 2 * m * k * n


def dense_cost(m, k, n, bias=True):
    """bf16 x [m, k] @ bf16 [k, n] (+ bias)."""
    return 2 * m * k + 2 * k * n + 2 * m * n + (2 * n if bias else 0), \
        2 * m * k * n


def llama_flops(cfg: dict, tokens: int, context: float,
                logit_rows: int) -> float:
    """Model operations of `tokens` decoder positions that attend `context`
    positions on average, with the lm_head at `logit_rows` of them: two a
    weight of every projection a token, QK^T and PV over the context."""
    d, f, n = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    kvd = d // cfg["num_attention_heads"] * (
        cfg.get("num_key_value_heads") or cfg["num_attention_heads"])
    per_layer = d * (d + 2 * kvd) + d * d + 3 * d * f
    return (2 * tokens * n * per_layer + 4 * tokens * n * d * context
            + 2 * logit_rows * d * cfg["extended_vocab_size"])


def served_flops(cfg: dict, prompt: int, new: int) -> float:
    """A served request: its prompt's prefill (the lm_head at its last
    position) and `new` - 1 decode positions."""
    return (llama_flops(cfg, prompt, (prompt + 1) / 2, 1)
            + llama_flops(cfg, max(new - 1, 0), prompt + new / 2,
                          max(new - 1, 0)))


def vit_flops(cfg: dict, images: int) -> float:
    """Model operations of the vision tower over `images` images: patch
    embedding, four projections and the MLP a token, attention over the
    whole sequence."""
    w, layers = cfg["width"], cfg["layers"]
    s = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    hidden = int(w * cfg["mlp_ratio"])
    per_token = 2 * (4 * w * w + 2 * w * hidden) * layers \
        + 2 * 3 * cfg["patch_size"] ** 2 * w
    return images * (s * per_token + 4 * layers * s * s * w)
