"""The host-side plans of kernels D (`decode_attention`) and G
(`fused_swiglu_q4`) on the CPU, and the rule of the plain twin that D's
chunk skip relies on. The plans are pure functions of the shape: how D
splits each cache plane's key axis over blocks, and how G splits its two
products' K axes over thread-block clusters. Neither needs the card."""

import numpy as np
import pytest
import torch

from emu_tpu_torch.ops import decode_attention as D
from emu_tpu_torch.ops import q4_matmul as Q4
from emu_tpu_torch.ops._cuda import H100_SMS, SMEM_PER_BLOCK

# (B, Hkv, rep, qn, S, D, itemsize): the continuous engine (8 slots, 52
# heads, 1024 slots, int8 and bf16), the Emu2 beam decode, the Emu1 caption
# decode, the speculative verify and the mixed step, GQA, odd S and long S
PLAN_SHAPES = [(8, 52, 1, 1, 1024, 128, 1), (8, 52, 1, 1, 1024, 128, 2),
               (5, 52, 1, 1, 384, 128, 2), (8, 40, 1, 1, 256, 128, 2),
               (5, 40, 1, 1, 256, 128, 2), (1, 52, 1, 5, 1024, 128, 2),
               (8, 52, 1, 32, 1024, 128, 1), (8, 52, 1, 32, 1024, 128, 2),
               (3, 2, 4, 1, 1000, 64, 2), (2, 2, 8, 1, 76, 128, 1),
               (1, 1, 1, 1, 1, 16, 2), (4, 8, 8, 8, 4096, 64, 1),
               (1, 4, 1, 1, 32768, 128, 2), (2, 1, 16, 1, 640, 128, 2)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_decode_plan_splits_cover_s_in_whole_chunks(shape):
    """The splits cut the key axis into consecutive runs of whole chunks
    that cover S exactly; none is empty and none holds more chunks than a
    block's list takes; the grid is at most one wave of co-resident
    blocks."""
    b, hkv, rep, qn, s, d, itemsize = shape
    plan = D.decode_plan(*shape)
    assert plan["kernel"] == ("rows" if qn == 1 and rep <= 8 else "mma")
    cs, n, cps = plan["chunk"], plan["splits"], plan["chunks_per_split"]
    nch = -(-s // cs)
    runs = [(i * cps, min((i + 1) * cps, nch)) for i in range(n)]
    assert runs[0][0] == 0 and runs[-1][1] == nch
    assert all(lo < hi for lo, hi in runs)
    assert all(a[1] == z[0] for a, z in zip(runs, runs[1:]))
    assert all(hi - lo <= D.MAX_SPLIT_CHUNKS for lo, hi in runs)
    assert plan["items"] == b * hkv * n
    cap = plan["blocks_per_sm"] * H100_SMS
    assert plan["grid"] == min(plan["items"], cap)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_decode_plan_is_a_function_of_the_shape(shape):
    """Computed afresh, the plan is the same: it reads no data (kv_valid
    decides which chunks a block loads, never the plan)."""
    first = dict(D.decode_plan(*shape))
    D.decode_plan.cache_clear()
    assert D.decode_plan(*shape) == first


def test_decode_plan_fills_the_card_at_one_row():
    """The speculative verify (B 1, 5 queries, 52 heads) has only 52 (row,
    head) planes: the plan splits their key axes so more than 52 blocks
    stream the cache."""
    plan = D.decode_plan(1, 52, 1, 5, 1024, 128, 2)
    assert plan["splits"] > 1 and plan["grid"] > 52
    plan = D.decode_plan(1, 52, 1, 1, 1024, 128, 1)
    assert plan["splits"] > 1 and plan["grid"] > 52


@pytest.mark.parametrize("itemsize", [1, 2])
def test_decode_plan_gives_the_engine_whole_waves(itemsize):
    """An 8-slot, 52-head cache of 1024 slots: one wave of co-resident
    blocks that leaves no SM without one, the items walked in whole rounds
    (every block but the last round's takes the same count)."""
    plan = D.decode_plan(8, 52, 1, 1, 1024, 128, itemsize)
    cap = plan["blocks_per_sm"] * H100_SMS
    assert H100_SMS <= plan["grid"] <= cap
    rounds = -(-plan["items"] // plan["grid"])
    assert plan["items"] > (rounds - 1) * plan["grid"]


@pytest.mark.parametrize("shape,why", [
    ((3, 2, 4, 1, 50, 128, 1), "int8 scales of an S that is not a multiple "
                               "of 4"),
    ((2, 4, 1, 1, 64, 36, 2), "bf16 rows of 72 bytes"),
    ((2, 4, 1, 1, 64, 40, 1), "int8 rows of 40 bytes"),
])
def test_decode_plan_keeps_the_first_row_kernel(shape, why):
    """Rows the bulk copies cannot take keep the first row kernel, one
    block per plane."""
    plan = D.decode_plan(*shape)
    assert plan["kernel"] == "first", why
    assert plan["grid"] == shape[0] * shape[1]


CHUNK_SHAPES = [sh for sh in PLAN_SHAPES if sh[3] > 1 or sh[2] > 8]


@pytest.mark.parametrize("page", [8, 16, 24, 64, 128])
@pytest.mark.parametrize("shape", CHUNK_SHAPES)
def test_paged_chunk_forms_take_the_dense_mma_plan(shape, page):
    """A page pool's chunk forms (S = P * page) take the mma kernel with the
    dense cache's splits and grid wherever pages are whole 8-row swizzle
    atoms: the same items in the same order, so the paged lane gives the
    dense lane's bits."""
    b, hkv, rep, qn, s, d, itemsize = shape
    s = -(-s // page) * page
    dense = D.decode_plan(b, hkv, rep, qn, s, d, itemsize)
    paged = D.decode_plan(b, hkv, rep, qn, s, d, itemsize, page=page)
    assert paged["kernel"] == "mma"
    assert paged == dense


@pytest.mark.parametrize("page", [1, 4, 12, 20, 36])
def test_paged_chunk_forms_outside_the_box_rule_keep_the_first_design(page):
    """bf16 pages that are not a multiple of 8 rows cannot land TMA boxes on
    the 128-byte swizzle's 8-row atoms: the chunk forms keep the first
    design there. An int8 pool's chunks come by bulk copy a page run and
    keep the mma kernel; the Sq = 1 forms keep the row kernel."""
    s = 64 * page
    plan = D.decode_plan(8, 52, 1, 32, s, 128, 2, page=page)
    assert plan["kernel"] == "first" and plan["grid"] == 8 * 52
    assert D.decode_plan(8, 52, 1, 32, s, 128, 1, page=page) == \
        D.decode_plan(8, 52, 1, 32, s, 128, 1)
    assert D.decode_plan(8, 52, 1, 1, s, 128, 2, page=page)["kernel"] == \
        "rows"


def test_decode_plan_needs_aligned_operands():
    assert D.decode_plan(8, 52, 1, 1, 1024, 128, 2,
                         aligned=False)["kernel"] == "first"
    assert D.decode_plan(8, 52, 1, 32, 1024, 128, 2,
                         aligned=False)["kernel"] == "first"


# (M, D, F, gs_d, gs_f, bf): LLaMA-33B (Emu2) at 1, 5, 8 (the engine's
# slots), 17 and 32 rows; LLaMA-13B (Emu1) widths; the card test's shape
G_SHAPES = [(m, 6656, 17920, 128, 128, 384) for m in (1, 5, 8, 17, 32)] + [
    (5, 5120, 13824, 128, 128, 384), (8, 2048, 5632, 128, 128, 384),
    (3, 256, 1536, 128, 128, 384), (2, 768, 1536, 384, 128, 384)]


@pytest.mark.parametrize("shape", G_SHAPES)
def test_swiglu_decode_plan_covers_planes_and_groups(shape):
    """G's decode plan: the gate|up clusters' hidden blocks tile both
    nibble planes' F/2 units exactly, and each product's K splits are
    consecutive, non-empty runs of whole scale-group pairs covering its
    K/2 packed rows."""
    m, d, f, gs_d, gs_f, bf = shape
    bf = Q4.snap_bf(bf, f, gs_f)
    plan = Q4.decode_plan(m, d, f, gs_d, gs_f, bf)
    for plane in (0, 1):
        blocks = sorted((j0, j1) for p, j0, j1 in plan["hidden_blocks"]
                        if p == plane)
        assert blocks[0][0] == plane * f // 2
        assert blocks[-1][1] == (plane + 1) * f // 2
        assert all(a[1] == z[0] for a, z in zip(blocks, blocks[1:]))
        assert all(j1 - j0 == bf for j0, j1 in blocks)
    for name, kp, gs in (("gate_up", d // 2, gs_d), ("down", f // 2, gs_f)):
        p = plan[name]
        runs = p["splits"]
        assert len(runs) == p["ks"] and p["ks"] in (1, 2, 4, 8)
        assert runs[0][0] == 0 and runs[-1][1] == kp
        assert all(lo < hi and lo % gs == 0 and hi % gs == 0
                   for lo, hi in runs)
        assert all(a[1] == z[0] for a, z in zip(runs, runs[1:]))
        assert p["kmax"] == max(hi - lo for lo, hi in runs)
        assert p["smem"] <= SMEM_PER_BLOCK


def test_swiglu_decode_plan_fills_one_wave_at_decode_rows():
    """At the decode rows of LLaMA-33B (1, 5 and the engine's 8) both
    products' blocks fit one wave of co-resident blocks and the down
    product's fill at least 132 SMs' worth of one block each."""
    for m in (1, 5, 8):
        plan = Q4.decode_plan(m, 6656, 17920, 128, 128, 256)
        for name in ("gate_up", "down"):
            p = plan[name]
            assert p["blocks"] <= p["blocks_per_sm"] * H100_SMS, name
        assert plan["gate_up"]["ks"] > 1
        assert plan["down"]["blocks"] >= H100_SMS


# ---- the twin's rule behind kernel D's chunk skip ---------------------------

def _decode_inputs(seed=0, b=3, qn=1, h=4, hkv=2, s=96, d=64, quant=False):
    rng = np.random.RandomState(seed)
    bf = torch.bfloat16

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32
                            ).to(bf)
    q = t(b, qn, h, d)
    if quant:
        k = torch.tensor(rng.randint(-127, 128, (b, hkv, s, d)),
                         dtype=torch.int8)
        v = torch.tensor(rng.randint(-127, 128, (b, hkv, s, d)),
                         dtype=torch.int8)
        ks = torch.tensor(rng.rand(b, hkv, s) * 0.02 + 0.005,
                          dtype=torch.float32)
        vs = torch.tensor(rng.rand(b, hkv, s) * 0.02 + 0.005,
                          dtype=torch.float32)
    else:
        k, v, ks, vs = t(b, hkv, s, d), t(b, hkv, s, d), None, None
    kn, vn = t(b, hkv, qn, d), t(b, hkv, qn, d)
    return q, k, v, ks, vs, kn, vn


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("qn", [1, 5])
def test_masked_cache_rows_add_exactly_nothing(quant, qn):
    """With k_new/v_new, every masked cache row (here whole 32-position
    chunks and scattered rows, and one batch row masked entirely) can hold
    anything finite: the output keeps its bits. That is what lets the
    kernel leave such chunks unread."""
    q, k, v, ks, vs, kn, vn = _decode_inputs(qn=qn, quant=quant)
    b, s = q.shape[0], k.shape[2]
    valid = torch.zeros(b, s, dtype=torch.bool)
    valid[0, :20] = True
    valid[0, 70:75] = True
    valid[1, 33:90:3] = True          # row 2 sees no cache row at all
    kw = dict(scale=q.shape[-1] ** -0.5, k_new=kn, v_new=vn)
    ref = D.decode_attention_reference(q, k, v, valid, ks, vs, **kw)
    junk_k, junk_v = k.clone(), v.clone()
    masked = ~valid[:, None, :, None].expand_as(k)
    if quant:
        junk_k[masked], junk_v[masked] = 127, -127
    else:
        junk_k[masked], junk_v[masked] = 3e4, -3e4
    got = D.decode_attention_reference(q, junk_k, junk_v, valid, ks, vs,
                                       **kw)
    assert torch.equal(got, ref)


def test_masked_cache_rows_add_nothing_without_k_new():
    """Without the extra columns the same holds for a row with some valid
    position."""
    q, k, v, _, _, _, _ = _decode_inputs(seed=1)
    b, s = q.shape[0], k.shape[2]
    valid = torch.zeros(b, s, dtype=torch.bool)
    for r in range(b):
        valid[r, 7 * r:7 * r + 5] = True
    kw = dict(scale=q.shape[-1] ** -0.5)
    ref = D.decode_attention_reference(q, k, v, valid, **kw)
    masked = ~valid[:, None, :, None].expand_as(k)
    junk_k, junk_v = k.clone(), v.clone()
    junk_k[masked], junk_v[masked] = -2e4, 2e4
    assert torch.equal(D.decode_attention_reference(q, junk_k, junk_v, valid,
                                                    **kw), ref)


@pytest.mark.parametrize("quant", [False, True])
def test_a_row_with_no_column_averages_all_of_v(quant):
    """Without k_new and with every position masked, each query head's
    output is the mean of its kv head's S values (int8: of the values
    times their scale rounded to bf16, the twin's P.V operand)."""
    q, k, v, ks, vs, _, _ = _decode_inputs(seed=2, quant=quant)
    b, s = q.shape[0], k.shape[2]
    valid = torch.zeros(b, s, dtype=torch.bool)
    got = D.decode_attention_reference(q, k, v, valid, ks, vs,
                                       scale=q.shape[-1] ** -0.5)
    vals = v.float()
    if quant:
        vals = vals * vs.to(torch.bfloat16).float()[..., None]
    mean = vals.mean(2)                                  # [B, Hkv, D]
    rep = q.shape[2] // k.shape[1]
    want = mean.repeat_interleave(rep, dim=1)[:, None]   # [B, 1, H, D]
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               rtol=8e-3, atol=1e-6)
