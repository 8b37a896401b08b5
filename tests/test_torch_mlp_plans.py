"""The host-side plans of kernels B (`fused_mlp`) and E (`fused_mlp_w8a8`)
on the CPU. Both are pure functions of the shape: B's plan pads the hidden
width for its tensor maps and sizes the two products' grids and
workspaces; E's plan chooses fc1's thread-block cluster for a hidden block
of `bf` columns and which (row tile, 128-column tile) pairs each block of
its persistent wave owns. They
must admit every MLP shape the port's configs route to the kernels, and
fc1's blocks must write every hidden column exactly once. Neither needs
the card."""

import pytest
import torch

from emu_tpu_torch import config as pconfig
from emu_tpu_torch.ops import fused_mlp as B
from emu_tpu_torch.ops import layers as L


def _eva02_l():
    """EVA02-CLIP-L-14's vision widths (chip_smoke's phase 16)."""
    return pconfig.VisionConfig(image_size=224, patch_size=14, width=1024,
                                layers=24, head_width=64, mlp_ratio=2.6667,
                                naiveswiglu=True, subln=False, rope=True,
                                pt_hw_seq_len=16, intp_freq=True)


def _vision(name):
    return {"vit-g": pconfig.VisionConfig.emu1_g,
            "eva-4b": pconfig.VisionConfig.emu2_4b,
            "eva02-l": _eva02_l,
            "emu1-tiny": lambda: pconfig.Emu1Config.tiny().vision,
            "emu2-tiny": lambda: pconfig.Emu2Config.tiny().vision}[name]()


# (vision config, rows): a batch of 1, 8 and 32 images where the paths
# run them (ViT-g: phases 5 and 17; EVA-4B: phase 6-7's one, two and
# eight 448-px images; EVA02-L: phase 16's 2 and 32)
B_SHAPES = [("vit-g", 257), ("vit-g", 2056), ("vit-g", 8224),
            ("eva-4b", 1025), ("eva-4b", 2050), ("eva02-l", 514),
            ("eva02-l", 8224), ("emu1-tiny", 10), ("emu2-tiny", 34)]


def _b_form(cfg):
    return ("swiglu" if cfg.naiveswiglu else "gelu",
            "post" if cfg.postnorm else "pre")


@pytest.mark.parametrize("name,m", B_SHAPES)
def test_mlp_plan_admits_the_configs_shapes(name, m):
    """Every vision config's MLP branch (the form `layers.fused_block_mlp`
    sends to kernel B) is in the plan's envelope; the hidden width is
    padded to the next multiple of MLP_F_ALIGN only where it is not one
    (EVA02-L's 2730 -> 2736), and the workspaces are the plan's sizes."""
    cfg = _vision(name)
    k, f = cfg.width, cfg.mlp_hidden
    act, mode = _b_form(cfg)
    plan = B.mlp_plan(m, k, f, k, act, mode)
    assert plan["f_pad"] % B.MLP_F_ALIGN == 0
    assert 0 <= plan["f_pad"] - f < B.MLP_F_ALIGN
    assert plan["pad"] == (f % B.MLP_F_ALIGN != 0)
    assert plan["h_bytes"] == 2 * m * plan["f_pad"]
    assert plan["xn_bytes"] == (2 * m * k if mode == "pre" else 0)
    assert plan["ws_bytes"] == (4 * m * k if mode == "post" else 0)
    assert plan["grid1"][1] == plan["grid2"][1] == -(-m // 128)
    assert plan["grid2"][0] == -(-k // 128)


def test_mlp_plan_pads_eva02_l():
    cfg = _eva02_l()
    assert cfg.mlp_hidden == 2730
    plan = B.mlp_plan(8224, 1024, 2730, 1024, "swiglu", "pre")
    assert plan["pad"] and plan["f_pad"] == 2736 and plan["cols"] == 64
    assert plan["grid1"] == (43, 65) and plan["grid2"] == (8, 65)


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("f", [90, 129, 2730, 6144, 15360])
def test_mlp_plan_covers_the_hidden_columns_once(activation, f):
    """The first product's blocks write the padded hidden width exactly
    once: consecutive tiles of `cols` columns, none empty, none past
    f_pad."""
    plan = B.mlp_plan(300, 128, f, 128, activation)
    seen = []
    for bx in range(plan["grid1"][0]):
        cols = B.mlp_hidden_columns(plan, bx)
        assert len(cols) > 0
        seen.extend(cols)
    assert seen == list(range(plan["f_pad"]))


def test_mlp_plan_is_a_function_of_the_shape():
    for args in ((2056, 1408, 6144, 1408, "gelu", "pre"),
                 (1025, 1792, 15360, 1792, "gelu", "post"),
                 (8224, 1024, 2730, 1024, "swiglu", None)):
        assert B.mlp_plan(*args) == B.mlp_plan(*args)
    # the rows move only the grids' row tiles and the workspaces
    a, b = (B.mlp_plan(m, 1408, 6144, 1408, "gelu", "pre")
            for m in (257, 8224))
    assert a["f_pad"] == b["f_pad"] and a["grid1"][0] == b["grid1"][0]


@pytest.mark.parametrize("args", [
    (10, 40, 128, 32, "gelu", None),       # K % 16
    (10, 32, 128, 40, "gelu", None),       # N % 16
    (10, 32, 128, 32, "geglu", None),      # unknown activation
    (10, 32, 128, 32, "gelu", "mid"),      # unknown LN placement
])
def test_mlp_plan_refuses_out_of_envelope(args):
    with pytest.raises(ValueError):
        B.mlp_plan(*args)


def _route_bf(k, f, n, m):
    """The hidden block `layers.w8a8_mlp_plan` gives a W8A8 GELU MLP at m
    rows (None: the unfused route)."""
    params = {"fc1": {"kernel_w8a8": torch.empty(k, f, dtype=torch.int8,
                                                 device="meta")},
              "fc2": {"kernel_w8a8": torch.empty(f, n, dtype=torch.int8,
                                                 device="meta")}}
    x = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
    return L.w8a8_mlp_plan(params, x)


# the W8A8 towers at the rows that reach kernel E (>= 2048): EVA-4B's
# two, four and eight 448-px images; ViT-g's 8 and 32 images; the tiny
# configs at 2048 rows
E_SHAPES = [("eva-4b", 2050), ("eva-4b", 4100), ("eva-4b", 8200),
            ("vit-g", 2056), ("vit-g", 8224), ("emu1-tiny", 2048),
            ("emu2-tiny", 2057)]


@pytest.mark.parametrize("name,m", E_SHAPES)
def test_w8a8_plan_admits_the_configs_shapes(name, m):
    """Every W8A8 MLP the route sends to kernel E is in the plan's
    envelope, with the route's own hidden block (768, wider than the tiny
    configs' 128 hidden columns: their one block is zero-padded, as the
    TPU wrapper pads it)."""
    cfg = _vision(name)
    k, f = cfg.width, cfg.mlp_hidden
    bf = _route_bf(k, f, k, m)
    assert bf == 768
    plan = B.w8a8_plan(m, k, f, k, bf)
    assert 1 <= plan["cluster"] <= B.W8A8_MAX_CLUSTER
    assert plan["cluster"] * plan["tiles"] * B.W8A8_TILE == bf
    assert plan["blocks"] == -(-f // bf)
    assert plan["row_tiles"] == -(-m // 128)
    assert plan["units"] == plan["blocks"] * plan["row_tiles"]
    assert plan["grid2"] == (-(-k // 128), -(-m // 128))
    assert plan["hq_bytes"] == m * f and plan["xq_bytes"] == m * k
    assert plan["hs_bytes"] == 4 * m * plan["blocks"]


def test_w8a8_plan_eva_4b():
    """EVA-4B: 20 hidden blocks of 768, each a cluster of six 128-column
    blocks computed once, over 65 row tiles: 1300 units for fc1's wave."""
    plan = B.w8a8_plan(8200, 1792, 15360, 1792, 768)
    assert (plan["cluster"], plan["tiles"], plan["recompute"]) == (6, 1, False)
    assert plan["units"] == 1300 and plan["grid2"] == (14, 65)


@pytest.mark.parametrize("bf,cluster,tiles", [
    (128, 1, 1), (256, 2, 1), (384, 3, 1), (768, 6, 1), (1024, 8, 1),
    (1152, 3, 3), (1280, 5, 2), (15360, 8, 15)])
def test_w8a8_plan_cluster_rule(bf, cluster, tiles):
    """The cluster is the largest divisor of bf / 128 that is at most the
    portable 8; each of its blocks owns the rest, computing them twice
    where it owns more than one (the maxima, then the quantization)."""
    plan = B.w8a8_plan(4100, 1792, 15360, 1792, bf)
    assert (plan["cluster"], plan["tiles"]) == (cluster, tiles)
    assert plan["recompute"] == (tiles > 1)


@pytest.mark.parametrize("clusters", [1, 7, 22, 1000])
@pytest.mark.parametrize("bf", [128, 256, 768, 1152])
@pytest.mark.parametrize("f", [768, 2304, 15360, 128, 896])
def test_w8a8_plan_covers_the_hidden_columns_once(bf, f, clusters):
    """fc1's persistent wave quantizes every (row tile, hidden column)
    exactly once, whatever number of clusters the card holds (the ranks
    of a cluster own disjoint tiles of the same hidden block, whose row
    maximum they share), and a last block narrower than bf is cut at F."""
    plan = B.w8a8_plan(300, 128, f, 128, bf)
    c = plan["cluster"]
    seen = []
    for cid in range(clusters):
        per_rank = [B.w8a8_fc1_work(plan, bf, f, clusters, cid * c + r)
                    for r in range(c)]
        for work in per_rank:
            seen.extend(work)
    want = [(row, col) for row in range(plan["row_tiles"])
            for col in range(f)]
    assert sorted(seen) == want


def test_w8a8_plan_is_a_function_of_the_shape():
    for args in ((2050, 1792, 15360, 1792, 768), (40, 32, 128, 32, 768),
                 (300, 128, 2304, 128, 1152)):
        assert B.w8a8_plan(*args) == B.w8a8_plan(*args)
    a, b = (B.w8a8_plan(m, 1792, 15360, 1792, 768) for m in (2050, 8200))
    assert (a["cluster"], a["tiles"], a["blocks"]) == (
        b["cluster"], b["tiles"], b["blocks"])


@pytest.mark.parametrize("args", [
    (10, 40, 256, 32, 128),      # K % 16
    (10, 32, 250, 32, 128),      # F % 16
    (10, 32, 256, 40, 128),      # N % 16
    (10, 32, 256, 32, 192),      # bf % 128
    (10, 32, 256, 2064, 128),    # N > 2048 (the post form's row pass)
])
def test_w8a8_plan_refuses_out_of_envelope(args):
    with pytest.raises(ValueError):
        B.w8a8_plan(*args)


def test_wrappers_take_their_twins_on_the_cpu():
    """On CPU tensors both wrappers run their plain twins and count no
    launch, at shapes outside the kernels' envelopes too."""
    torch.manual_seed(0)
    x = torch.randn(3, 40, dtype=torch.bfloat16)
    w1, w2 = torch.randn(40, 70).bfloat16(), torch.randn(70, 40).bfloat16()
    before = B.fused_mlp.launches, B.fused_mlp_w8a8.launches
    y = B.fused_mlp(x, w1, None, w2, None, residual=True)
    assert torch.equal(y, B.fused_mlp_reference(x, w1, None, w2, None,
                                                residual=True))
    from emu_tpu_torch.ops import quant as Q
    q1, q2 = Q.quantize_kernel(w1), Q.quantize_kernel(w2)
    args = (q1["kernel_q8"], q1["scale"], None, q2["kernel_q8"],
            q2["scale"], None)
    z = B.fused_mlp_w8a8(x, *args, bf=192)
    assert torch.equal(z, B.fused_mlp_w8a8_reference(x, *args, bf=192))
    assert (B.fused_mlp.launches, B.fused_mlp_w8a8.launches) == before
