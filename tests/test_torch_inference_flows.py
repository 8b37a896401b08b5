"""The port's last public surface against the JAX package, on tiny
configurations from a numpy seed: Emu1Runner's interleaved and video-QA
flows (tokens exactly equal to the JAX runner's, beam 5 and greedy, 1, 3
and 8 images), `vit.forward_head`, `vit.forward_features(compute_dtype=)`,
`rope.apply_llama_rope` (2e-4 of max|ref|), `quant.quantize_tree(
group_size=, layer_chunked=)` bit for bit, the small helpers, the CLI's
--interleaved / --frames flows, and a guard that diffs the two packages'
public names and parameters."""

import ast
import contextlib
import dataclasses
import functools
import io
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from emu_tpu.cli import inference as jcli
from emu_tpu.config import Emu1Config as JEmu1Config
from emu_tpu.models import llama as jllama
from emu_tpu.models import vit as jvit
from emu_tpu.ops import quant as jquant
from emu_tpu.ops import rope as jrope
from emu_tpu_torch import bridge
from emu_tpu_torch import config as pconfig
from emu_tpu_torch.cli import inference as cli
from emu_tpu_torch.models import emu1, llama, vit
from emu_tpu_torch.ops import layers as L
from emu_tpu_torch.ops import q4_matmul as Q4
from emu_tpu_torch.ops import quant as Q
from emu_tpu_torch.ops import rope
from emu_tpu_torch.ops.layers import Init

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4


def close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    err = np.abs(got.detach().float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def to_torch(tree):
    """JAX tree → the same nested dict of torch tensors."""
    out = {}
    for path, v in bridge.to_state_dict(tree).items():
        node = out
        *head, last = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def perturb(tree, seed=0):
    """Every leaf + 0.05 N(0, 1) (numpy), so biases and norms are live."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), tree)


# --- Emu1Runner: interleaved and video QA ------------------------------------


@pytest.fixture(scope="module")
def runners():
    """The JAX CLI's tiny runner and the port's on its params (bridged)."""
    jr = jcli.build_runner(tiny=True)
    cfg = cli.tiny_config()
    tree = emu1.init(cfg, Init(device="meta"))
    tree["decoder"] = llama.fuse_projections(tree["decoder"])
    model = bridge.load_jax_params(emu1.Emu1(cfg, tree), jr.params)
    return jr, cli.Emu1Runner(model, cfg, cli.tokenizer_for(cfg))


def pictures(n, seed):
    """n RGB images of assorted sizes."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(
        0, 256, (int(rng.integers(24, 48)), int(rng.integers(24, 48)), 3),
        dtype=np.uint8)) for _ in range(n)]


def interleaved_text(n):
    return "".join(f"Picture {i}: [<IMG_PLH>] holds item {i}. "
                   for i in range(n)) + "What is common?"


@contextlib.contextmanager
def greedy(jr):
    """The JAX runner's flows (fixed at beam 5) decoding greedily: its
    `generate` called with beam_size=1 on the prompt each flow builds."""
    jr.generate = functools.partial(type(jr).generate, jr, beam_size=1)
    try:
        yield
    finally:
        del jr.generate


@pytest.mark.parametrize("beams", [5, 1], ids=["beam5", "greedy"])
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("flow", ["interleaved", "video_qa"])
def test_flow_tokens_match_jax_runner(runners, flow, n, beams):
    """`interleaved` (markers → placeholders, no system message, 128 new
    tokens) and `video_qa` (a placeholder per frame, the video system
    message, 64 new tokens) at their defaults give the JAX runner's text
    exactly."""
    jr, runner = runners
    images = pictures(n, seed=10 * n + beams)
    if flow == "interleaved":
        args = (images, interleaved_text(n))
    else:
        args = (images, "What happens in the video?")
    with greedy(jr) if beams == 1 else contextlib.nullcontext():
        ref = getattr(jr, flow)(*args)
    assert getattr(runner, flow)(*args, beam_size=beams) == ref
    steps = runner.last_stats["decode_steps"]
    assert runner.last_stats["images"] == n and steps >= 1


def test_flow_prompts_match_jax(runners):
    """The video system message is the JAX CLI's string, and each flow's
    text is the one the JAX methods build."""
    jr, runner = runners
    assert cli.video_system_msg == jcli.video_system_msg
    assert runner.placeholder == jr.placeholder
    text = interleaved_text(2)
    assert runner.interleaved_prompt(text) == text.replace(
        "[<IMG_PLH>]", jr.placeholder)
    assert runner.video_prompt(3, "Why?") == jr.placeholder * 3 + "Why?"


def test_build_runner_default_is_the_jax_tiny_runner():
    """build_runner's defaults build the JAX CLI's tiny configuration, so
    the port needs no tiny= argument."""
    r = cli.build_runner(device="cpu")
    jr_cfg = jcli.build_runner(tiny=True).cfg
    assert dataclasses.asdict(r.cfg) == dataclasses.asdict(jr_cfg)
    assert r.device.type == "cpu"


def run_cli(argv, tmp_path):
    paths = []
    for i, im in enumerate(pictures(3, seed=7)):
        paths.append(str(tmp_path / f"im{i}.png"))
        im.save(paths[-1])
    argv = [a if not a.startswith("@") else paths[int(a[1:])] for a in argv]
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["inference", "--device", "cpu", "--max-new-tokens", "4",
                *argv]
    try:
        with contextlib.redirect_stdout(out):
            cli.main()
    finally:
        sys.argv = old
    return out.getvalue(), paths


@pytest.mark.parametrize("flow", ["interleaved", "frames"])
def test_cli_flows(tmp_path, flow):
    """--interleaved with one --image per marker and --frames with a
    --question answer through the runner's methods."""
    from PIL import Image
    if flow == "interleaved":
        prompt = "[<IMG_PLH>]A cat. [<IMG_PLH>]And this one?"
        text, paths = run_cli(["--interleaved", prompt, "--image", "@0",
                               "--image", "@1"], tmp_path)
        want = cli.build_runner(device="cpu").interleaved(
            [Image.open(p).convert("RGB") for p in paths[:2]], prompt,
            max_new_tokens=4)
        assert f"===> interleaved: {want}\n" in text
    else:
        text, paths = run_cli(["--frames", "@0", "@1", "@2", "--question",
                               "What moves?"], tmp_path)
        want = cli.build_runner(device="cpu").video_qa(
            [Image.open(p).convert("RGB") for p in paths], "What moves?",
            max_new_tokens=4)
        assert f"===> video_qa: {want}\n" in text


def test_cli_refuses_a_marker_count_without_its_images(tmp_path, capsys):
    with pytest.raises(SystemExit) as exit_:
        run_cli(["--interleaved", "[<IMG_PLH>][<IMG_PLH>]Same?", "--image",
                 "@0"], tmp_path)
    assert exit_.value.code == 2
    assert "2 [<IMG_PLH>] markers and 1 --image" in capsys.readouterr().err


# --- vit.forward_head, forward_features(compute_dtype=) ----------------------


JCFG = JEmu1Config.tiny()
PCFG = pconfig.Emu1Config.tiny()


@pytest.fixture(scope="module")
def tower():
    jp = perturb(jvit.init(jax.random.PRNGKey(3), JCFG.vision))
    x = np.random.default_rng(4).standard_normal(
        (2, JCFG.vision.image_size, JCFG.vision.image_size, 3)
    ).astype(np.float32)
    return jp, x


def test_vit_forward_head_matches_jax(tower):
    """cls token → norm → head, the tiny tower's 8 classes."""
    jp, x = tower
    jt = jax.tree.map(jnp.asarray, jp)
    feats = jvit.forward_features(jt, JCFG.vision, jnp.asarray(x))
    ref = jvit.forward_head(jt, JCFG.vision, feats)
    out = vit.forward_head(to_torch(jp), PCFG.vision,
                           torch.from_numpy(np.array(feats)))
    assert out.shape == (2, JCFG.vision.num_classes)
    close(out, ref)


def test_vit_compute_dtype_casts_the_images(tower):
    """compute_dtype casts the images before the tower: bf16 images with
    compute_dtype=float32 compute in fp32 (the JAX result, 2e-4), and
    compute_dtype=bfloat16 is the tower on bf16 images."""
    jp, x = tower
    tp = to_torch(jp)
    low = torch.from_numpy(x).to(torch.bfloat16)
    ref = jvit.forward_features(jax.tree.map(jnp.asarray, jp), JCFG.vision,
                                jnp.asarray(low.float().numpy(),
                                            jnp.bfloat16),
                                compute_dtype=jnp.float32)
    out = vit.forward_features(tp, PCFG.vision, low,
                               compute_dtype=torch.float32)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    close(out, ref)
    half = vit.forward_features(tp, PCFG.vision, torch.from_numpy(x),
                                compute_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, vit.forward_features(tp, PCFG.vision, low))


# --- rope.apply_llama_rope ---------------------------------------------------


def test_apply_llama_rope_matches_jax():
    """Gather the rows at left-padded positions, then rotate, fp32."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    cos, sin = rope.llama_rope_tables(16, 32)
    positions = np.array([[0, 1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 1, 2, 3]])
    rq, rk = jrope.apply_llama_rope(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(cos), jnp.asarray(sin),
                                    jnp.asarray(positions))
    oq, ok = rope.apply_llama_rope(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(cos),
        torch.from_numpy(sin), torch.from_numpy(positions))
    close(oq, rq)
    close(ok, rk)


# --- quant.quantize_tree(group_size=, layer_chunked=) -------------------------


WIDE = dataclasses.replace(JCFG.llama, hidden_size=256, intermediate_size=512)


@pytest.fixture(scope="module")
def wide_decoder():
    """A LLaMA decoder wide enough that groups of 128 rows are not clamped
    (the fold half of a 256-row kernel is 128)."""
    return perturb(jllama.init(jax.random.PRNGKey(6), WIDE), 6)


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["whole", "layer_chunked"])
@pytest.mark.parametrize("group", [64, 128])
def test_quantize_tree_int4_matches_jax_bits(wide_decoder, group, chunked):
    """Every leaf of the int4 tree equal to the JAX package's (which
    quantizes inside jitted programs), for each group size, one layer slice
    at a time or the whole stack at once."""
    ref = jax.jit(functools.partial(
        jquant.quantize_tree, bits=4, group_size=group,
        layer_chunked=chunked))(jax.tree.map(jnp.asarray, wide_decoder))
    out = Q.quantize_tree(to_torch(wide_decoder), bits=4, group_size=group,
                          layer_chunked=chunked)
    want, got = bridge.to_state_dict(ref), bridge.flatten(out)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    scale4 = out["layers"]["mlp"]["down"]["scale4"]
    assert scale4.shape[-2] == WIDE.intermediate_size // group


@pytest.mark.parametrize("group", [64, 128])
def test_int4_group_size_picks_the_route(wide_decoder, group):
    """Groups of 128 rows take kernel F (`q4_plan`; its twin on the CPU);
    groups of 64, which F refuses, take `dense`'s dequantized product."""
    tree = Q.quantize_tree(to_torch(wide_decoder), bits=4, group_size=group)
    p = bridge.layer(tree["layers"], 0)["self_attn"]["q_proj"]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, WIDE.hidden_size)).astype(np.float32))
    assert Q4.q4_plan(p, x) == (group == 128)
    want = (Q4.matmul_q4_reference(x, p["kernel_q4"], p["scale4"])
            if group == 128 else x @ Q.dequantize_int4(p, torch.float32))
    assert torch.equal(L.dense(p, x), want)


# --- helpers ------------------------------------------------------------------


def test_tree_paths_and_leaves_match_jax():
    from emu_tpu.parallel import mesh as jmesh
    from emu_tpu_torch.parallel import mesh as pmesh
    tree = {"b": [np.zeros(2), {"y": np.ones(1), "x": np.ones(3)}],
            "a": {"k": np.zeros(4)}, "c": None}
    ref = jmesh.tree_paths_and_leaves(tree)
    got = pmesh.tree_paths_and_leaves(tree)
    assert [p for p, _ in got] == [p for p, _ in ref]
    assert all(g is r for (_, g), (_, r) in zip(got, ref))


def test_safety_checker_clip_preprocess_matches_jax():
    from emu_tpu.models import safety_checker as jsc
    from emu_tpu_torch.models import safety_checker as psc
    jcfg, pcfg = jsc.CLIPVisionConfig.tiny(), psc.CLIPVisionConfig.tiny()
    images = np.random.default_rng(9).uniform(
        0, 1, (2, 40, 52, 3)).astype(np.float32)
    ref = jsc.SafetyChecker(None, jcfg).clip_preprocess(images)
    chk = psc.SafetyChecker(psc.init(pcfg, Init()), pcfg)
    close(chk.clip_preprocess(images), ref, 1e-5)


# --- the guard: the JAX package's public surface, in the port -----------------


# The JAX package's public names and parameters that the port deliberately
# leaves out: they exist for the TPU's compiler or memory.
NOT_PORTED = {
    "ops/flags.py": "routing switches of the TPU kernels",
    "ops/flash_attention.py:bhsd_plan": "a VMEM block plan",
    "ops/flash_attention.py:packed_qkv_plan": "a VMEM block plan",
    "ops/flash_attention.py:mha_fits": "a VMEM budget test",
    "ops/flash_attention.py:mha_head_block": "a VMEM head block",
    "ops/decode_attention.py:decode_attention_fits": "a VMEM budget test",
    "ops/decode_attention.py:paged_decode_attention_fits":
        "a VMEM budget test",
    "ops/quant.py:materialize_s4": "native s4 arrays of the TPU",
    "ops/quant.py:materialize_s4_tree": "native s4 arrays of the TPU",
    "ops/quant.py:einsum_w8a8": "the ViT's MXU einsum; the port routes "
                                "those products through quant.matmul_w8a8 "
                                "and kernel E",
    "synth.py:materialize": "a ShapeDtypeStruct tree",
    "optim.py:FusedAdafactorState": "an optax state; the port's optimizer "
                                    "is a torch.optim.Optimizer",
    # the init helpers of a JAX PRNG key: the port's `Init` makes leaves
    "ops/layers.py:dense_init": "Init.dense",
    "ops/layers.py:layer_norm_init": "Init.layer_norm",
    "ops/layers.py:patch_embed_init": "Init.dense of the patch kernel",
}
# arguments of the TPU kernels' compiler: interpret mode, block sizes and
# their TPU padding, scan unrolling, the XLA backend
TPU_ARGS = {"interpret", "bm", "bn", "bf", "gpb", "scan_unroll", "backend",
            "s_real", "static_max"}
# a JAX PRNG key or dtype where the port takes an `Init` or a
# torch.Generator, and the JAX types the port's torch forms replace:
# {(file, function): {JAX argument: the port's}}
RENAMED = {
    ("parallel/ring_attention.py", "ring_attention"): {"axis_name": "group"},
    ("parallel/pipeline.py", "pipeline_forward"): {"micro_tree": "micro"},
    ("training.py", "make_emu1_train_step"): {"tx": "optimizer_factory"},
}
KEY_ARGS = {"key": ("init", "generator"), "dtype": ("init",),
            "rng": ("generator",)}
# the JAX function takes these and refuses or ignores them, or the port
# reaches what they select without them
INERT = {
    # the port's default is the tiny configuration
    ("cli/inference.py", "build_runner"): {"tiny"},
    ("ops/flash_attention.py", "flash_attention"): {"bias", "mask"},
    ("ops/pooler.py", "attentional_pooler_init"): {"n_head"},
    ("diffusion/schedulers.py", "PNDMScheduler.init_state"):
        {"sample_shape", "dtype"},
}


def public_surface(pkg):
    """{(file, name): parameter names (None: a class, or a function that
    takes **kwargs)} of the public top-level defs and methods."""
    out = {}
    base = os.path.join(ROOT, pkg)
    for d, _, files in os.walk(base):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            rel = os.path.relpath(path, base)
            with open(path) as fh:
                body = ast.parse(fh.read()).body

            def params(fn):
                if fn.args.kwarg is not None:
                    return None
                a = fn.args
                return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
            for node in body:
                if (isinstance(node, ast.FunctionDef)
                        and not node.name.startswith("_")):
                    out[(rel, node.name)] = params(node)
                elif (isinstance(node, ast.ClassDef)
                      and not node.name.startswith("_")):
                    out[(rel, node.name)] = None
                    for m in node.body:
                        if isinstance(m, ast.FunctionDef) and (
                                not m.name.startswith("_")
                                or m.name == "__call__"):
                            out[(rel, f"{node.name}.{m.name}")] = params(m)
    return out


def test_every_public_name_and_argument_of_the_jax_package_is_ported():
    """Every module of `emu_tpu/` has its port; every public function,
    class and method in it has its counterpart of the same name, and every
    parameter its counterpart, but for the allow-lists above (each RENAMED
    argument must be the port's parameter)."""
    ref, port = public_surface("emu_tpu"), public_surface("emu_tpu_torch")
    ref_files = {f for f, _ in ref} | {
        os.path.relpath(os.path.join(d, f), os.path.join(ROOT, "emu_tpu"))
        for d, _, fs in os.walk(os.path.join(ROOT, "emu_tpu"))
        for f in fs if f.endswith(".py")}
    port_files = {os.path.relpath(os.path.join(d, f),
                                  os.path.join(ROOT, "emu_tpu_torch"))
                  for d, _, fs in os.walk(os.path.join(ROOT, "emu_tpu_torch"))
                  for f in fs if f.endswith(".py")}
    missing = sorted(f for f in ref_files - port_files if f not in NOT_PORTED)
    assert not missing, f"modules with no port: {missing}"
    gaps = []
    for (f, name), args in sorted(ref.items()):
        if f not in port_files or f in NOT_PORTED:
            continue
        if (f, name) not in port:
            if f"{f}:{name}" not in NOT_PORTED:
                gaps.append(f"{f}:{name}")
            continue
        theirs = port[(f, name)]
        if args is None or theirs is None:
            continue
        renamed = RENAMED.get((f, name), {})
        for a in args:
            if a in theirs or a in TPU_ARGS or a in INERT.get((f, name), ()):
                continue
            if a in renamed:
                assert renamed[a] in theirs, (f, name, a, renamed[a])
                continue
            if a in KEY_ARGS and any(k in theirs for k in KEY_ARGS[a]):
                continue
            gaps.append(f"{f}:{name}({a}=)")
    assert not gaps, f"not in the port: {gaps}"
    listed = {k for k in NOT_PORTED if ":" in k}
    stale = sorted(k for k in listed
                   if tuple(k.split(":")) not in ref
                   or tuple(k.split(":")) in port)
    assert not stale, f"allow-list entries that no longer apply: {stale}"


# --- the sharded int4 landing: a rank's columns quantized, not the plane ------


def test_sharded_int4_load_quantizes_a_ranks_columns(tmp_path, monkeypatch):
    """load_emu2_checkpoint(quantize="int4", mesh=) cuts the column-cut
    planes (q|k|v, gate|up) before quantizing them, so the quantizer sees a
    rank's columns; o_proj and down (row-cut, kept whole in int4) are
    quantized whole. The loaded slices equal the whole load's cut."""
    from emu_tpu_torch import checkpoint, synth
    from emu_tpu_torch.models import emu2
    from emu_tpu_torch.parallel import mesh as M
    cfg = pconfig.Emu2Config.tiny()
    tree = emu2.init(cfg, Init(generator=torch.Generator().manual_seed(2)))
    path = str(tmp_path / "emu2.safetensors")
    synth.write_safetensors(synth.invert_emu2(tree, cfg), path)
    whole = checkpoint.load_emu2_checkpoint(path, cfg, torch.float32, "cpu",
                                            quantize="int4")
    seen = []
    real = Q.quantize_kernel_int4
    monkeypatch.setattr(Q, "quantize_kernel_int4", lambda k, gs=128: (
        seen.append(tuple(k.shape)) if k.device.type != "meta" else None)
        or real(k, gs))
    mesh = M.Mesh.at((1, 2), rank=1)
    got = checkpoint.load_emu2_checkpoint(path, cfg, torch.float32, "cpu",
                                          quantize="int4", mesh=mesh)
    ll = cfg.llama
    d, f = ll.hidden_size, ll.intermediate_size
    qkv = (ll.num_attention_heads + 2 * ll.kv_heads) * ll.head_dim
    per_layer = [(d, qkv // 2), (ll.num_attention_heads * ll.head_dim, d),
                 (d, f), (f, d)]
    assert sorted(seen) == sorted(per_layer * ll.num_hidden_layers)
    want = M.shard_params(whole, mesh, emu2.sharding_rules,
                          emu2.tensor_layout(cfg))
    g, w = bridge.flatten(got), bridge.flatten(want)
    assert set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w)
