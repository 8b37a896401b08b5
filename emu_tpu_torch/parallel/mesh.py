"""Device mesh and parameter sharding over `torch.distributed`, as
`emu_tpu/parallel/mesh.py`.

The JAX package puts its weights on a ("data", "model") `jax.sharding.Mesh`
and lets GSPMD insert every collective. PyTorch has no partitioner that
sees the port's kernels (they are custom ops with no sharding strategy), so
the port shards explicitly, in the Megatron style:

- `make_mesh` arranges the ranks of the default process group in a grid and
  builds one process group per axis slice; `Mesh` knows this rank's
  coordinates and its group on every axis.
- `shard_params` keeps this rank's slice of every leaf that a rule shards,
  and writes a small `Shards` record under the reserved key `TP_KEY` into
  every dict of the tree it returns: the mesh, and the spec (a tuple of axis
  names, one per dim) and fused parts of each leaf of that dict. The models
  read the record where a product needs a collective (`ops.layers.dense`,
  `llama.embed`, ...); `bridge` and `checkpoint` skip it.
- Column-parallel products (a spec whose last entry is "model") keep their
  output columns local; row-parallel products (the second to last) end in
  `reduce_from`, the sum over "model". The collectives are the few named
  functions of this module (`reduce_from`, `copy_to`, `gather_last`,
  `ring_shift`, ...); the models never call `torch.distributed` directly.

Rules are (regex, spec) pairs matched against the '/'-joined leaf path; the
first match wins and no match means replicated. An axis whose size does not
divide the dimension is dropped, as in the JAX package. The port extends
that drop rule with the layout its kernels read: every call that plans a
cut takes the model's `tensor_layout(cfg)`, a list of (regex, parts, unit):

- a fused plane (`qkv_proj` = [q | k | v], `gate_up` = [gate | up], the
  ViT's `qkv`) shards PER PART along its last dim (`parts`: the parts'
  widths): rank r keeps its slice of q, of k and of v and concatenates
  them, so `_qkv` splits the local columns by the local head counts.
  (GSPMD splits the fused axis contiguously and keeps the global
  semantics; a rank that computes alone cannot.)
- a dim cut in units (attention heads: `head_dim` columns or rows) keeps
  whole units: if a part is not a multiple of `size * unit`, the leaf stays
  whole on that dim.
- a leaf whose unit is `WHOLE` stays whole on every rank: a kernel that
  cannot run on a rank's slice reads it. The vision towers' MLP leaves are
  such (`vit.tensor_layout`): kernel B's post-norm form normalises the
  whole sum and kernel E takes each row's maximum over the whole hidden,
  so every rank runs B or E on the whole MLP (the EVA-CLIP-4B tower is
  small beside the decoder it feeds).

No other kernel needs more: the vocabulary planes shard at any width (the
lm_head has no bias, so it is a plain product, or kernel F under int4,
which takes any N), and the int4 contraction planes stay replicated by the
rules themselves. Kernel G (`q4_matmul.swiglu_q4_plan`) refuses a sharded
MLP where its route is chosen (`llama.py`).

With a gloo group and CUDA tensors every collective here stages its tensor
through host memory: gloo moves host buffers (it accepts some CUDA tensors
and copies them itself, not all). That is the transport of a group of
processes on one card, where NCCL refuses two ranks; every product and
attention still runs its kernel on the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_AXES = ("data", "model")
TP_KEY = "_tp"          # the reserved key of a sharded tree's records

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of ranks with named axes. `ranks[c]` is the global rank at
    coordinate c; `coords` this process's coordinate (None when it is not
    in the mesh); `groups[axis]` its process group along `axis` (None for
    an axis of size 1, or a mesh built by `Mesh.at`, which has none)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    ranks: np.ndarray
    coords: Optional[Tuple[int, ...]]
    groups: Dict[str, Any]

    @classmethod
    def at(cls, shape: Sequence[int], axis_names: Sequence[str] = DEFAULT_AXES,
           rank: int = 0) -> "Mesh":
        """The mesh as rank `rank` sees it, without process groups: what
        `sharding_tree` and `shard_params` need to plan and cut a tree (a
        tree cut this way runs its collectives only once a real mesh's
        groups are there)."""
        ranks = np.arange(int(np.prod(shape))).reshape(tuple(shape))
        coords = tuple(int(c) for c in np.argwhere(ranks == rank)[0])
        return cls(tuple(shape), tuple(axis_names), ranks, coords, {})

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] \
            if axis in self.axis_names else 1

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (0 for an absent axis)."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)

    def peers(self, axis: str) -> list:
        """Global ranks of this rank's slice along `axis`, in axis order."""
        idx = list(self.coords)
        a = self.axis_names.index(axis)
        out = []
        for i in range(self.shape[a]):
            idx[a] = i
            out.append(int(self.ranks[tuple(idx)]))
        return out

    @property
    def rank(self) -> int:
        return int(self.ranks[self.coords])


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = DEFAULT_AXES,
              devices=None) -> Mesh:
    """A mesh over the ranks of the default process group (or the global
    ranks listed in `devices`), in row-major order, with one process group
    per axis slice. Every rank of the default group must call it (group
    creation is collective). Default shape: every rank on the last axis
    ("model"), as the JAX package puts every device on it. Without an
    initialised process group the only mesh is one rank: a shape whose
    product is 1.

    The port's `config.RuntimeConfig.mesh_shape`/`mesh_axis_names` are
    what a deployment passes here: `make_mesh(rc.mesh_shape,
    rc.mesh_axis_names)`. Nothing reads them implicitly, in the JAX package
    or here."""
    axis_names = tuple(axis_names)
    if dist.is_available() and dist.is_initialized():
        world, me = dist.get_world_size(), dist.get_rank()
    else:
        world, me = 1, 0
    members = list(range(world)) if devices is None else [int(d) for d in
                                                          devices]
    if members != sorted(members):
        # a group's ranks are ordered by global rank: keep the axes so
        raise ValueError(f"make_mesh: devices {members} must be increasing")
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (len(members),)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != len(members) or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not "
                         f"hold {len(members)} ranks")
    ranks = np.asarray(members).reshape(shape)
    found = np.argwhere(ranks == me)
    coords = tuple(int(c) for c in found[0]) if len(found) else None
    groups: Dict[str, Any] = {}
    for a, name in enumerate(axis_names):
        if shape[a] == 1:
            continue
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(a, slice(None))
            slice_ranks = [int(r) for r in ranks[tuple(idx)]]
            g = dist.new_group(slice_ranks)
            if me in slice_ranks:
                groups[name] = g
    return Mesh(shape, axis_names, ranks, coords, groups)


# ---------------------------------------------------------------------------
# Rules → specs → this rank's slices
# ---------------------------------------------------------------------------


def _spec_for(path: str, rules) -> Spec:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(spec)
    return ()


WHOLE = None     # a layout unit: the leaf is not cut (see the docstring)


def _layout_for(path: str, layout) -> Tuple[Optional[Tuple[int, ...]],
                                            Optional[int]]:
    """(parts along the last dim or None, unit) of a leaf."""
    for pattern, parts, unit in layout:
        if re.search(pattern, path):
            return (tuple(parts) if parts else None), unit
    return None, 1


def _parts_sizes(parts, dim: int) -> Tuple[int, ...]:
    if parts is None:
        return (dim,)
    if isinstance(parts, int):
        return (dim // parts,) * parts if dim % parts == 0 else (dim,)
    return parts if sum(parts) == dim else (dim,)


def _leaf_plan(path: str, shape, mesh: Mesh, rules, layout):
    """(spec, parts) of one leaf after the drop rules."""
    spec = _spec_for(path, rules)
    spec = spec + (None,) * (len(shape) - len(spec))
    parts, unit = _layout_for(path, layout)
    if unit is WHOLE:
        return (None,) * len(shape), None
    fixed = []
    for d, (dim, axis) in enumerate(zip(shape, spec)):
        if axis is None:
            fixed.append(None)
            continue
        size = _axis_size(mesh, axis)
        sizes = _parts_sizes(parts, dim) if d == len(shape) - 1 else (dim,)
        keep = all(s % (size * unit) == 0 for s in sizes)
        fixed.append(axis if keep and dim % size == 0 else None)
    last = fixed[-1] if fixed else None
    out_parts = (_parts_sizes(parts, shape[-1])
                 if last is not None and parts is not None else None)
    if out_parts is not None and len(out_parts) == 1:
        out_parts = None
    return tuple(fixed), out_parts


def _walk(tree, path=""):
    """(path, key, parent dict, leaf) of every tensor leaf; lists by index."""
    items = (enumerate(tree) if isinstance(tree, list) else tree.items())
    for k, v in items:
        if k == TP_KEY:
            continue
        sub = f"{path}/{k}" if path else str(k)
        if isinstance(v, (dict, list)):
            yield from _walk(v, sub)
        else:
            yield sub, k, tree, v


def tree_paths_and_leaves(tree) -> list:
    """[(path, leaf)] of every leaf in the JAX package's flattening order
    (dict keys sorted, lists and tuples by index; "a/b/0" paths); None is
    an empty subtree and the `Shards` records are skipped."""
    out = []

    def visit(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            items = sorted((k, v) for k, v in node.items() if k != TP_KEY)
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out.append((path, node))
            return
        for k, v in items:
            visit(v, f"{path}/{k}" if path else str(k))

    visit(tree, "")
    return out


def sharding_tree(params, mesh: Mesh, rules, layout):
    """The tree of every leaf's spec: a tuple of axis names (or None), one
    per dim, after the drop rules (the JAX `sharding_tree`'s PartitionSpecs
    as tuples); `layout`: the model's `tensor_layout(cfg)`."""
    def build(tree, path=""):
        if isinstance(tree, list):
            return [build(v, f"{path}/{i}") for i, v in enumerate(tree)]
        out = {}
        for k, v in tree.items():
            if k == TP_KEY:
                continue
            sub = f"{path}/{k}" if path else k
            out[k] = (build(v, sub) if isinstance(v, (dict, list))
                      else _leaf_plan(sub, tuple(v.shape), mesh, rules,
                                      layout)[0])
        return out
    return build(params)


def _axis_size(mesh: Mesh, axis) -> int:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return int(np.prod([mesh.size(a) for a in axes]))


def _axis_index(mesh: Mesh, axis) -> int:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    idx = 0
    for a in axes:
        idx = idx * mesh.size(a) + mesh.index(a)
    return idx


def local_slice(t: torch.Tensor, spec: Spec, parts, mesh: Mesh
                ) -> torch.Tensor:
    """This rank's slice of a whole leaf (a view): every sharded dim cut in
    `size` contiguous pieces, the last dim per part when it has parts."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n, r = _axis_size(mesh, axis), _axis_index(mesh, axis)
        sizes = parts if (parts and d == t.dim() - 1) else (t.shape[d],)
        pieces, start = [], 0
        for s in sizes:
            step = s // n
            pieces.append(t.narrow(d, start + r * step, step))
            start += s
        t = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=d)
    return t


@dataclasses.dataclass(eq=False)
class Shards:
    """The record `shard_params` writes under `TP_KEY` in every dict of a
    sharded tree: the mesh, and each leaf's spec and parts (by key)."""
    mesh: Mesh
    specs: Dict[str, Spec]
    parts: Dict[str, Optional[Tuple[int, ...]]]
    axis: str = "model"

    def spec(self, key: str) -> Spec:
        return self.specs.get(key, ())

    def cut(self, key: str, dim: int) -> bool:
        """Whether leaf `key` is sharded over the model axis on `dim`
        (negative dims count from the end, so a layer's view of a stacked
        leaf answers as the stack does)."""
        spec = self.specs.get(key, ())
        return len(spec) >= -dim and spec[dim] == self.axis

    @property
    def size(self) -> int:
        return self.mesh.size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.index(self.axis)

    @property
    def group(self):
        return self.mesh.group(self.axis)


def shard_params(params, mesh: Mesh, rules, layout, device=None,
                 planned=None):
    """This rank's slice of a param tree by rule table (contiguous copies,
    moved to `device` when given; a replicated leaf is the leaf itself),
    with a `Shards` record under `TP_KEY` in every dict. `layout`: the
    model's `tensor_layout(cfg)` (fused parts, head units, leaves kept
    whole). `planned`: {path: (spec, parts)} of leaves that are this rank's
    slices already (`cut_layer`), recorded as they are."""
    planned = planned or {}

    def build(tree, path=""):
        if isinstance(tree, list):
            return [build(v, f"{path}/{i}") for i, v in enumerate(tree)]
        out, specs, parts = {}, {}, {}
        for k, v in tree.items():
            if k == TP_KEY:
                continue
            sub = f"{path}/{k}" if path else k
            if isinstance(v, (dict, list)):
                out[k] = build(v, sub)
                continue
            t = v
            if sub in planned:
                spec, p = planned[sub]
            else:
                spec, p = _leaf_plan(sub, tuple(v.shape), mesh, rules, layout)
                if any(a is not None for a in spec):
                    t = local_slice(v, spec, p, mesh).contiguous()
            specs[k], parts[k] = spec, p
            if device is not None:
                t = t.to(device)
            out[k] = t
        out[TP_KEY] = Shards(mesh, specs, parts)
        return out
    return build(params)


def cut_layer(layer: dict, path: str, n: int, mesh: Mesh, rules, layout,
              planned: dict) -> dict:
    """This rank's slice of one layer of an `n`-layer stack under `path`
    (its leaves lack the stack's leading dim), cut as `shard_params` cuts
    the stacked leaves; each leaf's plan is written into `planned` for the
    `shard_params` call that records the whole tree. A loader lands a stack
    this way one layer at a time."""
    out = {}
    for k, v in layer.items():
        sub = f"{path}/{k}"
        if isinstance(v, dict):
            out[k] = cut_layer(v, sub, n, mesh, rules, layout, planned)
            continue
        spec, parts = _leaf_plan(sub, (n, *v.shape), mesh, rules, layout)
        planned[sub] = (spec, parts)
        out[k] = (local_slice(v, spec[1:], parts, mesh).contiguous()
                  if any(a is not None for a in spec) else v)
    return out


def gather_params(tree, device=None):
    """The whole tree back from a sharded one (every rank of the model
    group gets it): each sharded leaf gathered over its axis, per part.
    The inverse of `shard_params`."""
    def build(node):
        if isinstance(node, list):
            return [build(v) for v in node]
        rec = node.get(TP_KEY)
        out = {}
        for k, v in node.items():
            if k == TP_KEY:
                continue
            if isinstance(v, (dict, list)):
                out[k] = build(v)
                continue
            t = v.detach()
            if rec is not None:
                for d, axis in enumerate(rec.spec(k)):
                    if axis is not None:
                        t = _gather_dim(t, d, rec.mesh, axis,
                                        rec.parts.get(k)
                                        if d == t.dim() - 1 else None)
            out[k] = t if device is None else t.to(device)
        return out
    return build(tree)


def replicate(tree, mesh: Mesh):
    """Every rank of the mesh holds the values of its first rank: each
    tensor leaf broadcast from it over the default group (in place)."""
    if mesh.ranks.size > 1:
        src = int(mesh.ranks.flat[0])
        for _, _, _, leaf in _walk(tree):
            broadcast(leaf, src, dist.group.WORLD)
    return tree


def data_sharding(mesh: Mesh, *batches):
    """This rank's share of each batch's leading dim over the "data" axis
    (contiguous: data coordinate i holds rows [i·B/n, (i+1)·B/n)); one
    tensor in, one out."""
    n, i = mesh.size("data"), mesh.index("data")
    out = []
    for x in batches:
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split over "
                             f"{n} data ranks")
        step = x.shape[0] // n
        out.append(x[i * step:(i + 1) * step])
    return out[0] if len(out) == 1 else tuple(out)


# ---------------------------------------------------------------------------
# Collectives (gloo + CUDA: staged through host memory, see the docstring)
# ---------------------------------------------------------------------------


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` over `group` (None: nothing to do)."""
    if group is None:
        return t
    if _host_staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


BUCKET_BYTES = 256 << 20


def all_reduce_many(tensors, group) -> None:
    """In-place sum of every tensor over `group`, one collective per bucket
    (tensors of one dtype and device, packed flat, at most BUCKET_BYTES or
    one tensor): on gloo each collective is a round trip through the host,
    and NCCL too prefers few large calls to many small ones."""
    if group is None:
        return
    buckets, filling = [], {}       # filling: (dtype, device) → [list, bytes]
    for t in tensors:
        size, key = t.numel() * t.element_size(), (t.dtype, t.device)
        b = filling.get(key)
        if b is None or b[1] + size > BUCKET_BYTES:
            b = filling[key] = [[], 0]
            buckets.append(b[0])
        b[0].append(t)
        b[1] += size
    for bucket in buckets:
        flat = all_reduce(torch.cat([t.reshape(-1) for t in bucket]), group)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In-place broadcast from global rank `src` over `group` (None:
    nothing to do)."""
    if group is None:
        return t
    if _host_staged(t, group):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> list:
    """[rank 0's t, rank 1's t, ...] over `group` (group ranks in order)."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    staged = _host_staged(src, group)
    if staged:
        src = src.cpu()
    bufs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(bufs, src, group=group)
    return [b.to(t.device) for b in bufs] if staged else bufs


def _interleave(chunks, dim: int, parts) -> torch.Tensor:
    """Ranks' local slices → the whole tensor on `dim`, per part."""
    if not parts:
        return torch.cat(chunks, dim=dim)
    n = len(chunks)
    local = [s // n for s in parts]
    pieces = [c.split(local, dim=dim) for c in chunks]
    return torch.cat([pieces[r][p] for p in range(len(parts))
                      for r in range(n)], dim=dim)


def _own(x: torch.Tensor, dim: int, n: int, r: int, parts) -> torch.Tensor:
    """This rank's slice of a whole tensor on `dim`, per part."""
    sizes = parts or (x.shape[dim],)
    pieces, start = [], 0
    for s in sizes:
        pieces.append(x.narrow(dim, start + r * (s // n), s // n))
        start += s
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)


def _gather_dim(t, dim, mesh: Mesh, axis, parts):
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in reversed(axes):
        g = mesh.group(a)
        if g is not None:
            t = _interleave(all_gather(t, g), dim, parts)
    return t


class _Reduce(torch.autograd.Function):
    """Sum over the group forward, identity backward (a row-parallel
    product's partial sums)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Identity forward, sum over the group backward (the replicated input
    of a column-parallel product: each rank's dx covers its columns)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _GatherLast(torch.autograd.Function):
    """All-gather of the last dim forward (per part), this rank's slice of
    the cotangent backward (every rank holds the same one downstream)."""

    @staticmethod
    def forward(ctx, x, group, parts):
        ctx.n, ctx.r = dist.get_world_size(group), dist.get_rank(group)
        ctx.parts = parts
        return _interleave(all_gather(x, group), -1, parts)

    @staticmethod
    def backward(ctx, g):
        return _own(g, g.dim() - 1, ctx.n, ctx.r, ctx.parts), None, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over `group` (autograd: identity backward)."""
    return x if group is None else _Reduce.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """x, with its cotangent summed over `group` in the backward."""
    if group is None or not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _Copy.apply(x, group)


def gather_last(x: torch.Tensor, group, parts=None) -> torch.Tensor:
    """The ranks' local last-dim slices gathered (per part when `parts`
    gives the whole tensor's part sizes)."""
    if group is None:
        return x
    return _GatherLast.apply(x, group, tuple(parts) if parts else None)


def own_slice(x: torch.Tensor, group, parts=None) -> torch.Tensor:
    """This rank's last-dim slice of a whole (replicated) tensor, with its
    cotangent summed over `group` in the backward."""
    if group is None:
        return x
    x = copy_to(x, group)
    return _own(x, x.dim() - 1, dist.get_world_size(group),
                dist.get_rank(group), parts)


def ring_shift(tensors, group, reverse: bool = False):
    """Send each tensor to the next rank of `group` (group rank i → i+1
    mod n; `reverse`: i → i-1) and return what the previous one sent, with
    `batch_isend_irecv`. Same shapes and dtypes on every rank."""
    if group is None:
        return list(tensors)
    peers = dist.get_process_group_ranks(group)
    i, n = peers.index(dist.get_rank()), len(peers)
    step = -1 if reverse else 1
    dst, src = peers[(i + step) % n], peers[(i - step) % n]
    staged = any(_host_staged(t, group) for t in tensors)
    sends = [t.contiguous().cpu() if staged else t.contiguous()
             for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, src, group) for t in recvs]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [r.to(t.device) if staged else r for r, t in zip(recvs, tensors)]


def send(t: torch.Tensor, dst: int, group, tag: int = 0) -> None:
    """Blocking send to global rank `dst`."""
    dist.send(t.contiguous().cpu() if _host_staged(t, group)
              else t.contiguous(), dst, group=group, tag=tag)


def recv(like: torch.Tensor, src: int, group, tag: int = 0) -> torch.Tensor:
    """Blocking receive from global rank `src` into a tensor like `like`."""
    staged = _host_staged(like, group)
    buf = torch.empty_like(like, device="cpu" if staged else like.device)
    dist.recv(buf, src, group=group, tag=tag)
    return buf.to(like.device) if staged else buf


def tp_of(params) -> Optional[Shards]:
    """The record of a sharded tree's dict whose model axis is cut (None
    for a whole tree, or a mesh whose "model" axis has one rank)."""
    rec = params.get(TP_KEY) if isinstance(params, dict) else None
    return rec if rec is not None and rec.size > 1 else None
